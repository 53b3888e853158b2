"""Doc-range sharding: a segment's docs split into contiguous ranges, one
per shard of a :class:`~fugu_tpu_torch.parallel.sharded.Mesh`, every
kernel run per shard and the per-shard top k merged into the global
top k."""
