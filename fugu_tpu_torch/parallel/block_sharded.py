"""The batched block scorer over a doc-range-sharded mesh.

The counterpart of ``fugu_tpu/parallel/pallas_sharded.py`` (the port's
``ops/block_scorer.py`` is the reference's ``ops/pallas_scorer.py``).
Every shard runs the single-device engine's kernel over its own blocks
for the whole query batch:

- the shard's entry pack (local docs, tf | fid) and per-doc tombstone
  flags on its device (``parallel/sharded.ShardedPack``)
- per (query, shard) block tables: each clause's posting subrange per
  2048-doc block of the shard, from one cached ``searchsorted`` per
  (shard, term) over the shard's host doc ids

Each shard's rows go through ``block_scorer._dispatch_rows`` as on one
device (grouped by block count, ``SCRATCH_MAX_BYTES`` of first-pass
scratch a launch), so ``score_rows`` launches once or more per shard.
The shards' top k (score, global doc) lists then merge on the root
device (``merge_topk``: inner mesh axis first), and the host rescore
makes scores and order bit-identical to the oracle.  The reference
splits a shard's blocks into slices of its SMEM table; the port's rows
are sized by scratch bytes, so a shard with every block of its range is
one row.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from fugu_tpu_torch.index.segment import Segment
from fugu_tpu_torch.ops import buckets
from fugu_tpu_torch.ops.block_scorer import (
    BLOCK,
    K_OUT,
    MAX_K,
    SCRATCH_MAX_BYTES,
    _INT_MAX,
    _dispatch_rows,
    plan_block_tables,
)
from fugu_tpu_torch.ops.rescore import rescore_hits
from fugu_tpu_torch.ops.staging import ClauseArgs, has_nonpositive_weight
from fugu_tpu_torch.parallel.sharded import Mesh, ShardedPack, merge_topk
from fugu_tpu_torch.query import QueryPlan


class BlockShardedPack(ShardedPack):
    """ShardedPack + the block scorer's per-shard block counts and
    block-offset caches."""

    def __init__(self, segment: Segment, mesh: Mesh):
        super().__init__(segment, mesh)
        #: 2048-doc blocks of each shard (the flags' padded length)
        self.n_blocks = [
            max((int(c) + BLOCK - 1) // BLOCK, 1) for c in self.shard_counts
        ]
        #: searchsorted memo per shard: (start, len) -> block offsets
        self._offs_caches = [dict() for _ in range(self.n_shards)]

    def stage_block(self, plan: QueryPlan, stats, t_pad: int):
        """Per-shard staged clause args, or None (every clause df 0).

        Reuses ShardedPack.stage for the per-shard (start, len) tables
        and global weights, then re-wraps each shard's row as ClauseArgs
        for the block-table stager."""
        staged = self.stage(plan, stats, t_pad)
        if staged is None:
            return None
        starts, lens, weights, c1, c2, gbits, must, mustnot, should, need = staged
        shard_args = [
            ClauseArgs(starts=starts[s], lens=lens[s], weights=weights,
                       c1=c1, c2=c2, gbits=gbits.astype(np.uint32))
            for s in range(self.n_shards)
        ]
        return shard_args, must, mustnot, should, need


def block_sharded_search_batch(
    pack: BlockShardedPack,
    plans: Sequence[QueryPlan],
    stats,
    limit: int,
    block_lists: Optional[dict] = None,
) -> List[Optional[List[Tuple[float, int]]]]:
    """Batched multi-shard search; one entry per plan, None = the
    caller's host chain.

    ``block_lists`` (plan index -> per-shard list of allowed LOCAL block
    ids) restricts each query to a caller-proven candidate set — the
    sharded two-phase engine (parallel/batch_sharded) passes the blocks
    whose phase-A maxima can still reach the kth score."""
    results: List[Optional[List[Tuple[float, int]]]] = [None] * len(plans)
    if limit > MAX_K:
        return results
    # strict <: at limit == bucket extract one ladder step above so host
    # rescoring sees slack candidates (see ops/block_scorer.py)
    k = buckets.k_extract(limit) or MAX_K
    d = pack.n_shards

    staged = []
    for i, plan in enumerate(plans):
        if plan.host_only:
            continue
        if has_nonpositive_weight(plan, stats):
            continue  # 'scores > 0 == matched' breaks; host fallback
        n_clauses = sum(len(g.clauses) for g in plan.groups)
        t_pad = max(buckets.t_bucket(max(n_clauses, 1)), 4)
        if t_pad > 16 or len(plan.groups) > 32:
            continue
        st = pack.stage_block(plan, stats, t_pad)
        if st is None:
            # stage can only return None here when every clause had
            # df == 0 (>32-group plans were filtered above): no doc can
            # score, so the empty result is exact
            results[i] = []
            continue
        staged.append((i, t_pad) + st)
    if not staged:
        return results

    by_t: dict = {}
    for item in staged:
        # item = (i, t_pad, shard_args, must, mustnot, should, need_bits)
        by_t.setdefault((item[1], item[6]), []).append(item)

    pending: List[list] = [[] for _ in range(d)]
    for (t_pad, need_bits), items in by_t.items():
        for s in range(d):
            rows = []
            for (i, _t, shard_args, must, mustnot, should, _nb) in items:
                st, ct, nonempty = plan_block_tables(
                    pack.host_packs[s][0], shard_args[s], t_pad,
                    pack.n_blocks[s], must, pack._offs_caches[s],
                )
                if block_lists is not None and i in block_lists:
                    bl = np.asarray(block_lists[i][s], dtype=np.int64)
                    nonempty = bl[np.isin(bl, nonempty, assume_unique=True)]
                if len(nonempty):  # else the shard holds no candidate
                    rows.append((i, shard_args[s], must, mustnot, should,
                                 st, ct, nonempty))
            # rows group by a power-of-two block count, as on one device
            by_nb: dict = {}
            for r in rows:
                by_nb.setdefault(1 << (len(r[7]) - 1).bit_length(), []).append(r)
            for nb_pad, nb_rows in sorted(by_nb.items()):
                step = max(SCRATCH_MAX_BYTES // (nb_pad * k * 8), 1)
                for lo in range(0, len(nb_rows), step):
                    _dispatch_rows(nb_rows[lo:lo + step], nb_pad, t_pad, k,
                                   need_bits, pack.packs[s], pending[s])

    # per shard, one [P, K_OUT] candidate table over every plan (a plan
    # has at most one row a shard), local docs made global
    n = len(plans)
    scores, gdocs = [], []
    for s in range(d):
        if not pending[s]:
            scores.append(None)
            gdocs.append(None)
            continue
        dev = pack.mesh.devices[s]
        at = torch.tensor([r[0] for rows, _s, _d in pending[s] for r in rows],
                          dtype=torch.int64, device=dev)
        top_s = torch.full((n, K_OUT), float("-inf"), device=dev)
        top_d = torch.full((n, K_OUT), _INT_MAX, dtype=torch.int32, device=dev)
        top_s.index_copy_(0, at, torch.cat([p[1] for p in pending[s]]))
        top_d.index_copy_(0, at, torch.cat([p[2] for p in pending[s]]))
        scores.append(top_s)
        gdocs.append(torch.where(top_d != _INT_MAX, top_d + pack.bounds[s],
                                 _INT_MAX))
    merged = merge_topk(pack.mesh, scores, gdocs, k)
    if merged is not None:
        both = torch.stack([merged[0].view(torch.int32), merged[1]])
        both = both.cpu().numpy()
        top_s, top_d = both[0].view(np.float32), both[1]
    for i, *_rest in staged:
        hits = []
        if merged is not None:
            keep = np.isfinite(top_s[i])
            hits = list(zip(top_s[i][keep].tolist(), top_d[i][keep].tolist()))
        # device floats are replaced with oracle-exact host floats before
        # the final ranking; docs are global ids
        results[i] = rescore_hits(pack.segment, plans[i], stats, hits)[:limit]
    return results
