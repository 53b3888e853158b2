"""NamedIndex: one logical index (docs / filter_index / query_index) on a GPU.

The counterpart of ``fugu_tpu/engine/named_index.py``.  An index is a
directory in fugu_tpu's own format (meta.json, ``seg-*.npz``, tombstones,
doc store); a directory written by either package opens in the other.

Writer side (carried from the reference; ``tests/test_torch_drift.py``
holds each carried method to its source):

- single writer behind a lock; every upsert batch freezes an immutable
  segment, persists it and atomically publishes the new manifest
- delete-by-id tombstones matching docs in committed segments and
  earlier docs of the same in-flight batch
- tiered compaction (``index/compactor.py``) in the background, inline
  (``sync``) or not at all (``off``); a merge's entry pack is rebuilt on
  the index's device from the sources' resident packs
  (``ops/device_merge.py``) when every source pack is resident there,
  and uploads from the host at first query otherwise
- spill to and restore from a cold tier (``storage/spill.py``)

Reader side: a segment is routed by its size, as the reference's
default routes it.  A segment of at most ``SMALL_SEGMENT_MAX_DOCS`` docs
takes the small-segment engine (``ops/scoring.py``: torch ops on the
index's device, limits up to 4,096); the plans it declines (more than 16
clauses, more than 32 constrained groups, a limit above 4,096) go to the
host block-max engine or the oracle.  A larger segment takes the hybrid
engine: the two-phase batch engine, then the block scorer for the plans
phase A declines, then the host chain for the plans both decline by
design (more than 16 clauses or 32 groups, a nonpositive weight, a limit
above 128).  Quoted phrases take the phrase stream (ops/phrase_stream)
where its routing cost model sends them, as the reference's default
does, and the host matcher otherwise; with ``FUGU_DEVICE_PHRASE=1``, the
reference's opt-in switch, the phrases the stream declines go to
ops/device_phrase first.  Device errors, the device merge's included,
propagate to the caller; there is no device-to-host fallback.
With ``use_device=False`` the index runs the host engines only and
touches no tensor.

Under a mesh (:meth:`NamedIndex.enable_sharding`, parallel/) every
segment's docs split into contiguous ranges, one a shard, and the same
routing runs shard by shard: a larger segment takes the sharded
two-phase engine, then the sharded block scorer; a smaller one the
small-segment engine per shard; streamed phrases the phrase kernel per
shard.  Each merges its shards' top k into the global top k.  The
per-segment sharded packs are cached, accounted to the residency budget
and dropped with their segment.
"""

from __future__ import annotations

import functools
import threading
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from fugu_tpu_torch import device as device_mod
from fugu_tpu_torch.config import compaction_mode
from fugu_tpu_torch.engine import documents as docbuild
from fugu_tpu_torch.index.compactor import BackgroundCompactor, LogMergePolicy
from fugu_tpu_torch.index.manifest import Manifest, load_segment, save_segment, save_tombstones
from fugu_tpu_torch.index.merge import MergePlan, merge_segments
from fugu_tpu_torch.index.schema import REQUIRED_FIELDS, IndexSchema, IndexType, SCHEMAS
from fugu_tpu_torch.index.segment import Segment, SegmentBuilder
from fugu_tpu_torch.ops import device_phrase
from fugu_tpu_torch.ops import oracle as oracle_ops
from fugu_tpu_torch.query import QueryPlan
from fugu_tpu_torch.records import ObjectRecord

#: plans whose segment has fewer postings than this run on the host
#: (device launch overhead dominates tiny segments)
DEVICE_MIN_ENTRIES = 4096


#: a segment of at most this many docs takes the small-segment engine
#: (ops/scoring), a larger one the hybrid engine.  From chip_smoke.py's
#: routing ladder on an NVIDIA H100 80GB HBM3 at 700 W (232 plans, limit
#: 10, warm passes in turns, four calls): at 131,072 docs the two
#: engines' passes overlap and neither is ahead in every call (65-105 ms
#: against 49-94 ms); at 8,192 docs the small-segment engine is ahead in
#: every call (29-49 against 45-82 ms), at 262,144 docs the hybrid
#: engine (91-133 against 64-96 ms).  Both passes are host-bound.  With a
#: tenth of a segment's docs tombstoned the small-segment engine is
#: ahead at every rung (87-131 against 166-300 ms at 262,144 docs): a
#: head term's idf turns nonpositive and the hybrid engine sends such
#: plans to the host
SMALL_SEGMENT_MAX_DOCS = 131_072


def _engine_name(seg: Segment) -> str:
    """"small_segment" or "hybrid" for this segment, by its size."""
    if seg.doc_count <= SMALL_SEGMENT_MAX_DOCS:
        return "small_segment"
    return "hybrid"


def device_engine(seg: Segment, plans, stats, limit: int,
                  device: torch.device, routes: Optional[dict] = None):
    """Top-``limit`` [(score, doc)] of each plan on one segment through
    the engine its size selects.  A plan the small-segment engine
    declines comes back as None, for the caller's host chain; the hybrid
    engine runs its host chain itself.  ``routes``, when given, counts
    the plans each engine answered ("small_segment", "phase_a",
    "block_scorer", "host")."""
    if _engine_name(seg) == "small_segment":
        from fugu_tpu_torch.ops.scoring import device_search_batch

        res = device_search_batch(seg, plans, stats, limit, device)
        if routes is not None:
            declined = sum(r is None for r in res)
            routes["small_segment"] = (
                routes.get("small_segment", 0) + len(res) - declined
            )
            routes["host"] = routes.get("host", 0) + declined
        return res

    from fugu_tpu_torch.ops.batch_scorer import batch_search_should
    from fugu_tpu_torch.ops.block_scorer import block_search_batch
    from fugu_tpu_torch.ops.blockmax import search_blockmax

    res = batch_search_should(seg, plans, stats, limit, device)
    miss1 = [i for i, r in enumerate(res) if r is None]
    if miss1:
        fill1 = block_search_batch(
            seg, [plans[i] for i in miss1], stats, limit, device
        )
        for i, r in zip(miss1, fill1):
            res[i] = r
    missing = [i for i, r in enumerate(res) if r is None]
    for i in missing:
        r = search_blockmax(seg, plans[i], stats, limit)
        if r is None:
            r = [
                (h.score, h.doc)
                for h in oracle_ops.search([seg], plans[i], limit, stats)
            ]
        res[i] = r
    if routes is not None:
        n1, n2 = len(plans) - len(miss1), len(miss1) - len(missing)
        routes["phase_a"] = routes.get("phase_a", 0) + n1
        routes["block_scorer"] = routes.get("block_scorer", 0) + n2
        routes["host"] = routes.get("host", 0) + len(missing)
    return res


def _evict_sharded_pack(ni: "NamedIndex", sid: str) -> None:
    ni._sharded_packs.pop(sid, None)


def _evict_sharded_bm(ni: "NamedIndex", sid: str) -> None:
    ni._sharded_bm.pop(sid, None)


class NamedIndex:
    def __init__(
        self,
        name: str,
        path: Path,
        index_type: IndexType,
        writer_memory_budget: int = 50_000_000,
        use_device: bool = True,
        compaction: Optional[str] = None,
        device: Union[str, torch.device] = "cuda",
    ):
        self.name = name
        self.path = Path(path)
        self.index_type = index_type
        self.schema: IndexSchema = SCHEMAS[index_type]
        self.writer_memory_budget = writer_memory_budget
        self.use_device = use_device
        #: the device of the index's packs; None without use_device
        self.device = device_mod.resolve(device) if use_device else None
        self._lock = threading.RLock()
        self.compaction_mode = compaction_mode(compaction)
        self.merge_policy = LogMergePolicy()
        self._compactor = BackgroundCompactor(self.run_compaction_pass)
        #: write-amplification accounting: docs_written counts docs
        #: rewritten by merges; write_amp = (ingested+written)/ingested
        self.compaction_stats: Dict[str, int] = {
            "merges": 0,
            "docs_written": 0,
            "entries_written": 0,
            "docs_ingested": 0,
        }
        self.path.mkdir(parents=True, exist_ok=True)
        self.manifest = Manifest(self.path)
        self.segments: List[Segment] = []
        #: manifest entries for spilled (cold) segments — they have no
        #: in-memory Segment but must survive every manifest commit, or a
        #: write to a spilled namespace would orphan them permanently
        self.cold_segments: Dict[str, Dict[str, Any]] = {}
        if self.manifest.load():  # open_or_create (core.rs:238-245)
            for entry in self.manifest.entries:
                seg_id = entry["id"]
                if (self.path / f"seg-{seg_id}.spilled").exists():
                    # cold segment: stays remote until restore()
                    self.cold_segments[seg_id] = dict(entry)
                    continue
                self.segments.append(load_segment(self.path, seg_id, self.schema))
            # startup-only directory sweep: reclaims packs orphaned by a
            # crash mid-merge (save_segment runs before publish).  Safe
            # ONLY here — no merge can be in flight during open.
            self.manifest.gc(self.manifest.segment_ids)
        self._stats: Optional[oracle_ops.IndexStats] = None
        self._snap_stats: Optional[tuple] = None
        #: the mesh of enable_sharding, and its per-segment packs
        #: (segment id -> (version, pack))
        self._mesh = None
        self._sharded_packs: Dict[str, Any] = {}
        self._sharded_bm: Dict[str, Any] = {}
        #: plans answered per engine ("small_segment", "phase_a",
        #: "block_scorer", "host", "phrase_stream", "host_only"; with
        #: FUGU_DEVICE_PHRASE=1 "device_phrase"; under a mesh
        #: "sharded_small", "sharded_phase_a", "sharded_block_scorer"
        #: and "phrase_stream_sharded") since the index was opened
        self.routes: Dict[str, int] = {}
        #: searches run on several threads at once (the server's executor)
        self._routes_lock = threading.Lock()
        #: bumped on every spill(); cold-guarded readers compare it
        #: across their walk so a spill+restore pair completing entirely
        #: inside the walk (has_cold back to False) still triggers a
        #: retry instead of returning the post-spill empty snapshot
        self.spill_gen = 0

    # -- reader side ---------------------------------------------------------

    @property
    def num_docs(self) -> int:
        # cold (spilled) segments still count — stats/health must not
        # report an offloaded namespace as empty (live_docs recorded at
        # spill time; older markers fall back to doc_count).  Reads are
        # lockless, so dedup against the warm list: mid-spill a segment
        # may transiently appear in both.
        warm = list(self.segments)
        warm_ids = {s.segment_id for s in warm}
        cold = sum(
            int(e.get("live_docs", e.get("doc_count", 0)))
            # dict() snapshot: spill()/restore() mutate cold_segments
            # under the writer lock while this runs lockless
            for sid, e in dict(self.cold_segments).items()
            if sid not in warm_ids
        )
        return sum(s.num_live_docs for s in warm) + cold

    def stats(self) -> oracle_ops.IndexStats:
        if self._stats is None:
            self._stats = oracle_ops.IndexStats(self.segments)
        return self._stats

    def stats_for(self, segments) -> oracle_ops.IndexStats:
        """Stats describing exactly ``segments`` (a reader snapshot).

        Reuses the live-list stats when the snapshot IS the live list
        (keeps the df memo warm); the one-slot snapshot cache keeps
        repeated queries on another snapshot cheap."""
        live = self.stats()
        if len(segments) == len(live.segments) and all(
            a is b for a, b in zip(segments, live.segments)
        ):
            return live
        key = tuple(id(s) for s in segments)
        snap = self._snap_stats
        if snap is not None and snap[0] == key:
            return snap[1]
        st = oracle_ops.IndexStats(segments)
        self._snap_stats = (key, st)
        return st

    def _invalidate(self) -> None:
        self._stats = None
        self._snap_stats = None
        # evict sharded caches for segments no longer live (merged away,
        # spilled): a stale entry would strand its packs in device memory
        # for the life of the process
        self._drop_sharded_packs({s.segment_id for s in self.segments})

    def _drop_sharded_packs(self, keep) -> None:
        """Drop the cached sharded packs of every segment id not in
        ``keep``, and their residency accounting."""
        from fugu_tpu_torch.ops import residency

        for cache, rkind in (
            (self._sharded_packs, "spack"),
            (self._sharded_bm, "sbm"),
        ):
            for sid in [k for k in list(cache) if k not in keep]:
                cache.pop(sid, None)
                residency.unregister((rkind, id(self), sid))

    def has_field(self, field: str) -> bool:
        return self.schema.has_field(field)

    def validate_required_fields(self) -> None:
        self.schema.validate_required(REQUIRED_FIELDS[self.index_type])

    def schema_info(self) -> Dict[str, str]:
        info = {f: "TEXT | STORED" for f in self.schema.text_fields}
        if self.schema.facet_field:
            info[self.schema.facet_field] = "FACET | INDEXED | STORED"
        for f in self.schema.json_fields:
            info[f] = "JSON | STORED"
        for f in self.schema.date_fields:
            info[f] = "DATE | INDEXED | STORED"
        return info

    def _count_routes(self, counts: Dict[str, int]) -> None:
        with self._routes_lock:
            for name, n in counts.items():
                self.routes[name] = self.routes.get(name, 0) + n

    def enable_sharding(self, mesh) -> None:
        """Route searches through doc-range-sharded packs on ``mesh``
        (parallel/sharded.make_mesh), or through the unsharded engines
        again with None; packs build lazily per segment and are dropped
        when their segment leaves the index."""
        self._drop_sharded_packs(())
        self._mesh = mesh

    def _sharded_pack(self, segment: Segment, mesh):
        from fugu_tpu_torch.ops import residency
        from fugu_tpu_torch.parallel.block_sharded import BlockShardedPack

        # tombstone count is a valid version (tombstones only grow):
        # an in-place delete_document mutates segment.tombstones without
        # changing the segment identity, and a pack cached across it
        # would keep serving the deleted doc from its stale flags
        tomb_v = int(segment.tombstones.sum())
        sid = segment.segment_id
        cached = self._sharded_packs.get(sid)
        if (
            cached is None
            or cached[1].segment is not segment
            or cached[1].mesh is not mesh
            or cached[0] != tomb_v
        ):
            # one set of per-shard entry packs serves the block scorer
            # and the small-segment engine
            pack = BlockShardedPack(segment, mesh)
            cached = (tomb_v, pack)
            self._sharded_packs[sid] = cached
            residency.reserve(
                ("spack", id(self), sid),
                pack.resident_bytes,
                self,
                functools.partial(_evict_sharded_pack, sid=sid),
                kind="sharded_pack",
            )
            if not residency.contains(("spack", id(self), sid)):
                self._sharded_packs.pop(sid, None)
        else:
            residency.touch(("spack", id(self), sid))
        return cached[1]

    def _sharded_block_major(self, segment: Segment, stats, mesh):
        from fugu_tpu_torch.ops import residency
        from fugu_tpu_torch.parallel.batch_sharded import ShardedBlockMajor

        key = stats.fingerprint
        sid = segment.segment_id
        cached = self._sharded_bm.get(sid)
        if (
            cached is None
            or cached[0] != key
            or cached[1].segment is not segment
            or cached[1].mesh is not mesh
        ):
            pack = ShardedBlockMajor(segment, mesh, stats)
            cached = (key, pack)
            self._sharded_bm[sid] = cached
            residency.reserve(
                ("sbm", id(self), sid),
                pack.resident_bytes,
                self,
                functools.partial(_evict_sharded_bm, sid=sid),
                kind="sharded_block_major",
            )
            if not residency.contains(("sbm", id(self), sid)):
                self._sharded_bm.pop(sid, None)
        else:
            residency.touch(("sbm", id(self), sid))
        return cached[1]

    def _sharded_search_batch(self, seg, plans, stats, limit, mesh, routes):
        """``device_engine``'s routing over ``mesh``: a segment above
        SMALL_SEGMENT_MAX_DOCS takes the sharded two-phase engine, then
        the sharded block scorer for the plans phase A declined; a
        smaller one the small-segment engine per shard.  Declined plans
        come back as None, for the caller's host chain; ``routes``
        counts the plans each engine answered."""
        from fugu_tpu_torch.parallel.sharded import sharded_search_batch

        pack = self._sharded_pack(seg, mesh)
        if _engine_name(seg) == "small_segment":
            res = sharded_search_batch(pack, plans, stats, limit)
            counts = {"sharded_small": sum(r is not None for r in res)}
        else:
            from fugu_tpu_torch.parallel.batch_sharded import (
                batch_search_sharded,
            )
            from fugu_tpu_torch.parallel.block_sharded import (
                block_sharded_search_batch,
            )

            pack2 = self._sharded_block_major(seg, stats, mesh)
            res = batch_search_sharded(pack2, pack, plans, stats,
                                       [limit] * len(plans))
            miss = [j for j, r in enumerate(res) if r is None]
            if miss:
                fill = block_sharded_search_batch(
                    pack, [plans[j] for j in miss], stats, limit
                )
                for j, r in zip(miss, fill):
                    res[j] = r
            counts = {
                "sharded_phase_a": len(plans) - len(miss),
                "sharded_block_scorer": sum(res[j] is not None for j in miss),
            }
        counts["host"] = sum(r is None for r in res)
        for name, n in counts.items():
            routes[name] = routes.get(name, 0) + n
        return res

    def searcher_segments(self) -> List[Segment]:
        """A consistent segment snapshot — pass it back to
        search_topk_batch and use it to resolve hit ordinals to stored
        docs."""
        return list(self.segments)

    def _phrase_stream_begin(self, seg, plans, host_only_idx, n_device,
                             stats, limit, mesh):
        """Launch the phrase stream for ``host_only_idx`` on ``seg`` when
        the routing cost model wants it (the reference's default auto
        mode), else None; under ``mesh`` the stream is sharded.  The
        concurrent device batch of ``n_device`` plans sweeps only this
        segment, so its overlap credit scales by the segment's share of
        the index's tokens."""
        from fugu_tpu_torch.ops.phrase_stream import (
            estimate_device_batch_ms,
            phrase_stream_begin,
            want_stream,
        )

        phrase_plans = [plans[i] for i in host_only_idx]
        tot = max(sum(stats.total_tokens.values()), 1)
        share = sum(seg.total_tokens.values()) / tot
        if not want_stream(
            len(phrase_plans),
            plans=phrase_plans,
            stats=stats,
            overlap_ms=estimate_device_batch_ms(
                stats, n_device, token_share=share
            ),
        ):
            return None
        if mesh is not None:
            from fugu_tpu_torch.parallel.phrase_sharded import (
                phrase_stream_sharded_begin,
            )

            return phrase_stream_sharded_begin(
                seg, mesh, phrase_plans, stats, [limit] * len(phrase_plans)
            )
        return phrase_stream_begin(
            seg, phrase_plans, stats, [limit] * len(phrase_plans),
            self.device,
        )

    def search_topk(self, plan: QueryPlan, limit: int) -> List[oracle_ops.Hit]:
        """Top-k across segments for one plan."""
        return self.search_topk_batch([plan], limit)[0]

    def search_topk_batch(
        self,
        plans: Sequence[QueryPlan],
        limit: int,
        segments: Optional[List[Segment]] = None,
    ) -> List[List[oracle_ops.Hit]]:
        """Top-k for many queries, batching device launches per segment."""
        if segments is None:
            segments = self.searcher_segments()
        # stats must describe the snapshot being scored
        stats = self.stats_for(segments)
        # parser-expanded multi-field alternatives reduce to their live
        # alternatives here — score-exact (dead alternatives match
        # nothing), and dead terms would widen phase A's union lanes
        from fugu_tpu_torch.ops.blockmax import search_blockmax
        from fugu_tpu_torch.query import prune_dead_alternatives

        plans = [prune_dead_alternatives(p, stats.doc_freq) for p in plans]
        all_hits: List[List[oracle_ops.Hit]] = [[] for _ in plans]
        runnable = [
            i for i, p in enumerate(plans) if not p.is_empty and limit > 0
        ]
        mesh = self._mesh
        for ord_, seg in enumerate(segments):
            on_device = (
                self.use_device and seg.n_entries >= DEVICE_MIN_ENTRIES
            )
            device_idx = [
                i for i in runnable if on_device and not plans[i].host_only
            ]
            host_only_idx = [i for i in runnable if plans[i].host_only]
            host_map: Dict[int, Any] = {}
            host_thread = None
            # quoted phrases the cost model routes to the phrase stream
            # are staged and launched before the device batch, and
            # collected after it; errors propagate
            stream_handle = self._phrase_stream_begin(
                seg, plans, host_only_idx, len(device_idx), stats, limit,
                mesh,
            ) if host_only_idx and on_device else None
            phrase_handle = None
            if (stream_handle is None and host_only_idx and on_device
                    and device_phrase.enabled()):
                # the reference's opt-in device phrase path, for what the
                # stream declined; under a mesh on the unsharded segment
                # on the mesh's root device
                phrase_handle = device_phrase.device_phrase_begin(
                    seg, [plans[i] for i in host_only_idx], stats, limit,
                    self.device if mesh is None else mesh.root,
                )
            handle = (stream_handle if stream_handle is not None
                      else phrase_handle)
            phrase_host_idx = host_only_idx
            if handle is not None:
                pre, staged = handle[0], handle[1]
                covered = {j for j, _pc in staged} | {
                    j for j, r in enumerate(pre) if r is not None
                }
                phrase_host_idx = [
                    i for j, i in enumerate(host_only_idx) if j not in covered
                ]
            # the other host-only plans (phrases) run on a worker thread
            # WHILE the device batch executes: their NumPy work hides
            # under the device wait (both sides release the GIL)
            if phrase_host_idx and device_idx:
                def _host_work(seg=seg, idx=tuple(phrase_host_idx)):
                    for i in idx:
                        try:
                            host_map[i] = search_blockmax(
                                seg, plans[i], stats, limit
                            )
                        except Exception as e:  # re-raised after join
                            host_map[i] = e

                host_thread = threading.Thread(target=_host_work)
                host_thread.start()
            res_map = {}
            counts: Dict[str, int] = {}
            try:
                if device_idx and mesh is not None:
                    batch_res = self._sharded_search_batch(
                        seg, [plans[i] for i in device_idx], stats, limit,
                        mesh, counts,
                    )
                    res_map = dict(zip(device_idx, batch_res))
                elif device_idx:
                    batch_res = device_engine(
                        seg, [plans[i] for i in device_idx], stats, limit,
                        self.device, counts,
                    )
                    res_map = dict(zip(device_idx, batch_res))
                if stream_handle is not None:
                    if mesh is not None:
                        from fugu_tpu_torch.parallel.phrase_sharded import (
                            phrase_stream_sharded_collect as collect,
                        )
                    else:
                        from fugu_tpu_torch.ops.phrase_stream import (
                            phrase_stream_collect as collect,
                        )

                    for j, r in enumerate(collect(stream_handle)):
                        if r is not None:
                            host_map[host_only_idx[j]] = r
                n_host = len(phrase_host_idx)
                if phrase_handle is not None:
                    # declined and overflowed plans come back None: the
                    # host matcher takes them below
                    phrase_res = device_phrase.device_phrase_collect(
                        phrase_handle)
                    for j, r in enumerate(phrase_res):
                        if r is not None:
                            host_map[host_only_idx[j]] = r
                    n_host = sum(r is None for r in phrase_res)
            finally:
                if host_thread is not None:
                    host_thread.join()
            streamed = ("phrase_stream" if mesh is None
                        else "phrase_stream_sharded")
            counts[streamed] = 0
            counts["device_phrase" if phrase_handle is not None
                   else streamed] = len(host_only_idx) - n_host
            counts["host_only"] = n_host
            self._count_routes(counts)
            for i in runnable:
                res = res_map.get(i)
                if res is None:
                    got = host_map.get(i)
                    if isinstance(got, Exception):
                        raise got
                    if got is None:
                        # pruned host engine (exact top-k incl. phrases);
                        # None -> dense oracle below
                        got = search_blockmax(seg, plans[i], stats, limit)
                    res = got
                if res is not None:
                    all_hits[i].extend(
                        oracle_ops.Hit(s, ord_, d) for s, d in res
                    )
                else:
                    scores, mask = oracle_ops.score_segment(seg, plans[i], stats)
                    docs = np.nonzero(mask)[0]
                    if len(docs) > limit:
                        sc = scores[docs]
                        # keep kth-score ties so the final sort's doc-asc
                        # tiebreak is deterministic (see oracle.search)
                        part = np.argpartition(-sc, limit - 1)
                        kth = sc[part[limit - 1]]
                        docs = docs[sc >= kth]
                    all_hits[i].extend(
                        oracle_ops.Hit(float(scores[d]), ord_, int(d))
                        for d in docs
                    )
        for i in range(len(plans)):
            all_hits[i].sort(key=lambda h: (-h.score, h.segment_ord, h.doc))
            all_hits[i] = all_hits[i][:limit]
        return all_hits

    def stored_doc(self, segment_ord: int, doc: int) -> Dict[str, Any]:
        return self.segments[segment_ord].stored[doc]

    def terms_with_prefix(self, field: str, prefix: str, limit: int = 16) -> List[str]:
        """Terms starting with `prefix`, via the sorted term dictionaries."""
        import bisect

        out: List[str] = []
        seen = set()
        for seg in self.segments:
            keys = list(seg.terms.get(field, {}).keys())
            i = bisect.bisect_left(keys, prefix)
            while i < len(keys) and keys[i].startswith(prefix):
                if keys[i] not in seen:
                    seen.add(keys[i])
                    out.append(keys[i])
                    if len(out) >= limit:
                        return sorted(out)
                i += 1
        return sorted(out)

    # -- writer side ---------------------------------------------------------

    def upsert(
        self, records: Sequence[ObjectRecord], prevalidated: bool = False
    ) -> None:
        """Validate -> delete-by-id -> add -> synchronous commit
        (document.rs:23-67).

        ``prevalidated`` lets Dataset.upsert validate each record ONCE for
        all three per-namespace indexes instead of three times.
        """
        self.validate_required_fields()
        with self._lock:
            builder = SegmentBuilder(self.schema)
            kill_local: set = set()
            touched_committed = False
            # delete-by-id can only tombstone WARM segments; ids written
            # while segments are cold queue a pending delete applied at
            # restore() — otherwise the cold copy resurrects as a
            # duplicate live doc
            queue_cold = bool(self.cold_segments) and self.supports_full_documents()
            cold_pending: set = set()
            # NOTE (r5, VERDICT r4 #6): a columnar bulk add_documents
            # path (per-field encode comprehensions, chunked flushes,
            # early flush on in-chunk id-token collisions) was built and
            # measured against this per-record loop in an interleaved
            # same-day A/B: 0.86-0.96x — SLOWER.  The round-4 pre-encode
            # already removed the per-call ctypes/encode overhead the
            # bulk path targets; the remaining Python is documents.py's
            # per-record field/facet/date assembly, which only a C++
            # doc builder removes.  Reverted; don't re-try Python-level
            # bulking here.
            for record in records:
                if not record.id:
                    raise ValueError("Object ID cannot be empty")
                if not prevalidated:
                    record.validate()

                if self.supports_full_documents():
                    # Tantivy delete_term: the raw id string as one term
                    for seg in self.segments:
                        if seg.delete_by_term("id", record.id):
                            touched_committed = True
                    for d in builder.pending_docs_for_term("id", record.id):
                        kill_local.add(d)
                    if queue_cold:
                        cold_pending.add(record.id)

                for text_fields, facets, stored in self._build_docs(record):
                    builder.add_document(text_fields, facets=facets, stored=stored)

                if builder.approx_bytes >= self.writer_memory_budget:
                    self._freeze(builder, kill_local)
                    builder = SegmentBuilder(self.schema)
                    kill_local = set()

            if cold_pending:
                self._queue_pending_deletes(cold_pending)
            self._commit(builder, kill_local, touched_committed)

    def delete_document(self, doc_id: str) -> None:
        """Delete by id — docs index only (document.rs:81-99)."""
        if not doc_id:
            raise ValueError("Document ID cannot be empty")
        if not self.supports_full_documents():
            raise ValueError(
                f"Delete by ID not supported for {self.index_type.value} index type"
            )
        with self._lock:
            touched = False
            for seg in self.segments:
                if seg.delete_by_term("id", doc_id):
                    touched = True
            if self.cold_segments:
                # the id may live in a cold segment tombstones can't
                # reach — queue it for restore() (silently no-oping here
                # would resurrect the doc)
                self._queue_pending_deletes({doc_id})
                touched = True
            if touched:
                for seg in self.segments:
                    save_tombstones(seg, self.path)
                self._manifest_commit()
                self._invalidate()

    def _queue_pending_deletes(self, terms: set) -> None:
        """Queue delete-by-id terms against the CURRENTLY-cold segments.

        Scoping to today's cold set is what makes a later spill safe: a
        segment spilled after this write may hold the term's NEWEST copy
        (the one this very upsert wrote), and an unscoped delete would
        tombstone it at restore — silently losing the latest write."""
        targets = sorted(self.cold_segments)
        pd = self.manifest.pending_deletes
        for term in terms:
            prev = pd.get(term, ())
            if prev is None:
                continue  # legacy all-cold entry is already a superset
            pd[term] = sorted(set(prev) | set(targets))

    def _manifest_commit(self) -> None:
        """Commit live segments, always carrying cold (spilled) entries."""
        self.manifest.commit(
            self.segments, cold_entries=list(self.cold_segments.values())
        )

    def _build_docs(self, record: ObjectRecord) -> List[docbuild.DocSpec]:
        if self.index_type is IndexType.DOCS:
            return [docbuild.build_full_document(record)]
        if self.index_type is IndexType.QUERY_INDEX:
            return docbuild.build_query_suggestion_documents(record)
        return docbuild.build_filter_documents(record)

    def _freeze(self, builder: SegmentBuilder, kill_local: set) -> None:
        seg = builder.build()
        if kill_local:
            seg.tombstones[sorted(kill_local)] = True
        save_segment(seg, self.path)
        self.segments.append(seg)
        self.compaction_stats["docs_ingested"] += seg.doc_count

    def _commit(
        self, builder: SegmentBuilder, kill_local: set, touched_committed: bool
    ) -> None:
        if builder.doc_count:
            self._freeze(builder, kill_local)
        if touched_committed:
            for seg in self.segments:
                save_tombstones(seg, self.path)
        self._manifest_commit()
        self._invalidate()
        # compaction runs OFF the writer's critical path: the commit only
        # publishes; the worker merges and swaps the manifest atomically
        if self.compaction_mode == "background":
            self._compactor.notify()
        elif self.compaction_mode == "sync":
            while self.run_compaction_pass():
                pass

    def wait_compaction(self, timeout: Optional[float] = None) -> bool:
        """Barrier: block until background compaction is fully drained
        (tests / shutdown / deterministic benchmarks)."""
        return self._compactor.wait_idle(timeout)

    def close(self) -> None:
        """Stop the background compactor (joins an in-flight merge)."""
        self._compactor.close()

    def maybe_merge(self, force: bool = False) -> bool:
        """Explicit compaction entry point.

        ``force=True`` merges ALL live segments into one (the /compact
        endpoint semantics); otherwise runs one tiered policy pass."""
        if not force:
            return self.run_compaction_pass()
        with self._lock:
            if not self.segments:
                return False
            srcs = list(self.segments)
            snaps = [s.tombstones.copy() for s in srcs]
        merged, plan = merge_segments(
            srcs, self.schema, tombstones=snaps, return_plan=True
        )
        return self._swap_merged(srcs, merged, plan)

    def run_compaction_pass(self) -> bool:
        """One tiered-policy pass: select, merge off-lock, swap.

        Returns True when state changed (callers loop until False)."""
        with self._lock:
            candidates = self.merge_policy.select(self.segments)
            if not candidates:
                return False
            srcs = [self.segments[i] for i in candidates[0]]
            snaps = [s.tombstones.copy() for s in srcs]
        from fugu_tpu_torch import telemetry

        with telemetry.compactor_span(self.name):
            merged, plan = merge_segments(
                srcs, self.schema, tombstones=snaps, return_plan=True
            )
            entries = self._maybe_device_merge(srcs, plan, merged)
            return self._swap_merged(srcs, merged, plan, entries)

    def _maybe_device_merge(self, srcs, plan, merged):
        """Rebuild the merged entry pack on the index's device
        (ops/device_merge) when every source's pack is resident there
        (the reference's default rule: compaction never forces uploads),
        so the merged segment serves its first query without uploading
        its pack from the host.  Otherwise None: the pack uploads from
        the host at first query.  Errors propagate out of the pass."""
        if not self.use_device or any(
            s._device_pack is None or s._device_pack.e_doc.device != self.device
            for s in srcs
        ):
            return None
        from fugu_tpu_torch.ops.device_merge import device_merge_entries

        return device_merge_entries(srcs, plan, merged, self.device)

    def _swap_merged(
        self,
        srcs: List[Segment],
        merged: Segment,
        plan: MergePlan,
        device_entries=None,
    ) -> bool:
        """Atomically replace ``srcs`` with ``merged`` in the live list.

        The segment pack is persisted outside the lock (the heavy I/O);
        under the lock the swap (a) verifies every source is still live
        — a concurrent force-merge or spill may have consumed them, in
        which case this merge is discarded — and (b) forwards deletes
        that landed after the merge's tombstone snapshot through the
        doc remap, so a racing ``delete_document`` is never lost."""
        save_segment(merged, self.path)
        with self._lock:
            positions = []
            for s in srcs:
                pos = next(
                    (j for j, t in enumerate(self.segments) if t is s), None
                )
                if pos is None:
                    # source vanished (force-merge/spill raced us): the
                    # merged result is stale — drop its files and report
                    # "changed" so the worker re-selects from fresh state.
                    # gc_ids, not a directory scan: another merge's
                    # saved-but-unpublished pack must survive.
                    self.manifest.gc_ids([merged.segment_id])
                    return True
                positions.append(pos)
            changed_tombs = False
            for s, snap, remap in zip(srcs, plan.tomb_snapshots, plan.remaps):
                newly = s.tombstones & ~snap
                if newly.any():
                    merged.tombstones[remap[np.nonzero(newly)[0]]] = True
                    changed_tombs = True
            if changed_tombs:
                save_tombstones(merged, self.path)
            if device_entries is not None:
                # attach AFTER delete reconciliation so the pack's
                # tombstone words include any forwarded deletes
                from fugu_tpu_torch.ops.device_merge import attach_device_pack

                attach_device_pack(merged, device_entries)
            pos0 = min(positions)
            drop = set(positions)
            self.segments = [
                (merged if j == pos0 else t)
                for j, t in enumerate(self.segments)
                if j == pos0 or j not in drop
            ]
            self._manifest_commit()
            # delete exactly the consumed sources — a directory scan
            # here would race a concurrent merge's unpublished pack
            self.manifest.gc_ids([s.segment_id for s in srcs])
            self._invalidate()
            self.compaction_stats["merges"] += 1
            self.compaction_stats["docs_written"] += merged.doc_count
            self.compaction_stats["entries_written"] += merged.n_entries
        return True

    # -- spill / restore (cold-namespace tier, storage.spill) ----------------

    def spill(self, spiller) -> None:
        """Offload all committed segments to the remote tier and drop them
        from memory; the manifest stays authoritative for restore."""
        with self._lock:
            # accumulate locally and publish with the list swap, so
            # lockless stats readers never see a segment counted both
            # warm and cold during the (slow, per-segment) remote writes
            cold = {}
            for seg in self.segments:
                spiller.spill(self.path, seg.segment_id)
                cold[seg.segment_id] = {
                    "id": seg.segment_id,
                    "doc_count": seg.doc_count,
                    "live_docs": int(seg.num_live_docs),
                }
            self.spill_gen += 1
            self.cold_segments.update(cold)
            self.segments = []
            # publish the cold entries (with live counts) so a restart
            # keeps reporting accurate stats for the offloaded namespace
            self._manifest_commit()
            self._invalidate()

    def restore(self, spiller=None) -> int:
        """Bring every cold segment back from the remote tier.

        Without an explicit ``spiller``, each segment's ``.spilled``
        marker (which records the remote prefix it was spilled to) is
        used — restore is self-describing across restarts.  Returns the
        number of segments restored from remote."""
        from fugu_tpu_torch.storage.spill import SegmentSpiller

        with self._lock:
            self.manifest.load()
            from fugu_tpu_torch.index.manifest import load_segment

            cold_ids = set(self.cold_segments)
            segs = []
            restored = 0
            for sid in self.manifest.segment_ids:
                marker = self.path / f"seg-{sid}.spilled"
                sp = spiller
                if sp is None and marker.exists():
                    prefix = marker.read_text().strip()
                    if prefix:
                        sp = SegmentSpiller(prefix)
                if sp is not None and sp.is_spilled(self.path, sid):
                    sp.restore(self.path, sid)
                    restored += 1
                    cold_ids.add(sid)
                # a failed fetch leaves the marker in place and the pack
                # absent; load_segment then raises and the state below is
                # never committed (the segment stays recorded as cold)
                segs.append(load_segment(self.path, sid, self.schema))
            # apply delete-by-id terms queued while these segments were
            # cold (Manifest.pending_deletes): tombstones could not reach
            # them at write time, and skipping this would resurrect
            # overwritten/deleted docs as duplicates
            pending = self.manifest.pending_deletes
            if pending and self.supports_full_documents():
                touched = []
                for seg in segs:
                    if seg.segment_id not in cold_ids:
                        continue  # warm copies were tombstoned at write
                    hit = False
                    for d, targets in pending.items():
                        # each term is scoped to the segments that were
                        # cold when it was queued (None = legacy
                        # all-cold): a segment spilled LATER may hold
                        # the term's newest copy
                        if targets is not None and seg.segment_id not in targets:
                            continue
                        hit = seg.delete_by_term("id", d) or hit
                    if hit:
                        touched.append(seg)
                for seg in touched:
                    save_tombstones(seg, self.path)
            self.segments = segs
            self.cold_segments.clear()
            if pending:
                # durably clear: a stale pending list would re-apply old
                # deletes to FUTURE spill/restore cycles of these ids
                self.manifest.pending_deletes = {}
                self._manifest_commit()
            self._invalidate()
            return restored

    @property
    def has_cold(self) -> bool:
        """True when any committed segment is offloaded (queries served
        now would be silently partial)."""
        return bool(self.cold_segments)

    @property
    def is_loaded(self) -> bool:
        return bool(self.segments) or not self.manifest.segment_ids

    # -- capability flags (core.rs:484-497) ----------------------------------

    def supports_full_documents(self) -> bool:
        return self.index_type is IndexType.DOCS

    def supports_facet_filtering(self) -> bool:
        return self.index_type in (IndexType.DOCS, IndexType.FILTER_INDEX)

    def supports_query_suggestions(self) -> bool:
        return self.index_type is IndexType.QUERY_INDEX
