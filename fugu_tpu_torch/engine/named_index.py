"""NamedIndex, reader side: one logical index directory served on a GPU.

The counterpart of the reader half of ``fugu_tpu/engine/named_index.py``.
It opens a manifest directory in fugu_tpu's own format (meta.json,
``seg-*.npz``, tombstones, doc store) and answers top-k queries from it
exactly as the reference does: the same hits, the same score floats, in
the same order.  The writer side (upsert, commit, compaction, spill)
is not part of the port yet.

Every segment goes through the hybrid device engine (the reference's
``FUGU_ENGINE=pallas`` configuration): the two-phase batch engine, then
the block scorer for the plans phase A declines, then the host block-max
engine or the oracle for the plans both decline by design (phrases,
more than 16 clauses or 32 groups, a nonpositive weight, limit above
128).  Quoted phrases take the phrase stream (ops/phrase_stream) where
its routing cost model sends them, as the reference's default does, and
the host matcher otherwise.  Device errors propagate to the caller;
there is no device-to-host fallback.
"""

from __future__ import annotations

import threading
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from fugu_tpu_torch import device as device_mod
from fugu_tpu_torch.index.manifest import Manifest, load_segment
from fugu_tpu_torch.index.schema import IndexSchema, IndexType, SCHEMAS
from fugu_tpu_torch.index.segment import Segment
from fugu_tpu_torch.ops import oracle as oracle_ops
from fugu_tpu_torch.query import QueryPlan

#: plans whose segment has fewer postings than this run on the host
#: (device launch overhead dominates tiny segments)
DEVICE_MIN_ENTRIES = 4096


def device_engine(seg: Segment, plans, stats, limit: int,
                  device: torch.device, routes: Optional[dict] = None):
    """Top-``limit`` [(score, doc)] of each plan on one segment through
    the hybrid engine.  ``routes``, when given, counts the plans each
    engine answered ("phase_a", "block_scorer", "host")."""
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


class NamedIndex:
    """A committed index directory, opened read-only on ``device``."""

    def __init__(
        self,
        name: str,
        path: Path,
        index_type: IndexType,
        device: Union[str, torch.device] = "cuda",
    ):
        self.name = name
        self.path = Path(path)
        self.index_type = index_type
        self.schema: IndexSchema = SCHEMAS[index_type]
        self.device = device_mod.resolve(device)
        self.manifest = Manifest(self.path)
        self.segments: List[Segment] = []
        if not self.manifest.load():
            raise FileNotFoundError(f"no manifest in {self.path}")
        for entry in self.manifest.entries:
            self.segments.append(
                load_segment(self.path, entry["id"], self.schema)
            )
        self._stats: Optional[oracle_ops.IndexStats] = None
        self._snap_stats: Optional[tuple] = None
        #: plans answered per engine ("phase_a", "block_scorer", "host",
        #: "phrase_stream", "host_only") since the index was opened
        self.routes: Dict[str, int] = {}

    @property
    def num_docs(self) -> int:
        return sum(s.num_live_docs for s in self.segments)

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

    def searcher_segments(self) -> List[Segment]:
        """A consistent segment snapshot — pass it back to
        search_topk_batch and use it to resolve hit ordinals to stored
        docs."""
        return list(self.segments)

    def _phrase_stream_begin(self, seg, plans, host_only_idx, n_device,
                             stats, limit):
        """Launch the phrase stream for ``host_only_idx`` on ``seg`` when
        the routing cost model wants it (the reference's default auto
        mode), else None.  The concurrent device batch of ``n_device``
        plans sweeps only this segment, so its overlap credit scales by
        the segment's share of the index's tokens."""
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
        for ord_, seg in enumerate(segments):
            on_device = seg.n_entries >= DEVICE_MIN_ENTRIES
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
                seg, plans, host_only_idx, len(device_idx), stats, limit
            ) if host_only_idx and on_device else None
            phrase_host_idx = host_only_idx
            if stream_handle is not None:
                pre, staged = stream_handle[0], stream_handle[1]
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
            try:
                if device_idx:
                    batch_res = device_engine(
                        seg, [plans[i] for i in device_idx], stats, limit,
                        self.device, self.routes,
                    )
                    res_map = dict(zip(device_idx, batch_res))
                if stream_handle is not None:
                    from fugu_tpu_torch.ops.phrase_stream import (
                        phrase_stream_collect,
                    )

                    for j, r in enumerate(phrase_stream_collect(stream_handle)):
                        if r is not None:
                            host_map[host_only_idx[j]] = r
            finally:
                if host_thread is not None:
                    host_thread.join()
            n_stream = len(host_only_idx) - len(phrase_host_idx)
            self.routes["phrase_stream"] = (
                self.routes.get("phrase_stream", 0) + n_stream
            )
            self.routes["host_only"] = (
                self.routes.get("host_only", 0) + len(phrase_host_idx)
            )
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
