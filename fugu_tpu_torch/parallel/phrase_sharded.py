"""Sharded phrase stream: the corpus-sweep phrase engine
(ops/phrase_stream) over a doc-range-sharded mesh.

The counterpart of ``fugu_tpu/parallel/phrase_sharded.py``.  The phrase
kernel has no state across 512-doc blocks, so doc-range sharding is the
same move as phase A's (parallel/batch_sharded):

- **ShardedTokenStream**: each shard holds the forward token stream of
  ITS doc range on its device (local doc ids via
  ops/phrase_stream.build_stream_arrays with [doc_lo, doc_hi), and the
  per-doc row table ``stream_doc_rows`` the kernel walks); per-field term
  ordinals are segment-global, so one staging serves every shard.
- **Kernel per shard**: every shard sweeps its stream with the
  unchanged phrase kernel (``phrase_stream.phrase_stream``); the
  [nb_pad, F, B] maxima and classes are concatenated on the root device
  along the block axis and ``phrase_post`` runs ONCE for the global
  top-K bounds; only the [B, 3K + 1] bound buffer crosses to the host.
  A shard with no docs launches nothing (its maxima are -inf).
- **Host phase B**: global padded fine ids map to per-shard doc windows
  (clamped at shard bounds so a tail block never overlaps the next
  shard's block 0), then the same margin-free ordered verification
  (ops/phrase_stream._rescore_blocks with lo/hi tables) reproduces
  bit-exact results.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from fugu_tpu_torch.index.segment import BM_BLOCK_DOCS, Segment
from fugu_tpu_torch.ops import phrase_stream as ps
from fugu_tpu_torch.ops import residency
from fugu_tpu_torch.ops.batch_scorer import BM_FINE_DOCS, FINE_PER_BLOCK, _nb_pad
from fugu_tpu_torch.ops.phrase_stream import (
    PHRASE_MIN_BATCH,
    _rescore_blocks,
    build_stream_arrays,
    eligible_phrase,
    phrase_post,
    split_dispatch_groups,
    stage_group,
    stream_doc_rows,
)
from fugu_tpu_torch.parallel.sharded import Mesh, shard_bounds
from fugu_tpu_torch.query import PhraseClause, QueryPlan


class _Shard(NamedTuple):
    """One shard's stream operands on its device (see TokenStreamPack)."""

    d_offs: torch.Tensor
    d_doc_row: torch.Tensor
    d_tok: torch.Tensor
    d_cv: torch.Tensor
    d_fid: torch.Tensor


class ShardedTokenStream:
    """Per-shard token streams of one (segment, field) over a mesh's doc
    ranges, each on its shard's device (``shards[s]``, None for a shard
    without docs)."""

    def __init__(self, segment: Segment, field: str, mesh: Mesh, stats):
        self.mesh = mesh
        self.segment = segment
        self.field = field
        d = mesh.size
        self.n_shards = d
        bounds = shard_bounds(segment.doc_count, d)
        self.bounds = bounds

        nb_max = 1
        for s in range(d):
            nb_max = max(
                nb_max,
                (bounds[s + 1] - bounds[s] + BM_BLOCK_DOCS - 1)
                // BM_BLOCK_DOCS,
            )
        self.nb_pad = _nb_pad(nb_max)
        hosts = []
        for s in range(d):
            if bounds[s + 1] == bounds[s]:
                hosts.append(None)
                continue
            arrs = build_stream_arrays(
                segment,
                field,
                stats,
                doc_lo=bounds[s],
                doc_hi=bounds[s + 1],
                nb_pad=self.nb_pad,
            )
            if not arrs.ok:
                self.ok = False
                return
            doc_row = stream_doc_rows(segment, field, self.nb_pad,
                                      bounds[s], bounds[s + 1])
            hosts.append((arrs.chunk_offs, doc_row, arrs.pack, arrs.cv,
                          arrs.fid))
            self.tid_of, self.n_terms = arrs.tid_of, arrs.n_terms
        self.ok = True

        #: bytes each device holds of this stream
        self.device_bytes: Dict[torch.device, int] = {}
        for s, h in enumerate(hosts):
            if h is not None:
                dev = mesh.devices[s]
                self.device_bytes[dev] = self.device_bytes.get(dev, 0) + sum(
                    a.nbytes for a in h)
        # the budget models one device's memory: reserve what the fullest
        # device holds (on one card, every shard's bytes)
        residency.reserve(
            ("stok", id(segment), field),
            max(self.device_bytes.values()),
            segment,
            _evict_sharded_stream,
            kind="token_stream",
        )
        self.shards: List[Optional[_Shard]] = [
            None if h is None else _Shard(
                *(torch.from_numpy(a).to(mesh.devices[s]) for a in h))
            for s, h in enumerate(hosts)
        ]

        # global padded fine id -> clamped doc windows, monotone in id:
        # shard s, local fine f covers global docs [bounds[s] + f*FINE,
        # min(..., bounds[s+1])); padded local blocks get the empty
        # window [bounds[s+1], bounds[s+1]) so monotonicity holds
        nb2_local = self.nb_pad * FINE_PER_BLOCK
        gid = np.arange(d * nb2_local, dtype=np.int64)
        s_of = gid // nb2_local
        rem = gid % nb2_local
        b_lo = np.asarray(bounds, dtype=np.int64)
        lo = b_lo[s_of] + rem * BM_FINE_DOCS
        hi = np.minimum(lo + BM_FINE_DOCS, b_lo[s_of + 1])
        lo = np.minimum(lo, b_lo[s_of + 1])
        self.lo_table = lo
        self.hi_table = hi


def _evict_sharded_stream(segment: Segment) -> None:
    cache = getattr(segment, "_sharded_token_stream", None)
    if isinstance(cache, dict):
        cache.clear()


def get_sharded_token_stream(
    segment: Segment, field: str, mesh: Mesh, stats
) -> Optional[ShardedTokenStream]:
    """Cached per-(field, mesh) ShardedTokenStream (same fingerprint
    scheme as the single-device get_token_stream; residency-managed)."""
    if field not in segment.pos_offsets:
        return None
    cache = getattr(segment, "_sharded_token_stream", None)
    if not isinstance(cache, dict):
        cache = {}
        object.__setattr__(segment, "_sharded_token_stream", cache)
    key = (field, id(mesh))
    hit = cache.get(key)
    if hit is not None and hit[0] == stats.fingerprint:
        residency.touch(("stok", id(segment), field))
        return hit[1]
    pack = ShardedTokenStream(segment, field, mesh, stats)
    if not pack.ok:
        return None
    cache[key] = (stats.fingerprint, pack)
    if not residency.contains(("stok", id(segment), field)):
        cache.pop(key, None)
    return pack


def _dispatch_sharded(pack: ShardedTokenStream, q_idx, clauses, stats, smax):
    """Stage one dispatch group once, launch the phrase kernel on every
    shard with docs, and run the postproc over the concatenated maxima
    on the root device (all asynchronous on the devices' streams)."""
    qterm, qslop, wp, slot_of, _u, b_pad, _k = stage_group(
        pack.tid_of, pack.n_terms, q_idx, clauses, stats, smax
    )
    root = pack.mesh.root
    dev_ops: Dict[torch.device, list] = {}  # one upload a device
    maxima, classes = [], []
    for s, sh in enumerate(pack.shards):
        if sh is None:
            shape = (pack.nb_pad, FINE_PER_BLOCK, b_pad)
            maxima.append(torch.full(shape, float("-inf"), device=root))
            classes.append(torch.full(shape, -1, dtype=torch.int32,
                                      device=root))
            continue
        dev = pack.mesh.devices[s]
        ops = dev_ops.get(dev)
        if ops is None:
            ops = dev_ops[dev] = [torch.from_numpy(a).to(dev)
                                  for a in (qterm, qslop, wp, slot_of)]
        amax, acls = ps.phrase_stream(
            sh.d_offs, sh.d_doc_row, sh.d_tok, sh.d_cv, sh.d_fid, *ops, smax,
        )
        maxima.append(amax.to(root))
        classes.append(acls.to(root))
    return (q_idx, phrase_post(torch.cat(maxima), torch.cat(classes)), pack)


def phrase_stream_sharded_begin(
    segment: Segment,
    mesh: Mesh,
    plans: Sequence[QueryPlan],
    stats,
    limits: Sequence[int],
):
    """Sharded analog of ops/phrase_stream.phrase_stream_begin: stage
    and dispatch eligible phrase plans over the mesh; returns a handle
    for :func:`phrase_stream_sharded_collect`."""
    pre: List[Optional[List[Tuple[float, int]]]] = [None] * len(plans)
    staged: List[Tuple[int, PhraseClause]] = []
    by_field: Dict[str, List[int]] = {}
    clauses: Dict[int, PhraseClause] = {}
    for i, plan in enumerate(plans):
        pc = eligible_phrase(plan)
        if pc is None or limits[i] > 128:
            continue
        clauses[i] = pc
        by_field.setdefault(pc.field, []).append(i)

    min_batch = 1 if mesh.root.type == "cpu" else PHRASE_MIN_BATCH
    dispatches = []
    for field, idxs in sorted(by_field.items()):
        pack = get_sharded_token_stream(segment, field, mesh, stats)
        if pack is None:
            continue
        run = []
        for i in idxs:
            if any(t not in pack.tid_of for t in clauses[i].terms):
                pre[i] = []  # absent terms match nothing
            else:
                run.append(i)
        if len(run) < min_batch:
            for i in run:
                del clauses[i]  # host path serves these
            continue
        for q_idx, smax in split_dispatch_groups(run, clauses):
            dispatches.append(
                _dispatch_sharded(pack, q_idx, clauses, stats, smax)
            )
            for i in q_idx:
                staged.append((i, clauses[i]))
    return (pre, staged, dispatches, segment, stats, list(limits))


def phrase_stream_sharded_collect(handle):
    """Fetch per-query ordered block bounds (already globally top-K'd
    over the mesh) and host-verify in bound order — results are aligned
    with begin's plans (None = not served here) and bit-identical to
    the single-device engine/oracle."""
    pre, staged, dispatches, segment, stats, limits = handle
    results = list(pre)
    if not dispatches:
        return results

    bufs = [b.cpu().numpy() for _q, b, _p in dispatches]
    clause_of = dict(staged)
    for (q_idx, _b, pack), buf in zip(dispatches, bufs):
        k = (buf.shape[1] - 1) // 3
        nb2_global = len(pack.lo_table)
        for qi, i in enumerate(q_idx):
            row = buf[qi]
            count = int(row[-1])
            if count == 0:
                results[i] = []
                continue
            ids = row[k : 2 * k].astype(np.int64)
            cls = row[2 * k : 3 * k].astype(np.int64)
            take = min(count, k)
            keep = ids[:take] < nb2_global
            results[i] = _rescore_blocks(
                segment,
                clause_of[i],
                stats,
                ids[:take][keep],
                cls[:take][keep],
                count > k,
                limits[i],
                lo_table=pack.lo_table,
                hi_table=pack.hi_table,
            )
    return results


def batch_phrase_search_sharded(
    segment: Segment,
    mesh: Mesh,
    plans: Sequence[QueryPlan],
    stats,
    limits: Sequence[int],
) -> List[Optional[List[Tuple[float, int]]]]:
    """Synchronous begin+collect (None entries = caller's host path)."""
    return phrase_stream_sharded_collect(
        phrase_stream_sharded_begin(segment, mesh, plans, stats, limits)
    )
