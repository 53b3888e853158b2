"""Sharded two-phase batch engine: phase A per shard, one candidate
selection over every shard's maxima, pruned sharded re-scoring.

The counterpart of ``fugu_tpu/parallel/batch_sharded.py``.  The
single-device engine (ops/batch_scorer) streams the whole segment once
per query batch and re-scores only the blocks whose per-block maxima can
still reach the kth score.  This module runs the same two phases over a
mesh:

- **Sharded block-major packs**: each shard holds the block-major pack
  of ITS doc range (local doc ids, local 512-doc blocks, each doc's
  entries contiguous with its per-doc offsets ``doc_offs``) but with
  GLOBAL term ids (index/segment.py ``entry_term_contribs``), so the
  batch's weights and term table are the same for every shard — staging
  is the single-device engine's.  Each shard's ``doc_offs`` has
  ``nbs_pad`` rows; the rows past its blocks hold no entries.
- **Phase A per shard**: one ``batch_scorer.phasea`` launch per shard
  per stream, on the shard's device, emitting [nbs_pad, F, B] maxima;
  these are concatenated on the root device along the block axis and
  ``batch_scorer.postproc`` runs ONCE over the ``d * nbs_pad`` blocks,
  so the kth of the maxima is the global one and only the candidate
  mask crosses to the host.
- **Phase B**: each query's candidate fine ids split back into
  per-shard lists of local 2048-doc blocks, which restrict the sharded
  block scorer (parallel/block_sharded ``block_lists``); its merge gives
  the global top k.

Kinds "pure"/"neg"/"gate"/"exact"/"shift" run in one wave, as on one
device (the kth-of-maxima is a global bound: per-shard maxima are
gathered before thresholding).  "upper"-kind plans and plans with a
nonpositive weight return None: the caller's plain sharded block scorer
or host chain serves them exactly.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from fugu_tpu_torch.index.segment import (
    BM_BLOCK_DOCS,
    BM_CHUNK,
    Segment,
    block_doc_offsets,
    block_major_from_numpy,
    entry_term_contribs,
    pack_block_major,
)
from fugu_tpu_torch.ops import batch_scorer
from fugu_tpu_torch.ops.batch_scorer import (
    B_BUCKETS,
    GATE_MARGIN,
    MIN_BATCH,
    NARROW_KINDS,
    U_BUCKETS,
    _classify,
    _effective_kinds,
    _fine_for_stream,
    _merge_streams,
    _nb_pad,
    plan_batches,
    postproc,
    stage_batch_weights,
    weight_lists,
)
from fugu_tpu_torch.ops.block_scorer import BLOCK as B_BLOCK, MAX_K
from fugu_tpu_torch.ops.staging import has_nonpositive_weight
from fugu_tpu_torch.parallel.block_sharded import (
    BlockShardedPack,
    block_sharded_search_batch,
)
from fugu_tpu_torch.parallel.sharded import Mesh, shard_bounds
from fugu_tpu_torch.query import QueryPlan


class ShardedBlockMajor:
    """Per-shard block-major packs over a segment's doc ranges.

    Shard bounds match parallel/sharded.ShardedPack exactly (the same
    (s*n)//d split), so phase-B candidate blocks map 1:1 onto the
    sharded block scorer's local block space.  ``packs[s]`` is shard
    ``s``'s (doc, tid, con, doc_offs) on its device."""

    def __init__(self, segment: Segment, mesh: Mesh, stats):
        self.mesh = mesh
        self.segment = segment
        d = mesh.size
        self.n_shards = d
        bounds = shard_bounds(segment.doc_count, d)
        self.bounds = bounds

        e = segment.n_entries
        tid_entry, contrib, self.tid_of, self.n_terms = entry_term_contribs(
            segment, stats
        )
        # a stable pre-sort by doc (BlockMajorPack's, with torch's
        # threaded sort): doc-major blocks, each doc's entries in term
        # order, and each shard's entries one contiguous run
        def host(a):
            return torch.from_numpy(np.require(a, requirements="W"))

        docs, order = torch.sort(host(segment.e_doc[:e]), stable=True)
        docs = docs.numpy()
        tids = host(tid_entry)[order].numpy()
        cons = host(contrib)[order].numpy()
        cut = np.searchsorted(docs, bounds)

        self.nbs: List[int] = []  # real local block count per shard
        #: real entries per shard (a shard without any launches nothing)
        self.n_entries: List[int] = []
        hosts = []
        for s in range(d):
            lo, hi = int(cut[s]), int(cut[s + 1])
            local = (docs[lo:hi] - bounds[s]).astype(np.int64)
            arrs = pack_block_major(local, tids[lo:hi], cons[lo:hi],
                                    max(bounds[s + 1] - bounds[s], 1))
            hosts.append((arrs, block_doc_offsets(local, arrs[3], arrs[4])))
            self.nbs.append(arrs[4])
            self.n_entries.append(hi - lo)

        self.nbs_pad = _nb_pad(max(self.nbs))
        self.packs = []
        #: bytes each device holds of this pack
        self.device_bytes: Dict[torch.device, int] = {}
        for s, ((bm_doc, bm_tid, bm_con, chunk_offs, nb_s), offs) in enumerate(
            hosts
        ):
            # padded blocks: their first and last offsets equal, no entry
            doc_offs = np.full((self.nbs_pad, BM_BLOCK_DOCS + 1),
                               int(chunk_offs[-1]) * BM_CHUNK, dtype=np.int32)
            doc_offs[:nb_s] = offs
            dev = mesh.devices[s]
            # bf16 contributions, as the single-device BlockMajorPack's
            self.packs.append(
                block_major_from_numpy(bm_doc, bm_tid, bm_con, doc_offs, dev))
            self.device_bytes[dev] = self.device_bytes.get(dev, 0) + (
                bm_doc.nbytes + bm_tid.nbytes + bm_con.nbytes // 2
                + doc_offs.nbytes)

    @property
    def resident_bytes(self) -> int:
        """The bytes the residency budget accounts for this pack: what
        its fullest device holds."""
        return max(self.device_bytes.values())


def batch_search_sharded(
    pack2: ShardedBlockMajor,
    spack: BlockShardedPack,
    plans: Sequence[QueryPlan],
    stats,
    limits: Sequence[int],
) -> List[Optional[List[Tuple[float, int]]]]:
    """Two-phase sharded batch search; None entries = caller fallback
    (the plain sharded block scorer, then the host chain)."""
    results: List[Optional[List[Tuple[float, int]]]] = [None] * len(plans)
    kinds = {}
    for i, p in enumerate(plans):
        if limits[i] > MAX_K:
            continue
        kind = _classify(p)
        # "upper" needs raw maxima host-side (two waves); the plain
        # sharded scorer handles those exactly
        if kind is not None and has_nonpositive_weight(p, stats):
            kind = None  # 'scores > 0 == matched' breaks; host fallback
        if kind is not None and kind != "upper":
            kinds[i] = kind
    # narrow kinds first so plan_batches' narrow/wide boundary doesn't
    # split the batch at every kind flip (mirrors the single-device sort)
    elig = sorted(kinds, key=lambda i: (kinds[i] not in NARROW_KINDS, i))
    mesh = pack2.mesh
    root = mesh.root
    # a phase-A stream needs a real batch to pay for itself; on the CPU
    # (tests) every batch takes it, as on one device
    if len(elig) < (1 if root.type == "cpu" else MIN_BATCH):
        return results

    k1 = plans[elig[0]].k1
    batches, batch_terms = plan_batches(plans, elig, kinds, pack2.tid_of)
    # every shard runs the same lanes and streams, so the single-device
    # cost model's merge decision transfers verbatim
    batches, batch_terms = _merge_streams(
        batches, batch_terms, kinds, plans, pack2.tid_of
    )

    d = pack2.n_shards
    nbs_pad = pack2.nbs_pad
    nb_tot = d * nbs_pad

    pending = []
    shifts: Dict[int, float] = {}
    for q_idx, terms in zip(batches, batch_terms):
        u_pad = next((u for u in U_BUCKETS if len(terms) <= u), None)
        if u_pad is None:
            continue  # over-wide union: caller fallback
        b_pad = next(v for v in B_BUCKETS if len(q_idx) <= v)
        wide = any(kinds[i] not in NARROW_KINDS for i in q_idx)
        eff = _effective_kinds(plans, kinds, q_idx, wide)
        is_packed = False
        if wide and b_pad >= batch_scorer._PACK_MIN_B:
            order = batch_scorer._pack_order(q_idx, plans, pack2.tid_of,
                                             b_pad // 2)
            if order is not None:
                q_idx = order
                is_packed = True
        w2, nmust, tid_arr = stage_batch_weights(
            plans, eff, q_idx, terms, stats, pack2.tid_of, b_pad, wide,
            k1, shifts, packed=is_packed,
        )
        slot_of = np.full(max(pack2.n_terms, 1), -1, dtype=np.int32)
        for t, slot in terms.items():
            slot_of[t] = slot
        fine = _fine_for_stream(q_idx, limits)
        nz_off, nz = weight_lists(torch.from_numpy(w2).to(torch.bfloat16))
        host_ops = (nz_off, nz, torch.from_numpy(slot_of),
                    torch.from_numpy(nmust[0]))
        dev_ops: Dict[torch.device, list] = {}  # one upload a device
        maxima = []
        for s, (doc, tid, con, doc_offs) in enumerate(pack2.packs):
            dev = mesh.devices[s]
            if not pack2.n_entries[s]:
                # no posting in the shard: no doc passes
                maxima.append(torch.full((nbs_pad, fine, b_pad),
                                         float("-inf"), device=root))
                continue
            ops = dev_ops.get(dev)
            if ops is None:
                ops = dev_ops[dev] = [a.to(dev) for a in host_ops]
            amax = batch_scorer.phasea(doc_offs, doc, tid, con, ops[0],
                                       ops[1], w2.shape[1], ops[2], ops[3],
                                       fine)
            maxima.append(amax.to(root))
        k_top = min(128, nb_tot * fine)
        shift_v = np.zeros(b_pad, dtype=np.float32)
        limidx = np.full(b_pad, -1, dtype=np.int32)
        margin_v = np.zeros(b_pad, dtype=np.float32)
        for qi, i in enumerate(q_idx):
            if i is None:
                continue
            shift_v[qi] = shifts.get(i, 0.0)
            limidx[qi] = limits[i] - 1 if limits[i] <= k_top else -1
            # EFFECTIVE kind, as in batch_scorer: gate plans folded into
            # wide streams restage as shift/exact (no GATE_BIG terms),
            # so the gate quantization margin would only loosen their
            # thresholds for nothing
            if eff[i] == "gate":
                margin_v[qi] = GATE_MARGIN
        # the kth of every shard's maxima: [d * nbs_pad, F, B] at once
        mask, count = postproc(
            torch.cat(maxima),
            *(torch.from_numpy(a).to(root) for a in (shift_v, limidx,
                                                      margin_v)),
        )
        pending.append((q_idx, mask, count, fine))

    if not pending:
        return results

    sub_per_big = B_BLOCK // BM_BLOCK_DOCS
    wave_idx: List[int] = []
    wave_lists: Dict[int, List[np.ndarray]] = {}
    for q_idx, mask, count, fine in pending:
        mask = mask.cpu().numpy()    # [nb_tot * F, b_pad]
        count = count.cpu().numpy()  # [b_pad]
        for qi, i in enumerate(q_idx):
            if i is None:
                continue
            if count[qi] == 0:
                results[i] = []  # no doc scores any positive clause
                continue
            cand = np.unique(np.nonzero(mask[:, qi])[0] // fine)  # 512-blocks
            # global index -> (shard, local 512-block) -> the sharded
            # block scorer's local 2048-doc block ids; per-shard padded
            # tail blocks (>= nbs[s]) are -inf unless the query fell
            # back to a full sweep — drop them here either way
            per_shard: List[np.ndarray] = []
            for s in range(d):
                lb = cand[(cand >= s * nbs_pad) & (cand < (s + 1) * nbs_pad)]
                lb = lb - s * nbs_pad
                lb = lb[lb < pack2.nbs[s]]
                per_shard.append(
                    np.unique(lb // sub_per_big).astype(np.int64)
                )
            wave_lists[i] = per_shard
            wave_idx.append(i)

    by_limit: Dict[int, List[int]] = {}
    for i in wave_idx:
        by_limit.setdefault(limits[i], []).append(i)
    for lim, ii in by_limit.items():
        sub = block_sharded_search_batch(
            spack,
            [plans[i] for i in ii],
            stats,
            lim,
            block_lists={j: wave_lists[i] for j, i in enumerate(ii)},
        )
        for j, i in enumerate(ii):
            results[i] = sub[j]
    return results
