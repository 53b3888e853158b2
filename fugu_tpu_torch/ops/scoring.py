"""The small-segment engine: BM25 + boolean algebra + top-k as torch ops.

The counterpart of ``fugu_tpu/ops/scoring.py``'s device half (its host
half is ``ops/staging.py``).  The reference's engine is an XLA program,
not a kernel, so here it is a sequence of PyTorch calls on the index's
device; the same calls run on CPU tensors when the index's device is
``cpu``.  One dispatch scores B queries over one segment:

1. **Window read** — each clause's postings are a contiguous range of
   the segment's (doc, tf|fid) entry pack.  A ``[B, T, L]`` index of
   ``starts + lane`` is clamped to the pack and masked by ``lane <
   lens``, so a window may hang over the end of the pack: no plan is
   declined for where its term lies.
2. **BM25 contribution** — ``w * (tf / (tf + (c1 + c2 * norm)))`` with
   the fieldnorm decoded through a 256-entry table.  Facet clauses have
   ``c2 == 0`` and score the constant idf.
3. **Merge** — one stable sort of the doc keys per row
   (:func:`merge_sorted_rows`).  Padding lanes carry ``DOC_SENTINEL``
   and sink to the tail; equal docs keep clause order.
4. **Run aggregation** — a doc's run is at most T long, so its score is
   T - 1 shifted adds, taken from the far end of the run inwards: every
   doc's clauses are summed first to last, in one fixed order, with no
   atomics.  The group bits are OR-ed the same way.
5. **Masks and top k** — run ends that pass MUST / MUST_NOT / SHOULD
   and are not tombstoned keep their score.  Selection is ``topk`` over
   one int64 key a lane, (score descending, doc ascending): keys are
   unique, so ties have one answer, the lowest docs.

Final scores are recomputed on the host by ``ops/rescore.py`` in the
oracle's own float order and re-ranked.
"""

from __future__ import annotations

import threading
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from fugu_tpu_torch.index.segment import DOC_SENTINEL, Segment
from fugu_tpu_torch.ops import buckets
from fugu_tpu_torch.ops.rescore import rescore_hits
from fugu_tpu_torch.ops.staging import (
    NEG_INF,
    ClauseArgs,
    decode_fid,
    mask_i32,
    stage_clauses,
)
from fugu_tpu_torch.query import Occur, QueryPlan

#: cap on B*T*L lanes of one dispatch.  It bounds the bytes of a
#: dispatch's intermediates: a lane holds doc, contribution and bits
#: (12 B), the sort's keys and int64 order (12 B), the gathered
#: contribution and bits (8 B), the running sum and OR with one shifted
#: operand (12 B) and the int64 selection key (8 B) — about 52 B at the
#: peak, with the window index (8 B) and the tf / norm temporaries freed
#: before the sort.  16 Mi lanes keep a dispatch under 1 GiB (906-943
#: MB measured above what was resident on an H100, chip_smoke.py's
#: ladder), so the server's executor threads together stay within a few
#: GiB.
MAX_BATCH_LANES = 16 * 1024 * 1024
#: the engine handles up to this many clauses; beyond -> host chain
MERGE_MAX_T = 16
#: candidates extracted past the limit, so that the host rescore sees
#: the docs just behind the boundary (a last-ulp difference between the
#: device's sum and the oracle's must not exclude the true k-th doc)
RESCORE_SLACK = 16
#: a chunk may pad its rows up to this many times their own lanes, or
#: to PAD_FREE_LANES where that is more, before another chunk opens
PAD_FACTOR = 4
PAD_FREE_LANES = 1 << 20

#: dispatches launched since import (the smoke reads it; nothing else)
launches = 0
_launches_lock = threading.Lock()

_INT64_MAX = (1 << 63) - 1
_SENTINEL = int(DOC_SENTINEL)


def merge_sorted_rows(keys: torch.Tensor, *payloads: torch.Tensor):
    """Merge T sorted rows ``[..., T, L]`` into one sorted row
    ``[..., T*L]``, ascending; the payloads travel with their keys.

    One stable sort along the flattened row: among equal keys the lower
    row comes first, so a doc's entries stay in clause order.  Sentinel
    keys sink to the tail.
    """
    flat = keys.flatten(-2)
    out, order = torch.sort(flat, dim=-1, stable=True)
    return (out,) + tuple(
        p.flatten(-2).gather(-1, order) for p in payloads
    )


def _order_key(score: torch.Tensor, doc: torch.Tensor) -> torch.Tensor:
    """int64 key whose ascending order is (score descending, doc
    ascending): the float's bits mapped to a signed integer of the same
    order, complemented, above the doc id."""
    bits = (score + 0.0).view(torch.int32)  # -0.0 -> +0.0
    asc = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    return ((~asc).to(torch.int64) << 32) | doc.to(torch.int64)


def _key_score(key: torch.Tensor) -> torch.Tensor:
    asc = ~((key >> 32).to(torch.int32))
    return (asc ^ ((asc >> 31) & 0x7FFFFFFF)).view(torch.float32)


def segment_topk_batch(
    e_doc: torch.Tensor,    # int32[E] entry pack: doc id
    e_tffid: torch.Tensor,  # int32[E] tf | fid << 24
    tomb: torch.Tensor,     # int32[>= doc_count] tombstone flag per doc
    starts: torch.Tensor,   # int32[B, T]
    lens: torch.Tensor,     # int32[B, T]
    weights: torch.Tensor,  # float32[B, T]
    c1: torch.Tensor,
    c2: torch.Tensor,
    gbits: torch.Tensor,    # int32[B, T] 1 << group (see mask_i32)
    must: torch.Tensor,     # int32[B]
    mustnot: torch.Tensor,
    should: torch.Tensor,
    *,
    t_pad: int,
    l_pad: int,
    k: int,
    need_bits: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Score B queries over one segment: ``(scores f32[B, kk], docs
    i32[B, kk])`` with ``kk = min(k, t_pad * l_pad)``, each row in score
    descending then doc ascending order, ``-inf`` and ``DOC_SENTINEL``
    past a row's last hit.  Every operand lies on one device; nothing
    here waits for it."""
    dev = e_doc.device
    lane = torch.arange(l_pad, device=dev, dtype=torch.int32)
    valid = lane < lens[:, :, None]
    idx = starts[:, :, None].to(torch.int64) + lane
    idx.clamp_(max=e_doc.shape[0] - 1)
    packed = e_tffid[idx]
    docs = torch.where(valid, e_doc[idx], _SENTINEL)
    del idx
    norms = decode_fid(
        torch.arange(256, device=dev, dtype=torch.int32)
    ).to(torch.float32)
    tf = (packed & 0xFFFFFF).to(torch.float32)
    norm = norms[(packed >> 24) & 0xFF]
    del packed
    denom = tf + (c1[:, :, None] + c2[:, :, None] * norm)
    del norm
    con = torch.where(valid, weights[:, :, None] * (tf / denom), 0.0)
    del tf, denom
    bits = torch.where(valid, gbits[:, :, None], 0) if need_bits else None
    del valid

    if t_pad == 1:
        doc_s, con_s = docs[:, 0], con[:, 0]
        bit_s = bits[:, 0] if need_bits else None
    elif need_bits:
        doc_s, con_s, bit_s = merge_sorted_rows(docs, con, bits)
    else:
        doc_s, con_s = merge_sorted_rows(docs, con)
        bit_s = None
    del docs, con, bits

    # a run's sum, first clause to last: the entry w places back joins
    # before the nearer ones, and the entry itself last (0 + x is exact)
    total = torch.zeros_like(con_s)
    bits_total = bit_s.clone() if need_bits else None
    for w in range(t_pad - 1, 0, -1):
        same = doc_s[:, w:] == doc_s[:, :-w]
        total[:, w:] += torch.where(same, con_s[:, :-w], 0.0)
        if need_bits:
            bits_total[:, w:] |= torch.where(same, bit_s[:, :-w], 0)
    total += con_s

    ok = doc_s != _SENTINEL
    ok[:, :-1] &= doc_s[:, 1:] != doc_s[:, :-1]  # run ends
    if need_bits:
        m, mn, sh = must[:, None], mustnot[:, None], should[:, None]
        ok &= (bits_total & m) == m
        ok &= (bits_total & mn) == 0
        ok &= ((bits_total & sh) != 0) | (sh == 0)
    ok &= tomb[doc_s.clamp(max=tomb.shape[0] - 1)] == 0

    key = torch.where(ok, _order_key(total, doc_s), _INT64_MAX)
    kk = min(k, t_pad * l_pad)
    top = torch.topk(key, kk, dim=1, largest=False, sorted=True).values
    hit = top != _INT64_MAX
    scores = torch.where(hit, _key_score(top), float(NEG_INF))
    out_docs = torch.where(hit, top.to(torch.int32), _SENTINEL)
    return scores, out_docs


class _Staged(NamedTuple):
    """One plan's staged operands."""

    index: int        # of the plan in its batch
    args: ClauseArgs
    must: int
    mustnot: int
    should: int
    need_bits: bool
    t: int            # clauses up to the last one with postings here
    l: int            # longest posting


def _stage_batch(segment: Segment, plans, stats, limit: int):
    """(results, items): ``results`` holds ``[]`` for plans that provably
    match nothing and None elsewhere; ``items`` the staged operands of
    the plans the engine takes."""
    results: List[Optional[list]] = [None] * len(plans)
    items: List[_Staged] = []
    if limit > buckets.K_BUCKETS[-1]:
        # beyond the extraction ladder: declining beats truncating the
        # result set and presenting it as exact
        return results, items
    for i, plan in enumerate(plans):
        if plan.host_only:
            continue
        # no has_nonpositive_weight gate: the engine matches by group
        # bits, not by ``scores > 0``
        n_clauses = sum(len(g.clauses) for g in plan.groups)
        t_pad = buckets.t_bucket(max(n_clauses, 1))
        if t_pad > MERGE_MAX_T:
            continue
        args, must, mustnot, should, need_bits = stage_clauses(
            segment, plan, stats, t_pad
        )
        if args is None:
            constrained = any(g.occur is not Occur.SHOULD for g in plan.groups)
            if constrained and len(plan.groups) > 32:
                continue
            results[i] = []  # no clause has postings: provably empty
            continue
        with_postings = np.nonzero(args.lens)[0]
        if len(with_postings) == 0:
            results[i] = []  # the terms live in other segments only
            continue
        max_len = int(args.lens.max())
        if max_len > buckets.L_BUCKETS[-1]:
            continue
        items.append(_Staged(i, args, must, mustnot, should, need_bits,
                             int(with_postings[-1]) + 1, max_len))
    return results, items


def _chunks(items):
    """Split staged items into dispatches.  Rows are padded to their
    chunk's widest clause list and longest posting, so items go in order
    of their own lanes and a chunk closes when its padded lanes pass
    ``MAX_BATCH_LANES``, or pass both ``PAD_FACTOR`` times its rows' own
    lanes and ``PAD_FREE_LANES``."""
    order = sorted(items, key=lambda it: (-it.t * it.l, it.index))
    chunk: List[_Staged] = []
    t_max = l_max = own = 0
    for it in order:
        t, l = max(t_max, it.t), max(l_max, it.l)
        padded = (len(chunk) + 1) * t * l
        if chunk and (
            padded > MAX_BATCH_LANES
            or padded > max(PAD_FACTOR * (own + it.t * it.l), PAD_FREE_LANES)
        ):
            yield chunk, t_max, l_max
            chunk, own = [], 0
            t, l = it.t, it.l
        chunk.append(it)
        t_max, l_max, own = t, l, own + it.t * it.l
    if chunk:
        yield chunk, t_max, l_max


def _dispatch(pack, chunk, t_pad: int, l_pad: int, k: int):
    """One dispatch: stage the chunk's operands into one int32 array,
    upload it, score, and download ``(scores f32[B, kk], docs i32[B,
    kk])`` in one copy."""
    global launches
    dev = pack.e_doc.device
    n = len(chunk)
    ops = np.zeros((n, 6 * t_pad + 3), dtype=np.int32)
    fl = ops.view(np.float32)
    ops[:, 3 * t_pad:4 * t_pad] = np.float32(1.0).view(np.int32)  # c1 pad
    need_bits = False
    for j, it in enumerate(chunk):
        a, t = it.args, min(len(it.args.starts), t_pad)
        ops[j, 0:t] = a.starts[:t]
        ops[j, t_pad:t_pad + t] = a.lens[:t]
        fl[j, 2 * t_pad:2 * t_pad + t] = a.weights[:t]
        fl[j, 3 * t_pad:3 * t_pad + t] = a.c1[:t]
        fl[j, 4 * t_pad:4 * t_pad + t] = a.c2[:t]
        ops[j, 5 * t_pad:5 * t_pad + t] = a.gbits[:t].view(np.int32)
        ops[j, 6 * t_pad:] = (
            mask_i32(it.must), mask_i32(it.mustnot), mask_i32(it.should)
        )
        need_bits = need_bits or it.need_bits
    d = torch.from_numpy(ops).to(dev)
    f = d.view(torch.float32)

    def col(x, c):
        return x[:, c * t_pad:(c + 1) * t_pad]

    scores, docs = segment_topk_batch(
        pack.e_doc, pack.e_tffid, pack.tomb,
        col(d, 0), col(d, 1), col(f, 2), col(f, 3), col(f, 4), col(d, 5),
        d[:, 6 * t_pad], d[:, 6 * t_pad + 1], d[:, 6 * t_pad + 2],
        t_pad=t_pad, l_pad=l_pad, k=k, need_bits=need_bits,
    )
    with _launches_lock:
        launches += 1
    both = torch.stack([scores.view(torch.int32), docs]).cpu().numpy()
    return both[0].view(np.float32), both[1]


def device_candidates(
    segment: Segment,
    plans: Sequence[QueryPlan],
    stats,
    limit: int,
    device: torch.device,
) -> Tuple[list, Dict[int, Tuple[np.ndarray, np.ndarray]]]:
    """The engine before the host rescore: ``(results, candidates)``.
    ``results`` is :func:`device_search_batch`'s list with None where a
    plan has candidates or is declined; ``candidates`` maps a plan's
    index to its ``(scores f32[n], docs i32[n])`` as the device ranked
    them, ``n <= limit + RESCORE_SLACK``."""
    results, items = _stage_batch(segment, plans, stats, limit)
    cands: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
    if not items:
        return results, cands
    pack = segment.device_pack(device)
    k = limit + RESCORE_SLACK
    for chunk, t_pad, l_pad in _chunks(items):
        scores, docs = _dispatch(pack, chunk, t_pad, l_pad, k)
        # hits are a prefix of each row: -inf fills the tail
        n_hits = np.isfinite(scores).sum(axis=1)
        for j, it in enumerate(chunk):
            cands[it.index] = (scores[j, :n_hits[j]], docs[j, :n_hits[j]])
    return results, cands


def device_search_batch(
    segment: Segment,
    plans: Sequence[QueryPlan],
    stats,
    limit: int,
    device: torch.device,
) -> List[Optional[List[Tuple[float, int]]]]:
    """Run many queries over one segment with batched dispatches.

    Returns one entry per plan: [(score, local_doc)] (score desc, doc
    asc), [] when the plan provably matches nothing, or None when the
    plan must take another engine (match_all / phrases / more than 16
    clauses / more than 32 constrained groups / a limit above 4,096 / a
    posting beyond the largest window).
    """
    results, cands = device_candidates(segment, plans, stats, limit, device)
    for i, (scores, docs) in cands.items():
        hits = list(zip(scores.tolist(), docs.tolist()))
        # device floats -> oracle-exact host floats before the final
        # ranking (the device sums a doc's clauses in another order)
        results[i] = rescore_hits(segment, plans[i], stats, hits)[:limit]
    return results


def device_search_segment(
    segment: Segment,
    plan: QueryPlan,
    stats,
    limit: int,
    device: torch.device,
) -> Optional[List[Tuple[float, int]]]:
    """Single-query convenience wrapper over device_search_batch."""
    return device_search_batch(segment, [plan], stats, limit, device)[0]
