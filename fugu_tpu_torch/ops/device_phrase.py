"""Device-side phrase execution: adjacency scoring over positions on the card.

The counterpart of ``fugu_tpu/ops/device_phrase.py``, the reference's
opt-in phrase path: ``NamedIndex.search_topk_batch`` and
``fugu_tpu_torch.bench.device_run`` take it only when
``FUGU_DEVICE_PHRASE=1`` is set and the phrase stream declined the
batch, as the reference's do.  It needs neither the token stream nor the
host matcher's pruning: each field's position arrays go to the index's
device once (cached on the segment and reserved in ``ops/residency``
under kind ``"positions"``), and the common phrase shapes run as torch
ops on that device.  The reference runs one XLA program per query; here
the staged plans of one shape (field, term count, window pad) run
together, a row each:

1. **Doc intersection**: the rarest term's posting window is the
   candidate axis j; every other term resolves membership with one
   ``searchsorted`` over its own window.  A window is read by an index
   clamped to the pack, masked past the term's df.
2. **Position expansion**: the candidates' position runs expand by the
   monotone-gather idiom (int32 cumsum + ``searchsorted(right=True)``).
3. **Anchor intersection** (slop 0): position p of term i anchors the
   phrase at p - i; anchors are the int32 keys ``j * 2^15 + (p - i +
   4)``, ascending, intersected progressively with ``searchsorted``.
   Padding lanes carry INT_MAX.
4. **Scoring**: phrase tf per candidate by ``scatter_add_`` of the
   surviving anchors (whole numbers below 2^24, exact in any order);
   score = w_p * tf / (tf + cache[fid]); dead docs masked.  The top k is
   ``topk`` over one int64 key a lane, (score descending, candidate
   index ascending), so ties resolve to the lowest candidate index =
   the lowest doc, as ``lax.top_k`` resolves them.

Every gather index is kept in range with the reference's own guards:
torch raises (on the card, asserts) where JAX clamps.
:func:`device_phrase_begin` stages and launches without waiting for the
device; :func:`device_phrase_collect` makes the one transfer of every
staged output, routes overflowed plans to the host matcher, and
rescores the candidates on the host with the matcher's exact float
sequence, so results are bit-identical to ``ops/phrase.py``.  Errors
propagate: there is no fallback to the host for a failed launch.

On an NVIDIA H100 80GB HBM3 (700 W), on bench's 1M-doc corpus, it
stages 97 of ``chip_smoke.py``'s 256-phrase batch (127 are declined by
the pad ladder, 32 are sloppy) and answers them in 47-55 ms warm, where
the host matcher takes 614-1,060 ms and the phrase stream 83-141 ms for
the whole batch; one begin keeps the card busy 37 ms, its ops running
over padded lanes.  At 16M docs it stages 24 of the batch (200 declined
by the pad ladder) in 15-19 ms against the host matcher's 22-27 s for
the whole batch (``tools/device_phrase_ab.py``; PERF.md).

Eligibility gates (the host matcher otherwise): single-phrase plans
(every group one SHOULD/MUST phrase over one field, the shape quoted
queries parse to), slop == 0 or single-term, <= 4 terms, <= 2^16
COMMON docs (the anchor-key budget; checked on the device with an
overflow flag), max position < 2^15-8 (guaranteed by the 10k-char text
cap; checked per segment anyway), default bm25 constants, the largest
df within ``_PAD_LADDER``, and a limit below the k-extraction ladder's
top.
"""

from __future__ import annotations

import functools
import os
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from fugu_tpu_torch.device import resolve
from fugu_tpu_torch.index.segment import Segment, _pow2_bucket, pack_entry_size
from fugu_tpu_torch.ops import buckets
from fugu_tpu_torch.ops.oracle import IndexStats
from fugu_tpu_torch.ops.scoring import _key_score, _order_key
from fugu_tpu_torch.query import (
    Occur,
    QueryPlan,
    bm25_weight,
    fieldnorm_cache,
)

_SHIFT = 15              # anchors: rank * 2^15 + (pos - i + 4)
_POS_CAP = (1 << _SHIFT) - 8
#: max COMMON docs per phrase (rank * 2^15 stays in int32); the doc
#: intersection itself is unbounded — candidates compact to ranks on
#: device, and an overflow flag routes wider matches to the host matcher
_COMMON_CAP = 1 << 16
#: flat position budget across the compacted candidates (per term);
#: exceeding it also raises the overflow flag
_PPOS_PAD = 1 << 19
#: posting-window ladder: ONE pad per query (its largest constituent
#: df).  A plan whose largest df passes the top rung stays on the host
#: matcher.  The rungs are the reference's, chosen on its TPU; on the
#: card they are starting values
_PAD_LADDER = (1 << 13, 1 << 17)
_INT_MAX = np.int32(2**31 - 1)

_IMAX = int(_INT_MAX)
#: the reference's opt-in switch: "1" sends the phrases the stream
#: declines here (read on every search, as the reference reads it)
SWITCH = "FUGU_DEVICE_PHRASE"
#: cap on rows x lanes of one dispatch: at _PPOS_PAD lanes a row keeps
#: about 40 B a lane alive per term (int64 run indices and gather
#: indices, int32 positions and keys), so 2^24 lanes (32 rows) stay
#: under 1 GiB of intermediates
MAX_DISPATCH_LANES = 1 << 24


def enabled() -> bool:
    """True when the environment opts in (``FUGU_DEVICE_PHRASE=1``)."""
    return os.environ.get(SWITCH) == "1"


def _phrase_clause(plan: QueryPlan):
    """The single PhraseClause of an eligible plan, or None."""
    if plan.match_all or plan.has_range or plan.has_subplan:
        return None
    from fugu_tpu_torch.query import K1, B as B_CONST

    if plan.k1 != float(K1) or plan.b != float(B_CONST):
        return None
    pcs = []
    for g in plan.groups:
        if g.occur is Occur.MUST_NOT or g.clauses or g.ranges:
            return None
        if g.subplan is not None or len(g.phrases) != 1:
            return None
        pcs.append(g.phrases[0])
    if len(pcs) != 1:
        return None
    pc = pcs[0]
    slop = max(int(getattr(pc, "slop", 0) or 0), 0)
    if slop != 0 and len(pc.terms) > 1:
        return None
    if not (1 <= len(pc.terms) <= 4):
        return None
    return pc


class Positions(NamedTuple):
    """One field's positions on a device, padded as the reference pads
    them: ``pos_off`` / ``pos_dat`` (int32, to a power of two; the
    offsets' tail repeats the last offset), the per-doc fieldnorm id and
    tombstone flag (int32, to a power of two of at least 32 docs)."""

    pos_off: torch.Tensor
    pos_dat: torch.Tensor
    fid: torch.Tensor
    tomb: torch.Tensor


def _evict_positions(segment: Segment, field: str) -> None:
    cache = getattr(segment, "_device_pos", None)
    if cache:
        cache.pop(field, None)


def _device_positions(segment: Segment, field: str, device):
    """:class:`Positions` of one field on ``device``, cached on the
    segment under ``_device_pos`` and reserved in the residency budget
    as ``("pos", id(segment), field)`` (an eviction drops the cache
    entry; ``Segment.delete_by_term`` drops both); None when the field
    has no positions or positions exceed the anchor budget."""
    from fugu_tpu_torch.ops import residency

    cache = getattr(segment, "_device_pos", None)
    if cache is None:
        cache = {}
        object.__setattr__(segment, "_device_pos", cache)
    key = ("pos", id(segment), field)
    if field in cache:
        hit = cache[field]
        if hit is None:
            return None
        if hit.pos_off.device == device:
            residency.touch(key)
            return hit
    if field not in segment.pos_offsets:
        cache[field] = None
        return None
    dat = segment.pos_data[field]
    if len(dat) and int(dat.max()) >= _POS_CAP:
        cache[field] = None  # pathological positions: host matcher only
        return None
    if len(dat) >= 2**31:
        # int64 offsets would wrap in the int32 cast below and gather
        # garbage positions with no error — host matcher only
        cache[field] = None
        return None
    off = segment.pos_offsets[field]
    off_pad = np.zeros(_pow2_bucket(len(off)), dtype=np.int32)
    off_pad[: len(off)] = off.astype(np.int32)
    off_pad[len(off) :] = off[-1]
    dat_pad = np.zeros(_pow2_bucket(max(len(dat), 32)), dtype=np.int32)
    dat_pad[: len(dat)] = dat
    fid = np.zeros(_pow2_bucket(max(segment.doc_count, 32)), dtype=np.int32)
    fid[: segment.doc_count] = segment.fieldnorm_ids.get(
        field, np.zeros(segment.doc_count, dtype=np.uint8)
    )
    tomb = np.zeros(len(fid), dtype=np.int32)
    tomb[: segment.doc_count] = segment.tombstones.astype(np.int32)
    arrays = (off_pad, dat_pad, fid, tomb)
    residency.reserve(
        key,
        sum(a.nbytes for a in arrays),
        segment,
        functools.partial(_evict_positions, field=field),
        kind="positions",
    )
    out = Positions(*(torch.from_numpy(a).to(device) for a in arrays))
    cache[field] = out
    # the reserve()->cache window of Segment.device_pack: a concurrent
    # reserve may have evicted this key in between — don't keep an
    # unaccounted entry (the local reference stays valid for this call)
    if not residency.contains(key):
        cache.pop(field, None)
    return out


def _window(e_doc, starts, dfs, pad):
    """Masked posting windows [B, pad]: the docs of one term a row,
    INT_MAX from lane df on.  The index is clamped to the pack (the
    port's pack is unpadded; lanes past df are masked either way)."""
    lane = torch.arange(pad, device=e_doc.device)
    idx = torch.clamp(starts[:, None].long() + lane, max=e_doc.shape[0] - 1)
    return torch.where(lane < dfs[:, None], e_doc[idx], _IMAX)


def _expand_positions(pos_off, pos_dat, entry_idx, valid, ppad, base):
    """Flat positions [B, ppad] of each row's selected entries, with
    their candidate index.

    entry_idx[b, j] (a pack index) owns run pos_off[e-base : e-base+1);
    invalid j contribute empty runs.  Returns (cand_j, pos, ok, total)
    by the monotone-gather idiom."""
    rel = torch.where(valid, entry_idx - base, 0)
    starts = pos_off[rel]
    lens = torch.where(valid, pos_off[rel + 1] - starts, 0)
    cum = torch.cumsum(lens, dim=1, dtype=torch.int32)
    total = cum[:, -1]
    p = torch.arange(ppad, dtype=torch.int32, device=lens.device)
    p = p.expand(lens.shape[0], ppad).contiguous()
    j = torch.searchsorted(cum, p, right=True)
    j = torch.clamp(j, max=lens.shape[1] - 1)
    within = p - (cum.gather(1, j) - lens.gather(1, j))
    ok = p < total[:, None]
    pos = pos_dat[torch.where(ok, starts.gather(1, j) + within, 0).long()]
    return j, pos, ok, total


def _top(score, cand, k):
    """(top_s, top_d) [B, k]: the k best lanes by (score descending,
    lane ascending), the doc of each from ``cand``; INT_MAX for -inf."""
    lane = torch.arange(score.shape[1], device=score.device)
    key = _order_key(score, lane.expand_as(score))
    top = torch.topk(key, k, dim=1, largest=False, sorted=True).values
    top_s = _key_score(top)
    idx = top & 0xFFFFFFFF
    top_d = torch.where(top_s > -torch.inf, cand.gather(1, idx), _IMAX)
    return top_s, top_d


def phrase_topk(e_doc, pos_off, pos_dat, fid_doc, tomb_doc, starts, dfs,
                aoff, w_p, cache, field_base: int, *, k_terms: int,
                pad: int, ppad: int, k_out: int):
    """The reference's per-query phrase program for B queries of one
    shape at once, as torch ops on the operands' device.

    ``starts``, ``dfs``, ``aoff`` int32[B, k_terms] (term slots rarest
    first; ``aoff`` the slot's index in the quoted phrase), ``w_p``
    float32[B], ``cache`` float32[256] (the field's fieldnorm cache).
    Returns (top_s f32[B, kk], top_d int32[B, kk], overflow int32[B]):
    the candidates by device score, INT_MAX for empty slots, and a flag
    where the anchor budget was exceeded (the host matcher takes those).
    """
    b = starts.shape[0]
    # candidate axis: rarest term's window (term order pre-sorted by
    # df on the host; term index 0 here = rarest constituent)
    w0 = _window(e_doc, starts[:, 0], dfs[:, 0], pad)
    valid = w0 != _IMAX
    entries = [starts[:, :1].long() + torch.arange(pad, device=w0.device)]
    # doc intersection + per-term entry resolution
    for i in range(1, k_terms):
        wi = _window(e_doc, starts[:, i], dfs[:, i], pad)
        loc = torch.clamp(torch.searchsorted(wi, w0), max=pad - 1)
        valid = valid & (wi.gather(1, loc) == w0)
        entries.append(starts[:, i : i + 1].long() + loc)
    # dead docs can never be hits
    doc_safe = torch.where(valid, w0, 0).long()
    valid = valid & (tomb_doc[doc_safe] == 0)
    w_p = w_p[:, None]

    if k_terms == 1:
        # single-term "phrase": tf is the entry's position count; no
        # anchors, so no candidate cap applies
        rel = torch.where(valid, entries[0] - field_base, 0)
        tf = torch.where(valid, (pos_off[rel + 1] - pos_off[rel]).float(), 0.0)
        norm = cache[fid_doc[doc_safe].long()]
        score = torch.where((tf > 0.0) & valid, w_p * (tf / (tf + norm)),
                            -torch.inf)
        top_s, top_d = _top(score, w0, min(k_out, pad))
        return top_s, top_d, torch.zeros(b, dtype=torch.int32,
                                         device=w0.device)

    # compact the common docs to dense ranks (monotone gather) so the
    # anchor keys fit int32 regardless of the terms' doc freqs;
    # overflow (> _COMMON_CAP common docs, or more candidate positions
    # than the flat budget) goes to the host matcher
    c_pad = min(_COMMON_CAP, pad)
    cum = torch.cumsum(valid, dim=1, dtype=torch.int32)
    n_common = cum[:, -1:]
    overflow = n_common[:, 0] > c_pad
    q = torch.arange(c_pad, dtype=torch.int32, device=w0.device)
    src = torch.searchsorted(cum, (q + 1).expand(b, c_pad).contiguous())
    src = torch.clamp(src, max=pad - 1)
    cvalid = q < n_common
    cdoc = torch.where(cvalid, w0.gather(1, src), 0)
    centries = [torch.where(cvalid, e.gather(1, src), 0) for e in entries]

    inter = alive = None
    for i in range(k_terms):
        cj, pos, ok, p_total = _expand_positions(
            pos_off, pos_dat, centries[i], cvalid, ppad, field_base
        )
        overflow = overflow | (p_total > ppad)
        # anchor = original-phrase-index-adjusted position: the slot
        # order is rarest-first, aoff restores the term's index within
        # the quoted phrase; below 2^31 for every rank < 2^16
        keys = (cj.to(torch.int32) << _SHIFT) + (pos - aoff[:, i : i + 1] + 4)
        # pads: INT_MAX keeps the row non-decreasing for searchsorted
        # and never equals a valid key
        keys = torch.where(ok, keys, _IMAX)
        if inter is None:
            inter, alive = keys, ok
        else:
            m = torch.clamp(torch.searchsorted(keys, inter), max=ppad - 1)
            alive = alive & (keys.gather(1, m) == inter)
    # phrase_tf per candidate rank: count surviving anchors
    jj = torch.where(alive, inter >> _SHIFT, 0).long()
    tf = torch.zeros(b, c_pad, dtype=torch.float32, device=w0.device)
    tf.scatter_add_(1, jj, alive.float())
    norm = cache[fid_doc[cdoc.long()].long()]
    score = torch.where((tf > 0.0) & cvalid, w_p * (tf / (tf + norm)),
                        -torch.inf)
    top_s, top_d = _top(score, cdoc, min(k_out, c_pad))
    return top_s, top_d, overflow.to(torch.int32)


class PhraseHandle(NamedTuple):
    """What :func:`device_phrase_begin` staged; its first six fields
    are the reference's handle.  ``staged`` holds (plan index, (output
    index, row)); ``outcome`` says per plan where begin sent it
    ("staged", "answered" for a plan that provably matches nothing,
    "ineligible", "limit", "positions", "pad_ladder", "tail")."""

    results: list
    staged: list
    segment: Segment
    plans: Sequence[QueryPlan]
    stats: IndexStats
    limit: int
    outcome: List[str]
    outs: list


def device_phrase_begin(
    segment: Segment,
    plans: Sequence[QueryPlan],
    stats: IndexStats,
    limit: int,
    device,
) -> PhraseHandle:
    """Stage and launch the eligible phrase plans on ``device`` without
    waiting for it; returns a handle for :func:`device_phrase_collect`.
    Ineligible plans stay None (callers keep the host matcher)."""
    device = resolve(device)
    results: List[Optional[List[Tuple[float, int]]]] = [None] * len(plans)
    staged: list = []
    outs: list = []
    # strict-< ladder so rescoring always sees slack candidates at a
    # bucket boundary; limits past the last bucket would truncate the
    # device top-k — decline them all to the exact host matcher instead
    k_out = buckets.k_extract(limit)
    if k_out is None:
        return PhraseHandle(results, staged, segment, plans, stats, limit,
                            ["limit"] * len(plans), outs)
    outcome = ["ineligible"] * len(plans)
    # (field, k_terms, pad) -> rows of (plan index, starts, dfs, aoff, w_p)
    groups: Dict[tuple, list] = {}
    positions: Dict[str, Positions] = {}
    caches: Dict[str, np.ndarray] = {}
    tail = pack_entry_size(len(segment.e_doc))  # the reference's pack
    for qi, plan in enumerate(plans):
        pc = _phrase_clause(plan)
        if pc is None:
            continue
        field = pc.field
        infos = [segment.term_info(field, t) for t in pc.terms]
        if any(i is None for i in infos):
            results[qi] = []  # absent term: matches nothing (Tantivy)
            outcome[qi] = "answered"
            continue
        dev_pos = _device_positions(segment, field, device)
        if dev_pos is None:
            outcome[qi] = "positions"
            continue
        positions[field] = dev_pos
        dfs_idx = [stats.doc_freq(field, t) for t in pc.terms]
        if max(dfs_idx) == 0:
            results[qi] = []
            outcome[qi] = "answered"
            continue
        w_p = bm25_weight(max(dfs_idx), stats.doc_count, pc.boost, plan.k1)
        caches[field] = fieldnorm_cache(
            stats.avg_fieldnorm(field), plan.k1, plan.b
        ).astype(np.float32)
        # term order: rarest first (the candidate axis), anchors offset
        # by the ORIGINAL term index i (pos - i)
        order = sorted(range(len(infos)), key=lambda k: infos[k].doc_freq)
        starts = [infos[k].start for k in order]
        dfs = [infos[k].doc_freq for k in order]
        pad = next((v for v in _PAD_LADDER if max(dfs) <= v), None)
        if pad is None:
            outcome[qi] = "pad_ladder"
            continue  # dense terms: the pruned host matcher takes them
        if any(st + pad > tail for st in starts):
            outcome[qi] = "tail"
            continue  # the reference's window would clamp: host path
        outcome[qi] = "staged"
        groups.setdefault((field, len(order), pad), []).append(
            (qi, starts, dfs, order, np.float32(w_p)))

    if not groups:
        return PhraseHandle(results, staged, segment, plans, stats, limit,
                            outcome, outs)
    # every operand in one int32 and one float32 upload, before the
    # first launch: a copy from pageable memory waits for the stream
    chunks = []
    for (field, k_terms, pad), rows in groups.items():
        per = max(1, MAX_DISPATCH_LANES // max(pad, _PPOS_PAD))
        chunks += [(field, k_terms, pad, rows[lo : lo + per])
                   for lo in range(0, len(rows), per)]
    fields = sorted(caches)
    ints = torch.from_numpy(np.array(
        [v for *_, rows in chunks for r in rows for v in r[1] + r[2] + r[3]],
        dtype=np.int32)).to(device)
    floats = torch.from_numpy(np.concatenate(
        [caches[f] for f in fields]
        + [np.array([r[4] for *_, rows in chunks for r in rows],
                    dtype=np.float32)])).to(device)
    e_doc = segment.device_pack(device).e_doc
    at_i, at_f = 0, 256 * len(fields)
    for field, k_terms, pad, rows in chunks:
        dev_pos = positions[field]
        n = len(rows)
        op = ints[at_i : at_i + n * 3 * k_terms].view(n, 3 * k_terms)
        c = fields.index(field) * 256
        out = phrase_topk(
            e_doc, dev_pos.pos_off, dev_pos.pos_dat, dev_pos.fid,
            dev_pos.tomb, op[:, :k_terms], op[:, k_terms : 2 * k_terms],
            op[:, 2 * k_terms :], floats[at_f : at_f + n],
            floats[c : c + 256], segment.field_entry_base[field],
            k_terms=k_terms, pad=pad, ppad=_PPOS_PAD, k_out=k_out,
        )
        at_i += n * 3 * k_terms
        at_f += n
        staged.extend((r[0], (len(outs), row)) for row, r in enumerate(rows))
        outs.append(out)
    return PhraseHandle(results, staged, segment, plans, stats, limit,
                        outcome, outs)


def _exact_phrase_rescore(segment, plan, stats, docs, limit):
    """Exact host re-scoring of the device-selected candidate docs —
    the same float sequence as ops/phrase.py's matcher (w_p f32, tf/(tf
    + cache[fid]) in f32), so final orderings are bit-identical."""
    pc = _phrase_clause(plan)
    field = pc.field
    docs = np.asarray(sorted(set(int(d) for d in docs)), dtype=np.int64)
    if len(docs) == 0:
        return []
    dfs = [stats.doc_freq(field, t) for t in pc.terms]
    w_p = np.float32(
        bm25_weight(max(dfs), stats.doc_count, pc.boost, plan.k1)
    )
    cache = fieldnorm_cache(stats.avg_fieldnorm(field), plan.k1, plan.b)
    fids = segment.fieldnorm_ids[field][docs].astype(np.int64)

    if len(pc.terms) == 1:
        info = segment.term_info(field, pc.terms[0])
        tdocs = segment.e_doc[info.start : info.start + info.doc_freq]
        loc = np.searchsorted(tdocs, docs.astype(tdocs.dtype))
        tf = segment.e_tf[info.start + loc].astype(np.float32)
    else:
        base = segment.field_entry_base[field]
        offs = segment.pos_offsets[field]
        dat = segment.pos_data[field]
        # per-term lookups hoisted out of the candidate loop (they were
        # rebuilt k_out*k_terms times)
        term_windows = []
        for t in pc.terms:
            info = segment.term_info(field, t)
            term_windows.append(
                (info, segment.e_doc[info.start : info.start + info.doc_freq])
            )
        tf = np.zeros(len(docs), dtype=np.float32)
        for di, d in enumerate(docs):
            inter = None
            for k, (info, tdocs) in enumerate(term_windows):
                loc = int(np.searchsorted(tdocs, np.int32(d)))
                e = info.start + loc - base
                poss = dat[offs[e] : offs[e + 1]].astype(np.int64) - k
                if k:
                    poss = poss[poss >= 0]
                inter = poss if inter is None else np.intersect1d(
                    inter, poss, assume_unique=True
                )
                if inter.size == 0:
                    break
            tf[di] = float(len(inter)) if inter is not None else 0.0
    scores = w_p * (tf / (tf + cache[fids]))
    keep = tf > 0
    order = np.lexsort((docs[keep], -scores[keep]))
    return [
        (float(scores[keep][i]), int(docs[keep][i])) for i in order
    ][:limit]


def device_phrase_fetch(handle: PhraseHandle):
    """[(plan index, top_s, top_d, overflow)] of every staged plan on the
    host: the device's candidates before the rescore, brought over in
    one transfer of every output."""
    if not handle.staged:
        return []
    parts = [t.reshape(-1) for s, d, o in handle.outs
             for t in (s.view(torch.int32), d, o)]
    flat = torch.cat(parts).cpu().numpy()
    host, at = [], 0
    for s, _d, _o in handle.outs:
        b, kk = s.shape
        top_s = flat[at : at + b * kk].view(np.float32).reshape(b, kk)
        top_d = flat[at + b * kk : at + 2 * b * kk].reshape(b, kk)
        host.append((top_s, top_d, flat[at + 2 * b * kk : at + 2 * b * kk + b]))
        at += 2 * b * kk + b
    return [(qi, host[o][0][row], host[o][1][row], int(host[o][2][row]))
            for qi, (o, row) in handle.staged]


def device_phrase_collect(handle: PhraseHandle):
    """Fetch all staged outputs (one transfer) and host-rescore to the
    exact float sequence; a plan whose overflow flag is set comes back
    None, for the caller's host matcher."""
    results = handle.results
    for qi, top_s, top_d, overflow in device_phrase_fetch(handle):
        if overflow:
            # more common docs than the anchor-key budget: the pruned
            # host matcher takes this one (None -> caller fallback)
            results[qi] = None
            continue
        keep = np.isfinite(top_s) & (top_d != _INT_MAX)
        results[qi] = _exact_phrase_rescore(
            handle.segment, handle.plans[qi], handle.stats, top_d[keep],
            handle.limit,
        )
    return results


def device_phrase_batch(segment, plans, stats, limit, device):
    return device_phrase_collect(
        device_phrase_begin(segment, plans, stats, limit, device)
    )
