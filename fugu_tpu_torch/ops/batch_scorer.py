"""Two-phase batched query engine: corpus-stream phase A + pruned phase B.

The counterpart of ``fugu_tpu/ops/batch_scorer.py``.  The single-query
block scorer visits every nonempty block per query (~490 at 1M docs),
but the TRUE top-k docs of a query live in ~k blocks.  Sum-of-max WAND
bounds cannot find them on the bench corpus (148/245 blocks pass at 1M
docs, per the reference's notes); exact per-block maxima can (10.6/489).
So:

**Phase A** (``csrc/phasea.cu``): ONE streaming pass over the segment's
block-major pack (index/segment.py BlockMajorPack) computes, for the
whole query batch at once, the max score per (512-doc block slice,
query).  Each entry whose term is in the batch's union adds

    S[doc, q] += W[slot(term), q] * contrib[e]

for every query q, where W is the per-(union term, query) BM25 weight
matrix and contrib is the precomputed weight-free tf/(tf + norm)
component.  The scatter/BM25 work is shared by all B queries — the
batch visits each posting once instead of once per query that contains
its term.

**Phase B**: per query, only blocks whose phase-A max can still reach
the kth score (with a bf16-error margin) are re-scored exactly by the
block scorer (ops/block_scorer with per-query block lists).

- **Pure-SHOULD plans** (one phase-B wave): the kth-of-maxima is a valid
  lower bound because block maxima are real doc scores (blocks partition
  docs; dead docs are zeroed out of the pack).
- **Boolean plans** (MUST / MUST_NOT / facet filters): phase A carries
  a second half of count lanes that counts, per doc, the
  distinct single-clause MUST terms present (MUST_NOT terms count -64),
  and the maxima are masked to docs passing ``count == n_must`` — the
  unconstrained sum bound is uselessly loose for selective intersections
  (the reference's notes: the wave-2 sweep visited 444/489 blocks
  without the mask, ~15 with it).  When the mask reproduces the match set exactly
  ("exact"/"shift" kinds — every MUST single-clause; require-should
  either implied by ``scores > 0`` or restored by excluding the
  constant facet score from W and adding it back on the host), the
  masked maxima are achievable scores and one wave suffices.  Otherwise
  ("upper" kind) wave 1 scores the best-bounded blocks to establish the
  kth score and wave 2 sweeps the remaining candidates.  Under-filled
  wave-1 results degrade to a full candidate sweep (thresh = -inf),
  never to a wrong answer.

Eligibility: term/facet plans at default k1/b with no phrases, ranges,
or nested subplans.  Parity: phase B is the oracle-checked block scorer
and waves partition doc space, so merged results are identical to the
single-phase engine.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from fugu_tpu_torch import cuda_build
from fugu_tpu_torch.index.segment import (
    BM_BLOCK_DOCS,
    BM_CHUNK,
    FACET_FIELD_KEY,
    Segment,
)
from fugu_tpu_torch.ops.staging import NEG_INF, has_nonpositive_weight
from fugu_tpu_torch.query import Occur, QueryPlan, bm25_weight, idf

# The ladders, MIN_BATCH, the stream penalty and the fine default below
# were tuned for the TPU reference (fugu_tpu/ops/batch_scorer.py) and
# are kept as they are for parity.  On the H100 they are starting
# values, to be measured again; no timing from the TPU carries over.

B_PAD = 256          # max queries per phase-A stream
#: query-lane ladder; every rung is a multiple of the kernel's 64-lane
#: (narrow) and 32-query (wide) tiles
B_BUCKETS = (64, 128, 256)
#: union-term ladder (rows of W); beyond the last -> greedy split
U_BUCKETS = (256, 384, 512, 768, 1024)
#: relative + absolute margin absorbing bf16 error in the maxima vs the
#: exact f32 score: W and the pack's contributions are stored bf16 (the
#: TPU kernel also rounds each product to bf16; the CUDA kernel sums in
#: f32), so the bound needs m >= 3*eps_bf16 ~= 0.0118 at worst.  Looser
#: margins balloon phase-B candidate lists.
MARGIN_REL = 0.015
MARGIN_ABS = 3e-3
#: phase A pays one full corpus stream per launch; below this many
#: eligible queries the single-phase block scorer is used
MIN_BATCH = 24

#: score-lane gating constants ("neg"/"gate" kinds — boolean constraints
#: WITHOUT the lane-doubling count lanes):
#: - a MUST facet clause contributes its weight EXACTLY (facet entries
#:   carry contribution 1.0), so weighting it GATE_BIG makes "all n
#:   facet MUSTs present" detectable as scores > (n-0.5)*GATE_BIG; the
#:   real idf moves to the host-side shift.  2^14 keeps f32 accumulation
#:   granularity at <= 2^-7 for n <= 4 gates (GATE_MARGIN absorbs it)
#:   while any realistic BM25 score stays far below GATE_BIG/2.
#: - a MUST_NOT clause weighted W_MUSTNOT drives any matching doc's
#:   score hard negative (below every gate/zero threshold): the minimum
#:   entry contribution is tf/(tf+cache) >= ~2^-13 (tf=1, 5000-token
#:   field), so the penalty is >= 2^26 * 2^-13 = 2^13 = GATE_BIG/2,
#:   which clears the worst case (a doc missing half a gate step).
GATE_BIG = 2.0 ** 14
W_MUSTNOT = -(2.0 ** 26)
#: extra absolute margin for gate-kind thresholds: f32 rounding of
#: score + n*GATE_BIG quantizes the score part by up to ~2^-5
GATE_MARGIN = 0.0625

#: kinds served by the narrow (no count lanes) stream
NARROW_KINDS = ("pure", "neg", "gate")

#: count-lane bit-packing: two queries' counts share one f32 lane as
#: ``lo + hi * _PACK_FIELD``.  Counts are small exact integers (must +1,
#: MUST_NOT -64; |value| <= 1024 per field), so the packed sum stays
#: integer-exact in f32 (< 2^23) and the two fields separate by
#: round-divide.  Lanes drop from 2B to 1.5B; applied at b_pad = 256.
_PACK_FIELD = 4096.0
_PACK_MIN_B = 256

#: fixed cost of one extra corpus stream, in equivalent query lanes: a
#: split must save more lanes than this to win
_STREAM_PENALTY_LANES = 96

#: phase-A maxima granularity: FINE_PER_BLOCK maxima per 512-doc block
#: (256-doc halves).  Finer maxima strictly tighten phase B (the kth
#: over a superset of finer values is >= the coarse kth) at the price of
#: more candidate-mask rows; a stream whose every live query extracts
#: deep (limit > DEEP_LIMIT) takes DEEP_FINE.
FINE_PER_BLOCK = 2
BM_FINE_DOCS = BM_BLOCK_DOCS // FINE_PER_BLOCK
DEEP_LIMIT = 32
DEEP_FINE = 4


def _nb_pad(nb: int) -> int:
    """The reference's padded block count of a stream (its jit shape
    ladder); the phrase stream keeps it so its outputs have the
    reference's shapes."""
    for v in (64, 256, 1024, 2048, 4096, 8192):
        if nb <= v:
            return v
    return ((nb + 1023) // 1024) * 1024


def _fine_for_stream(q_idx, limits) -> int:
    """Phase-A maxima granularity for one corpus stream."""
    live = [limits[i] for i in q_idx if i is not None]
    if live and all(lim > DEEP_LIMIT for lim in live):
        return DEEP_FINE
    return FINE_PER_BLOCK


@functools.lru_cache(maxsize=None)
def _lane_plan(n: int) -> Tuple[int, ...]:
    """Bucket capacities covering ``n`` queries minimizing padded lanes
    plus the fixed per-stream overhead (in equivalent lanes)."""
    if n <= 0:
        return ()
    best = None
    for b in B_BUCKETS:
        cand = (b,) if n <= b else (b,) + _lane_plan(n - b)
        key = (sum(cand) + _STREAM_PENALTY_LANES * (len(cand) - 1), len(cand))
        if best is None or key < best[0]:
            best = (key, cand)
    return best[1]


#: kernel launches (not plain-version calls) since process start
launches = 0

#: entries per step of the plain version (bounds its [n, lanes] temp)
_PLAIN_ENTRY_STEP = 1 << 20


def _lane_mode(lanes: int, b: int) -> int:
    """0 narrow (W has b lanes), 1 wide (2b: [weights | counts]),
    2 packed (1.5b: two queries' counts per lane as lo + 4096 * hi)."""
    if lanes == b:
        return 0
    if lanes == 2 * b:
        return 1
    if lanes == b + b // 2 and b % 2 == 0:
        return 2
    raise ValueError(f"W has {lanes} lanes for {b} queries")


def phasea_plain(offs, doc, tid, con, w, slot_of, nm, fine: int):
    """Plain PyTorch version of the phase-A kernel, same contract.

    ``offs`` i32[nb + 1] chunk offsets of the block-major pack (``doc``
    i32 global doc id, ``tid`` i32 global term id, ``con`` bf16
    weight-free contribution; pad entries carry tid -1); ``w`` bf16
    [U, lanes] weights per union slot; ``slot_of`` i32[n_terms] union
    slot of each term (-1 outside the union); ``nm`` f32[b] per-query
    score threshold (narrow) or required count (wide/packed).  Returns
    f32[nb, fine, b]: the max gated score per (block, 512/fine-doc
    slice, query), -inf where no doc passes.  Sums are f32."""
    dev = doc.device
    nb = offs.numel() - 1
    b = nm.numel()
    lanes = w.shape[1]
    mode = _lane_mode(lanes, b)
    n_terms = slot_of.numel()
    wf = w.to(torch.float32)
    scale = torch.ones(lanes, dtype=torch.bool, device=dev)
    scale[b:] = False  # count lanes take the raw weight
    S = torch.zeros(nb * BM_BLOCK_DOCS, lanes, dtype=torch.float32, device=dev)
    end = int(offs[-1]) * BM_CHUNK
    for e in range(0, end, _PLAIN_ENTRY_STEP):
        t = tid[e : min(e + _PLAIN_ENTRY_STEP, end)].to(torch.int64)
        ok = (t >= 0) & (t < n_terms)
        slot = torch.where(ok, slot_of[t.clamp(0, max(n_terms - 1, 0))], -1)
        sel = torch.nonzero(slot >= 0).squeeze(1)
        if sel.numel() == 0:
            continue
        v = wf[slot[sel].to(torch.int64)]
        c = con[e + sel].to(torch.float32)
        v = torch.where(scale[None, :], v * c[:, None], v)
        S.index_add_(0, doc[e + sel].to(torch.int64), v)
    scores = S[:, :b]
    if mode == 0:
        ok = scores > nm[None, :]
    else:
        cnt = S[:, b:]
        if mode == 2:
            hi = torch.round(cnt * (1.0 / _PACK_FIELD))
            lo = cnt - hi * _PACK_FIELD
            cnt = torch.cat([lo, hi], dim=1)
        ok = (scores > 0.0) & (cnt > nm[None, :] - 0.5)
    m = torch.where(ok, scores, float("-inf"))
    return m.reshape(nb, fine, BM_BLOCK_DOCS // fine, b).amax(dim=2)


def _ptr(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr())


def phasea(offs, doc, tid, con, w, slot_of, nm, fine: int):
    """The phase-A kernel (``csrc/phasea.cu``); contract as
    :func:`phasea_plain`, which runs instead for CPU tensors."""
    global launches
    if doc.device.type == "cpu":
        return phasea_plain(offs, doc, tid, con, w, slot_of, nm, fine)
    dev = doc.device
    b = nm.numel()
    lanes = w.shape[1] if w.dim() == 2 else -1
    mode = _lane_mode(lanes, b)
    qt = 64 if mode == 0 else 32
    if b % qt or fine not in (1, 2, 4, 8):
        raise ValueError(f"b={b} must be a multiple of {qt}; fine={fine}")
    for name, t, dtype in (
        ("offs", offs, torch.int32), ("doc", doc, torch.int32),
        ("tid", tid, torch.int32), ("con", con, torch.bfloat16),
        ("w", w, torch.bfloat16), ("slot_of", slot_of, torch.int32),
        ("nm", nm, torch.float32),
    ):
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(
                f"{name}: {t.dtype} on {t.device} (contiguous="
                f"{t.is_contiguous()}), want contiguous {dtype} on {dev}"
            )
    if tid.shape != doc.shape or con.shape != doc.shape:
        raise ValueError("doc, tid and con must have one length")
    nb = offs.numel() - 1
    if nb > 65535:  # the grid's y dimension: 33.5M docs
        raise ValueError(f"{nb} blocks exceed the phase-A grid")
    out = torch.empty((nb, fine, b), dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fugu_phasea(
            _ptr(offs), nb, _ptr(doc), _ptr(tid), _ptr(con), _ptr(w), lanes,
            _ptr(slot_of), slot_of.numel(), _ptr(nm), b, mode, qt, fine,
            _ptr(out), ctypes.c_void_p(stream),
        )
    cuda_build.check(err, "phase-A launch")
    launches += 1
    return out


def _lib():
    lib = cuda_build.load("phasea")
    fn = lib.fugu_phasea
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        v, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [v, i, v, v, v, v, i, v, i, v, i, i, i, i, v, v]
    return lib


def postproc(amax, shift, limidx, margin):
    """Phase-A candidate selection on the device.

    ``amax`` f32[nb, fine, b] maxima; per query, the kth of its maxima
    (``limidx`` = limit - 1, or -1 for no valid kth) less the margin is
    the threshold, and every fine slice whose maximum clears it is a
    candidate.  Returns (candidate mask bool[nb * fine, b], finite
    count i32[b]).  Under-filled queries get threshold -inf: an
    all-finite mask, the full candidate sweep that is never wrong."""
    nb2 = amax.shape[0] * amax.shape[1]
    k_top = min(128, nb2)
    col = amax.reshape(nb2, -1)
    finite = torch.isfinite(col)
    col = torch.where(finite, col + shift[None, :], float("-inf"))
    count = finite.sum(dim=0, dtype=torch.int32)
    top = torch.topk(col.T, k_top, dim=1).values
    li = limidx.clamp(min=0).to(torch.int64)
    kth = torch.gather(top, 1, li[:, None])[:, 0]
    have = (limidx >= 0) & (count > li)
    thresh = torch.where(
        have,
        kth - kth.abs() * MARGIN_REL - MARGIN_ABS - margin,
        float("-inf"),
    )
    return col >= thresh[None, :], count


#: wave-1 big-blocks scored per constrained query to establish the kth
#: lower bound (4 x 2048 docs is plenty for k <= 128 on non-degenerate
#: corpora; a degenerate wave 1 just means wave 2 sweeps more blocks)
ROUND1_BLOCKS = 4


def _classify(plan: QueryPlan) -> Optional[str]:
    """Phase-A pruning class for one plan.

    - "pure": all-SHOULD — block maxima are achievable doc scores, one
      phase-B wave, narrow kernel.
    - "neg": SHOULDs + MUST_NOTs only — narrow kernel; each MUST_NOT
      term carries W_MUSTNOT in the SCORE lane, so excluded docs go hard
      negative and ``scores > 0`` drops them (no count lanes).
    - "gate": every MUST group is a single FACET clause (+ optional
      SHOULDs/MUST_NOTs) — narrow kernel; each facet MUST contributes
      exactly GATE_BIG (facet contributions are 1.0), eligibility is the
      per-query threshold ``scores > (n-0.5)*GATE_BIG``, and the host
      shift (-n*GATE_BIG + sum(idf)) turns maxima back into real scores.
    - "exact": boolean plan whose count mask reproduces the match set
      exactly (every MUST group single-clause, and the require-should
      constraint either absent or implied by ``scores > 0``) — the masked
      maxima are achievable constrained scores, one wave (wide kernel).
    - "upper": boolean plan where the mask is only an upper bound
      (multi-clause MUST groups are uncountable; require_should with
      both MUST and SHOULD groups is not encoded) — two waves.
    - None: this path does not handle it (phrases/ranges/subplans,
      non-default constants, no positive clause, staging limits).
    """
    from fugu_tpu_torch.query import K1, B as B_CONST

    if plan.host_only or plan.is_empty:
        return None
    if plan.k1 != float(K1) or plan.b != float(B_CONST):
        return None  # contributions precomputed at default constants
    n_clauses = 0
    n_must = n_should = 0
    must_countable = True
    gate_ok = True  # every MUST a single facet clause
    has_scoring = False
    max_boost = 0.0
    for g in plan.groups:
        if g.phrases or g.ranges or g.subplan is not None:
            return None
        n_clauses += len(g.clauses)
        for c in g.clauses:
            max_boost = max(max_boost, abs(c.boost))
        if g.occur is Occur.MUST:
            n_must += 1
            if len(g.clauses) != 1:
                must_countable = False
                gate_ok = False
            elif not g.clauses[0].is_facet:
                gate_ok = False
            if g.clauses:
                has_scoring = True
        elif g.occur is Occur.MUST_NOT:
            pass  # any-clause penalty counts exactly even multi-clause
        elif g.clauses:
            n_should += 1
            has_scoring = True
    if not has_scoring:
        return None  # nothing produces a positive bound
    # every kind re-scores through the block kernel in phase B: respect
    # its staging limits (t_pad <= 16, <= 32 boolean groups) BEFORE
    # classifying, or an over-wide plan burns a phase-A corpus stream
    # (and inflates the batch's u_pad bucket) only to fall back anyway
    if n_clauses > 16 or len(plan.groups) > 32:
        return None
    has_not = any(g.occur is Occur.MUST_NOT for g in plan.groups)
    if n_must == 0 and not has_not:
        return "pure"
    if n_must == 0:
        # MUST_NOTs alone gate through the score lane — but only while
        # no SHOULD can out-score the W_MUSTNOT*con penalty of the
        # excluded term (worst case ~2^26 * 1e-3 ≈ 6.6e4 for a 10k-char
        # doc vs <= 16 clauses * boost * idf * (k1+1) ≈ 740 unboosted).
        # The same boost cap as "gate" keeps an order of magnitude of
        # headroom; larger boosts reroute to the count-lane "exact"
        # staging, whose -64 count penalty is boost-immune.
        return "neg" if max_boost <= 8.0 else "exact"
    if gate_ok and n_must <= 4 and max_boost <= 8.0:
        # gate-soundness bounds: n <= 4 keeps f32 granularity at
        # score+n*GATE_BIG under GATE_MARGIN; bounded boosts keep every
        # real score far below GATE_BIG/2 (an ineligible doc must not
        # out-score half a gate step).  require_should is safe at this
        # threshold: a should-less gated doc reports exactly n*GATE_BIG
        # (facet contributions are exact), which never exceeds any
        # eligible doc's value in any block, so the kth-of-maxima stays
        # a valid lower bound and phase B enforces the true
        # "at least one SHOULD" semantics.
        return "gate"
    if must_countable and not (
        plan.require_should and n_should > 0 and n_must > 0
    ):
        return "exact"
    # require_should + MUSTs: if every MUST is a single facet clause, its
    # score contribution is a per-query CONSTANT (idf; fieldnorm is
    # constant for facets).  Excluding those weights from W makes
    # ``scores > 0`` equivalent to "some SHOULD matched", the count mask
    # enforces facet presence, and the host adds the constant back to the
    # maxima — the bound becomes exact again ("shift" kind).
    if must_countable and all(
        g.clauses[0].is_facet
        for g in plan.groups
        if g.occur is Occur.MUST
    ):
        return "shift"
    return "upper"


def batch_search_should(
    segment: Segment,
    plans: Sequence[QueryPlan],
    stats,
    limit: int,
    device: torch.device,
) -> List[Optional[List[Tuple[float, int]]]]:
    """Single-limit wrapper around :func:`batch_search`."""
    return batch_search(segment, plans, stats, [limit] * len(plans), device)


def _plan_tids(plan: QueryPlan, tid_of: Dict[tuple, int]) -> set:
    tids = set()
    for g in plan.groups:
        # MUST_NOT terms never score but DO join the union: they
        # carry the -64 count penalty that masks excluded docs
        for c in g.clauses:
            field = FACET_FIELD_KEY if c.is_facet else c.field
            t = tid_of.get((field, c.term))
            if t is not None:
                tids.add(t)
    return tids


def plan_batches(plans, elig, kinds, tid_of):
    """Partition eligible plan indices into phase-A batches.

    Greedy fill splits when the term union exceeds the largest U bucket
    (each batch pays a full corpus stream); lane-fit then re-splits each
    batch over the B_BUCKETS ladder minimizing padded lanes + the
    per-stream penalty (phase-A flops scale with the lane count).
    Returns (batches, batch_terms) with per-batch term->slot maps."""
    batches: List[List[int]] = []
    cur: List[int] = []
    cur_terms: Dict[int, int] = {}
    for i in elig:
        tids = _plan_tids(plans[i], tid_of)
        new = [t for t in tids if t not in cur_terms]
        boundary = cur and (
            (kinds[cur[0]] in NARROW_KINDS) != (kinds[i] in NARROW_KINDS)
        )
        if len(cur) >= B_PAD or boundary or (
            cur and len(cur_terms) + len(new) > U_BUCKETS[-1]
        ):
            batches.append(cur)
            cur, cur_terms = [], {}
            new = list(tids)
        for t in new:
            cur_terms[t] = len(cur_terms)
        cur.append(i)
    if cur:
        batches.append(cur)

    split: List[List[int]] = []
    for q_idx in batches:
        for size in _lane_plan(len(q_idx)):
            split.append(q_idx[:size])
            q_idx = q_idx[size:]
            if not q_idx:
                break
    batch_terms = []
    for q_idx in split:
        terms: Dict[int, int] = {}
        for i in q_idx:
            for t in _plan_tids(plans[i], tid_of):
                if t not in terms:
                    terms[t] = len(terms)
        batch_terms.append(terms)
    return split, batch_terms


def stage_batch_weights(
    plans, kinds, q_idx, terms, stats, tid_of, b_pad, wide, k1, shifts,
    packed=False,
):
    """(w2, nmust, tid_arr) operand staging for one phase-A batch.

    Fills ``shifts`` for "shift"-kind plans (constant MUST-facet scores
    added back to the maxima after the stream) and for "gate"-kind plans
    (sum(idf) - n*GATE_BIG: the gates come OFF and the real facet scores
    go ON).  For narrow batches the nm row carries the per-query score
    threshold ((n-0.5)*GATE_BIG for gate plans, 0 otherwise); for wide
    batches it keeps the required MUST count.

    With ``packed`` the count lanes are bit-packed two queries per lane
    (query qi < b_pad//2 in the low field, qi >= b_pad//2 in the high
    field of lane b_pad + qi % (b_pad//2)); ``q_idx`` may then contain
    None entries (pad lanes keeping pair geometry)."""
    u_pad = next(u for u in U_BUCKETS if len(terms) <= u)
    if packed:
        w_lanes = b_pad + b_pad // 2
    else:
        w_lanes = 2 * b_pad if wide else b_pad
    w2 = np.zeros((u_pad, w_lanes), dtype=np.float32)
    nmust = np.zeros((8, b_pad), dtype=np.float32)
    tid_arr = np.full((8, u_pad), -2, dtype=np.int32)
    for t, slot in terms.items():
        tid_arr[0, slot] = t
    half = b_pad // 2

    def add_count(slot, qi, wt):
        if packed:
            mult = 1.0 if qi < half else _PACK_FIELD
            w2[slot, b_pad + qi % half] += wt * mult
        else:
            w2[slot, b_pad + qi] += wt

    for qi, i in enumerate(q_idx):
        if i is None:
            continue
        kind = kinds[i]
        narrow = kind in NARROW_KINDS
        n_gates = 0
        gate_idf = 0.0
        for g in plans[i].groups:
            # multi-clause MUST groups are uncountable (any-of match);
            # leaving them out of the count loosens but never breaks
            # the bound — such plans are classified "upper"
            count_group = g.occur is Occur.MUST and len(g.clauses) == 1
            if count_group and not narrow:
                nmust[0, qi] += 1.0
            for c in g.clauses:
                field = FACET_FIELD_KEY if c.is_facet else c.field
                t = tid_of.get((field, c.term))
                if g.occur is Occur.MUST_NOT:
                    if t is None:
                        continue
                    if narrow:
                        # score-lane exclusion: any match goes hard
                        # negative, below every gate/zero threshold
                        w2[terms[t], qi] += W_MUSTNOT
                    else:
                        add_count(terms[t], qi, -64.0)
                    continue
                if kind == "gate" and count_group:
                    # facet MUST: GATE_BIG in the lane (facet entries
                    # contribute exactly 1.0), real idf on the shift.
                    # An absent facet term means nothing can pass the
                    # gate threshold — matches the empty result the
                    # boolean semantics require.
                    n_gates += 1
                    df = stats.facet_doc_freq(c.term)
                    gate_idf += float(idf(df, stats.doc_count)) * c.boost
                    if t is not None:
                        w2[terms[t], qi] += GATE_BIG
                    continue
                if t is None:
                    continue
                slot = terms[t]
                if count_group and not narrow:
                    add_count(slot, qi, 1.0)
                if c.is_facet:
                    df = stats.facet_doc_freq(c.term)
                    wv = float(idf(df, stats.doc_count)) * c.boost
                    if count_group and kind == "shift":
                        # constant facet score moves to the host-side
                        # shift so scores>0 == "some SHOULD matched"
                        shifts[i] = shifts.get(i, 0.0) + wv
                    else:
                        w2[slot, qi] += wv
                else:
                    df = stats.doc_freq(c.field, c.term)
                    w2[slot, qi] += float(
                        bm25_weight(df, stats.doc_count, c.boost, k1)
                    )
        if kind == "gate":
            nmust[0, qi] = (n_gates - 0.5) * GATE_BIG
            shifts[i] = gate_idf - n_gates * GATE_BIG
    return w2, nmust, tid_arr


def _effective_kinds(plans, kinds, q_idx, wide):
    """Per-batch staging kinds.  In a WIDE batch the narrow score-lane
    tricks are unavailable (the kernel extracts counts, and nm means
    "required count", not a score threshold), so narrow kinds restate as
    their counted equivalents: "neg" -> "exact" (MUST_NOT as -64 counts),
    "gate" -> "exact"/"shift" (facet MUSTs as +1 counts with idf back on
    the score lane / host shift).  Pure plans stage narrow-style either
    way (no counts, nm=0)."""
    if not wide:
        return kinds
    eff: Dict[int, str] = {}
    for i in q_idx:
        if i is None:
            continue
        k = kinds[i]
        if k == "neg":
            k = "exact"
        elif k == "gate":
            n_should = sum(
                1
                for g in plans[i].groups
                if g.occur is Occur.SHOULD and g.clauses
            )
            k = "shift" if (plans[i].require_should and n_should) else "exact"
        eff[i] = k
    return eff


def _stream_cost(n_queries: int, n_terms: int, wide: bool, packed: bool):
    """Relative phase-A cost of one corpus stream: the TPU kernel's flop
    model (lanes x (u_pad + block docs)) plus the fixed per-stream
    overhead, kept for parity of the stream plan with the reference."""
    u = next((u for u in U_BUCKETS if n_terms <= u), U_BUCKETS[-1])
    b = next((v for v in B_BUCKETS if n_queries <= v), B_BUCKETS[-1])
    if packed:
        b2 = b + b // 2
    else:
        b2 = 2 * b if wide else b
    # penalty calibrated at a typical u_pad of 512 (don't track ladder
    # refinements: the fixed grid/DMA overhead doesn't shrink with u)
    fixed = _STREAM_PENALTY_LANES * (512 + BM_BLOCK_DOCS)
    return b2 * (u + BM_BLOCK_DOCS) + fixed


def _merge_streams(batches, batch_terms, kinds, plans=None, tid_of=None):
    """Fuse a (narrow, wide) batch pair into ONE wide stream when the
    packed count lanes cost less than the second stream's fixed overhead
    plus its lanes (mixed workloads: the 40-query MUST stream folds into
    the 200-query narrow stream as 128 extra packed lanes instead of a
    whole extra corpus stream).

    With ``plans``/``tid_of`` the cost model verifies bit-packability
    with a real :func:`_pack_order` dry run instead of assuming it;
    batches containing an "upper" plan never fold (merging would drag
    every query through the full raw-maxima host path, which the flop
    units don't price)."""
    changed = True
    while changed:
        changed = False
        for a in range(len(batches)):
            for b in range(len(batches)):
                if a == b:
                    continue
                qa, qb = batches[a], batches[b]
                if any(kinds[i] == "upper" for i in qa + qb):
                    continue  # raw-maxima host path: never fold into it
                wa = any(kinds[i] not in NARROW_KINDS for i in qa)
                wb = any(kinds[i] not in NARROW_KINDS for i in qb)
                if wa == wb:
                    continue  # only narrow+wide pairs fold
                if len(qa) + len(qb) > B_PAD:
                    continue
                terms = set(batch_terms[a]) | set(batch_terms[b])
                if len(terms) > U_BUCKETS[-1]:
                    continue
                n_m = len(qa) + len(qb)
                b_m = next(v for v in B_BUCKETS if n_m <= v)
                # narrow queries lead: _pack_order pairs them freely
                merged = (qa + qb) if wb else (qb + qa)
                packable = b_m >= _PACK_MIN_B
                if packable and plans is not None and tid_of is not None:
                    packable = (
                        _pack_order(merged, plans, tid_of, b_m // 2)
                        is not None
                    )
                cost_m = _stream_cost(n_m, len(terms), True, packable)
                cost_s = _stream_cost(
                    len(qa), len(batch_terms[a]), wa, False
                ) + _stream_cost(len(qb), len(batch_terms[b]), wb, False)
                if cost_m >= cost_s:
                    continue
                batches[a] = merged
                tmap: Dict[int, int] = {}
                for t in list(batch_terms[a]) + list(batch_terms[b]):
                    if t not in tmap:
                        tmap[t] = len(tmap)
                batch_terms[a] = tmap
                del batches[b], batch_terms[b]
                changed = True
                break
            if changed:
                break
    return batches, batch_terms


def _count_weight_map(plan: QueryPlan, tid_of) -> Dict[int, float]:
    """tid -> summed count-lane weight the wide staging writes for one
    plan (+1 per single-clause MUST, -64 per MUST_NOT clause)."""
    m: Dict[int, float] = {}
    for g in plan.groups:
        if g.occur is Occur.MUST_NOT:
            for c in g.clauses:
                field = FACET_FIELD_KEY if c.is_facet else c.field
                t = tid_of.get((field, c.term))
                if t is not None:
                    m[t] = m.get(t, 0.0) - 64.0
        elif g.occur is Occur.MUST and len(g.clauses) == 1:
            c = g.clauses[0]
            field = FACET_FIELD_KEY if c.is_facet else c.field
            t = tid_of.get((field, c.term))
            if t is not None:
                m[t] = m.get(t, 0.0) + 1.0
    return m


@functools.lru_cache(maxsize=4096)
def _bf16_exact(x: float) -> bool:
    bf = torch.tensor(x, dtype=torch.float32).to(torch.bfloat16)
    return float(bf.to(torch.float32)) == x


def _pack_order(q_idx, plans, tid_of, half):
    """Reorder a wide batch so count lanes can bit-pack two queries.

    The query at position j (j < half) shares a count lane with the one
    at position half + j; a term both write lands as lo + FIELD * hi in
    ONE bf16 weight, which must round-trip exactly (e.g. two paired
    MUSTs on the same term -> 4097: not representable).  Greedy
    first-fit pairing plus a pair-splitting repair pass; returns the
    reordered q_idx (None = pad lane keeping pair geometry) or None when
    no safe arrangement fits (caller stages unpacked)."""
    maps = {i: _count_weight_map(plans[i], tid_of) for i in q_idx}
    for m in maps.values():
        for w in m.values():
            if not (_bf16_exact(w) and _bf16_exact(w * _PACK_FIELD)):
                return None

    def ok(lo_i, hi_i):
        mh = maps[hi_i]
        for t, wl in maps[lo_i].items():
            wh = mh.get(t)
            if wh is not None and not _bf16_exact(wl + _PACK_FIELD * wh):
                return False
        return True

    lo: List[int] = []
    hi: List[Optional[int]] = []
    for i in q_idx:
        for j in range(len(lo)):
            if hi[j] is None and ok(lo[j], i):
                hi[j] = i
                break
        else:
            lo.append(i)
            hi.append(None)
    pairs = [(l, h) for l, h in zip(lo, hi) if h is not None]
    solos = [l for l, h in zip(lo, hi) if h is None]
    # repair: two leftover solos can displace into an existing pair
    # ((l,h) + s1 + s2 -> (l,s1) + (s2,h): one lane slot freed)
    while len(pairs) + len(solos) > half and len(solos) >= 2:
        repaired = False
        for si in range(len(solos)):
            for sj in range(len(solos)):
                if si == sj:
                    continue
                for pi, (l, h) in enumerate(pairs):
                    if ok(l, solos[si]) and ok(solos[sj], h):
                        pairs[pi] = (l, solos[si])
                        pairs.append((solos[sj], h))
                        for idx in sorted((si, sj), reverse=True):
                            solos.pop(idx)
                        repaired = True
                        break
                if repaired:
                    break
            if repaired:
                break
        if not repaired:
            return None
    if len(pairs) + len(solos) > half:
        return None
    lo_side = [l for l, _ in pairs] + solos
    lo_side += [None] * (half - len(lo_side))
    out = lo_side + [h for _, h in pairs]
    while out and out[-1] is None:
        out.pop()
    return out




def batch_search(
    segment: Segment,
    plans: Sequence[QueryPlan],
    stats,
    limits: Sequence[int],
    device: torch.device,
) -> List[Optional[List[Tuple[float, int]]]]:
    """Two-phase batch search; per-plan result limits.

    Returns one entry per plan; None marks plans this path does not
    handle (callers run those through the block scorer directly).
    Phase A is limit-independent, so plans with different limits share
    the same corpus streams; phase-B waves group by limit.
    """
    from fugu_tpu_torch.ops.block_scorer import BLOCK as B_BLOCK, MAX_K

    results: List[Optional[List[Tuple[float, int]]]] = [None] * len(plans)
    kinds = {}
    for i, p in enumerate(plans):
        if limits[i] > MAX_K:
            continue
        kind = _classify(p)
        if kind is not None and has_nonpositive_weight(p, stats):
            kind = None  # 'scores > 0 == matched' breaks; host fallback
        if kind is not None:
            kinds[i] = kind
    # narrow-kind plans (pure/neg/gate) batch first so they ride narrow
    # (no-count) streams; count lanes double phase A's work and only
    # count-needing batches should pay for them
    elig = sorted(kinds, key=lambda i: (kinds[i] not in NARROW_KINDS, i))
    # a phase-A stream needs a real batch to pay for itself; on the CPU
    # (tests) every batch takes it, so small batches reach phase A too
    if len(elig) < (1 if device.type == "cpu" else MIN_BATCH):
        return results

    pack = segment.block_major(stats, device)
    k1 = plans[elig[0]].k1
    batches, batch_terms = plan_batches(plans, elig, kinds, pack.tid_of)
    batches, batch_terms = _merge_streams(
        batches, batch_terms, kinds, plans, pack.tid_of
    )

    nb = pack.n_blocks
    pending = []
    shifts: Dict[int, float] = {}  # "shift" plans: constant facet score
    for q_idx, terms in zip(batches, batch_terms):
        u_pad = next((u for u in U_BUCKETS if len(terms) <= u), None)
        if u_pad is None:
            continue  # single over-wide query set: block-scorer fallback
        b_pad = next(v for v in B_BUCKETS if len(q_idx) <= v)
        wide = any(kinds[i] not in NARROW_KINDS for i in q_idx)
        eff = _effective_kinds(plans, kinds, q_idx, wide)
        # bit-pack two queries' count columns per lane at b_pad = 256
        packed = False
        if wide and b_pad >= _PACK_MIN_B:
            order = _pack_order(q_idx, plans, pack.tid_of, b_pad // 2)
            if order is not None:
                q_idx = order
                packed = True
        # lane-concat [weights | must-counts]: one stream serves both the
        # score sum and the constraint count (wide batches only)
        w2, nmust, tid_arr = stage_batch_weights(
            plans, eff, q_idx, terms, stats, pack.tid_of, b_pad, wide,
            k1, shifts, packed=packed,
        )
        slot_of = np.full(max(pack.n_terms, 1), -1, dtype=np.int32)
        for t, slot in terms.items():
            slot_of[t] = slot
        fine = _fine_for_stream(q_idx, limits)
        amax = phasea(
            pack.d_chunk_offs,
            pack.d_doc,
            pack.d_tid,
            pack.d_con,
            torch.from_numpy(w2).to(device=device, dtype=torch.bfloat16),
            torch.from_numpy(slot_of).to(device),
            torch.from_numpy(nmust[0]).to(device),
            fine,
        )
        if any(i is not None and kinds[i] == "upper" for i in q_idx):
            # "upper" bounds need the raw per-block maxima on the host
            # (wave-1 ordering + the post-wave-1 re-threshold)
            pending.append(("full", q_idx, (amax,), fine))
        else:
            # kth + margin threshold on the device; only the candidate
            # mask and the finite counts come back to the host
            k_top = min(128, nb * fine)
            shift_v = np.zeros(b_pad, dtype=np.float32)
            limidx = np.full(b_pad, -1, dtype=np.int32)
            margin_v = np.zeros(b_pad, dtype=np.float32)
            for qi, i in enumerate(q_idx):
                if i is None:
                    continue
                shift_v[qi] = shifts.get(i, 0.0)
                limidx[qi] = limits[i] - 1 if limits[i] <= k_top else -1
                # key on the EFFECTIVE staging kind: a "gate" plan folded
                # into a wide stream restages as shift/exact (no GATE_BIG
                # terms in its maxima)
                if eff[i] == "gate":
                    margin_v[qi] = GATE_MARGIN
            mask, count = postproc(
                amax,
                torch.from_numpy(shift_v).to(device),
                torch.from_numpy(limidx).to(device),
                torch.from_numpy(margin_v).to(device),
            )
            pending.append(("compact", q_idx, (mask, count), fine))

    # phase B: per-query candidate 2048-blocks from the maxima
    sub_per_big = B_BLOCK // BM_BLOCK_DOCS

    def run_wave(idxs: List[int], lists: Dict[int, np.ndarray]):
        """One batched block-scorer wave, grouped by per-plan limit; all
        limit groups launch before any fetch."""
        from fugu_tpu_torch.ops.block_scorer import (
            block_search_begin,
            block_search_collect,
        )

        out: Dict[int, Optional[List[Tuple[float, int]]]] = {}
        by_limit: Dict[int, List[int]] = {}
        for i in idxs:
            by_limit.setdefault(limits[i], []).append(i)
        groups = list(by_limit.items())
        handles = [
            block_search_begin(
                segment,
                [plans[i] for i in ii],
                stats,
                lim,
                device,
                block_lists={j: lists[i] for j, i in enumerate(ii)},
            )
            for lim, ii in groups
        ]
        for (lim, ii), sub in zip(groups, block_search_collect(handles)):
            for j, i in enumerate(ii):
                out[i] = sub[j]
        return out

    def thresh_of(kth: float) -> float:
        return kth - abs(kth) * MARGIN_REL - MARGIN_ABS

    # candidate indices arrive at each stream's own fine granularity
    # ((512/fine)-doc slices); fine_of remembers it for the "upper"
    # two-wave re-threshold
    fine_of: Dict[int, int] = {}
    cols: Dict[int, np.ndarray] = {}
    wave1_idx: List[int] = []
    wave1_lists: Dict[int, np.ndarray] = {}
    for tag, q_idx, arrs, fine in pending:
        fine_sub = sub_per_big * fine
        if tag == "compact":
            mask = arrs[0].cpu().numpy()     # [nb * fine, b_pad]
            count = arrs[1].cpu().numpy()    # [b_pad]
            for qi, i in enumerate(q_idx):
                if i is None:
                    continue
                if count[qi] == 0:
                    results[i] = []  # no doc scores any positive clause
                    continue
                cand = np.nonzero(mask[:, qi])[0]
                wave1_lists[i] = np.unique(cand // fine_sub).astype(np.int64)
                wave1_idx.append(i)
            continue
        amax = arrs[0].cpu().numpy().reshape(nb * fine, -1)  # [NB*F, b_pad]
        for qi, i in enumerate(q_idx):
            if i is None:
                continue
            col = amax[:, qi]
            if i in shifts:  # add back the constant MUST-facet score
                col = np.where(np.isfinite(col), col + shifts[i], col)
            finite = col[np.isfinite(col)]
            if len(finite) == 0:
                results[i] = []  # no doc scores any positive clause
                continue
            lim = limits[i]
            if kinds[i] != "upper":
                # "pure"/"exact": maxima are achievable doc scores, so
                # kth-of-maxima is a valid lower bound — one wave
                kth = (
                    np.partition(-finite, lim - 1)[lim - 1] * -1
                    if len(finite) >= lim
                    else -np.inf
                )
                cand = np.nonzero(col >= thresh_of(kth))[0]
                wave1_lists[i] = np.unique(cand // fine_sub).astype(np.int64)
            else:
                # "upper": maxima are only upper bounds; wave 1 scores
                # the best-bounded big-blocks to establish kth
                cols[i] = col
                fine_of[i] = fine
                n_big = (len(col) + fine_sub - 1) // fine_sub
                big_u = np.full(n_big * fine_sub, NEG_INF, dtype=col.dtype)
                big_u[: len(col)] = col
                big_u = big_u.reshape(n_big, fine_sub).max(axis=1)
                order = np.argsort(-big_u, kind="stable")
                take = order[: ROUND1_BLOCKS]
                wave1_lists[i] = np.sort(take[np.isfinite(big_u[take])]).astype(
                    np.int64
                )
            wave1_idx.append(i)

    if not wave1_idx:
        return results
    wave1 = run_wave(wave1_idx, wave1_lists)

    wave2_idx: List[int] = []
    wave2_lists: Dict[int, np.ndarray] = {}
    for i in wave1_idx:
        hits1 = wave1[i]
        if hits1 is None:  # block scorer declined: hand back to caller
            results[i] = None
            continue
        if kinds[i] != "upper":
            results[i] = hits1
            continue
        lim = limits[i]
        col = cols[i]
        kth = hits1[lim - 1][0] if len(hits1) >= lim else -np.inf
        cand = np.nonzero(col >= thresh_of(kth))[0] if np.isfinite(kth) else (
            np.nonzero(np.isfinite(col))[0]
        )
        rest = np.setdiff1d(
            np.unique(cand // (sub_per_big * fine_of[i])).astype(np.int64),
            wave1_lists[i],
        )
        if len(rest) == 0:
            results[i] = hits1[:lim]
        else:
            wave2_idx.append(i)
            wave2_lists[i] = rest

    if wave2_idx:
        wave2 = run_wave(wave2_idx, wave2_lists)
        for i in wave2_idx:
            hits2 = wave2[i]
            if hits2 is None:
                results[i] = None
                continue
            # waves partition doc space; (-score, doc) re-rank reproduces
            # the single-phase scorer's global tie-break exactly
            merged = list(wave1[i]) + list(hits2)
            merged.sort(key=lambda sd: (-sd[0], sd[1]))
            results[i] = merged[: limits[i]]
    return results
