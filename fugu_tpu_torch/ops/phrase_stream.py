"""Batched phrase engine: a brute-force sweep of the forward token stream.

The counterpart of ``fugu_tpu/ops/phrase_stream.py``.  Matching phrases
by chasing position lists is the access pattern a wide device is worst
at, so phrases take the shape of the term engine's phase A
(ops/batch_scorer.py): one pass over the corpus serves the whole batch.

**TokenStreamPack** (built per (segment, field), cached by the index
stats fingerprint and the device): the corpus as a FORWARD token
stream — for every 512-doc block, each live doc's tokens laid out at
their position index (holes = sentinel; POSITION_GAP holes already
separate multi-value fields), KGAP sentinel rows between docs so
adjacency can never cross a doc, each block's stream cut into 2048-row
chunks that OVERLAP by KGAP rows (a row's KGAP successors are always
visible in some chunk where the row is anchor-eligible).  Each int32
row packs (doc_local << 22 | tid).

**Phrase kernel** (``csrc/phrase.cu``; plain PyTorch version
:func:`phrase_stream_plain`): one pass over the pack computes, for the
whole phrase batch at once, the max phrase score per (fine slice of a
512-doc block, query).  An anchor is a row in the first
BM_CHUNK - KGAP rows of its chunk whose term is slot 0 of a query; slot
j >= 1 matches if any of the rows anchor + j .. anchor + j + slop holds
its term (the oracle's ordered-window relaxation, ops/oracle.py), and
dead slots past the query's length always match.  Anchors count once
(chunk tails reappear at the next chunk's head), so the per-(doc,
query) count IS the oracle's phrase_tf, and the kernel's maxima of
``wp * tf / (tf + cv)`` are achievable doc scores.  Where the TPU
matched by one-hot matmuls against bf16 weight planes, the staged
operands here are compact: per query the union slot of each of its
terms and its slop, a term -> union slot table, and the phrase weight.

A postprocessor ships each query's top-K fine blocks SORTED BY BOUND
(lowest block id first among equal bounds), and the host matches them
in that order with float-safe early termination, re-checking survivors
with the exact PhraseMatcher (ops/phrase.py) so final scores stay
bit-identical to the oracle.

Routing is the reference's default ``auto`` mode and only that: the
port reads no environment variable to route phrases (the carried
docstrings that name ``FUGU_PHRASE_STREAM`` describe the reference).
The cost model's constants were fitted on the TPU host and are starting
values on the GPU.

Eligibility: single-group single-phrase plans (the quoted-query shape),
slop <= MAX_SLOP, <= 8 terms, default k1/b, positive boost, limit
<= 128, vocab < 2^22 terms in the field.  Everything else stays on the
host matcher, which is exact.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from fugu_tpu_torch import cuda_build
from fugu_tpu_torch.index.segment import BM_BLOCK_DOCS, BM_CHUNK, Segment
from fugu_tpu_torch.ops.batch_scorer import (
    BM_FINE_DOCS,
    FINE_PER_BLOCK,
    _nb_pad,
    _ptr,
)
from fugu_tpu_torch.ops.block_scorer import _order_keys
from fugu_tpu_torch.ops.staging import NEG_INF
from fugu_tpu_torch.query import (
    Occur,
    PhraseClause,
    QueryPlan,
    bm25_weight,
    fieldnorm_cache,
)

#: max phrase terms on the device path; also the inter-doc sentinel gap
#: and the chunk overlap (a row's KGAP-1 successors stay visible)
KMAX = 8
KGAP = KMAX
#: max slop on the device path (r5).  Slop semantics are the oracle's
#: ordered-window relaxation (term k anywhere in [anchor+k, anchor+k+
#: slop]; ops/oracle.py:141) — the kernel ORs each slot's one-hot over
#: its shift window, clamped to 1 per slot, so device phrase_tf stays
#: EXACT for sloppy phrases too.  The forward reach (n_terms-1+slop)
#: must stay <= KGAP: beyond that a roll's wrapped rows land on
#: anchor-ELIGIBLE rows and the doc-gap sentinels no longer block
#: cross-doc adjacency (see eligible_phrase).
MAX_SLOP = 2
#: term-ordinal bits in a packed stream row (doc_local rides bits 22-30,
#: sign bit stays 0: 511 << 22 | TID_MASK == 0x7FFFFFFF)
TID_BITS = 22
TID_MASK = (1 << TID_BITS) - 1
#: sentinel row: reserved never-assigned tid, doc_local 0 (harmless —
#: sentinel rows produce match 0, and match is the scatter's rhs)
SENT_ROW = np.int32(TID_MASK)

#: ladders (compile signatures; persistently cached like phase A's)
PB_BUCKETS = (64, 128, 256)
PU_BUCKETS = (128, 256, 512)
PK_BUCKETS = (2, 4, 8)
#: kmax ladder for sloppy dispatches (smax=MAX_SLOP): the wrap/doc-gap
#: constraint is kmax_bucket - 1 + smax <= KGAP, so the top bucket is 7
PK_SLOP_BUCKETS = (2, 4, 7)

#: one stream pays a fixed cost (staging, launch, postproc, fetch);
#: below this many staged phrases the host matcher is cheaper
PHRASE_MIN_BATCH = 8

#: a batch of at least this many phrases streams unconditionally when
#: the cost model below lacks its inputs (plans and stats); with them,
#: the cost model decides at any batch size
PHRASE_AUTO_MIN = 128

#: df cost model for auto routing, fitted on the TPU host (1M bench
#: corpus) and carried as starting values.  The host matcher intersects
#: rarest-first (ops/phrase.py PhraseMatcher), so its cost tracks the
#: SMALLEST constituent df plus the adjacency work on the candidate
#: intersection Πdf/N, corrected by (1 + 3·min_df/N) because positions
#: per doc grow with df.  The stream's sweep is df-INDEPENDENT: a fixed
#: cost, a cost per corpus token, and a small cost per phrase (host
#: verify).
HOST_NS_PER_MIN_POSTING = 44.0
HOST_NS_PER_INTER_DOC = 55.6
STREAM_NS_PER_TOKEN = 2.0
STREAM_FIXED_MS = 45.0
STREAM_MS_PER_PHRASE = 1.4


def estimate_host_ms(plans, stats) -> float:
    """Predicted host-matcher cost: rarest-posting walk + intersection
    adjacency work per phrase (see the calibration note above)."""
    n = max(stats.doc_count, 1)
    total = 0.0
    for p in plans:
        for g in p.groups:
            for pc in g.phrases:
                dfs = [stats.doc_freq(pc.field, t) for t in pc.terms]
                if not dfs or min(dfs) == 0:
                    continue  # dead phrase: host rejects instantly
                min_df = min(dfs)
                inter = 1.0
                for d in dfs:
                    inter *= d
                inter /= float(n) ** (len(dfs) - 1)
                total += min_df * HOST_NS_PER_MIN_POSTING * 1e-6
                # slop multiplies the adjacency work: each later term's
                # anchor set expands (slop+1)x before the intersection
                # (PhraseMatcher.match's np.unique over shifted copies)
                slop_f = 1.0 + max(int(getattr(pc, "slop", 0) or 0), 0)
                total += (
                    inter
                    * slop_f
                    * HOST_NS_PER_INTER_DOC
                    * 1e-6
                    * (1.0 + 3.0 * min_df / n)
                )
    return total


def estimate_stream_ms(stats, n_phrases: int) -> float:
    """Predicted stream cost: the df-independent corpus sweep plus the
    small per-phrase verify/lane cost."""
    toks = sum(stats.total_tokens.values())
    return (
        STREAM_FIXED_MS
        + toks * STREAM_NS_PER_TOKEN * 1e-6
        + n_phrases * STREAM_MS_PER_PHRASE
    )


def _stream_fits_budget(stats) -> bool:
    """False when staging the token-stream pack would blow the HBM
    residency budget past what is already resident.

    Matters at 16M docs on a 16GB chip: the phase-A packs alone are
    ~12.9GB of the 13.6GB auto budget, and the ~4.5GB token pack would
    evict them — every subsequent mixed batch then re-uploads multi-GB
    packs over a 10-35MB/s relay (minutes per batch, vs the ~100ms/
    phrase host cost the eviction was meant to beat).  Auto mode routes
    to the host instead; ``FUGU_PHRASE_STREAM=1`` still forces the
    stream for operators with phrase-dominant workloads.  Token bytes
    already resident (an earlier phrase batch staged them) count as
    free, so a warm phrase-heavy workload keeps streaming.
    """
    from fugu_tpu_torch.index.segment import _pow2_bucket
    from fugu_tpu_torch.ops import residency

    budget = residency.budget_bytes()
    if budget is None:
        return True
    toks = sum(stats.total_tokens.values())
    docs = stats.doc_count
    # stream rows = tokens + per-doc KGAP sentinel gap, chunk-overlap
    # inflated, pow2/16-step bucketed; plus the [nb_pad*1024] cv/fid rows
    rows = (toks + docs * KGAP) * BM_CHUNK // max(BM_CHUNK - KGAP, 1)
    est = _pow2_bucket(max(int(rows), BM_CHUNK)) * 4
    est += _nb_pad(max((docs + BM_BLOCK_DOCS - 1) // BM_BLOCK_DOCS, 1)) * 1024 * 8
    st = residency.stats()
    already = st["by_kind"].get("token_stream", 0)
    needed = max(est - already, 0)
    return st["resident_bytes"] + needed <= budget


def want_stream(
    n_phrases: int, plans=None, stats=None, overlap_ms: float = 0.0
) -> bool:
    """Whether a batch of ``n_phrases`` phrase plans should stream (the
    reference's ``auto`` mode).

    ``overlap_ms``: estimated wall time of the DEVICE batch the same
    call dispatches concurrently (0 for a pure phrase batch).  The host
    matcher runs on a worker thread UNDER that batch (engine/
    named_index), so up to ``overlap_ms`` of host phrase work is free,
    while the stream's sweep ADDS device time to the same device queue.
    Callers estimate overlap with :func:`estimate_device_batch_ms`."""
    if stats is not None and not _stream_fits_budget(stats):
        return False
    if overlap_ms > 0.0:
        # a concurrent device batch: only the host excess beyond the
        # device wall competes with the stream's sweep, at ANY batch
        # size.  The credit gates on overlap_ms ALONE: missing model
        # inputs mean "don't stream", never the unconditional
        # PHRASE_AUTO_MIN stream the credit exists to prevent
        if plans is None or stats is None:
            return False
        return (
            n_phrases >= PHRASE_MIN_BATCH
            and estimate_host_ms(plans, stats) - overlap_ms
            > estimate_stream_ms(stats, n_phrases)
        )
    if n_phrases >= PHRASE_AUTO_MIN and (plans is None or stats is None):
        return True  # model inputs missing: large batches favor the sweep
    if n_phrases < PHRASE_MIN_BATCH or plans is None or stats is None:
        return False
    # the cost model decides at ANY batch size when its inputs exist:
    # df-blind batch-size rules don't transfer across df profiles
    return estimate_host_ms(plans, stats) > estimate_stream_ms(stats, n_phrases)


def estimate_device_batch_ms(
    stats, n_queries: int, token_share: float = 1.0
) -> float:
    """Crude wall-time model of a concurrent two-phase device batch, for
    want_stream's overlap credit.  Phase A sweeps the same corpus the
    phrase stream does with the same cost shape (fixed dispatch floor +
    per-token sweep + per-query staging/wave cost), so the calibrated
    stream constants transfer: at 1M docs/44M postings this predicts a
    256-query mixed batch at ~500ms (round-3 measured 450-530ms).

    ``token_share``: fraction of the index's tokens the concurrent batch
    actually sweeps — multi-segment callers pass the CURRENT segment's
    share, since each segment's device batch sweeps only that segment
    (index-wide stats would overestimate the credit per segment and bias
    phrases onto the host thread, ADVICE r4)."""
    if n_queries <= 0:
        return 0.0
    toks = sum(stats.total_tokens.values()) * min(max(token_share, 0.0), 1.0)
    return (
        STREAM_FIXED_MS
        + toks * STREAM_NS_PER_TOKEN * 1e-6
        + n_queries * STREAM_MS_PER_PHRASE
    )


# --------------------------------------------------------------------------
# pack construction
# --------------------------------------------------------------------------


class _StreamArrays:
    """Host-side token stream of one (segment, field, doc range):
    (pack rows, cv, fid, chunk_offs, nb, nb_pad, tid_of, n_terms, ok).
    Shared by the single-chip TokenStreamPack and the sharded
    per-doc-range builder (parallel/phrase_sharded)."""

    __slots__ = (
        "pack", "cv", "fid", "chunk_offs", "n_blocks", "nb_pad",
        "tid_of", "n_terms", "ok",
    )


def build_stream_arrays(
    segment: Segment,
    field: str,
    stats,
    doc_lo: int = 0,
    doc_hi: Optional[int] = None,
    nb_pad: Optional[int] = None,
) -> _StreamArrays:
    """Build the forward token stream for docs in [doc_lo, doc_hi) with
    LOCAL doc ids (doc - doc_lo) — doc_lo=0/doc_hi=None is the whole
    segment.  Term ordinals are segment-global per field, so a sharded
    caller's weight matrices stay replicated across shards."""
    out = _StreamArrays()
    offs = segment.pos_offsets[field]
    data = segment.pos_data[field]
    base = segment.field_entry_base[field]
    n_ent = len(offs) - 1
    e_docs = segment.e_doc[base : base + n_ent].astype(np.int64)
    if doc_hi is None:
        doc_hi = segment.doc_count
    doc_count = doc_hi - doc_lo
    nb = max((doc_count + BM_BLOCK_DOCS - 1) // BM_BLOCK_DOCS, 1)
    out.n_blocks = nb
    out.nb_pad = nb_pad if nb_pad is not None else _nb_pad(nb)
    assert out.nb_pad >= nb

    # per-field term ordinals (the kernel's tid space)
    tmap = segment.terms[field]
    out.tid_of = {}
    tid_entry = np.zeros(max(n_ent, 1), dtype=np.int64)
    for j, (term, info) in enumerate(tmap.items()):
        out.tid_of[term] = j
        lo = info.start - base
        tid_entry[lo : lo + info.doc_freq] = j
    out.n_terms = len(tmap)
    out.ok = out.n_terms < TID_MASK  # tid 2^22-1 is the sentinel
    if not out.ok:
        return out

    # stream geometry: each LOCAL doc owns rows [row0[d], row0[d] +
    # maxpos[d] + 1 + KGAP); docs with no tokens in the field (or
    # tombstoned, or outside the range) own nothing
    lens = (offs[1:] - offs[:-1]).astype(np.int64)
    maxpos = np.full(doc_count, -1, dtype=np.int64)
    in_range = (e_docs >= doc_lo) & (e_docs < doc_hi)
    local_e = e_docs - doc_lo
    if n_ent:
        last = data[np.maximum(offs[1:] - 1, 0)].astype(np.int64)
        last = np.where(lens > 0, last, -1)
        np.maximum.at(
            maxpos, np.where(in_range, local_e, 0), np.where(in_range, last, -1)
        )
    live = ~segment.tombstones[doc_lo:doc_hi]
    has = (maxpos >= 0) & live
    dlen = np.where(has, maxpos + 1 + KGAP, 0)
    row0 = np.zeros(doc_count + 1, dtype=np.int64)
    np.cumsum(dlen, out=row0[1:])
    total_raw = int(row0[-1])

    raw = np.full(max(total_raw, 1), SENT_ROW, dtype=np.int32)
    if n_ent and total_raw:
        keep_e = in_range & has[np.where(in_range, local_e, 0)]
        rep_docs = np.repeat(local_e, lens * keep_e)
        rep_tids = np.repeat(tid_entry[:n_ent], lens * keep_e)
        pos_sel = _ragged_positions(data, offs, lens, keep_e)
        rows = row0[rep_docs] + pos_sel
        vals = rep_tids.astype(np.int64) | (
            (rep_docs % BM_BLOCK_DOCS) << TID_BITS
        )
        raw[rows] = vals.astype(np.int32)

    # per-block chunking with KGAP-row overlap: chunk i of a block
    # reads raw rows [i*(C-KGAP), i*(C-KGAP)+C) of the block's range
    usable = BM_CHUNK - KGAP
    blk_starts = row0[np.minimum(
        np.arange(nb, dtype=np.int64) * BM_BLOCK_DOCS, doc_count
    )]
    blk_ends = row0[np.minimum(
        (np.arange(nb, dtype=np.int64) + 1) * BM_BLOCK_DOCS, doc_count
    )]
    blk_len = blk_ends - blk_starts
    n_chunks = (blk_len + usable - 1) // usable  # 0 for empty blocks
    chunk_offs = np.zeros(out.nb_pad + 1, dtype=np.int32)
    np.cumsum(n_chunks, out=chunk_offs[1 : nb + 1])
    chunk_offs[nb + 1 :] = chunk_offs[nb]
    out.chunk_offs = chunk_offs
    total_chunks = int(chunk_offs[nb])

    size = _pack_rows(total_chunks)
    pack = np.full(size, SENT_ROW, dtype=np.int32)
    if total_chunks:
        blk_of = np.repeat(
            np.arange(nb, dtype=np.int64), n_chunks
        )
        within = (
            np.arange(total_chunks, dtype=np.int64)
            - chunk_offs[blk_of].astype(np.int64)
        )
        src0 = blk_starts[blk_of] + within * usable
        idx = src0[:, None] + np.arange(BM_CHUNK, dtype=np.int64)[None, :]
        valid = idx < blk_ends[blk_of][:, None]
        took = raw[np.where(valid, idx, 0)]
        pack[: total_chunks * BM_CHUNK] = np.where(
            valid, took, SENT_ROW
        ).reshape(-1)

    # per-doc BM25 denominator constants, laid out [block * 1024 +
    # doc_local] so the kernel DMAs one aligned 1024-f32 row per block
    cache = fieldnorm_cache(stats.avg_fieldnorm(field))
    fids = segment.fieldnorm_ids[field][doc_lo:doc_hi].astype(np.int64)
    cv = np.zeros(out.nb_pad * 1024, dtype=np.float32)
    didx = np.arange(doc_count, dtype=np.int64)
    cv[(didx // BM_BLOCK_DOCS) * 1024 + didx % BM_BLOCK_DOCS] = cache[
        fids
    ]
    # padded/empty doc slots keep cv=0; their tf is always 0, and the
    # tf > 0.5 gate excludes them before the 0/0 division could matter
    cv[cv == 0.0] = np.float32(1.0)
    # per-doc fieldnorm ids, same layout: the kernel packs each
    # block-max doc's exact INTEGER (tf, fid) class alongside the
    # f32 maxima, so the host can recompute bit-exact bounds with
    # its own float arithmetic (margin-free pruning)
    fid_arr = np.zeros(out.nb_pad * 1024, dtype=np.int32)
    fid_arr[(didx // BM_BLOCK_DOCS) * 1024 + didx % BM_BLOCK_DOCS] = fids
    out.pack = pack
    out.cv = cv
    out.fid = fid_arr
    return out


class TokenStreamPack:
    """Forward token stream of one (segment, field) on one device,
    block-major and chunk-overlapped for the phrase kernel (see module
    docstring): ``d_offs`` (chunk offsets per block), ``d_tok`` (rows),
    ``d_cv`` and ``d_fid`` (per-doc constants) are the kernel's stream
    operands."""

    def __init__(self, segment: Segment, field: str, stats, device):
        arrs = build_stream_arrays(segment, field, stats)
        self.n_blocks = arrs.n_blocks
        self.nb_pad = arrs.nb_pad
        self.tid_of = arrs.tid_of
        self.n_terms = arrs.n_terms
        self.ok = arrs.ok
        if not self.ok:
            return
        self.chunk_offs = arrs.chunk_offs

        from fugu_tpu_torch.ops import residency

        self.hbm_bytes = arrs.pack.nbytes + arrs.cv.nbytes + arrs.fid.nbytes
        residency.reserve(
            ("tok", id(segment), field),
            self.hbm_bytes,
            segment,
            functools.partial(_evict_token_stream, field=field),
            kind="token_stream",
        )
        self.d_offs, self.d_tok, self.d_cv, self.d_fid = (
            torch.from_numpy(a).to(device)
            for a in (arrs.chunk_offs, arrs.pack, arrs.cv, arrs.fid)
        )


def _ragged_positions(data, offs, lens, keep_e):
    """data[offs[i]:offs[i]+lens[i]] concatenated over entries with
    keep_e[i] (the repeat/cumsum idiom, no Python loop)."""
    klens = lens * keep_e
    total = int(klens.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    rep = np.repeat(offs[:-1].astype(np.int64), klens)
    within = np.arange(total, dtype=np.int64) - np.repeat(
        np.cumsum(klens) - klens, klens
    )
    return data[rep + within].astype(np.int64)


def _pack_rows(total_chunks: int) -> int:
    """Pack length bucket (jit signatures include shapes)."""
    from fugu_tpu_torch.index.segment import _pow2_bucket

    return _pow2_bucket(max(total_chunks, 1) * BM_CHUNK)


def _evict_token_stream(seg: Segment, field: str) -> None:
    cache = getattr(seg, "_token_stream", None)
    if isinstance(cache, dict):
        cache.pop(field, None)


def get_token_stream(segment: Segment, field: str, stats, device) -> Optional[
    TokenStreamPack
]:
    """Cached per-field TokenStreamPack on ``device`` (rebuilt after
    deletes — keyed on the same df-sensitive stats fingerprint as
    Segment.block_major; residency-managed, so a cold field's stream can
    be evicted)."""
    from fugu_tpu_torch.ops import residency

    if field not in segment.pos_offsets:
        return None
    cache = getattr(segment, "_token_stream", None)
    if not isinstance(cache, dict):
        cache = {}
        object.__setattr__(segment, "_token_stream", cache)
    key = (stats.fingerprint, device)
    hit = cache.get(field)
    if hit is not None and hit[0] == key:
        residency.touch(("tok", id(segment), field))
        return hit[1]
    pack = TokenStreamPack(segment, field, stats, device)
    if not pack.ok:
        return None
    cache[field] = (key, pack)
    # same reserve()->cache window as Segment.device_pack: a concurrent
    # reserve may have evicted this key in between — don't re-cache an
    # unaccounted pack (the local reference stays valid for this call)
    if not residency.contains(("tok", id(segment), field)):
        cache.pop(field, None)
    return pack


# --------------------------------------------------------------------------
# kernel
# --------------------------------------------------------------------------


#: union slots a dispatch group may use (the top PU_BUCKETS rung); the
#: kernel keeps one query mask per slot, and both versions treat a slot
#: outside [0, U_MAX) as no slot
U_MAX = PU_BUCKETS[-1]
#: queries per kernel thread block (one bit of a 64-bit mask each)
Q_TILE = 64

#: kernel launches (not plain-version calls) since process start
launches = 0

#: bounds of the plain version's working set: tf counters per block
#: range, and (anchor, query) pairs per step
_PLAIN_TF_ELEMS = 1 << 24
_PLAIN_PAIRS = 1 << 22


def _row_slots(rows, slot_of):
    """Union slot of each packed stream row: -1 when its term is not in
    the union, lies past the table (the sentinel row does) or has a slot
    outside [0, U_MAX)."""
    n_terms = slot_of.numel()
    tid = (rows & TID_MASK).to(torch.int64)
    s = slot_of[tid.clamp(max=n_terms - 1)]
    return torch.where((tid < n_terms) & (s >= 0) & (s < U_MAX), s, -1)


def phrase_stream_plain(offs, tok, cv, fid, qterm, qslop, wp, slot_of, smax):
    """Plain PyTorch version of the phrase kernel, same contract.

    ``offs`` i32[nb_pad + 1] chunk offsets per 512-doc block; ``tok``
    i32[>= offs[-1] * BM_CHUNK] packed rows (doc_local << 22 | tid);
    ``cv`` f32 and ``fid`` i32 [nb_pad * 1024]: each doc's BM25
    denominator constant and fieldnorm id at [block * 1024 + doc_local];
    ``qterm`` i32[b_pad, kmax] the union slot of each query's term j
    (-1: a dead slot, which always matches; a query whose slot 0 is -1
    matches nothing); ``qslop`` i32[b_pad] slops (clamped to [0,
    smax]); ``wp`` f32[b_pad] phrase weights; ``slot_of`` i32[n_terms]
    (n_terms >= 1) the union slot of each term id, -1 outside the
    union.  Requires kmax - 1 + smax <= KGAP.

    Returns (amax f32, acls i32), each [nb_pad, FINE_PER_BLOCK, b_pad]:
    per fine slice and query the max of ``wp * (tf / (tf + cv))`` over
    the docs with phrase tf > 0 (-inf if none), and the max class
    ``tf * 256 + 255 - fid`` over the docs at that max (-1 if none).
    It works by block range, joining each anchor row to the queries
    whose first term it holds, so its memory stays bounded on a whole
    corpus."""
    dev = tok.device
    nb_pad = offs.numel() - 1
    b_pad, kmax = qterm.shape
    neg = float(NEG_INF)
    amax = torch.full((nb_pad, FINE_PER_BLOCK, b_pad), neg, device=dev)
    acls = torch.full(
        (nb_pad, FINE_PER_BLOCK, b_pad), -1, dtype=torch.int32, device=dev
    )
    offs_h = offs.cpu().to(torch.int64)
    qterm = qterm.to(torch.int64)
    slop = qslop.to(torch.int64).clamp(0, smax)
    # queries grouped by the union slot of their first term
    first = qterm[:, 0]
    q_by_first = torch.nonzero((first >= 0) & (first < U_MAX)).squeeze(1)
    q_by_first = q_by_first[torch.argsort(first[q_by_first], stable=True)]
    n_first = torch.bincount(first[q_by_first], minlength=U_MAX)
    first0 = torch.cumsum(n_first, 0) - n_first
    doc_iota = torch.arange(BM_BLOCK_DOCS, device=dev)
    step = max(1, _PLAIN_TF_ELEMS // (BM_BLOCK_DOCS * b_pad))
    for b0 in range(0, nb_pad, step):
        b1 = min(b0 + step, nb_pad)
        c0, c1 = int(offs_h[b0]), int(offs_h[b1])
        rows = tok[c0 * BM_CHUNK : c1 * BM_CHUNK]
        slot = _row_slots(rows, slot_of)
        doc = (rows >> TID_BITS) & 0x3FF  # the row's logical shift
        col = torch.arange(rows.numel(), device=dev) % BM_CHUNK
        a = torch.nonzero(
            (slot >= 0) & (col < BM_CHUNK - KGAP) & (doc < BM_BLOCK_DOCS)
        ).squeeze(1)
        n_pairs = n_first[slot[a]]
        cum = torch.cumsum(n_pairs, 0)
        total = int(cum[-1]) if a.numel() else 0
        if total == 0:
            continue
        # each anchor's doc row in this range's [docs, b_pad] tf table
        blk = torch.searchsorted(
            offs_h[b0 : b1 + 1].to(dev), c0 + a // BM_CHUNK, right=True
        ) - 1
        arow = blk * BM_BLOCK_DOCS + doc[a]
        tf = torch.zeros(
            (b1 - b0) * BM_BLOCK_DOCS * b_pad, dtype=torch.int32, device=dev
        )
        marks = torch.arange(1, (total - 1) // _PLAIN_PAIRS + 1, device=dev)
        cuts = torch.searchsorted(cum, marks * _PLAIN_PAIRS).tolist()
        for i0, i1 in zip([0] + cuts, cuts + [a.numel()]):
            if i1 <= i0:
                continue
            cnt = n_pairs[i0:i1]
            row = torch.repeat_interleave(a[i0:i1], cnt)
            within = torch.arange(row.numel(), device=dev) - (
                torch.repeat_interleave(torch.cumsum(cnt, 0) - cnt, cnt)
            )
            q = q_by_first[
                torch.repeat_interleave(first0[slot[a[i0:i1]]], cnt) + within
            ]
            ok = torch.ones_like(q, dtype=torch.bool)
            for j in range(1, kmax):
                want = qterm[q, j]
                hit = want < 0
                for s in range(smax + 1):
                    hit |= (slot[row + j + s] == want) & (s <= slop[q])
                ok &= hit
            idx = torch.repeat_interleave(arow[i0:i1], cnt)[ok] * b_pad + q[ok]
            tf.index_add_(0, idx, torch.ones_like(idx, dtype=torch.int32))
        tf = tf.view(b1 - b0, BM_BLOCK_DOCS, b_pad)
        at = (
            torch.arange(b0, b1, device=dev)[:, None] * 1024 + doc_iota
        ).view(-1)
        cvb = cv[at].view(b1 - b0, BM_BLOCK_DOCS, 1)
        fidb = fid[at].view(b1 - b0, BM_BLOCK_DOCS, 1)
        tff = tf.to(torch.float32)
        matched = tf > 0
        res = torch.where(
            matched, wp.view(1, 1, -1) * (tff / (tff + cvb)), neg
        ).view(b1 - b0, FINE_PER_BLOCK, BM_FINE_DOCS, b_pad)
        cls = torch.where(matched, tf * 256 + (255 - fidb), -1).view(
            b1 - b0, FINE_PER_BLOCK, BM_FINE_DOCS, b_pad
        )
        fmax = res.amax(dim=2)
        amax[b0:b1] = fmax
        acls[b0:b1] = torch.where(res >= fmax[:, :, None, :], cls, -1).amax(
            dim=2
        )
    return amax, acls


def phrase_stream(offs, tok, cv, fid, qterm, qslop, wp, slot_of, smax):
    """The phrase kernel (``csrc/phrase.cu``); contract as
    :func:`phrase_stream_plain`, which runs instead for CPU tensors."""
    global launches
    if tok.device.type == "cpu":
        return phrase_stream_plain(
            offs, tok, cv, fid, qterm, qslop, wp, slot_of, smax
        )
    dev = tok.device
    for name, t, dtype in (
        ("offs", offs, torch.int32), ("tok", tok, torch.int32),
        ("cv", cv, torch.float32), ("fid", fid, torch.int32),
        ("qterm", qterm, torch.int32), ("qslop", qslop, torch.int32),
        ("wp", wp, torch.float32), ("slot_of", slot_of, torch.int32),
    ):
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(
                f"{name}: {t.dtype} on {t.device} (contiguous="
                f"{t.is_contiguous()}), want contiguous {dtype} on {dev}"
            )
    if qterm.dim() != 2:
        raise ValueError(f"qterm must be [b_pad, kmax], got {qterm.shape}")
    b_pad, kmax = qterm.shape
    nb_pad = offs.numel() - 1
    if b_pad % Q_TILE or not 1 <= kmax <= KMAX or not 0 <= smax <= MAX_SLOP:
        raise ValueError(f"b_pad={b_pad} kmax={kmax} smax={smax}")
    if kmax - 1 + smax > KGAP:
        raise ValueError(f"kmax {kmax} - 1 + smax {smax} exceeds KGAP")
    if qslop.numel() != b_pad or wp.numel() != b_pad:
        raise ValueError("qslop and wp need one entry per query")
    if min(cv.numel(), fid.numel()) < nb_pad * 1024 or slot_of.numel() < 1:
        raise ValueError("cv/fid shorter than nb_pad * 1024, or no slot_of")
    if nb_pad > 65535:  # the grid's y dimension: 33.5M docs
        raise ValueError(f"{nb_pad} blocks exceed the phrase grid")
    amax = torch.empty(
        (nb_pad, FINE_PER_BLOCK, b_pad), dtype=torch.float32, device=dev
    )
    acls = torch.empty_like(amax, dtype=torch.int32)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fugu_phrase(
            _ptr(offs), nb_pad, _ptr(tok), tok.numel(), _ptr(cv), _ptr(fid),
            _ptr(qterm), kmax, _ptr(qslop), smax, _ptr(wp), _ptr(slot_of),
            slot_of.numel(), b_pad, _ptr(amax), _ptr(acls),
            ctypes.c_void_p(stream),
        )
    cuda_build.check(err, "phrase launch")
    launches += 1
    return amax, acls


def _lib():
    lib = cuda_build.load("phrase")
    fn = lib.fugu_phrase
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        v, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [v, i, v, ll, v, v, v, i, v, i, v, v, i, i, v, v, v]
    return lib


# --------------------------------------------------------------------------
# staging + host phase B
# --------------------------------------------------------------------------


def eligible_clause(pc: PhraseClause) -> bool:
    """Whether one phrase clause fits the stream kernel: <= KMAX terms,
    slop <= MAX_SLOP, positive boost, and forward reach (n_terms - 1 +
    slop) <= KGAP — beyond KGAP a roll's wrapped rows land on
    anchor-eligible rows and the inter-doc sentinel gap no longer
    blocks cross-doc adjacency.  Sloppy dispatches additionally cap the
    kmax bucket at KGAP + 1 - MAX_SLOP (= 7 terms at slop > 0)."""
    if not pc.terms or len(pc.terms) > KMAX:
        return False
    slop = max(int(getattr(pc, "slop", 0) or 0), 0)
    if slop > MAX_SLOP:
        return False
    if slop and len(pc.terms) > KGAP + 1 - MAX_SLOP:
        return False
    if len(pc.terms) - 1 + slop > KGAP:
        return False
    if pc.boost <= 0.0:
        return False
    return True


def eligible_phrase(plan: QueryPlan) -> Optional[PhraseClause]:
    """The plan's phrase when the stream engine can serve it: ONE
    single-phrase SHOULD/MUST group (the quoted-query shape), slop <=
    MAX_SLOP (r5 — was slop 0), <= KMAX terms, default k1/b, positive
    boost.  Else None."""
    from fugu_tpu_torch.query import B as B_CONST, K1

    if plan.match_all or plan.has_range or plan.has_subplan:
        return None
    if plan.k1 != float(K1) or plan.b != float(B_CONST):
        return None
    if len(plan.groups) != 1:
        return None
    g = plan.groups[0]
    if g.occur is Occur.MUST_NOT or g.clauses or g.ranges:
        return None
    if g.subplan is not None or len(g.phrases) != 1:
        return None
    pc = g.phrases[0]
    if not eligible_clause(pc):
        return None
    return pc


def phrase_stream_begin(
    segment: Segment,
    plans: Sequence[QueryPlan],
    stats,
    limits: Sequence[int],
    device: torch.device,
):
    """Stage and dispatch the phrase batch on ``device``; returns a
    handle for :func:`phrase_stream_collect`.  ``pre`` (handle[0])
    carries results resolved without the kernel ([] for absent terms)
    aligned to ``plans``; ``staged`` entries are (plan_index, clause)
    pairs the kernel will answer; non-eligible plans stay None
    throughout.  On the CPU every batch streams; on a GPU a field's
    batch needs PHRASE_MIN_BATCH phrases."""
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

    min_batch = 1 if device.type == "cpu" else PHRASE_MIN_BATCH
    dispatches = []
    for field, idxs in sorted(by_field.items()):
        pack = get_token_stream(segment, field, stats, device)
        if pack is None:
            continue
        # absent terms can't match anything in this segment
        run = []
        for i in idxs:
            if any(t not in pack.tid_of for t in clauses[i].terms):
                pre[i] = []
            else:
                run.append(i)
        if len(run) < min_batch:
            for i in run:
                del clauses[i]  # host path serves these
            continue
        for q_idx, smax in split_dispatch_groups(run, clauses):
            dispatches.append(
                _dispatch_group(pack, q_idx, clauses, stats, smax)
            )
            for i in q_idx:
                staged.append((i, clauses[i]))
    return (pre, staged, dispatches, segment, stats, list(limits))


def _clause_slop(pc: PhraseClause) -> int:
    return max(int(getattr(pc, "slop", 0) or 0), 0)


def split_dispatch_groups(run, clauses) -> List[Tuple[List[int], int]]:
    """[(q_idx, smax)] dispatch groups for ``run`` (eligible plan
    indices, in order) — shared by the single-chip and sharded begins.

    slop-0 and sloppy queries dispatch separately: the sloppy program
    (smax=MAX_SLOP) pays (slop+1)x one-hot/matmul work per slot and
    compiles a different signature — keeping slop-0 batches on the
    round-4 program preserves both its speed and its warm compile
    cache.  Each sub-run pays its own sweep; a mixed batch therefore
    costs up to two sweeps (measured tradeoff vs 3x-ing the common
    slop-0 case: slop-0 wins).  Within a sub-run, split greedily when
    the union exceeds the largest U bucket (one usable slot is reserved
    for the ALWAYS-ONE column)."""
    out: List[Tuple[List[int], int]] = []
    subruns = [
        ([i for i in run if not _clause_slop(clauses[i])], 0),
        ([i for i in run if _clause_slop(clauses[i])], MAX_SLOP),
    ]
    for sub, smax in subruns:
        groups: List[List[int]] = []
        cur: List[int] = []
        cur_terms: set = set()
        for i in sub:
            ts = set(clauses[i].terms)
            new = ts - cur_terms
            if cur and (
                len(cur) >= PB_BUCKETS[-1]
                or len(cur_terms) + len(new) > PU_BUCKETS[-1] - 1
            ):
                groups.append(cur)
                cur, cur_terms = [], set()
            cur_terms |= ts
            cur.append(i)
        if cur:
            groups.append(cur)
        out.extend((g, smax) for g in groups)
    return out


def stage_group(tid_of, n_terms, q_idx, clauses, stats, smax):
    """(qterm, qslop, wp, slot_of, u_pad, b_pad, kmax) kernel operands
    for one dispatch group, shared by the kernel and its plain version.

    The compact counterpart of the reference's ``stage_group_weights``
    (bf16 weight planes for one-hot matmuls): ``qterm`` [b_pad, kmax]
    holds the union slot of each query's terms (-1 past its length: a
    dead slot, which always matches; padding queries match nothing),
    ``qslop`` each slop clamped to the group's smax, ``wp`` each phrase
    weight, and ``slot_of`` [n_terms] each term id's union slot.  The
    bucket ladders are the reference's (one union slot stays free, where
    the reference keeps its ALWAYS-ONE column), so dispatch groups and
    output shapes match it, and the union never outgrows the kernel's
    U_MAX slots."""
    terms: Dict[str, int] = {}
    kmax_need = 1
    for i in q_idx:
        for t in clauses[i].terms:
            if t not in terms:
                terms[t] = len(terms)
        kmax_need = max(kmax_need, len(clauses[i].terms))
    u_pad = next(u for u in PU_BUCKETS if len(terms) + 1 <= u)
    b_pad = next(b for b in PB_BUCKETS if len(q_idx) <= b)
    kb = PK_SLOP_BUCKETS if smax else PK_BUCKETS
    kmax = next(k for k in kb if kmax_need <= k)

    qterm = np.full((b_pad, kmax), -1, dtype=np.int32)
    qslop = np.zeros(b_pad, dtype=np.int32)
    wp = np.zeros(b_pad, dtype=np.float32)
    slot_of = np.full(max(n_terms, 1), -1, dtype=np.int32)
    for t, slot in terms.items():
        slot_of[tid_of[t]] = slot
    for qi, i in enumerate(q_idx):
        pc = clauses[i]
        qterm[qi, : len(pc.terms)] = [terms[t] for t in pc.terms]
        qslop[qi] = min(_clause_slop(pc), smax)
        dfs = [stats.doc_freq(pc.field, t) for t in pc.terms]
        wp[qi] = float(bm25_weight(max(dfs), stats.doc_count, pc.boost))
    return qterm, qslop, wp, slot_of, u_pad, b_pad, kmax


def _dispatch_group(pack, q_idx, clauses, stats, smax=0):
    """Stage operands and launch kernel + postproc for one group (both
    run asynchronously on the device's current stream)."""
    qterm, qslop, wp, slot_of, _u, b_pad, _k = stage_group(
        pack.tid_of, pack.n_terms, q_idx, clauses, stats, smax
    )
    dev = pack.d_tok.device
    amax, acls = phrase_stream(
        pack.d_offs, pack.d_tok, pack.d_cv, pack.d_fid,
        *(torch.from_numpy(a).to(dev) for a in (qterm, qslop, wp, slot_of)),
        smax,
    )
    return (q_idx, phrase_post(amax, acls), b_pad)


#: fine blocks whose (value, class, id) the phrase postprocessor ships
#: per query, sorted by bound descending.  64 covers limit<=10 scans by
#: a wide margin (ties terminate via the doc-id rule after ~limit hits)
#: while keeping the fetched buffer small — 256 was measured spending
#: 262ms of a 785ms batch just crossing the relay.  Queries whose scan
#: is inconclusive within the shipped blocks fall back to a
#: full-common match (correct, rare).
PHRASE_TOPK = 64


def phrase_post(amax, acls):
    """Postproc of one dispatch: per query the top-K fine blocks by
    maxima (achievable scores!), their EXACT integer (tf, fid) classes,
    ids, and the finite count — the host recomputes each block's bound
    bit-exactly from the class with its own float arithmetic and scans
    in bound order with margin-free termination.

    One f32 buffer [b_pad, 3k + 1] (ids and classes < 2^24 stay
    f32-exact), so the host fetches once per dispatch.  Equal maxima
    keep the LOWEST block ids, as XLA's ``top_k`` does (``torch.topk``
    alone promises no order among ties): ``_rescore_blocks`` relies on
    it to skip unshipped ties."""
    nb2 = amax.shape[0] * amax.shape[1]
    k = min(PHRASE_TOPK, nb2)
    col = amax.reshape(nb2, -1).T                       # [B, NB*F]
    ccol = acls.reshape(nb2, -1).T                      # [B, NB*F] i32
    count = torch.isfinite(col).sum(dim=1, dtype=torch.int32)
    ids = torch.arange(nb2, device=col.device).expand_as(col)
    idx = torch.topk(_order_keys(col, ids), k, dim=1).indices   # [B, k]
    return torch.cat(
        [
            torch.gather(col, 1, idx),
            idx.to(torch.float32),
            torch.gather(ccol, 1, idx).to(torch.float32),
            count[:, None].to(torch.float32),
        ],
        dim=1,
    )


def phrase_stream_collect(handle):
    """Finish the batch: fetch per-query ordered block bounds (one copy
    per dispatch), then host-match in bound order with early
    termination.  Returns a list aligned with the plans given to begin
    (None = not served here)."""
    pre, staged, dispatches, segment, stats, limits = handle
    results = list(pre)
    if not dispatches:
        return results

    bufs = [buf.cpu().numpy() for _q, buf, _b in dispatches]

    clause_of = dict(staged)
    nb = max((segment.doc_count + BM_BLOCK_DOCS - 1) // BM_BLOCK_DOCS, 1)
    nb2 = nb * FINE_PER_BLOCK
    for (q_idx, _a, _b), buf in zip(dispatches, bufs):
        k = (buf.shape[1] - 1) // 3
        for qi, i in enumerate(q_idx):
            row = buf[qi]
            count = int(row[-1])
            if count == 0:
                results[i] = []
                continue
            ids = row[k : 2 * k].astype(np.int64)
            cls = row[2 * k : 3 * k].astype(np.int64)
            take = min(count, k)
            # padded-block entries (id >= nb2) carry NEG_INF and sort
            # after every finite bound; trim alongside the finite count
            keep = ids[:take] < nb2
            results[i] = _rescore_blocks(
                segment,
                clause_of[i],
                stats,
                ids[:take][keep],
                cls[:take][keep],
                count > k,
                limits[i],
            )
    return results


#: relative guard band for device-argmax class flips: the kernel picks
#: each block's class by device-f32 score, whose rounding differs from
#: the host's by a few ulp (~1e-7 rel) — any block whose exact bound
#: sits within this band of the kth must be visited (or trigger the
#: fallback), making the pruning airtight without a bf16-sized margin
_CLS_GUARD = 1e-6


def _rescore_blocks(
    segment, pc, stats, fine_ids, classes, truncated, limit,
    lo_table=None, hi_table=None,
):
    """Exact host top-k over candidate fine blocks in descending-bound
    order with margin-free early termination.

    ``lo_table``/``hi_table`` (optional): per-fine-id doc windows for
    callers whose id space is not the plain ``id * BM_FINE_DOCS``
    layout — the sharded engine maps global padded fine ids onto
    per-shard doc ranges (clamped at shard bounds so windows never
    overlap a neighbour shard's block 0).  Tables must be monotone
    non-decreasing in id (id order == doc order), which the shard
    layout guarantees.

    ``classes`` are the kernel's per-block INTEGER (tf << 8 | 255-fid)
    classes of the score-argmax doc; the host recomputes each bound
    with the same np.float32 expression as final scoring, so
    bound-vs-kth comparisons are exact.  Ties (bound == kth) use the
    doc-id rule: blocks are doc-ranges in id order, so a tied block
    whose range starts at or past the current limit-th holder's doc id
    cannot displace it (doc-ascending tie-break).  Candidate matching
    runs through ops/phrase.match_ranges — windowed posting lookups,
    no full intersection — so host work scales with limit, not df."""
    from fugu_tpu_torch.ops.phrase import match_ranges

    if len(fine_ids) == 0:
        return []
    dfs = [stats.doc_freq(pc.field, t) for t in pc.terms]
    if max(dfs) == 0:
        return []
    w = np.float32(bm25_weight(max(dfs), stats.doc_count, pc.boost))
    cache = fieldnorm_cache(stats.avg_fieldnorm(pc.field))
    fid_all = segment.fieldnorm_ids[pc.field]

    tf_c = (classes >> 8).astype(np.float32)
    fid_c = (255 - (classes & 255)).astype(np.int64)
    bounds = (w * (tf_c / (tf_c + cache[fid_c]))).astype(np.float32)

    order = np.lexsort((fine_ids, -bounds))
    ids_o = fine_ids[order]
    bnd_o = bounds[order]

    def lo_of(ids):
        if lo_table is None:
            return ids * BM_FINE_DOCS
        return lo_table[ids]

    def hi_of(ids):
        if hi_table is None:
            return ids * BM_FINE_DOCS + BM_FINE_DOCS
        return hi_table[ids]

    hits_docs: List[np.ndarray] = []
    hits_scores: List[np.ndarray] = []
    n_hits = 0
    kth = None        # limit-th best score so far
    worst_doc = None  # its doc id (ties displace only below this)

    remaining = np.arange(len(ids_o))
    group = 8
    while len(remaining):
        if kth is not None:
            b = bnd_o[remaining]
            keep = (
                (b > kth)
                | ((b == kth) & (lo_of(ids_o[remaining]) < worst_doc))
                | ((b < kth) & (kth - b <= abs(kth) * _CLS_GUARD))
            )
            remaining = remaining[keep]
            if not len(remaining):
                break
        chunk, remaining = remaining[:group], remaining[group:]
        sel = np.sort(ids_o[chunk])
        docs, ptf = match_ranges(segment, pc, lo_of(sel), hi_of(sel))
        if len(docs):
            ptf_f = ptf.astype(np.float32)
            fids = fid_all[docs].astype(np.int64)
            scores = w * (ptf_f / (ptf_f + cache[fids]))
            hits_docs.append(docs.astype(np.int64))
            hits_scores.append(scores)
            n_hits += len(docs)
            if n_hits >= limit:
                alls = np.concatenate(hits_scores)
                alld = np.concatenate(hits_docs)
                top = np.lexsort((alld, -alls))[:limit]
                kth = float(alls[top[-1]])
                worst_doc = int(alld[top[-1]])
        group = min(group * 4, 1024)

    need_fallback = truncated
    if need_fallback and kth is not None and len(bnd_o):
        b_min = float(bnd_o[-1])
        if b_min < kth - abs(kth) * _CLS_GUARD:
            # every unshipped block's true bound sits below kth with
            # margin to spare (device ordering is within ~1e-7)
            need_fallback = False
        elif b_min == kth and worst_doc is not None:
            # unshipped ties: same-class blocks share the same device
            # value, and top_k keeps the lowest ids, so every unshipped
            # tied block starts past the shipped ones — skippable iff
            # even the next id couldn't reach worst_doc AND no OTHER
            # class collides with kth (a colliding class's blocks may
            # order differently in device f32)
            tied = ids_o[bnd_o == b_min]
            next_id = int(tied.max()) + 1
            if lo_table is None:
                next_lo = next_id * BM_FINE_DOCS
            elif next_id < len(lo_table):
                next_lo = int(lo_table[next_id])
            else:
                next_lo = segment.doc_count
            if next_lo >= worst_doc and not _class_collides(kth, w, cache):
                need_fallback = False

    if need_fallback:
        # exact, slow path: match the full intersection
        from fugu_tpu_torch.ops.phrase import PhraseMatcher

        matcher = PhraseMatcher(segment, pc)
        if not matcher.ok or len(matcher.common) == 0:
            return []
        docs, ptf = matcher.match(
            np.arange(len(matcher.common), dtype=np.int64)
        )
        if len(docs) == 0:
            return []
        ptf_f = ptf.astype(np.float32)
        fids = fid_all[docs].astype(np.int64)
        scores = w * (ptf_f / (ptf_f + cache[fids]))
        order2 = np.lexsort((docs, -scores))[:limit]
        return [(float(scores[o]), int(docs[o])) for o in order2]

    if not hits_docs:
        return []
    docs = np.concatenate(hits_docs)
    scores = np.concatenate(hits_scores)
    order2 = np.lexsort((docs, -scores))[:limit]
    return [(float(scores[o]), int(docs[o])) for o in order2]


def _class_collides(kth: float, w, cache) -> bool:
    """True when MORE THAN ONE (tf, fid) class scores exactly ``kth``
    — then device-f32 ordering between the colliding classes is not
    guaranteed to match the host tie order and the unshipped-ties skip
    is unsafe.  Per fid, the candidate tf solves kth = w*tf/(tf+cv)
    analytically; only its integer neighbours can produce the exact f32
    value, so the check is ~256 x 4 score evaluations."""
    w64 = float(np.float32(w))
    if not (0.0 < kth < w64):
        return True  # degenerate; be conservative
    cv = cache.astype(np.float64)
    t_est = kth * cv / (w64 - kth)
    hits = 0
    for delta in (-1.0, 0.0, 1.0, 2.0):
        tf = np.floor(t_est) + delta
        ok = tf >= 1.0
        tf32 = tf.astype(np.float32)
        sc = np.float32(w) * (tf32 / (tf32 + cache))
        hits += int(((sc == np.float32(kth)) & ok).sum())
        if hits > 1:
            return True
    return hits > 1


def batch_phrase_search(
    segment: Segment,
    plans: Sequence[QueryPlan],
    stats,
    limits: Sequence[int],
    device: torch.device,
) -> List[Optional[List[Tuple[float, int]]]]:
    """Synchronous begin+collect (None entries = caller's host path)."""
    return phrase_stream_collect(
        phrase_stream_begin(segment, plans, stats, limits, device)
    )
