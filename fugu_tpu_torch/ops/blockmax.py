"""Block-max pruned host scorer — the strengthened CPU baseline.

The round-1 baseline was the naive oracle: a full postings traversal per
query.  Tantivy (what the reference actually executes,
upstream `src/db/search.rs:153-162`) skips most postings for
top-k queries via block-max WAND, so the naive oracle understates the
reference and overstates our speedup (VERDICT r1 missing #1).  This is
the strongest single-core host stand-in we can build honestly:

- index-time (amortized, like Tantivy's skip lists): one pass computes
  every entry's exact BM25 contribution w_t * tf/(tf + cache[fid]) —
  query-independent at default k1/b/boost — plus per-(term, block) max
  contributions (np.maximum.reduceat per posting range).
- query-time: per-block upper bound = sum of the clause block-maxes
  (MUST groups prune blocks where any group is absent), blocks visited
  in descending bound order, and the loop stops as soon as the bound
  cannot beat the current kth score — exact top-k, WAND-style skipping.

Results are bit-identical to the naive oracle's (same f32 contribution
values, same tie ordering).  Also usable as a fast host fallback path.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from fugu_tpu_torch.index.segment import FACET_FIELD_KEY, Segment
from fugu_tpu_torch.ops.oracle import IndexStats
from fugu_tpu_torch.query import (
    Occur,
    QueryPlan,
    bm25_weight,
    fieldnorm_cache,
    idf,
)

BM_BLOCK = 4096


class BlockMaxIndex:
    """Per-segment skip structure: exact per-entry contributions + sparse
    per-(term, block) maxima.  Built once (default k1/b only), cached on
    the segment."""

    def __init__(self, segment: Segment, stats: IndexStats, k1: float, b: float):
        self.segment = segment
        self.k1 = float(k1)
        self.b = float(b)
        self.n_blocks = max((segment.doc_count + BM_BLOCK - 1) // BM_BLOCK, 1)
        e = segment.n_entries
        self.contrib = np.zeros(e, dtype=np.float32)
        #: per-term sparse block tables: (start,len) -> (block_ids, maxima,
        #: entry offsets of each block's subrange)
        self._term_blocks: Dict[Tuple[int, int], tuple] = {}

        # NOTE: no whole-array astype copies here — tf/fid are only ever
        # used as per-field slices below, and at 8-16M docs a transient
        # f32+int64 copy of every entry is multi-GB held for the whole
        # build (which reruns on every stats-fingerprint change)
        docs = segment.e_doc[:e]
        tfs = segment.e_tf
        fids = segment.e_fid
        for field, tmap in segment.terms.items():
            if not tmap:
                continue
            terms = list(tmap.keys())
            starts = np.array([tmap[t].start for t in terms], dtype=np.int64)
            # INDEX-WIDE doc frequencies, not segment-local: idf must
            # match what the oracle/device engines score with once the
            # index has more than one segment
            if field == FACET_FIELD_KEY:
                dfs = np.array(
                    [stats.facet_doc_freq(t) for t in terms], dtype=np.int64
                )
            else:
                dfs = np.array(
                    [stats.doc_freq(field, t) for t in terms], dtype=np.int64
                )
            seg_dfs = np.array(
                [tmap[t].doc_freq for t in terms], dtype=np.int64
            )
            if field == FACET_FIELD_KEY:
                w = np.array(
                    [idf(int(d), stats.doc_count) for d in dfs], dtype=np.float32
                )
                lo = int(starts.min()) if len(starts) else 0
                hi = int((starts + seg_dfs).max()) if len(starts) else 0
                order = np.argsort(starts)
                # repeat by the SEGMENT-LOCAL run lengths (entry layout);
                # only the weight uses index-wide df
                w_entry = np.repeat(w[order], seg_dfs[order])
                self.contrib[lo:hi] = w_entry
            else:
                cache = fieldnorm_cache(stats.avg_fieldnorm(field), k1, b)
                w = np.array(
                    [
                        bm25_weight(int(d), stats.doc_count, 1.0, k1)
                        for d in dfs
                    ],
                    dtype=np.float32,
                )
                order = np.argsort(starts)
                lo = int(starts.min()) if len(starts) else 0
                hi = int((starts + seg_dfs).max()) if len(starts) else 0
                w_entry = np.repeat(w[order], seg_dfs[order])
                tf_slice = tfs[lo:hi].astype(np.float32)
                self.contrib[lo:hi] = w_entry * (
                    tf_slice / (tf_slice + cache[fids[lo:hi]])
                )

        self._docs = docs

    def term_blocks(self, start: int, length: int):
        """(block_ids, block_max, offsets) for one posting range; offsets
        partition [start, start+length) by block (len = nblocks+1)."""
        key = (start, length)
        got = self._term_blocks.get(key)
        if got is None:
            d = self._docs[start : start + length]
            blocks = (d // BM_BLOCK).astype(np.int64)
            # boundaries of distinct blocks within the (doc-sorted) range
            change = np.nonzero(np.diff(blocks))[0] + 1
            bounds = np.concatenate(([0], change, [length]))
            ids = blocks[bounds[:-1]]
            maxima = np.maximum.reduceat(
                self.contrib[start : start + length], bounds[:-1]
            )
            got = (ids, maxima.astype(np.float32), bounds + start)
            self._term_blocks[key] = got
        return got


def relaxed(k):
    """Ulp-margin pruning threshold: bounds are computed on a different
    f32 rounding path than exact scores, so a strict `< kth` compare
    could prune a doc that ties or beats the kth score.  Shared by the
    block-max and phrase pruning loops — one definition, one margin."""
    return k - abs(k) * np.float32(1e-6) - np.float32(1e-12)


def get_blockmax(segment: Segment, stats: IndexStats, k1: float, b: float):
    """Segment-cached BlockMaxIndex.

    The cache key is the INDEX-WIDE stats fingerprint, not just (k1, b):
    contributions bake in per-term idf(df, doc_count) and the average
    fieldnorm, all of which change when other segments are ingested,
    deleted from, or merged — a stale cache would silently score this
    segment with outdated statistics (same scheme as
    Segment.block_major).  The fingerprint is df-sensitive (segment
    identities + tombstone counts), so churn that preserves doc_count
    and total_tokens while moving a term's df still invalidates."""
    key = (stats.fingerprint, k1, b)
    cached = getattr(segment, "_blockmax", None)
    if cached is not None and getattr(cached, "cache_key", None) == key:
        return cached
    bm = BlockMaxIndex(segment, stats, k1, b)
    bm.cache_key = key
    object.__setattr__(segment, "_blockmax", bm)
    return bm


def _stage(segment: Segment, plan: QueryPlan, stats: IndexStats):
    """[(start, len, boost, group_bit)] per clause + boolean masks, or
    None when the plan needs the full oracle (phrases/ranges/subplans/
    custom boosts change the precomputed contributions)."""
    if plan.host_only:
        return None
    must = mustnot = should = 0
    clauses = []
    if len(plan.groups) > 62:
        return None
    for gi, group in enumerate(plan.groups):
        bit = 1 << gi
        if group.occur is Occur.MUST:
            must |= bit
        elif group.occur is Occur.MUST_NOT:
            mustnot |= bit
        else:
            should |= bit
        for c in group.clauses:
            if c.boost != 1.0:
                return None  # contributions precomputed at boost=1
            field = FACET_FIELD_KEY if c.is_facet else c.field
            info = segment.term_info(field, c.term)
            df = (
                stats.facet_doc_freq(c.term)
                if c.is_facet
                else stats.doc_freq(c.field, c.term)
            )
            if df == 0 or info is None:
                clauses.append((0, 0, bit))
                continue
            clauses.append((info.start, info.doc_freq, bit))
    if must and not plan.require_should:
        should = 0
    return clauses, must, mustnot, should


def search_blockmax(
    segment: Segment,
    plan: QueryPlan,
    stats: IndexStats,
    limit: int,
) -> Optional[List[Tuple[float, int]]]:
    """Exact top-`limit` [(score, doc)] via block-max pruning, or None
    (caller falls back to the full oracle)."""
    from fugu_tpu_torch.query import B as B_CONST, K1

    # same default-constants gate as batch_scorer._classify: contribs
    # are precomputed at the index defaults
    if plan.k1 != float(K1) or plan.b != float(B_CONST):
        return None
    if plan.has_phrase:
        # doc-level pruned phrase path (ops/phrase.py) for the pure
        # single-phrase shape; mixed phrase/term/facet boolean plans
        # take the generalized block-WAND engine (ops/mixed.py, r5);
        # None from both keeps the caller's oracle fallback
        from fugu_tpu_torch.ops.mixed import search_mixed_topk
        from fugu_tpu_torch.ops.phrase import search_phrase_topk

        r = search_phrase_topk(segment, plan, stats, limit)
        if r is None:
            r = search_mixed_topk(segment, plan, stats, limit)
        return r
    staged = _stage(segment, plan, stats)
    if staged is None:
        return None
    clauses, must, mustnot, should = staged
    if not must and not should:
        return []  # nothing can match (only exclusions)
    live = [c for c in clauses if c[1] > 0]
    if not live:
        return []
    bm = get_blockmax(segment, stats, plan.k1, plan.b)
    nb = bm.n_blocks

    # per-block upper bound = sum of positive clause block maxima;
    # MUST pruning: a block missing every clause of a MUST group is out
    ub = np.zeros(nb, dtype=np.float64)
    present: Dict[int, np.ndarray] = {}
    term_tabs = []
    for start, length, bit in clauses:
        if length == 0:
            if must & bit and bit not in present:
                present[bit] = np.zeros(nb, dtype=bool)
            continue
        ids, maxima, bounds = bm.term_blocks(start, length)
        term_tabs.append((start, length, bit, ids, bounds))
        if not (mustnot & bit):
            # clamped at 0 (r5): with tombstone-inflated df a clause's
            # idf — and so its block maxima — can go negative; a doc
            # matching OTHER clauses but not this one would then sit
            # above the block's summed bound and be wrongly pruned
            np.add.at(
                ub, ids, np.maximum(maxima.astype(np.float64), 0.0)
            )
        if must & bit:
            p = present.setdefault(bit, np.zeros(nb, dtype=bool))
            p[ids] = True
    for bit, p in present.items():
        ub[~p] = -np.inf

    order = np.argsort(-ub)
    tomb = segment.tombstones
    # the traversal accumulates clause contributions in FLAT clause
    # order, while the exact (oracle/Tantivy) score nests per-group
    # sums — identical math, ulp-different rounding for docs matching
    # >=3 clauses across >=2 groups.  So: select with an ulp-margin
    # threshold into a padded running set, then rescore the survivors
    # with the oracle-exact float sequence (ops/rescore) and truncate.
    pad = limit + 8
    top_scores = np.full(pad, -np.inf, dtype=np.float32)
    top_docs = np.full(pad, 2**31 - 1, dtype=np.int64)
    kth = -np.inf

    scores = np.zeros(BM_BLOCK, dtype=np.float32)
    bits = np.zeros(BM_BLOCK, dtype=np.int64)
    for blk in order:
        bound = ub[blk]
        # strict <: a block whose bound equals kth can still contain an
        # equal-score doc with a lower id, which the tiebreak must keep
        if not np.isfinite(bound) or bound < relaxed(kth):
            break
        base = blk * BM_BLOCK
        scores[:] = 0.0
        bits[:] = 0
        # slice each clause's entries for this block; MUST_NOT clauses
        # contribute only their presence bit, never score
        for start, length, bit, ids, bounds in term_tabs:
            j = np.searchsorted(ids, blk)
            if j >= len(ids) or ids[j] != blk:
                continue
            s, e = bounds[j], bounds[j + 1]
            local = bm._docs[s:e] - base
            if not (mustnot & bit):
                scores[local] += bm.contrib[s:e]
            bits[local] |= bit
        ok = np.ones(BM_BLOCK, dtype=bool)
        if must:
            ok &= (bits & must) == must
        if mustnot:
            ok &= (bits & mustnot) == 0
        if should:
            ok &= (bits & should) != 0
        n_here = min(BM_BLOCK, segment.doc_count - base)
        ok[n_here:] = False
        ok[:n_here] &= ~tomb[base : base + n_here]
        cand = np.nonzero(ok & (scores >= relaxed(kth)))[0]
        if len(cand) == 0:
            continue
        cs = scores[cand]
        if len(cand) > pad:
            # keep kth ties so the lexsort's doc-asc tiebreak stays exact
            part = np.argpartition(-cs, pad - 1)
            kth_v = cs[part[pad - 1]]
            keep2 = cs >= relaxed(kth_v)
            cand, cs = cand[keep2], cs[keep2]
        # merge into the padded running top set (score desc, doc asc)
        all_s = np.concatenate([top_scores, cs])
        all_d = np.concatenate([top_docs, cand + base])
        sel = np.lexsort((all_d, -all_s))[:pad]
        top_scores, top_docs = all_s[sel], all_d[sel]
        # the pruning threshold is the LIMIT-th best (not pad-th): the
        # pad slots only hold ulp-margin boundary candidates
        kth = (
            top_scores[limit - 1]
            if np.isfinite(top_scores[limit - 1])
            else -np.inf
        )

    from fugu_tpu_torch.ops.rescore import rescore_hits

    keep = np.isfinite(top_scores)
    hits = [(float(s), int(d)) for s, d in zip(top_scores[keep], top_docs[keep])]
    return rescore_hits(segment, plan, stats, hits)[:limit]
