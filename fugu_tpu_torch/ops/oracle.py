"""NumPy oracle: scalar-faithful BM25 + boolean + top-k reference.

This is the ground truth the device kernels are tested against (SURVEY.md
§4 test plan: "kernel tests vs NumPy oracle ... plus bit-for-bit
BM25-ordering parity vs a Tantivy-equivalent scalar oracle").  It
implements exactly what Tantivy executes for the reference's search path
(upstream `src/db/search.rs:153-162`):

- per-(field,term) weight  = idf(df, N) * (k1+1) * boost      (f32)
- per-(doc)      component = tf / (tf + cache[fieldnorm_id])  (f32)
- document score = sum over all matching clauses of weight * component
- boolean semantics: MUST all present, MUST_NOT none present, and at
  least one SHOULD when no MUST exists
- top-k ordered by score desc, ties by (segment_ord, doc id) asc
- facet clauses score a constant idf (facet fields carry no fieldnorms)

Also used as the fallback execution path for query shapes the device
pipeline does not take (phrase queries resolve their postings here).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from fugu_tpu_torch.index.segment import FACET_FIELD_KEY, Segment
from fugu_tpu_torch.query import (
    Occur,
    PhraseClause,
    QueryPlan,
    bm25_weight,
    fieldnorm_cache,
    idf,
)


@dataclasses.dataclass(frozen=True)
class Hit:
    score: float
    segment_ord: int
    doc: int


_SEG_UID = itertools.count(1)


def _seg_uid(s: Segment) -> int:
    """Process-unique id for unsaved segments.  ``id(s)`` is NOT safe
    here: CPython reuses addresses after GC, so two different in-memory
    segments with equal doc/tombstone counts could collide and serve
    stale df-sensitive score caches.  A monotonic counter, stamped once
    per object, never recurs."""
    uid = getattr(s, "_fp_uid", None)
    if uid is None:
        uid = next(_SEG_UID)
        object.__setattr__(s, "_fp_uid", uid)
    return uid


class IndexStats:
    """Searcher-wide statistics across a list of segments."""

    def __init__(self, segments: Sequence[Segment]):
        self.segments = list(segments)
        # live docs (Tantivy Searcher::num_docs excludes deletes)
        self.doc_count = sum(s.num_live_docs for s in segments)
        self.total_tokens: Dict[str, int] = {}
        for s in segments:
            for field, n in s.total_tokens.items():
                self.total_tokens[field] = self.total_tokens.get(field, 0) + n
        #: df-sensitive cache fingerprint: per-term index-wide doc
        #: frequencies are baked into every derived score/bound structure
        #: (BlockMaxIndex contribs, BlockMajorPack), and (doc_count,
        #: total_tokens) alone can collide across churn that changes a
        #: term's df (e.g. offsetting upserts with identical token
        #: counts).  Segment ids are fresh per freeze/merge and tombstone
        #: counts only grow, so this tuple changes on ANY ingest, delete,
        #: or merge that could move a df.
        self.fingerprint = tuple(
            (s.segment_id or f"@{_seg_uid(s)}", s.doc_count,
             int(s.tombstones.sum()))
            for s in self.segments
        )
        self._df_memo: Dict[Tuple[str, str], int] = {}

    def doc_freq(self, field: str, term: str) -> int:
        # memoized: the segment list is an immutable snapshot, and every
        # per-segment consumer (score_segment, stage_clauses, ...) would
        # otherwise re-sum all S segments — O(S^2) per clause per query
        key = (field, term)
        df = self._df_memo.get(key)
        if df is None:
            df = sum(s.doc_freq(field, term) for s in self.segments)
            self._df_memo[key] = df
        return df

    def avg_fieldnorm(self, field: str) -> float:
        if self.doc_count == 0:
            return 1.0
        return self.total_tokens.get(field, 0) / self.doc_count

    def facet_doc_freq(self, path: str) -> int:
        return self.doc_freq(FACET_FIELD_KEY, path)


#: encoded (doc, position) keys: doc * POS_SHIFT + pos.  Positions stay
#: < 2^20 (text <= 10k chars, object.rs:44-46, plus bounded field gaps).
_POS_SHIFT = np.int64(1) << 20


def _ragged_gather(data: np.ndarray, starts: np.ndarray, lens: np.ndarray):
    """Concatenate data[starts[j]:starts[j]+lens[j]] for all j — one
    vectorized gather (the repeat/cumsum idiom), no Python loop."""
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, dtype=data.dtype)
    rep = np.repeat(starts, lens)
    within = np.arange(total, dtype=np.int64) - np.repeat(
        np.cumsum(lens) - lens, lens
    )
    return data[rep + within]


def phrase_postings(
    segment: Segment, clause: PhraseClause
) -> Tuple[np.ndarray, np.ndarray]:
    """(docs, phrase_tf) for a phrase within one segment — vectorized.

    A doc matches when the clause terms occur at consecutive positions —
    Tantivy PhraseQuery semantics; phrase_tf is the number of such
    occurrences and feeds the BM25 tf component.  The whole match runs as
    array ops: intersect the doc lists (keeping per-term entry indices),
    gather each term's positions for the common docs in one ragged
    gather, rebase term k's positions by -k, encode (doc, anchor) into
    one int64 key, and intersect the key sets — surviving keys ARE the
    phrase occurrences, counted per doc with np.unique.

    slop > 0 uses the ordered-window relaxation (term k within
    [k, k+slop] of the anchor, in order) — a documented deviation from
    Lucene's transposition-counting slop.
    """
    field = clause.field
    terms = clause.terms
    if not terms:
        return np.zeros(0, dtype=np.int32), np.zeros(0, dtype=np.int32)
    if len(terms) == 1:
        docs, tfs, _ = segment.postings(field, terms[0])
        return docs, tfs
    infos = [segment.term_info(field, t) for t in terms]
    if any(i is None for i in infos) or field not in segment.pos_offsets:
        return np.zeros(0, dtype=np.int32), np.zeros(0, dtype=np.int32)

    # intersect doc lists, carrying each term's entry index along
    base = segment.field_entry_base[field]
    offs = segment.pos_offsets[field]
    data = segment.pos_data[field]
    common = segment.e_doc[infos[0].start : infos[0].start + infos[0].doc_freq]
    sel: List[np.ndarray] = [np.arange(len(common), dtype=np.int64)]
    for info in infos[1:]:
        docs_k = segment.e_doc[info.start : info.start + info.doc_freq]
        common, ia, ib = np.intersect1d(
            common, docs_k, assume_unique=True, return_indices=True
        )
        sel = [s[ia] for s in sel]
        sel.append(ib)
        if len(common) == 0:
            return np.zeros(0, dtype=np.int32), np.zeros(0, dtype=np.int32)

    slop = max(int(getattr(clause, "slop", 0) or 0), 0)
    inter: Optional[np.ndarray] = None
    for k, info in enumerate(infos):
        ent = (info.start - base) + sel[k]
        starts_k = offs[ent]
        lens_k = offs[ent + 1] - starts_k
        positions = _ragged_gather(data, starts_k, lens_k).astype(np.int64)
        docrep = np.repeat(common.astype(np.int64), lens_k)
        anchors = docrep * _POS_SHIFT + (positions - k)
        if slop and k:
            # each later term may trail the exact spot by up to `slop`
            anchors = np.unique(
                (anchors[None, :] - np.arange(slop + 1)[:, None]).reshape(-1)
            )
        elif k:
            keep = positions >= k
            anchors = anchors[keep]
        # every intersection is against term0's keyset (k=0, unadjusted),
        # so surviving keys always decode to real (doc, anchor) pairs —
        # negative-position aliases in later sets simply never match
        inter = anchors if inter is None else np.intersect1d(
            inter, anchors, assume_unique=True
        )
        if inter.size == 0:
            return np.zeros(0, dtype=np.int32), np.zeros(0, dtype=np.int32)
    out_docs, out_tf = np.unique(inter // _POS_SHIFT, return_counts=True)
    return out_docs.astype(np.int32), out_tf.astype(np.int32)


def score_segment(
    segment: Segment,
    plan: QueryPlan,
    stats: IndexStats,
) -> Tuple[np.ndarray, np.ndarray]:
    """Dense scores + match mask for every doc of one segment."""
    n = segment.doc_count
    scores = np.zeros(n, dtype=np.float32)
    matched_should = np.zeros(n, dtype=bool)
    matched_all_must = np.ones(n, dtype=bool)
    excluded = np.zeros(n, dtype=bool)
    n_must = 0
    n_should = 0

    caches: Dict[str, np.ndarray] = {}

    def cache_for(field: str) -> np.ndarray:
        if field not in caches:
            caches[field] = fieldnorm_cache(
                stats.avg_fieldnorm(field), plan.k1, plan.b
            )
        return caches[field]

    for group in plan.groups:
        gm = np.zeros(n, dtype=bool)
        gs = np.zeros(n, dtype=np.float32)
        if group.subplan is not None:
            # nested boolean (parenthesized subquery): score recursively
            # by the subplan's own MUST/SHOULD/MUST_NOT rules; the group
            # contributes the matching docs' summed subquery scores
            sub_scores, sub_mask = score_segment(segment, group.subplan, stats)
            gm |= sub_mask
            gs += np.where(sub_mask, sub_scores, np.float32(0.0))
        for rc in group.ranges:
            vals = segment.date_values(rc.field)
            m = vals != Segment.DATE_MISSING
            if rc.lo is not None:
                m &= (vals >= rc.lo) if rc.lo_inclusive else (vals > rc.lo)
            if rc.hi is not None:
                m &= (vals <= rc.hi) if rc.hi_inclusive else (vals < rc.hi)
            gm |= m
            # Tantivy range queries are constant-score (1.0 * boost)
            gs[m] += np.float32(rc.boost)
        for pc in group.phrases:
            docs, ptf = phrase_postings(segment, pc)
            if len(docs):
                dfs = [stats.doc_freq(pc.field, t) for t in pc.terms]
                # Tantivy PhraseWeight: BM25 weight from the max doc_freq
                # among the phrase terms.
                w = bm25_weight(max(dfs), stats.doc_count, pc.boost, plan.k1)
                fids = segment.fieldnorm_ids[pc.field][docs].astype(np.int64)
                comp = ptf.astype(np.float32) / (
                    ptf.astype(np.float32) + cache_for(pc.field)[fids]
                )
                gm[docs] = True
                gs[docs] += np.float32(w) * comp
        for clause in group.clauses:
            if clause.is_facet:
                docs = segment.facet_docs(clause.term)
                # one index-wide df sum per clause (it re-sums over all
                # segments; computing it twice doubled the O(S) work)
                fdf = stats.facet_doc_freq(clause.term)
                if len(docs) == 0 and fdf == 0:
                    continue
                w = np.float32(idf(fdf, stats.doc_count)) * np.float32(
                    clause.boost
                )
                gm[docs] = True
                gs[docs] += w
            else:
                docs, tfs, fids = segment.postings(clause.field, clause.term)
                df = stats.doc_freq(clause.field, clause.term)
                if df == 0:
                    continue
                w = bm25_weight(df, stats.doc_count, clause.boost, plan.k1)
                comp = tfs.astype(np.float32) / (
                    tfs.astype(np.float32) + cache_for(clause.field)[fids.astype(np.int64)]
                )
                gm[docs] = True
                gs[docs] += np.float32(w) * comp
        if group.occur is Occur.SHOULD:
            n_should += 1
            matched_should |= gm
            scores += gs
        elif group.occur is Occur.MUST:
            n_must += 1
            matched_all_must &= gm
            scores += gs
        else:
            excluded |= gm

    if plan.match_all:
        scores = scores + np.ones(n, dtype=np.float32)
        mask = np.ones(n, dtype=bool)
        if n_must:
            mask &= matched_all_must
    else:
        if n_must:
            mask = matched_all_must.copy()
            if n_should and plan.require_should:
                mask &= matched_should
        elif n_should:
            mask = matched_should
        else:
            mask = np.zeros(n, dtype=bool)
    mask &= ~excluded
    mask &= segment.live_mask()
    return scores, mask


def search(
    segments: Sequence[Segment],
    plan: QueryPlan,
    limit: int,
    stats: Optional[IndexStats] = None,
) -> List[Hit]:
    """Top-`limit` hits across segments, Tantivy TopDocs ordering."""
    if stats is None:
        stats = IndexStats(segments)
    if plan.is_empty:
        return []
    hits: List[Hit] = []
    for ord_, seg in enumerate(segments):
        scores, mask = score_segment(seg, plan, stats)
        docs = np.nonzero(mask)[0]
        if len(docs) == 0:
            continue
        seg_scores = scores[docs]
        if len(docs) > limit:
            # keep every doc tied with the kth score so the final
            # (-score, ord, doc) sort breaks ties by doc id — a bare
            # argpartition[:limit] picks arbitrary members of the tie
            part = np.argpartition(-seg_scores, limit - 1)
            kth = seg_scores[part[limit - 1]]
            keep = seg_scores >= kth
            docs, seg_scores = docs[keep], seg_scores[keep]
        for d, s in zip(docs, seg_scores):
            hits.append(Hit(float(s), ord_, int(d)))
    hits.sort(key=lambda h: (-h.score, h.segment_ord, h.doc))
    return hits[:limit]
