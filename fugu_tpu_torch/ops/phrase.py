"""Doc-level pruned phrase search — WAND over per-doc phrase bounds.

The vectorized phrase matcher (ops/oracle.py::phrase_postings) checks
position adjacency for EVERY doc containing all phrase terms; with
high-df terms that is tens of thousands of candidate docs per query for
a top-10 answer.  Tantivy serves phrases through the same top-k pruning
machinery as terms (upstream `src/db/search.rs:112` QueryParser
-> PhraseQuery -> TopDocs); the analog here is doc-LEVEL pruning:

    phrase_tf <= tf_t for every constituent term t, and tf -> tf_sat is
    monotone, so   score = w_p * tf_sat(phrase_tf)
                        <= w_p * tf_sat(tf_rare)  per doc

where w_p is the phrase's BM25 weight (from the max constituent
doc_freq, Tantivy PhraseWeight) and tf_rare the doc's term frequency of
the rarest constituent.  The block-max index (ops/blockmax.py) already
stores every entry's exact contribution w_t * tf_sat(tf_t), so the
per-doc bound is one multiply: contrib_rare(doc) * (w_p / w_rare).

``search_phrase_topk`` intersects the constituent doc lists ONCE
(:class:`PhraseMatcher`), sorts the surviving docs by bound, and checks
position adjacency in descending-bound chunks until the next chunk's
best bound cannot reach the kth score — exact top-k, usually after one
or two chunks.

Handles plans whose every group is a single-phrase SHOULD/MUST group
over one field (the shape the query parser emits for quoted queries);
anything else returns None for the caller's fallback chain.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from fugu_tpu_torch.index.segment import Segment
from fugu_tpu_torch.ops.oracle import IndexStats, _ragged_gather, _POS_SHIFT
from fugu_tpu_torch.query import (
    Occur,
    PhraseClause,
    QueryPlan,
    bm25_weight,
    fieldnorm_cache,
)

CHUNK = 4096  # candidate docs checked per adjacency round


class PhraseMatcher:
    """One-time doc-list intersection for a phrase; positions are then
    checked for arbitrary candidate subsets via :meth:`match`.

    The intersection tracks entry indices only for the rarest term (the
    bound source); other terms' entry offsets are recovered lazily per
    candidate chunk with a small ``searchsorted`` inside :meth:`match` —
    chunks are <= a few thousand docs and usually only one or two chunks
    are ever checked, so membership is tested with an O(df) doc bitmap
    instead of an O(|common| log df) sorted merge."""

    def __init__(self, segment: Segment, clause: PhraseClause):
        self.segment = segment
        self.clause = clause
        self.common = np.zeros(0, dtype=np.int32)
        self.alive = np.zeros(0, dtype=np.int64)  # rarest-term entry sel
        self.k_rare = 0
        self.infos = []
        self.ok = False

        field = clause.field
        terms = clause.terms
        if not terms:
            return
        infos = [segment.term_info(field, t) for t in terms]
        if any(i is None for i in infos):
            return
        if len(terms) > 1 and field not in segment.pos_offsets:
            return
        # intersect rarest-first so `common` shrinks as fast as possible
        by_df = sorted(range(len(infos)), key=lambda k: infos[k].doc_freq)
        self.k_rare = by_df[0]
        first = infos[self.k_rare]
        common = segment.e_doc[first.start : first.start + first.doc_freq]
        alive = np.arange(len(common), dtype=np.int64)
        for k in by_df[1:]:
            if len(common) == 0:
                break
            info = infos[k]
            docs_k = segment.e_doc[info.start : info.start + info.doc_freq]
            if segment.doc_count <= 8 * (info.doc_freq + len(common)):
                # bitmap membership: O(df + |common|), no log factor —
                # but ONLY when the O(doc_count) bitmap itself (page
                # faults on the fresh allocation) is within a constant
                # factor of the useful work; a selective phrase on a
                # multi-M-doc segment pays ~1000x more for the bitmap
                # than for |common| binary searches
                mask = np.zeros(segment.doc_count, dtype=bool)
                mask[docs_k] = True
                hit = mask[common]
            else:
                # df >> survivors: binary search beats the O(df) scatter
                pos = np.searchsorted(docs_k, common)
                hit = docs_k[np.minimum(pos, len(docs_k) - 1)] == common
            common = common[hit]
            alive = alive[hit]
        # dead docs can never be hits; drop them before bounding
        if len(common):
            live = ~segment.tombstones[common]
            common = common[live]
            alive = alive[live]
        self.common = common
        self.alive = alive
        self.infos = infos
        self.ok = True

    def rare_entry_indices(self) -> Tuple[int, np.ndarray]:
        """(term_index, global entry indices) of the rarest constituent
        restricted to the common docs — the tightest per-doc bound."""
        return self.k_rare, self.infos[self.k_rare].start + self.alive

    def _entries(self, k: int, idx: np.ndarray, docs: np.ndarray) -> np.ndarray:
        """Global entry indices of term ``k`` for common[idx] (== docs).

        The rarest term's indices were tracked through the intersection;
        other terms pay one searchsorted over the candidate chunk only
        (docs are known members, so every lookup hits)."""
        info = self.infos[k]
        if k == self.k_rare:
            return info.start + self.alive[idx]
        docs_k = self.segment.e_doc[info.start : info.start + info.doc_freq]
        # match docs_k's dtype: an int64 needle forces numpy to copy the
        # whole O(df) haystack to int64 before searching
        return info.start + np.searchsorted(docs_k, docs.astype(docs_k.dtype))

    def match(self, idx: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(docs, phrase_tf) among common[idx] — the adjacency check of
        oracle.phrase_postings restricted to a candidate subset."""
        seg = self.segment
        clause = self.clause
        docs = self.common[idx].astype(np.int64)
        if len(self.infos) == 1:
            ent = self._entries(0, idx, docs)
            return self.common[idx], seg.e_tf[ent]
        field = clause.field
        base = seg.field_entry_base[field]
        offs = seg.pos_offsets[field]
        data = seg.pos_data[field]
        slop = max(int(getattr(clause, "slop", 0) or 0), 0)
        inter: Optional[np.ndarray] = None
        for k, info in enumerate(self.infos):
            ent = self._entries(k, idx, docs) - base
            starts_k = offs[ent]
            lens_k = offs[ent + 1] - starts_k
            positions = _ragged_gather(data, starts_k, lens_k).astype(np.int64)
            docrep = np.repeat(docs, lens_k)
            anchors = docrep * _POS_SHIFT + (positions - k)
            if slop and k:
                anchors = np.unique(
                    (anchors[None, :] - np.arange(slop + 1)[:, None]).reshape(-1)
                )
            elif k:
                keep = positions >= k
                anchors = anchors[keep]
            inter = anchors if inter is None else np.intersect1d(
                inter, anchors, assume_unique=True
            )
            if inter.size == 0:
                return (
                    np.zeros(0, dtype=np.int32),
                    np.zeros(0, dtype=np.int32),
                )
        out_docs, out_tf = np.unique(inter // _POS_SHIFT, return_counts=True)
        return out_docs.astype(np.int32), out_tf.astype(np.int32)


def match_ranges(
    segment: Segment, clause: PhraseClause, los: np.ndarray, his: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """(docs, phrase_tf) of ``clause`` restricted to the doc-id windows
    ``[los[i], his[i])`` — NO full-posting intersection: each term's
    entries are located inside the windows with a searchsorted over its
    own (doc-sorted) posting range, so the cost scales with the windowed
    entry counts, not with doc frequency.  Anchor semantics are the same
    integer arithmetic as :meth:`PhraseMatcher.match` (incl. the
    ordered-window slop expansion, r5), so the (docs, tf) sets are
    identical.  Windows must be disjoint ascending."""
    field = clause.field
    terms = clause.terms
    infos = [segment.term_info(field, t) for t in terms]
    if any(i is None for i in infos):
        return np.zeros(0, dtype=np.int32), np.zeros(0, dtype=np.int32)

    # int32 to match e_doc: int64 bounds make np.searchsorted cast the
    # ENTIRE posting slice per call (measured 360x slower on 200k docs)
    bounds_ls = np.concatenate([los, his]).astype(np.int32)

    def windowed_entries(info):
        ent0 = info.start
        docs_t = segment.e_doc[ent0 : ent0 + info.doc_freq]
        se = np.searchsorted(docs_t, bounds_ls)  # one call: starts|ends
        starts, ends = se[: len(los)], se[len(los) :]
        lens = ends - starts
        total = int(lens.sum())
        if total == 0:
            return np.zeros(0, dtype=np.int64)
        rep = np.repeat(starts, lens)
        within = np.arange(total, dtype=np.int64) - np.repeat(
            np.cumsum(lens) - lens, lens
        )
        return ent0 + rep + within  # global entry ids, doc-ascending

    if len(infos) == 1:
        ent = windowed_entries(infos[0])
        docs = segment.e_doc[ent]
        live = ~segment.tombstones[docs]
        return docs[live].astype(np.int32), segment.e_tf[ent][live].astype(
            np.int32
        )

    base = segment.field_entry_base[field]
    offs = segment.pos_offsets[field]
    data = segment.pos_data[field]
    slop = max(int(getattr(clause, "slop", 0) or 0), 0)
    inter: Optional[np.ndarray] = None
    for k, info in enumerate(infos):
        ent = windowed_entries(info) - base
        if len(ent) == 0:
            return np.zeros(0, dtype=np.int32), np.zeros(0, dtype=np.int32)
        starts_k = offs[ent]
        lens_k = offs[ent + 1] - starts_k
        positions = _ragged_gather(data, starts_k, lens_k).astype(np.int64)
        docs_k = segment.e_doc[ent + base].astype(np.int64)
        docrep = np.repeat(docs_k, lens_k)
        anchors = docrep * _POS_SHIFT + (positions - k)
        if slop and k:
            # ordered-window slop (PhraseMatcher.match): term k serves
            # any anchor in [pos-k-slop, pos-k]
            anchors = np.unique(
                (anchors[None, :] - np.arange(slop + 1)[:, None]).reshape(-1)
            )
        elif k:
            keep = positions >= k
            anchors = anchors[keep]
        inter = anchors if inter is None else np.intersect1d(
            inter, anchors, assume_unique=True
        )
        if inter.size == 0:
            return np.zeros(0, dtype=np.int32), np.zeros(0, dtype=np.int32)
    out_docs, out_tf = np.unique(inter // _POS_SHIFT, return_counts=True)
    live = ~segment.tombstones[out_docs]
    return out_docs[live].astype(np.int32), out_tf[live].astype(np.int32)


def _phrase_only_clauses(plan: QueryPlan) -> Optional[List[PhraseClause]]:
    """The plan's phrases when every group is a single-phrase scoring
    group (SHOULD/MUST, no term/range/subplan mixing); else None."""
    out = []
    for g in plan.groups:
        if g.occur is Occur.MUST_NOT:
            return None  # exclusions need full match sets
        if g.clauses or g.ranges or g.subplan is not None:
            return None
        if len(g.phrases) != 1:
            return None
        out.append(g.phrases[0])
    return out if out else None


def search_phrase_topk(
    segment: Segment,
    plan: QueryPlan,
    stats: IndexStats,
    limit: int,
) -> Optional[List[Tuple[float, int]]]:
    """Exact top-`limit` [(score, doc)] for phrase-only plans via
    bound-ordered adjacency checking, or None (caller falls back)."""
    if plan.match_all or plan.has_range or plan.has_subplan:
        return None
    clauses = _phrase_only_clauses(plan)
    if clauses is None:
        return None
    if len(clauses) != 1:
        return None  # multi-phrase plans: rare; keep the oracle exact
    pc = clauses[0]

    from fugu_tpu_torch.ops.blockmax import get_blockmax, relaxed

    matcher = PhraseMatcher(segment, pc)
    if not matcher.ok:
        # absent term or missing positions: Tantivy matches nothing
        return []
    if len(matcher.common) == 0:
        return []

    dfs = [stats.doc_freq(pc.field, t) for t in pc.terms]
    if max(dfs) == 0:
        return []
    w_p = float(bm25_weight(max(dfs), stats.doc_count, pc.boost, plan.k1))
    cache = fieldnorm_cache(stats.avg_fieldnorm(pc.field), plan.k1, plan.b)
    fid_all = segment.fieldnorm_ids[pc.field]

    bm = get_blockmax(segment, stats, plan.k1, plan.b)
    k_rare, rare_ent = matcher.rare_entry_indices()
    w_rare = float(
        bm25_weight(dfs[k_rare], stats.doc_count, 1.0, plan.k1)
    )
    if w_p <= 0.0 or w_rare <= 0.0:
        # Negative/zero phrase idf: df > N/2 is possible when tombstones
        # inflate df past the live doc count (Tantivy has the same
        # ln(1 + (N-df+.5)/(df+.5)) < 0 regime — deleted docs stay in df
        # until merge).  Matches still EXIST and score negatively, so
        # returning [] here dropped real hits (found live r5: tiny
        # corpus + delete -> phrase search came back empty).  And with
        # w_p < 0 the bound formulas below invert into LOWER bounds
        # (tf up => score down), so pruning is unsound — fall back to
        # the dense oracle, which is exact for any weight sign.
        return None
    slop = max(int(getattr(pc, "slop", 0) or 0), 0)
    if slop == 0 or len(pc.terms) == 1:
        # phrase_tf <= tf_rare: every match consumes a distinct rare-term
        # occurrence, so the block-max entry contribution scales exactly
        bounds = bm.contrib[rare_ent] * np.float32(w_p / w_rare)
    else:
        # with slop, ONE rare-term occurrence can serve up to slop+1
        # distinct anchors (anchor = a position of term 0), so the tight
        # per-doc bound is tf_sat((slop+1) * tf_rare) — except when the
        # rare term IS the anchor term, where matches stay distinct
        t = segment.e_tf[rare_ent].astype(np.float32)
        if k_rare > 0:
            t = t * np.float32(slop + 1)
        fids_c = fid_all[matcher.common].astype(np.int64)
        bounds = (np.float32(w_p) * (t / (t + cache[fids_c]))).astype(
            np.float32
        )

    # progressive top-chunk selection: argpartition is O(n) per round and
    # one or two rounds almost always suffice, vs a full O(n log n) sort
    n = len(bounds)
    visited = np.zeros(n, dtype=bool)
    top_scores = np.full(limit, -np.inf, dtype=np.float32)
    top_docs = np.full(limit, 2**31 - 1, dtype=np.int64)
    kth = -np.inf
    take = CHUNK
    while True:
        k = min(take, n)
        top = (
            np.argpartition(-bounds, k - 1)[:k] if k < n else np.arange(n)
        )
        chunk = top[~visited[top]]
        if len(chunk) == 0:
            if k >= n:
                break
            take *= 2
            continue
        # blockmax.relaxed ulp margin: the bound is computed on a
        # different f32 rounding path than the exact score (contrib *
        # w_p/w_rare vs w_p * tf/(tf+norm)), so when phrase_tf ==
        # tf_rare — the common case — a doc's bound can land a few ulp
        # BELOW its exact score; a strict un-margined compare could then
        # prune a doc that ties or beats the kth score
        if float(bounds[chunk].max()) < relaxed(kth):
            break
        visited[chunk] = True
        last_round = k >= n
        docs, ptf = matcher.match(np.sort(chunk))
        if len(docs):
            fids = fid_all[docs].astype(np.int64)
            ptf_f = ptf.astype(np.float32)
            scores = np.float32(w_p) * (ptf_f / (ptf_f + cache[fids]))
            keep = scores >= kth
            docs, scores = docs[keep], scores[keep]
            if len(docs):
                all_s = np.concatenate([top_scores, scores])
                all_d = np.concatenate([top_docs, docs.astype(np.int64)])
                sel = np.lexsort((all_d, -all_s))[:limit]
                top_scores, top_docs = all_s[sel], all_d[sel]
                kth = (
                    top_scores[-1]
                    if np.isfinite(top_scores).all()
                    else -np.inf
                )
        if last_round:
            break
        take *= 2

    keep = np.isfinite(top_scores)
    return [(float(s), int(d)) for s, d in zip(top_scores[keep], top_docs[keep])]
