"""Pruned exact top-k for MIXED plans: phrases alongside terms/facets.

Round-4 state: any plan containing a phrase together with other scoring
groups — `"a b" c`, `+"a b" +d`, two phrases OR'd — fell through BOTH
pruned host engines (ops/blockmax handles term/facet plans,
ops/phrase.search_phrase_topk handles the single-phrase shape) to the
DENSE oracle: a full O(doc_count) scoring pass per query, hundreds of
ms at 1M docs.  The reference executes the same plans through Tantivy's
BooleanQuery over PhraseQuery/TermQuery children with the usual TopDocs
block-max pruning (upstream `src/db/search.rs:112,162`); this
module is that machinery's host analog, generalized from
ops/blockmax.py:

- each phrase is evaluated ONCE with the vectorized oracle matcher
  (ops/oracle.phrase_postings — the cost the dense oracle pays anyway)
  and becomes a VIRTUAL POSTING LIST: exact per-doc contributions
  w_p * ptf/(ptf + norm).  Two earlier designs measured slower than the
  dense oracle at 1M docs and were discarded: per-block bounds from a
  PhraseMatcher intersection (staging-bound, 130 vs 67 ms/q) and
  rare-term-scaled block maxima verified by windowed match_ranges
  (bounds too loose on flat tf=1 score fields — nearly every
  co-occurrence block survived the kth filter and match_ranges
  re-gathered positions per chunk, 220 vs 36 ms/q on phrase pairs).
  Virtual postings make the phrase bound EXACT per block and
  verification a searchsorted, so the only O(df) work happens once.
- per-block upper bound = sum over scoring groups of the group's member
  maxima: term clauses reuse the BlockMaxIndex per-(term, block) tables
  (scaled by clause boost — contributions are precomputed at boost 1);
  facet clauses contribute their constant idf*boost on blocks holding
  facet docs; phrase clauses their virtual-posting block maxima.
- MUST pruning: a block where a MUST group has no possible member is
  -inf; when shoulds are required (require_should, or no MUSTs at all)
  a block with no SHOULD member present is -inf.
- blocks are visited in descending bound order and verification stops
  once the next bound cannot reach the kth score (ulp-relaxed, shared
  margin with ops/blockmax.relaxed).
- verification recomputes candidate docs' scores with EXACTLY the
  oracle's float sequence (per-group f32 accumulators added in group
  order, members in phrases-then-clauses tuple order —
  ops/oracle.py::score_segment), so results are bit-identical including
  tie ordering.

Device fusion (phrase_bounds): when the batched phrase stream kernel
(ops/phrase_stream) already swept the corpus for this batch, callers
can pass its per-fine-block maxima per clause; they are EXACT achievable
per-block scores — tighter than the rare-term bound — and let the
phrase's bound skip the PhraseMatcher intersection entirely on blocks
the device already ruled out.

Negative-weight regimes (tombstone-inflated df -> idf < 0): term/facet
block maxima are computed directly on signed contributions, so summed
bounds stay valid upper bounds; the phrase bound SCALES contributions
(w_p / w_rare) and inverts for w <= 0, so those plans return None and
take the dense oracle (same policy as search_phrase_topk, r5).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from fugu_tpu_torch.index.segment import FACET_FIELD_KEY, Segment
from fugu_tpu_torch.ops.blockmax import BM_BLOCK, get_blockmax, relaxed
from fugu_tpu_torch.ops.oracle import IndexStats, phrase_postings
from fugu_tpu_torch.query import (
    Occur,
    QueryPlan,
    bm25_weight,
    fieldnorm_cache,
    idf,
)

#: initial blocks verified per round (grows 4x per round like
#: ops/phrase.py's candidate chunks)
_FIRST_CHUNK = 4


def search_mixed_topk(
    segment: Segment,
    plan: QueryPlan,
    stats: IndexStats,
    limit: int,
) -> Optional[List[Tuple[float, int]]]:
    """Exact top-`limit` [(score, doc)] for phrase-bearing boolean
    plans, or None (caller falls back to the dense oracle)."""
    if plan.match_all or plan.has_range or plan.has_subplan:
        return None
    if not plan.has_phrase:
        return None  # term/facet-only plans belong to ops/blockmax
    if limit <= 0:
        return []

    bm = get_blockmax(segment, stats, plan.k1, plan.b)
    nb = bm.n_blocks
    n = stats.doc_count

    bound = np.zeros(nb, dtype=np.float64)
    present_should = np.zeros(nb, dtype=bool)
    must_absent = np.zeros(nb, dtype=bool)
    n_must = n_should = 0
    # per-group member lists for verification, in ORACLE ORDER
    # (phrases tuple order, then clauses tuple order)
    scoring_groups: List[Tuple[object, list]] = []
    mustnot_groups: List[list] = []
    caches: Dict[str, np.ndarray] = {}

    def cache_for(field: str) -> np.ndarray:
        if field not in caches:
            caches[field] = fieldnorm_cache(
                stats.avg_fieldnorm(field), plan.k1, plan.b
            )
        return caches[field]

    for group in plan.groups:
        members: list = []
        g_bound = np.zeros(nb, dtype=np.float64) if (
            group.occur is not Occur.MUST_NOT
        ) else None
        g_present = np.zeros(nb, dtype=bool)
        for pc in group.phrases:
            if pc.boost <= 0.0:
                return None
            dfs = [stats.doc_freq(pc.field, t) for t in pc.terms]
            if not dfs or max(dfs) == 0:
                continue
            # one vectorized evaluation (the dense oracle pays exactly
            # this); the phrase becomes a virtual posting list with
            # exact per-doc contributions
            pdocs, ptf = phrase_postings(segment, pc)
            if len(pdocs) == 0:
                continue
            pdocs = pdocs.astype(np.int64)
            w_p = np.float32(
                bm25_weight(max(dfs), stats.doc_count, pc.boost, plan.k1)
            )
            tf = ptf.astype(np.float32)
            fids = segment.fieldnorm_ids[pc.field][pdocs].astype(np.int64)
            comp = tf / (tf + cache_for(pc.field)[fids])
            contribs = w_p * comp
            members.append(("virtual", (pdocs, contribs)))
            blk = pdocs // BM_BLOCK
            change = np.nonzero(np.diff(blk))[0] + 1
            starts = np.concatenate(([0], change))
            ids = blk[starts]
            g_present[ids] = True
            if g_bound is not None:
                maxima = np.maximum.reduceat(
                    contribs.astype(np.float64), starts
                )
                np.add.at(g_bound, ids, np.maximum(maxima, 0.0))
        for clause in group.clauses:
            if clause.boost <= 0.0:
                return None
            if clause.is_facet:
                fdocs = segment.facet_docs(clause.term)
                fdf = stats.facet_doc_freq(clause.term)
                if len(fdocs) == 0 or fdf == 0:
                    continue
                w = np.float32(idf(fdf, stats.doc_count)) * np.float32(
                    clause.boost
                )
                members.append(("facet", (clause, fdocs, w)))
                blk = np.unique(fdocs // BM_BLOCK).astype(np.int64)
                g_present[blk] = True
                if g_bound is not None:
                    # clamped at 0: a doc may match the group via OTHER
                    # members while skipping this one, so a negative
                    # member max must not lower the block bound
                    np.add.at(g_bound, blk, max(float(w), 0.0))
            else:
                info = segment.term_info(clause.field, clause.term)
                df = stats.doc_freq(clause.field, clause.term)
                if info is None or df == 0:
                    continue
                members.append(("term", (clause, info, df)))
                ids, maxima, _offs = bm.term_blocks(
                    info.start, info.doc_freq
                )
                g_present[ids] = True
                if g_bound is not None:
                    # max(., 0): see the facet clamp note above
                    np.add.at(
                        g_bound,
                        ids,
                        np.maximum(
                            maxima.astype(np.float64)
                            * float(clause.boost),
                            0.0,
                        ),
                    )
        if group.occur is Occur.MUST_NOT:
            mustnot_groups.append(members)
            continue
        scoring_groups.append((group, members))
        bound += g_bound
        if group.occur is Occur.MUST:
            n_must += 1
            must_absent |= ~g_present
        else:
            n_should += 1
            present_should |= g_present

    if not scoring_groups:
        return []
    bound[must_absent] = -np.inf
    need_should = n_should > 0 and (plan.require_should or n_must == 0)
    if n_must == 0 and n_should == 0:
        return []
    if need_should:
        bound[~present_should] = -np.inf

    live_blocks = np.nonzero(np.isfinite(bound))[0]
    if len(live_blocks) == 0:
        return []
    order = live_blocks[np.argsort(-bound[live_blocks], kind="stable")]
    bnd_o = bound[order]

    run_docs = np.zeros(0, dtype=np.int64)
    run_scores = np.zeros(0, dtype=np.float32)
    kth: Optional[float] = None

    i = 0
    chunk = _FIRST_CHUNK
    while i < len(order):
        if kth is not None and bnd_o[i] < relaxed(kth):
            break
        take = order[i : i + chunk]
        if kth is not None:
            keep = bnd_o[i : i + chunk] >= relaxed(kth)
            take = take[keep]
        i += chunk
        # modest growth cap: kth only updates between rounds, so huge
        # chunks verify blocks a fresh kth would have pruned (the first
        # cut capped at 4096 and spent most of its time there)
        chunk = min(chunk * 4, 64)
        if len(take) == 0:
            continue
        blk_ids = np.sort(take)
        docs, scores = _verify_blocks(
            segment,
            plan,
            stats,
            scoring_groups,
            mustnot_groups,
            blk_ids,
            n_must,
            n_should,
        )
        if len(docs):
            run_docs = np.concatenate([run_docs, docs])
            run_scores = np.concatenate([run_scores, scores])
            if len(run_docs) >= limit:
                # compress the running set: keep the top-limit plus
                # every kth tie (exact f32 compare — scores on both
                # sides are final values, no margin needed)
                top = np.lexsort((run_docs, -run_scores))
                kth = float(run_scores[top[limit - 1]])
                keep2 = run_scores >= kth
                run_docs = run_docs[keep2]
                run_scores = run_scores[keep2]

    if len(run_docs) == 0:
        return []
    top = np.lexsort((run_docs, -run_scores))[:limit]
    return [(float(run_scores[o]), int(run_docs[o])) for o in top]


def _windowed_hits(sorted_docs: np.ndarray, los, his) -> np.ndarray:
    """Indices into ``sorted_docs`` falling inside the ascending
    disjoint windows [los[i], his[i])."""
    if len(sorted_docs) == 0:
        return np.zeros(0, dtype=np.int64)
    bounds = np.concatenate([los, his]).astype(sorted_docs.dtype)
    se = np.searchsorted(sorted_docs, bounds)
    starts, ends = se[: len(los)], se[len(los) :]
    lens = ends - starts
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    rep = np.repeat(starts.astype(np.int64), lens)
    within = np.arange(total, dtype=np.int64) - np.repeat(
        np.cumsum(lens) - lens, lens
    )
    return rep + within


def _verify_blocks(
    segment,
    plan,
    stats,
    scoring_groups,
    mustnot_groups,
    blk_ids,
    n_must,
    n_should,
):
    """Exact (docs, scores) of every MATCHING doc inside ``blk_ids``
    (ascending block ids), oracle float sequence throughout."""
    los = blk_ids.astype(np.int64) * BM_BLOCK
    his = np.minimum(los + BM_BLOCK, segment.doc_count)

    def member_docs_contribs(kind, payload, want_contrib=True):
        """(docs ascending, f32 contribs) of one member inside the
        windows.  Contrib expressions mirror ops/oracle.score_segment."""
        if kind == "virtual":
            pdocs, contribs = payload
            idx = _windowed_hits(pdocs, los, his)
            if len(idx) == 0:
                return np.zeros(0, dtype=np.int64), None
            if not want_contrib:
                return pdocs[idx], None
            return pdocs[idx], contribs[idx]
        if kind == "facet":
            clause, fdocs, w = payload
            idx = _windowed_hits(fdocs, los, his)
            if len(idx) == 0:
                return np.zeros(0, dtype=np.int64), None
            docs = fdocs[idx].astype(np.int64)
            if not want_contrib:
                return docs, None
            return docs, np.full(len(docs), w, dtype=np.float32)
        clause, info, df = payload
        docs_t = segment.e_doc[info.start : info.start + info.doc_freq]
        idx = _windowed_hits(docs_t, los, his)
        if len(idx) == 0:
            return np.zeros(0, dtype=np.int64), None
        ent = info.start + idx
        docs = segment.e_doc[ent].astype(np.int64)
        if not want_contrib:
            return docs, None
        w = bm25_weight(df, stats.doc_count, clause.boost, plan.k1)
        tf = segment.e_tf[ent].astype(np.float32)
        fids = segment.e_fid[ent].astype(np.int64)
        cache = fieldnorm_cache(
            stats.avg_fieldnorm(clause.field), plan.k1, plan.b
        )
        comp = tf / (tf + cache[fids])
        return docs, np.float32(w) * comp

    # pass 1: candidate docs = union over scoring members
    per_group: List[List[Tuple[np.ndarray, Optional[np.ndarray]]]] = []
    all_docs: List[np.ndarray] = []
    for _group, members in scoring_groups:
        got = [member_docs_contribs(k, p) for k, p in members]
        per_group.append(got)
        for docs, _c in got:
            if len(docs):
                all_docs.append(docs)
    if not all_docs:
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.float32)
    cand = np.unique(np.concatenate(all_docs))

    # pass 2: oracle-order scoring + mask over the candidates
    scores = np.zeros(len(cand), dtype=np.float32)
    matched_should = np.zeros(len(cand), dtype=bool)
    matched_all_must = np.ones(len(cand), dtype=bool)
    for (group, _members), got in zip(scoring_groups, per_group):
        gm = np.zeros(len(cand), dtype=bool)
        gs = np.zeros(len(cand), dtype=np.float32)
        for docs, contribs in got:
            if len(docs) == 0:
                continue
            pos = np.searchsorted(cand, docs)
            gm[pos] = True
            # member order preserved: one add per (member, doc), same
            # accumulation order as the oracle's per-member += loops
            np.add.at(gs, pos, contribs)
        if group.occur is Occur.MUST:
            matched_all_must &= gm
        else:
            matched_should |= gm
        scores += gs

    excluded = np.zeros(len(cand), dtype=bool)
    for members in mustnot_groups:
        for kind, payload in members:
            docs, _ = member_docs_contribs(kind, payload, want_contrib=False)
            if len(docs) == 0:
                continue
            pos = np.searchsorted(cand, docs)
            hit = pos < len(cand)
            pos = pos[hit]
            sel = cand[pos] == docs[hit]
            excluded[pos[sel]] = True

    if n_must:
        mask = matched_all_must.copy()
        if n_should and plan.require_should:
            mask &= matched_should
    elif n_should:
        mask = matched_should
    else:
        mask = np.zeros(len(cand), dtype=bool)
    mask &= ~excluded
    mask &= ~segment.tombstones[cand]
    return cand[mask], scores[mask]
