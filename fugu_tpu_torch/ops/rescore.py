"""Exact host rescoring of device-selected top-k hits.

The device engines do not sum a doc's clause contributions as the host
oracle does (ops/oracle.py::score_segment: per-group accumulators summed
in group order, f32 throughout), and they fold a facet clause's
normalisation into its weight, so a score computed on the device need
not match the oracle bit for bit, although the card divides with IEEE
rounding.  On an NVIDIA H100 80GB HBM3 the small-segment engine's
candidate scores differed in bits from the exact ones on 480 of 24,217
candidates of a 32,768-doc segment and 356 of 26,311 of a 262,144-doc
segment (256 plans at limit 100, chip_smoke.py's small-segment phase).
The engines therefore use the device for finding the top-k candidates
and recompute the <=k winning scores on the host with exactly the
oracle's float sequence.  Cost: a few searchsorted lookups over <=k
docs per clause, 17-27 ms for the 232 plans of a batch at limit 10 on
that machine's host, and the final ordering becomes bit-identical to
the scalar reference.

The device ranking and the exact ranking can only disagree by last-ulp
near-ties, so re-sorting the device's k candidates (k >= requested
limit, the kernels' extraction ladder) reproduces the exact top-limit.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from fugu_tpu_torch.index.segment import Segment
from fugu_tpu_torch.ops.oracle import IndexStats
from fugu_tpu_torch.query import (
    Occur,
    QueryPlan,
    bm25_weight,
    fieldnorm_cache,
    idf,
)


def exact_scores(
    segment: Segment, plan: QueryPlan, stats: IndexStats, docs: np.ndarray
) -> np.ndarray:
    """Oracle-exact f32 scores for `docs` (device plans only: term and
    facet clauses — phrases/ranges/subplans never reach the device)."""
    # int32 needles for searchsorted: an int64 needle makes numpy copy
    # the whole O(df) posting haystack to int64 per clause
    docs32 = docs.astype(np.int32)
    scores = np.zeros(len(docs), dtype=np.float32)
    caches = {}

    def cache_for(field: str) -> np.ndarray:
        if field not in caches:
            caches[field] = fieldnorm_cache(
                stats.avg_fieldnorm(field), plan.k1, plan.b
            )
        return caches[field]

    for group in plan.groups:
        if group.occur is Occur.MUST_NOT:
            continue  # excluded docs are never in the hit set
        gs = np.zeros(len(docs), dtype=np.float32)
        for clause in group.clauses:
            if clause.is_facet:
                fdocs = segment.facet_docs(clause.term)
                df = stats.facet_doc_freq(clause.term)
                # df can be >0 via OTHER segments while this one carries
                # no postings for the term — nothing to add here then
                if len(fdocs) == 0 or df == 0:
                    continue
                w = np.float32(idf(df, stats.doc_count)) * np.float32(
                    clause.boost
                )
                pos = np.searchsorted(fdocs, docs32)
                hit = (pos < len(fdocs)) & (
                    fdocs[np.minimum(pos, max(len(fdocs) - 1, 0))] == docs32
                )
                gs[hit] += w
            else:
                cdocs, tfs, fids = segment.postings(clause.field, clause.term)
                df = stats.doc_freq(clause.field, clause.term)
                if df == 0 or len(cdocs) == 0:
                    continue
                w = bm25_weight(df, stats.doc_count, clause.boost, plan.k1)
                pos = np.searchsorted(cdocs, docs32)
                posc = np.minimum(pos, max(len(cdocs) - 1, 0))
                hit = (pos < len(cdocs)) & (cdocs[posc] == docs32)
                sel = posc[hit]
                tf = tfs[sel].astype(np.float32)
                comp = tf / (tf + cache_for(clause.field)[fids[sel].astype(np.int64)])
                gs[hit] += np.float32(w) * comp
        scores += gs
    return scores


def rescore_hits(
    segment: Segment,
    plan: QueryPlan,
    stats: IndexStats,
    hits: List[Tuple[float, int]],
) -> List[Tuple[float, int]]:
    """Replace device scores with oracle-exact host scores and re-rank
    (-score, doc).  Doc membership is unchanged — only float rounding."""
    if not hits:
        return hits
    docs = np.array([d for _, d in hits], dtype=np.int64)
    exact = exact_scores(segment, plan, stats, docs)
    out = sorted(
        ((float(s), int(d)) for s, d in zip(exact, docs)),
        key=lambda sd: (-sd[0], sd[1]),
    )
    return out
