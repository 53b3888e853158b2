"""The comparison that decides ``correct``: served answers against the
reference's.

A search answer is judged by its gap: for each served hit ``i`` with
score ``s_i`` on doc ``d_i``, the larger of ``|s_i - r(d_i)| / r(d_i)``
(the doc's own reference score) and ``|s_i - R_i| / R_i`` (the
reference's ``i``-th best score), over the hits.  A served doc that does
not match the query, a doc served twice, or a hit count other than the
reference's ``min(k, matches)`` gives the gap 1.  Ties and rounding move
neither term by more than the scores' own rounding.
"""

from __future__ import annotations

import numpy as np

#: the gap of an answer that is wrong in kind, not in rounding
WRONG = 1.0


class Expected:
    """The reference's answer to one query, ready to judge served answers
    by: its matching docs ascending with their scores, and its best
    ``k`` scores."""

    def __init__(self, ref_docs, ref_scores, k: int):
        order = np.argsort(ref_docs, kind="stable")
        self.docs = np.asarray(ref_docs)[order]
        self.scores = np.asarray(ref_scores, dtype=np.float64)[order]
        self.best = np.sort(self.scores)[::-1][:min(k, len(self.scores))]

    def score_of(self, doc: int):
        i = int(np.searchsorted(self.docs, doc))
        return self.scores[i] if i < len(self.docs) and self.docs[i] == doc \
            else None


def answer_gap(hits, expected: Expected, doc_index) -> float:
    """Gap of one served answer ``hits`` ([(id, score)]) against the
    reference's ``expected`` answer to the same query; ``doc_index`` maps
    an id to the reference's doc number."""
    if len(hits) != len(expected.best):
        return WRONG
    seen = set()
    gap = 0.0
    for i, (doc_id, score) in enumerate(hits):
        d = doc_index.get(doc_id)
        r = None if d is None or d in seen else expected.score_of(d)
        if r is None:
            return WRONG
        seen.add(d)
        best = expected.best[i]
        gap = max(gap, abs(score - r) / abs(r), abs(score - best) / abs(best))
    return gap


def gaps(answers, reference, doc_index, k: int):
    """Gap of each (query index, hits) in ``answers``; ``reference``
    maps a query index to its (docs, scores)."""
    expected = {qi: Expected(*ref, k) for qi, ref in reference.items()}
    return [answer_gap(hits, expected[qi], doc_index) for qi, hits in answers]
