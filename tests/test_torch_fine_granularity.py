"""The phase-A planner's per-stream granularity on the port, held to the
reference's ``tests/test_fine_granularity.py``
(``test_planner_deep_stream_picks_fine4``).

A stream whose every live query extracts deep (limit > DEEP_LIMIT)
takes DEEP_FINE maxima a block, a mixed or shallow one FINE_PER_BLOCK,
and DEEP_LIMIT itself is not deep.  An all-deep batch must equal the
reference's ``batch_search(..., interpret=True)`` and the oracle bit for
bit.  The reference's cases that pin ``FUGU_FINE_PER_BLOCK`` have no
counterpart: the port reads no environment for it.
"""

import dataclasses

import numpy as np
import pytest
import torch

from fugu_tpu.index import segment as ref_segment
from fugu_tpu.index.schema import DOCS_SCHEMA
from fugu_tpu.index.segment import SegmentBuilder
from fugu_tpu.ops import batch_scorer as ref_bs
from fugu_tpu.ops import oracle as ref_oracle
from fugu_tpu.query import Occur, QueryGroup, QueryPlan, TermClause
from fugu_tpu_torch import query as pq
from fugu_tpu_torch.index import segment as port_segment
from fugu_tpu_torch.ops import batch_scorer as bs
from fugu_tpu_torch.ops import oracle

torch.set_num_threads(1)

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def segs():
    """The reference test's segment (3,000 docs over 40 words, a facet
    a doc, every 41st doc dead), built by the reference, and its port
    copy."""
    rng = np.random.default_rng(11)
    words = [f"w{i}" for i in range(40)]
    b = SegmentBuilder(DOCS_SCHEMA)
    for i in range(3000):
        text = " ".join(rng.choice(words, size=int(rng.integers(3, 20))))
        b.add_document(
            {"text": [text]},
            facets=[f"/cat/{int(rng.integers(0, 5))}"],
            stored={"id": f"d{i}"},
        )
    ref = b.build()
    ref.tombstones[::41] = True
    kw = {
        f.name: getattr(ref, f.name)
        for f in dataclasses.fields(ref_segment.Segment)
        if f.init and not f.name.startswith("_")
    }
    kw["tombstones"] = ref.tombstones.copy()
    return ref, port_segment.Segment(**kw)


def _mixed_plans(rng):
    """The reference test's plans: pure SHOULD, MUST, MUST_NOT and
    facet-gated."""
    plans = []
    for qi in range(12):
        n = int(rng.integers(1, 4))
        terms = rng.choice(40, size=n, replace=False)
        groups = [
            QueryGroup(Occur.SHOULD, (TermClause("text", f"w{t}"),))
            for t in terms
        ]
        r = qi % 4
        if r == 1:
            groups[0] = QueryGroup(Occur.MUST, groups[0].clauses)
        elif r == 2:
            groups.append(QueryGroup(Occur.MUST_NOT, (
                TermClause("text", f"w{int(rng.integers(0, 40))}"),)))
        elif r == 3:
            groups.append(QueryGroup(Occur.MUST, (TermClause(
                "", f"/cat/{int(rng.integers(0, 5))}", is_facet=True),)))
        plans.append(QueryPlan(groups=tuple(groups)))
    return plans


def to_port_plan(plan):
    return pq.QueryPlan(
        groups=tuple(
            pq.QueryGroup(
                pq.Occur(g.occur.value),
                tuple(pq.TermClause(c.field, c.term, c.boost, c.is_facet)
                      for c in g.clauses),
            )
            for g in plan.groups
        ),
        require_should=plan.require_should,
        k1=plan.k1,
        b=plan.b,
    )


@pytest.mark.parametrize("q_idx,limits,deep", [
    ([0, 1, None], [100, 64], True),   # every live query deep
    ([0, 1], [100, 10], False),        # mixed
    ([0], [bs.DEEP_LIMIT], False),     # the boundary is not deep
    ([0], [bs.DEEP_LIMIT + 1], True),
    ([None], [100], False),            # no live query
])
def test_planner_deep_stream_picks_deep_fine(q_idx, limits, deep):
    assert not ref_bs._FINE_PINNED
    want = bs.DEEP_FINE if deep else bs.FINE_PER_BLOCK
    assert bs._fine_for_stream(q_idx, limits) == want
    assert ref_bs._fine_for_stream(q_idx, limits) == want
    assert (bs.DEEP_LIMIT, bs.DEEP_FINE, bs.FINE_PER_BLOCK) == (
        ref_bs.DEEP_LIMIT, ref_bs.DEEP_FINE, ref_bs.FINE_PER_BLOCK)


@pytest.mark.parametrize("deep", [True, False])
def test_deep_batch_matches_reference_and_oracle(segs, monkeypatch, deep):
    """The reference test's all-limit-100 batch (and the same plans with
    every other limit 10): the port's phase A runs at the planner's
    granularity for each stream, and the hits equal the reference's and
    the oracle's, tolerance 0."""
    ref, port = segs
    plans = _mixed_plans(np.random.default_rng(13))
    limits = [100 if deep or i % 2 else 10 for i in range(len(plans))]
    fines = []
    real = bs.phasea

    def record(*args):
        fines.append(args[-1])
        return real(*args)

    monkeypatch.setattr(bs, "phasea", record)
    stats = oracle.IndexStats([port])
    got = bs.batch_search(port, [to_port_plan(p) for p in plans], stats,
                          limits, CPU)
    want = ref_bs.batch_search(ref, plans, ref_oracle.IndexStats([ref]),
                               limits, interpret=True)
    if deep:
        assert fines and set(fines) == {bs.DEEP_FINE}
    else:  # a stream holding a shallow query keeps the default
        assert bs.FINE_PER_BLOCK in fines
    for plan, lim, g, w in zip(plans, limits, got, want):
        exp = [(np.float32(h.score), h.doc)
               for h in oracle.search([port], to_port_plan(plan), lim, stats)]
        assert g is not None and w is not None
        assert [(np.float32(s), d) for s, d in g] == exp, plan
        assert [(np.float32(s), d) for s, d in w] == exp, plan
