"""Port two-phase batch engine (fugu_tpu_torch.ops.batch_scorer) against
the reference's Pallas phase A in interpret mode, its batch_search and
the NumPy oracle.

The port runs its plain PyTorch versions here (CPU tensors); the CUDA
kernels are held to the same plain versions on the card by
chip_smoke.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fugu_tpu.index import segment as ref_segment
from fugu_tpu.index.schema import DOCS_SCHEMA
from fugu_tpu.index.segment import SegmentBuilder
from fugu_tpu.ops import batch_scorer as ref_bs
from fugu_tpu.ops import oracle as ref_oracle
from fugu_tpu.query import Occur, QueryGroup, QueryPlan, TermClause
from fugu_tpu_torch.index import segment as port_segment
from fugu_tpu_torch.ops import batch_scorer as bs
from fugu_tpu_torch.ops import block_scorer as port_block
from fugu_tpu_torch.ops import oracle
from fugu_tpu_torch.query import (
    Occur as POccur,
    QueryGroup as PQueryGroup,
    QueryPlan as PQueryPlan,
    TermClause as PTermClause,
)

torch.set_num_threads(1)

CPU = torch.device("cpu")


def to_port(seg):
    kw = {
        f.name: getattr(seg, f.name)
        for f in dataclasses.fields(ref_segment.Segment)
        if f.init and not f.name.startswith("_")
    }
    kw["tombstones"] = seg.tombstones.copy()
    return port_segment.Segment(**kw)


def to_port_plan(plan):
    return PQueryPlan(
        groups=tuple(
            PQueryGroup(
                POccur(g.occur.value),
                tuple(
                    PTermClause(c.field, c.term, c.boost, c.is_facet)
                    for c in g.clauses
                ),
            )
            for g in plan.groups
        ),
        require_should=plan.require_should,
        k1=plan.k1,
        b=plan.b,
    )


@pytest.fixture(scope="module")
def segs():
    """tests/test_batch_scorer.py's corpus plus a second facet per doc
    (so five facet MUSTs can all match), built by the reference."""
    rng = np.random.default_rng(2)
    words = [f"w{i}" for i in range(50)]
    b = SegmentBuilder(DOCS_SCHEMA)
    for i in range(5000):
        text = " ".join(rng.choice(words, size=int(rng.integers(3, 25))))
        b.add_document(
            {"text": [text]},
            facets=[f"/cat/{int(rng.integers(0, 6))}",
                    f"/tag/{int(rng.integers(0, 3))}"],
            stored={"id": f"d{i}"},
        )
    ref = b.build()
    ref.tombstones[::53] = True  # dead docs must be zeroed in phase A
    return ref, to_port(ref)


def S(t):
    return QueryGroup(Occur.SHOULD, (TermClause("text", t),))


def M(t):
    return QueryGroup(Occur.MUST, (TermClause("text", t),))


def N(t):
    return QueryGroup(Occur.MUST_NOT, (TermClause("text", t),))


def F(path):
    return QueryGroup(Occur.MUST, (TermClause("", path, is_facet=True),))


def make_plans(kind, n=6, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        w = [f"w{x}" for x in rng.choice(50, size=4, replace=False)]
        cat = f"/cat/{int(rng.integers(0, 6))}"
        if kind == "pure":
            groups, rs = [S(x) for x in w[: int(rng.integers(1, 5))]], True
        elif kind == "neg":
            groups, rs = [S(w[0]), S(w[1]), N(w[2])], True
        elif kind == "gate":
            groups, rs = [S(w[0]), S(w[1]), F(cat)], True
        elif kind == "shift":
            # more than 4 facet gates with require_should: counted lanes
            groups = [S(w[0]), F("/cat"), F(cat), F("/tag"), F("/tag/1"),
                      F("/cat")]
            rs = True
        elif kind == "exact":
            groups, rs = [M(x) for x in w[: int(rng.integers(2, 4))]], True
        else:  # upper: a MUST with SHOULDs that must match too
            groups, rs = [S(w[0]), S(w[1]), M(w[2])], True
        out.append(QueryPlan(groups=tuple(groups), require_should=rs))
    return out


def f32_hits(hits):
    return [(np.float32(s), int(d)) for s, d in hits]


def assert_identical(segs, plans, limits):
    ref, port = segs
    ref_stats = ref_oracle.IndexStats([ref])
    stats = oracle.IndexStats([port])
    pplans = [to_port_plan(p) for p in plans]
    got = bs.batch_search(port, pplans, stats, limits, CPU)
    want = ref_bs.batch_search(ref, plans, ref_stats, limits, interpret=True)
    for p, lim, g, w in zip(pplans, limits, got, want):
        exp = [(h.score, h.doc) for h in oracle.search([port], p, lim, stats)]
        assert g is not None and w is not None
        assert f32_hits(g) == f32_hits(exp), (g[:3], exp[:3])
        assert f32_hits(w) == f32_hits(exp)


KINDS = ["pure", "neg", "gate", "shift", "exact", "upper"]


@pytest.mark.parametrize("kind", KINDS)
def test_batch_search_matches_reference_and_oracle(segs, kind):
    plans = make_plans(kind, seed=KINDS.index(kind))
    assert {ref_bs._classify(p) for p in plans} == {kind}
    assert {bs._classify(to_port_plan(p)) for p in plans} == {kind}
    assert_identical(segs, plans, [10] * len(plans))


def test_batch_search_mixed_limits(segs):
    plans = make_plans("pure", 3, seed=11) + make_plans("exact", 3, seed=12)
    assert_identical(segs, plans, [10, 100, 50, 10, 100, 128])


def test_candidates_contain_true_topk_blocks(segs, monkeypatch):
    """Wave 1 of every one-wave kind must already hold every block of
    the true top-k: the margin keeps the bf16-rounded maxima a valid
    bound."""
    _, port = segs
    stats = oracle.IndexStats([port])
    plans = [
        to_port_plan(p)
        for kind in KINDS[:-1]
        for p in make_plans(kind, 3, seed=20 + KINDS.index(kind))
    ]
    seen = {}
    orig = port_block.block_search_begin

    def spy(segment, sub_plans, st, limit, device, block_lists=None):
        for j, p in enumerate(sub_plans):
            seen.setdefault(id(p), set()).update(
                int(x) for x in block_lists[j]
            )
        return orig(segment, sub_plans, st, limit, device, block_lists)

    monkeypatch.setattr(port_block, "block_search_begin", spy)
    got = bs.batch_search(port, plans, stats, [10] * len(plans), CPU)
    for p, g in zip(plans, got):
        exp = oracle.search([port], p, 10, stats)
        assert f32_hits(g) == f32_hits((h.score, h.doc) for h in exp)
        want = {h.doc // port_block.BLOCK for h in exp}
        assert want <= seen.get(id(p), set()), (want, seen.get(id(p)))


def phasea_inputs(segs, kind_list, packed):
    """One stream's staged operands, for the reference and the port."""
    ref, port = segs
    stats = oracle.IndexStats([port])
    plans = [
        to_port_plan(p)
        for i, kind in enumerate(kind_list)
        for p in make_plans(kind, 4, seed=40 + i)
    ]
    pack = port.block_major(stats, CPU)
    kinds = {i: bs._classify(p) for i, p in enumerate(plans)}
    q_idx = list(range(len(plans)))
    wide = any(k not in bs.NARROW_KINDS for k in kinds.values())
    terms = {}
    for i in q_idx:
        for t in bs._plan_tids(plans[i], pack.tid_of):
            terms.setdefault(t, len(terms))
    b_pad = 64
    if packed:
        q_idx = bs._pack_order(q_idx, plans, pack.tid_of, b_pad // 2)
        assert q_idx is not None
    eff = bs._effective_kinds(plans, kinds, q_idx, wide)
    w2, nmust, tid_arr = bs.stage_batch_weights(
        plans, eff, q_idx, terms, stats, pack.tid_of, b_pad, wide,
        plans[0].k1, {}, packed=packed,
    )
    return pack, w2, nmust, tid_arr, wide


LANE_CASES = {
    "narrow": (["pure", "neg", "gate"], False),
    "wide": (["exact", "pure"], False),
    "packed": (["exact", "exact"], True),
}


@pytest.mark.parametrize("fine", [1, 2, 4, 8])
@pytest.mark.parametrize("lanes", sorted(LANE_CASES))
def test_phasea_maxima_within_margin_of_reference(segs, lanes, fine):
    """Phase-A maxima of the port's plain version against the reference
    kernel (interpret mode) on the same pack and the same bf16 weights:
    within MARGIN_REL/MARGIN_ABS (the reference rounds each product to
    bf16, the port sums in f32), -inf in the same places, and -inf over
    the padded blocks."""
    kinds, packed = LANE_CASES[lanes]
    pack, w2, nmust, tid_arr, wide = phasea_inputs(segs, kinds, packed)
    nb = pack.n_blocks
    nb_pad = ref_bs._nb_pad(nb)
    offs = np.zeros(nb_pad + 1, dtype=np.int32)
    offs[: nb + 1] = pack.chunk_offs
    offs[nb + 1 :] = pack.chunk_offs[-1]
    doc = pack.d_doc.numpy()
    tid = pack.d_tid.numpy()
    con = pack.d_con.to(torch.float32).numpy()
    u_pad, lanes_w = w2.shape
    b_pad = nmust.shape[1]
    call = ref_bs.phasea_callable(nb_pad, u_pad, b_pad, wide, True,
                                  packed=packed, fine=fine)
    want = np.asarray(call(
        jnp.asarray(offs), jnp.asarray(doc), jnp.asarray(tid),
        jnp.asarray(con, dtype=jnp.bfloat16),
        jnp.asarray(w2, dtype=jnp.bfloat16), jnp.asarray(tid_arr),
        jnp.asarray(nmust),
    ))

    slot_of = np.full(pack.n_terms, -1, dtype=np.int32)
    for s, t in enumerate(tid_arr[0]):
        if t >= 0:
            slot_of[t] = s
    got = bs.phasea(
        torch.from_numpy(offs), pack.d_doc, pack.d_tid, pack.d_con,
        torch.from_numpy(w2).to(torch.bfloat16), torch.from_numpy(slot_of),
        torch.from_numpy(nmust[0].copy()), fine,
    ).numpy()
    assert got.shape == want.shape == (nb_pad, fine, b_pad)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    assert fin[:nb].any() and not fin[nb:].any()
    err = np.abs(got[fin] - want[fin])
    assert (err <= np.abs(want[fin]) * bs.MARGIN_REL + bs.MARGIN_ABS).all()


def test_postproc_matches_reference():
    """The torch postproc selects the reference XLA postproc's candidate
    fine blocks and finite counts from the same maxima."""
    rng = np.random.default_rng(5)
    nb_pad, fine, b_pad = 16, 2, 64
    amax = rng.standard_normal((nb_pad, fine, b_pad)).astype(np.float32)
    amax[rng.random(amax.shape) < 0.3] = -np.inf
    shift = rng.standard_normal(b_pad).astype(np.float32)
    limidx = rng.integers(-1, 12, b_pad).astype(np.int32)
    margin = np.where(rng.random(b_pad) < 0.5, bs.GATE_MARGIN, 0.0).astype(
        np.float32
    )
    words = np.asarray(ref_bs._build_postproc(nb_pad, b_pad, fine)(
        jnp.asarray(amax), jnp.asarray(shift), jnp.asarray(limidx),
        jnp.asarray(margin),
    ))
    mask, count = bs.postproc(*(torch.from_numpy(a) for a in
                                (amax, shift, limidx, margin)))
    np.testing.assert_array_equal(count.numpy(), words[-1])
    for q in range(b_pad):
        want = ref_bs._unpack_mask(words[:-1, q], nb_pad * fine)
        np.testing.assert_array_equal(np.nonzero(mask[:, q].numpy())[0], want)
