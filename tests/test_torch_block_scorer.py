"""Port block scorer (fugu_tpu_torch.ops.block_scorer) against the
reference Pallas block scorer in interpret mode and the NumPy oracle.

The port runs its plain PyTorch version here (CPU tensors); the CUDA
kernel is held to the same plain version on the card by chip_smoke.py.
Final hits of all three must be identical: the same score floats in the
same order.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fugu_tpu.index import segment as ref_segment
from fugu_tpu.index.schema import DOCS_SCHEMA
from fugu_tpu.index.segment import SegmentBuilder
from fugu_tpu.ops import oracle as ref_oracle
from fugu_tpu.ops import pallas_scorer as ref_ps
from fugu_tpu.query import Occur, QueryGroup, QueryPlan, TermClause
from fugu_tpu_torch.index import segment as port_segment
from fugu_tpu_torch.ops import block_scorer as ps
from fugu_tpu_torch.ops import oracle
from fugu_tpu_torch.ops.staging import mask_i32, stage_clauses
from fugu_tpu_torch.query import (
    Occur as POccur,
    QueryGroup as PQueryGroup,
    QueryPlan as PQueryPlan,
    TermClause as PTermClause,
)

torch.set_num_threads(1)

CPU = torch.device("cpu")
VOCAB = [f"w{i}" for i in range(60)]


def make_ref_segment(n_docs=5000, seed=0):
    """tests/test_pallas_scorer.py's corpus, built by the reference."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, len(VOCAB) + 1)
    p /= p.sum()
    b = SegmentBuilder(DOCS_SCHEMA)
    for i in range(n_docs):
        words = rng.choice(VOCAB, size=int(rng.integers(2, 30)), p=p)
        b.add_document(
            {"text": [" ".join(words)]},
            facets=[f"/cat/{int(rng.integers(0, 5))}"],
            stored={"id": f"d{i}"},
        )
    return b.build()


def to_port(seg):
    """The same frozen segment as a port Segment (arrays copied)."""
    kw = {
        f.name: getattr(seg, f.name)
        for f in dataclasses.fields(ref_segment.Segment)
        if f.init and not f.name.startswith("_")
    }
    kw["tombstones"] = seg.tombstones.copy()
    return port_segment.Segment(**kw)


def to_port_plan(plan):
    """Rebuild a reference QueryPlan from the port's query classes."""
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
    ref = make_ref_segment()
    return ref, to_port(ref)


def f32_hits(hits):
    return [(np.float32(s), int(d)) for s, d in hits]


def run_three(ref, port, plans, limit):
    """(port, reference, oracle) hit lists for each plan."""
    ref_stats = ref_oracle.IndexStats([ref])
    stats = oracle.IndexStats([port])
    pplans = [to_port_plan(p) for p in plans]
    got = ps.block_search_batch(port, pplans, stats, limit, CPU)
    want = ref_ps.pallas_search_batch(ref, plans, ref_stats, limit,
                                      interpret=True)
    exp = [
        [(h.score, h.doc) for h in oracle.search([port], p, limit, stats)]
        for p in pplans
    ]
    return got, want, exp


def assert_identical(ref, port, plans, limit):
    got, want, exp = run_three(ref, port, plans, limit)
    for g, w, e in zip(got, want, exp):
        assert g is not None and w is not None
        assert f32_hits(g) == f32_hits(e), (g[:3], e[:3])
        assert f32_hits(w) == f32_hits(e), (w[:3], e[:3])


def plan_terms(*words, occur=Occur.SHOULD):
    return QueryPlan(
        groups=tuple(QueryGroup(occur, (TermClause("text", w),)) for w in words)
    )


CASES = {
    "single_term": (plan_terms("w0"), 10),
    "sparse_term": (plan_terms("w55"), 20),
    "multi_term_or": (plan_terms("w0", "w3", "w9"), 15),
    "must": (plan_terms("w0", "w1", occur=Occur.MUST), 25),
    "mustnot": (
        QueryPlan(groups=(
            QueryGroup(Occur.SHOULD, (TermClause("text", "w0"),)),
            QueryGroup(Occur.MUST_NOT, (TermClause("text", "w1"),)),
        )),
        20,
    ),
    "facet_filter": (
        QueryPlan(groups=(
            QueryGroup(Occur.MUST, (TermClause("text", "w1"),)),
            QueryGroup(Occur.MUST, (TermClause("", "/cat/2", is_facet=True),)),
        )),
        20,
    ),
    # group index 31 sets bit 2**31: the int32 mask must wrap
    "group_bit_31": (
        QueryPlan(groups=(
            (QueryGroup(Occur.SHOULD, (TermClause("text", "w0"),)),)
            + tuple(QueryGroup(Occur.SHOULD, ()) for _ in range(30))
            + (QueryGroup(Occur.MUST_NOT, (TermClause("text", "w1"),)),)
        )),
        20,
    ),
    "k_100": (plan_terms("w1"), 100),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_block_scorer_matches_reference_and_oracle(segs, case):
    plan, limit = CASES[case]
    assert_identical(*segs, [plan], limit)


def test_batched_mixed(segs):
    plans = [
        plan_terms("w0"),
        plan_terms("w1", "w4"),
        plan_terms("w2", "w5", "w7"),
        plan_terms("w50"),
        CASES["must"][0],
        CASES["mustnot"][0],
    ]
    assert_identical(*segs, plans, 10)


def test_tombstones():
    ref = make_ref_segment()
    ref.tombstones[:500] = True
    assert_identical(ref, to_port(ref), [plan_terms("w0", "w2")], 20)


def test_small_segment_and_empty_result():
    ref = make_ref_segment(n_docs=100, seed=3)
    assert_identical(ref, to_port(ref), [plan_terms("w0", "w1")], 10)
    got, want, exp = run_three(ref, to_port(ref), [plan_terms("zzz")], 10)
    assert got == want == exp == [[]]


def test_limit_above_128_declines(segs):
    ref, port = segs
    got, want, _ = run_three(ref, port, [plan_terms("w1")], 129)
    assert got == want == [None]


def test_block_slice_split(segs, monkeypatch):
    """The reference's NB_SPLIT = 1 makes every block its own kernel row,
    whose per-slice top-k lists merge on its host; the port never splits
    a row (its kernel merges the per-block lists itself).  Both must stay
    exact, at k = 16 (limit 10) and k = 128 (limit 100)."""
    assert not hasattr(ps, "NB_SPLIT")
    monkeypatch.setattr(ref_ps, "NB_SPLIT", 1)
    plans = [plan_terms("w0", "w3"), plan_terms("w0", "w5", occur=Occur.MUST)]
    assert_identical(*segs, plans, 10)
    assert_identical(*segs, plans, 100)


def test_scratch_cap_splits_launches(segs, monkeypatch):
    """Rows of one shape whose first-pass scratch would pass
    ``SCRATCH_MAX_BYTES`` go in several launches (one row each at the
    smallest cap), and every result stays exact."""
    plans = [plan_terms("w0"), plan_terms("w1", "w4"),
             plan_terms("w2", "w5", "w7"), CASES["must"][0]]
    rows = []
    score_rows = ps.score_rows

    def counted(*args):
        rows.append(args[1].shape[0])
        return score_rows(*args)

    monkeypatch.setattr(ps, "score_rows", counted)
    assert_identical(*segs, plans, 10)
    whole = list(rows)
    rows.clear()
    monkeypatch.setattr(ps, "SCRATCH_MAX_BYTES", 1)
    assert_identical(*segs, plans, 10)
    assert max(whole) > 1 and set(rows) == {1}
    assert len(rows) == sum(whole)


@pytest.mark.parametrize("mode", ["1", "0"])
def test_inkernel_topk_tie_corpus(monkeypatch, mode):
    """More than 128 docs tie on one score: the doc-asc tie-break decides
    which docs survive extraction, in the top-128 mode ("1") and in the
    dense mode ("0").  The reference takes the mode from its
    FUGU_INKERNEL_TOPK switch; end to end both engines must give the
    oracle's hits, and the port's raw k = 128 extraction in the same
    mode must give the reference kernel's docs."""
    b = SegmentBuilder(DOCS_SCHEMA)
    for i in range(8000):
        text = "foo bar baz qux" if i % 3 == 0 else "filler words only here"
        b.add_document({"text": [text]}, stored={"id": f"t{i}"})
    for i in range(7):
        b.add_document({"text": ["foo foo foo bar"]}, stored={"id": f"hi{i}"})
    ref = b.build()
    ref.tombstones[::97] = True
    monkeypatch.setenv("FUGU_INKERNEL_TOPK", mode)
    ref_ps._SCORER_CACHE.clear()
    plans = [plan_terms("foo", "bar")]
    assert_identical(ref, to_port(ref), plans, 100)
    assert_raw_topk(ref, plans, ps.K_OUT, inkernel=mode == "1")
    ref_ps._SCORER_CACHE.clear()


def test_negative_idf_declines():
    """Tombstone-inflated df flips idf negative: the device engines must
    decline (None) so the host chain serves the negative scores."""
    from fugu_tpu_torch.ops.batch_scorer import batch_search

    b = SegmentBuilder(DOCS_SCHEMA)
    for i in range(5000):
        b.add_document({"text": ["foo bar baz"]}, stored={"id": f"t{i}"})
    ref = b.build()
    ref.tombstones[::61] = True
    port = to_port(ref)
    stats = oracle.IndexStats([port])
    plan = to_port_plan(plan_terms("foo", "bar"))
    exp = oracle.search([port], plan, 50, stats)
    assert exp and exp[0].score < 0  # the regime under test
    assert ps.block_search_batch(port, [plan], stats, 50, CPU) == [None]
    assert batch_search(port, [plan], stats, [50], CPU) == [None]
    ref_stats = ref_oracle.IndexStats([ref])
    assert ref_ps.pallas_search_batch(
        ref, [plan_terms("foo", "bar")], ref_stats, 50, interpret=True
    ) == [None]


def stage_rows(port, plans, stats, t_pad, nb_pad):
    """Kernel-row operands for ``plans`` (one row each, every nonempty
    block), as the reference's scorer call takes them."""
    n_blocks = max((port.doc_count + ps.BLOCK - 1) // ps.BLOCK, 1)
    b = len(plans)
    nblocks = np.zeros(b, np.int32)
    block_ids = np.zeros((b, nb_pad), np.int32)
    starts = np.zeros((b, nb_pad, t_pad), np.int32)
    counts = np.zeros((b, nb_pad, t_pad), np.int32)
    weights = np.zeros((b, t_pad), np.float32)
    c1 = np.ones((b, t_pad), np.float32)
    c2 = np.zeros((b, t_pad), np.float32)
    gbits = np.full((b, t_pad), -1, np.int32)
    masks = np.zeros((b, 3), np.int32)
    need = False
    for bi, plan in enumerate(plans):
        args, must, mustnot, should, need_bits = stage_clauses(
            port, plan, stats, t_pad
        )
        need |= need_bits
        st, ct, nonempty = ps.plan_block_tables(
            port.e_doc, args, t_pad, n_blocks, must, {}
        )
        nb = len(nonempty)
        assert nb <= nb_pad
        nblocks[bi] = nb
        block_ids[bi, :nb] = nonempty
        starts[bi, :nb] = st[nonempty]
        counts[bi, :nb] = ct[nonempty]
        weights[bi], c1[bi], c2[bi] = args.weights, args.c1, args.c2
        for t in range(t_pad):
            bits = int(args.gbits[t])
            gbits[bi, t] = bits.bit_length() - 1 if bits else -1
        masks[bi] = (mask_i32(must), mask_i32(mustnot), mask_i32(should))
    return (nblocks, block_ids, starts, counts, weights, c1, c2, gbits,
            masks), need


def assert_raw_topk(ref, plans, k, inkernel, t_pad=4, nb_pad=32):
    """One kernel dispatch of ``plans`` (one row each) before the host
    rescore, in the reference's scorer call (interpret mode; running
    top-128 in its kernel, or dense scores and its top_k outside it, as
    ``inkernel`` says) and in the port's ``score_rows`` (the row's top k):
    the same candidate docs, and scores within 1e-6 relative.  The
    scores are not bit-equal
    because the reference's interpret-mode kernel scatters through a
    three-way bf16 split of each f32 contribution and an f32 matmul,
    which reproduces the contribution only to a few f32 ulps, while the
    port adds the exact f32 contributions in clause order."""
    port = to_port(ref)
    stats = oracle.IndexStats([port])
    plans = [to_port_plan(p) for p in plans]
    tables, need_bits = stage_rows(port, plans, stats, t_pad, nb_pad)
    e_doc, e_tffid, _ = (np.asarray(a) for a in ref.device_pack())
    tomb = np.asarray(ref.device_tomb_flags())
    call = ref_ps.build_scorer_call(t_pad, nb_pad, k, len(plans), need_bits,
                                    interpret=True, inkernel_topk=inkernel)
    (nblocks, block_ids, starts, counts, *rest) = tables
    want_s, want_d = call(
        jnp.asarray(nblocks), jnp.asarray(block_ids),
        jnp.asarray(starts.reshape(len(plans), -1)),
        jnp.asarray(counts.reshape(len(plans), -1)),
        *(jnp.asarray(a) for a in rest),
        jnp.asarray(e_doc), jnp.asarray(e_tffid), jnp.asarray(tomb),
    )
    want_s = np.asarray(want_s)[:, 0]
    want_d = np.asarray(want_d)[:, 0]

    pack = port_segment.device_pack_from_numpy(e_doc, e_tffid, tomb, CPU)
    t = [torch.from_numpy(a) for a in tables]
    got_s, got_d = ps.score_rows(*t, pack.e_doc, pack.e_tffid, pack.tomb,
                                 need_bits, k)
    got_s, got_d = got_s.numpy(), got_d.numpy()
    assert got_s.shape == want_s.shape
    np.testing.assert_array_equal(got_d, want_d)
    fin = np.isfinite(want_s)
    np.testing.assert_array_equal(np.isfinite(got_s), fin)
    np.testing.assert_allclose(got_s[fin], want_s[fin], rtol=1e-6, atol=0)


@pytest.mark.parametrize("k", [16, 32, 64, 128])
def test_raw_topk_matches_reference_kernel(k):
    """The port's row top k against the reference kernel's raw
    candidates (its dense output and top_k for k < 128, its in-kernel
    top-128 for k = 128), over MUST, MUST_NOT, facet and SHOULD rows with
    tombstones."""
    ref = make_ref_segment()
    ref.tombstones[::11] = True
    plans = [plan_terms("w0", "w3"), CASES["must"][0], CASES["mustnot"][0],
             CASES["facet_filter"][0]]
    assert_raw_topk(ref, plans, k, inkernel=k == ps.K_OUT)


def two_pass(masked, block_ids, nblocks, k):
    """The kernel's two passes in plain torch: each (row, block slot)
    keeps its block's top k in scratch [B, NB, k] (score desc, doc asc),
    then each row's first ``nblocks`` lists merge into its top k, ties
    again to the lower doc.  Returns (scratch scores, scratch docs,
    scores, docs)."""
    n_rows, nb_pad = block_ids.shape
    per_block = masked.reshape(n_rows * nb_pad, ps.BLOCK)
    scr_s, scr_d = ps.topk_dense(per_block, block_ids.reshape(-1, 1), k)
    scr_s = scr_s.reshape(n_rows, nb_pad, k)
    scr_d = scr_d.reshape(n_rows, nb_pad, k)
    listed = torch.arange(nb_pad)[None, :, None] < nblocks[:, None, None]
    cand_s = torch.where(listed, scr_s, float("-inf")).reshape(n_rows, -1)
    cand_d = torch.where(listed, scr_d, ps._INT_MAX).reshape(n_rows, -1)
    sel = torch.topk(ps._order_keys(cand_s, cand_d), k, dim=1).indices
    top_s = torch.gather(cand_s, 1, sel)
    top_d = torch.where(top_s > float("-inf"), torch.gather(cand_d, 1, sel),
                        ps._INT_MAX)
    return scr_s, scr_d, top_s, top_d


@pytest.mark.parametrize("k", [16, 32, 64, 128])
def test_two_pass_select_matches_dense_topk(k):
    """The kernel's decomposition, per-block top-k lists in a [B, NB, k]
    scratch merged per row, gives the plain version's dense top k (docs
    and score bits), on a corpus where more than k docs tie across
    blocks, with tombstones, rows of 1 and of every block, and a row
    with no block."""
    b = SegmentBuilder(DOCS_SCHEMA)
    for i in range(9000):
        text = "foo bar baz" if i % 3 == 0 else f"filler w{i % 7} foo"
        b.add_document({"text": [text]}, stored={"id": f"t{i}"})
    port = to_port(b.build())
    port.tombstones[::31] = True
    stats = oracle.IndexStats([port])
    plans = [to_port_plan(p) for p in (
        plan_terms("foo", "bar"), plan_terms("baz"),
        plan_terms("w3", "w5"), plan_terms("foo", "w1", occur=Occur.MUST),
    )]
    tables, need_bits = stage_rows(port, plans, stats, 4, 8)
    assert need_bits and int(tables[0][0]) == 5
    nblocks = tables[0].copy()
    nblocks[1] = 1  # a row over its first block only
    nblocks[3] = 0  # a row with no block
    t = [torch.from_numpy(a) for a in (nblocks,) + tables[1:]]
    pack = port.device_pack(CPU)
    args = t + [pack.e_doc, pack.e_tffid, pack.tomb, need_bits]
    want_s, want_d = ps.score_rows_plain(*args, k)
    scr_s, scr_d, got_s, got_d = two_pass(ps.masked_scores(*args), t[1],
                                          t[0], k)
    assert scr_s.shape == scr_d.shape == (len(plans), 8, k)
    assert got_s.shape == want_s.shape == (len(plans), k)
    np.testing.assert_array_equal(got_d.numpy(), want_d.numpy())
    np.testing.assert_array_equal(got_s.numpy().view(np.int32),
                                  want_s.numpy().view(np.int32))
    assert np.isfinite(want_s[0].numpy()).all()  # > k tied docs in row 0
