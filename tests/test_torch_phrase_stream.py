"""Port phrase stream (fugu_tpu_torch.ops.phrase_stream) against the
reference's Pallas phrase kernel in interpret mode, its
batch_phrase_search and NamedIndex, and the NumPy oracle.

The port runs its plain PyTorch version here (CPU tensors); the CUDA
kernel is held to the same plain version on the card by chip_smoke.py.
Both kernels compute IEEE f32 scores from the same integer phrase tf,
so the maxima must agree bit for bit (max abs error 0.0) and the
classes exactly; final hits must be bit-identical to the oracle.
"""

import dataclasses
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from fugu_tpu.engine.named_index import NamedIndex as RefNamedIndex
from fugu_tpu.index import segment as ref_segment
from fugu_tpu.index.schema import DOCS_SCHEMA, IndexType
from fugu_tpu.index.segment import SegmentBuilder
from fugu_tpu.ops import oracle as ref_oracle
from fugu_tpu.ops import phrase_stream as ref_ps
from fugu_tpu.query import Occur, PhraseClause, QueryGroup, QueryPlan, TermClause
from fugu_tpu.records import ObjectRecord
from fugu_tpu_torch import query as pq
from fugu_tpu_torch.engine.named_index import NamedIndex
from fugu_tpu_torch.index import segment as port_segment
from fugu_tpu_torch.index.schema import IndexType as PortIndexType
from fugu_tpu_torch.ops import oracle, residency
from fugu_tpu_torch.ops import phrase_stream as ps

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
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
    return pq.QueryPlan(
        groups=tuple(
            pq.QueryGroup(
                pq.Occur(g.occur.value),
                tuple(
                    pq.TermClause(c.field, c.term, c.boost, c.is_facet)
                    for c in g.clauses
                ),
                tuple(
                    pq.PhraseClause(ph.field, ph.terms, ph.boost, ph.slop)
                    for ph in g.phrases
                ),
            )
            for g in plan.groups
        ),
        require_should=plan.require_should,
        k1=plan.k1,
        b=plan.b,
    )


def _phrase_plan(words, occur=Occur.SHOULD, slop=0, boost=1.0):
    return QueryPlan(
        groups=(
            QueryGroup(
                occur,
                phrases=(
                    PhraseClause("text", tuple(words), slop=slop, boost=boost),
                ),
            ),
        )
    )


def _f32(res):
    return None if res is None else [(np.float32(s), int(d)) for s, d in res]


def _build(docs, tomb_every=None):
    """A reference-built segment and its port copy."""
    b = SegmentBuilder(DOCS_SCHEMA)
    for vals, sid in docs:
        b.add_document({"text": vals}, stored={"id": sid})
    ref = b.build()
    if tomb_every:
        ref.tombstones[::tomb_every] = True
    return ref, to_port(ref)


@pytest.fixture(scope="module")
def segs():
    """tests/test_phrase_stream.py's corpus: 2600 docs over 30 words
    (> 4 blocks of 512 docs), a multi-value field on every 7th doc, one
    long doc that spans several 2048-row chunks, tombstones every 37th."""
    rng = np.random.default_rng(5)
    words = [f"w{i}" for i in range(30)]
    docs = []
    for i in range(2600):
        n = int(rng.integers(4, 30))
        text = " ".join(rng.choice(words, size=n))
        vals = [text]
        if i % 7 == 0:
            vals = [text, " ".join(rng.choice(words, size=5))]
        docs.append((vals, f"d{i}"))
    docs.append(
        ([" ".join(["w1 w2"] * 1500 + ["w3 w4 w5 w6 w7 w8 w9 w10"])], "long")
    )
    return _build(docs, tomb_every=37)


def assert_search_matches(segs, plans, limits):
    """Port, reference (interpret mode) and oracle agree bit for bit;
    returns the port's results."""
    ref, port = segs
    ref_stats = ref_oracle.IndexStats([ref])
    stats = oracle.IndexStats([port])
    pplans = [to_port_plan(p) for p in plans]
    launches = ps.launches
    got = ps.batch_phrase_search(port, pplans, stats, limits, CPU)
    assert ps.launches == launches  # CPU tensors: the plain version ran
    want = ref_ps.batch_phrase_search(ref, plans, ref_stats, limits,
                                      interpret=True)
    for p, lim, g, w in zip(pplans, limits, got, want):
        assert _f32(g) == _f32(w), p
        if g is not None:
            exp = [(np.float32(h.score), h.doc)
                   for h in oracle.search([port], p, lim, stats)]
            assert _f32(g) == exp, p
    return got


def test_two_term_parity(segs):
    rng = np.random.default_rng(3)
    plans = []
    for _ in range(24):
        w = rng.integers(0, 30, size=2)
        plans.append(_phrase_plan([f"w{w[0]}", f"w{w[1]}"]))
    got = assert_search_matches(segs, plans, [10] * len(plans))
    assert all(g is not None for g in got)


def test_variable_lengths_and_limits(segs):
    plans = [
        _phrase_plan(["w1"]),                      # single term
        _phrase_plan(["w1", "w2", "w1"]),          # repeated term slots
        _phrase_plan(["w3", "w4", "w5", "w6"]),
        _phrase_plan(["w3", "w4", "w5", "w6", "w7", "w8", "w9", "w10"]),
        _phrase_plan(["w0", "zzz-absent"]),        # absent term -> []
        _phrase_plan(["w2", "w0"], occur=Occur.MUST),
        _phrase_plan(["w5", "w9"], boost=2.5),
    ]
    got = assert_search_matches(segs, plans, [5, 10, 10, 10, 10, 100, 7])
    assert all(g is not None for g in got)
    assert got[4] == []


def test_long_doc_chunk_overlap(segs):
    """The 1500x "w1 w2" doc: pairs straddle chunk boundaries, and each
    anchor counts once, so its tf (1500) makes it the top hit."""
    got = assert_search_matches(segs, [_phrase_plan(["w1", "w2"])], [3])
    assert got[0][0][1] == segs[1].doc_count - 1


def test_tombstones_drop_out(segs):
    plans = [_phrase_plan([f"w{i}", f"w{(i + 1) % 30}"]) for i in range(12)]
    got = assert_search_matches(segs, plans, [50] * 12)
    dead = set(np.nonzero(segs[1].tombstones)[0].tolist())
    for g in got:
        assert g is not None and not ({d for _s, d in g} & dead)


def test_ineligible_plans_fall_through(segs):
    deep_slop = _phrase_plan(["w1", "w2"], slop=3)  # > MAX_SLOP
    wide_slop = _phrase_plan([f"w{i}" for i in range(8)], slop=1)
    multi = QueryPlan(groups=(
        QueryGroup(Occur.SHOULD, phrases=(PhraseClause("text", ("w1", "w2")),)),
        QueryGroup(Occur.SHOULD, (TermClause("text", "w3"),)),
    ))
    nine = _phrase_plan([f"w{i}" for i in range(9)])
    plans = [deep_slop, wide_slop, multi, nine]
    for p in plans:
        assert ps.eligible_phrase(to_port_plan(p)) is None
    assert assert_search_matches(segs, plans, [10] * 4) == [None] * 4


def test_slop_parity(segs):
    rng = np.random.default_rng(9)
    plans, limits = [], []
    for _ in range(20):
        k = int(rng.integers(2, 5))
        w = rng.integers(0, 30, size=k)
        plans.append(
            _phrase_plan([f"w{x}" for x in w], slop=int(rng.integers(1, 3)))
        )
        limits.append(int(rng.choice([3, 10, 50])))
    plans.append(_phrase_plan(["w1", "w2"]))  # slop 0: its own dispatch
    limits.append(10)
    got = assert_search_matches(segs, plans, limits)
    assert all(g is not None for g in got)


def test_slop_long_doc_and_bounds(segs):
    """Sloppy adjacency across chunk boundaries, the 7-term slop-2
    phrase at the eligibility edge, and a sloppy boost."""
    plans = [
        _phrase_plan(["w1", "w3"], slop=1),
        _phrase_plan(["w1", "w2"], slop=2),
        _phrase_plan([f"w{i}" for i in range(3, 10)], slop=2),
        _phrase_plan(["w2", "w5"], slop=2, boost=1.7),
    ]
    got = assert_search_matches(segs, plans, [10, 5, 10, 10])
    assert all(g is not None for g in got)


def test_multivalue_gap_blocks_adjacency():
    two = _build([(["alpha beta", "gamma delta"], "a"),
                  (["alpha beta gamma delta"], "b")])
    got = assert_search_matches(two, [_phrase_plan(["beta", "gamma"])], [10])
    assert [d for _s, d in got[0]] == [1]  # doc 0's gap blocks the match


@pytest.mark.parametrize("skip", [False, True])
def test_topk_truncation_with_pervasive_ties(monkeypatch, skip):
    """More matching fine blocks than PHRASE_TOPK, all of one (tf, fid)
    class.  As the reference's case, collect finds colliding classes
    near the kth score and falls back to the full match.  With the
    collision check answering "none" (true of this corpus, whose blocks
    share one class) collect must skip the unshipped ties without the
    full match, which is right only when the postproc ships the LOWEST
    block ids among the tied maxima."""
    from fugu_tpu_torch.ops import phrase as port_phrase

    n = (ps.PHRASE_TOPK + 8) * ps.BM_FINE_DOCS
    tied = _build([(["foo bar baz qux"], f"d{i}") for i in range(n)])
    if skip:
        def full_match(*args, **kwargs):
            raise AssertionError("collect fell back to the full match")

        monkeypatch.setattr(ps, "_class_collides", lambda *args: False)
        monkeypatch.setattr(port_phrase, "PhraseMatcher", full_match)
    for lim in (3, 10):
        got = assert_search_matches(tied, [_phrase_plan(["foo", "bar"])],
                                    [lim])
        assert [d for _s, d in got[0]] == list(range(lim))


def test_build_stream_arrays_matches_reference(segs):
    ref, port = segs
    chunks = {}
    for lo, hi in ((0, None), (700, 2100)):
        want = ref_ps.build_stream_arrays(
            ref, "text", ref_oracle.IndexStats([ref]), lo, hi
        )
        got = ps.build_stream_arrays(
            port, "text", oracle.IndexStats([port]), lo, hi
        )
        for name in ("pack", "cv", "fid", "chunk_offs"):
            np.testing.assert_array_equal(getattr(got, name),
                                          getattr(want, name))
        for name in ("tid_of", "n_blocks", "nb_pad", "n_terms", "ok"):
            assert getattr(got, name) == getattr(want, name)
        chunks[lo] = np.diff(got.chunk_offs)
    # block 5 holds 40 short docs and the long doc, which spans chunks
    assert chunks[0][5] >= 2 and chunks[0][6:].sum() == 0


#: batches whose dispatch groups the kernels are compared on:
#: (words, slop, boost) per plan
def _kernel_batch(name):
    rng = np.random.default_rng(len(name))

    def words(k):
        return [f"w{x}" for x in rng.integers(0, 30, size=k)]

    if name == "slop0":
        specs = [(["w1"], 0, 1.0), (["w1", "w2", "w1"], 0, 1.0),
                 (["w3", "w4", "w5", "w6", "w7", "w8", "w9", "w10"], 0, 1.0),
                 (["w0", "zzz-absent"], 0, 1.0), (["w5", "w9"], 0, 2.5)]
        specs += [(words(2), 0, 1.0) for _ in range(10)]
    elif name == "sloppy":
        specs = [([f"w{i}" for i in range(3, 10)], 2, 1.0),
                 (["w2", "w5"], 2, 1.7), (["w1", "w3"], 1, 1.0)]
        specs += [(words(int(rng.integers(2, 5))), int(rng.integers(1, 3)),
                   1.0) for _ in range(12)]
    elif name == "wide":  # more than 64 queries: b_pad 128
        specs = [(words(2), 0, 1.0) for _ in range(80)]
    else:  # "mixed": slop 0 and sloppy plans in one batch, two groups
        specs = [(words(int(rng.integers(1, 4))), int(rng.integers(0, 3)),
                  float(rng.choice([1.0, 0.5, 3.0]))) for _ in range(30)]
    return [_phrase_plan(w, slop=s, boost=b) for w, s, b in specs]


KERNEL_BATCHES = ["slop0", "sloppy", "wide", "mixed"]


def _groups(segs, name):
    """(port pack, reference pack, [(port plans by index, q_idx, smax)])
    for the dispatch groups of one batch, as phrase_stream_begin forms
    them."""
    ref, port = segs
    plans = [to_port_plan(p) for p in _kernel_batch(name)]
    stats = oracle.IndexStats([port])
    arrs = ps.build_stream_arrays(port, "text", stats)
    ref_arrs = ref_ps.build_stream_arrays(ref, "text",
                                          ref_oracle.IndexStats([ref]))
    clauses = {i: ps.eligible_phrase(p) for i, p in enumerate(plans)}
    assert all(c is not None for c in clauses.values())
    run = [i for i, c in clauses.items()
           if all(t in arrs.tid_of for t in c.terms)]
    return arrs, ref_arrs, clauses, ps.split_dispatch_groups(run, clauses)


@pytest.mark.parametrize("name", KERNEL_BATCHES)
def test_stage_group_matches_reference_weights(segs, name):
    """The compact operands encode exactly the reference's bf16 weight
    planes, union term ordinals and phrase weights."""
    arrs, _ref_arrs, clauses, groups = _groups(segs, name)
    stats = oracle.IndexStats([segs[1]])
    for q_idx, smax in groups:
        w, tid_arr, wp, u_pad, b_pad, kmax = ref_ps.stage_group_weights(
            arrs.tid_of, q_idx, clauses, stats, smax
        )
        qterm, qslop, pwp, slot_of, pu, pb, pk = ps.stage_group(
            arrs.tid_of, arrs.n_terms, q_idx, clauses, stats, smax
        )
        assert (pu, pb, pk) == (u_pad, b_pad, kmax)
        assert qterm.shape == (b_pad, kmax) and slot_of.shape == (
            arrs.n_terms,)
        np.testing.assert_array_equal(pwp, wp[0])
        rebuilt = np.zeros_like(w)
        for qi in range(b_pad):
            for jj in range(kmax):
                s = qterm[qi, jj]
                if s < 0:
                    if qterm[qi, 0] >= 0:  # dead slot of a live query
                        rebuilt[jj * (smax + 1) * u_pad + u_pad - 1, qi] = 1
                    continue
                n_shift = 1 if jj == 0 else qslop[qi] + 1
                for ss in range(n_shift):
                    rebuilt[(jj * (smax + 1) + ss) * u_pad + s, qi] = 1
        np.testing.assert_array_equal(rebuilt, w)
        tids = np.full(u_pad, -2, dtype=np.int32)
        tids[u_pad - 1] = -3
        for t, s in enumerate(slot_of):
            if s >= 0:
                tids[s] = t
        np.testing.assert_array_equal(tids, tid_arr[0])


@pytest.mark.parametrize("name", KERNEL_BATCHES)
def test_plain_kernel_matches_reference_kernel(segs, name, monkeypatch):
    """phrase_stream_plain against the reference's Pallas kernel in
    interpret mode on every dispatch group: acls exactly equal, amax
    bit-identical (max abs error 0.0).  The plain version runs once with
    its default working-set bounds and once cut to one block and a few
    pairs per step."""
    arrs, ref_arrs, clauses, groups = _groups(segs, name)
    stats = oracle.IndexStats([segs[1]])
    seen = set()
    for q_idx, smax in groups:
        w, tid_arr, wp, u_pad, b_pad, kmax = ref_ps.stage_group_weights(
            ref_arrs.tid_of, q_idx, clauses, stats, smax
        )
        seen.add((smax, b_pad, kmax))
        fn = ref_ps._get_kernel(ref_arrs.nb_pad, u_pad, b_pad, kmax, smax,
                                True)
        want_max, want_cls = (np.asarray(a) for a in fn(
            jnp.asarray(ref_arrs.chunk_offs), jnp.asarray(ref_arrs.pack),
            jnp.asarray(ref_arrs.cv), jnp.asarray(ref_arrs.fid),
            jnp.asarray(w, dtype=jnp.bfloat16), jnp.asarray(tid_arr),
            jnp.asarray(wp),
        ))
        qterm, qslop, pwp, slot_of, *_ = ps.stage_group(
            arrs.tid_of, arrs.n_terms, q_idx, clauses, stats, smax
        )
        args = [torch.from_numpy(a) for a in (
            arrs.chunk_offs, arrs.pack, arrs.cv, arrs.fid, qterm, qslop,
            pwp, slot_of)] + [smax]
        outs = [ps.phrase_stream(*args)]
        with monkeypatch.context() as m:
            m.setattr(ps, "_PLAIN_TF_ELEMS", 1)
            m.setattr(ps, "_PLAIN_PAIRS", 7)
            outs.append(ps.phrase_stream_plain(*args))
        for got_max, got_cls in outs:
            assert got_max.shape == (ref_arrs.nb_pad, ps.FINE_PER_BLOCK,
                                     b_pad)
            np.testing.assert_array_equal(got_cls.numpy(), want_cls)
            np.testing.assert_array_equal(
                got_max.numpy().view(np.int32), want_max.view(np.int32)
            )
        assert np.isfinite(want_max).any()
    want_keys = {
        "slop0": {(0, 64, 8)}, "sloppy": {(2, 64, 7)},
        "wide": {(0, 128, 2)}, "mixed": {(0, 64, 4), (2, 64, 4)},
    }[name]
    assert seen == want_keys


def test_phrase_post_matches_reference():
    """Postproc on maxima with pervasive ties and -inf: the same top-k
    values, ids (lowest first among ties), classes and finite counts as
    the reference's XLA postproc."""
    rng = np.random.default_rng(4)
    nb_pad, b_pad = 64, 64
    amax = rng.choice(np.float32([0.5, 1.25, 2.0, 3.5]),
                      size=(nb_pad, ps.FINE_PER_BLOCK, b_pad))
    amax[rng.random(amax.shape) < 0.4] = -np.inf
    amax[:, :, :4] = 1.25       # every block tied
    amax[:, :, 4] = -np.inf     # nothing matched
    acls = np.where(np.isfinite(amax),
                    rng.integers(256, 4096, size=amax.shape), -1)
    acls = acls.astype(np.int32)
    want = np.asarray(ref_ps._get_phrase_post(nb_pad, b_pad)(
        jnp.asarray(amax), jnp.asarray(acls)))
    got = ps.phrase_post(torch.from_numpy(amax), torch.from_numpy(acls))
    np.testing.assert_array_equal(got.numpy(), want)


# -- routing -----------------------------------------------------------------


class _FakeStats:
    """Minimal stats shim for the routing cost model: 1M docs, 55M
    corpus tokens (the calibration corpus's shape)."""

    doc_count = 1_000_000
    total_tokens = {"text": 55_000_000}
    fingerprint = None

    def __init__(self, dfs):
        self._dfs = dfs

    def doc_freq(self, field, term):
        return self._dfs.get(term, 0)


def _pplans(pairs):
    return [to_port_plan(_phrase_plan(list(p))) for p in pairs]


def test_want_stream_auto_routing(monkeypatch):
    """Without model inputs, batch size alone decides; the constants
    stand in for the reference's FUGU_PHRASE_STREAM modes."""
    assert not ps.want_stream(ps.PHRASE_AUTO_MIN - 1)
    assert ps.want_stream(ps.PHRASE_AUTO_MIN)
    monkeypatch.setattr(ps, "PHRASE_AUTO_MIN", 10**9)  # "host only"
    assert not ps.want_stream(10_000)
    monkeypatch.setattr(ps, "PHRASE_AUTO_MIN", 1)      # "stream any"
    assert ps.want_stream(1)


def test_want_stream_reads_no_environment(monkeypatch):
    """The port routes as the reference's default auto mode whatever
    the reference's switches say, and its sources read no variable."""
    head = _FakeStats({"a": 963_000, "b": 999_000})
    plans = _pplans([("a", "b")] * 8)
    before = [ps.want_stream(n, plans[:n], head) for n in (1, 8)]
    for var, val in (("FUGU_PHRASE_STREAM", "0"), ("FUGU_PHRASE_MIN_BATCH", "1"),
                     ("FUGU_PHRASE_STREAM_FIXED_MS", "1e9"),
                     ("FUGU_PHRASE_HOST_NS", "0")):
        monkeypatch.setenv(var, val)
    assert [ps.want_stream(n, plans[:n], head) for n in (1, 8)] == before
    assert before == [False, True]
    assert not hasattr(ps, "phrase_stream_mode")
    for mod in ("ops/phrase_stream.py", "engine/named_index.py"):
        src = (REPO / "fugu_tpu_torch" / mod).read_text()
        assert not re.search(r"\bos\.environ|\bgetenv\b", src), mod


def test_want_stream_cost_model():
    """Selective phrases stay on the host; Zipf-head pairs (whose host
    intersection cost explodes) go to the stream."""
    selective = _FakeStats({"a": 5_000, "b": 15_000})
    assert not ps.want_stream(8, plans=_pplans([("a", "b")] * 8),
                              stats=selective)
    head = _FakeStats({"a": 963_000, "b": 999_000})
    head_plans = _pplans([("a", "b")] * 8)
    assert ps.want_stream(8, plans=head_plans, stats=head)
    dead = _FakeStats({"a": 0, "b": 999_000})
    assert not ps.want_stream(8, plans=head_plans, stats=dead)
    assert not ps.want_stream(
        ps.PHRASE_MIN_BATCH - 1,
        plans=head_plans[: ps.PHRASE_MIN_BATCH - 1],
        stats=head,
    )


def test_want_stream_overlap_credit(monkeypatch):
    """With a concurrent device batch, host phrase work hides under it:
    the router streams only when the host estimate exceeds the overlap
    credit by more than the sweep's cost."""
    mid = _FakeStats({"a": 300_000, "b": 300_000})
    plans = _pplans([("a", "b")] * 24)
    assert ps.want_stream(24, plans=plans, stats=mid)
    ov = ps.estimate_device_batch_ms(mid, 232)
    assert ov > 0
    assert not ps.want_stream(24, plans=plans, stats=mid, overlap_ms=ov)
    many = _pplans([("a", "b")] * 256)
    assert ps.want_stream(256, plans=many, stats=mid, overlap_ms=ov)
    # the credit needs the model's inputs; without them nothing streams
    assert not ps.want_stream(256, overlap_ms=ov)
    # overlap credit never re-enables a stream the budget refused
    monkeypatch.setattr(residency, "budget_bytes", lambda: 1)
    assert not ps.want_stream(256, plans=many, stats=mid, overlap_ms=ov)


def test_want_stream_respects_residency_budget(monkeypatch):
    """Routing refuses to stage a token pack that would blow the device
    budget past what is resident; resident token bytes count as free."""
    big = _FakeStats({"a": 963_000, "b": 999_000})
    big.doc_count = 16_000_000
    big.total_tokens = {"text": 880_000_000}
    plans = _pplans([("a", "b")] * 256)
    monkeypatch.setattr(residency, "budget_bytes", lambda: None)
    assert ps.want_stream(256, plans=plans, stats=big)
    monkeypatch.setattr(residency, "budget_bytes", lambda: 13_600_000_000)
    monkeypatch.setattr(
        residency, "stats",
        lambda: {"resident_bytes": 12_900_000_000, "by_kind": {}},
    )
    assert not ps.want_stream(256, plans=plans, stats=big)
    monkeypatch.setattr(
        residency, "stats",
        lambda: {"resident_bytes": 12_900_000_000,
                 "by_kind": {"token_stream": 6_000_000_000}},
    )
    assert ps.want_stream(256, plans=plans, stats=big)


def test_want_stream_model_overrides_auto_min():
    n = ps.PHRASE_AUTO_MIN + 32
    plans = _pplans([("a", "b")] * n)
    assert not ps.want_stream(n, plans=plans,
                              stats=_FakeStats({"a": 300, "b": 900}))
    assert ps.want_stream(n, plans=plans,
                          stats=_FakeStats({"a": 963_000, "b": 999_000}))
    assert ps.want_stream(n)


def test_pack_cached_and_invalidated_on_delete(segs):
    import copy

    s2 = copy.copy(segs[1])
    s2.tombstones = segs[1].tombstones.copy()
    object.__setattr__(s2, "_token_stream", None)
    stats = oracle.IndexStats([s2])
    pack1 = ps.get_token_stream(s2, "text", stats, CPU)
    assert ps.get_token_stream(s2, "text", stats, CPU) is pack1
    assert pack1.d_tok.dtype == torch.int32 and pack1.d_cv.numel() == (
        pack1.nb_pad * 1024)
    assert residency.contains(("tok", id(s2), "text"))
    assert s2.delete_by_term("text", "w0") > 0
    assert not residency.contains(("tok", id(s2), "text"))
    st2 = oracle.IndexStats([s2])
    assert ps.get_token_stream(s2, "text", st2, CPU) is not pack1
    plan = to_port_plan(_phrase_plan(["w1", "w2"]))
    res = ps.batch_phrase_search(s2, [plan], st2, [10], CPU)
    assert _f32(res[0]) == [(np.float32(h.score), h.doc)
                            for h in oracle.search([s2], plan, 10, st2)]


# -- NamedIndex --------------------------------------------------------------


@pytest.fixture(scope="module")
def namespace(tmp_path_factory):
    """Two segments written by the reference NamedIndex over a 30-word
    vocabulary (so phrases match often), with deletes in the first."""
    path = tmp_path_factory.mktemp("phrase_ns") / "docs"
    ni = RefNamedIndex("ns", path, IndexType.DOCS, compaction="off")
    rng = np.random.default_rng(11)
    words = np.array([f"w{i}" for i in range(30)])
    for batch in range(2):
        ni.upsert([
            ObjectRecord(id=f"d{batch}x{i}", text=" ".join(
                rng.choice(words, size=int(rng.integers(4, 30)))))
            for i in range(1300)
        ])
    for i in range(0, 1300, 29):
        ni.delete_document(f"d0x{i}")
    ni.close()
    ni.use_device = False  # the reference's exact host chain
    return path, ni


def _mixed_plans():
    rng = np.random.default_rng(12)
    plans = []
    for i in range(12):
        w = [f"w{x}" for x in rng.integers(0, 30, size=2 + i % 2)]
        plans.append(_phrase_plan(w, slop=1 if i % 4 == 3 else 0))
    for _ in range(12):
        w = rng.choice(30, size=2, replace=False)
        plans.append(QueryPlan(groups=tuple(
            QueryGroup(Occur.SHOULD, (TermClause("text", f"w{x}"),))
            for x in w)))
    return plans


def _force_stream(monkeypatch):
    """Make the cost model send every phrase batch to the stream: a host
    matcher priced at a second per posting."""
    monkeypatch.setattr(ps, "HOST_NS_PER_MIN_POSTING", 1e9)


@pytest.mark.parametrize("forced", [True, False])
def test_named_index_routes_phrases(namespace, monkeypatch, forced):
    """On a namespace written by fugu_tpu: with the stream forced
    through the cost constants every phrase plan is answered by the
    phrase stream; with the TPU-fitted constants this small corpus keeps
    them on the host matcher.  Either way the hits equal the reference
    NamedIndex's and the oracle's."""
    path, ref = namespace
    if forced:
        _force_stream(monkeypatch)
    port = NamedIndex("ns", path, PortIndexType.DOCS, device="cpu")
    assert len(port.segments) == 2
    plans = _mixed_plans()
    pplans = [to_port_plan(p) for p in plans]
    got = port.search_topk_batch(pplans, 10)
    want = ref.search_topk_batch(plans, 10)
    stats = port.stats()
    for p, g, w in zip(pplans, got, want):
        exp = oracle.search(port.segments, p, 10, stats)
        key = [(np.float32(h.score), h.segment_ord, h.doc) for h in exp]
        assert [(np.float32(h.score), h.segment_ord, h.doc) for h in g] == key
        assert [(np.float32(h.score), h.segment_ord, h.doc) for h in w] == key
    n_phrase = 12 * len(port.segments)
    if forced:
        assert port.routes["phrase_stream"] == n_phrase
        assert port.routes["host_only"] == 0
    else:
        assert port.routes["phrase_stream"] == 0
        assert port.routes["host_only"] == n_phrase
    assert port.routes["phase_a"] > 0


@pytest.mark.parametrize("where", ["phrase_stream", "phrase_stream_collect"])
def test_stream_errors_propagate(namespace, monkeypatch, where):
    """No fallback hides the kernel: an error in the launch (begin) or
    in collect comes out of search_topk_batch."""
    path, _ref = namespace
    _force_stream(monkeypatch)

    def boom(*args):
        raise RuntimeError("phrase kernel failed")

    monkeypatch.setattr(ps, where, boom)
    port = NamedIndex("ns", path, PortIndexType.DOCS, device="cpu")
    with pytest.raises(RuntimeError, match="phrase kernel failed"):
        port.search_topk_batch([to_port_plan(p) for p in _mixed_plans()], 10)


def test_smoke_phrase_batch(segs):
    """chip_smoke's 1M phrase batch, built here on the small segment:
    192 two-term plans, 32 of three to four terms, 32 sloppy, all
    eligible for the stream; the sloppy ones form their own group."""
    port = segs[1]
    plans = chip_smoke.make_phrase_batch(port)
    clauses = [ps.eligible_phrase(p) for p in plans]
    assert len(plans) == 256 and all(c is not None for c in clauses)
    lens = [len(c.terms) for c in clauses]
    slops = [c.slop for c in clauses]
    assert lens[:192] == [2] * 192 and set(lens[192:224]) <= {3, 4}
    assert set(slops[:224]) == {0} and set(slops[224:]) <= {1, 2}
    assert 1 in slops and 2 in slops
    groups = ps.split_dispatch_groups(list(range(256)), dict(enumerate(clauses)))
    assert {smax for _q, smax in groups} == {0, 2}
