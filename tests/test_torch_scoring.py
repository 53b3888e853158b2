"""The port's small-segment engine (fugu_tpu_torch.ops.scoring) against
the reference's XLA engine (fugu_tpu.ops.scoring, under JAX on the CPU)
and the NumPy oracle.

The port's engine is torch ops, so here it runs the very calls it runs
on the card, on CPU tensors.  ``segment_topk_batch`` is compared on the
same staged operands (numpy, from a seed) with a stated tolerance: the
two sum a doc's clauses in different orders.  The engine's hits, through
``device_search_segment``, ``NamedIndex``, ``Dataset`` and the server,
are compared with tolerance 0: the same score floats in the same order.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fugu_tpu.engine.named_index import NamedIndex as RefNamedIndex
from fugu_tpu.index import segment as ref_segment
from fugu_tpu.index.schema import DOCS_SCHEMA
from fugu_tpu.index.schema import IndexType as RefIndexType
from fugu_tpu.ops import oracle as ref_oracle
from fugu_tpu.ops import scoring as ref_scoring
from fugu_tpu.query import Occur, QueryGroup, QueryPlan, TermClause
from fugu_tpu.records import ObjectRecord as RefObjectRecord
from fugu_tpu_torch import query as pq
from fugu_tpu_torch.engine import named_index as named_index_module
from fugu_tpu_torch.engine.named_index import NamedIndex
from fugu_tpu_torch.index.schema import DOCS_SCHEMA as PORT_DOCS_SCHEMA
from fugu_tpu_torch.index.schema import IndexType
from fugu_tpu_torch.index.segment import DOC_SENTINEL, SegmentBuilder
from fugu_tpu_torch.ops import oracle, scoring
from test_scoring_device import VOCAB, random_segment
from test_torch_block_scorer import to_port, to_port_plan
from test_torch_slice import hits_key, to_ref_plan
from test_torch_writer import PORT, REF

torch.set_num_threads(1)

CPU = torch.device("cpu")

#: segment_topk_batch, port against reference: scores within REL of each
#: other (a run of up to 16 clauses summed in another order, each sum
#: rounded to 2**-24 relative), docs identical wherever the reference's
#: score is further than REL from both neighbours'
REL = 1e-6


# -- the function --------------------------------------------------------------


def synthetic_pack(rng, n_docs=1500, n_terms=40, max_len=500):
    """A flat entry pack of ``n_terms`` postings with sorted unique docs,
    its term table (start, length) and tombstone flags."""
    docs, tffid, table = [], [], []
    for _ in range(n_terms):
        n = int(rng.integers(1, max_len))
        d = np.sort(rng.choice(n_docs, size=n, replace=False))
        tf = rng.integers(1, 6, size=n)
        fid = rng.integers(0, 256, size=n)
        table.append((sum(len(x) for x in docs), n))
        docs.append(d.astype(np.int32))
        tffid.append((tf | (fid << 24)).astype(np.int64).astype(np.int32))
    tomb = rng.random(n_docs) < 0.1
    return np.concatenate(docs), np.concatenate(tffid), table, tomb


def staged_operands(rng, table, b, t_pad, need_bits):
    starts = np.zeros((b, t_pad), np.int32)
    lens = np.zeros((b, t_pad), np.int32)
    for j in range(b):
        n = int(rng.integers(1, t_pad + 1))
        for t, term in enumerate(rng.choice(len(table), n, replace=False)):
            starts[j, t], lens[j, t] = table[term]
    weights = rng.uniform(0.5, 4.0, (b, t_pad)).astype(np.float32)
    c1 = rng.uniform(0.2, 0.5, (b, t_pad)).astype(np.float32)
    c2 = rng.uniform(0.01, 0.1, (b, t_pad)).astype(np.float32)
    groups = rng.choice([0, 1, 2, 31], (b, t_pad))
    gbits = (np.uint32(1) << groups.astype(np.uint32)).astype(np.uint32)
    masks = np.zeros((3, b), np.uint32)
    if need_bits:
        for j in range(b):
            kind = rng.integers(0, 3, size=4)  # per group: must/not/should
            for g, kd in zip((0, 1, 2, 31), kind):
                masks[kd, j] |= np.uint32(1) << np.uint32(g)
            masks[1, j] &= ~gbits[j, 0]  # the first clause is never excluded
    return starts, lens, weights, c1, c2, gbits, masks


@pytest.mark.parametrize("need_bits", [False, True], ids=["nobits", "bits"])
@pytest.mark.parametrize("t_pad", [1, 4, 16])
def test_function_matches_reference(t_pad, need_bits):
    rng = np.random.default_rng(100 + t_pad + need_bits)
    e_doc, e_tffid, table, tomb = synthetic_pack(rng)
    b, l_pad, k = 8, 512, 16
    starts, lens, weights, c1, c2, gbits, masks = staged_operands(
        rng, table, b, t_pad, need_bits)

    size = ref_segment.pack_entry_size(len(e_doc))
    ref_doc = np.full(size, ref_segment.DOC_SENTINEL, np.int32)
    ref_doc[:len(e_doc)] = e_doc
    ref_tffid = np.zeros(size, np.int32)
    ref_tffid[:len(e_doc)] = e_tffid
    words = ref_segment.pack_dead_bits(
        tomb, ref_segment.pack_word_size(len(tomb)))
    want_s, want_d = ref_scoring.segment_topk_batch(
        jnp.asarray(ref_doc), jnp.asarray(ref_tffid), jnp.asarray(words),
        *(jnp.asarray(a) for a in (starts, lens, weights, c1, c2, gbits)),
        *(jnp.asarray(m) for m in masks),
        t_pad=t_pad, l_pad=l_pad, k=k, need_bits=need_bits,
    )
    want_s, want_d = np.asarray(want_s), np.asarray(want_d)

    def i32(a):
        return torch.from_numpy(a.view(np.int32).copy())

    got_s, got_d = scoring.segment_topk_batch(
        torch.from_numpy(e_doc), torch.from_numpy(e_tffid),
        torch.from_numpy(tomb.astype(np.int32)),
        i32(starts), i32(lens), *(torch.from_numpy(a) for a in (weights, c1, c2)),
        i32(gbits), *(i32(m) for m in masks),
        t_pad=t_pad, l_pad=l_pad, k=k, need_bits=need_bits,
    )
    got_s, got_d = got_s.numpy(), got_d.numpy()
    assert got_s.shape == want_s.shape == (b, k)
    hit = np.isfinite(want_s)
    assert hit.any()
    np.testing.assert_array_equal(np.isfinite(got_s), hit)
    np.testing.assert_allclose(got_s[hit], want_s[hit], rtol=REL, atol=0)
    assert (got_d[~hit] == DOC_SENTINEL).all()
    for j in range(b):
        s = want_s[j]
        for i in np.nonzero(hit[j])[0]:
            near = [s[n] for n in (i - 1, i + 1) if 0 <= n < k]
            if i == k - 1:
                continue  # may tie with the first doc left out
            if all(abs(s[i] - x) > REL * abs(s[i]) for x in near):
                assert got_d[j, i] == want_d[j, i], (j, i)


# -- the merge -----------------------------------------------------------------


@pytest.mark.parametrize("shape", [(4, 64), (8, 16), (2, 8)])
def test_merge_matches_reference(shape):
    t, l = shape
    rng = np.random.default_rng(t * l)
    keys = np.full((t, l), DOC_SENTINEL, np.int32)
    for r in range(t):
        n = int(rng.integers(0, l + 1))
        keys[r, :n] = np.sort(rng.choice(3 * l, size=n, replace=False))
    payload = np.arange(t * l, dtype=np.int32).reshape(t, l)
    want = np.asarray(ref_scoring.merge_sorted_rows(
        jnp.asarray(keys), jnp.asarray(payload))[0])
    got, got_p = scoring.merge_sorted_rows(
        torch.from_numpy(keys), torch.from_numpy(payload))
    np.testing.assert_array_equal(got.numpy(), want)
    # payloads travel with their keys, equal keys in row order
    np.testing.assert_array_equal(keys.reshape(-1)[got_p.numpy()], got.numpy())
    real = got.numpy() != DOC_SENTINEL
    same = real[1:] & (got.numpy()[1:] == got.numpy()[:-1])
    assert (np.diff(got_p.numpy())[same] > 0).all()


# -- the engine: tests/test_scoring_device.py's cases --------------------------


def should(*words):
    return QueryPlan(groups=tuple(
        QueryGroup(Occur.SHOULD, (TermClause("text", w),)) for w in words))


def sweep_plans():
    rng = np.random.default_rng(6)
    random_segment(rng, n_docs=200)  # the reference case's draws
    plans = []
    for _trial in range(10):
        n_terms = int(rng.integers(1, 6))
        words = list(rng.choice(VOCAB[:20], size=n_terms, replace=False))
        occurs = rng.choice(
            [Occur.SHOULD, Occur.MUST, Occur.MUST_NOT], size=n_terms,
            p=[0.6, 0.3, 0.1])
        groups = tuple(
            QueryGroup(o, (TermClause("text", w),))
            for w, o in zip(words, occurs))
        if all(o is Occur.MUST_NOT for o in occurs):
            groups += (QueryGroup(Occur.SHOULD, (TermClause("text", "w0"),)),)
        plans.append(QueryPlan(groups=groups))
    return plans


def multifield_segment():
    b = ref_segment.SegmentBuilder(DOCS_SCHEMA)
    b.add_document({"text": ["alpha beta"], "name": ["Gamma"]}, stored={})
    b.add_document({"text": ["gamma"], "name": ["Alpha"]}, stored={})
    b.add_document({"text": ["beta"]}, stored={})
    return b.build()


def engine_case(name):
    """(segments, plans, limit) of one case of the reference's test."""
    seeds = {"single_term": 0, "multi_term_should": 1, "must_and_mustnot": 2,
             "facet_filter_fused": 3, "tombstones": 4}
    if name in seeds:
        segs = [random_segment(np.random.default_rng(seeds[name]))]
    if name == "single_term":
        return segs, [should("w0")], 10
    if name == "multi_term_should":
        return segs, [should("w0", "w3", "w7")], 20
    if name == "must_and_mustnot":
        return segs, [QueryPlan(groups=(
            QueryGroup(Occur.MUST, (TermClause("text", "w0"),)),
            QueryGroup(Occur.MUST, (TermClause("text", "w1"),)),
            QueryGroup(Occur.MUST_NOT, (TermClause("text", "w2"),)),
        ))], 50
    if name == "facet_filter_fused":
        return segs, [QueryPlan(groups=(
            QueryGroup(Occur.MUST, (TermClause("text", "w0"),)),
            QueryGroup(Occur.MUST, (TermClause("", "/cat/2", is_facet=True),)),
        ))], 30
    if name == "multifield_group":
        return [multifield_segment()], [QueryPlan(groups=(
            QueryGroup(Occur.SHOULD, (TermClause("text", "alpha"),
                                      TermClause("name", "alpha"))),
        ))], 10
    if name == "tombstones":
        # 50 of 300 docs dead: df counts them, so w0's idf turns negative
        segs[0].tombstones[:50] = True
        return segs, [should("w0", "w1")], 25
    if name == "multi_segment":
        rng = np.random.default_rng(5)
        return ([random_segment(rng, n_docs=120),
                 random_segment(rng, n_docs=80)],
                [should("w0", "w2", "w4", "w9")], 15)
    assert name == "randomized_sweep"
    return ([random_segment(np.random.default_rng(6), n_docs=200)],
            sweep_plans(), 20)


def f32_hits(hits):
    return [(np.float32(s), int(d)) for s, d in hits]


@pytest.mark.parametrize("name", [
    "single_term", "multi_term_should", "must_and_mustnot",
    "facet_filter_fused", "multifield_group", "tombstones", "multi_segment",
    "randomized_sweep",
])
def test_engine_matches_reference_and_oracle(name):
    """Per segment: the reference's engine, the port's and the oracle
    give the same (score, doc) lists."""
    ref_segs, plans, limit = engine_case(name)
    segs = [to_port(s) for s in ref_segs]
    ref_stats = ref_oracle.IndexStats(ref_segs)
    stats = oracle.IndexStats(segs)
    for plan in plans:
        pplan = to_port_plan(plan)
        for ref_seg, seg in zip(ref_segs, segs):
            exp = [(h.score, h.doc)
                   for h in oracle.search([seg], pplan, limit, stats)]
            got = scoring.device_search_segment(seg, pplan, stats, limit, CPU)
            want = ref_scoring.device_search_segment(
                ref_seg, plan, ref_stats, limit)
            assert got is not None and want is not None
            assert f32_hits(got) == f32_hits(exp)
            assert f32_hits(want) == f32_hits(exp)
    if name == "tombstones":
        assert any(w <= 0 for w in scoring.stage_clauses(
            segs[0], to_port_plan(plans[0]), stats, 4)[0].weights[:2])


def test_fallback_for_match_all():
    ref_seg = random_segment(np.random.default_rng(7), n_docs=10)
    seg = to_port(ref_seg)
    assert ref_scoring.device_search_segment(
        ref_seg, QueryPlan(match_all=True),
        ref_oracle.IndexStats([ref_seg]), 5) is None
    assert scoring.device_search_segment(
        seg, pq.QueryPlan(match_all=True), oracle.IndexStats([seg]), 5,
        CPU) is None


# -- the port's own cases ------------------------------------------------------


def port_segment(n_docs, seed, vocab=300, tombstones=True):
    rng = np.random.default_rng(seed)
    words = np.array([f"w{i}" for i in range(vocab)])
    p = 1.0 / np.arange(1, vocab + 1)
    p /= p.sum()
    b = SegmentBuilder(PORT_DOCS_SCHEMA)
    for i in range(n_docs):
        b.add_document(
            {"text": [" ".join(rng.choice(words, int(rng.integers(2, 30)),
                                          p=p)) + " rare" * (i % 1500 == 7)]},
            facets=[f"/cat/{int(rng.integers(0, 5))}"],
            stored={"id": f"d{i}"},
        )
    seg = b.build()
    if tombstones:
        seg.tombstones[rng.random(n_docs) < 0.1] = True
    return seg


@pytest.fixture(scope="module")
def big():
    """6,000 docs: the head term matches more than 4,096 live docs."""
    seg = port_segment(6000, seed=21)
    return seg, oracle.IndexStats([seg])


def pshould(*words):
    return pq.QueryPlan(groups=tuple(
        pq.QueryGroup(pq.Occur.SHOULD, (pq.TermClause("text", w),))
        for w in words))


def mixed_plans():
    return [
        pshould("w0"),
        pshould("w0", "w1", "w7"),
        pshould("w250", "w299"),
        pq.QueryPlan(groups=(
            pq.QueryGroup(pq.Occur.MUST, (pq.TermClause("text", "w0"),)),
            pq.QueryGroup(pq.Occur.MUST_NOT, (pq.TermClause("text", "w2"),)),
            pq.QueryGroup(pq.Occur.SHOULD, (pq.TermClause("text", "w5"),)),
        )),
        pq.QueryPlan(groups=(
            pq.QueryGroup(pq.Occur.MUST, (pq.TermClause("text", "w1"),)),
            pq.QueryGroup(pq.Occur.MUST,
                          (pq.TermClause("", "/cat/2", is_facet=True),)),
        )),
        pshould(*[f"w{i}" for i in range(3, 14)]),
    ]


def assert_oracle(seg, stats, plans, limit):
    got = scoring.device_search_batch(seg, plans, stats, limit, CPU)
    for p, g in zip(plans, got):
        exp = [(h.score, h.doc) for h in oracle.search([seg], p, limit, stats)]
        assert g is not None
        assert f32_hits(g) == f32_hits(exp)
    return got


@pytest.mark.parametrize("limit", [16, 17, 256, 257, 4096])
def test_limits_match_oracle(big, limit):
    seg, stats = big
    got = assert_oracle(seg, stats, mixed_plans(), limit)
    assert len(got[0]) == limit  # the head term fills every limit


def test_limit_above_the_ladder_is_declined(big):
    seg, stats = big
    assert scoring.device_search_batch(
        seg, mixed_plans(), stats, 4097, CPU) == [None] * 6


@pytest.mark.parametrize("limit", [16, 256])
def test_ties_return_the_lowest_docs(limit):
    b = SegmentBuilder(PORT_DOCS_SCHEMA)
    for i in range(400):
        b.add_document({"text": ["alpha beta"]}, stored={"id": f"d{i}"})
    seg = b.build()
    seg.tombstones[[3, 100]] = True
    stats = oracle.IndexStats([seg])
    live = [d for d in range(400) if d not in (3, 100)][:limit]
    for plan in (pshould("alpha"), pshould("alpha", "beta")):
        got = assert_oracle(seg, stats, [plan], limit)[0]
        assert [d for _s, d in got] == live
        assert len({s for s, _d in got}) == 1


def last_term(seg):
    """(field, term) of the posting that ends the entry pack."""
    return max(
        ((f, t) for f, tm in seg.terms.items() for t in tm),
        key=lambda ft: seg.terms[ft[0]][ft[1]].start,
    )


def test_window_over_the_end_of_the_pack(big):
    """The pack's last posting beside a long one: its window reaches past
    the pack's end, where the index is clamped and the lanes masked."""
    seg, _stats = big
    n = seg.n_entries
    # the sentinel padding after the last posting cut off: the pack
    # ends with its last posting
    seg = dataclasses.replace(
        seg, e_doc=seg.e_doc[:n], e_tf=seg.e_tf[:n], e_fid=seg.e_fid[:n],
        tombstones=seg.tombstones.copy(), _device_pack=None)
    stats = oracle.IndexStats([seg])
    field, term = last_term(seg)
    info = seg.terms[field][term]
    assert info.start + info.doc_freq == n == len(seg.e_doc)
    head = seg.terms["text"]["w0"]
    assert info.start + head.doc_freq > len(seg.device_pack(CPU).e_doc)
    clause = pq.TermClause(field, term, is_facet=(field != "text"))
    plans = [
        pq.QueryPlan(groups=(pq.QueryGroup(pq.Occur.SHOULD, (clause,)),)),
        pq.QueryPlan(groups=(
            pq.QueryGroup(pq.Occur.SHOULD, (pq.TermClause("text", "w0"),)),
            pq.QueryGroup(pq.Occur.SHOULD, (clause,)),
        )),
        pq.QueryPlan(groups=(
            pq.QueryGroup(pq.Occur.MUST, (clause,)),
            pq.QueryGroup(pq.Occur.SHOULD, (pq.TermClause("text", "w0"),)),
        )),
    ]
    for limit in (10, 300):
        assert_oracle(seg, stats, plans, limit)


def test_clauses_a_thousand_times_apart(big):
    seg, stats = big
    head = seg.terms["text"]["w0"].doc_freq
    assert seg.terms["text"]["rare"].doc_freq * 1000 <= head
    assert_oracle(seg, stats, [pshould("w0", "rare"), pshould("rare", "w0")],
                  10)


def test_declines(big):
    seg, stats = big
    wide = pshould(*[f"w{i}" for i in range(17)])
    constrained = pq.QueryPlan(groups=tuple(
        pq.QueryGroup(pq.Occur.MUST if i == 0 else pq.Occur.SHOULD,
                      (pq.TermClause("text", f"nope{i}"),))
        for i in range(33)))
    phrase = pq.QueryPlan(groups=(pq.QueryGroup(
        pq.Occur.SHOULD, (), (pq.PhraseClause("text", ("w0", "w1")),)),))
    absent = pshould("nowhere", "nothing")
    got = scoring.device_search_batch(
        seg, [wide, constrained, pq.QueryPlan(match_all=True), phrase,
              absent, pshould("w0")], stats, 10, CPU)
    assert got[:4] == [None] * 4
    assert got[4] == []
    assert len(got[5]) == 10


@pytest.mark.parametrize("occur", ["must", "mustnot", "should"])
def test_group_31(big, occur):
    """Group 31's bit is the sign bit of the int32 masks."""
    seg, stats = big
    kind = {"must": pq.Occur.MUST, "mustnot": pq.Occur.MUST_NOT,
            "should": pq.Occur.SHOULD}[occur]
    groups = [pq.QueryGroup(pq.Occur.SHOULD, (pq.TermClause("text", "w0"),))]
    groups += [pq.QueryGroup(pq.Occur.SHOULD, ()) for _ in range(30)]
    groups.append(pq.QueryGroup(kind, (pq.TermClause("text", "w3"),)))
    plan = pq.QueryPlan(groups=tuple(groups))
    args, must, mustnot, should_mask, need_bits = scoring.stage_clauses(
        seg, plan, stats, 4)
    assert int(args.gbits[1]) == 1 << 31
    assert (must | mustnot | should_mask) >> 31
    got = assert_oracle(seg, stats, [plan], 50)[0]
    assert got
    w3 = set(seg.postings("text", "w3")[0].tolist())
    if occur == "must":
        assert all(d in w3 for _s, d in got)
    if occur == "mustnot":
        assert not any(d in w3 for _s, d in got)


def test_a_split_batch_equals_the_whole(big, monkeypatch):
    seg, stats = big
    plans = mixed_plans() * 3
    before = scoring.launches
    whole = scoring.device_search_batch(seg, plans, stats, 20, CPU)
    n_whole = scoring.launches - before
    whole_c = scoring.device_candidates(seg, plans, stats, 20, CPU)[1]
    monkeypatch.setattr(scoring, "MAX_BATCH_LANES", 8192)
    before = scoring.launches
    split = scoring.device_search_batch(seg, plans, stats, 20, CPU)
    assert scoring.launches - before > max(n_whole, 3)
    assert split == whole
    # and the same candidate bits before the rescore
    split_c = scoring.device_candidates(seg, plans, stats, 20, CPU)[1]
    assert split_c.keys() == whole_c.keys()
    for i in whole_c:
        for a, b in zip(whole_c[i], split_c[i]):
            np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


# -- routing -------------------------------------------------------------------


@pytest.fixture(scope="module")
def namespace(tmp_path_factory):
    """Three committed segments of 300, 600 and 1,200 docs written by
    the reference NamedIndex, with deletes in the first two."""
    path = tmp_path_factory.mktemp("ns") / "docs"
    ni = RefNamedIndex("ns", path, RefIndexType.DOCS, compaction="off")
    rng = np.random.default_rng(31)
    words = np.array([f"w{i}" for i in range(120)])
    p = 1.0 / np.arange(1, 121)
    p /= p.sum()
    for batch, n in enumerate((300, 600, 1200)):
        ni.upsert([
            RefObjectRecord(
                id=f"d{batch}x{i}",
                text=" ".join(rng.choice(words, int(rng.integers(8, 40)), p=p)),
                facets=[f"/source/{int(rng.integers(0, 4))}"])
            for i in range(n)
        ])
    for i in range(0, 300, 17):
        ni.delete_document(f"d0x{i}")
        ni.delete_document(f"d1x{i + 3}")
    ni.close()
    return path, ni


def routing_plans():
    return [
        pshould("w0"),
        pshould("w1", "w4", "w30"),
        pq.QueryPlan(groups=(
            pq.QueryGroup(pq.Occur.MUST, (pq.TermClause("text", "w2"),)),
            pq.QueryGroup(pq.Occur.MUST_NOT, (pq.TermClause("text", "w3"),)),
        )),
        pq.QueryPlan(groups=(
            pq.QueryGroup(pq.Occur.MUST, (pq.TermClause("text", "w1"),)),
            pq.QueryGroup(pq.Occur.MUST,
                          (pq.TermClause("", "/source/2", is_facet=True),)),
        )),
    ]


def test_segments_route_by_size(namespace, monkeypatch):
    """The constant between the segments' sizes: the two small segments
    take the small-segment engine, the large one the hybrid engine; the
    hits equal the reference NamedIndex's in its default mode and the
    oracle's."""
    path, ref = namespace
    monkeypatch.setattr(named_index_module, "SMALL_SEGMENT_MAX_DOCS", 700)
    monkeypatch.setattr(named_index_module, "DEVICE_MIN_ENTRIES", 1)
    port = NamedIndex("ns", path, IndexType.DOCS, device="cpu")
    assert [s.doc_count for s in port.segments] == [300, 600, 1200]
    assert [named_index_module._engine_name(s) for s in port.segments] == [
        "small_segment", "small_segment", "hybrid"]
    plans = routing_plans()
    got = port.search_topk_batch(plans, 10)
    want = ref.search_topk_batch([to_ref_plan(p) for p in plans], 10)
    stats = port.stats()
    for p, g, w in zip(plans, got, want):
        exp = hits_key(oracle.search(port.segments, p, 10, stats))
        assert hits_key(g) == exp
        assert hits_key(w) == exp
    assert port.routes["small_segment"] == 2 * len(plans)
    assert port.routes.get("phase_a", 0) + port.routes.get(
        "block_scorer", 0) + port.routes.get("host", 0) == len(plans)
    assert port.routes.get("phase_a", 0) + port.routes.get(
        "block_scorer", 0) > 0


def test_default_constant_serves_limit_300(namespace):
    """With the default constant every segment here is small: a term, a
    boolean and a facet-filter plan at limit 300 go through the
    small-segment engine and none reaches the host chain."""
    path, _ref = namespace
    assert named_index_module.SMALL_SEGMENT_MAX_DOCS >= 8192
    port = NamedIndex("ns", path, IndexType.DOCS, device="cpu")
    plans = routing_plans()
    got = port.search_topk_batch(plans, 300)
    stats = port.stats()
    for p, g in zip(plans, got):
        assert hits_key(g) == hits_key(
            oracle.search(port.segments, p, 300, stats))
    assert len(got[0]) == 300
    assert port.routes["small_segment"] == len(plans) * len(port.segments)
    assert port.routes["host"] == 0
    assert not port.routes.get("phase_a") and not port.routes.get(
        "block_scorer")


def test_engine_errors_propagate(namespace, monkeypatch):
    """No fallback hides the device: an error in a dispatch comes out of
    search_topk_batch."""
    path, _ref = namespace

    def boom(*args, **kw):
        raise RuntimeError("dispatch failed")

    monkeypatch.setattr(scoring, "segment_topk_batch", boom)
    port = NamedIndex("ns", path, IndexType.DOCS, device="cpu")
    with pytest.raises(RuntimeError, match="dispatch failed"):
        port.search_topk_batch(routing_plans(), 10)


# -- paging: Dataset and the server --------------------------------------------


def paging_specs():
    rng = np.random.default_rng(41)
    words = np.array([f"w{i}" for i in range(40)])
    return [(f"p{i}", " ".join(rng.choice(words, int(rng.integers(5, 25)))))
            for i in range(700)]


def test_dataset_page_two_matches_reference(tmp_path):
    """Page 2 at 100 a page is limit 200: the port's small-segment
    engine serves it on the device, and the page equals the reference's."""
    out = []
    for pkg in (PORT, REF):
        ds = pkg.Dataset("pages", tmp_path / pkg.name, **pkg.kw)
        ds.ingest([pkg.ObjectRecord(id=i, text=t, namespace="pages")
                   for i, t in paging_specs()])
        out.append((ds, [
            [(r.id, np.float32(r.score)) for r in ds.search(q, [], 1, 100)]
            for q in ("w1 w2", "w3 AND w4", "w5 -w6")
        ]))
    (port_ds, got), (_ref_ds, want) = out
    assert got == want
    assert len(got[0]) == 100
    routes = port_ds.docs().routes
    assert routes["small_segment"] == 3 and routes["host"] == 0
    for ds, _ in out:
        ds.close()


def test_server_page_two(tmp_path):
    """A page-2 request through the port's live server and the
    reference's: equal status and body."""
    from test_torch_server import PairServer

    srv = PairServer(tmp_path)
    try:
        docs = [{"id": i, "text": t, "namespace": "default"}
                for i, t in paging_specs()]
        status, out = srv.post_json("/ingest", {"data": docs})
        assert status == 200 and out["status"] == "success"
        status, out = srv.post_json(
            "/search", {"query": "w1 w2",
                        "page": {"page": 1, "per_page": 100}})
        assert status == 200 and len(out["results"]) == 100
        routes = srv.db.get_dataset("default").docs().routes
        assert routes["small_segment"] > 0 and not routes.get("host")
    finally:
        srv.stop()


# -- the smoke's phase ---------------------------------------------------------


def test_smoke_small_engine_phase_imports_no_jax(tmp_path):
    """A fresh interpreter runs chip_smoke's small-segment phase on the
    CPU at a small size (the ladder on clean and on tombstoned segments,
    the engine against the oracle at every limit, the negative-idf
    regime) without importing JAX, fugu_tpu or Triton."""
    import json
    import os
    import subprocess
    import sys
    import textwrap
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    script = textwrap.dedent(f"""
        import sys
        from pathlib import Path
        import torch
        import chip_smoke

        chip_smoke.phase_small_engine(
            torch.device("cpu"), "[cpu]", "cpu", Path({str(tmp_path)!r}),
            check_docs=(1500, 4000), ladder_docs=(1000, 4000),
            vocab_size=800, n_plans=48)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "fugu_tpu",
                                            "triton", "yaml", "aiohttp"))
        print("LOADED", bad)
    """)
    proc = subprocess.run(
        [sys.executable, "-c", script], cwd=str(repo),
        env=dict(os.environ, PYTHONPATH=str(repo)),
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LOADED []" in proc.stdout
    rungs = [json.loads(line) for line in proc.stdout.splitlines()
             if line.startswith('{"phase": "ladder"')]
    assert [(r["docs"], r["tombstoned"]) for r in rungs] == [
        (1000, 0.0), (4000, 0.0), (1000, 0.1), (4000, 0.1)]
    assert all(r["small_dispatches"] >= 1 and len(r["small_turn_ms"]) == 2
               for r in rungs)
    assert proc.stdout.count("results bit-identical to the oracle") == 3
