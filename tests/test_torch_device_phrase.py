"""The port's device phrase path (fugu_tpu_torch.ops.device_phrase)
against the reference's (fugu_tpu.ops.device_phrase, its XLA program
under JAX on the CPU), the host matcher and the oracle.

Every case of tests/test_device_phrase.py runs on both packages: the
reference on its segment, the port with ``device="cpu"`` on a copy of
it.  Results are compared with tolerance 0 (the same docs, the same f32
score bits), and the device candidates before the rescore are compared
too: the port's torch ops must pick what ``lax.top_k`` picks, ties
included.  Then the wiring: ``NamedIndex.search_topk_batch`` and
``bench.device_run`` with ``FUGU_DEVICE_PHRASE=1`` against the
reference's with the same switch, the residency of the positions, and
the module's imports.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import bench as ref_bench
from fugu_tpu.engine.named_index import NamedIndex as RefNamedIndex
from fugu_tpu.index.schema import DOCS_SCHEMA, IndexType
from fugu_tpu.index.segment import SegmentBuilder
from fugu_tpu.ops import device_phrase as ref_dp
from fugu_tpu.ops import oracle as ref_oracle
from fugu_tpu.query import Occur, PhraseClause, QueryGroup, QueryPlan
from fugu_tpu.query import TermClause
from fugu_tpu.records import ObjectRecord
from fugu_tpu_torch import bench
from fugu_tpu_torch.engine.named_index import NamedIndex
from fugu_tpu_torch.index.schema import IndexType as PortIndexType
from fugu_tpu_torch.ops import device_phrase as dp
from fugu_tpu_torch.ops import oracle, residency
from fugu_tpu_torch.ops.blockmax import search_blockmax
from fugu_tpu_torch.parallel.sharded import make_mesh
from test_torch_phrase_stream import to_port, to_port_plan

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def books():
    """Residency books empty, no budget, around every case."""
    residency.reset_for_test()
    yield
    residency.reset_for_test()


def build(docs, tomb_every=None):
    """A reference-built segment of ``docs`` (text, stored id) and its
    port copy."""
    b = SegmentBuilder(DOCS_SCHEMA)
    for text, sid in docs:
        b.add_document({"text": [text]}, stored={"id": sid})
    ref = b.build()
    if tomb_every:
        ref.tombstones[::tomb_every] = True
    return ref, to_port(ref)


@pytest.fixture(scope="module")
def segs():
    """tests/test_device_phrase.py's corpus: 4,000 docs over 30 words,
    every 37th tombstoned."""
    rng = np.random.default_rng(21)
    words = [f"p{i}" for i in range(30)]
    docs = []
    for i in range(4000):
        n = int(rng.integers(4, 30))
        docs.append((" ".join(rng.choice(words, size=n)), f"d{i}"))
    return build(docs, tomb_every=37)


def phrase_plan(terms, slop=0):
    return QueryPlan(
        groups=(
            QueryGroup(
                Occur.SHOULD,
                phrases=(PhraseClause("text", tuple(terms), slop=slop),),
            ),
        )
    )


def f32(res):
    return None if res is None else [(np.float32(s), int(d)) for s, d in res]


def host_result(port, plan, stats, limit):
    r = search_blockmax(port, plan, stats, limit)
    assert r is not None
    return f32(r)


def ref_candidates(handle):
    """{plan index: (top_s, top_d, overflow)} of the reference's staged
    XLA programs."""
    return {qi: tuple(np.asarray(a) for a in out) for qi, out in handle[1]}


def both(segs, plans, limit, check_candidates=True):
    """The plans through both packages' begin / collect; the results and
    (where ``check_candidates``) the staged candidates must be equal.
    Returns (port results, port handle)."""
    ref, port = segs
    ref_stats = ref_oracle.IndexStats([ref])
    stats = oracle.IndexStats([port])
    pplans = [to_port_plan(p) for p in plans]
    ref_handle = ref_dp.device_phrase_begin(ref, plans, ref_stats, limit)
    handle = dp.device_phrase_begin(port, pplans, stats, limit, CPU)
    assert sorted(qi for qi, _ in handle.staged) == sorted(
        qi for qi, _ in ref_handle[1])
    if check_candidates:
        want = ref_candidates(ref_handle)
        for qi, top_s, top_d, overflow in dp.device_phrase_fetch(handle):
            w_s, w_d, w_o = want[qi]
            assert overflow == int(w_o)
            np.testing.assert_array_equal(top_d, w_d)
            np.testing.assert_array_equal(top_s.view(np.uint32),
                                          w_s.view(np.uint32))
    want = ref_dp.device_phrase_collect(ref_handle)
    got = dp.device_phrase_collect(handle)
    assert [f32(g) for g in got] == [f32(w) for w in want]
    return got, handle


# -- the cases of tests/test_device_phrase.py ---------------------------------


def test_two_and_three_term_parity(segs):
    stats = oracle.IndexStats([segs[1]])
    rng = np.random.default_rng(5)
    plans = []
    for _ in range(16):
        k = int(rng.integers(2, 4))
        terms = [f"p{int(t)}" for t in rng.choice(30, size=k, replace=False)]
        plans.append(phrase_plan(terms))
    res, handle = both(segs, plans, 10)
    assert sum(r is not None for r in res) == len(plans)
    assert handle.outcome == ["staged"] * len(plans)
    for plan, r in zip(plans, res):
        assert f32(r) == host_result(segs[1], to_port_plan(plan), stats, 10)


def test_single_term_phrase_parity(segs):
    stats = oracle.IndexStats([segs[1]])
    plans = [phrase_plan(["p3"]), phrase_plan(["p17"])]
    res, _ = both(segs, plans, 10)
    for plan, r in zip(plans, res):
        assert r is not None
        assert f32(r) == host_result(segs[1], to_port_plan(plan), stats, 10)


def test_absent_term_matches_nothing(segs):
    res, handle = both(segs, [phrase_plan(["p1", "nosuchterm"])], 10)
    assert res == [[]] and handle.outcome == ["answered"]


def test_sloppy_and_multi_phrase_decline(segs):
    sloppy = phrase_plan(["p1", "p2"], slop=1)
    multi = QueryPlan(
        groups=(
            QueryGroup(
                Occur.SHOULD, phrases=(PhraseClause("text", ("p1", "p2")),)
            ),
            QueryGroup(
                Occur.SHOULD, phrases=(PhraseClause("text", ("p3", "p4")),)
            ),
        )
    )
    res, handle = both(segs, [sloppy, multi], 10)
    assert res == [None, None]  # host matcher handles these
    assert handle.outcome == ["ineligible"] * 2


def test_tombstones_respected(segs):
    res, _ = both(segs, [phrase_plan(["p0", "p1"])], 50)
    assert res[0] is not None
    dead = set(np.nonzero(segs[1].tombstones)[0].tolist())
    assert not ({d for _s, d in res[0]} & dead)


def test_adjacency_exactness_tiny():
    """Hand-built corpus where doc intersection alone would be wrong."""
    docs = [("alpha beta gamma", "a"), ("beta alpha gamma", "b"),
            ("alpha x beta", "c"), ("alpha beta alpha beta", "d")]
    docs += [(f"filler{i} alpha", f"f{i}") for i in range(60)]
    segs = build(docs)
    plan = phrase_plan(["alpha", "beta"])
    res, _ = both(segs, [plan], 10)
    docs = [d for _s, d in res[0]]
    assert set(docs) == {0, 3} and docs[0] == 3  # doc 3 has phrase tf 2
    stats = oracle.IndexStats([segs[1]])
    assert f32(res[0]) == host_result(segs[1], to_port_plan(plan), stats, 10)


def test_overflow_falls_back_to_host(monkeypatch):
    """More common docs than the anchor-key budget -> overflow flag ->
    None (caller's host matcher), never a truncated result."""
    monkeypatch.setattr(ref_dp, "_COMMON_CAP", 32)
    monkeypatch.setattr(ref_dp, "_FN_CACHE", {})
    monkeypatch.setattr(dp, "_COMMON_CAP", 32)
    segs = build([("red blue filler", f"o{i}") for i in range(100)])
    res, handle = both(segs, [phrase_plan(["red", "blue"])], 10)
    assert res == [None] and handle.outcome == ["staged"]
    assert [o for *_x, o in dp.device_phrase_fetch(handle)] == [1]


def test_delete_invalidates_device_position_cache():
    """delete_by_term after a device phrase query drops the cached
    positions (and their reservation), or the deleted doc keeps
    matching."""
    b = SegmentBuilder(DOCS_SCHEMA)
    for i in range(600):
        text = "alpha beta gamma" if i % 3 == 0 else "alpha delta gamma"
        b.add_document({"text": [text], "id": [f"d{i}"]},
                       stored={"id": f"d{i}"})
    segs = build_from(b.build())
    plan = phrase_plan(["alpha", "beta"])
    res1, _ = both(segs, [plan], 5)
    assert res1[0], "phrase matched nothing pre-delete"
    key = ("pos", id(segs[1]), "text")
    assert residency.contains(key)
    victim = res1[0][0][1]
    for seg in segs:
        assert seg.delete_by_term("id", f"d{victim}") == 1
    assert not residency.contains(key)
    res2, _ = both(segs, [plan], 5)
    assert victim not in [d for _s, d in res2[0]]
    stats = oracle.IndexStats([segs[1]])
    assert f32(res2[0]) == host_result(segs[1], to_port_plan(plan), stats, 5)


def build_from(ref):
    return ref, to_port(ref)


def test_limit_past_ladder_declines_to_host(segs):
    """A limit at or past the top of the extraction ladder declines
    every plan (no silently truncated candidate list)."""
    ref, port = segs
    stats = oracle.IndexStats([port])
    plans = [phrase_plan(["p1", "p2"]), phrase_plan(["p3", "p4"])]
    pplans = [to_port_plan(p) for p in plans]
    for limit in (200, 128):
        res, staged, *_ = ref_dp.device_phrase_begin(
            ref, plans, ref_oracle.IndexStats([ref]), limit)
        assert staged == [] and res == [None, None]
        handle = dp.device_phrase_begin(port, pplans, stats, limit, CPU)
        assert handle.staged == [] and handle.results == [None, None]
        assert handle.outcome == ["limit"] * 2
        assert dp.device_phrase_collect(handle) == [None, None]


# -- what the port adds ---------------------------------------------------------


@pytest.mark.parametrize("terms", [("red", "blue"), ("red",)],
                         ids=["two-term", "single-term"])
def test_ties_select_as_lax_top_k(terms):
    """More docs with equal phrase scores than the extraction ladder
    keeps (k_extract(10) = 16): the candidates are the lowest docs, as
    lax.top_k's lowest-index-first gives them, and so are the hits."""
    docs = [("x y z", f"n{i}") for i in range(7)]
    docs += [("red blue filler", f"t{i}") for i in range(100)]
    docs += [("blue red filler", f"u{i}") for i in range(9)]
    segs = build(docs, tomb_every=11)
    res, handle = both(segs, [phrase_plan(terms)], 10)
    (_qi, top_s, top_d, _o), = dp.device_phrase_fetch(handle)
    assert len(set(top_s[np.isfinite(top_s)].tolist())) == 1
    live = [d for d in range(7, 107) if d % 11]
    assert top_d.tolist() == live[: len(top_d)]
    stats = oracle.IndexStats([segs[1]])
    plan = to_port_plan(phrase_plan(terms))
    assert f32(res[0]) == host_result(segs[1], plan, stats, 10)
    exp = [(np.float32(h.score), h.doc)
           for h in oracle.search([segs[1]], plan, 10, stats)]
    assert f32(res[0]) == exp


def test_windows_past_the_pack_tail_decline_as_the_reference(monkeypatch):
    """A window may run past the end of the port's entry pack (the
    builder pads it by the longest posting's L bucket, 512 here, where
    the reference's device pack adds 8,192 and a power of two): it is
    read by a clamped index, and begin declines exactly the windows the
    reference declines, those past the reference's padded pack
    (``pack_entry_size``)."""
    rng = np.random.default_rng(4)
    words = [f"v{i}" for i in range(10)]
    segs = build([(" ".join(rng.choice(words, size=6)), f"d{i}")
                  for i in range(300)], tomb_every=13)
    port = segs[1]
    plans = [phrase_plan([t]) for t in words]
    plans += [phrase_plan(rng.choice(words, size=2, replace=False))
              for _ in range(6)]
    res, handle = both(segs, plans, 10)
    assert handle.outcome == ["staged"] * len(plans)
    assert all(i.start + 8192 > len(port.e_doc)
               for i in port.terms["text"].values())
    stats = oracle.IndexStats([port])
    for plan, r in zip(plans, res):
        assert f32(r) == host_result(port, to_port_plan(plan), stats, 10)
    # against a pack of no padding at all every window would pass its
    # tail: each plan is declined to the host matcher
    monkeypatch.setattr(dp, "pack_entry_size", lambda n_entries: n_entries)
    handle = dp.device_phrase_begin(port, [to_port_plan(p) for p in plans],
                                    stats, 10, CPU)
    assert handle.outcome == ["tail"] * len(plans) and not handle.staged
    assert dp.device_phrase_collect(handle) == [None] * len(plans)


def test_positions_are_reserved_and_evicted(segs, monkeypatch):
    """The positions are reserved as kind "positions" at their bytes;
    an eviction drops the cache entry, and the next query uploads and
    reserves them again."""
    _ref, port = segs
    fresh = to_port(segs[0])
    stats = oracle.IndexStats([fresh])
    plans = [to_port_plan(phrase_plan(["p1", "p2"]))]
    want = dp.device_phrase_batch(fresh, plans, stats, 10, CPU)
    pos = fresh._device_pos["text"]
    by_kind = residency.stats()["by_kind"]
    assert by_kind["positions"] == sum(t.numel() * 4 for t in pos)
    assert pos.pos_off.dtype == pos.pos_dat.dtype == torch.int32
    assert pos.pos_dat.numel() >= len(fresh.pos_data["text"])
    # a budget below what is resident evicts the positions first
    # (least recently used) when another pack is reserved
    monkeypatch.setenv("FUGU_DEVICE_MEM_BUDGET", str(by_kind["entry"] + 1))
    other = to_port(segs[0])
    other.device_pack(CPU)
    assert residency.stats()["evictions"] >= 1
    assert "text" not in fresh._device_pos
    assert not residency.contains(("pos", id(fresh), "text"))
    monkeypatch.delenv("FUGU_DEVICE_MEM_BUDGET")
    assert dp.device_phrase_batch(fresh, plans, stats, 10, CPU) == want
    assert residency.contains(("pos", id(fresh), "text"))


def test_cuda_tensors_run_on_the_card():
    """No quiet CPU run for the card: asking for CUDA without it raises
    before anything is staged."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py covers it")
    ref, port = build([("a b", "x")])
    with pytest.raises(RuntimeError, match="cuda"):
        dp.device_phrase_begin(port, [to_port_plan(phrase_plan(["a", "b"]))],
                               oracle.IndexStats([port]), 10, "cuda")


# -- the switch, read where the reference reads it ------------------------------


@pytest.fixture(scope="module")
def namespace(tmp_path_factory):
    """Two segments written by the reference NamedIndex over a 30-word
    vocabulary, with deletes in the first."""
    path = tmp_path_factory.mktemp("device_phrase_ns") / "docs"
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
    return path


def routed_plans():
    """12 phrase plans (two and three terms, one single-term, two
    sloppy) and 6 term plans."""
    rng = np.random.default_rng(12)
    plans = []
    for i in range(12):
        w = [f"w{x}" for x in rng.choice(30, size=1 + (i % 3 != 0) + i % 2,
                                         replace=False)]
        plans.append(phrase_plan(w, slop=1 if i % 6 == 5 else 0))
    for _ in range(6):
        w = rng.choice(30, size=2, replace=False)
        plans.append(QueryPlan(groups=tuple(
            QueryGroup(Occur.SHOULD, (TermClause("text", f"w{x}"),))
            for x in w)))
    return plans


def hit_key(hits):
    return [(np.float32(h.score), h.segment_ord, h.doc) for h in hits]


@pytest.mark.parametrize("shards", [0, 2], ids=["unsharded", "mesh2"])
def test_named_index_routes_phrases_to_device_phrase(namespace, monkeypatch,
                                                     shards):
    """With FUGU_DEVICE_PHRASE=1 the phrases the stream declines go to
    device_phrase, on the unsharded segment also under a 2-shard mesh:
    hits equal to the reference NamedIndex's with the same switch and
    to the oracle, and routes["device_phrase"] counts the plans it
    answered; unset, the same hits come from the host matcher."""
    plans = routed_plans()
    pplans = [to_port_plan(p) for p in plans]
    monkeypatch.setenv("FUGU_DEVICE_PHRASE", "1")
    ref = RefNamedIndex("ns", namespace, IndexType.DOCS, compaction="off")
    want = ref.search_topk_batch(plans, 10)
    port = NamedIndex("ns", namespace, PortIndexType.DOCS, device="cpu")
    if shards:
        port.enable_sharding(make_mesh(shards, device="cpu"))
    got = port.search_topk_batch(pplans, 10)
    stats = port.stats()
    for p, g, w in zip(pplans, got, want):
        exp = hit_key(oracle.search(port.segments, p, 10, stats))
        assert hit_key(g) == exp and hit_key(w) == exp
    expected = 0
    for seg in port.segments:
        handle = dp.device_phrase_begin(
            seg, [p for p in pplans if p.host_only], stats, 10, CPU)
        expected += sum(r is not None for r in dp.device_phrase_collect(handle))
    n_phrase = 12 * len(port.segments)
    assert port.routes["device_phrase"] == expected > 0
    assert port.routes["host_only"] == n_phrase - expected
    assert port.routes.get("phrase_stream", 0) == 0
    monkeypatch.delenv("FUGU_DEVICE_PHRASE")
    off = NamedIndex("ns", namespace, PortIndexType.DOCS, device="cpu")
    assert [hit_key(h) for h in off.search_topk_batch(pplans, 10)] == [
        hit_key(h) for h in got]
    assert "device_phrase" not in off.routes
    assert off.routes["host_only"] == n_phrase


def test_device_phrase_errors_propagate(namespace, monkeypatch):
    """No fallback hides the device path: an error in begin or collect
    comes out of search_topk_batch."""
    monkeypatch.setenv("FUGU_DEVICE_PHRASE", "1")

    def boom(*args, **kwargs):
        raise RuntimeError("device phrase failed")

    monkeypatch.setattr(dp, "phrase_topk", boom)
    port = NamedIndex("ns", namespace, PortIndexType.DOCS, device="cpu")
    with pytest.raises(RuntimeError, match="device phrase failed"):
        port.search_topk_batch([to_port_plan(p) for p in routed_plans()], 10)


def test_bench_device_run_with_the_switch(tmp_path, monkeypatch):
    """bench's chain with FUGU_DEVICE_PHRASE=1 against bench.py's with
    the same switch and the oracle, tolerance 0, on a 2,000-doc corpus's
    32-phrase class (the stream declines so small a batch)."""
    monkeypatch.setattr(ref_bench, "N_DOCS", 2000)
    monkeypatch.setattr(ref_bench, "CACHE", tmp_path / "ref")
    monkeypatch.setattr(ref_bench, "N_QUERIES", 32)
    monkeypatch.setattr(bench, "N_QUERIES", 32)
    ref = ref_bench.build_corpus()
    port, _t = bench.build_corpus(2000, cache=tmp_path / "port")
    mix = bench.make_query_mix(port, counts={"phrase": 32}, seed_offset=2)
    ref_mix = ref_bench.make_query_mix(ref, counts={"phrase": 32},
                                       seed_offset=2)
    monkeypatch.setenv("FUGU_DEVICE_PHRASE", "1")
    stats = oracle.IndexStats([port])
    routes = {}
    got = bench.device_run(port, stats, mix, CPU, routes)
    want = ref_bench.device_run(ref, ref_oracle.IndexStats([ref]), ref_mix)
    assert [f32(g) for g in got] == [f32(w) for w in want]
    for (_c, plan, limit), g in zip(mix, got):
        exp = oracle.search([port], plan, limit, stats)
        assert f32(g) == [(np.float32(h.score), h.doc) for h in exp]
    assert routes["device_phrase"] > 0
    assert routes["device_phrase"] + routes["host"] == len(mix)


def test_module_imports_no_jax():
    script = textwrap.dedent("""
        import sys
        import fugu_tpu_torch.ops.device_phrase
        import fugu_tpu_torch.engine.named_index
        print(sorted(m for m in sys.modules if m.split(".")[0] in
                     ("jax", "jaxlib", "fugu_tpu", "triton")))
    """)
    proc = subprocess.run([sys.executable, "-c", script], cwd=str(REPO),
                          env=dict(os.environ, PYTHONPATH=str(REPO)),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "[]"


def test_smoke_device_phrase_phase_on_the_cpu(tmp_path, capsys):
    """chip_smoke's device_phrase phase on CPU tensors at a small size:
    a 4,000-doc namespace of bench's generator, a 64-query mix and 24 of
    the phrase batch; every returned result exact, the same outcomes and
    candidates on both devices (here both CPU), the mix with the switch
    equal to the mix without it, phrases routed to device_phrase."""
    import chip_smoke
    from fugu_tpu_torch.index.manifest import Manifest, save_segment

    seg = chip_smoke.build_corpus(4000, 7, 3000)
    seg.segment_id = "smoke"
    save_segment(seg, tmp_path)
    Manifest(tmp_path).commit([seg])
    ni = NamedIndex("smoke", tmp_path, PortIndexType.DOCS, device="cpu")
    seg, stats = ni.segments[0], ni.stats()
    mix = chip_smoke.make_query_mix(seg, n_queries=64)

    def run_mix():
        return [ni.search_topk_batch([plan], lim)[0]
                for _c, plan, lim in mix]

    warm = run_mix()
    phrases = chip_smoke.make_phrase_batch(seg)
    phrases = phrases[:12] + phrases[-12:]
    chip_smoke.phase_device_phrase(ni, seg, stats, mix, run_mix, warm,
                                   phrases, CPU, "[cpu]", "cpu")
    line = next(json.loads(s) for s in capsys.readouterr().out.splitlines()
                if s.startswith('{"phase": "device_phrase"'))
    assert line["mix"]["exact"] == "64/64"
    assert line["mix"]["routes"]["device_phrase"] > 0
    batch = line["batch"]
    assert batch["outcome"]["ineligible"] == 12  # the sloppy ones
    assert batch["staged"] == batch["exact"] > 0
    assert batch["candidates_equal_cpu"] == f"{batch['staged']}/" \
        f"{batch['staged']}"
    assert os.environ.get("FUGU_DEVICE_PHRASE") is None
    assert "positions" not in residency.stats()["by_kind"]
