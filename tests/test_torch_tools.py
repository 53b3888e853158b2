"""The port's tools on the CPU: the residency drill evicts at every
switch and stays exact, ``live_load`` gets every response 200 and equal
to the in-process answers, ``phrase_cost_validate`` routes as the
reference's ``want_stream`` does on the same plans and stats, and the
smoke's bench and residency phases run at a small size without JAX."""

import importlib.util
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from fugu_tpu.index.schema import DOCS_SCHEMA as REF_DOCS_SCHEMA
from fugu_tpu.index.segment import SegmentBuilder as RefSegmentBuilder
from fugu_tpu.ops import oracle as ref_oracle
from fugu_tpu.ops import phrase_stream as ref_phrase_stream
from fugu_tpu_torch import bench
from fugu_tpu_torch.ops import oracle, residency
from fugu_tpu_torch.ops import phrase_stream
from fugu_tpu_torch.engine import named_index
from fugu_tpu_torch.engine.named_index import NamedIndex
from fugu_tpu_torch.index.manifest import Manifest, save_segment
from fugu_tpu_torch.index.schema import IndexType
from fugu_tpu_torch.tools import dump_oracle_golden, phrase_eligibility
from fugu_tpu_torch.tools import live_load, phrase_cost_validate as pcv
from fugu_tpu_torch.tools import residency_live, routing_fit, slop_ab
from test_torch_phrase_stream import reference_routing

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")


@pytest.fixture
def cache(tmp_path, monkeypatch):
    """bench's cache in a temporary directory, residency books empty."""
    monkeypatch.setattr(bench, "CACHE", tmp_path / "cache")
    monkeypatch.delenv("FUGU_DEVICE_MEM_BUDGET", raising=False)
    residency.reset_for_test()
    yield tmp_path / "cache"
    residency.reset_for_test()


def test_residency_drill_evicts_at_every_switch(cache):
    segs = {"big": bench.build_corpus(5000)[0],
            "small": bench.build_corpus(1500)[0]}
    out = residency_live.drill(segs, ("big", "small", "big"), CPU,
                               headroom_bytes=16 << 10, n_plans=24)
    assert out["ok"], out["problems"]
    steps = out["transitions"]
    assert [t["ns_docs"] for t in steps] == [5000, 1500, 5000]
    assert all(t["served"] == t["of"] == 24 and t["spot_exact"] == 8
               for t in steps)
    ev = [t["evictions"] for t in steps]
    assert ev[0] == 0 and ev[0] < ev[1] < ev[2]
    # the budget was pinned just above the big corpus's packs, and the
    # caller's environment is back as it was
    assert out["budget_bytes"] == steps[0]["pack_bytes"] + (16 << 10)
    assert steps[0]["pack_bytes"] == steps[0]["resident_bytes"]
    assert "FUGU_DEVICE_MEM_BUDGET" not in os.environ


def test_residency_drill_reports_a_headroom_that_proves_nothing(cache):
    segs = {"big": bench.build_corpus(3000)[0],
            "small": bench.build_corpus(1000)[0]}
    out = residency_live.drill(segs, ("big", "small", "big"), CPU,
                               headroom_bytes=1 << 30, n_plans=16)
    assert not out["ok"]
    assert any("no eviction" in p for p in out["problems"])
    assert any("headroom" in p for p in out["problems"])


def test_residency_main_on_the_cpu(cache, capsys):
    rc = residency_live.main(["--big", "3000", "--small", "1000",
                              "--headroom-mb", "0.01", "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and out["ok"] and out["card"] == "cpu"
    assert {"ok", "problems", "budget_gb", "evictions",
            "transitions"} <= set(out)


def test_live_load_answers_equal_the_in_process_answers(cache, capsys):
    rc = live_load.main(["--docs", "2000", "--concurrency", "4,16",
                         "--requests", "64", "--queries", "40",
                         "--device", "cpu"])
    lines = [json.loads(s) for s in
             capsys.readouterr().out.strip().splitlines()]
    assert rc == 0
    assert [lv["clients"] for lv in lines] == [4, 16]
    for lv in lines:
        assert lv["phase"] == "served load" and lv["failed"] == 0
        assert lv["requests"] == 64 and lv["mean_batch"] > 1
        assert set(lv["stage_mean_ms"]) == set(live_load.STAGES)
    assert not list(cache.glob("live_load_*"))  # the mount was removed


def test_live_load_refuses_a_differing_response():
    res = {"statuses": [200, 200], "seconds": [0.0, 0.0],
           "texts": ['{"results": [{"id": "d1", "score": 1.5}]}'] * 2}
    live_load.check_responses(res, [[("d1", 1.5)]], "same")
    with pytest.raises(live_load.LoadError, match="only 0/2"):
        live_load.check_responses(res, [[("d2", 1.5)]], "other doc")
    with pytest.raises(live_load.LoadError, match="not 200"):
        live_load.check_responses(dict(res, statuses=[200, 503]),
                                  [[("d1", 1.5)]], "status")


def test_live_load_queries_are_the_reference_tools():
    spec = importlib.util.spec_from_file_location(
        "ref_live_load", REPO / "tools" / "live_load.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    assert [q for q, _f in live_load.make_queries(64)] == ref.make_queries(
        1_000_000, 64)


def _ref_cost_tool():
    spec = importlib.util.spec_from_file_location(
        "ref_phrase_cost_validate", REPO / "tools" / "phrase_cost_validate.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ref_segment(n_docs, zipf_s, mean_len):
    """The reference's segment of the cost tool's corpus, the same texts
    drawn as the reference tool draws them."""
    rng = np.random.default_rng(11)
    lens = np.clip(rng.poisson(mean_len, n_docs), 4, 200)
    b = RefSegmentBuilder(REF_DOCS_SCHEMA)
    for texts in bench.iter_texts(rng, lens, bench.VOCAB_SIZE, zipf_s):
        for text in texts:
            b.add_document({"text": [text]},
                           stored={"id": f"d{b.doc_count}"})
    return b.build()


#: the card's decisions on the cost tool's batches at 3,000 docs
#: (selective16, heavy16, mixed32, heavy160), with the port's constants
CARD_DECISIONS = {"home": [False, True, True, True],
                  "flat": [False, False, False, False]}


@pytest.mark.parametrize("constants", ["reference", "card"])
@pytest.mark.parametrize("host_ns", [None, 1e7],
                         ids=["fitted", "host-expensive"])
@pytest.mark.parametrize("corpus", pcv.CORPORA, ids=lambda c: c[0])
def test_phrase_cost_routes_as_the_reference(cache, corpus, host_ns,
                                             constants, monkeypatch):
    """On each corpus and batch: the same plans as the reference tool's.
    With the reference's constants patched into the port (its own terms
    at the values that reduce the model to the reference's form), the
    same two cost estimates and the same ``want_stream`` decision as the
    reference's router; with the card's constants, the card's decisions.
    With the host cost raised (on both sides), every batch streams."""
    tag, zipf_s, mean_len = corpus
    if constants == "reference":
        for name, value in reference_routing().items():
            monkeypatch.setattr(phrase_stream, name, value)
    if host_ns is not None:
        for mod in (phrase_stream, ref_phrase_stream):
            monkeypatch.setattr(mod, "HOST_NS_PER_MIN_POSTING", host_ns)
    seg = pcv.build_corpus(tag, 3000, zipf_s, mean_len, cache=cache)
    ref_seg = _ref_segment(3000, zipf_s, mean_len)
    stats = oracle.IndexStats([seg])
    ref_stats = ref_oracle.IndexStats([ref_seg])
    ref_tool = _ref_cost_tool()
    decided = []
    for (name, plans), (ref_name, ref_plans) in zip(
            pcv.phrase_batches(seg), ref_tool.phrase_batches(ref_seg,
                                                             ref_stats)):
        assert name == ref_name
        assert [repr(p) for p in plans] == [repr(p) for p in ref_plans]
        got = pcv.decision(plans, stats)
        assert got["routed_stream"] == (
            got["host_est_ms"] > got["stream_est_ms"])
        if constants == "reference":
            assert got["routed_stream"] == ref_phrase_stream.want_stream(
                len(ref_plans), plans=ref_plans, stats=ref_stats)
            assert got["host_est_ms"] == ref_phrase_stream.estimate_host_ms(
                ref_plans, ref_stats)
            assert got["stream_est_ms"] == (
                ref_phrase_stream.estimate_stream_ms(ref_stats,
                                                     len(ref_plans)))
        decided.append(got["routed_stream"])
    if host_ns:
        assert decided == [True] * 4
    elif constants == "reference":
        assert decided == [False] * 4
    else:
        assert decided == CARD_DECISIONS[tag]


def test_phrase_cost_main_on_the_cpu(cache, capsys):
    rc = pcv.main(["--docs", "1500", "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == (0 if out["ok"] else 2)
    assert [(p["corpus"], p["batch"]) for p in out["points"]] == [
        (c, b) for c in ("home", "flat")
        for b in ("selective16", "heavy16", "mixed32", "heavy160")]
    for p in out["points"]:
        assert p["host_ms"] > 0 and p["stream_ms"] > 0
        assert p["ok"] == (p["near_crossover"]
                           or p["routed_stream"] == p["measured_stream_wins"])
        n = {"selective16": 16, "heavy16": 16, "mixed32": 32,
             "heavy160": 160}[p["batch"]]
        assert len(p["host_plan_ms"]) == len(p["plan_dfs"]) == n
        assert len(p["verify_plan_ms"]) == n
        assert sum(p["host_plan_ms"]) <= p["host_ms"] * 1.5 + 5.0
        assert len(p["stream_split_ms"]) == 3


def test_routing_fit_recovers_the_constants(tmp_path, capsys):
    """Readings made by the cost model itself at known constants (a cost
    tool line and an overlap line, the phrases' dfs drawn from a seed):
    ``routing_fit`` recovers those constants (the verify's half point on
    its grid), finds every decision right, and fits the reference's form
    with the added terms at 0."""
    rng = np.random.default_rng(5)
    truth = {"HOST_NS_PER_MIN_POSTING": 20.0, "HOST_NS_PER_INTER_DOC": 30.0,
             "HOST_NS_PER_OTHER_POSTING": 8.0,
             "HOST_MS_PER_MATCHING_PHRASE": 0.2, "STREAM_FIXED_MS": 0.5,
             "STREAM_MS_PER_PHRASE": 0.05, "STREAM_VERIFY_MS": 1.5,
             "STREAM_VERIFY_HALF_DOCS": 1000.0}
    old = {k: getattr(phrase_stream, k) for k in truth}
    points = []
    try:
        for k, v in truth.items():
            setattr(phrase_stream, k, v)
        for i, (docs, n, hi) in enumerate([(500_000, 16, 300_000),
                                           (500_000, 32, 3_000),
                                           (1_000_000, 160, 900_000),
                                           (1_000_000, 8, 2_000),
                                           (200_000, 64, 50_000)]):
            dfs = rng.integers(1, hi, size=(n, 2)).tolist()
            b = routing_fit.batch("x", docs, docs * 55, dfs, 0.0, 0.0)
            each = [phrase_stream.estimate_host_ms([p], b["stats"])
                    for p in b["plans"]]
            points.append({
                "corpus": "c", "batch": f"b{i}", "docs": docs,
                "tokens": docs * 55, "plan_dfs": dfs,
                "host_ms": phrase_stream.estimate_host_ms(b["plans"],
                                                          b["stats"]),
                "stream_ms": phrase_stream.estimate_stream_ms(
                    b["stats"], n, b["plans"]),
                "host_plan_ms": each,
                "verify_plan_ms": [None if j % 2 else 1.0
                                   for j in range(n)]})
    finally:
        for k, v in old.items():
            setattr(phrase_stream, k, v)
    overlap = {"device_ms": 90.0, "device_plans": {"10": 216},
               "docs": 1_000_000, "tokens": 55_000_000,
               "mix": dict(points[3], phrases=8, hidden_ms=-20.0)}
    # an overlap line without the phrases' dfs gives no batch
    bare = dict(overlap, mix={"phrases": 24, "hidden_ms": 600.0})
    (tmp_path / "costval.out").write_text(
        "log line\n" + json.dumps({"ok": True, "points": points}) + "\n")
    (tmp_path / "mix.out").write_text(json.dumps(overlap) + "\n"
                                      + json.dumps(bare) + "\n")
    assert routing_fit.main([str(tmp_path / "costval.out"),
                             str(tmp_path / "mix.out")]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for k, v in truth.items():
        assert out["fitted"][k] == pytest.approx(v, rel=1e-6), k
    assert out["all_ok"]
    assert len(out["batches"]) == 6
    ref = out["reference_form"]
    assert [r["batch"] for r in ref["batches"]] == [
        r["batch"] for r in out["batches"]]
    for k in ("HOST_NS_PER_OTHER_POSTING", "HOST_MS_PER_MATCHING_PHRASE",
              "STREAM_VERIFY_MS"):
        assert ref["fitted"][k] == 0.0
    assert ref["fitted"]["HOST_NS_PER_MIN_POSTING"] > 0
    assert ref["all_ok"] == all(r["ok"] for r in ref["batches"])
    # the reference form's decisions were taken with its constants, and
    # the module's are back
    assert phrase_stream.STREAM_VERIFY_MS == old["STREAM_VERIFY_MS"]
    bins = out["by_intersection"]
    assert sum(row[1] for row in bins) == sum(
        len(p["plan_dfs"]) for p in points)
    assert [row[0] for row in bins] == sorted(row[0] for row in bins)
    assert all(0.0 <= row[3] <= 1.0 and row[2] > 0 for row in bins)
    for row in out["batches"]:
        assert row["routed_stream"] == (
            row["host_est_ms"] > row["stream_est_ms"])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_routing_fit_nnls_meets_its_optimality_conditions(seed):
    """``routing_fit.nnls`` on a random system with a few unknowns: no
    negative value, and the conditions of the non-negative optimum hold
    (the gradient is 0 on each positive unknown and not negative on each
    unknown at 0); a system with a non-negative exact solution gives it
    back."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(12, 4))
    y = rng.normal(size=12)
    x = routing_fit.nnls(a, y)
    grad = a.T @ (a @ x - y)
    assert (x >= 0).all()
    assert np.allclose(grad[x > 0], 0.0, atol=1e-9)
    assert (grad[x == 0] >= -1e-9).all()
    truth = np.array([0.5, 0.0, 2.0, 1.5])
    assert np.allclose(routing_fit.nnls(np.abs(a), np.abs(a) @ truth),
                       truth)


def test_smoke_routing_phase_on_the_cpu(tmp_path):
    """The smoke's routing line on a 3,000-doc segment's mix: the
    routes given, the three estimates with the router's decision, and
    both sides' measured ms."""
    seg = chip_smoke.build_corpus(3000, 7, 3000)
    stats = oracle.IndexStats([seg])
    mix = chip_smoke.make_query_mix(seg)
    line = chip_smoke.phase_routing(seg, stats, mix,
                                    {"host_only": 72, "phase_a": 600},
                                    CPU, "cpu")
    n = sum(c == "phrase" for c, _p, _l in mix)
    assert line["phase"] == "routing" and line["phrases"] == n == 24
    assert line["routes"] == {"phrase_stream": 0, "host_only": 72}
    assert line["device_plans"] == sum(
        lim == 10 and not p.host_only for _c, p, lim in mix)
    assert line["credit_est_ms"] == 0.0
    assert line["routed_stream"] == (line["host_est_ms"]
                                     > line["stream_est_ms"])
    assert line["host_ms"] > 0 and line["stream_ms"] > 0
    assert len(line["stream_split_ms"]) == 3


def test_smoke_bench_and_residency_phases_on_the_cpu(tmp_path):
    """The smoke's bench phase (bench.run on a 4,000-doc segment: exact
    order n/n) and its residency phase (a 4,000- and a 1,500-doc segment)
    in a fresh interpreter, which imports neither JAX, nor fugu_tpu, nor
    Triton, nor aiohttp."""
    script = textwrap.dedent(f"""
        import sys
        from pathlib import Path
        import torch
        import chip_smoke
        from fugu_tpu_torch import bench
        from fugu_tpu_torch.ops import oracle
        from fugu_tpu_torch.tools.residency_live import fresh

        bench.CACHE = Path({str(tmp_path)!r})
        cpu = torch.device("cpu")
        big = chip_smoke.build_corpus(4000, 7, 3000)
        chip_smoke.phase_bench(big, oracle.IndexStats([big]), cpu, "[cpu]",
                               "cpu", n_passes=1)
        small = chip_smoke.build_corpus(1500, 8, 3000)
        # big's own packs from the bench phase stay resident beside the
        # drill's: they go first, and every switch still evicts
        chip_smoke.phase_residency(fresh(big), fresh(small), cpu, "[cpu]",
                                   "cpu", headroom_bytes=16 << 10,
                                   n_plans=16)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "fugu_tpu",
                                            "triton", "aiohttp"))
        print("LOADED", bad)
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO), BENCH_QUERIES="32",
               BENCH_INGEST_DOCS="200", OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", script], cwd=str(REPO),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    assert "LOADED []" in proc.stdout
    lines = [json.loads(s) for s in proc.stdout.splitlines()
             if s.startswith("{")]
    line = next(x for x in lines if "exact_order" in x)
    assert line["exact_order"] == "32/32"
    detail = next(x for x in lines if x.get("phase") == "bench")
    assert detail["class_full"]["phrase"]["routes"]["host"] == 32
    drill = next(x for x in lines if x.get("phase") == "residency")
    assert drill["ok"] and [t["ns_docs"] for t in drill["transitions"]] == [
        4000, 1500, 4000]


@pytest.mark.parametrize("tool", ["residency_live", "live_load",
                                  "phrase_cost_validate", "slop_ab",
                                  "device_phrase_ab"])
def test_tool_without_a_card_exits_with_an_error_line(tool, tmp_path):
    """Each tool runs on the card unless asked for the CPU: without CUDA
    it prints an error line and exits 1, having built nothing."""
    env = dict(os.environ, PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", f"fugu_tpu_torch.tools.{tool}"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 1, proc.stderr[-2000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["ok"] is False and "cuda" in line["error"].lower()


def test_new_modules_import_no_jax():
    script = textwrap.dedent("""
        import sys
        import fugu_tpu_torch.analysis_extended
        import fugu_tpu_torch.bench
        import fugu_tpu_torch.tools.live_load
        import fugu_tpu_torch.tools.phrase_cost_validate
        import fugu_tpu_torch.tools.residency_live
        print(sorted(m for m in sys.modules if m.split(".")[0] in
                     ("jax", "jaxlib", "fugu_tpu", "triton", "aiohttp")))
    """)
    proc = subprocess.run([sys.executable, "-c", script], cwd=str(REPO),
                          env=dict(os.environ, PYTHONPATH=str(REPO)),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "[]"


def _ref_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"ref_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_phrase_eligibility_line_equals_the_reference_tools(capsys):
    """The same 256 query strings, and the same JSON line from the
    port's parser and stream eligibility as from the reference's."""
    ref = _ref_tool("phrase_eligibility")
    assert phrase_eligibility.make_phrase_mix() == ref.make_phrase_mix()
    ref.main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert phrase_eligibility.main([]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got == want
    assert got["n_phrase_plans"] == 256 and got["classes"]["stream"] > 0


def test_slop_ab_on_the_cpu(cache, capsys):
    """192 slop-1/2 phrases through the phrase stream (its plain kernel
    on CPU tensors) and the host matcher on a 2,000-doc corpus: parity
    192/192, the reference tool's line and a JSON line."""
    assert slop_ab.main(["--docs", "2000", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-2].startswith("slop-heavy 192 phrases @2000 docs: stream ")
    assert lines[-2].endswith("parity 192/192")
    out = json.loads(lines[-1])
    assert out["ok"] and out["parity"] == out["plans"] == 192
    assert len(out["stream_s"]) == len(out["host_s"]) == 3
    clauses = [phrase_stream.eligible_phrase(p) for p in slop_ab.slop_plans()]
    assert all(c is not None and c.slop in (1, 2) for c in clauses)


GOLDEN = REPO / "tests" / "golden" / "oracle_golden.json"


def test_dump_oracle_golden_equals_the_committed_fixture(tmp_path):
    """The port's oracle over the golden corpus and queries writes
    ``results`` equal bit for bit to the reference tool's fixture, in
    its schema; the fixture itself is not written."""
    before = GOLDEN.read_bytes()
    out = tmp_path / "golden.json"
    assert dump_oracle_golden.main(["--out", str(out)]) == 0
    got = json.loads(out.read_text())
    want = json.loads(before)
    assert got["results"] == want["results"]
    assert set(got) == set(want) and got["limit"] == want["limit"] == 30
    assert GOLDEN.read_bytes() == before


@pytest.mark.parametrize("switch", [None, "1"],
                         ids=["default", "device_phrase"])
def test_golden_queries_through_named_index_equal_the_fixture(
        tmp_path, monkeypatch, switch):
    """The golden corpus as a namespace of the port, every golden query
    through ``NamedIndex.search_topk_batch`` on CPU tensors (the device
    stack: ``DEVICE_MIN_ENTRIES`` lowered to 1), with and without
    ``FUGU_DEVICE_PHRASE=1``: ids and f32 score bits equal the fixture."""
    monkeypatch.setattr(named_index, "DEVICE_MIN_ENTRIES", 1)
    if switch:
        monkeypatch.setenv("FUGU_DEVICE_PHRASE", switch)
        # the device phrase path takes what the stream declines: the
        # stream priced out, the phrases reach it at any routing
        monkeypatch.setattr(phrase_stream, "STREAM_FIXED_MS", float("inf"))
    else:
        monkeypatch.delenv("FUGU_DEVICE_PHRASE", raising=False)
    golden = json.loads(GOLDEN.read_text())
    corpus = json.loads((GOLDEN.parent / "corpus.json").read_text())
    seg = dump_oracle_golden.golden_segment(corpus)
    seg.segment_id = "golden"
    save_segment(seg, tmp_path)
    Manifest(tmp_path).commit([seg])
    ni = NamedIndex("golden", tmp_path, IndexType.DOCS, device="cpu")
    queries = [q for q, r in golden["results"].items() if r is not None]
    hits = ni.search_topk_batch([dump_oracle_golden.parse(q)
                                 for q in queries], golden["limit"])
    seg = ni.segments[0]
    for q, hs in zip(queries, hits):
        got = [[seg.stored[h.doc]["id"],
                int(np.float32(h.score).view(np.uint32))] for h in hs]
        assert got == golden["results"][q], q
    device_routes = {k: v for k, v in ni.routes.items()
                     if k not in ("host", "host_only") and v}
    assert device_routes.get("small_segment", 0) > 0
    assert bool(device_routes.get("device_phrase")) == bool(switch)


def test_the_tools_import_no_jax():
    script = textwrap.dedent("""
        import sys
        import fugu_tpu_torch.tools.device_phrase_ab
        import fugu_tpu_torch.tools.dump_oracle_golden
        import fugu_tpu_torch.tools.phrase_eligibility
        import fugu_tpu_torch.tools.slop_ab
        print(sorted(m for m in sys.modules if m.split(".")[0] in
                     ("jax", "jaxlib", "fugu_tpu", "triton", "aiohttp")))
    """)
    proc = subprocess.run([sys.executable, "-c", script], cwd=str(REPO),
                          env=dict(os.environ, PYTHONPATH=str(REPO)),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "[]"


def test_device_phrase_ab_main_on_the_cpu(cache, capsys, monkeypatch):
    """The device phrase A/B on CPU tensors at 2,000 docs, with 16 of
    the smoke's phrase batch (8 of them sloppy): one JSON line, every
    staged plan exact, the stream and the host matcher in turns; the
    profile and the bound only on the card."""
    import chip_smoke
    from fugu_tpu_torch.tools import device_phrase_ab

    full = chip_smoke.make_phrase_batch
    monkeypatch.setattr(chip_smoke, "make_phrase_batch",
                        lambda seg: full(seg)[:8] + full(seg)[-8:])
    rc = device_phrase_ab.main(["--docs", "2000", "--device", "cpu",
                                "--reps", "1"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and out["ok"] and out["card"] == "cpu"
    batch = out["batch"]
    assert batch["plans"] == 16 and batch["outcome"]["ineligible"] == 8
    assert batch["exact"] == batch["answered"] == batch["staged"] > 0
    assert len(batch["stream_ms"]) == len(batch["host_ms"]) == 1
    assert out["mix_phrases"]["plans"] > 0 and "bound_ms" not in batch
