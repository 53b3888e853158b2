"""The port's spans and counters (``fugu_tpu_torch/telemetry.py``,
``server/metrics.py``) and the benchmark's readers of them.

A span adds its seconds to ``fugu_span_seconds{span=...}``, nests
through a contextvar, opens a ``torch.profiler`` range only while a
profiler records, and a same-named inner span is part of its outer one.
The registry renders labelled histograms as Prometheus text and its
unlabelled families exactly as the reference's registry does, and gives
each sample's change between its last two renders.  The garbage
collector's hook times collections once per process.  Through the app on
a CPU namespace, each search-path span fires for every engine call, and
the upload counter equals the bytes the kernels' wrappers were handed.
The nine readers under ``perfbench/metrics/`` read a synthetic window,
and give None where the window or the program does not match."""

import gc
import json
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from fugu_tpu.server import metrics as ref_metrics
from fugu_tpu_torch import telemetry
from fugu_tpu_torch.index.schema import DOCS_SCHEMA
from fugu_tpu_torch.index.segment import SegmentBuilder
from fugu_tpu_torch.ops import batch_scorer as bs
from fugu_tpu_torch.ops import block_scorer
from fugu_tpu_torch.ops import oracle
from fugu_tpu_torch.query import Occur, QueryGroup, QueryPlan, TermClause
from fugu_tpu_torch.server import metrics
from test_torch_server import (  # noqa: F401 (the fixture applies here)
    LiveServer,
    device_engine_for_small_segments,
)
from test_torch_writer import PORT

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import manifest  # noqa: E402

torch.set_num_threads(1)

TWO_PHASE_SPANS = ("two_phase.stage", "two_phase.fetch",
                   "two_phase.candidates", "two_phase.rescore")


def span_key(name: str, part: str = "count") -> str:
    return f'fugu_span_seconds_{part}{{span="{name}"}}'


def fill(reg):
    """The same unlabelled samples on either package's registry."""
    reg.inc("fugu_requests_total", status="ok", route="/search")
    reg.inc("fugu_ingested_documents_total", 3)
    reg.inc("fugu_plain_total")
    for s in (0.0004, 0.02, 0.3, 7.0):
        reg.observe("fugu_search_seconds", s)
    reg.observe("fugu_search_engine_seconds", 0.0123456789)


# -- the registry ---------------------------------------------------------------


def test_labelled_histogram_renders_prometheus_text():
    reg = metrics.Metrics()
    reg.observe("fugu_span_seconds", 0.002, span="engine.plan")
    reg.observe("fugu_span_seconds", 0.3, span="engine.plan")
    reg.observe("fugu_span_seconds", 0.0001, span='odd"name')
    lines = reg.render().splitlines()
    plan = [l for l in lines if 'span="engine.plan"' in l]
    assert plan[0] == 'fugu_span_seconds_bucket{span="engine.plan",le="0.001"} 0'
    assert 'fugu_span_seconds_bucket{span="engine.plan",le="0.005"} 1' in plan
    assert 'fugu_span_seconds_bucket{span="engine.plan",le="0.5"} 2' in plan
    assert 'fugu_span_seconds_bucket{span="engine.plan",le="+Inf"} 2' in plan
    assert plan[-2:] == ['fugu_span_seconds_sum{span="engine.plan"} 0.302000',
                         'fugu_span_seconds_count{span="engine.plan"} 2']
    assert 'fugu_span_seconds_count{span="odd\\"name"} 1' in lines
    sample = re.compile(r'^[a-z_]+(\{([a-z_]+="([^"\\]|\\.)*",?)+\})? \S+$')
    assert all(sample.match(l) for l in lines), lines


def test_unlabelled_families_render_as_the_reference_does():
    port, ref = metrics.Metrics(), ref_metrics.Metrics()
    fill(port)
    fill(ref)
    assert port.render() == ref.render()
    port.observe("fugu_span_seconds", 0.01, span="front.parse")
    port.observe_later("fugu_gc_seconds", 0.2, generation="2")
    labelled = re.compile(r"^fugu_(span|gc)_seconds_")
    got = [l for l in port.render().splitlines() if not labelled.match(l)]
    assert got == ref.render().splitlines()


def test_between_renders_gives_each_samples_change():
    reg = metrics.Metrics()
    reg.observe("fugu_search_engine_seconds", 0.5)
    reg.inc("fugu_h2d_bytes_total", 100, site="phase_a")
    reg.render()
    reg.observe("fugu_search_engine_seconds", 0.25)
    reg.observe("fugu_span_seconds", 0.125, span="engine.plan")
    reg.inc("fugu_h2d_bytes_total", 40, site="phase_a")
    reg.inc("fugu_h2d_bytes_total", 7, site="block_rows")
    reg.render()
    delta = reg.between_renders()
    assert delta["fugu_search_engine_seconds_count"] == 1
    assert delta["fugu_search_engine_seconds_sum"] == pytest.approx(0.25)
    assert delta[span_key("engine.plan", "sum")] == pytest.approx(0.125)
    assert delta[span_key("engine.plan")] == 1
    assert delta['fugu_h2d_bytes_total{site="phase_a"}'] == 40
    assert delta['fugu_h2d_bytes_total{site="block_rows"}'] == 7
    reg.render()
    assert reg.between_renders()["fugu_search_engine_seconds_count"] == 0


def test_observe_later_is_counted_at_the_next_render():
    reg = metrics.Metrics()
    reg.observe_later("fugu_gc_seconds", 0.05, generation="1")
    assert not reg.labelled
    text = reg.render()
    assert 'fugu_gc_seconds_count{generation="1"} 1' in text
    assert not reg._later


# -- spans ------------------------------------------------------------------------


def test_spans_nest_and_know_their_parent():
    seen = {}
    with telemetry.span("engine", "batch", batch=7, size=3) as outer:
        with telemetry.span("engine", "plan") as inner:
            seen["inner"] = telemetry._open_span.get()
            seen["label"] = telemetry._current_span.get()
            telemetry.annotate(note="x", skipped=None)
        seen["after"] = telemetry._open_span.get()
    assert seen["inner"] is inner and inner.parent is outer
    assert seen["label"] == "engine:plan" and seen["after"] is outer
    assert inner.fields == {"note": "x"} and outer.parent is None
    assert outer.fields == {"batch": 7, "size": 3}
    assert telemetry._open_span.get() is None


def test_span_observes_its_seconds_and_a_same_named_inner_span_is_part_of_it():
    metrics.REGISTRY.render()
    with telemetry.span("test", "outer"):
        with telemetry.span("test", "outer"):
            with telemetry.span("test", "inner"):
                pass
    with telemetry.server_span("/x", "GET"):
        pass
    metrics.REGISTRY.render()
    delta = metrics.REGISTRY.between_renders()
    assert delta[span_key("test.outer")] == 1
    assert delta[span_key("test.inner")] == 1
    assert delta[span_key("test.outer", "sum")] >= delta[
        span_key("test.inner", "sum")]
    assert not any("server." in k for k in delta)


def test_no_profiler_range_while_no_profiler_records(monkeypatch):
    import torch.autograd.profiler as prof

    def refuse(*a, **kw):
        raise AssertionError("record_function called with no profiler")

    assert not prof._is_profiler_enabled
    monkeypatch.setattr(prof, "record_function", refuse)
    with telemetry.span("test", "quiet"):
        pass


def test_span_is_a_range_in_a_cpu_profiler_trace(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as p:
        with telemetry.span("test", "traced"):
            torch.ones(8).sum()
    out = tmp_path / "trace.json"
    p.export_chrome_trace(str(out))
    names = [e.get("name") for e in json.loads(out.read_text())["traceEvents"]]
    assert names.count("fugu.test.traced") == 1


# -- the garbage collector's hook -------------------------------------------------


def test_gc_hook_times_a_full_collection():
    telemetry.install_gc_hook()
    metrics.REGISTRY.render()
    gc.collect(2)
    metrics.REGISTRY.render()
    delta = metrics.REGISTRY.between_renders()
    assert delta['fugu_gc_seconds_count{generation="2"}'] >= 1
    assert delta['fugu_gc_seconds_sum{generation="2"}'] > 0


def test_gc_hook_installed_once_over_two_apps(tmp_path):
    from fugu_tpu_torch.server.app import create_app

    cfg = PORT.config.ServerConfig.with_defaults(str(tmp_path), "default")
    db = PORT.manager.DatasetManager(cfg, **PORT.mgr_kw)
    try:
        create_app(db)
        create_app(db)
    finally:
        db.close()
    assert gc.callbacks.count(telemetry._gc_callback) == 1


# -- the search path --------------------------------------------------------------


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    srv = LiveServer(PORT, tmp_path_factory.mktemp("spans"))
    docs = [{"id": f"s{i}", "text": f"common word{i % 7} special{i}"}
            for i in range(60)]
    status, _ = srv.post_json("/ingest", {"data": docs})
    assert status == 200
    yield srv
    srv.stop()


def test_each_search_path_span_fires_for_every_engine_call(served):
    served.get("/metrics")
    for q in ("common word3", "special5 word1", "common"):
        status, out = served.post_json(
            "/search/json", {"query": q, "page": {"per_page": 5}})
        assert status == 200 and out["results"]
    served.get("/metrics")
    delta = metrics.REGISTRY.between_renders()
    calls = delta["fugu_search_engine_seconds_count"]
    assert calls >= 1
    assert delta[span_key("front.parse")] == 3
    assert delta[span_key("front.respond")] == 3
    for name in ("engine.plan", "engine.route", "engine.convert"):
        assert delta[span_key(name)] == calls, name
    for name in TWO_PHASE_SPANS:
        assert delta[span_key(name)] >= calls, name
    # the engine call's own seconds are the batcher's histogram's alone
    assert not delta.get(span_key("engine.batch"))
    # children are disjoint pieces of their parents: their sums fit
    inside = sum(delta[span_key(n, "sum")] for n in TWO_PHASE_SPANS)
    assert inside <= delta[span_key("engine.route", "sum")]
    assert sum(delta[span_key(n, "sum")] for n in (
        "engine.plan", "engine.route", "engine.convert")) <= delta[
        "fugu_search_engine_seconds_sum"]
    assert sum(v for k, v in delta.items()
               if k.startswith("fugu_h2d_bytes_total{")) > 0
    assert sum(v for k, v in delta.items()
               if k.startswith("fugu_d2h_bytes_total{")) > 0


def test_compacting_unknown_namespaces_adds_no_span_series(served):
    def series(text):
        return {ln.rsplit(" ", 1)[0] for ln in text.splitlines()
                if ln.startswith("fugu_span_seconds")}

    before = served.get("/metrics")[1]
    for name in ("nope-a", "nope-b", "nope-c"):
        status, _ = served.post_json(f"/compact/{name}", {})
        assert status == 404
    after = served.get("/metrics")[1]
    assert "nope-" not in after and "compactor" not in after
    assert series(after) == series(before)


@pytest.mark.parametrize("helper, args", [
    ("cli_span", ("search_namespace",)),
    ("compactor_span", ("ns-from-a-url",)),
    ("query_span", ("bm25",)),
    ("server_span", ("/objects/42", "GET")),
])
def test_component_helpers_log_but_add_no_histogram(helper, args, caplog):
    import logging

    metrics.REGISTRY.render()
    with caplog.at_level(logging.DEBUG, logger="fugu_tpu_torch"):
        with getattr(telemetry, helper)(*args):
            pass
    metrics.REGISTRY.render()
    assert not any(k.startswith("fugu_span_seconds")
                   for k, v in metrics.REGISTRY.between_renders().items() if v)
    assert any(args[0] in r.getMessage() and "done in" in r.getMessage()
               for r in caplog.records)


def test_pages_name_the_batch_that_served_them(served):
    ds = served.db.get_dataset("default")
    first = ds.search_many([("common", []), ("word2", [])], 0, 5)
    second = ds.search_many([("special3", [])], 0, 5)
    assert first[0].batch == first[1].batch
    assert second[0].batch > first[0].batch
    assert first[0] == ds.search("common", [], 0, 5)


def test_a_searchs_span_names_its_engine_batch(served, caplog):
    import logging

    with caplog.at_level(logging.DEBUG, logger="fugu_tpu_torch"):
        status, _ = served.post_json("/search/json", {"query": "special9"})
    assert status == 200
    lines = [r.getMessage() for r in caplog.records]
    batch = [m for m in lines if m.startswith("engine:batch done")]
    request = [m for m in lines if m.startswith("server:POST /search/json")]
    assert len(batch) == 1 and len(request) == 1
    number = re.search(r"'batch': (\d+)", batch[0]).group(1)
    assert f"'batch': {number}" in request[0]
    assert "'size': 1" in batch[0]
    assert any(m.startswith("engine:plan done") and "parent=engine:batch" in m
               for m in lines)


def search_segment():
    rng = np.random.default_rng(5)
    words = [f"w{i}" for i in range(40)]
    b = SegmentBuilder(DOCS_SCHEMA)
    for i in range(3000):
        text = " ".join(rng.choice(words, size=int(rng.integers(3, 20))))
        b.add_document({"text": [text]}, stored={"id": f"d{i}"})
    return b.build()


def test_upload_counter_equals_the_bytes_handed_to_the_kernels(monkeypatch):
    seg = search_segment()
    stats = oracle.IndexStats([seg])

    def S(t):
        return QueryGroup(Occur.SHOULD, (TermClause("text", t),))

    def M(t):
        return QueryGroup(Occur.MUST, (TermClause("text", t),))

    plans = [QueryPlan(groups=(S("w1"), S("w2"), S("w9")), require_should=True),
             QueryPlan(groups=(S("w3"),), require_should=True),
             QueryPlan(groups=(S("w4"), S("w5"), M("w6")), require_should=True)]
    handed = []

    def spy(fn, at):
        def call(*args):
            handed.append(sum(args[i].nbytes for i in at))
            return fn(*args)
        return call

    monkeypatch.setattr(bs, "phasea", spy(bs.phasea, (4, 5, 7, 8)))
    monkeypatch.setattr(bs, "postproc", spy(bs.postproc, (1, 2, 3)))
    monkeypatch.setattr(block_scorer, "score_rows",
                        spy(block_scorer.score_rows, range(9)))
    metrics.REGISTRY.render()
    got = bs.batch_search(seg, plans, stats, [10] * 3, torch.device("cpu"))
    metrics.REGISTRY.render()
    delta = metrics.REGISTRY.between_renders()
    for p, g in zip(plans, got):
        want = [(h.score, h.doc) for h in oracle.search([seg], p, 10, stats)]
        assert [(np.float32(s), d) for s, d in g] == [
            (np.float32(s), d) for s, d in want]
    uploaded = sum(v for k, v in delta.items()
                   if k.startswith("fugu_h2d_bytes_total{"))
    assert len(handed) >= 3 and uploaded == sum(handed)
    assert delta['fugu_d2h_bytes_total{site="block_rows"}'] > 0


# -- the benchmark's readers ------------------------------------------------------

READERS = {
    # reader: (value on the synthetic window below)
    "front_end_ms": (0.030 + 0.010) / 4 * 1e3,
    "engine_plan_ms": 0.006 / 2 * 1e3,
    "engine_convert_ms": 0.004 / 2 * 1e3,
    "two_phase_stage_ms": 0.020 / 2 * 1e3,
    "two_phase_fetch_ms": 0.002 / 2 * 1e3,
    "candidates_ms": 0.008 / 2 * 1e3,
    "rescore_ms": 0.012 / 2 * 1e3,
    "h2d_mb": (21_000_000 + 3_000_000 + 1_000_000) / 2 / 1e6,
    "gc_share": 100 * (0.4 + 0.1) / 10.0,
}


def synthetic_window(monkeypatch, registry):
    """A window of 2 engine calls and 4 searches between two renders of
    ``registry``, which stands in for the program's; the record as the
    run builds it."""
    monkeypatch.setattr(metrics, "REGISTRY", registry)
    registry.observe("fugu_search_engine_seconds", 9.0)
    registry.observe("fugu_span_seconds", 1.0, span="engine.plan")
    registry.inc("fugu_h2d_bytes_total", 5e8, site="phase_a")
    registry.observe_later("fugu_gc_seconds", 3.0, generation="2")
    registry.render()
    for span, total, n in (("front.parse", 0.030, 4), ("front.respond", 0.010, 4),
                           ("engine.plan", 0.006, 2), ("engine.convert", 0.004, 2),
                           ("two_phase.stage", 0.020, 5),
                           ("two_phase.fetch", 0.002, 3),
                           ("two_phase.candidates", 0.008, 3),
                           ("two_phase.rescore", 0.012, 2)):
        for _ in range(n):
            registry.observe("fugu_span_seconds", total / n, span=span)
    for _ in range(2):
        registry.observe("fugu_search_engine_seconds", 0.05)
    for site, n in (("phase_a", 21_000_000), ("postproc", 3_000_000),
                    ("block_rows", 1_000_000)):
        registry.inc("fugu_h2d_bytes_total", n, site=site)
    registry.observe_later("fugu_gc_seconds", 0.4, generation="2")
    registry.observe_later("fugu_gc_seconds", 0.1, generation="0")
    registry.render()
    return {"traced_s": 10.0, "stages": {
        "fugu_search_engine_seconds": (0.1, 2.0),
        "fugu_search_queue_wait_seconds": (0.02, 4.0)}}


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_reads_the_window(name, monkeypatch):
    rec = synthetic_window(monkeypatch, metrics.Metrics())
    assert manifest.reader(name)(rec) == pytest.approx(READERS[name])


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_gives_none_on_another_window(name, monkeypatch):
    """Renders that are not the window's (another engine-call count), or
    a program whose registry keeps no renders, read as None."""
    rec = synthetic_window(monkeypatch, metrics.Metrics())
    rec["stages"]["fugu_search_engine_seconds"] = (0.15, 3.0)
    assert manifest.reader(name)(rec) is None

    class Parent:  # the registry before it kept its renders
        def render(self):
            return ""

    monkeypatch.setattr(metrics, "REGISTRY", Parent())
    rec["stages"]["fugu_search_engine_seconds"] = (0.1, 2.0)
    assert manifest.reader(name)(rec) is None


def test_readers_are_in_the_manifest():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in READERS:
        m = entries[name]
        assert m["workloads"] == ["msmarco-passage-1m.questions-c64"]
        assert m["source"] in ("program_span", "program_counter")
        assert m["unit"] in ("ms", "MB", "%") and m["better"] == "lower"
