"""The port's serving layers against the reference's: the intended-API
knobs of tests/test_api_extensions.py, the micro-batcher cases of
tests/test_batcher.py, and the metrics and span cases of
tests/test_observability.py.

The HTTP cases run on the pair of live servers of
tests/test_torch_server.py (every response of the port's server is held
to the reference's: equal status, equal body, scores bit for bit); the
package-level cases run on each package.  Then the batcher against the
port's engine: concurrent HTTP searches coalesce into fewer
``search_many`` calls than requests, each waiter gets its own query's
result, equal to a direct ``Dataset.search`` and to the oracle, and an
exception in ``search_many`` reaches every waiter of its batch without
hanging the next one."""

import asyncio
import logging
import threading

import pytest
import torch

from test_torch_repairs import hits, oracle_hits
from test_torch_server import (  # noqa: F401 (the fixture applies here)
    PairServer,
    device_engine_for_small_segments,
)
from test_torch_writer import PKGS, PORT

torch.set_num_threads(1)


def in_threads(worker, n):
    threads = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)


# -- tests/test_api_extensions.py, the server cases -----------------------------


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    srv = PairServer(tmp_path_factory.mktemp("apiext"))
    docs = [
        {"id": "h1", "text": "the quick brown fox jumps over the lazy dog"},
        {"id": "h2", "text": "a fox " + "filler " * 40 + "fox den at the end"},
        {"id": "h3", "text": "nothing relevant here"},
    ]
    status, _ = srv.post_json("/ingest", {"data": docs})
    assert status == 200
    yield srv
    srv.stop()


def test_bm25_knobs_change_scores(server):
    _, base = server.post_json("/search/json", {"query": "fox", "text": True})
    _, flat = server.post_json(
        "/search/json", {"query": "fox", "text": True, "bm25_b": 0.0}
    )
    assert base["results"] and flat["results"]
    # with b=0 length normalization is off -> scores differ
    assert base["results"][0]["score"] != flat["results"][0]["score"]


def test_min_score_threshold(server):
    _, out = server.post_json(
        "/search/json", {"query": "fox", "min_score_threshold": 1e9}
    )
    assert out["results"] == []


def test_highlight_snippets(server):
    _, out = server.post_json(
        "/search/json", {"query": "fox", "text": True, "highlight_snippets": True}
    )
    snips = {r["id"]: r["snippet"] for r in out["results"]}
    assert "<em>fox</em>" in snips["h1"]


class TestErrorContracts:
    """Caller mistakes get JSON envelopes with caller-mistake statuses,
    never aiohttp's HTML 500 (and never 5xx alert noise for typos)."""

    def test_unknown_namespace_is_404_json(self, server):
        status, out = server.get_json("/search?q=x&namespace=no_such_ns")
        assert status == 404
        assert "no_such_ns" in out["error"]
        assert '"' not in out["error"].replace('\\"', "")  # no KeyError quoting

    def test_bad_int_params_are_400_json(self, server):
        for path in (
            "/objects?page=abc",
            "/suggest?q=x&limit=abc",
            "/facets/tree?max_depth=abc",
        ):
            status, out = server.get_json(path)
            assert status == 400, path
            assert "invalid" in out["error"], path

    def test_post_search_clamps_per_page(self, server):
        status, out = server.post_json(
            "/search", {"query": "quick", "page": {"per_page": 100000000}}
        )
        assert status == 200
        assert out["per_page"] == 20  # (0,100] -> 20, like every route


# -- tests/test_batcher.py ------------------------------------------------------


@pytest.fixture(scope="module")
def batch_server(tmp_path_factory):
    srv = PairServer(tmp_path_factory.mktemp("batch_data"))
    docs = [
        {"id": f"b{i}", "text": f"common word{i % 7} special{i}",
         "namespace": "default"}
        for i in range(50)
    ]
    status, _ = srv.post_json("/ingest", {"data": docs})
    assert status == 200
    yield srv
    srv.stop()


def test_concurrent_searches_batched(batch_server):
    """Fire 24 concurrent searches; all must return their own results."""
    results = {}
    errors = []

    def worker(i):
        try:
            status, out = batch_server.get_json(
                f"/search?q=special{i}&text=true")
            assert status == 200
            results[i] = [r["id"] for r in out["results"]]
        except Exception as e:  # pragma: no cover
            errors.append(e)

    in_threads(worker, 24)
    assert not errors
    for i in range(24):
        assert results[i] == [f"b{i}"], (i, results[i])


def test_mixed_queries_same_window(batch_server):
    results = {}

    def worker(i):
        q = "common" if i % 2 == 0 else f"word{i % 7}"
        status, out = batch_server.get_json(f"/search?q={q}")
        results[i] = (status, out["total"])

    in_threads(worker, 10)
    assert len(results) == 10
    for i, (status, total) in results.items():
        assert status == 200
        assert total > 0


def gated_batches(pkg, max_batch, n_rest, settle):
    """Batch sizes a ``SearchBatcher`` of one batch in flight dispatches
    when ``n_rest`` searches arrive while its first batch is blocked;
    [sizes before the release, sizes at the end]."""
    batch_sizes = []
    release = threading.Event()
    seen = []

    class FakeDataset:
        def search_many(self, queries, page, per_page):
            batch_sizes.append(len(queries))
            if len(batch_sizes) == 1:
                release.wait(10)  # first batch blocks until released
            return [[] for _ in queries]

    async def main():
        b = pkg.batcher.SearchBatcher(
            window_ms=1.0, max_batch=max_batch, max_inflight=1)
        ds = FakeDataset()

        async def one(q):
            return await b.search(ds, q, (), 0, 10)

        first = asyncio.create_task(one("q0"))
        await asyncio.sleep(0.05)  # batch 1 dispatched, now blocked
        assert batch_sizes == [1]
        rest = [asyncio.create_task(one(f"q{i}"))
                for i in range(1, 1 + n_rest)]
        await asyncio.sleep(settle)  # window long past
        seen.append(list(batch_sizes))
        release.set()
        await asyncio.gather(first, *rest)
        seen.append(list(batch_sizes))

    asyncio.run(main())
    return seen


@pytest.mark.parametrize("pkg", PKGS, ids=lambda p: p.name)
def test_inflight_gate_coalesces_under_load(pkg):
    """While one batch executes, later arrivals hold in the queue and
    dispatch as ONE batch the moment the slot frees (continuous
    batching), not as many tiny overlapping batches."""
    assert gated_batches(pkg, 256, 8, 0.05) == [[1], [1, 8]]


@pytest.mark.parametrize("pkg", PKGS, ids=lambda p: p.name)
def test_full_queue_bypasses_gate(pkg):
    """A queue at max_batch dispatches immediately even while another
    batch runs: the gate bounds batch count, not queue memory."""
    assert gated_batches(pkg, 4, 4, 0.2) == [[1, 4], [1, 4]]


# -- the batcher against the port's engine --------------------------------------


@pytest.fixture()
def counted_search_many(batch_server, monkeypatch):
    """The port dataset's ``search_many`` calls, as lists of queries."""
    ds = batch_server.db.get_dataset("default")
    calls = []
    real = ds.search_many

    def counted(queries, page, per_page):
        calls.append([q for q, _f in queries])
        return real(queries, page, per_page)

    monkeypatch.setattr(ds, "search_many", counted)
    return ds, calls


def test_http_searches_coalesce_into_fewer_engine_calls(
        batch_server, counted_search_many):
    """48 concurrent searches, one thread each: fewer ``search_many``
    calls than requests, every waiter its own query's result, equal to a
    direct ``Dataset.search`` and to the oracle."""
    ds, calls = counted_search_many
    live = batch_server.live
    queries = [f"special{i} word{i % 7}" for i in range(48)]
    results = {}
    status, _ = live.get("/search?q=common")  # one batch in flight first
    assert status == 200
    calls.clear()

    def worker(i):
        status, out = live.post_json(
            "/search/json",
            {"query": queries[i], "page": {"page": 0, "per_page": 10}})
        results[i] = (status, [(r["id"], r["score"]) for r in out["results"]])

    in_threads(worker, len(queries))
    assert sorted(q for c in calls for q in c) == sorted(queries)
    assert len(calls) < len(queries), [len(c) for c in calls]
    assert max(len(c) for c in calls) > 1
    for i, q in enumerate(queries):
        status, got = results[i]
        assert status == 200
        direct = ds.search(q, [], 0, 10)
        assert got == [(r.id, r.score) for r in direct], q
        assert hits(direct) == oracle_hits(PORT, ds, q, [], 10)
        assert got[0][0] == f"b{i}"


def test_engine_error_reaches_every_waiter_and_next_batch_is_served(
        batch_server, monkeypatch):
    """``search_many`` raising fails every request of that batch with the
    error envelope (no hung future), and the next batch is answered."""
    live = batch_server.live
    ds = batch_server.db.get_dataset("default")
    real = ds.search_many
    failed = []

    def failing(queries, page, per_page):
        failed.append(len(queries))
        raise RuntimeError("injected engine failure")

    monkeypatch.setattr(ds, "search_many", failing)
    results = {}

    def worker(i):
        results[i] = live.get_json(f"/search?q=special{i}")

    in_threads(worker, 12)
    assert len(results) == 12 and sum(failed) == 12
    for status, out in results.values():
        assert status == 500
        assert "injected engine failure" in out["error"]
    monkeypatch.setattr(ds, "search_many", real)
    status, out = batch_server.get_json("/search?q=special3")
    assert status == 200 and [r["id"] for r in out["results"]] == ["b3"]
    state = live.app["state"]
    assert not state.batcher._inflight and not state.batcher._running


# -- tests/test_observability.py ------------------------------------------------


@pytest.mark.parametrize("pkg", PKGS, ids=lambda p: p.name)
def test_counters_and_histograms(pkg):
    m = pkg.metrics.Metrics()
    m.inc("reqs_total")
    m.inc("reqs_total")
    m.inc("reqs_total", status="error")
    m.observe("lat_seconds", 0.003)
    m.observe("lat_seconds", 0.2)
    text = m.render()
    assert "reqs_total 2.0" in text
    assert 'reqs_total{status="error"} 1.0' in text
    assert 'lat_seconds_bucket{le="0.005"} 1' in text
    assert "lat_seconds_count 2" in text


@pytest.mark.parametrize("pkg", PKGS, ids=lambda p: p.name)
def test_timed_context(pkg):
    registry = pkg.metrics.REGISTRY
    m_before = registry.hist_count.get("unit_test_seconds", 0)
    with pkg.metrics.timed("unit_test"):
        pass
    assert registry.hist_count["unit_test_seconds"] == m_before + 1


def test_metrics_endpoint(tmp_path):
    srv = PairServer(tmp_path)
    try:
        srv.post_json(
            "/ingest", {"data": [{"id": "m1", "text": "metric doc"}]}
        )
        srv.get("/search?q=metric")
        status, body = srv.get("/metrics")
        assert status == 200
        assert "fugu_ingested_documents_total" in body
        assert "fugu_search_seconds_bucket" in body
        # the batcher's stages, and the packs the search left resident
        for stage in ("queue_wait", "exec_wait", "engine", "serialize"):
            assert f"fugu_search_{stage}_seconds_count" in body
        resident = [line for line in body.splitlines()
                    if line.startswith("fugu_device_resident_bytes ")]
        assert int(resident[0].split()[1]) > 0
        assert 'fugu_device_resident_bytes_by_kind{kind="entry"}' in body
    finally:
        srv.stop()


@pytest.mark.parametrize("pkg", PKGS, ids=lambda p: p.name)
def test_spans_nest_and_log(pkg, caplog):
    telemetry = pkg.telemetry
    name = telemetry.__name__.split(".")[0]
    telemetry.init_tracing(log_file=None, console=False)
    with caplog.at_level(logging.DEBUG, logger=name):
        with telemetry.server_span("/x", "GET"):
            with telemetry.query_span("inner"):
                logging.getLogger(name).debug("inside")
    assert any("inside" in r.message for r in caplog.records)


def test_metrics_exposes_compaction_gauges(tmp_path):
    """/metrics carries live per-index segment and compaction counters
    (write amplification is observable in production)."""
    s = PairServer(tmp_path)
    try:
        for i in range(3):
            s.post_json(
                "/ingest", {"data": [{"id": f"m{i}", "text": f"metric doc {i}"}]}
            )
        status, body = s.get("/metrics")
        assert status == 200
        assert 'fugu_segments{namespace="default",index="docs"}' in body
        assert 'fugu_docs_ingested{namespace="default",index="docs"} 3' in body
        assert "fugu_compaction_merges" in body
    finally:
        s.stop()
