"""The port's HTTP server against the reference's, request by request.

Every case of tests/test_server.py runs on a pair of live servers: the
port's ``create_app`` over ``DatasetManager(cfg, device="cpu")`` (the
device engine on, every kernel wrapper running its plain PyTorch
version; ``DEVICE_MIN_ENTRIES`` lowered to 1 so that these few docs reach
it) and the reference's over ``DatasetManager(cfg, use_device=False)``,
each on its own directory.  ``PairServer`` sends each request to both
and requires equal status codes and equal bodies: hit ids, order and
score floats identical (tolerance 0).  What is removed before the
comparison is stated once, in ``normalized``.  Each case then keeps the
reference test's own assertions on the port's response."""

import asyncio
import json
import socket
import threading
import urllib.error
import urllib.request

import pytest
import torch
from aiohttp import web

import fugu_tpu.server.app
import fugu_tpu.server.batcher
import fugu_tpu.server.metrics
import fugu_tpu.server.openapi
import fugu_tpu.version
import fugu_tpu_torch.server.app
import fugu_tpu_torch.server.batcher
import fugu_tpu_torch.server.metrics
import fugu_tpu_torch.server.openapi
import fugu_tpu_torch.version
from test_torch_writer import PKGS, PORT, REF

torch.set_num_threads(1)

for _pkg, _root in ((PORT, fugu_tpu_torch), (REF, fugu_tpu)):
    _pkg.app = _root.server.app
    _pkg.batcher = _root.server.batcher
    _pkg.metrics = _root.server.metrics
    _pkg.openapi = _root.server.openapi
    _pkg.version = _root.version.__version__

#: keys removed from every JSON body before two servers' answers are
#: compared (wall-clock times); beside them only the package's name is
#: rewritten, and /metrics (timings, per-process registries) is compared
#: by status alone
DROPPED_KEYS = ("took_ms",)


def normalized(value):
    """A response body without ``DROPPED_KEYS`` and with the port's
    package name read as the reference's."""
    if isinstance(value, dict):
        return {k: normalized(v) for k, v in value.items()
                if k not in DROPPED_KEYS}
    if isinstance(value, list):
        return [normalized(v) for v in value]
    if isinstance(value, str):
        return value.replace("fugu_tpu_torch", "fugu_tpu")
    return value


def comparable(raw: str):
    try:
        return normalized(json.loads(raw))
    except json.JSONDecodeError:
        return normalized(raw)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module", autouse=True)
def device_engine_for_small_segments():
    """The port's indexes send every segment with a posting to the
    hybrid device engine (its plain versions here), not only those of
    4096 postings and more and of more docs than the small-segment
    engine's constant."""
    mp = pytest.MonkeyPatch()
    mp.setattr(PORT.named_index_module, "DEVICE_MIN_ENTRIES", 1)
    mp.setattr(PORT.named_index_module, "SMALL_SEGMENT_MAX_DOCS", 0)
    yield
    mp.undo()


class LiveServer:
    """One package's app on a thread with its own event loop."""

    def __init__(self, pkg, root, configure=None):
        self.pkg = pkg
        self.root = root
        root.mkdir(parents=True, exist_ok=True)
        cfg = pkg.config.ServerConfig.with_defaults(str(root), "default")
        if configure is not None:
            configure(cfg, root)
        self.db = pkg.manager.DatasetManager(cfg, **pkg.mgr_kw)
        self.port = _free_port()
        self.base = f"http://127.0.0.1:{self.port}"
        self._loop = asyncio.new_event_loop()
        self._started = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        assert self._started.wait(10)

    def _run(self):
        asyncio.set_event_loop(self._loop)

        async def boot():
            self.app = self.pkg.app.create_app(self.db)
            runner = web.AppRunner(self.app)
            await runner.setup()
            site = web.TCPSite(runner, "127.0.0.1", self.port)
            await site.start()
            self._runner = runner
            self._started.set()

        self._loop.run_until_complete(boot())
        self._loop.run_forever()

    def stop(self):
        async def cleanup():
            await self._runner.cleanup()

        fut = asyncio.run_coroutine_threadsafe(cleanup(), self._loop)
        fut.result(10)
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join(10)
        self.db.close()

    def request(self, method, path, body=None):
        data = None
        if body is not None:
            # "@ROOT@" in a body stands for this server's own directory
            data = json.dumps(body).replace("@ROOT@", str(self.root)).encode()
        req = urllib.request.Request(
            self.base + path,
            data=data,
            method=method,
            headers={"Content-Type": "application/json"} if data else {},
        )
        try:
            with urllib.request.urlopen(req, timeout=30) as resp:
                return resp.status, resp.read().decode()
        except urllib.error.HTTPError as e:
            return e.code, e.read().decode()

    def get(self, path):
        return self.request("GET", path)

    def get_json(self, path):
        status, body = self.get(path)
        return status, json.loads(body)

    def post_json(self, path, body):
        status, raw = self.request("POST", path, body)
        return status, json.loads(raw)


class PairServer(LiveServer):
    """The port's server and the reference's, fed the same requests.
    ``request`` returns the port's answer after holding it to the
    reference's; ``db`` and ``base`` are the port's."""

    def __init__(self, tmp_path, configure=None):
        self.live = LiveServer(PORT, tmp_path / "port", configure)
        self.ref = LiveServer(REF, tmp_path / "ref", configure)
        self.db, self.base, self.root = (
            self.live.db, self.live.base, self.live.root)
        self.compared = 0

    def stop(self):
        self.live.stop()
        self.ref.stop()

    def request(self, method, path, body=None):
        got = self.live.request(method, path, body)
        want = self.ref.request(method, path, body)
        assert got[0] == want[0], (method, path, got, want)
        if not path.startswith("/metrics"):
            assert comparable(got[1]) == comparable(want[1]), (method, path)
        self.compared += 1
        return got


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    srv = PairServer(tmp_path_factory.mktemp("server_data"))
    docs = [
        {
            "id": "s1",
            "text": "the quick brown fox jumps over the lazy dog",
            "namespace": "default",
            "data_type": "animal",
        },
        {
            "id": "s2",
            "text": "sphinx of black quartz judge my vow",
            "namespace": "default",
            "data_type": "pangram",
            "organization": "acme",
        },
        {
            "id": "s3",
            "text": "pack my box with five dozen liquor jugs",
            "namespace": "default",
            "conversation_id": "conv9",
            "metadata": {"name": "Jugs Pangram", "topic": "boxes"},
        },
    ]
    status, out = srv.post_json("/ingest", {"data": docs})
    assert status == 200 and out["status"] == "success"
    yield srv
    srv.stop()


def test_health(server):
    status, body = server.get("/health")
    assert status == 200
    # 7 text fields + facet + metadata + 3 dates = 12 (schemas.rs:7-31)
    assert body == "OK, found 12 in db"


def test_hi(server):
    status, out = server.get_json("/hi")
    assert out == {"message": "hi"}


def test_search_get(server):
    status, out = server.get_json("/search?q=quick%20fox")
    assert status == 200
    assert out["total"] >= 1
    assert out["results"][0]["id"] == "s1"
    assert "text" not in out["results"][0]  # stripped unless text=true
    assert "took_ms" in out


def test_search_get_with_text(server):
    _, out = server.get_json("/search?q=quick&text=true")
    assert "text" in out["results"][0]


def test_search_path(server):
    status, out = server.get_json("/search/sphinx%20quartz")
    assert status == 200
    assert out["results"][0]["id"] == "s2"


def test_search_post(server):
    status, out = server.post_json(
        "/search", {"query": "pangram liquor", "page": {"page": 0, "per_page": 10}}
    )
    assert status == 200
    assert out["status"] == "success"
    ids = [r["id"] for r in out["results"]]
    assert "s3" in ids


def test_search_post_namespace(server):
    status, out = server.post_json("/search/default", {"query": "fox"})
    assert status == 200
    assert out["results"][0]["id"] == "s1"
    status, out = server.post_json("/search/nope", {"query": "fox"})
    assert status == 404


def test_search_json_flags(server):
    status, out = server.post_json(
        "/search/json?text=true", {"query": "fox", "text": False}
    )
    assert status == 200
    assert "developer_message" in out
    assert "text" in out["results"][0]
    assert out["includes_data_objects"] is True
    status, out = server.post_json(
        "/search/json",
        {"query": "quartz", "filters": ["/namespace/default/organization/acme"]},
    )
    assert out["targeting_conversations_or_organizations"] is True
    assert out["includes_data_objects"] is False
    assert [r["id"] for r in out["results"]] == ["s2"]


def test_search_filters_constrain(server):
    status, out = server.post_json(
        "/search", {"query": "", "filters": ["/namespace/default/data/animal"]}
    )
    assert [r["id"] for r in out["results"]] == ["s1"]


def test_per_page_clamp(server):
    _, out = server.get_json("/search?q=quick&limit=1000")
    assert out["per_page"] == 20  # (0,100] clamp


def test_objects_get_by_id(server):
    status, out = server.get_json("/objects/s2")
    assert status == 200
    assert out["id"] == ["s2"]  # tantivy to_json array wrapping
    assert out["organization"] == ["acme"]


def test_objects_get_missing(server):
    _, out = server.get_json("/objects/zzz")
    assert "error" in out


def test_objects_list(server):
    status, out = server.get_json("/objects")
    assert status == 200
    assert out["total"] == 3
    assert len(out["objects"]) == 3


def test_objects_put_and_delete(server):
    status, out = server.request(
        "PUT", "/objects", {"data": [{"id": "tmp1", "text": "temporary doc"}]}
    )
    assert status == 200
    status, out = server.get_json("/search?q=temporary")
    assert out["total"] == 1
    status, raw = server.request("DELETE", "/objects/tmp1")
    assert status == 200
    status, out = server.get_json("/search?q=temporary")
    assert out["total"] == 0


def test_ingest_validation_400(server):
    status, out = server.post_json("/ingest", {"data": [{"id": "", "text": "x"}]})
    assert status == 400
    assert "Validation failed for object at index 0" in out["error"]


def test_ingest_namespace_counts(server):
    status, out = server.post_json(
        "/ingest/namespace",
        {
            "data": [
                {"id": "e1", "text": "explicit facets", "facets": ["/custom/path"]},
                {"id": "e2", "text": "generated facets", "namespace": "default"},
            ]
        },
    )
    assert out["explicit_facets_count"] == 1
    assert out["generated_facets_count"] == 1


def test_batch_upsert(server):
    status, out = server.post_json(
        "/batch/upsert", {"objects": [{"id": "b1", "text": "batch doc"}]}
    )
    assert out["upserted_count"] == 1


def test_namespaces_list(server):
    _, out = server.get_json("/namespaces")
    assert "default" in out["namespaces"]


def test_namespace_create_delete(server):
    status, out = server.post_json("/namespaces", {"name": "scratch"})
    assert status == 200
    _, out = server.get_json("/namespaces")
    assert "scratch" in out["namespaces"]
    status, _ = server.request("DELETE", "/namespaces/scratch")
    assert status == 200
    _, out = server.get_json("/namespaces")
    assert "scratch" not in out["namespaces"]


def test_namespace_facets(server):
    _, out = server.get_json("/namespaces/default/facets")
    assert out["status"] == "success"
    # the reference passes facet_root "/" (namespaces.rs handler), so this
    # returns the dataset's TOP-LEVEL facets, not the namespace subtree
    paths = [f["path"] for f in out["facets"]]
    assert "/namespace" in paths


def test_namespace_values(server):
    _, out = server.get_json("/namespaces/default/organizations")
    assert out["organizations"] == ["acme"]
    _, out = server.get_json("/namespaces/default/conversations")
    assert out["conversations"] == ["conv9"]
    _, out = server.get_json("/namespaces/default/data")
    assert set(out["data_types"]) >= {"animal", "pangram"}


def test_filters_list(server):
    _, out = server.get_json("/filters")
    values = [f["value"] for f in out["filters"]]
    assert "/namespace" in values


def test_filters_all(server):
    _, out = server.get_json("/filters/all")
    assert "/namespace/default/data" in out["filter_paths"]


def test_filters_path(server):
    _, out = server.get_json("/filters/path/namespace/default/data")
    assert set(out["values"]) >= {"animal", "pangram"}


def test_filters_namespace(server):
    _, out = server.get_json("/filters/namespace/default")
    assert out["status"] == "success"
    assert "/metadata" in out["filter_paths"] or out["filter_paths"] == {}


def test_filters_legacy(server):
    _, out = server.get_json("/filters/namespace")
    assert isinstance(out["filters"], list)


def test_facet_tree(server):
    _, out = server.get_json("/facets/tree")
    assert out["status"] == "success"
    assert "namespace" in out["data"]["tree"]
    _, limited = server.get_json("/facets/tree?max_depth=2")
    ns = limited["data"]["tree"].get("namespace")
    assert ns is None or ns["children"] == {}


def test_suggest(server):
    _, out = server.get_json("/suggest?q=sphinx")
    assert out["status"] == "success"


def test_openapi_and_swagger(server):
    status, out = server.get_json("/api.json")
    assert status == 200
    assert out["openapi"].startswith("3.")
    assert "/search" in out["paths"]
    status, body = server.get("/swagger")
    assert status == 200 and "swagger-ui" in body


def test_unknown_route_404(server):
    status, _ = server.get("/definitely/not/a/route")
    assert status == 404


def test_invalid_json_400(server):
    status, raw = server.request("POST", "/ingest", None)
    # no body at all -> error envelope
    assert status in (400, 500)


def test_compact_endpoint(server):
    # several ingest batches -> several segments; compaction merges them
    for i in range(3):
        server.post_json(
            "/ingest", {"data": [{"id": f"cpt{i}", "text": f"compact doc {i}"}]}
        )
    assert len(server.db.get_dataset("default").docs().segments) > 1
    status, out = server.post_json("/compact", {})
    assert status == 200 and out["status"] == "success"
    assert len(server.db.get_dataset("default").docs().segments) == 1
    _, res = server.get_json("/search?q=compact")
    assert res["total"] == 3
    status, _ = server.post_json("/compact/missing_ns", {})
    assert status == 404


def test_unparseable_query_returns_error_envelope(server):
    # trailing NOT survives character escaping, so both parse attempts
    # fail (search.rs's lenient path) -> error envelope, not a crash
    status, out = server.get_json("/search?q=fox%20NOT")
    assert status == 500
    assert "error" in out
    # the server is still healthy afterwards
    status, _ = server.get("/health")
    assert status == 200


def test_invalid_limit_param_400(server):
    status, out = server.get_json("/search?q=fox&limit=abc")
    assert status == 400
    assert "limit" in out["error"]


class TestShapeTolerantBodies:
    """Well-formed JSON with the wrong shape must produce JSON error
    envelopes / lenient defaults — never an aiohttp HTML 500."""

    def test_post_search_page_as_int(self, server):
        status, body = server.post_json("/search", {"query": "fox", "page": 5})
        assert status == 200  # wrong-shape page ignored, defaults used
        assert body["page"] == 0

    def test_post_search_array_body(self, server):
        status, raw = server.request("POST", "/search", ["not", "a", "dict"])
        assert status == 200  # reads as empty query, not HTML 500
        assert "results" in json.loads(raw)

    def test_post_search_scalar_filters(self, server):
        status, body = server.post_json(
            "/search", {"query": "fox", "filters": "abc"}
        )
        assert status == 200  # scalar filters dropped, not char-iterated
        assert body["total"] >= 1

    def test_ingest_non_dict_items_400(self, server):
        status, body = server.post_json("/ingest", {"data": ["not-a-dict"]})
        assert status == 400
        assert body["status"] == "error"

    def test_ingest_scalar_data_400(self, server):
        status, body = server.post_json("/ingest", {"data": "abc"})
        assert status == 400

    def test_put_objects_wrong_shape_400(self, server):
        status, raw = server.request("PUT", "/objects", {"data": [42]})
        assert status == 400
        assert json.loads(raw)["status"] == "error"


class TestUnknownNamespaceIs404:
    def test_namespace_facets_404(self, server):
        status, body = server.get_json("/namespaces/no-such-ns/facets")
        assert status == 404

    def test_namespace_orgs_404(self, server):
        status, body = server.get_json("/namespaces/no-such-ns/organizations")
        assert status == 404

    def test_search_json_with_knobs_404(self, server):
        status, body = server.post_json(
            "/search/json",
            {"query": "x", "namespace": "no-such-ns", "bm25_k1": 1.5},
        )
        assert status == 404


@pytest.mark.parametrize("pkg", PKGS, ids=lambda p: p.name)
def test_metrics_label_escaping(pkg):
    m = pkg.metrics.Metrics()
    m.inc("reqs", namespace='a\nb"c\\d')
    text = m.render()
    assert '\\n' in text and '\\"' in text and "\\\\" in text
    # exactly two physical lines: the metric line and trailing newline
    assert len([l for l in text.splitlines() if l.startswith("reqs")]) == 1


@pytest.mark.parametrize("pkg", PKGS, ids=lambda p: p.name)
def test_every_route_is_in_the_openapi_spec(pkg, tmp_path):
    """Drift guard: every registered route (method+path) must appear in
    /api.json."""
    db = pkg.manager.DatasetManager(
        pkg.config.ServerConfig.with_defaults(str(tmp_path), "default"),
        **pkg.mgr_kw)
    app = pkg.app.create_app(db)
    spec = pkg.openapi.build_openapi("0")["paths"]
    missing = []
    for resource in app.router.resources():
        info = resource.get_info()
        path = info.get("path") or info.get("formatter")
        if path in ("/api.json", "/swagger"):
            continue  # the docs endpoints describe, not appear in, the spec
        # aiohttp regex routes ({filter:.+}) normalize to {filter}
        norm = path.replace("{filter:.+}", "{filter}")
        for route in resource:
            method = route.method.lower()
            if method in ("head", "options"):
                continue
            if norm not in spec or method not in spec[norm]:
                missing.append((method.upper(), path))
    db.close()
    assert not missing, f"routes missing from /api.json: {missing}"


def test_pair_compared_every_request(server):
    """The module's cases went through both servers (the fixture counted
    each compared request), the port's searches through its device
    engine, and the two packages state one version."""
    assert server.compared > 40
    routes = server.db.get_dataset("default").docs().routes
    assert routes.get("phase_a", 0) + routes.get("block_scorer", 0) > 0, routes
    assert PORT.version == REF.version
    status, out = server.get_json("/api.json")
    assert status == 200 and out["info"]["version"] == PORT.version
