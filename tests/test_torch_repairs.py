"""Reference cases whose code the port carries, run on the port.

Each scenario runs on the port (``device="cpu"``: the device engine with
its kernels' plain versions) and on the reference (``use_device=False``)
and the two results must be equal; searches are also held to the NumPy
oracle over the same snapshot.  The scenarios are those of
tests/test_crash_recovery.py, tests/test_e2e_fuzz.py, the direct
``Dataset`` cases of tests/test_api_extensions.py, the OTel-gating and
spilled-index cases of tests/test_faults.py and tests/test_concurrency.py
(its mesh case is in tests/test_torch_sharded_engine.py), followed by
the port's own concurrency cases: route counters, pack uploads and
residency books under searches from several threads."""

import os
import sys
import threading
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from fugu_tpu_torch.ops import residency
from test_torch_dataset import norm
from test_torch_writer import PKGS, PORT, REF

torch.set_num_threads(1)


@pytest.fixture()
def small_segments_on_device(monkeypatch):
    """Segments of any size reach the port's device engine."""
    monkeypatch.setattr(PORT.named_index_module, "DEVICE_MIN_ENTRIES", 1)


@pytest.fixture()
def hybrid_engine(monkeypatch):
    """Segments of any size take the port's hybrid engine."""
    monkeypatch.setattr(PORT.named_index_module, "SMALL_SEGMENT_MAX_DOCS", 0)


def oracle_hits(pkg, ds, query, filters, limit, segs=None):
    """[(id, float32 score)] of the oracle over ``segs``, by default
    ``ds``'s docs snapshot."""
    if segs is None:
        segs = ds.docs().searcher_segments()
    stats = ds.docs().stats_for(segs)
    plan = ds.build_search_plan(query, filters, False)
    return [(segs[h.segment_ord].stored[h.doc]["id"], np.float32(h.score))
            for h in pkg.oracle.search(segs, plan, limit, stats)]


def hits(results):
    return [(r.id, np.float32(r.score)) for r in results]


def checked_search(pkg, ds, query, filters, limit, **kw):
    """``ds.search`` held to the oracle (for default k1 and b) on the
    segments the search read.  Background compaction is drained first,
    and no merge may swap the segments between the search and the
    oracle: a merge that drops tombstoned docs changes the doc
    frequencies, so the two would score different snapshots."""
    assert ds.wait_compaction(60), "background compaction did not drain"
    segs = ds.docs().searcher_segments()
    got = ds.search(query, filters, 0, limit, **kw)
    if not kw:
        want = oracle_hits(pkg, ds, query, filters, limit, segs)
        now = ds.docs().searcher_segments()
        assert len(now) == len(segs) and all(
            a is b for a, b in zip(now, segs)), "a merge ran during the check"
        assert hits(got) == want, query
    return got


def both(case, tmp_path, *args):
    """Run ``case`` on the port and on the reference; equal results."""
    got = norm(case(PORT, tmp_path / "port", *args))
    want = norm(case(REF, tmp_path / "ref", *args))
    assert got == want
    return got


# -- tests/test_crash_recovery.py ---------------------------------------------


def _mk(pkg, tmp):
    mgr = pkg.manager.DatasetManager.with_defaults(str(tmp), "crashns",
                                                   **pkg.mgr_kw)
    ds = mgr.get_or_create_dataset("crashns")
    ds.ingest([
        pkg.ObjectRecord(id="a", text="the quick brown fox"),
        pkg.ObjectRecord(id="b", text="lazy dogs sleep"),
        pkg.ObjectRecord(id="c", text="quick dogs and foxes"),
    ])
    return mgr, ds


def _reopen(pkg, tmp):
    mgr = pkg.manager.DatasetManager.with_defaults(str(tmp), "crashns",
                                                   **pkg.mgr_kw)
    return mgr.get_or_create_dataset("crashns")


def _docs_dir(tmp) -> Path:
    return Path(tmp) / "crashns" / "docs"


def c_torn_uncommitted_files_ignored_on_reopen(pkg, tmp):
    mgr, ds = _mk(pkg, tmp)
    want = checked_search(pkg, ds, "quick", [], 10)
    assert want  # committed state serves

    d = _docs_dir(tmp)
    assert (d / "meta.json").exists()
    # crash mid-commit: a torn, manifest-unreferenced segment pack...
    (d / "seg-deadbeefdeadbeef.npz").write_bytes(b"PK\x03\x04 torn!")
    # ...a torn doc store for the same orphan...
    (d / "seg-deadbeefdeadbeef.store.msgpack").write_bytes(b"\x93tor")
    # ...a stale manifest tmp from the dying process...
    (d / f"meta.json.tmp{os.getpid() + 1}").write_bytes(b'{"generation"')
    # ...and a torn tombstone tmp
    (d / "seg-deadbeefdeadbeef.tomb.tmp99.npy").write_bytes(b"\x93NUM")

    ds2 = _reopen(pkg, tmp)
    again = checked_search(pkg, ds2, "quick", [], 10)
    assert hits(again) == hits(want)
    # startup gc reclaimed the orphan pack (it was never published)
    assert not (d / "seg-deadbeefdeadbeef.npz").exists()
    # and writes still work after recovery
    ds2.ingest([pkg.ObjectRecord(id="e", text="quick recovery doc")])
    after = checked_search(pkg, ds2, "recovery", [], 10)
    assert {r.id for r in after} == {"e"}
    return want, again, after


def c_stale_manifest_tmp_never_shadows(pkg, tmp):
    mgr, ds = _mk(pkg, tmp)
    want = checked_search(pkg, ds, "dogs", [], 10)
    d = _docs_dir(tmp)
    real = (d / "meta.json").read_bytes()
    # a crashed writer's half-written manifest tmp must not be read
    (d / "meta.json.tmp424242").write_bytes(real[: len(real) // 2])
    again = checked_search(pkg, _reopen(pkg, tmp), "dogs", [], 10)
    assert hits(again) == hits(want)
    return want, again


def c_truncated_committed_pack_fails_loudly(pkg, tmp):
    """Real data loss (a COMMITTED pack torn on disk) must raise on
    reopen, not silently serve partial results."""
    mgr, ds = _mk(pkg, tmp)
    packs = sorted(_docs_dir(tmp).glob("seg-*.npz"))
    assert packs
    data = packs[0].read_bytes()
    packs[0].write_bytes(data[: max(len(data) // 3, 8)])
    with pytest.raises(Exception) as raised:
        _reopen(pkg, tmp).search("quick", [], 0, 10)
    return type(raised.value).__name__


# -- tests/test_api_extensions.py, the direct Dataset cases ---------------------


def c_dataset_knobs_direct(pkg, tmp):
    ds = pkg.Dataset("kn", tmp, **pkg.kw)
    ds.ingest([
        pkg.ObjectRecord(id="a", text="word short", namespace="kn"),
        pkg.ObjectRecord(id="b", text="word " + "pad " * 50, namespace="kn"),
    ])
    default = checked_search(pkg, ds, "word", [], 10)
    no_norm = checked_search(pkg, ds, "word", [], 10, b=0.0)
    # b=0: doc length no longer matters -> equal scores
    assert no_norm[0].score == pytest.approx(no_norm[1].score, rel=1e-6)
    assert default[0].score != pytest.approx(default[1].score, rel=1e-6)
    return default, no_norm


def c_bare_star_filter_is_noop(pkg, tmp):
    """'*' is excluded from the facet query upstream (search.rs:101-105):
    it must not become an unmatchable MUST."""
    ds = pkg.Dataset("starns", tmp, **pkg.kw)
    ds.ingest([pkg.ObjectRecord(id=f"s{i}", text="star topic",
                                namespace="starns") for i in range(5)])
    plain = checked_search(pkg, ds, "star", [], 10)
    starred = ds.search("star", ["*"], 0, 10)
    assert [r.id for r in starred] == [r.id for r in plain]
    assert len(starred) == 5
    return plain, starred


def c_k1_override_reaches_subplans(pkg, tmp):
    """(a AND b) OR c builds a nested subplan; per-query k1/b must apply
    inside it, not just at the top level."""
    ds = pkg.Dataset("subk", tmp, **pkg.kw)
    ds.ingest([
        pkg.ObjectRecord(id="a1", text="alpha beta words here",
                         namespace="subk"),
        pkg.ObjectRecord(id="a2", text="alpha beta beta beta beta",
                         namespace="subk"),
        pkg.ObjectRecord(id="c1", text="gamma words", namespace="subk"),
    ])
    q = "(alpha AND beta) OR gamma"
    base = checked_search(pkg, ds, q, [], 10)
    tuned = checked_search(pkg, ds, q, [], 10, k1=0.01)
    b, t = ({r.id: r.score for r in res} for res in (base, tuned))
    # k1 affects tf saturation: the subplan-scored docs must move too
    assert t["a2"] != b["a2"], "subplan ignored the k1 override"
    assert t["c1"] != b["c1"]
    return base, tuned


# -- tests/test_faults.py: the spilled index ----------------------------------


def c_spilled_index_reports_unloaded_but_counted(pkg, tmp):
    """A cold (spilled) index reports unloaded, but keeps its live-doc
    count visible."""
    ds = pkg.Dataset("faults", tmp, **pkg.kw)
    ds.ingest([pkg.ObjectRecord(id=f"f{i}", text=f"resilient w{i % 12} doc",
                                namespace="faults") for i in range(20)])
    ds.spill(str(tmp / "remote"))
    assert ds.docs().num_docs == 20
    assert not ds.docs().is_loaded
    return ds.stats()


CASES = {name[2:]: fn for name, fn in globals().items()
         if name.startswith("c_")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_case_matches_reference(case, tmp_path, small_segments_on_device):
    both(CASES[case], tmp_path)


@pytest.mark.parametrize("pkg", PKGS, ids=lambda p: p.name)
def test_otel_gating_with_stub_exporter(pkg, monkeypatch):
    telemetry = pkg.telemetry
    # 1) endpoint unset -> no pipeline
    monkeypatch.delenv("OTEL_EXPORTER_OTLP_ENDPOINT", raising=False)
    assert telemetry._init_otel() is None

    # 2) endpoint set, package missing -> logged, no pipeline
    monkeypatch.setenv("OTEL_EXPORTER_OTLP_ENDPOINT", "http://otel:4317")
    monkeypatch.setitem(sys.modules, "opentelemetry", None)
    try:
        assert telemetry._init_otel() is None
    finally:
        sys.modules.pop("opentelemetry", None)

    # 3) endpoint set but only the API surface importable (no SDK): the
    #    full pipeline cannot assemble, so init degrades to log-only
    stub = types.ModuleType("opentelemetry")
    stub.trace = types.SimpleNamespace(get_tracer=lambda name: object())
    monkeypatch.setitem(sys.modules, "opentelemetry", stub)
    assert telemetry._init_otel() is None


# -- tests/test_e2e_fuzz.py -----------------------------------------------------

WORDS = [f"w{i}" for i in range(24)]


def fuzz_records(pkg):
    rng = np.random.default_rng(31)
    recs = []
    for i in range(4000):
        text = " ".join(rng.choice(WORDS, size=int(rng.integers(3, 14))))
        recs.append(pkg.ObjectRecord(
            id=f"d{i}", text=text, namespace="fuzzns",
            facets=[f"/cat/{int(rng.integers(0, 4))}"]))
    return recs


def random_query(rng) -> str:
    parts = []
    n = int(rng.integers(1, 4))
    for _ in range(n):
        w = WORDS[int(rng.integers(0, len(WORDS)))]
        r = rng.random()
        if r < 0.12:
            parts.append(f'"{w} {WORDS[int(rng.integers(0, len(WORDS)))]}"')
        elif r < 0.2:
            parts.append(f"+{w}")
        elif r < 0.27:
            parts.append(f"-{w}")
        elif r < 0.34:
            parts.append(f"text:{w}")
        elif r < 0.4:
            parts.append(f"{w}^2")
        elif r < 0.46 and n > 1:
            parts.append(f"({w} OR {WORDS[int(rng.integers(0, len(WORDS)))]})")
        else:
            parts.append(w)
        if rng.random() < 0.18:
            parts.append(rng.choice(["AND", "OR"]))
    q = " ".join(parts)
    return q.rstrip("ANDOR ") or "w0"


def test_device_host_agree_on_random_query_strings(tmp_path, hybrid_engine):
    """Random query strings through parse -> plan -> engine: the port's
    device stack, the port's host-only stack, the reference's host-only
    stack and the oracle agree bit for bit on ids and scores."""
    routes = random_query_strings_agree(tmp_path)
    assert routes["phase_a"] > 0 and routes["host_only"] > 0, routes
    assert not routes.get("small_segment")


def test_random_query_strings_small_segment_engine(tmp_path):
    """The same strings with the size constant at its default: the
    small-segment engine answers every plan without a phrase."""
    routes = random_query_strings_agree(tmp_path)
    assert routes["small_segment"] > 0 and routes["host_only"] > 0, routes
    assert not routes.get("phase_a") and not routes.get("host"), routes


def random_query_strings_agree(tmp_path):
    """Hold the port's device stack to its host-only stack, the
    reference's and the oracle; the port's route counts."""
    dev = PORT.Dataset("fuzzns", tmp_path / "port", device="cpu")
    dev.ingest(fuzz_records(PORT))
    host = PORT.Dataset("fuzzns", tmp_path / "port", use_device=False)
    ref = REF.Dataset("fuzzns", tmp_path / "ref", use_device=False)
    ref.ingest(fuzz_records(REF))
    assert dev.docs().segments[0].n_entries >= (
        PORT.named_index_module.DEVICE_MIN_ENTRIES)
    rng = np.random.default_rng(77)
    checked = 0
    for trial in range(80):
        q = random_query(rng)
        filters = (
            [f"/cat/{int(rng.integers(0, 4))}"] if rng.random() < 0.25 else []
        )
        per_page = int(rng.choice([5, 10, 20]))
        g = hits(dev.search(q, filters, 0, per_page))
        assert g == hits(host.search(q, filters, 0, per_page)), (trial, q)
        assert g == hits(ref.search(q, filters, 0, per_page)), (trial, q)
        assert g == oracle_hits(PORT, dev, q, filters, per_page), (trial, q)
        checked += len(g)
    assert checked > 100  # the grammar produces real matches
    return dev.docs().routes


# -- tests/test_concurrency.py --------------------------------------------------


def rec(pkg, i, text):
    return pkg.ObjectRecord(id=f"doc{i}", text=text, namespace="default")


@pytest.fixture(params=PKGS, ids=lambda p: p.name)
def pkg_ds(request, tmp_path, small_segments_on_device):
    pkg = request.param
    cfg = pkg.config.ServerConfig.with_defaults(str(tmp_path), "default")
    mgr = pkg.manager.DatasetManager(cfg, **pkg.mgr_kw)
    yield pkg, mgr.get_dataset("default")
    mgr.close()


def run_threads(targets, timeout=120):
    threads = [threading.Thread(target=t) for t in targets]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    assert not any(t.is_alive() for t in threads), "a thread hung"


def test_search_during_ingest(pkg_ds):
    """Readers race a writer ingesting 40 batches; every search must
    return a consistent (possibly stale) view and never raise."""
    pkg, ds = pkg_ds
    errors = []
    stop = threading.Event()

    def writer():
        try:
            for b in range(40):
                ds.ingest([rec(pkg, b * 5 + j, f"common token{b}")
                           for j in range(5)])
        except Exception as e:  # pragma: no cover
            errors.append(e)
        finally:
            stop.set()

    def reader():
        try:
            while not stop.is_set():
                ids = [h.id for h in ds.search("common", [], 0, 300)]
                assert len(ids) == len(set(ids)), "duplicate ids in one view"
        except Exception as e:  # pragma: no cover
            errors.append(e)

    run_threads([writer] + [reader] * 3)
    assert not errors, errors
    assert len(ds.search("common", [], 0, 300)) == 200


def test_search_during_compaction(pkg_ds):
    pkg, ds = pkg_ds
    for b in range(6):
        ds.ingest([rec(pkg, b * 3 + j, "stable corpus words")
                   for j in range(3)])
    assert len(ds.docs().segments) > 1
    errors = []
    stop = threading.Event()

    def compactor():
        try:
            ds.compact()
        except Exception as e:  # pragma: no cover
            errors.append(e)
        finally:
            stop.set()

    def reader():
        try:
            while not stop.is_set():
                assert len(ds.search("stable", [], 0, 50)) == 18
        except Exception as e:  # pragma: no cover
            errors.append(e)

    run_threads([compactor] + [reader] * 2)
    assert not errors, errors
    assert len(ds.docs().segments) == 1
    assert len(checked_search(pkg, ds, "stable", [], 50)) == 18


def test_delete_during_search(pkg_ds):
    pkg, ds = pkg_ds
    ds.ingest([rec(pkg, i, "ephemeral data point") for i in range(30)])
    errors = []
    stop = threading.Event()

    def deleter():
        try:
            for i in range(15):
                ds.delete_document(f"doc{i}")
        except Exception as e:  # pragma: no cover
            errors.append(e)
        finally:
            stop.set()

    def reader():
        try:
            while not stop.is_set():
                assert 15 <= len(ds.search("ephemeral", [], 0, 60)) <= 30
        except Exception as e:  # pragma: no cover
            errors.append(e)

    run_threads([deleter, reader])
    assert not errors, errors
    assert len(checked_search(pkg, ds, "ephemeral", [], 60)) == 15


def test_concurrent_upserts_same_ids(pkg_ds):
    """Two writers upserting overlapping id ranges must serialize on the
    writer lock, and no id may appear twice."""
    pkg, ds = pkg_ds
    errors = []

    def writer(tag):
        def run():
            try:
                for b in range(10):
                    ds.upsert([rec(pkg, b * 4 + j, f"{tag} payload")
                               for j in range(4)])
            except Exception as e:  # pragma: no cover
                errors.append(e)
        return run

    run_threads([writer("alpha"), writer("beta")])
    assert not errors, errors
    ids = [h.id for h in checked_search(pkg, ds, "payload", [], 200)]
    assert len(ids) == len(set(ids)) == 40


@pytest.mark.parametrize("pkg", PKGS, ids=lambda p: p.name)
def test_concurrent_get_or_create_single_instance(pkg, tmp_path):
    """Racing creators of the same namespace must all get the SAME
    instance, and other namespaces must not block."""
    mgr = pkg.manager.DatasetManager(
        pkg.config.ServerConfig.with_defaults(str(tmp_path), "default"),
        **pkg.mgr_kw)
    results = [None] * 8
    barrier = threading.Barrier(8)

    def create(i):
        def run():
            barrier.wait()
            ns = "shared" if i < 6 else f"other{i}"
            results[i] = (ns, mgr.get_or_create_dataset(ns))
        return run

    run_threads([create(i) for i in range(8)], timeout=30)
    shared = {id(ds) for ns, ds in results if ns == "shared"}
    assert len(shared) == 1, "racing creators built distinct datasets"
    assert all(ds is not None for _, ds in results)
    mgr.close()


# -- the port's engine from several threads at once -----------------------------


def busy_dataset(tmp_path, n=600):
    """A port dataset of two segments above DEVICE_MIN_ENTRIES."""
    rng = np.random.default_rng(5)
    ds = PORT.Dataset("busy", tmp_path, device="cpu", compaction="off")
    for half in range(2):
        ds.ingest([
            PORT.ObjectRecord(
                id=f"b{half}-{i}", namespace="busy",
                text=" ".join(rng.choice(WORDS, size=int(rng.integers(8, 20)))))
            for i in range(n)])
    assert all(s.n_entries >= PORT.named_index_module.DEVICE_MIN_ENTRIES
               for s in ds.docs().segments)
    return ds


def test_concurrent_search_many_counts_every_plan(tmp_path, hybrid_engine):
    """Eight threads batch-search one index: every thread's results equal
    a single-threaded run, and the route counters, updated under the
    index's lock, account for every plan on every segment."""
    routes = concurrent_search_many(tmp_path)
    assert routes.get("phase_a", 0) + routes.get("block_scorer", 0) > 0
    assert not routes.get("small_segment")


def test_concurrent_search_many_small_segment_engine(tmp_path):
    """The same threads with the size constant at its default: the
    small-segment engine, which keeps no state between calls, answers."""
    routes = concurrent_search_many(tmp_path)
    assert routes["small_segment"] > 0
    assert not routes.get("phase_a") and not routes.get("block_scorer")


def concurrent_search_many(tmp_path):
    """Eight threads' results against a single-threaded run and the
    oracle; the route counts of the threaded part."""
    ds = busy_dataset(tmp_path)
    rng = np.random.default_rng(9)
    batches = [[(random_query(rng), []) for _ in range(12)] for _ in range(8)]
    want = [[hits(r) for r in ds.search_many(b, 0, 10)] for b in batches]
    for b, w in zip(batches, want):
        for (q, f), h in zip(b, w):
            assert h == oracle_hits(PORT, ds, q, f, 10), q
    docs = ds.docs()
    docs.routes.clear()
    got = [None] * len(batches)
    errors = []

    def searcher(i):
        def run():
            try:
                for _ in range(4):
                    got[i] = [hits(r) for r in ds.search_many(batches[i], 0, 10)]
            except Exception as e:  # pragma: no cover
                errors.append(e)
        return run

    run_threads([searcher(i) for i in range(len(batches))])
    assert not errors, errors
    assert got == want
    assert sum(docs.routes.values()) == 8 * 4 * 12 * len(docs.segments)
    return docs.routes


def test_concurrent_first_queries_balance_residency(tmp_path, hybrid_engine):
    """First queries from several threads may upload a segment's packs
    more than once; the residency books still hold each pack once, at
    its own size."""
    first_queries_balance_residency(tmp_path, block_major=True)


def test_concurrent_first_queries_small_segment_engine(tmp_path):
    """The same through the small-segment engine, which keeps the entry
    pack resident and builds no block-major pack."""
    first_queries_balance_residency(tmp_path, block_major=False)


def first_queries_balance_residency(tmp_path, block_major):
    residency.reset_for_test()
    ds = busy_dataset(tmp_path)
    barrier = threading.Barrier(6)
    errors = []

    def first_query():
        try:
            barrier.wait()
            ds.search("w1 w2", [], 0, 10)
        except Exception as e:  # pragma: no cover
            errors.append(e)

    run_threads([first_query] * 6)
    assert not errors, errors
    stats = residency.stats()
    segs = ds.docs().segments
    cpu = torch.device("cpu")
    entry = 0
    for s in segs:
        pack = s.device_pack(cpu)
        entry += sum(t.numel() * t.element_size()
                     for t in (pack.e_doc, pack.e_tffid, pack.tomb))
    assert stats["by_kind"]["entry"] == entry
    assert all((getattr(s, "_block_major", None) is not None) == block_major
               for s in segs)
    assert stats["resident_packs"] == (1 + block_major) * len(segs)
    residency.reset_for_test()


def test_kernel_libraries_load_once_from_many_threads(tmp_path, monkeypatch):
    """cuda_build.load from several threads builds and loads a library
    once (the build and the loader are stubbed: there is no nvcc here)."""
    from fugu_tpu_torch import cuda_build

    built = []

    def fake_build(name):
        built.append(name)
        threading.Event().wait(0.05)
        return tmp_path / name

    monkeypatch.setattr(cuda_build, "build", fake_build)
    monkeypatch.setattr(cuda_build.ctypes, "CDLL", lambda path: object())
    monkeypatch.setattr(cuda_build, "_libs", {})
    libs = []
    run_threads([lambda: libs.append(cuda_build.load("phasea"))] * 6)
    assert built == ["phasea"]
    assert len({id(lib) for lib in libs}) == 1
