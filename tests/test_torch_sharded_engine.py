"""The port's sharded slice as a whole: ``Dataset``, ``NamedIndex`` and
``DatasetManager`` over a CPU mesh.

The cases of tests/test_sharded_engine.py, ``test_engine_sharded_batch``
and ``test_manager_config_sharding`` of tests/test_pallas_sharded.py,
``test_sharded_two_phase_through_named_index`` of
tests/test_batch_sharded.py and the mesh case of tests/test_concurrency.py
run on the port under ``enable_sharding(make_mesh(n, device="cpu"))``.
Each result must equal, in ids and float32 scores, the port's unsharded
result, the reference's (``use_device=False``) and the oracle over the
same snapshot, and the index's route counters must show which sharded
engine answered.  Each case runs with the size constant at its default
(the small-segment engine per shard) and at 0 (the two-phase engine and
the block scorer per shard)."""

import json
import os
import subprocess
import sys
import textwrap
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from fugu_tpu_torch.ops import oracle
from fugu_tpu_torch.parallel.sharded import make_mesh
from test_torch_dataset import norm
from test_torch_parallel import make_plans
from test_torch_repairs import checked_search, oracle_hits, run_threads
from test_torch_writer import PORT, REF

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent

#: the route each engine setting must show
ROUTES = {"small": "sharded_small", "two_phase": "sharded_phase_a"}


@pytest.fixture(params=sorted(ROUTES))
def engine(request, monkeypatch):
    """The size constant: at its default (the small-segment engine per
    shard) or at 0 (the two-phase engine per shard)."""
    if request.param == "two_phase":
        monkeypatch.setattr(PORT.named_index_module,
                            "SMALL_SEGMENT_MAX_DOCS", 0)
    return request.param


def cpu_mesh(n, n_slices=1):
    return make_mesh(n, n_slices=n_slices, device="cpu")


def results(res):
    return [(r.id, np.float32(r.score)) for r in res]


# -- tests/test_sharded_engine.py -----------------------------------------------


def test_dataset_search_through_mesh(tmp_path, engine):
    rng = np.random.default_rng(0)
    vocab = [f"w{i}" for i in range(50)]
    texts = [" ".join(rng.choice(vocab, size=20)) for _ in range(600)]
    ds = PORT.Dataset("mesh", tmp_path / "port", device="cpu")
    ref = REF.Dataset("mesh", tmp_path / "ref", use_device=False)
    for pkg, d in ((PORT, ds), (REF, ref)):
        d.ingest([pkg.ObjectRecord(id=f"m{i}", text=t, namespace="mesh")
                  for i, t in enumerate(texts)])
    assert ds.docs().segments[0].n_entries >= (
        PORT.named_index_module.DEVICE_MIN_ENTRIES)
    base = ds.search("w0 w1", [], 0, 10)
    ds.docs().enable_sharding(cpu_mesh(8))
    got = checked_search(PORT, ds, "w0 w1", [], 10)
    assert results(got) == results(base) == results(
        ref.search("w0 w1", [], 0, 10))
    assert ds.docs().routes.get(ROUTES[engine], 0) > 0, ds.docs().routes


def test_mesh_with_filters(tmp_path, engine, monkeypatch):
    monkeypatch.setattr(PORT.named_index_module, "DEVICE_MIN_ENTRIES", 1)
    out = {}
    for pkg, kw in ((PORT, {"device": "cpu"}), (REF, {"use_device": False})):
        ds = pkg.Dataset("meshf", tmp_path / pkg.name, **kw)
        ds.ingest([
            pkg.ObjectRecord(id=f"f{i}", text=f"shared word item{i}",
                             namespace="meshf",
                             data_type="even" if i % 2 == 0 else "odd")
            for i in range(400)
        ])
        if pkg is PORT:
            ds.docs().enable_sharding(cpu_mesh(8))
        out[pkg.name] = ds.search(
            "shared", ["/namespace/meshf/data/even"], 0, 5)
    assert out["port"] and all(int(r.id[1:]) % 2 == 0 for r in out["port"])
    assert norm(out["port"]) == norm(out["ref"])


def test_delete_invalidates_cached_sharded_pack(tmp_path, engine):
    """delete_document mutates segment.tombstones in place (same segment
    identity): the cached sharded packs must not keep serving the
    deleted doc."""
    ds = PORT.Dataset("meshd", tmp_path, device="cpu")
    rng = np.random.default_rng(3)
    vocab = [f"w{i}" for i in range(40)]
    ds.ingest([
        PORT.ObjectRecord(id=f"d{i}",
                          text="victim " + " ".join(rng.choice(vocab, size=20)),
                          namespace="meshd")
        for i in range(600)
    ])
    seg = ds.docs().segments[0]
    assert seg.n_entries >= PORT.named_index_module.DEVICE_MIN_ENTRIES
    ds.docs().enable_sharding(cpu_mesh(8))
    before = checked_search(PORT, ds, "victim", [], 5)
    assert before
    # the device path is live: the cached pack exists afterwards
    assert ds.docs()._sharded_packs, "query did not take the sharded path"
    target = before[0].id
    ds.delete_document(target)
    after = checked_search(PORT, ds, "victim", [], 10)
    assert target not in {r.id for r in after}, (
        "cached sharded pack served a deleted doc")


# -- tests/test_pallas_sharded.py, tests/test_batch_sharded.py -------------------


def test_engine_sharded_batch(tmp_path, engine, monkeypatch):
    """NamedIndex under a mesh batches the whole query list through the
    sharded engines; the results equal the unsharded host engines'."""
    monkeypatch.setattr(PORT.named_index_module, "DEVICE_MIN_ENTRIES", 1)
    ds = PORT.Dataset("meshns", tmp_path, device="cpu")
    ds.ingest([
        PORT.ObjectRecord(id=f"m{i}",
                          text=f"alpha w{i % 16} beta w{(i * 7) % 16}",
                          namespace="meshns")
        for i in range(400)
    ])
    ds.docs().enable_sharding(cpu_mesh(8))
    queries = [("alpha w1", []), ("beta w3", []), ("w5 w6", [])]
    batch = ds.search_many(queries, 0, 5)
    assert len(batch) == 3 and all(len(b) > 0 for b in batch)
    host = PORT.Dataset("meshns", tmp_path, use_device=False)
    for (q, f), hits in zip(queries, batch):
        assert results(hits) == results(host.search(q, f, 0, 5))
        assert results(hits) == oracle_hits(PORT, ds, q, f, 5)
    assert ds.docs().routes.get(ROUTES[engine], 0) > 0, ds.docs().routes


def test_manager_config_sharding(tmp_path, engine, monkeypatch):
    """FUGU_SHARD_DEVICES wires the mesh in with no code."""
    monkeypatch.setattr(PORT.named_index_module, "DEVICE_MIN_ENTRIES", 1)
    monkeypatch.setenv("FUGU_SHARD_DEVICES", "8")
    cfg = PORT.config.ServerConfig.with_defaults(str(tmp_path / "port"),
                                                 "shardns")
    assert cfg.shard_devices == 8
    mgr = PORT.manager.DatasetManager(cfg, device="cpu")
    assert mgr._mesh is not None and mgr._mesh.size == 8
    ds = mgr.default_dataset()
    assert ds.docs()._mesh is mgr._mesh
    monkeypatch.delenv("FUGU_SHARD_DEVICES")
    ref = REF.Dataset("shardns", tmp_path / "ref", use_device=False)
    for pkg, d in ((PORT, ds), (REF, ref)):
        d.ingest([pkg.ObjectRecord(id=f"s{i}", text=f"gamma doc w{i % 8}",
                                   namespace="shardns") for i in range(64)])
    res = checked_search(PORT, ds, "gamma w3", [], 5)
    assert res and norm(res) == norm(ref.search("gamma w3", [], 0, 5))
    assert ds.docs().routes.get(ROUTES[engine], 0) > 0, ds.docs().routes
    mgr.close()


def test_sharded_two_phase_through_named_index(tmp_path, engine):
    """enable_sharding routes search_topk_batch through the sharded
    engines, with exact cross-checks against the oracle."""
    rng = np.random.default_rng(6)
    words = [f"w{i}" for i in range(30)]
    mgr = PORT.manager.DatasetManager.with_defaults(str(tmp_path), "sh",
                                                    device="cpu")
    ds = mgr.get_or_create_dataset("sh")
    ds.batch_upsert([
        PORT.ObjectRecord(id=f"r{i}", text=" ".join(rng.choice(words, size=7)))
        for i in range(3000)
    ])
    assert ds.wait_compaction(60)
    idx = ds._docs
    idx.enable_sharding(cpu_mesh(4))
    stats = idx.stats()
    segs = idx.searcher_segments()
    plans = make_plans(rng, 6)
    batch = idx.search_topk_batch(plans, 10)
    for plan, hits in zip(plans, batch):
        exp = oracle.search(segs, plan, 10, stats)
        assert [(np.float32(h.score), h.segment_ord, h.doc) for h in hits] == [
            (np.float32(h.score), h.segment_ord, h.doc) for h in exp]
    assert idx.routes.get(ROUTES[engine], 0) > 0, idx.routes
    mgr.close()


# -- tests/test_concurrency.py ------------------------------------------------------


def test_search_during_ingest_sharded(tmp_path, engine, monkeypatch):
    """Readers race ingest while the sharded packs' caches are replaced
    at every commit: searches stay consistent, and the last one equals
    the oracle."""
    monkeypatch.setattr(PORT.named_index_module, "DEVICE_MIN_ENTRIES", 1)
    cfg = PORT.config.ServerConfig.with_defaults(str(tmp_path), "default")
    mgr = PORT.manager.DatasetManager(cfg, device="cpu")
    ds = mgr.get_dataset("default")

    def rec(i, text):
        return PORT.ObjectRecord(id=f"doc{i}", text=text, namespace="default")

    ds.upsert([rec(i, f"seed body w{i % 6}") for i in range(200)])
    ds.docs().enable_sharding(cpu_mesh(4))
    errors = []
    stop = threading.Event()

    def reader():
        try:
            while not stop.is_set():
                for h in ds.search("body w1", [], 0, 10):
                    assert h.score > 0
        except Exception as e:  # pragma: no cover
            errors.append(e)

    def writer():
        try:
            for b in range(6):
                ds.upsert([rec(200 + b * 20 + j, f"fresh body w{j % 6}")
                           for j in range(20)])
        except Exception as e:  # pragma: no cover
            errors.append(e)
        finally:
            stop.set()

    run_threads([writer, reader, reader])
    assert not errors, errors
    assert len(checked_search(PORT, ds, "fresh", [], 200)) == 120
    assert ds.docs().routes.get(ROUTES[engine], 0) > 0, ds.docs().routes
    mgr.close()


# -- chip_smoke.py's sharded phase at a small size ---------------------------------


def test_smoke_sharded_phase_on_cpu(tmp_path):
    """The smoke's sharded phase and its sharded server in a fresh
    interpreter on the CPU at a small size (20,000 docs routed to the
    two-phase engine, one warm pass, 16 plans on the 2x2 mesh; a 2,048-
    record write path served with --shard-devices 2); neither JAX,
    fugu_tpu nor Triton is loaded."""
    script = textwrap.dedent(f"""
        import sys
        from pathlib import Path
        import torch
        import chip_smoke
        from fugu_tpu_torch.engine import named_index
        from fugu_tpu_torch.engine.named_index import NamedIndex
        from fugu_tpu_torch.index.manifest import Manifest, save_segment
        from fugu_tpu_torch.index.schema import IndexType

        named_index.SMALL_SEGMENT_MAX_DOCS = 0
        work = Path({str(tmp_path)!r}) / "smoke"
        work.mkdir()
        seg = chip_smoke.build_corpus(20000, 7, 3000)
        seg.segment_id = "corpus"
        save_segment(seg, work)
        Manifest(work).commit([seg])
        cpu = torch.device("cpu")
        ni = NamedIndex("smoke", work, IndexType.DOCS, device=cpu)
        seg = ni.segments[0]
        mix = chip_smoke.make_query_mix(seg)
        warm = [None] * len(mix)
        for lim in (10, 100):
            idx = [i for i, m in enumerate(mix) if m[2] == lim]
            for i, h in zip(idx, ni.search_topk_batch(
                    [mix[i][1] for i in idx], lim)):
                warm[i] = h
        phrases = chip_smoke.make_phrase_batch(seg)
        phrase_warm = ni.search_topk_batch(phrases, 10)
        out = chip_smoke.phase_sharded(
            ni, mix, warm, phrases, phrase_warm, cpu, "[cpu]", "cpu", work,
            n_passes=1, n_2d=16)
        print("KERNELS", sorted(out))
        named_index.SMALL_SEGMENT_MAX_DOCS = 131072
        written = chip_smoke.phase_write_path(
            cpu, "[cpu]", work / "write", n_records=2048, n_batches=8,
            n_churn=32, vocab_size=2000, n_queries=48)
        chip_smoke.phase_serve_sharded(
            "[cpu]", work / "serve_sharded", written,
            device_args=("--device", "cpu"), n_queries=32, clients=4)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "fugu_tpu",
                                            "triton"))
        print("LOADED", bad)
        assert not bad, bad
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", script], cwd=str(tmp_path), env=env,
        capture_output=True, text=True, timeout=400,
    )
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    assert "LOADED []" in proc.stdout
    line = next(json.loads(x) for x in proc.stdout.splitlines()
                if x.startswith('{"phase": "sharded"'))
    assert line["shards"] == 4 and line["results_equal"] == "256/256"
    assert line["phrase_results_equal"] == "256/256"
    assert min(min(p) for p in line["calls_per_pass"]) >= 4
    assert min(line["phrase_calls_per_pass"]) >= 4
    assert line["dryrun"]["two_phase_handled"] == line["dryrun"]["plans"]
    assert line["merge"]["calls_per_pass"] > 0 and line["merge"]["ms"] is None
    assert "served sharded [cpu]: serve --shard-devices 2" in proc.stdout
