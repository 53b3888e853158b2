"""``fugu_tpu_torch.bench`` against the repo's ``bench.py``: the corpus
doc for doc (drawn in chunks), the query mix, the engine chain's results
on CPU tensors against ``bench.device_run`` (JAX on the CPU, Pallas in
interpret mode) and the oracle with tolerance 0, and the entry point in
a fresh interpreter."""

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
import chip_smoke
from fugu_tpu.ops import oracle as ref_oracle
from fugu_tpu_torch import bench
from fugu_tpu_torch.ops import batch_scorer, block_scorer, oracle

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
N_DOCS = 3000
#: the keys of bench.py's JSON line (bench.py:659-683)
REF_KEYS = {
    "metric", "value", "unit", "vs_baseline", "baseline", "exact_order",
    "tie_tolerant", "passes_qps", "per_class_full_qps",
    "baseline_passes_qps", "cpu_score", "baseline_qps_per_cpu",
    "ingest_docs_per_s", "ingest_docs_per_s_per_cpu",
}


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """(reference segment, port segment) of bench's corpus at N_DOCS,
    the port's drawn in chunks of 700 docs; both caches in temporary
    directories."""
    tmp = tmp_path_factory.mktemp("bench")
    mp = pytest.MonkeyPatch()
    mp.setattr(ref_bench, "N_DOCS", N_DOCS)
    mp.setattr(ref_bench, "CACHE", tmp / "ref")
    mp.setattr(bench, "CHUNK_DOCS", 700)
    try:
        ref = ref_bench.build_corpus()
        port, t_build = bench.build_corpus(N_DOCS, cache=tmp / "port")
    finally:
        mp.undo()
    assert t_build is not None
    return ref, port


def segment_view(seg):
    """Everything a segment holds, as plain comparable values."""
    n = seg.n_entries
    return {
        "doc_count": seg.doc_count, "n_entries": n,
        "terms": {f: {t: (i.start, i.doc_freq) for t, i in tm.items()}
                  for f, tm in seg.terms.items()},
        "e_doc": seg.e_doc[:n].tolist(), "e_tf": seg.e_tf[:n].tolist(),
        "e_fid": seg.e_fid[:n].tolist(),
        "pos": {f: (seg.pos_data[f].tolist(), seg.pos_offsets[f].tolist())
                for f in seg.pos_data},
        "norms": {f: a.tolist() for f, a in seg.fieldnorm_ids.items()},
        "tokens": dict(seg.total_tokens), "stored": list(seg.stored),
    }


@pytest.mark.parametrize("generator", ["bench", "chip_smoke"])
def test_chunked_corpus_equals_reference(corpora, generator, monkeypatch):
    """Postings, positions, fieldnorms and stored ids of the chunked
    draw equal bench.py's single draw: the port's build_corpus (and its
    cache, reloaded) and chip_smoke's generator."""
    ref, port = corpora
    if generator == "chip_smoke":
        monkeypatch.setattr(bench, "CHUNK_DOCS", 1000)
        port = chip_smoke.build_corpus(N_DOCS, bench.SEED, bench.VOCAB_SIZE)
    assert segment_view(port) == segment_view(ref)


def test_cached_corpus_reloads_equal(corpora, tmp_path):
    _ref, port = corpora
    bench.build_corpus(500, cache=tmp_path)
    again, t_build = bench.build_corpus(500, cache=tmp_path)
    assert t_build is None
    first, _t = bench.build_corpus(500, cache=tmp_path / "other")
    assert segment_view(again) == segment_view(first)
    assert sorted(p.name for p in tmp_path.glob("seg-*")) == [
        "seg-torchbenchv1500.npz", "seg-torchbenchv1500.store.msgpack",
        "seg-torchbenchv1500.tomb.npy"]


def mix_view(mix):
    return [(cls, repr(plan), limit) for cls, plan, limit in mix]


@pytest.mark.parametrize("counts", [None, {"must": 64}, {"phrase": 64},
                                    {"limit100": 64}],
                         ids=["mix", "must", "phrase", "limit100"])
def test_query_mix_equals_reference(corpora, counts, monkeypatch):
    ref, port = corpora
    monkeypatch.setattr(ref_bench, "N_QUERIES", 64)
    monkeypatch.setattr(bench, "N_QUERIES", 64)
    offset = 1 if counts is None else 2
    want = ref_bench.make_query_mix(ref, counts=counts, seed_offset=offset)
    got = bench.make_query_mix(port, counts=counts, seed_offset=offset)
    assert mix_view(got) == mix_view(want)
    assert len(got) == 64


def key(hits):
    return [(np.float32(s), int(d)) for s, d in hits]


def test_device_run_equals_reference_and_oracle(corpora, monkeypatch):
    """The port's chain on CPU tensors against bench.device_run and the
    oracle on the 64-query mix, tolerance 0; phase A and the block
    scorer ran (their wrappers were called: on CPU tensors the plain
    versions run and the launch counters stay)."""
    ref, port = corpora
    monkeypatch.setattr(ref_bench, "N_QUERIES", 64)
    monkeypatch.setattr(bench, "N_QUERIES", 64)
    mix = bench.make_query_mix(port)
    ref_mix = ref_bench.make_query_mix(ref)
    stats = oracle.IndexStats([port])
    calls = {"phasea": 0, "score_rows": 0}

    def counted(mod, name):
        orig = getattr(mod, name)

        def wrapper(*a):
            calls[name] += 1
            return orig(*a)

        monkeypatch.setattr(mod, name, wrapper)

    counted(batch_scorer, "phasea")
    counted(block_scorer, "score_rows")
    routes = {}
    got = bench.device_run(port, stats, mix, torch.device("cpu"), routes)
    want = ref_bench.device_run(ref, ref_oracle.IndexStats([ref]), ref_mix)
    assert [key(g) for g in got] == [key(w) for w in want]
    for (_c, plan, limit), g in zip(mix, got):
        exp = oracle.search([port], plan, limit, stats)
        assert key(g) == key((h.score, h.doc) for h in exp)
    assert calls["phasea"] > 0 and calls["score_rows"] > 0
    assert routes["phase_a"] > 0 and sum(routes.values()) == len(mix)
    assert routes["host"] >= sum(c == "phrase" for c, _p, _l in mix)


def test_device_run_streams_phrases_the_router_sends(corpora, monkeypatch):
    """A phrase class the cost model sends to the stream: served by the
    phrase kernel's plain version, equal to the oracle."""
    from fugu_tpu_torch.ops import phrase_stream

    _ref, port = corpora
    monkeypatch.setattr(phrase_stream, "HOST_NS_PER_MIN_POSTING", 1e9)
    mix = bench.make_query_mix(port, counts={"phrase": 32}, seed_offset=2)
    stats = oracle.IndexStats([port])
    routes = {}
    got = bench.device_run(port, stats, mix, torch.device("cpu"), routes)
    assert routes["phrase_stream"] == len(mix)
    for (_c, plan, limit), g in zip(mix, got):
        exp = oracle.search([port], plan, limit, stats)
        assert key(g) == key((h.score, h.doc) for h in exp)


BAD_MODULES = ("jax", "jaxlib", "fugu_tpu", "triton")


def test_entry_point_on_the_cpu(tmp_path):
    """``bench.main(["--device", "cpu"])`` in a fresh interpreter prints
    one JSON line with bench.py's keys and exact order n/n, its details
    on stderr, and imports neither JAX nor fugu_tpu."""
    script = textwrap.dedent(f"""
        import sys
        from pathlib import Path
        from fugu_tpu_torch import bench
        bench.CACHE = Path({str(tmp_path)!r})
        rc = bench.main(["--device", "cpu"])
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in {BAD_MODULES!r})
        print("LOADED", bad, file=sys.stderr)
        sys.exit(rc)
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO), BENCH_DOCS="1500",
               BENCH_QUERIES="32", BENCH_PASSES="1", BENCH_CLASS_FULL="0",
               BENCH_INGEST_DOCS="200", OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", script], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert set(line) == REF_KEYS
    assert line["exact_order"] == "32/32"
    assert line["metric"] == "BM25 mixed-workload QPS (1500 docs, batched)"
    assert "LOADED []" in proc.stderr
    detail = next(json.loads(s) for s in proc.stderr.splitlines()
                  if s.startswith('{"bench_detail"'))["bench_detail"]
    assert detail["device"] == "cpu" and detail["docs"] == 1500
    assert (tmp_path / "seg-torchbenchv11500.npz").exists()


def test_entry_point_without_a_card_exits_with_an_error_line(tmp_path):
    """``python3 -m fugu_tpu_torch.bench`` runs on the card unless asked
    for the CPU: without CUDA it prints the error line and exits 1."""
    env = dict(os.environ, PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-m", "fugu_tpu_torch.bench"],
                          cwd=str(tmp_path), env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 1
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["value"] == 0 and "cuda" in line["error"].lower()
    assert not (tmp_path / ".bench_cache").exists()
