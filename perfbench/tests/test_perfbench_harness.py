"""The harness on the CPU at a tiny size: whole runs of each cell, the
manifest's rules, a mix added as a file, the frozen copies, and the
comparison failing its control and each fault a cell can have."""

import json
import re
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from conftest import LIVE, READ, ROOT, cell_of, tiny_cell
from perfbench import corpus, manifest, run

CELLS = [READ, LIVE]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_generator_is_bench_corpus_doc_for_doc(monkeypatch):
    """At seed 7 the copied generator draws ``fugu_tpu_torch.bench``'s
    corpus: the same texts and sources, drawn in chunks too."""
    from fugu_tpu_torch import bench

    monkeypatch.setattr(bench, "CHUNK_DOCS", 700)
    monkeypatch.setattr(corpus, "CHUNK_DOCS", 700)
    n = 3000
    rng = np.random.default_rng(bench.SEED)
    lens = np.clip(rng.poisson(bench.MEAN_DOC_LEN, n), 5, 200)
    srcs = bench.draw_after(rng, int(lens.sum())).integers(0, 20, n)
    want = [t for chunk in bench.iter_texts(rng, lens, bench.VOCAB_SIZE)
            for t in chunk]
    gen = {"vocab": bench.VOCAB_SIZE, "zipf_s": 1.07,
           "mean_len": bench.MEAN_DOC_LEN, "min_len": 5, "max_len": 200,
           "facet_sources": 20}
    got = corpus.draw_corpus(7, n, gen)
    assert got.texts() == want
    assert got.sources.tolist() == srcs.tolist()


def test_large_and_negative_seeds_draw():
    gen = manifest.cell(ROOT, CELLS[0])["config"]["generator"]
    a = corpus.draw_corpus(2**31 + 12345, 50, gen)
    b = corpus.draw_corpus(2**31 + 12345, 50, gen)
    assert a.texts() == b.texts()
    assert corpus.draw_corpus(-5, 50, gen).n_docs == 50


def test_costs_constants_are_the_programs():
    from fugu_tpu_torch.index import segment
    from fugu_tpu_torch.ops import phrase_stream

    from perfbench import costs

    assert costs.BM_BLOCK_DOCS == segment.BM_BLOCK_DOCS
    assert costs.BM_CHUNK == segment.BM_CHUNK
    assert costs.FINE_PER_BLOCK == phrase_stream.FINE_PER_BLOCK
    assert costs.TID_MASK == phrase_stream.TID_MASK


def test_manifest_keeps_its_rules():
    raw = (ROOT / "BENCHMARK.json").read_bytes()
    assert len(raw) <= 64 * 1024
    bench = json.loads(raw)
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51
    for p in bench["paths"]:
        assert (ROOT / p).is_dir() and not p.startswith("/") and ".." not in p
    metrics = bench["end_to_end"] + bench["per_layer"]
    items = bench["configs"] + bench["workloads"] + metrics
    for names in (bench["configs"], bench["workloads"], metrics):
        assert len({x["name"] for x in names}) == len(names)
    for x in items:
        assert NAME.match(x["name"]), x["name"]
        for key in ("why", "layer", "source"):
            if key in x:
                assert 1 <= len(x[key]) <= 200 and not set(x[key]) & {"\n",
                                                                      "\t"}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "layer", "moves", "workloads"}
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"]: w for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and m["layer"]
        assert (ROOT / "perfbench" / "metrics" / f"{m['name']}.py").exists()
        assert set(m.get("workloads", [])) <= set(cells)
    for c in bench["configs"]:
        assert c["file"].startswith("perfbench/")
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["reduced"] == c["reduced"] and conf["source"] == c["source"]
        for key in ("assumed", "guarantees", "limits"):
            assert conf[key]
        for k in c["reduced"]:
            assert NAME.match(k)
    for name, w in cells.items():
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert (ROOT / "perfbench" / "traffic" / f"{w['traffic']}.json").exists()
        cell = manifest.cell(ROOT, name)
        reported = {m["name"] for m in cell["end_to_end"]}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell["per_layer"]


RUN_TINY = textwrap.dedent("""
    import json, sys
    sys.path.insert(0, {root!r})
    sys.path.insert(0, {tests!r})
    from conftest import cell_of, shrink
    from perfbench import manifest, run
    manifest.cell = lambda root, name, traffic_dir=None: shrink(
        cell_of(root, name, traffic_dir))
    rc = run.main(["--workload", {cell!r}, "--seed", "4294967301",
                   "--seconds", "2", "--trace", {trace!r}], device="cpu")
    tops = sorted({{m.split(".")[0] for m in sys.modules}})
    print(json.dumps({{"rc": rc, "modules": tops}}), file=sys.stderr)
    sys.exit(rc)
""")


@pytest.mark.parametrize("trace", ["0", "1"])
@pytest.mark.parametrize("cell", CELLS)
def test_whole_run_prints_a_result_line(cell, trace):
    """A whole run in a fresh interpreter: exit 0, the last line of
    standard output is the result, checks its last key, and neither JAX
    nor the JAX package was loaded."""
    proc = subprocess.run(
        [sys.executable, "-c", RUN_TINY.format(
            root=str(ROOT), tests=str(Path(__file__).parent), cell=cell,
            trace=trace)],
        capture_output=True, text=True, timeout=600, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    kind = "per_layer" if trace == "1" else "end_to_end"
    names = {m["name"] for m in cell_of(ROOT, cell)[kind]}
    assert set(line["metrics"]) <= names and line["metrics"]
    if trace == "0":
        assert "setup_s" in line["metrics"]
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    stderr = proc.stderr.strip().splitlines()
    info = json.loads(stderr[-1])
    assert not {"jax", "jaxlib", "flax", "fugu_tpu"} & set(info["modules"])
    assert "fugu_tpu_torch" in info["modules"]
    assert any(s.startswith("check score_gap") for s in stderr)


def test_no_card_no_result():
    proc = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=str(ROOT),
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_a_mix_added_as_a_file_runs(tmp_path):
    """A new configuration and a new mix are one file each and one cell
    entry: found by name, and the cell runs (here a corpus with facets,
    and boolean, boosted, filtered and phrase queries)."""
    root = tmp_path / "root"
    shutil.copytree(ROOT / "perfbench" / "configs",
                    root / "perfbench" / "configs")
    config = json.loads((root / "perfbench" / "configs" /
                         "msmarco-passage-1m.json").read_text())
    config.update(name="faceted", docs=2500)
    config["generator"].update(vocab=30000, mean_len=55, facet_sources=20)
    (root / "perfbench" / "configs" / "faceted.json").write_text(
        json.dumps(config))
    traffic = tmp_path / "traffic"
    shutil.copytree(ROOT / "perfbench" / "traffic", traffic)
    mix = json.loads((traffic / "questions-c64.json").read_text())
    mix.update(name="must-c4", search_clients=4, distinct_queries=48,
               check_queries=24,
               classes=[{"form": "intersection", "terms": [2, 3], "share": 1},
                        {"form": "negation", "terms": [3, 3], "share": 1},
                        {"form": "boost", "terms": [2, 4], "share": 1,
                         "facet": True},
                        {"form": "phrase", "terms": [2, 2], "share": 1}])
    (traffic / "must-c4.json").write_text(json.dumps(mix))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "faceted", "source": "a test",
        "file": "perfbench/configs/faceted.json", "reduced": [],
        "why": "a test"})
    bench["workloads"].append({
        "name": "faceted.must-c4", "config": "faceted",
        "traffic": "must-c4", "chips": 1, "why": "a test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = manifest.cell(root, "faceted.must-c4", traffic)
    assert cell["mix"]["name"] == "must-c4"
    assert cell["config"]["name"] == "faceted"
    line = run.run(cell, 77, 2.0, False, "cpu")
    assert line["correct"] is True
    assert line["metrics"]["search_p95_ms"]["value"] > 0


# -- the comparison fails its control and each fault ------------------------

def test_control_fails(tmp_path):
    """The reference in bfloat16 put in the program's place comes out over
    the limit on three seeds, in both cells."""
    from perfbench.control import control_gap

    for name in CELLS:
        cell = tiny_cell(name)
        for seed in (1, 2, 3):
            got = control_gap(cell, seed, 4)
            assert got["score_gap"] > got["limit"], (name, got)


def _perturb(results):
    for res in results:
        if res:
            res[0].score = float(np.float32(res[0].score) * np.float32(1.001))
    return results


FAULTS = {
    # an answer altered where it is produced
    "answer_altered": lambda orig: lambda ds, q, page, per_page: _perturb(
        orig(ds, q, page, per_page)),
    # half of the batch left out
    "half_batch": lambda orig: lambda ds, q, page, per_page: (
        orig(ds, q[:len(q) // 2], page, per_page)
        + [[] for _ in q[len(q) // 2:]]),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_fault_in_the_timed_path_is_not_correct(cell, fault, monkeypatch):
    from fugu_tpu_torch.engine.dataset import Dataset

    monkeypatch.setattr(Dataset, "search_many",
                        FAULTS[fault](Dataset.search_many))
    line = run.run(tiny_cell(cell), 11, 2.0, False, "cpu")
    assert line["correct"] is False
    assert line["checks"]["score_gap"]["value"] > line["checks"][
        "score_gap"]["limit"]


def test_write_acknowledged_unapplied_is_not_correct(monkeypatch):
    """A write step that returns the state unchanged: the upsert is
    acknowledged and nothing is written."""
    from fugu_tpu_torch.engine.dataset import Dataset

    monkeypatch.setattr(Dataset, "batch_upsert",
                        lambda ds, records: len(records))
    line = run.run(tiny_cell(CELLS[1]), 12, 2.0, False, "cpu")
    assert line["correct"] is False
    assert line["checks"]["lost_writes"]["value"] > 0


def test_delete_acknowledged_unapplied_is_not_correct(monkeypatch):
    from fugu_tpu_torch.engine.dataset import Dataset

    monkeypatch.setattr(Dataset, "delete_document", lambda ds, doc_id: None)
    line = run.run(tiny_cell(CELLS[1]), 13, 2.0, False, "cpu")
    assert line["correct"] is False
    assert line["checks"]["deleted_served"]["value"] > 0


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS[:1])
def test_cell_on_the_card(cell, card):
    """A short run of each cell at its own size on the card."""
    proc = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", cell, "--seed",
         "2147483659", "--seconds", "5", "--trace", "0"],
        capture_output=True, text=True, timeout=1200, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1])["correct"] is True
