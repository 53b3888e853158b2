"""mix_timing.py: the device-busy union of a trace, and runs of the
script on the CPU at a small corpus (unsharded, profiled, and on 4
shards)."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import mix_timing  # noqa: E402


def test_busy_union_clips_to_the_window_and_merges_overlaps():
    ev = [
        {"name": "warm_pass", "cat": "user_annotation", "ts": 100, "dur": 1000},
        {"name": "k0", "cat": "kernel", "ts": 50, "dur": 100},       # 100-150
        {"name": "k1", "cat": "kernel", "ts": 200, "dur": 300},      # 200-500
        {"name": "c0", "cat": "gpu_memcpy", "ts": 400, "dur": 200},  # to 600
        {"name": "s0", "cat": "gpu_memset", "ts": 650, "dur": 50},   # 650-700
        {"name": "k2", "cat": "kernel", "ts": 1050, "dur": 500},     # to 1100
        {"name": "op", "cat": "cpu_op", "ts": 100, "dur": 1000},
        {"name": "k3", "cat": "kernel", "ts": 1200, "dur": 10},
    ]
    wall, busy = mix_timing.busy_ms({"traceEvents": ev}, "warm_pass")
    assert wall == pytest.approx(1.0)
    assert busy == pytest.approx((50 + 400 + 50 + 50) / 1e3)


def test_script_runs_the_mix_on_the_cpu(tmp_path):
    ns = tmp_path / "ns"
    cmd = [sys.executable, str(REPO / "mix_timing.py"), "--namespace",
           str(ns), "--tree", str(REPO), "--docs", "3000", "--passes", "2",
           "--device", "cpu"]
    runs = []
    for extra in ([], ["--profile", str(tmp_path / "prof")],
                  ["--shards", "4"]):
        out = subprocess.run(cmd + extra, capture_output=True, text=True,
                             cwd=tmp_path, timeout=300)
        assert out.returncode == 0, out.stderr[-2000:]
        runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
    first, second, sharded = runs
    assert (ns / "meta.json").exists()  # built once, then reopened
    assert (first["shards"], sharded["shards"]) == (0, 4)
    for r in runs:
        assert r["docs"] == 3000 and len(r["passes_s"]) == 2
        assert r["qps"] == pytest.approx(256 / r["median_s"])
    assert "device_idle_share" not in first
    assert second["device_busy_ms"] == 0.0  # no device events on the CPU
    assert (tmp_path / "prof" / "trace.json.gz").exists()


def test_script_forces_the_phrase_route_in_turns(tmp_path):
    """``--phrase-route`` turns on the CPU: the forced stream turn sends
    every phrase of the mix to the stream, the forced host turn none;
    ``--overlap`` prints the credit's readings, small batches included;
    an unknown route is refused."""
    cmd = [sys.executable, str(REPO / "mix_timing.py"), "--namespace",
           str(tmp_path / "ns"), "--tree", str(REPO), "--docs", "3000",
           "--passes", "1", "--device", "cpu"]
    out = subprocess.run(cmd + ["--phrase-route", "host,stream,auto",
                                "--overlap", "8"],
                         capture_output=True, text=True, cwd=tmp_path,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = [json.loads(x) for x in out.stdout.splitlines()
             if x.startswith("{")]
    main, overlap = lines
    assert [t["route"] for t in main["turns"]] == ["host", "stream", "auto"]
    assert main["phrase_route"] == "host"
    assert main["median_s"] == main["turns"][0]["median_s"]
    host, stream, _auto = (t["routes"] for t in main["turns"])
    assert host.get("phrase_stream", 0) == 0 and host["host_only"] == 24
    assert stream["phrase_stream"] == 24 and stream.get("host_only", 0) == 0
    assert overlap["mix"]["phrases"] == 24 and overlap["batch"]["phrases"] == 32
    for row in (overlap["mix"], overlap["batch"]):
        assert len(row["plan_dfs"]) == len(row["host_plan_ms"]) == row[
            "phrases"]
        assert row["hidden_ms"] == pytest.approx(
            overlap["device_ms"] + row["host_ms"] - row["with_host_ms"])
    assert [r["phrases"] for r in overlap["small"]] == [1, 2, 4, 8]
    bad = subprocess.run(cmd + ["--phrase-route", "auto,gpu"],
                         capture_output=True, text=True, cwd=tmp_path,
                         timeout=300)
    assert bad.returncode == 2 and "gpu" in bad.stderr
