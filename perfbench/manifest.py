"""What ``BENCHMARK.json`` says of one cell, and the files it names.

A cell names a configuration and a traffic mix; each is found by name
(``perfbench/configs/<file>`` through the configuration's ``file``,
``perfbench/traffic/<mix>.json``), and each per-layer metric by its
reader ``perfbench/metrics/<metric>.py``, which defines ``read(record)``.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


def load(root: Path) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def applies(metric: dict, cell: str, reported=()) -> bool:
    """A metric belongs to a cell when its ``workloads`` name the cell,
    or, without the key, when the cell reports the metric it ``moves``
    (or always, for an end-to-end metric)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in reported


def cell(root: Path, name: str, traffic_dir: Path = None) -> dict:
    """The cell ``name``: its entry, configuration and mix, and the
    end-to-end and per-layer metrics it reports."""
    bench = load(root)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = json.loads((Path(root) / conf["file"]).read_text())
    traffic_dir = HERE / "traffic" if traffic_dir is None else traffic_dir
    mix = json.loads((Path(traffic_dir) / f"{entry['traffic']}.json")
                     .read_text())
    e2e = [m for m in bench["end_to_end"] if applies(m, name)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if applies(m, name, names)]
    return {"entry": entry, "config": config, "mix": mix,
            "end_to_end": e2e, "per_layer": per_layer}


def reader(metric: str, metrics_dir: Path = None):
    """The ``read(record)`` of a per-layer metric."""
    path = (HERE / "metrics" if metrics_dir is None
            else Path(metrics_dir)) / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
