"""CPU tests of the benchmark harness; tests marked ``card`` need a CUDA
device and skip without one (decided in the ``card`` fixture, never at
import)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench.manifest import cell as _manifest_cell  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; run on the card with "
        "`python3 -m pytest perfbench/tests -m card`")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


#: the cell of the benchmark's read path
READ = "msmarco-passage-1m.questions-c64"
#: a write-path cell that ``BENCHMARK.json`` does not hold yet (PERF.md
#: section 7): the read cell's corpus upserted through the writer, and
#: its searchers beside writers.  These tests keep the harness's write
#: path (``run.open_live``, ``live_state``, ``after_live``, the client's
#: writers, ``workload.writer_plan``, the control's live branch) working
#: until a later change adds such a cell with files of its own.
LIVE = "msmarco-passage-live.churn-w2"
LIVE_METRICS = {
    "end_to_end": [("setup_s", "s"), ("search_p95_ms", "ms"),
                   ("ingest_docs_per_s", "docs/s"), ("write_p95_ms", "ms")],
    "per_layer": [("queue_wait_ms", "ms"), ("engine_ms.live", "ms"),
                  ("search_qps.live", "req/s"), ("small_engine_ms", "ms"),
                  ("segments_searched", "segments"),
                  ("compaction_busy_share", "%"), ("device_idle.live", "%")],
}


def cell_of(root, name, traffic_dir=None):
    """``manifest.cell``, and the write-path cell built on the read
    cell's files."""
    if name != LIVE:
        return _manifest_cell(root, name, traffic_dir)
    read = _manifest_cell(root, READ)
    return {
        "entry": {"name": LIVE, "config": "msmarco-passage-live",
                  "traffic": "churn-w2", "chips": 1},
        "config": dict(read["config"], name="msmarco-passage-live",
                       build="writer", setup_batch=32768),
        "mix": dict(read["mix"], name="churn-w2", search_clients=16,
                    writers=2, write_batch=512, overwrite_share=0.25,
                    deletes_per_batch=8, writer_batches=320),
        **{kind: [{"name": n, "unit": u} for n, u in items]
           for kind, items in LIVE_METRICS.items()},
    }


def tiny_cell(name: str, docs: int = 3000):
    """The cell ``name`` at a size the CPU runs in seconds."""
    return shrink(cell_of(ROOT, name), docs)


def shrink(cell: dict, docs: int = 3000) -> dict:
    cell["config"]["docs"] = docs
    cell["config"]["setup_batch"] = 1000
    cell["mix"].update(distinct_queries=64, check_queries=32,
                       search_clients=4)
    if cell["mix"].get("writers"):
        cell["mix"].update(writer_batches=4, write_batch=64)
    return cell
