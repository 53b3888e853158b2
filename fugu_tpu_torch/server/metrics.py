"""Minimal metrics registry + Prometheus text exposition.

The reference has no metrics registry (SURVEY.md §5: observability is
logs + traces + /health) — this is an extension for production serving:
request/search/ingest counters and latency histograms, exposed at
``/metrics`` in Prometheus text format with zero dependencies.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Tuple

_BUCKETS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0)


def escape_label(value) -> str:
    """Prometheus exposition-format label escaping: backslash, quote,
    newline.  A namespace named 'a\\nb' (legal path component, passes
    name validation) would otherwise corrupt the whole scrape."""
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


class Metrics:
    def __init__(self):
        self._lock = threading.Lock()
        self.counters: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], float] = {}
        self.hist: Dict[str, List[int]] = {}
        self.hist_sum: Dict[str, float] = {}
        self.hist_count: Dict[str, int] = {}

    def inc(self, name: str, value: float = 1.0, **labels) -> None:
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            self.counters[key] = self.counters.get(key, 0.0) + value

    def observe(self, name: str, seconds: float) -> None:
        with self._lock:
            buckets = self.hist.setdefault(name, [0] * (len(_BUCKETS) + 1))
            for i, edge in enumerate(_BUCKETS):
                if seconds <= edge:
                    buckets[i] += 1
                    break
            else:
                buckets[-1] += 1
            self.hist_sum[name] = self.hist_sum.get(name, 0.0) + seconds
            self.hist_count[name] = self.hist_count.get(name, 0) + 1

    def render(self) -> str:
        lines: List[str] = []
        with self._lock:
            for (name, labels), value in sorted(self.counters.items()):
                if labels:
                    lbl = ",".join(
                        f'{k}="{escape_label(v)}"' for k, v in labels
                    )
                    lines.append(f"{name}{{{lbl}}} {value}")
                else:
                    lines.append(f"{name} {value}")
            for name, buckets in sorted(self.hist.items()):
                cum = 0
                for i, edge in enumerate(_BUCKETS):
                    cum += buckets[i]
                    lines.append(f'{name}_bucket{{le="{edge}"}} {cum}')
                cum += buckets[-1]
                lines.append(f'{name}_bucket{{le="+Inf"}} {cum}')
                lines.append(f"{name}_sum {self.hist_sum.get(name, 0.0):.6f}")
                lines.append(f"{name}_count {self.hist_count.get(name, 0)}")
        return "\n".join(lines) + "\n"


REGISTRY = Metrics()


class timed:
    """Context manager: observe a histogram + count a counter."""

    def __init__(self, name: str, **labels):
        self.name = name
        self.labels = labels

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, *exc):
        REGISTRY.observe(f"{self.name}_seconds", time.perf_counter() - self._t0)
        REGISTRY.inc(
            f"{self.name}_total",
            status="error" if exc_type else "ok",
            **self.labels,
        )
        return False
