"""Minimal metrics registry + Prometheus text exposition.

The reference has no metrics registry (SURVEY.md §5: observability is
logs + traces + /health) — this is an extension for production serving:
request/search/ingest counters and latency histograms, exposed at
``/metrics`` in Prometheus text format with zero dependencies.
"""

from __future__ import annotations

import collections
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
    """Counters and histograms, rendered as Prometheus text.

    A histogram takes labels (``fugu_span_seconds{span="..."}``); the
    unlabelled ones render as they always have.  :meth:`render` keeps
    the sums, counts and counter values it rendered the last two times,
    and :meth:`between_renders` gives each sample's change between them:
    what a scraper computes from two scrapes."""

    def __init__(self):
        self._lock = threading.Lock()
        self.counters: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], float] = {}
        self.hist: Dict[str, List[int]] = {}
        self.hist_sum: Dict[str, float] = {}
        self.hist_count: Dict[str, int] = {}
        #: labelled histograms: (name, sorted labels) -> [buckets, sum, count]
        self.labelled: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], list] = {}
        self._later: collections.deque = collections.deque()
        self._renders: Tuple[Dict[str, float], Dict[str, float]] = ({}, {})

    def inc(self, name: str, value: float = 1.0, **labels) -> None:
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            self.counters[key] = self.counters.get(key, 0.0) + value

    def observe(self, name: str, seconds: float, **labels) -> None:
        if self._later:
            self._drain()
        with self._lock:
            self._observe(name, seconds, labels)

    def observe_later(self, name: str, seconds: float, **labels) -> None:
        """:meth:`observe` for a caller that may run while this thread
        holds the lock (a ``gc`` callback fires inside any allocation):
        queued without a lock, observed at the next observe or render."""
        self._later.append((name, seconds, labels))

    def _drain(self) -> None:
        while self._later:
            try:
                name, seconds, labels = self._later.popleft()
            except IndexError:  # another thread drained it
                return
            with self._lock:
                self._observe(name, seconds, labels)

    def _observe(self, name: str, seconds: float, labels: dict) -> None:
        if labels:
            key = (name, tuple(sorted(labels.items())))
            entry = self.labelled.get(key)
            if entry is None:
                entry = self.labelled[key] = [[0] * (len(_BUCKETS) + 1), 0.0, 0]
            buckets = entry[0]
            entry[1] += seconds
            entry[2] += 1
        else:
            buckets = self.hist.setdefault(name, [0] * (len(_BUCKETS) + 1))
            self.hist_sum[name] = self.hist_sum.get(name, 0.0) + seconds
            self.hist_count[name] = self.hist_count.get(name, 0) + 1
        for i, edge in enumerate(_BUCKETS):
            if seconds <= edge:
                buckets[i] += 1
                break
        else:
            buckets[-1] += 1

    def render(self) -> str:
        if self._later:
            self._drain()
        lines: List[str] = []
        snap: Dict[str, float] = {}
        with self._lock:
            for (name, labels), value in sorted(self.counters.items()):
                if labels:
                    lbl = ",".join(
                        f'{k}="{escape_label(v)}"' for k, v in labels
                    )
                    lines.append(f"{name}{{{lbl}}} {value}")
                    snap[f"{name}{{{lbl}}}"] = value
                else:
                    lines.append(f"{name} {value}")
                    snap[name] = value
            for name, buckets in sorted(self.hist.items()):
                cum = 0
                for i, edge in enumerate(_BUCKETS):
                    cum += buckets[i]
                    lines.append(f'{name}_bucket{{le="{edge}"}} {cum}')
                cum += buckets[-1]
                lines.append(f'{name}_bucket{{le="+Inf"}} {cum}')
                lines.append(f"{name}_sum {self.hist_sum.get(name, 0.0):.6f}")
                lines.append(f"{name}_count {self.hist_count.get(name, 0)}")
                snap[f"{name}_sum"] = self.hist_sum.get(name, 0.0)
                snap[f"{name}_count"] = self.hist_count.get(name, 0)
            for (name, labels), (buckets, total, count) in sorted(
                self.labelled.items()
            ):
                lbl = ",".join(f'{k}="{escape_label(v)}"' for k, v in labels)
                cum = 0
                for i, edge in enumerate(_BUCKETS):
                    cum += buckets[i]
                    lines.append(f'{name}_bucket{{{lbl},le="{edge}"}} {cum}')
                cum += buckets[-1]
                lines.append(f'{name}_bucket{{{lbl},le="+Inf"}} {cum}')
                lines.append(f"{name}_sum{{{lbl}}} {total:.6f}")
                lines.append(f"{name}_count{{{lbl}}} {count}")
                snap[f"{name}_sum{{{lbl}}}"] = total
                snap[f"{name}_count{{{lbl}}}"] = count
            self._renders = (self._renders[1], snap)
        return "\n".join(lines) + "\n"

    def between_renders(self) -> Dict[str, float]:
        """Each counter's value and each histogram's ``_sum`` and
        ``_count`` (keyed as the samples are written, labels included)
        at the last render, less its value at the render before."""
        with self._lock:
            before, last = self._renders
        return {key: value - before.get(key, 0) for key, value in last.items()}


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
