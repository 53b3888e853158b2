"""Spans and counters of the traced run, taken from the benchmark's side.

In a ``--trace 1`` run, :class:`Tracer` wraps functions of the program
where its callers look them up through the module or the class at call
time, so that each call is timed on the host and named in the profiler's
trace (``torch.profiler.record_function``).  Nothing is wrapped in a
``--trace 0`` run.

Spans (host seconds, one per call):

- ``engine``: ``Dataset.search_many`` (one a batch of the micro-batcher);
- ``two_phase``: ``ops/batch_scorer.batch_search`` and
  ``ops/block_scorer.block_search_batch`` (phase A, the block scorer and
  the host rescore);
- ``phrase_stream``: ``ops/phrase_stream.phrase_stream_begin`` and
  ``phrase_stream_collect``;
- ``small_engine``: ``ops/scoring.device_search_batch``;
- ``compaction``: ``engine/named_index.merge_segments`` and
  ``NamedIndex._maybe_device_merge`` / ``_swap_merged`` (a merge, its
  device merge and its swap);
- ``writer``: ``Dataset.upsert`` and ``Dataset.delete_document``.

Counters: the live segments of the docs index at each engine call
(``NamedIndex.search_topk_batch``); each call of a kernel wrapper
(``batch_scorer.phasea``, ``block_scorer.score_rows``,
``phrase_stream.phrase_stream``) with clones of the operands its cost is
computed from.  A wrapper's device time is that of its CUDA kernels,
found in the profiler's trace by name (``KERNEL_NAMES``).
"""

from __future__ import annotations

import threading
import time

#: kernel wrapper -> (module, attribute, operand positions to clone: the
#: per-call operands its cost reads; the resident packs are not copied)
KERNELS = {
    "phase_a": ("fugu_tpu_torch.ops.batch_scorer", "phasea", (4, 5, 7, 8)),
    "block_scorer": ("fugu_tpu_torch.ops.block_scorer", "score_rows",
                     (0, 1, 2, 3)),
    "phrase": ("fugu_tpu_torch.ops.phrase_stream", "phrase_stream", (5,)),
}
#: kernel wrapper -> the CUDA kernels it launches (``csrc/*.cu``)
KERNEL_NAMES = {
    "phase_a": ("phasea_kernel",),
    "block_scorer": ("block_topk_kernel", "merge_topk_kernel"),
    "phrase": ("phrase_kernel",),
}

SPANS = {
    "engine": [("fugu_tpu_torch.engine.dataset", "Dataset", "search_many")],
    "two_phase": [("fugu_tpu_torch.ops.batch_scorer", None, "batch_search"),
                  ("fugu_tpu_torch.ops.block_scorer", None,
                   "block_search_batch")],
    "phrase_stream": [
        ("fugu_tpu_torch.ops.phrase_stream", None, "phrase_stream_begin"),
        ("fugu_tpu_torch.ops.phrase_stream", None, "phrase_stream_collect")],
    "small_engine": [("fugu_tpu_torch.ops.scoring", None,
                      "device_search_batch")],
    "compaction": [
        ("fugu_tpu_torch.engine.named_index", None, "merge_segments"),
        ("fugu_tpu_torch.engine.named_index", "NamedIndex",
         "_maybe_device_merge"),
        ("fugu_tpu_torch.engine.named_index", "NamedIndex", "_swap_merged")],
    "writer": [("fugu_tpu_torch.engine.dataset", "Dataset", "upsert"),
               ("fugu_tpu_torch.engine.dataset", "Dataset",
                "delete_document")],
}


class Tracer:
    """Installs the wrappers on entry and restores the originals on exit.
    ``recording`` is set for the measured window only."""

    def __init__(self):
        self.spans = []           # (name, t0, t1)
        self.segments = []        # live docs segments at each engine call
        self.kept = {k: [] for k in KERNELS}   # cloned args of each call
        self.recording = False
        self._lock = threading.Lock()
        self._undo = []

    def _set(self, owner, attr, fn):
        self._undo.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, fn)

    def __enter__(self):
        import importlib

        from fugu_tpu_torch.engine.named_index import NamedIndex

        for span, targets in SPANS.items():
            for mod, cls, attr in targets:
                owner = importlib.import_module(mod)
                if cls is not None:
                    owner = getattr(owner, cls)
                self._set(owner, attr,
                          _span_call(self, getattr(owner, attr), span))
        self._set(NamedIndex, "search_topk_batch",
                  _segments_count(self, NamedIndex.search_topk_batch))
        for name, (mod, attr, clone_at) in KERNELS.items():
            owner = importlib.import_module(mod)
            self._set(owner, attr,
                      _kernel_call(self, getattr(owner, attr), name, clone_at))
        return self

    def __exit__(self, *exc):
        for owner, attr, orig in reversed(self._undo):
            setattr(owner, attr, orig)
        self._undo.clear()

    def span_seconds(self, name: str, lo: float, hi: float) -> float:
        """Seconds of [lo, hi] covered by spans called ``name``."""
        return union_seconds(
            [(max(a, lo), min(b, hi)) for n, a, b in self.spans
             if n == name and b > lo and a < hi])


def _span_call(tracer: Tracer, orig, span: str):
    from torch.profiler import record_function

    def call(*a, **kw):
        t0 = time.perf_counter()
        with record_function("perfbench." + span):
            try:
                return orig(*a, **kw)
            finally:
                if tracer.recording:
                    tracer.spans.append((span, t0, time.perf_counter()))

    return call


def _segments_count(tracer: Tracer, orig):
    def search_topk_batch(ni, plans, limit, segments=None):
        if tracer.recording and ni.name == "docs":
            tracer.segments.append(
                len(segments if segments is not None else ni.segments))
        return orig(ni, plans, limit, segments)

    return search_topk_batch


def _kernel_call(tracer: Tracer, orig, name: str, clone_at):
    def call(*a):
        out = orig(*a)
        if tracer.recording:
            tracer.kept[name].append(
                tuple(x.clone() if i in clone_at else x
                      for i, x in enumerate(a)))
        return out

    return call


def union_seconds(intervals) -> float:
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


# -- the profiler's trace ----------------------------------------------------

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def window_busy(events, name: str):
    """(window us, device busy us, [(start, end)] of device activity,
    (window start, end)) of the user annotation ``name``: the union of
    the device's intervals inside it.  The arithmetic of ``busy_ms`` in
    ``fugu_tpu_torch/tools/live_load.py`` at commit
    23dc844b70300e262b1ac425b78377cec020fed5."""
    win = next(e for e in events
               if e.get("name") == name and e.get("cat") == "user_annotation")
    lo, hi = win["ts"], win["ts"] + win["dur"]
    spans = sorted(
        (max(e["ts"], lo), min(e["ts"] + e["dur"], hi))
        for e in events
        if e.get("cat") in DEVICE_CATS
        and e["ts"] < hi and e["ts"] + e["dur"] > lo
    )
    busy, end, merged = 0.0, lo, []
    for s, t in spans:
        s = max(s, end)
        if t > s:
            busy += t - s
            if merged and merged[-1][1] == s:
                merged[-1] = (merged[-1][0], t)
            else:
                merged.append((s, t))
            end = t
    return hi - lo, busy, merged, (lo, hi)


def kernel_seconds(events, names, lo: float, hi: float) -> float:
    """Seconds of the kernels whose names contain one of ``names`` and
    that start in [lo, hi] (trace microseconds)."""
    return sum(e["dur"] for e in events
               if e.get("cat") == "kernel" and lo <= e["ts"] < hi
               and any(n in e["name"] for n in names)) / 1e6


def breakdown(events, merged, lo: float, hi: float, host_spans, shift):
    """The device operations that took most time in [lo, hi] and the
    longest idle gaps (seconds), each gap named by the innermost harness
    span open on the host at its middle (``host_spans``: (name, t0, t1)
    in seconds of ``time.perf_counter``, which ``shift`` maps to trace
    microseconds); "front end" where no engine call was open."""
    ops = {}
    for e in events:
        if e.get("cat") in DEVICE_CATS and lo <= e["ts"] < hi:
            ops[e["name"]] = ops.get(e["name"], 0.0) + e["dur"]
    device_ops = sorted(ops.items(), key=lambda x: -x[1])[:10]
    gaps, prev = [], lo
    for s, t in merged + [(hi, hi)]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, t)
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    named = []
    for a, b in gaps:
        mid = (a + b) / 2
        inner = [(t1 - t0, n) for n, t0, t1 in host_spans
                 if t0 * 1e6 + shift <= mid <= t1 * 1e6 + shift]
        named.append([min(inner)[1] if inner else "front end",
                      (b - a) / 1e6])
    return ([[n, us / 1e6] for n, us in device_ops], named)
