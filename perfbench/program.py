"""The program's own spans and counters over the window, for the
per-layer readers that read them.

``fugu_tpu_torch.server.metrics.REGISTRY`` keeps the samples of its last
two renders (``between_renders``), and the run renders ``/metrics``
right before and right after the window, in this process: their change
is the window's, as a scraper computes it.  A program that keeps no such
record, or renders that are not the window's (their engine calls differ
from ``rec["stages"]``'s), give None, never a wrong number.
"""

from __future__ import annotations

ENGINE = "fugu_search_engine_seconds"


def window(rec: dict):
    """{sample as ``/metrics`` writes it: change over the window}, or
    None."""
    try:
        from fugu_tpu_torch.server.metrics import REGISTRY
    except ImportError:
        return None
    between = getattr(REGISTRY, "between_renders", None)
    if between is None:
        return None
    delta = between()
    if delta.get(ENGINE + "_count") != rec["stages"][ENGINE][1]:
        return None
    return delta


def engine_calls(rec: dict) -> float:
    return rec["stages"][ENGINE][1]


def family(delta: dict, name: str) -> list:
    """The changes of every labelled sample of ``name``."""
    return [v for k, v in delta.items() if k.startswith(name + "{")]


def span_ms_per_call(rec: dict, span: str):
    """ms a window's engine call spends in the span ``span``."""
    delta = window(rec)
    key = f'fugu_span_seconds_sum{{span="{span}"}}'
    if delta is None or key not in delta or not engine_calls(rec):
        return None
    return delta[key] / engine_calls(rec) * 1e3
