"""The phrase router's cost constants fitted from the card's readings.

    python3 -m fugu_tpu_torch.tools.routing_fit READINGS...

Each ``READINGS`` file is the output of ``tools/phrase_cost_validate``
(its JSON line: per batch each plan's dfs and host ms, and the stream's
ms; a batch without its plans' dfs is skipped) or of ``mix_timing.py
--overlap`` (its overlap line: the mix's phrases, more phrases beside
them and small batches, each phrase's dfs and host ms, and the stream's
ms).  A batch is one set of phrases timed both ways.  Non-negative
least squares on the relative error over the batches fits:

- the host matcher's four constants (``HOST_NS_PER_MIN_POSTING``,
  ``HOST_NS_PER_INTER_DOC``, ``HOST_NS_PER_OTHER_POSTING``,
  ``HOST_MS_PER_MATCHING_PHRASE``) to each batch's host ms;
- the stream's ``STREAM_FIXED_MS``, ``STREAM_MS_PER_PHRASE`` and
  ``STREAM_VERIFY_MS`` to each batch's stream ms less the kernel's sweep
  at the module's ``STREAM_NS_PER_TOKEN``, at each
  ``STREAM_VERIFY_HALF_DOCS`` of ``HALF_DOCS_GRID``, keeping the one of
  least residual;
- and the reference's form on the same batches (its two host constants
  and the stream's fixed and per-phrase costs, the added terms at 0).

It prints one JSON line: the fitted constants; per batch its measured
host and stream ms beside the estimates of the constants in
``ops/phrase_stream`` as they stand and whether ``want_stream`` picks
the measured winner there (within ``TOLERANCE_PCT`` either way counts,
as in ``phrase_cost_validate``); the reference form's constants and the
same per batch under them; and the cost tool's phrases by their
expected intersection I (decades, ``BINS``): count, mean host ms and
mean verify ms (0 for a phrase the stream did not verify).  It runs
anywhere: it reads files.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

import numpy as np

from fugu_tpu_torch.tools.phrase_cost_validate import TOLERANCE_PCT

HOST_CONSTANTS = ("HOST_NS_PER_MIN_POSTING", "HOST_NS_PER_INTER_DOC",
                  "HOST_NS_PER_OTHER_POSTING", "HOST_MS_PER_MATCHING_PHRASE")
STREAM_CONSTANTS = ("STREAM_FIXED_MS", "STREAM_MS_PER_PHRASE",
                    "STREAM_VERIFY_MS")
#: the ``STREAM_VERIFY_HALF_DOCS`` tried: ten a decade from 10 to 10**6
HALF_DOCS_GRID = tuple(10.0 ** (k / 10) for k in range(10, 61))
#: the lower edges of the expected-intersection bins of ``by_intersection``
BINS = (0.0, 1.0, 10.0, 100.0, 1e3, 1e4, 1e5)


class _Stats:
    """The cost model's view of a corpus: docs, tokens and the dfs of
    the phrases' terms (each plan's terms named apart)."""

    def __init__(self, docs: int, tokens: int, dfs: dict):
        self.doc_count = docs
        self.total_tokens = {"text": tokens}
        self._dfs = dfs

    def doc_freq(self, field, term):
        return self._dfs[term]

    fingerprint = None


def batch(name: str, docs: int, tokens: int, plan_dfs, host_ms: float,
          stream_ms: float) -> dict:
    """One batch: plans whose phrases have the given dfs, its stats, and
    its measured ms."""
    from fugu_tpu_torch.query import Occur, PhraseClause, QueryGroup, QueryPlan

    plans, dfs = [], {}
    for i, ds in enumerate(plan_dfs):
        terms = tuple(f"p{i}t{j}" for j in range(len(ds)))
        dfs.update(zip(terms, ds))
        plans.append(QueryPlan(groups=(QueryGroup(
            Occur.SHOULD, phrases=(PhraseClause("text", terms),)),)))
    return {"name": name, "plans": plans,
            "stats": _Stats(docs, tokens, dfs), "host_ms": host_ms,
            "stream_ms": stream_ms}


def read_batches(paths):
    """The batches of the readings' JSON lines."""
    batches = []
    for path in paths:
        for line in Path(path).read_text().splitlines():
            line = line.strip()
            if not line.startswith("{"):
                continue
            d = json.loads(line)
            if "points" in d:
                for p in d["points"]:
                    if "plan_dfs" not in p:
                        continue
                    batches.append(batch(
                        f"{p['corpus']}/{p['batch']}@{p['docs']}", p["docs"],
                        p["tokens"], p["plan_dfs"], p["host_ms"],
                        p["stream_ms"]))
                    batches[-1]["plan_ms"] = list(zip(p["host_plan_ms"],
                                                      p["verify_plan_ms"]))
            elif "device_ms" in d:
                for name in ("mix", "batch"):
                    r = d.get(name, {})
                    if "plan_dfs" in r:
                        batches.append(batch(
                            f"{name}{r['phrases']}@{d['docs']}",
                            d["docs"], d["tokens"], r["plan_dfs"],
                            r["host_ms"], r["stream_ms"]))
                for r in d.get("small", []):
                    batches.append(batch(
                        f"small{r['phrases']}@{d['docs']}", d["docs"],
                        d["tokens"], r["plan_dfs"], r["host_ms"],
                        r["stream_ms"]))
    return batches


def host_features(plans, stats):
    """The host estimate's terms at a unit constant each (ms)."""
    from fugu_tpu_torch.ops.phrase_stream import (
        _bitmap_postings, _live_phrases,
    )

    n = max(stats.doc_count, 1)
    f = np.zeros(4)
    for dfs, min_df, expected, inter, slop_f in _live_phrases(plans, stats):
        f += (min_df * 1e-6, inter * slop_f * 1e-6 * (1.0 + 3.0 * min_df / n),
              _bitmap_postings(dfs, n) * 1e-6, -math.expm1(-expected))
    return f


def stream_features(plans, stats, half_docs: float):
    """The stream estimate's fitted terms at a unit constant each (ms):
    the batch, its phrases, and their verify's share at
    ``STREAM_VERIFY_HALF_DOCS`` = ``half_docs``."""
    from fugu_tpu_torch.ops.phrase_stream import _live_phrases

    f = np.array([1.0, float(len(plans)), 0.0])
    for _d, _m, expected, _i, _s in _live_phrases(plans, stats):
        f[2] += expected / (expected + half_docs)
    return f


def nnls(a: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Non-negative least squares of ``a @ x = y`` for a few unknowns:
    the least-squares solution on each subset of the columns, the best
    of those with no negative value (the solution is the unconstrained
    one on its own positive columns)."""
    k = a.shape[1]
    best, best_res = np.zeros(k), float(np.sum(y * y))
    for mask in range(1, 1 << k):
        cols = [j for j in range(k) if mask >> j & 1]
        x = np.linalg.lstsq(a[:, cols], y, rcond=None)[0]
        if (x < 0).any():
            continue
        res = float(np.sum((a[:, cols] @ x - y) ** 2))
        if res < best_res:
            best, best_res = np.zeros(k), res
            best[cols] = x
    return best


def _relative_fit(a: np.ndarray, y: np.ndarray):
    """(constants, squared residual) of the non-negative fit of ``a @ x``
    to ``y`` on the relative error."""
    x = nnls(a / y[:, None], np.ones(len(y)))
    return x, float(np.sum((a @ x / y - 1.0) ** 2))


def _targets(batches):
    """(host ms, stream ms less the kernel's sweep at the module's
    ``STREAM_NS_PER_TOKEN``) of each batch."""
    from fugu_tpu_torch.ops.phrase_stream import STREAM_NS_PER_TOKEN

    return (np.array([b["host_ms"] for b in batches]),
            np.array([b["stream_ms"] - sum(b["stats"].total_tokens.values())
                      * STREAM_NS_PER_TOKEN * 1e-6 for b in batches]))


def fit(batches) -> dict:
    """The fitted constants (see the module docstring)."""
    host_y, stream_y = _targets(batches)
    host_c, _res = _relative_fit(np.array([
        host_features(b["plans"], b["stats"]) for b in batches]), host_y)
    fits = []
    for half in HALF_DOCS_GRID:
        stream_a = np.array([stream_features(b["plans"], b["stats"], half)
                             for b in batches])
        fits.append(_relative_fit(stream_a, stream_y) + (half,))
    stream_c, _res, half = min(fits, key=lambda f: f[1])
    out = dict(zip(HOST_CONSTANTS, host_c))
    out.update(zip(STREAM_CONSTANTS, stream_c))
    out["STREAM_VERIFY_HALF_DOCS"] = half
    return {k: float(v) for k, v in out.items()}


def fit_reference_form(batches) -> dict:
    """The reference's form fitted to the same batches: the host's two
    constants and the stream's fixed and per-phrase costs (its sweep at
    the module's ``STREAM_NS_PER_TOKEN``), the port's added terms at 0."""
    host_y, stream_y = _targets(batches)
    host_c, _res = _relative_fit(np.array([
        host_features(b["plans"], b["stats"])[:2] for b in batches]), host_y)
    stream_a = np.array([[1.0, float(len(b["plans"]))] for b in batches])
    stream_c, _res = _relative_fit(stream_a, stream_y)
    out = dict(zip(HOST_CONSTANTS, list(host_c) + [0.0, 0.0]))
    out.update(zip(STREAM_CONSTANTS, list(stream_c) + [0.0]))
    return {k: float(v) for k, v in out.items()}


def routed_with(constants: dict, batches) -> list:
    """``check`` with ``constants`` set in ``ops/phrase_stream`` for the
    call (and restored after)."""
    from fugu_tpu_torch.ops import phrase_stream as ps

    old = {k: getattr(ps, k) for k in constants}
    try:
        for k, v in constants.items():
            setattr(ps, k, v)
        return check(batches)
    finally:
        for k, v in old.items():
            setattr(ps, k, v)


def check(batches) -> list:
    """Per batch: measured ms beside the module's estimates, and whether
    ``want_stream`` picks the measured winner."""
    from fugu_tpu_torch.ops import phrase_stream as ps

    rows = []
    for b in batches:
        plans, stats = b["plans"], b["stats"]
        host, stream = b["host_ms"], b["stream_ms"]
        routed = ps.want_stream(len(plans), plans=plans, stats=stats)
        near = abs(host - stream) <= TOLERANCE_PCT / 100 * max(host, stream)
        rows.append({
            "batch": b["name"], "phrases": len(plans), "host_ms": host,
            "host_est_ms": ps.estimate_host_ms(plans, stats),
            "stream_ms": stream,
            "stream_est_ms": ps.estimate_stream_ms(stats, len(plans), plans),
            "routed_stream": routed, "ok": near or routed == (stream < host),
        })
    return rows


def by_intersection(batches) -> list:
    """The cost tool's phrases binned by expected intersection I: [lower
    edge, count, mean host ms, mean verify ms]."""
    from fugu_tpu_torch.ops.phrase_stream import _live_phrases

    rows = [[lo, 0, 0.0, 0.0] for lo in BINS]
    for b in batches:
        if "plan_ms" not in b:
            continue
        for plan, (host, verify) in zip(b["plans"], b["plan_ms"]):
            for _d, _m, expected, _i, _s in _live_phrases([plan], b["stats"]):
                row = rows[sum(expected >= lo for lo in BINS) - 1]
                row[1] += 1
                row[2] += host
                row[3] += verify or 0.0
    return [[lo, n, h / n, v / n] for lo, n, h, v in rows if n]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("readings", nargs="+")
    opts = ap.parse_args(argv)
    batches = read_batches(opts.readings)
    rows = check(batches)
    ref = fit_reference_form(batches)
    ref_rows = routed_with(ref, batches)
    print(json.dumps({"fitted": fit(batches), "batches": rows,
                      "all_ok": all(r["ok"] for r in rows),
                      "reference_form": {
                          "fitted": ref, "batches": ref_rows,
                          "all_ok": all(r["ok"] for r in ref_rows)},
                      "by_intersection": by_intersection(batches)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
