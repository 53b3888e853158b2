"""The phrase router's choices against measured host and stream times,
on two corpora of different df profiles: the counterpart of the repo's
``tools/phrase_cost_validate.py``.

    python3 -m fugu_tpu_torch.tools.phrase_cost_validate [--docs 500000]
        [--device cuda]

Two synthetic corpora are built (and cached in ``.bench_cache/`` as
``seg-torchcostval<tag><N>``): "home", bench's shape (Zipf 1.07, about
55 tokens a doc), and "flat" (Zipf 0.7, about 25 tokens a doc), each
``--docs`` docs drawn as the reference tool draws them (seed 11, doc
lengths Poisson clipped to [4, 200]).  On each, four phrase batches
span the df spectrum (:func:`phrase_batches`: 16 selective phrases, 16
heavy, 32 mixed, 160 heavy).  Per batch it takes ``want_stream``'s
decision and the cost model's two estimates, then times the host
matcher (``search_blockmax``, the oracle where it declines; each plan
on its own too) against the phrase stream (``phrase_stream_begin`` and
``phrase_stream_collect`` on the device, split into staging and
launches, the device wait and the verify, the host matcher for what it
declines), the medians of 3 warm runs, then once more the stream's
verify of each plan (``_rescore_blocks``), and says whether the router
picked the measured winner.  Decisions where the two times lie within
``TOLERANCE_PCT`` of each other count as right either way.

It changes no constant.  Its line (with each plan's dfs, host ms and
verify ms) is an input of ``tools/routing_fit``, which fits the
routing constants of ``ops/phrase_stream.py``.  Prints one JSON line
``{"ok", "tolerance_pct", "card", "points"}``; exits 0 when every
decision was right, 2 otherwise, 1 without the device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

from fugu_tpu_torch.bench import log

TOLERANCE_PCT = 25.0
#: (tag, Zipf exponent, mean doc length) of the two corpora
CORPORA = (("home", 1.07, 55), ("flat", 0.7, 25))


def build_corpus(tag: str, n_docs: int, zipf_s: float, mean_len: int,
                 cache: Path = None):
    """The reference tool's corpus (seed 11, no facets, stored ids),
    drawn in chunks (``bench.iter_texts``) and cached."""
    from fugu_tpu_torch import bench
    from fugu_tpu_torch.index.manifest import load_segment, save_segment
    from fugu_tpu_torch.index.schema import DOCS_SCHEMA
    from fugu_tpu_torch.index.segment import SegmentBuilder

    cache = bench.CACHE if cache is None else Path(cache)
    cache.mkdir(parents=True, exist_ok=True)
    seg_id = f"torchcostval{tag}{n_docs}"
    if (cache / f"seg-{seg_id}.npz").exists():
        log(f"loading cached {seg_id}")
        return load_segment(cache, seg_id, DOCS_SCHEMA)
    log(f"building {seg_id}: {n_docs} docs, zipf {zipf_s}, len {mean_len}")
    rng = np.random.default_rng(11)
    lens = np.clip(rng.poisson(mean_len, n_docs), 4, 200)
    b = SegmentBuilder(DOCS_SCHEMA)
    for texts in bench.iter_texts(rng, lens, bench.VOCAB_SIZE, zipf_s):
        for text in texts:
            b.add_document({"text": [text]},
                           stored={"id": f"d{b.doc_count}"})
    seg = b.build()
    seg.segment_id = seg_id
    save_segment(seg, cache)
    return seg


def phrase_batches(seg):
    """(name, plans): batches spanning the df spectrum: selective
    (uniform term draw), heavy (df-weighted draw), mixed, and a large
    heavy batch above ``PHRASE_AUTO_MIN``."""
    from fugu_tpu_torch.query import Occur, PhraseClause, QueryGroup, QueryPlan

    rng = np.random.default_rng(3)
    terms = sorted(seg.terms["text"].keys())
    dfs = np.array([seg.terms["text"][t].doc_freq for t in terms],
                   dtype=np.float64)
    w = dfs / dfs.sum()
    uni = np.ones(len(terms)) / len(terms)

    def plan(words):
        return QueryPlan(groups=(QueryGroup(
            Occur.SHOULD, phrases=(PhraseClause("text", tuple(words)),)),))

    def pick(n, p):
        idx = rng.choice(len(terms), size=n, replace=False, p=p)
        return [terms[i] for i in idx]

    return [
        ("selective16", [plan(pick(2, uni)) for _ in range(16)]),
        ("heavy16", [plan(pick(2, w)) for _ in range(16)]),
        ("mixed32", [plan(pick(2, w if i % 2 else uni)) for i in range(32)]),
        ("heavy160", [plan(pick(2, w)) for _ in range(160)]),
    ]


def decision(plans, stats) -> dict:
    """``want_stream``'s choice for a pure phrase batch (no concurrent
    device batch) and the cost model's two estimates, in ms."""
    from fugu_tpu_torch.ops.phrase_stream import (
        estimate_host_ms, estimate_stream_ms, want_stream,
    )

    return {
        "routed_stream": bool(want_stream(len(plans), plans=plans,
                                          stats=stats)),
        "host_est_ms": estimate_host_ms(plans, stats),
        "stream_est_ms": estimate_stream_ms(stats, len(plans), plans),
        "tokens": sum(stats.total_tokens.values()),
    }


def phrase_dfs(plans, stats):
    """Each plan's phrase terms' dfs (the host estimate's inputs)."""
    return [[stats.doc_freq(pc.field, t) for t in pc.terms]
            for p in plans for g in p.groups for pc in g.phrases]


def measure(seg, stats, plans, device, reps: int = 3):
    """(host ms, stream ms, stream split, host ms a plan) medians of
    serving the whole batch; the split is the stream's staging and
    launches, its wait for the device, and its fetch and host verify
    with the host matcher for what it declines, in ms."""
    import torch

    from fugu_tpu_torch.bench import host_path
    from fugu_tpu_torch.ops.blockmax import search_blockmax
    from fugu_tpu_torch.ops.phrase_stream import (
        phrase_stream_begin, phrase_stream_collect,
    )

    def host_run():
        each = []
        for p in plans:
            t0 = time.perf_counter()
            host_path(seg, p, stats, 10)
            each.append((time.perf_counter() - t0) * 1000)
        return each

    def stream_run():
        t0 = time.perf_counter()
        handle = phrase_stream_begin(seg, plans, stats, [10] * len(plans),
                                     device)
        t1 = time.perf_counter()
        if device.type == "cuda":
            torch.cuda.synchronize()
        t2 = time.perf_counter()
        res = phrase_stream_collect(handle)
        # what the stream declines the host matcher serves
        for p, r in zip(plans, res):
            if r is None:
                search_blockmax(seg, p, stats, 10)
        return [(t1 - t0) * 1000, (t2 - t1) * 1000,
                (time.perf_counter() - t2) * 1000]

    host_run()  # warm the skip tables
    stream_run()  # the token stream's build and upload
    hs, ss = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        hs.append(host_run())
        ss.append(stream_run())
    hs.sort(key=sum)
    ss.sort(key=sum)
    per_plan = [sorted(x)[len(x) // 2] for x in zip(*hs)]
    return (sum(hs[len(hs) // 2]), sum(ss[len(ss) // 2]), ss[len(ss) // 2],
            per_plan, verify_ms(seg, stats, plans, device))


def verify_ms(seg, stats, plans, device):
    """The stream's host verify (``_rescore_blocks``) of each plan in
    one more warm run, in ms (None for a plan it did not verify)."""
    from fugu_tpu_torch.ops import phrase_stream as ps

    inner = ps._rescore_blocks
    took = {}

    def timed(segment, pc, *a, **k):
        t0 = time.perf_counter()
        out = inner(segment, pc, *a, **k)
        took.setdefault(pc, []).append((time.perf_counter() - t0) * 1000)
        return out

    ps._rescore_blocks = timed
    try:
        ps.batch_phrase_search(seg, plans, stats, [10] * len(plans), device)
    finally:
        ps._rescore_blocks = inner
    out = []
    for p in plans:
        pc = ps.eligible_phrase(p)
        out.append(took[pc].pop(0) if took.get(pc) else None)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--docs", type=int, default=500_000)
    ap.add_argument("--device", default="cuda")
    opts = ap.parse_args(argv)
    from fugu_tpu_torch.bench import card_line
    from fugu_tpu_torch.device import resolve
    from fugu_tpu_torch.ops import oracle

    try:
        device = resolve(opts.device)
    except RuntimeError as e:
        print(json.dumps({"ok": False, "error": str(e)}), flush=True)
        return 1
    points = []
    ok = True
    for tag, zipf_s, mean_len in CORPORA:
        seg = build_corpus(tag, opts.docs, zipf_s, mean_len)
        stats = oracle.IndexStats([seg])
        for bname, plans in phrase_batches(seg):
            pt = {"corpus": tag, "docs": seg.doc_count, "batch": bname,
                  **decision(plans, stats)}
            host_ms, stream_ms, split, each, verify = measure(
                seg, stats, plans, device)
            wins = stream_ms < host_ms
            near = (abs(host_ms - stream_ms)
                    <= TOLERANCE_PCT / 100.0 * max(host_ms, stream_ms))
            good = near or pt["routed_stream"] == wins
            ok &= good
            pt.update(host_ms=host_ms, stream_ms=stream_ms,
                      stream_split_ms=split, host_plan_ms=each,
                      verify_plan_ms=verify,
                      plan_dfs=phrase_dfs(plans, stats),
                      measured_stream_wins=wins,
                      near_crossover=near, ok=good)
            points.append(pt)
            log(f"{tag}/{bname}: {pt}")
        del seg, stats
    print(json.dumps({
        "ok": ok, "tolerance_pct": TOLERANCE_PCT,
        "card": card_line() if device.type == "cuda" else "cpu",
        "points": points}), flush=True)
    return 0 if ok else 2


if __name__ == "__main__":
    sys.exit(main())
