"""A slop-heavy phrase batch, the phrase stream against the host
matcher, on bench's corpus: the counterpart of the repo's
``tools/slop_ab.py``.

    python3 -m fugu_tpu_torch.tools.slop_ab [--docs 1000000] [--device cuda]

192 phrases of two or three Zipf-drawn terms (seed 5), each with slop 1
or 2, go through the phrase stream called directly
(``ops/phrase_stream.batch_phrase_search``; what it declines, the host
matcher) and through the host matcher (``ops/phrase.search_phrase_topk``,
then ``search_blockmax``, then the oracle): a first run of each (the
stream's includes the token pack's build and upload), then 3 runs in
turns.  It prints the reference tool's line (each side's range in ms,
QPS at the median, parity n/n of the last runs' results) and one JSON
line of the same numbers with the card.  ``--device`` defaults to
``cuda``; without a CUDA device it prints a JSON error line and exits 1.
It exits 2 when a result differs.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from fugu_tpu_torch.bench import log

N_PLANS = 192


def slop_plans(n: int = N_PLANS):
    """The reference tool's plans: two or three terms drawn by Zipf 1.07
    rank over bench's 30,000-term vocabulary, slop 1 or 2."""
    from fugu_tpu_torch.query import Occur, PhraseClause, QueryGroup, QueryPlan

    rng = np.random.default_rng(5)
    p = 1.0 / np.arange(1, 30_000 + 1) ** 1.07
    p /= p.sum()
    plans = []
    for _ in range(n):
        k = int(rng.integers(2, 4))
        words = [f"t{j:05d}"
                 for j in rng.choice(30_000, size=k, replace=False, p=p)]
        plans.append(QueryPlan(groups=(QueryGroup(
            Occur.SHOULD,
            phrases=(PhraseClause("text", tuple(words),
                                  slop=int(rng.integers(1, 3))),),
        ),)))
    return plans


def run(seg, stats, plans, device, reps: int = 3) -> dict:
    """Both sides' first and warm times (s) and the parity of the last
    warm runs."""
    from fugu_tpu_torch.ops import oracle
    from fugu_tpu_torch.ops.blockmax import search_blockmax
    from fugu_tpu_torch.ops.phrase import search_phrase_topk
    from fugu_tpu_torch.ops.phrase_stream import batch_phrase_search

    def host_run():
        out = []
        for pl in plans:
            r = search_phrase_topk(seg, pl, stats, 10)
            if r is None:
                r = search_blockmax(seg, pl, stats, 10)
            if r is None:
                r = [(h.score, h.doc)
                     for h in oracle.search([seg], pl, 10, stats)]
            out.append(r)
        return out

    def stream_run():
        res = batch_phrase_search(seg, plans, stats, [10] * len(plans),
                                  device)
        for j, r in enumerate(res):
            if r is None:
                res[j] = search_phrase_topk(seg, plans[j], stats, 10)
        return res

    t0 = time.perf_counter()
    stream_run()
    first_stream = time.perf_counter() - t0
    t0 = time.perf_counter()
    host_run()
    first_host = time.perf_counter() - t0
    hs, ss = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        sr = stream_run()
        ss.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        hr = host_run()
        hs.append(time.perf_counter() - t0)
    return {"stream_s": ss, "host_s": hs, "first_stream_s": first_stream,
            "first_host_s": first_host,
            "parity": sum(1 for a, b in zip(sr, hr) if a == b),
            "plans": len(plans)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--docs", type=int, default=1_000_000)
    ap.add_argument("--device", default="cuda")
    opts = ap.parse_args(argv)
    from fugu_tpu_torch import bench
    from fugu_tpu_torch.device import resolve
    from fugu_tpu_torch.ops import oracle

    try:
        device = resolve(opts.device)
    except RuntimeError as e:
        print(json.dumps({"ok": False, "error": str(e)}), flush=True)
        return 1
    seg, _t = bench.build_corpus(opts.docs)
    stats = oracle.IndexStats([seg])
    log("first runs: the stream's includes the token pack's build")
    out = run(seg, stats, slop_plans(), device)
    ss, hs, n = out["stream_s"], out["host_s"], out["plans"]
    print(f"slop-heavy {n} phrases @{seg.doc_count} docs: stream "
          f"{min(ss) * 1e3:.0f}-{max(ss) * 1e3:.0f}ms "
          f"({n / sorted(ss)[1]:.1f} QPS) vs host "
          f"{min(hs) * 1e3:.0f}-{max(hs) * 1e3:.0f}ms "
          f"({n / sorted(hs)[1]:.1f} QPS); parity {out['parity']}/{n}",
          flush=True)
    ok = out["parity"] == n
    print(json.dumps({
        "ok": ok, "docs": seg.doc_count,
        "card": bench.card_line() if device.type == "cuda" else "cpu",
        **out}), flush=True)
    return 0 if ok else 2


if __name__ == "__main__":
    sys.exit(main())
