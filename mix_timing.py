"""Warm passes of the 1M-doc 256-query mix, for timing two trees in turns.

    python3 mix_timing.py --namespace DIR [--tree TREE] [--passes 10]
                          [--profile OUT_DIR] [--docs N] [--device cpu]
                          [--shards N] [--bench-cache] [--kernels]
                          [--phrase-route ROUTE[,ROUTE...]] [--overlap N]

Imports ``chip_smoke`` and ``fugu_tpu_torch`` from ``--tree`` (default:
the directory of this file), so a tree unpacked with ``git archive``
(a parent commit, say) runs the same measurement as this one.  If
``DIR`` holds no namespace yet, it first builds ``chip_smoke``'s seeded
corpus (bench.py's generator, ``--docs`` docs, 1M by default) and
commits it there; later runs, from either tree, open the same files.
With ``--bench-cache`` it mounts ``fugu_tpu_torch.bench``'s cached
segment of ``--docs`` docs instead (the same corpus, built by bench
first where the cache lacks it; its files are linked, not copied).
The namespace is opened with ``NamedIndex`` on the card, the mix runs
once cold (pack uploads; the token stream's first build where the
router streams the mix's phrases) and ``--passes`` times warm, one
``search_topk_batch`` call per limit as in ``chip_smoke.py``.  With
``--shards N`` the index serves through ``enable_sharding`` on an
``N``-shard mesh on the same device.

``--phrase-route`` gives the turns of warm passes, each ``auto`` (the
router as the tree has it), ``stream`` or ``host``: a forced turn sets
the router's cost constants in this process only, as the tests do
(``stream`` prices the host matcher at 1e9 ns a posting, ``host`` the
stream at infinity), so ``auto,stream,host,host,stream,auto`` reads the
three in turns on one card.  The cold pass runs under the first turn's route.

It prints one JSON line: the tree, the card, the corpus's docs and
tokens, the cold seconds, and per turn every warm pass's seconds, their
median, min and max, the QPS of the median and the plans per route
(``NamedIndex.routes``; with ``FUGU_DEVICE_PHRASE=1`` in the
environment the phrases the stream declines route to
``device_phrase``); the first turn's numbers are repeated at the top
level.  With ``--overlap N``, one more line gives what the router's
overlap credit is read from (:func:`overlap_line`): the mix's device
plans alone, its phrases alone on the host matcher and through the
stream, and both together with the phrases forced each way, for the
mix's own phrases and again with the first ``N`` plans of
``chip_smoke.make_phrase_batch`` added (0: the mix's only), with the
cost model's estimates and their inputs.  With ``--profile``, two more
warm passes follow under the first turn's route: one under
``torch.profiler``, whose trace (gzipped chrome JSON) goes to
``OUT_DIR`` and gives the pass's wall time, the device's busy time (the
union of its kernel, copy and set intervals inside the pass) and its
idle share; and one under ``cProfile``, whose top host functions by
cumulative time are printed.  With ``--kernels``, one more warm pass
and then ``chip_smoke.make_phrase_batch``'s 256 phrases (a cold pass,
then a recorded one; the router unforced) give each kernel's launches,
its ms over the recorded calls (CUDA events), its bound
(``chip_smoke``'s cost of each call at 3.35 TB/s or 67 TFLOP/s) and, on
every call whose plain version fits in the card's memory beside the
resident packs, its plain version's ms and the largest difference from
it (``chip_smoke``'s comparisons, which fail on a disagreement); one
more JSON line.  Run several of these processes one after another in
one call to compare trees on one card: parent, new, new, parent.
"""

from __future__ import annotations

import argparse
import cProfile
import gzip
import io
import json
import pstats
import sys
import time
from contextlib import contextmanager
from pathlib import Path

#: each forced route's cost constants (``ops/phrase_stream``): "stream"
#: prices the host matcher out at any batch size, "host" prices the
#: stream out
ROUTE_CONSTANTS = {
    "auto": {},
    "stream": {"HOST_NS_PER_MIN_POSTING": 1e9, "PHRASE_MIN_BATCH": 1},
    "host": {"STREAM_FIXED_MS": float("inf")},
}


@contextmanager
def phrase_route(ps, route: str):
    """The phrase router of module ``ps`` forced to ``route`` inside the
    block (see ``ROUTE_CONSTANTS``), restored after it."""
    saved = {k: getattr(ps, k) for k in ROUTE_CONSTANTS[route]}
    for k, v in ROUTE_CONSTANTS[route].items():
        setattr(ps, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(ps, k, v)


#: the small batches of the mix's phrases that ``overlap_line`` times
SMALL_BATCHES = (1, 2, 4, 8)


def median(xs):
    return sorted(xs)[len(xs) // 2]


def busy_ms(trace: dict, name: str):
    """(window ms, device busy ms) of the user annotation ``name`` in a
    chrome trace: the union of the device's intervals inside it."""
    events = trace["traceEvents"]
    win = next(e for e in events
               if e.get("name") == name and e.get("cat") == "user_annotation")
    lo, hi = win["ts"], win["ts"] + win["dur"]
    spans = sorted(
        (max(e["ts"], lo), min(e["ts"] + e["dur"], hi))
        for e in events
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
        and e["ts"] < hi and e["ts"] + e["dur"] > lo
    )
    busy, end = 0.0, lo
    for s, t in spans:
        s = max(s, end)
        if t > s:
            busy += t - s
            end = t
    return (hi - lo) / 1e3, busy / 1e3


def plain_compare(cs, cmp, fk, fp, mod, args):
    """(max abs err, plain ms, kernel ms) of one recorded call against
    its plain version, or None where the plain version does not fit in
    the card's memory (the dense plain phase A at 16M docs, say)."""
    import torch

    try:
        return (cmp(args, mod), cs.cuda_ms(lambda: fp(*args), 1),
                cs.cuda_ms(lambda: fk(*args), 5))
    except torch.OutOfMemoryError:
        torch.cuda.empty_cache()
        return None


def kernel_line(cs, ni, run_mix, device) -> dict:
    """Each kernel's launches, ms, bound and plain comparison over one
    warm mix pass (phase A, block scorer) and one warm phrase batch
    (phrase kernel); see the module docstring."""
    import torch

    from fugu_tpu_torch.ops import batch_scorer as ba
    from fugu_tpu_torch.ops import block_scorer as bs
    from fugu_tpu_torch.ops import phrase_stream as ps

    mods = {"block_scorer": bs, "phase_a": ba, "phrase_stream": ps}
    for mod in mods.values():
        mod.launches = 0
    with cs.Recorder(bs, "score_rows") as rec_s, \
            cs.Recorder(ba, "phasea") as rec_a:
        run_mix()
    phrases = cs.make_phrase_batch(ni.segments[0])
    t0 = time.perf_counter()
    ni.search_topk_batch(phrases, 10)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    ps.launches = 0
    routes = dict(ni.routes)
    with cs.Recorder(ps, "phrase_stream") as rec_p:
        t0 = time.perf_counter()
        ni.search_topk_batch(phrases, 10)
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
    phrase_routes = {k: v - routes.get(k, 0) for k, v in ni.routes.items()}
    # the passes' launches, before the comparisons below launch more
    launched = {name: mod.launches for name, mod in mods.items()}
    out = {"phrase_batch_cold_s": cold, "phrase_batch_warm_s": warm,
           "phrase_batch_routes": phrase_routes, "kernels": []}
    for name, calls, run, plain, cmp, cost in (
        ("block_scorer", rec_s.calls, "score_rows", "score_rows_plain",
         cs.compare_scorer, cs.scorer_cost),
        ("phase_a", rec_a.calls, "phasea", "phasea_plain", cs.compare_phasea,
         cs.phasea_cost),
        ("phrase_stream", rec_p.calls, "phrase_stream",
         "phrase_stream_plain", cs.compare_phrase, cs.phrase_cost),
    ):
        mod = mods[name]
        fk, fp = getattr(mod, run), getattr(mod, plain)
        compared = [c for c in (plain_compare(cs, cmp, fk, fp, mod, a)
                                for a in calls) if c is not None]
        nbytes, ops = (sum(c) for c in zip(*(cost(a) for a in calls))) \
            if calls else (0, 0)
        bound_ms = max(nbytes / cs.HBM_BYTES_S, ops / cs.F32_OPS_S) * 1e3
        out["kernels"].append({
            "name": name, "launches": launched[name], "calls": len(calls),
            "ms": sum(cs.cuda_ms(lambda a=a: fk(*a), 5) for a in calls),
            "bound_ms": bound_ms,
            "bound_by": ("bytes" if nbytes / cs.HBM_BYTES_S
                         >= ops / cs.F32_OPS_S else "operations"),
            "bound_bytes": nbytes, "bound_ops": ops,
            "compared_calls": len(compared),
            "max_abs_err": max((c[0] for c in compared), default=None),
            "plain_ms_compared": sum(c[1] for c in compared),
            "ms_compared": sum(c[2] for c in compared),
        })
    return out


def overlap_line(cs, ni, by_limit, n_extra: int, passes: int,
                 sync) -> dict:
    """What the overlap credit is read from, medians of ``passes``
    warm runs in ms.  ``device_ms``: the mix's device plans alone, one
    call per limit; then for the mix's phrases (``mix``) and for them plus the first
    ``n_extra`` plans of ``make_phrase_batch`` (``batch``; when
    ``n_extra`` > 0): ``host_ms``, the phrases on the host matcher alone
    (``bench.host_path`` on this thread); ``stream_ms``, the phrases
    alone through ``search_topk_batch`` with the stream forced;
    ``with_host_ms`` and ``with_stream_ms``, the device plans and the
    phrases together (the phrases at limit 10, beside the limit-10
    plans) with the phrases forced each way; and the estimates of the
    tree's cost model for them (host, stream, and the credit
    ``estimate_device_batch_ms`` gives the limit-10 call's device
    plans) and each phrase's dfs and host ms; then the first 1, 2, 4
    and 8 of the mix's phrases alone on the host matcher and through
    the stream (``small``).  The host work the device batch hid is
    ``device_ms + host_ms - with_host_ms``; what the stream added,
    ``with_stream_ms - device_ms``."""
    from fugu_tpu_torch.bench import host_path
    from fugu_tpu_torch.ops import phrase_stream as ps
    from fugu_tpu_torch.tools.phrase_cost_validate import phrase_dfs

    seg = ni.segments[0]
    stats = ni.stats()
    dev = {lim: [p for p in plans if not p.host_only]
           for lim, plans in sorted(by_limit.items())}
    mix_phrases = [p for plans in by_limit.values() for p in plans
                   if p.host_only]

    def timed(fn):
        fn()
        out = []
        for _ in range(passes):
            t0 = time.perf_counter()
            fn()
            sync()
            out.append((time.perf_counter() - t0) * 1e3)
        return median(out)

    def run(batches):
        for lim, plans in batches.items():
            if plans:
                ni.search_topk_batch(plans, lim)

    n_dev10 = len(dev.get(10, []))
    out = {
        "tokens": sum(stats.total_tokens.values()),
        "device_plans": {lim: len(p) for lim, p in dev.items()},
        "device_ms": timed(lambda: run(dev)),
        "credit_est_ms": ps.estimate_device_batch_ms(stats, n_dev10),
    }
    sets = [("mix", mix_phrases)]
    if n_extra:
        sets.append(("batch", mix_phrases
                     + cs.make_phrase_batch(seg)[:n_extra]))
    for name, phrases in sets:
        together = dict(dev)
        together[10] = dev.get(10, []) + phrases
        row = {
            "phrases": len(phrases),
            "host_est_ms": ps.estimate_host_ms(phrases, stats),
            "stream_est_ms": ps.estimate_stream_ms(stats, len(phrases),
                                                   phrases),
            "plan_dfs": phrase_dfs(phrases, stats),
            "host_ms": timed(lambda: [host_path(seg, p, stats, 10)
                                      for p in phrases]),
        }
        each = []
        for p in phrases:
            t0 = time.perf_counter()
            host_path(seg, p, stats, 10)
            each.append((time.perf_counter() - t0) * 1e3)
        row["host_plan_ms"] = each
        with phrase_route(ps, "stream"):
            row["stream_ms"] = timed(lambda: run({10: phrases}))
            row["with_stream_ms"] = timed(lambda: run(together))
        with phrase_route(ps, "host"):
            row["with_host_ms"] = timed(lambda: run(together))
        row["hidden_ms"] = out["device_ms"] + row["host_ms"] \
            - row["with_host_ms"]
        row["stream_added_ms"] = row["with_stream_ms"] - out["device_ms"]
        out[name] = row
    # small batches of the mix's phrases alone, each way
    out["small"] = []
    for k in SMALL_BATCHES:
        phrases = mix_phrases[:k]
        with phrase_route(ps, "stream"):
            stream_ms = timed(lambda: run({10: phrases}))
        out["small"].append({
            "phrases": k, "plan_dfs": phrase_dfs(phrases, stats),
            "host_ms": timed(lambda: [host_path(seg, p, stats, 10)
                                      for p in phrases]),
            "stream_ms": stream_ms,
            "host_est_ms": ps.estimate_host_ms(phrases, stats),
            "stream_est_ms": ps.estimate_stream_ms(stats, k, phrases),
        })
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--namespace", required=True, type=Path)
    ap.add_argument("--tree", type=Path, default=Path(__file__).parent)
    ap.add_argument("--passes", type=int, default=10)
    ap.add_argument("--profile", type=Path, default=None)
    ap.add_argument("--docs", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shards", type=int, default=0)
    ap.add_argument("--bench-cache", action="store_true")
    ap.add_argument("--kernels", action="store_true")
    ap.add_argument("--phrase-route", default="auto")
    ap.add_argument("--overlap", type=int, default=None)
    opts = ap.parse_args()
    routes = opts.phrase_route.split(",")
    bad = [r for r in routes if r not in ROUTE_CONSTANTS]
    if bad:
        ap.error(f"--phrase-route: {bad} not in {sorted(ROUTE_CONSTANTS)}")
    tree = opts.tree.resolve()
    sys.path.insert(0, str(tree))
    import torch

    import chip_smoke as cs
    from fugu_tpu_torch.device import resolve
    from fugu_tpu_torch.engine.named_index import NamedIndex
    from fugu_tpu_torch.index.manifest import Manifest, save_segment
    from fugu_tpu_torch.index.schema import IndexType

    import fugu_tpu_torch

    for mod in (cs, fugu_tpu_torch):
        if tree not in Path(mod.__file__).resolve().parents:
            cs.fail(f"{mod.__name__} imported from {mod.__file__}, not {tree}")
    device = resolve(opts.device)
    cuda = device.type == "cuda"
    card = cs.card_line() if cuda else "cpu"
    ns = opts.namespace.resolve()
    if not (ns / "meta.json").exists() and opts.bench_cache:
        from fugu_tpu_torch import bench
        from fugu_tpu_torch.tools.live_load import mount

        n = opts.docs or cs.N_DOCS
        seg_id = f"torchbenchv1{n}"
        if not (bench.CACHE / f"seg-{seg_id}.npz").exists():
            bench.build_corpus(n)
        mount(ns, bench.CACHE, [(seg_id, n)])
    if not (ns / "meta.json").exists():
        ns.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        seg = cs.build_corpus(opts.docs or cs.N_DOCS, cs.SEED, cs.VOCAB_SIZE)
        seg.segment_id = "mix1m"
        save_segment(seg, ns)
        Manifest(ns).commit([seg])
        cs.log(f"built the namespace in {time.perf_counter() - t0:.1f} s")
        del seg
    ni = NamedIndex("mix", ns, IndexType.DOCS, device=device)
    if opts.shards:
        from fugu_tpu_torch.parallel.sharded import make_mesh

        ni.enable_sharding(make_mesh(opts.shards, device=device.type))
    mix = cs.make_query_mix(ni.segments[0])
    by_limit = {}
    for _cls, plan, lim in mix:
        by_limit.setdefault(lim, []).append(plan)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def run_mix():
        for lim, plans in sorted(by_limit.items()):
            ni.search_topk_batch(plans, lim)
        sync()

    from fugu_tpu_torch.ops import phrase_stream as ps

    with phrase_route(ps, routes[0]):
        t0 = time.perf_counter()
        run_mix()
        cold = time.perf_counter() - t0
    turns = []
    for route in routes:
        ni.routes.clear()
        passes = []
        with phrase_route(ps, route):
            for _ in range(opts.passes):
                t0 = time.perf_counter()
                run_mix()
                passes.append(time.perf_counter() - t0)
        med = median(passes)
        turns.append({
            "route": route, "passes_s": passes, "median_s": med,
            "min_s": min(passes), "max_s": max(passes),
            "qps": len(mix) / med, "routes": dict(ni.routes),
        })
    stats = ni.stats()
    out = {
        "tree": str(opts.tree), "card": card, "docs": ni.segments[0].doc_count,
        "tokens": sum(stats.total_tokens.values()), "shards": opts.shards,
        "cold_s": cold, "phrase_route": routes[0],
        **{k: v for k, v in turns[0].items() if k != "route"},
        "turns": turns,
    }
    if opts.profile is not None:
        from torch.profiler import ProfilerActivity, profile, record_function

        with phrase_route(ps, routes[0]):
            opts.profile.mkdir(parents=True, exist_ok=True)
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if cuda else [])
            with profile(activities=acts) as prof:
                with record_function("warm_pass"):
                    run_mix()
            raw = opts.profile / "trace.json"
            prof.export_chrome_trace(str(raw))
            trace = json.loads(raw.read_text())
            with gzip.open(opts.profile / "trace.json.gz", "wt") as f:
                json.dump(trace, f)
            raw.unlink()
            wall, busy = busy_ms(trace, "warm_pass")
            out.update(profiled_wall_ms=wall, device_busy_ms=busy,
                       device_idle_share=1.0 - busy / wall)
            pr = cProfile.Profile()
            pr.enable()
            run_mix()
            pr.disable()
            text = io.StringIO()
            pstats.Stats(pr, stream=text).sort_stats("cumulative").print_stats(25)
            cs.log(text.getvalue())
    cs.log(json.dumps(out))
    if opts.overlap is not None:
        cs.log(json.dumps(dict(overlap_line(cs, ni, by_limit, opts.overlap,
                                            opts.passes, sync),
                               card=card, docs=out["docs"])))
    if opts.kernels and cuda:
        cs.log(json.dumps(dict(kernel_line(cs, ni, run_mix, device),
                               card=card, docs=out["docs"],
                               tokens=out["tokens"])))


if __name__ == "__main__":
    main()
