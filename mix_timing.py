"""Warm passes of the 1M-doc 256-query mix, for timing two trees in turns.

    python3 mix_timing.py --namespace DIR [--tree TREE] [--passes 10]
                          [--profile OUT_DIR] [--docs N] [--device cpu]
                          [--shards N]

Imports ``chip_smoke`` and ``fugu_tpu_torch`` from ``--tree`` (default:
the directory of this file), so a tree unpacked with ``git archive``
(a parent commit, say) runs the same measurement as this one.  If
``DIR`` holds no namespace yet, it first builds ``chip_smoke``'s seeded
corpus (bench.py's generator, ``--docs`` docs, 1M by default) and
commits it there; later runs, from either tree, open the same files.
The namespace is opened with ``NamedIndex`` on the card, the mix runs
once cold (pack uploads) and ``--passes`` times warm, one
``search_topk_batch`` call per limit as in ``chip_smoke.py``.  With
``--shards N`` the index serves through ``enable_sharding`` on an
``N``-shard mesh on the same device.

It prints one JSON line: the tree, the card, the cold seconds, every
warm pass's seconds, their median, min and max, and the QPS of the
median.  With ``--profile``, two more warm passes follow: one under
``torch.profiler``, whose trace (gzipped chrome JSON) goes to
``OUT_DIR`` and gives the pass's wall time, the device's busy time (the
union of its kernel, copy and set intervals inside the pass) and its
idle share; and one under ``cProfile``, whose top host functions by
cumulative time are printed.  Run several of these processes one after
another in one call to compare trees on one card: parent, new, new,
parent.
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
from pathlib import Path


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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--namespace", required=True, type=Path)
    ap.add_argument("--tree", type=Path, default=Path(__file__).parent)
    ap.add_argument("--passes", type=int, default=10)
    ap.add_argument("--profile", type=Path, default=None)
    ap.add_argument("--docs", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shards", type=int, default=0)
    opts = ap.parse_args()
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

    def run_mix():
        for lim, plans in sorted(by_limit.items()):
            ni.search_topk_batch(plans, lim)
        if cuda:
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    run_mix()
    cold = time.perf_counter() - t0
    passes = []
    for _ in range(opts.passes):
        t0 = time.perf_counter()
        run_mix()
        passes.append(time.perf_counter() - t0)
    med = sorted(passes)[len(passes) // 2]
    out = {
        "tree": str(opts.tree), "card": card, "docs": ni.segments[0].doc_count,
        "shards": opts.shards,
        "cold_s": cold, "passes_s": passes, "median_s": med,
        "min_s": min(passes), "max_s": max(passes), "qps": len(mix) / med,
    }
    if opts.profile is not None:
        from torch.profiler import ProfilerActivity, profile, record_function

        opts.profile.mkdir(parents=True, exist_ok=True)
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
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


if __name__ == "__main__":
    main()
