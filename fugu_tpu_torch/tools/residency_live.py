"""Two-namespace device-residency drill, the counterpart of the repo's
``tools/residency_live.py``.

    python3 -m fugu_tpu_torch.tools.residency_live [--big 16000000]
        [--small 1000000] [--headroom-mb 200] [--device cuda]

Serves two cached bench corpora (``fugu_tpu_torch.bench.build_corpus``,
built first where the cache lacks one) from one process in turns, big,
small, big.  Each step sends the first 48 device-path plans of
bench's mix over that corpus (its phrases left out) through
``ops/batch_scorer.batch_search``, which uploads the corpus's entry and
block-major packs under ``ops/residency.py``'s budget, and holds 8 of
the results to the oracle, exact.  After step 0 the budget is pinned to
the first corpus's pack bytes plus ``--headroom-mb``
(``FUGU_DEVICE_MEM_BUDGET``; what is resident, when nothing else was), so
that the other corpus cannot join it: every switch must evict, and
every eviction drops only the evicted segment's cached references, never
a buffer an in-flight batch still holds.  The headroom must stay below
the small corpus's pack bytes, or a switch evicts nothing and proves
nothing; the line reports both.

Prints one JSON line: ``ok``, ``problems``, ``budget_gb``,
``evictions``, ``transitions`` (per step: docs, plans served, exact spot
checks, seconds, resident GB and bytes, evictions so far, the
segment's pack bytes) and the card.  Exits 0 when ok, 2 when a check
failed, 1 without the device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

from fugu_tpu_torch.bench import log

#: exact-order spot checks against the oracle a step
SPOT_CHECKS = 8


def fresh(seg):
    """``seg``'s host arrays as a new segment with nothing cached on a
    device, so that its packs are this drill's alone."""
    return dataclasses.replace(seg, _device_pack=None)


def pack_bytes(seg) -> int:
    """Bytes the residency books hold for ``seg``'s packs."""
    from fugu_tpu_torch.ops import residency

    with residency._lock:
        return sum(e.nbytes for k, e in residency._entries.items()
                   if len(k) > 1 and k[1] == id(seg))


def drill(segs: dict, order, device, headroom_bytes: int,
          n_plans: int = 48) -> dict:
    """The drill over ``segs`` (name -> segment) in ``order`` (names,
    one step each); returns the JSON line's dict.  The caller's
    ``FUGU_DEVICE_MEM_BUDGET`` is restored afterwards."""
    import torch

    from fugu_tpu_torch.bench import make_query_mix
    from fugu_tpu_torch.ops import oracle, residency
    from fugu_tpu_torch.ops.batch_scorer import batch_search

    t0 = time.time()
    stats, mixes = {}, {}
    for name, seg in segs.items():
        stats[name] = oracle.IndexStats([seg])
        # device-path plans only: the drill moves packs, not phrases
        mix = [m for m in make_query_mix(seg) if not m[1].host_only]
        mixes[name] = mix[:n_plans]
        log(f"{name}: {seg.doc_count} docs, {seg.n_entries} postings, "
            f"{len(mixes[name])} plans")

    saved = os.environ.get("FUGU_DEVICE_MEM_BUDGET")
    transitions, problems = [], []
    prev_evictions = None
    resident_before = residency.stats()["resident_bytes"]
    try:
        for step, name in enumerate(order):
            seg = segs[name]
            plans = [p for _c, p, _l in mixes[name]]
            lims = [lim for _c, _p, lim in mixes[name]]
            t1 = time.time()
            res = batch_search(seg, plans, stats[name], lims, device)
            if device.type == "cuda":
                torch.cuda.synchronize()
            dt = time.time() - t1
            st = residency.stats()
            ok = 0
            for j in range(0, len(plans), max(len(plans) // SPOT_CHECKS, 1)):
                if res[j] is None:
                    continue
                want = [(np.float32(h.score), h.doc) for h in oracle.search(
                    [seg], plans[j], lims[j], stats[name])]
                got = [(np.float32(s), d) for s, d in res[j]]
                if got != want:
                    problems.append(f"step {step}: plan {j} differs from "
                                    f"the oracle")
                    continue
                ok += 1
            served = sum(r is not None for r in res)
            if served == 0:
                problems.append(f"step {step}: served 0 of {len(plans)}")
            if ok == 0:
                problems.append(f"step {step}: zero spot checks ran")
            if step == 0:
                # just above this corpus's packs: the next one cannot join
                # them (nor can packs resident before the drill, which
                # go first), so each switch below must evict and upload
                budget = pack_bytes(seg) + headroom_bytes
                os.environ["FUGU_DEVICE_MEM_BUDGET"] = str(budget)
                log(f"budget pinned to {budget / 2**30:.2f} GB")
            if prev_evictions is not None and (
                    st["evictions"] <= prev_evictions):
                problems.append(
                    f"step {step}: no eviction on namespace switch "
                    f"({st['evictions']} <= {prev_evictions})")
            prev_evictions = st["evictions"]
            transitions.append({
                "ns_docs": seg.doc_count, "served": served,
                "of": len(plans), "spot_exact": ok, "secs": dt,
                "resident_gb": st["resident_bytes"] / 2**30,
                "resident_bytes": st["resident_bytes"],
                "pack_bytes": pack_bytes(seg),
                "by_kind": st["by_kind"], "evictions": st["evictions"],
            })
            log(f"step {step} ({name}): {transitions[-1]}")
        st = residency.stats()
    finally:
        if saved is None:
            os.environ.pop("FUGU_DEVICE_MEM_BUDGET", None)
        else:
            os.environ["FUGU_DEVICE_MEM_BUDGET"] = saved
    smallest = min(t["pack_bytes"] for t in transitions)
    if headroom_bytes >= smallest:
        problems.append(f"headroom {headroom_bytes} bytes is not below the "
                        f"smallest corpus's packs ({smallest} bytes)")
    return {
        "ok": not problems, "problems": problems,
        "budget_gb": (st["budget_bytes"] or 0) / 2**30,
        "budget_bytes": st["budget_bytes"],
        "headroom_bytes": headroom_bytes,
        "resident_before_bytes": resident_before,
        "evictions": st["evictions"], "transitions": transitions,
        "total_secs": time.time() - t0,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--big", type=int, default=16_000_000)
    ap.add_argument("--small", type=int, default=1_000_000)
    ap.add_argument("--headroom-mb", type=float, default=200.0)
    ap.add_argument("--device", default="cuda")
    opts = ap.parse_args(argv)
    from fugu_tpu_torch.bench import build_corpus, card_line
    from fugu_tpu_torch.device import resolve

    try:
        device = resolve(opts.device)
    except RuntimeError as e:
        print(json.dumps({"ok": False, "error": str(e)}), flush=True)
        return 1
    if device.type == "cuda":
        from fugu_tpu_torch import cuda_build

        cuda_build.load_all()
    segs = {name: build_corpus(n)[0]
            for name, n in (("big", opts.big), ("small", opts.small))}
    out = drill(segs, ("big", "small", "big"), device,
                int(opts.headroom_mb * 2**20))
    out["card"] = card_line() if device.type == "cuda" else "cpu"
    print(json.dumps(out), flush=True)
    return 0 if out["ok"] else 2


if __name__ == "__main__":
    sys.exit(main())
