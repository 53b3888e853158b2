"""The device phrase path against the host matcher and the phrase stream
on bench's corpus, on the card.

    python3 -m fugu_tpu_torch.tools.device_phrase_ab [--docs 1000000]
        [--device cuda] [--reps 3] [--no-stream]

Run from the root of a checkout: the phrase batch is ``chip_smoke.py``'s.
On bench's corpus of ``--docs`` docs (``fugu_tpu_torch.bench``'s cached
segment, built first where the cache lacks it) two plan sets run: the
phrase class of bench's 256-query mix (``mix_phrases``) and the smoke's
256-phrase batch (``batch``: 192 two-term, 32 three- to four-term and 32
sloppy phrases, df-weighted), all at limit 10.  Per set (:func:`compare`):

- the positions' first upload (seconds and bytes), then every plan
  through ``ops/device_phrase`` once: the plans staged, and the others
  by reason (ineligible, pad ladder, answered in begin for an absent
  term, the window's tail, the overflow flag); every result it returns
  must equal the host matcher's (``search_blockmax``) bit for bit;
- warm times in turns (device phrase, host matcher, stream), ``--reps``
  times: ``device_phrase_ms`` (begin + collect of the whole set: what
  it stages), ``device_phrase_route_ms`` (the same plus the host matcher
  for what it leaves), ``host_ms`` (the host matcher on every plan),
  ``stream_ms`` (``batch_phrase_search`` plus the host matcher for what
  it declines; left out with ``--no-stream``, where the token stream's
  host build does not fit);
- one ``device_phrase_begin`` under ``torch.profiler``: its wall time,
  the device's busy time (the union of its kernel and copy intervals),
  and the bound of that work: the bytes the staged plans must read
  (each term's posting window, each common doc's offsets, position run,
  fieldnorm id and tombstone flag, the outputs) over 3.35 TB/s.

Prints one JSON line with the card, the host's peak memory and both
sets; exits 0 when every returned result was exact, 2 otherwise, 1
without the device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

from fugu_tpu_torch.bench import log

REPO = Path(__file__).resolve().parent.parent.parent
#: the card's memory rate for the bound (the H100 SXM data sheet)
HBM_BYTES_S = 3.35e12


class Mismatch(Exception):
    """A result of the device phrase path or the stream differs from
    the host matcher's."""


def bound_bytes(seg, plans, handle) -> int:
    """Bytes the staged plans of ``handle`` must move: per plan each
    term's posting window (df docs), per common live doc and term its
    two offsets and its position run, per common doc its fieldnorm id
    and tombstone flag, and the plan's output (score, doc per slot and
    the flag); int32 each."""
    from fugu_tpu_torch.ops import buckets
    from fugu_tpu_torch.ops import device_phrase as dp

    total = 0
    for qi, _where in handle.staged:
        pc = dp._phrase_clause(plans[qi])
        infos = [seg.term_info(pc.field, t) for t in pc.terms]
        wins = [seg.e_doc[i.start: i.start + i.doc_freq] for i in infos]
        total += 4 * sum(i.doc_freq for i in infos)
        common = wins[0]
        for w in wins[1:]:
            common = np.intersect1d(common, w, assume_unique=True)
        total += 8 * len(common)
        if len(pc.terms) > 1:
            common = common[~seg.tombstones[common]]
            offs = seg.pos_offsets[pc.field]
            base = seg.field_entry_base[pc.field]
            for i, w in zip(infos, wins):
                e = i.start + np.searchsorted(w, common) - base
                total += 4 * int((offs[e + 1] - offs[e]).sum()) + 8 * len(e)
        total += 8 * buckets.k_extract(handle.limit) + 4
    return total


def profiled_begin(begin):
    """(wall ms, device busy ms) of one ``begin()`` and the device work
    it queued, from a ``torch.profiler`` trace (``mix_timing.busy_ms``:
    the union of the device's kernel, copy and set intervals)."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from mix_timing import busy_ms

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("device_phrase_begin"):
            begin()
            torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        trace = json.loads(path.read_text())
    return busy_ms(trace, "device_phrase_begin")


def _f32(res):
    return None if res is None else [(np.float32(s), int(d)) for s, d in res]


def compare(seg, stats, plans, device, reps: int = 3, stream: bool = True,
            limit: int = 10) -> dict:
    """The readings of one plan set (see the module docstring); raises
    :class:`Mismatch` when a result differs from the host matcher's."""
    import torch

    from fugu_tpu_torch.ops import device_phrase as dp
    from fugu_tpu_torch.ops.blockmax import search_blockmax
    from fugu_tpu_torch.ops.phrase_stream import batch_phrase_search

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    out = {"plans": len(plans)}
    fields = {pc.field for pc in map(dp._phrase_clause, plans) if pc}
    for field in sorted(fields):
        if field not in (getattr(seg, "_device_pos", None) or {}):
            t0 = time.perf_counter()
            dp._device_positions(seg, field, device)
            sync()
            out["upload_s"] = out.get("upload_s", 0.0) + (
                time.perf_counter() - t0)
    out["positions_bytes"] = sum(
        t.numel() * t.element_size()
        for pos in (getattr(seg, "_device_pos", None) or {}).values()
        if pos is not None for t in pos)
    host = [search_blockmax(seg, p, stats, limit) for p in plans]
    handle = dp.device_phrase_begin(seg, plans, stats, limit, device)
    fetched = dp.device_phrase_fetch(handle)
    got = dp.device_phrase_collect(handle)
    reasons = {}
    for how in handle.outcome:
        reasons[how] = reasons.get(how, 0) + 1
    reasons["overflow"] = sum(o for *_x, o in fetched)
    out["outcome"] = reasons
    out["staged"] = len(handle.staged)
    out["answered"] = sum(r is not None for r in got)
    out["exact"] = sum(g is not None and _f32(g) == _f32(h)
                       for g, h in zip(got, host))
    if out["exact"] != out["answered"]:
        raise Mismatch(f"device phrase: {out['exact']} of {out['answered']} "
                       f"results equal the host matcher's")

    def dp_run():
        return dp.device_phrase_batch(seg, plans, stats, limit, device)

    def route_run():
        res = dp_run()
        return [r if r is not None else search_blockmax(seg, p, stats, limit)
                for p, r in zip(plans, res)]

    def host_run():
        return [search_blockmax(seg, p, stats, limit) for p in plans]

    def stream_run():
        res = batch_phrase_search(seg, plans, stats, [limit] * len(plans),
                                  device)
        return [r if r is not None else search_blockmax(seg, p, stats, limit)
                for p, r in zip(plans, res)]

    runs = {"device_phrase_ms": dp_run, "device_phrase_route_ms": route_run,
            "host_ms": host_run}
    if stream:
        runs["stream_ms"] = stream_run
        stream_run()  # the token stream's build and upload
    times = {name: [] for name in runs}
    for _ in range(reps):
        for name, fn in runs.items():
            t0 = time.perf_counter()
            res = fn()
            sync()
            times[name].append((time.perf_counter() - t0) * 1e3)
            if (name != "device_phrase_ms"
                    and [_f32(r) for r in res] != [_f32(h) for h in host]):
                raise Mismatch(f"{name}: a result differs from the host "
                               f"matcher's")
    for name, ts in times.items():
        out[name] = ts
        out[name.replace("_ms", "_median_ms")] = sorted(ts)[len(ts) // 2]
    if device.type == "cuda" and handle.staged:
        out["begin_wall_ms"], out["begin_busy_ms"] = profiled_begin(
            lambda: dp.device_phrase_begin(seg, plans, stats, limit, device))
        nbytes = bound_bytes(seg, plans, handle)
        out["bound_bytes"] = nbytes
        out["bound_ms"] = nbytes / HBM_BYTES_S * 1e3
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--docs", type=int, default=1_000_000)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--no-stream", action="store_true")
    opts = ap.parse_args(argv)
    from fugu_tpu_torch import bench
    from fugu_tpu_torch.device import resolve
    from fugu_tpu_torch.ops import oracle

    try:
        device = resolve(opts.device)
    except RuntimeError as e:
        print(json.dumps({"ok": False, "error": str(e)}), flush=True)
        return 1
    sys.path.insert(0, str(REPO))
    import chip_smoke

    seg, t_build = bench.build_corpus(opts.docs)
    stats = oracle.IndexStats([seg])
    sets = {
        "mix_phrases": [p for cls, p, _lim in bench.make_query_mix(seg)
                        if cls == "phrase"],
        "batch": chip_smoke.make_phrase_batch(seg),
    }
    line = {"ok": True, "docs": seg.doc_count, "build_s": t_build,
            "card": bench.card_line() if device.type == "cuda" else "cpu"}
    for name, plans in sets.items():
        try:
            line[name] = compare(seg, stats, plans, device, opts.reps,
                                 stream=not opts.no_stream)
        except Mismatch as e:
            line.update(ok=False, error=f"{name}: {e}")
            break
        log(f"{name}: {line[name]}")
    line["host_gb"] = bench.host_rss_gb()
    print(json.dumps(line), flush=True)
    return 0 if line["ok"] else 2


if __name__ == "__main__":
    sys.exit(main())
