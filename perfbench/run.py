"""One run of one cell of the benchmark of ``fugu_tpu_torch``:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (``BENCHMARK.json``) names a configuration
(``perfbench/configs/``) and a traffic mix (``perfbench/traffic/``).
From the seed the run draws the corpus and the query strings (data
generation, kept out of ``setup_s``); then the system's set-up: the
kernels loaded, the corpus handed to the port (one segment built by its
``SegmentBuilder`` and opened as a namespace, or records upserted
through its writer), the port's HTTP app served in process, and one warm
pass of the mix's distinct queries.  The load client (a process of its
own, ``perfbench/client.py``) then drives the window over HTTP.  After
the window the served answers are judged against the plain reference
(``perfbench/reference/``), and the last line of standard output is one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``, each
compared number beside its limit.

Without a CUDA device the run exits 2 and prints no result; if a module
of JAX or of the JAX package is loaded once the window has closed, it
exits 3 and prints no result.
"""

from __future__ import annotations

import os
import time

T_START = time.perf_counter()

#: the cores the run may use; run as a program on four or more, it keeps
#: the last two for the load client and pins itself (and every thread it
#: starts after this line, the server's and torch's) to the rest, so that
#: the client's turn-around and the server never take each other's cores
CORES = sorted(os.sched_getaffinity(0))
CLIENT_CORES = None
if __name__ == "__main__" and len(CORES) >= 4:
    CLIENT_CORES = CORES[-2:]
    os.sched_setaffinity(0, CORES[:-2])

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

from perfbench import check, manifest, serve, spans, workload  # noqa: E402
from perfbench.corpus import Corpus, draw_corpus, facets_of, rng_for  # noqa: E402
from perfbench.costs import COSTS, bound_seconds  # noqa: E402
from perfbench.reference.bm25 import Index, Scorer  # noqa: E402

#: top-level module names that may not be loaded once the window closed
FORBIDDEN = ("jax", "jaxlib", "flax", "fugu_tpu")
STAGES = ("fugu_search_queue_wait_seconds", "fugu_search_exec_wait_seconds",
          "fugu_search_engine_seconds", "fugu_search_serialize_seconds",
          "fugu_search_seconds")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def p95(values):
    """Nearest-rank 95th percentile (a failed request counts as inf)."""
    if not values:
        return None
    v = sorted(values)
    return v[max(math.ceil(0.95 * len(v)) - 1, 0)]


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def use_cache_dirs() -> None:
    """Kernel and build caches at fixed paths inside the checkout, so that
    only a checkout's first run builds (the port builds its own kernels
    into ``fugu_tpu_torch/_build/``)."""
    cache = ROOT / "perfbench" / ".cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")


# -- the system's set-up ------------------------------------------------------

def open_static(data: Path, corp: Corpus, texts, device):
    """One segment of the corpus, built by the port's ``SegmentBuilder``,
    saved as the default namespace's docs index and opened."""
    from fugu_tpu_torch.config import ServerConfig
    from fugu_tpu_torch.engine.manager import DatasetManager
    from fugu_tpu_torch.index.manifest import Manifest, save_segment
    from fugu_tpu_torch.index.schema import DOCS_SCHEMA
    from fugu_tpu_torch.index.segment import SegmentBuilder

    b = SegmentBuilder(DOCS_SCHEMA)
    for i, text in enumerate(texts):
        b.add_document({"text": [text]},
                       facets=facets_of(corp.sources[i]),
                       stored={"id": f"d{i}"})
    seg = b.build()
    del b
    seg.segment_id = "perfbench"
    docs = data / "default" / "docs"
    docs.mkdir(parents=True)
    save_segment(seg, docs)
    Manifest(docs).commit([seg])
    del seg
    gc.collect()
    return DatasetManager(ServerConfig.with_defaults(str(data), "default"),
                          device=device)


def open_live(data: Path, corp: Corpus, texts, device, batch: int):
    """The corpus upserted through the port's writer in batches of
    ``batch`` records (background compaction, the default), then
    compaction drained so that every run starts from the same state."""
    from fugu_tpu_torch.config import ServerConfig
    from fugu_tpu_torch.engine.manager import DatasetManager
    from fugu_tpu_torch.records import ObjectRecord

    mgr = DatasetManager(ServerConfig.with_defaults(str(data), "default"),
                         device=device)
    ds = mgr.get_or_create_dataset("default")
    for lo in range(0, corp.n_docs, batch):
        hi = min(lo + batch, corp.n_docs)
        ds.upsert([ObjectRecord(id=f"d{i}", text=texts[i],
                                facets=facets_of(corp.sources[i]))
                   for i in range(lo, hi)])
    if not ds.wait_compaction(600):
        raise serve.LoadError("compaction did not drain after the ingest")
    return mgr


# -- what the window did ------------------------------------------------------

def summarize(res: dict, seconds: float) -> dict:
    """The end-to-end numbers of the window from the client's record."""
    searches, writes = res["searches"], res["writes"]
    lat = [(t1 - t0) * 1e3 if st == 200 else math.inf
           for _qi, t0, t1, st, _h in searches]
    ok = sum(1 for _qi, _t0, t1, st, _h in searches
             if st == 200 and t1 <= seconds)
    out = {"searches": len(searches), "searches_ok": ok,
           "search_qps": ok / seconds, "search_p95_ms": p95(lat)}
    if writes:
        wlat = [(t1 - t0) * 1e3 if st == 200 else math.inf
                for _w, _b, t0, t1, st in writes]
        out["write_p95_ms"] = p95(wlat)
        out["writes"] = len(writes)
    return out


def live_state(seed: int, corp: Corpus, res: dict, mix: dict, gen: dict):
    """The docs the namespace must hold after the window: the initial
    corpus with every acknowledged upsert and delete applied, as
    {id: (passages, doc)}; and the ids deleted, {id: ack time}."""
    live = {f"d{i}": (corp, i) for i in range(corp.n_docs)}
    n_w = mix["writers"]
    acked = [0] * n_w
    for w, b, _t0, _t1, st in res["writes"]:
        if st == 200:
            acked[w] = max(acked[w], b + 1)
    dels = {}
    for w, b, doc_id, _t0, t1, st in res["deletes"]:
        if st == 200:
            dels.setdefault((w, b), []).append((doc_id, t1))
    deleted = {}
    for w in range(n_w):
        plan = workload.writer_plan(seed, w, n_w, corp.n_docs, mix, gen,
                                    acked[w])
        for b, batch in enumerate(plan):
            for j, doc_id in enumerate(batch.ids):
                live[doc_id] = (batch.passages, j)
            done = dels.get((w, b), [])
            if [d for d, _ in done] != batch.deletes[:len(done)]:
                raise serve.LoadError(f"writer {w} batch {b}: deletes out "
                                      f"of plan")
            for doc_id, t1 in done:
                live.pop(doc_id)
                deleted[doc_id] = t1
    return live, deleted


def assemble(live: dict):
    """(ids, words, starts, sources) of the docs in ``live``."""
    ids = list(live)
    lens = np.array([p.starts[j + 1] - p.starts[j] for p, j in live.values()],
                    dtype=np.int64)
    starts = np.zeros(len(ids) + 1, dtype=np.int64)
    np.cumsum(lens, out=starts[1:])
    words = np.empty(int(starts[-1]), dtype=np.int32)
    srcs = np.empty(len(ids), dtype=np.int64)
    for i, (p, j) in enumerate(live.values()):
        words[starts[i]:starts[i + 1]] = p.words[p.starts[j]:p.starts[j + 1]]
        srcs[i] = p.sources[j]
    return ids, words, starts, srcs


def doc_text(p: Corpus, j: int) -> str:
    return p.texts(j, j + 1)[0]


# -- the run ------------------------------------------------------------------

def run(cell: dict, seed: int, seconds: float, trace: bool,
        device: str) -> dict:
    """One run of ``cell``; returns the result line (a dict) and logs
    progress on standard error."""
    cfg, mix = cell["config"], cell["mix"]
    gen = cfg["generator"]
    name = cell["entry"]["name"]
    k = int(mix["per_page"])
    work = Path(tempfile.mkdtemp(prefix="perfbench-"))
    server = mgr = None
    try:
        t0 = time.perf_counter()
        corp = draw_corpus(seed, int(cfg["docs"]), gen)
        texts = corp.texts()
        queries = workload.make_queries(seed, mix, corp, gen)
        bodies = [workload.search_body(q, f, k) for q, f in queries]
        gen_s = time.perf_counter() - t0
        log(f"{name}: seed {seed}, {corp.n_docs} docs, {len(corp.words)} "
            f"words, {len(queries)} distinct queries drawn in {gen_s:.1f} s")

        import torch

        dev = torch.device(device)
        cuda = dev.type == "cuda"
        if cuda:
            from fugu_tpu_torch import cuda_build

            cuda_build.load_all()
        data = work / "data"
        if cfg["build"] == "segment":
            mgr = open_static(data, corp, texts, dev)
        else:
            mgr = open_live(data, corp, texts, dev, int(cfg["setup_batch"]))
        del texts
        server = serve.LiveServer(mgr)
        clients = int(mix["search_clients"])
        serve.drive(work / "warm", {"base": server.base,
                                    "search_clients": clients,
                                    "bodies": bodies, "total": len(bodies),
                                    "parse": [], "cores": CLIENT_CORES})
        setup_s = time.perf_counter() - T_START - gen_s
        log(f"{name}: set-up {setup_s:.2f} s (data generation {gen_s:.2f} s "
            f"apart)")

        sample = sorted(rng_for(seed, workload.SAMPLE).choice(
            len(queries), size=min(int(mix["check_queries"]), len(queries)),
            replace=False).tolist())
        # the live cell's checks read every answer; the read cell's the
        # sampled queries'
        job = {"base": server.base, "seconds": seconds,
               "search_clients": clients, "bodies": bodies,
               "parse": None if mix.get("writers") else sample,
               "cores": CLIENT_CORES}
        if mix.get("writers"):
            job["writer"] = {"seed": seed, "writers": mix["writers"],
                             "n_initial": corp.n_docs, "mix": mix, "gen": gen,
                             "batches": mix["writer_batches"]}
        tracer = spans.Tracer() if trace else None
        window = {}
        prof_box = []

        @contextlib.contextmanager
        def during():
            prof = None
            if trace and cuda:
                from torch.profiler import ProfilerActivity, profile

                prof = profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA])
                prof.__enter__()
                prof_box.append(prof)
            from torch.profiler import record_function

            ann = record_function("perfbench.window")
            ann.__enter__()
            if tracer is not None:
                tracer.recording = True
            window["t0"] = time.perf_counter()
            try:
                yield
            finally:
                window["t1"] = time.perf_counter()
                if tracer is not None:
                    tracer.recording = False
                ann.__exit__(None, None, None)
                if prof is not None:
                    torch.cuda.synchronize()
                    prof.__exit__(None, None, None)

        before = serve.scrape(server.base)
        with (tracer if tracer is not None else contextlib.nullcontext()):
            res = serve.drive(work / "window", job, during)
        after = serve.scrape(server.base)
        mem_peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
        found = forbidden_modules()
        if found:
            log(f"modules loaded that the run may not load: {found}")
            raise SystemExit(3)
        e2e = summarize(res, seconds)
        thirds = [sum(1 for _qi, _t0, t1, st, _h in res["searches"]
                      if st == 200 and j * seconds / 3 < t1
                      <= (j + 1) * seconds / 3) / (seconds / 3)
                  for j in range(3)]
        log(f"{name}: searches answered a second in each third of the "
            f"window {[round(x, 1) for x in thirds]}; server cores "
            f"{sorted(os.sched_getaffinity(0))}, client cores {CLIENT_CORES}")
        log(f"{name}: {e2e['searches']} searches sent in the window, "
            f"{e2e['searches_ok']} answered 200 within it; search_p95_ms "
            f"over {e2e['searches']} samples; the load client used "
            f"{res['cpu_s']:.2f} CPU s")

        checks = {}
        failed = sum(1 for s in res["searches"] if s[3] != 200)
        failed += sum(1 for w in res["writes"] if w[4] != 200)
        failed += sum(1 for d in res["deletes"] if d[5] != 200)
        attempted = (len(res["searches"]) + len(res["writes"])
                     + len(res["deletes"]))
        checks["failed_requests"] = (failed, 0)

        per_layer_rec = None
        if trace:
            per_layer_rec = layer_record(res, seconds, before, after, tracer,
                                         window, prof_box, work, e2e)

        if mix.get("writers"):
            ids, words, starts, srcs, merged, answers, extra = after_live(
                seed, corp, res, mix, gen, mgr, server, work, bodies, sample,
                clients)
            checks.update(extra)
            e2e["ingest_docs_per_s"] = sum(
                mix["write_batch"] for w in res["writes"]
                if w[4] == 200 and w[3] <= seconds) / seconds
        else:
            ids = [f"d{i}" for i in range(corp.n_docs)]
            words, starts, srcs = corp.words, corp.starts, corp.sources
            merged = None
            keep = set(sample)
            answers = [(qi, hits) for qi, _t0, _t1, st, hits in res["searches"]
                       if st == 200 and qi in keep]
        server.stop()
        server = None
        mgr.close()
        mgr = None
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

        t_ref = time.perf_counter()
        index = Index(words, starts, srcs, gen["vocab"], merged)
        t_index = time.perf_counter() - t_ref
        scorer = Scorer(index, "float32", dev)
        reference = {qi: scorer.score(*queries[qi]) for qi in sample}
        doc_index = {d: i for i, d in enumerate(ids)}
        gaps = check.gaps(answers, reference, doc_index, k)
        checks["score_gap"] = (max(gaps) if gaps else check.WRONG,
                               cfg["limits"]["score_gap"])
        log(f"{name}: {len(answers)} answers of {len(sample)} sampled "
            f"queries compared with the reference in "
            f"{time.perf_counter() - t_ref:.1f} s (its index {t_index:.1f} s)")

        correct = all(v <= lim for v, lim in checks.values())

        metrics = {}
        if trace:
            for m in cell["per_layer"]:
                value = manifest.reader(m["name"])(per_layer_rec)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        else:
            e2e["setup_s"] = setup_s
            for m in cell["end_to_end"]:
                if e2e.get(m["name"]) is not None:
                    metrics[m["name"]] = {"value": e2e[m["name"]],
                                          "unit": m["unit"]}
        device_info = {"platform": "gpu" if cuda else "cpu",
                       "kind": (torch.cuda.get_device_name(dev) if cuda
                                else "cpu"),
                       "count": int(cell["entry"]["chips"]) if cuda else 0,
                       "memory_peak_bytes": mem_peak}
        line = {"correct": bool(correct), "attempted": attempted,
                "failed": failed, "metrics": metrics, "device": device_info}
        if trace and per_layer_rec.get("device"):
            dv = per_layer_rec["device"]
            device_info["busy_s"] = dv["busy_s"]
            device_info["window_s"] = dv["window_s"]
            line["breakdown"] = per_layer_rec["breakdown"]
        for key, (value, lim) in checks.items():
            log(f"check {key} {value!r} limit {lim!r}")
        line["checks"] = {key: {"value": v, "limit": lim}
                          for key, (v, lim) in checks.items()}
        return line
    finally:
        if server is not None:
            server.stop()
        if mgr is not None:
            mgr.close()
        shutil.rmtree(work, ignore_errors=True)


def after_live(seed, corp, res, mix, gen, mgr, server, work, bodies, sample,
               clients):
    """The live cell's checks once the window has closed: the ids that
    in-window answers served after their delete was acknowledged and the
    reads of acknowledged writes in the window; then, compaction
    drained, a seeded sample of ids read back by id; then the namespace
    force-compacted, ``final_batch`` records upserted and the sampled
    queries searched at the cell's concurrency.  Returns the reference's
    docs, those answers and the checks."""
    live, deleted = live_state(seed, corp, res, mix, gen)
    seen_deleted = sum(
        1 for _qi, t0, _t1, st, hits in res["searches"] if st == 200
        for doc_id, _s in hits
        if doc_id in deleted and t0 > deleted[doc_id])
    lost = sum(1 for p in res["probes"] if not p[3])
    ds = mgr.get_dataset("default")
    if not ds.wait_compaction(600):
        raise serve.LoadError("compaction did not drain after the window")
    rng = rng_for(seed, workload.SAMPLE + 1)
    written = [d for d in live if not d.startswith("d")] + [
        d for d in live if d.startswith("d") and live[d][0] is not corp]
    probe_live = list(rng.choice(written, size=min(256, len(written)),
                                 replace=False)) if written else []
    gone = sorted(deleted)
    probe_gone = list(rng.choice(gone, size=min(64, len(gone)),
                                 replace=False)) if gone else []
    for doc_id in probe_live:
        _st, text = serve.http("GET", f"{server.base}/objects/{doc_id}")
        if json.loads(text).get("text") != [doc_text(*live[doc_id])]:
            lost += 1
    for doc_id in probe_gone:
        _st, text = serve.http("GET", f"{server.base}/objects/{doc_id}")
        if "id" in json.loads(text):
            seen_deleted += 1
    # every doc now goes through one merge, so that the index's token
    # count is the reference's whatever merges ran in the window
    st, _ = serve.http("POST", f"{server.base}/compact/default")
    if st != 200:
        raise serve.LoadError(f"/compact answered {st}")
    last = workload.final_batch(seed, int(mix["write_batch"]), gen)
    texts = last.passages.texts()
    st, _ = serve.http("POST", f"{server.base}/batch/upsert", {"objects": [
        workload.record_json(d, t, s)
        for d, t, s in zip(last.ids, texts, last.passages.sources)]})
    if st != 200:
        raise serve.LoadError(f"the last upsert answered {st}")
    for j, doc_id in enumerate(last.ids):
        live[doc_id] = (last.passages, j)
    got = serve.drive(work / "check", {
        "base": server.base, "search_clients": clients,
        "bodies": [bodies[qi] for qi in sample], "total": len(sample),
        "cores": CLIENT_CORES})
    answers = [(sample[qi], hits) for qi, _t0, _t1, st, hits in got["searches"]
               if st == 200]
    checks = {"lost_writes": (lost, 0), "deleted_served": (seen_deleted, 0),
              "failed_check_searches": (len(sample) - len(answers), 0)}
    log(f"live: {len(written)} ids written in the window, "
        f"{len(deleted)} deleted; read back {len(probe_live)} written and "
        f"{len(probe_gone)} deleted ids")
    ids, words, starts, srcs = assemble(live)
    fresh = set(last.ids)
    merged = np.array([d not in fresh for d in ids])
    return ids, words, starts, srcs, merged, answers, checks


def layer_record(res, seconds, before, after, tracer, window, prof_box, work,
                 e2e) -> dict:
    """What the per-layer readers read: the window's /metrics deltas, the
    harness spans and counters, the kernel calls' bounds and device
    times, and the device's busy time from the profiler's trace."""
    def delta(key):
        return after.get(key, 0.0) - before.get(key, 0.0)

    lo, hi = window["t0"], window["t1"]
    rec = {
        "window_s": seconds, "traced_s": hi - lo,
        "searches_ok": e2e["searches_ok"], "searches": e2e["searches"],
        "stages": {s: (delta(s + "_sum"), delta(s + "_count"))
                   for s in STAGES},
        "spans": {s: tracer.span_seconds(s, lo, hi) for s in spans.SPANS},
        "segments": list(tracer.segments),
        "kernel_calls": {k: len(v) for k, v in tracer.kept.items()},
        "device": None, "kernels": {}, "breakdown": None,
    }
    if prof_box:
        raw = work / "trace.json"
        prof_box[0].export_chrome_trace(str(raw))
        events = json.loads(raw.read_text())["traceEvents"]
        raw.unlink()
        win_us, busy_us, merged, (a, b) = spans.window_busy(
            events, "perfbench.window")
        rec["device"] = {"busy_s": busy_us / 1e6, "window_s": win_us / 1e6}
        device_ops, idle_gaps = spans.breakdown(
            events, merged, a, b, tracer.spans, a - lo * 1e6)
        rec["breakdown"] = {"device_ops": device_ops, "idle_gaps": idle_gaps}
        for name, calls in tracer.kept.items():
            if calls:
                rec["kernels"][name] = {
                    "calls": len(calls),
                    "bound_s": sum(bound_seconds(*COSTS[name](args))
                                   for args in calls),
                    "device_s": spans.kernel_seconds(
                        events, spans.KERNEL_NAMES[name], a, b)}
    tracer.kept = {k: [] for k in tracer.kept}
    log("layers: " + json.dumps({k: rec[k] for k in (
        "traced_s", "stages", "spans", "kernel_calls", "device", "kernels")}))
    return rec


def main(argv=None, device: str = None) -> int:
    """``device`` set (``"cpu"`` in tests) skips the look for a card."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    opts = ap.parse_args(argv)
    use_cache_dirs()
    cell = manifest.cell(ROOT, opts.workload)
    if device is None:
        import torch

        want = int(cell["entry"]["chips"])
        if not torch.cuda.is_available() or torch.cuda.device_count() < want:
            log(f"no CUDA device, or fewer than the {want} the cell asks for")
            return 2
        device = "cuda"
    try:
        line = run(cell, opts.seed, opts.seconds, bool(opts.trace), device)
    except SystemExit as e:
        return int(e.code)
    found = forbidden_modules()
    if found:
        log(f"modules loaded that the run may not load: {found}")
        return 3
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
