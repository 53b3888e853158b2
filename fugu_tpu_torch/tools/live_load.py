"""Live-stack load: concurrent search requests over real HTTP against a
mounted bench namespace, the counterpart of the repo's
``tools/live_load.py``.

    python3 -m fugu_tpu_torch.tools.live_load [--docs 1000000]
        [--concurrency 64,128] [--requests 2048] [--device cuda]

The cached bench segment of ``--docs`` docs (``fugu_tpu_torch.bench``,
built first where the cache lacks it) is mounted as a namespace's docs
index: its files linked beside a generation-1 manifest in a data
directory under ``.bench_cache/``.  A ``DatasetManager`` on the device
opens it and the port's app serves it in process, on a thread with its
own event loop.  Query strings over the bench vocabulary
(:func:`make_queries`, the reference tool's classes) are answered in
process first; those answers are what every HTTP response must equal.

Per concurrency level, closed-loop clients (a client process of their
own, ``--drive JOB``, one keep-alive connection each) send an untimed
pass, a timed pass and, on the card, a pass under ``torch.profiler``.
One JSON line a level: QPS, p50 and p99 latency, ``search_many`` calls
and mean queries a call, the engine's share of the wall, the mean of
each stage's histogram from ``/metrics`` (queue wait, executor wait,
engine, serialisation, request total), the kernels' launches, the plans
per route and the device's idle share.  Any response that is not 200
or differs from the in-process answer ends the run with exit code 2.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path
from types import SimpleNamespace

import numpy as np

#: the per-stage histograms of /metrics that a load level reports
STAGES = (
    "fugu_search_queue_wait_seconds", "fugu_search_exec_wait_seconds",
    "fugu_search_engine_seconds", "fugu_search_serialize_seconds",
    "fugu_search_seconds",
)
PER_PAGE = 10


class LoadError(RuntimeError):
    """A response, a client or the server failed a check."""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def http(method: str, url: str, body=None, timeout: float = 120.0):
    """(status, text) of one request."""
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(
        url, data=data, method=method,
        headers={"Content-Type": "application/json"} if data else {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def scrape(base: str) -> dict:
    """/metrics as {sample name with labels: value}."""
    status, text = http("GET", base + "/metrics")
    if status != 200:
        raise LoadError(f"/metrics answered {status}")
    out = {}
    for line in text.splitlines():
        name, _, value = line.rpartition(" ")
        if name:
            out[name] = float(value)
    return out


def served_hits(text: str):
    """[(id, float32 score)] of a search response body."""
    return [(r["id"], np.float32(r["score"]))
            for r in json.loads(text)["results"]]


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


def drive_main(job_path: Path) -> None:
    """The load client, a process of its own (``--drive JOB``):
    ``concurrency`` closed-loop clients, one keep-alive connection each,
    POST the job's bodies in turn to ``url`` until ``total`` requests
    are answered.  It prints READY once every connection is open, starts
    at a line on its standard input, prints DONE after the last answer,
    and writes each request's status and seconds, the loop's wall
    seconds and the first ``keep`` response bodies to the job's ``out``
    file."""
    import aiohttp

    job = json.loads(job_path.read_text())
    bodies = [json.dumps(b).encode() for b in job["bodies"]]
    total, keep = job["total"], job["keep"]
    statuses, seconds, texts = [0] * total, [0.0] * total, [None] * keep
    headers = {"Content-Type": "application/json"}

    async def run():
        nxt = 0
        conn = aiohttp.TCPConnector(limit=0)
        timeout = aiohttp.ClientTimeout(total=600)
        async with aiohttp.ClientSession(connector=conn,
                                         timeout=timeout) as pool:
            async def open_connection():
                async with pool.get(job["base"] + "/hi") as resp:
                    await resp.read()

            await asyncio.gather(
                *(open_connection() for _ in range(job["concurrency"])))
            print("READY", flush=True)
            await asyncio.get_running_loop().run_in_executor(
                None, sys.stdin.readline)

            async def client():
                nonlocal nxt
                while nxt < total:
                    i, nxt = nxt, nxt + 1
                    t0 = time.perf_counter()
                    async with pool.post(
                            job["url"], data=bodies[i % len(bodies)],
                            headers=headers) as resp:
                        text = await resp.text()
                    seconds[i] = time.perf_counter() - t0
                    statuses[i] = resp.status
                    if i < keep:
                        texts[i] = text

            t0 = time.perf_counter()
            await asyncio.gather(
                *(client() for _ in range(job["concurrency"])))
            return time.perf_counter() - t0

    wall = asyncio.run(run())
    Path(job["out"]).write_text(json.dumps({
        "wall_s": wall, "statuses": statuses, "seconds": seconds,
        "texts": texts}))
    print("DONE", flush=True)


def drive(work: Path, base: str, bodies, concurrency: int, total: int,
          keep: int, during=contextlib.nullcontext) -> dict:
    """Run the load client (:func:`drive_main`) and return what it wrote;
    its request loop runs inside ``during()``."""
    work.mkdir(parents=True, exist_ok=True)
    job, out = work / "job.json", work / "out.json"
    job.write_text(json.dumps({
        "base": base, "url": base + "/search/json", "bodies": bodies,
        "concurrency": concurrency, "total": total, "keep": keep,
        "out": str(out)}))
    root = str(Path(__file__).resolve().parents[2])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.Popen(
        [sys.executable, "-m", "fugu_tpu_torch.tools.live_load", "--drive",
         str(job)], stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        text=True, env=env)
    try:
        if proc.stdout.readline().strip() != "READY":
            raise LoadError("the load client did not start")
        with during():
            proc.stdin.write("GO\n")
            proc.stdin.flush()
            done = proc.stdout.readline().strip()
        if done != "DONE" or proc.wait(timeout=60) != 0:
            raise LoadError(f"the load client ended with {done!r}, code "
                            f"{proc.poll()}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return json.loads(out.read_text())


def check_responses(res: dict, expected, label: str) -> None:
    """Every request answered 200, and every kept body's hits equal
    ``expected`` of its query (ids, order and float32 scores)."""
    bad = [s for s in res["statuses"] if s != 200]
    if bad:
        raise LoadError(f"{label}: {len(bad)} of {len(res['statuses'])} "
                        f"responses were not 200 (first {bad[0]})")
    n_ok = sum(
        served_hits(text) == [(d, np.float32(s))
                              for d, s in expected[i % len(expected)]]
        for i, text in enumerate(res["texts"]))
    if n_ok != len(res["texts"]):
        raise LoadError(f"{label}: only {n_ok}/{len(res['texts'])} "
                        f"responses equal the expected hits")


class LiveServer:
    """The port's app over ``db`` on a thread with its own event loop."""

    def __init__(self, db):
        self.db = db
        self.port = free_port()
        self.base = f"http://127.0.0.1:{self.port}"
        self._loop = asyncio.new_event_loop()
        self._up = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        if not self._up.wait(60):
            raise LoadError("the in-process server did not start")

    def _run(self):
        from aiohttp import web

        from fugu_tpu_torch.server import create_app

        asyncio.set_event_loop(self._loop)

        async def boot():
            self._runner = web.AppRunner(create_app(self.db))
            await self._runner.setup()
            await web.TCPSite(self._runner, "127.0.0.1", self.port).start()
            self._up.set()

        self._loop.run_until_complete(boot())
        self._loop.run_forever()

    def stop(self):
        asyncio.run_coroutine_threadsafe(
            self._runner.cleanup(), self._loop).result(60)
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join(60)


def mount(docs_dir: Path, src_dir: Path, entries) -> None:
    """Mount segments saved in ``src_dir`` as the index in ``docs_dir``
    (a namespace's ``docs`` directory): each segment's files linked
    (``entries``: [(segment id, doc count)]) beside a generation-1
    manifest."""
    from fugu_tpu_torch.index.manifest import Manifest

    docs_dir = Path(docs_dir)
    docs_dir.mkdir(parents=True, exist_ok=True)
    for seg_id, _n in entries:
        for f in Path(src_dir).glob(f"seg-{seg_id}.*"):
            if not (docs_dir / f.name).exists():
                os.link(f, docs_dir / f.name)
    Manifest(docs_dir).commit([SimpleNamespace(segment_id=s, doc_count=n)
                               for s, n in entries])


def make_queries(n: int = 512, vocab_size: int = 30_000):
    """The reference tool's query strings over the bench vocabulary,
    [(query, filters)]: by turns three should, two ``+a +b``, one ``a b
    -c``, one quoted phrase and one boosted disjunction ``a^2 b c``, the
    terms drawn by rank from the generator's Zipf 1.07 (seed 11)."""
    from fugu_tpu_torch.bench import zipf_p

    rng = np.random.default_rng(11)
    p = zipf_p(vocab_size)

    def pick(k):
        return [f"t{i:05d}" for i in rng.choice(vocab_size, size=k,
                                                replace=False, p=p)]

    out = []
    for i in range(n):
        c = i % 8
        if c < 3:
            q = " ".join(pick(3))
        elif c < 5:
            a, b = pick(2)
            q = f"+{a} +{b}"
        elif c == 5:
            a, b, neg = pick(3)
            q = f"{a} {b} -{neg}"
        elif c == 6:
            a, b = pick(2)
            q = f'"{a} {b}"'
        else:
            a, b, cc = pick(3)
            q = f"{a}^2 {b} {cc}"
        out.append((q, []))
    return out


def search_body(query, filters, namespace: str) -> dict:
    return {"query": query, "filters": list(filters), "namespace": namespace,
            "page": {"page": 0, "per_page": PER_PAGE}}


def run_levels(mgr, ns: str, queries, expected, work: Path, card: str,
               device, levels=(64, 128), n_requests: int = 2048,
               n_profiled: int = 512) -> list:
    """Serve ``mgr`` in process and drive ``queries`` ([(query,
    filters)] on namespace ``ns``, whose in-process answers [(id,
    score)] are ``expected``) at each concurrency of ``levels``: an
    untimed pass, a timed pass whose every response must be 200 and
    equal ``expected``, and on the card a pass of ``n_profiled`` under
    ``torch.profiler``.  Returns one dict a level (see the module
    docstring); raises :class:`LoadError` at a failed check."""
    from fugu_tpu_torch.ops import batch_scorer, block_scorer

    docs = mgr.get_dataset(ns).docs()
    bodies = [search_body(q, f, ns) for q, f in queries]
    server = LiveServer(mgr)
    cuda = device.type == "cuda"
    lines = []
    try:
        for clients in levels:
            level = work / f"drive{clients}"
            drive(level, server.base, bodies, clients, n_requests, 0)
            before = scrape(server.base)
            block_scorer.launches = 0
            batch_scorer.launches = 0
            docs.routes.clear()
            res = drive(level, server.base, bodies, clients, n_requests,
                        n_requests)
            after = scrape(server.base)
            launches = {"block_scorer": block_scorer.launches,
                        "phase_a": batch_scorer.launches}
            routes = dict(docs.routes)
            check_responses(res, expected, f"served load, {clients} clients")

            def delta(name):
                return after.get(name, 0.0) - before.get(name, 0.0)

            stage_ms = {}
            for stage in STAGES:
                n = delta(f"{stage}_count")
                stage_ms[stage] = delta(f"{stage}_sum") / n * 1e3 if n else None
            batches = int(delta("fugu_search_engine_seconds_count"))
            line = {
                "phase": "served load", "card": card,
                "docs": sum(s.doc_count for s in docs.segments),
                "clients": clients, "requests": n_requests,
                "per_page": PER_PAGE, "failed": 0,
                "qps": n_requests / res["wall_s"], "wall_s": res["wall_s"],
                "p50_ms": float(np.percentile(res["seconds"], 50)) * 1e3,
                "p99_ms": float(np.percentile(res["seconds"], 99)) * 1e3,
                "batches": batches,
                "mean_batch": n_requests / batches if batches else None,
                "engine_share_of_wall": (
                    delta("fugu_search_engine_seconds_sum") / res["wall_s"]),
                "stage_mean_ms": stage_ms, "launches": launches,
                "routes": routes,
            }
            if cuda:
                line.update(profiled_level(server.base, bodies, clients,
                                           n_profiled, level))
                if min(launches.values()) <= 0:
                    raise LoadError(f"served load, {clients} clients: "
                                    f"launches {launches}")
            lines.append(line)
            if not batches or n_requests / batches <= 1:
                raise LoadError(f"served load, {clients} clients: {batches} "
                                f"batches for {n_requests} requests")
    finally:
        server.stop()
    return lines


def profiled_level(base, bodies, clients, n_profiled, level: Path) -> dict:
    """The device's idle share over one more pass at this level under
    the profiler (kept out of the timed pass)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        drive(level, base, bodies, clients, n_profiled, 0,
              during=lambda: record_function("served_level"))
        torch.cuda.synchronize()
    raw = level / "trace.json"
    prof.export_chrome_trace(str(raw))
    wall, busy = busy_ms(json.loads(raw.read_text()), "served_level")
    raw.unlink()
    return {"profiled_requests": n_profiled, "profiled_wall_ms": wall,
            "device_busy_ms": busy, "device_idle_share": 1.0 - busy / wall}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--docs", type=int, default=1_000_000)
    ap.add_argument("--concurrency", default="64,128")
    ap.add_argument("--requests", type=int, default=2048)
    ap.add_argument("--profiled", type=int, default=512)
    ap.add_argument("--queries", type=int, default=512)
    ap.add_argument("--device", default="cuda")
    opts = ap.parse_args(argv)
    import shutil

    from fugu_tpu_torch import bench
    from fugu_tpu_torch.config import ServerConfig
    from fugu_tpu_torch.device import resolve
    from fugu_tpu_torch.engine.manager import DatasetManager

    try:
        device = resolve(opts.device)
    except RuntimeError as e:
        print(json.dumps({"ok": False, "error": str(e)}), flush=True)
        return 1
    card = bench.card_line() if device.type == "cuda" else "cpu"
    seg_id = f"torchbenchv1{opts.docs}"
    if not (bench.CACHE / f"seg-{seg_id}.npz").exists():
        bench.build_corpus(opts.docs)
    work = bench.CACHE / f"live_load_{os.getpid()}"
    ns = "default"
    try:
        mount(work / "data" / ns / "docs", bench.CACHE,
              [(seg_id, opts.docs)])
        cfg = ServerConfig.with_defaults(str(work / "data"), ns)
        cfg.compaction = "off"
        mgr = DatasetManager(cfg, device=device)
        try:
            ds = mgr.get_dataset(ns)
            queries = make_queries(opts.queries)
            t0 = time.perf_counter()
            direct = ds.search_many(queries, 0, PER_PAGE)
            bench.log(f"corpus mounted: {opts.docs} docs; in-process "
                      f"search_many of {len(queries)} queries "
                      f"{time.perf_counter() - t0:.2f} s")
            expected = [[(r.id, r.score) for r in res] for res in direct]
            lines = run_levels(
                mgr, ns, queries, expected, work, card, device,
                [int(c) for c in opts.concurrency.split(",")],
                opts.requests, opts.profiled)
        finally:
            mgr.close()
    except LoadError as e:
        print(json.dumps({"ok": False, "error": str(e)}), flush=True)
        return 2
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for line in lines:
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--drive"]:
        drive_main(Path(sys.argv[2]))
    else:
        sys.exit(main())
