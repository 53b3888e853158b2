"""The load client, a process of its own:

    python3 -m perfbench.client JOB

Frozen from ``drive_main`` in ``fugu_tpu_torch/tools/live_load.py`` at
commit 23dc844b70300e262b1ac425b78377cec020fed5, changed in three ways:
it sends for a fixed window (``seconds``) where the original sent a fixed
number of requests, writers run beside the searchers, and it parses only
the answers the job names (``parse``, the checked queries; all without
it), so that its own turn-around stays short.

The client runs on the job's ``cores`` where it names them.  Every
client holds one keep-alive connection and works as a closed loop,
sending its next request only once the last is answered.  Search clients
POST ``/search/json`` bodies in turn from one shared counter.  A writer
(``perfbench.workload.writer_plan``) POSTs ``/batch/upsert``, reads one
record of the acknowledged batch back by id, then DELETEs its ids one by
one.  Nothing new is sent once the window is over; what is in flight is
waited for.  With ``total`` set instead of ``seconds``, the searchers
send that many requests and stop.

The client prints READY once every connection is open and its writers'
requests are built, starts at a line on its standard input, prints DONE
after the last answer, and writes what it saw to the job's ``out``
file: each request's start and end (seconds from the start), status,
a parsed search's hits, and the client's own CPU seconds.
"""

from __future__ import annotations

import asyncio
import json
import os
import sys
import time
from pathlib import Path


def _hits(raw: bytes):
    return [[r["id"], r["score"]] for r in json.loads(raw)["results"]]


def build_writers(job: dict):
    """Per writer: [(upsert body, probe id, probe text, deletes)]."""
    from perfbench.workload import record_json, writer_plan

    w = job["writer"]
    out = []
    for i in range(w["writers"]):
        steps = []
        for batch in writer_plan(w["seed"], i, w["writers"], w["n_initial"],
                                 w["mix"], w["gen"], w["batches"]):
            texts = batch.passages.texts()
            body = json.dumps({"objects": [
                record_json(d, t, s) for d, t, s in
                zip(batch.ids, texts, batch.passages.sources)]}).encode()
            steps.append((body, batch.ids[batch.probe], texts[batch.probe],
                          batch.deletes))
        out.append(steps)
    return out


def main(job_path: Path) -> None:
    job = json.loads(Path(job_path).read_text())
    if job.get("cores"):
        os.sched_setaffinity(0, job["cores"])
    import aiohttp

    bodies = [json.dumps(b).encode() for b in job["bodies"]]
    writers = build_writers(job) if job.get("writer") else []
    seconds, total = job.get("seconds"), job.get("total")
    parse = set(job["parse"]) if job.get("parse") is not None else None
    searches, writes, deletes, probes = [], [], [], []
    headers = {"Content-Type": "application/json"}
    base = job["base"]

    async def run():
        nxt = 0
        conn = aiohttp.TCPConnector(limit=0)
        timeout = aiohttp.ClientTimeout(total=600)
        async with aiohttp.ClientSession(connector=conn,
                                         timeout=timeout) as pool:
            async def open_connection():
                async with pool.get(base + "/hi") as resp:
                    await resp.read()

            await asyncio.gather(*(open_connection() for _ in range(
                job["search_clients"] + len(writers))))
            print("READY", flush=True)
            await asyncio.get_running_loop().run_in_executor(
                None, sys.stdin.readline)
            t_go = time.perf_counter()
            cpu["go"] = os.times()
            deadline = t_go + seconds if seconds is not None else None

            def open_():
                if deadline is not None:
                    return time.perf_counter() < deadline
                return nxt < total

            async def searcher():
                nonlocal nxt
                while open_():
                    i, nxt = nxt, nxt + 1
                    qi = i % len(bodies)
                    t0 = time.perf_counter()
                    async with pool.post(base + "/search/json",
                                         data=bodies[qi],
                                         headers=headers) as resp:
                        raw = await resp.read()
                    t1 = time.perf_counter()
                    hits = (_hits(raw) if resp.status == 200 and (
                        parse is None or qi in parse) else None)
                    searches.append([qi, t0 - t_go, t1 - t_go, resp.status,
                                     hits])

            async def writer(w, steps):
                for b, (body, probe_id, probe_text, dels) in enumerate(steps):
                    if not open_():
                        return
                    t0 = time.perf_counter()
                    async with pool.post(base + "/batch/upsert", data=body,
                                         headers=headers) as resp:
                        await resp.read()
                    t1 = time.perf_counter()
                    writes.append([w, b, t0 - t_go, t1 - t_go, resp.status])
                    if resp.status != 200:
                        return
                    async with pool.get(f"{base}/objects/{probe_id}") as resp:
                        doc = json.loads(await resp.text())
                    probes.append([w, b, probe_id,
                                   doc.get("text") == [probe_text]])
                    for doc_id in dels:
                        if not open_():
                            return
                        t0 = time.perf_counter()
                        async with pool.delete(
                                f"{base}/objects/{doc_id}") as resp:
                            await resp.read()
                        t1 = time.perf_counter()
                        deletes.append([w, b, doc_id, t0 - t_go, t1 - t_go,
                                        resp.status])
                        if resp.status != 200:
                            return

            await asyncio.gather(
                *(searcher() for _ in range(job["search_clients"])),
                *(writer(w, steps) for w, steps in enumerate(writers)))
            return time.perf_counter() - t_go

    cpu = {}
    wall = asyncio.run(run())
    end = os.times()
    Path(job["out"]).write_text(json.dumps({
        "wall_s": wall, "searches": searches, "writes": writes,
        "deletes": deletes, "probes": probes,
        "cpu_s": (end.user + end.system) - (cpu["go"].user
                                             + cpu["go"].system)}))
    print("DONE", flush=True)


if __name__ == "__main__":
    main(Path(sys.argv[1]))
