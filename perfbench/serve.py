"""The program under test served in process, and its load client.

``LiveServer``, ``scrape``, ``free_port`` and ``drive`` are frozen from
``fugu_tpu_torch/tools/live_load.py`` at commit
23dc844b70300e262b1ac425b78377cec020fed5: the port's app
(``fugu_tpu_torch.server.create_app``) over a ``DatasetManager`` on a
thread with its own event loop, ``/metrics`` read as {sample: value},
and the client process (``perfbench/client.py``) started, released and
waited for.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import os
import socket
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


class LoadError(RuntimeError):
    """The server or the load client failed."""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def http(method: str, url: str, body=None, timeout: float = 600.0):
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
        if name and not line.startswith("#"):
            out[name] = float(value)
    return out


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
        self._loop.close()


def drive(work: Path, job: dict, during=contextlib.nullcontext,
          timeout: float = 900.0) -> dict:
    """Run the load client on ``job`` and return what it wrote; its
    window runs inside ``during()``."""
    work.mkdir(parents=True, exist_ok=True)
    job_path, out = work / "job.json", work / "out.json"
    job = dict(job, out=str(out))
    job_path.write_text(json.dumps(job))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(ROOT), os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.Popen(
        [sys.executable, "-m", "perfbench.client", str(job_path)],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True, env=env,
        cwd=str(ROOT))
    try:
        if proc.stdout.readline().strip() != "READY":
            raise LoadError("the load client did not start")
        with during():
            proc.stdin.write("GO\n")
            proc.stdin.flush()
            done = proc.stdout.readline().strip()
        if done != "DONE" or proc.wait(timeout=timeout) != 0:
            raise LoadError(f"the load client ended with {done!r}, code "
                            f"{proc.poll()}")
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait()
    res = json.loads(out.read_text())
    out.unlink()
    job_path.unlink()
    return res
