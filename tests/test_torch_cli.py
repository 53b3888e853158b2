"""The port's CLI and its ``python -m fugu_tpu_torch`` entry point.

The cases of tests/test_cli.py run each package's CLI against that
package's live server (the port's with ``device="cpu"``, the reference's
with ``use_device=False``) and require the same exit code and the same
printed JSON (``normalized`` of tests/test_torch_server.py says what is
removed).  The entry-point cases start ``python -m fugu_tpu_torch serve``
in a subprocess on a temp directory: with ``--device cpu`` it answers
/health and a search, ``namespace search`` prints the hits, and SIGTERM
ends it with exit code 0 after the graceful shutdown; without ``--device``
on a machine with no CUDA device it exits 1 with the error and serves
nothing; with ``--shard-devices 2`` it serves over a 2-shard mesh and
answers as an unsharded server does."""

import json
import os
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest
import torch

import fugu_tpu.cli
import fugu_tpu_torch.cli
from test_torch_server import LiveServer, _free_port, comparable
from test_torch_writer import PKGS, PORT, REF

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PORT.cli = fugu_tpu_torch.cli
REF.cli = fugu_tpu.cli


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_data")
    pair = {pkg.name: LiveServer(pkg, root / pkg.name) for pkg in PKGS}
    yield pair
    for srv in pair.values():
        srv.stop()


def run(servers, argv, capsys):
    """Both CLIs on their own servers: equal exit codes and output; the
    port's are returned."""
    outs = {}
    for pkg in PKGS:
        rc = pkg.cli.run_cli(["--server", servers[pkg.name].base] + argv)
        outs[pkg.name] = (rc, capsys.readouterr().out)
    (rc, out), (ref_rc, ref_out) = outs["port"], outs["ref"]
    assert rc == ref_rc
    assert comparable(out) == comparable(ref_out), argv
    return rc, out


def test_namespace_add_and_list(servers, capsys):
    rc, out = run(servers, ["namespace", "add", "clins"], capsys)
    assert rc == 0
    assert json.loads(out)["status"] == "success"
    rc, out = run(servers, ["namespace", "list"], capsys)
    assert "clins" in json.loads(out)["namespaces"]


def test_add_file_and_search(servers, tmp_path, capsys):
    f = tmp_path / "notes.txt"
    f.write_text("zebras gallop across the savanna")
    rc, out = run(servers, ["namespace", "add-file", "clins", str(f)], capsys)
    assert rc == 0
    assert json.loads(out)["status"] == "success"

    rc, out = run(servers, ["namespace", "search", "clins", "zebras"], capsys)
    assert rc == 0
    payload = json.loads(out)
    assert payload["total"] == 1
    assert payload["results"][0]["id"] == "notes.txt"


def test_namespace_filters(servers, capsys):
    rc, out = run(servers, ["namespace", "filters", "namespace"], capsys)
    assert rc == 0
    assert "filters" in json.loads(out)


def test_dummy_item_and_get_object(servers, capsys):
    rc, out = run(servers, ["dummy-item", "--id", "dmy1"], capsys)
    assert rc == 0
    rc, out = run(servers, ["get-object", "dmy1"], capsys)
    assert rc == 0
    assert json.loads(out)["id"] == ["dmy1"]


@pytest.mark.parametrize("pkg", PKGS, ids=lambda p: p.name)
def test_get_object_missing_exits_nonzero(pkg, servers, capsys):
    with pytest.raises(SystemExit):
        pkg.cli.run_cli(
            ["--server", servers[pkg.name].base, "get-object", "nope"])


def test_namespace_delete(servers, capsys):
    rc, out = run(servers, ["namespace", "delete", "clins"], capsys)
    assert rc == 0
    rc, out = run(servers, ["namespace", "list"], capsys)
    assert "clins" not in json.loads(out)["namespaces"]


@pytest.mark.parametrize("pkg", PKGS, ids=lambda p: p.name)
def test_connection_refused_friendly_error(pkg, capsys):
    rc = pkg.cli.run_cli(["--server", "http://127.0.0.1:9", "namespace", "list"])
    assert rc == 1
    err = capsys.readouterr().err
    assert "could not reach server" in err


# -- python -m fugu_tpu_torch -----------------------------------------------------


def entry_env(data_path, **extra):
    env = {k: v for k, v in os.environ.items() if not k.startswith("FUGU_")}
    env.update(PYTHONPATH=str(REPO), FUGU_DATA_PATH=str(data_path),
               FUGU_DEFAULT_NAMESPACE="main", **extra)
    return env


def entry(args, cwd, env, **kw):
    return subprocess.run(
        [sys.executable, "-m", "fugu_tpu_torch", *args], cwd=str(cwd),
        env=env, capture_output=True, text=True, timeout=120, **kw)


def http(method, url, body=None):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(
        url, data=data, method=method,
        headers={"Content-Type": "application/json"} if data else {})
    with urllib.request.urlopen(req, timeout=30) as resp:
        return resp.status, resp.read().decode()


def test_serve_on_cpu_answers_and_stops_on_sigterm(tmp_path):
    port = _free_port()
    base = f"http://127.0.0.1:{port}"
    env = entry_env(tmp_path / "data")
    proc = subprocess.Popen(
        [sys.executable, "-m", "fugu_tpu_torch", "serve", "--device", "cpu",
         "--port", str(port)],
        cwd=str(tmp_path), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.time() + 90
        while True:
            try:
                status, body = http("GET", base + "/health")
                break
            except (urllib.error.URLError, ConnectionError):
                assert proc.poll() is None, proc.stderr.read()[-3000:]
                assert time.time() < deadline, "the server never came up"
                time.sleep(0.2)
        assert status == 200 and body == "OK, found 12 in db"
        docs = [{"id": f"e{i}", "text": f"entry point doc {i} fox",
                 "namespace": "main"} for i in range(6)]
        status, _ = http("POST", base + "/ingest", {"data": docs})
        assert status == 200
        status, raw = http("POST", base + "/search/main", {"query": "fox"})
        served = json.loads(raw)
        assert status == 200 and served["total"] == 6
        # the CLI, as its own process, prints the same hits
        cli = entry(["--server", base, "namespace", "search", "main", "fox"],
                    tmp_path, env)
        assert cli.returncode == 0, cli.stderr[-2000:]
        printed = json.loads(cli.stdout)
        assert comparable(cli.stdout) == comparable(raw)
        assert [r["id"] for r in printed["results"]] == [
            r["id"] for r in served["results"]]
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            out, err = proc.communicate(timeout=60)
        except subprocess.TimeoutExpired:  # pragma: no cover
            proc.kill()
            raise
    assert proc.returncode == 0, err[-3000:]
    assert "shutting down (graceful)" in err
    # what was served is on disk: a new manager on the directory finds it
    reopened = PORT.manager.DatasetManager.with_defaults(
        str(tmp_path / "data"), "main", device="cpu")
    assert reopened.get_dataset("main").stats().docs_count == 6
    reopened.close()


@pytest.mark.parametrize("args", [["serve"], []], ids=["serve", "no-args"])
def test_serve_without_cuda_exits_nonzero_and_serves_nothing(tmp_path, args):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is there: serve would start on it")
    port = _free_port()
    extra = ["--port", str(port)] if args else []
    proc = entry(args + extra, tmp_path, entry_env(tmp_path / "data"))
    assert proc.returncode == 1, proc.stderr[-2000:]
    assert "torch.cuda.is_available() is False" in proc.stderr
    assert not (tmp_path / "data").exists()  # no manager was built
    with pytest.raises((urllib.error.URLError, ConnectionError)):
        http("GET", f"http://127.0.0.1:{port}/health")


def start_server(args, cwd, env):
    """``python -m fugu_tpu_torch serve`` with ``args`` on a free port,
    once it answers /health: (process, base URL)."""
    port = _free_port()
    base = f"http://127.0.0.1:{port}"
    proc = subprocess.Popen(
        [sys.executable, "-m", "fugu_tpu_torch", "serve", "--port",
         str(port), *args],
        cwd=str(cwd), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    deadline = time.time() + 90
    while True:
        try:
            http("GET", base + "/health")
            return proc, base
        except (urllib.error.URLError, ConnectionError):
            if proc.poll() is not None or time.time() > deadline:
                proc.kill()
                raise AssertionError(proc.stderr.read()[-3000:])
            time.sleep(0.2)


def stop_server(proc):
    proc.send_signal(signal.SIGTERM)
    try:
        _out, err = proc.communicate(timeout=60)
    except subprocess.TimeoutExpired:  # pragma: no cover
        proc.kill()
        raise
    assert proc.returncode == 0, err[-3000:]
    return err


def test_serve_sharded_answers_like_unsharded(tmp_path):
    """``serve --device cpu --shard-devices 2`` serves over a 2-shard
    mesh, and its answers equal an unsharded server's on the same
    records (a corpus above DEVICE_MIN_ENTRIES, so the sharded engines
    answer)."""
    words = [f"w{i}" for i in range(30)]
    docs = [{"id": f"s{i}", "namespace": "main",
             "text": " ".join(words[(i * j) % 30] for j in range(1, 12))}
            for i in range(600)]
    queries = ["w1", "w2 w3", "+w4 w5", "w6 -w7", '"w2 w4"', "w11 OR w13"]
    answers, errs = {}, {}
    for name, args in (("plain", []), ("sharded", ["--shard-devices", "2"])):
        (tmp_path / name).mkdir()
        env = entry_env(tmp_path / name / "data")
        proc, base = start_server(["--device", "cpu", *args],
                                  tmp_path / name, env)
        try:
            status, _ = http("POST", base + "/ingest", {"data": docs})
            assert status == 200
            answers[name] = [
                comparable(http("POST", base + "/search/main",
                                {"query": q, "per_page": 20})[1])
                for q in queries]
        finally:
            errs[name] = stop_server(proc)
    assert "doc-range shards" in errs["sharded"]
    assert "doc-range shards" not in errs["plain"]
    assert answers["sharded"] == answers["plain"]
    assert all(a["total"] > 0 for a in answers["plain"])
