"""CLI client — parity with upstream `src/cli.rs`.

Subcommand surface (cli.rs:22-100):

    fugu namespace list
    fugu namespace add <name>
    fugu namespace delete <name>
    fugu namespace filters <name>
    fugu namespace search <name> <query...>
    fugu namespace add-file <name> <file>
    fugu dummy-item [--id ID] [--suffix SFX]
    fugu get-object <id>
    fugu serve [--port N] [--device D] [--shard-devices N [--shard-slices S]]
                                         (server mode, main.rs:25-29)

Talks HTTP to the server (default http://localhost:3301), health-probes
first (cli.rs:436-441), pretty-prints JSON responses.  The routes these
hit exist on our server (the reference CLI targeted several routes its
server never implemented — SURVEY.md §2d; we implemented them).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import urllib.error
import urllib.parse
import urllib.request
from pathlib import Path
from typing import Any, Optional

from fugu_tpu_torch import telemetry

DEFAULT_SERVER = "http://localhost:3301"


class CliError(RuntimeError):
    pass


class CliHttpError(CliError):
    """HTTP-level failure carrying the server's error envelope."""

    def __init__(self, status: int, payload: Any):
        self.status = status
        self.payload = payload
        if isinstance(payload, dict):
            msg = payload.get("error") or json.dumps(payload)
        else:
            msg = str(payload)
        super().__init__(f"HTTP {status}: {msg}")


def _request(
    method: str, url: str, body: Optional[dict] = None, timeout: float = 30.0
) -> Any:
    data = json.dumps(body).encode("utf-8") if body is not None else None
    req = urllib.request.Request(
        url,
        data=data,
        method=method,
        headers={"Content-Type": "application/json"} if data else {},
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            raw = resp.read().decode("utf-8")
    except urllib.error.HTTPError as e:
        # an HTTP error is a FAILED command: surface the server's error
        # envelope and exit nonzero (returning the body as a normal
        # payload made failed commands pretty-print the error and exit 0
        # — shell scripts checking $? treated failures as success)
        raw = e.read().decode("utf-8")
        try:
            payload = json.loads(raw)
        except json.JSONDecodeError:
            payload = raw
        raise CliHttpError(e.code, payload)
    except urllib.error.URLError as e:
        raise CliError(f"Failed to connect to server at {url}: {e.reason}")
    try:
        return json.loads(raw)
    except json.JSONDecodeError:
        return raw


def health_check(server: str) -> None:
    """Probe /health before doing anything (cli.rs:436-452).

    An HTTP error (server up but unhealthy) re-raises as-is so the
    generic handler reports the real status; only a connection failure
    gets the 'may not be running' hint.  The hint replaces the generic
    message (raise-from below) rather than printing both.
    """
    try:
        _request("GET", f"{server}/health", timeout=5.0)
    except CliHttpError:
        raise
    except CliError as e:
        raise CliError(
            f"could not reach server at {server} ({e}). The server may "
            "not be running — start it with `fugu serve` (or "
            "`python -m fugu_tpu_torch`)."
        ) from e


def _print(payload: Any) -> None:
    if isinstance(payload, str):
        print(payload)
    else:
        print(json.dumps(payload, indent=2, ensure_ascii=False))


def list_namespaces(server: str) -> None:
    with telemetry.cli_span("list_namespaces"):
        _print(_request("GET", f"{server}/namespaces"))


def add_namespace(server: str, name: str) -> None:
    with telemetry.cli_span("add_namespace"):
        _print(_request("POST", f"{server}/namespaces", {"name": name}))


def delete_namespace(server: str, name: str) -> None:
    with telemetry.cli_span("delete_namespace"):
        _print(_request("DELETE", f"{server}/namespaces/{urllib.parse.quote(name)}"))


def get_namespace_filters(server: str, name: str) -> None:
    with telemetry.cli_span("get_namespace_filters"):
        _print(_request("GET", f"{server}/filters/{urllib.parse.quote(name)}"))


def search_namespace(server: str, name: str, query: str) -> None:
    with telemetry.cli_span("search_namespace"):
        _print(
            _request(
                "POST",
                f"{server}/search/{urllib.parse.quote(name)}",
                {"query": query},
            )
        )


def spill_namespace(server: str, name: str, prefix: Optional[str]) -> None:
    with telemetry.cli_span("spill_namespace"):
        body = {"prefix": prefix} if prefix else {}
        _print(
            _request(
                "POST",
                f"{server}/namespaces/{urllib.parse.quote(name)}/spill",
                body,
            )
        )


def restore_namespace(server: str, name: str, prefix: Optional[str]) -> None:
    with telemetry.cli_span("restore_namespace"):
        body = {"prefix": prefix} if prefix else {}
        _print(
            _request(
                "POST",
                f"{server}/namespaces/{urllib.parse.quote(name)}/restore",
                body,
            )
        )


def add_file(server: str, namespace: str, path: str) -> None:
    with telemetry.cli_span("add_file"):
        p = Path(path)
        if not p.exists():
            raise CliError(f"File not found: {path}")
        content = p.read_text()
        _print(
            _request(
                "POST",
                f"{server}/add/{urllib.parse.quote(namespace)}",
                {"name": p.name, "body": content},
            )
        )


def create_dummy_item(server: str, id_: Optional[str], suffix: Optional[str]) -> None:
    with telemetry.cli_span("create_dummy_item"):
        timestamp = int(time.time())
        if id_:
            object_id = id_
        elif suffix:
            object_id = f"dummy_item_{timestamp}_{suffix}"
        else:
            object_id = f"dummy_item_{timestamp}"
        _print(_request("POST", f"{server}/demo-index", {"id": object_id}))


def get_object(server: str, object_id: str) -> None:
    with telemetry.cli_span("get_object"):
        payload = _request(
            "GET", f"{server}/objects/{urllib.parse.quote(object_id)}"
        )
        if isinstance(payload, dict) and payload.get("error"):
            print(f"Error: {payload['error']}", file=sys.stderr)
            sys.exit(1)
        _print(payload)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="fugu",
        description="fugu_tpu_torch — full-text search on an NVIDIA GPU",
    )
    parser.add_argument(
        "--server", default=DEFAULT_SERVER, help="server URL (default %(default)s)"
    )
    sub = parser.add_subparsers(dest="command")

    ns = sub.add_parser("namespace", help="namespace operations")
    ns_sub = ns.add_subparsers(dest="action", required=True)
    ns_sub.add_parser("list", help="list namespaces")
    p = ns_sub.add_parser("add", help="create a namespace")
    p.add_argument("name")
    p = ns_sub.add_parser("delete", help="delete a namespace")
    p.add_argument("name")
    p = ns_sub.add_parser("filters", help="show a namespace's filters")
    p.add_argument("name")
    p = ns_sub.add_parser("search", help="search a namespace")
    p.add_argument("name")
    p.add_argument("query", nargs="+")
    p = ns_sub.add_parser("add-file", help="index a file into a namespace")
    p.add_argument("name")
    p.add_argument("file")
    p = ns_sub.add_parser(
        "spill", help="offload a namespace's segments to the cold tier"
    )
    p.add_argument("name")
    p.add_argument("--prefix", help="remote prefix (defaults to server config)")
    p = ns_sub.add_parser(
        "restore", help="restore a namespace's cold segments"
    )
    p.add_argument("name")
    p.add_argument("--prefix", help="remote prefix (markers used if omitted)")

    p = sub.add_parser("dummy-item", help="create a demo item")
    p.add_argument("--id")
    p.add_argument("--suffix")

    p = sub.add_parser("get-object", help="fetch an object by id")
    p.add_argument("object_id")

    p = sub.add_parser("serve", help="run the HTTP server")
    p.add_argument("--port", type=int, default=3301)
    p.add_argument("--config")
    p.add_argument(
        "--device",
        default="cuda",
        help="torch device the indexes run on (default %(default)s; "
        "the server does not start when it is not there)",
    )
    p.add_argument(
        "--shard-devices",
        type=int,
        default=None,
        help="serve over an N-device mesh (doc-range sharding; 0 = single device)",
    )
    p.add_argument(
        "--shard-slices",
        type=int,
        default=None,
        help="outer (DCN) mesh axis size for multi-slice serving",
    )
    return parser


def run_cli(argv: Optional[list] = None) -> int:
    args = build_parser().parse_args(argv)
    telemetry.init_tracing(log_file=None)
    try:
        return _run_cli_inner(args)
    finally:
        # flush buffered OTLP spans: a short-lived CLI process would
        # otherwise exit inside the BatchSpanProcessor's schedule delay
        # and drop every span it produced
        telemetry.shutdown_tracing()


def _run_cli_inner(args) -> int:
    try:
        if args.command == "serve" or args.command is None:
            import os

            from fugu_tpu_torch import config as cfgmod
            from fugu_tpu_torch import device as device_mod
            from fugu_tpu_torch.engine.manager import DatasetManager
            from fugu_tpu_torch.server.app import start_http_server

            # flags win over env which wins over config-file values
            if getattr(args, "shard_devices", None) is not None:
                os.environ[cfgmod.ENV_SHARD_DEVICES] = str(args.shard_devices)
            if getattr(args, "shard_slices", None) is not None:
                os.environ[cfgmod.ENV_SHARD_SLICES] = str(args.shard_slices)
            # the server runs on the device it was asked for or not at
            # all: an absent device or a config the manager refuses (a
            # mesh whose shards the slices do not divide) ends the
            # command, and nothing is served from the CPU in its place;
            # --shard-devices N serves over N doc-range shards there
            device = getattr(args, "device", "cuda")
            try:
                device_mod.resolve(device)
            except (RuntimeError, ValueError) as e:
                print(f"Error: {e}", file=sys.stderr)
                return 1
            try:
                if getattr(args, "config", None):
                    db = DatasetManager.from_config_file(
                        args.config, device=device
                    )
                else:
                    db = DatasetManager.discover(device=device)
            except cfgmod.ConfigError as e:
                print(f"Error: {e}", file=sys.stderr)
                return 1
            start_http_server(getattr(args, "port", 3301), db)
            return 0

        server = args.server
        health_check(server)
        if args.command == "namespace":
            if args.action == "list":
                list_namespaces(server)
            elif args.action == "add":
                add_namespace(server, args.name)
            elif args.action == "delete":
                delete_namespace(server, args.name)
            elif args.action == "filters":
                get_namespace_filters(server, args.name)
            elif args.action == "search":
                search_namespace(server, args.name, " ".join(args.query))
            elif args.action == "add-file":
                add_file(server, args.name, args.file)
            elif args.action == "spill":
                spill_namespace(server, args.name, args.prefix)
            elif args.action == "restore":
                restore_namespace(server, args.name, args.prefix)
        elif args.command == "dummy-item":
            create_dummy_item(server, args.id, args.suffix)
        elif args.command == "get-object":
            get_object(server, args.object_id)
        return 0
    except CliError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    except BrokenPipeError:
        # output piped into e.g. `head`; exit quietly like a polite CLI
        try:
            sys.stdout.close()
        except Exception:
            pass
        return 0


if __name__ == "__main__":
    sys.exit(run_cli())
