"""HTTP API server — the reference's axum+aide surface on aiohttp.

Route table parity with upstream `src/server/routes.rs:26-85`,
handler semantics with `src/server/handlers/*` (response JSON shapes,
clamps, defaults, error envelopes), plus the §2d drift fixes the
reference CLI needs but the reference server never implemented:

- POST /search/{namespace}       (cli.rs:352-356 expects it; was 405)
- POST /add/{namespace}          (cli.rs:392-398; was 404)
- POST /namespaces, DELETE /namespaces/{ns}   (cli.rs:241-283)
- POST /demo-index               (cli.rs:477-481)
- GET  /objects with real pagination (reference stubs it, objects.rs:157-168)
- `took_ms` in search responses (API.md:108-115 promised, never shipped)

OpenAPI JSON at /api.json and Swagger UI at /swagger
(server_main.rs:68-69).
"""

from __future__ import annotations

import asyncio
import json
import logging
import signal
import urllib.parse
from typing import Any, List, Optional

from aiohttp import web

from fugu_tpu_torch import telemetry
from fugu_tpu_torch.config import ConfigError
from fugu_tpu_torch.engine.manager import DatasetManager, NamespaceNotFoundError
from fugu_tpu_torch.records import ObjectRecord, ValidationError
from fugu_tpu_torch.server.openapi import build_openapi, SWAGGER_HTML
from fugu_tpu_torch.version import __version__

logger = logging.getLogger("fugu_tpu_torch.server")

DEFAULT_PORT = 3301  # main.rs:76


def _json(data: Any, status: int = 200) -> web.Response:
    return web.json_response(data, status=status, dumps=lambda d: json.dumps(d, ensure_ascii=False))


def _json_search(data: Any) -> web.Response:
    """Search responses: same encoding, plus a serialize-stage histogram
    (the live-stack breakdown: parse / queue / engine / serialize)."""
    import time

    from fugu_tpu_torch.server.metrics import REGISTRY

    t0 = time.perf_counter()
    text = json.dumps(data, ensure_ascii=False)
    REGISTRY.observe(
        "fugu_search_serialize_seconds", time.perf_counter() - t0
    )
    return web.Response(
        text=text, status=200, content_type="application/json"
    )




def _exc_status(e: Exception, default: int = 500) -> int:
    """ColdNamespaceError -> 409 (the namespace exists but its segments
    are offloaded and could not be auto-restored — never silently serve
    partial results); unknown namespace -> 404; everything else keeps
    the caller's default."""
    from fugu_tpu_torch.engine.dataset import ColdNamespaceError

    if isinstance(e, ColdNamespaceError):
        return 409
    if isinstance(e, NamespaceNotFoundError):
        return 404
    return default


def _err(message: str, status: int = 500) -> web.Response:
    return _json({"status": "error", "error": message}, status=status)


def _clamp_per_page(per_page: int) -> int:
    """(0,100] else 20 (handlers/search.rs:370-374)."""
    return per_page if 0 < per_page <= 100 else 20


def _as_dict(value) -> dict:
    """Shape-tolerant body access: any non-object JSON value (which
    would AttributeError into an HTML 500) reads as an empty object."""
    return value if isinstance(value, dict) else {}


def _int_or(value, default: int) -> int:
    try:
        return int(value)
    except (TypeError, ValueError):
        return default


def _page_params(payload: dict):
    """(page, per_page) from a FuguSearchQuery body, tolerating wrong
    shapes (serde would 422 them; we default like the query-param path)."""
    page_obj = _as_dict(payload.get("page"))
    return (
        _int_or(page_obj.get("page"), 0),
        _int_or(page_obj.get("per_page"), 20),
    )


def _filter_list(payload: dict) -> List[str]:
    """Filters as a list of strings; scalar/wrong-shape values (a bare
    string would iterate as characters) are dropped."""
    filters = payload.get("filters")
    if not isinstance(filters, list):
        return []
    return [f for f in filters if isinstance(f, str)]


class AppState:
    """AppState { db: DatasetManager } (server_main.rs:16-19)."""

    def __init__(self, db: DatasetManager):
        self.db = db
        from fugu_tpu_torch.server.batcher import SearchBatcher

        self.batcher = SearchBatcher()

    async def run_sync(self, fn, *args):
        """Engine calls are CPU-bound sync; keep the event loop free."""
        return await asyncio.get_running_loop().run_in_executor(None, fn, *args)


def _state(request: web.Request) -> AppState:
    return request.app["state"]


def _strip_text(payload: dict, include_text: bool) -> dict:
    if not include_text:
        for item in payload.get("results", []):
            item.pop("text", None)
    return payload


def _search_response(results, query, page, per_page, took_ms) -> dict:
    return {
        "results": [r.to_dict() for r in results],
        "total": len(results),
        "page": page,
        "per_page": per_page,
        "query": query,
        "took_ms": took_ms,
    }


async def _perform_search(state, namespace, query, filters, page, per_page):
    """perform_search parity (handlers/search.rs:350-402), executed through
    the micro-batcher so concurrent requests share device dispatches."""
    from fugu_tpu_torch.server.metrics import timed

    ds = state.db.get_dataset(namespace)
    if ds is None:
        raise NamespaceNotFoundError(f"Namespace '{namespace}' not found")
    per_page = _clamp_per_page(per_page)
    with telemetry.Timer() as t, timed("fugu_search", namespace=namespace):
        results = await state.batcher.search(ds, query, filters, page, per_page)
    # the request's span names the engine batch that served it
    telemetry.annotate(batch=getattr(results, "batch", None))
    return _search_response(results, query, page, per_page, t.took_ms)


# -- basic (handlers/basic.rs) ------------------------------------------------


async def health(request: web.Request) -> web.Response:
    state = _state(request)
    ds = state.db.get_dataset(state.db.config.default_namespace)
    num_fields = len(ds.docs().schema.stored_fields) if ds else 0
    return web.Response(text=f"OK, found {num_fields} in db")


async def sayhi(request: web.Request) -> web.Response:
    return _json({"message": "hi"})


# -- search (handlers/search.rs) ----------------------------------------------


async def query_text_get(request: web.Request) -> web.Response:
    with telemetry.server_span("/search", "GET"):
        with telemetry.span("front", "parse"):
            state = _state(request)
            q = request.query.get("q")
            if q is None:
                return _json({"error": "missing query parameter `q`"}, status=400)
            try:
                limit = int(request.query.get("limit", 20))
            except ValueError:
                return _json({"error": "invalid `limit` parameter"}, status=400)
            include_text = request.query.get("text", "false").lower() == "true"
            namespace = request.query.get(
                "namespace", state.db.config.default_namespace
            )
        try:
            payload = await _perform_search(state, namespace, q, [], 0, limit)
        except Exception as e:  # parse/engine errors -> 500 envelope
            return _json({"error": f"Search failed: {e}"}, status=_exc_status(e))
        with telemetry.span("front", "respond"):
            return _json_search(_strip_text(payload, include_text))


async def query_text_path(request: web.Request) -> web.Response:
    with telemetry.server_span("/search/:query", "GET"):
        with telemetry.span("front", "parse"):
            state = _state(request)
            query = urllib.parse.unquote(request.match_info["query"])
            include_text = request.query.get("text", "false").lower() == "true"
            namespace = request.query.get(
                "namespace", state.db.config.default_namespace
            )
        try:
            payload = await _perform_search(state, namespace, query, [], 0, 20)
        except Exception as e:  # parse/engine errors -> 500 envelope
            return _json({"error": f"Search failed: {e}"}, status=_exc_status(e))
        with telemetry.span("front", "respond"):
            return _json_search(_strip_text(payload, include_text))


async def search_endpoint(request: web.Request) -> web.Response:
    """POST /search: FuguSearchQuery on the default namespace."""
    with telemetry.server_span("/search", "POST"):
        with telemetry.span("front", "parse"):
            state = _state(request)
            try:
                payload = _as_dict(await request.json())
            except json.JSONDecodeError:
                return _err("invalid JSON body", 400)
            query = payload.get("query", "")
            if not isinstance(query, str):
                query = ""
            filters = _filter_list(payload)
            page, per_page = _page_params(payload)
            ds = state.db.get_dataset(state.db.config.default_namespace)
            if ds is None:
                return _err("Default dataset not found")
            per_page = _clamp_per_page(per_page)  # every search route clamps
        from fugu_tpu_torch.server.metrics import timed

        try:
            with telemetry.Timer() as t, timed(
                "fugu_search", namespace=state.db.config.default_namespace
            ):
                results = await state.batcher.search(
                    ds, query, filters, page, per_page
                )
        except Exception as e:  # engine errors -> 500 envelope
            return _err(f"Search failed: {e}", _exc_status(e))
        telemetry.annotate(batch=getattr(results, "batch", None))
        with telemetry.span("front", "respond"):
            return _json_search(
                {
                    "status": "success",
                    "query": query,
                    "filters": filters,
                    "page": page,
                    "per_page": per_page,
                    "total": len(results),
                    "results": [r.to_dict() for r in results],
                    "took_ms": t.took_ms,
                }
            )


async def search_namespace_post(request: web.Request) -> web.Response:
    """POST /search/{namespace} — drift fix for the reference CLI
    (cli.rs:352-356 posts {"query": q} here and got a 405)."""
    with telemetry.server_span("/search/:namespace", "POST"):
        with telemetry.span("front", "parse"):
            state = _state(request)
            namespace = request.match_info["namespace"]
            try:
                payload = _as_dict(await request.json())
            except json.JSONDecodeError:
                return _err("invalid JSON body", 400)
            query = payload.get("query", "")
            if not isinstance(query, str):
                query = ""
            filters = _filter_list(payload)
            page, per_page = _page_params(payload)
            ds = state.db.get_dataset(namespace)
            if ds is None:
                return _err(f"Namespace '{namespace}' not found", 404)
        from fugu_tpu_torch.server.metrics import timed

        try:
            with telemetry.Timer() as t, timed(
                "fugu_search", namespace=namespace
            ):
                results = await state.batcher.search(
                    ds, query, filters, page, _clamp_per_page(per_page)
                )
        except Exception as e:
            return _err(f"Search failed: {e}", _exc_status(e))
        telemetry.annotate(batch=getattr(results, "batch", None))
        with telemetry.span("front", "respond"):
            return _json_search(
                _search_response(results, query, page, _clamp_per_page(per_page), t.took_ms)
            )


async def query_json_post(request: web.Request) -> web.Response:
    """POST /search/json (handlers/search.rs:210-301) — full parity
    including the url-vs-body `text` flag conflict message and the
    include_data defaulting."""
    with telemetry.server_span("/search/json", "POST"):
        with telemetry.span("front", "parse"):
            state = _state(request)
            try:
                payload = _as_dict(await request.json())
            except json.JSONDecodeError:
                return _json({"error": "invalid JSON body"}, status=400)
            if "query" not in payload or not isinstance(payload["query"], str):
                return _json({"error": "missing `query`"}, status=400)

            url_text_raw = request.query.get("text")
            body_text = payload.get("text")
            url_text = (url_text_raw or "false").lower() == "true"
            include_text = url_text if url_text_raw is not None else bool(body_text)

            developer_message = None
            if url_text_raw is not None and body_text is not None and url_text != bool(body_text):
                developer_message = (
                    "url and request body are set to different values; using url:true/false"
                )

            filters = _filter_list(payload)
            page, per_page = _page_params(payload)

            targeting = _is_targeting_conv_or_org(filters)
            include_data = payload.get("include_data")
            if include_data is None:
                idq = request.query.get("include_data")
                include_data = (idq.lower() == "true") if idq is not None else None
            if include_data is None:
                include_data = not targeting

            namespace = payload.get("namespace") or state.db.config.default_namespace

            # intended-API knobs (API.md:30-44 — documented in the reference,
            # implemented here): bm25_k1 / bm25_b / min_score_threshold /
            # highlight_snippets
            k1 = payload.get("bm25_k1")
            b = payload.get("bm25_b")
            min_score = payload.get("min_score_threshold")
            want_highlights = bool(payload.get("highlight_snippets"))

        try:
            if k1 is None and b is None and min_score is None:
                out = await _perform_search(
                    state, namespace, payload["query"], filters, page, per_page
                )
            else:
                ds = state.db.get_dataset(namespace)
                if ds is None:
                    # NamespaceNotFoundError -> 404 like the knob-less
                    # path (a bare KeyError mapped to 500 here)
                    raise NamespaceNotFoundError(
                        f"Namespace '{namespace}' not found"
                    )
                from fugu_tpu_torch.server.metrics import timed

                pp = _clamp_per_page(per_page)
                with telemetry.Timer() as t, timed(
                    "fugu_search", namespace=namespace
                ):
                    results = await state.run_sync(
                        lambda: ds.search(
                            payload["query"], filters, page, pp,
                            k1=k1, b=b, min_score=min_score,
                        )
                    )
                out = _search_response(results, payload["query"], page, pp, t.took_ms)
        except Exception as e:  # parse/engine errors -> 500 envelope
            return _json({"error": f"Search failed: {e}"}, status=_exc_status(e))

        with telemetry.span("front", "respond"):
            if want_highlights:
                from fugu_tpu_torch import analysis
                from fugu_tpu_torch.engine.highlight import highlight

                def add_snippets():  # CPU work off the event loop
                    terms = analysis.tokenize_terms(payload["query"])
                    for item in out["results"]:
                        if "text" in item and item["text"]:
                            item["snippet"] = highlight(item["text"], terms)

                await state.run_sync(add_snippets)
            out = _strip_text(out, include_text)
            if developer_message:
                out["developer_message"] = developer_message
            out["includes_data_objects"] = include_data
            out["targeting_conversations_or_organizations"] = targeting
            out["total_hits"] = out["total"]  # API.md:108-115 naming alias
            return _json_search(out)


def _is_targeting_conv_or_org(filters: List[str]) -> bool:
    """search.rs:522-531."""
    out = False
    for f in filters:
        normalized = f if f.startswith("/") else "/" + f
        if "/conversation" in normalized or "/organization" in normalized:
            out = True
    return out


# -- objects (handlers/objects.rs) -------------------------------------------


async def get_object_by_id(request: web.Request) -> web.Response:
    state = _state(request)
    object_id = request.match_info["object_id"]
    with telemetry.server_span(f"/objects/{object_id}", "GET"):
        ds = state.db.get_dataset(state.db.config.default_namespace)
        if ds is None:
            return _json({"error": "Default dataset not found"})
        results = await state.run_sync(ds.get, object_id)
        if results:
            # Tantivy's to_json wraps every field value in an array
            # (objects.rs:55); replicate the wire shape.
            doc = {
                k: v if isinstance(v, list) else [v] for k, v in results[0].items()
            }
            return _json(doc)
        return _json({"error": f"Object with id {object_id} not found"})


async def delete_object(request: web.Request) -> web.Response:
    state = _state(request)
    object_id = request.match_info["object_id"]
    with telemetry.server_span(f"/objects/{object_id}", "DELETE"):
        ds = state.db.get_dataset(state.db.config.default_namespace)
        if ds is None:
            return _err("Default dataset not found")
        try:
            await state.run_sync(ds.delete_document, object_id)
        except Exception as e:
            return _err(f"Failed to delete object: {e}")
        return _json(
            {
                "status": "success",
                "message": f"Object with ID '{object_id}' deleted successfully",
            }
        )


async def upsert_objects(request: web.Request) -> web.Response:
    """PUT /objects — errors surface as 500 (no pre-validation pass,
    matching objects.rs:113-155 vs ingest's 400)."""
    with telemetry.server_span("/objects", "PUT"):
        state = _state(request)
        try:
            payload = await request.json()
        except json.JSONDecodeError:
            return _err("invalid JSON body", 400)
        data = payload.get("data", []) if isinstance(payload, dict) else []
        try:
            records = [ObjectRecord.from_dict(d) for d in data]
        except ValidationError as e:  # wrong-shape items: 400, not HTML 500
            return _err(str(e), 400)
        ds = state.db.get_dataset(state.db.config.default_namespace)
        if ds is None:
            return _err("Default dataset not found")
        try:
            await state.run_sync(ds.upsert, records)
        except Exception as e:
            return _err(f"Failed to upsert objects: {e}")
        return _json({"status": "success", "message": "Objects upserted successfully"})


async def list_objects(request: web.Request) -> web.Response:
    """GET /objects — implemented for real (the reference stubs this,
    objects.rs:157-168; SURVEY.md §2a says implement it properly)."""
    with telemetry.server_span("/objects", "GET"):
        state = _state(request)
        ds = state.db.get_dataset(state.db.config.default_namespace)
        if ds is None:
            return _err("Default dataset not found")
        try:
            page = int(request.query.get("page", 0))
            per_page = _clamp_per_page(int(request.query.get("per_page", 20)))
        except ValueError:
            return _err("invalid `page`/`per_page` parameter", 400)

        def collect():
            # early-exit after the requested window: materializing every
            # stored doc in a 1M-doc corpus per request was a memory
            # spike and a trivial DoS.  total comes from live-doc counts.
            need = (page + 1) * per_page
            out = []
            total = 0
            for seg in ds.docs().segments:
                total += seg.num_live_docs
                if len(out) < need:
                    for d in range(seg.doc_count):
                        if not seg.tombstones[d]:
                            out.append(seg.stored[d])
                            if len(out) >= need:
                                break
            return out, total

        objects, total = await state.run_sync(collect)
        window = objects[page * per_page : (page + 1) * per_page]
        return _json(
            {"objects": window, "total": total, "page": page, "per_page": per_page}
        )


# -- ingest (handlers/ingest.rs) ---------------------------------------------


def _validated_records_sync(payload_list) -> List[ObjectRecord]:
    if not isinstance(payload_list, list):
        raise ValidationError("expected a JSON array of object records")
    records = [ObjectRecord.from_dict(d) for d in payload_list]
    for i, rec in enumerate(records):
        try:
            rec.validate()
        except ValidationError as e:
            raise ValidationError(f"Validation failed for object at index {i}: {e}")
    return records


async def _validated_records(state, payload_list) -> List[ObjectRecord]:
    """Record construction + validation for up to client_max_size bodies
    is CPU work — run it in the executor so in-flight searches don't
    stall on a big ingest."""
    return await state.run_sync(_validated_records_sync, payload_list)


async def ingest_objects(request: web.Request) -> web.Response:
    with telemetry.server_span("/ingest", "POST"):
        state = _state(request)
        try:
            payload = await request.json()
        except json.JSONDecodeError:
            return _err("invalid JSON body", 400)
        try:
            records = await _validated_records(state, payload.get("data", []))
        except ValidationError as e:
            return _err(str(e), 400)
        ds = state.db.get_dataset(state.db.config.default_namespace)
        if ds is None:
            return _err("Default dataset not found")
        from fugu_tpu_torch.server.metrics import REGISTRY, timed

        try:
            with timed("fugu_ingest"):
                await state.run_sync(ds.ingest, records)
            REGISTRY.inc("fugu_ingested_documents_total", len(records))
        except Exception as e:
            return _err(f"Failed to ingest objects: {e}")
        return _json(
            {
                "status": "success",
                "message": "Objects ingested successfully (upserted)",
            }
        )


async def ingest_objects_with_namespace_facets(request: web.Request) -> web.Response:
    with telemetry.server_span("/ingest/namespace", "POST"):
        state = _state(request)
        try:
            payload = await request.json()
        except json.JSONDecodeError:
            return _err("invalid JSON body", 400)
        data = payload.get("data", [])
        try:
            records = await _validated_records(state, data)
        except ValidationError as e:
            return _err(str(e), 400)
        explicit = sum(1 for r in records if r.facets is not None)
        generated = len(records) - explicit
        ds = state.db.get_dataset(state.db.config.default_namespace)
        if ds is None:
            return _err("Default dataset not found")
        try:
            await state.run_sync(ds.upsert, records)
        except Exception as e:
            return _err(f"Failed to ingest objects: {e}")
        return _json(
            {
                "status": "success",
                "message": "Objects ingested successfully with namespace facets",
                "explicit_facets_count": explicit,
                "generated_facets_count": generated,
            }
        )


async def batch_upsert_objects(request: web.Request) -> web.Response:
    with telemetry.server_span("/batch/upsert", "POST"):
        state = _state(request)
        try:
            payload = await request.json()
        except json.JSONDecodeError:
            return _err("invalid JSON body", 400)
        try:
            records = await _validated_records(state, payload.get("objects", []))
        except ValidationError as e:
            return _err(str(e), 400)
        ds = state.db.get_dataset(state.db.config.default_namespace)
        if ds is None:
            return _err("Default dataset not found")
        try:
            count = await state.run_sync(ds.batch_upsert, records)
        except Exception as e:
            return _err(f"Failed to batch upsert objects: {e}")
        return _json(
            {
                "status": "success",
                "message": f"Successfully upserted {count} objects",
                "upserted_count": count,
            }
        )


async def add_file(request: web.Request) -> web.Response:
    """POST /add/{namespace} — drift fix for CLI add-file (cli.rs:392-398):
    body {"name": ..., "body": ...} becomes one ObjectRecord."""
    with telemetry.server_span("/add/:namespace", "POST"):
        state = _state(request)
        namespace = request.match_info["namespace"]
        try:
            payload = await request.json()
        except json.JSONDecodeError:
            return _err("invalid JSON body", 400)
        name = payload.get("name")
        body = payload.get("body")
        if not name or body is None:
            return _err("`name` and `body` are required", 400)
        record = ObjectRecord(
            id=name, text=body, namespace=namespace, metadata={"name": name}
        )
        try:
            record.validate()
        except ValidationError as e:
            return _err(str(e), 400)
        ds = state.db.get_or_create_dataset(namespace)
        try:
            await state.run_sync(ds.ingest, [record])
        except Exception as e:
            return _err(f"Failed to add file: {e}")
        return _json(
            {
                "status": "success",
                "message": f"File '{name}' added to namespace '{namespace}'",
                "id": name,
            }
        )


async def demo_index(request: web.Request) -> web.Response:
    """POST /demo-index — drift fix for CLI dummy-item (cli.rs:477-481)."""
    with telemetry.server_span("/demo-index", "POST"):
        state = _state(request)
        try:
            payload = await request.json()
        except json.JSONDecodeError:
            payload = {}
        object_id = payload.get("id") or "dummy_item"
        record = ObjectRecord(
            id=object_id,
            text="This is a dummy demo item used to exercise the index.",
            namespace=state.db.config.default_namespace,
            data_type="demo",
            metadata={"name": "Demo item", "demo": "true"},
        )
        ds = state.db.default_dataset()
        try:
            await state.run_sync(ds.ingest, [record])
        except Exception as e:
            return _err(f"Failed to create demo item: {e}")
        return _json({"status": "success", "id": object_id})


# -- namespaces (handlers/namespaces.rs) -------------------------------------


async def get_available_namespaces(request: web.Request) -> web.Response:
    with telemetry.server_span("/namespaces", "GET"):
        state = _state(request)
        return _json(
            {"status": "success", "namespaces": state.db.get_available_namespaces()}
        )


async def create_namespace(request: web.Request) -> web.Response:
    """POST /namespaces — drift fix (cli.rs:241-245 got a 405)."""
    with telemetry.server_span("/namespaces", "POST"):
        state = _state(request)
        try:
            payload = await request.json()
        except json.JSONDecodeError:
            return _err("invalid JSON body", 400)
        name = payload.get("name")
        if not name:
            return _err("`name` is required", 400)
        try:
            await state.run_sync(state.db.create_namespace, name)
        except ConfigError as e:
            return _err(f"Invalid namespace name: {e}", 400)
        except Exception as e:
            return _err(f"Failed to create namespace: {e}")
        return _json({"status": "success", "namespace": name})


async def delete_namespace(request: web.Request) -> web.Response:
    """DELETE /namespaces/{ns} — drift fix (cli.rs:280-283 got a 404)."""
    with telemetry.server_span("/namespaces/:namespace", "DELETE"):
        state = _state(request)
        namespace = request.match_info["namespace"]
        removed = await state.run_sync(state.db.delete_namespace, namespace)
        if not removed:
            return _err(f"Namespace '{namespace}' not found", 404)
        return _json({"status": "success", "namespace": namespace})


async def get_namespace_facets(request: web.Request) -> web.Response:
    state = _state(request)
    namespace = request.match_info["namespace"]
    with telemetry.server_span(f"/namespaces/{namespace}/facets", "GET"):
        try:
            facets = await state.run_sync(
                state.db.get_namespace_facets, namespace, "/"
            )
        except Exception as e:
            return _err(f"Failed to get namespace facets: {e}", _exc_status(e))
        return _json(
            {
                "status": "success",
                "namespace": namespace,
                "facets": [{"path": p, "count": c} for p, c in facets],
            }
        )


def _namespace_values_handler(kind: str, key: str):
    async def handler(request: web.Request) -> web.Response:
        state = _state(request)
        namespace = request.match_info["namespace"]
        with telemetry.server_span(f"/namespaces/{namespace}/{kind}", "GET"):
            path = f"/namespace/{namespace}/{kind}"
            try:
                values = await state.run_sync(
                    state.db.get_filter_values_at_path, path
                )
            except Exception as e:
                return _err(f"Failed to get {key}: {e}", _exc_status(e))
            return _json({"status": "success", "namespace": namespace, key: values})

    return handler


get_namespace_organizations = _namespace_values_handler("organization", "organizations")
get_namespace_conversations = _namespace_values_handler("conversation", "conversations")
get_namespace_data_types = _namespace_values_handler("data", "data_types")


# -- filters (handlers/filters.rs) -------------------------------------------


async def list_filters(request: web.Request) -> web.Response:
    with telemetry.server_span("/filters", "GET"):
        state = _state(request)
        ds = state.db.get_dataset(state.db.config.default_namespace)
        if ds is None:
            return _err("Default dataset not found")
        try:
            facets = await state.run_sync(ds.get_facets, None)
        except Exception as e:  # cold namespace -> 409, else 500 envelope
            return _err(f"Failed to list filters: {e}", _exc_status(e))
        return _json({"filters": [{"value": p} for p, _ in facets]})


async def get_filter(request: web.Request) -> web.Response:
    """Legacy /filters/{namespace} (filters.rs:34-48): lists facets at
    /{namespace} in the DEFAULT dataset."""
    state = _state(request)
    namespace = request.match_info["namespace"]
    with telemetry.server_span(f"/filters/{namespace}", "GET"):
        ds = state.db.get_dataset(state.db.config.default_namespace)
        if ds is None:
            return _err("Default dataset not found")
        try:
            facets = await state.run_sync(ds.get_facets, f"/{namespace}")
        except Exception as e:
            return _err(f"Failed to get filter: {e}", _exc_status(e))
        return _json({"filters": [[p, c] for p, c in facets]})


async def get_all_filters(request: web.Request) -> web.Response:
    with telemetry.server_span("/filters/all", "GET"):
        state = _state(request)
        ds = state.db.get_dataset(state.db.config.default_namespace)
        if ds is None:
            return _err("Default dataset not found")
        try:
            paths = await state.run_sync(ds.get_all_filter_paths)
        except Exception as e:
            return _err(f"Failed to get filters: {e}", _exc_status(e))
        return _json({"status": "success", "filter_paths": paths})


async def get_namespace_filters(request: web.Request) -> web.Response:
    state = _state(request)
    namespace = request.match_info["namespace"]
    with telemetry.server_span(f"/filters/namespace/{namespace}", "GET"):
        ds = state.db.get_dataset(state.db.config.default_namespace)
        if ds is None:
            return _err("Default dataset not found")
        try:
            paths = await state.run_sync(
                ds.get_filter_paths_for_namespace, namespace
            )
        except Exception as e:
            return _err(f"Failed to get namespace filters: {e}", _exc_status(e))
        return _json(
            {"status": "success", "namespace": namespace, "filter_paths": paths}
        )


async def get_filter_values_at_path(request: web.Request) -> web.Response:
    state = _state(request)
    filter_path = request.match_info["filter"]
    with telemetry.server_span(f"/filters/path/{filter_path}", "GET"):
        ds = state.db.get_dataset(state.db.config.default_namespace)
        if ds is None:
            return _err("Default dataset not found")
        try:
            values = await state.run_sync(
                ds.get_filter_values_at_path, filter_path
            )
        except Exception as e:
            return _err(f"Failed to get filter values: {e}", _exc_status(e))
        return _json({"status": "success", "path": filter_path, "values": values})


# -- facets (handlers/facets.rs) ---------------------------------------------


async def get_facet_tree(request: web.Request) -> web.Response:
    with telemetry.server_span("/facets/tree", "GET"):
        state = _state(request)
        raw = request.query.get("max_depth")
        try:
            max_depth = int(raw) if raw is not None else None
        except ValueError:
            return _err("invalid `max_depth` parameter", 400)
        # max_depth - 1 adjustment (facets.rs:31)
        effective = None if max_depth is None else (max_depth - 1 if max_depth > 0 else 0)
        ds = state.db.get_dataset(state.db.config.default_namespace)
        if ds is None:
            return _err("Default dataset not found")
        try:
            tree = await state.run_sync(ds.get_facet_tree, effective)
        except Exception as e:
            return _err(f"Failed to get facet tree: {e}", _exc_status(e))
        return _json({"status": "success", "data": tree.to_dict()})


# -- suggestions (query_index read path; extension) ---------------------------


async def suggest(request: web.Request) -> web.Response:
    with telemetry.server_span("/suggest", "GET"):
        state = _state(request)
        q = request.query.get("q", "")
        try:
            limit = int(request.query.get("limit", 10))
        except ValueError:
            return _err("invalid `limit` parameter", 400)
        namespace = request.query.get("namespace", state.db.config.default_namespace)
        ds = state.db.get_dataset(namespace)
        if ds is None:
            return _err(f"Namespace '{namespace}' not found", 404)
        try:
            out = await state.run_sync(ds.suggest, q, limit)
        except Exception as e:
            return _err(f"Failed to suggest: {e}", _exc_status(e))
        return _json({"status": "success", "suggestions": out})


# -- app assembly ------------------------------------------------------------


async def compact_endpoint(request: web.Request) -> web.Response:
    """POST /compact[/{namespace}] — force-merge segments (the explicit
    compactor; README.md:71 promises one, tracing_utils.rs:190 reserves
    its span name, but the reference never implements it)."""
    state = _state(request)
    namespace = request.match_info.get(
        "namespace", state.db.config.default_namespace
    )
    with telemetry.compactor_span(namespace):
        ds = state.db.get_dataset(namespace)
        if ds is None:
            return _err(f"Namespace '{namespace}' not found", 404)
        with telemetry.Timer() as t:
            merged = await state.run_sync(ds.compact)
        return _json(
            {
                "status": "success",
                "namespace": namespace,
                "segments_before": merged,
                "took_ms": t.took_ms,
            }
        )


async def spill_namespace(request: web.Request) -> web.Response:
    """POST /namespaces/{ns}/spill — offload the namespace's segments to
    the cold tier (storage/spill.py; SURVEY §2a S3 row: first-class in
    the rebuild).  Body (optional JSON): {"prefix": "..."} overriding
    the configured ServerConfig.spill_prefix."""
    state = _state(request)
    namespace = request.match_info["namespace"]
    ds = state.db.get_dataset(namespace)
    if ds is None:
        return _err(f"Namespace '{namespace}' not found", 404)
    prefix = None
    if request.can_read_body:
        try:
            body = await request.json()
            prefix = (body or {}).get("prefix")
        except Exception:
            pass
    try:
        with telemetry.Timer() as t:
            counts = await state.run_sync(lambda: ds.spill(prefix))
    except ValueError as e:  # no prefix configured
        return _err(str(e), 400)
    except Exception as e:  # remote-tier I/O failure mid-spill: keep the
        # JSON envelope (segments already offloaded stay cold-marked and
        # restorable via their .spilled markers)
        return _err(f"Spill failed: {e}", 500)
    return _json(
        {
            "status": "success",
            "namespace": namespace,
            "spilled_segments": counts,
            "took_ms": t.took_ms,
        }
    )


async def restore_namespace(request: web.Request) -> web.Response:
    """POST /namespaces/{ns}/restore — bring cold segments back from the
    remote tier (marker-driven; body may override the prefix)."""
    state = _state(request)
    namespace = request.match_info["namespace"]
    ds = state.db.get_dataset(namespace)
    if ds is None:
        return _err(f"Namespace '{namespace}' not found", 404)
    prefix = None
    if request.can_read_body:
        try:
            body = await request.json()
            prefix = (body or {}).get("prefix")
        except Exception:
            pass
    try:
        with telemetry.Timer() as t:
            counts = await state.run_sync(lambda: ds.restore(prefix))
    except Exception as e:
        return _err(f"Restore failed: {e}", 500)
    return _json(
        {
            "status": "success",
            "namespace": namespace,
            "restored_segments": counts,
            "took_ms": t.took_ms,
        }
    )


async def metrics_endpoint(request: web.Request) -> web.Response:
    from fugu_tpu_torch.server.metrics import REGISTRY, escape_label

    state = _state(request)
    # live compaction gauges (write amplification accounting per index)
    lines = []
    # snapshot: namespace create/drop mutates the dict from executor
    # threads while this iterates on the event loop
    for ns, ds in list(state.db.datasets.items()):
        for idx in ds.all_indexes():
            st = idx.compaction_stats
            lbl = (
                f'namespace="{escape_label(ns)}",index="{escape_label(idx.name)}"'
            )
            lines.append(f"fugu_segments{{{lbl}}} {len(idx.segments)}")
            lines.append(f"fugu_compaction_merges{{{lbl}}} {st['merges']}")
            lines.append(
                f"fugu_compaction_docs_written{{{lbl}}} {st['docs_written']}"
            )
            lines.append(
                f"fugu_docs_ingested{{{lbl}}} {st['docs_ingested']}"
            )
    # HBM residency (ops/residency): budget accounting across every
    # resident device pack in the process
    from fugu_tpu_torch.ops import residency

    rs = residency.stats()
    lines.append(f"fugu_device_resident_bytes {rs['resident_bytes']}")
    lines.append(f"fugu_device_resident_packs {rs['resident_packs']}")
    lines.append(f"fugu_device_evictions {rs['evictions']}")
    if rs["budget_bytes"] is not None:
        lines.append(f"fugu_device_mem_budget_bytes {rs['budget_bytes']}")
    for kind, nb in sorted(rs["by_kind"].items()):
        lines.append(
            f'fugu_device_resident_bytes_by_kind{{kind="{kind}"}} {nb}'
        )
    extra = ("\n".join(lines) + "\n") if lines else ""
    return web.Response(
        text=REGISTRY.render() + extra,
        content_type="text/plain",
        charset="utf-8",
    )


async def openapi_json(request: web.Request) -> web.Response:
    return _json(build_openapi(__version__))


async def swagger_ui(request: web.Request) -> web.Response:
    return web.Response(text=SWAGGER_HTML, content_type="text/html")


@web.middleware
async def _otel_middleware(request: web.Request, handler):
    """OtelAxumLayer parity (server_main.rs:71-73): join the caller's
    W3C trace context and wrap the request in a span.  No-op overhead
    when the OTLP pipeline is inactive."""
    if telemetry._otel_tracer is None:
        return await handler(request)
    with telemetry.request_span(
        request.method, request.path, request.headers
    ):
        return await handler(request)


def create_app(db: DatasetManager) -> web.Application:
    app = web.Application(
        client_max_size=256 * 1024 * 1024, middlewares=[_otel_middleware]
    )
    app["state"] = AppState(db)
    telemetry.install_gc_hook()
    r = app.router
    r.add_get("/health", health)
    r.add_get("/hi", sayhi)
    # search
    r.add_get("/search", query_text_get)
    r.add_post("/search", search_endpoint)
    r.add_post("/search/json", query_json_post)
    r.add_get("/search/{query}", query_text_path)
    r.add_post("/search/{namespace}", search_namespace_post)
    # objects
    r.add_get("/objects", list_objects)
    r.add_put("/objects", upsert_objects)
    r.add_get("/objects/{object_id}", get_object_by_id)
    r.add_delete("/objects/{object_id}", delete_object)
    # ingest
    r.add_post("/ingest", ingest_objects)
    r.add_post("/ingest/namespace", ingest_objects_with_namespace_facets)
    r.add_post("/batch/upsert", batch_upsert_objects)
    r.add_post("/add/{namespace}", add_file)
    r.add_post("/demo-index", demo_index)
    # namespaces
    r.add_get("/namespaces", get_available_namespaces)
    r.add_post("/namespaces", create_namespace)
    r.add_delete("/namespaces/{namespace}", delete_namespace)
    r.add_get("/namespaces/{namespace}/facets", get_namespace_facets)
    r.add_get("/namespaces/{namespace}/organizations", get_namespace_organizations)
    r.add_get("/namespaces/{namespace}/conversations", get_namespace_conversations)
    r.add_get("/namespaces/{namespace}/data", get_namespace_data_types)
    # filters
    r.add_get("/filters", list_filters)
    r.add_get("/filters/all", get_all_filters)
    r.add_get("/filters/namespace/{namespace}", get_namespace_filters)
    r.add_get(r"/filters/path/{filter:.+}", get_filter_values_at_path)
    r.add_get("/filters/{namespace}", get_filter)
    # facets
    r.add_get("/facets/tree", get_facet_tree)
    # suggestions
    r.add_get("/suggest", suggest)
    # maintenance
    r.add_post("/compact", compact_endpoint)
    r.add_post("/compact/{namespace}", compact_endpoint)
    r.add_post("/namespaces/{namespace}/spill", spill_namespace)
    r.add_post("/namespaces/{namespace}/restore", restore_namespace)
    # observability
    r.add_get("/metrics", metrics_endpoint)
    # docs
    r.add_get("/api.json", openapi_json)
    r.add_get("/swagger", swagger_ui)
    return app


def start_http_server(
    port: int = DEFAULT_PORT, db: Optional[DatasetManager] = None
) -> None:
    """Bind 0.0.0.0:{port}, serve until SIGINT/SIGTERM
    (server_main.rs:44-147).

    When the manager's indexes run on a CUDA device, the three kernels
    are built and loaded before the socket is bound: a request never
    waits on the compiler, and a kernel that does not build stops the
    server here instead of failing somebody's first query."""
    telemetry.init_tracing()
    if db is None:
        db = DatasetManager.discover()
    if db.use_device:
        from fugu_tpu_torch import cuda_build, device as device_mod

        if device_mod.resolve(db.device).type == "cuda":
            cuda_build.load_all()
            logger.info("CUDA kernels loaded: %s", ", ".join(cuda_build.KERNELS))
    for ns, stats in db.get_all_stats().items():
        logger.info(
            "namespace %s: docs=%d filter=%d query=%d",
            ns,
            stats.docs_count,
            stats.filter_count,
            stats.query_count,
        )
    import os as _os

    if _os.environ.get("FUGU_WARMUP") == "1":
        # pre-trigger the device pack uploads so first queries don't
        # stall on them (the kernels are loaded above).  Real high-df
        # terms matter: made-up terms stage zero posting blocks and
        # touch no pack.
        for ns, ds in db.datasets.items():
            if not ds.stats().docs_count:
                continue
            logger.info("warming up engine for namespace %s ...", ns)
            terms = []
            for seg in ds.docs().searcher_segments():
                table = seg.terms.get("text", {})
                terms.extend(
                    sorted(table, key=lambda t: -table[t].doc_freq)[:2]
                )
            query = " ".join(list(dict.fromkeys(terms))[:2]) or "warmup"
            try:
                # serving default (per_page 20), the bench/API per_page
                # 10, and the filtered boolean variant
                ds.search(query, [], 0, 20)
                ds.search(query, [], 0, 10)
                ds.search(query, [f"/namespace/{ns}"], 0, 20)
            except Exception as e:  # warmup is best-effort
                logger.warning("warmup for %s failed: %s", ns, e)
    app = create_app(db)

    async def _run():
        runner = web.AppRunner(app)
        await runner.setup()
        site = web.TCPSite(runner, "0.0.0.0", port)
        await site.start()
        logger.info("fugu_tpu_torch server listening on 0.0.0.0:%d", port)
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            try:
                loop.add_signal_handler(sig, stop.set)
            except NotImplementedError:  # pragma: no cover
                pass
        sweeper = None
        ttl = getattr(db.config, "spill_idle_ttl_secs", None)
        if ttl and getattr(db.config, "spill_prefix", None):

            async def _idle_sweep():
                # offload idle namespaces to the cold tier; the next
                # query auto-restores (Dataset._ensure_loaded)
                period = min(max(ttl / 2.0, 1.0), 60.0)
                while True:
                    await asyncio.sleep(period)
                    spilled = await loop.run_in_executor(None, db.spill_idle)
                    if spilled:
                        logger.info("idle-spilled namespaces: %s", spilled)

            sweeper = asyncio.create_task(_idle_sweep())
        await stop.wait()
        if sweeper is not None:
            sweeper.cancel()
        logger.info("shutting down (graceful)")
        await runner.cleanup()
        # join in-flight background merges so no half-written segment
        # files are left behind (manifest swaps are atomic regardless)
        db.close()
        # flush buffered OTLP spans (BatchSpanProcessor) before exit
        telemetry.shutdown_tracing()

    asyncio.run(_run())
