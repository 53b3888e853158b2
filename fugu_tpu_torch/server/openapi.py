"""OpenAPI document + Swagger UI page (server_main.rs:21-43, 68-69 analog)."""

from __future__ import annotations

from typing import Any, Dict

OBJECT_RECORD_SCHEMA = {
    "type": "object",
    "required": ["id", "text"],
    "properties": {
        "id": {"type": "string", "maxLength": 256},
        "text": {"type": "string", "maxLength": 10000},
        "metadata": {"type": "object", "nullable": True},
        "namespace": {"type": "string", "nullable": True, "maxLength": 128},
        "facets": {
            "type": "array",
            "items": {"type": "string", "maxLength": 512},
            "maxItems": 100,
            "nullable": True,
        },
        "organization": {"type": "string", "nullable": True},
        "conversation_id": {"type": "string", "nullable": True},
        "data_type": {"type": "string", "nullable": True},
        "date_created": {"type": "string", "format": "date-time", "nullable": True},
        "date_updated": {"type": "string", "format": "date-time", "nullable": True},
        "date_published": {"type": "string", "format": "date-time", "nullable": True},
    },
}

SEARCH_RESULT_SCHEMA = {
    "type": "object",
    "properties": {
        "id": {"type": "string"},
        "score": {"type": "number"},
        "text": {"type": "string"},
        "metadata": {"nullable": True},
        "facets": {"type": "array", "items": {"type": "string"}, "nullable": True},
    },
}

SEARCH_RESPONSE_SCHEMA = {
    "type": "object",
    "properties": {
        "results": {"type": "array", "items": SEARCH_RESULT_SCHEMA},
        "total": {"type": "integer"},
        "page": {"type": "integer"},
        "per_page": {"type": "integer"},
        "query": {"type": "string"},
        "took_ms": {"type": "number"},
    },
}


def _op(summary: str, **kw) -> Dict[str, Any]:
    out = {"summary": summary, "responses": {"200": {"description": "OK"}}}
    out.update(kw)
    return out


def _body(schema: Dict[str, Any]) -> Dict[str, Any]:
    return {
        "required": True,
        "content": {"application/json": {"schema": schema}},
    }


def build_openapi(version: str) -> Dict[str, Any]:
    records_body = _body(
        {
            "type": "object",
            "properties": {
                "data": {"type": "array", "items": {"$ref": "#/components/schemas/ObjectRecord"}}
            },
        }
    )
    q_params = [
        {"name": "q", "in": "query", "required": True, "schema": {"type": "string"}},
        {"name": "namespace", "in": "query", "schema": {"type": "string"}},
        {"name": "limit", "in": "query", "schema": {"type": "integer"}},
        {"name": "text", "in": "query", "schema": {"type": "boolean"}},
        {"name": "include_data", "in": "query", "schema": {"type": "boolean"}},
    ]
    ns_param = {
        "name": "namespace",
        "in": "path",
        "required": True,
        "schema": {"type": "string"},
    }
    paths: Dict[str, Any] = {
        "/health": {"get": _op("Check the health of the server.")},
        "/hi": {"get": _op("Server says hi")},
        "/search": {
            "get": _op("Execute a text query via GET.", parameters=q_params),
            "post": _op(
                "Search endpoint returning full facet paths for each result.",
                requestBody=_body(
                    {
                        # no `required`: the handler defaults query to ""
                        "type": "object",
                        "properties": {
                            "query": {"type": "string"},
                            "filters": {"type": "array", "items": {"type": "string"}},
                            "page": {
                                "type": "object",
                                "properties": {
                                    "page": {"type": "integer"},
                                    "per_page": {"type": "integer"},
                                },
                            },
                        },
                    }
                ),
            ),
        },
        "/search/json": {
            "post": _op(
                "Execute a JSON query via POST.",
                requestBody=_body(
                    {
                        "type": "object",
                        "required": ["query"],
                        "properties": {
                            "query": {"type": "string"},
                            "namespace": {"type": "string"},
                            "filters": {"type": "array", "items": {"type": "string"}},
                            "page": {"type": "object"},
                            "text": {"type": "boolean"},
                            "include_data": {"type": "boolean"},
                        },
                    }
                ),
            )
        },
        "/search/{query}": {
            "get": _op(
                "Execute a text query via URL path (URL-encoded).",
                parameters=[
                    {
                        "name": "query",
                        "in": "path",
                        "required": True,
                        "schema": {"type": "string"},
                    }
                ],
            )
        },
        "/search/{namespace}": {
            "post": _op(
                "Search within one namespace.",
                parameters=[ns_param],
                requestBody=_body(
                    {
                        "type": "object",
                        "required": ["query"],
                        "properties": {"query": {"type": "string"}},
                    }
                ),
            )
        },
        "/objects": {
            "get": _op("List stored objects (paginated)."),
            "put": _op("Upsert objects.", requestBody=records_body),
        },
        "/objects/{object_id}": {
            "get": _op(
                "Get a specific object by ID.",
                parameters=[
                    {
                        "name": "object_id",
                        "in": "path",
                        "required": True,
                        "schema": {"type": "string"},
                    }
                ],
            ),
            "delete": _op(
                "Delete an object by ID.",
                parameters=[
                    {
                        "name": "object_id",
                        "in": "path",
                        "required": True,
                        "schema": {"type": "string"},
                    }
                ],
            ),
        },
        "/ingest": {"post": _op("Ingest (upsert) objects.", requestBody=records_body)},
        "/ingest/namespace": {
            "post": _op(
                "Ingest objects with namespace facet support.",
                requestBody=records_body,
            )
        },
        "/batch/upsert": {
            "post": _op(
                "Batch upsert objects.",
                requestBody=_body(
                    {
                        "type": "object",
                        "properties": {
                            "objects": {
                                "type": "array",
                                "items": {"$ref": "#/components/schemas/ObjectRecord"},
                            }
                        },
                    }
                ),
            )
        },
        "/add/{namespace}": {
            "post": _op(
                "Add a file's content as a document.",
                parameters=[ns_param],
                requestBody=_body(
                    {
                        "type": "object",
                        "required": ["name", "body"],
                        "properties": {
                            "name": {"type": "string"},
                            "body": {"type": "string"},
                        },
                    }
                ),
            )
        },
        "/demo-index": {"post": _op("Create a demo item.")},
        "/namespaces": {
            "get": _op("List available namespaces."),
            "post": _op(
                "Create a namespace.",
                requestBody=_body(
                    {
                        "type": "object",
                        "required": ["name"],
                        "properties": {"name": {"type": "string"}},
                    }
                ),
            ),
        },
        "/namespaces/{namespace}": {
            "delete": _op("Delete a namespace.", parameters=[ns_param])
        },
        "/namespaces/{namespace}/facets": {
            "get": _op("Namespace facets.", parameters=[ns_param])
        },
        "/namespaces/{namespace}/organizations": {
            "get": _op("Namespace organizations.", parameters=[ns_param])
        },
        "/namespaces/{namespace}/conversations": {
            "get": _op("Namespace conversations.", parameters=[ns_param])
        },
        "/namespaces/{namespace}/data": {
            "get": _op("Namespace data types.", parameters=[ns_param])
        },
        "/namespaces/{namespace}/spill": {
            "post": _op(
                "Offload the namespace's segments to the cold (remote) "
                "tier; body may carry {\"prefix\": ...} overriding the "
                "configured spill prefix.",
                parameters=[ns_param],
            )
        },
        "/namespaces/{namespace}/restore": {
            "post": _op(
                "Restore the namespace's cold segments from the remote "
                "tier (marker-driven when no prefix is given). Queries "
                "against a cold namespace auto-restore by default; with "
                "auto-restore disabled they return 409 rather than "
                "silently-partial results.",
                parameters=[ns_param],
            )
        },
        "/filters": {"get": _op("List all filters.")},
        "/filters/all": {"get": _op("All filter paths with leaf values.")},
        "/filters/namespace/{namespace}": {
            "get": _op("Filter paths for a namespace.", parameters=[ns_param])
        },
        "/filters/path/{filter}": {
            "get": _op(
                "Filter values at a path.",
                parameters=[
                    {
                        "name": "filter",
                        "in": "path",
                        "required": True,
                        "schema": {"type": "string"},
                    }
                ],
            )
        },
        "/filters/{namespace}": {
            "get": _op(
                "Get filter for a specific namespace (legacy endpoint).",
                parameters=[ns_param],
            )
        },
        "/facets/tree": {
            "get": _op(
                "Complete facet tree.",
                parameters=[
                    {
                        "name": "max_depth",
                        "in": "query",
                        "schema": {"type": "integer"},
                    }
                ],
            )
        },
        "/suggest": {
            "get": _op(
                "Query suggestions from the query index.",
                parameters=[
                    {"name": "q", "in": "query", "schema": {"type": "string"}}
                ],
            )
        },
        "/compact": {
            "post": _op("Compact every namespace's indexes (explicit merge).")
        },
        "/compact/{namespace}": {
            "post": _op(
                "Compact one namespace's indexes.", parameters=[ns_param]
            )
        },
        "/metrics": {
            "get": _op("Prometheus text exposition of server metrics.")
        },
    }
    return {
        "openapi": "3.0.3",
        "info": {
            "title": "Fugu",
            "description": "TPU-native namespace-scoped full-text search",
            "version": version,
        },
        "paths": paths,
        "components": {
            "schemas": {
                "ObjectRecord": OBJECT_RECORD_SCHEMA,
                "SearchResult": SEARCH_RESULT_SCHEMA,
                "SearchResponse": SEARCH_RESPONSE_SCHEMA,
            }
        },
    }


SWAGGER_HTML = """<!DOCTYPE html>
<html>
<head>
  <title>Fugu API — Swagger UI</title>
  <link rel="stylesheet" href="https://unpkg.com/swagger-ui-dist@5/swagger-ui.css">
</head>
<body>
  <div id="swagger-ui"></div>
  <script src="https://unpkg.com/swagger-ui-dist@5/swagger-ui-bundle.js"></script>
  <script>
    window.onload = () => {
      window.ui = SwaggerUIBundle({ url: '/api.json', dom_id: '#swagger-ui' });
    };
  </script>
  <noscript>OpenAPI spec is served at <a href="/api.json">/api.json</a>.</noscript>
</body>
</html>
"""
