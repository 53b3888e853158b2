"""Tracing / structured logging — the tracing_utils + otel_setup analog.

The reference runs two overlapping systems (SURVEY.md §5): `tracing` spans
with per-component constructors (upstream `src/tracing_utils.rs:149-235`
— cli/server/database/compactor/query spans) plus an OTLP OpenTelemetry
pipeline (upstream `src/otel_setup.rs`).  Here:

- the same span taxonomy via a contextvar-based Span that logs structured
  enter/exit lines with durations (console + optional logs/fugu.log file,
  mirroring tracing_utils.rs:14-95)
- a REAL OTLP pipeline (otel_setup.rs:28-62 parity): when
  OTEL_EXPORTER_OTLP_ENDPOINT is set and the `opentelemetry` SDK is
  importable, init assembles TracerProvider + Resource (service
  name/version detection) + BatchSpanProcessor + OTLP exporter, installs
  the global provider and a W3C TraceContext+Baggage composite
  propagator, and every span() mirrors into it;
  ``extract_context``/``request_span`` give the HTTP layer the
  OtelAxumLayer-equivalent (incoming traceparent joins the trace).  The
  CI image ships without the SDK, so it degrades to logging (tested
  against a recording stub SDK in test_observability)
- `took_ms` timing helper — the response field API.md promises but the
  reference never implemented (API.md:108-115); we do.
"""

from __future__ import annotations

import contextlib
import contextvars
import logging
import os
import sys
import time
from pathlib import Path
from typing import Iterator, Optional

logger = logging.getLogger("fugu_tpu_torch")

_current_span: contextvars.ContextVar[Optional[str]] = contextvars.ContextVar(
    "fugu_span", default=None
)

_otel_tracer = None
_otel_provider = None


def init_tracing(
    level: str = "INFO",
    log_file: Optional[str] = "logs/fugu.log",
    console: bool = True,
) -> None:
    """Console + file subscriber (tracing_utils.rs:14-95)."""
    root = logging.getLogger("fugu_tpu_torch")
    root.setLevel(os.environ.get("FUGU_LOG", level).upper())
    for h in root.handlers:  # close before dropping: a cleared
        try:  # FileHandler otherwise leaks its fd per re-init
            h.close()
        except Exception:
            pass
    root.handlers.clear()
    fmt = logging.Formatter(
        "%(asctime)s %(levelname)s %(name)s [%(span)s] %(message)s"
    )

    class SpanFilter(logging.Filter):
        def filter(self, record):
            record.span = _current_span.get() or "-"
            return True

    if console:
        h = logging.StreamHandler()
        h.setFormatter(fmt)
        h.addFilter(SpanFilter())
        root.addHandler(h)
    if log_file:
        try:
            Path(log_file).parent.mkdir(parents=True, exist_ok=True)
            fh = logging.FileHandler(log_file)
            fh.setFormatter(fmt)
            fh.addFilter(SpanFilter())
            root.addHandler(fh)
        except OSError:
            pass

    global _otel_tracer
    _otel_tracer = _init_otel()


def _init_otel():
    """Assemble the OTLP pipeline (otel_setup.rs:28-62 parity): resource
    detection -> TracerProvider -> BatchSpanProcessor(OTLP exporter) ->
    global provider + W3C composite propagator.  Returns the tracer, or
    None when the endpoint is unset / the SDK is missing (log-only
    degrade).  Split out so tests can exercise the full assembly with a
    stubbed SDK."""
    global _otel_provider
    endpoint = os.environ.get("OTEL_EXPORTER_OTLP_ENDPOINT")
    if not endpoint:
        return None
    if _otel_provider is not None:
        # already assembled (init_tracing runs in both run_cli and
        # start_http_server): reuse it.  Building a second provider
        # would be ignored by set_tracer_provider (override refused)
        # while overwriting _otel_provider — shutdown would then flush
        # the EMPTY provider and drop the real one's buffered spans.
        return _otel_provider.get_tracer("fugu_tpu_torch")
    try:
        from opentelemetry import propagate, trace
        from opentelemetry.baggage.propagation import W3CBaggagePropagator
        from opentelemetry.exporter.otlp.proto.grpc.trace_exporter import (
            OTLPSpanExporter,
        )
        from opentelemetry.propagators.composite import CompositePropagator
        from opentelemetry.sdk.resources import Resource
        from opentelemetry.sdk.trace import TracerProvider
        from opentelemetry.sdk.trace.export import BatchSpanProcessor
        from opentelemetry.trace.propagation.tracecontext import (
            TraceContextTextMapPropagator,
        )
    except ImportError:
        logger.info(
            "OTLP endpoint set but opentelemetry not installed; spans log-only"
        )
        return None

    try:
        from fugu_tpu_torch import __version__ as _version
    except Exception:
        _version = "0"
    resource = Resource.create(
        {
            "service.name": os.environ.get("OTEL_SERVICE_NAME", "fugu"),
            "service.version": _version,
        }
    )
    provider = TracerProvider(resource=resource)
    provider.add_span_processor(
        BatchSpanProcessor(OTLPSpanExporter(endpoint=endpoint))
    )
    # best-effort global install (third-party instrumentation reads it);
    # it REFUSES overrides, so after a shutdown_tracing -> init_tracing
    # cycle the old shut-down provider stays global and would silently
    # drop every span — which is why the tracer below (and the reuse
    # branch above) come from OUR provider, never trace.get_tracer()
    trace.set_tracer_provider(provider)
    propagate.set_global_textmap(
        CompositePropagator(
            [TraceContextTextMapPropagator(), W3CBaggagePropagator()]
        )
    )
    _otel_provider = provider
    return provider.get_tracer("fugu_tpu_torch")


def shutdown_tracing() -> None:
    """Flush + shut down the OTLP pipeline (graceful server shutdown —
    BatchSpanProcessor buffers spans; a hard exit would drop them)."""
    global _otel_provider, _otel_tracer
    if _otel_provider is not None:
        try:
            _otel_provider.shutdown()
        except Exception:
            logger.exception("otel provider shutdown failed")
        _otel_provider = None
        _otel_tracer = None


def extract_context(headers) -> Optional[object]:
    """Incoming W3C trace context (traceparent/baggage headers) via the
    installed propagator — the OtelAxumLayer-extraction analog.  None
    when the pipeline is inactive."""
    if _otel_provider is None:
        return None
    try:
        from opentelemetry import propagate

        return propagate.extract(dict(headers))
    except Exception:
        return None


@contextlib.contextmanager
def request_span(method: str, path: str, headers=None) -> Iterator[None]:
    """HTTP request span joined to the caller's trace when a traceparent
    header is present (OtelAxumLayer parity, server_main.rs:71-73)."""
    ctx = extract_context(headers or {})
    if _otel_tracer is None:
        with span("server", f"{method} {path}"):
            yield
        return
    otel_ctx = _otel_tracer.start_as_current_span(
        f"{method} {path}", context=ctx
    )
    otel_ctx.__enter__()
    try:
        with span("server", f"{method} {path}"):
            yield
    finally:
        # hand the live exception to use_span so failed requests export
        # with record_exception + ERROR status, not as OK spans
        otel_ctx.__exit__(*sys.exc_info())


@contextlib.contextmanager
def span(component: str, name: str, **fields) -> Iterator[None]:
    """Named span: logs entry/exit with duration; nests via contextvar."""
    label = f"{component}:{name}"
    token = _current_span.set(label)
    start = time.perf_counter()
    ctx = None
    if _otel_tracer is not None:
        ctx = _otel_tracer.start_as_current_span(label)
        ctx.__enter__()
    try:
        yield
    finally:
        dur_ms = (time.perf_counter() - start) * 1000
        logger.debug("%s done in %.2fms %s", label, dur_ms, fields or "")
        if ctx is not None:
            ctx.__exit__(*sys.exc_info())
        _current_span.reset(token)


def cli_span(name: str):
    return span("cli", name)


def server_span(route: str, method: str):
    return span("server", f"{method} {route}")


def db_span(name: str):
    return span("database", name)


def compactor_span(name: str):
    return span("compactor", name)


def query_span(name: str):
    return span("query", name)


class Timer:
    """took_ms helper."""

    def __enter__(self):
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.took_ms = round((time.perf_counter() - self._start) * 1000, 3)
        return False
