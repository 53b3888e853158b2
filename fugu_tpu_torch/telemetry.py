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

The search path's spans are also its measurements (:func:`span`): each
adds its seconds to ``fugu_span_seconds{span=...}`` in ``/metrics`` and,
while a ``torch.profiler`` records, opens a ``fugu.*`` range on the
profiler's timeline.  Its layers open them: ``front.parse`` and
``front.respond`` (``server/app.py``); ``engine.batch`` (a range and a log
line only) and in it ``engine.plan``, ``engine.route``
(``NamedIndex.search_topk_batch``) and
``engine.convert`` (``Dataset.search_many``); in ``engine.route``,
``two_phase.stage``, ``two_phase.fetch``, ``two_phase.candidates`` and
``two_phase.rescore`` (``ops/batch_scorer.py``,
``ops/block_scorer.py``).  :func:`count` adds
the bytes those two modules copy to and from the card
(``fugu_h2d_bytes_total`` / ``fugu_d2h_bytes_total{site=...}``), and
:func:`install_gc_hook` times the process's garbage collections.
"""

from __future__ import annotations

import contextlib
import contextvars
import gc
import itertools
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

#: the innermost open span of this context (its parent, its fields)
_open_span: contextvars.ContextVar[Optional["_Span"]] = contextvars.ContextVar(
    "fugu_open_span", default=None
)

_otel_tracer = None
_otel_provider = None

_batches = itertools.count(1)
_gc_installed = False
_gc_start = 0.0
_gc_ann = None


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
        with span("server", f"{method} {path}", observe=False):
            yield
        return
    otel_ctx = _otel_tracer.start_as_current_span(
        f"{method} {path}", context=ctx
    )
    otel_ctx.__enter__()
    try:
        with span("server", f"{method} {path}", observe=False):
            yield
    finally:
        # hand the live exception to use_span so failed requests export
        # with record_exception + ERROR status, not as OK spans
        otel_ctx.__exit__(*sys.exc_info())


class _Span:
    """One open span: see :func:`span`."""

    __slots__ = ("component", "name", "fields", "observe", "parent",
                 "_absorbed", "_tokens", "_start", "_otel", "_otel_span",
                 "_ann")

    def __init__(self, component: str, name: str, observe: bool, fields):
        self.component = component
        self.name = name
        self.observe = observe
        self.fields = fields
        self.parent: Optional[_Span] = None
        self._otel = self._otel_span = self._ann = None

    def __enter__(self):
        outer = _open_span.get()
        self._absorbed = (outer is not None and outer.name == self.name
                          and outer.component == self.component)
        if self._absorbed:
            return self
        self.parent = outer
        label = f"{self.component}:{self.name}"
        self._tokens = (_open_span.set(self), _current_span.set(label))
        if _otel_tracer is not None:
            self._otel = _otel_tracer.start_as_current_span(label)
            self._otel_span = self._otel.__enter__()
            _set_attributes(self._otel_span, self.fields)
        prof = _profiler()
        if prof is not None:
            self._ann = prof.record_function(
                f"fugu.{self.component}.{self.name}")
            self._ann.__enter__()
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._absorbed:
            return False
        seconds = time.perf_counter() - self._start
        if self._ann is not None:
            self._ann.__exit__(None, None, None)
        if self.observe:
            registry = _registry()
            if registry is not None:
                registry.observe("fugu_span_seconds", seconds,
                                 span=f"{self.component}.{self.name}")
        if logger.isEnabledFor(logging.DEBUG):
            parent = self.parent
            logger.debug(
                "%s:%s done in %.2fms parent=%s %s", self.component,
                self.name, seconds * 1000,
                parent and f"{parent.component}:{parent.name}",
                self.fields or "",
            )
        if self._otel is not None:
            self._otel.__exit__(*exc)
        _current_span.reset(self._tokens[1])
        _open_span.reset(self._tokens[0])
        return False


def span(component: str, name: str, *, observe: bool = True, **fields):
    """Named span, nested through a contextvar (it knows its parent).

    - Its seconds go to ``fugu_span_seconds{span="<component>.<name>"}``
      in ``server/metrics.REGISTRY`` (``/metrics``) once the process has
      loaded that module (a process that serves ``/metrics`` has);
      ``observe=False`` keeps a span out of it (the request spans and
      the component helpers below, whose names come from the input, and
      ``engine.batch``, whose seconds the batcher's
      ``fugu_search_engine_seconds`` already holds).  Clock:
      ``time.perf_counter``.
    - While a ``torch.profiler`` records, it also opens
      ``record_function("fugu.<component>.<name>")``, so that the span
      lies on the device trace's clock beside the work it launched.  A
      profiler records the ranges of the thread that started it, or of
      every thread when started with
      ``_ExperimentalConfig(profile_all_threads=True)``.
    - It logs its end at DEBUG with its duration, parent and ``fields``,
      and mirrors into the OTLP tracer when one is configured, the
      fields as attributes.

    A span opened inside a span of the same name is part of it and
    records nothing of its own, so that the self times of a layer's
    spans add up."""
    return _Span(component, name, observe, fields)


def annotate(**fields) -> None:
    """Add ``fields`` to the innermost open span of this context (its
    log line and its OTLP attributes); a field of None is left out."""
    fields = {k: v for k, v in fields.items() if v is not None}
    current = _open_span.get()
    if current is not None and fields:
        current.fields.update(fields)
        if current._otel_span is not None:
            _set_attributes(current._otel_span, fields)


def count(name: str, value: float, **labels) -> None:
    """Add ``value`` to the counter ``name`` in ``server/metrics``'s
    registry, once the process has loaded it (see :func:`span`)."""
    registry = _registry()
    if registry is not None:
        registry.inc(name, value, **labels)


def next_batch() -> int:
    """A process-wide sequence number for an engine batch."""
    return next(_batches)


def install_gc_hook() -> None:
    """Time every garbage collection of this process, once however often
    it is called: ``fugu_gc_seconds{generation="0|1|2"}`` in the
    registry, and a ``fugu.gc`` range while a profiler records."""
    global _gc_installed
    if not _gc_installed:
        _gc_installed = True
        gc.callbacks.append(_gc_callback)


def _gc_callback(phase: str, info: dict) -> None:
    # collections never overlap (the interpreter runs one at a time), so
    # module state carries a collection's start to its stop; the
    # registry's lock may be held by this very thread, hence observe_later
    global _gc_start, _gc_ann
    if phase == "start":
        prof = _profiler()
        if prof is not None:
            _gc_ann = prof.record_function("fugu.gc")
            _gc_ann.__enter__()
        _gc_start = time.perf_counter()
        return
    seconds = time.perf_counter() - _gc_start
    if _gc_ann is not None:
        _gc_ann.__exit__(None, None, None)
        _gc_ann = None
    registry = _registry()
    if registry is not None:
        registry.observe_later("fugu_gc_seconds", seconds,
                               generation=str(info["generation"]))


def _profiler():
    """torch's profiler module while a ``torch.profiler`` records, else
    None: one flag read, and torch is never imported here."""
    prof = sys.modules.get("torch.autograd.profiler")
    if prof is not None and prof._is_profiler_enabled:
        return prof
    return None


def _registry():
    metrics = sys.modules.get("fugu_tpu_torch.server.metrics")
    return None if metrics is None else metrics.REGISTRY


def _set_attributes(otel_span, fields) -> None:
    setter = getattr(otel_span, "set_attribute", None)
    if setter is not None:
        for key, value in fields.items():
            setter(key, value if isinstance(value, (str, bool, int, float))
                   else str(value))


def cli_span(name: str):
    # the component helpers' spans log and export to OTLP only: their
    # names come from routes, namespaces and callers, so histograms of
    # them would grow with the input, and no metric reads them
    return span("cli", name, observe=False)


def server_span(route: str, method: str):
    return span("server", f"{method} {route}", observe=False)


def compactor_span(name: str):
    return span("compactor", name, observe=False)


def query_span(name: str):
    return span("query", name, observe=False)


class Timer:
    """took_ms helper."""

    def __enter__(self):
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.took_ms = round((time.perf_counter() - self._start) * 1000, 3)
        return False
