"""ms an engine call (a batch of the micro-batcher) spends in the
conversion of its hits to results (``_convert_hit``, which reads each
hit's stored doc): the program's span ``engine.convert``
(``fugu_span_seconds``), its sum over the window's engine calls
(``fugu_search_engine_seconds`` count)."""

from perfbench import program


def read(rec):
    return program.span_ms_per_call(rec, "engine.convert")
