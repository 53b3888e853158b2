"""ms an engine call (a batch of the micro-batcher) spends in the planning
of a batch: ``parse_filters`` and ``build_search_plan`` over its
searches (``Dataset.search_many``): the program's span ``engine.plan``
(``fugu_span_seconds``), its sum over the window's engine calls
(``fugu_search_engine_seconds`` count)."""

from perfbench import program


def read(rec):
    return program.span_ms_per_call(rec, "engine.plan")
