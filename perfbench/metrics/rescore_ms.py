"""ms an engine call (a batch of the micro-batcher) spends in the exact
host rescore of the block scorer's candidates (``rescore_hits``) and
their hit lists: the program's span ``two_phase.rescore``
(``fugu_span_seconds``), its sum over the window's engine calls
(``fugu_search_engine_seconds`` count)."""

from perfbench import program


def read(rec):
    return program.span_ms_per_call(rec, "two_phase.rescore")
