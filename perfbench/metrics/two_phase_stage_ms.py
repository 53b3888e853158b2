"""ms an engine call (a batch of the micro-batcher) spends in the two-
phase batch's host staging and kernel launches (``batch_search``'s
phase-A and postproc streams, ``block_search_begin`` and
``_dispatch_rows``): the program's span ``two_phase.stage``
(``fugu_span_seconds``), its sum over the window's engine calls
(``fugu_search_engine_seconds`` count)."""

from perfbench import program


def read(rec):
    return program.span_ms_per_call(rec, "two_phase.stage")
