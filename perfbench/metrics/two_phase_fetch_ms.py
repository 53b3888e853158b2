"""ms an engine call (a batch of the micro-batcher) spends in the host
blocked on the card's answers and their copies to the host (``.cpu()``
of the candidate masks, maxima and block-scorer candidates): the
program's span ``two_phase.fetch`` (``fugu_span_seconds``), its sum over
the window's engine calls (``fugu_search_engine_seconds`` count)."""

from perfbench import program


def read(rec):
    return program.span_ms_per_call(rec, "two_phase.fetch")
