"""ms an engine call (a batch of the micro-batcher) spends in the host's
candidate block lists from phase A's answer and the wave-2 thresholds
(``np.nonzero``, ``np.unique``, ``np.partition``): the program's span
``two_phase.candidates`` (``fugu_span_seconds``), its sum over the
window's engine calls (``fugu_search_engine_seconds`` count)."""

from perfbench import program


def read(rec):
    return program.span_ms_per_call(rec, "two_phase.candidates")
