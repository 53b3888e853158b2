"""Host ms a batch inside the ``two_phase`` span (see ``perfbench/spans.py``):
the union of its calls' intervals in the traced window, over the engine
calls (``fugu_search_engine_seconds`` count)."""


def read(rec):
    _e, calls = rec["stages"]["fugu_search_engine_seconds"]
    busy = rec["spans"]["two_phase"]
    return busy / calls * 1e3 if calls and busy else None
