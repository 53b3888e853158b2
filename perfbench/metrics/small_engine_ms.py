"""Host ms a batch inside the ``small_engine`` span (see ``perfbench/spans.py``):
the union of its calls' intervals in the traced window, over the engine
calls (``fugu_search_engine_seconds`` count)."""


def read(rec):
    _e, calls = rec["stages"]["fugu_search_engine_seconds"]
    busy = rec["spans"]["small_engine"]
    return busy / calls * 1e3 if calls and busy else None
