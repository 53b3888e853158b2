"""ms of the app's own work a search: the program's spans
``front.parse`` (from the handler's entry to the engine's queue: the
body read, JSON decoding, validation, filters and paging) and
``front.respond`` (from the engine's answer to the response: the
response's dict, the text stripped, the aliases and ``json.dumps``),
their sums over the window's searches (``front.parse`` count)."""

from perfbench import program


def read(rec):
    delta = program.window(rec)
    parse = 'fugu_span_seconds_{}{{span="front.parse"}}'
    respond = 'fugu_span_seconds_sum{span="front.respond"}'
    if delta is None or parse.format("sum") not in delta:
        return None
    searches = delta[parse.format("count")]
    if not searches:
        return None
    total = delta[parse.format("sum")] + delta.get(respond, 0.0)
    return total / searches * 1e3
