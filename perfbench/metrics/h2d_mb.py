"""MB (10^6 bytes) of host arrays the search path copies to the card an
engine call: the program's counter ``fugu_h2d_bytes_total`` over every
site (``phase_a``, ``postproc``, ``block_rows``: the staging uploads of
``batch_search`` and ``_dispatch_rows``), over the window's engine calls
(``fugu_search_engine_seconds`` count)."""

from perfbench import program


def read(rec):
    delta = program.window(rec)
    if delta is None or not program.engine_calls(rec):
        return None
    sites = program.family(delta, "fugu_h2d_bytes_total")
    if not sites:
        return None
    return sum(sites) / program.engine_calls(rec) / 1e6
