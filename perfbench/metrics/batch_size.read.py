"""Mean searches a batch of the micro-batcher: searches dispatched
(``fugu_search_queue_wait_seconds`` count) over engine calls
(``fugu_search_engine_seconds`` count), as deltas over the window."""


def read(rec):
    _s, searches = rec["stages"]["fugu_search_queue_wait_seconds"]
    _e, calls = rec["stages"]["fugu_search_engine_seconds"]
    return searches / calls if calls else None
