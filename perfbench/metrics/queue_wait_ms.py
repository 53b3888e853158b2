"""Mean ms a search waits in the micro-batcher's queue before its batch
is dispatched: ``fugu_search_queue_wait_seconds`` sum over count, as
deltas of ``/metrics`` over the window."""


def read(rec):
    total, count = rec["stages"]["fugu_search_queue_wait_seconds"]
    return total / count * 1e3 if count else None
