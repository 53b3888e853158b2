"""Mean ms of an engine call (``Dataset.search_many`` on a batch):
``fugu_search_engine_seconds`` sum over count, as deltas over the
window."""


def read(rec):
    total, count = rec["stages"]["fugu_search_engine_seconds"]
    return total / count * 1e3 if count else None
