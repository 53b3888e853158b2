"""Searches answered 200 within the window, over the window's seconds:
the live cell's search throughput, beside its tail."""


def read(rec):
    return rec["searches_ok"] / rec["window_s"]
