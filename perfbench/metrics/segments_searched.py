"""Mean live segments of the docs index at each engine call in the
traced window."""


def read(rec):
    seg = rec["segments"]
    return sum(seg) / len(seg) if seg else None
