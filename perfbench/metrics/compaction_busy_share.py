"""Share of the traced window (%) inside the ``compaction`` span: a merge
of the background compactor, its device merge and its swap."""


def read(rec):
    return 100.0 * rec["spans"]["compaction"] / rec["traced_s"]
