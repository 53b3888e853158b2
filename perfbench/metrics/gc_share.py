"""Share (%) of the traced window's seconds that the run's process spent
in garbage collections: the program's histogram ``fugu_gc_seconds``
(every generation) summed between the two ``/metrics`` scrapes that
bracket the window, over ``rec["traced_s"]``.

The server and the harness share that process, and the scrapes bracket
more than the window: the profiler's start and teardown, the device's
synchronize and the hand-back of the load client's answers.  So the
numerator also counts the collections there, and in a traced run those
of the harness's own work (its operand clones among them); the share
reads high by what they take."""

from perfbench import program


def read(rec):
    delta = program.window(rec)
    if delta is None or rec["traced_s"] <= 0:
        return None
    sums = program.family(delta, "fugu_gc_seconds_sum")
    if not sums:
        return None
    return 100.0 * sum(sums) / rec["traced_s"]
