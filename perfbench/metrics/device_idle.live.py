"""Share (%) of the traced window in which no kernel, copy or memset ran
on the device: 1 minus the union of their intervals over the window."""


def read(rec):
    dev = rec["device"]
    if not dev or dev["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - dev["busy_s"] / dev["window_s"])
