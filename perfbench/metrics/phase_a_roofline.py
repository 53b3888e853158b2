"""Share (%) of its roofline the ``phase_a`` kernel wrapper reached: the
sum of each sampled call's bound (the longer of its bytes at 3.35 TB/s
and its float32 operations at 67 TFLOP/s, from ``perfbench/costs.py``)
over the sum of those calls' kernel time in the profiler's trace."""


def read(rec):
    k = rec["kernels"].get("phase_a")
    if not k or k["device_s"] <= 0:
        return None
    return 100.0 * k["bound_s"] / k["device_s"]
