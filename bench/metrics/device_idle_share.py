"""1 - the union of the device's activity intervals over the profiled
wall time (%)."""


def read(run):
    p = run.prof
    if not p or p["window_s"] <= 0 or not p["n_device"]:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
