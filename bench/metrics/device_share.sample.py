"""The device time launched inside ``engine.sample`` ranges over the
device's busy time in the profiled part (%): each tick's sampler
(``ServeEngine._sample``), its parameters' and tokens' copies aside
(``engine.sync``).  A launch belongs to the innermost range open at its
call (``harness.trace.read``)."""


def read(run):
    p = run.prof
    r = p and p["ranges"].get("engine.sample")
    if not r or p["busy_s"] <= 0:
        return None
    return 100.0 * r["device_s"] / p["busy_s"]
