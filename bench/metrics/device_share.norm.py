"""The device time launched inside ``model.norm`` ranges over the device's
busy time in the profiled part (%): every norm's operators
(``layers.apply_norm``), the final norm's too.  A launch belongs to the
innermost range open at its call (``harness.trace.read``)."""


def read(run):
    p = run.prof
    r = p and p["ranges"].get("model.norm")
    if not r or p["busy_s"] <= 0:
        return None
    return 100.0 * r["device_s"] / p["busy_s"]
