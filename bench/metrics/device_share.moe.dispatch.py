"""The device time launched inside ``model.moe.dispatch`` ranges over
the device's busy time in the profiled part (%): the MoE FFN's dispatch
stage (the scatter of the routed rows into the (E, C, d) buffer;
``models/moe.py`` ``moe_apply``).  A launch belongs to the innermost
range open at its call (``harness.trace.read``).  Nothing where the
program opens no such range."""


def read(run):
    p = run.prof
    r = p and p["ranges"].get("model.moe.dispatch")
    if not r or p["busy_s"] <= 0:
        return None
    return 100.0 * r["device_s"] / p["busy_s"]
