"""The device time launched inside ``model.mlp_act`` ranges over the
device's busy time in the profiled part (%): the MLP's activation
(``layers.mlp``; GPT-2's tanh GELU).  A launch belongs to the innermost
range open at its call (``harness.trace.read``)."""


def read(run):
    p = run.prof
    r = p and p["ranges"].get("model.mlp_act")
    if not r or p["busy_s"] <= 0:
        return None
    return 100.0 * r["device_s"] / p["busy_s"]
