"""The device time launched inside ``model.head`` ranges over the device's
busy time in the profiled part (%): the head (``lm._logits``: GPT-2's
tied float32 head), its final norm aside (``model.norm``).  A launch
belongs to the innermost range open at its call
(``harness.trace.read``)."""


def read(run):
    p = run.prof
    r = p and p["ranges"].get("model.head")
    if not r or p["busy_s"] <= 0:
        return None
    return 100.0 * r["device_s"] / p["busy_s"]
