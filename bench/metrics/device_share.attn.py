"""The device time launched inside ``model.attn`` ranges over the device's
busy time in the profiled part (%): the attention mixers' own operators
(the q/k/v reshapes, the cache or page writes, the lengths); their
linears' input quantization is ``model.quant_act``'s and their kernels
lie in the benchmark's ``bench.*`` ranges inside.  A launch belongs to
the innermost range open at its call (``harness.trace.read``)."""


def read(run):
    p = run.prof
    r = p and p["ranges"].get("model.attn")
    if not r or p["busy_s"] <= 0:
        return None
    return 100.0 * r["device_s"] / p["busy_s"]
