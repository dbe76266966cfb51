"""The device time launched inside ``model.quant_act`` ranges over the
device's busy time in the profiled part (%): each quantized linear's
smoothing multiply and the per-token int8 quantization of its input
(``layers.linear``), not the kernel call, whose ``bench.quant_matmul``
range lies beside it.  A launch belongs to the innermost range open at
its call (``harness.trace.read``)."""


def read(run):
    p = run.prof
    r = p and p["ranges"].get("model.quant_act")
    if not r or p["busy_s"] <= 0:
        return None
    return 100.0 * r["device_s"] / p["busy_s"]
