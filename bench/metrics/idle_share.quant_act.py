"""The device's idle time while the host was inside a ``model.quant_act``
range (the idle gaps whose middle's innermost range it is,
``harness.trace.read``) over the profiled part's wall time (%): how much
of the card's waiting the activation quantization's dispatch makes."""

KEY = "model.quant_act /"


def read(run):
    p = run.prof
    if not p or p["window_s"] <= 0 or "model.quant_act" not in p["ranges"]:
        return None
    idle = sum(s for k, s in p["idle"].items() if k.startswith(KEY))
    return 100.0 * idle / p["window_s"]
