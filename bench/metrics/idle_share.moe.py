"""The device's idle time while the host was inside a ``model.moe.*``
range (the idle gaps whose middle's innermost range is one of the MoE
FFN's stages, ``harness.trace.read``) over the profiled part's wall time
(%): how much of the card's waiting the MoE FFN's dispatch makes.
Nothing where the program opens no such range."""

PREFIX = "model.moe."


def read(run):
    p = run.prof
    if not p or p["window_s"] <= 0 or not any(
            k and k.startswith(PREFIX) for k in p["ranges"]):
        return None
    idle = sum(s for k, s in p["idle"].items() if k.startswith(PREFIX))
    return 100.0 * idle / p["window_s"]
