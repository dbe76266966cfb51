"""The MoE FFN with its experts in bf16 (``models/moe.py`` ``moe_apply``
under a configuration's ``expert_dtype`` ``bfloat16``; float32 router):
``T`` tokens, each through ``k`` of ``E`` experts of width ``f``, three
products each (two with a gate bank).

Operations: what the routing needs, ``2 T k d f`` per product, at the
bf16 peak, plus the router's ``2 T d E`` at the float32 peak.  Bytes:
the touched experts' banks once at 2 bytes an element, the router's
weight once at 4, the tokens read and the output written once in the
stream's type.  The touched experts are counted as uniform routing
touches them on average, ``E (1 - (1 - k / E) ** T)`` (62.9 of 64 at
T 32 and k 8; k at T 1), since which experts a call touched is a device
value that nothing here reads."""


def touched(T: int, E: int, k: int) -> float:
    """Experts a call of ``T`` tokens touches on average under uniform
    top-``k`` routing."""
    return E * (1.0 - (1.0 - k / E) ** T)


def cost(T: int, d: int, f: int, E: int, k: int, *, gated: bool = True,
         x_bytes: int = 4) -> dict:
    mats = 3 if gated else 2
    ops = {"bf16": 2.0 * T * k * d * f * mats, "fp32": 2.0 * T * d * E}
    nbytes = (2.0 * touched(T, E, k) * mats * d * f + 4.0 * d * E
              + 2.0 * x_bytes * T * d)
    return {"ops": ops, "bytes": nbytes}
