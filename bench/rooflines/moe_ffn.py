"""The MoE FFN (``models/moe.py`` ``moe_apply``; plain PyTorch, float32
router and experts): ``T`` tokens, each through ``k`` of ``E`` experts
of width ``f``, three products each (two with a gate bank).

Operations: what the routing needs, ``2 T k d f`` per product, plus the
router's ``2 T d E``, at the float32 peak.  Bytes: the router once, and
every touched expert's banks once; with no device read the touched
experts are taken as ``min(E, T k)`` (at T 32 and k 8, 256 choices over
64 experts touch 62.9 of them on average under uniform routing, so this
counts about 2% more than uniform routing needs); the tokens read and the
output written once."""


def cost(T: int, d: int, f: int, E: int, k: int, *,
         gated: bool = True) -> dict:
    mats = 3 if gated else 2
    touched = min(E, T * k)
    ops = 2.0 * T * k * d * f * mats + 2.0 * T * d * E
    nbytes = 4.0 * (touched * mats * d * f + d * E + 2 * T * d + T * E)
    return {"ops": {"fp32": ops}, "bytes": nbytes}
