"""The Fused MP kernel (``ops.quant_matmul`` -> ``csrc/mp_matmul.cu``):
``y (M, N) = (x_q @ w_q) * x_scale * w_scale [+ bias]`` with int8
operands and an int32 accumulation on the tensor cores.

Operations: ``2 M K N`` at the int8 peak.  Bytes: the int8 weight and
input read once, the float32 scales and bias read once, the output
written once."""


def cost(M: int, K: int, N: int, *, out_bytes: int = 4,
         bias: bool = False) -> dict:
    nbytes = K * N + M * K + 4 * M + 4 * N + M * N * out_bytes
    if bias:
        nbytes += 4 * N
    return {"ops": {"int8": 2.0 * M * K * N}, "bytes": float(nbytes)}


def cost_of(rec: dict) -> dict:
    """The cost of one recorded call (``harness.probes``)."""
    return cost(rec["M"], rec["K"], rec["N"], out_bytes=rec["out_bytes"],
                bias=rec["bias"])
