"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit): the yardstick of
every roofline and of ``step_mfu``.  Operations are counted per precision
of the unit that runs them; float32 outside the tensor cores (TF32 off)."""

PEAK_OPS = {
    "int8": 1979e12,
    "fp8": 1979e12,
    "bf16": 989e12,
    "fp16": 989e12,
    "tf32": 495e12,
    "fp32": 67e12,
}
HBM_BYTES_S = 3.35e12


def bound_s(ops: dict, nbytes: float) -> float:
    """The least time a call can take: the larger of its operations over
    their precisions' peaks (summed) and its bytes over HBM bandwidth."""
    t_ops = sum(n / PEAK_OPS[p] for p, n in ops.items())
    return max(t_ops, nbytes / HBM_BYTES_S)
