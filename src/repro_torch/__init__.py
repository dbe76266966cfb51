"""PyTorch + CUDA port of the LoopLynx serving stack for an NVIDIA H100.

The JAX package ``repro`` is the reference; this package imports nothing
from it.  Entry points run on the card (``device="cuda"``) unless the
caller asks for the CPU, where every kernel wrapper takes its plain
PyTorch version (``repro_torch.kernels.ref``).
"""
