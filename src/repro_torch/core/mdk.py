"""Macro Dataflow Kernels (MDK) — the paper's hybrid temporal-spatial core.

LoopLynx instantiates a small set of large fused kernels (Fused MP, Fused
MHA, Fused LN&Res, plus small functional units) and reuses them across
every stage of every block (Fig 3c).  :class:`MDKStats` counts, per
token, how many stages each kernel instance serves; ``MDK_REGISTRY`` maps
a kernel kind to the kernel wrapper that executes it, as the JAX
package's does: ``"mp"`` to the Fused MP kernel, ``"mha"`` to the Fused
MHA kernel on the contiguous cache (``ops.mha_decode``; the paged decode
kernel is its block-table sibling, ``ops.paged_mha_decode``) and
``"ln_res"`` to the Fused LN&Res kernel (``ops.ln_res``), which, as in
the JAX package, no model code calls: this registry is its entry point.
"""
from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Callable, Dict

from repro_torch.kernels import ops

#: The three macro kernels + the small functional units bucket.
MDK_KINDS = ("mp", "mha", "ln_res", "func")


@dataclasses.dataclass
class MDKStats:
    """Reuse accounting across one forward step (per token)."""

    activations: Counter = dataclasses.field(default_factory=Counter)
    stages: list = dataclasses.field(default_factory=list)

    def record(self, kind: str, stage: str) -> None:
        if kind not in MDK_KINDS:
            raise ValueError(f"unknown MDK kind {kind!r}")
        self.activations[kind] += 1
        self.stages.append((stage, kind))

    def reuse_factor(self) -> Dict[str, int]:
        """How many stages each single kernel instance served."""
        return dict(self.activations)


#: kernel kind -> the wrapper that executes it
MDK_REGISTRY: Dict[str, Callable] = {
    "mp": ops.quant_matmul,
    "mha": ops.mha_decode,
    "ln_res": ops.ln_res,
}
