"""Ranges and call records the benchmark puts around the program's calls
in a traced run (``--trace 1``); an untraced run installs none.

Module attributes of the port are wrapped from here, and nothing inside
the port changes:

  * ``lm.decode_step`` and ``lm.prefill_into_slot`` get a record of the
    model call: its rows and the engine's host-side cache lengths, or the
    chunk's offset and valid tokens (``install``, for the whole window);
  * ``ops.quant_matmul``, ``ops.paged_mha_decode``, ``ops.paged_verify``
    and ``moe.moe_apply`` get a ``torch.profiler.record_function`` range
    each (``bench.<name>``), so the profiler's kernels can be told apart
    by the call that launched them, and a record of the call's shapes
    (``install_ranges``, when the profiled part starts, so that the host
    part of the window pays for none of them).

Nothing here reads a device tensor: lengths come from the engine's
host-side ``kv.lengths`` and the chunk's host arguments.  The records
carry the phase they fell in (``"host"`` or ``"profiled"``), so each
metric takes the calls of its own part of the window.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Optional

import numpy as np
import torch

RANGED = (("ops", "quant_matmul"), ("ops", "paged_mha_decode"),
          ("ops", "paged_verify"), ("moe", "moe_apply"))


def range_name(attr: str) -> str:
    return f"bench.{attr}"


class Probes:
    def __init__(self, engine):
        self.engine = engine
        self.phase: Optional[str] = None  # records are kept only in a phase
        self.calls: List[Dict] = []  # model calls
        self.kernels: List[Dict] = []  # wrapped kernel calls
        self._ctx: Dict = {}
        self._saved: List = []

    # -- installation ------------------------------------------------------
    def install(self) -> "Probes":
        """The model-call records."""
        from repro_torch.models import lm

        self._wrap(lm, "decode_step", self._decode)
        self._wrap(lm, "prefill_into_slot", self._prefill)
        return self

    def install_ranges(self) -> None:
        """The kernels' ranges and shape records."""
        from repro_torch.kernels import ops
        from repro_torch.models import moe

        mods = {"ops": ops, "moe": moe}
        for mod_name, attr in RANGED:
            self._wrap(mods[mod_name], attr, self._ranged)

    def remove(self) -> None:
        for mod, attr, orig in reversed(self._saved):
            setattr(mod, attr, orig)
        self._saved.clear()

    def _wrap(self, mod, attr: str, make) -> None:
        orig = getattr(mod, attr)
        wrapper = functools.wraps(orig)(make(attr, orig))
        self._saved.append((mod, attr, orig))
        setattr(mod, attr, wrapper)

    # -- model calls -------------------------------------------------------
    def _decode(self, attr, orig):
        def call(params, cfg, token, cache, lengths, **kw):
            rows = int(token.shape[0])
            lens = np.asarray(self.engine.kv.lengths[:rows], np.int64).copy()
            self._ctx = {"kind": "decode", "lengths": lens}
            if self.phase is not None:
                self.calls.append({"kind": "decode", "rows": rows,
                                   "lengths": lens, "phase": self.phase})
            return orig(params, cfg, token, cache, lengths, **kw)
        return call

    def _prefill(self, attr, orig):
        def call(params, cfg, tokens, cache, offset, **kw):
            C = int(tokens.shape[-1])
            valid = kw.get("valid")
            valid = C if valid is None else int(valid)
            self._ctx = {"kind": "prefill", "start": int(offset), "C": C,
                         "valid": valid}
            if self.phase is not None:
                self.calls.append({"kind": "prefill", "start": int(offset),
                                   "C": C, "valid": valid,
                                   "phase": self.phase})
            return orig(params, cfg, tokens, cache, offset, **kw)
        return call

    # -- kernels -----------------------------------------------------------
    def _ranged(self, attr, orig):
        name = range_name(attr)
        shapes = getattr(self, "_shape_" + attr)

        def call(*args, **kw):
            if self.phase is not None:
                rec = shapes(*args, **kw)
                if rec is not None:
                    rec.update(kernel=attr, phase=self.phase)
                    self.kernels.append(rec)
            with torch.profiler.record_function(name):
                return orig(*args, **kw)
        return call

    def _shape_quant_matmul(self, x_q, w_q, x_scale, w_scale, bias=None,
                            *, out_dtype=torch.bfloat16):
        return {"M": int(x_q.shape[0]), "K": int(x_q.shape[1]),
                "N": int(w_q.shape[1]), "bias": bias is not None,
                "out_bytes": out_dtype.itemsize}

    def _shape_paged_mha_decode(self, q, k_pages, v_pages, lengths,
                                block_table, **kw):
        if self._ctx.get("kind") != "decode":
            return None
        B, H, D = q.shape
        return {"keys": self._ctx["lengths"][:B] + 1, "H": int(H),
                "Hkv": int(k_pages.shape[1]), "D": int(D),
                "n_pg": int(block_table.shape[1]),
                "q_bytes": q.element_size(),
                "kv_bytes": k_pages.element_size()}

    def _shape_paged_verify(self, q, k_pages, v_pages, base, block_table,
                            **kw):
        if self._ctx.get("kind") != "prefill" or kw.get("anc") is not None:
            return None
        B, C, H, D = q.shape
        return {"start": self._ctx["start"], "C": int(C), "H": int(H),
                "Hkv": int(k_pages.shape[1]), "D": int(D),
                "n_pg": int(block_table.shape[1]),
                "q_bytes": q.element_size(),
                "kv_bytes": k_pages.element_size()}

    def _shape_moe_apply(self, p, x, cfg, **kw):
        B, S, d = x.shape
        return {"T": int(B * S)}
