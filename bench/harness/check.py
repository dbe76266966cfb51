"""How ``correct`` is decided: the served tokens against the plain
reference.

Once the window has closed and the program's state is freed, a sample of
the requests finished in the window, drawn from the seed and holding the
longest of them, is run through the reference (``bench/reference/``):
one forward over each prompt with its served tokens.  At every served
position the reference's logits say how far the served token lies below
their best; the widest such gap over the sample is the number compared
(``logit_gap``), beside their mean (``mean_gap``) and the share of
served tokens that are not the reference's best (``off_share``).
Greedy serving puts the program's own best first, so a sound program
parts from the reference only at near-ties, by what its arithmetic
differs.  A workload's ``limits`` name the numbers its runs are held to.

A control (the reference again, in a precision below the configured
one) is read at the same positions: the gap of the token it puts first.
The benchmark's runs do not compute it; ``bench/tools/readings.py`` and
the tests do.
"""
from __future__ import annotations

import sys
from typing import Dict, List, Sequence

import numpy as np
import torch

from harness import weights as weights_mod

_BLOCK = 1024  # logit rows computed at once
#: SmoothQuant's calibration input, unless a configuration's ``serving``
#: gives its own ``calibration``
CALIBRATION = {"batches": 1, "rows": 2, "tokens": 128}
#: the sample's size, unless a workload's ``check`` gives its own
SAMPLE = {"min_tokens": 2048, "max_requests": 16}


def calibration(serving: Dict, seed: int, vocab: int) -> List[np.ndarray]:
    """The calibration tokens both sides get: ``batches`` arrays of
    (rows, tokens) ids, drawn from the seed."""
    c = dict(CALIBRATION, **serving.get("calibration", {}))
    rng = np.random.default_rng([int(seed) % (1 << 63), 0xCA11B])
    return [rng.integers(1, vocab, (c["rows"], c["tokens"]))
            for _ in range(c["batches"])]


def sample(done: Sequence[Dict], seed: int, *, min_tokens: int,
           max_requests: int) -> List[Dict]:
    """The longest finished request (most served tokens, then lowest rid)
    and others in an order drawn from the seed, until ``min_tokens``
    served tokens or ``max_requests`` requests."""
    if not done:
        return []
    done = sorted(done, key=lambda r: r["rid"])
    longest = max(done, key=lambda r: (len(r["out"]), -r["rid"]))
    rest = [r for r in done if r is not longest]
    rng = np.random.default_rng([int(seed) % (1 << 63), 0xC0DE])
    out, tokens = [longest], len(longest["out"])
    for i in rng.permutation(len(rest)):
        if tokens >= min_tokens or len(out) >= max_requests:
            break
        out.append(rest[int(i)])
        tokens += len(rest[int(i)]["out"])
    return out


def _reference_family(cell):
    ref_dir = str(cell.bench / "reference")
    if ref_dir not in sys.path:
        sys.path.insert(0, ref_dir)
    import reference_common

    return reference_common, cell.reference()


def controls_of(config: Dict) -> Dict[str, Dict]:
    """The configuration's controls: name -> Reference keyword arguments."""
    out = {}
    for name, spec in config.get("controls", {}).items():
        kw = {}
        if "bits" in spec:
            kw["bits"] = int(spec["bits"])
        for key in ("expert_dtype", "float_dtype"):
            if key in spec:
                kw[key] = getattr(torch, spec[key])
        out[name] = kw
    return out


def _numbers(gap: torch.Tensor, prefix: str = "",
             suffix: str = "") -> Dict[str, float]:
    """The widest and the mean gap, and the share of positions off the
    reference's best."""
    return {f"{prefix}logit_gap{suffix}": float(gap.max()),
            f"{prefix}mean_gap{suffix}": float(gap.mean()),
            f"{prefix}off_share{suffix}": float((gap > 0).float().mean())}


@torch.no_grad()
def compare(cell, seed: int, samples: List[Dict], device, *,
            controls: Sequence[str] = ()) -> Dict[str, float]:
    """The numbers of ``_numbers`` over ``samples`` (dicts with
    ``prompt`` and ``out`` token lists), ``logit_gap`` and the others,
    and for each control asked for the same as
    ``control.<number>.<name>``."""
    common, family = _reference_family(cell)
    common.exact_float32()
    model, serving = cell.config["model"], cell.config["serving"]
    w = weights_mod.make(model, serving["max_seq"], seed, device)
    calib = calibration(serving, seed, model["vocab_size"])
    ref = common.Reference(family, w, model, calib)
    seqs = [torch.as_tensor(r["prompt"] + r["out"][:-1], device=device)
            .long() for r in samples]
    # rows of the concatenation that predict a served token
    rows, served, at = [], [], 0
    for r, s in zip(samples, seqs):
        P = len(r["prompt"])
        rows.extend(range(at + P - 1, at + s.numel()))
        served.extend(r["out"])
        at += s.numel()
    rows_t = torch.as_tensor(rows, device=device)
    served_t = torch.as_tensor(served, device=device)
    h = ref.final_hidden(seqs)[rows_t]
    blocks = [slice(a, a + _BLOCK) for a in range(0, len(rows), _BLOCK)]

    def gaps(pick_of) -> torch.Tensor:
        """Per position, the gap below the reference's best of the token
        that ``pick_of(block, reference logits)`` picks."""
        out = []
        for sl in blocks:
            lg = ref.logits(h[sl])
            got = lg.gather(1, pick_of(sl, lg)[:, None])[:, 0]
            out.append((lg.amax(dim=-1) - got).cpu())
        return torch.cat(out)

    out = _numbers(gaps(lambda sl, lg: served_t[sl]))
    specs = controls_of(cell.config)
    for name in controls:
        ctl = common.Reference(family, w, model, calib, **specs[name])
        hc = ctl.final_hidden(seqs)[rows_t]
        out.update(_numbers(gaps(lambda sl, lg: ctl.logits(hc[sl])
                                 .argmax(dim=-1)),
                            prefix="control.", suffix=f".{name}"))
        del ctl, hc
    return out
