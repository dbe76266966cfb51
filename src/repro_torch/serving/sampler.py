"""Per-request token sampling for the serving engine.

Each request carries a :class:`SamplingParams`; the engine packs them
into per-slot tensors and one :func:`sample_batch` call serves the whole
heterogeneous batch.  Convention: ``temperature <= 0`` is greedy
(argmax), ``top_k <= 0`` disables top-k, ``top_p >= 1`` disables the
nucleus.  Randomness comes from an explicit ``torch.Generator``, so
streams differ from the JAX package's for the same seed: sampled streams
are compared by distribution, greedy streams token for token.
"""
from __future__ import annotations

import dataclasses

import torch

_NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0  # <= 0 -> greedy
    top_k: int = 0  # <= 0 -> no top-k filter
    top_p: float = 1.0  # >= 1 -> no nucleus filter


GREEDY = SamplingParams()


def _filter_logits(lg: torch.Tensor, temp: torch.Tensor, topk: torch.Tensor,
                   topp: torch.Tensor) -> torch.Tensor:
    """Temperature + per-row top-k + nucleus filtering of (B, V) f32
    logits.  Greedy rows are sanitized to temperature 1 (their argmax is
    taken separately).  The nucleus keeps tokens by *rank* in descending
    probability, so ties with the last kept token are not readmitted."""
    V = lg.shape[-1]
    safe_temp = torch.where(temp <= 0.0, 1.0, temp.clamp(min=1e-4))
    x = lg / safe_temp[:, None]
    sorted_desc = torch.sort(x, dim=-1, descending=True).values
    k = torch.where(topk <= 0, V, topk).clamp(1, V).long()
    kth = torch.gather(sorted_desc, 1, (k - 1)[:, None])
    x = torch.where(x >= kth, x, _NEG_INF)
    probs = torch.softmax(x, dim=-1)
    order = torch.argsort(-probs, dim=-1, stable=True)
    sp = torch.gather(probs, 1, order)
    keep = (torch.cumsum(sp, dim=-1) - sp) < topp[:, None]
    keep[:, 0] = True  # top_p <= 0 still keeps the top token
    n_keep = keep.sum(dim=-1, keepdim=True)
    ranks = torch.argsort(order, dim=-1)  # token id -> descending rank
    return torch.where(ranks < n_keep, x, _NEG_INF)


def sample_batch(logits: torch.Tensor, gen: torch.Generator,
                 temp: torch.Tensor, topk: torch.Tensor,
                 topp: torch.Tensor) -> torch.Tensor:
    """One token per row under that row's params; (B,) int64."""
    lg = logits.float()
    greedy_tok = lg.argmax(dim=-1)
    if not bool((temp > 0.0).any()):
        return greedy_tok
    probs = torch.softmax(_filter_logits(lg, temp, topk, topp), dim=-1)
    tok = torch.multinomial(probs, 1, generator=gen)[:, 0]
    return torch.where(temp <= 0.0, greedy_tok, tok)
