"""Token samplers for the serving engine.

:func:`greedy`, :func:`temperature` and :func:`top_k` are single-policy
functions for tests and offline use.  On the engine path each request
carries a :class:`SamplingParams`; the engine packs them into per-slot
tensors and one :func:`sample_batch` call serves the whole heterogeneous
batch.  Convention: ``temperature <= 0`` is greedy
(argmax), ``top_k <= 0`` disables top-k, ``top_p >= 1`` disables the
nucleus.  Randomness comes from an explicit ``torch.Generator``, so
streams differ from the JAX package's for the same seed: sampled streams
are compared by distribution, greedy streams token for token.  A batch
with no stochastic row draws nothing from the generator.

:func:`spec_accept_batch` and :func:`spec_accept_tree` are speculative
decoding's accept rules, which keep every row's sampling distribution.

Where a sampler branches on a device value (is any row stochastic?), it
reads it inside an ``engine.sync`` stage (``telemetry.stage``): the read
waits for the device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.serving.telemetry import stage

_NEG_INF = -1e30


def greedy(logits: torch.Tensor, gen=None) -> torch.Tensor:
    return logits.argmax(dim=-1).to(torch.int32)


def temperature(logits: torch.Tensor, gen: torch.Generator,
                temp: float = 0.8) -> torch.Tensor:
    """One categorical draw per row of ``logits / temp``."""
    probs = torch.softmax(logits.float() / max(temp, 1e-4), dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    tok = torch.multinomial(flat, 1, generator=gen)[:, 0]
    return tok.reshape(probs.shape[:-1]).to(torch.int32)


def top_k(logits: torch.Tensor, gen: torch.Generator, k: int = 40,
          temp: float = 0.8) -> torch.Tensor:
    """A draw among each row's ``k`` largest logits at ``temp``."""
    vals, idx = torch.topk(logits.float(), k, dim=-1)
    choice = temperature(vals, gen, temp).long()
    return torch.gather(idx, -1, choice[..., None])[..., 0].to(torch.int32)


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling; ``priority`` and ``deadline_s`` feed
    admission, not sampling: a higher priority admits (and preempts)
    first, and an absolute ``time.monotonic()`` deadline orders the queue
    within a priority class.  The defaults give exact FIFO admission."""

    temperature: float = 0.0  # <= 0 -> greedy
    top_k: int = 0  # <= 0 -> no top-k filter
    top_p: float = 1.0  # >= 1 -> no nucleus filter
    priority: int = 0  # higher admits first, preempts lower
    deadline_s: Optional[float] = None  # absolute time.monotonic() SLO


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


def _any_stochastic(temp: torch.Tensor) -> bool:
    """Whether any row samples (``temp > 0``): a read of one device value
    on the host (``engine.sync``)."""
    stochastic = (temp > 0.0).any()
    with stage("engine.sync"):
        return bool(stochastic)


def sample_batch(logits: torch.Tensor, gen: torch.Generator,
                 temp: torch.Tensor, topk: torch.Tensor,
                 topp: torch.Tensor) -> torch.Tensor:
    """One token per row under that row's params; (B,) int64."""
    lg = logits.float()
    greedy_tok = lg.argmax(dim=-1)
    if not _any_stochastic(temp):
        return greedy_tok
    probs = torch.softmax(_filter_logits(lg, temp, topk, topp), dim=-1)
    tok = torch.multinomial(probs, 1, generator=gen)[:, 0]
    return torch.where(temp <= 0.0, greedy_tok, tok)


# ---------------------------------------------------------------------------
# speculative decoding: accept/reject against verified logits


def _filtered_probs(lg: torch.Tensor, temp: torch.Tensor, topk: torch.Tensor,
                    topp: torch.Tensor) -> torch.Tensor:
    """(B, C, V) probabilities of each row's filtered distribution at every
    chunk position."""
    B, C, V = lg.shape
    flat = _filter_logits(lg.reshape(B * C, V),
                          temp.repeat_interleave(C),
                          topk.repeat_interleave(C),
                          topp.repeat_interleave(C)).reshape(B, C, V)
    return torch.softmax(flat, dim=-1)


def _uniforms(temp: torch.Tensor, k: int, gen: torch.Generator):
    """(B, k) uniforms for the accept trials, or None for an all-greedy
    batch, which draws nothing."""
    if not _any_stochastic(temp):
        return None
    return torch.rand((temp.shape[0], k), generator=gen, device=temp.device)


def _next_token(p: torch.Tensor, greedy_tok: torch.Tensor,
                temp: torch.Tensor, u, gen: torch.Generator) -> torch.Tensor:
    """The bonus / corrective token: the argmax on greedy rows, else one
    draw from the renormalised residual ``p`` (B, V)."""
    if u is None:
        return greedy_tok
    p = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    sampled = torch.multinomial(p.clamp_min(1e-30), 1, generator=gen)[:, 0]
    return torch.where(temp <= 0.0, greedy_tok, sampled)


def spec_accept_batch(logits: torch.Tensor, draft: torch.Tensor,
                      n_draft: torch.Tensor, gen: torch.Generator,
                      temp: torch.Tensor, topk: torch.Tensor,
                      topp: torch.Tensor):
    """Accept/reject point-mass draft tokens against the target
    distribution, preserving it exactly (the reference's
    ``spec_accept_batch``).

    ``logits`` (B, C, V), C >= k + 1, are one verify call's: position
    ``i`` follows the row's context plus ``draft[b, :i]``.  Draft token
    ``i`` is accepted with probability ``p_i(d_i)`` under the row's
    filtered target distribution; at the first rejection the next token
    is drawn from ``p_i`` with ``d_i`` struck out and renormalised, after
    a full match from the bonus position.  Greedy rows (``temp <= 0``)
    accept the longest prefix equal to the argmax chain and then take the
    argmax, token for token the plain greedy stream.  Randomness comes
    from ``gen`` (uniforms for the trials, then one categorical draw), so
    stochastic rows match the reference in distribution, not in value.

    Returns ``(n_accept (B,) int64, next_tok (B,) int64)``: row ``b``
    emits ``draft[b, :n_accept[b]]`` then ``next_tok[b]``."""
    B, C, V = logits.shape
    k = draft.shape[1]
    dev = logits.device
    lg = logits.float()
    gtok = lg.argmax(dim=-1)  # (B, C) the greedy chain
    draft = draft.long()
    u = _uniforms(temp, k, gen)
    ok = draft == gtok[:, :k]
    if u is not None:
        probs = _filtered_probs(lg, temp, topk, topp)
        p_draft = torch.gather(probs[:, :k], 2, draft[..., None])[..., 0]
        ok = torch.where((temp <= 0.0)[:, None], ok, u < p_draft)
    ok = ok & (torch.arange(k, device=dev)[None] < n_draft[:, None])
    n_accept = torch.cumprod(ok.long(), dim=-1).sum(dim=-1)
    row = torch.arange(B, device=dev)
    greedy_tok = gtok[row, n_accept]
    if u is None:
        return n_accept, greedy_tok
    rejected = n_accept < n_draft
    d_rej = draft[row, n_accept.clamp(max=k - 1)]
    strike = rejected[:, None] & (torch.arange(V, device=dev)[None]
                                  == d_rej[:, None])
    p_next = torch.where(strike, 0.0, probs[row, n_accept])
    return n_accept, _next_token(p_next, greedy_tok, temp, u, gen)


def spec_accept_tree(logits: torch.Tensor, tokens: torch.Tensor,
                     parents: torch.Tensor, n_nodes: torch.Tensor,
                     gen: torch.Generator, temp: torch.Tensor,
                     topk: torch.Tensor, topp: torch.Tensor):
    """Accept/reject a token tree against the target distribution (the
    reference's ``spec_accept_tree``).

    Node ``j`` (chunk position ``j``, index ``j - 1``) carries
    ``tokens[b, j - 1]`` and hangs off chunk position ``parents[b, j -
    1]`` (0 = the current token); ``logits[b, i]`` follows the context
    plus position ``i``'s root path.  Nodes are tried in DFS order: a
    node is tryable if its parent was accepted and no earlier sibling won
    that parent, and takes the point-mass decision against its parent's
    residual distribution (rejected siblings struck out, renormalised:
    sampling without replacement).  Greedy rows accept a child whose
    token is its parent's argmax.  The next token samples the deepest
    accepted position's residual (greedy rows: its argmax).  On a chain
    this is :func:`spec_accept_batch`.

    Returns ``(n_accept (B,), accepted (B, C) bool, next_tok (B,))``:
    the accepted positions (0 always set) form a root-to-leaf path whose
    ascending order is depth order."""
    B, C, V = logits.shape
    k = tokens.shape[1]
    if k + 1 > C:
        raise ValueError(f"{k} nodes do not fit a width-{C} chunk")
    dev = logits.device
    lg = logits.float()
    gtok = lg.argmax(dim=-1)  # (B, C)
    u = _uniforms(temp, k, gen)
    probs = None if u is None else _filtered_probs(lg, temp, topk, topp)
    greedy_row = temp <= 0.0
    row = torch.arange(B, device=dev)
    tokens, parents = tokens.long(), parents.long()

    accepted = torch.zeros((B, C), dtype=torch.bool, device=dev)
    accepted[:, 0] = True
    child_done = torch.zeros((B, C), dtype=torch.bool, device=dev)
    if probs is not None:
        struck = torch.zeros((B, C, V), dtype=torch.bool, device=dev)
        struck_mass = torch.zeros((B, C), dtype=torch.float32, device=dev)
    for j in range(1, k + 1):
        par, tok = parents[:, j - 1], tokens[:, j - 1]
        tryable = ((j - 1) < n_nodes) & accepted[row, par] \
            & ~child_done[row, par]
        ok = tok == gtok[row, par]
        if probs is not None:
            p_tok = probs[row, par, tok]
            was_struck = struck[row, par, tok]
            denom = (1.0 - struck_mass[row, par]).clamp_min(1e-30)
            p_try = torch.where(was_struck, 0.0, p_tok) / denom
            ok = torch.where(greedy_row, ok, u[:, j - 1] < p_try)
        ok = ok & tryable
        accepted[:, j] = ok
        child_done[row, par] |= ok
        if probs is not None:
            rej = tryable & ~ok
            struck[row, par, tok] |= rej
            struck_mass[row, par] += torch.where(rej & ~was_struck, p_tok,
                                                 0.0)
    ar = torch.arange(C, device=dev)[None]
    fin = torch.where(accepted, ar, 0).amax(dim=1)  # deepest accepted
    n_accept = accepted[:, 1:].long().sum(dim=1)
    greedy_tok = gtok[row, fin]
    if probs is None:
        return n_accept, accepted, greedy_tok
    p_next = torch.where(struck[row, fin], 0.0, probs[row, fin])
    return n_accept, accepted, _next_token(p_next, greedy_tok, temp, u, gen)
