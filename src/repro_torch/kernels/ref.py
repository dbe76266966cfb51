"""Plain PyTorch versions of the Hopper kernels.

Each function mirrors its counterpart in the JAX package's
``repro/kernels/ref.py`` operation for operation, including the cast of
the softmax probabilities to the cache dtype before the PV product, so
that on the CPU the port agrees with the JAX reference.  They are the
path ``kernels/ops.py`` takes for CPU tensors, and the yardstick the
CUDA kernels are held against on the card.  They are device-agnostic:
``chip_smoke.py`` runs them on CUDA tensors for that comparison.
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def quant_matmul_ref(
    x_q: torch.Tensor,  # int8 (M, K)
    w_q: torch.Tensor,  # int8 (K, N)
    x_scale: torch.Tensor,  # f32 (M, 1) per-token
    w_scale: torch.Tensor,  # f32 (1, N) per-channel
    bias: Optional[torch.Tensor] = None,  # f32 (N,)
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Y = (x_q @ w_q) * x_scale * w_scale + bias with an exact integer
    accumulation.  The product runs in float64, which holds every partial
    sum exactly (|sum| <= 127 * 127 * K < 2**53) on the CPU and the card
    alike, and rounding that exact integer to float32 equals the int32 ->
    float32 conversion of the reference."""
    acc = (x_q.double() @ w_q.double()).float()
    y = acc * x_scale.float() * w_scale.float()
    if bias is not None:
        y = y + bias.float()[None, :]
    return y.to(out_dtype)


def mha_decode_ref(
    q: torch.Tensor,  # (B, H, D)
    k_cache: torch.Tensor,  # (B, Hkv, S, D)
    v_cache: torch.Tensor,  # (B, Hkv, S, D)
    lengths: torch.Tensor,  # (B,) valid cache entries
    window: int = 0,
) -> torch.Tensor:
    """Single-token attention over a contiguous cache (grouped query
    heads contract the cache at its stored width)."""
    B, H, D = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(B, Hkv, H // Hkv, D)
    scores = torch.einsum(
        "bhgd,bhsd->bhgs", qg.float(), k_cache.float()) / math.sqrt(D)
    pos = torch.arange(S, device=q.device)[None, None, None, :]
    ln = lengths.long()[:, None, None, None]
    valid = pos < ln
    if window:
        valid = valid & (pos >= ln - window)
    scores = scores.masked_fill(~valid, -math.inf)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum(
        "bhgs,bhsd->bhgd", p.to(v_cache.dtype).float(), v_cache.float())
    return out.reshape(B, H, D).to(q.dtype)


def paged_gather_ref(pages: torch.Tensor,
                     block_table: torch.Tensor) -> torch.Tensor:
    """Gather each sequence's pages ``(P, Hkv, ps, D)`` into a contiguous
    ``(B, Hkv, n_pg * ps, D)`` view; unallocated entries name the null
    page 0, whose content the attention masks never unmask."""
    g = pages[block_table.long()]  # (B, n_pg, Hkv, ps, D)
    B, n_pg, Hkv, ps, D = g.shape
    return g.permute(0, 2, 1, 3, 4).reshape(B, Hkv, n_pg * ps, D)


def paged_mha_decode_ref(
    q: torch.Tensor,  # (B, H, D)
    k_pages: torch.Tensor,  # (P, Hkv, ps, D)
    v_pages: torch.Tensor,
    lengths: torch.Tensor,  # (B,)
    block_table: torch.Tensor,  # (B, n_pg)
    window: int = 0,
) -> torch.Tensor:
    """Single-token attention over a paged cache: the contiguous oracle
    applied to the block-table gather of the page pool."""
    k = paged_gather_ref(k_pages, block_table)
    v = paged_gather_ref(v_pages, block_table)
    return mha_decode_ref(q, k, v, lengths, window=window)


def paged_verify_ref(
    q: torch.Tensor,  # (B, C, H, D)
    k_pages: torch.Tensor,  # (P, Hkv, ps, D)
    v_pages: torch.Tensor,
    base: torch.Tensor,  # (B,) first query position per row
    block_table: torch.Tensor,  # (B, n_pg)
    window: int = 0,
    anc: Optional[torch.Tensor] = None,  # (B, C, C) ancestor bitmask
) -> torch.Tensor:
    """Chunked causal attention over a paged cache: query ``j`` of row
    ``b`` sits at ``base[b] + j`` and attends every cached position at or
    below it (the chunk's own K/V are already in the pages), under an
    optional sliding window.  With ``anc`` the in-chunk causal mask is
    replaced by a token tree's ancestor bitmask.  A row left with no
    valid key yields zeros."""
    B, C, H, D = q.shape
    Hkv = k_pages.shape[1]
    k = paged_gather_ref(k_pages, block_table)  # (B, Hkv, S, D)
    v = paged_gather_ref(v_pages, block_table)
    S = k.shape[2]
    dev = q.device
    qg = q.reshape(B, C, Hkv, H // Hkv, D)
    scores = torch.einsum(
        "bchgd,bhsd->bhgcs", qg.float(), k.float()) / math.sqrt(D)
    base = base.long()
    ar_s = torch.arange(S, device=dev)
    if anc is not None:
        if window:
            raise ValueError("window and anc are mutually exclusive")
        rel = ar_s[None, :] - base[:, None]  # (B, S) chunk-relative
        in_chunk = (rel >= 0) & (rel < C)
        bits = torch.gather(
            anc.bool(), 2,
            rel.clamp(0, C - 1)[:, None, :].expand(B, C, S))  # (B, C, S)
        prefix = (ar_s[None, :] < base[:, None])[:, None, :]
        valid = (prefix | (in_chunk[:, None, :] & bits))[:, None, None]
    else:
        pos = ar_s[None, None, None, None, :]
        qpos = (base[:, None] + torch.arange(C, device=dev)[None, :])[
            :, None, None, :, None]
        valid = pos <= qpos
        if window:
            valid = valid & (pos > qpos - window)
    scores = scores.masked_fill(~valid, -math.inf)
    p = torch.softmax(scores, dim=-1)
    p = torch.where(valid.any(dim=-1, keepdim=True), p, 0.0)
    out = torch.einsum("bhgcs,bhsd->bchgd", p.to(v.dtype).float(), v.float())
    return out.reshape(B, C, H, D).to(q.dtype)


def ln_res_ref(
    x: torch.Tensor,  # (B, D) block output
    res: torch.Tensor,  # (B, D) running residual
    weight: torch.Tensor,  # (D,)
    bias: Optional[torch.Tensor],  # (D,) or None (skips the add)
    *,
    kind: str = "layernorm",  # layernorm | rmsnorm
    eps: float = 1e-5,
):
    """Residual add, norm, scale and shift, then per-token symmetric int8
    quantization.  Returns ``(y bf16, new residual in res's dtype, y_q
    int8, scale f32 (B, 1))``.  ``scale`` is taken over the float32
    ``y``, before its bf16 rounding.

    Two choices keep this version bit for bit with the CUDA kernel while
    computing the reference's function: the sums behind the mean and the
    variance are taken in float64 (exact or nearly, whatever their
    order, then rounded to float32 once; a float32 sum in another order
    would move the mean of a row with a large mean, and with it every
    output near zero, by far more than a bf16 ulp of that output), and
    the normalisation divides by an IEEE square root where the reference
    multiplies by ``rsqrt``."""
    D = x.shape[-1]
    r = x.float() + res.float()
    if kind == "layernorm":
        mu = (r.double().sum(dim=-1, keepdim=True) / D).float()
        d = r - mu
        var = (d.double().square().sum(dim=-1, keepdim=True) / D).float()
        y = d * (1.0 / torch.sqrt(var + eps))
    elif kind == "rmsnorm":
        ms = (r.double().square().sum(dim=-1, keepdim=True) / D).float()
        y = r * (1.0 / torch.sqrt(ms + eps))
    else:
        raise ValueError(f"unknown norm kind {kind!r}")
    y = y * weight.float()[None, :]
    if bias is not None:
        y = y + bias.float()[None, :]
    amax = y.abs().amax(dim=-1, keepdim=True)
    scale = amax.clamp(min=1e-6) / 127.0
    y_q = torch.round(y / scale).clamp(-127, 127).to(torch.int8)
    return y.to(torch.bfloat16), r.to(res.dtype), y_q, scale
