"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory with
exponential gating), per arXiv:2405.04517.

Both are attention-free recurrences with a constant-size state.  Every
path threads the state one token at a time through the same cell, with
the paper's max-stabiliser for the exponential gates (mLSTM's ``m``
starts at -1e30), as the reference's ``lax.scan`` does.  The cells are
plain PyTorch, as they are plain ``jnp`` in the reference; mLSTM's
``qkv``, ``o_gate`` and ``out`` go through ``linear`` (the MP kernel
under W8A8), while the exponential-gate projections (mLSTM's and
sLSTM's ``gates``) and sLSTM's block-diagonal ``rec`` stay floating
point.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import linear, linear_init


def _stack_states(states: List[Dict]) -> Dict:
    """A trajectory: per-token states stacked on dim 1."""
    return {k: torch.stack([s[k] for s in states], dim=1)
            for k in states[0]}


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def mlstm_init(gen, cfg: ModelConfig, *, dtype=torch.float32, device=None):
    d = cfg.d_model
    kw = {"dtype": dtype, "device": device}
    return {
        "qkv": linear_init(gen, d, cfg.q_dim + 2 * cfg.kv_dim, **kw),
        # per-head scalar input/forget gates, always float32
        "gates": linear_init(gen, d, 2 * cfg.n_heads, dtype=torch.float32,
                             device=device, bias=True),
        "o_gate": linear_init(gen, d, cfg.q_dim, **kw),
        "out": linear_init(gen, cfg.q_dim, d, **kw),
    }


def mlstm_init_state(cfg: ModelConfig, batch: int, device=None) -> Dict:
    H, hd = cfg.n_heads, cfg.head_dim
    kw = {"dtype": torch.float32, "device": device}
    return {
        "C": torch.zeros((batch, H, hd, hd), **kw),
        "n": torch.zeros((batch, H, hd), **kw),
        "m": torch.full((batch, H), -1e30, **kw),
    }


def _mlstm_cell(state: Dict, q, k, v, li, lf):
    """One stabilised mLSTM step. q/k/v (B, H, hd); li/lf (B, H) logs."""
    C, n, m = state["C"], state["n"], state["m"]
    m_new = torch.maximum(lf + m, li)
    i_p = torch.exp(li - m_new)[..., None]  # (B, H, 1)
    f_p = torch.exp(lf + m - m_new)[..., None]
    C = f_p[..., None] * C + i_p[..., None] * (v[..., :, None]
                                               * k[..., None, :])
    n = f_p * n + i_p * k
    h_num = torch.einsum("bhij,bhj->bhi", C, q)
    h_den = torch.clamp_min(torch.einsum("bhj,bhj->bh", n, q).abs(),
                            1.0)[..., None]
    return {"C": C, "n": n, "m": m_new}, h_num / h_den


def _mlstm_prep(p, x: torch.Tensor, cfg: ModelConfig):
    """Project x (B, S, d) -> per-token cell inputs.  ``qkv`` records its
    calibration stats under the fixed name ``"mlstm.qkv"``, as in the
    reference."""
    B, S, _ = x.shape
    H, hd = cfg.n_heads, cfg.head_dim
    qkv = linear(p["qkv"], x, "mlstm.qkv")
    q, k, v = torch.split(qkv, [cfg.q_dim, cfg.kv_dim, cfg.kv_dim], dim=-1)
    q = q.reshape(B, S, H, hd).float() / (hd ** 0.5)
    k = k.reshape(B, S, H, hd).float()
    v = v.reshape(B, S, H, hd).float()
    g = linear(p["gates"], x.float(), "mlstm.gates")  # (B, S, 2H)
    return q, k, v, g[..., :H], F.logsigmoid(g[..., H:])


def _mlstm_out(p, x, hs: torch.Tensor, cfg: ModelConfig, name: str):
    B, S = x.shape[:2]
    h = hs.reshape(B, S, cfg.q_dim).to(x.dtype)
    o = torch.sigmoid(linear(p["o_gate"], x, name + ".o").float()).to(
        x.dtype)
    return linear(p["out"], h * o, name + ".out")


def mlstm_chunk(p: Dict, x: torch.Tensor, state: Dict, cfg: ModelConfig,
                name: str = "") -> Tuple[torch.Tensor, Dict]:
    """C tokens (B, C, d) against a carried state.  Returns ``(out (B, C,
    d), traj)``, ``traj[:, t]`` being the state after tokens ``0..t``."""
    ins = _mlstm_prep(p, x, cfg)
    states, hs = [], []
    for t in range(x.shape[1]):
        state, h = _mlstm_cell(state, *(a[:, t] for a in ins))
        states.append(state)
        hs.append(h)
    return (_mlstm_out(p, x, torch.stack(hs, dim=1), cfg, name),
            _stack_states(states))


def mlstm_seq(p: Dict, x: torch.Tensor, cfg: ModelConfig, name: str = ""):
    """Full-sequence path from the init state: (out, final state)."""
    out, traj = mlstm_chunk(p, x, mlstm_init_state(cfg, x.shape[0],
                                                   x.device), cfg, name)
    return out, {k: t[:, -1] for k, t in traj.items()}


def mlstm_step(p: Dict, x: torch.Tensor, state: Dict, cfg: ModelConfig,
               name: str = "") -> Tuple[torch.Tensor, Dict]:
    """One decode token (B, 1, d)."""
    ins = _mlstm_prep(p, x, cfg)
    st, h = _mlstm_cell(state, *(a[:, 0] for a in ins))
    return _mlstm_out(p, x, h[:, None], cfg, name), st


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def slstm_init(gen, cfg: ModelConfig, *, dtype=torch.float32, device=None):
    d = cfg.d_model
    H, hd = cfg.n_heads, cfg.d_model // cfg.n_heads  # sLSTM heads tile d
    return {
        # z, i, f, o pre-activations from x
        "gates": linear_init(gen, d, 4 * d, dtype=dtype, device=device,
                             bias=True),
        # block-diagonal recurrent weights per head: (H, hd, 4 * hd)
        "rec": torch.randn((H, hd, 4 * hd), generator=gen,
                           dtype=torch.float32, device=device)
        * (1.0 / hd ** 0.5),
    }


def slstm_init_state(cfg: ModelConfig, batch: int, device=None) -> Dict:
    kw = {"dtype": torch.float32, "device": device}
    d = cfg.d_model
    return {"h": torch.zeros((batch, d), **kw),
            "c": torch.zeros((batch, d), **kw),
            "n": torch.ones((batch, d), **kw),
            "m": torch.zeros((batch, d), **kw)}


def _slstm_cell(p, state: Dict, gx: torch.Tensor, cfg: ModelConfig):
    """gx (B, 4d): the pre-activations from x."""
    B = gx.shape[0]
    H, hd = cfg.n_heads, cfg.d_model // cfg.n_heads
    hprev = state["h"].reshape(B, H, hd)
    rec = torch.einsum("bhi,hij->bhj", hprev, p["rec"]).reshape(
        B, 4 * cfg.d_model)
    za, ia, fa, oa = (gx.float() + rec).chunk(4, dim=-1)
    z = torch.tanh(za)
    o = torch.sigmoid(oa)
    li, lf = ia, F.logsigmoid(fa)
    m_new = torch.maximum(lf + state["m"], li)
    i_p = torch.exp(li - m_new)
    f_p = torch.exp(lf + state["m"] - m_new)
    c = f_p * state["c"] + i_p * z
    n = f_p * state["n"] + i_p
    h = o * c / torch.clamp_min(n, 1.0)
    return {"h": h, "c": c, "n": n, "m": m_new}, h


def slstm_chunk(p: Dict, x: torch.Tensor, state: Dict, cfg: ModelConfig,
                name: str = "") -> Tuple[torch.Tensor, Dict]:
    """C tokens (B, C, d) against a carried state: (out, trajectory)."""
    gx = linear(p["gates"], x, name + ".gates")  # (B, C, 4d)
    states, hs = [], []
    for t in range(x.shape[1]):
        state, h = _slstm_cell(p, state, gx[:, t], cfg)
        states.append(state)
        hs.append(h)
    return torch.stack(hs, dim=1).to(x.dtype), _stack_states(states)


def slstm_seq(p: Dict, x: torch.Tensor, cfg: ModelConfig, name: str = ""):
    out, traj = slstm_chunk(p, x, slstm_init_state(cfg, x.shape[0],
                                                   x.device), cfg, name)
    return out, {k: t[:, -1] for k, t in traj.items()}


def slstm_step(p: Dict, x: torch.Tensor, state: Dict, cfg: ModelConfig,
               name: str = "") -> Tuple[torch.Tensor, Dict]:
    gx = linear(p["gates"], x[:, 0], name + ".gates")
    st, h = _slstm_cell(p, state, gx, cfg)
    return h[:, None].to(x.dtype), st
