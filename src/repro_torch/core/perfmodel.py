"""Analytic LoopLynx FPGA performance model (host-side planning).

A copy of ``FPGAPerfModel`` from the JAX package's
``repro/core/perfmodel.py``: it walks the stage program
(:mod:`repro_torch.core.scheduler`) and prices each stage against the
paper's FPGA constants (8 HBM channels x 8.49 GB/s per node, 16 x 32 MACs
at 285 MHz).  The serving engine uses it for two things only: the
per-tick prefill token budget (``serving/admission.py``) and the
``*_modeled_s`` counters beside the measured times.  These are model
numbers of the paper's FPGA, not of the H100 this package runs on; the
H100's numbers come from ``chip_smoke.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs.base import ModelConfig
from repro_torch.core import scheduler


@dataclasses.dataclass
class FPGAPerfModel:
    cfg: ModelConfig
    nodes: int = 2
    # paper constants
    freq_hz: float = 285e6
    hbm_per_channel: float = 8.49e9
    net_bw: float = 8.49e9
    channels_per_node: int = 8
    hbm_efficiency: float = 0.93
    mp_slices: int = 16
    macs_per_slice: int = 32
    # calibrated micro-constants (see the JAX package's module docstring)
    vpu_cyc_per_elem: float = 2.0
    ln_res_passes_unfused: float = 5.0
    ln_res_passes_fused: float = 2.0
    softmax_cyc_per_score: float = 4.0
    quant_drain_cycles: float = 300.0
    net_hop_latency: float = 2e-6
    fuse_ln_res: bool = True
    headwise_pipeline: bool = True
    hide_transmission: bool = True
    prefill_pipeline_eff: float = 0.7

    @property
    def node_bw(self) -> float:
        return (self.channels_per_node * self.hbm_per_channel
                * self.hbm_efficiency)

    @property
    def node_macs_per_s(self) -> float:
        return self.mp_slices * self.macs_per_slice * self.freq_hz

    def token_latency(self, context_len: int = 512) -> Dict[str, float]:
        """Per-token decode latency breakdown (seconds) at a given KV
        context length."""
        cfg, n = self.cfg, self.nodes
        t_mp_mem = t_mp_cmp = t_mha = t_smax = t_crit = 0.0
        n_mp_stages = 0
        for st in scheduler.model_program(cfg):
            if st.kernel == "mp":
                t_mp_mem += (st.k * st.n / n) / self.node_bw
                t_mp_cmp += (st.k * st.n / n) / self.node_macs_per_s
                n_mp_stages += 1
            elif st.kernel == "mha":
                hd, H = st.k, st.n
                S = min(context_len, cfg.window or context_len)
                t_mha += (2 * S * cfg.n_kv_heads * hd / n) / self.node_bw
                if not self.headwise_pipeline:
                    t_smax += (H * S * self.softmax_cyc_per_score) \
                        / self.freq_hz
            elif st.kernel == "ln_res":
                passes = (self.ln_res_passes_fused if self.fuse_ln_res
                          else self.ln_res_passes_unfused)
                t_crit += (st.k * passes * self.vpu_cyc_per_elem) \
                    / self.freq_hz
        t_parallel = max(t_mp_mem, t_mp_cmp) + t_mha
        t_serial = t_crit + t_smax
        sync_bytes = cfg.d_model / n
        t_expose = (n - 1) * n_mp_stages * (
            self.quant_drain_cycles / self.freq_hz + sync_bytes / self.net_bw)
        if not self.hide_transmission and n > 1:
            t_expose += n_mp_stages * (n - 1) * (
                self.net_hop_latency + sync_bytes / self.net_bw)
        total = t_parallel + t_serial + t_expose
        return {
            "total": total,
            "mp": max(t_mp_mem, t_mp_cmp),
            "mp_mem": t_mp_mem,
            "mp_compute": t_mp_cmp,
            "mha": t_mha,
            "softmax_exposed": t_smax,
            "critical_path": t_crit,
            "expose": t_expose,
            "linear_mha_frac": t_parallel / total,
            "crit_frac": t_serial / total,
        }

    def prefill_token_latency(self) -> float:
        """Marginal cost of one pipelined prefill token (compute-bound
        against the same weight stream)."""
        macs = sum(st.k * st.n for st in scheduler.model_program(self.cfg)
                   if st.kernel == "mp")
        return macs / (self.node_macs_per_s * self.nodes
                       * self.prefill_pipeline_eff)
