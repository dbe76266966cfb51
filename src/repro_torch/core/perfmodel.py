"""Analytic performance models: LoopLynx FPGA, the paper's A100 baseline,
and the H100 roofline.

``FPGAPerfModel`` is a copy of the JAX package's
``repro/core/perfmodel.py``: it walks the stage program
(:mod:`repro_torch.core.scheduler`) and prices each stage against the
paper's FPGA constants (8 HBM channels x 8.49 GB/s per node, 16 x 32 MACs
at 285 MHz).  The serving engine uses it for the per-tick prefill token
budget (``serving/admission.py``) and the ``*_modeled_s`` counters beside
the measured times.  ``A100Model`` and the ``PAPER_*`` tables are the
paper's comparison setup.  All of these are model numbers of the paper's
hardware, not of the H100 this package runs on.

:func:`roofline_terms` keeps the reference's formula and keys with the
H100 SXM data-sheet constants (``H100_*``): the least time one card could
take for a step's operations, bytes and collective traffic.
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

    def tokens_per_second(self, context_len: int = 512) -> float:
        return 1.0 / self.token_latency(context_len)["total"]

    def prefill_token_latency(self) -> float:
        """Marginal cost of one pipelined prefill token (compute-bound
        against the same weight stream)."""
        macs = sum(st.k * st.n for st in scheduler.model_program(self.cfg)
                   if st.kernel == "mp")
        return macs / (self.node_macs_per_s * self.nodes
                       * self.prefill_pipeline_eff)

    def request_latency(self, n_in: int, n_out: int) -> float:
        """End-to-end [input:output] latency."""
        t_pre = n_in * self.prefill_token_latency()
        t_dec = n_out * self.token_latency(n_in + n_out // 2)["total"]
        return t_pre + t_dec


#: power draw (W), derived from the paper's energy-efficiency ratios
#: (2.3x/2.7x/2.1x against the A100 at 1/2/4 nodes): 1 node is half a U50,
#: 2 nodes one U50, 4 nodes two; the A100 as measured (not its TDP)
POWER_W = {"a100": 150.0, 1: 57.7, 2: 88.6, 4: 181.0}

#: the paper's published numbers (Table II latency in s/token, its
#: baselines, Table III throughput in tokens/s)
PAPER_TABLE2 = {1: 6.59e-3, 2: 3.85e-3, 4: 2.55e-3}
PAPER_BASELINES = {"dfx_u280": 5.37e-3, "spatial_u280": 4.17e-3}
PAPER_TABLE3 = {1: 151.7, 2: 259.7, 4: 392.2}


@dataclasses.dataclass
class A100Model:
    """The paper's A100 baseline (torch-int W8A8), calibrated to its Fig-8
    averages (1.67x at 2 nodes, 2.52x at 4) and the [128:32] crossover:
    7.7 ms per decode token (launch-latency bound at small batch) and
    prefill batched at 3k tokens/s."""

    t_decode: float = 7.7e-3
    prefill_tok_per_s: float = 3000.0

    def request_latency(self, n_in: int, n_out: int) -> float:
        return n_in / self.prefill_tok_per_s + n_out * self.t_decode


#: NVIDIA H100 SXM data sheet: HBM3 rate, dense tensor-core peaks, float32
#: outside the tensor cores, and NVLink 4 per direction
H100_HBM_BW = 3.35e12  # B/s
H100_PEAK_FLOPS = 989e12  # dense bf16
H100_PEAK_INT8 = 1979e12  # dense int8
H100_PEAK_F32 = 67e12
H100_NVLINK_BW = 450e9  # B/s per direction
#: the peaks by operand type
H100_PEAK_OPS = {"int8": H100_PEAK_INT8, "bf16": H100_PEAK_FLOPS,
                 "f32": H100_PEAK_F32}


def roofline_terms(
    flops_per_device: float,
    bytes_per_device: float,
    collective_bytes_per_device: float,
) -> Dict[str, float]:
    """The three roofline terms of one step on one card, in seconds:
    operations at the bf16 peak, bytes at the HBM rate, collective bytes
    at the NVLink rate."""
    t_c = flops_per_device / H100_PEAK_FLOPS
    t_m = bytes_per_device / H100_HBM_BW
    t_x = collective_bytes_per_device / H100_NVLINK_BW
    dominant = max((t_c, "compute"), (t_m, "memory"),
                   (t_x, "collective"))[1]
    bound = max(t_c, t_m, t_x)
    return {
        "compute_s": t_c,
        "memory_s": t_m,
        "collective_s": t_x,
        "dominant": dominant,
        "bound_s": bound,
        # how much of the binding resource the useful work keeps busy if
        # the three overlap perfectly
        "overlap_efficiency": bound / max(t_c + t_m + t_x, 1e-30),
    }


def model_flops(cfg: ModelConfig, kind: str, seq_len: int,
                global_batch: int) -> float:
    """MODEL_FLOPS: 6*N*D for training, 2*N*D forward only (N = active
    params for MoE; D = tokens processed by the step)."""
    n_active = cfg.param_counts()["active"]
    if kind == "train":
        return 6.0 * n_active * seq_len * global_batch
    if kind == "prefill":
        return 2.0 * n_active * seq_len * global_batch
    return 2.0 * n_active * global_batch  # decode: one token a sequence
