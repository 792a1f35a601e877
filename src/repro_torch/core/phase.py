"""Analytic memory-bound -> compute-bound phase model of one verify call
(paper §3 / Fig. 1; port of ``repro/core/phase.py``), priced for one NVIDIA
H100.

The paper measures the slowdown of a (k, w+1) verification call against a
(1, 1) decode call and observes the phase transition where the matmuls
cross the card's operations-to-bytes ratio.  The call time is derived
from the FLOPs and bytes of each component (weight loads, KV reads, GEMM
compute): each matmul contributes max(flops / peak, bytes / bandwidth), its
roofline time, summed over the layers.  The adaptive (k, w) controller
(``core/controller.py``) divides measured acceptance by this slowdown.

The constants are the H100 SXM data sheet's: 989e12 dense bf16 FLOP/s and
3.35e12 B/s of HBM.
"""
from __future__ import annotations

import dataclasses

from ..models.config import ATTN, MAMBA, MOE, ModelConfig, layer_blocks

PEAK_FLOPS = 989e12        # H100 SXM dense bf16 FLOP/s
HBM_BW = 3.35e12           # H100 SXM HBM bytes/s
BYTES_PER_EL = 2           # bf16


@dataclasses.dataclass
class CallCost:
    flops: float
    hbm_bytes: float

    @property
    def time(self) -> float:
        """Roofline execution time (s) on one card."""
        return max(self.flops / PEAK_FLOPS, self.hbm_bytes / HBM_BW)

    @property
    def compute_bound(self) -> bool:
        return self.flops / PEAK_FLOPS > self.hbm_bytes / HBM_BW

    def __add__(self, o: "CallCost") -> "CallCost":
        return CallCost(self.flops + o.flops, self.hbm_bytes + o.hbm_bytes)

    def __mul__(self, s: float) -> "CallCost":
        return CallCost(self.flops * s, self.hbm_bytes * s)

    __rmul__ = __mul__


def _gemm(m: int, n: int, kk: int) -> CallCost:
    """(m, k) x (k, n) matmul: one matmul's roofline term."""
    return CallCost(2.0 * m * n * kk,
                    BYTES_PER_EL * (m * kk + kk * n + m * n))


def verify_call_cost(cfg: ModelConfig, ell: int, k: int, w: int,
                     shared_cache: bool = True) -> CallCost:
    """Cost of one verification model call: batch (k, w+1), context ell.

    ``shared_cache=False`` models the paper's layout (KV replicated k times,
    re-read per row); ``True`` the bifurcated layout (read once).
    """
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H, KV = cfg.num_heads, cfg.num_kv_heads
    t = k * (w + 1)              # query tokens in the call
    total = CallCost(0.0, 0.0)
    for b in layer_blocks(cfg):
        if b.mixer == ATTN:
            total += _gemm(t, H * hd, d) + _gemm(t, KV * hd, d) * 2
            total += _gemm(t, d, H * hd)
            # attention scores and values against the cache
            ctx = min(ell, cfg.sliding_window or ell)
            cache_reads = 1 if shared_cache else k
            flops = 2.0 * k * (w + 1) * ctx * H * hd * 2   # qk^T and pv
            flops += 2.0 * k * (w + 1) * (w + 1) * H * hd * 2
            kv_bytes = BYTES_PER_EL * cache_reads * ctx * KV * hd * 2
            total += CallCost(flops, kv_bytes)
        else:
            # recurrent mixers: state-sized read/write plus projections
            di = cfg.mamba_d_inner if b.mixer == MAMBA else 2 * d
            total += _gemm(t, 2 * di, d) + _gemm(t, d, di)
            total += CallCost(2.0 * t * di * 16,
                              4 * di * 16 * 2)  # state update (f32)
        if b.mlp == MOE:
            e_ff = cfg.expert_d_ff
            n_act = cfg.num_experts_per_tok + cfg.num_shared_experts
            # active expert FLOPs; weight bytes of every touched expert
            touched = min(cfg.num_experts, t * cfg.num_experts_per_tok)
            total += CallCost(2.0 * 3 * t * n_act * d * e_ff,
                              BYTES_PER_EL * 3 * d * e_ff * touched)
        elif b.mlp in ("swiglu", "geglu"):
            total += _gemm(t, cfg.d_ff, d) * 2 + _gemm(t, d, cfg.d_ff)
        elif b.mlp in ("relu2", "gelu"):
            total += _gemm(t, cfg.d_ff, d) + _gemm(t, d, cfg.d_ff)
    total += _gemm(t, cfg.vocab_size, d)   # lm head
    return total


def slowdown(cfg: ModelConfig, ell: int, k: int, w: int,
             shared_cache: bool = True) -> float:
    """Fig. 1's quantity: time(k, w+1 | ell) / time(1, 1 | ell)."""
    base = verify_call_cost(cfg, ell, 1, 0, shared_cache).time
    return verify_call_cost(cfg, ell, k, w, shared_cache).time / base

