"""Mamba-1 selective SSM block, Jamba's sequence mixer (port of
``repro/models/mamba.py``).

The projections and the 4-tap causal depthwise convolution are plain
PyTorch, as the reference leaves them to XLA; the selective scan is K5
(``kernels/dispatch.selective_scan``), in every mode: prefill and full
forward, decode, verify (B*k rows started from their slot's state) and the
gated replay (``mamba_mix_commit``), where the kernel keeps the state
after each row's accepted tokens.  The reference's replay
(``mamba_mix_steps``, kept here too) runs its own associative scan; here
one sequential kernel serves every mode, so a token's state has the same
arithmetic whichever call brought it.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..distributed import local as L
from ..kernels.dispatch import selective_scan
from .config import ModelConfig

Params = Dict[str, torch.Tensor]


def param_shapes(cfg: ModelConfig, R: int) -> Dict[str, tuple]:
    """(shape, init, dtype) of the R-stacked Mamba parameters.  ``A_log``
    (S4D-real), ``D`` and ``dt_bias`` stay float32 whatever the config's
    ``param_dtype``, as the reference makes them."""
    d, di, ds = cfg.d_model, cfg.mamba_d_inner, cfg.mamba_d_state
    dtr, dc, pd = cfg.resolved_dt_rank, cfg.mamba_d_conv, cfg.param_dtype
    f32 = torch.float32
    return {"in_proj": ((R, d, 2 * di), "dense", pd),
            "conv_w": ((R, dc, di), "dense", pd),
            "conv_b": ((R, di), "zeros", pd),
            "x_proj": ((R, di, dtr + 2 * ds), "dense", pd),
            "dt_proj": ((R, dtr, di), "dense", pd),
            "dt_bias": ((R, di), "dt_bias", f32),
            "A_log": ((R, di, ds), "a_log", f32),
            "D": ((R, di), "ones", f32),
            "out_proj": ((R, di, d), "dense", pd)}


def a_log_init(shape, device) -> torch.Tensor:
    """S4D-real: A[d, s] = s + 1, stored as its log."""
    ds = shape[-1]
    a = torch.arange(1, ds + 1, dtype=torch.float32, device=device)
    return torch.log(a).expand(shape).clone()


def dt_bias_init(shape, generator: torch.Generator, device) -> torch.Tensor:
    """softplus^-1 of dt drawn log-uniformly in [0.001, 0.1], floored at
    1e-4 (the reference's distribution; its numbers differ)."""
    lo, hi = torch.log(torch.tensor(0.001)), torch.log(torch.tensor(0.1))
    r = torch.rand(shape, generator=generator, dtype=torch.float32,
                   device=device)
    dt = torch.exp(r * (hi - lo) + lo).clamp(min=1e-4)
    return torch.log(torch.expm1(dt))


def _conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
          state: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv (the reference's ``_causal_conv_full``, in the
    same order of sums).  u: (B, T, di); w: (dc, di); state: (B, dc-1, di).
    Returns the output (B, T, di) and the extended input (B, T+dc-1, di),
    whose rows t..t+dc-2 are the conv state after t steps."""
    dc, T = w.shape[0], u.shape[1]
    ext = torch.cat([state.to(u.dtype), u], dim=1)
    out = torch.zeros_like(u)
    for i in range(dc):
        out = out + ext[:, i:i + T] * w[i].to(u.dtype)
    return out + b.to(u.dtype), ext


def _local(t):
    """A parameter as this rank's shard (a mixer's per-channel leaves
    under a mesh; the tensor itself without one)."""
    return t.to_local() if L.is_dtensor(t) else t


def _mix(params: Params, x: torch.Tensor, cfg: ModelConfig,
         conv_state: torch.Tensor, ssm_state: torch.Tensor, *, rep: int,
         final: bool, steps: bool, n_commit=None):
    """The block on x (B*rep, T, d) from per-slot states (B, ...), slot b's
    state serving rows b*rep .. b*rep+rep-1.  Returns (y (B*rep, T, d),
    conv ext, final ssm state (after ``n_commit`` steps where given) or
    None, per-step states or None).  u goes to the scan in the compute
    dtype (K5 upcasts it, as the reference kernel does).

    Under a mesh (``distributed/local.py``) x is this rank's local rows
    and the states this rank's channel shard (d_inner over "model" by the
    rules): the projections are products against the parameters' shards
    (``in_proj``'s output gathered over its columns, ``x_proj`` and
    ``out_proj`` reduced over the channels: partial sums), the conv and
    the scan run on the rank's channels alone, with no collective, and y
    is the DTensor of the global rows."""
    cd = cfg.compute_dtype
    dtr, ds = cfg.resolved_dt_rank, cfg.mamba_d_state
    rows = L.current()
    if rows is None:
        xz = x.to(cd) @ params["in_proj"].to(cd)
        u, z = xz.chunk(2, dim=-1)
    else:
        lo, hi, _ = L.state_dims("ssm", (1, 1, cfg.mamba_d_inner, ds))[2]
        u, z = L.lower(L.product(x.to(cd), params["in_proj"])).chunk(2, -1)
        u, z = u[..., lo:hi], z[..., lo:hi]
    if rep > 1:
        conv_state = conv_state.repeat_interleave(rep, dim=0)
    u, ext = _conv(u, _local(params["conv_w"]), _local(params["conv_b"]),
                   conv_state)
    u = F.silu(u)
    if rows is None:
        proj = (u @ params["x_proj"].to(cd)).float()
    else:
        proj = L.lower(L.product(u, params["x_proj"])).float()
    dt_low, Bm, Cm = proj.split([dtr, ds, ds], dim=-1)
    dt = F.softplus(dt_low @ _local(params["dt_proj"]).float()
                    + _local(params["dt_bias"]))
    A = -torch.exp(_local(params["A_log"]))
    y, hT, hs = selective_scan(u, dt, A, Bm, Cm, _local(params["D"]),
                               ssm_state, h0_rep=rep, final=final,
                               steps=steps, n_commit=n_commit)
    y = y.to(cd) * F.silu(z)
    if rows is None:
        y = y @ params["out_proj"].to(cd)
    else:
        y = L.to_rows(L.product(y, params["out_proj"]))
    return y, ext, hT, hs


def mamba_mix(params: Params, x: torch.Tensor, cfg: ModelConfig,
              conv_state: torch.Tensor, ssm_state: torch.Tensor, *,
              rep: int = 1, final: bool = True
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full block for prefill (T large), decode (T = 1) and verify.

    conv_state: (B, dc-1, di); ssm_state: (B, di, ds) f32; x: (B*rep, T, d)
    with slot b's state serving its ``rep`` rows (verify: rep = k).  Returns
    (y (B*rep, T, d), new conv state, new ssm state (None unless
    ``final``))."""
    y, ext, hT, _ = _mix(params, x, cfg, conv_state, ssm_state, rep=rep,
                         final=final, steps=False)
    return y, ext[:, x.shape[1]:], hT


def mamba_mix_steps(params: Params, x: torch.Tensor, cfg: ModelConfig,
                    conv_state: torch.Tensor, ssm_state: torch.Tensor):
    """Like ``mamba_mix`` but returns the per-step states, from which the
    speculative commit selects the winner's state after n accepted tokens.

    Returns (y, conv_ext (B, T+dc-1, di), ssm_steps (B, T, di, ds)): the
    state after t steps is conv = conv_ext[:, t:t+dc-1], ssm =
    ssm_steps[:, t-1].  CPU tensors only: K5 writes no per-step states (the
    replay is ``mamba_mix_commit``)."""
    y, ext, _, hs = _mix(params, x, cfg, conv_state, ssm_state, rep=1,
                         final=False, steps=True)
    return y, ext, hs


def mamba_mix_commit(params: Params, x: torch.Tensor, cfg: ModelConfig,
                     conv_state: torch.Tensor, ssm_state: torch.Tensor,
                     n_commit: torch.Tensor):
    """The gated replay's block: ``mamba_mix_steps`` then
    ``cache.select_step_state`` on the ssm states, with the selection made
    by the scan itself (only the kept state is written).

    n_commit: (B,) int32, the steps each row keeps.  Returns (y, conv_ext
    (B, T+dc-1, di), the ssm state after n_commit[b] steps (B, di, ds),
    ``ssm_state[b]`` where that is 0)."""
    y, ext, hT, _ = _mix(params, x, cfg, conv_state, ssm_state, rep=1,
                         final=True, steps=False, n_commit=n_commit)
    return y, ext, hT


def init_mamba_state(cfg: ModelConfig, batch: int, device
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Empty (conv, ssm) states of ``batch`` rows (under a mesh: this
    rank's rows and channel shard)."""
    conv = torch.zeros((batch, cfg.mamba_d_conv - 1, cfg.mamba_d_inner),
                       dtype=cfg.compute_dtype, device=device)
    ssm = torch.zeros((batch, cfg.mamba_d_inner, cfg.mamba_d_state),
                      dtype=torch.float32, device=device)
    return (L.local_leaf("conv", conv, stacked=False),
            L.local_leaf("ssm", ssm, stacked=False))
