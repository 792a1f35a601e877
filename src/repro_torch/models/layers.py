"""Shared layers: norms, MLP variants, embeddings, init helpers (port of
``repro/models/layers.py``).

Parameters are plain nested dicts of tensors with the reference's names and
layouts (``x @ w``, weights (in, out)).  Every random draw goes through an
explicit ``torch.Generator``.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from ..distributed import local as L
from .config import GEGLU, GELU, RELU2, SWIGLU, ModelConfig

Params = Dict[str, torch.Tensor]


# ----------------------------------------------------------------------------
# init helpers (the reference's distributions; numbers differ, as the RNGs do)
# ----------------------------------------------------------------------------
def dense_init(shape, dtype, generator: torch.Generator, device,
               scale: float = 1.0, fan_in: int = 0) -> torch.Tensor:
    """Truncated-normal fan-in init: std * N(0, 1) cut to [-2, 2], with the
    fan-in taken from the second-to-last dim unless given (stacked (R, in,
    out) weights get each layer's own fan-in, as the reference's vmapped
    init does)."""
    std = scale / ((fan_in or shape[-2]) ** 0.5)
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t.mul_(std).to(dtype)      # in place: one f32 copy at a time


def embed_init(shape, dtype, generator: torch.Generator,
               device) -> torch.Tensor:
    t = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=device)
    return t.mul_(0.02).to(dtype)


# ----------------------------------------------------------------------------
# norms
# ----------------------------------------------------------------------------
def apply_norm(params: Params, x: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    xf = x.float()
    if cfg.norm == "rmsnorm":
        var = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + cfg.norm_eps)
        return (y * params["scale"].float()).to(x.dtype)
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mean) * torch.rsqrt(var + cfg.norm_eps)
    y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)


# ----------------------------------------------------------------------------
# MLPs
# ----------------------------------------------------------------------------
def _gelu(x, approx: bool):
    return F.gelu(x, approximate="tanh" if approx else "none")


def apply_mlp(params: Params, x: torch.Tensor, cfg: ModelConfig,
              kind: str) -> torch.Tensor:
    cd = cfg.compute_dtype
    x = x.to(cd)
    if kind == SWIGLU:
        g = F.silu(x @ params["w_gate"].to(cd))
        u = x @ params["w_up"].to(cd)
        return (g * u) @ params["w_down"].to(cd)
    if kind == GEGLU:
        g = _gelu(x @ params["w_gate"].to(cd), cfg.gelu_approx)
        u = x @ params["w_up"].to(cd)
        return (g * u) @ params["w_down"].to(cd)
    if kind == RELU2:  # squared ReLU (Nemotron-4)
        h = torch.relu(x @ params["w_up"].to(cd)).square()
        return h @ params["w_down"].to(cd)
    if kind == GELU:
        h = _gelu(x @ params["w_up"].to(cd), cfg.gelu_approx)
        return h @ params["w_down"].to(cd)
    raise ValueError(kind)


# ----------------------------------------------------------------------------
# embeddings / head
# ----------------------------------------------------------------------------
def embed_tokens(params: Params, tokens: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """The token embeddings; under a mesh (``tokens`` this rank's rows),
    the DTensor of every rank's rows, the table left in its shards."""
    if L.current() is not None:
        x = L.embed_rows(params["embedding"], tokens).to(cfg.compute_dtype)
    else:
        x = params["embedding"][tokens.long()].to(cfg.compute_dtype)
    if cfg.scale_embed:  # Gemma
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cfg.compute_dtype)
    return x


def lm_logits(params: Params, x: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    """f32 logits; on a DTensor ``x`` of rows, the DTensor of the rows with
    the vocabulary whole, the head left in its shards."""
    cd = cfg.compute_dtype
    if cfg.tie_embeddings:
        w = params["embedding"].to(cd).T
    else:
        w = params["lm_head"].to(cd)
    if L.current() is not None:
        return L.matmul_rows(x.to(cd), w).float()
    return (x.to(cd) @ w).float()
