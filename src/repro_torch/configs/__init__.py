"""Architecture registry of the port: the reference's eleven
architectures (its ten assigned ones and the paper's own Mistral-7B), in
the reference's order.

``get_config(arch)`` / ``get_smoke_config(arch)`` mirror the reference's
``repro/configs`` entry points.  ``long_context_variant`` applies the
sliding-window KV-cache variant that turns a full-attention dense config
into a ring of ``LONG_CONTEXT_WINDOW`` positions.
"""
from __future__ import annotations

import dataclasses
from typing import List

from ..models.config import ATTN, ModelConfig
from . import (deepseek_moe_16b, gemma_2b, glm4_9b, hubert_xlarge,
               jamba_1_5_large_398b, mistral_7b, mixtral_8x7b,
               nemotron_4_340b, qwen2_vl_72b, stablelm_1_6b, xlstm_125m)

_MODULES = {
    "jamba-1.5-large-398b": jamba_1_5_large_398b,
    "xlstm-125m": xlstm_125m,
    "qwen2-vl-72b": qwen2_vl_72b,
    "stablelm-1.6b": stablelm_1_6b,
    "gemma-2b": gemma_2b,
    "hubert-xlarge": hubert_xlarge,
    "mixtral-8x7b": mixtral_8x7b,
    "nemotron-4-340b": nemotron_4_340b,
    "glm4-9b": glm4_9b,
    "deepseek-moe-16b": deepseek_moe_16b,
    "mistral-7b": mistral_7b,            # the paper's own model
}

ALL_ARCHS: List[str] = list(_MODULES)
ASSIGNED_ARCHS: List[str] = [a for a in _MODULES if a != "mistral-7b"]

LONG_CONTEXT_WINDOW = 8192


def get_config(arch: str) -> ModelConfig:
    return _MODULES[arch].config()


def get_smoke_config(arch: str) -> ModelConfig:
    return _MODULES[arch].smoke_config()


def long_context_variant(cfg: ModelConfig) -> ModelConfig:
    """Sliding-window variant for long decode on full-attention archs: the
    KV cache becomes a ring of LONG_CONTEXT_WINDOW positions.  Archs
    without attention and natively windowed archs are returned
    unchanged."""
    has_attn = any(b.mixer == ATTN
                   for b in (tuple(cfg.prefix_blocks)
                             + tuple(cfg.block_pattern)))
    if not has_attn or cfg.sliding_window is not None:
        return cfg
    return dataclasses.replace(
        cfg, name=cfg.name + "+swa", sliding_window=LONG_CONTEXT_WINDOW)


def supports_decode(cfg: ModelConfig) -> bool:
    return not cfg.encoder_only


def supports_long_decode(cfg: ModelConfig) -> bool:
    """Sub-quadratic decode at long context: recurrent and hybrid archs
    natively, attention archs through a sliding window (native or the
    +swa variant); encoder-only archs do not decode."""
    return not cfg.encoder_only
