"""Jamba-1.5-Large (398B): Mamba+attention 1:7 interleave, MoE 16e top-2
[arXiv:2403.19887].  Period-8 pattern: attention at offset 4, MoE on odd
layers; no explicit positional encoding (Jamba uses none)."""
import dataclasses

import torch

from ..models.config import MOE, SWIGLU, BlockSpec, ModelConfig

_PATTERN = tuple(
    BlockSpec("attn" if p == 4 else "mamba",
              "moe" if p % 2 == 1 else "swiglu")
    for p in range(8))


def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-1.5-large-398b", arch_type="hybrid",
        source="arXiv:2403.19887",
        num_layers=72, d_model=8192, num_heads=64, num_kv_heads=8,
        d_ff=24576, vocab_size=65536,
        block_pattern=_PATTERN,
        num_experts=16, num_experts_per_tok=2,
        mamba_d_state=16, mamba_d_conv=4, mamba_expand=2,
        norm="rmsnorm", rope="none",
    ).validate()


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="jamba-smoke", arch_type="hybrid", source="arXiv:2403.19887",
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
        d_ff=256, vocab_size=512,
        block_pattern=(BlockSpec("mamba", "moe"), BlockSpec("attn", "swiglu")),
        num_experts=4, num_experts_per_tok=2,
        mamba_d_state=8, mamba_d_conv=4, mamba_expand=2,
        norm="rmsnorm", rope="none",
        param_dtype=torch.float32, compute_dtype=torch.float32,
    ).validate()


def no_experts(cfg: ModelConfig, periods: int = 1) -> ModelConfig:
    """``cfg`` (``config()`` or ``smoke_config()``) cut to its first
    ``periods`` periods of the layer pattern, with every MoE FFN replaced by
    the config's dense SwiGLU at d_ff.

    Widths stay the published config's (d_model 8192, 64 heads / 8 KV
    heads, Mamba d_inner 16384, d_state 16, vocab 65536).  Depth: 72
    layers (9 periods) cut to ``periods`` * 8, default 8 (7 Mamba + 1
    attention).  Experts: one 16-expert MoE FFN holds 16 x 3 x 8192 x 24576
    = 9.66 B parameters, 19.3 GB in bf16, and a period has four of them
    (77 GB), more than one card holds beside anything else; Jamba's non-MoE
    layers already use this dense SwiGLU, so the cut keeps every mixer and
    every dense FFN shape the model has, at about 9.0 B parameters (18 GB
    bf16) for one period.  ``with_experts`` keeps the experts instead and
    cuts the period.
    """
    pattern = tuple(BlockSpec(b.mixer, SWIGLU if b.mlp == MOE else b.mlp)
                    for b in cfg.block_pattern)
    return dataclasses.replace(
        cfg, name=f"{cfg.name}-dense-{periods}p",
        num_layers=len(cfg.prefix_blocks) + periods * len(pattern),
        block_pattern=pattern, num_experts=0).validate()


def with_experts(cfg: ModelConfig, layers: int = 5,
                 start: int = 0) -> ModelConfig:
    """``cfg`` cut to ONE period of ``layers`` blocks of its pattern, from
    offset ``start``, every MoE FFN kept with all its experts.

    Widths stay the published config's.  The default, offsets 0-4 of
    ``config()``, is Mamba/SwiGLU, Mamba/MoE, Mamba/SwiGLU, Mamba/MoE,
    attention/SwiGLU: every mixer and FFN kind of the model, two 16-expert
    MoE FFNs (9.66 B parameters each) among about 24 B parameters, 48 GB
    in bf16.  ``start=2, layers=3`` (Mamba/SwiGLU, Mamba/MoE,
    attention/SwiGLU) holds one MoE FFN in about 12 B parameters.
    """
    pattern = tuple(cfg.block_pattern[start:start + layers])
    if len(pattern) != layers or cfg.prefix_blocks:
        raise ValueError(f"{cfg.name}: no {layers} blocks from offset "
                         f"{start} in a period of {cfg.pattern_period}")
    return dataclasses.replace(
        cfg, name=f"{cfg.name}-experts-{start}+{layers}", num_layers=layers,
        block_pattern=pattern).validate()
