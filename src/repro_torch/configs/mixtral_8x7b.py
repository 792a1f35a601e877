"""Mixtral-8x7B: 8 experts top-2, GQA kv=8, sliding-window attention
[arXiv:2401.04088]."""
import torch

from ..models.config import BlockSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b", arch_type="moe", source="arXiv:2401.04088",
        num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
        d_ff=14336, vocab_size=32000,
        block_pattern=(BlockSpec("attn", "moe"),),
        num_experts=8, num_experts_per_tok=2,
        norm="rmsnorm", rope="rope", rope_theta=1e6,
        sliding_window=4096,
    ).validate()


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-smoke", arch_type="moe", source="arXiv:2401.04088",
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
        d_ff=256, vocab_size=512,
        block_pattern=(BlockSpec("attn", "moe"),),
        num_experts=4, num_experts_per_tok=2,
        norm="rmsnorm", rope="rope", rope_theta=1e6, sliding_window=64,
        param_dtype=torch.float32, compute_dtype=torch.float32,
    ).validate()
