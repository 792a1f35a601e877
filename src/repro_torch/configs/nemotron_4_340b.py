"""Nemotron-4-340B: GQA kv=8, squared-ReLU MLP, 50% partial rotary,
LayerNorm [arXiv:2402.16819]."""
import torch

from ..models.config import BlockSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-340b", arch_type="dense", source="arXiv:2402.16819",
        num_layers=96, d_model=18432, num_heads=96, num_kv_heads=8,
        d_ff=73728, vocab_size=256000,
        block_pattern=(BlockSpec("attn", "relu2"),),
        norm="layernorm", rope="rope", partial_rotary_factor=0.5,
    ).validate()


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="nemotron-smoke", arch_type="dense", source="arXiv:2402.16819",
        num_layers=2, d_model=192, num_heads=4, num_kv_heads=2,
        d_ff=384, vocab_size=512,
        block_pattern=(BlockSpec("attn", "relu2"),),
        norm="layernorm", rope="rope", partial_rotary_factor=0.5,
        param_dtype=torch.float32, compute_dtype=torch.float32,
    ).validate()
