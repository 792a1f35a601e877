"""Mistral-7B, the paper's own evaluation model: GQA kv=8, RoPE theta 1e6,
a 4096-token sliding window (a ring KV cache) [arXiv:2310.06825]."""
import torch

from ..models.config import BlockSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mistral-7b", arch_type="dense", source="arXiv:2310.06825",
        num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
        d_ff=14336, vocab_size=32000,
        block_pattern=(BlockSpec("attn", "swiglu"),),
        norm="rmsnorm", rope="rope", rope_theta=1e6,
        sliding_window=4096,
    ).validate()


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mistral-7b-smoke", arch_type="dense", source="arXiv:2310.06825",
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
        d_ff=256, vocab_size=512,
        block_pattern=(BlockSpec("attn", "swiglu"),),
        norm="rmsnorm", rope="rope", rope_theta=1e6, sliding_window=64,
        param_dtype=torch.float32, compute_dtype=torch.float32,
    ).validate()
