"""Gemma-2B: GeGLU, head_dim=256, MQA (kv=1), tied + scaled embeddings
[arXiv:2403.08295]."""
import torch

from ..models.config import BlockSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma-2b", arch_type="dense", source="arXiv:2403.08295",
        num_layers=18, d_model=2048, num_heads=8, num_kv_heads=1,
        head_dim=256, d_ff=16384, vocab_size=256000,
        block_pattern=(BlockSpec("attn", "geglu"),),
        norm="rmsnorm", rope="rope",
        tie_embeddings=True, scale_embed=True,
    ).validate()


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="gemma-smoke", arch_type="dense", source="arXiv:2403.08295",
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=1,
        head_dim=64, d_ff=256, vocab_size=512,
        block_pattern=(BlockSpec("attn", "geglu"),),
        norm="rmsnorm", rope="rope",
        tie_embeddings=True, scale_embed=True,
        param_dtype=torch.float32, compute_dtype=torch.float32,
    ).validate()
