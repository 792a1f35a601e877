"""GLM-4-9B: GQA kv=2, RoPE (half), SwiGLU [hf:THUDM/glm-4-9b]."""
import torch

from ..models.config import BlockSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="glm4-9b", arch_type="dense", source="hf:THUDM/glm-4-9b",
        num_layers=40, d_model=4096, num_heads=32, num_kv_heads=2,
        d_ff=13696, vocab_size=151552,
        block_pattern=(BlockSpec("attn", "swiglu"),),
        norm="rmsnorm", rope="rope", partial_rotary_factor=0.5,
    ).validate()


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="glm4-smoke", arch_type="dense", source="hf:THUDM/glm-4-9b",
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
        d_ff=256, vocab_size=512,
        block_pattern=(BlockSpec("attn", "swiglu"),),
        norm="rmsnorm", rope="rope", partial_rotary_factor=0.5,
        param_dtype=torch.float32, compute_dtype=torch.float32,
    ).validate()
