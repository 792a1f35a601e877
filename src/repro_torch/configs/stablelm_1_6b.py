"""StableLM-2-1.6B: MHA (kv=32), 25% partial rotary, LayerNorm
[hf:stabilityai/stablelm-2-1_6b]."""
import torch

from ..models.config import BlockSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-1.6b", arch_type="dense",
        source="hf:stabilityai/stablelm-2-1_6b",
        num_layers=24, d_model=2048, num_heads=32, num_kv_heads=32,
        d_ff=5632, vocab_size=100352,
        block_pattern=(BlockSpec("attn", "swiglu"),),
        norm="layernorm", rope="rope", partial_rotary_factor=0.25,
    ).validate()


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-smoke", arch_type="dense",
        source="hf:stabilityai/stablelm-2-1_6b",
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=4,
        d_ff=256, vocab_size=512,
        block_pattern=(BlockSpec("attn", "swiglu"),),
        norm="layernorm", rope="rope", partial_rotary_factor=0.25,
        param_dtype=torch.float32, compute_dtype=torch.float32,
    ).validate()
