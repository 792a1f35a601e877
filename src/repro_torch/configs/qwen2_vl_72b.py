"""Qwen2-VL-72B language backbone: M-RoPE, GQA kv=8 [arXiv:2409.12191].
The vision frontend is not part of the model: text tokens carry equal
t/h/w positions (``model.make_positions``); mrope_sections = (16, 24, 24)
rotary half-dims for t, h and w."""
import torch

from ..models.config import BlockSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-72b", arch_type="vlm", source="arXiv:2409.12191",
        num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8,
        d_ff=29568, vocab_size=152064,
        block_pattern=(BlockSpec("attn", "swiglu"),),
        norm="rmsnorm", rope="mrope", rope_theta=1e6,
        mrope_sections=(16, 24, 24),
    ).validate()


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-smoke", arch_type="vlm", source="arXiv:2409.12191",
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
        d_ff=256, vocab_size=512,
        block_pattern=(BlockSpec("attn", "swiglu"),),
        norm="rmsnorm", rope="mrope", rope_theta=1e6,
        mrope_sections=(6, 5, 5),
        param_dtype=torch.float32, compute_dtype=torch.float32,
    ).validate()
