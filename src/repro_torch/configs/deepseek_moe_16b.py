"""DeepSeek-MoE-16B: fine-grained experts (64 routed top-6, width 1408) +
2 shared experts; dense first layer (d_ff=10944) [arXiv:2401.06066]."""
import torch

from ..models.config import BlockSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b", arch_type="moe", source="arXiv:2401.06066",
        num_layers=28, d_model=2048, num_heads=16, num_kv_heads=16,
        d_ff=10944, moe_d_ff=1408, vocab_size=102400,
        prefix_blocks=(BlockSpec("attn", "swiglu"),),
        block_pattern=(BlockSpec("attn", "moe"),),
        num_experts=64, num_experts_per_tok=6, num_shared_experts=2,
        norm="rmsnorm", rope="rope",
    ).validate()


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-smoke", arch_type="moe", source="arXiv:2401.06066",
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=4,
        d_ff=256, moe_d_ff=64, vocab_size=512,
        prefix_blocks=(BlockSpec("attn", "swiglu"),),
        block_pattern=(BlockSpec("attn", "moe"),),
        num_experts=4, num_experts_per_tok=2, num_shared_experts=1,
        norm="rmsnorm", rope="rope",
        param_dtype=torch.float32, compute_dtype=torch.float32,
    ).validate()
