"""xLSTM-125M: sLSTM + mLSTM blocks, no separate FFN sub-layer
[arXiv:2405.04517].  Period-4 pattern (3 mLSTM : 1 sLSTM ~ the paper's
mLSTM-heavy ratios)."""
import torch

from ..models.config import BlockSpec, ModelConfig

_PATTERN = (BlockSpec("mlstm", "none"), BlockSpec("mlstm", "none"),
            BlockSpec("mlstm", "none"), BlockSpec("slstm", "none"))


def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-125m", arch_type="ssm", source="arXiv:2405.04517",
        num_layers=12, d_model=768, num_heads=4, num_kv_heads=4,
        d_ff=0, vocab_size=50304,
        block_pattern=_PATTERN,
        norm="layernorm", rope="none",
    ).validate()


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-smoke", arch_type="ssm", source="arXiv:2405.04517",
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=4,
        d_ff=0, vocab_size=512,
        block_pattern=(BlockSpec("mlstm", "none"), BlockSpec("slstm", "none")),
        norm="layernorm", rope="none",
        param_dtype=torch.float32, compute_dtype=torch.float32,
    ).validate()
