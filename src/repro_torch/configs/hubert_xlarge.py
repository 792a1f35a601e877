"""HuBERT-XLarge: encoder-only transformer backbone (the wav2vec2 layout)
[arXiv:2106.07447].  The conv frontend is not part of the model: it takes
precomputed frame embeddings (``model.forward(embeds=)``); vocab=504 target
units.  Encoder-only: bidirectional attention and no decode path
(``configs.supports_decode``)."""
import torch

from ..models.config import BlockSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge", arch_type="audio", source="arXiv:2106.07447",
        num_layers=48, d_model=1280, num_heads=16, num_kv_heads=16,
        d_ff=5120, vocab_size=504,
        block_pattern=(BlockSpec("attn", "gelu"),),
        norm="layernorm", rope="none", causal=False,
        encoder_only=True, embedding_inputs=True,
    ).validate()


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="hubert-smoke", arch_type="audio", source="arXiv:2106.07447",
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=4,
        d_ff=256, vocab_size=64,
        block_pattern=(BlockSpec("attn", "gelu"),),
        norm="layernorm", rope="none", causal=False,
        encoder_only=True, embedding_inputs=True,
        param_dtype=torch.float32, compute_dtype=torch.float32,
    ).validate()
