"""Model configuration (port of ``repro/models/config.py``), torch dtypes.

One dataclass describes every architecture family of the reference; layers
are a repeating ``block_pattern`` of (mixer, mlp) pairs, with parameters
stacked over the ``R = num_layers / period`` repetitions.  The reference's
``backend`` and ``kernel_block_s`` knobs have no counterpart: a tensor on
the card always takes the CUDA kernels, a tensor on the CPU their plain
versions (``kernels/dispatch.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

# Mixer kinds (sequence-mixing sublayer).
ATTN = "attn"
MAMBA = "mamba"
MLSTM = "mlstm"
SLSTM = "slstm"

# MLP kinds (channel-mixing sublayer).
SWIGLU = "swiglu"
GEGLU = "geglu"
RELU2 = "relu2"  # squared-ReLU (Nemotron-4)
GELU = "gelu"    # plain 2-layer GELU MLP (HuBERT)
MOE = "moe"
NO_MLP = "none"  # xLSTM blocks carry their own projections

ROPE_NONE = "none"
ROPE = "rope"
MROPE = "mrope"  # Qwen2-VL multimodal 3D RoPE


def as_torch_dtype(dt) -> torch.dtype:
    """A torch dtype from a torch dtype, a dtype name, or a numpy-style
    scalar type (such as the reference configs' dtypes)."""
    if isinstance(dt, torch.dtype):
        return dt
    if isinstance(dt, str):
        name = dt
    else:
        name = getattr(getattr(dt, "dtype", None), "name", None) \
            or np.dtype(dt).name
    out = getattr(torch, name, None)
    if not isinstance(out, torch.dtype):
        raise ValueError(f"no torch dtype named {name!r}")
    return out


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    """One layer position inside the repeating pattern."""
    mixer: str = ATTN
    mlp: str = SWIGLU


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    arch_type: str = "dense"  # dense | moe | ssm | hybrid | vlm | audio
    source: str = ""          # citation (arXiv id / model card)

    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 0          # 0 -> d_model // num_heads
    d_ff: int = 1024
    vocab_size: int = 512

    # Repeating layer pattern; len must divide num_layers (after prefix).
    block_pattern: Tuple[BlockSpec, ...] = (BlockSpec(),)
    # Layers preceding the periodic body (e.g. DeepSeek-MoE dense layer 0).
    prefix_blocks: Tuple[BlockSpec, ...] = ()

    # Norm
    norm: str = "rmsnorm"      # rmsnorm | layernorm
    norm_eps: float = 1e-5
    qk_norm: bool = False

    # Positional encoding
    rope: str = ROPE
    rope_theta: float = 10_000.0
    partial_rotary_factor: float = 1.0   # StableLM-2: 0.25, Nemotron: 0.5
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)

    # Attention
    causal: bool = True
    sliding_window: Optional[int] = None  # Mixtral: 4096
    attn_logit_softcap: Optional[float] = None

    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 2
    num_shared_experts: int = 0
    moe_d_ff: int = 0
    router_aux_loss_coef: float = 0.01
    moe_impl: str = "scatter"
    capacity_factor: float = 2.0

    # Mamba (Jamba)
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    mamba_dt_rank: int = 0

    # xLSTM
    xlstm_mlstm_proj_factor: float = 2.0
    xlstm_slstm_proj_factor: float = 4.0 / 3.0
    xlstm_conv_kernel: int = 4

    # Embedding / head
    tie_embeddings: bool = False
    scale_embed: bool = False     # Gemma: x * sqrt(d_model)
    encoder_only: bool = False
    embedding_inputs: bool = False

    # Gemma-style GeGLU uses approximate tanh gelu
    gelu_approx: bool = True

    param_dtype: torch.dtype = torch.bfloat16
    compute_dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        object.__setattr__(self, "param_dtype", as_torch_dtype(self.param_dtype))
        object.__setattr__(self, "compute_dtype",
                           as_torch_dtype(self.compute_dtype))

    @classmethod
    def from_reference(cls, ref) -> "ModelConfig":
        """The port's config for a reference-package ``ModelConfig``: every
        field the two share, by name, with dtypes and block specs converted
        (the reference's kernel knobs have no counterpart here)."""
        kw = {f.name: getattr(ref, f.name) for f in dataclasses.fields(cls)
              if hasattr(ref, f.name)}
        kw["block_pattern"] = tuple(BlockSpec(b.mixer, b.mlp)
                                    for b in ref.block_pattern)
        kw["prefix_blocks"] = tuple(BlockSpec(b.mixer, b.mlp)
                                    for b in ref.prefix_blocks)
        return cls(**kw).validate()

    # ---- derived ----
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.num_heads

    @property
    def rotary_dim(self) -> int:
        rd = int(self.resolved_head_dim * self.partial_rotary_factor)
        return rd - (rd % 2)

    @property
    def expert_d_ff(self) -> int:
        return self.moe_d_ff if self.moe_d_ff else self.d_ff

    @property
    def mamba_d_inner(self) -> int:
        return self.mamba_expand * self.d_model

    @property
    def resolved_dt_rank(self) -> int:
        return self.mamba_dt_rank if self.mamba_dt_rank \
            else -(-self.d_model // 16)

    @property
    def body_layers(self) -> int:
        return self.num_layers - len(self.prefix_blocks)

    @property
    def pattern_period(self) -> int:
        return len(self.block_pattern)

    @property
    def num_periods(self) -> int:
        if self.body_layers % self.pattern_period:
            raise ValueError(
                f"{self.name}: body layers {self.body_layers} not divisible "
                f"by pattern period {self.pattern_period}")
        return self.body_layers // self.pattern_period

    def validate(self) -> "ModelConfig":
        if self.num_heads % self.num_kv_heads:
            raise ValueError(f"{self.name}: heads not a multiple of kv heads")
        _ = self.num_periods
        for b in tuple(self.prefix_blocks) + tuple(self.block_pattern):
            if b.mixer not in (ATTN, MAMBA, MLSTM, SLSTM):
                raise ValueError(f"{self.name}: unknown mixer {b}")
            if b.mlp not in (SWIGLU, GEGLU, RELU2, GELU, MOE, NO_MLP):
                raise ValueError(f"{self.name}: unknown mlp {b}")
            if b.mlp == MOE and self.num_experts <= 0:
                raise ValueError(f"{self.name}: moe block without experts")
        if self.encoder_only and self.causal:
            raise ValueError(f"{self.name}: encoder-only must be bidirectional")
        return self

    def param_count(self) -> int:
        """Parameters (embeddings included, every expert of an MoE FFN),
        counted as the reference counts them."""
        d, hd = self.d_model, self.resolved_head_dim
        total = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        for b in layer_blocks(self):
            if b.mixer == ATTN:
                total += d * (self.num_heads * hd) * 2
                total += d * (self.num_kv_heads * hd) * 2
            elif b.mixer == MAMBA:
                di, dtr = self.mamba_d_inner, self.resolved_dt_rank
                total += d * di * 2                      # in_proj (x, z)
                total += di * self.mamba_d_conv          # conv
                total += di * (dtr + 2 * self.mamba_d_state)   # x_proj
                total += dtr * di + di * self.mamba_d_state    # dt_proj, A
                total += di * d                          # out_proj
            elif b.mixer == MLSTM:
                di = int(d * self.xlstm_mlstm_proj_factor)
                total += d * di * 2 + di * di * 3 + 3 * di + di * d
            elif b.mixer == SLSTM:
                total += 4 * d * d + d * int(
                    d * self.xlstm_slstm_proj_factor) * 2
            if b.mlp in (SWIGLU, GEGLU):
                total += 3 * d * self.d_ff
            elif b.mlp in (RELU2, GELU):
                total += 2 * d * self.d_ff
            elif b.mlp == MOE:
                n_exp = self.num_experts + self.num_shared_experts
                total += n_exp * 3 * d * self.expert_d_ff
                total += d * self.num_experts            # router
        return total


def layer_blocks(cfg: ModelConfig) -> Tuple[BlockSpec, ...]:
    """Full per-layer block list (prefix + periodic body expanded)."""
    return tuple(cfg.prefix_blocks) + tuple(cfg.block_pattern) * cfg.num_periods
