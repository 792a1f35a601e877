"""Representative serving configurations the runtime rules run (port of
``repro/analysis/registry.py``).

The step's contracts (no host read, every state leaf written in place, a
fixed state signature) are claims about the REAL entry points in every
serving mode, so ``runtime_rules`` runs the real ``spec_step``,
``admit_slot`` and ``release_slot`` on concrete states built here:

    linear/paged x greedy/mixed x sampled x tree x adaptive arms

on the reference's tiny 2-layer model (the contracts are structural: they
do not depend on the model's size, and a tiny model keeps the checker a
seconds-scale gate on the CPU), plus one case for each layer family the
port serves and the reference's registry lacks, on that family's smoke
config: the hybrid (Mamba, with Jamba's experts), MoE (DeepSeek), M-RoPE
(Qwen2-VL), xLSTM and the sliding window (Mistral, its buffer longer than
the window, so that the cache is a ring).

``build_case`` takes a model's ``cfg`` and ``params`` too, so that a
caller holding a full-width model on the card checks the same case there.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..configs import get_smoke_config
from ..core.ngram_tables import NGramTables
from ..core.spec_engine import (DecodeState, PagedConfig, SpecConfig,
                                empty_decode_state)
from ..device import resolve_device
from ..models import model as M
from ..models.config import ModelConfig

NUM_SLOTS = 4
PROMPT_LEN = 8
MAX_NEW = 8
TABLE_K, TABLE_W = 8, 8          # the stand-in tables' k_max, w_max


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh for the sharding rules alone: they read only its axis sizes
    (``distributed.sharding.axis_sizes``), so coverage needs no devices."""
    name: str
    shape: Dict[str, int]


# the reference's mesh axis of the registry matrix
MESHES: Tuple[MeshShape, ...] = (
    MeshShape("1dev", {"data": 1, "model": 1}),
    MeshShape("2x2", {"data": 2, "model": 2}),
    MeshShape("pod3d", {"pod": 2, "data": 2, "model": 2}),
)


@dataclasses.dataclass(frozen=True)
class Case:
    name: str
    spec: SpecConfig
    paged: Optional[PagedConfig] = None
    arch: Optional[str] = None    # a registry arch's smoke config; None:
    #                               the tiny model
    ring: bool = False            # a buffer longer than the config's
    #                               window: the KV cache is a ring

    @property
    def needs_tables(self) -> bool:
        return self.spec.strategy != "greedy"


def _spec(**kw) -> SpecConfig:
    base = dict(k=4, w=3, q=1, strategy="mixed", max_new_tokens=MAX_NEW)
    base.update(kw)
    return SpecConfig(**base)


# the reference's six cases
REFERENCE_CASES: Tuple[Case, ...] = (
    Case("linear-greedy", _spec(strategy="greedy")),
    Case("linear-mixed", _spec()),
    Case("linear-sampled", _spec(sampling=True)),
    Case("linear-adaptive", _spec(arms=((1, 0), (2, 2), (4, 3)))),
    Case("tree", _spec(w=2, tree=True, tree_branch=2)),
    Case("paged-mixed", _spec(), paged=PagedConfig(num_pages=0, page_size=8)),
)

# the layer families the reference's registry lacks, each on its smoke
# config (the window case's buffer outgrows Mistral's window, so that its
# cache is a ring)
FAMILY_CASES: Tuple[Case, ...] = (
    Case("hybrid", _spec(), arch="jamba-1.5-large-398b"),
    Case("moe", _spec(), arch="deepseek-moe-16b"),
    Case("mrope", _spec(), arch="qwen2-vl-72b"),
    Case("xlstm", _spec(), arch="xlstm-125m"),
    Case("window", _spec(), arch="mistral-7b", ring=True),
)

CASES: Tuple[Case, ...] = REFERENCE_CASES + FAMILY_CASES


def case(name: str) -> Case:
    return next(c for c in CASES if c.name == name)


@functools.lru_cache(maxsize=None)
def tiny_config() -> ModelConfig:
    """The reference registry's model: 2 layers, d 64, H 4, KV 2, V 61,
    f32."""
    return ModelConfig(name="lint-tiny", num_layers=2, d_model=64,
                       num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=61,
                       param_dtype=torch.float32,
                       compute_dtype=torch.float32).validate()


def case_config(c: Case) -> ModelConfig:
    return get_smoke_config(c.arch) if c.arch else tiny_config()


@functools.lru_cache(maxsize=None)
def _params(cfg: ModelConfig, device: torch.device):
    return M.init_params(cfg, seed=0, device=device)


def stand_in_tables(cfg: ModelConfig, device) -> NGramTables:
    """Value-free stand-in tables: drafting only gathers from them, so
    zeros run the same operations as model-built tables."""
    i32 = dict(dtype=torch.int32, device=device)
    return NGramTables(
        unigram_topk=torch.zeros((TABLE_K,), **i32),
        bigram_topk=torch.zeros((cfg.vocab_size, TABLE_K), **i32),
        bigram_chain=torch.zeros((cfg.vocab_size, TABLE_W), **i32))


def buf_size(c: Case, cfg: ModelConfig) -> int:
    """ServingEngine._init_continuous's sizing arithmetic; a ring case's
    buffer holds its window and a prompt more."""
    if c.ring and cfg.sliding_window is not None:
        return cfg.sliding_window + PROMPT_LEN
    return PROMPT_LEN + MAX_NEW + c.spec.w + 2


def prompts(cfg: ModelConfig, n: int = NUM_SLOTS) -> np.ndarray:
    """(n, PROMPT_LEN) int32 prompts, seeded, inside the vocabulary."""
    rng = np.random.default_rng(0)
    return rng.integers(0, cfg.vocab_size, (n, PROMPT_LEN)).astype(np.int32)


@dataclasses.dataclass
class BuiltCase:
    case: Case
    cfg: ModelConfig
    params: Dict[str, Any]
    tables: Optional[NGramTables]
    state: DecodeState            # empty: every slot free

    @property
    def name(self) -> str:
        return self.case.name

    @property
    def spec(self) -> SpecConfig:
        return self.case.spec


def build_case(c: Case, device="cpu", cfg: Optional[ModelConfig] = None,
               params=None) -> BuiltCase:
    """``c``'s empty state on ``device``, with its model: the case's own
    (seeded) unless ``cfg`` and ``params`` are given."""
    dev = resolve_device(device)
    if cfg is None:
        cfg = case_config(c)
        params = _params(cfg, dev)
    state = empty_decode_state(cfg, c.spec, NUM_SLOTS, buf_size(c, cfg),
                               paged=c.paged, device=dev)
    tables = stand_in_tables(cfg, dev) if c.needs_tables else None
    return BuiltCase(case=c, cfg=cfg, params=params, tables=tables,
                     state=state)
