"""The speculative generation engine: draft -> verify -> accept -> commit
(port of ``repro/core/spec_engine.py``, greedy and sampled, over a linear
or a paged KV cache, with the slot admission and release of continuous
batching).

The unit of work is ONE iteration, ``spec_step``: it drafts, runs the
batched verification call and commits the winning tokens for every active
row of a persistent ``DecodeState``.  The step is fixed-shape, reads
nothing back to the host and writes every leaf of the state in place, so
that a CUDA graph can capture it (``analysis``'s level 1 holds all three);
``generate`` loops over it and reads one boolean per step to stop.

Invariants (as in the reference):
  - output is bit-identical to greedy decoding (temperature-0 rows);
  - per row: model cur_len == #cached positions == buf_len - 1 (the last
    committed token's KV is written by the next call).

The commit writes the winner's verified KV tail into the shared cache in
place for attention-only stacks; a stack with Mamba layers instead replays
the winning row through ``decode(n_commit=)``, which writes only the first
n_commit positions of the KV cache and keeps the recurrent state after
n_commit tokens (the reference's gated replay).  Over a paged cache the
step first grows every running row's pages to cover what it may commit
(``cache.grow_pages``, device-side, no host read).

In-flight adaptive (k, w) (``SpecConfig.arms``, the reference's DESIGN.md
§9): (k, w) become the step's fixed maxima, and every step each slot picks
one arm of the table by its own UCB (``core/controller.py``, on the
device) and is masked down to it: one genuine draft per distinct arm
depth (``drafters.multi_depth_draft``, one K2 launch each on the card),
acceptance cut at the slot's (k_eff, w_eff) (a tree's paths by
``path_max_branch < k_eff``), the same tokens as a dedicated run of that
arm.  (1, 0) is plain greedy.  The bandit's (B, A) stats ride in
``DecodeState.stats`` and are zeroed on admission and release; the arm
table's tensors are built once per (table, device), so the step copies
nothing from the host.

Lossless speculative sampling (``SpecConfig.sampling``, the reference's
DESIGN.md §12): per-slot ``temperature``, ``top_p`` and ``rng_key`` leaves
of the DecodeState steer each row; a sampling step splits every slot's
key once (half drives this step's per-level gumbel noise, half is carried),
verifies with ``verify.sample_predictions`` instead of the argmax, and
keeps temperature-0 rows bit-exact greedy, so one step serves mixed
greedy and sampled batches.  The keys are ``core/prng.py``'s threefry, the
reference's schedule: the same seed gives the reference's tokens.

Tree mode (``SpecConfig.tree``): the k independent rows become ONE token
tree per slot (``core/tree.py``), (k, w) read as (tree width, depth).  The
whole tree is verified in a single (B, 1, N+1) call whose attention sees
each node's ancestors only (K4 on the card); acceptance runs over the
tree's root-to-leaf paths, and the winning path's KV tail is gathered and
committed through the unchanged ``commit_kv_tails``, linear or paged.
Recurrent stacks have no tree layout (their rows are causal sequences):
tree mode raises for them, as in the reference.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..distributed import local as DL
from ..distributed import sharding as shd
from ..kernels import dispatch
from ..models import cache as C
from ..models import model as M
from ..models.config import ModelConfig
from . import tree as T
from .controller import (ARM_STAT_KEYS, arm_slowdowns, choose_arms,
                         init_arm_stats, tree_arm_slowdowns,
                         update_arm_stats)
from .drafters import (bigram_draft, mixed_draft, multi_depth_draft,
                       unigram_draft)
from . import prng
from .ngram_tables import NGramTables
from .verify import accept, per_row_keys, sample_predictions, sample_token

STRATEGIES = ("mixed", "bigram", "unigram", "context", "greedy")


@dataclasses.dataclass(frozen=True)
class PagedConfig:
    """Sizing of a paged DecodeState (``models/cache.py``).

    ``num_pages`` is the page-pool size shared by every slot; 0 sizes it to
    the per-slot worst case (num_slots * pages_per_slot, the linear
    footprint).  ``page_size`` is positions per page; 0 follows
    ``cache.default_page_size`` (64, whole verify-kernel key tiles).
    """
    num_pages: int = 0
    page_size: int = 0

    def resolve_page_size(self, cfg: ModelConfig) -> int:
        return self.page_size or C.default_page_size(cfg)


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    k: int = 10                 # number of batched drafts
    w: int = 10                 # speculation depth
    q: int = 1                  # context-match query length
    strategy: str = "mixed"     # mixed | bigram | unigram | context | greedy
    max_new_tokens: int = 64
    eos_id: int = -1            # -1: never stop on eos
    # Tree mode: verify one draft TREE per slot instead of k independent
    # rows; (k, w) read as (tree width, depth), and ``tree_branch`` is how
    # many of the first depths fan out over the drafter's top-k candidates
    # (deeper levels chain).  Attention-only archs, tables required.
    tree: bool = False
    tree_branch: int = 2
    # In-flight adaptive (k, w): a table of (k_arm, w_arm) arms, each in
    # [1, k] x [0, w] ((width, depth) pairs under ``tree``).  When set,
    # (k, w) are the step's fixed maxima; each step every slot picks one
    # arm by its own UCB and is masked down to it, the same tokens as a
    # dedicated run of that arm.  (1, 0) is plain greedy decoding.
    # The UCB's constants are controller.EXPLORE/EMA/ELL.
    arms: Optional[Tuple[Tuple[int, int], ...]] = None
    # Lossless speculative sampling: verify with the sampled walk
    # (verify.sample_predictions); per-slot temperature/top_p/rng_key
    # leaves steer each row, temperature-0 rows stay bit-exact greedy.  Off
    # by default: the noise and the top-p sort are per-step work that
    # greedy-only serving should not pay.
    sampling: bool = False

    def validate_tree(self) -> "SpecConfig":
        """Raise unless the tree knobs are a buildable topology."""
        if not self.tree:
            return self
        if self.strategy == "greedy":
            raise ValueError("tree mode needs a drafting strategy "
                             "(strategy='greedy' verifies nothing)")
        if self.w < 1:
            raise ValueError(f"tree mode needs w >= 1, got w={self.w}")
        if self.tree_branch < 1:
            raise ValueError(
                f"tree_branch must be >= 1, got {self.tree_branch}")
        return self

    def validate_arms(self) -> "SpecConfig":
        """Raise unless the arm table fits the step's (k, w) box."""
        if self.arms is None:
            return self
        if self.strategy == "greedy":
            raise ValueError(
                "arms require a drafting strategy (the greedy arm (1, 0) "
                "is expressed inside the masked step, not via "
                "strategy='greedy')")
        if not self.arms:
            raise ValueError("arms must be a non-empty tuple")
        for a in self.arms:
            ka, wa = a
            if not (1 <= ka <= self.k and 0 <= wa <= self.w):
                raise ValueError(
                    f"arm {a} outside the compile-time box "
                    f"[1, {self.k}] x [0, {self.w}]")
        return self

    def validate(self) -> "SpecConfig":
        self.validate_tree()
        self.validate_arms()
        if self.strategy not in STRATEGIES:
            raise ValueError(f"strategy must be one of {STRATEGIES}, got "
                             f"{self.strategy!r}")
        if self.k < 1 or self.w < 1 or self.q < 1:
            raise ValueError(f"need k, w, q >= 1, got {self}")
        return self


@dataclasses.dataclass
class DecodeState:
    """Persistent decoding state: one row ("slot") per in-flight sequence.
    ``done`` marks rows that must not commit further tokens; ``eos_id == -1``
    means the row never stops on eos.  Every leaf is fixed-shape.

    Sampling leaves: ``rng_key`` is the slot's CARRY key (``core/prng.py``
    int64 words); a sampling step splits it once, uses one half for its
    noise and stores the other, so the same admitted key replays the same
    output.  ``temperature``/``top_p`` are per-slot data: temperature-0
    rows take the argmax inside the same step.  Admission and release
    reset all three."""
    buf: torch.Tensor         # (B, L) int32 token buffer (prompt + output)
    buf_len: torch.Tensor     # (B,) int32 committed length per row
    prompt_len: torch.Tensor  # (B,) int32
    budget: torch.Tensor      # (B,) int32 per-row max_new_tokens
    eos_id: torch.Tensor      # (B,) int32 per-row eos (-1: never)
    done: torch.Tensor        # (B,) bool
    active: torch.Tensor      # (B,) bool — slot currently occupied
    model: Dict               # models/cache.py state (linear or paged)
    stats: Dict[str, torch.Tensor]
    rng_key: torch.Tensor     # (B, 2) int64 per-slot carry key (uint32 words)
    temperature: torch.Tensor  # (B,) f32, <= 0 -> greedy row
    top_p: torch.Tensor       # (B,) f32 nucleus mass, 1 -> off

    @property
    def buf_size(self) -> int:
        return self.buf.shape[1]


def _draft(spec: SpecConfig, tables: NGramTables, buf, buf_len, last):
    """(drafts (B,k,w), valid (B,k), n_ctx (B,) int32) of the strategy;
    mixed and context are one K2 launch on the card."""
    if spec.strategy == "mixed":
        return mixed_draft(tables, buf, buf_len, last, spec.q, spec.k, spec.w)
    if spec.strategy == "context":
        return dispatch.ngram_draft(buf, buf_len, q=spec.q, k=spec.k,
                                    w=spec.w)
    if spec.strategy == "bigram":
        d, v = bigram_draft(tables, last, spec.k, spec.w)
    elif spec.strategy == "unigram":
        d, v = unigram_draft(tables, buf.shape[0], spec.k, spec.w)
    else:
        raise ValueError(spec.strategy)
    return d, v, torch.zeros((buf.shape[0],), dtype=torch.int32,
                             device=buf.device)


def _init_stats(spec: SpecConfig, B: int, device) -> Dict[str, torch.Tensor]:
    z = lambda *shape: torch.zeros(shape, dtype=torch.int32, device=device)
    # tree mode ranks over root-to-leaf PATHS, not drafter rows
    ranks = (T.num_paths(spec.k, spec.w, spec.tree_branch) if spec.tree
             else spec.k)
    st = {
        "calls": z(B),
        "tokens": z(B),
        # n_commit per verify call in bins 0..w+1; bin 0 stays zero (every
        # call commits >= 1 token) and hist.sum() == calls
        "accept_hist": z(B, spec.w + 2),
        "rank_hist": z(B, max(ranks, 1)),
        "alloc_ctx": z(B, spec.k + 1),          # n_ctx per call
        "accepted_ctx": z(B),                   # drafted tokens accepted
        "accepted_bigram": z(B),                # per source
    }
    if spec.arms is not None:
        # the per-slot bandit rides in the stats: zeroed by the same slot
        # reset as the call and token counters (admission and release)
        st.update(init_arm_stats(B, len(spec.arms), device))
    return st


class ArmConstants(NamedTuple):
    """An arm table's tensors on one device (index = arm)."""
    k: torch.Tensor          # (A,) int32 rows (tree: width) of each arm
    w: torch.Tensor          # (A,) int32 depth of each arm
    widx: torch.Tensor       # (A,) int64 index into unique_sweep_widths
    slow: torch.Tensor       # (A,) f32 roofline slowdown prior
    path_max_branch: Optional[torch.Tensor]  # (P,) int32, tree tables only


def arm_constants(cfg: ModelConfig, spec: SpecConfig,
                  device: torch.device) -> ArmConstants:
    """Every per-arm tensor of ``spec``'s adaptive step on ``device``."""
    tree = (spec.k, spec.w, spec.tree_branch) if spec.tree else None
    return _arm_constants(cfg, spec.arms, tree, device)


@functools.lru_cache(maxsize=None)
def _arm_constants(cfg: ModelConfig, arms: Tuple[Tuple[int, int], ...],
                   tree: Optional[Tuple[int, int, int]],
                   device: torch.device) -> ArmConstants:
    """Built once per (config, arm table, tree shape, device) and
    cached: a step then makes no host-to-device copy."""
    sw = dispatch.unique_sweep_widths(arms)
    slow = (tree_arm_slowdowns(cfg, arms, tree[2]) if tree
            else arm_slowdowns(cfg, arms))
    on = lambda v, dt: torch.tensor(v, dtype=dt, device=device)
    pmb = (on(T.topology(*tree).path_max_branch, torch.int32) if tree
           else None)
    return ArmConstants(
        k=on([a[0] for a in arms], torch.int32),
        w=on([a[1] for a in arms], torch.int32),
        widx=on([sw.index(w) if w > 0 else 0 for _, w in arms],
                torch.int64),
        slow=on(slow, torch.float32), path_max_branch=pmb)


def _draft_adaptive(spec: SpecConfig, tables: Optional[NGramTables],
                    buf, buf_len, last, widx):
    """Arm-masked drafting: (k_max, w_max) candidates for every slot.

    One genuine draft per distinct positive arm depth (the context sweep's
    hash is a function of w, see ``drafters.multi_depth_draft``), selected
    per slot by ``widx`` (B,), its arm's depth index.  A table whose arms
    are all greedy drafts nothing."""
    B, dev = buf.shape[0], buf.device
    sw = dispatch.unique_sweep_widths(spec.arms)
    if not sw:                              # every arm is (k, 0): greedy
        return (torch.zeros((B, spec.k, spec.w), dtype=torch.int32,
                            device=dev),
                torch.zeros((B, spec.k), dtype=torch.bool, device=dev),
                torch.zeros((B,), dtype=torch.int32, device=dev))
    draft_fn = lambda w: _draft(dataclasses.replace(spec, w=w, arms=None),
                                tables, buf, buf_len, last)
    return multi_depth_draft(draft_fn, sw, spec.w, widx)


# ---------------------------------------------------------------------------
# state construction
# ---------------------------------------------------------------------------
def _sampling_leaves(B: int, device) -> Dict[str, torch.Tensor]:
    """Greedy-default per-slot sampling leaves (the admit/release reset)."""
    return dict(rng_key=torch.zeros((B, 2), dtype=torch.int64, device=device),
                temperature=torch.zeros((B,), dtype=torch.float32,
                                        device=device),
                top_p=torch.ones((B,), dtype=torch.float32, device=device))


def _local_kv_cfg(cfg: ModelConfig) -> ModelConfig:
    """``cfg`` as this rank's cache shapes read it: under a mesh whose
    cache splits the kv heads, this rank's share of them (allocation
    only; the model math reads ``cfg``)."""
    rows = DL.current()
    if rows is None:
        return cfg
    n = 1
    for a in DL.live(rows.mesh, rows.cache.kv):
        n *= shd.axis_sizes(rows.mesh)[a]
    if n == 1:
        return cfg
    return dataclasses.replace(cfg, num_kv_heads=cfg.num_kv_heads // n)


def _paged_model(cfg: ModelConfig, paged: PagedConfig, B: int,
                 buf_size: int, device) -> Tuple[Dict, int]:
    """An empty paged model state whose slots hold ``buf_size`` positions
    rounded up to whole pages; returns it with the rounded buffer size."""
    ps = paged.resolve_page_size(cfg)
    pps = -(-buf_size // ps)
    model = C.init_paged_state(cfg, B, paged.num_pages or B * pps, ps, pps,
                               device=device)
    return model, pps * ps


def empty_decode_state(cfg: ModelConfig, spec: SpecConfig, num_slots: int,
                       buf_size: int, paged: Optional[PagedConfig] = None,
                       device="cuda") -> DecodeState:
    """All-slots-free state for a continuous-batching engine.

    With ``paged``, the model cache is a shared page pool plus per-slot page
    tables instead of per-slot linear buffers; ``buf_size`` (the token
    buffer and logical KV capacity per slot) is rounded up to whole pages.
    """
    spec.validate()
    dev = resolve_device(device)
    B = num_slots
    if paged is not None:
        model, buf_size = _paged_model(cfg, paged, B, buf_size, dev)
    else:
        model = M.init_state(cfg, B, buf_size, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    return DecodeState(
        buf=torch.zeros((B, buf_size), **i32),
        buf_len=torch.zeros((B,), **i32),
        prompt_len=torch.zeros((B,), **i32),
        budget=torch.zeros((B,), **i32),
        eos_id=torch.full((B,), -1, **i32),
        done=torch.ones((B,), dtype=torch.bool, device=dev),
        active=torch.zeros((B,), dtype=torch.bool, device=dev),
        model=model,
        stats=_init_stats(spec, B, dev),
        **_sampling_leaves(B, dev))


def init_decode_state(params, cfg: ModelConfig, spec: SpecConfig,
                      prompt: torch.Tensor,
                      eos_id: Optional[torch.Tensor] = None,
                      paged: Optional[PagedConfig] = None,
                      temperature=None, top_p=None, rng=None
                      ) -> DecodeState:
    """Prefill every row of ``prompt`` (B, P) into a fresh DecodeState on
    the prompt's device.  The buffer holds P + max_new_tokens + w + 2
    tokens; K1 masks the cache's ragged edge itself, so no kernel alignment
    is applied.  ``eos_id``: optional per-row override of spec.eos_id.

    ``paged`` switches the KV layout to the shared page pool: the buffer is
    rounded up to whole pages, each row gets ceil(P / page_size) pages up
    front and grows inside spec_step.  The default pool covers the worst
    case, so one-shot ``generate`` can never exhaust it.

    Sampling (needs ``spec.sampling``: a silent greedy fallback would be a
    correctness trap): ``temperature``/``top_p`` are scalars or per-row;
    ``rng`` is one key (2,), expanded per row by ``fold_in(row)``, or
    per-row keys (B, 2) (``prng.as_key`` reads either).  The first token is
    already a sampling event: it draws from the row key's first split, and
    the other half is carried into the step loop."""
    spec.validate()
    if not spec.sampling and (temperature is not None or top_p is not None
                              or rng is not None):
        raise ValueError(
            "temperature/top_p/rng need SpecConfig(sampling=True): without "
            "the sampled verification walk these knobs would silently "
            "degrade to greedy")
    dev = prompt.device
    B, P = prompt.shape
    L = P + spec.max_new_tokens + spec.w + 2
    eos = (torch.full((B,), spec.eos_id, dtype=torch.int32, device=dev)
           if eos_id is None
           else torch.as_tensor(eos_id, dtype=torch.int32,
                                device=dev).expand(B).clone())
    if paged is not None:
        model, L = _paged_model(_local_kv_cfg(cfg), paged, B, L, dev)
        C.grow_pages(model, torch.full((B,), P, dtype=torch.int32,
                                       device=dev),
                     torch.ones((B,), dtype=torch.bool, device=dev))
    else:
        model = M.init_state(_local_kv_cfg(cfg), B, L, device=dev)
    buf = torch.zeros((B, L), dtype=torch.int32, device=dev)
    buf[:, :P] = prompt.to(torch.int32)
    logits_p, model = M.prefill(params, cfg, model, tokens=prompt,
                                last_only=True)
    leaves = _sampling_leaves(B, dev)
    if spec.sampling:
        for name, v in (("temperature", temperature), ("top_p", top_p)):
            if v is not None:
                leaves[name] = torch.as_tensor(
                    v, dtype=torch.float32, device=dev).expand(B).clone()
        keys = (leaves["rng_key"] if rng is None
                else per_row_keys(rng, B).to(dev))
        nk = prng.split(keys)                                  # (B, 2, 2)
        first = sample_token(logits_p[:, -1], nk[:, 0],
                             leaves["temperature"], leaves["top_p"])
        leaves["rng_key"] = nk[:, 1]
    else:
        first = torch.argmax(logits_p[:, -1], dim=-1).to(torch.int32)
    buf[:, P] = first
    stats = _init_stats(spec, B, dev)
    stats["tokens"] += 1
    return DecodeState(
        buf=buf,
        buf_len=torch.full((B,), P + 1, dtype=torch.int32, device=dev),
        prompt_len=torch.full((B,), P, dtype=torch.int32, device=dev),
        budget=torch.full((B,), spec.max_new_tokens, dtype=torch.int32,
                          device=dev),
        eos_id=eos,
        done=(first == eos) & (eos >= 0),
        active=torch.ones((B,), dtype=torch.bool, device=dev),
        model=model,
        stats=stats,
        **leaves)


# ---------------------------------------------------------------------------
# slot admission and release (continuous batching)
# ---------------------------------------------------------------------------
def admit_slot(params, cfg: ModelConfig, state: DecodeState, slot: int,
               prompt: torch.Tensor, max_new_tokens: int, eos_id: int,
               temperature: float = 0.0, top_p: float = 1.0,
               rng_key=None) -> DecodeState:
    """Prefill ``prompt`` (P,) into slot ``slot`` of a shared DecodeState,
    IN PLACE (the reference donates the state), on the state's device.

    A linear state prefills a batch-1 scratch row of the full buffer
    length and overwrites every leaf of the slot with it
    (``cache.insert_slot``), so nothing leaks from the slot's previous
    occupant.  A paged state prefills a P-long scratch linear row, frees the
    slot's pages (idempotent: safe if release was skipped), allocates
    ceil(P / page_size) fresh ones and scatters the prefix KV through them;
    spec_step grows further pages as the row commits.

    ``temperature``/``top_p``/``rng_key`` are the request's sampling
    controls (the defaults admit a greedy request).  The first token is
    the request's first sampling event: it draws from the key's first
    split, and the second half is carried into the slot; a temperature-0
    request takes the prompt's argmax, which is what the draw gives it bit
    for bit, without drawing noise.  Reads nothing back to the host.
    """
    dev = state.buf.device
    prompt = torch.as_tensor(prompt).to(device=dev, dtype=torch.int32)
    P, L = prompt.shape[0], state.buf_size
    paged = C.is_paged(state.model)
    row_model = M.init_state(cfg, 1, P if paged else L, device=dev)
    logits, row_model = M.prefill(params, cfg, row_model, tokens=prompt[None],
                                  last_only=True)
    first, k_carry = _first_token(logits, temperature, top_p, rng_key)
    if paged:
        ps = C.paged_dims(state.model)[1]
        C.free_slot_pages(state.model, slot)
        C.alloc_slot_pages(state.model, slot, C.pages_for_len(P, ps))
        C.insert_slot_paged(state.model, row_model, slot, P)
    else:
        C.insert_slot(state.model, row_model, slot)
    _write_slot(state, slot, prompt, first, max_new_tokens, eos_id,
                temperature, top_p, k_carry)
    return state


def _first_token(logits: torch.Tensor, temperature: float, top_p: float,
                 rng_key) -> Tuple[torch.Tensor, torch.Tensor]:
    """(first token, carried key) of an admission from its prompt's last
    logits (1, 1, V)."""
    key = (torch.zeros((2,), dtype=torch.int64) if rng_key is None
           else prng.as_key(rng_key))
    k_use, k_carry = prng.split(key)
    if temperature > 0:
        first = sample_token(logits[:, -1], k_use[None], [temperature],
                             [top_p])[0]
    else:
        first = torch.argmax(logits[0, -1], dim=-1).to(torch.int32)
    return first, k_carry


def _write_slot(state: DecodeState, slot: int, prompt: torch.Tensor,
                first: torch.Tensor, max_new_tokens: int, eos_id: int,
                temperature: float, top_p: float, k_carry) -> None:
    """An admission's per-slot rows, IN PLACE (slot: a row of ``state``)."""
    P = prompt.shape[0]
    C.zero_slot_stats(state.stats, slot)
    state.stats["tokens"][slot] = 1
    state.buf[slot] = 0
    state.buf[slot, :P] = prompt
    state.buf[slot, P] = first
    state.buf_len[slot] = P + 1
    state.prompt_len[slot] = P
    state.budget[slot] = max_new_tokens
    state.eos_id[slot] = eos_id
    state.done[slot] = (first == eos_id) & (eos_id >= 0)
    state.active[slot] = True
    state.rng_key[slot] = k_carry
    state.temperature[slot] = temperature
    state.top_p[slot] = top_p


def release_slot(state: DecodeState, slot: int) -> DecodeState:
    """Mark a retired row's slot free, IN PLACE.  A linear cache is
    overwritten at the next admission; a paged one returns the slot's pages
    to the free stack now.  The slot's stats rows are zeroed: read a
    retiring slot's stats before releasing it."""
    if C.is_paged(state.model):
        C.free_slot_pages(state.model, slot)
    _clear_slot(state, slot)
    return state


def _clear_slot(state: DecodeState, slot: int) -> None:
    C.zero_slot_stats(state.stats, slot)
    state.active[slot] = False
    state.done[slot] = True
    state.rng_key[slot] = 0
    state.temperature[slot] = 0.0
    state.top_p[slot] = 1.0


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------
def _running(s: DecodeState) -> torch.Tensor:
    """(B,) bool: rows that may still commit tokens this step."""
    return s.active & (~s.done) & (s.buf_len - s.prompt_len < s.budget)


def _spec_body(params, cfg: ModelConfig, spec: SpecConfig,
               tables: Optional[NGramTables], s: DecodeState) -> DecodeState:
    B, L = s.buf.shape
    dev = s.buf.device
    if C.is_paged(s.model):
        # this step commits at most w+1 tokens per row (positions
        # cur_len .. cur_len+w): cover cur_len + w + 1 before the verify
        # and commit touch the pool
        C.grow_pages(s.model, s.model["cur_len"] + spec.w + 1, _running(s))
    buf_c, len_c, done_c, state_c = s.buf, s.buf_len, s.done, s.model
    if spec.sampling:
        # one split per slot per step: half drives this step's per-level
        # noise, half is carried
        nk = prng.split(s.rng_key)                             # (B, 2, 2)
        use_keys, carry_keys = nk[:, 0], nk[:, 1]
    else:
        carry_keys = s.rng_key
    # a free slot (buf_len 0) reads its last buffer entry, as the
    # reference's wrapping index does; it commits nothing
    last_i = torch.remainder(len_c - 1, L)[:, None].long()
    last = buf_c.gather(1, last_i)[:, 0]
    if spec.arms is not None:
        # per-slot, per-step arm choice on the device: UCB over the slot's
        # own (B, A) stats, then the fixed (k_max, w_max) shapes are masked
        # down to the chosen arm
        ac = arm_constants(cfg, spec, dev)
        arm = choose_arms(s.stats, ac.slow)                # (B,)
        k_eff, w_eff = ac.k[arm.long()], ac.w[arm.long()]
        drafts, valid, n_ctx = _draft_adaptive(spec, tables, buf_c, len_c,
                                               last, ac.widx[arm.long()])
    else:
        k_eff = w_eff = None
        drafts, valid, n_ctx = _draft(spec, tables, buf_c, len_c, last)
    if spec.tree:
        if M.has_recurrent(cfg):
            raise ValueError(
                "tree speculation needs an attention-only arch: recurrent "
                "mixers verify rows as causal sequences, which has no "
                "valid tree layout")
        # ONE (B, 1, N+1) verify call scores the whole token tree; the
        # ancestor mask and per-level positions make every root-to-leaf
        # path score exactly as a linear row of its tokens would
        topo = T.topology(spec.k, spec.w, spec.tree_branch)
        tc = T.device_constants(spec.k, spec.w, spec.tree_branch, dev)
        nodes = T.fill_tree(topo, drafts, tables, buf=buf_c,
                            buf_len=len_c)                       # (B, N)
        rows = torch.cat([last[:, None], nodes], dim=1)[:, None]  # (B,1,N+1)
        logits, tails = M.verify(params, cfg, state_c, rows,
                                 pos_off=tc.pos_off,
                                 tail_mask=tc.tail_mask)
        if spec.sampling:
            # noise keyed per tree LEVEL (pos_off): same-level nodes share
            # it, duplicate-token siblings included, so the slot has one
            # sampled trajectory across the whole tree
            preds = sample_predictions(logits, use_keys, s.temperature,
                                       s.top_p, levels=tc.pos_off,
                                       n_levels=spec.w + 1)[:, 0]
        else:
            preds = torch.argmax(logits[:, 0], dim=-1).to(torch.int32)
        # a (width_b, depth_b) arm keeps exactly the paths whose branch
        # indices all fall below width_b (scattered through the lex order,
        # not a prefix of the path list)
        row_mask = (None if k_eff is None
                    else ac.path_max_branch[None] < k_eff[:, None])
        # path views: (B, P, w) draft tokens, (B, P, w+1) predictions
        acc = accept(nodes[:, tc.path_nodes], preds[:, tc.path_inputs],
                     w_eff=w_eff, row_mask=row_mask)
    else:
        rows = torch.cat([last[:, None, None].expand(B, spec.k, 1), drafts],
                         dim=-1)                                 # (B,k,w+1)
        logits, tails = M.verify(params, cfg, state_c, rows)
        if spec.sampling:
            # noise keyed per position level and SHARED across the k rows:
            # rows alive at level j share their prefix, logits and sample,
            # so acceptance walks one sampled trajectory and the bonus is
            # its first divergent (residual) token
            greedy = sample_predictions(logits, use_keys, s.temperature,
                                        s.top_p)
        else:
            greedy = torch.argmax(logits, dim=-1).to(torch.int32)
        acc = accept(drafts, greedy, k_eff=k_eff, w_eff=w_eff)
    active = _running(s)
    budget = (s.prompt_len + s.budget - len_c).clamp(min=0)
    n_commit = torch.where(active, torch.minimum(acc.n_commit, budget), 0)
    # eos truncation: commit only up to (and including) the first eos
    iseos = (acc.tokens == s.eos_id[:, None]) & (s.eos_id >= 0)[:, None]
    first_eos = torch.argmax(iseos.to(torch.int32), dim=1)
    has_eos = iseos.any(dim=1) & (first_eos < n_commit)
    n_commit = torch.where(has_eos, first_eos + 1, n_commit).to(torch.int32)
    done_c = done_c | (has_eos & active)
    # commit the model state (in place)
    b_idx = torch.arange(B, device=dev)
    if spec.tree:
        # gather the winning PATH's inputs out of the (N+1)-wide tree tails
        # into a (w+1)-wide linear tail; the stock commit (winner row 0 of
        # 1) writes it, linear or paged
        sel = tc.path_inputs[acc.winner.long()]                 # (B, w+1)
        tails = {g: {kk: tt[:, :, 0][:, b_idx[:, None], sel][:, :, None]
                     for kk, tt in d.items()} for g, d in tails.items()}
        M.commit_kv_tails(cfg, state_c, tails, torch.zeros_like(acc.winner),
                          n_commit)
    elif not M.has_recurrent(cfg):
        M.commit_kv_tails(cfg, state_c, tails, acc.winner, n_commit)
    else:
        # gated replay: the winning row's tokens through decode, which keeps
        # the first n_commit positions' KV and recurrent state
        row_tok = rows[b_idx, acc.winner.long()]                # (B, w+1)
        M.decode(params, cfg, state_c, row_tok, n_commit=n_commit)
    # write accepted tokens into the buffer (in place)
    pos = torch.arange(spec.w + 1, device=dev)[None, :]
    slots = (len_c[:, None].long() + pos).clamp(0, L - 1)
    gate = pos < n_commit[:, None]
    old = buf_c.gather(1, slots)
    buf_c.scatter_(1, slots, torch.where(gate, acc.tokens, old))
    # ---- stats (in place) ----
    st = s.stats
    act = active.to(torch.int32)
    st["calls"].add_(act)
    st["tokens"].add_(n_commit)
    st["accept_hist"].index_put_(
        (b_idx, n_commit.long().clamp(0, spec.w + 1)), act, accumulate=True)
    n_win = acc.n_acc.gather(1, acc.winner[:, None].long())[:, 0]
    st["rank_hist"].index_put_(
        (b_idx, acc.winner.long()), (active & (n_win > 0)).to(torch.int32),
        accumulate=True)
    st["alloc_ctx"].index_put_(
        (b_idx, n_ctx.long().clamp(0, spec.k)), act, accumulate=True)
    # the winning path's origin: the drafter row its first branch tracks
    # (tree) or the winning row itself (linear)
    from_ctx = ((tc.path_first[acc.winner.long()] if spec.tree
                 else acc.winner) < n_ctx)
    acc_drafted = (n_commit - 1).clamp(min=0)
    st["accepted_ctx"].add_(torch.where(active & from_ctx, acc_drafted, 0))
    st["accepted_bigram"].add_(torch.where(active & ~from_ctx, acc_drafted,
                                           0))
    if spec.arms is not None:
        # reward the pulled arm with the tokens its call committed (bonus
        # included: the tokens-per-call quantity AdaptiveKW tracks)
        for key, v in update_arm_stats(
                {k: st[k] for k in ARM_STAT_KEYS}, arm, n_commit,
                active).items():
            st[key].copy_(v)
    _advance(s, n_commit, done_c, carry_keys)
    return s


def _advance(s: DecodeState, n_commit: torch.Tensor, done: torch.Tensor,
             carry_keys: torch.Tensor) -> None:
    """The step's last writes, IN PLACE: ``n_commit`` more committed
    tokens a row, the rows that finished (``done``, or out of budget) and
    the carried keys.  Every leaf keeps its storage, as a CUDA graph of
    the step needs."""
    s.buf_len.add_(n_commit)
    s.done.copy_(done | (s.buf_len - s.prompt_len >= s.budget))
    if carry_keys is not s.rng_key:
        s.rng_key.copy_(carry_keys)


def _greedy_body(params, cfg: ModelConfig, spec: SpecConfig,
                 tables: Optional[NGramTables], s: DecodeState) -> DecodeState:
    B, L = s.buf.shape
    dev = s.buf.device
    active = _running(s)
    if C.is_paged(s.model):
        C.grow_pages(s.model, s.model["cur_len"] + 1, active)
    buf_c, len_c, done_c, state_c = s.buf, s.buf_len, s.done, s.model
    last = buf_c.gather(1, torch.remainder(len_c - 1, L)[:, None].long())
    logits, _ = M.decode(params, cfg, state_c, last)
    # decode advances cur_len by 1 for every row; freeze inactive rows so
    # the cur_len == buf_len - 1 invariant holds for done rows too (their
    # cache writes are row-local and never read: only p < cur_len is)
    state_c["cur_len"].sub_((~active).to(torch.int32))
    if spec.sampling:
        nk = prng.split(s.rng_key)                             # (B, 2, 2)
        nxt = sample_token(logits[:, -1], nk[:, 0], s.temperature, s.top_p)
        carry_keys = nk[:, 1]
    else:
        nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        carry_keys = s.rng_key
    slots = len_c.long().clamp(0, L - 1)[:, None]
    b_idx = torch.arange(B, device=dev)
    buf_c.scatter_(1, slots, torch.where(active, nxt,
                                         buf_c.gather(1, slots)[:, 0])[:, None])
    st = s.stats
    act = active.to(torch.int32)
    st["calls"].add_(act)
    st["tokens"].add_(act)
    # a greedy call commits exactly one token: bin 1 of the histogram
    st["accept_hist"].index_put_(
        (b_idx, torch.ones_like(b_idx)), act, accumulate=True)
    _advance(s, act, done_c | ((nxt == s.eos_id) & (s.eos_id >= 0)),
             carry_keys)
    return s


def spec_step(params, cfg: ModelConfig, spec: SpecConfig, state: DecodeState,
              tables: Optional[NGramTables] = None) -> DecodeState:
    """One draft -> verify -> commit iteration over every active row.  Rows
    that are inactive or done commit nothing and their stats are untouched.
    Every leaf of the state is updated in place (the reference donates
    them) and the same state is returned; ``analysis``'s ``in-place`` rule
    holds this."""
    body = _greedy_body if spec.strategy == "greedy" else _spec_body
    if body is _spec_body and tables is None:
        raise ValueError(f"strategy {spec.strategy!r} needs NGramTables")
    return body(params, cfg, spec, tables, state)


# ---------------------------------------------------------------------------
# one-shot generation
# ---------------------------------------------------------------------------
def generate(params, cfg: ModelConfig, spec: SpecConfig, prompt,
             tables: Optional[NGramTables] = None,
             eos_id: Optional[torch.Tensor] = None,
             paged: Optional[PagedConfig] = None, device="cuda",
             temperature=None, top_p=None, rng=None, mesh=None
             ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """Generate up to max_new_tokens for every row of ``prompt`` (B, P) on
    ``device`` (where ``params`` and ``tables`` live).  ``eos_id``: optional
    per-row override of spec.eos_id.  ``paged`` runs the same loop over the
    paged KV layout (the same outputs).  ``temperature``/``top_p``/``rng``
    (scalar or per-row; need ``spec.sampling``) run the lossless sampled
    walk, see ``init_decode_state``.  Returns (buf (B, L), buf_len (B,),
    stats).

    ``mesh`` (params DTensors placed by ``distributed.sharding``, inside the
    caller's ``act_sharding.activated(mesh)``): the rows are split over the
    mesh's batch axes when they divide them, each rank runs the loop on
    its own rows (``distributed/local.py``) and the outputs are gathered."""
    dev = resolve_device(device)
    prompt = torch.as_tensor(np.asarray(prompt) if not torch.is_tensor(prompt)
                             else prompt).to(device=dev, dtype=torch.int32)
    if mesh is not None:
        return _generate_mesh(params, cfg, spec, prompt, tables, eos_id,
                              paged, temperature, top_p, rng, mesh)
    state = init_decode_state(params, cfg, spec, prompt, eos_id=eos_id,
                              paged=paged, temperature=temperature,
                              top_p=top_p, rng=rng)
    while _any_running(state):
        state = spec_step(params, cfg, spec, state, tables)
    return state.buf, state.buf_len, state.stats


def _any_running(state: DecodeState) -> bool:
    """The loop's one host read per step: is any row still running (on
    any rank, under a mesh)?"""
    run = (~state.done) & (state.buf_len - state.prompt_len < state.budget)
    if DL.current() is not None:
        run = DL.gather_rows(run)
    # repro-lint: allow(tensor-branch): generate's stop test, outside the step
    return bool(run.any())


def _generate_mesh(params, cfg: ModelConfig, spec: SpecConfig,
                   prompt: torch.Tensor, tables, eos_id, paged, temperature,
                   top_p, rng, mesh):
    """``generate`` over a mesh: this rank's rows of every per-row input,
    a rank-private state (its caches' kv heads by the rule), the global
    stop test, then every rank's rows gathered."""
    B = prompt.shape[0]
    # rows padded to a whole number a rank with copies of row 0 (rows are
    # independent: a copy changes no other row), dropped at the end
    Bp = DL.padded(mesh, B)
    rows = DL.rows_for(mesh, Bp, DL.cache_layout(mesh, cfg))
    pick = torch.arange(rows.lo, rows.hi, device=prompt.device)
    pick = torch.where(pick < B, pick, 0)

    def local(v):
        if v is None:
            return None
        t = torch.as_tensor(v, device=prompt.device)
        return t.expand(B)[pick] if t.dim() == 0 else t[pick]
    keys = None
    if rng is not None:
        keys = per_row_keys(rng, B).to(prompt.device)[pick]
    with DL.active(rows):
        state = init_decode_state(params, cfg, spec, prompt[pick],
                                  eos_id=local(eos_id), paged=paged,
                                  temperature=local(temperature),
                                  top_p=local(top_p), rng=keys)
        while _any_running(state):
            state = spec_step(params, cfg, spec, state, tables)
        return (DL.gather_rows(state.buf)[:B],
                DL.gather_rows(state.buf_len)[:B],
                {k: DL.gather_rows(v)[:B] for k, v in state.stats.items()})


# ---------------------------------------------------------------------------
# the mesh: step, admit and release over a sharded DecodeState
# ---------------------------------------------------------------------------
def map_state(state: DecodeState, fn) -> DecodeState:
    """A DecodeState with ``fn(path, leaf)`` in every leaf's place (path
    '/'-joined, as ``sharding.decode_state_pspecs`` names it)."""
    def walk(prefix, v):
        if isinstance(v, dict):
            return {k: walk(f"{prefix}/{k}", x) for k, x in v.items()}
        return fn(prefix, v)
    return DecodeState(**{f.name: walk(f.name, getattr(state, f.name))
                          for f in dataclasses.fields(state)})


def shard_state(state: DecodeState, mesh, device=None) -> DecodeState:
    """A DecodeState that every rank holds whole (on the host, say) as
    DTensors placed by ``sharding.decode_state_pspecs``: each rank copies
    its own shards to ``device`` (default: where the state lies)."""
    specs = shd.decode_state_pspecs(mesh, state)
    return map_state(state, lambda p, t: DL.distribute(t, mesh, specs[p],
                                                       device))


class ShardedSlotFns(NamedTuple):
    step: object
    admit: object
    release: object
    placements: Dict[str, tuple]    # every leaf's, by path


def make_sharded_slot_fns(cfg: ModelConfig, spec: SpecConfig,
                          state: DecodeState, mesh) -> ShardedSlotFns:
    """The counterpart of the reference's ``make_sharded_slot_fns``: the
    step, admit and release of a DecodeState of DTensors (``shard_state``)
    with every leaf's placements pinned.

    Each runs its row work on this rank's local rows (views of the
    DTensors' storage, so every leaf keeps its storage) and its model math
    on DTensors (``distributed/local.py``); admission prefills the prompt
    on every rank and only the slot's owner writes the slot's rows, the
    paged pool's writes landing on the shards that hold their pages.
    After every call the leaves hold the placements that
    ``decode_state_pspec`` gives them: the same DTensors, written in
    place."""
    specs = shd.decode_state_pspecs(mesh, state)
    placements = {p: shd.to_placements(mesh, sp) for p, sp in specs.items()}
    paged = C.is_paged(state.model)
    kpath = next((p for p in specs
                  if p.startswith("model/groups/") and p.endswith("/k")),
                 None)
    if kpath is None:           # a recurrent stack (xLSTM): no cache
        layout = DL.CacheLayout()
    else:
        gid = kpath.split("/")[2]
        layout = DL.cache_layout(
            mesh, cfg, specs[kpath],
            tuple(state.model["groups"][gid]["k"].shape), paged=paged)
    rows = DL.rows_for(mesh, state.buf.shape[0], layout)
    # an admission prefills its prompt as one local row on every rank
    scratch = DL.rows_for(mesh, DL.padded(mesh, 1),
                          DL.CacheLayout(kv=layout.kv))

    def local_view(st: DecodeState) -> DecodeState:
        return dataclasses.replace(
            map_state(dataclasses.replace(st, model={}),
                      lambda p, t: t.to_local()),
            model=DL.local_model(st.model, rows))

    def step(params, st: DecodeState, tables=None) -> DecodeState:
        with DL.active(rows):
            spec_step(params, cfg, spec, local_view(st), tables)
        DL.sync_cur_len(st.model, rows)
        return st

    def slot_pages(model: Dict, slot: int):
        """(page-table row, page count) of ``slot``, from the rank that
        holds it."""
        pt, npg = model["page_table"], model["n_pages"]
        if not rows.axes:
            return pt[slot], npg[slot]
        vec = torch.zeros((1, pt.shape[1] + 1), dtype=torch.int32,
                          device=pt.device)
        if rows.owns(slot):
            vec[0, :-1] = pt[slot - rows.lo]
            vec[0, -1] = npg[slot - rows.lo]
        got = DL.gather_rows(vec, rows)[slot // rows.n]
        return got[:-1], got[-1]

    def free_pages(model: Dict, slot: int) -> None:
        row, n = slot_pages(model, slot)
        C.push_row(model["free_list"], model["free_top"], row, n)
        if rows.owns(slot):
            model["page_table"][slot - rows.lo] = -1
            model["n_pages"][slot - rows.lo] = 0

    def admit(params, st: DecodeState, slot: int, prompt: torch.Tensor,
              max_new_tokens: int, eos_id: int, temperature: float = 0.0,
              top_p: float = 1.0, rng_key=None) -> DecodeState:
        loc = local_view(st)
        dev = loc.buf.device
        prompt = torch.as_tensor(prompt).to(device=dev, dtype=torch.int32)
        P, Lb = prompt.shape[0], loc.buf.shape[1]
        with DL.active(scratch):
            row_model = M.init_state(_local_kv_cfg(cfg), 1,
                                     P if paged else Lb, device=dev)
            logits, row_model = M.prefill(params, cfg, row_model,
                                          tokens=prompt[None],
                                          last_only=True)
        first, k_carry = _first_token(logits, temperature, top_p, rng_key)
        st.model["cur_len"].to_local()[slot] = P
        own, sl = rows.owns(slot), slot - rows.lo
        if paged:
            model = loc.model
            free_pages(model, slot)
            ps = next(iter(C.attn_groups(model).values()))["k"].shape[2]
            row, n = C.alloc_row(model["free_list"], model["free_top"],
                                 torch.full_like(model["page_table"][0], -1),
                                 0, C.pages_for_len(P, ps))
            if own:
                model["page_table"][sl] = row
                model["n_pages"][sl] = n
            # every rank writes the pages of its pool shard (the row is
            # the same on every rank: nothing to gather)
            with DL.active(DL.Rows(mesh, 1, (), 0, 1, layout)):
                phys = C.phys_slots(row[None], torch.arange(
                    P, device=dev)[None], ps, layout.pool_pages - 1)
                for g_id, g in C.attn_groups(model).items():
                    r = row_model["groups"][g_id]
                    C.paged_kv_write(g["k"], g["v"], r["k"][:, :, :P],
                                     r["v"][:, :, :P], phys)
        if own:
            # the slot's recurrent leaves (the prefill computed this rank's
            # shards of them), and a linear cache's shard of its sequence
            for g_id, g in loc.model["groups"].items():
                if paged and "k" in g:
                    continue
                for name, leaf in g.items():
                    row = row_model["groups"][g_id][name][:, 0]
                    if name in ("k", "v"):
                        lo, hi = DL.shard_range(mesh, row.shape[1],
                                                layout.seq)
                        row = row[:, lo:hi]
                    leaf[:, sl] = row
            _write_slot(loc, sl, prompt, first,
                        max_new_tokens, eos_id, temperature, top_p, k_carry)
        return st

    def release(st: DecodeState, slot: int) -> DecodeState:
        loc = local_view(st)
        if paged:
            free_pages(loc.model, slot)
        if rows.owns(slot):
            # the owner empties the slot's shards of the recurrent state
            # (zeros, the -1e9 stabilisers), as a paged reset_slot does
            C.reset_recurrent(loc.model, slot - rows.lo)
            _clear_slot(loc, slot - rows.lo)
        return st

    return ShardedSlotFns(step, admit, release, placements)


def greedy_reference(params, cfg: ModelConfig, prompt, max_new_tokens: int,
                     device="cuda") -> torch.Tensor:
    """Plain greedy decoding via full forward() only — the test oracle.
    A fixed-shape buffer: causality keeps the zero tail from influencing the
    position being read."""
    dev = resolve_device(device)
    prompt = torch.as_tensor(np.asarray(prompt) if not torch.is_tensor(prompt)
                             else prompt).to(device=dev, dtype=torch.int32)
    B, P = prompt.shape
    buf = torch.zeros((B, P + max_new_tokens), dtype=torch.int32, device=dev)
    buf[:, :P] = prompt
    for i in range(max_new_tokens):
        logits, _ = M.forward(params, cfg, tokens=buf)
        buf[:, P + i] = torch.argmax(logits[:, P + i - 1], dim=-1).to(
            torch.int32)
    return buf


def sampling_reference(params, cfg: ModelConfig, prompt, max_new_tokens: int,
                       rng, temperature, top_p=1.0, device="cuda"
                       ) -> torch.Tensor:
    """Plain temperature/top-p decoding via full forward() only: the
    sampled sibling of ``greedy_reference`` and the oracle of the
    distribution tests.  Per-row key chains are the engine's
    (``per_row_keys``, then one split per sampled token, first token
    included), and every draw is ``verify.sample_token``, so spec against
    plain isolates the acceptance walk.  No eos or budget: every row
    samples ``max_new_tokens``."""
    dev = resolve_device(device)
    prompt = torch.as_tensor(np.asarray(prompt) if not torch.is_tensor(prompt)
                             else prompt).to(device=dev, dtype=torch.int32)
    B, P = prompt.shape
    buf = torch.zeros((B, P + max_new_tokens), dtype=torch.int32, device=dev)
    buf[:, :P] = prompt
    f32 = dict(dtype=torch.float32, device=dev)
    temp = torch.as_tensor(temperature, **f32).expand(B)
    topp = torch.as_tensor(top_p, **f32).expand(B)
    keys = per_row_keys(rng, B).to(dev)
    for i in range(max_new_tokens):
        logits, _ = M.forward(params, cfg, tokens=buf)
        nk = prng.split(keys)
        buf[:, P + i] = sample_token(logits[:, P + i - 1], nk[:, 0], temp,
                                     topp)
        keys = nk[:, 1]
    return buf
