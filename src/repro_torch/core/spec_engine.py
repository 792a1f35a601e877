"""The speculative generation engine: draft -> verify -> accept -> commit
(port of the linear, greedy path of ``repro/core/spec_engine.py``).

The unit of work is ONE iteration, ``spec_step``: it drafts, runs the
batched verification call and commits the winning tokens for every active
row of a persistent ``DecodeState``.  The step is fixed-shape and reads
nothing back to the host, so that a CUDA graph can capture it; ``generate``
loops over it and reads one boolean per step to stop.

Invariants (as in the reference):
  - output is bit-identical to greedy decoding;
  - per row: model cur_len == #cached positions == buf_len - 1 (the last
    committed token's KV is written by the next call).

The commit writes the winner's verified KV tail into the shared cache in
place (attention-only stacks; the reference's gated replay for recurrent
mixers, the tree and adaptive branches and sampling are not ported yet).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..models import model as M
from ..models.config import ModelConfig
from .drafters import (bigram_draft, context_ngram_draft, mixed_draft,
                       unigram_draft)
from .ngram_tables import NGramTables
from .verify import accept

STRATEGIES = ("mixed", "bigram", "unigram", "context", "greedy")


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    k: int = 10                 # number of batched drafts
    w: int = 10                 # speculation depth
    q: int = 1                  # context-match query length
    strategy: str = "mixed"     # mixed | bigram | unigram | context | greedy
    max_new_tokens: int = 64
    eos_id: int = -1            # -1: never stop on eos

    def validate(self) -> "SpecConfig":
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
    means the row never stops on eos.  Every leaf is fixed-shape."""
    buf: torch.Tensor         # (B, L) int32 token buffer (prompt + output)
    buf_len: torch.Tensor     # (B,) int32 committed length per row
    prompt_len: torch.Tensor  # (B,) int32
    budget: torch.Tensor      # (B,) int32 per-row max_new_tokens
    eos_id: torch.Tensor      # (B,) int32 per-row eos (-1: never)
    done: torch.Tensor        # (B,) bool
    active: torch.Tensor      # (B,) bool — slot currently occupied
    model: Dict               # models/cache.py state {"cur_len", "groups"}
    stats: Dict[str, torch.Tensor]


def _draft(spec: SpecConfig, tables: NGramTables, buf, buf_len, last):
    if spec.strategy == "mixed":
        return mixed_draft(tables, buf, buf_len, last, spec.q, spec.k, spec.w)
    if spec.strategy == "bigram":
        d, v = bigram_draft(tables, last, spec.k, spec.w)
    elif spec.strategy == "unigram":
        d, v = unigram_draft(tables, buf.shape[0], spec.k, spec.w)
    elif spec.strategy == "context":
        d, v = context_ngram_draft(buf, buf_len, spec.q, spec.k, spec.w)
        d = torch.where(v[..., None], d, 0)
    else:
        raise ValueError(spec.strategy)
    n_ctx = (v.sum(dim=1) if spec.strategy == "context"
             else torch.zeros((buf.shape[0],), dtype=torch.int32,
                              device=buf.device))
    return d, v, n_ctx.to(torch.int32)


def _init_stats(spec: SpecConfig, B: int, device) -> Dict[str, torch.Tensor]:
    z = lambda *shape: torch.zeros(shape, dtype=torch.int32, device=device)
    return {
        "calls": z(B),
        "tokens": z(B),
        # n_commit per verify call in bins 0..w+1; bin 0 stays zero (every
        # call commits >= 1 token) and hist.sum() == calls
        "accept_hist": z(B, spec.w + 2),
        "rank_hist": z(B, max(spec.k, 1)),
        "alloc_ctx": z(B, spec.k + 1),          # n_ctx per call
        "accepted_ctx": z(B),                   # drafted tokens accepted
        "accepted_bigram": z(B),                # per source
    }


# ---------------------------------------------------------------------------
# state construction
# ---------------------------------------------------------------------------
def init_decode_state(params, cfg: ModelConfig, spec: SpecConfig,
                      prompt: torch.Tensor,
                      eos_id: Optional[torch.Tensor] = None) -> DecodeState:
    """Prefill every row of ``prompt`` (B, P) into a fresh DecodeState on
    the prompt's device.  The buffer holds P + max_new_tokens + w + 2
    tokens; K1 masks the cache's ragged edge itself, so no kernel alignment
    is applied.  ``eos_id``: optional per-row override of spec.eos_id."""
    spec.validate()
    if M.has_recurrent(cfg):
        raise NotImplementedError(
            f"{cfg.name}: recurrent mixers are not ported yet")
    dev = prompt.device
    B, P = prompt.shape
    L = P + spec.max_new_tokens + spec.w + 2
    eos = (torch.full((B,), spec.eos_id, dtype=torch.int32, device=dev)
           if eos_id is None
           else torch.as_tensor(eos_id, dtype=torch.int32,
                                device=dev).expand(B).clone())
    model = M.init_state(cfg, B, L, device=dev)
    buf = torch.zeros((B, L), dtype=torch.int32, device=dev)
    buf[:, :P] = prompt.to(torch.int32)
    logits_p, model = M.prefill(params, cfg, model, tokens=prompt,
                                last_only=True)
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
        stats=stats)


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------
def _spec_body(params, cfg: ModelConfig, spec: SpecConfig,
               tables: Optional[NGramTables], s: DecodeState) -> DecodeState:
    B, L = s.buf.shape
    dev = s.buf.device
    buf_c, len_c, done_c, state_c = s.buf, s.buf_len, s.done, s.model
    last = buf_c.gather(1, (len_c - 1)[:, None].long())[:, 0]
    drafts, valid, n_ctx = _draft(spec, tables, buf_c, len_c, last)
    rows = torch.cat([last[:, None, None].expand(B, spec.k, 1), drafts],
                     dim=-1)                                     # (B,k,w+1)
    logits, tails = M.verify(params, cfg, state_c, rows)
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    acc = accept(drafts, greedy)
    active = s.active & (~done_c) & (len_c - s.prompt_len < s.budget)
    budget = (s.prompt_len + s.budget - len_c).clamp(min=0)
    n_commit = torch.where(active, torch.minimum(acc.n_commit, budget), 0)
    # eos truncation: commit only up to (and including) the first eos
    iseos = (acc.tokens == s.eos_id[:, None]) & (s.eos_id >= 0)[:, None]
    first_eos = torch.argmax(iseos.to(torch.int32), dim=1)
    has_eos = iseos.any(dim=1) & (first_eos < n_commit)
    n_commit = torch.where(has_eos, first_eos + 1, n_commit).to(torch.int32)
    done_c = done_c | (has_eos & active)
    # commit the model state (in place)
    state_n = M.commit_kv_tails(cfg, state_c, tails, acc.winner, n_commit)
    # write accepted tokens into the buffer (in place)
    pos = torch.arange(spec.w + 1, device=dev)[None, :]
    slots = (len_c[:, None].long() + pos).clamp(0, L - 1)
    gate = pos < n_commit[:, None]
    old = buf_c.gather(1, slots)
    buf_c.scatter_(1, slots, torch.where(gate, acc.tokens, old))
    len_n = len_c + n_commit
    done_n = done_c | (len_n - s.prompt_len >= s.budget)
    # ---- stats ----
    st = dict(s.stats)
    act = active.to(torch.int32)
    b_idx = torch.arange(B, device=dev)
    st["calls"] = st["calls"] + act
    st["tokens"] = st["tokens"] + n_commit
    st["accept_hist"] = st["accept_hist"].index_put(
        (b_idx, n_commit.long().clamp(0, spec.w + 1)), act, accumulate=True)
    n_win = acc.n_acc.gather(1, acc.winner[:, None].long())[:, 0]
    st["rank_hist"] = st["rank_hist"].index_put(
        (b_idx, acc.winner.long()), (active & (n_win > 0)).to(torch.int32),
        accumulate=True)
    st["alloc_ctx"] = st["alloc_ctx"].index_put(
        (b_idx, n_ctx.long().clamp(0, spec.k)), act, accumulate=True)
    from_ctx = acc.winner < n_ctx
    acc_drafted = (n_commit - 1).clamp(min=0)
    st["accepted_ctx"] = st["accepted_ctx"] + torch.where(
        active & from_ctx, acc_drafted, 0)
    st["accepted_bigram"] = st["accepted_bigram"] + torch.where(
        active & ~from_ctx, acc_drafted, 0)
    return dataclasses.replace(s, buf=buf_c, buf_len=len_n, done=done_n,
                               model=state_n, stats=st)


def _greedy_body(params, cfg: ModelConfig, spec: SpecConfig,
                 tables: Optional[NGramTables], s: DecodeState) -> DecodeState:
    B, L = s.buf.shape
    dev = s.buf.device
    buf_c, len_c, done_c, state_c = s.buf, s.buf_len, s.done, s.model
    cur_c = state_c["cur_len"]
    last = buf_c.gather(1, (len_c - 1)[:, None].long())
    logits, state_n = M.decode(params, cfg, state_c, last)
    active = s.active & (~done_c) & (len_c - s.prompt_len < s.budget)
    # decode advances cur_len by 1 for every row; freeze inactive rows so
    # the cur_len == buf_len - 1 invariant holds for done rows too (their
    # cache writes are row-local and never read: only p < cur_len is)
    state_n["cur_len"] = cur_c + active.to(torch.int32)
    nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    slots = len_c.long().clamp(0, L - 1)[:, None]
    b_idx = torch.arange(B, device=dev)
    buf_c.scatter_(1, slots, torch.where(active, nxt,
                                         buf_c.gather(1, slots)[:, 0])[:, None])
    len_n = len_c + active.to(torch.int32)
    done_n = done_c | (len_n - s.prompt_len >= s.budget)
    done_n = done_n | ((nxt == s.eos_id) & (s.eos_id >= 0))
    st = dict(s.stats)
    act = active.to(torch.int32)
    st["calls"] = st["calls"] + act
    st["tokens"] = st["tokens"] + act
    # a greedy call commits exactly one token: bin 1 of the histogram
    st["accept_hist"] = st["accept_hist"].index_put(
        (b_idx, torch.ones_like(b_idx)), act, accumulate=True)
    return dataclasses.replace(s, buf=buf_c, buf_len=len_n, done=done_n,
                               model=state_n, stats=st)


def spec_step(params, cfg: ModelConfig, spec: SpecConfig, state: DecodeState,
              tables: Optional[NGramTables] = None) -> DecodeState:
    """One draft -> verify -> commit iteration over every active row.  Rows
    that are inactive or done commit nothing and their stats are untouched.
    The state's buffers are updated in place (the reference donates them);
    callers rebind to the returned state."""
    body = _greedy_body if spec.strategy == "greedy" else _spec_body
    if body is _spec_body and tables is None:
        raise ValueError(f"strategy {spec.strategy!r} needs NGramTables")
    return body(params, cfg, spec, tables, state)


# ---------------------------------------------------------------------------
# one-shot generation
# ---------------------------------------------------------------------------
def generate(params, cfg: ModelConfig, spec: SpecConfig, prompt,
             tables: Optional[NGramTables] = None,
             eos_id: Optional[torch.Tensor] = None, device="cuda"
             ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """Generate up to max_new_tokens for every row of ``prompt`` (B, P) on
    ``device`` (where ``params`` and ``tables`` live).  ``eos_id``: optional
    per-row override of spec.eos_id.  Returns (buf (B, L), buf_len (B,),
    stats)."""
    dev = resolve_device(device)
    prompt = torch.as_tensor(np.asarray(prompt) if not torch.is_tensor(prompt)
                             else prompt).to(device=dev, dtype=torch.int32)
    state = init_decode_state(params, cfg, spec, prompt, eos_id=eos_id)
    # the loop's one host read per step: is any row still running?
    while bool(((~state.done)
                & (state.buf_len - state.prompt_len < state.budget)).any()):
        state = spec_step(params, cfg, spec, state, tables)
    return state.buf, state.buf_len, state.stats


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
