"""Top-level language-model API: forward / prefill / decode / verify /
commit (port of ``repro/models/model.py``), over a linear or a paged KV
cache and the per-slot Mamba and xLSTM states (``models/cache.py``).

The reference's functions are pure and return new states; here ``prefill``,
``decode`` and ``commit_kv_tails`` update the state's cache IN PLACE and
return the same state dict, its ``cur_len`` advanced in place too (every
leaf keeps its storage, as ``analysis``'s ``in-place`` rule holds).
``verify`` only reads the state.  On a paged state each call computes the
physical slots of its writes once (``cache.phys_slots``) and hands them,
with the page table, to every layer.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..distributed import local as L
from .cache import (attn_groups, init_state, is_paged, key_positions,
                    kv_write, paged_dims, paged_kv_write, phys_slots,
                    write_slots)
from .config import ATTN, MROPE, ModelConfig, layer_blocks
from .layers import apply_norm, embed_tokens, lm_logits
from .transformer import init_params, run_stack

Params = Dict[str, Any]
State = Dict[str, Any]

__all__ = ["init_params", "init_state", "forward", "forward_hidden",
           "prefill", "decode", "verify", "commit_kv_tails", "has_recurrent",
           "make_positions"]


def has_recurrent(cfg: ModelConfig) -> bool:
    return any(b.mixer != ATTN for b in layer_blocks(cfg))


def _pure_recurrent(cfg: ModelConfig) -> bool:
    return all(b.mixer != ATTN for b in layer_blocks(cfg))


def _linear_positions(B: int, T: int, offset: Optional[torch.Tensor] = None,
                      device=None) -> torch.Tensor:
    """(B, T) int64 positions, shifted by ``offset`` (B,) when given."""
    dev = offset.device if offset is not None else device
    pos = torch.arange(T, device=dev)[None].expand(B, T)
    if offset is not None:
        pos = pos + offset[:, None].long()
    return pos


def _rope_positions(cfg: ModelConfig, pos: torch.Tensor) -> torch.Tensor:
    """(B, T) positions as the config's RoPE reads them: (3, B, T) for
    M-RoPE, where a text token's t/h/w positions coincide (Qwen2-VL
    §3.1)."""
    if cfg.rope == MROPE:
        return pos[None].expand(3, *pos.shape)
    return pos


def make_positions(cfg: ModelConfig, B: int, T: int,
                   offset: Optional[torch.Tensor] = None,
                   device=None) -> torch.Tensor:
    """(B, T) int64 positions, shifted by ``offset`` (B,) when given;
    (3, B, T) for M-RoPE."""
    return _rope_positions(cfg, _linear_positions(B, T, offset, device))


def _cache_len(state: State) -> int:
    """Logical cache capacity per row (pages_per_slot * page_size when
    paged; the whole sequence under a mesh that shards it)."""
    if is_paged(state):
        _, ps, pps = paged_dims(state)
        return pps * ps
    S = next(iter(attn_groups(state).values()))["k"].shape[2]
    rows = L.current()
    if rows is not None and rows.cache.seq:
        S *= L.ways(rows.mesh, rows.cache.seq)
    return S


def _paged_ctx(state: State, pos: torch.Tensor) -> Dict[str, Any]:
    """ctx entries of a paged call whose writes go to logical ``pos``."""
    N, ps, _ = paged_dims(state)
    return {"paged": True, "page_table": state["page_table"],
            "slots": phys_slots(state["page_table"], pos, ps, N)}


def _embed(params: Params, cfg: ModelConfig, tokens, embeds
           ) -> torch.Tensor:
    """The first hidden states: ``embeds`` (B, T, d) as given (an
    embedding-input model's frame or patch embeddings), else the token
    embeddings of ``tokens`` (B, T)."""
    if embeds is not None:
        x = embeds.to(cfg.compute_dtype)
        # under a mesh, this rank's rows as the DTensor of every rank's
        return x if L.current() is None else L.lift(x)
    return embed_tokens(params["embed"], tokens, cfg)


def _logits(params: Params, cfg: ModelConfig, x) -> torch.Tensor:
    """The head's logits, as this rank's local rows under a mesh (the
    step's row work reads them whole over the vocabulary)."""
    logits = lm_logits(params["embed"], x, cfg)
    return logits if L.current() is None else L.lower(logits)


def forward_hidden(params: Params, cfg: ModelConfig, tokens=None,
                   embeds=None, positions=None, remat: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full forward up to the final norm, from ``tokens`` (B, T) or
    ``embeds`` (B, T, d).  Returns (hidden (B, T, d), aux) — aux is the
    MoE layers' mean router load-balance loss (0 for a stack without MoE
    layers).  ``remat`` checkpoints each block for backward (training)."""
    x = _embed(params, cfg, tokens, embeds)
    # under a mesh x holds every rank's rows, the positions this rank's
    B, T = (x if tokens is None else tokens).shape[:2]
    if positions is None:
        positions = make_positions(cfg, B, T, device=x.device)
    x, _, aux = run_stack(params, cfg, x, "full", None,
                          {"positions": positions}, remat=remat)
    return apply_norm(params["final_norm"], x, cfg), aux


def forward(params: Params, cfg: ModelConfig, tokens=None, embeds=None,
            positions=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full forward (scoring) from ``tokens`` or ``embeds``.  Returns
    (logits f32, aux)."""
    x, aux = forward_hidden(params, cfg, tokens, embeds, positions)
    return _logits(params, cfg, x), aux


def prefill(params: Params, cfg: ModelConfig, state: State,
            tokens: Optional[torch.Tensor] = None,
            positions: Optional[torch.Tensor] = None,
            last_only: bool = False, embeds: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, State]:
    """Process the prompt (all rows of length T), from ``tokens`` (B, T) or
    ``embeds`` (B, T, d), writing the cache in place.  ``state`` must be
    freshly allocated (cur_len == 0).  ``last_only`` computes logits for
    the final position only."""
    x = _embed(params, cfg, tokens, embeds)
    src = tokens if tokens is not None else embeds
    B, T = src.shape[:2]
    if positions is None:
        positions = make_positions(cfg, B, T, device=src.device)
    ctx: Dict[str, Any] = {"positions": positions}
    if is_paged(state):
        # positions 0..T-1 of every row, through its page table (the pages
        # must be allocated already)
        ctx.update(_paged_ctx(state, _linear_positions(
            B, T, device=src.device)))
    x, _, _ = run_stack(params, cfg, x, "prefill", state, ctx)
    x = apply_norm(params["final_norm"], x, cfg)
    if last_only:
        x = x[:, -1:]
    logits = _logits(params, cfg, x)
    state["cur_len"].add_(T)
    return logits, state


def decode(params: Params, cfg: ModelConfig, state: State,
           tokens: torch.Tensor, n_commit: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, State]:
    """Decode T new tokens from the cached state; their KV and the
    recurrent state are written in place and cur_len advances by T for
    every row.

    With ``n_commit`` (B,), runs in *replay* mode: only the first n_commit
    positions of each row update the KV cache and the recurrent state, and
    cur_len advances by n_commit — the speculative commit of the winning
    row for recurrent stacks (the paper's "overwrite all rows with the
    accepted speculation", adapted to recurrent state)."""
    B, T = tokens.shape[:2]
    cur = state["cur_len"]
    ctx: Dict[str, Any] = {"positions": make_positions(cfg, B, T,
                                                       offset=cur)}
    if not _pure_recurrent(cfg):
        S = _cache_len(state)
        ctx.update(slots=write_slots(cfg, S, cur, T),
                   cache_pos=key_positions(cfg, S, cur), cur_len=cur)
        if is_paged(state):
            ctx.update(_paged_ctx(state, ctx["slots"]))
    mode = "decode"
    if n_commit is not None:
        mode = "replay"
        ctx["n_commit"] = n_commit
        ctx["gate"] = (torch.arange(T, device=cur.device)[None, :]
                       < n_commit[:, None])
    x = embed_tokens(params["embed"], tokens, cfg)
    x, _, _ = run_stack(params, cfg, x, mode, state, ctx)
    x = apply_norm(params["final_norm"], x, cfg)
    logits = _logits(params, cfg, x)
    cur.add_(T if n_commit is None else n_commit.to(cur.dtype))
    return logits, state


def verify(params: Params, cfg: ModelConfig, state: State,
           tokens: torch.Tensor, pos_off: Optional[torch.Tensor] = None,
           tail_mask=None) -> Tuple[torch.Tensor, Dict]:
    """The paper's batched verification call.

    tokens: (B, k, w+1) — row i is [last_token, draft_i(0..w-1)].
    Returns (logits (B, k, w+1, V) f32, kv tails of the attention groups
    {gid: {"k_tail", "v_tail": (R, B, k, w+1, KV, hd)}}).  The state is only
    read; recurrent layers run every row from its slot's state.

    Tree mode passes the whole token tree as the single row k == 1 with two
    per-topology constants (``core/tree.device_constants``):
      pos_off:   (w+1,) int tensor, each input's position offset (its tree
                 level; 0 for the committed last token) in place of the
                 linear arange: input i sits at cur_len + pos_off[i];
      tail_mask: the topology's ``TreeMask``, ancestor-or-self visibility
                 between tree inputs, threaded to the attention tail.
    """
    B, K, W1 = tokens.shape
    cur = state["cur_len"]
    positions = (make_positions(cfg, B, W1, offset=cur) if pos_off is None
                 else _rope_positions(cfg, pos_off[None, :]
                                      + cur[:, None].long()))
    ctx: Dict[str, Any] = {"positions": positions,
                           "tail_mask": tail_mask,
                           "k_rows": K}
    if not _pure_recurrent(cfg):
        S = _cache_len(state)
        ctx.update(cache_pos=key_positions(cfg, S, cur), cur_len=cur)
        if is_paged(state):
            ctx["page_table"] = state["page_table"]
    x = embed_tokens(params["embed"], tokens.reshape(B * K, W1), cfg)
    x, kv_tails, _ = run_stack(params, cfg, x, "verify", state, ctx)
    x = apply_norm(params["final_norm"], x, cfg)
    logits = _logits(params, cfg, x)
    return logits.reshape(B, K, W1, -1), kv_tails


def commit_kv_tails(cfg: ModelConfig, state: State, kv_tails: Dict,
                    winner: torch.Tensor, n_commit: torch.Tensor) -> State:
    """Fast commit for attention-only stacks: write the winning row's first
    ``n_commit`` KV tail entries into the shared cache, IN PLACE, and
    advance cur_len.  Paged states route the same gated write through each
    slot's page table."""
    cur = state["cur_len"]
    S = _cache_len(state)
    paged = is_paged(state)
    phys = None
    for gid, tails in kv_tails.items():
        k_t, v_t = tails["k_tail"], tails["v_tail"]   # (R,B,K,W1,KV,hd)
        R, B, K, W1 = k_t.shape[:4]
        b_idx = torch.arange(B, device=winner.device)
        k_w = k_t[:, b_idx, winner.long()]            # (R,B,W1,KV,hd)
        v_w = v_t[:, b_idx, winner.long()]
        slots = write_slots(cfg, S, cur, W1)
        gate = (torch.arange(W1, device=cur.device)[None, :]
                < n_commit[:, None])
        g = state["groups"][gid]
        if paged:
            if phys is None:
                N, ps, _ = paged_dims(state)
                phys = phys_slots(state["page_table"], slots, ps, N)
            paged_kv_write(g["k"], g["v"], k_w, v_w, phys, gate=gate)
            continue
        flat = lambda t: t.view((R * B,) + t.shape[2:])   # views: in place
        kv_write(flat(g["k"]), flat(g["v"]), flat(k_w), flat(v_w),
                 slots.repeat(R, 1), gate=gate.repeat(R, 1))
    cur.add_(n_commit.to(cur.dtype))
    return state
