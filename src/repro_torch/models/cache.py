"""Decode state: the linear KV cache and the speculative commit (port of the
linear half of ``repro/models/cache.py``).

State layout, as in the reference (every leaf stacked over the R periods
of the layer pattern):

  state = {
    "cur_len": (B,) int32   — #positions committed per sequence,
    "groups": {gid: {"k": (R, B, S, KV, hd), "v": ...}},
  }

Where the reference relies on buffer donation, the port updates the cache
in place (``index_put_``); every such write says so.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..device import resolve_device
from .config import ATTN, BlockSpec, ModelConfig


def cache_buffer_len(cfg: ModelConfig, max_len: int) -> int:
    """Physical KV buffer length: window-sized ring when sliding-window."""
    if cfg.sliding_window is not None and cfg.sliding_window < max_len:
        return cfg.sliding_window
    return max_len


def group_ids(cfg: ModelConfig):
    """(gid, BlockSpec, R) for prefix and body pattern positions."""
    out = []
    for i, b in enumerate(cfg.prefix_blocks):
        out.append((f"pre{i}", b, 1))
    for j, b in enumerate(cfg.block_pattern):
        out.append((f"p{j}", b, cfg.num_periods))
    return out


def _init_group(cfg: ModelConfig, spec: BlockSpec, R: int, batch: int,
                S: int, device) -> Dict:
    """Empty decode-state group for one layer position (linear ATTN)."""
    if spec.mixer != ATTN:
        raise NotImplementedError(
            f"{cfg.name}: {spec.mixer} state is not ported yet")
    shape = (R, batch, S, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.compute_dtype, device=device)}


def init_state(cfg: ModelConfig, batch: int, max_len: int,
               device="cuda") -> Dict:
    """Allocate an empty decode state for ``batch`` sequences."""
    dev = resolve_device(device)
    S = cache_buffer_len(cfg, max_len)
    groups = {gid: _init_group(cfg, spec, R, batch, S, dev)
              for gid, spec, R in group_ids(cfg)}
    return {"cur_len": torch.zeros((batch,), dtype=torch.int32, device=dev),
            "groups": groups}


# ----------------------------------------------------------------------------
# position bookkeeping
# ----------------------------------------------------------------------------
def key_positions(cfg: ModelConfig, S: int,
                  cur_len: torch.Tensor) -> torch.Tensor:
    """Absolute position stored in each cache slot; -1 where empty.

    cur_len: (B,). Linear cache: slot s holds position s if s < cur_len.
    Ring cache (window W=S): slot s holds the largest p < cur_len with
    p % W == s, valid if p >= 0 and p >= cur_len - W.
    """
    B = cur_len.shape[0]
    slots = torch.arange(S, device=cur_len.device)[None, :]
    cl = cur_len[:, None]
    if cfg.sliding_window is not None and cfg.sliding_window <= S:
        p = cl - 1 - torch.remainder(cl - 1 - slots, S)
        valid = (p >= 0) & (p >= cl - S) & (cl > 0)
        return torch.where(valid, p, -1).to(torch.int32)
    pos = slots.expand(B, S)
    return torch.where(pos < cl, pos, -1).to(torch.int32)


def write_slots(cfg: ModelConfig, S: int, cur_len: torch.Tensor,
                T_new: int) -> torch.Tensor:
    """Cache slots for the next T_new positions. (B, T_new) int64."""
    pos = (cur_len[:, None].long()
           + torch.arange(T_new, device=cur_len.device)[None, :])
    if cfg.sliding_window is not None and cfg.sliding_window <= S:
        return torch.remainder(pos, S)
    return pos


def kv_write(k_cache: torch.Tensor, v_cache: torch.Tensor,
             k_new: torch.Tensor, v_new: torch.Tensor,
             slots: torch.Tensor,
             gate: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write new KV into slots, IN PLACE.  caches: (N, S, KV, hd); new:
    (N, T, KV, hd); slots: (N, T).  ``gate``: (N, T) bool — write only where
    True (spec commit).  Returns the updated caches.

    Slots outside [0, S) are dropped, as the reference's scatter drops them;
    a dropped or gated-off position rewrites the value already at its
    (clamped) slot, so the caller keeps in-range writes off slot S-1 when a
    row also drops writes (the engine's buffers always leave that margin).
    """
    N, T = slots.shape
    S = k_cache.shape[1]
    keep = (slots >= 0) & (slots < S)
    if gate is not None:
        keep = keep & gate
    idx = slots.clamp(0, S - 1)
    n_idx = torch.arange(N, device=slots.device)[:, None].expand(N, T)
    m = keep[..., None, None]
    for cache, new in ((k_cache, k_new), (v_cache, v_new)):
        old = cache[n_idx, idx]
        cache.index_put_((n_idx, idx),
                         torch.where(m, new.to(cache.dtype), old))
    return k_cache, v_cache


def prefill_write(cfg: ModelConfig, k_cache, v_cache, k_new, v_new,
                  seq_mask: Optional[torch.Tensor] = None):
    """Write a full prefill block (positions 0..T-1) into an empty cache,
    IN PLACE.  With a ring cache shorter than the prompt only the last S
    positions land (ring semantics)."""
    B, T = k_new.shape[:2]
    S = k_cache.shape[1]
    if T > S:
        k_new, v_new = k_new[:, -S:], v_new[:, -S:]
        if seq_mask is not None:
            seq_mask = seq_mask[:, -S:]
        off = torch.full((B,), T - S, dtype=torch.int32,
                         device=k_new.device)
        slots = write_slots(cfg, S, off, S)
        return kv_write(k_cache, v_cache, k_new, v_new, slots, gate=seq_mask)
    cur0 = torch.zeros((B,), dtype=torch.int32, device=k_new.device)
    slots = write_slots(cfg, S, cur0, T)
    return kv_write(k_cache, v_cache, k_new, v_new, slots, gate=seq_mask)
