"""Plain PyTorch oracles of the port's kernels: twins of the reference's
``repro/kernels/ref.py`` (same layouts, same masking, f32 math)."""
from __future__ import annotations

import torch

from .hashing import HASH_DTYPE, hash_step

NEG_INF = -1e30


def spec_attention_ref(q, k_cache, v_cache, k_tail, v_tail, cur_len, *,
                       w1: int, tail_mask=None) -> torch.Tensor:
    """Bifurcated verify attention, computed densely in f32.

    q: (B,H,KW1,hd); k/v_cache: (B,KV,S,hd); k/v_tail: (B,KV,KW1,hd);
    cur_len: (B,).  Cache slots >= cur_len are masked; tail key j is
    visible to query i iff both lie in the same w1-row and j%w1 <= i%w1,
    or, given ``tail_mask`` (KW1, KW1) bool (a tree's ancestor-or-self
    mask), iff ``tail_mask[i, j]``.  Returns (B,H,KW1,hd) in q's dtype.
    """
    B, H, KW1, hd = q.shape
    KV, S = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    qf = q.float().reshape(B, KV, G, KW1, hd)
    scale = 1.0 / (hd ** 0.5)
    lc = torch.einsum("bngqh,bnsh->bngqs", qf, k_cache.float()) * scale
    valid = (torch.arange(S, device=q.device)[None, :]
             < cur_len.to(q.device)[:, None])
    lc = torch.where(valid[:, None, None, None, :], lc, NEG_INF)
    lt = torch.einsum("bngqh,bnth->bngqt", qf, k_tail.float()) * scale
    if tail_mask is None:
        qi = torch.arange(KW1, device=q.device)
        same_row = (qi[:, None] // w1) == (qi[None, :] // w1)
        causal = (qi[None, :] % w1) <= (qi[:, None] % w1)
        tail_mask = same_row & causal
    lt = torch.where(torch.as_tensor(tail_mask, dtype=torch.bool,
                                     device=q.device), lt, NEG_INF)
    w = torch.softmax(torch.cat([lc, lt], dim=-1), dim=-1)
    out = (torch.einsum("bngqs,bnsh->bngqh", w[..., :S], v_cache.float())
           + torch.einsum("bngqt,bnth->bngqh", w[..., S:], v_tail.float()))
    return out.reshape(B, H, KW1, hd).to(q.dtype)


def gather_pages(k_pool: torch.Tensor, v_pool: torch.Tensor,
                 page_table: torch.Tensor):
    """The per-slot linear view (B, PPS*ps, KV, hd) of a paged pool
    (NP, ps, KV, hd), copied.  An unallocated page (-1) reads physical
    page 0; every position it covers is >= cur_len, so the verify mask hides
    it.  (Twin of the reference's ``models/cache.py:gather_pages``.)"""
    B, PPS = page_table.shape
    pid = page_table.clamp(min=0).long()
    tail = k_pool.shape[1:]
    shape = (B, PPS * tail[0]) + tuple(tail[1:])
    return k_pool[pid].reshape(shape), v_pool[pid].reshape(shape)


def ngram_match_ref(buf_padded: torch.Tensor, query: torch.Tensor,
                    cur_len: torch.Tensor, *, w: int):
    """Oracle of the n-gram sweep over any leading batch dims.

    buf_padded: (..., L+q+w) int; query: (..., q); cur_len: (...).
    Returns (match (..., L) int32, hash (..., L) HASH_DTYPE) with
      match[i] = all(buf[i:i+q] == query) and i + q + w <= cur_len
      hash[i]  = hash_rows(buf[i+q : i+q+w]).
    """
    q = query.shape[-1]
    L = buf_padded.shape[-1] - q - w
    pos = torch.arange(L, device=buf_padded.device)
    match = torch.ones(buf_padded.shape[:-1] + (L,), dtype=torch.bool,
                       device=buf_padded.device)
    for j in range(q):
        match = match & (buf_padded[..., j:j + L] == query[..., j:j + 1])
    match = match & (pos + q + w <= cur_len[..., None])
    h = torch.zeros(match.shape, dtype=HASH_DTYPE, device=buf_padded.device)
    for j in range(w):
        h = hash_step(h, buf_padded[..., q + j:q + j + L])
    return match.to(torch.int32), h


def mamba_scan_ref(u, dt, A, B, C, D, h0, *, steps: bool = False):
    """Oracle of the selective scan: the sequential recurrence in f32.

    u/dt: (Bt, T, di); A: (di, ds); B/C: (Bt, T, ds); D: (di,); h0:
    (Bt, di, ds).  Per step t:  h = exp(dt_t * A) * h + (dt_t * u_t) * B_t,
    y_t = h . C_t + u_t * D.  Returns (y (Bt, T, di), hT (Bt, di, ds), the
    state after every step (Bt, T, di, ds) when ``steps``, else None), all
    f32; T >= 1.  (Twin of the reference's ``kernels/ref.py:
    mamba_scan_ref``, plus the per-step states that the gated replay
    selects from.)
    """
    uf, dtf = u.float(), dt.float()
    Af, Bf, Cf = A.float(), B.float(), C.float()
    h = h0.float()
    ys, hs = [], []
    for t in range(uf.shape[1]):
        dA = torch.exp(dtf[:, t, :, None] * Af)
        h = dA * h + (dtf[:, t] * uf[:, t])[..., None] * Bf[:, t, None, :]
        ys.append(torch.einsum("bds,bs->bd", h, Cf[:, t]))
        if steps:
            hs.append(h)
    y = torch.stack(ys, dim=1) + uf * D.float()
    return y, h, torch.stack(hs, dim=1) if steps else None


def select_step_state(per_step: torch.Tensor, old: torch.Tensor,
                      n_commit: torch.Tensor) -> torch.Tensor:
    """The gated replay's commit of a recurrent state (twin of the
    reference's ``models/cache.py:select_step_state``).  per_step: (B, T,
    ...) states after each step; old: (B, ...) the state before them;
    n_commit: (B,).  Returns the state after n_commit steps (clamped to T;
    ``old`` where n_commit <= 0)."""
    B, T = per_step.shape[:2]
    idx = (n_commit.long() - 1).clamp(0, T - 1)
    picked = per_step[torch.arange(B, device=per_step.device), idx]
    keep = (n_commit > 0).reshape((B,) + (1,) * (old.dim() - 1))
    return torch.where(keep, picked, old)
