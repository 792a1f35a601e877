"""Attention: MHA / GQA / MQA with (partial) RoPE over a linear or paged KV
cache (port of ``repro/models/attention.py``).

Prefill and the full forward use ``masked_attention``, plain tensor ops (the
reference leaves it to XLA as well).  Verify and decode use the bifurcated
attention of the paper's batched (k, w+1) verification: on the card through
K1 (``kernels/dispatch.verify_attention``) or, over a paged pool, K3
(``dispatch.verify_attention_paged``), and K4 for a token tree in either
layout; on the CPU through ``_verify_attention_xla``, the plain verify.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..kernels import dispatch
from ..kernels.ref import gather_pages
from ..kernels.spec_attention import TreeMask
from .config import MROPE, ModelConfig

Params = Dict[str, torch.Tensor]

NEG_INF = -1e30


# ----------------------------------------------------------------------------
# RoPE (NeoX half-split over the first rotary_dim dims)
# ----------------------------------------------------------------------------
def _rope_inv_freq(cfg: ModelConfig, device) -> torch.Tensor:
    rd = cfg.rotary_dim
    ex = torch.arange(0, rd, 2, dtype=torch.float32, device=device) / rd
    return 1.0 / (cfg.rope_theta ** ex)


def rope_freqs(cfg: ModelConfig, positions: torch.Tensor) -> torch.Tensor:
    """positions: (B, T) int. Returns (B, T, rd/2) f32."""
    if cfg.rope == MROPE:
        raise NotImplementedError("M-RoPE is not ported yet")
    inv = _rope_inv_freq(cfg, positions.device)
    return positions.float()[..., None] * inv


def apply_rope(x: torch.Tensor, freqs: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    """x: (B, T, N, hd); freqs: (B, T, rd/2). NeoX half-split convention."""
    rd = cfg.rotary_dim
    if rd == 0:
        return x
    x_rot, x_pass = x[..., :rd], x[..., rd:]
    half = rd // 2
    x1, x2 = x_rot[..., :half], x_rot[..., half:]
    cos = torch.cos(freqs)[:, :, None, :].to(x.dtype)
    sin = torch.sin(freqs)[:, :, None, :].to(x.dtype)
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    return torch.cat([r1, r2, x_pass], dim=-1)


# ----------------------------------------------------------------------------
# full attention (prefill / forward), plain tensor ops
# ----------------------------------------------------------------------------
def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     q_pos: torch.Tensor, k_pos: torch.Tensor,
                     cfg: ModelConfig, causal: bool) -> torch.Tensor:
    """q: (B,T,H,hd) k/v: (B,S,KV,hd); *_pos: (B,T)/(B,S) (-1 = invalid key).

    Returns (B, T, H, hd).  GQA via reshape to (KV, G) groups.  (The
    reference's blockwise path for S >= 8192 computes the same softmax; it is
    not ported with this slice.)
    """
    B, T, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    qf = q.reshape(B, T, KV, G, hd).float()
    logits = torch.einsum("btkgh,bskh->bkgts", qf, k.float()) / (hd ** 0.5)
    if cfg.attn_logit_softcap:
        c = cfg.attn_logit_softcap
        logits = c * torch.tanh(logits / c)
    valid = (k_pos >= 0)[:, None, None, None, :]
    if causal:
        valid = valid & (k_pos[:, None, :] <= q_pos[:, :, None])[:, None, None]
    if cfg.sliding_window is not None:
        win = cfg.sliding_window
        valid = valid & (k_pos[:, None, :]
                         > q_pos[:, :, None] - win)[:, None, None]
    logits = torch.where(valid, logits, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgts,bskh->btkgh", w, v.float())
    return out.reshape(B, T, H, hd).to(q.dtype)


# ----------------------------------------------------------------------------
# layer application
# ----------------------------------------------------------------------------
def qkv_project(params: Params, x: torch.Tensor, cfg: ModelConfig,
                freqs: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    B, T, _ = x.shape
    hd = cfg.resolved_head_dim
    cd = cfg.compute_dtype
    x = x.to(cd)
    q = (x @ params["wq"].to(cd)).reshape(B, T, cfg.num_heads, hd)
    k = (x @ params["wk"].to(cd)).reshape(B, T, cfg.num_kv_heads, hd)
    v = (x @ params["wv"].to(cd)).reshape(B, T, cfg.num_kv_heads, hd)
    if cfg.rope != "none":
        q = apply_rope(q, freqs, cfg)
        k = apply_rope(k, freqs, cfg)
    return q, k, v


def attn_full(params: Params, x: torch.Tensor, cfg: ModelConfig,
              positions: torch.Tensor,
              seq_mask: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Self-attention over a full block (prefill / forward).

    positions: (B, T). seq_mask: (B, T) bool for padding.
    Returns output and the (k, v) tensors for cache insertion.
    """
    freqs = rope_freqs(cfg, positions) if cfg.rope != "none" else None
    q, k, v = qkv_project(params, x, cfg, freqs)
    k_pos = positions if seq_mask is None else torch.where(seq_mask,
                                                           positions, -1)
    out = masked_attention(q, k, v, positions, k_pos, cfg, causal=cfg.causal)
    B, T = out.shape[:2]
    y = out.reshape(B, T, -1) @ params["wo"].to(cfg.compute_dtype)
    return y, (k, v)


def _verify_attention_xla(q, k_cache, v_cache, k_tail, v_tail, cache_pos,
                          pos2d, cfg: ModelConfig,
                          tail_mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Plain bifurcated verify attention (the reference's XLA path).

    q: (B,K,W1,H,hd); caches (B,S,KV,hd); tails (B,K,W1,KV,hd);
    cache_pos: (B,S) absolute position per slot (-1 = empty, ring-aware);
    pos2d: (B,W1) query positions.  ``tail_mask``: optional static (W1, W1)
    bool tail visibility replacing the causal triangle, tree verification's
    ancestor mask (K == 1 there).  Returns (B,K,W1,H,hd) f32.
    Covers softcap and sliding-window ring caches, which K1 does not.
    """
    B, K, W1, H, hd = q.shape
    KV = k_cache.shape[2]
    G = H // KV
    qg = q.reshape(B, K, W1, KV, G, hd).float()
    kn, vn = k_tail.float(), v_tail.float()
    kc, vc = k_cache.float(), v_cache.float()
    scale = 1.0 / (hd ** 0.5)
    # context logits: shared cache read once per sequence
    lc = torch.einsum("bkwnGh,bsnh->bknGws", qg, kc) * scale
    if cfg.attn_logit_softcap:
        lc = cfg.attn_logit_softcap * torch.tanh(lc / cfg.attn_logit_softcap)
    valid_c = (cache_pos >= 0)[:, None, None, None, None, :]
    if cfg.sliding_window is not None:
        win = cfg.sliding_window
        in_win = cache_pos[:, None, :] > pos2d[:, :, None] - win
        valid_c = valid_c & in_win[:, None, None, None]
    lc = torch.where(valid_c, lc, NEG_INF)
    # local (per-row) logits: causal within the speculative tail
    ll = torch.einsum("bkwnGh,bkvnh->bknGwv", qg, kn) * scale
    if cfg.attn_logit_softcap:
        ll = cfg.attn_logit_softcap * torch.tanh(ll / cfg.attn_logit_softcap)
    local = (torch.tril(torch.ones((W1, W1), dtype=torch.bool,
                                   device=q.device))
             if tail_mask is None else tail_mask)
    ll = torch.where(local, ll, NEG_INF)
    # merged softmax without concatenating [lc | ll]
    m = torch.maximum(lc.amax(dim=-1), ll.amax(dim=-1))     # (b,k,n,G,w)
    e_c = torch.exp(lc - m[..., None])
    e_l = torch.exp(ll - m[..., None])
    denom = e_c.sum(dim=-1) + e_l.sum(dim=-1)
    out = (torch.einsum("bknGws,bsnh->bkwnGh", e_c, vc)
           + torch.einsum("bknGwv,bkvnh->bkwnGh", e_l, vn))
    out = out / torch.movedim(denom, -1, 2)[..., None]
    return out.reshape(B, K, W1, H, hd)


def attn_verify(params: Params, x: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor,
                k_cache: torch.Tensor, v_cache: torch.Tensor,
                cache_pos: torch.Tensor, cur_len: torch.Tensor,
                page_table: Optional[torch.Tensor] = None,
                tail_mask: Optional[TreeMask] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Bifurcated batched-speculation attention (the paper's verification).

    x: (B, k, w1, d) — k speculative rows per sequence.  Each row attends to
    the SHARED context cache (read once, not k times) plus its own
    (w1)-token tail, causally, with no cross-row attention.
    positions: (B, w1), identical for all k rows.  cur_len: (B,) int32
    committed cache length; cache_pos: (B, S) (``cache.key_positions``).
    On the card this runs K1, which raises for a config outside its
    contract (``dispatch.verify_kernel_supported``).
    page_table: (B, PPS) when the cache is PAGED: k_cache/v_cache are then
    the layer's shared pool (NP, ps, KV, hd).  On the card K3 walks the
    table; on the CPU the per-slot linear view is gathered first and the
    plain verify runs on it unchanged, with cache_pos over PPS*ps slots.
    tail_mask: optional static tail visibility of a token tree (the tree
    rides as the single row k == 1; ``core/tree.device_constants``):
    K4 on the card, the plain verify with its bool mask on the CPU.
    Returns (y (B,k,w1,d), k_new, v_new (B,k,w1,KV,hd)).
    """
    B, K, W1, d = x.shape
    hd = cfg.resolved_head_dim
    cd = cfg.compute_dtype
    KV = cfg.num_kv_heads
    freqs = rope_freqs(cfg, positions) if cfg.rope != "none" else None
    fr = None if freqs is None else freqs.repeat_interleave(K, dim=0)
    q, k_new, v_new = qkv_project(params, x.reshape(B * K, W1, d), cfg, fr)
    qk = q.reshape(B, K, W1, cfg.num_heads, hd)
    kn = k_new.reshape(B, K, W1, KV, hd)
    vn = v_new.reshape(B, K, W1, KV, hd)
    if dispatch.on_card(x):
        if not dispatch.verify_kernel_supported(cfg):
            raise ValueError(
                f"{cfg.name}: sliding-window or softcapped attention is "
                f"outside the verify kernel's contract")
        if page_table is not None:
            out = dispatch.verify_attention_paged(qk, k_cache, v_cache,
                                                  page_table, kn, vn,
                                                  cur_len, w1=W1,
                                                  tail_mask=tail_mask)
        else:
            out = dispatch.verify_attention(qk, k_cache, v_cache, kn, vn,
                                            cur_len, w1=W1,
                                            tail_mask=tail_mask)
    else:
        mask = None if tail_mask is None else tail_mask.mask
        if page_table is not None:
            k_cache, v_cache = gather_pages(k_cache, v_cache, page_table)
        out = _verify_attention_xla(qk, k_cache, v_cache, kn, vn, cache_pos,
                                    positions, cfg, tail_mask=mask)
    out = out.reshape(B, K, W1, cfg.num_heads * hd).to(cd)
    y = out @ params["wo"].to(cd)
    return y, kn, vn
