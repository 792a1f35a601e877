"""Attention: MHA / GQA / MQA with (partial) RoPE over a linear or paged KV
cache (port of ``repro/models/attention.py``).

Prefill and the full forward use ``masked_attention``, plain tensor ops (the
reference leaves it to XLA as well), blockwise with an online softmax from
``BLOCKWISE_THRESHOLD`` keys on.  Verify and decode use the bifurcated
attention of the paper's batched (k, w+1) verification.  Which path is
decided by the config alone, as the reference's ``_use_verify_kernel``
does (``dispatch.verify_kernel_supported``): inside K1's contract, on the
card through K1 (``kernels/dispatch.verify_attention``) or, over a paged
pool, K3 (``dispatch.verify_attention_paged``), and K4 for a token tree in
either layout, on the CPU through ``_verify_attention_xla``; outside it (a
sliding window or a logit softcap), through ``plain_verify`` on whatever
device the tensors are on, the counterpart of the reference's XLA verify
for those configs.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..distributed import act_sharding
from ..distributed import local as L
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


@functools.lru_cache(maxsize=None)
def _mrope_section_ids(cfg: ModelConfig, device: torch.device
                       ) -> torch.Tensor:
    """(rd/2,) int64: the position row (0 t, 1 h, 2 w) of each rotary
    half-dim, ``cfg.mrope_sections`` half-dims each and any remainder on
    w.  Built once per (config, device), so that a step copies nothing
    from the host."""
    half = len(range(0, cfg.rotary_dim, 2))
    ids = np.repeat(np.arange(3), cfg.mrope_sections)
    ids = np.concatenate([ids, np.full(max(half - ids.size, 0), 2)])[:half]
    return torch.as_tensor(ids, dtype=torch.int64, device=device)


def rope_freqs(cfg: ModelConfig, positions: torch.Tensor) -> torch.Tensor:
    """positions: (B, T) int, or (3, B, T) t/h/w rows for M-RoPE.  Returns
    (B, T, rd/2) f32.  M-RoPE gives rotary half-dim i the position row of
    its section (``cfg.mrope_sections`` half-dims for t, h, w in turn)."""
    inv = _rope_inv_freq(cfg, positions.device)
    if cfg.rope == MROPE:
        if positions.dim() != 3:
            raise ValueError("M-RoPE needs (3, B, T) positions")
        sec_id = _mrope_section_ids(cfg, positions.device)
        pos = positions.float()[sec_id]                # (rd/2, B, T)
        return torch.movedim(pos, 0, -1) * inv
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
# From this many keys on (in whole blocks), full attention runs blockwise
# with an online softmax, so that only one (B, KV, G, T, block) slab of
# logits is live at a time instead of the whole (B, KV, G, T, S) tensor
# (the reference's constants).
BLOCKWISE_THRESHOLD = 8192
BLOCKWISE_BLOCK = 1024


def _valid_keys(kp, q_pos, cfg: ModelConfig, causal: bool) -> torch.Tensor:
    """(B, 1, 1, T, S') visibility of keys at positions ``kp`` (B, S')."""
    valid = (kp >= 0)[:, None, None, None, :]
    if causal:
        valid = valid & (kp[:, None, :] <= q_pos[:, :, None])[:, None, None]
    if cfg.sliding_window is not None:
        win = cfg.sliding_window
        valid = valid & (kp[:, None, :]
                         > q_pos[:, :, None] - win)[:, None, None]
    return valid


def _blockwise_attention(q, k, v, q_pos, k_pos, cfg: ModelConfig,
                         causal: bool, block: int = BLOCKWISE_BLOCK
                         ) -> torch.Tensor:
    """Flash-style attention: a loop over key blocks with an online
    softmax.  Same contract as ``masked_attention`` (S a multiple of
    ``block``); the same softmax, up to float reassociation."""
    B, T, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    if S % block:
        raise ValueError(f"{S} keys are not a whole number of {block}-key "
                         f"blocks")
    qf = q.reshape(B, T, KV, G, hd).float()
    scale = 1.0 / (hd ** 0.5)
    m = torch.full((B, KV, G, T), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, KV, G, T), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, KV, G, T, hd), dtype=torch.float32,
                      device=q.device)
    for lo in range(0, S, block):
        k_c = k[:, lo:lo + block].float()
        v_c = v[:, lo:lo + block].float()
        logits = torch.einsum("btkgh,bskh->bkgts", qf, k_c) * scale
        if cfg.attn_logit_softcap:
            c = cfg.attn_logit_softcap
            logits = c * torch.tanh(logits / c)
        logits = torch.where(
            _valid_keys(k_pos[:, lo:lo + block], q_pos, cfg, causal),
            logits, NEG_INF)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        p = torch.exp(logits - m_new[..., None])
        del logits
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bkgts,bskh->bkgth", p,
                                                    v_c)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return torch.movedim(out, -2, 1).reshape(B, T, H, hd).to(q.dtype)


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     q_pos: torch.Tensor, k_pos: torch.Tensor,
                     cfg: ModelConfig, causal: bool) -> torch.Tensor:
    """q: (B,T,H,hd) k/v: (B,S,KV,hd); *_pos: (B,T)/(B,S) (-1 = invalid key).

    Returns (B, T, H, hd).  GQA via reshape to (KV, G) groups.  From
    ``BLOCKWISE_THRESHOLD`` keys on, in whole blocks, the blockwise path.
    """
    B, T, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    if S >= BLOCKWISE_THRESHOLD and S % BLOCKWISE_BLOCK == 0:
        return _blockwise_attention(q, k, v, q_pos, k_pos, cfg, causal)
    G = H // KV
    qf = q.reshape(B, T, KV, G, hd).float()
    logits = torch.einsum("btkgh,bskh->bkgts", qf, k.float()) / (hd ** 0.5)
    if cfg.attn_logit_softcap:
        c = cfg.attn_logit_softcap
        logits = c * torch.tanh(logits / c)
    logits = torch.where(_valid_keys(k_pos, q_pos, cfg, causal), logits,
                         NEG_INF)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgts,bskh->btkgh", w, v.float())
    return out.reshape(B, T, H, hd).to(q.dtype)


# ----------------------------------------------------------------------------
# layer application
# ----------------------------------------------------------------------------
def qkv_project(params: Params, x: torch.Tensor, cfg: ModelConfig,
                freqs: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(q, k, v) of a (B, T, d) block, split into heads and rotated.  Under
    a mesh (``x`` a DTensor, ``distributed/local.py``) the projections run
    on DTensors and come back as this rank's rows and kv heads (q's heads
    follow their kv heads: G q heads a kv head, contiguous) before the
    split and RoPE, which then run locally (``freqs`` local rows)."""
    hd = cfg.resolved_head_dim
    cd = cfg.compute_dtype
    x = x.to(cd)
    q, k, v = (x @ params[w].to(cd) for w in ("wq", "wk", "wv"))
    rows = L.current()
    if rows is not None:
        kv = {2: rows.cache.kv}
        q, k, v = (L.lower(t, 0, kv) for t in (q, k, v))
    q, k, v = (t.reshape(t.shape[0], t.shape[1], -1, hd) for t in (q, k, v))
    if cfg.rope != "none":
        q = apply_rope(q, freqs, cfg)
        k = apply_rope(k, freqs, cfg)
    return q, k, v


def out_project(params: Params, out: torch.Tensor, cfg: ModelConfig
                ) -> torch.Tensor:
    """The output projection of an attention output (N, T, H, hd); under
    a mesh, this rank's rows and kv heads are lifted to the global rows'
    DTensor first."""
    cd = cfg.compute_dtype
    N, T = out.shape[:2]
    o = out.reshape(N, T, -1).to(cd)
    rows = L.current()
    if rows is not None:
        o = L.lift(o, 0, {2: rows.cache.kv})
    return o @ params["wo"].to(cd)


def attn_full(params: Params, x: torch.Tensor, cfg: ModelConfig,
              positions: torch.Tensor,
              seq_mask: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Self-attention over a full block (prefill / forward).

    positions: (B, T), or (3, B, T) for M-RoPE.  seq_mask: (B, T) bool for
    padding.  Returns output and the (k, v) tensors for cache insertion.
    Under a mesh (``x`` a DTensor, ``distributed/local.py``) the positions
    and the returned k, v are this rank's local rows.
    """
    freqs = rope_freqs(cfg, positions) if cfg.rope != "none" else None
    q, k, v = qkv_project(params, x, cfg, freqs)
    pos2d = positions[0] if positions.dim() == 3 else positions
    k_pos = pos2d if seq_mask is None else torch.where(seq_mask, pos2d, -1)
    out = masked_attention(q, k, v, pos2d, k_pos, cfg, causal=cfg.causal)
    return out_project(params, out, cfg), (k, v)


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
    Covers softcap and sliding-window ring caches, which K1 does not
    (``plain_verify`` routes those configs here on any device).
    """
    B, K, W1, H, hd = q.shape
    KV = k_cache.shape[2]
    G = H // KV
    qg = q.reshape(B, K, W1, KV, G, hd).float()
    kn, vn = k_tail.float(), v_tail.float()
    kc, vc = k_cache.float(), v_cache.float()
    scale = 1.0 / (hd ** 0.5)
    # context logits: shared cache read once per sequence
    lc = act_sharding.constrain(
        torch.einsum("bkwnGh,bsnh->bknGws", qg, kc) * scale, "ctx_logits")
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
    out = act_sharding.constrain(out, "ctx_out")
    out = out / torch.movedim(denom, -1, 2)[..., None]
    return out.reshape(B, K, W1, H, hd)


def plain_verify(q, k_cache, v_cache, k_tail, v_tail, cache_pos, pos2d,
                 cfg: ModelConfig, tail_mask: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """The verify of a config outside K1's contract (a sliding window or a
    logit softcap), on the card as on the CPU: ``_verify_attention_xla``,
    which is what the reference runs for such a config
    (``_use_verify_kernel``), so it is the config's own main path and not
    a stand-in for a kernel.  ``plain_verify.calls`` counts its calls, as
    the kernels' wrappers count their launches."""
    plain_verify.calls += 1
    return _verify_attention_xla(q, k_cache, v_cache, k_tail, v_tail,
                                 cache_pos, pos2d, cfg, tail_mask=tail_mask)


plain_verify.calls = 0


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
    positions: (B, w1), or (3, B, w1) for M-RoPE, identical for all k
    rows.  cur_len: (B,) int32 committed cache length; cache_pos: (B, S)
    (``cache.key_positions``).  A config outside K1's contract
    (``dispatch.verify_kernel_supported``: a sliding window, whose cache
    may be a ring, or a logit softcap) runs ``plain_verify`` on any device;
    inside it a CUDA tensor runs K1, which raises on an operand it
    refuses.
    page_table: (B, PPS) when the cache is PAGED: k_cache/v_cache are then
    the layer's shared pool (NP, ps, KV, hd).  On the card a config inside
    the contract runs K3, which walks the table; otherwise the per-slot
    linear view is gathered first and the plain verify runs on it
    unchanged, with cache_pos over PPS*ps slots.  (Paged states refuse
    window configs, ``cache.paged_supported``; a softcap config may be
    paged.)
    tail_mask: optional static tail visibility of a token tree (the tree
    rides as the single row k == 1; ``core/tree.device_constants``):
    K4 on the card, the plain verify with its bool mask on the CPU.
    Returns (y (B,k,w1,d), k_new, v_new (B,k,w1,KV,hd)).

    Under a mesh (``x`` a DTensor) the positions, caches, cur_len and
    returned tails are this rank's local rows and kv heads; the cache shard
    a rank lacks is gathered for the read (a linear cache's sequence, a
    paged pool's pages), and the verify takes the same route on the local
    tensors.
    """
    B, K, W1, d = x.shape
    hd = cfg.resolved_head_dim
    freqs = rope_freqs(cfg, positions) if cfg.rope != "none" else None
    fr = None if freqs is None else freqs.repeat_interleave(K, dim=0)
    q, k_new, v_new = qkv_project(params, x.reshape(B * K, W1, d), cfg, fr)
    n = q.shape[0] // K             # this rank's rows under a mesh, else B
    qk, kn, vn = (t.reshape(n, K, W1, -1, hd) for t in (q, k_new, v_new))
    pos2d = positions[0] if positions.dim() == 3 else positions
    if L.current() is not None:
        k_cache, v_cache = _whole_cache(k_cache, v_cache, page_table)
    kernel = dispatch.verify_kernel_supported(cfg)
    if kernel and dispatch.on_card(qk):
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
        if page_table is not None:
            k_cache, v_cache = gather_pages(k_cache, v_cache, page_table)
        verify = _verify_attention_xla if kernel else plain_verify
        out = verify(qk, k_cache, v_cache, kn, vn, cache_pos, pos2d, cfg,
                     tail_mask=None if tail_mask is None else tail_mask.mask)
    y = out_project(params, out.reshape(n * K, W1, -1, hd), cfg)
    return y.reshape(B, K, W1, d), kn, vn


def _whole_cache(k_cache: torch.Tensor, v_cache: torch.Tensor,
                 page_table: Optional[torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Under a mesh, this rank's cache shards with what the read lacks
    gathered: a paged pool's pages (a slot's pages may sit on any shard),
    a linear cache's sequence; a no-op over axes of size 1."""
    c = L.current().cache
    if page_table is not None:
        return (L.gather(k_cache, 0, c.pages, size=c.pool_pages),
                L.gather(v_cache, 0, c.pages, size=c.pool_pages))
    return L.gather(k_cache, 1, c.seq), L.gather(v_cache, 1, c.seq)
