"""Kernel dispatch: the ONE place that picks a kernel or its plain version.

The choice follows the tensor: an operand on the CPU takes the kernel's
plain PyTorch version, an operand on a CUDA device takes the CUDA kernel,
and anything else raises.  There is no backend knob and no fallback: a CUDA
tensor the kernel refuses raises from the kernel's wrapper.

Under a mesh (``distributed/local.py``) the model hands every kernel this
rank's local tensors, so the choice follows them there too: a meshed step
on the card launches the same kernels as an unmeshed one.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .mamba_scan import (mamba_scan_cuda, mamba_scan_plain,
                         mamba_scan_train)
from .ngram_match import (ngram_draft_cuda, ngram_draft_plain,
                          ngram_match_plain)
from .spec_attention import (TreeMask, paged_spec_attention_cuda,
                             paged_spec_attention_plain, spec_attention_cuda,
                             spec_attention_plain)


def on_card(t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel path for device {t.device}")


def verify_kernel_supported(cfg) -> bool:
    """Configs inside K1's contract (counterpart of the reference's
    ``pallas_verify_supported``): a linear cache and no logit softcap.
    Sliding-window ring caches and softcapped logits are outside it."""
    return cfg.attn_logit_softcap is None and cfg.sliding_window is None


def verify_attention(q, k_cache, v_cache, k_tail, v_tail, cur_len, *,
                     w1: int, tail_mask: Optional[TreeMask] = None
                     ) -> torch.Tensor:
    """Bifurcated verify attention in the engine layout.

    q: (B, K, W1, H, hd); caches (B, S, KV, hd); tails (B, K, W1, KV, hd);
    cur_len (B,) int32.  ``tail_mask``: optional static (K*W1, K*W1) tail
    visibility replacing the per-row causal one, tree verification's
    ancestor mask (K == 1 there): K4 on the card reads its ancestor table,
    the plain version its bool mask.  Returns (B, K, W1, H, hd) in q's
    dtype.
    """
    if on_card(q):
        return spec_attention_cuda(
            q, k_cache, v_cache, k_tail, v_tail, cur_len, w1=w1,
            anc=None if tail_mask is None else tail_mask.anc)
    return spec_attention_plain(
        q, k_cache, v_cache, k_tail, v_tail, cur_len, w1=w1,
        tail_mask=None if tail_mask is None else tail_mask.mask)


def verify_attention_paged(q, k_pool, v_pool, page_table, k_tail, v_tail,
                           cur_len, *, w1: int,
                           tail_mask: Optional[TreeMask] = None
                           ) -> torch.Tensor:
    """Bifurcated verify attention over a paged KV pool.

    q: (B, K, W1, H, hd); pools (NP, ps, KV, hd); page_table (B, PPS) int32
    (-1 = unallocated); tails (B, K, W1, KV, hd); cur_len (B,) int32;
    ``tail_mask`` as in ``verify_attention``.  Returns (B, K, W1, H, hd) in
    q's dtype: K3 (K4 given a tree) on the card, on the CPU its plain
    version (the gathered linear view through K1's plain version).
    """
    if on_card(q):
        return paged_spec_attention_cuda(
            q, k_pool, v_pool, page_table, k_tail, v_tail, cur_len, w1=w1,
            anc=None if tail_mask is None else tail_mask.anc)
    return paged_spec_attention_plain(
        q, k_pool, v_pool, page_table, k_tail, v_tail, cur_len, w1=w1,
        tail_mask=None if tail_mask is None else tail_mask.mask)


def ngram_sweep(buf: torch.Tensor, query: torch.Tensor,
                cur_len: torch.Tensor, *, w: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Match/hash sweep over every context position, on the CPU.

    buf: (B, L) int32; query: (B, q) int32; cur_len: (B,) int32.
    Returns (match (B, L) int32, hash (B, L) int64 in [0, 2**32)) where
      match[b, i] = all(buf[b, i:i+q] == query[b]) and i + q + w <= cur_len
      hash[b, i]  = hashing.hash_rows(buf[b, i+q : i+q+w])  (-1 past L).
    The card has no kernel for the sweep alone: K2 drafts in one launch
    (``ngram_draft``), so a CUDA tensor raises.
    """
    if on_card(buf):
        raise ValueError("the sweep alone has no CUDA kernel; the card "
                         "drafts through ngram_draft (K2)")
    return ngram_match_plain(buf, query, cur_len, w=w)


def ngram_draft(buf: torch.Tensor, buf_len: torch.Tensor, *, q: int, k: int,
                w: int, last: Optional[torch.Tensor] = None,
                bigram_topk: Optional[torch.Tensor] = None,
                bigram_chain: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A step's context-strategy drafts (K2 on the card, its plain version
    on the CPU): buf (B, L) int32, buf_len (B,) int32 -> (drafts (B, k, w)
    int32, valid (B, k) bool, n_ctx (B,) int32), the context strategy's
    rows; given ``last`` (B,) and the bigram tables, the mixed strategy's
    (``kernels/ngram_match.py`` states the contract).  Bit-identical
    either way."""
    fn = ngram_draft_cuda if on_card(buf) else ngram_draft_plain
    return fn(buf, buf_len, q=q, k=k, w=w, last=last,
              bigram_topk=bigram_topk, bigram_chain=bigram_chain)


def unique_sweep_widths(arms) -> Tuple[int, ...]:
    """Distinct positive speculation depths of an arm table, sorted.

    The adaptive step drafts once per depth returned here (one K2 launch
    each on the card), because the context sweep's continuation hash is a
    function of w.  The set of launches one adaptive step makes is fixed by
    the arm TABLE, never by the arms the slots pick at run time; w == 0
    arms (plain greedy) need no sweep and contribute nothing.
    """
    return tuple(sorted({w for _, w in arms if w > 0}))


def selective_scan(u, dt, A, B, C, D, h0, *, h0_rep: int = 1,
                   final: bool = True, steps: bool = False, n_commit=None):
    """The Mamba selective scan (K5 on the card, its plain version on the
    CPU).

    u: (Bt, T, di) f32 or bf16 (upcast to f32); dt: (Bt, T, di) f32; A:
    (di, ds); B/C: (Bt, T, ds); D: (di,); h0: (Bt // h0_rep, di, ds) f32,
    row b starting from h0 row b // h0_rep.  Returns (y (Bt, T, di), the
    final state (Bt, di, ds) or None unless ``final``, the state after
    every step (Bt, T, di, ds) or None unless ``steps``), all f32.  Given
    ``n_commit`` (Bt,) int32, the final state is the one after
    ``n_commit[b]`` steps (row b's h0 where it is 0): the replay's commit.
    ``steps`` is the plain version's alone: K5 raises on it.

    A call that autograd differentiates (grad enabled and an input that
    requires grad: the training forward) runs on the card through
    ``mamba_scan_train``, K5 with K5's backward kernel as its gradient;
    its contract is the training call's (h0_rep 1, no ``n_commit``, no
    ``steps``), and any other differentiated call raises.  On the CPU
    autograd differentiates the plain version.
    """
    if on_card(u):
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (u, dt, A, B, C, D, h0)):
            if h0_rep != 1 or n_commit is not None or steps:
                raise ValueError(
                    "K5's backward takes the training call alone (h0_rep 1, "
                    "no n_commit, no per-step states); run serving modes "
                    "under torch.no_grad()")
            return mamba_scan_train(u, dt, A, B, C, D, h0, final=final)
        fn = mamba_scan_cuda
    else:
        fn = mamba_scan_plain
    return fn(u, dt, A, B, C, D, h0, h0_rep=h0_rep, final=final, steps=steps,
              n_commit=n_commit)
