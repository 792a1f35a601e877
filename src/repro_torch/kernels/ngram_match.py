"""K2: a step's context-strategy drafts, CUDA for Hopper.

Replaces the TPU kernel ``repro/kernels/ngram_match.py:ngram_match_call``
(the match/hash sweep, vmapped over the batch by
``repro/kernels/ops.py:121``) together with the drafting the reference
leaves to XLA around it (``repro/core/drafters.py``: ``_extract_queries``,
``_score_topk_row``, ``mixed_draft``'s merge).  The kernel is
``csrc/ngram_match.cu``; this module holds its wrapper ``ngram_draft_cuda``
with its launch count, and its plain version ``ngram_draft_plain``.

Contract, for both: buf (B, L) int32 and buf_len (B,) int32 with the
query length q, k rows and depth w give (drafts (B, k, w) int32, valid
(B, k) bool, n_ctx (B,) int32), bit for bit what the reference's drafters
give:
  - context (no ``last``): the context n-gram rows, invalid rows zeroed;
  - mixed (``last`` (B,), ``bigram_topk`` (V, k_max), ``bigram_chain``
    (V, w_max)): the valid context rows, then the extended bigram rows of
    ``last`` that do not repeat one of them, then those that do; all valid.

What bounds it on the H100: bytes, the row read once (~11 KB at B=8,
L=332), which is far below one launch.  What the design does about it: the
whole function is one launch (the eager torch sequence it replaces ran
~90 device ops), and its work scales with the matched positions M, not
with L (see the source).  Hashes are the uint32 of ``hashing.py``; the
kernel gets its constants as launch arguments.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor

from . import build, ref
from .hashing import HASH_MIX, HASH_MULT, MASK32

SENTINEL = MASK32     # hash of non-matching positions (uint32 0xFFFFFFFF)
SMEM_KEYS = 16384     # sort keys a block holds in shared memory (128 KB)


# ----------------------------------------------------------------------------
# plain version: the reference's drafting, as eager torch ops
# ----------------------------------------------------------------------------
def ngram_match_plain(buf, query, cur_len, *, w: int):
    """The match/hash sweep alone: buf (B, L) int; query (B, q); cur_len
    (B,).  Returns (match (B, L) int32, hash (B, L) int64 holding the
    uint32)."""
    B = buf.shape[0]
    q = query.shape[1]
    pad = torch.full((B, q + w), -1, dtype=torch.int32, device=buf.device)
    bufp = torch.cat([buf.to(torch.int32), pad], dim=1)
    return ref.ngram_match_ref(bufp, query.to(torch.int32),
                               cur_len.to(torch.int32), w=w)


def _extract_queries(buf: torch.Tensor, cur_len: torch.Tensor,
                     q: int) -> torch.Tensor:
    """Last q committed tokens per row. buf: (B, L); cur_len: (B,) -> (B, q).
    The start clamps to [0, L-q], as the reference's dynamic_slice does."""
    L = buf.shape[1]
    start = (cur_len.long() - q).clamp(0, L - q)
    idx = start[:, None] + torch.arange(q, device=buf.device)[None, :]
    return buf.gather(1, idx)


def _score_topk(bufp: torch.Tensor, match: torch.Tensor, h: torch.Tensor,
                cur_len: torch.Tensor, q: int, k: int, w: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(count, recency) scoring + top-k for every row at once (the
    reference's ``_score_topk_row``, vmapped): a stable sort for its
    ``sort``/``argsort``, one composite integer key for its ``lexsort``, and
    a segment max (``scatter_reduce`` over equal-hash runs) for its two
    running-max scans.

    bufp: (B, L+q+w) int32 padded buffer; match: (B, L) bool; h: (B, L)
    int64 hashes; cur_len: (B,).  Returns (drafts (B, k, w), valid (B, k)),
    the rows past the valid ones as the reference leaves them.
    """
    B, L = match.shape
    dev = match.device
    idx = torch.arange(L, device=dev)
    match = match & (cur_len >= q + 1)[:, None]
    hm = torch.where(match, h, SENTINEL)
    # equal-hash runs of the stably sorted hashes are the buckets
    hs, order = torch.sort(hm, dim=1, stable=True)
    new_run = torch.ones_like(hs, dtype=torch.bool)
    new_run[:, 1:] = hs[:, 1:] != hs[:, :-1]
    seg = (torch.cumsum(new_run, dim=1) - 1
           + torch.arange(B, device=dev)[:, None] * L).reshape(-1)
    # occurrences of each position's continuation (its bucket's size)
    size = torch.zeros(B * L, dtype=torch.int64, device=dev).scatter_add_(
        0, seg, torch.ones_like(seg))
    # dedup: a position represents its bucket iff it is the bucket's latest
    # matching position (recency also breaks count ties, per the paper)
    i_sorted = torch.where(match, idx, -1).gather(1, order).reshape(-1)
    bmax = torch.full((B * L,), -1, dtype=torch.int64,
                      device=dev).scatter_reduce_(0, seg, i_sorted, "amax")
    counts = torch.empty_like(hm).scatter_(1, order, size[seg].view(B, L))
    bucket_max = torch.empty_like(hm).scatter_(1, order,
                                               bmax[seg].view(B, L))
    is_rep = match & (idx == bucket_max)
    # top-k by (count, recency): the reference's lexsort((idx, cnt_key))
    # as one composite key, unique per position, largest first
    cnt_key = torch.where(is_rep, counts, -1)
    top_idx = torch.topk((cnt_key + 1) * L + idx, k, dim=1).indices
    gather_at = (top_idx[:, :, None] + q
                 + torch.arange(w, device=dev)[None, None, :])
    drafts = bufp.gather(1, gather_at.reshape(B, k * w)).view(B, k, w)
    valid = cnt_key.gather(1, top_idx) >= 0
    return drafts.to(torch.int32), valid


def _context_rows(buf, buf_len, *, q: int, k: int, w: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``context_ngram_draft``: (drafts (B, k, w), valid
    (B, k)), rows past the valid ones not zeroed."""
    buf = buf.to(torch.int32)
    query = _extract_queries(buf, buf_len, q).contiguous()
    match, h = ngram_match_plain(buf, query, buf_len, w=w)
    pad = torch.full((buf.shape[0], q + w), -1, dtype=torch.int32,
                     device=buf.device)
    return _score_topk(torch.cat([buf, pad], dim=1), match.bool(), h,
                       buf_len, q, k, w)


def ngram_draft_plain(buf, buf_len, *, q: int, k: int, w: int,
                      last=None, bigram_topk=None, bigram_chain=None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K2 (the module's contract)."""
    ctx_d, ctx_v = _context_rows(buf, buf_len, q=q, k=k, w=w)
    n_ctx = ctx_v.sum(dim=1)
    if last is None:
        return (torch.where(ctx_v[..., None], ctx_d, 0), ctx_v,
                n_ctx.to(torch.int32))
    B = buf.shape[0]
    dev = buf.device
    first = bigram_topk[last.long()][:, :k]                       # (B, k)
    big_d = first[..., None]
    if w > 1:
        tail = bigram_chain[first.long()][..., :w - 1]            # (B,k,w-1)
        big_d = torch.cat([big_d, tail], dim=-1)
    big_d = big_d.to(torch.int32)
    # compact the valid context drafts to the front, bigram after
    order = torch.sort((~ctx_v).to(torch.int32), dim=1, stable=True).indices
    ctx_sorted = ctx_d.gather(1, order[..., None].expand(B, k, w))
    row = torch.arange(k, device=dev)[None, :]
    use_ctx = row < n_ctx[:, None]
    # dup[b, j]: bigram candidate j token-identical to a context row in use
    dup = (big_d[:, :, None, :] == ctx_sorted[:, None, :, :]).all(dim=-1)
    dup = (dup & use_ctx[:, None, :]).any(dim=-1)
    seq = torch.sort(dup.to(torch.int32), dim=1, stable=True).indices
    big_pos = (row - n_ctx[:, None]).clamp(0, k - 1)
    big_idx = seq.gather(1, big_pos)
    big_fill = big_d.gather(1, big_idx[..., None].expand(B, k, w))
    drafts = torch.where(use_ctx[..., None], ctx_sorted, big_fill)
    valid = torch.ones((B, k), dtype=torch.bool, device=dev)
    return drafts, valid, n_ctx.to(torch.int32)


# ----------------------------------------------------------------------------
# the kernel
# ----------------------------------------------------------------------------
def _lib() -> ctypes.CDLL:
    lib = build.load("ngram_match")
    fn = lib.ngram_draft_launch
    if fn.argtypes is None:
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [p, ll, p, p, p, ll, p, ll, p, p, p, p, ll,
                       i, i, i, i, i, i, i, ctypes.c_uint, ctypes.c_uint, p]
        fn.restype = ctypes.c_int
    return lib


def _launch_shape(L: int) -> Tuple[int, int]:
    """(keys the block sorts in shared memory, threads a block) for rows of
    length L: the keys cover every position up to ``SMEM_KEYS``, past that
    the wrapper adds global scratch; a thread for every ~8 positions."""
    p = 1 << max(0, L - 1).bit_length()                # next power of two
    threads = min(1024, max(128, 1 << max(0, -(-L // 8) - 1).bit_length()))
    return min(p, SMEM_KEYS), threads


def ngram_draft_cuda(buf, buf_len, *, q: int, k: int, w: int,
                     last: Optional[torch.Tensor] = None,
                     bigram_topk: Optional[torch.Tensor] = None,
                     bigram_chain: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch K2 (the module's contract): buf (B, L) int32 with a contiguous
    last dim, buf_len (B,) int32; for the mixed strategy also last (B,)
    int32 (tokens < V) and the int32 tables, each with a contiguous last
    dim; all on one CUDA device.  Raises on anything the kernel does not
    take and on a failed launch."""
    B, L = buf.shape
    mixed = last is not None
    ops = (buf, buf_len) + ((last, bigram_topk, bigram_chain) if mixed
                            else ())
    if any(not t.is_cuda or t.device != buf.device for t in ops):
        raise ValueError("ngram_draft_cuda needs every operand on one CUDA "
                         "device")
    if any(t.dtype != torch.int32 for t in ops):
        raise TypeError("ngram_draft_cuda takes int32 operands")
    if buf_len.shape != (B,) or min(q, k, w) < 1 or q > L or k > L:
        raise ValueError(f"shapes buf {tuple(buf.shape)} buf_len "
                         f"{tuple(buf_len.shape)} q {q} k {k} w {w}")
    if buf.stride(1) != 1 or not buf_len.is_contiguous():
        raise ValueError("buf needs a contiguous last dim; buf_len must be "
                         "contiguous")
    if mixed and (last.shape != (B,) or not last.is_contiguous()
                  or bigram_topk.shape[1] < k
                  or bigram_chain.shape[1] < w - 1
                  or bigram_topk.stride(1) != 1
                  or bigram_chain.stride(1) != 1):
        raise ValueError(f"mixed drafting (k={k}, w={w}) needs last (B,) "
                         f"contiguous and tables (V, >= k), (V, >= w-1) "
                         f"with contiguous rows, got {tuple(last.shape)}, "
                         f"{tuple(bigram_topk.shape)}, "
                         f"{tuple(bigram_chain.shape)}")
    dev = buf.device
    drafts = torch.empty((B, k, w), dtype=torch.int32, device=dev)
    valid = torch.empty((B, k), dtype=torch.bool, device=dev)
    n_ctx = torch.empty((B,), dtype=torch.int32, device=dev)
    if B == 0:
        return drafts, valid, n_ctx
    if isinstance(drafts, FakeTensor):
        raise NotImplementedError(
            "K2 has no shape function: the dry-run's cases run no drafting")
    smem_keys, threads = _launch_shape(L)
    p = 1 << max(0, L - 1).bit_length()
    scratch = (torch.empty((B, p), dtype=torch.int64, device=dev)
               if p > smem_keys else None)
    rc = _lib().ngram_draft_launch(
        buf.data_ptr(), buf.stride(0), buf_len.data_ptr(),
        last.data_ptr() if mixed else None,
        bigram_topk.data_ptr() if mixed else None,
        bigram_topk.stride(0) if mixed else 0,
        bigram_chain.data_ptr() if mixed else None,
        bigram_chain.stride(0) if mixed else 0,
        drafts.data_ptr(), valid.data_ptr(), n_ctx.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        0 if scratch is None else scratch.stride(0),
        B, L, q, k, w, smem_keys, threads, HASH_MULT, HASH_MIX,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ngram_draft kernel launch failed: CUDA error "
                           f"{rc}")
    ngram_draft_cuda.launches += 1
    return drafts, valid, n_ctx


ngram_draft_cuda.launches = 0
