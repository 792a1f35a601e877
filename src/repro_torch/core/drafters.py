"""Draft strategies (paper §4): model-derived and context-derived N-grams
(port of ``repro/core/drafters.py``).

Every drafter maps the current decode state to a fixed-shape batch of k
drafts of w tokens: drafts (B, k, w) int32, valid (B, k) bool.  Invalid rows
are still verified (fixed shapes) but can never win more than the bonus
token.

The context N-gram runs in two stages:
  1. the match/hash sweep over every context position — K2 on the card,
     its plain version on the CPU (``kernels/dispatch.ngram_sweep``), the
     same integers either way;
  2. (count, recency) scoring + top-k, pure integer tensor math on the sweep
     output, bit-identical to the reference: a stable sort for its
     ``sort``/``argsort``, one composite integer key for its ``lexsort``,
     and a segment max (``scatter_reduce`` over equal-hash runs) for its two
     running-max scans.  Nothing here reads back to the host.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..kernels import dispatch
from ..kernels.hashing import MASK32
from .ngram_tables import NGramTables

SENTINEL = MASK32     # hash of non-matching positions (uint32 0xFFFFFFFF)


# ----------------------------------------------------------------------------
# model-derived drafters
# ----------------------------------------------------------------------------
def _check_table_size(tables: NGramTables, k: int, w: int) -> None:
    """The tables must hold k candidates and w-1 chain steps (the reference
    gathers out of range silently)."""
    if k > tables.k_max or w - 1 > tables.w_max:
        raise ValueError(f"drafting (k={k}, w={w}) needs tables with k_max "
                         f">= {k} and w_max >= {w - 1}, got "
                         f"({tables.k_max}, {tables.w_max})")


def unigram_draft(tables: NGramTables, batch: int, k: int, w: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k unigram tokens, extended with bigram argmax chains (w > 1)."""
    _check_table_size(tables, k, w)
    first = tables.unigram_topk[:k][None].expand(batch, k)
    drafts = _extend(tables, first, w)
    return drafts, torch.ones((batch, k), dtype=torch.bool,
                              device=first.device)


def bigram_draft(tables: NGramTables, last_token: torch.Tensor, k: int,
                 w: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Extended model bigram: row i = [topk_i(p(.|x)), argmax chain...].
    last_token: (B,)."""
    _check_table_size(tables, k, w)
    first = tables.bigram_topk[last_token.long()][:, :k]          # (B, k)
    drafts = _extend(tables, first, w)
    return drafts, torch.ones((first.shape[0], k), dtype=torch.bool,
                              device=first.device)


def _extend(tables: NGramTables, first: torch.Tensor, w: int) -> torch.Tensor:
    """first: (B, k) -> (B, k, w) via the precomputed argmax chain."""
    if w == 1:
        return first[..., None].to(torch.int32)
    tail = tables.bigram_chain[first.long()][..., :w - 1]         # (B,k,w-1)
    return torch.cat([first[..., None], tail], dim=-1).to(torch.int32)


# ----------------------------------------------------------------------------
# context-derived drafter
# ----------------------------------------------------------------------------
def _extract_queries(buf: torch.Tensor, cur_len: torch.Tensor,
                     q: int) -> torch.Tensor:
    """Last q committed tokens per row. buf: (B, L); cur_len: (B,) -> (B, q).
    The start clamps to [0, L-q], as the reference's dynamic_slice does."""
    L = buf.shape[1]
    start = (cur_len.long() - q).clamp(0, L - q)
    idx = start[:, None] + torch.arange(q, device=buf.device)[None, :]
    return buf.gather(1, idx)


def match_hash_sweep(buf: torch.Tensor, cur_len: torch.Tensor, q: int,
                     w: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stage 1: the sweep.  Returns (query (B,q), match (B,L) bool,
    hash (B,L) int64); rows whose cur_len < q get a garbage query but are
    invalidated by the scoring stage's ``cur_len >= q+1`` guard."""
    buf = buf.to(torch.int32)
    query = _extract_queries(buf, cur_len, q).contiguous()
    match, h = dispatch.ngram_sweep(buf, query,
                                    cur_len.to(torch.int32).contiguous(),
                                    w=w)
    return query, match.bool(), h


def _score_topk(bufp: torch.Tensor, match: torch.Tensor, h: torch.Tensor,
                cur_len: torch.Tensor, q: int, k: int, w: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stage 2: (count, recency) scoring + top-k, for every row at once
    (the reference's ``_score_topk_row``, vmapped).

    bufp: (B, L+q+w) int32 padded buffer; match: (B, L) bool; h: (B, L)
    int64 hashes; cur_len: (B,).  Returns (drafts (B, k, w), valid (B, k)).
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


def context_ngram_draft(buf: torch.Tensor, cur_len: torch.Tensor, q: int,
                        k: int, w: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """buf: (B, L); cur_len: (B,). Returns (drafts (B,k,w), valid (B,k))."""
    B = buf.shape[0]
    _, match, h = match_hash_sweep(buf, cur_len, q, w)
    pad = torch.full((B, q + w), -1, dtype=torch.int32, device=buf.device)
    bufp = torch.cat([buf.to(torch.int32), pad], dim=1)
    return _score_topk(bufp, match, h, cur_len, q, k, w)


# ----------------------------------------------------------------------------
# mixed strategy (paper §4.3)
# ----------------------------------------------------------------------------
def mixed_draft(tables: NGramTables, buf: torch.Tensor, cur_len: torch.Tensor,
                last_token: torch.Tensor, q: int, k: int, w: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Context N-gram matches first, extended model bigram fills the rest;
    bigram fill rows skip candidates that duplicate a context row in use
    (the reference's dedup, prefix-consistent in k).

    Returns (drafts (B,k,w), valid (B,k), n_context (B,) int32).
    """
    ctx_d, ctx_v = context_ngram_draft(buf, cur_len, q, k, w)
    big_d, _ = bigram_draft(tables, last_token, k, w)
    B = buf.shape[0]
    dev = buf.device
    # compact the valid context drafts to the front, bigram after
    order = torch.sort((~ctx_v).to(torch.int32), dim=1, stable=True).indices
    ctx_sorted = ctx_d.gather(1, order[..., None].expand(B, k, w))
    n_ctx = ctx_v.sum(dim=1)
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
