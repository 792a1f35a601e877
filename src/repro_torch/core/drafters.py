"""Draft strategies (paper §4): model-derived and context-derived N-grams
(port of ``repro/core/drafters.py``).

Every drafter maps the current decode state to a fixed-shape batch of k
drafts of w tokens: drafts (B, k, w) int32, valid (B, k) bool.  Invalid rows
are still verified (fixed shapes) but can never win more than the bonus
token.

The context N-gram and the mixed strategy are one call of
``kernels/dispatch.ngram_draft``: K2 on the card (sweep, scoring, top-k and
the mixed fill in one launch), its plain version on the CPU
(``kernels/ngram_match.py``), the same integers either way, bit-identical
to the reference's drafters.  Nothing here reads back to the host.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from ..kernels import dispatch
from .ngram_tables import NGramTables


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
# context-derived drafter and the mixed strategy (paper §4.2, §4.3)
# ----------------------------------------------------------------------------
def context_ngram_draft(buf: torch.Tensor, cur_len: torch.Tensor, q: int,
                        k: int, w: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """buf: (B, L); cur_len: (B,). Returns (drafts (B,k,w), valid (B,k)),
    the rows past the valid ones zeroed."""
    d, v, _ = dispatch.ngram_draft(buf.to(torch.int32),
                                   cur_len.to(torch.int32), q=q, k=k, w=w)
    return d, v


def mixed_draft(tables: NGramTables, buf: torch.Tensor, cur_len: torch.Tensor,
                last_token: torch.Tensor, q: int, k: int, w: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Context N-gram matches first, extended model bigram fills the rest;
    bigram fill rows skip candidates that duplicate a context row in use
    (the reference's dedup, prefix-consistent in k).

    Returns (drafts (B,k,w), valid (B,k), n_context (B,) int32).
    """
    _check_table_size(tables, k, w)
    return dispatch.ngram_draft(
        buf.to(torch.int32), cur_len.to(torch.int32), q=q, k=k, w=w,
        last=last_token.to(torch.int32).contiguous(),
        bigram_topk=tables.bigram_topk, bigram_chain=tables.bigram_chain)


# ----------------------------------------------------------------------------
# multi-depth drafting (adaptive arm masking)
# ----------------------------------------------------------------------------
def multi_depth_draft(draft_fn: Callable, ws: Tuple[int, ...], w_max: int,
                      widx: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Draft at every distinct masked depth and select per slot.

    ``draft_fn(w) -> (drafts (B, k, w), valid (B, k), n_ctx (B,))`` runs
    once per depth in ``ws`` (the arm table's, so a step's drafting calls
    are fixed by the table, whatever the slots pick).  Each result is
    zero-padded to ``w_max`` and slot b takes the drafts of depth
    ``ws[widx[b]]``.

    Depth matters beyond truncation only for the context N-gram: its
    continuation hash and match guard are functions of w, so a depth-w_b
    draft inside a (k_max, w_max) step must come from a genuine depth-w_b
    sweep to equal a dedicated (k, w_b) run.  The model-derived drafters
    are prefix-consistent in w, but go through here too, so that every
    strategy shares one parity story.  Tokens past a slot's depth are
    zeros; acceptance never takes them (``verify.accept`` gates on w_eff).
    """
    ds, vs, ns = [], [], []
    for w in ws:
        d, v, n = draft_fn(w)
        ds.append(torch.nn.functional.pad(d, (0, w_max - w)))
        vs.append(v)
        ns.append(n)
    if len(ws) == 1:                       # one depth: nothing to select
        return ds[0], vs[0], ns[0]
    B = widx.shape[0]
    sel = widx.long()
    b_idx = torch.arange(B, device=sel.device)
    return (torch.stack(ds, dim=1)[b_idx, sel],
            torch.stack(vs, dim=1)[b_idx, sel],
            torch.stack(ns, dim=1)[b_idx, sel])
