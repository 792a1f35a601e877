"""Greedy acceptance for batched speculation (paper §4.1; port of the greedy
half of ``repro/core/verify.py``).

Row i accepts n_i = the longest prefix of its draft matching the model's
own argmax predictions; the winner is the row with the largest n_i (ties
-> lowest row index, which under the mixed strategy prioritises the context
N-gram).  The winner always also emits one *bonus* token, so every call
commits n* + 1 >= 1 tokens and the output equals plain greedy decoding.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch


class Acceptance(NamedTuple):
    tokens: torch.Tensor    # (B, w+1) committed tokens (zero past n_commit)
    n_commit: torch.Tensor  # (B,) = n* + 1
    winner: torch.Tensor    # (B,) winning row index
    n_acc: torch.Tensor     # (B, k) per-row accepted-draft lengths (stats)


def masked_acceptance(eq: torch.Tensor,
                      k_eff: Optional[torch.Tensor] = None,
                      w_eff: Optional[torch.Tensor] = None,
                      row_mask: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row ranking scores from a (B, k, w) match matrix.

    Returns (n_acc, n_rank), both (B, k) int32: n_acc is each row's longest
    matching prefix (cut at the slot's depth ``w_eff``); n_rank is n_acc
    with rows outside the slot's arm (``i >= k_eff[b]`` or not
    ``row_mask[b, i]``) forced to -1 so that they can never win.
    """
    B, k, w = eq.shape
    dev = eq.device
    if w_eff is not None:
        eq = eq & (torch.arange(w, device=dev)[None, None, :]
                   < w_eff[:, None, None])
    n_acc = torch.cumprod(eq.to(torch.int32), dim=-1).sum(dim=-1,
                                                          dtype=torch.int32)
    eligible = torch.ones((B, k), dtype=torch.bool, device=dev)
    if k_eff is not None:
        eligible = eligible & (torch.arange(k, device=dev)[None, :]
                               < k_eff[:, None])
    if row_mask is not None:
        eligible = eligible & row_mask
    n_rank = torch.where(eligible, n_acc, -1)
    return n_acc, n_rank


def accept(drafts: torch.Tensor, greedy: torch.Tensor,
           k_eff: Optional[torch.Tensor] = None,
           w_eff: Optional[torch.Tensor] = None,
           row_mask: Optional[torch.Tensor] = None) -> Acceptance:
    """drafts: (B, k, w) int32; greedy: (B, k, w+1) int32 argmax predictions.
    ``k_eff``/``w_eff``/``row_mask`` optionally mask slots down to an arm
    (see ``masked_acceptance``)."""
    B, k, w = drafts.shape
    dev = drafts.device
    eq = drafts == greedy[..., :w]
    n_acc, n_rank = masked_acceptance(eq, k_eff=k_eff, w_eff=w_eff,
                                      row_mask=row_mask)
    winner = torch.argmax(n_rank, dim=-1)                    # first max
    n_win = n_acc.gather(1, winner[:, None])[:, 0]
    d_win = drafts.gather(1, winner[:, None, None].expand(B, 1, w))[:, 0]
    g_win = greedy.gather(1, winner[:, None, None].expand(B, 1, w + 1))[:, 0]
    pos = torch.arange(w + 1, device=dev)[None, :]
    bonus = g_win.gather(1, n_win[:, None].long())
    d_pad = torch.cat([d_win, torch.zeros((B, 1), dtype=d_win.dtype,
                                          device=dev)], dim=1)
    tokens = torch.where(pos < n_win[:, None], d_pad,
                         torch.where(pos == n_win[:, None], bonus, 0))
    return Acceptance(tokens=tokens.to(torch.int32),
                      n_commit=(n_win + 1).to(torch.int32),
                      winner=winner.to(torch.int32), n_acc=n_acc)
