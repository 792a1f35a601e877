"""Acceptance for batched speculation, greedy and sampled (paper §4.1; port
of ``repro/core/verify.py``).

Row i accepts n_i = the longest prefix of its draft matching the model's
own predictions; the winner is the row with the largest n_i (ties -> lowest
row index, which under the mixed strategy prioritises the context N-gram).
The winner always also emits one *bonus* token, so every call commits
n* + 1 >= 1 tokens.  Under greedy decoding the predictions are the argmax
and the output equals plain greedy decoding.

Lossless sampled verification (the reference's DESIGN.md §12): n-gram
drafts are deterministic, so the speculative-sampling proposal is a point
mass, and "accept x with prob min(1, p(x)/q(x)), else draw from the
residual (p - q)+" becomes "accept x with prob p(x), else draw from p with
x zeroed" (``residual_pmf``).  ``sample_predictions`` realises it by
trajectory coupling: ONE target sample per (slot, level), by the
gumbel-max trick over the temperature/top-p-shaped logits with noise
keyed by (slot step key, level) and shared by every row (or tree node) at
that level.  Rows alive at a level share their prefix, hence their logits
and their sample, so each slot has one sampled trajectory; the
longest-prefix walk commits its drafted prefix and the bonus is its first
divergent token, a draw from the residual.  Rows with temperature <= 0 take
the argmax of the raw logits, bit for bit.  The noise is
``core/prng.py``'s threefry, the reference's own key schedule, so the port
draws the reference's tokens.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from . import prng


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


# ---------------------------------------------------------------------------
# sampled verification
# ---------------------------------------------------------------------------
def _bcast_over(v, like: torch.Tensor) -> torch.Tensor:
    """A scalar or (B,) control as f32 aligned to the LEADING dims of
    ``like`` (trailing singleton axes added)."""
    v = torch.as_tensor(v, dtype=torch.float32, device=like.device)
    return v.reshape(v.shape + (1,) * (like.dim() - v.dim()))


def shape_logits(logits: torch.Tensor,
                 temperature: Union[float, torch.Tensor],
                 top_p: Union[float, torch.Tensor, None] = None
                 ) -> torch.Tensor:
    """Raw logits (..., V) -> the target sampling distribution's logits
    (f32), the one shaping function of every sampling site.

    Upcasts to f32 BEFORE the temperature division (half-precision logits
    over a small t overflow), then nucleus truncation: keep the smallest
    prefix of descending-probability tokens whose mass reaches ``top_p``,
    -inf the rest; the top-1 token is always kept and ``top_p >= 1`` is a
    no-op.  Temperatures <= 0 divide by 1 only to stay finite: callers send
    those rows to the argmax, never through this distribution.
    """
    lf = logits.float()
    t = _bcast_over(temperature, lf)
    scaled = lf / torch.where(t > 0, t, 1.0)
    if top_p is None:
        return scaled
    p = _bcast_over(top_p, lf)
    probs = torch.softmax(scaled, dim=-1)
    srt = torch.sort(probs, dim=-1, descending=True).values
    excl = torch.cumsum(srt, dim=-1) - srt        # mass strictly above rank
    kept = excl < p                                # always keeps rank 0
    thresh = torch.where(kept, srt, torch.inf).amin(dim=-1, keepdim=True)
    keep = (probs >= thresh) | (p >= 1.0)
    return torch.where(keep, scaled, -torch.inf)


def residual_pmf(probs: torch.Tensor, rejected: torch.Tensor
                 ) -> torch.Tensor:
    """The renormalised residual after a point-mass rejection: ``probs``
    (..., V) with token ``rejected`` (...,) zeroed, i.e. p conditioned on
    t != x.  Callers guarantee probs[rejected] < 1."""
    p = probs.float()
    hit = torch.nn.functional.one_hot(rejected.long(), p.shape[-1]).to(p)
    z = p * (1.0 - hit)
    return z / z.sum(dim=-1, keepdim=True)


def per_row_keys(rng, batch: int) -> torch.Tensor:
    """One key (2,) -> per-row keys (B, 2) by ``fold_in(rng, row)``;
    (B, 2) keys pass through.  Keys as ``prng.as_key`` reads them."""
    rng = prng.as_key(rng)
    if rng.dim() == 1:
        return prng.fold_in(rng, torch.arange(batch, device=rng.device))
    return rng


def sample_predictions(logits: torch.Tensor, rng: torch.Tensor,
                       temperature: torch.Tensor, top_p: torch.Tensor,
                       levels: Union[np.ndarray, torch.Tensor, None] = None,
                       n_levels: Optional[int] = None) -> torch.Tensor:
    """Per-position target predictions for sampled verification.

    logits (B, K, W1, V) verify logits; rng (B, 2) per-slot step keys;
    temperature and top_p (B,) f32.  Returns (B, K, W1) int32 predictions
    that go into ``accept`` where the argmax predictions go.

    The gumbel noise is keyed per (slot, LEVEL): ``levels`` maps each of
    the W1 positions to its depth (linear rows: arange(W1); a tree: the
    topology's ``pos_off``, so same-level nodes share noise), level l's
    noise is ``gumbel(fold_in(rng[b], l), (V,))``.  ``n_levels`` (the
    number of levels to draw) is read from ``levels`` when not given; pass
    it with a device tensor of levels so that nothing is read back.  Rows
    with temperature <= 0 return the argmax of the raw logits bit for bit.
    """
    B, K, W1, V = logits.shape
    dev = logits.device
    if levels is None:
        lv, n_levels = torch.arange(W1, device=dev), W1
    else:
        if n_levels is None:
            # repro-lint: allow(tensor-branch): host levels; the step passes n_levels
            n_levels = int(np.asarray(levels).max()) + 1
        lv = torch.as_tensor(levels, device=dev).long()
    pred_greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    shaped = shape_logits(logits, temperature, top_p)
    keys = prng.fold_in(rng[:, None, :].to(dev),
                        torch.arange(n_levels, device=dev)[None, :])
    g = prng.gumbel(keys, (V,))[:, lv]                       # (B, W1, V)
    sampled = torch.argmax(shaped + g[:, None], dim=-1).to(torch.int32)
    return torch.where((temperature > 0)[:, None, None], sampled,
                       pred_greedy)


def sample_token(logits: torch.Tensor, rng: torch.Tensor,
                 temperature: torch.Tensor, top_p: torch.Tensor
                 ) -> torch.Tensor:
    """One next token per row, (B, V) logits -> (B,) int32: the
    single-position case of ``sample_predictions`` (level 0), used for the
    plain decode body, the prefill's first token and admissions.  Rows with
    temperature <= 0 take the argmax bit for bit."""
    dev = logits.device
    return sample_predictions(
        logits[:, None, None, :], rng,
        torch.as_tensor(temperature, dtype=torch.float32, device=dev),
        torch.as_tensor(top_p, dtype=torch.float32, device=dev))[:, 0, 0]
