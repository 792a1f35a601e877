"""Model-derived N-gram tables (paper §4.1; port of
``repro/core/ngram_tables.py``).

  - *unigram*:  rank tokens by the distance of their output embedding from
    the mean output embedding under the input-embedding covariance metric.
  - *bigram*:   p_M(.|x) for every x — one batched forward sweep over the
    vocabulary, stored as a top-k index table (V, k_max).
  - *extended bigram*:  greedy argmax chains of the bigram (V, w_max).

Top-k breaks ties toward the lowest index, as ``jax.lax.top_k`` does
(``torch.topk`` does not promise an order among ties): ``_topk_indices`` is
a stable descending sort.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch


@dataclasses.dataclass
class NGramTables:
    """Static draft tables (int32 index tensors on the serving device)."""
    unigram_topk: torch.Tensor      # (k_max,) — global token ranking
    bigram_topk: torch.Tensor       # (V, k_max) — top-k of p_M(.|x)
    bigram_chain: torch.Tensor      # (V, w_max) — argmax chains

    @property
    def k_max(self) -> int:
        return self.bigram_topk.shape[-1]

    @property
    def w_max(self) -> int:
        return self.bigram_chain.shape[-1]


def _topk_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries along the last dim, largest first,
    ties to the lowest index (``jax.lax.top_k``'s order)."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]


UNIGRAM_CHUNK = 1 << 16        # tokens of the vocabulary read at a time


def build_unigram(embedding: torch.Tensor, lm_head: torch.Tensor,
                  k_max: int = 32, appendix_variant: bool = False,
                  device=None) -> torch.Tensor:
    """embedding: (V, d) input embeddings; lm_head: (d, V) output embeds.

    Returns the k_max tokens with the smallest d(x) (main-text formula), or
    the appendix's topk(-(mu Cov u_x)) when ``appendix_variant``.  The
    vocabulary is read ``UNIGRAM_CHUNK`` tokens at a time in f32, so that
    no f32 copy of a whole table is made (one of Nemotron-4's
    256000 x 18432 tables is 18.9 GB in f32).  ``device``: where the
    chunks are read into and the ranking computed (default: where the
    tables lie; tables on the host go to the card a chunk at a time).
    """
    dev = embedding.device if device is None else device
    V = embedding.shape[0]
    parts = [slice(i, i + UNIGRAM_CHUNK) for i in range(0, V, UNIGRAM_CHUNK)]
    cov = sum(e.T @ e for e in (embedding[c].to(dev).float()
                                for c in parts)) / V
    mu = sum(lm_head[:, c].to(dev).float().sum(dim=1, keepdim=True)
             for c in parts) / V                       # (d, 1)
    if appendix_variant:
        w = mu.T @ cov
        dists = torch.cat([(w @ lm_head[:, c].to(dev).float()).squeeze(0)
                           for c in parts])
        return _topk_indices(-dists, k_max).to(torch.int32)
    d2 = []
    for c in parts:
        diff = lm_head[:, c].to(dev).float() - mu
        d2.append(torch.einsum("dv,de,ev->v", diff, cov, diff))
    return _topk_indices(-torch.cat(d2), k_max).to(torch.int32)


def build_bigram(next_logits_fn: Callable[[torch.Tensor], torch.Tensor],
                 vocab_size: int, k_max: int = 32, w_max: int = 16,
                 batch: int = 256, device="cuda"
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sweep the vocabulary once to obtain p_M(.|x) for every token.

    next_logits_fn: (B, 1) int32 -> (B, V) f32 next-token logits.
    Returns (bigram_topk (V, k_max), bigram_chain (V, w_max)), int32.
    """
    topks = []
    for lo in range(0, vocab_size, batch):
        toks = torch.arange(lo, lo + batch, device=device).clamp(
            0, vocab_size - 1).to(torch.int32)
        logits = next_logits_fn(toks[:, None])
        topks.append(_topk_indices(logits, k_max).to(torch.int32))
    topk = torch.cat(topks, dim=0)[:vocab_size]
    return topk, chain_from_argmax(topk[:, 0], w_max)


def chain_from_argmax(argmax_next: torch.Tensor, w_max: int) -> torch.Tensor:
    """argmax_next: (V,) -> chain (V, w_max): chain[x, j] = argmax^(j+1)(x)."""
    cols = [argmax_next]
    for _ in range(w_max - 1):
        cols.append(argmax_next[cols[-1].long()])
    return torch.stack(cols, dim=1).to(torch.int32)
