"""Training data pipeline: tokenize -> pack -> batch (port of
``repro/data/pipeline.py``).

Deterministic, host-side (numpy) packing into fixed (B, T+1) int32 blocks,
bit-identical to the reference's; the train step slices inputs and labels
and moves the block to its device.  ``shard(index, num_shards)`` splits the
stream as a data-parallel shard would consume it.
"""
from __future__ import annotations

from typing import Iterator, List

import numpy as np

from .datasets import make_corpus
from .tokenizer import EOS_ID, ByteTokenizer


def token_stream(task: str, n_examples: int, seed: int = 0) -> np.ndarray:
    tok = ByteTokenizer()
    ids: List[int] = []
    for ex in make_corpus(task, n_examples, seed):
        ids.extend(tok.encode(ex, bos=True, eos=False))
        ids.append(EOS_ID)
    return np.asarray(ids, np.int32)


def packed_batches(task: str, batch: int, seq_len: int, steps: int,
                   seed: int = 0, shard: int = 0, num_shards: int = 1
                   ) -> Iterator[np.ndarray]:
    """Yields ``steps`` arrays of shape (batch, seq_len + 1) int32."""
    need = steps * batch * (seq_len + 1) * num_shards
    stream = token_stream(task, max(64, need // 40), seed)
    while stream.size < need:
        stream = np.concatenate([stream, token_stream(
            task, max(64, need // 40), seed + stream.size)])
    stream = stream[:need].reshape(num_shards, steps, batch, seq_len + 1)
    for i in range(steps):
        yield stream[shard, i]


def mixed_batches(batch: int, seq_len: int, steps: int, seed: int = 0
                  ) -> Iterator[np.ndarray]:
    """Equal-parts mixture of the three tasks (the quickstart train set)."""
    its = [packed_batches(t, batch, seq_len, steps, seed)
           for t in ("code", "math", "chat")]
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        parts = [next(it) for it in its]
        sel = rng.integers(0, 3, size=batch)
        yield np.stack([parts[sel[j]][j] for j in range(batch)])
