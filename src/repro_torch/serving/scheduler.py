"""Request scheduling: queueing, length-bucketing, batch formation, and the
slot map for continuous batching.

The engine's jitted generation requires a bounded set of prompt lengths (one
prefill shape per bucket keeps recompilation bounded); the scheduler pads
prompts up to the bucket boundary.  Static batching groups whole batches by
(bucket, max_new_tokens); continuous batching instead pops requests FIFO one
at a time (``pop_next``) and tracks which DecodeState slot each in-flight
request occupies (``SlotMap``), so rows can be admitted and retired between
verify calls.
"""
from __future__ import annotations

import dataclasses
import itertools
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..data.tokenizer import ByteTokenizer

_counter = itertools.count()


@dataclasses.dataclass
class Request:
    prompt: str
    max_new_tokens: int = 64
    eos_id: int = -1             # -1: never stop on eos
    # sampling controls (DESIGN.md §12): temperature 0 = greedy (bit-exact
    # spec path); > 0 samples losslessly through the same spec_step.
    # ``seed`` pins the request's rng key; None derives a deterministic key
    # from the engine seed and request_id (replayable either way).
    temperature: float = 0.0
    top_p: float = 1.0
    seed: Optional[int] = None
    request_id: int = dataclasses.field(default_factory=lambda: next(_counter))
    # filled on completion:
    output: Optional[str] = None
    output_ids: Optional[np.ndarray] = None
    stats: Optional[dict] = None


@dataclasses.dataclass
class Batch:
    requests: List[Request]
    tokens: np.ndarray           # (B, P) int32, right-padded to bucket
    max_new_tokens: int


DEFAULT_BUCKETS = (32, 64, 128, 256, 512)


def fit_bucket(n: int, buckets: Tuple[int, ...] = DEFAULT_BUCKETS) -> int:
    """Smallest bucket holding an n-token prompt (largest bucket clamps)."""
    for b in sorted(buckets):
        if n <= b:
            return b
    return max(buckets)


class Scheduler:
    """FIFO with length bucketing.

    ``align`` rounds every bucket boundary up to a multiple (the engine
    passes the TPU lane width when the Pallas backend is active, so prefill
    blocks and the cache lengths derived from the bucket ladder land on
    kernel-friendly tiles; 1 = keep the ladder as given).
    """

    def __init__(self, max_batch: int = 8,
                 buckets: Tuple[int, ...] = DEFAULT_BUCKETS,
                 align: int = 1):
        self.max_batch = max_batch
        self.align = max(1, align)
        self.buckets = tuple(sorted({-(-b // self.align) * self.align
                                     for b in buckets}))
        self.tok = ByteTokenizer()
        self._queue: List[Tuple[Request, List[int]]] = []

    def submit(self, req: Request) -> int:
        ids = self.tok.encode(req.prompt)
        self._queue.append((req, ids))
        return req.request_id

    def _bucket(self, n: int) -> int:
        return fit_bucket(n, self.buckets)

    def next_batch(self) -> Optional[Batch]:
        if not self._queue:
            return None
        groups: Dict[Tuple[int, int], List[Tuple[Request, List[int]]]] = \
            defaultdict(list)
        for req, ids in self._queue:
            key = (self._bucket(len(ids)), req.max_new_tokens)
            groups[key].append((req, ids))
        # take the largest group (best batching efficiency)
        key = max(groups, key=lambda k: len(groups[k]))
        chosen = groups[key][:self.max_batch]
        chosen_ids = {id(r) for r, _ in chosen}
        self._queue = [(r, i) for r, i in self._queue
                       if id(r) not in chosen_ids]
        bucket, mnt = key
        # LEFT-pad so that the last prompt token sits at position bucket-1:
        # the jitted engine prefills a uniform length and starts generating
        # from the final position of every row.  (Per-row pad masking inside
        # recurrent prefill is future work; BOS-padding keeps the shift tiny.)
        toks = np.stack([self.pad_to_bucket(ids) for _, ids in chosen])
        return Batch([r for r, _ in chosen], toks, mnt)

    def max_queued_bucket(self) -> Optional[int]:
        """Largest bucket any currently-queued prompt needs (None if idle).
        Lets the engine size its continuous DecodeState to the workload
        instead of the worst-case largest bucket."""
        if not self._queue:
            return None
        return max(self._bucket(len(ids)) for _, ids in self._queue)

    def pad_to_bucket(self, ids: List[int]) -> np.ndarray:
        """LEFT-pad ``ids`` with BOS so the last prompt token sits at position
        bucket-1 — identical placement to the static ``next_batch`` path, so
        both serving modes produce bit-identical outputs per request."""
        bucket = self._bucket(len(ids))
        toks = np.full((bucket,), self.tok.bos_id, np.int32)
        ids = ids[-bucket:]
        toks[bucket - len(ids):] = ids
        return toks

    def peek_next(self) -> Optional[Tuple[Request, np.ndarray, int]]:
        """FIFO head without popping: (request, (bucket,) int32, raw_len).

        Lets the engine decide admissibility (page reservation, prompt
        capacity) BEFORE committing to the pop — a deferred request stays at
        the head of the queue in order.  ``raw_len`` is the un-bucketed
        token count (diagnostics: rejection messages cite it alongside the
        bucket that actually gates admission).
        """
        if not self._queue:
            return None
        req, ids = self._queue[0]
        return req, self.pad_to_bucket(ids), len(ids)

    def pop_next(self) -> Optional[Tuple[Request, np.ndarray]]:
        """FIFO pop for continuous batching: (request, (bucket,) int32)."""
        if not self._queue:
            return None
        req, ids = self._queue.pop(0)
        return req, self.pad_to_bucket(ids)

    def pending(self) -> int:
        return len(self._queue)

    def queued_requests(self) -> List[Request]:
        """Snapshot of queued requests in FIFO order (no pop) — the engine
        inspects it at continuous-state build time to decide whether the
        step must compile the sampled verification walk."""
        return [r for r, _ in self._queue]


class SlotMap:
    """Which request occupies which DecodeState slot (continuous batching)."""

    def __init__(self, num_slots: int):
        self.num_slots = num_slots
        self._slots: List[Optional[Request]] = [None] * num_slots

    def __len__(self) -> int:
        return sum(r is not None for r in self._slots)

    def free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self._slots) if r is None]

    def occupied(self) -> List[Tuple[int, Request]]:
        return [(i, r) for i, r in enumerate(self._slots) if r is not None]

    def get(self, slot: int) -> Optional[Request]:
        return self._slots[slot]

    def assign(self, slot: int, req: Request) -> None:
        if self._slots[slot] is not None:
            raise ValueError(f"slot {slot} already occupied by request "
                             f"{self._slots[slot].request_id}")
        self._slots[slot] = req

    def release(self, slot: int) -> Request:
        req = self._slots[slot]
        if req is None:
            raise ValueError(f"slot {slot} is already free")
        self._slots[slot] = None
        return req
