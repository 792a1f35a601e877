"""Serving engine: ties the scheduler to the speculative generator (port of
the static-batching half of ``repro/serving/engine.py``).

One ``ServingEngine`` owns (params, cfg, tables) and serves batched requests
with either plain greedy decoding or the paper's batched speculation —
switching is one constructor argument (the paper's P3, plug-and-play).
``serve_all`` is static batching: the scheduler forms whole batches and
each runs one ``generate``; a finished row idles until its batch is done.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

import torch

from ..core.ngram_tables import NGramTables, build_bigram, build_unigram
from ..core.spec_engine import SpecConfig, generate
from ..data.tokenizer import ByteTokenizer
from ..device import resolve_device
from ..models import model as M
from ..models.config import ModelConfig
from .scheduler import DEFAULT_BUCKETS, Batch, Request, Scheduler


class ServingEngine:
    def __init__(self, params, cfg: ModelConfig,
                 spec: Optional[SpecConfig] = None,
                 tables: Optional[NGramTables] = None,
                 max_batch: int = 8,
                 buckets: Optional[Tuple[int, ...]] = None,
                 device="cuda"):
        """``params`` live on ``device`` (default the CUDA card; pass
        ``device="cpu"`` for the plain path).  A drafting ``spec`` without
        ``tables`` builds them with one sweep over the vocabulary.
        ``buckets``: the scheduler's prompt-length ladder."""
        self.device = resolve_device(device)
        self.params = params
        self.cfg = cfg
        self.spec = (spec or SpecConfig(strategy="greedy")).validate()
        self.tok = ByteTokenizer()
        self.scheduler = Scheduler(
            max_batch=max_batch,
            buckets=buckets if buckets is not None else DEFAULT_BUCKETS)
        if self.spec.strategy != "greedy" and tables is None:
            tables = self.build_tables(k_max=max(self.spec.k, 25),
                                       w_max=max(self.spec.w, 16))
        self.tables = tables

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def build_tables(self, k_max: int = 16, w_max: int = 16,
                     batch: int = 256) -> NGramTables:
        """One-off model sweep over the vocabulary (the bigram tables) plus
        the unigram ranking from the embeddings."""
        topk, chain = build_bigram(
            lambda t: M.forward(self.params, self.cfg, tokens=t)[0][:, -1],
            self.cfg.vocab_size, k_max=k_max, w_max=w_max, batch=batch,
            device=self.device)
        emb = self.params["embed"]["embedding"]
        uni = build_unigram(emb, self.params["embed"].get("lm_head", emb.T),
                            k_max=k_max)
        return NGramTables(unigram_topk=uni, bigram_topk=topk,
                           bigram_chain=chain)

    def submit(self, prompt: str, max_new_tokens: int = 64,
               eos_id: int = -1) -> Request:
        """Queue a greedy request."""
        req = Request(prompt=prompt, max_new_tokens=max_new_tokens,
                      eos_id=eos_id)
        self.scheduler.submit(req)
        return req

    def _effective_eos(self, req: Request) -> int:
        """Per-request eos wins; fall back to the engine-wide spec.eos_id."""
        return req.eos_id if req.eos_id >= 0 else self.spec.eos_id

    def run_batch(self, batch: Batch) -> List[Request]:
        spec = dataclasses.replace(self.spec,
                                   max_new_tokens=batch.max_new_tokens)
        eos = torch.tensor([self._effective_eos(r) for r in batch.requests],
                           dtype=torch.int32, device=self.device)
        tokens = torch.as_tensor(batch.tokens).to(self.device)
        self._sync()
        t0 = time.perf_counter()
        buf, blen, stats = generate(self.params, self.cfg, spec, tokens,
                                    self.tables, eos_id=eos,
                                    device=self.device)
        self._sync()
        dt = time.perf_counter() - t0
        P = batch.tokens.shape[1]
        buf = buf.cpu().numpy()
        blen = blen.cpu().numpy()
        stats = {k: v.cpu().numpy() for k, v in stats.items()}
        for i, req in enumerate(batch.requests):
            req.output_ids = buf[i, P:blen[i]].copy()
            req.output = self.tok.decode(req.output_ids)
            req.stats = {
                "new_tokens": int(blen[i] - P),
                "model_calls": int(stats["calls"][i]),
                "tokens_per_call": float(stats["tokens"][i]
                                         / max(1, stats["calls"][i])),
                "accept_hist": stats["accept_hist"][i].tolist(),
                "wall_time_s": dt,
            }
        return batch.requests

    def serve_all(self) -> List[Request]:
        done: List[Request] = []
        while True:
            batch = self.scheduler.next_batch()
            if batch is None:
                return done
            done.extend(self.run_batch(batch))
