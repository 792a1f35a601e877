"""Serving engine: ties the scheduler to the speculative generator (port of
``repro/serving/engine.py``).

One ``ServingEngine`` owns (params, cfg, tables) and serves batched requests
with either plain greedy decoding or the paper's batched speculation —
switching is one constructor argument (the paper's P3, plug-and-play).
Two serving modes share the engine:

  - ``serve_all``: static batching; the scheduler forms whole batches and
    each runs one ``generate``; a finished row idles until its batch is
    done.
  - ``serve_continuous`` / ``step``: continuous batching over one
    persistent DecodeState; between steps finished rows are retired and
    queued prompts are prefilled into the freed slots (``admit_slot``).

Continuous batching can run over the PAGED KV layout (``paged=True``):
slots share a page pool with per-slot page tables, and admission reserves
each request's worst-case pages up front (deferring the queue head while
the pool is short), so one long prompt no longer sizes every slot's
buffer.  The outputs are the same as the linear layout's.

``adaptive=True`` works in both modes, with different machinery:
``serve_all`` picks one (k, w) arm per whole batch with the host-side UCB
controller (``core/controller.py`` ``AdaptiveKW``) and runs it as a
dedicated spec; continuous batching bakes the arm table into the step
(``SpecConfig.arms``): every slot picks its own arm every step on the
device, and the step's shapes are the table's maxima whatever it picks.

Both modes serve temperature and top-p requests (``submit(...,
temperature=, top_p=, seed=)``) losslessly through the same speculative
step, beside greedy ones (``SpecConfig.sampling``, ``core/verify.py``).
A request's key is ``prng_key(seed)`` when it pins a seed, else
``fold_in(prng_key(engine seed), request_id)``: the reference's keys, so
the reference's engine serves the same tokens for the same request.

``mesh=`` (a ``DeviceMesh`` with the reference's axis names,
``launch/mesh.py``) serves over a mesh: the parameters are DTensors placed
by ``distributed.sharding.params_shardings``, the continuous DecodeState by
``decode_state_shardings``, a static batch's rows by ``batch_sharding``,
the draft tables replicated; the activation sharder is active only inside
the engine's own calls (``_act``).  Temperature-0 rows serve the same
tokens as the engine without a mesh; sampled rows are reproducible per
mesh configuration (sharded reductions perturb logits at the ~1e-6
level, which argmax absorbs and a gumbel draw at its boundary may not).
``mesh_report()`` says how the state and parameters were placed.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core import prng
from ..core.controller import DEFAULT_ARMS, AdaptiveKW
from ..core.ngram_tables import NGramTables, build_bigram, build_unigram
from ..core.spec_engine import (DecodeState, PagedConfig, SpecConfig,
                                admit_slot, empty_decode_state, generate,
                                make_sharded_slot_fns, release_slot,
                                shard_state, spec_step)
from ..data.tokenizer import ByteTokenizer
from ..device import resolve_device
from ..distributed import act_sharding
from ..distributed import local as DL
from ..distributed import sharding as shd
from ..models import cache as Cache
from ..models import model as M
from ..models.config import ModelConfig
from .scheduler import DEFAULT_BUCKETS, Batch, Request, Scheduler, SlotMap


class ServingEngine:
    def __init__(self, params, cfg: ModelConfig,
                 spec: Optional[SpecConfig] = None,
                 tables: Optional[NGramTables] = None,
                 max_batch: int = 8,
                 adaptive: bool = False,
                 arms: Optional[Tuple[Tuple[int, int], ...]] = None,
                 buckets: Optional[Tuple[int, ...]] = None,
                 max_new_cap: int = 64,
                 paged: bool = False,
                 num_pages: Optional[int] = None,
                 page_size: int = 0,
                 sampling: Optional[bool] = None,
                 seed: int = 0,
                 device="cuda",
                 mesh=None):
        """``params`` live on ``device`` (default the CUDA card; pass
        ``device="cpu"`` for the plain path).  A drafting ``spec`` without
        ``tables`` builds them with one sweep over the vocabulary.
        ``adaptive``: pick (k, w) online with the UCB controller instead of
        the spec's fixed setting: per whole batch under ``serve_all``, per
        slot per step (arm masking inside ``spec_step``) under continuous
        batching.  ``arms`` overrides its arm table (``DEFAULT_ARMS``).
        ``buckets``: the scheduler's prompt-length ladder;
        ``buckets``/``max_new_cap`` bound the continuous DecodeState
        (buffer length = largest bucket + max_new_cap + w + 2).

        ``paged``: continuous batching over the paged KV layout: slots
        share a ``num_pages``-page pool (default: the linear worst case;
        pass less to cap memory) and admission reserves pages.
        ``page_size`` 0 follows ``cache.default_page_size``.

        ``sampling``: run the lossless sampled walk in the continuous step
        so that temperature > 0 requests are served.  None (default)
        resolves when the continuous state is built: on iff a sampled
        request is queued (or ``spec.sampling`` is set).  True commits to
        it up front (for sampled traffic that arrives after the first
        step); False pins the greedy-only step, and sampled requests are
        then rejected at admission rather than served greedy.  Static
        batches resolve it per batch.  ``seed`` is the engine's base key:
        a request's key is fold_in(seed key, request_id) unless the request
        pins its own ``seed``; both replay.

        ``mesh``: serve over a ``DeviceMesh`` (module docstring).  The
        ``params`` may then lie anywhere, the host say: each rank copies
        only its own shard of each to ``device``, so that no card holds the
        whole model.  Every architecture of the registry: attention with
        dense or MoE FFNs and the recurrent mixers (Mamba, mLSTM, sLSTM)
        alike; the kernels take the same route as without a mesh, on each
        rank's local tensors."""
        self.device = resolve_device(device)
        self.mesh = mesh
        self.params = params
        self.cfg = cfg
        self.spec = (spec or SpecConfig(strategy="greedy")).validate()
        if self.spec.tree and M.has_recurrent(cfg):
            raise ValueError(
                f"{cfg.name}: tree speculation needs an attention-only "
                f"arch — recurrent mixers verify rows as causal "
                f"sequences, which has no valid tree layout")
        self.tok = ByteTokenizer()
        self.controller: Optional[AdaptiveKW] = None
        self._arms: Optional[Tuple[Tuple[int, int], ...]] = None
        if adaptive:
            self._arms = tuple(tuple(a) for a in (arms or DEFAULT_ARMS))
            self.controller = AdaptiveKW(cfg, arms=self._arms)
        elif arms is not None:
            raise ValueError("arms= requires adaptive=True")
        # None resolves in _init_continuous; spec.sampling pre-commits
        self.sampling = True if self.spec.sampling else sampling
        self._seed_key = prng.prng_key(seed)
        self.max_batch = max_batch
        self.max_new_cap = max_new_cap
        self._explicit_buckets = buckets is not None
        self.scheduler = Scheduler(
            max_batch=max_batch,
            buckets=buckets if buckets is not None else DEFAULT_BUCKETS)
        self.paged = paged
        if paged and not Cache.paged_supported(cfg):
            raise ValueError(
                f"{cfg.name}: paged KV needs a linear-cache attention arch "
                f"(sliding_window=None, >=1 attn layer); run linear instead")
        self._paged_cfg = (PagedConfig(num_pages or 0, page_size)
                           if paged else None)
        if mesh is not None:
            # each rank's shards alone reach its device
            self.params = shd.rebuild(params, lambda p, t: DL.distribute(
                t, mesh, shd.param_pspec(mesh, p, t), self.device))
        if (self.spec.strategy != "greedy" or adaptive) and tables is None:
            arm_k = max((a[0] for a in self._arms or ()), default=0)
            arm_w = max((a[1] for a in self._arms or ()), default=0)
            # under a mesh: the sweep through the sharded model, the
            # unigrams from the caller's whole embeddings, a chunk at a time
            tables = self.build_tables(
                k_max=max(self.spec.k, 25, arm_k),
                w_max=max(self.spec.w, 16, arm_w),
                embed=None if mesh is None else params["embed"])
        # under a mesh the tables, small integer lookups, are replicated:
        # every rank holds them whole
        self.tables = tables
        self._fns = None
        # the spec the continuous path runs (sampling resolved, and the arm
        # table baked in under adaptive, when the state is built)
        self._cont_spec: SpecConfig = self.spec
        self._cont_state: Optional[DecodeState] = None
        self._slots: Optional[SlotMap] = None

    def _act(self):
        """Scoped activation sharder: the engine's mesh is active only
        inside its own calls and always uninstalled on exit, so that a
        meshed engine never constrains OTHER callers' tensors."""
        return (act_sharding.activated(self.mesh) if self.mesh is not None
                else contextlib.nullcontext())

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def build_tables(self, k_max: int = 16, w_max: int = 16,
                     batch: int = 256, embed=None) -> NGramTables:
        """One-off model sweep over the vocabulary (the bigram tables) plus
        the unigram ranking from the embeddings.  Under a mesh each rank
        sweeps its rows of every batch through the sharded model, and the
        unigrams come from ``embed`` (whole embedding parameters anywhere,
        read a chunk at a time on the engine's device), else from the
        engine's own tables gathered whole."""
        if self.mesh is None:
            topk, chain = build_bigram(
                lambda t: M.forward(self.params, self.cfg,
                                    tokens=t)[0][:, -1],
                self.cfg.vocab_size, k_max=k_max, w_max=w_max, batch=batch,
                device=self.device)
            emb = self.params["embed"]["embedding"]
            uni = build_unigram(emb, self.params["embed"].get("lm_head",
                                                              emb.T),
                                k_max=k_max)
            return NGramTables(unigram_topk=uni, bigram_topk=topk,
                               bigram_chain=chain)
        topk, chain = build_bigram(self._meshed_next_logits,
                                   self.cfg.vocab_size, k_max=k_max,
                                   w_max=w_max, batch=batch,
                                   device=self.device)
        if embed is None:
            embed = {k: DL.whole(t) for k, t in self.params["embed"].items()}
        emb = embed["embedding"]
        uni = build_unigram(emb, embed.get("lm_head", emb.T), k_max=k_max,
                            device=self.device)
        return NGramTables(unigram_topk=uni, bigram_topk=topk,
                           bigram_chain=chain)

    def _meshed_next_logits(self, toks: torch.Tensor) -> torch.Tensor:
        """(B, 1) tokens -> (B, V) next-token logits through the sharded
        model: each rank runs its rows of the batch (padded to a whole
        number a rank with copies of the last row) and the rows are
        gathered."""
        B = toks.shape[0]
        rows = DL.rows_for(self.mesh, DL.padded(self.mesh, B),
                           DL.cache_layout(self.mesh, self.cfg))
        pick = torch.arange(rows.lo, rows.hi,
                            device=toks.device).clamp(max=B - 1)
        with self._act(), DL.active(rows):
            logits = M.forward(self.params, self.cfg,
                               tokens=toks[pick])[0][:, -1]
            return DL.gather_rows(logits)[:B]

    def submit(self, prompt: str, max_new_tokens: int = 64,
               eos_id: int = -1, temperature: float = 0.0,
               top_p: float = 1.0, seed: Optional[int] = None) -> Request:
        """Queue a request.  ``temperature`` 0 decodes greedy (bit-exact);
        > 0 samples losslessly through the same step with nucleus mass
        ``top_p``.  ``seed`` pins the request's key (None: derived from the
        engine seed and request_id; deterministic either way)."""
        if temperature < 0:
            raise ValueError(
                f"temperature must be >= 0, got {temperature} (pass 0 for "
                f"greedy decoding; negative values are always a bug)")
        if not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        req = Request(prompt=prompt, max_new_tokens=max_new_tokens,
                      eos_id=eos_id, temperature=temperature, top_p=top_p,
                      seed=seed)
        self.scheduler.submit(req)
        return req

    def _req_key(self, req: Request) -> torch.Tensor:
        """The request's (2,) key on the host: its own seed's when pinned,
        else fold_in(engine seed key, request_id).  A pure function of
        (engine seed, request), so the same request replays the same
        sampled output in any batch (slots are independent)."""
        if req.seed is not None:
            return prng.prng_key(req.seed)
        return prng.fold_in(self._seed_key, req.request_id)

    def _effective_eos(self, req: Request) -> int:
        """Per-request eos wins; fall back to the engine-wide spec.eos_id."""
        return req.eos_id if req.eos_id >= 0 else self.spec.eos_id

    def run_batch(self, batch: Batch) -> List[Request]:
        # a batch with any sampled request runs the sampled walk (its
        # greedy rows stay bit-exact); an all-greedy batch the greedy step
        reqs = batch.requests
        sampled = (self.sampling is True
                   or any(r.temperature > 0 for r in reqs))
        spec = dataclasses.replace(self.spec,
                                   max_new_tokens=batch.max_new_tokens,
                                   sampling=sampled)
        kw = self.controller.choose() if self.controller else None
        if kw is not None:
            # the batch's arm as a dedicated spec: (1, 0) is plain greedy
            # (no tree to build), a greedy engine spec drafts mixed
            k, w = kw
            strategy = ("greedy" if w == 0 else
                        ("mixed" if self.spec.strategy == "greedy"
                         else self.spec.strategy))
            spec = dataclasses.replace(spec, k=max(k, 1), w=max(w, 1),
                                       strategy=strategy,
                                       tree=spec.tree and w > 0)
        eos = torch.tensor([self._effective_eos(r) for r in reqs],
                           dtype=torch.int32, device=self.device)
        tokens = torch.as_tensor(batch.tokens).to(self.device)
        sample_kw = {}
        if sampled:
            f32 = dict(dtype=torch.float32, device=self.device)
            sample_kw = dict(
                temperature=torch.tensor([r.temperature for r in reqs],
                                         **f32),
                top_p=torch.tensor([r.top_p for r in reqs], **f32),
                rng=torch.stack([self._req_key(r) for r in reqs]).to(
                    self.device))
        self._sync()
        t0 = time.perf_counter()
        with self._act():
            buf, blen, stats = generate(self.params, self.cfg, spec, tokens,
                                        self.tables, eos_id=eos,
                                        device=self.device, mesh=self.mesh,
                                        **sample_kw)
        self._sync()
        dt = time.perf_counter() - t0
        P = batch.tokens.shape[1]
        buf = buf.cpu().numpy()
        blen = blen.cpu().numpy()
        stats = {k: v.cpu().numpy() for k, v in stats.items()}
        if kw is not None:
            self.controller.update(
                kw, tokens=float(stats["tokens"].sum()),
                calls=float(max(stats["calls"].sum(), 1)))
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

    # ------------------------------------------------------------------
    # continuous batching (slot-level admission and retirement)
    # ------------------------------------------------------------------
    def _init_continuous(self) -> None:
        spec = self.spec
        if self.controller is not None:
            # adaptive: bake the arm table into the step; its shapes are the
            # table's maxima and every slot picks its arm each step (a tree
            # spec reads the table as (width, depth) arms)
            k_max = max(a[0] for a in self._arms)
            w_max = max(a[1] for a in self._arms)
            strategy = ("mixed" if spec.strategy == "greedy"
                        else spec.strategy)
            spec = dataclasses.replace(
                spec, k=k_max, w=max(w_max, 1), strategy=strategy,
                arms=self._arms).validate()
        # resolve the sampling flag ONCE, when the state is built: None
        # turns it on iff a sampled request is queued.  A sampled request
        # that later reaches a greedy-only step is rejected at admission
        # (_admit_queued) rather than served greedy.
        if self.sampling is None:
            self.sampling = any(r.temperature > 0
                                for r in self.scheduler.queued_requests())
        self._cont_spec = dataclasses.replace(spec,
                                              sampling=bool(self.sampling))
        # size the DecodeState to the queued workload, not the worst case:
        # a later prompt beyond the sized capacity is REJECTED at admission
        # (truncating it would corrupt its output).  Paged mode reserves the
        # full bucket ladder: KV capacity is governed by the page pool.
        prompt_cap = self.scheduler.buckets[-1]
        if not self.paged and not self._explicit_buckets:
            prompt_cap = self.scheduler.max_queued_bucket() or prompt_cap
        self._cont_prompt_cap = prompt_cap
        # w is the step's: the arm table's maximum under adaptive
        buf_size = prompt_cap + self.max_new_cap + self._cont_spec.w + 2
        # under a mesh the slots are a whole number a rank; a slot past
        # max_batch is never assigned
        n_slots, paged_cfg = self.max_batch, self._paged_cfg
        if self.mesh is not None:
            n_slots = DL.padded(self.mesh, self.max_batch)
            if paged_cfg is not None and not paged_cfg.num_pages:
                # the default pool stays max_batch slots' worst case
                ps = paged_cfg.resolve_page_size(self.cfg)
                paged_cfg = dataclasses.replace(
                    paged_cfg, num_pages=self.max_batch * -(-buf_size // ps))
        self._cont_state = empty_decode_state(
            self.cfg, self._cont_spec, n_slots, buf_size,
            paged=paged_cfg,
            device=self.device if self.mesh is None else "cpu")
        if self.mesh is not None:
            # place the state (built on the host: each rank's shards alone
            # reach its device), then the step, admit and release with
            # every leaf's placements pinned
            self._cont_state = shard_state(self._cont_state, self.mesh,
                                           self.device)
            self._fns = make_sharded_slot_fns(self.cfg, self._cont_spec,
                                              self._cont_state, self.mesh)
        self._slots = SlotMap(self.max_batch)
        # host-side total of the retired requests' arm pulls (adaptive)
        self._arm_pulls_total = (np.zeros(len(self._arms), np.int64)
                                 if self._arms else None)
        # page accounting (paged mode): admission reserves each request's
        # worst-case page count up front so the in-step growth can never
        # exhaust the pool mid-flight; physical allocation stays lazy.
        # All host-side: admitting reads nothing back from the device.
        if self.paged:
            self._page_size = self._paged_cfg.resolve_page_size(self.cfg)
            pps = self._cont_state.buf_size // self._page_size
            self._pool_pages = (self._paged_cfg.num_pages
                                or self.max_batch * pps)
            self._page_reserved: Dict[int, int] = {}
            self._pool_peak = 0
            self._deferrals = 0
        self._rejected = 0

    def in_flight(self) -> int:
        return len(self._slots) if self._slots is not None else 0

    def _run_step(self, state: DecodeState) -> DecodeState:
        if self._fns is not None:
            with self._act():
                return self._fns.step(self.params, state, self.tables)
        return spec_step(self.params, self.cfg, self._cont_spec, state,
                         self.tables)

    def _run_admit(self, state: DecodeState, slot: int, toks, mnt: int,
                   eos: int, req: Request) -> DecodeState:
        args = (state, slot, torch.from_numpy(np.asarray(toks)), mnt, eos)
        kw = dict(temperature=req.temperature, top_p=req.top_p,
                  rng_key=self._req_key(req))
        if self._fns is not None:
            with self._act():
                return self._fns.admit(self.params, *args, **kw)
        return admit_slot(self.params, self.cfg, *args, **kw)

    def _run_release(self, state: DecodeState, slot: int) -> DecodeState:
        if self._fns is not None:
            with self._act():
                return self._fns.release(state, slot)
        return release_slot(state, slot)

    def _retire_finished(self) -> List[Request]:
        state = self._cont_state
        # the one structural host read per step: slot reuse is a host
        # decision, so the done flags come back every step
        # repro-lint: allow(host-sync): slot reuse is decided on the host
        done = DL.whole(state.done).cpu().numpy()
        if not done[[s for s, _ in self._slots.occupied()]].any():
            return []
        if self.paged:
            # pool peak: occupancy only falls at release, so sampling here
            # (before this round's frees) sees every high-water mark
            # repro-lint: allow(host-sync): retiring rounds only, after the done read
            in_use = self._pool_pages - int(
                DL.whole(state.model["free_top"]).cpu())
            self._pool_peak = max(self._pool_peak, in_use)
        # one device->host transfer per array, only on retiring rounds:
        # the retired rows' outputs and stats, before release zeroes them
        # repro-lint: allow(host-sync): retiring rounds only, after the done read
        blen, plen, buf, calls_np, tokens_np, accept_hist_np, arm_pulls_np = (
            DL.whole(t).cpu().numpy() if t is not None else None
            for t in (
                state.buf_len, state.prompt_len, state.buf,
                state.stats["calls"], state.stats["tokens"],
                state.stats["accept_hist"],
                state.stats["arm_pulls"] if self._arms else None))
        retired: List[Request] = []
        for slot, req in self._slots.occupied():
            if not done[slot]:
                continue
            calls = int(calls_np[slot])
            tokens = int(tokens_np[slot])
            req.output_ids = buf[slot, plen[slot]:blen[slot]].copy()
            req.output = self.tok.decode(req.output_ids)
            req.stats = {
                "new_tokens": int(blen[slot] - plen[slot]),
                "model_calls": calls,
                "tokens_per_call": float(tokens / max(1, calls)),
                # verify calls that committed exactly n tokens (0..w+1),
                # read before release zeroes the slot's stats rows
                "accept_hist": accept_hist_np[slot].tolist(),
                # admit -> retire latency on the host clock (the done
                # readback above has synchronised with the device)
                "latency_s": time.perf_counter() - req.stats["admit_t"],
            }
            if arm_pulls_np is not None:
                # the slot's bandit history, read before release zeroes it
                req.stats["arm_pulls"] = {
                    self._arms[a]: int(arm_pulls_np[slot, a])
                    for a in range(len(self._arms))
                    if arm_pulls_np[slot, a]}
                self._arm_pulls_total += arm_pulls_np[slot].astype(np.int64)
            state = self._run_release(state, slot)
            self._slots.release(slot)
            if self.paged:
                self._page_reserved.pop(slot, None)
            retired.append(req)
        self._cont_state = state
        return retired

    def _slot_pages(self, prompt_len: int, mnt: int) -> int:
        """Worst-case pool pages one request can ever occupy: the cache
        holds at most prompt_len + mnt + w positions (cur_len peaks at
        prompt_len + mnt - 1 and spec growth covers cur_len + w + 1); w is
        the step's, the arm table's maximum under adaptive."""
        return int(Cache.pages_for_len(prompt_len + mnt + self._cont_spec.w,
                                       self._page_size))

    def _reject(self, req: Request, reason: str) -> Request:
        """Per-request admission failure: the request completes with an
        ``error`` stat instead of silently corrupted output."""
        req.output = None
        req.output_ids = np.zeros((0,), np.int32)
        req.stats = {"error": reason, "new_tokens": 0}
        self._rejected += 1
        warnings.warn(f"request {req.request_id} rejected: {reason}")
        return req

    def _admit_queued(self) -> List[Request]:
        """Admit queued prompts into free slots; returns the requests
        REJECTED this round.  Paged mode also gates admission on
        pages-available (reservation), deferring the queue head, in order,
        until retirements free enough pages."""
        state = self._cont_state
        rejected: List[Request] = []
        free = self._slots.free_slots()
        i = 0
        while i < len(free):
            slot = free[i]
            head = self.scheduler.peek_next()
            if head is None:
                break
            req, toks, raw_len = head
            if toks.shape[0] > self._cont_prompt_cap:
                # the request's bucket does not fit the self-sized state:
                # admitting would truncate it; a rejection frees no slot,
                # so retry this slot with the next queued request
                self.scheduler.pop_next()
                rejected.append(self._reject(
                    req,
                    f"prompt is {raw_len} tokens ({toks.shape[0]}-bucket) "
                    f"but the continuous DecodeState was sized for "
                    f"{self._cont_prompt_cap} (pass buckets= / use paged "
                    f"mode to admit longer prompts)"))
                continue
            if req.temperature > 0 and not self._cont_spec.sampling:
                # the step runs greedy-only (sampling=False was pinned, or
                # the state was built before sampled traffic arrived):
                # serving this request greedy would break its output
                # distribution, so reject it loudly
                self.scheduler.pop_next()
                rejected.append(self._reject(
                    req,
                    f"temperature={req.temperature} needs a "
                    f"sampling-enabled step, but the continuous spec_step "
                    f"runs greedy-only (construct the engine with "
                    f"sampling=True, or queue sampled requests before the "
                    f"first step)"))
                continue
            mnt = min(req.max_new_tokens, self.max_new_cap)
            if self.paged:
                pages = self._slot_pages(toks.shape[0], mnt)
                if pages > self._pool_pages:
                    # can NEVER fit: deferring would deadlock an idle pool
                    self.scheduler.pop_next()
                    rejected.append(self._reject(
                        req,
                        f"request needs {pages} pages but the pool has "
                        f"only {self._pool_pages} (raise num_pages)"))
                    continue
                avail = self._pool_pages - sum(self._page_reserved.values())
                if pages > avail:
                    # pool short: defer the head (FIFO order is kept) until
                    # retirements return pages to the free stack
                    self._deferrals += 1
                    break
                self._page_reserved[slot] = pages
            self.scheduler.pop_next()
            if mnt < req.max_new_tokens:
                warnings.warn(
                    f"request {req.request_id}: max_new_tokens "
                    f"{req.max_new_tokens} exceeds the engine's continuous "
                    f"max_new_cap={self.max_new_cap}; clamping (raise "
                    f"max_new_cap to honour larger budgets)")
            state = self._run_admit(state, slot, toks, mnt,
                                    self._effective_eos(req), req)
            self._slots.assign(slot, req)
            req.stats = {"admit_t": time.perf_counter()}
            i += 1
        self._cont_state = state
        return rejected

    def step(self) -> List[Request]:
        """One continuous-batching iteration: retire finished rows, admit
        queued prompts into the freed slots, then run one spec_step over
        every active slot.  Returns the requests completed this step,
        retired normally or rejected at admission (``stats["error"]``)."""
        if self._cont_state is None:
            self._init_continuous()
        retired = self._retire_finished()
        retired.extend(self._admit_queued())
        # occupancy is tracked host-side: after retirement every occupied
        # slot is runnable (an admission whose first token is eos retires
        # next step; its one no-op step is cheaper than a per-step read)
        if len(self._slots):
            self._cont_state = self._run_step(self._cont_state)
        return retired

    def reset_pool_counters(self) -> None:
        """Zero the cumulative pool and bandit counters (peak pages,
        deferral rounds, rejections, retired arm pulls) without touching
        the pool or the in-flight bandit state, so that a measured window
        starts clean after a warm-up."""
        if self._cont_state is None:
            return
        if self.paged:
            self._pool_peak = 0
            self._deferrals = 0
        if self._arm_pulls_total is not None:
            self._arm_pulls_total[:] = 0
        self._rejected = 0

    def pool_stats(self) -> Dict:
        """Paged-pool occupancy and admission counters (paged mode only).

        ``deferrals`` counts deferral ROUNDS (one per step() in which the
        queue head could not reserve pages), not distinct requests."""
        if not self.paged or self._cont_state is None:
            return {}
        free = int(DL.whole(self._cont_state.model["free_top"]))
        self._pool_peak = max(self._pool_peak, self._pool_pages - free)
        return {"num_pages": self._pool_pages,
                "page_size": self._page_size,
                "free_pages": free,
                "reserved_pages": sum(self._page_reserved.values()),
                "peak_pages": self._pool_peak,
                "deferrals": self._deferrals,
                "rejected": self._rejected}

    def adaptive_stats(self) -> Dict:
        """Continuous-mode bandit telemetry: the arm table, the pulls per
        arm over every RETIRED request, and the in-flight slots' current
        pulls (adaptive continuous mode only; reads the device)."""
        if self._arms is None or self._cont_state is None:
            return {}
        # repro-lint: allow(host-sync): telemetry, read outside the serving loop
        in_flight = DL.whole(
            self._cont_state.stats["arm_pulls"]).cpu().numpy()
        return {"arms": [list(a) for a in self._arms],
                "pulls_retired": self._arm_pulls_total.tolist(),
                "pulls_in_flight": in_flight.sum(axis=0).tolist()}

    def mesh_report(self) -> Dict:
        """How THIS engine placed its serving state ({} without a mesh):
        the mesh shape, per-leaf DecodeState specs, the parameters'
        sharding coverage and bytes (whole and on this rank), every
        (logical axis, dim) that degraded to replication in this engine's
        own resolution, and the attention caches' bytes, whole and on this
        rank."""
        if self.mesh is None:
            return {}
        leaves = [t for _, t in shd.walk(self.params)]
        p_sharded = sum(1 for t in leaves
                        if any(pl.is_shard() for pl in t.placements))
        # re-resolve THIS engine's specs under a scoped recorder: only the
        # fallbacks of its own params and state, not the process history
        with shd.recording_fallbacks() as fallbacks:
            shd.params_pspecs(self.mesh, self.params)
            specs = (shd.decode_state_pspecs(self.mesh, self._cont_state)
                     if self._cont_state is not None else None)
        p_bytes = {"global": sum(t.numel() * t.element_size()
                                 for t in leaves),
                   "local": sum(t.to_local().numel() * t.element_size()
                                for t in leaves)}
        rep = {"mesh": shd.axis_sizes(self.mesh),
               # the kernels' route: the tensors', as without a mesh
               "backend": "cuda" if self.device.type == "cuda" else "plain",
               "tables": "replicated",
               "params_leaves": len(leaves),
               "params_sharded": p_sharded,
               "params_bytes": p_bytes,
               "replication_fallbacks": [list(kv)
                                         for kv in sorted(fallbacks)]}
        if specs is not None:
            txt = shd.spec_summary(specs)
            rep["state_specs"] = txt
            rep["state_sharded"] = sum(
                1 for v in txt.values()
                if any(f"'{ax}'" in v for ax in rep["mesh"]))
            kv = [t for p, t in shd.state_leaf_items(self._cont_state)
                  if p[0] == "model" and p[-1] in ("k", "v")]
            rep["kv_bytes"] = {
                "global": sum(t.numel() * t.element_size() for t in kv),
                "local": sum(t.to_local().numel() * t.element_size()
                             for t in kv)}
        return rep

    def serve_continuous(self) -> List[Request]:
        """Drain the queue with continuous batching; blocks until idle."""
        done: List[Request] = []
        while True:
            done.extend(self.step())
            if self.scheduler.pending() == 0 and self.in_flight() == 0:
                return done
