"""Mixture-of-Experts FFN: top-k router, shared experts and the two dispatch
implementations (port of ``repro/models/moe.py``).

Covers Mixtral (8 experts, top-2), DeepSeek-MoE (2 shared + 64 routed
experts, top-6, fine-grained expert width) and Jamba (16 experts, top-2).
The reference computes the whole layer in XLA ops, outside any Pallas
kernel, and so does the port: the expert FFN is a batched product
(``torch.bmm``).

  - ``moe_dense``:   every expert computes every token, combined with the
                     router weights: the oracle.
  - ``moe_scatter``: the default.  Token-slots are ranked within their
                     expert in flat (token, k) order and packed into an
                     (E, C, d) buffer; a slot ranked C or later is DROPPED
                     (contributes nothing).  C depends on N, the number of
                     tokens in the call, so a row's output depends on the
                     other rows of the call: the reference's semantics,
                     kept exactly (same float expression for C, same
                     ranks, every token of the call routed, padding
                     included).

The scatter is deterministic on the card: the kept slots are packed with a
non-accumulating ``index_put_`` (each (e, c) holds one slot; dropped slots
all land on one spare row that nothing reads), and a token's K outputs are
summed in k order, as the reference's scatter-add sums them.

Inside ``count_drops()``, ``moe_scatter`` counts its dropped token-slots
on the device of the tokens it routes, without a host sync.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterator, Optional, Tuple

import torch
import torch.nn.functional as F

from ..distributed import local as L
from .config import ModelConfig

Params = Dict[str, torch.Tensor]


def param_shapes(cfg: ModelConfig, R: int) -> Dict[str, tuple]:
    """(shape, init, dtype) of the R-stacked MoE parameters.  The router
    stays float32 whatever the config's ``param_dtype``, as the reference
    makes it.  Expert stacks take their fan-in from the per-layer leading
    dim (E), as the reference's ``dense_init`` does for them."""
    d, f, E, pd = cfg.d_model, cfg.expert_d_ff, cfg.num_experts, \
        cfg.param_dtype
    out = {"router": ((R, d, E), "dense", torch.float32),
           "w_gate": ((R, E, d, f), "dense_lead", pd),
           "w_up": ((R, E, d, f), "dense_lead", pd),
           "w_down": ((R, E, f, d), "dense_lead", pd)}
    if cfg.num_shared_experts:
        s = f * cfg.num_shared_experts
        out.update(shared_gate=((R, d, s), "dense", pd),
                   shared_up=((R, d, s), "dense", pd),
                   shared_down=((R, s, d), "dense", pd))
    return out


def _expert_ffn(wg, wu, wd, x: torch.Tensor, cd) -> torch.Tensor:
    """x: (E, C, d) -> (E, C, d), the batched SwiGLU over experts."""
    g = F.silu(torch.bmm(x, wg.to(cd)))
    u = torch.bmm(x, wu.to(cd))
    return torch.bmm(g * u, wd.to(cd))


def expert_counts(flat_e: torch.Tensor, E: int) -> torch.Tensor:
    """(E,) int64: how many entries of ``flat_e`` name each expert.  A
    fixed-length scatter-add, exact in integers; ``torch.bincount`` would
    read the input's extent back to the host on CUDA."""
    return torch.zeros((E,), dtype=torch.int64,
                       device=flat_e.device).index_add_(
        0, flat_e, torch.ones_like(flat_e))


def _router(params: Params, x2d: torch.Tensor, cfg: ModelConfig):
    """Returns (topk_idx (N, K) int64, topk_w (N, K) f32, aux_loss).

    Top-k is a stable descending sort, so a tie keeps the lower expert
    first, as ``jax.lax.top_k`` does."""
    logits = x2d.float() @ params["router"]                  # (N, E)
    probs = torch.softmax(logits, dim=-1)
    K, E = cfg.num_experts_per_tok, cfg.num_experts
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    topk_w, topk_idx = vals[:, :K], idx[:, :K]
    topk_w = topk_w / topk_w.sum(-1, keepdim=True).clamp(min=1e-9)
    # Switch-style load-balance loss
    me = probs.mean(dim=0)                                   # (E,)
    ce = expert_counts(topk_idx.reshape(-1), E).float()
    ce = ce / ce.sum().clamp(min=1.0)
    aux = E * torch.sum(me * ce)
    return topk_idx, topk_w, aux


def moe_dense(params: Params, x: torch.Tensor, cfg: ModelConfig,
              e_lo: int = 0):
    """Oracle: all experts on all tokens.  x: (B, T, d).  ``params``' expert
    stacks may hold experts e_lo .. e_lo + E_l - 1 alone (a mesh's expert
    shard): the result is then their part of the combine."""
    cd = cfg.compute_dtype
    B, T, d = x.shape
    x2d = x.reshape(-1, d).to(cd)
    idx, w, aux = _router(params, x2d, cfg)
    E, E_l = cfg.num_experts, params["w_gate"].shape[0]
    outs = _expert_ffn(params["w_gate"], params["w_up"], params["w_down"],
                       x2d.expand((E_l,) + x2d.shape), cd)   # (E_l, N, d)
    onehot = F.one_hot(idx, E)[..., e_lo:e_lo + E_l].to(cd) \
        * w.to(cd)[..., None]
    comb = torch.einsum("nke,end->nd", onehot, outs)
    return comb.reshape(B, T, d), aux


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """Slots per expert in a call of ``n_tokens`` tokens: the reference's
    expression, operand order and truncation included."""
    K, E = cfg.num_experts_per_tok, cfg.num_experts
    return max(int(n_tokens * K / E * cfg.capacity_factor), K)


def moe_scatter(params: Params, x: torch.Tensor, cfg: ModelConfig,
                e_lo: int = 0):
    """Sort-based capacity dispatch.  x: (B, T, d).  Routing and capacity
    ranks always cover all E experts and every token of the call; the
    expert stacks may hold experts e_lo .. e_lo + E_l - 1 alone (a mesh's
    expert shard), whose slots alone are then computed: their part of the
    combine."""
    cd = cfg.compute_dtype
    B, T, d = x.shape
    N = B * T
    K, E = cfg.num_experts_per_tok, cfg.num_experts
    C = capacity(cfg, N)
    x2d = x.reshape(N, d).to(cd)
    idx, w, aux = _router(params, x2d, cfg)                  # (N, K)
    flat_e = idx.reshape(-1)                                 # (N*K,)
    # each slot's rank within its expert, in flat (token, k) order: a
    # stable sort by expert, then the slot's place in the sorted order less
    # its expert's first place (the reference's running one-hot count, as
    # integers: the same ranks)
    order = torch.argsort(flat_e, stable=True)
    e_sorted = flat_e[order]
    counts = expert_counts(flat_e, E)
    first = counts.cumsum(0) - counts
    pos_sorted = torch.arange(N * K, device=x.device) - first[e_sorted]
    ranks = torch.empty_like(pos_sorted).scatter_(0, order, pos_sorted)
    keep = ranks < C
    if _counter is not None:
        _counter.add((~keep).sum())
    E_l = params["w_gate"].shape[0]
    if E_l != E:
        keep = keep & (flat_e >= e_lo) & (flat_e < e_lo + E_l)
    # pack the kept slots into (E, C, d); row E*C takes every dropped slot
    dst = torch.where(keep, (flat_e - e_lo) * C + ranks, E_l * C)
    buf = torch.zeros((E_l * C + 1, d), dtype=cd, device=x.device)
    buf = buf.index_put((dst,), x2d.repeat_interleave(K, dim=0))
    out = _expert_ffn(params["w_gate"], params["w_up"], params["w_down"],
                      buf[:E_l * C].view(E_l, C, d), cd).reshape(E_l * C, d)
    got = out[dst.clamp(max=E_l * C - 1)]                    # (N*K, d)
    got = torch.where(keep[:, None], got, 0) * w.reshape(-1, 1).to(cd)
    got = got.view(N, K, d)
    comb = got[:, 0]
    for k in range(1, K):                                    # in k order
        comb = comb + got[:, k]
    return comb.reshape(B, T, d), aux


class DropCounts:
    """``moe_scatter``'s dropped token-slots while ``count_drops`` is
    active: one call is one MoE layer's dispatch.  The sums stay on the
    device of the first call's tokens until ``read``."""

    def __init__(self):
        self.calls = 0
        self.dropped: Optional[torch.Tensor] = None
        self.most: Optional[torch.Tensor] = None

    def add(self, n_drop: torch.Tensor) -> None:
        self.calls += 1
        if self.dropped is None:
            self.dropped = self.most = n_drop
        else:
            self.dropped = self.dropped + n_drop
            self.most = torch.maximum(self.most, n_drop)

    def read(self) -> Tuple[int, int, int]:
        """(calls, dropped token-slots in all, most dropped in one call)."""
        if not self.calls:
            return 0, 0, 0
        return self.calls, int(self.dropped), int(self.most)


_counter: Optional[DropCounts] = None


@contextlib.contextmanager
def count_drops() -> Iterator[DropCounts]:
    """Counts ``moe_scatter``'s dropped token-slots while active; the
    counting stops when the block ends, whatever ends it."""
    global _counter
    outer, _counter = _counter, DropCounts()
    try:
        yield _counter
    finally:
        _counter = outer


def _routed_mesh(params: Params, x, cfg: ModelConfig):
    """The routed experts on a DTensor ``x`` (B, T, d): every rank routes
    all the call's tokens (the capacity ranks are over all N of them, so
    the tokens are gathered, an explicit redistribute), computes its
    "model" shard's experts (or, when E does not divide the axis, its ffn
    columns of every expert) and the partial combines are summed over
    "model"."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = L.current().mesh
    rep = [Replicate()] * mesh.ndim
    names = list(mesh.mesh_dim_names)
    mi = names.index("model") if "model" in names else None

    def model_shard(w):
        pl = list(rep)
        if mi is not None:
            pl[mi] = w.placements[mi]
        return w.redistribute(mesh, pl).to_local()

    local = {"router": params["router"].redistribute(mesh, rep).to_local()}
    for n in ("w_gate", "w_up", "w_down"):
        local[n] = model_shard(params[n])
    e_lo = 0
    if mi is not None and params["w_gate"].placements[mi] == Shard(0):
        e_lo = L.coord(mesh, "model") * local["w_gate"].shape[0]
    impl = moe_dense if cfg.moe_impl == "dense" else moe_scatter
    y, aux = impl(local, x.redistribute(mesh, rep).to_local(), cfg, e_lo)
    y = DTensor.from_local(L.reduce(y, ("model",)), mesh, rep,
                           run_check=False)
    return y.redistribute(mesh, L.current().placements(y.dim())), aux


def apply_moe(params: Params, x: torch.Tensor, cfg: ModelConfig):
    """Returns (y, aux_loss).  Adds the shared experts (DeepSeek) when the
    config has them."""
    if L.current() is not None:
        y, aux = _routed_mesh(params, x, cfg)
    else:
        impl = moe_dense if cfg.moe_impl == "dense" else moe_scatter
        y, aux = impl(params, x, cfg)
    if cfg.num_shared_experts:
        cd = cfg.compute_dtype
        xs = x.to(cd)
        g = F.silu(xs @ params["shared_gate"].to(cd))
        u = xs @ params["shared_up"].to(cd)
        y = y + (g * u) @ params["shared_down"].to(cd)
    return y, aux
