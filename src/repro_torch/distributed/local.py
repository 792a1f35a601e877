"""The meshed step's local rows: how the port runs a step over a sharded
``DecodeState``.

A meshed engine's parameters and state leaves are DTensors placed by
``sharding.py``.  The step's row-local work (drafting, acceptance, the
commit, sampling, the stats) runs unchanged on each rank's LOCAL shard of
the slot axis: ``make_sharded_slot_fns``'s ``local_view`` hands the step
the leaves' local tensors, views of the DTensors' own storage, so every
in-place write lands in the sharded state.  Only the model math crosses
ranks: the model functions ``lift`` their local token rows into DTensors,
run the layers on DTensor activations against DTensor parameters, and
``lower`` the logits back to the local rows.  The attention reads and writes the caches' local shards
(``models/attention.py``'s mesh path), gathering only what a shard lacks.
The recurrent mixers (``models/mamba.py``, ``models/xlstm.py``) take the
local rows and their state leaves' shards (``state_dims``,
``local_leaf``): their projections are ``product``s against the
parameters' shards, their recurrences run on the rank's channels, heads
or head dims, and a contraction over a dim the state shards is a partial
sum (``reduce``), never a gather of the leaf.

``Rows`` says where this rank's rows sit: the global row count, the mesh
axes that shard the rows (none when the count does not divide them), and
the cache layout (the mesh axes of the kv heads, of a linear cache's
sequence, of a paged pool's pages).  ``active(rows)`` scopes it; the model
code asks ``current()`` and is unchanged when it is None.
"""
from __future__ import annotations

import contextlib
import dataclasses
import sys
from typing import Any, Dict, Iterator, Optional, Tuple

import torch

from .sharding import axis_sizes, resolve_axis, state_pspec, to_placements

Axes = Tuple[str, ...]


def _axes(entry) -> Axes:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _entry(axes: Axes):
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else tuple(axes)


def coord(mesh, axis: str) -> int:
    """This rank's coordinate along mesh axis ``axis``."""
    return mesh.get_local_rank(axis)


def shard_range(mesh, size: int, axes: Axes) -> Tuple[int, int]:
    """This rank's [lo, hi) of a dim of ``size`` sharded over ``axes`` (in
    mesh order), with DTensor's chunking: each axis splits the range left
    by the axes before it into ceil-sized chunks."""
    lo, hi = 0, size
    for a in axes:
        n = axis_sizes(mesh)[a]
        c = -(-(hi - lo) // n)
        i = coord(mesh, a)
        lo, hi = min(lo + i * c, hi), min(lo + (i + 1) * c, hi)
    return lo, hi


@dataclasses.dataclass(frozen=True)
class CacheLayout:
    """The mesh axes of an attention cache's sharded dims: the kv heads
    (either layout), a linear cache's sequence, a paged pool's pages.
    ``shared_pool``: the pool's free stack is shared by every rank's rows
    (the engine's replicated free list), so page growth counts all rows."""
    kv: Axes = ()
    seq: Axes = ()
    pages: Axes = ()
    shared_pool: bool = False
    pool_pages: int = 0         # the pool's global page count, trash included


def cache_layout(mesh, cfg, spec: Optional[tuple] = None,
                 shape: Optional[tuple] = None, paged: bool = False
                 ) -> CacheLayout:
    """The layout of a state's attention cache leaf of global ``shape``
    and the rule's ``spec`` ((R, B, S, KV, hd) linear, (R, NP+1, ps, KV,
    hd) paged: a paged state's pool is shared by every rank's rows);
    without a spec, a rank-private cache: kv heads by the rule, nothing
    else sharded."""
    if spec is None:
        return CacheLayout(kv=_axes(resolve_axis(mesh, "kv",
                                                 cfg.num_kv_heads,
                                                 warn=False)))
    if paged:
        return CacheLayout(kv=_axes(spec[3]), pages=_axes(spec[1]),
                           shared_pool=True, pool_pages=shape[1])
    return CacheLayout(kv=_axes(spec[3]), seq=_axes(spec[2]))


def live(mesh, axes: Axes) -> Axes:
    """The axes of ``axes`` that split anything (size > 1): sharding over
    a size-1 axis is replication, and DTensor's view rules are kept off
    such placements."""
    sizes = axis_sizes(mesh)
    return tuple(a for a in axes if sizes[a] > 1)


def ways(mesh, axes: Axes) -> int:
    """How many shards ``axes`` split a dim into."""
    sizes = axis_sizes(mesh)
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def batch_ways(mesh) -> int:
    """How many ways a batch splits on ``mesh``: the size of its live
    ("pod", "data") axes."""
    sizes = axis_sizes(mesh)
    return ways(mesh, tuple(a for a in ("pod", "data") if a in sizes))


def padded(mesh, B: int) -> int:
    """``B`` rounded up to a whole number of rows a rank."""
    n = batch_ways(mesh)
    return -(-B // n) * n


@dataclasses.dataclass(frozen=True)
class Rows:
    mesh: Any
    B: int                      # global rows (a whole number a rank)
    axes: Axes                  # live mesh axes sharding the rows
    lo: int
    hi: int
    cache: CacheLayout

    @property
    def n(self) -> int:
        return self.hi - self.lo

    def owns(self, row: int) -> bool:
        return self.lo <= row < self.hi

    def placements(self, ndim: int, batch_dim: int = 0,
                   extra: Optional[Dict[int, Axes]] = None) -> tuple:
        """Placements of a tensor whose ``batch_dim`` holds these rows and
        whose other dims are sharded over the live axes ``extra`` gives
        them."""
        spec = [None] * ndim
        spec[batch_dim] = _entry(self.axes)
        for d, ax in (extra or {}).items():
            spec[d] = _entry(live(self.mesh, ax))
        return to_placements(self.mesh, tuple(spec))


def rows_for(mesh, B: int, cache: CacheLayout) -> Rows:
    """Rows of a B-row batch or state, B a whole number a rank
    (``padded``): split over the live ("pod","data") axes.  Every model
    call under a mesh splits its rows so: a batch whose rows were left
    whole would let DTensor's matmul split the flattened rows unevenly."""
    if B % batch_ways(mesh):
        raise ValueError(f"{B} rows do not split over {axis_sizes(mesh)}: "
                         f"pad them (local.padded)")
    sizes = axis_sizes(mesh)
    axes = live(mesh, tuple(a for a in ("pod", "data") if a in sizes))
    lo, hi = shard_range(mesh, B, axes)
    return Rows(mesh, B, axes, lo, hi, cache)


def local_model(model: Dict[str, Any], rows: Rows) -> Dict[str, Any]:
    """A model state of DTensors (``cur_len``, the caches, the recurrent
    leaves) as this rank's local tensors: views of the DTensors' own
    storage, so every in-place write of a call lands in the sharded state;
    the replicated ``cur_len`` cut to this rank's rows."""
    def walk(t):
        return ({k: walk(v) for k, v in t.items()} if isinstance(t, dict)
                else t.to_local())
    loc = walk(model)
    if rows.axes:
        loc["cur_len"] = loc["cur_len"][rows.lo:rows.hi]
    return loc


def sync_cur_len(model: Dict[str, Any], rows: Rows) -> None:
    """After a call advanced this rank's rows of the replicated
    ``cur_len`` (``local_model``'s cut), every rank's rows of it, gathered
    in place."""
    if rows.axes:
        full = model["cur_len"].to_local()
        full.copy_(gather_rows(full[rows.lo:rows.hi].clone(), rows))


_ROWS: Optional[Rows] = None


def current() -> Optional[Rows]:
    return _ROWS


@contextlib.contextmanager
def active(rows: Optional[Rows]) -> Iterator[None]:
    """Scope ``rows`` (and DTensor's implicit replication of plain tensors
    that meet DTensors: the model's constants); the previous value is
    restored on exit."""
    global _ROWS
    prev = _ROWS
    _ROWS = rows
    try:
        if rows is None:
            yield
        else:
            from torch.distributed.tensor.experimental import (
                implicit_replication)
            with implicit_replication():
                yield
    finally:
        _ROWS = prev


# ---------------------------------------------------------------------------
# local <-> DTensor
# ---------------------------------------------------------------------------
def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor, without importing DTensor's module (no
    DTensor exists before it is imported)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def whole(t: torch.Tensor) -> torch.Tensor:
    """A tensor whole: a DTensor's gathered (a host read of a meshed
    state's leaf, outside any step), any other as it is."""
    return t.full_tensor() if is_dtensor(t) else t


def lift(x: torch.Tensor, batch_dim: int = 0,
         extra: Optional[Dict[int, Axes]] = None):
    """A local rows tensor as the DTensor of the global rows."""
    from torch.distributed.tensor import DTensor
    r = _ROWS
    return DTensor.from_local(x, r.mesh, r.placements(x.dim(), batch_dim,
                                                      extra),
                              run_check=False)


def lower(x, batch_dim: int = 0, extra: Optional[Dict[int, Axes]] = None
          ) -> torch.Tensor:
    """A DTensor as this rank's local rows (other dims as ``extra``
    says, replicated otherwise)."""
    r = _ROWS
    return x.redistribute(r.mesh, r.placements(x.dim(), batch_dim,
                                               extra)).to_local()


# when a list, ``model_only`` appends (bytes after its gather, the
# parameter's global bytes) for every parameter it gathers (a test's probe)
PARAM_GATHERS: Optional[list] = None


def model_only(tree):
    """A layer's parameters with every mesh axis but "model" gathered
    (the FSDP all-gather over ("pod","data")): the matmuls then split
    only over "model", column- then row-parallel, and each row's product
    is computed whole on the rank that holds the row.  A parameter keeps
    its "model" shard: none is gathered whole unless "model" splits it
    not at all."""
    if isinstance(tree, dict):
        return {k: model_only(v) for k, v in tree.items()}
    if not is_dtensor(tree):
        return tree
    from torch.distributed.tensor import DTensor, Replicate
    mesh = tree.device_mesh
    names = list(mesh.mesh_dim_names)
    pl = [p if n == "model" else Replicate()
          for n, p in zip(names, tree.placements)]
    if list(tree.placements) == pl:
        return tree
    local = tree.to_local()
    for n, p in zip(names, tree.placements):
        if n != "model" and p.is_shard():
            local = gather(local, p.dim, (n,), mesh)
    if PARAM_GATHERS is not None:
        PARAM_GATHERS.append((local.numel() * local.element_size(),
                              tree.numel() * tree.element_size()))
    return DTensor.from_local(local, mesh, pl, run_check=False,
                              shape=tree.shape, stride=tree.stride())


def to_rows(x):
    """A DTensor activation with its rows split as this call's rows are
    and every other dim whole: a block's normed input, so that its
    projections are column-parallel with no weight gathered."""
    r = _ROWS
    return x.redistribute(r.mesh, r.placements(x.dim()))


def _dim_offset(t, dim: int) -> int:
    """The global offset of a DTensor's local shard along ``dim``."""
    mesh = t.device_mesh
    axes = tuple(n for n, p in zip(mesh.mesh_dim_names, t.placements)
                 if p.is_shard(dim))
    return shard_range(mesh, t.shape[dim], axes)[0]


def embed_rows(table, tokens: torch.Tensor):
    """The DTensor of the embeddings of every rank's ``tokens`` rows, from
    a (V, d) ``table`` DTensor left in its shards: each rank looks the
    gathered tokens up in its own (vocab range, d range) block, a token
    outside its vocab range giving zeros, so that the sum over the vocab's
    axes is exact (one nonzero term) and no rank gathers the table."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    r = _ROWS
    toks = gather_rows(tokens).long()
    tab = table.to_local()
    idx = toks - _dim_offset(table, 0)
    ok = (idx >= 0) & (idx < tab.shape[0])
    x = torch.where(ok[..., None], tab[idx.clamp(0, tab.shape[0] - 1)], 0)
    pl = [Partial() if p.is_shard(0) else Shard(x.dim() - 1)
          if p.is_shard(1) else Replicate() for p in table.placements]
    shape = tuple(toks.shape) + (table.shape[1],)
    dt = DTensor.from_local(x, r.mesh, pl, run_check=False, shape=shape,
                            stride=_contiguous_stride(shape))
    return dt.redistribute(r.mesh, r.placements(x.dim()))


def matmul_rows(x, w):
    """``x @ w`` for a DTensor ``x`` (..., d) of rows and a (d, V) DTensor
    ``w`` left in its shards: along a mesh axis that shards w's d the
    activation is split over d instead (a partial sum, reduced), along one
    that shards V the activation is whole.  Returns the DTensor of the
    rows, V whole."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    r = _ROWS
    last = x.dim() - 1
    x_pl, out_pl = [], []
    for px, pw in zip(r.placements(x.dim()), w.placements):
        if pw.is_shard(0):
            x_pl.append(Shard(last))
            out_pl.append(Partial())
        elif pw.is_shard(1):
            x_pl.append(Replicate())
            out_pl.append(Shard(last))
        else:
            x_pl.append(px)
            out_pl.append(px)
    xl = x.redistribute(r.mesh, x_pl).to_local()
    out = xl @ w.to_local()
    shape = tuple(x.shape[:-1]) + (w.shape[1],)
    dt = DTensor.from_local(out, r.mesh, out_pl, run_check=False,
                            shape=shape, stride=_contiguous_stride(shape))
    return dt.redistribute(r.mesh, r.placements(dt.dim()))


def product(x: torch.Tensor, w):
    """``x @ w`` for this rank's local rows ``x`` (..., K) and a (K, N)
    DTensor ``w`` left in its shards, as the DTensor of the global rows.
    ``x``'s last dim is whole, or this rank's shard of K where ``w``
    shards its K (a row-parallel product: a partial sum over those axes,
    which DTensor reduces when the result is redistributed).  Along an
    axis that shards N the result is column-sharded.  No weight is
    gathered."""
    from torch.distributed.tensor import DTensor, Partial, Shard
    r = _ROWS
    out = x @ w.to_local().to(x.dtype)
    last = out.dim() - 1
    pl = []
    for px, pw in zip(r.placements(out.dim()), w.placements):
        pl.append(Partial() if pw.is_shard(0)
                  else Shard(last) if pw.is_shard(1) else px)
    shape = (x.shape[0] * (r.B // r.n),) + tuple(x.shape[1:-1]) \
        + (w.shape[1],)
    return DTensor.from_local(out, r.mesh, pl, run_check=False, shape=shape,
                              stride=_contiguous_stride(shape))


def reduce(x: torch.Tensor, axes: Axes) -> torch.Tensor:
    """This rank's partial sum ``x`` summed over the mesh ``axes`` (every
    rank gets the sum): a recurrent cell's contraction over a dim that
    its state shards."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mesh = _ROWS.mesh
    axes = live(mesh, axes)
    if not axes:
        return x
    pl = [Partial() if n in axes else Replicate()
          for n in mesh.mesh_dim_names]
    dt = DTensor.from_local(x.contiguous(), mesh, pl, run_check=False)
    return dt.redistribute(mesh, [Replicate()] * mesh.ndim).to_local()


def state_dims(name: str, shape: Tuple[int, ...]
               ) -> Tuple[Tuple[int, int, Axes], ...]:
    """(lo, hi, live mesh axes) of this rank's shard of each dim of a
    recurrent state leaf ``name`` of global ``shape`` (R, B, ...) under
    the state rules (``sharding.state_pspec``).  The mixers read which heads,
    channels or head dims they own from it, so that their local work
    always matches the leaves' shards."""
    mesh = _ROWS.mesh
    spec = state_pspec(mesh, (name,), torch.empty(shape, device="meta"))
    return tuple(shard_range(mesh, n, _axes(e)) + (live(mesh, _axes(e)),)
                 for n, e in zip(shape, spec))


def local_leaf(name: str, t: torch.Tensor, stacked: bool = True
               ) -> torch.Tensor:
    """A fresh recurrent state leaf made at its global shape as this
    rank's shard of it, contiguous (as is without a mesh): every dim past
    the batch's cut by the state rules, the batch dim already this
    rank's rows.  ``stacked``: ``t`` is (R, B, ...), else (B, ...)."""
    if _ROWS is None:
        return t
    shape = tuple(t.shape) if stacked else (1,) + tuple(t.shape)
    off = 0 if stacked else 1
    idx = [slice(None)] * t.dim()
    for d, (lo, hi, _) in enumerate(state_dims(name, shape)):
        if d >= 2:
            idx[d - off] = slice(lo, hi)
    return t[tuple(idx)].contiguous()


def gather(x: torch.Tensor, dim: int, axes: Axes, mesh=None,
           size: Optional[int] = None) -> torch.Tensor:
    """All-gather a local shard along ``dim`` over ``axes`` (a derived
    vector, or a cache shard a layer must read whole).  ``size``: the
    dim's global size when the shards are uneven (a pool's trash page)."""
    from torch.distributed.tensor import DTensor, Replicate
    mesh = mesh if mesh is not None else _ROWS.mesh
    axes = live(mesh, axes)
    if not axes:
        return x
    spec = [None] * x.dim()
    spec[dim] = _entry(axes)
    pl = to_placements(mesh, tuple(spec))
    if size is None:
        dt = DTensor.from_local(x, mesh, pl, run_check=False)
    else:
        shape = list(x.shape)
        shape[dim] = size
        dt = DTensor.from_local(x, mesh, pl, run_check=False,
                                shape=torch.Size(shape),
                                stride=_contiguous_stride(shape))
    return dt.redistribute(mesh, [Replicate()] * mesh.ndim).to_local()


def _contiguous_stride(shape) -> Tuple[int, ...]:
    out, acc = [], 1
    for n in reversed(shape):
        out.append(acc)
        acc *= n
    return tuple(reversed(out))


def gather_rows(x: torch.Tensor, rows: Optional[Rows] = None
                ) -> torch.Tensor:
    """(n, ...) local rows -> (B, ...) every row (a small derived vector:
    the page growth's per-row needs, a stop flag)."""
    r = rows or _ROWS
    return gather(x, 0, r.axes, r.mesh)


def distribute(x: torch.Tensor, mesh, spec: tuple, device=None):
    """A tensor that every rank holds whole (on the host, say) as the
    DTensor of ``spec``: each rank copies its own shard alone to
    ``device`` (default: ``x``'s), contiguous, with no communication; the
    engine places its parameters and state so, and a rank's device never
    holds more than its shards."""
    from torch.distributed.tensor import DTensor
    spec = tuple(spec) + (None,) * (x.dim() - len(spec))
    idx = tuple(slice(*shard_range(mesh, n, _axes(e)))
                for n, e in zip(x.shape, spec))
    local = x[idx].to(device=x.device if device is None else device,
                      copy=True, memory_format=torch.contiguous_format)
    return DTensor.from_local(local, mesh, to_placements(mesh, spec),
                              run_check=False, shape=x.shape,
                              stride=_contiguous_stride(x.shape))


def owned_write(flat: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor,
                ok: torch.Tensor) -> None:
    """``flat[idx[i]] = vals[i]`` where ``ok[i]``, IN PLACE and without a
    host read: the other entries repeat the first kept entry's write (its
    index and value), or rewrite ``flat[0]`` with itself when none is
    kept, so that duplicate indices always carry equal values.  flat:
    (M, ...); idx (n,) in [0, M) where ok; vals (n, ...)."""
    n = idx.shape[0]
    if n == 0:
        return
    # the first kept entry by index_select (a 0-dim index tensor would be
    # read on the host where it lies on the CPU)
    first = torch.argmax(ok.to(torch.int32)).view(1)
    any_ok = ok.any()
    idx0 = torch.where(any_ok, idx.index_select(0, first)[0], 0)
    val0 = torch.where(any_ok, vals.index_select(0, first)[0], flat[0])
    sel = ok.view((n,) + (1,) * (vals.dim() - 1))
    flat.index_put_((torch.where(ok, idx, idx0).long(),),
                    torch.where(sel, vals.to(flat.dtype), val0))
