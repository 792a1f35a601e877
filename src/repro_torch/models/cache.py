"""Decode state: the linear and the paged KV cache, slot management and
the speculative commit (port of ``repro/models/cache.py``).

State layout, as in the reference (every leaf stacked over the R periods
of the layer pattern):

  linear = {
    "cur_len": (B,) int32   — #positions committed per sequence,
    "groups": {gid: {"k": (R, B, S, KV, hd), "v": ...}        # attention
               gid: {"conv": (R, B, dc-1, di) compute dtype,  # Mamba
                     "ssm": (R, B, di, ds) float32},
               gid: {"C": (R, B, H, dh, dh), "n": (R, B, H, dh), # mLSTM
                     "m": (R, B, H) float32 (-1e9 empty),
                     "conv": (R, B, dc-1, di) compute dtype},
               gid: {"c", "n", "h": (R, B, H, dh),             # sLSTM
                     "m": (R, B, H, dh) float32 (-1e9 empty)}},
  }
  paged = {
    "cur_len": (B,) int32,
    "groups": {gid: {"k": (R, NP + 1, ps, KV, hd), "v": ...}, # shared pool
               gid: {"conv": ..., "ssm": ...}},   # recurrent: per slot,
                                                  # as linear
    "page_table": (B, PPS) int32   — physical page of each logical page,
                                     -1 = unallocated,
    "n_pages": (B,) int32,
    "free_list": (NP + 1,) int32   — stack of free pages, top at free_top,
    "free_top": () int32,
  }

Where the reference relies on buffer donation, the port updates the cache
in place (``index_put_``); every such write says so.

Where the reference scatters with JAX's ``mode="drop"`` (an out-of-bounds
index is skipped), PyTorch has no counterpart, and a clamped index would
write into another slot's page.  So each paged pool holds one spare TRASH
page past its ``NP`` real ones, and the free list one trash entry past its
``NP``: a dropped write lands there, without a host sync.  No page table
ever names the trash page (it is never on the free stack), so neither the
verify kernel nor ``gather_pages`` reads it.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..device import resolve_device
from ..distributed import local as L
# select_step_state (the gated replay's commit of a recurrent state) lives
# beside K5's plain version, whose n_commit selection it defines
from ..kernels.ref import gather_pages, select_step_state  # noqa: F401
from .config import ATTN, MAMBA, MLSTM, SLSTM, BlockSpec, ModelConfig
from .xlstm import M_EMPTY, mlstm_inner

__all__ = ["gather_pages"]   # re-exported: the plain paged read path


def cache_buffer_len(cfg: ModelConfig, max_len: int) -> int:
    """Physical KV buffer length: window-sized ring when sliding-window."""
    if cfg.sliding_window is not None and cfg.sliding_window < max_len:
        return cfg.sliding_window
    return max_len


def group_ids(cfg: ModelConfig):
    """(gid, BlockSpec, R) for prefix and body pattern positions."""
    out = []
    for i, b in enumerate(cfg.prefix_blocks):
        out.append((f"pre{i}", b, 1))
    for j, b in enumerate(cfg.block_pattern):
        out.append((f"p{j}", b, cfg.num_periods))
    return out


def _init_group(cfg: ModelConfig, spec: BlockSpec, R: int, batch: int,
                S: int, device) -> Dict:
    """Empty decode-state group for one layer position (linear ATTN
    layout; the recurrent mixers' per-slot states, each leaf its own
    buffer)."""
    f32 = dict(dtype=torch.float32, device=device)
    cd = dict(dtype=cfg.compute_dtype, device=device)
    if spec.mixer == MAMBA:
        di = cfg.mamba_d_inner
        return {"conv": torch.zeros((R, batch, cfg.mamba_d_conv - 1, di),
                                    **cd),
                "ssm": torch.zeros((R, batch, di, cfg.mamba_d_state), **f32)}
    if spec.mixer == MLSTM:
        di, nh = mlstm_inner(cfg), cfg.num_heads
        dh = di // nh
        return {"C": torch.zeros((R, batch, nh, dh, dh), **f32),
                "n": torch.zeros((R, batch, nh, dh), **f32),
                "m": torch.full((R, batch, nh), M_EMPTY, **f32),
                "conv": torch.zeros((R, batch, cfg.xlstm_conv_kernel - 1,
                                     di), **cd)}
    if spec.mixer == SLSTM:
        nh = cfg.num_heads
        shape = (R, batch, nh, cfg.d_model // nh)
        return {"c": torch.zeros(shape, **f32), "n": torch.zeros(shape, **f32),
                "h": torch.zeros(shape, **f32),
                "m": torch.full(shape, M_EMPTY, **f32)}
    if spec.mixer != ATTN:
        raise ValueError(spec.mixer)
    shape = (R, batch, S, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, **cd), "v": torch.zeros(shape, **cd)}


def attn_groups(state: Dict) -> Dict[str, Dict]:
    """The attention groups (those holding a KV cache or pool) of a
    state."""
    return {gid: g for gid, g in state["groups"].items() if "k" in g}


def _recurrent_groups(state: Dict) -> Dict[str, Dict]:
    return {gid: g for gid, g in state["groups"].items() if "k" not in g}


def init_state(cfg: ModelConfig, batch: int, max_len: int,
               device="cuda") -> Dict:
    """Allocate an empty decode state for ``batch`` sequences."""
    dev = resolve_device(device)
    S = cache_buffer_len(cfg, max_len)
    groups = {}
    for gid, spec, R in group_ids(cfg):
        g = _init_group(cfg, spec, R, batch, S, dev)
        # under a mesh a rank allocates its rows; its recurrent leaves are
        # its shards of them (the attention caches follow the caller's cfg)
        groups[gid] = g if spec.mixer == ATTN else {
            n: L.local_leaf(n, t) for n, t in g.items()}
    return {"cur_len": torch.zeros((batch,), dtype=torch.int32, device=dev),
            "groups": groups}


# ----------------------------------------------------------------------------
# slot management (continuous batching)
# ----------------------------------------------------------------------------
def insert_slot(state: Dict, row_state: Dict, slot: int) -> Dict:
    """Overwrite batch slot ``slot`` of a linear ``state`` with a batch-1
    state, IN PLACE.  ``row_state`` comes from prefilling one request alone
    (batch 1, same buffer length); every leaf of the previous occupant is
    replaced, so request N+1 in a reused slot cannot observe request N's
    cache."""
    for gid, g in state["groups"].items():
        for name, leaf in g.items():
            row = row_state["groups"][gid][name]
            if leaf.shape[2:] != row.shape[2:] or row.shape[1] != 1:
                raise ValueError(f"slot insert shape mismatch: "
                                 f"{tuple(leaf.shape)} vs {tuple(row.shape)}")
            leaf[:, slot] = row[:, 0]
    state["cur_len"][slot] = row_state["cur_len"][0]
    return state


def zero_slot_stats(stats: Dict[str, torch.Tensor], slot: int) -> Dict:
    """Zero batch slot ``slot``'s row in every per-slot stats array, IN
    PLACE (any trailing shape: counters (B,) and histograms (B, n))."""
    for v in stats.values():
        v[slot] = 0
    return stats


def reset_recurrent(state: Dict, slot: int) -> Dict:
    """Slot ``slot``'s recurrent leaves to the empty state, IN PLACE:
    zeros, and -1e9 for the xLSTM stabilisers "m" (the leaves may be a
    rank's shards: every element of a shard is reset the same way)."""
    for g in _recurrent_groups(state).values():
        for name, leaf in g.items():
            leaf[:, slot] = M_EMPTY if name == "m" else 0
    return state


def reset_slot(cfg: ModelConfig, state: Dict, slot: int) -> Dict:
    """Reset slot ``slot`` to the empty state, IN PLACE.  Paged states free
    the slot's pages instead of zeroing KV (a freed page is never read:
    ``phys_slots`` maps unallocated positions to the trash page) and reset
    the slot's recurrent state to the empty one (zeros; the xLSTM
    stabilisers' -1e9)."""
    if is_paged(state):
        free_slot_pages(state, slot)
        reset_recurrent(state, slot)
        state["cur_len"][slot] = 0
        return state
    S = next((g["k"].shape[2] for g in attn_groups(state).values()), 1)
    empty = init_state(cfg, 1, S, device=state["cur_len"].device)
    return insert_slot(state, empty, slot)


# ----------------------------------------------------------------------------
# paged KV cache
# ----------------------------------------------------------------------------
def default_page_size(cfg: ModelConfig) -> int:
    """Pages of 64 keys: a whole number of the verify kernel's key tiles
    (64 or 32 keys, ``kernels/csrc/spec_attention.cu``), so no tile that
    K3 stages in shared memory spans two pages.  (The reference ties
    pages to its TPU kernel's 512-slot VMEM block instead.)  Any
    page_size >= 1 is right."""
    del cfg
    return 64


def paged_supported(cfg: ModelConfig) -> bool:
    """Paged layout implements linear-cache semantics only: sliding-window
    ring caches keep the per-slot ring buffer, and at least one attention
    group must exist for paging to mean anything."""
    return (cfg.sliding_window is None
            and any(spec.mixer == ATTN for _, spec, _ in group_ids(cfg)))


def is_paged(state: Dict) -> bool:
    return "page_table" in state


def paged_dims(state: Dict) -> Tuple[int, int, int]:
    """(num_pages, page_size, pages_per_slot) of a paged state; num_pages
    counts the real pages, not the trash page (the whole pool's under a
    mesh that shards its pages)."""
    pool = next(iter(attn_groups(state).values()))["k"]
    n_pg = pool.shape[1]
    rows = L.current()
    if rows is not None and rows.cache.pool_pages:
        n_pg = rows.cache.pool_pages
    return n_pg - 1, pool.shape[2], state["page_table"].shape[1]


def init_paged_state(cfg: ModelConfig, batch: int, num_pages: int,
                     page_size: int, pages_per_slot: int,
                     device="cuda") -> Dict:
    """Allocate an empty PAGED decode state: attention groups hold a shared
    (R, num_pages + 1, page_size, KV, hd) pool (the last page is the trash
    page), all real pages start on the free stack, and every slot's page
    table is empty.  Recurrent groups stay per slot (O(1) in length)."""
    if not paged_supported(cfg):
        raise ValueError(f"{cfg.name}: paged KV requires a linear-cache "
                         f"attention arch (sliding_window=None, >=1 attn "
                         f"layer)")
    if num_pages < 1 or page_size < 1 or pages_per_slot < 1:
        raise ValueError(f"need num_pages, page_size, pages_per_slot >= 1, "
                         f"got {num_pages}, {page_size}, {pages_per_slot}")
    dev = resolve_device(device)
    hd = cfg.resolved_head_dim
    groups = {}
    for gid, spec, R in group_ids(cfg):
        if spec.mixer != ATTN:
            groups[gid] = _init_group(cfg, spec, R, batch, 0, dev)
            continue
        shape = (R, num_pages + 1, page_size, cfg.num_kv_heads, hd)
        groups[gid] = {"k": torch.zeros(shape, dtype=cfg.compute_dtype,
                                        device=dev),
                       "v": torch.zeros(shape, dtype=cfg.compute_dtype,
                                        device=dev)}
    i32 = dict(dtype=torch.int32, device=dev)
    return {"cur_len": torch.zeros((batch,), **i32),
            "groups": groups,
            "page_table": torch.full((batch, pages_per_slot), -1, **i32),
            "n_pages": torch.zeros((batch,), **i32),
            "free_list": torch.arange(num_pages + 1, **i32),
            "free_top": torch.tensor(num_pages, **i32)}


def pages_for_len(length, page_size: int):
    """Pages needed to hold ``length`` positions (int or tensor)."""
    return (length + page_size - 1) // page_size


def phys_slots(page_table: torch.Tensor, pos: torch.Tensor, page_size: int,
               num_pages: int) -> torch.Tensor:
    """Physical pool slot of each logical position.  pos: (B, T).

    Positions without an allocated page map to ``num_pages * page_size``,
    the first slot of the trash page (the reference's out-of-bounds
    sentinel, which its scatter drops).  (B, T) int64.
    """
    PPS = page_table.shape[1]
    pos = pos.long()
    pg = torch.div(pos, page_size, rounding_mode="floor")
    pid = page_table.gather(1, pg.clamp(0, PPS - 1)).long()
    ok = (pos >= 0) & (pg < PPS) & (pid >= 0)
    return torch.where(ok, pid * page_size + torch.remainder(pos, page_size),
                       num_pages * page_size)


def paged_kv_write(k_pool: torch.Tensor, v_pool: torch.Tensor,
                   k_new: torch.Tensor, v_new: torch.Tensor,
                   phys: torch.Tensor,
                   gate: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter new KV into the shared pool, IN PLACE.

    pools: (..., NP + 1, ps, KV, hd), contiguous, with any leading dims
    (the R periods of a group); k_new/v_new: (..., B, T, KV, hd) with the
    same leading dims; phys: (B, T) physical slots (``phys_slots``); gate:
    (B, T) bool, write where True.  Distinct slots own distinct pages, so
    real writes never collide; gated-off and unallocated writes land on the
    trash page.  Returns the pools.

    Under a mesh whose pool is shared by the ranks' rows
    (``distributed/local.py``), every rank applies every row's writes that
    fall in its own page shard.
    """
    rows = L.current()
    if rows is not None and rows.cache.shared_pool:
        _paged_kv_write_mesh(rows, k_pool, v_pool, k_new, v_new, phys, gate)
        return k_pool, v_pool
    lead = k_pool.shape[:-4]
    slots = k_pool.shape[-4] * k_pool.shape[-3]
    trash = (k_pool.shape[-4] - 1) * k_pool.shape[-3]
    if gate is not None:
        phys = torch.where(gate, phys, trash)
    n_lead = 1
    for d in lead:
        n_lead *= d
    idx = phys.reshape(1, -1) + (torch.arange(n_lead, device=phys.device)
                                 * slots)[:, None]
    tail = k_pool.shape[-2:]
    for pool, new in ((k_pool, k_new), (v_pool, v_new)):
        pool.view((n_lead * slots,) + tail).index_put_(
            (idx.reshape(-1),),
            new.reshape((-1,) + tail).to(pool.dtype))
    return k_pool, v_pool


def _paged_kv_write_mesh(rows, k_pool, v_pool, k_new, v_new, phys, gate
                         ) -> None:
    """``paged_kv_write`` into this rank's shard of a shared pool: the
    writes of every rank's rows are gathered (a slot's pages may sit on any
    shard) and each lands where its page is local."""
    if gate is not None:
        phys = torch.where(gate, phys, -1)
    phys = L.gather_rows(phys, rows)
    nd = k_new.dim()
    k_new, v_new = (L.gather(t, nd - 4, rows.axes, rows.mesh)
                    for t in (k_new, v_new))
    n_pg, ps = k_pool.shape[-4], k_pool.shape[-3]
    lo, _ = L.shard_range(rows.mesh, rows.cache.pool_pages,
                          rows.cache.pages)
    loc = phys - lo * ps
    ok = (phys >= 0) & (loc >= 0) & (loc < n_pg * ps)
    n_lead = k_pool.numel() // (n_pg * ps * k_pool.shape[-2]
                                * k_pool.shape[-1])
    idx = (loc.clamp(min=0).reshape(1, -1)
           + (torch.arange(n_lead, device=phys.device) * n_pg * ps)[:, None])
    ok = ok.reshape(1, -1).expand(n_lead, -1).reshape(-1)
    tail = k_pool.shape[-2:]
    for pool, new in ((k_pool, k_new), (v_pool, v_new)):
        L.owned_write(pool.view((n_lead * n_pg * ps,) + tail),
                      idx.reshape(-1), new.reshape((-1,) + tail), ok)


def alloc_row(free_list: torch.Tensor, free_top: torch.Tensor,
              row: torch.Tensor, cur, n_new
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pop ``n_new`` pages off the free stack after a page-table ``row``'s
    ``cur`` allocated pages: returns (the new row, its page count) and
    lowers ``free_top`` IN PLACE."""
    PPS, N = row.shape[0], free_list.shape[0] - 1
    j = torch.arange(PPS, device=row.device) - cur   # j-th newly-added page
    take = (j >= 0) & (j < n_new)
    src = free_top - 1 - j
    grant = take & (src >= 0) & (src < N)
    new = torch.where(grant, free_list[src.clamp(0, N - 1)], row)
    free_top.copy_((free_top - n_new).clamp(min=0))
    return new, cur + grant.sum().to(torch.int32)


def push_row(free_list: torch.Tensor, free_top: torch.Tensor,
             row: torch.Tensor, n) -> None:
    """Push a page-table ``row``'s first ``n`` pages back onto the free
    stack, IN PLACE."""
    PPS, N = row.shape[0], free_list.shape[0] - 1
    idx = torch.arange(PPS, device=row.device)
    dst = torch.where(idx < n, free_top + idx, N).clamp(max=N).long()
    free_list.index_put_((dst,), row)                # N: the trash entry
    free_top.add_(n)


def alloc_slot_pages(state: Dict, slot: int, n_new) -> Dict:
    """Pop ``n_new`` pages off the free stack into ``slot``'s page table
    (after its allocated pages), IN PLACE and without a host sync.  The
    caller guarantees n_new <= free_top (the serving engine's reservation
    admission does)."""
    pt, npg = state["page_table"], state["n_pages"]
    pt[slot], npg[slot] = alloc_row(state["free_list"], state["free_top"],
                                    pt[slot], npg[slot], n_new)
    return state


def free_slot_pages(state: Dict, slot: int) -> Dict:
    """Push every page of ``slot`` back onto the free stack and clear its
    table, IN PLACE.  Idempotent: a slot with n_pages == 0 is a no-op."""
    pt, npg = state["page_table"], state["n_pages"]
    push_row(state["free_list"], state["free_top"], pt[slot], npg[slot])
    pt[slot] = -1
    npg[slot] = 0
    return state


def grow_pages(state: Dict, required_len: torch.Tensor,
               active: torch.Tensor) -> Dict:
    """Batched growth, IN PLACE and sync-free: every ``active`` slot gets
    pages covering ``required_len`` positions (spec_step calls this each
    iteration with cur_len + w + 1, so commits never outrun the table).
    On exhaustion a slot's missing pages stay -1 (its writes go to the trash
    page, its reads are masked); the engine's reservation admission keeps
    that unreachable in serving."""
    pt, npg = state["page_table"], state["n_pages"]
    fl, ft = state["free_list"], state["free_top"]
    PPS, N = pt.shape[1], fl.shape[0] - 1
    ps = paged_dims(state)[1]
    need = (pages_for_len(required_len, ps) - npg).clamp(min=0)
    need = torch.where(active, need, 0).to(torch.int32)
    rows = L.current()
    if rows is not None and rows.cache.shared_pool and rows.axes:
        # a pool shared by every rank's rows: allocate in global row order
        need_all = L.gather_rows(need, rows)
        offs = (torch.cumsum(need_all, 0) - need_all)[rows.lo:rows.hi]
        total = need_all.sum()
    else:
        offs = torch.cumsum(need, 0) - need          # exclusive prefix (B,)
        total = need.sum()
    j = torch.arange(PPS, device=pt.device)[None, :] - npg[:, None]
    take = (j >= 0) & (j < need[:, None])
    src = ft - 1 - (offs[:, None] + j)
    grant = take & (src >= 0)
    pt.copy_(torch.where(grant, fl[src.clamp(0, N - 1)], pt))
    npg.add_(grant.sum(dim=1).to(torch.int32))
    ft.copy_((ft - total).clamp(min=0))
    return state


def insert_slot_paged(state: Dict, row_state: Dict, slot: int,
                      row_len: int) -> Dict:
    """Paged counterpart of insert_slot: scatter a prefilled batch-1 LINEAR
    row state (cur_len == row_len) into the pool pages already allocated to
    ``slot`` (``alloc_slot_pages`` first), IN PLACE; recurrent leaves copy
    as in ``insert_slot``."""
    N, ps, _ = paged_dims(state)
    pos = torch.arange(row_len, device=state["page_table"].device)[None]
    phys = phys_slots(state["page_table"][slot][None], pos, ps, N)
    for gid, g in state["groups"].items():
        row = row_state["groups"][gid]                # (R, 1, row_len, ..)
        if "k" not in g:
            for name, leaf in g.items():
                leaf[:, slot] = row[name][:, 0]
            continue
        paged_kv_write(g["k"], g["v"], row["k"][:, :, :row_len],
                       row["v"][:, :, :row_len], phys)
    state["cur_len"][slot] = row_state["cur_len"][0]
    return state


def check_page_invariants(state: Dict) -> Dict:
    """Host-side free-list/page-table audit (tests and debugging).

    Asserts: allocated pages are unique, disjoint from the free stack, and
    together with it cover exactly {0..num_pages-1}; every page table row is
    n_pages valid entries followed by -1s.  Returns summary counts.
    """
    N = state["free_list"].shape[0] - 1
    # repro-lint: allow(tensor-branch): a host-side audit, outside the step
    pt, npg, fl, ft = (L.whole(state[k]).cpu().numpy() for k in (
        "page_table", "n_pages", "free_list", "free_top"))
    fl, ft = fl[:N], int(ft)
    allocated = []
    for b in range(pt.shape[0]):
        row, n = pt[b], int(npg[b])
        assert (row[:n] >= 0).all() and (row[:n] < N).all(), (b, row, n)
        assert (row[n:] == -1).all(), (b, row, n)
        allocated.extend(row[:n].tolist())
    free = fl[:ft].tolist()
    assert len(set(allocated)) == len(allocated), "page double-mapped"
    assert not (set(allocated) & set(free)), "allocated page on free stack"
    assert set(allocated) | set(free) == set(range(N)), (
        f"page leak: {sorted(set(range(N)) - set(allocated) - set(free))}")
    return {"num_pages": N, "free": ft, "allocated": len(allocated)}


# ----------------------------------------------------------------------------
# position bookkeeping
# ----------------------------------------------------------------------------
def key_positions(cfg: ModelConfig, S: int,
                  cur_len: torch.Tensor) -> torch.Tensor:
    """Absolute position stored in each cache slot; -1 where empty.

    cur_len: (B,). Linear cache: slot s holds position s if s < cur_len.
    Ring cache (window W=S): slot s holds the largest p < cur_len with
    p % W == s, valid if p >= 0 and p >= cur_len - W.
    """
    B = cur_len.shape[0]
    slots = torch.arange(S, device=cur_len.device)[None, :]
    cl = cur_len[:, None]
    if cfg.sliding_window is not None and cfg.sliding_window <= S:
        p = cl - 1 - torch.remainder(cl - 1 - slots, S)
        valid = (p >= 0) & (p >= cl - S) & (cl > 0)
        return torch.where(valid, p, -1).to(torch.int32)
    pos = slots.expand(B, S)
    return torch.where(pos < cl, pos, -1).to(torch.int32)


def write_slots(cfg: ModelConfig, S: int, cur_len: torch.Tensor,
                T_new: int) -> torch.Tensor:
    """Cache slots for the next T_new positions. (B, T_new) int64."""
    pos = (cur_len[:, None].long()
           + torch.arange(T_new, device=cur_len.device)[None, :])
    if cfg.sliding_window is not None and cfg.sliding_window <= S:
        return torch.remainder(pos, S)
    return pos


def kv_write(k_cache: torch.Tensor, v_cache: torch.Tensor,
             k_new: torch.Tensor, v_new: torch.Tensor,
             slots: torch.Tensor,
             gate: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write new KV into slots, IN PLACE.  caches: (N, S, KV, hd); new:
    (N, T, KV, hd); slots: (N, T).  ``gate``: (N, T) bool — write only where
    True (spec commit).  Returns the updated caches.

    Slots outside [0, S) are dropped, as the reference's scatter drops them;
    a dropped or gated-off position rewrites the value already at its
    (clamped) slot, so the caller keeps in-range writes off slot S-1 when a
    row also drops writes (the engine's buffers always leave that margin).
    """
    N, T = slots.shape
    S = k_cache.shape[1]
    rows = L.current()
    if rows is not None and rows.cache.seq:
        _kv_write_seq_mesh(rows, k_cache, v_cache, k_new, v_new, slots, gate)
        return k_cache, v_cache
    keep = (slots >= 0) & (slots < S)
    if gate is not None:
        keep = keep & gate
    idx = slots.clamp(0, S - 1)
    n_idx = torch.arange(N, device=slots.device)[:, None].expand(N, T)
    m = keep[..., None, None]
    for cache, new in ((k_cache, k_new), (v_cache, v_new)):
        old = cache[n_idx, idx]
        cache.index_put_((n_idx, idx),
                         torch.where(m, new.to(cache.dtype), old))
    return k_cache, v_cache


def _kv_write_seq_mesh(rows, k_cache, v_cache, k_new, v_new, slots, gate
                       ) -> None:
    """``kv_write`` into this rank's sequence shard of a linear cache
    whose sequence is sharded over the mesh (``state_pspec``'s fallback
    when the kv heads do not divide the model axis)."""
    N, S_loc = k_cache.shape[:2]
    n_sh = L.ways(rows.mesh, rows.cache.seq)
    lo, _ = L.shard_range(rows.mesh, S_loc * n_sh, rows.cache.seq)
    loc = slots - lo
    ok = (slots >= 0) & (slots < S_loc * n_sh) & (loc >= 0) & (loc < S_loc)
    if gate is not None:
        ok = ok & gate
    idx = (torch.arange(N, device=slots.device)[:, None] * S_loc
           + loc.clamp(0, S_loc - 1))
    tail = k_cache.shape[2:]
    for cache, new in ((k_cache, k_new), (v_cache, v_new)):
        L.owned_write(cache.view((N * S_loc,) + tail), idx.reshape(-1),
                      new.reshape((-1,) + tail), ok.reshape(-1))


def prefill_write(cfg: ModelConfig, k_cache, v_cache, k_new, v_new,
                  seq_mask: Optional[torch.Tensor] = None):
    """Write a full prefill block (positions 0..T-1) into an empty cache,
    IN PLACE.  With a ring cache shorter than the prompt only the last S
    positions land (ring semantics)."""
    B, T = k_new.shape[:2]
    S = k_cache.shape[1]
    if T > S:
        k_new, v_new = k_new[:, -S:], v_new[:, -S:]
        if seq_mask is not None:
            seq_mask = seq_mask[:, -S:]
        off = torch.full((B,), T - S, dtype=torch.int32,
                         device=k_new.device)
        slots = write_slots(cfg, S, off, S)
        return kv_write(k_cache, v_cache, k_new, v_new, slots, gate=seq_mask)
    cur0 = torch.zeros((B,), dtype=torch.int32, device=k_new.device)
    slots = write_slots(cfg, S, cur0, T)
    return kv_write(k_cache, v_cache, k_new, v_new, slots, gate=seq_mask)
