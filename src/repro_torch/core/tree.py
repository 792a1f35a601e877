"""Static draft-tree topology for tree-structured batched speculation (port
of ``repro/core/tree.py``).  Under adaptive arms one (width_max, depth_max)
topology serves every (width, depth) arm: ``path_max_branch`` masks a slot
down to its width, acceptance to its depth.

Tree speculation verifies ONE token tree per slot instead of k independent
w-token rows: the first ``branch`` depths fan out over the drafter's
top-``width`` candidates and every leaf continues as a chain, so shared
prefixes are scored once.  The topology is host numpy computed from the
static ints (width, depth, branch), as in the reference.

Node/tuple convention: a node at depth ``l`` (1-based) is identified by its
branch tuple ``(b_1, .., b_l)`` with ``b_j < width`` for ``j <= branch`` and
``b_j == 0`` beyond; nodes are enumerated level-major, lexicographically
within a level, so a parent's id is below its child's and the leaf paths
come out in lexicographic tuple order.

The *verify inputs* are ``[root] + nodes``: input 0 is the last committed
token, input ``i+1`` is node ``i``; ``anc_mask[i, j]`` lets input i attend
input j iff j is an ancestor-or-self of i, so each root-to-leaf path behaves
like a linear draft row of the same tokens.

Two things differ from the reference, both because the port runs eagerly:
  - ``fill_tree`` fills the tree LEVEL by level, a handful of gathers over
    index arrays that ``fill_plan`` precomputes, instead of the reference's
    loop over every node (free under jit, several device ops per node
    eagerly).  The tokens are the same, bit for bit.
  - ``device_constants`` builds the per-topology tensors a step needs (query
    offsets, the tail mask in both kernel forms, path tables, the fill
    plan) once per (topology, device), so a step copies nothing from the
    host.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..kernels.spec_attention import TreeMask, tree_mask


class TreeTopology(NamedTuple):
    """Static tree layout (all numpy; see module docstring for conventions)."""
    width: int
    depth: int
    branch: int
    parent: np.ndarray           # (N,) int32 parent node id, -1 = root
    level: np.ndarray            # (N,) int32 1-based depth of each node
    child: np.ndarray            # (N,) int32 branch-candidate index b_l
    spine: np.ndarray            # (N,) bool — tuple is (b_1, 0, .., 0)
    spine_row: np.ndarray        # (N,) int32 b_1 (the drafter row a spine tracks)
    sibling0: np.ndarray         # (N,) int32 node id of the parent's child 0
    path_nodes: np.ndarray       # (P, depth) int32 node ids along each leaf path
    path_inputs: np.ndarray      # (P, depth+1) int32 verify-input ids (root=0)
    path_max_branch: np.ndarray  # (P,) int32 max tuple entry (width masking)
    path_first: np.ndarray       # (P,) int32 b_1 of each path
    pos_off: np.ndarray          # (N+1,) int32 query-position offset per input
    anc_mask: np.ndarray         # (N+1, N+1) bool ancestor-or-self visibility

    @property
    def num_nodes(self) -> int:
        return int(self.parent.shape[0])

    @property
    def num_paths(self) -> int:
        return int(self.path_nodes.shape[0])


def effective_branch(depth: int, branch: int) -> int:
    return max(1, min(branch, depth)) if depth > 0 else 0


def num_nodes(width: int, depth: int, branch: int) -> int:
    """Node count of topology(width, depth, branch) without building it."""
    d = effective_branch(depth, branch)
    branched = sum(width ** j for j in range(1, d + 1))
    return branched + (width ** d) * (depth - d)


def num_paths(width: int, depth: int, branch: int) -> int:
    return width ** effective_branch(depth, branch) if depth > 0 else 0


@functools.lru_cache(maxsize=None)
def topology(width: int, depth: int, branch: int) -> TreeTopology:
    """The static topology of a (width, depth, branch) tree: levels
    1..min(branch, depth) fan out ``width`` children per node, deeper levels
    extend every leaf with one chain child.  Cached per (width, depth,
    branch)."""
    if width < 1 or depth < 1 or branch < 1:
        raise ValueError(
            f"tree needs width >= 1, depth >= 1, branch >= 1; got "
            f"({width}, {depth}, {branch})")
    d = effective_branch(depth, branch)
    parent, level, child, spine, spine_row, sibling0 = [], [], [], [], [], []
    prev: list = [(-1, ())]                       # (node id, tuple) per leaf
    for lvl in range(1, depth + 1):
        wmax = width if lvl <= d else 1
        cur = []
        for pid, pt in prev:
            c0 = len(parent)                      # id the 0-child will get
            for b in range(wmax):
                nid = len(parent)
                t = pt + (b,)
                parent.append(pid)
                level.append(lvl)
                child.append(b)
                spine.append(all(x == 0 for x in t[1:]))
                spine_row.append(t[0])
                sibling0.append(c0)
                cur.append((nid, t))
        prev = cur
    N = len(parent)
    P = len(prev)
    path_nodes = np.zeros((P, depth), np.int32)
    path_max_branch = np.zeros((P,), np.int32)
    path_first = np.zeros((P,), np.int32)
    for p, (nid, t) in enumerate(prev):
        n = nid
        for j in range(depth - 1, -1, -1):
            path_nodes[p, j] = n
            n = parent[n]
        path_max_branch[p] = max(t)
        path_first[p] = t[0]
    path_inputs = np.concatenate(
        [np.zeros((P, 1), np.int32), path_nodes + 1], axis=1)
    anc = np.zeros((N + 1, N + 1), bool)
    anc[0, 0] = True                              # root attends itself
    anc[1:, 0] = True                             # every node attends root
    for i in range(N):
        anc[i + 1, i + 1] = True
        a = parent[i]
        while a >= 0:
            anc[i + 1, a + 1] = True
            a = parent[a]
    return TreeTopology(
        width=width, depth=depth, branch=branch,
        parent=np.asarray(parent, np.int32),
        level=np.asarray(level, np.int32),
        child=np.asarray(child, np.int32),
        spine=np.asarray(spine, bool),
        spine_row=np.asarray(spine_row, np.int32),
        sibling0=np.asarray(sibling0, np.int32),
        path_nodes=path_nodes,
        path_inputs=path_inputs,
        path_max_branch=path_max_branch,
        path_first=path_first,
        pos_off=np.concatenate([np.zeros((1,), np.int32),
                                np.asarray(level, np.int32)]),
        anc_mask=anc)


# ---------------------------------------------------------------------------
# the level-wise fill plan and the per-device constants
# ---------------------------------------------------------------------------
class FillLevel(NamedTuple):
    """The off-spine nodes of one level and what ``fill_tree`` reads for
    them (numpy int64 in ``fill_plan``, device tensors in
    ``device_constants``)."""
    nodes: object        # (n,) node ids
    parents: object      # (n,) parent ids
    child: object        # (n,) branch-candidate index b_l
    sibling0: object     # (n,) the parent's 0-child (read where ``dedup``)
    dedup: object        # (n,) bool: the parent is on a spine
    grand: object        # (n,) grandparent ids; None: the grandparent is
                         # the root (level 2)
    chain: bool          # a level below the branch levels (context-seeded
                         # when the committed buffer is given)
    any_dedup: bool


class FillPlan(NamedTuple):
    spine_nodes: object  # (ns,) every spine node, all levels
    spine_flat: object   # (ns,) its index into drafts.reshape(B, k*w)
    levels: Tuple[FillLevel, ...]


@functools.lru_cache(maxsize=None)
def fill_plan(width: int, depth: int, branch: int) -> FillPlan:
    """Host index arrays of the level-wise ``fill_tree``.  Spine nodes
    replay drafter rows and are filled first, all levels in one gather; an
    off-spine node reads only its parent, its grandparent and its parent's
    0-child (a spine node of its own level), so each level is filled after
    the spine and the levels above it."""
    topo = topology(width, depth, branch)
    d = effective_branch(depth, branch)
    i64 = lambda a: np.asarray(a, np.int64)
    sp = np.flatnonzero(topo.spine)
    spine_flat = topo.spine_row[sp] * depth + topo.level[sp] - 1
    levels = []
    for lvl in range(2, depth + 1):
        nodes = np.flatnonzero((topo.level == lvl) & ~topo.spine)
        if nodes.size == 0:
            continue
        par = topo.parent[nodes]
        dedup = topo.spine[par]
        levels.append(FillLevel(
            nodes=i64(nodes), parents=i64(par), child=i64(topo.child[nodes]),
            sibling0=i64(topo.sibling0[nodes]), dedup=dedup,
            grand=None if lvl == 2 else i64(topo.parent[par]),
            chain=lvl > d, any_dedup=bool(dedup.any())))
    return FillPlan(i64(sp), i64(spine_flat), tuple(levels))


class TreeConstants(NamedTuple):
    """The per-topology tensors of a tree step, on one device."""
    pos_off: torch.Tensor        # (N+1,) int64 query-position offsets
    tail_mask: TreeMask          # ancestor visibility, both kernel forms
    path_nodes: torch.Tensor     # (P, depth) int64
    path_inputs: torch.Tensor    # (P, depth+1) int64
    path_first: torch.Tensor     # (P,) int32
    plan: FillPlan               # fill_plan with device index tensors


@functools.lru_cache(maxsize=None)
def device_constants(width: int, depth: int, branch: int,
                     device: torch.device) -> TreeConstants:
    """Every per-topology constant of a tree step as tensors on ``device``,
    built once and cached: a step then makes no host-to-device copy."""
    topo = topology(width, depth, branch)
    plan = fill_plan(width, depth, branch)
    on = lambda a, dt=torch.int64: torch.as_tensor(
        np.asarray(a), dtype=dt, device=device)
    levels = tuple(lv._replace(
        nodes=on(lv.nodes), parents=on(lv.parents), child=on(lv.child),
        sibling0=on(lv.sibling0), dedup=on(lv.dedup, torch.bool),
        grand=None if lv.grand is None else on(lv.grand))
        for lv in plan.levels)
    return TreeConstants(
        pos_off=on(topo.pos_off),
        tail_mask=tree_mask(topo.anc_mask, device),
        path_nodes=on(topo.path_nodes),
        path_inputs=on(topo.path_inputs),
        path_first=on(topo.path_first, torch.int32),
        plan=FillPlan(on(plan.spine_nodes), on(plan.spine_flat), levels))


# ---------------------------------------------------------------------------
# filling the tree with tokens
# ---------------------------------------------------------------------------
def _context_next(buf: torch.Tensor, buf_len: torch.Tensor,
                  gp: torch.Tensor, p: torch.Tensor,
                  fallback: torch.Tensor) -> torch.Tensor:
    """Buffer-local continuation of the (grandparent, parent) token pairs.

    buf (B, S); buf_len (B,); gp, p, fallback (B, n) (gp may be (B, 1)).
    For each pair, finds the LATEST committed position j with
    ``buf[j] == gp`` and ``buf[j+1] == p`` whose continuation ``buf[j+2]``
    is itself committed and returns that continuation; pairs with no such
    occurrence keep ``fallback`` (the global bigram argmax)."""
    S = buf.shape[1]
    pos = torch.arange(S - 1, device=buf.device)
    m = ((buf[:, None, :-1] == gp[..., None])
         & (buf[:, None, 1:] == p[..., None])
         & ((pos[None, :] + 2) < buf_len[:, None])[:, None, :])
    j = torch.where(m, pos, -1).amax(dim=-1)                 # (B, n)
    cont = buf.gather(1, (j + 2).clamp(0, S - 1))
    return torch.where(j >= 0, cont, fallback)


def fill_tree(topo: TreeTopology, drafts: torch.Tensor, tables,
              buf: Optional[torch.Tensor] = None,
              buf_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token content for every tree node: (B, k, w) linear drafts -> (B, N)
    int32, on the drafts' device.

    Spine nodes (tuple (b, 0, .., 0)) replay drafter row b verbatim, so the
    tree's path set is a superset of the linear draft rows.  Off-spine
    children of a node with token t take the model-bigram top candidates
    ``tables.bigram_topk[t]``; children of a *spine* parent skip the
    candidate equal to the spine continuation (it is already the 0-child),
    so a branch level never verifies the same token twice.

    With the committed buffer (``buf``/``buf_len``) the chain tails below
    the branch levels are context-seeded: each chain child looks up the
    buffer-local order-2 n-gram of its (grandparent, parent) tokens and
    copies what followed, falling back to the bigram argmax.

    The same tokens as the reference's node loop, filled level by level
    (``fill_plan``).  Token correctness is not assumed anywhere:
    verification rejects any wrong token.
    """
    big = tables.bigram_topk
    kmax = int(big.shape[1])
    if kmax < topo.width:
        raise ValueError(
            f"tree width {topo.width} needs bigram tables with k_max >= "
            f"width, got k_max={kmax}")
    B, k, w = drafts.shape
    if (k, w) != (topo.width, topo.depth):
        raise ValueError(f"drafts (B, {k}, {w}) do not fit the "
                         f"({topo.width}, {topo.depth}) tree")
    dev = drafts.device
    c = device_constants(topo.width, topo.depth, topo.branch, dev).plan
    toks = torch.empty((B, topo.num_nodes), dtype=torch.int32, device=dev)
    toks[:, c.spine_nodes] = drafts.reshape(B, k * w)[:, c.spine_flat].to(
        torch.int32)
    last = None
    if buf is not None:
        # a free slot (buf_len 0) reads its last entry, as a wrapping index
        last = buf.gather(1, torch.remainder(buf_len - 1, buf.shape[1])[
            :, None].long())
    for lv in c.levels:
        p_tok = toks[:, lv.parents]                           # (B, n)
        cands = big[p_tok.long()]                             # (B, n, kmax)
        if buf is not None and lv.chain:
            # chain tail: context-seed from the committed buffer (the
            # grandparent of a level-2 node is the root, the last token)
            gp = last if lv.grand is None else toks[:, lv.grand]
            t = _context_next(buf, buf_len, gp, p_tok, cands[..., 0])
        else:
            idx = lv.child.expand(B, -1)
            if lv.any_dedup:
                # a spine parent's 0-child is the drafter row's own
                # continuation: take candidate c-1, skipping over the one
                # candidate that duplicates it
                s_tok = toks[:, lv.sibling0]
                m = cands[..., :topo.width] == s_tok[..., None]
                j_dup = torch.where(m.any(dim=-1),
                                    torch.argmax(m.to(torch.int32), dim=-1),
                                    kmax + 1)
                base = lv.child - 1
                idx = torch.where(lv.dedup, base + (j_dup <= base).long(),
                                  idx)
            t = cands.gather(-1, idx[..., None])[..., 0]
        toks[:, lv.nodes] = t.to(torch.int32)
    return toks
