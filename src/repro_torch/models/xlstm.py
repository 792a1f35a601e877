"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory), the
mixers of xLSTM-125M (port of ``repro/models/xlstm.py``).

  - mLSTM block: up-projection (pf 2) -> causal conv + silu -> q/k/v ->
    matrix-memory cell with exponential gating and a stabiliser ->
    per-head group norm -> skip -> gate with silu(z) -> down-projection.
  - sLSTM block: headwise recurrent cell (h_{t-1} feeds the gates, so it
    is sequential by nature) -> group norm -> GELU-gated FFN (pf 4/3).

The reference has no Pallas kernel here; its ``lax.scan`` over time is a
Python loop over time steps, each a handful of f32 tensor ops.  The
chunkwise-parallel mLSTM form (``_mlstm_cell_chunkwise``) is ported as a
reference function: as in the reference, nothing on the served or trained
path switches it on (``ctx["chunkwise"]`` is read, never set).

The gated replay (``n_commit``) keeps each row's state after its first
n_commit steps by a masked update inside the time loop, bit-equal to the
reference's per-step states followed by ``select_step_state``, without
materialising the (B, T, H, dh, dh) per-step states.

States (per layer):
  mLSTM: C (B, H, dh, dh) f32, n (B, H, dh) f32, m (B, H) f32 (-1e9 empty),
         conv (B, dc-1, di) compute dtype
  sLSTM: c, n, h (B, H, dh) f32, m (B, H, dh) f32 (-1e9 empty)
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..distributed import local as L
from .config import ModelConfig
from .mamba import _conv, _local

Params = Dict[str, torch.Tensor]

M_EMPTY = -1e9       # the stabiliser of an empty state


def mlstm_inner(cfg: ModelConfig) -> int:
    return int(cfg.d_model * cfg.xlstm_mlstm_proj_factor)


def mlstm_param_shapes(cfg: ModelConfig, R: int) -> Dict[str, tuple]:
    """(shape, init, dtype) of the R-stacked mLSTM parameters; the gate
    biases stay float32, as the reference makes them."""
    d, nh, pd = cfg.d_model, cfg.num_heads, cfg.param_dtype
    di = mlstm_inner(cfg)
    f32 = torch.float32
    return {"up_proj": ((R, d, 2 * di), "dense", pd),
            "conv_w": ((R, cfg.xlstm_conv_kernel, di), "dense", pd),
            "conv_b": ((R, di), "zeros", pd),
            "wq": ((R, di, di), "dense", pd),
            "wk": ((R, di, di), "dense", pd),
            "wv": ((R, di, di), "dense", pd),
            "w_if": ((R, di, 2 * nh), "dense", pd),
            "b_i": ((R, nh), "const:-3.0", f32),
            "b_f": ((R, nh), "const:3.0", f32),
            "gn_scale": ((R, di), "ones", pd),
            "skip": ((R, di), "ones", pd),
            "down_proj": ((R, di, d), "dense", pd)}


def slstm_param_shapes(cfg: ModelConfig, R: int) -> Dict[str, tuple]:
    """(shape, init, dtype) of the R-stacked sLSTM parameters.  The
    headwise recurrent weights ``r`` (4, nh, dh, dh) and the gate biases
    stay float32; ``r`` takes fan-in 4 (its per-layer leading dim) and
    scale 1, as the reference draws it."""
    d, nh, pd = cfg.d_model, cfg.num_heads, cfg.param_dtype
    dh = d // nh
    d_ff = int(d * cfg.xlstm_slstm_proj_factor)
    f32 = torch.float32
    return {"w_in": ((R, d, 4 * d), "dense", pd),
            "r": ((R, 4, nh, dh, dh), "dense_lead", f32),
            "b": ((R, 4 * d), "slstm_b", f32),
            "gn_scale": ((R, d), "ones", pd),
            "ffn_gate": ((R, d, d_ff), "dense", pd),
            "ffn_up": ((R, d, d_ff), "dense", pd),
            "ffn_down": ((R, d_ff, d), "dense", pd)}


def slstm_bias_init(shape, device) -> torch.Tensor:
    """z, i, f, o gate biases: 0, -3, +3, 0 (each d wide)."""
    d = shape[-1] // 4
    b = torch.zeros(shape, dtype=torch.float32, device=device)
    b[..., d:2 * d] = -3.0
    b[..., 2 * d:3 * d] = 3.0
    return b


def _groupnorm_heads(x: torch.Tensor, scale: torch.Tensor, nh: int,
                     eps: float = 1e-5) -> torch.Tensor:
    """Per-head group norm over (..., di) with di = nh * dh, in f32."""
    shp = x.shape
    xh = x.reshape(shp[:-1] + (nh, shp[-1] // nh)).float()
    mu = xh.mean(dim=-1, keepdim=True)
    var = xh.var(dim=-1, keepdim=True, unbiased=False)
    xh = (xh - mu) * torch.rsqrt(var + eps)
    return (xh.reshape(shp) * scale.float()).to(x.dtype)


def _keep(t: int, n_commit, new, old):
    """The replay's masked update: ``new`` for rows with t < n_commit."""
    if n_commit is None:
        return new
    m = (t < n_commit).reshape((-1,) + (1,) * (new.dim() - 1))
    return torch.where(m, new, old)


# ----------------------------------------------------------------------------
# mLSTM
# ----------------------------------------------------------------------------
def _mlstm_gates(log_i, log_f, m0):
    """The stabiliser's (B, H) recurrence over the log gates, then every
    step's gates at once, with the reference's operands and order
    (``exp(lf + m - m_new)``): (m after each step (a list), i' (B, T, H,
    1), f' (B, T, H, 1), the floor exp(-m) (B, T, H))."""
    m, ms = m0, []
    for lf, li in zip(log_f.unbind(1), log_i.unbind(1)):
        m = torch.maximum(lf + m, li)
        ms.append(m)
    m_all = torch.stack(ms, dim=1)                            # (B, T, H)
    m_prev = torch.cat([m0[:, None], m_all[:, :-1]], dim=1)
    i_p = torch.exp(log_i - m_all)[..., None]                # (B, T, H, 1)
    f_p = torch.exp(log_f + m_prev - m_all)[..., None]
    return ms, i_p, f_p, torch.exp(-m_all)


def _mlstm_cell_scan(q, k, v, log_i, log_f, C0, n0, m0,
                     n_commit: Optional[torch.Tensor] = None,
                     per_step: bool = False):
    """Recurrent mLSTM cell over time.

    q/k/v: (B, T, H, dh) f32; log_i/log_f: (B, T, H) f32.  Returns h (B, T,
    H, dh) and the final (C, n, m), or with ``n_commit`` (B,) the state
    after each row's first n_commit steps (the start state where 0), or
    with ``per_step`` the (B, T, ...) states after every step (the
    reference's form of the replay; tests only).

    The stabiliser m follows the log gates alone, so its (B, H) recurrence
    runs first and the gates' exponentials for every step at once, with
    the reference's operands and order (``exp(lf + m - m_new)``).  The
    loop over time then carries n as one more row of C: both take the same
    update (n is C's for a value of 1), so one fused multiply-add updates
    them and one product reads num and n . q together."""
    dh = q.shape[-1]
    k = k / (dh ** 0.5)
    ms, i_p, f_p, floor = _mlstm_gates(log_i, log_f, m0)
    m = ms[-1]
    iv = i_p * torch.cat([v, torch.ones_like(v[..., :1])], dim=-1)
    # each step's operands as views made once: (B, H, dh+1, 1) columns,
    # (B, H, 1, dh) rows, (B, H, dh, 1) queries
    steps_in = zip(iv.unsqueeze(-1).unbind(1), k.unsqueeze(-2).unbind(1),
                   f_p.unsqueeze(-1).unbind(1), q.unsqueeze(-1).unbind(1),
                   floor.unbind(1), ms)
    Cn = torch.cat([C0, n0.unsqueeze(-2)], dim=-2)            # (B,H,dh+1,dh)
    kept = (C0, n0, m0)
    hs, steps = [], []
    for t, (ivc, kr, f, qc, fl, mt) in enumerate(steps_in):
        Cn = torch.addcmul(ivc * kr, f, Cn)
        read = (Cn @ qc).squeeze(-1)                          # (B, H, dh+1)
        den = torch.maximum(read[..., dh].abs(), fl).unsqueeze(-1)
        hs.append(read[..., :dh] / den)
        if n_commit is not None or per_step:
            st = (Cn[..., :dh, :], Cn[..., dh, :], mt)
            if n_commit is not None:
                kept = tuple(_keep(t, n_commit, new, old)
                             for new, old in zip(st, kept))
            if per_step:
                steps.append(st)
    final = (Cn[..., :dh, :], Cn[..., dh, :], m) if n_commit is None \
        else kept
    if per_step:
        final = tuple(torch.stack(a, dim=1) for a in zip(*steps))
    return torch.stack(hs, dim=1), final


def _make_mlstm_chunk_body(chunk: int):
    def body(carry, xs):
        # C is stored with log-scale m: true state = C * exp(m)
        C, n, m = carry                       # (B,H,dh,dh), (B,H,dh), (B,H)
        qt, kt, vt, li, lf = xs               # (B, c, H, *)
        li = li.movedim(-1, 1)                # (B, H, c)
        lf = lf.movedim(-1, 1)
        Fc = torch.cumsum(lf, dim=-1)         # log F_t
        a = li - Fc                           # a_s = li_s - log F_s
        # stabiliser: m_t = log F_t + max(m_carry, cummax_{s<=t} a_s)
        m_t = Fc + torch.maximum(m[..., None], torch.cummax(a, dim=-1).values)
        # source weights w[t, s] = exp(log F_t + a_s - m_t), s <= t
        i_w = torch.exp(Fc[..., :, None] + a[..., None, :]
                        - m_t[..., :, None])
        mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                     device=i_w.device))
        i_w = torch.where(mask, i_w, 0.0)                    # (B, H, t, s)
        carry_w = torch.exp(Fc + m[..., None] - m_t)         # (B, H, c)
        qh, kh, vh = qt.movedim(1, 2), kt.movedim(1, 2), vt.movedim(1, 2)
        # intra-chunk attention-like term + the carried state
        qk = torch.einsum("bhtd,bhsd->bhts", qh, kh) * i_w
        num = torch.einsum("bhts,bhsd->bhtd", qk, vh)
        num = num + carry_w[..., None] * torch.einsum("bhvk,bhtk->bhtv", C,
                                                      qh)
        nvec = torch.einsum("bhts,bhsd->bhtd", i_w, kh)
        nvec = nvec + carry_w[..., None] * n[..., None, :]
        den = torch.einsum("bhtd,bhtd->bht", nvec, qh).abs()
        den = torch.maximum(den, torch.exp(-m_t))[..., None]
        h = num / den                                        # (B, H, c, dh)
        # the chunk's final state, stored at scale m_new = m_t[last]
        m_new = m_t[..., -1]
        w_s = torch.exp(Fc[..., -1:] + a - m_new[..., None])  # (B, H, c)
        decay = torch.exp(Fc[..., -1] + m - m_new)
        C_new = (decay[..., None, None] * C
                 + torch.einsum("bhs,bhsv,bhsk->bhvk", w_s, vh, kh))
        n_new = decay[..., None] * n + torch.einsum("bhs,bhsk->bhk", w_s, kh)
        return (C_new, n_new, m_new), h.movedim(2, 1)

    return body


def _mlstm_cell_chunkwise(q, k, v, log_i, log_f, C0, n0, m0,
                          chunk: int = 128):
    """Chunkwise-parallel mLSTM (the same math as the scan): a masked
    quadratic form inside each chunk, the state carried between chunks.
    Falls back to the scan unless T is a multiple of ``chunk`` above it,
    as the reference does."""
    B, T, H, dh = q.shape
    if T % chunk != 0 or T <= chunk:
        return _mlstm_cell_scan(q, k, v, log_i, log_f, C0, n0, m0)
    k = k / (dh ** 0.5)
    body = _make_mlstm_chunk_body(chunk)
    carry, hs = (C0, n0, m0), []
    for c in range(T // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        carry, h = body(carry, (q[:, sl], k[:, sl], v[:, sl],
                                log_i[:, sl], log_f[:, sl]))
        hs.append(h)
    return torch.cat(hs, dim=1), carry


def mlstm_mix(params: Params, x: torch.Tensor, cfg: ModelConfig,
              state: Tuple, conv_state: torch.Tensor, *, rep: int = 1,
              chunkwise: bool = False,
              n_commit: Optional[torch.Tensor] = None):
    """x: (B*rep, T, d); state (C, n, m) and conv_state (B, dc-1, di) per
    slot, slot b's serving rows b*rep .. b*rep+rep-1 (verify: rep = k).

    Returns (y (B*rep, T, d), new state, conv ext (B*rep, T+dc-1, di),
    whose rows t..t+dc-2 are the conv state after t steps).  With
    ``n_commit`` the new state is each row's after its first n_commit
    steps."""
    if L.current() is not None:
        return _mlstm_mix_mesh(params, x, cfg, state, conv_state, rep=rep,
                               n_commit=n_commit)
    cd = cfg.compute_dtype
    nh = cfg.num_heads
    if rep > 1:
        state = tuple(a.repeat_interleave(rep, dim=0) for a in state)
        conv_state = conv_state.repeat_interleave(rep, dim=0)
    B, T, _ = x.shape
    up = x.to(cd) @ params["up_proj"].to(cd)
    xm, z = up.chunk(2, dim=-1)
    di = xm.shape[-1]
    dh = di // nh
    xc, ext = _conv(xm, params["conv_w"], params["conv_b"], conv_state)
    xc = F.silu(xc)
    q = (xc @ params["wq"].to(cd)).reshape(B, T, nh, dh).float()
    k = (xc @ params["wk"].to(cd)).reshape(B, T, nh, dh).float()
    v = (xm @ params["wv"].to(cd)).reshape(B, T, nh, dh).float()
    if_gates = (xc @ params["w_if"].to(cd)).float()
    log_i = if_gates[..., :nh] + params["b_i"]
    log_f = F.logsigmoid(if_gates[..., nh:] + params["b_f"])
    if chunkwise and n_commit is None:
        h, new_state = _mlstm_cell_chunkwise(q, k, v, log_i, log_f, *state)
    else:
        h, new_state = _mlstm_cell_scan(q, k, v, log_i, log_f, *state,
                                        n_commit=n_commit)
    h = h.reshape(B, T, di).to(cd)
    h = _groupnorm_heads(h, params["gn_scale"], nh)
    h = h + params["skip"].to(cd) * xc
    y = (h * F.silu(z)) @ params["down_proj"].to(cd)
    return y, new_state, ext


def _mlstm_cell_dh(q, k, v, log_i, log_f, C0, n0, m0, kdims, n_commit=None):
    """The mLSTM cell of a rank that holds a shard of every head's dims
    (the rules' fallback when the heads divide no "model" axis): C0 (B,
    H, dv, dh) its value dims' rows, n0 (B, H, dk) its key dims
    ``kdims`` = (lo, hi, mesh axes) of n, m0 (B, H) whole.  q/k (B, T, H,
    dh) whole, v (B, T, H, dv) the rank's value dims.  The same
    arithmetic as ``_mlstm_cell_scan`` on those rows, except that n . q
    is this rank's partial sum, reduced over ``kdims``' axes once after
    the loop.  Returns (h (B, T, H, dv), the kept (C, n, m))."""
    dh = q.shape[-1]
    lo, hi, axes = kdims
    k = k / (dh ** 0.5)
    ms, i_p, f_p, floor = _mlstm_gates(log_i, log_f, m0)
    m = ms[-1]
    iv, ik = i_p * v, i_p * torch.ones_like(k[..., lo:hi])
    C, n = C0, n0
    kept = (C0, n0, m0)
    reads, nqs = [], []
    for t in range(q.shape[1]):
        kt, qt, f = k[:, t], q[:, t], f_p[:, t]
        C = torch.addcmul(iv[:, t].unsqueeze(-1) * kt.unsqueeze(-2),
                          f.unsqueeze(-1), C)
        n = torch.addcmul(ik[:, t] * kt[..., lo:hi], f, n)
        reads.append((C @ qt.unsqueeze(-1)).squeeze(-1))
        nqs.append((n * qt[..., lo:hi]).sum(-1))
        if n_commit is not None:
            kept = tuple(_keep(t, n_commit, new, old)
                         for new, old in zip((C, n, ms[t]), kept))
    nq = L.reduce(torch.stack(nqs, dim=1), axes)              # (B, T, H)
    den = torch.maximum(nq.abs(), floor).unsqueeze(-1)
    h = torch.stack(reads, dim=1) / den
    return h, ((C, n, m) if n_commit is None else kept)


def _mlstm_mix_mesh(params: Params, x: torch.Tensor, cfg: ModelConfig,
                    state: Tuple, conv_state: torch.Tensor, *, rep: int,
                    n_commit: Optional[torch.Tensor]):
    """``mlstm_mix`` under a mesh: x is this rank's local rows, the states
    its shards (C, n, m over the heads on "model", else C's value dims and
    n's key dims; the conv over the inner channels).  The projections are
    products against the parameters' shards, gathered to whole rows of
    the activation; the conv runs on the rank's channels, the cell on its
    heads (or head dims); y is the DTensor of the global rows."""
    cd = cfg.compute_dtype
    nh = cfg.num_heads
    di = mlstm_inner(cfg)
    dh = di // nh
    heads, vdims = L.state_dims("C", (1, 1, nh, dh, dh))[2:4]
    kdims = L.state_dims("n", (1, 1, nh, dh))[3]
    clo, chi, caxes = L.state_dims(
        "conv", (1, 1, cfg.xlstm_conv_kernel - 1, di))[3]
    if rep > 1:
        state = tuple(a.repeat_interleave(rep, dim=0) for a in state)
        conv_state = conv_state.repeat_interleave(rep, dim=0)
    B, T, _ = x.shape
    whole = lambda t, w: L.lower(L.product(t, params[w]))
    xm, z = whole(x.to(cd), "up_proj").chunk(2, dim=-1)
    xc, ext = _conv(xm[..., clo:chi], _local(params["conv_w"]),
                    _local(params["conv_b"]), conv_state)
    xc = L.gather(F.silu(xc), 2, caxes)
    q = whole(xc, "wq").reshape(B, T, nh, dh).float()
    k = whole(xc, "wk").reshape(B, T, nh, dh).float()
    v = whole(xm, "wv").reshape(B, T, nh, dh).float()
    if_gates = whole(xc, "w_if").float()
    log_i = if_gates[..., :nh] + _local(params["b_i"])
    log_f = F.logsigmoid(if_gates[..., nh:] + _local(params["b_f"]))
    (hlo, hhi, haxes), (vlo, vhi, vaxes) = heads, vdims
    if vaxes:
        h, new_state = _mlstm_cell_dh(q, k, v[..., vlo:vhi], log_i, log_f,
                                      *state, kdims, n_commit=n_commit)
        h = L.gather(h, 3, vaxes)
    else:
        sl = slice(hlo, hhi)
        h, new_state = _mlstm_cell_scan(q[:, :, sl], k[:, :, sl],
                                        v[:, :, sl], log_i[..., sl],
                                        log_f[..., sl], *state,
                                        n_commit=n_commit)
        h = L.gather(h, 2, haxes)
    h = h.reshape(B, T, di).to(cd)
    h = _groupnorm_heads(h, _local(params["gn_scale"]), nh)
    h = h + _local(params["skip"]).to(cd) * xc
    y = L.to_rows(L.product((h * F.silu(z))[..., clo:chi],
                            params["down_proj"]))
    return y, new_state, ext


def init_mlstm_state(cfg: ModelConfig, batch: int, device):
    nh = cfg.num_heads
    di = mlstm_inner(cfg)
    dh = di // nh
    f32 = dict(dtype=torch.float32, device=device)
    C = torch.zeros((batch, nh, dh, dh), **f32)
    n = torch.zeros((batch, nh, dh), **f32)
    m = torch.full((batch, nh), M_EMPTY, **f32)
    conv = torch.zeros((batch, cfg.xlstm_conv_kernel - 1, di),
                       dtype=cfg.compute_dtype, device=device)
    # under a mesh, this rank's shards (``local.local_leaf``)
    mine = lambda name, t: L.local_leaf(name, t, stacked=False)
    return ((mine("C", C), mine("n", n), mine("m", m)), mine("conv", conv))


# ----------------------------------------------------------------------------
# sLSTM
# ----------------------------------------------------------------------------
def _slstm_cell(pre: torch.Tensor, R: torch.Tensor, state: Tuple,
                n_commit: Optional[torch.Tensor] = None,
                per_step: bool = False,
                dims: Optional[Tuple[int, int, Tuple[str, ...]]] = None):
    """The headwise sLSTM recurrence.  pre: (B, T, 4, H, dh) f32 gate
    pre-activations; R: (4, H, dh, dh) f32; state (c, n, h, m).  Returns
    the outputs (B, T, H, dh) and the final state, or with ``n_commit``
    each row's after its first n_commit steps, or with ``per_step`` the
    (B, T, ...) states after every step (tests only).

    A step's recurrent term ``einsum("ghij,bhj->bghi", R, h)`` is one f32
    batched product over the heads, R laid out (H, 4 dh, dh) once.

    ``dims`` = (lo, hi, mesh axes): under a mesh whose "model" axis the
    heads do not divide, this rank holds head dims lo:hi of every head
    (the rules' fallback; the state's leaves (B, H, hi - lo)).  The
    recurrent term sums over the previous h's dims, which the ranks share
    out: each multiplies its own dims' columns of R by its own h, the
    partial sums are reduced over the axes (no rank gathers h), and the
    rank's dims of the gates update its c, n, h, m."""
    c, n, h, m = state
    G, H, dh = R.shape[0], R.shape[1], R.shape[2]
    lo, hi, axes = dims or (0, dh, ())
    Rh = R[..., lo:hi].permute(1, 0, 2, 3).reshape(H, G * dh, hi - lo)
    kept = state
    hs, steps = [], []
    for t, pt in enumerate(pre.unbind(1)):
        rec = (Rh @ h.permute(1, 2, 0)).view(H, G, dh, -1)   # (H, 4, dh, B)
        rec = rec.permute(3, 1, 0, 2)                        # (B, 4, H, dh)
        if dims is not None:
            rec, pt = L.reduce(rec, axes)[..., lo:hi], pt[..., lo:hi]
        g = pt + rec
        zt = torch.tanh(g[:, 0])
        it = g[:, 1]
        ft = F.logsigmoid(g[:, 2])
        ot = torch.sigmoid(g[:, 3])
        a = ft + m
        m_new = torch.maximum(a, it)
        i_p = torch.exp(it - m_new)
        f_p = torch.exp(a - m_new)
        c = torch.addcmul(i_p * zt, f_p, c)
        n = torch.addcmul(i_p, f_p, n)
        h = ot * c / n.clamp(min=1e-6)
        m = m_new
        hs.append(h)
        if n_commit is not None:
            kept = tuple(_keep(t, n_commit, new, old)
                         for new, old in zip((c, n, h, m), kept))
        if per_step:
            steps.append((c, n, h, m))
    final = (c, n, h, m) if n_commit is None else kept
    if per_step:
        final = tuple(torch.stack(a, dim=1) for a in zip(*steps))
    return torch.stack(hs, dim=1), final


def slstm_mix(params: Params, x: torch.Tensor, cfg: ModelConfig,
              state: Tuple, *, rep: int = 1,
              n_commit: Optional[torch.Tensor] = None):
    """x: (B*rep, T, d); state (c, n, h, m), each (B, H, dh) f32 per slot
    (slot b serving rows b*rep .. b*rep+rep-1).  Sequential by nature.

    Returns (y, new state), the new state each row's after its first
    n_commit steps when ``n_commit`` is given."""
    if L.current() is not None:
        return _slstm_mix_mesh(params, x, cfg, state, rep=rep,
                               n_commit=n_commit)
    cd = cfg.compute_dtype
    nh = cfg.num_heads
    if rep > 1:
        state = tuple(a.repeat_interleave(rep, dim=0) for a in state)
    B, T, d = x.shape
    pre = (x.to(cd) @ params["w_in"].to(cd)).float() + params["b"]
    hs, new_state = _slstm_cell(pre.reshape(B, T, 4, nh, d // nh),
                                params["r"], state, n_commit=n_commit)
    y = hs.reshape(B, T, d).to(cd)
    y = _groupnorm_heads(y, params["gn_scale"], nh)
    # gated FFN (pf 4/3); jax.nn.gelu's default is the tanh form
    g = F.gelu(y @ params["ffn_gate"].to(cd), approximate="tanh")
    u = y @ params["ffn_up"].to(cd)
    return (g * u) @ params["ffn_down"].to(cd), new_state


def _slstm_mix_mesh(params: Params, x: torch.Tensor, cfg: ModelConfig,
                    state: Tuple, *, rep: int,
                    n_commit: Optional[torch.Tensor]):
    """``slstm_mix`` under a mesh: x is this rank's local rows, the state
    its shard (the heads over "model", else every head's dims).  ``w_in``'s
    4 d output columns are gate-major (4, H, dh), so a "model" shard of
    them is not a set of heads: the gate pre-activations are gathered to
    whole rows of the activation and each rank runs the recurrence of its
    own heads (or dims) alone.  The gated FFN is column- then
    row-parallel; y is the DTensor of the global rows."""
    cd = cfg.compute_dtype
    nh = cfg.num_heads
    B, T, d = x.shape
    dh = d // nh
    (hlo, hhi, haxes), dims = L.state_dims("h", (1, 1, nh, dh))[2:4]
    if rep > 1:
        state = tuple(a.repeat_interleave(rep, dim=0) for a in state)
    pre = (L.lower(L.product(x.to(cd), params["w_in"])).float()
           + _local(params["b"])).reshape(B, T, 4, nh, dh)
    R = _local(params["r"])
    if dims[2]:
        hs, new_state = _slstm_cell(pre, R, state, n_commit=n_commit,
                                    dims=dims)
        hs = L.gather(hs, 3, dims[2])
    else:
        hs, new_state = _slstm_cell(pre[:, :, :, hlo:hhi], R[:, hlo:hhi],
                                    state, n_commit=n_commit)
        hs = L.gather(hs, 2, haxes)
    y = hs.reshape(B, T, d).to(cd)
    y = _groupnorm_heads(y, _local(params["gn_scale"]), nh)
    g = F.gelu(y @ _local(params["ffn_gate"]).to(cd), approximate="tanh")
    u = y @ _local(params["ffn_up"]).to(cd)
    return L.to_rows(L.product(g * u, params["ffn_down"])), new_state


def init_slstm_state(cfg: ModelConfig, batch: int, device):
    """Empty (c, n, h, m) of ``batch`` rows (under a mesh: this rank's
    rows and shard)."""
    nh = cfg.num_heads
    dh = cfg.d_model // nh
    z = lambda: torch.zeros((batch, nh, dh), dtype=torch.float32,
                            device=device)
    st = (z(), z(), z(),
          torch.full((batch, nh, dh), M_EMPTY, dtype=torch.float32,
                     device=device))
    return tuple(L.local_leaf(name, t, stacked=False)
                 for name, t in zip(("c", "n", "h", "m"), st))
