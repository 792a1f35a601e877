"""K5: the Mamba selective scan, CUDA for Hopper.

Replaces the TPU kernel ``repro/kernels/mamba_scan.py:mamba_scan_call``
(body ``_kernel``).  In the reference no model code calls that kernel (its
``models/mamba.py:selective_scan`` is an XLA chunked scan); in the port
K5 *is* ``selective_scan``, so it carries every Mamba layer's scan: prefill
and full forward (the bigram table sweep too), decode, verify (B*k rows
started from their slot's state) and the gated replay, which keeps the
state after each row's accepted tokens (``n_commit``).  The kernel is
``csrc/mamba_scan.cu``; this module holds its wrapper, its launch count
and its plain version.  Training differentiates it: ``mamba_scan_train``
is an autograd Function whose forward is K5 and whose backward is K5's
backward kernel (``csrc/mamba_scan_bwd.cu``, which states its own bound
and design; its wrapper, launch count and plain version are the second
half of this module).  The training forward runs K5's checkpointing
instance, which also writes the state before every ``CHUNK``-th step for
the backward to rebuild its states from.

What bounds it on the H100: at the prefill shape (8, 256, 16384, 16) the
exps on the special-function units (~0.13 ms); at the verify shape the
exps and the bytes about equally; the replay and decode move bytes.  What
the design does about it: each (batch row, channel) walks the steps in
order with its state in registers, split over 4 lanes of 4 states, so the
state is read once and written once per call, in 16-byte slices; u, dt, B
and C are staged in shared memory by ``cp.async``, double-buffered, while
the previous chunk computes; each exp is one FMUL and one ``ex2``.  Verify
rows read their slot's state as ``h0[row // h0_rep]`` instead of a
repeated copy, a caller that needs no final state (verify) skips writing
it, and the replay writes only the state it keeps.  u comes in the layer's
compute dtype (f32 or bf16) and is upcast in registers, as the reference
kernel does.
"""
from __future__ import annotations

import ctypes

import torch
from torch._subclasses.fake_tensor import FakeTensor

from . import build, ref

MAX_DS = 16
CHUNK = 16        # steps a checkpoint of the training forward (both kernels)


def n_chunks(T: int) -> int:
    """Checkpoints of a T-step scan: the states before steps 0, CHUNK,
    2 CHUNK, ..."""
    return -(-T // CHUNK)


def mamba_scan_plain(u, dt, A, B, C, D, h0, *, h0_rep: int = 1,
                     final: bool = True, steps: bool = False,
                     n_commit=None):
    """Plain PyTorch version (``ref.mamba_scan_ref``, sequential, f32).

    u: (Bt, T, di) f32 or bf16 (upcast to f32); dt: (Bt, T, di); A: (di,
    ds); B/C: (Bt, T, ds); D: (di,); h0: (Bt // h0_rep, di, ds), row b
    starting from h0 row b // h0_rep.  Returns (y (Bt, T, di), the final
    state (Bt, di, ds) or None unless ``final``, per-step states (Bt, T,
    di, ds) or None unless ``steps``), all f32.  Given ``n_commit`` (Bt,)
    int, the final state is the one after ``n_commit[b]`` steps (clamped to
    T; row b's h0 where it is <= 0), as ``ref.select_step_state`` picks it
    from the per-step states.  Only this version returns the per-step
    states (``mamba_mix_steps``, held against the reference on the CPU);
    K5 keeps the selected state instead.
    """
    if n_commit is not None and not final:
        raise ValueError("n_commit selects the final state: final=True")
    if h0_rep > 1:
        h0 = h0.repeat_interleave(h0_rep, dim=0)
    y, hT, hs = ref.mamba_scan_ref(u, dt, A, B, C, D, h0,
                                   steps=steps or n_commit is not None)
    if n_commit is not None:
        hT = ref.select_step_state(hs, h0.float(), n_commit)
        hs = hs if steps else None
    return y, hT if final else None, hs


def _lib() -> ctypes.CDLL:
    lib = build.load("mamba_scan")
    fn = lib.mamba_scan_launch
    if fn.argtypes is None:
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [p, i, p, p, p, ll, ll, p, ll, ll, p, p, i, p, p, p,
                       p, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return lib


def mamba_scan_cuda(u, dt, A, B, C, D, h0, *, h0_rep: int = 1,
                    final: bool = True, steps: bool = False,
                    n_commit=None, ckpt=None):
    """Launch K5; arguments and results as ``mamba_scan_plain``, except
    that it writes no per-step states (``steps`` must be False: the replay
    passes ``n_commit``).  Given ``ckpt``, a contiguous float32 (Bt,
    n_chunks(T), di, ds) tensor on u's device, the training instance also
    fills it with the state before every CHUNK-th step (h0_rep 1, no
    ``n_commit``): the checkpoints K5's backward reads.

    u float32 or bfloat16, every other operand float32 (``n_commit``
    int32), all on one CUDA device; u, dt, A, D, h0 and n_commit
    contiguous; B and C any strides with a contiguous last dim (views of
    the layer's x_proj output); 1 <= ds <= 16; T >= 1.  Launches on the
    current stream; raises on anything the kernel does not take and on a
    failed launch.  Counts launches in ``launches``.
    """
    if steps:
        raise ValueError("mamba_scan_cuda writes no per-step states; the "
                         "replay keeps its state by n_commit")
    ops = (u, dt, A, B, C, D, h0) + (() if n_commit is None else (n_commit,))
    if any(not t.is_cuda or t.device != u.device for t in ops):
        raise ValueError("mamba_scan_cuda needs every operand on one CUDA "
                         "device")
    if u.dtype not in (torch.float32, torch.bfloat16) \
            or any(t.dtype != torch.float32 for t in ops[1:7]) \
            or (n_commit is not None and n_commit.dtype != torch.int32):
        raise TypeError(f"mamba_scan_cuda takes u float32 or bfloat16, "
                        f"n_commit int32 and float32 otherwise, got "
                        f"{[t.dtype for t in ops]}")
    if n_commit is not None and not final:
        raise ValueError("n_commit selects the final state: final=True")
    if ckpt is not None and (h0_rep != 1 or n_commit is not None):
        raise ValueError("checkpoints are the training forward's: h0_rep 1 "
                         "and no n_commit")
    if u.dim() != 3:
        raise ValueError(f"u must be (Bt, T, di), got {tuple(u.shape)}")
    Bt, T, di = u.shape
    ds = A.shape[-1]
    if not 1 <= ds <= MAX_DS or T < 1 or h0_rep < 1 or Bt % h0_rep:
        raise ValueError(f"unsupported scan: ds={ds} (1..{MAX_DS}), T={T}, "
                         f"Bt={Bt}, h0_rep={h0_rep}")
    want = {"dt": (dt, (Bt, T, di)), "A": (A, (di, ds)),
            "B": (B, (Bt, T, ds)), "C": (C, (Bt, T, ds)), "D": (D, (di,)),
            "h0": (h0, (Bt // h0_rep, di, ds))}
    if n_commit is not None:
        want["n_commit"] = (n_commit, (Bt,))
    if ckpt is not None:
        want["ckpt"] = (ckpt, (Bt, n_chunks(T), di, ds))
        if ckpt.dtype != torch.float32 or ckpt.device != u.device:
            raise ValueError("ckpt must be float32 on u's device")
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape}")
    if not all(t.is_contiguous() for t in ops if t is not B and t is not C) \
            or B.stride(2) != 1 or C.stride(2) != 1 \
            or (ckpt is not None and not ckpt.is_contiguous()):
        raise ValueError("u, dt, A, D, h0, n_commit and ckpt must be "
                         "contiguous; B and C need a contiguous last dim")
    f32 = dict(dtype=torch.float32, device=u.device)
    y = torch.empty((Bt, T, di), **f32)
    hT = torch.empty((Bt, di, ds), **f32) if final else None
    if y.numel() == 0:
        return y, hT, None
    if isinstance(y, FakeTensor):
        return _k5_shape(y, hT, ops, ckpt)
    ptr = lambda t: None if t is None else t.data_ptr()
    rc = _lib().mamba_scan_launch(
        u.data_ptr(), int(u.dtype == torch.bfloat16), dt.data_ptr(),
        A.data_ptr(), B.data_ptr(), B.stride(0), B.stride(1), C.data_ptr(),
        C.stride(0), C.stride(1), D.data_ptr(), h0.data_ptr(), h0_rep,
        ptr(n_commit), y.data_ptr(), ptr(hT), ptr(ckpt), Bt, T, di, ds,
        torch.cuda.current_stream(u.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mamba_scan kernel launch failed: CUDA error "
                           f"{rc}")
    mamba_scan_cuda.launches += 1
    return y, hT, None


mamba_scan_cuda.launches = 0
mamba_scan_cuda.shape_calls = []


def k5_instance(u_dtype, ds: int, select: bool) -> str:
    """The template instance K5 launches, as ``csrc/mamba_scan.cu`` picks
    it: ``<ds capacity, u's type, n_commit's select, checkpoints>``."""
    cap = 4 if ds <= 4 else 8 if ds <= 8 else 16
    tu = "bf16" if u_dtype == torch.bfloat16 else "float"
    return f"<{cap}, {tu}, {str(select).lower()}, false>"


def _k5_shape(y, hT, ops, ckpt):
    """K5's shape function: a fake ``u`` (``FakeTensorMode``, the
    dry-run) reached the launch, after every check of the real path.
    Returns the empty fake outputs the real path would fill and appends
    to ``mamba_scan_cuda.shape_calls`` the instance the card would launch
    and its cost as the kernel does it: per state element one exp and six
    flops (decay, the two products, the add, C's product and the sum), per
    channel three (dt u, D u and its add); bytes of every operand read
    once and the outputs written."""
    if ckpt is not None:
        raise NotImplementedError("K5's training instance has no shape "
                                  "function: the dry-run does not train")
    u, n_commit = ops[0], (ops[7] if len(ops) > 7 else None)
    Bt, T, di = u.shape
    ds = ops[2].shape[-1]
    outs = (y,) if hT is None else (y, hT)
    mamba_scan_cuda.shape_calls.append({
        "kernel": "K5", "instance": k5_instance(u.dtype, ds,
                                                n_commit is not None),
        "flops": Bt * T * di * (6 * ds + 3),
        "transcendentals": Bt * T * di * ds,
        "bytes": sum(t.numel() * t.element_size() for t in ops + outs)})
    return y, hT, None


# ---------------------------------------------------------------------------
# the backward (csrc/mamba_scan_bwd.cu) and the training call
# ---------------------------------------------------------------------------
def mamba_scan_bwd_plain(u, dt, A, B, C, D, h0, dy, dhT=None):
    """Plain PyTorch version of K5's backward: the gradients of the scan
    ``ref.mamba_scan_ref`` (h0_rep 1, the final state the last one) given
    ``dy`` (Bt, T, di) and optionally ``dhT`` (Bt, di, ds), by the reverse
    recurrence the kernel runs (``csrc/mamba_scan_bwd.cu`` states it), in
    f32.  Returns (du, ddt, dA, dB, dC, dD, dh0), each the shape of its
    input, all f32 (du too: the training call casts it to u's dtype).  Used
    by the tests and ``chip_smoke.py`` alone: on the CPU autograd
    differentiates ``mamba_scan_plain`` itself."""
    uf, dtf, Af = u.float(), dt.float(), A.float()
    Bf, Cf, dyf = B.float(), C.float(), dy.float()
    T = uf.shape[1]
    h, prev, decay = h0.float(), [], []
    for t in range(T):
        a = torch.exp(dtf[:, t, :, None] * Af)
        prev.append(h)
        decay.append(a)
        h = a * h + (dtf[:, t] * uf[:, t])[..., None] * Bf[:, t, None, :]
    g = torch.zeros_like(h) if dhT is None else dhT.float().clone()
    du, ddt, dB, dC = ([None] * T for _ in range(4))
    dA = torch.zeros_like(Af)
    for t in reversed(range(T)):
        a, hp = decay[t], prev[t]
        ht = a * hp + (dtf[:, t] * uf[:, t])[..., None] * Bf[:, t, None, :]
        g = g + dyf[:, t, :, None] * Cf[:, t, None, :]
        gB = torch.einsum("bds,bs->bd", g, Bf[:, t])
        gha = g * a * hp
        du[t] = dyf[:, t] * D.float() + dtf[:, t] * gB
        ddt[t] = uf[:, t] * gB + (gha * Af).sum(-1)
        dA = dA + (gha * dtf[:, t, :, None]).sum(0)
        dB[t] = torch.einsum("bds,bd->bs", g, dtf[:, t] * uf[:, t])
        dC[t] = torch.einsum("bds,bd->bs", ht, dyf[:, t])
        g = a * g
    dD = (dyf * uf).sum((0, 1))
    st = lambda xs: torch.stack(xs, dim=1)
    return st(du), st(ddt), dA, st(dB), st(dC), dD, g


def _bwd_lib() -> ctypes.CDLL:
    lib = build.load("mamba_scan_bwd")
    fn = lib.mamba_scan_bwd_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        ll = ctypes.c_longlong
        fn.argtypes = [p, i, p, p, p, ll, ll, p, ll, ll] + [p] * 15 \
            + [i, i, i, i, p]
        fn.restype = ctypes.c_int
        lib.mamba_scan_bwd_blocks.argtypes = [i, i]
        lib.mamba_scan_bwd_blocks.restype = i
        lib.mamba_scan_bwd_chunk.argtypes = []
        lib.mamba_scan_bwd_chunk.restype = i
    return lib


def mamba_scan_bwd_cuda(u, dt, A, B, C, D, h0, dy, dhT=None, ckpt=None):
    """Launch K5's backward (``csrc/mamba_scan_bwd.cu``): arguments and
    results as ``mamba_scan_bwd_plain``, plus ``ckpt``, the checkpoints K5's
    training instance wrote in the forward of the same operands
    (``mamba_scan_cuda(..., ckpt=)``); when it is None, that instance runs
    here first (a K5 launch, counted as such).  Operands as
    ``mamba_scan_cuda`` takes them with h0_rep 1 (B and C any strides
    with a contiguous last dim), dy and dhT float32.  The partial sums
    (so that no float atomic is used) are allocated here.  Counts launches
    in ``launches`` (the main kernel and its reduction count as one)."""
    ops = (u, dt, A, B, C, D, h0, dy) + (() if dhT is None else (dhT,))
    Bt, T, di = u.shape
    ds = A.shape[-1]
    if not 1 <= ds <= MAX_DS or T < 1:
        raise ValueError(f"unsupported scan: ds={ds} (1..{MAX_DS}), T={T}")
    want = {"dt": (dt, (Bt, T, di)), "A": (A, (di, ds)),
            "B": (B, (Bt, T, ds)), "C": (C, (Bt, T, ds)), "D": (D, (di,)),
            "h0": (h0, (Bt, di, ds)), "dy": (dy, (Bt, T, di))}
    if dhT is not None:
        want["dhT"] = (dhT, (Bt, di, ds))
    if ckpt is not None:
        want["ckpt"] = (ckpt, (Bt, n_chunks(T), di, ds))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape}")
    if any(not t.is_cuda or t.device != u.device for t in ops):
        raise ValueError("mamba_scan_bwd_cuda needs every operand on one "
                         "CUDA device")
    if u.dtype not in (torch.float32, torch.bfloat16) \
            or any(t.dtype != torch.float32 for t in ops[1:]):
        raise TypeError(f"mamba_scan_bwd_cuda takes u float32 or bfloat16 "
                        f"and float32 otherwise, got "
                        f"{[t.dtype for t in ops]}")
    u, dt, A, D, h0, dy = (t.contiguous() for t in (u, dt, A, D, h0, dy))
    B, C = (t if t.stride(2) == 1 else t.contiguous() for t in (B, C))
    dhT = None if dhT is None else dhT.contiguous()
    f32 = dict(dtype=torch.float32, device=u.device)
    if ckpt is None:
        ckpt = torch.empty((Bt, n_chunks(T), di, ds), **f32)
        mamba_scan_cuda(u, dt, A, B, C, D, h0, final=False, ckpt=ckpt)
    elif ckpt.dtype != torch.float32 or ckpt.device != u.device \
            or not ckpt.is_contiguous():
        raise ValueError("ckpt must be contiguous float32 on u's device")
    lib = _bwd_lib()
    if lib.mamba_scan_bwd_chunk() != CHUNK:
        raise RuntimeError("mamba_scan_bwd.cu's checkpoint interval is not "
                           "CHUNK")
    nbx = lib.mamba_scan_bwd_blocks(di, ds)
    du, ddt = torch.empty((Bt, T, di), **f32), torch.empty((Bt, T, di),
                                                           **f32)
    dh0 = torch.empty((Bt, di, ds), **f32)
    dA, dD = torch.empty((di, ds), **f32), torch.empty((di,), **f32)
    dB, dC = torch.empty((Bt, T, ds), **f32), torch.empty((Bt, T, ds),
                                                          **f32)
    pB, pC = (torch.empty((nbx, Bt, T, ds), **f32) for _ in range(2))
    pA, pD = torch.empty((Bt, di, ds), **f32), torch.empty((Bt, di), **f32)
    ptr = lambda t: None if t is None else t.data_ptr()
    rc = lib.mamba_scan_bwd_launch(
        u.data_ptr(), int(u.dtype == torch.bfloat16), dt.data_ptr(),
        A.data_ptr(), B.data_ptr(), B.stride(0), B.stride(1), C.data_ptr(),
        C.stride(0), C.stride(1), D.data_ptr(), dy.data_ptr(), ptr(dhT),
        ckpt.data_ptr(), du.data_ptr(), ddt.data_ptr(), dh0.data_ptr(),
        pB.data_ptr(), pC.data_ptr(), pA.data_ptr(), pD.data_ptr(),
        dB.data_ptr(), dC.data_ptr(), dA.data_ptr(), dD.data_ptr(),
        Bt, T, di, ds,
        torch.cuda.current_stream(u.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mamba_scan_bwd kernel launch failed: CUDA "
                           f"error {rc}")
    mamba_scan_bwd_cuda.launches += 1
    return du, ddt, dA, dB, dC, dD, dh0


mamba_scan_bwd_cuda.launches = 0


class _TrainScan(torch.autograd.Function):
    """K5 as autograd sees it: the forward is K5's training instance, which
    also writes the checkpoints that autograd keeps (Bt x n_chunks(T) x di
    x ds f32 a Mamba layer; under remat only for the layer being
    differentiated), the backward K5's backward kernel.  ``final``: the
    forward also returns the final state, whose gradient the backward
    takes as ``dhT``."""

    @staticmethod
    def forward(ctx, u, dt, A, B, C, D, h0, final):
        Bt, T, di = u.shape
        ckpt = torch.empty((Bt, n_chunks(T), di, A.shape[-1]),
                           dtype=torch.float32, device=u.device)
        y, hT, _ = mamba_scan_cuda(u, dt, A, B, C, D, h0, final=final,
                                   ckpt=ckpt)
        ctx.save_for_backward(u, dt, A, B, C, D, h0, ckpt)
        return (y, hT) if final else y

    @staticmethod
    def backward(ctx, dy, dhT=None):
        u, dt, A, B, C, D, h0, ckpt = ctx.saved_tensors
        dy = torch.zeros(u.shape, dtype=torch.float32, device=u.device) \
            if dy is None else dy.float()
        du, *rest = mamba_scan_bwd_cuda(u, dt, A, B, C, D, h0, dy,
                                        None if dhT is None else dhT.float(),
                                        ckpt)
        return (du.to(u.dtype), *rest, None)


def mamba_scan_train(u, dt, A, B, C, D, h0, *, final: bool = False):
    """The training call on the card: K5 under autograd, differentiated by
    K5's backward.  Operands as ``mamba_scan_cuda`` takes them with h0_rep
    1, no ``n_commit`` and no per-step states; returns (y, the final state
    or None, None) as it does.  The gradient of u comes back in u's
    dtype."""
    out = _TrainScan.apply(u, dt, A, B, C, D, h0, final)
    y, hT = out if final else (out, None)
    return y, hT, None
