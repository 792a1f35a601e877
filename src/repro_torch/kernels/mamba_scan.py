"""K5: the Mamba selective scan, CUDA for Hopper.

Replaces the TPU kernel ``repro/kernels/mamba_scan.py:mamba_scan_call``
(body ``_kernel``).  In the reference no model code calls that kernel (its
``models/mamba.py:selective_scan`` is an XLA chunked scan); in the port
K5 *is* ``selective_scan``, so it carries every Mamba layer's scan: prefill
and full forward (the bigram table sweep too), decode, verify (B*k rows
started from their slot's state) and the gated replay, which also takes the
state after every step.  The kernel is ``csrc/mamba_scan.cu``; this module
holds its wrapper, its launch count and its plain version.

What bounds it on the H100: at the prefill shape (8, 256, 16384, 16) the
exps on the special-function units (~0.13 ms) and the ~0.42 GB of u, dt, y
and states (~0.125 ms) are both near the limit.  What the design does about
it: one thread per (batch row, channel) walks the steps in order with its
ds-entry state in registers, so the state is read once and written once per
call; u, dt and y move coalesced over neighbouring channels, and a block's
128 channels share B and C from shared memory.  Verify rows read their
slot's state as ``h0[row // h0_rep]`` instead of a repeated copy, and a
caller that needs no final state (verify) skips writing it.  u is read in
f32 (the layer casts a bf16 u first, as the reference does); reading bf16
directly is not done.
"""
from __future__ import annotations

import ctypes

import torch

from . import build, ref

MAX_DS = 16


def mamba_scan_plain(u, dt, A, B, C, D, h0, *, h0_rep: int = 1,
                     final: bool = True, steps: bool = False):
    """Plain PyTorch version (``ref.mamba_scan_ref``, sequential, f32).

    u/dt: (Bt, T, di); A: (di, ds); B/C: (Bt, T, ds); D: (di,); h0:
    (Bt // h0_rep, di, ds), row b starting from h0 row b // h0_rep.
    Returns (y (Bt, T, di), hT (Bt, di, ds) or None unless ``final``,
    per-step states (Bt, T, di, ds) or None unless ``steps``), all f32.
    """
    if h0_rep > 1:
        h0 = h0.repeat_interleave(h0_rep, dim=0)
    y, hT, hs = ref.mamba_scan_ref(u, dt, A, B, C, D, h0, steps=steps)
    return y, hT if final else None, hs


def _lib() -> ctypes.CDLL:
    lib = build.load("mamba_scan")
    fn = lib.mamba_scan_launch
    if fn.argtypes is None:
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [p, p, p, p, ll, ll, p, ll, ll, p, p, i, p, p, p,
                       i, i, i, i, p]
        fn.restype = ctypes.c_int
    return lib


def mamba_scan_cuda(u, dt, A, B, C, D, h0, *, h0_rep: int = 1,
                    final: bool = True, steps: bool = False):
    """Launch K5; arguments and results as ``mamba_scan_plain``.

    Every operand float32 on one CUDA device; u, dt, A, D and h0
    contiguous; B and C any strides with a contiguous last dim (views of
    the layer's x_proj output); 1 <= ds <= 16; T >= 1.  Launches on the
    current stream; raises on anything the kernel does not take and on a
    failed launch.  Counts launches in ``launches``.
    """
    ops = (u, dt, A, B, C, D, h0)
    if any(not t.is_cuda or t.device != u.device for t in ops):
        raise ValueError("mamba_scan_cuda needs every operand on one CUDA "
                         "device")
    if any(t.dtype != torch.float32 for t in ops):
        raise TypeError(f"mamba_scan_cuda takes float32 operands, got "
                        f"{[t.dtype for t in ops]}")
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
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape}")
    if not all(t.is_contiguous() for t in (u, dt, A, D, h0)) \
            or B.stride(2) != 1 or C.stride(2) != 1:
        raise ValueError("u, dt, A, D and h0 must be contiguous; B and C "
                         "need a contiguous last dim")
    f32 = dict(dtype=torch.float32, device=u.device)
    y = torch.empty((Bt, T, di), **f32)
    hT = torch.empty((Bt, di, ds), **f32) if final else None
    hs = torch.empty((Bt, T, di, ds), **f32) if steps else None
    if y.numel() == 0:
        return y, hT, hs
    rc = _lib().mamba_scan_launch(
        u.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
        B.stride(0), B.stride(1), C.data_ptr(), C.stride(0), C.stride(1),
        D.data_ptr(), h0.data_ptr(), h0_rep, y.data_ptr(),
        None if hT is None else hT.data_ptr(),
        None if hs is None else hs.data_ptr(), Bt, T, di, ds,
        torch.cuda.current_stream(u.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mamba_scan kernel launch failed: CUDA error "
                           f"{rc}")
    mamba_scan_cuda.launches += 1
    return y, hT, hs


mamba_scan_cuda.launches = 0
