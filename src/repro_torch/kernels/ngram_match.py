"""K2: the context drafter's n-gram match/hash sweep, CUDA for Hopper.

Replaces the TPU kernel ``repro/kernels/ngram_match.py:ngram_match_call``
(body ``_kernel``, vmapped over the batch by ``repro/kernels/ops.py:121``).
The kernel is ``csrc/ngram_match.cu``; this module holds its wrapper, its
launch count and its plain version.

What bounds it on the H100: bytes (~(q+w) integer ops per position against
16 bytes moved).  What the design does about it: one thread per (batch
row, position) over the engine's (B, L) buffer in place, reading positions
past L as -1 instead of building the reference wrapper's -1-padded copy
(``repro/kernels/ops.py:133-135``); neighbouring threads share their
overlapping window loads through the cache.  The output is bit-exact with
``hashing.hash_step``: the kernel does the same uint32 arithmetic with the
constants passed from ``hashing.py``.
"""
from __future__ import annotations

import ctypes

import torch

from . import build, ref
from .hashing import HASH_DTYPE, HASH_MIX, HASH_MULT


def ngram_match_plain(buf, query, cur_len, *, w: int):
    """Plain PyTorch version: buf (B, L) int; query (B, q); cur_len (B,).
    Returns (match (B, L) int32, hash (B, L) HASH_DTYPE)."""
    B = buf.shape[0]
    q = query.shape[1]
    pad = torch.full((B, q + w), -1, dtype=torch.int32, device=buf.device)
    bufp = torch.cat([buf.to(torch.int32), pad], dim=1)
    return ref.ngram_match_ref(bufp, query.to(torch.int32),
                               cur_len.to(torch.int32), w=w)


def _lib() -> ctypes.CDLL:
    lib = build.load("ngram_match")
    fn = lib.ngram_match_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_uint,
                       ctypes.c_uint, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def ngram_match_cuda(buf, query, cur_len, *, w: int):
    """Launch K2: buf (B, L) int32 with a contiguous last dim; query (B, q)
    int32, contiguous; cur_len (B,) int32; all on one CUDA device.
    Returns (match (B, L) int32, hash (B, L) HASH_DTYPE); raises on anything
    the kernel does not take and on a failed launch."""
    B, L = buf.shape
    q = query.shape[1]
    ops = (buf, query, cur_len)
    if any(not t.is_cuda or t.device != buf.device for t in ops):
        raise ValueError("ngram_match_cuda needs every operand on one CUDA "
                         "device")
    if any(t.dtype != torch.int32 for t in ops):
        raise TypeError("ngram_match_cuda takes int32 operands")
    if query.shape[0] != B or cur_len.shape != (B,) or w < 0:
        raise ValueError(f"shapes buf {tuple(buf.shape)} query "
                         f"{tuple(query.shape)} cur_len "
                         f"{tuple(cur_len.shape)} w {w}")
    if buf.stride(1) != 1 or not query.is_contiguous() \
            or not cur_len.is_contiguous():
        raise ValueError("buf needs a contiguous last dim; query and "
                         "cur_len must be contiguous")
    match = torch.empty((B, L), dtype=torch.int32, device=buf.device)
    h = torch.empty((B, L), dtype=HASH_DTYPE, device=buf.device)
    if match.numel() == 0:
        return match, h
    rc = _lib().ngram_match_launch(
        buf.data_ptr(), buf.stride(0), query.data_ptr(), query.stride(0),
        cur_len.data_ptr(), match.data_ptr(), h.data_ptr(), B, L, q, w,
        HASH_MULT, HASH_MIX, torch.cuda.current_stream(buf.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ngram_match kernel launch failed: CUDA error "
                           f"{rc}")
    ngram_match_cuda.launches += 1
    return match, h


ngram_match_cuda.launches = 0
