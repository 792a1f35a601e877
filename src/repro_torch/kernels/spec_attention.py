"""K1: bifurcated speculative-verification attention, CUDA for Hopper.

Replaces the TPU kernel ``repro/kernels/spec_attention.py:spec_attention_call``
(body ``_kernel``) on the verify path and on decode (verify with one row).
The kernel is ``csrc/spec_attention.cu``; this module holds its wrapper, its
launch count and its plain version.

What bounds it on the H100: bytes.  Each call reads every committed cache
row of a (batch, KV head) once and does ~4*hd flops per (query row, key),
far below the card's ~295 bf16 flops per byte.  What the design does about
it: it reads the engine layout (B, S, KV, hd) in place through strides (the
reference wrapper's per-call transposed copy of the whole cache and its
block padding, ``repro/kernels/ops.py:55-62``, are gone); one block per
(batch, KV head, 32 query rows) stages each cache tile once in shared memory
for all G query heads of that KV head; it stops at ``cur_len[b]``, which it
reads from device memory itself, so no host sync and no padding.
"""
from __future__ import annotations

import ctypes

import torch

from . import build, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HD = 256


def spec_attention_plain(q, k_cache, v_cache, k_tail, v_tail, cur_len, *,
                         w1: int) -> torch.Tensor:
    """Plain PyTorch version in the engine layout: q (B,K,W1,H,hd); caches
    (B,S,KV,hd); tails (B,K,W1,KV,hd); cur_len (B,).  Returns
    (B,K,W1,H,hd) in q's dtype (via ``ref.spec_attention_ref``)."""
    B, K, W1, H, hd = q.shape
    KV = k_cache.shape[2]
    qk = q.permute(0, 3, 1, 2, 4).reshape(B, H, K * W1, hd)
    kt = k_tail.permute(0, 3, 1, 2, 4).reshape(B, KV, K * W1, hd)
    vt = v_tail.permute(0, 3, 1, 2, 4).reshape(B, KV, K * W1, hd)
    out = ref.spec_attention_ref(qk, k_cache.transpose(1, 2),
                                 v_cache.transpose(1, 2), kt, vt, cur_len,
                                 w1=w1)
    return out.reshape(B, H, K, W1, hd).permute(0, 2, 3, 1, 4)


def _lib() -> ctypes.CDLL:
    lib = build.load("spec_attention")
    fn = lib.spec_attention_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 7
                       + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 9
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def spec_attention_cuda(q, k_cache, v_cache, k_tail, v_tail, cur_len, *,
                        w1: int) -> torch.Tensor:
    """Launch K1 on the engine layout (see ``spec_attention_plain``).

    q, tails: contiguous; caches: any strides with a contiguous last dim
    (a layer's view of the stacked state); cur_len: int32; all on one CUDA
    device, q/caches/tails of one dtype (float32 or bfloat16).  Launches on
    the current stream; raises on anything the kernel does not take and on
    a failed launch.
    """
    B, K, W1, H, hd = q.shape
    if W1 != w1:
        raise ValueError(f"w1={w1} but q has W1={W1}")
    S, KV = k_cache.shape[1], k_cache.shape[2]
    ops = (q, k_cache, v_cache, k_tail, v_tail, cur_len)
    if any(not t.is_cuda or t.device != q.device for t in ops):
        raise ValueError("spec_attention_cuda needs every operand on one "
                         "CUDA device")
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in ops[1:5]):
        raise TypeError(f"spec_attention_cuda takes float32 or bfloat16 "
                        f"operands of one dtype, got "
                        f"{[t.dtype for t in ops[:5]]}")
    if cur_len.dtype != torch.int32 or cur_len.shape != (B,) \
            or not cur_len.is_contiguous():
        raise TypeError("cur_len must be a contiguous (B,) int32 tensor")
    if H % KV or not 0 < hd <= _MAX_HD:
        raise ValueError(f"unsupported heads H={H} KV={KV} hd={hd}")
    if k_cache.shape != (B, S, KV, hd) or v_cache.shape != k_cache.shape:
        raise ValueError(f"cache shape {tuple(k_cache.shape)} / "
                         f"{tuple(v_cache.shape)} != {(B, S, KV, hd)}")
    if k_cache.stride() != v_cache.stride() or k_cache.stride(3) != 1:
        raise ValueError("k/v caches need equal strides and a contiguous "
                         "last dim")
    if k_tail.shape != (B, K, W1, KV, hd) or v_tail.shape != k_tail.shape:
        raise ValueError(f"tail shape {tuple(k_tail.shape)} != "
                         f"{(B, K, W1, KV, hd)}")
    if not (q.is_contiguous() and k_tail.is_contiguous()
            and v_tail.is_contiguous()):
        raise ValueError("q and the tails must be contiguous")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    cs = k_cache.stride()
    rc = _lib().spec_attention_launch(
        _DTYPES[q.dtype], q.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), k_tail.data_ptr(), v_tail.data_ptr(),
        cur_len.data_ptr(), out.data_ptr(),
        B, K * W1, W1, H, KV, hd, S,
        K * W1 * H * hd, H * hd, hd,
        cs[0], cs[1], cs[2],
        K * W1 * KV * hd, KV * hd, hd,
        1.0 / (hd ** 0.5), torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"spec_attention kernel launch failed: CUDA "
                           f"error {rc}")
    spec_attention_cuda.launches += 1
    return out


spec_attention_cuda.launches = 0
