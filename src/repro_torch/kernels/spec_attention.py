"""K1, K3 and K4: bifurcated speculative-verification attention over a
linear (K1) or a paged (K3) KV cache, CUDA for Hopper, with a tree's
ancestor tail (K4) in either layout.

K1 replaces the TPU kernel ``repro/kernels/spec_attention.py:
spec_attention_call`` (body ``_kernel``), K3 its paged sibling
``paged_spec_attention_call`` (body ``_paged_kernel``), on the verify path
and on decode (verify with one row).  K4 replaces the two kernels' tree
variant, the static ``tail_mask`` operand (``_pad_mask`` and the mask read
in ``_kernel``): there query input i sees, besides the cache, exactly the
tail inputs that are its ancestors-or-self.  All are one template in
``csrc/spec_attention.cu`` that differs only in how a cache row is
addressed and, for K4, in which tail keys a row walks: this module holds
their wrappers, launch counts and plain versions.

K4's operand is an ancestor table (``TreeMask.anc``), not the reference's
lane-padded (KW1, KW1p) int32 mask: row i lists its visible inputs in
ascending order, so the kernel walks at most depth+1 tail keys per row, as
a linear row walks at most w+1, in the order a masked scan over all inputs
would visit them.  Linear rows pass no table (a null pointer): the choice is
made at run time, uniformly across a warp, and doubles no template instance.

What bounds it on the H100: bytes at StableLM's main path (one query head
per KV head, ~440 flops per 256-byte key), the tensor-core rate at the
hybrid's GQA shape (8 heads per KV head, ~880 flops per byte).  What the
design does about it: it reads the engine layout (B, S, KV, hd) in place
through strides (the reference wrapper's per-call transposed copy of the
whole cache and its block padding, ``repro/kernels/ops.py:55-62``, are
gone) and stops at ``cur_len[b]``, which it reads from device memory
itself, so no host sync and no padding.  bf16 runs on the tensor cores:
one block per (batch, KV head, 64 packed (head, row) query rows), each
warp's 16 rows one ``mma.sync`` fragment, K/V tiles double-buffered in
shared memory by ``cp.async``, the tail as the last tiles of the same loop
(staged once for all G heads).  f32 keeps exact f32 arithmetic on the CUDA
cores, which the lossless checks need.  The source note in
``csrc/spec_attention.cu`` gives the details.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensor

from . import build, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HD = 256


class TreeMask(NamedTuple):
    """A tree's tail visibility in the two forms its consumers read.

    ``mask``: (KW1, KW1) bool, ancestor-or-self, for the plain versions (the
    reference's ``tail_mask``).  ``anc``: (KW1, 1 + D) int32 for the CUDA
    kernels (K4): row i is ``[n_i, a_0 < .. < a_{n_i - 1}, -1, ..]``, the
    n_i inputs that input i sees, ascending, padded with -1."""
    mask: torch.Tensor
    anc: torch.Tensor


def ancestor_table(mask: np.ndarray) -> np.ndarray:
    """The ``TreeMask.anc`` table of a (KW1, KW1) bool visibility mask."""
    mask = np.asarray(mask, bool)
    if mask.ndim != 2 or mask.shape[0] != mask.shape[1]:
        raise ValueError(f"tail mask must be square, got {mask.shape}")
    counts = mask.sum(axis=1)
    table = np.full((mask.shape[0], 1 + max(int(counts.max()), 1)), -1,
                    np.int32)
    table[:, 0] = counts
    for i, row in enumerate(mask):
        vis = np.flatnonzero(row)
        table[i, 1:1 + vis.size] = vis
    return table


def tree_mask(mask: np.ndarray, device) -> TreeMask:
    """Both forms of a static tail mask, as tensors on ``device``."""
    return TreeMask(
        mask=torch.as_tensor(np.asarray(mask, bool), device=device),
        anc=torch.as_tensor(ancestor_table(mask), device=device))


def spec_attention_plain(q, k_cache, v_cache, k_tail, v_tail, cur_len, *,
                         w1: int, tail_mask=None) -> torch.Tensor:
    """Plain PyTorch version in the engine layout: q (B,K,W1,H,hd); caches
    (B,S,KV,hd); tails (B,K,W1,KV,hd); cur_len (B,); ``tail_mask``:
    optional (K*W1, K*W1) bool tail visibility (a tree's ancestor mask) in
    place of the per-row causal one.  Returns (B,K,W1,H,hd) in q's dtype
    (via ``ref.spec_attention_ref``)."""
    B, K, W1, H, hd = q.shape
    KV = k_cache.shape[2]
    qk = q.permute(0, 3, 1, 2, 4).reshape(B, H, K * W1, hd)
    kt = k_tail.permute(0, 3, 1, 2, 4).reshape(B, KV, K * W1, hd)
    vt = v_tail.permute(0, 3, 1, 2, 4).reshape(B, KV, K * W1, hd)
    out = ref.spec_attention_ref(qk, k_cache.transpose(1, 2),
                                 v_cache.transpose(1, 2), kt, vt, cur_len,
                                 w1=w1, tail_mask=tail_mask)
    return out.reshape(B, H, K, W1, hd).permute(0, 2, 3, 1, 4)


def paged_spec_attention_plain(q, k_pool, v_pool, page_table, k_tail,
                               v_tail, cur_len, *, w1: int,
                               tail_mask=None) -> torch.Tensor:
    """Plain version of K3 (and of K4 over the pool, given ``tail_mask``):
    ``ref.gather_pages`` of the pool (NP, ps, KV, hd) through page_table
    (B, PPS), then ``spec_attention_plain``."""
    k_lin, v_lin = ref.gather_pages(k_pool, v_pool, page_table)
    return spec_attention_plain(q, k_lin, v_lin, k_tail, v_tail, cur_len,
                                w1=w1, tail_mask=tail_mask)


def _lib() -> ctypes.CDLL:
    lib = build.load("spec_attention")
    fn = lib.spec_attention_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8
                       + [ctypes.c_int] * 9 + [ctypes.c_longlong] * 9
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    fn = lib.paged_spec_attention_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 9
                       + [ctypes.c_int] * 10 + [ctypes.c_longlong] * 9
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def copy_width(tensors, strides) -> int:
    """Elements per shared-memory copy of the bf16 kernel: 8 (one 16-byte
    ``cp.async``) where every row start is 16-byte aligned, i.e. 8 divides
    every stride and every base address (in elements), else 1 (plain
    loads)."""
    elt = tensors[0].element_size()
    if all(t.data_ptr() % (8 * elt) == 0 for t in tensors) \
            and all(s % 8 == 0 for s in strides):
        return 8
    return 1


def _check_common(name, q, k_cache, v_cache, k_tail, v_tail, cur_len, w1,
                  extra=()):
    """Checks shared by K1 and K3; returns (B, K, W1, H, KV, hd)."""
    B, K, W1, H, hd = q.shape
    if W1 != w1:
        raise ValueError(f"w1={w1} but q has W1={W1}")
    KV = k_cache.shape[-2]
    ops = (q, k_cache, v_cache, k_tail, v_tail, cur_len) + tuple(extra)
    if any(not t.is_cuda or t.device != q.device for t in ops):
        raise ValueError(f"{name} needs every operand on one CUDA device")
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in ops[1:5]):
        raise TypeError(f"{name} takes float32 or bfloat16 operands of one "
                        f"dtype, got {[t.dtype for t in ops[:5]]}")
    if cur_len.dtype != torch.int32 or cur_len.shape != (B,) \
            or not cur_len.is_contiguous():
        raise TypeError("cur_len must be a contiguous (B,) int32 tensor")
    if H % KV or not 0 < hd <= _MAX_HD or k_cache.shape[-1] != hd:
        raise ValueError(f"unsupported heads H={H} KV={KV} hd={hd}")
    if v_cache.shape != k_cache.shape:
        raise ValueError(f"k/v cache shapes differ: {tuple(k_cache.shape)} "
                         f"/ {tuple(v_cache.shape)}")
    if k_cache.stride() != v_cache.stride() or k_cache.stride(3) != 1:
        raise ValueError("k/v caches need equal strides and a contiguous "
                         "last dim")
    if k_tail.shape != (B, K, W1, KV, hd) or v_tail.shape != k_tail.shape:
        raise ValueError(f"tail shape {tuple(k_tail.shape)} != "
                         f"{(B, K, W1, KV, hd)}")
    if not (q.is_contiguous() and k_tail.is_contiguous()
            and v_tail.is_contiguous()):
        raise ValueError("q and the tails must be contiguous")
    return B, K, W1, H, KV, hd


def _check_anc(name, anc, q, KW1):
    """Checks of K4's ancestor table; returns its row width (0: none)."""
    if anc is None:
        return 0
    if anc.dtype != torch.int32 or anc.dim() != 2 or anc.shape[0] != KW1 \
            or anc.shape[1] < 2 or not anc.is_contiguous():
        raise TypeError(f"{name}: anc must be a contiguous (K*W1={KW1}, "
                        f"1 + D) int32 table, got {anc.dtype} "
                        f"{tuple(anc.shape)}")
    if anc.device != q.device:
        raise ValueError(f"{name}: anc lies on {anc.device}, q on "
                         f"{q.device}")
    return anc.shape[1]


def _count(fn, anc) -> None:
    """One more launch of ``fn``'s linear-row (K1/K3) or tree (K4) kernel."""
    if anc is None:
        fn.launches += 1
    else:
        fn.tree_launches += 1


def spec_attention_cuda(q, k_cache, v_cache, k_tail, v_tail, cur_len, *,
                        w1: int, anc=None) -> torch.Tensor:
    """Launch K1 on the engine layout (see ``spec_attention_plain``), or K4
    over the linear cache when ``anc`` (``TreeMask.anc``) is given.

    q, tails: contiguous; caches: any strides with a contiguous last dim
    (a layer's view of the stacked state); cur_len: int32; all on one CUDA
    device, q/caches/tails of one dtype (float32 or bfloat16).  Launches on
    the current stream; raises on anything the kernel does not take and on
    a failed launch.  Counts K1's launches in ``launches`` and K4's in
    ``tree_launches``.
    """
    B, K, W1, H, KV, hd = _check_common("spec_attention_cuda", q, k_cache,
                                        v_cache, k_tail, v_tail, cur_len, w1)
    anc_w = _check_anc("spec_attention_cuda", anc, q, K * W1)
    S = k_cache.shape[1]
    if k_cache.shape != (B, S, KV, hd):
        raise ValueError(f"cache shape {tuple(k_cache.shape)} != "
                         f"{(B, S, KV, hd)}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if isinstance(out, FakeTensor):
        return _k1_shape(out, q, k_cache, cur_len, S, anc)
    cs = k_cache.stride()
    vec = copy_width((q, k_cache, v_cache, k_tail, v_tail), cs[:3] + (hd,))
    rc = _lib().spec_attention_launch(
        _DTYPES[q.dtype], q.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), k_tail.data_ptr(), v_tail.data_ptr(),
        cur_len.data_ptr(), None if anc is None else anc.data_ptr(),
        out.data_ptr(), B, K * W1, W1, H, KV, hd, S, anc_w, vec,
        K * W1 * H * hd, H * hd, hd,
        cs[0], cs[1], cs[2],
        K * W1 * KV * hd, KV * hd, hd,
        1.0 / (hd ** 0.5), torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"spec_attention kernel launch failed: CUDA "
                           f"error {rc}")
    _count(spec_attention_cuda, anc)
    return out


spec_attention_cuda.launches = 0
spec_attention_cuda.tree_launches = 0
spec_attention_cuda.shape_calls = []


def k1_instance(dtype, H: int, KV: int, KW1: int, hd: int) -> str:
    """The template instance K1 launches for these operands, as
    ``csrc/spec_attention.cu`` picks it: bf16 ``<head-dim capacity, m16
    fragments a warp, paged>`` on the tensor cores, f32 ``simt<32-lane
    head-dim chunks, paged>``."""
    if dtype == torch.float32:
        return f"simt<{-(-hd // 32)}, false>"
    cap = 64 if hd <= 64 else 128 if hd <= 128 else 256
    two = (H // KV) * KW1 > 64 and hd <= 128
    return f"<{cap}, {2 if two else 1}, false>"


def _k1_shape(out, q, k_cache, cur_len, S: int, anc):
    """K1's shape function: a fake ``q`` (``FakeTensorMode``, the
    dry-run) reached the launch, after every check of the real path.
    Returns ``out``, the empty fake the real path would fill, and appends
    to ``spec_attention_cuda.shape_calls`` the instance the card would
    launch and its cost as the kernel does it, over all S cache slots (a
    fake cur_len has no values): flops of Q K^T and P V over S + W1 keys,
    one exp a score, bytes of every operand read once and ``out``
    written."""
    if anc is not None:
        raise NotImplementedError(
            "K4 has no shape function: the dry-run's cases run no tree")
    B, K, W1, H, hd = q.shape
    KV = k_cache.shape[2]
    keys = B * H * K * W1 * (S + W1)
    nbytes = lambda t: t.numel() * t.element_size()
    spec_attention_cuda.shape_calls.append({
        "kernel": "K1", "instance": k1_instance(q.dtype, H, KV, K * W1, hd),
        "flops": 4 * keys * hd, "transcendentals": keys,
        "bytes": 2 * nbytes(q) + 2 * B * S * KV * hd * k_cache.element_size()
        + 2 * B * K * W1 * KV * hd * q.element_size() + nbytes(cur_len)})
    return out


def paged_spec_attention_cuda(q, k_pool, v_pool, page_table, k_tail, v_tail,
                              cur_len, *, w1: int, anc=None) -> torch.Tensor:
    """Launch K3: K1's function with cache slot s of row b read from pool
    row (page_table[b, s // ps], s % ps); a -1 page reads page 0, hidden by
    the cur_len mask.  With ``anc`` (``TreeMask.anc``), K4 over the pool;
    launches are counted as in ``spec_attention_cuda``.

    q, tails, cur_len: as ``spec_attention_cuda``; pools (NP, ps, KV, hd)
    with any strides and a contiguous last dim (a layer's view of the
    engine's (R, NP, ps, KV, hd) pool, read in place: no gather, no copy,
    no host read); page_table (B, PPS) contiguous int32.  Raises on anything
    the kernel does not take and on a failed launch.
    """
    B, K, W1, H, KV, hd = _check_common(
        "paged_spec_attention_cuda", q, k_pool, v_pool, k_tail, v_tail,
        cur_len, w1, extra=(page_table,))
    anc_w = _check_anc("paged_spec_attention_cuda", anc, q, K * W1)
    if k_pool.dim() != 4:
        raise ValueError(f"pool must be (NP, ps, KV, hd), got "
                         f"{tuple(k_pool.shape)}")
    ps = k_pool.shape[1]
    if page_table.dtype != torch.int32 or page_table.dim() != 2 \
            or page_table.shape[0] != B or not page_table.is_contiguous():
        raise TypeError("page_table must be a contiguous (B, PPS) int32 "
                        "tensor")
    pps = page_table.shape[1]
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if isinstance(out, FakeTensor):
        raise NotImplementedError(
            "K3 has no shape function: the dry-run's cases run no pages")
    ps_ = k_pool.stride()
    vec = copy_width((q, k_pool, v_pool, k_tail, v_tail), ps_[:3] + (hd,))
    rc = _lib().paged_spec_attention_launch(
        _DTYPES[q.dtype], q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        page_table.data_ptr(), k_tail.data_ptr(), v_tail.data_ptr(),
        cur_len.data_ptr(), None if anc is None else anc.data_ptr(),
        out.data_ptr(), B, K * W1, W1, H, KV, hd, ps, pps, anc_w, vec,
        K * W1 * H * hd, H * hd, hd,
        ps_[0], ps_[1], ps_[2],
        K * W1 * KV * hd, KV * hd, hd,
        1.0 / (hd ** 0.5), torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_spec_attention kernel launch failed: "
                           f"CUDA error {rc}")
    _count(paged_spec_attention_cuda, anc)
    return out


paged_spec_attention_cuda.launches = 0
paged_spec_attention_cuda.tree_launches = 0
