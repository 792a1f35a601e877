"""The port's kernels (repro_torch.kernels) against the JAX reference.

The plain PyTorch versions of K1 (verify attention) and K2 (n-gram sweep)
run on the CPU and are held against the JAX oracles on the same numpy
inputs: K1 within f32 2e-5 / bf16 2e-2 (the reference's own kernel
tolerance, tests/test_kernels.py), K2 bit-exact.  The CUDA kernels run only
on a card: their tests are in test_torch_gpu.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import dispatch as jdispatch
from repro.kernels import hashing as jhashing
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import build, dispatch, hashing, ref
from repro_torch.kernels.ngram_match import (ngram_draft_cuda,
                                             ngram_match_plain)
from repro_torch.kernels.spec_attention import (copy_width,
                                                spec_attention_cuda,
                                                spec_attention_plain)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The port's side in one thread: these models are tiny, and the suite
    runs its files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = {"float32": 2e-5, "bfloat16": 2e-2}

# the reference's kernel sweep (tests/test_kernels.py) plus decode rows
SWEEP = [(1, 1, 1, 1, 1, 16, 32, 16),     # degenerate: plain decode
         (2, 3, 4, 4, 2, 32, 64, 32),     # GQA
         (1, 5, 3, 8, 1, 64, 128, 64),    # MQA
         (2, 2, 6, 4, 4, 32, 96, 32),     # MHA, 3 blocks
         (1, 25, 4, 4, 2, 32, 64, 64),    # paper-scale k
         (3, 1, 1, 8, 2, 64, 80, 32)]     # decode (K=1, W1=1), GQA


def _k1_inputs(B, K, W1, H, KV, hd, S, seed, empty=False):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in
            [(B, K, W1, H, hd), (B, S, KV, hd), (B, S, KV, hd),
             (B, K, W1, KV, hd), (B, K, W1, KV, hd)]]
    cur = (np.zeros(B, np.int32) if empty
           else rng.integers(0, S + 1, B).astype(np.int32))
    return arrs, cur


def _both(arrs, cur, dtype):
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    td = getattr(torch, dtype)
    j = [jnp.asarray(a, jd) for a in arrs] + [jnp.asarray(cur)]
    t = [torch.from_numpy(a).to(td) for a in arrs] + [torch.from_numpy(cur)]
    return j, t


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,K,W1,H,KV,hd,S,bs", SWEEP)
def test_spec_attention_plain_matches_jax(B, K, W1, H, KV, hd, S, bs, dtype):
    arrs, cur = _k1_inputs(B, K, W1, H, KV, hd, S, seed=B * 7 + K)
    j, t = _both(arrs, cur, dtype)
    got = spec_attention_plain(*t, w1=W1)
    assert got.dtype == getattr(torch, dtype)
    _close(got, jops.spec_attention_ref_op(*j, w1=W1), TOL[dtype])
    _close(got, jops.spec_attention_op(*j, w1=W1, block_s=bs,
                                       interpret=True), TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_spec_attention_ref_kernel_layout_matches_jax(dtype):
    """ref.spec_attention_ref is the twin of the JAX oracle in the kernel
    layout (B, H, KW1, hd) / (B, KV, S, hd)."""
    B, H, KV, KW1, hd, S, w1 = 2, 4, 2, 12, 16, 40, 4
    rng = np.random.default_rng(5)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in
            [(B, H, KW1, hd), (B, KV, S, hd), (B, KV, S, hd),
             (B, KV, KW1, hd), (B, KV, KW1, hd)]]
    cur = np.array([17, 0], np.int32)
    j, t = _both(arrs, cur, dtype)
    _close(ref.spec_attention_ref(*t, w1=w1),
           jref.spec_attention_ref(*j, w1=w1), TOL[dtype])


def test_spec_attention_empty_cache_is_tail_only():
    """cur_len == 0: only the tail (incl. the leading token) attends."""
    arrs, cur = _k1_inputs(1, 2, 3, 2, 1, 16, 32, seed=3, empty=True)
    j, t = _both(arrs, cur, "float32")
    got = spec_attention_plain(*t, w1=3)
    _close(got, jops.spec_attention_ref_op(*j, w1=3), 2e-5)
    # the cache's contents cannot matter when nothing is committed
    t[1] = torch.randn(t[1].shape)
    _close(spec_attention_plain(*t, w1=3), got.numpy(), 0.0)


def test_dispatch_routes_cpu_tensors_to_the_plain_versions():
    arrs, cur = _k1_inputs(2, 3, 4, 4, 2, 32, 64, seed=1)
    _, t = _both(arrs, cur, "float32")
    assert torch.equal(dispatch.verify_attention(*t, w1=4),
                       spec_attention_plain(*t, w1=4))
    buf = torch.randint(0, 4, (2, 50), dtype=torch.int32)
    query = buf[:, :2].contiguous()
    cl = torch.tensor([50, 30], dtype=torch.int32)
    m, h = dispatch.ngram_sweep(buf, query, cl, w=3)
    m_p, h_p = ngram_match_plain(buf, query, cl, w=3)
    assert torch.equal(m, m_p) and torch.equal(h, h_p)


def test_kernel_wrappers_refuse_cpu_tensors():
    """A wrapper launches its kernel or raises; it never computes on CPU."""
    arrs, cur = _k1_inputs(1, 2, 3, 2, 1, 16, 8, seed=2)
    _, t = _both(arrs, cur, "float32")
    with pytest.raises(ValueError):
        spec_attention_cuda(*t, w1=3)
    buf = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        ngram_draft_cuda(buf, torch.tensor([8], dtype=torch.int32), q=1, k=2,
                         w=2)


@pytest.mark.parametrize("hd,off,vec", [(64, 0, 8), (36, 0, 1), (80, 4, 1),
                                        (64, 2, 1), (64, 1, 1), (33, 0, 1)])
def test_copy_width_follows_row_alignment(hd, off, vec):
    """The bf16 kernel copies 16 bytes at a time (8 elements) where every
    row start of the operands is 16-byte aligned, as a contiguous
    hd % 8 == 0 cache is, else element by element (1): hd = 4 x odd, an
    offset view by 4, 2 or 1 elements, an odd hd."""
    buf = torch.zeros((2, 5, 3, hd + off), dtype=torch.bfloat16)
    cache = buf[..., off:]
    tail = torch.zeros((2, 4, 3, hd), dtype=torch.bfloat16)
    assert copy_width((tail, cache, cache), cache.stride()[:3] + (hd,)) \
        == vec


def test_kernel_build_needs_nvcc(tmp_path, monkeypatch):
    """Each CUDA source is a kernel; without nvcc the build raises instead
    of leaving a wrapper with no kernel."""
    assert set(build.sources()) == {"spec_attention", "ngram_match",
                                    "mamba_scan", "mamba_scan_bwd"}
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build.shutil, "which", lambda _: None)
    monkeypatch.setattr(build.os.path, "exists", lambda _: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        build.build()
    assert not list(tmp_path.iterdir())


# ----------------------------------------------------------------------------
# K2 and the hash: bit-exact
# ----------------------------------------------------------------------------
def test_hash_rows_matches_jax_bit_for_bit():
    rng = np.random.default_rng(11)
    rows = rng.integers(-2**31, 2**31, (64, 7), dtype=np.int64).astype(
        np.int32)
    rows[:8] = -1                                  # pad tokens
    rows[8:16] = 2**31 - 1
    got = hashing.hash_rows(torch.from_numpy(rows))
    want = np.asarray(jhashing.hash_rows(jnp.asarray(rows))).astype(np.int64)
    assert got.dtype == hashing.HASH_DTYPE
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want > 2**31).any()                    # wrapped, high bit set
    assert hashing.HASH_MULT == jhashing.HASH_MULT
    assert hashing.HASH_MIX == jhashing.HASH_MIX


@pytest.mark.parametrize("q,w,L,vocab", [(1, 3, 64, 6), (2, 5, 128, 4),
                                         (3, 8, 256, 3), (1, 1, 32, 5),
                                         (1, 10, 300, 2**31 - 1)])
def test_ngram_sweep_plain_matches_jax(q, w, L, vocab):
    rng = np.random.default_rng(q * 100 + w)
    B = 3
    buf = rng.integers(0, vocab, (B, L)).astype(np.int32)
    buf[1, L - L // 4:] = -1                       # -1 pads inside the buffer
    query = np.stack([buf[b, 5:5 + q] for b in range(B)])
    cur = np.array([L, rng.integers(q, L), max(q - 1, 0)], np.int32)
    m, h = ngram_match_plain(torch.from_numpy(buf), torch.from_numpy(query),
                             torch.from_numpy(cur), w=w)
    m_x, h_x = jdispatch.ngram_sweep(jnp.asarray(buf), jnp.asarray(query),
                                     jnp.asarray(cur), w=w, backend="xla")
    np.testing.assert_array_equal(m.numpy(), np.asarray(m_x))
    np.testing.assert_array_equal(h.numpy(), np.asarray(h_x).astype(np.int64))
    # and the single-row oracle, per row, on the -1-padded buffer
    bufp = np.concatenate([buf, np.full((B, q + w), -1, np.int32)], 1)
    m_r, h_r = jax.vmap(lambda b, qq, c: jref.ngram_match_ref(
        b, qq, c[None], w=w))(jnp.asarray(bufp), jnp.asarray(query),
                              jnp.asarray(cur))
    m_t, h_t = ref.ngram_match_ref(torch.from_numpy(bufp),
                                   torch.from_numpy(query),
                                   torch.from_numpy(cur), w=w)
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_r))
    np.testing.assert_array_equal(h_t.numpy(),
                                  np.asarray(h_r).astype(np.int64))
    assert m.sum() > 0 or vocab > 100
