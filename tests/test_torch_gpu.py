"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test carries the ``gpu`` marker and skips without a CUDA device.
This file imports neither JAX nor the reference package, so it also runs
on a machine with only the port's dependencies:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

Shapes are those of ``chip_smoke.py``'s main path (StableLM-2-1.6B, B=8,
k=10, w=10, S=332) plus GQA, MQA, hd up to 256 and a 2048-slot cache.
Tolerances: K1 f32 2e-5, bf16 2e-2 (the reference's kernel tolerance);
K2 bit-exact.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.ngram_match import ngram_match_cuda, ngram_match_plain
from repro_torch.kernels.spec_attention import (spec_attention_cuda,
                                                spec_attention_plain)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol, atol=tol)


# ----------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,K,W1,H,KV,hd,S,cur", [
    (8, 10, 11, 32, 32, 64, 332, [256, 265, 274, 283, 292, 301, 310, 319]),
    (8, 1, 1, 32, 32, 64, 332, [256, 265, 274, 283, 292, 301, 310, 319]),
    (2, 25, 11, 32, 8, 128, 2048, [2000, 0]),
    (2, 3, 4, 32, 1, 256, 300, [299, 64]),
    (2, 2, 41, 4, 2, 80, 200, [205, 7])])     # tail > 32 keys, cur_len > S
def test_spec_attention_cuda_matches_plain(cuda_device, B, K, W1, H, KV, hd,
                                           S, cur, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    td = getattr(torch, dtype)
    rn = lambda *s: torch.randn(s, generator=g, device=cuda_device).to(td)
    ops = (rn(B, K, W1, H, hd), rn(B, S, KV, hd), rn(B, S, KV, hd),
           rn(B, K, W1, KV, hd), rn(B, K, W1, KV, hd),
           torch.tensor(cur, dtype=torch.int32, device=cuda_device))
    got = spec_attention_cuda(*ops, w1=W1)
    want = spec_attention_plain(*ops, w1=W1)
    torch.cuda.synchronize()
    _close(got, want, TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("B,L,q,w", [(8, 332, 1, 10), (3, 4097, 4, 16)])
def test_ngram_match_cuda_matches_plain(cuda_device, B, L, q, w):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    buf = torch.randint(0, 5, (B, L), generator=g, device=cuda_device,
                        dtype=torch.int32)
    buf[:, -7:] = -1
    query = buf[:, 2:2 + q].contiguous()
    cl = torch.randint(0, L + 1, (B,), generator=g, device=cuda_device,
                       dtype=torch.int32)
    m, h = ngram_match_cuda(buf, query, cl, w=w)
    m_p, h_p = ngram_match_plain(buf, query, cl, w=w)
    assert torch.equal(m, m_p) and torch.equal(h, h_p)
