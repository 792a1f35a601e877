"""The ONE definition of the context-N-gram continuation hash in the port.

Bit-equal to the reference's ``repro/kernels/hashing.py``:

    h_0 = 0;  h_{j+1} = (h_j ^ (tok_j * HASH_MULT)) * HASH_MIX + 1   (uint32)

The CUDA sweep (``csrc/ngram_match.cu``) receives ``HASH_MULT``/``HASH_MIX``
from here as launch arguments, so no other file repeats the constants.

Hash dtype: the port carries hashes as ``HASH_DTYPE`` = int64 holding the
uint32 value in [0, 2**32).  PyTorch's uint32 lacks arithmetic and sorting
on the CPU, so the plain path computes in int64 and masks to 32 bits; the
multiply is split in 16-bit halves so that no int64 product overflows.
A pad token -1 hashes as 0xFFFFFFFF, as the reference's ``astype(uint32)``
does.
"""
from __future__ import annotations

import torch

HASH_MULT = 2654435761        # Knuth multiplicative hash
HASH_MIX = 0x9E3779B9         # golden-ratio odd constant
MASK32 = 0xFFFFFFFF
HASH_DTYPE = torch.int64


def _mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """(a * b) mod 2**32 for int64 ``a`` in [0, 2**32) and 32-bit ``b``."""
    lo = a & 0xFFFF
    hi = a >> 16
    return (lo * b + (((hi * b) & 0xFFFF) << 16)) & MASK32


def hash_step(h: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
    """One token folded into the running hash. h: int64 in [0, 2**32)."""
    t = tok.to(torch.int64) & MASK32
    return (_mul32(h ^ _mul32(t, HASH_MULT), HASH_MIX) + 1) & MASK32


def hash_rows(rows: torch.Tensor) -> torch.Tensor:
    """Hash over the last axis of ``rows`` (..., w) -> (...) HASH_DTYPE."""
    h = torch.zeros(rows.shape[:-1], dtype=HASH_DTYPE, device=rows.device)
    for j in range(rows.shape[-1]):
        h = hash_step(h, rows[..., j])
    return h
