"""Counter-based random numbers with the bits of ``jax.random`` (the port's
counterpart of what the reference takes from it).

The reference keys every sampling event with jax's default PRNG,
threefry-2x32 (Salmon et al., "Parallel random numbers: as easy as 1, 2,
3", SC 2011) under jax's defaults ``jax_default_prng_impl=threefry2x32``
and ``jax_threefry_partitionable=True``.  This module implements the same
functions in torch integer operations, so that the port draws the same
keys, bits and noise as the reference, on any device:

  - ``threefry2x32``: 20 rounds of add / rotate / xor with a key injection
    every 4 rounds (rotations 13 15 26 6 and 17 29 16 24, parity constant
    0x1BD11BDA);
  - ``prng_key(seed)``: ``(0, seed mod 2**32)``, as ``jax.random.PRNGKey``
    builds it with 64-bit types off (jax's default);
  - ``fold_in(key, d)``: ``threefry2x32(key, (0, d))``;
  - ``split(key, n)``: ``threefry2x32(key, (0, iota(n)))``, one key per
    counter, the two output words side by side;
  - ``random_bits32(key, shape)``: ``bits1 ^ bits2`` of
    ``threefry2x32(key, (hi, lo) of the row-major iota over shape)``;
  - ``uniform``: the top 23 bits as a mantissa of [1, 2), minus 1, scaled
    into [minval, maxval) and clamped below at minval;
  - ``gumbel`` (mode "low"): ``-log(-log(uniform(tiny, 1)))``.

A key is an int64 tensor of shape (..., 2) whose entries hold the two
uint32 words (torch has no full set of uint32 operators): every sum is
masked to 32 bits, so every shift is logical.  Leading dimensions batch:
``split`` of (B, 2) keys is the reference's ``jax.vmap(jax.random.split)``.
Nothing here reads the host or uses torch's own generators, so keys can
live in a decoding state on the card and split inside a step.  Integer
results equal jax's bit for bit; ``gumbel`` differs from jax's only where
``log`` rounds its last bit differently.
"""
from __future__ import annotations

import functools
import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
F32_TINY = float(np.finfo(np.float32).tiny)


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The threefry-2x32 block cipher of the counter words (x1, x2) under
    the key words (k1, k2).  int64 tensors holding uint32 values,
    broadcast together; returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & MASK32
    x2 = (x2 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK32
            x2 = ((x2 << r) & MASK32) | (x2 >> (32 - r))
            x2 = x1 ^ x2
        x1 = (x1 + ks[(i + 1) % 3]) & MASK32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x1, x2


def as_key(key, device=None) -> torch.Tensor:
    """A key (..., 2) as the int64 tensor this module uses: accepts a torch
    tensor of any integer type, or anything numpy reads (a ``jax.random``
    uint32 key converted with ``np.asarray``)."""
    if not torch.is_tensor(key):
        key = torch.from_numpy(np.asarray(key).astype(np.int64))
    return (key.to(device=device, dtype=torch.int64)) & MASK32


def prng_key(seed: int, device="cpu") -> torch.Tensor:
    """The (2,) key of an integer seed: ``(0, seed mod 2**32)``, as
    ``jax.random.PRNGKey(seed)`` gives it with 64-bit types off."""
    return torch.tensor([0, int(seed) & MASK32], dtype=torch.int64,
                        device=device)


def fold_in(key: torch.Tensor, data: Union[int, torch.Tensor]
            ) -> torch.Tensor:
    """``jax.random.fold_in``: a new key from ``key`` (..., 2) and the
    integer ``data`` (broadcast against the key's leading dimensions)."""
    d = torch.as_tensor(data, dtype=torch.int64, device=key.device) & MASK32
    y1, y2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack([y1, y2], dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: (..., 2) keys -> (..., num, 2) new keys."""
    n = torch.arange(num, dtype=torch.int64, device=key.device)
    y1, y2 = threefry2x32(key[..., 0, None], key[..., 1, None],
                          torch.zeros_like(n), n)
    return torch.stack([y1, y2], dim=-1)


def random_bits32(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.bits`` at 32 bits: (..., 2) keys -> (..., *shape) int64
    tensor of uint32 values, one counter per element in row-major order."""
    shape = tuple(shape)
    n = torch.arange(math.prod(shape), dtype=torch.int64, device=key.device)
    y1, y2 = threefry2x32(key[..., 0, None], key[..., 1, None], n >> 32,
                          n & MASK32)
    return (y1 ^ y2).reshape(key.shape[:-1] + shape)


def uniform(key: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32 over [minval, maxval), bit for bit
    where the span is 1 (the defaults, and gumbel's [tiny, 1)); other
    spans may differ in the last bit, where XLA fuses the multiply-add.
    The bounds are float32 values taken on the host, as jax converts
    them: a tensor made from them would be a host-to-device copy, which
    stalls the step behind the card."""
    bits = random_bits32(key, shape)
    floats = (((bits >> 9) | 0x3F800000).to(torch.int32)
              .view(torch.float32) - 1.0)
    lo = np.float32(minval)
    span = float(np.float32(maxval) - lo)
    return (floats * span + float(lo)).clamp_min(float(lo))


@functools.cache
def _cpu_log_initialised() -> None:
    """One single-threaded float32 log before any parallel one.  The CPU
    build's first float32 ``torch.log`` of a process (MKL's vector math),
    when it runs on several threads at once, returns results ~1e-4 off on
    some of them (seen with torch 2.13 in 2 of 6 fresh processes, never
    after one single-threaded call)."""
    torch.log(torch.ones(1))


def gumbel(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.gumbel`` (mode "low"), float32: (..., 2) keys ->
    (..., *shape) standard Gumbel noise."""
    if key.device.type == "cpu":
        _cpu_log_initialised()
    return -torch.log(-torch.log(uniform(key, shape, F32_TINY, 1.0)))
