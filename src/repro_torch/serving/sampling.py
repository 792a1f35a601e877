"""Sampling policies for one-off draws from a logits row (port of
``repro/serving/sampling.py``).

The engine serves temperature and top-p requests losslessly through the
speculative step itself (``core/verify.py``); these are the plain,
non-speculative primitives.  They shape logits with the same
``core.verify.shape_logits`` the step uses, and draw as
``jax.random.categorical`` does (gumbel-max over the shaped logits, the
noise from ``core/prng.py``), so a key gives the reference's token.
"""
from __future__ import annotations

import torch

from ..core import prng
from ..core.verify import shape_logits


def greedy(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)


def temperature_sample(rng, logits: torch.Tensor, temperature: float = 1.0,
                       top_p: float = 1.0) -> torch.Tensor:
    """Token ids from ``logits`` (..., V) at ``temperature`` with optional
    nucleus (top-p) truncation, under the (2,) key ``rng``.

    ``temperature == 0`` is explicit greedy; a NEGATIVE temperature raises
    (it is always a caller's bug, which degrading it to greedy would
    hide).  Logits are upcast to float32 before the temperature division
    (``shape_logits``): half precision over a small temperature overflows.
    """
    if temperature < 0.0:
        raise ValueError(
            f"temperature must be >= 0, got {temperature} (pass 0 for "
            f"greedy; a negative value is always a bug)")
    if temperature == 0.0:
        return greedy(logits)
    shaped = shape_logits(logits, temperature,
                          None if top_p >= 1.0 else top_p)
    noise = prng.gumbel(prng.as_key(rng, logits.device), shaped.shape)
    return torch.argmax(shaped + noise, dim=-1).to(torch.int32)
