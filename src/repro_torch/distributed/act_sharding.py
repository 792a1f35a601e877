"""Activation-sharding constraints, installable hook (port of
``repro/distributed/act_sharding.py``).

Model code is mesh-agnostic; an owner (``ServingEngine``, a training loop)
activates a mesh around its own calls and the model calls
``constrain(x, kind)`` at the few points where the reference helps GSPMD's
propagation.  On a DTensor, ``constrain`` redistributes it to the kind's
placements; on a plain tensor, or with no mesh installed, it returns ``x``.

  - "residual": the (B, T, d) stream carried between blocks: batch over
    ("pod","data"), sequence over "model" when it divides.
  - "logits": (B, Tc, V) loss chunks: vocab over "model".
  - "ctx_logits" / "ctx_out": the verify attention's context logits and
    value contraction, in the cache's sharding.
  - "hidden_ffn": an FFN hidden activation, its last dim over "model".

Unlike the reference's sharder, an installed mesh leaves the kernels'
route alone: the model hands them this rank's local tensors
(``distributed/local.py``), and ``kernels/dispatch.py`` follows those.
"""
from __future__ import annotations

import contextlib
from typing import Iterator, Optional

from .sharding import axis_sizes, resolve_axis, to_placements

_MESH = None


def _batch(mesh, b: int):
    """Activation batch dims replicate legitimately when odd (a 3-row
    partial batch is routine, not a mis-sized mesh): resolve quietly."""
    return resolve_axis(mesh, "embed", b, warn=False)


def install(mesh) -> None:
    """Set the process-global activation sharder.  Prefer ``activated``:
    a bare install leaks the mesh across engines and tests: every later
    caller's DTensors are constrained to it."""
    global _MESH
    # repro-lint: allow(global-state): the bare install API; uninstall() pairs it, activated() scopes it
    _MESH = mesh


def uninstall() -> None:
    install(None)


def installed() -> bool:
    return _MESH is not None


def current():
    """The installed mesh, or None."""
    return _MESH


@contextlib.contextmanager
def activated(mesh) -> Iterator[None]:
    """Scoped install: the sharder is active inside the block and the
    PREVIOUS value is restored on exit (exception-safe), so one engine's
    mesh can never leak into another engine's calls.  ``activated(None)``
    is a no-op scope."""
    global _MESH
    prev = _MESH
    _MESH = mesh
    try:
        yield
    finally:
        _MESH = prev


def spec_of(mesh, kind: str, shape) -> Optional[tuple]:
    """The spec ``constrain`` gives a tensor of ``shape`` (None: left
    alone)."""
    ndim = len(shape)
    if kind == "residual" and ndim == 3:
        B, T, _ = shape
        # sequence parallelism is opportunistic (decode-time T = w+1 is
        # tiny and legitimately replicated): no fallback warning here
        return (_batch(mesh, B), resolve_axis(mesh, "heads", T, warn=False),
                None)
    if kind == "logits" and ndim == 3:
        B, _, V = shape
        return (_batch(mesh, B), None, resolve_axis(mesh, "vocab", V))
    if kind == "ctx_logits" and ndim == 6:
        # (B, K, n_kv, G, w1, S): keep them in the CACHE's sharding (kv
        # heads over "model" when divisible, else the cache sequence)
        B, _, n_kv, _, _, S = shape
        n_ax = resolve_axis(mesh, "kv", n_kv, warn=False)
        s_ax = None
        if n_ax is None and S % axis_sizes(mesh).get("model", 1) == 0:
            s_ax = "model"
        return (_batch(mesh, B), None, n_ax, None, None, s_ax)
    if kind == "ctx_out" and ndim == 6:
        # (B, K, w1, n_kv, G, hd): batch-only
        return (_batch(mesh, shape[0]),) + (None,) * 5
    if kind == "hidden_ffn" and ndim >= 2:
        return ((_batch(mesh, shape[0]),) + (None,) * (ndim - 2)
                + (resolve_axis(mesh, "ffn", shape[-1]),))
    return None


def constrain(x, kind: str):
    if _MESH is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    spec = spec_of(_MESH, kind, tuple(x.shape))
    if spec is None:
        return x
    return x.redistribute(_MESH, to_placements(_MESH, spec))
