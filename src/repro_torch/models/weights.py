"""Parameters from npz checkpoints, the reference package's or the port's
(``train/checkpoint.py`` writes the same layout).

The reference saves parameters flattened with '/'-joined key paths
(``embed/embedding``, ``final_norm/scale``, ``p0/mixer/wq``, ...), group
leaves stacked over R (``repro/train/checkpoint.py``).  The port keeps the
same nested layout, so loading is an unflatten plus a dtype/device move,
checked leaf by leaf against ``transformer.param_shapes``.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..device import resolve_device
from .config import ModelConfig
from .transformer import param_shapes


def _to_tensor(arr: np.ndarray) -> torch.Tensor:
    """A leaf as a tensor.  bfloat16 comes as ml_dtypes' in-memory array or
    as the raw 2-byte records (``|V2``) that ``np.savez`` writes for one
    and ``np.load`` reads back: both are bf16 bits."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16" or arr.dtype == np.dtype("V2"):
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr.copy())


def from_jax_flat(flat: Dict[str, np.ndarray], cfg: ModelConfig,
                  device="cuda") -> Dict[str, Any]:
    """The port's parameters from the reference's flattened parameters
    (``{'embed/embedding': array, 'p0/mixer/wq': (R, d, H*hd) array, ...}``),
    each leaf in its dtype in ``transformer.param_shapes`` (the config's
    ``param_dtype``; float32 for Mamba's ``A_log``, ``D`` and ``dt_bias``,
    the xLSTM gate biases and sLSTM's ``r``, and the MoE router, as the
    reference keeps them) on ``device``.  Raises on a missing, extra
    or misshapen leaf."""
    dev = resolve_device(device)
    out: Dict[str, Any] = {}
    want: Dict[str, tuple] = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            key = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                walk(v, key)
            else:
                want[key] = v
    walk(param_shapes(cfg), "")
    missing = sorted(set(want) - set(flat))
    extra = sorted(set(flat) - set(want))
    if missing or extra:
        raise ValueError(f"{cfg.name}: checkpoint keys differ — missing "
                         f"{missing}, unexpected {extra}")
    for key, (shape, _, dtype) in want.items():
        arr = flat[key]
        if tuple(arr.shape) != tuple(shape):
            raise ValueError(f"{cfg.name}: {key} has shape {arr.shape}, "
                             f"expected {shape}")
        node = out
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = _to_tensor(arr).to(device=dev, dtype=dtype)
    return out


def load_npz(path: str, cfg: ModelConfig, device="cuda") -> Dict[str, Any]:
    """Parameters from a reference ``.npz`` checkpoint."""
    with np.load(path if path.endswith(".npz") else path + ".npz") as data:
        return from_jax_flat({k: data[k] for k in data.files}, cfg, device)
