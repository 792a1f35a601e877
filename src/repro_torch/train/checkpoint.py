"""npz checkpoints in the reference's layout (port of
``repro/train/checkpoint.py``).

Keys are the parameter paths joined with '/' (``embed/embedding``,
``p0/mixer/wq``, ...), in the reference's sorted pytree order, group leaves
stacked over R.  A bfloat16 leaf is written as the raw 2-byte records
(``|V2``) that the reference's ``np.savez`` writes for its ml_dtypes
arrays, so either package's files load into the port
(``models.weights.load_npz``), and the port's float32 files into the
reference's ``load``.
"""
from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np
import torch

from ..models.config import ModelConfig
from ..models.weights import load_npz


def _leaf(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """'/'-joined key paths -> host arrays, keys in sorted order."""
    flat: Dict[str, np.ndarray] = {}
    for k in sorted(tree):
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(tree[k], dict):
            flat.update(flatten(tree[k], key))
        else:
            flat[key] = _leaf(tree[k])
    return flat


def save(path: str, params: Any) -> None:
    """Write ``params`` to ``path`` (``np.savez`` adds ``.npz`` if it is
    missing)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **flatten(params))


def load(path: str, cfg: ModelConfig, device="cuda") -> Dict[str, Any]:
    """Parameters of ``cfg`` from a file of either package, each leaf in its
    ``param_shapes`` dtype on ``device``."""
    return load_npz(path, cfg, device)
