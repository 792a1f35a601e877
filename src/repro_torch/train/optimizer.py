"""AdamW and its schedule over the port's nested dicts of tensors (port of
``repro/train/optimizer.py``).

The optimizer state mirrors the parameters: m and v moments in float32 and
a step counter, an int32 tensor on the parameters' device.  The update
follows the reference's arithmetic: clip by the global norm (+ 1e-9), bias
corrections from ``step + 1`` in float32, decoupled weight decay on leaves
of ndim >= 2 only (stacked over R, as the reference's are, so the same set),
the update in float32 cast back to the leaf's dtype.  Plain torch ops, one
leaf at a time: no kernel.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 1000
    min_lr_ratio: float = 0.1


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of nested dicts of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """The leaves in sorted-key order (the reference's pytree order)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def cosine_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``cfg.lr``, then a cosine down to ``min_lr_ratio``
    of it; ``step`` an int tensor, the result float32."""
    warm = cfg.lr * torch.clamp((step + 1) / max(cfg.warmup_steps, 1),
                                max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return torch.where(step < cfg.warmup_steps, warm, cfg.lr * cos)


def init_opt_state(params: Any) -> Dict[str, Any]:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    dev = tree_leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float()))
                          for leaf in tree_leaves(tree)))


def adamw_update(cfg: AdamWConfig, params: Any, grads: Any,
                 opt_state: Dict[str, Any], donate: bool = False
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step.  Returns (new params, new optimizer state, metrics
    {"grad_norm", "lr"}); the inputs are left as they are, unless
    ``donate``: then each leaf's new values are copied into the params and
    moments passed in, one leaf at a time, and those tensors are returned
    (the same bits; the step then holds one state and one leaf's
    temporaries, where the functional update holds two states)."""
    step = opt_state["step"]
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = cosine_lr(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** (step.float() + 1)
    bc2 = 1 - b2 ** (step.float() + 1)

    def upd(p, g, m, v):
        g = g.float() * scale
        m_new = b1 * m + (1 - b1) * g
        v_new = b2 * v + (1 - b2) * torch.square(g)
        delta = (m_new / bc1) / (torch.sqrt(v_new / bc2) + cfg.eps)
        if p.dim() >= 2:  # decoupled weight decay on matrices only
            delta = delta + cfg.weight_decay * p.float()
        new = (p.float() - lr * delta).to(p.dtype), m_new, v_new
        if donate:
            for old, n in zip((p, m, v), new):
                old.copy_(n)
            return p, m, v
        return new

    with torch.no_grad():
        out = tree_map(upd, params, grads, opt_state["m"], opt_state["v"])
    part = lambda i: tree_map(lambda o: o[i], out)
    return (part(0), {"m": part(1), "v": part(2), "step": step + 1},
            {"grad_norm": gnorm, "lr": lr})
