"""Transformer assembly: a stack of attention blocks with dense MLPs (port of
``repro/models/transformer.py``).

Parameters keep the reference's layout: the layers at one position of the
repeating ``block_pattern`` form a group ``p{j}`` (``pre{i}`` for prefix
layers) whose leaves are stacked over the R repetitions.  A Python loop over
the layers takes the place of the reference's ``lax.scan``.

Execution modes:
  "full"    — forward / scoring: full causal self-attention.
  "prefill" — "full" + write the KV cache (in place).
  "decode"  — T new tokens against the cache, written after (in place).
  "verify"  — the paper's batched speculation: (B, k, w+1) rows attend the
              shared cache bifurcated-ly; the cache is read-only and the
              per-row KV tails are returned for the commit.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..device import resolve_device
from .attention import attn_full, attn_verify
from .cache import group_ids, kv_write, paged_kv_write, prefill_write
from .config import (ATTN, GEGLU, GELU, MOE, NO_MLP, RELU2, SWIGLU,
                     BlockSpec, ModelConfig)
from .layers import apply_mlp, apply_norm, dense_init, embed_init

Params = Dict[str, Any]


# ----------------------------------------------------------------------------
# parameter shapes and init
# ----------------------------------------------------------------------------
def _check_block(cfg: ModelConfig, spec: BlockSpec) -> None:
    if spec.mixer != ATTN or spec.mlp == MOE:
        raise NotImplementedError(
            f"{cfg.name}: {spec} blocks are not ported yet (attention "
            f"blocks with dense MLPs only)")


def param_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    """Nested dict of (shape, init) leaves in the reference's layout, with
    init one of "dense", "embed", "ones", "zeros"."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H, KV = cfg.num_heads, cfg.num_kv_heads

    def norm(R=None):
        lead = () if R is None else (R,)
        out = {"scale": (lead + (d,), "ones")}
        if cfg.norm != "rmsnorm":
            out["bias"] = (lead + (d,), "zeros")
        return out

    embed = {"embedding": ((cfg.vocab_size, d), "embed")}
    if not cfg.tie_embeddings:
        embed["lm_head"] = ((d, cfg.vocab_size), "dense")
    shapes: Dict[str, Any] = {"embed": embed, "final_norm": norm()}
    for gid, spec, R in group_ids(cfg):
        _check_block(cfg, spec)
        block = {"norm1": norm(R),
                 "mixer": {"wq": ((R, d, H * hd), "dense"),
                           "wk": ((R, d, KV * hd), "dense"),
                           "wv": ((R, d, KV * hd), "dense"),
                           "wo": ((R, H * hd, d), "dense")}}
        if spec.mlp != NO_MLP:
            block["norm2"] = norm(R)
            if spec.mlp in (SWIGLU, GEGLU):
                block["mlp"] = {"w_gate": ((R, d, cfg.d_ff), "dense"),
                                "w_up": ((R, d, cfg.d_ff), "dense"),
                                "w_down": ((R, cfg.d_ff, d), "dense")}
            elif spec.mlp in (RELU2, GELU):
                block["mlp"] = {"w_up": ((R, d, cfg.d_ff), "dense"),
                                "w_down": ((R, cfg.d_ff, d), "dense")}
        shapes[gid] = block
    return shapes


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> Params:
    """Random parameters with the reference's distributions, drawn on the
    target device from one seeded ``torch.Generator`` (the values differ
    from the reference's, whose RNG differs)."""
    cfg.validate()
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def make(tree):
        if isinstance(tree, dict):
            return {k: make(v) for k, v in tree.items()}
        shape, init = tree
        if init == "dense":
            return dense_init(shape, cfg.param_dtype, gen, dev)
        if init == "embed":
            return embed_init(shape, cfg.param_dtype, gen, dev)
        fill = torch.ones if init == "ones" else torch.zeros
        return fill(shape, dtype=cfg.param_dtype, device=dev)

    return make(param_shapes(cfg))


# ----------------------------------------------------------------------------
# one block in one mode
# ----------------------------------------------------------------------------
def _apply_block(bp: Params, x: torch.Tensor, cfg: ModelConfig,
                 spec: BlockSpec, mode: str, gst: Optional[Dict],
                 ctx: Dict) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Returns (x_out, kv tails (verify) or None).  ``gst`` holds the
    layer's (B, S, KV, hd) cache views, or its (NP + 1, ps, KV, hd) pool
    view when ``ctx["paged"]``; prefill/decode write them in place, a paged
    write through the physical slots ``ctx["slots"]`` that the caller
    computed once for every layer."""
    h = apply_norm(bp["norm1"], x, cfg)
    tails = None
    paged = ctx.get("paged", False)
    if mode in ("full", "prefill"):
        y, (k_new, v_new) = attn_full(bp["mixer"], h, cfg, ctx["positions"])
        if mode == "prefill":
            if paged:
                paged_kv_write(gst["k"], gst["v"], k_new, v_new,
                               ctx["slots"])
            else:
                prefill_write(cfg, gst["k"], gst["v"], k_new, v_new)
    elif mode == "decode":
        # decode = verify with one row: the block attends the shared cache
        # and its own causal tail, then its KV is written (in place)
        y, k_t, v_t = attn_verify(bp["mixer"], h[:, None], cfg,
                                  ctx["positions"], gst["k"], gst["v"],
                                  ctx["cache_pos"], ctx["cur_len"],
                                  page_table=ctx.get("page_table"))
        y = y[:, 0]
        write = paged_kv_write if paged else kv_write
        write(gst["k"], gst["v"], k_t[:, 0], v_t[:, 0], ctx["slots"])
    elif mode == "verify":
        K = ctx["k_rows"]
        B = h.shape[0] // K
        hv = h.reshape(B, K, h.shape[-2], h.shape[-1])
        y, k_t, v_t = attn_verify(bp["mixer"], hv, cfg, ctx["positions"],
                                  gst["k"], gst["v"], ctx["cache_pos"],
                                  ctx["cur_len"],
                                  page_table=ctx.get("page_table"),
                                  tail_mask=ctx.get("tail_mask"))
        y = y.reshape(x.shape)
        tails = {"k_tail": k_t, "v_tail": v_t}
    else:
        raise ValueError(mode)
    x = x + y.to(x.dtype)
    if spec.mlp != NO_MLP:
        h2 = apply_norm(bp["norm2"], x, cfg)
        x = x + apply_mlp(bp["mlp"], h2, cfg, spec.mlp).to(x.dtype)
    return x, tails


def _index(tree, r: int):
    if isinstance(tree, dict):
        return {k: _index(v, r) for k, v in tree.items()}
    return tree[r]


def _layers(cfg: ModelConfig):
    """(gid, spec, r) per layer, in execution order."""
    out = [(f"pre{i}", b, 0) for i, b in enumerate(cfg.prefix_blocks)]
    for r in range(cfg.num_periods):
        out += [(f"p{j}", b, r) for j, b in enumerate(cfg.block_pattern)]
    return out


# ----------------------------------------------------------------------------
# full stack
# ----------------------------------------------------------------------------
def run_stack(params: Params, cfg: ModelConfig, x: torch.Tensor, mode: str,
              state: Optional[Dict], ctx: Dict
              ) -> Tuple[torch.Tensor, Dict[str, Dict[str, torch.Tensor]]]:
    """Apply every layer. Returns (x, kv tails per gid stacked over R —
    verify mode only, else {})."""
    tails: Dict[str, Dict[str, list]] = {}
    for gid, spec, r in _layers(cfg):
        gst = (None if state is None
               else _index(state["groups"][gid], r))
        x, t = _apply_block(_index(params[gid], r), x, cfg, spec, mode, gst,
                            ctx)
        if t is not None:
            g = tails.setdefault(gid, {"k_tail": [], "v_tail": []})
            g["k_tail"].append(t["k_tail"])
            g["v_tail"].append(t["v_tail"])
    return x, {gid: {k: torch.stack(v) for k, v in g.items()}
               for gid, g in tails.items()}
