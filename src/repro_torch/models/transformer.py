"""Transformer assembly: a stack of attention, Mamba, mLSTM and sLSTM
blocks with dense or MoE FFNs (port of ``repro/models/transformer.py``).

Parameters keep the reference's layout: the layers at one position of the
repeating ``block_pattern`` form a group ``p{j}`` (``pre{i}`` for prefix
layers) whose leaves are stacked over the R repetitions.  A Python loop over
the layers takes the place of the reference's ``lax.scan``.

Execution modes:
  "full"    — forward / scoring: full causal self-attention, recurrent
              state from zero.
  "prefill" — "full" + write the KV cache and the recurrent state (in place).
  "decode"  — T new tokens against the cache/state, written after (in
              place).
  "replay"  — decode gated per row by ``n_commit``: only the first n_commit
              positions update the KV cache and the recurrent state (the
              speculative commit of the winning row for recurrent stacks).
  "verify"  — the paper's batched speculation: (B, k, w+1) rows attend the
              shared cache bifurcated-ly and run the recurrent mixers from
              their slot's state; nothing is written and the attention
              layers' per-row KV tails are returned for the attention-only
              commit.

Every mode computes the MoE layers' router aux loss (the mean over MoE
layers, as the reference's ``run_stack`` returns it); only training reads
it.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..distributed import act_sharding
from ..distributed import local as L
from .attention import attn_full, attn_verify
from .cache import group_ids, kv_write, paged_kv_write, prefill_write
from . import moe as moe_lib
from . import xlstm as X
from .config import (ATTN, GEGLU, GELU, MAMBA, MLSTM, MOE, NO_MLP, RELU2,
                     SLSTM, SWIGLU, BlockSpec, ModelConfig, layer_blocks)
from .layers import apply_mlp, apply_norm, dense_init, embed_init
from .mamba import (a_log_init, dt_bias_init, init_mamba_state, mamba_mix,
                    mamba_mix_commit)
from .mamba import param_shapes as mamba_param_shapes

Params = Dict[str, Any]


# ----------------------------------------------------------------------------
# parameter shapes and init
# ----------------------------------------------------------------------------
def param_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    """Nested dict of (shape, init, dtype) leaves in the reference's
    layout, with init one of "dense", "dense_lead" (fan-in from the
    per-layer leading dim), "embed", "ones", "zeros", "const:<value>",
    "a_log", "dt_bias", "slstm_b"; dtype is ``cfg.param_dtype`` except for
    the float32 leaves of the Mamba, mLSTM and sLSTM mixers and the MoE
    router."""
    d, hd, pd = cfg.d_model, cfg.resolved_head_dim, cfg.param_dtype
    H, KV = cfg.num_heads, cfg.num_kv_heads

    def norm(R=None):
        lead = () if R is None else (R,)
        out = {"scale": (lead + (d,), "ones", pd)}
        if cfg.norm != "rmsnorm":
            out["bias"] = (lead + (d,), "zeros", pd)
        return out

    embed = {"embedding": ((cfg.vocab_size, d), "embed", pd)}
    if not cfg.tie_embeddings:
        embed["lm_head"] = ((d, cfg.vocab_size), "dense", pd)
    shapes: Dict[str, Any] = {"embed": embed, "final_norm": norm()}
    for gid, spec, R in group_ids(cfg):
        if spec.mixer == MAMBA:
            mixer = mamba_param_shapes(cfg, R)
        elif spec.mixer == MLSTM:
            mixer = X.mlstm_param_shapes(cfg, R)
        elif spec.mixer == SLSTM:
            mixer = X.slstm_param_shapes(cfg, R)
        else:
            mixer = {"wq": ((R, d, H * hd), "dense", pd),
                     "wk": ((R, d, KV * hd), "dense", pd),
                     "wv": ((R, d, KV * hd), "dense", pd),
                     "wo": ((R, H * hd, d), "dense", pd)}
        block = {"norm1": norm(R), "mixer": mixer}
        if spec.mlp != NO_MLP:
            block["norm2"] = norm(R)
            if spec.mlp == MOE:
                block["mlp"] = moe_lib.param_shapes(cfg, R)
            elif spec.mlp in (SWIGLU, GEGLU):
                block["mlp"] = {"w_gate": ((R, d, cfg.d_ff), "dense", pd),
                                "w_up": ((R, d, cfg.d_ff), "dense", pd),
                                "w_down": ((R, cfg.d_ff, d), "dense", pd)}
            elif spec.mlp in (RELU2, GELU):
                block["mlp"] = {"w_up": ((R, d, cfg.d_ff), "dense", pd),
                                "w_down": ((R, cfg.d_ff, d), "dense", pd)}
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
        shape, init, dtype = tree
        if init == "dense":
            return dense_init(shape, dtype, gen, dev)
        if init == "dense_lead":
            # the reference draws each layer's (E, ...) or (4, ...) leaf
            # with its leading dim as the fan-in (scale 1)
            return dense_init(shape, dtype, gen, dev, fan_in=shape[1])
        if init == "embed":
            return embed_init(shape, dtype, gen, dev)
        if init == "a_log":
            return a_log_init(shape, dev)
        if init == "dt_bias":
            return dt_bias_init(shape, gen, dev)
        if init == "slstm_b":
            return X.slstm_bias_init(shape, dev)
        if init.startswith("const:"):
            return torch.full(shape, float(init[6:]), dtype=dtype,
                              device=dev)
        fill = torch.ones if init == "ones" else torch.zeros
        return fill(shape, dtype=dtype, device=dev)

    return make(param_shapes(cfg))


# ----------------------------------------------------------------------------
# one block in one mode
# ----------------------------------------------------------------------------
def _attn_mixer(bp: Params, h: torch.Tensor, cfg: ModelConfig, mode: str,
                gst: Optional[Dict], ctx: Dict):
    """Attention sublayer: (y, kv tails (verify) or None).  ``gst`` holds
    the layer's (B, S, KV, hd) cache views, or its (NP + 1, ps, KV, hd)
    pool view when ``ctx["paged"]``; prefill/decode/replay write them in
    place, a paged write through the physical slots ``ctx["slots"]`` that
    the caller computed once for every layer."""
    paged = ctx.get("paged", False)
    if mode in ("full", "prefill"):
        y, (k_new, v_new) = attn_full(bp, h, cfg, ctx["positions"])
        if mode == "prefill":
            if paged:
                paged_kv_write(gst["k"], gst["v"], k_new, v_new,
                               ctx["slots"])
            else:
                prefill_write(cfg, gst["k"], gst["v"], k_new, v_new)
        return y, None
    if mode in ("decode", "replay"):
        # decode = verify with one row: the block attends the shared cache
        # and its own causal tail, then its KV is written (in place; replay
        # gates the write to each row's first n_commit positions)
        y, k_t, v_t = attn_verify(bp, h[:, None], cfg, ctx["positions"],
                                  gst["k"], gst["v"], ctx["cache_pos"],
                                  ctx["cur_len"],
                                  page_table=ctx.get("page_table"))
        write = paged_kv_write if paged else kv_write
        write(gst["k"], gst["v"], k_t[:, 0], v_t[:, 0], ctx["slots"],
              gate=ctx.get("gate"))
        return y[:, 0], None
    if mode == "verify":
        K = ctx["k_rows"]
        B = h.shape[0] // K
        hv = h.reshape(B, K, h.shape[-2], h.shape[-1])
        y, k_t, v_t = attn_verify(bp, hv, cfg, ctx["positions"],
                                  gst["k"], gst["v"], ctx["cache_pos"],
                                  ctx["cur_len"],
                                  page_table=ctx.get("page_table"),
                                  tail_mask=ctx.get("tail_mask"))
        return y.reshape(h.shape), {"k_tail": k_t, "v_tail": v_t}
    raise ValueError(mode)


def _conv_after(ext: torch.Tensor, n_commit: torch.Tensor, dc: int
                ) -> torch.Tensor:
    """The conv state after n steps, ext[:, n : n+dc-1], per row."""
    idx = n_commit.long()[:, None] + torch.arange(dc - 1,
                                                  device=ext.device)[None]
    return ext.gather(1, idx[..., None].expand(-1, -1, ext.shape[-1]))


def _mamba_mixer(bp: Params, h: torch.Tensor, cfg: ModelConfig, mode: str,
                 gst: Optional[Dict], ctx: Dict) -> torch.Tensor:
    """Mamba sublayer.  ``gst`` holds the layer's (B, dc-1, di) conv and
    (B, di, ds) f32 ssm state views; prefill/decode/replay write them in
    place."""
    if mode in ("full", "prefill"):
        conv0, ssm0 = init_mamba_state(cfg, h.shape[0], h.device)
        y, conv, ssm = mamba_mix(bp, h, cfg, conv0, ssm0,
                                 final=mode == "prefill")
        if mode == "prefill":
            gst["conv"].copy_(conv)
            gst["ssm"].copy_(ssm)
        return y
    if mode == "decode":
        y, conv, ssm = mamba_mix(bp, h, cfg, gst["conv"], gst["ssm"])
        gst["conv"].copy_(conv)
        gst["ssm"].copy_(ssm)
        return y
    if mode == "replay":
        y, ext, ssm = mamba_mix_commit(bp, h, cfg, gst["conv"], gst["ssm"],
                                       ctx["n_commit"])
        gst["conv"].copy_(_conv_after(ext, ctx["n_commit"], cfg.mamba_d_conv))
        gst["ssm"].copy_(ssm)
        return y
    if mode == "verify":
        # every draft row runs from its slot's state; nothing is written
        y, _, _ = mamba_mix(bp, h, cfg, gst["conv"], gst["ssm"],
                            rep=ctx["k_rows"], final=False)
        return y
    raise ValueError(mode)


def _mlstm_mixer(bp: Params, h: torch.Tensor, cfg: ModelConfig, mode: str,
                 gst: Optional[Dict], ctx: Dict) -> torch.Tensor:
    """mLSTM sublayer.  ``gst`` holds the layer's (B, H, dh, dh) C, (B, H,
    dh) n, (B, H) m (f32) and (B, dc-1, di) conv state views;
    prefill/decode/replay write them in place."""
    if mode in ("full", "prefill"):
        st, conv = X.init_mlstm_state(cfg, h.shape[0], h.device)
    else:
        st, conv = (gst["C"], gst["n"], gst["m"]), gst["conv"]
    if mode == "verify":
        return X.mlstm_mix(bp, h, cfg, st, conv, rep=ctx["k_rows"])[0]
    n = ctx.get("n_commit")
    # the chunkwise form is the prefill's option alone, as in the reference
    chunkwise = mode in ("full", "prefill") and ctx.get("chunkwise", False)
    y, st, ext = X.mlstm_mix(bp, h, cfg, st, conv, n_commit=n,
                             chunkwise=chunkwise)
    if mode != "full":
        T = h.shape[1]
        conv = (ext[:, T:] if n is None
                else _conv_after(ext, n, cfg.xlstm_conv_kernel))
        for name, a in zip(("C", "n", "m", "conv"), st + (conv,)):
            gst[name].copy_(a)
    return y


def _slstm_mixer(bp: Params, h: torch.Tensor, cfg: ModelConfig, mode: str,
                 gst: Optional[Dict], ctx: Dict) -> torch.Tensor:
    """sLSTM sublayer.  ``gst`` holds the layer's (B, H, dh) f32 c, n, h, m
    views; prefill/decode/replay write them in place."""
    names = ("c", "n", "h", "m")
    if mode in ("full", "prefill"):
        st = X.init_slstm_state(cfg, h.shape[0], h.device)
    else:
        st = tuple(gst[k] for k in names)
    if mode == "verify":
        return X.slstm_mix(bp, h, cfg, st, rep=ctx["k_rows"])[0]
    y, st = X.slstm_mix(bp, h, cfg, st, n_commit=ctx.get("n_commit"))
    if mode != "full":
        for name, a in zip(names, st):
            gst[name].copy_(a)
    return y


_RECURRENT = {MAMBA: _mamba_mixer, MLSTM: _mlstm_mixer,
              SLSTM: _slstm_mixer}


def _apply_block(bp: Params, x: torch.Tensor, cfg: ModelConfig,
                 spec: BlockSpec, mode: str, gst: Optional[Dict],
                 ctx: Dict) -> Tuple[torch.Tensor, Optional[Dict],
                                     Optional[torch.Tensor]]:
    """Returns (x_out, kv tails (attention in verify mode) or None, the
    MoE aux loss (MoE FFN) or None)."""
    h = apply_norm(bp["norm1"], x, cfg)
    tails = aux = None
    if L.current() is not None:
        h = L.to_rows(h)
        if spec.mixer != ATTN:
            # a recurrent mixer takes this rank's local rows and states
            # and returns the DTensor of the global rows
            h = h.to_local()
    if spec.mixer == ATTN:
        y, tails = _attn_mixer(bp["mixer"], h, cfg, mode, gst, ctx)
    else:
        y = _RECURRENT[spec.mixer](bp["mixer"], h, cfg, mode, gst, ctx)
    x = x + y.to(x.dtype)
    if spec.mlp != NO_MLP:
        h2 = apply_norm(bp["norm2"], x, cfg)
        if L.current() is not None:
            h2 = L.to_rows(h2)
        if spec.mlp == MOE:
            y2, aux = moe_lib.apply_moe(bp["mlp"], h2, cfg)
        else:
            y2 = apply_mlp(bp["mlp"], h2, cfg, spec.mlp)
        x = x + y2.to(x.dtype)
    return x, tails, aux


def _index(tree, r: int):
    if isinstance(tree, dict):
        return {k: _index(v, r) for k, v in tree.items()}
    return tree[r]


def _unbind(tree):
    """Each (R, ...) leaf as the tuple of its R layers' views.  One unbind a
    leaf: under autograd its backward stacks the R layers' gradients in one
    op, where indexing each layer's slice would add R zero-padded (R, ...)
    gradients into the leaf's."""
    if isinstance(tree, dict):
        return {k: _unbind(v) for k, v in tree.items()}
    return tree.unbind(0)


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
              state: Optional[Dict], ctx: Dict, remat: bool = False
              ) -> Tuple[torch.Tensor, Dict[str, Dict[str, torch.Tensor]],
                         torch.Tensor]:
    """Apply every layer. Returns (x, kv tails per attention gid stacked
    over R — verify mode only, else {} —, the MoE aux loss summed over the
    MoE layers in layer order and divided by their number (0 without
    one)).  ``remat`` (``"full"`` mode, the training forward) checkpoints
    each block: backward recomputes its activations instead of keeping
    them (the reference's ``jax.checkpoint(body)``)."""
    if remat and mode != "full":
        raise ValueError(f"remat applies to the full forward, not {mode!r}")
    tails: Dict[str, Dict[str, list]] = {}
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    layers = _layers(cfg)
    views = {gid: _unbind(params[gid]) for gid in {g for g, _, _ in layers}}
    meshed = L.current() is not None
    for gid, spec, r in layers:
        gst = (None if state is None
               else _index(state["groups"][gid], r))
        bp = _index(views[gid], r)
        if meshed:
            bp = L.model_only(bp)
        if remat:
            # bp and spec bound now: backward calls the block again after
            # the loop has moved on
            x, a = checkpoint(lambda xc, bp=bp, spec=spec: _apply_block(
                bp, xc, cfg, spec, mode, None, ctx)[::2], x,
                use_reentrant=False)
            t = None
        else:
            x, t, a = _apply_block(bp, x, cfg, spec, mode, gst, ctx)
        if meshed:
            x = act_sharding.constrain(x, "residual")
        if a is not None:
            aux = aux + a
        if t is not None:
            g = tails.setdefault(gid, {"k_tail": [], "v_tail": []})
            g["k_tail"].append(t["k_tail"])
            g["v_tail"].append(t["v_tail"])
    n_moe = max(sum(b.mlp == MOE for b in layer_blocks(cfg)), 1)
    return x, {gid: {k: torch.stack(v) for k, v in g.items()}
               for gid, g in tails.items()}, aux / n_moe
