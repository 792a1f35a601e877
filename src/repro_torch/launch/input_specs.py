"""Fake-tensor stand-ins and per-rank step programs for the dry-run matrix
(port of ``repro/launch/input_specs.py``).

For each (architecture, input-shape) pair this module builds:
  - the step the production server runs, as rank 0's program over the mesh
      prefill_32k -> prefill          (last-position logits only)
      decode_32k  -> decode           (1 new token, 32k KV cache; the step
                                       emits the argmax, the state is
                                       written in place) and
                     verify           (the paper: (k, w+1) verification)
      long_500k   -> decode at 524k   (recurrent native / window ring)
      train_4k    -> raises: the port's mesh serves and does not train yet
  - its inputs as fake tensors (``FakeTensorMode``: nothing is allocated)
    at full size, the parameters and the state as DTensors placed by the
    port's rules (``distributed/sharding.py``), each holding rank 0's
    local shard.

The reference jits one global program and lets GSPMD partition it; the
port's counterpart is the program each rank runs under ``ServingEngine(
mesh=)``: the state's local tensors (``local.local_model``), the batch's
local rows (``local.rows_for``), the model functions inside
``act_sharding.activated(mesh)`` and ``local.active(rows)``.  A batch that
divides no batch axis (long_500k's one row) is replicated, as the rule
replicates it, and every rank runs it whole.

Skips (DESIGN.md §5): encoder-only archs have no decode; long_500k uses the
+swa ring-cache variant for full-attention dense archs.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from ..configs import get_config, long_context_variant
from ..device import resolve_device
from ..distributed import act_sharding
from ..distributed import local as DL
from ..distributed import sharding as shd
from ..models import model as M
from ..models.config import ModelConfig
from ..models.transformer import param_shapes

SHAPES: Dict[str, Dict] = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}

# the paper's representative default (k, w) = (10, 10)
SPEC_K, SPEC_W = 10, 10

TRAIN_TODO = ("train_4k needs a sharded train step (a DTensor train step), "
              "ROADMAP.md queue 1's first module; the port's mesh serves "
              "only")


class DryrunCase(NamedTuple):
    name: str
    fn: Callable                 # rank 0's program over ``args``
    args: Tuple[Any, ...]        # fake DTensor pytrees (nested dicts)
    in_shardings: Tuple[Any, ...]   # DTensor placements, like ``args``
    out_shardings: Any
    skip_reason: Optional[str] = None
    donate: Tuple[int, ...] = ()   # args written in place (the state)


def fake_mode():
    """The active ``FakeTensorMode``, or a new one (entered by the
    caller)."""
    from torch._guards import detect_fake_mode
    from torch._subclasses.fake_tensor import FakeTensorMode
    return detect_fake_mode() or FakeTensorMode()


def params_abstract(cfg: ModelConfig, device) -> Dict[str, Any]:
    """The parameters at full size as empty tensors of their dtypes (fake
    under a ``FakeTensorMode``)."""
    return shd.rebuild(param_shapes(cfg), lambda p, leaf: torch.empty(
        leaf[0], dtype=leaf[2], device=device))


def state_abstract(cfg: ModelConfig, batch: int, max_len: int, device
                   ) -> Dict[str, Any]:
    return M.init_state(cfg, batch, max_len, device=device)


def _placed(mesh, tree, rule):
    """(DTensors, placements) of a nested dict: each leaf placed by
    ``rule(mesh, path, leaf)``'s spec, rank 0's shard its local tensor."""
    specs = shd.rebuild(tree, lambda p, t: rule(mesh, p, t))
    flat = dict(shd.walk(specs))
    return (shd.rebuild(tree, lambda p, t: DL.distribute(t, mesh, flat[p])),
            shd.rebuild(specs, lambda p, s: shd.to_placements(mesh, s)))


def _rows(mesh, cfg: ModelConfig, state, B: int) -> DL.Rows:
    """The rows of a B-row state under ``mesh``, with its cache's layout:
    split over the batch axes when B divides them, else every rank's
    (replicated, as ``sharding.batch_pspec`` leaves them)."""
    k = next((t for p, t in shd.walk(state["groups"]) if p[-1] == "k"),
             None)
    layout = DL.CacheLayout() if k is None else DL.cache_layout(
        mesh, cfg, shd.state_pspec(mesh, ("k",), k), tuple(k.shape))
    if B % DL.batch_ways(mesh):
        return DL.Rows(mesh, B, (), 0, B, layout)
    return DL.rows_for(mesh, B, layout)


def resolve_case(arch: str, shape: str, mesh, spec_step: bool = False,
                 num_layers: Optional[int] = None, device="cuda",
                 batch: Optional[int] = None) -> DryrunCase:
    """Build the (possibly skipped) dry-run case for one (arch, shape) on
    ``mesh`` (a ``DeviceMesh``), its fake inputs on ``device`` (the card
    by default).  Call it inside the ``FakeTensorMode`` the trace runs
    under, or it makes one (``args``' leaves carry it).

    ``num_layers`` overrides depth (the roofline calibration's 1- and
    2-period variants); ``batch`` the shape's batch (a card-sized
    anchor).  ``train_4k`` raises ``NotImplementedError``."""
    info = SHAPES[shape]
    cfg = get_config(arch)
    name = f"{arch}|{shape}" + ("|spec" if spec_step else "")

    if cfg.encoder_only and info["kind"] == "decode":
        return DryrunCase(name, None, (), (), None,
                          skip_reason="encoder-only: no decode step "
                                      "(DESIGN.md §5)")
    if info["kind"] == "train":
        raise NotImplementedError(TRAIN_TODO)
    if shape == "long_500k":
        cfg = long_context_variant(cfg)
    if num_layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=num_layers).validate()
    return build_case(name, cfg, info["kind"], batch or info["batch"],
                      info["seq"], mesh, spec_step=spec_step, device=device)


def build_case(name: str, cfg: ModelConfig, kind: str, B: int, T: int,
               mesh, spec_step: bool = False, device="cuda") -> DryrunCase:
    """The case of a serving ``kind`` ("prefill" or "decode") of ``cfg``
    at batch ``B`` and sequence ``T`` on ``mesh``: ``resolve_case``'s
    body, for any config."""
    dev = resolve_device(device)
    with fake_mode():
        params, p_shd = _placed(mesh, params_abstract(cfg, dev),
                                shd.param_pspec)
        st_abs = state_abstract(cfg, B, T, dev)
        state, st_shd = _placed(mesh, st_abs, shd.state_pspec)
        rows = _rows(mesh, cfg, st_abs, B)
        if kind == "prefill":
            if cfg.embedding_inputs:
                x_abs = torch.empty((B, T, cfg.d_model), dtype=torch.bfloat16,
                                    device=dev)
            else:
                x_abs = torch.empty((B, T), dtype=torch.int32, device=dev)
        elif spec_step:
            x_abs = torch.empty((B, SPEC_K, SPEC_W + 1), dtype=torch.int32,
                                device=dev)
        else:
            x_abs = torch.empty((B, 1), dtype=torch.int32, device=dev)
        x_spec = shd.batch_pspec(mesh, tuple(x_abs.shape))
        x = DL.distribute(x_abs, mesh, x_spec)
    x_shd = shd.to_placements(mesh, x_spec)
    repl = shd.replicated(mesh)

    def program(body):
        def fn(params, state, x):
            loc = DL.local_model(state, rows)
            with act_sharding.activated(mesh), DL.active(rows):
                out = body(params, loc, x.to_local())
            return out
        return fn

    if kind == "prefill":
        key = "embeds" if cfg.embedding_inputs else "tokens"

        def body(params, loc, x):
            logits, _ = M.prefill(params, cfg, loc, last_only=True,
                                  **{key: x})
            return logits

        def fn(params, state, x):
            logits = program(body)(params, state, x)
            DL.sync_cur_len(state, rows)
            return logits, state
        return DryrunCase(name, fn, (params, state, x),
                          (p_shd, st_shd, x_shd), (repl, st_shd),
                          donate=(1,))

    if not spec_step:
        def body(params, loc, x):
            logits, _ = M.decode(params, cfg, loc, x)
            # serve semantics: the step emits the next token, not the
            # (B, vocab) logits
            return torch.argmax(logits, dim=-1).to(torch.int32)

        def fn(params, state, x):
            toks = program(body)(params, state, x)
            DL.sync_cur_len(state, rows)
            return toks, state
        return DryrunCase(name, fn, (params, state, x),
                          (p_shd, st_shd, x_shd), (x_shd, st_shd),
                          donate=(1,))

    # the paper's speculative verification step (k, w+1): the state is read
    def body(params, loc, x):
        logits, tails = M.verify(params, cfg, loc, x)
        return torch.argmax(logits, dim=-1), tails
    return DryrunCase(name, program(body), (params, state, x),
                      (p_shd, st_shd, x_shd), None)
