"""Level-1 (runtime) rules over the real engine entry points (the port's
counterpart of ``repro/analysis/jaxpr_rules.py``).

The reference traces its jitted bodies and reads the jaxpr; the port's
step is eager torch, so each rule watches a real run instead: the real
``spec_step``, ``admit_slot`` and ``release_slot`` on each registry case's
concrete state (``registry.py``), after one warm step that builds the
per-device constant caches.

  - ``in-place``        (the reference's ``donation``) — every
    ``DecodeState`` leaf, ``model/*`` and ``stats/*`` included, keeps its
    storage (``untyped_storage().data_ptr()``) across step, admit and
    release, and no two leaves share one storage.  The reference donates
    its state so XLA updates it in place; the port's claim is the same,
    and a CUDA graph of the step (which replays into fixed addresses)
    needs it.
  - ``state-signature`` (the reference's ``trace-signature``) — the
    state's structure and every leaf's shape, dtype and device are a fixed
    point of step, admit and release.
  - ``host-sync``       (the runtime half; the AST half is
    ``ast_rules.serving_sync_findings``) — a ``TorchDispatchMode`` records
    every op of the step that reads device data to the host or would
    synchronise on CUDA (``D2H_OPS``, a ``repeat_interleave`` without
    ``output_size``, an index by a bool mask, a copy across devices) or
    makes a tensor from host data (``lift_fresh``).  Admission and release
    stay outside a captured step, so there only the device->host entries
    count.  On a CUDA state the step also runs under
    ``torch.cuda.set_sync_debug_mode("error")``.

  - ``sharding-coverage`` — every ``DecodeState`` leaf of every case has
    a rule (``decode_state_pspec(strict=True)`` on the reference's three
    meshes ``registry.MESHES``) and none degrades to replication (a
    ``ShardingFallbackWarning``): a leaf added without a
    ``DECODE_STATE_LEAF_RULES`` entry is a finding, not a silently
    replicated leaf.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
import warnings
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..core import prng
from ..core.spec_engine import (DecodeState, admit_slot, release_slot,
                                spec_step)
from ..distributed import sharding as shd
from . import registry
from .findings import Finding

PORT_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ANALYSIS_DIR = os.path.dirname(os.path.abspath(__file__))

# ops that read device data to the host (on CUDA each waits for the
# device): scalars, data-dependent output sizes, comparisons to a bool
D2H_OPS = frozenset({
    "_local_scalar_dense", "is_nonzero", "nonzero", "bincount", "_unique",
    "_unique2", "unique_dim", "unique_consecutive", "unique_dim_consecutive",
    "masked_select", "equal", "histc"})
# ops that make a tensor from host data (a host->device copy on CUDA; a
# captured graph would replay the value it saw at capture)
H2D_OPS = frozenset({"lift_fresh", "lift_fresh_copy"})
_INDEX_OPS = frozenset({"index", "index_put", "index_put_",
                        "_index_put_impl_"})
SYNC_SAMPLE_SITES = 3           # distinct call sites named in a message


# ---------------------------------------------------------------------------
# state leaves
# ---------------------------------------------------------------------------
def state_leaves(state: DecodeState) -> Dict[str, torch.Tensor]:
    """{'buf': t, 'model/groups/p0/k': t, 'stats/calls': t, ...}."""
    out: Dict[str, torch.Tensor] = {}

    def walk(prefix: str, v) -> None:
        if isinstance(v, dict):
            for k in sorted(v):
                walk(f"{prefix}/{k}", v[k])
        else:
            out[prefix] = v
    for f in dataclasses.fields(state):
        walk(f.name, getattr(state, f.name))
    return out


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def storages(state: DecodeState) -> Dict[str, int]:
    return {n: _storage(t) for n, t in state_leaves(state).items()}


def signature(state: DecodeState) -> Dict[str, Tuple]:
    return {n: (tuple(t.shape), str(t.dtype), str(t.device))
            for n, t in state_leaves(state).items()}


def shared_storage_findings(state: DecodeState, label: str
                            ) -> List[Finding]:
    """No two leaves may share one storage: a write to one would change
    the other (the reference's ``shared_buffer_findings``)."""
    seen: Dict[int, str] = {}
    out = []
    for name, t in state_leaves(state).items():
        if t.numel() == 0:
            continue
        ptr = _storage(t)
        if ptr in seen:
            out.append(Finding(
                rule="in-place", file=label, line=0,
                message=f"leaves {seen[ptr]!r} and {name!r} share one "
                        f"storage: an in-place write to one changes the "
                        f"other",
                hint="give each leaf its own tensor (no shared zeros, "
                     "views or expand()s)",
                context=f"{label}::shared::{name}"))
        else:
            seen[ptr] = name
    return out


def in_place_findings(before: Dict[str, int], after: DecodeState,
                      label: str) -> List[Finding]:
    """Every leaf of ``after`` must live in the storage its name had in
    ``before``."""
    out = []
    for name, t in state_leaves(after).items():
        if name in before and _storage(t) != before[name]:
            out.append(Finding(
                rule="in-place", file=label, line=0,
                message=f"leaf {name!r} was replaced by a new tensor: the "
                        f"state is not updated in place",
                hint="write the new value into the leaf (copy_, add_, "
                     "index_put_(..., accumulate=True)) instead of "
                     "rebinding it",
                context=f"{label}::realloc::{name}"))
    return out


def signature_findings(before: Dict[str, Tuple], after: DecodeState,
                       label: str) -> List[Finding]:
    """The state's structure and per-leaf (shape, dtype, device) must be a
    fixed point of the call."""
    got = signature(after)
    out = []
    for name in sorted(set(before) | set(got)):
        if name not in before or name not in got:
            which = "output" if name not in before else "input"
            out.append(Finding(
                rule="state-signature", file=label, line=0,
                message=f"state leaf {name!r} exists only in the {which} "
                        f"state: the loop's state changes structure "
                        f"across calls",
                hint="thread the leaf through every entry point (step AND "
                     "the admit/release resets)",
                context=f"signature::{name}::structure"))
        elif before[name] != got[name]:
            out.append(Finding(
                rule="state-signature", file=label, line=0,
                message=f"state leaf {name!r} drifts across the call: in "
                        f"{before[name]} vs out {got[name]}",
                hint="pin the leaf's dtype and shape (watch silent "
                     "upcasts and broadcasts)",
                context=f"signature::{name}::drift"))
    return out


# ---------------------------------------------------------------------------
# host-sync (runtime half)
# ---------------------------------------------------------------------------
def _site() -> str:
    """The innermost frame of the port (outside this package) on the
    stack, as 'models/moe.py:82'."""
    f = sys._getframe(2)
    while f is not None:
        path = os.path.abspath(f.f_code.co_filename)
        if path.startswith(PORT_DIR) and not path.startswith(ANALYSIS_DIR):
            rel = os.path.relpath(path, PORT_DIR).replace(os.sep, "/")
            return f"{rel}:{f.f_lineno}"
        f = f.f_back
    return "<outside the port>"


def _devices(x) -> set:
    return {str(t.device.type) for t in (x if isinstance(x, (list, tuple))
                                         else (x,))
            if isinstance(t, torch.Tensor)}


def classify(func, args, kwargs) -> Optional[str]:
    """'d2h' for an op that reads device data to the host, 'h2d' for one
    that brings host data to the device, None otherwise."""
    name = func.overloadpacket.__name__
    if name in D2H_OPS:
        return "d2h"
    if name in H2D_OPS:
        return "h2d"
    if name == "repeat_interleave" and func._overloadname == "Tensor" \
            and kwargs.get("output_size") is None:
        return "d2h"                    # the output size is read back
    if name in _INDEX_OPS and len(args) > 1:
        idx = args[1] if isinstance(args[1], (list, tuple)) else ()
        if any(isinstance(i, torch.Tensor)
               and i.dtype in (torch.bool, torch.uint8) for i in idx):
            return "d2h"                # a mask index is a nonzero
    if name == "_to_copy" and args:
        src = args[0].device.type
        dst = torch.device(kwargs.get("device") or args[0].device).type
        if src != dst:
            return "d2h" if dst == "cpu" else "h2d"
    if name == "copy_" and len(args) > 1 \
            and isinstance(args[1], torch.Tensor):
        src, dst = args[1].device.type, args[0].device.type
        if src != dst:
            return "d2h" if dst == "cpu" else "h2d"
    return None


class SyncWatch(TorchDispatchMode):
    """Records (op, kind, site) for every op ``classify`` flags."""

    def __init__(self):
        super().__init__()
        self.hits: List[Tuple[str, str, str]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        kind = classify(func, args, kwargs)
        if kind is not None:
            self.hits.append((str(func), kind, _site()))
        return func(*args, **kwargs)


def sync_findings(hits: Sequence[Tuple[str, str, str]], label: str,
                  d2h_only: bool) -> List[Finding]:
    """One finding per flagged op, naming how often and where."""
    by_op: Dict[Tuple[str, str], List[str]] = {}
    for op, kind, site in hits:
        if d2h_only and kind != "d2h":
            continue
        by_op.setdefault((op, kind), []).append(site)
    out = []
    for (op, kind), sites in sorted(by_op.items()):
        where = sorted(set(sites))
        what = ("reads device data to the host" if kind == "d2h"
                else "makes a tensor from host data")
        out.append(Finding(
            rule="host-sync", file=label, line=0,
            message=f"{op} {what}, {len(sites)}x in the call (at "
                    f"{', '.join(where[:SYNC_SAMPLE_SITES])}"
                    f"{', ...' if len(where) > SYNC_SAMPLE_SITES else ''})",
            hint="keep the value on the device (a fixed-length scatter "
                 "for counts, output_size= for repeat_interleave, "
                 "torch.where for masks) and build constants once per "
                 "device",
            context=f"{label}::op::{op}"))
    return out


@contextlib.contextmanager
def _sync_debug_error(device: torch.device):
    """``set_sync_debug_mode("error")`` on a CUDA device, else nothing."""
    if device.type != "cuda":
        yield
        return
    torch.cuda.synchronize(device)
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)


# ---------------------------------------------------------------------------
# one case
# ---------------------------------------------------------------------------
def _admit(built: registry.BuiltCase, state: DecodeState, slot: int,
           prompt) -> DecodeState:
    """Admits ``prompt`` into ``slot``: a sampled request in odd slots of
    a sampling case, greedy otherwise."""
    sampled = built.spec.sampling and slot % 2 == 1
    return admit_slot(built.params, built.cfg, state, slot,
                      torch.from_numpy(prompt), registry.MAX_NEW, -1,
                      temperature=0.8 if sampled else 0.0,
                      top_p=0.9 if sampled else 1.0,
                      rng_key=prng.prng_key(slot))


def _watched(label: str, call: Callable[[], DecodeState],
             before: DecodeState, d2h_only: bool, device: torch.device,
             hook=None, sync_debug: bool = True
             ) -> Tuple[Optional[DecodeState], List[Finding]]:
    """Runs ``call`` under the detectors (and, unless ``d2h_only`` or not
    ``sync_debug``, the CUDA sync debug mode); returns its state (None if
    a synchronising call raised) and the findings."""
    ptrs, sig = storages(before), signature(before)
    watch = SyncWatch()
    findings: List[Finding] = []
    after = None
    with (hook() if hook else contextlib.nullcontext()):
        try:
            with (_sync_debug_error(device) if sync_debug and not d2h_only
                  else contextlib.nullcontext()), watch:
                after = call()
        except RuntimeError as e:
            if "synchroniz" not in str(e):
                raise
            findings.append(Finding(
                rule="host-sync", file=label, line=0,
                message=f"a synchronising call under "
                        f"set_sync_debug_mode('error'): "
                        f"{str(e).splitlines()[0]}",
                hint="see the op findings of the same call",
                context=f"{label}::sync-debug"))
    findings += sync_findings(watch.hits, label, d2h_only)
    if after is not None:
        findings += in_place_findings(ptrs, after, label)
        findings += signature_findings(sig, after, label)
        findings += shared_storage_findings(after, label)
    return after, findings


def check_case(built: registry.BuiltCase, step_hook=None,
               sync_debug: bool = True) -> List[Finding]:
    """Every level-1 rule on one case: slots 0-2 admitted and one warm
    step, then a watched step, a watched admission into slot 3 and a
    watched release of slot 0.  ``step_hook``: a context-manager factory
    entered around the watched step alone (a caller's launch counters).
    ``sync_debug=False`` leaves the CUDA sync debug mode off, so that a
    synchronising step runs to its end and every other rule is read."""
    label = f"<case:{built.name}"
    dev = built.state.buf.device
    state = built.state
    findings = shared_storage_findings(state, f"{label}/empty_state>")
    prompts = registry.prompts(built.cfg)
    for slot in range(registry.NUM_SLOTS - 1):
        state = _admit(built, state, slot, prompts[slot])
    state = spec_step(built.params, built.cfg, built.spec, state,
                      built.tables)
    for name, call, d2h_only, hook in (
            ("spec_step", lambda s: spec_step(built.params, built.cfg,
                                              built.spec, s, built.tables),
             False, step_hook),
            ("admit_slot", lambda s: _admit(built, s, registry.NUM_SLOTS - 1,
                                            prompts[-1]), True, None),
            ("release_slot", lambda s: release_slot(s, 0), True, None)):
        state, got = _watched(f"{label}/{name}>", lambda: call(state), state,
                              d2h_only, dev, hook, sync_debug)
        findings += got
        if state is None:
            break
    return findings


def check_sharding_coverage(
        state: DecodeState, name: str,
        meshes: Sequence[registry.MeshShape] = registry.MESHES
) -> List[Finding]:
    """The ``sharding-coverage`` rule on one case's state: every leaf
    resolved strictly on each mesh; a leaf with no rule, and a replication
    fallback, are findings."""
    findings: List[Finding] = []
    paged = shd.is_paged_state(state)
    shd.reset_fallback_warnings()
    for mesh in meshes:
        label = f"<case:{name}/mesh:{mesh.name}>"
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for path, leaf in shd.state_leaf_items(state):
                leaf_name = "/".join(path)
                try:
                    shd.decode_state_pspec(mesh, path, leaf, paged=paged,
                                           strict=True)
                except KeyError as e:
                    findings.append(Finding(
                        rule="sharding-coverage", file=label, line=0,
                        message=f"DecodeState leaf {leaf_name!r} has no "
                                f"decode_state_pspec rule: {e.args[0]}",
                        hint="add the leaf to distributed/sharding.py's "
                             "DECODE_STATE_LEAF_RULES (and a pspec branch "
                             "if it needs more than slot-row sharding)",
                        context=f"sharding::{leaf_name}"))
        for w in caught:
            if issubclass(w.category, shd.ShardingFallbackWarning):
                findings.append(Finding(
                    rule="sharding-coverage", file=label, line=0,
                    message="replication fallback during state resolution: "
                            + str(w.message).splitlines()[0],
                    hint="registry dims are sized to divide every registry "
                         "mesh: a fallback here means a new leaf hit the "
                         "loud resolve_axis chain; probe with warn=False "
                         "or add a real rule",
                    context=f"sharding-fallback::{mesh.name}"))
    shd.reset_fallback_warnings()
    return findings


def run_level1(cases: Optional[Sequence[registry.Case]] = None,
               device="cpu") -> List[Finding]:
    findings: List[Finding] = []
    for c in (cases if cases is not None else registry.CASES):
        built = registry.build_case(c, device=device)
        findings += check_sharding_coverage(built.state, built.name)
        findings += check_case(built)
    return findings
