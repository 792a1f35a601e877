"""Logical-axis sharding rules with divisibility fallbacks (port of
``repro/distributed/sharding.py``).

Scheme: 2D ("data", "model") per pod, + leading "pod" axis multi-pod.
  - "embed"-like param dims  -> FSDP over ("pod","data"),
  - "heads"/"ffn"/"kv"/"vocab"/"expert" dims -> tensor/expert parallel over
    "model",
  - activation batch         -> ("pod", "data"),
  - KV-cache: kv-heads over "model" when divisible, else the cache
    sequence over "model"; batch over ("pod","data") when divisible, else
    cache sequence over "data" (the batch=1 long-context case).

Every rule degrades to replication when the dim isn't divisible by the mesh
axis: a sharding that cannot be laid out is a bug, a replicated small
tensor is not.

A spec is a tuple with one entry per tensor dim, as the reference's
``PartitionSpec`` is: a mesh-axis name, a tuple of names, or None.  The
rules read only a mapping from axis name to size (``axis_sizes``), so they
run on a ``DeviceMesh`` and on a plain dict alike; ``to_placements`` turns a
spec into DTensor placements, one per mesh dim.  Paths are tuples of key
names: a param's nested dict keys, a ``DecodeState`` leaf's field and dict
keys (``analysis.runtime_rules.state_leaves`` joins them with ``/``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import warnings
from typing import Any, Dict, List, Mapping, Optional, Set, Tuple

Spec = Tuple[Any, ...]

# logical axis -> preferred mesh axes, in fallback order
_LOGICAL = {
    "embed": (("pod", "data"), ("data",)),
    "heads": (("model",),),
    "kv": (("model",),),
    "ffn": (("model",),),
    "vocab": (("model",),),
    "expert": (("model",),),
    None: (),
}


class ShardingFallbackWarning(UserWarning):
    """A logical axis degraded to replication because no mesh-axis chain
    divides the dim.  Correct but memory-costly: a mis-sized mesh serves
    the full replicated tensor on every device."""


# once-per-(logical, dim, mesh-shape) so repeated resolution doesn't spam;
# tests reset it
_FALLBACK_WARNED: set = set()
# scoped recorders (recording_fallbacks): every dead-end fallback is added
# to each active recorder, independent of the once-only warning dedup, so
# that a caller (ServingEngine.mesh_report) can attribute fallbacks to ITS
# OWN spec resolution instead of reading the process-global history
_RECORDERS: List[Set[Tuple[str, int]]] = []


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` (its ``mesh_dim_names``), of
    anything with a ``shape`` mapping (the reference's ``Mesh``, the
    analysis registry's ``MeshShape``), or of a plain mapping."""
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return {str(n): int(s) for n, s in zip(names, mesh.shape)}
    return {str(k): int(v) for k, v in dict(mesh.shape).items()}


def _axis_size(sizes: Dict[str, int], axes: Tuple[str, ...]) -> int:
    return math.prod(sizes[a] for a in axes)


def reset_fallback_warnings() -> None:
    _FALLBACK_WARNED.clear()


def fallback_report() -> List[Tuple[str, int]]:
    """(logical, dim) pairs that degraded to replication so far in this
    PROCESS (all meshes, all callers), sorted.  For a single engine's view
    use ``recording_fallbacks`` around its own spec resolution."""
    return sorted({(lg, d) for lg, d, _ in _FALLBACK_WARNED})


@contextlib.contextmanager
def recording_fallbacks():
    """Collect every replication dead end hit while the context is active,
    repeats included (the once-only warning dedup does not apply), so
    re-resolving a spec tree always yields its full fallback set."""
    rec: Set[Tuple[str, int]] = set()
    _RECORDERS.append(rec)
    try:
        yield rec
    finally:
        # strictly LIFO: pop by position, not remove() (set equality would
        # match a different recorder with equal contents)
        assert _RECORDERS[-1] is rec
        _RECORDERS.pop()


def resolve_axis(mesh, logical: Optional[str], dim: int, *,
                 warn: bool = True):
    """Pick the first fallback whose size divides ``dim`` (else None).

    Replication-on-non-divisible is by design, but it must not be SILENT:
    when every candidate chain fails, a once-per-(axis, dim, mesh)
    ``ShardingFallbackWarning`` fires.  Callers that probe one rule only to
    fall back to ANOTHER sharding (the kv -> sequence cache chain in
    ``state_pspec``) pass ``warn=False``: there the tensor still ends up
    sharded and the warning would be a false alarm.
    """
    if logical is None:
        return None
    sizes = axis_sizes(mesh)
    tried = False
    for axes in _LOGICAL[logical]:
        axes = tuple(a for a in axes if a in sizes)
        if not axes:
            continue
        tried = True
        if dim % _axis_size(sizes, axes) == 0:
            return axes if len(axes) > 1 else axes[0]
    if tried and warn and dim > 1:     # replicating a size-1 dim is free
        for rec in _RECORDERS:
            rec.add((logical, dim))
        key = (logical, dim, tuple(sorted(sizes.items())))
        if key not in _FALLBACK_WARNED:
            _FALLBACK_WARNED.add(key)
            warnings.warn(
                f"logical axis {logical!r} (dim {dim}) divides no mesh axis "
                f"chain of {sizes} — replicating (full per-device "
                f"memory).  Resize the mesh or the dim to shard it.",
                ShardingFallbackWarning, stacklevel=2)
    return None


def spec_for(mesh, logicals: Tuple[Optional[str], ...],
             shape: Tuple[int, ...]) -> Spec:
    assert len(logicals) == len(shape), (logicals, shape)
    return tuple(resolve_axis(mesh, lg, d) for lg, d in zip(logicals, shape))


# ----------------------------------------------------------------------------
# parameter rules, keyed by leaf name
# ----------------------------------------------------------------------------
_PARAM_RULES: Dict[str, Tuple[Optional[str], ...]] = {
    # embeddings
    "embedding": ("vocab", "embed"),
    "lm_head": ("embed", "vocab"),
    # norms
    "scale": (None,),
    "bias": (None,),
    # attention
    "wq": ("embed", "heads"),
    "wk": ("embed", "kv"),
    "wv": ("embed", "kv"),
    "wo": ("heads", "embed"),
    # dense mlps (and shared experts)
    "w_gate": ("embed", "ffn"),
    "w_up": ("embed", "ffn"),
    "w_down": ("ffn", "embed"),
    "shared_gate": ("embed", "ffn"),
    "shared_up": ("embed", "ffn"),
    "shared_down": ("ffn", "embed"),
    # moe (3D expert weights override the 2D mlp rules by rank below)
    "router": ("embed", None),
    # mamba
    "in_proj": ("embed", "ffn"),
    "conv_w": (None, "ffn"),
    "conv_b": ("ffn",),
    "x_proj": ("ffn", None),
    "dt_proj": (None, "ffn"),
    "dt_bias": ("ffn",),
    "A_log": ("ffn", None),
    "D": ("ffn",),
    "out_proj": ("ffn", "embed"),
    # mlstm
    "up_proj": ("embed", "ffn"),
    "w_if": (None, None),
    "b_i": (None,),
    "b_f": (None,),
    "gn_scale": (None,),
    "skip": (None,),
    "down_proj": ("ffn", "embed"),
    # slstm
    "w_in": ("embed", "ffn"),
    "r": (None, None, None, None),
    "b": (None,),
    "ffn_gate": ("embed", "ffn"),
    "ffn_up": ("embed", "ffn"),
    "ffn_down": ("ffn", "embed"),
}

_MOE_3D_RULES = {
    "w_gate": (("expert", "embed", None), (None, "embed", "ffn")),
    "w_up": (("expert", "embed", None), (None, "embed", "ffn")),
    "w_down": (("expert", None, "embed"), (None, "ffn", "embed")),
}


def _names(path) -> Tuple[str, ...]:
    """A path as a tuple of names: a tuple as given, a ``/``-joined string
    split."""
    return tuple(path.split("/")) if isinstance(path, str) else tuple(path)


def param_pspec(mesh, path, leaf) -> Spec:
    names = _names(path)
    name = names[-1]
    shape = tuple(leaf.shape)
    # body/prefix groups are stacked over periods: leading None
    stacked = any(n.startswith("p") and n[1:].isdigit()
                  or n.startswith("pre") for n in names)
    core_shape = shape[1:] if stacked else shape
    if name in _MOE_3D_RULES and len(core_shape) == 3:
        for rule in _MOE_3D_RULES[name]:
            # probe silently (the next rule is the fallback)...
            spec = [resolve_axis(mesh, lg, d, warn=False)
                    for lg, d in zip(rule, core_shape)]
            if spec[0] is not None or rule[0] is None:
                break
        # falls through to the last rule if the expert dim never divided.
        # ...then re-resolve the CHOSEN rule loudly: its dead ends (any
        # dim, not just the leading one) are genuine replication
        spec = [resolve_axis(mesh, lg, d) for lg, d in zip(rule, core_shape)]
    elif name in _PARAM_RULES and len(_PARAM_RULES[name]) == len(core_shape):
        rule = _PARAM_RULES[name]
        spec = [resolve_axis(mesh, lg, d) for lg, d in zip(rule, core_shape)]
    else:
        spec = [None] * len(core_shape)
    if stacked:
        spec = [None] + spec
    return tuple(spec)


def walk(tree, prefix: Tuple[str, ...] = ()):
    """(path, leaf) over a nested dict, keys in insertion order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from walk(v, prefix + (str(k),))
    else:
        yield prefix, tree


def rebuild(tree, fn, prefix: Tuple[str, ...] = ()):
    """The nested dict with ``fn(path, leaf)`` in every leaf's place."""
    if isinstance(tree, dict):
        return {k: rebuild(v, fn, prefix + (str(k),))
                for k, v in tree.items()}
    return fn(prefix, tree)


def params_pspecs(mesh, params) -> Any:
    """The params' nested dict with each leaf's spec in its place."""
    return rebuild(params, lambda p, x: param_pspec(mesh, p, x))


def params_shardings(mesh, params) -> Any:
    """The params' nested dict with each leaf's DTensor placements."""
    return rebuild(params, lambda p, x: to_placements(
        mesh, param_pspec(mesh, p, x)))


# ----------------------------------------------------------------------------
# decode-state rules
# ----------------------------------------------------------------------------
def _batch_axes(mesh, b: int):
    # batch/slot dims are transient and cheap: an odd batch (a 3-prompt
    # partial batch, an odd slot count) replicating is routine, not the
    # mis-sized-mesh memory hazard the fallback warning flags
    return resolve_axis(mesh, "embed", b, warn=False)


def state_pspec(mesh, path, leaf) -> Spec:
    names = _names(path)
    name = names[-1]
    shape = tuple(leaf.shape)
    sizes = axis_sizes(mesh)
    if name == "cur_len":
        return (None,)
    B = shape[1]
    batch = _batch_axes(mesh, B)
    if name in ("k", "v"):                      # (R, B, S, KV, hd)
        _, _, S, KV, hd = shape
        kv_ax = resolve_axis(mesh, "kv", KV, warn=False)   # seq fallback below
        seq_ax = None
        if kv_ax is None and S % sizes.get("model", 1) == 0:
            # kv heads don't divide the model axis (kv=8/2/1 GQA): shard the
            # cache SEQUENCE over "model" instead: attention contracts hd
            # (replicated) and softmaxes over the sharded sequence with
            # small partial-reduce collectives
            seq_ax = "model"
        if batch is None and seq_ax is None:
            # batch=1 long-context: shard the cache sequence over "data"
            seq_ax = "data" if S % sizes.get("data", 1) == 0 else None
        return (None, batch, seq_ax, kv_ax, None)
    if name == "conv":                          # (R, B, dc-1, di)
        return (None, batch, None, resolve_axis(mesh, "ffn", shape[-1]))
    if name == "ssm":                           # (R, B, di, ds)
        return (None, batch, resolve_axis(mesh, "ffn", shape[2]), None)
    if name == "C":                             # (R, B, nh, dh, dh)
        nh_ax = resolve_axis(mesh, "heads", shape[2], warn=False)
        dh_ax = (resolve_axis(mesh, "heads", shape[3]) if nh_ax is None
                 else None)
        return (None, batch, nh_ax, dh_ax, None)
    if name in ("n", "h", "c", "m"):            # (R,B,nh[,dh])
        nh_ax = resolve_axis(mesh, "heads", shape[2], warn=False)
        rest = [None] * (len(shape) - 3)
        if nh_ax is None and len(shape) > 3:
            rest[0] = resolve_axis(mesh, "heads", shape[3])
        return (None, batch, nh_ax, *rest)
    return (None,) * len(shape)


# ----------------------------------------------------------------------------
# full DecodeState rules (live sharded serving)
# ----------------------------------------------------------------------------
# per-slot row leaves of core.spec_engine.DecodeState: dim 0 is the slot
# ("batch") axis; everything trailing is replicated.  The sampling leaves
# (rng_key (B, 2), temperature/top_p (B,)) are ordinary per-slot rows: the
# in-step key split and gumbel draws are row-local, so they shard with
# their slot exactly like the bandit stats.
_STATE_ROW_FIELDS = ("buf", "buf_len", "prompt_len", "budget", "eos_id",
                     "done", "active", "rng_key", "temperature", "top_p")

# The single source of truth for WHICH DecodeState leaves have a sharding
# rule: ``decode_state_pspec(strict=True)`` raises KeyError for any leaf
# matching no entry, and the checker's sharding-coverage rule runs strict
# over every registry case, so adding a DecodeState leaf without extending
# this table is a finding instead of a silently replicated leaf.
# Top-level fields match on the path HEAD; model-cache leaves match on the
# path TAIL (they sit under ``model``, nested per layer).
DECODE_STATE_LEAF_RULES: Dict[str, str] = {
    # --- top-level per-slot rows (match on path head) ---
    **{f: "per-slot row: slot axis over ('pod','data'), rest replicated"
       for f in _STATE_ROW_FIELDS},
    "stats": "telemetry rows: slot axis over ('pod','data')",
    # --- model-cache leaves (match on path tail, under `model`) ---
    "cur_len": "scalar step counter: replicated",
    "k": "KV cache: kv-heads over 'model' else sequence fallback; "
         "paged pool: page axis over ('pod','data')[+'model']",
    "v": "same rule as 'k'",
    "conv": "mamba conv window: channel dim over 'ffn'->'model'",
    "ssm": "mamba ssm state: inner dim over 'ffn'->'model'",
    "C": "mlstm covariance: heads over 'model' else head_dim",
    "n": "mlstm/slstm normalizer: heads over 'model'",
    "h": "slstm hidden: heads over 'model'",
    "c": "slstm cell: heads over 'model'",
    "m": "mlstm/slstm max-stabilizer: heads over 'model'",
    "page_table": "per-slot page map: slot axis over ('pod','data')",
    "n_pages": "per-slot page count: slot axis over ('pod','data')",
    "free_list": "free-page stack: replicated (device-identical mutation)",
    "free_top": "free-stack pointer: replicated",
}


def _page_axes(mesh, num_pages: int, kv_sharded: bool):
    """The paged pool's page axis shards like the linear cache's
    (batch, sequence) pair it replaces: capacity-parallel over
    ("pod","data") when divisible, extended over "model" too when the kv
    heads could not take the model axis (the GQA kv=8/2/1 case, exactly
    the linear layout's sequence-over-"model" fallback)."""
    sizes = axis_sizes(mesh)
    axes: Tuple[str, ...] = ()
    for chain in (("pod", "data"), ("data",)):
        c = tuple(a for a in chain if a in sizes)
        if c and num_pages % _axis_size(sizes, c) == 0:
            axes = c
            break
    if not kv_sharded and "model" in sizes:
        cand = axes + ("model",)
        if num_pages % _axis_size(sizes, cand) == 0:
            axes = cand
    if not axes:
        return None
    return axes if len(axes) > 1 else axes[0]


def decode_state_pspec(mesh, path, leaf, *, paged: bool = False,
                       strict: bool = False) -> Spec:
    """The spec of ONE leaf of a full ``DecodeState``.

    Extends ``state_pspec`` (the model-cache leaves) with the serving-level
    leaves: the token buffer, per-slot scalars and stats rows shard their
    slot axis over ("pod","data"); the paged pool's page axis shards like
    the sequence axis; page tables are slot-sharded and the free stack is
    replicated (every rank mutates it identically: a tiny int32 vector,
    and replication keeps alloc/free/grow free of collectives).

    ``strict=True`` raises ``KeyError`` for a leaf matching no
    ``DECODE_STATE_LEAF_RULES`` entry instead of silently replicating it:
    the mode the checker's sharding-coverage rule runs in.  The engine
    itself stays non-strict: at serve time a replicated unknown leaf is
    correct (just unreviewed), and the checker is where the review is
    forced.
    """
    names = _names(path)
    top, name = names[0], names[-1]
    if strict and top not in DECODE_STATE_LEAF_RULES \
            and name not in DECODE_STATE_LEAF_RULES:
        raise KeyError(
            f"DecodeState leaf {'/'.join(names)!r} matches no "
            f"DECODE_STATE_LEAF_RULES entry — add one (plus a pspec branch "
            f"if it needs more than replication/slot-row sharding)")
    shape = tuple(leaf.shape)
    if top in _STATE_ROW_FIELDS or top == "stats":
        return (_batch_axes(mesh, shape[0]),) + (None,) * (len(shape) - 1)
    # below here: the model-cache subtree
    if name == "page_table":
        return (_batch_axes(mesh, shape[0]), None)
    if name == "n_pages":
        return (_batch_axes(mesh, shape[0]),)
    if name in ("free_list", "free_top"):
        return (None,) * len(shape)
    if paged and name in ("k", "v"):            # pool (R, NP+1, ps, KV, hd)
        # the port's pool holds one trash page past its NP real ones
        # (models/cache.py); the page axis is sized by the real pages
        _, NP, _, KV, _ = shape
        NP -= 1
        kv_ax = resolve_axis(mesh, "kv", KV, warn=False)
        page_ax = _page_axes(mesh, NP, kv_sharded=kv_ax is not None)
        if kv_ax is None and page_ax is None:
            resolve_axis(mesh, "kv", KV)        # end of chain: warn once
        return (None, page_ax, None, kv_ax, None)
    return state_pspec(mesh, path, leaf)


def state_leaf_items(state) -> List[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) of every leaf of a ``DecodeState`` (or of any
    dataclass of tensors and nested dicts), fields in declaration order
    and dict keys sorted, as ``analysis.runtime_rules.state_leaves``
    names them."""
    out: List[Tuple[Tuple[str, ...], Any]] = []

    def walk(prefix, v):
        if isinstance(v, dict):
            for k in sorted(v):
                walk(prefix + (str(k),), v[k])
        else:
            out.append((prefix, v))
    for f in dataclasses.fields(state):
        walk((f.name,), getattr(state, f.name))
    return out


def is_paged_state(state) -> bool:
    """The paged layout, detected from the state itself ("page_table"
    under ``model``), so callers pass the state they actually built."""
    model = getattr(state, "model", None)
    return isinstance(model, dict) and "page_table" in model


def decode_state_pspecs(mesh, state, *, strict: bool = False
                        ) -> Dict[str, Spec]:
    """{leaf path ('/'-joined): spec} for a ``DecodeState``; ``strict`` is
    forwarded to ``decode_state_pspec``."""
    paged = is_paged_state(state)
    return {"/".join(p): decode_state_pspec(mesh, p, leaf, paged=paged,
                                            strict=strict)
            for p, leaf in state_leaf_items(state)}


def decode_state_shardings(mesh, state, *, strict: bool = False
                           ) -> Dict[str, tuple]:
    """{leaf path: DTensor placements} for a ``DecodeState``."""
    return {p: to_placements(mesh, s)
            for p, s in decode_state_pspecs(mesh, state,
                                            strict=strict).items()}


def spec_summary(specs: Mapping[str, Spec]) -> Dict[str, str]:
    """{leaf path: spec text} (the reference's ``str(tuple(spec))``): the
    human-readable half of ``ServingEngine.mesh_report()``."""
    return {p: str(tuple(s)) for p, s in specs.items()}


def batch_pspec(mesh, shape: Tuple[int, ...], batch_dim: int = 0) -> Spec:
    """Tokens / embeds / logits: batch over ("pod","data"), rest
    replicated.  Exception: (3, B, T) M-RoPE positions -> batch_dim=1."""
    spec: List[Any] = [None] * len(shape)
    spec[batch_dim] = _batch_axes(mesh, shape[batch_dim])
    return tuple(spec)


def batch_sharding(mesh, shape: Tuple[int, ...], batch_dim: int = 0
                   ) -> tuple:
    """``batch_pspec`` as DTensor placements on ``mesh``."""
    return to_placements(mesh, batch_pspec(mesh, shape, batch_dim))


def replicated(mesh) -> tuple:
    """Every mesh dim Replicate (the draft tables, scalars)."""
    return to_placements(mesh, ())


# ----------------------------------------------------------------------------
# specs -> DTensor placements
# ----------------------------------------------------------------------------
def to_placements(mesh, spec: Spec) -> tuple:
    """DTensor placements (one per mesh dim, in the mesh's dim order) of a
    spec: a tensor dim sharded over ("pod", "data") is ``Shard(d)`` on both
    mesh dims.  A size-1 axis splits nothing, so it stays ``Replicate``
    (the same layout, and DTensor's view rules then never meet a shard of
    a size-1 split).  The mesh's dim order must list a tuple entry's axes
    in the same order (pod before data before model), as every rule here
    does."""
    from torch.distributed.tensor import Replicate, Shard
    sizes = axis_sizes(mesh)
    names = list(sizes)
    out: List[Any] = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} lists mesh axes out of "
                             f"the mesh's order {names}")
        for a, i in zip(axes, idx):
            if not isinstance(out[i], Replicate):
                raise ValueError(f"mesh axis {a!r} shards two dims of "
                                 f"{spec}")
            if sizes[a] > 1:
                out[i] = Shard(d)
    return tuple(out)
