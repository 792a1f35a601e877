"""Level-2 (AST) rules over ``src/repro_torch`` (port of
``repro/analysis/ast_rules.py``, in torch's idiom).

Each rule mechanises a contract the port states in prose:

  - ``kernel-scope``   (the reference's ``pallas-scope``) — outside
    ``kernels/`` no module imports ``ctypes``, ``triton`` or
    ``torch.utils.cpp_extension``, and none calls ``build.load``: the
    compiled libraries are reached only through ``kernels/dispatch.py``,
    the one seam where the device picks a kernel or its plain version.
  - ``tensor-branch``  (the reference's ``tracer-branch``) — in ``core/``
    and ``models/`` no Python ``if``/``while`` on a value derived from a
    torch call, and no ``bool()``/``int()``/``float()`` of one, nor
    ``.item()``/``.tolist()``/``.cpu()``/``.numpy()`` on anything that is
    not a host array: each reads device data back to the host, which
    stalls the card and cannot be captured in a CUDA graph.  Shape, dtype
    and device reads are host values, and so are numpy constants.
  - ``hash-constants`` — ``HASH_MULT``/``HASH_MIX`` and their literals
    appear only in ``kernels/hashing.py`` (the CUDA sources in
    ``kernels/csrc`` are scanned too: the kernel takes the constants as
    launch arguments), so drafter, kernel and oracle hash alike.
  - ``global-state``   — at module level nothing mutates ``os.environ``,
    calls ``torch.set_num_threads``/``set_default_dtype``/
    ``set_default_device``/``manual_seed`` or assigns ``torch.backends.*``
    (an import would change its importer's process); a module global that
    a function rebinds is restored by a context manager (rebound in a
    ``finally`` of a ``contextmanager``); no module installs a mesh
    (``act_sharding.install``) at import, nor anywhere without an
    ``uninstall``/``activated`` pairing in the same module: an installed
    mesh outlives its owner and constrains every later caller's DTensors.
  - ``time-in-step``   (the reference's ``time-in-jit``) — inside
    ``spec_step``, ``admit_slot``, ``release_slot`` and the ``*_body``
    functions no wall clock and no host RNG (``time.*``, ``random.*``,
    ``np.random.*``, a torch RNG call without ``generator=``): under a
    CUDA graph such a call runs once, at capture.
  - ``host-sync`` (AST half) — every device->host read in the
    continuous-serving critical path (``CRITICAL_PATH_METHODS`` of
    ``serving/engine.py``) carries an inline waiver that says why it
    cannot move; the inventory is the map for a captured step (the runtime
    half: ``runtime_rules``).
"""
from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .findings import Finding, apply_waivers, scan_waivers

# repro-lint: allow(hash-constants): the linter must name the constants it hunts
HASH_CONSTANTS = {2654435761, 0x9E3779B9}
HASH_NAMES = {"HASH_MULT", "HASH_MIX"}
_CU_HASH_RE = re.compile(
    r"\b(?:2654435761|0x9e3779b9)[uUlL]*\b", re.IGNORECASE)
_KERNEL_IMPORTS = ("ctypes", "triton", "torch.utils.cpp_extension")
# torch calls whose results are host values, not tensors
_TORCH_HOST_CALLS = {"device", "dtype", "Size", "finfo", "iinfo",
                     "is_tensor", "is_floating_point", "get_default_dtype",
                     "Generator"}
# tensor reads that are host values
_HOST_ATTRS = {"shape", "dtype", "device", "ndim", "is_cuda", "layout",
               "requires_grad"}
_HOST_METHODS = {"size", "dim", "numel", "ndimension", "element_size",
                 "is_contiguous", "stride", "data_ptr", "get_device",
                 "untyped_storage", "nbytes"}
_READ_METHODS = {"item", "tolist", "cpu", "numpy"}
_READ_BUILTINS = {"bool", "int", "float"}
# builtins that pass a tensor through
_PASS_BUILTINS = {"min", "max", "sum", "abs"}
_TENSOR_ANNOTATIONS = re.compile(r"\b(Tensor|DecodeState)\b")
_CLOCKS = {"time", "perf_counter", "monotonic", "process_time",
           "perf_counter_ns", "time_ns", "monotonic_ns"}
_TORCH_RNG = {"rand", "randn", "randint", "randperm", "bernoulli",
              "multinomial", "normal", "rand_like", "randn_like",
              "randint_like", "poisson"}
_TENSOR_RNG_METHODS = {"uniform_", "normal_", "exponential_", "geometric_",
                       "cauchy_", "log_normal_", "random_", "bernoulli_"}
STEP_FUNCTIONS = {"spec_step", "admit_slot", "release_slot"}
# the continuous-serving decode critical path (serving/engine.py):
# everything called between two spec_step dispatches
CRITICAL_PATH_METHODS = {"step", "serve_continuous", "_retire_finished",
                         "_admit_queued", "_run_step", "_run_admit",
                         "_run_release"}


def _src_line(lines: Sequence[str], lineno: int) -> str:
    return lines[lineno - 1].strip() if 0 < lineno <= len(lines) else ""


def _mk(rule: str, relpath: str, node: ast.AST, lines: Sequence[str],
        message: str, hint: str) -> Finding:
    line = getattr(node, "lineno", 0)
    return Finding(rule=rule, file=relpath, line=line, message=message,
                   hint=hint, context=_src_line(lines, line))


def _attr_chain(node: ast.AST) -> str:
    """Dotted name of an attribute/name expression ('' if not one)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _functions(tree: ast.AST):
    return [n for n in ast.walk(tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]


def _in_order(node: ast.AST):
    """``ast.walk`` in source order (line, then column)."""
    return sorted(ast.walk(node), key=lambda n: (getattr(n, "lineno", 0),
                                                 getattr(n, "col_offset", 0)))


# ---------------------------------------------------------------------------
# kernel-scope
# ---------------------------------------------------------------------------
def kernel_scope_findings(relpath: str, source: str,
                          tree: ast.Module) -> List[Finding]:
    if relpath.startswith("kernels/"):
        return []
    lines = source.splitlines()
    hint = ("reach the kernel through kernels/dispatch.py (or move the "
            "code into kernels/)")
    out = []
    for node in ast.walk(tree):
        mods: List[str] = []
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            mods = [node.module] + [f"{node.module}.{a.name}"
                                    for a in node.names]
        for m in mods:
            if any(m == k or m.startswith(k + ".") for k in _KERNEL_IMPORTS):
                out.append(_mk("kernel-scope", relpath, node, lines,
                               f"imports {m!r} outside kernels/: compiled "
                               f"code bypasses the dispatch layer", hint))
                break
        if isinstance(node, ast.Call) \
                and _attr_chain(node.func).endswith("build.load"):
            out.append(_mk("kernel-scope", relpath, node, lines,
                           "loads a compiled kernel library outside "
                           "kernels/", hint))
    return out


# ---------------------------------------------------------------------------
# data flow: which expressions hold tensors
# ---------------------------------------------------------------------------
def tensor_functions(tree: ast.Module) -> Set[str]:
    """Names of the functions whose return annotation names a tensor or a
    DecodeState."""
    return {fn.name for fn in _functions(tree)
            if fn.returns is not None
            and _TENSOR_ANNOTATIONS.search(ast.unparse(fn.returns))}


def _module_aliases(tree: ast.Module) -> Set[str]:
    """Names bound to modules by this file's imports."""
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {(a.asname or a.name).split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            out |= {a.asname or a.name for a in node.names}
    return out


class Flow:
    """Which names of one function hold tensors (``traced``) or host
    arrays (``host``), from the line of the assignment that makes them so
    on (a forward pass over the function's assignments, in line order)."""

    def __init__(self, fn: ast.AST, tensor_fns: Set[str],
                 aliases: Set[str], roots: Sequence[str] = ()):
        self.tensor_fns, self.aliases = tensor_fns, aliases
        self.roots = set(roots)
        self.traced: Dict[str, int] = {}     # name -> from this line on
        self.host: Dict[str, int] = {}
        args = getattr(fn, "args", None)
        for a in (args.posonlyargs + args.args + args.kwonlyargs
                  if args else []):
            if a.annotation is not None and _TENSOR_ANNOTATIONS.search(
                    ast.unparse(a.annotation)):
                self.traced[a.arg] = 0
        assigns = sorted((n for n in ast.walk(fn) if isinstance(
            n, (ast.Assign, ast.AugAssign, ast.AnnAssign))
            and n.value is not None), key=lambda n: n.lineno)
        for node in assigns:
            tgts = (node.targets if isinstance(node, ast.Assign)
                    else [node.target])
            for tgt in tgts:
                pairs = ([(t, v) for t, v in zip(tgt.elts, node.value.elts)]
                         if isinstance(tgt, ast.Tuple)
                         and isinstance(node.value, ast.Tuple)
                         and len(tgt.elts) == len(node.value.elts)
                         else [(tgt, node.value)])
                for t, v in pairs:
                    names = [n.id for n in ast.walk(t)
                             if isinstance(n, ast.Name)]
                    if self.is_host(v):
                        into = self.host
                    elif self.is_tensor(v):
                        into = self.traced
                    else:
                        continue
                    for name in names:
                        into.setdefault(name, node.end_lineno)

    @staticmethod
    def _bound(names: Dict[str, int], node: ast.Name) -> bool:
        return node.id in names and node.lineno > names[node.id] \
            or names.get(node.id) == 0

    def is_host(self, node: ast.AST) -> bool:
        """A host array: a numpy call's result, or a read's."""
        if isinstance(node, ast.Name):
            return self._bound(self.host, node)
        if isinstance(node, ast.Call):
            chain = _attr_chain(node.func)
            if chain.split(".")[0] in ("np", "numpy"):
                return True
            if isinstance(node.func, ast.Attribute):
                if node.func.attr in _READ_METHODS:
                    return True
                return self.is_host(node.func.value)
            return False
        if isinstance(node, (ast.Subscript, ast.Attribute)):
            return self.is_host(node.value)
        if isinstance(node, (ast.GeneratorExp, ast.ListComp)):
            return self.is_host(node.elt)
        if isinstance(node, ast.IfExp):
            return all(self.is_host(b) or isinstance(b, ast.Constant)
                       for b in (node.body, node.orelse))
        return False

    def is_tensor(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Name):
            return self._bound(self.traced, node)
        if isinstance(node, ast.Attribute):
            if _attr_chain(node) in self.roots:
                return True
            return node.attr not in _HOST_ATTRS and self.is_tensor(node.value)
        if isinstance(node, ast.Subscript):
            return self.is_tensor(node.value)
        if isinstance(node, ast.Call):
            chain = _attr_chain(node.func)
            root = chain.split(".")[0] if chain else ""
            if root in ("torch", "F"):
                return chain.split(".")[-1] not in _TORCH_HOST_CALLS \
                    and not chain.startswith("torch.cuda.")
            if isinstance(node.func, ast.Name):
                if node.func.id in _PASS_BUILTINS:
                    return any(self.is_tensor(a) for a in node.args)
                return node.func.id in self.tensor_fns
            if isinstance(node.func, ast.Attribute):
                if isinstance(node.func.value, ast.Name) \
                        and node.func.value.id in self.aliases:
                    return node.func.attr in self.tensor_fns
                return (node.func.attr not in _HOST_METHODS
                        and node.func.attr not in _READ_METHODS
                        and self.is_tensor(node.func.value))
            return False
        if isinstance(node, ast.Compare):
            if any(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                   for op in node.ops):
                return False
            return any(self.is_tensor(c)
                       for c in [node.left] + node.comparators)
        if isinstance(node, (ast.BinOp, ast.BoolOp, ast.UnaryOp,
                             ast.IfExp)):
            return any(self.is_tensor(c) for c in ast.iter_child_nodes(node)
                       if isinstance(c, ast.expr))
        return False

    def read(self, node: ast.AST) -> Optional[str]:
        """The device->host read ``node`` makes, or None."""
        if not isinstance(node, ast.Call):
            return None
        if isinstance(node.func, ast.Name) \
                and node.func.id in _READ_BUILTINS and node.args \
                and self.is_tensor(node.args[0]):
            return f"{node.func.id}() of a tensor"
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr in _READ_METHODS:
            recv = node.func.value
            if self.is_host(recv):
                return None
            if node.func.attr == "numpy" and isinstance(recv, ast.Call) \
                    and isinstance(recv.func, ast.Attribute) \
                    and recv.func.attr == "cpu":
                return None             # .cpu().numpy(): one read
            return f".{node.func.attr}()"
        chain = _attr_chain(node.func)
        if chain in ("np.asarray", "np.array", "numpy.asarray") \
                and node.args and self.is_tensor(node.args[0]):
            return f"{chain}() of a tensor"
        if chain == "torch.cuda.synchronize":
            return "torch.cuda.synchronize()"
        return None


# ---------------------------------------------------------------------------
# tensor-branch
# ---------------------------------------------------------------------------
def tensor_branch_findings(relpath: str, source: str, tree: ast.Module,
                           tensor_fns: Set[str]) -> List[Finding]:
    if not relpath.startswith(("core/", "models/")):
        return []
    lines = source.splitlines()
    aliases = _module_aliases(tree)
    out: List[Finding] = []
    seen: Set[Tuple[int, str]] = set()     # a nested def is walked twice
    for fn in _functions(tree):
        flow = Flow(fn, tensor_fns, aliases)
        for node in _in_order(fn):
            if isinstance(node, (ast.If, ast.While)) \
                    and flow.is_tensor(node.test):
                kw = "if" if isinstance(node, ast.If) else "while"
                what = f"Python `{kw}` on a tensor"
            else:
                what = flow.read(node)
            key = (getattr(node, "lineno", 0), what or "")
            if what and key not in seen:
                seen.add(key)
                out.append(_mk(
                    "tensor-branch", relpath, node, lines,
                    f"{what} in {fn.name!r}: reads device data back to the "
                    f"host (a stall on the card, and no CUDA graph can "
                    f"capture it)",
                    "keep the value on the device (torch.where, masks, "
                    "fixed shapes), or waive a host-side helper with "
                    "`# repro-lint: allow(tensor-branch): <why>`"))
    return out


# ---------------------------------------------------------------------------
# hash-constants
# ---------------------------------------------------------------------------
def hash_constant_findings(relpath: str, source: str,
                           tree: ast.Module) -> List[Finding]:
    if relpath.endswith("kernels/hashing.py"):
        return []
    lines = source.splitlines()
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, int) \
                and not isinstance(node.value, bool) \
                and node.value in HASH_CONSTANTS:
            out.append(_mk(
                "hash-constants", relpath, node, lines,
                f"continuation-hash constant {node.value} outside "
                f"kernels/hashing.py: drafter, kernel and oracle agree "
                f"only while a copy stays in sync",
                "import HASH_MULT/HASH_MIX from kernels/hashing.py"))
        elif isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name) and tgt.id in HASH_NAMES:
                    out.append(_mk(
                        "hash-constants", relpath, node, lines,
                        f"redefinition of {tgt.id} outside "
                        f"kernels/hashing.py",
                        "import it from kernels/hashing.py"))
    return out


def cuda_hash_findings(relpath: str, source: str) -> List[Finding]:
    """The hash constants as literals in a CUDA source: the kernel must
    take them as launch arguments from kernels/hashing.py."""
    lines = source.splitlines()
    out = []
    for i, text in enumerate(lines, start=1):
        code = text.split("//", 1)[0]
        for m in _CU_HASH_RE.finditer(code):
            out.append(Finding(
                rule="hash-constants", file=relpath, line=i,
                message=f"continuation-hash constant {m.group(0)} in a "
                        f"CUDA source",
                hint="pass HASH_MULT/HASH_MIX from kernels/hashing.py as "
                     "kernel arguments",
                context=text.strip()))
    return out


# ---------------------------------------------------------------------------
# global-state
# ---------------------------------------------------------------------------
def _is_main_guard(node: ast.AST) -> bool:
    return (isinstance(node, ast.If)
            and isinstance(node.test, ast.Compare)
            and isinstance(node.test.left, ast.Name)
            and node.test.left.id == "__name__")


def _walk_no_defs(node: ast.AST):
    """Walk a statement WITHOUT descending into function/class bodies:
    code inside a def runs when called, not at import."""
    yield node
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                         ast.ClassDef, ast.Lambda)):
        return
    for child in ast.iter_child_nodes(node):
        yield from _walk_no_defs(child)


_GLOBAL_CALLS = {"torch.set_num_threads", "torch.set_num_interop_threads",
                 "torch.set_default_dtype", "torch.set_default_device",
                 "torch.set_default_tensor_type", "torch.manual_seed",
                 "torch.cuda.manual_seed", "torch.cuda.manual_seed_all",
                 "os.putenv", "os.unsetenv"}


def _module_mutation(node: ast.AST) -> Optional[str]:
    if isinstance(node, (ast.Assign, ast.AugAssign, ast.Delete)):
        tgts = (node.targets if isinstance(node, (ast.Assign, ast.Delete))
                else [node.target])
        for tgt in tgts:
            if isinstance(tgt, ast.Subscript) \
                    and _attr_chain(tgt.value).endswith("environ"):
                return "os.environ[...] assignment"
            if isinstance(tgt, ast.Attribute) \
                    and _attr_chain(tgt).startswith("torch.backends."):
                return f"{_attr_chain(tgt)} assignment"
    if isinstance(node, ast.Call):
        chain = _attr_chain(node.func)
        if chain in _GLOBAL_CALLS:
            return chain
        if chain.startswith("os.environ.") and chain.split(".")[-1] in (
                "setdefault", "update", "pop", "clear", "__setitem__"):
            return chain
    return None


def _is_contextmanager(fn: ast.AST) -> bool:
    return any(_attr_chain(d).endswith("contextmanager")
               for d in getattr(fn, "decorator_list", []))


def global_state_findings(relpath: str, source: str,
                          tree: ast.Module) -> List[Finding]:
    lines = source.splitlines()
    out: List[Finding] = []
    for stmt in tree.body:
        if _is_main_guard(stmt):
            continue
        for node in _walk_no_defs(stmt):
            kind = _module_mutation(node)
            if kind:
                out.append(_mk(
                    "global-state", relpath, node, lines,
                    f"module-level process mutation ({kind}): it runs at "
                    f"IMPORT time and changes the importer's process",
                    "move it into the entry point's `if __name__ == "
                    "'__main__'` block or a function the caller invokes"))
    for fn in _functions(tree):
        names = {n for g in ast.walk(fn) if isinstance(g, ast.Global)
                 for n in g.names}
        if not names:
            continue
        restored = set()
        if _is_contextmanager(fn):
            for t in ast.walk(fn):
                if isinstance(t, ast.Try):
                    for st in t.finalbody:
                        for n in ast.walk(st):
                            if isinstance(n, ast.Name) \
                                    and isinstance(n.ctx, ast.Store):
                                restored.add(n.id)
        for node in ast.walk(fn):
            if isinstance(node, (ast.Assign, ast.AugAssign)):
                tgts = (node.targets if isinstance(node, ast.Assign)
                        else [node.target])
                bound = {n.id for t in tgts for n in ast.walk(t)
                         if isinstance(n, ast.Name) and n.id in names}
                for name in sorted(bound - restored):
                    out.append(_mk(
                        "global-state", relpath, node, lines,
                        f"{fn.name!r} rebinds the module global {name!r} "
                        f"without restoring it: the change outlives its "
                        f"caller",
                        "rebind it inside a contextlib.contextmanager and "
                        "restore it in the `finally`"))
                    restored.add(name)        # one finding a name
    return out + _mesh_install_findings(relpath, source, tree, lines)


def _is_install(node: ast.AST, source: str) -> bool:
    if not isinstance(node, ast.Call):
        return False
    chain = _attr_chain(node.func)
    return (chain.endswith("act_sharding.install")
            or chain == "install" and "from .act_sharding import" in source
            or chain == "install"
            and "from ..distributed.act_sharding import" in source)


def _mesh_install_findings(relpath: str, source: str, tree: ast.Module,
                           lines: List[str]) -> List[Finding]:
    """The mesh half of ``global-state`` (the reference's act_sharding
    branches): a module-level install, and an install with no
    uninstall/``activated`` pairing in its module."""
    out: List[Finding] = []
    for stmt in tree.body:
        if _is_main_guard(stmt):
            continue
        for node in _walk_no_defs(stmt):
            if _is_install(node, source):
                out.append(_mk(
                    "global-state", relpath, node, lines,
                    "module-level act_sharding.install: the mesh leaks into "
                    "every engine in the process",
                    "use act_sharding.activated(mesh) scoped to the calls "
                    "that need it"))
    paired = "uninstall" in source or "activated(" in source
    if not paired:
        for node in ast.walk(tree):
            if _is_install(node, source):
                out.append(_mk(
                    "global-state", relpath, node, lines,
                    "act_sharding.install(...) with no uninstall/activated "
                    "pairing in this module: an installed mesh outlives its "
                    "owner and constrains every later caller's DTensors",
                    "wrap the calls in act_sharding.activated(mesh), or "
                    "pair install with uninstall in a finally block"))
    return out


# ---------------------------------------------------------------------------
# time-in-step
# ---------------------------------------------------------------------------
def time_in_step_findings(relpath: str, source: str,
                          tree: ast.Module) -> List[Finding]:
    lines = source.splitlines()
    out: List[Finding] = []
    for fn in _functions(tree):
        if not (fn.name in STEP_FUNCTIONS or fn.name.endswith("_body")):
            continue
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            chain = _attr_chain(node.func)
            parts = chain.split(".")
            seeded = any(k.arg == "generator" for k in node.keywords)
            bad = (parts[0] == "time" and parts[-1] in _CLOCKS
                   or chain in ("datetime.now", "datetime.datetime.now")
                   or parts[0] == "random"
                   or parts[:2] in (["np", "random"], ["numpy", "random"])
                   or (parts[0] == "torch" and parts[-1] in _TORCH_RNG
                       and not seeded)
                   or (isinstance(node.func, ast.Attribute)
                       and node.func.attr in _TENSOR_RNG_METHODS
                       and not seeded))
            if bad:
                out.append(_mk(
                    "time-in-step", relpath, node, lines,
                    f"host clock or RNG {chain or node.func.attr!r} inside "
                    f"the step function {fn.name!r}: under a CUDA graph it "
                    f"runs once, at capture",
                    "take the value as an argument, or draw from "
                    "core/prng.py's keys carried in the state"))
    return out


# ---------------------------------------------------------------------------
# host-sync (AST half: the serving-loop critical path)
# ---------------------------------------------------------------------------
def serving_sync_findings(relpath: str, source: str, tree: ast.Module,
                          tensor_fns: Set[str]
                          ) -> Tuple[List[Finding], List[Dict]]:
    """Findings and the full sync inventory of the continuous-serving
    critical path.  EVERY read found is an inventory entry (waived
    included: a captured step needs the complete map); only un-waived
    ones are findings."""
    if not relpath.endswith("serving/engine.py"):
        return [], []
    lines = source.splitlines()
    aliases = _module_aliases(tree)
    out: List[Finding] = []
    inventory: List[Dict] = []
    for cls in ast.walk(tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        for method in cls.body:
            if not (isinstance(method, (ast.FunctionDef,
                                        ast.AsyncFunctionDef))
                    and method.name in CRITICAL_PATH_METHODS):
                continue
            flow = Flow(method, tensor_fns, aliases,
                        roots=("self._cont_state",))
            for node in _in_order(method):
                kind = flow.read(node)
                if kind is None:
                    continue
                f = _mk("host-sync", relpath, node, lines,
                        f"device->host read ({kind}) in the continuous-"
                        f"serving critical path method {method.name!r}: it "
                        f"waits for the device between two steps",
                        "defer the read, batch it with an existing one, or "
                        "waive it with `# repro-lint: allow(host-sync): "
                        "<why it cannot move>`")
                out.append(f)
                inventory.append({"file": relpath, "line": f.line,
                                  "method": method.name, "call": kind,
                                  "kind": "device->host read",
                                  "code": f.context})
    return out, inventory


# ---------------------------------------------------------------------------
# running the rules
# ---------------------------------------------------------------------------
AST_RULES = (kernel_scope_findings, hash_constant_findings,
             global_state_findings, time_in_step_findings)


_COMPOUND = (ast.If, ast.For, ast.AsyncFor, ast.While, ast.With,
             ast.AsyncWith, ast.Try, ast.FunctionDef, ast.AsyncFunctionDef,
             ast.ClassDef)


def statement_waivers(tree: ast.Module, source: str
                      ) -> Dict[int, Tuple[Set[str], str]]:
    """``scan_waivers``, with a waiver on a comment-only line covering
    every line of the simple statement below it (a read that spans
    lines)."""
    waivers = scan_waivers(source)
    lines = source.splitlines()
    for node in ast.walk(tree):
        if not isinstance(node, ast.stmt) or isinstance(node, _COMPOUND):
            continue
        w = waivers.get(node.lineno)
        above = lines[node.lineno - 2] if node.lineno >= 2 else ""
        if w and above.lstrip().startswith("#"):
            for i in range(node.lineno + 1, node.end_lineno + 1):
                waivers.setdefault(i, w)
    return waivers


def analyze_source(relpath: str, source: str,
                   tensor_fns: Optional[Set[str]] = None
                   ) -> Tuple[List[Finding], List[Dict]]:
    """All AST findings (waivers applied) and the sync inventory of one
    Python file.  ``tensor_fns``: the package's functions that return
    tensors (default: this file's own)."""
    tree = ast.parse(source, filename=relpath)
    if tensor_fns is None:
        tensor_fns = tensor_functions(tree)
    waivers = statement_waivers(tree, source)
    findings: List[Finding] = []
    for rule in AST_RULES:
        findings += rule(relpath, source, tree)
    findings += tensor_branch_findings(relpath, source, tree, tensor_fns)
    sync, inventory = serving_sync_findings(relpath, source, tree,
                                            tensor_fns)
    findings += sync
    findings = apply_waivers(findings, waivers)
    for entry, f in zip(inventory,
                        [f for f in findings if f.rule == "host-sync"]):
        entry["waived"] = f.waived
        entry["reason"] = f.waive_reason
    return findings, inventory


def analyze_cuda_source(relpath: str, source: str) -> List[Finding]:
    return apply_waivers(cuda_hash_findings(relpath, source),
                         scan_waivers(source.replace("//", "#")))


def _sources(root: str, suffixes: Tuple[str, ...]):
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames
                             if d != "__pycache__" and not d.startswith("_"))
        for fn in sorted(filenames):
            if fn.endswith(suffixes):
                path = os.path.join(dirpath, fn)
                rel = os.path.relpath(path, root).replace(os.sep, "/")
                with open(path, encoding="utf-8") as f:
                    yield rel, f.read()


def run_level2(root: str) -> Tuple[List[Finding], List[Dict]]:
    """Walk ``root`` (the ``src/repro_torch`` package dir) and apply every
    AST rule, and the hash rule to ``kernels/csrc``'s CUDA sources.
    Returns (findings, host-sync inventory)."""
    py = list(_sources(root, (".py",)))
    tensor_fns: Set[str] = set()
    for rel, src in py:
        tensor_fns |= tensor_functions(ast.parse(src, filename=rel))
    findings: List[Finding] = []
    inventory: List[Dict] = []
    for rel, src in py:
        got, inv = analyze_source(rel, src, tensor_fns)
        findings += got
        inventory += inv
    for rel, src in _sources(os.path.join(root, "kernels", "csrc"),
                             (".cu", ".cuh")):
        findings += analyze_cuda_source(f"kernels/csrc/{rel}", src)
    return findings, inventory
