"""Multi-pod dry-run of the port (port of ``repro/launch/dryrun.py``).

For every (architecture x input-shape) pair, trace rank 0's program of the
production serving step on the reference's 16x16 mesh (256 ranks) or its
2x16x16 mesh (512 ranks), over placeholder ranks (``launch/hostdev.py``)
and under ``FakeTensorMode``: nothing is allocated and no kernel runs.  A
kernel wrapper reached by a fake tensor runs its own checks and its shape
function, which records the instance the card would launch (K1, K5; K2-K4
raise: no case drafts, pages or builds a tree).  The trace records, per
rank, what the reference's compile records per device: the cost, the
memory and the collectives, into ``experiments/dryrun_torch/*.json`` in
the reference's schema.

Usage:
  python -m repro_torch.launch.dryrun --arch mistral-7b --shape decode_32k
  python -m repro_torch.launch.dryrun --all                # 10 x 4 matrix
  python -m repro_torch.launch.dryrun --all --multi-pod
  python -m repro_torch.launch.dryrun --arch mixtral-8x7b --shape decode_32k --spec
  ... --device cpu                     # fake CPU tensors (no card needed)
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time
import traceback
import weakref
from typing import Any, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..configs import ALL_ARCHS, ASSIGNED_ARCHS, get_config
from ..distributed import local as DL
from ..distributed import sharding as shd
from ..kernels.mamba_scan import mamba_scan_cuda
from ..kernels.spec_attention import spec_attention_cuda
from .hostdev import ensure_placeholder_ranks
from .input_specs import SHAPES, resolve_case
from .mesh import make_production_mesh

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")
# functional collectives (DTensor's redistribute issues these) by the
# reference's HLO names
_COLL_OPS = {"all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
             "all_gather_into_tensor": "all-gather",
             "all_gather_into_tensor_coalesced": "all-gather",
             "reduce_scatter_tensor": "reduce-scatter",
             "reduce_scatter_tensor_coalesced": "reduce-scatter",
             "all_to_all_single": "all-to-all"}
_NOT_COMPUTE = {"wait_tensor", "broadcast", "broadcast_"}
# XLA's transcendental ops, as aten ops (one per output element; the
# composite activations count their exp)
_TRANSCENDENTAL = {"exp", "exp2", "expm1", "log", "log1p", "log2", "log10",
                   "tanh", "sigmoid", "erf", "erfc", "rsqrt", "sqrt", "pow",
                   "sin", "cos", "_softmax", "_log_softmax", "silu", "gelu",
                   "softplus", "logsumexp"}
_SHAPE_CALLS = (spec_attention_cuda, mamba_scan_cuda)


def _tensors(tree):
    """Every tensor of a nested tuple/list/dict."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _tensors(v)


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if DL.is_dtensor(t) else t


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class RankTrace(TorchDispatchMode):
    """Counts rank 0's local ops of a traced call: flops (the products
    ``torch.utils.flop_counter`` counts, by its formulas), bytes accessed
    (each op's tensor inputs and outputs; views move none), transcendentals
    (output elements of exp, log, tanh, ...), the collectives (result bytes
    per rank by kind, and the storages they read), the live fake storages
    (their peak past the arguments) and the storages written in place.

    A DTensor op is left to DTensor (``NotImplemented``), which runs it as
    local ops and collectives on the local shards that this mode then
    sees: a mode outside DTensor would count the global op.  DTensor's
    sharding propagation runs the op once more on fake tensors of the
    global shapes, for their metadata, inside a nested entry of the fake
    mode (``fake``'s, or a fresh mode's): those ops are run, not
    counted."""

    def __init__(self, arg_tensors, fake):
        super().__init__()
        self.fake = fake
        self.depth = len(fake.enter_stack) + 1
        from torch.utils.flop_counter import flop_registry
        self.registry = flop_registry
        self.flops = self.bytes = self.trans = 0
        self.coll = {c: 0 for c in _COLLECTIVES}
        self.coll_counts = {c: 0 for c in _COLLECTIVES}
        self.coll_largest = 0
        # storage -> the largest result of a collective that read it
        self.coll_inputs: Dict[int, int] = {}
        # the arguments' storages (held: their ids stay theirs)
        self.args = {id(s): s for s in
                     (t.untyped_storage() for t in arg_tensors)}
        self.live = self.peak = 0
        self._sizes: Dict[int, int] = {}
        self.written = set()

    def _free(self, key: int) -> None:
        self.live -= self._sizes.pop(key, 0)

    def _track(self, t: torch.Tensor) -> None:
        s = t.untyped_storage()
        key = id(s)
        if key in self.args or key in self._sizes:
            return
        self._sizes[key] = s.nbytes()
        self.live += s.nbytes()
        self.peak = max(self.peak, self.live)
        weakref.finalize(s, self._free, key)

    def _in_propagation(self) -> bool:
        from torch._guards import detect_fake_mode
        return (detect_fake_mode() is not self.fake
                or len(self.fake.enter_stack) > self.depth)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if any(DL.is_dtensor(a) for a in _tensors((args, kwargs))) or any(
                getattr(t, "__name__", "") == "DTensor" for t in types):
            return NotImplemented
        if self._in_propagation():
            return func(*args, **kwargs)
        packet = func._overloadpacket
        if packet not in self.registry and \
                func is not torch.ops.prim.device.default:
            # as FlopCounterMode: count what a composite decomposes into
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        name = packet.__name__
        outs = list(_tensors(out))
        for t in outs:
            self._track(t)
        for i, a in enumerate(func._schema.arguments):
            if a.alias_info is not None and a.alias_info.is_write:
                v = args[i] if i < len(args) else kwargs.get(a.name)
                for t in _tensors(v):
                    self.written.add(id(t.untyped_storage()))
        if name in _COLL_OPS:
            kind = _COLL_OPS[name]
            nb = sum(_nbytes(t) for t in outs)
            for t in _tensors(args):
                key = id(t.untyped_storage())
                self.coll_inputs[key] = max(self.coll_inputs.get(key, 0), nb)
            self.coll[kind] += nb
            self.coll_counts[kind] += 1
            self.coll_largest = max(self.coll_largest, nb)
            return out
        if name in _NOT_COMPUTE:
            return out
        if packet in self.registry:
            self.flops += self.registry[packet](*args, **kwargs,
                                                out_val=out)
        if not func.is_view:
            self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)))
            self.bytes += sum(_nbytes(t) for t in outs)
        if name.rstrip("_") in _TRANSCENDENTAL:
            self.trans += sum(t.numel() for t in outs)
        return out


def trace_case(case) -> Dict[str, Any]:
    """Run ``case.fn`` once under its fake mode and ``RankTrace``; the
    record's cost, memory, collectives and kernels entries, and
    ``compile_s``: the trace's seconds (the port compiles nothing: the
    counterpart of the reference's lower and compile is this trace)."""
    named = {"/".join(p): _local(t) for i, a in enumerate(case.args)
             for p, t in shd.walk(a, (str(i),))}
    args = list(named.values())
    mode = next(t.fake_mode for t in args if hasattr(t, "fake_mode"))
    for fn in _SHAPE_CALLS:
        fn.shape_calls.clear()
    counter = RankTrace(args, mode)
    t0 = time.time()
    with mode, counter:
        out = case.fn(*case.args)
    took = time.time() - t0
    calls = [c for fn in _SHAPE_CALLS for c in fn.shape_calls]
    arg_bytes = sum(_nbytes(t) for t in args)
    donated = [_local(t) for i in case.donate
               for t in _tensors(case.args[i])]
    alias = sum(_nbytes(t) for t in donated
                if id(t.untyped_storage()) in counter.written)
    mem = {"argument_size_in_bytes": arg_bytes,
           "output_size_in_bytes": sum(_nbytes(_local(t))
                                       for t in _tensors(out)),
           "temp_size_in_bytes": counter.peak,
           "alias_size_in_bytes": alias}
    mem["total_hbm_bytes"] = (mem["argument_size_in_bytes"]
                              + mem["output_size_in_bytes"]
                              + mem["temp_size_in_bytes"]
                              - mem["alias_size_in_bytes"])
    coll = dict(counter.coll)
    coll["total"] = sum(counter.coll.values())
    coll["counts"] = dict(counter.coll_counts)
    coll["largest"] = counter.coll_largest
    # the argument shards a collective read (by path: "1/groups/p0/k"),
    # each with the largest such collective's result bytes
    coll["args_read"] = {p: counter.coll_inputs[id(t.untyped_storage())]
                         for p, t in named.items()
                         if id(t.untyped_storage()) in counter.coll_inputs}
    kernels: Dict[str, int] = {}
    for c in calls:
        key = f"{c['kernel']} {c['instance']}"
        kernels[key] = kernels.get(key, 0) + 1
    return {"compile_s": round(took, 3),
            "cost": {"flops": float(counter.flops
                                    + sum(c["flops"] for c in calls)),
                     "bytes accessed": float(counter.bytes
                                             + sum(c["bytes"]
                                                   for c in calls)),
                     "transcendentals": float(
                         counter.trans + sum(c["transcendentals"]
                                             for c in calls))},
            "memory": mem, "collectives": coll, "kernels": kernels}


def run_case(arch: str, shape: str, multi_pod: bool,
             spec_step: bool = False, roofline: bool = False,
             device="cuda") -> dict:
    """One case's record on the production mesh (256 or 512 placeholder
    ranks, started here unless a group of that size already is)."""
    mesh_name = "2x16x16" if multi_pod else "16x16"
    n = 512 if multi_pod else 256
    rec = {"arch": arch, "shape": shape, "mesh": mesh_name,
           "spec_step": spec_step, "n_devices": n, "device": str(device)}
    ensure_placeholder_ranks(n)
    mesh = make_production_mesh(multi_pod=multi_pod, device=device)
    with shd.recording_fallbacks() as fallbacks:
        case = resolve_case(arch, shape, mesh, spec_step=spec_step,
                            device=device)
    if case.skip_reason:
        rec["status"] = "skip"
        rec["skip_reason"] = case.skip_reason
        return rec
    rec.update(trace_case(case))
    rec["fallbacks"] = sorted(fallbacks)
    rec["status"] = "ok"

    if roofline:
        # calibration: the 1- and 2-period variants, for a per-layer cost
        # (the trace counts every executed op: nothing to unroll)
        cfg = get_config(arch)
        P, pre = cfg.pattern_period, len(cfg.prefix_blocks)
        calib = {"pattern_period": P, "prefix_layers": pre,
                 "full_layers": cfg.num_layers}
        for tag, L in (("L1", pre + P), ("L2", pre + 2 * P)):
            c = resolve_case(arch, shape, mesh, spec_step=spec_step,
                             num_layers=L, device=device)
            r = trace_case(c)
            calib[tag] = {"layers": L, "cost": r["cost"],
                          "collectives": r["collectives"],
                          "compile_s": r["compile_s"]}
        rec["calib"] = calib
    return rec


def _fname(out: str, arch: str, shape: str, multi_pod: bool,
           spec: bool) -> str:
    return os.path.join(out, f"{arch}__{shape}__"
                             f"{'multipod' if multi_pod else 'pod'}__"
                             f"{'spec' if spec else 'base'}.json")


def _drive_subprocesses(cases, args, timeout_s: int = 2400) -> None:
    """Run each case in its own process (its own placeholder group; one
    failing case must not take down the rest).  Caches finished cases."""
    import subprocess
    os.makedirs(args.out, exist_ok=True)
    n_ok = n_skip = n_fail = 0
    for arch, shape in cases:
        fname = _fname(args.out, arch, shape, args.multi_pod, args.spec)
        if os.path.exists(fname):
            with open(fname) as f:
                rec = json.load(f)
            st = rec.get("status")
            calib_ok = (not args.roofline) or ("calib" in rec) \
                or st != "ok"
            if st in ("ok", "skip") and calib_ok:
                print(f"[cache] {arch:22s} {shape:12s} ({st})", flush=True)
                n_ok += st == "ok"
                n_skip += st == "skip"
                continue
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", arch, "--shape", shape, "--out", args.out,
               "--device", args.device]
        for flag, on in (("--multi-pod", args.multi_pod),
                         ("--spec", args.spec),
                         ("--roofline", args.roofline)):
            if on:
                cmd.append(flag)
        err = ""
        try:
            r = subprocess.run(cmd, timeout=timeout_s,
                               capture_output=True, text=True)
            if r.returncode:
                err = (r.stdout[-400:] + r.stderr[-400:])
        except subprocess.TimeoutExpired:
            err = f"timeout after {timeout_s}s"
        if os.path.exists(fname):
            with open(fname) as f:
                st = json.load(f).get("status", "fail")
            if st == "ok" and err:
                err = f"(base ok; {err})"
        else:
            st = "fail"
            with open(fname, "w") as f:
                json.dump({"arch": arch, "shape": shape, "status": "fail",
                           "error": err or "no output"}, f, indent=1)
        n_ok += st == "ok"
        n_skip += st == "skip"
        n_fail += st == "fail"
        print(f"[{st:4s}] {arch:22s} {shape:12s} {err[-120:]}", flush=True)
    print(f"done: {n_ok} ok, {n_skip} skip, {n_fail} fail")


def _summary(rec: dict) -> str:
    st = rec["status"]
    if st == "ok":
        return (f"flops/dev={rec['cost']['flops']:.3g} "
                f"arg/dev={rec['memory']['argument_size_in_bytes']/2**30:.2f}"
                f"GiB hbm/dev={rec['memory']['total_hbm_bytes']/2**30:.2f}"
                f"GiB coll/dev={rec['collectives']['total']/2**20:.1f}MiB "
                f"trace={rec['compile_s']}s kernels={rec['kernels']}")
    if st == "skip":
        return rec["skip_reason"]
    return rec["error"].strip().splitlines()[-1][:160]


_VARIANTS = (("16x16", False), ("16x16", True), ("2x16x16", False),
             ("2x16x16", True))


def table(out: str, capacity: Optional[int] = None) -> str:
    """The records under ``out`` as a markdown table, a row an (arch,
    shape), a column a (mesh, step) variant: argument GiB / total_hbm
    GiB, TFLOP, collective GiB, trace s, and whether total_hbm fits
    ``capacity`` bytes (the card's memory; 80 GiB without a card)."""
    if capacity is None:
        capacity = (torch.cuda.get_device_properties(0).total_memory
                    if torch.cuda.is_available() else 80 * 2**30)
    recs: Dict[tuple, dict] = {}
    for path in glob.glob(os.path.join(out, "*.json")):
        with open(path) as f:
            r = json.load(f)
        mesh = r.get("mesh") or ("2x16x16" if "__multipod__" in path
                                 else "16x16")
        spec = r.get("spec_step", path.endswith("__spec.json"))
        recs[(r["arch"], r["shape"], mesh, spec)] = r

    def cell(r: Optional[dict]) -> str:
        if r is None:
            return "not run"
        if r["status"] == "skip":
            return "skip"
        if r["status"] != "ok":
            err = r.get("error", "").strip().splitlines() or ["no output"]
            return "fail: " + err[-1].split(":")[0][:40]
        m, g = r["memory"], 2**30
        return (f"{m['argument_size_in_bytes'] / g:.2f} / "
                f"{m['total_hbm_bytes'] / g:.2f}, "
                f"{r['cost']['flops'] / 1e12:.4g}, "
                f"{r['collectives']['total'] / g:.2f}, {r['compile_s']}, "
                f"{'yes' if m['total_hbm_bytes'] <= capacity else 'no'}")
    order = {s: i for i, s in enumerate(
        ("prefill_32k", "decode_32k", "long_500k", "train_4k"))}
    rows = sorted({(a, s) for a, s, _, _ in recs},
                  key=lambda k: (order[k[1]], k[0]))
    head = ["arch", "shape"] + [f"{m} {'spec' if sp else 'base'}"
                                for m, sp in _VARIANTS]
    lines = ["| " + " | ".join(head) + " |",
             "|" + "---|" * len(head)]
    for a, s in rows:
        lines.append("| " + " | ".join(
            [a, s] + [cell(recs.get((a, s, m, sp))) for m, sp in _VARIANTS])
            + " |")
    return "\n".join(lines)


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", choices=ALL_ARCHS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true",
                    help="run the assigned 10x4 matrix, a process a case")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--spec", action="store_true",
                    help="trace the speculative (k,w+1) verify step instead "
                         "of the 1-token decode")
    ap.add_argument("--roofline", action="store_true",
                    help="add the 1- and 2-period calibration traces")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--device", default="cuda",
                    help="device of the fake tensors: the card (default) "
                         "or cpu")
    ap.add_argument("--timeout", type=int, default=2400,
                    help="seconds a case may take under --all; its "
                         "process is then stopped and the case recorded "
                         "as failed")
    ap.add_argument("--table", action="store_true",
                    help="print the records under --out as a markdown "
                         "table (arg / total_hbm GiB, TFLOP, collective "
                         "GiB, trace s, fits the card) and exit")
    args = ap.parse_args(argv)

    if args.table:
        print(table(args.out))
        return

    if args.all:
        # cheap decode shapes first, train last (it raises: no sharded
        # train step yet)
        order = ["decode_32k", "long_500k", "prefill_32k", "train_4k"]
        _drive_subprocesses([(a, s) for s in order for a in ASSIGNED_ARCHS],
                            args, timeout_s=args.timeout)
        return
    if not (args.arch and args.shape):
        ap.error("--arch and --shape, or --all")
    os.makedirs(args.out, exist_ok=True)
    fname = _fname(args.out, args.arch, args.shape, args.multi_pod,
                   args.spec)
    try:
        # the base record first, so that a slow calibration never loses it
        rec = run_case(args.arch, args.shape, args.multi_pod,
                       spec_step=args.spec, device=args.device)
        with open(fname, "w") as f:
            json.dump(rec, f, indent=1)
        if args.roofline and rec["status"] == "ok":
            rec = run_case(args.arch, args.shape, args.multi_pod,
                           spec_step=args.spec, roofline=True,
                           device=args.device)
    except Exception:
        rec = {"arch": args.arch, "shape": args.shape, "status": "fail",
               "error": traceback.format_exc()[-2000:]}
    with open(fname, "w") as f:
        json.dump(rec, f, indent=1)
    print(f"[{rec['status']:4s}] {args.arch:22s} {args.shape:12s} "
          f"{_summary(rec)}", flush=True)
    if rec["status"] == "fail":
        raise SystemExit(1)


if __name__ == "__main__":
    main()
