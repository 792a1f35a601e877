#!/usr/bin/env python3
"""Time this checkout's hand-written kernels beside another checkout's, on
one CUDA card, in one process, at ``chip_smoke.py``'s timing shapes.

    git archive <commit> | tar -x -C _archive/other   # any git-ignored dir
    python3 tools/compare_kernels.py _archive/other [--out FILE.json]

Both trees build their kernels with nvcc at once, each into its own
``kernels/_build/``, and print the ``-Xptxas -v`` report of every instance.
Each shape is timed by ``chip_smoke.device_ms`` (the calls enqueued while
the card spins, so the kernel's own time) in the order other, this, this,
other, on the same inputs, bf16 as served.  Drafting (K2) is timed as
each tree's model path drafts a mixed step, ``core.drafters.mixed_draft``
on the same buffers and tables, whatever kernels and torch ops that
takes; for it the script also gives CUDA-event times (``chip_smoke.
time_ms``, the host's launches included) and, last, after every timing,
the device ops one call runs and their summed device time
(torch.profiler).  Each tree's kernel is called as
that tree's model path calls it: a tree whose K5 wrapper takes no
``n_commit`` got u cast to f32 and replayed by writing every step's state
(its path then selected one), so that kernel is what is timed there (the
cast is made before the timing).  K5's backward runs at the hybrid's
training shape (bf16 u): a tree whose wrapper takes ``ckpt`` gets the
checkpoints its training forward wrote (made before the timing, as the
training call hands them over); an older one walks the scan itself.
Correctness is ``chip_smoke.py``'s business, not this script's.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import inspect
import json
import os
import sys
import threading

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as cs  # noqa: E402

NAMES = ("spec_attention", "mamba_scan", "ngram_match")   # modules
BUILDS = NAMES + ("mamba_scan_bwd",)                      # libraries


def load_other(root: str) -> dict:
    """The other checkout's ``repro_torch`` kernel modules, imported as the
    package ``other_repro_torch`` (its own build directory and counts)."""
    pkg = os.path.join(os.path.abspath(root), "src", "repro_torch")
    spec = importlib.util.spec_from_file_location(
        "other_repro_torch", os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["other_repro_torch"] = mod
    spec.loader.exec_module(mod)
    mods = {n: importlib.import_module(f"other_repro_torch.kernels.{n}")
            for n in ("build",) + NAMES}
    mods["drafters"] = importlib.import_module(
        "other_repro_torch.core.drafters")
    return mods


def cases():
    """(name, call(kernel modules) -> None) at chip_smoke's timing shapes."""
    import torch
    from repro_torch.core.tree import topology
    from repro_torch.kernels.ref import gather_pages
    from repro_torch.kernels.spec_attention import tree_mask
    bf = torch.bfloat16
    W1 = cs.SERVE_W + 1
    S = cs.SERVE_BUCKET + cs.SERVE_NEW + cs.SERVE_W + 2
    cur = [cs.SERVE_BUCKET + (cs.SERVE_NEW - 1) * i // 7 for i in range(8)]
    cont = [cs.CONT_BUCKETS[0] + 40 * i for i in range(cs.CONT_SLOTS)]
    pages = cs.CONT_PAGES + 1
    out = []

    def k1(name, *shape, seed, w1):
        ops = cs.k1_inputs(8, *shape, S, cur, bf, seed=seed)
        out.append((name, lambda m: m["spec_attention"].spec_attention_cuda(
            *ops, w1=w1)))

    k1("K1 verify", cs.SERVE_K, W1, 32, 32, 64, seed=1, w1=W1)
    k1("K1 decode", 1, 1, 32, 32, 64, seed=2, w1=1)
    k1("K1 hybrid verify", cs.SERVE_K, W1, 64, 8, 128, seed=11, w1=W1)
    k1("K1 hybrid decode", 1, 1, 64, 8, 128, seed=12, w1=1)
    for name, K, w1, seed in (("K3 verify", cs.SERVE_K, W1, 3),
                              ("K3 decode", 1, 1, 4)):
        ops3 = cs.k3_inputs(8, K, w1, 32, 32, 64, cs.CONT_PAGE, cont, bf,
                            seed=seed, n_pages=pages)
        out.append((name, lambda m, o=ops3, w=w1: m["spec_attention"]
                    .paged_spec_attention_cuda(*o, w1=w)))
    topo = topology(*cs.TREE_WDB)
    wt = topo.num_nodes + 1
    tm = tree_mask(topo.anc_mask, "cuda")
    ops4 = cs.k3_inputs(8, 1, wt, 32, 32, 64, cs.CONT_PAGE, cont, bf, seed=5,
                        n_pages=pages)
    q, kp, vp, pt, kt, vt, cl = ops4
    k_lin, v_lin = gather_pages(kp, vp, pt)
    out.append(("K4 linear", lambda m: m["spec_attention"].spec_attention_cuda(
        q, k_lin, v_lin, kt, vt, cl, w1=wt, anc=tm.anc)))
    out.append(("K4 paged", lambda m: m["spec_attention"]
                .paged_spec_attention_cuda(*ops4, w1=wt, anc=tm.anc)))
    di, ds = 16384, 16                       # Jamba: d_inner, d_state
    commit = torch.tensor([0, 1, 3, 5, 7, 9, W1, W1], dtype=torch.int32,
                          device="cuda")
    for name, Bt, T, rep, final, nc in (
            ("K5 prefill", 8, cs.SERVE_BUCKET, 1, True, None),
            ("K5 verify", 8 * cs.SERVE_K, W1, cs.SERVE_K, False, None),
            ("K5 replay", 8, W1, 1, True, commit),
            ("K5 decode", 8, 1, 1, True, None)):
        ops5 = cs.k5_inputs(Bt, T, di, ds, seed=7, h0_rep=rep, u_dtype=bf)
        ops32 = (ops5[0].float(),) + ops5[1:]
        out.append((name, lambda m, o=ops5, o32=ops32, r=rep, f=final, n=nc:
                    scan(m["mamba_scan"].mamba_scan_cuda, o, o32, r, f, n)))
    out.append(("K5 backward train", backward_case(di, ds)))
    return out + drafting_cases(S, cur)


def backward_case(di, ds):
    """K5's backward at chip_smoke's timing shape (TRAIN_B x TRAIN_T, bf16
    u, no gradient into the final state), each tree's wrapper called as its
    training call calls it (``ckpt`` where it takes one)."""
    import torch
    from repro_torch.kernels.mamba_scan import mamba_scan_cuda, n_chunks
    ops = cs.k5_inputs(cs.TRAIN_B, cs.TRAIN_T, di, ds, seed=5,
                       u_dtype=torch.bfloat16)
    dy = torch.randn((cs.TRAIN_B, cs.TRAIN_T, di), device="cuda")
    ckpt = torch.empty((cs.TRAIN_B, n_chunks(cs.TRAIN_T), di, ds),
                       device="cuda")
    mamba_scan_cuda(*ops, final=False, ckpt=ckpt)

    def call(m):
        fn = m["mamba_scan"].mamba_scan_bwd_cuda
        if "ckpt" in inspect.signature(fn).parameters:
            return fn(*ops, dy, ckpt=ckpt)
        return fn(*ops, dy)
    return call


def drafting_cases(S, cur):
    """A mixed step's drafting at chip_smoke's three real-text shapes (B=8
    L=332, B=4 L=4096, B=2 L=32768; StableLM's vocabulary, q=1, k=w=10)."""
    import torch
    from repro_torch.core.ngram_tables import NGramTables
    topk, chain = cs.k2_tables(cs.K2_VOCABS["stablelm"], seed=0)
    tables = NGramTables(torch.arange(topk.shape[1], dtype=torch.int32,
                                      device="cuda"), topk, chain)
    out = []
    for B, L, c in ((8, S, cur), (4, 4096, [4096, 4000, 2500, 300]),
                    (2, 32768, [32768, 20001])):
        buf, cl = cs.k2_text_rows(B, L, c)
        last = buf.gather(1, torch.remainder(cl.long() - 1, L)[:, None])[:, 0]
        out.append((f"K2 drafting B={B} L={L}",
                    lambda m, b=buf, c=cl, t=last: m["drafters"].mixed_draft(
                        tables, b, c, t, 1, cs.SERVE_K, cs.SERVE_W)))
    return out


def device_ops(fn, calls: int = 5) -> tuple:
    """(device ops, their summed device ms) of one ``fn()``, by
    torch.profiler over ``calls`` calls after a warm one."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    cs.sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        cs.sync()
    ops = [e for e in prof.key_averages()
           if str(e.device_type).endswith("CUDA")]
    return (sum(e.count for e in ops) / calls,
            sum(getattr(e, "self_device_time_total",
                        getattr(e, "self_cuda_time_total", 0.0))
                for e in ops) / 1e3 / calls)


def scan(fn, ops, ops32, rep, final, n_commit):
    """K5 as its tree's path calls it: with ``n_commit`` and u as the layer
    hands it (``ops``) where the wrapper takes ``n_commit``; else on f32 u
    (``ops32``, cast beforehand: the kernel alone is timed), the replay
    writing every step's state."""
    if "n_commit" in inspect.signature(fn).parameters:
        return fn(*ops, h0_rep=rep, final=final, n_commit=n_commit)
    return fn(*ops32, h0_rep=rep, final=final and n_commit is None,
              steps=n_commit is not None)


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", help="another checkout of the repository")
    ap.add_argument("--out", help="also write the times to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("compare_kernels: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core import drafters
    from repro_torch.kernels import (build, mamba_scan, ngram_match,
                                     spec_attention)
    this = {"build": build, "spec_attention": spec_attention,
            "mamba_scan": mamba_scan, "ngram_match": ngram_match,
            "drafters": drafters}
    other = load_other(args.other)
    built = []
    th = threading.Thread(target=lambda: built.append(
        other["build"].build(BUILDS)))
    th.start()
    build.build(BUILDS)
    th.join()
    if not built:
        raise RuntimeError(f"the kernels in {args.other} did not build")
    for label, mods in (("this", this), ("other", other)):
        for name in BUILDS:
            log = mods["build"].BUILD_DIR / f"{name}.log"
            for kernel, report in cs.ptxas_report(log.read_text()):
                print(f"  {label} {name}: {kernel}: {report}")
    card = cs.card_line()
    print(f"  {card}; other tree: {args.other}")
    rows = []
    all_cases = cases()
    for name, call in all_cases:
        # a drafting call of the other tree may launch ~150 kernels: 5 calls
        # keep them inside CUDA's queue of pending launches while the card
        # spins (a full queue blocks the host, and the spin then ends first)
        n = 5 if name.startswith("K2") else 20
        o1 = cs.device_ms(lambda: call(other), iters=n)
        t1 = cs.device_ms(lambda: call(this), iters=n)
        t2 = cs.device_ms(lambda: call(this), iters=n)
        o2 = cs.device_ms(lambda: call(other), iters=n)
        ok = None not in (o1, t1, t2, o2)
        t, o = ((t1 + t2) / 2, (o1 + o2) / 2) if ok else (None, None)
        rows.append(dict(name=name, device_ms=t, other_device_ms=o,
                         runs=[o1, t1, t2, o2]))
        print(f"  {name:24s} device ms: this {cs.fmt_ms(t)} other "
              f"{cs.fmt_ms(o)}" + (f" ({t / o:.2f}x)" if ok else "")
              + f"  [other, this, this, other: "
              f"{', '.join(cs.fmt_ms(x) for x in (o1, t1, t2, o2))}]")
        if name.startswith("K2"):
            ev = [cs.time_ms(lambda: call(m))
                  for m in (other, this, this, other)]
            rows[-1].update(ms=(ev[1] + ev[2]) / 2,
                            other_ms=(ev[0] + ev[3]) / 2)
            print(f"  {name:24s} CUDA-event ms: this {rows[-1]['ms']:.4f} "
                  f"other {rows[-1]['other_ms']:.4f}  [other, this, this, "
                  f"other: {', '.join(f'{x:.4f}' for x in ev)}]")
    for (name, call), row in zip(all_cases, rows):
        if name.startswith("K2"):
            (row["ops"], row["profiled_ms"]), (row["other_ops"],
                                               row["other_profiled_ms"]) = (
                device_ops(lambda: call(m)) for m in (this, other))
            print(f"  {name:24s} device ops a call: this {row['ops']:.0f} "
                  f"({row['profiled_ms']:.4f} device ms, profiler) other "
                  f"{row['other_ops']:.0f} ({row['other_profiled_ms']:.4f})")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "other": args.other, "kernels": rows},
                      f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
