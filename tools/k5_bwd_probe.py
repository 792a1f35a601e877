#!/usr/bin/env python3
"""Where K5's backward spends its time: the committed kernel timed beside
copies of it with one part taken out, on one CUDA card, in one process.

    python3 tools/k5_bwd_probe.py [--out FILE.json]

Each probe is ``csrc/mamba_scan_bwd.cu`` with one text substitution (it
stops if the text is not found), built by nvcc with the build's flags
into the git-ignored ``kernels/_build/probe/`` and timed by
``chip_smoke.device_ms`` at chip_smoke's training shape (8 x 128, d_inner
16384, d_state 16, bf16 u, the training forward's checkpoints), in the
order committed, probes..., committed.  A probe computes wrong gradients:
only its time is read.  The time a probe saves bounds what that part
costs (parts overlap, so the savings do not add up).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as cs  # noqa: E402

# name -> (text in the committed source, its replacement)
PROBES = {
    "no warp channel sums": (
        "        for (int ww = 1; ww < kW; ++ww) {\n"
        "          const float4 v = lds4(rs + ww * kOut + (o0 ^ S::swz(ww)));",
        "        for (int ww = 1; ww < 1; ++ww) {\n"
        "          const float4 v = lds4(rs + ww * kOut + (o0 ^ S::swz(ww)));"),
    "no B, C loads in the reverse walk": (
        "          const float4 Bv = lds4(Bp + j * DS + k4);\n"
        "          const float4 Cv = lds4(Cp + j * DS + k4);",
        "          const float4 Bv = make_float4(dyv, 0.25f, 0.125f, dtv);\n"
        "          const float4 Cv = make_float4(0.5f, uv, 0.125f, 0.3f);"),
    "one exp (a_t in the reverse walk as 1 + dt A)": (
        "ex2(dtv * A2[k]);           // a_t, again",
        "fmaf(dtv, A2[k], 1.f);      // a_t, again"),
}


def build_probe(name: str, src: str, out_dir: str, i: int):
    """nvcc of ``src`` with probe ``name``'s substitution -> (process,
    library path)."""
    from repro_torch.kernels import build
    old, new = PROBES[name] if name else ("", "")
    if name:
        if src.count(old) != 1:
            raise RuntimeError(f"probe {name!r}: its text is not in the "
                               f"source once")
        src = src.replace(old, new)
    cu = os.path.join(out_dir, f"probe{i}.cu")
    lib = os.path.join(out_dir, f"libprobe{i}.so")
    with open(cu, "w") as f:
        f.write(src)
    nvcc = build._nvcc()
    return subprocess.Popen([nvcc, *build.NVCC_FLAGS, "-o", lib, cu],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True), lib


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the times to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k5_bwd_probe: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build, mamba_scan as M
    out_dir = str(build.BUILD_DIR / "probe")
    os.makedirs(out_dir, exist_ok=True)
    src = (build.CSRC / "mamba_scan_bwd.cu").read_text()
    names = [""] + list(PROBES)
    procs = [build_probe(n, src, out_dir, i) for i, n in enumerate(names)]
    libs = []
    for (proc, path), name in zip(procs, names):
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name or 'committed'}:\n"
                               f"{log}")
        libs.append(ctypes.CDLL(path))
    build.build(["mamba_scan"])
    card = cs.card_line()
    di, ds = 16384, 16
    ops = cs.k5_inputs(cs.TRAIN_B, cs.TRAIN_T, di, ds, seed=5,
                       u_dtype=torch.bfloat16)
    dy = torch.randn((cs.TRAIN_B, cs.TRAIN_T, di), device="cuda")
    ckpt = torch.empty((cs.TRAIN_B, M.n_chunks(cs.TRAIN_T), di, ds),
                       device="cuda")
    M.mamba_scan_cuda(*ops, final=False, ckpt=ckpt)
    own = M._bwd_lib()   # sets the argument types the probes share
    launch = own.mamba_scan_bwd_launch

    def timed(lib) -> float:
        fn = lib.mamba_scan_bwd_launch
        fn.argtypes, fn.restype = launch.argtypes, launch.restype
        for f in ("mamba_scan_bwd_blocks", "mamba_scan_bwd_chunk"):
            g = getattr(own, f)
            getattr(lib, f).argtypes = g.argtypes
            getattr(lib, f).restype = g.restype
        M._bwd_lib = lambda: lib
        try:
            return cs.device_ms(lambda: M.mamba_scan_bwd_cuda(
                *ops, dy, ckpt=ckpt), iters=20)
        finally:
            M._bwd_lib = lambda: own
    order = list(range(len(libs))) + [0]
    times = {}
    for i in order:
        times.setdefault(i, []).append(timed(libs[i]))
    base = sum(times[0]) / len(times[0])
    print(f"  {card}; K5 backward at {cs.TRAIN_B} x {cs.TRAIN_T}, d_inner "
          f"{di}, d_state {ds}, bf16 u")
    rows = []
    for i, name in enumerate(names):
        t = sum(times[i]) / len(times[i])
        rows.append(dict(probe=name or "committed", device_ms=t,
                         runs=times[i]))
        print(f"  {name or 'committed':48s} {t:.4f} device ms"
              + (f" ({t / base - 1:+.1%})" if name else
                 f"  [first, last: {times[0][0]:.4f}, {times[0][-1]:.4f}]"))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "probes": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
