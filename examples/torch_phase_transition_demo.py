"""The paper's §3 phase-transition analysis on the H100's roofline (Fig. 1
analogue), from the PyTorch port's ``core/phase.py``.

Prints the roofline-modelled slowdown of a (k, w+1) verification call
against a plain decode call for Mistral-7B, over context lengths: where
the 'free verification' assumption breaks, and how the bifurcated
(shared-cache) layout pushes the boundary against the paper's
replicated-cache layout.  The roofline is the H100 SXM data sheet's, not
a measurement: 989e12 dense bf16 FLOP/s and 3.35e12 B/s of HBM.  The
counterpart of ``examples/phase_transition_demo.py`` (whose roofline is
a TPU's).

Run:  PYTHONPATH=src python examples/torch_phase_transition_demo.py
      [--device cuda|cpu]
"""
import argparse
from typing import Optional, Sequence

import torch

from repro_torch.configs import get_config
from repro_torch.core.phase import HBM_BW, PEAK_FLOPS, slowdown, \
    verify_call_cost
from repro_torch.device import resolve_device

SHAPES = ((5, 4), (10, 10), (25, 14))


def table(cfg, ells, shared_cache: bool = True) -> list:
    """[(ell, [slowdown at each of SHAPES])]."""
    return [(ell, [slowdown(cfg, ell, k, w, shared_cache=shared_cache)
                   for (k, w) in SHAPES]) for ell in ells]


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(
        prog="examples/torch_phase_transition_demo.py")
    ap.add_argument("--device", default="cuda", help="cuda (the default) "
                    "or cpu: the card whose name is printed beside the "
                    "data sheet's roofline")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_config("mistral-7b")
    where = ("the CPU" if dev.type == "cpu"
             else torch.cuda.get_device_name(dev))
    print(f"model: {cfg.name}  (H100 SXM roofline model: "
          f"{PEAK_FLOPS:.3g} FLOP/s, {HBM_BW:.3g} B/s, data sheet; running "
          f"on {where})\n")
    print("ell      (k,w)=(5,4)   (10,10)    (25,14)   [shared-cache]")
    for ell, row in table(cfg, (25, 100, 500, 4096, 32768)):
        print(f"{ell:6d} " + "  ".join(f"{s:8.2f}x" for s in row))
    print("\nsame, paper's replicated-cache layout (k x KV reads):")
    for ell, row in table(cfg, (500, 4096, 32768), shared_cache=False):
        print(f"{ell:6d} " + "  ".join(f"{s:8.2f}x" for s in row))
    c = verify_call_cost(cfg, 4096, 10, 10)
    print(f"\n(10,10)@4k: {c.flops/1e9:.1f} GFLOP, {c.hbm_bytes/1e9:.2f} GB "
          f"-> {'compute' if c.compute_bound else 'memory'}-bound")


if __name__ == "__main__":
    main()
