"""Training launcher: ``python -m repro_torch.launch.train --arch <id>
[...]`` (port of ``repro/launch/train.py``).

Trains a registry config (the reduced smoke config unless ``--full``) on
the synthetic three-task corpus with AdamW, on the CUDA card unless
``--device cpu``, and saves the parameters in the reference's npz layout
with ``--save``.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

from ..configs import ALL_ARCHS, get_config, get_smoke_config
from ..data.pipeline import mixed_batches
from ..train import AdamWConfig, init_train_state, make_train_step
from ..train.checkpoint import save


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Runs the launcher on ``argv`` (the command line when None); returns
    the final train state."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", choices=ALL_ARCHS, default="mistral-7b")
    ap.add_argument("--smoke", action="store_true", default=True,
                    help="use the reduced config (the default)")
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--save", default="")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.embedding_inputs:
        raise SystemExit(f"{args.arch}: embedding-input arch; use the "
                         "frontend-stub training path in tests/benchmarks")
    print(f"arch={cfg.name} params={cfg.param_count():,}")
    ts = init_train_state(cfg, seed=0, device=args.device)
    opt = AdamWConfig(lr=args.lr, total_steps=args.steps,
                      warmup_steps=max(args.steps // 10, 1))
    step = make_train_step(cfg, opt, remat=False)
    t0 = time.time()
    for i, b in enumerate(mixed_batches(args.batch, args.seq, args.steps)):
        ts, m = step(ts, b)
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i:4d} loss={float(m['loss']):.4f} "
                  f"ppl={float(m['ppl']):.1f} "
                  f"lr={float(m['lr']):.2e} "
                  f"({(time.time()-t0)/(i+1):.2f}s/step)", flush=True)
    if args.save:
        save(args.save, ts["params"])
        print("saved ->", args.save)
    return ts


if __name__ == "__main__":
    main()
