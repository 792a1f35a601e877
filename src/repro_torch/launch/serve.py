"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id>
[...]`` (port of ``repro/launch/serve.py``).

Loads (``--ckpt``) or quickly trains the arch's smoke model, builds the
learning-free tables from its own weights, then serves a batch of prompts
with batched speculation and reports tokens/call per request.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import List, Optional, Sequence

from ..configs import ALL_ARCHS, get_smoke_config
from ..core.spec_engine import SpecConfig
from ..data.datasets import make_prompts
from ..serving.engine import ServingEngine
from ..train import AdamWConfig, init_train_state, make_train_step
from ..train.checkpoint import load

QUICK_STEPS = 80

DESCRIPTION = (
    "Serve an arch's smoke model with batched speculation. The reference's "
    "--backend flag has no counterpart: the device decides the kernels "
    "(the CUDA kernels on the card, their plain PyTorch versions with "
    "--device cpu). --mesh (sharded serving) is not ported yet.")


def main(argv: Optional[Sequence[str]] = None) -> List:
    """Runs the launcher on ``argv`` (the command line when None); returns
    the served requests."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve",
                                 description=DESCRIPTION)
    ap.add_argument("--arch", choices=ALL_ARCHS, default="mistral-7b")
    ap.add_argument("--ckpt", default="", help="params npz (else quick-train)")
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--w", type=int, default=10)
    ap.add_argument("--strategy", default="mixed",
                    choices=["mixed", "bigram", "unigram", "context",
                             "greedy"])
    ap.add_argument("--max-new", type=int, default=48)
    ap.add_argument("--n-prompts", type=int, default=4)
    ap.add_argument("--task", default="code", choices=["code", "math",
                                                       "chat"])
    ap.add_argument("--continuous", action="store_true",
                    help="serve with slot-level continuous batching instead "
                         "of static batches")
    ap.add_argument("--adaptive", action="store_true",
                    help="pick (k, w) online with the UCB controller "
                         "instead of the static --k/--w: per batch under "
                         "static serving, per slot per step (arm masking "
                         "inside spec_step) under --continuous")
    ap.add_argument("--tree", action="store_true",
                    help="tree-structured speculation: branch on the top "
                         "--k candidates at the first --tree-branch depths "
                         "and verify the whole token tree in one "
                         "ancestor-masked call; attention-only archs")
    ap.add_argument("--tree-branch", type=int, default=2,
                    help="number of branching levels in the draft tree "
                         "(deeper levels chain greedily); only with --tree")
    ap.add_argument("--paged", action="store_true",
                    help="paged KV cache for continuous batching: slots "
                         "share a page pool with per-slot page tables")
    ap.add_argument("--num-pages", type=int, default=0,
                    help="page-pool size for --paged (0 = linear worst "
                         "case; smaller pools defer admission when "
                         "exhausted)")
    ap.add_argument("--page-size", type=int, default=0,
                    help="positions per page for --paged (0 = the "
                         "default page size)")
    ap.add_argument("--mesh", default="",
                    help="sharded serving over a DxM mesh: not ported yet, "
                         "exits with a message")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature for every submitted request "
                         "(0 = greedy; > 0 serves losslessly by "
                         "speculative sampling inside the same spec_step)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus mass for --temperature > 0 (1 = off)")
    ap.add_argument("--seed", type=int, default=0,
                    help="engine rng seed: request keys derive from it, so "
                         "a rerun with the same seed replays the same "
                         "sampled outputs")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    if args.mesh:
        raise SystemExit("--mesh: sharded serving is not ported to "
                         "repro_torch yet; serve on one device without "
                         "--mesh")
    if args.paged and not args.continuous:
        raise SystemExit("--paged applies to --continuous serving")

    cfg = get_smoke_config(args.arch)
    if cfg.encoder_only:
        raise SystemExit(f"{args.arch}: encoder-only arch has no decode loop")
    cfg = dataclasses.replace(cfg, vocab_size=max(cfg.vocab_size, 259))
    if args.ckpt:
        params = load(args.ckpt, cfg, args.device)
    else:
        from ..data.pipeline import mixed_batches
        print("quick-training the smoke model (pass --ckpt to skip)...")
        ts = init_train_state(cfg, seed=0, device=args.device)
        step = make_train_step(cfg, AdamWConfig(
            lr=1e-3, total_steps=QUICK_STEPS, warmup_steps=8), remat=False)
        for b in mixed_batches(8, 128, QUICK_STEPS):
            ts, m = step(ts, b)
        params = ts["params"]
        print(f"  final loss {float(m['loss']):.3f}")

    spec = SpecConfig(k=args.k, w=args.w, strategy=args.strategy,
                      max_new_tokens=args.max_new, tree=args.tree,
                      tree_branch=args.tree_branch)
    eng = ServingEngine(params, cfg, spec, max_batch=args.n_prompts,
                        max_new_cap=args.max_new, adaptive=args.adaptive,
                        paged=args.paged,
                        num_pages=args.num_pages or None,
                        page_size=args.page_size,
                        sampling=args.temperature > 0 or None,
                        seed=args.seed, device=args.device)
    for prompt, _ in make_prompts(args.task, args.n_prompts):
        eng.submit(prompt, max_new_tokens=args.max_new,
                   temperature=args.temperature, top_p=args.top_p)
    served = eng.serve_continuous() if args.continuous else eng.serve_all()
    for r in served:
        if "error" in r.stats:
            print(f"[req {r.request_id}] REJECTED: {r.stats['error']}")
            continue
        print(f"[req {r.request_id}] tokens/call="
              f"{r.stats['tokens_per_call']:.2f} "
              f"calls={r.stats['model_calls']} "
              f"output={r.output[:60]!r}")
    if args.paged:
        print(f"pool: {eng.pool_stats()}")
    if args.adaptive and args.continuous:
        print(f"bandit: {eng.adaptive_stats()}")
    return served


if __name__ == "__main__":
    main()
