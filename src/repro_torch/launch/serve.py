"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id>
[...]`` (port of ``repro/launch/serve.py``).

Loads (``--ckpt``) or quickly trains the arch's smoke model, builds the
learning-free tables from its own weights, then serves a batch of prompts
with batched speculation and reports tokens/call per request.

``--mesh DxM`` serves over a mesh of D x M ranks (``ServingEngine(mesh=)``):
with ``--device cpu`` the launcher runs the D x M gloo ranks itself (this
process is rank 0, the others are spawned); on cards it runs under
``torchrun --nproc-per-node D*M``, one card a rank (a 1x1 mesh needs no
torchrun).  Rank 0 prints the texts and the mesh line.
"""
from __future__ import annotations

import argparse
import dataclasses
import datetime
import math
import os
import sys
import tempfile
import time
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
    "--device cpu; the same under --mesh, on each rank's shards).")

# a spawned CPU rank that outlives this many seconds past rank 0's end is
# a hang: the launcher reports it instead of waiting on it; a collective
# that waits longer than COLL_TIMEOUT raises
JOIN_DEADLINE_S = 120.0
COLL_TIMEOUT = datetime.timedelta(minutes=10)


def main(argv: Optional[Sequence[str]] = None) -> List:
    """Runs the launcher on ``argv`` (the command line when None); returns
    the served requests (rank 0's under ``--mesh``)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = _parser().parse_args(argv)
    if args.paged and not args.continuous:
        raise SystemExit("--paged applies to --continuous serving")
    if args.mesh:
        return _serve_meshed(args, argv)
    return _serve(args)


def _parser() -> argparse.ArgumentParser:
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
                    help="serve sharded over a DxM mesh (2x2 = data 2 x "
                         "model 2; 3 dims add a leading pod axis): with "
                         "--device cpu the launcher runs the D*M gloo "
                         "ranks itself; on cards run it under torchrun "
                         "--nproc-per-node D*M (1x1 needs none).  Tokens "
                         "equal unsharded serving's")
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
    return ap


def _serve(args, mesh=None, rank: int = 0) -> List:
    """Serve as ``args`` say, on ``mesh`` when given; rank 0 prints."""
    say = print if rank == 0 else (lambda *a, **k: None)

    cfg = get_smoke_config(args.arch)
    if cfg.encoder_only:
        raise SystemExit(f"{args.arch}: encoder-only arch has no decode loop")
    cfg = dataclasses.replace(cfg, vocab_size=max(cfg.vocab_size, 259))
    if args.ckpt:
        params = load(args.ckpt, cfg, args.device)
    else:
        from ..data.pipeline import mixed_batches
        say("quick-training the smoke model (pass --ckpt to skip)...")
        ts = init_train_state(cfg, seed=0, device=args.device)
        step = make_train_step(cfg, AdamWConfig(
            lr=1e-3, total_steps=QUICK_STEPS, warmup_steps=8), remat=False)
        for b in mixed_batches(8, 128, QUICK_STEPS):
            ts, m = step(ts, b)
        params = ts["params"]
        say(f"  final loss {float(m['loss']):.3f}")

    spec = SpecConfig(k=args.k, w=args.w, strategy=args.strategy,
                      max_new_tokens=args.max_new, tree=args.tree,
                      tree_branch=args.tree_branch)
    eng = ServingEngine(params, cfg, spec, max_batch=args.n_prompts,
                        max_new_cap=args.max_new, adaptive=args.adaptive,
                        paged=args.paged,
                        num_pages=args.num_pages or None,
                        page_size=args.page_size,
                        sampling=args.temperature > 0 or None,
                        seed=args.seed, device=args.device, mesh=mesh)
    for prompt, _ in make_prompts(args.task, args.n_prompts):
        eng.submit(prompt, max_new_tokens=args.max_new,
                   temperature=args.temperature, top_p=args.top_p)
    served = eng.serve_continuous() if args.continuous else eng.serve_all()
    for r in served:
        if "error" in r.stats:
            say(f"[req {r.request_id}] REJECTED: {r.stats['error']}")
            continue
        say(f"[req {r.request_id}] tokens/call="
            f"{r.stats['tokens_per_call']:.2f} "
            f"calls={r.stats['model_calls']} "
            f"output={r.output[:60]!r}")
    if args.paged:
        say(f"pool: {eng.pool_stats()}")
    if args.adaptive and args.continuous:
        say(f"bandit: {eng.adaptive_stats()}")
    if mesh is not None:
        rep = eng.mesh_report()
        say(f"mesh: {rep.get('mesh')} params sharded "
            f"{rep.get('params_sharded')}/{rep.get('params_leaves')} "
            f"state leaves sharded {rep.get('state_sharded', 'n/a')} "
            f"fallbacks {rep.get('replication_fallbacks')}")
    return served


def _serve_meshed(args, argv: List[str]) -> List:
    """``--mesh``: start the process group, build the mesh, serve.  Under
    torchrun (``WORLD_SIZE`` set) the ranks exist; with ``--device cpu``
    this process becomes rank 0 of D*M gloo ranks and spawns the rest; on
    a card a 1x1 mesh runs in this process alone."""
    import torch
    import torch.distributed as dist
    from .mesh import make_debug_mesh, parse_mesh_shape
    try:
        shape = parse_mesh_shape(args.mesh)
    except ValueError as e:
        raise SystemExit(str(e))
    need = math.prod(shape)
    cpu = args.device == "cpu"
    if "WORLD_SIZE" in os.environ:
        # torchrun (or an equivalent launcher) made the ranks
        rank = int(os.environ.get("RANK", "0"))
        if not cpu:
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group("gloo" if cpu else "nccl")
        return _run_rank(args, shape, rank)
    if not cpu:
        have = torch.cuda.device_count()
        if need > 1:
            raise SystemExit(
                f"--mesh {args.mesh} needs {need} ranks, one card each "
                f"({have} here): run it under torchrun --nproc-per-node "
                f"{need}" + ("" if have >= need else
                             f" on a host with {need} cards"))
        if have < 1:
            raise SystemExit("--mesh on cards needs a CUDA device")
        dist.init_process_group("nccl", init_method=_file_init(), rank=0,
                                world_size=1)
        return _run_rank(args, shape, 0)
    # the CPU: rank 0 here, ranks 1..need-1 spawned
    import torch.multiprocessing as mp
    init = _file_init()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_spawned_rank,
                         args=(argv, r, need, init), daemon=True)
             for r in range(1, need)]
    for p in procs:
        p.start()
    dist.init_process_group("gloo", init_method=init, rank=0,
                            world_size=need, timeout=COLL_TIMEOUT)
    try:
        return _run_rank(args, shape, 0)
    finally:
        _join(procs)


def _file_init() -> str:
    """A rendezvous file no other group uses (no port to collide on)."""
    return "file://" + os.path.join(tempfile.mkdtemp(prefix="mesh-"),
                                    "init")


def _run_rank(args, shape, rank: int) -> List:
    """Serve on this rank's share of the mesh; the group is destroyed on
    exit."""
    import torch.distributed as dist
    from .mesh import make_debug_mesh
    try:
        try:
            mesh = make_debug_mesh(shape, "cpu" if args.device == "cpu"
                                   else "cuda")
        except RuntimeError as e:
            raise SystemExit(f"--mesh {args.mesh}: {e}")
        return _serve(args, mesh, rank)
    finally:
        dist.destroy_process_group()


def _spawned_rank(argv, rank: int, world: int, init: str) -> None:
    """A spawned CPU rank of ``--mesh``: one thread, the same arguments."""
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    args = _parser().parse_args(argv)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world, timeout=COLL_TIMEOUT)
    from .mesh import parse_mesh_shape
    _run_rank(args, parse_mesh_shape(args.mesh), rank)


def _join(procs) -> None:
    """Join the spawned ranks within ``JOIN_DEADLINE_S``; a rank still
    running then is killed and reported."""
    end = time.monotonic() + JOIN_DEADLINE_S
    for p in procs:
        p.join(max(0.0, end - time.monotonic()))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join()
    failed = [p.exitcode for p in procs if p.exitcode]
    if hung or failed:
        raise SystemExit(f"--mesh: {len(hung)} spawned rank(s) hung, exit "
                         f"codes {failed}")


if __name__ == "__main__":
    main()
