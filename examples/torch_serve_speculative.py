"""End-to-end serving on the PyTorch port: train a small model for
a few hundred steps, then serve batched requests through the scheduler
and engine, comparing greedy with the paper's mixed batched speculation:
first with static batching (serve_all), then with continuous batching
(serve_continuous) under staggered arrivals and heterogeneous
max_new_tokens, then over the paged KV cache.  The counterpart of
``examples/serve_speculative.py``.

Run:  PYTHONPATH=src python examples/torch_serve_speculative.py
      [--steps 200] [--requests 6] [--device cuda|cpu]
"""
import argparse
import time
from typing import Dict, List, Optional, Sequence

import torch

from repro_torch.core.spec_engine import SpecConfig
from repro_torch.data.datasets import make_prompts
from repro_torch.data.pipeline import mixed_batches
from repro_torch.models.config import ModelConfig
from repro_torch.serving.engine import ServingEngine
from repro_torch.train import AdamWConfig, init_train_state, make_train_step

CFG = ModelConfig(name="serve-demo", num_layers=3, d_model=160, num_heads=4,
                  num_kv_heads=2, d_ff=384, vocab_size=259,
                  param_dtype=torch.float32, compute_dtype=torch.float32)


def train(steps: int, device: str, cfg: ModelConfig = CFG):
    """``steps`` AdamW steps from seed 0; returns the parameters."""
    ts = init_train_state(cfg, seed=0, device=device)
    step = make_train_step(cfg, AdamWConfig(
        lr=1e-3, total_steps=steps, warmup_steps=steps // 10))
    t0 = time.time()
    for b in mixed_batches(8, 128, steps):
        ts, m = step(ts, b)
    print(f"trained {steps} steps in {time.time()-t0:.0f}s, "
          f"loss={float(m['loss']):.3f}")
    return ts["params"]


def serve(params, prompts: List[str], device: str, cfg: ModelConfig = CFG,
          max_new: int = 48, cont_budgets=(32, 24)
          ) -> Dict[str, list]:
    """Serves ``prompts`` four ways and prints a line each: static greedy
    and mixed (10, 10) at ``max_new`` tokens; continuous, the first half
    at ``cont_budgets[0] + 8 * (i % 3)`` tokens, three steps, then the
    second half at ``cont_budgets[1] + 8 * (i % 3)``; paged, the first
    half at ``cont_budgets[0]``.  Returns {mode: finished requests}."""
    out: Dict[str, list] = {}
    mixed_eng = None
    for mode, spec in [("greedy", SpecConfig(strategy="greedy",
                                             max_new_tokens=max_new)),
                       ("spec(10,10)", SpecConfig(k=10, w=10,
                                                  strategy="mixed",
                                                  max_new_tokens=max_new))]:
        eng = ServingEngine(params, cfg, spec, max_batch=4, device=device)
        if spec.strategy == "mixed":
            mixed_eng = eng
        for p in prompts:
            eng.submit(p, max_new_tokens=max_new)
        t0 = time.time()
        reqs = eng.serve_all()
        dt = time.time() - t0
        tpc = sum(r.stats["tokens_per_call"] for r in reqs) / len(reqs)
        calls = sum(r.stats["model_calls"] for r in reqs)
        print(f"{mode:12s}: {len(reqs)} requests, {calls} total calls, "
              f"{tpc:.2f} tokens/call, wall {dt:.1f}s")
        print("   sample:", reqs[0].output[:70].replace("\n", "\\n"))
        out[mode] = reqs

    # --- continuous batching: staggered arrivals, heterogeneous budgets ---
    # (the engine sizes its DecodeState from the queued prompts at first
    # step)
    half = len(prompts) // 2
    cont_eng = ServingEngine(params, cfg,
                             SpecConfig(k=10, w=10, strategy="mixed"),
                             tables=mixed_eng.tables,  # the one-off sweep
                             max_batch=4, max_new_cap=64, device=device)
    for i, p in enumerate(prompts[:half]):
        cont_eng.submit(p, max_new_tokens=cont_budgets[0] + 8 * (i % 3))
    t0 = time.time()
    done = []
    for _ in range(3):                  # a few steps before the late wave
        done.extend(cont_eng.step())
    for i, p in enumerate(prompts[half:]):
        cont_eng.submit(p, max_new_tokens=cont_budgets[1] + 8 * (i % 3))
    done.extend(cont_eng.serve_continuous())
    dt = time.time() - t0
    calls = sum(r.stats["model_calls"] for r in done)
    toks = sum(r.stats["new_tokens"] for r in done)
    print(f"{'continuous':12s}: {len(done)} requests, {calls} total calls, "
          f"{toks / max(calls, 1):.2f} tokens/call, wall {dt:.1f}s "
          f"(staggered arrivals, per-request budgets)")
    out["continuous"] = done

    # --- paged KV: the same serving loop, slots share a page pool ---------
    paged_eng = ServingEngine(params, cfg,
                              SpecConfig(k=10, w=10, strategy="mixed"),
                              tables=mixed_eng.tables, max_batch=4,
                              max_new_cap=64, paged=True, device=device)
    for p in prompts[:half]:
        paged_eng.submit(p, max_new_tokens=cont_budgets[0])
    done_p = paged_eng.serve_continuous()
    toks_p = sum(r.stats["new_tokens"] for r in done_p)
    print(f"{'paged':12s}: {len(done_p)} requests, {toks_p} tokens, "
          f"pool {paged_eng.pool_stats()}")
    out["paged"] = done_p
    return out


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, list]:
    ap = argparse.ArgumentParser(prog="examples/torch_serve_speculative.py")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--device", default="cuda", help="cuda (the default) "
                    "or cpu")
    args = ap.parse_args(argv)
    params = train(args.steps, args.device)
    prompts = [p for p, _ in make_prompts("code", args.requests)]
    return serve(params, prompts, args.device)


if __name__ == "__main__":
    main()
