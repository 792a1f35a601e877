"""Quickstart on the PyTorch port: the paper's method through the port's
public API.

Trains a tiny byte-level LM, builds learning-free N-gram tables from its
OWN weights (P1: no draft training, P2: no external data), then generates
with batched speculation: the output is bit-identical to greedy, in fewer
calls.  The counterpart of ``examples/quickstart.py``; ``--steps`` (the
reference's fixed 100) shortens the training.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--steps 100]
      [--device cuda|cpu]
"""
import argparse
from typing import Dict, Optional, Sequence

import torch

from repro_torch.core.ngram_tables import (NGramTables, build_bigram,
                                           build_unigram)
from repro_torch.core.spec_engine import SpecConfig, generate
from repro_torch.data.pipeline import mixed_batches
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.train import AdamWConfig, init_train_state, make_train_step

# 1. a tiny model, trained for a few steps on synthetic code/math/chat
CFG = ModelConfig(name="quickstart", num_layers=2, d_model=128, num_heads=4,
                  num_kv_heads=2, d_ff=256, vocab_size=259,
                  param_dtype=torch.float32, compute_dtype=torch.float32)
PROMPT = "def add_numbers(a, b):\n"
PROMPT_LEN = 24


def train(steps: int, device: str, cfg: ModelConfig = CFG):
    """``steps`` AdamW steps from seed 0; returns the parameters."""
    ts = init_train_state(cfg, seed=0, device=device)
    step = make_train_step(cfg, AdamWConfig(lr=1e-3, total_steps=steps,
                                            warmup_steps=10))
    for batch in mixed_batches(8, 128, steps):
        ts, metrics = step(ts, batch)
    print(f"trained: loss={float(metrics['loss']):.3f}")
    return ts["params"]


def make_tables(params, cfg: ModelConfig, device: str) -> NGramTables:
    """2. learning-free tables from the model itself (one-off sweep)."""
    fwd = lambda t: M.forward(params, cfg, tokens=t)[0][:, -1]
    bigram_topk, chain = build_bigram(fwd, cfg.vocab_size, k_max=10,
                                      w_max=10, device=device)
    unigram = build_unigram(params["embed"]["embedding"],
                            params["embed"]["lm_head"], k_max=10)
    return NGramTables(unigram, bigram_topk, chain)


def speculate(params, cfg: ModelConfig, tables: NGramTables, device: str,
              strategies=("greedy", "mixed")) -> Dict[str, dict]:
    """3. batched speculation vs greedy: the same output, fewer model
    calls.  Returns {strategy: {"ids": new token ids, "calls": model
    calls, "tokens_per_call": ...}}."""
    tok = ByteTokenizer()
    prompt = torch.as_tensor(tok.encode_batch([PROMPT], PROMPT_LEN))
    out = {}
    for strategy in strategies:
        spec = SpecConfig(k=10, w=10, strategy=strategy, max_new_tokens=64)
        buf, blen, stats = generate(params, cfg, spec, prompt, tables,
                                    device=device)
        ids = buf[0, PROMPT_LEN:int(blen[0])].cpu().numpy()
        calls = int(stats["calls"][0])
        tpc = float(stats["tokens"][0]) / max(calls, 1)
        print(f"\n--- {strategy}: {calls} calls, {tpc:.2f} tokens/call ---")
        print(tok.decode(ids))
        out[strategy] = {"ids": ids.tolist(), "calls": calls,
                         "tokens_per_call": tpc}
    return out


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, dict]:
    ap = argparse.ArgumentParser(prog="examples/torch_quickstart.py")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--device", default="cuda", help="cuda (the default) "
                    "or cpu")
    args = ap.parse_args(argv)
    params = train(args.steps, args.device)
    tables = make_tables(params, CFG, args.device)
    return speculate(params, CFG, tables, args.device)


if __name__ == "__main__":
    main()
