"""Train a ~30M-param model on the synthetic corpus with the PyTorch port
and watch speculation quality improve as the model sharpens (tokens/call
rises with training).  The counterpart of ``examples/train_tiny.py``.

Run:  PYTHONPATH=src python examples/torch_train_tiny.py [--steps 300]
      [--device cuda|cpu]
"""
import argparse
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.core.ngram_tables import (NGramTables, build_bigram,
                                           build_unigram)
from repro_torch.core.spec_engine import SpecConfig, generate
from repro_torch.data.pipeline import mixed_batches
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.train import AdamWConfig, init_train_state, make_train_step

CFG = ModelConfig(name="tiny-30m", num_layers=4, d_model=256, num_heads=8,
                  num_kv_heads=4, d_ff=1024, vocab_size=259,
                  param_dtype=torch.float32, compute_dtype=torch.float32)
PROMPT = "def mul_numbers(a, b):\n"


def tokens_per_call(params, cfg: ModelConfig = CFG,
                    device: str = "cuda") -> float:
    """Mixed (10, 10) speculation's tokens/call on the prompt, over tables
    swept from ``params``."""
    fwd = lambda t: M.forward(params, cfg, tokens=t)[0][:, -1]
    topk, chain = build_bigram(fwd, cfg.vocab_size, k_max=10, w_max=10,
                               device=device)
    uni = build_unigram(params["embed"]["embedding"],
                        params["embed"]["lm_head"], k_max=10)
    tables = NGramTables(uni, topk, chain)
    prompt = torch.as_tensor(ByteTokenizer().encode_batch([PROMPT], 24))
    spec = SpecConfig(k=10, w=10, strategy="mixed", max_new_tokens=48)
    _, _, stats = generate(params, cfg, spec, prompt, tables, device=device)
    return float(stats["tokens"][0]) / max(int(stats["calls"][0]), 1)


def train(steps: int, device: str, cfg: ModelConfig = CFG
          ) -> Tuple[dict, List[Tuple[int, float, float]]]:
    """``steps`` AdamW steps from seed 0, reading tokens/call three times
    on the way; returns (params, [(step, loss, tokens/call)])."""
    ts = init_train_state(cfg, seed=0, device=device)
    step = make_train_step(cfg, AdamWConfig(
        lr=6e-4, total_steps=steps, warmup_steps=steps // 10))
    curve = []
    for i, b in enumerate(mixed_batches(8, 128, steps)):
        ts, m = step(ts, b)
        if (i + 1) % max(steps // 3, 1) == 0:
            tpc = tokens_per_call(ts["params"], cfg, device)
            loss = float(m["loss"])
            print(f"step {i+1:4d}: loss={loss:.3f} -> tokens/call={tpc:.2f}")
            curve.append((i + 1, loss, tpc))
    return ts["params"], curve


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(prog="examples/torch_train_tiny.py")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--device", default="cuda", help="cuda (the default) "
                    "or cpu")
    args = ap.parse_args(argv)
    print(f"params: {CFG.param_count():,}")
    return train(args.steps, args.device)


if __name__ == "__main__":
    main()
