#!/usr/bin/env python3
"""Time StableLM-2-1.6B training steps (full width, bf16 params, f32
moments, B 8 x T 128, remat) for the port of one checkout, on one CUDA
card, in a fresh process:

    git archive <commit> | tar -x -C _archive/other   # any git-ignored dir
    for t in _archive/other . . _archive/other; do
        python3 tools/time_train_step.py $t; done

With ``--hybrid``, chip_smoke's phase 11e model instead: Jamba cut to
``no_experts(with_experts(config(), 2, 3), 1)`` (a Mamba and an attention
layer at full width, 2.853 B), the state donated (updated in place), so
that its steps run K5, K5's training instance and K5's backward.

Prints the mean ms of steps 2-11 (by the host clock between two
synchronises), the last loss and the peak memory.  Run two checkouts in
turns (other, this, this, other) in one call to compare them on one card.
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.abspath(sys.argv[1]), "src"))
import torch  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import mixed_batches  # noqa: E402
from repro_torch.train import (AdamWConfig, init_train_state,  # noqa: E402
                               make_train_step)

STEPS, WARM = 12, 2
HYBRID = "--hybrid" in sys.argv[2:]
if HYBRID:
    from repro_torch.configs.jamba_1_5_large_398b import (  # noqa: E402
        no_experts, with_experts)
    cfg = no_experts(with_experts(get_config("jamba-1.5-large-398b"), 2, 3),
                     1)
else:
    cfg = get_config("stablelm-1.6b")
ts = init_train_state(cfg, seed=0, device="cuda")
step = make_train_step(cfg, AdamWConfig(lr=1e-3, total_steps=200,
                                        warmup_steps=20), remat=True,
                       donate=HYBRID)
batches = list(mixed_batches(8, 128, STEPS, seed=0))
torch.cuda.reset_peak_memory_stats()
for i, b in enumerate(batches):
    if i == WARM:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
    ts, m = step(ts, b)
torch.cuda.synchronize()
ms = (time.perf_counter() - t0) * 1e3 / (STEPS - WARM)
print(f"AB {sys.argv[1]}{' hybrid' if HYBRID else ''}: {ms:.2f} ms a step, loss {float(m['loss']):.4f}, "
      f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
