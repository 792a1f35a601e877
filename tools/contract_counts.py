#!/usr/bin/env python3
"""The contract checker's findings, the host syncs of a step and the
MoE and M-RoPE mixed steps' profiles, for one checkout, at full width on
the card.

    python3 tools/contract_counts.py TREE [--checker-from DIR]

Imports the port and ``chip_smoke.py`` of the checkout TREE, builds its
kernels, then loads each model of ``chip_smoke.py``'s phase 13a in turn
(seeded bf16, full width; Mistral-7B at 4 layers, Qwen2-VL at 2, the
Jamba hybrid at one period without experts), and for each of its registry
cases prints:
  - the level-1 findings per rule (``runtime_rules.check_case`` with the
    sync debug mode off, so that a synchronising step runs on and every
    rule is read);
  - the synchronising calls one steady step makes, as
    ``torch.cuda.set_sync_debug_mode("warn")`` counts them.
DeepSeek-MoE-16B's and Qwen2-VL's static mixed (10, 10) steps over phase
3's 8 requests are profiled as phase 12a profiles DeepSeek's (wall ms,
device-busy ms, device ops a step; DeepSeek's MoE FFN's device ms).  The
last line is one JSON object.

A checkout without ``src/repro_torch/analysis`` (one from before the
checker) gets a copy of DIR's with ``--checker-from DIR``: give TREE as a
scratch copy under a git-ignored directory.  To compare two checkouts on
one card, run them in one call in the order parent, this, this, parent.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time
import warnings

MODELS = (  # label, arch, layers (0: all), registry cases
    ("stablelm-1.6b", "stablelm-1.6b", 0,
     ("linear-greedy", "linear-mixed", "linear-sampled", "linear-adaptive",
      "tree", "paged-mixed")),
    ("hybrid", "jamba-1.5-large-398b", 0, ("hybrid",)),
    ("mistral-7b", "mistral-7b", 4, ("window",)),
    ("qwen2-vl-72b", "qwen2-vl-72b", 2, ("mrope",)),
    ("deepseek-moe-16b", "deepseek-moe-16b", 0, ("moe",)),
    ("xlstm-125m", "xlstm-125m", 0, ("xlstm",)),
)
PROFILED = ("deepseek-moe-16b", "qwen2-vl-72b")
# the sync debug mode's warning for a synchronising call (the mode also
# warns, once a process, that it is a prototype: not counted)
SYNC_WARNING = "called a synchronizing CUDA operation"


def warn_syncs(built) -> int:
    """Synchronising calls of one steady step (three slots admitted, one
    warm step first), as the sync debug mode's warnings count them."""
    import torch
    from repro_torch.analysis import registry, runtime_rules
    from repro_torch.core.spec_engine import spec_step
    s = built.state
    prompts = registry.prompts(built.cfg)
    for slot in range(registry.NUM_SLOTS - 1):
        s = runtime_rules._admit(built, s, slot, prompts[slot])
    s = spec_step(built.params, built.cfg, built.spec, s, built.tables)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            spec_step(built.params, built.cfg, built.spec, s, built.tables)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return sum(SYNC_WARNING in str(w.message) for w in caught)


def main() -> int:
    ap = argparse.ArgumentParser(prog="tools/contract_counts.py")
    ap.add_argument("tree")
    ap.add_argument("--checker-from", default="")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    have = os.path.join(tree, "src", "repro_torch", "analysis")
    if not os.path.isdir(have):
        if not args.checker_from:
            raise SystemExit(f"{tree} has no checker: pass --checker-from")
        shutil.copytree(os.path.join(os.path.abspath(args.checker_from),
                                     "src", "repro_torch", "analysis"), have)
    sys.path[:0] = [os.path.join(tree, "src"), tree]
    import torch
    import chip_smoke as cs
    from repro_torch.analysis import registry, runtime_rules
    from repro_torch.configs.jamba_1_5_large_398b import no_experts
    from repro_torch.core.spec_engine import SpecConfig
    from repro_torch.kernels import build

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    t0 = time.perf_counter()
    build.build()
    print(f"{tree}: kernels built in {time.perf_counter() - t0:.1f} s; "
          f"{cs.card_line()}")
    out = {"tree": tree, "card": cs.card_line(), "cases": {}}
    for label, arch, layers, cases in MODELS:
        cfg = cs.arch_config(arch, layers)
        if label == "hybrid":
            cfg = no_experts(cfg, cs.HYB_PERIODS)
        params = cs.load_model(cfg)
        for name in cases:
            c = registry.case(name)
            built = registry.build_case(c, device="cuda", cfg=cfg,
                                        params=params)
            found = runtime_rules.check_case(built, sync_debug=False)
            rules: dict = {}
            for f in found:
                rules[f.rule] = rules.get(f.rule, 0) + 1
            syncs = warn_syncs(registry.build_case(c, device="cuda", cfg=cfg,
                                                   params=params))
            out["cases"][f"{label} {name}"] = dict(findings=rules,
                                                  syncs=syncs)
            print(f"  {label} {name}: findings {rules or 0}, synchronising "
                  f"calls in a step {syncs}", flush=True)
            for f in found:
                print(f"    {f.format().splitlines()[0]}")
        if arch in PROFILED:
            tables = cs.arch_tables(params, cfg)
            with cs.named_ranges():
                out[f"{label} step"] = cs.profile_steps(
                    params, cfg, SpecConfig(k=cs.SERVE_K, w=cs.SERVE_W,
                                            strategy="mixed"),
                    tables, cs.smoke_prompts(), steps=3,
                    label=f"{label} mixed step", ranges=cs.RANGES)
            del tables
        del params
        torch.cuda.empty_cache()
    totals: dict = {}
    for r in out["cases"].values():
        for rule, n in r["findings"].items():
            totals[rule] = totals.get(rule, 0) + n
    out["findings_per_rule"] = totals
    out["syncs"] = sum(r["syncs"] for r in out["cases"].values())
    print(f"  findings per rule {totals or 0}; synchronising calls in all "
          f"the cases' steps {out['syncs']}; "
          f"{time.perf_counter() - t0:.1f} s")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
