"""Does rounding P to bf16 before P.V set the bf16 acceptance of the
tensor-core verify kernel (K1)?

Serves ``chip_smoke.py``'s phase 3 (StableLM-2-1.6B at full width, seeded
bf16 weights, its 8 requests, k=10, w=10, 64 new tokens, mixed drafts),
and greedy on the same prompts, once through each of three K1s:

  shipped  the kernel built from ``csrc/spec_attention.cu``: P is rounded
           to bf16 for the P.V ``mma``;
  p_split  the same source with P split into a bf16 head and a bf16
           remainder, each through its own ``mma`` (P to ~16 bits); tiles,
           key order, masks and the softmax are the shipped kernel's;
  plain    ``spec_attention_plain`` (f32 scores, P and accumulation).

For each it prints tokens/call, the verify steps, and which requests
equal greedy serving through the same K1 (with the first difference and
the bf16 top-2 logit margin there).  First it holds the shipped and the
p_split kernel against the plain version at the main verify shape, so
the error shows that the split took effect.  Needs one CUDA card and
``nvcc``; builds into the git-ignored ``kernels/_build/``:

    python3 tools/p_precision_probe.py
"""
from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402  (puts src/ on the path)

# the helper for the remainder, and the P.V step's edits (pattern,
# replacement, count the source must have)
_REST = """__device__ __forceinline__ unsigned pack_rest(float lo, float hi) {
  return pack_bf16(lo - __bfloat162float(__float2bfloat16_rn(lo)),
                   hi - __bfloat162float(__float2bfloat16_rn(hi)));
}

"""
_EDITS = [
    (r"__device__ __forceinline__ float ex2\(", _REST + r"\g<0>", 1),
    (r"unsigned pa\[MF\]\[4\];", "unsigned pa[MF][4], pr[MF][4];", 1),
    (r"(\n\s*)pa\[f\]\[(\d)\] = pack_bf16\((.*)\);",
     r"\g<0>\1pr[f][\2] = pack_rest(\3);", 4),
    (r"(\n\s*)mma16816\((o\[f\]\[2 \* d16(?: \+ 1)?\]), pa\[f\], "
     r"(bv\[\d\], bv\[\d\])\);", r"\g<0>\1mma16816(\2, pr[f], \3);", 2),
]


def build_p_split() -> ctypes.CDLL:
    """Compile the P-split variant of the verify kernel, return it."""
    from repro_torch.kernels import build
    src = build.sources()["spec_attention"].read_text()
    for pat, rep, n in _EDITS:
        src, k = re.subn(pat, rep, src)
        if k != n:
            raise RuntimeError(f"{pat!r} matched {k} times, expected {n}")
    out = build.BUILD_DIR / "p_split"
    out.mkdir(parents=True, exist_ok=True)
    (out / "spec_attention.cu").write_text(src)
    lib = out / "libspec_attention.so"
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                           str(out / "spec_attention.cu")],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    print(f"  p_split build: {cs.ptxas_report(proc.stdout + proc.stderr)}")
    return ctypes.CDLL(str(lib))


def main() -> int:
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.spec_engine import SpecConfig
    from repro_torch.kernels import build, dispatch
    from repro_torch.kernels.spec_attention import (spec_attention_cuda,
                                                    spec_attention_plain)
    from repro_torch.models import model as M
    from repro_torch.serving.engine import ServingEngine

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(cs.card_line())
    build.build(["spec_attention", "ngram_match"])
    shipped = build.load("spec_attention")
    split = build_p_split()

    def use(variant):
        """Route K1 through ``variant``; returns nothing."""
        build._LIBS["spec_attention"] = split if variant == "p_split" \
            else shipped
        dispatch.spec_attention_cuda = spec_attention_cuda
        if variant == "plain":
            dispatch.spec_attention_cuda = (
                lambda *ops, w1, anc=None: spec_attention_plain(*ops, w1=w1))

    W1 = cs.SERVE_W + 1
    S = cs.SERVE_BUCKET + cs.SERVE_NEW + cs.SERVE_W + 2
    cur = [cs.SERVE_BUCKET + (cs.SERVE_NEW - 1) * i // 7 for i in range(8)]
    ops = cs.k1_inputs(8, cs.SERVE_K, W1, 32, 32, 64, S, cur,
                       torch.bfloat16, seed=1)
    want = spec_attention_plain(*ops, w1=W1)
    for variant in ("shipped", "p_split"):
        use(variant)
        _, err = cs.close(spec_attention_cuda(*ops, w1=W1), want, 2e-2)
        print(f"  K1 {variant} vs plain, main verify bf16: max_abs_err="
              f"{err:.4g}")

    cfg = get_config("stablelm-1.6b")
    params = M.init_params(cfg, seed=0, device="cuda")
    prompts = cs.smoke_prompts()
    spec = SpecConfig(k=cs.SERVE_K, w=cs.SERVE_W, strategy="mixed")
    tables = None
    for variant in ("shipped", "p_split", "plain"):
        use(variant)
        eng = ServingEngine(params, cfg, spec, tables=tables,
                            buckets=(cs.SERVE_BUCKET,))
        tables = eng.tables
        done, _ = cs.serve(eng, prompts, cs.SERVE_NEW)
        g_eng = ServingEngine(params, cfg, SpecConfig(strategy="greedy"),
                              buckets=(cs.SERVE_BUCKET,))
        g_done, _ = cs.serve(g_eng, prompts, cs.SERVE_NEW)
        n_new = sum(r.stats["new_tokens"] for r in done)
        calls = [r.stats["model_calls"] for r in done]
        same = [bool(np.array_equal(a.output_ids, b.output_ids))
                for a, b in zip(done, g_done)]
        print(f"  {variant}: tokens/call {n_new / sum(calls):.3f}, steps "
              f"{max(calls)}, calls per request {calls}; mixed == greedy "
              f"per request {same} ({sum(same)} of {len(same)})")
        for a, b in zip(done, g_done):
            if not np.array_equal(a.output_ids, b.output_ids):
                j = int(np.argmax(a.output_ids != b.output_ids))
                ids = np.concatenate([eng.scheduler.pad_to_bucket(
                    eng.tok.encode(a.prompt)), b.output_ids])
                m = cs.top2_margin(params, cfg, ids, cs.SERVE_BUCKET + j - 1)
                print(f"    request {a.request_id}: first difference at new "
                      f"token {j}, bf16 top-2 margin there {m:.4g}")
        del eng, g_eng
    use("shipped")
    return 0


if __name__ == "__main__":
    sys.exit(main())
