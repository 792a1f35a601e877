#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Phases (any failure raises and the script exits non-zero):
  1. build   — compile every kernel in src/repro_torch/kernels/csrc with nvcc
               (sm_90a), one process per source, in parallel, and print
               each kernel instance's -Xptxas -v register, shared-memory
               and spill report;
  2. kernels — hold each CUDA kernel against its plain PyTorch version on the
               card (K1 spec_attention and K3 paged_spec_attention: f32 2e-5,
               bf16 2e-2, including the bf16 tensor-core kernel's edges:
               fragments across heads and drafts, hd 36/80/96/256, cache
               rows aligned below 16 bytes; K3 over a shuffled pool == K1
               over the gathered view, bit for bit) and time kernel, plain
               version and library call (SDPA,
               also at the decode shape) by CUDA events over 20 calls and,
               for kernel and library call, by device time (the same
               calls enqueued while the card spins, so that they run back
               to back); the bf16 verify
               kernel's error at the main verify shape stays within
               K1_SPLIT_ERR (P enters P.V as a bf16 head and remainder);
               K2 (a step's context and mixed drafts in one launch) bit for
               bit against its plain version on the main path's real bytes
               (B=8, L=332), real text at L 4096 and 32768, q 2 and 4, w 16,
               k = the tables' k_max, the bigram tables of every served
               vocabulary (phases 10 and 12's: DeepSeek's 102,400 and
               xLSTM's 50,304 too)
               and adversarial rows (matches everywhere at L 32768, the
               SENTINEL-hashed continuation, buf_len < q+1, fewer than k
               representatives, a bigram fill past the non-duplicates),
               timed at the three real-text shapes beside its bound;
  3. serve   — StableLM-2-1.6B at full width, cut to MAIN_DEPTH (2) of its
               24 layers, bf16, seeded random weights:
               a mixed-strategy ServingEngine builds its n-gram tables and
               serves 8 requests statically (serve_all); the kernels' launch
               counts show the path went through them, K2 once a step;
               a greedy engine
               serves the same requests; a few steps of each run under
               torch.profiler (device-busy share, top kernels);
  4. lossless— the same model in f32 (no TF32): the static mixed engine's
               outputs equal greedy_reference token for token, and so do
               those of continuous serving, paged and linear, over the first
               8 requests of phase 5's mix;
  5. continuous — the bf16 model serves 24 requests (every 5th a long
               prompt) by continuous batching over a 16-page KV pool (40%
               of the linear worst case): paged mixed, linear mixed, paged
               greedy, linear greedy; K3 carries the paged runs, the pool
               defers and leaks no page.
  6. tree    — tree speculation, bf16: the repetitive branching mix of the
               reference's tree benchmark (12 prompts, bucket 128, 48 new
               tokens, 4 slots) served by a (4, 5, 2) tree (69 verify
               inputs), linear mixed (12, 5) (72 inputs) and greedy,
               statically and continuously over the 16-page pool (the tree
               also over the linear cache: paged == linear); K4 carries
               every tree verify.  6b profiles a tree and a linear (12, 5)
               step.  In f32 (TF32 off) the tree's static, continuous
               linear and continuous paged outputs equal greedy_reference.
  7. hybrid  — Jamba-1.5-Large cut to offsets 1-4 of its period without
               experts (HYB_SERVE: 3 Mamba + 1 attention layer at full
               width, dense SwiGLU FFNs, 4.9 B parameters), bf16, seeded
               weights,
               after StableLM is freed: 7a serves phase 3's 8 requests
               statically, mixed and greedy (K5, K1 and K2 launch), then
               with requests 0-3 sampled, twice: the replay is bit-equal
               and the greedy rows equal the mixed run's; 7b
               profiles a mixed and a greedy step (K5's share); 7c serves
               phase 5's 24-request mix continuously (paged mixed, linear
               mixed, paged greedy; K3 on the paged runs; bf16 paged ==
               linear); 7e serves them under DEFAULT_ARMS (static:
               phase 3's 8 requests as 4 batches of 2, one arm a batch;
               continuous paged: phase 5's mix, one arm a slot a step),
               per-arm pulls and tokens/s beside 7a's and 7c's runs, K5
               and K1/K3 launching; 7d, in f32 (TF32 off), 4 requests x
               32 tokens static and continuous paged are greedy decoding:
               equal to greedy_reference, or, at a tie closer than f32
               evaluation can separate (measured in the run), the
               oracle's argmax on their own prefix (``check_lossless``).
  8. sampled — runs after phase 6, while StableLM is loaded (before 7):
               temperature 0.8, top_p 0.95 requests with pinned seeds
               beside greedy ones.  8a: phase 3's 8 requests, 0-3 sampled,
               twice (every row replays bit for bit, rows 4-7 equal phase
               3's, K2 once a step; tokens/call and tokens/s of each
               half); 8b: phase 5's mix continuously over the 16-page
               pool, every other request sampled, twice (no leaked page,
               no rejection, every budget, bit-equal replay, latency
               p50/p99; K3); 8c: the (4, 5, 2) tree on phase 6's mix,
               every other sampled, twice (replay; the greedy rows equal
               phase 6's; K4); 8d: the reference's distribution test
               (V=17, B=512, f32) through K1 and K2 on the card: TV,
               chi-square, a power control and a speculation share
               (``check_distribution``, also the CPU test's); 8e: a
               sampled static step profiled beside the greedy-only mixed
               step, and the sampler's own device ms (noise, shaping and
               sort).
  9. adaptive — in-flight adaptive (k, w) over ``DEFAULT_ARMS``, after
               phase 8 (StableLM loaded, bf16): 9a static serve_all of
               phase 5's mix at max_batch 4 (one arm a batch by the host
               controller; each batch's arm and tokens/call) beside mixed
               (10, 10) and greedy on the same batches; 9b continuous paged
               over the 16-page pool (one arm a slot a step: no leaked
               page, no rejection, every budget; tokens/s, latency,
               ``adaptive_stats()`` beside phase 5's runs; K2 launches
               exactly once per arm depth a step); 9d every other request
               sampled, twice (bit-equal replay); 9e an adaptive step
               profiled beside a mixed one; 9c in f32 (TF32 off, StableLM
               at ADAPTIVE_F32_DEPTH layers): adaptive
               static and continuous paged and linear on the mix's first 8
               requests, and tree arms ((1, 0), (2, 2), (4, 5)) on phase
               6's mix, static and continuous paged (K4), equal
               greedy_reference.  Phase 2e holds each kernel at the
               adaptive step's shapes (K1 and K3 at 25 x 11 inputs, K2 at
               k 25 and w 2, 4, 10, K5 at 200 verify rows from 8 states).
 10. archs  — the registry's other attention-only architectures, after
               phase 7, one model at a time (seeded, bf16, full width,
               cut by depth: Mistral-7B to 4 layers, Gemma-2B to 4,
               GLM-4-9B to 5, Nemotron-4 to 1, Qwen2-VL to 2, StableLM's
               long-context variant to 4), each freed
               after, with its peak memory: 10a Mistral-7B (its 4096-token
               window keeps it outside K1's contract: every verify layer
               runs the plain verify, counted, K1 never; K2 drafts) serves
               phase 3's 8 requests statically, mixed and greedy,
               profiled, and the plain verify's device ms is printed
               beside K1's and SDPA's at its verify shape; 10b two
               ~4,200-byte prompts and 64 new tokens wrap its 4096-slot
               ring in prefill and under speculation, then in f32 at
               depth 1 the outputs are greedy decoding
               (``check_lossless``'s tie rule); 10c-10e Gemma-2B,
               GLM-4-9B, Nemotron-4 and Qwen2-VL (M-RoPE) serve phase 3's
               requests statically (K1 steps x layers times), Gemma and
               GLM phase 5's mix continuously paged (K3), and in f32
               (Nemotron at 1 layer, the others at 2) their static mixed
               outputs are greedy decoding; 10f HuBERT-XLarge's encoder
               (``forward(embeds=)``) in bf16 against f32 on the same
               weights; 10g StableLM's ``long_context_variant`` (an
               8192-slot ring): two 8192-token prompts prefill through the
               blockwise attention (timed), 64 new tokens wrap the ring,
               and at depth 2 in f32 the outputs are greedy decoding.
               Phase 2f holds K1 and K3 at Gemma's (8 / 1 / 256), GLM's
               (32 / 2 / 128), Nemotron's (96 / 8 / 192), Qwen's
               (64 / 8 / 128) and DeepSeek-MoE's (16 / 16 / 128) heads,
               verify and decode, beside their
               bounds and SDPA, with their instance's registers and
               spills.
 11. train  — after phase 10: training on the card, then serving what it
               trained.  11a: the reference's benchmark model
               (``bench_config``: 2 layers, d_model 128, f32) by its own
               recipe (``get_trained``: 120 AdamW steps, lr 1e-3, warmup
               10, ``mixed_batches(8, 128, 120, seed=0)``, remat), its loss
               curve, the first 5 losses held against the same steps on
               the CPU (TRAIN_CPU_TOL), and K1-K5 0 launches while it
               trains; 11b: StableLM-2-1.6B at full width cut to 3 of
               its 24 layers (bf16 params, f32 moments), its seeded
               weights served first (11c's yardstick), then 200 steps on
               the same mixture: ms a step,
               training tokens/s, peak memory, no kernel launch, an npz
               round trip (``train.checkpoint``) bit-equal leaf for leaf;
               11c: each model's tables rebuilt from its trained weights
               by the engine's own build (256 tokens a forward), phase
               3's 8 requests served mixed (10, 10) and greedy (K1 steps
               x layers, K2 once a step), tokens/call and tokens/s beside
               greedy and beside the same model's seeded reading, and in
               f32 the mixed outputs equal ``greedy_reference`` (StableLM's
               trained weights upcast); trained StableLM's mixed run again
               over tables swept at BIGRAM_BATCH tokens a forward (the
               build phases 10 and 12 use); then 11b's step under
               torch.profiler and the AdamW update alone beside its bound;
               11d: ``python -m repro_torch.launch.train`` (StableLM's
               smoke config, 20 steps, ``--save``) and
               ``launch.serve --ckpt --continuous --paged`` as
               subprocesses, both exit 0, every request served, K3
               launches; 11e: the hybrid trains on the card: K5's
               backward (``csrc/mamba_scan_bwd.cu``) against its plain
               version at the training shape (8 x 128, d_inner 16384,
               d_state 16; bf16 and f32 u, a ragged T, 1 x 1024 steps
               with a gradient into the final state, odd shapes; f32
               relative K5_BWD_TOL on every gradient, a second run
               bit-equal), K5's training instance (the checkpoints the
               backward reads) bit-equal to K5's own states, the backward
               timed beside its bound; then
               ``no_experts(with_experts(config(), 2, 3), 1)`` (Mamba and
               attention with SwiGLU FFNs at full width, 2.853 B, bf16
               params and f32 moments, the state donated) trains
               HYB_TRAIN_STEPS steps of the mixture with remat: ms a step,
               peak memory, the loss falling, K5 twice and its backward
               once a Mamba layer a step and no other kernel (asserted),
               and two more steps under torch.profiler (busy share, top
               kernels, K5's backward's share); then in f32 (TF32 off),
               on 1 x 32 tokens of 2 batches with
               the card's AdamW step between, the loss, grad norm and
               every Mamba parameter's gradient equal the CPU's on the
               same weights (TRAIN_CPU_TOL, relative).
 12. moe    — after phase 11: the MoE FFN and the xLSTM mixers, one model
               at a time (seeded, full width, each freed after), phase 3's
               8 requests statically mixed (10, 10) and greedy, with the
               token-slots ``moe_scatter`` drops at the default capacity
               (mean and max a MoE-layer call) and the peak memory: 12a
               DeepSeek-MoE-16B at 7 of its 28 layers (K1 steps x 7),
               the first 8
               requests of phase 5's mix continuously paged (K3), a mixed
               step profiled (the MoE FFN's device ms); 12b Mixtral-8x7B
               cut to 4 of 32 layers with all 8 experts (the window's
               plain verify steps x 8, K1 never), continuous linear; 12c
               Jamba with experts (``with_experts(config(), 5)``: 4 Mamba
               layers, 2 of them with 16-expert MoE FFNs, 1 attention; K5
               4 x (1 + 2 x steps), K1 2 x steps); 12d xLSTM-125M at 4 of
               its 12 layers (12e's too), continuous linear, a mixed step
               profiled (the mLSTM
               and sLSTM loops' device ms; K1/K3/K5 never).  12e in f32
               (TF32 off): DeepSeek at 2 layers and Mixtral at 1 on 8 x 64,
               at the default capacity against ``greedy_reference`` (rows
               equal, first differences, drops: printed, not asserted,
               the reference's capacity fault) and at capacity E / K (no
               drop, every row equal); Jamba with one MoE FFN
               (``with_experts(config(), 3, start=2)``) at E / K, 4 x 32
               greedy decoding up to measured ties; xLSTM-125M's f32
               spread at the reference's init (its sLSTM amplifies
               rounding) and, with sLSTM's r at fan-in dh, 8 x 64 equal to
               ``greedy_reference``.  12f: 5 AdamW steps of deepseek-smoke
               and xlstm-smoke (f32) on the card: loss and aux_loss equal
               the CPU's (TRAIN_CPU_TOL), DeepSeek's aux > 0, no launch.
 13. contract — after phase 12: the contract checker and the examples.
               13a: where phases 3, 7, 10 and 12 hold a model (bf16, full
               width), the checker's level 1 ran on it
               (``contract_check``: ``analysis.runtime_rules.check_case``,
               the step under ``set_sync_debug_mode("error")`` and the
               dispatch-mode detector, an admission and a release; every
               leaf in place, a fixed state signature): StableLM-2-1.6B in
               the reference's six cases, the hybrid, Mistral-7B's ring,
               Qwen2-VL's M-RoPE, DeepSeek-MoE-16B, xLSTM-125M; phase 13
               prints each check's findings (0 asserted) and the kernels
               its checked step launched (``CONTRACT_KERNELS`` asserted).
               13b: the four ``examples/torch_*.py`` at their default
               flags (wall s, tokens/call, K1/K2 launched, K3 by the
               serving example).  13c: ``python -m repro_torch.analysis
               --strict`` (both levels, level 1 on the card) exits 0.
 14. mesh    — after phase 13: ``ServingEngine(mesh=)`` on a (1, 1)
               NCCL mesh (a one-rank process group in this process, torn
               down at the phase's end; one card cannot hold two NCCL
               ranks).  14a: phase 3's StableLM-2-1.6B (MAIN_DEPTH),
               bf16, seeded weights, serves phase 5's first 8 requests
               continuously, paged mixed, beside the same engine without
               a mesh: tokens/s, tokens/call, wall ms a step and peak
               memory of each, the mesh report, K1/K2/K3 0 launches under
               the mesh and plain_verify once a layer a step (asserted);
               a few steps of each profiled (wall against device-busy ms
               a step: the gap is DTensor's dispatch on the card).  14b:
               at 2 layers in f32 (TF32 off), 4 of the requests, greedy
               and mixed, linear and paged: the meshed tokens equal the
               unmeshed engine's and greedy_reference's.
 15. mesh, recurrent — in phase 14's group: 15a Jamba cut to one period
               (7 Mamba + 1 attention layer at full width, no experts,
               9.0 B, bf16; phase 7's until its cut) serves phase
               5's first 8 requests continuously mixed, linear and paged,
               without and with the (1, 1) mesh (the meshed engine from
               host parameters): tokens/s, wall and busy ms a step, device
               ops, the card's bytes after placement against the shards';
               under the mesh the kernels launch as without it (K5 once a
               Mamba layer an admission and twice a step, K1/K3 twice a
               step, K2 once, no plain_verify; asserted) and the bf16
               tokens are equal; 15b in f32 the 2-layer hybrid of 11e and
               xLSTM-125M at one period (4 layers; sLSTM's r at fan-in
               dh), greedy and mixed: meshed == unmeshed ==
               greedy_reference.
Phase 2c holds K4 (the tree's ancestor tail in K1 and K3) against its plain
version over six shapes, K4 over the pool == K4 over the gathered view bit
for bit, and times it at the tree cell's shape.  Phase 2d holds K5 (the
Mamba selective scan) against its plain version at the hybrid's prefill,
verify, decode and replay shapes and odd ones (f32 2e-4), with f32 and
bf16 u and both stagings (cp.async, plain loads), checks that it computes
every token with the same bits whatever the chunking (``k5_invariance``),
times the four shapes beside their bounds, and holds K1 at the hybrid's
attention shape (H=64, KV=8, hd=128).  ``tools/compare_kernels.py`` times
these kernels beside another checkout's.
The last two lines of stdout are the card's name and power limit and
``{"ok": true, "device": {...}}``; the line before them is the kernels'
JSON record: each kernel's ``launches`` on its main path's run (phases 3, 5,
6 and 7a; K5's backward: 11e's training run), under ``launches_adaptive``
its launches on each adaptive run (9a, 9b, 9c's f32 tree runs, 7e), under
``launches_archs`` on each bf16 run of phases 10 and 12, under
``launches_trained`` on each serving run of phase 11c, under
``launches_contract`` in each of 13a's checked steps and each of 13b's
examples and under ``launches_mesh`` in 14a's meshed run (K5: 15a's
meshed paged run), each counted from zero.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12            # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12,    # dense tensor-core bf16
              "float32": 67e12}      # float32 outside the tensor cores
# exp on the special-function units: 16 results per clock per SM (CUDA C++
# Programming Guide, arithmetic instruction throughput, compute capability
# 9.0) x 132 SMs x 1.98 GHz boost clock (H100 SXM data sheet)
SFU_PER_S = 16 * 132 * 1.98e9
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
K5_TOL = 2e-4                        # f32, the reference's kernel tolerance
# the bf16 verify kernel's max abs error against its plain version at the
# main verify shape (phase 2's inputs), with P split into a bf16 head and
# remainder for P.V (with P rounded to one bf16 it read 0.0039 on an H100)
K1_SPLIT_ERR = 2.5e-3
# phase 2e, at the adaptive verify shapes: how much farther from the exact
# f32 result bf16 K1 may lie than its plain version does (the measure of
# k1_rounding_split).  On an H100 the kernel read 3.34e-6 (StableLM's
# heads) and 2.17e-6 (the hybrid's); the control (the plain version with P
# rounded to one bf16 before P.V) must read above the limit, or the check
# could not tell that fault from a sound kernel and the phase fails.
K1_EXCESS_ERR = 3e-5

SERVE_K, SERVE_W, SERVE_NEW, SERVE_BUCKET = 10, 10, 64, 256
# StableLM-2-1.6B on the main path (phases 3-9, 14a) at full width, cut by
# depth to hold the script's time: 2 of its 24 layers (24 until phase 15
# joined the script); its steps are host-bound, so their time falls with
# the layers
MAIN_DEPTH = 2
LOSSLESS_REQUESTS, LOSSLESS_NEW = 4, 32
# phase 5: continuous batching over the paged pool
CONT_N, CONT_SLOTS, CONT_BUCKETS = 24, 8, (64, 256)
CONT_NEW, CONT_PAGE, CONT_PAGES = (16, 32, 48), 64, 16
CONT_LONG_EVERY, CONT_LOSSLESS = 5, 8
# phase 6: tree speculation on the reference tree benchmark's mix
TREE_WDB = (4, 5, 2)             # width, depth, branch: 68 nodes + root
TREE_LINEAR = (12, 5)            # the linear arm of matched cost: 72 inputs
TREE_N, TREE_BUCKET, TREE_NEW, TREE_SLOTS = 12, 128, 48, 4
# phase 7: the hybrid, Jamba cut to offsets 1-4 of its period without
# experts, no_experts(with_experts(config(), 4, 1), 1): 3 Mamba layers and
# the attention layer at full width (the whole period of 8 until phase 15
# joined the script); 15a keeps the whole period (HYB_PERIODS)
HYB_SERVE, HYB_PERIODS = (4, 1), 1
# phase 8: sampled serving; the distribution check's setup and limits are
# the reference's test_spec_sampling_matches_plain_distribution
SAMPLE_T, SAMPLE_P, SAMPLE_SEED = 0.8, 0.95, 1000
DIST_V, DIST_B, DIST_N = 17, 512, 4
DIST_CASES = ((0.9, 1.0), (1.2, 0.8))
# phase 11: training on the card; 11a is the reference's get_trained recipe
# (benchmarks/common.py): bench_config, 120 AdamW steps at lr 1e-3 with 10
# warmup steps over mixed_batches(8, 128, 120, seed=0)
TRAIN_B, TRAIN_T, TRAIN_LR = 8, 128, 1e-3
BENCH_STEPS, BENCH_WARMUP = 120, 10
TRAIN_CHECK_STEPS = 5            # 11a's first steps, run again on the CPU
# f32 losses of the card against the CPU's over those steps (relative):
# the two run the same ops with other reduction orders, ~1e-6 per step
TRAIN_CPU_TOL = 1e-4
LM_TRAIN_STEPS = 200             # 11b: StableLM-2-1.6B at full width,
LM_TRAIN_DEPTH = 3               # cut to 3 of its 24 layers (12 before
#                                  phase 14, 6 before phase 15 joined)
CLI_TRAIN_STEPS = 20             # 11d
# 11e: the hybrid trains on the card: with_experts(config(), 2, 3) made
# dense (Mamba/SwiGLU + attention/SwiGLU at full width, 2.853 B)
HYB_TRAIN, HYB_TRAIN_STEPS = (2, 3), 30
# its f32 steps held against the CPU's, on 1 x 32 of each batch's tokens
# (the CPU's time: a full 8 x 128 step of 2.853 B f32 takes it minutes)
HYB_CHECK_STEPS, HYB_CHECK_ROWS, HYB_CHECK_T = 2, 1, 32
K5_BWD_TOL = 1e-4                # f32 relative, every gradient of K5's
ADAPTIVE_F32_DEPTH = 2           # 9c: StableLM's f32 checks, of 24 layers


def main_config():
    """StableLM-2-1.6B, the main path's model: full width, MAIN_DEPTH of
    its 24 layers, bf16."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("stablelm-1.6b"),
                               num_layers=MAIN_DEPTH)


def hybrid_config(periods: int = 0):
    """Phase 7's hybrid (see HYB_SERVE), or with ``periods`` that many
    whole periods of Jamba's pattern: full width, dense FFNs, bf16."""
    from repro_torch.configs import get_config
    from repro_torch.configs.jamba_1_5_large_398b import (no_experts,
                                                           with_experts)
    cfg = get_config("jamba-1.5-large-398b")
    if periods:
        return no_experts(cfg, periods)
    return no_experts(with_experts(cfg, *HYB_SERVE), 1)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def sync():
    import torch
    torch.cuda.synchronize()


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` in ms, by CUDA events, after warmup."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    sync()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
def k1_inputs(B, K, W1, H, KV, hd, S, cur_len, dtype, seed, s_pad=0,
              d_off=0):
    """Engine-layout K1 operands; caches are a view into a longer buffer
    when ``s_pad`` > 0, so that the kernel's strided cache reads are held
    too, and start ``d_off`` elements into a wider last dim (rows aligned
    below 16 bytes: the bf16 kernel's plain-load copies)."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    rn = lambda *shape: torch.randn(shape, generator=g, device="cuda",
                                    dtype=torch.float32).to(dtype)
    q = rn(B, K, W1, H, hd)
    kc = rn(B, S + s_pad, KV, hd + d_off)[:, :S, :, d_off:]
    vc = rn(B, S + s_pad, KV, hd + d_off)[:, :S, :, d_off:]
    kt, vt = rn(B, K, W1, KV, hd), rn(B, K, W1, KV, hd)
    cl = torch.as_tensor(cur_len, dtype=torch.int32, device="cuda")
    return q, kc, vc, kt, vt, cl


def k1_bound_ms(q, kc, kt, cur_len, W1, tail_keys=None) -> tuple:
    """Least time for K1's work on these inputs: q, the committed cache rows
    (k and v), the tails and the output moved once; 4*hd flops per (query
    row, visible key).  ``tail_keys``: visible tail keys summed over the
    rows of one batch row (default: a causal tail per w1-row; K4 passes
    its ancestor mask's count)."""
    B, K, _, H, hd = q.shape
    S, KV = kc.shape[1], kc.shape[2]
    elt = q.element_size()
    n_keys = cur_len.clamp(0, S).long().cpu()
    kw1 = K * W1
    if tail_keys is None:
        tail_keys = kw1 * (W1 + 1) // 2             # sum over rows of t+1
    bytes_ = (2 * q.numel() * elt + 2 * kt.numel() * elt
              + int(n_keys.sum()) * KV * hd * 2 * elt + 4 * B)
    flops = 4 * hd * H * (kw1 * int(n_keys.sum()) + B * tail_keys)
    peak = PEAK_FLOPS[str(q.dtype).replace("torch.", "")]
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def sdpa_yardstick(q, kc, vc, kt, vt, cur_len, W1, tail=None):
    """One scaled_dot_product_attention call computing K1's function on the
    same inputs (boolean mask over [cache | tail]; ``tail`` a (KW1, KW1)
    bool tail mask in place of the causal one, K4's ancestor mask); timed
    as a yardstick, never called by the port.  Returns (fn, output in
    engine layout)."""
    import torch
    import torch.nn.functional as F
    B, K, _, H, hd = q.shape
    S, KV = kc.shape[1], kc.shape[2]
    kw1 = K * W1
    G = H // KV
    qs = q.reshape(B, kw1, H, hd).transpose(1, 2)
    keys = torch.cat([kc.transpose(1, 2), kt.reshape(B, kw1, KV, hd)
                      .transpose(1, 2)], dim=2).repeat_interleave(G, dim=1)
    vals = torch.cat([vc.transpose(1, 2), vt.reshape(B, kw1, KV, hd)
                      .transpose(1, 2)], dim=2).repeat_interleave(G, dim=1)
    if tail is None:
        i = torch.arange(kw1, device="cuda")
        tail = ((i[:, None] // W1) == (i[None, :] // W1)) \
            & ((i[None, :] % W1) <= (i[:, None] % W1))
    cache = torch.arange(S, device="cuda")[None, :] < cur_len[:, None].long()
    mask = torch.cat([cache[:, None, :].expand(B, kw1, S),
                      tail[None].expand(B, kw1, kw1)], dim=2)[:, None]
    fn = lambda: F.scaled_dot_product_attention(qs, keys, vals,
                                                attn_mask=mask)
    out = fn().transpose(1, 2).reshape(B, K, W1, H, hd)
    return fn, out


def device_ms(fn, iters: int = 20, warmup: int = 3):
    """Mean device time of ``fn()`` in ms, by CUDA events over ``iters``
    calls that the host enqueues while the card spins (~10 ms, doubled
    when the enqueue takes longer), so that the card runs them back to
    back: unlike ``time_ms`` it leaves out the host's time between
    launches, which a small kernel called from Python cannot hide.  (Not
    torch.profiler: its sessions leave the process's host path slower for
    the serving phases after them.)  None if the enqueue outlasted even
    the longest spin."""
    import torch
    for _ in range(warmup):
        fn()
    sync()
    ev = lambda: torch.cuda.Event(enable_timing=True)
    for cycles in (20_000_000, 80_000_000, 320_000_000):
        before, start, end = ev(), ev(), ev()
        before.record()
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        end.record()
        host_ms = (time.perf_counter() - t0) * 1e3
        sync()
        if host_ms < 0.8 * before.elapsed_time(start):
            return start.elapsed_time(end) / iters
    print("  (the host's enqueue outlasted the spin: no device time)")
    return None


def timed(name: str, fn, lib_fn, rec: dict = None) -> dict:
    """Time a kernel and its library yardstick both ways (``time_ms`` and
    ``device_ms``) and print them; returns (and fills) the record."""
    rec = {} if rec is None else rec
    rec.update(ms=time_ms(fn), device_ms=device_ms(fn))
    if lib_fn is not None:
        rec.update(library_ms=time_ms(lib_fn),
                   library_device_ms=device_ms(lib_fn))
    lib = (f"SDPA {rec['library_ms']:.4f} ms (device "
           f"{fmt_ms(rec['library_device_ms'])})" if lib_fn is not None
           else "no library call")
    print(f"  {name}: ms={rec['ms']:.4f} (device "
          f"{fmt_ms(rec['device_ms'])}); {lib}")
    return rec


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f}"


def close(out, want, tol) -> tuple:
    diff = (out.float() - want.float()).abs()
    ok = bool((diff <= tol + tol * want.float().abs()).all())
    return ok, float(diff.max())


def k3_inputs(B, K, W1, H, KV, hd, ps, cur_len, dtype, seed, n_pages=0,
              d_off=0):
    """Engine-layout K3 operands: the pool is one layer's view of a
    2-period (R, NP, ps, KV, hd) pool (starting ``d_off`` elements into a
    wider last dim, as ``k1_inputs``); each row's pages are a shuffled
    draw, -1 past what its cur_len needs."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    rn = lambda *shape: torch.randn(shape, generator=g, device="cuda",
                                    dtype=torch.float32).to(dtype)
    pps = max(1, -(-max(cur_len) // ps))
    NP = max(n_pages, B * pps + 1)
    perm = torch.randperm(NP, generator=g, device="cuda").to(torch.int32)
    pt = perm[:B * pps].reshape(B, pps).clone()
    for b, c in enumerate(cur_len):
        pt[b, -(-c // ps):] = -1
    kp = rn(2, NP, ps, KV, hd + d_off)[1, ..., d_off:]
    vp = rn(2, NP, ps, KV, hd + d_off)[1, ..., d_off:]
    cl = torch.as_tensor(cur_len, dtype=torch.int32, device="cuda")
    return (rn(B, K, W1, H, hd), kp, vp, pt, rn(B, K, W1, KV, hd),
            rn(B, K, W1, KV, hd), cl)


def k3_bound_ms(q, kp, pt, kt, cur_len, W1, tail_keys=None) -> tuple:
    """K1's bound on the committed rows plus the page-table entries those
    rows need (4 bytes each)."""
    ps = kp.shape[1]
    n_pages = int(((cur_len.long() + ps - 1) // ps).sum())
    B, S = pt.shape[0], pt.shape[1] * ps
    lin = kp.new_empty((B, S) + tuple(kp.shape[2:]))   # shape carrier only
    t, by = k1_bound_ms(q, lin, kt, cur_len, W1, tail_keys)
    return t + 4 * n_pages / HBM_BYTES_PER_S * 1e3, by


def phase_k3(cont_cur: list) -> dict:
    """K3 against its plain version and against K1 over the gathered view
    (bit for bit), then its times at the continuous main path's shapes."""
    import torch
    from repro_torch.kernels.ref import gather_pages
    from repro_torch.kernels.spec_attention import (
        paged_spec_attention_cuda, paged_spec_attention_plain,
        spec_attention_cuda)
    cases = [  # name, B, K, W1, H, KV, hd, ps, cur_len
        ("main verify ps=64", 8, SERVE_K, SERVE_W + 1, 32, 32, 64,
         CONT_PAGE, cont_cur),
        ("main decode KW1=1", 8, 1, 1, 32, 32, 64, CONT_PAGE, cont_cur),
        ("GQA ps=16", 4, 4, 5, 32, 8, 128, 16, [700, 0, 333, 65]),
        ("MQA hd=256 ps=128", 2, 3, 4, 32, 1, 256, 128, [299, 130]),
        ("ps=1 w=40 hd=80", 2, 2, 41, 4, 2, 80, 1, [70, 7]),
        ("ps=5 k=25 multi-tile", 2, 25, 11, 8, 2, 96, 5, [1024, 513]),
        ("empty cache ps=64", 2, 25, 11, 8, 4, 64, 64, [0, 0]),
        # the hybrid's decode, verify and replay over the served page size
        ("hybrid decode KW1=1", 8, 1, 1, 64, 8, 128, CONT_PAGE, cont_cur),
        ("hybrid verify KW1=110", 8, SERVE_K, SERVE_W + 1, 64, 8, 128,
         CONT_PAGE, cont_cur),
        ("hybrid replay KW1=11", 8, 1, SERVE_W + 1, 64, 8, 128, CONT_PAGE,
         cont_cur),
        # the bf16 kernel's edges, as phase 2's
        ("frag x heads ps=5", 2, 3, 7, 16, 2, 64, 5, [100, 37]),
        ("frag 6 drafts ps=16", 2, 5, 3, 16, 2, 96, 16, [129, 0]),
        ("frag hd=80 ps=3", 2, 3, 7, 16, 2, 80, 3, [64, 65]),
        ("frag hd=256 ps=64", 2, 3, 7, 16, 2, 256, 64, [99, 33]),
        ("rows unaligned hd=36", 2, 3, 7, 16, 2, 36, 16, [64, 65]),
        ("rows unaligned view+1", 2, 3, 7, 16, 2, 64, 16, [64, 65], 1),
    ]
    err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        for name, B, K, W1, H, KV, hd, ps, cl, *off in cases:
            ops = k3_inputs(B, K, W1, H, KV, hd, ps, cl, dtype,
                            seed=B * 1000 + K * 10 + ps,
                            d_off=off[0] if off else 0)
            out = paged_spec_attention_cuda(*ops, w1=W1)
            want = paged_spec_attention_plain(*ops, w1=W1)
            q, kp, vp, pt, kt, vt, cur = ops
            k_lin, v_lin = gather_pages(kp, vp, pt)
            lin = spec_attention_cuda(q, k_lin, v_lin, kt, vt, cur, w1=W1)
            sync()
            ok, e = close(out, want, TOL[dname])
            same = torch.equal(out, lin)
            err = max(err, e)
            print(f"  K3 {name:20s} {dname:8s} B={B} K={K} W1={W1} H={H} "
                  f"KV={KV} hd={hd} ps={ps} pages/row={pt.shape[1]} "
                  f"cur_len={cl} max_abs_err={e:.3g} tol={TOL[dname]} "
                  f"{'ok' if ok else 'FAIL'} == K1 on gathered view: "
                  f"{'ok' if same else 'FAIL'}")
            if not ok:
                raise AssertionError(f"K3 {name} {dname} disagrees with its "
                                     f"plain version (max err {e})")
            if not same:
                raise AssertionError(f"K3 {name} {dname} differs from K1 "
                                     f"over the gathered linear view")
    W1 = SERVE_W + 1
    ops = k3_inputs(8, SERVE_K, W1, 32, 32, 64, CONT_PAGE, cont_cur,
                    torch.bfloat16, seed=3, n_pages=CONT_PAGES + 1)
    q, kp, vp, pt, kt, vt, cur = ops
    k_lin, v_lin = gather_pages(kp, vp, pt)
    lib_fn, lib_out = sdpa_yardstick(q, k_lin, v_lin, kt, vt, cur, W1)
    ok, e = close(paged_spec_attention_cuda(*ops, w1=W1), lib_out, 2e-2)
    gather_ms = time_ms(lambda: gather_pages(kp, vp, pt))
    k1_lin = lambda: spec_attention_cuda(q, k_lin, v_lin, kt, vt, cur, w1=W1)
    bound, bound_by = k3_bound_ms(q, kp, pt, kt, cur, W1)
    rec = timed("paged_spec_attention",
                lambda: paged_spec_attention_cuda(*ops, w1=W1), lib_fn,
                dict(max_abs_err=err,
                     plain_ms=time_ms(lambda: paged_spec_attention_plain(
                         *ops, w1=W1)),
                     bound_ms=bound, bound_by=bound_by))
    print(f"  K3 vs SDPA yardstick (gathered view): max_abs_err={e:.3g}; "
          f"SDPA ms excludes the gather, gather_pages ms={gather_ms:.4f}; "
          f"K1 on the gathered view ms={time_ms(k1_lin):.4f} (device "
          f"{fmt_ms(device_ms(k1_lin))})")
    dops = k3_inputs(8, 1, 1, 32, 32, 64, CONT_PAGE, cont_cur,
                     torch.bfloat16, seed=4, n_pages=CONT_PAGES + 1)
    d_bound, _ = k3_bound_ms(dops[0], dops[1], dops[3], dops[4], dops[6], 1)
    dk, dv = gather_pages(dops[1], dops[2], dops[3])
    d_lib, d_out = sdpa_yardstick(dops[0], dk, dv, dops[4], dops[5],
                                  dops[6], 1)
    ok, e = close(paged_spec_attention_cuda(*dops, w1=1), d_out, 2e-2)
    d = timed("paged_spec_attention decode",
              lambda: paged_spec_attention_cuda(*dops, w1=1), d_lib)
    print(f"  K3 decode shape (KW1=1): ms={d['ms']:.4f} device_ms="
          f"{fmt_ms(d['device_ms'])} library_ms={d['library_ms']:.4f} "
          f"library_device_ms={fmt_ms(d['library_device_ms'])} plain_ms="
          f"{time_ms(lambda: paged_spec_attention_plain(*dops, w1=1)):.4f}"
          f" bound_ms={d_bound:.5f}; vs SDPA (gathered view) max_abs_err="
          f"{e:.3g}")
    print(f"  paged_spec_attention: ms={rec['ms']:.4f} plain_ms="
          f"{rec['plain_ms']:.4f} library_ms={rec['library_ms']:.4f} "
          f"bound_ms={rec['bound_ms']:.5f} ({rec['bound_by']}) at B=8 "
          f"KW1={SERVE_K * W1} ps={CONT_PAGE} cur_len={cont_cur}")
    return rec


def phase_k4(cont_cur: list) -> dict:
    """K4, the tree's ancestor tail, in both instantiations (the linear
    cache's K1 and the pool's K3) against the plain version with the bool
    ancestor mask; K4 over the pool equals K4 over the gathered view bit
    for bit.  Then its times at the tree cell's shape (bf16)."""
    import torch
    from repro_torch.core.tree import topology
    from repro_torch.kernels.ref import gather_pages
    from repro_torch.kernels.spec_attention import (
        paged_spec_attention_cuda, paged_spec_attention_plain,
        spec_attention_cuda, spec_attention_plain, tree_mask)
    cases = [  # name, (width, depth, branch), B, H, KV, hd, ps, cur_len
        ("main tree (4,5,2)", TREE_WDB, 8, 32, 32, 64, CONT_PAGE, cont_cur),
        ("GQA ps=16", TREE_WDB, 3, 32, 8, 128, 16, [700, 0, 333]),
        ("MQA hd=256 ps=128", (3, 3, 2), 2, 32, 1, 256, 128, [299, 130]),
        ("branch-1 (16,5,1) ps=5", (16, 5, 1), 2, 8, 4, 64, 5, [70, 7]),
        ("depth-1 (6,1,2) hd=80", (6, 1, 2), 2, 4, 2, 80, 8, [33, 1]),
        ("empty cache", TREE_WDB, 2, 8, 4, 64, CONT_PAGE, [0, 0]),
        # 265 inputs: ancestor rows reach back over several key tiles;
        # 16-row fragments crossing heads
        ("(8,5,2) 265 inputs", (8, 5, 2), 2, 16, 2, 64, 16, [90, 0]),
        ("(8,5,2) hd=256", (8, 5, 2), 1, 8, 1, 256, CONT_PAGE, [130]),
        ("frag x heads hd=96", TREE_WDB, 2, 16, 2, 96, 8, [40, 77]),
    ]
    err = {"tree_spec_attention": 0.0, "paged_tree_spec_attention": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        for name, wdb, B, H, KV, hd, ps, cl in cases:
            topo = topology(*wdb)
            W1 = topo.num_nodes + 1
            tm = tree_mask(topo.anc_mask, "cuda")
            ops = k3_inputs(B, 1, W1, H, KV, hd, ps, cl, dtype,
                            seed=B * 1000 + W1 * 10 + ps)
            q, kp, vp, pt, kt, vt, cur = ops
            k_lin, v_lin = gather_pages(kp, vp, pt)
            lin = spec_attention_cuda(q, k_lin, v_lin, kt, vt, cur, w1=W1,
                                      anc=tm.anc)
            pag = paged_spec_attention_cuda(*ops, w1=W1, anc=tm.anc)
            want = spec_attention_plain(q, k_lin, v_lin, kt, vt, cur, w1=W1,
                                        tail_mask=tm.mask)
            want_pg = paged_spec_attention_plain(*ops, w1=W1,
                                                 tail_mask=tm.mask)
            sync()
            ok_l, e_l = close(lin, want, TOL[dname])
            ok_p, e_p = close(pag, want_pg, TOL[dname])
            same = torch.equal(pag, lin)
            err["tree_spec_attention"] = max(err["tree_spec_attention"], e_l)
            err["paged_tree_spec_attention"] = max(
                err["paged_tree_spec_attention"], e_p)
            print(f"  K4 {name:22s} {dname:8s} B={B} W1={W1} H={H} KV={KV} "
                  f"hd={hd} ps={ps} cur_len={cl} linear max_abs_err="
                  f"{e_l:.3g} {'ok' if ok_l else 'FAIL'}, paged max_abs_err="
                  f"{e_p:.3g} {'ok' if ok_p else 'FAIL'} (tol {TOL[dname]});"
                  f" paged == linear: {'ok' if same else 'FAIL'}")
            if not (ok_l and ok_p):
                raise AssertionError(f"K4 {name} {dname} disagrees with its "
                                     f"plain version ({e_l}, {e_p})")
            if not same:
                raise AssertionError(f"K4 {name} {dname}: paged differs "
                                     f"from linear on the gathered view")
    topo = topology(*TREE_WDB)
    W1 = topo.num_nodes + 1
    tm = tree_mask(topo.anc_mask, "cuda")
    ops = k3_inputs(8, 1, W1, 32, 32, 64, CONT_PAGE, cont_cur,
                    torch.bfloat16, seed=5, n_pages=CONT_PAGES + 1)
    q, kp, vp, pt, kt, vt, cur = ops
    k_lin, v_lin = gather_pages(kp, vp, pt)
    lib_fn, lib_out = sdpa_yardstick(q, k_lin, v_lin, kt, vt, cur, W1,
                                     tail=tm.mask)
    ok, e = close(spec_attention_cuda(q, k_lin, v_lin, kt, vt, cur, w1=W1,
                                      anc=tm.anc), lib_out, 2e-2)
    tail_keys = int(tm.mask.sum())
    b_lin, by_lin = k1_bound_ms(q, k_lin, kt, cur, W1, tail_keys)
    b_pag, by_pag = k3_bound_ms(q, kp, pt, kt, cur, W1, tail_keys)
    rec = {"tree_spec_attention": timed(
               "tree_spec_attention", lambda: spec_attention_cuda(
                   q, k_lin, v_lin, kt, vt, cur, w1=W1, anc=tm.anc), lib_fn,
               dict(max_abs_err=err["tree_spec_attention"],
                    plain_ms=time_ms(lambda: spec_attention_plain(
                        q, k_lin, v_lin, kt, vt, cur, w1=W1,
                        tail_mask=tm.mask)),
                    bound_ms=b_lin, bound_by=by_lin)),
           "paged_tree_spec_attention": timed(
               "paged_tree_spec_attention",
               lambda: paged_spec_attention_cuda(*ops, w1=W1, anc=tm.anc),
               lib_fn,
               dict(max_abs_err=err["paged_tree_spec_attention"],
                    plain_ms=time_ms(lambda: paged_spec_attention_plain(
                        *ops, w1=W1, tail_mask=tm.mask)),
                    bound_ms=b_pag, bound_by=by_pag))}
    causal_ms = time_ms(lambda: spec_attention_cuda(q, k_lin, v_lin, kt, vt,
                                                    cur, w1=W1))
    print(f"  K4 vs SDPA yardstick (ancestor mask folded into the boolean "
          f"mask, gathered view): max_abs_err={e:.3g}; K1 with a causal "
          f"tail on the same inputs ms={causal_ms:.4f}; tail keys "
          f"{tail_keys} of {W1 * W1}")
    for name, r in rec.items():
        print(f"  {name}: ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
              f"library_ms={r['library_ms']:.4f} bound_ms="
              f"{r['bound_ms']:.5f} ({r['bound_by']}) at B=8 W1={W1} "
              f"H=KV=32 hd=64 ps={CONT_PAGE} cur_len={cont_cur}")
    return rec


def k5_inputs(Bt, T, di, ds, seed, h0_rep=1, zero_h0=False, dtr=512,
              u_dtype=None):
    """K5 operands with the reference kernel test's distributions, u in
    ``u_dtype`` (default f32); B and C are strided views of one projection
    output of ``dtr`` + 2 ds columns, as in the Mamba layer: Jamba's dt
    rank 512 keeps every row start 16-byte aligned (the kernel's cp.async
    staging), an odd ``dtr`` does not (its plain-load staging)."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    rn = lambda *shape: torch.randn(shape, generator=g, device="cuda")
    u = rn(Bt, T, di).to(u_dtype or torch.float32)
    dt = torch.nn.functional.softplus(rn(Bt, T, di))
    A = -torch.exp(rn(di, ds) * 0.3)
    proj = rn(Bt, T, dtr + 2 * ds)
    h0 = rn(Bt // h0_rep, di, ds)
    if zero_h0:
        h0.zero_()
    return (u, dt, A, proj[..., dtr:dtr + ds], proj[..., dtr + ds:], rn(di),
            h0)


def k5_bound_ms(Bt, T, di, ds, h0_rows, final, u_bytes=4,
                n_commit=False) -> tuple:
    """Least time for K5's work: u (``u_bytes`` an element), dt, B, C, A, D
    and h0 (and n_commit) read once, y (and the final or kept state)
    written once; per (row, step, channel, state) one exp on the
    special-function units and 6 flops (dt*A, the state's FMA, dt*u*B, the
    output's FMA), 3 more per (row, step, channel)."""
    n = Bt * T * di
    bytes_ = (u_bytes * n + 4 * (
        2 * n + 2 * Bt * T * ds + di * ds + di + h0_rows * di * ds
        + (Bt * di * ds if final else 0) + (Bt if n_commit else 0)))
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = max((6 * n * ds + 3 * n) / PEAK_FLOPS["float32"],
                n * ds / SFU_PER_S) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def k5_invariance(di: int, ds: int) -> None:
    """K5 computes a token's state and output with the same bits whatever
    call brought it (the gated replay's commit relies on it): a prefill
    of SERVE_BUCKET steps equals the same tokens fed as chained verify-
    length calls and then decodes through hT -> h0; the replay's kept state
    with n_commit = t equals the final state of a t-step call, and with
    mixed n_commit equals ``select_step_state`` over those final states;
    bf16 u equals its f32 upcast; plain-load staging
    (rows not 16-byte aligned) equals cp.async staging.  torch.equal
    throughout; raises on any difference."""
    import torch
    from repro_torch.kernels.mamba_scan import mamba_scan_cuda as K
    from repro_torch.models.cache import select_step_state
    W1, T = SERVE_W + 1, SERVE_BUCKET
    u, dt, A, B, C, D, h0 = k5_inputs(8, T, di, ds, seed=21,
                                      u_dtype=torch.bfloat16)
    cut = lambda t0, t1: (u[:, t0:t1].contiguous(),
                          dt[:, t0:t1].contiguous(), A, B[:, t0:t1],
                          C[:, t0:t1], D)
    y, hT, _ = K(u, dt, A, B, C, D, h0)
    ys, h, t = [], h0, 0
    for n in [W1] * (T // W1) + [1] * (T % W1):
        y_i, h, _ = K(*cut(t, t + n), h)
        ys.append(y_i)
        t += n
    checks = {f"prefill == {T // W1} calls of {W1} + {T % W1} decodes":
              torch.equal(torch.cat(ys, 1), y) and torch.equal(h, hT)}
    hs, same = [], True  # the final state of a t-step call, t = 1 .. W1
    for t in range(1, W1 + 1):
        hs.append(K(*cut(0, t), h0)[1])
        y_t, kept, _ = K(*cut(0, W1), h0, n_commit=torch.full(
            (8,), t, dtype=torch.int32, device="cuda"))
        same &= torch.equal(kept, hs[-1]) and torch.equal(y_t, y[:, :W1])
    checks["replay's state kept after t steps == a t-step call's final "
           "state"] = same
    n_commit = torch.tensor([0, 1, 3, 5, 7, 9, W1, W1 + 4],
                            dtype=torch.int32, device="cuda")
    y_c, sel, _ = K(*cut(0, W1), h0, n_commit=n_commit)
    checks["in-kernel selection == select_step_state"] = torch.equal(
        sel, select_step_state(torch.stack(hs, 1), h0, n_commit)) \
        and torch.equal(y_c, y[:, :W1])
    y32, h32, _ = K(u.float(), dt, A, B, C, D, h0)
    checks["bf16 u == its f32 upcast"] = (torch.equal(y32, y)
                                          and torch.equal(h32, hT))
    proj = torch.zeros(8, T, 7 + 2 * ds, device="cuda")
    proj[..., 7:7 + ds], proj[..., 7 + ds:] = B, C
    y_p, h_p, _ = K(u, dt, A, proj[..., 7:7 + ds], proj[..., 7 + ds:], D,
                    h0)
    checks["plain-load staging == cp.async staging"] = (
        torch.equal(y_p, y) and torch.equal(h_p, hT))
    sync()
    for name, ok in checks.items():
        print(f"  K5 invariance: {name}: {'ok' if ok else 'FAIL'}")
    if not all(checks.values()):
        raise AssertionError("K5 is not invariant to how its calls chunk "
                             "the tokens")


def phase_k5(S_main: int, cur_main: list) -> dict:
    """K5 against its plain version at the hybrid's shapes and odd ones
    (f32 2e-4), with f32 and bf16 u, in both stagings; its invariance to
    chunking (``k5_invariance``); its times at the four main-path shapes
    (bf16 u, as the bf16 hybrid hands it; the replay keeping the state
    after n_commit) beside their bounds; then K1 at the hybrid's attention
    shape."""
    import torch
    from repro_torch.kernels.mamba_scan import (mamba_scan_cuda,
                                                mamba_scan_plain)
    from repro_torch.kernels.spec_attention import (spec_attention_cuda,
                                                    spec_attention_plain)
    di, ds = 16384, 16                       # Jamba: d_inner, d_state
    rows, W1 = 8 * SERVE_K, SERVE_W + 1
    commit = [0, 1, 3, 5, 7, 9, W1, W1]      # the replay's n_commit
    cases = [  # name, Bt, T, di, ds, h0_rep, final, n_commit, zero h0,
               # dt rank (odd: rows not 16-byte aligned)
        ("prefill", 8, SERVE_BUCKET, di, ds, 1, True, None, True, 512),
        ("verify", rows, W1, di, ds, SERVE_K, False, None, False, 512),
        ("decode", 8, 1, di, ds, 1, True, None, False, 512),
        ("replay", 8, W1, di, ds, 1, True, commit, False, 512),
        ("T=37 di=200 ds=8", 3, 37, 200, 8, 1, True, [37, 20, 0], False, 8),
        ("T=37 ds=8 unaligned", 3, 37, 200, 8, 1, True, [5, 0, 36], False,
         7),
        ("ds=4 di=256 T=20", 2, 20, 256, 4, 1, True, [3, 0], False, 4),
        ("T=1 di=130 ds=2", 4, 1, 130, 2, 2, True, None, False, 7),
        ("T=300 di=1000 ds=16", 2, 300, 1000, 16, 1, True, [150, 0], False,
         7),
        ("T=300 di=1000 aligned", 2, 300, 1000, 16, 1, True, [0, 299],
         False, 8),
        ("ds=12 di=72 T=20", 6, 20, 72, 12, 3, True, None, False, 4),
    ]
    err = 0.0
    for u_dtype in (torch.float32, torch.bfloat16):
        for name, Bt, T, d_, s_, rep, final, nc, zero, dtr in cases:
            ops = k5_inputs(Bt, T, d_, s_, seed=Bt * 100 + T, h0_rep=rep,
                            zero_h0=zero, dtr=dtr, u_dtype=u_dtype)
            kw = dict(h0_rep=rep, final=final, n_commit=None
                      if nc is None else torch.tensor(
                          nc, dtype=torch.int32, device="cuda"))
            got = mamba_scan_cuda(*ops, **kw)
            want = mamba_scan_plain(*ops, **kw)
            sync()
            errs = []
            for a, b in zip(got, want):
                if (a is None) != (b is None):
                    raise AssertionError(f"K5 {name}: outputs differ in "
                                         f"kind")
                if a is not None:
                    ok, e = close(a, b, K5_TOL)
                    errs.append(e)
                    if not ok:
                        raise AssertionError(f"K5 {name} ({u_dtype}) "
                                             f"disagrees with its plain "
                                             f"version (max err {e})")
            err = max([err] + errs)
            print(f"  K5 {name:22s} u {str(u_dtype)[6:]:8s} Bt={Bt} T={T} "
                  f"di={d_} ds={s_} h0_rep={rep} final={final} "
                  f"n_commit={nc} dt_rank={dtr} max_abs_err="
                  f"{max(errs):.3g} tol={K5_TOL} ok")
    k5_invariance(di, ds)
    rec = {}
    shapes = [  # name, Bt, T, h0_rep, final, n_commit
        ("prefill", 8, SERVE_BUCKET, 1, True, None),
        ("verify", rows, W1, SERVE_K, False, None),
        ("replay", 8, W1, 1, True, commit),
        ("decode", 8, 1, 1, True, None)]
    for name, Bt, T, rep, final, nc in shapes:
        ops = k5_inputs(Bt, T, di, ds, seed=7, h0_rep=rep,
                        u_dtype=torch.bfloat16)
        ops32 = (ops[0].float(),) + ops[1:]
        kw = dict(h0_rep=rep, final=final, n_commit=None
                  if nc is None else torch.tensor(nc, dtype=torch.int32,
                                                  device="cuda"))
        run = lambda: mamba_scan_cuda(*ops, **kw)
        bound, by = k5_bound_ms(Bt, T, di, ds, Bt // rep, final,
                                u_bytes=2, n_commit=nc is not None)
        r = dict(max_abs_err=err, ms=time_ms(run), device_ms=device_ms(run),
                 f32_u_device_ms=device_ms(
                     lambda: mamba_scan_cuda(*ops32, **kw)),
                 plain_ms=time_ms(lambda: mamba_scan_plain(*ops, **kw),
                                  iters=5, warmup=1),
                 library_ms=None, bound_ms=bound, bound_by=by)
        print(f"  mamba_scan {name} (Bt={Bt}, T={T}, di={di}, ds={ds}, "
              f"h0_rep={rep}, u bf16): ms={r['ms']:.4f} (device "
              f"{fmt_ms(r['device_ms'])}; f32 u "
              f"{fmt_ms(r['f32_u_device_ms'])}) plain_ms={r['plain_ms']:.3f} bound_ms={bound:.4f} ({by})"
              + (f", {bound / r['device_ms']:.1%} of the bound"
                 if r["device_ms"] else ""))
        rec[name] = r
    # K1 at the hybrid's attention shape (64 heads, 8 KV heads, hd 128)
    W1 = SERVE_W + 1
    k1_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        ops = k1_inputs(8, SERVE_K, W1, 64, 8, 128, S_main, cur_main, dtype,
                        seed=11)
        ok, e = close(spec_attention_cuda(*ops, w1=W1),
                      spec_attention_plain(*ops, w1=W1), TOL[dname])
        k1_err = max(k1_err, e)
        print(f"  K1 hybrid attention {dname:8s} B=8 K={SERVE_K} W1={W1} "
              f"H=64 KV=8 hd=128 S={S_main} max_abs_err={e:.3g} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"K1 at H=64 KV=8 hd=128 {dname} "
                                 f"disagrees with its plain version ({e})")
    lib_fn, _ = sdpa_yardstick(*ops, W1)
    bound, by = k1_bound_ms(ops[0], ops[1], ops[3], ops[5], W1)
    h = timed("spec_attention hybrid",
              lambda: spec_attention_cuda(*ops, w1=W1), lib_fn)
    print(f"  spec_attention at H=64 KV=8 hd=128 (bf16): ms={h['ms']:.4f} "
          f"device_ms={fmt_ms(h['device_ms'])} "
          f"plain_ms={time_ms(lambda: spec_attention_plain(*ops, w1=W1)):.4f}"
          f" library_ms={h['library_ms']:.4f} library_device_ms="
          f"{fmt_ms(h['library_device_ms'])} bound_ms={bound:.5f} ({by})")
    # K1 at the hybrid's decode shape: 8 rows of a (b, kv head), one
    # fragment a warp (the <128, 1> instance)
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        dops = k1_inputs(8, 1, 1, 64, 8, 128, S_main, cur_main, dtype,
                         seed=12)
        ok, e = close(spec_attention_cuda(*dops, w1=1),
                      spec_attention_plain(*dops, w1=1), TOL[dname])
        print(f"  K1 hybrid decode {dname:8s} B=8 KW1=1 H=64 KV=8 hd=128 "
              f"S={S_main} max_abs_err={e:.3g} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"K1 hybrid decode {dname} disagrees with "
                                 f"its plain version ({e})")
    d_bound, d_by = k1_bound_ms(dops[0], dops[1], dops[3], dops[5], 1)
    d_lib, _ = sdpa_yardstick(*dops, 1)
    d = timed("spec_attention hybrid decode",
              lambda: spec_attention_cuda(*dops, w1=1), d_lib)
    print(f"  spec_attention hybrid decode (KW1=1): bound_ms={d_bound:.5f} "
          f"({d_by}); 8 x 8 = 64 blocks, one per (batch row, KV head)")
    return rec


def k1_plain_p_bf16(ops, W1):
    """The control of ``k1_rounding_split``: the plain version with the
    unnormalised softmax weights P rounded to one bf16 before P.V (the
    precision fault that the kernel's head-and-remainder split repairs),
    its output rounded to bf16 as the kernel's is."""
    import torch
    q, kc, vc, kt, vt, cur = (t.float() if t.is_floating_point() else t
                              for t in ops)
    B, K, _, H, hd = q.shape
    S, KV = kc.shape[1], kc.shape[2]
    KW1 = K * W1
    qf = q.reshape(B, KW1, KV, H // KV, hd)
    tail_k, tail_v = (t.reshape(B, KW1, KV, hd) for t in (kt, vt))
    keys = torch.cat([kc, tail_k], 1)                  # (B, S + KW1, KV, hd)
    vals = torch.cat([vc, tail_v], 1)
    logits = torch.einsum("bqngh,bsnh->bngqs", qf, keys) / hd ** 0.5
    i = torch.arange(KW1, device=q.device)
    tail_vis = ((i[:, None] // W1 == i[None, :] // W1)
                & (i[None, :] % W1 <= i[:, None] % W1))
    vis = torch.cat([torch.arange(S, device=q.device)[None, None, :]
                     < cur[:, None, None].expand(B, KW1, S),
                     tail_vis[None].expand(B, KW1, KW1)], 2)
    logits = logits.masked_fill(~vis[:, None, None], float("-inf"))
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    out = torch.einsum("bngqs,bsnh->bqngh", p.bfloat16().float(), vals)
    out = out / p.sum(-1).permute(0, 3, 1, 2)[..., None]
    return out.reshape(B, K, W1, H, hd).to(ops[0].dtype)


def k1_rounding_split(out, want, ops, W1) -> tuple:
    """Split bf16 K1's error against its plain version into the output's
    bf16 rounding and the rest.  Both round an f32 result to bf16, so where
    the exact result (the plain version on the same inputs in f32) lies
    within the kernel's f32 error of a rounding midpoint the two differ by
    one output ulp, whatever the kernel's precision.  Prints the error
    against the plain version, both errors against the exact result and
    the one-ulp flips.  Returns the largest amount by which the kernel lies
    farther from the exact result than the plain version does, for the
    kernel and for the control ``k1_plain_p_bf16`` (P kept to 8 bits)."""
    from repro_torch.kernels.spec_attention import spec_attention_plain
    exact = spec_attention_plain(*(t.float() if t.is_floating_point()
                                   else t for t in ops), w1=W1)
    diff = (out.float() - want.float()).abs()
    d_want = (want.float() - exact).abs()
    beyond = lambda o: float(((o.float() - exact).abs() - d_want).max())
    i = int(diff.argmax())
    at = abs(float(want.reshape(-1)[i]))
    ulp = 2.0 ** (math.floor(math.log2(at)) - 7) if at else 0.0
    excess, control = beyond(out), beyond(k1_plain_p_bf16(ops, W1))
    print(f"    bf16 vs its plain version {float(diff.max()):.4g} "
          f"(K1_SPLIT_ERR {K1_SPLIT_ERR}) at |value| {at:.4g}, where one "
          f"bf16 ulp is {ulp:.4g}; {int((diff > 0).sum())} of {out.numel()}"
          f" outputs differ; vs the exact f32 result: kernel "
          f"{float((out.float() - exact).abs().max()):.4g}, plain version "
          f"{float(d_want.max()):.4g}; beyond the plain version's own "
          f"rounding: kernel {excess:.3g}, control with P in one bf16 "
          f"{control:.3g} (limit K1_EXCESS_ERR {K1_EXCESS_ERR})")
    return excess, control


def phase_adaptive_kernels(S_main: int, cur_main: list,
                           cont_cur: list) -> dict:
    """Phase 2e: each kernel at the shapes the adaptive step gives it.
    Under ``DEFAULT_ARMS`` the masked step verifies every slot at the arm
    table's maxima (k 25, w + 1 = 11: 275 inputs a slot), drafts once per
    distinct arm depth (w 2, 4 and 10 at k 25) and, on the hybrid, scans
    200 verify rows from 8 slot states.  K1 (StableLM's and the hybrid's
    heads) and K3 against their plain versions (f32 2e-5, bf16 2e-2; K3
    bit for bit K1 on the gathered view; bf16 K1 no farther from the exact
    f32 result than its plain version, beyond that version's own output
    rounding, than K1_EXCESS_ERR, which the control with P in one bf16
    must exceed: ``k1_rounding_split`` shows why the error against the
    plain version reaches one output ulp at this shape), K2 bit for bit in both strategies on the main path's
    bytes, K5 at f32 2e-4 with f32 and bf16 u; each timed by events and
    device ms beside its bound and SDPA where there is one."""
    import torch
    from repro_torch.core.controller import DEFAULT_ARMS
    from repro_torch.kernels.dispatch import unique_sweep_widths
    from repro_torch.kernels.mamba_scan import (mamba_scan_cuda,
                                                mamba_scan_plain)
    from repro_torch.kernels.ngram_match import (ngram_draft_cuda,
                                                 ngram_draft_plain)
    from repro_torch.kernels.ref import gather_pages
    from repro_torch.kernels.spec_attention import (
        paged_spec_attention_cuda, paged_spec_attention_plain,
        spec_attention_cuda, spec_attention_plain)
    K = max(a[0] for a in DEFAULT_ARMS)
    W1 = max(a[1] for a in DEFAULT_ARMS) + 1
    rec = {}
    for label, H, KV, hd in (("StableLM", 32, 32, 64),
                             ("hybrid", 64, 8, 128)):
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).replace("torch.", "")
            ops = k1_inputs(8, K, W1, H, KV, hd, S_main, cur_main, dtype,
                            seed=31 + hd)
            out = spec_attention_cuda(*ops, w1=W1)
            want = spec_attention_plain(*ops, w1=W1)
            ok, e = close(out, want, TOL[dname])
            print(f"  K1 adaptive {label:8s} {dname:8s} B=8 K={K} W1={W1} "
                  f"H={H} KV={KV} hd={hd} S={S_main} max_abs_err={e:.4g} "
                  f"tol={TOL[dname]} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"K1 at the adaptive {label} verify "
                                     f"shape ({dname}): max abs err {e}")
        excess, control = k1_rounding_split(out, want, ops, W1)
        if not excess <= K1_EXCESS_ERR < control:
            raise AssertionError(
                f"bf16 K1 at the adaptive {label} verify shape: {excess} "
                f"beyond the plain version's rounding, control {control}; "
                f"the limit {K1_EXCESS_ERR} must lie between them")
        lib_fn, _ = sdpa_yardstick(*ops, W1)
        bound, by = k1_bound_ms(ops[0], ops[1], ops[3], ops[5], W1)
        r = timed(f"K1 adaptive {label} (bf16)",
                  lambda: spec_attention_cuda(*ops, w1=W1), lib_fn,
                  dict(max_abs_err=e, bound_ms=bound, bound_by=by,
                       plain_ms=time_ms(lambda: spec_attention_plain(
                           *ops, w1=W1))))
        print(f"    plain_ms={r['plain_ms']:.4f} bound_ms={bound:.5f} ({by})")
        rec[f"K1 {label}"] = r
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        ops = k3_inputs(8, K, W1, 32, 32, 64, CONT_PAGE, cont_cur, dtype,
                        seed=33, n_pages=CONT_PAGES + 1)
        q, kp, vp, pt, kt, vt, cur = ops
        out = paged_spec_attention_cuda(*ops, w1=W1)
        ok, e = close(out, paged_spec_attention_plain(*ops, w1=W1),
                      TOL[dname])
        k_lin, v_lin = gather_pages(kp, vp, pt)
        same = torch.equal(out, spec_attention_cuda(q, k_lin, v_lin, kt, vt,
                                                    cur, w1=W1))
        print(f"  K3 adaptive StableLM {dname:8s} B=8 K={K} W1={W1} "
              f"ps={CONT_PAGE} cur_len={cont_cur} max_abs_err={e:.4g} "
              f"{'ok' if ok else 'FAIL'} == K1 on gathered view: "
              f"{'ok' if same else 'FAIL'}")
        if not (ok and same):
            raise AssertionError(f"K3 at the adaptive verify shape "
                                 f"({dname}) disagrees")
    bound, by = k3_bound_ms(q, kp, pt, kt, cur, W1)
    lib_fn, _ = sdpa_yardstick(q, k_lin, v_lin, kt, vt, cur, W1)
    r = timed("K3 adaptive StableLM (bf16)",
              lambda: paged_spec_attention_cuda(*ops, w1=W1), lib_fn,
              dict(max_abs_err=e, bound_ms=bound, bound_by=by))
    print(f"    bound_ms={bound:.5f} ({by}); SDPA on the gathered view")
    rec["K3 StableLM"] = r
    # K2: one launch per distinct arm depth, at k = 25
    topk, chain = k2_tables(K2_VOCABS["stablelm"], seed=0)
    buf, cl = k2_text_rows(8, S_main, cur_main)
    last = buf.gather(1, torch.remainder(cl.long() - 1, buf.shape[1])
                      [:, None])[:, 0].contiguous()
    big = dict(last=last, bigram_topk=topk, bigram_chain=chain)
    for w in unique_sweep_widths(DEFAULT_ARMS):
        for strategy, kw in (("context", {}), ("mixed", big)):
            got = ngram_draft_cuda(buf, cl, q=1, k=K, w=w, **kw)
            want = ngram_draft_plain(buf, cl, q=1, k=K, w=w, **kw)
            sync()
            exact = all(torch.equal(a, b) for a, b in zip(got, want))
            print(f"  K2 adaptive k={K} w={w:2d} {strategy:7s} B=8 "
                  f"L={S_main} n_ctx={got[2].tolist()} bit-exact="
                  f"{'ok' if exact else 'FAIL'}")
            if not exact:
                raise AssertionError(f"K2 at k={K} w={w} {strategy} "
                                     f"differs from its plain version")
        run = lambda: ngram_draft_cuda(buf, cl, q=1, k=K, w=w, **big)
        bound, by, M = k2_bound_ms(buf, cl, 1, K, w, mixed=True)
        r = dict(max_abs_err=0.0, ms=time_ms(run), device_ms=device_ms(run),
                 plain_ms=time_ms(lambda: ngram_draft_plain(
                     buf, cl, q=1, k=K, w=w, **big)),
                 library_ms=None, bound_ms=bound, bound_by=by)
        print(f"  K2 adaptive mixed k={K} w={w}: ms={r['ms']:.4f} device_ms="
              f"{fmt_ms(r['device_ms'])} plain_ms={r['plain_ms']:.4f} "
              f"bound_ms={bound:.7f} ({by}; {M} matched positions)")
        rec[f"K2 w={w}"] = r
    # K5: the hybrid's adaptive verify, 8 slots x 25 rows from 8 states
    di, ds, Bt = 16384, 16, 8 * K
    for u_dtype in (torch.float32, torch.bfloat16):
        ops = k5_inputs(Bt, W1, di, ds, seed=35, h0_rep=K, u_dtype=u_dtype)
        kw = dict(h0_rep=K, final=False)
        errs = [close(a, b, K5_TOL) for a, b in zip(
            mamba_scan_cuda(*ops, **kw)[:1], mamba_scan_plain(*ops, **kw)[:1])]
        ok, e = errs[0]
        print(f"  K5 adaptive verify u {str(u_dtype)[6:]:8s} Bt={Bt} T={W1} "
              f"di={di} ds={ds} h0_rep={K} max_abs_err={e:.3g} tol={K5_TOL}"
              f" {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"K5 at the adaptive verify shape "
                                 f"disagrees with its plain version ({e})")
    run = lambda: mamba_scan_cuda(*ops, **kw)
    bound, by = k5_bound_ms(Bt, W1, di, ds, Bt // K, False, u_bytes=2)
    r = dict(max_abs_err=e, ms=time_ms(run), device_ms=device_ms(run),
             plain_ms=time_ms(lambda: mamba_scan_plain(*ops, **kw), iters=5,
                              warmup=1),
             library_ms=None, bound_ms=bound, bound_by=by)
    print(f"  mamba_scan adaptive verify (u bf16): ms={r['ms']:.4f} (device "
          f"{fmt_ms(r['device_ms'])}) plain_ms={r['plain_ms']:.3f} "
          f"bound_ms={bound:.4f} ({by})"
          + (f", {bound / r['device_ms']:.1%} of the bound"
             if r["device_ms"] else ""))
    rec["K5 verify"] = r
    return rec


def phase_kernels(S_main: int, cur_main: list) -> dict:
    import torch
    from repro_torch.kernels.spec_attention import (spec_attention_cuda,
                                                    spec_attention_plain)
    rec = {}
    # ---- K1 ----
    cases = [  # name, B, K, W1, H, KV, hd, S, cur_len, s_pad
        ("main verify", 8, SERVE_K, SERVE_W + 1, 32, 32, 64, S_main,
         cur_main, 0),
        ("main decode", 8, 1, 1, 32, 32, 64, S_main, cur_main, 0),
        ("S=2048 ragged", 8, SERVE_K, SERVE_W + 1, 32, 32, 64, 2048,
         [2000, 1, 777, 1500, 64, 1999, 0, 1024], 0),
        ("GQA strided cache", 4, 4, 5, 32, 8, 128, 700,
         [700, 0, 333, 65], 37),
        ("MQA hd=256", 2, 3, 4, 32, 1, 256, 300, [299, 130], 0),
        ("k=25 empty cache", 2, 25, 11, 8, 4, 64, 512, [0, 0], 0),
        ("k=25 multi-tile", 2, 25, 11, 8, 2, 96, 1024, [1024, 513], 0),
        ("w=40 hd=80 cur>S", 2, 2, 41, 4, 2, 80, 200, [205, 7], 0),
        # the bf16 kernel's edges: 16-row fragments crossing a head and
        # spanning 3 (W1 7) or 6 (W1 3) drafts, hd 80/96/256, cache rows
        # not 16-byte aligned (hd 36, an offset view); one fragment a warp
        # at hd 128 (the hybrid's decode, and 40 rows over 3 warps), the
        # hybrid's replay of the winning row
        ("hybrid decode KW1=1", 8, 1, 1, 64, 8, 128, S_main, cur_main, 0),
        ("hybrid replay KW1=11", 8, 1, SERVE_W + 1, 64, 8, 128, S_main,
         cur_main, 0),
        ("1 frag hd=128 G=4", 2, 2, 5, 16, 4, 128, 300, [299, 64], 0),
        ("frag x heads W1=7", 2, 3, 7, 16, 2, 64, 150, [100, 37], 0),
        ("frag 6 drafts hd=96", 2, 5, 3, 16, 2, 96, 130, [129, 0], 0),
        ("frag hd=80 edge 64", 2, 3, 7, 16, 2, 80, 90, [64, 65], 0),
        ("frag hd=256", 2, 3, 7, 16, 2, 256, 100, [99, 33], 0),
        ("rows unaligned hd=36", 2, 3, 7, 16, 2, 36, 90, [64, 65], 0),
        ("rows unaligned view+1", 2, 3, 7, 16, 2, 64, 90, [64, 65], 0, 1),
    ]
    k1_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        for name, B, K, W1, H, KV, hd, S, cl, pad, *off in cases:
            ops = k1_inputs(B, K, W1, H, KV, hd, S, cl, dtype,
                            seed=B * 1000 + K * 10 + hd, s_pad=pad,
                            d_off=off[0] if off else 0)
            out = spec_attention_cuda(*ops, w1=W1)
            want = spec_attention_plain(*ops, w1=W1)
            sync()
            ok, err = close(out, want, TOL[dname])
            k1_err = max(k1_err, err)
            print(f"  K1 {name:20s} {dname:8s} B={B} K={K} W1={W1} H={H} "
                  f"KV={KV} hd={hd} S={S} cur_len={cl} max_abs_err={err:.3g}"
                  f" tol={TOL[dname]} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"K1 {name} {dname} disagrees with its "
                                     f"plain version (max err {err})")
    # timing at the main path's shapes (bf16 verify, as served)
    ops = k1_inputs(8, SERVE_K, SERVE_W + 1, 32, 32, 64, S_main, cur_main,
                    torch.bfloat16, seed=1)
    W1 = SERVE_W + 1
    lib_fn, lib_out = sdpa_yardstick(*ops, W1)
    out = spec_attention_cuda(*ops, w1=W1)
    ok, err = close(out, lib_out, 2e-2)
    _, split_err = close(out, spec_attention_plain(*ops, w1=W1), 2e-2)
    print(f"  K1 vs SDPA yardstick: max_abs_err={err:.3g}; vs its plain "
          f"version {split_err:.4g} (P split into a bf16 head and "
          f"remainder; bound {K1_SPLIT_ERR})")
    if split_err > K1_SPLIT_ERR:
        raise AssertionError(f"bf16 K1 at the main verify shape: max abs "
                             f"err {split_err} > {K1_SPLIT_ERR}")
    bound, bound_by = k1_bound_ms(ops[0], ops[1], ops[3], ops[5], W1)
    rec["spec_attention"] = timed(
        "spec_attention", lambda: spec_attention_cuda(*ops, w1=W1),
        lib_fn,
        dict(max_abs_err=k1_err,
             plain_ms=time_ms(lambda: spec_attention_plain(*ops, w1=W1)),
             bound_ms=bound, bound_by=bound_by))
    dops = k1_inputs(8, 1, 1, 32, 32, 64, S_main, cur_main, torch.bfloat16,
                     seed=2)
    d_bound, _ = k1_bound_ms(dops[0], dops[1], dops[3], dops[5], 1)
    d_lib, d_out = sdpa_yardstick(*dops, 1)
    ok, err = close(spec_attention_cuda(*dops, w1=1), d_out, 2e-2)
    d = timed("spec_attention decode",
              lambda: spec_attention_cuda(*dops, w1=1), d_lib)
    print(f"  K1 decode shape (KW1=1): ms={d['ms']:.4f} device_ms="
          f"{fmt_ms(d['device_ms'])} library_ms={d['library_ms']:.4f} "
          f"library_device_ms={fmt_ms(d['library_device_ms'])} plain_ms="
          f"{time_ms(lambda: spec_attention_plain(*dops, w1=1)):.4f}"
          f" bound_ms={d_bound:.5f}; vs SDPA max_abs_err={err:.3g}")
    rec["ngram_match"] = phase_k2(S_main, cur_main)
    for name, r in rec.items():
        print(f"  {name}: ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
              f"library_ms={r['library_ms']} bound_ms={r['bound_ms']:.5f} "
              f"({r['bound_by']})")
    return rec


# ---------------------------------------------------------------------------
# phase 2: K2, a step's context-strategy drafts in one launch
# ---------------------------------------------------------------------------
SENTINEL_TOKEN = 1097884494     # 0x4170634E: its w=1 hash is 0xFFFFFFFF
K2_VOCABS = {"stablelm": 100352, "jamba": 65536, "mistral/mixtral": 32000,
             "glm": 151552, "qwen": 152064, "gemma/nemotron": 256000,
             "deepseek": 102400, "xlstm": 50304}
K2_TABLES = (25, 16)            # the engine's (k_max, w_max) at k=w=10


def k2_tables(V: int, seed: int):
    """Seeded bigram tables of the engine's shape for a vocabulary of V."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    k_max, w_max = K2_TABLES
    topk = torch.randint(0, V, (V, k_max), generator=g, device="cuda",
                         dtype=torch.int32)
    chain = torch.randint(0, V, (V, w_max), generator=g, device="cuda",
                          dtype=torch.int32)
    return topk, chain


def k2_text_rows(B: int, L: int, cur: list):
    """(buf (B, L), buf_len) of real bytes: row b holds the smoke prompt b's
    bucketed tokens (phase 3's prefill) followed by its text repeated, up to
    cur[b]; zeros after it, as the engine's unwritten tail."""
    import numpy as np
    import torch
    from repro_torch.data.tokenizer import ByteTokenizer
    from repro_torch.serving.scheduler import Scheduler
    tok = ByteTokenizer()
    sched = Scheduler(buckets=(SERVE_BUCKET,))
    prompts = smoke_prompts()
    buf = np.zeros((B, L), np.int32)
    for b in range(B):
        p = prompts[b % len(prompts)]
        head = sched.pad_to_bucket(tok.encode(p))
        body = tok.encode(p, bos=False)
        n = max(0, L - len(head))
        row = np.concatenate([head, np.resize(np.asarray(body, np.int32), n)])
        buf[b, :cur[b]] = row[:cur[b]]
    return (torch.as_tensor(buf, device="cuda"),
            torch.as_tensor(cur, dtype=torch.int32, device="cuda"))


def k2_adversarial(tables):
    """(name, buf, buf_len, q, k, w, tables) rows that stress the contract:
    matches everywhere (M = L - q - w + 1) at L = 32768, the continuation
    whose hash is the no-match SENTINEL, rows too short to query, fewer
    representatives than rows (all over ``tables``), and a bigram fill that
    runs past the non-duplicates (over tables whose candidates repeat)."""
    import torch
    dev = "cuda"
    i32 = dict(dtype=torch.int32, device=dev)
    out = []
    L = 32768
    buf = torch.full((2, L), 5, **i32)
    buf[1, 1::2] = 6
    out.append(("M=L one token L=32768", buf,
                torch.tensor([L, L - 3], **i32), 1, 10, 10, tables))
    g = torch.Generator(device=dev).manual_seed(17)
    L = 4099
    buf = torch.randint(0, 4, (3, L), generator=g, **i32)
    buf[:, 100:4000:6] = 7
    buf[:, 101:4000:12] = SENTINEL_TOKEN
    buf[:, 4000] = 7
    out.append(("SENTINEL hash w=1", buf, torch.tensor([4001, 4001, 333],
                                                       **i32), 1, 10, 1,
                tables))
    buf = torch.randint(0, 3, (4, 300), generator=g, **i32)
    out.append(("buf_len < q+1", buf, torch.tensor([0, 1, 2, 3], **i32), 2,
                10, 10, tables))
    buf = torch.tensor([1, 2, 3, 1, 4, 4] * 60, **i32)[None].repeat(2, 1)
    out.append(("fewer than k reps", buf, torch.tensor([360, 97], **i32), 1,
                25, 2, tables))
    topk = torch.tensor([[2, 2, 2, 3, 4, 5]] * 12, **i32)
    chain = torch.arange(6, **i32)[None].repeat(12, 1) + 4
    chain[2] = torch.tensor([4, 5, 6, 7, 8, 9], **i32)
    buf = torch.zeros((2, 30), **i32)
    buf[:, 5:9] = torch.tensor([1, 2, 4, 5], **i32)
    buf[:, 20] = 1
    buf[1, 12:16] = torch.tensor([1, 3, 8, 9], **i32)
    out.append(("dup tail", buf, torch.tensor([21, 21], **i32), 1, 4, 3,
                (topk, chain)))
    return out


def k2_bound_ms(buf, buf_len, q, k, w, mixed: bool) -> tuple:
    """Least time for K2's work on these inputs: each row read up to its
    buf_len, the lengths (and last tokens, the bigram rows the fill reads)
    once, the outputs written once; operations: q compares a candidate
    position, 4 integer ops a hash step of each match, k*k*w compares of the
    mixed dedup, at the float32 lane rate (a 32-bit integer op takes a lane
    as a float op does)."""
    from repro_torch.kernels.ngram_match import (_extract_queries,
                                                 ngram_match_plain)
    B, L = buf.shape
    cur = buf_len.clamp(0, L).long()
    query = _extract_queries(buf, buf_len, q).contiguous()
    M = int(ngram_match_plain(buf, query, buf_len, w=w)[0].sum())
    n_pos = int((buf_len.long() - q - w + 1).clamp(0, L).sum())
    bytes_ = 4 * int(cur.sum()) + 4 * B + 4 * B * k * w + B * k + 4 * B
    ops = n_pos * q + 4 * w * M
    if mixed:
        bytes_ += 4 * B + 4 * B * k * w
        ops += B * k * k * w
    t_b = bytes_ / HBM_BYTES_PER_S * 1e3
    t_o = ops / PEAK_FLOPS["float32"] * 1e3
    return max(t_b, t_o), ("bytes" if t_b >= t_o else "operations"), M


def phase_k2(S_main: int, cur_main: list) -> dict:
    """K2 against its plain version, bit for bit, in both strategies over
    the main path's rows, long rows, q, w, k, the main shape over the
    bigram tables of every served vocabulary (phases 10 and 12's) and the
    adversarial rows; then its times at the three real-text shapes beside
    its bound, its plain version and one launch's floor."""
    import torch
    from repro_torch.kernels.ngram_match import (ngram_draft_cuda,
                                                 ngram_draft_plain)
    tables = {n: k2_tables(V, seed=i) for i, (n, V) in
              enumerate(K2_VOCABS.items())}
    st = tables["stablelm"]
    cases = [  # name, buf, buf_len, q, k, w, tables or None
        ("main B=8 L=332", *k2_text_rows(8, S_main, cur_main), 1, SERVE_K,
         SERVE_W, st),
        ("B=4 L=4096", *k2_text_rows(4, 4096, [4096, 4000, 2500, 300]), 1,
         SERVE_K, SERVE_W, st),
        ("B=2 L=32768", *k2_text_rows(2, 32768, [32768, 20001]), 1, SERVE_K,
         SERVE_W, st),
        ("q=2 w=5 L=4097", *k2_text_rows(3, 4097, [4097, 1000, 3]), 2, 8, 5,
         st),
        ("q=4 w=16 L=1000", *k2_text_rows(3, 1000, [1000, 999, 517]), 4,
         SERVE_K, 16, tables["jamba"]),
        ("k=k_max L=332", *k2_text_rows(8, S_main, cur_main), 1,
         K2_TABLES[0], SERVE_W, st),
    ] + [(f"{n} vocab L=332", *k2_text_rows(8, S_main, cur_main), 1,
          SERVE_K, SERVE_W, tables[n]) for n in K2_VOCABS if n != "stablelm"
         ] + k2_adversarial(st)
    for name, buf, cl, q, k, w, tab in cases:
        last = buf.gather(1, torch.remainder(cl.long() - 1, buf.shape[1])
                          [:, None])[:, 0].contiguous()
        big = dict(last=last, bigram_topk=tab[0], bigram_chain=tab[1])
        for strategy, kw in (("context", {}), ("mixed", big)):
            got = ngram_draft_cuda(buf, cl, q=q, k=k, w=w, **kw)
            want = ngram_draft_plain(buf, cl, q=q, k=k, w=w, **kw)
            sync()
            exact = all(torch.equal(a, b) for a, b in zip(got, want))
            print(f"  K2 {name:22s} {strategy:7s} B={buf.shape[0]} "
                  f"L={buf.shape[1]} q={q} k={k} w={w} n_ctx="
                  f"{got[2].tolist()} bit-exact={'ok' if exact else 'FAIL'}")
            if not exact:
                raise AssertionError(f"K2 {name} {strategy} differs from "
                                     f"its plain version")
    one = torch.zeros(1, device="cuda")
    floor = device_ms(lambda: one.zero_())
    print(f"  one launch's floor (a 1-element fill, device ms): "
          f"{fmt_ms(floor)}")
    rec = None
    for name, buf, cl, q, k, w, tab in cases[:3]:
        last = buf.gather(1, torch.remainder(cl.long() - 1, buf.shape[1])
                          [:, None])[:, 0].contiguous()
        kw = dict(q=q, k=k, w=w, last=last, bigram_topk=tab[0],
                  bigram_chain=tab[1])
        bound, bound_by, M = k2_bound_ms(buf, cl, q, k, w, mixed=True)
        r = dict(max_abs_err=0.0,
                 ms=time_ms(lambda: ngram_draft_cuda(buf, cl, **kw)),
                 device_ms=device_ms(lambda: ngram_draft_cuda(buf, cl, **kw)),
                 plain_ms=time_ms(lambda: ngram_draft_plain(buf, cl, **kw)),
                 library_ms=None, bound_ms=bound, bound_by=bound_by)
        print(f"  K2 mixed {name}: ms={r['ms']:.4f} device_ms="
              f"{fmt_ms(r['device_ms'])} plain_ms={r['plain_ms']:.4f} "
              f"bound_ms={bound:.7f} ({bound_by}; {M} matched positions, "
              f"{'below' if floor and bound < floor else 'above'} one "
              f"launch's floor)")
        rec = rec or r
    return rec


# ---------------------------------------------------------------------------
# phases 3 and 4: serving
# ---------------------------------------------------------------------------
def smoke_prompts():
    from repro_torch.data.datasets import make_prompts
    return ([p for p, _ in make_prompts("code", 3)]
            + [p for p, _ in make_prompts("math", 3)]
            + [p for p, _ in make_prompts("chat", 2)])


def serve(engine, prompts, max_new):
    for p in prompts:
        engine.submit(p, max_new_tokens=max_new)
    sync()
    t0 = time.perf_counter()
    done = engine.serve_all()
    sync()
    done.sort(key=lambda r: r.request_id)
    return done, time.perf_counter() - t0


def top2_margin(params, cfg, ids, pos) -> float:
    """top-1 minus top-2 logit of the next-token prediction at ``pos``."""
    import torch
    from repro_torch.models import model as M
    toks = torch.as_tensor(ids[None, :pos + 1], dtype=torch.int32,
                           device="cuda")
    logits = M.forward(params, cfg, tokens=toks)[0][0, -1]
    top = torch.topk(logits, 2).values
    return float(top[0] - top[1])


def check_equals_greedy(params32, cfg32, done, ref, bucket: int) -> None:
    """Phase 4's strict check: each request's f32 output equals its row of
    ``greedy_reference`` (``ref``, prompts padded to ``bucket``) token for
    token; a difference prints the oracle's top-2 margin there and fails."""
    import numpy as np
    for i, r in enumerate(done):
        want = ref[i, bucket:]
        if not np.array_equal(r.output_ids, want):
            j = int(np.argmax(r.output_ids != want))
            m = top2_margin(params32, cfg32, ref[i], bucket + j - 1)
            print(f"  request {r.request_id}: mixed != greedy_reference at "
                  f"new token {j} (f32 top-2 margin {m:.4g})")
            raise AssertionError("f32 speculative output is not lossless")


def profile_steps(params, cfg, spec, tables, prompts, steps: int = 4,
                  bucket: int = SERVE_BUCKET, label: str = "",
                  focus: str = "", ranges: tuple = (), **state_kw):
    """Where a static step's time goes: spec_steps of a fresh batch of the
    served prompts under torch.profiler (``profile_window``).
    ``state_kw``: the sampling controls of ``init_decode_state``."""
    import numpy as np
    import torch
    from repro_torch.core.spec_engine import init_decode_state, spec_step
    from repro_torch.data.tokenizer import ByteTokenizer
    from repro_torch.serving.scheduler import Scheduler
    sched = Scheduler(buckets=(bucket,))
    toks = torch.as_tensor(np.stack([sched.pad_to_bucket(
        ByteTokenizer().encode(p)) for p in prompts]), device="cuda")
    box = [init_decode_state(params, cfg, spec, toks, **state_kw)]

    def one_step():
        box[0] = spec_step(params, cfg, spec, box[0], tables)
    return profile_window(label or f"{spec.strategy} step", one_step, steps,
                          focus, ranges)


def profile_window(label: str, one_step, steps: int = 4, focus: str = "",
                   ranges: tuple = (), warm: int = 2):
    """``steps`` calls of ``one_step`` under torch.profiler after ``warm``
    warm ones: wall ms per step, the device-busy share (kernel time / wall),
    device ops per step and the kernels with the most device time; with
    ``focus``, also the device ms per step of the kernels whose name holds
    it; for each name in ``ranges`` (a ``named_ranges`` range), the device
    ms per step of the kernels launched inside it.  Returns those
    numbers."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warm):
        one_step()
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            one_step()
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    events = prof.key_averages()
    # a named range also shows as a device-side annotation span: not a
    # kernel, so it stays out of the busy time
    kernels = [e for e in events if str(e.device_type).endswith("CUDA")
               and e.key not in ranges]
    dev = lambda e: getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0.0))
    inside = lambda e: getattr(e, "device_time_total",
                               getattr(e, "cuda_time_total", 0.0))
    range_ms = {name: sum(inside(e) for e in events if e.key == name and
                          not str(e.device_type).endswith("CUDA"))
                / 1e3 / steps for name in ranges}
    busy_ms = sum(dev(e) for e in kernels) / 1e3 / steps
    n_launch = sum(e.count for e in kernels) / steps
    focus_ms = (sum(dev(e) for e in kernels if focus in e.key) / 1e3 / steps
                if focus else None)
    print(f"  {label}: {wall_ms:.2f} ms wall, {busy_ms:.2f} ms device busy "
          f"({busy_ms / max(wall_ms, 1e-9):.1%}), {n_launch:.0f} device ops "
          f"per step" + (f", {focus} {focus_ms:.3f} ms per step"
                         if focus else "")
          + "".join(f", {n} {ms:.3f} device ms per step"
                    for n, ms in range_ms.items()))
    # the kinds of kernel the eager drafter launched before K2 took it in;
    # torch.gather runs the scatter-gather kernel too, and any left come
    # from elsewhere in the step (acceptance's cumprod, the commit, the
    # stats histograms, whose index_put with accumulate sorts)
    eager = [e for e in kernels if re.search(
        "sort|topk|scatter|cumsum|tensor_kernel_scan", e.key, re.I)]
    print(f"    sort/topk/scatter-gather/scan kernels per step: "
          f"{sum(e.count for e in eager) / steps:.0f}"
          + "".join(f"; x{e.count / steps:.0f} {e.key[:60]}" for e in eager))
    for e in sorted(kernels, key=dev, reverse=True)[:6]:
        print(f"    {dev(e) / 1e3 / steps:8.3f} ms/step  x{e.count // steps:4d}"
              f"  {e.key[:90]}")
    return dict(wall_ms=wall_ms, busy_ms=busy_ms, ops=n_launch,
                focus_ms=focus_ms, range_ms=range_ms)


def phase_serve() -> dict:
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.spec_engine import SpecConfig, greedy_reference
    from repro_torch.kernels.ngram_match import ngram_draft_cuda
    from repro_torch.kernels.spec_attention import spec_attention_cuda
    from repro_torch.models import model as M
    from repro_torch.serving.engine import ServingEngine

    cfg = main_config()
    t0 = time.perf_counter()
    params = M.init_params(cfg, seed=0, device="cuda")
    sync()
    print(f"  {cfg.name}: {cfg.param_count() / 1e9:.3f}B params, "
          f"{cfg.num_layers} layers, d_model {cfg.d_model}, vocab "
          f"{cfg.vocab_size}, bf16, seeded init {time.perf_counter() - t0:.1f}"
          f" s")
    spec = SpecConfig(k=SERVE_K, w=SERVE_W, strategy="mixed")
    t0 = time.perf_counter()
    eng = ServingEngine(params, cfg, spec, buckets=(SERVE_BUCKET,))
    sync()
    print(f"  n-gram tables (bigram sweep over {cfg.vocab_size} tokens): "
          f"{time.perf_counter() - t0:.2f} s")
    prompts = smoke_prompts()
    # the main path: counts from zero just before it, read just after
    spec_attention_cuda.launches = 0
    ngram_draft_cuda.launches = 0
    torch.cuda.reset_peak_memory_stats()
    done, wall = serve(eng, prompts, SERVE_NEW)
    launches = {"spec_attention": spec_attention_cuda.launches,
                "ngram_match": ngram_draft_cuda.launches}
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_new = sum(r.stats["new_tokens"] for r in done)
    calls = sum(r.stats["model_calls"] for r in done)
    for r in done:
        print(f"  request {r.request_id}: {r.stats['new_tokens']} new tokens,"
              f" {r.stats['model_calls']} calls, tokens/call "
              f"{r.stats['tokens_per_call']:.3f}")
    print(f"  mixed: {n_new} new tokens in {wall:.3f} s = "
          f"{n_new / wall:.1f} tokens/s, tokens/call "
          f"{n_new / max(calls, 1):.3f}, peak memory {peak:.2f} GiB")
    print(f"  launches on the main path: {launches}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the main path never launched: "
                             f"{launches}")
    steps = launches["spec_attention"] // cfg.num_layers
    print(f"  K2 launches per mixed step: {launches['ngram_match']} in "
          f"{steps} steps")
    if launches["ngram_match"] != steps:
        raise AssertionError("a mixed step did not draft in exactly one K2 "
                             "launch")
    if any(r.stats["new_tokens"] != SERVE_NEW for r in done):
        raise AssertionError("a request did not reach its token budget")
    g_eng = ServingEngine(params, cfg, SpecConfig(strategy="greedy"),
                          buckets=(SERVE_BUCKET,))
    g_done, g_wall = serve(g_eng, prompts, SERVE_NEW)
    g_new = sum(r.stats["new_tokens"] for r in g_done)
    print(f"  greedy: {g_new} new tokens in {g_wall:.3f} s = "
          f"{g_new / g_wall:.1f} tokens/s")
    same = [np.array_equal(a.output_ids, b.output_ids)
            for a, b in zip(done, g_done)]
    print(f"  bf16 mixed == bf16 greedy per request: {same}")
    print("phase 3b: where a step's time goes (torch.profiler)")
    profile_steps(params, cfg, spec, eng.tables, prompts)
    profile_steps(params, cfg, SpecConfig(strategy="greedy"), None, prompts)
    for a, b in zip(done, g_done):
        if not np.array_equal(a.output_ids, b.output_ids):
            j = int(np.argmax(a.output_ids != b.output_ids))
            ids = np.concatenate([eng.scheduler.pad_to_bucket(
                eng.tok.encode(a.prompt)), b.output_ids])
            pos = SERVE_BUCKET + j - 1
            print(f"    request {a.request_id}: first difference at new "
                  f"token {j}, bf16 top-2 margin there "
                  f"{top2_margin(params, cfg, ids, pos):.4g}")

    contract_check("13a stablelm-1.6b", REFERENCE_CASES, params, cfg)

    # ---- phase 4: lossless in f32 ----
    print("phase 4: lossless (f32, TF32 off)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tables = eng.tables
    del params, eng, g_eng
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, param_dtype=torch.float32,
                                compute_dtype=torch.float32)
    params32 = M.init_params(cfg32, seed=0, device="cuda")
    eng32 = ServingEngine(params32, cfg32, spec, tables=tables,
                          buckets=(SERVE_BUCKET,))
    lprompts = prompts[:LOSSLESS_REQUESTS]
    done32, wall32 = serve(eng32, lprompts, LOSSLESS_NEW)
    toks = np.stack([eng32.scheduler.pad_to_bucket(eng32.tok.encode(p))
                     for p in lprompts])
    ref = greedy_reference(params32, cfg32, toks, LOSSLESS_NEW).cpu().numpy()
    check_equals_greedy(params32, cfg32, done32, ref, SERVE_BUCKET)
    calls32 = sum(r.stats["model_calls"] for r in done32)
    print(f"  f32 mixed == greedy_reference for {len(done32)} requests x "
          f"{LOSSLESS_NEW} tokens ({calls32} verify calls, {wall32:.2f} s)")
    lossless_continuous(params32, cfg32, spec, tables)
    del params32, eng32
    torch.cuda.empty_cache()
    return launches, tables, [r.output_ids for r in done]


# ---------------------------------------------------------------------------
# phases 4 (continuous part) and 5: continuous batching, paged and linear
# ---------------------------------------------------------------------------
def cont_workload():
    """The long-context arrival mix of the reference's paged benchmark
    (``make_longctx_workload``), all submitted up front: every 5th request
    (i % 5 == 2) fills the 256 bucket, the rest fit 64; budgets cycle over
    16, 32, 48."""
    from repro_torch.data.datasets import make_prompts
    texts = [p for p, _ in make_prompts("code", CONT_N, seed=1)]
    out = []
    for i in range(CONT_N):
        text = texts[i % len(texts)]
        if i % CONT_LONG_EVERY == 2:
            text = ((text + " ") * 40)[:CONT_BUCKETS[-1] - 1]
        else:
            text = text[:CONT_BUCKETS[0] - 1]
        out.append((text, CONT_NEW[i % len(CONT_NEW)]))
    return out


def cont_engine(params, cfg, spec, tables, paged: bool, **kw):
    """Phase 5's continuous engine; ``kw``: more engine arguments
    (``adaptive=True``)."""
    from repro_torch.serving.engine import ServingEngine
    return ServingEngine(params, cfg, spec, tables=tables,
                         max_batch=CONT_SLOTS, buckets=CONT_BUCKETS,
                         max_new_cap=max(CONT_NEW), paged=paged,
                         num_pages=CONT_PAGES if paged else None,
                         page_size=CONT_PAGE, **kw)


def serve_continuous(engine, work):
    for text, mnt in work:
        engine.submit(text, max_new_tokens=mnt)
    sync()
    t0 = time.perf_counter()
    done = engine.serve_continuous()
    sync()
    done.sort(key=lambda r: r.request_id)
    return done, time.perf_counter() - t0


def reset_launches():
    from repro_torch.kernels.mamba_scan import mamba_scan_cuda
    from repro_torch.kernels.ngram_match import ngram_draft_cuda
    from repro_torch.kernels.spec_attention import (paged_spec_attention_cuda,
                                                    spec_attention_cuda)
    for fn in (spec_attention_cuda, ngram_draft_cuda,
               paged_spec_attention_cuda, mamba_scan_cuda):
        fn.launches = 0
    spec_attention_cuda.tree_launches = 0
    paged_spec_attention_cuda.tree_launches = 0


def read_launches() -> dict:
    from repro_torch.kernels.mamba_scan import mamba_scan_cuda
    from repro_torch.kernels.ngram_match import ngram_draft_cuda
    from repro_torch.kernels.spec_attention import (paged_spec_attention_cuda,
                                                    spec_attention_cuda)
    return {"mamba_scan": mamba_scan_cuda.launches,
            "spec_attention": spec_attention_cuda.launches,
            "ngram_match": ngram_draft_cuda.launches,
            "paged_spec_attention": paged_spec_attention_cuda.launches,
            "tree_spec_attention": spec_attention_cuda.tree_launches,
            "paged_tree_spec_attention":
                paged_spec_attention_cuda.tree_launches}


def check_paged_run(engine, done, work, deferrals: bool = True):
    """The paged run's pool: no leaked page, deferrals (unless
    ``deferrals`` is False), no rejection, the page books intact; every
    request reached its budget."""
    from repro_torch.models.cache import check_page_invariants
    st = engine.pool_stats()
    inv = check_page_invariants(engine._cont_state.model)
    print(f"    pool: {st}; invariants after the drain: {inv}")
    if st["free_pages"] != st["num_pages"] or inv["allocated"] != 0:
        raise AssertionError(f"pages leaked: {st}, {inv}")
    if (deferrals and st["deferrals"] <= 0) or st["rejected"] != 0:
        raise AssertionError(f"expected deferrals and no rejection: {st}")
    check_budgets(done, work)
    return st


def check_budgets(done, work):
    got = [r.stats.get("new_tokens") for r in done]
    want = [m for _, m in work]
    if got != want or any("error" in r.stats for r in done):
        raise AssertionError(f"requests did not reach their budgets: {got} "
                             f"!= {want}")


def lossless_continuous(params32, cfg32, spec, tables):
    """Phase 4, continuous part: the first 8 requests of phase 5's mix (two
    long) through continuous serving, paged (16-page pool) and linear, in
    f32: each output equals greedy_reference, and paged equals linear."""
    import numpy as np
    from repro_torch.core.spec_engine import greedy_reference
    work = cont_workload()[:CONT_LOSSLESS]
    outs = {}
    for paged in (True, False):
        eng = cont_engine(params32, cfg32, spec, tables, paged)
        reset_launches()
        done, wall = serve_continuous(eng, work)
        launches = read_launches()
        check_budgets(done, work)
        if paged:
            check_paged_run(eng, done, work)
        kernel = "paged_spec_attention" if paged else "spec_attention"
        if launches[kernel] <= 0:
            raise AssertionError(f"{kernel} never launched: {launches}")
        outs[paged] = done
        print(f"  f32 continuous {'paged' if paged else 'linear'} mixed: "
              f"{len(done)} requests in {wall:.2f} s, launches {launches}")
    for rp, rl in zip(outs[True], outs[False]):
        if not np.array_equal(rp.output_ids, rl.output_ids):
            raise AssertionError(f"f32 request {rp.request_id}: paged != "
                                 f"linear continuous output")
    for r, (_, mnt) in zip(outs[True], work):
        toks = np.asarray(cont_engine_tokens(r.prompt))
        ref = greedy_reference(params32, cfg32, toks[None], mnt)
        want = ref[0, len(toks):].cpu().numpy()
        if not np.array_equal(r.output_ids, want):
            j = int(np.argmax(r.output_ids != want))
            m = top2_margin(params32, cfg32, ref[0].cpu().numpy(),
                            len(toks) + j - 1)
            print(f"  request {r.request_id}: continuous != greedy_reference"
                  f" at new token {j} (f32 top-2 margin {m:.4g})")
            raise AssertionError("f32 continuous output is not lossless")
    print(f"  f32 continuous paged == linear == greedy_reference for "
          f"{len(work)} requests ({sum(m for _, m in work)} tokens)")


def cont_engine_tokens(prompt: str, buckets=CONT_BUCKETS):
    """The bucketed prompt tokens continuous serving prefills."""
    from repro_torch.data.tokenizer import ByteTokenizer
    from repro_torch.serving.scheduler import Scheduler
    return Scheduler(buckets=buckets).pad_to_bucket(
        ByteTokenizer().encode(prompt))


def phase_continuous(tables) -> tuple:
    """Phase 5: the bf16 model serves the mix four times (paged mixed, the
    slice's main path, then linear mixed, paged greedy, linear greedy).
    Returns K3's launches on the main path and each run's rate line."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.spec_engine import SpecConfig
    from repro_torch.models import model as M
    cfg = main_config()
    params = M.init_params(cfg, seed=0, device="cuda")
    work = cont_workload()
    runs, rates = {}, {}
    for strategy in ("mixed", "greedy"):
        spec = SpecConfig(k=SERVE_K, w=SERVE_W, strategy=strategy)
        for paged in (True, False):
            eng = cont_engine(params, cfg, spec,
                              tables if strategy == "mixed" else None, paged)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()        # counts from zero just before the run
            done, wall = serve_continuous(eng, work)
            launches = read_launches()
            peak = torch.cuda.max_memory_allocated() / 2**30
            name = f"{'paged' if paged else 'linear'} {strategy}"
            rates[name] = cont_rate(done, wall)
            print(f"  {name}: {rates[name]}, peak memory {peak:.2f} "
                  f"GiB, launches {launches}")
            if paged:
                check_paged_run(eng, done, work)
                if launches["paged_spec_attention"] <= 0 \
                        or launches["spec_attention"] != 0:
                    raise AssertionError(f"paged run not carried by K3: "
                                         f"{launches}")
            else:
                check_budgets(done, work)
                if launches["spec_attention"] <= 0 \
                        or launches["paged_spec_attention"] != 0:
                    raise AssertionError(f"linear run not carried by K1: "
                                         f"{launches}")
            if strategy == "mixed" and launches["ngram_match"] <= 0:
                raise AssertionError(f"K2 never launched: {launches}")
            runs[(strategy, paged)] = (done, launches)
    print("phase 5b: where a continuous step's time goes (torch.profiler, "
          "8 slots after the first admissions; each step retires, admits "
          "and runs one spec_step)")
    spec = SpecConfig(k=SERVE_K, w=SERVE_W, strategy="mixed")
    for paged in (True, False):
        eng = cont_engine(params, cfg, spec, tables, paged)
        for text, mnt in work:
            eng.submit(text, max_new_tokens=mnt)
        eng.step()
        profile_window(f"{'paged' if paged else 'linear'} mixed continuous "
                       f"step", eng.step)
        del eng
    for strategy in ("mixed", "greedy"):
        dp, dl = runs[(strategy, True)][0], runs[(strategy, False)][0]
        same = [bool(np.array_equal(a.output_ids, b.output_ids))
                for a, b in zip(dp, dl)]
        print(f"  bf16 {strategy}: paged == linear for {sum(same)} of "
              f"{len(same)} requests")
        for a, b, (text, _) in zip(dp, dl, work):
            if not np.array_equal(a.output_ids, b.output_ids):
                j = int(np.argmax(a.output_ids != b.output_ids))
                toks = np.asarray(cont_engine_tokens(text))
                ids = np.concatenate([toks, b.output_ids])
                print(f"    request {a.request_id}: first difference at new "
                      f"token {j}, bf16 top-2 margin there "
                      f"{top2_margin(params, cfg, ids, len(toks) + j - 1):.4g}")
    del params
    torch.cuda.empty_cache()
    return runs[("mixed", True)][1]["paged_spec_attention"], rates


def cont_rate(done, wall) -> str:
    """A continuous run's rate line: tokens, tokens/s, tokens/call and
    admit->retire latency p50/p99."""
    import numpy as np
    n_new = sum(r.stats["new_tokens"] for r in done)
    calls = sum(r.stats["model_calls"] for r in done)
    lat = np.array([r.stats["latency_s"] for r in done])
    return (f"{n_new} new tokens in {wall:.3f} s = {n_new / wall:.1f} "
            f"tokens/s, tokens/call {n_new / max(calls, 1):.3f}, "
            f"admit->retire latency p50 {np.percentile(lat, 50):.3f} s p99 "
            f"{np.percentile(lat, 99):.3f} s")


# ---------------------------------------------------------------------------
# phase 6: tree speculation
# ---------------------------------------------------------------------------
def tree_workload():
    """The reference tree benchmark's mix (``make_repetitive_prompts``,
    benchmarks/continuous_batching.py), rebuilt: 12 code prompts, the even
    ones one chunk looped verbatim, the odd ones two chunks with a shared
    prefix alternating (the top-1 n-gram successor is right half the time
    at a seam, the top-2 set always), cut to the 128 bucket."""
    from repro_torch.data.datasets import make_prompts
    texts = [p for p, _ in make_prompts("code", TREE_N, seed=1)]
    out = []
    for i, t in enumerate(texts):
        a = t[:14].strip() or "for i in"
        if i % 2 == 0:
            body = (a + " ") * 8
        else:
            b = (a[:6] + t[20:28]).strip() or a + "x"
            body = "".join((a if j % 2 else b) + " " for j in range(8))
        out.append(body[:TREE_BUCKET - 1])
    return out


def tree_specs() -> dict:
    """name -> (SpecConfig, verify inputs per call)."""
    from repro_torch.core.spec_engine import SpecConfig
    from repro_torch.core.tree import num_nodes
    wd, dp, br = TREE_WDB
    k, w = TREE_LINEAR
    return {f"tree {TREE_WDB}": (SpecConfig(k=wd, w=dp, strategy="mixed",
                                            tree=True, tree_branch=br),
                                 num_nodes(*TREE_WDB) + 1),
            f"linear {TREE_LINEAR}": (SpecConfig(k=k, w=w, strategy="mixed"),
                                      k * (w + 1)),
            "greedy": (SpecConfig(strategy="greedy"), 1)}


def tree_engine(params, cfg, spec, tables, paged=None, **kw):
    """A 4-slot engine over the 128 bucket; ``paged`` None: static (the
    linear cache), else continuous over the 16-page pool or linear.
    ``kw``: more engine arguments (``adaptive=True, arms=...``)."""
    from repro_torch.serving.engine import ServingEngine
    if paged:
        kw.update(paged=True, num_pages=CONT_PAGES, page_size=CONT_PAGE)
    return ServingEngine(params, cfg, spec,
                         tables=None if spec.strategy == "greedy" else tables,
                         max_batch=TREE_SLOTS, buckets=(TREE_BUCKET,),
                         max_new_cap=TREE_NEW, **kw)


def check_pool_drained(engine):
    from repro_torch.models.cache import check_page_invariants
    st = engine.pool_stats()
    inv = check_page_invariants(engine._cont_state.model)
    if st["free_pages"] != st["num_pages"] or inv["allocated"] != 0 \
            or st["rejected"] != 0:
        raise AssertionError(f"pool not drained cleanly: {st}, {inv}")
    return st


def profile_fill_tree(tables, prompts):
    """``fill_tree`` alone on a batch of the mix's committed buffers: the
    device ops and time the level-wise fill adds to a tree step."""
    import numpy as np
    import torch
    from repro_torch.core.tree import fill_tree, topology
    from repro_torch.data.tokenizer import ByteTokenizer
    from repro_torch.serving.scheduler import Scheduler
    sched = Scheduler(buckets=(TREE_BUCKET,))
    buf = torch.as_tensor(np.stack([sched.pad_to_bucket(
        ByteTokenizer().encode(p)) for p in prompts]), device="cuda")
    buf_len = torch.full((buf.shape[0],), TREE_BUCKET, dtype=torch.int32,
                         device="cuda")
    g = torch.Generator(device="cuda").manual_seed(6)
    drafts = torch.randint(0, 256, (buf.shape[0],) + TREE_WDB[:2],
                           generator=g, device="cuda", dtype=torch.int32)
    topo = topology(*TREE_WDB)
    profile_window(f"fill_tree {TREE_WDB} alone", lambda: fill_tree(
        topo, drafts, tables, buf=buf, buf_len=buf_len), steps=8)


def phase_tree(tables) -> dict:
    """Phase 6: the tree mix served statically and continuously (bf16),
    6b: a tree step and a linear (12, 5) step profiled, then the f32
    lossless check.  Returns K4's launches on the tree path (the linear
    instantiation's in the static tree run, the paged one's in the
    continuous paged tree run) and the static tree run's outputs."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.spec_engine import greedy_reference
    from repro_torch.models import model as M
    cfg = main_config()
    params = M.init_params(cfg, seed=0, device="cuda")
    prompts = tree_workload()
    work = [(p, TREE_NEW) for p in prompts]
    specs = tree_specs()
    tree_name = f"tree {TREE_WDB}"
    k4 = {}
    runs = {}

    def report(mode, name, done, wall, launches, extra=""):
        n_new = sum(r.stats["new_tokens"] for r in done)
        calls = sum(r.stats["model_calls"] for r in done)
        peak = torch.cuda.max_memory_allocated() / 2**30
        hist = np.sum([r.stats["accept_hist"] for r in done], axis=0)
        print(f"  {mode} {name} ({specs[name][1]} verify inputs): {n_new} "
              f"new tokens in {wall:.3f} s = {n_new / wall:.1f} tokens/s, "
              f"tokens/call {n_new / max(calls, 1):.3f}, {calls} calls, "
              f"accept_hist {hist.tolist()}, peak memory {peak:.2f} GiB"
              f"{extra}, launches {launches}")
        check_budgets(done, work)
        return n_new / max(calls, 1)

    tpc = {}
    for name, (spec, _) in specs.items():
        eng = tree_engine(params, cfg, spec, tables)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()              # counts from zero just before the run
        done, wall = serve(eng, prompts, TREE_NEW)
        launches = read_launches()
        tpc[name] = report("static", name, done, wall, launches)
        if spec.tree:
            k4["tree_spec_attention"] = launches["tree_spec_attention"]
            if launches["tree_spec_attention"] <= 0 \
                    or launches["spec_attention"] != 0:
                raise AssertionError(f"static tree run not carried by K4: "
                                     f"{launches}")
        runs["static", name] = done
    for name in specs:
        print(f"  static tokens/call at verify cost: {name}: "
              f"{tpc[name]:.3f} ({specs[name][1]} inputs)")
    for name, paged in ((tree_name, True), (tree_name, False),
                        (f"linear {TREE_LINEAR}", True), ("greedy", True)):
        spec = specs[name][0]
        eng = tree_engine(params, cfg, spec, tables, paged=paged)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()              # counts from zero just before the run
        done, wall = serve_continuous(eng, work)
        launches = read_launches()
        pool = ""
        if paged:
            st = check_pool_drained(eng)
            pool = (f", peak pages {st['peak_pages']} of {st['num_pages']},"
                    f" deferrals {st['deferrals']}")
        lat = np.array([r.stats["latency_s"] for r in done])
        pool += (f", latency p50 {np.percentile(lat, 50):.3f} s p99 "
                 f"{np.percentile(lat, 99):.3f} s")
        mode = f"continuous {'paged' if paged else 'linear'}"
        report(mode, name, done, wall, launches, pool)
        if spec.tree:
            key = "paged_tree_spec_attention" if paged \
                else "tree_spec_attention"
            other = ("spec_attention", "paged_spec_attention",
                     "tree_spec_attention" if paged
                     else "paged_tree_spec_attention")
            if launches[key] <= 0 or any(launches[o] for o in other):
                raise AssertionError(f"{mode} tree run not carried by K4 "
                                     f"alone: {launches}")
            if paged:
                k4["paged_tree_spec_attention"] = launches[key]
        runs[mode, name] = done
    same = [bool(np.array_equal(a.output_ids, b.output_ids)) for a, b in
            zip(runs["continuous paged", tree_name],
                runs["continuous linear", tree_name])]
    print(f"  bf16 continuous tree: paged == linear for {sum(same)} of "
          f"{len(same)} requests")
    if not all(same):
        raise AssertionError("bf16 tree paged differs from tree linear")
    tree_out = [r.output_ids for r in runs["static", tree_name]]
    print("phase 6b: where a tree step's time goes (torch.profiler, "
          f"{TREE_SLOTS} prompts of the mix, static)")
    for name in (tree_name, f"linear {TREE_LINEAR}"):
        profile_steps(params, cfg, specs[name][0], tables,
                      prompts[:TREE_SLOTS], bucket=TREE_BUCKET,
                      label=f"{name} step")
    profile_fill_tree(tables, prompts[:TREE_SLOTS])
    del params
    torch.cuda.empty_cache()

    print("phase 6, lossless: the tree in f32 (TF32 off)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = dataclasses.replace(cfg, param_dtype=torch.float32,
                                compute_dtype=torch.float32)
    params32 = M.init_params(cfg32, seed=0, device="cuda")
    tree_spec = specs[tree_name][0]
    eng = tree_engine(params32, cfg32, tree_spec, tables)
    toks = np.stack([eng.scheduler.pad_to_bucket(eng.tok.encode(p))
                     for p in prompts])
    ref = greedy_reference(params32, cfg32, toks, TREE_NEW).cpu().numpy()
    outs = {"static": serve(eng, prompts, TREE_NEW)[0]}
    for paged in (False, True):
        eng = tree_engine(params32, cfg32, tree_spec, tables, paged=paged)
        outs[f"continuous {'paged' if paged else 'linear'}"] = \
            serve_continuous(eng, work)[0]
    for mode, done in outs.items():
        for i, r in enumerate(done):
            want = ref[i, TREE_BUCKET:]
            if not np.array_equal(r.output_ids, want):
                j = int(np.argmax(r.output_ids != want))
                m = top2_margin(params32, cfg32, ref[i], TREE_BUCKET + j - 1)
                print(f"  request {r.request_id}: f32 {mode} tree != "
                      f"greedy_reference at new token {j} (top-2 margin "
                      f"{m:.4g})")
                raise AssertionError(f"f32 {mode} tree is not lossless")
        calls = sum(r.stats["model_calls"] for r in done)
        print(f"  f32 {mode} tree == greedy_reference for {len(done)} "
              f"requests x {TREE_NEW} tokens ({calls} verify calls)")
    del params32, eng
    torch.cuda.empty_cache()
    return k4, tree_out


# ---------------------------------------------------------------------------
# phase 8: sampled serving (run after phase 6, while StableLM is loaded)
# ---------------------------------------------------------------------------
def tv_distance(a, b) -> float:
    """Total variation distance between two count vectors."""
    return float(0.5 * abs(a / a.sum() - b / b.sum()).sum())


def chi2_two_sample(a_counts, b_counts, min_expected: float = 5.0):
    """Two-sample chi-square with the sparse tail merged into one cell;
    returns (statistic, degrees of freedom)."""
    import numpy as np
    order = np.argsort(a_counts + b_counts)[::-1]
    a, b = a_counts[order].astype(float), b_counts[order].astype(float)
    k = max(int((np.cumsum((a + b) < 2 * min_expected) == 0).sum()), 1)
    a = np.concatenate([a[:k], [a[k:].sum()]])
    b = np.concatenate([b[:k], [b[k:].sum()]])
    p = (a + b) / (a.sum() + b.sum())
    ea, eb = a.sum() * p, b.sum() * p
    m = (ea > 0) & (eb > 0)
    stat = ((a - ea) ** 2 / np.where(m, ea, 1))[m].sum() + (
        (b - eb) ** 2 / np.where(m, eb, 1))[m].sum()
    return float(stat), int(m.sum()) - 1


def check_distribution(device: str, temp: float, topp: float) -> dict:
    """The spec walk samples the plain sampler's distribution: a V=17
    f32 model (seeded), B=512 rows of one prompt, 4 new tokens by a mixed
    (4, 3) walk against ``sampling_reference``.  Each position's marginal
    has TV < 0.18 and a two-sample chi-square below df + 6 sqrt(2 df); a
    0.3-temperature control is told apart at position 0 (TV > 0.25: the
    check has power); more than 10% of verify calls commit more than one
    token (the walk speculates).  Raises on a miss; returns the numbers."""
    import numpy as np
    import torch
    from repro_torch.core import prng
    from repro_torch.core.ngram_tables import (NGramTables, build_bigram,
                                               build_unigram)
    from repro_torch.core.spec_engine import (SpecConfig, generate,
                                              sampling_reference)
    from repro_torch.models import model as M
    from repro_torch.models.config import ModelConfig
    cfg = ModelConfig(name="tv", num_layers=2, d_model=32, num_heads=2,
                      num_kv_heads=2, d_ff=64, vocab_size=DIST_V,
                      param_dtype=torch.float32,
                      compute_dtype=torch.float32).validate()
    params = M.init_params(cfg, seed=0, device=device)
    topk, chain = build_bigram(
        lambda t: M.forward(params, cfg, tokens=t)[0][:, -1], DIST_V,
        k_max=4, w_max=4, batch=DIST_V, device=device)
    emb = params["embed"]["embedding"]
    tables = NGramTables(build_unigram(emb, params["embed"].get(
        "lm_head", emb.T), k_max=4), topk, chain)
    prompt = torch.tensor([3, 1, 4, 1, 5, 9], dtype=torch.int32,
                          device=device).expand(DIST_B, 6).contiguous()
    P, N = prompt.shape[1], DIST_N
    spec = SpecConfig(k=4, w=3, strategy="mixed", max_new_tokens=N,
                      sampling=True)
    buf, _, stats = generate(params, cfg, spec, prompt, tables,
                             device=device, temperature=temp, top_p=topp,
                             rng=prng.prng_key(17))
    got = buf[:, P:P + N].cpu().numpy()
    plain = lambda seed, t, p: sampling_reference(
        params, cfg, prompt, N, prng.prng_key(seed), t, p,
        device=device)[:, P:P + N].cpu().numpy()
    ref, ctl = plain(170, temp, topp), plain(171, 0.3, 1.0)
    count = lambda toks: np.bincount(toks, minlength=DIST_V)
    out = dict(tv=0.0, chi2_excess=-np.inf)
    for pos in range(N):
        cs, cr = count(got[:, pos]), count(ref[:, pos])
        tv = tv_distance(cs, cr)
        stat, df = chi2_two_sample(cs, cr)
        limit = df + 6 * np.sqrt(2 * max(df, 1))
        if tv >= 0.18 or stat >= limit:
            raise AssertionError(f"t={temp} p={topp} position {pos}: TV "
                                 f"{tv:.4f}, chi-square {stat:.2f} (limit "
                                 f"{limit:.2f}, df {df})")
        out["tv"] = max(out["tv"], tv)
        out["chi2_excess"] = max(out["chi2_excess"], stat - limit)
    out["power_tv"] = tv_distance(count(got[:, 0]), count(ctl[:, 0]))
    hist = stats["accept_hist"].sum(dim=0).cpu().numpy()
    calls = int(stats["calls"].sum())
    out["multi_share"] = float(hist[2:].sum() / calls)
    if out["power_tv"] <= 0.25 or out["multi_share"] <= 0.10 \
            or hist[0] != 0 or hist.sum() != calls:
        raise AssertionError(f"t={temp} p={topp}: no power or no "
                             f"speculation: {out}, hist {hist.tolist()}")
    return out


def sample_kw(i: int) -> dict:
    """Request i's sampling controls (pinned seed)."""
    return dict(temperature=SAMPLE_T, top_p=SAMPLE_P, seed=SAMPLE_SEED + i)


def serve_sampled(engine, prompts, max_new, sampled, continuous=False):
    """``serve``/``serve_continuous`` with request i sampled where
    ``sampled[i]`` (``sample_kw``); returns (done, wall s)."""
    for i, (p, mnt) in enumerate(zip(prompts, max_new)):
        engine.submit(p, max_new_tokens=mnt,
                      **(sample_kw(i) if sampled[i] else {}))
    sync()
    t0 = time.perf_counter()
    done = (engine.serve_continuous() if continuous
            else engine.serve_all())
    sync()
    done.sort(key=lambda r: r.request_id)
    return done, time.perf_counter() - t0


def check_replay(label, runs, greedy_ref=None, sampled=None):
    """The second run replays the first bit for bit; with ``greedy_ref``,
    the unsampled rows equal it."""
    import numpy as np
    a, b = runs
    if not all(np.array_equal(x.output_ids, y.output_ids)
               for x, y in zip(a, b)):
        raise AssertionError(f"{label}: the replay differs")
    if greedy_ref is not None:
        same = [bool(np.array_equal(r.output_ids, g))
                for r, g, s in zip(a, greedy_ref, sampled) if not s]
        print(f"  {label}: replay bit-equal; greedy rows == the greedy-only "
              f"run's for {sum(same)} of {len(same)}")
        if not all(same):
            raise AssertionError(f"{label}: a greedy row was perturbed")
    else:
        print(f"  {label}: replay bit-equal for {len(a)} requests")


def rate_line(done, wall, sampled) -> str:
    """tokens/call and tokens/s of the sampled and of the greedy rows."""
    parts = []
    for name, flag in (("sampled", True), ("greedy", False)):
        rs = [r for r, s in zip(done, sampled) if s == flag]
        n = sum(r.stats["new_tokens"] for r in rs)
        calls = sum(r.stats["model_calls"] for r in rs)
        parts.append(f"{name} rows {n} tokens, tokens/call "
                     f"{n / max(calls, 1):.3f}, {n / wall:.1f} tokens/s")
    return "; ".join(parts)


def sampler_device_ms(B, K, W1, V):
    """The sampler's own device ms at a verify step's shape: the noise
    (one split per slot, a key per level, gumbel over V) and the shaping
    (temperature, softmax, the top-p sort and cumsum); also the whole
    ``sample_predictions``.  One call at a time behind the spin: a call
    is ~450 launches, and more than CUDA's queue of pending launches would
    stall the enqueue."""
    import torch
    from repro_torch.core import prng
    from repro_torch.core.verify import sample_predictions, shape_logits
    g = torch.Generator(device="cuda").manual_seed(8)
    logits = torch.randn((B, K, W1, V), generator=g, device="cuda").to(
        torch.bfloat16) * 4
    keys = prng.split(prng.fold_in(prng.prng_key(3, "cuda"),
                                   torch.arange(B, device="cuda")))[:, 0]
    temp = torch.full((B,), SAMPLE_T, device="cuda")
    topp = torch.full((B,), SAMPLE_P, device="cuda")
    lv = torch.arange(W1, device="cuda")

    def noise():
        use = prng.split(keys)[:, 0]
        prng.gumbel(prng.fold_in(use[:, None], lv[None]), (V,))
    return dict(
        noise=device_ms(noise, iters=1, warmup=1),
        shaping=device_ms(lambda: shape_logits(logits, temp, topp), iters=1,
                          warmup=1),
        sample_predictions=device_ms(lambda: sample_predictions(
            logits, keys, temp, topp), iters=1, warmup=1))


def phase_sampling(tables, serve_out, tree_out) -> None:
    """Phase 8 (see the module docstring)."""
    t_phase = time.perf_counter()
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.spec_engine import SpecConfig
    from repro_torch.models import model as M
    from repro_torch.serving.engine import ServingEngine
    cfg = main_config()
    params = M.init_params(cfg, seed=0, device="cuda")
    spec = SpecConfig(k=SERVE_K, w=SERVE_W, strategy="mixed")
    prompts = smoke_prompts()
    n = len(prompts)
    half = [i < n // 2 for i in range(n)]

    # ---- 8a: static, phase 3's requests, the first half sampled ----
    print(f"phase 8a: static ({n} requests, requests 0-{n // 2 - 1} "
          f"sampled)")
    runs = []
    for _ in range(2):
        eng = ServingEngine(params, cfg, spec, tables=tables,
                            buckets=(SERVE_BUCKET,))
        reset_launches()            # counts from zero just before the run
        done, wall = serve_sampled(eng, prompts, [SERVE_NEW] * n, half)
        launches = read_launches()
        runs.append(done)
        steps = launches["spec_attention"] // cfg.num_layers
        print(f"  {rate_line(done, wall, half)}; {wall:.3f} s, launches "
              f"{launches}")
        if launches["ngram_match"] != steps or steps <= 0:
            raise AssertionError(f"sampled static run not drafted by K2 "
                                 f"once a step through K1: {launches}")
        if any(r.stats["new_tokens"] != SERVE_NEW for r in done):
            raise AssertionError("a sampled request missed its budget")
    check_replay("8a static", runs, serve_out, half)

    # ---- 8b: continuous paged, phase 5's mix, every other sampled ----
    work = cont_workload()
    alt = [i % 2 == 1 for i in range(len(work))]
    print(f"phase 8b: continuous paged ({len(work)} requests, every other "
          f"sampled, {CONT_PAGES}-page pool)")
    runs = []
    for _ in range(2):
        eng = cont_engine(params, cfg, spec, tables, True)
        reset_launches()
        done, wall = serve_sampled(eng, [t for t, _ in work],
                                   [m for _, m in work], alt,
                                   continuous=True)
        launches = read_launches()
        lat = np.array([r.stats["latency_s"] for r in done])
        print(f"  {rate_line(done, wall, alt)}; latency p50 "
              f"{np.percentile(lat, 50):.3f} s p99 "
              f"{np.percentile(lat, 99):.3f} s, {wall:.3f} s, launches "
              f"{launches}")
        check_paged_run(eng, done, work)
        if launches["paged_spec_attention"] <= 0 \
                or launches["ngram_match"] <= 0:
            raise AssertionError(f"sampled paged run not carried by K3 and "
                                 f"K2: {launches}")
        runs.append(done)
    check_replay("8b continuous paged", runs)

    # ---- 8c: the (4, 5, 2) tree, half the mix sampled ----
    tprompts = tree_workload()
    tspec = tree_specs()[f"tree {TREE_WDB}"][0]
    odd = [i % 2 == 1 for i in range(len(tprompts))]
    print(f"phase 8c: static tree {TREE_WDB} ({len(tprompts)} requests of "
          f"the tree mix, every other sampled)")
    runs = []
    for _ in range(2):
        eng = tree_engine(params, cfg, tspec, tables)
        reset_launches()
        done, wall = serve_sampled(eng, tprompts, [TREE_NEW] * len(tprompts),
                                   odd)
        launches = read_launches()
        print(f"  {rate_line(done, wall, odd)}; launches {launches}")
        if launches["tree_spec_attention"] <= 0 \
                or launches["spec_attention"] != 0:
            raise AssertionError(f"sampled tree run not carried by K4: "
                                 f"{launches}")
        runs.append(done)
    check_replay("8c tree", runs, tree_out, odd)

    # ---- 8d: the distribution through K1 and K2 ----
    print(f"phase 8d: distribution (V={DIST_V}, B={DIST_B}, {DIST_N} "
          f"tokens, f32, TF32 off)")
    torch.backends.cuda.matmul.allow_tf32 = False     # phase 4 set it too
    for temp, topp in DIST_CASES:
        reset_launches()
        out = check_distribution("cuda", temp, topp)
        launches = read_launches()
        print(f"  t={temp} p={topp}: max TV {out['tv']:.4f} (< 0.18), "
              f"chi-square margin {out['chi2_excess']:.2f} (< 0), control "
              f"TV {out['power_tv']:.4f} (> 0.25), calls committing > 1 "
              f"token {out['multi_share']:.3f} (> 0.10); launches "
              f"{launches}")
        if launches["spec_attention"] <= 0 or launches["ngram_match"] <= 0:
            raise AssertionError(f"distribution run missed K1/K2: "
                                 f"{launches}")

    # ---- 8e: profile ----
    print("phase 8e: a sampled static step beside the greedy-only mixed "
          "step (torch.profiler, phase 3's 8 prompts, 4 sampled)")
    sspec = dataclasses.replace(spec, sampling=True)
    profile_steps(params, cfg, spec, tables, prompts,
                  label="greedy-only mixed step")
    profile_steps(params, cfg, sspec, tables, prompts,
                  label="sampled mixed step",
                  temperature=torch.tensor([SAMPLE_T if h else 0.0
                                            for h in half], device="cuda"),
                  top_p=SAMPLE_P)
    ms = sampler_device_ms(n, SERVE_K, SERVE_W + 1, cfg.vocab_size)
    print(f"  sampler device ms at (B, k, w+1, V) = ({n}, {SERVE_K}, "
          f"{SERVE_W + 1}, {cfg.vocab_size}): noise {fmt_ms(ms['noise'])}, "
          f"shaping/sort {fmt_ms(ms['shaping'])}, sample_predictions "
          f"{fmt_ms(ms['sample_predictions'])}")
    del params, eng
    torch.cuda.empty_cache()
    print(f"  phase 8 took {time.perf_counter() - t_phase:.1f} s")



# ---------------------------------------------------------------------------
# phase 9: in-flight adaptive (k, w) arms (run after phase 8, before 7)
# ---------------------------------------------------------------------------
def recorded_arms(engine) -> list:
    """(arm, tokens/call) of every static batch the engine serves: its host
    controller's choice and the batch's committed tokens per call."""
    log, run = [], engine.run_batch

    def run_batch(batch):
        arm = engine.controller.choose()
        engine.controller.choose = lambda: arm
        try:
            done = run(batch)
        finally:
            del engine.controller.choose
        n = sum(r.stats["new_tokens"] for r in done)
        log.append((arm, n / max(1, sum(r.stats["model_calls"]
                                        for r in done))))
        return done

    engine.run_batch = run_batch
    return log


def arm_pulls_line(stats: dict) -> str:
    """``adaptive_stats()`` as 'arm: pulls' pairs (retired requests)."""
    return ", ".join(f"{tuple(a)}: {n}" for a, n in
                     zip(stats["arms"], stats["pulls_retired"]))


def check_f32_outputs(label, done, want):
    """Every output equals its greedy_reference tokens ``want``."""
    import numpy as np
    for r, w in zip(done, want):
        if not np.array_equal(r.output_ids, w):
            j = int(np.argmax(r.output_ids != w)) if len(r.output_ids) == \
                len(w) else -1
            raise AssertionError(f"f32 {label}: request {r.request_id} != "
                                 f"greedy_reference (first difference at "
                                 f"new token {j})")
    calls = sum(r.stats["model_calls"] for r in done)
    print(f"  f32 {label} == greedy_reference for {len(done)} requests "
          f"({sum(len(w) for w in want)} tokens, {calls} verify calls)")


def phase_adaptive(tables, cont_rates: dict) -> dict:
    """Phase 9 (see the module docstring).  Returns the kernels' launches
    on each adaptive path (9a's static run, 9b's continuous paged run,
    9c's f32 tree runs), by run, each counted from zero."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.controller import DEFAULT_ARMS
    from repro_torch.core.spec_engine import SpecConfig, greedy_reference
    from repro_torch.kernels.dispatch import unique_sweep_widths
    from repro_torch.models import model as M
    from repro_torch.serving.engine import ServingEngine
    t_phase = time.perf_counter()
    cfg = main_config()
    params = M.init_params(cfg, seed=0, device="cuda")
    spec = SpecConfig(k=SERVE_K, w=SERVE_W, strategy="mixed")
    work = cont_workload()
    texts, budgets = [t for t, _ in work], [m for _, m in work]
    depths = len(unique_sweep_widths(DEFAULT_ARMS))
    by_run = {}

    # ---- 9a: static, one arm a batch ----
    print(f"phase 9a: static serve_all, adaptive over {DEFAULT_ARMS} "
          f"({len(work)} requests of phase 5's mix, max_batch 4), beside "
          f"mixed ({SERVE_K}, {SERVE_W}) and greedy on the same batches")
    for name, sp, kw in (("adaptive", spec, dict(adaptive=True)),
                         (f"mixed ({SERVE_K}, {SERVE_W})", spec, {}),
                         ("greedy", SpecConfig(strategy="greedy"), {})):
        eng = ServingEngine(params, cfg, sp,
                            tables=None if sp.strategy == "greedy"
                            else tables, max_batch=4, buckets=CONT_BUCKETS,
                            **kw)
        log = recorded_arms(eng) if eng.controller else None
        reset_launches()            # counts from zero just before the run
        done, wall = serve_sampled(eng, texts, budgets, [False] * len(work))
        launches = read_launches()
        check_budgets(done, work)
        n_new = sum(r.stats["new_tokens"] for r in done)
        calls = sum(r.stats["model_calls"] for r in done)
        print(f"  {name}: {n_new} new tokens in {wall:.3f} s = "
              f"{n_new / wall:.1f} tokens/s, tokens/call "
              f"{n_new / max(calls, 1):.3f}, launches {launches}")
        if log is not None:
            by_run["9a static"] = launches
            for i, (arm, tpc) in enumerate(log):
                print(f"    batch {i}: arm {arm}, tokens/call {tpc:.3f}")
            if min(launches["spec_attention"], launches["ngram_match"]) <= 0:
                raise AssertionError(f"adaptive static run missed K1/K2: "
                                     f"{launches}")

    # ---- 9b: continuous paged, one arm a slot a step ----
    print(f"phase 9b: continuous paged adaptive ({len(work)} requests, "
          f"{CONT_PAGES}-page pool), beside phase 5's runs")
    eng = cont_engine(params, cfg, spec, tables, True, adaptive=True)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    done, wall = serve_continuous(eng, work)
    launches = read_launches()
    by_run["9b continuous paged"] = launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"  paged adaptive: {cont_rate(done, wall)}, peak memory "
          f"{peak:.2f} GiB, launches {launches}")
    for name in ("paged mixed", "paged greedy"):
        print(f"  (phase 5) {name}: {cont_rates[name]}")
    check_paged_run(eng, done, work)
    stats = eng.adaptive_stats()
    print(f"  adaptive_stats: pulls per arm {arm_pulls_line(stats)}; in "
          f"flight {stats['pulls_in_flight']}")
    steps = launches["paged_spec_attention"] // cfg.num_layers
    print(f"  K2 launches {launches['ngram_match']} in {steps} steps "
          f"({depths} arm depths a step)")
    if steps <= 0 or launches["ngram_match"] != steps * depths:
        raise AssertionError(f"an adaptive step did not draft once per arm "
                             f"depth: {launches}")
    if sum(stats["pulls_retired"]) != sum(r.stats["model_calls"]
                                          for r in done):
        raise AssertionError(f"arm pulls do not account for every call: "
                             f"{stats}")

    # ---- 9d: sampled rows under arms, replayed ----
    half = work[:len(work) // 2]
    alt = [i % 2 == 1 for i in range(len(half))]
    print(f"phase 9d: continuous paged adaptive, {len(half)} requests of "
          f"the mix, every other sampled (t {SAMPLE_T}, p {SAMPLE_P}), "
          f"twice")
    runs = []
    for _ in range(2):
        eng = cont_engine(params, cfg, spec, tables, True, adaptive=True)
        done, wall = serve_sampled(eng, [t for t, _ in half],
                                   [m for _, m in half], alt,
                                   continuous=True)
        check_pool_drained(eng)
        check_budgets(done, half)
        print(f"  {rate_line(done, wall, alt)}; {wall:.3f} s; pulls per "
              f"arm {arm_pulls_line(eng.adaptive_stats())}")
        runs.append(done)
    check_replay("9d adaptive sampled", runs)

    # ---- 9e: profile ----
    print("phase 9e: an adaptive continuous step beside phase 5b's mixed "
          "step (torch.profiler, paged, 8 slots after the first "
          "admissions)")
    for name, kw in (("adaptive", dict(adaptive=True)),
                     (f"mixed ({SERVE_K}, {SERVE_W})", {})):
        eng = cont_engine(params, cfg, spec, tables, True, **kw)
        for text, mnt in work:
            eng.submit(text, max_new_tokens=mnt)
        eng.step()
        profile_window(f"paged {name} continuous step", eng.step)
    del params, eng
    torch.cuda.empty_cache()

    # ---- 9c: lossless in f32 ----
    print(f"phase 9c: lossless (f32, TF32 off, {ADAPTIVE_F32_DEPTH} "
          f"layers): adaptive static, continuous "
          "paged and linear; tree arms")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = dataclasses.replace(cfg, num_layers=ADAPTIVE_F32_DEPTH,
                                param_dtype=torch.float32,
                                compute_dtype=torch.float32)
    params32 = M.init_params(cfg32, seed=0, device="cuda")
    lwork = work[:CONT_LOSSLESS]
    want = []
    for text, mnt in lwork:
        toks = np.asarray(cont_engine_tokens(text))
        want.append(greedy_reference(params32, cfg32, toks[None], mnt)
                    [0, len(toks):].cpu().numpy())
    eng = ServingEngine(params32, cfg32, spec, tables=tables, max_batch=4,
                        buckets=CONT_BUCKETS, adaptive=True)
    reset_launches()
    done, _ = serve_sampled(eng, [t for t, _ in lwork],
                            [m for _, m in lwork], [False] * len(lwork))
    check_f32_outputs("adaptive static", done, want)
    print(f"    launches {read_launches()}")
    for paged in (True, False):
        eng = cont_engine(params32, cfg32, spec, tables, paged,
                          adaptive=True)
        reset_launches()
        done, _ = serve_continuous(eng, lwork)
        launches = read_launches()
        if paged:
            check_pool_drained(eng)
        check_f32_outputs(f"adaptive continuous "
                          f"{'paged' if paged else 'linear'}", done, want)
        print(f"    launches {launches}")
    tprompts = tree_workload()
    tarms = ((1, 0), (2, 2), TREE_WDB[:2])
    tspec = tree_specs()[f"tree {TREE_WDB}"][0]
    toks = np.stack([cont_engine_tokens(p, (TREE_BUCKET,))
                     for p in tprompts])
    ref = greedy_reference(params32, cfg32, toks, TREE_NEW).cpu().numpy()
    twant = list(ref[:, TREE_BUCKET:])
    for paged in (None, True):
        eng = tree_engine(params32, cfg32, tspec, tables, paged,
                          adaptive=True, arms=tarms)
        reset_launches()
        if paged:
            done, _ = serve_continuous(eng, [(p, TREE_NEW)
                                             for p in tprompts])
            check_pool_drained(eng)
        else:
            done, _ = serve(eng, tprompts, TREE_NEW)
        launches = read_launches()
        mode = "continuous paged" if paged else "static"
        by_run[f"9c f32 tree {mode}"] = launches
        key = "paged_tree_spec_attention" if paged else "tree_spec_attention"
        check_f32_outputs(f"tree arms {tarms} {mode}", done, twant)
        print(f"    launches {launches}"
              + (f"; pulls per arm {arm_pulls_line(eng.adaptive_stats())}"
                 if paged else ""))
        if launches[key] <= 0:
            raise AssertionError(f"adaptive tree {mode} run did not launch "
                                 f"K4: {launches}")
    del params32, eng
    torch.cuda.empty_cache()
    print(f"  phase 9 took {time.perf_counter() - t_phase:.1f} s")
    return by_run


# ---------------------------------------------------------------------------
# phase 7: the hybrid (Mamba + attention) at full width
# ---------------------------------------------------------------------------
def oracle_logits(params, cfg, seq, lo: int, hi: int, pad_to: int = 0):
    """Next-token logits at positions lo..hi-1 of one full forward over
    ``seq`` (B, T), zero-padded at the end to a multiple of ``pad_to``
    when given (causal: the padding changes no earlier position), so that
    a long sequence takes the blockwise attention path."""
    import torch.nn.functional as F
    from repro_torch.models import model as M
    from repro_torch.models.layers import lm_logits
    if pad_to:
        seq = F.pad(seq, (0, -seq.shape[1] % pad_to))
    hidden, _ = M.forward_hidden(params, cfg, tokens=seq)
    return lm_logits(params["embed"], hidden[:, lo:hi], cfg)


def oracle_greedy(params, cfg, toks, max_new: int, pad_to: int = 0):
    """Greedy decoding by full forwards only: ``greedy_reference``, or with
    ``pad_to`` the same loop over ``oracle_logits`` (padded buffers)."""
    import torch
    from repro_torch.core.spec_engine import greedy_reference
    if not pad_to:
        return greedy_reference(params, cfg, toks, max_new).cpu().numpy()
    B, P = toks.shape
    buf = torch.zeros((B, P + max_new), dtype=torch.int32, device="cuda")
    buf[:, :P] = torch.as_tensor(toks, device="cuda")
    with torch.no_grad():
        for i in range(max_new):
            buf[:, P + i] = oracle_logits(params, cfg, buf[:, :P + i], P + i - 1,
                                          P + i, pad_to)[:, 0].argmax(-1)
    return buf.cpu().numpy()


def check_lossless(params32, cfg32, done, prompts, tok_fn, max_new, mode,
                   pad_to: int = 0, ref=None):
    """Each output is greedy decoding of its prompt, up to f32 ties.

    The outputs are compared with greedy decoding by full forwards
    (``oracle_greedy``) token for token, and every output token is held
    against the oracle's full forward over its own prefix (prompt + the
    output before it, one forward for all positions): it must be the
    oracle's argmax there, or lie within the f32 noise of it, measured in
    this run as the largest logit difference between two oracle
    evaluations of the same sequences (batch of all requests against one
    at a time).  A token within that noise is a tie (two top logits closer
    than f32 evaluation can separate); each is printed with its margin.
    Any other difference fails the run.  ``pad_to``: see
    ``oracle_logits``.  ``ref``: the oracle's greedy decoding of the same
    prompts, returned by an earlier call (computed when None).  Returns
    it."""
    import numpy as np
    import torch
    toks = np.stack([tok_fn(p) for p in prompts])
    P, n = toks.shape[1], len(done)
    if ref is None:
        ref = oracle_greedy(params32, cfg32, toks, max_new, pad_to)
    out = np.stack([r.output_ids for r in done])
    if out.shape != (n, max_new):
        raise AssertionError(f"f32 {mode}: outputs {out.shape}")
    seq = torch.as_tensor(np.concatenate([toks, out], 1), device="cuda")
    T = seq.shape[1]
    with torch.no_grad():
        logits = oracle_logits(params32, cfg32, seq, P - 1, T - 1, pad_to)
        one = torch.cat([oracle_logits(params32, cfg32, seq[i:i + 1], P - 1,
                                       T - 1, pad_to) for i in range(n)])
    noise = float((logits - one).abs().max())
    chosen = logits.gather(-1, seq[:, P:, None].long())[..., 0]
    gap = (logits.max(-1).values - chosen).cpu().numpy()     # >= 0
    exact = [bool(np.array_equal(out[i], ref[i, P:])) for i in range(n)]
    for i in range(n):
        if not exact[i]:
            j = int(np.argmax(out[i] != ref[i, P:]))
            top = oracle_logits(params32, cfg32, torch.as_tensor(
                ref[i:i + 1, :P + j], device="cuda"), P + j - 1, P + j,
                pad_to)[0, 0].topk(2).values
            print(f"  request {done[i].request_id}: f32 {mode} != "
                  f"greedy decoding from new token {j} (the oracle's "
                  f"top-2 margin there {float(top[0] - top[1]):.4g})")
    for i, t in zip(*np.nonzero(gap > 0)):
        tie = gap[i, t] <= noise
        print(f"  request {done[i].request_id} new token {t}: the oracle's "
              f"argmax on this prefix leads by {gap[i, t]:.4g} "
              f"({'a tie within' if tie else 'ABOVE'} the f32 noise "
              f"{noise:.4g})")
        if not tie:
            raise AssertionError(f"f32 {mode} is not lossless")
    calls = sum(r.stats["model_calls"] for r in done)
    print(f"  f32 {mode}: == greedy decoding for {sum(exact)} of {n}"
          f" requests x {max_new} tokens; every token the oracle's argmax on"
          f" its own prefix but {int((gap > 0).sum())} f32 tie(s) (noise "
          f"{noise:.4g}); {calls} verify calls")
    return ref


def phase_hybrid() -> tuple:
    """Phase 7 (see the module docstring).  Returns the launches of the
    static mixed run (7a), the hybrid's main path, and of 7e's adaptive
    runs."""
    import numpy as np
    import torch
    from repro_torch.core.spec_engine import SpecConfig
    from repro_torch.models import model as M
    from repro_torch.serving.engine import ServingEngine
    cfg = hybrid_config()
    gib = torch.cuda.memory_allocated() / 2**30
    print(f"  memory after freeing StableLM: {gib:.2f} GiB allocated, peak "
          f"so far {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_params(cfg, seed=0, device="cuda")
    sync()
    print(f"  {cfg.name}: {cfg.param_count() / 1e9:.3f}B params, "
          f"{cfg.num_layers} layers "
          f"({[b.mixer for b in cfg.block_pattern]}), d_model {cfg.d_model},"
          f" H={cfg.num_heads} KV={cfg.num_kv_heads}, Mamba d_inner "
          f"{cfg.mamba_d_inner} d_state {cfg.mamba_d_state}, vocab "
          f"{cfg.vocab_size}, bf16, seeded init "
          f"{time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    spec = SpecConfig(k=SERVE_K, w=SERVE_W, strategy="mixed")
    t0 = time.perf_counter()
    eng = ServingEngine(params, cfg, spec, buckets=(SERVE_BUCKET,))
    sync()
    print(f"  n-gram tables (bigram sweep over {cfg.vocab_size} tokens): "
          f"{time.perf_counter() - t0:.2f} s")
    tables = eng.tables
    prompts = smoke_prompts()

    # ---- 7a: static, the hybrid's main path ----
    print("phase 7a: static serving (8 requests, bucket 256, 64 new tokens)")
    runs, rates = {}, {}
    for name, e in (("mixed", eng), ("greedy", ServingEngine(
            params, cfg, SpecConfig(strategy="greedy"),
            buckets=(SERVE_BUCKET,)))):
        torch.cuda.reset_peak_memory_stats()
        reset_launches()              # counts from zero just before the run
        done, wall = serve(e, prompts, SERVE_NEW)
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated() / 2**30
        n_new = sum(r.stats["new_tokens"] for r in done)
        calls = sum(r.stats["model_calls"] for r in done)
        rates[name] = (f"{n_new} new tokens in {wall:.3f} s = "
                       f"{n_new / wall:.1f} tokens/s, tokens/call "
                       f"{n_new / max(calls, 1):.3f}")
        print(f"  {name}: {rates[name]}, {calls} calls, peak memory "
              f"{peak:.2f} GiB, launches {launches}")
        if any(r.stats["new_tokens"] != SERVE_NEW for r in done):
            raise AssertionError("a hybrid request did not reach its budget")
        runs[name] = (done, launches)
    k5 = runs["mixed"][1]
    if min(k5["mamba_scan"], k5["spec_attention"], k5["ngram_match"]) <= 0:
        raise AssertionError(f"a kernel of the hybrid's path never "
                             f"launched: {k5}")
    if runs["greedy"][1]["mamba_scan"] <= 0:
        raise AssertionError("the greedy hybrid run did not launch K5")
    same = [bool(np.array_equal(a.output_ids, b.output_ids))
            for a, b in zip(runs["mixed"][0], runs["greedy"][0])]
    print(f"  bf16 mixed == bf16 greedy for {sum(same)} of {len(same)} "
          f"requests")
    n = len(prompts)
    half = [i < n // 2 for i in range(n)]
    print(f"phase 7a, sampled: requests 0-{n // 2 - 1} sampled (temperature "
          f"{SAMPLE_T}, top_p {SAMPLE_P}), twice")
    sruns = []
    for _ in range(2):
        e = ServingEngine(params, cfg, spec, tables=tables,
                          buckets=(SERVE_BUCKET,))
        reset_launches()
        done, wall = serve_sampled(e, prompts, [SERVE_NEW] * n, half)
        launches = read_launches()
        print(f"  {rate_line(done, wall, half)}; {wall:.3f} s, launches "
              f"{launches}")
        if min(launches["mamba_scan"], launches["spec_attention"],
               launches["ngram_match"]) <= 0:
            raise AssertionError(f"sampled hybrid run missed a kernel: "
                                 f"{launches}")
        sruns.append(done)
    check_replay("7a sampled", sruns,
                 [r.output_ids for r in runs["mixed"][0]], half)

    # ---- 7b: profile ----
    print("phase 7b: where a hybrid step's time goes (torch.profiler, 8 "
          "prompts, static)")
    profile_steps(params, cfg, spec, tables, prompts, steps=3,
                  label="hybrid mixed step", focus="mamba_scan")
    profile_steps(params, cfg, SpecConfig(strategy="greedy"), None, prompts,
                  steps=3, label="hybrid greedy step", focus="mamba_scan")

    # ---- 7c: continuous ----
    print(f"phase 7c: continuous batching ({CONT_N} requests, "
          f"{CONT_SLOTS} slots, {CONT_PAGES}-page pool)")
    work = cont_workload()
    cont = {}
    for strategy, paged in (("mixed", True), ("mixed", False),
                            ("greedy", True)):
        sp = SpecConfig(k=SERVE_K, w=SERVE_W, strategy=strategy)
        e = cont_engine(params, cfg, sp,
                        tables if strategy == "mixed" else None, paged)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        done, wall = serve_continuous(e, work)
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated() / 2**30
        name = f"{'paged' if paged else 'linear'} {strategy}"
        rates[name] = cont_rate(done, wall)
        print(f"  {name}: {rates[name]}, peak memory {peak:.2f} GiB, "
              f"launches {launches}")
        if paged:
            check_paged_run(e, done, work)
            if launches["paged_spec_attention"] <= 0 \
                    or launches["spec_attention"] != 0:
                raise AssertionError(f"paged hybrid run not carried by K3:"
                                     f" {launches}")
        else:
            check_budgets(done, work)
        if launches["mamba_scan"] <= 0:
            raise AssertionError(f"continuous hybrid run without K5: "
                                 f"{launches}")
        cont[strategy, paged] = done
    same = [bool(np.array_equal(a.output_ids, b.output_ids))
            for a, b in zip(cont["mixed", True], cont["mixed", False])]
    print(f"  bf16 mixed: paged == linear for {sum(same)} of {len(same)} "
          f"requests")
    if not all(same):
        raise AssertionError("bf16 hybrid paged differs from linear")
    adaptive = hybrid_adaptive(params, cfg, tables, prompts, work, rates)
    contract_check("13a hybrid", ("hybrid",), params, cfg)
    del eng, e, params
    torch.cuda.empty_cache()

    # ---- 7d: lossless in f32 ----
    print("phase 7d: lossless (f32, TF32 off)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = dataclasses.replace(cfg, param_dtype=torch.float32,
                                compute_dtype=torch.float32)
    params32 = M.init_params(cfg32, seed=0, device="cuda")
    lprompts = prompts[:LOSSLESS_REQUESTS]
    e = ServingEngine(params32, cfg32, spec, tables=tables,
                      buckets=(SERVE_BUCKET,))
    tok_fn = lambda p: e.scheduler.pad_to_bucket(e.tok.encode(p))
    done, _ = serve(e, lprompts, LOSSLESS_NEW)
    ref = check_lossless(params32, cfg32, done, lprompts, tok_fn,
                         LOSSLESS_NEW, "hybrid static")
    e = ServingEngine(params32, cfg32, spec, tables=tables,
                      max_batch=CONT_SLOTS, buckets=(SERVE_BUCKET,),
                      max_new_cap=LOSSLESS_NEW, paged=True,
                      num_pages=CONT_PAGES, page_size=CONT_PAGE)
    done, _ = serve_continuous(e, [(p, LOSSLESS_NEW) for p in lprompts])
    print(f"    pool: {check_pool_drained(e)}")
    check_lossless(params32, cfg32, done, lprompts, tok_fn, LOSSLESS_NEW,
                   "hybrid continuous paged", ref=ref)   # the same oracle
    del params32, e
    torch.cuda.empty_cache()
    return k5, adaptive


def hybrid_adaptive(params, cfg, tables, prompts, work, rates) -> dict:
    """Phase 7e: the hybrid under ``DEFAULT_ARMS``: static serve_all of
    phase 3's 8 requests as 4 batches of 2 (one arm a batch, a dedicated
    spec), then continuous paged over phase 5's mix (one arm a slot a step,
    every slot verified at the table's maxima), beside 7a's and 7c's runs.
    Returns the kernels' launches on each path, by run."""
    import torch
    from repro_torch.core.controller import DEFAULT_ARMS
    from repro_torch.core.spec_engine import SpecConfig
    from repro_torch.serving.engine import ServingEngine
    t_phase = time.perf_counter()
    print(f"phase 7e: the hybrid adaptive over {DEFAULT_ARMS}")
    spec = SpecConfig(k=SERVE_K, w=SERVE_W, strategy="mixed")
    by_run = {}
    eng = ServingEngine(params, cfg, spec, tables=tables, max_batch=2,
                        buckets=(SERVE_BUCKET,), adaptive=True)
    log = recorded_arms(eng)
    reset_launches()
    done, wall = serve(eng, prompts, SERVE_NEW)
    launches = read_launches()
    by_run["7e static"] = launches
    n_new = sum(r.stats["new_tokens"] for r in done)
    calls = sum(r.stats["model_calls"] for r in done)
    print(f"  static adaptive (4 batches of 2): {n_new} new tokens in "
          f"{wall:.3f} s = {n_new / wall:.1f} tokens/s, tokens/call "
          f"{n_new / max(calls, 1):.3f}, launches {launches}")
    for i, (arm, tpc) in enumerate(log):
        print(f"    batch {i}: arm {arm}, tokens/call {tpc:.3f}")
    for name in ("mixed", "greedy"):
        print(f"  (7a, 8 requests in one batch) {name}: {rates[name]}")
    if any(r.stats["new_tokens"] != SERVE_NEW for r in done):
        raise AssertionError("a hybrid adaptive request missed its budget")
    if min(launches["mamba_scan"], launches["spec_attention"]) <= 0:
        raise AssertionError(f"static adaptive hybrid missed K5/K1: "
                             f"{launches}")
    eng = cont_engine(params, cfg, spec, tables, True, adaptive=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    done, wall = serve_continuous(eng, work)
    launches = read_launches()
    by_run["7e continuous paged"] = launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"  continuous paged adaptive: {cont_rate(done, wall)}, peak "
          f"memory {peak:.2f} GiB, launches {launches}")
    print(f"    pulls per arm {arm_pulls_line(eng.adaptive_stats())}")
    for name in ("paged mixed", "paged greedy"):
        print(f"  (7c) {name}: {rates[name]}")
    check_paged_run(eng, done, work)
    if min(launches["mamba_scan"], launches["paged_spec_attention"],
           launches["ngram_match"]) <= 0:
        raise AssertionError(f"continuous adaptive hybrid missed a kernel: "
                             f"{launches}")
    print(f"  phase 7e took {time.perf_counter() - t_phase:.1f} s")
    return by_run


# ---------------------------------------------------------------------------
# phase 2f: K1 and K3 at the head shapes of the registry's other archs
# ---------------------------------------------------------------------------
ARCH_HEADS = (  # arch, H, KV, hd
    ("gemma-2b", 8, 1, 256), ("glm4-9b", 32, 2, 128),
    ("nemotron-4-340b", 96, 8, 192), ("qwen2-vl-72b", 64, 8, 128),
    ("deepseek-moe-16b", 16, 16, 128))
PTXAS = {}           # kernel instance -> its -Xptxas -v report (phase 1)


def mma_instance(H, KV, hd, KW1, paged: bool) -> str:
    """The bf16 verify kernel's instance for these heads (the rule of
    ``launch_mma_hd`` in csrc/spec_attention.cu) with its ptxas report."""
    cap = 64 if hd <= 64 else 128 if hd <= 128 else 256
    mf = 2 if hd <= 128 and (H // KV) * KW1 > 64 else 1
    name = f"spec_attention_mma_kernel<{cap}, {mf}, {int(paged)}>"
    return f"{name}: {PTXAS.get(name, 'no ptxas report')}"


def check_bf16_k1(label, out, want, ops, W1):
    """Phase 2's bf16 check at a verify shape: within K1_SPLIT_ERR of the
    plain version, or, where one output ulp exceeds it, within
    K1_EXCESS_ERR of the plain version's own rounding with the control
    above that limit (phase 2e's rule)."""
    _, err = close(out, want, TOL["bfloat16"])
    print(f"    bf16 vs its plain version {err:.4g} (K1_SPLIT_ERR "
          f"{K1_SPLIT_ERR})")
    if err <= K1_SPLIT_ERR:
        return
    excess, control = k1_rounding_split(out, want, ops, W1)
    if not excess <= K1_EXCESS_ERR < control:
        raise AssertionError(
            f"bf16 K1 at {label}: {excess} beyond the plain version's "
            f"rounding, control {control}; the limit {K1_EXCESS_ERR} must "
            f"lie between them")


def phase_arch_kernels(S_main: int, cur_main: list, cont_cur: list) -> None:
    """Phase 2f: K1 and K3 against their plain versions (f32 2e-5, bf16
    2e-2 and phase 2's K1_SPLIT_ERR rule; K3 bit for bit K1 on the
    gathered view) at the verify (B 8, K 10, W1 11, S 332, ragged cur_len)
    and decode (KW1 1) shapes of Gemma-2B's, GLM-4-9B's, Nemotron-4's,
    Qwen2-VL's and DeepSeek-MoE-16B's heads; the bf16 ones timed by events
    and device ms beside their bound and SDPA, with their instance's
    registers and spills."""
    import torch
    from repro_torch.kernels.ref import gather_pages
    from repro_torch.kernels.spec_attention import (
        paged_spec_attention_cuda, paged_spec_attention_plain,
        spec_attention_cuda, spec_attention_plain)
    t_phase = time.perf_counter()
    for arch, H, KV, hd in ARCH_HEADS:
        for kind, K, W1 in (("verify", SERVE_K, SERVE_W + 1),
                            ("decode", 1, 1)):
            for dtype in (torch.float32, torch.bfloat16):
                dname = str(dtype).replace("torch.", "")
                ops = k1_inputs(8, K, W1, H, KV, hd, S_main, cur_main, dtype,
                                seed=41 + hd + K)
                out = spec_attention_cuda(*ops, w1=W1)
                want = spec_attention_plain(*ops, w1=W1)
                ok, e = close(out, want, TOL[dname])
                pops = k3_inputs(8, K, W1, H, KV, hd, CONT_PAGE, cont_cur,
                                 dtype, seed=43 + hd + K)
                q, kp, vp, pt, kt, vt, cur = pops
                pout = paged_spec_attention_cuda(*pops, w1=W1)
                pok, pe = close(pout, paged_spec_attention_plain(
                    *pops, w1=W1), TOL[dname])
                k_lin, v_lin = gather_pages(kp, vp, pt)
                same = torch.equal(pout, spec_attention_cuda(
                    q, k_lin, v_lin, kt, vt, cur, w1=W1))
                print(f"  {arch:15s} {kind} {dname:8s} B=8 K={K} W1={W1} "
                      f"H={H} KV={KV} hd={hd}: K1 S={S_main} max_abs_err="
                      f"{e:.4g} {'ok' if ok else 'FAIL'}; K3 ps={CONT_PAGE}"
                      f" max_abs_err={pe:.4g} {'ok' if pok else 'FAIL'}, =="
                      f" K1 on the gathered view {'ok' if same else 'FAIL'}")
                if not (ok and pok and same):
                    raise AssertionError(f"K1/K3 at {arch}'s {kind} shape "
                                         f"({dname}) disagree")
            if kind == "verify":
                check_bf16_k1(f"{arch}'s verify shape", out, want, ops, W1)
            for name, fn, plain, lib_ops, bound, err in (
                    ("K1", lambda: spec_attention_cuda(*ops, w1=W1),
                     lambda: spec_attention_plain(*ops, w1=W1), ops,
                     k1_bound_ms(ops[0], ops[1], ops[3], ops[5], W1), e),
                    ("K3", lambda: paged_spec_attention_cuda(*pops, w1=W1),
                     lambda: paged_spec_attention_plain(*pops, w1=W1),
                     (q, k_lin, v_lin, kt, vt, cur),
                     k3_bound_ms(q, kp, pt, kt, cur, W1), pe)):
                lib_fn, _ = sdpa_yardstick(*lib_ops, W1)
                r = timed(f"{name} {arch} {kind} (bf16)", fn, lib_fn,
                          dict(max_abs_err=err, bound_ms=bound[0],
                               bound_by=bound[1],
                               plain_ms=time_ms(plain, iters=5, warmup=1)))
                print(f"    plain_ms={r['plain_ms']:.4f} bound_ms="
                      f"{bound[0]:.5f} ({bound[1]}); "
                      f"{mma_instance(H, KV, hd, K * W1, name == 'K3')}")
    print(f"  phase 2f took {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# phase 10: the registry's other attention-only architectures
# ---------------------------------------------------------------------------
ARCH_RUNS = (("10c", "gemma-2b"), ("10d", "glm4-9b"),
             ("10e", "nemotron-4-340b"), ("10e", "qwen2-vl-72b"))
# of 18, 40, 96 and 80 layers
ARCH_DEPTH = {"gemma-2b": 4, "glm4-9b": 5, "nemotron-4-340b": 1,
              "qwen2-vl-72b": 2}         # Nemotron-4: 2 until phase 15
ARCH_F32_DEPTH = {"nemotron-4-340b": 1}                  # others: 2
MISTRAL_DEPTH, LONG_DEPTH = 4, 4     # 10a-10b of 32 layers, 10g of 24
BIGRAM_BATCH = 2048          # the tables' sweep batch for vocabularies
RING_CHARS, RING_BUCKET, RING_NEW = 4200, 4224, 64      # 10b: 4096-slot ring
LONG_BUCKET, LONG_NEW = 8192, 64                        # 10g: 8192-slot ring
HUBERT_FRAMES = (2, 1024)
HUBERT_REL_TOL = 5e-2        # bf16 against f32 logits, relative (Frobenius)


def arch_config(arch: str, layers: int = 0, f32: bool = False):
    """The published config, cut to ``layers`` when given, in f32 when
    asked (bf16 otherwise)."""
    import torch
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    if f32:
        cfg = dataclasses.replace(cfg, param_dtype=torch.float32,
                                  compute_dtype=torch.float32)
    return cfg


def load_model(cfg, seed: int = 0):
    """Seeded parameters on the card, after a fresh peak-memory count (an
    earlier model's engines may sit in reference cycles: collect them
    first, so that its weights are gone)."""
    import gc
    import torch
    from repro_torch.models import model as M
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_params(cfg, seed=seed, device="cuda")
    sync()
    print(f"  {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"H={cfg.num_heads} KV={cfg.num_kv_heads} hd="
          f"{cfg.resolved_head_dim}, vocab {cfg.vocab_size}, "
          f"{cfg.param_count() / 1e9:.3f}B params "
          f"{str(cfg.param_dtype)[6:]}, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB, seeded init "
          f"{time.perf_counter() - t0:.1f} s")
    return params


def peak_line(label: str) -> None:
    import torch
    print(f"  {label}: peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB")


def arch_tables(params, cfg, batch: int = BIGRAM_BATCH):
    """The mixed strategy's n-gram tables (k_max 25, w_max 16), by one
    sweep over the vocabulary at ``batch`` tokens a forward, where a
    default ServingEngine sweeps 256 at a time.  In bf16 the two batches
    give different tables (the matmuls' reduction order follows the
    batch: 255,961 of Gemma-2B's 512,000 top-k and chain rows differ,
    ROADMAP queue 3).  That is acceptable here because the tables only
    propose drafts: verification decides every served token, so no check
    of this phase depends on which tables were built."""
    from repro_torch.core.spec_engine import SpecConfig
    from repro_torch.serving.engine import ServingEngine
    eng = ServingEngine(params, cfg, SpecConfig(strategy="greedy"),
                        buckets=(SERVE_BUCKET,))
    t0 = time.perf_counter()
    tables = eng.build_tables(k_max=25, w_max=16, batch=batch)
    sync()
    print(f"  n-gram tables (bigram sweep over {cfg.vocab_size} tokens, "
          f"batch {batch}): {time.perf_counter() - t0:.2f} s")
    return tables


def mixer_counts(cfg) -> tuple:
    """(attention layers, Mamba layers) of ``cfg``."""
    from repro_torch.models.config import ATTN, MAMBA, layer_blocks
    blocks = layer_blocks(cfg)
    return (sum(b.mixer == ATTN for b in blocks),
            sum(b.mixer == MAMBA for b in blocks))


def expected_launches(cfg, steps: int, calls_a_step: int, paged: bool,
                      prefills: int = 0) -> dict:
    """What ``steps`` steps of ``calls_a_step`` model calls each (2 for a
    recurrent stack's verify + gated replay, else 1) launch: each attention
    layer's call K3 (paged), K1 (linear, inside K1's contract) or the plain
    verify, never the other two; each Mamba layer's K5, also in each of
    ``prefills`` prefills."""
    from repro_torch.kernels.dispatch import verify_kernel_supported
    n_attn, n_mamba = mixer_counts(cfg)
    per = steps * calls_a_step * n_attn
    kernel = verify_kernel_supported(cfg)
    return {"spec_attention": per if kernel and not paged else 0,
            "paged_spec_attention": per if paged else 0,
            "plain_verify": 0 if kernel else per,
            "mamba_scan": n_mamba * (prefills + steps * calls_a_step)}


def check_launches(label: str, launches: dict, plain: int,
                   want: dict) -> None:
    got = {k: launches[k] for k in want if k != "plain_verify"}
    got["plain_verify"] = plain
    if got != want:
        raise AssertionError(f"{label}: launches {got}, want {want}")


def drop_line(cfg, label: str, counts):
    """The dropped token-slots ``counts`` (``moe.count_drops``) holds, for
    a config with MoE layers (None otherwise), recorded in DROPS and
    printed."""
    from repro_torch.models.config import MOE, layer_blocks
    calls, dropped, most = counts.read()
    if not any(b.mlp == MOE for b in layer_blocks(cfg)):
        return None
    DROPS[label] = (calls, dropped, most)
    print(f"    {label}: dropped token-slots {dropped} in {calls} MoE-layer "
          f"calls (capacity factor {cfg.capacity_factor}): mean "
          f"{dropped / max(calls, 1):.2f}, max {most} a call")
    return calls, dropped, most


def arch_static(params, cfg, tables, prompts, label: str, runs: dict,
                max_new: int = SERVE_NEW, bucket: int = SERVE_BUCKET,
                rates: dict = None):
    """Static mixed (10, 10) beside greedy on ``prompts``: tokens/s,
    tokens/call, launches and plain-verify calls; asserts each step went
    through the path the config's contract gives it (``expected_launches``:
    K1 or the plain verify in each attention layer, steps x layers times,
    twice a mixed step for a recurrent stack, which replays its winner; K5
    in each Mamba layer) and K2 once a mixed step.  An MoE config's dropped
    token-slots are counted (``drop_line``).  Records each run's launches
    in ``runs`` and, given ``rates``, its (tokens/s, tokens/call) there;
    returns the mixed run's requests."""
    import numpy as np
    import torch
    from repro_torch.core.spec_engine import SpecConfig
    from repro_torch.models import attention as A
    from repro_torch.models import model as M
    from repro_torch.models import moe
    from repro_torch.serving.engine import ServingEngine
    out = {}
    for name in ("mixed", "greedy"):
        spec = (SpecConfig(k=SERVE_K, w=SERVE_W, strategy="mixed")
                if name == "mixed" else SpecConfig(strategy="greedy"))
        eng = ServingEngine(params, cfg, spec, buckets=(bucket,),
                            tables=tables if name == "mixed" else None)
        reset_launches()              # counts from zero just before the run
        A.plain_verify.calls = 0
        with moe.count_drops() as drops:
            done, wall = serve(eng, prompts, max_new)
        launches, plain = read_launches(), A.plain_verify.calls
        n_new = sum(r.stats["new_tokens"] for r in done)
        calls = sum(r.stats["model_calls"] for r in done)
        steps = max(r.stats["model_calls"] for r in done)
        print(f"  {label} {name}: {n_new} new tokens in {wall:.3f} s = "
              f"{n_new / wall:.1f} tokens/s, tokens/call "
              f"{n_new / max(calls, 1):.3f}, {steps} steps, launches "
              f"{launches}, plain-verify calls {plain}")
        drop_line(cfg, f"{label} {name}", drops)
        if any(r.stats["new_tokens"] != max_new for r in done):
            raise AssertionError(f"{label} {name}: a request missed its "
                                 f"budget")
        replays = 2 if name == "mixed" and M.has_recurrent(cfg) else 1
        check_launches(f"{label} {name}", launches, plain,
                       expected_launches(cfg, steps, replays, paged=False,
                                         prefills=1))
        if name == "mixed" and launches["ngram_match"] != steps:
            raise AssertionError(f"{label}: K2 launched "
                                 f"{launches['ngram_match']} times in "
                                 f"{steps} drafting steps")
        runs[f"{label} {name}"] = launches
        if rates is not None:
            rates[name] = (n_new / wall, n_new / max(calls, 1))
        out[name] = done
    same = sum(bool(np.array_equal(a.output_ids, b.output_ids))
               for a, b in zip(out["mixed"], out["greedy"]))
    print(f"  {label}: {str(cfg.compute_dtype)[6:]} mixed == greedy for "
          f"{same} of "
          f"{len(prompts)} requests")
    torch.cuda.synchronize()
    return out["mixed"]


def arch_continuous(params, cfg, tables, label: str, runs: dict,
                    paged: bool = True, n: int = CONT_N) -> None:
    """The first ``n`` requests of phase 5's mix, continuous mixed (10, 10)
    over the 16-page pool (``paged``) or the linear cache: each step's
    verify layers on their path (``expected_launches``: K3 when paged),
    K2 once a step; the pool drains (deferring when all 24 requests
    come)."""
    from repro_torch.core.spec_engine import SpecConfig
    from repro_torch.models import attention as A
    from repro_torch.models import model as M
    from repro_torch.models import moe
    work = cont_workload()[:n]
    eng = cont_engine(params, cfg, SpecConfig(k=SERVE_K, w=SERVE_W,
                                              strategy="mixed"), tables,
                      paged)
    layout = "paged" if paged else "linear"
    reset_launches()
    A.plain_verify.calls = 0
    with moe.count_drops() as drops:
        done, wall = serve_continuous(eng, work)
    launches, plain = read_launches(), A.plain_verify.calls
    print(f"  {label} continuous {layout} mixed ({n} requests): "
          f"{cont_rate(done, wall)}, launches {launches}, plain-verify "
          f"calls {plain}")
    drop_line(cfg, f"{label} continuous {layout}", drops)
    if paged:
        check_paged_run(eng, done, work, deferrals=n == CONT_N)
    else:
        check_budgets(done, work)
    steps = launches["ngram_match"]
    if steps <= 0:
        raise AssertionError(f"{label} continuous: K2 never launched")
    check_launches(f"{label} continuous {layout}", launches, plain,
                   expected_launches(cfg, steps,
                                     2 if M.has_recurrent(cfg) else 1,
                                     paged=paged, prefills=n))
    runs[f"{label} continuous {layout}"] = launches


def arch_lossless(arch: str, tables, prompts, max_new: int, label: str,
                  layers: int, bucket: int = SERVE_BUCKET, pad_to: int = 0,
                  base=None) -> None:
    """``base`` (default the published config) cut to ``layers`` in f32
    (TF32 off), served statically mixed (10, 10) with ``tables``: greedy
    decoding up to f32 ties (``check_lossless``)."""
    import torch
    from repro_torch.core.spec_engine import SpecConfig
    from repro_torch.serving.engine import ServingEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = arch_config(arch) if base is None else base
    cfg32 = dataclasses.replace(cfg, num_layers=layers,
                                param_dtype=torch.float32,
                                compute_dtype=torch.float32)
    params32 = load_model(cfg32)
    eng = ServingEngine(params32, cfg32, SpecConfig(k=SERVE_K, w=SERVE_W,
                                                    strategy="mixed"),
                        tables=tables, buckets=(bucket,))
    done, wall = serve(eng, prompts, max_new)
    tok_fn = lambda p: eng.scheduler.pad_to_bucket(eng.tok.encode(p))
    check_lossless(params32, cfg32, done, prompts, tok_fn, max_new,
                   f"{label} ({layers} layer{'s' * (layers > 1)}) static "
                   f"mixed", pad_to=pad_to)
    peak_line(f"{label} f32")
    del params32, eng
    torch.cuda.empty_cache()


def mistral_verify_times(cfg, S_main: int, cur_main: list) -> None:
    """10a: at Mistral's verify shape (B 8, K 10, W1 11, H 32, KV 8, hd
    128, the main path's S and cur_len) the plain verify the model runs
    (its window is out of reach at S 332, so all three compute the same
    function), K1 and SDPA on the same bf16 inputs: outputs within bf16
    2e-2 of one another, events and device ms, one bound."""
    import torch
    from repro_torch.models.attention import _verify_attention_xla
    from repro_torch.kernels.spec_attention import spec_attention_cuda
    W1 = SERVE_W + 1
    ops = k1_inputs(8, SERVE_K, W1, 32, 8, 128, S_main, cur_main,
                    torch.bfloat16, seed=51)
    q, kc, vc, kt, vt, cl = ops
    slots = torch.arange(S_main, device="cuda")[None]
    cache_pos = torch.where(slots < cl[:, None], slots, -1).to(torch.int32)
    pos2d = cl[:, None].long() + torch.arange(W1, device="cuda")[None]
    plain = lambda: _verify_attention_xla(q, kc, vc, kt, vt, cache_pos,
                                          pos2d, cfg)
    lib_fn, lib_out = sdpa_yardstick(*ops, W1)
    k1_out = spec_attention_cuda(*ops, w1=W1)
    p_out = plain().to(torch.bfloat16)
    errs = [close(a, b, 2e-2) for a, b in ((k1_out, p_out), (lib_out, p_out))]
    bound, by = k1_bound_ms(q, kc, kt, cl, W1)
    print(f"  Mistral's verify shape B=8 K={SERVE_K} W1={W1} H=32 KV=8 "
          f"hd=128 S={S_main} (bf16): K1 vs the plain verify max_abs_err "
          f"{errs[0][1]:.4g}, SDPA vs it {errs[1][1]:.4g}; bound_ms="
          f"{bound:.5f} ({by})")
    if not all(ok for ok, _ in errs):
        raise AssertionError("K1, SDPA and the plain verify disagree at "
                             "Mistral's verify shape")
    for name, fn in (("plain verify (the model's path)", plain),
                     ("K1 on the same inputs", lambda: spec_attention_cuda(
                         *ops, w1=W1)),
                     ("SDPA on the same inputs", lib_fn)):
        print(f"    {name}: ms={time_ms(fn):.4f} device_ms="
              f"{fmt_ms(device_ms(fn))}")


def long_text(chars: int, seed: int) -> str:
    """A code prompt of ``chars`` bytes: the reference datasets' examples
    joined and repeated."""
    from repro_torch.data.datasets import make_prompts
    text = " ".join(p + c for p, c in make_prompts("code", 6, seed=seed))
    return ((text + " ") * (chars // len(text) + 1))[:chars]


def phase_mistral(S_main: int, cur_main: list, prompts, runs) -> None:
    """10a and 10b (see ``phase_archs``)."""
    import torch
    from repro_torch.core.spec_engine import SpecConfig
    from repro_torch.kernels.dispatch import verify_kernel_supported
    from repro_torch.models.cache import cache_buffer_len
    cfg = arch_config("mistral-7b", MISTRAL_DEPTH)
    assert not verify_kernel_supported(cfg), cfg.sliding_window
    print(f"phase 10a: Mistral-7B ({MISTRAL_DEPTH} of its 32 layers, full "
          f"width, bf16): the plain verify, static serving")
    mistral_verify_times(cfg, S_main, cur_main)
    params = load_model(cfg)
    tables = arch_tables(params, cfg, batch=256)
    arch_static(params, cfg, tables, prompts, "10a mistral-7b", runs)
    spec = SpecConfig(k=SERVE_K, w=SERVE_W, strategy="mixed")
    profile_steps(params, cfg, spec, tables, prompts, steps=3,
                  label="mistral mixed step")
    profile_steps(params, cfg, SpecConfig(strategy="greedy"), None, prompts,
                  steps=3, label="mistral greedy step")
    peak_line("mistral-7b bf16")
    ring = [long_text(RING_CHARS, 1), long_text(RING_CHARS, 2)]
    S = cache_buffer_len(cfg, RING_BUCKET + RING_NEW + SERVE_W + 2)
    print(f"phase 10b: Mistral's ring wraps ({len(ring)} prompts of "
          f"{RING_CHARS} bytes in bucket {RING_BUCKET}, {RING_NEW} new "
          f"tokens, a {S}-slot ring: wrapped in prefill and again under "
          f"speculation)")
    if S != cfg.sliding_window or RING_BUCKET <= S:
        raise AssertionError(f"the ring ({S} slots) would not wrap")
    arch_static(params, cfg, tables, ring, "10b mistral-7b ring", runs,
                max_new=RING_NEW, bucket=RING_BUCKET)
    peak_line("mistral-7b bf16 ring")
    contract_check("13a mistral-7b", ("window",), params, cfg)
    del params
    torch.cuda.empty_cache()
    arch_lossless("mistral-7b", tables, ring, RING_NEW, "10b mistral-7b ring",
                  layers=1, bucket=RING_BUCKET)


def phase_archs(S_main: int, cur_main: list, lm_tables) -> dict:
    """Phase 10: the registry's other attention-only archs at full width
    cut by depth (Mistral-7B to MISTRAL_DEPTH layers, the others as
    ARCH_DEPTH says, StableLM's long-context variant to LONG_DEPTH), bf16,
    seeded weights, one model at a time, each freed after.

    10a: Mistral-7B serves phase 3's 8 requests statically (mixed (10, 10)
    and greedy; profiled): its window keeps K1 off, so every verify layer
    is the plain verify (steps x layers calls) and K2 drafts; the plain
    verify's device ms beside K1 and SDPA at its verify shape.  10b: two
    ~4,200-byte prompts and 64 new tokens wrap its 4,096-slot ring in
    prefill and under speculation (bf16), then in f32 at depth
    1 the same requests are greedy decoding (``check_lossless``'s tie
    rule).  10c-10e: Gemma-2B, GLM-4-9B, Nemotron-4 and Qwen2-VL (M-RoPE)
    serve phase 3's requests statically (K1 steps x
    layers times), Gemma and GLM phase 5's mix continuously paged (K3),
    and in f32 (Nemotron at 1 layer, the others at 2) the static mixed
    outputs are greedy decoding.  10f: HuBERT-XLarge's encoder on 2 x 1024
    seeded frame embeddings, bf16 against f32 on the same weights.  10g:
    StableLM's long-context variant (an 8,192-slot ring): two 8,192-token
    prompts prefill through the blockwise attention, 64 new tokens wrap
    the ring; in f32 at depth 2 greedy decoding.  Returns each run's
    kernel launches."""
    import torch
    t_phase = time.perf_counter()
    runs: dict = {}
    prompts = smoke_prompts()
    t0 = time.perf_counter()
    phase_mistral(S_main, cur_main, prompts, runs)
    print(f"  phases 10a-10b took {time.perf_counter() - t0:.1f} s")
    for label, arch in ARCH_RUNS:
        t0 = time.perf_counter()
        layers = ARCH_DEPTH.get(arch, 0)
        cfg = arch_config(arch, layers)
        print(f"phase {label}: {arch} "
              f"({f'{layers} of its layers' if layers else 'full depth'}, "
              f"full width, bf16)")
        params = load_model(cfg)
        tables = arch_tables(params, cfg)
        if arch == "gemma-2b":
            small = arch_tables(params, cfg, batch=256)
            diff = sum(int((a != b).any(dim=-1).sum()) for a, b in (
                (tables.bigram_topk, small.bigram_topk),
                (tables.bigram_chain, small.bigram_chain)))
            print(f"    tables at batch {BIGRAM_BATCH} == batch 256: rows "
                  f"that differ {diff} of {2 * cfg.vocab_size}")
        arch_static(params, cfg, tables, prompts, f"{label} {arch}", runs)
        if arch in ("gemma-2b", "glm4-9b"):
            arch_continuous(params, cfg, tables, f"{label} {arch}", runs)
        if arch == "qwen2-vl-72b":
            contract_check(f"13a {arch}", ("mrope",), params, cfg)
        peak_line(f"{arch} bf16")
        del params
        torch.cuda.empty_cache()
        n = 2 if arch == "nemotron-4-340b" else LOSSLESS_REQUESTS
        arch_lossless(arch, tables, prompts[:n], LOSSLESS_NEW,
                      f"{label} {arch}", ARCH_F32_DEPTH.get(arch, 2))
        print(f"  phase {label} {arch} took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_hubert()
    print(f"  phase 10f took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_long_context(lm_tables, prompts, runs)
    print(f"  phase 10g took {time.perf_counter() - t0:.1f} s")
    print(f"  phase 10 took {time.perf_counter() - t_phase:.1f} s")
    return runs


def phase_hubert() -> None:
    """10f: HuBERT-XLarge (full width and depth, encoder-only, no decode
    path) from seeded frame embeddings: ``forward(embeds=)`` in bf16,
    against the same forward in f32 on the same (bf16) weights."""
    import torch
    from repro_torch.configs import supports_decode
    from repro_torch.models import model as M
    cfg = arch_config("hubert-xlarge")
    print(f"phase 10f: {cfg.name} (full, bf16; {HUBERT_FRAMES[0]} x "
          f"{HUBERT_FRAMES[1]} seeded frame embeddings)")
    assert not supports_decode(cfg)
    params = load_model(cfg)
    g = torch.Generator(device="cuda").manual_seed(5)
    emb = torch.randn(HUBERT_FRAMES + (cfg.d_model,), generator=g,
                      device="cuda")
    fwd = lambda: M.forward(params, cfg, embeds=emb)[0]
    logits = fwd()
    ms = time_ms(fwd, iters=5, warmup=1)
    cfg32 = dataclasses.replace(cfg, param_dtype=torch.float32,
                                compute_dtype=torch.float32)
    up = lambda t: {k: up(v) for k, v in t.items()} if isinstance(t, dict) \
        else t.float()
    params32 = up(params)
    want = M.forward(params32, cfg32, embeds=emb)[0]
    rel = float((logits - want).norm() / want.norm())
    print(f"  logits {tuple(logits.shape)}, finite "
          f"{bool(torch.isfinite(logits).all())}; bf16 forward {ms:.3f} ms "
          f"(events, 5 calls); bf16 vs f32 relative error {rel:.4g} "
          f"(limit {HUBERT_REL_TOL}), max abs "
          f"{float((logits - want).abs().max()):.4g} at max |logit| "
          f"{float(want.abs().max()):.4g}")
    if logits.shape != HUBERT_FRAMES + (cfg.vocab_size,) \
            or not bool(torch.isfinite(logits).all()) or rel > HUBERT_REL_TOL:
        raise AssertionError("HuBERT's bf16 logits are wrong")
    peak_line("hubert-xlarge")
    del params, params32
    torch.cuda.empty_cache()


def phase_long_context(tables, prompts, runs) -> None:
    """10g: ``long_context_variant`` of StableLM-2-1.6B (an 8,192-slot
    ring) at full width and LONG_DEPTH layers, bf16: a prefill of two
    8,192-token prompts through
    the blockwise attention (timed), then static mixed and greedy serving
    with 64 new tokens (the ring wraps; the plain verify carries every
    verify layer); in f32 at depth 2, 32 new tokens are greedy decoding
    (the oracle's buffers padded to whole 1,024-key blocks)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config, long_context_variant
    from repro_torch.data.tokenizer import ByteTokenizer
    from repro_torch.models import attention as A
    from repro_torch.models import model as M
    from repro_torch.serving.scheduler import Scheduler
    cfg = dataclasses.replace(long_context_variant(
        get_config("stablelm-1.6b")), num_layers=LONG_DEPTH)
    print(f"phase 10g: {cfg.name} (window {cfg.sliding_window}, "
          f"{LONG_DEPTH} of its 24 layers, full width, bf16): 2 prompts of "
          f"{LONG_BUCKET} tokens, {LONG_NEW} new")
    texts = [long_text(LONG_BUCKET, 3), long_text(LONG_BUCKET, 4)]
    real = A._blockwise_attention
    calls = []

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    A._blockwise_attention = counted
    try:
        params = load_model(cfg)
        toks = torch.as_tensor(np.stack(
            [Scheduler(buckets=(LONG_BUCKET,)).pad_to_bucket(
                ByteTokenizer().encode(t)) for t in texts]), device="cuda")
        state = M.init_state(cfg, 2, LONG_BUCKET + LONG_NEW + SERVE_W + 2)
        sync()
        t0 = time.perf_counter()
        logits, _ = M.prefill(params, cfg, state, tokens=toks,
                              last_only=True)
        sync()
        pre_ms = (time.perf_counter() - t0) * 1e3
        print(f"  prefill (2 x {LONG_BUCKET} tokens): {pre_ms:.1f} ms, "
              f"blockwise calls {len(calls)} ({cfg.num_layers} layers), "
              f"finite {bool(torch.isfinite(logits).all())}, ring slots "
              f"{state['groups']['p0']['k'].shape[2]}")
        peak_line("prefill")
        if len(calls) != cfg.num_layers or not bool(
                torch.isfinite(logits).all()):
            raise AssertionError("the long prefill did not run blockwise "
                                 "in every layer, or is not finite")
        del state, logits
        calls.clear()
        done = arch_static(params, cfg, tables, texts, "10g stablelm+swa",
                           runs, max_new=LONG_NEW, bucket=LONG_BUCKET)
        print(f"  blockwise calls while serving: {len(calls)}")
        if not calls or any(len(r.output_ids) != LONG_NEW for r in done):
            raise AssertionError("long-context serving missed the blockwise "
                                 "prefill")
        peak_line("stablelm+swa bf16")
        del params
        torch.cuda.empty_cache()
        arch_lossless("stablelm-1.6b", tables, texts, LOSSLESS_NEW,
                      "10g stablelm+swa", 2, bucket=LONG_BUCKET,
                      pad_to=A.BLOCKWISE_BLOCK, base=cfg)
    finally:
        A._blockwise_attention = real


# ---------------------------------------------------------------------------
# phase 11: training on the card, then serving the weights it trained
# ---------------------------------------------------------------------------
def bench_config():
    """The reference's benchmark model (``benchmarks/common.py``
    ``bench_config``): 2 layers, d_model 128, d_ff 256, 4 heads and 2 KV
    heads, the byte vocabulary (259), f32."""
    import torch
    from repro_torch.models.config import ModelConfig
    return ModelConfig(name="bench-tiny-31m", num_layers=2, d_model=128,
                       d_ff=256, num_heads=4, num_kv_heads=2, vocab_size=259,
                       param_dtype=torch.float32,
                       compute_dtype=torch.float32).validate()


def train_run(ts, cfg, batches, warmup: int, label: str,
              donate: bool = False):
    """AdamW steps (remat) of ``ts``, one a batch, on the device ``ts``
    lives on (``donate``: updated in place).  Returns (train state,
    per-step losses, seconds per step after the first, the first step's
    seconds)."""
    import torch
    from repro_torch.train import AdamWConfig, make_train_step
    steps = len(batches)
    step = make_train_step(cfg, AdamWConfig(
        lr=TRAIN_LR, total_steps=steps, warmup_steps=warmup), remat=True,
        donate=donate)
    card = ts["params"]["final_norm"]["scale"].is_cuda
    losses = []
    t0 = t1 = time.perf_counter()
    for i, b in enumerate(batches):
        ts, m = step(ts, b)
        losses.append(m["loss"])
        if i == 0:
            if card:
                sync()
            t1 = time.perf_counter()
    if card:
        sync()
    per_step = (time.perf_counter() - t1) / max(steps - 1, 1)
    losses = torch.stack(losses).cpu().tolist()
    print(f"  {label}: {steps} steps, loss " + " ".join(
        f"{i}:{losses[i]:.4f}" for i in sorted({*range(0, steps, 10),
                                               steps - 1})))
    return ts, losses, per_step, t1 - t0


def check_no_launch(label: str) -> None:
    """Training runs no kernel of ``kernels/``: every count still 0."""
    counts = read_launches()
    print(f"  {label}: kernel launches while training {counts}")
    if any(counts.values()):
        raise AssertionError(f"{label}: a kernel launched while training: "
                             f"{counts}")


def serve_trained(params, cfg, label: str, runs: dict, seeded=None) -> dict:
    """11c: tables from the model's weights by the engine's own build (a
    default ServingEngine's: 256 tokens a forward), phase 3's 8 requests
    statically mixed (10, 10) and greedy (``arch_static``: K1 steps x
    layers, K2 once a step), tokens/call and tokens/s beside greedy and,
    given ``seeded``, beside the same model's seeded reading.  Returns the
    tables and rates."""
    from repro_torch.core.spec_engine import SpecConfig
    from repro_torch.serving.engine import ServingEngine
    t0 = time.perf_counter()
    tables = ServingEngine(params, cfg, SpecConfig(k=SERVE_K, w=SERVE_W),
                           buckets=(SERVE_BUCKET,)).tables
    sync()
    print(f"  {label}: n-gram tables from the weights (the engine's own "
          f"build) {time.perf_counter() - t0:.2f} s")
    rates: dict = {}
    arch_static(params, cfg, tables, smoke_prompts(), label, runs,
                rates=rates)
    (mix_s, mix_c), (gr_s, _) = rates["mixed"], rates["greedy"]
    print(f"  {label}: trained mixed {mix_c:.3f} tokens/call, {mix_s:.1f} "
          f"tokens/s = {mix_s / gr_s:.2f}x greedy's {gr_s:.1f}"
          + ("" if seeded is None else
             f"; seeded {seeded['mixed'][1]:.3f} tokens/call, "
             f"{seeded['mixed'][0]:.1f} tokens/s, greedy "
             f"{seeded['greedy'][0]:.1f}"))
    return {"tables": tables, **rates}


def wide_tables_reading(params, cfg, own: float) -> None:
    """Trained StableLM's mixed (10, 10) run on phase 3's 8 requests again,
    over tables swept at BIGRAM_BATCH tokens a forward (``arch_tables``,
    the build of phases 10 and 12) in place of the engine's 256: how far
    the table build alone moves tokens/call on the same weights."""
    from repro_torch.core.spec_engine import SpecConfig
    from repro_torch.serving.engine import ServingEngine
    eng = ServingEngine(params, cfg, SpecConfig(k=SERVE_K, w=SERVE_W,
                                                strategy="mixed"),
                        tables=arch_tables(params, cfg),
                        buckets=(SERVE_BUCKET,))
    done, wall = serve(eng, smoke_prompts(), SERVE_NEW)
    calls = sum(r.stats["model_calls"] for r in done)
    print(f"  11c stablelm-1.6b trained, tables at batch {BIGRAM_BATCH}: "
          f"mixed {len(done) * SERVE_NEW / calls:.3f} tokens/call in "
          f"{wall:.2f} s (the engine's own build: {own:.3f})")


def trained_lossless(params32, cfg32, tables, n: int, max_new: int,
                     label: str) -> None:
    """f32 (TF32 off) static mixed (10, 10) on the first ``n`` of phase 3's
    requests equals ``greedy_reference`` token for token (phase 4's
    check)."""
    import numpy as np
    import torch
    from repro_torch.core.spec_engine import SpecConfig, greedy_reference
    from repro_torch.serving.engine import ServingEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    eng = ServingEngine(params32, cfg32, SpecConfig(k=SERVE_K, w=SERVE_W),
                        tables=tables, buckets=(SERVE_BUCKET,))
    prompts = smoke_prompts()[:n]
    done, wall = serve(eng, prompts, max_new)
    toks = np.stack([eng.scheduler.pad_to_bucket(eng.tok.encode(p))
                     for p in prompts])
    ref = greedy_reference(params32, cfg32, toks, max_new).cpu().numpy()
    check_equals_greedy(params32, cfg32, done, ref, SERVE_BUCKET)
    calls = sum(r.stats["model_calls"] for r in done)
    print(f"  {label}: f32 mixed == greedy_reference for {n} requests x "
          f"{max_new} tokens ({calls} verify calls, {n * max_new / calls:.3f}"
          f" tokens/call, {wall:.2f} s)")


def mixture(steps: int) -> list:
    """The reference's training batches: ``mixed_batches(8, 128, steps,
    seed=0)``."""
    from repro_torch.data.pipeline import mixed_batches
    return list(mixed_batches(TRAIN_B, TRAIN_T, steps, seed=0))


def phase_train_bench(runs: dict) -> None:
    """11a and 11c on the reference's benchmark model; its seeded weights
    are served first, as the trained ones' yardstick."""
    import torch
    from repro_torch.train import AdamWConfig, init_train_state
    from repro_torch.train import make_train_step
    from repro_torch.train.optimizer import tree_map
    cfg = bench_config()
    # seeded on the CPU and copied, so that the CPU's steps start from the
    # same weights (a CUDA generator draws other numbers)
    cpu_ts = init_train_state(cfg, seed=0, device="cpu")
    ts = tree_map(lambda t: t.to("cuda"), cpu_ts)
    print(f"  {cfg.name}: {cfg.param_count():,} params, f32, "
          f"B {TRAIN_B} x T {TRAIN_T}, lr {TRAIN_LR}, warmup {BENCH_WARMUP}")
    seeded = serve_trained(ts["params"], cfg, "11c bench seeded", runs)
    batches = mixture(BENCH_STEPS)
    reset_launches()
    ts, losses, per_step, first = train_run(ts, cfg, batches, BENCH_WARMUP,
                                            "11a card")
    check_no_launch("11a")
    print(f"  11a: {per_step * 1e3:.2f} ms a step after the first "
          f"({first:.2f} s), {TRAIN_B * TRAIN_T / per_step:.0f} training "
          f"tokens/s")
    step = make_train_step(cfg, AdamWConfig(
        lr=TRAIN_LR, total_steps=BENCH_STEPS, warmup_steps=BENCH_WARMUP))
    cpu = []
    for b in batches[:TRAIN_CHECK_STEPS]:
        cpu_ts, m = step(cpu_ts, b)
        cpu.append(float(m["loss"]))
    err = max(abs(a - b) / abs(b) for a, b in
              zip(losses[:TRAIN_CHECK_STEPS], cpu))
    print(f"  11a: card losses of steps 0-{TRAIN_CHECK_STEPS - 1} against "
          f"the CPU's: max relative difference {err:.3g} (limit "
          f"{TRAIN_CPU_TOL})")
    if err > TRAIN_CPU_TOL:
        raise AssertionError(f"11a: card {losses[:TRAIN_CHECK_STEPS]} != "
                             f"CPU {cpu}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"11a: the loss did not fall: {losses}")
    print("phase 11c: serving the bench model's trained weights")
    served = serve_trained(ts["params"], cfg, "11c bench", runs, seeded)
    trained_lossless(ts["params"], cfg, served["tables"], len(
        smoke_prompts()), SERVE_NEW, "11c bench")
    del ts, cpu_ts
    torch.cuda.empty_cache()


def phase_train_lm(runs: dict) -> None:
    """11b and 11c on StableLM-2-1.6B at full width and LM_TRAIN_DEPTH
    layers (bf16 params, f32 moments): its seeded weights served, then
    trained and served, then its trained weights in f32 and over tables
    swept at BIGRAM_BATCH; last, where a train step's time goes (after the
    serving readings: a profiler run slows the process's host path
    afterwards)."""
    import gc
    import tempfile
    import torch
    from repro_torch.configs import get_config
    from repro_torch.train import checkpoint, init_train_state
    from repro_torch.train.optimizer import tree_map
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(get_config("stablelm-1.6b"),
                              num_layers=LM_TRAIN_DEPTH)
    t0 = time.perf_counter()
    ts = init_train_state(cfg, seed=0, device="cuda")
    sync()
    print(f"  {cfg.name}: {LM_TRAIN_DEPTH} of its 24 layers, "
          f"{cfg.param_count() / 1e9:.3f}B params bf16, moments f32, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB, init "
          f"{time.perf_counter() - t0:.1f} s; B {TRAIN_B} x T {TRAIN_T}, "
          f"lr {TRAIN_LR}, remat")
    seeded = serve_trained(ts["params"], cfg, "11c stablelm-1.6b seeded",
                           runs)
    del seeded["tables"]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    warm = max(LM_TRAIN_STEPS // 10, 1)
    batches = mixture(LM_TRAIN_STEPS)
    ts, losses, per_step, first = train_run(ts, cfg, batches, warm,
                                            "11b card")
    check_no_launch("11b")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"  11b: {per_step * 1e3:.2f} ms a step after the first "
          f"({first:.2f} s), {TRAIN_B * TRAIN_T / per_step:.0f} training "
          f"tokens/s, peak memory {peak:.2f} GiB")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"11b: the loss did not fall: {losses}")
    params = ts["params"]
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".ckpt-") as tmp:
        path = os.path.join(tmp, "stablelm.npz")
        t0 = time.perf_counter()
        checkpoint.save(path, params)
        t_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = checkpoint.load(path, cfg, device="cuda")
        sync()
        t_load = time.perf_counter() - t0
        size = os.path.getsize(path) / 2**30
    flat, flat_back = [], []
    tree_map(flat.append, params)
    tree_map(flat_back.append, back)
    same = sum(a.dtype == b.dtype and torch.equal(a, b)
               for a, b in zip(flat, flat_back))
    print(f"  11b checkpoint: {size:.2f} GiB saved in {t_save:.1f} s, "
          f"loaded in {t_load:.1f} s; {same} of {len(flat)} leaves "
          f"bit-equal")
    if same != len(flat):
        raise AssertionError("11b: the checkpoint round trip changed a leaf")
    del back, flat, flat_back
    print("phase 11c: serving StableLM-2-1.6B's trained weights")
    served = serve_trained(params, cfg, "11c stablelm-1.6b", runs, seeded)
    wide_tables_reading(params, cfg, served["mixed"][1])
    params32 = tree_map(lambda t: t.float(), params)
    cfg32 = dataclasses.replace(cfg, param_dtype=torch.float32,
                                compute_dtype=torch.float32)
    trained_lossless(params32, cfg32, served["tables"], LOSSLESS_REQUESTS,
                     LOSSLESS_NEW, "11c stablelm-1.6b trained, upcast")
    del params32, served, params
    gc.collect()
    torch.cuda.empty_cache()
    train_step_breakdown(ts, cfg, batches[0], warm)
    del ts
    gc.collect()
    torch.cuda.empty_cache()


def train_step_breakdown(ts, cfg, batch, warm: int) -> None:
    """11b's step under torch.profiler (its results discarded), and the
    AdamW update alone by CUDA events beside its bound: each parameter's
    bf16 value and gradient read and value written, its f32 moments read
    and written, 22 bytes."""
    from repro_torch.train import AdamWConfig, make_train_step
    from repro_torch.train.optimizer import adamw_update, tree_leaves
    opt = AdamWConfig(lr=TRAIN_LR, total_steps=LM_TRAIN_STEPS,
                      warmup_steps=warm)
    step = make_train_step(cfg, opt, remat=True)
    print("phase 11b: where a train step's time goes (torch.profiler)")
    profile_window("11b train step", lambda: step(ts, batch), steps=3)
    params = ts["params"]
    n = sum(p.numel() for p in tree_leaves(params))
    ms = time_ms(lambda: adamw_update(opt, params, params, ts["opt"]),
                 iters=5, warmup=1)
    bound = 22 * n / HBM_BYTES_PER_S * 1e3
    print(f"  11b AdamW update alone: {ms:.2f} ms (CUDA events), bound "
          f"{bound:.2f} ms (22 bytes a parameter, bytes)")


def phase_cli() -> None:
    """11d: the port's two entry points as subprocesses: ``launch.train``
    saves StableLM's smoke model, ``launch.serve`` serves it from that file
    continuously over a paged cache (K3 launches)."""
    import tempfile
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".ckpt-") as tmp:
        path = os.path.join(tmp, "smoke.npz")
        runs = {
            "train": [sys.executable, "-m", "repro_torch.launch.train",
                      "--arch", "stablelm-1.6b", "--steps",
                      str(CLI_TRAIN_STEPS), "--save", path],
            # launch.serve's main, and K3's count after it
            "serve": [sys.executable, "-c",
                      "import sys\n"
                      "from repro_torch.launch import serve\n"
                      "from repro_torch.kernels.spec_attention import "
                      "paged_spec_attention_cuda as k3\n"
                      "serve.main(sys.argv[1:])\n"
                      "print('K3 launches', k3.launches)\n",
                      "--arch", "stablelm-1.6b", "--ckpt", path,
                      "--continuous", "--paged"]}
        for name, cmd in runs.items():
            t0 = time.perf_counter()
            out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                                 text=True, timeout=600)
            lines = out.stdout.strip().splitlines()
            print(f"  11d {name}: exit {out.returncode} in "
                  f"{time.perf_counter() - t0:.1f} s")
            for line in lines:
                print(f"    {line}")
            if out.returncode != 0:
                raise AssertionError(f"11d {name} failed:\n{out.stderr}")
    # the serve run's lines: one a request (4 by default), then K3's count
    reqs = [ln for ln in lines if ln.startswith("[req ")]
    k3 = int(lines[-1].split()[-1])
    if len(reqs) != 4 or "REJECTED" in out.stdout or k3 <= 0:
        raise AssertionError(f"11d serve: {len(reqs)} request lines, K3 "
                             f"{k3} launches")


def k5_bwd_bound_ms(Bt, T, di, ds, u_bytes, final) -> tuple:
    """Least time for K5's backward: u, dt, dy, B, C, A, D and h0 (and
    dhT) read once, du (in u's dtype), ddt, dA, dB, dC, dD and dh0 written
    once; per (row, step, channel, state) the a_t's exp once on the
    special-function units and 19 flops (6 of the forward's state, 13 of
    the reverse recurrence and its sums)."""
    n = Bt * T * di
    bytes_ = 2 * u_bytes * n + 4 * (3 * n + 4 * Bt * T * ds + 2 * di * ds
                                    + 2 * di + 2 * Bt * di * ds
                                    + (Bt * di * ds if final else 0))
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = max(19 * n * ds / PEAK_FLOPS["float32"],
                n * ds / SFU_PER_S) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def k5_ckpt_check(ops) -> None:
    """K5's training instance on ``ops`` (h0_rep 1): y and the final state
    the serving instance's bits, and each checkpoint (the state before
    every CHUNK-th step) the final state of K5 run on that prefix, bit for
    bit; prints its device ms beside the serving instance's."""
    import torch
    from repro_torch.kernels.mamba_scan import (CHUNK, mamba_scan_cuda,
                                                n_chunks)
    u, dt, A, B, C, D, h0 = ops
    Bt, T, di = u.shape
    ckpt = torch.empty((Bt, n_chunks(T), di, A.shape[-1]), device="cuda")
    y, hT, _ = mamba_scan_cuda(*ops, ckpt=ckpt)
    y0, hT0, _ = mamba_scan_cuda(*ops)
    same = [torch.equal(ckpt[:, 0], h0)]
    for c in range(1, n_chunks(T)):
        t = c * CHUNK
        same.append(torch.equal(ckpt[:, c], mamba_scan_cuda(
            u[:, :t].contiguous(), dt[:, :t].contiguous(), A, B[:, :t],
            C[:, :t], D, h0)[1]))
    if not (torch.equal(y, y0) and torch.equal(hT, hT0) and all(same)):
        raise AssertionError(f"K5's training instance: y {torch.equal(y, y0)}"
                             f", hT {torch.equal(hT, hT0)}, checkpoints "
                             f"{same}")
    ms = [device_ms(lambda: mamba_scan_cuda(*ops, ckpt=ckpt), iters=10),
          device_ms(lambda: mamba_scan_cuda(*ops), iters=10)]
    print(f"  K5 training instance Bt={Bt} T={T} di={di}: y and hT equal the "
          f"serving instance's, {len(same)} checkpoints equal K5's prefix "
          f"states (torch.equal); device ms {fmt_ms(ms[0])} against "
          f"{fmt_ms(ms[1])} without checkpoints")


def k5_bwd_check() -> dict:
    """11e: K5's backward against its plain version on the card, at the
    training shape (TRAIN_B x TRAIN_T, d_inner 16384, d_state 16) with bf16
    and f32 u, at a ragged T past a checkpoint's edge with a gradient into
    the final state, at 1 x 1024 steps (64 chunks of the pipeline) and at
    odd shapes: f32 relative K5_BWD_TOL on every gradient (du before its
    cast to u's dtype), and a second run bit-equal (no float atomics; the
    first takes the checkpoints of K5's training instance, as training
    does, the second makes its own).  K5's training instance against its
    serving one (``k5_ckpt_check``).  Then the backward's time at the
    training shape (bf16 u) beside its bound and its plain version's.
    Returns its record."""
    import torch
    from repro_torch.kernels.mamba_scan import (mamba_scan_bwd_cuda,
                                                mamba_scan_bwd_plain,
                                                mamba_scan_cuda, n_chunks)
    di, ds = 16384, 16
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [  # name, Bt, T, di, ds, u dtype, a gradient into hT, dt rank
        ("train", TRAIN_B, TRAIN_T, di, ds, bf16, False, 512),
        ("train f32 u", TRAIN_B, TRAIN_T, di, ds, f32, False, 512),
        ("ragged T", TRAIN_B, TRAIN_T - 1, di, ds, bf16, True, 512),
        ("T=1024", 1, 1024, di, ds, bf16, True, 512),
        ("T=37 di=200 ds=8", 3, 37, 200, 8, f32, True, 7),
        ("T=5 di=130 ds=3", 4, 5, 130, 3, bf16, False, 5)]
    err = 0.0
    for name, Bt, T, d_, s_, udt, final, dtr in cases:
        ops = k5_inputs(Bt, T, d_, s_, seed=Bt * 10 + T, dtr=dtr,
                        u_dtype=udt)
        g = torch.Generator(device="cuda").manual_seed(T)
        dy = torch.randn((Bt, T, d_), generator=g, device="cuda")
        dhT = (torch.randn((Bt, d_, s_), generator=g, device="cuda")
               if final else None)
        ckpt = torch.empty((Bt, n_chunks(T), d_, s_), device="cuda")
        mamba_scan_cuda(*ops, final=False, ckpt=ckpt)
        got = mamba_scan_bwd_cuda(*ops, dy, dhT, ckpt)
        again = mamba_scan_bwd_cuda(*ops, dy, dhT)
        want = mamba_scan_bwd_plain(*ops, dy, dhT)
        sync()
        rel = []
        for gname, a, b, c in zip(("du", "ddt", "dA", "dB", "dC", "dD",
                                   "dh0"), got, want, again):
            e = float((a - b).abs().max())
            r = e / float(b.abs().max())
            err = max(err, e)
            rel.append(f"{gname} {r:.2e}")
            if r > K5_BWD_TOL or not torch.equal(a, c):
                raise AssertionError(f"K5 backward {name}: {gname} off its "
                                     f"plain version by {r:.3g} (relative)"
                                     f" or not deterministic")
        print(f"  K5 backward {name:18s} Bt={Bt} T={T} di={d_} ds={s_} u "
              f"{str(udt)[6:]} dhT={final}: relative {', '.join(rel)} "
              f"(tol {K5_BWD_TOL}), second run bit-equal")
    ops = k5_inputs(TRAIN_B, TRAIN_T, di, ds, seed=5, u_dtype=bf16)
    k5_ckpt_check(ops)
    dy = torch.randn((TRAIN_B, TRAIN_T, di), device="cuda")
    ckpt = torch.empty((TRAIN_B, n_chunks(TRAIN_T), di, ds), device="cuda")
    mamba_scan_cuda(*ops, final=False, ckpt=ckpt)
    # the training call's: the forward's checkpoints handed over
    run = lambda: mamba_scan_bwd_cuda(*ops, dy, ckpt=ckpt)
    bound, by = k5_bwd_bound_ms(TRAIN_B, TRAIN_T, di, ds, 2, False)
    r = dict(max_abs_err=err, ms=time_ms(run, iters=10),
             device_ms=device_ms(run, iters=10),
             plain_ms=time_ms(lambda: mamba_scan_bwd_plain(*ops, dy),
                              iters=2, warmup=1),
             library_ms=None, bound_ms=bound, bound_by=by)
    print(f"  mamba_scan_bwd train (Bt={TRAIN_B}, T={TRAIN_T}, di={di}, "
          f"ds={ds}, u bf16): ms={r['ms']:.4f} (device "
          f"{fmt_ms(r['device_ms'])}) plain_ms={r['plain_ms']:.3f} "
          f"bound_ms={bound:.4f} ({by})"
          + (f", {bound / r['device_ms']:.1%} of the bound"
             if r["device_ms"] else ""))
    return r


def loss_and_grads(params, cfg, batch) -> dict:
    """The training loss of ``batch`` (remat) and its gradients, on the
    device ``params`` lie on: the loss, the global grad norm, each Mamba
    parameter's gradient (the leaves K5's backward feeds) and, under
    "grads", every gradient in ``tree_map`` form."""
    import torch
    from repro_torch.train.optimizer import global_norm, tree_map
    from repro_torch.train.train_loop import lm_loss
    dev = params["final_norm"]["scale"].device
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    leaves = []
    tree_map(leaves.append, live)
    with torch.enable_grad():
        loss, _ = lm_loss(live, cfg, torch.as_tensor(batch, device=dev),
                          remat=True)
        grads = torch.autograd.grad(loss, leaves)
    it = iter(grads)
    grads = tree_map(lambda _: next(it), params)
    out = {"loss": loss.detach(), "grad_norm": global_norm(grads)}
    for gid, g in grads.items():
        if "A_log" in g.get("mixer", {}):
            out.update({f"{gid}/{k}": v for k, v in g["mixer"].items()})
    out["grads"] = grads
    return out


def max_rel(a, b) -> float:
    """max |a - b| / max |b| of two tensors (any devices)."""
    a, b = a.float().cpu(), b.float().cpu()
    return float((a - b).abs().max() / max(float(b.abs().max()), 1e-30))


def phase_hybrid_train() -> tuple:
    """11e: the hybrid trains on the card.  K5's backward held against its
    plain version (``k5_bwd_check``); then Jamba at full width cut to two
    layers, ``no_experts(with_experts(config(), 2, 3), 1)`` (Mamba/SwiGLU
    and attention/SwiGLU, d_model 8192, d_inner 16384, vocab 65536; bf16
    params, f32 moments), HYB_TRAIN_STEPS steps of the reference's
    mixture with remat, the state donated (updated in place: two copies
    of it do not fit the card): ms a step, peak memory, the loss falling,
    and K5's forward twice and its backward once a Mamba layer a step
    (asserted; no other kernel), then two more steps under torch.profiler
    (K5's backward's share of the step); last, in f32 (TF32 off) on
    HYB_CHECK_ROWS x HYB_CHECK_T of each of HYB_CHECK_STEPS batches, the
    loss, the grad norm and every Mamba parameter's gradient equal the
    CPU's on the same weights within TRAIN_CPU_TOL (relative), the card's
    AdamW step between the two (the CPU takes the updated weights: its
    own AdamW over 2.853 B f32 parameters took minutes).  Returns (the
    backward's record, the training run's launches)."""
    import gc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.jamba_1_5_large_398b import (no_experts,
                                                           with_experts)
    from repro_torch.kernels.mamba_scan import mamba_scan_bwd_cuda
    from repro_torch.train import AdamWConfig, init_train_state
    from repro_torch.train.optimizer import adamw_update, tree_map
    t0 = time.perf_counter()
    rec = k5_bwd_check()
    t0 = took("11e's kernel checks", t0)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = no_experts(with_experts(get_config("jamba-1.5-large-398b"),
                                  *HYB_TRAIN), 1)
    n_mamba = sum(b.mixer == "mamba" for b in cfg.block_pattern)
    ts = init_train_state(cfg, seed=0, device="cuda")
    sync()
    print(f"  {cfg.name}: {[b.mixer + '/' + b.mlp for b in cfg.block_pattern]}"
          f", d_model {cfg.d_model}, Mamba d_inner {cfg.mamba_d_inner}, "
          f"vocab {cfg.vocab_size}, {cfg.param_count() / 1e9:.3f}B params "
          f"bf16, moments f32, {torch.cuda.memory_allocated() / 2**30:.2f} "
          f"GiB, init {time.perf_counter() - t0:.1f} s; B {TRAIN_B} x T "
          f"{TRAIN_T}, lr {TRAIN_LR}, remat")
    reset_launches()
    mamba_scan_bwd_cuda.launches = 0
    steps = HYB_TRAIN_STEPS
    # donated: with the functional update's second copy of the 26.6 GiB
    # state the step overflows the card (75.5 GiB allocated on an H100)
    ts, losses, per_step, first = train_run(
        ts, cfg, mixture(steps), max(steps // 10, 1), "11e card",
        donate=True)
    launches = dict(read_launches(), mamba_scan_bwd=mamba_scan_bwd_cuda
                    .launches)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"  11e: {per_step * 1e3:.2f} ms a step after the first "
          f"({first:.2f} s), {TRAIN_B * TRAIN_T / per_step:.0f} training "
          f"tokens/s, peak memory {peak:.2f} GiB; K5 a step: forward "
          f"{launches['mamba_scan'] / steps:g}, backward "
          f"{launches['mamba_scan_bwd'] / steps:g} ({n_mamba} Mamba layer); "
          f"launches {launches}")
    want = dict(mamba_scan=2 * n_mamba * steps,
                mamba_scan_bwd=n_mamba * steps)
    if any(launches[k] != n for k, n in want.items()) or any(
            v for k, v in launches.items() if k not in want):
        raise AssertionError(f"11e: launches {launches}, want {want} and "
                             f"no other kernel")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"11e: the loss did not fall: {losses}")
    # two more steps under torch.profiler (warm already): where a step's
    # device time goes, and K5's backward's share of it
    from repro_torch.train import make_train_step
    step = make_train_step(cfg, AdamWConfig(
        lr=TRAIN_LR, total_steps=steps + 2, warmup_steps=max(steps // 10, 1)),
        remat=True, donate=True)
    box, batch = [ts], mixture(steps)[-1]
    del ts

    def one_step():
        box[0] = step(box[0], batch)[0]
    print("phase 11e: where a hybrid train step's time goes (torch.profiler)")
    prof = profile_window("11e hybrid train step", one_step, steps=2,
                          focus="mamba_scan_bwd", warm=0)
    print(f"  11e: K5's backward (kernel and reduction) "
          f"{prof['focus_ms']:.3f} device ms a step, "
          f"{prof['focus_ms'] / max(prof['busy_ms'], 1e-9):.2%} of the "
          f"step's device-busy time")
    ts = box.pop()
    del ts
    gc.collect()
    torch.cuda.empty_cache()
    t0 = took("11e's bf16 training", t0)
    # f32 against the CPU: the card draws the weights, the CPU copies them
    cfg32 = dataclasses.replace(cfg, param_dtype=torch.float32,
                                compute_dtype=torch.float32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ts = init_train_state(cfg32, seed=0, device="cuda")
    opt = AdamWConfig(lr=TRAIN_LR, total_steps=HYB_CHECK_STEPS,
                      warmup_steps=1)
    worst = 0.0
    for i, b in enumerate(mixture(HYB_CHECK_STEPS)):
        b = b[:HYB_CHECK_ROWS, :HYB_CHECK_T + 1]
        t1 = time.perf_counter()
        cpu = tree_map(lambda t: t.cpu(), ts["params"])
        want = loss_and_grads(cpu, cfg32, b)
        t_cpu = time.perf_counter() - t1
        got = loss_and_grads(ts["params"], cfg32, b)
        rel = {k: max_rel(got[k], want[k]) for k in want if k != "grads"}
        worst = max([worst] + list(rel.values()))
        print(f"  11e f32 step {i}: loss card {float(got['loss']):.7f} CPU "
              f"{float(want['loss']):.7f}; relative differences "
              + ", ".join(f"{k} {v:.2e}" for k, v in rel.items())
              + f" (the CPU's side {t_cpu:.1f} s)")
        del cpu, want
        if i + 1 < HYB_CHECK_STEPS:     # the card's AdamW step, in place
            adamw_update(opt, ts["params"], got["grads"], ts["opt"],
                         donate=True)
            ts["opt"]["step"] += 1
        del got
    print(f"  11e: f32 card against the CPU over {HYB_CHECK_STEPS} steps of "
          f"{HYB_CHECK_ROWS} x {HYB_CHECK_T} tokens: max relative "
          f"difference {worst:.3g} (limit {TRAIN_CPU_TOL})")
    if worst > TRAIN_CPU_TOL:
        raise AssertionError("11e: the f32 card steps differ from the CPU's")
    del ts
    gc.collect()
    torch.cuda.empty_cache()
    took("11e's f32 check", t0)
    return rec, launches


def phase_train() -> tuple:
    """Phase 11 (see the module docstring).  Returns each serving run's
    kernel launches, and 11e's (K5's backward's record, its training
    run's launches)."""
    t_phase = time.perf_counter()
    runs: dict = {}
    hybrid = []
    for label, fn in (("11a", lambda: phase_train_bench(runs)),
                      ("11b", lambda: phase_train_lm(runs)),
                      ("11d", phase_cli),
                      ("11e", lambda: hybrid.extend(phase_hybrid_train()))):
        t0 = time.perf_counter()
        print(f"phase {label}")
        fn()
        print(f"  phase {label} took {time.perf_counter() - t0:.1f} s")
    print(f"  phase 11 took {time.perf_counter() - t_phase:.1f} s")
    return runs, tuple(hybrid)


# ---------------------------------------------------------------------------
# phase 12: the MoE FFN and the xLSTM mixers
# ---------------------------------------------------------------------------
MIXTRAL_DEPTH = 4              # of 32 layers; full width, all 8 experts
# cut by depth to hold the script's time once phases 11e and 15 ran in it:
# DeepSeek (12a) from its full 28 layers (then 14), xLSTM-125M (12d, 12e)
# from 12 (then 8) to one period of its pattern (3 mLSTM, 1 sLSTM)
DEEPSEEK_DEPTH, XLSTM_DEPTH = 7, 4
JAMBA_EXPERTS = (5, 0)         # with_experts(config(), 5): two MoE FFNs
JAMBA_EXPERTS_F32 = (3, 2)     # offsets 2-4: one MoE FFN, ~52 GB in f32
MOE_CONT_N = 8                 # the first 8 requests of phase 5's mix
# 12e's f32 depth: DeepSeek's dense layer 0 and one MoE layer; Mixtral's
# first layer, a MoE layer (2 layers until phase 15 joined the script)
MOE_F32_DEPTH = {"deepseek-moe-16b": 2, "mixtral-8x7b": 1}
RANGES = ("moe_ffn", "mlstm_mix", "slstm_mix")
DROPS: dict = {}               # run -> (MoE-layer calls, dropped, max a call)


def no_drop(cfg):
    """``cfg`` at capacity_factor E / K: C >= N at every N of a call, so
    no token-slot drops and a row's output is its own."""
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    return dataclasses.replace(cfg, name=f"{cfg.name}-cf{E}/{K}",
                               capacity_factor=E / K)


@contextlib.contextmanager
def named_ranges():
    """While active, the MoE FFN and the two xLSTM mixers run inside
    torch.profiler ranges named as in RANGES, so that a profile reads the
    device ms of the kernels each launches (``profile_window``)."""
    from torch.profiler import record_function
    from repro_torch.models import transformer as TR
    patched = ((TR.moe_lib, "apply_moe", "moe_ffn"),
               (TR.X, "mlstm_mix", "mlstm_mix"),
               (TR.X, "slstm_mix", "slstm_mix"))
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in patched]

    def ranged(fn, name):
        def call(*a, **kw):
            with record_function(name):
                return fn(*a, **kw)
        return call
    for (mod, attr, fn), (_, _, name) in zip(saved, patched):
        setattr(mod, attr, ranged(fn, name))
    try:
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def moe_serve(label: str, cfg, runs: dict, continuous=None,
              profile: bool = False, contract: str = ""):
    """One bf16 model of phase 12: seeded weights, its n-gram tables,
    static mixed and greedy (``arch_static``), continuous serving of
    MOE_CONT_N requests (``continuous``: True paged, False linear), a
    profiled mixed step, phase 13a's checks of the registry case
    ``contract``; freed after.  Returns its tables."""
    import torch
    from repro_torch.core.spec_engine import SpecConfig
    t0 = time.perf_counter()
    params = load_model(cfg)
    tables = arch_tables(params, cfg)
    prompts = smoke_prompts()
    arch_static(params, cfg, tables, prompts, label, runs)
    if continuous is not None:
        arch_continuous(params, cfg, tables, label, runs, paged=continuous,
                        n=MOE_CONT_N)
    if profile:
        with named_ranges():
            profile_steps(params, cfg, SpecConfig(k=SERVE_K, w=SERVE_W,
                                                  strategy="mixed"),
                          tables, prompts, steps=3,
                          label=f"{label} mixed step", ranges=RANGES)
    if contract:
        contract_check(f"13a {label.split()[1]}", (contract,), params, cfg)
    peak_line(f"{label} bf16")
    del params
    torch.cuda.empty_cache()
    print(f"  phase {label} took {time.perf_counter() - t0:.1f} s")
    return tables


def moe_capacity(arch: str, tables, label: str) -> None:
    """12e for a routed attention model at its MOE_F32_DEPTH, full
    width, f32 (TF32 off): phase 3's 8 requests x SERVE_NEW static
    mixed (10, 10), against ``greedy_reference``, at the default capacity
    (printed:
    the rows equal to it, each other row's first difference, the drops;
    nothing asserted, the reference's fault) and at capacity E / K (no
    drop, and every row equal to it: ``check_equals_greedy``)."""
    import numpy as np
    import torch
    from repro_torch.core.spec_engine import SpecConfig, greedy_reference
    from repro_torch.models import moe
    from repro_torch.serving.engine import ServingEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = arch_config(arch, MOE_F32_DEPTH[arch], f32=True)
    params = load_model(cfg)
    prompts = smoke_prompts()
    for c in (cfg, no_drop(cfg)):
        eng = ServingEngine(params, c, SpecConfig(k=SERVE_K, w=SERVE_W,
                                                  strategy="mixed"),
                            tables=tables, buckets=(SERVE_BUCKET,))
        with moe.count_drops() as drops:
            done, wall = serve(eng, prompts, SERVE_NEW)
        served = drop_line(c, f"{label} f32 {c.name} served", drops)
        toks = np.stack([eng.scheduler.pad_to_bucket(eng.tok.encode(p))
                         for p in prompts])
        with moe.count_drops() as drops:
            ref = greedy_reference(params, c, toks, SERVE_NEW).cpu().numpy()
        oracle = drop_line(c, f"{label} f32 {c.name} greedy_reference",
                           drops)
        equal = [bool(np.array_equal(r.output_ids, ref[i, SERVE_BUCKET:]))
                 for i, r in enumerate(done)]
        first = {i: int(np.argmax(r.output_ids != ref[i, SERVE_BUCKET:]))
                 for i, r in enumerate(done) if not equal[i]}
        calls = sum(r.stats["model_calls"] for r in done)
        print(f"  {label} f32 capacity factor {c.capacity_factor:.4g}: "
              f"{sum(equal)} of {len(done)} rows x {SERVE_NEW} == "
              f"greedy_reference; first differing new token per other row "
              f"{first}; tokens/call {len(done) * SERVE_NEW / calls:.3f},"
              f" {wall:.2f} s")
        if c is not cfg:
            if served[1] or oracle[1]:
                raise AssertionError(f"{label}: slots dropped at capacity "
                                     f"E / K: {served}, {oracle}")
            check_equals_greedy(params, c, done, ref, SERVE_BUCKET)
    peak_line(f"{label} f32")
    del params, eng
    torch.cuda.empty_cache()


def jamba_experts_f32(tables) -> None:
    """12e: Jamba with one MoE FFN (``with_experts(config(), 3, start=2)``,
    full width, f32, TF32 off) at capacity E / K: 4 requests x 32 static
    mixed are greedy decoding up to measured f32 ties (phase 7d's rule,
    ``check_lossless``), with no dropped slot."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.jamba_1_5_large_398b import with_experts
    from repro_torch.core.spec_engine import SpecConfig
    from repro_torch.models import moe
    from repro_torch.serving.engine import ServingEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    layers, start = JAMBA_EXPERTS_F32
    cfg = with_experts(get_config("jamba-1.5-large-398b"), layers, start)
    cfg = no_drop(dataclasses.replace(cfg, param_dtype=torch.float32,
                                      compute_dtype=torch.float32))
    params = load_model(cfg)
    prompts = smoke_prompts()[:LOSSLESS_REQUESTS]
    eng = ServingEngine(params, cfg, SpecConfig(k=SERVE_K, w=SERVE_W,
                                                strategy="mixed"),
                        tables=tables, buckets=(SERVE_BUCKET,))
    tok_fn = lambda p: eng.scheduler.pad_to_bucket(eng.tok.encode(p))
    with moe.count_drops() as counts:      # the served run and its oracle
        done, _ = serve(eng, prompts, LOSSLESS_NEW)
        check_lossless(params, cfg, done, prompts, tok_fn, LOSSLESS_NEW,
                       "12e jamba with experts static mixed")
    drops = drop_line(cfg, "12e jamba with experts f32", counts)
    if drops[1]:
        raise AssertionError(f"12e jamba: slots dropped at E / K: {drops}")
    peak_line("12e jamba with experts f32")
    del params, eng
    torch.cuda.empty_cache()


def f32_spread(params, cfg, toks) -> float:
    """Largest |logit| difference at the last position of ``toks`` (B, T)
    between one forward of all rows and one forward a row: how far apart
    two f32 evaluations of the same sequences land (their GEMMs differ in
    shape, so in rounding)."""
    import torch
    from repro_torch.models import model as M
    with torch.no_grad():
        a = M.forward(params, cfg, tokens=toks)[0][:, -1]
        b = torch.cat([M.forward(params, cfg, tokens=toks[i:i + 1])[0][:, -1]
                       for i in range(toks.shape[0])])
    return float((a - b).abs().max())


def graphed_greedy_reference(params, cfg, toks, max_new: int):
    """``greedy_reference`` (one full forward over the fixed (B, P +
    max_new) buffer a new token, the argmax at the last filled position)
    with that forward captured once in a CUDA graph and replayed for each
    token: the same kernels on the same buffer, without the host's time
    loop in every call.  The graph's first logits must equal an eager
    forward's bit for bit, or the eager ``greedy_reference`` runs instead.
    Returns the buffer as numpy."""
    import torch
    from repro_torch.core.spec_engine import greedy_reference
    from repro_torch.models import model as M
    B, P = toks.shape
    buf = torch.zeros((B, P + max_new), dtype=torch.int32, device="cuda")
    buf[:, :P] = toks
    with torch.no_grad():
        eager = M.forward(params, cfg, tokens=buf)[0]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):           # warm-up, as capture asks
            M.forward(params, cfg, tokens=buf)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        try:
            with torch.cuda.graph(graph):
                logits = M.forward(params, cfg, tokens=buf)[0]
            graph.replay()
            sync()
            same = torch.equal(logits, eager)
        except RuntimeError as e:       # the forward would not capture
            print(f"    graphed greedy_reference: capture failed ({e})")
            same = logits = None
        print(f"    graphed greedy_reference: captured in "
              f"{time.perf_counter() - t0:.1f} s; first logits == an eager "
              f"forward's: {same}")
        if not same:
            del graph, logits
            return greedy_reference(params, cfg, toks, max_new).cpu().numpy()
        for i in range(max_new):
            if i:
                graph.replay()
            buf[:, P + i] = torch.argmax(logits[:, P + i - 1], dim=-1).to(
                torch.int32)
    out = buf.cpu().numpy()
    del graph, logits
    return out


def xlstm_f32(tables) -> None:
    """12e: xLSTM-125M (XLSTM_DEPTH of its 12 layers, full width) in f32
    (TF32 off).  With the
    reference's init (sLSTM's ``r`` at fan-in 4, std 0.5) the sLSTM
    recurrence amplifies rounding: the run reads the spread of two f32
    evaluations of phase 3's first 2 prompts (``f32_spread``), and no
    output can be held to an oracle whose GEMMs round otherwise.  With ``r`` drawn at
    the fan-in of its dh x dh blocks (std dh^-0.5; every other weight as
    seeded), the spread is f32 noise, and phase 3's 8 requests x
    SERVE_NEW static mixed equal ``greedy_reference`` token for token
    (hard; its oracle's forward is a host-bound time loop, ~1.5 s a
    forward of 8 x 320 tokens on the card, so it runs as
    ``graphed_greedy_reference``)."""
    import numpy as np
    import torch
    from repro_torch.core.spec_engine import SpecConfig
    from repro_torch.serving.engine import ServingEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = arch_config("xlstm-125m", XLSTM_DEPTH, f32=True)
    params = load_model(cfg)
    prompts = smoke_prompts()
    eng = ServingEngine(params, cfg, SpecConfig(k=SERVE_K, w=SERVE_W,
                                                strategy="mixed"),
                        tables=tables, buckets=(SERVE_BUCKET,))
    toks = torch.as_tensor(np.stack([eng.scheduler.pad_to_bucket(
        eng.tok.encode(p)) for p in prompts]), device="cuda")
    spread = f32_spread(params, cfg, toks[:2])
    dh = cfg.d_model // cfg.num_heads
    for gid, g in params.items():
        if "r" in g.get("mixer", {}):
            g["mixer"]["r"].mul_((4 / dh) ** 0.5)     # fan-in 4 -> dh
    tamed = f32_spread(params, cfg, toks[:2])
    print(f"  12e xlstm-125m f32: logit spread of two evaluations at the "
          f"last prompt position {spread:.4g} with the reference's init "
          f"(sLSTM r std 0.5), {tamed:.4g} with r at fan-in {dh}")
    done, wall = serve(eng, prompts, SERVE_NEW)
    t0 = time.perf_counter()
    ref = graphed_greedy_reference(params, cfg, toks, SERVE_NEW)
    check_equals_greedy(params, cfg, done, ref, SERVE_BUCKET)
    calls = sum(r.stats["model_calls"] for r in done)
    print(f"  12e xlstm-125m (r at fan-in {dh}): f32 mixed == "
          f"greedy_reference for {len(done)} requests x {SERVE_NEW} "
          f"tokens ({calls} verify calls, "
          f"{len(done) * SERVE_NEW / calls:.3f} tokens/call, served in "
          f"{wall:.2f} s; greedy_reference "
          f"{time.perf_counter() - t0:.1f} s)")
    del params, eng
    torch.cuda.empty_cache()


def moe_train() -> None:
    """12f: TRAIN_CHECK_STEPS AdamW steps (remat) of deepseek-smoke and
    xlstm-smoke (f32) on the card from CPU-seeded weights, on the
    reference's mixture: loss and aux_loss equal the CPU's same steps to
    TRAIN_CPU_TOL (relative), DeepSeek's aux_loss > 0, no kernel
    launches."""
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.train import AdamWConfig, init_train_state
    from repro_torch.train import make_train_step
    from repro_torch.train.optimizer import tree_map
    batches = mixture(TRAIN_CHECK_STEPS)
    for arch in ("deepseek-moe-16b", "xlstm-125m"):
        cfg = get_smoke_config(arch)
        step = make_train_step(cfg, AdamWConfig(
            lr=TRAIN_LR, total_steps=TRAIN_CHECK_STEPS, warmup_steps=1),
            remat=True)
        cpu_ts = init_train_state(cfg, seed=0, device="cpu")
        ts = tree_map(lambda t: t.to("cuda"), cpu_ts)
        reads = {}
        reset_launches()
        t0 = time.perf_counter()
        for dev, state in (("card", ts), ("cpu", cpu_ts)):
            mets = []
            for b in batches:
                state, m = step(state, b)
                mets.append((m["loss"], m["aux_loss"]))
            reads[dev] = [(float(a), float(x)) for a, x in mets]
            if dev == "card":
                sync()
                secs = time.perf_counter() - t0
                check_no_launch(f"12f {cfg.name}")
        rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)
        err = max(max(rel(c[0], p[0]), rel(c[1], p[1]) if p[1] else c[1])
                  for c, p in zip(reads["card"], reads["cpu"]))
        print(f"  12f {cfg.name}: card (loss, aux_loss) " + " ".join(
            f"({a:.5f}, {x:.5f})" for a, x in reads["card"])
            + f"; max relative difference from the CPU's {err:.3g} (limit "
            f"{TRAIN_CPU_TOL}); {secs:.2f} s on the card")
        if err > TRAIN_CPU_TOL:
            raise AssertionError(f"12f {cfg.name}: card {reads['card']} != "
                                 f"CPU {reads['cpu']}")
        if arch == "deepseek-moe-16b" and not all(
                x > 0 for _, x in reads["card"]):
            raise AssertionError(f"12f: DeepSeek's aux_loss is not > 0: "
                                 f"{reads['card']}")


def phase_moe() -> dict:
    """Phase 12 (see the module docstring).  Returns each bf16 serving
    run's kernel launches."""
    import gc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.jamba_1_5_large_398b import with_experts
    t_phase = time.perf_counter()
    runs: dict = {}
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 12a: DeepSeek-MoE-16B ({DEEPSEEK_DEPTH} of 28 layers, full "
          f"width, bf16): static, continuous paged, profiled")
    tables = {"deepseek": moe_serve(
        "12a deepseek-moe-16b", arch_config("deepseek-moe-16b",
                                            DEEPSEEK_DEPTH), runs,
        continuous=True, profile=True, contract="moe")}
    print(f"phase 12b: Mixtral-8x7B ({MIXTRAL_DEPTH} of 32 layers, full "
          f"width, all 8 experts, bf16): static (the window's plain "
          f"verify), continuous linear")
    tables["mixtral"] = moe_serve("12b mixtral-8x7b",
                                  arch_config("mixtral-8x7b", MIXTRAL_DEPTH),
                                  runs, continuous=False)
    layers, start = JAMBA_EXPERTS
    print(f"phase 12c: Jamba-1.5-Large with experts (offsets {start}-"
          f"{start + layers - 1} of its period, full width, 16 experts, "
          f"bf16): static")
    tables["jamba"] = moe_serve("12c jamba with experts", with_experts(
        get_config("jamba-1.5-large-398b"), layers, start), runs)
    print(f"phase 12d: xLSTM-125M ({XLSTM_DEPTH} of 12 layers, full width, "
          f"bf16): static, continuous linear, profiled")
    tables["xlstm"] = moe_serve("12d xlstm-125m",
                                arch_config("xlstm-125m", XLSTM_DEPTH),
                                runs, continuous=False, profile=True,
                                contract="xlstm")
    for label, fn in (
            ("12e deepseek", lambda: moe_capacity(
                "deepseek-moe-16b", tables["deepseek"], "12e deepseek")),
            ("12e mixtral", lambda: moe_capacity(
                "mixtral-8x7b", tables["mixtral"], "12e mixtral")),
            ("12e jamba", lambda: jamba_experts_f32(tables["jamba"])),
            ("12e xlstm", lambda: xlstm_f32(tables["xlstm"])),
            ("12f", moe_train)):
        t0 = time.perf_counter()
        print(f"phase {label}")
        fn()
        print(f"  phase {label} took {time.perf_counter() - t0:.1f} s")
    print(f"  dropped token-slots (MoE-layer calls, dropped, most in one "
          f"call): {DROPS}")
    print(f"  phase 12 took {time.perf_counter() - t_phase:.1f} s")
    return runs


# ---- phase 13: the contract checker and the examples ----
REFERENCE_CASES = ("linear-greedy", "linear-mixed", "linear-sampled",
                   "linear-adaptive", "tree", "paged-mixed")
# the kernels each registry case's checked step launches on the card
CONTRACT_KERNELS = {
    "linear-greedy": ("spec_attention",),
    "linear-mixed": ("spec_attention", "ngram_match"),
    "linear-sampled": ("spec_attention", "ngram_match"),
    "linear-adaptive": ("spec_attention", "ngram_match"),
    "tree": ("tree_spec_attention", "ngram_match"),
    "paged-mixed": ("paged_spec_attention", "ngram_match"),
    "hybrid": ("mamba_scan", "spec_attention", "ngram_match"),
    "moe": ("spec_attention", "ngram_match"),
    "mrope": ("spec_attention", "ngram_match"),
    "window": ("ngram_match",),        # the window's plain verify: no K1
    "xlstm": ("ngram_match",),         # no attention layer
}
# every (model, case) 13a checks
CONTRACT_WANT = ({("13a stablelm-1.6b", c) for c in REFERENCE_CASES}
                 | {("13a hybrid", "hybrid"), ("13a mistral-7b", "window"),
                    ("13a qwen2-vl-72b", "mrope"),
                    ("13a deepseek-moe-16b", "moe"),
                    ("13a xlstm-125m", "xlstm")})
CONTRACT: list = []            # 13a's checks, as the phases that hold the
#                                models run them
EXAMPLES = ("torch_quickstart", "torch_train_tiny", "torch_serve_speculative",
            "torch_phase_transition_demo")
CLI_TIMEOUT_S = 600


def contract_check(label: str, names, params, cfg) -> None:
    """Phase 13a on a model an earlier phase holds (full width, bf16, on
    the card): the level-1 contract checks of the registry cases ``names``
    (``analysis.runtime_rules.check_case``: admissions and a warm step,
    then a step under ``set_sync_debug_mode("error")`` and the dispatch-mode
    detector, an admission and a release), with the kernels' launches in
    the checked step.  Recorded in CONTRACT for phase 13's report."""
    from repro_torch.analysis import registry, runtime_rules
    for name in names:
        launches: dict = {}

        @contextlib.contextmanager
        def count():
            reset_launches()
            try:
                yield
            finally:
                sync()
                launches.update(read_launches())
        t0 = time.perf_counter()
        built = registry.build_case(registry.case(name), device="cuda",
                                    cfg=cfg, params=params)
        findings = runtime_rules.check_case(built, step_hook=count)
        sync()
        rules: dict = {}
        for f in findings:
            rules[f.rule] = rules.get(f.rule, 0) + 1
        CONTRACT.append(dict(label=label, case=name, rules=rules,
                             findings=[f.format() for f in findings],
                             launches={k: v for k, v in launches.items()
                                       if v},
                             seconds=time.perf_counter() - t0))
        print(f"  {label} {name}: contract findings {rules or 0}, the "
              f"checked step's launches {CONTRACT[-1]['launches']}")


def run_example(name: str) -> dict:
    """Phase 13b: one example's ``main`` at its default flags on the card;
    its wall seconds, tokens/call and kernel launches."""
    import importlib
    import io
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    try:
        mod = importlib.import_module(name)
    finally:
        sys.path.pop(0)
    reset_launches()
    out = io.StringIO()
    sync()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        got = mod.main([])
    sync()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in read_launches().items() if v}
    if name == "torch_quickstart":
        tpc = {s: r["tokens_per_call"] for s, r in got.items()}
    elif name == "torch_train_tiny":
        tpc = {f"step {i}": t for i, _, t in got[1]}
    elif name == "torch_serve_speculative":
        tpc = {m: sum(r.stats["new_tokens"] for r in reqs)
               / max(sum(r.stats["model_calls"] for r in reqs), 1)
               for m, reqs in got.items()}
    else:
        tpc = {}
    lines = out.getvalue().strip().splitlines()
    print(f"  {name}: {wall:.1f} s, tokens/call "
          + (", ".join(f"{k} {v:.3f}" for k, v in tpc.items()) or "none")
          + f", launches {launches}; its last line: {lines[-1][:100]!r}")
    return dict(wall=wall, tokens_per_call=tpc, launches=launches)


def phase_contract() -> dict:
    """Phase 13 (see the module docstring).  Returns each 13a check's and
    each example's kernel launches."""
    t_phase = time.perf_counter()
    print("phase 13a: the contract checker's level-1 checks at full width "
          "(run where phases 3, 7, 10 and 12 held each model)")
    runs: dict = {}
    totals: dict = {}
    bad = []
    for r in CONTRACT:
        for rule, n in r["rules"].items():
            totals[rule] = totals.get(rule, 0) + n
        missing = [k for k in CONTRACT_KERNELS[r["case"]]
                   if not r["launches"].get(k)]
        print(f"  {r['label']} {r['case']}: {sum(r['rules'].values())} "
              f"findings, launches {r['launches']}, {r['seconds']:.1f} s")
        for f in r["findings"]:
            print(f"    {f}")
        if r["rules"] or missing:
            bad.append((r["label"], r["case"], r["rules"], missing))
        runs[f"{r['label']} {r['case']}"] = r["launches"]
    checked = {(r["label"], r["case"]) for r in CONTRACT}
    print(f"  findings per rule over {len(CONTRACT)} checks: {totals or 0}")
    if checked != CONTRACT_WANT:
        raise AssertionError(f"13a: checks missing "
                             f"{sorted(CONTRACT_WANT - checked)}, unexpected "
                             f"{sorted(checked - CONTRACT_WANT)}")
    if bad:
        raise AssertionError(f"13a: findings or kernels not launched: {bad}")
    t0 = took("phase 13a's report", t_phase)

    print(f"phase 13b: the examples at their default flags on the card "
          f"({', '.join(EXAMPLES)})")
    for name in EXAMPLES:
        got = run_example(name)
        runs[f"13b {name}"] = got["launches"]
        need = {"torch_quickstart": ("spec_attention", "ngram_match"),
                "torch_train_tiny": ("spec_attention", "ngram_match"),
                "torch_serve_speculative": ("spec_attention", "ngram_match",
                                            "paged_spec_attention")
                }.get(name, ())
        if any(not got["launches"].get(k) for k in need):
            raise AssertionError(f"13b {name}: a kernel never launched: "
                                 f"{got['launches']}")
    t0 = took("phase 13b", t0)

    print("phase 13c: python -m repro_torch.analysis --strict (both "
          "levels, level 1 on the card)")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                          "--strict"], cwd=ROOT, env=env,
                         capture_output=True, text=True,
                         timeout=CLI_TIMEOUT_S)
    for line in (out.stdout + out.stderr).strip().splitlines()[-12:]:
        print(f"    {line}")
    if out.returncode != 0:
        raise AssertionError(f"13c: the checker exited {out.returncode}")
    took("phase 13c", t0)
    print(f"  phase 13 took {time.perf_counter() - t_phase:.1f} s")
    return runs


MESH_N = 8                     # phase 5's first 8 requests (two long)
MESH_F32_N, MESH_F32_LAYERS = 4, 2
MESH_PROFILE_STEPS = 3


def mesh_group():
    """A one-rank NCCL process group in this process and its (1, 1) mesh
    (two ranks on one card is not an NCCL configuration)."""
    import tempfile
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_debug_mesh
    init = "file://" + os.path.join(tempfile.mkdtemp(prefix="mesh-"),
                                    "init")
    dist.init_process_group("nccl", init_method=init, rank=0, world_size=1)
    return make_debug_mesh((1, 1), "cuda")


def counted_steps(engine) -> list:
    """Count the engine's continuous steps (a one-element list)."""
    n = [0]
    real = engine._run_step

    def step(state):
        n[0] += 1
        return real(state)
    engine._run_step = step
    return n


def mesh_run(params, cfg, spec, tables, work, mesh, paged: bool,
             label: str) -> dict:
    """One continuous run of ``work``, with a mesh or without: tokens/s,
    tokens/call, steps, wall ms a step, peak memory, the kernels' launches
    and plain_verify's calls (none for a config inside K1's contract)."""
    import gc
    import torch
    from repro_torch.models.attention import plain_verify
    gc.collect()                    # an earlier run's engine, in its cycles
    eng = cont_engine(params, cfg, spec, tables, paged, mesh=mesh)
    steps = counted_steps(eng)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()                # counts from zero just before the run
    pv = plain_verify.calls
    done, wall = serve_continuous(eng, work)
    launches = read_launches()
    pv = plain_verify.calls - pv
    peak = torch.cuda.max_memory_allocated() / 2**30
    check_budgets(done, work)
    if paged:
        check_paged_run(eng, done, work, deferrals=False)
    new = sum(r.stats["new_tokens"] for r in done)
    calls = sum(r.stats["model_calls"] for r in done)
    out = dict(done=done, engine=eng, steps=steps[0], wall=wall,
               tok_s=new / wall, tpc=new / max(calls, 1),
               step_ms=wall * 1e3 / max(steps[0], 1), peak=peak,
               launches=launches, plain_verify=pv)
    print(f"  {label}: {len(done)} requests, {new} tokens in {wall:.2f} s "
          f"= {out['tok_s']:.1f} tok/s, {out['tpc']:.2f} tokens/call, "
          f"{steps[0]} steps, {out['step_ms']:.1f} ms wall a step, peak "
          f"{peak:.2f} GiB, launches {launches}, plain_verify {pv}")
    return out


def mesh_busy(params, cfg, spec, tables, work, mesh, paged: bool,
              label: str) -> dict:
    """Wall against device-busy ms a continuous step (torch.profiler over
    a few steps of a fresh engine once its slots are full)."""
    eng = cont_engine(params, cfg, spec, tables, paged, mesh=mesh)
    for text, mnt in work:
        eng.submit(text, max_new_tokens=mnt)
    eng.step()
    return profile_window(label, eng.step, MESH_PROFILE_STEPS)


def mesh_placement(host, cfg, spec, tables, mesh, label="14a") -> dict:
    """A meshed engine built from parameters on the host: the card's bytes
    after it against the shard bytes its report gives (each rank copies
    its shards alone: nothing whole passes through the card), and the
    peak on the way."""
    import torch
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    eng = cont_engine(host, cfg, spec, tables, True, mesh=mesh)
    sync()
    placed = torch.cuda.memory_allocated() - before
    peak = torch.cuda.max_memory_allocated() - before
    rep = eng.mesh_report()
    shards = rep["params_bytes"]["local"]
    print(f"  {label}: the meshed engine from host parameters placed "
          f"{placed / 2**30:.3f} GiB on the card (peak "
          f"{peak / 2**30:.3f}) for {shards / 2**30:.3f} GiB of shards "
          f"({rep['params_bytes']['global'] / 2**30:.3f} GiB whole)")
    # the caching allocator rounds each of the ~300 blocks up to 2 MiB at
    # most; a second copy of the model would add its 3.11 GiB
    slack = 2**20 * 2 * len(list(host_leaves(host)))
    if not (shards <= placed <= shards + slack and peak <= placed + slack):
        raise AssertionError(f"placement: {placed} bytes placed, peak "
                             f"{peak}, for {shards} bytes of shards")
    return dict(placed=placed, peak=peak, shards=shards)


def host_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from host_leaves(v)
    else:
        yield tree


def phase_mesh(tables) -> dict:
    """Phase 14: the mesh (``ServingEngine(mesh=)``) on a (1, 1) NCCL mesh
    in this process.  14a: StableLM-2-1.6B (phase 3's, MAIN_DEPTH), bf16,
    continuous paged mixed over phase 5's pool, beside the same engine
    without a mesh: the gap is DTensor's dispatch on this card.  The
    meshed engine is built from parameters on the host (its shards alone
    reach the card) and its step launches the kernels on its local
    tensors: K3 once a layer a step and K2 once a step, as without the
    mesh, and no plain_verify.  14b: in f32 at 2 layers the meshed tokens
    equal the unmeshed engine's and greedy_reference's, greedy and mixed,
    linear and paged.  Returns 14a's meshed launches."""
    import gc
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.core.spec_engine import SpecConfig, greedy_reference
    from repro_torch.distributed import act_sharding
    t0 = time.perf_counter()
    mesh = mesh_group()
    try:
        cfg = main_config()
        params = load_model(cfg)
        spec = SpecConfig(k=SERVE_K, w=SERVE_W, strategy="mixed")
        work = cont_workload()[:MESH_N]
        print(f"  14a: continuous paged mixed, {len(work)} requests, "
              f"{CONT_SLOTS} slots, {CONT_PAGES}-page pool")
        runs = {"no mesh": mesh_run(params, cfg, spec, tables, work, None,
                                    True, "no mesh")}
        mesh_busy(params, cfg, spec, tables, work, None, True,
                  "14a no mesh paged mixed step")
        # the meshed engines take the model from the host; the card keeps
        # no copy of it (the engine without a mesh held one)
        host = _to_host(params)
        del params, runs["no mesh"]["engine"]
        gc.collect()
        placed = mesh_placement(host, cfg, spec, tables, mesh)
        meshed = runs["mesh (1, 1)"] = mesh_run(host, cfg, spec, tables,
                                                work, mesh, True,
                                                "mesh (1, 1)")
        ln, steps = meshed["launches"], meshed["steps"]
        want = {"paged_spec_attention": steps * cfg.num_layers,
                "ngram_match": steps}
        if (any(ln[k] != n for k, n in want.items())
                or meshed["plain_verify"]):
            raise AssertionError(
                f"under the mesh: launches {ln}, want {want}; "
                f"plain_verify {meshed['plain_verify']}, want 0")
        if act_sharding.installed():
            raise AssertionError("the meshed engine left its mesh installed")
        same = sum(np.array_equal(a.output_ids, b.output_ids) for a, b in
                   zip(runs["no mesh"]["done"], meshed["done"]))
        print(f"  14a: bf16 outputs equal without and with the mesh for "
              f"{same}/{len(work)} requests; tok/s ratio mesh/no mesh "
              f"{meshed['tok_s'] / runs['no mesh']['tok_s']:.3f}")
        rep = meshed["engine"].mesh_report()
        print(f"  mesh: {rep['mesh']} params sharded {rep['params_sharded']}"
              f"/{rep['params_leaves']} params bytes {rep['params_bytes']} "
              f"state leaves sharded {rep['state_sharded']} fallbacks "
              f"{rep['replication_fallbacks']} kv bytes {rep['kv_bytes']} "
              f"kernels {rep['backend']}")
        t0 = took("phase 14a's runs", t0)
        mesh_busy(host, cfg, spec, tables, work, mesh, True,
                  "14a mesh (1, 1) paged mixed step")
        launches = dict(ln)
        del host, runs, meshed, placed
        t0 = took("phase 14a's profile", t0)

        cfg32 = arch_config("stablelm-1.6b", layers=MESH_F32_LAYERS,
                            f32=True)
        torch.backends.cuda.matmul.allow_tf32 = False
        params32 = load_model(cfg32)
        tables32 = arch_tables(params32, cfg32)
        work = cont_workload()[:MESH_F32_N]
        for strategy in ("greedy", "mixed"):
            sp = SpecConfig(k=SERVE_K, w=SERVE_W, strategy=strategy)
            tb = tables32 if strategy == "mixed" else None
            for paged in (False, True):
                label = (f"14b f32 {'paged' if paged else 'linear'} "
                         f"{strategy}")
                outs = [mesh_run(params32, cfg32, sp, tb, work, m, paged,
                                 f"{label} {'mesh' if m else 'no mesh'}")
                        ["done"] for m in (None, mesh)]
                for a, b, (_, mnt) in zip(*outs, work):
                    toks = np.asarray(cont_engine_tokens(a.prompt))
                    ref = greedy_reference(params32, cfg32, toks[None],
                                           mnt)[0, len(toks):].cpu().numpy()
                    if not (np.array_equal(a.output_ids, b.output_ids)
                            and np.array_equal(b.output_ids, ref)):
                        raise AssertionError(
                            f"{label}: request {b.request_id}: meshed "
                            f"{b.output_ids.tolist()} unmeshed "
                            f"{a.output_ids.tolist()} greedy_reference "
                            f"{ref.tolist()}")
                print(f"  {label}: meshed == unmeshed == greedy_reference "
                      f"for {len(work)} requests")
        took("phase 14b", t0)
        del params32, tables32
        print("phase 15: the recurrent mixers under the (1, 1) mesh")
        t0 = time.perf_counter()
        launches.update(phase_mesh_recurrent(mesh))
        took("phase 15", t0)
        return launches
    finally:
        dist.destroy_process_group()


def mesh_kernels_as_unmeshed(label, plain, meshed, n_mamba, n_attn,
                             admitted) -> None:
    """15a: the meshed run launched what the run without a mesh did, and
    what the path asks: K5 once a Mamba layer for each admission's
    prefill and twice a step (verify, replay), K1 (linear) or K3 (paged)
    twice an attention layer a step, K2 once a step, no plain_verify."""
    ln, steps = meshed["launches"], meshed["steps"]
    paged = "paged" in label
    want = {"mamba_scan": n_mamba * (admitted + 2 * steps),
            "paged_spec_attention" if paged else "spec_attention":
                2 * n_attn * steps,
            "ngram_match": steps}
    bad = [k for k, n in want.items() if ln[k] != n]
    others = [k for k, v in ln.items() if k not in want and v]
    if bad or others or meshed["plain_verify"] or (
            plain["steps"] == steps and plain["launches"] != ln):
        raise AssertionError(
            f"{label}: meshed launches {ln} (plain_verify "
            f"{meshed['plain_verify']}), want {want}; without the mesh "
            f"{plain['launches']} in {plain['steps']} steps")


def phase_mesh_recurrent(mesh) -> dict:
    """Phase 15: the recurrent mixers under the (1, 1) NCCL mesh.  15a:
    Jamba cut to one period (HYB_PERIODS: 7 Mamba + 1 attention layer at
    full width, no experts, 9.0 B, bf16) serves phase 5's first MESH_N
    requests continuously mixed, linear and paged, without and with the mesh (the meshed engine built
    from host parameters): tokens/s, wall and busy ms a step, device ops,
    the card's bytes after placement against the shards'; the kernels
    launch as without the mesh (``mesh_kernels_as_unmeshed``) and the bf16
    tokens are equal.  15b: in f32 (TF32 off) the hybrid at 2 layers
    (Mamba and attention, 11e's config) and xLSTM-125M at one period of
    4 layers (3 mLSTM, 1 sLSTM; sLSTM's r at fan-in dh, as 12e), greedy
    and mixed, linear: meshed == unmeshed == ``greedy_reference``.
    Returns 15a's meshed paged launches."""
    import gc
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.jamba_1_5_large_398b import (no_experts,
                                                           with_experts)
    from repro_torch.core.spec_engine import SpecConfig
    t0 = time.perf_counter()
    cfg = hybrid_config(HYB_PERIODS)
    n_mamba = sum(b.mixer == "mamba" for b in cfg.block_pattern)
    params = load_model(cfg)
    tables = arch_tables(params, cfg)
    spec = SpecConfig(k=SERVE_K, w=SERVE_W, strategy="mixed")
    work = cont_workload()[:MESH_N]
    runs = {}
    for paged in (False, True):
        label = f"15a no mesh {'paged' if paged else 'linear'} mixed"
        runs[label] = mesh_run(params, cfg, spec, tables, work, None, paged,
                               label)
        del runs[label]["engine"]
    mesh_busy(params, cfg, spec, tables, work, None, True,
              "15a no mesh paged mixed step")
    host = _to_host(params)
    del params
    gc.collect()
    mesh_placement(host, cfg, spec, tables, mesh, "15a")
    launches = {}
    for paged in (False, True):
        layout = "paged" if paged else "linear"
        label = f"15a mesh (1, 1) {layout} mixed"
        meshed = runs[label] = mesh_run(host, cfg, spec, tables, work, mesh,
                                        paged, label)
        plain = runs[f"15a no mesh {layout} mixed"]
        mesh_kernels_as_unmeshed(label, plain, meshed, n_mamba, 1,
                                 len(work))
        same = sum(np.array_equal(a.output_ids, b.output_ids)
                   for a, b in zip(plain["done"], meshed["done"]))
        print(f"  {label}: bf16 outputs equal without and with the mesh for "
              f"{same}/{len(work)} requests; tok/s ratio mesh/no mesh "
              f"{meshed['tok_s'] / plain['tok_s']:.3f}")
        if same != len(work):
            raise AssertionError(f"{label}: bf16 tokens differ under the "
                                 f"mesh")
        launches = meshed["launches"]
        rep = meshed["engine"].mesh_report()
        del meshed["engine"]
    print(f"  mesh: {rep['mesh']} params sharded {rep['params_sharded']}"
          f"/{rep['params_leaves']} state leaves sharded "
          f"{rep['state_sharded']} kernels {rep['backend']}")
    t0 = took("phase 15a's runs", t0)
    mesh_busy(host, cfg, spec, tables, work, mesh, True,
              "15a mesh (1, 1) paged mixed step")
    del host, runs, tables
    gc.collect()
    torch.cuda.empty_cache()
    t0 = took("phase 15a's profile", t0)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    f32 = dict(param_dtype=torch.float32, compute_dtype=torch.float32)
    hyb = dataclasses.replace(no_experts(with_experts(
        get_config("jamba-1.5-large-398b"), *HYB_TRAIN), 1), **f32)
    xl = dataclasses.replace(arch_config("xlstm-125m", layers=4), **f32)
    work = cont_workload()[:MESH_F32_N]
    for cfg32 in (hyb, xl):
        params32 = load_model(cfg32)
        if cfg32 is xl:
            dh = cfg32.d_model // cfg32.num_heads
            for g in params32.values():
                if "r" in g.get("mixer", {}):
                    g["mixer"]["r"].mul_((4 / dh) ** 0.5)  # fan-in 4 -> dh
        tables32 = arch_tables(params32, cfg32)
        refs = {}
        for strategy in ("greedy", "mixed"):
            sp = SpecConfig(k=SERVE_K, w=SERVE_W, strategy=strategy)
            tb = tables32 if strategy == "mixed" else None
            label = f"15b f32 {cfg32.name} linear {strategy}"
            outs = [mesh_run(params32, cfg32, sp, tb, work, m, False,
                             f"{label} {'mesh' if m else 'no mesh'}")
                    ["done"] for m in (None, mesh)]
            for a, b, (_, mnt) in zip(*outs, work):
                toks = np.asarray(cont_engine_tokens(a.prompt))
                if a.request_id not in refs:
                    refs[a.request_id] = graphed_greedy_reference(
                        params32, cfg32, torch.as_tensor(
                            toks[None], device="cuda"), mnt)[0, len(toks):]
                ref = refs[a.request_id]
                if not (np.array_equal(a.output_ids, b.output_ids)
                        and np.array_equal(b.output_ids, ref)):
                    raise AssertionError(
                        f"{label}: request {b.request_id}: meshed "
                        f"{b.output_ids.tolist()} unmeshed "
                        f"{a.output_ids.tolist()} greedy_reference "
                        f"{ref.tolist()}")
            print(f"  {label}: meshed == unmeshed == greedy_reference for "
                  f"{len(work)} requests")
        del params32, tables32
        gc.collect()
        torch.cuda.empty_cache()
    took("phase 15b", t0)
    return {"mamba_scan": launches["mamba_scan"]}


# phase 16: the dry-run.  Its cases on the reference's meshes, through
# the CLI (a process each, its own placeholder group; this one held NCCL's):
# (arch, shape, flags, the kernels whose instances the trace records).
# Mistral's window verifies by the plain path and a prefill's attention
# is no kernel, so those two record none.
DRYRUN_CASES = (
    ("jamba-1.5-large-398b", "decode_32k", ("--spec",), {"K1", "K5"}),
    ("nemotron-4-340b", "decode_32k", ("--multi-pod",), {"K1"}),
    ("mistral-7b", "long_500k", ("--spec",), set()),
    ("stablelm-1.6b", "prefill_32k", (), set()),
)
DRYRUN_ANCHOR_B = 8              # 16c: phase 3's batch, at MAIN_DEPTH
DRYRUN_TIMEOUT_S = 600


def shape_function_check() -> None:
    """16a: each shape function against its real kernel on the same
    inputs (the fake copies of the real operands): equal shapes, dtypes,
    strides and device, and the instance it records is the one the card
    launched (K1 by the rule of ``launch_mma_hd``, K5 by ``launch_ds``)."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels.mamba_scan import mamba_scan_cuda
    from repro_torch.kernels.spec_attention import spec_attention_cuda

    def same(label, fn, ops, kw, calls, want):
        real = [t for t in fn(*ops, **kw) if t is not None] \
            if fn is mamba_scan_cuda else [fn(*ops, **kw)]
        torch.cuda.synchronize()
        mode = FakeTensorMode()
        fakes = [None if t is None else mode.from_tensor(t) for t in ops]
        calls.clear()
        with mode:
            fake = fn(*fakes, **{k: mode.from_tensor(v)
                                 if isinstance(v, torch.Tensor) else v
                                 for k, v in kw.items()})
            fake = [t for t in fake if t is not None] \
                if fn is mamba_scan_cuda else [fake]
        meta = lambda t: (tuple(t.shape), t.dtype, t.stride(), t.device)
        got = [c["instance"] for c in calls]
        if [meta(t) for t in fake] != [meta(t) for t in real] \
                or got != [want]:
            raise AssertionError(f"16a {label}: fake {[meta(t) for t in fake]}"
                                 f" {got}, real {[meta(t) for t in real]} "
                                 f"{want}")
        print(f"  16a {label}: {[meta(t)[:3] for t in real]} on "
              f"{real[0].device}, instance {want}")

    S = 4096
    for label, (B, K, W1, H, KV, hd), want in (
            ("K1 StableLM verify", (8, 10, 11, 32, 32, 64), "<64, 2, false>"),
            ("K1 StableLM decode", (8, 1, 1, 32, 32, 64), "<64, 1, false>"),
            ("K1 hybrid verify", (8, 10, 11, 64, 8, 128), "<128, 2, false>"),
            ("K1 Nemotron decode", (8, 1, 1, 96, 8, 192),
             "<256, 1, false>")):
        ops = k1_inputs(B, K, W1, H, KV, hd, S, [S // 2] * B, torch.bfloat16,
                        seed=16)
        same(label, spec_attention_cuda, ops, {"w1": W1},
             spec_attention_cuda.shape_calls, want)
    di, ds = 16384, 16
    for label, (Bt, T, rep, final) in (("K5 prefill", (8, 256, 1, True)),
                                       ("K5 verify", (80, 11, 10, False)),
                                       ("K5 decode", (8, 1, 1, True))):
        ops = k5_inputs(Bt, T, di, ds, seed=16, h0_rep=rep,
                        u_dtype=torch.bfloat16)
        same(label, mamba_scan_cuda, ops, {"h0_rep": rep, "final": final},
             mamba_scan_cuda.shape_calls, "<16, bf16, false, false>")


def dryrun_anchor() -> None:
    """16c: the dry-run at mesh (1, 1) beside the same program on real
    tensors: StableLM-2-1.6B at MAIN_DEPTH, decode_32k at phase 3's batch.
    The dry-run's argument bytes equal the bytes of the real params, state
    and tokens placed on the card by the same rules (asserted); its peak
    (arguments plus temp) is printed beside ``max_memory_allocated`` over
    the real call."""
    import torch
    from repro_torch.distributed import local as DL
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import dryrun, input_specs
    from repro_torch.launch.hostdev import ensure_placeholder_ranks
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import model as M
    ensure_placeholder_ranks(1)
    mesh = make_debug_mesh((1, 1))
    case = input_specs.resolve_case("stablelm-1.6b", "decode_32k", mesh,
                                    num_layers=MAIN_DEPTH,
                                    batch=DRYRUN_ANCHOR_B)
    rec = dryrun.trace_case(case)
    mem = rec["memory"]
    cfg = main_config()
    B, T = DRYRUN_ANCHOR_B, input_specs.SHAPES["decode_32k"]["seq"]
    params = M.init_params(cfg, seed=0)
    state = M.init_state(cfg, B, T)
    toks = torch.zeros((B, 1), dtype=torch.int32, device="cuda")
    place = lambda tree, rule: shd.rebuild(tree, lambda p, t: DL.distribute(
        t, mesh, rule(mesh, p, t)))
    args = (place(params, shd.param_pspec), place(state, shd.state_pspec),
            DL.distribute(toks, mesh, shd.batch_pspec(mesh, (B, 1))))
    del params, state
    real = sum(t.to_local().numel() * t.to_local().element_size()
               for t in dryrun._tensors(args))
    if real != mem["argument_size_in_bytes"]:
        raise AssertionError(f"16c: dry-run argument bytes "
                             f"{mem['argument_size_in_bytes']}, placed "
                             f"{real}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        case.fn(*args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    temp = mem["temp_size_in_bytes"]
    fake_peak = real + temp
    print(f"  16c (1, 1) StableLM-2-1.6B {MAIN_DEPTH} layers decode_32k "
          f"B={B}: argument bytes {real} (dry-run == placed); dry-run peak "
          f"{fake_peak / 2**30:.3f} GiB (arguments + temp "
          f"{temp / 2**30:.3f}), real max_memory_allocated "
          f"{peak / 2**30:.3f} GiB, ratio {fake_peak / peak:.4f}; "
          f"total_hbm {mem['total_hbm_bytes'] / 2**30:.3f} GiB; kernels "
          f"{rec['kernels']}; trace {rec['compile_s']} s")


def phase16_card() -> int:
    """16a and 16c, in a process of their own (``chip_smoke.py
    --phase16``): 16c starts a placeholder group."""
    from repro_torch.kernels import build
    build.build()
    shape_function_check()
    dryrun_anchor()
    return 0


def phase_dryrun() -> None:
    """Phase 16: the dry-run (``launch/dryrun.py``) on the card.  16b runs
    DRYRUN_CASES through ``python -m repro_torch.launch.dryrun`` (fake
    CUDA tensors on the reference's 256- and 512-rank meshes), a process
    each, beside one process for 16a and 16c; each record is ok with the
    kernels' instances it should record (asserted)."""
    import tempfile
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    pipe = dict(cwd=ROOT, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".dryrun-") as out:
        t0 = time.perf_counter()
        procs = {(a, s): subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", a,
             "--shape", s, "--out", out, *flags], **pipe)
            for a, s, flags, _ in DRYRUN_CASES}
        procs["16a/16c"] = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--phase16"], **pipe)
        res = {}
        try:
            for key, p in procs.items():
                so, se = p.communicate(timeout=DRYRUN_TIMEOUT_S)
                res[key] = (p.returncode, so, se)
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
        print(f"  16: {len(procs)} processes in "
              f"{time.perf_counter() - t0:.1f} s")
        rc, so, se = res.pop("16a/16c")
        for line in so.strip().splitlines():
            print(line)
        if rc != 0:
            raise AssertionError(f"16a/16c failed:\n{se[-3000:]}")
        for arch, shape, flags, want in DRYRUN_CASES:
            rc, so, se = res[(arch, shape)]
            mp = "--multi-pod" in flags
            name = (f"{arch}__{shape}__{'multipod' if mp else 'pod'}__"
                    f"{'spec' if '--spec' in flags else 'base'}.json")
            print(f"  16b {' '.join(flags) or '(base)'}: "
                  f"{so.strip().splitlines()[-1] if so.strip() else ''}")
            path = os.path.join(out, name)
            rec = json.load(open(path)) if os.path.exists(path) else {}
            got = {k.split()[0] for k in rec.get("kernels", {})}
            if rc != 0 or rec.get("status") != "ok" or got != want:
                raise AssertionError(
                    f"16b {arch} {shape} {flags}: exit {rc}, record "
                    f"{json.dumps(rec)[:1500]}, kernels {got} want {want}:"
                    f"\n{se[-3000:]}")
            mem, coll = rec["memory"], rec["collectives"]
            print(f"    {rec['mesh']}: argument "
                  f"{mem['argument_size_in_bytes'] / 2**30:.3f} GiB, "
                  f"total_hbm {mem['total_hbm_bytes'] / 2**30:.3f} GiB, "
                  f"flops {rec['cost']['flops']:.4g}, collectives "
                  f"{coll['total'] / 2**20:.1f} MiB {coll['counts']}, "
                  f"kernels {rec['kernels']}, trace {rec['compile_s']} s")


def _to_host(tree):
    """A parameter tree's copy on the host."""
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    return tree.cpu()


def took(label: str, t0: float) -> float:
    """Prints the seconds since ``t0`` and returns the time now."""
    now = time.perf_counter()
    print(f"  {label} took {now - t0:.1f} s")
    return now


def template_args(mangled: str) -> list:
    """The template arguments of a mangled name's ``I...E`` list: integers
    and bools as numbers, builtin types by name, named types as named."""
    builtin = {"f": "float", "d": "double", "i": "int", "b": "bool"}
    args, i = [], 0
    while i < len(mangled) and mangled[i] != "E":
        m = re.match(r"L[ib](\d+)E", mangled[i:])
        n = re.match(r"(\d+)", mangled[i:])
        if m:
            args.append(m.group(1))
            i += m.end()
        elif n:
            j = i + n.end()
            args.append(mangled[j:j + int(n.group(1))])
            i = j + int(n.group(1))
        else:
            args.append(builtin.get(mangled[i], mangled[i]))
            i += 1
    return args


def ptxas_report(log: str) -> list:
    """(kernel instance, its ``-Xptxas -v`` registers / shared memory and
    spill report) for every entry function of an nvcc log; the bf16
    verify kernel's instances read spec_attention_mma_kernel<head-dim
    capacity, fragments a warp, paged>, K5's mamba_scan_kernel<state
    capacity, u's type, keeps the state after n_commit, writes the
    training checkpoints>, its backward's mamba_scan_bwd_kernel<state
    capacity, u's type>."""
    out, kernel, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            mangled, kernel = m.group(1), m.group(1)
            # a length prefix may follow a namespace hash's digits: try
            # every suffix of each run of digits
            for d in re.finditer(r"\d+(?=[A-Za-z_])", mangled):
                k = next((k for k in range(d.start(), d.end()) if mangled[
                    d.end():d.end() + int(mangled[k:d.end()])].endswith(
                        ("_kernel", "_reduce"))), None)
                if k is not None:
                    ident = mangled[d.end():d.end() + int(mangled[k:d.end()])]
                    rest = mangled[d.end() + len(ident):]
                    args = template_args(rest[1:]) \
                        if rest.startswith("I") else []
                    kernel = ident + (f"<{', '.join(args)}>" if args else "")
                    break
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and kernel:
            out.append((kernel, line.split(":", 1)[-1].strip()
                        + (f"; {spill}" if spill else "")))
            kernel, spill = None, ""
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build

    print("phase 1: build")
    t0 = time.perf_counter()
    secs = build.build()
    print(f"  built {sorted(secs)} in {time.perf_counter() - t0:.2f} s ("
          + ", ".join(f"{n} done at {t:.1f} s" for n, t in secs.items())
          + ")")
    for name in build.sources():
        log = build.BUILD_DIR / f"{name}.log"
        for kernel, report in ptxas_report(
                log.read_text() if log.exists() else ""):
            print(f"  {name}: {kernel}: {report}")
            PTXAS[kernel] = report
    card = card_line()
    print(f"  {card}")
    print(f"  torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)}")

    t_script = t0
    S_main = SERVE_BUCKET + SERVE_NEW + SERVE_W + 2
    cur_main = [SERVE_BUCKET + (SERVE_NEW - 1) * i // 7 for i in range(8)]
    t0 = time.perf_counter()
    print(f"phase 2: kernels against their plain versions (main-path cache "
          f"S={S_main}, ragged cur_len={cur_main})")
    rec = phase_kernels(S_main, cur_main)

    cont_cur = [CONT_BUCKETS[0] + 40 * i for i in range(CONT_SLOTS)]
    print(f"phase 2b: K3 (paged pool, main-path page size {CONT_PAGE}, "
          f"ragged cur_len={cont_cur})")
    rec["paged_spec_attention"] = phase_k3(cont_cur)

    print(f"phase 2c: K4 (tree {TREE_WDB} ancestor tail, linear and paged,"
          f" ragged cur_len={cont_cur})")
    rec.update(phase_k4(cont_cur))

    print("phase 2d: K5 (selective scan, Jamba's d_inner 16384, d_state 16)"
          " and K1 at the hybrid's attention shape")
    k5 = phase_k5(S_main, cur_main)
    rec["mamba_scan"] = k5["prefill"]

    print("phase 2e: the kernels at the adaptive step's shapes "
          "(DEFAULT_ARMS: verify at (k, w + 1) = (25, 11), drafts at "
          "k = 25 and w 2, 4, 10)")
    phase_adaptive_kernels(S_main, cur_main, cont_cur)

    print("phase 2f: K1 and K3 at Gemma-2B's, GLM-4-9B's, Nemotron-4's, "
          "Qwen2-VL's and DeepSeek-MoE-16B's heads (verify and decode)")
    phase_arch_kernels(S_main, cur_main, cont_cur)
    t0 = took("phases 2-2f", t0)

    print("phase 3: serve")
    launches, tables, serve_out = phase_serve()
    t0 = took("phases 3-4", t0)

    print(f"phase 5: continuous batching over a {CONT_PAGES}-page pool "
          f"(bf16, {CONT_N} requests, {CONT_SLOTS} slots)")
    launches["paged_spec_attention"], cont_rates = phase_continuous(tables)
    t0 = took("phase 5", t0)

    print(f"phase 6: tree speculation (bf16, {TREE_N} requests of the tree "
          f"mix, {TREE_SLOTS} slots, bucket {TREE_BUCKET}, {TREE_NEW} new "
          f"tokens)")
    k4, tree_out = phase_tree(tables)
    launches.update(k4)
    took("phase 6", t0)

    print(f"phase 8: sampled serving (bf16, temperature {SAMPLE_T}, top_p "
          f"{SAMPLE_P}, beside greedy rows)")
    phase_sampling(tables, serve_out, tree_out)

    print("phase 9: in-flight adaptive (k, w) arms (bf16 StableLM, then "
          "f32)")
    adaptive = phase_adaptive(tables, cont_rates)

    print(f"phase 7: the hybrid (Jamba-1.5-Large, offsets {HYB_SERVE[1]}-"
          f"{sum(HYB_SERVE) - 1} of its period, no experts, full width)")
    t0 = time.perf_counter()
    hyb, hyb_adaptive = phase_hybrid()
    took("phase 7", t0)
    launches["mamba_scan"] = hyb["mamba_scan"]
    # each adaptive run's own launches (9a-9c, 7e), beside the main path's
    adaptive.update(hyb_adaptive)

    print("phase 10: the registry's other attention-only archs (Mistral-7B,"
          " Gemma-2B, GLM-4-9B, Nemotron-4, Qwen2-VL, HuBERT, StableLM's "
          "long-context variant)")
    archs = phase_archs(S_main, cur_main, tables)

    print("phase 11: training on the card (the reference's bench recipe, "
          "StableLM-2-1.6B at full width), then serving the trained weights")
    trained, (bwd_rec, bwd_launches) = phase_train()
    rec["mamba_scan_bwd"] = bwd_rec
    launches["mamba_scan_bwd"] = bwd_launches["mamba_scan_bwd"]

    print("phase 12: the MoE FFN and the xLSTM mixers (DeepSeek-MoE-16B, "
          "Mixtral-8x7B, Jamba with its experts, xLSTM-125M)")
    archs.update(phase_moe())

    print("phase 13: the contract checker (13a's checks ran inside phases "
          "3, 7, 10 and 12) and the examples")
    contract = phase_contract()

    print("phase 14: the mesh (ServingEngine(mesh=)) on a (1, 1) NCCL mesh: "
          "StableLM-2-1.6B bf16 beside the engine without a mesh, then f32 "
          "lossless; phase 15 (the recurrent mixers) in the same group")
    t0 = time.perf_counter()
    mesh_launches = phase_mesh(tables)
    took("phase 14", t0)

    print("phase 16: the dry-run (fake CUDA tensors on the reference's "
          "256- and 512-rank meshes), the shape functions against their "
          "kernels and a (1, 1) anchor on real tensors")
    t0 = time.perf_counter()
    phase_dryrun()
    took("phase 16", t0)

    cu = "src/repro_torch/kernels/csrc/spec_attention.cu"
    sources = {"spec_attention": (
                   cu, "src/repro/kernels/spec_attention.py:137"),
               "ngram_match": (
                   "src/repro_torch/kernels/csrc/ngram_match.cu",
                   "src/repro/kernels/ngram_match.py:50"),
               "paged_spec_attention": (
                   cu, "src/repro/kernels/spec_attention.py:204"),
               "tree_spec_attention": (
                   cu, "src/repro/kernels/spec_attention.py:174"),
               "paged_tree_spec_attention": (
                   cu, "src/repro/kernels/spec_attention.py:240"),
               "mamba_scan": (
                   "src/repro_torch/kernels/csrc/mamba_scan.cu",
                   "src/repro/kernels/mamba_scan.py:61"),
               # the gradient of the XLA scan the reference trains through
               "mamba_scan_bwd": (
                   "src/repro_torch/kernels/csrc/mamba_scan_bwd.cu",
                   "src/repro/models/mamba.py:84")}
    kernels = [dict(name=n, route="cuda", source=sources[n][0],
                    replaces=sources[n][1], launches=launches[n],
                    launches_adaptive={run: ls[n] for run, ls in
                                       adaptive.items() if ls.get(n)},
                    launches_archs={run: ls[n] for run, ls in archs.items()
                                    if ls.get(n)},
                    launches_trained={run: ls[n] for run, ls in
                                      trained.items() if ls.get(n)},
                    launches_contract={run: ls[n] for run, ls in
                                       contract.items() if ls.get(n)},
                    launches_mesh=mesh_launches.get(n, 0),
                    **rec[n])
               for n in sources]
    took("the script", t_script)
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(phase16_card() if sys.argv[1:] == ["--phase16"] else main())
