"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test carries the ``gpu`` marker and skips without a CUDA device.
This file imports neither JAX nor the reference package, so it also runs
on a machine with only the port's dependencies:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

Shapes are those of ``chip_smoke.py``'s main path (StableLM-2-1.6B, B=8,
k=10, w=10, S=332) plus GQA, MQA, hd up to 256 and a 2048-slot cache, and
the bf16 kernel's fragment edges (16-row fragments that cross a head or
span several drafts, one fragment a warp at hd 128 as the hybrid's
decode runs, hd 80/96/256, cache rows aligned below 16 bytes, trees of
265 inputs); K4's are phase 2c's (tree (4, 5, 2), 69 inputs, and
others); K5's are phase 2d's (Jamba's d_inner 16384 at the prefill,
verify, decode and replay shapes, B and C as views of an x_proj output
whose rows are 16-byte aligned as Jamba's are, and odd ones whose rows are
not), with f32 and bf16 u.
Tolerances: K1, K3 and K4 f32 2e-5, bf16 2e-2 (the reference's kernel
tolerance); K2 bit-exact in both strategies (drafts, valid, n_ctx) at
phase 2's shapes and adversarial rows, and a mixed spec_step drafts in
exactly one K2 launch, serving the CPU's tokens; K3 over a shuffled pool
equals K1 over the gathered linear view bit for bit, and K4 over the pool
equals K4 over the gathered view; paged continuous serving equals linear continuous serving
token for token (tiny f32 model), with a tree too.  K5 f32 rtol = atol =
2e-4 (the reference's kernel tolerance), and a tiny f32 hybrid served
through K5 equals its greedy reference, paged and linear.  K5 computes a
token with the same bits whatever the chunking of its calls (torch.equal).
K5's backward: f32 relative 1e-4 of its plain version on every gradient
(the same f32 recurrence in another summation order, ~1e-6 measured),
the same bits on a second run; K5's training instance writes, as its
checkpoints, the bits of K5's own final state at every CHUNK-th step, and
leaves y and hT as the serving instance has them; the smoke hybrid's f32
train steps on the
card (K5 forward, K5's backward) give the CPU's losses and grad norms
within 1e-4 (TRAIN_CPU_TOL's limit).
The bf16 verify kernel keeps P to ~16 bits for P.V (a bf16 head and
remainder): its max abs error at the main verify shape stays within
P_SPLIT_ERR, half of what one bf16 P allowed.  Sampling: the threefry
keys, bits and uniforms of ``core/prng.py`` on the card equal the CPU's
bit for bit (gumbel noise to 1e-6), and sampled spec_steps (linear,
paged, tree) draw the CPU's tokens with the same keys, the
temperature-0 row equal to the greedy-only step's.  Adaptive arms:
masked spec_steps (linear, paged, tree, sampled) choose the CPU's arms and
serve its tokens, with its arm stats (rewards to 1e-6); an adaptive step
makes no synchronising call, and launches K2 once per distinct arm depth.
The registry's other architectures: K1 and K3 at Nemotron-4's (96 / 8 /
192) and Gemma-2B's (8 / 1 / 256) full head shapes, verify and decode;
the plain verify that a sliding-window config runs equals the CPU's
within f32 1e-5 over a wrapped ring.  The MoE FFN and the xLSTM mixers
(torch ops, no kernel): ``moe_scatter`` on the card drops the CPU's
token-slots and gives its output within f32 1e-5, the same bits on a
second call; the mLSTM and sLSTM cells within f32 1e-5 of the CPU's, the
replay's kept state bit-equal to per-step states then
``select_step_state``; deepseek-smoke and xlstm-smoke served on the card
equal ``greedy_reference``.  The contract checker: deepseek-smoke's and
qwen2-vl-smoke's mixed steps make no synchronising call, and the
checker's level 1 finds nothing over its registry on the card.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.mamba_scan import mamba_scan_cuda, mamba_scan_plain
from repro_torch.kernels.ngram_match import ngram_draft_cuda, ngram_draft_plain
from repro_torch.kernels.ref import gather_pages
from repro_torch.core.tree import topology
from repro_torch.kernels.spec_attention import (paged_spec_attention_cuda,
                                                paged_spec_attention_plain,
                                                spec_attention_cuda,
                                                spec_attention_plain,
                                                tree_mask)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
P_SPLIT_ERR = 2.5e-3
MAIN_CUR = [256, 265, 274, 283, 292, 301, 310, 319]


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol, atol=tol)


# ----------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,K,W1,H,KV,hd,S,cur", [
    (8, 10, 11, 32, 32, 64, 332, [256, 265, 274, 283, 292, 301, 310, 319]),
    (8, 1, 1, 32, 32, 64, 332, [256, 265, 274, 283, 292, 301, 310, 319]),
    (2, 25, 11, 32, 8, 128, 2048, [2000, 0]),
    (2, 3, 4, 32, 1, 256, 300, [299, 64]),
    (2, 2, 41, 4, 2, 80, 200, [205, 7]),      # tail > 32 keys, cur_len > S
    # bf16 fragments of 16 packed (head, row) rows: G*K*W1 = 168 crosses a
    # head boundary inside a fragment, each fragment spans 3 drafts (W1 7)
    # or 6 (W1 3); hd 80 / 96 pad to the 128 instance, 256 reads Q from
    # shared memory over 32-key tiles
    (2, 3, 7, 16, 2, 64, 150, [100, 37]),
    (2, 5, 3, 16, 2, 96, 130, [129, 0]),
    (2, 3, 7, 16, 2, 80, 90, [64, 65]),
    (2, 3, 7, 16, 2, 256, 100, [99, 33]),
    # one fragment a warp at hd 128: the hybrid's decode (8 rows of a
    # (b, KV head)) and 40 rows over 3 warps; the hybrid's replay (KW1 11)
    (8, 1, 1, 64, 8, 128, 332, [256, 265, 274, 283, 292, 301, 310, 319]),
    (2, 2, 5, 16, 4, 128, 300, [299, 64]),
    (8, 1, 11, 64, 8, 128, 332, [256, 265, 274, 283, 292, 301, 310, 319])])
def test_spec_attention_cuda_matches_plain(cuda_device, B, K, W1, H, KV, hd,
                                           S, cur, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    td = getattr(torch, dtype)
    rn = lambda *s: torch.randn(s, generator=g, device=cuda_device).to(td)
    ops = (rn(B, K, W1, H, hd), rn(B, S, KV, hd), rn(B, S, KV, hd),
           rn(B, K, W1, KV, hd), rn(B, K, W1, KV, hd),
           torch.tensor(cur, dtype=torch.int32, device=cuda_device))
    got = spec_attention_cuda(*ops, w1=W1)
    want = spec_attention_plain(*ops, w1=W1)
    torch.cuda.synchronize()
    _close(got, want, TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("paged", [False, True])
def test_spec_attention_bf16_p_split_error_bound(cuda_device, paged):
    """bf16 K1 and K3 at StableLM's verify shape (B=8, k=10, w=10, H=KV=32,
    hd 64, S=332, page 64) stay within P_SPLIT_ERR of the plain version (f32
    P): P enters P.V as a bf16 head and remainder."""
    W1 = 11
    if paged:
        ops = _paged_inputs(cuda_device, 8, 10, W1, 32, 32, 64, 64, MAIN_CUR,
                            "bfloat16", seed=1)
        got = paged_spec_attention_cuda(*ops, w1=W1)
        want = paged_spec_attention_plain(*ops, w1=W1)
    else:
        g = torch.Generator(device=cuda_device).manual_seed(1)
        rn = lambda *s: torch.randn(s, generator=g, device=cuda_device).to(
            torch.bfloat16)
        ops = (rn(8, 10, W1, 32, 64), rn(8, 332, 32, 64), rn(8, 332, 32, 64),
               rn(8, 10, W1, 32, 64), rn(8, 10, W1, 32, 64),
               torch.tensor(MAIN_CUR, dtype=torch.int32, device=cuda_device))
        got = spec_attention_cuda(*ops, w1=W1)
        want = spec_attention_plain(*ops, w1=W1)
    err = float((got.float() - want.float()).abs().max())
    assert err <= P_SPLIT_ERR, err


SENTINEL_TOKEN = 1097884494     # 0x4170634E: its w=1 hash is 0xFFFFFFFF


def _k2_case(device, name):
    """(buf, buf_len, q, k, w, vocab or the hand tables) of one K2 case:
    phase 2's shapes (the main path's B=8, L=332 and long rows of repeated
    text, q, w, k and vocabulary variants) and its adversarial rows."""
    rng = np.random.default_rng(sum(map(ord, name)))
    text = rng.integers(32, 127, 211).astype(np.int32)       # byte "text"
    V = 100352

    def rows(B, L, cur):
        buf = np.zeros((B, L), np.int32)
        for b, c in enumerate(cur):
            buf[b, :c] = np.roll(np.resize(text, L), 17 * b)[:c]
        return buf, np.array(cur, np.int32)
    q, k, w = 1, 10, 10
    if name == "main":
        buf, cur = rows(8, 332, MAIN_CUR)
    elif name == "L4096":
        buf, cur = rows(4, 4096, [4096, 4000, 2500, 300])
    elif name == "L32768":
        buf, cur = rows(2, 32768, [32768, 20001])
    elif name == "q2w5":
        (buf, cur), q, k, w = rows(3, 4097, [4097, 1000, 3]), 2, 8, 5
    elif name == "q4w16_jamba":
        (buf, cur), q, w, V = rows(3, 1000, [1000, 999, 517]), 4, 16, 65536
    elif name == "k_max":
        (buf, cur), k = rows(8, 332, MAIN_CUR), 25
    elif name == "match_everywhere":
        buf = np.full((2, 32768), 5, np.int32)
        buf[1, 1::2] = 6
        cur = np.array([32768, 32765], np.int32)
    elif name == "sentinel":
        buf = rng.integers(0, 4, (3, 4099)).astype(np.int32)
        buf[:, 100:4000:6] = 7
        buf[:, 101:4000:12] = SENTINEL_TOKEN
        buf[:, 4000] = 7
        cur, w = np.array([4001, 4001, 333], np.int32), 1
    elif name == "too_short":
        buf = rng.integers(0, 3, (4, 300)).astype(np.int32)
        cur, q = np.array([0, 1, 2, 3], np.int32), 2
    elif name == "few_reps":
        buf = np.tile(np.array([1, 2, 3, 1, 4, 4], np.int32), (2, 60))
        cur, k, w = np.array([360, 97], np.int32), 25, 2
    else:                                                    # dup_tail
        buf = np.zeros((2, 30), np.int32)
        buf[:, 5:9] = [1, 2, 4, 5]
        buf[:, 20] = 1
        buf[1, 12:16] = [1, 3, 8, 9]
        cur, k, w = np.array([21, 21], np.int32), 4, 3
        chain = np.tile(np.arange(6, dtype=np.int32) + 4, (12, 1))
        chain[2] = [4, 5, 6, 7, 8, 9]
        V = (np.tile(np.array([2, 2, 2, 3, 4, 5], np.int32), (12, 1)), chain)
    t = lambda a: torch.as_tensor(a, device=device)
    return t(buf), t(cur), q, k, w, V


def _k2_tables(device, V):
    """Seeded tables of the engine's shape (k_max 25, w_max 16), or the
    hand tables of a case."""
    if isinstance(V, tuple):
        return tuple(torch.as_tensor(a, device=device) for a in V)
    g = torch.Generator(device=device).manual_seed(V)
    return tuple(torch.randint(0, V, (V, n), generator=g, device=device,
                               dtype=torch.int32) for n in (25, 16))


@pytest.mark.gpu
@pytest.mark.parametrize("strategy", ["context", "mixed"])
@pytest.mark.parametrize("case", ["main", "L4096", "L32768", "q2w5",
                                  "q4w16_jamba", "k_max", "match_everywhere",
                                  "sentinel", "too_short", "few_reps",
                                  "dup_tail"])
def test_ngram_match_cuda_matches_plain(cuda_device, case, strategy):
    """K2 equals its plain version bit for bit: drafts, valid, n_ctx."""
    buf, cl, q, k, w, V = _k2_case(cuda_device, case)
    kw = {}
    if strategy == "mixed":
        topk, chain = _k2_tables(cuda_device, V)
        last = buf.gather(1, torch.remainder(cl.long() - 1, buf.shape[1])
                          [:, None])[:, 0].contiguous()
        kw = dict(last=last, bigram_topk=topk, bigram_chain=chain)
    got = ngram_draft_cuda(buf, cl, q=q, k=k, w=w, **kw)
    want = ngram_draft_plain(buf, cl, q=q, k=k, w=w, **kw)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _to(tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {key: _to(v, device) for key, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, device) for v in tree)
    return tree


@pytest.mark.gpu
def test_mixed_step_drafts_in_one_launch(cuda_device):
    """One mixed spec_step on the card launches K2 exactly once, and the
    steps serve the tokens the CPU's plain path serves (tiny f32 model, the
    same weights and tables on both)."""
    from repro_torch.core import spec_engine as E
    from repro_torch.core.ngram_tables import NGramTables
    from repro_torch.models import model as M
    from repro_torch.models.config import ModelConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ModelConfig(name="tiny", num_layers=2, d_model=64, num_heads=4,
                      num_kv_heads=2, d_ff=128, vocab_size=259,
                      param_dtype=torch.float32,
                      compute_dtype=torch.float32).validate()
    spec = E.SpecConfig(k=4, w=3, strategy="mixed", max_new_tokens=12)
    rng = np.random.default_rng(3)
    tab = NGramTables(torch.arange(8, dtype=torch.int32),
                      torch.as_tensor(rng.integers(0, 259, (259, 8)),
                                      dtype=torch.int32),
                      torch.as_tensor(rng.integers(0, 259, (259, 6)),
                                      dtype=torch.int32))
    text = np.frombuffer(b"def f(x): return x + 1; def g(x): return f(x)",
                         np.uint8).astype(np.int32)
    prompt = torch.as_tensor(np.stack([text[:32], text[8:40]]))
    params = M.init_params(cfg, seed=0, device="cpu")
    states = {}
    for dev in ("cpu", "cuda"):
        p = params if dev == "cpu" else _to(params, dev)
        t = tab if dev == "cpu" else NGramTables(*(_to(a, dev) for a in (
            tab.unigram_topk, tab.bigram_topk, tab.bigram_chain)))
        s = E.init_decode_state(p, cfg, spec, prompt.to(dev))
        for i in range(4):
            before = ngram_draft_cuda.launches
            s = E.spec_step(p, cfg, spec, s, t)
            if dev == "cuda":
                assert ngram_draft_cuda.launches == before + 1
        states[dev] = s
    assert torch.equal(states["cuda"].buf.cpu(), states["cpu"].buf)
    assert torch.equal(states["cuda"].buf_len.cpu(), states["cpu"].buf_len)
    assert int(states["cpu"].buf_len.min()) >= 32 + 4


def _paged_inputs(device, B, K, W1, H, KV, hd, ps, cur, dtype, seed=0):
    """K3 operands: the pool is a layer's view into an R-stacked engine
    pool, each row's pages are shuffled, and -1 past what cur_len needs."""
    g = torch.Generator(device=device).manual_seed(seed)
    td = getattr(torch, dtype)
    rn = lambda *s: torch.randn(s, generator=g, device=device).to(td)
    pps = max(1, -(-max(cur) // ps) + 1)
    NP = B * pps + 3
    perm = torch.randperm(NP, generator=g, device=device).to(torch.int32)
    pt = perm[:B * pps].reshape(B, pps).clone()
    for b, c in enumerate(cur):
        pt[b, -(-c // ps):] = -1
    k_pool, v_pool = rn(2, NP, ps, KV, hd)[1], rn(2, NP, ps, KV, hd)[1]
    return (rn(B, K, W1, H, hd), k_pool, v_pool, pt, rn(B, K, W1, KV, hd),
            rn(B, K, W1, KV, hd),
            torch.tensor(cur, dtype=torch.int32, device=device))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,K,W1,H,KV,hd,ps,cur", [
    (8, 10, 11, 32, 32, 64, 64, [256, 265, 274, 283, 292, 301, 310, 319]),
    (8, 1, 1, 32, 32, 64, 64, [256, 265, 274, 283, 292, 301, 310, 319]),
    (3, 4, 5, 32, 8, 128, 16, [700, 0, 333]),
    (2, 3, 4, 32, 1, 256, 128, [299, 129]),
    (2, 2, 41, 4, 2, 80, 1, [70, 7]),
    (2, 25, 11, 8, 4, 64, 5, [0, 0]),
    (2, 3, 7, 16, 2, 64, 5, [100, 37]),       # fragments cross heads
    (2, 5, 3, 16, 2, 96, 16, [129, 0]),
    (2, 3, 7, 16, 2, 80, 3, [64, 65]),
    (2, 3, 7, 16, 2, 256, 64, [99, 33]),
    # the hybrid's decode, verify and replay over the served page size
    (8, 1, 1, 64, 8, 128, 64, [64, 104, 144, 184, 224, 264, 304, 344]),
    (8, 10, 11, 64, 8, 128, 64, [64, 104, 144, 184, 224, 264, 304, 344]),
    (8, 1, 11, 64, 8, 128, 64, [64, 104, 144, 184, 224, 264, 304, 344])])
def test_paged_spec_attention_cuda_matches_plain_and_k1(cuda_device, B, K,
                                                        W1, H, KV, hd, ps,
                                                        cur, dtype):
    ops = _paged_inputs(cuda_device, B, K, W1, H, KV, hd, ps, cur, dtype)
    got = paged_spec_attention_cuda(*ops, w1=W1)
    want = paged_spec_attention_plain(*ops, w1=W1)
    q, kp, vp, pt, kt, vt, cl = ops
    k_lin, v_lin = gather_pages(kp, vp, pt)
    lin = spec_attention_cuda(q, k_lin, v_lin, kt, vt, cl, w1=W1)
    torch.cuda.synchronize()
    _close(got, want, TOL[dtype])
    assert torch.equal(got, lin), "K3 differs from K1 on the gathered view"


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("wdb,B,H,KV,hd,ps,cur", [
    ((4, 5, 2), 8, 32, 32, 64, 64, [64 + 40 * i for i in range(8)]),
    ((4, 5, 2), 3, 32, 8, 128, 16, [700, 0, 333]),
    ((3, 3, 2), 2, 32, 1, 256, 128, [299, 129]),
    ((16, 5, 1), 2, 8, 4, 64, 5, [70, 7]),
    ((6, 1, 2), 2, 4, 2, 80, 8, [33, 1]),
    ((4, 5, 2), 2, 8, 4, 64, 64, [0, 0]),
    # 265 inputs: ancestor rows reach back over several key tiles
    ((8, 5, 2), 2, 16, 2, 64, 16, [90, 0]),
    ((8, 5, 2), 1, 8, 1, 256, 64, [130]),
    ((4, 5, 2), 2, 16, 2, 96, 8, [40, 77])])  # fragments cross heads
def test_tree_kernels_match_plain(cuda_device, wdb, B, H, KV, hd, ps, cur,
                                  dtype):
    """K4 over the linear cache and over the pool against the plain version
    with the bool ancestor mask; over the pool it equals the linear one on
    the gathered view bit for bit."""
    topo = topology(*wdb)
    W1 = topo.num_nodes + 1
    tm = tree_mask(topo.anc_mask, cuda_device)
    q, kp, vp, pt, kt, vt, cl = _paged_inputs(cuda_device, B, 1, W1, H, KV,
                                              hd, ps, cur, dtype, seed=W1)
    k_lin, v_lin = gather_pages(kp, vp, pt)
    got_pg = paged_spec_attention_cuda(q, kp, vp, pt, kt, vt, cl, w1=W1,
                                       anc=tm.anc)
    got_lin = spec_attention_cuda(q, k_lin, v_lin, kt, vt, cl, w1=W1,
                                  anc=tm.anc)
    want = spec_attention_plain(q, k_lin, v_lin, kt, vt, cl, w1=W1,
                                tail_mask=tm.mask)
    want_pg = paged_spec_attention_plain(q, kp, vp, pt, kt, vt, cl, w1=W1,
                                         tail_mask=tm.mask)
    torch.cuda.synchronize()
    _close(got_lin, want, TOL[dtype])
    _close(got_pg, want_pg, TOL[dtype])
    assert torch.equal(got_pg, got_lin), "K4 paged differs from K4 linear"


def _offset_view(t, off):
    """``t``'s values in a buffer whose last dim is ``off`` longer, read at
    ``off``: the rows of the view start ``off`` elements past alignment."""
    buf = torch.zeros(t.shape[:-1] + (t.shape[-1] + off,), dtype=t.dtype,
                      device=t.device)
    buf[..., off:] = t
    return buf[..., off:]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd,off", [(36, 0), (64, 1)])
def test_spec_attention_cuda_unaligned_rows(cuda_device, hd, off, dtype):
    """Cache rows that do not start 16-byte aligned (hd = 4 x odd, which
    also leaves part of a 16-dim k step zero-padded, or a view offset by
    one element): bf16 copies them by plain loads instead of cp.async.  K1
    and K3 against the plain version, and K3 bit for bit against K1 on the
    gathered view."""
    from repro_torch.kernels.spec_attention import copy_width
    B, K, W1, H, KV = 2, 3, 7, 16, 2
    q, kp, vp, pt, kt, vt, cl = _paged_inputs(cuda_device, B, K, W1, H, KV,
                                              hd, 16, [90, 41], dtype)
    kp, vp = _offset_view(kp, off), _offset_view(vp, off)
    k_lin, v_lin = gather_pages(kp, vp, pt)
    k_off, v_off = _offset_view(k_lin, off), _offset_view(v_lin, off)
    if dtype == "bfloat16":
        assert copy_width((q, kp, vp, kt, vt), kp.stride()[:3] + (hd,)) \
            == 1
        assert copy_width((q, k_off, v_off, kt, vt),
                          k_off.stride()[:3] + (hd,)) == 1
    got_pg = paged_spec_attention_cuda(q, kp, vp, pt, kt, vt, cl, w1=W1)
    got_off = spec_attention_cuda(q, k_off, v_off, kt, vt, cl, w1=W1)
    got_lin = spec_attention_cuda(q, k_lin, v_lin, kt, vt, cl, w1=W1)
    want = spec_attention_plain(q, k_lin, v_lin, kt, vt, cl, w1=W1)
    torch.cuda.synchronize()
    _close(got_off, want, TOL[dtype])
    _close(got_pg, want, TOL[dtype])
    assert torch.equal(got_off, got_lin), "K1's copy width changed a bit"
    assert torch.equal(got_pg, got_lin), "K3 differs from K1 on the " \
                                         "gathered view"


@pytest.mark.gpu
def test_paged_continuous_equals_linear_on_the_card(cuda_device):
    """A tiny f32 model served continuously over a small paged pool (with
    deferrals) and over the linear layout: the same tokens, K3 launched."""
    from repro_torch.core.spec_engine import SpecConfig
    from repro_torch.models import model as M
    from repro_torch.models.cache import check_page_invariants
    from repro_torch.models.config import ModelConfig
    from repro_torch.serving.engine import ServingEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ModelConfig(name="tiny", num_layers=2, d_model=64, num_heads=4,
                      num_kv_heads=2, d_ff=128, vocab_size=259,
                      param_dtype=torch.float32,
                      compute_dtype=torch.float32).validate()
    params = M.init_params(cfg, seed=0, device="cuda")
    outs = {}
    for tree in (False, True):
        for paged in (False, True):
            eng = ServingEngine(params, cfg, SpecConfig(k=4, w=3, tree=tree),
                                max_batch=3, buckets=(16, 32),
                                max_new_cap=14, paged=paged,
                                num_pages=9 if paged else None, page_size=8)
            for i in range(7):
                text = f"def f{i}(x): return x * {i} + 1"
                eng.submit((text * 2)[:30] if i % 3 == 1 else text[:14],
                           max_new_tokens=(6, 10, 14)[i % 3])
            fn = paged_spec_attention_cuda if paged else spec_attention_cuda
            fn.launches = fn.tree_launches = 0
            done = sorted(eng.serve_continuous(),
                          key=lambda r: r.request_id)
            outs[tree, paged] = [r.output_ids for r in done]
            assert (fn.tree_launches if tree else fn.launches) > 0
            if paged:
                st = eng.pool_stats()
                assert st["deferrals"] > 0 and st["rejected"] == 0
                assert check_page_invariants(
                    eng._cont_state.model)["free"] == 9
    for key in outs:
        for a, b in zip(outs[False, False], outs[key]):
            np.testing.assert_array_equal(a, b)


def _scan_inputs(device, Bt, T, di, ds, rep, dtr, u_dtype, seed):
    """K5 operands; B and C are views of an x_proj output of dtr + 2 ds
    columns (dtr 512, Jamba's: rows 16-byte aligned, cp.async staging; an
    odd dtr: plain-load staging)."""
    g = torch.Generator(device=device).manual_seed(seed)
    rn = lambda *s: torch.randn(s, generator=g, device=device)
    u, dt = rn(Bt, T, di), torch.nn.functional.softplus(rn(Bt, T, di))
    A = -torch.exp(rn(di, ds) * 0.3)
    proj = rn(Bt, T, dtr + 2 * ds)
    B, C = proj[..., dtr:dtr + ds], proj[..., dtr + ds:]
    return (u.to(getattr(torch, u_dtype)), dt, A, B, C, rn(di),
            rn(Bt // rep, di, ds))


@pytest.mark.gpu
@pytest.mark.parametrize("u_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Bt,T,di,ds,rep,commit,dtr", [
    (8, 256, 16384, 16, 1, None, 512),           # prefill
    (80, 11, 16384, 16, 10, None, 512),          # verify: 8 slots x k=10
    (8, 1, 16384, 16, 1, None, 512),             # decode
    (8, 11, 16384, 16, 1, [0, 1, 3, 5, 7, 9, 11, 11], 512),  # replay
    (3, 37, 200, 8, 1, [37, 20, 0], 5),          # odd T and di
    (4, 1, 130, 2, 2, [1, 0, 1, 1], 5),
    (2, 20, 72, 12, 1, [3, 25], 4)])             # ds below the capacity
def test_mamba_scan_cuda_matches_plain(cuda_device, Bt, T, di, ds, rep,
                                       commit, dtr, u_dtype):
    ops = _scan_inputs(cuda_device, Bt, T, di, ds, rep, dtr, u_dtype,
                       seed=T + di)
    n = None if commit is None else torch.tensor(
        commit, dtype=torch.int32, device=cuda_device)
    got = mamba_scan_cuda(*ops, h0_rep=rep, n_commit=n)
    want = mamba_scan_plain(*ops, h0_rep=rep, n_commit=n)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        if b is None:
            assert a is None
        else:
            _close(a, b, 2e-4)


@pytest.mark.gpu
def test_mamba_scan_cuda_is_invariant_to_chunking(cuda_device):
    """A 256-step scan in one call equals the same tokens fed as chained
    calls of 11 (verify's length) and then single-step decodes through
    hT -> h0; the replay's kept state with n_commit = t equals the final
    state of a t-step call, and with mixed n_commit equals
    select_step_state over those final states; bf16 u equals its f32 upcast; plain-load
    staging equals cp.async staging.  torch.equal throughout."""
    from repro_torch.models.cache import select_step_state
    T, W1, ds = 256, 11, 16
    u, dt, A, B, C, D, h0 = _scan_inputs(cuda_device, 8, T, 16384, ds, 1,
                                         512, "bfloat16", seed=21)
    cut = lambda t0, t1: (u[:, t0:t1].contiguous(),
                          dt[:, t0:t1].contiguous(), A, B[:, t0:t1],
                          C[:, t0:t1], D)
    y, hT, _ = mamba_scan_cuda(u, dt, A, B, C, D, h0)
    ys, h, t = [], h0, 0
    for n in [W1] * (T // W1) + [1] * (T % W1):
        y_i, h, _ = mamba_scan_cuda(*cut(t, t + n), h)
        ys.append(y_i)
        t += n
    assert torch.equal(torch.cat(ys, 1), y) and torch.equal(h, hT)
    hs = []  # the final state of a t-step call, t = 1 .. W1
    for t in range(1, W1 + 1):
        hs.append(mamba_scan_cuda(*cut(0, t), h0)[1])
        n_t = torch.full((8,), t, dtype=torch.int32, device=cuda_device)
        y_t, kept, _ = mamba_scan_cuda(*cut(0, W1), h0, n_commit=n_t)
        assert torch.equal(kept, hs[-1]) and torch.equal(y_t, y[:, :W1])
    n_commit = torch.tensor([0, 1, 3, 5, 7, 9, W1, W1 + 4],
                            dtype=torch.int32, device=cuda_device)
    y_c, kept, _ = mamba_scan_cuda(*cut(0, W1), h0, n_commit=n_commit)
    assert torch.equal(y_c, y[:, :W1])
    assert torch.equal(kept, select_step_state(torch.stack(hs, 1), h0,
                                               n_commit))
    y32, h32, _ = mamba_scan_cuda(u.float(), dt, A, B, C, D, h0)
    assert torch.equal(y32, y) and torch.equal(h32, hT)
    proj = torch.zeros(8, T, 7 + 2 * ds, device=cuda_device)
    proj[..., 7:7 + ds], proj[..., 7 + ds:] = B, C
    y_p, h_p, _ = mamba_scan_cuda(u, dt, A, proj[..., 7:7 + ds],
                                  proj[..., 7 + ds:], D, h0)
    assert torch.equal(y_p, y) and torch.equal(h_p, hT)


@pytest.mark.gpu
def test_hybrid_serving_is_lossless_on_the_card(cuda_device):
    """A tiny f32 hybrid (Mamba, attention) served speculatively, static
    and continuous over a small pool and the linear layout: every output
    equals greedy_reference, and K5 carried the scans."""
    from repro_torch.core.spec_engine import SpecConfig, greedy_reference
    from repro_torch.models import model as M
    from repro_torch.models.config import BlockSpec, ModelConfig
    from repro_torch.serving.engine import ServingEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ModelConfig(name="tiny-hyb", num_layers=2, d_model=64,
                      num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=259,
                      block_pattern=(BlockSpec("mamba", "swiglu"),
                                     BlockSpec("attn", "swiglu")),
                      rope="none", param_dtype=torch.float32,
                      compute_dtype=torch.float32).validate()
    params = M.init_params(cfg, seed=0, device="cuda")
    for paged in (None, False, True):
        eng = ServingEngine(params, cfg, SpecConfig(k=4, w=3), max_batch=3,
                            buckets=(16, 32), max_new_cap=14,
                            paged=bool(paged), num_pages=9 if paged else None,
                            page_size=8)
        for i in range(5):
            text = f"def f{i}(x): return x * {i} + 1"
            eng.submit((text * 2)[:30] if i % 3 == 1 else text[:14],
                       max_new_tokens=(6, 10, 14)[i % 3])
        mamba_scan_cuda.launches = 0
        done = (eng.serve_all() if paged is None
                else eng.serve_continuous())
        assert mamba_scan_cuda.launches > 0
        for r in done:
            toks = eng.scheduler.pad_to_bucket(eng.tok.encode(r.prompt))
            ref = greedy_reference(params, cfg, toks[None],
                                   r.stats["new_tokens"])
            np.testing.assert_array_equal(r.output_ids,
                                          ref[0, len(toks):].cpu().numpy())


# ----------------------------------------------------------------------------
# lossless sampling: the threefry keys and the sampled step on the card
# ----------------------------------------------------------------------------
@pytest.mark.gpu
def test_prng_on_the_card_equals_the_cpu(cuda_device):
    """Keys, bits and uniforms are integer work: bit for bit the CPU's.
    Gumbel noise differs at most by ``log``'s last bit."""
    from repro_torch.core import prng
    key = prng.prng_key(2**31 + 11)
    keys = prng.split(key, 3)
    on = lambda t: t.to(cuda_device)
    assert torch.equal(prng.split(on(keys)).cpu(), prng.split(keys))
    lv = torch.arange(11)
    assert torch.equal(prng.fold_in(on(keys)[:, None], on(lv)[None]).cpu(),
                       prng.fold_in(keys[:, None], lv[None]))
    assert torch.equal(prng.random_bits32(on(keys), (100352,)).cpu(),
                       prng.random_bits32(keys, (100352,)))
    assert torch.equal(prng.uniform(on(keys), (100352,)).cpu(),
                       prng.uniform(keys, (100352,)))
    _close(prng.gumbel(on(keys), (100352,)), prng.gumbel(keys, (100352,)),
           1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["linear", "paged", "tree"])
def test_sampled_spec_step_equals_the_cpu(cuda_device, layout):
    """Sampled spec_steps of a tiny f32 model (a sampled row beside a
    temperature-0 one) draw the CPU's tokens and carry the CPU's keys on
    the card, through K1, K3 or K4; the temperature-0 row equals the
    greedy-only step's."""
    import dataclasses
    from repro_torch.core import prng
    from repro_torch.core import spec_engine as E
    from repro_torch.core.ngram_tables import NGramTables
    from repro_torch.models import model as M
    from repro_torch.models.config import ModelConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ModelConfig(name="tiny", num_layers=2, d_model=64, num_heads=4,
                      num_kv_heads=2, d_ff=128, vocab_size=259,
                      param_dtype=torch.float32,
                      compute_dtype=torch.float32).validate()
    spec = E.SpecConfig(k=4, w=3, strategy="mixed", max_new_tokens=16,
                        sampling=True)
    if layout == "tree":
        spec = dataclasses.replace(spec, w=5, tree=True, tree_branch=2)
    paged = E.PagedConfig(page_size=8) if layout == "paged" else None
    rng = np.random.default_rng(3)
    tab = NGramTables(torch.arange(8, dtype=torch.int32),
                      torch.as_tensor(rng.integers(0, 259, (259, 8)),
                                      dtype=torch.int32),
                      torch.as_tensor(rng.integers(0, 259, (259, 6)),
                                      dtype=torch.int32))
    text = np.frombuffer(b"def f(x): return x + 1; def g(x): return f(x)",
                         np.uint8).astype(np.int32)
    prompt = torch.as_tensor(np.stack([text[:32], text[8:40]]))
    params = M.init_params(cfg, seed=0, device="cpu")
    samp = dict(temperature=torch.tensor([0.0, 0.9]),
                top_p=torch.tensor([1.0, 0.9]), rng=prng.prng_key(5))
    fn = paged_spec_attention_cuda if paged else spec_attention_cuda
    states = {}
    for dev, sp, kw in (("cpu", spec, samp), ("cuda", spec, samp),
                        ("greedy", dataclasses.replace(spec, sampling=False),
                         {})):
        on = "cpu" if dev == "cpu" else "cuda"
        p, t = _to(params, on), NGramTables(*(_to(a, on) for a in (
            tab.unigram_topk, tab.bigram_topk, tab.bigram_chain)))
        s = E.init_decode_state(p, cfg, sp, prompt.to(on), paged=paged,
                                **_to(kw, on))
        fn.launches = fn.tree_launches = 0
        for _ in range(4):
            s = E.spec_step(p, cfg, sp, s, t)
        if on == "cuda":
            assert (fn.tree_launches if spec.tree else fn.launches) > 0
        states[dev] = s
    for leaf in ("buf", "buf_len", "rng_key"):
        assert torch.equal(getattr(states["cuda"], leaf).cpu(),
                           getattr(states["cpu"], leaf)), leaf
    assert torch.equal(states["cuda"].buf[0].cpu(),
                       states["greedy"].buf[0].cpu())
    assert int(states["cpu"].buf_len.min()) >= 32 + 5


@pytest.mark.gpu
def test_sampled_step_does_not_synchronise(cuda_device):
    """A sampled mixed spec_step on the card makes no call that waits for
    the device (torch's sync debug mode raises on one): its keys split
    and its noise is drawn on the card, as a captured step needs."""
    from repro_torch.core import prng
    from repro_torch.core import spec_engine as E
    from repro_torch.core.ngram_tables import NGramTables
    from repro_torch.models import model as M
    from repro_torch.models.config import ModelConfig
    cfg = ModelConfig(name="tiny", num_layers=2, d_model=64, num_heads=4,
                      num_kv_heads=2, d_ff=128, vocab_size=259,
                      param_dtype=torch.float32,
                      compute_dtype=torch.float32).validate()
    spec = E.SpecConfig(k=4, w=3, strategy="mixed", max_new_tokens=16,
                        sampling=True)
    params = M.init_params(cfg, seed=0, device="cuda")
    rng = np.random.default_rng(3)
    tab = NGramTables(*(torch.as_tensor(a, dtype=torch.int32,
                                        device=cuda_device) for a in (
        np.arange(8), rng.integers(0, 259, (259, 8)),
        rng.integers(0, 259, (259, 6)))))
    prompt = torch.as_tensor(rng.integers(0, 259, (2, 24)),
                             dtype=torch.int32, device=cuda_device)
    s = E.init_decode_state(params, cfg, spec, prompt,
                            temperature=torch.tensor([0.0, 0.9]),
                            top_p=0.9, rng=prng.prng_key(5))
    s = E.spec_step(params, cfg, spec, s, tab)        # warm the allocator
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            s = E.spec_step(params, cfg, spec, s, tab)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert int(s.buf_len.min()) >= 24 + 4


def _adaptive_setup(device, k_max=8, w_max=6):
    """A tiny f32 byte-vocabulary model, seeded tables of (k_max, w_max)
    and two prompts of code, on the CPU; the card's copies on ``device``."""
    from repro_torch.core.ngram_tables import NGramTables
    from repro_torch.models import model as M
    from repro_torch.models.config import ModelConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ModelConfig(name="tiny", num_layers=2, d_model=64, num_heads=4,
                      num_kv_heads=2, d_ff=128, vocab_size=259,
                      param_dtype=torch.float32,
                      compute_dtype=torch.float32).validate()
    rng = np.random.default_rng(3)
    tab = NGramTables(torch.arange(k_max, dtype=torch.int32),
                      torch.as_tensor(rng.integers(0, 259, (259, k_max)),
                                      dtype=torch.int32),
                      torch.as_tensor(rng.integers(0, 259, (259, w_max)),
                                      dtype=torch.int32))
    text = np.frombuffer(b"def f(x): return x + 1; def g(x): return f(x)",
                         np.uint8).astype(np.int32)
    prompt = torch.as_tensor(np.stack([text[:32], text[8:40]]))
    params = M.init_params(cfg, seed=0, device="cpu")
    on = {"cpu": (params, tab),
          "cuda": (_to(params, device), NGramTables(*(_to(a, device) for a
                   in (tab.unigram_topk, tab.bigram_topk,
                       tab.bigram_chain))))}
    return cfg, prompt, on


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["linear", "paged", "tree", "sampled"])
def test_adaptive_spec_step_equals_the_cpu(cuda_device, layout):
    """Adaptive spec_steps of a tiny f32 model (arms masked inside a (4, 3)
    box; a (3, 4) tree's (width, depth) arms; sampled rows beside a
    temperature-0 one) choose the CPU's arms and serve its tokens through
    K1, K3 or K4 and K2, with the CPU's arm stats."""
    import dataclasses
    from repro_torch.core import prng
    from repro_torch.core import spec_engine as E
    cfg, prompt, on = _adaptive_setup(cuda_device)
    spec = E.SpecConfig(k=4, w=3, strategy="mixed", max_new_tokens=16,
                        arms=((1, 0), (2, 2), (3, 1), (4, 3)))
    kw = {}
    if layout == "tree":
        spec = E.SpecConfig(k=3, w=4, strategy="mixed", max_new_tokens=16,
                            tree=True, tree_branch=2,
                            arms=((1, 0), (2, 2), (3, 4)))
    if layout == "sampled":
        spec = dataclasses.replace(spec, sampling=True)
        kw = dict(temperature=torch.tensor([0.0, 0.9]),
                  top_p=torch.tensor([1.0, 0.9]), rng=prng.prng_key(5))
    paged = E.PagedConfig(page_size=8) if layout == "paged" else None
    fn = paged_spec_attention_cuda if paged else spec_attention_cuda
    states = {}
    for dev in ("cpu", "cuda"):
        p, t = on[dev]
        s = E.init_decode_state(p, cfg, spec, prompt.to(dev), paged=paged,
                                **_to(kw, dev))
        fn.launches = fn.tree_launches = 0
        for _ in range(8):
            s = E.spec_step(p, cfg, spec, s, t)
        if dev == "cuda":
            assert (fn.tree_launches if spec.tree else fn.launches) > 0
        states[dev] = s
    gpu, cpu = states["cuda"], states["cpu"]
    for leaf in ("buf", "buf_len", "rng_key"):
        assert torch.equal(getattr(gpu, leaf).cpu(), getattr(cpu, leaf)), leaf
    for key in ("arm_pulls", "arm_last", "calls", "tokens", "accept_hist"):
        assert torch.equal(gpu.stats[key].cpu(), cpu.stats[key]), key
    _close(gpu.stats["arm_reward"], cpu.stats["arm_reward"], 1e-6)
    assert torch.equal(cpu.stats["arm_pulls"].sum(1), cpu.stats["calls"])
    assert int(cpu.stats["calls"].min()) >= 3


@pytest.mark.gpu
@pytest.mark.parametrize("paged", [False, True], ids=["linear", "paged"])
def test_adaptive_step_does_not_synchronise(cuda_device, paged):
    """An adaptive mixed spec_step on the card makes no call that waits
    for the device (torch's sync debug mode raises on one): the arm
    table's tensors are built once per (table, device), and the choice,
    the per-depth drafts and the bandit update stay on the card."""
    from repro_torch.core import spec_engine as E
    cfg, prompt, on = _adaptive_setup(cuda_device)
    spec = E.SpecConfig(k=4, w=3, strategy="mixed", max_new_tokens=16,
                        arms=((1, 0), (2, 2), (3, 1), (4, 3)))
    p, t = on["cuda"]
    s = E.init_decode_state(p, cfg, spec, prompt.to(cuda_device),
                            paged=E.PagedConfig(page_size=8) if paged
                            else None)
    s = E.spec_step(p, cfg, spec, s, t)     # builds the arm tensors
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            s = E.spec_step(p, cfg, spec, s, t)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert torch.equal(s.stats["arm_pulls"].sum(1), s.stats["calls"])
    assert int(s.stats["calls"].sum()) == 6


@pytest.mark.gpu
def test_adaptive_step_launches_k2_once_per_arm_depth(cuda_device):
    """The default arm table (depths 2, 4 and 10 at k = 25): every adaptive
    step launches K2 three times, whatever arms the slots pick."""
    from repro_torch.core import spec_engine as E
    from repro_torch.core.controller import DEFAULT_ARMS
    from repro_torch.kernels.dispatch import unique_sweep_widths
    cfg, prompt, on = _adaptive_setup(cuda_device, k_max=25, w_max=16)
    spec = E.SpecConfig(k=25, w=10, strategy="mixed", max_new_tokens=24,
                        arms=DEFAULT_ARMS)
    p, t = on["cuda"]
    s = E.init_decode_state(p, cfg, spec, prompt.to(cuda_device))
    depths = len(unique_sweep_widths(DEFAULT_ARMS))
    assert depths == 3
    for _ in range(6):
        before = ngram_draft_cuda.launches
        s = E.spec_step(p, cfg, spec, s, t)
        assert ngram_draft_cuda.launches == before + depths
    assert torch.equal(s.stats["arm_pulls"].sum(1), s.stats["calls"])


# ----------------------------------------------------------------------------
# the registry's other architectures: K1/K3 at their full head shapes, and
# the plain verify that a window config runs on the card
@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("K,W1", [(10, 11), (1, 1)], ids=["verify", "decode"])
@pytest.mark.parametrize("H,KV,hd", [(96, 8, 192), (8, 1, 256)],
                         ids=["nemotron", "gemma"])
def test_verify_kernels_at_full_arch_head_shapes(cuda_device, H, KV, hd, K,
                                                 W1, dtype):
    """K1 and K3 at Nemotron-4's (96 / 8 / 192: hd padded to the 256
    instance) and Gemma-2B's (MQA 8 / 1 / 256) heads, at the main path's
    B, S, ragged cur_len and 64-key pages; K3 bit for bit K1 on the
    gathered view."""
    g = torch.Generator(device=cuda_device).manual_seed(hd + K)
    td = getattr(torch, dtype)
    rn = lambda *s: torch.randn(s, generator=g, device=cuda_device).to(td)
    ops = (rn(8, K, W1, H, hd), rn(8, 332, KV, hd), rn(8, 332, KV, hd),
           rn(8, K, W1, KV, hd), rn(8, K, W1, KV, hd),
           torch.tensor(MAIN_CUR, dtype=torch.int32, device=cuda_device))
    _close(spec_attention_cuda(*ops, w1=W1),
           spec_attention_plain(*ops, w1=W1), TOL[dtype])
    pops = _paged_inputs(cuda_device, 8, K, W1, H, KV, hd, 64, MAIN_CUR,
                         dtype, seed=hd)
    got = paged_spec_attention_cuda(*pops, w1=W1)
    _close(got, paged_spec_attention_plain(*pops, w1=W1), TOL[dtype])
    q, kp, vp, pt, kt, vt, cur = pops
    k_lin, v_lin = gather_pages(kp, vp, pt)
    assert torch.equal(got, spec_attention_cuda(q, k_lin, v_lin, kt, vt, cur,
                                                w1=W1))


@pytest.mark.gpu
def test_plain_window_verify_on_the_card_equals_the_cpu(cuda_device):
    """A sliding-window config verifies through ``plain_verify`` on the
    card, over a wrapped ring (cur_len past the 64 slots), and gives the
    CPU's output within f32 1e-5."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import attention as A
    from repro_torch.models.cache import key_positions
    cfg = get_smoke_config("mistral-7b")             # window 64, f32
    S, B, K, W1 = cfg.sliding_window, 2, 4, 5
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    g = torch.Generator().manual_seed(7)
    rn = lambda *s: torch.randn(s, generator=g)
    cur = torch.tensor([150, 40], dtype=torch.int32)
    ops = (rn(B, K, W1, H, hd), rn(B, S, KV, hd), rn(B, S, KV, hd),
           rn(B, K, W1, KV, hd), rn(B, K, W1, KV, hd),
           key_positions(cfg, S, cur),
           cur[:, None].long() + torch.arange(W1)[None])
    want = A.plain_verify(*ops, cfg)
    A.plain_verify.calls = 0
    got = A.plain_verify(*(t.to(cuda_device) for t in ops), cfg)
    assert A.plain_verify.calls == 1 and got.is_cuda
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("u_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Bt,T,di,ds,final", [
    (8, 128, 16384, 16, False),       # the hybrid's training shape
    (8, 127, 16384, 16, True),        # T past a checkpoint's edge
    (3, 37, 200, 8, True), (4, 5, 130, 4, False), (2, 20, 72, 12, True)])
def test_mamba_scan_bwd_cuda_matches_plain(cuda_device, Bt, T, di, ds,
                                           final, u_dtype):
    """K5's backward against its plain version: f32 relative 1e-4 on every
    gradient (du in f32, before the training call casts it to u's dtype),
    and the same bits on a second run (no float atomics)."""
    from repro_torch.kernels.mamba_scan import (mamba_scan_bwd_cuda,
                                                mamba_scan_bwd_plain)
    ops = _scan_inputs(cuda_device, Bt, T, di, ds, 1, 5, u_dtype, seed=T)
    g = torch.Generator(device=cuda_device).manual_seed(1)
    dy = torch.randn((Bt, T, di), generator=g, device=cuda_device)
    dhT = (torch.randn((Bt, di, ds), generator=g, device=cuda_device)
           if final else None)
    n = mamba_scan_bwd_cuda.launches
    got = mamba_scan_bwd_cuda(*ops, dy, dhT)
    again = mamba_scan_bwd_cuda(*ops, dy, dhT)
    torch.cuda.synchronize()
    assert mamba_scan_bwd_cuda.launches == n + 2
    want = mamba_scan_bwd_plain(*ops, dy, dhT)
    for name, a, b, c in zip(("du", "ddt", "dA", "dB", "dC", "dD", "dh0"),
                             got, want, again):
        err = float((a - b).abs().max() / b.abs().max())
        assert err < 1e-4, (name, err)
        assert torch.equal(a, c), name


@pytest.mark.gpu
@pytest.mark.parametrize("dtr", [512, 5])
def test_mamba_scan_training_checkpoints(cuda_device, dtr):
    """K5's training instance (``ckpt=``): y and the final state carry the
    serving instance's bits; checkpoint c, the state before step CHUNK * c,
    equals bit for bit the final state of K5 run on that prefix, and the
    plain version's state after those steps within K5's tolerance (its exp
    is torch.exp, not ex2.approx); the backward given those checkpoints
    equals, bit for bit, the backward that makes its own.  dtr 5 leaves B
    and C rows unaligned (plain-load staging in both kernels)."""
    from repro_torch.kernels.mamba_scan import (CHUNK, mamba_scan_bwd_cuda,
                                                n_chunks)
    Bt, T, di, ds = 3, 3 * CHUNK + 5, 200, 16
    ops = _scan_inputs(cuda_device, Bt, T, di, ds, 1, dtr, "bfloat16",
                       seed=9)
    u, dt, A, B, C, D, h0 = ops
    ckpt = torch.empty((Bt, n_chunks(T), di, ds), device=cuda_device)
    y, hT, _ = mamba_scan_cuda(*ops, ckpt=ckpt)
    y0, hT0, _ = mamba_scan_cuda(*ops)
    assert torch.equal(y, y0) and torch.equal(hT, hT0)
    _, _, hs = mamba_scan_plain(*ops, steps=True)
    assert torch.equal(ckpt[:, 0], h0)
    for c in range(1, n_chunks(T)):
        t = c * CHUNK
        kept = mamba_scan_cuda(u[:, :t].contiguous(), dt[:, :t].contiguous(),
                               A, B[:, :t], C[:, :t], D, h0)[1]
        assert torch.equal(ckpt[:, c], kept), c
        _close(ckpt[:, c], hs[:, t - 1], 2e-4)
    g = torch.Generator(device=cuda_device).manual_seed(2)
    dy = torch.randn((Bt, T, di), generator=g, device=cuda_device)
    for a, b in zip(mamba_scan_bwd_cuda(*ops, dy, None, ckpt),
                    mamba_scan_bwd_cuda(*ops, dy)):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_mamba_training_on_the_card_equals_the_cpu(cuda_device):
    """Three f32 train steps of the smoke hybrid (TF32 off) on the card,
    its scan K5 with K5's backward kernel as the gradient, give the CPU's
    losses and grad norms within 1e-4; K5 runs twice a Mamba layer a step
    (the forward and remat's recompute), the backward once.  A
    differentiated call outside the training contract raises, and a scan
    without gradients still runs K5 alone."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.jamba_1_5_large_398b import no_experts
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.mamba_scan import mamba_scan_bwd_cuda
    from repro_torch.train import AdamWConfig, init_train_state
    from repro_torch.train import make_train_step
    from repro_torch.train.optimizer import tree_map
    cfg = no_experts(get_smoke_config("jamba-1.5-large-398b"))
    n_mamba = sum(b.mixer == "mamba" for b in cfg.block_pattern) \
        * cfg.num_periods
    cpu_ts = init_train_state(cfg, seed=0, device="cpu")
    ts = tree_map(lambda t: t.to(cuda_device), cpu_ts)
    batch = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 33))
    step = make_train_step(cfg, AdamWConfig(total_steps=3, warmup_steps=1))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for _ in range(3):
            f0, b0 = mamba_scan_cuda.launches, mamba_scan_bwd_cuda.launches
            ts, m = step(ts, batch)
            cpu_ts, cm = step(cpu_ts, batch)
            assert mamba_scan_cuda.launches - f0 == 2 * n_mamba
            assert mamba_scan_bwd_cuda.launches - b0 == n_mamba
            for k in ("loss", "grad_norm"):
                a, b = float(m[k]), float(cm[k])
                assert abs(a - b) <= 1e-4 * abs(b), (k, a, b)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    ops = _scan_inputs(cuda_device, 4, 5, 64, 8, 2, 8, "float32", seed=0)
    ops[0].requires_grad_()
    with pytest.raises(ValueError, match="training call"):
        dispatch.selective_scan(*ops, h0_rep=2)
    n = mamba_scan_cuda.launches
    with torch.no_grad():
        dispatch.selective_scan(*ops, h0_rep=2)
    assert mamba_scan_cuda.launches == n + 1


@pytest.mark.gpu
def test_dense_train_steps_on_the_card_equal_the_cpu(cuda_device):
    """Three f32 steps of StableLM's smoke config (TF32 off) on the card
    give the CPU's losses and grad norms within 1e-5 and launch no kernel
    of ``kernels/``: training runs plain torch ops."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.pipeline import mixed_batches
    from repro_torch.train import AdamWConfig, init_train_state
    from repro_torch.train import make_train_step
    cfg = get_smoke_config("stablelm-1.6b")
    opt = AdamWConfig(lr=1e-3, total_steps=3, warmup_steps=1)
    batches = list(mixed_batches(4, 64, 3))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        runs = {}
        for dev in ("cpu", cuda_device):
            ts = init_train_state(cfg, seed=0, device="cpu")
            ts = _to(ts, dev)
            step = make_train_step(cfg, opt, remat=True)
            counts = (spec_attention_cuda.launches, ngram_draft_cuda.launches,
                      paged_spec_attention_cuda.launches,
                      mamba_scan_cuda.launches)
            mets = []
            for b in batches:
                ts, m = step(ts, b)
                mets.append([float(m["loss"]), float(m["grad_norm"])])
            assert counts == (spec_attention_cuda.launches,
                              ngram_draft_cuda.launches,
                              paged_spec_attention_cuda.launches,
                              mamba_scan_cuda.launches)
            runs[str(dev)] = np.array(mets)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    np.testing.assert_allclose(runs["cuda"], runs["cpu"], rtol=1e-5,
                               atol=1e-5)


# ----------------------------------------------------------------------------
# the MoE FFN and the xLSTM mixers (torch ops on the card, no kernel)
# ----------------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("cf", [0.5, 2.0], ids=["drops", "no-drops"])
def test_moe_scatter_on_the_card_equals_the_cpu(cuda_device, cf):
    """deepseek-smoke's MoE layer at 3 x 13 tokens: the card drops the
    CPU's token-slots and gives its output (f32 1e-5 of the largest
    magnitude), the same bits on a second call (the packing does not
    accumulate)."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as M
    from repro_torch.models import moe
    cfg = dataclasses.replace(get_smoke_config("deepseek-moe-16b"),
                              capacity_factor=cf)
    p = {k: v[0] for k, v in M.init_params(cfg, seed=0, device="cpu")[
        "p0"]["mlp"].items()}
    x = torch.randn(3, 13, cfg.d_model, generator=torch.Generator()
                    .manual_seed(0))
    reads = {}
    for dev in ("cpu", cuda_device):
        pd = {k: v.to(dev) for k, v in p.items()}
        with moe.count_drops() as drops:
            y, aux = moe.apply_moe(pd, x.to(dev), cfg)
        reads[str(dev)] = (y.cpu(), float(aux), drops.read())
        if str(dev) == "cuda":
            assert torch.equal(moe.apply_moe(pd, x.to(dev), cfg)[0], y)
    (yc, ac, dc), (yg, ag, dg) = reads["cpu"], reads["cuda"]
    assert dc == dg and (dc[1] > 0) == (cf < 1)
    scale = float(yc.abs().max())
    np.testing.assert_allclose(yg.numpy(), yc.numpy(), rtol=1e-5,
                               atol=1e-5 * scale)
    assert abs(ag - ac) <= 1e-6


@pytest.mark.gpu
def test_xlstm_cells_on_the_card_equal_the_cpu(cuda_device):
    """The mLSTM and sLSTM cells on the card: f32 1e-5 of the CPU's, and
    the replay's kept state equal, bit for bit, to the per-step states
    then ``select_step_state``."""
    from repro_torch.kernels.ref import select_step_state
    from repro_torch.models import xlstm as X
    g = torch.Generator().manual_seed(1)
    r = lambda *s: torch.randn(*s, generator=g)
    B, T, H, dh = 3, 7, 2, 16
    mins = (r(B, T, H, dh), r(B, T, H, dh), r(B, T, H, dh), r(B, T, H) - 1,
            torch.nn.functional.logsigmoid(r(B, T, H) + 2),
            0.3 * r(B, H, dh, dh), 0.3 * r(B, H, dh), r(B, H))
    sins = (r(B, T, 4, H, dh), 0.3 * r(4, H, dh, dh),
            r(B, H, dh), r(B, H, dh).abs() + 1, r(B, H, dh), r(B, H, dh))
    cells = ((X._mlstm_cell_scan, mins, lambda a: a[5:]),
             (lambda *a, **kw: X._slstm_cell(a[0], a[1], a[2:], **kw), sins,
              lambda a: a[2:]))
    nc = torch.tensor([0, 3, 7], dtype=torch.int32)
    for cell, ins, start in cells:
        h, st = cell(*ins)
        gins = [a.to(cuda_device) for a in ins]
        gh, gst = cell(*gins)
        for a, b in zip((h,) + tuple(st), (gh,) + tuple(gst)):
            _close(b, a, 1e-5)
        gnc = nc.to(cuda_device)
        _, kept = cell(*gins, n_commit=gnc)
        _, steps = cell(*gins, per_step=True)
        for got, per, old in zip(kept, steps, start(gins)):
            assert torch.equal(got, select_step_state(per, old, gnc))


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "xlstm-125m"])
def test_moe_and_xlstm_serving_is_lossless_on_the_card(cuda_device, arch):
    """The smoke configs (f32) served speculatively on the card, static
    and continuous (DeepSeek over a small paged pool, xLSTM linear): every
    output equals greedy_reference; DeepSeek's attention verifies through
    K1 and K3."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.spec_engine import SpecConfig, greedy_reference
    from repro_torch.models import model as M
    from repro_torch.serving.engine import ServingEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke_config(arch)
    params = M.init_params(cfg, seed=0, device="cuda")
    paged = not M.has_recurrent(cfg)
    for static in (True, False):
        eng = ServingEngine(params, cfg, SpecConfig(k=4, w=3), max_batch=3,
                            buckets=(16, 32), max_new_cap=14,
                            paged=paged and not static,
                            num_pages=9 if paged and not static else None,
                            page_size=8)
        for i in range(5):
            text = f"def f{i}(x): return x * {i} + 1"
            eng.submit((text * 2)[:30] if i % 3 == 1 else text[:14],
                       max_new_tokens=(6, 10, 14)[i % 3])
        spec_attention_cuda.launches = 0
        paged_spec_attention_cuda.launches = 0
        done = eng.serve_all() if static else eng.serve_continuous()
        if arch == "deepseek-moe-16b":
            assert (spec_attention_cuda.launches if static
                    else paged_spec_attention_cuda.launches) > 0
        for r in done:
            toks = eng.scheduler.pad_to_bucket(eng.tok.encode(r.prompt))
            ref = greedy_reference(params, cfg, toks[None],
                                   r.stats["new_tokens"])
            np.testing.assert_array_equal(r.output_ids,
                                          ref[0, len(toks):].cpu().numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "qwen2-vl-72b"])
def test_moe_and_mrope_steps_do_not_synchronise(cuda_device, arch):
    """A mixed spec_step of deepseek-smoke (the router's expert counts and
    the capacity ranks: a fixed-length scatter-add, no bincount) and of
    qwen2-vl-smoke (M-RoPE's section ids built once per device) makes no
    call that waits for the device (torch's sync debug mode raises on
    one), and K1 carries its verify."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import spec_engine as E
    from repro_torch.core.ngram_tables import NGramTables
    from repro_torch.models import model as M
    cfg = get_smoke_config(arch)
    spec = E.SpecConfig(k=4, w=3, strategy="mixed", max_new_tokens=16)
    params = M.init_params(cfg, seed=0, device="cuda")
    rng = np.random.default_rng(3)
    V = cfg.vocab_size
    tab = NGramTables(*(torch.as_tensor(a, dtype=torch.int32,
                                        device=cuda_device) for a in (
        np.arange(8), rng.integers(0, V, (V, 8)),
        rng.integers(0, V, (V, 6)))))
    prompt = torch.as_tensor(rng.integers(0, V, (2, 24)),
                             dtype=torch.int32, device=cuda_device)
    s = E.init_decode_state(params, cfg, spec, prompt)
    s = E.spec_step(params, cfg, spec, s, tab)     # the per-device constants
    torch.cuda.synchronize()
    spec_attention_cuda.launches = 0
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            s = E.spec_step(params, cfg, spec, s, tab)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert spec_attention_cuda.launches == 2 * cfg.num_layers
    assert int(s.buf_len.min()) >= 24 + 4


@pytest.mark.gpu
def test_contract_checker_is_clean_on_the_card(cuda_device):
    """The checker's level 1 over its whole registry on the card (each
    step under set_sync_debug_mode("error") and the dispatch-mode
    detector): no finding."""
    from repro_torch.analysis.runtime_rules import run_level1
    found = run_level1(device="cuda")
    assert found == [], "\n".join(f.format() for f in found)


def _meta(t):
    return tuple(t.shape), t.dtype, t.stride(), t.device


@pytest.mark.gpu
@pytest.mark.parametrize("kernel,dims,want", [
    ("K1", (8, 10, 11, 32, 32, 64), "<64, 2, false>"),     # StableLM verify
    ("K1", (8, 1, 1, 32, 32, 64), "<64, 1, false>"),       # StableLM decode
    ("K1", (8, 10, 11, 64, 8, 128), "<128, 2, false>"),    # hybrid verify
    ("K1", (8, 1, 1, 96, 8, 192), "<256, 1, false>"),      # Nemotron decode
    ("K5", (8, 256, 1, True), "<16, bf16, false, false>"),   # prefill
    ("K5", (80, 11, 10, False), "<16, bf16, false, false>"),  # verify
    ("K5", (8, 1, 1, True), "<16, bf16, false, false>")])    # decode
def test_shape_functions_match_their_kernels(cuda_device, kernel, dims,
                                             want):
    """The dry-run's shape functions: fake copies of the real operands
    (``FakeTensorMode.from_tensor``) reaching K1's or K5's wrapper give
    outputs of the real kernel's shapes, dtypes, strides and device, and
    record the instance the card launched; the fake call launches
    nothing."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    if kernel == "K1":
        B, K, W1, H, KV, hd = dims
        g = torch.Generator(device=cuda_device).manual_seed(16)
        rn = lambda *s: torch.randn(s, generator=g,
                                    device=cuda_device).bfloat16()
        S = 4096
        ops = (rn(B, K, W1, H, hd), rn(B, S, KV, hd), rn(B, S, KV, hd),
               rn(B, K, W1, KV, hd), rn(B, K, W1, KV, hd),
               torch.full((B,), S // 2, dtype=torch.int32,
                          device=cuda_device))
        fn, kw, pick = spec_attention_cuda, {"w1": W1}, lambda r: [r]
    else:
        Bt, T, rep, final = dims
        ops = _scan_inputs(cuda_device, Bt, T, 16384, 16, rep, 512,
                           "bfloat16", seed=16)
        fn, kw = mamba_scan_cuda, {"h0_rep": rep, "final": final}
        pick = lambda r: [t for t in r if t is not None]
    real = pick(fn(*ops, **kw))
    torch.cuda.synchronize()
    launches = fn.launches
    mode = FakeTensorMode()
    fn.shape_calls.clear()
    with mode:
        fake = pick(fn(*(mode.from_tensor(t) for t in ops), **kw))
    assert [_meta(t) for t in fake] == [_meta(t) for t in real]
    assert [c["instance"] for c in fn.shape_calls] == [want]
    assert fn.launches == launches
    fn.shape_calls.clear()
