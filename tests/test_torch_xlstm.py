"""The port's xLSTM mixers against the JAX reference, on the CPU: the
per-head group norm, the mLSTM cell (per-step scan and chunkwise form),
the sLSTM cell, the gated replay's kept state, ``xlstm-smoke`` through
every entry point, ``generate`` and continuous serving, the decode-state
groups and a train step.

Weights go from the JAX ``init_params`` through ``checkpoint._flatten``
into ``weights.from_jax_flat``; inputs are made from a seed with numpy.
Tolerances (float32): the cells 1e-5; the mixers 5e-5 of the output's
largest magnitude (the per-head group norm divides each head by its own
spread, which scales the cells' last-bit differences up: one element of
1792 reads 1.1e-5 of it); model logits 1e-4, as in the earlier slices,
and the states they write 1e-5 of each leaf's largest magnitude (sLSTM's
n accumulates to tens); tokens exact.  The replay's masked state update
is held bit for bit against the reference's form (per-step states, then
``select_step_state``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import spec_engine as JE
from repro.core.ngram_tables import NGramTables as JTables
from repro.models import cache as JC
from repro.models import model as JM
from repro.models import xlstm as JX
from repro.serving.engine import ServingEngine as JServingEngine
from repro.train import train_loop as JT
from repro.train.checkpoint import _flatten
from repro_torch.core import spec_engine as E
from repro_torch.core.ngram_tables import (NGramTables, build_bigram,
                                           build_unigram)
from repro_torch.kernels.ref import select_step_state
from repro_torch.models import cache as C
from repro_torch.models import model as M
from repro_torch.models import xlstm as X
from repro_torch.models.config import BlockSpec, ModelConfig
from repro_torch.models.weights import from_jax_flat
from repro_torch.serving.engine import ServingEngine
from repro_torch.train import train_loop as T

ARCH = "xlstm-125m"
MAX_NEW = 12


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The port's side in one thread: these models are tiny, and the suite
    runs its files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol):
    np.testing.assert_allclose(torch.as_tensor(got).float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _close_scaled(got, want, tol):
    """Within ``tol`` of the largest magnitude of ``want``."""
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol * float(np.abs(want).max()))


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(ARCH),
                               backend="xla")
    jparams = JM.init_params(jax.random.PRNGKey(1), jcfg)
    cfg = ModelConfig.from_reference(jcfg)
    return jcfg, jparams, cfg, from_jax_flat(_flatten(jparams), cfg,
                                             device="cpu")


def _cell_inputs(seed, B=2, T=9, H=3, dh=8):
    """q, k, v (B, T, H, dh), log gates (B, T, H) and a nonzero start
    state (C, n, m)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    q, k, v = f(B, T, H, dh), f(B, T, H, dh), f(B, T, H, dh)
    li = f(B, T, H) - 1.0
    lf = np.log(1.0 / (1.0 + np.exp(-(f(B, T, H) + 2.0)))).astype(np.float32)
    C0, n0, m0 = 0.3 * f(B, H, dh, dh), 0.3 * f(B, H, dh), f(B, H)
    return q, k, v, li, lf, C0, n0, m0


# ----------------------------------------------------------------------------
# cells
# ----------------------------------------------------------------------------
def test_groupnorm_heads_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 24)).astype(np.float32) * 3 + 1
    s = rng.standard_normal(24).astype(np.float32)
    _close(X._groupnorm_heads(_t(x), _t(s), 4),
           JX._groupnorm_heads(jnp.asarray(x), jnp.asarray(s), 4), 1e-5)


@pytest.mark.parametrize("empty", [False, True], ids=["state", "empty"])
def test_mlstm_scan_matches_jax(empty):
    ins = _cell_inputs(1)
    if empty:   # the -1e9 stabiliser of an empty state meets exp(-m)
        ins = ins[:5] + (0 * ins[5], 0 * ins[6], np.full_like(ins[7], -1e9))
    h, (Cf, nf, mf) = X._mlstm_cell_scan(*map(_t, ins))
    jh, (jC, jn, jm) = JX._mlstm_cell_scan(*map(jnp.asarray, ins))
    for got, want in ((h, jh), (Cf, jC), (nf, jn), (mf, jm)):
        _close(got, want, 1e-5)


def test_mlstm_chunkwise_matches_jax_and_the_scan():
    """T = 256 in two chunks of 128: JAX's chunkwise form, and the port's
    own scan (the same math)."""
    ins = _cell_inputs(2, B=1, T=256, H=2, dh=4)
    h, st = X._mlstm_cell_chunkwise(*map(_t, ins))
    jh, jst = JX._mlstm_cell_chunkwise(*map(jnp.asarray, ins))
    sh, sst = X._mlstm_cell_scan(*map(_t, ins))
    for got, want in zip((h,) + st, (jh,) + jst):
        _close(got, want, 1e-5)
    # the chunk form stores C and n at its own log scale m: compare the
    # true states C * exp(m)
    for a, b in ((h, sh), (st[0] * torch.exp(st[2])[..., None, None],
                           sst[0] * torch.exp(sst[2])[..., None, None])):
        _close(a, b, 1e-4)


def test_replay_keeps_the_state_after_n_commit_steps():
    """The masked update keeps, bit for bit, what the reference's replay
    keeps: the per-step states, then ``select_step_state`` (the start
    state where n_commit is 0); the outputs of every step stay the
    unmasked ones.  mLSTM and sLSTM cells."""
    nc = torch.tensor([0, 2, 5], dtype=torch.int32)
    ins = [_t(a) for a in _cell_inputs(3, B=3, T=5)]
    rng = np.random.default_rng(8)
    pre = _t(rng.standard_normal((3, 5, 4, 2, 6)).astype(np.float32))
    R = _t(rng.standard_normal((4, 2, 6, 6)).astype(np.float32) * 0.5)
    st = tuple(_t(rng.standard_normal((3, 2, 6)).astype(np.float32))
               for _ in range(4))
    slstm = lambda **kw: X._slstm_cell(pre, R, st, **kw)
    for cell, args, start in ((X._mlstm_cell_scan, ins, ins[5:]),
                              (slstm, (), st)):
        h, kept = cell(*args, n_commit=nc)
        h_all, _ = cell(*args)
        _, steps = cell(*args, per_step=True)
        assert torch.equal(h, h_all)
        for got, per, old in zip(kept, steps, start):
            assert torch.equal(got, select_step_state(per, old, nc))


def test_mixers_match_jax(model):
    """mlstm_mix and slstm_mix from nonzero states, and verify rows from
    their slot's state (rep)."""
    jcfg, jparams, cfg, params = model
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 7, cfg.d_model)).astype(np.float32)
    (C0, n0, m0), conv0 = JX.init_mlstm_state(jcfg, 2)
    st = (C0 + 0.1, n0 + 0.1, m0 * 0)
    conv = jnp.asarray(rng.standard_normal(conv0.shape).astype(np.float32))
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams["p0"]["mixer"])
    p = {k: _t(v) for k, v in jp.items()}
    jy, jst, jconv = JX.mlstm_mix(jp, jnp.asarray(x), jcfg, st, conv)
    y, pst, ext = X.mlstm_mix(p, _t(x), cfg, tuple(map(_t, st)), _t(conv))
    for got, want in zip((y, ext[:, 7:]) + pst, (jy, jconv) + jst):
        _close_scaled(got, want, 5e-5)
    yr, _, _ = X.mlstm_mix(p, _t(np.repeat(x, 3, 0)), cfg,
                           tuple(map(_t, st)), _t(conv), rep=3)
    _close_scaled(yr, np.repeat(np.asarray(jy), 3, 0), 5e-5)
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams["p1"]["mixer"])
    p = {k: _t(v) for k, v in jp.items()}
    sst = tuple(a + 0.1 * i for i, a in enumerate(
        JX.init_slstm_state(jcfg, 2)))
    jy, jst = JX.slstm_mix(jp, jnp.asarray(x), jcfg, sst)
    y, pst = X.slstm_mix(p, _t(x), cfg, tuple(map(_t, sst)))
    for got, want in zip((y,) + pst, (jy,) + jst):
        _close_scaled(got, want, 5e-5)


# ----------------------------------------------------------------------------
# the model
# ----------------------------------------------------------------------------
def test_entry_points_match_jax(model):
    """forward, prefill, decode, verify and the gated replay give JAX's
    logits at f32 1e-4, and the states they write agree."""
    jcfg, jparams, cfg, params = model
    rng = np.random.default_rng(5)
    V = cfg.vocab_size
    toks = rng.integers(0, V, (2, 11)).astype(np.int32)
    want, _ = JM.forward(jparams, jcfg, tokens=jnp.asarray(toks))
    got, aux = M.forward(params, cfg, tokens=torch.from_numpy(toks))
    _close(got, want, 1e-4)
    assert float(aux) == 0.0
    B, P, K, W1 = 2, 9, 3, 4
    st = M.init_state(cfg, B, 24, device="cpu")
    jst = JM.init_state(jcfg, B, 24)
    got, st = M.prefill(params, cfg, st, torch.from_numpy(toks[:, :P]))
    want, jst = JM.prefill(jparams, jcfg, jst, jnp.asarray(toks[:, :P]))
    _close(got, want, 1e-4)
    step = rng.integers(0, V, (B, 2)).astype(np.int32)
    got, st = M.decode(params, cfg, st, torch.from_numpy(step))
    want, jst = JM.decode(jparams, jcfg, jst, jnp.asarray(step))
    _close(got, want, 1e-4)
    rows = rng.integers(0, V, (B, K, W1)).astype(np.int32)
    got, tails = M.verify(params, cfg, st, torch.from_numpy(rows))
    want, _ = JM.verify(jparams, jcfg, jst, jnp.asarray(rows))
    _close(got, want, 1e-4)
    assert tails == {}
    nc = np.array([3, 0], np.int32)
    got, st = M.decode(params, cfg, st, torch.from_numpy(rows[:, 2]),
                       n_commit=torch.from_numpy(nc))
    want, jst = JM.decode(jparams, jcfg, jst, jnp.asarray(rows[:, 2]),
                          n_commit=jnp.asarray(nc))
    _close(got, want, 1e-4)
    np.testing.assert_array_equal(st["cur_len"].numpy(), [P + 5, P + 2])
    for gid, g in st["groups"].items():
        for name, leaf in g.items():
            want = np.asarray(jst["groups"][gid][name], np.float32)
            np.testing.assert_allclose(leaf.numpy(), want, rtol=1e-5,
                                       atol=1e-5 * np.abs(want).max())


def test_bf16_config_keeps_the_float32_leaves():
    """In a bf16 config the sLSTM's ``r`` and ``b`` and the mLSTM's gate
    biases stay float32 through ``from_jax_flat``, bit for bit, and the
    port's own init draws them float32 too."""
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(ARCH),
                               param_dtype=jnp.bfloat16,
                               compute_dtype=jnp.bfloat16)
    jp = JM.init_params(jax.random.PRNGKey(2), jcfg)
    cfg = ModelConfig.from_reference(jcfg)
    p = from_jax_flat(_flatten(jp), cfg, device="cpu")
    own = M.init_params(cfg, seed=0, device="cpu")
    for gid, names in (("p0", ("b_i", "b_f")), ("p1", ("r", "b"))):
        for name in names:
            leaf = p[gid]["mixer"][name]
            assert leaf.dtype == own[gid]["mixer"][name].dtype == \
                torch.float32
            np.testing.assert_array_equal(
                leaf.numpy(), np.asarray(jp[gid]["mixer"][name]))
    assert p["p0"]["mixer"]["wq"].dtype == torch.bfloat16


def test_state_groups_match_the_reference_and_reset():
    """mLSTM and sLSTM groups take the reference's shapes, dtypes and
    -1e9 fills, each leaf its own buffer; a pure xLSTM stack cannot be
    paged; a paged reset of an xLSTM + attention stack restores the
    empty recurrent state (zeros, -1e9) in that slot alone."""
    jcfg = jconfigs.get_config(ARCH)
    cfg = ModelConfig.from_reference(jcfg)
    st = M.init_state(cfg, 2, 16, device="cpu")
    jst = jax.eval_shape(lambda: JC.init_state(jcfg, 2, 16))
    for gid, g in jst["groups"].items():
        assert sorted(g) == sorted(st["groups"][gid])
        for name, leaf in g.items():
            mine = st["groups"][gid][name]
            assert tuple(mine.shape) == leaf.shape, (gid, name)
            assert str(mine.dtype)[6:] == str(leaf.dtype), (gid, name)
    small = ModelConfig.from_reference(jconfigs.get_smoke_config(ARCH))
    st = M.init_state(small, 2, 16, device="cpu")
    jst = JC.init_state(jconfigs.get_smoke_config(ARCH), 2, 16)
    ptrs = set()
    for gid, g in st["groups"].items():
        for name, leaf in g.items():
            np.testing.assert_array_equal(leaf.numpy(), np.asarray(
                jst["groups"][gid][name], np.float32))
            ptrs.add(leaf.data_ptr())
    assert len(ptrs) == sum(len(g) for g in st["groups"].values())
    assert not C.paged_supported(small)
    with pytest.raises(ValueError, match="paged KV"):
        C.init_paged_state(small, 2, 4, 8, 2, device="cpu")
    mixed = dataclasses.replace(small, name="xl-attn", block_pattern=(
        BlockSpec("mlstm", "none"), BlockSpec("attn", "swiglu"),
        BlockSpec("slstm", "none")), num_layers=3, d_ff=64)
    pst = C.init_paged_state(mixed, 2, 4, 8, 2, device="cpu")
    for gid in ("p0", "p2"):
        for leaf in pst["groups"][gid].values():
            leaf.fill_(1)
    C.reset_slot(mixed, pst, 1)
    empty = M.init_state(mixed, 1, 8, device="cpu")
    for gid in ("p0", "p2"):
        for name, leaf in pst["groups"][gid].items():
            assert torch.equal(leaf[:, 1], empty["groups"][gid][name][:, 0])
            assert bool((leaf[:, 0] == 1).all())


# ----------------------------------------------------------------------------
# generation and serving
# ----------------------------------------------------------------------------
@pytest.fixture(scope="module")
def tables(model):
    _, _, cfg, params = model
    topk, chain = build_bigram(
        lambda t: M.forward(params, cfg, tokens=t)[0][:, -1],
        cfg.vocab_size, k_max=4, w_max=4, device="cpu")
    emb = params["embed"]["embedding"]
    uni = build_unigram(emb, params["embed"]["lm_head"], k_max=4)
    return (NGramTables(uni, topk, chain),
            JTables(*(jnp.asarray(t.numpy()) for t in (uni, topk, chain))))


def test_generate_matches_jax_and_is_lossless(model, tables):
    jcfg, jparams, cfg, params = model
    tab, jtab = tables
    prompt = np.random.default_rng(6).integers(0, 7, (3, 10)).astype(
        np.int32)
    kw = dict(k=4, w=3, strategy="mixed", max_new_tokens=MAX_NEW)
    buf, blen, stats = E.generate(params, cfg, E.SpecConfig(**kw), prompt,
                                  tab, device="cpu")
    jbuf, jblen, jstats = JE.generate(
        jparams, jcfg, JE.SpecConfig(backend="xla", **kw),
        jnp.asarray(prompt), jtab)
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))
    np.testing.assert_array_equal(blen.numpy(), np.asarray(jblen))
    for key in ("calls", "tokens", "accept_hist"):
        np.testing.assert_array_equal(stats[key].numpy(),
                                      np.asarray(jstats[key]), err_msg=key)
    n = prompt.shape[1] + MAX_NEW
    ref = E.greedy_reference(params, cfg, prompt, MAX_NEW, device="cpu")
    np.testing.assert_array_equal(buf[:, :n].numpy(), ref.numpy())
    assert int(stats["tokens"].sum()) > int(stats["calls"].sum())
    with pytest.raises(ValueError, match="paged KV"):
        E.generate(params, cfg, E.SpecConfig(**kw), prompt, tab,
                   paged=E.PagedConfig(page_size=8), device="cpu")


def test_continuous_serving_matches_jax_engine(model, tables):
    """Linear continuous serving: outputs, calls and histograms equal the
    reference engine's; a paged engine raises, as the reference's does."""
    jcfg, jparams, cfg, params = model
    tab, jtab = tables
    common = dict(max_batch=2, buckets=(16, 32), max_new_cap=12)
    jeng = JServingEngine(jparams, jcfg, JE.SpecConfig(
        k=4, w=3, strategy="mixed", backend="xla"), tables=jtab, **common)
    eng = ServingEngine(params, cfg, E.SpecConfig(k=4, w=3,
                                                  strategy="mixed"),
                        tables=tab, device="cpu", **common)
    work = [(f"def f{i}(x): return x * {i} + 1"[:14 + 8 * (i % 2)],
             (6, 10, 12)[i % 3]) for i in range(5)]
    for e in (eng, jeng):
        for text, mnt in work:
            e.submit(text, max_new_tokens=mnt)
    done = sorted(eng.serve_continuous(), key=lambda r: r.request_id)
    jdone = sorted(jeng.serve_continuous(), key=lambda r: r.request_id)
    for r, jr, (_, mnt) in zip(done, jdone, work):
        np.testing.assert_array_equal(r.output_ids, jr.output_ids)
        for key in ("new_tokens", "model_calls", "accept_hist"):
            assert r.stats[key] == jr.stats[key], key
        assert r.stats["new_tokens"] == mnt
    with pytest.raises(ValueError) as err:
        ServingEngine(params, cfg, E.SpecConfig(k=4, w=3), tables=tab,
                      paged=True, device="cpu", **common)
    with pytest.raises(ValueError) as jerr:
        JServingEngine(jparams, jcfg, JE.SpecConfig(k=4, w=3,
                                                    backend="xla"),
                       tables=jtab, paged=True, **common)
    assert "paged" in str(err.value) and "paged" in str(jerr.value)


def test_train_step_matches_jax(model):
    """One xlstm-smoke step: loss and gradients equal JAX's (f32 1e-5 of
    each leaf's largest gradient)."""
    jcfg, jparams, cfg, params = model
    batch = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (2, 17)).astype(np.int32)
    (jtotal, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: JT.lm_loss(p, jcfg, jnp.asarray(batch)), has_aux=True))(
        jparams)
    flat = {k: v.detach().clone().requires_grad_()
            for k, v in _flatten_port(params)}
    total, m = T.lm_loss(_unflatten(flat), cfg, torch.from_numpy(batch))
    grads = dict(zip(flat, torch.autograd.grad(total, list(flat.values()))))
    _close(m["loss"], jm["loss"], 1e-5)
    jflat = _flatten(jg)
    assert sorted(grads) == sorted(jflat)
    for k, g in grads.items():
        want = np.asarray(jflat[k], np.float32)
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=k)


def _flatten_port(tree, prefix=""):
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flatten_port(v, key)
        else:
            yield key, v


def _unflatten(flat):
    out = {}
    for key, v in flat.items():
        node = out
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out
