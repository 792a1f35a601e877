"""The port's MoE FFN against the JAX reference, on the CPU: the router,
``moe_dense``, ``moe_scatter`` (capacity drops included) and shared
experts; DeepSeek-MoE, Mixtral and Jamba (with its experts) at their smoke
configs through every entry point, ``generate`` and continuous serving; a
train step of DeepSeek-MoE.

Weights go from the JAX ``init_params`` through ``checkpoint._flatten``
into ``weights.from_jax_flat``; inputs are made from a seed with numpy.
Tolerances (float32): the router's probabilities and aux loss 1e-6, its
top-k indices and the drop counts exact; the modules 1e-5 of the
output's largest magnitude (the reference's expert init, fan-in E, makes
outputs of a few hundred, whose f32 sums round at ~1e-5 each); the
models' logits 1e-4, as in the earlier slices; tokens exact.

``moe_scatter`` keeps the reference's capacity semantics: C follows the
number of tokens in the call, so a row's output depends on the other rows
and on the buffer length.  ``test_capacity_drops_give_jaxs_tokens`` holds
the port to JAX's tokens in a case where JAX's speculative output differs
from its own ``greedy_reference`` (``mixtral-smoke`` with 8 experts).
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
from repro.models import model as JM
from repro.models import moe as JMoE
from repro.serving.engine import ServingEngine as JServingEngine
from repro.train import train_loop as JT
from repro.train.checkpoint import _flatten
from repro_torch import configs
from repro_torch.configs.jamba_1_5_large_398b import no_experts, with_experts
from repro_torch.core import spec_engine as E
from repro_torch.core.ngram_tables import (NGramTables, build_bigram,
                                           build_unigram)
from repro_torch.models import model as M
from repro_torch.models import moe
from repro_torch.models.config import ModelConfig
from repro_torch.models.weights import from_jax_flat
from repro_torch.serving.engine import ServingEngine
from repro_torch.train import train_loop as T

ARCHS = ["deepseek-moe-16b", "mixtral-8x7b", "jamba-1.5-large-398b"]
J_FORWARD = jax.jit(JM.forward, static_argnums=(1,))
J_PREFILL = jax.jit(JM.prefill, static_argnums=(1,))
J_DECODE = jax.jit(JM.decode, static_argnums=(1,))
J_VERIFY = jax.jit(JM.verify, static_argnums=(1,))
J_INIT = jax.jit(JM.init_params, static_argnums=(1,))
MAX_NEW = 12


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The port's side in one thread: these models are tiny, and the suite
    runs its files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jcfg(arch, **kw):
    return dataclasses.replace(jconfigs.get_smoke_config(arch),
                               backend="xla", **kw).validate()


def _port(jcfg, jparams):
    cfg = ModelConfig.from_reference(jcfg)
    return cfg, from_jax_flat(_flatten(jparams), cfg, device="cpu")


def _close(got, want, tol):
    np.testing.assert_allclose(torch.as_tensor(got).float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _close_scaled(got, want, tol):
    """Within ``tol`` of the largest magnitude of ``want``."""
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol * float(np.abs(want).max()))


@pytest.fixture(scope="module")
def models():
    """arch -> (jax cfg, jax params, port cfg, port params)."""
    out = {}
    for arch in ARCHS:
        jcfg = _jcfg(arch)
        jparams = J_INIT(jax.random.PRNGKey(1), jcfg)
        out[arch] = (jcfg, jparams) + _port(jcfg, jparams)
    return out


def _layer(jparams, gid="p0"):
    """One MoE layer's parameters: JAX's (R index 0) and the port's."""
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams[gid]["mlp"])
    return jp, {k: torch.tensor(np.asarray(v)) for k, v in jp.items()}


# ----------------------------------------------------------------------------
# the router and the two dispatches
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("tied", [False, True], ids=["random", "tied"])
def test_router_matches_jax(models, tied):
    """Exact top-k (a tie keeps the lower expert, as lax.top_k does);
    weights and aux loss at 1e-6."""
    jcfg, jparams, cfg, _ = models["deepseek-moe-16b"]
    jp, p = _layer(jparams)
    x = np.random.default_rng(0).standard_normal((37, cfg.d_model))
    x = x.astype(np.float32)
    if tied:
        # identical router columns: every expert ties with every other
        col = np.asarray(jp["router"])[:, :1]
        jp = {**jp, "router": jnp.asarray(np.repeat(col, cfg.num_experts,
                                                    1))}
        p = {**p, "router": torch.tensor(np.asarray(jp["router"]))}
    jidx, jw, jaux = JMoE._router(jp, jnp.asarray(x), jcfg)
    idx, w, aux = moe._router(p, torch.from_numpy(x), cfg)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    _close(w, jw, 1e-6)
    _close(aux, jaux, 1e-6)
    if tied:
        assert (idx.numpy() == np.arange(cfg.num_experts_per_tok)).all()


def _ref_drops(jcfg, jparams, x):
    """The token-slots JAX's moe_scatter drops on x, from its router."""
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams["p0"]["mlp"])
    N = x.shape[0] * x.shape[1]
    idx, _, _ = JMoE._router(jp, jnp.asarray(x.reshape(N, -1)), jcfg)
    flat = np.asarray(idx).reshape(-1)
    C = max(int(N * jcfg.num_experts_per_tok / jcfg.num_experts
                * jcfg.capacity_factor), jcfg.num_experts_per_tok)
    ranks = np.array([(flat[:i] == e).sum() for i, e in enumerate(flat)])
    return int((ranks >= C).sum())


@pytest.mark.parametrize("arch,impl,cf", [
    ("mixtral-8x7b", "dense", 2.0), ("mixtral-8x7b", "scatter", 2.0),
    ("mixtral-8x7b", "scatter", 0.5), ("deepseek-moe-16b", "scatter", 0.7),
    ("deepseek-moe-16b", "dense", 2.0)])
def test_moe_modules_match_jax(models, arch, impl, cf):
    """moe_dense, moe_scatter (with and without drops) and apply_moe's
    shared experts at f32 1e-5; the drop counter counts JAX's drops."""
    jcfg, jparams, _, _ = models[arch]
    jcfg = dataclasses.replace(jcfg, moe_impl=impl, capacity_factor=cf)
    cfg = ModelConfig.from_reference(jcfg)
    jp, p = _layer(jparams)
    x = np.random.default_rng(1).standard_normal((3, 13, cfg.d_model))
    x = x.astype(np.float32)
    with moe.count_drops() as drops:
        y, aux = moe.apply_moe(p, torch.from_numpy(x), cfg)
    calls, dropped, most = drops.read()
    jy, jaux = JMoE.apply_moe(jp, jnp.asarray(x), jcfg)
    _close_scaled(y, jy, 1e-5)
    _close(aux, jaux, 1e-6)
    if impl == "scatter":
        want = _ref_drops(jcfg, jparams, x)
        assert (calls, dropped, most) == (1, want, want)
        assert (want > 0) == (cf < 1)
    else:
        assert calls == 0


def test_capacity_is_the_references_expression():
    """C at every N of a call up to 4096 for each registry MoE config,
    against the reference's own float expression (its operand order and
    truncation), at the default factor and at E / K."""
    for arch in ("deepseek-moe-16b", "mixtral-8x7b", "jamba-1.5-large-398b"):
        cfg = configs.get_config(arch)
        E_, K = cfg.num_experts, cfg.num_experts_per_tok
        for cf in (cfg.capacity_factor, E_ / K):
            c = dataclasses.replace(cfg, capacity_factor=cf)
            got = [moe.capacity(c, n) for n in range(1, 4097)]
            assert got == [max(int(n * K / E_ * cf), K)
                           for n in range(1, 4097)]
            if cf == E_ / K:
                assert all(g >= n for n, g in enumerate(got, 1))


# ----------------------------------------------------------------------------
# the models
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_entry_points_match_jax(models, arch):
    """forward (and its aux), prefill, decode, verify and (Jamba) the gated
    replay give JAX's logits at f32 1e-4, and the states written agree."""
    jcfg, jparams, cfg, params = models[arch]
    rng = np.random.default_rng(2)
    V = cfg.vocab_size
    toks = rng.integers(0, V, (2, 11)).astype(np.int32)
    want, jaux = J_FORWARD(jparams, jcfg, tokens=jnp.asarray(toks))
    got, aux = M.forward(params, cfg, tokens=torch.from_numpy(toks))
    _close(got, want, 1e-4)
    _close(aux, jaux, 1e-6)
    assert float(aux) > 0
    B, P, S, K, W1 = 2, 9, 24, 3, 4
    st = M.init_state(cfg, B, S, device="cpu")
    jst = JM.init_state(jcfg, B, S)
    got, st = M.prefill(params, cfg, st, torch.from_numpy(toks[:, :P]))
    want, jst = J_PREFILL(jparams, jcfg, jst, jnp.asarray(toks[:, :P]))
    _close(got, want, 1e-4)
    step = rng.integers(0, V, (B, 2)).astype(np.int32)
    got, st = M.decode(params, cfg, st, torch.from_numpy(step))
    want, jst = J_DECODE(jparams, jcfg, jst, jnp.asarray(step))
    _close(got, want, 1e-4)
    rows = rng.integers(0, V, (B, K, W1)).astype(np.int32)
    got, _ = M.verify(params, cfg, st, torch.from_numpy(rows))
    want, _ = J_VERIFY(jparams, jcfg, jst, jnp.asarray(rows))
    _close(got, want, 1e-4)
    if M.has_recurrent(cfg):
        nc = np.array([3, 0], np.int32)
        got, st = M.decode(params, cfg, st, torch.from_numpy(rows[:, 1]),
                           n_commit=torch.from_numpy(nc))
        want, jst = J_DECODE(jparams, jcfg, jst, jnp.asarray(rows[:, 1]),
                             n_commit=jnp.asarray(nc))
        _close(got, want, 1e-4)
    np.testing.assert_array_equal(st["cur_len"].numpy(),
                                  np.asarray(jst["cur_len"]))
    for gid, g in st["groups"].items():
        for name, leaf in g.items():
            _close(leaf, jst["groups"][gid][name], 1e-4)


def test_bf16_config_keeps_the_float32_router(models):
    """A bf16 config's router stays float32 through ``from_jax_flat``, bit
    for bit, and the expert stacks take the reference's layout."""
    jcfg, jparams, _, _ = models["deepseek-moe-16b"]
    jcfg = dataclasses.replace(jcfg, param_dtype=jnp.bfloat16,
                               compute_dtype=jnp.bfloat16)
    jp = J_INIT(jax.random.PRNGKey(4), jcfg)
    cfg, p = _port(jcfg, jp)
    mlp = p["p0"]["mlp"]
    assert mlp["router"].dtype == torch.float32
    np.testing.assert_array_equal(mlp["router"].numpy(),
                                  np.asarray(jp["p0"]["mlp"]["router"]))
    assert mlp["w_gate"].dtype == torch.bfloat16
    assert mlp["w_gate"].shape == (1, 4, 128, 64)
    assert mlp["w_down"].shape == (1, 4, 64, 128)
    assert mlp["shared_down"].shape == (1, 64, 128)
    own = M.init_params(cfg, seed=0, device="cpu")["p0"]["mlp"]
    assert own["router"].dtype == torch.float32
    # the reference's fan-in for an (E, d, f) expert stack is E
    assert abs(float(own["w_up"].float().std()) - 0.88 / 2) < 0.05


def test_jamba_with_experts_cuts_one_period():
    full, smoke = (configs.get_config("jamba-1.5-large-398b"),
                   configs.get_smoke_config("jamba-1.5-large-398b"))
    cut = with_experts(full)
    assert [(b.mixer, b.mlp) for b in cut.block_pattern] == [
        ("mamba", "swiglu"), ("mamba", "moe"), ("mamba", "swiglu"),
        ("mamba", "moe"), ("attn", "swiglu")]
    assert (cut.num_layers, cut.d_model, cut.num_experts,
            cut.vocab_size) == (5, 8192, 16, 65536)
    assert abs(cut.param_count() / 1e9 - 24.05) < 0.01
    one = with_experts(full, 3, start=2)
    assert [b.mlp for b in one.block_pattern] == ["swiglu", "moe", "swiglu"]
    assert abs(one.param_count() / 1e9 - 12.94) < 0.01
    assert with_experts(smoke, 2).block_pattern == smoke.block_pattern
    with pytest.raises(ValueError, match="no 6 blocks"):
        with_experts(full, 6, start=4)
    assert no_experts(smoke).num_experts == 0


# ----------------------------------------------------------------------------
# generation and serving
# ----------------------------------------------------------------------------
def _tables(cfg, params):
    """The port's n-gram tables of a smoke model (k_max, w_max 4) and the
    same tables for JAX."""
    topk, chain = build_bigram(
        lambda t: M.forward(params, cfg, tokens=t)[0][:, -1],
        cfg.vocab_size, k_max=4, w_max=4, device="cpu")
    emb = params["embed"]["embedding"]
    uni = build_unigram(emb, params["embed"].get("lm_head", emb.T), k_max=4)
    return (NGramTables(uni, topk, chain),
            JTables(*(jnp.asarray(t.numpy()) for t in (uni, topk, chain))))


@pytest.fixture(scope="module")
def tables(models):
    return {arch: _tables(*models[arch][2:]) for arch in ARCHS}


def _prompt(seed, B=3, P=10, vocab=7):
    return np.random.default_rng(seed).integers(0, vocab, (B, P)).astype(
        np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_jax(models, tables, arch):
    """Mixed ``generate`` over the linear cache gives JAX's buffer, lengths
    and call counts (the paged layout's tokens are held in
    ``test_continuous_serving_matches_jax_engine``); at the smoke configs'
    C = N nothing drops, so it is also ``greedy_reference``'s output."""
    jcfg, jparams, cfg, params = models[arch]
    tab, jtab = tables[arch]
    prompt = _prompt(3)
    kw = dict(k=4, w=3, strategy="mixed", max_new_tokens=MAX_NEW)
    buf, blen, stats = E.generate(
        params, cfg, E.SpecConfig(**kw), prompt, tab, device="cpu")
    jbuf, jblen, jstats = JE.generate(
        jparams, jcfg, JE.SpecConfig(backend="xla", **kw),
        jnp.asarray(prompt), jtab)
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))
    np.testing.assert_array_equal(blen.numpy(), np.asarray(jblen))
    np.testing.assert_array_equal(stats["calls"].numpy(),
                                  np.asarray(jstats["calls"]))
    n = prompt.shape[1] + MAX_NEW
    ref = E.greedy_reference(params, cfg, prompt, MAX_NEW, device="cpu")
    np.testing.assert_array_equal(buf[:, :n].numpy(), ref.numpy())


def _workload():
    out = []
    for i in range(5):
        text = f"def f{i}(x): return x * {i} + 1"
        text = (text * 2)[:30] if i % 3 == 1 else text[:14]
        out.append((text, (6, 10, 12)[i % 3]))
    return out


def _serve(eng, work):
    for text, mnt in work:
        eng.submit(text, max_new_tokens=mnt)
    return sorted(eng.serve_continuous(), key=lambda r: r.request_id)


@pytest.mark.parametrize("arch,paged", [
    ("deepseek-moe-16b", True), ("mixtral-8x7b", False),
    ("jamba-1.5-large-398b", True)])
def test_continuous_serving_matches_jax_engine(models, tables, arch, paged):
    """Outputs, calls and acceptance histograms equal the reference
    engine's, over the paged pool where the arch allows it (Mixtral's
    window keeps it linear; ``test_generate_matches_jax`` holds the other
    two on the linear cache); the pool drains without a leak."""
    jcfg, jparams, cfg, params = models[arch]
    tab, jtab = tables[arch]
    common = dict(max_batch=2, buckets=(16, 32), max_new_cap=12,
                  paged=paged, num_pages=9 if paged else None, page_size=8)
    jeng = JServingEngine(jparams, jcfg, JE.SpecConfig(
        k=4, w=3, strategy="mixed", backend="xla"), tables=jtab, **common)
    eng = ServingEngine(params, cfg, E.SpecConfig(k=4, w=3,
                                                  strategy="mixed"),
                        tables=tab, device="cpu", **common)
    work = _workload()
    done, jdone = _serve(eng, work), _serve(jeng, work)
    assert len(done) == len(jdone) == len(work)
    for r, jr, (_, mnt) in zip(done, jdone, work):
        np.testing.assert_array_equal(r.output_ids, jr.output_ids)
        for key in ("new_tokens", "model_calls", "accept_hist"):
            assert r.stats[key] == jr.stats[key], key
        assert r.stats["new_tokens"] == mnt
    if paged:
        assert eng.pool_stats() == jeng.pool_stats()
        assert eng.pool_stats()["free_pages"] == 9


def test_capacity_drops_give_jaxs_tokens():
    """``mixtral-smoke`` at Mixtral's own E/K (8 experts, top-2): C = N/2,
    so token-slots drop and a row's output depends on the call's other
    rows.  The port gives JAX's speculative tokens and JAX's
    ``greedy_reference``, drops included, although the two differ from
    each other in some rows (the reference's fault, kept)."""
    jcfg = _jcfg("mixtral-8x7b", num_experts=8, name="mixtral-smoke-e8")
    jparams = J_INIT(jax.random.PRNGKey(1), jcfg)
    cfg, params = _port(jcfg, jparams)
    tab, jtab = _tables(cfg, params)
    prompt = np.random.default_rng(5).integers(0, cfg.vocab_size, (4, 12))
    prompt = prompt.astype(np.int32)
    new = 24
    kw = dict(k=4, w=3, strategy="mixed", max_new_tokens=new)
    with moe.count_drops() as drops:
        buf, _, stats = E.generate(params, cfg, E.SpecConfig(**kw), prompt,
                                   tab, device="cpu")
    calls, dropped, _ = drops.read()
    jbuf, _, jstats = JE.generate(jparams, jcfg,
                                  JE.SpecConfig(backend="xla", **kw),
                                  jnp.asarray(prompt), jtab)
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))
    np.testing.assert_array_equal(stats["calls"].numpy(),
                                  np.asarray(jstats["calls"]))
    ref = E.greedy_reference(params, cfg, prompt, new, device="cpu")
    jref = JE.greedy_reference(jparams, jcfg, jnp.asarray(prompt), new)
    np.testing.assert_array_equal(ref.numpy(), np.asarray(jref))
    n = prompt.shape[1] + new
    differ = [b for b in range(4)
              if not np.array_equal(buf[b, :n].numpy(), ref[b].numpy())]
    assert dropped > 0 and calls > 0
    assert differ, "no row shows the capacity fault"


# ----------------------------------------------------------------------------
# training
# ----------------------------------------------------------------------------
def test_train_step_matches_jax(models):
    """deepseek-smoke: loss, aux_loss and every gradient leaf equal JAX's
    (f32 1e-5); the aux loss reaches the gradient of the router."""
    jcfg, jparams, cfg, params = models["deepseek-moe-16b"]
    batch = np.random.default_rng(6).integers(
        0, cfg.vocab_size, (4, 33)).astype(np.int32)
    (jtotal, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: JT.lm_loss(p, jcfg, jnp.asarray(batch)), has_aux=True))(
        jparams)
    live = _deep_copy(params)
    leaves = []

    def track(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                track(v)
            else:
                tree[k] = v.detach().requires_grad_()
                leaves.append(tree[k])
    track(live)
    total, m = T.lm_loss(live, cfg, torch.from_numpy(batch), remat=True)
    grads = torch.autograd.grad(total, leaves)
    _close(total.detach(), jtotal, 1e-5)
    _close(m["loss"], jm["loss"], 1e-5)
    _close(m["aux_loss"], jm["aux_loss"], 1e-6)
    assert float(m["aux_loss"]) > 0
    jflat = _flatten(jg)
    names = list(_flatten_names(live))
    assert sorted(names) == sorted(jflat)
    for name, g in zip(names, grads):
        _close(g, jflat[name], 1e-5)
    router = names.index("p0/mlp/router")
    assert float(grads[router].abs().max()) > 0


def _deep_copy(tree):
    return {k: _deep_copy(v) if isinstance(v, dict) else v
            for k, v in tree.items()}


def _flatten_names(tree, prefix=""):
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flatten_names(v, key)
        else:
            yield key
