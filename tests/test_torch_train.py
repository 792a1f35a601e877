"""The port's training path against the JAX reference, on the CPU: the
data pipeline, AdamW, the train step (dense, chunked loss, encoder loss,
the hybrid), remat, and npz checkpoints crossing both ways.

Parameters start from the reference's ``init_train_state`` and go through
``checkpoint._flatten`` into ``weights.from_jax_flat``; token batches are
drawn from a seed with numpy.  Each JAX step is compiled once per module.

Tolerances (float32): the optimizer's pieces 1e-6; train steps 1e-5 on
losses, ``grad_norm`` and parameters (AdamW's first steps divide each
gradient element by its own magnitude, so a parameter moves by ~lr
whatever its gradient's size, and the two frameworks' reduction orders
differ in the last bits of the gradient); the hybrid 1e-4 (its scan sums
in another order than the reference's associative scan, as in
``test_torch_hybrid.py``); one bfloat16 step's loss 2e-2 (the frameworks
round bf16 intermediates at different places; the loss is ~4.1 and one bf16
ulp there is 1.6e-2).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.data import pipeline as jpipe
from repro.models import model as JM
from repro.models.config import BlockSpec as JBlockSpec
from repro.train import checkpoint as jckpt
from repro.train import optimizer as JO
from repro.train import train_loop as JT
from repro.train.checkpoint import _flatten
from repro_torch.data import pipeline
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.models.weights import from_jax_flat, load_npz
from repro_torch.train import checkpoint, optimizer as O, train_loop as T

STEPS = 4
B, SEQ = 4, 32
OPT = dict(lr=1e-3, total_steps=STEPS + 2, warmup_steps=2)
TOL = 1e-5
HYB_TOL = 1e-4
M_NOISE = 1e-8      # the hybrid's gradient noise, in first-moment units
BF16_LOSS_TOL = 2e-2


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The port's side in one thread: these models are tiny, and the suite
    runs its files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(jcfg, jparams):
    cfg = ModelConfig.from_reference(jcfg)
    return cfg, from_jax_flat(_flatten(jparams), cfg, device="cpu")


def _np(t):
    return t.detach().float().numpy()


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _same_tree(got, want_flat, tol):
    flat = checkpoint.flatten(got)
    assert sorted(flat) == sorted(want_flat)
    for k, v in want_flat.items():
        np.testing.assert_allclose(
            _np(_leaf(got, k)), np.asarray(v, np.float32), atol=tol,
            rtol=tol, err_msg=k)


def _leaf(tree, key):
    for part in key.split("/"):
        tree = tree[part]
    return tree


def _tokens(V, steps, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, V, (B, SEQ + 1)).astype(np.int32)
            for _ in range(steps)]


# ----------------------------------------------------------------------------
# data pipeline
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("task,shard,num_shards",
                         [("code", 0, 1), ("math", 1, 3), ("chat", 2, 3)])
def test_packed_batches_equal_reference(task, shard, num_shards):
    got = list(pipeline.packed_batches(task, 3, 40, 5, seed=2, shard=shard,
                                       num_shards=num_shards))
    want = list(jpipe.packed_batches(task, 3, 40, 5, seed=2, shard=shard,
                                     num_shards=num_shards))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int32 and g.shape == (3, 41)
        np.testing.assert_array_equal(g, w)


def test_mixed_batches_and_token_stream_equal_reference():
    np.testing.assert_array_equal(pipeline.token_stream("chat", 20, seed=4),
                                  jpipe.token_stream("chat", 20, seed=4))
    got = list(pipeline.mixed_batches(8, 128, 6, seed=0))
    want = list(jpipe.mixed_batches(8, 128, 6, seed=0))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape == (8, 129)
        np.testing.assert_array_equal(g, w)


# ----------------------------------------------------------------------------
# optimizer
# ----------------------------------------------------------------------------
def test_cosine_lr_equals_reference():
    cfg = O.AdamWConfig(lr=2e-3, warmup_steps=5, total_steps=40)
    jcfg = JO.AdamWConfig(lr=2e-3, warmup_steps=5, total_steps=40)
    for s in range(0, 45, 3):
        got = O.cosine_lr(cfg, torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32
        _close(got, JO.cosine_lr(jcfg, jnp.asarray(s, jnp.int32)), 1e-6)


def test_global_norm_and_adamw_update_equal_reference():
    """Leaves of ndim 1 (no weight decay) and 2 (decayed), three steps from
    a nonzero state, gradients large enough to clip."""
    rng = np.random.default_rng(3)
    flat = {"a/scale": rng.normal(size=(7,)).astype(np.float32),
            "a/w": rng.normal(size=(5, 6)).astype(np.float32)}
    nest = lambda f, conv: {"a": {k.split("/")[1]: conv(v)
                                  for k, v in f.items()}}
    params = nest(flat, torch.from_numpy)
    jparams = nest(flat, jnp.asarray)
    cfg = O.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10)
    jcfg = JO.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10)
    opt, jopt = O.init_opt_state(params), JO.init_opt_state(jparams)
    assert opt["step"].dtype == torch.int32
    for i in range(3):
        g = {k: (rng.normal(size=v.shape) * (i + 1)).astype(np.float32)
             for k, v in flat.items()}
        grads, jgrads = nest(g, torch.from_numpy), nest(g, jnp.asarray)
        _close(O.global_norm(grads), JO.global_norm(jgrads), 1e-6)
        params, opt, met = O.adamw_update(cfg, params, grads, opt)
        jparams, jopt, jmet = JO.adamw_update(jcfg, jparams, jgrads, jopt)
        for k in ("grad_norm", "lr"):
            _close(met[k], jmet[k], 1e-6)
        for tree, jtree in ((params, jparams), (opt["m"], jopt["m"]),
                            (opt["v"], jopt["v"])):
            for leaf in ("scale", "w"):
                _close(tree["a"][leaf], jtree["a"][leaf], 1e-6)
        assert int(opt["step"]) == int(jopt["step"]) == i + 1
    # weight decay reaches the matrix alone: with zero gradients the
    # vector stays, the matrix shrinks by lr * wd
    zero = {"a": {"scale": torch.zeros(7), "w": torch.zeros(5, 6)}}
    p2, _, _ = O.adamw_update(cfg, params, zero, O.init_opt_state(params))
    torch.testing.assert_close(p2["a"]["scale"], params["a"]["scale"],
                               rtol=0, atol=0)
    assert not torch.equal(p2["a"]["w"], params["a"]["w"])


# ----------------------------------------------------------------------------
# train steps
# ----------------------------------------------------------------------------
@pytest.fixture(scope="module")
def dense_run(tiny_dense_cfg):
    """STEPS reference train steps on the tiny dense config, compiled once:
    (jax cfg, initial jax params, batches, per-step metrics, final jax
    params)."""
    jcfg = dataclasses.replace(tiny_dense_cfg, name="tiny-train")
    jts = JT.init_train_state(jax.random.PRNGKey(0), jcfg)
    init = jts["params"]
    step = jax.jit(JT.make_train_step(jcfg, JO.AdamWConfig(**OPT),
                                      remat=False))
    batches = _tokens(jcfg.vocab_size, STEPS)
    mets = []
    for b in batches:
        jts, m = step(jts, jnp.asarray(b))
        mets.append({k: float(v) for k, v in m.items()})
    return jcfg, init, batches, mets, jts["params"]


def _port_steps(jcfg, init, batches, remat):
    cfg, params = _port(jcfg, init)
    ts = {"params": params, "opt": O.init_opt_state(params)}
    step = T.make_train_step(cfg, O.AdamWConfig(**OPT), remat=remat)
    mets = []
    for b in batches:
        ts, m = step(ts, b)
        mets.append(m)
    return ts, mets


def test_train_steps_equal_reference(dense_run):
    """Losses, grad_norm, lr and the parameters after STEPS steps, from the
    reference's init."""
    jcfg, init, batches, jmets, jfinal = dense_run
    ts, mets = _port_steps(jcfg, init, batches, remat=True)
    for m, jm in zip(mets, jmets):
        assert sorted(m) == sorted(jm)
        for k in jm:
            assert m[k].dim() == 0
            np.testing.assert_allclose(float(m[k]), jm[k], rtol=TOL,
                                       atol=TOL, err_msg=k)
    _same_tree(ts["params"], _flatten(jfinal), TOL)
    assert int(ts["opt"]["step"]) == STEPS


def test_remat_equals_no_remat(dense_run):
    jcfg, init, batches, _, _ = dense_run
    a, ma = _port_steps(jcfg, init, batches[:2], remat=True)
    b, mb = _port_steps(jcfg, init, batches[:2], remat=False)
    for x, y in zip(ma, mb):
        for k in x:
            torch.testing.assert_close(x[k], y[k], rtol=1e-6, atol=1e-6)
    for k, v in checkpoint.flatten(b["params"]).items():
        np.testing.assert_allclose(_np(_leaf(a["params"], k)), v, rtol=1e-6,
                                   atol=1e-6, err_msg=k)


def test_donated_step_equals_the_functional_step(tiny_dense_cfg):
    """``donate=True`` writes the new parameters and moments into the
    state passed in (the same tensors come back) with the functional
    step's bits, two steps running."""
    from repro_torch.train.optimizer import tree_leaves
    cfg = ModelConfig.from_reference(tiny_dense_cfg)
    opt = O.AdamWConfig(lr=1e-3, total_steps=4, warmup_steps=1)
    batches = _tokens(cfg.vocab_size, 2, seed=5)
    runs = {}
    for donate in (False, True):
        ts = T.init_train_state(cfg, seed=0, device="cpu")
        held = [t for t in tree_leaves(ts["params"])]
        step = T.make_train_step(cfg, opt, donate=donate)
        for b in batches:
            ts, m = step(ts, b)
        same = all(a is b for a, b in zip(tree_leaves(ts["params"]), held))
        assert same == donate
        runs[donate] = (ts, m)
    (a, ma), (b, mb) = runs[False], runs[True]
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)


def test_remat_is_for_the_full_forward_only(tiny_dense_cfg):
    cfg = ModelConfig.from_reference(tiny_dense_cfg)
    params = M.init_params(cfg, device="cpu")
    st = M.init_state(cfg, 1, 8, device="cpu")
    from repro_torch.models.transformer import run_stack
    with pytest.raises(ValueError, match="remat"):
        run_stack(params, cfg, torch.zeros(1, 4, cfg.d_model), "prefill",
                  st, {}, remat=True)


def test_chunked_loss_equals_unchunked_and_reference(tiny_dense_cfg):
    """T = 2048 (four 512-step chunks, each checkpointed): the value and
    the gradients (hidden states and embedding) equal the whole-logits
    loss and the reference's chunked loss."""
    jcfg = tiny_dense_cfg
    cfg = ModelConfig.from_reference(jcfg)
    rng = np.random.default_rng(5)
    Tn = T.CHUNKED_LOSS_MIN_T
    h = rng.normal(size=(1, Tn, cfg.d_model)).astype(np.float32)
    lbl = rng.integers(0, cfg.vocab_size, (1, Tn)).astype(np.int32)
    emb = (rng.normal(size=(cfg.d_model, cfg.vocab_size)) * 0.1
           ).astype(np.float32)

    assert not cfg.tie_embeddings      # the logits read lm_head

    def port(chunked):
        e = torch.from_numpy(emb).requires_grad_()
        hid = torch.from_numpy(h).requires_grad_()
        p = {"embed": {"lm_head": e}}
        lab = torch.from_numpy(lbl)
        loss = (T._ce_from_hidden(p, cfg, hid, lab) if chunked
                else T._nll_sum(p["embed"], cfg, hid, lab) / Tn)
        ge, gh = torch.autograd.grad(loss, (e, hid))
        return loss, ge, gh

    jfn = jax.value_and_grad(
        lambda e, hid: JT._ce_from_hidden({"embed": {"lm_head": e}}, jcfg,
                                          hid, jnp.asarray(lbl)),
        argnums=(0, 1))
    jloss, (jge, jgh) = jfn(jnp.asarray(emb), jnp.asarray(h))
    chunked, whole = port(True), port(False)
    for got in (chunked, whole):
        _close(got[0], jloss, TOL)
        _close(got[1], jge, TOL)
        _close(got[2], jgh, TOL)
    for a, b in zip(chunked, whole):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_encoder_loss_equals_reference():
    """HuBERT's smoke config: loss, metrics and every gradient."""
    jcfg = j_smoke("hubert-xlarge")
    jparams = JM.init_params(jax.random.PRNGKey(2), jcfg)
    cfg, params = _port(jcfg, jparams)
    rng = np.random.default_rng(6)
    emb = rng.normal(size=(2, 24, cfg.d_model)).astype(np.float32)
    tgt = rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    (jloss, jm), jg = jax.value_and_grad(
        lambda p: JT.encoder_loss(p, jcfg, jnp.asarray(emb),
                                  jnp.asarray(tgt)), has_aux=True)(jparams)
    live = O.tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, m = T.encoder_loss(live, cfg, torch.from_numpy(emb),
                             torch.from_numpy(tgt), remat=True)
    leaves = O.tree_leaves(live)
    # the token embedding table takes no part (frames come as embeds):
    # no gradient here, zeros in the reference
    it = iter(torch.autograd.grad(loss, leaves, allow_unused=True,
                                  materialize_grads=True))
    grads = {k: next(it) for k in checkpoint.flatten(live)}
    _close(loss, jloss, TOL)
    for k in ("loss", "aux_loss", "ppl"):
        _close(m[k], jm[k], TOL)
    jflat = _flatten(jg)
    assert sorted(jflat) == sorted(grads)
    for key, g in grads.items():
        _close(g, jflat[key], TOL)


def _dense_ffn(jcfg, name):
    """The reference config with every MoE FFN made the dense SwiGLU."""
    pattern = tuple(JBlockSpec(b.mixer, "swiglu" if b.mlp == "moe"
                               else b.mlp) for b in jcfg.block_pattern)
    return dataclasses.replace(jcfg, name=name, block_pattern=pattern,
                               num_experts=0, backend="xla").validate()


def test_hybrid_step_equals_reference():
    """One float32 step of Jamba's smoke config without experts (Mamba +
    attention): the scan's plain version is differentiable on the CPU."""
    jcfg = _dense_ffn(j_smoke("jamba-1.5-large-398b"), "jamba-train")
    jts = JT.init_train_state(jax.random.PRNGKey(3), jcfg)
    cfg, params = _port(jcfg, jts["params"])
    batch = _tokens(cfg.vocab_size, 1, seed=7)[0]
    opt = dict(lr=1e-3, total_steps=10, warmup_steps=0)
    jts, jm = jax.jit(JT.make_train_step(jcfg, JO.AdamWConfig(**opt)))(
        jts, jnp.asarray(batch))
    ts = {"params": params, "opt": O.init_opt_state(params)}
    ts, m = T.make_train_step(cfg, O.AdamWConfig(**opt))(ts, batch)
    for k in ("loss", "grad_norm", "lr", "total_loss"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=HYB_TOL,
                                   atol=HYB_TOL, err_msg=k)
    # the gradients, through the first moments m = (1 - b1) * clip * g
    # (|m| up to ~5e-3 here), agree to ~5e-10
    _same_tree(ts["opt"]["m"], _flatten(jts["opt"]["m"]), M_NOISE)
    # a parameter whose gradient lies within that noise moves by
    # lr * g / (|g| + eps) with g ~ eps: up to ~lr either way, whatever the
    # bits of g (one conv_w element of 1024 reads 1.6e-4 off, its m
    # 3.2e-10 against the reference's 6.7e-10).  Every other element is
    # held at HYB_TOL.
    jflat, jm_flat = _flatten(jts["params"]), _flatten(jts["opt"]["m"])
    for k, want in jflat.items():
        got = _np(_leaf(ts["params"], k))
        noisy = np.abs(np.asarray(jm_flat[k])) < M_NOISE
        np.testing.assert_allclose(got[~noisy], np.asarray(want)[~noisy],
                                   rtol=HYB_TOL, atol=HYB_TOL, err_msg=k)
        assert np.all(np.abs(got - np.asarray(want))[noisy]
                      <= 2 * opt["lr"]), k


def test_bf16_step_loss_within_tolerance(tiny_dense_cfg):
    jcfg = dataclasses.replace(tiny_dense_cfg, name="tiny-bf16",
                               param_dtype=jnp.bfloat16,
                               compute_dtype=jnp.bfloat16)
    jts = JT.init_train_state(jax.random.PRNGKey(4), jcfg)
    cfg, params = _port(jcfg, jts["params"])
    assert params["embed"]["embedding"].dtype == torch.bfloat16
    batch = _tokens(cfg.vocab_size, 1, seed=8)[0]
    jts, jm = jax.jit(JT.make_train_step(jcfg, JO.AdamWConfig(**OPT)))(
        jts, jnp.asarray(batch))
    ts = {"params": params, "opt": O.init_opt_state(params)}
    ts, m = T.make_train_step(cfg, O.AdamWConfig(**OPT))(ts, batch)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=BF16_LOSS_TOL, atol=BF16_LOSS_TOL)
    assert ts["params"]["p0"]["mixer"]["wq"].dtype == torch.bfloat16
    assert ts["opt"]["m"]["p0"]["mixer"]["wq"].dtype == torch.float32


def test_init_train_state_on_the_cpu(tiny_dense_cfg):
    cfg = ModelConfig.from_reference(tiny_dense_cfg)
    ts = T.init_train_state(cfg, seed=1, device="cpu")
    assert set(ts) == {"params", "opt"}
    assert int(ts["opt"]["step"]) == 0
    assert ts["opt"]["v"]["p0"]["mlp"]["w_up"].shape == (
        cfg.num_layers, cfg.d_model, cfg.d_ff)


# ----------------------------------------------------------------------------
# checkpoints
# ----------------------------------------------------------------------------
def test_port_f32_checkpoint_loads_into_reference(tiny_dense_cfg, tmp_path):
    """The port's own seeded params, saved, restored by the reference's
    ``load``: the same arrays, and the reference's logits equal the port's."""
    jcfg = tiny_dense_cfg
    cfg = ModelConfig.from_reference(jcfg)
    params = M.init_params(cfg, seed=3, device="cpu")
    path = str(tmp_path / "port.npz")
    checkpoint.save(path, params)
    like = JM.init_params(jax.random.PRNGKey(0), jcfg)
    restored = jckpt.load(path, like)
    for k, v in _flatten(restored).items():
        np.testing.assert_array_equal(np.asarray(v), _np(_leaf(params, k)))
    toks = np.random.default_rng(9).integers(0, cfg.vocab_size, (2, 12))
    want, _ = JM.forward(restored, jcfg, tokens=jnp.asarray(toks, jnp.int32))
    got, _ = M.forward(params, cfg, tokens=torch.from_numpy(toks))
    _close(got, want, TOL)
    back = checkpoint.load(path, cfg, device="cpu")
    for k, v in checkpoint.flatten(params).items():
        np.testing.assert_array_equal(_np(_leaf(back, k)), v)


def _bf16_pair(tiny_dense_cfg):
    jcfg = dataclasses.replace(tiny_dense_cfg, name="tiny-ckpt-bf16",
                               param_dtype=jnp.bfloat16,
                               compute_dtype=jnp.bfloat16)
    jparams = JM.init_params(jax.random.PRNGKey(5), jcfg)
    return jcfg, jparams, ModelConfig.from_reference(jcfg)


def test_reference_bf16_checkpoint_loads_bit_for_bit(tiny_dense_cfg,
                                                      tmp_path):
    """The reference's ``np.savez`` stores bf16 leaves as raw ``|V2``
    records; ``load_npz`` reads them as the same bf16 bits."""
    jcfg, jparams, cfg = _bf16_pair(tiny_dense_cfg)
    path = str(tmp_path / "ref.npz")
    jckpt.save(path, jparams)
    with np.load(path) as data:
        assert data["embed/embedding"].dtype == np.dtype("V2")
    params = load_npz(path, cfg, device="cpu")
    for k, v in _flatten(jparams).items():
        leaf = _leaf(params, k)
        assert leaf.dtype == torch.bfloat16
        np.testing.assert_array_equal(leaf.view(torch.int16).numpy(),
                                      np.asarray(v).view(np.int16),
                                      err_msg=k)


def test_port_bf16_checkpoint_has_the_reference_layout(tiny_dense_cfg,
                                                       tmp_path):
    """The same params saved by both packages: the same keys in the same
    order, the same dtypes and the same bytes."""
    jcfg, jparams, cfg = _bf16_pair(tiny_dense_cfg)
    params = from_jax_flat(_flatten(jparams), cfg, device="cpu")
    ref, port = str(tmp_path / "ref.npz"), str(tmp_path / "port.npz")
    jckpt.save(ref, jparams)
    checkpoint.save(port, params)
    with np.load(ref) as want, np.load(port) as got:
        assert got.files == want.files
        for k in want.files:
            assert got[k].dtype == want[k].dtype, k
            assert got[k].shape == want[k].shape, k
            assert got[k].tobytes() == want[k].tobytes(), k
