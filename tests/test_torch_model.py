"""The port's model entry points (repro_torch.models) against the JAX
reference, with the same weights.

Weights go from the JAX ``init_params`` through ``checkpoint._flatten`` into
``weights.from_jax_flat``; token inputs are made with numpy.  forward,
prefill, decode and verify logits agree within atol 1e-4 in f32 (float
reassociation across frameworks only).  In bf16 the two frameworks round
intermediates at different places, so logits agree within 6e-2 (the
logits are O(1); one bf16 ulp at 1.0 is 7.8e-3).  The caches after prefill
and ``commit_kv_tails`` agree within the same tolerances.  The
sliding-window + softcap config runs the plain paths' ring cache (window 8
under a 24-token buffer, a 9-token prompt) and logit softcap, which K1
does not take.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.models import model as JM
from repro.train.checkpoint import _flatten
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.models.weights import from_jax_flat, load_npz


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The port's side in one thread: these models are tiny, and the suite
    runs its files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = {"float32": 1e-4, "bfloat16": 6e-2}


def _bench_cfg(_):
    from benchmarks.common import bench_config
    return bench_config()


CFGS = {"tiny": lambda tiny: tiny,       # conftest's tiny_dense_cfg (GQA)
        "stablelm-smoke": lambda _: get_smoke_config("stablelm-1.6b"),
        "bench": _bench_cfg,
        "swa-softcap": lambda tiny: dataclasses.replace(
            tiny, name="tiny-swa", sliding_window=8,
            attn_logit_softcap=30.0)}


@pytest.fixture(params=[(c, d) for c in CFGS for d in TOL],
                ids=lambda p: f"{p[0]}-{p[1]}")
def pair(request, tiny_dense_cfg):
    """(jax cfg, jax params, port cfg, port params, dtype name)."""
    name, dtype = request.param
    jcfg = CFGS[name](tiny_dense_cfg)
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    jcfg = dataclasses.replace(jcfg, name=f"{jcfg.name}-{dtype}",
                               param_dtype=jd, compute_dtype=jd)
    jparams = JM.init_params(jax.random.PRNGKey(1), jcfg)
    cfg = ModelConfig.from_reference(jcfg)
    params = from_jax_flat(_flatten(jparams), cfg, device="cpu")
    return jcfg, jparams, cfg, params, dtype


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


def _toks(rng, V, *shape):
    return rng.integers(0, V, shape).astype(np.int32)


def test_forward_logits_match_jax(pair):
    jcfg, jparams, cfg, params, dtype = pair
    toks = _toks(np.random.default_rng(0), cfg.vocab_size, 2, 11)
    want, _ = JM.forward(jparams, jcfg, tokens=jnp.asarray(toks))
    got, _ = M.forward(params, cfg, tokens=torch.from_numpy(toks))
    _close(got, want, dtype)


def test_prefill_decode_verify_commit_match_jax(pair):
    jcfg, jparams, cfg, params, dtype = pair
    rng = np.random.default_rng(1)
    B, P, S, K, W1 = 2, 9, 24, 3, 4
    V = cfg.vocab_size
    prompt = _toks(rng, V, B, P)
    jst = JM.init_state(jcfg, B, S)
    st = M.init_state(cfg, B, S, device="cpu")

    def same_state():
        for gid, g in jst["groups"].items():
            for leaf in ("k", "v"):
                _close(st["groups"][gid][leaf], g[leaf], dtype)
        np.testing.assert_array_equal(st["cur_len"].numpy(),
                                      np.asarray(jst["cur_len"]))

    want, jst = JM.prefill(jparams, jcfg, jst, tokens=jnp.asarray(prompt))
    got, st = M.prefill(params, cfg, st, tokens=torch.from_numpy(prompt))
    _close(got, want, dtype)
    same_state()

    step = _toks(rng, V, B, 1)
    want, jst = JM.decode(jparams, jcfg, jst, jnp.asarray(step))
    got, st = M.decode(params, cfg, st, torch.from_numpy(step))
    _close(got, want, dtype)
    same_state()

    rows = _toks(rng, V, B, K, W1)
    want, jtails = JM.verify(jparams, jcfg, jst, jnp.asarray(rows))
    got, tails = M.verify(params, cfg, st, torch.from_numpy(rows))
    _close(got, want, dtype)
    for gid, g in jtails.items():
        for leaf in ("k_tail", "v_tail"):
            _close(tails[gid][leaf], g[leaf], dtype)

    winner = np.array([2, 0], np.int32)
    n_commit = np.array([3, 1], np.int32)
    jst = JM.commit_kv_tails(jcfg, jst, jtails, jnp.asarray(winner),
                             jnp.asarray(n_commit))
    st = M.commit_kv_tails(cfg, st, tails, torch.from_numpy(winner),
                           torch.from_numpy(n_commit))
    same_state()


def test_weights_round_trip_through_an_npz_checkpoint(tmp_path,
                                                      tiny_dense_cfg):
    from repro.train.checkpoint import save
    jparams = JM.init_params(jax.random.PRNGKey(3), tiny_dense_cfg)
    path = str(tmp_path / "ckpt.npz")
    save(path, jparams)
    cfg = ModelConfig.from_reference(tiny_dense_cfg)
    params = load_npz(path, cfg, device="cpu")
    flat = _flatten(jparams)
    assert params["p0"]["mixer"]["wq"].shape == flat["p0/mixer/wq"].shape
    np.testing.assert_array_equal(params["embed"]["embedding"].numpy(),
                                  flat["embed/embedding"])
    bad = dict(flat)
    bad.pop("final_norm/scale")
    with pytest.raises(ValueError):
        from_jax_flat(bad, cfg, device="cpu")


def test_init_params_matches_the_reference_layout(tiny_dense_cfg):
    cfg = ModelConfig.from_reference(tiny_dense_cfg)
    jparams = JM.init_params(jax.random.PRNGKey(0), tiny_dense_cfg)
    params = M.init_params(cfg, seed=0, device="cpu")
    flat = _flatten(jparams)
    from_jax_flat(flat, cfg, device="cpu")       # same keys and shapes
    again = M.init_params(cfg, seed=0, device="cpu")
    assert torch.equal(params["p0"]["mixer"]["wq"], again["p0"]["mixer"]["wq"])
    wq = params["p0"]["mixer"]["wq"]
    # truncated normal at std 1/sqrt(fan_in): bounded by 2 std
    assert float(wq.abs().max()) <= 2.0 / cfg.d_model ** 0.5 + 1e-6
    with pytest.raises(RuntimeError, match="device='cpu'"):
        M.init_params(cfg, seed=0)                 # no card here
