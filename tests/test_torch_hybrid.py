"""The port's hybrid Mamba/attention model against the JAX reference, on the
CPU: the entry points (forward, prefill, decode, the gated replay, verify)
with the same weights, and the Jamba configs.  Serving the hybrid is
``test_torch_hybrid_serving.py``.

Configs: a no-MoE variant of ``tests/conftest.py:tiny_hybrid_cfg`` (three
Mamba layers around one attention layer) and of Jamba's
``smoke_config()`` (Mamba + attention, d_state 8), each MoE FFN made the
dense SwiGLU (``_dense_ffn``), and a Mamba-only stack.  Logits and states
agree within f32 1e-4, as in the earlier slices (the Mamba scan sums in
another order than the reference's associative scan), and within bf16
1e-1, not the dense slices' 6e-2: bf16 rounds at other places in the two
frameworks, and three Mamba layers amplify it — on the tiny hybrid's
forward, JAX's own bf16 logits lie 0.069 from its f32 logits with the same
weights, and the port's bf16 logits 0.086 from JAX's bf16 and 0.089 from
its f32.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_config
from repro.configs import get_smoke_config as j_smoke
from repro.models import model as JM
from repro.models.config import BlockSpec as JBlockSpec
from repro.train.checkpoint import _flatten
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.jamba_1_5_large_398b import no_experts
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import param_shapes
from repro_torch.models.weights import from_jax_flat


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The port's side in one thread: these models are tiny, and the suite
    runs its files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = {"float32": 1e-4, "bfloat16": 1e-1}
# the reference's entry points, compiled once per shape (op-by-op dispatch
# of the eager reference is the slowest part of these tests)
J_FORWARD = jax.jit(JM.forward, static_argnums=(1,))
J_PREFILL = jax.jit(JM.prefill, static_argnums=(1,))
J_DECODE = jax.jit(JM.decode, static_argnums=(1,))
J_VERIFY = jax.jit(JM.verify, static_argnums=(1,))
JAMBA = "jamba-1.5-large-398b"


def _dense_ffn(jcfg, name):
    """The reference config with every MoE FFN made the dense SwiGLU."""
    pattern = tuple(JBlockSpec(b.mixer, "swiglu" if b.mlp == "moe"
                               else b.mlp) for b in jcfg.block_pattern)
    return dataclasses.replace(jcfg, name=name, block_pattern=pattern,
                               num_experts=0, backend="xla").validate()


def _port(jcfg, jparams):
    cfg = ModelConfig.from_reference(jcfg)
    return cfg, from_jax_flat(_flatten(jparams), cfg, device="cpu")


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


CFGS = {"tiny-hybrid": lambda tiny: _dense_ffn(tiny, "tiny-hyb-dense"),
        "jamba-smoke": lambda _: _dense_ffn(j_smoke(JAMBA), "jamba-dense"),
        # no attention layer at all: the pure-recurrent path of the entry
        # points (no cache positions, no KV tails)
        "mamba-only": lambda tiny: dataclasses.replace(
            _dense_ffn(tiny, "tiny-mamba"), num_layers=2,
            block_pattern=(JBlockSpec("mamba", "swiglu"),) * 2)}


@pytest.fixture(params=[(c, d) for c in CFGS for d in TOL],
                ids=lambda p: f"{p[0]}-{p[1]}")
def pair(request, tiny_hybrid_cfg):
    """(jax cfg, jax params, port cfg, port params, dtype name)."""
    name, dtype = request.param
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    jcfg = CFGS[name](tiny_hybrid_cfg)
    jcfg = dataclasses.replace(jcfg, name=f"{jcfg.name}-{dtype}",
                               param_dtype=jd, compute_dtype=jd)
    jparams = JM.init_params(jax.random.PRNGKey(1), jcfg)
    return (jcfg, jparams) + _port(jcfg, jparams) + (dtype,)


def test_entry_points_match_jax(pair):
    """forward, prefill, decode, verify and the gated replay (decode with
    n_commit): logits, the KV cache and the Mamba states after each."""
    jcfg, jparams, cfg, params, dtype = pair
    rng = np.random.default_rng(1)
    B, P, S, K, W1 = 2, 9, 24, 3, 4
    V = cfg.vocab_size
    toks = rng.integers(0, V, (B, 11)).astype(np.int32)
    want, _ = J_FORWARD(jparams, jcfg, jnp.asarray(toks))
    got, _ = M.forward(params, cfg, tokens=torch.from_numpy(toks))
    _close(got, want, dtype)

    jst = JM.init_state(jcfg, B, S)
    st = M.init_state(cfg, B, S, device="cpu")

    def same_state():
        for gid, g in jst["groups"].items():
            assert sorted(st["groups"][gid]) == sorted(g)
            for leaf, val in g.items():
                assert st["groups"][gid][leaf].dtype == (
                    torch.float32 if leaf == "ssm" else cfg.compute_dtype)
                _close(st["groups"][gid][leaf], val, dtype)
        np.testing.assert_array_equal(st["cur_len"].numpy(),
                                      np.asarray(jst["cur_len"]))

    prompt = toks[:, :P]
    want, jst = J_PREFILL(jparams, jcfg, jst, jnp.asarray(prompt))
    got, st = M.prefill(params, cfg, st, tokens=torch.from_numpy(prompt))
    _close(got, want, dtype)
    same_state()
    step = rng.integers(0, V, (B, 1)).astype(np.int32)
    want, jst = J_DECODE(jparams, jcfg, jst, jnp.asarray(step))
    got, st = M.decode(params, cfg, st, torch.from_numpy(step))
    _close(got, want, dtype)
    same_state()
    rows = rng.integers(0, V, (B, K, W1)).astype(np.int32)
    want, jtails = J_VERIFY(jparams, jcfg, jst, jnp.asarray(rows))
    got, tails = M.verify(params, cfg, st, torch.from_numpy(rows))
    _close(got, want, dtype)
    assert sorted(tails) == sorted(jtails)        # attention groups only
    for gid, g in jtails.items():
        for leaf in ("k_tail", "v_tail"):
            _close(tails[gid][leaf], g[leaf], dtype)
    same_state()                                  # verify writes nothing
    for n_commit in ([3, 0], [W1, 1]):
        win = rows[:, 1]
        nc = np.asarray(n_commit, np.int32)
        want, jst = J_DECODE(jparams, jcfg, jst, jnp.asarray(win),
                             jnp.asarray(nc))
        got, st = M.decode(params, cfg, st, torch.from_numpy(win),
                           n_commit=torch.from_numpy(nc))
        _close(got, want, dtype)
        same_state()


# ----------------------------------------------------------------------------
# configs
# ----------------------------------------------------------------------------
def test_jamba_configs_and_the_no_experts_cut():
    """The published config and its smoke config carry experts (the smoke
    config initialises with them; the published one's MoE leaves take the
    reference's layout); ``no_experts`` keeps widths, cuts depth to whole
    periods and makes every FFN the dense SwiGLU."""
    full, smoke = get_config(JAMBA), get_smoke_config(JAMBA)
    assert full == ModelConfig.from_reference(j_config(JAMBA))
    assert smoke == ModelConfig.from_reference(j_smoke(JAMBA))
    assert M.init_params(smoke, device="cpu")["p0"]["mlp"]["w_up"].shape \
        == (1, 4, 128, 256)
    assert param_shapes(full)["p1"]["mlp"]["w_gate"][0] == (9, 16, 8192,
                                                            24576)
    cut = no_experts(full)
    assert (cut.num_layers, cut.d_model, cut.num_heads, cut.num_kv_heads,
            cut.mamba_d_inner, cut.mamba_d_state, cut.vocab_size) == \
        (8, 8192, 64, 8, 16384, 16, 65536)
    assert [b.mixer for b in cut.block_pattern] == \
        ["mamba"] * 4 + ["attn"] + ["mamba"] * 3
    assert all(b.mlp == "swiglu" for b in cut.block_pattern)
    assert abs(cut.param_count() / 1e9 - 9.0) < 0.01
    assert no_experts(full, periods=2).num_layers == 16
    small = no_experts(smoke)
    p = M.init_params(small, seed=0, device="cpu")
    assert p["p0"]["mixer"]["A_log"].shape == (1, 256, 8)
    assert M.has_recurrent(small)
