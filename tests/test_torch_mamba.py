"""The port's Mamba pieces against the JAX reference, on the CPU: K5's plain
version (the selective scan), ``mamba_mix`` / ``mamba_mix_steps`` with the
same weights, ``select_step_state``, and the Mamba parameters' layout and
dtypes.  Bit for bit within the port: the scan takes u in bf16 as its f32
upcast (the layer hands it the compute dtype), and the replay's commit
(the scan keeping the state after ``n_commit`` steps) equals
``select_step_state`` over the per-step states.

Tolerances.  The scan: f32 rtol = atol = 2e-4, the reference's own kernel
tolerance (``tests/test_kernels.py``), against both its oracle
``ref.mamba_scan_ref`` and its Pallas kernel in interpret mode; the two
sequential f32 recurrences agree to ~1e-6 here.  The block: f32 1e-5 —
the reference scans with an associative scan (another summation order)
and the port sequentially, and the two agree to ~2e-6 on these inputs;
bf16 6e-2 as the earlier slices' logits (bf16 rounds the projections and
the conv at other places in the two frameworks).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops
from repro.kernels import ref as jref
from repro.models import cache as JC
from repro.models import mamba as JMB
from repro.models import model as JM
from repro.models.config import BlockSpec, ModelConfig as JModelConfig
from repro.train.checkpoint import _flatten
from repro_torch.kernels import build, dispatch
from repro_torch.kernels.mamba_scan import mamba_scan_cuda, mamba_scan_plain
from repro_torch.models import cache as C
from repro_torch.models import mamba as MB
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.models.weights import from_jax_flat


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The port's side in one thread: these models are tiny, and the suite
    runs its files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SCAN_TOL = 2e-4
MIX_TOL = {"float32": 1e-5, "bfloat16": 6e-2}


def _scan_inputs(seed, Bt, T, di, ds, h0_rows=None):
    """The reference kernel test's distributions, drawn with numpy."""
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)
    return dict(u=n(Bt, T, di), dt=np.log1p(np.exp(n(Bt, T, di))),
                A=-np.exp(n(di, ds) * 0.3), B=n(Bt, T, ds), C=n(Bt, T, ds),
                D=np.ones((di,), np.float32),
                h0=n(h0_rows or Bt, di, ds))


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


@pytest.mark.parametrize("Bt,T,di,ds,chunk,bd", [
    (2, 32, 16, 4, 8, 8), (1, 64, 32, 16, 16, 32), (2, 16, 8, 2, 16, 8),
    (3, 1, 16, 8, 8, 8),                 # one step (decode)
    (1, 37, 24, 16, 16, 8)])             # T not a multiple of the chunk
def test_plain_scan_matches_oracle_and_pallas_kernel(Bt, T, di, ds, chunk,
                                                     bd):
    x = _scan_inputs(T + di, Bt, T, di, ds)
    args = [x[k] for k in ("u", "dt", "A", "B", "C", "D", "h0")]
    y, hT, hs = mamba_scan_plain(*map(_t, args), steps=True)
    y_r, h_r = jref.mamba_scan_ref(*map(jnp.asarray, args))
    y_k, h_k = ops.mamba_scan_op(*map(jnp.asarray, args), chunk=chunk,
                                 block_d=bd, interpret=True)
    for got, want in ((y, y_r), (hT, h_r), (y, y_k), (hT, h_k)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=SCAN_TOL, atol=SCAN_TOL)
    # the state after step t is the oracle's final state over steps 0..t
    for t in sorted({0, T // 2, T - 1}):
        part = [a[:, :t + 1] if k in ("u", "dt", "B", "C") else a
                for k, a in zip(("u", "dt", "A", "B", "C", "D", "h0"), args)]
        _, h_t = jref.mamba_scan_ref(*map(jnp.asarray, part))
        np.testing.assert_allclose(hs[:, t].numpy(), np.asarray(h_t),
                                   rtol=SCAN_TOL, atol=SCAN_TOL)


def test_plain_scan_reads_each_rows_state_by_h0_rep():
    """Verify rows b*k .. b*k+k-1 start from slot b's state: the same as a
    repeated h0, and ``final=False`` skips the final state."""
    k = 3
    x = _scan_inputs(5, 2 * k, 4, 16, 8, h0_rows=2)
    args = [_t(x[n]) for n in ("u", "dt", "A", "B", "C", "D")]
    h0 = _t(x["h0"])
    y, hT, hs = mamba_scan_plain(*args, h0, h0_rep=k, final=False)
    y_rep, _, _ = mamba_scan_plain(*args, h0.repeat_interleave(k, 0))
    assert hT is None and hs is None
    torch.testing.assert_close(y, y_rep, rtol=0, atol=0)


def test_selective_scan_follows_the_tensor():
    """A CPU tensor takes the plain version; the kernel's wrapper refuses
    CPU tensors (no fallback); any other device raises."""
    x = _scan_inputs(1, 2, 3, 8, 4)
    args = [_t(x[n]) for n in ("u", "dt", "A", "B", "C", "D", "h0")]
    y, hT, _ = dispatch.selective_scan(*args)
    y_p, h_p, _ = mamba_scan_plain(*args)
    assert torch.equal(y, y_p) and torch.equal(hT, h_p)
    with pytest.raises(ValueError, match="CUDA"):
        mamba_scan_cuda(*args)
    with pytest.raises(ValueError, match="no kernel path"):
        dispatch.selective_scan(*[a.to("meta") for a in args])
    assert "mamba_scan" in build.sources()


def test_kernel_writes_no_per_step_states():
    """The per-step states are the plain version's alone: K5's wrapper
    refuses ``steps=True`` before it looks at the device (the replay keeps
    its state by ``n_commit``)."""
    x = _scan_inputs(2, 2, 3, 8, 4)
    args = [_t(x[n]) for n in ("u", "dt", "A", "B", "C", "D", "h0")]
    with pytest.raises(ValueError, match="per-step"):
        mamba_scan_cuda(*args, final=False, steps=True)
    assert mamba_scan_plain(*args, steps=True)[2].shape == (2, 3, 8, 4)


def test_scan_takes_bf16_u_as_its_f32_upcast():
    """bf16 u through the plain version and ``dispatch.selective_scan`` gives
    the bits of the same call on ``u.float()`` (K5 upcasts in registers)."""
    x = _scan_inputs(7, 4, 9, 16, 8, h0_rows=2)
    args = [_t(x[n]) for n in ("dt", "A", "B", "C", "D", "h0")]
    u16 = _t(x["u"]).to(torch.bfloat16)
    for fn in (mamba_scan_plain, dispatch.selective_scan):
        got = fn(u16, *args, h0_rep=2, steps=True)
        want = fn(u16.float(), *args, h0_rep=2, steps=True)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


@pytest.mark.parametrize("h0_rep", [1, 2])
def test_scan_selection_equals_select_step_state(h0_rep):
    """``n_commit`` keeps the state after n_commit[b] steps (clamped to T;
    h0's row where it is 0), bit for bit ``select_step_state`` over the
    per-step states; y is unchanged, and the per-step states come too when
    asked."""
    T = 5
    x = _scan_inputs(8, 6, T, 16, 8, h0_rows=6 // h0_rep)
    args = [_t(x[n]) for n in ("u", "dt", "A", "B", "C", "D", "h0")]
    n = torch.tensor([0, 1, 3, T, T + 2, 2], dtype=torch.int32)
    y, hs_sel, none = mamba_scan_plain(*args, h0_rep=h0_rep, n_commit=n)
    y_s, _, hs = mamba_scan_plain(*args, h0_rep=h0_rep, steps=True)
    old = args[-1].repeat_interleave(h0_rep, 0)
    assert none is None and torch.equal(y, y_s)
    assert torch.equal(hs_sel, C.select_step_state(hs, old, n))
    _, sel2, hs2 = dispatch.selective_scan(*args, h0_rep=h0_rep, n_commit=n,
                                           steps=True)
    assert torch.equal(sel2, hs_sel) and torch.equal(hs2, hs)
    with pytest.raises(ValueError, match="final"):
        mamba_scan_plain(*args, h0_rep=h0_rep, n_commit=n, final=False)


# ----------------------------------------------------------------------------
# the block, with weights carried across
# ----------------------------------------------------------------------------
def _hybrid_jcfg(dtype, d_state=16):
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    return JModelConfig(
        name=f"mix-{dtype}-{d_state}", num_layers=2, d_model=32, num_heads=4,
        num_kv_heads=2, d_ff=64, vocab_size=61, mamba_d_state=d_state,
        block_pattern=(BlockSpec("mamba", "swiglu"),
                       BlockSpec("attn", "swiglu")),
        param_dtype=jd, compute_dtype=jd).validate()


@pytest.fixture(params=[("float32", 16), ("bfloat16", 16), ("float32", 4)],
                ids=lambda p: f"{p[0]}-ds{p[1]}")
def mixer(request):
    """(jax cfg, jax mixer params, port cfg, port mixer params, dtype)."""
    dtype, ds = request.param
    jcfg = _hybrid_jcfg(dtype, ds)
    jp = JM.init_params(jax.random.PRNGKey(3), jcfg)
    cfg = ModelConfig.from_reference(jcfg)
    p = from_jax_flat(_flatten(jp), cfg, device="cpu")
    jm = jax.tree_util.tree_map(lambda a: a[0], jp["p0"]["mixer"])
    pm = {k: v[0] for k, v in p["p0"]["mixer"].items()}
    return jcfg, jm, cfg, pm, dtype


def _mix_inputs(cfg, seed, B, T):
    rng = np.random.default_rng(seed)
    di, ds, dc = cfg.mamba_d_inner, cfg.mamba_d_state, cfg.mamba_d_conv
    return (rng.standard_normal((B, T, cfg.d_model)).astype(np.float32),
            rng.standard_normal((B, dc - 1, di)).astype(np.float32) * 0.5,
            rng.standard_normal((B, di, ds)).astype(np.float32) * 0.5)


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _both(cfg, jcfg, x, conv, ssm):
    cd = cfg.compute_dtype
    return ((jnp.asarray(x).astype(jcfg.compute_dtype),
             jnp.asarray(conv).astype(jcfg.compute_dtype), jnp.asarray(ssm)),
            (torch.from_numpy(x).to(cd), torch.from_numpy(conv).to(cd),
             torch.from_numpy(ssm)))


@pytest.mark.parametrize("T", [1, 20])
def test_mamba_mix_matches_reference(mixer, T):
    jcfg, jm, cfg, pm, dtype = mixer
    (jx, jconv, jssm), (x, conv, ssm) = _both(cfg, jcfg,
                                              *_mix_inputs(cfg, T, 2, T))
    jy, jc, js = JMB.mamba_mix(jm, jx, jcfg, jconv, jssm)
    y, c, s = MB.mamba_mix(pm, x, cfg, conv, ssm)
    for got, want in ((y, jy), (c, jc), (s, js)):
        _close(got, want, MIX_TOL[dtype])
    # zero states through the full forward's entry (prefill starts there)
    jc0, js0 = JMB.init_mamba_state(jcfg, 2)
    c0, s0 = MB.init_mamba_state(cfg, 2, "cpu")
    assert c0.dtype == cfg.compute_dtype and s0.dtype == torch.float32
    _close(MB.mamba_mix(pm, x, cfg, c0, s0)[0],
           JMB.mamba_mix(jm, jx, jcfg, jc0, js0)[0], MIX_TOL[dtype])


def test_mamba_mix_steps_matches_reference(mixer):
    jcfg, jm, cfg, pm, dtype = mixer
    (jx, jconv, jssm), (x, conv, ssm) = _both(cfg, jcfg,
                                              *_mix_inputs(cfg, 9, 3, 5))
    jy, jext, jhs = JMB.mamba_mix_steps(jm, jx, jcfg, jconv, jssm)
    y, ext, hs = MB.mamba_mix_steps(pm, x, cfg, conv, ssm)
    for got, want in ((y, jy), (ext, jext), (hs, jhs)):
        _close(got, want, MIX_TOL[dtype])
    # the last step's state is mamba_mix's final state
    _, _, s = MB.mamba_mix(pm, x, cfg, conv, ssm)
    torch.testing.assert_close(hs[:, -1], s, rtol=0, atol=0)


def test_mamba_mix_commit_equals_steps_then_select(mixer):
    """The replay's block (the scan keeps the committed state) equals
    ``mamba_mix_steps`` followed by ``select_step_state``, bit for bit."""
    jcfg, jm, cfg, pm, dtype = mixer
    (_, _, _), (x, conv, ssm) = _both(cfg, jcfg, *_mix_inputs(cfg, 13, 4, 5))
    n = torch.tensor([0, 2, 5, 1], dtype=torch.int32)
    y, ext, kept = MB.mamba_mix_commit(pm, x, cfg, conv, ssm, n)
    y_s, ext_s, hs = MB.mamba_mix_steps(pm, x, cfg, conv, ssm)
    assert torch.equal(y, y_s) and torch.equal(ext, ext_s)
    assert torch.equal(kept, C.select_step_state(hs, ssm, n))


def test_mix_hands_the_scan_u_in_the_compute_dtype(mixer, monkeypatch):
    """``_mix`` gives K5 u in the compute dtype; its output equals the
    block's with u cast to f32 first (the earlier path), bit for bit."""
    jcfg, jm, cfg, pm, dtype = mixer
    (_, _, _), (x, conv, ssm) = _both(cfg, jcfg, *_mix_inputs(cfg, 14, 2, 6))
    seen = []
    scan = MB.selective_scan

    def spy(u, *args, **kw):
        seen.append(u.dtype)
        return scan(u, *args, **kw)
    monkeypatch.setattr(MB, "selective_scan", spy)
    got = MB.mamba_mix(pm, x, cfg, conv, ssm)
    monkeypatch.setattr(MB, "selective_scan",
                        lambda u, *args, **kw: scan(u.float(), *args, **kw))
    want = MB.mamba_mix(pm, x, cfg, conv, ssm)
    assert seen == [cfg.compute_dtype]
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_mamba_mix_verify_rows_share_their_slots_state(mixer):
    """rep=k: slot b's state serves its k draft rows, as the reference's
    jnp.repeat of the states before mamba_mix."""
    jcfg, jm, cfg, pm, dtype = mixer
    k = 3
    xb, conv, ssm = _mix_inputs(cfg, 11, 2, 4)
    x = np.random.default_rng(12).standard_normal(
        (2 * k, 4, cfg.d_model)).astype(np.float32)
    (jx, jconv, jssm), (tx, tconv, tssm) = _both(cfg, jcfg, x, conv, ssm)
    rep = lambda a: jnp.repeat(a, k, axis=0)
    jy, _, _ = JMB.mamba_mix(jm, jx, jcfg, rep(jconv), rep(jssm))
    y, _, s = MB.mamba_mix(pm, tx, cfg, tconv, tssm, rep=k, final=False)
    assert s is None
    _close(y, jy, MIX_TOL[dtype])


def test_select_step_state_matches_reference():
    rng = np.random.default_rng(0)
    B, T = 5, 4
    per_step = rng.standard_normal((B, T, 6, 3)).astype(np.float32)
    old = rng.standard_normal((B, 6, 3)).astype(np.float32)
    n = np.array([0, 1, 2, 4, 3], np.int32)
    want = JC.select_step_state(jnp.asarray(per_step), jnp.asarray(old),
                                jnp.asarray(n))
    got = C.select_step_state(torch.from_numpy(per_step),
                              torch.from_numpy(old), torch.from_numpy(n))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ----------------------------------------------------------------------------
# parameters
# ----------------------------------------------------------------------------
def test_bf16_hybrid_weights_keep_float32_mamba_leaves():
    """A bf16 hybrid's weights carried across keep the reference's float32
    ``A_log``, ``D`` and ``dt_bias`` (bit for bit); the rest is bf16."""
    jcfg = _hybrid_jcfg("bfloat16")
    jp = JM.init_params(jax.random.PRNGKey(4), jcfg)
    cfg = ModelConfig.from_reference(jcfg)
    p = from_jax_flat(_flatten(jp), cfg, device="cpu")
    mixer = p["p0"]["mixer"]
    for name in ("A_log", "D", "dt_bias"):
        assert mixer[name].dtype == torch.float32, name
        np.testing.assert_array_equal(mixer[name].numpy(),
                                      np.asarray(jp["p0"]["mixer"][name]))
    for name in ("in_proj", "conv_w", "conv_b", "x_proj", "dt_proj",
                 "out_proj"):
        assert mixer[name].dtype == torch.bfloat16, name
    assert p["p1"]["mixer"]["wq"].dtype == torch.bfloat16


def test_init_params_draws_the_reference_mamba_distributions():
    cfg = dataclasses.replace(ModelConfig.from_reference(
        _hybrid_jcfg("bfloat16")), name="mix-init")
    p = M.init_params(cfg, seed=0, device="cpu")
    mixer = p["p0"]["mixer"]
    ds = cfg.mamba_d_state
    assert all(mixer[n].dtype == torch.float32
               for n in ("A_log", "D", "dt_bias"))
    torch.testing.assert_close(
        torch.exp(mixer["A_log"][0]),
        torch.arange(1, ds + 1, dtype=torch.float32).expand(
            cfg.mamba_d_inner, ds))
    assert torch.equal(mixer["D"], torch.ones_like(mixer["D"]))
    dt = torch.nn.functional.softplus(mixer["dt_bias"])
    assert float(dt.min()) >= 1e-4 - 1e-7 and float(dt.max()) <= 0.1 + 1e-6
    # conv taps: truncated normal with the tap count as fan-in
    assert float(mixer["conv_w"].float().abs().max()) <= \
        2.0 / cfg.mamba_d_conv ** 0.5 + 1e-2
    assert cfg.param_count() == JModelConfig.param_count(
        _hybrid_jcfg("bfloat16"))
