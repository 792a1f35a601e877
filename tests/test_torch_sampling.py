"""The port's lossless speculative sampling against the JAX reference, on
the CPU.

``core/prng.py`` draws jax.random's threefry keys and bits, so the port's
sampled tokens are the reference's own, not only alike in distribution:

* ``prng``: ``prng_key``, ``fold_in``, ``split`` (and batched split),
  ``bits`` and ``uniform`` equal ``jax.random`` bit for bit, seeds on both
  sides of 2**31; ``gumbel`` within 1e-6 (``log``'s last bit);
* ``core/verify.py``: ``shape_logits`` (f32 1e-6, bf16 input, per-row
  controls, the same keep-set), ``sample_predictions`` and
  ``sample_token`` give JAX's tokens; temperature 0 is the argmax bit for
  bit; rows share their level's noise, and a tree's ``levels`` map is
  honoured; ``residual_pmf``'s property; ``temperature_sample``;
* sampled ``generate`` against JAX's with the same seed, in every mode
  (five strategies, paged, a (4, 5, 2) tree, the tiny hybrid): the same
  token streams and stats.  A token may differ only where JAX's own top-2
  margin of shaped logits plus noise is below 1e-5 (a tie two
  frameworks' float rounding can flip); each such case is printed;
* the port's own invariants: temperature-0 rows equal the greedy-only
  run, seeds replay, a request alone equals itself inside a batch, eos and
  budget edges, ``accept_hist`` accounting;
* ``ServingEngine`` against JAX's with pinned seeds (static, continuous
  linear and paged), a pinned-greedy engine's rejection, ``submit``
  validation;
* the distribution: the spec walk against the plain sampler
  ``sampling_reference`` (TV and chi-square at B=512, a power control, and
  enough speculation that the check means something).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.common import bench_config
from chip_smoke import DIST_CASES, check_distribution
from repro.core import spec_engine as JE
from repro.core import verify as JV
from repro.models import model as JM
from repro.models.config import BlockSpec as JBlockSpec
from repro.serving.engine import ServingEngine as JServingEngine
from repro.serving.sampling import temperature_sample as j_temperature_sample
from repro.train.checkpoint import _flatten
from repro_torch.core import prng
from repro_torch.core import spec_engine as E
from repro_torch.core import verify as V
from repro_torch.core.ngram_tables import NGramTables
from repro_torch.models import cache as C
from repro_torch.models.config import ModelConfig
from repro_torch.models.weights import from_jax_flat
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.sampling import temperature_sample


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The port's side in one thread: these models are tiny, and the suite
    runs its files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MAX_NEW = 14
MARGIN = 1e-5          # a sampled token may differ only below this margin
SEED = 2**31 + 11      # above 2**31: a sign error in the key shows
TEMP = np.array([0.0, 0.8, 1.2], np.float32)
TOP_P = np.array([1.0, 0.9, 1.0], np.float32)


def _port(jcfg, jparams):
    cfg = ModelConfig.from_reference(jcfg)
    return cfg, from_jax_flat(_flatten(jparams), cfg, device="cpu")


def _port_tables(jt):
    return NGramTables(*(torch.from_numpy(np.array(a)) for a in
                         (jt.unigram_topk, jt.bigram_topk, jt.bigram_chain)))


def _model(jcfg, seed=0):
    """JAX params and tables (XLA backend) and the port's copies."""
    jcfg = dataclasses.replace(jcfg, backend="xla").validate()
    jparams = JM.init_params(jax.random.PRNGKey(seed), jcfg)
    jtables = JServingEngine(jparams, jcfg,
                             JE.SpecConfig(k=4, w=5, backend="xla")).tables
    cfg, params = _port(jcfg, jparams)
    return jcfg, jparams, jtables, cfg, params, _port_tables(jtables)


@pytest.fixture(scope="module")
def tiny(tiny_dense_cfg):
    return _model(dataclasses.replace(tiny_dense_cfg, name="tiny-sampling"))


@pytest.fixture(scope="module")
def hybrid(tiny_hybrid_cfg):
    """tests/conftest.py's tiny hybrid with every MoE FFN made dense."""
    pattern = tuple(JBlockSpec(b.mixer, "swiglu" if b.mlp == "moe"
                               else b.mlp)
                    for b in tiny_hybrid_cfg.block_pattern)
    return _model(dataclasses.replace(
        tiny_hybrid_cfg, name="tiny-hyb-sampling", block_pattern=pattern,
        num_experts=0))


@pytest.fixture(scope="module")
def bench():
    """The byte-vocabulary bench model, for the serving engines."""
    return _model(dataclasses.replace(bench_config(), name="bench-sampling"),
                  seed=2)


def _prompt(seed=1, B=3, P=10, vocab=7):
    """Repetitive prompts over a few tokens, so that context drafts hit."""
    return np.random.default_rng(seed).integers(0, vocab, (B, P)).astype(
        np.int32)


def _jkey(seed):
    return jax.random.PRNGKey(seed)


# ----------------------------------------------------------------------------
# prng
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1, 2**31, 2**31 + 5,
                                  2**32 - 1, 2**32 + 7, -1])
def test_prng_keys_are_jax_random_bit_for_bit(seed):
    jk = _jkey(seed)
    tk = prng.prng_key(seed)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    for d in (0, 1, 12345, 2**31 - 1, 2**31 + 3, 2**32 - 1):
        np.testing.assert_array_equal(prng.fold_in(tk, d).numpy(),
                                      np.asarray(jax.random.fold_in(jk, d)))
    np.testing.assert_array_equal(prng.split(tk).numpy(),
                                  np.asarray(jax.random.split(jk)))
    np.testing.assert_array_equal(prng.split(tk, 5).numpy(),
                                  np.asarray(jax.random.split(jk, 5)))
    jks = jax.random.split(jk, 6)
    np.testing.assert_array_equal(
        prng.split(prng.as_key(np.asarray(jks))).numpy(),
        np.asarray(jax.vmap(jax.random.split)(jks)))
    # per_row_keys: one key folded per row, (B, 2) keys pass through
    np.testing.assert_array_equal(V.per_row_keys(tk, 4).numpy(),
                                  np.asarray(JV.per_row_keys(jk, 4)))
    np.testing.assert_array_equal(V.per_row_keys(np.asarray(jks), 6).numpy(),
                                  np.asarray(jks))


@pytest.mark.parametrize("V_", [259, 100352])
def test_prng_bits_uniform_gumbel_match_jax(V_):
    jk = _jkey(SEED)
    tk = prng.prng_key(SEED)
    np.testing.assert_array_equal(prng.random_bits32(tk, (V_,)).numpy(),
                                  np.asarray(jax.random.bits(jk, (V_,))))
    np.testing.assert_array_equal(prng.random_bits32(tk, (3, 7)).numpy(),
                                  np.asarray(jax.random.bits(jk, (3, 7))))
    np.testing.assert_array_equal(prng.uniform(tk, (V_,)).numpy(),
                                  np.asarray(jax.random.uniform(jk, (V_,))))
    g = prng.gumbel(tk, (V_,)).numpy()
    jg = np.asarray(jax.random.gumbel(jk, (V_,)))
    np.testing.assert_allclose(g, jg, rtol=0, atol=1e-6)
    # batched keys: the reference's vmap over per-level keys
    jks = jax.random.split(jk, 3)
    np.testing.assert_allclose(
        prng.gumbel(prng.as_key(np.asarray(jks)), (2, 259)).numpy(),
        np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (2, 259)))(jks)),
        rtol=0, atol=1e-6)


# ----------------------------------------------------------------------------
# core/verify.py and serving/sampling.py
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("controls", ["per-row", "scalar", "no-top-p"])
def test_shape_logits_matches_jax(dtype, controls):
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 2, 4, 259)).astype(np.float32) * 3
    t, p = {"per-row": (np.array([0.0, 0.7, 1.3], np.float32),
                        np.array([1.0, 0.9, 0.5], np.float32)),
            "scalar": (0.8, 0.95),
            "no-top-p": (np.array([0.5, 1.0, 2.0], np.float32), None)}[
        controls]
    tl = torch.from_numpy(logits).to(getattr(torch, dtype))
    jl = jnp.asarray(logits).astype(getattr(jnp, dtype))
    got = V.shape_logits(tl, t if np.isscalar(t) else torch.from_numpy(t),
                         p if p is None or np.isscalar(p)
                         else torch.from_numpy(p))
    want = np.asarray(JV.shape_logits(jl, t if np.isscalar(t)
                                      else jnp.asarray(t),
                                      p if p is None or np.isscalar(p)
                                      else jnp.asarray(p)))
    assert got.dtype == torch.float32
    got = got.numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6, atol=1e-6)
    if p is not None:
        assert np.isneginf(want).any()          # the keep-set bites


def test_shape_logits_edges():
    # f16 logits over a tiny temperature: finite f32, ordering kept
    s = V.shape_logits(torch.tensor([[400.0, 300.0, -50.0]],
                                    dtype=torch.float16), 1e-3)
    assert s.dtype == torch.float32 and torch.isfinite(s).all()
    assert int(s.argmax()) == 0
    probs = torch.tensor([[0.5, 0.3, 0.15, 0.05]])
    kept = V.shape_logits(probs.log(), 1.0, 0.75)[0]
    assert torch.isfinite(kept[:2]).all() and torch.isneginf(kept[2:]).all()
    assert torch.isfinite(V.shape_logits(probs.log(), 1.0, 1.0)).all()
    top1 = V.shape_logits(torch.tensor([[0.9, 0.06, 0.04]]).log(), 1.0,
                          1e-6)[0]
    assert torch.isfinite(top1[0]) and torch.isneginf(top1[1:]).all()


@pytest.mark.parametrize("levels", [None, [0, 0, 1, 2]], ids=["linear",
                                                              "tree"])
def test_sample_predictions_and_token_match_jax(levels):
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((4, 3, 4, 61)).astype(np.float32) * 2
    t = np.array([0.0, 0.6, 1.0, 1.5], np.float32)
    p = np.array([1.0, 0.8, 1.0, 0.95], np.float32)
    jkeys = JV.per_row_keys(_jkey(SEED), 4)
    tkeys = V.per_row_keys(prng.prng_key(SEED), 4)
    lv = None if levels is None else np.asarray(levels)
    got = V.sample_predictions(torch.from_numpy(logits), tkeys,
                               torch.from_numpy(t), torch.from_numpy(p),
                               levels=lv).numpy()
    want = np.asarray(JV.sample_predictions(
        jnp.asarray(logits), jkeys, jnp.asarray(t), jnp.asarray(p),
        levels=lv))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0], logits[0].argmax(-1))   # t = 0
    tok = V.sample_token(torch.from_numpy(logits[:, 0, 0]), tkeys,
                         torch.from_numpy(t), torch.from_numpy(p)).numpy()
    np.testing.assert_array_equal(tok, np.asarray(JV.sample_token(
        jnp.asarray(logits[:, 0, 0]), jkeys, jnp.asarray(t),
        jnp.asarray(p))))
    assert tok.dtype == np.int32 and tok[0] == logits[0, 0, 0].argmax()


def test_rows_share_their_levels_noise():
    g = torch.Generator().manual_seed(2)
    row = torch.randn((1, 1, 4, 32), generator=g)
    keys = V.per_row_keys(prng.prng_key(7), 1)
    one = torch.ones((1,))
    preds = V.sample_predictions(torch.cat([row, row], dim=1), keys,
                                 one * 1.5, one)
    assert torch.equal(preds[:, 0], preds[:, 1])       # one trajectory
    # fresh noise per level: equal logits at every level do not collapse
    flat = row[:, :, :1].expand(row.shape)
    assert len(set(V.sample_predictions(flat, keys, one * 3.0,
                                        one)[0, 0].tolist())) > 1
    # a tree's levels map: same-level positions share noise; t = 0 argmax
    tree = row[:, :, :1].expand(1, 1, 3, 32)
    lv = np.asarray([0, 0, 1])
    p = V.sample_predictions(tree, keys, one * 2.0, one, levels=lv)
    assert p[0, 0, 0] == p[0, 0, 1]
    assert torch.equal(V.sample_predictions(tree, keys, one * 0, one,
                                            levels=lv),
                       tree.argmax(-1).to(torch.int32))


def test_residual_pmf():
    from hypothesis import given, settings
    from hypothesis import strategies as st
    res = V.residual_pmf(torch.tensor([[0.5, 0.3, 0.2]]),
                         torch.tensor([0]))[0]
    assert res[0] == 0.0 and abs(float(res.sum()) - 1.0) < 1e-6
    np.testing.assert_allclose(float(res[1] / res[2]), 1.5, rtol=1e-5)

    @settings(max_examples=50, deadline=None)
    @given(st.integers(2, 12).flatmap(lambda v: st.tuples(
        st.lists(st.floats(-3, 3), min_size=v, max_size=v),
        st.integers(0, v - 1))))
    def check(case):
        logits, rejected = case
        probs = torch.softmax(torch.tensor(logits, dtype=torch.float32), -1)
        r = V.residual_pmf(probs[None], torch.tensor([rejected]))[0].numpy()
        assert r[rejected] == 0.0 and (r >= 0).all()
        np.testing.assert_allclose(r.sum(), 1.0, rtol=1e-5)
        p = probs.numpy()
        keep = np.arange(len(p)) != rejected
        np.testing.assert_allclose(r[keep], p[keep] / (1.0 - p[rejected]),
                                   rtol=1e-4)

    check()
    probs = np.random.default_rng(4).dirichlet(np.ones(16), size=5).astype(
        np.float32)
    rej = np.arange(5)
    np.testing.assert_allclose(
        V.residual_pmf(torch.from_numpy(probs), torch.from_numpy(rej)),
        np.asarray(JV.residual_pmf(jnp.asarray(probs), jnp.asarray(rej))),
        rtol=1e-6, atol=1e-7)


def test_temperature_sample():
    with pytest.raises(ValueError, match="temperature"):
        temperature_sample(prng.prng_key(0), torch.zeros((2, 8)),
                           temperature=-0.5)
    logits = torch.randn((3, 16), generator=torch.Generator().manual_seed(1))
    assert torch.equal(temperature_sample(prng.prng_key(0), logits, 0.0),
                       logits.argmax(-1).to(torch.int32))
    # f16 over 1e-3 overflows half precision; the upcast keeps the argmax
    half = torch.tensor([[400.0, 500.0, -10.0]] * 8, dtype=torch.float16)
    assert (temperature_sample(prng.prng_key(2), half, 1e-3) == 1).all()
    # a small top_p keeps only the top token
    probs = torch.tensor([[0.5, 0.3, 0.2]] * 16).log()
    assert (temperature_sample(prng.prng_key(3), probs, 1.0, 0.4) == 0).all()
    # the reference's draw on the same key
    for t, p in ((0.9, 1.0), (1.3, 0.7)):
        np.testing.assert_array_equal(
            temperature_sample(prng.prng_key(SEED), logits, t, p).numpy(),
            np.asarray(j_temperature_sample(_jkey(SEED),
                                            jnp.asarray(logits.numpy()),
                                            t, p)))


# ----------------------------------------------------------------------------
# sampled generate against JAX's
# ----------------------------------------------------------------------------
def _step_lens(params, cfg, spec, prompt, tables, **kw):
    """The port's buf_len before every step of a generate run (the
    reference's too, up to a row's first differing token: a row's steps
    depend on its own tokens only)."""
    s = E.init_decode_state(params, cfg, spec, torch.as_tensor(prompt),
                            **kw)
    lens = []
    while bool(((~s.done) & (s.buf_len - s.prompt_len < s.budget)).any()):
        lens.append(s.buf_len.clone().numpy())
        s = E.spec_step(params, cfg, spec, s, tables)
    return np.array(lens)


def _jax_margins(model, prompt, jbuf, row, positions, temp, top_p, lens):
    """For each position of ``row``: JAX's own top-2 margin of shaped
    logits plus noise, with the key and level the reference's schedule
    gives the token there, and the argmax (the token JAX drew).  ``lens``:
    the row's buf_len before each step; the step that commits a position
    starts at or before it, and its noise level is position - start.  One
    causal forward over the row gives every position's logits."""
    jcfg, jparams = model[0], model[1]
    P = prompt.shape[1]
    key = JV.per_row_keys(_jkey(SEED), prompt.shape[0])[row]
    first, carry = jax.random.split(key)         # the prefill's draw
    draws = {P: (first, 0)}
    ends = list(lens[1:, row]) + [max(positions) + 1]
    for start, end in zip(lens[:, row], ends):
        use, carry = jax.random.split(carry)
        draws.update({q: (use, q - int(start)) for q in range(start, end)})
    row_buf = jnp.asarray(np.asarray(jbuf)[row:row + 1, :max(positions)])
    logits = JM.forward(jparams, jcfg, tokens=row_buf)[0][0]
    out = []
    for pos in positions:
        use, level = draws[pos]
        shaped = JV.shape_logits(logits[pos - 1][None], temp[row],
                                 top_p[row])[0]
        z = np.asarray(shaped + jax.random.gumbel(
            jax.random.fold_in(use, level), shaped.shape))
        top = np.sort(z)[::-1]
        out.append((float(top[0] - top[1]), int(z.argmax())))
    return out


def _hold_streams(model, prompt, buf, jbuf, temp, top_p, lens_fn):
    """Equal token streams, or a first difference at a JAX margin below
    MARGIN (printed).  Returns the rows that are equal throughout."""
    n = buf.shape[1]
    P = prompt.shape[1]
    same = []
    for b in range(buf.shape[0]):
        diff = np.nonzero(buf[b, P:n] != np.asarray(jbuf)[b, P:n])[0]
        if not len(diff):
            same.append(b)
            continue
        pos = P + int(diff[0])
        (margin, tok), = _jax_margins(model, prompt, jbuf, b, [pos], temp,
                                      top_p, lens_fn())
        print(f"row {b}: first difference at position {pos}, JAX's top-2 "
              f"margin there {margin:.3g} (1 of {buf.shape[0]} rows)")
        assert tok == int(np.asarray(jbuf)[b, pos])
        assert margin < MARGIN, (b, pos, margin)
    return same


STATS = ("calls", "tokens", "accept_hist", "rank_hist", "alloc_ctx",
         "accepted_ctx", "accepted_bigram")


def _generate_both(model, kw, paged=False):
    """Sampled generate of the port and of JAX on ``_prompt()`` with per-row
    controls TEMP/TOP_P and the key SEED: the same streams (up to a
    printed tie) and stats; returns the port's stats, JAX's buffer and a
    function giving the port's per-step buf_len."""
    jcfg, jparams, jtables, cfg, params, tables = model
    prompt = _prompt()
    spec = E.SpecConfig(sampling=True, max_new_tokens=MAX_NEW, **kw)
    jspec = JE.SpecConfig(sampling=True, max_new_tokens=MAX_NEW,
                          backend="xla", **kw)
    samp = dict(temperature=TEMP, top_p=TOP_P)
    pg = E.PagedConfig(page_size=8) if paged else None
    buf, blen, stats = E.generate(params, cfg, spec, prompt, tables,
                                  paged=pg, device="cpu",
                                  rng=prng.prng_key(SEED), **samp)
    jbuf, jblen, jstats = JE.generate(
        jparams, jcfg, jspec, jnp.asarray(prompt), jtables,
        paged=JE.PagedConfig(page_size=8) if paged else None,
        rng=_jkey(SEED), **{k: jnp.asarray(v) for k, v in samp.items()})
    n = prompt.shape[1] + MAX_NEW
    lens_fn = lambda: _step_lens(params, cfg, spec, prompt, tables,
                                 paged=pg, rng=prng.prng_key(SEED), **samp)
    same = _hold_streams(model, prompt, buf[:, :n].numpy(), jbuf[:, :n],
                         TEMP, TOP_P, lens_fn)
    for b in same:
        assert int(blen[b]) == int(jblen[b])
        for key in STATS:
            np.testing.assert_array_equal(stats[key][b].numpy(),
                                          np.asarray(jstats[key])[b],
                                          err_msg=key)
    # the greedy row is greedy decoding
    ref = E.greedy_reference(params, cfg, prompt[:1], MAX_NEW, device="cpu")
    np.testing.assert_array_equal(buf[:1, :n].numpy(), ref.numpy())
    return stats, jbuf, lens_fn


@pytest.mark.parametrize("mode", ["mixed", "context", "bigram", "unigram",
                                  "greedy", "mixed-paged", "tree"])
def test_sampled_generate_matches_jax(tiny, mode):
    kw = dict(k=4, w=3, strategy=mode.split("-")[0])
    if mode == "tree":
        kw = dict(k=4, w=5, strategy="mixed", tree=True, tree_branch=2)
    stats, jbuf, lens_fn = _generate_both(tiny, kw,
                                          paged=mode.endswith("paged"))
    hist, calls = stats["accept_hist"].numpy(), stats["calls"].numpy()
    assert (hist[:, 0] == 0).all() and (hist.sum(1) == calls).all()
    if mode == "mixed":
        # the key-and-level reconstruction behind the excuse above, where
        # the frameworks agree: JAX's shaped logits plus its noise pick the
        # token JAX committed, also at steps that accepted drafted tokens
        lens, P = lens_fn(), _prompt().shape[1]
        for b in (1, 2):
            pos = list(range(P, P + MAX_NEW))
            for p, (margin, tok) in zip(pos, _jax_margins(
                    tiny, _prompt(), jbuf, b, pos, TEMP, TOP_P, lens)):
                assert tok == int(np.asarray(jbuf)[b, p]) and margin > 0, p
        assert (np.diff(lens[:, 1:], axis=0) > 1).any()


def test_sampled_generate_matches_jax_hybrid(hybrid):
    _generate_both(hybrid, dict(k=4, w=3, strategy="mixed"))


# ----------------------------------------------------------------------------
# invariants of the port
# ----------------------------------------------------------------------------
def test_greedy_rows_replay_and_rows_alone(tiny):
    _, _, _, cfg, params, tables = tiny
    prompt = _prompt()
    P, n = prompt.shape[1], prompt.shape[1] + MAX_NEW
    spec = E.SpecConfig(k=4, w=3, max_new_tokens=MAX_NEW)
    sspec = dataclasses.replace(spec, sampling=True)
    temp = np.array([0.0, 0.9, 0.0], np.float32)
    run = lambda seed, **kw: E.generate(
        params, cfg, sspec, prompt, tables, device="cpu", temperature=temp,
        rng=prng.prng_key(seed), **kw)[0][:, :n]
    greedy = E.generate(params, cfg, spec, prompt, tables,
                        device="cpu")[0][:, :n]
    a, b, c = run(SEED), run(SEED), run(SEED + 1)
    assert torch.equal(a[[0, 2]], greedy[[0, 2]])      # t = 0 rows
    assert torch.equal(a, b)                           # the seed replays
    assert not torch.equal(a[1], c[1])                 # a new seed varies
    # the sampled row alone, with its own key, equals itself in the batch
    key = V.per_row_keys(prng.prng_key(SEED), 3)[1:2]
    alone = E.generate(params, cfg, sspec, prompt[1:2], tables,
                       device="cpu", temperature=0.9, rng=key)[0][:, :n]
    assert torch.equal(alone[0], a[1])
    assert not torch.equal(a[1, P:], greedy[1, P:])


def test_sampling_arguments_need_the_flag(tiny):
    _, _, _, cfg, params, tables = tiny
    spec = E.SpecConfig(k=4, w=3, max_new_tokens=4)
    for kw in (dict(temperature=0.7), dict(top_p=0.9),
               dict(rng=prng.prng_key(0))):
        with pytest.raises(ValueError, match="sampling"):
            E.init_decode_state(params, cfg, spec,
                                torch.as_tensor(_prompt()), **kw)
        with pytest.raises(ValueError, match="sampling"):
            E.generate(params, cfg, spec, _prompt(), tables, device="cpu",
                       **kw)


@pytest.mark.parametrize("strategy", ["mixed", "greedy"])
@pytest.mark.parametrize("temp", [0.0, 0.9], ids=["greedy-t", "sampled-t"])
def test_accept_hist_accounts_every_call(tiny, strategy, temp):
    _, _, _, cfg, params, tables = tiny
    spec = E.SpecConfig(k=4, w=3, strategy=strategy, max_new_tokens=12,
                        sampling=True)
    _, _, stats = E.generate(params, cfg, spec, _prompt(), tables,
                             device="cpu", temperature=temp,
                             rng=prng.prng_key(3))
    hist, calls = stats["accept_hist"].numpy(), stats["calls"].numpy()
    assert (hist[:, 0] == 0).all() and (calls > 0).all()
    np.testing.assert_array_equal(hist.sum(axis=1), calls)
    if strategy == "greedy":
        np.testing.assert_array_equal(hist[:, 1], calls)


def test_eos_exactly_at_budget_does_not_overshoot(tiny):
    _, _, _, cfg, params, tables = tiny
    prompt = _prompt(B=1)
    P = prompt.shape[1]
    ref = E.greedy_reference(params, cfg, prompt, 12, device="cpu").numpy()
    for budget in (1, 2, 3, 5, 8):
        eos = int(ref[0, P + budget - 1])
        first = int(np.argmax(ref[0, P:P + 12] == eos))
        spec = E.SpecConfig(k=4, w=3, max_new_tokens=budget, sampling=True)
        buf, blen, _ = E.generate(params, cfg, spec, prompt, tables,
                                  device="cpu", temperature=0.0,
                                  rng=prng.prng_key(7),
                                  eos_id=torch.tensor([eos]))
        got = int(blen[0]) - P
        assert got == min(first + 1, budget), (budget, eos, got)
        np.testing.assert_array_equal(buf[0, P:P + got].numpy(),
                                      ref[0, P:P + got])


def test_sampled_eos_mid_stream_stops_once(tiny):
    _, _, _, cfg, params, tables = tiny
    prompt = _prompt(B=4)
    P, N = prompt.shape[1], 16
    spec = E.SpecConfig(k=4, w=3, max_new_tokens=N, sampling=True)
    run = lambda **kw: E.generate(params, cfg, spec, prompt, tables,
                                  device="cpu", temperature=0.9,
                                  rng=prng.prng_key(21), **kw)
    free = run()[0].numpy()
    eos = free[:, P + 5].astype(np.int32)
    buf, blen, _ = run(eos_id=torch.as_tensor(eos))
    for b in range(4):
        got = int(blen[b]) - P
        first = int(np.argmax(free[b, P:P + N] == eos[b]))
        assert got == first + 1 <= N, (b, got, first)
        np.testing.assert_array_equal(buf[b, P:P + got].numpy(),
                                      free[b, P:P + got])
        assert int(buf[b, P + got - 1]) == int(eos[b])


# ----------------------------------------------------------------------------
# ServingEngine against JAX's
# ----------------------------------------------------------------------------
def _engines(model, paged=False, **kw):
    jcfg, jparams, jtables, cfg, params, tables = model
    common = dict(max_batch=3, buckets=(16,), max_new_cap=14,
                  paged=paged, num_pages=9 if paged else None, page_size=8,
                  **kw)
    spec = dict(k=4, w=3, strategy="mixed")
    return (JServingEngine(jparams, jcfg, JE.SpecConfig(backend="xla", **spec),
                           tables=jtables, **common),
            ServingEngine(params, cfg, E.SpecConfig(**spec), tables=tables,
                          device="cpu", **common))


def _mixed_traffic(static):
    """Six requests, every other one sampled with a pinned seed (the
    request ids differ between the two packages' counters); one budget
    when static, so that every batch has one shape."""
    out = []
    for i in range(6):
        kw = (dict(temperature=(0.8, 1.1)[i % 4 // 2], top_p=(1.0, 0.9)[
            i % 4 // 2], seed=SEED + i) if i % 2 else {})
        out.append((f"def f{i}(x): return x * {i} + 1"[:14],
                    10 if static else (6, 10, 14)[i % 3], kw))
    return out


def _serve(eng, work, static=False):
    for text, mnt, kw in work:
        eng.submit(text, max_new_tokens=mnt, **kw)
    done = eng.serve_all() if static else eng.serve_continuous()
    return sorted(done, key=lambda r: r.request_id)


def _same_requests(done, jdone, work):
    assert len(done) == len(jdone) == len(work)
    for r, jr in zip(done, jdone):
        assert "error" not in r.stats
        np.testing.assert_array_equal(r.output_ids, jr.output_ids)
        for key in ("new_tokens", "model_calls", "accept_hist"):
            assert r.stats[key] == jr.stats[key], key


@pytest.mark.parametrize("mode", ["static", "linear", "paged"])
def test_engine_serves_mixed_traffic_like_jax(bench, mode):
    work = _mixed_traffic(mode == "static")
    jeng, eng = _engines(bench, paged=mode == "paged")
    done = _serve(eng, work, static=mode == "static")
    _same_requests(done, _serve(jeng, work, static=mode == "static"), work)
    assert [r.stats["new_tokens"] for r in done] == [m for _, m, _ in work]
    if mode != "static":
        assert eng.sampling is True          # resolved from the queue
    if mode == "paged":
        st = eng.pool_stats()
        assert st["rejected"] == 0 and st["free_pages"] == 9
        C.check_page_invariants(eng._cont_state.model)
    # a fresh engine replays every request; the greedy rows are greedy
    _, eng2 = _engines(bench, paged=mode == "paged")
    for a, b in zip(done, _serve(eng2, work, static=mode == "static")):
        np.testing.assert_array_equal(a.output_ids, b.output_ids)
    cfg, params = bench[3], bench[4]
    for r, (_, mnt, kw) in zip(done, work):
        if kw:
            continue
        toks = eng.scheduler.pad_to_bucket(eng.tok.encode(r.prompt))
        ref = E.greedy_reference(params, cfg, toks[None], mnt, device="cpu")
        np.testing.assert_array_equal(r.output_ids, ref[0, len(toks):])


def test_engine_default_keys_match_jax(bench):
    """Unpinned requests: fold_in(engine seed key, request_id), as JAX's
    engine derives them (given the same request ids)."""
    jeng, eng = _engines(bench, seed=2**31 + 3)
    for rid in (0, 5, 2**31 + 1):
        req = eng.submit("x", temperature=0.5)
        req.request_id = rid
        jreq = jeng.submit("x", temperature=0.5)
        jreq.request_id = rid
        np.testing.assert_array_equal(eng._req_key(req).numpy(),
                                      np.asarray(jeng._req_key(jreq)))
    pinned = eng.submit("x", temperature=0.5, seed=9)
    np.testing.assert_array_equal(eng._req_key(pinned).numpy(),
                                  np.asarray(_jkey(9)))


def test_pinned_greedy_engine_rejects_sampled_admission(bench):
    _, eng = _engines(bench, sampling=False)
    ok = eng.submit("greedy fine", max_new_tokens=8)
    bad = eng.submit("sampled not", max_new_tokens=8, temperature=0.7)
    with pytest.warns(UserWarning, match="rejected"):
        done = {r.request_id: r for r in eng.serve_continuous()}
    assert done[ok.request_id].stats["new_tokens"] == 8
    assert "sampling" in done[bad.request_id].stats["error"]


def test_submit_validation(bench):
    _, eng = _engines(bench)
    with pytest.raises(ValueError, match="temperature"):
        eng.submit("x", temperature=-0.1)
    for p in (0.0, 1.5):
        with pytest.raises(ValueError, match="top_p"):
            eng.submit("x", top_p=p)


# ----------------------------------------------------------------------------
# the distribution: spec walk against the plain sampler
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("temp,topp", DIST_CASES, ids=["t0.9", "t1.2-p0.8"])
def test_spec_sampling_matches_plain_distribution(temp, topp):
    """The reference's test_spec_sampling_matches_plain_distribution on the
    port (``chip_smoke.check_distribution``, which phase 8d runs on the
    card): B=512 rows, each position's marginal of the spec walk against
    ``sampling_reference`` (TV < 0.18 and the chi-square limit), a
    0.3-temperature control told apart (TV > 0.25), and more than 10% of
    calls committing more than one token.  It raises on a miss."""
    out = check_distribution("cpu", temp, topp)
    print(out)
    assert out["tv"] < 0.18 and out["power_tv"] > 0.25
