"""The port's in-flight adaptive (k, w) arms against the JAX reference, on
the CPU.

* ``core/phase.py``: ``verify_call_cost`` and ``slowdown`` equal the
  reference's (rel 1e-12) once the port's H100 constants are patched to the
  reference's; with the H100's own constants the reference's shape facts
  still hold (decode memory-bound, monotone cost, a compute-bound
  transition).
* ``core/controller.py``: ``init_arm_stats``, ``choose_arms`` and
  ``update_arm_stats`` over planted (B, A) stats equal JAX's (chosen arms,
  pulls and last arm bit for bit, rewards at f32 1e-6), ``AdaptiveKW``
  chooses JAX's arms; the reference's controller behaviours (every arm
  explored first, convergence to a planted arm, no leak across slots, a
  reset on slot reuse).
* Arm masking: for ``ARMS`` inside a (4, 3) box and the bigram, unigram,
  context and mixed strategies, a masked run equals a dedicated run of the
  arm (``generate``, the continuous ``admit_slot``/``spec_step`` drive,
  paged); tree arms likewise; multi-arm runs equal ``greedy_reference``.
* Against JAX's masked runs (one JAX run per case, built once per module):
  tokens and stats of multi-arm ``generate`` (linear, paged, tree, the tiny
  hybrid, sampled rows with pinned seeds), and ``ServingEngine(adaptive=
  True)`` static (JAX's arm sequence) and continuous (per-request
  ``arm_pulls``, ``adaptive_stats()``), linear and paged.
* One step for every arm: a continuous adaptive run keeps every state
  tensor's shape and drafts once per distinct arm depth in every step.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.common import bench_config
from repro.configs import get_config as j_get_config
from repro.configs import get_smoke_config as j_get_smoke_config
from repro.core import controller as JC
from repro.core import phase as JP
from repro.core import spec_engine as JE
from repro.models import model as JM
from repro.models.config import BlockSpec as JBlockSpec
from repro.serving.engine import ServingEngine as JServingEngine
from repro.train.checkpoint import _flatten
from repro_torch.configs import get_smoke_config
from repro_torch.configs.jamba_1_5_large_398b import no_experts
from repro_torch.core import controller as PC
from repro_torch.core import phase as P
from repro_torch.core import spec_engine as E
from repro_torch.core import tree as T
from repro_torch.core.ngram_tables import NGramTables
from repro_torch.kernels import dispatch
from repro_torch.models import cache as C
from repro_torch.models.config import ModelConfig
from repro_torch.models.weights import from_jax_flat
from repro_torch.serving.engine import ServingEngine


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The port's side in one thread: these models are tiny, and the suite
    runs its files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the masked box is (K_MAX, W_MAX); every arm is strictly inside it on at
# least one axis, so masking (not shape equality) is what is tested
K_MAX, W_MAX = 4, 3
ARMS = ((1, 0), (2, 2), (3, 1), (4, 3))
TREE_ARMS = ((1, 0), (2, 2), (3, 4))
N_NEW = 20
STRATEGIES = ("bigram", "unigram", "context", "mixed")
arm_id = lambda a: f"k{a[0]}w{a[1]}"


def _port_tables(jt):
    return NGramTables(*(torch.from_numpy(np.array(a)) for a in
                         (jt.unigram_topk, jt.bigram_topk, jt.bigram_chain)))


def _model(jcfg, seed=0):
    """JAX params and tables (XLA backend) and the port's copies."""
    jcfg = dataclasses.replace(jcfg, backend="xla").validate()
    jparams = JM.init_params(jax.random.PRNGKey(seed), jcfg)
    jtables = JServingEngine(jparams, jcfg,
                             JE.SpecConfig(k=4, w=5, backend="xla")).tables
    cfg = ModelConfig.from_reference(jcfg)
    params = from_jax_flat(_flatten(jparams), cfg, device="cpu")
    return jcfg, jparams, jtables, cfg, params, _port_tables(jtables)


@pytest.fixture(scope="module")
def tiny(tiny_dense_cfg):
    return _model(dataclasses.replace(tiny_dense_cfg, name="tiny-adaptive"))


@pytest.fixture(scope="module")
def hybrid():
    """The reference's jamba smoke config cut as the port's ``no_experts``
    cuts it (one period, every MoE FFN the dense SwiGLU)."""
    jcfg = j_get_smoke_config("jamba-1.5-large-398b")
    pattern = tuple(JBlockSpec(b.mixer, "swiglu" if b.mlp == "moe"
                               else b.mlp) for b in jcfg.block_pattern)
    jcfg = dataclasses.replace(jcfg, name="jamba-smoke-adaptive",
                               block_pattern=pattern, num_experts=0,
                               num_layers=len(pattern))
    out = _model(jcfg)
    want = no_experts(get_smoke_config("jamba-1.5-large-398b"))
    assert dataclasses.replace(out[3], name=want.name) == want
    return out


@pytest.fixture(scope="module")
def bench():
    """The byte-vocabulary bench model, for the serving engines."""
    return _model(dataclasses.replace(bench_config(), name="bench-adaptive"),
                  seed=2)


def _prompt(seed=1, B=2, P=10, vocab=7):
    """Repetitive prompts over a few tokens, so that context drafts hit."""
    return np.random.default_rng(seed).integers(0, vocab, (B, P)).astype(
        np.int32)


# ----------------------------------------------------------------------------
# the phase model
# ----------------------------------------------------------------------------
def _phase_cfgs():
    tiny = j_get_smoke_config("stablelm-1.6b")
    return {"tiny-dense": dataclasses.replace(
                tiny, name="t", num_layers=2, d_model=64, num_heads=4,
                num_kv_heads=2, d_ff=128, vocab_size=61),
            "stablelm-smoke": tiny,
            "hybrid-smoke": j_get_smoke_config("jamba-1.5-large-398b")}


@pytest.mark.parametrize("name", list(_phase_cfgs()))
def test_phase_model_matches_jax(name, monkeypatch):
    """The same roofline arithmetic as the reference's, MoE terms included:
    with the reference's constants patched in, every cost and slowdown is
    the reference's to 1e-12."""
    monkeypatch.setattr(P, "PEAK_FLOPS", JP.PEAK_FLOPS)
    monkeypatch.setattr(P, "HBM_BW", JP.HBM_BW)
    jcfg = _phase_cfgs()[name]
    cfg = ModelConfig.from_reference(jcfg)
    assert cfg.expert_d_ff == jcfg.expert_d_ff
    for ell in (25, 512, 32768):
        for k, w in ((1, 0), (2, 1), (5, 4), (10, 10), (25, 2), (32, 15)):
            for shared in (True, False):
                a = P.verify_call_cost(cfg, ell, k, w, shared)
                b = JP.verify_call_cost(jcfg, ell, k, w, shared)
                np.testing.assert_allclose(
                    [a.flops, a.hbm_bytes, a.time],
                    [b.flops, b.hbm_bytes, b.time], rtol=1e-12)
                assert a.compute_bound == b.compute_bound
                np.testing.assert_allclose(
                    P.slowdown(cfg, ell, k, w, shared),
                    JP.slowdown(jcfg, ell, k, w, shared), rtol=1e-12)
    c = P.CallCost(10.0, 4.0) * 2 + P.CallCost(10.0, 4.0)
    assert (c.flops, c.hbm_bytes) == (30.0, 12.0)


def test_phase_shape_facts_on_the_h100():
    """The reference's tests/test_phase.py facts hold with the H100's own
    constants (Mistral-7B, the paper's model)."""
    assert (P.PEAK_FLOPS, P.HBM_BW) == (989e12, 3.35e12)
    cfg = ModelConfig.from_reference(j_get_config("mistral-7b"))
    assert not P.verify_call_cost(cfg, 512, 1, 0).compute_bound
    assert P.slowdown(cfg, 500, 1, 0) == pytest.approx(1.0)
    assert 1.0 <= P.slowdown(cfg, 500, 5, 4) <= P.slowdown(cfg, 500, 25, 14)
    assert P.slowdown(cfg, 500, 2, 1) < 1.2            # the free region
    assert P.slowdown(cfg, 25, 32, 15) > 1.5           # compute-bound
    assert P.verify_call_cost(cfg, 25, 32, 15).compute_bound
    assert (P.slowdown(cfg, 32768, 10, 10, shared_cache=False)
            > 1.2 * P.slowdown(cfg, 32768, 10, 10, shared_cache=True))


# ----------------------------------------------------------------------------
# the controller
# ----------------------------------------------------------------------------
def _jstats(st):
    return {k: jnp.asarray(v.numpy()) for k, v in st.items()}


def _best_exploit(c):
    """The host bandit's best arm by acceptance over slowdown alone."""
    return max(c.arms, key=lambda a: (c.stats[a].tpc if c.stats[a].pulls
                                      else 0.0) / c.slow[a])


def test_controller_constants_are_the_references_defaults():
    """The port fixes what the reference's SpecConfig leaves tunable."""
    assert (PC.EXPLORE, PC.EMA, PC.ELL) == (
        JE.SpecConfig.adapt_explore, JE.SpecConfig.adapt_ema,
        JE.SpecConfig.adapt_ell)


def _same_stats(st, jst):
    for key in ("arm_pulls", "arm_last"):
        np.testing.assert_array_equal(st[key].numpy(), np.asarray(jst[key]),
                                      err_msg=key)
    np.testing.assert_allclose(st["arm_reward"].numpy(),
                               np.asarray(jst["arm_reward"]), rtol=1e-6)


def test_init_arm_stats_matches_jax():
    st, jst = PC.init_arm_stats(3, 5), JC.init_arm_stats(3, 5)
    assert set(st) == set(jst) == set(PC.ARM_STAT_KEYS)
    for key in st:
        assert st[key].shape == jst[key].shape
        assert str(st[key].dtype)[6:] == str(jst[key].dtype)
    _same_stats(st, jst)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_vectorised_bandit_matches_jax(tiny, seed):
    """From planted stats (random pulls and EMA rewards, some arms never
    pulled), 60 rounds of choose -> reward -> update on a random active
    set: every choice and the stats equal the reference's."""
    cfg, jcfg = tiny[3], tiny[0]
    rng = np.random.default_rng(seed)
    B, A = 6, len(JC.DEFAULT_ARMS)
    slow = PC.arm_slowdowns(cfg, JC.DEFAULT_ARMS)
    np.testing.assert_array_equal(
        np.float32(slow), np.float32(JC.arm_slowdowns(jcfg, JC.DEFAULT_ARMS)))
    pulls = rng.integers(0, 6, (B, A)) * (rng.random((B, A)) < 0.7)
    st = {"arm_pulls": torch.tensor(pulls, dtype=torch.int32),
          "arm_reward": torch.tensor(
              np.where(pulls > 0, rng.uniform(1, 8, (B, A)), 0),
              dtype=torch.float32),
          "arm_last": torch.tensor(rng.integers(0, A, B), dtype=torch.int32)}
    jst = _jstats(st)
    for _ in range(60):
        arm = PC.choose_arms(st, slow)
        jarm = JC.choose_arms(jst, slow, 0.3)
        np.testing.assert_array_equal(arm.numpy(), np.asarray(jarm))
        reward = rng.integers(1, 12, B).astype(np.int32)
        active = rng.random(B) < 0.8
        st = PC.update_arm_stats(st, arm, torch.from_numpy(reward),
                                 torch.from_numpy(active))
        jst = JC.update_arm_stats(jst, jarm, jnp.asarray(reward),
                                  jnp.asarray(active), 0.9)
        _same_stats(st, jst)


def test_host_controller_matches_jax(tiny):
    """``AdaptiveKW`` (one arm a batch): the same prior and the same arms
    as the reference's over a seeded reward stream."""
    cfg, jcfg = tiny[3], tiny[0]
    c, jc = PC.AdaptiveKW(cfg), JC.AdaptiveKW(jcfg)
    for a in c.arms:
        np.testing.assert_allclose(c.slow[a], jc.slow[a], rtol=1e-12)
    rng = np.random.default_rng(0)
    for _ in range(40):
        a = c.choose()
        assert a == jc.choose()
        tok = float(rng.integers(10, 40))
        c.update(a, tokens=tok, calls=10.0)
        jc.update(a, tokens=tok, calls=10.0)
    for a in c.arms:
        s, js = c.stats[a], jc.stats[a]
        assert (s.tokens, s.calls, s.pulls) == (js.tokens, js.calls, js.pulls)
    assert _best_exploit(c) == jc.best_exploit()


def test_controller_explores_every_arm_then_converges(tiny, monkeypatch):
    """The reference's tests/test_controller.py behaviours: the host
    bandit pulls every arm once first, then (at that test's exploration
    coefficient, 0.05) settles on the best ratio of acceptance to
    slowdown."""
    cfg = tiny[3]
    c = PC.AdaptiveKW(cfg)
    seen = set()
    for _ in range(len(c.arms)):
        a = c.choose()
        assert a not in seen
        seen.add(a)
        c.update(a, tokens=10, calls=10)
    assert seen == set(c.arms)
    rng = np.random.default_rng(0)
    monkeypatch.setattr(PC, "EXPLORE", 0.05)
    c = PC.AdaptiveKW(cfg)
    true_tpc = {(1, 0): 1.0, (5, 4): 2.0, (10, 4): 2.2, (10, 10): 2.6,
                (25, 2): 1.8}
    for _ in range(300):
        a = c.choose()
        c.update(a, tokens=true_tpc[a] * 10 * (1 + 0.05
                                                * rng.standard_normal()),
                 calls=10)
    ratios = {a: true_tpc[a] / c.slow[a] for a in c.arms}
    assert _best_exploit(c) == max(ratios, key=ratios.get)
    assert c.slow[(1, 0)] == 1.0 and all(v >= 1.0 for v in c.slow.values())


def test_vectorised_bandit_explores_converges_and_keeps_slots_apart(
        tiny, monkeypatch):
    cfg = tiny[3]
    arms = ((1, 0), (4, 2), (8, 4))
    slow = PC.arm_slowdowns(cfg, arms)
    B = 3
    # unpulled arms first, in index order, independently per slot
    st = PC.init_arm_stats(B, len(arms))
    seen = [[] for _ in range(B)]
    for _ in range(len(arms)):
        arm = PC.choose_arms(st, slow)
        for b in range(B):
            assert int(arm[b]) not in seen[b]
            seen[b].append(int(arm[b]))
        st = PC.update_arm_stats(st, arm, torch.full((B,), 2.0),
                                 torch.ones(B, dtype=torch.bool))
    assert all(sorted(s) == [0, 1, 2] for s in seen)
    # no leak: hammering slot 0 leaves slot 1's stats and choice alone
    before = {k: v[1].clone() for k, v in st.items()}
    choice1 = int(PC.choose_arms(st, slow)[1])
    for _ in range(10):
        st = PC.update_arm_stats(
            st, torch.tensor([2, 0, 0], dtype=torch.int32),
            torch.tensor([50.0, 99.0, 99.0]),
            torch.tensor([True, False, False]))
    for k in before:
        assert torch.equal(st[k][1], before[k]), k
    assert int(PC.choose_arms(st, slow)[1]) == choice1
    assert int(PC.choose_arms(st, slow)[0]) == 2
    # a planted best arm per slot dominates that slot's pulls
    rng = np.random.default_rng(42)
    slow_np = np.asarray(slow)
    # (at the reference test's exploration coefficient, 0.05)
    monkeypatch.setattr(PC, "EXPLORE", 0.05)
    st = PC.init_arm_stats(B, len(arms))
    for _ in range(300):
        arm = PC.choose_arms(st, slow)
        a = arm.numpy()
        reward = slow_np[a] * np.where(a == np.arange(B), 1.5, 0.5) \
            * (1 + 0.05 * rng.standard_normal(B))
        st = PC.update_arm_stats(st, arm, torch.tensor(reward),
                                 torch.ones(B, dtype=torch.bool))
    pulls = st["arm_pulls"].numpy()
    assert (pulls.argmax(1) == np.arange(B)).all(), pulls
    assert (pulls[np.arange(B), np.arange(B)] > 0.6 * pulls.sum(1)).all()


def test_arm_stats_reset_on_slot_reuse(tiny):
    """release_slot and admit_slot both zero a slot's bandit rows."""
    cfg, params = tiny[3], tiny[4]
    spec = E.SpecConfig(k=4, w=2, strategy="mixed", max_new_tokens=8,
                        arms=((1, 0), (4, 2)))
    state = E.empty_decode_state(cfg, spec, 2, 32, device="cpu")
    state.stats.update(PC.update_arm_stats(
        {k: state.stats[k] for k in PC.ARM_STAT_KEYS},
        torch.tensor([1, 1], dtype=torch.int32), torch.tensor([3.0, 3.0]),
        torch.ones(2, dtype=torch.bool)))
    assert int(state.stats["arm_pulls"].sum()) == 2
    E.release_slot(state, 0)
    assert int(state.stats["arm_pulls"][0].sum()) == 0
    assert float(state.stats["arm_reward"][0].sum()) == 0
    assert int(state.stats["arm_pulls"][1].sum()) == 1
    E.admit_slot(params, cfg, state, 1, torch.arange(6) % 7, 4, -1)
    assert int(state.stats["arm_pulls"][1].sum()) == 0
    assert float(state.stats["arm_reward"][1].sum()) == 0


def test_arm_helpers_match_jax(tiny, monkeypatch):
    """Sweep widths, and the linear and tree priors with the reference's
    constants patched in (through the uncached functions, so that no
    patched prior stays in the caches)."""
    from repro.kernels import dispatch as JD
    monkeypatch.setattr(P, "PEAK_FLOPS", JP.PEAK_FLOPS)
    monkeypatch.setattr(P, "HBM_BW", JP.HBM_BW)
    cfg, jcfg = tiny[3], tiny[0]
    for arms in (ARMS, TREE_ARMS, JC.DEFAULT_ARMS, ((1, 0),), ((3, 2),)):
        assert dispatch.unique_sweep_widths(arms) == \
            JD.unique_sweep_widths(arms)
        np.testing.assert_allclose(
            PC.arm_slowdowns.__wrapped__(cfg, arms),
            JC.arm_slowdowns(jcfg, arms), rtol=1e-12)
        for branch in (1, 2, 3):
            np.testing.assert_allclose(
                PC.tree_arm_slowdowns.__wrapped__(cfg, arms, branch),
                JC.tree_arm_slowdowns(jcfg, arms, branch), rtol=1e-12)


def test_arm_table_validation_matches_jax(tiny):
    """Each bad table raises the reference's ValueError, message and all."""
    jcfg, jparams, _, cfg, params, _ = tiny
    prompt = _prompt()
    bad = [dict(arms=a) for a in (((5, 3),), ((0, 2),), ((2, 4),), ())]
    bad.append(dict(strategy="greedy", arms=((1, 0),)))
    for kw in bad:
        spec = dict(k=K_MAX, w=W_MAX, max_new_tokens=4, **kw)
        spec.setdefault("strategy", "mixed")
        with pytest.raises(ValueError) as err:
            E.generate(params, cfg, E.SpecConfig(**spec), prompt,
                       device="cpu")
        with pytest.raises(ValueError) as jerr:
            JE.generate(jparams, jcfg, JE.SpecConfig(**spec),
                        jnp.asarray(prompt))
        assert str(err.value) == str(jerr.value)
    for eng_cls, p, c in ((ServingEngine, params, cfg),
                          (JServingEngine, jparams, jcfg)):
        with pytest.raises(ValueError, match="requires adaptive=True"):
            eng_cls(p, c, arms=ARMS,
                    **({"device": "cpu"} if eng_cls is ServingEngine
                       else {}))


# ----------------------------------------------------------------------------
# masked arms against dedicated runs (the port alone)
# ----------------------------------------------------------------------------
def _masked(strategy, arm, **kw):
    return E.SpecConfig(k=K_MAX, w=W_MAX, strategy=strategy,
                        max_new_tokens=N_NEW, arms=(arm,), **kw)


def _dedicated(strategy, arm, **kw):
    """The run a masked arm must reproduce; (1, 0) IS greedy."""
    k, w = arm
    if w == 0:
        return E.SpecConfig(strategy="greedy", max_new_tokens=N_NEW, **kw)
    return E.SpecConfig(k=k, w=w, strategy=strategy, max_new_tokens=N_NEW,
                        **kw)


@pytest.mark.parametrize("arm", ARMS, ids=arm_id)
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_generate_masked_arm_equals_dedicated(tiny, strategy, arm):
    cfg, params, tables = tiny[3:]
    prompt = _prompt()
    P = prompt.shape[1]
    bm, lm, sm = E.generate(params, cfg, _masked(strategy, arm), prompt,
                            tables, device="cpu")
    bd, ld, sd = E.generate(params, cfg, _dedicated(strategy, arm), prompt,
                            tables, device="cpu")
    assert torch.equal(lm, ld)
    assert torch.equal(bm[:, :P + N_NEW], bd[:, :P + N_NEW])
    assert torch.equal(sm["calls"], sd["calls"])
    assert sm["arm_pulls"][:, 0].tolist() == sm["calls"].tolist()


@pytest.mark.parametrize("arm", ARMS, ids=arm_id)
@pytest.mark.parametrize("strategy", ["bigram", "unigram", "mixed"])
def test_masks_alone_keep_the_arm(tiny, strategy, arm):
    """With the lm head zeroed the model predicts token 0 everywhere, and
    the tables make every draft row [c, 0, 0] with c = 7, 8, 0, 9: row 2
    would be accepted to any depth, and every zero-padded position past a
    slot's depth too.  The masked run still commits what the dedicated run
    of the arm commits, call by call: the first call commits the bonus
    alone unless the arm keeps row 2 (k >= 3), then its depth too."""
    cfg, params = tiny[3], tiny[4]
    embed = dict(params["embed"])
    embed["lm_head"] = torch.zeros_like(embed["lm_head"])
    params = {**params, "embed": embed}
    V = cfg.vocab_size
    first = torch.tensor([7, 8, 0, 9, 10, 11, 12, 13], dtype=torch.int32)
    tables = NGramTables(first, first.repeat(V, 1),
                         torch.zeros((V, 8), dtype=torch.int32))
    prompt = torch.tensor([[1, 2, 1, 3, 1, 5, 6, 5, 1]], dtype=torch.int32)
    lens = {}
    for mode, spec in (("masked", _masked(strategy, arm)),
                       ("dedicated", _dedicated(strategy, arm))):
        state = E.init_decode_state(params, cfg, spec, prompt)
        trail = []
        while bool((~state.done).any()):
            state = E.spec_step(params, cfg, spec, state, tables)
            trail.append(int(state.buf_len[0]))
        lens[mode] = trail
    assert lens["masked"] == lens["dedicated"]
    assert lens["masked"][0] - 10 == 1 + (arm[1] if arm[0] > 2 else 0)


def _drive(params, cfg, spec, state, tables, max_steps=100):
    for _ in range(max_steps):
        if not bool((~state.done).any()):
            return state
        state = E.spec_step(params, cfg, spec, state, tables)
    raise AssertionError("spec_step did not converge")


def _step_run(model, spec, paged=None, N=12):
    """The continuous drive: slot 1 admitted one step after slot 0."""
    cfg, params, tables = model[3:]
    prompt = torch.from_numpy(_prompt())
    P = prompt.shape[1]
    spec = dataclasses.replace(spec, max_new_tokens=N)
    state = E.empty_decode_state(cfg, spec, 2, P + N + spec.w + 2,
                                 paged=paged, device="cpu")
    E.admit_slot(params, cfg, state, 0, prompt[0], N, -1)
    state = E.spec_step(params, cfg, spec, state, tables)
    E.admit_slot(params, cfg, state, 1, prompt[1], N, -1)
    state = _drive(params, cfg, spec, state, tables)
    assert (state.buf_len == P + N).all()
    return state


@pytest.mark.parametrize("paged", [False, True], ids=["linear", "paged"])
@pytest.mark.parametrize("arm", ARMS, ids=arm_id)
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_step_masked_arm_equals_dedicated(tiny, strategy, arm, paged):
    pc = E.PagedConfig(page_size=8) if paged else None
    sm = _step_run(tiny, _masked(strategy, arm), pc)
    sd = _step_run(tiny, _dedicated(strategy, arm), pc)
    assert torch.equal(sm.buf[:, :22], sd.buf[:, :22])
    if paged:
        C.check_page_invariants(sm.model)


@pytest.mark.parametrize("paged", [False, True], ids=["linear", "paged"])
def test_adaptive_runs_are_lossless(tiny, paged):
    """The whole table: adaptive generate and the continuous drive equal
    greedy decoding, and every slot pulled every arm (UCB's optimistic
    start) with pulls accounting for every call."""
    cfg, params, tables = tiny[3:]
    prompt = _prompt()
    P = prompt.shape[1]
    pc = E.PagedConfig(page_size=8) if paged else None
    ref = E.greedy_reference(params, cfg, prompt, N_NEW, device="cpu")
    spec = E.SpecConfig(k=K_MAX, w=W_MAX, strategy="mixed",
                        max_new_tokens=N_NEW, arms=ARMS)
    buf, _, st = E.generate(params, cfg, spec, prompt, tables, paged=pc,
                            device="cpu")
    assert torch.equal(buf[:, :P + N_NEW], ref)
    assert (st["arm_pulls"] > 0).all()
    assert st["arm_pulls"].sum(1).tolist() == st["calls"].tolist()
    state = _step_run(tiny, spec, pc)
    ref = E.greedy_reference(params, cfg, prompt, 12, device="cpu")
    assert torch.equal(state.buf[:, :P + 12], ref)


@pytest.mark.parametrize("arm", [(1, 1), (2, 2), (3, 4)], ids=arm_id)
def test_tree_masked_arm_equals_dedicated(tiny, arm):
    """A (width, depth) tree arm inside the (3, 4) tree step commits the
    tokens of a dedicated tree run of that arm, call by call."""
    cfg, params, tables = tiny[3:]
    prompt = torch.from_numpy(_prompt(seed=11))

    def drive(spec):
        state = E.init_decode_state(params, cfg, spec, prompt)
        trail = []
        while bool((~state.done).any()):
            state = E.spec_step(params, cfg, spec, state, tables)
            trail.append(state.buf_len.clone())
        return state.buf[:, :10 + 16], trail

    tree = dict(strategy="mixed", max_new_tokens=16, tree=True,
                tree_branch=2)
    out_m, trail_m = drive(E.SpecConfig(k=3, w=4, arms=(arm,), **tree))
    out_d, trail_d = drive(E.SpecConfig(k=arm[0], w=arm[1], **tree))
    assert torch.equal(out_m, out_d)
    assert len(trail_m) == len(trail_d)
    assert all(torch.equal(a, b) for a, b in zip(trail_m, trail_d))


def test_one_step_serves_every_arm(tiny, monkeypatch):
    """A continuous adaptive run (the port's counterpart of the reference's
    "compiles exactly once"): every state tensor keeps its shape, and every
    step drafts exactly once per distinct arm depth, whatever the slots
    pick."""
    depths = []
    real = dispatch.ngram_draft

    def spy(*a, **kw):
        depths.append(kw["w"])
        return real(*a, **kw)

    monkeypatch.setattr(dispatch, "ngram_draft", spy)
    cfg, params, tables = tiny[3:]
    spec = E.SpecConfig(k=K_MAX, w=W_MAX, strategy="mixed",
                        max_new_tokens=12, arms=ARMS)
    state = E.empty_decode_state(cfg, spec, 2, 40, device="cpu")
    shapes = lambda s: [(k, tuple(v.shape), v.dtype) for k, v in
                        sorted(s.stats.items())] + [
        (n, tuple(getattr(s, n).shape)) for n in
        ("buf", "buf_len", "done", "rng_key")]
    first = shapes(state)
    prompts = torch.from_numpy(_prompt(B=4))
    n_steps, queue = 0, list(range(4))
    while queue or bool((state.active & ~state.done).any()):
        for slot in range(2):
            if queue and not bool(state.active[slot] & ~state.done[slot]):
                E.admit_slot(params, cfg, state, slot, prompts[queue.pop(0)],
                             12, -1)
        state = E.spec_step(params, cfg, spec, state, tables)
        n_steps += 1
        assert shapes(state) == first
        for slot in range(2):
            if bool(state.done[slot]) and bool(state.active[slot]):
                E.release_slot(state, slot)
    sw = dispatch.unique_sweep_widths(ARMS)
    assert depths == list(sw) * n_steps


# ----------------------------------------------------------------------------
# against JAX's masked runs
# ----------------------------------------------------------------------------
def _jax_generate(model, spec_kw, prompt, paged=False, **kw):
    jcfg, jparams, jtables = model[:3]
    spec = JE.SpecConfig(backend="xla", **spec_kw)
    out = JE.generate(jparams, jcfg, spec, jnp.asarray(prompt), jtables,
                      paged=JE.PagedConfig(page_size=8) if paged else None,
                      **kw)
    return jax.tree_util.tree_map(np.asarray, out)


def _hold_against_jax(model, spec_kw, prompt, paged=False, jkw=None,
                      **kw):
    cfg, params, tables = model[3:]
    buf, blen, st = E.generate(
        params, cfg, E.SpecConfig(**spec_kw), prompt, tables,
        paged=E.PagedConfig(page_size=8) if paged else None, device="cpu",
        **kw)
    jbuf, jblen, jst = _jax_generate(model, spec_kw, prompt, paged,
                                     **(jkw or {}))
    P = prompt.shape[1]
    n = spec_kw["max_new_tokens"]
    np.testing.assert_array_equal(buf[:, :P + n].numpy(), jbuf[:, :P + n])
    np.testing.assert_array_equal(blen.numpy(), jblen)
    for key in ("calls", "tokens", "accept_hist", "arm_pulls",
                "arm_last"):
        np.testing.assert_array_equal(st[key].numpy(), jst[key],
                                      err_msg=key)
    np.testing.assert_allclose(st["arm_reward"].numpy(), jst["arm_reward"],
                               rtol=1e-6)
    return buf, st


@pytest.mark.parametrize("case", ["mixed", "context", "mixed-paged"])
def test_adaptive_generate_matches_jax(tiny, case):
    strategy = case.split("-")[0]
    _hold_against_jax(tiny, dict(k=K_MAX, w=W_MAX, strategy=strategy,
                                 max_new_tokens=N_NEW, arms=ARMS),
                      _prompt(B=3), paged=case.endswith("paged"))


def test_tree_adaptive_matches_jax_and_is_lossless(tiny):
    cfg, params = tiny[3], tiny[4]
    prompt = _prompt(seed=13)
    buf, st = _hold_against_jax(
        tiny, dict(k=3, w=4, strategy="mixed", max_new_tokens=N_NEW,
                   tree=True, tree_branch=2, arms=TREE_ARMS), prompt)
    ref = E.greedy_reference(params, cfg, prompt, N_NEW, device="cpu")
    assert torch.equal(buf[:, :prompt.shape[1] + N_NEW], ref)
    assert int(st["arm_pulls"].sum()) > 0
    # one masked tree arm against JAX's masked run of it
    _hold_against_jax(tiny, dict(k=3, w=4, strategy="mixed",
                                 max_new_tokens=16, tree=True,
                                 tree_branch=2, arms=((2, 2),)),
                      _prompt(seed=11))


def test_hybrid_adaptive_matches_jax(hybrid):
    """The tiny hybrid (gated replay, K5's plain version) under the whole
    table: JAX's tokens and stats, and greedy decoding."""
    cfg, params = hybrid[3], hybrid[4]
    prompt = _prompt(B=3, vocab=9)
    buf, _ = _hold_against_jax(
        hybrid, dict(k=K_MAX, w=W_MAX, strategy="mixed", max_new_tokens=12,
                     arms=ARMS), prompt)
    ref = E.greedy_reference(params, cfg, prompt, 12, device="cpu")
    assert torch.equal(buf[:, :prompt.shape[1] + 12], ref)


def test_sampled_rows_under_arms_match_jax(tiny):
    """Sampled rows (t 0.8 and 1.2, pinned seed) beside a greedy row under
    the whole table: JAX's tokens, stats and arm pulls; and at temperature
    0 the arms' sampled step is greedy decoding (the arms half of the
    reference's test_temp0_bit_parity_arms_and_tree)."""
    from repro_torch.core import prng
    cfg, params, tables = tiny[3:]
    prompt = _prompt(B=3)
    P = prompt.shape[1]
    spec_kw = dict(k=K_MAX, w=W_MAX, strategy="mixed", max_new_tokens=14,
                   arms=((1, 0), (2, 2), (4, 3)), sampling=True)
    temp = np.array([0.0, 0.8, 1.2], np.float32)
    topp = np.array([1.0, 0.9, 1.0], np.float32)
    seed = 2**31 + 11
    _hold_against_jax(
        tiny, spec_kw, prompt, temperature=torch.from_numpy(temp),
        top_p=torch.from_numpy(topp), rng=prng.prng_key(seed),
        jkw=dict(temperature=jnp.asarray(temp), top_p=jnp.asarray(topp),
                 rng=jax.random.PRNGKey(seed)))
    ref = E.greedy_reference(params, cfg, prompt, 12, device="cpu")
    buf, _, _ = E.generate(
        params, cfg, E.SpecConfig(**{**spec_kw, "max_new_tokens": 12}),
        prompt, tables, temperature=0.0, rng=prng.prng_key(7), device="cpu")
    assert torch.equal(buf[:, :P + 12], ref)


# ----------------------------------------------------------------------------
# ServingEngine(adaptive=True) against JAX's
# ----------------------------------------------------------------------------
def _engines(model, **kw):
    jcfg, jparams, jtables, cfg, params, tables = model
    common = dict(adaptive=True, arms=ARMS, buckets=(16, 32),
                  max_new_cap=14, **kw)
    spec = dict(k=K_MAX, w=W_MAX, strategy="mixed")
    return (JServingEngine(jparams, jcfg, JE.SpecConfig(backend="xla", **spec),
                           tables=jtables, **common),
            ServingEngine(params, cfg, E.SpecConfig(**spec), tables=tables,
                          device="cpu", **common))


def _work(n=7):
    out = []
    for i in range(n):
        text = f"def f{i}(x): return x * {i} + 1"
        out.append(((text * 2)[:30] if i % 3 == 1 else text[:14],
                    (6, 10, 14)[i % 3]))
    return out


def _serve(eng, work, static=False):
    for text, mnt in work:
        eng.submit(text, max_new_tokens=mnt)
    done = eng.serve_all() if static else eng.serve_continuous()
    return sorted(done, key=lambda r: r.request_id)


def _same_requests(done, jdone, keys):
    assert len(done) == len(jdone)
    for r, jr in zip(done, jdone):
        np.testing.assert_array_equal(r.output_ids, jr.output_ids)
        for key in keys:
            assert r.stats[key] == jr.stats[key], key


def _recorded(eng):
    """Record each arm the engine's host controller chooses."""
    seq, choose = [], eng.controller.choose

    def spy():
        seq.append(choose())
        return seq[-1]

    eng.controller.choose = spy
    return seq


def test_static_adaptive_serving_matches_jax(bench):
    """serve_all, one arm a batch: JAX's arm sequence (every arm explored,
    then exploited), the same outputs and per-arm statistics."""
    jeng, eng = _engines(bench, max_batch=1)
    seq, jseq = _recorded(eng), _recorded(jeng)
    work = [(t, 10) for t, _ in _work(6)]
    done = _serve(eng, work, static=True)
    _same_requests(done, _serve(jeng, work, static=True),
                   ("new_tokens", "model_calls", "accept_hist"))
    assert seq == jseq and len(seq) == 6
    assert set(seq[:len(ARMS)]) == set(ARMS)
    for a in ARMS:
        s, js = eng.controller.stats[a], jeng.controller.stats[a]
        assert (s.pulls, s.tokens, s.calls) == (js.pulls, js.tokens,
                                                js.calls)


@pytest.mark.parametrize("paged", [False, True], ids=["linear", "paged"])
def test_continuous_adaptive_serving_matches_jax(bench, paged):
    """serve_continuous, one arm a slot a step: outputs, per-request
    arm_pulls and adaptive_stats() equal JAX's engine; every output is
    greedy decoding; a paged pool drains with no leaked page."""
    jeng, eng = _engines(bench, max_batch=3, paged=paged,
                         num_pages=12 if paged else None, page_size=8)
    work = _work()
    done = _serve(eng, work)
    _same_requests(done, _serve(jeng, work),
                   ("new_tokens", "model_calls", "accept_hist", "arm_pulls"))
    for r in done:
        assert sum(r.stats["arm_pulls"].values()) == r.stats["model_calls"]
    assert eng.adaptive_stats() == jeng.adaptive_stats()
    assert eng._cont_spec.w == W_MAX and eng._cont_spec.arms == ARMS
    cfg, params = bench[3], bench[4]
    for r, (_, mnt) in zip(done, work):
        toks = eng.scheduler.pad_to_bucket(eng.tok.encode(r.prompt))
        ref = E.greedy_reference(params, cfg, toks[None], mnt, device="cpu")
        np.testing.assert_array_equal(r.output_ids, ref[0, len(toks):])
    if paged:
        assert eng.pool_stats() == jeng.pool_stats()
        C.check_page_invariants(eng._cont_state.model)
    eng.reset_pool_counters()
    assert sum(eng.adaptive_stats()["pulls_retired"]) == 0


def test_adaptive_engine_sizes_for_the_widest_arm(bench):
    """A greedy engine spec under adaptive: tables are built for the arm
    maxima, and the continuous buffer and page reservation follow the arm
    table's w, not the engine spec's."""
    cfg, params = bench[3], bench[4]
    arms = ((1, 0), (2, 2), (5, 7))
    eng = ServingEngine(params, cfg, E.SpecConfig(strategy="greedy", w=1),
                        adaptive=True, arms=arms, buckets=(16,),
                        max_new_cap=8, paged=True, page_size=8, max_batch=2,
                        device="cpu")
    assert eng.tables.k_max >= 25 and eng.tables.w_max >= 16
    eng.submit("abc", max_new_tokens=8)
    eng.step()
    assert eng._cont_spec.strategy == "mixed"
    assert (eng._cont_spec.k, eng._cont_spec.w) == (5, 7)
    assert eng._cont_state.buf_size == -(-(16 + 8 + 7 + 2) // 8) * 8
    assert eng._slot_pages(16, 8) == C.pages_for_len(16 + 8 + 7, 8)
