"""The port's engine (repro_torch.core.spec_engine, repro_torch.serving)
against the JAX reference.

Lossless is exact: every strategy's ``generate`` equals the port's
``greedy_reference`` and JAX's, token for token.  Given the same tables,
the per-row verify-call counts, token counts and acceptance histograms
equal JAX's ``generate`` too, and ``serve_all`` returns JAX's outputs and
stats for the same submits.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import spec_engine as JE
from repro.core.verify import accept as j_accept
from repro.data.datasets import make_prompts
from repro.models import model as JM
from repro.serving.engine import ServingEngine as JServingEngine
from repro.train.checkpoint import _flatten
from repro_torch.core import spec_engine as E
from repro_torch.core.ngram_tables import NGramTables
from repro_torch.core.verify import accept
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


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STRATEGIES = ["mixed", "bigram", "unigram", "context", "greedy"]
MAX_NEW = 14


def _port(jcfg, jparams):
    cfg = ModelConfig.from_reference(jcfg)
    return cfg, from_jax_flat(_flatten(jparams), cfg, device="cpu")


def _port_tables(jt):
    return NGramTables(*(torch.from_numpy(np.array(a)) for a in
                         (jt.unigram_topk, jt.bigram_topk, jt.bigram_chain)))


@pytest.fixture(scope="module")
def tiny(tiny_dense_cfg):
    """JAX params and tables of the tiny GQA model, and the port's copies."""
    jparams = JM.init_params(jax.random.PRNGKey(0), tiny_dense_cfg)
    jtables = JServingEngine(jparams, tiny_dense_cfg,
                             JE.SpecConfig(k=4, w=3)).tables
    cfg, params = _port(tiny_dense_cfg, jparams)
    return tiny_dense_cfg, jparams, jtables, cfg, params, _port_tables(jtables)


def _prompt(seed, B=3, P=10, vocab=7):
    """Repetitive prompts over a few tokens, so that context drafts hit."""
    return np.random.default_rng(seed).integers(0, vocab, (B, P)).astype(
        np.int32)


@pytest.fixture(scope="module")
def greedy_refs(tiny):
    """The port's and JAX's greedy_reference on ``_prompt(1)``."""
    jcfg, jparams, _, cfg, params, _ = tiny
    prompt = _prompt(1)
    return (E.greedy_reference(params, cfg, prompt, MAX_NEW, device="cpu"),
            JE.greedy_reference(jparams, jcfg, jnp.asarray(prompt), MAX_NEW))


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_generate_is_lossless_and_matches_jax(tiny, greedy_refs, strategy):
    jcfg, jparams, jtables, cfg, params, tables = tiny
    prompt = _prompt(1)
    spec = E.SpecConfig(k=4, w=3, strategy=strategy, max_new_tokens=MAX_NEW)
    jspec = JE.SpecConfig(k=4, w=3, strategy=strategy,
                          max_new_tokens=MAX_NEW)
    buf, blen, stats = E.generate(params, cfg, spec, prompt, tables,
                                  device="cpu")
    jbuf, jblen, jstats = JE.generate(jparams, jcfg, jspec,
                                      jnp.asarray(prompt), jtables)
    n = prompt.shape[1] + MAX_NEW
    ref, jref = greedy_refs
    np.testing.assert_array_equal(ref.numpy(), np.asarray(jref))
    np.testing.assert_array_equal(buf[:, :n].numpy(), ref.numpy())
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))
    np.testing.assert_array_equal(blen.numpy(), np.asarray(jblen))
    for key in ("calls", "tokens", "accept_hist", "rank_hist", "alloc_ctx",
                "accepted_ctx", "accepted_bigram"):
        np.testing.assert_array_equal(stats[key].numpy(),
                                      np.asarray(jstats[key]), err_msg=key)
    if strategy != "greedy":
        assert int(stats["tokens"].sum()) > int(stats["calls"].sum())


@pytest.mark.parametrize("masked", [False, True])
def test_accept_matches_jax(masked):
    """Longest accepted prefix, winner (ties to the lowest row), bonus."""
    rng = np.random.default_rng(4)
    B, k, w = 6, 5, 4
    drafts = rng.integers(0, 3, (B, k, w)).astype(np.int32)
    greedy = rng.integers(0, 3, (B, k, w + 1)).astype(np.int32)
    greedy[:, :, :2] = np.where(rng.random((B, k, 2)) < 0.7,
                                drafts[:, :, :2], greedy[:, :, :2])
    masks = {}
    if masked:
        masks = dict(k_eff=rng.integers(1, k + 1, B).astype(np.int32),
                     w_eff=rng.integers(0, w + 1, B).astype(np.int32),
                     row_mask=rng.random((B, k)) < 0.7)
        masks["row_mask"][:, 0] = True
    got = accept(torch.from_numpy(drafts), torch.from_numpy(greedy),
                 **{n: torch.from_numpy(m) for n, m in masks.items()})
    want = j_accept(jnp.asarray(drafts), jnp.asarray(greedy),
                    **{n: jnp.asarray(m) for n, m in masks.items()})
    for field in ("tokens", "n_commit", "winner", "n_acc"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)),
                                      err_msg=field)


def test_generate_eos_truncation_matches_jax(tiny):
    jcfg, jparams, jtables, cfg, params, tables = tiny
    prompt = _prompt(2)
    ref = E.greedy_reference(params, cfg, prompt, MAX_NEW, device="cpu")
    P = prompt.shape[1]
    eos = np.array([int(ref[0, P + 5]), -1, int(ref[2, P + 1])], np.int32)
    spec = E.SpecConfig(k=4, w=3, max_new_tokens=MAX_NEW)
    jspec = JE.SpecConfig(k=4, w=3, max_new_tokens=MAX_NEW)
    buf, blen, stats = E.generate(params, cfg, spec, prompt, tables,
                                  eos_id=torch.from_numpy(eos), device="cpu")
    jbuf, jblen, jstats = JE.generate(jparams, jcfg, jspec,
                                      jnp.asarray(prompt), jtables,
                                      eos_id=jnp.asarray(eos))
    np.testing.assert_array_equal(blen.numpy(), np.asarray(jblen))
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))
    np.testing.assert_array_equal(stats["calls"].numpy(),
                                  np.asarray(jstats["calls"]))
    assert int(blen[1]) == P + MAX_NEW and int(blen[0]) < P + MAX_NEW


def test_serve_all_matches_jax_engine():
    from benchmarks.common import bench_config
    jcfg = bench_config()
    jparams = JM.init_params(jax.random.PRNGKey(2), jcfg)
    cfg, params = _port(jcfg, jparams)
    prompts = ([p for p, _ in make_prompts("code", 2)]
               + [p for p, _ in make_prompts("chat", 1)])
    jspec = JE.SpecConfig(k=5, w=4)
    jeng = JServingEngine(jparams, jcfg, jspec, buckets=(256,))
    eng = ServingEngine(params, cfg, E.SpecConfig(k=5, w=4),
                        tables=_port_tables(jeng.tables), buckets=(256,),
                        device="cpu")
    for p in prompts:
        jeng.submit(p, max_new_tokens=12)
        eng.submit(p, max_new_tokens=12)
    jdone = sorted(jeng.serve_all(), key=lambda r: r.request_id)
    done = sorted(eng.serve_all(), key=lambda r: r.request_id)
    assert len(done) == len(jdone) == 3
    for r, jr in zip(done, jdone):
        np.testing.assert_array_equal(r.output_ids, jr.output_ids)
        assert r.output == jr.output
        for key in ("new_tokens", "model_calls", "tokens_per_call",
                    "accept_hist"):
            assert r.stats[key] == jr.stats[key], key
    # the port's own table sweep gives the same (lossless) outputs
    own = ServingEngine(params, cfg, E.SpecConfig(k=5, w=4), buckets=(256,),
                        device="cpu")
    assert own.tables.k_max == 25 and own.tables.w_max == 16
    for p in prompts:
        own.submit(p, max_new_tokens=12)
    for r, jr in zip(sorted(own.serve_all(), key=lambda r: r.request_id),
                     jdone):
        np.testing.assert_array_equal(r.output_ids, jr.output_ids)


def test_entry_points_need_a_card_unless_cpu_is_asked_for(tiny):
    _, _, _, cfg, params, tables = tiny
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(params, cfg, E.SpecConfig(k=4, w=3), tables=tables)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        E.generate(params, cfg, E.SpecConfig(k=4, w=3), _prompt(0), tables)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        E.greedy_reference(params, cfg, _prompt(0), 2)


def test_port_and_smoke_script_import_neither_jax_nor_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "archs = ('mistral_7b', 'gemma_2b', 'glm4_9b', 'nemotron_4_340b',\n"
        "         'qwen2_vl_72b', 'hubert_xlarge')\n"
        "mods = ['configs.' + a for a in archs] + [\n"
        "    'data.pipeline', 'train', 'train.optimizer', 'train.train_loop',\n"
        "    'train.checkpoint', 'launch', 'launch.train', 'launch.serve']\n"
        "missing = [m for m in mods if 'repro_torch.' + m not in sys.modules]\n"
        "assert not missing, missing\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 52
