"""Serving the port's hybrid Mamba/attention model against the JAX
reference, on the CPU: speculative ``generate`` over a linear and a paged
cache (the gated replay commits every step), static and continuous
serving through ``ServingEngine``, and slot resets of the recurrent state.

Models: a no-MoE variant of ``tests/conftest.py:tiny_hybrid_cfg`` (three
Mamba layers around one attention layer, each MoE FFN made the dense
SwiGLU) and a byte-vocabulary hybrid (Mamba, attention) for serving.
Tokens, call counts, histograms, pool stats and page books equal the
reference's, and every output equals the port's ``greedy_reference``.
Drafting runs on the reference's XLA backend (its Pallas n-gram kernel
fails on this jax, ROADMAP queue 3).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.common import bench_config
from repro.core import spec_engine as JE
from repro.models import model as JM
from repro.models.config import BlockSpec as JBlockSpec
from repro.serving.engine import ServingEngine as JServingEngine
from repro.train.checkpoint import _flatten
from repro_torch.core import spec_engine as E
from repro_torch.core.ngram_tables import NGramTables
from repro_torch.models import cache as C
from repro_torch.models import model as M
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


def _dense_ffn(jcfg, name):
    """The reference config with every MoE FFN made the dense SwiGLU."""
    pattern = tuple(JBlockSpec(b.mixer, "swiglu" if b.mlp == "moe"
                               else b.mlp) for b in jcfg.block_pattern)
    return dataclasses.replace(jcfg, name=name, block_pattern=pattern,
                               num_experts=0, backend="xla").validate()


def _port(jcfg, jparams):
    cfg = ModelConfig.from_reference(jcfg)
    return cfg, from_jax_flat(_flatten(jparams), cfg, device="cpu")


def _port_tables(jt):
    return NGramTables(*(torch.from_numpy(np.array(a)) for a in
                         (jt.unigram_topk, jt.bigram_topk, jt.bigram_chain)))


# ----------------------------------------------------------------------------
# speculative generation
# ----------------------------------------------------------------------------
MAX_NEW = 12


@pytest.fixture(scope="module")
def tiny(tiny_hybrid_cfg):
    jcfg = _dense_ffn(tiny_hybrid_cfg, "tiny-hyb-gen")
    jparams = JM.init_params(jax.random.PRNGKey(0), jcfg)
    jtables = JServingEngine(jparams, jcfg,
                             JE.SpecConfig(k=4, w=3, backend="xla")).tables
    cfg, params = _port(jcfg, jparams)
    prompt = np.random.default_rng(1).integers(0, 7, (3, 10)).astype(
        np.int32)
    ref = E.greedy_reference(params, cfg, prompt, MAX_NEW, device="cpu")
    jref = JE.greedy_reference(jparams, jcfg, jnp.asarray(prompt), MAX_NEW)
    np.testing.assert_array_equal(ref.numpy(), np.asarray(jref))
    return (jcfg, jparams, jtables, cfg, params, _port_tables(jtables),
            prompt, ref)


@pytest.mark.parametrize("paged", [False, True], ids=["linear", "paged"])
@pytest.mark.parametrize("strategy", ["mixed", "context", "bigram"])
def test_generate_is_lossless_and_matches_jax(tiny, strategy, paged):
    jcfg, jparams, jtables, cfg, params, tables, prompt, ref = tiny
    kw = dict(k=4, w=3, strategy=strategy, max_new_tokens=MAX_NEW)
    pg = E.PagedConfig(page_size=8) if paged else None
    jpg = JE.PagedConfig(page_size=8) if paged else None
    buf, blen, stats = E.generate(params, cfg, E.SpecConfig(**kw), prompt,
                                  tables, paged=pg, device="cpu")
    jbuf, jblen, jstats = JE.generate(
        jparams, jcfg, JE.SpecConfig(backend="xla", **kw),
        jnp.asarray(prompt), jtables, paged=jpg)
    n = prompt.shape[1] + MAX_NEW
    np.testing.assert_array_equal(buf[:, :n].numpy(), ref.numpy())
    np.testing.assert_array_equal(buf[:, :n].numpy(),
                                  np.asarray(jbuf[:, :n]))
    np.testing.assert_array_equal(blen.numpy(), np.asarray(jblen))
    for key in ("calls", "tokens", "accept_hist", "rank_hist", "alloc_ctx",
                "accepted_ctx", "accepted_bigram"):
        np.testing.assert_array_equal(stats[key].numpy(),
                                      np.asarray(jstats[key]), err_msg=key)
    assert int(stats["tokens"].sum()) > int(stats["calls"].sum())


def test_tree_speculation_needs_an_attention_only_arch(tiny):
    """A tree with a recurrent stack raises in the step, as the
    reference's does (its rows are causal sequences)."""
    jcfg, jparams, jtables, cfg, params, tables, prompt, _ = tiny
    kw = dict(k=2, w=2, tree=True, max_new_tokens=4)
    with pytest.raises(ValueError, match="attention-only") as err:
        E.generate(params, cfg, E.SpecConfig(**kw), prompt, tables,
                   device="cpu")
    with pytest.raises(ValueError, match="attention-only") as jerr:
        JE.generate(jparams, jcfg, JE.SpecConfig(backend="xla", **kw),
                    jnp.asarray(prompt), jtables)
    assert str(err.value).split(" (")[0] == str(jerr.value).split(" (")[0]


# ----------------------------------------------------------------------------
# continuous serving
# ----------------------------------------------------------------------------
@pytest.fixture(scope="module")
def serving():
    """A byte-vocabulary hybrid (Mamba, attention), its JAX tables, and the
    port's copies."""
    jcfg = dataclasses.replace(
        bench_config(), name="bench-hybrid", backend="xla",
        block_pattern=(JBlockSpec("mamba", "swiglu"),
                       JBlockSpec("attn", "swiglu")), num_layers=2,
        mamba_d_state=8).validate()
    jparams = JM.init_params(jax.random.PRNGKey(2), jcfg)
    jtables = JServingEngine(jparams, jcfg,
                             JE.SpecConfig(k=4, w=3, backend="xla")).tables
    cfg, params = _port(jcfg, jparams)
    return jcfg, jparams, jtables, cfg, params, _port_tables(jtables)


def _workload():
    out = []
    for i in range(6):
        text = f"def f{i}(x): return x * {i} + 1"
        text = (text * 2)[:30] if i % 3 == 1 else text[:14]
        out.append((text, (6, 10, 14)[i % 3]))
    return out


def _serve(eng, work):
    for text, mnt in work:
        eng.submit(text, max_new_tokens=mnt)
    return sorted(eng.serve_continuous(), key=lambda r: r.request_id)


@pytest.mark.parametrize("strategy,paged,num_pages", [
    ("mixed", False, None), ("mixed", True, 9), ("greedy", True, None)],
    ids=["linear-mixed", "paged-mixed-small-pool", "paged-greedy"])
def test_continuous_serving_matches_jax_engine(serving, strategy, paged,
                                               num_pages):
    """Outputs, calls, histograms, pool stats and the page books equal the
    reference engine's; the 9-page pool defers, drains and leaks nothing."""
    jcfg, jparams, jtables, cfg, params, tables = serving
    common = dict(max_batch=3, buckets=(16, 32), max_new_cap=14,
                  paged=paged, num_pages=num_pages, page_size=8)
    jeng = JServingEngine(jparams, jcfg, JE.SpecConfig(
        k=4, w=3, strategy=strategy, backend="xla"), tables=jtables,
        **common)
    eng = ServingEngine(params, cfg, E.SpecConfig(k=4, w=3,
                                                  strategy=strategy),
                        tables=tables, device="cpu", **common)
    work = _workload()
    done, jdone = _serve(eng, work), _serve(jeng, work)
    assert len(done) == len(jdone) == len(work)
    for r, jr, (_, mnt) in zip(done, jdone, work):
        np.testing.assert_array_equal(r.output_ids, jr.output_ids)
        for key in ("new_tokens", "model_calls", "accept_hist"):
            assert r.stats[key] == jr.stats[key], key
        assert r.stats["new_tokens"] == mnt
    if paged:
        stats = eng.pool_stats()
        assert stats == jeng.pool_stats()
        assert stats["rejected"] == 0 and stats["free_pages"] == \
            stats["num_pages"]
        if num_pages:
            assert stats["deferrals"] > 0
        model, jmodel = eng._cont_state.model, jeng._cont_state.model
        N = C.paged_dims(model)[0]
        assert C.check_page_invariants(model)["allocated"] == 0
        for key in ("page_table", "n_pages"):
            np.testing.assert_array_equal(model[key].numpy(),
                                          np.asarray(jmodel[key]))
        np.testing.assert_array_equal(model["free_list"][:N].numpy(),
                                      np.asarray(jmodel["free_list"]))
        assert int(model["free_top"]) == int(jmodel["free_top"])


def test_serve_all_and_slot_reset_keep_recurrent_rows_apart(serving):
    """Static serving is lossless on the hybrid, and a reused slot
    (reset_slot on either layout) starts from zero recurrent state."""
    _, _, _, cfg, params, tables = serving
    eng = ServingEngine(params, cfg, E.SpecConfig(k=4, w=3), tables=tables,
                        buckets=(16, 32), device="cpu")
    for text, mnt in _workload()[:3]:
        eng.submit(text, max_new_tokens=mnt)
    for r in eng.serve_all():
        toks = eng.scheduler.pad_to_bucket(eng.tok.encode(r.prompt))
        ref = E.greedy_reference(params, cfg, toks[None],
                                 r.stats["new_tokens"], device="cpu")
        np.testing.assert_array_equal(r.output_ids,
                                      ref[0, len(toks):].numpy())
        assert r.stats["model_calls"] < r.stats["new_tokens"]
    for paged in (False, True):
        st = (C.init_paged_state(cfg, 2, 4, 8, 2, device="cpu") if paged
              else M.init_state(cfg, 2, 16, device="cpu"))
        for g in st["groups"].values():
            for leaf in g.values():
                leaf.fill_(1)
        st = C.reset_slot(cfg, st, 1)
        conv, ssm = st["groups"]["p0"]["conv"], st["groups"]["p0"]["ssm"]
        assert not conv[:, 1].any() and not ssm[:, 1].any()
        assert bool((conv[:, 0] == 1).all()) and bool((ssm[:, 0] == 1).all())
