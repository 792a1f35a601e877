"""The registry's attention-only architectures (Mistral-7B, Gemma-2B,
GLM-4-9B, Nemotron-4, Qwen2-VL, HuBERT) in the port against the JAX
reference, at their smoke configs.

Weights go from the JAX ``init_params`` through ``checkpoint._flatten`` into
``weights.from_jax_flat``; inputs are made from a seed with numpy.  Logits
of forward (HuBERT's from frame embeddings), prefill, decode and verify
agree within 1e-4 in f32 and 6e-2 in bf16 (the frameworks round bf16
intermediates at different places; one bf16 ulp at 1.0 is 7.8e-3).  Greedy
and mixed ``generate`` are token-equal to JAX's and to the port's
``greedy_reference``.  Also: M-RoPE with distinct t/h/w positions, the
registry's long-context variant and decode support, and the verify routing
of a config outside K1's contract (a softcap config over a paged cache too).
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
from repro.models import attention as JA
from repro.models import cache as JC
from repro.models import model as JM
from repro.train.checkpoint import _flatten
from repro_torch import configs
from repro_torch.core import spec_engine as E
from repro_torch.core.ngram_tables import (NGramTables, build_bigram,
                                           build_unigram)
from repro_torch.models import attention as A
from repro_torch.models import cache as C
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.models.weights import from_jax_flat
from repro_torch.serving.engine import ServingEngine

TOL = {"float32": 1e-4, "bfloat16": 6e-2}
NEW_ARCHS = ["mistral-7b", "gemma-2b", "glm4-9b", "nemotron-4-340b",
             "qwen2-vl-72b", "hubert-xlarge"]
DECODERS = [a for a in NEW_ARCHS if a != "hubert-xlarge"]
MAX_NEW = 16


def _port(jcfg, jparams):
    cfg = ModelConfig.from_reference(jcfg)
    return cfg, from_jax_flat(_flatten(jparams), cfg, device="cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The port's side in one thread: these models are tiny, and the suite
    runs its files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """arch -> dtype -> (jax cfg, jax params, port cfg, port params), made
    once per module so that each JAX function compiles once per config;
    the bf16 weights are the f32 ones rounded."""
    out = {}
    for arch in NEW_ARCHS:
        out[arch] = {}
        jparams = JM.init_params(jax.random.PRNGKey(1),
                                 jconfigs.get_smoke_config(arch))
        for dtype, jd in (("float32", jnp.float32),
                          ("bfloat16", jnp.bfloat16)):
            jcfg = dataclasses.replace(
                jconfigs.get_smoke_config(arch), param_dtype=jd,
                compute_dtype=jd)
            jp = jax.tree_util.tree_map(lambda a: a.astype(jd), jparams)
            out[arch][dtype] = (jcfg, jp) + _port(jcfg, jp)
    return out


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


def _toks(rng, V, *shape):
    return rng.integers(0, V, shape).astype(np.int32)


def test_smoke_configs_are_the_references_field_for_field():
    for arch in configs.ALL_ARCHS:
        for port_fn, ref_fn in ((configs.get_config, jconfigs.get_config),
                                (configs.get_smoke_config,
                                 jconfigs.get_smoke_config)):
            assert port_fn(arch) == ModelConfig.from_reference(ref_fn(arch))
            assert port_fn(arch).param_count() == ref_fn(arch).param_count()
    assert configs.ALL_ARCHS == jconfigs.ALL_ARCHS


@pytest.mark.parametrize("arch", configs.ALL_ARCHS)
def test_long_context_variant_and_decode_support_match_the_reference(arch):
    ref = jconfigs.get_config(arch)
    cfg = configs.get_config(arch)
    assert configs.long_context_variant(cfg) == ModelConfig.from_reference(
        jconfigs.long_context_variant(ref))
    assert configs.supports_decode(cfg) == jconfigs.supports_decode(ref)
    assert configs.supports_long_decode(cfg) \
        == jconfigs.supports_long_decode(ref)
    assert configs.LONG_CONTEXT_WINDOW == jconfigs.LONG_CONTEXT_WINDOW


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_forward_logits_match_jax(models, arch, dtype):
    jcfg, jparams, cfg, params = models[arch][dtype]
    rng = np.random.default_rng(0)
    if cfg.embedding_inputs:
        emb = rng.standard_normal((2, 11, cfg.d_model)).astype(np.float32)
        want, _ = JM.forward(jparams, jcfg, embeds=jnp.asarray(emb))
        got, _ = M.forward(params, cfg, embeds=torch.from_numpy(emb))
        hid, _ = M.forward_hidden(params, cfg, embeds=torch.from_numpy(emb))
        jhid, _ = JM.forward_hidden(jparams, jcfg, embeds=jnp.asarray(emb))
        _close(hid, jhid, dtype)
    else:
        toks = _toks(rng, cfg.vocab_size, 2, 11)
        want, _ = JM.forward(jparams, jcfg, tokens=jnp.asarray(toks))
        got, _ = M.forward(params, cfg, tokens=torch.from_numpy(toks))
    assert got.shape == (2, 11, cfg.vocab_size)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("arch", DECODERS)
def test_prefill_decode_verify_match_jax(models, arch, dtype):
    jcfg, jparams, cfg, params = models[arch][dtype]
    rng = np.random.default_rng(1)
    B, P, S, K, W1 = 2, 9, 24, 3, 4
    prompt = _toks(rng, cfg.vocab_size, B, P)
    jst = JM.init_state(jcfg, B, S)
    st = M.init_state(cfg, B, S, device="cpu")
    want, jst = JM.prefill(jparams, jcfg, jst, tokens=jnp.asarray(prompt))
    got, st = M.prefill(params, cfg, st, tokens=torch.from_numpy(prompt))
    _close(got, want, dtype)
    step = _toks(rng, cfg.vocab_size, B, 1)
    want, jst = JM.decode(jparams, jcfg, jst, jnp.asarray(step))
    got, st = M.decode(params, cfg, st, torch.from_numpy(step))
    _close(got, want, dtype)
    rows = _toks(rng, cfg.vocab_size, B, K, W1)
    want, jtails = JM.verify(jparams, jcfg, jst, jnp.asarray(rows))
    got, tails = M.verify(params, cfg, st, torch.from_numpy(rows))
    _close(got, want, dtype)
    for gid, g in jtails.items():
        _close(tails[gid]["k_tail"], g["k_tail"], dtype)


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


def _prompt(seed, B=2, P=12, vocab=7):
    """Repetitive prompts over a few tokens, so that context drafts hit."""
    return np.random.default_rng(seed).integers(0, vocab, (B, P)).astype(
        np.int32)


@pytest.mark.parametrize("arch", DECODERS)
def test_generate_is_lossless_and_matches_jax(models, arch):
    """Greedy and mixed ``generate`` give the port's ``greedy_reference``
    tokens, which equal JAX's; mixed also equals JAX's ``generate`` with
    the same tables, buffer, lengths and verify calls."""
    jcfg, jparams, cfg, params = models[arch]["float32"]
    tables, jtables = _tables(cfg, params)
    prompt = _prompt(2)
    n = prompt.shape[1] + MAX_NEW
    ref = E.greedy_reference(params, cfg, prompt, MAX_NEW, device="cpu")
    jref = JE.greedy_reference(jparams, jcfg, jnp.asarray(prompt), MAX_NEW)
    np.testing.assert_array_equal(ref.numpy(), np.asarray(jref))
    for strategy in ("greedy", "mixed"):
        spec = E.SpecConfig(k=4, w=3, strategy=strategy,
                            max_new_tokens=MAX_NEW)
        buf, blen, stats = E.generate(params, cfg, spec, prompt, tables,
                                      device="cpu")
        np.testing.assert_array_equal(buf[:, :n].numpy(), ref.numpy())
    jbuf, jblen, jstats = JE.generate(
        jparams, jcfg, JE.SpecConfig(k=4, w=3, strategy="mixed",
                                     max_new_tokens=MAX_NEW),
        jnp.asarray(prompt), jtables)
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))
    np.testing.assert_array_equal(blen.numpy(), np.asarray(jblen))
    np.testing.assert_array_equal(stats["calls"].numpy(),
                                  np.asarray(jstats["calls"]))


@pytest.mark.parametrize("arch,paged", [("qwen2-vl-72b", False),
                                        ("qwen2-vl-72b", True),
                                        ("mistral-7b", False)])
def test_continuous_and_tree_serving_are_lossless(models, arch, paged):
    """Continuous serving (linear, and paged where the config allows it)
    and a token tree on M-RoPE and on the window config equal greedy
    decoding of each request."""
    _, _, cfg, params = models[arch]["float32"]
    tables, _ = _tables(cfg, params)
    texts = ["abcabcabcabd", "xyzzy xyzzy xyzzy", "hello hello"]
    for spec in (E.SpecConfig(k=4, w=3, strategy="mixed"),
                 E.SpecConfig(k=3, w=3, strategy="mixed", tree=True,
                              tree_branch=2)):
        eng = ServingEngine(params, cfg, spec, tables=tables, max_batch=2,
                            buckets=(16,), max_new_cap=MAX_NEW,
                            paged=paged, page_size=8 if paged else 0,
                            device="cpu")
        for t in texts:
            eng.submit(t, max_new_tokens=MAX_NEW)
        done = sorted(eng.serve_continuous(), key=lambda r: r.request_id)
        for r in done:
            toks = eng.scheduler.pad_to_bucket(eng.tok.encode(r.prompt))
            want = E.greedy_reference(params, cfg, np.asarray(toks)[None],
                                      MAX_NEW, device="cpu")
            np.testing.assert_array_equal(r.output_ids,
                                          want[0, len(toks):].numpy())


@pytest.mark.parametrize("arch", ["qwen2-vl-72b"])
def test_mrope_with_distinct_positions_matches_jax(models, arch):
    rng = np.random.default_rng(3)
    for jcfg in (jconfigs.get_config(arch), jconfigs.get_smoke_config(arch)):
        cfg = ModelConfig.from_reference(jcfg)
        pos = rng.integers(0, 5000, (3, 2, 7)).astype(np.int32)
        want = JA.rope_freqs(jcfg, jnp.asarray(pos))
        got = A.rope_freqs(cfg, torch.from_numpy(pos).long())
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    jcfg, jparams, cfg, params = models[arch]["float32"]
    toks = _toks(rng, cfg.vocab_size, 2, 9)
    pos = np.sort(rng.integers(0, 40, (3, 2, 9)), axis=-1).astype(np.int32)
    want, _ = JM.forward(jparams, jcfg, tokens=jnp.asarray(toks),
                         positions=jnp.asarray(pos))
    got, _ = M.forward(params, cfg, tokens=torch.from_numpy(toks),
                       positions=torch.from_numpy(pos).long())
    _close(got, want, "float32")
    # text tokens: the three rows coincide
    assert M.make_positions(cfg, 2, 5, device="cpu").shape == (3, 2, 5)


@pytest.mark.parametrize("arch,plain", [("mistral-7b", True),
                                        ("glm4-9b", False)])
def test_verify_routing_follows_the_kernel_contract(models, arch, plain):
    """A window config verifies through ``plain_verify`` (counted), a
    config inside K1's contract does not, as the reference routes them."""
    _, _, cfg, params = models[arch]["float32"]
    st = M.init_state(cfg, 2, 24, device="cpu")
    M.prefill(params, cfg, st, tokens=torch.zeros((2, 5), dtype=torch.int32))
    A.plain_verify.calls = 0
    M.verify(params, cfg, st, torch.zeros((2, 3, 4), dtype=torch.int32))
    M.decode(params, cfg, st, torch.zeros((2, 1), dtype=torch.int32))
    assert A.plain_verify.calls == (2 * cfg.num_layers if plain else 0)


def test_softcap_config_verifies_over_a_paged_cache_like_jax(models):
    """A logit-softcap config (outside K1's contract, but pageable: only
    windows are refused) over a paged state: the pages are gathered and the
    plain verify runs on them, counted, and prefill, decode and verify
    logits agree with JAX's paged state within f32 1e-4."""
    jcfg, jparams, _, params = models["glm4-9b"]["float32"]
    jcfg = dataclasses.replace(jcfg, attn_logit_softcap=5.0)
    cfg = ModelConfig.from_reference(jcfg)
    rng = np.random.default_rng(3)
    B, P, K, W1, N, ps, pps = 2, 9, 3, 4, 12, 4, 5
    jst = JC.init_paged_state(jcfg, B, N, ps, pps)
    st = C.init_paged_state(cfg, B, N, ps, pps, device="cpu")
    for slot in range(B):
        jst = JC.alloc_slot_pages(jst, jnp.int32(slot), 4)
        C.alloc_slot_pages(st, slot, 4)
    prompt = _toks(rng, cfg.vocab_size, B, P)
    want, jst = JM.prefill(jparams, jcfg, jst, tokens=jnp.asarray(prompt))
    got, st = M.prefill(params, cfg, st, tokens=torch.from_numpy(prompt))
    _close(got, want, "float32")
    A.plain_verify.calls = 0
    step = _toks(rng, cfg.vocab_size, B, 1)
    want, jst = JM.decode(jparams, jcfg, jst, jnp.asarray(step))
    got, st = M.decode(params, cfg, st, torch.from_numpy(step))
    _close(got, want, "float32")
    rows = _toks(rng, cfg.vocab_size, B, K, W1)
    want, _ = JM.verify(jparams, jcfg, jst, jnp.asarray(rows))
    got, _ = M.verify(params, cfg, st, torch.from_numpy(rows))
    _close(got, want, "float32")
    assert A.plain_verify.calls == 2 * cfg.num_layers
