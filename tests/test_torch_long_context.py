"""Long contexts in the port against the JAX reference: the blockwise
(online-softmax) full attention and the sliding-window ring cache under
speculation.

``_blockwise_attention`` agrees with JAX's at a small block, with a window
and a logit softcap, within f32 1e-5; ``masked_attention`` at S 8192 takes
it, as the reference's does, and agrees with JAX's.  On Mistral's smoke
config (a 64-slot ring) prompts longer than the window and new tokens that
wrap the ring again during speculation give the port's ``greedy_reference``
tokens, which equal JAX's, statically and in continuous serving.
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
from repro.models import model as JM
from repro.train.checkpoint import _flatten
from repro_torch.core import spec_engine as E
from repro_torch.core.ngram_tables import (NGramTables, build_bigram,
                                           build_unigram)
from repro_torch.models import attention as A
from repro_torch.models.cache import cache_buffer_len
from repro_torch.models.config import ModelConfig
from repro_torch.models import model as M
from repro_torch.models.weights import from_jax_flat
from repro_torch.serving.engine import ServingEngine

WINDOW = 64          # Mistral's smoke window: the ring's slots


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The port's side in one thread: these models are tiny, and the suite
    runs its files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkv(rng, B, T, S, H, KV, hd):
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return f(B, T, H, hd), f(B, S, KV, hd), f(B, S, KV, hd)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window,softcap", [(None, None), (24, None),
                                            (24, 5.0)])
def test_blockwise_attention_matches_jax(window, softcap, causal):
    rng = np.random.default_rng(0)
    B, T, S, H, KV, hd, block = 2, 12, 64, 4, 2, 8, 16
    q, k, v = _qkv(rng, B, T, S, H, KV, hd)
    q_pos = np.stack([np.arange(S - T, S), np.arange(30, 30 + T)]
                     ).astype(np.int32)
    k_pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    k_pos[1, 50:] = -1                         # empty slots
    jcfg = dataclasses.replace(jconfigs.get_smoke_config("mistral-7b"),
                               sliding_window=window,
                               attn_logit_softcap=softcap)
    cfg = ModelConfig.from_reference(jcfg)
    want = JA._blockwise_attention(*map(jnp.asarray, (q, k, v, q_pos, k_pos)),
                                   jcfg, causal, block=block)
    got = A._blockwise_attention(*map(torch.from_numpy,
                                      (q, k, v, q_pos, k_pos)),
                                 cfg, causal, block=block)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    # and the plain softmax over every key at once
    full = A.masked_attention(*map(torch.from_numpy,
                                   (q, k, v, q_pos, k_pos)), cfg, causal)
    np.testing.assert_allclose(got.numpy(), full.numpy(), atol=1e-5,
                               rtol=1e-5)


def test_masked_attention_goes_blockwise_from_8192_keys(monkeypatch):
    rng = np.random.default_rng(1)
    B, T, S, H, KV, hd = 1, 2, A.BLOCKWISE_THRESHOLD, 2, 1, 8
    q, k, v = _qkv(rng, B, T, S, H, KV, hd)
    q_pos = np.array([[S - 2, S - 1]], np.int32)
    k_pos = np.arange(S, dtype=np.int32)[None]
    jcfg = dataclasses.replace(jconfigs.get_smoke_config("mistral-7b"),
                               sliding_window=5000)
    cfg = ModelConfig.from_reference(jcfg)
    want = JA.masked_attention(*map(jnp.asarray, (q, k, v, q_pos, k_pos)),
                               jcfg, True)
    calls = []
    real = A._blockwise_attention
    monkeypatch.setattr(A, "_blockwise_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    got = A.masked_attention(*map(torch.from_numpy,
                                  (q, k, v, q_pos, k_pos)), cfg, True)
    assert calls == [1]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    A.masked_attention(*map(torch.from_numpy, (q, k[:, :-8], v[:, :-8],
                                               q_pos, k_pos[:, :-8])),
                       cfg, True)
    assert calls == [1]                # S % 1024 != 0: the plain softmax


@pytest.fixture(scope="module")
def mistral():
    jcfg = jconfigs.get_smoke_config("mistral-7b")
    assert jcfg.sliding_window == WINDOW
    jparams = JM.init_params(jax.random.PRNGKey(2), jcfg)
    cfg = ModelConfig.from_reference(jcfg)
    params = from_jax_flat(_flatten(jparams), cfg, device="cpu")
    topk, chain = build_bigram(
        lambda t: M.forward(params, cfg, tokens=t)[0][:, -1],
        cfg.vocab_size, k_max=4, w_max=4, device="cpu")
    emb = params["embed"]["embedding"]
    uni = build_unigram(emb, params["embed"]["lm_head"], k_max=4)
    tables = NGramTables(uni, topk, chain)
    jtables = JTables(*(jnp.asarray(t.numpy()) for t in (uni, topk, chain)))
    return jcfg, jparams, cfg, params, tables, jtables


def test_speculation_over_a_wrapped_ring_is_greedy_decoding(mistral):
    """An 80-token prompt (the ring already wrapped in prefill) and 40 new
    tokens (wrapping it again, under speculation)."""
    jcfg, jparams, cfg, params, tables, jtables = mistral
    P, new = 80, 40
    prompt = np.random.default_rng(3).integers(0, 9, (2, P)).astype(np.int32)
    ref = E.greedy_reference(params, cfg, prompt, new, device="cpu")
    for strategy in ("greedy", "mixed"):
        spec = E.SpecConfig(k=4, w=3, strategy=strategy, max_new_tokens=new)
        assert cache_buffer_len(cfg, P + new + spec.w + 2) == WINDOW
        buf, blen, stats = E.generate(params, cfg, spec, prompt, tables,
                                      device="cpu")
        np.testing.assert_array_equal(buf[:, :P + new].numpy(), ref.numpy())
    # speculation did commit several tokens a call, and JAX's tokens agree
    assert int(stats["tokens"].sum()) > int(stats["calls"].sum())
    jbuf, jblen, _ = JE.generate(
        jparams, jcfg, JE.SpecConfig(k=4, w=3, strategy="mixed",
                                     max_new_tokens=new),
        jnp.asarray(prompt), jtables)
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))
    np.testing.assert_array_equal(blen.numpy(), np.asarray(jblen))


def test_continuous_serving_over_a_wrapped_ring(mistral):
    """Admission prefills prompts longer than the ring into slots that
    earlier requests wrapped; every output is greedy decoding."""
    _, _, cfg, params, tables, _ = mistral
    eng = ServingEngine(params, cfg, E.SpecConfig(k=4, w=3,
                                                  strategy="mixed"),
                        tables=tables, max_batch=2, buckets=(32, 96),
                        max_new_cap=40, device="cpu")
    texts = ["the cat sat on the mat " * 4, "abcab" * 5, "zz top " * 12]
    for t, n in zip(texts, (40, 24, 33)):
        eng.submit(t[:95], max_new_tokens=n)
    done = sorted(eng.serve_continuous(), key=lambda r: r.request_id)
    assert eng._cont_state.model["groups"]["p0"]["k"].shape[2] == WINDOW
    for r in done:
        toks = np.asarray(eng.scheduler.pad_to_bucket(eng.tok.encode(
            r.prompt)))
        want = E.greedy_reference(params, cfg, toks[None],
                                  r.max_new_tokens, device="cpu")
        np.testing.assert_array_equal(r.output_ids,
                                      want[0, len(toks):].numpy())
