"""The port's drafters and n-gram tables (repro_torch.core) against the JAX
reference: drafts and valid masks are integers and must be bit-identical
on the same buffers and tables, ties included (small vocabularies make
count ties and recency ties the common case)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import drafters as JD
from repro.core.ngram_tables import build_bigram as j_build_bigram
from repro.core.ngram_tables import build_unigram as j_build_unigram
from repro.core.ngram_tables import tables_from_counts
from repro_torch.core import drafters as D
from repro_torch.core.ngram_tables import (NGramTables, build_bigram,
                                           build_unigram)


def _tables(V, seed, k_max=8, w_max=6):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 3, (V, V)).astype(np.float32)   # many ties
    jt = tables_from_counts(jnp.asarray(counts), k_max=k_max, w_max=w_max)
    return jt, NGramTables(*(torch.from_numpy(np.array(a)) for a in
                             (jt.unigram_topk, jt.bigram_topk,
                              jt.bigram_chain)))


def _buffers(seed, B=5, L=90, vocab=3, q=1):
    rng = np.random.default_rng(seed)
    buf = rng.integers(0, vocab, (B, L)).astype(np.int32)
    cur = np.array([L, L - 7, 40, q, 1][:B], np.int32)   # incl. cur < q + 1
    buf[np.arange(L)[None, :] >= cur[:, None]] = 0       # unwritten tail
    last = buf[np.arange(B), cur - 1]
    return buf, cur, last


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("q,k,w,vocab", [(1, 4, 3, 3), (2, 6, 5, 2),
                                         (1, 10, 10, 4), (3, 5, 2, 2)])
def test_context_drafts_bit_identical(q, k, w, vocab):
    buf, cur, _ = _buffers(q * 10 + w, vocab=vocab, q=q)
    jd, jv = JD.context_ngram_draft(jnp.asarray(buf), jnp.asarray(cur), q, k,
                                    w, backend="xla")
    d, v = D.context_ngram_draft(torch.from_numpy(buf),
                                 torch.from_numpy(cur), q, k, w)
    _eq(d, jd)
    _eq(v, jv)
    assert bool(jv.any()) and not bool(jv.all())


def test_context_draft_count_then_recency_order():
    """Continuations rank by occurrence count, ties by latest position."""
    seq = [7, 1, 7, 2, 7, 1, 7, 3, 7, 2, 7, 4, 7]
    buf = np.array([seq + [0] * 7], np.int32)
    cur = np.array([len(seq)], np.int32)
    d, v = D.context_ngram_draft(torch.from_numpy(buf),
                                 torch.from_numpy(cur), 1, 4, 1)
    # after "7": 1 twice, 2 twice (2 latest), then 3, 4 once (4 latest)
    assert d[0, :, 0].tolist() == [2, 1, 4, 3]
    assert v.all()
    jd, jv = JD.context_ngram_draft(jnp.asarray(buf), jnp.asarray(cur), 1, 4,
                                    1, backend="xla")
    _eq(d, jd)


@pytest.mark.parametrize("k,w", [(4, 3), (8, 6), (6, 1)])
def test_mixed_bigram_unigram_drafts_bit_identical(k, w):
    jt, tt = _tables(12, seed=k + w)
    buf, cur, last = _buffers(k * w, vocab=3)
    jd, jv, jn = JD.mixed_draft(jt, jnp.asarray(buf), jnp.asarray(cur),
                                jnp.asarray(last), 1, k, w, backend="xla")
    d, v, n = D.mixed_draft(tt, torch.from_numpy(buf), torch.from_numpy(cur),
                            torch.from_numpy(last), 1, k, w)
    _eq(d, jd)
    _eq(v, jv)
    _eq(n, jn)
    jd, _ = JD.bigram_draft(jt, jnp.asarray(last), k, w)
    _eq(D.bigram_draft(tt, torch.from_numpy(last), k, w)[0], jd)
    jd, _ = JD.unigram_draft(jt, buf.shape[0], k, w)
    _eq(D.unigram_draft(tt, buf.shape[0], k, w)[0], jd)


def test_build_bigram_breaks_exact_ties_like_jax():
    V, k_max, w_max = 37, 6, 5
    rng = np.random.default_rng(0)
    table = rng.integers(0, 3, (V, V)).astype(np.float32)  # exact ties
    jt = jnp.asarray(table)
    tt = torch.from_numpy(table)
    j_topk, j_chain = j_build_bigram(lambda t: jt[t[:, 0]], V, k_max=k_max,
                                     w_max=w_max, batch=8)
    topk, chain = build_bigram(lambda t: tt[t[:, 0].long()], V, k_max=k_max,
                               w_max=w_max, batch=8, device="cpu")
    _eq(topk, j_topk)
    _eq(chain, j_chain)
    assert topk.dtype == chain.dtype == torch.int32


@pytest.mark.parametrize("appendix", [False, True])
def test_build_unigram_breaks_exact_ties_like_jax(appendix):
    """Small integer embeddings over a power-of-two vocabulary keep every
    product exact in f32, so duplicate columns tie exactly in both."""
    V, d = 64, 4
    rng = np.random.default_rng(1)
    emb = rng.integers(-1, 2, (V, d)).astype(np.float32)
    head = rng.integers(-1, 2, (d, V // 4)).astype(np.float32)
    head = np.repeat(head, 4, axis=1)                     # 4-way ties
    want = j_build_unigram(jnp.asarray(emb), jnp.asarray(head), k_max=10,
                           appendix_variant=appendix)
    got = build_unigram(torch.from_numpy(emb), torch.from_numpy(head),
                        k_max=10, appendix_variant=appendix)
    _eq(got, want)


def test_drafters_refuse_more_rows_than_the_tables_hold():
    _, tt = _tables(5, seed=3)                   # k_max = min(8, V) = 5
    last = torch.zeros((2,), dtype=torch.int32)
    with pytest.raises(ValueError):
        D.bigram_draft(tt, last, 6, 3)
    with pytest.raises(ValueError):
        D.unigram_draft(tt, 2, 4, 8)             # chain holds w_max = 6

