"""The port's drafters and n-gram tables (repro_torch.core) against the JAX
reference: drafts and valid masks are integers and must be bit-identical
on the same buffers and tables, ties included (small vocabularies make
count ties and recency ties the common case).  The context and mixed
strategies are K2's contract (invalid context rows zeroed, as the
engine's ``_draft`` returns them); on the CPU its plain version runs.
The adversarial rows hold the drafting step (``_draft``) against JAX's:
a row that matches everywhere, the token whose continuation hash equals
the no-match SENTINEL, rows too short to query, fewer representatives
than rows, and a bigram fill that runs past the non-duplicates."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import drafters as JD
from repro.core import spec_engine as JE
from repro.core.ngram_tables import build_bigram as j_build_bigram
from repro.core.ngram_tables import build_unigram as j_build_unigram
from repro.core.ngram_tables import NGramTables as JNGramTables
from repro.core.ngram_tables import tables_from_counts
from repro_torch.core import drafters as D
from repro_torch.core import ngram_tables as NT
from repro_torch.core import spec_engine as E
from repro_torch.core.ngram_tables import (NGramTables, build_bigram,
                                           build_unigram)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The port's side in one thread: these models are tiny, and the suite
    runs its files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
    _eq(d, jnp.where(jv[..., None], jd, 0))
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


SENTINEL_TOKEN = 1097884494     # 0x4170634E: its w=1 hash is 0xFFFFFFFF


def _adversarial(case):
    """(buf (B, L), cur (B,), q, k, w, tables (JAX, port)) of one row set
    that stresses the drafting contract."""
    rng = np.random.default_rng(5)
    jt, tt = _tables(12, seed=7, k_max=8, w_max=6)
    if case == "match_everywhere":
        # one repeated token: M = L - q - w + 1 matches, all one bucket;
        # a period-2 row; a row of one token up to a ragged cur_len
        L, q, k, w = 64, 1, 4, 3
        buf = np.full((3, L), 5, np.int32)
        buf[1, 1::2] = 6
        cur = np.array([L, L, 40], np.int32)
    elif case == "sentinel_hash":
        # w = 1: the continuation SENTINEL_TOKEN hashes as the no-match
        # SENTINEL, so its count also holds every unmatched position
        L, q, k, w = 48, 1, 4, 1
        buf = rng.integers(0, 4, (3, L)).astype(np.int32)
        buf[:, 10:40:6] = 7
        buf[:, 11:40:12] = SENTINEL_TOKEN
        buf[:, 17:40:12] = 3
        buf[:, 40] = 7
        buf[2, [20, 24]] = 7
        buf[2, 21] = SENTINEL_TOKEN
        cur = np.array([41, 41, 25], np.int32)
    elif case == "too_short":
        # buf_len < q + 1: no context row anywhere; the clamped query
        L, q, k, w = 32, 2, 4, 3
        buf = rng.integers(0, 3, (4, L)).astype(np.int32)
        cur = np.array([0, 1, 2, 3], np.int32)
    elif case == "few_representatives":
        # two distinct continuations for k = 8 rows
        L, q, k, w = 40, 1, 8, 2
        buf = np.tile(np.array([1, 2, 3, 1, 4, 4], np.int32), 7)[None, :L]
        buf = np.repeat(buf, 2, axis=0)
        cur = np.array([L, 19], np.int32)
    else:
        # "dup_tail": bigram candidates that repeat each other and the one
        # context row, so the fill runs past the non-duplicates
        L, q, k, w = 30, 1, 4, 3
        topk = np.tile(np.array([2, 2, 2, 3, 4, 5], np.int32), (12, 1))
        chain = np.tile(np.arange(6, dtype=np.int32)[None, :] + 4, (12, 1))
        chain[2] = [4, 5, 6, 7, 8, 9]
        jt = JNGramTables(jnp.arange(6, dtype=jnp.int32), jnp.asarray(topk),
                          jnp.asarray(chain))
        tt = NGramTables(torch.arange(6, dtype=torch.int32),
                         torch.from_numpy(topk), torch.from_numpy(chain))
        buf = np.zeros((2, L), np.int32)
        buf[:, 5:9] = [1, 2, 4, 5]
        buf[:, 20] = 1
        buf[1, 12:16] = [1, 3, 8, 9]
        cur = np.array([21, 21], np.int32)
    return buf, cur, q, k, w, (jt, tt)


@pytest.mark.parametrize("strategy", ["context", "mixed"])
@pytest.mark.parametrize("case", ["match_everywhere", "sentinel_hash",
                                  "too_short", "few_representatives",
                                  "dup_tail"])
def test_draft_step_matches_jax_on_adversarial_rows(case, strategy):
    buf, cur, q, k, w, (jt, tt) = _adversarial(case)
    L = buf.shape[1]
    last = buf[np.arange(buf.shape[0]), (cur - 1) % L]
    jspec = JE.SpecConfig(k=k, w=w, q=q, strategy=strategy, backend="xla")
    jd, jv, jn = JE._draft(jspec, jt, jnp.asarray(buf), jnp.asarray(cur),
                           jnp.asarray(last))
    spec = E.SpecConfig(k=k, w=w, q=q, strategy=strategy)
    d, v, n = E._draft(spec, tt, torch.from_numpy(buf),
                       torch.from_numpy(cur), torch.from_numpy(last))
    _eq(d, jd)
    _eq(v, jv)
    _eq(n, jn)
    assert d.dtype == n.dtype == torch.int32 and v.dtype == torch.bool
    # the contract's invariants, beside the reference's bits
    ctx_v = D.context_ngram_draft(torch.from_numpy(buf),
                                  torch.from_numpy(cur), q, k, w)[1]
    assert torch.equal(n, ctx_v.sum(dim=1).to(torch.int32))
    if case == "too_short":
        assert not n.any()
    if case == "match_everywhere":
        assert n.tolist() == [1, 1, 1]
    if case == "few_representatives":
        assert n.tolist() == [2, 2]
    if case == "sentinel_hash" and strategy == "context":
        # the SENTINEL-hashed continuation outcounts every real one
        assert (d[:, 0, 0] == SENTINEL_TOKEN).all()
    if case == "dup_tail" and strategy == "mixed":
        # row 0: the context row, then candidate 3, then duplicates 0, 1
        assert d[0, :, 0].tolist() == [2, 3, 2, 2]


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


@pytest.mark.parametrize("ties", [True, False])
@pytest.mark.parametrize("appendix", [False, True])
def test_build_unigram_over_several_chunks_matches_jax(monkeypatch,
                                                       appendix, ties):
    """The vocabulary read in uneven chunks (21, 21, 21, 1 of 64 tokens),
    as every served vocabulary on the card is read: exact 4-way ties break
    as JAX's do, and over normal embeddings the ranking is JAX's."""
    V, d = 64, 4
    rng = np.random.default_rng(2)
    if ties:
        emb = rng.integers(-1, 2, (V, d)).astype(np.float32)
        head = np.repeat(rng.integers(-1, 2, (d, V // 4)), 4,
                         axis=1).astype(np.float32)
    else:
        emb = rng.standard_normal((V, d)).astype(np.float32)
        head = rng.standard_normal((d, V)).astype(np.float32)
    want = j_build_unigram(jnp.asarray(emb), jnp.asarray(head), k_max=10,
                           appendix_variant=appendix)
    monkeypatch.setattr(NT, "UNIGRAM_CHUNK", V // 3)
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

