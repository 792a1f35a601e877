"""The port's tree speculation (repro_torch.core.tree, K4's plain version,
tree ``verify``, tree ``generate`` and tree serving) against the JAX
reference, on the CPU.

  - topology arrays equal JAX's; the ancestor table lists each input's
    visible inputs in ascending order;
  - the level-wise ``fill_tree`` gives JAX's node-loop tokens bit for bit,
    with and without the committed buffer (dedup and context-seeded tails
    both exercised);
  - K4's plain version, linear and paged, is within f32 2e-5 of the
    reference's Pallas kernels in interpret mode and of its oracle (the
    kernel tolerance);
  - tree ``verify`` logits and KV tails are within f32 1e-4 of JAX's;
  - tree ``generate`` and continuous tree serving, linear and paged, give
    JAX's tokens and stats exactly, and ``greedy_reference``'s tokens.
Drafting on the JAX side runs with ``backend="xla"`` (its Pallas n-gram
sweep does not run on this jax).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.common import bench_config
from repro.core import spec_engine as JE
from repro.core import tree as JT
from repro.core.ngram_tables import NGramTables as JNGramTables
from repro.kernels import dispatch as jdispatch
from repro.kernels import ops as jops
from repro.models import cache as JC
from repro.models import model as JM
from repro.serving.engine import ServingEngine as JServingEngine
from repro.train.checkpoint import _flatten
from repro_torch.core import spec_engine as E
from repro_torch.core import tree as T
from repro_torch.core.ngram_tables import NGramTables
from repro_torch.kernels import dispatch
from repro_torch.kernels.spec_attention import ancestor_table, tree_mask
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


TOPOLOGIES = [(1, 1, 1), (2, 3, 1), (3, 2, 2), (2, 5, 2), (4, 5, 2),
              (3, 4, 3)]
STATS = ("calls", "tokens", "accept_hist", "rank_hist", "alloc_ctx",
         "accepted_ctx", "accepted_bigram")
MAX_NEW = 14


def _port_tables(jt):
    return NGramTables(*(torch.from_numpy(np.array(a)) for a in
                         (jt.unigram_topk, jt.bigram_topk, jt.bigram_chain)))


def _port(jcfg, seed):
    jparams = JM.init_params(jax.random.PRNGKey(seed), jcfg)
    cfg = ModelConfig.from_reference(jcfg)
    return jparams, cfg, from_jax_flat(_flatten(jparams), cfg, device="cpu")


@pytest.fixture(scope="module")
def tiny(tiny_dense_cfg):
    """The tiny GQA model on the XLA backend, its tables, and the port's
    copies."""
    jcfg = dataclasses.replace(tiny_dense_cfg, backend="xla")
    jparams, cfg, params = _port(jcfg, 0)
    jtables = JServingEngine(jparams, jcfg, JE.SpecConfig(k=4, w=3)).tables
    return jcfg, jparams, jtables, cfg, params, _port_tables(jtables)


# ---------------------------------------------------------------------------
# (a) topology
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("wdb", TOPOLOGIES)
def test_topology_matches_jax(wdb):
    topo, jtopo = T.topology(*wdb), JT.topology(*wdb)
    for field in jtopo._fields:
        np.testing.assert_array_equal(getattr(topo, field),
                                      getattr(jtopo, field), err_msg=field)
    assert topo.num_nodes == jtopo.num_nodes == T.num_nodes(*wdb)
    assert topo.num_paths == jtopo.num_paths == T.num_paths(*wdb)
    assert T.effective_branch(*wdb[1:]) == JT.effective_branch(*wdb[1:])
    # K4's operand: row i = [n_i, visible inputs ascending, -1 ...], at most
    # depth + 1 of them (the root and the node's ancestors-or-self)
    anc = ancestor_table(jtopo.anc_mask)
    assert anc.shape == (topo.num_nodes + 1, wdb[1] + 2)
    for i, row in enumerate(jtopo.anc_mask):
        vis = np.flatnonzero(row)
        assert anc[i, 0] == vis.size == topo.pos_off[i] + 1
        np.testing.assert_array_equal(anc[i, 1:1 + vis.size], vis)
        assert (anc[i, 1 + vis.size:] == -1).all()
    # the fill plan covers every node once: the spine, then level by level
    plan = T.fill_plan(*wdb)
    filled = np.concatenate([plan.spine_nodes]
                            + [lv.nodes for lv in plan.levels])
    np.testing.assert_array_equal(np.sort(filled),
                                  np.arange(topo.num_nodes))


# ---------------------------------------------------------------------------
# (b) the level-wise fill against the reference's node loop
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("with_buf", [False, True], ids=["no-buf", "buf"])
@pytest.mark.parametrize("wdb", TOPOLOGIES[1:])
def test_fill_tree_matches_jax(wdb, with_buf):
    """Random drafts over a small vocabulary, bigram rows of distinct
    tokens, a repetitive committed buffer with ragged lengths: the tokens
    equal JAX's.  The dedup skip and context hits both occur."""
    width, depth, branch = wdb
    rng = np.random.default_rng(width * 100 + depth * 10 + branch)
    B, V, kmax, L = 6, 9, 6, 40
    drafts = rng.integers(0, V, (B, width, depth)).astype(np.int32)
    big = np.stack([rng.permutation(V)[:kmax] for _ in range(V)]).astype(
        np.int32)
    buf = rng.integers(0, 4, (B, L)).astype(np.int32)
    buf_len = rng.integers(1, L + 1, B).astype(np.int32)
    jt = JNGramTables(jnp.zeros((1, kmax), jnp.int32), jnp.asarray(big),
                      jnp.zeros((V, kmax), jnp.int32))
    pt = NGramTables(torch.zeros((1, kmax), dtype=torch.int32),
                     torch.from_numpy(big),
                     torch.zeros((V, kmax), dtype=torch.int32))
    kw, jkw = {}, {}
    if with_buf:
        kw = dict(buf=torch.from_numpy(buf), buf_len=torch.from_numpy(buf_len))
        jkw = dict(buf=jnp.asarray(buf), buf_len=jnp.asarray(buf_len))
    topo = T.topology(*wdb)
    got = T.fill_tree(topo, torch.from_numpy(drafts), pt, **kw)
    want = JT.fill_tree(JT.topology(*wdb), jnp.asarray(drafts), jt, **jkw)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    toks = got.numpy()
    d = T.effective_branch(depth, branch)
    # the dedup case: a spine parent whose 0-child is among its top-width
    # candidates (the sibling skips it)
    dup = [(toks[:, topo.sibling0[n]][:, None]
            == big[toks[:, topo.parent[n]], :width]).any(axis=1).sum()
           for n in range(topo.num_nodes)
           if not topo.spine[n] and topo.spine[topo.parent[n]]]
    if width > 1 and d > 1:
        assert sum(dup) > 0
    if with_buf and depth > d:
        # context-seeded tails: some chain node differs from the bigram
        # argmax of its parent
        chain = [n for n in range(topo.num_nodes)
                 if topo.level[n] > d and not topo.spine[n]]
        if chain:
            par = toks[:, topo.parent[chain]]
            assert (toks[:, chain] != big[par, 0]).any()


def test_fill_tree_rejects_narrow_tables():
    topo = T.topology(4, 2, 1)
    tables = NGramTables(torch.zeros((1, 3), dtype=torch.int32),
                         torch.zeros((5, 3), dtype=torch.int32),
                         torch.zeros((5, 3), dtype=torch.int32))
    with pytest.raises(ValueError, match="k_max >= width"):
        T.fill_tree(topo, torch.zeros((1, 4, 2), dtype=torch.int32), tables)


# ---------------------------------------------------------------------------
# (c) K4's plain version against the reference's kernels and oracle
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("wdb,H,KV,hd,cur", [
    ((2, 3, 2), 4, 2, 16, [9, 0]),
    ((3, 2, 2), 4, 1, 32, [16, 5]),
    ((1, 1, 1), 4, 4, 16, [8, 3]),
    ((4, 5, 2), 8, 2, 16, [13, 24])])
def test_tree_plain_kernel_matches_jax(wdb, H, KV, hd, cur):
    topo = JT.topology(*wdb)
    W1 = topo.num_nodes + 1
    B, S, ps = len(cur), 24, 8
    NP, pps = 8, S // ps
    rng = np.random.default_rng(W1)
    sh = lambda *s: rng.normal(size=s).astype(np.float32)
    q, kt, vt = sh(B, 1, W1, H, hd), sh(B, 1, W1, KV, hd), sh(B, 1, W1, KV, hd)
    kc, vc = sh(B, S, KV, hd), sh(B, S, KV, hd)
    kp, vp = sh(NP, ps, KV, hd), sh(NP, ps, KV, hd)
    pt = rng.permutation(NP)[:B * pps].reshape(B, pps).astype(np.int32)
    for b, c in enumerate(cur):
        pt[b, -(-c // ps):] = -1
    cl = np.asarray(cur, np.int32)
    tm = tree_mask(topo.anc_mask, "cpu")
    static = jdispatch._static_mask(topo.anc_mask)
    j = lambda a: jnp.asarray(a)
    t = torch.from_numpy
    want_lin = jops.spec_attention_op(*map(j, (q, kc, vc, kt, vt, cl)),
                                      w1=W1, block_s=8, interpret=True,
                                      tail_mask=static)
    want_ref = jops.spec_attention_ref_op(*map(j, (q, kc, vc, kt, vt, cl)),
                                          w1=W1, tail_mask=topo.anc_mask)
    want_pg = jops.paged_spec_attention_op(
        *map(j, (q, kp, vp, pt, kt, vt, cl)), w1=W1, interpret=True,
        tail_mask=static)
    got_lin = dispatch.verify_attention(*map(t, (q, kc, vc, kt, vt, cl)),
                                        w1=W1, tail_mask=tm)
    got_pg = dispatch.verify_attention_paged(
        *map(t, (q, kp, vp, pt, kt, vt, cl)), w1=W1, tail_mask=tm)
    close = lambda a, b: np.testing.assert_allclose(
        a.numpy(), np.asarray(b), rtol=2e-5, atol=2e-5)
    close(got_lin, want_lin)
    close(got_lin, want_ref)
    close(got_pg, want_pg)
    # the tree mask is not the causal one: without it the outputs differ
    if topo.width > 1:
        causal = dispatch.verify_attention(*map(t, (q, kc, vc, kt, vt, cl)),
                                           w1=W1)
        assert not torch.allclose(causal, got_lin, atol=1e-3)


# ---------------------------------------------------------------------------
# (d) tree verify
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("paged", [False, True], ids=["linear", "paged"])
def test_tree_verify_matches_jax(tiny, paged):
    jcfg, jparams, _, cfg, params, _ = tiny
    topo = JT.topology(3, 3, 2)
    B, P, L, ps = 2, 7, 24, 4
    rng = np.random.default_rng(11)
    prompt = rng.integers(0, cfg.vocab_size, (B, P)).astype(np.int32)
    rows = rng.integers(0, cfg.vocab_size,
                        (B, 1, topo.num_nodes + 1)).astype(np.int32)
    if paged:
        jst = JC.init_paged_state(jcfg, B, B * L // ps, ps, L // ps)
        jst = JC.grow_pages(jst, jnp.full((B,), P, jnp.int32),
                            jnp.ones((B,), bool))
        st = C.init_paged_state(cfg, B, B * L // ps, ps, L // ps,
                                device="cpu")
        C.grow_pages(st, torch.full((B,), P, dtype=torch.int32),
                     torch.ones((B,), dtype=torch.bool))
    else:
        jst = JM.init_state(jcfg, B, L)
        st = M.init_state(cfg, B, L, device="cpu")
    _, jst = JM.prefill(jparams, jcfg, jst, tokens=jnp.asarray(prompt))
    _, st = M.prefill(params, cfg, st, tokens=torch.from_numpy(prompt))
    tc = T.device_constants(3, 3, 2, torch.device("cpu"))
    logits, tails = M.verify(params, cfg, st, torch.from_numpy(rows),
                             pos_off=tc.pos_off, tail_mask=tc.tail_mask)
    jlogits, jtails = JM.verify(jparams, jcfg, jst, jnp.asarray(rows),
                                pos_off=topo.pos_off,
                                tail_mask=topo.anc_mask)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-4)
    for gid, g in jtails.items():
        for name, arr in g.items():
            np.testing.assert_allclose(tails[gid][name].numpy(),
                                       np.asarray(arr), rtol=1e-4,
                                       atol=1e-4, err_msg=f"{gid} {name}")


# ---------------------------------------------------------------------------
# (e) tree generate
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def greedy_refs(tiny):
    jcfg, jparams, _, cfg, params, _ = tiny
    prompt = np.random.default_rng(1).integers(0, 7, (3, 10)).astype(
        np.int32)
    return prompt, E.greedy_reference(params, cfg, prompt, MAX_NEW,
                                      device="cpu").numpy()


@pytest.mark.parametrize("strategy,wdb,paged", [
    ("mixed", (3, 3, 2), False),
    ("bigram", (3, 3, 2), False),
    ("unigram", (3, 3, 2), False),
    ("context", (3, 3, 2), False),
    ("mixed", (4, 5, 2), False),
    ("mixed", (2, 4, 1), False),
    ("mixed", (1, 2, 1), False),
    ("mixed", (3, 1, 2), False),
    ("mixed", (4, 5, 2), True),
    ("context", (2, 3, 1), True)])
def test_tree_generate_matches_jax(tiny, greedy_refs, strategy, wdb, paged):
    jcfg, jparams, jtables, cfg, params, tables = tiny
    prompt, ref = greedy_refs
    width, depth, branch = wdb
    common = dict(k=width, w=depth, strategy=strategy,
                  max_new_tokens=MAX_NEW, tree=True, tree_branch=branch)
    kw = dict(paged=E.PagedConfig(page_size=4)) if paged else {}
    jkw = dict(paged=JE.PagedConfig(page_size=4)) if paged else {}
    buf, blen, stats = E.generate(params, cfg, E.SpecConfig(**common),
                                  prompt, tables, device="cpu", **kw)
    jbuf, jblen, jstats = JE.generate(
        jparams, jcfg, JE.SpecConfig(backend="xla", **common),
        jnp.asarray(prompt), jtables, **jkw)
    np.testing.assert_array_equal(buf[:, :ref.shape[1]].numpy(), ref)
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))
    np.testing.assert_array_equal(blen.numpy(), np.asarray(jblen))
    assert stats["rank_hist"].shape[1] == T.num_paths(*wdb)
    for key in STATS:
        np.testing.assert_array_equal(stats[key].numpy(),
                                      np.asarray(jstats[key]), err_msg=key)


def test_tree_generate_eos_truncation_matches_jax(tiny, greedy_refs):
    jcfg, jparams, jtables, cfg, params, tables = tiny
    prompt, ref = greedy_refs
    P = prompt.shape[1]
    eos = np.array([ref[0, P + 4], -1, ref[2, P + 1]], np.int32)
    common = dict(k=3, w=3, max_new_tokens=MAX_NEW, tree=True)
    buf, blen, stats = E.generate(params, cfg, E.SpecConfig(**common),
                                  prompt, tables,
                                  eos_id=torch.from_numpy(eos), device="cpu")
    jbuf, jblen, jstats = JE.generate(
        jparams, jcfg, JE.SpecConfig(backend="xla", **common),
        jnp.asarray(prompt), jtables, eos_id=jnp.asarray(eos))
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))
    np.testing.assert_array_equal(blen.numpy(), np.asarray(jblen))
    for key in STATS:
        np.testing.assert_array_equal(stats[key].numpy(),
                                      np.asarray(jstats[key]), err_msg=key)
    assert int(blen[1]) == P + MAX_NEW and int(blen[0]) < P + MAX_NEW


# ---------------------------------------------------------------------------
# (f) continuous tree serving
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def bench():
    jcfg = dataclasses.replace(bench_config(), backend="xla")
    jparams, cfg, params = _port(jcfg, 2)
    jtables = JServingEngine(jparams, jcfg, JE.SpecConfig(k=4, w=3)).tables
    return jcfg, jparams, jtables, cfg, params, _port_tables(jtables)


@pytest.mark.parametrize("paged", [False, True], ids=["linear", "paged"])
def test_continuous_tree_matches_jax_engine(bench, paged):
    """Seven requests over 3 slots (a 9-page pool when paged, so the queue
    head is deferred): outputs, calls, histograms and pool stats equal JAX's
    engine, each output equals greedy_reference, every page comes back."""
    jcfg, jparams, jtables, cfg, params, tables = bench
    common = dict(max_batch=3, buckets=(16, 32), max_new_cap=14,
                  paged=paged, num_pages=9 if paged else None, page_size=8)
    tree = dict(k=3, w=3, tree=True, tree_branch=2)
    jeng = JServingEngine(jparams, jcfg,
                          JE.SpecConfig(backend="xla", **tree),
                          tables=jtables, **common)
    eng = ServingEngine(params, cfg, E.SpecConfig(**tree), tables=tables,
                        device="cpu", **common)
    work = []
    for i in range(7):
        text = f"def f{i}(x): return x * {i} + 1"
        work.append(((text * 2)[:30] if i % 3 == 1 else text[:14],
                     (6, 10, 14)[i % 3]))
    outs = []
    for e in (eng, jeng):
        for text, mnt in work:
            e.submit(text, max_new_tokens=mnt)
        outs.append(sorted(e.serve_continuous(),
                           key=lambda r: r.request_id))
    done, jdone = outs
    assert len(done) == len(jdone) == len(work)
    for r, jr, (_, mnt) in zip(done, jdone, work):
        np.testing.assert_array_equal(r.output_ids, jr.output_ids)
        for key in ("new_tokens", "model_calls", "accept_hist"):
            assert r.stats[key] == jr.stats[key], key
        assert r.stats["new_tokens"] == mnt
        toks = eng.scheduler.pad_to_bucket(eng.tok.encode(r.prompt))
        ref = E.greedy_reference(params, cfg, toks[None], mnt, device="cpu")
        np.testing.assert_array_equal(r.output_ids,
                                      ref[0, len(toks):].numpy())
    assert sum(r.stats["model_calls"] for r in done) < sum(
        m for _, m in work)
    if paged:
        stats = eng.pool_stats()
        assert stats == jeng.pool_stats()
        assert stats["deferrals"] > 0 and stats["free_pages"] == 9
        assert C.check_page_invariants(eng._cont_state.model)["free"] == 9


def test_tree_serve_all_matches_jax_engine(bench):
    jcfg, jparams, jtables, cfg, params, tables = bench
    tree = dict(k=4, w=5, tree=True, tree_branch=2)
    jeng = JServingEngine(jparams, jcfg, JE.SpecConfig(backend="xla", **tree),
                          tables=jtables, buckets=(32,))
    eng = ServingEngine(params, cfg, E.SpecConfig(**tree), tables=tables,
                        buckets=(32,), device="cpu")
    for p in ("a = a + 1; a = a + 1; a =", "for i in range(3): for i in"):
        jeng.submit(p, max_new_tokens=12)
        eng.submit(p, max_new_tokens=12)
    for r, jr in zip(sorted(eng.serve_all(), key=lambda r: r.request_id),
                     sorted(jeng.serve_all(), key=lambda r: r.request_id)):
        np.testing.assert_array_equal(r.output_ids, jr.output_ids)
        for key in ("new_tokens", "model_calls", "tokens_per_call",
                    "accept_hist"):
            assert r.stats[key] == jr.stats[key], key


# ---------------------------------------------------------------------------
# (g) configuration errors
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bad", [dict(strategy="greedy"), dict(w=0),
                                 dict(tree_branch=0)])
def test_validate_tree_errors_match_jax(bad):
    with pytest.raises(ValueError) as jerr:
        JE.SpecConfig(tree=True, **bad).validate_tree()
    with pytest.raises(ValueError) as err:
        E.SpecConfig(tree=True, **bad).validate()
    assert str(err.value) == str(jerr.value)
    E.SpecConfig(tree=False, **bad).validate_tree()       # tree off: no-op


def test_tree_needs_an_attention_only_arch(tiny_hybrid_cfg):
    cfg = ModelConfig.from_reference(tiny_hybrid_cfg)
    assert M.has_recurrent(cfg)
    with pytest.raises(ValueError, match="attention-only"):
        ServingEngine(None, cfg, E.SpecConfig(k=2, w=2, tree=True),
                      device="cpu")
    with pytest.raises(ValueError, match="attention-only"):
        JServingEngine(None, tiny_hybrid_cfg,
                       JE.SpecConfig(k=2, w=2, tree=True))
