"""The port's paged KV cache (repro_torch.models.cache, K3's plain version,
paged ``generate``) against the JAX reference, on the CPU.

  - page bookkeeping: the same alloc / grow / free / insert sequence through
    ``repro.models.cache`` and the port leaves equal page tables, n_pages,
    free lists, free_top and pool pages, with ``check_page_invariants``
    holding on both;
  - ``phys_slots`` gives the reference's sentinel, and a dropped write lands
    on the port's trash page only;
  - K3's plain version equals the reference's Pallas paged kernel in
    interpret mode within f32 2e-5 / bf16 2e-2 (the kernel tolerance);
  - paged ``generate`` equals the port's linear ``generate`` and JAX's paged
    ``generate`` for every strategy: tokens and stats exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import spec_engine as JE
from repro.kernels import ops as jops
from repro.models import cache as JC
from repro.models import model as JM
from repro.serving.engine import ServingEngine as JServingEngine
from repro.train.checkpoint import _flatten
from repro_torch.core import spec_engine as E
from repro_torch.core.ngram_tables import NGramTables
from repro_torch.kernels import dispatch
from repro_torch.models import cache as C
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


TOL = {"float32": 2e-5, "bfloat16": 2e-2}
STRATEGIES = ["mixed", "bigram", "unigram", "context", "greedy"]
MAX_NEW = 14


@pytest.fixture(scope="module")
def tiny(tiny_dense_cfg):
    """The tiny GQA model on the XLA backend, its tables, and the port's
    copies."""
    jcfg = dataclasses.replace(tiny_dense_cfg, backend="xla")
    jparams = JM.init_params(jax.random.PRNGKey(0), jcfg)
    jtables = JServingEngine(jparams, jcfg, JE.SpecConfig(k=4, w=3)).tables
    cfg = ModelConfig.from_reference(jcfg)
    params = from_jax_flat(_flatten(jparams), cfg, device="cpu")
    tables = NGramTables(*(torch.from_numpy(np.array(a)) for a in
                           (jtables.unigram_topk, jtables.bigram_topk,
                            jtables.bigram_chain)))
    return jcfg, jparams, jtables, cfg, params, tables


def _assert_books_equal(st, jst):
    N = C.paged_dims(st)[0]
    for key in ("page_table", "n_pages"):
        np.testing.assert_array_equal(st[key].numpy(), np.asarray(jst[key]),
                                      err_msg=key)
    np.testing.assert_array_equal(st["free_list"][:N].numpy(),
                                  np.asarray(jst["free_list"]))
    assert int(st["free_top"]) == int(jst["free_top"])
    assert C.check_page_invariants(st) == JC.check_page_invariants(jst)


# ---------------------------------------------------------------------------
# page bookkeeping
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_page_bookkeeping_matches_jax(tiny, seed):
    """Random churn of alloc, batched grow (exhaustion included), free and
    a prefilled-row insert: the books and the pool stay equal to JAX's."""
    jcfg, _, _, cfg, _, _ = tiny
    B, N, ps, pps = 4, 12, 4, 5
    jst = JC.init_paged_state(jcfg, B, N, ps, pps)
    st = C.init_paged_state(cfg, B, N, ps, pps, device="cpu")
    rng = np.random.default_rng(seed)
    for _ in range(24):
        op = rng.integers(0, 4)
        slot = int(rng.integers(0, B))
        if op == 0:
            n = int(rng.integers(0, 3))
            if int(st["free_top"]) >= n and int(st["n_pages"][slot]) + n <= pps:
                jst = JC.alloc_slot_pages(jst, jnp.int32(slot), n)
                C.alloc_slot_pages(st, slot, n)
        elif op == 1:
            req = rng.integers(0, pps * ps + 1, B).astype(np.int32)
            act = rng.random(B) < 0.6
            jst = JC.grow_pages(jst, jnp.asarray(req), jnp.asarray(act))
            C.grow_pages(st, torch.from_numpy(req), torch.from_numpy(act))
        elif op == 2:
            jst = JC.free_slot_pages(jst, jnp.int32(slot))
            C.free_slot_pages(st, slot)
        else:
            # a batch-1 linear row of row_len positions into fresh pages
            row_len = int(rng.integers(1, 3 * ps))
            need = int(C.pages_for_len(row_len, ps))
            jst = JC.free_slot_pages(jst, jnp.int32(slot))
            C.free_slot_pages(st, slot)
            if int(st["free_top"]) < need:
                continue
            jst = JC.alloc_slot_pages(jst, jnp.int32(slot), need)
            C.alloc_slot_pages(st, slot, need)
            jrow = JM.init_state(jcfg, 1, row_len)
            for g in jrow["groups"].values():
                for name in ("k", "v"):
                    g[name] = jnp.asarray(rng.normal(size=g[name].shape),
                                          jnp.float32)
            jrow["cur_len"] = jnp.full((1,), row_len, jnp.int32)
            row = {"cur_len": torch.tensor([row_len], dtype=torch.int32),
                   "groups": {gid: {n: torch.from_numpy(np.array(a))
                                    for n, a in g.items()}
                              for gid, g in jrow["groups"].items()}}
            jst = JC.insert_slot_paged(jst, jrow, jnp.int32(slot), row_len)
            C.insert_slot_paged(st, row, slot, row_len)
        _assert_books_equal(st, jst)
    for gid, g in st["groups"].items():
        for name in ("k", "v"):
            np.testing.assert_array_equal(
                g[name][:, :N].numpy(), np.asarray(jst["groups"][gid][name]))
    np.testing.assert_array_equal(st["cur_len"].numpy(),
                                  np.asarray(jst["cur_len"]))
    for slot in range(B):
        jst = JC.free_slot_pages(jst, jnp.int32(slot))
        C.free_slot_pages(st, slot)
        C.free_slot_pages(st, slot)          # idempotent
    _assert_books_equal(st, jst)
    assert int(st["free_top"]) == N, "leaked pages after churn"


@pytest.mark.parametrize("paged", [False, True], ids=["linear", "paged"])
def test_reset_slot_matches_jax(tiny, paged):
    """reset_slot empties one slot (zeroed KV, or its pages freed) and
    leaves the others, as the reference's does."""
    jcfg, _, _, cfg, _, _ = tiny
    rng = np.random.default_rng(5)
    if paged:
        jst = JC.init_paged_state(jcfg, 3, 9, 4, 3)
        st = C.init_paged_state(cfg, 3, 9, 4, 3, device="cpu")
        for slot, n in ((0, 2), (1, 3), (2, 1)):
            jst = JC.alloc_slot_pages(jst, jnp.int32(slot), n)
            C.alloc_slot_pages(st, slot, n)
    else:
        jst = JM.init_state(jcfg, 3, 12)
        st = C.init_state(cfg, 3, 12, device="cpu")
    N = C.paged_dims(st)[0] if paged else None       # the real pages
    for gid, g in jst["groups"].items():
        for name in ("k", "v"):
            g[name] = jnp.asarray(rng.normal(size=g[name].shape), jnp.float32)
            st["groups"][gid][name][:, :N] = torch.from_numpy(
                np.array(g[name]))
    cur = np.array([5, 9, 3], np.int32)
    jst["cur_len"], st["cur_len"] = jnp.asarray(cur), torch.from_numpy(cur)
    jst = JC.reset_slot(jcfg, jst, jnp.int32(1))
    C.reset_slot(cfg, st, 1)
    np.testing.assert_array_equal(st["cur_len"].numpy(), [5, 0, 3])
    np.testing.assert_array_equal(st["cur_len"].numpy(),
                                  np.asarray(jst["cur_len"]))
    for gid, g in st["groups"].items():
        for name in ("k", "v"):
            np.testing.assert_array_equal(
                g[name][:, :N].numpy(), np.asarray(jst["groups"][gid][name]))
    if paged:
        _assert_books_equal(st, jst)


def test_phys_slots_sentinel_and_dropped_writes_match_jax(tiny):
    """Unallocated pages, positions past the table and negative positions
    map to num_pages*ps, the reference's out-of-bounds sentinel; the port's
    write of them lands on the trash page, and every real page equals the
    reference's dropping scatter."""
    jcfg, _, _, cfg, _, _ = tiny
    N, ps, KV, hd = 6, 4, cfg.num_kv_heads, cfg.resolved_head_dim
    pt = np.array([[3, -1, 5], [0, 2, -1]], np.int32)
    pos = np.array([[0, 3, 4, 9, 12, -1], [1, 5, 8, 11, 13, 7]], np.int32)
    phys = C.phys_slots(torch.from_numpy(pt), torch.from_numpy(pos), ps, N)
    jphys = JC.phys_slots(jnp.asarray(pt), jnp.asarray(pos), ps, N)
    np.testing.assert_array_equal(phys.numpy(), np.asarray(jphys))
    assert (phys.numpy() == N * ps).sum() == 6
    rng = np.random.default_rng(3)
    pool = rng.normal(size=(N + 1, ps, KV, hd)).astype(np.float32)
    new = rng.normal(size=(2, 6, KV, hd)).astype(np.float32)
    gate = rng.random((2, 6)) < 0.7
    kp, vp = torch.from_numpy(pool.copy()), torch.from_numpy(pool.copy())
    C.paged_kv_write(kp, vp, torch.from_numpy(new), torch.from_numpy(new),
                     phys, gate=torch.from_numpy(gate))
    jk, _ = JC.paged_kv_write(jnp.asarray(pool[:N]), jnp.asarray(pool[:N]),
                              jnp.asarray(new), jnp.asarray(new), jphys,
                              gate=jnp.asarray(gate))
    np.testing.assert_array_equal(kp[:N].numpy(), np.asarray(jk))
    np.testing.assert_array_equal(vp[:N].numpy(), np.asarray(jk))
    assert not np.array_equal(kp[N].numpy(), pool[N])   # the trash page


# ---------------------------------------------------------------------------
# K3's plain version against the reference's paged kernel (interpret mode)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,K,W1,H,KV,hd,ps,pt,cur", [
    (2, 3, 4, 4, 2, 16, 4, [[5, 2, 9, -1], [0, 7, -1, -1]], [10, 5]),
    (2, 2, 3, 4, 1, 32, 8, [[1, 3, -1], [-1, -1, -1]], [13, 0]),
    (3, 1, 1, 4, 4, 16, 8, [[4, 0], [2, -1], [1, 3]], [16, 3, 9]),
])
def test_paged_plain_matches_jax_paged_kernel(B, K, W1, H, KV, hd, ps, pt,
                                              cur, dtype):
    NP = 10
    rng = np.random.default_rng(B * 10 + ps)
    sh = lambda *s: rng.normal(size=s).astype(np.float32)
    q, kt, vt = sh(B, K, W1, H, hd), sh(B, K, W1, KV, hd), sh(B, K, W1, KV, hd)
    kp, vp = sh(NP, ps, KV, hd), sh(NP, ps, KV, hd)
    pt, cur = np.asarray(pt, np.int32), np.asarray(cur, np.int32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jops.paged_spec_attention_op(
        *(jnp.asarray(a, jd) for a in (q, kp, vp)), jnp.asarray(pt),
        *(jnp.asarray(a, jd) for a in (kt, vt)), jnp.asarray(cur), w1=W1,
        interpret=True)
    t = lambda a: torch.from_numpy(a).to(td)
    got = dispatch.verify_attention_paged(
        t(q), t(kp), t(vp), torch.from_numpy(pt), t(kt), t(vt),
        torch.from_numpy(cur), w1=W1)
    assert got.dtype == td and got.shape == (B, K, W1, H, hd)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


# ---------------------------------------------------------------------------
# paged generate
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_paged_generate_matches_linear_and_jax(tiny, strategy):
    jcfg, jparams, jtables, cfg, params, tables = tiny
    prompt = np.random.default_rng(1).integers(0, 7, (3, 10)).astype(
        np.int32)
    spec = E.SpecConfig(k=4, w=3, strategy=strategy, max_new_tokens=MAX_NEW)
    jspec = JE.SpecConfig(k=4, w=3, strategy=strategy,
                          max_new_tokens=MAX_NEW)
    paged, jpaged = E.PagedConfig(page_size=4), JE.PagedConfig(page_size=4)
    buf, blen, stats = E.generate(params, cfg, spec, prompt, tables,
                                  paged=paged, device="cpu")
    lbuf, lblen, lstats = E.generate(params, cfg, spec, prompt, tables,
                                     device="cpu")
    jbuf, jblen, jstats = JE.generate(jparams, jcfg, jspec,
                                      jnp.asarray(prompt), jtables,
                                      paged=jpaged)
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))
    np.testing.assert_array_equal(buf[:, :lbuf.shape[1]].numpy(),
                                  lbuf.numpy())
    np.testing.assert_array_equal(blen.numpy(), np.asarray(jblen))
    np.testing.assert_array_equal(blen.numpy(), lblen.numpy())
    for key in ("calls", "tokens", "accept_hist", "rank_hist", "alloc_ctx",
                "accepted_ctx", "accepted_bigram"):
        np.testing.assert_array_equal(stats[key].numpy(),
                                      np.asarray(jstats[key]), err_msg=key)
        np.testing.assert_array_equal(stats[key].numpy(),
                                      lstats[key].numpy(), err_msg=key)
