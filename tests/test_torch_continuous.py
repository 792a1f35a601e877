"""The port's continuous batching (``ServingEngine.step`` /
``serve_continuous``, ``admit_slot`` / ``release_slot``) against the JAX
reference's engine, on the CPU, over the linear and the paged KV layout.

The same submits give the same per-request ``output_ids``, ``new_tokens``,
``model_calls`` and ``accept_hist``; a pool small enough to defer drains
with no leaked page and the reference's deferral count and pool stats.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from benchmarks.common import bench_config
from repro.core import spec_engine as JE
from repro.models import model as JM
from repro.serving.engine import ServingEngine as JServingEngine
from repro.train.checkpoint import _flatten
from repro_torch.core import spec_engine as E
from repro_torch.core.ngram_tables import NGramTables
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


BUCKETS = (16, 32)
PS = 8
K, W = 4, 3


@pytest.fixture(scope="module")
def bench():
    """The byte-vocabulary bench model (XLA backend), its tables, and the
    port's copies."""
    jcfg = dataclasses.replace(bench_config(), backend="xla")
    jparams = JM.init_params(jax.random.PRNGKey(2), jcfg)
    jtables = JServingEngine(jparams, jcfg, JE.SpecConfig(k=K, w=W)).tables
    cfg = ModelConfig.from_reference(jcfg)
    params = from_jax_flat(_flatten(jparams), cfg, device="cpu")
    tables = NGramTables(*(torch.from_numpy(np.array(a)) for a in
                           (jtables.unigram_topk, jtables.bigram_topk,
                            jtables.bigram_chain)))
    return jcfg, jparams, jtables, cfg, params, tables


def _workload():
    """Seven requests: every third needs the 32 bucket, budgets cycle."""
    out = []
    for i in range(7):
        text = f"def f{i}(x): return x * {i} + 1"
        text = (text * 2)[:30] if i % 3 == 1 else text[:14]
        out.append((text, (6, 10, 14)[i % 3]))
    return out


def _engines(bench, strategy, paged, max_batch=3, num_pages=None, **kw):
    jcfg, jparams, jtables, cfg, params, tables = bench
    common = dict(max_batch=max_batch, buckets=BUCKETS, max_new_cap=14,
                  paged=paged, num_pages=num_pages, page_size=PS, **kw)
    jeng = JServingEngine(jparams, jcfg,
                          JE.SpecConfig(k=K, w=W, strategy=strategy),
                          tables=jtables, **common)
    eng = ServingEngine(params, cfg, E.SpecConfig(k=K, w=W,
                                                  strategy=strategy),
                        tables=tables, device="cpu", **common)
    return jeng, eng


def _serve(eng, work, eos=None):
    for i, (text, mnt) in enumerate(work):
        eng.submit(text, max_new_tokens=mnt,
                   eos_id=-1 if eos is None else eos[i])
    return sorted(eng.serve_continuous(), key=lambda r: r.request_id)


def _assert_same_requests(done, jdone):
    assert len(done) == len(jdone)
    for r, jr in zip(done, jdone):
        np.testing.assert_array_equal(r.output_ids, jr.output_ids)
        for key in ("new_tokens", "model_calls", "accept_hist"):
            assert r.stats[key] == jr.stats[key], key


@pytest.mark.parametrize("strategy", ["mixed", "greedy"])
@pytest.mark.parametrize("paged", [False, True], ids=["linear", "paged"])
def test_continuous_matches_jax_engine(bench, strategy, paged):
    jeng, eng = _engines(bench, strategy, paged)
    work = _workload()
    done, jdone = _serve(eng, work), _serve(jeng, work)
    _assert_same_requests(done, jdone)
    assert [r.stats["new_tokens"] for r in done] == [m for _, m in work]
    if paged:
        assert eng.pool_stats() == jeng.pool_stats()
        C.check_page_invariants(eng._cont_state.model)


def test_small_pool_defers_and_drains_like_jax(bench):
    """A pool of 9 pages for 3 slots: the queue head is deferred while the
    pool is short, nothing is rejected, every page comes back, and the
    deferral rounds and pool stats equal the reference's."""
    jeng, eng = _engines(bench, "mixed", True, num_pages=9)
    work = _workload()
    done, jdone = _serve(eng, work), _serve(jeng, work)
    _assert_same_requests(done, jdone)
    stats = eng.pool_stats()
    assert stats == jeng.pool_stats()
    assert stats["deferrals"] > 0 and stats["rejected"] == 0
    assert stats["free_pages"] == 9 and stats["reserved_pages"] == 0
    assert C.check_page_invariants(eng._cont_state.model)["free"] == 9
    eng.reset_pool_counters()
    assert (eng.pool_stats()["deferrals"], eng.pool_stats()["peak_pages"],
            eng.pool_stats()["rejected"]) == (0, 0, 0)
    # the linear engine gives the same outputs
    _, lin = _engines(bench, "mixed", False)
    _assert_same_requests(_serve(lin, work), done)


@pytest.mark.parametrize("paged", [False, True], ids=["linear", "paged"])
def test_slot_reuse_no_cross_request_leakage(bench, paged):
    """One slot, several requests in turn: each output equals the request's
    isolated greedy reference (any cache residue would diverge)."""
    _, _, _, cfg, params, tables = bench
    eng = ServingEngine(params, cfg, E.SpecConfig(k=K, w=W), tables=tables,
                        max_batch=1, buckets=(16,), max_new_cap=12,
                        paged=paged, page_size=PS, device="cpu")
    prompts = ["first request", "second, unlike it", "third!"]
    reqs = [eng.submit(p, max_new_tokens=12) for p in prompts]
    done = {r.request_id: r for r in eng.serve_continuous()}
    assert len(done) == 3
    for req in reqs:
        toks = eng.scheduler.pad_to_bucket(eng.tok.encode(req.prompt))
        ref = E.greedy_reference(params, cfg, toks[None], 12, device="cpu")
        np.testing.assert_array_equal(done[req.request_id].output_ids,
                                      ref[0, len(toks):].numpy())


@pytest.mark.parametrize("paged", [False, True], ids=["linear", "paged"])
def test_eos_truncation_matches_jax(bench, paged):
    work = _workload()[:3]
    _, probe = _engines(bench, "greedy", False)
    ref = _serve(probe, work)
    eos = [int(ref[0].output_ids[3]), -1, int(ref[2].output_ids[1])]
    jeng, eng = _engines(bench, "mixed", paged)
    done, jdone = _serve(eng, work, eos), _serve(jeng, work, eos)
    _assert_same_requests(done, jdone)
    assert done[0].output_ids[-1] == eos[0] and len(done[0].output_ids) <= 4
    assert done[1].stats["new_tokens"] == work[1][1]


def test_overlong_prompt_rejected_not_truncated(bench):
    """A prompt beyond the self-sized linear buffer is REJECTED with an
    error stat, as in the reference; truncating would corrupt its output."""
    _, _, _, cfg, params, _ = bench
    eng = ServingEngine(params, cfg, E.SpecConfig(strategy="greedy"),
                        max_batch=1, max_new_cap=8, device="cpu")
    short = eng.submit("short", max_new_tokens=8)     # 32-bucket state
    eng.step()
    long = eng.submit("x" * 40, max_new_tokens=8)     # needs the 64 bucket
    with pytest.warns(UserWarning, match="rejected"):
        done = {r.request_id: r for r in eng.serve_continuous()}
    assert sorted(done) == sorted([short.request_id, long.request_id])
    assert "error" in done[long.request_id].stats
    assert done[long.request_id].output is None
    assert done[long.request_id].stats["new_tokens"] == 0
    assert done[short.request_id].stats["new_tokens"] == 8


def test_admit_step_release_keep_the_page_books(bench):
    """admit_slot, paged spec_steps (page growth) and release_slot each
    leave the page books consistent; the free slot never takes a page."""
    _, _, _, cfg, params, tables = bench
    spec = E.SpecConfig(k=K, w=W, strategy="mixed")
    st = E.empty_decode_state(cfg, spec, 2, 40, paged=E.PagedConfig(
        num_pages=8, page_size=PS), device="cpu")
    assert st.buf_size == 40 and C.paged_dims(st.model) == (8, PS, 5)
    toks = torch.arange(3, 13, dtype=torch.int32)
    st = E.admit_slot(params, cfg, st, 1, toks, 9, -1)
    assert C.check_page_invariants(st.model)["allocated"] == 2
    for _ in range(3):
        st = E.spec_step(params, cfg, spec, st, tables)
        C.check_page_invariants(st.model)
    assert int(st.model["n_pages"][0]) == 0          # the free slot
    st = E.release_slot(st, 1)
    assert C.check_page_invariants(st.model)["free"] == 8
    assert not bool(st.active.any()) and bool(st.done.all())
    assert int(st.stats["calls"].sum()) == 0


def test_new_entry_points_need_a_card_unless_cpu_is_asked_for(bench):
    _, _, _, cfg, params, tables = bench
    spec = E.SpecConfig(k=K, w=W)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(params, cfg, spec, tables=tables, paged=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        E.empty_decode_state(cfg, spec, 2, 40, paged=E.PagedConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        C.init_paged_state(cfg, 2, 4, 8, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        E.generate(params, cfg, spec, np.zeros((1, 4), np.int32), tables,
                   paged=E.PagedConfig())
