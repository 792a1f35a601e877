"""Sharded serving on a real mesh: four gloo ranks on the CPU (the port's
counterpart of ``tests/test_sharded_serving.py``, which needs placeholder
XLA devices and skips in this suite).

The contract: a ``ServingEngine(mesh=...)`` (params placed by
``params_shardings``, the DecodeState by ``decode_state_shardings``, the
activation sharder scoped to the engine's own calls) serves the same
tokens as the same engine without a mesh, and as the JAX package's engine
on the same weights, for one-shot ``generate`` (static batches) and the
continuous drive, for every drafting strategy, over the linear and the
paged layout, adaptive included; the state's placements and each rank's
local storages are a fixed point of step, admit and release.

One spawned group of four ranks (``torch_mesh_worker.py``, rendezvous
through a file, joined with a deadline) runs every meshed case while this
process runs the unmeshed port and JAX; each test then reads its part.
"""
import dataclasses
import pickle
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro.configs import get_smoke_config as j_get_smoke_config
from repro.core import spec_engine as JE
from repro.models import model as JM
from repro.models.config import ModelConfig as JModelConfig
from repro.serving.engine import ServingEngine as JServingEngine
from repro.train.checkpoint import _flatten
from repro_torch.configs import get_smoke_config
from repro_torch.core.ngram_tables import NGramTables
from repro_torch.models.config import ModelConfig
from repro_torch.models.weights import from_jax_flat
from repro_torch.serving.engine import ServingEngine

import torch_mesh_worker as W

WORLD = 4
DEADLINE_S = 300.0


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh_tiny():
    """The reference's mesh-tiny (2 layers, d 64, 4 heads / 2 kv, f32) with
    the byte vocabulary (259: the port's embedding refuses the ids >= 61
    that the reference's clamps; 259 divides no axis either)."""
    kw = dict(name="mesh-tiny", num_layers=2, d_model=64, num_heads=4,
              num_kv_heads=2, d_ff=128, vocab_size=259)
    jcfg = JModelConfig(**kw, param_dtype=jnp.float32,
                        compute_dtype=jnp.float32, backend="xla").validate()
    cfg = ModelConfig(**kw, param_dtype=torch.float32,
                      compute_dtype=torch.float32).validate()
    return jcfg, cfg


def _j_serve(eng, mode="continuous", prompts=W.PROMPTS):
    reqs = [eng.submit(p, max_new_tokens=m) for p, m in prompts]
    done = eng.serve_continuous() if mode == "continuous" else eng.serve_all()
    by_id = {r.request_id: r for r in done}
    return [(np.asarray(by_id[r.request_id].output_ids),
             by_id[r.request_id].stats["new_tokens"],
             by_id[r.request_id].stats["model_calls"]) for r in reqs]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(meshed results from rank 0, the unmeshed port's, JAX's)."""
    tmp = tmp_path_factory.mktemp("mesh")
    jcfg, cfg = _mesh_tiny()
    jparams = JM.init_params(jax.random.PRNGKey(0), jcfg)
    params = from_jax_flat(_flatten(jparams), cfg, device="cpu")
    jtables = JServingEngine(jparams, jcfg, JE.SpecConfig(k=4, w=3)).tables
    tables = NGramTables(*(torch.from_numpy(np.array(a)) for a in (
        jtables.unigram_topk, jtables.bigram_topk, jtables.bigram_chain)))
    jmcfg = dataclasses.replace(j_get_smoke_config("mixtral-8x7b"),
                                backend="xla")
    jmparams = JM.init_params(jax.random.PRNGKey(1), jmcfg)
    mcfg = get_smoke_config("mixtral-8x7b")
    mparams = from_jax_flat(_flatten(jmparams), mcfg, device="cpu")
    data_path, out_path = str(tmp / "data.pkl"), str(tmp / "out.pkl")
    with open(data_path, "wb") as f:
        pickle.dump(dict(cfg=cfg, params=params, tables=tables,
                         moe_cfg=mcfg, moe_params=mparams), f)
    init = "file://" + str(tmp / "rendezvous")
    t0 = time.monotonic()
    ctx = mp.start_processes(W.run, args=(WORLD, init, data_path, out_path),
                             nprocs=WORLD, join=False, start_method="spawn")
    try:
        # while the ranks run: the unmeshed port and JAX on the same weights
        plain, jax_out = {}, {}

        def eng(strategy, **kw):
            tb = tables if strategy != "greedy" or kw.get("adaptive") \
                else None
            return ServingEngine(params, cfg, W.spec(strategy), tables=tb,
                                 **W.engine_kw(**kw))

        def jeng(strategy, c=jcfg, p=jparams, tb=jtables, **kw):
            kw = dict(W.engine_kw(**kw))
            kw.pop("device")
            return JServingEngine(
                p, c, JE.SpecConfig(k=4, w=3, strategy=strategy,
                                    max_new_tokens=16),
                tables=tb if strategy != "greedy" else None, **kw)
        for s in W.STRATEGIES:
            plain[f"static/{s}"] = W.serve(eng(s), "static")
            plain[f"continuous/{s}"] = W.serve(eng(s))
            je = jeng(s)
            jax_out[f"static/{s}"] = _j_serve(je, "static")
            jax_out[f"continuous/{s}"] = _j_serve(je)
        for s in ("greedy", "mixed"):
            plain[f"paged/{s}"] = W.serve(eng(s, paged=True, page_size=8))
            jax_out[f"paged/{s}"] = _j_serve(jeng(s, paged=True,
                                                  page_size=8))
        plain["adaptive"] = W.serve(eng("mixed", adaptive=True,
                                        arms=W.ARMS))
        jax_out["adaptive"] = _j_serve(jeng("mixed", adaptive=True,
                                            arms=W.ARMS))
        plain["sampled"] = W.serve(eng("mixed"), sampled=(1, 3))
        plain["shape"] = W.serve(eng("mixed"), prompts=W.PROMPTS[:3])
        plain["moe"] = W.serve(ServingEngine(mparams, mcfg, W.spec("greedy"),
                                             **W.engine_kw()))
        plain["tables"] = ServingEngine(params, cfg, W.spec("mixed"),
                                        **W.engine_kw()).tables
        jax_out["moe"] = _j_serve(jeng("greedy", c=jmcfg, p=jmparams,
                                       tb=None))
        # join the ranks with a deadline: a hang fails, never waits
        while not ctx.join(timeout=1.0):
            if time.monotonic() - t0 > DEADLINE_S:
                raise TimeoutError(f"the {WORLD} ranks ran past "
                                   f"{DEADLINE_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    with open(out_path, "rb") as f:
        meshed = pickle.load(f)
    assert "error" not in meshed, meshed.get("error")
    print(f"\nmeshed ranks {time.monotonic() - t0:.1f} s; per case: "
          + ", ".join(f"{k} {v:.1f}" for k, v in meshed["seconds"].items()))
    return meshed, plain, jax_out


def _same(a, b, what):
    assert len(a) == len(b), what
    for i, (x, y) in enumerate(zip(a, b)):
        np.testing.assert_array_equal(x[0], y[0], err_msg=f"{what} #{i}")
        assert x[1:3] == y[1:3], (what, i, x[1:3], y[1:3])


@pytest.mark.parametrize("strategy", W.STRATEGIES)
def test_generate_sharded_parity(runs, strategy):
    meshed, plain, jax_out = runs
    key = f"static/{strategy}"
    _same(meshed[key], plain[key], key)
    _same(plain[key], jax_out[key], key + " vs JAX")
    assert all(r[1] > 0 for r in meshed[key])


@pytest.mark.parametrize("strategy", W.STRATEGIES)
def test_continuous_sharded_parity(runs, strategy):
    meshed, plain, jax_out = runs
    key = f"continuous/{strategy}"
    _same(meshed[key], plain[key], key)
    _same(plain[key], jax_out[key], key + " vs JAX")
    assert not meshed["installed_after"], "engine leaked its mesh globally"


@pytest.mark.parametrize("strategy", ["greedy", "mixed"])
def test_continuous_sharded_parity_paged(runs, strategy):
    meshed, plain, jax_out = runs
    key = f"paged/{strategy}"
    _same(meshed[key], plain[key], key)
    _same(plain[key], jax_out[key], key + " vs JAX")
    _same(meshed[key], plain[f"continuous/{strategy}"], key + " vs linear")


def test_adaptive_sharded_parity(runs):
    meshed, plain, jax_out = runs
    _same(meshed["adaptive"], plain["adaptive"], "adaptive")
    _same(plain["adaptive"], jax_out["adaptive"], "adaptive vs JAX")
    for ids, new, calls, pulls in meshed["adaptive"]:
        assert pulls == calls


@pytest.mark.parametrize("which", ["linear", "paged/greedy", "paged/mixed"])
def test_state_placement_is_a_fixed_point(runs, which):
    """Every leaf keeps the placements ``decode_state_pspec`` gives it and
    its local storage across every step, admit and release."""
    bad, calls = runs[0][f"fixed_point/{which}"]
    assert bad == []
    assert calls["step"] > 0 and calls["admit"] == 5
    assert calls["release"] == 5


def test_meshed_then_plain_engine_keeps_the_kernel_route(runs):
    """A meshed engine leaves no mesh installed: the next engine in the
    process takes its config's own verify route (no ``plain_verify`` for
    this config) on plain tensors."""
    meshed, plain, _ = runs
    assert meshed["then_plain_counters"] == (0, 0)
    _same(meshed["then_plain"], plain["continuous/mixed"][:2], "then_plain")


def test_mesh_pins_the_kernels_with_a_warning(runs):
    """The reference's counterpart (``test_mesh_pins_xla_backend_with_
    warning``) checks that its mesh pins the Pallas kernels, with a
    warning.  The port pins nothing, so there is nothing to warn of: the
    meshed step hands every kernel entry point (the drafter's and the
    verify's ``dispatch.on_card`` choice) this rank's local tensors, never
    a DTensor, so on the card the kernels launch as without a mesh (phase
    14a of ``chip_smoke.py`` counts them), and ``plain_verify`` runs only
    for the configs whose own path it is."""
    meshed = runs[0]
    assert meshed["pin_warning"] == []
    route, n_verify = meshed["mixed_counters"]
    steps = meshed["fixed_point/linear"][1]["step"]
    # a mixed step: the drafter once, then the verify once a layer (2)
    assert steps > 0 and route == {"Tensor": 3 * steps, "DTensor": 0}, (
        route, steps)
    assert n_verify == 0
    assert meshed["report/linear"]["backend"] == "plain"   # the CPU's


def test_mesh_builds_its_tables_through_the_sharded_model(runs):
    """A meshed engine given no tables sweeps the vocabulary through the
    sharded model, its unigrams from the caller's whole embeddings: the
    tables of the engine without a mesh."""
    meshed, plain, _ = runs
    for name, a in zip(("unigram_topk", "bigram_topk", "bigram_chain"),
                       meshed["tables"]):
        np.testing.assert_array_equal(
            a, getattr(plain["tables"], name).numpy(), err_msg=name)


def test_mesh_places_each_parameter_shard_alone(runs):
    """Each rank copies only its own shard of each parameter to its
    device: a local tensor owns a storage of exactly its shard's bytes
    (no view into a whole copy), and their sum is the rules' shards'."""
    got = runs[0]["param_bytes"]
    assert got["exact_storages"], got
    assert got["local"] == got["want_local"] < got["global"], got
    assert runs[0]["report/linear"]["params_bytes"]["local"] == got["local"]


def test_mesh_report_shows_sharded_state(runs):
    rep = runs[0]["report/linear"]
    assert rep["mesh"] == {"data": 2, "model": 2}
    assert rep["params_sharded"] > 0
    specs = rep["state_specs"]
    assert "'data'" in specs["buf"]                  # slots over data
    assert "'data'" in specs["model/groups/p0/k"]    # cache batch over data
    assert "'model'" in specs["model/groups/p0/k"]   # kv heads over model
    assert rep["state_sharded"] >= 3
    # vocab 259 divides nothing on a (2,2) mesh: surfaced, not silent
    assert ["vocab", 259] in rep["replication_fallbacks"]
    kv = rep["kv_bytes"]
    assert kv["local"] * 4 == kv["global"]


def test_paged_pool_sharded_and_free_list_replicated(runs):
    meshed = runs[0]
    for s in ("greedy", "mixed"):
        specs = meshed[f"report/paged/{s}"]["state_specs"]
        pool = specs["model/groups/p0/k"]
        assert "'data'" in pool and "'model'" in pool
        assert specs["model/free_list"] == "(None,)"
        assert "'data'" in specs["model/page_table"]
        stats = meshed[f"pool/paged/{s}"]
        assert stats["free_pages"] == stats["num_pages"]  # no leaks


@pytest.mark.parametrize("shape", ["2x2", "1x4", "4x1"])
def test_every_dividing_mesh_shape_is_lossless(runs, shape):
    """(1, 4) runs a 40-slot buffer: 2 kv heads divide no 4 ranks, so the
    cache's SEQUENCE goes over "model" (read gathered, each write on the
    shard that holds its slot); (4, 1) gives each rank one slot."""
    meshed, plain, _ = runs
    got = (meshed["continuous/mixed"][:3] if shape == "2x2"
           else meshed[f"shape/{shape}"])
    _same(got, plain["shape"], shape)
    want = {"1x4": "(None, 'data', 'model', None, None)",
            "4x1": "(None, 'data', None, 'model', None)"}
    if shape in want:
        specs = meshed[f"report/{shape}"]["state_specs"]
        assert specs["model/groups/p0/k"] == want[shape]


def test_meshed_logits_match_unmeshed(runs):
    """Prefill and verify logits on the same rows: within f32 1e-5 (the
    row-parallel products reduce over the model axis in another order),
    the same argmax."""
    dp, dv, same_p, same_v = runs[0]["logits"]
    assert dp < 1e-5 and dv < 1e-5, (dp, dv)
    assert same_p and same_v


def test_sampled_rows(runs):
    """Temperature-0 rows beside sampled ones stay the unmeshed tokens;
    the sampled rows are reproducible per mesh configuration (their
    equality with the unmeshed rows is reported, not required)."""
    meshed, plain, _ = runs
    for i, (a, b) in enumerate(zip(meshed["sampled"], plain["sampled"])):
        if i in (1, 3):
            assert a[1] == len(a[0]) and (a[0] < 259).all()
            print(f"sampled row {i}: equal to the unmeshed tokens: "
                  f"{np.array_equal(a[0], b[0])}")
        else:
            np.testing.assert_array_equal(a[0], b[0])


def test_moe_sharded_parity(runs):
    """mixtral-smoke, greedy continuous on the (2, 2) mesh: the experts
    sharded over "model" by the 3-D rule, the capacity ranks over all of a
    call's tokens."""
    meshed, plain, jax_out = runs
    _same(meshed["moe"], plain["moe"], "moe")
    _same(plain["moe"], jax_out["moe"], "moe vs JAX")
    specs = meshed["moe_report"]
    assert specs["params_sharded"] > 0


@pytest.mark.parametrize("layout", ["linear", "paged"])
def test_one_step_collectives(runs, layout):
    """One continuous mixed step on the (2, 2) mesh, under CommDebugMode:
    its collectives by kind and bytes.  The linear step gathers no KV-cache
    leaf and no whole parameter: every all-gather is smaller than the
    smallest KV leaf, and every parameter gathered over "data" keeps its
    "model" shard (half its global bytes here).  The paged step reads its
    pool through the gathered view (the pool's page shards, gathered per
    layer): reported, not bounded."""
    got = runs[0][f"collectives/{layout}"]
    print(f"\n{layout} step on (2,2): counts {got['counts']}; by kind "
          f"(n, bytes, largest): {got['by_kind']}; KV leaf bytes "
          f"{sorted(set(got['kv_leaf_bytes']))}; param gathers "
          f"{len(got['param_gathers'])}, "
          f"{sum(a for a, _ in got['param_gathers'])} bytes")
    assert sum(got["counts"].values()) > 0
    assert got["param_gathers"]
    for after, whole in got["param_gathers"]:
        assert after < whole
    if layout == "linear":
        n, tot, most = got["by_kind"].get("all_gather_into_tensor",
                                          (0, 0, 0))
        assert most < min(got["kv_leaf_bytes"])
