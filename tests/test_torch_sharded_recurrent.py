"""The recurrent mixers under a mesh: four gloo ranks on the CPU serve
jamba-smoke (Mamba with its MoE FFN, plus attention) and xlstm-smoke
(mLSTM, sLSTM), both with the byte vocabulary of 259.

The contract: over the (2, 2), (1, 4) and (4, 1) meshes a
``ServingEngine(mesh=...)`` serves the tokens of the same engine without a
mesh and of the JAX package's engine on the same weights, static and
continuous, greedy and mixed, over the linear and (jamba-smoke) the paged
layout, adaptive on one case; xlstm-smoke with two heads on (1, 4) shards
its mLSTM C and sLSTM state over the head dims (the rules' fallback);
logits agree within f32 1e-5; a step gathers no recurrent state leaf and
no parameter whole; the state's placements and local storages are a fixed
point of step, admit and release.

One spawned group of four ranks (``torch_mesh_worker.recurrent_cases``)
runs every meshed case while this process runs the unmeshed port and
JAX; each test then reads its part.
"""
import dataclasses
import pickle
import time

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro.configs import get_smoke_config as j_get_smoke_config
from repro.core import spec_engine as JE
from repro.models import model as JM
from repro.serving.engine import ServingEngine as JServingEngine
from repro.train.checkpoint import _flatten
from repro_torch.configs import get_smoke_config
from repro_torch.core.ngram_tables import NGramTables
from repro_torch.models.weights import from_jax_flat
from repro_torch.serving.engine import ServingEngine

import torch_mesh_worker as W

WORLD = 4
# a hang guard: the whole file took ~95 s alone, 216 s in a six-worker run
DEADLINE_S = 600.0
ARCHS = {"jamba": "jamba-1.5-large-398b", "xlstm": "xlstm-125m",
         "xlstm-h2": "xlstm-125m"}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(name):
    """(JAX config, port config) of ``name``: the smoke config with the
    byte vocabulary (259 divides no axis); ``xlstm-h2`` with 2 heads."""
    kw = dict(vocab_size=259)
    if name == "xlstm-h2":
        kw.update(num_heads=2, num_kv_heads=2)
    jcfg = dataclasses.replace(j_get_smoke_config(ARCHS[name]),
                               backend="xla", **kw).validate()
    cfg = dataclasses.replace(get_smoke_config(ARCHS[name]), **kw).validate()
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
    tmp = tmp_path_factory.mktemp("mesh_recurrent")
    models, jmodels = {}, {}
    for i, name in enumerate(ARCHS):
        jcfg, cfg = _configs(name)
        jparams = JM.init_params(jax.random.PRNGKey(i), jcfg)
        params = from_jax_flat(_flatten(jparams), cfg, device="cpu")
        jtables = JServingEngine(jparams, jcfg, JE.SpecConfig(k=4, w=3)).tables
        tables = NGramTables(*(torch.from_numpy(np.array(a)) for a in (
            jtables.unigram_topk, jtables.bigram_topk, jtables.bigram_chain)))
        models[name] = (cfg, params, tables)
        jmodels[name] = (jcfg, jparams, jtables)
    data_path, out_path = str(tmp / "data.pkl"), str(tmp / "out.pkl")
    with open(data_path, "wb") as f:
        pickle.dump(models, f)
    init = "file://" + str(tmp / "rendezvous")
    t0 = time.monotonic()
    ctx = mp.start_processes(
        W.run, args=(WORLD, init, data_path, out_path, "recurrent"),
        nprocs=WORLD, join=False, start_method="spawn")
    try:
        plain, jax_out = {}, {}

        def eng(arch, strategy, **kw):
            cfg, params, tables = models[arch]
            tb = tables if strategy != "greedy" or kw.get("adaptive") \
                else None
            return ServingEngine(params, cfg, W.spec(strategy), tables=tb,
                                 **W.engine_kw(**kw))

        def jeng(arch, strategy, **kw):
            jcfg, jparams, jtables = jmodels[arch]
            kw = dict(W.engine_kw(**kw))
            kw.pop("device")
            return JServingEngine(
                jparams, jcfg, JE.SpecConfig(k=4, w=3, strategy=strategy,
                                             max_new_tokens=16),
                tables=jtables if strategy != "greedy" or kw.get("adaptive")
                else None, **kw)
        for arch in W.RECURRENT:
            for s in ("greedy", "mixed"):
                for mode in ("static", "continuous"):
                    key = f"{arch}/{mode}/{s}"
                    plain[key] = W.serve(eng(arch, s), mode)
                    jax_out[key] = _j_serve(jeng(arch, s), mode)
        for s in ("greedy", "mixed"):
            key = f"jamba/paged/{s}"
            plain[key] = W.serve(eng("jamba", s, paged=True, page_size=8))
            jax_out[key] = _j_serve(jeng("jamba", s, paged=True,
                                         page_size=8))
        plain["jamba/adaptive"] = W.serve(eng("jamba", "mixed",
                                              adaptive=True, arms=W.ARMS))
        jax_out["jamba/adaptive"] = _j_serve(jeng("jamba", "mixed",
                                                  adaptive=True,
                                                  arms=W.ARMS))
        for arch in ARCHS:
            plain[f"{arch}/shape"] = W.serve(eng(arch, "mixed"),
                                             prompts=W.PROMPTS[:3])
            jax_out[f"{arch}/shape"] = _j_serve(jeng(arch, "mixed"),
                                                prompts=W.PROMPTS[:3])
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


CASES = [f"{a}/{m}/{s}" for a in W.RECURRENT for m in ("static", "continuous")
         for s in ("greedy", "mixed")] + ["jamba/paged/greedy",
                                          "jamba/paged/mixed",
                                          "jamba/adaptive"]


@pytest.mark.parametrize("key", CASES)
def test_recurrent_sharded_parity(runs, key):
    """(2, 2): the meshed streams are the unmeshed port's and JAX's."""
    meshed, plain, jax_out = runs
    _same(meshed[key], plain[key], key)
    _same(plain[key], jax_out[key], key + " vs JAX")
    assert all(r[1] > 0 for r in meshed[key])
    if key == "jamba/adaptive":
        assert all(pulls == calls for _, _, calls, pulls in meshed[key])


@pytest.mark.parametrize("key", [f"{a}/shape/{m}" for a in W.RECURRENT
                                 for m in ("1x4", "4x1")])
def test_recurrent_every_dividing_mesh_shape_is_lossless(runs, key):
    """(1, 4) shards d_inner and the heads four ways; (4, 1) gives each
    rank one slot and shards nothing else."""
    meshed, plain, jax_out = runs
    arch, _, shape = key.split("/")
    _same(meshed[key], plain[f"{arch}/shape"], key)
    _same(plain[f"{arch}/shape"], jax_out[f"{arch}/shape"], key + " JAX")
    specs = meshed[f"{arch}/report/{shape}"]["state_specs"]
    leaf = ("model/groups/p0/ssm" if arch == "jamba"
            else "model/groups/p0/C")
    want = {"1x4": "'model'", "4x1": "'data'"}[shape]
    assert want in specs[leaf], specs[leaf]


def test_xlstm_two_heads_shard_the_head_dims(runs):
    """Two heads divide no (1, 4) "model" axis: the rules shard C's value
    dims and n's, c's, h's and m's head dims instead (the reference's
    fallback) and m of the mLSTM stays replicated; the meshed stream is
    the unmeshed port's and JAX's."""
    meshed, plain, jax_out = runs
    key = "xlstm-h2/shape/1x4"
    _same(meshed[key], plain["xlstm-h2/shape"], key)
    _same(plain["xlstm-h2/shape"], jax_out["xlstm-h2/shape"], key + " JAX")
    specs = meshed["xlstm-h2/report/1x4"]["state_specs"]
    assert specs["model/groups/p0/C"] == \
        "(None, 'data', None, 'model', None)"
    assert specs["model/groups/p0/n"] == "(None, 'data', None, 'model')"
    assert specs["model/groups/p0/m"] == "(None, 'data', None)"
    assert specs["model/groups/p1/h"] == "(None, 'data', None, 'model')"


@pytest.mark.parametrize("arch", W.RECURRENT)
def test_recurrent_state_is_sharded_on_2x2(runs, arch):
    rep = runs[0][f"{arch}/report/2x2"]
    specs = rep["state_specs"]
    if arch == "jamba":
        assert specs["model/groups/p0/ssm"] == \
            "(None, 'data', 'model', None)"
        assert specs["model/groups/p0/conv"] == \
            "(None, 'data', None, 'model')"
    else:
        assert specs["model/groups/p0/C"] == \
            "(None, 'data', 'model', None, None)"
        assert specs["model/groups/p1/c"] == \
            "(None, 'data', 'model', None)"
    assert rep["state_sharded"] >= 3


@pytest.mark.parametrize("which", ["jamba/fixed_point/linear",
                                   "jamba/fixed_point/paged/greedy",
                                   "jamba/fixed_point/paged/mixed",
                                   "xlstm/fixed_point/linear"])
def test_recurrent_state_placement_is_a_fixed_point(runs, which):
    bad, calls = runs[0][which]
    assert bad == []
    assert calls["step"] > 0 and calls["admit"] == 5
    assert calls["release"] == 5


def test_recurrent_paged_pool_drains(runs):
    for s in ("greedy", "mixed"):
        stats = runs[0][f"jamba/pool/paged/{s}"]
        assert stats["free_pages"] == stats["num_pages"]


@pytest.mark.parametrize("arch", ["jamba", "xlstm", "xlstm-h2"])
def test_recurrent_meshed_logits_match_unmeshed(runs, arch):
    """Prefill and verify logits on the same rows: within f32 1e-5 (the
    row-parallel products and the head-dim cells reduce over "model" in
    another order), the same argmax."""
    dp, dv, same_p, same_v = runs[0][f"{arch}/logits"]
    assert dp < 1e-5 and dv < 1e-5, (dp, dv)
    assert same_p and same_v


@pytest.mark.parametrize("arch", ["jamba", "xlstm", "xlstm-h2"])
def test_recurrent_step_collectives(runs, arch):
    """One continuous mixed step under CommDebugMode: its collectives by
    kind and bytes.  No collective takes a recurrent state leaf's storage
    as its input (no leaf is gathered: the mixers work on their shards),
    and every parameter gathered over "data" keeps its "model" shard,
    except the MoE router, which the rules shard over "data" alone (its
    FSDP gather, as in the reference)."""
    got = runs[0][f"{arch}/collectives"]
    print(f"\n{arch} step: counts {got['counts']}; by kind (n, bytes, "
          f"largest): {got['by_kind']}; param gathers "
          f"{len(got['param_gathers'])}")
    assert sum(got["counts"].values()) > 0
    assert got["leaves"] and got["leaves_gathered"] == []
    for after, whole in got["param_gathers"]:
        assert after < whole or whole in got["router_bytes"], (after, whole)
