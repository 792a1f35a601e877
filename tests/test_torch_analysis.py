"""The port's contract checker (``src/repro_torch/analysis``) on the CPU:
every rule fires on its planted violation and stays quiet on the clean
variant, the live port is clean at both levels with an empty baseline,
and the faults the checker found in the port are shown and their repairs
held (the counterpart of ``tests/test_analysis.py``; no JAX there, JAX
only where a repair is held against the reference).

AST rules run on synthetic sources through ``analyze_source`` (so the
waiver plumbing is on the path); runtime rules on planted states and ops
through the helpers the live checks use.  The faults: ``aten.bincount``
in the MoE steps (the router's aux loss and the capacity ranks),
M-RoPE's host copy and tensor-repeat ``repeat_interleave`` in every
rotary call, and the step's reallocated leaves (``buf_len``, ``done``,
``rng_key``, ``stats/*``, ``model/cur_len``).  Each is planted back with
the code the port had before its repair, and the checker reports it.
The repairs are held: ``expert_counts`` equals ``torch.bincount``, the
router and ``moe_scatter`` (capacity drops included) equal JAX's, the
M-RoPE section ids equal the former construction and Qwen2-VL's verify
logits equal JAX's (f32 1e-4), and the in-place step serves, over the
reference's six cases, the tokens and stats the out-of-place step served
(``STEP_DIGESTS``, its sha256 over buf, buf_len, done, rng_key, cur_len
and every stats leaf).  Torch runs in one thread.
"""
import dataclasses
import hashlib
import json
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.analysis import DEFAULT_BASELINE, Baseline, run_all
from repro_torch.analysis import ast_rules as ar
from repro_torch.analysis import registry
from repro_torch.analysis import runtime_rules as rr
from repro_torch.analysis.__main__ import main as lint_main
from repro_torch.analysis.findings import Finding
from repro_torch.core import prng
from repro_torch.core import spec_engine as E
from repro_torch.core.ngram_tables import (NGramTables, build_bigram,
                                           build_unigram)
from repro_torch.models import attention as A
from repro_torch.models import model as M
from repro_torch.models import moe


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The port's side in one thread: the models are tiny, and the suite
    runs its files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ast(relpath, source):
    findings, _ = ar.analyze_source(relpath, textwrap.dedent(source))
    return [f for f in findings if not f.waived]


# ---------------------------------------------------------------------------
# AST rules: planted violations and their clean variants
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("src", [
    "import ctypes\n",
    "from triton import language as tl\n",
    "from torch.utils.cpp_extension import load_inline\n",
    "from ..kernels import build\nlib = build.load('spec_attention')\n",
])
def test_kernel_scope_fires_outside_kernels(src):
    got = _ast("core/rogue.py", src)
    assert [f.rule for f in got] == ["kernel-scope"]
    assert _ast("kernels/spec_attention.py", src) == []


@pytest.mark.parametrize("body,what", [
    ("y = torch.sum(x)\n    if y > 0:\n        pass", "`if`"),
    ("y = x.sum()\n    while y:\n        pass", "`while`"),
    ("y = torch.argmax(x)\n    return int(y)", "int()"),
    ("return bool((x > 0).any())", "bool()"),
    ("return x.max().item()", ".item()"),
    ("return torch.ones(3).tolist()", ".tolist()"),
    ("return state['cur_len'].cpu()", ".cpu()"),
    ("return np.asarray(x + 1)", "np.asarray()"),
])
def test_tensor_branch_fires_on_a_host_read(body, what):
    src = ("import numpy as np\nimport torch\n"
           "def f(x: torch.Tensor, state):\n    " + body + "\n")
    got = _ast("models/rogue.py", src)
    assert [f.rule for f in got] == ["tensor-branch"], got
    assert what in got[0].message


def test_tensor_branch_follows_calls_annotated_to_return_tensors():
    src = """
    import torch
    def make(n) -> torch.Tensor:
        return torch.zeros(n)
    def loop(n):
        s = make(n)
        while bool(s.any()):
            s = make(n)
    """
    got = _ast("core/rogue.py", src)
    assert [f.line for f in got] == [7]


def test_tensor_branch_ignores_host_values():
    src = """
    import numpy as np
    import torch
    def f(x: torch.Tensor, flag, spec, cfg):
        y = torch.sum(x)
        if x.shape[0] > 1 or x.dim() == 2:    # shape reads: host ints
            pass
        if flag and spec.tree:                # untraced arguments
            pass
        if cfg is not None and "k" in {}:
            pass
        a = np.flatnonzero(np.arange(4) > 1)  # numpy constants
        if bool(a.any()) and int(a[0]):
            pass
        h = x.cpu().numpy()                   # one read (flagged once)
        return h.tolist(), int(h[0]), y
    """
    got = _ast("core/ok.py", src)
    assert [f.message.split(" in ")[0] for f in got] == [".cpu()"]


def test_tensor_branch_scoped_to_core_and_models():
    src = ("import torch\ndef f(x):\n    y = torch.sum(x)\n"
           "    if y > 0:\n        pass\n")
    assert [f.rule for f in _ast("core/x.py", src)] == ["tensor-branch"]
    assert [f.rule for f in _ast("models/x.py", src)] == ["tensor-branch"]
    assert _ast("serving/x.py", src) == []


def test_hash_constants_fire_in_python_and_cuda():
    assert [f.rule for f in _ast("core/rogue.py", "M = 2654435761\n")] \
        == ["hash-constants"]
    assert [f.rule for f in _ast("core/rogue.py", "HASH_MIX = 7\n")] \
        == ["hash-constants"]
    assert _ast("kernels/hashing.py",
                "HASH_MULT = 2654435761\nHASH_MIX = 0x9E3779B9\n") == []
    cu = ("__global__ void k(unsigned m) {\n"
          "  unsigned h = x * 0x9e3779b9u;\n"
          "  // 2654435761 in a comment is fine\n}\n")
    got = ar.analyze_cuda_source("kernels/csrc/rogue.cu", cu)
    assert [(f.rule, f.line) for f in got] == [("hash-constants", 2)]


@pytest.mark.parametrize("stmt", [
    "os.environ['CUDA_VISIBLE_DEVICES'] = '0'",
    "torch.set_num_threads(1)",
    "torch.manual_seed(0)",
    "torch.set_default_dtype(torch.float64)",
    "torch.backends.cuda.matmul.allow_tf32 = False",
])
def test_global_state_fires_on_module_level_mutation(stmt):
    src = f"import os\nimport torch\n{stmt}\n"
    assert [f.rule for f in _ast("core/rogue.py", src)] == ["global-state"]
    guarded = (f"import os\nimport torch\ndef main():\n    {stmt}\n"
               f"if __name__ == '__main__':\n    {stmt}\n")
    assert _ast("launch/ok.py", guarded) == []


def test_global_state_needs_a_context_manager_to_rebind_a_global():
    bad = """
    _counter = None
    def start():
        global _counter
        _counter = 0
    """
    got = _ast("models/rogue.py", bad)
    assert [f.rule for f in got] == ["global-state"]
    good = """
    import contextlib
    _counter = None
    @contextlib.contextmanager
    def counting():
        global _counter
        outer, _counter = _counter, 0
        try:
            yield
        finally:
            _counter = outer
    """
    assert _ast("models/ok.py", good) == []


def test_time_in_step_fires_in_step_functions():
    src = """
    import random
    import time
    import numpy as np
    import torch
    def spec_step(s):
        t = time.perf_counter()
    def _spec_body(s):
        return random.random() + np.random.rand()
    def admit_slot(s):
        return torch.rand(3), torch.rand(3, generator=g), s.uniform_()
    def helper():
        return time.time(), torch.rand(3)
    """
    got = _ast("core/rogue.py", src)
    assert [f.line for f in got] == [7, 9, 9, 11, 11]
    assert {f.rule for f in got} == {"time-in-step"}


def test_serving_sync_rule_and_inventory():
    src = """
    import torch
    class ServingEngine:
        def _retire_finished(self):
            state = self._cont_state
            # repro-lint: allow(host-sync): slot reuse is a host decision
            done = state.done.cpu().numpy()
            n = int(self._cont_state.model["free_top"])
            return done.tolist(), int(done[0]), n
        def step(self):
            torch.cuda.synchronize()
            return self._cont_state.buf_len.tolist()
        def pool_stats(self):
            return self._cont_state.buf.cpu()     # not the critical path
    """
    findings, inventory = ar.analyze_source("serving/engine.py",
                                            textwrap.dedent(src))
    assert [(f.line, f.waived) for f in findings] == [
        (7, True), (8, False), (11, False), (12, False)]
    assert [e["waived"] for e in inventory] == [True, False, False, False]
    assert inventory[0]["reason"] == "slot reuse is a host decision"


def test_waivers_apply_to_the_line_or_the_statement_below():
    src = """
    import torch
    def f(x: torch.Tensor):
        # repro-lint: allow(tensor-branch): host-side audit
        a, b = (t.cpu()
                for t in (x, x))
        c = x.item()  # repro-lint: allow(tensor-branch): same line
        d = x.item()
        return a, b, c, d
    """
    findings, _ = ar.analyze_source("core/w.py", textwrap.dedent(src))
    assert [(f.line, f.waived) for f in findings] == [
        (5, True), (7, True), (8, False)]
    assert findings[0].waive_reason == "host-side audit"


def test_baseline_split_and_covers(tmp_path):
    f1 = Finding("in-place", "<case:x/spec_step>", 0, "m",
                 context="<case:x/spec_step>::realloc::buf_len")
    f2 = Finding("host-sync", "<case:x/spec_step>", 0, "m", context="k2")
    p = tmp_path / "baseline.json"
    p.write_text(json.dumps({"entries": [
        {"rule": "in-place", "file": "<case:x/spec_step>",
         "context": "<case:x/spec_step>::realloc::buf_len"}]}))
    new, accepted = Baseline.load(str(p)).split([f1, f2])
    assert new == [f2] and accepted == [f1]
    assert Baseline.load(str(tmp_path / "missing.json")).entries == []


# ---------------------------------------------------------------------------
# runtime rules on planted states and ops
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("src", [
    "from ..distributed import act_sharding\n"
    "act_sharding.install(object())\n",
    "from ..distributed import act_sharding\n"
    "def start(mesh):\n    act_sharding.install(mesh)\n",
], ids=["module-level", "unpaired"])
def test_global_state_fires_on_a_mesh_install(src):
    """The mesh half of ``global-state``: an install at import, and an
    install with no uninstall/activated pairing in its module."""
    got = _ast("serving/rogue.py", src)
    assert [f.rule for f in got] == ["global-state"] * (
        2 if "\nact_sharding.install" in src else 1)
    paired = src + ("def stop():\n    act_sharding.uninstall()\n")
    assert [f.rule for f in _ast("serving/rogue.py", paired)] == (
        ["global-state"] if "\nact_sharding.install" in src else [])
    scoped = ("from ..distributed import act_sharding\n"
              "def serve(mesh):\n"
              "    with act_sharding.activated(mesh):\n"
              "        pass\n")
    assert _ast("serving/ok.py", scoped) == []


@pytest.fixture(scope="module")
def linear_mixed():
    return registry.build_case(registry.case("linear-mixed"))


def test_in_place_fires_on_a_reallocated_leaf(linear_mixed):
    s = linear_mixed.state
    before = rr.storages(s)
    after = dataclasses.replace(s, buf_len=s.buf_len + 0,
                                stats={**s.stats,
                                       "calls": s.stats["calls"] + 0})
    got = rr.in_place_findings(before, after, "<case:t/spec_step>")
    assert sorted(f.context.split("::")[-1] for f in got) == [
        "buf_len", "stats/calls"]
    assert rr.in_place_findings(before, s, "<case:t/spec_step>") == []


def test_in_place_fires_on_leaves_sharing_storage(linear_mixed):
    s = linear_mixed.state
    assert rr.shared_storage_findings(s, "<t>") == []
    shared = dataclasses.replace(s, prompt_len=s.budget,
                                 top_p=s.temperature.view(-1))
    got = rr.shared_storage_findings(shared, "<t>")
    assert {f.rule for f in got} == {"in-place"}
    assert len(got) == 2


@pytest.mark.parametrize("drift", ["dtype", "shape", "structure"])
def test_state_signature_fires_on_drift(linear_mixed, drift):
    s = linear_mixed.state
    sig = rr.signature(s)
    if drift == "dtype":
        after = dataclasses.replace(s, buf_len=s.buf_len.long())
    elif drift == "shape":
        after = dataclasses.replace(s, done=s.done[:2])
    else:
        after = dataclasses.replace(s, stats={**s.stats,
                                              "extra": s.buf_len.clone()})
    got = rr.signature_findings(sig, after, "<t>")
    assert [f.rule for f in got] == ["state-signature"]
    assert got[0].context.endswith("drift" if drift != "structure"
                                   else "structure")
    assert rr.signature_findings(sig, s, "<t>") == []


@pytest.mark.parametrize("op,name,kind", [
    (lambda x: torch.bincount(x, minlength=8), "aten.bincount", "d2h"),
    (lambda x: x.sum().item(), "aten._local_scalar_dense", "d2h"),
    (lambda x: x[x > 2], "aten.index.Tensor", "d2h"),
    (lambda x: torch.repeat_interleave(torch.arange(3), x[:3]),
     "aten.repeat_interleave.Tensor", "d2h"),
    (lambda x: torch.tensor([1, 2]) + x[:2], "aten.lift_fresh", "h2d"),
])
def test_host_sync_fires_on_planted_ops(op, name, kind):
    x = torch.arange(6)
    with rr.SyncWatch() as watch:
        op(x)
    got = rr.sync_findings(watch.hits, "<case:t/spec_step>", d2h_only=False)
    assert [f.rule for f in got] == ["host-sync"]
    assert got[0].message.startswith(name)
    assert "test_torch_analysis" not in got[0].message
    # admission and release count only the device->host entries
    assert len(rr.sync_findings(watch.hits, "<t>", d2h_only=True)) == \
        (kind == "d2h")


def test_host_sync_is_quiet_on_device_side_ops():
    x = torch.arange(6)
    with rr.SyncWatch() as watch:
        torch.where(x > 2, x, 0)
        x.index_put_((x[:2].clone(),), x[2:4].clone(), accumulate=True)
        torch.repeat_interleave(torch.arange(3), torch.ones(3).long(),
                                output_size=3)
        torch.zeros(8, dtype=torch.int64).index_add_(0, x, torch.ones_like(x))
        torch.sort(x, stable=True)
    assert watch.hits == []


def test_sharding_coverage_fires_on_a_leaf_without_a_rule(linear_mixed):
    s = linear_mixed.state
    assert rr.check_sharding_coverage(s, "t") == []
    planted = dataclasses.replace(s, stats={**s.stats,
                                            "mystery": s.stats["calls"]})
    planted = dataclasses.replace(planted, model={**s.model,
                                                  "mystery": s.buf_len})
    got = rr.check_sharding_coverage(planted, "t")
    assert {f.rule for f in got} == {"sharding-coverage"}
    # a stats row matches its head's rule; a model-cache leaf its own name
    assert {f.context for f in got} == {"sharding::model/mystery"}
    assert len(got) == len(registry.MESHES)


def test_sharding_coverage_fires_on_a_replication_fallback(linear_mixed):
    """A Mamba state whose inner dim divides no model axis falls back to
    replication on the loud end of its chain."""
    s = linear_mixed.state
    B = s.buf.shape[0]
    planted = dataclasses.replace(s, model={
        **s.model, "groups": {**s.model["groups"],
                              "p1": {"ssm": torch.zeros((1, B, 3, 4))}}})
    got = rr.check_sharding_coverage(planted, "t")
    assert got and {f.rule for f in got} == {"sharding-coverage"}
    assert all("replication fallback" in f.message for f in got)
    assert {f.context for f in got} == {"sharding-fallback::2x2",
                                        "sharding-fallback::pod3d"}


# ---------------------------------------------------------------------------
# the live port
# ---------------------------------------------------------------------------
def test_live_port_is_clean_with_an_empty_baseline():
    """Both levels over the whole registry, on the CPU: every finding is
    waived, and the baseline holds nothing."""
    assert Baseline.load(DEFAULT_BASELINE).entries == []
    findings, inventory = run_all(device="cpu")
    new, accepted = Baseline.load(DEFAULT_BASELINE).split(findings)
    assert new == [], "\n".join(f.format() for f in new)
    assert all(f.waived for f in accepted)
    assert {e["method"] for e in inventory} == {"_retire_finished"}
    assert all(e["waived"] for e in inventory)


def test_cli_level2_strict_and_syncmap(tmp_path):
    out = tmp_path / "syncmap.json"
    assert lint_main(["--level", "2", "--strict", "--syncmap",
                      str(out)]) == 0
    data = json.loads(out.read_text())
    assert data["total"] == len(data["inventory"]) >= 3
    assert data["waived"] == data["total"]
    assert lint_main(["--list-rules"]) == 0


def test_cli_fails_on_stale_baseline_only_when_strict(tmp_path):
    p = tmp_path / "baseline.json"
    p.write_text(json.dumps({"entries": [
        {"rule": "in-place", "file": "<case:gone/spec_step>",
         "context": "no longer found"}]}))
    assert lint_main(["--level", "2", "--baseline", str(p)]) == 0
    assert lint_main(["--level", "2", "--strict", "--baseline",
                      str(p)]) == 1


def test_cli_level1_raises_without_a_card_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lint_main(["--level", "1"])


# ---------------------------------------------------------------------------
# the faults the checker found, planted back, and their repairs
# ---------------------------------------------------------------------------
def _runtime(name):
    return rr.check_case(registry.build_case(registry.case(name)))


def _bincount_counts(flat_e, E):
    return torch.bincount(flat_e, minlength=E)          # the former line


def test_checker_reports_bincount_in_the_moe_steps(monkeypatch):
    assert _runtime("moe") == []
    monkeypatch.setattr(moe, "expert_counts", _bincount_counts)
    got = [f for f in _runtime("moe") if f.file == "<case:moe/spec_step>"]
    assert [f.context for f in got] == [
        "<case:moe/spec_step>::op::aten.bincount.default"]
    assert "2x" in got[0].message and "models/moe.py" in got[0].message


def _former_section_ids(cfg, device):
    """M-RoPE's section ids as ``rope_freqs`` built them in every call."""
    half = len(range(0, cfg.rotary_dim, 2))
    sec_id = torch.repeat_interleave(
        torch.arange(3, device=device),
        torch.as_tensor(cfg.mrope_sections, device=device))
    return torch.cat([sec_id, sec_id.new_full(
        (max(half - sec_id.shape[0], 0),), 2)])[:half]


def test_checker_reports_mropes_host_copy_and_repeat(monkeypatch):
    assert _runtime("mrope") == []
    monkeypatch.setattr(A, "_mrope_section_ids", _former_section_ids)
    got = {f.context for f in _runtime("mrope")
           if f.file == "<case:mrope/spec_step>"}
    assert got == {"<case:mrope/spec_step>::op::aten.lift_fresh.default",
                   "<case:mrope/spec_step>::op::aten.repeat_interleave.Tensor"}


def _out_of_place_step(step):
    """``spec_step`` as it returned new tensors for the leaves it wrote."""
    def call(params, cfg, spec, s, tables=None):
        s = step(params, cfg, spec, s, tables)
        fresh = lambda t: t.clone()
        return dataclasses.replace(
            s, buf_len=fresh(s.buf_len), done=fresh(s.done),
            rng_key=fresh(s.rng_key) if spec.sampling else s.rng_key,
            stats={k: fresh(v) for k, v in s.stats.items()},
            model={**s.model, "cur_len": fresh(s.model["cur_len"])})
    return call


def test_checker_reports_reallocated_leaves(monkeypatch):
    monkeypatch.setattr(rr, "spec_step", _out_of_place_step(E.spec_step))
    got = _runtime("linear-sampled")
    names = {f.context.split("::")[-1] for f in got
             if f.file == "<case:linear-sampled/spec_step>"}
    assert {f.rule for f in got} == {"in-place"}
    assert names == {"buf_len", "done", "rng_key", "model/cur_len"} | {
        f"stats/{k}" for k in ("calls", "tokens", "accept_hist",
                               "rank_hist", "alloc_ctx", "accepted_ctx",
                               "accepted_bigram")}


def test_expert_counts_equal_bincount():
    rng = np.random.default_rng(0)
    for E_, n in ((8, 0), (8, 37), (64, 6 * 41), (16, 2)):
        flat = torch.from_numpy(rng.integers(0, E_, n))
        got = moe.expert_counts(flat, E_)
        assert got.dtype == torch.int64
        assert torch.equal(got, torch.bincount(flat, minlength=E_))


@pytest.mark.parametrize("arch", ["qwen2-vl-72b", "qwen2-vl-72b-smoke"])
def test_mrope_section_ids_equal_the_former_construction(arch):
    from repro_torch import configs
    cfg = (configs.get_smoke_config("qwen2-vl-72b") if arch.endswith("smoke")
           else configs.get_config(arch))
    for sections in (cfg.mrope_sections, (2, 1, 1), (40, 40, 40)):
        c = dataclasses.replace(cfg, mrope_sections=tuple(sections))
        got = A._mrope_section_ids(c, torch.device("cpu"))
        assert torch.equal(got, _former_section_ids(c, "cpu"))
    assert A._mrope_section_ids(cfg, torch.device("cpu")) is \
        A._mrope_section_ids(cfg, torch.device("cpu"))


@pytest.fixture(scope="module")
def jax_moe():
    """DeepSeek-MoE's smoke layer: JAX's cfg and parameters, the port's."""
    import jax
    from repro import configs as jconfigs
    from repro.models import model as JM
    jcfg = dataclasses.replace(jconfigs.get_smoke_config("deepseek-moe-16b"),
                               backend="xla").validate()
    jparams = JM.init_params(jax.random.PRNGKey(1), jcfg)
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams["p0"]["mlp"])
    return jcfg, jp, {k: torch.tensor(np.asarray(v)) for k, v in jp.items()}


@pytest.mark.parametrize("cf", [None, 0.5], ids=["default", "drops"])
def test_router_and_moe_scatter_equal_jax(jax_moe, cf):
    """The router (its aux loss counts experts by ``expert_counts``) and
    ``moe_scatter`` (whose ranks do too), with and without dropped
    token-slots, against JAX's at f32 (indices and drops exact)."""
    import jax.numpy as jnp
    from repro.models import moe as JMoE
    from repro_torch.models.config import ModelConfig
    jcfg, jp, p = jax_moe
    if cf is not None:
        jcfg = dataclasses.replace(jcfg, capacity_factor=cf)
    cfg = ModelConfig.from_reference(jcfg)
    x = np.random.default_rng(1).standard_normal((3, 13, cfg.d_model))
    x = x.astype(np.float32)
    jidx, jw, jaux = JMoE._router(jp, jnp.asarray(x.reshape(39, -1)), jcfg)
    idx, w, aux = moe._router(p, torch.from_numpy(x.reshape(39, -1)), cfg)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    with moe.count_drops() as drops:
        y, aux = moe.moe_scatter(p, torch.from_numpy(x), cfg)
    jy, jaux = JMoE.moe_scatter(jp, jnp.asarray(x), jcfg)
    want = np.asarray(jy)
    np.testing.assert_allclose(y.numpy(), want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    assert (drops.read()[1] > 0) == (cf is not None)


def test_mrope_verify_logits_equal_jax():
    """Qwen2-VL's smoke model: the verify call (M-RoPE positions from
    cur_len) gives JAX's logits at f32 1e-4 after a prefill."""
    import jax
    import jax.numpy as jnp
    from repro import configs as jconfigs
    from repro.models import model as JM
    from repro.train.checkpoint import _flatten
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.weights import from_jax_flat
    jcfg = dataclasses.replace(jconfigs.get_smoke_config("qwen2-vl-72b"),
                               backend="xla").validate()
    jparams = JM.init_params(jax.random.PRNGKey(0), jcfg)
    cfg = ModelConfig.from_reference(jcfg)
    params = from_jax_flat(_flatten(jparams), cfg, device="cpu")
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    rows = rng.integers(0, cfg.vocab_size, (2, 3, 4)).astype(np.int32)
    jst = JM.init_state(jcfg, 2, 24)
    _, jst = JM.prefill(jparams, jcfg, jst, tokens=jnp.asarray(toks))
    want, _ = JM.verify(jparams, jcfg, jst, jnp.asarray(rows))
    st = M.init_state(cfg, 2, 24, device="cpu")
    M.prefill(params, cfg, st, tokens=torch.from_numpy(toks))
    got, _ = M.verify(params, cfg, st, torch.from_numpy(rows))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


# sha256 (first 16 hex digits) of the served state of each reference case
# (``_served_digest``), and its buf_len, as the out-of-place step served
# them
STEP_DIGESTS = {
    "linear-greedy": ("4ff86fd8ef0bcfc2", [15, 21, 21, 15]),
    "linear-mixed": ("03cc052b4c40e650", [15, 22, 26, 15]),
    "linear-sampled": ("bf929a9280f8f379", [15, 22, 26, 15]),
    "linear-adaptive": ("5fff33dd3caf8e93", [15, 21, 26, 15]),
    "tree": ("8ed8ae71297f3707", [17, 22, 26, 15]),
    "paged-mixed": ("e426fdf71e3b418b", [15, 22, 26, 15]),
}


def _served_digest(c):
    """Three slots admitted (odd slots sampled in a sampling case), 12
    steps with model-built tables, slot 3 admitted and slot 0 released
    after the 6th; the digest of the tokens and stats that leaves."""
    b = registry.build_case(c)
    tables = None
    if c.needs_tables:
        fwd = lambda t: M.forward(b.params, b.cfg, tokens=t)[0][:, -1]
        topk, chain = build_bigram(fwd, b.cfg.vocab_size, k_max=8, w_max=8,
                                   device="cpu")
        tables = NGramTables(build_unigram(
            b.params["embed"]["embedding"], b.params["embed"]["lm_head"],
            k_max=8), topk, chain)
    prompts = registry.prompts(b.cfg)
    new = 32
    s = E.empty_decode_state(b.cfg, c.spec, 4, 8 + new + c.spec.w + 2,
                             paged=c.paged, device="cpu")

    def admit(s, slot):
        t = 0.8 if c.spec.sampling and slot % 2 else 0.0
        return E.admit_slot(b.params, b.cfg, s, slot,
                            torch.from_numpy(prompts[slot]), new, -1,
                            temperature=t, top_p=0.9 if t else 1.0,
                            rng_key=prng.prng_key(slot))
    for slot in range(3):
        s = admit(s, slot)
    for i in range(12):
        s = E.spec_step(b.params, b.cfg, c.spec, s, tables)
        if i == 5:
            s = E.release_slot(admit(s, 3), 0)
    h = hashlib.sha256()
    leaves = {"buf": s.buf, "buf_len": s.buf_len, "done": s.done,
              "rng_key": s.rng_key, "cur_len": s.model["cur_len"],
              **{f"stats/{k}": v for k, v in s.stats.items()}}
    for k in sorted(leaves):
        h.update(k.encode())
        h.update(leaves[k].numpy().tobytes())
    return h.hexdigest()[:16], s.buf_len.tolist()


@pytest.mark.parametrize("name", list(STEP_DIGESTS))
def test_in_place_step_serves_the_out_of_place_steps_tokens(name):
    assert _served_digest(registry.case(name)) == STEP_DIGESTS[name]
