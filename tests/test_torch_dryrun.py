"""The port's dry-run (``repro_torch.launch.dryrun``, ``input_specs``,
``hostdev``) on the CPU, held against the reference's ``input_specs``.

The reference's cases resolve on a ``jax.sharding.AbstractMesh`` (no
devices, no compile), and ``NamedSharding.shard_shape`` gives each leaf's
per-device shard.  The port's cases resolve over a placeholder process
group (``dist.init_process_group("fake")``) of 256 or 512 ranks on the
reference's meshes, their leaves fake DTensors holding rank 0's shard.
For every serving (arch, shape, spec) pair on both meshes, each leaf's
rank-0 shape and dtype, the argument bytes and the replication fallbacks
are the reference's.  Then a few cases traced at full width, cut to one
period; at mesh (1, 1) the traced flops equal ``FlopCounterMode`` over the
same unsharded call on real tensors; the K1 and K5 shape functions on fake
CUDA tensors (which this CPU build makes without a mesh); the CLI.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
import warnings

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import ASSIGNED_ARCHS as J_ASSIGNED
from repro.distributed import sharding as JS
from repro.launch import input_specs as JI
from repro_torch.configs import ALL_ARCHS, ASSIGNED_ARCHS
from repro_torch.distributed import local as DL
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import mamba_scan as K5
from repro_torch.kernels import ngram_match as K2
from repro_torch.kernels import spec_attention as K1
from repro_torch.launch import dryrun
from repro_torch.launch import input_specs as TI
from repro_torch.launch.hostdev import ensure_placeholder_ranks, mesh_arg
from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
SERVING = ("prefill_32k", "decode_32k", "long_500k")
EXPECTED_SKIPS = {("hubert-xlarge", "decode_32k"),
                  ("hubert-xlarge", "long_500k")}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The port's side in one thread: the suite runs its files in parallel
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ranks():
    """``use(n)``: this process as rank 0 of an n-rank placeholder group
    (the previous one of another size destroyed); none is left behind."""
    assert not dist.is_initialized()

    def use(n):
        if dist.is_initialized() and dist.get_world_size() != n:
            dist.destroy_process_group()
        ensure_placeholder_ranks(n)
    yield use
    if dist.is_initialized():
        dist.destroy_process_group()


def _mesh(ranks, name):
    shape, _ = MESHES[name]
    ranks(256 if len(shape) == 2 else 512)
    return make_debug_mesh(shape, device="cpu")


def _jax_shards(case):
    """{path: (rank-0 shard shape, dtype)} of a reference case's args."""
    leaves = jax.tree_util.tree_flatten_with_path(case.args)[0]
    shardings = jax.tree_util.tree_flatten(
        case.in_shardings, is_leaf=lambda x: hasattr(x, "shard_shape"))[0]
    out = {}
    for (path, leaf), s in zip(leaves, shardings):
        key = tuple(str(getattr(k, "idx", getattr(k, "key", k)))
                    for k in path)
        out[key] = (tuple(s.shard_shape(leaf.shape)), str(leaf.dtype))
    return out


def _port_shards(case):
    out = {}
    for i, arg in enumerate(case.args):
        for path, t in shd.walk(arg, (str(i),)):
            loc = t.to_local()
            out[path] = (tuple(loc.shape),
                         str(loc.dtype).replace("torch.", ""))
    return out


def _nbytes(shards):
    return sum(jnp.dtype(dt).itemsize * math.prod(s)
               for s, dt in shards.values())


# ---------------------------------------------------------------------------
# the tables and the per-rank shards, against the reference's
# ---------------------------------------------------------------------------
def test_tables_equal_reference():
    assert TI.SHAPES == JI.SHAPES
    assert (TI.SPEC_K, TI.SPEC_W) == (JI.SPEC_K, JI.SPEC_W) == (10, 10)
    assert TI.DryrunCase._fields == JI.DryrunCase._fields
    assert ASSIGNED_ARCHS == J_ASSIGNED
    assert ALL_ARCHS == J_ASSIGNED + ["mistral-7b"]


@pytest.mark.parametrize("arch", ALL_ARCHS)
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_rank0_shards_equal_reference(ranks, mesh_name, arch):
    """Every serving (shape, spec) pair of ``arch``: the case names and
    skips are the reference's; each leaf's rank-0 local shape and dtype
    equal ``NamedSharding.shard_shape`` of the reference's leaf on an
    ``AbstractMesh`` of the same shape (matched by path), so the argument
    bytes are equal too; the replication fallbacks are the reference's."""
    mesh = _mesh(ranks, mesh_name)
    jmesh = AbstractMesh(*MESHES[mesh_name])
    for shape in SERVING:
        for spec in (False, True):
            with JS.recording_fallbacks() as jfall, \
                    warnings.catch_warnings():
                warnings.simplefilter("ignore")
                jc = JI.resolve_case(arch, shape, jmesh, spec_step=spec)
            with shd.recording_fallbacks() as tfall, \
                    warnings.catch_warnings():
                warnings.simplefilter("ignore")
                tc = TI.resolve_case(arch, shape, mesh, spec_step=spec,
                                     device="cpu")
            what = (arch, shape, spec, mesh_name)
            assert tc.name == jc.name, what
            assert (tc.skip_reason is None) == (jc.skip_reason is None), what
            if jc.skip_reason:
                assert (arch, shape) in EXPECTED_SKIPS
                continue
            want, got = _jax_shards(jc), _port_shards(tc)
            assert set(got) == set(want), (what, set(got) ^ set(want))
            bad = {p: (want[p], got[p]) for p in want if want[p] != got[p]}
            assert not bad, (what, bad)
            arg_bytes = sum(t.to_local().numel() * t.to_local().element_size()
                            for t in dryrun._tensors(tc.args))
            assert arg_bytes == _nbytes(want), what
            assert sorted(tfall) == sorted(jfall), what


def test_skips_and_train(ranks):
    """The skip set is the reference's (DESIGN §5, the artifact test's);
    ``train_4k`` raises, naming the queue item, for every arch (the port's
    mesh serves only: no skip, which the artifact test would read as an
    expected one)."""
    mesh = _mesh(ranks, "16x16")
    skips = {(a, s) for a in ALL_ARCHS for s in SERVING
             if TI.resolve_case(a, s, mesh, device="cpu").skip_reason}
    assert skips == EXPECTED_SKIPS
    for arch in ALL_ARCHS:
        with pytest.raises(NotImplementedError, match="sharded train step"):
            TI.resolve_case(arch, "train_4k", mesh, device="cpu")


# ---------------------------------------------------------------------------
# traced cases at full width, cut to one period
# ---------------------------------------------------------------------------
def _whole_bytes(t):
    return t.numel() * t.element_size()


@pytest.mark.parametrize("arch,shape,spec,mesh_name", [
    ("stablelm-1.6b", "decode_32k", True, "16x16"),
    ("jamba-1.5-large-398b", "decode_32k", True, "2x16x16"),
    ("mixtral-8x7b", "prefill_32k", False, "16x16"),
])
def test_traced_case(ranks, arch, shape, spec, mesh_name):
    """Rank 0's program traced on fake tensors at full width, one period
    deep: flops and HBM bytes counted.  The mesh's invariants (those of
    ``test_torch_sharded_*.py``) hold: no collective reads a recurrent
    state leaf's shard; a collective
    that reads a KV leaf's shard (a cache's sequence gathered for this
    rank's rows) returns less than the whole leaf; in a decode or verify
    step every collective's result is smaller than the smallest whole KV
    leaf (a 32k-token prefill's activations are larger than a 4096-slot
    ring's whole leaf: there the bound is not asserted); every parameter
    the layers gather over the batch axes keeps its "model" shard
    (smaller than the whole parameter), the MoE router alone excepted."""
    mesh = _mesh(ranks, mesh_name)
    from repro_torch.configs import get_config
    period = get_config(arch).pattern_period
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        case = TI.resolve_case(arch, shape, mesh, spec_step=spec,
                               num_layers=period, device="cpu")
        DL.PARAM_GATHERS = []
        try:
            rec = dryrun.trace_case(case)
            gathers = DL.PARAM_GATHERS
        finally:
            DL.PARAM_GATHERS = None
    print(f"\n{arch} {shape} spec={spec} {mesh_name} ({period} layers): "
          f"{dryrun._summary(dict(rec, status='ok'))}")
    assert rec["cost"]["flops"] > 0
    assert rec["cost"]["bytes accessed"] > 0
    assert rec["memory"]["total_hbm_bytes"] > 0
    assert rec["memory"]["argument_size_in_bytes"] > 0
    assert rec["collectives"]["total"] > 0
    leaves = {"/".join(("1",) + p): _whole_bytes(t)
              for p, t in shd.walk(case.args[1])}
    kv = [n for p, n in leaves.items() if p.split("/")[-1] in ("k", "v")]
    for path, nb in rec["collectives"]["args_read"].items():
        if path.startswith("1/groups/"):
            assert path.split("/")[-1] in ("k", "v"), path
            assert nb < leaves[path], path
    if shape != "prefill_32k":
        assert rec["collectives"]["largest"] < min(kv)
    router = {_whole_bytes(t) for p, t in shd.walk(case.args[0])
              if p[-1] == "router"}
    assert gathers
    for after, whole in gathers:
        assert after < whole or whole in router
    # the state is written in place by prefill/decode, only read by verify
    alias = rec["memory"]["alias_size_in_bytes"]
    assert (alias == 0) if spec else alias > 0
    assert rec["kernels"] == {}        # the CPU runs the plain versions


@pytest.mark.parametrize("kind,spec", [("prefill", False), ("decode", False),
                                       ("decode", True)])
def test_flops_equal_flop_counter_at_1x1(ranks, tiny_dense_cfg, kind, spec):
    """At mesh (1, 1) the traced flops equal ``FlopCounterMode`` over the
    same unsharded call on real tensors, and the argument bytes equal the
    real params', state's and inputs' bytes."""
    ranks(1)
    mesh = make_debug_mesh((1, 1), device="cpu")
    cfg = ModelConfig.from_reference(tiny_dense_cfg)
    B, T = 4, 32
    case = TI.build_case("tiny", cfg, kind, B, T, mesh, spec_step=spec,
                         device="cpu")
    rec = dryrun.trace_case(case)
    params = M.init_params(cfg, seed=0, device="cpu")
    state = M.init_state(cfg, B, T, device="cpu")
    shape = {"prefill": (B, T), "decode": (B, 1)}[kind] if not spec \
        else (B, TI.SPEC_K, TI.SPEC_W + 1)
    toks = torch.zeros(shape, dtype=torch.int32)
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        if kind == "prefill":
            M.prefill(params, cfg, state, tokens=toks, last_only=True)
        elif spec:
            M.verify(params, cfg, state, toks)
        else:
            M.decode(params, cfg, state, toks)
    assert rec["cost"]["flops"] == fc.get_total_flops() > 0
    real = sum(_whole_bytes(t) for t in dryrun._tensors((params, state,
                                                          toks)))
    assert rec["memory"]["argument_size_in_bytes"] == real
    assert rec["collectives"]["total"] == 0


# ---------------------------------------------------------------------------
# the placeholder group and the CLI
# ---------------------------------------------------------------------------
def test_import_starts_no_group_and_never_replaces_one():
    """Importing ``launch.dryrun`` (and so every ``launch`` module it
    imports) starts no process group and imports no JAX;
    ``ensure_placeholder_ranks`` starts one where there is none and never
    replaces one (a fresh process: this one may hold the module's)."""
    code = (
        "import sys, torch.distributed as dist\n"
        "import repro_torch.launch.dryrun, repro_torch.launch.input_specs\n"
        "import repro_torch.launch.hostdev as H\n"
        "assert not dist.is_initialized()\n"
        "assert 'jax' not in sys.modules and 'repro' not in sys.modules\n"
        "assert H.ensure_placeholder_ranks(4) is True\n"
        "assert H.ensure_placeholder_ranks(256) is False\n"
        "assert dist.get_world_size() == 4\n"
        "dist.destroy_process_group()\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=120)
    assert r.returncode == 0 and r.stdout.strip().endswith("ok"), r.stderr
    assert mesh_arg(["x", "--mesh", "2x2"]) == "2x2"
    assert mesh_arg(["x", "--mesh=1x4"]) == "1x4"
    assert mesh_arg(["x"]) is None


def test_production_mesh_needs_its_ranks(ranks):
    ranks(256)
    assert ensure_placeholder_ranks(512) is False      # never replaced
    mesh = make_production_mesh(device="cpu")
    assert tuple(mesh.shape) == (16, 16)
    assert tuple(mesh.mesh_dim_names) == ("data", "model")
    with pytest.raises(RuntimeError, match="512"):
        make_production_mesh(multi_pod=True, device="cpu")
    ranks(512)
    mesh = make_production_mesh(multi_pod=True, device="cpu")
    assert tuple(mesh.mesh_dim_names) == ("pod", "data", "model")


def test_cli_records(ranks, tmp_path):
    """``main`` writes the reference's record schema (the base record, and
    the 1- and 2-period calibration with ``--roofline``); a train_4k case
    is a failed record naming the sharded train step, and exits 1;
    ``table`` reads both records back."""
    ranks(256)
    out = str(tmp_path)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        dryrun.main(["--arch", "xlstm-125m", "--shape", "long_500k",
                     "--device", "cpu", "--out", out, "--roofline"])
    with open(os.path.join(out, "xlstm-125m__long_500k__pod__base.json")) \
            as f:
        rec = json.load(f)
    assert rec["status"] == "ok" and rec["n_devices"] == 256
    assert set(rec["cost"]) == {"flops", "bytes accessed",
                                "transcendentals"}
    assert set(rec["memory"]) >= {
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "alias_size_in_bytes", "total_hbm_bytes"}
    assert set(rec["collectives"]) >= set(dryrun._COLLECTIVES) | {
        "total", "counts"}
    calib = rec["calib"]
    assert calib["L1"]["layers"] < calib["L2"]["layers"]
    assert 0 < calib["L1"]["cost"]["flops"] < calib["L2"]["cost"]["flops"]
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "stablelm-1.6b", "--shape", "train_4k",
                     "--device", "cpu", "--out", out])
    with open(os.path.join(out, "stablelm-1.6b__train_4k__pod__base.json")) \
            as f:
        rec = json.load(f)
    assert rec["status"] == "fail" and "sharded train step" in rec["error"]
    rows = dryrun.table(out, capacity=2**30).splitlines()
    assert rows[2].startswith("| xlstm-125m | long_500k | ")
    assert rows[2].endswith(", yes | not run | not run | not run |")
    assert rows[3] == ("| stablelm-1.6b | train_4k | fail: NotImplementedError"
                       " | not run | not run | not run |")


# ---------------------------------------------------------------------------
# the shape functions (fake CUDA tensors, no mesh)
# ---------------------------------------------------------------------------
def _k1_operands(B, K, W1, H, KV, hd, S, dtype, device):
    e = lambda *s: torch.zeros(s, dtype=dtype, device=device)
    return (e(B, K, W1, H, hd), e(B, S, KV, hd), e(B, S, KV, hd),
            e(B, K, W1, KV, hd), e(B, K, W1, KV, hd),
            torch.zeros((B,), dtype=torch.int32, device=device))


@pytest.mark.parametrize("H,KV,hd,W1,want", [
    (32, 32, 64, 11, "<64, 2, false>"),      # StableLM verify (G 1)
    (32, 32, 64, 1, "<64, 1, false>"),       # StableLM decode
    (64, 8, 128, 11, "<128, 2, false>"),     # the hybrid's verify (G 8)
    (96, 8, 192, 1, "<256, 1, false>"),      # Nemotron's hd 192, decode
])
def test_k1_shape_function(H, KV, hd, W1, want):
    """A fake CUDA ``q`` reaching K1's wrapper gets the empty output the
    kernel would fill (the plain version's shape and dtype; the kernel's
    contiguous strides, on q's device) and records K1's instance."""
    B, K, S = 2, (10 if W1 > 1 else 1), 48
    plain = K1.spec_attention_plain(
        *_k1_operands(B, K, W1, H, KV, hd, S, torch.float32, "cpu"), w1=W1)
    K1.spec_attention_cuda.shape_calls.clear()
    launches = K1.spec_attention_cuda.launches
    with FakeTensorMode():
        ops = _k1_operands(B, K, W1, H, KV, hd, S, torch.bfloat16, "cuda")
        out = K1.spec_attention_cuda(*ops, w1=W1)
        assert out.shape == plain.shape and out.dtype == torch.bfloat16
        assert out.stride() == ops[0].stride() and out.is_contiguous()
        assert out.device == ops[0].device
    calls = K1.spec_attention_cuda.shape_calls
    assert [c["instance"] for c in calls] == [want]
    assert calls[0]["flops"] == 4 * B * H * K * W1 * (S + W1) * hd
    assert K1.spec_attention_cuda.launches == launches     # none launched
    K1.spec_attention_cuda.shape_calls.clear()


def test_k1_k2_k3_k4_fake_refusals():
    """K1's checks run before its shape function (what the card refuses
    fails the dry-run); K2, K3 and K4 have no shape function: a fake
    tensor reaching them raises."""
    with FakeTensorMode():
        ops = _k1_operands(2, 1, 3, 4, 2, 64, 16, torch.bfloat16, "cuda")
        with pytest.raises(ValueError, match="w1"):
            K1.spec_attention_cuda(*ops, w1=4)
        bad = (ops[0].float(),) + ops[1:]
        with pytest.raises(TypeError):
            K1.spec_attention_cuda(*bad, w1=3)
        wide = _k1_operands(2, 1, 3, 4, 2, 320, 16, torch.bfloat16, "cuda")
        with pytest.raises(ValueError, match="hd=320"):
            K1.spec_attention_cuda(*wide, w1=3)
        cpu = (ops[0].cpu(),) + ops[1:]
        with pytest.raises(ValueError, match="CUDA"):
            K1.spec_attention_cuda(*cpu, w1=3)
        anc = torch.zeros((3, 4), dtype=torch.int32, device="cuda")
        with pytest.raises(NotImplementedError, match="K4"):
            K1.spec_attention_cuda(*ops, w1=3, anc=anc)
        pool = torch.zeros((4, 8, 2, 64), dtype=torch.bfloat16,
                           device="cuda")
        table = torch.zeros((2, 2), dtype=torch.int32, device="cuda")
        with pytest.raises(NotImplementedError, match="K3"):
            K1.paged_spec_attention_cuda(ops[0], pool, pool, table, ops[3],
                                         ops[4], ops[5], w1=3)
        buf = torch.zeros((2, 64), dtype=torch.int32, device="cuda")
        blen = torch.zeros((2,), dtype=torch.int32, device="cuda")
        with pytest.raises(NotImplementedError, match="K2"):
            K2.ngram_draft_cuda(buf, blen, q=2, k=3, w=2)
    assert K1.spec_attention_cuda.shape_calls == []


def _k5_operands(Bt, T, di, ds, h0_rows, u_dtype, device):
    """K5's operands, B and C strided as the layer's views of its x_proj
    output (made strided: this CPU build slices no fake CUDA tensor)."""
    z = lambda *s: torch.zeros(s, device=device)
    w = 8 + 2 * ds
    bc = lambda: torch.empty_strided((Bt, T, ds), (T * w, w, 1),
                                     device=device).zero_()
    return (z(Bt, T, di).to(u_dtype), z(Bt, T, di), z(di, ds), bc(), bc(),
            z(di), z(h0_rows, di, ds))


@pytest.mark.parametrize("mode", ["prefill", "verify", "decode", "replay"])
def test_k5_shape_function(mode):
    """A fake CUDA ``u`` reaching K5's wrapper gets the empty outputs the
    kernel would fill (the plain version's shapes and dtypes) and records
    K5's instance; K5's checks run first."""
    Bt, T, rep, final = {"prefill": (2, 24, 1, True),
                         "verify": (6, 11, 3, False),
                         "decode": (2, 1, 1, True),
                         "replay": (2, 11, 1, True)}[mode]
    di, ds = 32, 16
    nc = (lambda d: torch.tensor([3, 0], dtype=torch.int32, device=d)) \
        if mode == "replay" else (lambda d: None)
    want = K5.mamba_scan_plain(
        *_k5_operands(Bt, T, di, ds, Bt // rep, torch.float32, "cpu"),
        h0_rep=rep, final=final, n_commit=nc("cpu"))
    K5.mamba_scan_cuda.shape_calls.clear()
    launches = K5.mamba_scan_cuda.launches
    with FakeTensorMode():
        ops = _k5_operands(Bt, T, di, ds, Bt // rep, torch.bfloat16, "cuda")
        y, hT, steps = K5.mamba_scan_cuda(*ops, h0_rep=rep, final=final,
                                          n_commit=nc("cuda"))
        assert steps is None and y.shape == want[0].shape
        assert y.dtype == torch.float32 and y.is_contiguous() and y.is_cuda
        assert (hT is None) == (want[1] is None)
        if hT is not None:
            assert hT.shape == want[1].shape and hT.dtype == torch.float32
        with pytest.raises(ValueError, match="ds=17"):
            K5.mamba_scan_cuda(*_k5_operands(Bt, T, di, 17, Bt // rep,
                                             torch.bfloat16, "cuda"),
                               h0_rep=rep, final=final)
        with pytest.raises(TypeError):
            K5.mamba_scan_cuda(ops[0], ops[1].double(), *ops[2:],
                               h0_rep=rep, final=final)
        if mode == "prefill":
            ckpt = torch.zeros((Bt, K5.n_chunks(T), di, ds), device="cuda")
            with pytest.raises(NotImplementedError, match="training"):
                K5.mamba_scan_cuda(*ops, ckpt=ckpt)
    sel = "true" if mode == "replay" else "false"
    assert [c["instance"] for c in K5.mamba_scan_cuda.shape_calls] == [
        f"<16, bf16, {sel}, false>"]
    assert K5.mamba_scan_cuda.shape_calls[0]["transcendentals"] == \
        Bt * T * di * ds
    assert K5.mamba_scan_cuda.launches == launches
    K5.mamba_scan_cuda.shape_calls.clear()


def test_prefill_from_embeds_equals_forward(tiny_dense_cfg):
    """``prefill(embeds=)`` (the dry-run's encoder prefill) gives the
    forward's last-position logits for the same embeddings."""
    cfg = ModelConfig.from_reference(dataclasses.replace(
        tiny_dense_cfg, name="tiny-embeds"))
    params = M.init_params(cfg, seed=1, device="cpu")
    g = torch.Generator().manual_seed(0)
    emb = torch.randn((2, 12, cfg.d_model), generator=g)
    state = M.init_state(cfg, 2, 16, device="cpu")
    got, _ = M.prefill(params, cfg, state, embeds=emb, last_only=True)
    want, _ = M.forward(params, cfg, embeds=emb)
    torch.testing.assert_close(got[:, 0], want[:, -1], rtol=2e-5, atol=2e-5)
    assert int(state["cur_len"][0]) == 12
