"""The port's sharding rules (``repro_torch.distributed``) on the CPU, with
no devices: the rules are functions of a mesh's axis sizes, so they run on
plain dicts.

For every parameter leaf and every ``DecodeState`` leaf, linear and paged,
of each registry smoke config, on four meshes, the port's spec equals the
reference's ``PartitionSpec`` and the set of replication fallbacks is the
reference's.  Then the reference's own unit cases (``tests/test_sharding.py``)
on the port's functions, the scoped activation sharder, and the kernels'
route, which an installed mesh leaves alone.
"""
import dataclasses
import types
import warnings

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_get_smoke_config
from repro.core import spec_engine as JE
from repro.distributed import sharding as JS
from repro.models import model as JM
from repro.train.checkpoint import _flatten
from repro_torch.configs import ALL_ARCHS, get_smoke_config
from repro_torch.core import spec_engine as E
from repro_torch.distributed import act_sharding as act
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import dispatch
from repro_torch.launch.mesh import make_debug_mesh, parse_mesh_shape
from repro_torch.models import cache as C
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.models.weights import from_jax_flat


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The port's side in one thread: the suite runs its files in parallel
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MESHES = {"16x16": {"data": 16, "model": 16},
          "pod2x16x16": {"pod": 2, "data": 16, "model": 16},
          "2x2": {"data": 2, "model": 2},
          "1x1": {"data": 1, "model": 1}}
SLOTS, BUF, NP, PS = 32, 64, 64, 16
ARMS = ((1, 0), (2, 2), (4, 3))


class _Leaf:
    def __init__(self, shape):
        self.shape = tuple(shape)


def _j_specs(fn, mesh_shape, tree):
    """{path: spec tuple} and the fallback set of the reference's rule
    ``fn(mesh, path, leaf)`` over a pytree."""
    mesh = types.SimpleNamespace(shape=dict(mesh_shape))
    out = {}
    with JS.recording_fallbacks() as fb, warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            out["/".join(JS._path_names(path))] = tuple(fn(mesh, path, leaf))
    return out, set(fb)


def _port_param_specs(mesh_shape, params):
    with shd.recording_fallbacks() as fb, warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out = {"/".join(p): shd.param_pspec(mesh_shape, p, t)
               for p, t in shd.walk(params)}
    return out, set(fb)


def _port_state_specs(mesh_shape, state):
    with shd.recording_fallbacks() as fb, warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out = shd.decode_state_pspecs(mesh_shape, state, strict=True)
    return out, set(fb)


def _states(arch):
    """(reference state shapes, the port's state) for each layout the
    arch supports, same slots, buffer and pool."""
    jcfg = j_get_smoke_config(arch)
    cfg = get_smoke_config(arch)
    spec_kw = dict(k=4, w=3, strategy="mixed", arms=ARMS)
    jspec, spec = JE.SpecConfig(**spec_kw), E.SpecConfig(**spec_kw)
    out = {}
    layouts = [None]
    if C.paged_supported(cfg):
        layouts.append((NP, PS))
    for lay in layouts:
        jpaged = None if lay is None else JE.PagedConfig(*lay)
        paged = None if lay is None else E.PagedConfig(*lay)
        jst = jax.eval_shape(lambda: JE.empty_decode_state(
            jcfg, jspec, SLOTS, BUF, paged=jpaged))
        st = E.empty_decode_state(cfg, spec, SLOTS, BUF, paged=paged,
                                  device="cpu")
        out["linear" if lay is None else "paged"] = (jst, st)
    return out


@pytest.fixture(scope="module")
def carried():
    """{arch: (reference params, the port's params via from_jax_flat)}."""
    out = {}
    for arch in ALL_ARCHS:
        jcfg = j_get_smoke_config(arch)
        jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
        out[arch] = (jp, from_jax_flat(_flatten(jp), get_smoke_config(arch),
                                       device="cpu"))
    return out


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_specs_equal_the_references(carried, arch):
    jp, params = carried[arch]
    for name, mesh in MESHES.items():
        want, want_fb = _j_specs(JS.param_pspec, mesh, jp)
        got, got_fb = _port_param_specs(mesh, params)
        assert got == want, (arch, name)
        assert got_fb == want_fb, (arch, name)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_state_specs_equal_the_references(arch):
    """Every DecodeState leaf, linear and (where the arch has a linear
    attention cache) paged; the port's pool holds one trash page past the
    reference's NP, which its rule does not count."""
    for layout, (jst, st) in _states(arch).items():
        paged = layout == "paged"
        for name, mesh in MESHES.items():
            want, want_fb = _j_specs(
                lambda m, p, x: JS.decode_state_pspec(m, p, x, paged=paged,
                                                      strict=True),
                mesh, jst)
            got, got_fb = _port_state_specs(mesh, st)
            assert got == want, (arch, layout, name)
            assert got_fb == want_fb, (arch, layout, name)


# ---------------------------------------------------------------------------
# the reference's unit cases on the port's functions
# ---------------------------------------------------------------------------
POD = {"data": 16, "model": 16}
MULTI = {"pod": 2, "data": 16, "model": 16}


def test_resolve_axis_divisibility_fallback():
    assert shd.resolve_axis(POD, "kv", 8) is None          # 8 % 16 != 0
    assert shd.resolve_axis(POD, "kv", 32) == "model"
    assert shd.resolve_axis(POD, "embed", 4096) == "data"
    assert shd.resolve_axis(MULTI, "embed", 4096) == ("pod", "data")
    assert shd.resolve_axis(MULTI, "embed", 16) == "data"  # 16 % 32 != 0
    assert shd.resolve_axis(POD, None, 123) is None


def test_param_pspec_attention_and_moe_expert_fallback():
    assert shd.param_pspec(POD, ("p0", "mixer", "wq"),
                           _Leaf((32, 4096, 8192))) == (None, "data", "model")
    assert shd.param_pspec(POD, ("p0", "mixer", "wk"),
                           _Leaf((32, 4096, 1024))) == (None, "data", "model")
    # 16 experts: shard the expert dim; 8 (mixtral): the ffn instead
    assert shd.param_pspec(POD, ("p1", "mlp", "w_gate"),
                           _Leaf((9, 16, 8192, 24576))) == (
        None, "model", "data", None)
    assert shd.param_pspec(POD, ("p0", "mlp", "w_gate"),
                           _Leaf((32, 8, 4096, 14336))) == (
        None, None, "data", "model")
    # a '/'-joined path reads the same
    assert shd.param_pspec(POD, "p0/mixer/wq", _Leaf((32, 4096, 8192))) == (
        None, "data", "model")


def test_state_pspec_kv_and_recurrent_caches():
    k = ("model", "groups", "p0", "k")
    # kv=8 not divisible by model=16 -> shard the cache SEQUENCE
    assert shd.state_pspec(POD, k, _Leaf((32, 128, 32768, 8, 128))) == (
        None, "data", "model", None, None)
    assert shd.state_pspec(POD, k, _Leaf((24, 128, 32768, 32, 64))) == (
        None, "data", None, "model", None)
    # batch=1 (long context), kv non-divisible: sequence over "model"
    assert shd.state_pspec(POD, k, _Leaf((32, 1, 8192, 8, 128))) == (
        None, None, "model", None, None)
    assert shd.state_pspec(POD, ("groups", "p0", "ssm"),
                           _Leaf((63, 128, 16384, 16))) == (
        None, "data", "model", None)
    # mlstm C: nh=4 not divisible -> shard dh
    assert shd.state_pspec(POD, ("groups", "p0", "C"),
                           _Leaf((9, 32, 4, 384, 384))) == (
        None, "data", None, "model", None)


def test_resolve_axis_warns_once_and_records():
    """One ShardingFallbackWarning per (logical, dim, mesh), none for a
    probe (warn=False) or a size-1 dim; ``recording_fallbacks`` sees
    repeats; ``fallback_report`` the process history."""
    shd.reset_fallback_warnings()
    with pytest.warns(shd.ShardingFallbackWarning, match="'vocab'"):
        assert shd.resolve_axis(POD, "vocab", 61) is None
    with warnings.catch_warnings():
        warnings.simplefilter("error")          # second time: silent
        with shd.recording_fallbacks() as rec:
            assert shd.resolve_axis(POD, "vocab", 61) is None
            assert shd.resolve_axis(POD, "kv", 8, warn=False) is None
            assert shd.resolve_axis(POD, "embed", 1) is None
            assert shd.resolve_axis(POD, "embed", 4096) == "data"
    assert rec == {("vocab", 61)}                # the repeat is recorded
    with pytest.warns(shd.ShardingFallbackWarning):
        assert shd.resolve_axis(MULTI, "vocab", 61) is None
    assert ("vocab", 61) in shd.fallback_report()
    shd.reset_fallback_warnings()
    assert shd.fallback_report() == []


def test_decode_state_pspec_serving_leaves():
    mesh = {"data": 2, "model": 2}
    assert shd.decode_state_pspec(mesh, ("buf",), _Leaf((4, 64))) == (
        "data", None)
    assert shd.decode_state_pspec(mesh, ("done",), _Leaf((4,))) == ("data",)
    assert shd.decode_state_pspec(mesh, ("stats", "accept_hist"),
                                  _Leaf((4, 6))) == ("data", None)
    assert shd.decode_state_pspec(mesh, ("rng_key",), _Leaf((4, 2))) == (
        "data", None)
    assert shd.decode_state_pspec(mesh, ("top_p",), _Leaf((4,))) == (
        "data",)
    # an odd slot count replicates, not an error
    assert shd.decode_state_pspec(mesh, ("buf_len",), _Leaf((3,))) == (
        None,)
    assert shd.decode_state_pspec(mesh, ("model", "groups", "p0", "k"),
                                  _Leaf((1, 4, 32, 2, 16))) == (
        None, "data", None, "model", None)
    with pytest.raises(KeyError, match="DECODE_STATE_LEAF_RULES"):
        shd.decode_state_pspec(mesh, ("model", "mystery"), _Leaf((4,)),
                               strict=True)


def test_decode_state_pspec_paged_pool():
    """The pool's page axis (its NP real pages; the port's pool holds one
    trash page more) shards over data when kv takes the model axis, over
    (data, model) when the kv heads cannot; bookkeeping slot-sharded or
    replicated."""
    mesh = {"data": 2, "model": 2}
    assert shd.decode_state_pspec(mesh, ("model", "groups", "p0", "k"),
                                  _Leaf((1, 17, 8, 2, 16)), paged=True) == (
        None, "data", None, "model", None)
    assert shd.decode_state_pspec(mesh, ("model", "groups", "p0", "v"),
                                  _Leaf((1, 17, 8, 1, 16)), paged=True) == (
        None, ("data", "model"), None, None, None)
    assert shd.decode_state_pspec(mesh, ("model", "page_table"),
                                  _Leaf((4, 8))) == ("data", None)
    assert shd.decode_state_pspec(mesh, ("model", "free_list"),
                                  _Leaf((17,))) == (None,)
    assert shd.decode_state_pspec(mesh, ("model", "free_top"),
                                  _Leaf(())) == ()


def test_decode_state_pspecs_walk_the_ports_state():
    cfg = ModelConfig(name="walk", num_layers=1, d_model=32, num_heads=2,
                      num_kv_heads=2, d_ff=64, vocab_size=32)
    st = E.empty_decode_state(cfg, E.SpecConfig(k=2, w=2), 2, 8,
                              device="cpu")
    specs = shd.decode_state_pspecs({"data": 2, "model": 2}, st,
                                    strict=True)
    assert specs["buf"] == ("data", None)
    assert specs["model/groups/p0/k"] == (None, "data", None, "model", None)
    assert specs["model/cur_len"] == (None,)
    assert "stats/calls" in specs and "rng_key" in specs
    assert shd.spec_summary(specs)["buf"] == "('data', None)"


def test_to_placements():
    from torch.distributed.tensor import Replicate, Shard
    mesh = {"pod": 2, "data": 2, "model": 2}
    assert shd.to_placements(mesh, (None, ("pod", "data"), "model")) == (
        Shard(1), Shard(1), Shard(2))
    assert shd.to_placements(mesh, ()) == (Replicate(),) * 3
    # a size-1 axis splits nothing
    assert shd.to_placements({"data": 1, "model": 2}, ("data", "model")) == (
        Replicate(), Shard(1))
    with pytest.raises(ValueError, match="order"):
        shd.to_placements(mesh, (("data", "pod"),))
    with pytest.raises(ValueError, match="two dims"):
        shd.to_placements(mesh, ("model", "model"))


def test_act_sharding_activated_scoped_and_exception_safe():
    mesh_a, mesh_b = object(), object()     # only identity matters here
    assert not act.installed()
    with act.activated(mesh_a):
        assert act.installed()
        with act.activated(mesh_b):
            assert act.current() is mesh_b
        assert act.current() is mesh_a      # restored, not cleared
    assert not act.installed()
    with pytest.raises(RuntimeError):
        with act.activated(mesh_a):
            raise RuntimeError("boom")
    assert not act.installed()
    act.install(mesh_a)
    assert act.installed()
    act.uninstall()
    assert not act.installed()
    x = torch.ones(2, 3, 4)
    with act.activated({"data": 2, "model": 2}):
        assert act.constrain(x, "residual") is x    # a plain tensor
    assert act.spec_of({"data": 2, "model": 2}, "residual", (4, 4, 8)) == (
        "data", "model", None)
    assert act.spec_of({"data": 2, "model": 2}, "logits", (4, 1, 61)) == (
        "data", None, None)


def test_mesh_pins_the_kernels_to_their_plain_paths(monkeypatch):
    """The reference's counterpart (``test_mesh_pins_ngram_sweep_to_xla``)
    checks that an installed mesh pins its Pallas kernels to XLA.  The
    port pins nothing: the meshed model hands the kernels local tensors,
    so an installed mesh leaves the route to the tensor (asked of
    ``dispatch.on_card`` for the drafter and the scan alike), and the
    results are those without a mesh."""
    seen = []
    real = dispatch.on_card
    monkeypatch.setattr(dispatch, "on_card",
                        lambda t: seen.append(t.device.type) or real(t))
    buf = torch.randint(0, 5, (2, 24), generator=torch.Generator()
                        .manual_seed(0)).to(torch.int32)
    blen = torch.tensor([20, 24], dtype=torch.int32)
    with act.activated(object()):
        meshed = dispatch.ngram_draft(buf, blen, q=1, k=3, w=2)
    assert seen == ["cpu"]
    plain = dispatch.ngram_draft(buf, blen, q=1, k=3, w=2)
    for a, b in zip(meshed, plain):
        assert torch.equal(a, b)
    g = torch.Generator().manual_seed(1)
    Bt, T, di, ds = 2, 3, 4, 2
    args = (torch.randn(Bt, T, di, generator=g),
            torch.rand(Bt, T, di, generator=g),
            -torch.rand(di, ds, generator=g), torch.randn(Bt, T, ds,
                                                          generator=g),
            torch.randn(Bt, T, ds, generator=g), torch.randn(di, generator=g),
            torch.zeros(Bt, di, ds))
    with act.activated(object()):
        y1 = dispatch.selective_scan(*args)[0]
    assert seen == ["cpu"] * 3
    assert torch.equal(y1, dispatch.selective_scan(*args)[0])
    assert not hasattr(dispatch, "pinned")


def test_mesh_shape_parsing_and_clear_error_without_a_group():
    assert parse_mesh_shape("2x2") == (2, 2)
    assert parse_mesh_shape("2x4x2") == (2, 4, 2)
    for bad in ("2", "0x2", "ax2", "2x2x2x2"):
        with pytest.raises(ValueError):
            parse_mesh_shape(bad)
    with pytest.raises(RuntimeError, match="process group"):
        make_debug_mesh((2, 2))


def test_debug_mesh_defaults_to_the_card(tmp_path):
    """``make_debug_mesh`` is an entry point: its default device is the
    card, so without one it raises unless the caller asks for the CPU."""
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1)
    try:
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="device='cpu'"):
                make_debug_mesh((1, 1))
        mesh = make_debug_mesh((1, 1), "cpu")
        assert mesh.device_type == "cpu"
        assert tuple(mesh.mesh_dim_names) == ("data", "model")
    finally:
        dist.destroy_process_group()


def test_every_arch_has_full_param_coverage():
    """Every leaf of every published config gets a spec of its rank whose
    axes divide the dim, on both production meshes."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import param_shapes

    def leaves(tree, prefix=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, prefix + (k,))
            else:
                yield prefix + (k,), _Leaf(v[0])
    for arch in ALL_ARCHS:
        for mesh in (POD, MULTI):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                for path, leaf in leaves(param_shapes(get_config(arch))):
                    spec = shd.param_pspec(mesh, path, leaf)
                    assert len(spec) == len(leaf.shape), (arch, path)
                    for ax, d in zip(spec, leaf.shape):
                        if ax is None:
                            continue
                        axes = (ax,) if isinstance(ax, str) else ax
                        assert d % int(np.prod([mesh[a] for a in axes])) \
                            == 0, (arch, path, spec)


def test_distribute_keeps_each_ranks_shard():
    """``local.distribute``'s shard arithmetic (DTensor's chunking) on a
    mesh stand-in: ranges over one and two axes, uneven included."""
    from repro_torch.distributed import local as L

    class FakeMesh:
        mesh_dim_names = ("data", "model")
        shape = (2, 2)

        def __init__(self, coords):
            self.coords = coords

        def get_local_rank(self, axis):
            return self.coords[axis]
    m = FakeMesh({"data": 1, "model": 0})
    assert L.shard_range(m, 8, ("data",)) == (4, 8)
    assert L.shard_range(m, 8, ("data", "model")) == (4, 6)
    assert L.shard_range(m, 21, ("data",)) == (11, 21)      # uneven: 11+10
    assert L.shard_range(m, 8, ()) == (0, 8)
    assert L.padded({"data": 2, "model": 2}, 5) == 6
    assert L.padded({"data": 1, "model": 4}, 5) == 5
    assert dataclasses.is_dataclass(L.CacheLayout())
    assert M.has_recurrent(get_smoke_config("jamba-1.5-large-398b"))
