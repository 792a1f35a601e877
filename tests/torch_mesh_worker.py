"""The ranks of ``test_torch_sharded_serving.py``: one gloo process group of
four CPU ranks runs every meshed case and rank 0 pickles the results for
the test process, which holds them against the engine without a mesh and
against the JAX package.  No JAX here: a spawned rank imports the port
alone.
"""
import datetime
import os
import pickle
import time
import traceback
import warnings

import numpy as np
import torch
import torch.distributed as dist

PROMPTS = [("hello world", 16), ("a rather different prompt", 12),
           ("third request!", 16), ("four", 9), ("five arrives late", 16)]
STRATEGIES = ("greedy", "bigram", "unigram", "context", "mixed")
ARMS = ((1, 0), (2, 2), (4, 3))
SAMPLED = dict(temperature=0.8, top_p=0.95)
COLL_TIMEOUT_S = 120


def engine_kw(**kw):
    return {**dict(max_batch=4, buckets=(16,), max_new_cap=16,
                   device="cpu"), **kw}


def spec(strategy):
    from repro_torch.core.spec_engine import SpecConfig
    return SpecConfig(k=4, w=3, strategy=strategy, max_new_tokens=16)


def serve(eng, mode="continuous", prompts=PROMPTS, sampled=()):
    """Submit ``prompts`` (the indices in ``sampled`` at SAMPLED with a
    pinned seed), drain, and return (output_ids, new_tokens, model_calls,
    arm pulls) per request in submission order."""
    reqs = []
    for i, (p, m) in enumerate(prompts):
        kw = dict(SAMPLED, seed=100 + i) if i in sampled else {}
        reqs.append(eng.submit(p, max_new_tokens=m, **kw))
    done = eng.serve_continuous() if mode == "continuous" else eng.serve_all()
    by_id = {r.request_id: r for r in done}
    out = []
    for r in reqs:
        d = by_id[r.request_id]
        out.append((np.asarray(d.output_ids), d.stats["new_tokens"],
                    d.stats["model_calls"],
                    sum(d.stats.get("arm_pulls", {}).values())))
    return out


def leaf_layout(state):
    """{leaf path: (placements, local storage)} of a DTensor state."""
    from repro_torch.distributed.sharding import state_leaf_items
    return {"/".join(p): (tuple(t.placements),
                          t.to_local().untyped_storage().data_ptr())
            for p, t in state_leaf_items(state)}


def watch_fixed_point(eng):
    """Wrap the engine's meshed step, admit and release so that each
    checks every leaf keeps its placements (those ``decode_state_pspec``
    gives it) and its local storage; returns the list of violations."""
    bad, calls = [], {"step": 0, "admit": 0, "release": 0}
    eng._init_continuous()
    want = {p: tuple(pl) for p, pl in eng._fns.placements.items()}
    first = leaf_layout(eng._cont_state)
    for p, (pl, _) in first.items():
        if pl != want[p]:
            bad.append(("initial", p, str(pl), str(want[p])))
    for name in calls:
        real = getattr(eng, f"_run_{name}")

        def wrapped(*a, _real=real, _name=name, **k):
            st = _real(*a, **k)
            calls[_name] += 1
            now = leaf_layout(st)
            if now != first:
                bad.extend((_name, p) for p in now if now[p] != first[p])
            return st
        setattr(eng, f"_run_{name}", wrapped)
    return bad, calls


COLLECTIVES = ("all_gather", "reduce_scatter", "all_reduce", "all_to_all",
               "broadcast")


class CollectiveBytes:
    """CommDebugMode plus the bytes of every collective's output and the
    storages of its tensor inputs."""

    def __init__(self):
        from torch.distributed.tensor.debug import CommDebugMode
        outer = self

        class Mode(CommDebugMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = super().__torch_dispatch__(func, types, args, kwargs)
                name = str(getattr(func, "_overloadpacket", func))
                if out is not NotImplemented and any(
                        k in name for k in COLLECTIVES):
                    kind = name.split(".")[-1]
                    nb = sum(t.numel() * t.element_size()
                             for t in (out if isinstance(out, (list, tuple))
                                       else [out])
                             if isinstance(t, torch.Tensor))
                    outer.ops.append((kind, int(nb)))
                    outer.inputs.update(
                        t.untyped_storage().data_ptr() for t in args
                        if isinstance(t, torch.Tensor))
                return out
        self.ops = []
        self.inputs = set()
        self.mode = Mode()

    def __enter__(self):
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self.mode.__exit__(*exc)

    def summary(self):
        by = {}
        for kind, nb in self.ops:
            n, tot, most = by.get(kind, (0, 0, 0))
            by[kind] = (n + 1, tot + nb, max(most, nb))
        return {"counts": {str(k): int(v) for k, v in
                           self.mode.get_comm_counts().items()},
                "by_kind": by}


def one_step_collectives(eng, paged):
    """Admit the prompts, then count one continuous mixed step's
    collectives; with the KV leaves' and the params' global bytes."""
    from repro_torch.distributed.sharding import state_leaf_items, walk
    for p, m in PROMPTS[:4]:
        eng.submit(p, max_new_tokens=m)
    from repro_torch.distributed import local as L
    eng.step()                              # admits, then one step
    L.PARAM_GATHERS = []
    try:
        with CollectiveBytes() as cb:
            eng._cont_state = eng._run_step(eng._cont_state)
        gathers = L.PARAM_GATHERS
    finally:
        L.PARAM_GATHERS = None
    kv = [t.numel() * t.element_size()
          for p, t in state_leaf_items(eng._cont_state)
          if p[0] == "model" and p[-1] in ("k", "v")]
    params = {"/".join(p): t.numel() * t.element_size()
              for p, t in walk(eng.params)}
    eng.serve_continuous()
    return dict(cb.summary(), kv_leaf_bytes=kv, param_bytes=params,
                param_gathers=gathers, paged=paged)


def logits_gap(params_dt, params, cfg, mesh):
    """Max |meshed - unmeshed| of the prefill's and one verify call's
    logits on the same rows (f32)."""
    from repro_torch.core import spec_engine as E
    from repro_torch.distributed import act_sharding, local as L
    from repro_torch.models import model as M
    g = torch.Generator().manual_seed(3)
    prompt = torch.randint(0, 259, (4, 12), generator=g, dtype=torch.int32)
    rows_tok = torch.randint(0, 259, (4, 4, 4), generator=g,
                             dtype=torch.int32)
    sp = spec("mixed")
    st = E.init_decode_state(params, cfg, sp, prompt)
    lp, _ = M.prefill(params, cfg, M.init_state(cfg, 4, 40, device="cpu"),
                      tokens=prompt)
    lv, _ = M.verify(params, cfg, st.model, rows_tok)
    rows = L.rows_for(mesh, 4, L.cache_layout(mesh, cfg))
    mine = slice(rows.lo, rows.hi)
    with act_sharding.activated(mesh), L.active(rows):
        st_m = E.init_decode_state(params_dt, cfg, sp, prompt[mine])
        lp_m, _ = M.prefill(params_dt, cfg,
                            M.init_state(E._local_kv_cfg(cfg), rows.n, 40,
                                         device="cpu"),
                            tokens=prompt[mine])
        lv_m, _ = M.verify(params_dt, cfg, st_m.model, rows_tok[mine])
        lp_m, lv_m = L.gather_rows(lp_m), L.gather_rows(lv_m)
    return (float((lp_m - lp).abs().max()), float((lv_m - lv).abs().max()),
            bool(torch.equal(lp_m.argmax(-1), lp.argmax(-1))),
            bool(torch.equal(lv_m.argmax(-1), lv.argmax(-1))))


class RouteProbe:
    """Counts the tensor types that reach ``dispatch.on_card`` (the
    drafter's and the verify's kernel choice) inside the block."""

    def __init__(self):
        self.types = {"Tensor": 0, "DTensor": 0}

    def __enter__(self):
        from repro_torch.kernels import dispatch
        real = self.real = dispatch.on_card

        def on_card(t):
            self.types[type(t).__name__] = (
                self.types.get(type(t).__name__, 0) + 1)
            return real(t)
        dispatch.on_card = on_card
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import dispatch
        dispatch.on_card = self.real


def param_bytes(eng, mesh):
    """A meshed engine's parameter bytes: on this rank, whole, what the
    rules' shards of this rank come to, and whether every local tensor owns
    a storage of exactly its bytes (no view into a whole copy)."""
    from repro_torch.distributed import local as L
    from repro_torch.distributed import sharding as shd
    local = want = whole = 0
    exact = True
    for p, t in shd.walk(eng.params):
        loc = t.to_local()
        nb = loc.numel() * loc.element_size()
        local += nb
        whole += t.numel() * t.element_size()
        exact &= loc.untyped_storage().nbytes() == nb
        spec = tuple(shd.param_pspec(mesh, p, t)) + (None,) * t.dim()
        n = t.element_size()
        for size, e in zip(t.shape, spec):
            lo, hi = L.shard_range(mesh, size, L._axes(e))
            n *= hi - lo
        want += n
    return dict(local=local, want_local=want, exact_storages=exact,
                **{"global": whole})


def cases(rank, data):
    from repro_torch.distributed import act_sharding
    from repro_torch.distributed import local as L
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import attention
    from repro_torch.serving.engine import ServingEngine
    cfg, params, tables = data["cfg"], data["params"], data["tables"]
    mesh = make_debug_mesh((2, 2), "cpu")
    res, secs = {}, {}

    def timed(name, fn):
        t0 = time.perf_counter()
        res[name] = fn()
        secs[name] = time.perf_counter() - t0

    def eng(strategy, m=mesh, tables_none=False, **kw):
        tb = (tables if (strategy != "greedy" or kw.get("adaptive"))
              and not tables_none else None)
        return ServingEngine(params, cfg, spec(strategy), tables=tb,
                             mesh=m, **engine_kw(**kw))

    for s in STRATEGIES:
        timed(f"static/{s}", lambda: serve(eng(s), "static"))
        assert not act_sharding.installed()
    for s in STRATEGIES:
        if s == "mixed":
            continue
        timed(f"continuous/{s}", lambda: serve(eng(s)))
    # the mixed continuous run: warning, fixed point, report, counters
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        e = eng("mixed")
    # any warning but the rules' (warn-once) replication fallbacks
    res["pin_warning"] = [str(w.message) for w in caught
                          if w.category.__name__
                          != "ShardingFallbackWarning"]
    res["param_bytes"] = param_bytes(e, mesh)
    bad, calls = watch_fixed_point(e)
    before = attention.plain_verify.calls
    with RouteProbe() as route:
        timed("continuous/mixed", lambda: serve(e))
    res["mixed_counters"] = (route.types,
                             attention.plain_verify.calls - before)
    res["fixed_point/linear"] = (bad, calls)
    res["report/linear"] = e.mesh_report()
    res["installed_after"] = act_sharding.installed()
    # the same engine class without a mesh, in the same process, keeps its
    # config's route (no plain_verify for this config, no DTensor)
    before = attention.plain_verify.calls
    with RouteProbe() as route:
        timed("then_plain", lambda: serve(eng("mixed", m=None),
                                          prompts=PROMPTS[:2]))
    res["then_plain_counters"] = (route.types["DTensor"],
                                  attention.plain_verify.calls - before)
    for s in ("greedy", "mixed"):
        e = eng(s, paged=True, page_size=8)
        bad, calls = watch_fixed_point(e)
        timed(f"paged/{s}", lambda: serve(e))
        res[f"fixed_point/paged/{s}"] = (bad, calls)
        res[f"report/paged/{s}"] = e.mesh_report()
        res[f"pool/paged/{s}"] = e.pool_stats()
    timed("adaptive", lambda: serve(eng("mixed", adaptive=True, arms=ARMS)))
    timed("sampled", lambda: serve(eng("mixed"), sampled=(1, 3)))
    timed("collectives/linear",
          lambda: one_step_collectives(eng("mixed"), False))
    timed("collectives/paged", lambda: one_step_collectives(
        eng("mixed", paged=True, page_size=8), True))
    params_dt = shd.rebuild(params, lambda p, t: L.distribute(
        t, mesh, shd.param_pspec(mesh, p, t)))
    timed("logits", lambda: logits_gap(params_dt, params, cfg, mesh))
    # every dividing shape of the same four ranks; on (1, 4) a buffer of
    # 16 + 19 + 3 + 2 = 40 slots takes the cache sequence over "model"
    # (2 kv heads divide 4 ranks not), so its reads gather the sequence
    # and its writes land on the shard that holds their slot
    for shape, cap in (((1, 4), 19), ((4, 1), 16)):
        m = make_debug_mesh(shape, "cpu")
        e = eng("mixed", m=m, max_new_cap=cap)
        timed(f"shape/{shape[0]}x{shape[1]}",
              lambda: serve(e, prompts=PROMPTS[:3]))
        res[f"report/{shape[0]}x{shape[1]}"] = e.mesh_report()
    # tables built by the meshed engine itself (the sweep sharded)
    tb = eng("mixed", tables_none=True).tables
    res["tables"] = tuple(getattr(tb, n).numpy() for n in (
        "unigram_topk", "bigram_topk", "bigram_chain"))
    # one MoE case: the expert 3-D rule and the capacity ranks, sharded
    mcfg, mparams = data["moe_cfg"], data["moe_params"]
    timed("moe", lambda: serve(ServingEngine(
        mparams, mcfg, spec("greedy"), mesh=mesh, **engine_kw())))
    res["moe_report"] = ServingEngine(
        mparams, mcfg, spec("greedy"), mesh=mesh,
        **engine_kw()).mesh_report()
    res["seconds"] = secs
    return res


RECURRENT = ("jamba", "xlstm")
RECURRENT_LEAVES = ("conv", "ssm", "C", "n", "m", "c", "h")


def recurrent_step_collectives(eng, paged=False):
    """Admit the prompts, then count one continuous mixed step's
    collectives; whether any took a recurrent state leaf's local storage
    as its input (a leaf gathered), and the parameters' gathers."""
    from repro_torch.distributed import local as L
    from repro_torch.distributed.sharding import state_leaf_items
    for p, m in PROMPTS[:4]:
        eng.submit(p, max_new_tokens=m)
    eng.step()
    leaves = {"/".join(p): t.to_local().untyped_storage().data_ptr()
              for p, t in state_leaf_items(eng._cont_state)
              if p[0] == "model" and p[-1] in RECURRENT_LEAVES}
    L.PARAM_GATHERS = []
    try:
        with CollectiveBytes() as cb:
            eng._cont_state = eng._run_step(eng._cont_state)
        gathers = L.PARAM_GATHERS
    finally:
        L.PARAM_GATHERS = None
    eng.serve_continuous()
    from repro_torch.distributed.sharding import walk
    unsplit = sorted({t.numel() * t.element_size()
                      for p, t in walk(eng.params) if p[-1] == "router"})
    return dict(cb.summary(), paged=paged, param_gathers=gathers,
                router_bytes=unsplit, leaves=sorted(leaves),
                leaves_gathered=sorted(p for p, ptr in leaves.items()
                                       if ptr in cb.inputs))


def recurrent_cases(rank, data):
    """The recurrent mixers under the mesh: jamba-smoke (Mamba with its
    MoE FFN, attention) and xlstm-smoke (mLSTM, sLSTM), and xlstm-smoke
    with two heads on (1, 4), whose C falls to the head-dim sharding."""
    from repro_torch.distributed import local as L
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.serving.engine import ServingEngine
    meshes = {"2x2": make_debug_mesh((2, 2), "cpu")}
    res, secs = {}, {}

    def timed(name, fn):
        t0 = time.perf_counter()
        res[name] = fn()
        secs[name] = time.perf_counter() - t0

    def eng(arch, strategy, m="2x2", **kw):
        cfg, params, tables = data[arch]
        tb = tables if strategy != "greedy" or kw.get("adaptive") else None
        return ServingEngine(params, cfg, spec(strategy), tables=tb,
                             mesh=meshes[m], **engine_kw(**kw))

    for arch in RECURRENT:
        for s in ("greedy", "mixed"):
            timed(f"{arch}/static/{s}", lambda: serve(eng(arch, s),
                                                      "static"))
        timed(f"{arch}/continuous/greedy",
              lambda: serve(eng(arch, "greedy")))
        e = eng(arch, "mixed")
        bad, calls = watch_fixed_point(e)
        timed(f"{arch}/continuous/mixed", lambda: serve(e))
        res[f"{arch}/fixed_point/linear"] = (bad, calls)
        res[f"{arch}/report/2x2"] = e.mesh_report()
    for s in ("greedy", "mixed"):
        e = eng("jamba", s, paged=True, page_size=8)
        bad, calls = watch_fixed_point(e)
        timed(f"jamba/paged/{s}", lambda: serve(e))
        res[f"jamba/fixed_point/paged/{s}"] = (bad, calls)
        res[f"jamba/pool/paged/{s}"] = e.pool_stats()
    timed("jamba/adaptive", lambda: serve(eng("jamba", "mixed",
                                              adaptive=True, arms=ARMS)))
    for shape in ((1, 4), (4, 1)):
        name = f"{shape[0]}x{shape[1]}"
        meshes[name] = make_debug_mesh(shape, "cpu")
        for arch in RECURRENT:
            e = eng(arch, "mixed", m=name)
            timed(f"{arch}/shape/{name}",
                  lambda: serve(e, prompts=PROMPTS[:3]))
            res[f"{arch}/report/{name}"] = e.mesh_report()
    e = eng("xlstm-h2", "mixed", m="1x4")
    timed("xlstm-h2/shape/1x4", lambda: serve(e, prompts=PROMPTS[:3]))
    res["xlstm-h2/report/1x4"] = e.mesh_report()
    for arch, m in (("jamba", "2x2"), ("xlstm", "2x2"), ("xlstm-h2", "1x4")):
        cfg, params, _ = data[arch]
        mesh = meshes[m]
        params_dt = shd.rebuild(params, lambda p, t: L.distribute(
            t, mesh, shd.param_pspec(mesh, p, t)))
        timed(f"{arch}/logits", lambda: logits_gap(params_dt, params, cfg,
                                                   mesh))
        timed(f"{arch}/collectives", lambda: recurrent_step_collectives(
            eng(arch, "mixed", m=m)))
    res["seconds"] = secs
    return res


def run(rank, world, init, data_path, out_path, which="attention"):
    torch.set_num_threads(1)
    warnings.simplefilter("ignore")
    # a collective that waits past the timeout raises: a hang fails
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=COLL_TIMEOUT_S))
    try:
        with open(data_path, "rb") as f:
            data = pickle.load(f)
        try:
            res = (cases if which == "attention"
                   else recurrent_cases)(rank, data)
        except Exception:
            res = {"error": traceback.format_exc()}
        if rank == 0:
            with open(out_path + ".tmp", "wb") as f:
                pickle.dump(res, f)
            os.replace(out_path + ".tmp", out_path)
    finally:
        dist.destroy_process_group()
