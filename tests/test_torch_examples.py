"""The PyTorch port's examples (``examples/torch_*.py``) on the CPU.

Each example runs to its end at small flags (``--device cpu``) and prints
the lines of its reference script (``examples/*.py``), in their format;
the quickstart's mixed output equals its greedy output; the phase demo
prints the H100 roofline of ``core/phase.py``.  On weights carried from
the reference serving example's config at ``PRNGKey(0)``
(``weights.from_jax_flat``), the serving example's ``serve`` gives the
reference library's tokens and calls, static greedy and mixed (10, 10),
continuous and paged, on 2 prompts x 16 new tokens in f32.  Torch runs in
one thread.
"""
import os
import re
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "examples"))

import torch_phase_transition_demo as phase_demo  # noqa: E402
import torch_quickstart as quickstart  # noqa: E402
import torch_serve_speculative as serve_ex  # noqa: E402
import torch_train_tiny as train_tiny  # noqa: E402

NUM = r"\d+\.\d\d"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The port's side in one thread: the models are tiny, and the suite
    runs its files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lines(capsys):
    return [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]


def test_quickstart_runs_and_mixed_equals_greedy(capsys):
    out = quickstart.main(["--steps", "3", "--device", "cpu"])
    lines = _lines(capsys)
    assert re.fullmatch(r"trained: loss=\d+\.\d{3}", lines[0])
    heads = [ln for ln in lines if ln.startswith("---")]
    assert [h.split(":")[0] for h in heads] == ["--- greedy", "--- mixed"]
    for h in heads:
        assert re.fullmatch(rf"--- \w+: \d+ calls, {NUM} tokens/call ---", h)
    assert len(out["greedy"]["ids"]) == 64
    assert out["mixed"]["ids"] == out["greedy"]["ids"]
    assert out["mixed"]["calls"] <= out["greedy"]["calls"] == 63


def test_train_tiny_runs(capsys):
    _, curve = train_tiny.main(["--steps", "3", "--device", "cpu"])
    lines = _lines(capsys)
    assert re.fullmatch(r"params: [\d,]+", lines[0])
    assert len(lines) == 4 and len(curve) == 3
    for ln, (i, _, _) in zip(lines[1:], curve):
        assert re.fullmatch(
            rf"step {i:4d}: loss=\d+\.\d{{3}} -> tokens/call={NUM}", ln)
    assert all(tpc >= 1.0 for _, _, tpc in curve)


def test_serve_speculative_runs(capsys):
    out = serve_ex.main(["--steps", "3", "--requests", "2", "--device",
                         "cpu"])
    lines = _lines(capsys)
    assert re.fullmatch(r"trained 3 steps in \d+s, loss=\d+\.\d{3}",
                        lines[0])
    for mode in ("greedy", "spec(10,10)"):
        ln = next(x for x in lines if x.startswith(f"{mode:12s}:"))
        assert re.fullmatch(rf"{re.escape(f'{mode:12s}')}: 2 requests, "
                            rf"\d+ total calls, {NUM} tokens/call, wall "
                            rf"\d+\.\ds", ln)
    assert any(re.match(rf"continuous  : 2 requests, \d+ total calls, "
                        rf"{NUM} tokens/call", x) for x in lines)
    assert any(re.match(r"paged       : 1 requests, 32 tokens, pool \{",
                        x) for x in lines)
    assert sum(ln.startswith("   sample:") for ln in lines) == 2
    assert {m: len(r) for m, r in out.items()} == {
        "greedy": 2, "spec(10,10)": 2, "continuous": 2, "paged": 1}


def test_phase_demo_prints_the_h100_roofline(capsys):
    phase_demo.main(["--device", "cpu"])
    lines = _lines(capsys)
    assert "9.89e+14 FLOP/s, 3.35e+12 B/s, data sheet" in lines[0]
    assert not any("v5e" in ln or "TPU" in ln for ln in lines)
    rows = [ln for ln in lines if re.fullmatch(r"\s*\d+( +\d+\.\d\dx){3}",
                                               ln)]
    assert len(rows) == 8
    from repro_torch.configs import get_config
    from repro_torch.core.phase import slowdown
    cfg = get_config("mistral-7b")
    assert rows[3].split()[2] == f"{slowdown(cfg, 4096, 10, 10):.2f}x"
    assert re.fullmatch(r"\(10,10\)@4k: \d+\.\d GFLOP, \d+\.\d\d GB -> "
                        r"(compute|memory)-bound", lines[-1])


def test_serve_gives_the_reference_librarys_tokens(capsys):
    """The reference serving example's flow (its library, at its config,
    PRNGKey(0) weights) beside the port's ``serve`` on the same weights:
    every request's tokens and model calls are equal."""
    import jax
    from repro.core.spec_engine import SpecConfig as JSpec
    from repro.models import model as JM
    from repro.models.config import ModelConfig as JConfig
    from repro.serving.engine import ServingEngine as JEngine
    from repro.train.checkpoint import _flatten
    from repro_torch.models.weights import from_jax_flat
    jcfg = JConfig(name="serve-demo", num_layers=3, d_model=160,
                   num_heads=4, num_kv_heads=2, d_ff=384, vocab_size=259,
                   param_dtype=jax.numpy.float32,
                   compute_dtype=jax.numpy.float32)
    jparams = JM.init_params(jax.random.PRNGKey(0), jcfg)
    params = from_jax_flat(_flatten(jparams), serve_ex.CFG, device="cpu")
    from repro_torch.data.datasets import make_prompts
    prompts = [p for p, _ in make_prompts("code", 2)]
    got = serve_ex.serve(params, prompts, "cpu", max_new=16,
                         cont_budgets=(16, 16))
    capsys.readouterr()

    want = {}
    mixed = None
    for mode, spec in [("greedy", JSpec(strategy="greedy",
                                        max_new_tokens=16)),
                       ("spec(10,10)", JSpec(k=10, w=10, strategy="mixed",
                                             max_new_tokens=16))]:
        eng = JEngine(jparams, jcfg, spec, max_batch=4)
        mixed = eng if spec.strategy == "mixed" else mixed
        for p in prompts:
            eng.submit(p, max_new_tokens=16)
        want[mode] = eng.serve_all()
    spec = JSpec(k=10, w=10, strategy="mixed")
    eng = JEngine(jparams, jcfg, spec, tables=mixed.tables, max_batch=4,
                  max_new_cap=64)
    eng.submit(prompts[0], max_new_tokens=16)
    done = []
    for _ in range(3):
        done.extend(eng.step())
    eng.submit(prompts[1], max_new_tokens=16)
    want["continuous"] = done + eng.serve_continuous()
    eng = JEngine(jparams, jcfg, spec, tables=mixed.tables, max_batch=4,
                  max_new_cap=64, paged=True)
    eng.submit(prompts[0], max_new_tokens=16)
    want["paged"] = eng.serve_continuous()

    assert set(got) == set(want)
    for mode in want:
        key = lambda r: r.request_id
        g, w = sorted(got[mode], key=key), sorted(want[mode], key=key)
        assert [r.prompt for r in g] == [r.prompt for r in w], mode
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a.output_ids, b.output_ids,
                                          err_msg=mode)
            assert a.stats["model_calls"] == b.stats["model_calls"], mode
    assert all(len(r.output_ids) == 16 for r in got["greedy"])
    calls = {m: sum(r.stats["model_calls"] for r in got[m]) for m in got}
    assert calls["spec(10,10)"] <= calls["greedy"]
