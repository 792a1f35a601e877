"""The port's command-line entry points on the CPU (no JAX): ``launch.train``
trains StableLM's smoke config for a few steps and saves it, and
``launch.serve`` serves prompts from that file, statically and
continuously over a paged cache, with outputs equal to
``greedy_reference`` and to a ``ServingEngine`` built directly.
"""
import contextlib
import io
import re

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.spec_engine import SpecConfig, greedy_reference
from repro_torch.data.datasets import make_prompts
from repro_torch.launch import serve, train
from repro_torch.models.transformer import param_shapes
from repro_torch.serving.engine import ServingEngine
from repro_torch.train import checkpoint

ARCH = "stablelm-1.6b"
MAX_NEW, N_PROMPTS = 8, 2


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The port's side in one thread: these models are tiny, and the suite
    runs its files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = main(argv)
    return result, out.getvalue()


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """(checkpoint path, the train CLI's final state, its output)."""
    path = str(tmp_path_factory.mktemp("ckpt") / "stablelm-smoke.npz")
    ts, out = _run(train.main, ["--arch", ARCH, "--steps", "3", "--device",
                                "cpu", "--save", path])
    return path, ts, out


def test_train_cli_writes_a_checkpoint(trained):
    path, ts, out = trained
    lines = out.splitlines()
    assert lines[0].startswith("arch=stablelm-smoke params=")
    assert [ln.split()[1] for ln in lines if ln.startswith("step")] == [
        "0", "2"]
    assert lines[-1] == f"saved -> {path}"
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    want = checkpoint.flatten(ts["params"])
    assert list(flat) == list(want)
    for k, v in want.items():
        np.testing.assert_array_equal(flat[k], v)
    assert sorted(flat) == sorted(_paths(param_shapes(
        get_smoke_config(ARCH))))
    assert int(ts["opt"]["step"]) == 3


def _paths(tree, prefix=""):
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        yield from (_paths(v, key) if isinstance(v, dict) else [key])


@pytest.mark.parametrize("mode", [[], ["--continuous", "--paged"]],
                         ids=["static", "continuous-paged"])
def test_serve_cli_equals_engine_and_greedy(trained, mode):
    path = trained[0]
    served, out = _run(serve.main, ["--arch", ARCH, "--ckpt", path,
                                    "--device", "cpu", "--n-prompts",
                                    str(N_PROMPTS), "--max-new",
                                    str(MAX_NEW)] + mode)
    assert len(served) == N_PROMPTS
    assert sum(ln.startswith("[req ") for ln in out.splitlines()) == N_PROMPTS
    assert ("pool: " in out) == bool(mode)
    cfg = get_smoke_config(ARCH)
    params = checkpoint.load(path, cfg, device="cpu")
    eng = ServingEngine(params, cfg, SpecConfig(max_new_tokens=MAX_NEW),
                        max_batch=N_PROMPTS, max_new_cap=MAX_NEW,
                        paged=bool(mode), device="cpu")
    for prompt, _ in make_prompts("code", N_PROMPTS):
        eng.submit(prompt, max_new_tokens=MAX_NEW)
    direct = eng.serve_continuous() if mode else eng.serve_all()
    order = lambda rs: sorted(rs, key=lambda r: r.request_id)
    for r, d in zip(order(served), order(direct)):
        assert r.prompt == d.prompt
        np.testing.assert_array_equal(r.output_ids, d.output_ids)
        toks = eng.scheduler.pad_to_bucket(eng.tok.encode(r.prompt))
        ref = greedy_reference(params, cfg, toks[None], MAX_NEW,
                               device="cpu")[0, len(toks):].numpy()
        np.testing.assert_array_equal(r.output_ids, ref)
        assert r.stats["new_tokens"] == MAX_NEW


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_serve_cli_refuses_the_mesh(monkeypatch):
    """A mesh larger than the process group, and a mesh of cards on a host
    without them, exit with a clear message."""
    with pytest.raises(SystemExit, match="torchrun --nproc-per-node 4"):
        serve.main(["--arch", ARCH, "--mesh", "2x2"])
    with pytest.raises(SystemExit, match="DxM"):
        serve.main(["--arch", ARCH, "--mesh", "2by2", "--device", "cpu"])
    # under a launcher's one-rank group (torchrun's environment)
    for k, v in dict(WORLD_SIZE="1", RANK="0", MASTER_ADDR="localhost",
                     MASTER_PORT=str(_free_port())).items():
        monkeypatch.setenv(k, v)
    with pytest.raises(SystemExit, match="needs 4 ranks but the process "
                                         "group has 1"):
        serve.main(["--arch", ARCH, "--mesh", "2x2", "--device", "cpu"])
    assert not torch.distributed.is_initialized()


def test_serve_cli_mesh_prints_the_same_texts(trained):
    """``--mesh 2x2 --device cpu``: this process as rank 0 of four gloo
    ranks (three spawned) prints what the call without ``--mesh`` prints,
    then the mesh line."""
    argv = ["--arch", ARCH, "--ckpt", trained[0], "--device", "cpu",
            "--n-prompts", str(N_PROMPTS), "--max-new", str(MAX_NEW),
            "--continuous"]
    plain, out = _run(serve.main, argv)
    meshed, out_m = _run(serve.main, argv + ["--mesh", "2x2"])
    # request ids count on across the process's engines: compare the rest
    drop_id = lambda text: [re.sub(r"^\[req \d+\] ", "", ln)
                            for ln in text.splitlines()]
    lines = drop_id(out_m)
    assert lines[:-1] == drop_id(out)
    assert lines[-1].startswith("mesh: {'data': 2, 'model': 2} params "
                                "sharded ")
    for a, b in zip(plain, meshed):
        np.testing.assert_array_equal(a.output_ids, b.output_ids)
    assert not torch.distributed.is_initialized()


def test_serve_cli_mesh_serves_the_hybrid(tmp_path):
    """The recurrent mixers serve under ``--mesh``: jamba-smoke (Mamba with
    its MoE FFN, plus attention), trained two steps and saved, served over
    ``--mesh 1x1 --device cpu`` prints what the call without ``--mesh``
    prints, then the mesh line."""
    arch = "jamba-1.5-large-398b"
    path = str(tmp_path / "jamba-smoke.npz")
    _run(train.main, ["--arch", arch, "--steps", "2", "--batch", "2",
                      "--device", "cpu", "--save", path])
    argv = ["--arch", arch, "--ckpt", path, "--device", "cpu",
            "--n-prompts", str(N_PROMPTS), "--max-new", str(MAX_NEW),
            "--continuous"]
    plain, out = _run(serve.main, argv)
    meshed, out_m = _run(serve.main, argv + ["--mesh", "1x1"])
    drop_id = lambda text: [re.sub(r"^\[req \d+\] ", "", ln)
                            for ln in text.splitlines()]
    lines = drop_id(out_m)
    assert lines[:-1] == drop_id(out)
    assert lines[-1].startswith("mesh: {'data': 1, 'model': 1} params "
                                "sharded ")
    assert len(meshed) == N_PROMPTS
    for a, b in zip(plain, meshed):
        np.testing.assert_array_equal(a.output_ids, b.output_ids)
    assert not torch.distributed.is_initialized()


def test_cli_refusals_and_help(capsys):
    with pytest.raises(SystemExit, match="--continuous"):
        serve.main(["--arch", ARCH, "--paged", "--device", "cpu"])
    with pytest.raises(SystemExit, match="encoder-only"):
        serve.main(["--arch", "hubert-xlarge", "--device", "cpu"])
    with pytest.raises(SystemExit, match="embedding-input"):
        train.main(["--arch", "hubert-xlarge", "--device", "cpu"])
    with pytest.raises(SystemExit) as exc:
        serve.main(["--help"])
    assert exc.value.code == 0
    assert "--backend flag has no counterpart" in " ".join(
        capsys.readouterr().out.split())
