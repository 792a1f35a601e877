"""K5's backward on the CPU: ``mamba_scan_bwd_plain`` (the plain version of
the backward kernel, ``kernels/csrc/mamba_scan_bwd.cu``'s reverse
recurrence) against the JAX reference's gradient of its scan oracle
(``jax.vjp`` of ``repro/kernels/ref.py:mamba_scan_ref``, the function
whose XLA scan the reference's training differentiates) and against
autograd of the port's oracle, on the same inputs drawn with numpy.

Cases: d_state 4, 8 and 16 (the kernel's capacities) and 3 (a ragged
one), T inside one checkpoint chunk of the kernel (16 steps), across
chunks with a ragged last one, at a whole number of chunks (32) and one
step past it (33: the kernel's checkpoints, which the training forward
writes, end there), u in f32 and bf16, with and without a gradient
flowing into the final state.  The backward kernel's wrapper raises on
operands it does not take before it launches anything.  Tolerance: f32 1e-5 relative to
each gradient's largest magnitude (both sides run the same f32
recurrence; they differ by summation order, ~1e-7 here).  On the CPU the
scan's gradient stays autograd of the plain version: a training step
never reaches the backward kernel here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import dispatch, ref
from repro_torch.kernels.mamba_scan import (CHUNK, mamba_scan_bwd_cuda,
                                           mamba_scan_bwd_plain, n_chunks)

TOL = 1e-5
NAMES = ("du", "ddt", "dA", "dB", "dC", "dD", "dh0")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, Bt, T, di, ds, u_dtype):
    """The reference kernel test's distributions (numpy), u rounded to
    ``u_dtype``; the incoming gradients dy and dhT."""
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)
    u = torch.from_numpy(n(Bt, T, di)).to(u_dtype)
    ops = dict(u=u, dt=torch.from_numpy(np.log1p(np.exp(n(Bt, T, di)))),
               A=torch.from_numpy(-np.exp(n(di, ds) * 0.3)),
               B=torch.from_numpy(n(Bt, T, ds)),
               C=torch.from_numpy(n(Bt, T, ds)),
               D=torch.from_numpy(n(di)), h0=torch.from_numpy(n(Bt, di, ds)))
    return ops, torch.from_numpy(n(Bt, T, di)), torch.from_numpy(
        n(Bt, di, ds))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("u_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [5, 37, 2 * CHUNK, 2 * CHUNK + 1])
@pytest.mark.parametrize("ds", [4, 8, 16, 3])
def test_plain_backward_equals_jax_gradient(ds, T, u_dtype):
    ops, dy, dhT = _inputs(ds * 100 + T, 2, T, 12, ds,
                           getattr(torch, u_dtype))
    names = ("u", "dt", "A", "B", "C", "D", "h0")
    got = mamba_scan_bwd_plain(*(ops[k] for k in names), dy, dhT)
    # the reference's gradient: jax.vjp of its oracle at u's f32 values
    args = [jnp.asarray(ops[k].float().numpy()) for k in names]
    _, vjp = jax.vjp(jref.mamba_scan_ref, *args)
    want = vjp((jnp.asarray(dy.numpy()), jnp.asarray(dhT.numpy())))
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        assert _rel(g.numpy(), w) < TOL, (name, _rel(g.numpy(), w))


@pytest.mark.parametrize("final", [False, True])
def test_plain_backward_equals_port_autograd(final):
    """Against autograd of the port's oracle (the CPU's training path),
    with (final) and without a gradient into the final state."""
    ops, dy, dhT = _inputs(7, 3, 20, 8, 16, torch.float32)
    names = ("u", "dt", "A", "B", "C", "D", "h0")
    leaves = [ops[k].clone().requires_grad_() for k in names]
    y, hT, _ = ref.mamba_scan_ref(*leaves)
    loss = (y * dy).sum() + ((hT * dhT).sum() if final else 0)
    want = torch.autograd.grad(loss, leaves)
    got = mamba_scan_bwd_plain(*(ops[k] for k in names), dy,
                               dhT if final else None)
    for name, g, w in zip(NAMES, got, want):
        assert _rel(g.numpy(), w.numpy()) < TOL, name


def test_cpu_training_call_differentiates_the_plain_version():
    """On the CPU ``dispatch.selective_scan`` under autograd is the plain
    version's graph: its gradients are the backward's plain version's."""
    ops, dy, _ = _inputs(3, 2, 9, 8, 8, torch.float32)
    names = ("u", "dt", "A", "B", "C", "D", "h0")
    leaves = [ops[k].clone().requires_grad_() for k in names]
    y, hT, _ = dispatch.selective_scan(*leaves, final=False)
    assert hT is None
    want = torch.autograd.grad((y * dy).sum(), leaves)
    got = mamba_scan_bwd_plain(*(ops[k] for k in names), dy)
    for name, g, w in zip(NAMES, got, want):
        assert _rel(g.numpy(), w.numpy()) < TOL, name


@pytest.mark.parametrize("case", ["cpu operands", "ds 17", "ds 0",
                                  "ckpt shape"])
def test_bwd_kernel_wrapper_raises(case):
    """``mamba_scan_bwd_cuda`` refuses what its kernel does not take: CPU
    operands (the CPU's training path is autograd of the plain version),
    a state size outside 1..16 and checkpoints of the wrong shape, each
    with a ValueError before any launch."""
    ds = {"ds 17": 17, "ds 0": 0}.get(case, 8)
    ops, dy, _ = _inputs(5, 2, 20, 8, max(ds, 1), torch.float32)
    names = ("u", "dt", "A", "B", "C", "D", "h0")
    args = [ops[k] for k in names]
    if ds == 0:
        args[2], args[3], args[4], args[6] = (t[..., :0] for t in (
            args[2], args[3], args[4], args[6]))
    ckpt = None
    if case == "ckpt shape":
        ckpt = torch.zeros(2, n_chunks(20) + 1, 8, ds)
    match = "CUDA device" if case in ("cpu operands", "ckpt shape") \
        else "unsupported scan"
    if case == "ckpt shape":
        match = "ckpt has shape"
    with pytest.raises(ValueError, match=match):
        mamba_scan_bwd_cuda(*args, dy, None, ckpt)


def test_checkpoint_count():
    """The training forward keeps the state before steps 0, CHUNK, ...: a
    T-step scan has ceil(T / CHUNK) checkpoints."""
    assert [n_chunks(T) for T in (1, CHUNK, CHUNK + 1, 8 * CHUNK)] == \
        [1, 1, 2, 8]
