import jax
import jax.numpy as jnp
import pytest

from repro.models.config import BlockSpec, ModelConfig

# NOTE: no XLA_FLAGS device-count override here on purpose — smoke tests and
# benches must see the single real CPU device (the 512-device placeholder
# mesh exists ONLY inside repro/launch/dryrun.py).

F32 = dict(param_dtype=jnp.float32, compute_dtype=jnp.float32)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long model-level suite; deselect with -m 'not slow' for the "
        "inner-loop fast lane (tier-1 verification still runs everything)")
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA card (the port's kernels against their plain "
        "versions); skips without one — run on the card with -m gpu")


@pytest.fixture(scope="module", autouse=True)
def _drop_jit_caches_per_module():
    """Drop jax's compiled-executable caches when a test module finishes.

    Tier-1 runs the whole suite in ONE process and every module compiles
    its own model configs, so the process-global executable cache only
    grows — past a few hundred retained executables XLA:CPU's compiler has
    been observed to segfault mid-compile (deep in backend_compile, late
    in the run).  Cross-module cache reuse is ~nil (each module names its
    own cfg precisely so it gets a fresh cache), so clearing at module
    teardown bounds the growth without re-compiling anything a module
    still needs."""
    yield
    jax.clear_caches()


@pytest.fixture(autouse=True)
def _act_sharding_hygiene():
    """No test may leak an installed activation-sharder mesh into the next
    one: an installed mesh silently pins attn_verify off the Pallas path
    for the whole process (models/attention.py:_use_verify_kernel)."""
    yield
    from repro.distributed import act_sharding
    act_sharding.uninstall()


@pytest.fixture(scope="session")
def tiny_dense_cfg():
    return ModelConfig(name="tiny", num_layers=2, d_model=64, num_heads=4,
                       num_kv_heads=2, d_ff=128, vocab_size=61,
                       **F32).validate()


@pytest.fixture(scope="session")
def tiny_hybrid_cfg():
    return ModelConfig(
        name="tiny-hyb", num_layers=4, d_model=64, num_heads=4,
        num_kv_heads=2, d_ff=128, vocab_size=61,
        num_experts=4, num_experts_per_tok=2,
        block_pattern=(BlockSpec("mamba", "swiglu"), BlockSpec("mamba", "moe"),
                       BlockSpec("attn", "swiglu"), BlockSpec("mamba", "moe")),
        **F32).validate()


@pytest.fixture(scope="session")
def tiny_xlstm_cfg():
    return ModelConfig(
        name="tiny-xl", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=4, d_ff=0, rope="none",
        block_pattern=(BlockSpec("mlstm", "none"), BlockSpec("slstm", "none")),
        **F32).validate()


def make_params(cfg, seed=0):
    from repro.models import model as M
    return M.init_params(jax.random.PRNGKey(seed), cfg)


@pytest.fixture(scope="session")
def tiny_dense(tiny_dense_cfg):
    return tiny_dense_cfg, make_params(tiny_dense_cfg)
