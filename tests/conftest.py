"""Test configuration.

Tests run on the CPU platform with 8 virtual devices so that multi-device
sharding (halo exchange over a mesh) is exercised without GPUs — the
standard JAX trick the reference lacks for its GPU backends (see SURVEY.md
section 4 and .github/workflows/ci.yml:201-206's FIXME).

Tests that need a GPU carry the ``gpu`` marker and skip elsewhere (the
decision is taken in a fixture, tests/test_gpu.py). Run them on a machine
with a GPU with

    GRAYSCOTT_TEST_GPU=1 python -m pytest tests/test_gpu.py -m gpu
"""

import os

# Must be set before jax is imported by any test module. Plain assignment,
# not setdefault: tests must not take a GPU from whatever else runs there.
if not os.environ.get("GRAYSCOTT_TEST_GPU"):
    # env assignment too (not just jax.config): subprocess-spawning tests
    # (two-process jax.distributed, CLI drivers) inherit the environment
    os.environ["JAX_PLATFORMS"] = "cpu"
    # the suite's thousands of tiny executables stay out of the
    # checkout's persistent compilation cache (utils/cache.py)
    os.environ["GRAYSCOTT_NO_PERSISTENT_CACHE"] = "1"
    from grayscott_tpu.utils.runtime import force_virtual_devices

    force_virtual_devices(8)

import numpy as np
import pytest

from grayscott_tpu.params import Parameters


@pytest.fixture
def params():
    return Parameters()


@pytest.fixture
def rng():
    return np.random.RandomState(42)


def random_uv(rng, shape):
    """Random but physically-plausible concentrations."""
    u = rng.uniform(0.0, 1.0, shape).astype(np.float32)
    v = rng.uniform(0.0, 1.0, shape).astype(np.float32)
    return u, v


@pytest.fixture(autouse=True, scope="module")
def _bound_jit_state_per_module():
    """Clear JAX's compiled-program caches after every test module, so
    the live JIT code arena stays bounded over the whole suite instead of
    growing with every module's executables."""
    yield
    import jax

    jax.clear_caches()


# -- slow-marker split ---------------------------------------------------------
# The multi-process heavyweights get an automatic `slow` marker so the
# edit-test loop can run `pytest -m "not slow"` quickly; plain
# `pytest tests/` still runs EVERYTHING — the split deselects, it never
# skips. The reference's analog split: fast `cargo test --workspace` on
# every push vs the cron matrix (.github/workflows/ci.yml:12-16).

_SLOW_FILES = {
    "test_distributed.py",    # two-process jax.distributed
    "test_distributed_cli.py",  # two-process binary integration
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        if os.path.basename(str(item.fspath)) in _SLOW_FILES:
            item.add_marker(pytest.mark.slow)


#: Stencil names, in the order the sharded parity files parametrize them
STENCIL_NAMES = ("oono-puri", "pretty", "patra-karttunen", "5points")


def sharded_parity_case(rng, mesh, boundary, stencil, k, shape=(29, 23),
                        steps=7):
    """Sharded XLA step on an (nr, nc) mesh of the virtual devices vs the
    oracle: random state on an odd domain (padded shards), ``steps`` =
    whole K-blocks plus a remainder, so the halo refills between blocks
    and the naive edge quirk lands on the shards holding row/column 0."""
    from grayscott_tpu import oracle
    from grayscott_tpu.backends.sharded import ShardedSimulation

    params = Parameters.with_stencil(stencil)
    u, v = random_uv(rng, shape)
    nr, nc = mesh
    sim = ShardedSimulation(params, boundary=boundary, n_devices=nr * nc,
                            mesh_cols=nc, steps_per_exchange=k)
    species = sim.make_species(shape)
    species.storage = sim.build_storage(u, v)
    sim.perform_steps(species, steps)
    assert tuple(sim.mesh.devices.shape) == mesh
    gu, gv = species.uv_host()
    ou, ov = oracle.run(u, v, params, steps, boundary)
    np.testing.assert_allclose(gu, ou, rtol=0, atol=1e-6)
    np.testing.assert_allclose(gv, ov, rtol=0, atol=1e-6)


def load_chip_smoke():
    """chip_smoke.py (a script at the repo root) as a module."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
