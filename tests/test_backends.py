"""Cross-backend numerical parity tests against the NumPy oracle —
the testing strategy the reference lacks (SURVEY.md section 4)."""

import numpy as np
import pytest

from grayscott_tpu import oracle
from grayscott_tpu.backends import BACKENDS, get_backend
from grayscott_tpu.params import Parameters, STENCILS
from grayscott_tpu.species import initial_uv

from conftest import random_uv

JNP_BACKENDS = ["naive", "regular", "fused", "conv"]


def make_sim(name, params, boundary, **kw):
    return get_backend(name)(params, boundary=boundary, **kw)


@pytest.mark.parametrize("backend", JNP_BACKENDS)
@pytest.mark.parametrize("boundary", ["naive", "zero"])
def test_one_step_parity(rng, params, backend, boundary):
    u, v = random_uv(rng, (24, 33))
    ou, ov = oracle.step(u, v, params, boundary)
    sim = make_sim(backend, params, boundary)
    species = sim.make_species((24, 33))
    species.storage = sim.build_storage(u, v)
    sim.perform_steps(species, 1)
    gu, gv = species.uv_host()
    np.testing.assert_allclose(gu, ou, rtol=0, atol=2e-7)
    np.testing.assert_allclose(gv, ov, rtol=0, atol=2e-7)


@pytest.mark.parametrize("stencil", list(STENCILS))
@pytest.mark.parametrize("backend", JNP_BACKENDS)
def test_all_stencils_one_step(rng, stencil, backend):
    params = Parameters.with_stencil(stencil)
    u, v = random_uv(rng, (16, 17))
    ou, ov = oracle.step(u, v, params, "naive")
    sim = make_sim(backend, params, "naive")
    species = sim.make_species((16, 17))
    species.storage = sim.build_storage(u, v)
    sim.perform_steps(species, 1)
    gu, gv = species.uv_host()
    np.testing.assert_allclose(gu, ou, rtol=0, atol=3e-7)
    np.testing.assert_allclose(gv, ov, rtol=0, atol=3e-7)


@pytest.mark.parametrize("backend", JNP_BACKENDS)
def test_many_steps_from_standard_init(params, backend):
    """100 steps from the standard init box: tolerance budget for f32
    reassociation drift (SURVEY.md 'hard parts')."""
    shape = (48, 64)
    u0, v0 = initial_uv(shape)
    ou, ov = oracle.run(u0, v0, params, 100)
    sim = make_sim(backend, params, "naive")
    species = sim.make_species(shape)
    sim.perform_steps(species, 100)
    gu, gv = species.uv_host()
    np.testing.assert_allclose(gu, ou, rtol=0, atol=1e-5)
    np.testing.assert_allclose(gv, ov, rtol=0, atol=1e-5)


@pytest.mark.parametrize("stencil", list(STENCILS))
@pytest.mark.parametrize("backend", JNP_BACKENDS)
@pytest.mark.parametrize("boundary", ["naive", "zero"])
def test_all_stencils_many_steps(boundary, backend, stencil):
    """50 steps from the standard init box for every stencil under both
    boundaries: the multi-step budget of test_many_steps_from_standard_init
    across the whole stencil x boundary matrix."""
    params = Parameters.with_stencil(stencil)
    shape = (32, 40)
    u0, v0 = initial_uv(shape)
    ou, ov = oracle.run(u0, v0, params, 50, boundary)
    sim = make_sim(backend, params, boundary)
    species = sim.make_species(shape)
    sim.perform_steps(species, 50)
    gu, gv = species.uv_host()
    np.testing.assert_allclose(gu, ou, rtol=0, atol=1e-5)
    np.testing.assert_allclose(gv, ov, rtol=0, atol=1e-5)


def test_naive_backend_near_bitwise(rng, params):
    """The naive jnp backend reproduces the oracle to 1 ulp (XLA may
    contract multiply-adds into FMAs; term order is otherwise identical)."""
    u, v = random_uv(rng, (20, 21))
    ou, ov = oracle.step(u, v, params, "naive")
    sim = make_sim("naive", params, "naive")
    species = sim.make_species((20, 21))
    species.storage = sim.build_storage(u, v)
    sim.perform_steps(species, 1)
    gu, gv = species.uv_host()
    np.testing.assert_allclose(gu, ou, rtol=0, atol=2.4e-7)
    np.testing.assert_allclose(gv, ov, rtol=0, atol=2.4e-7)


def test_registry():
    assert set(JNP_BACKENDS) <= set(BACKENDS)
    with pytest.raises(ValueError):
        get_backend("bogus")


@pytest.mark.parametrize("stencil", ["oono-puri", "5points"])
@pytest.mark.parametrize("boundary", ["naive", "zero"])
def test_runtime_weights(rng, stencil, boundary):
    """weights-runtime analog: traced weights/rates, no recompile on change."""
    params = Parameters.with_stencil(stencil, feed_rate=0.02)
    u, v = random_uv(rng, (14, 19))
    ou, ov = oracle.run(u, v, params, 3, boundary)
    sim = make_sim("fused", params, boundary, runtime_weights=True)
    species = sim.make_species((14, 19))
    species.storage = sim.build_storage(u, v)
    sim.perform_steps(species, 3)
    gu, gv = species.uv_host()
    np.testing.assert_allclose(gu, ou, rtol=0, atol=1e-6)
    np.testing.assert_allclose(gv, ov, rtol=0, atol=1e-6)
    # swap parameters on the live simulation: same executable, new behavior
    sim.params = Parameters.with_stencil("pretty", kill_rate=0.06)
    ou2, ov2 = oracle.step(gu, gv, sim.params, boundary)
    sim.perform_steps(species, 1)
    gu2, gv2 = species.uv_host()
    np.testing.assert_allclose(gu2, ou2, rtol=0, atol=1e-6)
    np.testing.assert_allclose(gv2, ov2, rtol=0, atol=1e-6)


def test_selector_env_override(monkeypatch):
    import grayscott_tpu.backends as B

    monkeypatch.setenv("GRAYSCOTT_BACKEND", "regular")
    assert B.best_backend_name() == "regular"
    monkeypatch.delenv("GRAYSCOTT_BACKEND")
    # on the 8-virtual-CPU-device test platform, multi-device => sharded
    assert B.best_backend_name() == "sharded"


def test_selector_domain_size_guard():
    """Auto-selection skips `sharded` for domains too small to amortize
    halo exchange (the selector picks the BEST backend, not the widest —
    compute/selector/src/lib.rs:4-59). Explicit --backend sharded is
    untouched; only the automatic choice is gated."""
    import grayscott_tpu.backends as B

    # 64x64 on 8 virtual devices: 8 rows/shard and 4 Kcell total — a
    # single-device backend must win
    assert B.best_backend_name(shape=(64, 64)) != "sharded"
    assert not B.sharded_worthwhile((64, 64), 8)
    # a wide-short domain the backend can COLUMN-shard stays worthwhile
    # (review r5 #6: the selector shares the backend's viability scan
    # instead of assuming row sharding)
    assert B.sharded_worthwhile((48, 1 << 16), 8)
    # the flagship 4096^2 stays sharded on any reasonable topology
    assert B.sharded_worthwhile((4096, 4096), 8)
    assert B.best_backend_name(shape=(4096, 4096)) == "sharded"
    # shape omitted: the historical device-count rule stands
    assert B.best_backend_name() == "sharded"


def test_make_simulation_auto_small_domain_not_sharded():
    """The CLI auto path threads the domain into the selector: a small
    run on the 8-virtual-device platform lands on a single-device
    backend."""
    import argparse

    from grayscott_tpu.cli import shared

    parser = argparse.ArgumentParser()
    shared.add_shared_args(parser)
    ns = parser.parse_args(["-r", "64", "-c", "64"])
    sim = shared.make_simulation(ns)
    assert sim.name != "sharded"
