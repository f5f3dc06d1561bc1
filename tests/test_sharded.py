"""Multi-chip sharding tests on the 8-virtual-device CPU mesh — the fake
backend the reference's CI explicitly lacks (.github/workflows/ci.yml FIXME,
SURVEY.md section 4)."""

import jax
import numpy as np
import pytest

from grayscott_tpu import oracle
from grayscott_tpu.backends.sharded import ShardedSimulation
from grayscott_tpu.params import Parameters
from grayscott_tpu.species import initial_uv

from conftest import random_uv


def run_sharded(u, v, params, boundary, steps, n_devices, **kw):
    sim = ShardedSimulation(
        params, boundary=boundary, n_devices=n_devices, **kw
    )
    species = sim.make_species(u.shape)
    species.storage = sim.build_storage(u, v)
    sim.perform_steps(species, steps)
    return species.uv_host()


def test_eight_devices_available():
    assert len(jax.devices()) == 8


@pytest.mark.parametrize("n,boundary", [(2, "naive"), (8, "naive"), (4, "zero")])
def test_sharded_parity(rng, params, boundary, n):
    """Halo exchange + per-shard kernel == global oracle, incl. the naive
    edge quirk at the true domain boundary."""
    u, v = random_uv(rng, (64, 16))
    ou, ov = oracle.run(u, v, params, 4, boundary)
    gu, gv = run_sharded(u, v, params, boundary, 4, n, steps_per_exchange=4)
    np.testing.assert_allclose(gu, ou, rtol=0, atol=1e-6)
    np.testing.assert_allclose(gv, ov, rtol=0, atol=1e-6)


def test_multiple_blocks_cross_shard(rng, params):
    """9 steps = 2 full K=4 blocks + remainder; halo refills between blocks,
    and the pattern crosses shard boundaries (standard init box)."""
    u0, v0 = initial_uv((32, 16))
    ou, ov = oracle.run(u0, v0, params, 9, "naive")
    gu, gv = run_sharded(u0, v0, params, "naive", 9, 4, steps_per_exchange=4)
    np.testing.assert_allclose(gu, ou, rtol=0, atol=1e-6)
    np.testing.assert_allclose(gv, ov, rtol=0, atol=1e-6)


def test_indivisible_rows_padded_internally(rng, params):
    """Domains that don't divide evenly across shards pad internally and
    stay exact (the reference GPU backend errors instead,
    data/src/concentration/gpu/shape.rs:141-164)."""
    u, v = random_uv(rng, (60, 16))
    ou, ov = oracle.run(u, v, params, 4, "naive")
    gu, gv = run_sharded(u, v, params, "naive", 4, 8, steps_per_exchange=4)
    np.testing.assert_allclose(gu, ou, rtol=0, atol=1e-6)
    np.testing.assert_allclose(gv, ov, rtol=0, atol=1e-6)


def test_odd_2d_domain(rng, params):
    """Odd rows AND cols on a 2-D mesh (29x21 over 2x2)."""
    u, v = random_uv(rng, (29, 21))
    ou, ov = oracle.run(u, v, params, 3, "naive")
    sim = ShardedSimulation(
        params, boundary="naive", n_devices=4, mesh_cols=2,
        steps_per_exchange=4,
    )
    species = sim.make_species((29, 21))
    species.storage = sim.build_storage(u, v)
    sim.perform_steps(species, 3)
    gu, gv = species.uv_host()
    np.testing.assert_allclose(gu, ou, rtol=0, atol=1e-6)
    np.testing.assert_allclose(gv, ov, rtol=0, atol=1e-6)


@pytest.mark.parametrize("mesh,boundary", [((2, 2), "naive"), ((2, 2), "zero"),
                                           ((2, 4), "naive")])
def test_2d_mesh_parity(rng, params, mesh, boundary):
    """2-D spatial decomposition: row AND column halos (with corner blocks
    via the two-phase exchange) match the global oracle."""
    nr, nc = mesh
    u, v = random_uv(rng, (16 * nr, 16 * nc))
    ou, ov = oracle.run(u, v, params, 4, boundary)
    sim = ShardedSimulation(
        params, boundary=boundary, n_devices=nr * nc, mesh_cols=nc,
        steps_per_exchange=4,
    )
    species = sim.make_species(u.shape)
    species.storage = sim.build_storage(u, v)
    sim.perform_steps(species, 4)
    gu, gv = species.uv_host()
    np.testing.assert_allclose(gu, ou, rtol=0, atol=1e-6)
    np.testing.assert_allclose(gv, ov, rtol=0, atol=1e-6)


def test_2d_mesh_multiblock(rng, params):
    """Two K-blocks on a 2-D mesh: corner data crosses diagonal shards."""
    from grayscott_tpu.species import initial_uv

    u0, v0 = initial_uv((32, 32))
    ou, ov = oracle.run(u0, v0, params, 8, "naive")
    sim = ShardedSimulation(
        params, boundary="naive", n_devices=4, mesh_cols=2,
        steps_per_exchange=4,
    )
    species = sim.make_species((32, 32))
    sim.perform_steps(species, 8)
    gu, gv = species.uv_host()
    np.testing.assert_allclose(gu, ou, rtol=0, atol=1e-6)
    np.testing.assert_allclose(gv, ov, rtol=0, atol=1e-6)


def test_deep_k_sharded(rng, params):
    """Deep exchange: K=9 steps per exchange on 16-row shards."""
    u, v = random_uv(rng, (32, 16))
    ou, ov = oracle.run(u, v, params, 9, "naive")
    gu, gv = run_sharded(u, v, params, "naive", 9, 2, steps_per_exchange=9)
    np.testing.assert_allclose(gu, ou, rtol=0, atol=1e-6)
    np.testing.assert_allclose(gv, ov, rtol=0, atol=1e-6)


def test_sharded_extract_result_matches_uv(rng, params):
    """extract_result builds only V's view (no U materialization); it
    must equal extract_uv[1] on 1-D and 2-D meshes."""
    u, v = random_uv(rng, (32, 16))
    for mesh_cols in (1, 2):
        sim = ShardedSimulation(params, boundary="naive", n_devices=4,
                                mesh_cols=mesh_cols, steps_per_exchange=4)
        species = sim.make_species((32, 16))
        species.storage = sim.build_storage(u, v)
        sim.perform_steps(species, 8)
        vr = np.asarray(sim.extract_result(species.storage, species.shape))
        v2 = np.asarray(sim.extract_uv(species.storage, species.shape)[1])
        np.testing.assert_array_equal(vr, v2)


def test_choose_mesh_cols_geometry():
    """AUTO mesh factorization: 2-D chosen over 1-D when it decisively
    cuts per-device halo exchange, 1-D kept otherwise."""
    from grayscott_tpu.parallel import halo

    # square 16384^2 on 8 devices: 4x2 halves the exchange volume
    assert halo.choose_mesh_cols(8, (16384, 16384), 8) == 2
    # tall-skinny: row sharding already minimal
    assert halo.choose_mesh_cols(8, (16384, 1024), 8) == 1
    # narrow: column splits buy nothing over the row split
    assert halo.choose_mesh_cols(8, (4096, 200), 8) == 1
    # single device: trivially 1
    assert halo.choose_mesh_cols(1, (4096, 4096), 8) == 1
    # wide-flat: column-heavy factorization wins
    assert halo.choose_mesh_cols(8, (64, 65536), 8) >= 4


def test_auto_mesh_resolution(rng, params):
    """mesh_cols=None resolves the mesh from the domain geometry at
    first storage build; small-width domains stay 1-D."""
    sim = ShardedSimulation(params, n_devices=4)
    assert sim.mesh is None
    u, v = random_uv(rng, (64, 16))
    sim.build_storage(u, v)
    assert sim.mesh is not None
    assert sim.mesh.devices.shape == (4, 1)  # narrow domain stays 1-D
    # wide square domain on 4 devices -> 2x2
    sim2 = ShardedSimulation(params, n_devices=4, steps_per_exchange=4)
    sim2._resolve_mesh((4096, 4096))
    assert tuple(sim2.mesh.devices.shape) == (2, 2)


def test_choose_mesh_cols_nonviable_1d_prefers_2d():
    """Shards must be at least K deep on every split axis: when 1-D row
    shards are too shallow, a viable column-wise factorization wins."""
    from grayscott_tpu.parallel import halo

    # 32 rows / 8 devices = 4-row shards < K=8 -> 1-D not viable; the
    # pure-column 1x8 mesh (256-col shards) is
    assert halo.choose_mesh_cols(8, (32, 2048), 8) == 8
    # nothing viable at all: 1 (the backend then rejects the domain)
    assert halo.viable_mesh_cols((8, 40), 8, 8) == []
    assert halo.choose_mesh_cols(8, (8, 40), 8) == 1


def test_sharded_run_blocks_rejects_shallow_shards():
    """A shard shallower than the halo cannot supply its neighbour's
    K-deep halo: the step refuses it instead of computing wrong seams,
    and the backend rejects the domain at storage build."""
    from grayscott_tpu.errors import UnsupportedConfigError
    from grayscott_tpu.parallel import halo

    mesh = halo.make_mesh(4, 2)
    z = np.zeros((2, 2, 16, 4), np.float32)
    with pytest.raises(ValueError, match="halo"):
        halo.sharded_run_blocks(
            z, z, 1, mesh=mesh, shape=(32, 8), steps=8,
            params=Parameters(), boundary="zero",
        )
    sim = ShardedSimulation(Parameters(), n_devices=4, mesh_cols=2,
                            steps_per_exchange=8)
    with pytest.raises(UnsupportedConfigError, match="halo"):
        sim.build_storage(np.zeros((32, 8), np.float32),
                          np.zeros((32, 8), np.float32))
