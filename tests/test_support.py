"""The backend support matrix contract: every REJECTED combination
raises the one uniform error type (UnsupportedConfigError, a ValueError),
and every supported cell constructs and runs. One parametrized sweep —
the single enforcement surface for grayscott_tpu/support.py's table.
"""

from __future__ import annotations

import numpy as np
import pytest

from grayscott_tpu.backends import get_backend
from grayscott_tpu.backends.sharded import ShardedSimulation
from grayscott_tpu.errors import UnsupportedConfigError
from grayscott_tpu.params import Parameters
from grayscott_tpu import support


@pytest.fixture
def params():
    return Parameters()


# (kwargs for ShardedSimulation, shape or None for ctor-time rejection)
REJECTED_SHARDED = [
    (dict(n_devices=0), None),
    (dict(mesh_cols=0), None),
    # 4-row shards on a 4-device row mesh cannot carry an 8-deep halo
    (dict(n_devices=4, mesh_cols=1, steps_per_exchange=8), (16, 64)),
    # 4-column shards on a 1x4 mesh, same rule on the column axis
    (dict(n_devices=4, mesh_cols=4, steps_per_exchange=8), (64, 16)),
    # the auto mesh finds nothing viable: 1-row shards, 5-column shards
    (dict(n_devices=8, steps_per_exchange=8), (8, 40)),
]

SUPPORTED = [
    ("naive", dict(), "naive"),
    ("regular", dict(), "zero"),
    ("fused", dict(), "naive"),
    ("fused", dict(runtime_weights=True), "zero"),
    ("conv", dict(), "naive"),
    ("sharded", dict(n_devices=4, mesh_cols=1), "naive"),
    ("sharded", dict(n_devices=4, mesh_cols=2), "zero"),
]


@pytest.mark.parametrize("kwargs,shape", REJECTED_SHARDED)
def test_rejected_sharded_combinations(params, kwargs, shape):
    if shape is None:
        with pytest.raises(UnsupportedConfigError):
            ShardedSimulation(params, **kwargs)
        return
    sim = ShardedSimulation(params, **kwargs)
    u = np.zeros(shape, np.float32)
    with pytest.raises(UnsupportedConfigError):
        sim.build_storage(u, u)


@pytest.mark.parametrize("name,kwargs,boundary", SUPPORTED)
def test_supported_combinations(params, name, kwargs, boundary):
    sim = get_backend(name)(params, boundary=boundary, **kwargs)
    species = sim.make_species((32, 32))
    sim.perform_steps(species, 2)
    assert np.isfinite(species.result_host()).all()


def test_uniform_error_type_is_valueerror_subclass():
    assert issubclass(UnsupportedConfigError, ValueError)


def test_matrix_renders_both_formats():
    md = support.render("markdown")
    txt = support.render("text")
    assert md.startswith("| configuration |")
    assert "UnsupportedConfigError" in txt
    assert len(support.MATRIX) >= 5


def test_matrix_in_readme_and_help():
    """The README table block and the CLI --help epilog both come from
    support.py — drift between surfaces fails here."""
    import argparse

    from grayscott_tpu.cli import shared

    readme = open("README.md").read()
    begin = readme.index("<!-- support-matrix:begin")
    end = readme.index("<!-- support-matrix:end -->")
    block = readme[begin:end]
    for combo, status, _ in support.MATRIX:
        assert combo in block, f"README matrix missing: {combo}"
        assert f"| {combo} | {status} |" in block

    parser = argparse.ArgumentParser()
    shared.add_shared_args(parser)
    assert parser.epilog and "support matrix" in parser.epilog
    for combo, _, _ in support.MATRIX:
        assert combo in parser.epilog
