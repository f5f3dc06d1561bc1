"""Sharded XLA step vs the oracle on row meshes of 2 and 4 devices, both
boundaries, every stencil, one and three steps per halo exchange
(conftest.sharded_parity_case)."""

import pytest

from conftest import STENCIL_NAMES, sharded_parity_case


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("stencil", STENCIL_NAMES)
@pytest.mark.parametrize("boundary", ["naive", "zero"])
@pytest.mark.parametrize("mesh", [(2, 1), (4, 1)])
def test_sharded_matches_oracle(rng, mesh, boundary, stencil, k):
    sharded_parity_case(rng, mesh, boundary, stencil, k)
