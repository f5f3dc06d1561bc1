"""`regular` backend: vectorized shift-form step, one jit call per step.

Analog of ``compute/regular`` (compute/regular/src/lib.rs:49-202): the
reference splits the domain into a fast center (corrected weights,
``fast_grid_iter``) and general edge slabs. Here that split is expressed
as whole-array shift algebra plus O(R+C) edge strips (see
grayscott_tpu/ops/stencil.py), all fused by XLA into one pass — including
the reference's documented edge anchoring quirk
(compute/regular/src/lib.rs:174-179) when ``boundary="naive"``.

Unlike `fused`, each step is a separate device dispatch (the reference's
``SimulateStep`` loop, compute/shared/src/cpu.rs:30-42).
"""

from __future__ import annotations

from .base import StepwiseSimulation


class RegularSimulation(StepwiseSimulation):
    name = "regular"
