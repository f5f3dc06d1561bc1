"""`sharded` backend: multi-device spatial decomposition over a mesh.

The replacement for the reference's `parallel` backend (rayon fork-join
over halo-overlapped grid splits, compute/parallel/src/lib.rs:29-121) —
see grayscott_tpu/parallel/halo.py. Like the reference's
``ParallelSimulation<...>`` composition, this wraps the plain XLA step per
shard and adds the distribution layer on top.
"""

from __future__ import annotations

import argparse
import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..errors import UnsupportedConfigError
from ..parallel import halo
from ..params import Parameters
from .base import Simulation, env_default


@functools.partial(jax.jit, static_argnames=("shape",))
def _v_view(v_blocks, *, shape):
    """V reassembled in one executable, without materializing U."""
    return halo.unshard_result(v_blocks, shape)


class ShardedSimulation(Simulation):
    name = "sharded"

    def __init__(
        self,
        params: Parameters,
        boundary: str = "naive",
        n_devices: int | None = None,
        mesh_cols: int | None = None,
        steps_per_exchange: int | None = None,
        **kwargs,
    ):
        super().__init__(params, boundary)
        if n_devices is not None and n_devices < 1:
            raise UnsupportedConfigError(
                f"n_devices must be >= 1, got {n_devices} (omit the flag "
                "to use every device)"
            )
        if mesh_cols is not None and mesh_cols < 1:
            raise UnsupportedConfigError(
                f"mesh_cols must be >= 1, got {mesh_cols} (omit the flag "
                "for automatic factorization)"
            )
        k = steps_per_exchange or halo.DEFAULT_STEPS_PER_EXCHANGE
        if not 1 <= k <= 32:
            raise ValueError(f"steps_per_exchange must be in [1, 32], got {k}")
        self.steps_per_exchange = k
        self._n_devices = n_devices
        # mesh_cols=None = AUTO: the (rows, cols) factorization is chosen
        # from the domain geometry at first storage build
        # (halo.choose_mesh_cols), because the domain shape is unknown here
        self.mesh = (None if mesh_cols is None
                     else halo.make_mesh(n_devices, mesh_cols))

    def _resolve_mesh(self, shape) -> None:
        if self.mesh is None:
            n = self._n_devices or len(jax.devices())
            self.mesh = halo.make_mesh(
                n, halo.choose_mesh_cols(n, shape, self.steps_per_exchange))

    def build_storage(self, u: np.ndarray, v: np.ndarray):
        self._resolve_mesh(u.shape)
        nr, nc = self.mesh.devices.shape
        if not halo.mesh_viable(u.shape, nr, nc, self.steps_per_exchange):
            r_loc, c_loc = halo.shard_extents(u.shape, (nr, nc))
            raise UnsupportedConfigError(
                f"a {u.shape[0]}x{u.shape[1]} domain on a {nr}x{nc} mesh "
                f"gives {r_loc}x{c_loc} shards, too small for a "
                f"{self.steps_per_exchange}-deep halo; use fewer devices, "
                "another --sharded-mesh-cols or fewer steps per exchange"
            )
        return halo.shard_state(u, v, self.mesh)

    def extract_uv(self, storage, shape) -> Tuple[jax.Array, jax.Array]:
        return tuple(halo.unshard_result(x, shape) for x in storage)

    def extract_result(self, storage, shape):
        return _v_view(storage[1], shape=tuple(shape))

    def run_steps(self, storage, shape, steps: int):
        u, v = storage
        k = self.steps_per_exchange
        n_full, rem = divmod(steps, k)
        common = dict(mesh=self.mesh, shape=tuple(shape), params=self.params,
                      boundary=self.boundary)
        if n_full:
            u, v = halo.sharded_run_blocks(u, v, jnp.int32(n_full), steps=k,
                                           **common)
        if rem:
            u, v = halo.sharded_run_blocks(u, v, jnp.int32(1), steps=rem,
                                           **common)
        return (u, v)

    @classmethod
    def add_cli_args(cls, parser: argparse.ArgumentParser) -> None:
        parser.add_argument(
            "--sharded-devices", type=int,
            default=env_default("GRAYSCOTT_SHARDED_DEVICES", None, int),
            help="Number of devices in the mesh (default: all)",
        )
        parser.add_argument(
            "--sharded-mesh-cols", type=int,
            default=env_default("GRAYSCOTT_SHARDED_MESH_COLS", None, int),
            help="Mesh columns for 2-D spatial decomposition (default: "
            "auto — the (rows, cols) factorization minimizing per-device "
            "halo exchange for the domain geometry, 1-D preferred; "
            "1 forces row sharding only)",
        )
        parser.add_argument(
            "--sharded-steps-per-exchange", type=int,
            default=env_default("GRAYSCOTT_SHARDED_STEPS_PER_EXCHANGE", None,
                                int),
            help="Steps between halo exchanges, which is also the halo "
            f"depth (default {halo.DEFAULT_STEPS_PER_EXCHANGE}; 1-32)",
        )

    @classmethod
    def args_from_namespace(cls, ns: argparse.Namespace):
        return {
            "n_devices": getattr(ns, "sharded_devices", None),
            "mesh_cols": getattr(ns, "sharded_mesh_cols", None),
            "steps_per_exchange": getattr(ns, "sharded_steps_per_exchange",
                                          None),
        }
