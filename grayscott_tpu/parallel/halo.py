"""Multi-device spatial decomposition: shard_map + ppermute halo exchange.

This replaces the reference's shared-memory fork-join parallelism
(``compute/parallel/src/lib.rs:29-121``). The reference splits the grid
across rayon worker threads with halo-overlapped input views
(``SimulateCpu::split_grid``, compute/shared/src/cpu.rs:112-154) — because
memory is shared, halos are implicit overlapping reads. Across devices the
halo must be explicit: each device owns a contiguous tile of the domain
and, once per K-step block, receives K boundary rows (and, on 2-D meshes,
columns) from its neighbours via ``lax.ppermute``, which XLA hands to the
collective library (NCCL on GPUs). Devices at the ends of the
(non-wrapped) permutation receive zeros — exactly the zero-border
condition of the global domain.

2-D meshes use the classic two-phase exchange: rows first (full local
width), then columns of the row-extended tile — which delivers the
diagonal-neighbour corner blocks without explicit corner messages.

K-deep halos amortize exchange latency over K steps: step s of a block
updates the tile plus the K - 1 - s rings of halo that later steps still
read, so the halo shrinks by one ring per step and no exchange happens
inside the block. Every step is the plain XLA slab step
(:func:`grayscott_tpu.ops.stencil.slab_step`); the boundary semantics
follow each cell's global index, computed from ``axis_index`` times the
local extent, so the reference-naive edge quirk stays exact on the shards
that hold the domain's edges. The whole ``n_blocks`` loop runs in one
executable per device (no host round-trips).

Mesh rule: a shard must be at least K rows deep when rows are split, and
K columns wide when columns are split, so that one neighbour supplies the
whole K-deep halo.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import stencil
from ..params import Parameters

ROWS = "rows"
COLS = "cols"

#: Default steps per halo exchange (the halo depth K).
DEFAULT_STEPS_PER_EXCHANGE = 8


def make_mesh(n_devices: int | None = None, n_cols: int = 1) -> Mesh:
    """(n_rows, n_cols) device grid in ``jax.devices()`` order: every
    device reaches every other one at the same rate, so the mesh follows
    the decomposition alone."""
    devices = jax.devices()
    n = n_devices or len(devices)
    if n > len(devices):
        raise ValueError(f"requested {n} devices, have {len(devices)}")
    if n % n_cols != 0:
        raise ValueError(f"{n} devices not divisible by {n_cols} mesh columns")
    grid = np.asarray(devices[:n]).reshape(n // n_cols, n_cols)
    return Mesh(grid, (ROWS, COLS))


def shard_extents(shape, mesh_shape) -> Tuple[int, int]:
    """(r_loc, c_loc): per-shard extents. Domains that do not divide
    evenly are padded at the high end; the padding lies outside the
    global domain and the step keeps it at zero (the reference's GPU
    backend instead errors on such domains — PartialWorkGroupError,
    data/src/concentration/gpu/shape.rs:141-164)."""
    (r, c), (nr, nc) = shape, mesh_shape
    return -(-r // nr), -(-c // nc)


def mesh_viable(shape, nr: int, nc: int, depth: int) -> bool:
    """Whether an (nr, nc) mesh can carry a ``depth``-deep halo on
    ``shape``: each split axis needs shards at least ``depth`` deep."""
    r_loc, c_loc = shard_extents(shape, (nr, nc))
    return (nr == 1 or r_loc >= depth) and (nc == 1 or c_loc >= depth)


def viable_mesh_cols(shape, n: int, depth: int) -> list[int]:
    """Every divisor of ``n`` whose (rows, cols) factorization is
    :func:`mesh_viable` on ``shape`` (possibly empty). The one viability
    scan shared by :func:`choose_mesh_cols` and the backend selector."""
    return [nc for nc in range(1, n + 1)
            if n % nc == 0 and mesh_viable(shape, n // nc, nc, depth)]


def choose_mesh_cols(n: int, shape, depth: int, bias: float = 0.8) -> int:
    """Mesh-column count for ``n`` devices on an (R, C) domain, chosen
    by per-device halo-exchange volume — the auto analog of the
    reference's rayon split always cutting the longest axis first
    (compute/parallel/src/lib.rs:107-114). For each viable (nr, nc)
    factorization the cost is

        cost = row_neighbors * ceil(C/nc) + col_neighbors * ceil(R/nr)

    (an interior device exchanges with 2 neighbours per >2-extent axis).
    1-D row sharding wins ties and anything within ``1 - bias`` (2-D
    meshes pay extra messages and the corner traffic); when 1-D is not
    viable, the cheapest viable 2-D mesh wins outright, and with nothing
    viable the answer is 1 (the backend then rejects the domain)."""
    r, c = shape

    def nb(extent: int) -> int:
        return 0 if extent == 1 else (1 if extent == 2 else 2)

    viable = viable_mesh_cols(shape, n, depth)
    if not viable:
        return 1

    def cost(nc: int) -> int:
        r_loc, c_loc = shard_extents(shape, (n // nc, nc))
        return nb(n // nc) * c_loc + nb(nc) * r_loc

    best = min(viable, key=lambda nc: (cost(nc), nc))
    if 1 not in viable or best == 1:
        return best
    return best if cost(best) < bias * cost(1) else 1


def _exchange(x, axis_name: str, axis: int, n: int, depth: int):
    """Extend ``x`` by ``depth`` cells on both sides of ``axis`` with the
    neighbours' edge cells (zeros at the ends of the mesh axis)."""
    if n == 1:
        pad = [(0, 0), (0, 0)]
        pad[axis] = (depth, depth)
        return jnp.pad(x, pad)
    size = x.shape[axis]
    down = [(i, i + 1) for i in range(n - 1)]
    up = [(i + 1, i) for i in range(n - 1)]
    last = jax.lax.slice_in_dim(x, size - depth, size, axis=axis)
    first = jax.lax.slice_in_dim(x, 0, depth, axis=axis)
    before = jax.lax.ppermute(last, axis_name, down)
    after = jax.lax.ppermute(first, axis_name, up)
    return jax.lax.concatenate([before, x, after], axis)


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "shape", "steps", "params", "boundary"),
    donate_argnames=("u", "v"),
)
def sharded_run_blocks(u, v, n_blocks, *, mesh: Mesh, shape: Tuple[int, int],
                       steps: int, params: Parameters, boundary: str):
    """Run ``n_blocks`` blocks of ``steps`` steps on mesh-sharded state.

    State arrays have shape (n_row_shards, n_col_shards, r_loc, c_loc),
    sharded on the first two axes (:func:`shard_state`). Each block
    exchanges a ``steps``-deep halo, then takes ``steps`` slab steps."""
    nr, nc = mesh.devices.shape
    r_loc, c_loc = u.shape[2], u.shape[3]
    if (nr > 1 and r_loc < steps) or (nc > 1 and c_loc < steps):
        raise ValueError(
            f"{r_loc}x{c_loc} shards cannot carry a {steps}-deep halo "
            f"on a {nr}x{nc} mesh"
        )

    def local(u, v, n_blocks):
        row_start = jax.lax.axis_index(ROWS) * r_loc
        col_start = jax.lax.axis_index(COLS) * c_loc

        def block(_, uv):
            a, b = (
                _exchange(_exchange(x, ROWS, 0, nr, steps), COLS, 1, nc, steps)
                for x in uv
            )
            for s in range(steps):
                ring = steps - 1 - s  # halo rings still needed after step s
                a, b = stencil.slab_step(a, b, row_start - ring,
                                         col_start - ring, shape, params,
                                         boundary)
            return a, b

        out = jax.lax.fori_loop(0, n_blocks, block, (u[0, 0], v[0, 0]))
        return tuple(x[None, None] for x in out)

    spec = P(ROWS, COLS, None, None)
    return jax.shard_map(
        local, mesh=mesh, in_specs=(spec, spec, P()), out_specs=(spec, spec),
    )(u, v, n_blocks)


def shard_state(u: np.ndarray, v: np.ndarray, mesh: Mesh
                ) -> Tuple[jax.Array, jax.Array]:
    """Pack (R, C) host state into (nr, nc, r_loc, c_loc) blocks on the
    mesh, zero-padded at the high end."""
    nr, nc = mesh.devices.shape
    r_loc, c_loc = shard_extents(u.shape, (nr, nc))
    sharding = NamedSharding(mesh, P(ROWS, COLS, None, None))
    out = []
    for x in (u, v):
        xp = np.zeros((nr * r_loc, nc * c_loc), dtype=np.float32)
        xp[: x.shape[0], : x.shape[1]] = x
        blocks = xp.reshape(nr, r_loc, nc, c_loc).transpose(0, 2, 1, 3)
        out.append(jax.device_put(blocks, sharding))
    return out[0], out[1]


def unshard_result(blocks, shape) -> jax.Array:
    """All shards reassembled and cropped to (R, C)."""
    r, c = shape
    nr, nc, r_loc, c_loc = blocks.shape
    full = blocks.transpose(0, 2, 1, 3).reshape(nr * r_loc, nc * c_loc)
    return full[:r, :c]
