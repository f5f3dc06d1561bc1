"""Multi-host (multi-process) support: meshes beyond one host.

The reference is strictly single-node (no MPI/NCCL; rayon threads are its
only fabric, SURVEY.md §5 "Distributed communication backend"). Scaling
past one host here means a multi-controller JAX program: every host runs
the same binary, ``jax.distributed.initialize`` wires them into one
runtime, ``jax.devices()`` becomes the global device list, and the
existing ``shard_map`` + ``ppermute`` halo exchange
(grayscott_tpu/parallel/halo.py) runs unchanged — XLA hands the neighbour
exchanges to NCCL, over NVLink within a host and the network across
hosts. No simulation code changes; only process bring-up and host I/O
need care:

- initialization is env-driven (`GRAYSCOTT_COORDINATOR` etc.), a no-op in
  the common single-process case;
- host reads of globally-sharded arrays must gather shards that live on
  other hosts (:func:`fetch`);
- exactly one process writes output files (:func:`is_primary`).

tests/test_distributed.py runs two CPU processes through this path.
"""

from __future__ import annotations

import os

import numpy as np


def maybe_initialize(logger=None) -> bool:
    """Initialize ``jax.distributed`` when configured; no-op otherwise.

    Configuration comes from ``GRAYSCOTT_COORDINATOR`` (``host:port``),
    ``GRAYSCOTT_NUM_PROCESSES`` and ``GRAYSCOTT_PROCESS_ID``. When only
    ``GRAYSCOTT_COORDINATOR=auto`` is set, defer entirely to JAX's own
    cluster auto-detection (SLURM, Open MPI, ...). Returns True if
    distributed mode was initialized.
    """
    coord = os.environ.get("GRAYSCOTT_COORDINATOR")
    if not coord:
        return False
    import jax

    # peer-failure detection bound: a dead process is declared failed
    # after this many seconds of missed heartbeats, turning a peer crash
    # into a clean abort of the survivors instead of a hang on the next
    # collective (exercised by tests/test_distributed.py failure
    # injection). JAX's default is 100 s.
    heartbeat = int(os.environ.get("GRAYSCOTT_HEARTBEAT_S", "100"))
    if coord == "auto":
        jax.distributed.initialize(heartbeat_timeout_seconds=heartbeat)
    else:
        jax.distributed.initialize(
            coordinator_address=coord,
            num_processes=int(os.environ["GRAYSCOTT_NUM_PROCESSES"]),
            process_id=int(os.environ["GRAYSCOTT_PROCESS_ID"]),
            heartbeat_timeout_seconds=heartbeat,
        )
    if logger is not None:
        logger.info(
            "distributed: process %d/%d, %d local + %d global devices",
            jax.process_index(), jax.process_count(),
            len(jax.local_devices()), len(jax.devices()),
        )
    return True


def process_count() -> int:
    import jax

    return jax.process_count()


def is_primary() -> bool:
    """True on the process that owns file output (process 0)."""
    import jax

    return jax.process_index() == 0


def fetch(x) -> np.ndarray:
    """Host copy of a (possibly globally-sharded) device array.

    Single-process: plain ``np.asarray``. Multi-process: an allgather of
    the shards (collective — EVERY process must call this, even those that
    discard the result)."""
    if process_count() == 1:
        return np.asarray(x)
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(x, tiled=True))
