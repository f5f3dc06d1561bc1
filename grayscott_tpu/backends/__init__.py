"""Backend registry and auto-selection.

Analog of ``compute/selector`` (compute/selector/src/lib.rs:4-59): the
reference picks the best enabled backend at compile time via a cfg_if
priority chain; here the choice is at runtime via :func:`best_backend`
(overridable with the ``GRAYSCOTT_BACKEND`` env var or ``--backend``).

Priority (best first): `sharded` when more than one device is visible and
the domain is worth splitting, else `fused` (one XLA executable per batch
of steps) on any platform; `regular`, `naive` and `conv` are explicit
choices.
"""

from __future__ import annotations

import os
from typing import Dict, Type

from .base import Simulation
from .naive import NaiveSimulation
from .regular import RegularSimulation
from .fused import FusedSimulation
from .conv import ConvSimulation
from .sharded import ShardedSimulation

BACKENDS: Dict[str, Type[Simulation]] = {}


def register(cls: Type[Simulation]) -> None:
    BACKENDS[cls.name] = cls


register(NaiveSimulation)
register(RegularSimulation)
register(FusedSimulation)
register(ConvSimulation)
register(ShardedSimulation)


def get_backend(name: str) -> Type[Simulation]:
    if name not in BACKENDS:
        raise ValueError(f"unknown backend {name!r}; available: {sorted(BACKENDS)}")
    return BACKENDS[name]


def sharded_worthwhile(shape, n_devices: int) -> bool:
    """Is a ``shape`` domain big enough for the ``sharded`` backend to pay
    for its halo exchange across ``n_devices``?

    The selector is supposed to pick the *best* backend, not the widest
    (compute/selector/src/lib.rs:4-59) — an 8-way mesh on a 64x64 domain
    pays exchange and per-shard padding for nothing. Thresholds:

    - some (rows, cols) factorization of the devices must give shards
      at least as deep as the default halo (the SAME viability scan the
      backend's auto mesh uses, parallel/halo.viable_mesh_cols, so the
      selector never rejects a wide-short domain the backend could
      column-shard), and
    - the whole domain must be >= ~1 Mcell — below that one device runs
      a step in microseconds and the exchange overhead dominates.

    An explicit ``--backend sharded`` always wins; this gates only the
    automatic choice."""
    from ..parallel import halo

    rows, cols = int(shape[0]), int(shape[1])
    if rows * cols < 1 << 20:
        return False
    return bool(halo.viable_mesh_cols((rows, cols), max(1, n_devices),
                                      halo.DEFAULT_STEPS_PER_EXCHANGE))


def best_backend_name(shape=None) -> str:
    """Best available backend for the visible devices (selector analog).

    ``shape``, when given, lets the selector skip the multi-device backend
    for domains too small to amortize exchange (see
    :func:`sharded_worthwhile`); without it the historical device-count
    rule stands."""
    forced = os.environ.get("GRAYSCOTT_BACKEND")
    if forced:
        return forced
    import jax

    n = len(jax.devices())
    if n > 1 and (shape is None or sharded_worthwhile(shape, n)):
        return "sharded"
    return "fused"


def best_backend() -> Type[Simulation]:
    return get_backend(best_backend_name())
