"""Double-buffered U/V species state.

JAX re-design of the reference's ``Species``/``Evolving``/
``Concentration`` data model (``data/src/concentration/mod.rs:17-301``).

Design mapping:

- The reference keeps explicit in/out buffer pairs and a ``flip()`` that
  swaps them (``Evolving`` at ``concentration/mod.rs:140-187``). Here the
  double buffer lives *inside* XLA: step functions are functional
  ``(u, v) -> (u', v')`` and buffer donation makes the compiler reuse the
  input device buffers in place, which is the same memory behavior without a
  host-visible buffer swap. ``Species`` therefore stores the *input* state
  (what the reference calls ``in_u``/``in_v`` after a flip).

- The reference's per-backend storage layouts (``ScalarConcentration``,
  ``SIMDConcentration`` with zero-padded edges, ``ImageConcentration``) map
  to per-backend ``storage`` pytrees here: plain ``(R, C)`` arrays for the
  single-device backends and ``(rows, cols)``-mesh-sharded tile arrays for
  the multi-device backend.

- "The simulation result is V's current input concentration"
  (``concentration/mod.rs:94-103``) maps to :meth:`Species.result`.
"""

from __future__ import annotations

from typing import Any, Tuple

import numpy as np

from .params import Precision


def initial_uv(shape: Tuple[int, int]) -> Tuple[np.ndarray, np.ndarray]:
    """Initial concentrations, replicating ``Species::new``
    (reference: data/src/concentration/mod.rs:36-59).

    U = 1 and V = 0 everywhere, except a central box where U = 0 and V = 1.
    The box spans rows ``[7R/16 - 4, 8R/16 - 4)`` (integer division,
    saturating at 0) and columns ``[7C/16, 8C/16)``; the row shift of 4 only
    applies to the row axis (``row_shift`` at ``:44-51``).
    """
    rows, cols = shape
    u = np.ones(shape, dtype=Precision)
    v = np.zeros(shape, dtype=Precision)
    num_range = (7, 8)
    frac = 16
    shifts = (4, 0)  # row_shift applies to axis 0 only
    slices = []
    for axis, n in enumerate(shape):
        start = max(n * num_range[0] // frac - shifts[axis], 0)
        end = max(n * num_range[1] // frac - shifts[axis], 0)
        slices.append(slice(start, end))
    u[tuple(slices)] = Precision(0.0)
    v[tuple(slices)] = Precision(1.0)
    return u, v


class Species:
    """Chemical species state bound to a backend-specific storage layout.

    Construct through ``Simulation.make_species(shape)``; the backend decides
    the storage pytree (the ``Concentration`` trait analog).
    """

    def __init__(self, shape: Tuple[int, int], storage: Any, backend: "Any"):
        self.shape = tuple(shape)
        self.storage = storage
        self._backend = backend
        self.steps_performed = 0

    # -- reference API parity -------------------------------------------------

    def result(self):
        """V's current input concentration as a device array of ``shape``
        (reference: ``Species::access_result``, concentration/mod.rs:94-103).

        The returned array is dispatched asynchronously; call
        :func:`numpy.asarray` on it (or ``result_host``) to synchronize —
        the analog of the reference's GPU ``make_scalar_view_after`` chaining
        readback on the async compute future
        (data/src/concentration/gpu/image/mod.rs:183-206).
        """
        return self._backend.extract_result(self.storage, self.shape)

    def result_host(self) -> np.ndarray:
        """Synchronous host copy of the result (write_result_view analog).

        Multi-process safe: shards living on other hosts are gathered
        (collective — all processes must call this together)."""
        from .utils.distributed import fetch

        return fetch(self.result())

    def uv_host(self) -> Tuple[np.ndarray, np.ndarray]:
        """Host copies of both input concentrations (testing/checkpointing)."""
        from .utils.distributed import fetch

        u, v = self._backend.extract_uv(self.storage, self.shape)
        return fetch(u), fetch(v)
