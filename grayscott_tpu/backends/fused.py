"""`fused` backend: whole multi-step batch on device via lax.fori_loop.

The analog of the reference GPU backends' one-command-buffer-many-dispatches
pattern (compute/gpu/naive/src/lib.rs:99-128): N simulation steps are traced
into a single XLA executable with no host round-trip — on a GPU, one fused
kernel launch per step inside the loop — with donated buffers so the
double-buffer flip (Evolving::flip, data/src/concentration/mod.rs:181)
becomes an in-place device-memory buffer swap chosen by the compiler.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import stencil
from ..params import Parameters
from .base import Simulation


class FusedSimulation(Simulation):
    name = "fused"

    def __init__(
        self,
        params: Parameters,
        boundary: str = "naive",
        runtime_weights: bool = False,
        **kwargs,
    ):
        super().__init__(params, boundary)
        self.runtime_weights = runtime_weights

        if runtime_weights:
            # weights-runtime feature analog (data/src/parameters.rs:40-53):
            # weights and rates are traced operands, so changing parameters
            # (via `sim.params = ...`) never recompiles.
            @partial(jax.jit, donate_argnums=(0, 1))
            def _run(u, v, steps, weights, rates):
                def body(_, uv):
                    return stencil.step_runtime(
                        uv[0], uv[1], weights, rates, boundary
                    )

                return jax.lax.fori_loop(0, steps, body, (u, v))

        else:

            @partial(jax.jit, donate_argnums=(0, 1))
            def _run(u, v, steps):
                def body(_, uv):
                    return stencil.step(uv[0], uv[1], params, boundary)

                return jax.lax.fori_loop(0, steps, body, (u, v))

        self._run = _run

    def build_storage(self, u: np.ndarray, v: np.ndarray):
        return (jnp.asarray(u), jnp.asarray(v))

    def extract_uv(self, storage, shape) -> Tuple[jax.Array, jax.Array]:
        return storage

    def run_steps(self, storage, shape, steps: int):
        u, v = storage
        # steps is a traced operand: changing it does not recompile
        if self.runtime_weights:
            return self._run(
                u, v, jnp.int32(steps),
                jnp.asarray(self.params.weights_array()),
                stencil.rates_array(self.params),
            )
        return self._run(u, v, jnp.int32(steps))
