"""`conv` backend: the stencil as an XLA convolution.

The ladder rung that exists to prove a point, like the reference's
`manualvec` ("demonstrate that manual SIMD is not worth it here",
compute/manualvec/src/lib.rs): expressing the 3x3 stencil as
``lax.conv_general_dilated`` hands it to the convolution library (cuDNN on
GPUs), a single-channel 3x3 convolution that moves the same bytes as the
shift algebra of `regular`/`fused` plus the library's layout overheads.
It is still a fully correct backend for both boundary semantics and is
exercised by the parity suite.

The convolution runs at ``lax.Precision.HIGHEST``: at the default
precision cuDNN may compute in TF32, which keeps about three decimal
digits and would break float32 parity with the oracle.

Zero-border semantics are exactly SAME-padded convolution with corrected
weights; the reference-naive semantics subtract a per-cell in-bounds weight
sum (nonconstant only on edge rows/columns) and patch the two anchored-
weight strips, reusing the shared strip math in ops/stencil.py.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import stencil
from ..params import Parameters, Precision
from .base import Simulation


def _edge_ok(n: int) -> np.ndarray:
    """(n, 3) in-bounds indicator of stencil taps per index."""
    ok = np.ones((n, 3), dtype=np.float32)
    ok[0, 0] = 0.0
    ok[-1, 2] = 0.0
    return ok


class ConvSimulation(Simulation):
    name = "conv"

    def __init__(self, params: Parameters, boundary: str = "naive", **kwargs):
        super().__init__(params, boundary)
        w = params.weights_array()
        wc = params.corrected_weights()

        def conv2d(x, kernel):
            return jax.lax.conv_general_dilated(
                x[None, :, :, None],
                jnp.asarray(kernel)[:, :, None, None],
                window_strides=(1, 1),
                padding="SAME",
                dimension_numbers=("NHWC", "HWIO", "NHWC"),
                precision=jax.lax.Precision.HIGHEST,
            )[0, :, :, 0]

        def laplacian(x):
            if boundary == "zero":
                return conv2d(x, wc)
            r, c = x.shape
            # A_mid = conv(x, w) - x * B with B(r, c) = rok(r) . W . cok(c).
            # B equals sum(w) except on the 4 border lines, so apply the
            # constant globally and correct only the last row/column (the
            # first row/column get replaced by the quirk strips below).
            wsum = np.float32(w.sum())
            full = conv2d(x, w) - x * wsum
            b_lastrow = np.einsum(
                "i,ij,cj->c", _edge_ok(r)[-1], w, _edge_ok(c)
            ).astype(np.float32)
            full = full.at[-1, :].add(x[-1, :] * jnp.asarray(wsum - b_lastrow))
            b_lastcol = np.float32(
                np.einsum("i,ij,j->", np.ones(3, np.float32), w, _edge_ok(c)[-1])
            )
            full = full.at[1:-1, -1].add(x[1:-1, -1] * (wsum - b_lastcol))
            top, left = stencil._naive_strips(x, params)
            full = full.at[0, :].set(top)
            full = full.at[1:, 0].set(left[1:])
            return full

        @partial(jax.jit, donate_argnums=(0, 1))
        def run(u, v, steps):
            def body(_, uv):
                u, v = uv
                return stencil.reaction(u, v, laplacian(u), laplacian(v), params)

            return jax.lax.fori_loop(0, steps, body, (u, v))

        self._run = run

    def build_storage(self, u: np.ndarray, v: np.ndarray):
        return (jnp.asarray(u), jnp.asarray(v))

    def extract_uv(self, storage, shape) -> Tuple[jax.Array, jax.Array]:
        return storage

    def run_steps(self, storage, shape, steps: int):
        u, v = storage
        return self._run(u, v, jnp.int32(steps))
