"""Functional core: the Gray-Scott update as pure JAX functions.

This is the JAX re-design of the reference's per-backend stencil loops
(naive: ``compute/naive/src/lib.rs:43-82``; optimized corrected-weights form:
``data/src/parameters.rs:57-63`` + ``compute/autovec/src/lib.rs:52-115``).
Instead of pointer-walking loops, the update is expressed as whole-array
shift algebra that XLA fuses into a single pass.

Key algebraic identity used by the fast paths (derivation in SURVEY.md
terms): for a symmetric stencil ``[[a,b,a],[b,c,b],[a,b,a]]`` with
``h = [x, y, x]``, ``x = sqrt(a)``, ``y = b/x``, both boundary semantics
collapse to

    full = sepconv_zeropad(X) - X * (rowsum ⊗ colsum)

where ``sepconv_zeropad`` is the separable zero-padded convolution with
``h`` along rows then columns, and ``rowsum/colsum`` are per-row/column sums
of the h taps that are in-bounds: constant ``2x + y`` for the ``zero``
(GPU-style) semantics, and ``x + y`` on edge rows/columns for the ``naive``
(clamped-window) semantics. The reference-naive top-row/left-column weight
anchoring quirk (``compute/regular/src/lib.rs:174-179``) is then restored by
recomputing those two 1-cell strips exactly (`naive_top_strip` /
`naive_left_strip`), which is cheap (O(R + C) cells).

Boundary semantics are documented in :mod:`grayscott_tpu.oracle`.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..params import Parameters, Precision

Array = jax.Array


# ---------------------------------------------------------------------------
# Exact naive semantics via gathers (the oracle-parity path)
# ---------------------------------------------------------------------------


def _index_maps_np(n: int):
    r = np.arange(n)
    start = np.maximum(r - 1, 0)
    end = np.minimum(r + 1, n - 1)
    idx, valid = [], []
    for i in range(3):
        src = start + i
        ok = src <= end
        idx.append(np.where(ok, src, 0))
        valid.append(ok)
    return idx, valid


def laplacian_naive_gather(x: Array, params: Parameters) -> Array:
    """Bit-faithful jnp transcription of the naive semantics (sequential
    row-major term accumulation, like the reference fold at
    ``compute/naive/src/lib.rs:62-70``)."""
    w = params.weights_array()
    r, c = x.shape
    ridx, rok = _index_maps_np(r)
    cidx, cok = _index_maps_np(c)
    full = jnp.zeros_like(x)
    for i in range(3):
        for j in range(3):
            if w[i, j] == 0.0:
                continue
            tap = x[jnp.asarray(ridx[i])][:, jnp.asarray(cidx[j])]
            mask = jnp.logical_and(
                jnp.asarray(rok[i])[:, None], jnp.asarray(cok[j])[None, :]
            )
            full = full + jnp.where(mask, w[i, j] * (tap - x), Precision(0.0))
    return full


# ---------------------------------------------------------------------------
# Shift-based fast paths
# ---------------------------------------------------------------------------


def _shift2d(xp: Array, i: int, j: int, r: int, c: int) -> Array:
    """Tap (i-1, j-1) of the zero-padded array ``xp`` of shape (r+2, c+2)."""
    return jax.lax.slice(xp, (i, j), (i + r, j + c))


def laplacian_zero_direct(x: Array, params: Parameters) -> Array:
    """Zero-border semantics via 9 shifted terms on a zero-padded array
    (corrected weights; GPU backend math, compute/gpu/naive/src/main.comp)."""
    wc = params.corrected_weights()
    r, c = x.shape
    xp = jnp.pad(x, 1)
    full = jnp.zeros_like(x)
    for i in range(3):
        for j in range(3):
            if wc[i, j] == 0.0:
                continue
            full = full + wc[i, j] * _shift2d(xp, i, j, r, c)
    return full


def _sepconv(x: Array, h: np.ndarray) -> Array:
    """Separable zero-padded 3x3 convolution with kernel outer(h, h)."""
    r, c = x.shape
    xp = jnp.pad(x, ((0, 0), (1, 1)))
    t = h[1] * x
    if h[0] != 0.0:
        t = t + h[0] * jax.lax.slice(xp, (0, 0), (r, c))
    if h[2] != 0.0:
        t = t + h[2] * jax.lax.slice(xp, (0, 2), (r, c + 2))
    tp = jnp.pad(t, ((1, 1), (0, 0)))
    s = h[1] * t
    if h[0] != 0.0:
        s = s + h[0] * jax.lax.slice(tp, (0, 0), (r, c))
    if h[2] != 0.0:
        s = s + h[2] * jax.lax.slice(tp, (2, 0), (r + 2, c))
    return s


def _edge_sums(n: int, h: np.ndarray) -> np.ndarray:
    """Per-index sum of in-bounds h taps: h0+h1+h2 interior, h1+h2 / h0+h1
    at the ends."""
    s = np.full((n,), h.sum(), dtype=Precision)
    s[0] = Precision(h[1] + h[2])
    s[-1] = Precision(h[0] + h[1])
    return s


def laplacian_fast(x: Array, params: Parameters, boundary: str) -> Array:
    """Fast full-array diffusion gradient for either boundary semantics.

    Uses the separable decomposition when available, falling back to the
    direct 9-term form. For ``naive`` semantics the result is exact for all
    cells except the top row and left column, which callers must patch with
    :func:`naive_top_strip` / :func:`naive_left_strip` (done by
    :func:`laplacian`).
    """
    plan = params.separable_plan()
    r, c = x.shape
    if plan[0] == "separable":
        _, h, alpha = plan
        s = _sepconv(x, h)
        if boundary == "zero":
            return s - alpha * x
        rs = _edge_sums(r, h)
        cs = _edge_sums(c, h)
        # rank-1 on-device outer product: embedding the full (R, C) product
        # as a constant made executables O(R*C) bytes (compile blowup at
        # 8192^2); the two 1-D constants are tiny and XLA fuses the product.
        b = jnp.outer(jnp.asarray(rs), jnp.asarray(cs))
        return s - x * b
    # direct path
    if boundary == "zero":
        return laplacian_zero_direct(x, params)
    # naive semantics, direct: masked 9-term form (valid except row 0 / col 0)
    w = params.weights_array()
    xp = jnp.pad(x, 1)
    full = jnp.zeros_like(x)
    _, rok = _index_maps_np(r)
    _, cok = _index_maps_np(c)
    for i in range(3):
        for j in range(3):
            if w[i, j] == 0.0:
                continue
            mask = jnp.outer(
                jnp.asarray(rok[i].astype(Precision)),
                jnp.asarray(cok[j].astype(Precision)),
            )
            full = full + w[i, j] * (
                _shift2d(xp, i, j, r, c) - x * mask
            )
    return full


# ---------------------------------------------------------------------------
# Naive-semantics edge strips
# ---------------------------------------------------------------------------


def naive_edge_strip(lane0: Array, lane1: Array, w2) -> Array:
    """Exact naive-semantics diffusion gradient for a domain-edge strip.

    ``lane0`` is the edge row (or column) itself and ``lane1`` its inward
    neighbor, both 1-D arrays of length n along the strip. ``w2`` is the
    (2, 3) weight slab: ``w[0:2, :]`` for the top row, ``w[:, 0:2].T`` for
    the left column (by symmetry of the anchoring quirk). Implements, per
    strip cell c (reference semantics, compute/naive/src/lib.rs:56-70):

        full(c) = sum_{i in 0..2, j} w2[i][j'] * (lane_i[c'] - lane0[c])

    with the along-strip index map c' = max(c-1, 0) + j, valid while
    c' <= min(c+1, n-1) and j' = j (the anchoring quirk at c == 0).
    """
    static = isinstance(w2, np.ndarray)
    n = lane0.shape[-1]
    center = lane0
    full = jnp.zeros_like(lane0)
    lanes = (lane0, lane1)
    # c >= 1 general form (c' = c-1+j, mask c+1 < n); computed everywhere,
    # then the c == 0 cell is overwritten with the quirky form.
    for i in range(2):
        xi = lanes[i]
        xpi = jnp.pad(xi, ((1, 1),))
        for j in range(3):
            wij = Precision(w2[i][j]) if static else w2[i][j]
            if static and wij == 0.0:
                continue
            tap = jax.lax.slice(xpi, (j,), (j + n,))
            if j == 2:
                valid = jnp.asarray(
                    (np.arange(n) + 1 < n).astype(Precision)
                )
                full = full + wij * (tap - center * valid)
            else:
                # j in {0, 1}: tap index max(c-1,0)+j <= c <= min(c+1, n-1),
                # always valid; the zero pad at c == 0, j == 0 is fixed below.
                full = full + wij * (tap - center)
    # c == 0: taps are lane_i[0] and lane_i[1] with weights w2[i][0], w2[i][1]
    q = jnp.zeros_like(lane0[..., :1])
    for i in range(2):
        xi = lanes[i]
        for j in range(2):
            wij = Precision(w2[i][j]) if static else w2[i][j]
            if static and wij == 0.0:
                continue
            q = q + wij * (xi[..., j : j + 1] - center[..., :1])
    full = jnp.concatenate([q, full[..., 1:]], axis=-1)
    return full


def _naive_strips(x: Array, params: Parameters) -> Tuple[Array, Array]:
    """(top-row strip, left-column strip) of the naive diffusion gradient."""
    w = params.weights_array()
    top = naive_edge_strip(x[0, :], x[1, :], w[0:2, :])
    left = naive_edge_strip(x[:, 0], x[:, 1], w[:, 0:2].T)
    return top, left


# ---------------------------------------------------------------------------
# Full step
# ---------------------------------------------------------------------------


def laplacian(x: Array, params: Parameters, boundary: str, exact: bool = False):
    """Diffusion gradient with the requested boundary semantics."""
    if boundary == "naive":
        if exact:
            return laplacian_naive_gather(x, params)
        full = laplacian_fast(x, params, "naive")
        top, left = _naive_strips(x, params)
        full = full.at[0, :].set(top)
        full = full.at[1:, 0].set(left[1:])
        return full
    if boundary == "zero":
        return laplacian_fast(x, params, "zero")
    raise ValueError(f"unknown boundary {boundary!r}")


def reaction(u: Array, v: Array, full_u: Array, full_v: Array, params: Parameters):
    """Reaction + forward-Euler update (compute/naive/src/lib.rs:71-79).

    Term order matches the reference expression trees exactly; the optimized
    ``min_feed_kill`` form (data/src/parameters.rs:67-69) is IEEE-identical
    to ``-(f + k) * v``.
    """
    du_rate = Precision(params.diffusion_rate_u)
    dv_rate = Precision(params.diffusion_rate_v)
    f = Precision(params.feed_rate)
    mfk = params.min_feed_kill()
    dt = Precision(params.time_step)
    uv_square = u * v * v
    du = du_rate * full_u - uv_square + f * (Precision(1.0) - u)
    dv = dv_rate * full_v + uv_square + mfk * v
    return u + du * dt, v + dv * dt


def step(
    u: Array,
    v: Array,
    params: Parameters,
    boundary: str = "naive",
    exact: bool = False,
) -> Tuple[Array, Array]:
    """One Gray-Scott step on full arrays. Pure; jit/scan/shard_map friendly."""
    full_u = laplacian(u, params, boundary, exact=exact)
    full_v = laplacian(v, params, boundary, exact=exact)
    return reaction(u, v, full_u, full_v, params)


# ---------------------------------------------------------------------------
# Step on a window of a larger domain (the per-shard step)
# ---------------------------------------------------------------------------


def slab_step(u: Array, v: Array, row0, col0, shape: Tuple[int, int],
              params: Parameters, boundary: str = "naive"
              ) -> Tuple[Array, Array]:
    """One step on an (a, b) window of a global (R, C) domain.

    The window carries one ring of neighbour cells around the (a-2, b-2)
    cells it updates; its element [1, 1] sits at global ``(row0, col0)``
    (traced scalars allowed, so one executable serves every shard).
    Returns the updated (a-2, b-2) interior. Boundary handling follows the
    global index of each cell, so it applies only where the window holds
    the domain's edge:

    - ``zero``: out-of-domain cells read as 0 (the caller keeps them 0);
    - ``naive``: taps outside the clamped window contribute nothing, and
      global row 0 / column 0 keep the reference's top-left weight
      anchoring (see :mod:`grayscott_tpu.oracle`), summed in the oracle's
      term order.

    Output cells outside the domain are set to 0.
    """
    rows, cols = shape
    n, m = u.shape[0] - 2, u.shape[1] - 2
    gr = row0 + jax.lax.broadcasted_iota(jnp.int32, (n, 1), 0)
    gc = col0 + jax.lax.broadcasted_iota(jnp.int32, (1, m), 1)
    w = params.weights_array()

    def tap(x, di, dj):
        return jax.lax.slice(x, (1 + di, 1 + dj), (1 + di + n, 1 + dj + m))

    def lap(x, center):
        full = jnp.zeros_like(center)
        if boundary == "zero":
            for i in range(3):
                for j in range(3):
                    if w[i, j] != 0.0:
                        full = full + w[i, j] * (tap(x, i - 1, j - 1) - center)
            return full
        # naive: tap i reads global row max(gr-1, 0) + i while that row is
        # <= min(gr+1, R-1); on row 0 that is offset i, elsewhere i - 1
        top, left = gr == 0, gc == 0
        for i in range(3):
            rok = jnp.maximum(gr - 1, 0) + i <= jnp.minimum(gr + 1, rows - 1)
            for j in range(3):
                if w[i, j] == 0.0:
                    continue
                cok = jnp.maximum(gc - 1, 0) + j <= jnp.minimum(gc + 1,
                                                                cols - 1)
                t = tap(x, i - 1, j - 1)
                if j < 2:
                    t = jnp.where(left, tap(x, i - 1, j), t)
                if i < 2:
                    t_top = tap(x, i, j - 1)
                    if j < 2:
                        t_top = jnp.where(left, tap(x, i, j), t_top)
                    t = jnp.where(top, t_top, t)
                full = full + jnp.where(rok & cok, w[i, j] * (t - center),
                                        Precision(0.0))
        return full

    cu, cv = tap(u, 0, 0), tap(v, 0, 0)
    nu, nv = reaction(cu, cv, lap(u, cu), lap(v, cv), params)
    inside = (gr >= 0) & (gr < rows) & (gc >= 0) & (gc < cols)
    zero = Precision(0.0)
    return jnp.where(inside, nu, zero), jnp.where(inside, nv, zero)


# ---------------------------------------------------------------------------
# Runtime-parameter step (the `weights-runtime` feature analog)
# ---------------------------------------------------------------------------


def step_runtime(u: Array, v: Array, weights: Array, rates: Array,
                 boundary: str = "naive") -> Tuple[Array, Array]:
    """One step with *traced* weights and rates.

    Analog of the reference's ``weights-runtime`` Cargo feature
    (data/src/parameters.rs:40-53, data/Cargo.toml:28-34), which forces a
    runtime weight lookup instead of compile-time constant folding. Here the
    motivation is practical rather than pedagogical: with ``weights`` (3, 3)
    and ``rates = [Du, Dv, f, k, dt]`` as traced operands, changing any
    parameter — including the stencil — does NOT recompile the executable.
    Used by ``FusedSimulation(runtime_weights=True)``.
    """
    r, c = u.shape
    _, rok = _index_maps_np(r)
    _, cok = _index_maps_np(c)

    def lap(x):
        xp = jnp.pad(x, 1)
        full = jnp.zeros_like(x)
        for i in range(3):
            for j in range(3):
                tap = _shift2d(xp, i, j, r, c)
                if boundary == "zero":
                    full = full + weights[i, j] * (tap - x)
                else:
                    mask = jnp.outer(
                        jnp.asarray(rok[i].astype(Precision)),
                        jnp.asarray(cok[j].astype(Precision)),
                    )
                    full = full + weights[i, j] * (tap - x * mask)
        if boundary == "naive":
            top = naive_edge_strip(x[0, :], x[1, :], weights[0:2, :])
            left = naive_edge_strip(x[:, 0], x[:, 1], weights[:, 0:2].T)
            full = full.at[0, :].set(top)
            full = full.at[1:, 0].set(left[1:])
        return full

    full_u = lap(u)
    full_v = lap(v)
    du_rate, dv_rate, f, k, dt = (rates[i] for i in range(5))
    uv_square = u * v * v
    du = du_rate * full_u - uv_square + f * (Precision(1.0) - u)
    dv = dv_rate * full_v + uv_square - (f + k) * v
    return u + du * dt, v + dv * dt


def rates_array(params: Parameters) -> Array:
    """Pack the scalar parameters for :func:`step_runtime`."""
    return jnp.asarray(
        [params.diffusion_rate_u, params.diffusion_rate_v,
         params.feed_rate, params.kill_rate, params.time_step],
        dtype=Precision,
    )
