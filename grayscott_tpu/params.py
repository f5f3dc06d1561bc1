"""Simulation parameters and stencil weights.

JAX re-design of the reference's ``data`` crate parameter model
(reference: ``data/src/parameters.rs:15-33`` for the parameter set,
``:90-123`` for the four selectable stencils, ``:57-63`` for corrected
weights, ``:67-69`` for the ``-(f+k)`` prefactor).

Differences from the reference, by design:

- Stencil selection is a *runtime* choice (``Parameters.with_stencil``)
  rather than a Cargo compile-time feature. Because backends close over a
  frozen, hashable ``Parameters`` when they build their jitted step
  functions, XLA still constant-folds the weights exactly like the
  reference's compile-time default (the ``weights-runtime`` feature analog
  is ``runtime_weights=True`` on backends that support it, which passes the
  weights as a traced operand instead).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

#: Floating-point precision used for simulation (reference: data/src/lib.rs:11)
Precision = np.float32

#: Stencil shape (reference: data/src/parameters.rs:166)
STENCIL_SHAPE = (3, 3)

#: Offset from the stencil's top-left corner to its center
#: (reference: data/src/parameters.rs:169-175)
STENCIL_OFFSET = (1, 1)

WeightsT = Tuple[Tuple[float, float, float], ...]

#: The four selectable stencils (reference: data/src/parameters.rs:90-123).
#: Keys mirror the reference's Cargo feature names.
STENCILS: dict[str, WeightsT] = {
    # Optimally isotropic discretization of the Laplacian; the default
    # (reference: data/src/parameters.rs:115-122).
    "oono-puri": (
        (0.25, 0.5, 0.25),
        (0.5, 0.0, 0.5),
        (0.25, 0.5, 0.25),
    ),
    # All-ones stencil used by the C++ version of the course
    # (reference: data/src/parameters.rs:92-97, feature `weights-pretty`).
    "pretty": (
        (1.0, 1.0, 1.0),
        (1.0, 1.0, 1.0),
        (1.0, 1.0, 1.0),
    ),
    # Rotationally invariant stencil, smallest error around the origin
    # (reference: data/src/parameters.rs:98-105).
    "patra-karttunen": (
        (1.0 / 6.0, 4.0 / 6.0, 1.0 / 6.0),
        (4.0 / 6.0, 0.0, 4.0 / 6.0),
        (1.0 / 6.0, 4.0 / 6.0, 1.0 / 6.0),
    ),
    # Computationally simpler but anisotropic 5-point stencil
    # (reference: data/src/parameters.rs:106-114).
    "5points": (
        (0.0, 1.0, 0.0),
        (1.0, 0.0, 1.0),
        (0.0, 1.0, 0.0),
    ),
}

DEFAULT_STENCIL = "oono-puri"

#: Named (feed_rate, kill_rate) presets for the classic Gray-Scott
#: pattern classes — the widely-used coordinates from Pearson's regime
#: map (Pearson, "Complex Patterns in a Simple System", Science 1993).
#: Every entry is validated to produce a live, spatially-structured V
#: field after 4000 steps in THIS discretization (Du=0.1, Dv=0.05,
#: dt=1, Oono-Puri stencil) — see tests/test_params.py. A
#: beyond-reference convenience: the reference exposes only -f/-k
#: (ui/src/lib.rs:18-46); "reference" is its shipped default pair.
PRESETS: dict[str, Tuple[float, float]] = {
    "reference": (0.014, 0.054),  # the reference's default: growing spots
    "solitons": (0.030, 0.062),  # self-replicating spots
    "mitosis": (0.0367, 0.0649),  # dividing cells
    "coral": (0.0545, 0.062),  # coral-like branching growth
    "maze": (0.029, 0.057),  # labyrinthine stripes
    "worms": (0.058, 0.065),  # crawling worm segments
    "waves": (0.014, 0.045),  # unstable travelling waves
    "u-skate": (0.062, 0.061),  # U-skate world (glider-bearing)
    "chaos": (0.026, 0.051),  # spatiotemporal chaos, domain-filling
}


@dataclasses.dataclass(frozen=True)
class Parameters:
    """Gray-Scott simulation parameters.

    Defaults mirror the reference (``data/src/parameters.rs:72-83``).
    The dataclass is frozen and hashable so that backends can treat it as a
    static (compile-time) value, letting XLA fold the weights into the
    kernel exactly like the reference's default compile-time stencil.
    """

    weights: WeightsT = STENCILS[DEFAULT_STENCIL]
    diffusion_rate_u: float = 0.1
    diffusion_rate_v: float = 0.05
    feed_rate: float = 0.014
    kill_rate: float = 0.054
    time_step: float = 1.0

    # -- constructors -------------------------------------------------------

    @classmethod
    def with_stencil(cls, name: str = DEFAULT_STENCIL, **kwargs) -> "Parameters":
        if name not in STENCILS:
            raise ValueError(
                f"unknown stencil {name!r}; available: {sorted(STENCILS)}"
            )
        return cls(weights=STENCILS[name], **kwargs)

    @classmethod
    def with_preset(cls, name: str, stencil: str = DEFAULT_STENCIL,
                    **kwargs) -> "Parameters":
        """Parameters for a named pattern preset (:data:`PRESETS`).
        Explicit ``feed_rate``/``kill_rate`` kwargs override the preset's
        pair, mirroring the CLI contract (-f/-k beat --preset)."""
        if name not in PRESETS:
            raise ValueError(
                f"unknown preset {name!r}; available: {sorted(PRESETS)}"
            )
        f, k = PRESETS[name]
        kwargs.setdefault("feed_rate", f)
        kwargs.setdefault("kill_rate", k)
        return cls.with_stencil(stencil, **kwargs)

    # -- derived quantities --------------------------------------------------

    def weights_array(self) -> np.ndarray:
        """Stencil weights as a float32 (3, 3) array."""
        return np.asarray(self.weights, dtype=Precision)

    def corrected_weights(self) -> np.ndarray:
        """Weights folding the ``-center`` term of the naive formulation into
        a corrected center weight (reference: data/src/parameters.rs:57-63).

        The subtraction uses a sequential float32 sum over the row-major
        flattened weights, matching the reference's fold order bit-for-bit.
        """
        w = self.weights_array().copy()
        total = Precision(0.0)
        for x in w.reshape(-1):
            total = Precision(total + x)
        w[STENCIL_OFFSET] = Precision(w[STENCIL_OFFSET] - total)
        return w

    def min_feed_kill(self) -> Precision:
        """``-(feed_rate + kill_rate)`` prefactor for the dv computation
        (reference: data/src/parameters.rs:67-69)."""
        return Precision(-(Precision(self.feed_rate) + Precision(self.kill_rate)))

    def structure_only(self) -> "Parameters":
        """A copy with all reaction/integration fields at their defaults,
        keeping only the weights. Backends in runtime-parameter mode use
        this as the static (executable-keying) value so that feed/kill/dt
        changes hit the same compiled kernel — the whole point of passing
        the reaction scalars as a traced operand."""
        return Parameters(weights=self.weights)

    def stencil_name(self) -> str:
        for name, w in STENCILS.items():
            if w == self.weights:
                return name
        return "custom"

    # -- separable decomposition (fast path) ----------------------------------

    def separable_plan(self):
        """Decompose the corrected stencil for the separable fast path.

        For symmetric stencils of the form ``[[a,b,a],[b,c,b],[a,b,a]]`` with
        ``a > 0``, the corrected-weight convolution can be written as a
        separable pass ``conv_h(rows) . conv_h(cols) - alpha * center`` with
        ``h = [x, y, x]``, ``x = sqrt(a)``, ``y = b / x`` and
        ``alpha = y*y - c + sum(w)``. This cuts the per-cell shift count
        roughly in half versus a direct 9-point sum (the analog of the
        reference's unrolled mul_add ladder, compute/autovec/src/lib.rs:87-106).

        Returns ``("separable", h, alpha)`` or ``("direct", corrected)``.
        All math in float64 here; values are cast to f32 at use sites. Note
        the separable path reassociates the f32 sum, so results differ from
        the naive path at the last-ulp level (same caveat as the reference's
        autovec backend, see SURVEY.md section 7 "hard parts").
        """
        w = np.asarray(self.weights, dtype=np.float64)
        a, b = w[0, 0], w[0, 1]
        symmetric = (
            np.allclose(w, w.T)
            and w[0, 0] == w[0, 2] == w[2, 0] == w[2, 2]
            and w[0, 1] == w[1, 0] == w[1, 2] == w[2, 1]
        )
        if symmetric and a > 0:
            x = np.sqrt(a)
            y = b / x
            alpha = y * y - w[1, 1] + w.sum()
            h = np.asarray([x, y, x], dtype=Precision)
            return ("separable", h, Precision(alpha))
        return ("direct", self.corrected_weights())


def default_parameters() -> Parameters:
    return Parameters()
