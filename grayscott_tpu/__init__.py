"""A Gray-Scott reaction-diffusion framework in JAX, run on NVIDIA GPUs.

Built from scratch in JAX/XLA with the capabilities of the Rust
reference ``HadrienG2/grayscott`` (see SURVEY.md for the full structural
analysis and the design mapping).
"""

from .params import Parameters, Precision, STENCILS, DEFAULT_STENCIL
from .species import Species, initial_uv

__version__ = "0.1.0"

__all__ = [
    "Parameters",
    "Precision",
    "STENCILS",
    "DEFAULT_STENCIL",
    "Species",
    "initial_uv",
]
