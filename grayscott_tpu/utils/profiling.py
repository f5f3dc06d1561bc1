"""Profiling support.

The reference's profiling story is criterion microbenchmarks plus
`gpu-debug-utils` object naming for GPU profilers (SURVEY.md section 5;
data/Cargo.toml:14-16). The equivalents here:

- :func:`trace` — context manager around ``jax.profiler.trace`` writing an
  xprof/TensorBoard trace (set ``GRAYSCOTT_TRACE_DIR`` or pass a path);
- :func:`annotate` — named ``TraceAnnotation`` scopes, the analog of the
  reference's named Vulkan objects: they label host-side phases in the
  trace timeline (XLA's kernels already appear under their own names);
- the benchmark harness (grayscott_tpu/bench) for throughput numbers.

``scripts/profile_trace.py`` reduces a trace of the ``fused`` step to
per-step kernels, busy time and idle share (utils/xplane.py), and
``scripts/trace_ops.py`` prints per-line device time of any capture.
Start a trace after a warm-up step, so that compilation stays out of the
traced window.
"""

from __future__ import annotations

import contextlib
import os
import tempfile


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Capture a device + host profile for the enclosed block."""
    import jax

    log_dir = log_dir or os.environ.get(
        "GRAYSCOTT_TRACE_DIR",
        os.path.join(tempfile.gettempdir(), "grayscott_trace"),
    )
    with jax.profiler.trace(log_dir):
        yield log_dir


def annotate(name: str):
    """Named scope that shows up on the profiler timeline."""
    import jax

    return jax.profiler.TraceAnnotation(name)
