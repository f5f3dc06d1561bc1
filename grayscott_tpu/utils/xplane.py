"""Reductions of a ``jax.profiler`` trace (xplane.pb) to device metrics.

``jax.profiler`` writes XSpace protos; ``jax.profiler.ProfileData`` reads
them with nothing but JAX. This module turns one capture into the numbers
the benchmark and ``scripts/profile_trace.py`` report:

- :func:`kernel_summary` — per-kernel device time and launch count, and
  the device's busy time (union of kernel intervals) over the window;
  the bench harness's ``device`` workload reads its busy time;
- :func:`parse_xspace` — every plane and line, for ``scripts/trace_ops.py``.

Device planes are the ``/device:GPU:N`` planes. On them, kernels and
copies appear on the per-stream lines (``Stream #13(MemcpyD2H,MemcpyD2D,
Compute)`` in an H100 trace); other lines, where present, group the
same intervals by XLA module or op.
"""

from __future__ import annotations

import glob
import os
from collections import defaultdict


def find_xplane(arg: str) -> str:
    """An xplane.pb path from either a direct path or a trace dir (the
    newest ``plugins/profile/<run>/`` capture wins)."""
    if os.path.isfile(arg):
        return arg
    hits = sorted(glob.glob(os.path.join(arg, "plugins/profile/*/*.xplane.pb")))
    if not hits:
        raise FileNotFoundError(f"no xplane.pb under {arg}")
    return hits[-1]


def parse_xspace(path: str) -> list[dict]:
    """Every plane as ``{"name", "lines": [(line name, [(event name,
    start_ns, duration_ns), ...]), ...]}``."""
    from jax.profiler import ProfileData

    with open(path, "rb") as f:
        data = ProfileData.from_serialized_xspace(f.read())
    return [
        {"name": plane.name,
         "lines": [(line.name, [(e.name, e.start_ns, e.duration_ns)
                                for e in line.events])
                   for line in plane.lines]}
        for plane in data.planes
    ]


def device_planes(path: str) -> list[dict]:
    return [p for p in parse_xspace(path) if "GPU" in p["name"]]


def kernel_summary(trace_dir: str) -> dict:
    """Kernel-level reduction of one capture.

    Returns ``{"kernels": {name: {"ms", "count"}}, "busy_ms",
    "window_ms", "idle_share"}`` over the stream lines of every device
    plane. ``busy_ms`` is the union of kernel intervals; the window runs
    from the first kernel's start to the last one's end. A trace of one
    device is what this measures: the union merges several devices'
    intervals into one."""
    per: dict[str, list] = defaultdict(lambda: [0.0, 0])
    spans = []
    for plane in device_planes(find_xplane(trace_dir)):
        for lname, events in plane["lines"]:
            if not lname.startswith("Stream"):
                continue
            for name, start, dur in events:
                per[name][0] += dur
                per[name][1] += 1
                spans.append((start, start + dur))
    if not spans:
        raise RuntimeError(
            "trace holds no kernel on a GPU stream line: it needs a run "
            "on the GPU"
        )
    spans.sort()
    busy, (cur_lo, cur_hi) = 0.0, spans[0]
    for lo, hi in spans[1:]:
        if lo > cur_hi:
            busy += cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    busy += cur_hi - cur_lo
    window = max(hi for _, hi in spans) - spans[0][0]
    return {
        "kernels": {k: {"ms": d / 1e6, "count": n}
                    for k, (d, n) in sorted(per.items(),
                                            key=lambda kv: -kv[1][0])},
        "busy_ms": busy / 1e6,
        "window_ms": window / 1e6,
        "idle_share": 1.0 - busy / window if window > 0 else 0.0,
    }
