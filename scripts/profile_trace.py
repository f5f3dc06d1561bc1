"""Trace the `fused` step on the GPU and reduce each trace to per-step
device metrics.

For every (shape, boundary): compile and warm up, time ``--steps`` steps
to ``block_until_ready`` with the profiler off, then trace the same
number of steps and reduce the capture (grayscott_tpu/utils/xplane.py):

- kernels per step and each kernel's device time;
- device busy time per step and the idle share of the traced window;
- bytes per step (16 B per cell-step, the least a step can move) and the
  bandwidth that implies, against the card's published peak;
- Gcell/s from the wall clock and from device busy time, against the
  single-step roofline (grayscott_tpu/bench/roofline.py).

Usage::

    python scripts/profile_trace.py [--out DIR] [--steps 200]
        [--shapes 1080x1920,4096x4096] [--boundaries naive,zero]

Writes DIR/summary.json plus one trace directory per configuration, and
prints one JSON line per configuration. Needs a GPU whose device kind
is in the peak table.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def profile(shape, boundary: str, steps: int, out: str, roof: float,
            peak_bytes: float) -> dict:
    import jax

    from grayscott_tpu.backends import get_backend
    from grayscott_tpu.bench import roofline
    from grayscott_tpu.params import Parameters
    from grayscott_tpu.utils import xplane

    sim = get_backend("fused")(Parameters(), boundary=boundary)
    species = sim.make_species(shape)
    sim.perform_steps(species, steps)  # compile + warm up
    wall = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        sim.perform_steps(species, steps)
        wall = min(wall, time.perf_counter() - t0)
    tdir = os.path.join(out, f"{shape[0]}x{shape[1]}_{boundary}")
    jax.profiler.start_trace(tdir)
    try:
        sim.perform_steps(species, steps)
    finally:
        jax.profiler.stop_trace()
    # every line of every plane (event count, total ms), written before
    # the reduction so that a trace it cannot read can still be examined
    lines = {}
    for plane in xplane.parse_xspace(xplane.find_xplane(tdir)):
        for lname, events in plane["lines"]:
            lines[f"{plane['name']} | {lname}"] = [
                len(events), sum(d for _, _, d in events) / 1e6]
    with open(os.path.join(tdir, "lines.json"), "w") as f:
        json.dump(lines, f, indent=1)
    ks = xplane.kernel_summary(tdir)
    cells = shape[0] * shape[1]
    busy_s = ks["busy_ms"] * 1e-3 / steps
    bytes_step = roofline.BYTES_PER_CELL_STEP * cells
    return {
        "shape": list(shape), "boundary": boundary, "steps": steps,
        "wall_gcells": cells * steps / wall / 1e9,
        "wall_us_per_step": wall / steps * 1e6,
        "device_gcells": cells / busy_s / 1e9,
        "device_us_per_step": busy_s * 1e6,
        "roofline_gcells": roof,
        "wall_roofline_share": cells * steps / wall / 1e9 / roof,
        "device_roofline_share": cells / busy_s / 1e9 / roof,
        "bytes_per_step": bytes_step,
        "device_bandwidth": bytes_step / busy_s,
        "bandwidth_share": bytes_step / busy_s / peak_bytes,
        "kernels_per_step": sum(k["count"] for k in ks["kernels"].values())
        / steps,
        "idle_share": ks["idle_share"],
        "kernels": {name: {"us_per_step": k["ms"] * 1e3 / steps,
                           "per_step": k["count"] / steps}
                    for name, k in ks["kernels"].items()},
        "lines": lines,
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default="chiprun_out/trace")
    parser.add_argument("--steps", type=int, default=200)
    parser.add_argument("--shapes", default="1080x1920,4096x4096")
    parser.add_argument("--boundaries", default="naive,zero")
    args = parser.parse_args(argv)

    from grayscott_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    import jax

    from grayscott_tpu.bench import roofline

    kind = jax.devices()[0].device_kind
    roof = roofline.roofline_gcells(kind)
    card = roofline.card_line()
    print(f"device {kind}; card: {card}", flush=True)
    rows = []
    for shape_s in args.shapes.split(","):
        shape = tuple(int(x) for x in shape_s.split("x"))
        for boundary in args.boundaries.split(","):
            row = profile(shape, boundary, args.steps, args.out, roof,
                          roofline.hbm_peak(kind))
            rows.append(row)
            print(json.dumps({k: v for k, v in row.items()
                              if k != "lines"}), flush=True)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump({"device_kind": kind, "card": card, "rows": rows}, f,
                  indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
