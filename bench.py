"""Headline benchmark: Gray-Scott throughput at 4096^2, 1000 steps, one GPU.

Prints the device (platform, ``device_kind``, device count) and the card's
name and power limit on stderr, then ONE JSON line on stdout:

    {"metric": ..., "value": N, "unit": "Gcell/s", "vs_baseline": N, ...}

``value`` is cell-updates per second (the reference's criterion throughput
unit, compute/shared/src/benchmark.rs:59) on the selected backend under
the zero boundary. ``vs_baseline`` is its share of the card's single-step
memory roofline (published bandwidth / 16 B per cell-step,
grayscott_tpu/bench/roofline.py); a device kind missing from that table
is an error. ``naive_*`` keys carry the same for the naive boundary, the
CLI default.

Timing: after a warm-up run, five 1000-step runs are timed one by one,
each closed with ``block_until_ready`` (``value_single_run`` = the best),
then three samples of five back-to-back runs closed by one
``block_until_ready`` (``value_steady_state`` = the best, the criterion
sample model of total time over iterations). Everything runs in this one
process, which holds the card alone.
"""

from __future__ import annotations

import json
import sys
import time


def measure(r=4096, c=4096, steps=1000, boundary="zero"):
    """(backend name, steady-state Gcell/s, single-run Gcell/s, batch)."""
    from grayscott_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    from grayscott_tpu.backends import best_backend_name, get_backend
    from grayscott_tpu.params import Parameters

    name = best_backend_name(shape=(r, c))
    sim = get_backend(name)(Parameters(), boundary=boundary)
    species = sim.make_species((r, c))
    sim.perform_steps(species, steps)  # compile + warm up
    single = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        sim.perform_steps(species, steps)
        single = min(single, time.perf_counter() - t0)
    batch = 5
    steady = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(batch):
            sim.prepare_steps(species, steps)
        sim.block_until_ready(species)
        steady = min(steady, time.perf_counter() - t0)
    cells = r * c * steps
    return name, cells * batch / steady / 1e9, cells / single / 1e9, batch


def main() -> int:
    import jax

    from grayscott_tpu.bench import roofline

    dev = jax.devices()[0]
    roof = roofline.roofline_gcells(dev.device_kind)
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    card = roofline.card_line()
    print(f"bench.py: device {device}; card: {card}", file=sys.stderr)
    name, gcells, single, batch = measure(boundary="zero")
    print(f"bench.py: zero boundary: single run {single} Gcell/s; "
          f"steady-state ({batch} runs, 1 sync) {gcells}", file=sys.stderr)
    nname, ngcells, nsingle, _ = measure(boundary="naive")
    print(f"bench.py: naive boundary: single run {nsingle} Gcell/s; "
          f"steady-state {ngcells}", file=sys.stderr)
    print(
        json.dumps(
            {
                "metric": (
                    f"Gcell-updates/s steady-state, 4096^2 x 1000 steps "
                    f"x{batch} back-to-back runs with one sync, "
                    f"backend={name}, zero-border semantics; "
                    "naive_* = the CLI-default boundary"
                ),
                "value": gcells,
                "unit": "Gcell/s",
                "vs_baseline": gcells / roof,
                "value_steady_state": gcells,
                "value_single_run": single,
                "naive_steady_state": ngcells,
                "naive_single_run": nsingle,
                "naive_vs_baseline": ngcells / roof,
                "naive_backend": nname,
                "roofline_gcells": roof,
                "device": device,
                "card": card,
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
