"""Weak-scaling benchmark over a device mesh.

Fixes the per-device domain and grows the global domain with the mesh:
for D devices on a 1-D row mesh the global grid is (D * rows_per_dev,
cols). Linear weak scaling means constant time per step as D grows, i.e.
aggregate Gcell/s proportional to D.

On a machine without several GPUs this runs on the virtual CPU mesh for
pipeline validation (tiny shapes; timing meaningless, scaling
shape-only):

    python scripts/bench_scaling.py --platform cpu --virtual-devices 8 \
        --rows-per-dev 64 --cols 256 --steps 32

On a multi-GPU machine, run as-is (defaults give 4096^2 per device).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--rows-per-dev", type=int, default=4096)
    parser.add_argument("--cols", type=int, default=4096)
    parser.add_argument("--steps", type=int, default=512)
    parser.add_argument("--mesh-cols", type=int, default=1)
    parser.add_argument("--boundary", default="zero")
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--platform", default=None,
                        help="force a JAX platform (e.g. cpu)")
    parser.add_argument("--virtual-devices", type=int, default=None,
                        help="with --platform cpu: number of virtual devices")
    args = parser.parse_args()

    if args.virtual_devices:
        from grayscott_tpu.utils.runtime import force_virtual_devices

        force_virtual_devices(args.virtual_devices, platform=None)
    if args.platform:
        import jax

        jax.config.update("jax_platforms", args.platform)

    from grayscott_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    import jax

    from grayscott_tpu.backends.sharded import ShardedSimulation
    from grayscott_tpu.params import Parameters

    n_all = len(jax.devices())
    print(f"devices: {n_all} x {jax.devices()[0].platform}", flush=True)
    results = []
    d = 1
    while d <= n_all:
        if d % args.mesh_cols == 0 or d == 1:
            mesh_cols = args.mesh_cols if d % args.mesh_cols == 0 else 1
            rows = args.rows_per_dev * (d // mesh_cols)
            cols = args.cols * mesh_cols
            sim = ShardedSimulation(
                Parameters(), boundary=args.boundary, n_devices=d,
                mesh_cols=mesh_cols,
            )
            species = sim.make_species((rows, cols))
            # warm BOTH executables the timed loop will use: the K-step
            # block loop and (when steps % K != 0) the remainder block
            k = sim.steps_per_exchange
            sim.perform_steps(species, k + args.steps % k)
            best = float("inf")
            for _ in range(args.reps):
                t0 = time.perf_counter()
                sim.perform_steps(species, args.steps)
                best = min(best, time.perf_counter() - t0)
            rate = rows * cols * args.steps / best / 1e9
            entry = {
                "devices": d, "mesh": f"{d // mesh_cols}x{mesh_cols}",
                "domain": [rows, cols], "steps": args.steps,
                "seconds": best, "gcells_per_sec": rate,
                "per_device": rate / d,
                "_rate": rate,
            }
            results.append(entry)
            print(json.dumps({k: v for k, v in entry.items()
                              if not k.startswith("_")}), flush=True)
        d *= 2
    if len(results) >= 2:
        eff = (results[-1]["_rate"] / results[-1]["devices"]) / (
            results[0]["_rate"] / results[0]["devices"]
        )
        print(f"weak-scaling efficiency at {results[-1]['devices']} devices: "
              f"{eff:.2%}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
