"""Long-run numerical parity report (BASELINE config 1).

Runs the 256x384 / f=0.014 / k=0.054 / 1000-step simulation with every
backend and reports drift against the NumPy oracle (the bit-faithful
transcription of the reference naive backend, grayscott_tpu/oracle.py) at
snapshot intervals — the float32 error-growth budget analysis called for in
SURVEY.md section 7 "hard parts".

Usage: python scripts/parity_check.py [--steps 1000] [--backends a,b,c]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=1000)
    parser.add_argument("--snapshot-every", type=int, default=100)
    parser.add_argument("--backends", default="naive,regular,fused,conv")
    parser.add_argument("--boundary", default="naive")
    parser.add_argument("--shape", default="256x384")
    parser.add_argument("--stencil", default="oono-puri",
                        help="Laplacian stencil; '5points' exercises the "
                        "DIRECT (non-separable) path")
    parser.add_argument("-o", "--output", default=None)
    args = parser.parse_args(argv)

    from grayscott_tpu import oracle
    from grayscott_tpu.backends import get_backend
    from grayscott_tpu.params import Parameters
    from grayscott_tpu.species import initial_uv

    shape = tuple(int(x) for x in args.shape.split("x"))
    # f=0.014 k=0.054 are the defaults
    params = Parameters.with_stencil(args.stencil)
    u_ref, v_ref = initial_uv(shape)

    sims = {}
    for name in args.backends.split(","):
        sim = get_backend(name)(params, boundary=args.boundary)
        species = sim.make_species(shape)
        sims[name] = (sim, species)

    report = {"shape": shape, "boundary": args.boundary,
              "stencil": args.stencil, "rows": []}
    t0 = time.time()
    done = 0
    while done < args.steps:
        n = min(args.snapshot_every, args.steps - done)
        u_ref, v_ref = oracle.run(u_ref, v_ref, params, n, args.boundary)
        done += n
        row = {"step": done}
        for name, (sim, species) in sims.items():
            sim.perform_steps(species, n)
            gu, gv = species.uv_host()
            row[name] = {
                "max_abs_u": float(np.abs(gu - u_ref).max()),
                "max_abs_v": float(np.abs(gv - v_ref).max()),
                "rms_v": float(np.sqrt(np.mean((gv - v_ref) ** 2))),
            }
        report["rows"].append(row)
        print(
            f"step {done:5d}: "
            + "  ".join(
                f"{n}: max|dV|={row[n]['max_abs_v']:.3e}" for n in sims
            ),
            flush=True,
        )
    report["seconds"] = time.time() - t0
    print(f"oracle V checksum after {done} steps: {float(v_ref.sum()):.6f}")
    if args.output:
        with open(args.output, "w") as f:
            json.dump(report, f, indent=1)
    # acceptance: float32 tolerance after 1000s of steps (BASELINE.md)
    worst = max(row[n]["max_abs_v"] for row in report["rows"] for n in sims)
    print(f"worst max|dV| over run: {worst:.3e}")
    return 0 if worst < 1e-3 else 1


if __name__ == "__main__":
    sys.exit(main())
