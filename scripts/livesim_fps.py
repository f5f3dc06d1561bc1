"""End-to-end livesim frame-rate A/B over frames-in-flight depth.

Measures the full FrameSource pipeline in-process at the reference's
default 1080x1920 domain: device frame-steps + device->host palette-index
transfer + tobytes (what the web index-stream path serves per frame,
livesim/src/frames.rs:21-175 swapchain analog). Reports fps per pipeline
depth plus the host's round-trip floor (a blocking 4-byte readback), so
a depth verdict can be read against it: K frames in flight can overlap
K device->host transfers if the runtime pipelines them.

Usage (on a GPU machine):
    python scripts/livesim_fps.py [--rows 1080] [--cols 1920]
        [--frames 60] [--depths 1,2,3,4] [--backend auto]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from grayscott_tpu.utils.cache import enable_compilation_cache

enable_compilation_cache()


def measure_depth(args, depth: int, frames: int, warm: int = 8) -> dict:
    from grayscott_tpu.cli import livesim

    ns = livesim.build_parser().parse_args([
        "-r", str(args.rows), "-c", str(args.cols),
        "--frames-in-flight", str(depth),
    ] + ([] if args.backend in (None, "auto") else
         ["--backend", args.backend]))
    src = livesim.FrameSource(ns)
    for _ in range(warm):  # warm executables + fill the pipeline
        src.next_idx()
    t0 = time.perf_counter()
    nbytes = 0
    for _ in range(frames):
        idx = src.next_idx()
        nbytes += len(np.ascontiguousarray(idx).tobytes())
    dt = time.perf_counter() - t0
    return {
        "depth": depth,
        "fps": frames / dt,
        "ms_per_frame": 1e3 * dt / frames,
        "mb_per_s": nbytes / dt / 1e6,
        "backend": src.sim.name,
    }


def rtt_probe(n: int = 10) -> float:
    """Best-of-n blocking 4-byte readback: the per-round-trip floor of
    dispatch plus device->host copy."""
    import jax.numpy as jnp

    x = jnp.float32(1.0) + jnp.float32(2.0)
    float(np.asarray(x))
    best = float("inf")
    for _ in range(n):
        t0 = time.perf_counter()
        float(np.asarray(x + jnp.float32(1.0)))
        best = min(best, time.perf_counter() - t0)
    return best


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--rows", type=int, default=1080)
    parser.add_argument("--cols", type=int, default=1920)
    parser.add_argument("--frames", type=int, default=60)
    parser.add_argument("--depths", default="1,2,3,4")
    parser.add_argument("--backend", default="auto")
    args = parser.parse_args(argv)

    rtt = rtt_probe()
    print(f"round-trip floor (4-byte blocking readback): {rtt * 1e3:.3f} ms",
          flush=True)
    frame_mb = args.rows * args.cols / 1e6
    print(f"frame payload: {frame_mb:.2f} MB (palette indices, 1 B/px)",
          flush=True)
    for d in (int(x) for x in args.depths.split(",")):
        r = measure_depth(args, d, args.frames)
        print(f"depth {r['depth']}: {r['fps']:6.2f} fps "
              f"({r['ms_per_frame']:6.1f} ms/frame, "
              f"{r['mb_per_s']:6.1f} MB/s) backend={r['backend']}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
