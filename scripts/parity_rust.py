"""Golden-parity diff against the ACTUAL Rust reference binary.

Toolchain-gated automation of the SURVEY.md section-4 golden-file ask.
When a Rust toolchain is available this script:

1. builds the reference's ``simulate`` binary from source with the
   ``compute_naive`` CPU feature set (``simulate/src/main.rs:46-127``,
   backend priority chain ``compute/selector/src/lib.rs:4-59``) — the
   backend whose update rule our oracle transcribes bit-faithfully;
2. runs BASELINE.json config 0: 256x384 grid, f=0.014, k=0.054, 1000
   steps, written as 10 HDF5 snapshots of 100 steps each
   (``data/src/hdf5.rs:36-54`` layout: one f32 "matrix" dataset of
   shape [n, rows, cols]);
3. runs this package's ``naive`` backend through the same CLI surface
   (``grayscott_tpu.cli.simulate``) with identical arguments; and
4. diffs the two HDF5 files snapshot by snapshot against the PARITY.md
   float32 error-growth bound (worst measured transcription-vs-backend
   drift is 6.1e-06 at step 1000; default tolerance 1e-5 leaves margin
   for rustc-vs-XLA rounding differences while still failing loudly on
   any semantic divergence).

Without a toolchain (this image: rounds 1-5) it SKIPS cleanly with exit
code 0, so the same invocation is safe in CI today and fires the real
diff automatically the day cargo appears. Until then, PARITY.md's
triple-transcription defense (oracle.py / tests/test_transcription.py /
native/refstep.cpp) carries the bounded residual risk.

Exit codes: 0 = parity verified OR cleanly skipped; 1 = toolchain
present but build, run, or diff failed.

Usage:
    python scripts/parity_rust.py [--reference /root/reference]
        [--tol 1e-5] [--images 10] [--steps-per-image 100]
        [--shape 256x384] [--keep DIR]
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def find_cargo() -> str | None:
    """Locate a cargo binary (PATH, then the rustup default install)."""
    cargo = shutil.which("cargo")
    if cargo:
        return cargo
    home = os.path.expanduser("~/.cargo/bin/cargo")
    if os.access(home, os.X_OK):
        return home
    return None


def build_reference(cargo: str, reference: str, target_dir: str) -> str:
    """Build the reference ``simulate`` binary (CPU naive feature set).

    The reference tree may be read-only (it is in this image), so all
    build artifacts go to ``target_dir`` via CARGO_TARGET_DIR and the
    committed Cargo.lock is used as-is (--locked)."""
    env = dict(os.environ, CARGO_TARGET_DIR=target_dir)
    subprocess.run(
        [cargo, "build", "--locked", "--release", "-p", "simulate",
         "--features", "compute_naive"],
        cwd=reference, env=env, check=True,
    )
    binary = os.path.join(target_dir, "release", "simulate")
    if not os.access(binary, os.X_OK):
        raise FileNotFoundError(f"built binary not found at {binary}")
    return binary


def run_reference(binary: str, out: str, shape, images: int,
                  steps: int) -> None:
    """Run the reference binary on BASELINE config 0 arguments
    (simulate/src/main.rs:24-44 + ui/src/lib.rs:18-46 CLI surface)."""
    subprocess.run(
        [binary, "-n", str(images), "-e", str(steps),
         "-r", str(shape[0]), "-c", str(shape[1]),
         "-f", "0.014", "-k", "0.054", "-o", out],
        check=True,
    )


def run_ours(out: str, shape, images: int, steps: int) -> None:
    """Run our arg-parity simulate CLI with the naive backend in-process
    (forced to CPU, so that no GPU is required)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from grayscott_tpu.cli import simulate

    rc = simulate.main([
        "-n", str(images), "-e", str(steps),
        "-r", str(shape[0]), "-c", str(shape[1]),
        "-f", "0.014", "-k", "0.054", "-o", out,
        "--backend", "naive", "--boundary", "naive",
    ])
    if rc != 0:
        raise RuntimeError(f"grayscott simulate exited with {rc}")


def compare(ref_h5: str, ours_h5: str, tol: float) -> dict:
    """Snapshot-by-snapshot diff of two reference-layout HDF5 files.

    Returns {"rows": [{"image", "steps", "max_abs"}...], "worst": float,
    "tol": tol, "ok": bool}; raises ValueError on any layout mismatch
    (shape or image count), which is a parity failure in itself."""
    import h5py
    import numpy as np

    with h5py.File(ref_h5, "r") as fr, h5py.File(ours_h5, "r") as fo:
        dr, do = fr["matrix"], fo["matrix"]
        if dr.shape != do.shape:
            raise ValueError(
                f"HDF5 layout mismatch: reference {dr.shape} vs ours "
                f"{do.shape}")
        rows = []
        for i in range(dr.shape[0]):
            a = np.asarray(dr[i], dtype=np.float32)
            b = np.asarray(do[i], dtype=np.float32)
            rows.append({"image": i,
                         "max_abs": float(np.abs(a - b).max())})
    worst = max((r["max_abs"] for r in rows), default=0.0)
    return {"rows": rows, "worst": worst, "tol": tol, "ok": worst <= tol}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Golden HDF5 diff vs the built Rust reference")
    parser.add_argument("--reference", default="/root/reference",
                        help="Path to the reference source tree")
    parser.add_argument("--tol", type=float, default=1e-5,
                        help="max|dV| acceptance bound (PARITY.md)")
    parser.add_argument("--images", type=int, default=10)
    parser.add_argument("--steps-per-image", type=int, default=100)
    parser.add_argument("--shape", default="256x384")
    parser.add_argument("--keep", default=None, metavar="DIR",
                        help="Keep build + HDF5 artifacts here")
    args = parser.parse_args(argv)
    shape = tuple(int(x) for x in args.shape.split("x"))

    cargo = find_cargo()
    if cargo is None:
        print("parity_rust: SKIP — no Rust toolchain (cargo) on this "
              "machine; reference goldens remain covered by the "
              "triple-transcription defense (PARITY.md)")
        return 0
    if not os.path.isfile(os.path.join(args.reference, "Cargo.toml")):
        print(f"parity_rust: SKIP — no reference checkout at "
              f"{args.reference} (pass --reference)")
        return 0

    work = args.keep or tempfile.mkdtemp(prefix="grayscott_parity_rust_")
    os.makedirs(work, exist_ok=True)
    print(f"parity_rust: cargo={cargo} workdir={work}")
    binary = build_reference(cargo, args.reference,
                             os.path.join(work, "target"))
    ref_h5 = os.path.join(work, "reference.h5")
    ours_h5 = os.path.join(work, "ours.h5")
    run_reference(binary, ref_h5, shape, args.images, args.steps_per_image)
    run_ours(ours_h5, shape, args.images, args.steps_per_image)
    report = compare(ref_h5, ours_h5, args.tol)
    for row in report["rows"]:
        print(f"  image {row['image']:3d} "
              f"(step {(row['image'] + 1) * args.steps_per_image:5d}): "
              f"max|dV| = {row['max_abs']:.3e}")
    print(f"parity_rust: worst max|dV| = {report['worst']:.3e} "
          f"(bound {args.tol:.1e}) -> "
          f"{'OK' if report['ok'] else 'FAIL'}")
    if not args.keep:
        shutil.rmtree(work, ignore_errors=True)
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
