"""Smoke test of the simulator on NVIDIA GPUs, through the user entry points.

Run from the root of a checkout, on a machine whose JAX sees a GPU:

    python chip_smoke.py                # one card
    python chip_smoke.py --four-cards   # the sharded path on four cards

One card, in order (any failure stops the run with a non-zero exit):

1. device — the platform must be ``gpu``; prints ``device_kind`` and the
   card's name and power limit (``nvidia-smi``);
2. selector — ``best_backend_name((1080, 1920))`` must be ``fused``;
3. parity — ``naive``, ``regular``, ``fused`` (static and runtime
   weights) and ``conv`` at 1080x1920 from the standard init, both
   boundaries, against ``oracle.run`` on the host after 256 steps;
4. pipeline — the ``simulate`` CLI's default arguments plus ``-n 8``
   through its own snapshot pipeline (``run_pipeline``) into an
   in-memory sink; the last image must match the oracle;
5. throughput — ``fused`` at 1080x1920 and 4096^2, 1000 steps, both
   boundaries, timed to ``block_until_ready``.

``--four-cards`` runs only the sharded path: 8192^2 on 4x1 and 2x2 meshes
under both boundaries against ``fused`` on one of the same cards after
256 steps, and 1024^2 on four cards against the oracle.

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``;
it is printed only when every phase passed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

#: max |error| allowed on U and V against the reference, after 256 steps
#: (the reasons and measured errors are in PERF.md)
TOLERANCE = 1e-4

PARITY_SHAPE = (1080, 1920)
PARITY_STEPS = 256
PARITY_BACKENDS = (
    ("naive", {}),
    ("regular", {}),
    ("fused", {}),
    ("fused", {"runtime_weights": True}),
    ("conv", {}),
)
THROUGHPUT_SHAPES = ((1080, 1920), (4096, 4096))
BOUNDARIES = ("naive", "zero")


def _log(msg: str) -> None:
    print(msg, flush=True)


def device_phase(platform: str = "gpu") -> dict:
    """The device JAX reports; fails unless it is on ``platform``."""
    import jax

    devices = jax.devices()
    dev = devices[0]
    if dev.platform != platform:
        raise RuntimeError(
            f"JAX found no {platform} device (device 0 is {dev.platform!r})")
    info = {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(devices)}
    _log(f"device: {info}")
    return info


def card_phase() -> str:
    from grayscott_tpu.bench import roofline

    card = roofline.card_line()
    _log(f"card (name, power limit): {card}")
    return card


def selector_phase(shape=PARITY_SHAPE) -> str:
    from grayscott_tpu.backends import best_backend_name

    name = best_backend_name(shape)
    _log(f"selector: best_backend_name({shape}) = {name}")
    return name


def max_errors(got, want) -> tuple[float, float]:
    """(max |dU|, max |dV|) between two (u, v) host pairs."""
    return tuple(float(np.abs(np.asarray(g) - w).max())
                 for g, w in zip(got, want))


def check(label: str, errs, tol: float = TOLERANCE) -> None:
    """Print ``errs`` beside ``tol``; raise if either exceeds it."""
    _log(f"{label}: max|dU| = {errs[0]:.3e}, max|dV| = {errs[1]:.3e} "
         f"(tolerance {tol:.0e})")
    if not all(e <= tol for e in errs):  # NaN fails too
        raise AssertionError(f"{label}: error {errs} above {tol}")


def oracle_run(shape, steps: int, boundary: str, params=None):
    from grayscott_tpu import oracle
    from grayscott_tpu.params import Parameters
    from grayscott_tpu.species import initial_uv

    u, v = initial_uv(shape)
    return oracle.run(u, v, params or Parameters(), steps, boundary)


def run_backend(name: str, shape, steps: int, boundary: str, **kwargs):
    """Host (u, v) after ``steps`` steps of ``name`` from the standard
    init."""
    from grayscott_tpu.backends import get_backend
    from grayscott_tpu.params import Parameters

    sim = get_backend(name)(Parameters(), boundary=boundary, **kwargs)
    species = sim.make_species(shape)
    sim.perform_steps(species, steps)
    return species.uv_host()


def parity_phase(shape=PARITY_SHAPE, steps: int = PARITY_STEPS,
                 boundaries=BOUNDARIES, backends=PARITY_BACKENDS,
                 tol: float = TOLERANCE) -> dict:
    """Every single-device backend against the oracle; returns the
    oracle's (u, v) per boundary."""
    refs = {}
    for boundary in boundaries:
        t0 = time.perf_counter()
        refs[boundary] = oracle_run(shape, steps, boundary)
        _log(f"oracle {shape[0]}x{shape[1]} {boundary} {steps} steps: "
             f"{time.perf_counter() - t0:.1f} s on the host")
        for name, kwargs in backends:
            got = run_backend(name, shape, steps, boundary, **kwargs)
            label = name + ("[runtime_weights]" if kwargs else "")
            check(f"parity {label} {boundary} {shape[0]}x{shape[1]} "
                  f"{steps} steps", max_errors(got, refs[boundary]), tol)
    return refs


def pipeline_phase(argv=("-n", "8")) -> tuple[np.ndarray, int]:
    """The simulate CLI's pipeline on its parsed arguments, into an
    in-memory sink; returns (last image, images received)."""
    from grayscott_tpu.cli import shared, simulate

    args = simulate.build_parser().parse_args(list(argv))
    sim = shared.make_simulation(args)
    species = sim.make_species(shared.domain_shape(args))
    steps = (args.nbextrastep if args.nbextrastep is not None
             else simulate.DEFAULT_STEPS_PER_IMAGE)
    received = []

    def sink(image):
        received.append(image)

    simulate.run_pipeline(sim, species, args.nbimage, steps, sink,
                          output_buffer=args.output_buffer,
                          snapshot_dtype=args.snapshot_dtype)
    if len(received) != args.nbimage:
        raise AssertionError(
            f"pipeline produced {len(received)} images, not {args.nbimage}")
    _log(f"pipeline: backend={sim.name} {args.nbimage} images of "
         f"{steps} steps at {args.nbrow}x{args.nbcol}, {args.boundary}")
    return received[-1], args.nbimage * steps


def throughput_phase(shapes=THROUGHPUT_SHAPES, steps: int = 1000,
                     boundaries=BOUNDARIES, card: str = "") -> dict:
    """Best-of-3 Gcell/s of ``fused`` per (shape, boundary)."""
    from grayscott_tpu.backends import get_backend
    from grayscott_tpu.params import Parameters

    rates = {}
    for shape in shapes:
        for boundary in boundaries:
            sim = get_backend("fused")(Parameters(), boundary=boundary)
            species = sim.make_species(shape)
            sim.perform_steps(species, steps)  # compile + warm up
            best = float("inf")
            for _ in range(3):
                t0 = time.perf_counter()
                sim.perform_steps(species, steps)
                best = min(best, time.perf_counter() - t0)
            v = species.result_host()
            if not np.isfinite(v).all():
                raise AssertionError(f"non-finite V at {shape} {boundary}")
            rate = shape[0] * shape[1] * steps / best / 1e9
            rates[(shape, boundary)] = rate
            _log(f"throughput fused {shape[0]}x{shape[1]} {boundary} "
                 f"{steps} steps: {rate} Gcell/s ({best * 1e3:.3f} ms) "
                 f"on {card}")
    return rates


def four_card_phase(shape=(8192, 8192), meshes=((4, 1), (2, 2)),
                    steps: int = 256, boundaries=BOUNDARIES,
                    oracle_shape=(1024, 1024), n_devices: int = 4,
                    timed_steps: int = 1024, card: str = "",
                    tol: float = TOLERANCE) -> None:
    """The sharded path against one-card ``fused`` and the oracle."""
    import jax

    from grayscott_tpu.backends import get_backend
    from grayscott_tpu.backends.sharded import ShardedSimulation
    from grayscott_tpu.params import Parameters

    if len(jax.devices()) < n_devices:
        raise RuntimeError(f"need {n_devices} devices, JAX sees "
                           f"{len(jax.devices())}")

    def timed(sim, species, n):
        t0 = time.perf_counter()
        sim.perform_steps(species, n)
        dt = time.perf_counter() - t0
        return species.shape[0] * species.shape[1] * n / dt / 1e9

    for boundary in boundaries:
        fsim = get_backend("fused")(Parameters(), boundary=boundary)
        fspecies = fsim.make_species(shape)
        fsim.perform_steps(fspecies, steps)
        ref = fspecies.uv_host()
        _log(f"throughput fused one card {boundary} {shape[0]}x{shape[1]} "
             f"{timed_steps} steps: {timed(fsim, fspecies, timed_steps)} "
             f"Gcell/s on {card}")
        del fspecies
        for nr, nc in meshes:
            sim = ShardedSimulation(Parameters(), boundary=boundary,
                                    n_devices=n_devices, mesh_cols=nc)
            species = sim.make_species(shape)
            sim.perform_steps(species, steps)
            if tuple(sim.mesh.devices.shape) != (nr, nc):
                raise AssertionError(f"mesh {sim.mesh.devices.shape}")
            check(f"sharded {nr}x{nc} {boundary} {shape[0]}x{shape[1]} "
                  f"{steps} steps vs fused on one card",
                  max_errors(species.uv_host(), ref), tol)
            _log(f"throughput sharded {nr}x{nc} {boundary} "
                 f"{shape[0]}x{shape[1]} {timed_steps} steps: "
                 f"{timed(sim, species, timed_steps)} Gcell/s on "
                 f"{n_devices} x {card}")
            del species
    for boundary in boundaries:
        sim = ShardedSimulation(Parameters(), boundary=boundary,
                                n_devices=n_devices)
        species = sim.make_species(oracle_shape)
        sim.perform_steps(species, steps)
        mesh = tuple(sim.mesh.devices.shape)
        check(f"sharded {mesh[0]}x{mesh[1]} {boundary} "
              f"{oracle_shape[0]}x{oracle_shape[1]} {steps} steps vs oracle",
              max_errors(species.uv_host(),
                         oracle_run(oracle_shape, steps, boundary)), tol)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the sharded path on four cards")
    args = parser.parse_args(argv)

    from grayscott_tpu.utils.cache import enable_compilation_cache

    _log(f"compile cache: {enable_compilation_cache()}")
    t0 = time.perf_counter()
    info = device_phase()
    card = card_phase()
    if args.four_cards:
        four_card_phase(card=card.splitlines()[0])
    else:
        if info["count"] != 1:
            raise RuntimeError(
                f"the one-card smoke needs exactly one visible card, JAX "
                f"sees {info['count']}")
        name = selector_phase()
        if name != "fused":
            raise AssertionError(f"selector chose {name!r}, not 'fused'")
        refs = parity_phase()
        image, steps = pipeline_phase()
        if steps != PARITY_STEPS:
            raise AssertionError(f"pipeline ran {steps} steps, the oracle "
                                 f"{PARITY_STEPS}")
        ref_v = refs["naive"][1]
        check("pipeline last image vs oracle",
              (0.0, float(np.abs(image - ref_v).max())))
        throughput_phase(card=card)
    _log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": info}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
