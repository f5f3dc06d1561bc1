"""Benchmark harness: the criterion-suite analog.

Reproduces the reference's measurement methodology
(``compute/shared/src/benchmark.rs``):

- sweep of domain sizes ``[2^s, 2^{s+1}]`` for s in 3..11 and step batches
  ``2^0..2^8`` (``benchmark.rs:50-56``), both configurable;
- throughput in cell-updates/sec (``Throughput::Elements(cells * steps)``,
  ``benchmark.rs:59``);
- three workloads (``benchmark.rs:77-113``):
  * ``compute``    — simulation steps only (closed by block_until_ready);
  * ``full_sync``  — steps + full V readback to the host each iteration;
  * ``full_future``— steps + readback scheduled as one async chain (the
    GPU single-submission analog: device-side snapshot copy enqueued with
    the steps, host touches it once);
  plus a beyond-reference one:
  * ``device``     — device busy time from a jax.profiler trace of the
    dispatch (utils/xplane.py), without the host's dispatch and sync
    costs. GPU only.

Denormals: the reference flushes denormals during its measurements
(DenormalsFlusher, compute/shared/src/lib.rs:123-213); XLA's GPU code
keeps them, which changes no result of this solver measurably (its
concentrations stay in [0, 1] and far from the denormal range).
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Iterable, List, Sequence

import numpy as np


@dataclasses.dataclass
class Result:
    backend: str
    workload: str
    shape: tuple
    steps: int
    seconds: float
    #: best-sample rate — the noise-floor estimator, comparable with the
    #: rounds-1/2 sweep history
    gcells_per_sec: float
    #: run labels (boundary, dtype, pinned tunables) so sweep files from
    #: different precisions/configs stay distinguishable
    extra: dict = dataclasses.field(default_factory=dict)
    #: raw per-rep rates (persisted for re-analysis; criterion keeps its
    #: raw samples too) and their robust summary (bench/stats.py):
    #: median/MAD/CI95/outlier counts — what reports and adoption gates
    #: should reason from
    samples_gcells: list = dataclasses.field(default_factory=list)
    stats: dict = dataclasses.field(default_factory=dict)

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d.update(d.pop("extra"))
        return d


def default_domains(smin: int = 3, smax: int = 11) -> List[tuple]:
    """[2^s, 2^{s+1}] for s in smin..smax (benchmark.rs:50-56)."""
    return [(1 << s, 1 << (s + 1)) for s in range(smin, smax + 1)]


def default_step_counts() -> List[int]:
    return [1 << n for n in range(9)]  # 2^0 .. 2^8


def _device_time_rep(sim, species, steps: int) -> float:
    """One traced dispatch; returns the device busy seconds (the union of
    kernel intervals, utils/xplane.kernel_summary)."""
    import shutil
    import tempfile

    import jax

    from ..utils import xplane

    tdir = tempfile.mkdtemp(prefix="gs_devtime_")
    try:
        jax.profiler.start_trace(tdir)
        try:
            sim.perform_steps(species, steps)
        finally:
            # a mid-trace failure must still close the profiler session,
            # or every later start_trace in this process raises "profiler
            # already started"
            jax.profiler.stop_trace()
        return xplane.kernel_summary(tdir)["busy_ms"] * 1e-3
    finally:
        shutil.rmtree(tdir, ignore_errors=True)


def run_one(
    sim, shape, steps: int, workload: str = "compute", reps: int = 5,
    extra: dict | None = None,
) -> Result:
    import jax.numpy as jnp

    from . import stats

    species = sim.make_species(shape)
    sim.perform_steps(species, steps)  # compile + warmup
    times = []
    for _ in range(reps):
        if workload == "device":
            times.append(_device_time_rep(sim, species, steps))
            continue
        t0 = time.perf_counter()
        sim.prepare_steps(species, steps)
        if workload == "compute":
            sim.block_until_ready(species)
        elif workload == "full_sync":
            np.asarray(species.result())
        elif workload == "full_future":
            snap = jnp.copy(species.result())
            np.asarray(snap)
        else:
            raise ValueError(f"unknown workload {workload!r}")
        times.append(time.perf_counter() - t0)
    cells = shape[0] * shape[1] * steps
    best = min(times)
    rates = [cells / t / 1e9 for t in times]
    return Result(
        backend=sim.name, workload=workload, shape=tuple(shape), steps=steps,
        seconds=best, gcells_per_sec=cells / best / 1e9,
        extra=dict(extra or {}),
        samples_gcells=[round(r, 4) for r in rates],
        stats=stats.summarize(rates),
    )


def sweep(
    backend_names: Sequence[str],
    domains: Iterable[tuple] | None = None,
    step_counts: Iterable[int] | None = None,
    workloads: Sequence[str] = ("compute",),
    boundary: str = "naive",
    reps: int = 5,
    out_path: str | None = None,
    verbose: bool = True,
    backend_kwargs: dict | None = None,
) -> List[Result]:
    from ..backends import get_backend
    from ..params import Parameters

    domains = list(domains or default_domains())
    step_counts = list(step_counts or default_step_counts())
    results = []
    for name in backend_names:
        kwargs = dict(backend_kwargs or {})
        labels = {"boundary": boundary, **kwargs}
        sim = get_backend(name)(Parameters(), boundary=boundary, **kwargs)
        for shape in domains:
            for steps in step_counts:
                for workload in workloads:
                    res = run_one(sim, shape, steps, workload, reps,
                                  extra=labels)
                    results.append(res)
                    if verbose:
                        print(
                            f"{name:8s} {workload:11s} {shape[0]:5d}x{shape[1]:<5d} "
                            f"steps={steps:3d}  {res.gcells_per_sec:8.2f} Gcell/s",
                            flush=True,
                        )
    if out_path:
        with open(out_path, "w") as f:
            json.dump([r.to_json() for r in results], f, indent=1)
    return results


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        prog="grayscott-bench",
        description="Throughput sweep (criterion benchmark analog)",
    )
    parser.add_argument("--report", metavar="SWEEP_JSON", default=None,
                        help="render a report from a sweep JSON file "
                        "instead of measuring (criterion-HTML-report "
                        "analog)")
    parser.add_argument("--baseline", metavar="SWEEP_JSON", default=None,
                        help="with --report: baseline sweep to diff "
                        "against (adds a vs-baseline delta column)")
    parser.add_argument("--format", default="markdown",
                        choices=["markdown", "html", "svg"],
                        help="report output format (html embeds the "
                        "throughput-vs-size SVG plot; svg emits it alone)")
    parser.add_argument("--gate", action="store_true",
                        help="with --report and --baseline: exit 1 on any "
                        "SIGNIFICANT regression (CI95 non-overlap, not "
                        "point delta — within-noise deltas never fail)")
    parser.add_argument("--backends", default="auto",
                        help="comma-separated backend names, or 'auto'")
    parser.add_argument("--smin", type=int, default=3)
    parser.add_argument("--smax", type=int, default=11)
    parser.add_argument("--steps", default=None,
                        help="comma-separated step counts (default 1..256 pow2)")
    parser.add_argument("--workloads", default="compute",
                        help="comma-separated: compute,full_sync,"
                        "full_future,device")
    parser.add_argument("--boundary", default="naive", choices=["naive", "zero"])
    parser.add_argument("--reps", type=int, default=5,
                        help="samples per measurement (median/MAD/CI95 "
                        "are reported from these; criterion analog)")
    parser.add_argument("-o", "--output", default=None, help="JSON output path")
    args = parser.parse_args(argv)

    if args.report:
        from . import report as report_mod
        from .report import report

        text = report(args.report, args.baseline, args.format)
        if args.output:
            with open(args.output, "w") as f:
                f.write(text)
        else:
            print(text, end="")
        if args.gate and args.baseline:
            rows = report_mod.build_rows(
                report_mod.load_results(args.report),
                report_mod.load_results(args.baseline))
            bad = report_mod.gate(rows)
            for r in bad:
                print(f"REGRESSION {r['backend']} {r['shape']} "
                      f"steps={r['steps']}: {r['delta_pct']:+.1f}% "
                      "(CI95s do not overlap)", flush=True)
            return 1 if bad else 0
        return 0

    # jax touches the device at import on some setups, so defer platform
    # configuration until we know this run actually measures
    from ..utils.cache import enable_compilation_cache
    from ..utils.runtime import apply_env_config

    apply_env_config()  # honor GRAYSCOTT_PLATFORM like the other binaries
    enable_compilation_cache()
    if args.backends == "auto":
        from ..backends import best_backend_name

        names = [best_backend_name()]
    else:
        names = args.backends.split(",")
    steps = [int(s) for s in args.steps.split(",")] if args.steps else None
    sweep(
        names,
        domains=default_domains(args.smin, args.smax),
        step_counts=steps,
        workloads=args.workloads.split(","),
        boundary=args.boundary,
        reps=args.reps,
        out_path=args.output,
    )
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
