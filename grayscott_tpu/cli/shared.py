"""CLI arguments shared by the simulation programs.

Argument-compatible with the reference's ``SharedArgs``
(``ui/src/lib.rs:18-46``): ``-k/--killrate``, ``-f/--feedrate``,
``-e/--nbextrastep``, ``-r/--nbrow`` (default 1080), ``-c/--nbcol``
(default 1920), ``-t/--deltat``, plus flattened backend-specific arguments.
Runtime additions that replace the reference's compile-time Cargo features:
``--backend`` (the `selector` analog), ``--stencil`` (the `weights-*`
feature analog) and ``--boundary``.
"""

from __future__ import annotations

import argparse
import os
from typing import Tuple

from ..params import DEFAULT_STENCIL, Parameters, PRESETS, STENCILS


def add_shared_args(parser: argparse.ArgumentParser) -> None:
    # one user-facing support-matrix surface (grayscott_tpu/support.py):
    # the same table the README renders, as the --help epilog
    from .. import support

    if parser.epilog is None:
        parser.epilog = support.render("text")
        parser.formatter_class = argparse.RawDescriptionHelpFormatter
    parser.add_argument(
        "-k", "--killrate", type=float, default=None,
        help="Rate of the process which converts V into P",
    )
    parser.add_argument(
        "-f", "--feedrate", type=float, default=None,
        help="Rate of the process which feeds U and drains U, V and P",
    )
    parser.add_argument(
        "-e", "--nbextrastep", type=int, default=None,
        help="Number of simulation steps to perform between images",
    )
    parser.add_argument(
        "-r", "--nbrow", type=int, default=1080,
        help="Number of rows of the images to be created",
    )
    parser.add_argument(
        "-c", "--nbcol", type=int, default=1920,
        help="Number of columns of the images to be created",
    )
    parser.add_argument(
        "-t", "--deltat", type=float, default=None,
        help="Simulated time interval on each simulation step",
    )
    parser.add_argument(
        "--preset",
        default=os.environ.get("GRAYSCOTT_PRESET") or None,
        choices=sorted(PRESETS),
        help="Named (feed, kill) pattern preset from Pearson's regime "
        "map (solitons, mitosis, coral, maze, worms, waves, u-skate, "
        "chaos; 'reference' = the reference's default pair). Explicit "
        "-f/-k still override",
    )
    parser.add_argument(
        "--backend",
        default=os.environ.get("GRAYSCOTT_BACKEND", "auto"),
        help="Compute backend (default: best available; env GRAYSCOTT_BACKEND)",
    )
    parser.add_argument(
        "--stencil",
        default=os.environ.get("GRAYSCOTT_STENCIL", DEFAULT_STENCIL),
        choices=sorted(STENCILS),
        help="Laplacian stencil (the reference's weights-* feature analog)",
    )
    parser.add_argument(
        "--boundary",
        default=os.environ.get("GRAYSCOTT_BOUNDARY", "naive"),
        choices=["naive", "zero"],
        help="Boundary semantics: 'naive' = reference CPU backends "
        "(clamped window), 'zero' = reference GPU backends (zero border)",
    )
    # Backend-specific args (clap flatten analog)
    from ..backends import BACKENDS

    for cls in BACKENDS.values():
        cls.add_cli_args(parser)


def simulation_parameters(ns: argparse.Namespace) -> Parameters:
    """Overlay CLI args onto defaults (ui/src/lib.rs:51-63); a --preset
    supplies the (feed, kill) base pair, explicit -f/-k override it."""
    kwargs = {}
    if ns.killrate is not None:
        kwargs["kill_rate"] = ns.killrate
    if ns.feedrate is not None:
        kwargs["feed_rate"] = ns.feedrate
    if ns.deltat is not None:
        kwargs["time_step"] = ns.deltat
    preset = getattr(ns, "preset", None)
    if preset:
        return Parameters.with_preset(preset, stencil=ns.stencil, **kwargs)
    return Parameters.with_stencil(ns.stencil, **kwargs)


def domain_shape(ns: argparse.Namespace) -> Tuple[int, int]:
    return (ns.nbrow, ns.nbcol)


def make_simulation(ns: argparse.Namespace):
    from ..backends import best_backend_name, get_backend

    name = ns.backend
    if name in (None, "", "auto"):
        name = best_backend_name(shape=domain_shape(ns))
    cls = get_backend(name)
    kwargs = cls.args_from_namespace(ns)
    params = simulation_parameters(ns)
    import logging

    logger = logging.getLogger("grayscott_tpu")
    if logger.isEnabledFor(logging.DEBUG):
        # the reference's trace-level capability dump on context build
        # (device.rs:77-118): everything a bug report needs, once
        from ..utils import device as _device

        logger.debug("device capabilities:\n%s", _device.capability_dump())
    return cls(params, boundary=ns.boundary, **kwargs)


def simulation_output_path(path) -> str:
    """Default output file name (ui/src/lib.rs:72-75)."""
    return str(path) if path else "output.h5"


def bounded_put(q, item, dead, timeout: float = 1.0) -> bool:
    """Bounded queue put that keeps checking a dead-consumer predicate:
    a plain ``q.put`` deadlocks on a full queue whose consumer thread
    died (full disk, unwritable directory). Returns False when ``dead()``
    reports no consumer remains. Shared by the simulate and data-to-pics
    pipelines — one copy of the deadlock-avoidance protocol."""
    import queue as _queue

    while True:
        try:
            q.put(item, timeout=timeout)
            return True
        except _queue.Full:
            if dead():
                return False
