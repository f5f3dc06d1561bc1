"""Batch simulation CLI.

Argument-compatible with the reference's ``simulate`` binary
(``simulate/src/main.rs:22-44``): shared args plus ``-n/--nbimage``
(default 1000), ``-o/--output`` (default ``output.h5``) and
``--output-buffer`` (default 2); ``--nbextrastep`` defaults to 32 steps per
image (``main.rs:52``).

Pipeline structure mirrors the reference (``main.rs:73-122``): the main
thread drives the device, an I/O thread hands snapshots to a sink (the
HDF5 writer here) through a bounded queue (:func:`run_pipeline`). Two
levels of compute/IO overlap:

1. device-side: each 32-step batch is dispatched asynchronously, and the
   snapshot device->host copy is enqueued on the same dependency chain —
   the analog of the reference's `async-gpu` single-submission path
   (main.rs:99-106 + write_scalar_view_after); the host only blocks on the
   *previous* image's transfer while the device runs the next batch.
2. host-side: the sink runs on a separate thread behind a bounded queue
   (the mpsc::sync_channel analog).

Unlike the reference (``main.rs:73-122``) and our ``data_to_pics`` there
is no buffer-recycling return channel here: the host snapshot array is
allocated inside JAX's device-to-host transfer (jax owns the destination
of the DMA), so handing a recycled buffer back would require an extra
host-side memcpy per image instead of removing one. The bounded queue
still caps live images at ``--output-buffer + 2``.
"""

from __future__ import annotations

import argparse
import queue
import sys
import threading

import numpy as np

from ..io.hdf5 import Writer
from ..utils.logs import init_logging
from ..utils.progress import ProgressBar
from . import shared

#: Steps between images when ``-e`` is not given (simulate/src/main.rs:52)
DEFAULT_STEPS_PER_IMAGE = 32


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="simulate", description="Perform Gray-Scott simulation"
    )
    shared.add_shared_args(parser)
    parser.add_argument(
        "-n", "--nbimage", type=int, default=1000,
        help="Number of images to be created",
    )
    parser.add_argument(
        "-o", "--output", default=None, help="Path to the results output file"
    )
    parser.add_argument(
        "--output-buffer", type=int, default=2,
        help="Size of the image buffer between the compute and I/O thread",
    )
    parser.add_argument(
        "--snapshot-dtype", choices=["float32", "bfloat16"],
        default="float32",
        help="Precision of the device->host snapshot TRANSFER. bfloat16 "
        "halves the bytes copied to the host; the HDF5 file stays float32 "
        "(upcast host-side), at ~3 significant digits — "
        "visualization-grade, not parity-grade",
    )
    parser.add_argument(
        "--checkpoint", default=None,
        help="Write full simulation state (U and V) here when done, "
        "for later --resume (capability the reference lacks)",
    )
    parser.add_argument(
        "--resume", default=None,
        help="Initialize state from a checkpoint instead of the standard box",
    )
    return parser


def run_pipeline(sim, species, nbimage: int, steps_per_image: int, sink,
                 output_buffer: int = 2,
                 snapshot_dtype: str = "float32") -> None:
    """The snapshot loop: ``nbimage`` batches of ``steps_per_image`` steps,
    each followed by one V snapshot handed to ``sink(image)`` on the I/O
    thread, in order, as a float32 host array.

    The device runs batch N+1 while the host fetches snapshot N: each
    batch is dispatched asynchronously with a device-side snapshot copy
    on the same dependency chain, and the host blocks only on the
    *previous* image's transfer. A bounded queue of ``output_buffer``
    images separates the fetching thread from the sink. An exception
    raised by the sink stops the loop and is re-raised here.
    """
    import jax.numpy as jnp

    from ..utils import distributed as dist

    # optional device-side downcast of the snapshot TRANSFER; the host
    # image is float32 either way
    transfer_dtype = jnp.bfloat16 if snapshot_dtype == "bfloat16" else None
    error: list[BaseException] = []
    q: queue.Queue = queue.Queue(maxsize=max(output_buffer, 1))

    def put_checked(item) -> bool:
        # dead consumer = the sink recorded an error (shared.bounded_put)
        return shared.bounded_put(q, item, lambda: bool(error))

    def io_thread() -> None:
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                sink(item)
        except BaseException as e:  # pragma: no cover - propagated below
            error.append(e)

    def snap():
        # must yield a FRESH device buffer: result() views the donated
        # state, which the next prepare_steps overwrites. The bf16 path's
        # dtype-changing cast already materializes a new buffer, so only
        # the f32 path needs an explicit copy.
        v = species.result()
        if transfer_dtype is None:
            return jnp.copy(v)
        return v.astype(transfer_dtype)

    def to_host(x):
        out = dist.fetch(x)
        return out.astype(np.float32) if transfer_dtype else out

    t = threading.Thread(target=io_thread, name="snapshot-sink", daemon=True)
    t.start()
    try:
        pending = None  # device array whose transfer overlaps the next batch
        for _ in range(nbimage):
            # Enqueue the next batch + an independent snapshot copy on the
            # device stream (prepare_steps is asynchronous).
            sim.prepare_steps(species, steps_per_image)
            snapshot = snap()
            if pending is not None:
                # sync point: previous image only
                put_checked(to_host(pending))
            pending = snapshot
            if error:
                raise error[0]
        if pending is not None:
            put_checked(to_host(pending))
    finally:
        put_checked(None)
        t.join()
    if error:
        raise error[0]


def main(argv=None) -> int:
    logger = init_logging()
    from ..utils.runtime import apply_env_config

    apply_env_config()
    from ..utils.cache import enable_compilation_cache

    enable_compilation_cache()
    from ..utils import distributed as dist

    dist.maybe_initialize(logger)
    args = build_parser().parse_args(argv)
    steps_per_image = (args.nbextrastep if args.nbextrastep is not None
                       else DEFAULT_STEPS_PER_IMAGE)
    file_name = shared.simulation_output_path(args.output)

    sim = shared.make_simulation(args)

    if args.resume:
        from ..io.checkpoint import load_state
        from ..species import Species

        u0, v0, ck_params, ck_steps = load_state(args.resume)
        if ck_params != sim.params:
            logger.warning(
                "checkpoint parameters differ from CLI parameters; "
                "using CLI parameters"
            )
        species = Species(u0.shape, sim.build_storage(u0, v0), sim)
        species.steps_performed = ck_steps
        logger.info("resumed from %s at step %d", args.resume, ck_steps)
    else:
        species = sim.make_species(shared.domain_shape(args))
    # log the shape the run ACTUALLY simulates: a resumed checkpoint's
    # domain wins over the -r/-c defaults
    logger.info(
        "backend=%s boundary=%s stencil=%s domain=%dx%d",
        sim.name, sim.boundary, sim.params.stencil_name(),
        species.shape[0], species.shape[1],
    )
    # one process owns the output file and the progress bar; the others
    # still run the (collective) compute + gather
    primary = dist.is_primary()
    writer = Writer(file_name, species.shape, args.nbimage) if primary else None
    progress = ProgressBar(
        "Running simulation step", args.nbimage if primary else 0
    )

    def sink(image: np.ndarray) -> None:
        if writer is not None:
            writer.write(image)
            progress.inc(1)

    try:
        run_pipeline(sim, species, args.nbimage, steps_per_image, sink,
                     output_buffer=args.output_buffer,
                     snapshot_dtype=args.snapshot_dtype)
    finally:
        progress.finish()
        if writer is not None:
            writer.close()
    if args.checkpoint:
        from ..io.checkpoint import save_state

        u, v = species.uv_host()  # collective gather: all processes call it
        if primary:
            save_state(
                args.checkpoint, u, v, sim.params, species.steps_performed
            )
            logger.info("checkpoint written to %s", args.checkpoint)
    logger.info("wrote %d images to %s", args.nbimage, file_name)
    return 0


if __name__ == "__main__":
    sys.exit(main())
