"""What am I running on: the device-capability report.

The analog of the reference's trace-level device-capability dump
(compute/shared/src/gpu/context/device.rs:77-118, library.rs:10-33).
"""

from __future__ import annotations

import os


def capability_dump() -> str:
    """One-shot verbose "what am I running on" report: versions, every
    visible device with its memory stats, the compile-cache location and
    the configuration environment. The CLI drivers log it at DEBUG on
    simulation construction (enable with GRAYSCOTT_LOG_LEVEL=DEBUG); for
    a bug report, print it directly:

        python -m grayscott_tpu.utils.device
    """
    import jax

    lines = [
        f"jax {jax.__version__}; "
        f"default backend {jax.default_backend()!r}",
        f"process {jax.process_index()}/{jax.process_count()}; "
        f"{jax.device_count()} device(s), "
        f"{jax.local_device_count()} local",
    ]
    for d in jax.devices():
        desc = (f"  device {d.id}: platform={d.platform} "
                f"kind={d.device_kind!r} process={d.process_index}")
        stats = d.memory_stats() or {}
        in_use = stats.get("bytes_in_use")
        limit = stats.get("bytes_limit")
        if in_use is not None:
            desc += f" mem_in_use={in_use >> 20}MiB"
        if limit:
            desc += f" mem_limit={limit >> 20}MiB"
        lines.append(desc)
    from . import cache

    lines.append(f"compile cache: {cache.compilation_cache_dir()}")
    env = {k: v for k, v in sorted(os.environ.items())
           if k.startswith("GRAYSCOTT_") or k in
           ("JAX_PLATFORMS", "JAX_COMPILATION_CACHE_DIR", "XLA_FLAGS",
            "CUDA_VISIBLE_DEVICES", "XLA_PYTHON_CLIENT_MEM_FRACTION")}
    lines.append("environment: " + (
        " ".join(f"{k}={v}" for k, v in env.items()) or "(defaults)"))
    return "\n".join(lines)


if __name__ == "__main__":  # pragma: no cover - bug-report shim
    print(capability_dump())
