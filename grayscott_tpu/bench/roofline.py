"""Published peaks of the cards the benchmark runs on, and the card's
identity as ``nvidia-smi`` reports it.

One Gray-Scott cell-step must at least read U and V and write them back,
all float32: 16 bytes. A step that streams both species through device
memory once is bound by memory bandwidth, so the roofline rate is the
card's memory bandwidth over 16 bytes per cell-step.
"""

from __future__ import annotations

import subprocess

#: Device-memory bandwidth in bytes/s by ``jax.devices()[0].device_kind``.
#: Source: NVIDIA H100 Tensor Core GPU data sheet (H100 SXM 3.35 TB/s,
#: H100 PCIe 2.0 TB/s).
HBM_BYTES_PER_S: dict[str, float] = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
    "NVIDIA H100 PCIe": 2.0e12,
}

#: Least bytes one cell-step moves: U and V read and written, float32.
BYTES_PER_CELL_STEP = 16


def hbm_peak(kind: str) -> float:
    """Published memory bandwidth of ``kind``; an unknown kind is an
    error, never a default."""
    try:
        return HBM_BYTES_PER_S[kind]
    except KeyError:
        raise ValueError(
            f"no published memory bandwidth for device kind {kind!r}; "
            f"known: {sorted(HBM_BYTES_PER_S)}"
        ) from None


def roofline_gcells(kind: str) -> float:
    """Single-step roofline in Gcell-updates/s for ``kind``."""
    return hbm_peak(kind) / BYTES_PER_CELL_STEP / 1e9


def card_line() -> str:
    """``name, power.limit`` of every visible card, one line each."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
