"""Simulation state checkpointing.

The reference has no state checkpointing — its HDF5 output stores only V
snapshots for visualization (SURVEY.md section 5). Restarting a simulation
from an output file is impossible there because U is discarded. This module
adds full checkpoint/resume: both concentrations plus metadata, in a small
HDF5 file, wired into ``simulate --checkpoint/--resume``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Tuple

import numpy as np

from ..params import Parameters, Precision

FORMAT_VERSION = 1


def save_state(
    path: os.PathLike | str,
    u: np.ndarray,
    v: np.ndarray,
    params: Parameters,
    steps_performed: int = 0,
) -> None:
    u = np.asarray(u, dtype=Precision)
    v = np.asarray(v, dtype=Precision)
    if u.shape != v.shape:
        raise ValueError(f"u/v shape mismatch: {u.shape} vs {v.shape}")
    import h5py

    with h5py.File(path, "w") as f:
        f.create_dataset("u", data=u)
        f.create_dataset("v", data=v)
        f.attrs["format_version"] = FORMAT_VERSION
        f.attrs["steps_performed"] = steps_performed
        f.attrs["params"] = json.dumps(dataclasses.asdict(params))


def load_state(
    path: os.PathLike | str,
) -> Tuple[np.ndarray, np.ndarray, Parameters, int]:
    import h5py

    with h5py.File(path, "r") as f:
        if int(f.attrs.get("format_version", -1)) != FORMAT_VERSION:
            raise ValueError(f"{path}: not a grayscott-tpu checkpoint")
        u = np.asarray(f["u"], dtype=Precision)
        v = np.asarray(f["v"], dtype=Precision)
        raw = json.loads(f.attrs["params"])
        raw["weights"] = tuple(tuple(row) for row in raw["weights"])
        params = Parameters(**raw)
        steps = int(f.attrs["steps_performed"])
    return u, v, params, steps
