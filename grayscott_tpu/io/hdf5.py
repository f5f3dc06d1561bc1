"""HDF5 snapshot I/O.

Layout-compatible with the reference's snapshot format
(``data/src/hdf5.rs:36-54``): one 3-D float32 dataset named ``"matrix"``
(``hdf5.rs:24``) of shape ``[num_images, rows, cols]`` with chunk shape
``[1, rows, cols]``, holding V-species concentrations. A file written by
this module is readable by the reference's ``data-to-pics`` and vice versa.
"""

from __future__ import annotations

import os
from typing import Iterator, Optional, Tuple

import numpy as np

from ..params import Precision

#: Default dataset name (reference: data/src/hdf5.rs:24)
DEFAULT_DATASET = "matrix"


def _chunk_shape(rows: int, cols: int, itemsize: int) -> Tuple[int, int, int]:
    """Chunk shape for one snapshot: ``(1, rows, cols)`` — the reference's
    layout (data/src/hdf5.rs:44-47) — unless that exceeds HDF5's hard
    4 GiB-per-chunk limit (h5py refuses the dataset outright), in which
    case the row dimension is halved until the chunk fits. Only domains
    at or beyond 32768x32768 f32 are affected; files stay readable by any
    HDF5 consumer (chunking is transparent), they just lose the exact
    one-chunk-per-image layout that cannot exist at that size."""
    r_chunk = rows
    while r_chunk > 1 and r_chunk * cols * itemsize >= 1 << 32:
        r_chunk = -(-r_chunk // 2)
    return (1, r_chunk, cols)


class Writer:
    """Streaming snapshot writer (``hdf5::Writer``, data/src/hdf5.rs:30-78)."""

    def __init__(
        self,
        file_name: os.PathLike | str,
        shape: Tuple[int, int],
        num_images: int,
        dataset_name: str = DEFAULT_DATASET,
    ):
        rows, cols = shape
        import h5py

        self._file = h5py.File(file_name, "w")
        self._dataset = self._file.create_dataset(
            dataset_name,
            shape=(num_images, rows, cols),
            dtype=Precision,
            chunks=_chunk_shape(rows, cols, np.dtype(Precision).itemsize),
        )
        self._position = 0

    def write(self, result: np.ndarray) -> None:
        """Append one V concentration snapshot (``Writer::write``)."""
        self._dataset[self._position] = np.asarray(result, dtype=Precision)
        self._position += 1

    def close(self) -> None:
        """Flush and close (``Writer::close``)."""
        self._file.close()

    def __enter__(self) -> "Writer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class Reader:
    """Snapshot reader / iterator (``hdf5::Reader``, data/src/hdf5.rs:81-148)."""

    def __init__(
        self,
        file_name: os.PathLike | str,
        dataset_name: str = DEFAULT_DATASET,
    ):
        import h5py

        self._file = h5py.File(file_name, "r")
        self._dataset = self._file[dataset_name]
        if self._dataset.ndim != 3:
            raise ValueError("Dataset should be three-dimensional")
        self._position = 0

    @property
    def image_shape(self) -> Tuple[int, int]:
        return tuple(self._dataset.shape[1:])

    @property
    def num_images(self) -> int:
        return self._dataset.shape[0]

    def read(self, out: Optional[np.ndarray] = None) -> Optional[np.ndarray]:
        """Next snapshot, or None at the end. ``out``: optional recycled
        destination buffer (the buffer-recycling channel pattern of the
        reference's pipelines, data-to-pics/src/main.rs:80-110) — must
        match the image shape and dtype; decoded directly into it."""
        if self._position >= self.num_images:
            return None
        if out is not None and out.shape == self.image_shape \
                and out.dtype == np.dtype(Precision):
            self._dataset.read_direct(out, source_sel=np.s_[self._position])
        else:
            out = np.asarray(self._dataset[self._position], dtype=Precision)
        self._position += 1
        return out

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            img = self.read()
            if img is None:
                return
            yield img

    def close(self) -> None:
        self._file.close()

    def __enter__(self) -> "Reader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
