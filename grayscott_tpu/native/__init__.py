"""Native (C++) host-pipeline components, loaded via ctypes.

The reference's host-side hot paths are native Rust (rayon colorize split,
data-to-pics/src/main.rs:126-144). Here the equivalent lives in C++
(colorize.cpp), compiled on first use with the toolchain baked into the
image and cached next to the source. Everything degrades gracefully to the
NumPy implementations when no compiler is available.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRCS = [
    os.path.join(_DIR, "colorize.cpp"),
    os.path.join(_DIR, "refstep.cpp"),
]
_LIB_PATH = os.path.join(_DIR, "_gs_native.so")

_lock = threading.Lock()
_lib = None
_tried = False
_png_scratch = threading.local()


def _build() -> bool:
    # compile to a temp name and rename over: atomic, and the fresh inode
    # guarantees a later CDLL really loads the new image (dlopen caches
    # the old mapping by inode when a stale library was bound first).
    # The temp name is per process: processes that build at once (test
    # workers on a fresh checkout) each finish their own file, and the
    # last rename wins
    tmp = f"{_LIB_PATH}.{os.getpid()}.build"
    try:
        # -ffp-contract=off: refstep.cpp's transcription contract — no FMA
        # fusion, every written f32 operation rounds exactly once (rustc's
        # default for the reference's expression trees)
        subprocess.run(
            ["g++", "-O3", "-ffp-contract=off", "-shared", "-fPIC",
             "-std=c++17", "-pthread", *_SRCS, "-o", tmp, "-lz"],
            check=True,
            capture_output=True,
            timeout=120,
        )
        os.replace(tmp, _LIB_PATH)
        return True
    except (OSError, subprocess.SubprocessError):
        if os.path.exists(tmp):
            os.unlink(tmp)
        return False


def _bind(path):
    """CDLL + symbol binding; raises on a stale/incompatible library.

    On failure the handle is dlclose'd: dlopen returns the cached mapping
    for an already-loaded pathname, so a leaked stale handle would make
    every post-rebuild CDLL of the same path return the old image."""
    lib = ctypes.CDLL(path)
    try:
        return _bind_symbols(lib)
    except (OSError, AttributeError):
        import _ctypes

        try:
            _ctypes.dlclose(lib._handle)
        except OSError:
            pass
        raise


def _bind_symbols(lib):
    # ABI gate FIRST: binding a symbol absent from a stale library
    # raises AttributeError, so the version check must not hide
    # behind the newer symbols it is meant to protect
    lib.gs_native_abi_version.restype = ctypes.c_int
    if lib.gs_native_abi_version() != 4:
        raise OSError("gs_native ABI version mismatch")
    lib.gs_colorize.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_float,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
    ]
    lib.gs_colorize.restype = None
    lib.gs_png_bound.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.gs_png_bound.restype = ctypes.c_size_t
    lib.gs_png_encode.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,
    ]
    lib.gs_png_encode.restype = ctypes.c_size_t
    fp = ctypes.POINTER(ctypes.c_float)
    lib.gs_ref_steps.argtypes = [
        fp, fp, ctypes.c_int, ctypes.c_int, fp,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_float, ctypes.c_int, ctypes.c_int,
    ]
    lib.gs_ref_steps.restype = ctypes.c_int
    lib.gs_ref_ftz.argtypes = [ctypes.c_int]
    lib.gs_ref_ftz.restype = ctypes.c_int
    return lib


def load():
    """The native library handle, building it on first use; None if
    unavailable (callers fall back to NumPy/PIL)."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        fresh = os.path.exists(_LIB_PATH) and os.path.getmtime(
            _LIB_PATH
        ) >= max(os.path.getmtime(s) for s in _SRCS)
        if not fresh and not _build():
            return None
        try:
            _lib = _bind(_LIB_PATH)
        except (OSError, AttributeError):
            # a stale-but-newer-mtime library (e.g. a committed binary
            # restored by git checkout) fails the ABI/symbol gate even
            # though the toolchain could produce a good one — rebuild
            # once from source before giving up
            _lib = None
            if _build():
                try:
                    _lib = _bind(_LIB_PATH)
                except (OSError, AttributeError):
                    _lib = None
        return _lib


#: Default PNG compression: the fast Z_RLE path (levels <= 3 in the C++
#: encoder) — the analog of the fdeflate fast encoder behind the
#: reference's `image`-crate PNG writer (data-to-pics/src/main.rs:98-104).
#: On smooth INFERNO fields it is ~5x faster than deflate level 6 and
#: smaller than plain level 1/2 output. Pass 4-9 for archival deflate.
PNG_LEVEL_DEFAULT = 2


def png_encode(rgb: np.ndarray, level: int = PNG_LEVEL_DEFAULT) -> bytes | None:
    """Encode an (H, W, 3) uint8 image as a PNG byte stream natively
    (zlib + Sub row filter, the analog of the reference's `image` crate
    writer on its output threads, data-to-pics/src/main.rs:98-104).
    ``level``: 1-3 = fast RLE strategy (the default, see
    PNG_LEVEL_DEFAULT), 4-9 = standard deflate at that level. Returns
    None if the native library is unavailable (callers fall back to PIL).
    Releases the GIL for the whole encode, so the data-to-pics output
    threads scale."""
    lib = load()
    if lib is None:
        return None
    img = np.ascontiguousarray(rgb, dtype=np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) uint8, got {img.shape}")
    h, w = img.shape[:2]
    cap = int(lib.gs_png_bound(w, h))
    # recycled per-thread scratch (the encoder runs on N writer threads)
    out = getattr(_png_scratch, "buf", None)
    if out is None or out.size < cap:
        out = np.empty(cap, dtype=np.uint8)
        _png_scratch.buf = out
    n = lib.gs_png_encode(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int(w), ctypes.c_int(h), ctypes.c_int(level),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_size_t(cap),
    )
    if n == 0:
        return None
    return out[:n].tobytes()


def colorize(values: np.ndarray, lut: np.ndarray, scale: float,
             num_threads: int | None = None,
             out: np.ndarray | None = None) -> np.ndarray | None:
    """Native colorize; returns None if the library is unavailable.
    ``out``: optional recycled destination (shape + (3,), uint8,
    C-contiguous) — the buffer-recycling channel pattern of the
    reference's pipelines (data-to-pics/src/main.rs:80-110)."""
    lib = load()
    if lib is None:
        return None
    v = np.ascontiguousarray(values, dtype=np.float32)
    lut8 = np.ascontiguousarray(lut, dtype=np.uint8)
    if out is None or out.shape != v.shape + (3,) or out.dtype != np.uint8 \
            or not out.flags.c_contiguous:
        out = np.empty(v.shape + (3,), dtype=np.uint8)
    if num_threads is None:
        num_threads = min(os.cpu_count() or 1, 8)
    lib.gs_colorize(
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_size_t(v.size),
        lut8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_float(scale),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int(num_threads),
    )
    return out


_REF_BOUNDARY = {"naive": 0, "zero": 1}


def ref_steps(u: np.ndarray, v: np.ndarray, weights, du_rate: float,
              dv_rate: float, feed: float, kill: float, dt: float,
              steps: int, boundary: str = "naive"):
    """Advance (u, v) by ``steps`` Gray-Scott steps with the compiled
    transcription of the reference kernels (refstep.cpp) — the third,
    independent implementation used to cross-check the NumPy oracle
    (grayscott_tpu/oracle.py). Returns (u', v') as fresh float32 arrays,
    or None if the native library is unavailable."""
    lib = load()
    if lib is None:
        return None
    uu = np.array(u, dtype=np.float32, order="C", copy=True)
    vv = np.array(v, dtype=np.float32, order="C", copy=True)
    if uu.ndim != 2 or uu.shape != vv.shape:
        raise ValueError(f"expected matching 2-D grids, got "
                         f"{uu.shape} vs {vv.shape}")
    w9 = np.ascontiguousarray(weights, dtype=np.float32)
    if w9.size != 9:
        raise ValueError(f"expected a 3x3 stencil, got shape {w9.shape}")
    fp = ctypes.POINTER(ctypes.c_float)
    rc = lib.gs_ref_steps(
        uu.ctypes.data_as(fp), vv.ctypes.data_as(fp),
        ctypes.c_int(uu.shape[0]), ctypes.c_int(uu.shape[1]),
        w9.ctypes.data_as(fp),
        ctypes.c_float(du_rate), ctypes.c_float(dv_rate),
        ctypes.c_float(feed), ctypes.c_float(kill), ctypes.c_float(dt),
        ctypes.c_int(steps), ctypes.c_int(_REF_BOUNDARY[boundary]),
    )
    if rc != 0:
        raise ValueError(f"gs_ref_steps rejected its arguments (rc={rc})")
    return uu, vv


def ref_ftz(enable: bool) -> int:
    """Set/clear SSE flush-to-zero + denormals-are-zero (the reference's
    DenormalsFlusher, compute/shared/src/lib.rs:123-213). Returns the
    previous FTZ state (0/1), or -1 when unsupported/unavailable."""
    lib = load()
    if lib is None:
        return -1
    return int(lib.gs_ref_ftz(1 if enable else 0))
