"""ctypes bindings for the native terrain runtime (terrain_runtime.cpp).

The C++ library implements the residency state machine and the async tile
file loader — the parts the reference writes in Rust (tile_atlas.rs). The
Python implementations in terrain_data/tile_atlas.py remain as the
fallback and as the oracle the native backend is tested against.

The library is never committed: it is built from ``terrain_runtime.cpp``
on first use, and rebuilt when the source is newer (or ahead of time with
``make -C bevy_terrain_tpu/native``).
When the build fails the Python fallbacks run and :func:`build_error`
says why.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_DIR = Path(__file__).resolve().parent
_LIB_PATH = _DIR / "libterrain_runtime.so"
_SRC_PATH = _DIR / "terrain_runtime.cpp"
_lib = None
_build_error: Optional[str] = None


def _stale() -> bool:
    """True when the library is missing or older than its source."""
    return (not _LIB_PATH.exists()
            or _LIB_PATH.stat().st_mtime < _SRC_PATH.stat().st_mtime)


def _build() -> None:
    """Build the library once, safely under concurrent importers (test
    workers): an exclusive lock serializes concurrent builds, and the compiler
    writes a private file that is renamed into place, so no process ever
    opens a half-written library."""
    import fcntl

    with open(_DIR / ".build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not _stale():
            return
        tmp = f"libterrain_runtime.build{os.getpid()}.so"
        try:
            subprocess.run(
                ["make", "-C", str(_DIR), f"TARGET={tmp}", tmp],
                check=True, capture_output=True, text=True, timeout=300,
            )
            os.replace(_DIR / tmp, _LIB_PATH)
        finally:
            (_DIR / tmp).unlink(missing_ok=True)


def build_error() -> Optional[str]:
    """Why the native runtime is unavailable (None when it loaded)."""
    _load()
    return _build_error


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_error
    if _lib is not None or _build_error is not None:
        return _lib
    # BT_DISABLE_NATIVE=1 forces the pure-Python fallbacks everywhere the
    # native runtime is optional (residency, IO pool, scan, Taylor,
    # bilinear taps). Debugging/bisection switch: lets any fault be
    # attributed to (or cleared of) the C++ layer without a rebuild.
    if os.environ.get("BT_DISABLE_NATIVE") == "1":
        _build_error = "disabled by BT_DISABLE_NATIVE=1"
        return None
    if _stale():
        try:
            _build()
        except subprocess.CalledProcessError as exc:
            _build_error = f"build failed: {exc.stderr.strip()[-2000:]}"
            return None
        except Exception as exc:
            _build_error = f"build failed: {exc!r}"
            return None
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
    except OSError as exc:
        _build_error = f"load failed: {exc}"
        return None

    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.tr_residency_create.restype = ctypes.c_void_p
    lib.tr_residency_create.argtypes = [ctypes.c_int32, ctypes.c_int32]
    lib.tr_residency_destroy.argtypes = [ctypes.c_void_p]
    lib.tr_add_existing.argtypes = [ctypes.c_void_p, i64p, ctypes.c_int64]
    lib.tr_clear_existing.argtypes = [ctypes.c_void_p]
    lib.tr_existing_count.restype = ctypes.c_int64
    lib.tr_existing_count.argtypes = [ctypes.c_void_p]
    lib.tr_request.restype = ctypes.c_int32
    lib.tr_request.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.tr_release.restype = ctypes.c_int32
    lib.tr_release.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.tr_release_underflows.restype = ctypes.c_int64
    lib.tr_release_underflows.argtypes = [ctypes.c_void_p]
    lib.tr_loaded.restype = ctypes.c_int32
    lib.tr_loaded.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.tr_get_or_allocate.restype = ctypes.c_int32
    lib.tr_get_or_allocate.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.tr_drain_loads.restype = ctypes.c_int64
    lib.tr_drain_loads.argtypes = [ctypes.c_void_p, i64p, i32p, i32p, ctypes.c_int64]
    lib.tr_best_tiles.argtypes = [
        ctypes.c_void_p, i32p, i32p, i32p, i32p, ctypes.c_int64, i32p, i32p,
    ]
    lib.tr_requests_of.restype = ctypes.c_int32
    lib.tr_requests_of.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.tr_index_of.restype = ctypes.c_int32
    lib.tr_index_of.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.tr_resident_count.restype = ctypes.c_int64
    lib.tr_resident_count.argtypes = [ctypes.c_void_p]
    lib.tr_io_create.restype = ctypes.c_void_p
    lib.tr_io_create.argtypes = [ctypes.c_int32]
    lib.tr_io_destroy.argtypes = [ctypes.c_void_p]
    lib.tr_io_submit.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
    ]
    lib.tr_io_poll.restype = ctypes.c_int64
    lib.tr_io_poll.argtypes = [ctypes.c_void_p, i64p, i64p, ctypes.c_int64]
    f64p = ctypes.POINTER(ctypes.c_double)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.tr_scan_requests.argtypes = [
        ctypes.c_int32, f64p, f64p, f64p, ctypes.c_double, ctypes.c_double,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        i32p, i32p, f64p, i64p, u8p, i64p, i64p, i32p, i32p,
    ]
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.tr_taylor_spherical.argtypes = [
        f64p, f64p, f64p, ctypes.c_double, i32p, f32p, f32p,
    ]
    lib.tr_taylor_from_world.argtypes = [
        f64p, f64p, f64p, ctypes.c_double, i32p, f32p, f32p,
    ]
    lib.tr_project_view_uv.argtypes = [f64p, f64p, f64p]
    lib.tr_view_anchors.argtypes = [
        f64p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        i32p, i32p, f32p,
    ]
    lib.tr_sample_bilinear.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_double, ctypes.c_double, ctypes.c_double, f64p,
    ]
    lib.tr_split_bilinear.argtypes = [
        f32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        f64p, ctypes.c_int64, f64p, ctypes.c_int64, f32p,
    ]
    lib.tr_quantize.argtypes = [
        f32p, ctypes.c_int64, ctypes.c_double, ctypes.c_int32,
        ctypes.c_void_p,
    ]
    lib.tr_downsample.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int32, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p,
    ]
    lib.tr_png_unfilter.restype = ctypes.c_int32
    lib.tr_png_unfilter.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_void_p,
    ]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def _i64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _i32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _f64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def scan_requests(kind: int, m: np.ndarray, inv_m3: np.ndarray,
                  view: np.ndarray, approx_height: float, load_distance: float,
                  origins: np.ndarray, view_int: np.ndarray,
                  view_frac: np.ndarray, tile_xy: np.ndarray,
                  requested: np.ndarray):
    """Native per-frame request scan (terrain_runtime.cpp tr_scan_requests).

    Mutates ``tile_xy`` (S,L,T,T,2 i64, C-contiguous) and ``requested``
    (S,L,T,T u8) in place; returns (released_keys, requested_keys) packed
    int64 arrays. Semantics identical to the numpy scan — fuzz-tested in
    test_native.py.
    """
    lib = _load()
    assert lib is not None
    S, L, T = tile_xy.shape[0], tile_xy.shape[1], tile_xy.shape[2]
    cap = S * L * T * T
    released = np.empty(cap, np.int64)
    requested_keys = np.empty(cap, np.int64)
    n_rel = np.zeros(1, np.int32)
    n_req = np.zeros(1, np.int32)
    lib.tr_scan_requests(
        kind, _f64p(m), _f64p(inv_m3), _f64p(view),
        float(approx_height), float(load_distance),
        S, L, T,
        _i32p(origins), _i32p(view_int), _f64p(view_frac),
        _i64p(tile_xy), requested.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        _i64p(released), _i64p(requested_keys), _i32p(n_rel), _i32p(n_req),
    )
    return released[: n_rel[0]], requested_keys[: n_req[0]]


class NativeResidency:
    """C++ residency state machine (see terrain_runtime.cpp)."""

    def __init__(self, atlas_size: int, attachment_count: int):
        lib = _load()
        if lib is None:
            raise RuntimeError("native terrain runtime not available")
        self._lib = lib
        self._h = lib.tr_residency_create(atlas_size, attachment_count)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.tr_residency_destroy(self._h)
            self._h = None

    def add_existing(self, keys: np.ndarray) -> None:
        keys = np.ascontiguousarray(keys, np.int64)
        self._lib.tr_add_existing(self._h, _i64p(keys), len(keys))

    def clear_existing(self) -> None:
        self._lib.tr_clear_existing(self._h)

    @property
    def existing_count(self) -> int:
        return self._lib.tr_existing_count(self._h)

    def request(self, key: int) -> int:
        result = self._lib.tr_request(self._h, key)
        if result == -3:
            raise RuntimeError("Atlas out of indices")
        return result

    def release(self, key: int) -> None:
        result = self._lib.tr_release(self._h, key)
        if result == -1:
            raise RuntimeError("Tried releasing a tile, which is not present.")
        # -2 == over-release of a cached tile: guarded + counted in C++
        # (release_underflows), mirroring the Python backend

    @property
    def release_underflows(self) -> int:
        return self._lib.tr_release_underflows(self._h)

    def loaded(self, key: int) -> None:
        if self._lib.tr_loaded(self._h, key) != 0:
            raise RuntimeError(
                "Loaded more attachments than registered with the tile atlas."
            )

    def get_or_allocate(self, key: int) -> int:
        result = self._lib.tr_get_or_allocate(self._h, key)
        if result == -3:
            raise RuntimeError("Atlas out of indices")
        return result

    def drain_loads(self, cap: int = 4096):
        keys = np.empty(cap, np.int64)
        indices = np.empty(cap, np.int32)
        attachments = np.empty(cap, np.int32)
        n = self._lib.tr_drain_loads(
            self._h, _i64p(keys), _i32p(indices), _i32p(attachments), cap
        )
        return keys[:n], indices[:n], attachments[:n]

    def best_tiles(self, side, lod, x, y):
        side = np.ascontiguousarray(side, np.int32).ravel()
        lod = np.ascontiguousarray(lod, np.int32).ravel()
        x = np.ascontiguousarray(x, np.int32).ravel()
        y = np.ascontiguousarray(y, np.int32).ravel()
        out_index = np.empty(side.shape, np.int32)
        out_lod = np.empty(side.shape, np.int32)
        self._lib.tr_best_tiles(
            self._h, _i32p(side), _i32p(lod), _i32p(x), _i32p(y),
            len(side), _i32p(out_index), _i32p(out_lod),
        )
        return out_index, out_lod

    def requests_of(self, key: int) -> int:
        return self._lib.tr_requests_of(self._h, key)

    def index_of(self, key: int) -> int:
        return self._lib.tr_index_of(self._h, key)

    @property
    def resident_count(self) -> int:
        return self._lib.tr_resident_count(self._h)


class NativeIoPool:
    """C++ async file reader pool (see terrain_runtime.cpp IoPool)."""

    def __init__(self, threads: int = 8):
        lib = _load()
        if lib is None:
            raise RuntimeError("native terrain runtime not available")
        self._lib = lib
        self._h = lib.tr_io_create(threads)
        self._buffers: dict[int, np.ndarray] = {}
        self._next = 0

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.tr_io_destroy(self._h)
            self._h = None

    def submit(self, path: str, capacity: int) -> int:
        job_id = self._next
        self._next += 1
        buf = np.empty(capacity, np.uint8)
        self._buffers[job_id] = buf
        self._lib.tr_io_submit(
            self._h, job_id, str(path).encode(),
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), capacity,
        )
        return job_id

    def poll(self, cap: int = 256):
        """Returns list of (job_id, bytes_or_None_on_error, buffer)."""
        ids = np.empty(cap, np.int64)
        sizes = np.empty(cap, np.int64)
        n = self._lib.tr_io_poll(self._h, _i64p(ids), _i64p(sizes), cap)
        out = []
        for i in range(n):
            job_id = int(ids[i])
            buf = self._buffers.pop(job_id)
            size = int(sizes[i])
            out.append((job_id, None if size < 0 else size, buf))
        return out


_DTYPE_CODES = {np.dtype(np.uint8): 0, np.dtype(np.uint16): 1,
                np.dtype(np.float32): 2}


def taylor_spherical(uv: np.ndarray, view: np.ndarray, m3x4: np.ndarray,
                     origin_count: float):
    """Native per-view Taylor chain (terrain_runtime.cpp tr_taylor_spherical).

    ``uv`` (6, 2) f64 view uv projected onto every side. Returns
    (origin_xy (6,2) i32, origin_uv (6,2) f32, coeffs (6, 6, 3) f32 ordered
    c, c_s, c_t, c_ss, c_st, c_tt). Twin of the numpy chain in
    math/approximation.py — fuzz-tested in test_native.py.
    """
    lib = _load()
    assert lib is not None
    uv = np.ascontiguousarray(uv, np.float64)
    view = np.ascontiguousarray(view, np.float64)
    m3x4 = np.ascontiguousarray(m3x4, np.float64)
    origin_xy = np.empty((6, 2), np.int32)
    origin_uv = np.empty((6, 2), np.float32)
    coeffs = np.empty((6, 6, 3), np.float32)
    lib.tr_taylor_spherical(
        _f64p(uv), _f64p(view), _f64p(m3x4), float(origin_count),
        _i32p(origin_xy), origin_uv.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        coeffs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return origin_xy, origin_uv, coeffs


def split_bilinear(source: np.ndarray, px: np.ndarray,
                   py: np.ndarray) -> np.ndarray:
    """Threaded separable clamp-to-edge bilinear resize of a (H, W, C)
    f32 source at f64 source positions px (P,) / py (B,) -> (B, P, C)
    f32 (terrain_runtime.cpp tr_split_bilinear). Bit-identical to the
    numpy two-pass path in ops/preprocess.split_mosaic."""
    lib = _load()
    assert lib is not None
    source = np.ascontiguousarray(source, np.float32)
    px = np.ascontiguousarray(px, np.float64)
    py = np.ascontiguousarray(py, np.float64)
    H, W, C = source.shape
    out = np.empty((py.shape[0], px.shape[0], C), np.float32)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.tr_split_bilinear(
        source.ctypes.data_as(f32p), H, W, C,
        _f64p(px), px.shape[0], _f64p(py), py.shape[0],
        out.ctypes.data_as(f32p),
    )
    return out


def quantize(src: np.ndarray, max_value: float, dtype) -> np.ndarray:
    """Quantize a f32 array to u8/u16 exactly like
    ``np.clip(np.rint(src * max_value), 0, max_value).astype(dtype)``
    (f32 multiply, round half-to-even — terrain_runtime.cpp tr_quantize)."""
    lib = _load()
    assert lib is not None
    src = np.ascontiguousarray(src, np.float32)
    dtype = np.dtype(dtype)
    out = np.empty(src.shape, dtype)
    lib.tr_quantize(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), src.size,
        float(max_value), _DTYPE_CODES[dtype], out.ctypes.data,
    )
    return out


def downsample(children, texture_size: int, border_size: int,
               dtype, channels: int) -> np.ndarray:
    """Native twin of ops/preprocess.downsample_tile (f64-accumulated
    nodata-masked 2x2 child average; terrain_runtime.cpp tr_downsample)."""
    lib = _load()
    assert lib is not None
    dtype = np.dtype(dtype)
    kept = [
        np.ascontiguousarray(c, dtype) if c is not None else None
        for c in children
    ]
    out = np.empty((texture_size, texture_size, channels), dtype)
    lib.tr_downsample(
        *(c.ctypes.data if c is not None else None for c in kept),
        _DTYPE_CODES[dtype], texture_size, border_size, channels,
        out.ctypes.data,
    )
    return out


def sample_bilinear(data: np.ndarray, uv, max_value: float) -> np.ndarray:
    """Native single-point bilinear tap (terrain_runtime.cpp
    tr_sample_bilinear); twin of attachment.sample_bilinear_host for one uv.
    ``data`` (size, size, C) C-contiguous u8/u16/f32. Returns (4,) f64."""
    lib = _load()
    assert lib is not None
    code = _DTYPE_CODES[data.dtype]
    out = np.empty(4, np.float64)
    lib.tr_sample_bilinear(
        data.ctypes.data, data.shape[0], data.shape[2], code,
        float(max_value), float(uv[0]), float(uv[1]), _f64p(out),
    )
    return out


def taylor_from_world(view: np.ndarray, m3x4: np.ndarray, lm3x4: np.ndarray,
                      origin_count: float):
    """Full native Taylor entry for TRUE spheres (tr_taylor_from_world):
    world view position -> face pick + warp + 6-side projection + chain.
    ``lm3x4`` = local_from_world (3, 4) f64. Same returns as
    :func:`taylor_spherical`."""
    lib = _load()
    assert lib is not None
    view = np.ascontiguousarray(view, np.float64)
    m3x4 = np.ascontiguousarray(m3x4, np.float64)
    lm3x4 = np.ascontiguousarray(lm3x4, np.float64)
    origin_xy = np.empty((6, 2), np.int32)
    origin_uv = np.empty((6, 2), np.float32)
    coeffs = np.empty((6, 6, 3), np.float32)
    lib.tr_taylor_from_world(
        _f64p(view), _f64p(m3x4), _f64p(lm3x4), float(origin_count),
        _i32p(origin_xy), origin_uv.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        coeffs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return origin_xy, origin_uv, coeffs


def project_view_uv(view: np.ndarray, lm3x4: np.ndarray) -> np.ndarray:
    """Native spherical view-uv projection onto all 6 faces
    (tr_project_view_uv). ``lm3x4`` = local_from_world (3, 4) f64.
    Returns (6, 2) f64."""
    lib = _load()
    assert lib is not None
    view = np.ascontiguousarray(view, np.float64)
    lm3x4 = np.ascontiguousarray(lm3x4, np.float64)
    uv6 = np.empty((6, 2), np.float64)
    lib.tr_project_view_uv(_f64p(view), _f64p(lm3x4), _f64p(uv6))
    return uv6


def view_anchors(side_uv: np.ndarray, L: int, T: int,
                 origins: np.ndarray, view_int: np.ndarray,
                 view_frac: np.ndarray) -> None:
    """Native per-(side, lod) tree anchors (tr_view_anchors); writes into
    the preallocated (S, L, 2) outputs in place. Twin of
    ops/tile_tree.py::compute_view_anchors' vector math."""
    lib = _load()
    assert lib is not None
    S = origins.shape[0]
    lib.tr_view_anchors(
        _f64p(side_uv), S, int(L), int(T),
        _i32p(origins), _i32p(view_int),
        view_frac.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )


def png_unfilter(data: np.ndarray, rows: int, stride: int, bpp: int) -> np.ndarray:
    """Native PNG scanline reconstruction (terrain_runtime.cpp
    tr_png_unfilter): ``data`` is the decompressed IDAT stream of ``rows``
    filtered scanlines; returns the (rows, stride) uint8 raw bytes."""
    lib = _load()
    assert lib is not None
    data = np.ascontiguousarray(data, np.uint8)
    if data.size != rows * (stride + 1) or bpp < 1:
        raise ValueError("PNG: image data does not match the header")
    out = np.empty((rows, stride), np.uint8)
    if lib.tr_png_unfilter(data.ctypes.data, rows, stride, bpp,
                           out.ctypes.data) != 0:
        raise ValueError("PNG: unknown scanline filter type")
    return out
