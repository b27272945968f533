"""ctypes bindings for the native C++ host data path (native/boda_native.cc).

Counterpart of ``boda_tpu/utils/native.py``: threaded jpeg decode, bilinear
resize and the RGBA-batch loader that feeds serving. The source is read where
it is, in ``native/``, and built with ``g++`` at first use into
``build/native/`` at the repo root (git-ignored), under a name carrying the
hash of the source and flags, written to a temporary file and renamed: a
stale library is never loaded and a concurrent process never sees half a file
(as ops/kernels/build.py does for the CUDA kernels). A build or load failure
makes :func:`native_available` false; nothing stands in for the library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_REPO = Path(__file__).resolve().parents[2]
SRC = _REPO / "native" / "boda_native.cc"
BUILD_DIR = _REPO / "build" / "native"
CXX_FLAGS = ["-O2", "-fPIC", "-std=c++17", "-Wall"]   # native/Makefile:3
LD_FLAGS = ["-shared", "-ljpeg", "-lpthread"]          # native/Makefile:4

_lib: Optional[ctypes.CDLL] = None
_tried = False
build_error = ""  # why the library is unavailable, once get_lib() has failed


def lib_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS + LD_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libboda_native_{h.hexdigest()[:16]}.so"


def _build(so: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp), *LD_FLAGS]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"{' '.join(cmd)}: {e}") from e
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{' '.join(cmd)}:\n{r.stdout}{r.stderr}")
    os.replace(tmp, so)


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried, build_error
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        so = lib_path()
        if not so.exists():
            _build(so)
        lib = ctypes.CDLL(str(so))
    except (OSError, RuntimeError) as e:
        build_error = str(e)
        return None
    c_u8p = ctypes.POINTER(ctypes.c_uint8)
    c_f32p = ctypes.POINTER(ctypes.c_float)
    c_f64p = ctypes.POINTER(ctypes.c_double)
    c_i64p = ctypes.POINTER(ctypes.c_int64)
    lib.bn_jpeg_decode.restype = ctypes.c_int
    lib.bn_jpeg_decode.argtypes = [c_u8p, ctypes.c_int64, c_u8p, c_i64p,
                                   c_i64p, ctypes.c_char_p, ctypes.c_int64]
    lib.bn_resize_bilinear_rgba.restype = None
    lib.bn_resize_bilinear_rgba.argtypes = [c_u8p, ctypes.c_int64,
                                            ctypes.c_int64, c_u8p,
                                            ctypes.c_int64, ctypes.c_int64]
    lib.bn_rgba_to_nchw_bgr.restype = None
    lib.bn_rgba_to_nchw_bgr.argtypes = [c_u8p, ctypes.c_int64, ctypes.c_int64,
                                        ctypes.c_int64, c_f32p, ctypes.c_float,
                                        c_f32p]
    lib.bn_f32_stats.restype = None
    lib.bn_f32_stats.argtypes = [c_f32p, ctypes.c_int64, c_f64p]
    lib.bn_loader_create.restype = ctypes.c_void_p
    lib.bn_loader_create.argtypes = [ctypes.POINTER(ctypes.c_char_p),
                                     ctypes.c_int64, ctypes.c_int64,
                                     ctypes.c_int64, ctypes.c_int64,
                                     ctypes.c_int, ctypes.c_int]
    lib.bn_loader_next.restype = ctypes.c_int64
    lib.bn_loader_next.argtypes = [ctypes.c_void_p, c_u8p]
    lib.bn_loader_error.restype = None
    lib.bn_loader_error.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                    ctypes.c_int64]
    lib.bn_loader_destroy.restype = None
    lib.bn_loader_destroy.argtypes = [ctypes.c_void_p]
    _lib = lib
    return _lib


def native_available() -> bool:
    return get_lib() is not None


def why_unavailable() -> str:
    """One line on why the library did not build or load ('' if it did)."""
    if native_available():
        return ""
    lines = build_error.strip().splitlines() or ["?"]
    return next((ln.strip() for ln in lines if "error" in ln), lines[-1].strip())


def _need_lib() -> ctypes.CDLL:
    lib = get_lib()
    if lib is None:
        raise RuntimeError(f"the native library did not build: {build_error}")
    return lib


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def jpeg_decode(data: bytes) -> np.ndarray:
    """Decode JPEG bytes -> (y, x, 4) uint8 RGBA via libjpeg."""
    lib = _need_lib()
    buf = np.frombuffer(data, np.uint8)
    y = ctypes.c_int64()
    x = ctypes.c_int64()
    err = ctypes.create_string_buffer(256)
    rc = lib.bn_jpeg_decode(_u8p(buf), len(data), None,
                            ctypes.byref(y), ctypes.byref(x), err, 256)
    if rc:
        raise ValueError(f"jpeg decode failed: {err.value.decode()}")
    out = np.empty((y.value, x.value, 4), np.uint8)
    rc = lib.bn_jpeg_decode(_u8p(buf), len(data), _u8p(out),
                            ctypes.byref(y), ctypes.byref(x), err, 256)
    if rc:
        raise ValueError(f"jpeg decode failed: {err.value.decode()}")
    return out


def resize_bilinear(rgba: np.ndarray, dy: int, dx: int) -> np.ndarray:
    lib = _need_lib()
    rgba = np.ascontiguousarray(rgba, np.uint8)
    if rgba.ndim != 3 or rgba.shape[2] != 4:
        raise ValueError(f"resize_bilinear: want (y, x, 4) uint8, got {rgba.shape}")
    out = np.empty((dy, dx, 4), np.uint8)
    lib.bn_resize_bilinear_rgba(_u8p(rgba), rgba.shape[0], rgba.shape[1],
                                _u8p(out), dy, dx)
    return out


def rgba_to_nchw_bgr(rgba: np.ndarray, mean_bgr=(104.0, 117.0, 123.0),
                     scale: float = 1.0) -> np.ndarray:
    lib = _need_lib()
    rgba = np.ascontiguousarray(rgba, np.uint8)
    if rgba.ndim != 4 or rgba.shape[3] != 4:
        raise ValueError(f"rgba_to_nchw_bgr: want (n, y, x, 4) uint8, got {rgba.shape}")
    n, y, x = rgba.shape[:3]
    out = np.empty((n, 3, y, x), np.float32)
    mean = np.asarray(mean_bgr, np.float32)
    lib.bn_rgba_to_nchw_bgr(_u8p(rgba), n, y, x,
                            mean.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                            scale,
                            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out


def f32_stats(v: np.ndarray) -> tuple[float, float, float, float]:
    lib = _need_lib()
    v = np.ascontiguousarray(v, np.float32).reshape(-1)
    out = np.zeros(4, np.float64)
    lib.bn_f32_stats(v.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), v.size,
                     out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return tuple(out)


class BatchLoader:
    """Threaded native jpeg->resize->RGBA-batch prefetcher."""

    def __init__(self, paths: list[str], batch: int, y: int, x: int,
                 n_threads: int = 2, loop: bool = False):
        self._lib = _need_lib()
        if n_threads <= 0:
            n_threads = os.cpu_count() or 4
        arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
        self._h = self._lib.bn_loader_create(arr, len(paths), batch, y, x,
                                             n_threads, int(loop))
        self.batch, self.y, self.x = batch, y, x

    def next(self, out: Optional[np.ndarray] = None) -> Optional[tuple[int, np.ndarray]]:
        """The next decoded batch as (batch index, (batch, y, x, 4) uint8), or
        None when the paths are exhausted. ``out``, if given, is the buffer
        to fill (a pinned host tensor's numpy view, say): C-contiguous uint8
        of exactly that shape."""
        shape = (self.batch, self.y, self.x, 4)
        if out is None:
            out = np.empty(shape, np.uint8)
        elif out.shape != shape or out.dtype != np.uint8 or not out.flags.c_contiguous:
            raise ValueError(f"BatchLoader.next: out must be C-contiguous uint8 {shape}, "
                             f"got {out.dtype} {out.shape}")
        bi = self._lib.bn_loader_next(self._h, _u8p(out))
        if bi == -1:
            return None
        if bi == -2:
            err = ctypes.create_string_buffer(256)
            self._lib.bn_loader_error(self._h, err, 256)
            raise RuntimeError(f"batch loader: {err.value.decode()}")
        return int(bi), out

    def close(self) -> None:
        if self._h:
            self._lib.bn_loader_destroy(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
