"""Native (C++) runtime components, loaded via ctypes.

The compute path is JAX on the device; the host runtime around it (artifact
serialization here) is C++ — the analog of the reference's native layer
(whose only native code is its CUDA kernels, SURVEY.md section 2.1).

The shared library is compiled on first use with g++ (cached next to the
source); every entry point has a pure-Python fallback so the package works
even without a toolchain.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "csvio.cpp")
_LIB = os.path.join(_HERE, "libgrtcsv.so")
_lock = threading.Lock()
_lib = None
_build_failed = False


def _build() -> bool:
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-o", _LIB, _SRC]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        return True
    except Exception:
        return False


def load():
    """The loaded CDLL, building it if needed; None if unavailable."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        if not os.path.exists(_LIB) or (
                os.path.getmtime(_LIB) < os.path.getmtime(_SRC)):
            if not _build():
                _build_failed = True
                return None
        try:
            lib = ctypes.CDLL(_LIB)
        except OSError:
            # A stale/foreign-arch .so (e.g. restored by a checkout with a
            # fresh mtime) fails to dlopen; rebuild from source once and
            # retry before giving up.
            if not _build():
                _build_failed = True
                return None
            try:
                lib = ctypes.CDLL(_LIB)
            except OSError:
                _build_failed = True
                return None
        lib.grt_write_photon_csv.restype = ctypes.c_int
        lib.grt_write_photon_csv.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double)]
        lib.grt_write_sampled_csv.restype = ctypes.c_int
        lib.grt_write_sampled_csv.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double)]
        _lib = lib
        return _lib


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def write_photon_csv(path, h, w, final_r, final_th, final_ph, cls, heading,
                     p0, alpha0) -> bool:
    """Native photon_data.csv writer. Returns False if native path is
    unavailable (caller falls back to the numpy writer)."""
    import numpy as np
    lib = load()
    if lib is None:
        return False
    f64 = lambda a: np.ascontiguousarray(a, dtype=np.float64)
    cls32 = np.ascontiguousarray(cls, dtype=np.int32)
    rc = lib.grt_write_photon_csv(
        path.encode(), h, w,
        _ptr(f64(final_r), ctypes.c_double),
        _ptr(f64(final_th), ctypes.c_double),
        _ptr(f64(final_ph), ctypes.c_double),
        _ptr(cls32, ctypes.c_int32),
        _ptr(f64(heading), ctypes.c_double),
        _ptr(f64(p0), ctypes.c_double),
        _ptr(f64(alpha0), ctypes.c_double))
    return rc == 0


def write_sampled_csv(path, xyz, heading) -> bool:
    """Native sampled_rays.csv writer. xyz: (n_rays, n_pts, 3)."""
    import numpy as np
    lib = load()
    if lib is None:
        return False
    xyz = np.ascontiguousarray(xyz, dtype=np.float64)
    heading = np.ascontiguousarray(heading, dtype=np.float64)
    rc = lib.grt_write_sampled_csv(
        path.encode(), xyz.shape[0], xyz.shape[1],
        _ptr(xyz, ctypes.c_double), _ptr(heading, ctypes.c_double))
    return rc == 0
