"""Native (C++) runtime core bindings.

The reference implements its runtime in native code (Rust: readback/unpad,
mesh generation, DEM stats, PNG encode). This rebuild keeps the compute
path in JAX/XLA/Pallas and implements two host hot paths, grid meshing
and DEM stats, in C++ (cpp/vfcore.cpp), loaded through ctypes. Every entry point has a pure-NumPy
fallback so the package works even without a C++ toolchain.

Build happens lazily on first import (g++ -O3 -shared), cached next to the
package; set VF_NO_NATIVE=1 to disable.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np

_LIB = None
_TRIED = False


def _build_and_load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("VF_NO_NATIVE"):
        return None
    here = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(os.path.dirname(os.path.dirname(here)), "cpp", "vfcore.cpp")
    if not os.path.exists(src):
        return None
    lib_path = os.path.join(here, "libvfcore.so")
    try:
        if (not os.path.exists(lib_path)
                or os.path.getmtime(lib_path) < os.path.getmtime(src)):
            cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC",
                   "-std=c++17", src, "-o", lib_path]
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        lib = ctypes.CDLL(lib_path)
    except Exception as e:
        detail = getattr(e, "stderr", None)
        if isinstance(detail, bytes):
            detail = detail.decode(errors="replace")
        print(f"vulkan_forge: native core unavailable, using the NumPy "
              f"fallbacks ({type(e).__name__}: {e})"
              + (f"\n{detail.strip()}" if detail else ""), file=sys.stderr)
        return None

    lib.vf_grid_generate.restype = None
    lib.vf_grid_generate.argtypes = [
        ctypes.c_int32, ctypes.c_int32, ctypes.c_float, ctypes.c_float,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_uint32)]
    lib.vf_dem_stats.restype = None
    lib.vf_dem_stats.argtypes = [ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                                 ctypes.POINTER(ctypes.c_float)]
    _LIB = lib
    return lib


def available() -> bool:
    return _build_and_load() is not None


def grid_generate_native(nx: int, nz: int, dx: float, dy: float):
    """(xy, uv, idx) via the C++ core, or None if unavailable."""
    lib = _build_and_load()
    if lib is None:
        return None
    n = nx * nz
    m = (nx - 1) * (nz - 1) * 6
    xy = np.empty((n, 2), dtype=np.float32)
    uv = np.empty((n, 2), dtype=np.float32)
    idx = np.empty((m,), dtype=np.uint32)
    lib.vf_grid_generate(
        nx, nz, np.float32(dx), np.float32(dy),
        xy.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        uv.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
    return xy, uv, idx


def dem_stats_native(heights: np.ndarray):
    """(min, max, mean, std) via the C++ core, or None."""
    lib = _build_and_load()
    if lib is None:
        return None
    h = np.ascontiguousarray(heights, dtype=np.float32).reshape(-1)
    out = np.empty(4, dtype=np.float32)
    lib.vf_dem_stats(h.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                     h.size, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return float(out[0]), float(out[1]), float(out[2]), float(out[3])

