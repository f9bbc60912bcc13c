"""Native host runtime kernels (C, ctypes-bound).

Compiled on first import with the system compiler into a cached shared
object under the package's `_build/` directory (git-ignored).  Import
raises ImportError if no compiler is available; callers fall back to
pure-Python paths.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_DIR = os.path.dirname(__file__)
_SRC = os.path.join(_DIR, "core.c")
_SO = os.path.join(os.path.dirname(_DIR), "_build", "_core.so")


def _build():
    # compile to a private name and rename: processes that import the
    # package at the same time never load a half-written library
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = ["cc", "-O3", "-shared", "-fPIC", "-o", tmp, _SRC]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, _SO)


def _load():
    if (not os.path.exists(_SO)
            or os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
        try:
            _build()
        except (OSError, subprocess.CalledProcessError) as e:
            raise ImportError(f"native build failed: {e}")
    lib = ctypes.CDLL(_SO)
    lib.fnv_fold.restype = ctypes.c_uint64
    lib.fnv_fold.argtypes = [ctypes.POINTER(ctypes.c_uint64),
                             ctypes.c_size_t]
    lib.pack_cps.restype = None
    lib.pack_cps.argtypes = [ctypes.POINTER(ctypes.c_double),
                             ctypes.c_size_t,
                             ctypes.POINTER(ctypes.c_uint32)]
    lib.gen_samples.restype = ctypes.c_uint64
    lib.gen_samples.argtypes = [ctypes.POINTER(ctypes.c_int64),
                                ctypes.POINTER(ctypes.c_int64),
                                ctypes.c_size_t, ctypes.c_int,
                                ctypes.c_uint64,
                                ctypes.POINTER(ctypes.c_double)]
    return lib


_lib = _load()


def fnv_fold(data: np.ndarray) -> int:
    data = np.ascontiguousarray(data, np.uint64)
    return int(_lib.fnv_fold(
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), data.size))


def pack_cps(img: np.ndarray) -> np.ndarray:
    """float RGB [..., 3] (f64) -> packed u32."""
    img = np.ascontiguousarray(img, np.float64)
    n = img.size // 3
    out = np.empty(img.shape[:-1], np.uint32)
    _lib.pack_cps(img.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n,
                  out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
    return out


def gen_samples(sel_x: np.ndarray, sel_y: np.ndarray, samples_per_px: int,
                state: int):
    """Sequential-LCG subpixel positions for selected pixels.
    Returns (positions [N*spp, 2] float64, new_lcg_state)."""
    sel_x = np.ascontiguousarray(sel_x, np.int64)
    sel_y = np.ascontiguousarray(sel_y, np.int64)
    out = np.empty((len(sel_x) * samples_per_px, 2), np.float64)
    new_state = _lib.gen_samples(
        sel_x.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        sel_y.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(sel_x), samples_per_px, np.uint64(state),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return out, int(new_state)
