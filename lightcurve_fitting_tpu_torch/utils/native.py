"""ctypes loader for the native host kernels (utils/native/lcf_native.cpp,
the port's own copy of the JAX package's source).

The shared library is compiled lazily with g++ on first use into the
package's build directory (``kernels/_build/``, ignored by git, where the
CUDA kernels' library lands too); every entry point has a pure-numpy
fallback so the framework works without a toolchain. Use :func:`available`
to check which path is active.
"""

import ctypes
import os
import subprocess
import threading

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG_DIR, "utils", "native", "lcf_native.cpp")
_BUILD_DIR = os.path.join(_PKG_DIR, "kernels", "_build")
_LIB_PATH = os.path.join(_BUILD_DIR, "liblcf_native.so")
_lock = threading.Lock()
_lib = None
_tried = False


def _build():
    """g++ into a file of this process's own, then renamed into place, so
    that processes building at once never load a half-written library."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-o", tmp, _SRC]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, _LIB_PATH)


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            if (not os.path.exists(_LIB_PATH)
                    or os.path.getmtime(_LIB_PATH) < os.path.getmtime(_SRC)):
                _build()
            lib = ctypes.CDLL(_LIB_PATH)
            lib.lcf_binflux.restype = ctypes.c_long
            lib.lcf_binflux.argtypes = [
                ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_long, ctypes.c_double, ctypes.c_int,
                ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_double)]
            lib.lcf_parse_table.restype = ctypes.c_long
            lib.lcf_parse_table.argtypes = [
                ctypes.c_char_p, ctypes.c_long, ctypes.c_long, ctypes.c_long,
                ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_uint8)]
            _lib = lib
        except Exception:
            _lib = None
        return _lib


def available():
    return _load() is not None


def _ptr(a, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


def binflux_native(time, flux, dflux, bad_err, delta, include_zero=True):
    """Native greedy binning. Inputs must be contiguous float64/uint8 arrays.
    Returns (time, flux, dflux) arrays or None if the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    n = len(time)
    time = np.ascontiguousarray(time, np.float64)
    flux = np.ascontiguousarray(flux, np.float64)
    dflux = np.ascontiguousarray(dflux, np.float64)
    bad = np.ascontiguousarray(bad_err, np.uint8)
    ot = np.empty(n)
    of = np.empty(n)
    od = np.empty(n)
    nbins = lib.lcf_binflux(_ptr(time, ctypes.c_double), _ptr(flux, ctypes.c_double),
                            _ptr(dflux, ctypes.c_double), _ptr(bad, ctypes.c_uint8),
                            n, float(delta), int(include_zero),
                            _ptr(ot, ctypes.c_double), _ptr(of, ctypes.c_double),
                            _ptr(od, ctypes.c_double))
    return ot[:nbins].copy(), of[:nbins].copy(), od[:nbins].copy()


def parse_numeric_table(text, n_cols, max_rows):
    """Native whitespace-separated numeric parser. Returns (values, mask,
    n_rows) or None if the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    raw = text.encode() if isinstance(text, str) else text
    out = np.empty((max_rows, n_cols))
    mask = np.zeros((max_rows, n_cols), np.uint8)
    n = lib.lcf_parse_table(raw, len(raw), n_cols, max_rows,
                            _ptr(out, ctypes.c_double), _ptr(mask, ctypes.c_uint8))
    return out[:n], mask[:n].astype(bool), n
