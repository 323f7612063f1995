"""ctypes bindings for the native C++ runtime components (heat-bath
generator + fast reference-format I/O), with build-on-demand and pure
NumPy/Python fallbacks when no C++ toolchain is available.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                           "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libmgnative.so")
_lock = threading.Lock()
_lib = None
_build_failed = False


_SOURCES = [os.path.join(_NATIVE_DIR, f)
            for f in ("heatbath.cpp", "refio.cpp", "Makefile")]


def _stale() -> bool:
    """True when the library is missing or older than any of its sources,
    so a library built elsewhere or from older sources is never loaded."""
    if not os.path.exists(_LIB_PATH):
        return True
    built = os.path.getmtime(_LIB_PATH)
    return any(os.path.getmtime(f) > built for f in _SOURCES)


def _build() -> bool:
    # build under a private name, then rename: concurrent processes
    # (e.g. test workers) never load a half-written library
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    try:
        subprocess.run(["make", "-B", "-C", _NATIVE_DIR, f"OUT={tmp}"],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, _LIB_PATH)
    except (OSError, subprocess.SubprocessError):
        return False
    return True


def get_lib():
    """Load the native library, rebuilding it first when it is missing or
    older than its sources; None if it cannot be built."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        if _stale() and not _build():
            _build_failed = True
            return None
        lib = ctypes.CDLL(_LIB_PATH)
        lib.mgn_heatbath_run.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_double,
            ctypes.c_int, ctypes.c_uint64]
        lib.mgn_mean_plaquette.restype = ctypes.c_double
        lib.mgn_mean_plaquette.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int]
        lib.mgn_read_complex_text.restype = ctypes.c_long
        lib.mgn_read_complex_text.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_double), ctypes.c_long]
        lib.mgn_write_complex_text.restype = ctypes.c_int
        lib.mgn_write_complex_text.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_double), ctypes.c_long]
        lib.mgn_read_phase_text.restype = ctypes.c_long
        lib.mgn_read_phase_text.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_double), ctypes.c_long]
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def _dptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def heatbath_run(theta: np.ndarray, beta: float, sweeps: int,
                 seed: int) -> np.ndarray:
    """Native in-place heat-bath sweeps on phases theta[2, L, L]."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    th = np.ascontiguousarray(theta, dtype=np.float64)
    L = th.shape[-1]
    lib.mgn_heatbath_run(_dptr(th), L, float(beta), int(sweeps),
                           int(seed) & (2 ** 64 - 1))
    return th


def mean_plaquette(theta: np.ndarray) -> float:
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    th = np.ascontiguousarray(theta, dtype=np.float64)
    return float(lib.mgn_mean_plaquette(_dptr(th), th.shape[-1]))


def read_complex_text(path: str, max_vals: int) -> np.ndarray:
    """Returns a complex128 array of up to max_vals parsed values."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    buf = np.empty(2 * max_vals, dtype=np.float64)
    k = lib.mgn_read_complex_text(path.encode(), _dptr(buf), max_vals)
    if k < 0:
        raise FileNotFoundError(path)
    pairs = buf[:2 * k].reshape(-1, 2)
    return pairs[:, 0] + 1j * pairs[:, 1]


def write_complex_text(path: str, vals: np.ndarray):
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    v = np.ascontiguousarray(vals, dtype=np.complex128)
    inter = np.empty(2 * v.size, dtype=np.float64)
    inter[0::2] = v.real.ravel()
    inter[1::2] = v.imag.ravel()
    rc = lib.mgn_write_complex_text(path.encode(), _dptr(inter), v.size)
    if rc != 0:
        raise IOError(f"cannot write {path}")


def read_phase_text(path: str, max_vals: int) -> np.ndarray:
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    buf = np.empty(max_vals, dtype=np.float64)
    k = lib.mgn_read_phase_text(path.encode(), _dptr(buf), max_vals)
    if k < 0:
        raise FileNotFoundError(path)
    return buf[:k]
