"""Native host-side ingest kernels (fused copy+validate) via ctypes.

hostops.cpp is compiled once with g++ into a cached shared library (same
source-hash-keyed cache as storage/lz4.py). Everything here is optional:
callers fall back to the numpy implementations in engine/memtable.py when
the toolchain is unavailable, so correctness never depends on g++.

ctypes releases the GIL for the call, so multi-core hosts can drive
copy_validate_range from a thread pool over disjoint row ranges.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile
import threading
from typing import Optional

import numpy as np

logger = logging.getLogger("vecgo")

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "hostops.cpp")
_lock = threading.Lock()
_lib = None
_tried = False


def _build_and_load() -> Optional[ctypes.CDLL]:
    try:
        with open(_SRC, "rb") as f:
            src = f.read()
    except OSError:
        return None
    tag = hashlib.sha256(src).hexdigest()[:16]
    cache_dir = os.environ.get(
        "VECGO_NATIVE_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache", "vecgo_native"),
    )
    so_path = os.path.join(cache_dir, f"libvghostops-{tag}.so")
    if not os.path.exists(so_path):
        try:
            os.makedirs(cache_dir, exist_ok=True)
            with tempfile.TemporaryDirectory(dir=cache_dir) as td:
                tmp_so = os.path.join(td, "libvghostops.so")
                subprocess.run(
                    ["g++", "-O3", "-march=native", "-shared", "-fPIC",
                     _SRC, "-o", tmp_so],
                    check=True, capture_output=True, timeout=120,
                )
                os.replace(tmp_so, so_path)  # atomic publish
        except Exception as e:  # noqa: BLE001 — toolchain optional
            logger.warning("hostops native build failed (%s); falling back", e)
            return None
    try:
        lib = ctypes.CDLL(so_path)
        lib.vg_copy_validate_f32.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ]
        lib.vg_copy_validate_f32.restype = ctypes.c_int
        lib.vg_validate_f32.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.vg_validate_f32.restype = ctypes.c_int
        lib.vg_fill_arange_i64.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ]
        lib.vg_fill_arange_i64.restype = None
        return lib
    except OSError as e:
        logger.warning("hostops native load failed (%s); falling back", e)
        return None


def _get() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is None and not _tried:
        with _lock:
            if _lib is None and not _tried:
                _lib = _build_and_load()
                _tried = True
    return _lib


def available() -> bool:
    return _get() is not None


def copy_validate_range(x: np.ndarray, out: np.ndarray, a: int, b: int) -> bool:
    """Copy rows [a, b) of contiguous f32 `x` into `out`, returning False on
    any NaN/Inf. Raises RuntimeError if the native library is unavailable."""
    lib = _get()
    if lib is None:
        raise RuntimeError("hostops native library unavailable")
    n = (b - a) * x.shape[1]
    if n <= 0:
        return True
    return bool(
        lib.vg_copy_validate_f32(
            x.ctypes.data + a * x.strides[0],
            out.ctypes.data + a * out.strides[0],
            n,
        )
    )


def validate_range(x: np.ndarray, a: int, b: int) -> bool:
    """Finiteness-check rows [a, b) of contiguous f32 `x` (no copy)."""
    lib = _get()
    if lib is None:
        raise RuntimeError("hostops native library unavailable")
    n = (b - a) * x.shape[1]
    if n <= 0:
        return True
    return bool(lib.vg_validate_f32(x.ctypes.data + a * x.strides[0], n))
