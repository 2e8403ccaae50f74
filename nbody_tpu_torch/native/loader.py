"""Build + load the native fastcsv runtime via ctypes.

Counterpart of ``nbody_tpu/native/loader.py``.  The C++ source is this
package's own copy of the JAX package's ``fastcsv.cpp``, beside this file,
compiled with g++ into this package's gitignored ``_build/`` directory keyed
by a hash of the source text.  Any failure (no compiler, read-only build
dir) falls back to the NumPy implementations in ``nbody_tpu_torch.io.csv``
and ``nbody_tpu_torch.io.checkpoint``: this is host I/O, not the device
path.

Set NBODY_TPU_NO_NATIVE=1 to force the pure-Python path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fastcsv.cpp")
_BUILD_DIR = os.path.join(_PKG, "_build")
_LOCK = threading.Lock()
_CACHED: "FastCsv | None" = None
_TRIED = False

_DOUBLE_P = ctypes.POINTER(ctypes.c_double)


class FastCsv:
    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        lib.fastcsv_count_rows.restype = ctypes.c_long
        lib.fastcsv_count_rows.argtypes = [ctypes.c_char_p]
        lib.fastcsv_read7.restype = ctypes.c_long
        lib.fastcsv_read7.argtypes = [ctypes.c_char_p, _DOUBLE_P, ctypes.c_long]
        lib.fastcsv_write_frames.restype = ctypes.c_int
        lib.fastcsv_write_frames.argtypes = [
            ctypes.c_char_p, _DOUBLE_P, _DOUBLE_P, ctypes.c_long, ctypes.c_long,
        ]
        lib.fastcsv_write7.restype = ctypes.c_int
        lib.fastcsv_write7.argtypes = [ctypes.c_char_p, _DOUBLE_P, ctypes.c_long]

    def read_csv7(self, path: str) -> np.ndarray | None:
        """Returns the (N, 7) float64 array, or raises ValueError if the
        file is malformed.  Returns None if the file can't be opened here
        (the caller falls back, which surfaces the right error)."""
        pathb = path.encode()
        n = self._lib.fastcsv_count_rows(pathb)
        if n < 0:
            return None
        if n == 0:
            raise ValueError(f"No bodies found into file '{path}'")
        out = np.empty((n, 7), dtype=np.float64)
        got = self._lib.fastcsv_read7(pathb, out.ctypes.data_as(_DOUBLE_P), n)
        if got == -2:
            raise ValueError(
                f"Error while reading file '{path}': file is not well formed"
            )
        if got < 0:
            return None
        return out[:got]

    def write7(self, path: str, data: np.ndarray) -> bool:
        """Write an (N, 7) float64 array as a checkpoint CSV, each value in
        its shortest exact form; returns False on failure (the caller falls
        back to Python formatting)."""
        data = np.ascontiguousarray(data, dtype=np.float64)
        rc = self._lib.fastcsv_write7(path.encode(), data.ctypes.data_as(_DOUBLE_P),
                                      data.shape[0])
        return rc == 0

    def write_frames(self, path: str, pos: np.ndarray, mass: np.ndarray) -> bool:
        """Append (T, N, 3) float64 frames; returns False on failure (the
        caller falls back to Python formatting)."""
        t, n, _ = pos.shape
        rc = self._lib.fastcsv_write_frames(
            path.encode(), pos.ctypes.data_as(_DOUBLE_P),
            mass.ctypes.data_as(_DOUBLE_P), t, n,
        )
        return rc == 0


def _build() -> "FastCsv | None":
    if os.environ.get("NBODY_TPU_NO_NATIVE"):
        return None
    try:
        with open(_SRC, "rb") as f:
            src = f.read()
    except OSError:
        return None
    tag = hashlib.sha256(src).hexdigest()[:16]
    so_path = os.path.join(_BUILD_DIR, f"fastcsv-{tag}.so")
    if not os.path.exists(so_path):
        tmp = so_path + f".tmp{os.getpid()}"
        try:
            os.makedirs(_BUILD_DIR, exist_ok=True)
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", tmp],
                check=True, capture_output=True, timeout=120,
            )
            os.replace(tmp, so_path)
        except (OSError, subprocess.SubprocessError):
            return None
    try:
        return FastCsv(ctypes.CDLL(so_path))
    except OSError:
        return None


def get() -> "FastCsv | None":
    """The process-wide fastcsv instance, or None if native is unavailable."""
    global _CACHED, _TRIED
    if _TRIED:
        return _CACHED
    with _LOCK:
        if not _TRIED:
            _CACHED = _build()
            _TRIED = True
    return _CACHED
