"""Build and bind the hand-written CUDA kernels (nvcc + ctypes).

Every ``nbody_tpu_torch/csrc/*.cu`` file is compiled for ``sm_90a`` by
its own ``nvcc`` process, all started together, and the objects are linked
into one shared library with a plain C interface, written to
``nbody_tpu_torch/_build/`` under a name keyed by a hash of the sources
and flags, at first use (never at import).  The library is loaded with
ctypes: every pointer and the stream are ``c_void_p``, ints are ``c_int``,
scalars ``c_float`` or ``c_double`` as the kernel takes them.

Unlike the fastcsv loader nothing here falls back: a missing ``nvcc``, a
compile error, a load error, or a non-zero ``cudaError_t`` returned by a
launcher raises ``CudaKernelError``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

_LOCK = threading.Lock()
_LIB: "Kernels | None" = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_D = ctypes.c_double


class CudaKernelError(RuntimeError):
    """A kernel could not be built, loaded or launched."""


def sources() -> list[str]:
    return sorted(
        os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR) if f.endswith(".cu")
    )


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise CudaKernelError(
        "nvcc not found on PATH or in /usr/local/cuda/bin: the CUDA kernels "
        "cannot be built"
    )


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of the kernel library's entry points."""
    for name in ("nbody_allpairs_f32", "nbody_allpairs_mma_f32"):
        fn = getattr(lib, name)
        fn.restype = _I
        fn.argtypes = [_P, _P, _P, _P, _P, _F, _I, _I, _P, _P]
    lib.nbody_potential_partials.restype = _I
    lib.nbody_potential_partials.argtypes = [_I]
    lib.nbody_potential_f32.restype = _I
    lib.nbody_potential_f32.argtypes = [_P, _P, _I, _P, _P, _P]
    lib.nbody_allpairs_f64.restype = _I
    lib.nbody_allpairs_f64.argtypes = [_P, _P, _P, _D, _I, _I, _P, _P]
    lib.nbody_potential_f64_partials.restype = _I
    lib.nbody_potential_f64_partials.argtypes = [_I]
    lib.nbody_potential_f64.restype = _I
    lib.nbody_potential_f64.argtypes = [_P, _P, _I, _P, _P, _P]
    lib.nbody_bh_fused_smem_bytes.restype = _I
    lib.nbody_bh_fused_smem_bytes.argtypes = [_I, _I, _I]
    # the f32 entries take the slot order after gcount; the cut entries
    # take the cut last
    for name, eps2, order, extra in (
            ("nbody_bh_fused_f32", _F, [_P], []), ("nbody_bh_fused_f64", _D, [], []),
            ("nbody_bh_fused_f32_cut", _F, [_P], [_I]),
            ("nbody_bh_fused_f64_cut", _D, [], [_I])):
        fn = getattr(lib, name)
        fn.restype = _I
        fn.argtypes = [
            _P, _P, _P, _P, _P, _P, _P, _P, *order, _I, _P, _P,
            _F, eps2, _I, _I, _I, _I, _P, _P, _P, *extra,
        ]
    for name, eps2 in (("nbody_group_lists_f32", _F), ("nbody_group_lists_f64", _D)):
        fn = getattr(lib, name)
        fn.restype = _I
        fn.argtypes = [_P, _P, _P, _I, _I, _I, eps2, _P, _P]
    lib.nbody_cuda_error_string.restype = ctypes.c_char_p
    lib.nbody_cuda_error_string.argtypes = [_I]
    return lib


class Kernels:
    """The loaded kernel library and how it was obtained."""

    def __init__(self, path: str, build_seconds: float, build_log: str):
        self.path = path
        self.build_seconds = build_seconds  # 0.0 when the .so was cached
        self.build_log = build_log
        try:
            lib = ctypes.CDLL(path)
        except OSError as e:
            raise CudaKernelError(f"cannot load {path}: {e}") from e
        bind(lib)
        self.lib = lib

    def check(self, err: int, what: str) -> None:
        """Raise if a launcher returned a non-zero cudaError_t."""
        if err != 0:
            msg = self.lib.nbody_cuda_error_string(err).decode()
            raise CudaKernelError(f"{what}: CUDA error {err} ({msg})")


def _build() -> Kernels:
    srcs = sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for path in srcs:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    so_path = os.path.join(BUILD_DIR, f"kernels-{h.hexdigest()[:16]}.so")
    if os.path.exists(so_path):
        return Kernels(so_path, 0.0, "")
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so_path}.tmp{os.getpid()}"
    objs = [f"{tmp}.{os.path.basename(src)}.o" for src in srcs]
    t0 = time.perf_counter()
    procs: list[subprocess.Popen] = []
    try:
        procs += [
            subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True)
            for src, obj in zip(srcs, objs)
        ]
        logs, failed = [], []
        for src, proc in zip(srcs, procs):
            out, _ = proc.communicate(timeout=900)
            logs.append(out)
            if proc.returncode != 0:
                failed.append(f"{os.path.basename(src)} (exit {proc.returncode})")
        log = "".join(logs)
        if failed:
            raise CudaKernelError(f"nvcc failed on {', '.join(failed)}:\n{log}")
        link = subprocess.run([nvcc, *LINK_FLAGS, "-o", tmp, *objs],
                              capture_output=True, text=True, timeout=900)
        log += link.stdout + link.stderr
        if link.returncode != 0:
            raise CudaKernelError(f"nvcc link failed (exit {link.returncode}):\n{log}")
        os.replace(tmp, so_path)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for path in (tmp, *objs):
            if os.path.exists(path):
                os.remove(path)
    return Kernels(so_path, time.perf_counter() - t0, log)


def library() -> Kernels:
    """The process-wide kernel library, built on first use."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = _build()
        return _LIB


def stream_handle(device) -> int:
    """The raw cudaStream_t of PyTorch's current stream on `device`."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream
