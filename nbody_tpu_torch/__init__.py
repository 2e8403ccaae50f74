"""nbody_tpu_torch — the PyTorch/CUDA port of nbody_tpu.

A second package beside the JAX one (``nbody_tpu``, which stays the
reference).  Plain tensor code is PyTorch; every TPU kernel on a ported
path is a hand-written CUDA kernel for Hopper (``csrc/*.cu``, built with
nvcc at first use and bound with ctypes).  Each module names its JAX
counterpart in its docstring.

Ported so far: the default all-pairs CLI run (``--algo exhaustive``), with
the force kernel and the potential-energy kernel
(``ops/cuda_exhaustive.py``); the fused Barnes-Hut run (``--algo
barnes-hut``, or ``auto`` above 32,768 bodies), with the
traverse-and-evaluate kernel (``ops/bh_fused.py``); the list-based
Barnes-Hut run (``--bh-traversal flat|padded``, and ``auto`` with
``--backend torch``), with the group x interaction-list kernel
(``ops/barneshut.py``, ``ops/cuda_lists.py``); ``--dtype f64`` for all
of them, through native fp64 kernels; the tensor-core all-pairs kernel
(``cuda_accelerations(use_mxu=True)``); and the exact outlier hybrid of
the fused run (``--bh-robust``, ``ops/bh_fused.py``) with its depth
pricer (``ops/bh_autold.py``); the persistent Morton layout
(``ops/bh_persistent.py``); and the run options: checkpoints
(``io/checkpoint.py``), adaptive dt (``integrate/adaptive.py``),
inelastic merging (``ops/collisions.py``) and block time-step tiers.

The names below are re-exported lazily: importing the package imports
neither jax nor triton and builds no kernel.
"""

import importlib

__version__ = "0.1.0"

_EXPORTS = {
    "Bodies": "nbody_tpu_torch.core.types",
    "SimConfig": "nbody_tpu_torch.core.types",
    "read_bodies": "nbody_tpu_torch.io.csv",
    "write_frames": "nbody_tpu_torch.io.csv",
    "exhaustive_accelerations": "nbody_tpu_torch.ops.exhaustive",
    "cuda_accelerations": "nbody_tpu_torch.ops.cuda_exhaustive",
    "barneshut_fused": "nbody_tpu_torch.ops.bh_fused",
    "barneshut_fused_robust": "nbody_tpu_torch.ops.bh_fused",
    "barneshut_accelerations": "nbody_tpu_torch.ops.barneshut",
    "leapfrog_steps": "nbody_tpu_torch.integrate.leapfrog",
    "simulate": "nbody_tpu_torch.integrate.leapfrog",
    "get_energy": "nbody_tpu_torch.diag.energy",
    "cuda_potential_energy": "nbody_tpu_torch.ops.cuda_exhaustive",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module 'nbody_tpu_torch' has no attribute {name!r}")
