"""All-pairs force through the hand-written CUDA kernel.

Counterpart of ``nbody_tpu/ops/pallas_exhaustive.py``: the wrapper of the
kernel in ``nbody_tpu_torch/csrc/allpairs.cu`` (which replaces the Pallas
``_kernel`` there).  A CPU tensor goes to the plain version,
``rect_accelerations_reference``; a CUDA tensor launches the kernel or
raises.  Nothing falls back.

``cuda_rect_accelerations.launches`` counts kernel launches, so a run can
show that it went through the kernel.
"""

from __future__ import annotations

import torch

from nbody_tpu_torch.core import constants
from nbody_tpu_torch.ops.exhaustive import rect_accelerations

# The plain PyTorch version of the kernel, same arguments, same result
# within the kernel's f32 tolerance.
rect_accelerations_reference = rect_accelerations


_INT_MAX = 2**31 - 1  # the kernels take sizes as C int


def check_tensor(name: str, t: torch.Tensor, shape: tuple, device: torch.device,
                 dtype: torch.dtype = torch.float32):
    """Raise unless `t` is a contiguous `dtype` tensor of `shape` on
    `device` (-1 in `shape` matches any size)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dim() != len(shape) or any(
        want not in (-1, got) for want, got in zip(shape, t.shape)
    ):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.shape and t.shape[0] > _INT_MAX:
        raise ValueError(f"{name}: {t.shape[0]} rows exceed the kernels' C int")


def cuda_rect_accelerations(
    pos_i: torch.Tensor,
    pos_j: torch.Tensor,
    mass_j: torch.Tensor,
    *,
    G: float = constants.BIG_G,
    softening_sq: float = constants.SOFTENING_SQ,
    eps2_i: torch.Tensor | None = None,
    eps2_all: torch.Tensor | None = None,
) -> torch.Tensor:
    """f32 accelerations of pos_i (M, 3) targets against pos_j (N, 3) /
    mass_j (N,) sources.  `eps2_i` (M,) / `eps2_all` (N,) switch on
    symmetric-mean per-body softening and must be given together."""
    if (eps2_i is None) != (eps2_all is None):
        raise ValueError("eps2_i and eps2_all must be given together")
    device = pos_i.device
    m, n = pos_i.shape[0], pos_j.shape[0]
    check_tensor("pos_i", pos_i, (-1, 3), device)
    check_tensor("pos_j", pos_j, (n, 3), device)
    check_tensor("mass_j", mass_j, (n,), device)
    if eps2_i is not None:
        check_tensor("eps2_i", eps2_i, (m,), device)
        check_tensor("eps2_all", eps2_all, (n,), device)
    if device.type == "cpu":
        return rect_accelerations_reference(
            pos_i, pos_j, mass_j, G=G, softening_sq=softening_sq,
            eps2_i=eps2_i, eps2_all=eps2_all,
        )
    if device.type != "cuda":
        raise ValueError(f"no all-pairs kernel for device {device}")

    from nbody_tpu_torch.ops import _cuda

    kernels = _cuda.library()
    gm = G * mass_j  # G folded into the source weights (pallas_exhaustive.py:165)
    out = torch.empty((m, 3), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        err = kernels.lib.nbody_allpairs_f32(
            pos_i.data_ptr(), pos_j.data_ptr(), gm.data_ptr(),
            None if eps2_i is None else eps2_i.data_ptr(),
            None if eps2_all is None else eps2_all.data_ptr(),
            float(softening_sq), m, n, out.data_ptr(),
            _cuda.stream_handle(device),
        )
    kernels.check(err, "allpairs kernel")
    cuda_rect_accelerations.launches += 1
    return out


cuda_rect_accelerations.launches = 0


def cuda_accelerations(
    pos: torch.Tensor,
    mass: torch.Tensor,
    *,
    G: float = constants.BIG_G,
    softening_sq: float = constants.SOFTENING_SQ,
    eps2_per_body: torch.Tensor | None = None,
) -> torch.Tensor:
    """Square all-pairs accelerations (ForceFn signature)."""
    return cuda_rect_accelerations(
        pos, pos, mass, G=G, softening_sq=softening_sq,
        eps2_i=eps2_per_body, eps2_all=eps2_per_body,
    )
