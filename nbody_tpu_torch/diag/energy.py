"""Energy oracle — counterpart of ``nbody_tpu/diag/energy.py``.

Matches common/get_energy.c:7-47:

* KE = 0.5 * sum_i m_i |v_i|^2                          (:9-21)
* PE = G * sum_{i<=j} -m_i m_j / |p_i - p_j|            (:23-46)
  with 1/r guarded to 0 at r == 0 (:40), so the diagonal contributes
  nothing.  PE uses the unsoftened distance although the force softens;
  that asymmetry is part of the reference contract.

Energy drift |E(t) - E(0)| / |E(0)| is the north-star correctness metric
(drift within 1e-3 of the serial reference).

* ``get_energy`` — plain torch, i-chunked, in the input dtype.
* ``cuda_potential_energy`` — PE through the hand-written kernel in
  ``nbody_tpu_torch/csrc/potential.cu`` (replacing the Pallas
  ``_pe_kernel``); ``cuda_potential_energy.launches`` counts launches.
* ``potential_energy_reference`` — its plain twin: pair terms in the
  inputs' dtype summed in fp64.  On f32 inputs that is what the kernel
  does; on fp64 inputs it is the plain version of the fp64 PE kernel
  (``ops/cuda_fp64.py``, K5).
"""

from __future__ import annotations

import torch

from nbody_tpu_torch.core import constants
from nbody_tpu_torch.ops.cuda_exhaustive import check_tensor


def _guarded_inv(r: torch.Tensor) -> torch.Tensor:
    """1/r with 1/0 := 0 (common/get_energy.c:40)."""
    pos_r = r > 0
    return torch.where(pos_r, 1.0 / torch.where(pos_r, r, torch.ones_like(r)), 0.0)


def get_energy(
    pos: torch.Tensor,
    vel: torch.Tensor,
    mass: torch.Tensor,
    *,
    G: float = constants.BIG_G,
    chunk: int = 1024,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (KE, PE) as 0-d tensors in the input dtype, with the
    reference's exact conventions."""
    ke = 0.5 * (mass * (vel * vel).sum(-1)).sum()
    pe_full = pos.new_zeros(())
    for s in range(0, pos.shape[0], chunk):
        d = pos[None, :, :] - pos[s:s + chunk, None, :]
        inv_r = _guarded_inv(torch.sqrt((d * d).sum(-1)))
        pe_full = pe_full + (-mass[s:s + chunk, None] * mass[None, :] * inv_r).sum()
    # Full symmetric sum halved == the reference's upper-triangle sum.
    return ke, G * pe_full * 0.5


def potential_energy_reference(
    pos: torch.Tensor,
    mass: torch.Tensor,
    *,
    G: float = constants.BIG_G,
    chunk: int = 1024,
) -> torch.Tensor:
    """Plain twin of the PE kernels: pair terms -m_i m_j * rsqrt(r^2) (0 at
    r^2 == 0) in the inputs' dtype (f32 for K3, fp64 for K5), accumulated
    in fp64.  Returns a 0-d fp64 tensor."""
    total = torch.zeros((), dtype=torch.float64, device=pos.device)
    for s in range(0, pos.shape[0], chunk):
        d = pos[None, :, :] - pos[s:s + chunk, None, :]
        r2 = (d * d).sum(-1)
        inv_r = torch.where(r2 > 0, torch.rsqrt(r2), 0.0)
        terms = -(mass[s:s + chunk, None] * mass[None, :]) * inv_r
        total = total + terms.sum(dtype=torch.float64)
    return G * total * 0.5


def cuda_potential_energy(
    pos: torch.Tensor,
    mass: torch.Tensor,
    *,
    G: float = constants.BIG_G,
) -> torch.Tensor:
    """Unsoftened PE of f32 pos (N, 3) / mass (N,), as a 0-d fp64 tensor.
    CPU tensors go to `potential_energy_reference`; CUDA tensors launch the
    kernel or raise."""
    device = pos.device
    n = pos.shape[0]
    check_tensor("pos", pos, (-1, 3), device)
    check_tensor("mass", mass, (n,), device)
    if device.type == "cpu":
        return potential_energy_reference(pos, mass, G=G)
    if device.type != "cuda":
        raise ValueError(f"no potential-energy kernel for device {device}")

    from nbody_tpu_torch.ops import _cuda

    kernels = _cuda.library()
    with torch.cuda.device(device):
        # one partial a block of the launch, whose grid is sized to this card
        # (a negative count is a CUDA error, which the launch returns too)
        count = kernels.lib.nbody_potential_partials(n)
        partials = torch.empty((max(count, 0),), dtype=torch.float64, device=device)
        out = torch.empty((1,), dtype=torch.float64, device=device)
        err = kernels.lib.nbody_potential_f32(
            pos.data_ptr(), mass.data_ptr(), n, partials.data_ptr(),
            out.data_ptr(), _cuda.stream_handle(device),
        )
    kernels.check(err, "potential-energy kernel")
    cuda_potential_energy.launches += 1
    return G * out[0] * 0.5  # G and the 1/2 (energy.py:94)


cuda_potential_energy.launches = 0


def energy_drift(e_t, e_0) -> float:
    """|E(t) - E(0)| / |E(0)| (guarding E(0) == 0)."""
    e_t, e_0 = float(e_t), float(e_0)
    if e_0 == 0.0:
        return abs(e_t - e_0)
    return abs(e_t - e_0) / abs(e_0)
