"""Energy oracle — counterpart of ``nbody_tpu/diag/energy.py``.

Matches common/get_energy.c:7-47:

* KE = 0.5 * sum_i m_i |v_i|^2                          (:9-21)
* PE = G * sum_{i<=j} -m_i m_j / |p_i - p_j|            (:23-46)
  with 1/r guarded to 0 at r == 0 (:40), so the diagonal contributes
  nothing.  PE uses the unsoftened distance although the force softens;
  that asymmetry is part of the reference contract.

Energy drift |E(t) - E(0)| / |E(0)| is the north-star correctness metric
(drift within 1e-3 of the serial reference).

``get_energy`` is plain torch, i-chunked, in the input dtype.  The PE
kernels sit in ``ops/`` beside their plain twin: K3
(``cuda_exhaustive.cuda_potential_energy``, f32) and K5
(``cuda_fp64.cuda_potential_energy_f64``), both held to
``cuda_exhaustive.potential_energy_reference``.
"""

from __future__ import annotations

import torch

from nbody_tpu_torch.core import constants


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


def energy_drift(e_t, e_0) -> float:
    """|E(t) - E(0)| / |E(0)| (guarding E(0) == 0)."""
    e_t, e_0 = float(e_t), float(e_0)
    if e_0 == 0.0:
        return abs(e_t - e_0)
    return abs(e_t - e_0) / abs(e_0)
