"""fp64 all-pairs force and potential energy through hand-written CUDA
kernels — counterpart of ``nbody_tpu/ops/pallas_df.py``.

* ``cuda_rect_accelerations_f64`` / ``cuda_accelerations_f64`` wrap kernel
  K4, ``nbody_tpu_torch/csrc/allpairs_f64.cu`` (which replaces the Pallas
  ``_force_kernel``): softened fp64 accelerations, within 1e-12 of the
  fp64 oracle (tests/test_pallas_df.py:47).
* ``cuda_potential_energy_f64`` wraps kernel K5,
  ``nbody_tpu_torch/csrc/potential_f64.cu`` (which replaces the Pallas
  ``_pe_kernel``): the unsoftened PE with 1/r = 0 at r = 0, the full
  symmetric sum halved.

The TPU kernels reach fp64 grade with double-float f32 pairs because the
TPU has no fp64 units; Hopper has them, so both kernels are native fp64.
A CPU tensor goes to the plain version (``rect_accelerations_reference``,
the displacement form of ``rect_accelerations``, and
``potential_energy_reference``, which compute in the inputs' dtype); a
CUDA tensor launches the kernel or raises.  Nothing falls back.  Each
wrapper's ``launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from nbody_tpu_torch.core import constants
from nbody_tpu_torch.ops.cuda_exhaustive import (
    check_tensor,
    fewest_split,
    potential_energy_reference,
    rect_accelerations_reference,
)

F64 = torch.float64


def cuda_rect_accelerations_f64(
    pos_i: torch.Tensor,
    pos_j: torch.Tensor,
    mass_j: torch.Tensor,
    *,
    G: float = constants.BIG_G,
    softening_sq: float = constants.SOFTENING_SQ,
    _split: int = 0,
) -> torch.Tensor:
    """fp64 accelerations of pos_i (M, 3) targets against pos_j (N, 3) /
    mass_j (N,) sources.  `_split` forces K4's number of source slices a
    block, for the card tests and chip_smoke.py's sweep only (0, as every
    caller of the port leaves it: ``k4_split``'s pick for this card)."""
    device = pos_i.device
    m, n = pos_i.shape[0], pos_j.shape[0]
    check_tensor("pos_i", pos_i, (-1, 3), device, F64)
    check_tensor("pos_j", pos_j, (n, 3), device, F64)
    check_tensor("mass_j", mass_j, (n,), device, F64)
    if device.type == "cpu":
        return rect_accelerations_reference(pos_i, pos_j, mass_j, G=G,
                                            softening_sq=softening_sq)
    if device.type != "cuda":
        raise ValueError(f"no fp64 all-pairs kernel for device {device}")

    from nbody_tpu_torch.ops import _cuda

    kernels = _cuda.library()
    gm = G * mass_j  # G folded into the source weights in fp64 (pallas_df.py:305)
    out = torch.empty((m, 3), dtype=F64, device=device)
    split = _split or k4_split(m, _cuda.sm_count(device))
    with torch.cuda.device(device):
        err = kernels.lib.nbody_allpairs_f64(
            pos_i.data_ptr(), pos_j.data_ptr(), gm.data_ptr(), float(softening_sq),
            m, n, split, out.data_ptr(), _cuda.stream_handle(device),
        )
    kernels.check(err, "fp64 allpairs kernel")
    cuda_rect_accelerations_f64.launches += 1
    return out


cuda_rect_accelerations_f64.launches = 0

# K4's blocks: 256 threads of 4 targets, two resident an SM (113 registers)
K4_THREADS, K4_PER_THREAD, K4_BLOCKS_PER_SM = 256, 4, 2


def k4_split(m: int, sms: int) -> int:
    """K4's source slices per block for m targets on a card of `sms` SMs:
    the fewest (1, 2, 4 or 8) that give every SM its K4_BLOCKS_PER_SM
    resident blocks, so the fp64 pipes have enough independent pairs in
    flight; 1 where m alone fills the card (m >= 270,336 on 132 SMs)."""
    return fewest_split(lambda s: -(-m // (K4_THREADS // s * K4_PER_THREAD)),
                        K4_BLOCKS_PER_SM * sms)


def cuda_accelerations_f64(
    pos: torch.Tensor,
    mass: torch.Tensor,
    *,
    G: float = constants.BIG_G,
    softening_sq: float = constants.SOFTENING_SQ,
) -> torch.Tensor:
    """Square fp64 all-pairs accelerations (ForceFn signature)."""
    return cuda_rect_accelerations_f64(pos, pos, mass, G=G, softening_sq=softening_sq)


def cuda_potential_energy_f64(
    pos: torch.Tensor,
    mass: torch.Tensor,
    *,
    G: float = constants.BIG_G,
) -> torch.Tensor:
    """Unsoftened PE of fp64 pos (N, 3) / mass (N,), as a 0-d fp64 tensor."""
    device = pos.device
    n = pos.shape[0]
    check_tensor("pos", pos, (-1, 3), device, F64)
    check_tensor("mass", mass, (n,), device, F64)
    if device.type == "cpu":
        return potential_energy_reference(pos, mass, G=G)
    if device.type != "cuda":
        raise ValueError(f"no fp64 potential-energy kernel for device {device}")

    from nbody_tpu_torch.ops import _cuda

    kernels = _cuda.library()
    with torch.cuda.device(device):
        # one partial a block of the launch, whose grid is sized to this card
        # (a negative count is a CUDA error, which the launch returns too)
        count = kernels.lib.nbody_potential_f64_partials(n)
        partials = torch.empty((max(count, 0),), dtype=F64, device=device)
        out = torch.empty((1,), dtype=F64, device=device)
        err = kernels.lib.nbody_potential_f64(
            pos.data_ptr(), mass.data_ptr(), n, partials.data_ptr(),
            out.data_ptr(), _cuda.stream_handle(device),
        )
    kernels.check(err, "fp64 potential-energy kernel")
    cuda_potential_energy_f64.launches += 1
    return G * out[0] * 0.5  # G and the 1/2 (pallas_df.py:434-435)


cuda_potential_energy_f64.launches = 0
