"""All-pairs force through the hand-written CUDA kernels.

Counterpart of ``nbody_tpu/ops/pallas_exhaustive.py``:

* ``cuda_rect_accelerations`` / ``cuda_accelerations`` wrap K1,
  ``nbody_tpu_torch/csrc/allpairs.cu`` (which replaces the Pallas
  ``_kernel``); its plain version is ``rect_accelerations_reference``,
  the displacement form (``rect_accelerations`` with ``mode="chunked"``).
* With ``use_mxu=True`` they go to ``cuda_rect_accelerations_mxu``, the
  wrapper of K2, ``nbody_tpu_torch/csrc/allpairs_mma.cu`` (which replaces
  the Pallas ``_kernel_mxu``): the same force with the j-sum as a
  tensor-core product W @ [x y z 1]; its plain version is
  ``rect_accelerations_mxu_reference``.
* ``cuda_potential_energy`` wraps K3, ``nbody_tpu_torch/csrc/potential.cu``
  (which replaces the Pallas ``_pe_kernel`` of ``nbody_tpu/diag/energy.py``):
  the unsoftened f32 PE.  Its plain twin ``potential_energy_reference``
  sums pair terms in the inputs' dtype in fp64, so it is also the plain
  version of the fp64 PE kernel K5 (``ops/cuda_fp64.py``).

A CPU tensor goes to the plain version; a CUDA tensor launches the kernel
or raises.  Nothing falls back.  Each kernel wrapper's ``launches``
counts its kernel's launches, so a run can show that it went through it.
"""

from __future__ import annotations

import torch

from nbody_tpu_torch.core import constants
from nbody_tpu_torch.ops.exhaustive import _inv_r3, _pair_eps2, rect_accelerations

_INT_MAX = 2**31 - 1  # the kernels take sizes as C int
MXU_BLOCK_J = 256  # sources per j-block of K2's plain version: K2's tile


def rect_accelerations_reference(pos_i, pos_j, mass_j, **kw) -> torch.Tensor:
    """K1's (and K4's) plain version: ``rect_accelerations`` in the
    displacement form (``mode="chunked"``), same arguments."""
    return rect_accelerations(pos_i, pos_j, mass_j, mode="chunked", **kw)


def rect_accelerations_mxu_reference(
    pos_i: torch.Tensor,
    pos_j: torch.Tensor,
    mass_j: torch.Tensor,
    *,
    G: float = constants.BIG_G,
    softening_sq: float = constants.SOFTENING_SQ,
    eps2_i: torch.Tensor | None = None,
    eps2_all: torch.Tensor | None = None,
    chunk: int = 4096,
    block_j: int = MXU_BLOCK_J,
) -> torch.Tensor:
    """K2's plain version, ``_kernel_mxu``'s arithmetic in plain torch: per
    j-block, exact r^2 and w = G m_j (r^2 + eps2_ij)^(-3/2), the product
    W @ [x_j y_j z_j 1] in full f32, and a_i += partial[:, :3] - p_i *
    partial[:, 3], with K2's tile of 256 sources as the j-block (JAX's
    kernel takes ``block_j``)."""
    if (eps2_i is None) != (eps2_all is None):
        raise ValueError("eps2_i and eps2_all must be given together")
    torch.backends.cuda.matmul.allow_tf32 = False  # JAX: Precision.HIGHEST
    gm = G * mass_j
    ones = torch.ones_like(pos_j[:, :1])
    pjt = torch.cat([pos_j, ones], dim=1)  # (N, 4) columns [x y z 1]
    out = torch.zeros_like(pos_i)
    for s in range(0, pos_i.shape[0], chunk):
        pi = pos_i[s:s + chunk]
        for k in range(0, pos_j.shape[0], block_j):
            d = pos_j[None, k:k + block_j] - pi[:, None]  # (C, BJ, 3)
            e = None if eps2_i is None else eps2_i[s:s + chunk]
            e_j = None if eps2_all is None else eps2_all[k:k + block_j]
            r2 = (d * d).sum(-1) + _pair_eps2(softening_sq, e, e_j, pos_i.dtype)
            w = _inv_r3(r2) * gm[None, k:k + block_j]
            partial = w @ pjt[k:k + block_j]  # (C, 4)
            out[s:s + chunk] += partial[:, :3] - pi * partial[:, 3:4]
    return out


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


def _check_rect(pos_i, pos_j, mass_j, eps2_i, eps2_all) -> torch.device:
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
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no all-pairs kernel for device {device}")
    return device


def _launch(entry: str, what: str, pos_i, pos_j, mass_j, G, softening_sq, eps2_i,
            eps2_all, *extra: int) -> torch.Tensor:
    """Launch the f32 all-pairs kernel `entry` of the library on checked
    CUDA tensors, with `extra` int arguments after the sizes (K1's number
    of source slices); raise on a launch error."""
    from nbody_tpu_torch.ops import _cuda

    device = pos_i.device
    kernels = _cuda.library()
    gm = G * mass_j  # G folded into the source weights (pallas_exhaustive.py:165)
    out = torch.empty((pos_i.shape[0], 3), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        err = getattr(kernels.lib, entry)(
            pos_i.data_ptr(), pos_j.data_ptr(), gm.data_ptr(),
            None if eps2_i is None else eps2_i.data_ptr(),
            None if eps2_all is None else eps2_all.data_ptr(),
            float(softening_sq), pos_i.shape[0], pos_j.shape[0], *extra,
            out.data_ptr(), _cuda.stream_handle(device),
        )
    kernels.check(err, what)
    return out


def fewest_split(blocks, want: int) -> int:
    """The fewest source slices a block (1, 2, 4 or 8) for which the grid,
    `blocks(split)` blocks, reaches `want` blocks; 8 where none does."""
    for split in (1, 2, 4):
        if blocks(split) >= want:
            return split
    return 8


# K1's blocks: 128 threads of 4 targets
K1_THREADS, K1_PER_THREAD, K1_BLOCKS_PER_SM = 128, 4, 8


def k1_split(m: int, sms: int) -> int:
    """K1's source slices per block for m targets on a card of `sms` SMs:
    the fewest that give every SM K1_BLOCKS_PER_SM blocks, so that no SM
    idles while the last blocks run; 1 where m alone does (m > 540,160 on
    132 SMs; PERF.md)."""
    return fewest_split(lambda s: -(-m // (K1_THREADS // s * K1_PER_THREAD)),
                        K1_BLOCKS_PER_SM * sms)


def cuda_rect_accelerations_mxu(
    pos_i: torch.Tensor,
    pos_j: torch.Tensor,
    mass_j: torch.Tensor,
    *,
    G: float = constants.BIG_G,
    softening_sq: float = constants.SOFTENING_SQ,
    eps2_i: torch.Tensor | None = None,
    eps2_all: torch.Tensor | None = None,
) -> torch.Tensor:
    """K2: f32 accelerations of pos_i (M, 3) against pos_j (N, 3) / mass_j
    (N,), the j-sum on the tensor cores in 3xTF32.  `eps2_i` (M,) /
    `eps2_all` (N,) switch on per-body softening, given together."""
    device = _check_rect(pos_i, pos_j, mass_j, eps2_i, eps2_all)
    if device.type == "cpu":
        return rect_accelerations_mxu_reference(
            pos_i, pos_j, mass_j, G=G, softening_sq=softening_sq,
            eps2_i=eps2_i, eps2_all=eps2_all,
        )
    out = _launch("nbody_allpairs_mma_f32", "tensor-core allpairs kernel", pos_i,
                  pos_j, mass_j, G, softening_sq, eps2_i, eps2_all)
    cuda_rect_accelerations_mxu.launches += 1
    return out


cuda_rect_accelerations_mxu.launches = 0


def cuda_rect_accelerations(
    pos_i: torch.Tensor,
    pos_j: torch.Tensor,
    mass_j: torch.Tensor,
    *,
    G: float = constants.BIG_G,
    softening_sq: float = constants.SOFTENING_SQ,
    eps2_i: torch.Tensor | None = None,
    eps2_all: torch.Tensor | None = None,
    use_mxu: bool = False,
    _split: int = 0,
) -> torch.Tensor:
    """f32 accelerations of pos_i (M, 3) targets against pos_j (N, 3) /
    mass_j (N,) sources through K1, or K2 with `use_mxu`.  `eps2_i` (M,) /
    `eps2_all` (N,) switch on symmetric-mean per-body softening and must be
    given together.  `_split` forces K1's number of source slices a block,
    for the card tests and chip_smoke.py's sweep only (0, as every caller
    of the port leaves it: ``k1_split``'s pick for this card)."""
    kw = dict(G=G, softening_sq=softening_sq, eps2_i=eps2_i, eps2_all=eps2_all)
    if use_mxu:
        return cuda_rect_accelerations_mxu(pos_i, pos_j, mass_j, **kw)
    device = _check_rect(pos_i, pos_j, mass_j, eps2_i, eps2_all)
    if device.type == "cpu":
        return rect_accelerations_reference(pos_i, pos_j, mass_j, **kw)
    from nbody_tpu_torch.ops import _cuda

    split = _split or k1_split(pos_i.shape[0], _cuda.sm_count(device))
    out = _launch("nbody_allpairs_f32", "allpairs kernel", pos_i, pos_j, mass_j, G,
                  softening_sq, eps2_i, eps2_all, split)
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
    use_mxu: bool = False,
) -> torch.Tensor:
    """Square all-pairs accelerations (ForceFn signature), K1 or K2."""
    return cuda_rect_accelerations(
        pos, pos, mass, G=G, softening_sq=softening_sq,
        eps2_i=eps2_per_body, eps2_all=eps2_per_body, use_mxu=use_mxu,
    )


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
    return G * out[0] * 0.5  # G and the 1/2 (nbody_tpu/diag/energy.py:94)


cuda_potential_energy.launches = 0
