"""Exhaustive O(N^2) all-pairs gravity in plain PyTorch.

Counterpart of ``nbody_tpu/ops/exhaustive.py:68-215``.  Physics contract
(every reference force kernel, e.g. serial/exhaustive.c:155-181):

    a_i = sum_j  G * m_j * (p_j - p_i) * (|p_j - p_i|^2 + eps2)^(-3/2)

The sum includes j == i: the softened self-term is zero because the
displacement is zero, so nothing is masked.

* ``direct_accelerations`` — full (N, N, 3) broadcast, the parity oracle.
* ``rect_accelerations`` — (M targets x N sources).  ``mode`` is JAX's:
  ``direct`` evaluates the whole rectangle at once, ``chunked`` i-chunks
  it so memory is O(chunk * N), ``mxu`` i-chunks it with |r|^2 expanded as
  |p_i|^2 + |p_j|^2 - 2 p_i.p_j (clamped at the softening floor) and the
  j-sum re-associated as W @ P - p_i * rowsum(W), so both N^2-sized
  contractions are matmuls; ``auto`` takes ``direct`` up to 2048^2 pairs
  and ``mxu`` above (``nbody_tpu/ops/exhaustive.py:142-143``).
  ``chunked`` is the plain version of the all-pairs kernels K1 and K4
  (``ops/cuda_exhaustive.py``, ``ops/cuda_fp64.py``).
* ``exhaustive_accelerations`` — the square form: ``auto`` is ``direct``
  up to 2048 bodies and ``mxu`` above (``exhaustive.py:191-192``).  The
  CLI's ``--backend torch`` takes it so, as JAX's ``--backend jnp`` does.

The ``mxu`` matmuls run in full f32: the mode turns TF32 off for CUDA
matmuls, as JAX's ``Precision.HIGHEST`` asks of the TPU.
"""

from __future__ import annotations

from functools import partial

import torch

from nbody_tpu_torch.core import constants

AUTO_DIRECT_PAIRS = 2048 * 2048  # auto: direct up to here, mxu above


def _inv_r3(r2: torch.Tensor) -> torch.Tensor:
    """(r2)^(-3/2): f32 uses rsqrt cubed; f64 uses pow(-1.5) like the
    reference (serial/exhaustive.c:173), which the 1e-12 bound needs."""
    if r2.dtype == torch.float64:
        return r2 ** -1.5
    inv_r = torch.rsqrt(r2)
    return inv_r * inv_r * inv_r


def _pair_eps2(softening_sq, e2_i, e2_all, dtype):
    """Pairwise softening addend for one (C, N) chunk: the global eps2, or
    the symmetric per-body mean eps2_ij = (eps2_i + eps2_j) / 2, which keeps
    the pair force antisymmetric (momentum exactly conserved)."""
    if e2_i is None:
        return softening_sq
    return 0.5 * (e2_i[:, None] + e2_all[None, :])


def _chunk_direct(pos_i, pos, gm, softening_sq, e2_i=None, e2_all=None):
    d = pos[None, :, :] - pos_i[:, None, :]  # (C, N, 3): d[c, j] = p_j - p_c
    r2 = (d * d).sum(-1) + _pair_eps2(softening_sq, e2_i, e2_all, pos.dtype)
    w = _inv_r3(r2) * gm[None, :]
    return (w[:, :, None] * d).sum(1)


def _sum_sq(p: torch.Tensor) -> torch.Tensor:
    """|p|^2 per row as JAX's compiled ``jnp.sum(p * p, axis=-1)`` rounds
    it on the CPU: x*x, then fused multiply-adds of y*y and z*z, each
    rounded once (an f32 FMA is exact in f64 before its one rounding).
    The expanded |r|^2 cancels to the softening floor for close pairs, so
    the ulp that another order moves shows in the force."""
    if p.dtype != torch.float32:
        return (p * p).sum(-1)
    x, y, z = p.double().unbind(-1)
    acc = (x * x).float().double()
    acc = (y * y + acc).float().double()
    return (z * z + acc).float()


def _chunk_mxu(pos_i, pos, gm, pj_sq, softening_sq, e2_i=None, e2_all=None):
    """JAX's ``_chunk_mxu``: expanded |r|^2, clamped at the softening floor
    (cancellation can dip below it), and a_i = W @ P - p_i * rowsum(W)."""
    torch.backends.cuda.matmul.allow_tf32 = False  # JAX: Precision.HIGHEST
    pi_sq = _sum_sq(pos_i)
    dots = pos_i @ pos.T  # (C, N)
    eps2 = _pair_eps2(softening_sq, e2_i, e2_all, pos.dtype)
    r2 = pi_sq[:, None] + pj_sq[None, :] - 2.0 * dots + eps2
    r2 = torch.maximum(r2, torch.as_tensor(eps2, dtype=r2.dtype, device=r2.device))
    w = _inv_r3(r2) * gm[None, :]
    return w @ pos - pos_i * w.sum(-1, keepdim=True)


def direct_accelerations(
    pos: torch.Tensor,
    mass: torch.Tensor,
    *,
    G: float = constants.BIG_G,
    softening_sq: float = constants.SOFTENING_SQ,
    eps2_per_body: torch.Tensor | None = None,
) -> torch.Tensor:
    """Full-broadcast all-pairs accelerations — the parity oracle."""
    return _chunk_direct(
        pos, pos, G * mass, softening_sq, eps2_per_body, eps2_per_body
    )


def rect_accelerations(
    pos_i: torch.Tensor,
    pos_all: torch.Tensor,
    mass_all: torch.Tensor,
    *,
    G: float = constants.BIG_G,
    softening_sq: float = constants.SOFTENING_SQ,
    mode: str = "auto",
    chunk: int = 1024,
    eps2_i: torch.Tensor | None = None,
    eps2_all: torch.Tensor | None = None,
) -> torch.Tensor:
    """Accelerations of pos_i (M, 3) targets against all (N, 3) sources.

    `mode` is ``auto``, ``direct``, ``chunked`` or ``mxu`` (module
    docstring).  `eps2_i` (M,) / `eps2_all` (N,) switch on per-body
    softening and must be given together."""
    if (eps2_i is None) != (eps2_all is None):
        raise ValueError("eps2_i and eps2_all must be given together")
    if mode == "auto":
        mode = ("direct" if pos_i.shape[0] * pos_all.shape[0] <= AUTO_DIRECT_PAIRS
                else "mxu")
    gm = G * mass_all
    if mode == "direct":
        return _chunk_direct(pos_i, pos_all, gm, softening_sq, eps2_i, eps2_all)
    if mode == "mxu":
        fn = partial(_chunk_mxu, pos=pos_all, gm=gm, pj_sq=_sum_sq(pos_all))
    elif mode == "chunked":
        fn = partial(_chunk_direct, pos=pos_all, gm=gm)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    out = pos_i.new_empty(pos_i.shape)
    for s in range(0, pos_i.shape[0], chunk):
        e = None if eps2_i is None else eps2_i[s:s + chunk]
        out[s:s + chunk] = fn(pos_i[s:s + chunk], softening_sq=softening_sq, e2_i=e,
                              e2_all=eps2_all)
    return out


def exhaustive_accelerations(
    pos: torch.Tensor,
    mass: torch.Tensor,
    *,
    G: float = constants.BIG_G,
    softening_sq: float = constants.SOFTENING_SQ,
    mode: str = "auto",
    chunk: int = 1024,
    eps2_per_body: torch.Tensor | None = None,
) -> torch.Tensor:
    """Square all-pairs accelerations (ForceFn signature).  ``auto`` picks
    by N (module docstring); ``direct`` above 4096 bodies runs chunked, as
    in JAX (``exhaustive.py:193-215``)."""
    n = pos.shape[0]
    if mode == "auto":
        mode = "direct" if n <= 2048 else "mxu"
    if mode == "direct" and n <= 4096:
        return direct_accelerations(pos, mass, G=G, softening_sq=softening_sq,
                                    eps2_per_body=eps2_per_body)
    return rect_accelerations(
        pos, pos, mass, G=G, softening_sq=softening_sq,
        mode="mxu" if mode == "mxu" else "chunked", chunk=chunk,
        eps2_i=eps2_per_body, eps2_all=eps2_per_body,
    )
