"""Morton (Z-order) keys of body positions — counterpart of
``nbody_tpu/ops/morton.py``.

Positions are quantised onto a 2^depth grid per axis over the root cube
centred at the origin with border = 2·max|coordinate| (the reference's
cube, serial/barnes-hut.c:326-344), and the cell's bits are interleaved
z·4 + y·2 + x (serial/barnes-hut.c:114-133).  A node of the reference
octree at depth d is the set of bodies sharing a 3d-bit key prefix.

The keys equal the JAX package's exactly: the scaling is done in the
border's dtype (f32 for f32 input), truncated toward zero and clipped to
[0, 2^depth - 1], and the sort is stable so tied keys keep input order.
"""

from __future__ import annotations

import torch


def bounding_border(pos: torch.Tensor) -> torch.Tensor:
    """Root cube border, 2·max|coordinate|, in the input dtype (a 0-dim
    tensor on pos's device, so no host sync)."""
    return 2.0 * pos.abs().max()


def _spread3(v: torch.Tensor) -> torch.Tensor:
    """Spread 10 bits so there are two zero bits between each."""
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def morton_encode(pos: torch.Tensor, border: torch.Tensor, depth: int) -> torch.Tensor:
    """int32 Morton keys (N,) of the depth-level cells holding each body."""
    if not 1 <= depth <= 10:
        raise ValueError(f"depth must be in [1, 10] for int32 keys, got {depth}")
    # JAX divides the f32 positions by the border in the border's dtype
    # (f64 under --dtype f64); a 0-dim f64 tensor would not promote here.
    p = pos.to(torch.float32).to(border.dtype)
    scaled = (p / border + 0.5) * float(2**depth)
    cell = scaled.to(torch.int32).clamp_(0, 2**depth - 1)
    return _spread3(cell[:, 0]) | (_spread3(cell[:, 1]) << 1) | (_spread3(cell[:, 2]) << 2)


def morton_sort(pos: torch.Tensor, depth: int, border: torch.Tensor | None = None):
    """(perm, keys, border): the stable permutation sorting bodies by key.

    `border` overrides the bounding cube; out-of-cube positions clip into
    edge cells."""
    if border is None:
        border = bounding_border(pos)
    keys = morton_encode(pos, border, depth)
    perm = torch.argsort(keys, stable=True)
    return perm, keys, border
