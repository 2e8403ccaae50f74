"""Collisional merging, perfectly inelastic body mergers — counterpart of
``nbody_tpu/ops/collisions.py``.

Merging changes no array shape: an absorbed body is not removed but
becomes a zero-mass ghost, which every force path already treats as inert
(a source of mass 0 pulls nothing).  The ghost rides at the merged body's
centre-of-mass state from then on.

One merge pass (``merge_pass``):

1. contact detection, an O(N²) distance test over row chunks, live bodies
   only;
2. each body takes the LOWEST-INDEX live partner closer than the radius,
   and adopts it as parent only when that index is below its own, so
   parents only point down;
3. chains resolve by pointer jumping, parent = parent[parent] for
   ceil(log2 N) rounds, so every body reaches its cluster's root;
4. mass, momentum and mass-weighted position are summed into each root
   with ``index_add_``, in fp64, and the root takes the centre of mass.
   Absorbed bodies take their root's new state; bodies that were dead
   before the pass keep theirs.

This is plain torch, as JAX's is jnp: no TPU kernel lies on this path.
The sums run in fp64 and round once to the state's dtype, so a root's mass
is the correctly rounded sum of its members' wherever that sum is exact in
fp64 (always, for a few f32 members), and the card's atomic order cannot
change a bit of it.  JAX sums in the state's dtype; the two agree within
one rounding.

The stepping loop that calls it every `merge_every` steps is
``integrate.leapfrog.simulate_merging``.
"""

from __future__ import annotations

import math

import torch

# Bytes of temporaries per (row, body) pair of a chunk of the contact test
# (three f32/f64 coordinate differences and r², a few bool masks), and the
# budget for one chunk: rows = budget / (pair bytes x N), at least 8.
_PAIR_BYTES = 40
_CHUNK_BUDGET = 2 << 30


def merge_chunk(n: int) -> int:
    """Rows a chunk of the contact test: as many as fit the temporaries'
    budget (2 GiB), where JAX takes 512.  The chunk changes no result."""
    return max(8, min(n, _CHUNK_BUDGET // (_PAIR_BYTES * max(n, 1))))


def lowest_partners(pos: torch.Tensor, live: torch.Tensor, r2_contact) -> torch.Tensor:
    """(N,) int64: each body's lowest-index live partner closer than the
    contact distance (r² < `r2_contact`), or N if none; dead bodies have
    none.  The squared distance is (dx² + dy²) + dz², each difference
    p_j - p_i, as JAX's ``jnp.sum(d * d, axis=-1)``."""
    n = pos.shape[0]
    c = merge_chunk(n)
    px, py, pz = pos[:, 0], pos[:, 1], pos[:, 2]
    part = torch.full((n,), n, dtype=torch.int64, device=pos.device)
    for s in range(0, n, c):
        e = min(n, s + c)
        dx = px[None, :] - px[s:e, None]
        r2 = dx * dx
        dy = py[None, :] - py[s:e, None]
        r2 = r2 + dy * dy
        dz = pz[None, :] - pz[s:e, None]
        r2 = r2 + dz * dz
        hit = (r2 < r2_contact) & live[None, :] & live[s:e, None]
        rows = torch.arange(e - s, device=pos.device)
        hit[rows, rows + s] = False
        first = hit.to(torch.uint8).argmax(dim=1)  # the first True: lowest index
        part[s:e] = torch.where(hit.any(dim=1), first, n)
    return part


def merge_pass(pos: torch.Tensor, vel: torch.Tensor, mass: torch.Tensor, radius: float):
    """One inelastic merge pass.  Returns (pos, vel, mass, n_merged) with
    the same shapes and dtype; `n_merged` is a 0-dim int64 tensor on the
    device (the absorbed bodies of this pass)."""
    n = pos.shape[0]
    dtype, dev = pos.dtype, pos.device
    idx = torch.arange(n, device=dev)
    live = mass > 0
    r2_contact = torch.tensor(radius, dtype=dtype, device=dev) ** 2
    part = lowest_partners(pos, live, r2_contact)
    parent = torch.where(part < idx, part, idx)
    for _ in range(max(1, math.ceil(math.log2(max(n, 2))))):
        parent = parent[parent]

    f64 = torch.float64
    m64 = mass.to(f64)
    new_mass = torch.zeros(n, dtype=f64, device=dev).index_add_(0, parent, m64)
    mom = torch.zeros((n, 3), dtype=f64, device=dev).index_add_(
        0, parent, m64[:, None] * vel.to(f64))
    mpos = torch.zeros((n, 3), dtype=f64, device=dev).index_add_(
        0, parent, m64[:, None] * pos.to(f64))
    safe = torch.clamp_min(new_mass, 1e-30)[:, None]
    com_pos, com_vel = (mpos / safe).to(dtype), (mom / safe).to(dtype)
    new_mass = new_mass.to(mass.dtype)

    moved = parent != idx
    rooted = (new_mass > 0)[:, None]
    out_pos = torch.where(rooted, com_pos, com_pos[parent])
    out_vel = torch.where(rooted, com_vel, com_vel[parent])
    was_dead = (~live & ~moved)[:, None]
    out_pos = torch.where(was_dead, pos, out_pos)
    out_vel = torch.where(was_dead, vel, out_vel)
    return out_pos, out_vel, new_mass, moved.sum()
