"""Input generators: the one general generator of the benchmark's traffic.

A cell's traffic file names a `distribution`; ``make_pool`` draws `pool`
distinct inputs of `n` bodies from it, from `--seed` alone, in the dtype the
cell runs in, on the device.  Job j of a window takes input j mod pool, so
no job's input is another job's output.

* ``uniform``: the reference's random cloud (positions +-2, velocities +-1,
  masses 0.04-1; ``bench.py:38-43``, ``tools/bench_bh.py:86-92``), drawn on
  the device by one ``torch.Generator`` in one call for the whole pool.
* ``plummer_escapers``: a Plummer sphere with its first 8 bodies moved out
  to r 300-1000, the robust hybrid's input.  Frozen numpy copies of
  ``nbody_tpu_torch/utils/fixtures.py``'s ``plummer_cloud`` and
  ``with_escapers``: the benchmark imports nothing of the program to make
  its inputs.  Drawn on the host (rejection sampling), so slower to set up.
"""

from __future__ import annotations

import numpy as np
import torch

DTYPES = {"f32": torch.float32, "f64": torch.float64}


def uniform_pool(n: int, pool: int, seed: int, dtype: torch.dtype, device) -> torch.Tensor:
    """(pool, n, 7) bodies [x y z vx vy vz m] of the uniform cloud, drawn in
    `dtype` on `device` from one generator seeded with `seed`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    u = torch.rand((pool, n, 7), generator=gen, dtype=dtype, device=device)
    lo = torch.tensor([-2.0] * 3 + [-1.0] * 3 + [0.04], dtype=dtype, device=device)
    hi = torch.tensor([2.0] * 3 + [1.0] * 3 + [1.0], dtype=dtype, device=device)
    return lo + u * (hi - lo)


def plummer_cloud(n: int, seed: int = 0, scale_radius: float = 1.0,
                  total_mass: float = 1.0, G: float = 1.0) -> np.ndarray:
    """(N, 7) Plummer-sphere realization (Aarseth, Henon & Wielen 1974):
    positions from the Plummer density profile, isotropic velocities from
    the local escape-speed distribution, equal masses."""
    rng = np.random.default_rng(seed)
    m = np.full(n, total_mass / n)
    x = rng.uniform(1e-8, 1.0 - 1e-8, n)
    r = scale_radius / np.sqrt(x ** (-2.0 / 3.0) - 1.0)
    u = rng.normal(size=(n, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    pos = r[:, None] * u
    # velocity magnitude: rejection-sample q = v/v_esc from q^2(1-q^2)^3.5
    q = np.empty(n)
    todo = np.arange(n)
    while todo.size:
        cand = rng.uniform(0.0, 1.0, todo.size)
        y = rng.uniform(0.0, 0.1, todo.size)
        ok = y < cand**2 * (1.0 - cand**2) ** 3.5
        q[todo[ok]] = cand[ok]
        todo = todo[~ok]
    v_esc = np.sqrt(2.0 * G * total_mass) * (r**2 + scale_radius**2) ** -0.25
    w = rng.normal(size=(n, 3))
    w /= np.linalg.norm(w, axis=1, keepdims=True)
    vel = (q * v_esc)[:, None] * w
    return np.concatenate([pos, vel, m[:, None]], axis=1)


def with_escapers(arr: np.ndarray) -> np.ndarray:
    """`arr` with its first 8 bodies moved out to r 300-1000 (directions and
    radii from ``default_rng(1)``): the outlier input of the robust hybrid."""
    out = arr.copy()
    rng = np.random.default_rng(1)
    u = rng.normal(size=(8, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    out[:8, :3] = u * rng.uniform(300.0, 1000.0, (8, 1))
    return out


def plummer_escapers_pool(n: int, pool: int, seed: int, dtype: torch.dtype,
                          device) -> torch.Tensor:
    """(pool, n, 7) Plummer spheres with 8 escapers, input i seeded with
    (seed, i)."""
    arrs = [with_escapers(plummer_cloud(n, seed=np.random.SeedSequence([int(seed), i])))
            for i in range(pool)]
    return torch.as_tensor(np.stack(arrs)).to(device=device, dtype=dtype)


DISTRIBUTIONS = {"uniform": uniform_pool, "plummer_escapers": plummer_escapers_pool}


def make_pool(distribution: str, n: int, pool: int, seed: int, dtype: str, device):
    """The window's inputs: a list of `pool` (pos (n, 3), vel (n, 3), mass
    (n,)) contiguous tensors in `dtype` ("f32" or "f64") on `device`."""
    if distribution not in DISTRIBUTIONS:
        raise ValueError(f"unknown distribution {distribution!r}; known: "
                         f"{sorted(DISTRIBUTIONS)}")
    arr = DISTRIBUTIONS[distribution](n, pool, seed, DTYPES[dtype], device)
    return [(a[:, 0:3].contiguous(), a[:, 3:6].contiguous(), a[:, 6].contiguous())
            for a in arr]
