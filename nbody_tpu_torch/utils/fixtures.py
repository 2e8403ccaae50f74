"""Input fixture generation — counterpart of ``nbody_tpu/utils/fixtures.py``.

The reference ships random-cloud fixtures (coords +-2, velocities +-1,
masses 0.04-1.0; SURVEY.md §2.4).  These functions draw the same numbers
in the same order from the same numpy generator, so for a given seed the
arrays are bit-identical to the JAX package's.  numpy only: the JAX
package cannot be imported here (``nbody_tpu/__init__.py`` imports jax).
"""

from __future__ import annotations

import numpy as np


def random_cloud(
    n: int,
    seed: int = 0,
    pos_range: float = 2.0,
    vel_range: float = 1.0,
    mass_range: tuple[float, float] = (0.04, 1.0),
) -> np.ndarray:
    """(N, 7) body array in the reference CSV column order."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-pos_range, pos_range, size=(n, 3))
    vel = rng.uniform(-vel_range, vel_range, size=(n, 3))
    mass = rng.uniform(*mass_range, size=(n,))
    return np.concatenate([pos, vel, mass[:, None]], axis=1)


def plummer_cloud(
    n: int,
    seed: int = 0,
    scale_radius: float = 1.0,
    total_mass: float = 1.0,
    G: float = 1.0,
) -> np.ndarray:
    """(N, 7) Plummer-sphere realization (Aarseth, Henon & Wielen 1974
    sampling): positions from the Plummer density profile, isotropic
    velocities from the local escape-speed distribution, equal masses."""
    rng = np.random.default_rng(seed)
    m = np.full(n, total_mass / n)

    # radius via inverse transform of M(r): r = a / sqrt(X^(-2/3) - 1)
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


def write_fixture(path: str, arr: np.ndarray) -> None:
    """Write bodies in the reference input format: 7 comma-separated floats
    per line, no header (serial/exhaustive.c:130-132), each as ``repr`` of
    the float so the file reads back bit-exact."""
    with open(path, "w") as f:
        f.writelines(",".join(map(repr, row)) + "\n" for row in arr.tolist())
