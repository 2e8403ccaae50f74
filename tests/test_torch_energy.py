"""PyTorch port of the energy oracle (nbody_tpu_torch/diag/energy.py) held
against the reference self-test, the fp64 oracle and the JAX package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
from conftest import random_cloud
from nbody_tpu.diag import energy as jax_energy
from nbody_tpu_torch.diag.energy import energy_drift, get_energy
from nbody_tpu_torch.ops.cuda_exhaustive import (
    cuda_potential_energy,
    potential_energy_reference,
)


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype)


def test_matches_reference_self_test():
    """Values of common/get_energy.c's -DTEST_GET_ENERGY self-test
    (:49-58), as in test_energy.py:10-27."""
    vel = np.array(
        [5, 65, 105, -18, 9, -89, -64, 23, 32, 45, 45, 45, -29, -71, -61],
        dtype=np.float64,
    ).reshape(5, 3)
    pos = np.array(
        [90, 44, -32, 33, 100, 9, -84, -4, 0, 103, 182, 71, 9, 2, -103],
        dtype=np.float64,
    ).reshape(5, 3)
    mass = np.array([103, 50, 88, 34, 59], dtype=np.float64)
    ke, pe = get_energy(_t(pos), _t(vel), _t(mass), G=0.7)
    assert float(ke) == pytest.approx(1629932.0, rel=1e-12)
    assert float(pe) == pytest.approx(-207.735345789164597, rel=1e-10)


@pytest.mark.parametrize("n", [5, 100, 1500])
def test_matches_oracle_and_jax(n):
    arr = random_cloud(n, seed=n + 1)
    ke_o, pe_o = oracle.energy(arr[:, :3], arr[:, 3:6], arr[:, 6])
    ke_j, pe_j = jax_energy.get_energy(
        jnp.asarray(arr[:, :3]), jnp.asarray(arr[:, 3:6]),
        jnp.asarray(arr[:, 6]), chunk=256,
    )
    ke, pe = get_energy(
        _t(arr[:, :3]), _t(arr[:, 3:6]), _t(arr[:, 6]), chunk=256
    )
    assert float(ke) == pytest.approx(ke_o, rel=1e-12)
    assert float(pe) == pytest.approx(pe_o, rel=1e-9)
    assert float(ke) == pytest.approx(float(ke_j), rel=1e-12)
    assert float(pe) == pytest.approx(float(pe_j), rel=1e-9)


def test_coincident_bodies_guarded():
    z = torch.zeros((2, 3), dtype=torch.float64)
    ke, pe = get_energy(z, z, torch.ones(2, dtype=torch.float64))
    assert float(ke) == 0.0
    assert float(pe) == 0.0


def test_kernel_twin_coincident_bodies_guarded():
    pe = potential_energy_reference(torch.zeros((3, 3)), torch.ones(3))
    assert float(pe) == 0.0


def test_energy_drift_helper():
    assert energy_drift(-1.001, -1.0) == pytest.approx(1e-3)
    assert energy_drift(5.0, 0.0) == 5.0


def test_kernel_twin_matches_pallas_interpret():
    """The PE kernel's plain twin against the Pallas kernel it replaces,
    in interpret mode, within the kernel's f32 bound (test_energy.py:70)."""
    arr = random_cloud(300, seed=77)
    want = float(jax_energy.pallas_potential_energy(
        jnp.asarray(arr[:, :3], jnp.float32),
        jnp.asarray(arr[:, 6], jnp.float32),
        block=256, interpret=True,
    ))
    before = cuda_potential_energy.launches
    got = cuda_potential_energy(
        _t(arr[:, :3], torch.float32), _t(arr[:, 6], torch.float32)
    )
    assert got.dtype == torch.float64
    assert float(got) == pytest.approx(want, rel=1e-4)
    assert cuda_potential_energy.launches == before  # no kernel on the CPU


@pytest.mark.parametrize("G", [1.0, 0.7])
def test_kernel_twin_matches_oracle(G):
    arr = random_cloud(700, seed=78)
    _, pe_o = oracle.energy(arr[:, :3], arr[:, 3:6], arr[:, 6], G=G)
    pe = potential_energy_reference(
        _t(arr[:, :3], torch.float32), _t(arr[:, 6], torch.float32), G=G,
        chunk=128,
    )
    assert float(pe) == pytest.approx(pe_o, rel=1e-4)


def test_kernel_wrapper_refuses_f64():
    with pytest.raises(TypeError):
        cuda_potential_energy(torch.zeros((4, 3), dtype=torch.float64),
                              torch.ones(4, dtype=torch.float64))
