"""The port's mxu modes (nbody_tpu_torch/ops/exhaustive.py) and K2's plain
version (ops/cuda_exhaustive.py::rect_accelerations_mxu_reference) held
against the JAX package and the fp64 oracle.

On the CPU the K2 wrapper runs its plain version; the kernel itself is
tested on the card in test_torch_cuda.py and under the CPU emulation in
test_torch_kernel_emulation.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
from conftest import random_cloud
from nbody_tpu.ops import exhaustive as jax_exh
from nbody_tpu.ops.pallas_exhaustive import pallas_rect_accelerations
from nbody_tpu_torch.ops import exhaustive as port
from nbody_tpu_torch.ops.cuda_exhaustive import (
    cuda_accelerations,
    cuda_rect_accelerations_mxu,
    rect_accelerations_mxu_reference,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs a worker per core, and torch's
    default of a thread per core in every worker oversubscribes the host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(got, want):
    return np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(np.asarray(want)).max()


# The mxu mode's bounds are JAX's own for it (test_softening.py:62,108):
# 5e-5 of the force scale with the scalar softening, 2e-3 per body (eps^2
# down to 1e-4 softens the closest pairs less), 1e-12 in f64.  Held to JAX's
# mxu result and to the fp64 oracle.  Tighter does not hold: |r|^2 expanded
# cancels to the softening floor for close pairs, so the ulps by which
# torch's and XLA's matmul and row sums round apart show in the force, and
# JAX's own mxu result is not within 1e-5 of the oracle at n = 3000 either.
# The port rounds |p|^2 with XLA's fused multiply-adds, so the expanded
# |r|^2 itself is JAX's bit for bit.
BOUNDS = {"f32": (torch.float32, jnp.float32, 5e-5),
          "f64": (torch.float64, jnp.float64, 1e-12)}


def _oracle(pos, mass, eps2):
    d = pos[None] - pos[:, None]
    r2 = (d * d).sum(-1) + 0.5 * (eps2[:, None] + eps2[None, :])
    return np.einsum("ij,ijk->ik", r2 ** -1.5 * mass[None], d)


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("form", ["square", "rect"])
def test_mxu_mode_matches_jax(dtype, form):
    """The expanded-|r|^2 matmul mode against JAX's jnp ``mxu`` mode and
    the fp64 oracle at n = 3000."""
    tdt, jdt, tol = BOUNDS[dtype]
    arr = random_cloud(3000, seed=31)
    pos, mass = arr[:, :3], arr[:, 6]
    m = 3000 if form == "square" else 700
    if form == "square":
        want = jax_exh.exhaustive_accelerations(jnp.asarray(pos, jdt), jnp.asarray(mass, jdt),
                                                mode="mxu", G=1.0)
        got = port.exhaustive_accelerations(torch.as_tensor(pos, dtype=tdt),
                                            torch.as_tensor(mass, dtype=tdt), mode="mxu",
                                            G=1.0)
    else:
        want = jax_exh.rect_accelerations(jnp.asarray(pos[:m], jdt), jnp.asarray(pos, jdt),
                                          jnp.asarray(mass, jdt), mode="mxu", chunk=256,
                                          G=1.0)
        got = port.rect_accelerations(torch.as_tensor(pos[:m], dtype=tdt),
                                      torch.as_tensor(pos, dtype=tdt),
                                      torch.as_tensor(mass, dtype=tdt), mode="mxu", chunk=256,
                                      G=1.0)
    assert got.dtype == tdt
    assert _rel(got.numpy(), want) < tol
    assert _rel(got.numpy(), oracle.accel_exhaustive(pos, mass, G=1.0)[:m]) < tol


@pytest.mark.parametrize("n,jax_mode", [(2048, "direct"), (2049, "mxu")])
def test_auto_picks_jax_mode(n, jax_mode):
    """``auto`` takes JAX's mode on both sides of 2048 bodies (2048^2 pairs
    for the rectangle): the port's auto result is its own result in that
    mode, bit for bit, and agrees with JAX's auto within that mode's
    bound."""
    arr = random_cloud(n, seed=n)
    pos = torch.as_tensor(arr[:, :3], dtype=torch.float32)
    mass = torch.as_tensor(arr[:, 6], dtype=torch.float32)
    auto = port.exhaustive_accelerations(pos, mass)
    assert torch.equal(auto, port.exhaustive_accelerations(pos, mass, mode=jax_mode))
    want = jax_exh.exhaustive_accelerations(jnp.asarray(arr[:, :3], jnp.float32),
                                            jnp.asarray(arr[:, 6], jnp.float32))
    assert _rel(auto.numpy(), want) < (5e-5 if jax_mode == "mxu" else 1e-5)
    rect = port.rect_accelerations(pos, pos[:2048], mass[:2048])
    assert torch.equal(rect, port.rect_accelerations(pos, pos[:2048], mass[:2048],
                                                     mode=jax_mode))


def test_mxu_mode_per_body_matches_jax():
    """Per-body mxu (test_softening.py's fixture at n = 2500) against JAX's
    and the oracle within JAX's per-body mxu bound, 2e-3."""
    rng = np.random.default_rng(0)
    pos, mass = rng.uniform(-1, 1, (2500, 3)), rng.uniform(0.1, 1.0, 2500)
    eps2 = rng.uniform(1e-4, 1e-2, 2500)
    want = jax_exh.exhaustive_accelerations(
        jnp.asarray(pos, jnp.float32), jnp.asarray(mass, jnp.float32), mode="mxu", G=1.0,
        eps2_per_body=jnp.asarray(eps2, jnp.float32))
    got = port.exhaustive_accelerations(
        torch.as_tensor(pos, dtype=torch.float32), torch.as_tensor(mass, dtype=torch.float32),
        mode="mxu", G=1.0, eps2_per_body=torch.as_tensor(eps2, dtype=torch.float32))
    assert _rel(got.numpy(), want) < 2e-3
    assert _rel(got.numpy(), _oracle(pos, mass, eps2)) < 2e-3


def _k2_case(per_body: bool):
    """200 targets and 328 sources (not multiples of the 128 blocks), the
    targets apart from the sources: at this force scale a softened
    self-term's weight G m / eps^3, which the W @ [x 1] - x * sum(w) form
    cancels in f32 on both sides, would set the error."""
    arr = random_cloud(528, seed=5)
    kw = {}
    if per_body:
        e = np.random.default_rng(6).uniform(1e-3, 1e-2, 528)
        kw = dict(eps2_i=e[:200], eps2_all=e[200:])
    return arr[:200, :3], arr[200:, :3], arr[200:, 6], kw


@pytest.mark.parametrize("per_body", [False, True])
def test_k2_plain_matches_pallas_interpret(per_body):
    """K2's plain version against the Pallas kernel it replaces
    (``_kernel_mxu``, interpret mode, blocks of 128) within K1's bound."""
    pi, pj, mj, kw = _k2_case(per_body)
    want = np.asarray(pallas_rect_accelerations(
        jnp.asarray(pi, jnp.float32), jnp.asarray(pj, jnp.float32),
        jnp.asarray(mj, jnp.float32), block_i=128, block_j=128, use_mxu=True,
        interpret=True, **{k: jnp.asarray(v, jnp.float32) for k, v in kw.items()}))
    t = lambda a: torch.as_tensor(a, dtype=torch.float32)  # noqa: E731
    got = rect_accelerations_mxu_reference(t(pi), t(pj), t(mj),
                                           **{k: t(v) for k, v in kw.items()})
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5 * scale, rtol=2e-4)


@pytest.mark.parametrize("per_body", [False, True])
def test_k2_wrapper_on_cpu_matches_oracle(per_body):
    """``cuda_accelerations(use_mxu=True)`` on CPU tensors is K2's plain
    version, launches nothing, and is within 2e-3 of the fp64 oracle
    (test_softening.py:163, the JAX bound of the per-body mxu kernel)."""
    rng = np.random.default_rng(9)
    pos, mass = rng.uniform(-1, 1, (300, 3)), rng.uniform(0.1, 1.0, 300)
    eps2 = rng.uniform(1e-4, 1e-2, 300) if per_body else np.full(300, 0.01)
    want = _oracle(pos, mass, eps2)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32)  # noqa: E731
    before = cuda_rect_accelerations_mxu.launches
    got = cuda_accelerations(t(pos), t(mass), G=1.0, use_mxu=True,
                             eps2_per_body=t(eps2) if per_body else None)
    assert cuda_rect_accelerations_mxu.launches == before
    assert _rel(got.numpy(), want) < 2e-3
    if not per_body:
        np.testing.assert_allclose(got.numpy(), oracle.accel_exhaustive(pos, mass, G=1.0),
                                   atol=2e-3 * np.abs(want).max())


def test_k2_plain_equals_k1_plain_in_exact_arithmetic():
    """In f64 the re-associated sum is the displacement form's to rounding:
    K2's plain version within 1e-12 of K1's."""
    arr = random_cloud(400, seed=12)
    p = torch.as_tensor(arr[:, :3], dtype=torch.float64)
    m = torch.as_tensor(arr[:, 6], dtype=torch.float64)
    a_mxu = rect_accelerations_mxu_reference(p, p, m, G=0.7, block_j=96)
    a_k1 = port.rect_accelerations(p, p, m, G=0.7, mode="chunked")
    assert _rel(a_mxu.numpy(), a_k1.numpy()) < 1e-12


def test_backend_torch_force_matches_jnp_where_the_expanded_form_cancels():
    """The CLI's --backend torch force (``exhaustive_accelerations``, auto)
    is JAX's --backend jnp force even where the two forms part: on a cloud
    offset to (300, 300, 300), |r|^2 expanded loses most of its digits, and
    the displacement form the port took before (``chunked``) lies more than
    half the force scale from JAX's result.  The port's expanded |r|^2
    rounds as XLA's bit for bit, so what is left is the matmul and row-sum
    order, bounded here by 1e-2."""
    arr = random_cloud(2100, seed=8)
    pos, mass = arr[:, :3] + 300.0, arr[:, 6]
    want = jax_exh.exhaustive_accelerations(jnp.asarray(pos, jnp.float32),
                                            jnp.asarray(mass, jnp.float32), G=1.0)
    p = torch.as_tensor(pos, dtype=torch.float32)
    m = torch.as_tensor(mass, dtype=torch.float32)
    assert _rel(port.exhaustive_accelerations(p, m, G=1.0).numpy(), want) < 1e-2
    assert _rel(port.exhaustive_accelerations(p, m, G=1.0, mode="chunked").numpy(), want) > 0.5
