"""PyTorch port of the all-pairs force (nbody_tpu_torch/ops/exhaustive.py,
ops/cuda_exhaustive.py) held against the JAX package and the fp64 oracle.

On the CPU the kernel wrapper runs its plain version; the kernel itself is
tested on the card in test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
from conftest import random_cloud
from nbody_tpu.ops import exhaustive as jax_exh
from nbody_tpu_torch.ops import exhaustive as port
from nbody_tpu_torch.ops.cuda_exhaustive import (
    cuda_accelerations,
    cuda_rect_accelerations,
)


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype)


def _j(a, dtype=jnp.float32):
    return jnp.asarray(a, dtype)


# f32 bound of the JAX kernel tests (test_pallas.py:25): rsqrt and the sum
# order differ between implementations, so compare to the force scale.
def _assert_f32_close(got, want):
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=2e-5 * scale, rtol=2e-4)


@pytest.mark.parametrize("n", [100, 1000])
def test_f32_matches_jax(n):
    arr = random_cloud(n, seed=n)
    want = np.asarray(
        jax_exh.direct_accelerations(_j(arr[:, :3]), _j(arr[:, 6]))
    )
    got = port.exhaustive_accelerations(
        _t(arr[:, :3]), _t(arr[:, 6]), chunk=128
    ).numpy()
    _assert_f32_close(got, want)


@pytest.mark.parametrize("n", [10, 100, 333])
@pytest.mark.parametrize("fn", ["direct", "chunked"])
def test_f64_matches_oracle(n, fn):
    arr = random_cloud(n, seed=n)
    pos, mass = _t(arr[:, :3], torch.float64), _t(arr[:, 6], torch.float64)
    if fn == "direct":
        got = port.direct_accelerations(pos, mass)
    else:
        got = port.exhaustive_accelerations(pos, mass, chunk=64)
    want = oracle.accel_exhaustive(arr[:, :3], arr[:, 6])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


def test_f64_matches_jax():
    arr = random_cloud(200, seed=11)
    want = np.asarray(jax_exh.direct_accelerations(
        _j(arr[:, :3], jnp.float64), _j(arr[:, 6], jnp.float64), G=0.7,
        softening_sq=3e-3,
    ))
    got = port.exhaustive_accelerations(
        _t(arr[:, :3], torch.float64), _t(arr[:, 6], torch.float64), G=0.7,
        softening_sq=3e-3, chunk=64,
    )
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


def test_rect_matches_jax():
    arr = random_cloud(300, seed=5)
    pos, mass = arr[:, :3], arr[:, 6]
    want = np.asarray(jax_exh.rect_accelerations(
        _j(pos[:100]), _j(pos), _j(mass), mode="chunked", chunk=64
    ))
    got = port.rect_accelerations(_t(pos[:100]), _t(pos), _t(mass), chunk=64)
    _assert_f32_close(got.numpy(), want)


def _softening_fixture(n, seed=0):
    rng = np.random.default_rng(seed)
    return (
        rng.uniform(-1, 1, (n, 3)),
        rng.uniform(0.1, 1.0, n),
        rng.uniform(1e-4, 1e-2, n),
    )


def _softening_oracle(pos, mass, eps2):
    d = pos[None] - pos[:, None]
    r2 = (d * d).sum(-1) + 0.5 * (eps2[:, None] + eps2[None, :])
    w = r2 ** -1.5 * mass[None]
    np.fill_diagonal(w, 0.0)
    return np.einsum("ij,ijk->ik", w, d)


@pytest.mark.parametrize("fn", ["direct", "chunked", "kernel_twin"])
def test_per_body_softening_matches_oracle(fn):
    """Per-body mode within the JAX bound of 5e-5 relative to the force
    scale (test_softening.py:62,163)."""
    pos, mass, eps2 = _softening_fixture(300)
    want = _softening_oracle(pos, mass, eps2)
    p, m, e = _t(pos), _t(mass), _t(eps2)
    if fn == "direct":
        got = port.direct_accelerations(p, m, eps2_per_body=e)
    elif fn == "chunked":
        got = port.exhaustive_accelerations(p, m, chunk=64, eps2_per_body=e)
    else:
        got = cuda_accelerations(p, m, eps2_per_body=e)
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert err < 5e-5, (fn, err)


def test_per_body_softening_matches_jax():
    pos, mass, eps2 = _softening_fixture(257, seed=3)
    want = np.asarray(jax_exh.direct_accelerations(
        _j(pos), _j(mass), eps2_per_body=_j(eps2)
    ))
    got = port.rect_accelerations(
        _t(pos[:100]), _t(pos), _t(mass), chunk=32, eps2_i=_t(eps2[:100]),
        eps2_all=_t(eps2),
    )
    _assert_f32_close(got.numpy(), want[:100])


def test_uniform_softening_array_equals_scalar():
    pos, mass, _ = _softening_fixture(200, seed=5)
    s = 3e-3
    a_scalar = port.direct_accelerations(_t(pos), _t(mass), softening_sq=s)
    a_array = port.direct_accelerations(
        _t(pos), _t(mass), eps2_per_body=torch.full((200,), s)
    )
    assert torch.equal(a_scalar, a_array)


def test_momentum_conserved_per_body():
    pos, mass, eps2 = _softening_fixture(257, seed=3)
    a = port.direct_accelerations(
        _t(pos), _t(mass), eps2_per_body=_t(eps2)
    ).numpy()
    ptot = np.abs((mass[:, None] * a).sum(0)).max()
    assert ptot < 1e-3 * np.abs(mass[:, None] * a).max(), ptot


def test_zero_mass_bodies_are_inert():
    arr = random_cloud(64, seed=3)
    pos, mass = _t(arr[:, :3], torch.float64), _t(arr[:, 6], torch.float64)
    acc = port.exhaustive_accelerations(pos, mass)
    pos_pad = torch.cat([pos, torch.zeros((16, 3), dtype=torch.float64)])
    mass_pad = torch.cat([mass, torch.zeros((16,), dtype=torch.float64)])
    acc_pad = port.exhaustive_accelerations(pos_pad, mass_pad)
    np.testing.assert_allclose(acc_pad[:64].numpy(), acc.numpy(), rtol=1e-12,
                               atol=1e-12)


def test_self_term_is_zero():
    acc = port.direct_accelerations(
        torch.tensor([[1.0, 2.0, 3.0]], dtype=torch.float64),
        torch.tensor([5.0], dtype=torch.float64),
    )
    assert torch.equal(acc, torch.zeros((1, 3), dtype=torch.float64))


def test_kernel_twin_matches_pallas_interpret():
    """The all-pairs kernel's plain twin against the Pallas kernel it
    replaces, in interpret mode, at the unaligned size of
    test_pallas.py:42-52 (the one interpret-mode case here)."""
    from nbody_tpu.ops.pallas_exhaustive import pallas_accelerations

    arr = random_cloud(137, seed=9)
    want = np.asarray(pallas_accelerations(
        _j(arr[:, :3]), _j(arr[:, 6]), block_i=128, block_j=256,
        interpret=True,
    ))
    before = cuda_rect_accelerations.launches
    got = cuda_accelerations(_t(arr[:, :3]), _t(arr[:, 6])).numpy()
    _assert_f32_close(got, want)
    assert cuda_rect_accelerations.launches == before  # no kernel on the CPU


def test_sass_hot_loop_is_the_unrolled_body():
    """diag.sass takes cuobjdump's listing apart: the hot loop is the
    innermost loop with the most rsqrts (an unrolled body, not its
    remainder loop or the tile loop around both), and per() divides by
    its rsqrts."""
    from nbody_tpu_torch.diag import sass

    ops = ["LDS.128", "FADD", "FFMA", "MUFU.RSQ", "FADD", "MUFU.RSQ", "@P0 BRA 0x20",
           "FFMA", "MUFU.RSQ", "@!P1 BRA 0x90", "BAR.SYNC.DEFER_BLOCKING 0x0",
           "@P2 BRA 0x10", "EXIT", "BRA 0xe0"]
    listing = "\n".join(["\t\tFunction : _Z3fooPf", "/*0000*/  LDC R1, c[0x0][0x28] ;"]
                         + [f"        /*{16 * (k + 2):04x}*/   {op} ;" for k, op in enumerate(ops)])
    (fn, instrs), = sass.kernels(listing).items()
    assert fn == "_Z3fooPf" and len(instrs) == 15
    assert sass.whole(instrs)["MUFU.RSQ"] == 3
    loop = sass.hot_loop(instrs, "MUFU.RSQ")
    assert loop == {"LDS": 1, "FADD": 2, "FFMA": 1, "MUFU.RSQ": 2, "BRA": 1}
    assert sass.per(loop, "MUFU.RSQ", sass.FP32) == 1.5
    assert sass.per(loop, "MUFU.RSQ", None) == 3.5
    assert not sass.hot_loop(instrs, "MUFU.RSQ64H")


def test_sass_counts_each_kernel_apart():
    """diag.sass keeps each function of a listing apart, counts MUFU
    instructions in full (the f32 and fp64 rsqrts apart) and every other
    opcode without its modifiers, and per() takes the fp64 names too."""
    from nbody_tpu_torch.diag import sass

    listing = "\n".join([
        "\t\tFunction : _Z1aPf",
        "        /*0000*/   FADD.FTZ R1, R2, R3 ;",
        "        /*0010*/   MUFU.RSQ R4, R1 ;",
        "        /*0020*/   @!P0 FMUL.FTZ R5, R4, R4 ;",
        "\t\tFunction : _Z1bPd",
        "        /*0000*/   MUFU.RSQ64H R1, R3 ;",
        "        /*0010*/   DFMA.RM R4, R2, R2, R4 ;",
        "        /*0020*/   DMUL R6, R4, R2 ;",
        "        /*0030*/   @P1 BRA 0x0 ;",
    ])
    fns = sass.kernels(listing)
    assert list(fns) == ["_Z1aPf", "_Z1bPd"]
    assert sass.whole(fns["_Z1aPf"]) == {"FADD": 1, "MUFU.RSQ": 1, "FMUL": 1}
    assert sass.per(sass.whole(fns["_Z1aPf"]), "MUFU.RSQ", sass.FP32) == 2
    loop = sass.hot_loop(fns["_Z1bPd"], "MUFU.RSQ64H")
    assert loop == {"MUFU.RSQ64H": 1, "DFMA": 1, "DMUL": 1, "BRA": 1}
    assert sass.per(loop, "MUFU.RSQ64H", sass.FP64) == 2


def test_sass_without_cuobjdump(tmp_path):
    """With no cuobjdump beside nvcc, diag.sass gives None, so the smoke
    run prints no counts and goes on."""
    from nbody_tpu_torch.diag import sass

    nvcc = tmp_path / "nvcc"
    nvcc.write_text("")
    assert sass.cuobjdump_sass(str(nvcc), str(tmp_path / "lib.so")) is None


@pytest.mark.parametrize("case", [
    "f64", "bad_shape", "mass_len", "non_contiguous", "one_sided_eps",
    "eps_len", "mixed_device",
])
def test_kernel_wrapper_refuses_bad_input(case):
    pos = torch.zeros((8, 3))
    mass = torch.ones(8)
    kw = {}
    exc = ValueError
    if case == "f64":
        pos, exc = pos.double(), TypeError
    elif case == "bad_shape":
        pos = torch.zeros((8, 4))
    elif case == "mass_len":
        mass = torch.ones(7)
    elif case == "non_contiguous":
        pos = torch.zeros((3, 8)).t()
    elif case == "one_sided_eps":
        kw = dict(eps2_i=torch.ones(8))
    elif case == "eps_len":
        kw = dict(eps2_i=torch.ones(8), eps2_all=torch.ones(9))
    elif case == "mixed_device":
        mass = torch.ones(8, device="meta")
    with pytest.raises(exc):
        cuda_rect_accelerations(pos, pos, mass, **kw)
