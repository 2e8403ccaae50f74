"""The port's CUDA kernel sources, run on the CPU under an emulation of the
CUDA execution model (EMU_HEADER below: one std::thread per CUDA thread, a
barrier for __syncthreads), against their plain PyTorch twins.

This checks the kernels' indexing, ragged-edge masking, tiling and
reductions wherever the tests run.  It is not the card: the kernels
themselves are built with nvcc and checked on the card by
test_torch_cuda.py and chip_smoke.py.
"""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from conftest import random_cloud
from nbody_tpu_torch.diag.energy import potential_energy_reference
from nbody_tpu_torch.ops import _cuda, barneshut, bh_fused, bh_fused_df, cuda_lists
from nbody_tpu_torch.ops.cuda_exhaustive import (
    rect_accelerations_mxu_reference,
    rect_accelerations_reference,
)
from nbody_tpu_torch.ops.exhaustive import rect_accelerations


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs a worker per core, and torch's
    default of a thread per core in every worker oversubscribes the host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# Stands in for <cuda_runtime.h> when the .cu sources are built with g++.
EMU_HEADER = r"""// CPU emulation of the CUDA features the port's kernels use.  Each CUDA
// thread is a std::thread; the blocks of a grid (x fastest, then y) run one
// after another, so
// `static` stands in for __shared__ and one buffer per launch for `extern
// __shared__`; __syncthreads is a barrier over the block.  The 32 lanes of
// each warp share an exchange buffer and a warp barrier, for the shuffles,
// __ballot_sync and the twin of allpairs_mma.cu's tensor-core helper
// mma_3xtf32.  bh_fused.cu's asynchronous near-row copies have twins that
// copy synchronously, with a block barrier for the wait.
// It checks the kernels' indexing, masking, fragment mapping and reductions,
// not the card's arithmetic: rsqrtf and rsqrt here are 1/sqrt, and nothing
// is timed.
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__ static
#define __launch_bounds__(...)

struct uint3_ { unsigned x = 0, y = 0, z = 0; };
inline thread_local uint3_ threadIdx, blockIdx, blockDim;

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct alignas(16) float4 { float x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline float rsqrtf(float x) { return 1.0f / std::sqrt(x); }
inline double rsqrt(double x) { return 1.0 / std::sqrt(x); }
inline float __int_as_float(int i) { float f; std::memcpy(&f, &i, sizeof f); return f; }
inline float __uint_as_float(unsigned u) { float f; std::memcpy(&f, &u, sizeof f); return f; }
inline unsigned __float_as_uint(float f) { unsigned u; std::memcpy(&u, &f, sizeof u); return u; }
// round-to-nearest single operations: plain operators (g++ does not contract
// them into FMAs for the x86-64 baseline)
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
using std::max;
using std::min;

inline std::barrier<>* emu_block_barrier = nullptr;
inline void __syncthreads() { emu_block_barrier->arrive_and_wait(); }
// `extern __shared__` dynamic shared memory of the running block
inline unsigned char* emu_dynamic_smem = nullptr;

// The running thread's warp: its lanes' exchange slots and barrier.
struct EmuWarp {
  std::barrier<> bar;
  float a[32][4], b[32][2];
  unsigned u[2][32];  // exchange slots, alternating from one exchange to the next
  explicit EmuWarp(int lanes) : bar(lanes) {}
};
inline thread_local EmuWarp* emu_warp = nullptr;
inline thread_local unsigned emu_exchanges = 0;  // this lane's exchanges so far

// The warp's slots for this exchange: every lane posts, the warp meets once,
// every lane reads.  A lane can post the next exchange while another still
// reads this one, because the two use other slots, and the one after meets
// first.
inline unsigned* emu_post(unsigned bits) {
  unsigned* slots = emu_warp->u[emu_exchanges++ & 1];
  slots[threadIdx.x & 31] = bits;
  emu_warp->bar.arrive_and_wait();
  return slots;
}

// Every lane posts `v`; the lane gets lane `src_lane`'s.
template <class T>
T emu_exchange(T v, int src_lane) {
  unsigned bits;
  std::memcpy(&bits, &v, sizeof bits);
  bits = emu_post(bits)[src_lane & 31];
  T got;
  std::memcpy(&got, &bits, sizeof got);
  return got;
}
inline float __shfl_sync(unsigned, float v, int src_lane) { return emu_exchange(v, src_lane); }
inline int __shfl_sync(unsigned, int v, int src_lane) { return emu_exchange(v, src_lane); }
inline float __shfl_xor_sync(unsigned, float v, int mask) {
  return emu_exchange(v, static_cast<int>(threadIdx.x & 31) ^ mask);
}
// lanes below `delta` keep their own value, as on the card
inline int __shfl_up_sync(unsigned, int v, unsigned delta) {
  const int lane = threadIdx.x & 31;
  return emu_exchange(v, lane >= static_cast<int>(delta) ? lane - static_cast<int>(delta) : lane);
}
inline unsigned __ballot_sync(unsigned, int pred) {
  const unsigned* slots = emu_post(pred ? 1u : 0u);
  unsigned m = 0;
  for (int l = 0; l < 32; ++l) m |= slots[l] << l;
  return m;
}
inline int __popc(unsigned m) { return __builtin_popcount(m); }

// Twins of bh_fused.cu's near-row ring: the copy is synchronous, and the
// wait, which every thread of the block calls, is a block barrier that
// publishes the rows the other threads copied.
#define NBODY_EMULATED_ASYNC_COPY 1
inline void ring_init(unsigned long long*) {}
inline void ring_expect(unsigned long long*, unsigned) {}
inline void ring_copy(float4* dst, const float4* src, int rows, unsigned long long*) {
  std::memcpy(dst, src, sizeof(float4) * rows);
}
inline void ring_wait(unsigned long long*, unsigned) { __syncthreads(); }

// cvt.rna.tf32.f32: round to 10 mantissa bits, to nearest, ties away from 0
inline float emu_tf32(float v) {
  return __uint_as_float((__float_as_uint(v) + 0x1000u) & ~0x1fffu);
}

// Twin of allpairs_mma.cu's mma_3xtf32, c += a @ b over the warp's
// m16n8k8 fragments (PTX ISA layout for .tf32): lane (g, t) = (lane / 4,
// lane % 4) holds A's a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8,
// t + 4), B's b0 (t, g), b1 (t + 4, g), and C's c0 (g, 2t), c1 (g, 2t + 1),
// c2 (g + 8, 2t), c3 (g + 8, 2t + 1).  Each lane posts its fragments, the
// warp meets, each lane computes its four C entries in 3xTF32 (lo·hi, hi·lo,
// then hi·hi added to c, as the three mma.sync of the helper), and the warp
// meets again before the slots are reused.
#define NBODY_EMULATED_MMA 1
inline void mma_3xtf32(float c[4], const float a[4], const float b[2]) {
  EmuWarp& w = *emu_warp;
  const unsigned lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int q = 0; q < 4; ++q) w.a[lane][q] = a[q];
  w.b[lane][0] = b[0];
  w.b[lane][1] = b[1];
  w.bar.arrive_and_wait();
  auto A = [&](int row, int k) { return w.a[(row & 7) * 4 + (k & 3)][(row >> 3) + 2 * (k >> 2)]; };
  auto B = [&](int k, int col) { return w.b[col * 4 + (k & 3)][k >> 2]; };
  for (int q = 0; q < 4; ++q) {
    const int row = g + 8 * (q >> 1), col = 2 * t + (q & 1);
    float lh = 0.f, hl = 0.f, hh = 0.f;
    for (int k = 0; k < 8; ++k) {
      const float ah = emu_tf32(A(row, k)), bh = emu_tf32(B(k, col));
      const float al = emu_tf32(A(row, k) - ah), bl = emu_tf32(B(k, col) - bh);
      lh += al * bh;
      hl += ah * bl;
      hh += ah * bh;
    }
    c[q] += lh;
    c[q] += hl;
    c[q] += hh;
  }
  w.bar.arrive_and_wait();
}

typedef struct CUstream_st* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class K>
cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int) { return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "no error"; }

// Stands in for `kernel<<<grid, block, ...>>>(args)`.
template <class F>
void emu_launch(dim3 grid, int block, size_t smem_bytes, F body) {
  std::vector<double> smem(smem_bytes / sizeof(double) + 1);
  emu_dynamic_smem = reinterpret_cast<unsigned char*>(smem.data());
  for (unsigned by = 0; by < grid.y; ++by) {
    for (unsigned b = 0; b < grid.x; ++b) {
      std::barrier<> bar(block);
      emu_block_barrier = &bar;
      std::vector<std::unique_ptr<EmuWarp>> warps;
      for (int w = 0; w < block; w += 32)
        warps.push_back(std::make_unique<EmuWarp>(std::min(32, block - w)));
      std::vector<std::thread> threads;
      for (int t = 0; t < block; ++t) {
        threads.emplace_back([&, t, b, by] {
          emu_warp = warps[t / 32].get();
          threadIdx.x = t;
          blockIdx.x = b;
          blockIdx.y = by;
          blockDim.x = block;
          body();
        });
      }
      for (auto& th : threads) th.join();
    }
  }
}
"""
_LAUNCH = re.compile(r"(\w+(?:<\w+>)?)<<<(.*?)>>>\((.*?)\);", re.S)
_DYNAMIC_SMEM = re.compile(
    r"extern\s+__shared__\s+(?:__align__\(\d+\)\s+)?([\w ]+?)\s+(\w+)\[\];")


def _host_source(path: str) -> str:
    """The .cu source with each `k<<<grid, block, smem, stream>>>(args);`
    launch rewritten as an emulated launch, and each `extern __shared__`
    array bound to the block's dynamic shared memory."""
    with open(path) as f:
        src = f.read()

    def launch(m):
        grid, block, smem = (a.strip() for a in m.group(2).split(",")[:3])
        return (f"emu_launch(dim3({grid}), {block}, {smem}, "
                f"[&] {{ {m.group(1)}({m.group(3)}); }});")

    src = _DYNAMIC_SMEM.sub(
        lambda m: f"{m.group(1)}* {m.group(2)} = "
        f"reinterpret_cast<{m.group(1)}*>(emu_dynamic_smem);", src)
    return _LAUNCH.sub(launch, src)


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ is needed to build the emulated kernels")
    d = tmp_path_factory.mktemp("emu")
    (d / "cuda_runtime.h").write_text(EMU_HEADER)
    cpps = []
    for cu in _cuda.sources():
        cpp = d / (os.path.basename(cu)[:-3] + ".cpp")
        cpp.write_text(_host_source(cu))
        cpps.append(str(cpp))
    so = d / "emu.so"
    r = subprocess.run(
        ["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
         "-I", str(d), *cpps, "-o", str(so)],
        capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stderr
    return _cuda.bind(ctypes.CDLL(str(so)))


def _f32(a):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32)


def _f64(a):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float64)


def _emu_allpairs(lib, pos_i, pos_j, mass_j, eps2, eps2_i=None, eps2_j=None):
    gm = mass_j * 1.0  # G = 1 folded in, as the wrapper does
    out = torch.full((pos_i.shape[0], 3), float("nan"))
    err = lib.nbody_allpairs_f32(
        pos_i.data_ptr(), pos_j.data_ptr(), gm.data_ptr(),
        None if eps2_i is None else eps2_i.data_ptr(),
        None if eps2_j is None else eps2_j.data_ptr(),
        eps2, pos_i.shape[0], pos_j.shape[0], out.data_ptr(), None,
    )
    assert err == 0
    return out


@pytest.mark.parametrize("m,n", [(1, 1), (137, 300), (256, 256), (300, 517)])
@pytest.mark.parametrize("per_body", [False, True])
def test_allpairs_kernel_source(emu, m, n, per_body):
    """Within the kernel's f32 bound of its twin (test_pallas.py:25)."""
    arr = random_cloud(max(m, n), seed=m + n)
    pos_j, mass_j = _f32(arr[:n, :3]), _f32(arr[:n, 6])
    pos_i = _f32(arr[:m, :3])
    kw = {}
    if per_body:
        e = np.random.default_rng(m).uniform(1e-4, 1e-2, max(m, n))
        kw = dict(eps2_i=_f32(e[:m]), eps2_all=_f32(e[:n]))
    got = _emu_allpairs(emu, pos_i, pos_j, mass_j, 0.01, kw.get("eps2_i"),
                        kw.get("eps2_all"))
    want = rect_accelerations_reference(pos_i, pos_j, mass_j, **kw)
    scale = want.abs().max().item()
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5 * scale,
                               rtol=2e-4)


def _emu_allpairs_mma(lib, pos_i, pos_j, mass_j, eps2, eps2_i=None, eps2_j=None):
    out = torch.full((pos_i.shape[0], 3), float("nan"))
    err = lib.nbody_allpairs_mma_f32(
        pos_i.data_ptr(), pos_j.data_ptr(), mass_j.data_ptr(),  # G = 1
        None if eps2_i is None else eps2_i.data_ptr(),
        None if eps2_j is None else eps2_j.data_ptr(),
        eps2, pos_i.shape[0], pos_j.shape[0], out.data_ptr(), None,
    )
    assert err == 0
    return out


@pytest.mark.parametrize("m,n", [(1, 9), (137, 300), (300, 517)])
@pytest.mark.parametrize("per_body", [False, True])
def test_allpairs_mma_kernel_source(emu, m, n, per_body):
    """K2 (tensor-core j-sum) within K1's bound of its plain version, on
    unaligned, asymmetric rectangles (m not a multiple of the 16-row tile,
    n not of the 8-source k-step or the 256-row tile), so a wrong lane to
    fragment (row, column) map cannot pass.  The targets are not sources:
    at these tiny force scales the softened self-term's weight G m / eps^3,
    which the W @ [x 1] - x * sum(w) form cancels in 3xTF32, would set the
    error (the card checks that case at the main path's scale)."""
    arr = random_cloud(m + n, seed=3 * m + n)
    arr[:, :3] += np.array([0.5, -0.25, 0.125])  # off the origin, asymmetric
    pos_j, mass_j = _f32(arr[m:, :3]), _f32(arr[m:, 6])
    pos_i = _f32(arr[:m, :3])
    kw = {}
    if per_body:
        e = np.random.default_rng(m).uniform(1e-3, 1e-2, m + n)
        kw = dict(eps2_i=_f32(e[:m]), eps2_all=_f32(e[m:]))
    got = _emu_allpairs_mma(emu, pos_i, pos_j, mass_j, 0.01, kw.get("eps2_i"),
                            kw.get("eps2_all"))
    want = rect_accelerations_mxu_reference(pos_i, pos_j, mass_j, G=1.0, **kw)
    scale = want.abs().max().item()
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5 * scale,
                               rtol=2e-4)


def test_allpairs_kernel_source_empty(emu):
    out = _emu_allpairs(emu, torch.zeros((0, 3)), torch.zeros((4, 3)),
                        torch.ones(4), 0.01)
    assert out.shape == (0, 3)


@pytest.mark.parametrize("n", [1, 255, 256, 700])
def test_potential_kernel_source(emu, n):
    """Within the kernel's f32 bound of its twin (test_energy.py:70), with a
    coincident pair exercising the r = 0 guard."""
    arr = random_cloud(n, seed=n)
    if n > 2:
        arr[1, :3] = arr[0, :3]
    pos, mass = _f32(arr[:, :3]), _f32(arr[:, 6])
    partials = torch.zeros(emu.nbody_potential_partials(n), dtype=torch.float64)
    out = torch.full((1,), float("nan"), dtype=torch.float64)
    assert emu.nbody_potential_f32(pos.data_ptr(), mass.data_ptr(), n,
                                   partials.data_ptr(), out.data_ptr(), None) == 0
    got = 0.5 * out.item()  # G = 1 and the 1/2 the wrapper applies
    want = potential_energy_reference(pos, mass).item()
    assert got == pytest.approx(want, rel=1e-5, abs=1e-12)


def test_potential_kernel_source_is_deterministic(emu):
    arr = random_cloud(600, seed=1)
    pos, mass = _f32(arr[:, :3]), _f32(arr[:, 6])
    results = []
    for _ in range(2):
        partials = torch.zeros(emu.nbody_potential_partials(600),
                               dtype=torch.float64)
        out = torch.zeros(1, dtype=torch.float64)
        emu.nbody_potential_f32(pos.data_ptr(), mass.data_ptr(), 600,
                                partials.data_ptr(), out.data_ptr(), None)
        results.append(out.item())
    assert results[0] == results[1]


def _bh_case(name):
    """(pos, mass, group_size, ld, leaf_cap, frontier_cap) of a small fused
    Barnes-Hut case."""
    rng = np.random.default_rng(21)
    if name == "uniform":  # far cells, partial and empty groups
        pos = rng.uniform(-2, 2, (400, 3))
        return pos, rng.uniform(0.1, 1, 400), 64, 3, 8, 2048
    if name == "cluster":  # an over-full terminal cell ships its bodies
        pos = np.vstack([rng.normal(0, 1e-4, (100, 3)),
                         rng.uniform(-1, 1, (20, 3)) * 50])
        return pos, rng.uniform(0.1, 1, 120), 64, 3, 8, 2048
    if name == "one":  # a lone body far out makes a 1-body group
        pos = np.vstack([rng.uniform(-1, 1, (150, 3)), [[40.0, 40.0, 40.0]]])
        return pos, rng.uniform(0.1, 1, 151), 16, 3, 8, 2048
    if name == "odd":  # B = 97: two warps, odd group sizes
        pos = rng.uniform(-2, 2, (500, 3))
        return pos, rng.uniform(0.1, 1, 500), 97, 3, 8, 2048
    if name == "full1024":  # 1,024-body groups: 512 threads x 2 bodies
        pos = rng.uniform(-2, 2, (2500, 3))
        return pos, rng.uniform(0.1, 1, 2500), 1024, 3, 8, 2048
    if name == "longrun":  # a 700-body terminal cell: a run over two stages
        pos = np.vstack([rng.normal(0, 1e-4, (700, 3)),
                         rng.uniform(-1, 1, (60, 3)) * 50])
        return pos, rng.uniform(0.1, 1, 760), 256, 3, 8, 2048
    # a frontier wider than the 128-cell cap: the overflow lane reports it
    pos = rng.uniform(-2, 2, (2000, 3))
    return pos, rng.uniform(0.1, 1, 2000), 64, 4, 1, 128


def _bh_check_cuts(lib, fi, kw, bound):
    """Every stage cut of K6's source (f32, or the df mode for f64 tables)
    against the plain version on the same tables and groups: the
    stats of "full" in every cut but "none" (zero there), zero forces short
    of "full"; "full" through the cut entry bit-identical to the production
    entry (a rerun of the same instantiation) and, in f32, to the
    production entry taking the slots in reverse order; within `bound`(got,
    want) of the plain version.  Returns the stats."""
    want, want_stats = bh_fused.fused_group_forces_reference(
        fi.tree, fi.gstart, fi.gcount, fi.src, fi.bsq, **kw)
    args = (lib, fi.tree, fi.gstart, fi.gcount, fi.src, fi.bsq, None)
    for cut in bh_fused.CUTS:
        err, got, stats = bh_fused.launch(*args, debug_mode=cut, cut_entry=True, **kw)
        assert err == 0
        if cut == "none":
            assert not stats.any()
        else:
            np.testing.assert_array_equal(stats.numpy(), want_stats.numpy(), cut)
        if cut != "full":
            assert not got.any(), cut
    err, prod, prod_stats = bh_fused.launch(*args, **kw)
    assert err == 0
    assert torch.equal(prod, got) and torch.equal(prod_stats, stats)
    if fi.src.dtype == torch.float32:  # slots taken in reverse: the same bits
        order = torch.arange(len(fi.gcount) - 1, -1, -1, dtype=torch.int32)
        err, ordered, ordered_stats = bh_fused.launch(*args, order=order, **kw)
        assert err == 0
        assert torch.equal(ordered, got) and torch.equal(ordered_stats, stats)
    if int(stats[:, bh_fused.S_OVF].max()) <= kw["frontier_cap"]:
        bound(got, want)  # past the cap both drop the same cells; forces are moot
    return stats


def _f32_bound(got, want):
    scale = want.abs().max().item()
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5 * scale, rtol=2e-4)


def _f64_bound(got, want):
    assert (got - want).abs().max().item() <= 1e-12 * want.abs().max().item()


@pytest.mark.parametrize("name", ["uniform", "cluster", "overflow", "one", "odd",
                                  "full1024", "longrun"])
def test_bh_fused_kernel_source(emu, name):
    """K6 f32 against its plain version on the same tables and groups, at
    every stage cut: equal stats lanes (the MAC is written without contraction,
    so the decisions match), accelerations within K1's bound."""
    pos, mass, b, ld, leaf_cap, fcap = _bh_case(name)
    fi = bh_fused.prepare_fused(_f32(pos), _f32(mass), ld=ld, group_size=b)
    kw = dict(theta=0.5, eps2=0.01, leaf_cap=leaf_cap, ld=ld, group_size=b,
              frontier_cap=fcap)
    stats = _bh_check_cuts(emu, fi, kw, _f32_bound)
    gcount = fi.gcount.numpy()
    if name in ("uniform", "cluster", "overflow"):
        assert (gcount == 0).sum() > 0  # empty groups took part
    if name == "uniform":
        assert int(stats[:, bh_fused.S_FAR].sum()) > 0
        assert ((gcount % b != 0) & (gcount > 0)).sum() > 1  # partial groups
    if name == "one":
        assert (gcount == 1).sum() >= 1
    if name == "odd":
        assert (gcount % 2 == 1).sum() >= 1 and gcount.max() > 64
    if name == "full1024":
        assert (gcount == 1024).sum() >= 2
    if name == "longrun":  # one staged run outgrows a 512-row stage
        assert int(stats[:, bh_fused.S_NEAR].max()) > 700
    if name == "overflow":
        assert int(stats[:, bh_fused.S_OVF].max()) > 128


@pytest.mark.parametrize("m,n", [(1, 1), (137, 300), (300, 517)])
def test_allpairs_f64_kernel_source(emu, m, n):
    """K4 within 1e-12 of its plain version (test_pallas_df.py:47), with a
    target coincident with a source (the zero self-term)."""
    arr = random_cloud(max(m, n), seed=m + n)
    pos_i, pos_j, mass_j = _f64(arr[:m, :3]), _f64(arr[:n, :3]), _f64(arr[:n, 6])
    out = torch.full((m, 3), float("nan"), dtype=torch.float64)
    gm = 0.7 * mass_j  # G folded in, as the wrapper does
    assert emu.nbody_allpairs_f64(pos_i.data_ptr(), pos_j.data_ptr(), gm.data_ptr(),
                                  0.01, m, n, out.data_ptr(), None) == 0
    want = rect_accelerations(pos_i, pos_j, mass_j, G=0.7)
    scale = want.abs().max().item()
    assert (out - want).abs().max().item() <= 1e-12 * scale


@pytest.mark.parametrize("n", [1, 255, 700])
def test_potential_f64_kernel_source(emu, n):
    """K5 within 1e-13 of its plain version, with a coincident pair
    exercising the r = 0 guard; reruns are bit-identical."""
    arr = random_cloud(n, seed=n)
    if n > 2:
        arr[1, :3] = arr[0, :3]
    pos, mass = _f64(arr[:, :3]), _f64(arr[:, 6])
    results = []
    for _ in range(2):
        partials = torch.zeros(emu.nbody_potential_f64_partials(n), dtype=torch.float64)
        out = torch.full((1,), float("nan"), dtype=torch.float64)
        assert emu.nbody_potential_f64(pos.data_ptr(), mass.data_ptr(), n,
                                       partials.data_ptr(), out.data_ptr(), None) == 0
        results.append(0.5 * out.item())  # G = 1 and the 1/2 the wrapper applies
    want = potential_energy_reference(pos, mass).item()
    assert results[0] == results[1]
    assert results[0] == pytest.approx(want, rel=1e-13, abs=1e-300)


@pytest.mark.parametrize("name", ["uniform", "cluster", "overflow"])
def test_bh_fused_df_kernel_source(emu, name):
    """K6's df mode (two bodies per thread) against its plain version on the
    same f64 tables and groups, at every stage cut: equal stats lanes,
    accelerations within 1e-12 of the force scale."""
    pos, mass, b, ld, leaf_cap, fcap = _bh_case(name)
    fi = bh_fused.prepare_fused(_f64(pos), _f64(mass), ld=ld, group_size=b)
    assert fi.src.dtype == fi.tree.cx.dtype == torch.float64
    assert fi.bsq.dtype == torch.float32
    kw = dict(theta=0.5, eps2=0.01, leaf_cap=leaf_cap, ld=ld, group_size=b,
              frontier_cap=fcap)
    stats = _bh_check_cuts(emu, fi, kw, _f64_bound)
    if name == "uniform":
        assert int(stats[:, bh_fused.S_FAR].sum()) > 0
    if name == "overflow":
        assert int(stats[:, bh_fused.S_OVF].max()) > 128


def test_bh_fused_unknown_debug_mode_raises():
    """A stage cut the JAX kernel does not have is refused, by the wrappers
    and by the plain version, before anything runs."""
    fi = bh_fused.prepare_fused(_f32(np.eye(3)), _f32(np.ones(3)), ld=2, group_size=64)
    kw = dict(theta=0.5, eps2=0.01, leaf_cap=8, ld=2, group_size=64, debug_mode="eval")
    args = (fi.tree, fi.gstart, fi.gcount, fi.src, fi.bsq)
    for fn in (bh_fused.fused_group_forces, bh_fused.fused_group_forces_reference,
               bh_fused_df.fused_group_forces_df):
        with pytest.raises(ValueError, match="debug_mode"):
            fn(*args, **kw)
    with pytest.raises(ValueError, match="debug_mode"):
        bh_fused.launch(None, *args, None, frontier_cap=128, **kw)


def _lists_case(dtype):
    """Four groups of B = 300 slots (two blocks, the second partial) against
    lists of M = 600 rows: lengths 517 and 300 (not multiples of the
    256-row tile), 0, and the full 600; group 2 holds 200 bodies and 100
    pad slots repeating its first body; each group's list holds one of its
    own bodies (a zero self-term).  Rows past a length are zero, as the
    traversals leave them."""
    rng = np.random.default_rng(17)
    g, b, m = 4, 300, 600
    pg = rng.uniform(-2, 2, (g, b, 3))
    pg[2, 200:] = pg[2, 0]
    lengths = np.array([517, 0, 300, 600], np.int32)
    lists = np.zeros((g, m, 4))
    for k, length in enumerate(lengths):
        lists[k, :length, :3] = rng.uniform(-3, 3, (length, 3))
        lists[k, :length, 3] = rng.uniform(0.04, 1.0, length)
        if length:
            lists[k, length // 2, :3] = pg[k, 7]
    return (torch.as_tensor(pg, dtype=dtype), torch.as_tensor(lists, dtype=dtype),
            torch.as_tensor(lengths))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_group_lists_kernel_source(emu, dtype):
    """K7 against its plain version (which runs the full M): f32 within
    K1's bound, fp64 within 1e-12 of the force scale; a zero-length group
    gets zero; reruns are bit-identical."""
    pg, lists, lengths = _lists_case(dtype)
    err, got = cuda_lists.launch(emu, pg, lists, lengths, None, eps2=0.01)
    assert err == 0 and got.dtype == dtype
    want = barneshut.eval_lists_reference(pg, lists, lengths, eps2=0.01)
    assert torch.equal(got[1], torch.zeros_like(got[1]))
    np.testing.assert_array_equal(got[2, 200:].numpy(),
                                  np.broadcast_to(got[2, 0].numpy(), (100, 3)))
    scale = want.abs().max().item()
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5 * scale, rtol=2e-4)
    else:
        assert (got - want).abs().max().item() <= 1e-12 * scale
    _, again = cuda_lists.launch(emu, pg, lists, lengths, None, eps2=0.01)
    assert torch.equal(again, got)


def test_group_lists_kernel_source_in_the_pipeline(emu):
    """The flat traversal's own lists through K7's source: the whole
    list-based path within K1's bound of the plain path."""
    arr = random_cloud(600, seed=8)
    pos, mass = _f32(arr[:, :3]), _f32(arr[:, 6])

    def emulated(pg, lists, lengths, *, eps2):
        err, out = cuda_lists.launch(emu, pg, lists, lengths, None, eps2=eps2)
        assert err == 0
        return out

    kw = dict(group_size=64, list_size=2048)
    got = barneshut.barneshut_accelerations(pos, mass, group_forces=emulated, **kw)
    want = barneshut.barneshut_accelerations(
        pos, mass, group_forces=barneshut.eval_lists_reference, **kw)
    scale = want.abs().max().item()
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5 * scale, rtol=2e-4)
