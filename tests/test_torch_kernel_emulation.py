"""The port's CUDA kernel sources, run on the CPU under an emulation of the
CUDA execution model (EMU_HEADER below: one cooperative fiber per CUDA
thread, a barrier for __syncthreads), against their plain PyTorch twins.

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
from nbody_tpu_torch.ops import _cuda, barneshut, bh_fused, bh_fused_df, cuda_lists
from nbody_tpu_torch.ops.cuda_exhaustive import (
    k1_split,
    potential_energy_reference,
    rect_accelerations_mxu_reference,
    rect_accelerations_reference,
)
from nbody_tpu_torch.ops.cuda_fp64 import k4_split
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
// thread is a fiber (ucontext) of one OS thread, run in turns: a thread runs
// until it waits at a barrier, then the next one runs; the blocks of a grid
// (x fastest, then y) run one after another, so
// `static` stands in for __shared__ and one buffer per launch for `extern
// __shared__`; __syncthreads is a barrier over the block.  The 32 lanes of
// each warp share an exchange buffer and a warp barrier, for the shuffles,
// __ballot_sync and the twin of allpairs_mma.cu's tensor-core helper
// mma_tf32.  bh_fused.cu's asynchronous near-row copies have twins that
// copy synchronously, with a block barrier for the wait.
// It checks the kernels' indexing, masking, fragment mapping and reductions,
// not the card's arithmetic: rsqrtf and rsqrt here are 1/sqrt, and nothing
// is timed.
#pragma once
#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstring>
#include <memory>
#include <csetjmp>
#include <ucontext.h>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__ static
#define __launch_bounds__(...)
#define __align__(n) __attribute__((aligned(n)))

struct uint3_ { unsigned x = 0, y = 0, z = 0; };
inline uint3_ threadIdx, blockIdx, blockDim;  // the running fiber's

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct alignas(8) float2 { float x, y; };
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
using std::isfinite;
using std::max;
using std::min;

// The fibers of the running block.  emu_yield hands the turn back to the
// scheduler in emu_launch, which runs the next fiber that has not finished.
// A fiber starts on its own stack through makecontext/swapcontext; after
// that the turns change hands by _setjmp/_longjmp, which leave the signal
// mask alone (swapcontext's system call per switch made the emulation of a
// 256-thread block ~50x slower).
inline jmp_buf emu_main_jb;
inline jmp_buf* emu_running_jb = nullptr;
inline void emu_yield() {
  if (!_setjmp(*emu_running_jb)) _longjmp(emu_main_jb, 1);
}

// A barrier of `count` fibers: each arrival waits, yielding, until the last
// one of its generation arrives.
struct EmuBarrier {
  int count, arrived = 0;
  unsigned generation = 0;
  explicit EmuBarrier(int n) : count(n) {}
  void arrive_and_wait() {
    const unsigned g = generation;
    if (++arrived == count) {
      arrived = 0;
      ++generation;
      return;
    }
    while (generation == g) emu_yield();
  }
};

inline EmuBarrier* emu_block_barrier = nullptr;
inline void __syncthreads() { emu_block_barrier->arrive_and_wait(); }
// `extern __shared__` dynamic shared memory of the running block
inline unsigned char* emu_dynamic_smem = nullptr;

// The running thread's warp: its lanes' exchange slots and barrier.
struct EmuWarp {
  EmuBarrier bar;
  float a[32][4], b[32][2];
  unsigned u[2][32];  // exchange slots, alternating from one exchange to the next
  explicit EmuWarp(int lanes) : bar(lanes) {}
};
inline EmuWarp* emu_warp = nullptr;  // the running fiber's
inline unsigned emu_exchanges = 0;   // the running fiber's exchanges so far

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

// Twins of rsqrt.cuh's seeds, which flush a subnormal input to zero (and
// so give inf).  rsqrt_seed (MUFU.RSQ64H): r2^(-1/2) with the low 32 bits
// of the double cleared, a relative error up to 2^-20, so the refinement to
// fp64 is exercised and not skipped.
#define NBODY_EMULATED_RSQRT 1
template <class T>
inline T emu_ftz(T x) { return std::fpclassify(x) == FP_SUBNORMAL ? std::copysign(T(0), x) : x; }
inline double rsqrt_seed(double r2) {
  const double y = 1.0 / std::sqrt(emu_ftz(r2));
  unsigned long long bits;
  std::memcpy(&bits, &y, sizeof bits);
  bits &= ~0xffffffffull;
  double seed;
  std::memcpy(&seed, &bits, sizeof seed);
  return seed;
}
// rsqrt_ftz (rsqrt.approx.ftz.f32, MUFU.RSQ)
inline float rsqrt_ftz(float x) { return 1.0f / std::sqrt(emu_ftz(x)); }

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

// Twins of allpairs_mma.cu's tensor-core helpers.  tf32_rna is
// cvt.rna.tf32.f32.  mma_tf32 is d += a @ b over the warp's m16n8k8
// fragments (PTX ISA layout for .tf32): lane (g, t) = (lane / 4, lane % 4)
// holds A's a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4), B's
// b0 (t, g), b1 (t + 4, g), and C's c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8,
// 2t), c3 (g + 8, 2t + 1).  The tensor cores read an operand's top 19 bits
// (TF32) and drop the low 13, and so does the twin.  Each lane posts its
// fragments, the warp meets, each lane sums its four C entries in f32, and
// the warp meets again before the slots are reused.
#define NBODY_EMULATED_MMA 1
inline float tf32_rna(float v) { return emu_tf32(v); }
inline float emu_tf32_operand(unsigned bits) { return __uint_as_float(bits & ~0x1fffu); }
inline void mma_tf32(float d[4], const unsigned a[4], float2 b) {
  EmuWarp& w = *emu_warp;
  const unsigned lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int q = 0; q < 4; ++q) w.a[lane][q] = emu_tf32_operand(a[q]);
  w.b[lane][0] = emu_tf32_operand(__float_as_uint(b.x));
  w.b[lane][1] = emu_tf32_operand(__float_as_uint(b.y));
  w.bar.arrive_and_wait();
  auto A = [&](int row, int k) { return w.a[(row & 7) * 4 + (k & 3)][(row >> 3) + 2 * (k >> 2)]; };
  auto B = [&](int k, int col) { return w.b[col * 4 + (k & 3)][k >> 2]; };
  for (int q = 0; q < 4; ++q) {
    const int row = g + 8 * (q >> 1), col = 2 * t + (q & 1);
    float sum = 0.f;
    for (int k = 0; k < 8; ++k) sum += A(row, k) * B(k, col);
    d[q] += sum;
  }
  w.bar.arrive_and_wait();
}

typedef struct CUstream_st* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorInvalidConfiguration = 9 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class K>
cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int) { return cudaSuccess; }
// The emulated card: one SM that holds two blocks of any kernel.  The
// potential-energy kernels are built for one wave of them (emu below), so
// their grids have two blocks, whose shares cross row blocks and tiles.
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
inline cudaError_t cudaGetDevice(int* dev) { *dev = 0; return cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) { *v = 1; return cudaSuccess; }
template <class K>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* blocks, K, int, size_t) {
  *blocks = 2;
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "no error"; }

// One fiber: the kernel body of its CUDA thread.
struct EmuFiber {
  ucontext_t ctx;
  jmp_buf jb;
  std::unique_ptr<char[]> stack;
  unsigned exchanges = 0;
  bool started = false, done = false;
};
constexpr size_t kEmuStack = 1 << 17;
inline void (*emu_body_fn)(void*) = nullptr;
inline void* emu_body_arg = nullptr;
inline EmuFiber* emu_running = nullptr;
inline ucontext_t emu_main_ctx;
inline void emu_fiber_main() {
  emu_body_fn(emu_body_arg);
  emu_running->done = true;
  _longjmp(emu_main_jb, 1);  // never returns: the scheduler takes the turn
}

// Stands in for `kernel<<<grid, block, ...>>>(args)`.
template <class F>
void emu_launch(dim3 grid, int block, size_t smem_bytes, F body) {
  std::vector<double> smem(smem_bytes / sizeof(double) + 1);
  emu_dynamic_smem = reinterpret_cast<unsigned char*>(smem.data());
  emu_body_fn = [](void* f) { (*static_cast<F*>(f))(); };
  emu_body_arg = &body;
  std::vector<EmuFiber> fibers(block);
  for (auto& f : fibers) f.stack.reset(new char[kEmuStack]);
  for (unsigned by = 0; by < grid.y; ++by) {
    for (unsigned b = 0; b < grid.x; ++b) {
      EmuBarrier bar(block);
      emu_block_barrier = &bar;
      std::vector<std::unique_ptr<EmuWarp>> warps;
      for (int w = 0; w < block; w += 32)
        warps.push_back(std::make_unique<EmuWarp>(std::min(32, block - w)));
      for (auto& f : fibers) {
        getcontext(&f.ctx);
        f.ctx.uc_stack.ss_sp = f.stack.get();
        f.ctx.uc_stack.ss_size = kEmuStack;
        f.ctx.uc_link = nullptr;
        makecontext(&f.ctx, emu_fiber_main, 0);
        f.exchanges = 0;
        f.started = f.done = false;
      }
      blockIdx.x = b;
      blockIdx.y = by;
      blockDim.x = block;
      for (int left = block; left > 0;) {
        for (int t = 0; t < block; ++t) {
          EmuFiber& f = fibers[t];
          if (f.done) continue;
          threadIdx.x = t;
          emu_warp = warps[t / 32].get();
          emu_exchanges = f.exchanges;
          emu_running = &f;
          emu_running_jb = &f.jb;
          if (!_setjmp(emu_main_jb)) {
            if (f.started) _longjmp(f.jb, 1);
            f.started = true;
            swapcontext(&emu_main_ctx, &f.ctx);
          }
          f.exchanges = emu_exchanges;
          left -= f.done;
        }
      }
    }
  }
}
"""
_LAUNCH = re.compile(r"(\w+(?:<[^<>]*>)?)<<<(.*?)>>>\((.*?)\);", re.S)
_DYNAMIC_SMEM = re.compile(
    r"extern\s+__shared__\s+(?:__align__\(\d+\)\s+)?([\w ]+?)\s+(\w+)\[\];")


def _host_source(path: str) -> str:
    """The .cu or .cuh source with each `k<<<grid, block, smem, stream>>>(args);`
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
    for h in _cuda.headers():
        (d / os.path.basename(h)).write_text(_host_source(h))
    cpps = []
    for cu in _cuda.sources():
        cpp = d / (os.path.basename(cu)[:-3] + ".cpp")
        cpp.write_text(_host_source(cu))
        cpps.append(str(cpp))
    so = d / "emu.so"
    r = subprocess.run(
        ["g++", "-std=c++20", "-O1", "-U_FORTIFY_SOURCE", "-shared", "-fPIC",
         "-I", str(d), *cpps, "-o", str(so)],
        capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stderr
    return _cuda.bind(ctypes.CDLL(str(so)))


def _f32(a):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32)


def _f64(a):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float64)


def _emu_allpairs(lib, pos_i, pos_j, mass_j, eps2, eps2_i=None, eps2_j=None, split=1):
    gm = mass_j * 1.0  # G = 1 folded in, as the wrapper does
    out = torch.full((pos_i.shape[0], 3), float("nan"))
    err = lib.nbody_allpairs_f32(
        pos_i.data_ptr(), pos_j.data_ptr(), gm.data_ptr(),
        None if eps2_i is None else eps2_i.data_ptr(),
        None if eps2_j is None else eps2_j.data_ptr(),
        eps2, pos_i.shape[0], pos_j.shape[0], split, out.data_ptr(), None,
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


@pytest.mark.parametrize("m,n,split", [(1100, 2500, 1), (137, 300, 4), (700, 4100, 2),
                                       (1100, 9, 8)])
@pytest.mark.parametrize("per_body", [False, True])
def test_allpairs_kernel_source_split(emu, m, n, split, per_body):
    """K1 with the source range of each block split over 1-8 thread
    groups, on m above one block's 512 / split targets (four a thread) and
    ragged m and n (not multiples of a block's targets or of the 2,048-row
    tile, one to three tiles), in scalar and per-body mode: within the
    kernel's f32 bound of its plain version (test_pallas.py:25), reruns
    bit-identical."""
    arr = random_cloud(max(m, n), seed=2 * m + n)
    pos_j, mass_j = _f32(arr[:n, :3]), _f32(arr[:n, 6])
    pos_i = _f32(arr[:m, :3])
    kw = {}
    if per_body:
        e = np.random.default_rng(n).uniform(1e-4, 1e-2, max(m, n))
        kw = dict(eps2_i=_f32(e[:m]), eps2_all=_f32(e[:n]))
    got, again = (_emu_allpairs(emu, pos_i, pos_j, mass_j, 0.01, kw.get("eps2_i"),
                                kw.get("eps2_all"), split) for _ in range(2))
    want = rect_accelerations_reference(pos_i, pos_j, mass_j, **kw)
    scale = want.abs().max().item()
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5 * scale,
                               rtol=2e-4)
    assert torch.equal(got, again)


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


@pytest.mark.parametrize("m,n", [(1, 9), (137, 300), (300, 517), (64, 64), (65, 65),
                                 (256, 512), (257, 513)])
@pytest.mark.parametrize("per_body", [False, True])
def test_allpairs_mma_kernel_source(emu, m, n, per_body):
    """K2 (tensor-core j-sum) within K1's bound of its plain version, on
    unaligned, asymmetric rectangles (m not a multiple of the 16-row tile,
    n not of the 8-source k-step or the 512-row tile), so a wrong lane to
    fragment (row, column) map cannot pass, and on the tile edges and one
    past them: a warp's 64 rows, a block's 256, a tensor-core chain's 64
    sources and a tile's 512.  The targets are not sources: at these tiny
    force scales the softened self-term's weight G m / eps^3, which the W @
    [x 1] - x * sum(w) form cancels in 3xTF32, would set the error (the
    card checks that case at the main path's scale)."""
    _check_mma_case(emu, m, n, per_body, (0.5, -0.25, 0.125),
                    rect_accelerations_mxu_reference)


@pytest.mark.parametrize("per_body", [False, True])
def test_allpairs_mma_kernel_source_off_origin(emu, per_body):
    """K2 on a cloud at chip_smoke.py's offset (8, -8, 8) from the origin,
    where the columns' offsets from the block's first target, not the
    coordinates, keep the tensor cores' sums small: within K1's bound of
    K1's plain version (the displacement form).  K2's own plain version,
    W @ [x y z 1] - x * sum(w) in f32, is off by its own cancellation
    here, ~7e-5 of the force scale against the fp64 formula."""
    _check_mma_case(emu, 300, 517, per_body, (8.0, -8.0, 8.0),
                    rect_accelerations_reference)


def _check_mma_case(emu, m, n, per_body, offset, plain):
    """K2's source on m targets and n other sources of a random cloud moved
    by `offset` (asymmetric), against the plain version `plain`."""
    arr = random_cloud(m + n, seed=3 * m + n)
    arr[:, :3] += np.array(offset)
    pos_j, mass_j = _f32(arr[m:, :3]), _f32(arr[m:, 6])
    pos_i = _f32(arr[:m, :3])
    kw = {}
    if per_body:
        e = np.random.default_rng(m).uniform(1e-3, 1e-2, m + n)
        kw = dict(eps2_i=_f32(e[:m]), eps2_all=_f32(e[m:]))
    got = _emu_allpairs_mma(emu, pos_i, pos_j, mass_j, 0.01, kw.get("eps2_i"),
                            kw.get("eps2_all"))
    want = plain(pos_i, pos_j, mass_j, G=1.0, **kw)
    scale = want.abs().max().item()
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5 * scale,
                               rtol=2e-4)


@pytest.mark.parametrize("pick,args,split", [
    (k1_split, (100_000, 132), 8), (k1_split, (1_000_000, 132), 1),
    (k1_split, (1, 132), 8), (k4_split, (100_000, 132), 4),
    (k4_split, (1_000_000, 132), 1), (k4_split, (1, 132), 8),
    (cuda_lists.k7_split, (120, 1792, 132), 8), (cuda_lists.k7_split, (1001, 2048, 132), 4),
    (cuda_lists.k7_split, (1, 64, 132), 8)])
def test_split_picks(pick, args, split):
    """The source (list) slices a block that K1, K4 and K7 (both entries)
    take on a 132-SM card: at the 100k main path (K7: its 120 groups of B
    = 1,792), at 1M (K1 and K4: the robust path's 1M-target rectangle; K7:
    1,001 groups of B = 2,048) and at a single target or group."""
    assert pick(*args) == split


def test_allpairs_kernel_source_empty(emu):
    out = _emu_allpairs(emu, torch.zeros((0, 3)), torch.zeros((4, 3)),
                        torch.ones(4), 0.01)
    assert out.shape == (0, 3)


@pytest.mark.parametrize("n", [1, 2, 255, 256, 511, 513, 700, 2100])
def test_potential_kernel_source(emu, n):
    """Within the kernel's f32 bound of its twin (test_energy.py:70), with a
    coincident pair exercising the r = 0 guard; n across the 512-row row
    blocks (one short, one over, four and a bit) and the 2,048-row tile."""
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


def _emu_potential(lib, pos, mass, guard=4):
    """(0.5 * out, partials) of the emulated K3 (f32 inputs) or K5 (fp64),
    the partials NaN-filled first, with `guard` NaN slots past
    ``*_partials(n)``."""
    f64 = pos.dtype == torch.float64
    n = pos.shape[0]
    count = (lib.nbody_potential_f64_partials if f64 else lib.nbody_potential_partials)(n)
    partials = torch.full((count + guard,), float("nan"), dtype=torch.float64)
    out = torch.full((1,), float("nan"), dtype=torch.float64)
    launch = lib.nbody_potential_f64 if f64 else lib.nbody_potential_f32
    assert launch(pos.data_ptr(), mass.data_ptr(), n, partials.data_ptr(),
                  out.data_ptr(), None) == 0
    return 0.5 * out.item(), partials  # G = 1 and the 1/2 the wrapper applies


@pytest.mark.parametrize("n", [0, 1, 2, 300, 513, 2100])
@pytest.mark.parametrize("f64", [False, True])
def test_potential_partials_match_the_grid(emu, n, f64):
    """``*_partials(n)`` is the grid of the launch: every block writes its
    own slot, so all of them are set and none past them.  On the emulated
    card (one SM of two resident blocks, 16 waves) a grid is 32 blocks at
    most, one for every 512 (row block, source) items of the triangle below
    that: at n = 2,100, 11 shares that cross row blocks and tiles."""
    arr = random_cloud(max(n, 1), seed=n)[:n]
    conv = _f64 if f64 else _f32
    _, partials = _emu_potential(emu, conv(arr[:, :3]), conv(arr[:, 6]))
    count = partials.shape[0] - 4
    rows = -(-n // 512)  # 512-row row blocks
    items = rows * n - 512 * (rows * (rows - 1) // 2)
    assert count == min(32, -(-items // 512))
    assert bool(torch.isfinite(partials[:count]).all())
    assert bool(torch.isnan(partials[count:]).all())


@pytest.mark.parametrize("n", [513, 2100])
@pytest.mark.parametrize("f64", [False, True])
def test_potential_kernels_coincident_and_close(emu, n, f64):
    """K3 and K5 where the hardware rsqrt gives inf: coincident bodies in
    one tile (0, 1) and across row blocks and tiles (4, n - 1), and a pair
    whose r^2 is subnormal (1e-40 in f32, 1e-320 in fp64), which the seed
    flushes to 0, with masses that make its term ~1 % of the energy.  The
    rare branch gives the plain version's value: within the f32 bound of
    the twin (K3) or 1e-13 of the plain version (K5), finite, reruns
    bit-identical."""
    arr = random_cloud(n, seed=n + 1)
    arr[1, :3] = arr[0, :3]
    arr[n - 1, :3] = arr[4, :3]
    arr[10, :3] = 0.0
    arr[11, :3] = (1e-160 if f64 else 1e-20, 0.0, 0.0)
    arr[10:12, 6] = 1e-79 if f64 else 1e-9  # m^2 / r = 100
    conv = _f64 if f64 else _f32
    pos, mass = conv(arr[:, :3]), conv(arr[:, 6])
    (got, _), (again, _) = (_emu_potential(emu, pos, mass) for _ in range(2))
    want = potential_energy_reference(pos, mass).item()
    assert np.isfinite(got) and got == again
    assert got == pytest.approx(want, rel=1e-13 if f64 else 1e-5)


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
    if name == "split":  # a dense core: its groups stage far more than the rest
        pos = np.vstack([rng.normal(0, 0.05, (256, 3)), rng.uniform(-2, 2, (200, 3))])
        return pos, rng.uniform(0.1, 1, 456), 128, 3, 8, 2048
    # a frontier wider than the 128-cell cap: the overflow lane reports it
    pos = rng.uniform(-2, 2, (2000, 3))
    return pos, rng.uniform(0.1, 1, 2000), 64, 4, 1, 128


def _warp_pieces(gcount):
    """A df piece table that cuts every occupied group into one-warp
    pieces, in reverse order: a finer cut and another launch order than
    the production table's, which must give the same bits."""
    rows = [(g, b0, min(b0 + 32, c)) for g, c in enumerate(gcount.tolist())
            for b0 in range(0, c, 32)]
    return torch.tensor(rows[::-1], dtype=torch.int32, device=gcount.device)


def _bh_check_cuts(lib, fi, kw, bound):
    """Every stage cut of K6's source (f32, or the df mode for f64 tables)
    against the plain version on the same tables and groups: the
    stats of "full" in every cut but "none" (zero there), zero forces short
    of "full"; "full" through the cut entry bit-identical to the production
    entry (a rerun of the same instantiation) and, in f32, to the
    production entry taking the slots in reverse order; within `bound`(got,
    want) of the plain version.  Returns ("full"'s accelerations, stats)."""
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
    assert _same_bits(prod, got) and torch.equal(prod_stats, stats)
    if fi.src.dtype == torch.float32:  # slots taken in reverse: the same bits
        order = torch.arange(len(fi.gcount) - 1, -1, -1, dtype=torch.int32)
        err, ordered, ordered_stats = bh_fused.launch(*args, order=order, **kw)
        assert err == 0
        assert _same_bits(ordered, got) and torch.equal(ordered_stats, stats)
    else:  # priced, then heaviest first, and one-warp pieces: the same bits
        err, _, est = bh_fused.launch(*args, debug_mode="pops",
                                      pieces=bh_fused.df_pricing_pieces(fi.gcount), **kw)
        assert err == 0 and torch.equal(est, stats)
        for pieces in (bh_fused.df_pieces(fi.gcount, kw["group_size"], est),
                       _warp_pieces(fi.gcount)):
            err, ordered, ordered_stats = bh_fused.launch(*args, pieces=pieces, **kw)
            assert err == 0
            assert _same_bits(ordered, got) and torch.equal(ordered_stats, stats)
    if int(stats[:, bh_fused.S_OVF].max()) <= kw["frontier_cap"]:
        bound(got, want)  # past the cap both drop the same cells; forces are moot
    return got, stats


def _same_bits(a, b):
    """Equal bit for bit, NaNs included (torch.equal holds NaN unequal)."""
    ints = {torch.float32: torch.int32, torch.float64: torch.int64}[a.dtype]
    return a.dtype == b.dtype and torch.equal(a.view(ints), b.view(ints))


def _f32_bound(got, want):
    """NaN exactly where the plain version has NaN; elsewhere within K1's
    bound of it."""
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    if nan.all():
        return
    got, want = got[~nan], want[~nan]
    scale = want.abs().max().item()
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5 * scale, rtol=2e-4)


def _f64_bound(got, want):
    assert (got - want).abs().max().item() <= 1e-12 * want.abs().max().item()


# The softening's edges, on the uniform case: the smallest normal float
# (2^-126), the smallest power of two at which a body's own entry (d = 0)
# stays finite (2^-84: r^-3 = 2^126), and zero.
_BH_EPS2 = {"eps2_min": 2.0 ** -126, "eps2_tiny": 2.0 ** -84, "eps2_zero": 0.0}


@pytest.mark.parametrize("name", ["uniform", "cluster", "overflow", "one", "odd",
                                  "full1024", "longrun", *_BH_EPS2])
def test_bh_fused_kernel_source(emu, name):
    """K6 f32 against its plain version on the same tables and groups, at
    every stage cut: equal stats lanes (the MAC is written without contraction,
    so the decisions match), accelerations within K1's bound.  The pair
    term's rsqrt flushes a subnormal r^2 to zero, and r^2 >= eps2: at a
    normal eps2 it never acts, so the smallest normal eps2 and 2^-84 match
    the plain version (torch.rsqrt, no flush) as 0.01 does.  Below
    2^-85 a body's own entry gives r^-3 = inf and 0 * inf = NaN, with the
    flush or without it: at 2^-126 and at 0 every body is NaN, as in the
    plain version."""
    pos, mass, b, ld, leaf_cap, fcap = _bh_case("uniform" if name in _BH_EPS2 else name)
    fi = bh_fused.prepare_fused(_f32(pos), _f32(mass), ld=ld, group_size=b)
    kw = dict(theta=0.5, eps2=_BH_EPS2.get(name, 0.01), leaf_cap=leaf_cap, ld=ld,
              group_size=b, frontier_cap=fcap)
    got, stats = _bh_check_cuts(emu, fi, kw, _f32_bound)
    if name in ("eps2_min", "eps2_zero"):
        assert bool(torch.isnan(got).all())
    else:
        assert bool(torch.isfinite(got).all())
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


def _emu_allpairs_f64(lib, m, n, split):
    """K4's source on m targets and n sources of a random cloud (G = 0.7),
    run twice, and its plain version."""
    arr = random_cloud(max(m, n), seed=m + n)
    pos_i, pos_j, mass_j = _f64(arr[:m, :3]), _f64(arr[:n, :3]), _f64(arr[:n, 6])
    gm = 0.7 * mass_j  # G folded in, as the wrapper does
    outs = []
    for _ in range(2):
        out = torch.full((m, 3), float("nan"), dtype=torch.float64)
        assert lib.nbody_allpairs_f64(pos_i.data_ptr(), pos_j.data_ptr(), gm.data_ptr(),
                                      0.01, m, n, split, out.data_ptr(), None) == 0
        outs.append(out)
    return outs, rect_accelerations_reference(pos_i, pos_j, mass_j, G=0.7)


@pytest.mark.parametrize("m,n", [(1, 1), (137, 300), (300, 517)])
def test_allpairs_f64_kernel_source(emu, m, n):
    """K4 within 1e-12 of its plain version (test_pallas_df.py:47), with a
    target coincident with a source (the zero self-term)."""
    (out, _), want = _emu_allpairs_f64(emu, m, n, 1)
    scale = want.abs().max().item()
    assert (out - want).abs().max().item() <= 1e-12 * scale


@pytest.mark.parametrize("m,n,split", [(1100, 700, 1), (137, 300, 4), (700, 1100, 2),
                                       (1100, 9, 8)])
def test_allpairs_f64_kernel_source_split(emu, m, n, split):
    """K4 with the source range of each block split over 1-8 thread
    groups, on m above one block's 1,024 / split targets (four a thread)
    and ragged m and n (not multiples of a block's targets or of the
    512-row tile): within 1e-12 of its plain version, reruns
    bit-identical."""
    (out, again), want = _emu_allpairs_f64(emu, m, n, split)
    scale = want.abs().max().item()
    assert (out - want).abs().max().item() <= 1e-12 * scale
    assert torch.equal(out, again)


@pytest.mark.parametrize("n", [1, 2, 255, 511, 513, 700, 2100])
def test_potential_f64_kernel_source(emu, n):
    """K5 within 1e-13 of its plain version, with a coincident pair
    exercising the r = 0 guard; reruns are bit-identical.  n across the
    512-row row blocks and the 512-row tile."""
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


@pytest.mark.parametrize("name", ["uniform", "cluster", "overflow", "one", "odd",
                                  "full1024", "longrun", "split"])
def test_bh_fused_df_kernel_source(emu, name):
    """K6's df mode (a 256-thread block per piece of a group, one body a
    thread) against its plain version on the same f64 tables and groups, at
    every stage cut: equal stats lanes, accelerations within 1e-12 of the
    force scale; the priced launch, its pieces heaviest first and every
    group cut into one-warp pieces, bit-identical to the base pieces in
    slot order."""
    pos, mass, b, ld, leaf_cap, fcap = _bh_case(name)
    fi = bh_fused.prepare_fused(_f64(pos), _f64(mass), ld=ld, group_size=b)
    assert fi.src.dtype == fi.tree.cx.dtype == torch.float64
    assert fi.bsq.dtype == torch.float32
    kw = dict(theta=0.5, eps2=0.01, leaf_cap=leaf_cap, ld=ld, group_size=b,
              frontier_cap=fcap)
    _, stats = _bh_check_cuts(emu, fi, kw, _f64_bound)
    if name == "uniform":
        assert int(stats[:, bh_fused.S_FAR].sum()) > 0
    if name == "overflow":
        assert int(stats[:, bh_fused.S_OVF].max()) > 128
    if name == "full1024":  # four base pieces a group
        assert (fi.gcount == 1024).sum() >= 2
    if name == "split":  # the heaviest group, one base piece, ran as warp pieces
        heavy = int((stats[:, bh_fused.S_SRC].long() * fi.gcount.long()).argmax())
        assert 32 < int(fi.gcount[heavy]) <= bh_fused.DF_THREADS


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
    """Four groups of B = 300 slots (a partial last block of slots at every
    split) against lists of M = 600 rows: lengths 517 and 300 (not
    multiples of a list slice), 0, and the full 600; group 2 holds 200
    bodies and 100 pad slots repeating its first body; each group's list
    holds one of its own bodies (a zero self-term).  Rows past a length are
    zero, as the traversals leave them."""
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


def _check_lists_case(lib, dtype, split=1):
    """K7 on _lists_case against its plain version (which runs the full M):
    f32 within K1's bound, fp64 within 1e-12 of the force scale; a
    zero-length group gets zero, pad slots equal slot 0; reruns are
    bit-identical."""
    pg, lists, lengths = _lists_case(dtype)
    err, got = cuda_lists.launch(lib, pg, lists, lengths, None, eps2=0.01, split=split)
    assert err == 0 and got.dtype == dtype
    want = cuda_lists.eval_lists_reference(pg, lists, lengths, eps2=0.01)
    assert torch.equal(got[1], torch.zeros_like(got[1]))
    np.testing.assert_array_equal(got[2, 200:].numpy(),
                                  np.broadcast_to(got[2, 0].numpy(), (100, 3)))
    scale = want.abs().max().item()
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5 * scale, rtol=2e-4)
    else:
        assert (got - want).abs().max().item() <= 1e-12 * scale
    _, again = cuda_lists.launch(lib, pg, lists, lengths, None, eps2=0.01, split=split)
    assert torch.equal(again, got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_group_lists_kernel_source(emu, dtype):
    """K7 against its plain version (which runs the full M): f32 within
    K1's bound, fp64 within 1e-12 of the force scale; a zero-length group
    gets zero; reruns are bit-identical."""
    _check_lists_case(emu, dtype)


@pytest.mark.parametrize("dtype,split", [
    *(pytest.param(torch.float64, s, id=str(s)) for s in (1, 2, 4, 8)),
    *(pytest.param(torch.float32, s, id=f"f32-{s}") for s in (1, 2, 4, 8))])
def test_group_lists_f64_kernel_source_split(emu, dtype, split):
    """K7's entries (the fp64 one, and the f32 one, ids f32-*) with each
    block's list tiles split over 1-8 thread groups: B = 300 slots is a
    partial last chunk of slots at every split (512 / split a block, four a
    thread), the lengths 517, 0, 300 and 600 are empty, ragged against the
    list slices and full, and group 2 holds pad slots; f32 within K1's
    bound, fp64 within 1e-12 of the force scale, pad slots equal slot 0,
    reruns bit-identical."""
    _check_lists_case(emu, dtype, split)


def _pipeline(lib, dtype):
    """(through K7's source, through the plain version) of the list-based
    path on 600 bodies: the flat traversal's own lists, at the split
    ``k7_split`` takes on a 132-SM card."""
    arr = random_cloud(600, seed=8)
    pos = torch.as_tensor(arr[:, :3], dtype=dtype)
    mass = torch.as_tensor(arr[:, 6], dtype=dtype)

    def emulated(pg, lists, lengths, *, eps2):
        split = cuda_lists.k7_split(pg.shape[0], pg.shape[1], 132)
        err, out = cuda_lists.launch(lib, pg, lists, lengths, None, eps2=eps2,
                                     split=split)
        assert err == 0
        return out

    kw = dict(group_size=64, list_size=2048)
    got = barneshut.barneshut_accelerations(pos, mass, group_forces=emulated, **kw)
    want = barneshut.barneshut_accelerations(
        pos, mass, group_forces=cuda_lists.eval_lists_reference, **kw)
    return got, want


def test_group_lists_kernel_source_in_the_pipeline(emu):
    """The flat traversal's own lists through K7's source: the whole
    list-based path within K1's bound of the plain path."""
    got, want = _pipeline(emu, torch.float32)
    scale = want.abs().max().item()
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5 * scale, rtol=2e-4)


def test_group_lists_kernel_source_in_the_pipeline_f64(emu):
    """The same in fp64 through the fp64 entry: within 1e-12 of the force
    scale of the plain path."""
    got, want = _pipeline(emu, torch.float64)
    assert got.dtype == torch.float64
    assert (got - want).abs().max().item() <= 1e-12 * want.abs().max().item()
