// allpairs.cu — softened all-pairs accelerations, f32, for sm_90a (K1).
//
// Replaces the TPU kernel nbody_tpu/ops/pallas_exhaustive.py::_kernel (with
// _pair_weights), which evaluates (BI, BJ) pair tiles on the VPU and
// accumulates each i-block's output across the sequential j axis of the
// grid.  It computes, over an (M targets x N sources) rectangle,
//
//     a_i = sum_j gm_j * (r_j - r_i) * (|r_j - r_i|^2 + eps2_ij)^(-3/2)
//
// with gm_j = G * m_j folded in by the wrapper.  The self-term is zero
// because the displacement is zero; there is no j == i branch.  Per-body
// mode uses eps2_ij = eps2_i / 2 + eps2_j / 2.
//
// What bounds it on the card: fp32 issue.  A pair is 3 FADD for the
// displacement, 3 FFMA for |d|^2 + eps2, one MUFU.RSQ, 3 FMUL for the
// weight and 3 FFMA into the sums: 12 fp32 instructions (13 in per-body
// mode), at 128 fp32 lanes per SM per clock.  chip_smoke.py phase 1 counts
// the SASS.  Device-memory traffic is O(M + N) for O(M * N) work.
//
// Design: K4's (allpairs_f64.cu).  A block of 128 threads holds kPer = 4
// targets a thread in registers and streams the sources through shared
// memory in tiles of kTile [x y z gm] rows (32 KB), so each staged row (one
// broadcast float4 load) feeds four independent chains.  Where M alone
// cannot fill the card (at M = 100k, 196 blocks of 512 targets for 132
// SMs), the block splits the source range: `split` = S groups of 128 / S
// threads hold the same targets and each sweeps its own slice of every
// tile, so the grid has S times the blocks; their sums meet in shared
// memory in the fixed order s = 0 ... S - 1 (split_sum.cuh).  The wrapper
// picks S from M and the SM count (ops/cuda_exhaustive.py::k1_split).  The
// ragged edges are masked by the loop bounds, not by padding: threads past
// M stage sources but write nothing.
//
// The block size, tile, unrolling and targets a thread are the fastest of
// a trial of builds on the card at 100k x 100k, 100,003 x 4,099 and 1M x
// 1,953 (PERF.md); 256 threads a block, tiles of 512 rows and two or
// eight targets a thread were slower.
//
// The pair term is pair_f32.cuh's, shared with K7's f32 entry: its rsqrt
// is rsqrt.approx.ftz.f32, MUFU.RSQ alone, without the scaling that CUDA's
// rsqrtf wraps around it for subnormal inputs (two fp32 instructions a
// pair, 10-18 % of the time in the same trial).

#include <cuda_runtime.h>

#include "pair_f32.cuh"
#include "split_sum.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kPer = 4;      // targets a thread
constexpr int kTile = 2048;  // source rows per shared tile

template <bool kPerBody>
__global__ void __launch_bounds__(kThreads)
allpairs_kernel(const float* __restrict__ pos_i, const float* __restrict__ pos_j,
                const float* __restrict__ gm_j, const float* __restrict__ eps2_i,
                const float* __restrict__ eps2_j, float eps2, int m, int n, int split,
                float* __restrict__ out) {
  // the source tile; after the last tile, the groups' partial sums
  constexpr int kWords = kTile * 4 > kThreads * kPer * 3 ? kTile * 4 : kThreads * kPer * 3;
  __shared__ __align__(16) float smem[kWords];
  __shared__ float src_e[kPerBody ? kTile : 1];
  float4* src = reinterpret_cast<float4*>(smem);

  const int width = kThreads / split;  // threads of a group
  const int s = threadIdx.x / width;   // this thread's group (source slice)
  const int u = threadIdx.x % width;   // its place in the group
  const int base = blockIdx.x * width * kPer;
  float xi[kPer], yi[kPer], zi[kPer], ei[kPer], ax[kPer], ay[kPer], az[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = base + u + k * width;
    xi[k] = yi[k] = zi[k] = 0.f;
    ax[k] = ay[k] = az[k] = 0.f;
    ei[k] = eps2;
    if (i < m) {
      xi[k] = pos_i[3 * (size_t)i + 0];
      yi[k] = pos_i[3 * (size_t)i + 1];
      zi[k] = pos_i[3 * (size_t)i + 2];
      if (kPerBody) ei[k] = 0.5f * eps2_i[i];
    }
  }

  const int slice = kTile / split;
  for (int t0 = 0; t0 < n; t0 += kTile) {
    for (int r = threadIdx.x; r < kTile; r += kThreads) {
      const int j = t0 + r;
      if (j < n) {
        src[r] = make_float4(pos_j[3 * (size_t)j + 0], pos_j[3 * (size_t)j + 1],
                             pos_j[3 * (size_t)j + 2], gm_j[j]);
        if (kPerBody) src_e[r] = 0.5f * eps2_j[j];
      }
    }
    __syncthreads();
    const int lo = s * slice;
    const int hi = min(lo + slice, n - t0);
#pragma unroll 8
    for (int q = lo; q < hi; ++q) {
      const float4 r = src[q];
      const float ej = kPerBody ? src_e[q] : 0.f;
#pragma unroll
      for (int k = 0; k < kPer; ++k)
        accumulate_f32(r, xi[k], yi[k], zi[k], kPerBody ? ei[k] + ej : ei[k], ax[k], ay[k],
                       az[k]);
    }
    __syncthreads();
  }

  if (!meet_groups<kPer>(smem, split, width, s, u, ax, ay, az)) return;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = base + u + k * width;
    if (i < m) {
      out[3 * (size_t)i + 0] = ax[k];
      out[3 * (size_t)i + 1] = ay[k];
      out[3 * (size_t)i + 2] = az[k];
    }
  }
}

}  // namespace

extern "C" {

// Launch on `stream`.  pos_i (m,3), pos_j (n,3), gm_j (n,), out (m,3): f32,
// contiguous, on the current device.  eps2_i (m,) and eps2_j (n,) are both
// null (scalar softening eps2) or both set (per-body mode).  `split` (1, 2,
// 4 or 8) is the number of source slices a block sweeps for the same
// targets.  Returns the cudaError_t of the launch.
int nbody_allpairs_f32(const float* pos_i, const float* pos_j, const float* gm_j,
                       const float* eps2_i, const float* eps2_j, float eps2, int m,
                       int n, int split, float* out, void* stream) {
  if (split != 1 && split != 2 && split != 4 && split != 8)
    return static_cast<int>(cudaErrorInvalidValue);
  if (m <= 0) return cudaSuccess;
  const int per_block = kThreads / split * kPer;
  const dim3 grid((m + per_block - 1) / per_block);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (eps2_i != nullptr) {
    allpairs_kernel<true><<<grid, kThreads, 0, s>>>(pos_i, pos_j, gm_j, eps2_i, eps2_j,
                                                     eps2, m, n, split, out);
  } else {
    allpairs_kernel<false><<<grid, kThreads, 0, s>>>(pos_i, pos_j, gm_j, nullptr,
                                                      nullptr, eps2, m, n, split, out);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* nbody_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
