// allpairs_f64.cu — softened all-pairs accelerations in fp64, for sm_90a.
//
// Replaces the TPU kernel nbody_tpu/ops/pallas_df.py::_force_kernel, which
// reaches fp64-grade forces on a chip without fp64 units by carrying every
// value as an unevaluated pair of f32 (hi + lo): Dekker splits, Knuth
// two-sums, a double-float Newton rsqrt and a compensated lane tree, ~290
// VPU operations per pair.  Hopper has fp64 units, so none of that carries
// over: this kernel computes the same function in native fp64,
//
//     a_i = sum_j gm_j * (r_j - r_i) * (|r_j - r_i|^2 + eps2)^(-3/2)
//
// with gm_j = G * m_j folded in by the wrapper.  The self-term is zero
// because the displacement is zero (eps2 > 0); there is no j == i branch.
//
// What bounds it on the card: fp64 issue.  The H100 SXM issues 64 fp64
// lanes per SM per clock, half the fp32 lanes, so at 132 SMs and 1980 MHz
// every fp64 instruction per pair costs 1e10 pairs 0.6 ms.  The pair term
// (pair_f64.cuh) is 3 DADD, 3 DFMA for |d|^2 + eps2, the rsqrt seed, 7 fp64
// instructions from the seed to the weight and 3 DFMA into the sums.
// chip_smoke.py phase 1 counts the SASS.  Device-memory traffic is
// O(M + N) for O(M * N) work.
//
// Design.  A block of 256 threads holds kPer = 4 targets a thread, in fp64
// registers (113 registers, two blocks an SM), and streams the sources
// through shared memory in tiles of kTile [x y z gm] rows (32 bytes each).
// Each staged row then feeds four independent fp64 chains, where K1's
// design (one target a thread) had one.  Where M alone cannot fill the card
// (at M = 100k, 98 blocks of 1,024 targets for 132 SMs), the block splits
// the source range: `split` = S groups of 256 / S threads hold the same
// targets and each sweeps its own slice of every tile, so the block covers
// 1,024 / S targets and the grid has S times the blocks.  At the end the
// groups' sums are added through shared memory in the fixed order s = 0,
// 1, ..., S - 1 (split_sum.cuh): one launch, no global workspace, no
// atomics.  The wrapper picks S from M and the SM count
// (ops/cuda_fp64.py::k4_split); S = 1 where M fills the card.  Each
// target's sum order depends on S only, so reruns are bit-identical.  The
// ragged edges are masked by the loop bounds, not by padding.
//
// Two targets a thread (four blocks an SM), and CUDA's rsqrt(double) in
// place of pair_f64.cuh's refinement, were each slower at 100k x 100k in a
// trial on the card; chip_smoke.py [18] times this kernel at every split
// (PERF.md).

#include <cuda_runtime.h>

#include "pair_f64.cuh"
#include "split_sum.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 4;     // targets a thread
constexpr int kTile = 512;  // source rows per shared tile

struct alignas(16) Src64 {
  double x, y, z, w;
};

__global__ void __launch_bounds__(kThreads, 2)
allpairs_f64_kernel(const double* __restrict__ pos_i, const double* __restrict__ pos_j,
                    const double* __restrict__ gm_j, double eps2, int m, int n, int split,
                    double* __restrict__ out) {
  // the source tile; after the last tile, the groups' partial sums
  constexpr int kWords = kTile * 4 > kThreads * kPer * 3 ? kTile * 4 : kThreads * kPer * 3;
  __shared__ __align__(16) double smem[kWords];
  Src64* src = reinterpret_cast<Src64*>(smem);

  const int width = kThreads / split;  // threads of a group
  const int s = threadIdx.x / width;   // this thread's group (source slice)
  const int u = threadIdx.x % width;   // its place in the group
  const int base = blockIdx.x * width * kPer;
  double xi[kPer], yi[kPer], zi[kPer], ax[kPer], ay[kPer], az[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = base + u + k * width;
    xi[k] = yi[k] = zi[k] = 0.0;
    ax[k] = ay[k] = az[k] = 0.0;
    if (i < m) {
      xi[k] = pos_i[3 * (size_t)i + 0];
      yi[k] = pos_i[3 * (size_t)i + 1];
      zi[k] = pos_i[3 * (size_t)i + 2];
    }
  }

  const int slice = kTile / split;
  for (int t0 = 0; t0 < n; t0 += kTile) {
    for (int r = threadIdx.x; r < kTile; r += kThreads) {
      const int j = t0 + r;
      if (j < n)
        src[r] = Src64{pos_j[3 * (size_t)j + 0], pos_j[3 * (size_t)j + 1],
                       pos_j[3 * (size_t)j + 2], gm_j[j]};
    }
    __syncthreads();
    const int lo = s * slice;
    const int hi = min(lo + slice, n - t0);
#pragma unroll 4
    for (int q = lo; q < hi; ++q) {
      const Src64 r = src[q];
#pragma unroll
      for (int k = 0; k < kPer; ++k)
        accumulate_f64(r, xi[k], yi[k], zi[k], eps2, ax[k], ay[k], az[k]);
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

// Launch on `stream`.  pos_i (m,3), pos_j (n,3), gm_j (n,), out (m,3): fp64,
// contiguous, on the current device.  `split` (1, 2, 4 or 8) is the number
// of source slices a block sweeps for the same targets.  Returns the
// cudaError_t of the launch.
int nbody_allpairs_f64(const double* pos_i, const double* pos_j, const double* gm_j,
                       double eps2, int m, int n, int split, double* out, void* stream) {
  if (split != 1 && split != 2 && split != 4 && split != 8)
    return static_cast<int>(cudaErrorInvalidValue);
  if (m <= 0) return cudaSuccess;
  const int per_block = kThreads / split * kPer;
  const dim3 grid((m + per_block - 1) / per_block);
  allpairs_f64_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      pos_i, pos_j, gm_j, eps2, m, n, split, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
