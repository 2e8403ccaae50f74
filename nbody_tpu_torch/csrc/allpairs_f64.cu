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
// What bounds it on the card: fp64 issue.  Per pair, from the source: 3
// DADD (displacement), 1 DMUL + 3 DFMA (r^2 + eps2), 2 DMUL (r^-3), 1 DMUL
// (weight) and 3 DFMA (accumulate) = 13 fp64 instructions, plus the
// software rsqrt: MUFU.RSQ64H seeds it and DFMA/DMUL refine it to fp64.
// The SASS (sm_90a, nvcc 12.9; chip_smoke.py phase 1 counts it) holds 8
// pair bodies with 29 DADD, 46 DMUL and 59 DFMA: 16.75 fp64 instructions
// per pair, the rsqrt's refinement included.  The H100 SXM issues 64 fp64
// lanes per SM per clock, half the fp32 lanes, so at 132 SMs and 1980 MHz
// 1e10 pairs take at least 10.0 ms (K1's FP32 issue bound: 3.9 ms).
// Device-memory traffic is O(M + N) for O(M * N) work.
//
// Design: K1's (allpairs.cu).  One thread per target, accumulating in fp64
// registers; sources stream through shared memory in tiles of kBlock
// [x y z gm] rows (32 bytes each), each thread of the block loading one.
// The ragged edge is masked by the loop bound, not by padding.  Every
// target sums its sources in the same order on every run, so reruns are
// bit-identical.
//
// Left for later: at M = 100k there are ~760 targets per SM, so fp64 issue
// is shared by few warps; two targets per thread would give each shared
// load twice the work.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;

struct alignas(16) Src64 {
  double x, y, z, w;
};

__global__ void __launch_bounds__(kBlock)
allpairs_f64_kernel(const double* __restrict__ pos_i, const double* __restrict__ pos_j,
                    const double* __restrict__ gm_j, double eps2, int m, int n,
                    double* __restrict__ out) {
  __shared__ Src64 src[kBlock];

  const int i = blockIdx.x * kBlock + threadIdx.x;
  const bool live = i < m;
  double xi = 0.0, yi = 0.0, zi = 0.0;
  if (live) {
    xi = pos_i[3 * (size_t)i + 0];
    yi = pos_i[3 * (size_t)i + 1];
    zi = pos_i[3 * (size_t)i + 2];
  }

  double ax = 0.0, ay = 0.0, az = 0.0;
  for (int t0 = 0; t0 < n; t0 += kBlock) {
    const int j = t0 + threadIdx.x;
    if (j < n) {
      src[threadIdx.x] = Src64{pos_j[3 * (size_t)j + 0], pos_j[3 * (size_t)j + 1],
                               pos_j[3 * (size_t)j + 2], gm_j[j]};
    }
    __syncthreads();
    const int count = min(kBlock, n - t0);
#pragma unroll 4
    for (int k = 0; k < count; ++k) {
      const Src64 s = src[k];
      const double dx = s.x - xi;
      const double dy = s.y - yi;
      const double dz = s.z - zi;
      const double r2 = dx * dx + dy * dy + dz * dz + eps2;
      const double inv_r = rsqrt(r2);
      const double w = s.w * (inv_r * inv_r * inv_r);
      ax += w * dx;
      ay += w * dy;
      az += w * dz;
    }
    __syncthreads();
  }
  if (live) {
    out[3 * (size_t)i + 0] = ax;
    out[3 * (size_t)i + 1] = ay;
    out[3 * (size_t)i + 2] = az;
  }
}

}  // namespace

extern "C" {

// Launch on `stream`.  pos_i (m,3), pos_j (n,3), gm_j (n,), out (m,3): fp64,
// contiguous, on the current device.  Returns the cudaError_t of the launch.
int nbody_allpairs_f64(const double* pos_i, const double* pos_j, const double* gm_j,
                       double eps2, int m, int n, double* out, void* stream) {
  if (m <= 0) return cudaSuccess;
  const dim3 grid((m + kBlock - 1) / kBlock);
  allpairs_f64_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      pos_i, pos_j, gm_j, eps2, m, n, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
