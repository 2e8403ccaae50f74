// potential_f64.cu — unsoftened potential energy in fp64, for sm_90a.
//
// Replaces the TPU kernel nbody_tpu/ops/pallas_df.py::_pe_kernel, which
// sums -m_i m_j / r over (BI, BJ) tiles in double-float (f32 hi + lo)
// arithmetic and a compensated reduction into one accumulator carried
// across the sequential grid.  Hopper has fp64 units, so this kernel
// computes the same sum in native fp64:
//
//     S = sum_{i,j} -m_i * m_j / r_ij,   1/r = 0 where r^2 = 0
//
// (common/get_energy.c:40: the diagonal and coincident bodies contribute
// nothing).  The wrapper applies G and the 1/2 that turns the full sum into
// the reference's upper-triangle sum (pallas_df.py:434-435).
//
// What bounds it on the card: fp64 issue.  Per pair, from the source: 3
// DADD, 1 DMUL + 2 DFMA (r^2), 1 DMUL (m_i m_j) and 1 DFMA (accumulate),
// 8 fp64 instructions, plus the software rsqrt (MUFU.RSQ64H and its
// refinement) and the r^2 > 0 select.  The SASS (sm_90a, nvcc 12.9;
// chip_smoke.py phase 1 counts it) holds 8 pair bodies with 30 DADD, 32
// DMUL and 45 DFMA, the block reduction's few DADD included: at most 13.4
// fp64 instructions per pair, so 1e10 pairs take at least 8.0 ms at 64
// fp64 lanes per SM per clock, 132 SMs and 1980 MHz.  Device bytes are
// O(N).
//
// Design: K3's (potential.cu) in fp64.  One thread per row i, sources
// [x y z m] staged through shared memory, the ragged edge masked by the
// loop bound, each thread accumulating its row in an fp64 register.  A
// block reduces in shared memory (fixed tree) and writes one partial; a
// second single-block pass sums the partials in a fixed order.  No
// atomics, so repeated runs are bit-identical.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;

struct alignas(16) Src64 {
  double x, y, z, w;
};

__global__ void __launch_bounds__(kBlock)
pe_f64_partials_kernel(const double* __restrict__ pos, const double* __restrict__ mass,
                       int n, double* __restrict__ partials) {
  __shared__ Src64 src[kBlock];
  __shared__ double red[kBlock];

  const int i = blockIdx.x * kBlock + threadIdx.x;
  const bool live = i < n;
  double xi = 0.0, yi = 0.0, zi = 0.0, mi = 0.0;
  if (live) {
    xi = pos[3 * (size_t)i + 0];
    yi = pos[3 * (size_t)i + 1];
    zi = pos[3 * (size_t)i + 2];
    mi = mass[i];
  }

  double acc = 0.0;
  for (int t0 = 0; t0 < n; t0 += kBlock) {
    const int j = t0 + threadIdx.x;
    if (j < n) {
      src[threadIdx.x] = Src64{pos[3 * (size_t)j + 0], pos[3 * (size_t)j + 1],
                               pos[3 * (size_t)j + 2], mass[j]};
    }
    __syncthreads();
    const int count = min(kBlock, n - t0);
#pragma unroll 4
    for (int k = 0; k < count; ++k) {
      const Src64 s = src[k];
      const double dx = s.x - xi;
      const double dy = s.y - yi;
      const double dz = s.z - zi;
      const double r2 = dx * dx + dy * dy + dz * dz;
      const double inv_r = r2 > 0.0 ? rsqrt(r2) : 0.0;
      acc += -(mi * s.w) * inv_r;
    }
    __syncthreads();
  }

  const int tid = threadIdx.x;
  red[tid] = live ? acc : 0.0;
  __syncthreads();
  for (int half = kBlock / 2; half > 0; half >>= 1) {
    if (tid < half) red[tid] += red[tid + half];
    __syncthreads();
  }
  if (tid == 0) partials[blockIdx.x] = red[0];
}

__global__ void __launch_bounds__(kBlock)
sum_f64_partials_kernel(const double* __restrict__ partials, int count,
                        double* __restrict__ out) {
  __shared__ double red[kBlock];
  const int tid = threadIdx.x;
  double acc = 0.0;
  for (int k = tid; k < count; k += kBlock) acc += partials[k];
  red[tid] = acc;
  __syncthreads();
  for (int half = kBlock / 2; half > 0; half >>= 1) {
    if (tid < half) red[tid] += red[tid + half];
    __syncthreads();
  }
  if (tid == 0) out[0] = red[0];
}

}  // namespace

extern "C" {

// Number of fp64 partials nbody_potential_f64 needs for n bodies.
int nbody_potential_f64_partials(int n) { return (n + kBlock - 1) / kBlock; }

// Launch both passes on `stream`.  pos (n,3) and mass (n,): fp64,
// contiguous.  partials: nbody_potential_f64_partials(n) doubles of
// scratch; out: one double, receives sum_{i,j} -m_i m_j / r_ij.  Returns
// the cudaError_t of the launches.
int nbody_potential_f64(const double* pos, const double* mass, int n, double* partials,
                        double* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = nbody_potential_f64_partials(n);
  if (blocks > 0) {
    pe_f64_partials_kernel<<<blocks, kBlock, 0, s>>>(pos, mass, n, partials);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  sum_f64_partials_kernel<<<1, kBlock, 0, s>>>(partials, blocks, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
