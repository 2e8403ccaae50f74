// potential.cu — unsoftened potential energy, f32 pair terms, for sm_90a
// (K3).
//
// Replaces the TPU kernel nbody_tpu/diag/energy.py:27 (_pe_kernel), which
// sums -m_i m_j / r over all (BI, BJ) tiles into one SMEM scalar carried
// across the sequential grid.  It computes
//
//     S = sum_{i,j} -m_i * m_j / r_ij,   1/r = 0 where r^2 = 0
//
// (common/get_energy.c:40: the diagonal and coincident bodies contribute
// nothing) as twice the sum over the unordered pairs i < j.  The wrapper
// applies G and the 1/2 that turns the full sum into the reference's
// upper-triangle sum.
//
// What bounds it on the card: instruction issue and the MUFU.  The pair is
// 3 FADD for the displacement, FMUL + 2 FFMA for r^2, one MUFU.RSQ and one
// FFMA into the row's sum m_j r^-1 (m_i is factored out of the loop): 7
// fp32 instructions at 128 lanes an SM a clock, and the rsqrt at 16.
// chip_smoke.py phase 1 counts the SASS.  Device bytes are O(N).
//
// Design: the upper-triangle schedule of pe_triangle.cuh (each unordered
// pair once, contiguous shares of the triangle, fixed-order partials)
// with K1's loop (allpairs.cu): 128-thread blocks, four rows a thread,
// sources staged as float4 [x y z m], 2,048 a tile (faster than 512 and
// 1,024 in a trial on the card, PERF.md), rsqrt.approx.ftz.f32 (rsqrt.cuh).
// Each row's f32 sum is folded into the thread's fp64 total every 256
// sources at most, as the design before this one folded it every 256-row
// tile, so the f32 chains stay as short.  Coincident bodies and r below
// 1.1e-19, where the ftz rsqrt gives inf, take pe_triangle.cuh's rare
// branch through CUDA's rsqrtf and give the plain version's value.

#include <cuda_runtime.h>

#include "pe_triangle.cuh"
#include "rsqrt.cuh"

namespace {

struct PeF32 {
  using Real = float;
  using Src = float4;
  static constexpr int kTile = 2048;  // source rows a shared tile
  static constexpr int kUnroll = 8;

  __device__ static Src load(const float* pos, const float* mass, int j) {
    return make_float4(pos[3 * (size_t)j + 0], pos[3 * (size_t)j + 1],
                       pos[3 * (size_t)j + 2], mass[j]);
  }
  __device__ static float inv_r(float r2) { return rsqrt_ftz(r2); }
  __device__ static float inv_r_exact(float r2) { return rsqrtf(r2); }
};

}  // namespace

extern "C" {

// Number of fp64 partials nbody_potential_f32 writes for n bodies on the
// current device: the blocks of its launch (or -cudaError_t).
int nbody_potential_partials(int n) { return pe_blocks<PeF32>(n); }

// Launch both passes on `stream`.  pos (n,3) and mass (n,): f32, contiguous.
// partials: nbody_potential_partials(n) doubles of scratch; out: one double,
// receives sum_{i,j} -m_i m_j / r_ij.  Returns the cudaError_t of the
// launches.
int nbody_potential_f32(const float* pos, const float* mass, int n, double* partials,
                        double* out, void* stream) {
  return pe_launch<PeF32>(pos, mass, n, partials, out, stream);
}

}  // extern "C"
