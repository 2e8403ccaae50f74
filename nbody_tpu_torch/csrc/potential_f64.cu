// potential_f64.cu — unsoftened potential energy in fp64, for sm_90a (K5).
//
// Replaces the TPU kernel nbody_tpu/ops/pallas_df.py:217 (_pe_kernel), which
// sums -m_i m_j / r over all (BI, BJ) tiles in double-float (f32 hi + lo)
// arithmetic and a compensated reduction into one accumulator carried
// across the sequential grid.  Hopper has fp64 units, so this kernel
// computes the same sum in native fp64,
//
//     S = sum_{i,j} -m_i * m_j / r_ij,   1/r = 0 where r^2 = 0
//
// (common/get_energy.c:40: the diagonal and coincident bodies contribute
// nothing), as twice the sum over the unordered pairs i < j.  The wrapper
// applies G and the 1/2 that turns the full sum into the reference's
// upper-triangle sum (pallas_df.py:434-435).
//
// What bounds it on the card: fp64 issue, 64 lanes an SM a clock.  The
// pair is 3 DADD for the displacement, DMUL + 2 DFMA for r^2, the
// MUFU.RSQ64H seed refined straight to r^-1 (pair_f64.cuh's pair_inv_r, 5
// fp64 instructions) and one DFMA into the row's sum m_j r^-1 (m_i is
// factored out of the loop): 12 fp64 instructions, where CUDA's
// rsqrt(double) and the old loop took 13.4 and a branch.  chip_smoke.py
// phase 1 counts the SASS.  Device bytes are O(N).
//
// Design: the upper-triangle schedule of pe_triangle.cuh (each unordered
// pair once, contiguous shares of the triangle, fixed-order partials)
// with K4's loop (allpairs_f64.cu): 128-thread blocks, four rows a thread,
// sources staged as 32-byte rows [x y z m], 1,024 a tile (faster than 256
// and 512 in a trial on the card, PERF.md).  Coincident bodies and r below
// 1.5e-154, where the seed gives inf, take pe_triangle.cuh's rare branch
// through CUDA's rsqrt(double) and give the plain version's value.

#include <cuda_runtime.h>

#include "pair_f64.cuh"
#include "pe_triangle.cuh"

namespace {

struct alignas(16) Src64 {
  double x, y, z, w;
};

struct PeF64 {
  using Real = double;
  using Src = Src64;
  static constexpr int kTile = 1024;  // source rows a shared tile
  static constexpr int kUnroll = 4;

  __device__ static Src load(const double* pos, const double* mass, int j) {
    return Src64{pos[3 * (size_t)j + 0], pos[3 * (size_t)j + 1], pos[3 * (size_t)j + 2],
                 mass[j]};
  }
  __device__ static double inv_r(double r2) { return pair_inv_r(r2); }
  __device__ static double inv_r_exact(double r2) { return rsqrt(r2); }
};

}  // namespace

extern "C" {

// Number of fp64 partials nbody_potential_f64 writes for n bodies on the
// current device: the blocks of its launch (or -cudaError_t).
int nbody_potential_f64_partials(int n) { return pe_blocks<PeF64>(n); }

// Launch both passes on `stream`.  pos (n,3) and mass (n,): fp64,
// contiguous.  partials: nbody_potential_f64_partials(n) doubles of
// scratch; out: one double, receives sum_{i,j} -m_i m_j / r_ij.  Returns
// the cudaError_t of the launches.
int nbody_potential_f64(const double* pos, const double* mass, int n, double* partials,
                        double* out, void* stream) {
  return pe_launch<PeF64>(pos, mass, n, partials, out, stream);
}

}  // extern "C"
