// rsqrt.cuh — the hardware reciprocal square roots without CUDA's wrappers,
// for the kernels whose pair loops are bound by instruction issue:
//
// * rsqrt_ftz: rsqrt.approx.ftz.f32, MUFU.RSQ alone, in pair_f32.cuh (K1
//   and K7's f32 entry), K2 (allpairs_mma.cu), K3 (potential.cu) and K6's
//   f32 pair term (bh_fused.cu's accumulate_fma).  CUDA's rsqrtf wraps the
//   same instruction in a scaling for subnormal inputs: an FSETP and two
//   more fp32 instructions a pair.
// * rsqrt_seed: rsqrt.approx.ftz.f64, MUFU.RSQ64H, r2^(-1/2) from the high
//   word of r2 with the low word of the result zero; pair_f64.cuh refines
//   it to fp64 (K4, K5, K6's df mode, K7's fp64 entry).
//
// Both flush a subnormal input to zero and so return +inf for it, as for
// zero.  The CPU emulation of the kernel sources brings its own twins and
// defines NBODY_EMULATED_RSQRT.
#pragma once

#ifndef NBODY_EMULATED_RSQRT
__device__ __forceinline__ float rsqrt_ftz(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ double rsqrt_seed(double r2) {
  double y;
  asm("rsqrt.approx.ftz.f64 %0, %1;" : "=d"(y) : "d"(r2));
  return y;
}
#endif
