// pair_f32.cuh — the f32 pair term of K1 (allpairs.cu) and K7's f32 entry
// (group_lists.cu), the twin of pair_f64.cuh:
//
//     a += gm * d * (|d|^2 + e)^(-3/2),   d = r_j - r_i
//
// 3 FADD for the displacement, 3 FFMA for |d|^2 + e, one MUFU.RSQ, 3 FMUL for
// the weight and 3 FFMA into the sums: 12 fp32 instructions a pair, the count
// that bounds both kernels (fp32 issue).  The rsqrt is rsqrt.cuh's
// rsqrt_ftz: MUFU.RSQ alone, without the scaling that CUDA's rsqrtf wraps
// around it for subnormal inputs.  |d|^2 + e is a normal float whenever e is
// (the softening is 1e-2 by default); a zero softening gives inf and NaN for
// a coincident pair either way.
#pragma once

#include "rsqrt.cuh"

// One source s = [x y z gm] on the body at (xi, yi, zi) with the pair's
// softening e.
__device__ __forceinline__ void accumulate_f32(const float4 s, float xi, float yi, float zi,
                                               float e, float& ax, float& ay, float& az) {
  const float dx = s.x - xi;
  const float dy = s.y - yi;
  const float dz = s.z - zi;
  const float r2 = fmaf(dx, dx, fmaf(dy, dy, fmaf(dz, dz, e)));
  const float inv_r = rsqrt_ftz(r2);
  const float w = (s.w * inv_r) * (inv_r * inv_r);
  ax = fmaf(w, dx, ax);
  ay = fmaf(w, dy, ay);
  az = fmaf(w, dz, az);
}
