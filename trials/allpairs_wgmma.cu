// allpairs_wgmma.cu — K2 (csrc/allpairs_mma.cu) with the product on wgmma in
// place of mma.sync, for the trial in trials/kernel_trial.py only: the port
// does not build or call it.
//
// The same weights, staging and epilogue as K2; per 8-source k-step each
// warpgroup issues wgmma.mma_async m64n8k8 .tf32 with A (K_hi or K_lo of its
// 64 rows, the same per-warp fragment layout as mma.m16n8k8) from registers
// and B from shared memory through a matrix descriptor: B's 8 x 8 TF32
// values of the k-step are two 8 x 16-byte core matrices (k 0-3, k 4-7),
// no swizzle, 128 bytes apart.  Both descriptor strides are 128 bytes, so
// the k-direction stride is right whichever of the two the hardware reads
// it from (the n direction has one core matrix).  The A registers of a
// k-step are kept until its group completes: two register sets, each
// k-step waits for the one before (wgmma.wait_group 1).  The tensor cores'
// sums of kChain k-steps are added to the tile's partial by FADD, as in K2.

#include <cuda_runtime.h>
#include <stdint.h>

#include "rsqrt.cuh"

namespace {

constexpr int kWarps = 8;                 // two warpgroups
constexpr int kMT = 2;                    // 64-row tiles a warpgroup
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 64 * kMT * (kWarps / 4);  // targets a block
constexpr int kTile = 512;
constexpr int kSteps = kTile / 8;
constexpr int kChain = 8;

__device__ __forceinline__ float tf32_rna(float v) {
  unsigned u;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(u) : "f"(v));
  return __uint_as_float(u);
}

__device__ __forceinline__ uint64_t b_desc(const float* p) {
  const uint64_t addr = static_cast<uint64_t>(__cvta_generic_to_shared(p));
  return ((addr & 0x3FFFF) >> 4) | (uint64_t(128 >> 4) << 16) | (uint64_t(128 >> 4) << 32);
}

__device__ __forceinline__ void wgmma_tf32(float d[4], const unsigned a[4], uint64_t desc,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float kernel_weight(const float4 s, const float p[3], float e) {
  const float dx = s.x - p[0];
  const float dy = s.y - p[1];
  const float dz = s.z - p[2];
  const float r2 = fmaf(dx, dx, fmaf(dy, dy, fmaf(dz, dz, e)));
  const float inv_r = rsqrt_ftz(r2);
  return (inv_r * inv_r) * inv_r;
}

__global__ void __launch_bounds__(kThreads)
allpairs_wgmma_kernel(const float* __restrict__ pos_i, const float* __restrict__ pos_j,
                      const float* __restrict__ gm_j, float eps2, int m, int n,
                      float* __restrict__ out) {
  __shared__ float4 src[kTile];
  __shared__ __align__(128) float bcm[kSteps * 64];  // per k-step two core matrices

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int first = blockIdx.x * kRows;
  // warpgroup wg owns rows first + wg * 64 kMT + 64 mt + 16 (warp % 4) + (g, g + 8)
  const int row0 = first + (warp >> 2) * 64 * kMT + 16 * (warp & 3);
  const float c[3] = {pos_i[3 * (size_t)first + 0], pos_i[3 * (size_t)first + 1],
                      pos_i[3 * (size_t)first + 2]};

  float p[kMT][2][3], pc[kMT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = row0 + 64 * mt + g + 8 * r;
#pragma unroll
      for (int d = 0; d < 3; ++d) p[mt][r][d] = i < m ? pos_i[3 * (size_t)i + d] : 0.f;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int col = 2 * t + (q & 1);
      pc[mt][q] = col < 3 ? p[mt][q >> 1][col] - c[col] : 0.f;
    }
  }

  float acc[kMT][4] = {};
  for (int t0 = 0; t0 < n; t0 += kTile) {
    for (int r = threadIdx.x; r < kTile; r += kThreads) {
      const int j = t0 + r;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (j < n) {
        const float x = pos_j[3 * (size_t)j + 0], y = pos_j[3 * (size_t)j + 1],
                    z = pos_j[3 * (size_t)j + 2], gm = gm_j[j];
        src[r] = make_float4(x, y, z, 0.f);
        v[0] = gm * (x - c[0]);
        v[1] = gm * (y - c[1]);
        v[2] = gm * (z - c[2]);
        v[3] = gm;
      } else {
        src[r] = make_float4(__int_as_float(0x7f800000), 0.f, 0.f, 0.f);
      }
      // B[k = r % 8][col] at core matrix k / 4, row col, word k % 4
      float* cm = bcm + (r >> 3) * 64 + ((r & 7) >> 2) * 32 + (r & 3);
#pragma unroll
      for (int col = 0; col < 4; ++col) {
        const float hi = tf32_rna(v[col]);
        cm[4 * col] = hi;
        cm[4 * (col + 4)] = tf32_rna(v[col] - hi);
      }
    }
    // the tile's stores made visible to the tensor cores' (async) reads
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const int steps = (min(kTile, n - t0) + 7) / 8;
    float part[kMT][4] = {};
    for (int s0 = 0; s0 < steps; s0 += kChain) {
      float d[kMT][4] = {};
      const int s1 = min(s0 + kChain, steps);
      unsigned ah[2][kMT][4], al[2][kMT][4];
      for (int s = s0; s < s1; s += 2) {
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          if (s + b >= s1) break;
          const int k = s + b;
          const float4 u0 = src[8 * k + t];
          const float4 u1 = src[8 * k + t + 4];
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) {
            const float w[4] = {kernel_weight(u0, p[mt][0], eps2),
                                kernel_weight(u0, p[mt][1], eps2),
                                kernel_weight(u1, p[mt][0], eps2),
                                kernel_weight(u1, p[mt][1], eps2)};
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              ah[b][mt][q] = __float_as_uint(w[q]) & 0xffffe000u;
              al[b][mt][q] = __float_as_uint(w[q] - __uint_as_float(ah[b][mt][q]));
            }
          }
          const uint64_t desc = b_desc(bcm + k * 64);
          wg_fence();
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) {
            wgmma_tf32(d[mt], ah[b][mt], desc, k != s0);
            wgmma_tf32(d[mt], al[b][mt], desc, 1);
          }
          wg_commit();
          wg_wait<1>();
        }
      }
      wg_wait<0>();
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int q = 0; q < 4; ++q) part[mt][q] += d[mt][q];
    }
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      float v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        v[q] = part[mt][q] + __shfl_xor_sync(0xffffffffu, part[mt][q], 2);
      const float sw0 = __shfl_sync(0xffffffffu, v[1], (lane & ~3) | 1);
      const float sw1 = __shfl_sync(0xffffffffu, v[3], (lane & ~3) | 1);
      acc[mt][0] += v[0] - pc[mt][0] * sw0;
      acc[mt][1] += v[1] - pc[mt][1] * sw0;
      acc[mt][2] += v[2] - pc[mt][2] * sw1;
      acc[mt][3] += v[3] - pc[mt][3] * sw1;
    }
    __syncthreads();
  }
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = row0 + 64 * mt + g + 8 * (q >> 1);
      const int col = 2 * t + (q & 1);
      if (i < m && col < 3) out[3 * (size_t)i + col] = acc[mt][q];
    }
  }
}

}  // namespace

extern "C" {

// K2's contract in scalar mode (no per-body softening), on `stream`.
int nbody_allpairs_wgmma_f32(const float* pos_i, const float* pos_j, const float* gm_j,
                             float eps2, int m, int n, float* out, void* stream) {
  if (m <= 0) return cudaSuccess;
  allpairs_wgmma_kernel<<<(m + kRows - 1) / kRows, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(pos_i, pos_j, gm_j, eps2, m,
                                                               n, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
