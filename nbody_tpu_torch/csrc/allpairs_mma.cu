// allpairs_mma.cu — softened all-pairs accelerations, f32, with the j-sum on
// the tensor cores, for sm_90a.
//
// Replaces the TPU kernel nbody_tpu/ops/pallas_exhaustive.py::_kernel_mxu
// (use_mxu=True), which computes the (BI, BJ) weight matrix on the VPU and
// contracts it with the j-tile's [x y z 1] columns on the MXU.  Over an
// (M targets x N sources) rectangle, per tile of sources:
//
//     w_ij    = gm_j * (|r_j - r_i|^2 + eps2_ij)^(-3/2)   (r^2 exact, not expanded)
//     partial = W @ [x_j y_j z_j 1]                       (tensor cores)
//     a_i    += partial[:, 0:3] - r_i * partial[:, 3]
//
// with gm_j = G * m_j folded in by the wrapper; per-body mode uses
// eps2_ij = eps2_i / 2 + eps2_j / 2.  The subtraction is made per tile, as
// _kernel_mxu makes it per j-block, so the running sum holds forces and not
// the far larger sum of w * x_j.
//
// What bounds it on the card: the weights, about 13 CUDA-core operations per
// pair with one rsqrt (SFU), plus the split of each weight into two TF32
// halves; the contraction is 3 x 16 flops per pair on the tensor cores,
// half of it on the zero columns 4..7 of B.  Device bytes are O(M + N).
//
// Design: a block of 8 warps owns 128 targets and their whole j loop (no
// atomics, bit-identical reruns), as K1 does.  Sources stream through shared
// memory in tiles of 256 [x y z gm] rows, one per thread; a ragged last tile
// is padded with gm = 0 rows whose B column 3 is 0.  Each warp owns one
// 16-row m-tile; per 8-source k-step every lane computes the four weights of
// its own A-fragment positions in registers (PTX ISA fragment layout for
// mma.m16n8k8 .tf32: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8,
// t + 4) with g = lane / 4, t = lane % 4), so W never touches shared memory,
// and its B fragment (b0 = row t, b1 = row t + 4 of column g) from the same
// two sources.  The product is 3xTF32 (mma_3xtf32): hi = cvt.rna.tf32(v),
// lo = tf32(v - hi) for W and B, and lo·hi + hi·lo + hi·hi accumulated in
// f32, what JAX's Precision.HIGHEST asks of the MXU.  One TF32 pass keeps
// about three digits.  Each k-step's product starts from a zero
// accumulator and is added to the tile's partial by FADD (see the loop).
//
// Left for later: wgmma with the weights staged to shared memory, TMA, and a
// B operand that uses its four zero columns.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // targets per block: one m16 tile per warp
constexpr int kTile = kThreads;     // sources staged per tile, one per thread

// The CPU emulation of the kernel sources brings its own warp-wide twin of
// this helper and defines NBODY_EMULATED_MMA.
#ifndef NBODY_EMULATED_MMA
// c += a @ b for the warp's m16n8k8 fragments (PTX ISA layout above), with
// a and b split into TF32 hi and lo halves: lo·hi, hi·lo, then hi·hi.
__device__ __forceinline__ void mma_3xtf32(float c[4], const float a[4],
                                           const float b[2]) {
  unsigned ah[4], al[4], bh[2], bl[2];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(ah[q]) : "f"(a[q]));
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(al[q]) : "f"(a[q] - __uint_as_float(ah[q])));
  }
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(bh[q]) : "f"(b[q]));
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(bl[q]) : "f"(b[q] - __uint_as_float(bh[q])));
  }
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(al[0]), "r"(al[1]), "r"(al[2]), "r"(al[3]), "r"(bh[0]), "r"(bh[1]));
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(ah[0]), "r"(ah[1]), "r"(ah[2]), "r"(ah[3]), "r"(bl[0]), "r"(bl[1]));
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(ah[0]), "r"(ah[1]), "r"(ah[2]), "r"(ah[3]), "r"(bh[0]), "r"(bh[1]));
}
#endif

// Component `c` of [x y z 1 0 0 0 0] for source s (the B column c), where
// `real` is false for a pad row.
__device__ __forceinline__ float b_column(float4 s, int c, bool real) {
  return c == 0 ? s.x : c == 1 ? s.y : c == 2 ? s.z : (c == 3 && real) ? 1.f : 0.f;
}

template <bool kPerBody>
__global__ void __launch_bounds__(kThreads)
allpairs_mma_kernel(const float* __restrict__ pos_i, const float* __restrict__ pos_j,
                    const float* __restrict__ gm_j, const float* __restrict__ eps2_i,
                    const float* __restrict__ eps2_j, float eps2, int m, int n,
                    float* __restrict__ out) {
  __shared__ float4 src[kTile];
  __shared__ float src_e[kPerBody ? kTile : 1];

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // A rows g and g + 8; B and C column group g
  const int t = lane & 3;   // A columns t and t + 4; C columns 2t and 2t + 1
  const int row0 = blockIdx.x * kRows + (threadIdx.x >> 5) * 16;

  // this lane's two targets (rows g and g + 8); rows past m compute on the
  // origin and are never written
  float p[2][3], e[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row0 + g + 8 * r;
    const bool live = i < m;
#pragma unroll
    for (int d = 0; d < 3; ++d) p[r][d] = live ? pos_i[3 * (size_t)i + d] : 0.f;
    e[r] = kPerBody ? (live ? 0.5f * eps2_i[i] : 0.f) : eps2;
  }
  // the target coordinate under each of this lane's C entries (0 past z)
  float pc[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int col = 2 * t + (q & 1);
    pc[q] = col < 3 ? p[q >> 1][col] : 0.f;
  }

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int t0 = 0; t0 < n; t0 += kTile) {
    const int j = t0 + threadIdx.x;
    const bool have = j < n;
    src[threadIdx.x] =
        have ? make_float4(pos_j[3 * (size_t)j + 0], pos_j[3 * (size_t)j + 1],
                           pos_j[3 * (size_t)j + 2], gm_j[j])
             : make_float4(0.f, 0.f, 0.f, 0.f);
    if (kPerBody) src_e[threadIdx.x] = have ? 0.5f * eps2_j[j] : 0.f;
    __syncthreads();
    const int steps = (min(kTile, n - t0) + 7) / 8;  // warp-uniform
    float c[4] = {0.f, 0.f, 0.f, 0.f};  // the tile's partial, summed by FADD
    for (int s = 0; s < steps; ++s) {
      float a[4], b[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // sources t and t + 4 of the k-step
        const int k = 8 * s + t + 4 * h;
        const float4 sj = src[k];
        const bool real = t0 + k < n;
#pragma unroll
        for (int r = 0; r < 2; ++r) {  // targets g and g + 8
          const float dx = sj.x - p[r][0];
          const float dy = sj.y - p[r][1];
          const float dz = sj.z - p[r][2];
          const float ee = kPerBody ? e[r] + src_e[k] : e[r];
          const float r2 = dx * dx + dy * dy + dz * dz + ee;
          const float inv_r = rsqrtf(r2);
          a[r + 2 * h] = real ? sj.w * (inv_r * inv_r * inv_r) : 0.f;
        }
        b[h] = b_column(sj, g, real);
      }
      // each k-step's product starts from zero and is added to the tile's
      // sum by round-to-nearest FADDs: chained through the tensor cores'
      // own f32 accumulation, which does not round to nearest, over a
      // tile's 96 products, the sums of a cloud far off the origin left
      // K1's bound on the card (PERF.md, PR 5)
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      mma_3xtf32(d, a, b);
#pragma unroll
      for (int q = 0; q < 4; ++q) c[q] += d[q];
    }
    // the tile's partial[:, :3] - p_i * partial[:, 3]; column 3 (the sum
    // of w) sits in c[1] and c[3] of lane t = 1 of this lane's group
    const float sw0 = __shfl_sync(0xffffffffu, c[1], (lane & ~3) | 1);
    const float sw1 = __shfl_sync(0xffffffffu, c[3], (lane & ~3) | 1);
    acc[0] += c[0] - pc[0] * sw0;
    acc[1] += c[1] - pc[1] * sw0;
    acc[2] += c[2] - pc[2] * sw1;
    acc[3] += c[3] - pc[3] * sw1;
    __syncthreads();
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int i = row0 + g + 8 * (q >> 1);
    const int col = 2 * t + (q & 1);
    if (i < m && col < 3) out[3 * (size_t)i + col] = acc[q];
  }
}

}  // namespace

extern "C" {

// Launch on `stream`.  pos_i (m,3), pos_j (n,3), gm_j (n,), out (m,3): f32,
// contiguous, on the current device.  eps2_i (m,) and eps2_j (n,) are both
// null (scalar softening eps2) or both set (per-body mode).  Returns the
// cudaError_t of the launch.
int nbody_allpairs_mma_f32(const float* pos_i, const float* pos_j, const float* gm_j,
                           const float* eps2_i, const float* eps2_j, float eps2, int m,
                           int n, float* out, void* stream) {
  if (m <= 0) return cudaSuccess;
  const dim3 grid((m + kRows - 1) / kRows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (eps2_i != nullptr) {
    allpairs_mma_kernel<true><<<grid, kThreads, 0, s>>>(pos_i, pos_j, gm_j, eps2_i,
                                                        eps2_j, eps2, m, n, out);
  } else {
    allpairs_mma_kernel<false><<<grid, kThreads, 0, s>>>(pos_i, pos_j, gm_j, nullptr,
                                                         nullptr, eps2, m, n, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
