// allpairs_mma.cu — softened all-pairs accelerations, f32, with the j-sum on
// the tensor cores, for sm_90a (K2).
//
// Replaces the TPU kernel nbody_tpu/ops/pallas_exhaustive.py::_kernel_mxu
// (use_mxu=True), which computes the (BI, BJ) weight matrix on the VPU and
// contracts it with the j-tile's [x y z 1] columns on the MXU.  Over an
// (M targets x N sources) rectangle, per tile of sources:
//
//     w_ij    = gm_j * (|r_j - r_i|^2 + eps2_ij)^(-3/2)   (r^2 exact, not expanded)
//     partial = W @ [x_j - c, y_j - c, z_j - c, 1]       (tensor cores)
//     a_i    += partial[:, 0:3] - (r_i - c) * partial[:, 3]
//
// with gm_j = G * m_j folded in by the wrapper; per-body mode uses
// eps2_ij = eps2_i / 2 + eps2_j / 2.  The subtraction is made per tile, as
// _kernel_mxu makes it per j-block, so the running sum holds forces.  W is
// taken apart as K diag(gm), K_ij = (|r_j - r_i|^2 + eps2_ij)^(-3/2): the
// CUDA cores compute K and the tensor cores take gm with the columns, B =
// diag(gm) [x - c, y - c, z - c, 1], which is the same product.  c is the
// block's first target: the columns hold offsets within the cloud, not
// coordinates, so a cloud far from the origin sums no larger terms than
// one around it.
//
// What bounds it on the card: fp32 issue on the CUDA cores, as in K1.  A
// pair is 3 FADD for the displacement, 3 FFMA for |d|^2 + eps2, one
// MUFU.RSQ (rsqrt.cuh's rsqrt_ftz), 2 FMUL for r^-3 and the split of K_ij
// into TF32 halves (a mask and an FADD); the three FFMAs of K1's sums are
// the tensor cores' (2 x 16 flops a pair, ~1 % of their TF32 rate).
// chip_smoke.py phase 1 counts the SASS.  Device bytes are O(M + N).
//
// Design: a block of 4 warps owns 256 targets and their whole j loop (no
// atomics, bit-identical reruns).  Sources stream through shared memory in
// tiles of 512 rows; each tile is staged once for the block in two forms:
// [x y z e_j] rows for the weights, and B's fragments, ready for each lane,
// B = [hi(v) | lo(v)] with v = gm [x - c, y - c, z - c, 1] and hi, lo its
// TF32 halves (cvt.rna), so no warp selects or splits B.  A ragged last
// tile is padded with rows at x = +inf (r^2 = inf, K = 0) whose B columns
// are 0, so the pair loop has no select.  Each warp owns kMT = 4 m16 tiles
// (PTX ISA fragment layout for mma.m16n8k8 .tf32: a0 (g, t), a1 (g + 8,
// t), a2 (g, t + 4), a3 (g + 8, t + 4) with g = lane / 4, t = lane % 4):
// per 8-source k-step a lane loads two source rows and its B fragment and
// computes the K of its own A-fragment positions in registers, 16 pairs.
// The product takes two mma.sync a k-step, K_hi B and K_lo B, where K_hi is
// K with its low 13 bits cleared and K_lo = K - K_hi, which the tensor
// cores read to its top 11 bits (they drop an operand's low 13 bits, a
// probe on the card found): with B's two halves that is all four products
// of 3xTF32 and lo·lo, what JAX's Precision.HIGHEST asks of the MXU.  The
// tensor cores' sums of kChain = 8 k-steps are added to the tile's
// partial by FADD: their own f32 accumulation does not round to nearest,
// and a whole tile's chain put 7x the error on the 100k bodies.  Columns c
// and c + 4 of the product meet in the tile's epilogue (lanes t and t + 2).
//
// On an NVIDIA H100 80GB HBM3 at 700 W (PERF.md, trials/kernel_trial.py) it
// took 5.44-5.45 ms at 100k x 100k where the earlier body (3xTF32 in three
// mma.sync, B selected and split in every warp, CUDA's rsqrtf) took 14.43.
// Two m16 tiles a warp (8 warps) took 5.71 ms, one 6.19; a chain of one
// k-step 6.79, a whole tile's 5.31; tiles of 256 rows 5.50; wgmma
// (trials/allpairs_wgmma.cu) in place of mma.sync 6.82.

#include <cuda_runtime.h>

#include "rsqrt.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kMT = 4;                   // m16 tiles a warp
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kMT * kWarps; // targets a block
constexpr int kTile = 512;               // sources a shared tile
constexpr int kSteps = kTile / 8;        // k-steps a tile
constexpr int kChain = 8;                // k-steps summed on the tensor cores

// The CPU emulation of the kernel sources brings its own twins of these
// two and defines NBODY_EMULATED_MMA.
#ifndef NBODY_EMULATED_MMA
// v rounded to TF32 (to nearest, ties away from zero), low 13 bits zero.
__device__ __forceinline__ float tf32_rna(float v) {
  unsigned u;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(u) : "f"(v));
  return __uint_as_float(u);
}

// d += a @ b for the warp's m16n8k8 .tf32 fragments (layout above); b0 and
// b1 of b are TF32 values.
__device__ __forceinline__ void mma_tf32(float d[4], const unsigned a[4], float2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(__float_as_uint(b.x)),
        "r"(__float_as_uint(b.y)));
}
#endif

// K_ij of source s = [x y z e_j] on the target at p with softening e (the
// pair's is e + e_j in per-body mode).
template <bool kPerBody>
__device__ __forceinline__ float kernel_weight(const float4 s, const float p[3], float e) {
  const float dx = s.x - p[0];
  const float dy = s.y - p[1];
  const float dz = s.z - p[2];
  const float r2 = fmaf(dx, dx, fmaf(dy, dy, fmaf(dz, dz, kPerBody ? e + s.w : e)));
  const float inv_r = rsqrt_ftz(r2);
  return (inv_r * inv_r) * inv_r;
}

template <bool kPerBody>
__global__ void __launch_bounds__(kThreads)
allpairs_mma_kernel(const float* __restrict__ pos_i, const float* __restrict__ pos_j,
                    const float* __restrict__ gm_j, const float* __restrict__ eps2_i,
                    const float* __restrict__ eps2_j, float eps2, int m, int n,
                    float* __restrict__ out) {
  __shared__ float4 src[kTile];                    // [x y z e_j] rows
  __shared__ __align__(8) float bfrag[kSteps * 64];  // per k-step, lane: b0, b1

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // A rows g and g + 8; B and C column group g
  const int t = lane & 3;   // A columns t and t + 4; C columns 2t and 2t + 1
  const int first = blockIdx.x * kRows;
  const int row0 = first + (threadIdx.x >> 5) * 16 * kMT;
  // c: the block's first target
  const float c[3] = {pos_i[3 * (size_t)first + 0], pos_i[3 * (size_t)first + 1],
                      pos_i[3 * (size_t)first + 2]};

  // this lane's targets: rows g and g + 8 of each m-tile; rows past m
  // compute on the origin and are never written
  float p[kMT][2][3], e[kMT][2], pc[kMT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = row0 + 16 * mt + g + 8 * r;
      const bool live = i < m;
#pragma unroll
      for (int d = 0; d < 3; ++d) p[mt][r][d] = live ? pos_i[3 * (size_t)i + d] : 0.f;
      e[mt][r] = kPerBody ? (live ? 0.5f * eps2_i[i] : 0.f) : eps2;
    }
    // the target's offset from c under each of this lane's C entries (0 past z)
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
      float v[4] = {0.f, 0.f, 0.f, 0.f};  // gm [x - c, y - c, z - c, 1]
      if (j < n) {
        const float x = pos_j[3 * (size_t)j + 0], y = pos_j[3 * (size_t)j + 1],
                    z = pos_j[3 * (size_t)j + 2], gm = gm_j[j];
        src[r] = make_float4(x, y, z, kPerBody ? 0.5f * eps2_j[j] : 0.f);
        v[0] = gm * (x - c[0]);
        v[1] = gm * (y - c[1]);
        v[2] = gm * (z - c[2]);
        v[3] = gm;
      } else {
        src[r] = make_float4(__int_as_float(0x7f800000), 0.f, 0.f, 0.f);  // +inf
      }
      // row q = r % 8 of k-step r / 8: b0 (q < 4) or b1 of lanes (column, q % 4)
      float* frag = bfrag + (r >> 3) * 64 + ((r & 7) >> 2);
#pragma unroll
      for (int col = 0; col < 4; ++col) {
        const float hi = tf32_rna(v[col]);
        frag[2 * (4 * col + (r & 3))] = hi;
        frag[2 * (4 * (col + 4) + (r & 3))] = tf32_rna(v[col] - hi);
      }
    }
    __syncthreads();
    const int steps = (min(kTile, n - t0) + 7) / 8;  // warp-uniform
    float part[kMT][4] = {};  // the tile's product
    for (int s0 = 0; s0 < steps; s0 += kChain) {
      float d[kMT][4] = {};
      const int s1 = min(s0 + kChain, steps);
#pragma unroll 2
      for (int s = s0; s < s1; ++s) {
        const float2 b = reinterpret_cast<const float2*>(bfrag)[s * 32 + lane];
        const float4 u0 = src[8 * s + t];
        const float4 u1 = src[8 * s + t + 4];
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          const float k[4] = {kernel_weight<kPerBody>(u0, p[mt][0], e[mt][0]),
                              kernel_weight<kPerBody>(u0, p[mt][1], e[mt][1]),
                              kernel_weight<kPerBody>(u1, p[mt][0], e[mt][0]),
                              kernel_weight<kPerBody>(u1, p[mt][1], e[mt][1])};
          unsigned hi[4], lo[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            hi[q] = __float_as_uint(k[q]) & 0xffffe000u;
            lo[q] = __float_as_uint(k[q] - __uint_as_float(hi[q]));
          }
          mma_tf32(d[mt], hi, b);
          mma_tf32(d[mt], lo, b);
        }
      }
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int q = 0; q < 4; ++q) part[mt][q] += d[mt][q];
    }
    // columns c and c + 4 (lanes t and t + 2) meet; then the tile's
    // partial[:, :3] - (p_i - c) * partial[:, 3], column 3 (the sum of w)
    // in v[1] and v[3] of lane t = 1 of this lane's group
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
      const int i = row0 + 16 * mt + g + 8 * (q >> 1);
      const int col = 2 * t + (q & 1);
      if (i < m && col < 3) out[3 * (size_t)i + col] = acc[mt][q];
    }
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
