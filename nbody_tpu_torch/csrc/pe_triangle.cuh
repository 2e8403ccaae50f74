// pe_triangle.cuh — the schedule of the potential-energy kernels K3
// (potential.cu, f32) and K5 (potential_f64.cu, fp64).  Both compute
//
//     S = sum_{i != j} -m_i m_j / r_ij = 2 sum_{i < j} -m_i m_j / r_ij,
//
// 1/r := 0 at r = 0.  The pair term is symmetric bit for bit ((a - b)^2
// equals (b - a)^2 in IEEE arithmetic), so each unordered pair {i, j} is
// evaluated once, as the reference does (common/get_energy.c:23-46), and
// the sum is doubled, which is exact.  The self pair is never evaluated.
//
// Work.  Rows come in row blocks of kPeRows = 512: 128 threads, four rows a
// thread (i = row0 + u + 128 k).  Row block I pairs with the sources
// I * kPeRows ... n - 1: its n - I * kPeRows "items" of the upper triangle.
// Its own 512 sources are masked to j > i pair by pair, which also drops
// the rows past n; every later source pairs with all four rows unmasked.
// The items, row block after row block, are cut into `blocks` contiguous
// shares that differ by at most one item, one share a CUDA block, so every
// block sweeps the same number of sources however short the triangle's
// last rows are.  A block finds the row block of its first item by a
// binary search, then walks its share: the row block's rows into
// registers, its sources through shared memory in tiles of P::kTile rows
// (each staged row one broadcast load for four chains), the next row block
// where the share crosses one.
//
// Grid.  blocks = kPeWaves = 16 waves of the card's resident blocks of the
// kernel (SMs x cudaOccupancyMaxActiveBlocksPerMultiprocessor), or one for
// every kPeShare = 512 items where that is fewer.  Equal items are not
// equal time (the likely cause, not measured apart: the masked items, a
// select each and half their pairs dropped, gather at the triangle's
// end), so one wave of equal shares waits on its last blocks; with 16 the
// card's block scheduler evens the tail out.  Item counts are 64-bit: at
// 10M bodies the triangle holds 9.8e10 items, and 16 waves on an H100 are
// ~13k blocks, their partials ~100 KB, far below 2^31 blocks.  In a trial
// on the card (PERF.md) one wave of equal shares was the slowest grid for
// both kernels, and a block for every 512 x 512 tile of the triangle (the
// 2-D triangle grid, 1.9M blocks at 1M, 1.5 GB of partials at 10M) no
// faster than this one.  A row block paired with its mirror in one block
// was not tried.
//
// Sums.  A thread sums m_j r_ij^-1 over at most kPeChunk = 256 sources in
// the kernel's type (f32 in K3: the port's f32 pair terms, in chains no
// longer than before), then folds the chunk times m_i into one fp64
// register.  A block adds its threads' sums in shared memory (a fixed
// tree) and writes its partial to its own slot; a second single-block pass
// adds the partials in a fixed order and doubles the total.  Nothing is
// atomic, so reruns are bit-identical.
//
// Guards.  The pair loops take P::inv_r, the hardware seed, flushing
// subnormals: at r^2 = 0 or a subnormal r^2 (r below 1.1e-19 in f32,
// 1.5e-154 in fp64) it gives inf or NaN, and there is no select in the
// loop.  At each fold a row whose chunk sum is not finite is summed again
// over the chunk with P::inv_r_exact and the guard r^2 > 0: a rare branch
// that gives the plain version's value for coincident bodies (0) and for
// those too close for the seed.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kPeThreads = 128;
constexpr int kPePer = 4;                     // rows a thread
constexpr int kPeRows = kPeThreads * kPePer;  // rows of a row block
constexpr int kPeChunk = 256;                 // sources between folds
constexpr int kPeWaves = 16;                  // waves of resident blocks at most
constexpr int kPeShare = 512;                 // items a block at least

// The items (row block, source) of the row blocks before row block I.
__host__ __device__ __forceinline__ long long pe_items_before(long long I, long long n) {
  return I * n - kPeRows * (I * (I - 1) / 2);
}

// The items of the whole triangle.
__host__ __device__ __forceinline__ long long pe_items(int n) {
  return pe_items_before((n + kPeRows - 1) / kPeRows, n);
}

// An FMA in the kernel's type.
__device__ __forceinline__ float pe_fma(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double pe_fma(double a, double b, double c) { return fma(a, b, c); }

template <class Src, class Real>
__device__ __forceinline__ Real pe_r2(const Src& s, Real xi, Real yi, Real zi) {
  const Real dx = s.x - xi;
  const Real dy = s.y - yi;
  const Real dz = s.z - zi;
  return pe_fma(dx, dx, pe_fma(dy, dy, dz * dz));
}

// The rare branch: sum_j m_j r_ij^-1 over the staged sources s[0, c1 - c0)
// (sources c0 ... c1 - 1) for row i, with the guards.
template <class P, class Src, class Real>
__device__ Real pe_chunk_exact(const Src* s, int c0, int c1, int i, Real xi, Real yi,
                               Real zi) {
  Real sum = 0;
  for (int j = c0; j < c1; ++j) {
    const Real r2 = pe_r2(s[j - c0], xi, yi, zi);
    if (j > i && r2 > Real(0)) sum = pe_fma(s[j - c0].w, P::inv_r_exact(r2), sum);
  }
  return sum;
}

// The sum of every thread's v, in a fixed order; `red` is shared memory of
// kPeThreads doubles.  The total is thread 0's.
__device__ __forceinline__ double pe_block_sum(double v, double* red) {
  const int tid = threadIdx.x;
  red[tid] = v;
  __syncthreads();
  for (int half = kPeThreads / 2; half > 0; half >>= 1) {
    if (tid < half) red[tid] += red[tid + half];
    __syncthreads();
  }
  return red[0];
}

template <class P>
__global__ void __launch_bounds__(kPeThreads)
pe_triangle_kernel(const typename P::Real* __restrict__ pos,
                   const typename P::Real* __restrict__ mass, int n, int blocks,
                   double* __restrict__ partials) {
  using Real = typename P::Real;
  using Src = typename P::Src;
  __shared__ __align__(16) Src src[P::kTile];
  __shared__ double red[kPeThreads];

  const int u = threadIdx.x;
  const long long b = blockIdx.x;
  const long long total = pe_items(n);
  const long long share = total / blocks, rest = total % blocks;
  long long at = b * share + (b < rest ? b : rest);
  const long long end = at + share + (b < rest ? 1 : 0);
  int I = 0;  // the row block of item `at`
  for (int hi = (n - 1) / kPeRows; I < hi;) {
    const int mid = (I + hi + 1) / 2;
    if (pe_items_before(mid, n) <= at) {
      I = mid;
    } else {
      hi = mid - 1;
    }
  }

  double tot = 0.0;
  for (; at < end; ++I) {
    const int row0 = I * kPeRows;
    const long long first = pe_items_before(I, n);
    const long long stop = min(end, first + static_cast<long long>(n - row0));
    const int s0 = row0 + static_cast<int>(at - first);
    const int s1 = row0 + static_cast<int>(stop - first);
    const int own = row0 + kPeRows;  // sources below it are the rows': masked
    int ri[kPePer];
    Real xi[kPePer], yi[kPePer], zi[kPePer], mi[kPePer], acc[kPePer];
#pragma unroll
    for (int k = 0; k < kPePer; ++k) {
      ri[k] = row0 + u + k * kPeThreads;
      xi[k] = yi[k] = zi[k] = mi[k] = acc[k] = Real(0);
      if (ri[k] < n) {
        xi[k] = pos[3 * (size_t)ri[k] + 0];
        yi[k] = pos[3 * (size_t)ri[k] + 1];
        zi[k] = pos[3 * (size_t)ri[k] + 2];
        mi[k] = mass[ri[k]];
      }
    }
    for (int t0 = s0; t0 < s1; t0 += P::kTile) {
      const int t1 = min(t0 + P::kTile, s1);
      for (int j = t0 + u; j < t1; j += kPeThreads) src[j - t0] = P::load(pos, mass, j);
      __syncthreads();
      for (int c0 = t0; c0 < t1; c0 += kPeChunk) {
        const int c1 = min(c0 + kPeChunk, t1);
        const int m1 = max(c0, min(c1, own));
#pragma unroll 2
        for (int j = c0; j < m1; ++j) {
          const Src s = src[j - t0];
#pragma unroll
          for (int k = 0; k < kPePer; ++k) {
            const Real y = P::inv_r(pe_r2(s, xi[k], yi[k], zi[k]));
            acc[k] = pe_fma(s.w, j > ri[k] ? y : Real(0), acc[k]);
          }
        }
#pragma unroll (P::kUnroll)
        for (int j = m1; j < c1; ++j) {
          const Src s = src[j - t0];
#pragma unroll
          for (int k = 0; k < kPePer; ++k)
            acc[k] = pe_fma(s.w, P::inv_r(pe_r2(s, xi[k], yi[k], zi[k])), acc[k]);
        }
#pragma unroll
        for (int k = 0; k < kPePer; ++k) {
          if (!isfinite(acc[k]))
            acc[k] = pe_chunk_exact<P>(src + (c0 - t0), c0, c1, ri[k], xi[k], yi[k], zi[k]);
          tot = fma(static_cast<double>(mi[k]), static_cast<double>(acc[k]), tot);
          acc[k] = Real(0);
        }
      }
      __syncthreads();
    }
    at = stop;
  }
  const double sum = pe_block_sum(tot, red);
  if (u == 0) partials[blockIdx.x] = -sum;
}

// The partials, added in a fixed order by one block, doubled into out[0].
__global__ void __launch_bounds__(kPeThreads)
pe_sum_kernel(const double* __restrict__ partials, int count, double* __restrict__ out) {
  __shared__ double red[kPeThreads];
  double acc = 0.0;
  for (int k = threadIdx.x; k < count; k += kPeThreads) acc += partials[k];
  const double sum = pe_block_sum(acc, red);
  if (threadIdx.x == 0) out[0] = 2.0 * sum;
}

// The blocks of the launch for n bodies, which is its number of partials,
// or -cudaError_t where the card cannot be asked.
template <class P>
int pe_blocks(int n) {
  const long long items = pe_items(n);
  if (items == 0) return 0;
  int dev = 0, sms = 0, resident = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, pe_triangle_kernel<P>,
                                                        kPeThreads, 0);
  if (err == cudaSuccess && sms * resident == 0) err = cudaErrorInvalidConfiguration;
  if (err != cudaSuccess) return -static_cast<int>(err);
  const long long cap = static_cast<long long>(sms) * resident * kPeWaves;
  const long long want = (items + kPeShare - 1) / kPeShare;
  return static_cast<int>(want < cap ? want : cap);
}

// Both passes on `stream`: pe_blocks<P>(n) partials, then their sum.
template <class P>
int pe_launch(const typename P::Real* pos, const typename P::Real* mass, int n,
              double* partials, double* out, void* stream) {
  const int blocks = pe_blocks<P>(n);
  if (blocks < 0) return -blocks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (blocks > 0) {
    pe_triangle_kernel<P><<<blocks, kPeThreads, 0, s>>>(pos, mass, n, blocks, partials);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  pe_sum_kernel<<<1, kPeThreads, 0, s>>>(partials, blocks, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
