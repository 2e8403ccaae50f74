// group_lists.cu — Barnes-Hut group x interaction-list evaluation (K7), for
// sm_90a, in f32 and in native fp64.
//
// Replaces the TPU kernel nbody_tpu/ops/barneshut.py::_group_kernel (called
// by _eval_lists_pallas), which evaluates each Morton group's B bodies
// against its interaction list in (BI, BJ) tiles of a (G, B/BI, M/BJ) grid,
// accumulating across the sequential j axis.  It computes, for every body
// slot i of group g,
//
//     a_i = sum_j gm_j * (r_j - r_i) * (|r_j - r_i|^2 + eps2)^(-3/2)
//
// over the rows [x y z G*m] of group g's list.  Pad slots repeat the group's
// first body and are dropped by the caller; zero-G*m list entries add exact
// zeros, and a body's own entry adds zero (zero displacement).
//
// What bounds it on the card: one rsqrt and about 20 operations per (slot,
// entry) pair, as K1 (allpairs.cu), against 16 bytes (32 in fp64) of
// shared memory per pair that the whole block shares.  Device-memory
// traffic is the list once per block of slots plus the bodies: O(G (M + B))
// for O(G B M) work, so it is compute-bound.
//
// Design: K1's.  One block per (group, chunk of up to kBlock slots), one
// thread per slot, its body in registers.  The list streams through shared
// memory in tiles of kBlock rows, each thread loading one row (float4 in
// f32, a 32-byte row in fp64).  Each group's loop stops at its length: the
// padded tail past it holds only zero-G*m rows, which add exact zeros, so
// the result is the full-M sum's.  Every slot sums its list in the same
// order on every run and nothing is atomic, so reruns are bit-identical.
// The (G, 4, M) planar list of the TPU kernel is TPU layout; the port's
// traversals write (G, M, 4) rows directly.
//
// Left for later: a group's list is read once per block of 256 slots
// (8 times at B = 2048); several groups per block, split-j for long lists
// and TMA bulk copies of the tiles are untried.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;

struct alignas(16) Row64 {
  double x, y, z, w;
};

template <typename T>
struct RowOf;
template <>
struct RowOf<float> {
  using type = float4;
};
template <>
struct RowOf<double> {
  using type = Row64;
};

__device__ __forceinline__ float inv_sqrt(float x) { return rsqrtf(x); }
__device__ __forceinline__ double inv_sqrt(double x) { return rsqrt(x); }

template <typename T>
__global__ void __launch_bounds__(kBlock)
group_lists_kernel(const T* __restrict__ pos_groups,
                   const typename RowOf<T>::type* __restrict__ lists,
                   const int* __restrict__ lengths, int b, int m, T eps2,
                   T* __restrict__ out) {
  using Row = typename RowOf<T>::type;
  __shared__ Row tile[kBlock];

  const int g = blockIdx.x;
  const int i = blockIdx.y * kBlock + threadIdx.x;
  const bool live = i < b;
  const size_t slot = (size_t)g * b + i;
  T xi = 0, yi = 0, zi = 0;
  if (live) {
    xi = pos_groups[3 * slot + 0];
    yi = pos_groups[3 * slot + 1];
    zi = pos_groups[3 * slot + 2];
  }
  const int len = min(max(lengths[g], 0), m);
  const Row* src = lists + (size_t)g * m;

  T ax = 0, ay = 0, az = 0;
  for (int t0 = 0; t0 < len; t0 += kBlock) {
    const int j = t0 + threadIdx.x;
    if (j < len) tile[threadIdx.x] = src[j];
    __syncthreads();
    const int count = min(kBlock, len - t0);
#pragma unroll 4
    for (int k = 0; k < count; ++k) {
      const Row s = tile[k];
      const T dx = s.x - xi;
      const T dy = s.y - yi;
      const T dz = s.z - zi;
      const T r2 = dx * dx + dy * dy + dz * dz + eps2;
      const T inv_r = inv_sqrt(r2);
      const T w = s.w * (inv_r * inv_r * inv_r);
      ax += w * dx;
      ay += w * dy;
      az += w * dz;
    }
    __syncthreads();
  }
  if (live) {
    out[3 * slot + 0] = ax;
    out[3 * slot + 1] = ay;
    out[3 * slot + 2] = az;
  }
}

template <typename T>
int launch_group_lists(const T* pos_groups, const T* lists, const int* lengths, int g,
                       int b, int m, T eps2, T* out, void* stream) {
  if (g <= 0 || b <= 0) return cudaSuccess;
  using Row = typename RowOf<T>::type;
  const dim3 grid(g, (b + kBlock - 1) / kBlock);
  group_lists_kernel<T><<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      pos_groups, reinterpret_cast<const Row*>(lists), lengths, b, m, eps2, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launch on `stream`.  pos_groups (g,b,3), lists (g,m,4) rows [x y z G*m]
// (16-byte aligned), lengths (g,) int32, out (g,b,3): contiguous, on the
// current device.  Returns the cudaError_t of the launch.
int nbody_group_lists_f32(const float* pos_groups, const float* lists, const int* lengths,
                          int g, int b, int m, float eps2, float* out, void* stream) {
  return launch_group_lists<float>(pos_groups, lists, lengths, g, b, m, eps2, out, stream);
}

// The same in fp64: pos_groups, lists (32-byte rows) and out are double.
int nbody_group_lists_f64(const double* pos_groups, const double* lists,
                          const int* lengths, int g, int b, int m, double eps2,
                          double* out, void* stream) {
  return launch_group_lists<double>(pos_groups, lists, lengths, g, b, m, eps2, out,
                                    stream);
}

}  // extern "C"
