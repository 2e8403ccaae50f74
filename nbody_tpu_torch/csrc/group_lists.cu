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
// zeros, and a body's own entry adds zero (zero displacement).  Each group's
// loop stops at its length: the padded tail past it holds only zero-G*m
// rows, which add exact zeros, so the result is the full-M sum's.  Nothing
// is atomic and every slot sums its list in an order fixed by the launch,
// so reruns are bit-identical.  The (G, 4, M) planar list of the TPU kernel
// is TPU layout; the port's traversals write (G, M, 4) rows directly.
// Device-memory traffic is the list once per block of slots plus the
// bodies: O(G (M + B)) for O(G B M) work, so both entries are bound by
// their pair rate.
//
// Both entries share one design, K1's and K4's (allpairs.cu,
// allpairs_f64.cu) applied to groups.  A block of 128 threads holds kPer =
// 4 slots a thread, and streams the list through shared memory in tiles of
// 512 rows (kTileF32, kTileF64), each staged row feeding four independent
// chains.  Each block splits every tile over `split` = S groups of 128 / S
// threads that hold the same slots; their sums meet in shared memory in
// the fixed order s = 0 ... S - 1 (split_sum.cuh).  The wrapper picks S
// from G, B and the SM count for both entries
// (ops/cuda_lists.py::k7_split): the groups' lists differ in length, so
// many small blocks even out the last of them (S = 8 at 100k bodies, 120
// groups of B = 1,792; S = 4 at 1M, 1,001 of B = 2,048).  The last chunk
// of slots may be partial; threads past B stage rows but write nothing,
// and pad slots are computed like any other, so they equal slot 0.
//
// f32 (nbody_group_lists_f32): bound by fp32 issue.  The pair term is
// pair_f32.cuh's, K1's: 12 fp32 instructions and one MUFU.RSQ
// (rsqrt.approx.ftz.f32) a pair.  On an NVIDIA H100 80GB HBM3 at 700 W
// (PERF.md, trials/kernel_trial.py) it took 5.20-5.22 ms on the 1M flat
// lists where the earlier body (one thread a slot, 256-row tiles, CUDA's
// rsqrtf: 15 fp32 instructions a pair, no split) took 7.04-7.09.  Its
// tile, kTileF32, is its own: tiles of 1,024 and 2,048 rows (K1's) were
// 0.2-0.6 % slower at 1M and 3-5 % slower at 100k, tiles of 256 rows 1-7 %
// slower.
//
// fp64 (nbody_group_lists_f64): bound by fp64 issue: the pair term of
// pair_f64.cuh is 16 fp64 instructions from the displacement to the sums.
// 256 threads a block, tiles of 1,024 rows, two slots a thread and other
// unrollings were within 2 % in a trial on the card (PERF.md).

#include <cuda_runtime.h>

#include "pair_f32.cuh"
#include "pair_f64.cuh"
#include "split_sum.cuh"

namespace {

constexpr int kThreads = 128;  // threads a block
constexpr int kPer = 4;        // slots a thread
constexpr int kTileF32 = 512;  // list rows per shared tile, f32 (16-byte rows)
constexpr int kTileF64 = 512;  // and fp64 (32-byte rows)

struct alignas(16) Row64 {
  double x, y, z, w;
};

// One list row r on the slot at (xi, yi, zi): the f32 or the fp64 pair term.
__device__ __forceinline__ void accumulate(const float4 r, float xi, float yi, float zi,
                                           float eps2, float& ax, float& ay, float& az) {
  accumulate_f32(r, xi, yi, zi, eps2, ax, ay, az);
}
__device__ __forceinline__ void accumulate(const Row64 r, double xi, double yi, double zi,
                                           double eps2, double& ax, double& ay,
                                           double& az) {
  accumulate_f64(r, xi, yi, zi, eps2, ax, ay, az);
}

// T is float with Row float4, or double with Row Row64; kTile list rows a
// shared tile.
template <class T, class Row, int kTile>
__global__ void __launch_bounds__(kThreads, 4)
group_lists_kernel(const T* __restrict__ pos_groups, const Row* __restrict__ lists,
                   const int* __restrict__ lengths, int b, int m, T eps2, int split,
                   T* __restrict__ out) {
  // the list tile; after the last tile, the groups' partial sums
  constexpr int kWords = kTile * 4 > kThreads * kPer * 3 ? kTile * 4 : kThreads * kPer * 3;
  __shared__ __align__(16) T smem[kWords];
  Row* tile = reinterpret_cast<Row*>(smem);

  const int g = blockIdx.x;
  const int width = kThreads / split;  // threads of a group
  const int s = threadIdx.x / width;   // this thread's group (list slice)
  const int u = threadIdx.x % width;   // its place in the group
  const int base = blockIdx.y * width * kPer;
  T xi[kPer], yi[kPer], zi[kPer], ax[kPer], ay[kPer], az[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = base + u + k * width;
    xi[k] = yi[k] = zi[k] = 0;
    ax[k] = ay[k] = az[k] = 0;
    if (i < b) {
      const size_t slot = (size_t)g * b + i;
      xi[k] = pos_groups[3 * slot + 0];
      yi[k] = pos_groups[3 * slot + 1];
      zi[k] = pos_groups[3 * slot + 2];
    }
  }
  const int len = min(max(lengths[g], 0), m);
  const Row* src = lists + (size_t)g * m;

  const int slice = kTile / split;
  for (int t0 = 0; t0 < len; t0 += kTile) {
    for (int r = threadIdx.x; r < kTile; r += kThreads) {
      const int j = t0 + r;
      if (j < len) tile[r] = src[j];
    }
    __syncthreads();
    const int lo = s * slice;
    const int hi = min(lo + slice, len - t0);
#pragma unroll 4
    for (int q = lo; q < hi; ++q) {
      const Row r = tile[q];
#pragma unroll
      for (int k = 0; k < kPer; ++k)
        accumulate(r, xi[k], yi[k], zi[k], eps2, ax[k], ay[k], az[k]);
    }
    __syncthreads();
  }

  if (!meet_groups<kPer>(smem, split, width, s, u, ax, ay, az)) return;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = base + u + k * width;
    if (i < b) {
      const size_t slot = (size_t)g * b + i;
      out[3 * slot + 0] = ax[k];
      out[3 * slot + 1] = ay[k];
      out[3 * slot + 2] = az[k];
    }
  }
}

// Checks `split` and launches the entry's kernel on `stream`.
template <class T, class Row, int kTile>
int launch_lists(const T* pos_groups, const T* lists, const int* lengths, int g, int b,
                 int m, T eps2, int split, T* out, void* stream) {
  if (split != 1 && split != 2 && split != 4 && split != 8)
    return static_cast<int>(cudaErrorInvalidValue);
  if (g <= 0 || b <= 0) return cudaSuccess;
  const int per_block = kThreads / split * kPer;
  const dim3 grid(g, (b + per_block - 1) / per_block);
  group_lists_kernel<T, Row, kTile><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      pos_groups, reinterpret_cast<const Row*>(lists), lengths, b, m, eps2, split, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launch on `stream`.  pos_groups (g,b,3), lists (g,m,4) rows [x y z G*m]
// (16-byte aligned), lengths (g,) int32, out (g,b,3): contiguous, on the
// current device.  `split` (1, 2, 4 or 8) is the number of list slices a
// block sweeps for the same slots.  Returns the cudaError_t of the launch.
int nbody_group_lists_f32(const float* pos_groups, const float* lists, const int* lengths,
                          int g, int b, int m, float eps2, int split, float* out,
                          void* stream) {
  return launch_lists<float, float4, kTileF32>(pos_groups, lists, lengths, g, b, m, eps2,
                                               split, out, stream);
}

// The same in fp64: pos_groups, lists (32-byte rows) and out are double.
int nbody_group_lists_f64(const double* pos_groups, const double* lists,
                          const int* lengths, int g, int b, int m, double eps2, int split,
                          double* out, void* stream) {
  return launch_lists<double, Row64, kTileF64>(pos_groups, lists, lengths, g, b, m,
                                                eps2, split, out, stream);
}

}  // extern "C"
