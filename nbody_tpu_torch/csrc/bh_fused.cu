// bh_fused.cu — fused Barnes-Hut traverse + evaluate, f32 and fp64 (df)
// modes, for sm_90a.
//
// Replaces the TPU kernel nbody_tpu/ops/bh_fused.py::_fused_kernel, in its
// f32 mode and its df mode (df=True, used by nbody_tpu/ops/bh_fused_df.py).
// One thread block handles one Morton group: the bodies
// [gstart, gstart + gcount) of the sorted source array.  For each group it
//
//   1. takes the group's bounding box;
//   2. runs a level-synchronous BFS over the dense grid (ops/bh_grid.py):
//      the frontier of level d holds cells whose 8 children (level d+1)
//      are classified against the box with the group MAC
//        far  if theta^2 * d2 > (border / 2^(d+1))^2, d2 = squared distance
//             from the child's centre of mass to the box;
//        near if not far and (count <= leaf_cap or level d+1 is terminal);
//        open otherwise — the child joins the next level's frontier;
//   3. stages each far child as one source [com, G·m] and each near child
//      as its sorted body run (over-full terminal cells ship their bodies
//      exactly: no terminal-COM residual);
//   4. evaluates every body against every staged source with K1's formula
//        a += gm * d * (|d|^2 + eps2)^(-3/2)
//      — a body's own entry gives d = 0 and adds nothing.
//
// The two modes are one kernel body, templated on the evaluation type R:
//   * f32 (R = float): tables, sources and accumulators in f32;
//   * df (R = double): tables, sources, eps2 and accumulators in fp64, but
//     the MAC stays in f32, as the TPU kernel's df mode classifies on the
//     f32 hi halves: the box is taken over (float) of the body coordinates,
//     each child's centre of mass enters as (float) of the fp64 table, and
//     bsq and theta^2 are f32.  So the df mode opens and accepts the same
//     cells as the f32 kernel would on the same tables, and only the force
//     arithmetic changes precision.  On the TPU that arithmetic is
//     double-float (f32 hi + lo pairs, ~290 VPU operations per pair);
//     Hopper has fp64 units, so here it is native fp64.
//
// The only capacity is the frontier (fcap cells per level).  Its counter
// runs on past fcap, cells beyond it are dropped, and the largest needed
// count is reported in the overflow stat so the caller can prescribe the
// cap that fits.  The next level then takes the first fcap cells only.
//
// Determinism: the MAC is written with __fmul_rn/__fadd_rn so that nvcc
// cannot contract it into FMAs; the decisions then match the plain PyTorch
// version (ops/bh_fused.py::fused_group_forces_reference) bit for bit and
// the stats compare for equality.  Far, near and open entries are compacted
// in (frontier, child) order by a block-wide prefix scan, not appended with
// atomics, and there are no float atomics: the same input gives the same
// accelerations on every run.
//
// What bounds it on the card: the evaluation, one pair per (body, source),
// ~20 FP32 operations and one rsqrt in f32 mode (K1's work); in df mode
// allpairs_f64.cu's work, 17.9 fp64 instructions per pair in the SASS
// (sm_90a, nvcc 12.9; chip_smoke.py phase 1 counts them), at half the
// fp32 issue rate.
// At 1M uniform bodies a group sees ~10^4 sources, against a few hundred
// frontier cells, so the traversal is a small share.  Design for that: each
// thread holds its bodies' coordinates and accumulators in registers;
// staged sources sit in shared memory (far sources as rows [x y z G·m], near
// runs as (start, offset) pairs that stream through a row tile as in K1).
// The staging buffers are evaluated and emptied whenever a classification
// round could overflow them.
//
// Registers: a block of up to 1024 threads leaves each thread at most 64
// registers.  The f32 mode runs one body per thread.  fp64 coordinates and
// accumulators take twice the registers, so the df mode runs half the
// threads with two bodies each (bodies t and t + blockDim): up to 128
// registers per thread, and each source row read from shared memory serves
// two bodies.  Group sizes and groups are the same in both modes.  ptxas
// (nvcc 12.9) gives the f32 mode 60 registers and the df mode 98, neither
// spilling.  Shared memory per block at B = 1024 and a 2048-cell frontier:
// 94,592 bytes in f32 mode, 121,216 in df mode (32-byte source rows).
//
// Left for later: one block per group leaves the SM idle at every block-
// wide barrier of the traversal; several groups per block or warp-level
// traversal would hide that.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;  // bodies per group, at most
constexpr int kFarCap = 2048;      // staged far sources
constexpr int kNearCap = 2048;     // staged near cells
constexpr int kMaxLd = 8;
// stats lanes, as ops/bh_fused.py
constexpr int kStatPops = 0, kStatSources = 1, kStatNear = 2, kStatOverflow = 3,
              kStatFar = 4, kNumStats = 5;

struct alignas(16) Src64 {
  double x, y, z, w;
};

// Per evaluation type: the staged source row, bodies per thread, rsqrt.
template <class R>
struct Eval;

template <>
struct Eval<float> {
  using Src = float4;
  static constexpr int kPer = 1;
  static __device__ __forceinline__ float rsqrt_(float x) { return rsqrtf(x); }
};

template <>
struct Eval<double> {
  using Src = Src64;
  static constexpr int kPer = 2;
  static __device__ __forceinline__ double rsqrt_(double x) { return rsqrt(x); }
};

__host__ __device__ inline int level_offset(int d) { return ((1 << (3 * d)) - 1) / 7; }

// Threads of a block for `group_size` bodies: a power of two, at least one
// warp, kPer bodies per thread.
template <class R>
__host__ inline int block_threads(int group_size) {
  int t = 32;
  while (t * Eval<R>::kPer < group_size) t <<= 1;
  return t;
}

template <class R>
__host__ inline size_t smem_bytes(int threads, int fcap) {
  using Src = typename Eval<R>::Src;
  return sizeof(Src) * (kFarCap + threads)                // far sources, near tile
         + sizeof(int) * 2 * kNearCap                     // near starts, offsets
         + sizeof(unsigned long long) * (threads + 32)    // scan: flags
         + sizeof(int) * (threads + 32)                   // scan: near counts
         + sizeof(int) * 2 * fcap;                        // frontier, two levels
}

template <class R, class Src>
__device__ __forceinline__ void accumulate(const Src s, R xi, R yi, R zi, R eps2, R& ax,
                                           R& ay, R& az) {
  const R dx = s.x - xi;
  const R dy = s.y - yi;
  const R dz = s.z - zi;
  const R r2 = dx * dx + dy * dy + dz * dz + eps2;
  const R inv_r = Eval<R>::rsqrt_(r2);
  const R w = s.w * (inv_r * inv_r * inv_r);
  ax += w * dx;
  ay += w * dy;
  az += w * dz;
}

// Block-wide exclusive scan of (flags, count).  Flags pack three 16-bit
// counters (far | near << 16 | open << 32); every thread gets its exclusive
// prefix and the block totals.  Two barriers, no warp intrinsics; the
// caller's barrier after it orders the next call's writes.
__device__ void block_scan(unsigned long long f, int c, unsigned long long* sf, int* sc,
                           unsigned long long& ex_f, int& ex_c, unsigned long long& tot_f,
                           int& tot_c) {
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int w = t >> 5;
  const int nw = blockDim.x >> 5;
  unsigned long long* wf = sf + blockDim.x;
  int* wc = sc + blockDim.x;
  sf[t] = f;
  sc[t] = c;
  __syncthreads();
  unsigned long long in_f = 0;
  int in_c = 0;
  for (int k = t - lane; k <= t; ++k) {
    in_f += sf[k];
    in_c += sc[k];
  }
  if (lane == 31) {
    wf[w] = in_f;
    wc[w] = in_c;
  }
  __syncthreads();
  unsigned long long off_f = 0;
  int off_c = 0;
  tot_f = 0;
  tot_c = 0;
  for (int k = 0; k < nw; ++k) {
    if (k < w) {
      off_f += wf[k];
      off_c += wc[k];
    }
    tot_f += wf[k];
    tot_c += wc[k];
  }
  ex_f = off_f + in_f - f;
  ex_c = off_c + in_c - c;
}

template <class R>
__global__ void __launch_bounds__(kMaxThreads / Eval<R>::kPer)
bh_fused_kernel(const R* __restrict__ cx, const R* __restrict__ cy,
                const R* __restrict__ cz, const R* __restrict__ cgm,
                const int* __restrict__ ccnt, const int* __restrict__ cstart,
                const int* __restrict__ gstart, const int* __restrict__ gcount,
                const typename Eval<R>::Src* __restrict__ src, const float* __restrict__ bsq,
                float theta_sq, R eps2, int leaf_cap, int ld, int fcap,
                R* __restrict__ out, int* __restrict__ stats) {
  using Src = typename Eval<R>::Src;
  constexpr int kPer = Eval<R>::kPer;
  extern __shared__ __align__(16) unsigned char smem[];
  const int T = blockDim.x;
  Src* far_buf = reinterpret_cast<Src*>(smem);
  Src* tile = far_buf + kFarCap;
  int* near_start = reinterpret_cast<int*>(tile + T);
  int* near_off = near_start + kNearCap;
  unsigned long long* scan_f = reinterpret_cast<unsigned long long*>(near_off + kNearCap);
  int* scan_c = reinterpret_cast<int*>(scan_f + T + 32);
  int* fr_cur = scan_c + T + 32;
  int* fr_next = fr_cur + fcap;

  const int g = blockIdx.x;
  const int t = threadIdx.x;
  const int gc = gcount[g];
  int* st = stats + (size_t)g * kNumStats;
  if (gc == 0) {
    if (t < kNumStats) st[t] = 0;
    return;
  }
  const int gs = gstart[g];
  // this thread's bodies: t, t + T, ... of the group
  bool live[kPer];
  R xi[kPer], yi[kPer], zi[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    live[k] = t + k * T < gc;
    xi[k] = yi[k] = zi[k] = R(0);
    if (live[k]) {
      const Src p = src[gs + t + k * T];
      xi[k] = p.x;
      yi[k] = p.y;
      zi[k] = p.z;
    }
  }

  // 1. bounding box of the live bodies (tree min/max, exact), in f32: over
  // the f32-rounded coordinates in df mode
  float* red = reinterpret_cast<float*>(far_buf);  // 6 x T floats, free until staging
  const float inf = __int_as_float(0x7f800000);
  float blo[3] = {inf, inf, inf}, bhi[3] = {-inf, -inf, -inf};
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    if (live[k]) {
      const float p[3] = {(float)xi[k], (float)yi[k], (float)zi[k]};
      for (int a = 0; a < 3; ++a) {
        blo[a] = fminf(blo[a], p[a]);
        bhi[a] = fmaxf(bhi[a], p[a]);
      }
    }
  }
  for (int a = 0; a < 3; ++a) {
    red[a * T + t] = blo[a];
    red[(a + 3) * T + t] = bhi[a];
  }
  __syncthreads();
  for (int s = T >> 1; s > 0; s >>= 1) {
    if (t < s) {
      for (int k = 0; k < 3; ++k) red[k * T + t] = fminf(red[k * T + t], red[k * T + t + s]);
      for (int k = 3; k < 6; ++k) red[k * T + t] = fmaxf(red[k * T + t], red[k * T + t + s]);
    }
    __syncthreads();
  }
  const float lox = red[0], loy = red[T], loz = red[2 * T];
  const float hix = red[3 * T], hiy = red[4 * T], hiz = red[5 * T];
  __syncthreads();  // the box scratch becomes the far buffer

  R ax[kPer], ay[kPer], az[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) ax[k] = ay[k] = az[k] = R(0);
  int nfar = 0, nnear = 0, near_total = 0;  // staged now (block-uniform)
  int pops = 0, far_children = 0, near_bodies = 0, overflow = 0;

  // evaluate every staged source and empty the buffers (block-uniform call)
  auto flush = [&]() {
    for (int q = 0; q < nfar; ++q) {
      const Src s = far_buf[q];
#pragma unroll
      for (int k = 0; k < kPer; ++k)
        accumulate(s, xi[k], yi[k], zi[k], eps2, ax[k], ay[k], az[k]);
    }
    for (int base = 0; base < near_total; base += T) {
      const int f = base + t;
      if (f < near_total) {
        int lo = 0, hi = nnear - 1;  // last staged cell with near_off <= f
        while (lo < hi) {
          const int mid = (lo + hi + 1) >> 1;
          if (near_off[mid] <= f) lo = mid; else hi = mid - 1;
        }
        tile[t] = src[near_start[lo] + (f - near_off[lo])];
      }
      __syncthreads();
      const int m = min(T, near_total - base);
#pragma unroll 8
      for (int q = 0; q < m; ++q) {
        const Src s = tile[q];
#pragma unroll
        for (int k = 0; k < kPer; ++k)
          accumulate(s, xi[k], yi[k], zi[k], eps2, ax[k], ay[k], az[k]);
      }
      __syncthreads();
    }
    nfar = nnear = near_total = 0;
  };

  // 2-3. level-synchronous traversal from the root's children
  if (t == 0) fr_cur[0] = 0;
  __syncthreads();
  int cur = 1;
  for (int d = 0; d < ld; ++d) {
    const bool terminal = d + 1 >= ld;
    const float bsq_next = bsq[d + 1];
    const int child_off = level_offset(d + 1);
    const int pairs = 8 * cur;
    int next = 0;
    for (int base = 0; base < pairs; base += T) {
      if (nfar > kFarCap - T || nnear > kNearCap - T) flush();
      const int p = base + t;
      int code = 0;  // 1 far, 2 near, 3 open
      int child = 0, count = 0, first = 0;
      Src com{};
      if (p < pairs) {
        child = fr_cur[p >> 3] * 8 + (p & 7);
        const int c = child_off + child;
        count = ccnt[c];
        if (count > 0) {
          com = Src{cx[c], cy[c], cz[c], cgm[c]};
          // the MAC in f32, on the f32-rounded centre of mass in df mode
          const float mx = (float)com.x, my = (float)com.y, mz = (float)com.z;
          const float ddx = __fsub_rn(mx, fminf(fmaxf(mx, lox), hix));
          const float ddy = __fsub_rn(my, fminf(fmaxf(my, loy), hiy));
          const float ddz = __fsub_rn(mz, fminf(fmaxf(mz, loz), hiz));
          const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(ddx, ddx), __fmul_rn(ddy, ddy)),
                                     __fmul_rn(ddz, ddz));
          if (__fmul_rn(theta_sq, d2) > bsq_next) {
            code = 1;
          } else if (count <= leaf_cap || terminal) {
            code = 2;
            first = cstart[c];
          } else {
            code = 3;
          }
        }
      }
      const unsigned long long flag = code == 1 ? 1ull
                                      : code == 2 ? (1ull << 16)
                                      : code == 3 ? (1ull << 32)
                                                  : 0ull;
      unsigned long long ex_f, tot_f;
      int ex_c, tot_c;
      block_scan(flag, code == 2 ? count : 0, scan_f, scan_c, ex_f, ex_c, tot_f, tot_c);
      if (code == 1) {
        far_buf[nfar + (int)(ex_f & 0xFFFF)] = com;
      } else if (code == 2) {
        const int k = nnear + (int)((ex_f >> 16) & 0xFFFF);
        near_start[k] = first;
        near_off[k] = near_total + ex_c;
      } else if (code == 3) {
        const int k = next + (int)(ex_f >> 32);
        if (k < fcap) fr_next[k] = child;
      }
      const int n_far = (int)(tot_f & 0xFFFF);
      nfar += n_far;
      far_children += n_far;
      nnear += (int)((tot_f >> 16) & 0xFFFF);
      near_total += tot_c;
      near_bodies += tot_c;
      next += (int)(tot_f >> 32);
      __syncthreads();  // staged entries and the next frontier are visible
    }
    pops += cur;
    if (next >= fcap) overflow = max(overflow, next);
    cur = min(next, fcap);
    int* swap = fr_cur;
    fr_cur = fr_next;
    fr_next = swap;
  }
  flush();

#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    if (live[k]) {
      R* o = out + 3 * (size_t)(gs + t + k * T);
      o[0] = ax[k];
      o[1] = ay[k];
      o[2] = az[k];
    }
  }
  if (t == 0) {
    st[kStatPops] = pops;
    st[kStatSources] = far_children + near_bodies;
    st[kStatNear] = near_bodies;
    st[kStatOverflow] = overflow;
    st[kStatFar] = far_children;
  }
}

template <class R>
int launch_bh_fused(const R* cx, const R* cy, const R* cz, const R* gm, const int* cnt,
                    const int* start, const int* gstart, const int* gcount, int n_groups,
                    const R* src, const float* bsq, float theta_sq, R eps2, int leaf_cap,
                    int ld, int fcap, int group_size, R* out, int* stats, void* stream) {
  if (ld < 1 || ld > kMaxLd || group_size < 1 || group_size > kMaxThreads || fcap < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_groups <= 0) return static_cast<int>(cudaSuccess);
  const int threads = block_threads<R>(group_size);
  const size_t smem = smem_bytes<R>(threads, fcap);
  cudaError_t err = cudaFuncSetAttribute(
      bh_fused_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  bh_fused_kernel<R><<<n_groups, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      cx, cy, cz, gm, cnt, start, gstart, gcount,
      reinterpret_cast<const typename Eval<R>::Src*>(src), bsq, theta_sq, eps2, leaf_cap, ld,
      fcap, out, stats);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared memory one block needs for `group_size` bodies and a frontier of
// `fcap` cells per level: of the f32 mode, or of the df mode if `f64`.
int nbody_bh_fused_smem_bytes(int group_size, int fcap, int f64) {
  return static_cast<int>(f64 ? smem_bytes<double>(block_threads<double>(group_size), fcap)
                              : smem_bytes<float>(block_threads<float>(group_size), fcap));
}

// Launch on `stream`, one block per group slot.  Tables cx, cy, cz, gm (f32)
// and cnt, start (i32) hold the dense levels 0..ld (ops/bh_grid.py);
// gstart, gcount (i32, n_groups) the groups' sorted ranges, at most
// group_size <= 1024 bodies each; src (n, 4) f32 [x y z G·m], 16-byte
// aligned; bsq (>= ld + 1) f32 with bsq[l] = (border / 2^l)^2; out (n, 3)
// f32, written for every body of a group (zero it for trimmed groups);
// stats (n_groups, 5) i32.  Returns the cudaError_t of the launch.
int nbody_bh_fused_f32(const float* cx, const float* cy, const float* cz, const float* gm,
                       const int* cnt, const int* start, const int* gstart,
                       const int* gcount, int n_groups, const float* src, const float* bsq,
                       float theta_sq, float eps2, int leaf_cap, int ld, int fcap,
                       int group_size, float* out, int* stats, void* stream) {
  return launch_bh_fused<float>(cx, cy, cz, gm, cnt, start, gstart, gcount, n_groups, src,
                                bsq, theta_sq, eps2, leaf_cap, ld, fcap, group_size, out,
                                stats, stream);
}

// The df mode: as nbody_bh_fused_f32, with the tables cx, cy, cz, gm, the
// sources src (n, 4), eps2 and out in fp64; bsq and theta_sq stay f32 (the
// MAC is f32).
int nbody_bh_fused_f64(const double* cx, const double* cy, const double* cz,
                       const double* gm, const int* cnt, const int* start,
                       const int* gstart, const int* gcount, int n_groups, const double* src,
                       const float* bsq, float theta_sq, double eps2, int leaf_cap, int ld,
                       int fcap, int group_size, double* out, int* stats, void* stream) {
  return launch_bh_fused<double>(cx, cy, cz, gm, cnt, start, gstart, gcount, n_groups, src,
                                 bsq, theta_sq, eps2, leaf_cap, ld, fcap, group_size, out,
                                 stats, stream);
}

}  // extern "C"
