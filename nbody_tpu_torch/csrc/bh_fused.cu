// bh_fused.cu — fused Barnes-Hut traverse + evaluate, f32, for sm_90a.
//
// Replaces the TPU kernel nbody_tpu/ops/bh_fused.py::_fused_kernel (f32
// mode).  One thread block handles one Morton group: the bodies
// [gstart, gstart + gcount) of the sorted source array, at most blockDim.
// For each group it
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
// What bounds it on the card: the evaluation, ~20 FP32 operations and one
// rsqrt per (body, source) pair, the same as K1.  At 1M uniform bodies a
// group sees ~10^4 sources, against a few hundred frontier cells, so the
// traversal is a small share.  Design for that: one thread per body, its
// accumulators in registers; staged sources sit in shared memory (far
// sources as float4, near runs as (start, offset) pairs that stream through
// a float4 tile as in K1).  The staging buffers are evaluated and emptied
// whenever a classification round could overflow them.
//
// Left for later: one 1024-thread block per SM leaves the SM idle at every
// block-wide barrier of the traversal; several groups per block or warp-
// level traversal would hide that.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kFarCap = 2048;   // staged far sources
constexpr int kNearCap = 2048;  // staged near cells
constexpr int kMaxLd = 8;
// stats lanes, as ops/bh_fused.py
constexpr int kStatPops = 0, kStatSources = 1, kStatNear = 2, kStatOverflow = 3,
              kStatFar = 4, kNumStats = 5;

__host__ __device__ inline int level_offset(int d) { return ((1 << (3 * d)) - 1) / 7; }

__host__ inline int block_threads(int group_size) {
  int t = 32;
  while (t < group_size) t <<= 1;
  return t;
}

__host__ inline size_t smem_bytes(int threads, int fcap) {
  return sizeof(float4) * (kFarCap + threads)             // far sources, near tile
         + sizeof(int) * 2 * kNearCap                     // near starts, offsets
         + sizeof(unsigned long long) * (threads + 32)    // scan: flags
         + sizeof(int) * (threads + 32)                   // scan: near counts
         + sizeof(int) * 2 * fcap;                        // frontier, two levels
}

__device__ __forceinline__ void accumulate(const float4 s, float xi, float yi, float zi,
                                           float eps2, float& ax, float& ay, float& az) {
  const float dx = s.x - xi;
  const float dy = s.y - yi;
  const float dz = s.z - zi;
  const float r2 = dx * dx + dy * dy + dz * dz + eps2;
  const float inv_r = rsqrtf(r2);
  const float w = s.w * (inv_r * inv_r * inv_r);
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

__global__ void __launch_bounds__(kMaxThreads)
bh_fused_kernel(const float* __restrict__ cx, const float* __restrict__ cy,
                const float* __restrict__ cz, const float* __restrict__ cgm,
                const int* __restrict__ ccnt, const int* __restrict__ cstart,
                const int* __restrict__ gstart, const int* __restrict__ gcount,
                const float4* __restrict__ src, const float* __restrict__ bsq,
                float theta_sq, float eps2, int leaf_cap, int ld, int fcap,
                float* __restrict__ out, int* __restrict__ stats) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int T = blockDim.x;
  float4* far_buf = reinterpret_cast<float4*>(smem);
  float4* tile = far_buf + kFarCap;
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
  const bool live = t < gc;
  float xi = 0.f, yi = 0.f, zi = 0.f;
  if (live) {
    const float4 p = src[gs + t];
    xi = p.x;
    yi = p.y;
    zi = p.z;
  }

  // 1. bounding box of the live bodies (tree min/max, exact)
  float* red = reinterpret_cast<float*>(far_buf);  // 6 x T floats, free until staging
  const float inf = __int_as_float(0x7f800000);
  red[0 * T + t] = live ? xi : inf;
  red[1 * T + t] = live ? yi : inf;
  red[2 * T + t] = live ? zi : inf;
  red[3 * T + t] = live ? xi : -inf;
  red[4 * T + t] = live ? yi : -inf;
  red[5 * T + t] = live ? zi : -inf;
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

  float ax = 0.f, ay = 0.f, az = 0.f;
  int nfar = 0, nnear = 0, near_total = 0;  // staged now (block-uniform)
  int pops = 0, far_children = 0, near_bodies = 0, overflow = 0;

  // evaluate every staged source and empty the buffers (block-uniform call)
  auto flush = [&]() {
    for (int k = 0; k < nfar; ++k) accumulate(far_buf[k], xi, yi, zi, eps2, ax, ay, az);
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
      for (int k = 0; k < m; ++k) accumulate(tile[k], xi, yi, zi, eps2, ax, ay, az);
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
      float4 com = make_float4(0.f, 0.f, 0.f, 0.f);
      if (p < pairs) {
        child = fr_cur[p >> 3] * 8 + (p & 7);
        const int c = child_off + child;
        count = ccnt[c];
        if (count > 0) {
          com = make_float4(cx[c], cy[c], cz[c], cgm[c]);
          const float ddx = __fsub_rn(com.x, fminf(fmaxf(com.x, lox), hix));
          const float ddy = __fsub_rn(com.y, fminf(fmaxf(com.y, loy), hiy));
          const float ddz = __fsub_rn(com.z, fminf(fmaxf(com.z, loz), hiz));
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

  if (live) {
    float* o = out + 3 * (size_t)(gs + t);
    o[0] = ax;
    o[1] = ay;
    o[2] = az;
  }
  if (t == 0) {
    st[kStatPops] = pops;
    st[kStatSources] = far_children + near_bodies;
    st[kStatNear] = near_bodies;
    st[kStatOverflow] = overflow;
    st[kStatFar] = far_children;
  }
}

}  // namespace

extern "C" {

// Shared memory one block needs for `group_size` bodies and a frontier of
// `fcap` cells per level.
int nbody_bh_fused_smem_bytes(int group_size, int fcap) {
  return static_cast<int>(smem_bytes(block_threads(group_size), fcap));
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
  if (ld < 1 || ld > kMaxLd || group_size < 1 || group_size > kMaxThreads || fcap < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_groups <= 0) return static_cast<int>(cudaSuccess);
  const int threads = block_threads(group_size);
  const size_t smem = smem_bytes(threads, fcap);
  cudaError_t err = cudaFuncSetAttribute(
      bh_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  bh_fused_kernel<<<n_groups, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      cx, cy, cz, gm, cnt, start, gstart, gcount, reinterpret_cast<const float4*>(src), bsq,
      theta_sq, eps2, leaf_cap, ld, fcap, out, stats);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
