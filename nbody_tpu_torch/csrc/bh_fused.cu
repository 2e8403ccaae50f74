// bh_fused.cu — fused Barnes-Hut traverse + evaluate, f32 and fp64 (df)
// modes, for sm_90a.
//
// Replaces the TPU kernel nbody_tpu/ops/bh_fused.py::_fused_kernel, in its
// f32 mode and its df mode (df=True, used by nbody_tpu/ops/bh_fused_df.py),
// with its debug_mode stage cuts.  A thread block handles one Morton group
// (f32), or one piece of one (df): the bodies [gstart, gstart + gcount) of
// the sorted source array.  For each group it
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
// Two kernel bodies, one contract:
//   * bh_fused_warp_kernel, the f32 mode: a block per group (below);
//   * bh_fused_df_kernel, the df mode: a 256-thread block per piece of a
//     group, one body a thread (further below).
// In df mode tables, sources, eps2 and accumulators are fp64, but the MAC
// stays in f32, as the TPU kernel's df mode classifies on the f32 hi
// halves: the box is taken over (float) of the body coordinates, each
// child's centre of mass enters as (float) of the fp64 table, and bsq and
// theta^2 are f32.  So both modes open and accept the same cells on the
// same tables, and only the force arithmetic changes precision.  On the
// TPU that arithmetic is double-float (f32 hi + lo pairs); Hopper has fp64
// units, so here it is native fp64.
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
// in (frontier, child) order by prefix scans, not appended with atomics,
// and there are no float atomics: the same input gives the same
// accelerations on every run.
//
// Stage cuts (the TPU kernel's debug_mode, nbody_tpu/ops/bh_fused.py:
// 201-214): a compile-time parameter kCut of both bodies.  "none" writes
// zero stats and returns; "pops" traverses and classifies; "stage" also
// writes the far and near staging entries ("stagefar" / "stagenear" only
// one of the two); "dma" also loads the near rows into shared memory;
// "full" also evaluates (production).  Every cut but "none" counts the
// same stats lanes as "full": classification does not depend on the cut.
// In "dma" the loaded rows have no consumer; the loads stay in the code
// because the warp kernel's bulk copies are asm volatile and the df
// kernel's tile stores go to shared memory, and each tile's first word is
// also folded into a flag that writes the body's output only if it is a
// NaN (never, for finite inputs), so no compiler pass can drop them.
//
// What bounds it on the card: the evaluation, one pair per (body, source).
// In f32 mode that is K1's pair term and K1's instruction budget: 12 fp32
// instructions and one MUFU.RSQ a pair, 13.8 instructions issued a pair in
// the hot loop (one LDS.128 row serves a thread's two bodies), so the
// card's instruction issue; in df mode allpairs_f64.cu's pair term
// (pair_f64.cuh), at half the fp32 issue rate.  The stage cuts show it
// (H100 80GB HBM3, 700 W, 1M bodies): traversal, staging and near-row loads
// together take 0.13 ms of the uniform cloud's 5.30 ms in f32 and under
// 1 ms of the robust input's ~56 ms; the rest is pairs.  And where
// the groups' work is uneven the card waits on the heaviest: one block per
// group, so a dense core group (316,649 sources x 1,024 bodies on the
// robust input, 28 ms alone on an SM) started last sets the time.  So the
// caller prices the groups with the "pops" cut and launches them heaviest
// first (`order`, ops/bh_fused.py::heavy_first), which took the robust
// input from 56 to ~35 ms whatever the kernel body.
//
// The warp design (f32):
//   * two bodies a thread (bodies 2t and 2t + 1 of the group): a
//     1,024-body group is a 512-thread block, __launch_bounds__(512, 2)
//     caps registers at 64, and ~84 KB of shared memory lets two blocks
//     share an SM, so one block's barriers hide behind the other's
//     evaluation; each staged row read from shared memory serves two
//     bodies.  A warp whose 64 bodies are all past the group's count skips
//     the evaluation loops (it still meets every barrier), so a small
//     group costs its live warps only;
//   * warp-level compaction: far, near and open flags by __ballot_sync and
//     __popc, the near counts by a __shfl_up_sync scan, one shared exchange
//     of the warp totals (double-buffered by round) — one barrier per
//     classification round where the block scan took three;
//   * near rows by TMA 1-D bulk copies (cp.async.bulk, completing on an
//     mbarrier) into a two-stage ring of kStage rows: each staged run is a
//     contiguous slice of the sorted sources with a known place in the
//     ring, so one thread issues one copy per run piece (a run longer than
//     a stage is split across stages) and no thread searches for its row;
//     the next stage's copies are in flight while the block evaluates the
//     current one, and a stage takes one barrier.  The bulk copy was
//     chosen over cp.async 16 bytes a row because it needs no per-row
//     instructions and no barrier to publish the rows; cp.async was not
//     measured.
// The earlier df body (a block of two bodies a thread per group, block-wide
// scans) run in f32, one body a thread, with the same pair loop and launch
// order, was ~5 % slower on the 1M uniform cloud and ~5 % faster on the
// robust input, where a 1,024-thread block gives a dense-core group the
// whole SM (PERF.md).
//
// The df design: one block of 256 threads per piece, one body a
// thread; a piece is a run of whole warps of one group, at most 256 bodies
// (ops/bh_fused.py::df_pieces), so a 1,024-body group is four blocks that
// the card runs on up to four SMs:
//   * every piece takes the whole group's box (it reads all the group's
//     bodies) and traversal, and stages and evaluates for its own bodies.
//     The classification round (256 children) and the flush thresholds do
//     not depend on the piece, so each body sums the same sources in the
//     same order however its group is cut and the pieces ordered: slot
//     order, heaviest first and one-warp pieces give the same bits;
//   * __launch_bounds__(256, 4) caps registers at 64 (one fp64 body, 64
//     with no spills) and the buffers are sized for four blocks an SM: 512
//     staged far sources, 1,024 near cells, a 256-row near tile (50,432
//     bytes at a 2048-cell frontier), so 32 warps an SM, and one block's
//     barriers hide behind three others' evaluation;
//   * warp-level compaction as the warp design's, one barrier a round;
//   * near rows gathered synchronously, a tile of 256 rows at a time (each
//     thread binary-searches its row's run): the dma cut puts the gather at
//     2.5 % of full on the uniform cloud and 2.6 % on the robust input (H100
//     80GB HBM3, 700 W, PERF.md), so the warp design's TMA ring was
//     not carried over;
//   * the caller prices the groups with the pops cut (one piece a group)
//     and launches the pieces heaviest first.
//
// Registers (ptxas, nvcc 12.9): chip_smoke.py phase 1 prints them for every
// instantiation.  Shared memory per block at a 2048-cell frontier: the warp
// kernel 83,732 bytes at any group size; the df kernel 50,432 bytes.

#include <cuda_runtime.h>

#include "pair_f64.cuh"
#include "rsqrt.cuh"

namespace {

constexpr int kMaxBodies = 1024;   // bodies per group, at most
constexpr int kFarCap = 2048;      // staged far sources
constexpr int kNearCap = 2048;     // staged near cells
constexpr int kMaxLd = 8;
// stats lanes, as ops/bh_fused.py
constexpr int kStatPops = 0, kStatSources = 1, kStatNear = 2, kStatOverflow = 3,
              kStatFar = 4, kNumStats = 5;
// stage cuts, as ops/bh_fused.py CUTS
constexpr int kCutNone = 0, kCutPops = 1, kCutStage = 2, kCutStageFar = 3,
              kCutStageNear = 4, kCutDma = 5, kCutFull = 6;

template <int kCut>
struct Cut {
  static constexpr bool far = kCut != kCutPops && kCut != kCutStageNear && kCut != kCutNone;
  static constexpr bool near = kCut != kCutPops && kCut != kCutStageFar && kCut != kCutNone;
  static constexpr bool load = kCut == kCutDma || kCut == kCutFull;
  static constexpr bool eval = kCut == kCutFull;
};

struct alignas(16) Src64 {
  double x, y, z, w;
};

__host__ __device__ inline int level_offset(int d) { return ((1 << (3 * d)) - 1) / 7; }

// The group MAC in f32, each operation rounded on its own: 1 far, 2 near,
// 3 open.  (mx, my, mz) is the child's centre of mass, rounded to f32.
__device__ __forceinline__ int classify(float mx, float my, float mz, float lox, float loy,
                                        float loz, float hix, float hiy, float hiz,
                                        float theta_sq, float bsq_next, int count,
                                        int leaf_cap, bool terminal) {
  const float ddx = __fsub_rn(mx, fminf(fmaxf(mx, lox), hix));
  const float ddy = __fsub_rn(my, fminf(fmaxf(my, loy), hiy));
  const float ddz = __fsub_rn(mz, fminf(fmaxf(mz, loz), hiz));
  const float d2 =
      __fadd_rn(__fadd_rn(__fmul_rn(ddx, ddx), __fmul_rn(ddy, ddy)), __fmul_rn(ddz, ddz));
  if (__fmul_rn(theta_sq, d2) > bsq_next) return 1;
  return count <= leaf_cap || terminal ? 2 : 3;
}

// ---------------------------------------------------------------------------
// The warp design (f32): two bodies a thread, warp-level compaction, near
// rows through a two-stage ring of TMA bulk copies.

constexpr int kWarpThreads = kMaxBodies / 2;  // two bodies a thread
constexpr int kStage = 512;                    // near rows per ring stage
constexpr int kFlagBits = 10;                  // per-warp packed counters (<= 512 each)

// Threads of a warp-design block for `group_size` bodies: whole warps, two
// bodies a thread.
__host__ inline int warp_threads(int group_size) {
  return 32 * ((group_size + 63) / 64);
}

__host__ inline size_t warp_smem_bytes(int fcap) {
  return sizeof(float4) * (kFarCap + 2 * kStage)   // far sources, near ring
         + sizeof(unsigned long long) * 2          // ring mbarriers
         + sizeof(int) * 2 * 2 * 32                // warp totals, two rounds
         + sizeof(float) * 6 * 32                  // box: warp partials
         + sizeof(int) * (2 * kNearCap + 1)        // near starts, offsets + end
         + sizeof(int) * 2 * fcap;                 // frontier, two levels
}

// The CPU emulation of the kernel sources brings its own twins of these
// helpers (synchronous copies, a block barrier for the wait) and defines
// NBODY_EMULATED_ASYNC_COPY.
#ifndef NBODY_EMULATED_ASYNC_COPY
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Called by one thread before the block's barrier: each ring stage's
// mbarrier expects one arrival (its expect_tx) a phase.
__device__ __forceinline__ void ring_init(unsigned long long* bar) {
  for (int s = 0; s < 2; ++s)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar + s)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// One thread: the stage's phase completes once `bytes` have landed.
__device__ __forceinline__ void ring_expect(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Copy `rows` 16-byte rows from global `src` to shared `dst` (TMA 1-D bulk
// copy), completing on the stage's mbarrier.
__device__ __forceinline__ void ring_copy(float4* dst, const float4* src, int rows,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst)), "l"(src), "r"(static_cast<unsigned>(rows) * 16u),
      "r"(smem_addr(bar)) : "memory");
}

// Every thread of the block: wait until the stage's phase `parity` has
// completed; its rows are then visible to the thread.
__device__ __forceinline__ void ring_wait(unsigned long long* bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}
#endif

// K1's pair term in f32, |d|^2 + eps2 as a chain of three FMAs: one
// instruction a pair fewer than the plain sum (measured on the card: ~7 %
// off the robust input's time).  The rsqrt is rsqrt.cuh's rsqrt_ftz,
// MUFU.RSQ alone: 12 fp32 instructions a pair, K1's count.  CUDA's rsqrtf
// would wrap it in a scaling for subnormal inputs (an FSETP and two
// predicated FMULs), which never acts here: r2 >= eps2, so r2 is normal
// whenever eps2 is, and both give the same bits; for eps2 below the normal
// range a body's own entry (d = 0) makes its sum NaN with either.  The
// weight keeps this order, gm (r^-1 r^-1 r^-1), not pair_f32.cuh's
// (gm r^-1)(r^-1 r^-1), which rounds otherwise.
__device__ __forceinline__ void accumulate_fma(const float4 s, float xi, float yi, float zi,
                                               float eps2, float& ax, float& ay, float& az) {
  const float dx = s.x - xi;
  const float dy = s.y - yi;
  const float dz = s.z - zi;
  const float r2 = fmaf(dx, dx, fmaf(dy, dy, fmaf(dz, dz, eps2)));
  const float inv_r = rsqrt_ftz(r2);
  const float w = s.w * (inv_r * inv_r * inv_r);
  ax = fmaf(w, dx, ax);
  ay = fmaf(w, dy, ay);
  az = fmaf(w, dz, az);
}

// Inclusive sum of `v` over the warp's lanes 0..lane.
__device__ __forceinline__ int warp_inclusive(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

template <int kCut>
__global__ void __launch_bounds__(kWarpThreads, 2)
bh_fused_warp_kernel(const float* __restrict__ cx, const float* __restrict__ cy,
                     const float* __restrict__ cz, const float* __restrict__ cgm,
                     const int* __restrict__ ccnt, const int* __restrict__ cstart,
                     const int* __restrict__ gstart, const int* __restrict__ gcount,
                     const int* __restrict__ order,
                     const float4* __restrict__ src, const float* __restrict__ bsq,
                     float theta_sq, float eps2, int leaf_cap, int ld, int fcap,
                     float* __restrict__ out, int* __restrict__ stats) {
  using C = Cut<kCut>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int T = blockDim.x;
  const int nw = T >> 5;
  float4* far_buf = reinterpret_cast<float4*>(smem);
  float4* ring = far_buf + kFarCap;
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(ring + 2 * kStage);
  int* wtot = reinterpret_cast<int*>(bars + 2);  // [round & 1][flags | counts][warp]
  float* red = reinterpret_cast<float*>(wtot + 2 * 2 * 32);
  int* near_start = reinterpret_cast<int*>(red + 6 * 32);
  int* near_off = near_start + kNearCap;  // kNearCap + 1: the end sentinel
  int* fr_cur = near_off + kNearCap + 1;
  int* fr_next = fr_cur + fcap;

  const int g = order ? order[blockIdx.x] : blockIdx.x;  // the group slot
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int w = t >> 5;
  const int gc = gcount[g];
  int* st = stats + (size_t)g * kNumStats;
  if (kCut == kCutNone || gc == 0) {
    if (t < kNumStats) st[t] = 0;
    return;
  }
  const int gs = gstart[g];
  // this thread's bodies: 2t and 2t + 1 of the group; a warp holds 64
  const bool warp_live = 64 * w < gc;  // warp-uniform
  bool live[2];
  float xi[2], yi[2], zi[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    live[k] = 2 * t + k < gc;
    xi[k] = yi[k] = zi[k] = 0.f;
    if (live[k]) {
      const float4 p = src[gs + 2 * t + k];
      xi[k] = p.x;
      yi[k] = p.y;
      zi[k] = p.z;
    }
  }

  // 1. bounding box of the live bodies (min/max, exact): warp shuffles,
  // then each warp reduces the warp partials
  const float inf = __int_as_float(0x7f800000);
  float bx[6] = {inf, inf, inf, -inf, -inf, -inf};
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    if (live[k]) {
      bx[0] = fminf(bx[0], xi[k]);
      bx[1] = fminf(bx[1], yi[k]);
      bx[2] = fminf(bx[2], zi[k]);
      bx[3] = fmaxf(bx[3], xi[k]);
      bx[4] = fmaxf(bx[4], yi[k]);
      bx[5] = fmaxf(bx[5], zi[k]);
    }
  }
#pragma unroll
  for (int a = 0; a < 6; ++a) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float u = __shfl_xor_sync(0xffffffffu, bx[a], o);
      bx[a] = a < 3 ? fminf(bx[a], u) : fmaxf(bx[a], u);
    }
    if (lane == 0) red[a * 32 + w] = bx[a];
  }
  if (C::load && t == 0) ring_init(bars);
  if (t == 0) fr_cur[0] = 0;
  __syncthreads();
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    bx[a] = lane < nw ? red[a * 32 + lane] : (a < 3 ? inf : -inf);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float u = __shfl_xor_sync(0xffffffffu, bx[a], o);
      bx[a] = a < 3 ? fminf(bx[a], u) : fmaxf(bx[a], u);
    }
  }
  const float lox = bx[0], loy = bx[1], loz = bx[2];
  const float hix = bx[3], hiy = bx[4], hiz = bx[5];

  float ax[2] = {0.f, 0.f}, ay[2] = {0.f, 0.f}, az[2] = {0.f, 0.f};
  int nfar = 0, nnear = 0, near_total = 0;  // staged now (block-uniform)
  int pops = 0, far_children = 0, near_bodies = 0, overflow = 0;
  unsigned phase = 0;  // bit s: the parity ring stage s waits for next
  bool nan_seen = false;  // the "dma" cut's fold of the loaded rows

  // Copies of the near rows [b0, b1) of the staged list into ring stage s:
  // one bulk copy per piece of a run, spread over the threads.
  auto issue = [&](int b0, int b1, int s) {
    int lo = 0, hi = nnear - 1;  // the run holding row b0
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (near_off[mid] <= b0) lo = mid; else hi = mid - 1;
    }
    if (t == 0) ring_expect(bars + s, static_cast<unsigned>(b1 - b0) * 16u);
    for (int k = lo + t; k < nnear && near_off[k] < b1; k += T) {
      const int r0 = max(near_off[k], b0), r1 = min(near_off[k + 1], b1);
      ring_copy(ring + s * kStage + (r0 - b0), src + near_start[k] + (r0 - near_off[k]),
                r1 - r0, bars + s);
    }
  };

  // evaluate every staged source and empty the buffers (block-uniform call)
  auto flush = [&]() {
    if (C::load && t == 0) near_off[nnear] = near_total;
    __syncthreads();  // staged entries are visible
    if (C::eval && warp_live) {
#pragma unroll 8
      for (int q = 0; q < nfar; ++q) {
        const float4 s = far_buf[q];
        accumulate_fma(s, xi[0], yi[0], zi[0], eps2, ax[0], ay[0], az[0]);
        accumulate_fma(s, xi[1], yi[1], zi[1], eps2, ax[1], ay[1], az[1]);
      }
    }
    if (C::load) {
      const int tiles = (near_total + kStage - 1) / kStage;
      if (tiles > 0) issue(0, min(kStage, near_total), 0);
      for (int i = 0; i < tiles; ++i) {
        const int s = i & 1;
        if (i + 1 < tiles)
          issue((i + 1) * kStage, min((i + 2) * kStage, near_total), s ^ 1);
        ring_wait(bars + s, (phase >> s) & 1u);
        phase ^= 1u << s;
        const float4* buf = ring + s * kStage;
        if (C::eval) {
          if (warp_live) {
            const int m = min(kStage, near_total - i * kStage);
#pragma unroll 8
            for (int q = 0; q < m; ++q) {
              const float4 r = buf[q];
              accumulate_fma(r, xi[0], yi[0], zi[0], eps2, ax[0], ay[0], az[0]);
              accumulate_fma(r, xi[1], yi[1], zi[1], eps2, ax[1], ay[1], az[1]);
            }
          }
        } else {
          nan_seen |= buf[0].x != buf[0].x;
        }
        __syncthreads();  // the stage is free for the copies after next
      }
    }
    __syncthreads();  // the far buffer and the runs are free
    nfar = nnear = near_total = 0;
  };

  // 2-3. level-synchronous traversal from the root's children
  const unsigned lt = (1u << lane) - 1u;  // lanes below this one
  int round = 0;
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
          code = classify(com.x, com.y, com.z, lox, loy, loz, hix, hiy, hiz, theta_sq,
                          bsq_next, count, leaf_cap, terminal);
          if (code == 2) first = cstart[c];
        }
      }
      // compaction in (frontier, child) order: ranks within the warp by
      // ballot, near counts by a shuffle scan, warps by one exchange
      const unsigned far_m = __ballot_sync(0xffffffffu, code == 1);
      const unsigned near_m = __ballot_sync(0xffffffffu, code == 2);
      const unsigned open_m = __ballot_sync(0xffffffffu, code == 3);
      const int c_near = code == 2 ? count : 0;
      const int inc = warp_inclusive(c_near, lane);
      int* wt = wtot + (round & 1) * 64;
      if (lane == 31) {
        wt[w] = __popc(far_m) | (__popc(near_m) << kFlagBits) |
                (__popc(open_m) << (2 * kFlagBits));
        wt[32 + w] = inc;
      }
      __syncthreads();  // the warp totals; the last round's entries
      const int vf = lane < nw ? wt[lane] : 0;
      const int vc = lane < nw ? wt[32 + lane] : 0;
      const int incf = warp_inclusive(vf, lane), incc = warp_inclusive(vc, lane);
      const int exf = __shfl_sync(0xffffffffu, incf - vf, w);
      const int exc = __shfl_sync(0xffffffffu, incc - vc, w);
      const int totf = __shfl_sync(0xffffffffu, incf, nw - 1);
      const int totc = __shfl_sync(0xffffffffu, incc, nw - 1);
      constexpr int kMask = (1 << kFlagBits) - 1;
      if (code == 1) {
        if (C::far) far_buf[nfar + (exf & kMask) + __popc(far_m & lt)] = com;
      } else if (code == 2) {
        if (C::near) {
          const int k = nnear + ((exf >> kFlagBits) & kMask) + __popc(near_m & lt);
          near_start[k] = first;
          near_off[k] = near_total + exc + inc - c_near;
        }
      } else if (code == 3) {
        const int k = next + (exf >> (2 * kFlagBits)) + __popc(open_m & lt);
        if (k < fcap) fr_next[k] = child;
      }
      const int n_far = totf & kMask;
      nfar += n_far;
      far_children += n_far;
      nnear += (totf >> kFlagBits) & kMask;
      near_total += totc;
      near_bodies += totc;
      next += totf >> (2 * kFlagBits);
      ++round;
    }
    pops += cur;
    if (next >= fcap) overflow = max(overflow, next);
    cur = min(next, fcap);
    int* swap = fr_cur;
    fr_cur = fr_next;
    fr_next = swap;
    __syncthreads();  // the next frontier is visible
  }
  flush();

#pragma unroll
  for (int k = 0; k < 2; ++k) {
    if (live[k] && (C::eval || nan_seen)) {
      float* o = out + 3 * (size_t)(gs + 2 * t + k);
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

// ---------------------------------------------------------------------------
// The df mode: one block of kDfThreads threads per piece of a group, one
// body a thread, warp-level compaction, near rows gathered synchronously.

constexpr int kDfThreads = 256;     // threads of a df block: one body each
constexpr int kDfWarps = kDfThreads / 32;
constexpr int kDfFarCap = 512;      // staged far sources
constexpr int kDfNearCap = 1024;    // staged near cells
constexpr int kDfRound = kDfThreads;  // children classified a round

__host__ inline size_t df_smem_bytes(int fcap) {
  return sizeof(Src64) * (kDfFarCap + kDfThreads)  // far sources, near tile
         + sizeof(int) * 2 * 2 * 32                // warp totals, two rounds
         + sizeof(float) * 6 * 32                  // box: warp partials
         + sizeof(int) * 2 * kDfNearCap            // near starts, offsets
         + sizeof(int) * 2 * fcap;                 // frontier, two levels
}

// A piece is [slot, first body, end body) of one group: pieces[3 b + 0..2]
// for block b.  Every piece takes the whole group's box and traversal, and
// stages and evaluates for its own bodies only; a piece with end <= first
// is a spare block and exits.  Only the piece that starts at body 0 writes
// the group's stats row (the caller zeroes the rows: "none" and empty
// groups write nothing).
template <int kCut>
__global__ void __launch_bounds__(kDfThreads, 4)
bh_fused_df_kernel(const double* __restrict__ cx, const double* __restrict__ cy,
                   const double* __restrict__ cz, const double* __restrict__ cgm,
                   const int* __restrict__ ccnt, const int* __restrict__ cstart,
                   const int* __restrict__ gstart, const int* __restrict__ gcount,
                   const int* __restrict__ pieces, const Src64* __restrict__ src,
                   const float* __restrict__ bsq, float theta_sq, double eps2, int leaf_cap,
                   int ld, int fcap, double* __restrict__ out, int* __restrict__ stats) {
  using C = Cut<kCut>;
  extern __shared__ __align__(16) unsigned char smem[];
  Src64* far_buf = reinterpret_cast<Src64*>(smem);
  Src64* tile = far_buf + kDfFarCap;
  int* wtot = reinterpret_cast<int*>(tile + kDfThreads);  // [round & 1][flags | counts][warp]
  float* red = reinterpret_cast<float*>(wtot + 2 * 2 * 32);
  int* near_start = reinterpret_cast<int*>(red + 6 * 32);
  int* near_off = near_start + kDfNearCap;
  int* fr_cur = near_off + kDfNearCap;
  int* fr_next = fr_cur + fcap;

  const int* piece = pieces + 3 * (size_t)blockIdx.x;
  const int g = piece[0], b0 = piece[1], b1 = piece[2];
  if (kCut == kCutNone || b1 <= b0) return;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int w = t >> 5;
  const int gc = gcount[g];
  const int gs = gstart[g];
  // this thread's body: b0 + t of the group; a warp holds 32
  const bool live = b0 + t < b1;
  const bool warp_live = b0 + 32 * w < b1;  // warp-uniform
  double xi = 0.0, yi = 0.0, zi = 0.0;
  if (live) {
    const Src64 p = src[gs + b0 + t];
    xi = p.x;
    yi = p.y;
    zi = p.z;
  }

  // 1. bounding box of all the group's bodies (min/max, exact), in f32 over
  // the f32-rounded coordinates: warp shuffles, then each warp reduces the
  // warp partials.  Every piece of the group gets the same box.
  const float inf = __int_as_float(0x7f800000);
  float bx[6] = {inf, inf, inf, -inf, -inf, -inf};
  for (int k = t; k < gc; k += kDfThreads) {
    const float p[3] = {(float)src[gs + k].x, (float)src[gs + k].y, (float)src[gs + k].z};
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      bx[a] = fminf(bx[a], p[a]);
      bx[a + 3] = fmaxf(bx[a + 3], p[a]);
    }
  }
#pragma unroll
  for (int a = 0; a < 6; ++a) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float u = __shfl_xor_sync(0xffffffffu, bx[a], o);
      bx[a] = a < 3 ? fminf(bx[a], u) : fmaxf(bx[a], u);
    }
    if (lane == 0) red[a * 32 + w] = bx[a];
  }
  if (t == 0) fr_cur[0] = 0;
  __syncthreads();
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    bx[a] = lane < kDfWarps ? red[a * 32 + lane] : (a < 3 ? inf : -inf);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float u = __shfl_xor_sync(0xffffffffu, bx[a], o);
      bx[a] = a < 3 ? fminf(bx[a], u) : fmaxf(bx[a], u);
    }
  }
  const float lox = bx[0], loy = bx[1], loz = bx[2];
  const float hix = bx[3], hiy = bx[4], hiz = bx[5];

  double ax = 0.0, ay = 0.0, az = 0.0;
  int nfar = 0, nnear = 0, near_total = 0;  // staged now (block-uniform)
  int pops = 0, far_children = 0, near_bodies = 0, overflow = 0;
  bool nan_seen = false;  // the "dma" cut's fold of the loaded rows

  // evaluate every staged source and empty the buffers (block-uniform call):
  // the far sources, then the near rows a tile of kDfThreads at a time, each
  // thread gathering one row (a binary search for its run)
  auto flush = [&]() {
    __syncthreads();  // staged entries are visible
    if (C::eval && warp_live) {
#pragma unroll 4
      for (int q = 0; q < nfar; ++q) accumulate_f64(far_buf[q], xi, yi, zi, eps2, ax, ay, az);
    }
    for (int base = 0; C::load && base < near_total; base += kDfThreads) {
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
      if (C::eval) {
        if (warp_live) {
          const int m = min(kDfThreads, near_total - base);
#pragma unroll 4
          for (int q = 0; q < m; ++q) accumulate_f64(tile[q], xi, yi, zi, eps2, ax, ay, az);
        }
      } else {
        nan_seen |= tile[0].x != tile[0].x;
      }
      __syncthreads();
    }
    __syncthreads();  // the far buffer and the runs are free
    nfar = nnear = near_total = 0;
  };

  // 2-3. level-synchronous traversal from the root's children, kDfRound
  // children a round.  The round and the flush thresholds do not depend on
  // the piece, so every piece of a group stages and flushes the same
  // sources at the same points, and each body sums them in the same order
  // however the group is cut into pieces.
  const unsigned lt = (1u << lane) - 1u;  // lanes below this one
  int round = 0;
  int cur = 1;
  for (int d = 0; d < ld; ++d) {
    const bool terminal = d + 1 >= ld;
    const float bsq_next = bsq[d + 1];
    const int child_off = level_offset(d + 1);
    const int pairs = 8 * cur;
    int next = 0;
    for (int base = 0; base < pairs; base += kDfRound) {
      if (nfar > kDfFarCap - kDfRound || nnear > kDfNearCap - kDfRound) flush();
      const int p = base + t;
      int code = 0;  // 1 far, 2 near, 3 open
      int child = 0, count = 0, first = 0;
      Src64 com{};
      if (p < pairs) {
        child = fr_cur[p >> 3] * 8 + (p & 7);
        const int c = child_off + child;
        count = ccnt[c];
        if (count > 0) {
          com = Src64{cx[c], cy[c], cz[c], cgm[c]};
          // the MAC in f32, on the f32-rounded centre of mass
          code = classify((float)com.x, (float)com.y, (float)com.z, lox, loy, loz, hix, hiy,
                          hiz, theta_sq, bsq_next, count, leaf_cap, terminal);
          if (code == 2) first = cstart[c];
        }
      }
      // compaction in (frontier, child) order: ranks within the warp by
      // ballot, near counts by a shuffle scan, warps by one exchange
      const unsigned far_m = __ballot_sync(0xffffffffu, code == 1);
      const unsigned near_m = __ballot_sync(0xffffffffu, code == 2);
      const unsigned open_m = __ballot_sync(0xffffffffu, code == 3);
      const int c_near = code == 2 ? count : 0;
      const int inc = warp_inclusive(c_near, lane);
      int* wt = wtot + (round & 1) * 64;
      if (lane == 31) {
        wt[w] = __popc(far_m) | (__popc(near_m) << kFlagBits) |
                (__popc(open_m) << (2 * kFlagBits));
        wt[32 + w] = inc;
      }
      __syncthreads();  // the warp totals; the last round's entries
      const int vf = lane < kDfWarps ? wt[lane] : 0;
      const int vc = lane < kDfWarps ? wt[32 + lane] : 0;
      const int incf = warp_inclusive(vf, lane), incc = warp_inclusive(vc, lane);
      const int exf = __shfl_sync(0xffffffffu, incf - vf, w);
      const int exc = __shfl_sync(0xffffffffu, incc - vc, w);
      const int totf = __shfl_sync(0xffffffffu, incf, kDfWarps - 1);
      const int totc = __shfl_sync(0xffffffffu, incc, kDfWarps - 1);
      constexpr int kMask = (1 << kFlagBits) - 1;
      if (code == 1) {
        if (C::far) far_buf[nfar + (exf & kMask) + __popc(far_m & lt)] = com;
      } else if (code == 2) {
        if (C::near) {
          const int k = nnear + ((exf >> kFlagBits) & kMask) + __popc(near_m & lt);
          near_start[k] = first;
          near_off[k] = near_total + exc + inc - c_near;
        }
      } else if (code == 3) {
        const int k = next + (exf >> (2 * kFlagBits)) + __popc(open_m & lt);
        if (k < fcap) fr_next[k] = child;
      }
      const int n_far = totf & kMask;
      nfar += n_far;
      far_children += n_far;
      nnear += (totf >> kFlagBits) & kMask;
      near_total += totc;
      near_bodies += totc;
      next += totf >> (2 * kFlagBits);
      ++round;
    }
    pops += cur;
    if (next >= fcap) overflow = max(overflow, next);
    cur = min(next, fcap);
    int* swap = fr_cur;
    fr_cur = fr_next;
    fr_next = swap;
    __syncthreads();  // the next frontier is visible
  }
  flush();

  if (live && (C::eval || nan_seen)) {
    double* o = out + 3 * (size_t)(gs + b0 + t);
    o[0] = ax;
    o[1] = ay;
    o[2] = az;
  }
  if (t == 0 && b0 == 0) {
    int* st = stats + (size_t)g * kNumStats;
    st[kStatPops] = pops;
    st[kStatSources] = far_children + near_bodies;
    st[kStatNear] = near_bodies;
    st[kStatOverflow] = overflow;
    st[kStatFar] = far_children;
  }
}

// ---------------------------------------------------------------------------
// Launchers

bool bad_args(int ld, int group_size, int fcap, int cut) {
  return ld < 1 || ld > kMaxLd || group_size < 1 || group_size > kMaxBodies || fcap < 1 ||
         cut < kCutNone || cut > kCutFull;
}

template <int kCut>
int launch_warp(const float* cx, const float* cy, const float* cz, const float* gm,
                const int* cnt, const int* start, const int* gstart, const int* gcount,
                const int* order, int n_groups, const float* src, const float* bsq,
                float theta_sq, float eps2, int leaf_cap, int ld, int fcap, int group_size,
                float* out, int* stats, void* stream) {
  const int threads = warp_threads(group_size);
  const size_t smem = warp_smem_bytes(fcap);
  auto kernel = bh_fused_warp_kernel<kCut>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<n_groups, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      cx, cy, cz, gm, cnt, start, gstart, gcount, order, reinterpret_cast<const float4*>(src),
      bsq, theta_sq, eps2, leaf_cap, ld, fcap, out, stats);
  return static_cast<int>(cudaGetLastError());
}

template <int kCut>
int launch_df(const double* cx, const double* cy, const double* cz, const double* gm,
              const int* cnt, const int* start, const int* gstart, const int* gcount,
              const int* pieces, int n_pieces, const double* src, const float* bsq,
              float theta_sq, double eps2, int leaf_cap, int ld, int fcap, int group_size,
              double* out, int* stats, void* stream) {
  (void)group_size;  // a piece holds at most kDfThreads bodies, whatever the group size
  const size_t smem = df_smem_bytes(fcap);
  auto kernel = bh_fused_df_kernel<kCut>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<n_pieces, kDfThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      cx, cy, cz, gm, cnt, start, gstart, gcount, pieces, reinterpret_cast<const Src64*>(src),
      bsq, theta_sq, eps2, leaf_cap, ld, fcap, out, stats);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared memory one block needs for a frontier of `fcap` cells per level,
// at any group size: in the f32 mode, or in the df mode if `df`.
int nbody_bh_fused_smem_bytes(int fcap, int df) {
  return static_cast<int>(df ? df_smem_bytes(fcap) : warp_smem_bytes(fcap));
}

// Stage cut `cut` (0 none, 1 pops, 2 stage, 3 stagefar, 4 stagenear, 5 dma,
// 6 full) of the f32 mode; arguments otherwise as nbody_bh_fused_f32.
int nbody_bh_fused_f32_cut(const float* cx, const float* cy, const float* cz,
                           const float* gm, const int* cnt, const int* start,
                           const int* gstart, const int* gcount, const int* order,
                           int n_groups, const float* src, const float* bsq, float theta_sq,
                           float eps2, int leaf_cap, int ld, int fcap, int group_size,
                           float* out, int* stats, void* stream, int cut) {
  if (bad_args(ld, group_size, fcap, cut)) return static_cast<int>(cudaErrorInvalidValue);
  if (n_groups <= 0) return static_cast<int>(cudaSuccess);
#define NBODY_BH_ARGS                                                                      \
  cx, cy, cz, gm, cnt, start, gstart, gcount, order, n_groups, src, bsq, theta_sq, eps2,    \
      leaf_cap, ld, fcap, group_size, out, stats, stream
  switch (cut) {
    case kCutNone: return launch_warp<kCutNone>(NBODY_BH_ARGS);
    case kCutPops: return launch_warp<kCutPops>(NBODY_BH_ARGS);
    case kCutStage: return launch_warp<kCutStage>(NBODY_BH_ARGS);
    case kCutStageFar: return launch_warp<kCutStageFar>(NBODY_BH_ARGS);
    case kCutStageNear: return launch_warp<kCutStageNear>(NBODY_BH_ARGS);
    case kCutDma: return launch_warp<kCutDma>(NBODY_BH_ARGS);
    default: return launch_warp<kCutFull>(NBODY_BH_ARGS);
  }
#undef NBODY_BH_ARGS
}

// Launch on `stream`, one block per group slot.  Tables cx, cy, cz, gm (f32)
// and cnt, start (i32) hold the dense levels 0..ld (ops/bh_grid.py);
// gstart, gcount (i32, n_groups) the groups' sorted ranges, at most
// group_size <= 1024 bodies each; src (n, 4) f32 [x y z G·m], 16-byte
// aligned; bsq (>= ld + 1) f32 with bsq[l] = (border / 2^l)^2; out (n, 3)
// f32, written for every body of a group (zero it for trimmed groups);
// stats (n_groups, 5) i32.  `order` (n_groups i32, a permutation of the
// slots, or null for 0, 1, ...) is the order in which the blocks take the
// slots: block b runs slot order[b], so the heaviest groups can go first.
// Returns the cudaError_t of the launch.
int nbody_bh_fused_f32(const float* cx, const float* cy, const float* cz, const float* gm,
                       const int* cnt, const int* start, const int* gstart,
                       const int* gcount, const int* order, int n_groups, const float* src,
                       const float* bsq, float theta_sq, float eps2, int leaf_cap, int ld,
                       int fcap, int group_size, float* out, int* stats, void* stream) {
  return nbody_bh_fused_f32_cut(cx, cy, cz, gm, cnt, start, gstart, gcount, order, n_groups,
                                src, bsq, theta_sq, eps2, leaf_cap, ld, fcap, group_size, out,
                                stats, stream, kCutFull);
}

// Stage cut `cut` of the df mode; arguments otherwise as nbody_bh_fused_f64.
int nbody_bh_fused_f64_cut(const double* cx, const double* cy, const double* cz,
                           const double* gm, const int* cnt, const int* start,
                           const int* gstart, const int* gcount, const int* pieces,
                           int n_pieces, const double* src, const float* bsq, float theta_sq,
                           double eps2, int leaf_cap, int ld, int fcap, int group_size,
                           double* out, int* stats, void* stream, int cut) {
  if (bad_args(ld, group_size, fcap, cut)) return static_cast<int>(cudaErrorInvalidValue);
  if (n_pieces <= 0) return static_cast<int>(cudaSuccess);
#define NBODY_BH_ARGS                                                                      \
  cx, cy, cz, gm, cnt, start, gstart, gcount, pieces, n_pieces, src, bsq, theta_sq, eps2,   \
      leaf_cap, ld, fcap, group_size, out, stats, stream
  switch (cut) {
    case kCutNone: return launch_df<kCutNone>(NBODY_BH_ARGS);
    case kCutPops: return launch_df<kCutPops>(NBODY_BH_ARGS);
    case kCutStage: return launch_df<kCutStage>(NBODY_BH_ARGS);
    case kCutStageFar: return launch_df<kCutStageFar>(NBODY_BH_ARGS);
    case kCutStageNear: return launch_df<kCutStageNear>(NBODY_BH_ARGS);
    case kCutDma: return launch_df<kCutDma>(NBODY_BH_ARGS);
    default: return launch_df<kCutFull>(NBODY_BH_ARGS);
  }
#undef NBODY_BH_ARGS
}

// The df mode: the tables cx, cy, cz, gm, the sources src (n, 4), eps2 and
// out in fp64; bsq and theta_sq stay f32 (the MAC is f32).  One block of
// 256 threads per piece: `pieces` (n_pieces, 3) i32 holds [slot, first
// body, end body) of a group, at most 256 bodies, in the order the blocks
// take them (ops/bh_fused.py::df_pieces).  stats (n_groups, 5) i32 must be
// zeroed by the caller: each group's row is written by its piece that
// starts at body 0.  Other arguments as nbody_bh_fused_f32.
int nbody_bh_fused_f64(const double* cx, const double* cy, const double* cz,
                       const double* gm, const int* cnt, const int* start, const int* gstart,
                       const int* gcount, const int* pieces, int n_pieces, const double* src,
                       const float* bsq, float theta_sq, double eps2, int leaf_cap, int ld,
                       int fcap, int group_size, double* out, int* stats, void* stream) {
  return nbody_bh_fused_f64_cut(cx, cy, cz, gm, cnt, start, gstart, gcount, pieces, n_pieces,
                                src, bsq, theta_sq, eps2, leaf_cap, ld, fcap, group_size, out,
                                stats, stream, kCutFull);
}

}  // extern "C"
