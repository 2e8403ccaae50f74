// split_sum.cuh — the fixed-order meeting of a block's source slices, shared
// by K1 (allpairs.cu), K4 (allpairs_f64.cu) and both entries of K7
// (group_lists.cu).
//
// Those kernels hold kPer targets a thread and, where the targets alone
// cannot fill the card, split each block's source range over `split` = S
// groups of kThreads / S threads: thread u of group s holds the same
// targets as thread u of group 0 and sweeps the s-th slice of every source
// tile.  Here the groups' sums are added through shared memory in the
// order s = 0, 1, ..., S - 1, so each target's sum order depends on S
// only: no global workspace, no atomics, bit-identical reruns.
#pragma once

// Adds groups 1 ... S - 1's sums into group 0's.  `part` is shared memory
// of at least kThreads * kPer * 3 elements that no thread reads or writes
// any more (the caller's last tile is behind a barrier).  Every
// thread of the block must call it; it returns true for group 0's threads,
// which hold the totals, and false for the others, which write nothing.
template <int kPer, typename T>
__device__ __forceinline__ bool meet_groups(T* part, int split, int width, int s, int u,
                                            T (&ax)[kPer], T (&ay)[kPer], T (&az)[kPer]) {
  if (split == 1) return true;
  if (s > 0) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      T* p = part + (((size_t)(s - 1) * width + u) * kPer + k) * 3;
      p[0] = ax[k];
      p[1] = ay[k];
      p[2] = az[k];
    }
  }
  __syncthreads();
  if (s > 0) return false;
#pragma unroll 1
  for (int g = 1; g < split; ++g) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const T* p = part + (((size_t)(g - 1) * width + u) * kPer + k) * 3;
      ax[k] += p[0];
      ay[k] += p[1];
      az[k] += p[2];
    }
  }
  return true;
}
