// tf32_probe.cu — for the trial in trials/kernel_trial.py only: one
// mma.sync m16n8k8 .tf32 whose A holds 1 + 2^-11 + 2^-12 (bits below TF32's
// 10 mantissa bits set) and whose B picks it out, so the result shows
// whether the tensor cores drop an f32 operand's low 13 bits (1), round it
// (1 + 2^-10) or read it whole.

#include <cuda_runtime.h>

namespace {

__global__ void tf32_probe_kernel(float* out) {
  const int lane = threadIdx.x;
  const int g = lane >> 2, t = lane & 3;
  // A = 0 but A[0][0] = 1 + 2^-11 + 2^-12; B = 0 but B[0][0] = 1
  const float a00 = 1.0f + 0x1p-11f + 0x1p-12f;
  unsigned a[4] = {(g == 0 && t == 0) ? __float_as_uint(a00) : 0u, 0u, 0u, 0u};
  const unsigned b0 = (g == 0 && t == 0) ? __float_as_uint(1.0f) : 0u;
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(0u));
  if (lane == 0) {
    out[0] = d[0];
    out[1] = a00;
  }
}

}  // namespace

extern "C" {

// out[0]: the tensor cores' product of 1 + 2^-11 + 2^-12 and 1; out[1]: the
// f32 operand.
int nbody_tf32_probe(float* out) {
  tf32_probe_kernel<<<1, 32>>>(out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
