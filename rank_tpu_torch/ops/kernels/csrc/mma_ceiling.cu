// The card's rate for mma.sync.m16n8k8 in TF32 (f32 accumulators), the
// instruction both hand-written kernels (cin.cu, din_attention.cu) run
// their 3xTF32 products on. Not a kernel of any path: chip_smoke.py times
// it to state how close each kernel comes to what mma.sync can give, beside
// the published 495 TFLOP/s that only wgmma reaches.
//
// Every warp runs `iters` rounds of kAcc independent products on register
// operands, so nothing but the tensor cores' own rate bounds it; the sums
// are written out so that the compiler keeps them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kAcc = 8;

__global__ void __launch_bounds__(kThreads)
mma_tf32_ceiling_kernel(float* __restrict__ out, int iters) {
  float acc[kAcc][4] = {};
  const uint32_t a0 = threadIdx.x, a1 = a0 + 1, a2 = a0 + 2, a3 = a0 + 3;
  const uint32_t b0 = blockIdx.x, b1 = b0 + 7;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < kAcc; ++j)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
          : "+f"(acc[j][0]), "+f"(acc[j][1]), "+f"(acc[j][2]), "+f"(acc[j][3])
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  }
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < kAcc; ++j) s += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
  out[blockIdx.x * kThreads + threadIdx.x] = s;
}

}  // namespace

// out: blocks * 256 floats on `device`. Each of the blocks' 8 warps runs
// iters * 8 mma.sync m16n8k8 (2,048 FLOP each). Returns a cudaError_t.
extern "C" int mma_tf32_ceiling(float* out, int blocks, int iters, int device, void* stream) {
  if (blocks < 1 || iters < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  mma_tf32_ceiling_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(out, iters);
  return (int)cudaGetLastError();
}
