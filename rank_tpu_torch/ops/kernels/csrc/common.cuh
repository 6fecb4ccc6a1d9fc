// What the hand-written kernels' libraries share: the 3xTF32 mma.sync core
// of cin.cu and din_attention.cu; on the host, each device's limits and each
// kernel's shared-memory opt-in, read or set once rather than at every
// launch, one launch path, and the error string every library exports. Each
// library is one translation unit that includes this header once.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <utility>

namespace {

// x = hi + lo. hi is x rounded to TF32 as cvt.rna.tf32.f32 rounds it (to
// nearest, ties away from zero), in two integer operations: add half a TF32
// unit to the magnitude, clear the 13 bits TF32 drops. lo = x - hi is exact
// in f32 (Sterbenz) and is passed as it is: the tensor core reads the top
// 19 bits of a TF32 operand, so lo keeps 2^-10 of itself and x is kept to
// 2^-21 of itself.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a (16x8, row) * b (8x8, col); TF32 inputs, f32 accumulators.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// What a launch reads of its device, which cannot change while the process
// lives: the SM count and the opt-in shared memory a block.
struct DeviceLimits {
  int sms = 0;
  int smem_optin = 0;
};

// Makes `device` current and gives its limits, queried at its first launch
// and then read without a runtime call; a failed query caches nothing.
// Locked, as are the grants below: autograd's device thread launches a
// backward while the main thread launches a forward.
cudaError_t use_device(int device, DeviceLimits& out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  static std::mutex mutex;
  static std::map<int, DeviceLimits> cache;
  std::lock_guard<std::mutex> lock(mutex);
  auto it = cache.find(device);
  if (it == cache.end()) {
    DeviceLimits d;
    err = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&d.smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return err;
    it = cache.emplace(device, d).first;
  }
  out = it->second;
  return cudaSuccess;
}

// Lets `kernel` launch with `smem` bytes of dynamic shared memory on the
// current device `device`, setting the attribute only when a launch asks for
// more than was last granted there. Above 48 KB a block must opt in; past the
// card's limit this fails, nothing is recorded, and the launch is refused
// with the error returned here.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int device, size_t smem) {
  static std::mutex mutex;
  static std::map<std::pair<const void*, int>, size_t> granted;
  const std::pair<const void*, int> key(reinterpret_cast<const void*>(kernel), device);
  std::lock_guard<std::mutex> lock(mutex);
  const auto it = granted.find(key);
  if (it != granted.end() && it->second >= smem) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) granted[key] = smem;
  return err;
}

// One launch on `stream` once `smem` is allowed; a refused or failed launch
// returns its error.
template <typename Kernel, typename... Args>
cudaError_t launch_kernel(Kernel kernel, dim3 grid, dim3 block, size_t smem, int device,
                          cudaStream_t stream, Args... args) {
  const cudaError_t err = allow_smem(kernel, device, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, block, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace

// The message of an error code that an entry point returned.
extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
