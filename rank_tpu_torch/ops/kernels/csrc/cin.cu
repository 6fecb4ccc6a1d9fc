// One CIN (Compressed Interaction Network) layer forward for Hopper
// (sm_90a), f32, in the transposed (B, D, .) layout.
//
// Replaces the Pallas TPU kernel rank_tpu/ops/pallas/cin.py
// (cin_layer_fused_t -> _forward_t -> _kernel). With m = (b, d) a row of
// the (B*D, .) views of the inputs:
//   out[m, o] = sum_{h, f} xk[m, h] * x0[m, f] * w[o, h, f]
// which is one GEMM of M = B*D rows, K = H*F and N = O, whose A operand
//   A[m, h*F + f] = xk[m, h] * x0[m, f]
// is the (B, H, F, D) pair tensor of the plain version. The kernel never
// writes it to device memory: each block forms its A tiles in shared memory
// from the xk and x0 rows it staged. B[h*F + f, o] = w[o, h, f] is
// reordered by the wrapper (at most H*F*O = 57,344 floats a call).
//
// What bounds it on an H100: a row reads 4*(H + F) bytes and writes 4*O,
// and costs 2*F*O*(H + 1) FLOP counted as the TPU kernel does its work (or
// 2*H*F*O here, plus H*F multiplies to form A). Layer 1 of the default
// xDeepFM (H = 64, F = 7, O = 128, D = 16 rows a sample) does ~146 FLOP per
// byte, above the f32 ridge of ~20 FLOP per byte: bound by operations.
//
// Design (simple and right first; wgmma and TMA wait for a later change):
//   * a block takes TM = 64 rows and TN = 128 outputs (grid.y walks O in
//     TN-wide tiles), with 256 threads, each holding a 4 x 8 tile of the
//     output in registers: one accumulator, plain f32 FMAs on CUDA cores;
//   * the block stages its xk rows (TM x H) and x0 rows (TM x F) in shared
//     memory once, with odd row strides so that threads reading one column
//     of consecutive rows hit distinct banks;
//   * it walks K in chunks of KC = 16: each chunk of A (KC x TM) is formed
//     in shared memory, one multiply per element, and the matching chunk of
//     B (KC x TN) is copied in with coalesced loads; ragged edges of M, K
//     and N are zero-filled and masked on the store.
// The TPU kernel's factored form (one (TB*D, H) x (H, F*O) product and F
// lane-slice multiply-accumulates) and its batch-tile padding answer the
// TPU's layouts and are not carried over.

#include <cuda_runtime.h>

namespace {

constexpr int kTM = 64;
constexpr int kTN = 128;
constexpr int kKC = 16;
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 8 outputs each

__global__ void __launch_bounds__(kThreads)
cin_layer_fwd_kernel(const float* __restrict__ xk, const float* __restrict__ x0,
                     const float* __restrict__ wt, float* __restrict__ out,
                     int M, int H, int F, int O) {
  extern __shared__ __align__(16) float smem[];  // float4 reads of as and bs
  const int hp = H | 1, fp = F | 1;  // odd strides: no bank conflicts
  float* as = smem;                  // (KC, TM) chunk of A, k-major
  float* bs = as + kKC * kTM;        // (KC, TN) chunk of B
  float* xs = bs + kKC * kTN;        // (TM, hp) xk rows
  float* x0s = xs + kTM * hp;        // (TM, fp) x0 rows

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kTM, n0 = blockIdx.y * kTN;
  const int rows = min(kTM, M - m0);
  for (int i = tid; i < kTM * H; i += kThreads)
    xs[(i / H) * hp + i % H] = i < rows * H ? xk[(size_t)m0 * H + i] : 0.f;
  for (int i = tid; i < kTM * F; i += kThreads)
    x0s[(i / F) * fp + i % F] = i < rows * F ? x0[(size_t)m0 * F + i] : 0.f;

  const int tx = tid % 16, ty = tid / 16;  // outputs n = tx*8.., rows m = ty*4..
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int K = H * F;
  for (int k0 = 0; k0 < K; k0 += kKC) {
    __syncthreads();  // rows staged; the previous chunk has been consumed
    for (int i = tid; i < kKC * kTM; i += kThreads) {
      const int kk = i / kTM, m = i % kTM, k = k0 + kk;
      float a = 0.f;
      if (k < K) {
        const int h = k / F, f = k - h * F;
        a = xs[m * hp + h] * x0s[m * fp + f];
      }
      as[i] = a;
    }
    for (int i = tid; i < kKC * kTN; i += kThreads) {
      const int kk = i / kTN, n = i % kTN, k = k0 + kk;
      bs[i] = (k < K && n0 + n < O) ? wt[(size_t)k * O + n0 + n] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kKC; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(as + kk * kTM + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(bs + kk * kTN + tx * 8);
      const float4 b1 = *reinterpret_cast<const float4*>(bs + kk * kTN + tx * 8 + 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + tx * 8 + j;
      if (n < O) out[(size_t)m * O + n] = acc[i][j];
    }
  }
}

}  // namespace

// xk (M, H), x0 (M, F), wt (H*F, O) with row h*F + f, out (M, O); all f32,
// contiguous, on `device`. Launches on `stream`; returns a cudaError_t.
extern "C" int cin_layer_fwd(const float* xk, const float* x0, const float* wt,
                             float* out, int M, int H, int F, int O, int device,
                             void* stream) {
  if (M < 1 || H < 1 || F < 1 || O < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = sizeof(float) *
      ((size_t)kKC * (kTM + kTN) + (size_t)kTM * ((H | 1) + (F | 1)));
  // Above 48 KB a block must opt in; above the card's limit this fails and
  // the launch is refused with the error returned here.
  err = cudaFuncSetAttribute(cin_layer_fwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((M + kTM - 1) / kTM, (O + kTN - 1) / kTN);
  cin_layer_fwd_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      xk, x0, wt, out, M, H, F, O);
  return (int)cudaGetLastError();
}

extern "C" const char* cin_layer_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
