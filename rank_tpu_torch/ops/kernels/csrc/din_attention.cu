// Fused DIN attention forward for Hopper (sm_90a), f32.
//
// Replaces the Pallas TPU kernel rank_tpu/ops/pallas/din_attention.py
// (din_attention_fused -> _forward -> _kernel). Per batch row b:
//   h1[t]  = relu(q@(w1a+w1c) + k[t]@(w1b-w1c) + (q*k[t])@w1d + b1)   (the
//            [q, k, q-k, q*k] @ w1 product with the concat folded away)
//   h2[t]  = relu(h1[t] @ w2 + b2)
//   s[t]   = h2[t] @ w3 + b3
//   w      = softmax over T of where(t < len, s, MASK_NEG) / sqrt(D), with
//            zero weight on masked positions and on all-masked rows, or
//            where(t < len, s, 0) without softmax
//   out[b] = sum_t w[t] * k[t]
//
// What bounds it on an H100: per row it reads 3.3 KB (keys 50x16 f32) and
// does ~416 kFLOP in f32 outside the tensor cores (D=16, T=50, 64/32
// hidden), ~126 FLOP per byte, above the f32 ridge of ~20 FLOP per byte:
// the work is bound by operations, not bytes.
//
// Design (simple and right first):
//   * a block holds R rows (R*32-rounded-T threads, about 256); one thread
//     per timestep, so T need not be a power of two;
//   * the folded first-layer weights, w2, b2 and w3 are staged in shared
//     memory once per block; blocks loop over row groups (grid-stride), so
//     that staging is paid once per block, not once per row;
//   * each row's keys are copied into shared memory with coalesced loads,
//     with an odd row stride so that threads reading their own timestep
//     hit distinct banks; the pool reads them again from there;
//   * a timestep past the row's length skips the MLP: its weight is zero
//     in both modes (the softmax max still runs over all T positions, as
//     the reference does);
//   * the softmax and the pool run per row: one thread for the max and
//     the sum over T, threads over D for the pool.
// The TPU kernel's T->multiple-of-8 and B->128 padding are TPU tiling and
// are not carried over: shapes are runtime arguments.

#include <cuda_runtime.h>

#include <algorithm>
#include <math.h>

namespace {

constexpr float kMaskNeg = -4294967295.0f;  // -(2**32)+1, as f32
constexpr int kBlockThreads = 256;

template <int MAX_H2>
__global__ void din_attention_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ keys,
    const int* __restrict__ lengths, const float* __restrict__ w1,
    const float* __restrict__ b1, const float* __restrict__ w2,
    const float* __restrict__ b2, const float* __restrict__ w3,
    const float* __restrict__ b3, float* __restrict__ out, int B, int T,
    int D, int H1, int H2, int use_softmax) {
  extern __shared__ float smem[];
  const int dp = D | 1;  // odd stride: thread t reads word t*dp+d, no bank conflicts
  const int row_floats = T * dp + D + H1 + T + 1;
  float* w1q = smem;          // (D, H1) = w1a + w1c, acts on q
  float* w1k = w1q + D * H1;  // (D, H1) = w1b - w1c, acts on k
  float* w1p = w1k + D * H1;  // (D, H1) = w1d, acts on q*k
  float* w2s = w1p + D * H1;  // (H1, H2)
  float* b2s = w2s + H1 * H2;
  float* w3s = b2s + H2;
  float* rows = w3s + H2;     // R rows of row_floats each

  const int tx = threadIdx.x, ty = threadIdx.y, R = blockDim.y;
  const int tid = ty * blockDim.x + tx, nthreads = blockDim.x * blockDim.y;
  for (int i = tid; i < D * H1; i += nthreads) {
    const int d = i / H1, j = i % H1;
    const float c = w1[(2 * D + d) * H1 + j];
    w1q[i] = w1[d * H1 + j] + c;
    w1k[i] = w1[(D + d) * H1 + j] - c;
    w1p[i] = w1[(3 * D + d) * H1 + j];
  }
  for (int i = tid; i < H1 * H2; i += nthreads) w2s[i] = w2[i];
  for (int i = tid; i < H2; i += nthreads) {
    b2s[i] = b2[i];
    w3s[i] = w3[i];
  }
  const float bias3 = b3[0];
  const float sqrt_d = sqrtf((float)D);

  float* ks = rows + ty * row_floats;  // (T, dp) keys
  float* qs = ks + T * dp;             // (D) query
  float* qh = qs + D;                  // (H1) q @ w1q + b1
  float* ws = qh + H1;                 // (T) scores, then softmax numerators
  float* denom = ws + T;               // softmax denominator

  for (int row0 = blockIdx.x * R; row0 < B; row0 += gridDim.x * R) {
    const int nrows = min(R, B - row0);
    __syncthreads();  // weights staged; the previous group is done with `rows`
    const float* kg = keys + (size_t)row0 * T * D;
    for (int i = tid; i < nrows * T * D; i += nthreads) {
      const int r = i / (T * D), rem = i % (T * D);
      rows[r * row_floats + (rem / D) * dp + rem % D] = kg[i];
    }
    for (int i = tid; i < nrows * D; i += nthreads)
      rows[(i / D) * row_floats + T * dp + i % D] = q[(size_t)row0 * D + i];
    __syncthreads();

    const int row = row0 + ty;
    const bool live = ty < nrows;
    const int len = live ? min(max(lengths[row], 0), T) : 0;
    if (live) {
      for (int j = tx; j < H1; j += blockDim.x) {
        float a = b1[j];
        for (int d = 0; d < D; ++d) a = fmaf(qs[d], w1q[d * H1 + j], a);
        qh[j] = a;
      }
    }
    __syncthreads();

    if (live) {
      for (int t = tx; t < T; t += blockDim.x) {
        float score = 0.f;
        if (t < len) {
          const float* kt = ks + t * dp;
          float acc[MAX_H2];
#pragma unroll
          for (int i = 0; i < MAX_H2; ++i) acc[i] = i < H2 ? b2s[i] : 0.f;
          for (int j = 0; j < H1; ++j) {
            float a = qh[j];
            for (int d = 0; d < D; ++d) {
              const float kd = kt[d];
              a = fmaf(kd, w1k[d * H1 + j], a);
              a = fmaf(qs[d] * kd, w1p[d * H1 + j], a);
            }
            a = fmaxf(a, 0.f);
#pragma unroll
            for (int i = 0; i < MAX_H2; ++i)
              if (i < H2) acc[i] = fmaf(a, w2s[j * H2 + i], acc[i]);
          }
          score = bias3;
#pragma unroll
          for (int i = 0; i < MAX_H2; ++i)
            if (i < H2) score = fmaf(fmaxf(acc[i], 0.f), w3s[i], score);
        }
        ws[t] = score;
      }
    }
    __syncthreads();

    if (live && tx == 0) {
      if (use_softmax) {
        float m = -INFINITY;
        for (int t = 0; t < T; ++t) {
          const float s = (t < len ? ws[t] : kMaskNeg) / sqrt_d;
          ws[t] = s;
          m = fmaxf(m, s);
        }
        float sum = 0.f;
        for (int t = 0; t < T; ++t) {
          const float e = t < len ? expf(ws[t] - m) : 0.f;
          ws[t] = e;
          sum += e;
        }
        *denom = fmaxf(sum, 1e-12f);
      } else {
        *denom = 1.f;  // raw masked scores; positions >= len are never read
      }
    }
    __syncthreads();

    if (live) {
      for (int d = tx; d < D; d += blockDim.x) {
        float acc = 0.f;
        for (int t = 0; t < len; ++t) {
          const float w = use_softmax ? ws[t] / *denom : ws[t];
          acc = fmaf(w, ks[t * dp + d], acc);
        }
        out[(size_t)row * D + d] = acc;
      }
    }
  }
}

template <int MAX_H2>
cudaError_t launch(const float* q, const float* keys, const int* lengths,
                   const float* w1, const float* b1, const float* w2,
                   const float* b2, const float* w3, const float* b3,
                   float* out, int B, int T, int D, int H1, int H2,
                   int use_softmax, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int row_threads = std::min(1024, std::max(32, (T + 31) / 32 * 32));
  const int R = std::max(1, kBlockThreads / row_threads);
  const size_t row_floats = (size_t)T * (D | 1) + D + H1 + T + 1;
  const size_t smem = sizeof(float) *
      ((size_t)3 * D * H1 + (size_t)H1 * H2 + 2 * H2 + R * row_floats);
  auto kernel = din_attention_fwd_kernel<MAX_H2>;
  // Above 48 KB a block must opt in; above the card's limit this fails
  // and the launch is refused with the error returned here.
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 block(row_threads, R);
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, row_threads * R, smem);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int groups = (B + R - 1) / R;
  const int grid = std::min(groups, std::max(1, per_sm) * sms);
  kernel<<<grid, block, smem, stream>>>(q, keys, lengths, w1, b1, w2, b2, w3,
                                        b3, out, B, T, D, H1, H2, use_softmax);
  return cudaGetLastError();
}

}  // namespace

extern "C" int din_attention_fwd(const float* q, const float* keys,
                                 const int* lengths, const float* w1,
                                 const float* b1, const float* w2,
                                 const float* b2, const float* w3,
                                 const float* b3, float* out, int B, int T,
                                 int D, int H1, int H2, int use_softmax,
                                 int device, void* stream) {
  if (B < 1 || T < 0 || D < 1 || H1 < 1 || H2 < 1 || H2 > 64)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (H2 <= 32)
    return (int)launch<32>(q, keys, lengths, w1, b1, w2, b2, w3, b3, out, B,
                           T, D, H1, H2, use_softmax, device, s);
  return (int)launch<64>(q, keys, lengths, w1, b1, w2, b2, w3, b3, out, B, T,
                         D, H1, H2, use_softmax, device, s);
}

extern "C" const char* din_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
