// Fused DIN attention forward for Hopper (sm_90a), f32-accurate on the
// tensor cores (3xTF32).
//
// Replaces the Pallas TPU kernel rank_tpu/ops/pallas/din_attention.py
// (din_attention_fused -> _forward -> _kernel). Per batch row b, with the
// first layer's row blocks w1a..w1d (acting on q, k, q-k and q*k) folded
// as the kernel stages them, w1q = w1a + w1c and w1kp = [w1b - w1c ; w1d]:
//   h1[t]  = relu([k[t] | q*k[t]] @ w1kp + (q @ w1q + b1))   (the
//            [q, k, q-k, q*k] @ w1 product with the concat folded away)
//   h2[t]  = relu(h1[t] @ w2 + b2)
//   s[t]   = h2[t] @ w3 + b3
//   w      = softmax over T of where(t < len, s, MASK_NEG) / sqrt(D), with
//            zero weight on masked positions and on all-masked rows, or
//            where(t < len, s, 0) without softmax
//   out[b] = sum_t w[t] * k[t]
//
// What bounds it on an H100 (700 W), D = 16, T = 50, H1 = 64, H2 = 32, for
// each timestep below its row's length: the products [k | q*k] @ w1kp
// (2*2D*H1 = 4,096 FLOP) and h1 @ w2 (2*H1*H2 = 4,096 FLOP); the rest
// (q @ w1q once a row, the score, the pool) is ~100 FLOP in f32. At
// B = 8192 with lengths uniform in [0, 50] (~209k valid timesteps):
//   * f32 outside the tensor cores (67 TFLOP/s): 0.025 ms;
//   * tensor cores: 3 x 1.7 GFLOP at 495 TFLOP/s, plus the f32 rest at
//     67 TFLOP/s: 0.011 ms;
//   * bytes: the valid keys, q, lengths and out, ~14 MB at 3.35 TB/s:
//     0.004 ms.
// Both bounds are set by operations.
//
// Why 3xTF32: as in cin.cu. The JAX kernel multiplies in f32 and the port
// holds this kernel to 1e-5; one TF32 product keeps 10 mantissa bits and
// misses that bar, while hi = tf32(x), lo = x - hi and lo*hi + hi*lo +
// hi*hi, each k-step's sum added in f32, are as close as an f32 product.
//
// Two kernels, chosen by the wrapper (ops/kernels/din_attention.py) by
// shape, each with its own launch count:
//   * din_attention_fwd_kernel<D>, on the tensor cores, for D in {8, 16,
//     32, 64} and hidden widths (64, 32), the widths DINAttention is built
//     with (the main path's D = 16 among them), and any T;
//   * din_attention_generic_kernel, f32 FMAs on the CUDA cores, for every
//     other D >= 1 and hidden widths (H1, H2) >= 1, and any T. A block
//     owns a row; its weights are read through L1/L2 rather than staged,
//     so no width has to fit in shared memory with them.
// Both stream a row's valid keys through shared memory in tiles of 16
// timesteps (a 2-stage cp.async ring a warp in the first), so T is not
// bounded by shared memory. Under use_softmax they keep an online max and
// sum and rescale the pooled sum at each tile; the pooled sum is kept in
// f64 across tiles, so that a long row's sum is not the error's source.
//
// Design of the tensor-core kernel, against what held the earlier
// one-thread-a-timestep kernel back:
//   * the scoring MLP runs on the tensor cores (mma.sync m16n8k8 TF32,
//     three products a k-step): a warp owns one row at a time, its
//     timesteps in m-tiles of 16, and runs only the ceil(len/16) tiles
//     that hold valid timesteps (no serial 8k-FMA chain a thread, and no
//     idle lanes from rounding T = 50 up to 64 threads);
//   * layer 1 is (16 x 2D) [k | q*k] @ (2D x H1); q @ w1q + b1 is computed
//     once a row and added with the ReLU;
//   * layer 2 reads h1 straight from the layer-1 accumulators. In TF32 the
//     accumulator layout (row g, columns 2*tig and 2*tig + 1 of each 8-wide
//     tile) is not the A layout (columns tig and tig + 4); but a product
//     sums over k in any order, so k-step j takes accumulator tile j with
//     its columns permuted (2*tig -> tig, 2*tig + 1 -> tig + 4), and the
//     b fragments read rows 8j + 2*tig and 8j + 2*tig + 1 of w2 to match:
//     no trip through shared memory and no shuffles;
//   * the score is the dot with w3 across the 4 lanes that share a row
//     (two shuffles); the masked softmax runs over the warp by shuffles,
//     with exactly the reference's semantics; the pool splits the warp over
//     D and over timesteps and reduces by shuffles;
//   * the weights are folded and staged once a block by all its 8 warps,
//     w1kp and w2 split into their TF32 hi and lo parts and stored in
//     fragment order, so that a lane loads the four b registers of a
//     k-step with one 16-byte load; R of the warps then loop over rows,
//     each copying the valid keys of its row with cp.async, the next
//     16-step tile in flight while the current one is scored. The grid is
//     at most the blocks the SMs hold at once, each looping over rows, so
//     the fold (about 3k adds a block) is paid once a block and not once
//     a row, and it costs no extra launch as a fold in torch would;
//   * at small B a block works on fewer rows at once (R = B / #SMs, at
//     least 1), so that B = 256 puts work on every SM; D is a template
//     parameter (8, 16, 32, 64) and H1 = 64, H2 = 32, the widths
//     DINAttention is built with.
// The TPU kernel's T->multiple-of-8 and B->128 padding are TPU tiling and
// are not carried over: T and B are runtime arguments.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <math.h>

namespace {

constexpr float kMaskNeg = -4294967295.0f;  // -(2**32)+1, as f32
constexpr int kH1 = 64, kH2 = 32;
constexpr int kWarps = 8;  // a block: all stage the weights, R <= 8 take rows
constexpr unsigned kFull = 0xffffffffu;

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

// The b registers of a lane for one k-step: {hi(k0), hi(k1), lo(k0), lo(k1)}.
__device__ __forceinline__ uint4 b_fragment(float k0, float k1) {
  uint4 b;
  split_tf32(k0, b.x, b.z);
  split_tf32(k1, b.y, b.w);
  return b;
}

// d += a*b for one k-step in 3xTF32: the three products, small terms
// first, summed on the tensor core into a zeroed fragment, then added to d
// in f32 on the CUDA cores (the tensor core truncates as it accumulates;
// cin.cu's header says why that matters).
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], const uint4& b) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(t, al, b.x, b.y);
  mma_tf32(t, ah, b.z, b.w);
  mma_tf32(t, ah, b.x, b.y);
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] += t[e];
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

// One tile of the online softmax over the warp, lane t holding timestep
// t of the tile (t < nv valid, raw score s). Returns the factor that
// rescales what was pooled before this tile, and leaves lane t's weight
// exp(s / sqrt(D) - m) in w. m starts at MASK_NEG / sqrt(D) when the row
// has masked positions (they take part in the max, as in the reference,
// with zero weight) and at -inf when it has none.
__device__ __forceinline__ float softmax_tile(float s, int lane, int nv, float sqrt_d,
                                              float& m, float& sum, float& w) {
  const float z = lane < nv ? s / sqrt_d : -INFINITY;
  const float m_new = fmaxf(m, warp_max(z));
  const float scale = expf(m - m_new);  // 0 at the first tile of an unmasked row
  w = lane < nv ? expf(z - m_new) : 0.f;
  sum = sum * scale + warp_sum(w);
  m = m_new;
  return scale;
}

// Shared-memory layout, in 4-byte words. The b fragments of w1kp and w2 are
// stored in the order the lanes read them: for k-step s, column n and lane
// tig, four words {hi(k0), hi(k1), lo(k0), lo(k1)} with k0, k1 the two rows
// the lane needs (8s + tig and 8s + tig + 4 for w1kp; 8s + 2*tig and
// 8s + 2*tig + 1 for w2, the permuted k of layer 2), so that a lane loads
// its four b registers with one 16-byte load and a warp reads 512
// contiguous bytes. Key rows have the stride SK = D + 4: a fragments read
// rows g of columns tig, banks 4*g + tig.
constexpr int kTile = 16;  // timesteps a tile: one m-tile of the products
template <int D>
struct Layout {
  static constexpr int K1 = 2 * D, SK = D + 4;
  static constexpr int kWeights = 2 * K1 * kH1 + 2 * kH1 * kH2 + D * kH1 + kH1 + 2 * kH2;
  // keys (2 stages x kTile, SK), scores (kTile), q (D), q @ w1q + b1 (H1)
  static constexpr int kPerWarp = 2 * kTile * SK + kTile + D + kH1;
};

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
din_attention_fwd_kernel(const float* __restrict__ q, const float* __restrict__ keys,
                         const int* __restrict__ lengths, const float* __restrict__ w1,
                         const float* __restrict__ b1,
                         const float* __restrict__ w2, const float* __restrict__ b2,
                         const float* __restrict__ w3, const float* __restrict__ b3,
                         float* __restrict__ out, int B, int T, int R, int use_softmax) {
  using L = Layout<D>;
  constexpr int K1 = L::K1, SK = L::SK;
  extern __shared__ __align__(16) float smem[];
  uint4* w1frag = reinterpret_cast<uint4*>(smem);  // (K1/8, H1, 4): w1kp
  uint4* w2frag = w1frag + K1 / 8 * kH1 * 4;       // (H1/8, H2, 4): w2
  float* w1qs = reinterpret_cast<float*>(w2frag + kH1 / 8 * kH2 * 4);  // (D, H1)
  float* b1s = w1qs + D * kH1;
  float* b2s = b1s + kH1;
  float* w3s = b2s + kH2;
  float* warps = w3s + kH2;

  // Stage the weights: the small ones with cp.async, the first layer
  // folded, w1kp and w2 split into their b fragments (loads unrolled, so
  // that several are in flight). Row k of w1kp is w1b[k] - w1c[k] for
  // k < D and w1d[k - D] = w1[2D + k] after.
  const int tid = threadIdx.x, nthreads = blockDim.x;
  auto w1kp = [&](int k, int n) {
    return k < D ? w1[(D + k) * kH1 + n] - w1[(2 * D + k) * kH1 + n] : w1[(2 * D + k) * kH1 + n];
  };
  for (int i = tid; i < kH1; i += nthreads) cp_async4(b1s + i, b1 + i);
  for (int i = tid; i < kH2; i += nthreads) {
    cp_async4(b2s + i, b2 + i);
    cp_async4(w3s + i, w3 + i);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#pragma unroll 4
  for (int i = tid; i < K1 / 8 * kH1 * 4; i += nthreads) {
    const int t = i & 3, n = (i >> 2) % kH1, s = (i >> 2) / kH1;
    w1frag[i] = b_fragment(w1kp(8 * s + t, n), w1kp(8 * s + t + 4, n));
  }
#pragma unroll 4
  for (int i = tid; i < D * kH1; i += nthreads) w1qs[i] = w1[i] + w1[2 * D * kH1 + i];
#pragma unroll 4
  for (int i = tid; i < kH1 / 8 * kH2 * 4; i += nthreads) {
    const int t = i & 3, n = (i >> 2) % kH2, s = (i >> 2) / kH2;
    w2frag[i] = b_fragment(w2[(8 * s + 2 * t) * kH2 + n], w2[(8 * s + 2 * t + 1) * kH2 + n]);
  }
  const float bias3 = b3[0];
  const float sqrt_d = sqrtf((float)D);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  const int lane = tid & 31, warp = tid >> 5;
  if (warp >= R) return;  // no __syncthreads follows
  const int g = lane >> 2, tig = lane & 3;
  float* ks = warps + warp * L::kPerWarp;  // 2 stages of (kTile, SK) keys
  float* sc = ks + 2 * kTile * SK;         // (kTile) scores, then weights
  float* qs = sc + kTile;                  // (D) query
  float* qh = qs + D;                      // (H1) q @ w1q + b1
  // pool: lanes split over (timestep group, d)
  constexpr int DL = D < 32 ? D : 32, TG = 32 / DL, DPL = D / DL;
  const int dl = lane % DL, tg = lane / DL;

  for (int row = blockIdx.x * R + warp; row < B; row += gridDim.x * R) {
    const int len = min(max(lengths[row], 0), T);
    float* orow = out + (size_t)row * D;
    if (len == 0) {  // every weight is zero in both modes
      for (int d = lane; d < D; d += 32) orow[d] = 0.f;
      continue;
    }
    __syncwarp();  // the previous row is done with ks, sc, qs and qh
    // Only the valid keys are copied: rows past len of the last tile are
    // stale, but rows of a product are independent and are not read.
    const float* kg = keys + (size_t)row * T * D;
    auto copy_tile = [&](int mt) {
      float* dst = ks + (mt & 1) * kTile * SK;
      const int t0 = mt * kTile, n = min(kTile, len - t0);
      for (int i = lane; i < n * (D / 4); i += 32) {
        const int t = i / (D / 4), c = (i % (D / 4)) * 4;
        cp_async16(dst + t * SK + c, kg + (size_t)(t0 + t) * D + c);
      }
    };
    copy_tile(0);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    for (int d = lane; d < D; d += 32) qs[d] = q[(size_t)row * D + d];
    __syncwarp();
    for (int j = lane; j < kH1; j += 32) {
      float a = b1s[j];
#pragma unroll
      for (int d = 0; d < D; ++d) a = fmaf(qs[d], w1qs[d * kH1 + j], a);
      qh[j] = a;
    }

    float m = len < T ? kMaskNeg / sqrt_d : -INFINITY, sum = 0.f;
    double acc[DPL];
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[j] = 0.0;
    const int tiles = (len + kTile - 1) / kTile;
    for (int mt = 0; mt < tiles; ++mt) {
      if (mt + 1 < tiles) copy_tile(mt + 1);
      asm volatile("cp.async.commit_group;\n" ::: "memory");  // one group a tile
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // tile mt landed
      __syncwarp();
      const float* kt = ks + (mt & 1) * kTile * SK;
      const int nv = min(kTile, len - mt * kTile);
      const float* k0 = kt + g * SK;  // timestep rows g and g + 8
      const float* k1 = k0 + 8 * SK;
      // layer 1: (16 x 2D) [k | q*k] @ w1kp, 8 tiles of 8 outputs
      float h1[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) h1[nt][e] = 0.f;
#pragma unroll
      for (int s = 0; s < K1 / 8; ++s) {
        const int d = (s % (D / 8)) * 8 + tig;
        float a[4] = {k0[d], k1[d], k0[d + 4], k1[d + 4]};
        if (s >= D / 8) {  // the q*k half
          const float qa = qs[d], qb = qs[d + 4];
          a[0] *= qa; a[1] *= qa; a[2] *= qb; a[3] *= qb;
        }
        uint32_t ah[4], al[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(a[e], ah[e], al[e]);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const uint4 b = w1frag[(s * kH1 + nt * 8 + g) * 4 + tig];
          mma_3xtf32(h1[nt], ah, al, b);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float qa = qh[nt * 8 + 2 * tig], qb = qh[nt * 8 + 2 * tig + 1];
        h1[nt][0] = fmaxf(h1[nt][0] + qa, 0.f);
        h1[nt][1] = fmaxf(h1[nt][1] + qb, 0.f);
        h1[nt][2] = fmaxf(h1[nt][2] + qa, 0.f);
        h1[nt][3] = fmaxf(h1[nt][3] + qb, 0.f);
      }
      // layer 2: (16 x H1) h1 @ w2, k-step j from accumulator tile j
      float h2[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) h2[nt][e] = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t ah[4], al[4];
        split_tf32(h1[j][0], ah[0], al[0]);  // (row g,     k 2*tig)
        split_tf32(h1[j][2], ah[1], al[1]);  // (row g + 8, k 2*tig)
        split_tf32(h1[j][1], ah[2], al[2]);  // (row g,     k 2*tig + 1)
        split_tf32(h1[j][3], ah[3], al[3]);  // (row g + 8, k 2*tig + 1)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const uint4 b = w2frag[(j * kH2 + nt * 8 + g) * 4 + tig];
          mma_3xtf32(h2[nt], ah, al, b);
        }
      }
      // score: relu(h2 + b2) . w3 + b3, over the 4 lanes of a row
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int c = nt * 8 + 2 * tig;
        s0 = fmaf(fmaxf(h2[nt][0] + b2s[c], 0.f), w3s[c], s0);
        s0 = fmaf(fmaxf(h2[nt][1] + b2s[c + 1], 0.f), w3s[c + 1], s0);
        s1 = fmaf(fmaxf(h2[nt][2] + b2s[c], 0.f), w3s[c], s1);
        s1 = fmaf(fmaxf(h2[nt][3] + b2s[c + 1], 0.f), w3s[c + 1], s1);
      }
      s0 += __shfl_xor_sync(kFull, s0, 1);
      s0 += __shfl_xor_sync(kFull, s0, 2);
      s1 += __shfl_xor_sync(kFull, s1, 1);
      s1 += __shfl_xor_sync(kFull, s1, 2);
      if (tig == 0) {
        sc[g] = s0 + bias3;
        sc[g + 8] = s1 + bias3;
      }
      __syncwarp();

      // weights: the raw scores, or the online softmax's exp
      float scale = 1.f;
      if (use_softmax) {
        float w;
        scale = softmax_tile(lane < kTile ? sc[lane] : 0.f, lane, nv, sqrt_d, m, sum, w);
        __syncwarp();
        if (lane < nv) sc[lane] = w;
        __syncwarp();
      }
      float p[DPL];
#pragma unroll
      for (int j = 0; j < DPL; ++j) p[j] = 0.f;
      for (int t = tg; t < nv; t += TG) {
        const float w = sc[t];
#pragma unroll
        for (int j = 0; j < DPL; ++j) p[j] = fmaf(w, kt[t * SK + dl + j * DL], p[j]);
      }
#pragma unroll
      for (int j = 0; j < DPL; ++j) acc[j] = acc[j] * scale + p[j];
      __syncwarp();  // done with this stage and sc before they are refilled
    }
#pragma unroll
    for (int off = DL; off < 32; off <<= 1)
#pragma unroll
      for (int j = 0; j < DPL; ++j) acc[j] += __shfl_xor_sync(kFull, acc[j], off);
    const double denom = use_softmax ? fmaxf(sum, 1e-12f) : 1.0;
    if (tg == 0) {
#pragma unroll
      for (int j = 0; j < DPL; ++j) orow[dl + j * DL] = (float)(acc[j] / denom);
    }
  }
}

template <int D>
cudaError_t launch(const float* q, const float* keys, const int* lengths,
                   const float* w1, const float* b1, const float* w2,
                   const float* b2, const float* w3, const float* b3, float* out,
                   int B, int T, int use_softmax, int device, cudaStream_t stream) {
  using L = Layout<D>;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  int optin = 0, sms = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const size_t per_warp = sizeof(float) * L::kPerWarp;
  const size_t weights = sizeof(float) * L::kWeights;
  int R = kWarps;
  while (R > 1 && weights + R * per_warp > (size_t)optin) --R;
  // small B: fewer rows a block, so that every SM gets a block
  R = std::min(R, std::max(1, (B + sms - 1) / sms));
  const size_t smem = weights + R * per_warp;
  auto kernel = din_attention_fwd_kernel<D>;
  // Above 48 KB a block must opt in.
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kWarps * 32, smem);
  if (err != cudaSuccess) return err;
  const int groups = (B + R - 1) / R;
  const int grid = std::min(groups, std::max(1, per_sm) * sms);
  kernel<<<grid, kWarps * 32, smem, stream>>>(q, keys, lengths, w1, b1, w2, b2, w3, b3, out,
                                              B, T, R, use_softmax);
  return cudaGetLastError();
}

// The generic kernel: a block of kGenWarps warps owns a row at a time.
// Per tile of up to kTile valid timesteps: the keys are staged; layer 1
// ([k | q*k] @ w1kp, the same fold as above, plus q @ w1q + b1 once a
// row) has a thread own an output column for every timestep of the tile,
// reading each weight once a tile; layer 2 and the score have a thread
// own a column of h2 and add its share of each score, summed over the
// block; warp 0 runs the online softmax; the pool has a thread own a
// column d. Weights are read through L1/L2 (__ldg), not staged.
constexpr int kGenWarps = 4, kGenThreads = kGenWarps * 32;

__global__ void __launch_bounds__(kGenThreads)
din_attention_generic_kernel(const float* __restrict__ q, const float* __restrict__ keys,
                             const int* __restrict__ lengths, const float* __restrict__ w1,
                             const float* __restrict__ b1,
                             const float* __restrict__ w2, const float* __restrict__ b2,
                             const float* __restrict__ w3, const float* __restrict__ b3,
                             float* __restrict__ out, int B, int T, int D, int H1, int H2,
                             int tt, int use_softmax) {
  extern __shared__ __align__(16) float smem[];
  double* acc = reinterpret_cast<double*>(smem);  // (D) pooled sum
  float* ks = reinterpret_cast<float*>(acc + D);  // (tt, D) keys of the tile
  float* h1s = ks + tt * D;                       // (tt, H1) layer 1
  float* qs = h1s + tt * H1;                      // (D) query
  float* qh = qs + D;                             // (H1) q @ w1q + b1
  float* part = qh + H1;                          // (warps, kTile) score shares
  float* wt = part + kGenWarps * kTile;           // (kTile) weights of the tile
  float* stat = wt + kTile;                       // rescale factor, softmax sum
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float sqrt_d = sqrtf((float)D);
  const float bias3 = __ldg(b3);

  for (int row = blockIdx.x; row < B; row += gridDim.x) {
    const int len = min(max(lengths[row], 0), T);
    float* orow = out + (size_t)row * D;
    if (len == 0) {  // every weight is zero in both modes
      for (int d = tid; d < D; d += kGenThreads) orow[d] = 0.f;
      continue;
    }
    __syncthreads();  // the previous row is done with the buffers
    for (int d = tid; d < D; d += kGenThreads) {
      qs[d] = q[(size_t)row * D + d];
      acc[d] = 0.0;
    }
    __syncthreads();
    for (int j = tid; j < H1; j += kGenThreads) {
      float a = __ldg(b1 + j);
      for (int d = 0; d < D; ++d)
        a = fmaf(qs[d], __ldg(w1 + (size_t)d * H1 + j) + __ldg(w1 + (size_t)(2 * D + d) * H1 + j), a);
      qh[j] = a;
    }
    float m = len < T ? kMaskNeg / sqrt_d : -INFINITY, sum = 0.f;  // warp 0's
    const float* kg = keys + (size_t)row * T * D;
    for (int t0 = 0; t0 < len; t0 += tt) {
      const int nv = min(tt, len - t0);
      __syncthreads();  // the previous tile is done with ks, h1s and wt
      for (int i = tid; i < tt * D; i += kGenThreads)
        ks[i] = i < nv * D ? kg[(size_t)t0 * D + i] : 0.f;
      __syncthreads();
      for (int j = tid; j < H1; j += kGenThreads) {
        float a[kTile];
#pragma unroll
        for (int t = 0; t < kTile; ++t) a[t] = 0.f;
        for (int d = 0; d < D; ++d) {
          const float wk = __ldg(w1 + (size_t)(D + d) * H1 + j) - __ldg(w1 + (size_t)(2 * D + d) * H1 + j);
          const float wq = __ldg(w1 + (size_t)(3 * D + d) * H1 + j), qd = qs[d];
#pragma unroll
          for (int t = 0; t < kTile; ++t) {
            if (t < tt) {
              const float k = ks[t * D + d];
              a[t] = fmaf(qd * k, wq, fmaf(k, wk, a[t]));
            }
          }
        }
        const float base = qh[j];
#pragma unroll
        for (int t = 0; t < kTile; ++t)
          if (t < tt) h1s[t * H1 + j] = fmaxf(a[t] + base, 0.f);
      }
      __syncthreads();
      float s[kTile];
#pragma unroll
      for (int t = 0; t < kTile; ++t) s[t] = 0.f;
      for (int n = tid; n < H2; n += kGenThreads) {
        float a[kTile];
#pragma unroll
        for (int t = 0; t < kTile; ++t) a[t] = 0.f;
        for (int j = 0; j < H1; ++j) {
          const float w = __ldg(w2 + (size_t)j * H2 + n);
#pragma unroll
          for (int t = 0; t < kTile; ++t)
            if (t < tt) a[t] = fmaf(h1s[t * H1 + j], w, a[t]);
        }
        const float bn = __ldg(b2 + n), wn = __ldg(w3 + n);
#pragma unroll
        for (int t = 0; t < kTile; ++t) s[t] = fmaf(fmaxf(a[t] + bn, 0.f), wn, s[t]);
      }
#pragma unroll
      for (int t = 0; t < kTile; ++t) {
        const float v = warp_sum(s[t]);
        if (lane == 0) part[warp * kTile + t] = v;
      }
      __syncthreads();
      if (warp == 0) {
        float score = 0.f;
        if (lane < nv) {
          for (int w = 0; w < kGenWarps; ++w) score += part[w * kTile + lane];
          score += bias3;
        }
        float w = lane < nv ? score : 0.f, scale = 1.f;
        if (use_softmax) scale = softmax_tile(score, lane, nv, sqrt_d, m, sum, w);
        if (lane < kTile) wt[lane] = w;
        if (lane == 0) stat[0] = scale;
      }
      __syncthreads();
      const double scale = stat[0];
      for (int d = tid; d < D; d += kGenThreads) {
        float p = 0.f;
        for (int t = 0; t < nv; ++t) p = fmaf(wt[t], ks[t * D + d], p);
        acc[d] = acc[d] * scale + p;
      }
    }
    if (tid == 0) stat[1] = sum;
    __syncthreads();
    const double denom = use_softmax ? fmaxf(stat[1], 1e-12f) : 1.0;
    for (int d = tid; d < D; d += kGenThreads) orow[d] = (float)(acc[d] / denom);
  }
}

// Shared memory of the generic kernel at tt timesteps a tile, in bytes.
size_t generic_smem(int D, int H1, int tt) {
  return sizeof(double) * D +
         sizeof(float) * ((size_t)tt * (D + H1) + D + H1 + kGenWarps * kTile + kTile + 2);
}

}  // namespace

// q (B, D), keys (B, T, D), lengths (B,) int32, w1 (4D, H1), b1 (H1),
// w2 (H1, H2), b2 (H2), w3 (H2), b3 (1), out (B, D); f32 unless said,
// contiguous, on `device`. Launches on `stream`; returns a cudaError_t.
//
// din_attention_fwd: the tensor-core kernel; keys 16-byte aligned, D in
// {8, 16, 32, 64}, H1 = 64, H2 = 32, any T >= 0.
extern "C" int din_attention_fwd(const float* q, const float* keys,
                                 const int* lengths, const float* w1,
                                 const float* b1, const float* w2,
                                 const float* b2, const float* w3,
                                 const float* b3, float* out, int B, int T,
                                 int D, int H1, int H2, int use_softmax,
                                 int device, void* stream) {
  if (B < 1 || T < 0 || H1 != kH1 || H2 != kH2) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)keys & 15) != 0) return (int)cudaErrorMisalignedAddress;
  auto s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 8:
      return (int)launch<8>(q, keys, lengths, w1, b1, w2, b2, w3, b3, out, B, T,
                            use_softmax, device, s);
    case 16:
      return (int)launch<16>(q, keys, lengths, w1, b1, w2, b2, w3, b3, out, B, T,
                             use_softmax, device, s);
    case 32:
      return (int)launch<32>(q, keys, lengths, w1, b1, w2, b2, w3, b3, out, B, T,
                             use_softmax, device, s);
    case 64:
      return (int)launch<64>(q, keys, lengths, w1, b1, w2, b2, w3, b3, out, B, T,
                             use_softmax, device, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// din_attention_generic_fwd: the CUDA-core kernel; any D, H1, H2 >= 1 and
// T >= 0. A tile holds up to 16 timesteps, fewer where (D + H1) is so
// wide that 16 do not fit in shared memory; it refuses (D + H1) too wide
// for even one (about 19,000 floats on an H100).
extern "C" int din_attention_generic_fwd(const float* q, const float* keys,
                                         const int* lengths, const float* w1,
                                         const float* b1, const float* w2,
                                         const float* b2, const float* w3,
                                         const float* b3, float* out, int B, int T,
                                         int D, int H1, int H2, int use_softmax,
                                         int device, void* stream) {
  if (B < 1 || T < 0 || D < 1 || H1 < 1 || H2 < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int optin = 0, sms = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  int tt = kTile;
  while (tt > 1 && generic_smem(D, H1, tt) > (size_t)optin) --tt;
  const size_t smem = generic_smem(D, H1, tt);
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  auto kernel = din_attention_generic_kernel;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kGenThreads, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = std::min(B, std::max(1, per_sm) * sms);
  kernel<<<grid, kGenThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      q, keys, lengths, w1, b1, w2, b2, w3, b3, out, B, T, D, H1, H2, tt, use_softmax);
  return (int)cudaGetLastError();
}

extern "C" const char* din_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
