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
// shape, each with its own launch count, both on the tensor cores:
//   * din_attention_fwd_kernel<D>, for D in {8, 16, 32, 64} and hidden
//     widths (64, 32), the widths DINAttention is built with (the main
//     path's D = 16 among them), and any T;
//   * din_attention_generic_kernel<Store, Staged>, for every other
//     D >= 1 and hidden widths (H1, H2) >= 1, and any T: the same design
//     with the widths zero-padded to the tensor cores' tiles, layer 1 in
//     chunks of h1 columns, and the weights staged where they fit (its
//     comment below).
// Both stream a row's valid keys through a 2-stage cp.async ring a warp
// in tiles of 16 timesteps, so T is not bounded by shared memory. Under
// use_softmax they keep an online max and sum and rescale the pooled sum
// at each tile; the pooled sum is kept in f64 across tiles, so that a
// long row's sum is not the error's source.
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

#include <algorithm>
#include <math.h>

#include "common.cuh"

namespace {

constexpr float kMaskNeg = -4294967295.0f;  // -(2**32)+1, as f32
constexpr int kH1 = 64, kH2 = 32;
constexpr int kWarps = 8;  // a block: all stage the weights, R <= 8 take rows
constexpr unsigned kFull = 0xffffffffu;

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

// mma_tf32 where `on` (the same in every lane) holds, else nothing. The
// product is predicated rather than branched around, so that the n-tiles
// of a width known only at run time stay in one basic block: behind a
// branch, one tile's chain of three dependent products cannot overlap the
// next tile's.
__device__ __forceinline__ void mma_tf32_if(float (&d)[4], const uint32_t (&a)[4],
                                            uint32_t b0, uint32_t b1, bool on) {
  asm("{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %10, 0;\n\t"
      "@p mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "r"((int)on));
}

// mma_3xtf32 for four n-tiles, d<i> += a * b[i] for the tiles i < n_on
// (the rest unchanged): the same three products a tile in the same order,
// each tile's into a zeroed fragment added to d<i> in f32, but issued a
// round of four tiles at a time, so that the four tiles' dependent chains
// of three products overlap rather than follow each other.
__device__ __forceinline__ void mma_3xtf32_x4(float (&d0)[4], float (&d1)[4], float (&d2)[4],
                                              float (&d3)[4], const uint32_t (&ah)[4],
                                              const uint32_t (&al)[4], const uint4 (&b)[4],
                                              int n_on) {
  float t[4][4] = {};
#pragma unroll
  for (int i = 0; i < 4; ++i) mma_tf32_if(t[i], al, b[i].x, b[i].y, i < n_on);
#pragma unroll
  for (int i = 0; i < 4; ++i) mma_tf32_if(t[i], ah, b[i].z, b[i].w, i < n_on);
#pragma unroll
  for (int i = 0; i < 4; ++i) mma_tf32_if(t[i], ah, b[i].x, b[i].y, i < n_on);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    d0[e] += t[0][e];
    d1[e] += t[1][e];
    d2[e] += t[2][e];
    d3[e] += t[3][e];
  }
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
  DeviceLimits lim;
  cudaError_t err = use_device(device, lim);
  if (err != cudaSuccess) return err;
  const int sms = lim.sms;
  const size_t per_warp = sizeof(float) * L::kPerWarp;
  const size_t weights = sizeof(float) * L::kWeights;
  int R = kWarps;
  while (R > 1 && weights + R * per_warp > (size_t)lim.smem_optin) --R;
  // small B: fewer rows a block, so that every SM gets a block
  R = std::min(R, std::max(1, (B + sms - 1) / sms));
  const size_t smem = weights + R * per_warp;
  auto kernel = din_attention_fwd_kernel<D>;
  err = allow_smem(kernel, device, smem);
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

// The generic kernel: the tensor-core kernel's design at any D and hidden
// widths (H1, H2), with the widths it has no instantiation for padded to
// what the tensor cores take, exactly. It replaces the same TPU kernel and
// is bound the same way, by operations: the folded first layer (4*D*H1
// FLOP a valid timestep) and the second (2*H1*H2); at D = 128, B = 1024,
// T = 50 about 0.006 ms through the tensor cores. With one warp a row it
// stays far from that, bound by the latency of a row's tiles (chip_smoke.py
// times it beside its bounds). Per batch row, as above:
//   * D is padded to DP (a multiple of 4), so that the folded depth
//     K1 = 2*DP is a multiple of 8, and H1, H2 to multiples of 8 (H1P,
//     H2P). The padded rows and columns of w1kp, w1q and w2 and the padded
//     entries of b1, b2 and w3 are zero, and so are the padded key and
//     query columns: a padded h1 column is relu(0) = 0 and a padded h2
//     column scores relu(0) * 0 = 0, so the padding changes no sum. The
//     kernel pads as it stages, so the wrapper makes no padded copies;
//   * a k-step of layer 1 may straddle the [k | q*k] seam (DP = 4 mod 8):
//     each of a lane's two A columns picks its half on its own;
//   * layer 1 runs in chunks of 64 h1 columns (8 n-tiles); each chunk's
//     ReLU'd accumulators are the A operand of the layer-2 k-steps for the
//     same 64 rows of w2 (the accumulator-as-A permutation above), so
//     only h2 (16 x 64 columns) is held across chunks. Past 64 h2 columns
//     layer 2 runs in passes of 64, each summing its share of the score,
//     layer 1 recomputed a pass: registers are bounded at any width;
//   * the weights are folded, padded and staged once a block where they
//     fit (kWFrag: TF32 hi/lo fragments as above; kWF32: the same order in
//     f32, split at load, half the bytes), each thread reading in batches
//     of 8 entries, and read through L1/L2 and folded at load where they
//     do not (kWGlobal);
//   * a warp owns a row at a time: the valid keys stream through a cp.async
//     ring of 16-step tiles, 2 stages (the next tile in flight while one
//     is scored) or 1 (copied after it), with 16-byte copies where D*4
//     bytes and the base allow it, else 4-byte, and padded columns
//     zero-filled once; where not even a 1-stage ring fits (DP past about
//     3,000), the keys are read through L1/L2. The launcher takes the first
//     of (fragments, 2), (f32, 2), (fragments, 1), (f32, 1), (L1/L2, 2),
//     (L1/L2, 1) that fits the warps B needs (up to 8 an SM), else the one
//     that fits most: at D = 128, B = 1024 that is f32 weights and one
//     stage, 8 warps, against 6 with two stages;
//   * layer 1's and layer 2's n-tiles go in groups of four, each group's
//     twelve products issued tile by tile a round (mma_3xtf32_x4), the
//     tiles past a width predicated off;
//   * the online softmax runs over the warp by shuffles, the pooled sum of
//     the real D columns is kept in f64 in shared memory across tiles, the
//     lanes split over (timestep group, column) where D < 32. No block
//     barrier follows the staging.
constexpr int kGenWarps = 8;  // a block: all stage the weights, R <= 8 take rows
constexpr int kChunk = 64;  // h1 columns a layer-1 chunk, h2 columns a layer-2 pass
enum WeightStore { kWFrag = 0, kWF32 = 1, kWGlobal = 2 };

struct GenDims {
  int D, DP, H1, H1P, H2, H2P, K1, SK;
};

GenDims gen_dims(int D, int H1, int H2) {
  GenDims g;
  g.D = D;
  g.DP = (D + 3) / 4 * 4;
  g.H1 = H1;
  g.H1P = (H1 + 7) / 8 * 8;
  g.H2 = H2;
  g.H2P = (H2 + 7) / 8 * 8;
  g.K1 = 2 * g.DP;
  // key rows of stride SK, SK/4 odd: a fragment reads (rows g, column
  // tig) fall in banks SK*g + tig, all 32 distinct
  g.SK = (g.DP / 4) % 2 ? g.DP : g.DP + 4;
  return g;
}

// Shared memory of the staged weights, in 4-byte words: w1kp's and w2's b
// fragments (4 words a lane and k-step for kWFrag, 2 for kWF32), w1q
// (DP, H1P), b1 (H1P), b2 and w3 (H2P).
__host__ __device__ inline size_t gen_weight_words(int store, const GenDims& g) {
  if (store == kWGlobal) return 0;
  const size_t b_words = (size_t)g.K1 * g.H1P + (size_t)g.H1P * g.H2P;
  return (store == kWFrag ? 2 : 1) * b_words + (size_t)g.DP * g.H1P + g.H1P + 2 * (size_t)g.H2P;
}

// A warp's shared memory, in words: the pooled sum (DP doubles), the key
// ring (`stages` stages of (kTile, SK): 2, 1, or 0 where the keys are read
// through L1/L2), scores (kTile), q (DP) and q @ w1q + b1 (H1P). Each part
// is a multiple of 4 words (16 bytes).
__host__ __device__ inline size_t gen_warp_words(int stages, const GenDims& g) {
  return 2 * (size_t)g.DP + stages * (size_t)kTile * g.SK + kTile + g.DP + g.H1P;
}

template <int Store, bool Staged>
__global__ void __launch_bounds__(kGenWarps * 32)
din_attention_generic_kernel(const float* __restrict__ q, const float* __restrict__ keys,
                             const int* __restrict__ lengths, const float* __restrict__ w1,
                             const float* __restrict__ b1,
                             const float* __restrict__ w2, const float* __restrict__ b2,
                             const float* __restrict__ w3, const float* __restrict__ b3,
                             float* __restrict__ out, int B, int T, GenDims dm, int R,
                             int stages, int use_softmax, int vec16) {
  const int D = dm.D, DP = dm.DP, H1 = dm.H1, H1P = dm.H1P, H2 = dm.H2, H2P = dm.H2P;
  const int SK = dm.SK, ksteps = dm.K1 / 8;
  constexpr int kB = Store == kWFrag ? 4 : 2;  // words of a lane's b fragment
  extern __shared__ __align__(16) float smem[];
  float* w1s = smem;                           // (K1/8, H1P, 4) b fragments of w1kp
  float* w2s = w1s + (size_t)kB * 4 * ksteps * H1P;  // (H1P/8, H2P, 4) of w2
  float* w1qs = w2s + (size_t)kB * H1P / 2 * H2P;    // (DP, H1P)
  float* b1s = w1qs + (size_t)DP * H1P;
  float* b2s = b1s + H1P;
  float* w3s = b2s + H2P;

  // The folded, zero-padded operands: row k of w1kp is w1b[k] - w1c[k]
  // for k < D, w1d[k - DP] for DP <= k < DP + D, else 0. The reads are
  // unconditional (a padded entry reads entry 0 and is then zeroed), so
  // that an unrolled staging loop keeps all its loads in flight.
  auto w1kp_at = [&](int k, int n) -> float {
    const bool top = k < DP;
    const int r = top ? k : k - DP;
    const bool ok = r < D && n < H1;
    const size_t rc = ok ? r : 0, nc = ok ? n : 0;
    const float x = __ldg(w1 + ((top ? D : 3 * D) + rc) * H1 + nc);
    const float y = __ldg(w1 + (2 * D + rc) * H1 + nc);
    return ok ? (top ? x - y : x) : 0.f;
  };
  auto w1q_at = [&](int d, int n) -> float {
    const bool ok = d < D && n < H1;
    const size_t dc = ok ? d : 0, nc = ok ? n : 0;
    const float x = __ldg(w1 + dc * H1 + nc), y = __ldg(w1 + (2 * D + dc) * H1 + nc);
    return ok ? x + y : 0.f;
  };
  auto w2_at = [&](int r, int n) -> float {
    const bool ok = r < H1 && n < H2;
    const float x = __ldg(w2 + (ok ? (size_t)r * H2 + n : 0));
    return ok ? x : 0.f;
  };
  // The b fragment of layer-1 k-step s, column n: rows 8s + tig and
  // 8s + tig + 4 of w1kp; of layer-2 k-step j: rows 8j + 2*tig and
  // 8j + 2*tig + 1 of w2 (the permuted k of the accumulator-as-A).
  auto load_b = [&](const float* base, int idx) -> uint4 {
    if constexpr (Store == kWFrag) {
      return reinterpret_cast<const uint4*>(base)[idx];
    } else {
      const float2 v = reinterpret_cast<const float2*>(base)[idx];
      return b_fragment(v.x, v.y);
    }
  };
  auto w1_b = [&](int s, int n, int tig) -> uint4 {
    if constexpr (Store == kWGlobal)
      return b_fragment(w1kp_at(8 * s + tig, n), w1kp_at(8 * s + tig + 4, n));
    else
      return load_b(w1s, (s * H1P + n) * 4 + tig);
  };
  auto w2_b = [&](int j, int n, int tig) -> uint4 {
    if constexpr (Store == kWGlobal)
      return b_fragment(w2_at(8 * j + 2 * tig, n), w2_at(8 * j + 2 * tig + 1, n));
    else
      return load_b(w2s, (j * H2P + n) * 4 + tig);
  };

  const int tid = threadIdx.x, nthreads = blockDim.x;
  if constexpr (Store != kWGlobal) {
    // in batches of kStage entries a thread, every read of a batch issued
    // before its first store, so that each thread keeps 16 to 32 reads of
    // L2 in flight: entry by entry, the reads of a block's 100 KB of
    // weights at D = 128 followed each other
    constexpr int kStage = 8;
    auto stage = [&](int count, auto&& read, auto&& write) {
      for (int i0 = tid; i0 < count; i0 += kStage * nthreads) {
        float2 v[kStage];
#pragma unroll
        for (int u = 0; u < kStage; ++u) v[u] = read(min(i0 + u * nthreads, count - 1));
#pragma unroll
        for (int u = 0; u < kStage; ++u)
          if (i0 + u * nthreads < count) write(i0 + u * nthreads, v[u]);
      }
    };
    auto write_b = [&](float* base, int i, float2 v) {
      if constexpr (Store == kWFrag)
        reinterpret_cast<uint4*>(base)[i] = b_fragment(v.x, v.y);
      else
        reinterpret_cast<float2*>(base)[i] = v;
    };
    stage(
        ksteps * H1P * 4,
        [&](int i) {
          const int t = i & 3, n = (i >> 2) % H1P, s = (i >> 2) / H1P;
          return make_float2(w1kp_at(8 * s + t, n), w1kp_at(8 * s + t + 4, n));
        },
        [&](int i, float2 v) { write_b(w1s, i, v); });
    stage(
        H1P / 8 * H2P * 4,
        [&](int i) {
          const int t = i & 3, n = (i >> 2) % H2P, j = (i >> 2) / H2P;
          return make_float2(w2_at(8 * j + 2 * t, n), w2_at(8 * j + 2 * t + 1, n));
        },
        [&](int i, float2 v) { write_b(w2s, i, v); });
    stage(
        DP * H1P, [&](int i) { return make_float2(w1q_at(i / H1P, i % H1P), 0.f); },
        [&](int i, float2 v) { w1qs[i] = v.x; });
    for (int i = tid; i < H1P; i += nthreads) b1s[i] = i < H1 ? b1[i] : 0.f;
    for (int i = tid; i < H2P; i += nthreads) {
      b2s[i] = i < H2 ? b2[i] : 0.f;
      w3s[i] = i < H2 ? w3[i] : 0.f;
    }
  }
  const float bias3 = b3[0];
  const float sqrt_d = sqrtf((float)D);
  __syncthreads();

  const int lane = tid & 31, warp = tid >> 5;
  if (warp >= R) return;  // no __syncthreads follows
  const int g = lane >> 2, tig = lane & 3;
  double* acc = reinterpret_cast<double*>(smem + gen_weight_words(Store, dm) +
                                          warp * gen_warp_words(stages, dm));  // (DP)
  float* ks = reinterpret_cast<float*>(acc + DP);  // `stages` of (kTile, SK) keys
  float* sc = ks + stages * kTile * SK;            // (kTile) scores, then weights
  float* qs = sc + kTile;                          // (DP) query, zero past D
  float* qh = qs + DP;                             // (H1P) q @ w1q + b1
  if (Staged) {  // the padded key columns; the copies never write them
    for (int i = lane; i < stages * kTile * (DP - D); i += 32)
      ks[(i / (DP - D)) * SK + D + i % (DP - D)] = 0.f;
  }
  // pool: lanes split over (timestep group, column): pw lanes a group
  int pw = 1;
  while (pw < D && pw < 32) pw <<= 1;
  const int ng = 32 / pw, tg = lane / pw, dl = lane % pw;

  for (int row = blockIdx.x * R + warp; row < B; row += gridDim.x * R) {
    const int len = min(max(lengths[row], 0), T);
    float* orow = out + (size_t)row * D;
    if (len == 0) {  // every weight is zero in both modes
      for (int d = lane; d < D; d += 32) orow[d] = 0.f;
      continue;
    }
    __syncwarp();  // the previous row is done with ks, sc, qs, qh and acc
    const float* kg = keys + (size_t)row * T * D;
    // Only the valid keys are copied: rows past len of the last tile are
    // stale, but rows of a product are independent and are not read.
    auto copy_tile = [&](int mt) {
      float* dst = ks + (stages == 2 ? mt & 1 : 0) * kTile * SK;
      const int t0 = mt * kTile, n = min(kTile, len - t0);
      const float* src = kg + (size_t)t0 * D;
      if (vec16) {
        const int per = D / 4;
        for (int i = lane; i < n * per; i += 32) {
          const int t = i / per, c = (i % per) * 4;
          cp_async16(dst + t * SK + c, src + (size_t)t * D + c);
        }
      } else {
        for (int i = lane; i < n * D; i += 32) cp_async4(dst + (i / D) * SK + i % D, src + i);
      }
    };
    if (Staged) {
      copy_tile(0);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
    for (int d = lane; d < DP; d += 32) qs[d] = d < D ? q[(size_t)row * D + d] : 0.f;
    for (int d = lane; d < D; d += 32) acc[d] = 0.0;
    __syncwarp();
    for (int j = lane; j < H1P; j += 32) {  // four partial sums over DP
      float a[4] = {0.f, 0.f, 0.f, 0.f};
      for (int d = 0; d < DP; d += 4) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if constexpr (Store == kWGlobal)
            a[e] = fmaf(qs[d + e], w1q_at(d + e, j), a[e]);
          else
            a[e] = fmaf(qs[d + e], w1qs[(d + e) * H1P + j], a[e]);
        }
      }
      float bias;
      if constexpr (Store == kWGlobal)
        bias = j < H1 ? b1[j] : 0.f;
      else
        bias = b1s[j];
      qh[j] = bias + ((a[0] + a[1]) + (a[2] + a[3]));
    }

    float m = len < T ? kMaskNeg / sqrt_d : -INFINITY, sum = 0.f;
    const int tiles = (len + kTile - 1) / kTile;
    for (int mt = 0; mt < tiles; ++mt) {
      const int nv = min(kTile, len - mt * kTile);
      const float* kt;
      if (Staged) {
        if (stages == 2) {  // tile mt + 1 in flight while mt is scored
          if (mt + 1 < tiles) copy_tile(mt + 1);
          asm volatile("cp.async.commit_group;\n" ::: "memory");  // one group a tile
          asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // tile mt landed
        } else {  // tile mt was copied at the end of tile mt - 1
          asm volatile("cp.async.wait_group 0;\n" ::: "memory");
        }
        kt = ks + (stages == 2 ? mt & 1 : 0) * kTile * SK;
      } else {
        kt = kg + (size_t)mt * kTile * D;
      }
      __syncwarp();
      // key r (< kTile) of the tile, column d (< DP); zero past D
      auto key = [&](int r, int d) -> float {
        if constexpr (Staged) return kt[r * SK + d];
        else return d < D ? __ldg(kt + (size_t)min(r, nv - 1) * D + d) : 0.f;
      };

      float s0 = 0.f, s1 = 0.f;  // the score's share of this lane's h2 columns
      for (int c2 = 0; c2 < H2P; c2 += kChunk) {
        const int n2t = min(kChunk, H2P - c2) / 8;
        float h2[8][4];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) h2[nt][e] = 0.f;
        for (int c1 = 0; c1 < H1P; c1 += kChunk) {
          const int n1t = min(kChunk, H1P - c1) / 8;
          // layer 1: (16 x K1) [k | q*k] @ w1kp[:, c1 : c1 + 64]
          float h1[8][4];
#pragma unroll
          for (int nt = 0; nt < 8; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) h1[nt][e] = 0.f;
          for (int s = 0; s < ksteps; ++s) {
            const int ca = 8 * s + tig, cb = ca + 4;  // the lane's two A columns
            const bool qa = ca >= DP, qb = cb >= DP;  // in the q*k half
            const int da = qa ? ca - DP : ca, db = qb ? cb - DP : cb;
            float a[4] = {key(g, da), key(g + 8, da), key(g, db), key(g + 8, db)};
            if (qa) {
              a[0] *= qs[da];
              a[1] *= qs[da];
            }
            if (qb) {
              a[2] *= qs[db];
              a[3] *= qs[db];
            }
            uint32_t ah[4], al[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) split_tf32(a[e], ah[e], al[e]);
#pragma unroll
            for (int grp = 0; grp < 2; ++grp) {  // n-tiles 4*grp .. 4*grp + 3
              if (grp == 1 && n1t <= 4) break;
              uint4 b[4];
#pragma unroll
              for (int i = 0; i < 4; ++i) {  // past the chunk: a column of it
                const int nt = 4 * grp + i;
                b[i] = w1_b(s, c1 + (nt < n1t ? nt : 0) * 8 + g, tig);
              }
              mma_3xtf32_x4(h1[4 * grp], h1[4 * grp + 1], h1[4 * grp + 2], h1[4 * grp + 3], ah,
                            al, b, n1t - 4 * grp);
            }
          }
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            if (nt < n1t) {
              const int c = c1 + nt * 8 + 2 * tig;
              const float qa = qh[c], qb = qh[c + 1];
              h1[nt][0] = fmaxf(h1[nt][0] + qa, 0.f);
              h1[nt][1] = fmaxf(h1[nt][1] + qb, 0.f);
              h1[nt][2] = fmaxf(h1[nt][2] + qa, 0.f);
              h1[nt][3] = fmaxf(h1[nt][3] + qb, 0.f);
            }
          }
          // layer 2: h1[:, c1 : c1 + 64] @ w2[c1 : c1 + 64, c2 : c2 + 64],
          // k-step j from accumulator tile j
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            if (j == 4 && n1t <= 4) break;
            uint32_t ah[4], al[4];
            split_tf32(h1[j][0], ah[0], al[0]);  // (row g,     k 2*tig)
            split_tf32(h1[j][2], ah[1], al[1]);  // (row g + 8, k 2*tig)
            split_tf32(h1[j][1], ah[2], al[2]);  // (row g,     k 2*tig + 1)
            split_tf32(h1[j][3], ah[3], al[3]);  // (row g + 8, k 2*tig + 1)
            const bool on = j < n1t;
            const int ks2 = c1 / 8 + (on ? j : 0);
#pragma unroll
            for (int grp = 0; grp < 2; ++grp) {  // h2 n-tiles 4*grp .. 4*grp + 3
              if (grp == 1 && n2t <= 4) break;
              uint4 b[4];
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const int nt = 4 * grp + i;
                b[i] = w2_b(ks2, c2 + (nt < n2t ? nt : 0) * 8 + g, tig);
              }
              mma_3xtf32_x4(h2[4 * grp], h2[4 * grp + 1], h2[4 * grp + 2], h2[4 * grp + 3], ah,
                            al, b, on ? n2t - 4 * grp : 0);
            }
          }
        }
        // the score's share: relu(h2 + b2) . w3 over this pass's columns
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          if (nt < n2t) {
            const int c = c2 + nt * 8 + 2 * tig;
            float ba, bb, wa, wb;
            if constexpr (Store == kWGlobal) {
              ba = c < H2 ? b2[c] : 0.f;
              bb = c + 1 < H2 ? b2[c + 1] : 0.f;
              wa = c < H2 ? w3[c] : 0.f;
              wb = c + 1 < H2 ? w3[c + 1] : 0.f;
            } else {
              ba = b2s[c], bb = b2s[c + 1], wa = w3s[c], wb = w3s[c + 1];
            }
            s0 = fmaf(fmaxf(h2[nt][0] + ba, 0.f), wa, s0);
            s0 = fmaf(fmaxf(h2[nt][1] + bb, 0.f), wb, s0);
            s1 = fmaf(fmaxf(h2[nt][2] + ba, 0.f), wa, s1);
            s1 = fmaf(fmaxf(h2[nt][3] + bb, 0.f), wb, s1);
          }
        }
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
      for (int d0 = 0; d0 < D; d0 += pw) {
        const int d = d0 + dl;
        float p = 0.f;
        if (d < D) {
#pragma unroll 4
          for (int t = tg; t < nv; t += ng) p = fmaf(sc[t], key(t, d), p);
        }
        for (int off = pw; off < 32; off <<= 1) p += __shfl_xor_sync(kFull, p, off);
        if (tg == 0 && d < D) acc[d] = acc[d] * scale + p;
      }
      __syncwarp();  // done with this stage and sc before they are refilled
      if (Staged && stages == 1 && mt + 1 < tiles) {
        copy_tile(mt + 1);
        asm volatile("cp.async.commit_group;\n" ::: "memory");
      }
    }
    const double denom = use_softmax ? fmaxf(sum, 1e-12f) : 1.0;
    for (int d = lane; d < D; d += 32) orow[d] = (float)(acc[d] / denom);
  }
}

template <int Store, bool Staged>
cudaError_t launch_generic(const float* q, const float* keys, const int* lengths,
                           const float* w1, const float* b1, const float* w2,
                           const float* b2, const float* w3, const float* b3, float* out,
                           int B, int T, const GenDims& dm, int R, int stages,
                           int use_softmax, int vec16,
                           int sms, int device, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (gen_weight_words(Store, dm) + R * gen_warp_words(stages, dm));
  auto kernel = din_attention_generic_kernel<Store, Staged>;
  cudaError_t err = allow_smem(kernel, device, smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kGenWarps * 32, smem);
  if (err != cudaSuccess) return err;
  const int groups = (B + R - 1) / R;
  const int grid = std::min(groups, std::max(1, per_sm) * sms);
  kernel<<<grid, kGenWarps * 32, smem, stream>>>(q, keys, lengths, w1, b1, w2, b2, w3, b3, out,
                                                 B, T, dm, R, stages, use_softmax, vec16);
  return cudaGetLastError();
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
  auto run = D == 8 ? launch<8> : D == 16 ? launch<16> : D == 32 ? launch<32>
             : D == 64 ? launch<64> : nullptr;
  if (run == nullptr) return (int)cudaErrorInvalidValue;
  return (int)run(q, keys, lengths, w1, b1, w2, b2, w3, b3, out, B, T, use_softmax, device,
                  static_cast<cudaStream_t>(stream));
}

// din_attention_generic_fwd: the generic kernel; any D, H1, H2 >= 1 and
// T >= 0 (keys at any 4-byte alignment). The weights are staged as TF32
// fragments, else as f32, else read through L1/L2, whichever first leaves
// room for min(4, rows an SM) warps of keys, else for the most; where not
// one warp's key ring fits, the keys are read through L1/L2 too. Refuses
// only D + H1 so wide that one warp's q, q @ w1q and pooled sum do not
// fit (about 19,000 floats on an H100).
extern "C" int din_attention_generic_fwd(const float* q, const float* keys,
                                         const int* lengths, const float* w1,
                                         const float* b1, const float* w2,
                                         const float* b2, const float* w3,
                                         const float* b3, float* out, int B, int T,
                                         int D, int H1, int H2, int use_softmax,
                                         int device, void* stream) {
  if (B < 1 || T < 0 || D < 1 || H1 < 1 || H2 < 1) return (int)cudaErrorInvalidValue;
  DeviceLimits lim;
  const cudaError_t err = use_device(device, lim);
  if (err != cudaSuccess) return (int)err;
  const int sms = lim.sms, optin = lim.smem_optin;
  const GenDims dm = gen_dims(D, H1, H2);
  // rows an SM at most kGenWarps: at small B a block takes fewer rows, so
  // that every SM gets one
  const int needed = std::min(kGenWarps, std::max(1, (B + sms - 1) / sms));
  auto warps_that_fit = [&](int store, int stages) {
    const size_t weights = sizeof(float) * gen_weight_words(store, dm);
    const size_t per_warp = sizeof(float) * gen_warp_words(stages, dm);
    if (weights + per_warp > (size_t)optin) return 0;
    return (int)std::min<size_t>(needed, ((size_t)optin - weights) / per_warp);
  };
  // (weights, key stages) in order of preference; the first that holds
  // `needed` warps, else the one that holds the most
  const int choices[][2] = {{kWFrag, 2}, {kWF32, 2}, {kWFrag, 1}, {kWF32, 1},
                            {kWGlobal, 2}, {kWGlobal, 1}, {kWGlobal, 0}};
  int store = kWGlobal, stages = 0, R = 0;
  for (const auto& c : choices) {
    const int r = warps_that_fit(c[0], c[1]);
    if (r > R) store = c[0], stages = c[1], R = r;
    if (r >= needed) break;
  }
  if (R == 0) return (int)cudaErrorInvalidValue;
  const int vec16 = D % 4 == 0 && ((uintptr_t)keys & 15) == 0;
  auto run = stages == 0 ? launch_generic<kWGlobal, false>
             : store == kWFrag ? launch_generic<kWFrag, true>
             : store == kWF32 ? launch_generic<kWF32, true> : launch_generic<kWGlobal, true>;
  return (int)run(q, keys, lengths, w1, b1, w2, b2, w3, b3, out, B, T, dm, R, stages, use_softmax,
                  vec16, sms, device, static_cast<cudaStream_t>(stream));
}
