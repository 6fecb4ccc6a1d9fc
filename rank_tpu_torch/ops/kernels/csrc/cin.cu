// One CIN (Compressed Interaction Network) layer forward for Hopper
// (sm_90a), f32-accurate on the tensor cores (3xTF32), in the transposed
// (B, D, .) layout.
//
// Replaces the Pallas TPU kernel rank_tpu/ops/pallas/cin.py
// (cin_layer_fused_t -> _forward_t -> _kernel). With m = (b, d) a row of
// the (B*D, .) views of the inputs:
//   out[m, o] = sum_{f, h} xk[m, h] * x0[m, f] * w[o, h, f]
// which is one GEMM of M = B*D rows, N = O and K = F*Hp, with K ordered
// (f, h) and H padded to Hp, a multiple of 8:
//   A[m, f*Hp + h] = xk[m, h] * x0[m, f]    (zero for h >= H)
//   B[f*Hp + h, o] = w[o, h, f]             (zero for h >= H, o >= O)
// The kernel never writes A to device memory: each thread forms its A
// fragments in registers from the xk and x0 rows its block staged. B is
// built by the wrapper (ops/kernels/cin.py: weight_operand), zero-padded to
// Op, O rounded up to 4, so that its rows are 16-byte copies.
//
// What bounds it on an H100 (700 W). Layer 1 of the default xDeepFM (H = 64,
// F = 7, O = 128, D = 16 rows a sample) at B = 8192: M = 131,072.
//   * f32 outside the tensor cores (67 TFLOP/s), counting the least work,
//     the factored form 2*M*F*O*(H + 1) = 15.3 GFLOP: 0.228 ms;
//   * tensor cores (495 TFLOP/s TF32): 3 x the products' 2*M*O*H*F = 45.1
//     GFLOP, plus M*H*F multiplies to form A at 67 TFLOP/s: 0.092 ms;
//   * bytes: M*(H + F + O)*4 + the weights = 104 MB at 3.35 TB/s: 0.031 ms.
// Both bounds are set by operations. Layer 0 (H = F = 7) is 8x lighter.
//
// Why 3xTF32. The JAX kernel multiplies in f32, and the port holds this
// kernel to its plain f32 version at rtol = atol = 1e-5. TF32 keeps 10
// mantissa bits. A numpy emulation of layer 1 at full width (B = 64,
// outputs up to 1.3; tests/test_torch_tensor_core_operands.py) puts one
// TF32 product off by 4.5e-4 against f64, 45 times the bar. Splitting each
// operand into hi = tf32(x) and lo = x - hi and summing lo*hi + hi*lo +
// hi*hi with f32 sums is off by 6.1e-7, as close as an f32 GEMM of the
// same operands (5.9e-7). So every k-step runs three mma.sync m16n8k8
// TF32 products. The dropped lo*lo term is below 2^-21 of a product.
//
// Where the sums are taken matters as much. The tensor core adds a
// product into its accumulator with truncation, not rounding, so summing
// all 3*K/8 products of a row into one accumulator left errors several
// times an f32 GEMM's on the card. Here each k-step's three products go
// into a zeroed fragment, whose sum spans 8 terms, and that is added to
// the accumulator on the CUDA cores in f32. The errors against an f64
// reference are then below cuBLAS's f32 GEMM's (chip_smoke.py prints
// both), at the cost of four f32 adds a tile and a k-step.
//
// Measured on the H100 (700 W; chip_smoke.py's mma_sync_tf32_ceiling line,
// PERF.md): mma.sync TF32 peaks near 320 TFLOP/s, two thirds of the 495
// that only wgmma reaches, so a 3xTF32 mma.sync kernel cannot beat 3x the
// products' FLOP at that rate (bound_mma_sync_ms).
//
// Design, against what held the earlier FMA kernel back:
//   * products on the tensor cores (mma.sync m16n8k8 TF32, f32
//     accumulators), not f32 FMAs on CUDA cores;
//   * K ordered (f, h): a k-step of 8 is 8 consecutive h under one f, so an
//     element of A is one xk value times one x0 scalar of its row, with no
//     integer divide a element and no A tile rebuilt in shared memory;
//   * a block has 8 warps (2 down, 4 across) and owns 32*MT rows x 128
//     outputs, each warp 16*MT x 32 (MT x 4 mma tiles). MT = 4 (128 rows)
//     when that gives every SM a block, else 2 or 1: a small batch (the
//     serving bucket B = 256 is 4,096 rows, 32 tiles of 128) takes
//     shorter tiles rather than leaving most SMs idle;
//   * the xk and x0 rows of the block are staged in panels of at most
//     kHC = 64 columns of xk (padded H) and kFC = 16 of x0, so any H and F
//     fit in shared memory. The k-steps run h-chunk by h-chunk, and inside
//     an h-chunk in (f, h) order: each panel is a contiguous run of
//     k-steps, and the product sums over K in any order. The first panel
//     is staged with cp.async; a later one (only for H > 64 or F > 16; the
//     default xDeepFM's layers are one panel each, and a one-panel shape
//     runs a loop with no panel state) with plain loads between two
//     __syncthreads. B is walked in chunks of 32 rows (4
//     k-steps, the rows of weight_operand each k-step names) through a
//     3-stage cp.async ring, so the copy of chunk c + 2 overlaps the
//     products of chunk c, with one __syncthreads a chunk;
//   * shared-memory strides min(Hp, 64) + 4 (xk rows) and 128 + 8 (B
//     rows) make the fragment loads conflict-free; x0 rows have an odd
//     stride. A warp's
//     k-step reads 32 words a lane (16 of xk, 8 of x0, 8 of B) for 48
//     tensor-core products, where the FMA kernel read 12 for 32 FMAs;
//   * B's hi and lo parts are split as each fragment is loaded, A's as it
//     is formed, with integer rounding (split_tf32), not cvt; the ragged
//     edges of M and N are masked on the store.
// Left out: the split_half halves and the D-sum pool (outside, in the CIN
// module, so that one layer's gradient is the operator's), the JAX dispatch
// threshold and VMEM budget (TPU policy), and wgmma/TMA (a later change).

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kTN = 128;      // outputs a block
constexpr int kKC = 32;       // K rows of B a pipeline stage
constexpr int kStages = 3;
constexpr int kThreads = 256;
constexpr int kSB = kTN + 8;  // B stage row stride: conflict-free b fragments
constexpr int kHC = 64;       // xk columns (of padded H) a panel stages
constexpr int kFC = 16;       // x0 columns a panel stages

// 16-byte (or 4-byte) global -> shared copy; zero-fills when !valid.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void store_pair(float* __restrict__ out, int M, int O,
                                           int m, int n, float v0, float v1) {
  if (m >= M) return;
  float* p = out + (size_t)m * O + n;
  if ((O & 1) == 0 && n + 1 < O) {
    *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
  } else {
    if (n < O) p[0] = v0;
    if (n + 1 < O) p[1] = v1;
  }
}

// The order of the k-steps (8 consecutive h under one f): h-chunks of
// HS k-steps (kHC columns) outer, then f, then h. Only the last h-chunk
// may be short, so an iterator needs no division.
struct KStep {
  int f = 0, hs = 0, ph = 0, step = 0;  // f, h-step in the chunk, h-chunk
  int width;                            // h-steps in this h-chunk
  __device__ KStep(int HS, int NHS) : width(min(HS, NHS)) {}
  __device__ int h0(int HS) const { return (ph * HS + hs) * 8; }
  __device__ void next(int F, int HS, int NHS) {
    ++step;
    if (++hs < width) return;
    hs = 0;
    if (++f < F) return;
    f = 0;
    ++ph;
    width = min(HS, NHS - ph * HS);
  }
};

// MT m-tiles of 16 rows a warp: a block owns kTM = 32*MT rows (2 warps
// down, 4 across) and kTN = 128 outputs. kPanels is false where the rows
// fit one panel (Hp <= kHC and F <= kFC, both layers of the default
// xDeepFM): the k-steps are then weight_operand's rows in order, and the
// loop and the loader keep no panel state (on the H100 the panel walk
// cost 2-19% at those shapes, chip_smoke.py timed against the one-panel
// kernel in turns).
template <int MT, bool kPanels>
__global__ void __launch_bounds__(kThreads, 2)
cin_layer_fwd_kernel(const float* __restrict__ xk, const float* __restrict__ x0,
                     const float* __restrict__ wop, float* __restrict__ out,
                     int M, int H, int F, int O, int Hp, int Op, int vec_xk) {
  constexpr int kTM = 32 * MT;
  extern __shared__ __align__(16) float smem[];
  const int NHS = Hp / 8, HS = min(Hp, kHC) / 8;  // h-steps a row, an h-chunk
  const int sx = HS * 8 + 4, sf = min(F, kFC) | 1;
  float* bs = smem;                      // kStages x (kKC, kSB) chunks of B
  float* xs = bs + kStages * kKC * kSB;  // (kTM, sx) xk panel, zero past H
  float* x0s = xs + kTM * sx;            // (kTM, sf) x0 panel

  const int S = F * NHS;  // k-steps
  const int nchunks = (S + 3) / 4;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;  // mma group and thread in group
  const int wm = warp >> 2, wn = warp & 3;  // warp's (16*MT)-row, 32-column tile
  const int m0 = blockIdx.x * kTM, n0 = blockIdx.y * kTN;

  // Chunk c holds k-steps 4c..4c+3, row 8j + r of the chunk being row r
  // of k-step 4c + j; this thread copies row `warp` of each, its columns
  // 4*lane..4*lane+3. Chunks are loaded in order, so the loader keeps its
  // own iterator over the k-steps.
  KStep ld(HS, NHS);
  auto load_b = [&](int chunk) {
    float* dst = bs + (chunk % kStages) * (kKC * kSB);
    const int n = n0 + lane * 4;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int step = chunk * 4 + j;
      int row = step * 8 + warp;  // one panel: the rows in order
      if constexpr (kPanels) {
        row = ld.f * Hp + ld.h0(HS) + warp;
        if (ld.step < S) ld.next(F, HS, NHS);
      }
      const bool ok = step < S && n < Op;
      cp_async16(dst + (8 * j + warp) * kSB + lane * 4, ok ? wop + (size_t)row * Op + n : wop, ok);
    }
  };

  // A later panel, with plain loads: xk columns [h0, h0 + width) when the
  // h-chunk changes, and x0 columns [f0, f0 + kFC) cut at F.
  auto stage_xk = [&](int h0, int width) {
    for (int i = tid; i < kTM * width; i += kThreads) {
      const int r = i / width, c = i - r * width, h = h0 + c;
      xs[r * sx + c] = m0 + r < M && h < H ? xk[(size_t)(m0 + r) * H + h] : 0.f;
    }
  };
  auto stage_x0 = [&](int f0) {
    const int width = min(kFC, F - f0);
    for (int i = tid; i < kTM * width; i += kThreads) {
      const int r = i / width, c = i - r * width;
      x0s[r * sf + c] = m0 + r < M ? x0[(size_t)(m0 + r) * F + f0 + c] : 0.f;
    }
  };

  // The first panel, with cp.async; rows past M are zero-filled and never
  // stored.
  const int hw = min(H, HS * 8), fw = min(F, kFC);
  if (vec_xk) {  // H % 4 == 0 and xk 16-byte aligned
    const int hv = hw / 4;
    for (int i = tid; i < kTM * hv; i += kThreads) {
      const int r = i / hv, c = (i - r * hv) * 4;
      const bool ok = m0 + r < M;
      cp_async16(xs + r * sx + c, ok ? xk + (size_t)(m0 + r) * H + c : xk, ok);
    }
  } else {
    for (int i = tid; i < kTM * hw; i += kThreads) {
      const int r = i / hw, c = i - r * hw;
      const bool ok = m0 + r < M;
      cp_async4(xs + r * sx + c, ok ? xk + (size_t)(m0 + r) * H + c : xk, ok);
    }
  }
  for (int i = tid; i < kTM * (HS * 8 - hw); i += kThreads) {
    const int r = i / (HS * 8 - hw), c = hw + i - r * (HS * 8 - hw);
    xs[r * sx + c] = 0.f;  // meets B's zero rows; must be finite
  }
  for (int i = tid; i < kTM * fw; i += kThreads) {
    const int r = i / fw, c = i - r * fw;
    const bool ok = m0 + r < M;
    cp_async4(x0s + r * sf + c, ok ? x0 + (size_t)(m0 + r) * F + c : x0, ok);
  }
  load_b(0);
  cp_async_commit();  // group 0: the first panel and chunk 0
  if (nchunks > 1) load_b(1);
  cp_async_commit();  // group 1: chunk 1 (maybe empty)

  float acc[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  KStep k(HS, NHS);  // the next k-step: f, h0 = k.h0(HS), under kPanels
  int f = 0, h0 = 0;  // the same for one panel
  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<1>();  // this thread's copies of chunk c (and the rows) landed
    __syncthreads();     // everyone's did; the stage of chunk c - 1 is free
    if (c + 2 < nchunks) load_b(c + 2);
    cp_async_commit();   // one group an iteration, so wait<1> stays exact
    const float* b = bs + (c % kStages) * (kKC * kSB);
#pragma unroll
    for (int s = 0; s < kKC / 8; ++s) {
      int fl, hl;  // the k-step's columns of the panel
      if constexpr (kPanels) {
        if (k.step >= S) break;  // K ends inside the last chunk
        if (k.step > 0 && k.hs == 0 && k.f % kFC == 0) {  // a new panel (uniform)
          __syncthreads();  // every warp is done with the old one
          if (k.f == 0) stage_xk(k.h0(HS), k.width * 8);
          stage_x0(k.f);
          __syncthreads();
        }
        fl = k.f % kFC;
        hl = k.hs * 8;
      } else {
        if (f >= F) break;
        fl = f;
        hl = h0;
      }
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = wn * 32 + nt * 8 + g;
        split_tf32(b[(s * 8 + tig) * kSB + col], bh[nt][0], bl[nt][0]);
        split_tf32(b[(s * 8 + tig + 4) * kSB + col], bh[nt][1], bl[nt][1]);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int r = wm * 16 * MT + mt * 16 + g;
        const float* xr0 = xs + r * sx + hl + tig;
        const float* xr1 = xr0 + 8 * sx;
        const float f0 = x0s[r * sf + fl], f1 = x0s[(r + 8) * sf + fl];
        uint32_t ah[4], al[4];
        split_tf32(xr0[0] * f0, ah[0], al[0]);  // (row g,     k tig)
        split_tf32(xr1[0] * f1, ah[1], al[1]);  // (row g + 8, k tig)
        split_tf32(xr0[4] * f0, ah[2], al[2]);  // (row g,     k tig + 4)
        split_tf32(xr1[4] * f1, ah[3], al[3]);  // (row g + 8, k tig + 4)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          // the k-step's products on the tensor core, small terms first,
          // then added in f32 (see the header: why not one accumulator)
          float t[4] = {0.f, 0.f, 0.f, 0.f};
          mma_tf32(t, al, bh[nt][0], bh[nt][1]);
          mma_tf32(t, ah, bl[nt][0], bl[nt][1]);
          mma_tf32(t, ah, bh[nt][0], bh[nt][1]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] += t[e];
        }
      }
      if constexpr (kPanels) {
        k.next(F, HS, NHS);
      } else {
        h0 += 8;
        if (h0 == Hp) {
          h0 = 0;
          ++f;
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int m = m0 + wm * 16 * MT + mt * 16 + g;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int n = n0 + wn * 32 + nt * 8 + tig * 2;
      store_pair(out, M, O, m, n, acc[mt][nt][0], acc[mt][nt][1]);
      store_pair(out, M, O, m + 8, n, acc[mt][nt][2], acc[mt][nt][3]);
    }
  }
}

template <int MT>
cudaError_t launch(const float* xk, const float* x0, const float* wop, float* out,
                   int M, int H, int F, int O, int Hp, int Op, int device, cudaStream_t stream) {
  constexpr int kTM = 32 * MT;
  const size_t smem = sizeof(float) *
      ((size_t)kStages * kKC * kSB + (size_t)kTM * (std::min(Hp, kHC) + 4) +
       (size_t)kTM * (std::min(F, kFC) | 1));
  const bool panels = Hp > kHC || F > kFC;
  auto kernel = panels ? cin_layer_fwd_kernel<MT, true> : cin_layer_fwd_kernel<MT, false>;
  const int vec_xk = (H % 4 == 0) && (((uintptr_t)xk & 15) == 0);
  const dim3 grid((M + kTM - 1) / kTM, (Op + kTN - 1) / kTN);
  return launch_kernel(kernel, grid, kThreads, smem, device, stream, xk, x0, wop, out, M, H, F, O,
                       Hp, Op, vec_xk);
}


// ---------------------------------------------------------------------------
// The layer's gradient, in 3xTF32 as the forward.
//
// Replaces no Pallas kernel: rank_tpu's _bwd (rank_tpu/ops/pallas/cin.py:149)
// recomputes through the plain version, as the port's plain gradient
// (ops/kernels/cin.py: cin_layer_vjp_plain) still does on the CPU. That
// route builds the (B, H, F, D) pair tensor in device memory (1.88 GB for
// layer 1 at B = 65536) and pulls it through broadcast multiplies and sums.
// With m = (b, d) and g = dL/dout (M, O):
//   P_f[m, h]   = sum_o g[m, o] * w[o, h, f]            GEMM G.W, K = O
//   dxk[m, h]   = sum_f x0[m, f] * P_f[m, h]
//   dx0[m, f]   = sum_h xk[m, h] * P_f[m, h]
//   dw[o, h, f] = sum_m g[m, o] * xk[m, h] * x0[m, f]   GEMM G^T.Z, K = M
// Two GEMMs of the forward's size, 2*M*O*H*F product FLOP each; the
// reductions that give dxk and dx0 are M*H*F multiply-adds each.
//
// What bounds it on an H100 (700 W). Layer 1 of the default xDeepFM at
// B = 65536 (M = 1,048,576, H = 64, F = 7, O = 128): 2 x 120.3 GFLOP of
// products, 1.46 ms through the tensor cores in 3xTF32 at the published 495
// TFLOP/s and 2.26 ms at mma.sync's measured 320; the bytes are 1.13 GB with
// every input read and every output written once (0.34 ms at 3.35 TB/s),
// 1.97 GB as the two kernels read them (g by each, xk and x0 twice; 0.59
// ms). Operations bind; layer 0 (H = F = 7) is 9x lighter.
//
// Design:
//   * cin_layer_bwd_dz_kernel (dxk and dx0): a block owns 128 rows m,
//     eight warps of one m16 tile each, so a warp's rows are its own and no
//     sum crosses warps. Its rows of g, the A operand, are staged once in
//     shared memory (panels of 128 columns of O padded to 8; O <= 128 is
//     one panel), the first window's stages bringing the columns they use.
//     P's columns are walked in windows of at most 64: an h-chunk of 8, 16,
//     32 or 64 columns (H padded up to one of those, or above 64 to a
//     multiple of 64) under as many f as fill 64. The window's columns of
//     W (weight_operand_bwd: (h-chunk, f, o, h), zero padded) stream
//     through a 2-stage cp.async ring, 64 rows of K a stage. A window's P
//     tile lives in registers only and is reduced in the epilogue: x0 * P
//     into dxk accumulators held in registers for the h-chunk, xk * P
//     summed over the thread's h and then over the four lanes of a quad by
//     shuffles into dx0. P is never written to device memory. The xk and
//     x0 values the epilogue takes are loaded into registers as the window
//     starts, so their latency hides behind its products (read in the
//     epilogue they cost the H100 28% of the kernel's time). Where H
//     has several h-chunks, dx0's owning lane adds each chunk's sum to what
//     it wrote, in chunk order.
//   * cin_layer_bwd_dw_kernel: the forward's kernel with the roles turned:
//     rows (f, h) of one h-chunk, columns o, K = m. A fragments are formed
//     in registers as xk * x0 from the staged rows (Z is never built), B
//     fragments read the staged rows of g; all three stream through one
//     2-stage cp.async ring of 64 rows m. Where a warp's rows lie under one
//     f (layer 1), a k-step reads two values of x0 for all its tiles (7%
//     faster on the H100). The m axis is split across blocks
//     (about four blocks an SM in all, at least 256 rows each); each block
//     writes its partial, in dw's (O, H, F) layout, to a workspace, and
//     cin_layer_bwd_dw_reduce sums the partials in split order. No
//     atomics: the same inputs give bit-identical gradients.
//   * Numerics as the forward: operands split into hi and lo by integer
//     rounding (split_tf32), each k-step's three products into a zeroed
//     fragment, added to the accumulator in f32 on the CUDA cores. The
//     reductions for dxk and dx0 are f32 multiply-adds.

constexpr int kBwdTM = 128;      // rows m a dz block
constexpr int kDzMT = 1;         // m16 tiles a dz warp: eight warps of 16 rows, 16 warps
                                 // an SM (four warps of 32 rows ran 4% slower on the H100)
constexpr int kOC = 128;         // columns of g (O padded to 8) a dz panel stages
constexpr int kWC = 64;          // P columns a window
constexpr int kSW = kWC + 8;     // W stage row stride: conflict-free b fragments
// Pipeline stages of 64 rows, two of them: one __syncthreads every eight
// k-steps, and the next stage's copy has a stage's products to land in
// (on the H100 7% faster for both kernels than three stages of 32).
constexpr int kDzKC = 64;        // K rows of W a dz stage
constexpr int kDzStages = 2;
constexpr int kDwKC = 64;        // rows m a dw stage
constexpr int kDwStages = 2;
constexpr int kSG = kTN + 8;     // g stage row stride in dw: conflict-free b fragments

// The h columns an h-chunk of the backward holds: H padded to 8, then to 16,
// 32 or 64; above 64, chunks of 64 (ops/kernels/cin.py: backward_h_chunk).
int bwd_h_chunk(int H) {
  const int hp = (H + 7) / 8 * 8;
  return hp <= 8 ? 8 : hp <= 16 ? 16 : hp <= 32 ? 32 : 64;
}

// HS = h-steps of 8 an h-chunk (1, 2, 4 or 8); a window is FW f's of one
// h-chunk, NT = FW * HS tiles of 8 columns. kPanels: O padded to 8 is more
// than one panel of g, which is then staged again for each window.
template <int HS, bool kPanels>
__global__ void __launch_bounds__(kBwdTM / (16 * kDzMT) * 32, 2)
cin_layer_bwd_dz_kernel(const float* __restrict__ g, const float* __restrict__ xk,
                        const float* __restrict__ x0, const float* __restrict__ wb,
                        float* __restrict__ dxk, float* __restrict__ dx0,
                        int M, int H, int F, int O, int Op8, int NHC, int vec_g) {
  constexpr int HSW = HS * 8, FW = 8 / HS, NT = FW * HS, MT = kDzMT;
  constexpr int kWarpRows = 16 * MT, kNThreads = kBwdTM / kWarpRows * 32;
  extern __shared__ __align__(16) float smem[];
  const int OC = min(Op8, kOC), sg = OC + 4;  // sg = 4 mod 8: conflict-free a fragments
  float* gs = smem;                 // (kBwdTM, sg) panel of g
  float* bs = gs + kBwdTM * sg;     // kDzStages x (kDzKC, kSW) chunks of W
  constexpr int kSPC = kDzKC / 8;   // k-steps a chunk
  constexpr int kCPP = kOC / kDzKC; // chunks a panel of g
  const int KS = Op8 / 8;           // k-steps a window
  const int KCH = (KS + kSPC - 1) / kSPC;  // chunks a window
  const int NFG = (F + FW - 1) / FW;
  const int nchunks = NHC * NFG * KCH;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tig = lane & 3;
  const int m0 = blockIdx.x * kBwdTM, rw = warp * kWarpRows;

  // Columns [c0, c0 + width) of the panel of g that starts at column p0,
  // for the block's rows; zero past O and M.
  auto stage_g = [&](int p0, int c0, int width, bool async) {
    if (async && vec_g) {  // O % 4 == 0 and g 16-byte aligned
      const int cv = width / 4;
      for (int i = tid; i < kBwdTM * cv; i += kNThreads) {
        const int r = i / cv, c = c0 + (i - r * cv) * 4;
        const bool ok = m0 + r < M && p0 + c < O;
        cp_async16(gs + r * sg + c, ok ? g + (size_t)(m0 + r) * O + p0 + c : g, ok);
      }
      return;
    }
    for (int i = tid; i < kBwdTM * width; i += kNThreads) {
      const int r = i / width, c = c0 + i - r * width;
      const bool ok = m0 + r < M && p0 + c < O;
      if (async)
        cp_async4(gs + r * sg + c, ok ? g + (size_t)(m0 + r) * O + p0 + c : g, ok);
      else
        gs[r * sg + c] = ok ? g[(size_t)(m0 + r) * O + p0 + c] : 0.f;
    }
  };
  // Chunk c: window c / KCH (h-chunk outer, f-group inner), its K rows
  // kDzKC * (c % KCH) on; row o of the stage holds the window's NT * 8 columns.
  // The first window's chunks also bring the first panel's columns of g
  // that they use, so that its products start before the panel is whole.
  auto load = [&](int c) {
    float* dst = bs + (c % kDzStages) * (kDzKC * kSW);
    const int win = c / KCH, kc = c - win * KCH;
    const int hc = win / NFG, fg = win - hc * NFG;
    for (int i = tid; i < kDzKC * NT * 2; i += kNThreads) {
      const int r = i / (NT * 2), col = (i - r * (NT * 2)) * 4;
      const int fi = col / HSW, f = fg * FW + fi, o = kc * kDzKC + r;
      const bool ok = f < F && o < Op8;
      const float* src = wb + (((size_t)hc * F + f) * Op8 + o) * HSW + col - fi * HSW;
      cp_async16(dst + r * kSW + col, ok ? src : wb, ok);
    }
    if (win == 0 && kc * kDzKC < OC) stage_g(0, kc * kDzKC, min(kDzKC, OC - kc * kDzKC), true);
  };

  for (int c = 0; c < kDzStages - 1; ++c) {  // one group a chunk (maybe empty)
    if (c < nchunks) load(c);
    cp_async_commit();
  }

  float acc[MT][NT][4];  // the window's P tile
  float dk[MT][HS][4];   // dxk of the h-chunk
  float xr[MT][HS][4];   // xk at dk's places, zero past H and M
  float x0r[MT][FW][2];  // x0 of the window's f's at rows g and g + 8, zero past F and M
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hs = 0; hs < HS; ++hs)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[mt][hs][e] = 0.f;

  for (int c = 0; c < nchunks; ++c) {
    const int win = c / KCH, kc = c - win * KCH;
    cp_async_wait<kDzStages - 2>();  // this thread's copies of chunk c landed
    __syncthreads();  // everyone's did; chunk c - 1's stage is free
    if (c + kDzStages - 1 < nchunks) load(c + kDzStages - 1);
    cp_async_commit();  // one group an iteration, so the wait stays exact
    if constexpr (kPanels) {
      if (c >= kCPP && kc % kCPP == 0) {  // a new panel of K, past the first window's first
        stage_g(kc / kCPP * kOC, 0, min(OC, Op8 - kc / kCPP * kOC), false);
        __syncthreads();
      }
    }
    if (kc == 0) {  // a new window: load what its epilogue reads, ahead of its products
      const int hc = win / NFG, fg = win - hc * NFG;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int r0 = m0 + rw + mt * 16 + gq, r1 = r0 + 8;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
#pragma unroll
        for (int fi = 0; fi < FW; ++fi) {
          const int f = fg * FW + fi;
          x0r[mt][fi][0] = r0 < M && f < F ? x0[(size_t)r0 * F + f] : 0.f;
          x0r[mt][fi][1] = r1 < M && f < F ? x0[(size_t)r1 * F + f] : 0.f;
        }
        if (fg == 0) {
#pragma unroll
          for (int hs = 0; hs < HS; ++hs) {
            const int h = hc * HSW + hs * 8 + tig * 2;
            xr[mt][hs][0] = r0 < M && h < H ? xk[(size_t)r0 * H + h] : 0.f;
            xr[mt][hs][1] = r0 < M && h + 1 < H ? xk[(size_t)r0 * H + h + 1] : 0.f;
            xr[mt][hs][2] = r1 < M && h < H ? xk[(size_t)r1 * H + h] : 0.f;
            xr[mt][hs][3] = r1 < M && h + 1 < H ? xk[(size_t)r1 * H + h + 1] : 0.f;
          }
        }
      }
    }
    const float* b = bs + (c % kDzStages) * (kDzKC * kSW);
#pragma unroll
    for (int s = 0; s < kSPC; ++s) {
      const int ks = kc * kSPC + s;
      if (ks >= KS) break;  // K ends inside the last chunk
      const int kcol = (ks % (kOC / 8)) * 8;
      uint32_t ah[MT][4], al[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const float* gr = gs + (rw + mt * 16 + gq) * sg + kcol + tig;
        split_tf32(gr[0], ah[mt][0], al[mt][0]);           // (row g,     k tig)
        split_tf32(gr[8 * sg], ah[mt][1], al[mt][1]);      // (row g + 8, k tig)
        split_tf32(gr[4], ah[mt][2], al[mt][2]);           // (row g,     k tig + 4)
        split_tf32(gr[8 * sg + 4], ah[mt][3], al[mt][3]);  // (row g + 8, k tig + 4)
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(b[(s * 8 + tig) * kSW + nt * 8 + gq], bh0, bl0);
        split_tf32(b[(s * 8 + tig + 4) * kSW + nt * 8 + gq], bh1, bl1);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          float t[4] = {0.f, 0.f, 0.f, 0.f};
          mma_tf32(t, al[mt], bh0, bh1);
          mma_tf32(t, ah[mt], bl0, bl1);
          mma_tf32(t, ah[mt], bh0, bh1);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] += t[e];
        }
      }
    }
    if (kc != KCH - 1) continue;

    // The window's P is complete: reduce it into dxk and dx0.
    const int hc = win / NFG, fg = win - hc * NFG;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int r0 = m0 + rw + mt * 16 + gq, r1 = r0 + 8;
#pragma unroll
      for (int fi = 0; fi < FW; ++fi) {
        const int f = fg * FW + fi;
        if (f >= F) break;  // uniform
        float s0 = 0.f, s1 = 0.f;
#pragma unroll
        for (int hs = 0; hs < HS; ++hs) {
          const float(&p)[4] = acc[mt][fi * HS + hs];
          const float(&x)[4] = xr[mt][hs];
          dk[mt][hs][0] = fmaf(x0r[mt][fi][0], p[0], dk[mt][hs][0]);
          dk[mt][hs][1] = fmaf(x0r[mt][fi][0], p[1], dk[mt][hs][1]);
          dk[mt][hs][2] = fmaf(x0r[mt][fi][1], p[2], dk[mt][hs][2]);
          dk[mt][hs][3] = fmaf(x0r[mt][fi][1], p[3], dk[mt][hs][3]);
          s0 = fmaf(x[1], p[1], fmaf(x[0], p[0], s0));
          s1 = fmaf(x[3], p[3], fmaf(x[2], p[2], s1));
        }
        s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
        s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
        s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
        s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
        if (tig == 0) {
          if (r0 < M) {
            float* d = dx0 + (size_t)r0 * F + f;
            *d = hc == 0 ? s0 : *d + s0;
          }
          if (r1 < M) {
            float* d = dx0 + (size_t)r1 * F + f;
            *d = hc == 0 ? s1 : *d + s1;
          }
        }
      }
    }
    if (fg != NFG - 1) continue;
    // The h-chunk's last window: its dxk is complete.
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int r0 = m0 + rw + mt * 16 + gq;
#pragma unroll
      for (int hs = 0; hs < HS; ++hs) {
        const int h = hc * HSW + hs * 8 + tig * 2;
        store_pair(dxk, M, H, r0, h, dk[mt][hs][0], dk[mt][hs][1]);
        store_pair(dxk, M, H, r0 + 8, h, dk[mt][hs][2], dk[mt][hs][3]);
#pragma unroll
        for (int e = 0; e < 4; ++e) dk[mt][hs][e] = 0.f;
      }
    }
  }
  cp_async_wait<0>();
}

// MT m16 tiles of rows (f, h) a warp: a block owns 32*MT rows of one
// h-chunk (fwd f's of hsw columns; rows past F are zero) and
// kTN = 128 columns o, over rows m [z * rows_per_split, + rows_per_split).
template <int MT, bool kOneF>
__global__ void __launch_bounds__(kThreads, 2)
cin_layer_bwd_dw_kernel(const float* __restrict__ g, const float* __restrict__ xk,
                        const float* __restrict__ x0, float* __restrict__ part,
                        int M, int H, int F, int O, int hsw, int fwd, int rows_per_split,
                        int vec_g, int vec_xk) {
  extern __shared__ __align__(16) float smem[];
  const int sx = hsw | 8, sf = fwd | 1;     // sx = 8 mod 16: conflict-free a fragments
  const int stage = kDwKC * (kSG + sx + sf);  // (kDwKC, kSG) g, (kDwKC, sx) xk, (kDwKC, sf) x0
  const int nrt = (F + fwd - 1) / fwd;
  const int hc = blockIdx.x / nrt, f0 = (blockIdx.x - hc * nrt) * fwd, h0 = hc * hsw;
  const int o0 = blockIdx.y * kTN;
  const int ms = blockIdx.z * rows_per_split, me = min(M, ms + rows_per_split);
  const int nchunks = me > ms ? (me - ms + kDwKC - 1) / kDwKC : 0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tig = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;

  // This thread's rows of the block, g of each m16 tile, as (f column of
  // the staged x0, h column of the staged xk); row g + 8 lies 8 columns of
  // h on (hsw >= 16) or one f on (hsw = 8). fwd * hsw = 32 * MT, so every row
  // names a staged column; x0's columns past F are zero. kOneF: the warp's
  // 16 * MT rows lie under one f (the default xDeepFM's layer 1), so a
  // k-step reads two values of x0 for all its tiles, and the rows are
  // (fa[0], ha[0] + 16 * mt).
  constexpr int NR = kOneF ? 1 : MT;
  const int dh = hsw >= 16 ? 8 : 0, df = hsw >= 16 ? 0 : 1;
  int fa[NR], ha[NR];
#pragma unroll
  for (int mt = 0; mt < NR; ++mt) {
    const int r = wm * 16 * MT + mt * 16 + gq;
    fa[mt] = r / hsw;
    ha[mt] = r - fa[mt] * hsw;
  }

  // Chunk c: rows m [ms + kDwKC * c, + kDwKC) of g (columns o0 on), of xk (the
  // h-chunk's columns) and of x0 (the block's f's); zero past me.
  auto load = [&](int c) {
    float* gsd = smem + (c % kDwStages) * stage;
    float* xsd = gsd + kDwKC * kSG;
    float* x0d = xsd + kDwKC * sx;
    const int mb = ms + c * kDwKC;
    if (vec_g) {  // O % 4 == 0 and g 16-byte aligned
      for (int i = tid; i < kDwKC * (kTN / 4); i += kThreads) {
        const int r = i / (kTN / 4), col = (i - r * (kTN / 4)) * 4;
        const bool ok = mb + r < me && o0 + col < O;
        cp_async16(gsd + r * kSG + col, ok ? g + (size_t)(mb + r) * O + o0 + col : g, ok);
      }
    } else {
      for (int i = tid; i < kDwKC * kTN; i += kThreads) {
        const int r = i / kTN, col = i - r * kTN;
        const bool ok = mb + r < me && o0 + col < O;
        cp_async4(gsd + r * kSG + col, ok ? g + (size_t)(mb + r) * O + o0 + col : g, ok);
      }
    }
    if (vec_xk) {  // H % 4 == 0 and xk 16-byte aligned
      const int hv = hsw / 4;
      for (int i = tid; i < kDwKC * hv; i += kThreads) {
        const int r = i / hv, col = (i - r * hv) * 4;
        const bool ok = mb + r < me && h0 + col < H;
        cp_async16(xsd + r * sx + col, ok ? xk + (size_t)(mb + r) * H + h0 + col : xk, ok);
      }
    } else {
      for (int i = tid; i < kDwKC * hsw; i += kThreads) {
        const int r = i / hsw, col = i - r * hsw;
        const bool ok = mb + r < me && h0 + col < H;
        cp_async4(xsd + r * sx + col, ok ? xk + (size_t)(mb + r) * H + h0 + col : xk, ok);
      }
    }
    for (int i = tid; i < kDwKC * fwd; i += kThreads) {
      const int r = i / fwd, col = i - r * fwd;
      const bool ok = mb + r < me && f0 + col < F;
      cp_async4(x0d + r * sf + col, ok ? x0 + (size_t)(mb + r) * F + f0 + col : x0, ok);
    }
  };

  for (int c = 0; c < kDwStages - 1; ++c) {  // one group a chunk (maybe empty)
    if (c < nchunks) load(c);
    cp_async_commit();
  }

  float acc[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<kDwStages - 2>();
    __syncthreads();
    if (c + kDwStages - 1 < nchunks) load(c + kDwStages - 1);
    cp_async_commit();
    const float* gsd = smem + (c % kDwStages) * stage;
    const float* xsd = gsd + kDwKC * kSG;
    const float* x0d = xsd + kDwKC * sx;
#pragma unroll
    for (int s = 0; s < kDwKC / 8; ++s) {
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = wn * 32 + nt * 8 + gq;
        split_tf32(gsd[(s * 8 + tig) * kSG + col], bh[nt][0], bl[nt][0]);
        split_tf32(gsd[(s * 8 + tig + 4) * kSG + col], bh[nt][1], bl[nt][1]);
      }
      const float* xr0 = xsd + (s * 8 + tig) * sx;
      const float* xr4 = xr0 + 4 * sx;
      const float* fr0 = x0d + (s * 8 + tig) * sf;
      const float* fr4 = fr0 + 4 * sf;
      const float f0 = kOneF ? fr0[fa[0]] : 0.f, f4 = kOneF ? fr4[fa[0]] : 0.f;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t ah[4], al[4];
        if constexpr (kOneF) {
          const int h = ha[0] + mt * 16;
          split_tf32(xr0[h] * f0, ah[0], al[0]);
          split_tf32(xr0[h + 8] * f0, ah[1], al[1]);
          split_tf32(xr4[h] * f4, ah[2], al[2]);
          split_tf32(xr4[h + 8] * f4, ah[3], al[3]);
        } else {
          const int hb = ha[mt] + dh, fb = fa[mt] + df;
          split_tf32(xr0[ha[mt]] * fr0[fa[mt]], ah[0], al[0]);  // (row g,     k tig)
          split_tf32(xr0[hb] * fr0[fb], ah[1], al[1]);          // (row g + 8, k tig)
          split_tf32(xr4[ha[mt]] * fr4[fa[mt]], ah[2], al[2]);  // (row g,     k tig + 4)
          split_tf32(xr4[hb] * fr4[fb], ah[3], al[3]);          // (row g + 8, k tig + 4)
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          float t[4] = {0.f, 0.f, 0.f, 0.f};
          mma_tf32(t, al, bh[nt][0], bh[nt][1]);
          mma_tf32(t, ah, bl[nt][0], bl[nt][1]);
          mma_tf32(t, ah, bh[nt][0], bh[nt][1]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] += t[e];
        }
      }
    }
  }
  cp_async_wait<0>();

  // The block's partial of dw[o, h, f], in dw's layout, in split z's slice.
  float* out = part + (size_t)blockIdx.z * O * H * F;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int f = kOneF ? f0 + fa[0] : f0 + fa[mt] + half * df;
      const int h = kOneF ? h0 + ha[0] + mt * 16 + half * 8 : h0 + ha[mt] + half * dh;
      if (f >= F || h >= H) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int o = o0 + wn * 32 + nt * 8 + tig * 2;
        if (o < O) out[((size_t)o * H + h) * F + f] = acc[mt][nt][2 * half];
        if (o + 1 < O) out[((size_t)(o + 1) * H + h) * F + f] = acc[mt][nt][2 * half + 1];
      }
    }
  }
}

// dw[i] = sum over the splits of part[z][i] in a fixed order: groups of eight
// as a tree, the groups in turn.
__global__ void cin_layer_bwd_dw_reduce(const float* __restrict__ part, float* __restrict__ dw,
                                        int splits, size_t n) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    int z = 0;
    for (; z + 8 <= splits; z += 8) {
      const float* p = part + z * n + i;
      s += ((p[0] + p[n]) + (p[2 * n] + p[3 * n])) +
           ((p[4 * n] + p[5 * n]) + (p[6 * n] + p[7 * n]));
    }
    for (; z < splits; ++z) s += part[z * n + i];
    dw[i] = s;
  }
}

// dw's tiling: m16 tiles a warp (MT), f's a row tile (fwd), row tiles.
struct DwTiling {
  int hsw, nhc, mt, fwd, tiles;
};
DwTiling dw_tiling(int H, int F, int O) {
  DwTiling t;
  t.hsw = bwd_h_chunk(H);
  t.nhc = ((H + 7) / 8 * 8 + t.hsw - 1) / t.hsw;
  const int rows = F * t.hsw;  // rows of one h-chunk
  t.mt = rows > 64 ? 4 : rows > 32 ? 2 : 1;
  t.fwd = std::max(1, 32 * t.mt / t.hsw);
  t.tiles = t.nhc * ((F + t.fwd - 1) / t.fwd) * ((O + kTN - 1) / kTN);
  return t;
}

// Rows m a dw block takes: enough splits for about four blocks an SM, at
// least 256 rows each, in whole stages.
int dw_rows_per_split(int M, const DwTiling& t, int sms) {
  int splits = std::max(1, (4 * sms + t.tiles - 1) / t.tiles);
  splits = std::min(splits, std::max(1, (M + 255) / 256));
  const int rows = (M + splits - 1) / splits;
  return (rows + kDwKC - 1) / kDwKC * kDwKC;
}

template <int HS>
cudaError_t launch_dz(const float* g, const float* xk, const float* x0, const float* wb,
                      float* dxk, float* dx0, int M, int H, int F, int O, int Op8, int nhc,
                      int device, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)kBwdTM * (std::min(Op8, kOC) + 4) +
                                       (size_t)kDzStages * kDzKC * kSW);
  auto kernel = Op8 > kOC ? cin_layer_bwd_dz_kernel<HS, true> : cin_layer_bwd_dz_kernel<HS, false>;
  const int vec_g = (O % 4 == 0) && (((uintptr_t)g & 15) == 0);
  return launch_kernel(kernel, (M + kBwdTM - 1) / kBwdTM, kBwdTM / (16 * kDzMT) * 32, smem, device,
                       stream, g, xk, x0, wb, dxk, dx0, M, H, F, O, Op8, nhc, vec_g);
}

template <int MT>
cudaError_t launch_dw(const float* g, const float* xk, const float* x0, float* part,
                      int M, int H, int F, int O, const DwTiling& t, int rows_per_split,
                      int splits, int device, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * kDwStages * kDwKC * ((size_t)kSG + (t.hsw | 8) + (t.fwd | 1));
  auto kernel = t.hsw % (16 * MT) == 0 ? cin_layer_bwd_dw_kernel<MT, true>
                                       : cin_layer_bwd_dw_kernel<MT, false>;
  const int vec_g = (O % 4 == 0) && (((uintptr_t)g & 15) == 0);
  const int vec_xk = (H % 4 == 0) && (((uintptr_t)xk & 15) == 0);
  const dim3 grid(t.tiles / ((O + kTN - 1) / kTN), (O + kTN - 1) / kTN, splits);
  return launch_kernel(kernel, grid, kThreads, smem, device, stream, g, xk, x0, part, M, H, F, O,
                       t.hsw, t.fwd, rows_per_split, vec_g, vec_xk);
}

}  // namespace

// xk (M, H), x0 (M, F), wop (F*Hp, Op) with row f*Hp + h and zeros in the
// padding, out (M, O); all f32, contiguous, on `device`; Hp = H rounded up
// to 8, Op = O rounded up to 4; any H, F, O >= 1. Launches on `stream`;
// returns a cudaError_t.
extern "C" int cin_layer_fwd(const float* xk, const float* x0, const float* wop,
                             float* out, int M, int H, int F, int O, int device,
                             void* stream) {
  if (M < 1 || H < 1 || F < 1 || O < 1) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)wop & 15) != 0) return (int)cudaErrorMisalignedAddress;
  const int Hp = (H + 7) / 8 * 8, Op = (O + 3) / 4 * 4;
  DeviceLimits lim;
  const cudaError_t err = use_device(device, lim);
  if (err != cudaSuccess) return (int)err;
  // The tallest block tile that still gives every SM a block: small M (a
  // small batch) takes shorter tiles rather than leaving SMs idle.
  const long n_tiles = (Op + kTN - 1) / kTN;
  auto run = (M + 127) / 128 * n_tiles >= lim.sms ? launch<4>
             : (M + 63) / 64 * n_tiles >= lim.sms ? launch<2> : launch<1>;
  return (int)run(xk, x0, wop, out, M, H, F, O, Hp, Op, device, static_cast<cudaStream_t>(stream));
}

// The number of partial sums of dw that cin_layer_bwd takes room for: its
// workspace is (splits, O, H, F) f32. A negative cudaError_t on failure.
extern "C" int cin_layer_bwd_splits(int M, int H, int F, int O, int device) {
  if (M < 1 || H < 1 || F < 1 || O < 1) return -(int)cudaErrorInvalidValue;
  DeviceLimits lim;
  const cudaError_t err = use_device(device, lim);
  if (err != cudaSuccess) return -(int)err;
  const int rows = dw_rows_per_split(M, dw_tiling(H, F, O), lim.sms);
  return (M + rows - 1) / rows;
}

// The gradients of one layer: g (M, O) = dL/dout, xk (M, H), x0 (M, F), wb
// (NHC, F, Op8, HSW) from weight_operand_bwd (ops/kernels/cin.py), out dxk
// (M, H), dx0 (M, F), dw (O, H, F), and part, room for `splits`
// (cin_layer_bwd_splits) partials of dw; all f32, contiguous, on `device`;
// any H, F, O >= 1. `hsw` is the HSW wb was laid out with: a width other
// than bwd_h_chunk(H) is refused, not read wrongly. Three launches on
// `stream`; returns a cudaError_t.
extern "C" int cin_layer_bwd(const float* g, const float* xk, const float* x0, const float* wb,
                             float* dxk, float* dx0, float* dw, float* part, int splits, int hsw,
                             int M, int H, int F, int O, int device, void* stream) {
  if (M < 1 || H < 1 || F < 1 || O < 1) return (int)cudaErrorInvalidValue;
  if (hsw != bwd_h_chunk(H)) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)wb & 15) != 0) return (int)cudaErrorMisalignedAddress;
  DeviceLimits lim;
  cudaError_t err = use_device(device, lim);
  if (err != cudaSuccess) return (int)err;
  const DwTiling t = dw_tiling(H, F, O);
  const int rows = dw_rows_per_split(M, t, lim.sms);
  if ((M + rows - 1) / rows != splits) return (int)cudaErrorInvalidValue;
  const int Op8 = (O + 7) / 8 * 8;
  auto s = static_cast<cudaStream_t>(stream);
  auto dz = t.hsw == 8 ? launch_dz<1> : t.hsw == 16 ? launch_dz<2>
             : t.hsw == 32 ? launch_dz<4> : launch_dz<8>;
  err = dz(g, xk, x0, wb, dxk, dx0, M, H, F, O, Op8, t.nhc, device, s);
  if (err != cudaSuccess) return (int)err;
  auto dw_partial = t.mt == 1 ? launch_dw<1> : t.mt == 2 ? launch_dw<2> : launch_dw<4>;
  err = dw_partial(g, xk, x0, part, M, H, F, O, t, rows, splits, device, s);
  if (err != cudaSuccess) return (int)err;
  const size_t n = (size_t)O * H * F;
  const int blocks = (int)std::min<size_t>((n + 255) / 256, (size_t)lim.sms * 8);
  cin_layer_bwd_dw_reduce<<<blocks, 256, 0, s>>>(part, dw, splits, n);
  return (int)cudaGetLastError();
}
