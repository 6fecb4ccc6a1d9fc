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
// Left out: the split_half halves and the D-sum pool (outside, so that
// CINLayerFn's backward is unchanged), the JAX dispatch threshold and
// VMEM budget (TPU policy), and wgmma/TMA (a later change).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kTN = 128;      // outputs a block
constexpr int kKC = 32;       // K rows of B a pipeline stage
constexpr int kStages = 3;
constexpr int kThreads = 256;
constexpr int kSB = kTN + 8;  // B stage row stride: conflict-free b fragments
constexpr int kHC = 64;       // xk columns (of padded H) a panel stages
constexpr int kFC = 16;       // x0 columns a panel stages

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
                   int M, int H, int F, int O, int Hp, int Op, cudaStream_t stream) {
  constexpr int kTM = 32 * MT;
  const size_t smem = sizeof(float) *
      ((size_t)kStages * kKC * kSB + (size_t)kTM * (std::min(Hp, kHC) + 4) +
       (size_t)kTM * (std::min(F, kFC) | 1));
  const bool panels = Hp > kHC || F > kFC;
  auto kernel = panels ? cin_layer_fwd_kernel<MT, true> : cin_layer_fwd_kernel<MT, false>;
  // Above 48 KB a block must opt in; above the card's limit this fails and
  // the launch is refused with the error returned here.
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int vec_xk = (H % 4 == 0) && (((uintptr_t)xk & 15) == 0);
  const dim3 grid((M + kTM - 1) / kTM, (Op + kTN - 1) / kTN);
  kernel<<<grid, kThreads, smem, stream>>>(xk, x0, wop, out, M, H, F, O, Hp, Op, vec_xk);
  return cudaGetLastError();
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
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  // The tallest block tile that still gives every SM a block: small M (a
  // small batch) takes shorter tiles rather than leaving SMs idle.
  const long n_tiles = (Op + kTN - 1) / kTN;
  auto s = static_cast<cudaStream_t>(stream);
  if ((M + 127) / 128 * n_tiles >= sms)
    return (int)launch<4>(xk, x0, wop, out, M, H, F, O, Hp, Op, s);
  if ((M + 63) / 64 * n_tiles >= sms)
    return (int)launch<2>(xk, x0, wop, out, M, H, F, O, Hp, Op, s);
  return (int)launch<1>(xk, x0, wop, out, M, H, F, O, Hp, Op, s);
}

extern "C" const char* cin_layer_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
