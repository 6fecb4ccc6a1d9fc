// DIEN's GRU, AGRU and AUGRU recurrences over a whole sequence, forward and
// backward, for Hopper (sm_90a), in f32 on the CUDA cores.
//
// Replaces no TPU kernel. The JAX package runs the recurrence as a
// lax.scan (rank_tpu/ops/rnn.py: AttentionalGRU), which XLA compiles into
// one device loop. Its port ran the loop from Python
// (rank_tpu_torch/ops/rnn.py: AttentionalGRU._loop): some 2,650 kernels a
// call, forward and backward, at T = 50, each of 1 to 2 us. These kernels
// walk all T steps of a direction in one launch.
//
// The algebra. With x_t (D), h (H) and the gate kernels split by rows into
// W_x (D rows) and U (H rows):
//   [u, r] = sigmoid(x W_xg + b_g + h U_g)
//   c      = tanh(x W_xc + b_c + (r*h) U_c)
//   z = u (gru), a_t (agru), a_t*u (augru);  h' = (1 - z) h + z c
// The x-parts do not depend on h, so the caller computes them for all T
// steps in one product, P = X [W_xg | W_xc] + [b_g | b_c]
// (ops/rnn.py: GRUSequence), and these kernels carry the recurrence only.
// The weight and input gradients are products over all B*T rows of the
// pre-activation gradients the backward kernel writes, again outside.
//
// What bounds it (H100 at 700 W; DIEN's cell: B = 1024, T = 50, H = 36,
// lengths balanced over 0-50):
//   * operations: the recurrent products, 2*3H*H FLOP a row's valid step in
//     each direction, 0.20 GFLOP a call: 3 us at 67 TFLOP/s;
//   * bytes: P and the outputs, the saved u, r, c, h and r*h (forward),
//     those and the gradients (backward), 44-55 MB a call: 13-17 us at
//     3.35 TB/s;
//   * the chain, which binds: T dependent steps, each two dependent
//     matrix-vector products (forward: the gates, then the candidate;
//     backward: the candidate's, then the reset gate's) of K = H, each
//     ended by a block barrier, and the elementwise work between them on
//     the same threads. Measured (chip_smoke.py, gru_seq_times) about 2 us
//     a step: 0.11 ms forward and 0.14 ms backward a call, where the loop
//     replayed from CUDA graphs took 1.6 and 4.5-5.0 ms.
// Design:
//   * a block owns 8 rows for all T steps and keeps h (backward: dh) on
//     chip: 128 blocks at B = 1024, one wave on 132 SMs;
//   * U_g and U_c stay in shared memory for the whole call (transposed for
//     the backward): 3*H*H floats, 15.6 KB at H = 36 and 196 KB at
//     H = 128. Wider, up to H = 512, they do not fit: a block then reads
//     them from global memory (L2) every step, untransposed, 8 rows a
//     thread. No configuration runs that width; it is there so that every
//     H the loop took runs on the card, and it is not tuned;
//   * a thread owns one column and RPT rows, 2 up to H = 64, 4 up to 128
//     and 8 above (at most 512 threads a block, 1024 above H = 256): per k
//     it loads one weight and the RPT rows' state in one vector load (a
//     broadcast; the state is stored transposed, (H, rows)) for RPT FMAs;
//     the loads of 8 k (2 at 8 rows) are issued before their FMAs;
//   * forward: the 2H threads of the gate columns compute u and r; the H
//     threads of u's columns then compute the candidate and the update,
//     with u kept in registers. Two barriers a step;
//   * backward: the H threads of dh's columns ("owners") compute the
//     elementwise gradients, then drh = dc_pre U_c^T while the H others
//     compute the update gate's share of dh, du_pre U_gu^T; then the owners
//     add the reset gate's share, dr_pre U_gr^T. Two barriers a step; the
//     buffers read across the missing third are kept by parity;
//   * the next step's inputs (forward: P and a_t; backward: the saved
//     gates, h, a_t and the upstream gradient) are loaded into registers
//     while the current step computes;
//   * a row's padded steps (t >= length) carry h (dh) and write zeros, as
//     the loop's torch.where does; a block computes up to its longest row
//     and zero-fills the rest; a length past T counts as T;
//   * f32 FMAs (no TF32, no fast math), every sum in a fixed order, no
//     atomics: equal inputs give equal bits.
// Tried and dropped (chip_smoke-style timings, PERF.md): 4-row blocks (no
// faster), fetching inputs into L2 four steps ahead (slower), fast
// exp and division (no faster: the chain of dependent instructions, not
// the special functions, sets a step's time).

#include "common.cuh"

namespace {

constexpr int kRows = 8;      // rows a block
constexpr int kMaxStaged = 128;  // the widest H whose U fits shared memory
constexpr int kMaxH = 512;    // the widest H: 2H threads a block at 8 rows a thread
constexpr int kWide = 8;      // rows a thread where U stays in global memory
enum Mode { kGru = 0, kAgru = 1, kAugru = 2 };
__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// RPT consecutive floats of shared memory in one load.
template <int RPT> struct Rows;
template <> struct Rows<2> {
  __device__ __forceinline__ static void load(const float* p, float (&v)[2]) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x; v[1] = x.y;
  }
};
template <> struct Rows<4> {
  __device__ __forceinline__ static void load(const float* p, float (&v)[4]) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  }
};
template <> struct Rows<8> {
  __device__ __forceinline__ static void load(const float* p, float (&v)[8]) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    const float4 y = *reinterpret_cast<const float4*>(p + 4);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
    v[4] = y.x; v[5] = y.y; v[6] = y.z; v[7] = y.w;
  }
};

// The float offset of a shared-memory region after `n` floats, rounded up
// to 4 so that vector reads of it are aligned.
__host__ __device__ __forceinline__ int align4(int n) { return (n + 3) & ~3; }

// acc[i] += sum_k s[k][RPT q + i] * w[k * stride + col], k in order: the
// RPT rows of group q of a state stored transposed, (K, kRows); w in
// shared or global memory. The loads of KC k at a time are issued before
// their FMAs, so that their latency is paid once a chunk and not once a k;
// fewer at kWide rows a thread, whose registers 1024 threads a block leave
// few.
template <int RPT>
__device__ __forceinline__ void matvec(float (&acc)[RPT], const float* __restrict__ s, int q,
                                       const float* __restrict__ w, int stride, int col,
                                       int K) {
  constexpr int KC = RPT == kWide ? 2 : 8;
  const float* sq = s + q * RPT;
  const float* wc = w + col;
  int k = 0;
  for (; k + KC <= K; k += KC) {
    float wk[KC], v[KC][RPT];
#pragma unroll
    for (int u = 0; u < KC; ++u) {
      wk[u] = wc[(k + u) * stride];
      Rows<RPT>::load(sq + (k + u) * kRows, v[u]);
    }
#pragma unroll
    for (int u = 0; u < KC; ++u)
#pragma unroll
      for (int i = 0; i < RPT; ++i) acc[i] = fmaf(v[u][i], wk[u], acc[i]);
  }
  for (; k < K; ++k) {
    float v[RPT];
    Rows<RPT>::load(sq + k * kRows, v);
    const float wk = wc[k * stride];
#pragma unroll
    for (int i = 0; i < RPT; ++i) acc[i] = fmaf(v[i], wk, acc[i]);
  }
}

// The largest length, capped at T, among the block's rows.
__device__ __forceinline__ int block_steps(const int* __restrict__ lengths, int row0, int B,
                                           int T) {
  int lmax = 0;
  for (int r = 0; r < kRows; ++r)
    if (row0 + r < B) lmax = max(lmax, min(lengths[row0 + r], T));
  return lmax;
}

// Zeros in dst[row, t, 0:W] for the block's rows and t in [t0, T).
__device__ __forceinline__ void zero_tail(float* __restrict__ dst, int row0, int B, int T, int W,
                                          int t0) {
  if (dst == nullptr || t0 >= T) return;
  const int n = (T - t0) * W;
  for (int r = 0; r < kRows && row0 + r < B; ++r) {
    float* p = dst + ((size_t)(row0 + r) * T + t0) * W;
    for (int i = threadIdx.x; i < n; i += blockDim.x) p[i] = 0.f;
  }
}

// Forward. proj (B, T, 3H): P's u, r and c parts; att (B, T) for agru and
// augru; ug (H, 2H), uc (H, H); writes outs (B, T, H), h_final (B, H) and,
// with kSave, gates (B, T, 3H): u, r, c; hprev (B, T, H): h before the
// step; rh (B, T, H): r*h; zeros at padded steps. Thread (j, q): column j
// of the gates (of u and of the candidate, j < H: an "owner"), rows
// RPT q to RPT q + RPT - 1 of the block. U_g and U_c in shared memory, or
// at kWide rows a thread read from global memory.
template <int RPT, int MODE, bool kSave>
__global__ void __launch_bounds__(RPT == kWide ? 2 * kMaxH : 2 * kMaxStaged * kRows / 4, 1)
    gru_seq_fwd_kernel(const float* __restrict__ proj, const float* __restrict__ att,
                       const int* __restrict__ lengths, const float* __restrict__ ug,
                       const float* __restrict__ uc, float* __restrict__ outs,
                       float* __restrict__ h_final, float* __restrict__ gates,
                       float* __restrict__ hprev, float* __restrict__ rh_out, int B, int T,
                       int H) {
  constexpr int RG = kRows / RPT;
  constexpr bool kStaged = RPT != kWide;  // U in shared memory
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int H2 = 2 * H, H3 = 3 * H;
  float* s_ug = smem;                                   // (H, 2H)
  float* s_uc = s_ug + H * H2;                          // (H, H)
  float* s_h = smem + (kStaged ? align4(3 * H * H) : 0);  // (H, kRows): h, transposed
  float* s_rh = s_h + H * kRows;                        // (H, kRows): r*h, transposed
  const float* w_g = kStaged ? s_ug : ug;
  const float* w_c = kStaged ? s_uc : uc;

  const int tid = threadIdx.x;
  const int j = tid % H2, q = tid / H2;
  const bool active = q < RG;
  const bool owner = active && j < H;
  const int row0 = blockIdx.x * kRows;

  if (kStaged) {
    for (int i = tid; i < H * H2; i += blockDim.x) s_ug[i] = ug[i];
    for (int i = tid; i < H * H; i += blockDim.x) s_uc[i] = uc[i];
  }
  for (int i = tid; i < H * kRows; i += blockDim.x) s_h[i] = 0.f;
  const int lmax = block_steps(lengths, row0, B, T);

  int len[RPT];
  const float* prow[RPT];
  const float* arow[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = row0 + q * RPT + i;
    const bool in = active && row < B;
    len[i] = in ? min(lengths[row], T) : 0;
    prow[i] = proj + (size_t)(in ? row : 0) * T * H3;
    arow[i] = (MODE != kGru) ? att + (size_t)(in ? row : 0) * T : nullptr;
  }
  // a step's inputs: P's gate column j and, for owners, P's candidate
  // column j and a_t; this step's (p*) and the next step's (n*), loaded
  // while this step computes
  float pg[RPT], pc[RPT], pa[RPT], ng[RPT], nc[RPT], na[RPT], u[RPT];
  auto load = [&](int t, float (&g)[RPT], float (&c)[RPT], float (&a)[RPT]) {
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const bool v = active && t < len[i];
      const float* p = prow[i] + (size_t)t * H3;
      g[i] = v ? p[j] : 0.f;
      c[i] = (v && owner) ? p[H2 + j] : 0.f;
      a[i] = (MODE != kGru && v && owner) ? arow[i][t] : 0.f;
    }
  };
  load(0, pg, pc, pa);
  __syncthreads();

  for (int t = 0; t < lmax; ++t) {
    load(t + 1, ng, nc, na);
    float acc[RPT];
    // gates: [u, r] = sigmoid(P_g + h U_g)
    if (active) {
#pragma unroll
      for (int i = 0; i < RPT; ++i) acc[i] = pg[i];
      matvec<RPT>(acc, s_h, q, w_g, H2, j, H);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int r = q * RPT + i;
        const bool v = t < len[i];
        const float s = sigmoid(acc[i]);
        if (j < H) {
          u[i] = s;
        } else {
          const float rh = s * s_h[(j - H) * kRows + r];
          s_rh[(j - H) * kRows + r] = v ? rh : 0.f;
          if (kSave && row0 + r < B)
            rh_out[((size_t)(row0 + r) * T + t) * H + j - H] = v ? rh : 0.f;
        }
        if (kSave && row0 + r < B) gates[((size_t)(row0 + r) * T + t) * H3 + j] = v ? s : 0.f;
      }
    }
    __syncthreads();
    // candidate c = tanh(P_c + (r*h) U_c), then h' = (1 - z) h + z c
    if (owner) {
#pragma unroll
      for (int i = 0; i < RPT; ++i) acc[i] = pc[i];
      matvec<RPT>(acc, s_rh, q, w_c, H, j, H);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int r = q * RPT + i;
        if (row0 + r >= B) continue;
        const bool v = t < len[i];
        const float c = tanhf(acc[i]);
        const float h = s_h[j * kRows + r];
        const float z = MODE == kGru ? u[i] : MODE == kAgru ? pa[i] : pa[i] * u[i];
        const float hn = (1.f - z) * h + z * c;
        if (v) s_h[j * kRows + r] = hn;
        const size_t at = ((size_t)(row0 + r) * T + t) * H + j;
        outs[at] = v ? hn : 0.f;
        if (kSave) {
          gates[((size_t)(row0 + r) * T + t) * H3 + H2 + j] = v ? c : 0.f;
          hprev[at] = v ? h : 0.f;
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      pg[i] = ng[i];
      pc[i] = nc[i];
      pa[i] = na[i];
    }
  }
  if (owner) {
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = q * RPT + i;
      if (row0 + r < B) h_final[(size_t)(row0 + r) * H + j] = s_h[j * kRows + r];
    }
  }
  zero_tail(outs, row0, B, T, H, lmax);
  if (kSave) {
    zero_tail(gates, row0, B, T, H3, lmax);
    zero_tail(hprev, row0, B, T, H, lmax);
    zero_tail(rh_out, row0, B, T, H, lmax);
  }
}

// Backward. gates, hprev as the forward saved them; att (B, T) for agru
// and augru; d_outs (B, T, H) and d_hT (B, H), either may be null (zero);
// writes d_pre (B, T, 3H): the gradients of the pre-activations of u, r
// and c (zero for agru's u), and for agru and augru d_att (B, T); zeros at
// padded steps. The gradient of the initial state (zero) is dropped.
// Thread (j, q) as in the forward: owners (j < H) carry dh's column j.
// U_g and U_c transposed in shared memory, or at kWide rows a thread read
// untransposed from global memory (column j of U^T is row j of U).
template <int RPT, int MODE>
__global__ void __launch_bounds__(RPT == kWide ? 2 * kMaxH : 2 * kMaxStaged * kRows / 4, 1)
    gru_seq_bwd_kernel(const float* __restrict__ gates, const float* __restrict__ hprev,
                       const float* __restrict__ att, const int* __restrict__ lengths,
                       const float* __restrict__ ug, const float* __restrict__ uc,
                       const float* __restrict__ d_outs, const float* __restrict__ d_hT,
                       float* __restrict__ d_pre, float* __restrict__ d_att, int B, int T,
                       int H) {
  constexpr int RG = kRows / RPT;
  constexpr bool kStaged = RPT != kWide;  // U in shared memory
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int H2 = 2 * H, H3 = 3 * H, HA = H | 1;
  float* s_ugT = smem;                      // (2H, H): U_g transposed
  float* s_ucT = s_ugT + H2 * H;            // (H, H): U_c transposed
  float* s_dcp = smem + (kStaged ? align4(3 * H * H) : 0);  // (H, kRows): dc_pre, transposed
  float* s_dup = s_dcp + H * kRows;         // (H, kRows): du_pre
  float* s_drp = s_dup + H * kRows;         // (H, kRows): dr_pre
  float* s_pu = s_drp + H * kRows;          // (H, kRows): du_pre U_gu^T
  float* s_att = s_pu + H * kRows;          // (2, kRows, H|1): a_t's terms, by parity

  const int tid = threadIdx.x;
  const int j = tid % H2, q = tid / H2;
  const bool active = q < RG;
  const bool owner = active && j < H;
  const bool other = active && j >= H;
  const int jo = j - H;
  const int row0 = blockIdx.x * kRows;

  if (kStaged) {
    for (int i = tid; i < H * H2; i += blockDim.x) {  // ug (H, 2H) -> (2H, H)
      const int a = i / H2, b = i % H2;
      s_ugT[b * H + a] = ug[i];
    }
    for (int i = tid; i < H * H; i += blockDim.x) {
      const int a = i / H, b = i % H;
      s_ucT[b * H + a] = uc[i];
    }
  }
  // U_c^T, U_gu^T and U_gr^T as matvec reads them: column c of each at
  // w + c * cs (+ k * ws for its k-th entry)
  const float* w_c = kStaged ? s_ucT : uc;
  const float* w_gu = kStaged ? s_ugT : ug;
  const float* w_gr = kStaged ? s_ugT + H * H : ug + H;
  const int ws = kStaged ? H : 1, cs_c = kStaged ? 1 : H, cs_g = kStaged ? 1 : H2;
  const int lmax = block_steps(lengths, row0, B, T);

  int len[RPT];
  size_t base[RPT];  // the row's offset in (B, T) units
  float dh[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = row0 + q * RPT + i;
    const bool in = active && row < B;
    len[i] = in ? min(lengths[row], T) : 0;
    base[i] = (size_t)(in ? row : 0) * T;
    dh[i] = (owner && in && d_hT != nullptr) ? d_hT[(size_t)row * H + j] : 0.f;
  }
  // a step's saved values (owners): this step's (c*) and the next (earlier)
  // step's (n*), loaded while this step computes
  float cu[RPT], cr[RPT], cc[RPT], ch[RPT], cd[RPT], ca[RPT];
  float nu[RPT], nr[RPT], nc[RPT], nh[RPT], nd[RPT], na[RPT];
  auto load = [&](int t, float (&u)[RPT], float (&r)[RPT], float (&c)[RPT], float (&h)[RPT],
                  float (&d)[RPT], float (&a)[RPT]) {
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const bool v = owner && t >= 0 && t < len[i];
      const size_t at = base[i] + (t >= 0 ? t : 0);
      u[i] = v ? gates[at * H3 + j] : 0.f;
      r[i] = v ? gates[at * H3 + H + j] : 0.f;
      c[i] = v ? gates[at * H3 + H2 + j] : 0.f;
      h[i] = v ? hprev[at * H + j] : 0.f;
      d[i] = (v && d_outs != nullptr) ? d_outs[at * H + j] : 0.f;
      a[i] = (MODE != kGru && v) ? att[at] : 0.f;
    }
  };
  load(lmax - 1, cu, cr, cc, ch, cd, ca);
  __syncthreads();

  for (int t = lmax - 1; t >= 0; --t) {
    load(t - 1, nu, nr, nc, nh, nd, na);
    float* s_a = s_att + (t & 1) * kRows * HA;
    float dpart[RPT];
    // elementwise: dc_pre, du_pre and a_t's terms
    if (owner) {
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int r = q * RPT + i;
        const bool v = t < len[i];
        const float dhn = dh[i] + cd[i];
        const float z = MODE == kGru ? cu[i] : MODE == kAgru ? ca[i] : ca[i] * cu[i];
        const float dz = dhn * (cc[i] - ch[i]);
        const float dcp = dhn * z * (1.f - cc[i] * cc[i]);
        dpart[i] = dhn * (1.f - z);
        float dup = 0.f;
        if (MODE == kGru) dup = dz * cu[i] * (1.f - cu[i]);
        if (MODE == kAugru) dup = dz * ca[i] * cu[i] * (1.f - cu[i]);
        if (MODE != kGru) s_a[r * HA + j] = v ? (MODE == kAgru ? dz : dz * cu[i]) : 0.f;
        s_dcp[j * kRows + r] = v ? dcp : 0.f;
        s_dup[j * kRows + r] = v ? dup : 0.f;
        if (row0 + r < B) {
          float* d = d_pre + (base[i] + t) * H3;
          d[j] = v ? dup : 0.f;
          d[H2 + j] = v ? dcp : 0.f;
        }
      }
    }
    __syncthreads();
    if (owner) {  // drh = dc_pre U_c^T; dr_pre
      float acc[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) acc[i] = 0.f;
      matvec<RPT>(acc, s_dcp, q, w_c, ws, j * cs_c, H);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int r = q * RPT + i;
        const bool v = t < len[i];
        const float drp = acc[i] * ch[i] * cr[i] * (1.f - cr[i]);
        dpart[i] += acc[i] * cr[i];
        s_drp[j * kRows + r] = v ? drp : 0.f;
        if (row0 + r < B) d_pre[(base[i] + t) * H3 + H + j] = v ? drp : 0.f;
      }
    } else if (other) {  // the update gate's share of dh: du_pre U_gu^T
      float acc[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) acc[i] = 0.f;
      matvec<RPT>(acc, s_dup, q, w_gu, ws, jo * cs_g, H);
#pragma unroll
      for (int i = 0; i < RPT; ++i) s_pu[jo * kRows + q * RPT + i] = acc[i];
    }
    __syncthreads();
    if (owner) {  // dh = (1 - z) dh' + drh * r + du_pre U_gu^T + dr_pre U_gr^T
      float acc[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) acc[i] = s_pu[j * kRows + q * RPT + i];
      matvec<RPT>(acc, s_drp, q, w_gr, ws, j * cs_g, H);
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        if (t < len[i]) dh[i] = dpart[i] + acc[i];
    } else if (MODE != kGru && other) {  // d a_t: a row's terms summed in column order
      for (int r = jo + q * H; r < kRows && row0 + r < B; r += RG * H) {
        float sum = 0.f;
        for (int k = 0; k < H; ++k) sum += s_a[r * HA + k];
        d_att[(size_t)(row0 + r) * T + t] = sum;
      }
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      cu[i] = nu[i]; cr[i] = nr[i]; cc[i] = nc[i];
      ch[i] = nh[i]; cd[i] = nd[i]; ca[i] = na[i];
    }
  }
  zero_tail(d_pre, row0, B, T, H3, lmax);
  if (MODE != kGru) zero_tail(d_att, row0, B, T, 1, lmax);
}

// Rows a thread: 2 up to H = 64 (2H * 4 threads a block, at most 512),
// 4 up to 128 (2H * 2, at most 512), 8 above (2H, at most 1024 at
// H = 512), the bounds __launch_bounds__ states.
int rows_per_thread(int H) { return H <= 64 ? 2 : H <= kMaxStaged ? 4 : kWide; }

// Floats of shared memory for U: U_g and U_c where they fit, else none.
size_t staged(int H) { return H <= kMaxStaged ? (size_t)align4(3 * H * H) : 0; }

int threads_for(int H) { return (2 * H * (kRows / rows_per_thread(H)) + 31) / 32 * 32; }

size_t fwd_smem(int H) { return sizeof(float) * (staged(H) + 2 * (size_t)H * kRows); }

size_t bwd_smem(int H) {
  return sizeof(float) * (staged(H) + 4 * (size_t)H * kRows + 2 * (size_t)kRows * (H | 1));
}

template <int RPT, int MODE>
cudaError_t launch_fwd(const float* proj, const float* att, const int* lengths, const float* ug,
                       const float* uc, float* outs, float* h_final, float* gates,
                       float* hprev, float* rh, int B, int T, int H, int device,
                       cudaStream_t stream) {
  auto kernel = gates != nullptr ? gru_seq_fwd_kernel<RPT, MODE, true>
                                 : gru_seq_fwd_kernel<RPT, MODE, false>;
  return launch_kernel(kernel, (B + kRows - 1) / kRows, threads_for(H), fwd_smem(H), device,
                       stream, proj, att, lengths, ug, uc, outs, h_final, gates, hprev, rh, B, T,
                       H);
}

template <int RPT, int MODE>
cudaError_t launch_bwd(const float* gates, const float* hprev, const float* att,
                       const int* lengths, const float* ug, const float* uc,
                       const float* d_outs, const float* d_hT, float* d_pre, float* d_att,
                       int B, int T, int H, int device, cudaStream_t stream) {
  return launch_kernel(gru_seq_bwd_kernel<RPT, MODE>, (B + kRows - 1) / kRows, threads_for(H),
                       bwd_smem(H), device, stream, gates, hprev, att, lengths, ug, uc, d_outs,
                       d_hT, d_pre, d_att, B, T, H);
}

cudaError_t check_args(int B, int T, int H, int mode, const float* att) {
  if (B < 1 || T < 1 || H < 1 || H > kMaxH || mode < kGru || mode > kAugru ||
      (mode != kGru && att == nullptr))
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

// LAUNCH(RPT, MODE) for the runtime `mode` (gru, agru, augru).
#define BY_MODE(LAUNCH, RPT) \
  (mode == kGru ? LAUNCH(RPT, kGru) : mode == kAgru ? LAUNCH(RPT, kAgru) : LAUNCH(RPT, kAugru))

}  // namespace

// proj (B, T, 3H), att (B, T) or null for gru, lengths (B,) int32, ug
// (H, 2H), uc (H, H), outs (B, T, H), h_final (B, H); gates (B, T, 3H),
// hprev and rh (B, T, H), all three or none (a forward that saves nothing
// for a backward); f32 (but lengths), contiguous, on `device`; 1 <= H <= 512;
// mode 0 gru, 1 agru, 2 augru; a length past T counts as T. Launches on
// `stream`; returns a cudaError_t.
extern "C" int gru_seq_fwd(const float* proj, const float* att, const int* lengths,
                           const float* ug, const float* uc, float* outs, float* h_final,
                           float* gates, float* hprev, float* rh, int B, int T, int H,
                           int mode, int device, void* stream) {
  cudaError_t err = check_args(B, T, H, mode, att);
  if (err != cudaSuccess) return (int)err;
  if ((gates == nullptr) != (hprev == nullptr) || (gates == nullptr) != (rh == nullptr))
    return (int)cudaErrorInvalidValue;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  auto s = static_cast<cudaStream_t>(stream);
#define GRU_SEQ_FWD(RPT, MODE) \
  launch_fwd<RPT, MODE>(proj, att, lengths, ug, uc, outs, h_final, gates, hprev, rh, B, T, H, \
                        device, s)
  switch (rows_per_thread(H)) {
    case 2: return (int)BY_MODE(GRU_SEQ_FWD, 2);
    case 4: return (int)BY_MODE(GRU_SEQ_FWD, 4);
    default: return (int)BY_MODE(GRU_SEQ_FWD, kWide);
  }
#undef GRU_SEQ_FWD
}

// gates (B, T, 3H), hprev (B, T, H) as gru_seq_fwd saved them; att (B, T)
// or null for gru; lengths (B,) int32; ug (H, 2H), uc (H, H); d_outs
// (B, T, H) and d_hT (B, H), or null for zero; d_pre (B, T, 3H); d_att
// (B, T) for agru and augru, else ignored. The same types, layouts and
// limits as gru_seq_fwd.
extern "C" int gru_seq_bwd(const float* gates, const float* hprev, const float* att,
                           const int* lengths, const float* ug, const float* uc,
                           const float* d_outs, const float* d_hT, float* d_pre, float* d_att,
                           int B, int T, int H, int mode, int device, void* stream) {
  cudaError_t err = check_args(B, T, H, mode, att);
  if (err != cudaSuccess) return (int)err;
  if (mode != kGru && d_att == nullptr) return (int)cudaErrorInvalidValue;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  auto s = static_cast<cudaStream_t>(stream);
#define GRU_SEQ_BWD(RPT, MODE) \
  launch_bwd<RPT, MODE>(gates, hprev, att, lengths, ug, uc, d_outs, d_hT, d_pre, d_att, B, T, H, \
                        device, s)
  switch (rows_per_thread(H)) {
    case 2: return (int)BY_MODE(GRU_SEQ_BWD, 2);
    case 4: return (int)BY_MODE(GRU_SEQ_BWD, 4);
    default: return (int)BY_MODE(GRU_SEQ_BWD, kWide);
  }
#undef GRU_SEQ_BWD
}
