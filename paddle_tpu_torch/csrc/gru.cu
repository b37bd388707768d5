// Fused whole-sequence GRU for Hopper (sm_90a), float32: forward (lean
// and residual-saving), BPTT backward, and the dW_gate / dW_state
// products, every recurrent product on the tensor cores in 3xTF32.
//
// Replaces: paddle_tpu/ops/pallas/gru.py :: gru_fused
//   forward  pallas_call at :129 (body _fwd_kernel :36, step _step :25)
//   backward pallas_call at :155 (body _bwd_kernel :59; its in-body
//   dW_gate / dW_state accumulation :95-101 is gru_dw_kernel here)
//
// Computes, per step t with gate order [u, r, c] (xs holds the input
//   projection plus bias, time-major [T, B, 3D]):
//     u = sigmoid(x_u + h_{t-1} W_gate[:, :D]);  r = sigmoid(x_r + h_{t-1} W_gate[:, D:])
//     c~ = tanh(x_c + (r h_{t-1}) W_state);  h_new = h_{t-1} + u (c~ - h_{t-1})
//     h_t = mask ? h_new : h_{t-1}
//   with h_{-1} = 0.  hs holds the CARRIED h, acts the u, r, c~ of the
//   computed step even where the mask is 0 -- the TPU kernel's contract.
//   The backward follows _bwd_kernel line for line: dgates = [dug, drg] m,
//   dxs = [dgates, dccg m], dh carried as m dh_prev + (1 - m) dh.  Takes
//   any T >= 1, B >= 1 and D a multiple of 128 up to 768: every (B, D)
//   the route's rule admits.
//
// Bound on this card: operations.  At the training shape (T=30, B=64,
//   D=512) the recurrent products are 2.9 GFLOP forward and 5.8 GFLOP
//   backward with dW against ~31 / ~38 MB moved: 0.018 / 0.035 ms at
//   TF32's dense rate over 3 (3xTF32, below), 0.044 / 0.087 ms as float32
//   SIMT.  What a step pays besides is two grid barriers and the L2 round
//   trips for the rows other SMs wrote.
//
// Products: mma.sync.m16n8k8 TF32 instructions in the 3xTF32 split of
//   csrc/simple_rnn.cu: each float32 operand x is split into big = x
//   rounded to TF32 and small = x - big (the tensor cores truncate it),
//   a b = a_small b_big + a_big b_small + a_big b_big.  Each k-step's three
//   products go to three fresh tiles, issued together, summed in float32
//   and added to the float32 accumulator.
//
// Design: the TPU kernel's grid IS the time loop, with W_gate and W_state
//   (3 MB at D=512) resident in VMEM.  No SM holds them here, so each
//   recurrence is ONE persistent cooperative launch with two
//   cooperative_groups grid.sync() a step:
//   - CTA (u, g) owns hidden units [16u, 16u + 16) and the 16-row
//     b-blocks g, g + NG, g + 2 NG, ... of the batch: D / 16 unit blocks
//     times NG b-groups, NG as many as stay co-resident (up to the batch's
//     b-blocks): at D=512, B=64 that is 32 x 4 = 128 CTAs, one an SM.  A
//     CTA loops over its b-blocks where B is large; a b-block past B
//     zero-fills its rows (B % 16 = 8 leaves half an m16 tile).
//   - A b-block's product is one m16 tile over NT n-tiles of the CTA's
//     resident slice ([n][k] rows at pitch K + 4: a warp's B-fragment
//     reads hit 32 banks), the operand's 16 rows staged in 128-column
//     chunks through a 3-stage cp.async ring (through L2 only: other SMs
//     wrote them before the barrier), so a CTA reads only its own rows.
//     The 8 warps are 8 k-groups; k-group q walks k-steps [2q, 2q + 2) of
//     every chunk, and the groups' partial tiles meet in shared memory,
//     summed in a fixed order (bit for bit the same every run).  One
//     thread a (row, unit) then runs the cell, its inputs loaded before
//     the product so that their latency hides behind it.
//   - Forward, resident: the CTA's 32 columns of W_gate (its u and r
//     columns) and 16 of W_state, 99 KB at D=512, 170 KB at D=768.  Per
//     step, phase A stages the b-block's rows of h_{t-1} = hs[t - 1],
//     forms the m16 x n32 product, then u and r of its cells; u stays in
//     shared memory (a slot for each b-block the CTA walks: the same
//     thread finishes the cell) and s = r h_{t-1} goes to sbuf; barrier;
//     phase B stages the rows of s, forms the m16 x n16 product with
//     W_state, then c~ and h_t into hs[t] (mask merged); barrier.  At t = 0, h_{-1} = 0 skips both
//     products and the first barrier; the last step needs no second:
//     2 (T - 1) barriers.  One s buffer is safe: phase A of step t + 1
//     writes it only after the barrier that ends every CTA's phase B of
//     step t.
//   - Backward, resident: the CTA's 16 rows of W_gate (16 x 2D) and of
//     W_state (16 x D).  Over reversed time, phase 1 (own cells) forms
//     dh = carry + dh_out[t], dug m and dccg m into dxs[t]; barrier;
//     phase 2 stages the b-block's rows of dxs[t]'s c columns, forms
//     ds = dccg m W_state^T, then drg m into dxs[t], part = dh (1 - u) +
//     ds r and r h_{t-1} into s_all[t - 1] (dW_state's operand); barrier;
//     phase 3 stages the rows of dgates = dxs[t][:, :2D], forms dgates
//     W_gate^T, merges dh_prev = part + it with the mask into the carry
//     and at once runs step t - 1's phase 1 (own columns of dxs[t - 1],
//     which no CTA reads before the next barrier).  At t = 0, h_{-1} = 0
//     makes drg 0 and dh_{-1} is not needed: 2 (T - 1) barriers.  ds may
//     use the masked dccg: where m = 0 every use of ds is masked away.
//   - dh_buf (the carry) and part are [B, D] scratch read and written by
//     their owner thread only.
//   - dW_gate = sum_t h_{t-1}^T dgates_t and dW_state = sum_t s_t^T
//     dccg_m,t have no recurrence: after the loop, one 3xTF32 tiled
//     product over the [(T-1) B, .] operands (h_{-1} = 0 drops t = 0),
//     128 x 64 tiles of 8 warps over 32-row chunks in a 3-stage ring, the
//     two products' tiles in one grid.  K is split across up to
//     kDwSplits CTAs a tile where they stay co-resident: one cooperative
//     launch whose splits add their partial tiles into dW in split order,
//     a grid barrier between two, no atomics.
//   Later work (ROADMAP B10): barriers over a b-group's CTAs alone,
//   sharing a b-block's rows across a cluster, wgmma with TMA loads.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;          // 8 warps; one thread a (row, unit) of a b-block
constexpr int kWarps = kThreads / 32;
constexpr int kUnits = 16;             // hidden units a CTA owns
constexpr int kRows = 16;              // batch rows of a b-block: one m16 tile
constexpr int kMaxD = 768;

// A b-block's product: NT n-tiles (all in every warp) over K, the rows in
// 128-column chunks through a 3-stage ring, the 8 warps 8 k-groups of 2
// k-steps a chunk.
constexpr int kChunk = 128;                  // columns a staged chunk
constexpr int kStages = 3;                   // ring depth
constexpr int kKs = kChunk / 8 / kWarps;     // k-steps a warp a chunk
constexpr int kAP = kChunk + 4;              // staged row pitch
constexpr int kStage = kRows * kAP;
constexpr int kMaxNt = 4;                    // phase A: the u and r columns
constexpr int kPP = kMaxNt * 8 + 4;          // partial tile row pitch
constexpr int kPart = kWarps * kRows * kPP;  // the k-groups' partial tiles
constexpr int kRegion = kStages * kStage > kPart ? kStages * kStage : kPart;  // ring, then tiles

struct Args {
  const float* xs;       // [T, B, 3D]
  const float* mask;     // [T, B]
  const float* w_gate;   // [D, 2D]
  const float* w_state;  // [D, D]
  float* hs;             // [T, B, D]
  float* acts;           // [T, B, 3D]; null in the lean forward
  float* sbuf;           // [B, D]: the step's s = r h_{t-1}
  const float* dh_out;   // [T, B, D]
  float* dxs;            // [T, B, 3D]
  float* dh_buf;         // [B, D]: the dh carry, own cells
  float* part;           // [B, D]: dh (1 - u) + ds r, own cells
  float* s_all;          // [T - 1, B, D]: r_t h_{t-1} for t >= 1
  int T, B, D;
  int NG;                // b-groups
};

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// x = big + small as two TF32 operands (csrc/flash_attention.cu)
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = __float_as_uint(x) + 0x1000u;
  small = __float_as_uint(x - __uint_as_float(big & 0xffffe000u));
}

// d += a b on one m16n8k8 TF32 tile
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in 3xTF32 for one k-step of 8, B already split: the three
// products each in a fresh tile, issued together (no product waits on
// another), summed small terms first and added to d in float32
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4], uint32_t bb0, uint32_t bs0,
                                     uint32_t bb1, uint32_t bs1) {
  float s0[4] = {0.f, 0.f, 0.f, 0.f}, s1[4] = {0.f, 0.f, 0.f, 0.f};
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(s0, as, bb0, bb1);
  mma_tf32(s1, ab, bs0, bs1);
  mma_tf32(t, ab, bb0, bb1);
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] += (s0[i] + s1[i]) + t[i];
}

// 16 bytes global -> shared through L2 only; valid = false zero-fills
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The partial products of one b-block: part[q][r][n] (at region, pitch
// kPP) = the sum over k-group q's k-steps of A[r0 + r][k] w[n][k], rows
// r >= rows zero, n < NT * 8.  A is global with row stride lda (read
// through L2); w is the resident slice [NT * 8][K + 4].  Ends with a
// __syncthreads: the partial tiles are complete and the ring is free.
template <int NT>
__device__ __forceinline__ void product(const float* A, int lda, int K, int r0, int rows,
                                        const float* w, float* region) {
  constexpr int KC = kChunk, S = kStages;
  const int tid = threadIdx.x, kq = tid >> 5, lane = tid & 31;  // k-group = warp
  const int g = lane >> 2, t4 = lane & 3;
  const int wp = K + 4, nk = K / KC;
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  auto load = [&](int kc) {
    float* s = region + (kc % S) * kStage;
    for (int e = tid; e < kRows * (KC / 4); e += kThreads) {
      const int r = e / (KC / 4), c = (e % (KC / 4)) * 4;
      const bool ok = r < rows;
      cp_async16(s + r * kAP + c, A + (size_t)(r0 + (ok ? r : 0)) * lda + kc * KC + c, ok);
    }
  };
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < nk) load(s);
    cp_async_commit();
  }
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<S - 2>();  // chunk kc landed (this thread's copies)
    __syncthreads();         // ... and every thread's; chunk kc - 1 consumed
    if (kc + S - 1 < nk) load(kc + S - 1);
    cp_async_commit();
    const float* ac = region + (kc % S) * kStage + g * kAP + t4;
    const float* wc = w + (size_t)g * wp + kc * KC + t4;
#pragma unroll
    for (int k8 = 0; k8 < kKs; ++k8) {
      const int kk = (kq * kKs + k8) * 8;
      const float* ar = ac + kk;
      uint32_t ab[4], as[4];
      split(ar[0], ab[0], as[0]);
      split(ar[8 * kAP], ab[1], as[1]);
      split(ar[4], ab[2], as[2]);
      split(ar[8 * kAP + 4], ab[3], as[3]);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float* wr = wc + (size_t)n * 8 * wp + kk;
        uint32_t bb0, bs0, bb1, bs1;
        split(wr[0], bb0, bs0);
        split(wr[4], bb1, bs1);
        mma3(acc[n], ab, as, bb0, bs0, bb1, bs1);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every chunk consumed before the partial tiles overwrite the ring
  float* pt = region + (kq * kRows + g) * kPP + 2 * t4;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    *reinterpret_cast<float2*>(pt + n * 8) = make_float2(acc[n][0], acc[n][1]);
    *reinterpret_cast<float2*>(pt + 8 * kPP + n * 8) = make_float2(acc[n][2], acc[n][3]);
  }
  __syncthreads();
}

// column n of a b-block's partial tiles, the k-groups summed first to last
__device__ __forceinline__ float part_sum(const float* region, int r, int n) {
  const float* p = region + r * kPP + n;
  float s = p[0];
#pragma unroll
  for (int q = 1; q < kWarps; ++q) s += p[q * kRows * kPP];
  return s;
}

template <bool kResid>
__global__ void __launch_bounds__(kThreads) gru_fwd_kernel(Args p) {
  extern __shared__ __align__(16) float smem[];
  cg::grid_group grid = cg::this_grid();
  const int T = p.T, B = p.B, D = p.D, G = 3 * D;
  const int nu = D / kUnits, nbb = (B + kRows - 1) / kRows;
  const int u0 = (blockIdx.x % nu) * kUnits, bg = blockIdx.x / nu;
  const int wp = D + 4, tid = threadIdx.x;
  float* wg = smem;                  // [32][D + 4]: wg[n][k] = W_gate[k][(n / 16) D + u0 + n % 16]
  float* ws = wg + 2 * kUnits * wp;  // [16][D + 4]: ws[n][k] = W_state[k][u0 + n]
  float* region = ws + kUnits * wp;
  float* uslots = region + kRegion;  // [b-blocks the CTA walks][256]: u of its cells
  for (int e = tid; e < D * 2 * kUnits; e += kThreads) {
    const int k = e / (2 * kUnits), n = e % (2 * kUnits);
    wg[n * wp + k] = p.w_gate[(size_t)k * 2 * D + (n / kUnits) * D + u0 + n % kUnits];
  }
  for (int e = tid; e < D * kUnits; e += kThreads) {
    const int k = e / kUnits, n = e % kUnits;
    ws[n * wp + k] = p.w_state[(size_t)k * D + u0 + n];
  }
  // this thread's cell in a b-block: (row cr, unit cu)
  const int cr = tid / kUnits, cu = tid % kUnits, col = u0 + cu;
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const float* hprev = p.hs + (size_t)(t > 0 ? t - 1 : 0) * B * D;
    // phase A: u and r of the CTA's cells, s = r h_{t-1} for its b-group
    for (int bb = bg; bb < nbb; bb += p.NG) {
      const int r0 = bb * kRows, rows = min(kRows, B - r0);
      const bool mine = cr < rows;
      const int b = r0 + (mine ? cr : 0);
      const size_t xrow = ((size_t)t * B + b) * G, hidx = (size_t)b * D + col;
      // the cell's inputs are loaded before the product, which hides
      // their latency
      float xu = 0.f, xr = 0.f, hp = 0.f;
      if (mine) {
        xu = p.xs[xrow + col];
        xr = p.xs[xrow + D + col];
        if (t > 0) hp = hprev[hidx];  // written by this thread at t - 1
      }
      if (t > 0) product<4>(hprev, D, D, r0, rows, wg, region);  // h_{-1} = 0 at t = 0
      if (mine) {
        const float u = sigmoid(xu + (t > 0 ? part_sum(region, cr, cu) : 0.f));
        const float r = sigmoid(xr + (t > 0 ? part_sum(region, cr, kUnits + cu) : 0.f));
        uslots[(bb - bg) / p.NG * kThreads + tid] = u;
        p.sbuf[hidx] = r * hp;
        if (kResid) {
          p.acts[xrow + col] = u;
          p.acts[xrow + D + col] = r;
        }
      }
      __syncthreads();  // the partial tiles read before the next b-block's ring loads
    }
    if (t > 0) grid.sync();  // s complete on every SM (at t = 0 it is not read)
    // phase B: c~ and h_t of the CTA's cells
    for (int bb = bg; bb < nbb; bb += p.NG) {
      const int r0 = bb * kRows, rows = min(kRows, B - r0);
      const bool mine = cr < rows;
      const int b = r0 + (mine ? cr : 0);
      const size_t xrow = ((size_t)t * B + b) * G, hidx = (size_t)b * D + col;
      float xc = 0.f, m = 0.f, hp = 0.f, u = 0.f;
      if (mine) {
        xc = p.xs[xrow + 2 * D + col];
        m = p.mask[(size_t)t * B + b];
        if (t > 0) hp = hprev[hidx];
        u = uslots[(bb - bg) / p.NG * kThreads + tid];  // written by this thread in phase A
      }
      if (t > 0) product<2>(p.sbuf, D, D, r0, rows, ws, region);
      if (mine) {
        const float cc = tanhf(xc + (t > 0 ? part_sum(region, cr, cu) : 0.f));
        const float hn = hp + u * (cc - hp);
        p.hs[(size_t)t * B * D + hidx] = m * hn + (1.f - m) * hp;
        if (kResid) p.acts[xrow + 2 * D + col] = cc;
      }
      __syncthreads();
    }
    if (t + 1 < T) grid.sync();  // hs[t] complete on every SM before step t+1
  }
}

// step t's first half for one cell: dh = carry + dh_out[t], the update
// and candidate columns of dxs[t] (drg = 0 at t = 0, where h_{-1} = 0),
// dh into the carry.  Inputs loaded by the caller.
__device__ __forceinline__ void bwd_phase1(const Args& p, int t, int b, int col, float carry,
                                           float dho, float u, float cc, float hp, float m) {
  const int D = p.D, G = 3 * D;
  const float dh = carry + dho;
  const float dug = dh * (cc - hp) * u * (1.f - u);
  const float dccg = dh * u * (1.f - cc * cc);
  float* dx = p.dxs + ((size_t)t * p.B + b) * G;
  dx[col] = dug * m;
  dx[2 * D + col] = dccg * m;
  if (t == 0) dx[D + col] = 0.f;
  p.dh_buf[(size_t)b * D + col] = dh;
}

__global__ void __launch_bounds__(kThreads) gru_bwd_kernel(Args p) {
  extern __shared__ __align__(16) float smem[];
  cg::grid_group grid = cg::this_grid();
  const int T = p.T, B = p.B, D = p.D, G = 3 * D;
  const int nu = D / kUnits, nbb = (B + kRows - 1) / kRows;
  const int u0 = (blockIdx.x % nu) * kUnits, bg = blockIdx.x / nu;
  const int tid = threadIdx.x, gp = 2 * D + 4, sp = D + 4;
  float* wgr = smem;                // [16][2D + 4]: wgr[n][k] = W_gate[u0 + n][k]
  float* wsr = wgr + kUnits * gp;   // [16][D + 4]: wsr[n][k] = W_state[u0 + n][k]
  float* region = wsr + kUnits * sp;
  for (int e = tid; e < kUnits * (2 * D / 4); e += kThreads) {
    const int n = e / (2 * D / 4), k = (e % (2 * D / 4)) * 4;
    *reinterpret_cast<float4*>(wgr + n * gp + k) =
        *reinterpret_cast<const float4*>(p.w_gate + (size_t)(u0 + n) * 2 * D + k);
  }
  for (int e = tid; e < kUnits * (D / 4); e += kThreads) {
    const int n = e / (D / 4), k = (e % (D / 4)) * 4;
    *reinterpret_cast<float4*>(wsr + n * sp + k) =
        *reinterpret_cast<const float4*>(p.w_state + (size_t)(u0 + n) * D + k);
  }
  const int cr = tid / kUnits, cu = tid % kUnits, col = u0 + cu;
  const size_t BD = (size_t)B * D;
  __syncthreads();

  // step T-1's first half: the carry starts at 0
  for (int bb = bg; bb < nbb; bb += p.NG) {
    const int b = bb * kRows + cr;
    if (b < B) {
      const size_t arow = ((size_t)(T - 1) * B + b) * G, hidx = (size_t)b * D + col;
      bwd_phase1(p, T - 1, b, col, 0.f, p.dh_out[(T - 1) * BD + hidx], p.acts[arow + col],
                 p.acts[arow + 2 * D + col], T > 1 ? p.hs[(T - 2) * BD + hidx] : 0.f,
                 p.mask[(size_t)(T - 1) * B + b]);
    }
  }
  for (int t = T - 1; t > 0; --t) {  // dh_{-1} is not needed
    grid.sync();                     // dug m and dccg m of step t complete on every SM
    float* dx = p.dxs + (size_t)t * B * G;
    // phase 2: ds = dccg m W_state^T for the CTA's units; the reset columns
    for (int bb = bg; bb < nbb; bb += p.NG) {
      const int r0 = bb * kRows, rows = min(kRows, B - r0);
      const bool mine = cr < rows;
      const int b = r0 + (mine ? cr : 0);
      const size_t arow = ((size_t)t * B + b) * G, hidx = (size_t)b * D + col;
      float u = 0.f, r = 0.f, hp = 0.f, m = 0.f, dh = 0.f;
      if (mine) {
        u = p.acts[arow + col];
        r = p.acts[arow + D + col];
        hp = p.hs[(t - 1) * BD + hidx];
        m = p.mask[(size_t)t * B + b];
        dh = p.dh_buf[hidx];
      }
      product<2>(dx + 2 * D, G, D, r0, rows, wsr, region);
      if (mine) {
        const float ds = part_sum(region, cr, cu);
        const float drg = ds * hp * r * (1.f - r);
        dx[(size_t)b * G + D + col] = drg * m;
        p.part[hidx] = dh * (1.f - u) + ds * r;
        p.s_all[(t - 1) * BD + hidx] = r * hp;
      }
      __syncthreads();  // the partial tiles read before the next b-block's ring loads
    }
    grid.sync();  // dgates of step t complete on every SM
    // phase 3: dh_prev = part + dgates W_gate^T merged with the mask into
    // the carry, then step t-1's first half
    for (int bb = bg; bb < nbb; bb += p.NG) {
      const int r0 = bb * kRows, rows = min(kRows, B - r0);
      const bool mine = cr < rows;
      const int b = r0 + (mine ? cr : 0);
      const size_t arow = ((size_t)(t - 1) * B + b) * G, hidx = (size_t)b * D + col;
      // every load of the cell first: step t's mask, dh and part, step
      // t-1's inputs, their latencies hidden behind the product
      float m = 0.f, dh = 0.f, pt = 0.f, dho = 0.f, u1 = 0.f, cc1 = 0.f, hp1 = 0.f, m1 = 0.f;
      if (mine) {
        m = p.mask[(size_t)t * B + b];
        dh = p.dh_buf[hidx];
        pt = p.part[hidx];
        dho = p.dh_out[(t - 1) * BD + hidx];
        u1 = p.acts[arow + col];
        cc1 = p.acts[arow + 2 * D + col];
        if (t > 1) hp1 = p.hs[(t - 2) * BD + hidx];
        m1 = p.mask[(size_t)(t - 1) * B + b];
      }
      product<2>(dx, G, 2 * D, r0, rows, wgr, region);
      if (mine) {
        const float dhp = pt + part_sum(region, cr, cu);
        bwd_phase1(p, t - 1, b, col, m * dhp + (1.f - m) * dh, dho, u1, cc1, hp1, m1);
      }
      __syncthreads();
    }
  }
}

// dw[M][N] = sum_k a[k][m] g[k][n] for the two products of the
// backward, each operand row-major over k with its own row stride, in
// 3xTF32: 128 x 64 tiles, 8 warps of 32 x 32, 32-row k chunks through a
// 3-stage ring (rows past K zero); M a multiple of 128, N of 64.  CTA i
// takes tile i % tiles (product 0's tiles first) and split i / tiles of
// KS: the chunks [s nk / KS, (s + 1) nk / KS).  Split 0 writes its tile,
// then split s adds its own after the s-th grid barrier.
constexpr int kDwM = 128, kDwN = 64, kDwK = 32, kDwStages = 3;
constexpr int kDwAP = kDwM + 8, kDwBP = kDwN + 8;  // pitches = 8 (mod 32): conflict-free fragments
constexpr int kDwStage = kDwK * (kDwAP + kDwBP);
constexpr size_t kDwSmem = sizeof(float) * kDwStages * kDwStage;
constexpr int kDwSplits = 8;  // the most K-splits of a tile

struct DwProduct {
  const float* a;  // [K][lda], columns [0, M)
  const float* g;  // [K][ldg], columns [0, N)
  float* out;      // [M][N]
  int lda, ldg, M, N;
};

struct DwArgs {
  DwProduct prod[2];
  int tiles0, tiles;  // product 0's tiles; both products'
  int K, KS;
};

__global__ void __launch_bounds__(256) gru_dw_kernel(DwArgs q) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t4 = lane & 3;
  const int K = q.K, KS = q.KS;
  const int tile_all = blockIdx.x % q.tiles, split_id = blockIdx.x / q.tiles;
  const bool second = tile_all >= q.tiles0;
  const DwProduct pr = second ? q.prod[1] : q.prod[0];
  const int tile = second ? tile_all - q.tiles0 : tile_all;
  const int tiles_n = pr.N / kDwN;
  const int m0 = (tile / tiles_n) * kDwM, n0 = (tile % tiles_n) * kDwN;
  const int wm = (warp % 4) * 32, wn = (warp / 4) * 32;
  const int nk = (K + kDwK - 1) / kDwK;
  const int c0 = (int)((long long)split_id * nk / KS);
  const int c1 = (int)((long long)(split_id + 1) * nk / KS);
  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  auto load = [&](int kc) {
    float* a = smem + ((kc - c0) % kDwStages) * kDwStage;
    float* b = a + kDwK * kDwAP;
    const int k0 = kc * kDwK;
    for (int e = tid; e < kDwK * (kDwM / 4); e += 256) {
      const int r = e / (kDwM / 4), c = (e % (kDwM / 4)) * 4;
      const bool ok = k0 + r < K;
      cp_async16(a + r * kDwAP + c, pr.a + (size_t)(ok ? k0 + r : 0) * pr.lda + m0 + c, ok);
    }
    for (int e = tid; e < kDwK * (kDwN / 4); e += 256) {
      const int r = e / (kDwN / 4), c = (e % (kDwN / 4)) * 4;
      const bool ok = k0 + r < K;
      cp_async16(b + r * kDwBP + c, pr.g + (size_t)(ok ? k0 + r : 0) * pr.ldg + n0 + c, ok);
    }
  };
#pragma unroll
  for (int s = 0; s < kDwStages - 1; ++s) {
    if (c0 + s < c1) load(c0 + s);
    cp_async_commit();
  }
  for (int kc = c0; kc < c1; ++kc) {
    cp_async_wait<kDwStages - 2>();
    __syncthreads();
    if (kc + kDwStages - 1 < c1) load(kc + kDwStages - 1);
    cp_async_commit();
    const float* a = smem + ((kc - c0) % kDwStages) * kDwStage;
    const float* b = a + kDwK * kDwAP;
#pragma unroll
    for (int k8 = 0; k8 < kDwK / 8; ++k8) {
      uint32_t ab[2][4], as[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {  // A[m][k] = a[k][m]
        const float* ar = a + (k8 * 8 + t4) * kDwAP + wm + i * 16 + gq;
        split(ar[0], ab[i][0], as[i][0]);
        split(ar[8], ab[i][1], as[i][1]);
        split(ar[4 * kDwAP], ab[i][2], as[i][2]);
        split(ar[4 * kDwAP + 8], ab[i][3], as[i][3]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* br = b + (k8 * 8 + t4) * kDwBP + wn + j * 8 + gq;
        uint32_t bb0, bs0, bb1, bs1;
        split(br[0], bb0, bs0);
        split(br[4 * kDwBP], bb1, bs1);
#pragma unroll
        for (int i = 0; i < 2; ++i) mma3(acc[i][j], ab[i], as[i], bb0, bs0, bb1, bs1);
      }
    }
  }
  cp_async_wait<0>();
  // the splits' partial tiles meet in split order: a fixed sum, no atomics
  for (int s = 0; s < KS; ++s) {
    if (s == split_id) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int row = m0 + wm + i * 16 + gq, c = n0 + wn + j * 8 + 2 * t4;
          float2* o0 = reinterpret_cast<float2*>(pr.out + (size_t)row * pr.N + c);
          float2* o1 = reinterpret_cast<float2*>(pr.out + (size_t)(row + 8) * pr.N + c);
          float2 v0 = make_float2(acc[i][j][0], acc[i][j][1]);
          float2 v1 = make_float2(acc[i][j][2], acc[i][j][3]);
          if (s > 0) {
            const float2 p0 = __ldcg(o0), p1 = __ldcg(o1);
            v0 = make_float2(p0.x + v0.x, p0.y + v0.y);
            v1 = make_float2(p1.x + v1.x, p1.y + v1.y);
          }
          *o0 = v0;
          *o1 = v1;
        }
    }
    if (s + 1 < KS) cg::this_grid().sync();  // split s's sum in dW before split s+1 adds
  }
}

// grid.sync() alone, `syncs` times, at the forward's launch shape: a
// probe for the cost of the barriers (chip_smoke.py times it), since a
// step's time cannot tell barriers from products.
__global__ void __launch_bounds__(kThreads) gru_barrier_kernel(int syncs) {
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < syncs; ++i) grid.sync();
}

// with `slots` u slots (the b-blocks a CTA walks)
size_t fwd_smem(int D, int slots) {
  return sizeof(float) * ((size_t)3 * kUnits * (D + 4) + kRegion + (size_t)slots * kThreads);
}
size_t bwd_smem(int D) {
  return sizeof(float) * ((size_t)kUnits * (2 * D + 4 + D + 4) + kRegion);
}

bool shape_ok(int T, int B, int D) {
  return T >= 1 && B >= 1 && D >= 128 && D % 128 == 0 && D <= kMaxD;
}

// {SM count, cooperative launch support, CTAs of kern resident on an SM}
cudaError_t occupancy(const void* kern, int threads, size_t smem, int& sms, int& coop,
                      int& per_sm) {
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  int dev = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  if ((e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess)
    return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, smem);
}

// The b-groups of a recurrence launch of `kern`: as many as stay
// co-resident beside the D / 16 unit blocks (up to the batch's b-blocks).
cudaError_t b_groups(const void* kern, size_t smem, int B, int D, int& ng) {
  int sms = 0, coop = 0, per_sm = 0;
  cudaError_t e = occupancy(kern, kThreads, smem, sms, coop, per_sm);
  if (e != cudaSuccess) return e;
  const int nu = D / kUnits, nbb = (B + kRows - 1) / kRows, cap = per_sm * sms;
  if (!coop || cap < nu) return cudaErrorCooperativeLaunchTooLarge;
  ng = nbb < cap / nu ? nbb : cap / nu;
  return cudaSuccess;
}

// The forward's b-groups and shared memory: a CTA keeps u of every
// b-block it walks (ceil(b-blocks / NG) slots), so NG is the most
// b-groups whose CTAs stay co-resident with the slots that many need.
cudaError_t fwd_grid(const void* kern, int B, int D, int& ng, size_t& smem) {
  const int nbb = (B + kRows - 1) / kRows;
  for (ng = nbb;;) {
    smem = fwd_smem(D, (nbb + ng - 1) / ng);
    int fit = 0;
    cudaError_t e = b_groups(kern, smem, B, D, fit);
    if (e != cudaSuccess || fit >= ng) return e;
    ng = fit;  // fewer b-groups, more slots a CTA: check again
  }
}

// One launch of D / 16 x p.NG CTAs; b_groups or fwd_grid checked that
// they are co-resident, as a cooperative launch needs.
cudaError_t coop_launch(const void* kern, size_t smem, Args& p, cudaStream_t st) {
  void* args[] = {&p};
  cudaError_t e = cudaLaunchCooperativeKernel(kern, dim3(p.D / kUnits * p.NG), dim3(kThreads),
                                              args, smem, st);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// dW_gate = hs[0 : T-1]^T dgates[1 : T] and dW_state = s_all^T
// dccg_m[1 : T]: KS K-splits a tile, as many as stay co-resident up to
// kDwSplits and the K chunks (one: a plain launch)
int dw_product(const float* hs, const float* dxs, const float* s_all, float* dwg, float* dws,
               int T, int B, int D, cudaStream_t st) {
  const void* kern = reinterpret_cast<const void*>(gru_dw_kernel);
  int sms = 0, coop = 0, per_sm = 0;
  cudaError_t e = occupancy(kern, 256, kDwSmem, sms, coop, per_sm);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int G = 3 * D;
  const float* g = dxs + (size_t)B * G;  // step 1's first row
  DwArgs q{};
  q.prod[0] = {hs, g, dwg, D, G, D, 2 * D};
  q.prod[1] = {s_all, g + 2 * D, dws, D, G, D, D};
  q.tiles0 = (D / kDwM) * (2 * D / kDwN);
  q.tiles = q.tiles0 + (D / kDwM) * (D / kDwN);
  q.K = (T - 1) * B;
  const int nk = (q.K + kDwK - 1) / kDwK;
  int KS = coop ? per_sm * sms / q.tiles : 1;
  KS = KS < kDwSplits ? KS : kDwSplits;
  KS = KS < nk ? KS : nk;
  q.KS = KS > 1 ? KS : 1;
  if (q.KS == 1) {
    gru_dw_kernel<<<q.tiles, 256, kDwSmem, st>>>(q);
    return static_cast<int>(cudaGetLastError());
  }
  void* args[] = {&q};
  e = cudaLaunchCooperativeKernel(kern, dim3(q.tiles * q.KS), dim3(256), args, kDwSmem, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each entry returns the first failing cudaError_t of its launches (0 =
// launched).  D a multiple of 128 up to 768, any T, B >= 1; the caller
// checks shapes.  sbuf is [B, D] scratch; acts may be null when
// save_residuals is 0.
extern "C" int gru_fwd_f32(const float* xs, const float* mask, const float* w_gate,
                           const float* w_state, float* hs, float* acts, float* sbuf, int T,
                           int B, int D, int save_residuals, void* stream) {
  if (!shape_ok(T, B, D)) return static_cast<int>(cudaErrorInvalidValue);
  Args p{};
  p.xs = xs, p.mask = mask, p.w_gate = w_gate, p.w_state = w_state;
  p.hs = hs, p.acts = acts, p.sbuf = sbuf;
  p.T = T, p.B = B, p.D = D;
  const void* kern = save_residuals ? reinterpret_cast<const void*>(gru_fwd_kernel<true>)
                                    : reinterpret_cast<const void*>(gru_fwd_kernel<false>);
  size_t smem = 0;
  const cudaError_t e = fwd_grid(kern, B, D, p.NG, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(coop_launch(kern, smem, p, static_cast<cudaStream_t>(stream)));
}

// BPTT over reversed time, then dW_gate and dW_state.  dh_buf / part are
// [B, D] scratch, s_all [T - 1, B, D] scratch (dW_state's operand).
extern "C" int gru_bwd_f32(const float* acts, const float* hs, const float* w_gate,
                           const float* w_state, const float* mask, const float* dh_out,
                           float* dxs, float* dwg, float* dws, float* dh_buf, float* part,
                           float* s_all, int T, int B, int D, void* stream) {
  if (!shape_ok(T, B, D)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Args p{};
  p.mask = mask, p.w_gate = w_gate, p.w_state = w_state;
  p.hs = const_cast<float*>(hs), p.acts = const_cast<float*>(acts);
  p.dh_out = dh_out, p.dxs = dxs, p.dh_buf = dh_buf, p.part = part, p.s_all = s_all;
  p.T = T, p.B = B, p.D = D;
  const void* kern = reinterpret_cast<const void*>(gru_bwd_kernel);
  cudaError_t e = b_groups(kern, bwd_smem(D), B, D, p.NG);
  if (e == cudaSuccess) e = coop_launch(kern, bwd_smem(D), p, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  return dw_product(hs, dxs, s_all, dwg, dws, T, B, D, st);
}

// `syncs` grid-wide barriers in one cooperative launch of the grid the
// forward takes at (B, D): its CTA count, threads and shared memory.
extern "C" int gru_barrier_probe(int syncs, int B, int D, void* stream) {
  if (!shape_ok(1, B, D)) return static_cast<int>(cudaErrorInvalidValue);
  size_t smem = 0;
  int ng = 0;
  cudaError_t e = fwd_grid(reinterpret_cast<const void*>(gru_fwd_kernel<true>), B, D, ng, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const void* kern = reinterpret_cast<const void*>(gru_barrier_kernel);
  if ((e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem))) != cudaSuccess)
    return static_cast<int>(e);
  void* args[] = {&syncs};
  e = cudaLaunchCooperativeKernel(kern, dim3(D / kUnits * ng), dim3(kThreads), args, smem,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
