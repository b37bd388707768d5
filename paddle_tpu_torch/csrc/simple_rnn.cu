// Fused whole-sequence vanilla RNN for Hopper (sm_90a): the forward, the
// BPTT backward and the dW product, every product on the tensor cores in
// 3xTF32, with an instance for each pair of float32, bf16 or float16 xs and W.
//
// Replaces: paddle_tpu/ops/pallas/simple_rnn.py :: simple_rnn_fused
//   forward  pallas_call at :74 (body _fwd_kernel :22)
//   backward pallas_call at :92 (body _bwd_kernel :40; its in-body dW
//   accumulator :62-64 is simple_rnn_dw_kernel here)
//
// Computes (the reference RecurrentLayer, xs holding the input
//   projection plus bias, time-major [T, B, D]):
//     h_t = m_t tanh(x_t + h_{t-1} W) + (1 - m_t) h_{t-1},  h_{-1} = 0
//   hs[t] = h_t at every step, masked steps included (the frozen carry):
//   hs is the output and the backward's only residual.  The backward,
//   over reversed time with carry dh = 0:
//     dh <- dh + dh_out[t];  dg = dh (1 - h_t^2) m_t;  dxs[t] = dg
//     dh <- m_t (dg W^T) + (1 - m_t) dh
//   and dW = sum_t h_{t-1}^T dg_t (h_{-1} = 0 drops t = 0).  Takes any
//   T >= 1, B >= 1 and D a multiple of 128 up to 1280: every (B, D) the
//   route's rule admits.
//
// Bound on this card: operations.  At the training shape (T=100, B=64,
//   D=512) each recurrence is 2 (T - 1) B D^2 = 3.3 GFLOP against ~27 MB
//   moved once (0.008 ms), and dW the same 3.3 GFLOP: 0.020 ms a product
//   at TF32's dense rate over 3 (3xTF32, below), 0.050 ms as float32 SIMT.
//   What a step pays besides is a grid barrier and an L2 round trip for
//   the rows other SMs wrote.
//
// Products: mma.sync.m16n8k8 TF32 instructions in the 3xTF32 split of
//   csrc/lstm.cu: each float32 operand x is split into big = x rounded to
//   TF32 and small = x - big (the tensor cores truncate it), a b =
//   a_small b_big + a_big b_small + a_big b_big.  Each k-step's three
//   products go to three fresh tiles, issued together, summed in float32
//   and added to the float32 accumulator: chained in the tensor cores
//   they truncate every sum, and chained in one fresh tile each waits on
//   the last (measured slower: the step products are latency-bound).
//
// Design: the TPU kernel's grid IS the time loop, with W (1 MB at D=512)
//   resident in VMEM.  No SM holds W here, so each recurrence is ONE
//   persistent cooperative launch with one cooperative_groups grid.sync()
//   a step:
//   - CTA (u, g) owns hidden units [16u, 16u + 16) and the 16-row
//     b-blocks g, g + NG, g + 2 NG, ... of the batch: D / 16 unit blocks
//     times NG b-groups, NG as many as stay co-resident (up to the batch's
//     b-blocks): at D=512, B=64 that is 32 x 4 = 128 CTAs.  A CTA loops
//     over its b-blocks where B is large.
//   - The CTA's slice of W stays in shared memory for the launch as
//     [n][k] rows at pitch D + 4 (a warp's B-fragment reads hit 32
//     banks): the forward's 16 columns of W (h_{t-1} W), the backward's
//     16 rows (dg_t W^T); 32 KB at D=512, 80 KB at D=1280.
//   - A step's product for one b-block is one m16 tile over 2 n-tiles,
//     the operand's 16 rows staged in 128-column chunks through a 3-stage
//     cp.async ring (through L2 only: other SMs wrote them before the
//     barrier), so a CTA reads only its own rows: a quarter of the L2
//     traffic of owning every row at B=64.  The 8 warps are 8 k-groups;
//     k-group q walks k-steps [2q, 2q + 2) of every chunk, and the
//     groups' partial tiles meet in shared memory, summed in a fixed
//     order (bit for bit the same every run).  One thread a (row, unit)
//     then runs the cell, its inputs loaded before the product so that
//     their latency hides behind it.
//   - Forward: step t stages h_{t-1} = hs[t - 1] and writes hs[t]; at
//     t = 0, h_{-1} = 0 skips the product.
//   - Backward: dg_t is as wide as h, so no K-split: after step t's
//     barrier the CTA stages its rows of dg_t = dxs[t], forms dh_prev for
//     its units, merges it with the mask into the carry and at once runs
//     step t - 1's first half: dh, dg into dxs[t - 1] (own columns, which
//     no CTA reads before the next barrier; slower CTAs still read
//     dxs[t]).  One barrier a step.  The carry (dh_buf) is read and
//     written by its owner thread only.
//   - dW has no recurrence: after the loop, a 3xTF32 tiled product over
//     the [(T-1) B, D] operands hs[0 : T-1] and dxs[1 : T], 128 x 64
//     tiles of 8 warps over 32-row chunks in a 3-stage ring.  At D=512
//     there are 32 tiles for 132 SMs, so K is split across up to
//     kDwSplits CTAs a tile (as many as stay co-resident): one
//     cooperative launch whose splits add their partial tiles into dW in
//     split order, a grid barrier between two, no atomics.
//   Later work (ROADMAP B11): barriers over a b-group's CTAs alone,
//   sharing a b-block's rows across a cluster, wgmma with TMA loads.
//
// Element types (the JAX kernels under the bf16 or float16 policy): xs (and with it
//   hs, dh_out, dxs) is XT, W (and dW) is WT, each float, bf16 or float16 (the
//   policy casts every weight: float or bf16 xs with a bf16 W; a direct
//   call may pass bf16 xs with a float W).  Every
//   operand is widened to float32 on load: W into the resident slice, a
//   bf16 row 8 values a 16-byte load; xs, hs and dh_out in the cell; hs
//   in dW's ring.  Carries, gates and products are float32 as in the
//   float32 instance, whose arithmetic this is.  The recurrence reads
//   the float32 h (the TPU kernel's VMEM carry), so a bf16 instance
//   keeps it in hc ([T, B, D] float32) and writes hs rounded once; the
//   backward keeps dg float32 in dg (the step product's and dW's
//   operand) and writes dxs rounded once.  dW sums in float32 (its
//   K-splits' partial tiles in dw32) and the last split writes it
//   rounded once to WT.  For float XT / WT, hc, dg and dw32 are hs, dxs
//   and dw themselves: the float32 instance.  Later work: a bf16 W is
//   exact in TF32, so its small term in the 3xTF32 split is zero.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;          // 8 warps; one thread a (row, unit) of a b-block
constexpr int kWarps = kThreads / 32;
constexpr int kUnits = 16;             // hidden units a CTA owns
constexpr int kRows = 16;              // batch rows of a b-block: one m16 tile

// One b-block's step product: the 16 x 16 tile (2 n-tiles, both in every
// warp) over K = D of the resident slice, the rows in 128-column chunks
// through a 3-stage ring, the 8 warps 8 k-groups of 2 k-steps a chunk.
constexpr int kNt = kUnits / 8;              // n-tiles
constexpr int kChunk = 128;                  // columns a staged chunk
constexpr int kStages = 3;                   // ring depth
constexpr int kKs = kChunk / 8 / kWarps;     // k-steps a warp a chunk
constexpr int kAP = kChunk + 4;              // staged row pitch
constexpr int kStage = kRows * kAP;
constexpr int kPP = kUnits + 4;              // partial tile row pitch
constexpr int kRegion = kStages * kStage;    // the ring, then the partial tiles
static_assert(kRegion >= kWarps * kRows * kPP, "the partial tiles fit in the ring");

using bf16 = __nv_bfloat16;
using f16 = __half;

template <typename XT, typename WT>
struct Args {
  const XT* xs;         // [T, B, D]
  const float* mask;    // [T, B]
  const WT* w;          // [D, D]
  XT* hs;               // [T, B, D]
  float* hc;            // [T, B, D] float32 carried h (hs where XT is float)
  const XT* dh_out;     // [T, B, D]
  XT* dxs;              // [T, B, D]
  float* dg;            // [T, B, D] float32 dg (dxs where XT is float)
  float* dh_buf;        // [B, D], the dh carry
  int T, B, D;
  int NG;               // b-groups
};

template <typename T>
__host__ __device__ constexpr bool is_f32() {
  return std::is_same<T, float>::value;
}
__device__ __forceinline__ float wide(float x) { return x; }
__device__ __forceinline__ float wide(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void put(bf16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ float wide(f16 x) { return __half2float(x); }
__device__ __forceinline__ void put(f16* p, float v) { *p = __float2half_rn(v); }
// two adjacent outputs rounded once to the element type
__device__ __forceinline__ void put2(float* p, float2 v) { *reinterpret_cast<float2*>(p) = v; }
__device__ __forceinline__ void put2(bf16* p, float2 v) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __float22bfloat162_rn(v);
}
__device__ __forceinline__ void put2(f16* p, float2 v) {
  *reinterpret_cast<__half2*>(p) = __float22half2_rn(v);
}

// the 16 bytes at src (16-byte aligned) widened to 16 / sizeof(T) floats
// at dst (16-byte aligned)
__device__ __forceinline__ void widen16(float* dst, const float* src) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
}
__device__ __forceinline__ void widen16(float* dst, const bf16* src) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  const float2 c = __bfloat1622float2(h[2]), d = __bfloat1622float2(h[3]);
  reinterpret_cast<float4*>(dst)[0] = make_float4(a.x, a.y, b.x, b.y);
  reinterpret_cast<float4*>(dst)[1] = make_float4(c.x, c.y, d.x, d.y);
}
__device__ __forceinline__ void widen16(float* dst, const f16* src) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const __half2* h = reinterpret_cast<const __half2*>(&u);
  const float2 a = __half22float2(h[0]), b = __half22float2(h[1]);
  const float2 c = __half22float2(h[2]), d = __half22float2(h[3]);
  reinterpret_cast<float4*>(dst)[0] = make_float4(a.x, a.y, b.x, b.y);
  reinterpret_cast<float4*>(dst)[1] = make_float4(c.x, c.y, d.x, d.y);
}

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
// a ring slot's 16 source bytes: float rows asynchronously; bf16 rows
// (written by an earlier launch) 8 values loaded, widened and stored,
// visible to the CTA at the ring's next __syncthreads
__device__ __forceinline__ void stage16(float* dst, const float* src, bool valid) {
  cp_async16(dst, src, valid);
}
template <typename T>  // bf16 or float16
__device__ __forceinline__ void stage16(float* dst, const T* src, bool valid) {
  if (valid) {
    widen16(dst, src);
  } else {
    reinterpret_cast<float4*>(dst)[0] = make_float4(0.f, 0.f, 0.f, 0.f);
    reinterpret_cast<float4*>(dst)[1] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
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
// r >= rows zero.  A is global with row stride lda (read through L2); w is
// the resident slice [16][K + 4].  Ends with a __syncthreads: the partial
// tiles are complete and the ring is free.
__device__ __forceinline__ void product(const float* A, int lda, int K, int r0, int rows,
                                        const float* w, float* region) {
  constexpr int KC = kChunk, S = kStages;
  const int tid = threadIdx.x, kq = tid >> 5, lane = tid & 31;  // k-group = warp
  const int g = lane >> 2, t4 = lane & 3;
  const int wp = K + 4, nk = K / KC;
  float acc[kNt][4];
#pragma unroll
  for (int n = 0; n < kNt; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

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
      for (int n = 0; n < kNt; ++n) {
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
  for (int n = 0; n < kNt; ++n) {
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

template <typename XT, typename WT>
__global__ void __launch_bounds__(kThreads) simple_rnn_fwd_kernel(Args<XT, WT> p) {
  extern __shared__ __align__(16) float smem[];
  cg::grid_group grid = cg::this_grid();
  const int T = p.T, B = p.B, D = p.D;
  const int nu = D / kUnits, nbb = (B + kRows - 1) / kRows;
  const int u0 = (blockIdx.x % nu) * kUnits, bg = blockIdx.x / nu;
  const int wp = D + 4, tid = threadIdx.x;
  float* w = smem;                  // [16][D + 4]: w[n][k] = W[k][u0 + n]
  float* region = smem + kUnits * wp;
  constexpr int V = 16 / sizeof(WT);  // W values a 16-byte load
  for (int e = tid; e < D * (kUnits / V); e += kThreads) {
    const int k = e / (kUnits / V), n0 = (e % (kUnits / V)) * V;
    alignas(16) float v[V];
    widen16(v, p.w + (size_t)k * D + u0 + n0);
#pragma unroll
    for (int j = 0; j < V; ++j) w[(n0 + j) * wp + k] = v[j];
  }
  // this thread's cell in a b-block: (row cr, unit cu)
  const int cr = tid / kUnits, cu = tid % kUnits, col = u0 + cu;
  const bool cell = tid < kRows * kUnits;
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const float* hprev = p.hc + (size_t)(t > 0 ? t - 1 : 0) * B * D;
    for (int bb = bg; bb < nbb; bb += p.NG) {
      const int r0 = bb * kRows, rows = min(kRows, B - r0);
      const bool mine = cell && cr < rows;
      const int b = r0 + (mine ? cr : 0);
      const size_t hidx = (size_t)b * D + col;
      const size_t tidx = (size_t)t * B * D + hidx;
      // the cell's inputs are loaded before the product, which hides
      // their latency
      float x = 0.f, m = 0.f, hp = 0.f;
      if (mine) {
        x = wide(p.xs[tidx]);
        m = p.mask[(size_t)t * B + b];
        if (t > 0) hp = hprev[hidx];  // written by this thread at t - 1
      }
      if (t > 0) product(hprev, D, D, r0, rows, w, region);  // h_{-1} = 0 at t = 0
      if (mine) {
        const float g = t > 0 ? part_sum(region, cr, cu) : 0.f;
        const float h = m * tanhf(x + g) + (1.f - m) * hp;
        p.hc[tidx] = h;
        if constexpr (!is_f32<XT>()) put(p.hs + tidx, h);
      }
      __syncthreads();  // the partial tiles read before the next b-block's ring loads
    }
    if (t + 1 < T) grid.sync();  // hs[t] complete on every SM before step t+1
  }
}

template <typename XT, typename WT>
__global__ void __launch_bounds__(kThreads) simple_rnn_bwd_kernel(Args<XT, WT> p) {
  extern __shared__ __align__(16) float smem[];
  cg::grid_group grid = cg::this_grid();
  const int T = p.T, B = p.B, D = p.D;
  const int nu = D / kUnits, nbb = (B + kRows - 1) / kRows;
  const int u0 = (blockIdx.x % nu) * kUnits, bg = blockIdx.x / nu;
  const int wp = D + 4, tid = threadIdx.x;
  float* w = smem;                  // [16][D + 4]: w[n][k] = W[u0 + n][k]
  float* region = smem + kUnits * wp;
  constexpr int V = 16 / sizeof(WT);  // W values a 16-byte load
  for (int e = tid; e < kUnits * (D / V); e += kThreads) {
    const int n = e / (D / V), k = (e % (D / V)) * V;
    widen16(w + n * wp + k, p.w + (size_t)(u0 + n) * D + k);
  }
  const int cr = tid / kUnits, cu = tid % kUnits, col = u0 + cu;
  const bool cell = tid < kRows * kUnits;
  __syncthreads();

  // step T-1's first half: dh = dh_out (the carry starts at 0)
  for (int bb = bg; bb < nbb; bb += p.NG) {
    const int b = bb * kRows + cr;
    if (cell && b < B) {
      const size_t tidx = ((size_t)(T - 1) * B + b) * D + col;
      const float dh = wide(p.dh_out[tidx]), h = wide(p.hs[tidx]);
      const float dg = dh * (1.f - h * h) * p.mask[(size_t)(T - 1) * B + b];
      p.dg[tidx] = dg;
      if constexpr (!is_f32<XT>()) put(p.dxs + tidx, dg);
      p.dh_buf[(size_t)b * D + col] = dh;
    }
  }
  for (int t = T - 1; t > 0; --t) {  // dh_{-1} is not needed
    grid.sync();                     // dg_t complete on every SM
    const float* dg = p.dg + (size_t)t * B * D;
    for (int bb = bg; bb < nbb; bb += p.NG) {
      const int r0 = bb * kRows, rows = min(kRows, B - r0);
      const bool mine = cell && cr < rows;
      const int b = r0 + (mine ? cr : 0);
      const size_t hidx = (size_t)b * D + col;
      const size_t pidx = (size_t)(t - 1) * B * D + hidx;
      // every load of the cell first: step t's mask and dh, step t-1's
      // inputs, their latencies hidden behind the product
      float m = 0.f, dh = 0.f, dho = 0.f, h = 0.f, m1 = 0.f;
      if (mine) {
        m = p.mask[(size_t)t * B + b];
        dh = p.dh_buf[hidx];
        dho = wide(p.dh_out[pidx]);
        h = wide(p.hs[pidx]);
        m1 = p.mask[(size_t)(t - 1) * B + b];
      }
      product(dg, D, D, r0, rows, w, region);
      if (mine) {
        // the carry into step t-1, then that step's first half
        const float carry = m * part_sum(region, cr, cu) + (1.f - m) * dh;
        const float dh1 = carry + dho;
        const float dg1 = dh1 * (1.f - h * h) * m1;
        p.dg[pidx] = dg1;
        if constexpr (!is_f32<XT>()) put(p.dxs + pidx, dg1);
        p.dh_buf[hidx] = dh1;
      }
      __syncthreads();  // the partial tiles read before the next b-block's ring loads
    }
  }
}

// dw[M][N] = sum_k h[k][m] g[k][n], both operands row-major over k (h =
// hs[0:T-1] of element type AT, g = dg[1:T], each as [K, D]), in 3xTF32:
// 128 x 64 tiles, 8 warps of 32 x 32, 32-row k chunks through a 3-stage
// ring (rows past K zero); D a multiple of 128.  CTA i takes tile i %
// tiles and split i / tiles of KS: the chunks [s nk / KS, (s + 1) nk /
// KS).  Split 0 writes its tile into the float32 sum acc, then split s
// adds its own after the s-th grid barrier; the last split writes the
// total to out in OT (acc and out are one buffer where OT is float).
constexpr int kDwM = 128, kDwN = 64, kDwK = 32, kDwStages = 3;
constexpr int kDwAP = kDwM + 8, kDwBP = kDwN + 8;  // pitches = 8 (mod 32): conflict-free fragments
constexpr int kDwStage = kDwK * (kDwAP + kDwBP);
constexpr size_t kDwSmem = sizeof(float) * kDwStages * kDwStage;
constexpr int kDwSplits = 8;  // the most K-splits of a tile

template <typename AT, typename OT>
__global__ void __launch_bounds__(256) simple_rnn_dw_kernel(const AT* __restrict__ h,
                                                            const float* __restrict__ g,
                                                            float* acc_sum, OT* out, int K, int D,
                                                            int KS) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t4 = lane & 3;
  const int tiles_n = D / kDwN, tiles = tiles_n * (D / kDwM);
  const int tile = blockIdx.x % tiles, split_id = blockIdx.x / tiles;
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
    constexpr int VA = 16 / sizeof(AT);  // h values a 16-byte load
    for (int e = tid; e < kDwK * (kDwM / VA); e += 256) {
      const int r = e / (kDwM / VA), c = (e % (kDwM / VA)) * VA;
      const bool ok = k0 + r < K;
      stage16(a + r * kDwAP + c, h + (size_t)(ok ? k0 + r : 0) * D + m0 + c, ok);
    }
    for (int e = tid; e < kDwK * (kDwN / 4); e += 256) {
      const int r = e / (kDwN / 4), c = (e % (kDwN / 4)) * 4;
      const bool ok = k0 + r < K;
      cp_async16(b + r * kDwBP + c, g + (size_t)(ok ? k0 + r : 0) * D + n0 + c, ok);
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
  for (int q = 0; q < KS; ++q) {
    if (q == split_id) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int row = m0 + wm + i * 16 + gq, c = n0 + wn + j * 8 + 2 * t4;
          const size_t i0 = (size_t)row * D + c, i1 = (size_t)(row + 8) * D + c;
          float2* o0 = reinterpret_cast<float2*>(acc_sum + i0);
          float2* o1 = reinterpret_cast<float2*>(acc_sum + i1);
          float2 v0 = make_float2(acc[i][j][0], acc[i][j][1]);
          float2 v1 = make_float2(acc[i][j][2], acc[i][j][3]);
          if (q > 0) {
            const float2 p0 = __ldcg(o0), p1 = __ldcg(o1);
            v0 = make_float2(p0.x + v0.x, p0.y + v0.y);
            v1 = make_float2(p1.x + v1.x, p1.y + v1.y);
          }
          if (is_f32<OT>() || q + 1 < KS) {
            *o0 = v0;
            *o1 = v1;
          } else {
            put2(out + i0, v0);
            put2(out + i1, v1);
          }
        }
    }
    if (q + 1 < KS) cg::this_grid().sync();  // split q's sum in dw before split q+1 adds
  }
}

size_t step_smem(int D) { return sizeof(float) * ((size_t)kUnits * (D + 4) + kRegion); }

// D <= 1280 keeps step_smem under 108 KB
bool shape_ok(int T, int B, int D) {
  return T >= 1 && B >= 1 && D >= 128 && D % 128 == 0 && D <= 1280;
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

// A cooperative launch fails unless every CTA can be resident at once:
// D / 16 unit blocks times as many b-groups as then fit (up to the
// batch's b-blocks).
template <class A>
cudaError_t coop_launch(const void* kern, A& p, cudaStream_t st) {
  const size_t smem = step_smem(p.D);
  int sms = 0, coop = 0, per_sm = 0;
  cudaError_t e = occupancy(kern, kThreads, smem, sms, coop, per_sm);
  if (e != cudaSuccess) return e;
  const int nu = p.D / kUnits, nbb = (p.B + kRows - 1) / kRows, cap = per_sm * sms;
  if (!coop || cap < nu) return cudaErrorCooperativeLaunchTooLarge;
  p.NG = nbb < cap / nu ? nbb : cap / nu;
  void* args[] = {&p};
  e = cudaLaunchCooperativeKernel(kern, dim3(nu * p.NG), dim3(kThreads), args, smem, st);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// dW = hs[0 : T-1]^T dg[1 : T]: KS K-splits a tile, as many as stay
// co-resident up to kDwSplits and the K chunks (one: a plain launch)
template <typename AT, typename OT>
int dw_product(const AT* hs, const float* dg, float* acc, OT* out, int T, int B, int D,
               cudaStream_t st) {
  const void* kern = reinterpret_cast<const void*>(simple_rnn_dw_kernel<AT, OT>);
  int sms = 0, coop = 0, per_sm = 0;
  cudaError_t e = occupancy(kern, 256, kDwSmem, sms, coop, per_sm);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles = (D / kDwM) * (D / kDwN), nk = ((T - 1) * B + kDwK - 1) / kDwK;
  int K = (T - 1) * B, KS = coop ? per_sm * sms / tiles : 1;
  KS = KS < kDwSplits ? KS : kDwSplits;
  KS = KS < nk ? KS : nk;
  KS = KS > 1 ? KS : 1;
  const float* g = dg + (size_t)B * D;
  if (KS == 1) {
    simple_rnn_dw_kernel<AT, OT><<<tiles, 256, kDwSmem, st>>>(hs, g, acc, out, K, D, 1);
    return static_cast<int>(cudaGetLastError());
  }
  void* args[] = {&hs, &g, &acc, &out, &K, &D, &KS};
  e = cudaLaunchCooperativeKernel(kern, dim3(tiles * KS), dim3(256), args, kDwSmem, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename XT, typename WT>
int fwd(const XT* xs, const float* mask, const WT* w, XT* hs, float* hc, int T, int B, int D,
        void* stream) {
  if (!shape_ok(T, B, D)) return static_cast<int>(cudaErrorInvalidValue);
  Args<XT, WT> p{};
  p.xs = xs, p.mask = mask, p.w = w, p.hs = hs, p.hc = hc;
  p.T = T, p.B = B, p.D = D;
  return static_cast<int>(coop_launch(
      reinterpret_cast<const void*>(simple_rnn_fwd_kernel<XT, WT>), p,
      static_cast<cudaStream_t>(stream)));
}

template <typename XT, typename WT>
int bwd(const XT* hs, const WT* w, const float* mask, const XT* dh_out, XT* dxs, WT* dw_out,
        float* dh_buf, float* dg, float* dw32, int T, int B, int D, void* stream) {
  if (!shape_ok(T, B, D)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Args<XT, WT> p{};
  p.mask = mask, p.w = w, p.hs = const_cast<XT*>(hs);
  p.dh_out = dh_out, p.dxs = dxs, p.dg = dg, p.dh_buf = dh_buf;
  p.T = T, p.B = B, p.D = D;
  const int rc = static_cast<int>(
      coop_launch(reinterpret_cast<const void*>(simple_rnn_bwd_kernel<XT, WT>), p, st));
  if (rc != 0) return rc;
  return dw_product(hs, dg, dw32, dw_out, T, B, D, st);
}

}  // namespace

// The entries build in parts, one nvcc each, linked into one library
// (ops/kernels/_build.py passes -DPT_PART=k; a build without it defines
// every entry): part 0 the float32 entries, 1 the (xs, W) pairs with a bf16 operand, 2 those with a float16 one and float32, 3 the mixed bf16 / float16 pairs.
#ifndef PT_PART
#define PT_PART -1
#endif
#define PT_IN(k) (PT_PART < 0 || PT_PART == (k))

// Each entry returns the first failing cudaError_t of its launches (0 =
// launched).  D must be a multiple of 128 up to 1280; the caller checks
// shapes.  One signature for every instance: the entries named _f32 take
// float xs and W, those named _x<xs>_w<W> those element types.  hc is
// [T, B, D] float32 scratch (hs itself for float xs), dg likewise (dxs
// itself), dw32 [D, D] float32 (dw itself for a float W).
#if PT_IN(0)
extern "C" int simple_rnn_fwd_f32(const float* xs, const float* mask, const float* w,
                                  float* hs, float* hc, int T, int B, int D, void* stream) {
  return fwd(xs, mask, w, hs, hc, T, B, D, stream);
}
#endif
#if PT_IN(1)
extern "C" int simple_rnn_fwd_xf32_wbf16(const float* xs, const float* mask, const bf16* w,
                                         float* hs, float* hc, int T, int B, int D,
                                         void* stream) {
  return fwd(xs, mask, w, hs, hc, T, B, D, stream);
}
#endif
#if PT_IN(1)
extern "C" int simple_rnn_fwd_xbf16_wbf16(const bf16* xs, const float* mask, const bf16* w,
                                          bf16* hs, float* hc, int T, int B, int D,
                                          void* stream) {
  return fwd(xs, mask, w, hs, hc, T, B, D, stream);
}
#endif
#if PT_IN(1)
extern "C" int simple_rnn_fwd_xbf16_wf32(const bf16* xs, const float* mask, const float* w,
                                         bf16* hs, float* hc, int T, int B, int D,
                                         void* stream) {
  return fwd(xs, mask, w, hs, hc, T, B, D, stream);
}
#endif
#if PT_IN(2)
extern "C" int simple_rnn_fwd_xf32_wf16(const float* xs, const float* mask, const f16* w,
                                         float* hs, float* hc, int T, int B, int D,
                                         void* stream) {
  return fwd(xs, mask, w, hs, hc, T, B, D, stream);
}
#endif
#if PT_IN(2)
extern "C" int simple_rnn_fwd_xf16_wf16(const f16* xs, const float* mask, const f16* w,
                                         f16* hs, float* hc, int T, int B, int D,
                                         void* stream) {
  return fwd(xs, mask, w, hs, hc, T, B, D, stream);
}
#endif
#if PT_IN(2)
extern "C" int simple_rnn_fwd_xf16_wf32(const f16* xs, const float* mask, const float* w,
                                         f16* hs, float* hc, int T, int B, int D,
                                         void* stream) {
  return fwd(xs, mask, w, hs, hc, T, B, D, stream);
}
#endif
#if PT_IN(3)
extern "C" int simple_rnn_fwd_xbf16_wf16(const bf16* xs, const float* mask, const f16* w,
                                         bf16* hs, float* hc, int T, int B, int D,
                                         void* stream) {
  return fwd(xs, mask, w, hs, hc, T, B, D, stream);
}
#endif
#if PT_IN(3)
extern "C" int simple_rnn_fwd_xf16_wbf16(const f16* xs, const float* mask, const bf16* w,
                                         f16* hs, float* hc, int T, int B, int D,
                                         void* stream) {
  return fwd(xs, mask, w, hs, hc, T, B, D, stream);
}
#endif

// BPTT over reversed time, then dW.  dh_buf is [B, D] scratch.
#if PT_IN(0)
extern "C" int simple_rnn_bwd_f32(const float* hs, const float* w, const float* mask,
                                  const float* dh_out, float* dxs, float* dw_out, float* dh_buf,
                                  float* dg, float* dw32, int T, int B, int D, void* stream) {
  return bwd(hs, w, mask, dh_out, dxs, dw_out, dh_buf, dg, dw32, T, B, D, stream);
}
#endif
#if PT_IN(1)
extern "C" int simple_rnn_bwd_xf32_wbf16(const float* hs, const bf16* w, const float* mask,
                                         const float* dh_out, float* dxs, bf16* dw_out,
                                         float* dh_buf, float* dg, float* dw32, int T, int B,
                                         int D, void* stream) {
  return bwd(hs, w, mask, dh_out, dxs, dw_out, dh_buf, dg, dw32, T, B, D, stream);
}
#endif
#if PT_IN(1)
extern "C" int simple_rnn_bwd_xbf16_wbf16(const bf16* hs, const bf16* w, const float* mask,
                                          const bf16* dh_out, bf16* dxs, bf16* dw_out,
                                          float* dh_buf, float* dg, float* dw32, int T, int B,
                                          int D, void* stream) {
  return bwd(hs, w, mask, dh_out, dxs, dw_out, dh_buf, dg, dw32, T, B, D, stream);
}
#endif
#if PT_IN(1)
extern "C" int simple_rnn_bwd_xbf16_wf32(const bf16* hs, const float* w, const float* mask,
                                         const bf16* dh_out, bf16* dxs, float* dw_out,
                                         float* dh_buf, float* dg, float* dw32, int T, int B,
                                         int D, void* stream) {
  return bwd(hs, w, mask, dh_out, dxs, dw_out, dh_buf, dg, dw32, T, B, D, stream);
}
#endif
#if PT_IN(2)
extern "C" int simple_rnn_bwd_xf32_wf16(const float* hs, const f16* w, const float* mask,
                                         const float* dh_out, float* dxs, f16* dw_out,
                                         float* dh_buf, float* dg, float* dw32, int T, int B,
                                         int D, void* stream) {
  return bwd(hs, w, mask, dh_out, dxs, dw_out, dh_buf, dg, dw32, T, B, D, stream);
}
#endif
#if PT_IN(2)
extern "C" int simple_rnn_bwd_xf16_wf16(const f16* hs, const f16* w, const float* mask,
                                         const f16* dh_out, f16* dxs, f16* dw_out,
                                         float* dh_buf, float* dg, float* dw32, int T, int B,
                                         int D, void* stream) {
  return bwd(hs, w, mask, dh_out, dxs, dw_out, dh_buf, dg, dw32, T, B, D, stream);
}
#endif
#if PT_IN(2)
extern "C" int simple_rnn_bwd_xf16_wf32(const f16* hs, const float* w, const float* mask,
                                         const f16* dh_out, f16* dxs, float* dw_out,
                                         float* dh_buf, float* dg, float* dw32, int T, int B,
                                         int D, void* stream) {
  return bwd(hs, w, mask, dh_out, dxs, dw_out, dh_buf, dg, dw32, T, B, D, stream);
}
#endif
#if PT_IN(3)
extern "C" int simple_rnn_bwd_xbf16_wf16(const bf16* hs, const f16* w, const float* mask,
                                         const bf16* dh_out, bf16* dxs, f16* dw_out,
                                         float* dh_buf, float* dg, float* dw32, int T, int B,
                                         int D, void* stream) {
  return bwd(hs, w, mask, dh_out, dxs, dw_out, dh_buf, dg, dw32, T, B, D, stream);
}
#endif
#if PT_IN(3)
extern "C" int simple_rnn_bwd_xf16_wbf16(const f16* hs, const bf16* w, const float* mask,
                                         const f16* dh_out, f16* dxs, bf16* dw_out,
                                         float* dh_buf, float* dg, float* dw32, int T, int B,
                                         int D, void* stream) {
  return bwd(hs, w, mask, dh_out, dxs, dw_out, dh_buf, dg, dw32, T, B, D, stream);
}
#endif
