// Fused whole-sequence GRU for Hopper (sm_90a), float32: forward (lean
// and residual-saving), BPTT backward, and the dW_gate / dW_state products.
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
//   dxs = [dgates, dccg m], dh carried as m dh_prev + (1 - m) dh.
//
// Bound on this card: operations.  At the training shape (T=30, B=64,
//   D=512) the recurrent products are 2.9 GFLOP forward and 5.8 GFLOP
//   backward with dW against ~31 / ~38 MB moved, so f32 FLOPs at
//   67 TFLOP/s set the floor (~0.045 / ~0.09 ms).  What this simple design
//   pays instead is two grid-wide barriers per step and the L2 traffic of
//   re-reading a whole [B, D] operand in every CTA in each phase.
//
// Design: the TPU kernel's grid IS the time loop, with W_gate and W_state
//   (3 MB at D=512) resident in VMEM.  No SM holds them here, so each
//   recurrence is ONE persistent cooperative launch of 128 CTAs with
//   cooperative_groups grid.sync() between phases.  CTA c owns hidden
//   units j in [c U, c U + U), U = D / 128 (1..6), and keeps its weight
//   slices in shared memory (dynamic: 55 KB of weights at U = 6).  Each
//   thread owns one (b, j) per round of BT = 256 / U batch rows; operands
//   written by other SMs are staged chunk by chunk through L2 (__ldcg).
//   The GRU step has two dependent products, unlike the LSTM's one:
//   - Forward, per step: phase A stages h_{t-1} and forms u, r of the
//     CTA's units (2U columns of W_gate, transposed) and s = r h_{t-1} into
//     a shared [B, D] buffer; barrier; phase B stages all of s and forms
//     c~ (U columns of W_state) and h_t into hs[t]; barrier.  At t = 0,
//     h_{-1} = 0 skips both products and the first barrier; the last step
//     needs no second barrier.  2 (T - 1) barriers.  One s buffer is safe:
//     phase A of step t + 1 writes it only after the barrier that ends
//     every CTA's phase B reads of step t.  hs[t - 1] (read in A) and
//     hs[t] (written in B) are different rows of the output.
//   - Backward, over reversed time: phase 1 forms dh = carry + dh_out[t],
//     the update columns dug m and dccg m of dxs[t] for the CTA's units;
//     barrier; phase 2 stages all of dccg m, forms ds = dccg m W_state^T
//     for its units (U rows of W_state), the reset columns drg m of dxs[t]
//     and part = dh (1 - u) + ds r; barrier; phase 3 stages dgates [B, 2D]
//     and forms dh_prev = part + dgates W_gate^T (U rows of W_gate),
//     merged with the mask into the carry.  Phase 1 of step t - 1 reads
//     only the CTA's own carry and writes dxs[t - 1], not the dxs[t] that
//     phase 3 of step t reads, so no third barrier.  At t = 0, h_{-1} = 0
//     makes drg 0 and dh_{-1} is not needed: 2 (T - 1) barriers.  ds may
//     use the masked dccg: where m = 0 every use of ds is masked away.
//   - dW_gate = sum_t h_{t-1}^T dgates_t and dW_state = sum_t
//     (r_t h_{t-1})^T dccg_m,t have no recurrence: after the loop, tiled f32
//     products over [(T-1) B, D] operands (h_{-1} = 0 drops t = 0), the
//     s operand rebuilt from the saved r and the shifted hs as it loads.
//   Two [B, D] scratch buffers per launch: forward u (own columns only)
//   and s (shared); backward dh carry and part (own columns only).
//   Later work (ROADMAP): split B across CTAs to cut the L2 re-reads,
//   cheaper barriers, tensor-core products once bf16 lands.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kCtas = 128;   // CTA c owns hidden units [c U, c U + U)
constexpr int kPad = 4;      // row padding (floats): rows land on distinct banks

template <int U>
struct Cfg {
  static constexpr int D = 128 * U;
  static constexpr int BT = 256 / U;         // batch rows per round
  static constexpr int kThreads = BT * U;    // one (b, j) per thread: 252..256
  static constexpr int KC = 32 * U;          // staged columns per chunk (D / KC = 4)
  static constexpr int LDS = KC + kPad;      // staged row stride
  static constexpr int LDW = D + kPad;       // forward: transposed weight column stride
  static constexpr int LDG = 2 * D + kPad;   // backward: W_gate row stride
  static constexpr size_t kFwdSmem = sizeof(float) * (3 * U * LDW + BT * LDS);
  static constexpr size_t kBwdSmem = sizeof(float) * (U * LDG + U * LDW + BT * LDS);
};

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// rows [b0, b0 + BT) x columns [k0, k0 + KC) of src (row stride ld floats)
// into dst (row stride LDS), zero past row B; read through L2 only
template <int U>
__device__ __forceinline__ void stage(float* dst, const float* src, int ld, int b0,
                                      int k0, int B) {
  using C = Cfg<U>;
  constexpr int kVec = C::KC / 4;
  for (int e = threadIdx.x; e < C::BT * kVec; e += C::kThreads) {
    const int r = e / kVec, c = (e % kVec) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (b0 + r < B)
      v = __ldcg(reinterpret_cast<const float4*>(src + (size_t)(b0 + r) * ld + k0 + c));
    *reinterpret_cast<float4*>(dst + r * C::LDS + c) = v;
  }
}

// acc[2 g], acc[2 g + 1] += the staged row x columns [k0, k0 + KC) of
// weight row g (rows ldw floats apart); two partial sums per gate
template <int U, int NG>
__device__ __forceinline__ void chunk_dot(float (&acc)[2 * NG], const float* row,
                                          const float* w, int ldw, int k0) {
#pragma unroll 4
  for (int k = 0; k < Cfg<U>::KC; k += 4) {
    const float4 x4 = *reinterpret_cast<const float4*>(row + k);
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const float4 w4 = *reinterpret_cast<const float4*>(w + g * ldw + k0 + k);
      acc[2 * g] = fmaf(x4.x, w4.x, acc[2 * g]);
      acc[2 * g + 1] = fmaf(x4.y, w4.y, acc[2 * g + 1]);
      acc[2 * g] = fmaf(x4.z, w4.z, acc[2 * g]);
      acc[2 * g + 1] = fmaf(x4.w, w4.w, acc[2 * g + 1]);
    }
  }
}

// acc += rows [b0, b0 + BT) of src[:, col0 : col0 + K] x weight rows w
// (this thread's row of the staged chunk), K / KC chunks
template <int U, int NG>
__device__ __forceinline__ void staged_dot(float (&acc)[2 * NG], float* st, const float* src,
                                           int ld, int col0, int K, int b0, int B,
                                           const float* w, int ldw, int bl) {
  using C = Cfg<U>;
  for (int k0 = 0; k0 < K; k0 += C::KC) {
    __syncthreads();  // previous chunk consumed
    stage<U>(st, src, ld, b0, col0 + k0, B);
    __syncthreads();
    chunk_dot<U, NG>(acc, st + bl * C::LDS, w, ldw, k0);
  }
}

template <int U, bool kResid>
__global__ void __launch_bounds__(Cfg<U>::kThreads)
gru_fwd_kernel(const float* __restrict__ xs, const float* __restrict__ mask,
               const float* __restrict__ w_gate, const float* __restrict__ w_state,
               float* hs, float* acts, float* ubuf, float* sbuf, int T, int B) {
  using C = Cfg<U>;
  constexpr int D = C::D;
  extern __shared__ __align__(16) float smem[];
  float* wg = smem;                  // [2U][LDW]: wg[(g U + j) LDW + k] = W_gate[k][g D + j0 + j]
  float* ws = smem + 2 * U * C::LDW; // [U][LDW]: ws[j LDW + k] = W_state[k][j0 + j]
  float* st = smem + 3 * U * C::LDW; // [BT][LDS]: staged chunk of h_{t-1} or s
  cg::grid_group grid = cg::this_grid();

  const int j0 = blockIdx.x * U;
  for (int e = threadIdx.x; e < 2 * U * D; e += C::kThreads) {
    const int k = e / (2 * U), r = e % (2 * U);
    wg[r * C::LDW + k] = w_gate[(size_t)k * 2 * D + (r / U) * D + j0 + r % U];
  }
  for (int e = threadIdx.x; e < U * D; e += C::kThreads) {
    const int k = e / U, r = e % U;
    ws[r * C::LDW + k] = w_state[(size_t)k * D + j0 + r];
  }
  __syncthreads();

  const int jj = threadIdx.x % U, bl = threadIdx.x / U, col = j0 + jj;
  for (int t = 0; t < T; ++t) {
    const float* hprev = hs + (size_t)(t > 0 ? t - 1 : 0) * B * D;
    // phase A: u, r of this CTA's units; s = r h_{t-1} for every CTA
    for (int b0 = 0; b0 < B; b0 += C::BT) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      if (t > 0)  // h_{-1} = 0: step 0 is xs alone
        staged_dot<U, 2>(acc, st, hprev, D, 0, D, b0, B, wg + jj * C::LDW, U * C::LDW, bl);
      const int b = b0 + bl;
      if (b < B) {
        const size_t xrow = ((size_t)t * B + b) * 3 * D;
        const size_t hidx = (size_t)b * D + col;
        const float hp = t > 0 ? __ldcg(hprev + hidx) : 0.f;
        const float u = sigmoid(xs[xrow + col] + (acc[0] + acc[1]));
        const float r = sigmoid(xs[xrow + D + col] + (acc[2] + acc[3]));
        ubuf[hidx] = u;
        sbuf[hidx] = r * hp;
        if (kResid) {
          acts[xrow + col] = u;
          acts[xrow + D + col] = r;
        }
      }
    }
    if (t > 0) grid.sync();  // s complete on every SM (at t = 0, s = 0 is not read)
    // phase B: c~ and h_t of this CTA's units
    for (int b0 = 0; b0 < B; b0 += C::BT) {
      float acc[2] = {0.f, 0.f};
      if (t > 0)
        staged_dot<U, 1>(acc, st, sbuf, D, 0, D, b0, B, ws + jj * C::LDW, 0, bl);
      const int b = b0 + bl;
      if (b < B) {
        const size_t xrow = ((size_t)t * B + b) * 3 * D;
        const size_t hidx = (size_t)b * D + col;
        const float hp = t > 0 ? __ldcg(hprev + hidx) : 0.f;
        const float u = __ldcg(ubuf + hidx);
        const float cc = tanhf(xs[xrow + 2 * D + col] + (acc[0] + acc[1]));
        const float hn = hp + u * (cc - hp);
        const float m = mask[(size_t)t * B + b];
        hs[(size_t)t * B * D + hidx] = m * hn + (1.f - m) * hp;
        if (kResid) acts[xrow + 2 * D + col] = cc;
      }
    }
    if (t + 1 < T) grid.sync();  // hs[t] complete on every SM before step t+1
  }
}

template <int U>
__global__ void __launch_bounds__(Cfg<U>::kThreads)
gru_bwd_kernel(const float* __restrict__ acts, const float* __restrict__ hs,
               const float* __restrict__ w_gate, const float* __restrict__ w_state,
               const float* __restrict__ mask, const float* __restrict__ dh_out, float* dxs,
               float* dh_buf, float* part, int T, int B) {
  using C = Cfg<U>;
  constexpr int D = C::D, G = 3 * D;
  extern __shared__ __align__(16) float smem[];
  float* wgr = smem;                             // [U][LDG]: wgr[j LDG + n] = W_gate[j0 + j][n]
  float* wsr = smem + U * C::LDG;                // [U][LDW]: wsr[j LDW + k] = W_state[j0 + j][k]
  float* st = smem + U * C::LDG + U * C::LDW;    // [BT][LDS]: staged chunk of dxs[t]
  cg::grid_group grid = cg::this_grid();

  const int j0 = blockIdx.x * U;
  for (int e = threadIdx.x; e < U * 2 * D; e += C::kThreads)
    wgr[(e / (2 * D)) * C::LDG + e % (2 * D)] = w_gate[(size_t)j0 * 2 * D + e];
  for (int e = threadIdx.x; e < U * D; e += C::kThreads)
    wsr[(e / D) * C::LDW + e % D] = w_state[(size_t)j0 * D + e];
  __syncthreads();

  const int jj = threadIdx.x % U, bl = threadIdx.x / U, col = j0 + jj;
  for (int s = 0; s < T; ++s) {
    const int t = T - 1 - s;
    float* dx = dxs + (size_t)t * B * G;
    // phase 1: dh, and the update and candidate columns of dxs[t]
    for (int b = bl; b < B; b += C::BT) {
      const size_t arow = ((size_t)t * B + b) * G;
      const size_t hidx = (size_t)b * D + col;
      const size_t tidx = (size_t)t * B * D + hidx;
      const float u = acts[arow + col], cc = acts[arow + 2 * D + col];
      const float hp = t > 0 ? hs[tidx - (size_t)B * D] : 0.f;
      const float m = mask[(size_t)t * B + b];
      const float dh = (s > 0 ? __ldcg(dh_buf + hidx) : 0.f) + dh_out[tidx];
      const float dug = dh * (cc - hp) * u * (1.f - u);
      const float dccg = dh * u * (1.f - cc * cc);
      dx[(size_t)b * G + col] = dug * m;
      dx[(size_t)b * G + 2 * D + col] = dccg * m;
      if (t == 0) dx[(size_t)b * G + D + col] = 0.f;  // h_{-1} = 0: drg = 0
      dh_buf[hidx] = dh;
    }
    if (t == 0) break;  // dh_{-1} is not needed
    grid.sync();        // dccg m of step t complete on every SM
    // phase 2: ds = dccg m W_state^T for this CTA's units; the reset columns
    for (int b0 = 0; b0 < B; b0 += C::BT) {
      float acc[2] = {0.f, 0.f};
      staged_dot<U, 1>(acc, st, dx, G, 2 * D, D, b0, B, wsr + jj * C::LDW, 0, bl);
      const int b = b0 + bl;
      if (b < B) {
        const size_t arow = ((size_t)t * B + b) * G;
        const size_t hidx = (size_t)b * D + col;
        const float u = acts[arow + col], r = acts[arow + D + col];
        const float hp = hs[(size_t)(t - 1) * B * D + hidx];
        const float m = mask[(size_t)t * B + b];
        const float dh = __ldcg(dh_buf + hidx);
        const float ds = acc[0] + acc[1];
        const float drg = ds * hp * r * (1.f - r);
        dx[(size_t)b * G + D + col] = drg * m;
        part[hidx] = dh * (1.f - u) + ds * r;
      }
    }
    grid.sync();  // dgates of step t complete on every SM
    // phase 3: dh_prev = part + dgates W_gate^T, merged with the mask
    for (int b0 = 0; b0 < B; b0 += C::BT) {
      float acc[2] = {0.f, 0.f};
      staged_dot<U, 1>(acc, st, dx, G, 0, 2 * D, b0, B, wgr + jj * C::LDG, 0, bl);
      const int b = b0 + bl;
      if (b < B) {
        const size_t hidx = (size_t)b * D + col;
        const float m = mask[(size_t)t * B + b];
        const float dhp = __ldcg(part + hidx) + (acc[0] + acc[1]);
        dh_buf[hidx] = m * dhp + (1.f - m) * __ldcg(dh_buf + hidx);
      }
    }
  }
}

// out[M][N] = sum_k A[k][m] G[k][n], A[k][m] = a[k lda + m] (times
// r[k ldr + m] when r is given), G[k][n] = g[k ldg + n].  64 x 64 tile per
// CTA, 4 x 4 per thread, 16-deep k slabs; K is masked, M and N are
// multiples of 64.
constexpr int kTm = 64, kTn = 64, kTk = 16;

__global__ void __launch_bounds__(256)
gru_dw_kernel(const float* __restrict__ a, int lda, const float* __restrict__ r, int ldr,
              const float* __restrict__ g, int ldg, float* __restrict__ out, int K, int N) {
  __shared__ __align__(16) float asm_[kTk][kTm];
  __shared__ __align__(16) float gsm[kTk][kTn];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * kTm, n0 = blockIdx.x * kTn;
  const int lr = threadIdx.x / 16, lc = (threadIdx.x % 16) * 4;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kTk) {
    const int k = k0 + lr;
    float4 av = make_float4(0.f, 0.f, 0.f, 0.f), gv = av;
    if (k < K) {
      av = *reinterpret_cast<const float4*>(a + (size_t)k * lda + m0 + lc);
      if (r != nullptr) {
        const float4 rv = *reinterpret_cast<const float4*>(r + (size_t)k * ldr + m0 + lc);
        av = make_float4(rv.x * av.x, rv.y * av.y, rv.z * av.z, rv.w * av.w);
      }
      gv = *reinterpret_cast<const float4*>(g + (size_t)k * ldg + n0 + lc);
    }
    __syncthreads();  // previous slab consumed
    *reinterpret_cast<float4*>(&asm_[lr][lc]) = av;
    *reinterpret_cast<float4*>(&gsm[lr][lc]) = gv;
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTk; ++kk) {
      const float4 a4 = *reinterpret_cast<const float4*>(&asm_[kk][ty * 4]);
      const float4 b4 = *reinterpret_cast<const float4*>(&gsm[kk][tx * 4]);
      const float avv[4] = {a4.x, a4.y, a4.z, a4.w};
      const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(avv[i], bv[c], acc[i][c]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(out + (size_t)(m0 + ty * 4 + i) * N + n0 + tx * 4) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
}

// grid.sync() alone, `syncs` times, at the recurrences' launch shape: a
// probe for the cost of the barriers (chip_smoke.py times it).  It stays
// beside the kernels because the step's time cannot tell barriers from
// products, and the later work on these kernels (ROADMAP B10: split B
// across CTAs, which grows the grid) has to weigh the barrier share at
// the grid it picks.
__global__ void __launch_bounds__(256) gru_barrier_kernel(int syncs) {
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < syncs; ++i) grid.sync();
}

// A cooperative launch fails unless every CTA can be resident at once.
cudaError_t coop_launch(const void* kern, int threads, size_t smem, void** args,
                        cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  if ((e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, smem)) !=
      cudaSuccess)
    return e;
  if (!coop || per_sm * sms < kCtas) return cudaErrorCooperativeLaunchTooLarge;
  e = cudaLaunchCooperativeKernel(kern, dim3(kCtas), dim3(threads), args, smem, st);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <int U>
int fwd(const float* xs, const float* mask, const float* w_gate, const float* w_state,
        float* hs, float* acts, float* ubuf, float* sbuf, int T, int B, int resid,
        cudaStream_t st) {
  void* args[] = {&xs, &mask, &w_gate, &w_state, &hs, &acts, &ubuf, &sbuf, &T, &B};
  const void* kern = resid ? reinterpret_cast<const void*>(gru_fwd_kernel<U, true>)
                           : reinterpret_cast<const void*>(gru_fwd_kernel<U, false>);
  return static_cast<int>(coop_launch(kern, Cfg<U>::kThreads, Cfg<U>::kFwdSmem, args, st));
}

template <int U>
int bwd(const float* acts, const float* hs, const float* w_gate, const float* w_state,
        const float* mask, const float* dh_out, float* dxs, float* dh_buf, float* part, int T,
        int B, cudaStream_t st) {
  void* args[] = {&acts, &hs, &w_gate, &w_state, &mask, &dh_out, &dxs, &dh_buf, &part, &T, &B};
  return static_cast<int>(coop_launch(reinterpret_cast<const void*>(gru_bwd_kernel<U>),
                                      Cfg<U>::kThreads, Cfg<U>::kBwdSmem, args, st));
}

// f(std::integral_constant<int, U>) for D = 128 U, U = 1..6
template <typename F>
int by_units(int D, F f) {
  switch (D) {
    case 128: return f(std::integral_constant<int, 1>{});
    case 256: return f(std::integral_constant<int, 2>{});
    case 384: return f(std::integral_constant<int, 3>{});
    case 512: return f(std::integral_constant<int, 4>{});
    case 640: return f(std::integral_constant<int, 5>{});
    case 768: return f(std::integral_constant<int, 6>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Each entry returns the first failing cudaError_t of its launches (0 =
// launched).  D must be a multiple of 128 up to 768; the caller checks
// shapes.  ubuf / sbuf are [B, D] scratch.
extern "C" int gru_fwd_f32(const float* xs, const float* mask, const float* w_gate,
                           const float* w_state, float* hs, float* acts, float* ubuf,
                           float* sbuf, int T, int B, int D, int save_residuals,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return by_units(D, [&](auto u) {
    return fwd<decltype(u)::value>(xs, mask, w_gate, w_state, hs, acts, ubuf, sbuf, T, B,
                                   save_residuals, st);
  });
}

// BPTT over reversed time, then dW_gate and dW_state.  dh_buf / part are
// [B, D] scratch.
extern "C" int gru_bwd_f32(const float* acts, const float* hs, const float* w_gate,
                           const float* w_state, const float* mask, const float* dh_out,
                           float* dxs, float* dwg, float* dws, float* dh_buf, float* part,
                           int T, int B, int D, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rc = by_units(D, [&](auto u) {
    return bwd<decltype(u)::value>(acts, hs, w_gate, w_state, mask, dh_out, dxs, dh_buf, part,
                                   T, B, st);
  });
  if (rc != 0) return rc;
  const int G = 3 * D, K = (T - 1) * B;
  const size_t row1 = (size_t)B * G;  // step 1's first row of acts / dxs
  // dW_gate = hs[0 : T-1]^T dgates[1 : T]
  gru_dw_kernel<<<dim3(2 * D / kTn, D / kTm), 256, 0, st>>>(hs, D, nullptr, 0, dxs + row1, G,
                                                            dwg, K, 2 * D);
  // dW_state = (r[1 : T] hs[0 : T-1])^T dccg_m[1 : T]
  gru_dw_kernel<<<dim3(D / kTn, D / kTm), 256, 0, st>>>(hs, D, acts + row1 + D, G,
                                                        dxs + row1 + 2 * D, G, dws, K, D);
  return static_cast<int>(cudaGetLastError());
}

// `syncs` grid-wide barriers in one cooperative launch of 128 CTAs of 256
// threads, the recurrences' grid.
extern "C" int gru_barrier_probe(int syncs, void* stream) {
  void* args[] = {&syncs};
  return static_cast<int>(coop_launch(reinterpret_cast<const void*>(gru_barrier_kernel), 256,
                                      0, args, static_cast<cudaStream_t>(stream)));
}
