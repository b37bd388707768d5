// Fused whole-sequence peephole LSTM for Hopper (sm_90a), float32:
// forward (lean and residual-saving), BPTT backward, and the dW_r product.
//
// Replaces: paddle_tpu/ops/pallas/lstm.py :: lstm_fused
//   forward  pallas_call at :177 (body _fwd_kernel :34)
//   backward pallas_call at :209 (body _bwd_kernel :80; its in-body dW_r
//   accumulation :131-133 is lstm_dwr_kernel here)
//
// Computes, per step t with gate order [a, i, f, o] (xs holds the input
//   projection plus bias, time-major [T, B, 4D]):
//     g = xs[t] + h_{t-1} @ W_r;  a = tanh(g_a)
//     i = sigmoid(g_i + c_{t-1} ci);  f = sigmoid(g_f + c_{t-1} cf)
//     c_new = a i + c_{t-1} f;  o = sigmoid(g_o + c_new co);  h_new = o tanh(c_new)
//     (h_t, c_t) = mask ? (h_new, c_new) : (h_{t-1}, c_{t-1})
//   with h_{-1} = c_{-1} = 0.  hs holds the CARRIED h (a masked step repeats
//   the last live h), cs the merged c, acts the a, i, f, o of the computed
//   step even where the mask is 0 -- the TPU kernel's contract exactly.
//   The backward follows _bwd_kernel line for line; dchk is written per
//   batch row [B, 3D] and summed over B by the caller, as lstm.py:245 does.
//
// Bound on this card: operations.  At the training shape (T=100, B=64,
//   D=512) the recurrent products are 13.3 GFLOP forward and 26.6 GFLOP
//   backward against ~135 / ~150 MB moved, so f32 FLOPs at 67 TFLOP/s set
//   the floor (0.20 / 0.40 ms).  What this simple design pays instead is
//   one grid-wide barrier per step and the L2 traffic of re-reading the
//   whole h_{t-1} (forward) or dgates_t (backward) in every CTA each step.
//
// Design: the TPU kernel's grid IS the time loop, with W_r (4 MB at
//   D=512) resident in VMEM.  No SM holds W_r here, and CTAs run in
//   parallel, so both recurrences are ONE persistent cooperative launch
//   of 128 CTAs with cooperative_groups grid.sync() between steps:
//   - CTA c owns hidden units j in [c U, c U + U), U = D / 128.
//   - Forward: the CTA keeps its 4U columns of W_r (transposed) in shared
//     memory.  Each step it stages h_{t-1} [B, D] chunk by chunk from L2
//     (__ldcg: written by other SMs before the barrier, so it must bypass
//     L1), each thread owns one (b, j) and sums its four gates, runs the
//     cell, and writes hs[t][:, U] (plus cs / acts when saving residuals).
//     c lives in c_fin (only its owner thread touches it), so any B fits.
//   - Backward, over reversed time: phase 1 computes dgates[:, cols(U)]
//     from the saved acts and writes them to dxs[t]; barrier; phase 2
//     forms dh_prev[:, U] = dxs[t] @ W_r[U, :]^T from the full dxs[t]
//     (the CTA keeps its U rows of W_r) and merges it with the mask.  One
//     barrier a step suffices: phase 1 of step t-1 writes dxs[t-1], a
//     different buffer from the dxs[t] that phase 2 of step t reads.
//   - dW_r = sum_t h_{t-1}^T dgates_t has no recurrence: after the loop a
//     tiled f32 product [D, (T-1) B] x [(T-1) B, 4D] (h_{-1} = 0 drops t=0).
//   Later work (ROADMAP): split B across CTAs to cut the L2 re-reads,
//   tensor-core products once bf16 lands, cheaper barriers.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kCtas = 128;   // CTA c owns hidden units [c U, c U + U)
constexpr int kPad = 4;      // row padding (floats): rows land on distinct banks

template <int U>
struct Cfg {
  static constexpr int D = 128 * U;
  static constexpr int G = 4 * D;
  static constexpr int BT = kThreads / U;  // batch rows per round, one (b, j) per thread
  static constexpr int KC = 32 * U;        // staged columns per chunk: BT * KC = 8192 floats
  static constexpr int LDS = KC + kPad;    // staged row stride
  static constexpr int LDWF = D + kPad;    // forward: W_r^T slice row stride
  static constexpr int LDWB = G + kPad;    // backward: W_r row slice stride
  static constexpr size_t kFwdSmem = sizeof(float) * (4 * U * LDWF + BT * LDS);
  static constexpr size_t kBwdSmem = sizeof(float) * (U * LDWB + BT * LDS);
};

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// rows [b0, b0 + BT) x columns [k0, k0 + KC) of src (row stride ld floats)
// into dst (row stride LDS), zero past row B; read through L2 only
template <int U>
__device__ __forceinline__ void stage(float* dst, const float* src, int ld, int b0,
                                      int k0, int B) {
  using C = Cfg<U>;
  constexpr int kVec = C::KC / 4;
  for (int e = threadIdx.x; e < C::BT * kVec; e += kThreads) {
    const int r = e / kVec, c = (e % kVec) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (b0 + r < B)
      v = __ldcg(reinterpret_cast<const float4*>(src + (size_t)(b0 + r) * ld + k0 + c));
    *reinterpret_cast<float4*>(dst + r * C::LDS + c) = v;
  }
}

template <int U, bool kResid>
__global__ void __launch_bounds__(kThreads)
lstm_fwd_kernel(const float* __restrict__ xs, const float* __restrict__ mask,
                const float* __restrict__ w_r, const float* __restrict__ checks,
                float* hs, float* cfin, float* cs, float* acts, int T, int B) {
  using C = Cfg<U>;
  extern __shared__ __align__(16) float smem[];
  float* wt = smem;                     // [4U][LDWF]: wt[g U + j][k] = W_r[k][g D + j0 + j]
  float* hst = smem + 4 * U * C::LDWF;  // [BT][LDS]: staged h_{t-1} chunk
  __shared__ float chk[3 * U];
  cg::grid_group grid = cg::this_grid();

  const int j0 = blockIdx.x * U;
  for (int e = threadIdx.x; e < 4 * U * C::D; e += kThreads) {
    const int k = e / (4 * U), r = e % (4 * U);
    wt[r * C::LDWF + k] = w_r[(size_t)k * C::G + (r / U) * C::D + j0 + r % U];
  }
  if (threadIdx.x < 3 * U)
    chk[threadIdx.x] = checks[(threadIdx.x / U) * C::D + j0 + threadIdx.x % U];
  __syncthreads();

  const int jj = threadIdx.x % U, bl = threadIdx.x / U, col = j0 + jj;
  const float ci = chk[jj], cf = chk[U + jj], co = chk[2 * U + jj];
  for (int t = 0; t < T; ++t) {
    const float* hprev = hs + (size_t)(t > 0 ? t - 1 : 0) * B * C::D;
    for (int b0 = 0; b0 < B; b0 += C::BT) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      if (t > 0) {  // h_{-1} = 0: step 0 is xs alone
        for (int k0 = 0; k0 < C::D; k0 += C::KC) {
          __syncthreads();  // previous chunk consumed
          stage<U>(hst, hprev, C::D, b0, k0, B);
          __syncthreads();
          const float* hr = hst + bl * C::LDS;
#pragma unroll 4
          for (int k = 0; k < C::KC; k += 4) {
            const float4 h4 = *reinterpret_cast<const float4*>(hr + k);
#pragma unroll
            for (int g = 0; g < 4; ++g) {
              const float4 w4 =
                  *reinterpret_cast<const float4*>(wt + (g * U + jj) * C::LDWF + k0 + k);
              acc[g] = fmaf(h4.x, w4.x, acc[g]);
              acc[g] = fmaf(h4.y, w4.y, acc[g]);
              acc[g] = fmaf(h4.z, w4.z, acc[g]);
              acc[g] = fmaf(h4.w, w4.w, acc[g]);
            }
          }
        }
      }
      const int b = b0 + bl;
      if (b < B) {
        const size_t xrow = ((size_t)t * B + b) * C::G;
        const size_t hidx = (size_t)b * C::D + col;
        const size_t tidx = (size_t)t * B * C::D + hidx;
        const float m = mask[(size_t)t * B + b];
        const float c = t > 0 ? cfin[hidx] : 0.f;
        const float hp = t > 0 ? __ldcg(hprev + hidx) : 0.f;
        const float a = tanhf(xs[xrow + col] + acc[0]);
        const float i = sigmoid(xs[xrow + C::D + col] + acc[1] + c * ci);
        const float f = sigmoid(xs[xrow + 2 * C::D + col] + acc[2] + c * cf);
        const float cn = a * i + c * f;
        const float o = sigmoid(xs[xrow + 3 * C::D + col] + acc[3] + cn * co);
        const float hn = o * tanhf(cn);
        const float h = m * hn + (1.f - m) * hp;
        const float cm = m * cn + (1.f - m) * c;
        hs[tidx] = h;
        cfin[hidx] = cm;
        if (kResid) {
          cs[tidx] = cm;
          acts[xrow + col] = a;
          acts[xrow + C::D + col] = i;
          acts[xrow + 2 * C::D + col] = f;
          acts[xrow + 3 * C::D + col] = o;
        }
      }
    }
    if (t + 1 < T) grid.sync();  // hs[t] complete on every SM before step t+1
  }
}

template <int U>
__global__ void __launch_bounds__(kThreads)
lstm_bwd_kernel(const float* __restrict__ acts, const float* __restrict__ cs,
                const float* __restrict__ w_r, const float* __restrict__ checks,
                const float* __restrict__ mask, const float* __restrict__ dh_out,
                const float* __restrict__ dcfin, float* dxs, float* dchk,
                float* dh_carry, float* dc_carry, int T, int B) {
  using C = Cfg<U>;
  extern __shared__ __align__(16) float smem[];
  float* wrow = smem;                 // [U][LDWB]: wrow[j][n] = W_r[j0 + j][n]
  float* gst = smem + U * C::LDWB;    // [BT][LDS]: staged dgates chunk
  __shared__ float chk[3 * U];
  cg::grid_group grid = cg::this_grid();

  const int j0 = blockIdx.x * U;
  for (int e = threadIdx.x; e < U * C::G; e += kThreads)
    wrow[(e / C::G) * C::LDWB + e % C::G] = w_r[(size_t)(j0 + e / C::G) * C::G + e % C::G];
  if (threadIdx.x < 3 * U)
    chk[threadIdx.x] = checks[(threadIdx.x / U) * C::D + j0 + threadIdx.x % U];
  __syncthreads();

  const int jj = threadIdx.x % U, bl = threadIdx.x / U, col = j0 + jj;
  const float ci = chk[jj], cf = chk[U + jj], co = chk[2 * U + jj];
  for (int s = 0; s < T; ++s) {
    const int t = T - 1 - s;
    // phase 1: this CTA's gate columns of dgates_t, from the saved acts
    for (int b = bl; b < B; b += C::BT) {
      const size_t arow = ((size_t)t * B + b) * C::G;
      const size_t hidx = (size_t)b * C::D + col;
      const size_t tidx = (size_t)t * B * C::D + hidx;
      const size_t pidx = (size_t)b * 3 * C::D + col;
      const float a = acts[arow + col], i = acts[arow + C::D + col];
      const float f = acts[arow + 2 * C::D + col], o = acts[arow + 3 * C::D + col];
      const float ct = cs[tidx];
      const float cp = t > 0 ? cs[tidx - (size_t)B * C::D] : 0.f;
      const float m = mask[(size_t)t * B + b];
      const float dh = (s > 0 ? dh_carry[hidx] : 0.f) + dh_out[tidx];
      const float dcm = s > 0 ? dc_carry[hidx] : dcfin[hidx];
      const float tc = tanhf(ct);
      const float dog = dh * tc * o * (1.f - o);
      const float dc = dh * o * (1.f - tc * tc) + dcm + dog * co;
      const float dag = dc * i * (1.f - a * a);
      const float dig = dc * a * i * (1.f - i);
      const float dfg = dc * cp * f * (1.f - f);
      dxs[arow + col] = dag * m;
      dxs[arow + C::D + col] = dig * m;
      dxs[arow + 2 * C::D + col] = dfg * m;
      dxs[arow + 3 * C::D + col] = dog * m;
      const float dcp = dc * f + dig * ci + dfg * cf;
      dc_carry[hidx] = m * dcp + (1.f - m) * dcm;
      dh_carry[hidx] = dh;  // the merged dh, for phase 2's pass-through
      const float p0 = s > 0 ? dchk[pidx] : 0.f;
      const float p1 = s > 0 ? dchk[pidx + C::D] : 0.f;
      const float p2 = s > 0 ? dchk[pidx + 2 * C::D] : 0.f;
      dchk[pidx] = p0 + m * dig * cp;
      dchk[pidx + C::D] = p1 + m * dfg * cp;
      dchk[pidx + 2 * C::D] = p2 + m * dog * ct;
    }
    if (t == 0) break;  // dh_{-1} is not needed
    grid.sync();        // dxs[t] complete on every SM
    // phase 2: dh_prev[:, U] = dgates_t @ W_r[U, :]^T, merged with the mask
    const float* dg = dxs + (size_t)t * B * C::G;
    for (int b0 = 0; b0 < B; b0 += C::BT) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int k0 = 0; k0 < C::G; k0 += C::KC) {
        __syncthreads();
        stage<U>(gst, dg, C::G, b0, k0, B);
        __syncthreads();
        const float* gr = gst + bl * C::LDS;
        const float* wr = wrow + jj * C::LDWB + k0;
#pragma unroll 8
        for (int k = 0; k < C::KC; k += 4) {
          const float4 g4 = *reinterpret_cast<const float4*>(gr + k);
          const float4 w4 = *reinterpret_cast<const float4*>(wr + k);
          acc.x = fmaf(g4.x, w4.x, acc.x);
          acc.y = fmaf(g4.y, w4.y, acc.y);
          acc.z = fmaf(g4.z, w4.z, acc.z);
          acc.w = fmaf(g4.w, w4.w, acc.w);
        }
      }
      const int b = b0 + bl;
      if (b < B) {
        const size_t hidx = (size_t)b * C::D + col;
        const float m = mask[(size_t)t * B + b];
        const float dhp = (acc.x + acc.y) + (acc.z + acc.w);
        dh_carry[hidx] = m * dhp + (1.f - m) * dh_carry[hidx];
      }
    }
  }
}

// dwr[M][N] = sum_k h[k][m] * g[k][n]: both operands row-major over k
// (h = hs[0:T-1] as [K, D], g = dxs[1:T] as [K, 4D]).  64 x 64 tile per
// CTA, 4 x 4 per thread, 16-deep k slabs; K is masked, M and N are
// multiples of 64.
constexpr int kTm = 64, kTn = 64, kTk = 16;

__global__ void __launch_bounds__(256)
lstm_dwr_kernel(const float* __restrict__ h, const float* __restrict__ g,
                float* __restrict__ dwr, int K, int M, int N) {
  __shared__ __align__(16) float hsm[kTk][kTm];
  __shared__ __align__(16) float gsm[kTk][kTn];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * kTm, n0 = blockIdx.x * kTn;
  const int lr = threadIdx.x / 16, lc = (threadIdx.x % 16) * 4;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kTk) {
    const int k = k0 + lr;
    float4 hv = make_float4(0.f, 0.f, 0.f, 0.f), gv = hv;
    if (k < K) {
      hv = *reinterpret_cast<const float4*>(h + (size_t)k * M + m0 + lc);
      gv = *reinterpret_cast<const float4*>(g + (size_t)k * N + n0 + lc);
    }
    __syncthreads();  // previous slab consumed
    *reinterpret_cast<float4*>(&hsm[lr][lc]) = hv;
    *reinterpret_cast<float4*>(&gsm[lr][lc]) = gv;
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTk; ++kk) {
      const float4 a4 = *reinterpret_cast<const float4*>(&hsm[kk][ty * 4]);
      const float4 b4 = *reinterpret_cast<const float4*>(&gsm[kk][tx * 4]);
      const float av[4] = {a4.x, a4.y, a4.z, a4.w};
      const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r)
    *reinterpret_cast<float4*>(dwr + (size_t)(m0 + ty * 4 + r) * N + n0 + tx * 4) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
}

// A cooperative launch fails unless every CTA can be resident at once.
cudaError_t coop_launch(const void* kern, size_t smem, void** args, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  if ((e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, smem)) !=
      cudaSuccess)
    return e;
  if (!coop || per_sm * sms < kCtas) return cudaErrorCooperativeLaunchTooLarge;
  e = cudaLaunchCooperativeKernel(kern, dim3(kCtas), dim3(kThreads), args, smem, st);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <int U>
int fwd(const float* xs, const float* mask, const float* w_r, const float* checks, float* hs,
        float* cfin, float* cs, float* acts, int T, int B, int resid, cudaStream_t st) {
  void* args[] = {&xs, &mask, &w_r, &checks, &hs, &cfin, &cs, &acts, &T, &B};
  const void* kern = resid ? reinterpret_cast<const void*>(lstm_fwd_kernel<U, true>)
                           : reinterpret_cast<const void*>(lstm_fwd_kernel<U, false>);
  return static_cast<int>(coop_launch(kern, Cfg<U>::kFwdSmem, args, st));
}

template <int U>
int bwd(const float* acts, const float* cs, const float* w_r, const float* checks,
        const float* mask, const float* dh_out, const float* dcfin, float* dxs, float* dchk,
        float* dh_carry, float* dc_carry, int T, int B, cudaStream_t st) {
  void* args[] = {&acts, &cs, &w_r, &checks, &mask, &dh_out, &dcfin,
                  &dxs, &dchk, &dh_carry, &dc_carry, &T, &B};
  return static_cast<int>(coop_launch(reinterpret_cast<const void*>(lstm_bwd_kernel<U>),
                                      Cfg<U>::kBwdSmem, args, st));
}

}  // namespace

// Each entry returns the first failing cudaError_t of its launches (0 =
// launched).  D must be 128, 256 or 512; the caller checks shapes.
extern "C" int lstm_fwd_f32(const float* xs, const float* mask, const float* w_r,
                            const float* checks, float* hs, float* cfin, float* cs,
                            float* acts, int T, int B, int D, int save_residuals,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 128: return fwd<1>(xs, mask, w_r, checks, hs, cfin, cs, acts, T, B, save_residuals, st);
    case 256: return fwd<2>(xs, mask, w_r, checks, hs, cfin, cs, acts, T, B, save_residuals, st);
    case 512: return fwd<4>(xs, mask, w_r, checks, hs, cfin, cs, acts, T, B, save_residuals, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// BPTT over reversed time, then dW_r.  dh_carry / dc_carry are [B, D]
// scratch; dchk is [B, 3D] per-row partials.
extern "C" int lstm_bwd_f32(const float* acts, const float* cs, const float* hs,
                            const float* w_r, const float* checks, const float* mask,
                            const float* dh_out, const float* dcfin, float* dxs, float* dwr,
                            float* dchk, float* dh_carry, float* dc_carry, int T, int B, int D,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  switch (D) {
    case 128:
      rc = bwd<1>(acts, cs, w_r, checks, mask, dh_out, dcfin, dxs, dchk, dh_carry, dc_carry, T,
                  B, st);
      break;
    case 256:
      rc = bwd<2>(acts, cs, w_r, checks, mask, dh_out, dcfin, dxs, dchk, dh_carry, dc_carry, T,
                  B, st);
      break;
    case 512:
      rc = bwd<4>(acts, cs, w_r, checks, mask, dh_out, dcfin, dxs, dchk, dh_carry, dc_carry, T,
                  B, st);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  const int G = 4 * D;
  lstm_dwr_kernel<<<dim3(G / kTn, D / kTm), 256, 0, st>>>(hs, dxs + (size_t)B * G, dwr,
                                                          (T - 1) * B, D, G);
  return static_cast<int>(cudaGetLastError());
}
