// Fused whole-sequence vanilla RNN for Hopper (sm_90a), float32: the
// forward, the BPTT backward and the dW product.
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
//   and dW = sum_t h_{t-1}^T dg_t (h_{-1} = 0 drops t = 0).
//
// Bound on this card: operations.  At the training shape (T=100, B=64,
//   D=512) each recurrence is 2 (T - 1) B D^2 = 3.3 GFLOP of f32 FMA
//   (0.050 ms at 67 TFLOP/s) against ~27 MB moved once (0.008 ms), and
//   dW the same 3.3 GFLOP.  What this simple design pays instead is a
//   grid barrier a step and the L2 traffic of every CTA staging the
//   whole [B, D] operand of the step.
//
// Design: the TPU kernel's grid IS the time loop, with W (1 MB at D=512)
//   resident in VMEM.  No SM holds W here, so each recurrence is ONE
//   persistent cooperative launch of 128 CTAs with a cooperative_groups
//   grid.sync() a step (T - 1 a launch).  CTA c owns hidden units
//   [c U, c U + U), U = D / 128 (1..10, every D the route admits), and
//   keeps its slice of W in shared memory for the whole launch (dynamic:
//   51 KB at U = 10).  Each thread owns one (b, j) per round of
//   BT = 256 / U batch rows; the operand written by other SMs is staged
//   chunk by chunk through L2 (__ldcg).
//   - Forward: step t stages h_{t-1} = hs[t - 1] and forms the CTA's
//     columns of h_{t-1} W (U columns of W, transposed), tanh and the
//     masked carry into hs[t]; barrier.  At t = 0, h_{-1} = 0 skips the
//     product.
//   - Backward: step t forms dh and dg of the CTA's units into dxs[t]
//     (own columns only, so no barrier before), barrier, then stages all
//     of dg_t and forms the CTA's columns of dg_t W^T (U rows of W) and
//     the carry.  The next step's first half reads only the CTA's own
//     carry and writes dxs[t - 1], not the dxs[t] that slower CTAs may
//     still stage, so one barrier a step.  At t = 0, dh_{-1} is not
//     needed.  The carry lives in the dh_buf scratch, read and written by
//     its owner thread only, so any B fits.
//   - dW has no recurrence: after the loop, a tiled f32 product over the
//     [(T-1) B, D] operands hs[0 : T-1] and dxs[1 : T].
//   Later work (ROADMAP B11): split B across CTAs to cut the L2 re-reads
//   of the staged operand, overlap the staging with the products,
//   tensor-core products.

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
  static constexpr int kThreads = BT * U;    // one (b, j) per thread: 250..256
  static constexpr int KC = 32 * U;          // staged columns per chunk (D / KC = 4)
  static constexpr int LDS = KC + kPad;      // staged row stride
  static constexpr int LDW = D + kPad;       // weight row stride in shared memory
  static constexpr size_t kSmem = sizeof(float) * (U * LDW + BT * LDS);
};

// rows [b0, b0 + BT) x columns [k0, k0 + KC) of src (row stride D) into
// dst (row stride LDS), zero past row B; read through L2 only
template <int U>
__device__ __forceinline__ void stage(float* dst, const float* src, int b0, int k0, int B) {
  using C = Cfg<U>;
  constexpr int kVec = C::KC / 4;
  for (int e = threadIdx.x; e < C::BT * kVec; e += C::kThreads) {
    const int r = e / kVec, c = (e % kVec) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (b0 + r < B)
      v = __ldcg(reinterpret_cast<const float4*>(src + (size_t)(b0 + r) * C::D + k0 + c));
    *reinterpret_cast<float4*>(dst + r * C::LDS + c) = v;
  }
}

// sum over k of src[b0 + bl][k] w[k], the staged rows chunk by chunk;
// two partial sums.  Every thread of the CTA calls it (it synchronizes).
template <int U>
__device__ __forceinline__ float staged_dot(float* st, const float* src, int b0, int B,
                                            const float* w, int bl) {
  using C = Cfg<U>;
  float a0 = 0.f, a1 = 0.f;
  for (int k0 = 0; k0 < C::D; k0 += C::KC) {
    __syncthreads();  // previous chunk consumed
    stage<U>(st, src, b0, k0, B);
    __syncthreads();
    const float* row = st + bl * C::LDS;
#pragma unroll 4
    for (int k = 0; k < C::KC; k += 4) {
      const float4 x4 = *reinterpret_cast<const float4*>(row + k);
      const float4 w4 = *reinterpret_cast<const float4*>(w + k0 + k);
      a0 = fmaf(x4.x, w4.x, a0);
      a1 = fmaf(x4.y, w4.y, a1);
      a0 = fmaf(x4.z, w4.z, a0);
      a1 = fmaf(x4.w, w4.w, a1);
    }
  }
  return a0 + a1;
}

template <int U>
__global__ void __launch_bounds__(Cfg<U>::kThreads)
simple_rnn_fwd_kernel(const float* __restrict__ xs, const float* __restrict__ mask,
                      const float* __restrict__ w, float* hs, int T, int B) {
  using C = Cfg<U>;
  constexpr int D = C::D;
  extern __shared__ __align__(16) float smem[];
  float* wt = smem;                  // [U][LDW]: wt[j LDW + k] = W[k][j0 + j]
  float* st = smem + U * C::LDW;     // [BT][LDS]: staged chunk of h_{t-1}
  cg::grid_group grid = cg::this_grid();

  const int j0 = blockIdx.x * U;
  for (int e = threadIdx.x; e < U * D; e += C::kThreads) {
    const int k = e / U, r = e % U;
    wt[r * C::LDW + k] = w[(size_t)k * D + j0 + r];
  }
  __syncthreads();

  const int jj = threadIdx.x % U, bl = threadIdx.x / U, col = j0 + jj;
  for (int t = 0; t < T; ++t) {
    const float* hprev = hs + (size_t)(t > 0 ? t - 1 : 0) * B * D;
    for (int b0 = 0; b0 < B; b0 += C::BT) {
      // h_{-1} = 0: step 0 is xs alone
      const float acc = t > 0 ? staged_dot<U>(st, hprev, b0, B, wt + jj * C::LDW, bl) : 0.f;
      const int b = b0 + bl;
      if (b < B) {
        const size_t hidx = (size_t)b * D + col;
        const float hp = t > 0 ? __ldcg(hprev + hidx) : 0.f;
        const float hn = tanhf(xs[(size_t)t * B * D + hidx] + acc);
        const float m = mask[(size_t)t * B + b];
        hs[(size_t)t * B * D + hidx] = m * hn + (1.f - m) * hp;
      }
    }
    if (t + 1 < T) grid.sync();  // hs[t] complete on every SM before step t+1
  }
}

template <int U>
__global__ void __launch_bounds__(Cfg<U>::kThreads)
simple_rnn_bwd_kernel(const float* __restrict__ hs, const float* __restrict__ w,
                      const float* __restrict__ mask, const float* __restrict__ dh_out,
                      float* dxs, float* dh_buf, int T, int B) {
  using C = Cfg<U>;
  constexpr int D = C::D;
  extern __shared__ __align__(16) float smem[];
  float* wr = smem;                  // [U][LDW]: wr[j LDW + k] = W[j0 + j][k]
  float* st = smem + U * C::LDW;     // [BT][LDS]: staged chunk of dg_t
  cg::grid_group grid = cg::this_grid();

  const int j0 = blockIdx.x * U;
  for (int e = threadIdx.x; e < U * D; e += C::kThreads)
    wr[(e / D) * C::LDW + e % D] = w[(size_t)j0 * D + e];
  __syncthreads();

  const int jj = threadIdx.x % U, bl = threadIdx.x / U, col = j0 + jj;
  for (int s = 0; s < T; ++s) {
    const int t = T - 1 - s;
    const size_t step = (size_t)t * B * D;
    // dh and dg of this CTA's units; dh_buf holds the carry
    for (int b = bl; b < B; b += C::BT) {
      const size_t hidx = (size_t)b * D + col;
      const float dh = (s > 0 ? dh_buf[hidx] : 0.f) + dh_out[step + hidx];
      const float h = hs[step + hidx];
      dxs[step + hidx] = dh * (1.f - h * h) * mask[(size_t)t * B + b];
      dh_buf[hidx] = dh;
    }
    if (t == 0) break;  // dh_{-1} is not needed
    grid.sync();        // dg_t complete on every SM
    // dh_prev = dg_t W^T for this CTA's units, merged with the mask
    for (int b0 = 0; b0 < B; b0 += C::BT) {
      const float acc = staged_dot<U>(st, dxs + step, b0, B, wr + jj * C::LDW, bl);
      const int b = b0 + bl;
      if (b < B) {
        const size_t hidx = (size_t)b * D + col;
        const float m = mask[(size_t)t * B + b];
        dh_buf[hidx] = m * acc + (1.f - m) * dh_buf[hidx];
      }
    }
  }
}

// out[M][N] = sum_k A[k][m] G[k][n], A[k][m] = a[k M + m], G[k][n] =
// g[k N + n].  64 x 64 tile per CTA, 4 x 4 per thread, 16-deep k slabs;
// K is masked (K = 0 writes zeros), M and N are multiples of 64.
constexpr int kTm = 64, kTn = 64, kTk = 16;

__global__ void __launch_bounds__(256)
simple_rnn_dw_kernel(const float* __restrict__ a, const float* __restrict__ g,
                     float* __restrict__ out, int K, int M, int N) {
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
      av = *reinterpret_cast<const float4*>(a + (size_t)k * M + m0 + lc);
      gv = *reinterpret_cast<const float4*>(g + (size_t)k * N + n0 + lc);
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

// f(std::integral_constant<int, U>) for D = 128 U, U = 1..10
template <typename F>
int by_units(int D, F f) {
  switch (D) {
    case 128: return f(std::integral_constant<int, 1>{});
    case 256: return f(std::integral_constant<int, 2>{});
    case 384: return f(std::integral_constant<int, 3>{});
    case 512: return f(std::integral_constant<int, 4>{});
    case 640: return f(std::integral_constant<int, 5>{});
    case 768: return f(std::integral_constant<int, 6>{});
    case 896: return f(std::integral_constant<int, 7>{});
    case 1024: return f(std::integral_constant<int, 8>{});
    case 1152: return f(std::integral_constant<int, 9>{});
    case 1280: return f(std::integral_constant<int, 10>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Each entry returns the first failing cudaError_t of its launches (0 =
// launched).  D must be a multiple of 128 up to 1280; the caller checks
// shapes.
extern "C" int simple_rnn_fwd_f32(const float* xs, const float* mask, const float* w,
                                  float* hs, int T, int B, int D, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return by_units(D, [&](auto u) {
    using C = Cfg<decltype(u)::value>;
    void* args[] = {&xs, &mask, &w, &hs, &T, &B};
    return static_cast<int>(coop_launch(
        reinterpret_cast<const void*>(simple_rnn_fwd_kernel<decltype(u)::value>), C::kThreads,
        C::kSmem, args, st));
  });
}

// BPTT over reversed time, then dW.  dh_buf is [B, D] scratch.
extern "C" int simple_rnn_bwd_f32(const float* hs, const float* w, const float* mask,
                                  const float* dh_out, float* dxs, float* dw, float* dh_buf,
                                  int T, int B, int D, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rc = by_units(D, [&](auto u) {
    using C = Cfg<decltype(u)::value>;
    void* args[] = {&hs, &w, &mask, &dh_out, &dxs, &dh_buf, &T, &B};
    return static_cast<int>(coop_launch(
        reinterpret_cast<const void*>(simple_rnn_bwd_kernel<decltype(u)::value>), C::kThreads,
        C::kSmem, args, st));
  });
  if (rc != 0) return rc;
  // dW = hs[0 : T-1]^T dxs[1 : T]
  simple_rnn_dw_kernel<<<dim3(D / kTn, D / kTm), 256, 0, st>>>(hs, dxs + (size_t)B * D, dw,
                                                               (T - 1) * B, D, D);
  return static_cast<int>(cudaGetLastError());
}
