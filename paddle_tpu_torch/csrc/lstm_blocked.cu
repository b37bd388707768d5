// Gate-blocked peephole LSTM forward for Hopper (sm_90a), float32, for
// the hidden sizes whose W_r does not stay on chip (lean and
// residual-saving variants).
//
// Replaces: paddle_tpu/ops/pallas/lstm_blocked.py :: lstm_fused_blocked
//   forward pallas_call at :144 (body _fwd_kernel :61, cell _cell_block
//   :43, entry :271).  Its backward is plain torch
//   (ops/kernels/lstm_blocked.py), as it is plain XLA (_bwd_scan :167)
//   in the reference.
//
// Computes, per step t with gate order [a, i, f, o] (xs holds the input
//   projection plus bias, time-major [T, B, 4D]):
//     g = xs[t] + h_{t-1} @ W_r;  a = tanh(g_a)
//     i = sigmoid(g_i + c_{t-1} ci);  f = sigmoid(g_f + c_{t-1} cf)
//     c_new = a i + c_{t-1} f;  o = sigmoid(g_o + c_new co);  h_new = o tanh(c_new)
//     (h_t, c_t) = mask ? (h_new, c_new) : (h_{t-1}, c_{t-1})
//   with h_{-1} = c_{-1} = 0.  hs holds the CARRIED h, cs the merged c,
//   acts the a, i, f, o of the computed step even where the mask is 0:
//   the contract of the resident kernel (csrc/lstm.cu) and of the TPU
//   kernel, in the same [T, B, 4D] layout.
//
// Bound on this card: operations.  At the training shapes (T=100, B=64)
//   the recurrent products are 83.9 GFLOP at D=1280 and 214.7 GFLOP at
//   D=2048 against ~354 / ~591 MB moved once: 1.25 / 3.20 ms of f32 FMA
//   at 67 TFLOP/s against 0.11 / 0.18 ms of bytes.  W_r (26 MB at
//   D=1280, 67 MB at D=2048) must be read again every step; past the
//   50 MB L2 that is ~20 us a step from HBM, still under the operation
//   bound.
//
// Design: the TPU kernel's grid (T, D/128) walks time in order and
//   streams W_r in 128-column blocks while the carry stays in VMEM.
//   Here the time loop is ONE persistent cooperative launch of 128 CTAs
//   with one grid.sync() a step (T - 1 a launch):
//   - CTA c owns hidden units [c U, c U + U), U = D / 128 (a runtime
//     value, 1..32), with all four gates of each, so the cell needs no
//     second barrier (the TPU block j likewise holds the four gates of
//     128 units).  Each step computes the CTA's [B, 4U] slice of
//     h_{t-1} @ W_r as a small GEMM: thread (rg, j) owns unit j of the
//     CTA and RM batch rows (rg, rg + RGP, ...), 4 RM accumulators.
//   - W_r does not fit in shared memory (the slice is 524 KB at D=2048),
//     so it is streamed: each step walks k in chunks of KC, and a
//     kStages-deep ring of cp.async copies (through L2 only: h_{t-1} was
//     written by other SMs before the barrier) brings each chunk's
//     h_{t-1} rows and W_r columns while the previous chunk is used.
//   - The CTA's columns are repacked once, in the launch's prologue,
//     into the wpack scratch as [D/KC][4U][KC], so a chunk of them is
//     one contiguous block and each row of it a 16-byte aligned k-run
//     (the TPU kernel reads the same block as [D, 4, 128]).
//   - c lives in c_fin: only its owner thread reads or writes it, so any
//     B fits.  At t = 0, h_{-1} = 0 skips the product.  Batches larger
//     than a pass (RM RGP rows, capped by threads and shared memory)
//     walk the k chunks once per pass.
//   Later work (ROADMAP B12): tensor-core products, TMA loads, keeping
//   W_r resident in shared memory at D <= 1280 (205 KB a CTA), sharing
//   the h_{t-1} chunk across a cluster instead of every CTA reading it.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCtas = 128;        // CTA c owns hidden units [c U, c U + U)
constexpr int kMaxThreads = 512;
constexpr int kMaxUnits = 32;     // D <= 4096
constexpr int KC = 64;            // k depth of one streamed chunk (floats)
constexpr int LDS = KC + 4;       // shared row stride: float4 rows land on distinct banks
constexpr int kStages = 3;        // cp.async ring depth
constexpr int kSmemFloats = 232448 / 4;  // 227 KB, the opt-in maximum a block

struct Args {
  const float* xs;      // [T, B, 4D]
  const float* mask;    // [T, B]
  const float* w_r;     // [D, 4D]
  const float* checks;  // [3, D]
  float* hs;            // [T, B, D]
  float* cfin;          // [B, D], the c carry
  float* cs;            // [T, B, D] (residual variant)
  float* acts;          // [T, B, 4D] (residual variant)
  float* wpack;         // [128][D / KC][4U][KC] scratch
  int T, B, D, U, rgp;  // rgp: row groups a pass (threads = U rgp)
};

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

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

template <int RM, bool kResid>
__global__ void __launch_bounds__(kMaxThreads)
lstm_blocked_fwd_kernel(Args p) {
  extern __shared__ __align__(16) float smem[];
  cg::grid_group grid = cg::this_grid();
  const int T = p.T, B = p.B, D = p.D, U = p.U, NC = 4 * U, G = 4 * D;
  const int NK = D / KC, RGP = p.rgp, RP = RM * RGP;
  const int stage = (RP + NC) * LDS;  // floats: RP rows of h, then NC rows of W^T
  const int j0 = blockIdx.x * U;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int jj = tid % U, rg = tid / U, col = j0 + jj;

  // wp[kc][n][kk] = W_r[kc KC + kk][(n / U) D + j0 + n % U]; first read at
  // t = 1, after a grid barrier
  float* wp = p.wpack + (size_t)blockIdx.x * D * NC;
  for (int e = tid; e < D * NC; e += nthr) {
    const int k = e / NC, n = e % NC;
    wp[((size_t)(k / KC) * NC + n) * KC + k % KC] =
        p.w_r[(size_t)k * G + (n / U) * D + j0 + n % U];
  }
  const float ci = p.checks[col], cf = p.checks[D + col], co = p.checks[2 * D + col];

  for (int t = 0; t < T; ++t) {
    const float* hprev = p.hs + (size_t)(t > 0 ? t - 1 : 0) * B * D;
    for (int r0 = 0; r0 < B; r0 += RP) {
      float acc[RM][4];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int g = 0; g < 4; ++g) acc[i][g] = 0.f;

      if (t > 0) {  // h_{-1} = 0: step 0 is xs alone
        // chunk kc of h_{t-1} rows [r0, r0 + RP) and of the packed columns
        auto load = [&](int kc) {
          float* hs_s = smem + (kc % kStages) * stage;
          float* ws_s = hs_s + RP * LDS;
          const int k0 = kc * KC;
          for (int e = tid; e < RP * (KC / 4); e += nthr) {
            const int r = e / (KC / 4), q = (e % (KC / 4)) * 4, b = r0 + r;
            cp_async16(hs_s + r * LDS + q, hprev + (size_t)(b < B ? b : 0) * D + k0 + q, b < B);
          }
          const float* src = wp + (size_t)kc * NC * KC;
          for (int e = tid; e < NC * (KC / 4); e += nthr) {
            const int n = e / (KC / 4), q = (e % (KC / 4)) * 4;
            cp_async16(ws_s + n * LDS + q, src + n * KC + q, true);
          }
        };
#pragma unroll
        for (int s = 0; s < kStages - 1; ++s) {
          if (s < NK) load(s);
          cp_async_commit();
        }
        for (int kc = 0; kc < NK; ++kc) {
          cp_async_wait<kStages - 2>();  // chunk kc landed (this thread's copies)
          __syncthreads();               // ... and every thread's; chunk kc - 1 consumed
          if (kc + kStages - 1 < NK) load(kc + kStages - 1);
          cp_async_commit();
          const float* hs_s = smem + (kc % kStages) * stage;
          const float* ws_s = hs_s + RP * LDS;
#pragma unroll 4
          for (int k = 0; k < KC; k += 4) {
            float4 w[4];
#pragma unroll
            for (int g = 0; g < 4; ++g)
              w[g] = *reinterpret_cast<const float4*>(ws_s + (g * U + jj) * LDS + k);
#pragma unroll
            for (int i = 0; i < RM; ++i) {
              const float4 h = *reinterpret_cast<const float4*>(hs_s + (rg + i * RGP) * LDS + k);
#pragma unroll
              for (int g = 0; g < 4; ++g) {
                acc[i][g] = fmaf(h.x, w[g].x, acc[i][g]);
                acc[i][g] = fmaf(h.y, w[g].y, acc[i][g]);
                acc[i][g] = fmaf(h.z, w[g].z, acc[i][g]);
                acc[i][g] = fmaf(h.w, w[g].w, acc[i][g]);
              }
            }
          }
        }
        __syncthreads();  // every chunk consumed before the next pass refills the ring
      }

#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int b = r0 + rg + i * RGP;
        if (b >= B) continue;
        const size_t xrow = ((size_t)t * B + b) * G;
        const size_t hidx = (size_t)b * D + col;
        const float cp = t > 0 ? p.cfin[hidx] : 0.f;
        const float hp = t > 0 ? hprev[hidx] : 0.f;  // written by this thread at t - 1
        const float a = tanhf(p.xs[xrow + col] + acc[i][0]);
        const float ig = sigmoid(p.xs[xrow + D + col] + acc[i][1] + cp * ci);
        const float fg = sigmoid(p.xs[xrow + 2 * D + col] + acc[i][2] + cp * cf);
        const float cn = a * ig + cp * fg;
        const float og = sigmoid(p.xs[xrow + 3 * D + col] + acc[i][3] + cn * co);
        const float hn = og * tanhf(cn);
        const float m = p.mask[(size_t)t * B + b];
        const float hout = m * hn + (1.f - m) * hp;
        const float cout = m * cn + (1.f - m) * cp;
        p.hs[(size_t)t * B * D + hidx] = hout;
        p.cfin[hidx] = cout;
        if (kResid) {
          p.cs[(size_t)t * B * D + hidx] = cout;
          p.acts[xrow + col] = a;
          p.acts[xrow + D + col] = ig;
          p.acts[xrow + 2 * D + col] = fg;
          p.acts[xrow + 3 * D + col] = og;
        }
      }
    }
    if (t + 1 < T) grid.sync();  // hs[t] complete on every SM before step t + 1 reads it
  }
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

template <int RM>
int launch(Args p, int resid, cudaStream_t st) {
  const int by_threads = kMaxThreads / p.U;
  const int by_smem = (kSmemFloats / (kStages * LDS) - 4 * p.U) / RM;
  int rgp = (p.B + RM - 1) / RM;
  rgp = rgp < by_threads ? rgp : by_threads;
  rgp = rgp < by_smem ? rgp : by_smem;
  p.rgp = rgp;
  const size_t smem = sizeof(float) * kStages * (RM * rgp + 4 * p.U) * LDS;
  void* args[] = {&p};
  const void* kern = resid ? reinterpret_cast<const void*>(lstm_blocked_fwd_kernel<RM, true>)
                           : reinterpret_cast<const void*>(lstm_blocked_fwd_kernel<RM, false>);
  return static_cast<int>(coop_launch(kern, p.U * rgp, smem, args, st));
}

}  // namespace

// Returns the cudaError_t of the launch (0 = launched).  D must be a
// multiple of 128 up to 4096, any T, B >= 1; the caller checks shapes.
// cs / acts may be null when save_residuals is 0.  wpack is [D, 4D]
// scratch; c_fin doubles as the c carry.
extern "C" int lstm_blocked_fwd_f32(const float* xs, const float* mask, const float* w_r,
                                    const float* checks, float* hs, float* cfin, float* cs,
                                    float* acts, float* wpack, int T, int B, int D,
                                    int save_residuals, void* stream) {
  if (T < 1 || B < 1 || D < 128 || D % 128 != 0 || D / 128 > kMaxUnits)
    return static_cast<int>(cudaErrorInvalidValue);
  Args p{xs, mask, w_r, checks, hs, cfin, cs, acts, wpack, T, B, D, D / 128, 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // four rows a thread where the batch gives every CTA enough threads
  return B >= 32 ? launch<4>(p, save_residuals, st) : launch<1>(p, save_residuals, st);
}
