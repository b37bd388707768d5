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
//   the recurrent products are 83.0 GFLOP at D=1280 and 212.6 GFLOP at
//   D=2048: 0.50 / 1.29 ms at TF32's dense rate over 3 (3xTF32, below),
//   against ~0.1 / 0.2 ms of bytes moved once.  W_r (26 MB at D=1280,
//   67 MB at D=2048) is needed again every step; streamed whole from HBM
//   at D=2048 (past the 50 MB L2) that alone is ~20 us a step.
//
// Products: mma.sync.m16n8k8 TF32 tensor-core instructions in the
//   3xTF32 split, the helpers of csrc/flash_attention.cu: each float32
//   operand x is split into big = x rounded to TF32 and small = x - big
//   (the tensor cores truncate it), a b = a_small b_big + a_big b_small
//   + a_big b_big, each k-step's three summed in a fresh tile and added
//   to the float32 accumulator (chained in the tensor cores they
//   truncate every sum: scripts/probe_flash.py, variant `chained`).
//
// Design: the TPU kernel's grid (T, D/128) walks time in order and
//   streams W_r in 128-column blocks while the carry stays in VMEM.
//   Here the time loop is ONE persistent cooperative launch of 128 CTAs
//   of 32 warps with one grid.sync() a step (T - 1 a launch):
//   - CTA c owns hidden units [c U, c U + U), U = D / 128 (a runtime
//     value, 1..32), with all four gates of each: its columns of W_r,
//     n = gate U + unit, NC = 4U of them padded with zeros to NCp (a
//     multiple of 8, the mma's n).  Each step computes the CTA's
//     [B, NC] slice of h_{t-1} @ W_r as M = B rows (a pass of RP = 16 MW
//     rows, zero-padded past B), N = NCp, K = D.
//   - The 32 warps are kKSplit = 4 k-groups of 8: warp (q, w) owns
//     m-tile w % MW and n-tiles [(w / MW) NTW, ...) of the pass, over
//     k-steps [4q, 4q + 4) of every 128-row chunk, so a CTA keeps 32
//     warps of independent mma chains in flight (8 warps walking every
//     k-step took longer: scripts/probe_lstm_blocked.py, `first`, `ks2`).
//     The groups' sums meet in a gate tile in shared memory (over the
//     ring), the last group storing and each earlier one adding in
//     turn: the same order, bit for bit, every run.
//   - The CTA's columns stay resident in shared memory as [k][n] rows
//     (pitch P = 8 mod 32, so a warp's B fragment reads hit 32 banks)
//     where they fit beside the ring -- 768 of 1280 rows at D 1280 (B
//     64), 256 of 2048 at D 2048 -- and the rest is repacked once, in
//     the launch's prologue, into the wpack scratch as [D][NCp] and
//     streamed every step beside the chunk's h_{t-1} rows (pitch KC + 4)
//     through a 2-stage cp.async ring (through L2 only: h_{t-1} was
//     written by other SMs before the barrier).  What bounds it now:
//     every CTA reading all of h_{t-1} (327 KB at D 1280, B 64) from L2
//     every step, the split's issue beside the mma.sync pipe, and at
//     D 2048 the streamed seven eighths of W_r (probe variants `no_mma`,
//     `tf32_1x`, `streamed`).
//   - The cell reads the four gates of (row, unit) from the gate tile;
//     c lives in c_fin, read and written only by its owner thread, so
//     any B fits.  At t = 0, h_{-1} = 0 skips the product.
//   Later work (ROADMAP B12): sharing the h_{t-1} chunk across a cluster
//   instead of every CTA reading it, TMA loads, wgmma.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCtas = 128;        // CTA c owns hidden units [c U, c U + U)
constexpr int kWarps = 8;       // warps a k-group: (m-tile, n-tiles) of a pass
// k-groups: k-group q walks k-steps [q, q + 1) KC / 8 / kKSplit of each
// chunk; their partial products meet in the gate tile
constexpr int kKSplit = 4;
constexpr int kThreads = kWarps * kKSplit * 32;
constexpr int kMaxUnits = 32;     // D <= 4096
constexpr int KC = 128;           // k rows of one streamed chunk
constexpr int kHP = KC + 4;       // h chunk row pitch: A fragment reads on 32 banks
constexpr int kStages = 2;        // cp.async ring depth
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
  float* wpack;         // [128][D][NCp] scratch
  int T, B, D, U;
  int NCp, P;           // padded columns; their shared-memory row pitch
  int MW, NTW;          // m-tiles a pass (RP = 16 MW rows); n-tiles a warp
  int KR;               // W_r rows resident in shared memory (a multiple of KC)
  int GP;               // gate tile row pitch
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

// d += a b in 3xTF32 for one k-step of 8: the three products in a fresh
// tile, then added to d in float32
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4], float b0, float b1) {
  uint32_t bb0, bs0, bb1, bs1;
  split(b0, bb0, bs0);
  split(b1, bb1, bs1);
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(t, as, bb0, bb1);
  mma_tf32(t, ab, bs0, bs1);
  mma_tf32(t, ab, bb0, bb1);
  d[0] += t[0];
  d[1] += t[1];
  d[2] += t[2];
  d[3] += t[3];
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

// Shared memory of a launch, in floats: the resident rows, then the ring
// (the gate tile over it).
__host__ __device__ inline int ring_floats(const Args& p) {
  const int stage = 16 * p.MW * kHP + (p.KR < p.D ? KC * p.P : 0);
  const int gate = 16 * p.MW * p.GP;
  return kStages * stage > gate ? kStages * stage : gate;
}

template <int NTW, bool kResid>
__global__ void __launch_bounds__(kThreads, 1)
lstm_blocked_fwd_kernel(Args p) {
  extern __shared__ __align__(16) float smem[];
  cg::grid_group grid = cg::this_grid();
  const int T = p.T, B = p.B, D = p.D, U = p.U, NC = 4 * U, G = 4 * D;
  const int NCp = p.NCp, P = p.P, GP = p.GP, RP = 16 * p.MW;
  const int NK = D / KC, NKR = p.KR / KC;
  const int h_floats = RP * kHP;
  const int stage_floats = h_floats + (NKR < NK ? KC * P : 0);
  float* wres = smem;
  float* ring = smem + (size_t)p.KR * P;
  float* gt = ring;
  const int j0 = blockIdx.x * U;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int kq = warp / kWarps;                         // the warp's k-group,
  const int mt = warp % kWarps % p.MW;                  // m-tile
  const int n_lo = (warp % kWarps / p.MW) * p.NTW;      // ... and n-tiles
  const int n_cnt = min(p.NTW, NCp / 8 - n_lo);         // may be <= 0

  // W_r's column n of this CTA, row k, as [k][n]: resident rows in
  // shared memory at pitch P, the rest in wpack at pitch NCp (first read
  // at t = 1, after a grid barrier)
  float* wp = p.wpack + (size_t)blockIdx.x * D * NCp;
  for (int e = tid; e < D * NCp; e += kThreads) {
    const int k = e / NCp, n = e % NCp;
    const float w = n < NC ? p.w_r[(size_t)k * G + (n / U) * D + j0 + n % U] : 0.f;
    if (k < p.KR)
      wres[(size_t)k * P + n] = w;
    else
      wp[(size_t)k * NCp + n] = w;
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const float* hprev = p.hs + (size_t)(t > 0 ? t - 1 : 0) * B * D;
    for (int r0 = 0; r0 < B; r0 += RP) {
      const int rows = min(RP, B - r0);
      if (t > 0) {  // h_{-1} = 0: step 0 is xs alone
        float acc[NTW][4];
#pragma unroll
        for (int n = 0; n < NTW; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

        // chunk kc of h_{t-1} rows [r0, r0 + RP) and, past the resident
        // rows, of the packed columns
        auto load = [&](int kc) {
          float* hs_s = ring + (kc % kStages) * stage_floats;
          const int k0 = kc * KC;
          for (int e = tid; e < RP * (KC / 4); e += kThreads) {
            const int r = e / (KC / 4), q = (e % (KC / 4)) * 4, b = r0 + r;
            cp_async16(hs_s + r * kHP + q, hprev + (size_t)(b < B ? b : 0) * D + k0 + q, b < B);
          }
          if (kc >= NKR) {
            float* ws_s = hs_s + h_floats;
            const float* src = wp + (size_t)kc * KC * NCp;
            for (int e = tid; e < KC * (NCp / 4); e += kThreads) {
              const int r = e / (NCp / 4), q = (e % (NCp / 4)) * 4;
              cp_async16(ws_s + r * P + q, src + r * NCp + q, true);
            }
          }
        };
#pragma unroll
        for (int s = 0; s < kStages - 1; ++s) {
          if (s < NK) load(s);
          cp_async_commit();
        }
        const int a_off = (mt * 16 + g) * kHP + t4;
        for (int kc = 0; kc < NK; ++kc) {
          cp_async_wait<kStages - 2>();  // chunk kc landed (this thread's copies)
          __syncthreads();               // ... and every thread's; chunk kc - 1 consumed
          if (kc + kStages - 1 < NK) load(kc + kStages - 1);
          cp_async_commit();
          const float* hc = ring + (kc % kStages) * stage_floats;
          const float* wc = kc < NKR ? wres + (size_t)kc * KC * P : hc + h_floats;
#pragma unroll
          for (int k8 = 0; k8 < KC / 8 / kKSplit; ++k8) {
            const int kk = kq * (KC / 8 / kKSplit) + k8;
            const float* hr = hc + a_off + kk * 8;
            uint32_t ab[4], as[4];
            split(hr[0], ab[0], as[0]);
            split(hr[8 * kHP], ab[1], as[1]);
            split(hr[4], ab[2], as[2]);
            split(hr[8 * kHP + 4], ab[3], as[3]);
            const float* wr = wc + (kk * 8 + t4) * P + n_lo * 8 + g;
#pragma unroll
            for (int n = 0; n < NTW; ++n) {
              if (n < n_cnt) mma3(acc[n], ab, as, wr[n * 8], wr[4 * P + n * 8]);
            }
          }
        }
        cp_async_wait<0>();
        __syncthreads();  // every chunk consumed before the gate tile overwrites the ring

        // C fragments -> the gate tile [RP][GP] (row g, g + 8; columns 2t4,
        // 2t4 + 1): the last k-group stores, then each earlier one adds
        // in turn (a fixed order: the same sums bit for bit every run)
        float2* gr = reinterpret_cast<float2*>(gt + (mt * 16 + g) * GP + n_lo * 8 + 2 * t4);
        const int gp2 = 4 * GP;  // 8 rows, in float2s
        for (int q = kKSplit - 1; q >= 0; --q) {
          if (kq == q) {
#pragma unroll
            for (int n = 0; n < NTW; ++n) {
              if (n < n_cnt) {
                float2 lo = make_float2(acc[n][0], acc[n][1]);
                float2 hi = make_float2(acc[n][2], acc[n][3]);
                if (q < kKSplit - 1) {
                  lo.x += gr[4 * n].x;
                  lo.y += gr[4 * n].y;
                  hi.x += gr[gp2 + 4 * n].x;
                  hi.y += gr[gp2 + 4 * n].y;
                }
                gr[4 * n] = lo;
                gr[gp2 + 4 * n] = hi;
              }
            }
          }
          __syncthreads();
        }
      }

      for (int e = tid; e < rows * U; e += kThreads) {
        const int r = e / U, u = e % U, b = r0 + r, col = j0 + u;
        const float* gg = gt + r * GP + u;
        const size_t xrow = ((size_t)t * B + b) * G;
        const size_t hidx = (size_t)b * D + col;
        const float cp = t > 0 ? p.cfin[hidx] : 0.f;
        const float hp = t > 0 ? hprev[hidx] : 0.f;  // written by this thread at t - 1
        const float ga = t > 0 ? gg[0] : 0.f, gi = t > 0 ? gg[U] : 0.f;
        const float gf = t > 0 ? gg[2 * U] : 0.f, go = t > 0 ? gg[3 * U] : 0.f;
        const float a = tanhf(p.xs[xrow + col] + ga);
        const float ig = sigmoid(p.xs[xrow + D + col] + gi + cp * p.checks[col]);
        const float fg = sigmoid(p.xs[xrow + 2 * D + col] + gf + cp * p.checks[D + col]);
        const float cn = a * ig + cp * fg;
        const float og = sigmoid(p.xs[xrow + 3 * D + col] + go + cn * p.checks[2 * D + col]);
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
      __syncthreads();  // the gate tile read before the next pass's ring loads
    }
    if (t + 1 < T) grid.sync();  // hs[t] complete on every SM before step t + 1 reads it
  }
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

template <int NTW>
int launch(Args p, int resid, cudaStream_t st) {
  const size_t smem = sizeof(float) * ((size_t)p.KR * p.P + ring_floats(p));
  void* args[] = {&p};
  const void* kern = resid ? reinterpret_cast<const void*>(lstm_blocked_fwd_kernel<NTW, true>)
                           : reinterpret_cast<const void*>(lstm_blocked_fwd_kernel<NTW, false>);
  return static_cast<int>(coop_launch(kern, smem, args, st));
}

}  // namespace

// Returns the cudaError_t of the launch (0 = launched).  D must be a
// multiple of 128 up to 4096, any T, B >= 1; the caller checks shapes.
// cs / acts may be null when save_residuals is 0.  wpack is scratch of
// lstm_blocked_wpack_floats(D) floats; c_fin doubles as the c carry.
extern "C" int lstm_blocked_fwd_f32(const float* xs, const float* mask, const float* w_r,
                                    const float* checks, float* hs, float* cfin, float* cs,
                                    float* acts, float* wpack, int T, int B, int D,
                                    int save_residuals, void* stream) {
  if (T < 1 || B < 1 || D < 128 || D % 128 != 0 || D / 128 > kMaxUnits)
    return static_cast<int>(cudaErrorInvalidValue);
  Args p{xs, mask, w_r, checks, hs, cfin, cs, acts, wpack, T, B, D, D / 128};
  p.NCp = (4 * p.U + 7) / 8 * 8;
  p.P = p.NCp + (40 - p.NCp % 32) % 32;   // = 8 (mod 32)
  p.GP = p.NCp + 4;
  // m-tiles a pass: the batch's, up to 8, as a power of two, halved
  // while the ring does not fit (more passes); the other warps of a
  // k-group split the n-tiles
  const int mt = (B + 15) / 16;
  p.MW = 1;
  while (p.MW < mt && p.MW < kWarps) p.MW *= 2;
  for (;;) {
    const int nw = kWarps / p.MW, nt = p.NCp / 8;
    p.NTW = (nt + nw - 1) / nw;
    // resident W_r rows: all, or all that fit beside a ring that also
    // streams W_r chunks
    p.KR = D;
    if (p.KR * p.P + ring_floats(p) > kSmemFloats) {
      p.KR = 0;
      const int room = kSmemFloats - ring_floats(p);
      p.KR = room > 0 ? room / (KC * p.P) * KC : 0;
    }
    if (ring_floats(p) <= kSmemFloats) break;
    if (p.MW == 1) return static_cast<int>(cudaErrorInvalidValue);
    p.MW /= 2;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p.NTW <= 1) return launch<1>(p, save_residuals, st);
  if (p.NTW <= 2) return launch<2>(p, save_residuals, st);
  if (p.NTW <= 4) return launch<4>(p, save_residuals, st);
  if (p.NTW <= 8) return launch<8>(p, save_residuals, st);
  return launch<16>(p, save_residuals, st);
}

// Floats of the wpack scratch lstm_blocked_fwd_f32 takes at hidden size D.
extern "C" long long lstm_blocked_wpack_floats(int D) {
  const long long ncp = (4 * (D / 128) + 7) / 8 * 8;
  return (long long)kCtas * D * ncp;
}
