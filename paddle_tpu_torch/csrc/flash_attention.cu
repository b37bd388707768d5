// Flash attention for Hopper (sm_90a): the forward over float32 K/V or
// over an int8 KV cache with per-(position, KV head) scales, and the
// float32 backward (dK/dV and dQ).
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py ::
//   flash_attention forward (pallas_call at :144 in _fwd; body _fwd_kernel
//     :90) -- the batched causal pass of lm_prefill over a float32 cache
//     and every attention of the training path (full_seq=True);
//   flash_attention backward (_bwd :264): _bwd_dkv_kernel (body :172,
//     pallas_call :276) and _bwd_dq_kernel (body :221, pallas_call :304)
//     -- the custom_vjp of the training path;
//   flash_attention_quant (:507; pallas_call :554; body _fwd_quant_kernel
//     :458) -- the same pass of lm_prefill(kv_dtype="int8") over the
//     just-quantized cache.
//
// Computes: softmax(q k^T * scale) v with a running max / sum in float32.
//   Causal masks column > row (aligned starts, Tq == Tk).  Masked scores
//   sit at -1e30; the output is acc / max(l, 1e-30), as the TPU kernel
//   finalizes.  Unlike the TPU wrapper, ragged Tq / Tk are masked here,
//   not sent to a fallback path.
//   Float32 (flash_attention_fwd_f32): q [BH, Tq, dh], k/v [BH, Tk, dh]
//   -> o [BH, Tq, dh] and the log-sum-exp lse [BH, Tq] = m + log(max(l,
//   1e-30)) for a later backward.
//   Int8 (flash_attention_quant_i8): q [B, Tq, D] (the flat projection),
//   k/v [B, Tk, Dkv] int8 codes (the cache layout), kscale/vscale
//   [B, Tk, Hkv] f32 -> o [B, H, Tq, dh].  GQA in the kernel: query head
//   h reads the dh-column stripe of KV head h / (H / Hkv) straight from
//   the flat buffers, so no repeated heads and no widened float32 K/V
//   exist in memory.  Each code is widened as float(code) * scale before
//   its shared-memory store -- exactly quant/kv.dequantize_heads' product
//   -- and the rest is the float32 kernel's, so the int8 kernel equals
//   the float32 kernel run on the dequantized, head-repeated K/V bit for
//   bit.
//   Both are one template: a CTA addresses its (b, h) query stripe and
//   (b, g) K/V stripe by row strides D and Dkv; the float32 entry is the
//   case H = Hkv = 1 over BH batch rows.
//
// Bound on this card: bytes at the prefill shapes (dh = 64, T in the
//   tens to hundreds: a few FLOPs per byte of q/k/v/o moved).
//
// Design: one CTA per (b*h, 32-row q tile) -- Hopper runs CTAs in no
//   order, so the TPU's innermost sequential kv grid axis becomes a loop
//   inside the CTA over 32-row K/V tiles, stopping at the diagonal when
//   causal (the TPU kernel's `needed` skip).  8 warps; each warp owns 4
//   query rows (2 at dh = 128, to stay inside 48 KB of static shared
//   memory) whose running max / sum / accumulator live in registers.
//   K/V tiles arrive through coalesced 16-byte loads (4 floats, or 16
//   int8 codes with the tile's scales read once into shared memory) into
//   shared memory with row stride dh + 1 (conflict-free per-lane score
//   reads); lane c scores column t0 + c and the probabilities are
//   broadcast by shuffle into the P.V product.  Later work (ROADMAP): TMA
//   and tensor-core (wgmma) products.
//
// Backward (flash_attention_bwd_dkv_f32, flash_attention_bwd_dq_f32):
//   FlashAttention-2 as the TPU kernels compute it.  The caller supplies
//   the forward's lse [BH, Tq] and delta = rowsum(do * o) [BH, Tq]; both
//   kernels recompute s = q k^T * scale (masked at -1e30, so p is exactly
//   0 there), p = exp(s - lse), dp = do v^T and ds = p (dp - delta) scale.
//   dK/dV: dV = p^T do, dK = ds^T q.  dQ: dQ = ds k.
//   Bound on this card: operations at the training shape (BH 256, T 256,
//   dh 64: 4 resp. 3 products of T x T x dh per (b, h), ~40 FLOPs per
//   byte moved), so the limit is the f32 rate.
//   Design: as the forward, the TPU's sequential innermost grid axis is a
//   loop inside the CTA, and every output row belongs to exactly one CTA
//   (no atomics: the result is the same bit for bit from run to run).
//   dK/dV: one CTA per (b*h, 32-row K/V tile) holding the tile in shared
//   memory; it loops over 32-row q tiles, starting at the diagonal when
//   causal (q rows before it see none of the tile's columns: the TPU
//   kernel's `needed` skip), staging q, do, lse and delta.  Each warp owns
//   4 K/V rows; lane i scores q row i against them, and the warp
//   broadcasts p and ds by shuffle into dV += p^T do and dK += ds^T q,
//   whose dh columns are spread over the lanes in registers.  dQ: one CTA
//   per (b*h, 32-row q tile); it loops over K/V tiles up to the diagonal
//   (the tiles after it are skipped), each warp owning 4 q rows and lane
//   c scoring K column c, and accumulates dQ += ds k the same way.  A q
//   row past Tq contributes nothing (p = 0) and a K column past Tk gets p
//   = 0.  Four 32 x (dh + 1) float tiles take 66 KB at dh 128, above the
//   48 KB of static shared memory, so both kernels use dynamic shared
//   memory, raising the limit where it is needed.  Later work (ROADMAP):
//   tensor-core products, TMA loads, delta fused into the dQ kernel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kTile = 32;
constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// blockIdx.x = b * H + h.  q rows of (b, h) at q + (b * Tq + row) * D +
// h * DH; K/V rows of (b, g = h / (H / Hkv)) at (b * Tk + t) * Dkv + g *
// DH, in floats or, kInt8, in int8 codes with scales at (b * Tk + t) *
// Hkv + g; o [B, H, Tq, DH].  lse may be null (not written).
template <int DH, bool kInt8>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_kernel(const float* __restrict__ q, const void* __restrict__ k,
                 const void* __restrict__ v,
                 const float* __restrict__ kscale,
                 const float* __restrict__ vscale, float* __restrict__ o,
                 float* __restrict__ lse, int H, int Hkv, int Tq, int Tk,
                 float scale, int causal) {
  constexpr int kRows = DH >= 128 ? 2 : 4;    // query rows per warp
  constexpr int kBq = kWarps * kRows;         // query rows per CTA
  constexpr int kPerLane = (DH + 31) / 32;
  constexpr int kLd = DH + 1;
  constexpr int kVec = DH / 4;                // float4s per q row
  constexpr int kKvVec = kInt8 ? DH / 16 : DH / 4;   // 16-byte K/V loads
  __shared__ float ks[kTile * kLd];
  __shared__ float vs[kTile * kLd];
  __shared__ __align__(16) float qs[kBq * DH];
  __shared__ float s_ksc[kTile];
  __shared__ float s_vsc[kTile];

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int g = h / (H / Hkv);
  const int D = H * DH;
  const int Dkv = Hkv * DH;
  const int q0 = blockIdx.y * kBq;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float* qb = q + (size_t)b * Tq * D + (size_t)h * DH;
  const size_t kv_row0 = (size_t)b * Tk;      // first K/V row of batch b

  for (int e = threadIdx.x; e < kBq * kVec; e += kWarps * 32) {
    const int row = e / kVec, c = (e % kVec) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + row < Tq)
      x = *reinterpret_cast<const float4*>(qb + (size_t)(q0 + row) * D + c);
    *reinterpret_cast<float4*>(qs + row * DH + c) = x;
  }

  float m[kRows], l[kRows], acc[kRows][kPerLane];
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) {
    m[rr] = kNeg;
    l[rr] = 0.f;
#pragma unroll
    for (int u = 0; u < kPerLane; ++u) acc[rr][u] = 0.f;
  }

  // last column any row of this tile needs
  const int k_end = causal ? min(q0 + kBq - 1, Tk - 1) : Tk - 1;
  for (int t0 = 0; t0 <= k_end; t0 += kTile) {
    __syncthreads();    // previous tile fully consumed (and qs written)
    if constexpr (kInt8) {
      if (threadIdx.x < kTile) {
        const int t = t0 + threadIdx.x;
        const size_t src = (kv_row0 + t) * Hkv + g;
        s_ksc[threadIdx.x] = t < Tk ? kscale[src] : 0.f;
        s_vsc[threadIdx.x] = t < Tk ? vscale[src] : 0.f;
      }
      __syncthreads();
    }
    for (int e = threadIdx.x; e < kTile * kKvVec; e += kWarps * 32) {
      const int row = e / kKvVec, t = t0 + row;
      const size_t off = (kv_row0 + t) * Dkv + (size_t)g * DH;
      float* kd = ks + row * kLd;
      float* vd = vs + row * kLd;
      if constexpr (kInt8) {
        // 16 codes per load at a byte offset that is a multiple of 16
        // (Dkv and DH are)
        const int c = (e % kKvVec) * 16;
        int4 kc = make_int4(0, 0, 0, 0), vc = kc;
        if (t < Tk) {
          kc = *reinterpret_cast<const int4*>(
              static_cast<const int8_t*>(k) + off + c);
          vc = *reinterpret_cast<const int4*>(
              static_cast<const int8_t*>(v) + off + c);
        }
        const float sk = s_ksc[row], sv = s_vsc[row];
        const int8_t* k8 = reinterpret_cast<const int8_t*>(&kc);
        const int8_t* v8 = reinterpret_cast<const int8_t*>(&vc);
#pragma unroll
        for (int u = 0; u < 16; ++u) {
          kd[c + u] = __fmul_rn(static_cast<float>(k8[u]), sk);
          vd[c + u] = __fmul_rn(static_cast<float>(v8[u]), sv);
        }
      } else {
        const int c = (e % kKvVec) * 4;
        float4 kv4 = make_float4(0.f, 0.f, 0.f, 0.f), vv4 = kv4;
        if (t < Tk) {
          kv4 = *reinterpret_cast<const float4*>(
              static_cast<const float*>(k) + off + c);
          vv4 = *reinterpret_cast<const float4*>(
              static_cast<const float*>(v) + off + c);
        }
        kd[c] = kv4.x; kd[c + 1] = kv4.y; kd[c + 2] = kv4.z;
        kd[c + 3] = kv4.w;
        vd[c] = vv4.x; vd[c + 1] = vv4.y; vd[c + 2] = vv4.z;
        vd[c + 3] = vv4.w;
      }
    }
    __syncthreads();
    const int col = t0 + lane;
    const float* kr = ks + lane * kLd;
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) {
      const int row_local = warp * kRows + rr;
      const int qrow = q0 + row_local;
      if (qrow >= Tq || (causal && t0 > qrow)) continue;   // warp-uniform
      const float* qr = qs + row_local * DH;
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < DH; ++d) s = fmaf(qr[d], kr[d], s);
      s *= scale;
      if (col >= Tk || (causal && col > qrow)) s = kNeg;
      const float m_new = fmaxf(m[rr], warp_max(s));
      const float p = expf(s - m_new);
      const float alpha = expf(m[rr] - m_new);
      l[rr] = l[rr] * alpha + warp_sum(p);
      m[rr] = m_new;
#pragma unroll
      for (int u = 0; u < kPerLane; ++u) acc[rr][u] *= alpha;
#pragma unroll 8
      for (int c = 0; c < kTile; ++c) {
        const float pc = __shfl_sync(kFull, p, c);
#pragma unroll
        for (int u = 0; u < kPerLane; ++u) {
          const int d = lane + 32 * u;
          if (d < DH) acc[rr][u] = fmaf(pc, vs[c * kLd + d], acc[rr][u]);
        }
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) {
    const int qrow = q0 + warp * kRows + rr;
    if (qrow >= Tq) continue;
    const float den = fmaxf(l[rr], 1e-30f);
    float* orow = o + ((size_t)bh * Tq + qrow) * DH;
#pragma unroll
    for (int u = 0; u < kPerLane; ++u) {
      const int d = lane + 32 * u;
      if (d < DH) orow[d] = acc[rr][u] / den;
    }
    if (lse != nullptr && lane == 0)
      lse[(size_t)bh * Tq + qrow] = m[rr] + logf(den);
  }
}

template <int DH, bool kInt8>
int launch(const float* q, const void* k, const void* v, const float* ks,
           const float* vs, float* o, float* lse, int B, int H, int Hkv,
           int Tq, int Tk, float scale, int causal, cudaStream_t st) {
  constexpr int kBq = kWarps * (DH >= 128 ? 2 : 4);
  const dim3 grid(B * H, (Tq + kBq - 1) / kBq);
  flash_fwd_kernel<DH, kInt8><<<grid, kWarps * 32, 0, st>>>(
      q, k, v, ks, vs, o, lse, H, Hkv, Tq, Tk, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <bool kInt8>
int dispatch(const float* q, const void* k, const void* v, const float* ks,
             const float* vs, float* o, float* lse, int B, int H, int Hkv,
             int Tq, int Tk, int dh, float scale, int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 16:
      return launch<16, kInt8>(q, k, v, ks, vs, o, lse, B, H, Hkv, Tq, Tk,
                               scale, causal, st);
    case 32:
      return launch<32, kInt8>(q, k, v, ks, vs, o, lse, B, H, Hkv, Tq, Tk,
                               scale, causal, st);
    case 64:
      return launch<64, kInt8>(q, k, v, ks, vs, o, lse, B, H, Hkv, Tq, Tk,
                               scale, causal, st);
    case 128:
      return launch<128, kInt8>(q, k, v, ks, vs, o, lse, B, H, Hkv, Tq, Tk,
                                scale, causal, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ------------------------------------------------------------- backward

constexpr int kBwdRows = kTile / kWarps;      // rows per warp (4)

template <int DH>
constexpr size_t bwd_smem_bytes() {
  return sizeof(float) * (4 * kTile * (DH + 1) + 2 * kTile);
}

// Rows [r0, r0 + kTile) of a [T, DH] matrix into a shared tile with row
// stride DH + 1, zero past T.
template <int DH>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           int r0, int T) {
  constexpr int kVec = DH / 4;
  for (int e = threadIdx.x; e < kTile * kVec; e += kWarps * 32) {
    const int row = e / kVec, c = (e % kVec) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + row < T)
      x = *reinterpret_cast<const float4*>(src + (size_t)(r0 + row) * DH + c);
    float* d = dst + row * (DH + 1) + c;
    d[0] = x.x; d[1] = x.y; d[2] = x.z; d[3] = x.w;
  }
}

// Entries [r0, r0 + kTile) of a [T] vector into shared memory, zero past T.
__device__ __forceinline__ void stage_vec(float* dst, const float* src,
                                          int r0, int T) {
  if (threadIdx.x < kTile)
    dst[threadIdx.x] = r0 + threadIdx.x < T ? src[r0 + threadIdx.x] : 0.f;
}

// blockIdx.x = b*h, blockIdx.y = K/V tile.  q/do [BH, Tq, DH], k/v/dk/dv
// [BH, Tk, DH], lse/delta [BH, Tq].
template <int DH>
__global__ void __launch_bounds__(kWarps * 32)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int Tq, int Tk, float scale,
                     int causal) {
  constexpr int kPerLane = (DH + 31) / 32;
  constexpr int kLd = DH + 1;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + kTile * kLd;
  float* qs = vs + kTile * kLd;
  float* dos = qs + kTile * kLd;
  float* s_lse = dos + kTile * kLd;
  float* s_delta = s_lse + kTile;

  const size_t bh = blockIdx.x;
  const int k0 = blockIdx.y * kTile;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  stage_rows<DH>(ks, k + bh * Tk * DH, k0, Tk);
  stage_rows<DH>(vs, v + bh * Tk * DH, k0, Tk);

  float dka[kBwdRows][kPerLane], dva[kBwdRows][kPerLane];
#pragma unroll
  for (int rr = 0; rr < kBwdRows; ++rr)
#pragma unroll
    for (int u = 0; u < kPerLane; ++u) dka[rr][u] = dva[rr][u] = 0.f;

  // causal: q rows before k0 see none of this tile's columns
  for (int q0 = causal ? k0 : 0; q0 < Tq; q0 += kTile) {
    __syncthreads();    // previous q tile fully consumed
    stage_rows<DH>(qs, q + bh * Tq * DH, q0, Tq);
    stage_rows<DH>(dos, dout + bh * Tq * DH, q0, Tq);
    stage_vec(s_lse, lse + bh * Tq, q0, Tq);
    stage_vec(s_delta, delta + bh * Tq, q0, Tq);
    __syncthreads();
    const int qrow = q0 + lane;                 // lane i scores q row i
    const float* qr = qs + lane * kLd;
    const float* dr = dos + lane * kLd;
    const float* kr = ks + warp * kBwdRows * kLd;
    const float* vr = vs + warp * kBwdRows * kLd;
    float s[kBwdRows], dp[kBwdRows];
#pragma unroll
    for (int rr = 0; rr < kBwdRows; ++rr) s[rr] = dp[rr] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      const float qd = qr[d], dd = dr[d];
#pragma unroll
      for (int rr = 0; rr < kBwdRows; ++rr) {
        s[rr] = fmaf(qd, kr[rr * kLd + d], s[rr]);
        dp[rr] = fmaf(dd, vr[rr * kLd + d], dp[rr]);
      }
    }
    const float l = s_lse[lane], dl = s_delta[lane];
    float p[kBwdRows], ds[kBwdRows];
#pragma unroll
    for (int rr = 0; rr < kBwdRows; ++rr) {
      const int col = k0 + warp * kBwdRows + rr;
      float sc = s[rr] * scale;
      if (causal && col > qrow) sc = kNeg;
      p[rr] = qrow < Tq ? expf(sc - l) : 0.f;
      ds[rr] = p[rr] * (dp[rr] - dl) * scale;
    }
#pragma unroll 4
    for (int i = 0; i < kTile; ++i) {
      float pi[kBwdRows], dsi[kBwdRows];
#pragma unroll
      for (int rr = 0; rr < kBwdRows; ++rr) {
        pi[rr] = __shfl_sync(kFull, p[rr], i);
        dsi[rr] = __shfl_sync(kFull, ds[rr], i);
      }
#pragma unroll
      for (int u = 0; u < kPerLane; ++u) {
        const int d = lane + 32 * u;
        if (d < DH) {
          const float dd = dos[i * kLd + d], qd = qs[i * kLd + d];
#pragma unroll
          for (int rr = 0; rr < kBwdRows; ++rr) {
            dva[rr][u] = fmaf(pi[rr], dd, dva[rr][u]);
            dka[rr][u] = fmaf(dsi[rr], qd, dka[rr][u]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < kBwdRows; ++rr) {
    const int row = k0 + warp * kBwdRows + rr;
    if (row >= Tk) continue;
    const size_t off = (bh * Tk + row) * DH;
#pragma unroll
    for (int u = 0; u < kPerLane; ++u) {
      const int d = lane + 32 * u;
      if (d < DH) {
        dk[off + d] = dka[rr][u];
        dv[off + d] = dva[rr][u];
      }
    }
  }
}

// blockIdx.x = b*h, blockIdx.y = q tile.  Layouts as flash_bwd_dkv_kernel;
// dq [BH, Tq, DH].
template <int DH>
__global__ void __launch_bounds__(kWarps * 32)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int Tq, int Tk, float scale, int causal) {
  constexpr int kPerLane = (DH + 31) / 32;
  constexpr int kLd = DH + 1;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + kTile * kLd;
  float* qs = vs + kTile * kLd;
  float* dos = qs + kTile * kLd;
  float* s_lse = dos + kTile * kLd;
  float* s_delta = s_lse + kTile;

  const size_t bh = blockIdx.x;
  const int q0 = blockIdx.y * kTile;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  stage_rows<DH>(qs, q + bh * Tq * DH, q0, Tq);
  stage_rows<DH>(dos, dout + bh * Tq * DH, q0, Tq);
  stage_vec(s_lse, lse + bh * Tq, q0, Tq);
  stage_vec(s_delta, delta + bh * Tq, q0, Tq);

  float acc[kBwdRows][kPerLane];
#pragma unroll
  for (int rr = 0; rr < kBwdRows; ++rr)
#pragma unroll
    for (int u = 0; u < kPerLane; ++u) acc[rr][u] = 0.f;

  const float* qr = qs + warp * kBwdRows * kLd;
  const float* dr = dos + warp * kBwdRows * kLd;
  // last column any row of this tile needs; the tiles after it are skipped
  const int k_end = causal ? min(q0 + kTile - 1, Tk - 1) : Tk - 1;
  for (int t0 = 0; t0 <= k_end; t0 += kTile) {
    __syncthreads();    // previous tile fully consumed (and q staged)
    stage_rows<DH>(ks, k + bh * Tk * DH, t0, Tk);
    stage_rows<DH>(vs, v + bh * Tk * DH, t0, Tk);
    __syncthreads();
    const int col = t0 + lane;                  // lane c scores column c
    const float* kr = ks + lane * kLd;
    const float* vr = vs + lane * kLd;
    float s[kBwdRows], dp[kBwdRows];
#pragma unroll
    for (int rr = 0; rr < kBwdRows; ++rr) s[rr] = dp[rr] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      const float kd = kr[d], vd = vr[d];
#pragma unroll
      for (int rr = 0; rr < kBwdRows; ++rr) {
        s[rr] = fmaf(qr[rr * kLd + d], kd, s[rr]);
        dp[rr] = fmaf(dr[rr * kLd + d], vd, dp[rr]);
      }
    }
    float ds[kBwdRows];
#pragma unroll
    for (int rr = 0; rr < kBwdRows; ++rr) {
      const int r = warp * kBwdRows + rr;
      float sc = s[rr] * scale;
      if (col >= Tk || (causal && col > q0 + r)) sc = kNeg;
      const float p = expf(sc - s_lse[r]);
      ds[rr] = p * (dp[rr] - s_delta[r]) * scale;
    }
#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float dsc[kBwdRows];
#pragma unroll
      for (int rr = 0; rr < kBwdRows; ++rr)
        dsc[rr] = __shfl_sync(kFull, ds[rr], c);
#pragma unroll
      for (int u = 0; u < kPerLane; ++u) {
        const int d = lane + 32 * u;
        if (d < DH) {
          const float kd = ks[c * kLd + d];
#pragma unroll
          for (int rr = 0; rr < kBwdRows; ++rr)
            acc[rr][u] = fmaf(dsc[rr], kd, acc[rr][u]);
        }
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < kBwdRows; ++rr) {
    const int row = q0 + warp * kBwdRows + rr;
    if (row >= Tq) continue;
    float* out = dq + (bh * Tq + row) * DH;
#pragma unroll
    for (int u = 0; u < kPerLane; ++u) {
      const int d = lane + 32 * u;
      if (d < DH) out[d] = acc[rr][u];
    }
  }
}

// Launch one backward kernel with its dynamic shared memory, raising the
// per-kernel limit first where it is above the 48 KB default.
template <typename Kernel, typename... Args>
int launch_bwd(Kernel kernel, size_t smem, dim3 grid, cudaStream_t st,
               Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<grid, kWarps * 32, smem, st>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int bwd(const float* q, const float* k, const float* v, const float* dout,
        const float* lse, const float* delta, float* dq, float* dk,
        float* dv, int BH, int Tq, int Tk, float scale, int causal,
        cudaStream_t st) {
  constexpr size_t smem = bwd_smem_bytes<DH>();
  if (dq == nullptr)
    return launch_bwd(flash_bwd_dkv_kernel<DH>, smem,
                      dim3(BH, (Tk + kTile - 1) / kTile), st, q, k, v, dout,
                      lse, delta, dk, dv, Tq, Tk, scale, causal);
  return launch_bwd(flash_bwd_dq_kernel<DH>, smem,
                    dim3(BH, (Tq + kTile - 1) / kTile), st, q, k, v, dout,
                    lse, delta, dq, Tq, Tk, scale, causal);
}

// dq == nullptr launches the dK/dV kernel, else the dQ kernel.
int bwd_dispatch(const float* q, const float* k, const float* v,
                 const float* dout, const float* lse, const float* delta,
                 float* dq, float* dk, float* dv, int BH, int Tq, int Tk,
                 int dh, float scale, int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 16:
      return bwd<16>(q, k, v, dout, lse, delta, dq, dk, dv, BH, Tq, Tk,
                     scale, causal, st);
    case 32:
      return bwd<32>(q, k, v, dout, lse, delta, dq, dk, dv, BH, Tq, Tk,
                     scale, causal, st);
    case 64:
      return bwd<64>(q, k, v, dout, lse, delta, dq, dk, dv, BH, Tq, Tk,
                     scale, causal, st);
    case 128:
      return bwd<128>(q, k, v, dout, lse, delta, dq, dk, dv, BH, Tq, Tk,
                      scale, causal, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Each entry returns cudaGetLastError() after the launch (0 = launched).

// q [BH, Tq, dh], k/v [BH, Tk, dh] -> o [BH, Tq, dh], lse [BH, Tq]
extern "C" int flash_attention_fwd_f32(const float* q, const float* k,
                                       const float* v, float* o, float* lse,
                                       int BH, int Tq, int Tk, int dh,
                                       float scale, int causal,
                                       void* stream) {
  return dispatch<false>(q, k, v, nullptr, nullptr, o, lse, BH, 1, 1, Tq,
                         Tk, dh, scale, causal, stream);
}

// q [B, Tq, H * dh], k/v [B, Tk, Hkv * dh] int8, ks/vs [B, Tk, Hkv]
// -> o [B, H, Tq, dh]
extern "C" int flash_attention_quant_i8(const float* q, const int8_t* k,
                                        const int8_t* v, const float* ks,
                                        const float* vs, float* o, int B,
                                        int H, int Hkv, int Tq, int Tk,
                                        int dh, float scale, int causal,
                                        void* stream) {
  return dispatch<true>(q, k, v, ks, vs, o, nullptr, B, H, Hkv, Tq, Tk, dh,
                        scale, causal, stream);
}

// q/do [BH, Tq, dh], k/v [BH, Tk, dh], lse/delta [BH, Tq] -> dk/dv
// [BH, Tk, dh]
extern "C" int flash_attention_bwd_dkv_f32(const float* q, const float* k,
                                           const float* v, const float* dout,
                                           const float* lse,
                                           const float* delta, float* dk,
                                           float* dv, int BH, int Tq, int Tk,
                                           int dh, float scale, int causal,
                                           void* stream) {
  return bwd_dispatch(q, k, v, dout, lse, delta, nullptr, dk, dv, BH, Tq,
                      Tk, dh, scale, causal, stream);
}

// the same inputs -> dq [BH, Tq, dh]
extern "C" int flash_attention_bwd_dq_f32(const float* q, const float* k,
                                          const float* v, const float* dout,
                                          const float* lse,
                                          const float* delta, float* dq,
                                          int BH, int Tq, int Tk, int dh,
                                          float scale, int causal,
                                          void* stream) {
  return bwd_dispatch(q, k, v, dout, lse, delta, dq, nullptr, nullptr, BH,
                      Tq, Tk, dh, scale, causal, stream);
}
