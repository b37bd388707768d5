// Flash attention forward for Hopper (sm_90a), float32.
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py :: flash_attention
//   forward (pallas_call at :144 in _fwd; body _fwd_kernel :90) -- the
//   batched causal pass of lm_prefill.
//
// Computes: q [BH, Tq, dh], k/v [BH, Tk, dh] -> o [BH, Tq, dh] and the
//   log-sum-exp lse [BH, Tq] (for a later backward), softmax(q k^T *
//   scale) v with a running max / sum in float32.  Causal masks column >
//   row (aligned starts, Tq == Tk).  Masked scores sit at -1e30; the
//   output is acc / max(l, 1e-30) and lse = m + log(max(l, 1e-30)), as
//   the TPU kernel finalizes.  Unlike the TPU wrapper, ragged Tq / Tk are
//   masked here, not sent to a fallback path.
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
//   K/V tiles arrive through coalesced 16-byte loads into shared memory
//   with row stride dh + 1 (conflict-free per-lane score reads); lane c
//   scores column t0 + c and the probabilities are broadcast by shuffle
//   into the P.V product.  Later work (ROADMAP): in-kernel GQA head
//   indexing, TMA and tensor-core (wgmma) products.

#include <cuda_runtime.h>

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

template <int DH>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int Tq, int Tk, float scale,
                 int causal) {
  constexpr int kRows = DH >= 128 ? 2 : 4;    // query rows per warp
  constexpr int kBq = kWarps * kRows;         // query rows per CTA
  constexpr int kPerLane = (DH + 31) / 32;
  constexpr int kLd = DH + 1;
  constexpr int kVec = DH / 4;
  __shared__ float ks[kTile * kLd];
  __shared__ float vs[kTile * kLd];
  __shared__ __align__(16) float qs[kBq * DH];

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kBq;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float* qb = q + (size_t)bh * Tq * DH;
  const float* kb = k + (size_t)bh * Tk * DH;
  const float* vb = v + (size_t)bh * Tk * DH;

  for (int e = threadIdx.x; e < kBq * kVec; e += kWarps * 32) {
    const int row = e / kVec, c = (e % kVec) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + row < Tq)
      x = *reinterpret_cast<const float4*>(qb + (size_t)(q0 + row) * DH + c);
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
    for (int e = threadIdx.x; e < kTile * kVec; e += kWarps * 32) {
      const int row = e / kVec, c = (e % kVec) * 4, t = t0 + row;
      float4 kv4 = make_float4(0.f, 0.f, 0.f, 0.f), vv4 = kv4;
      if (t < Tk) {
        kv4 = *reinterpret_cast<const float4*>(kb + (size_t)t * DH + c);
        vv4 = *reinterpret_cast<const float4*>(vb + (size_t)t * DH + c);
      }
      float* kd = ks + row * kLd + c;
      float* vd = vs + row * kLd + c;
      kd[0] = kv4.x; kd[1] = kv4.y; kd[2] = kv4.z; kd[3] = kv4.w;
      vd[0] = vv4.x; vd[1] = vv4.y; vd[2] = vv4.z; vd[3] = vv4.w;
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
    if (lane == 0) lse[(size_t)bh * Tq + qrow] = m[rr] + logf(den);
  }
}

template <int DH>
int launch(const float* q, const float* k, const float* v, float* o,
           float* lse, int BH, int Tq, int Tk, float scale, int causal,
           cudaStream_t st) {
  constexpr int kBq = kWarps * (DH >= 128 ? 2 : 4);
  const dim3 grid(BH, (Tq + kBq - 1) / kBq);
  flash_fwd_kernel<DH><<<grid, kWarps * 32, 0, st>>>(q, k, v, o, lse, Tq, Tk,
                                                     scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int flash_attention_fwd_f32(const float* q, const float* k,
                                       const float* v, float* o, float* lse,
                                       int BH, int Tq, int Tk, int dh,
                                       float scale, int causal,
                                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 16: return launch<16>(q, k, v, o, lse, BH, Tq, Tk, scale, causal, st);
    case 32: return launch<32>(q, k, v, o, lse, BH, Tq, Tk, scale, causal, st);
    case 64: return launch<64>(q, k, v, o, lse, BH, Tq, Tk, scale, causal, st);
    case 128:
      return launch<128>(q, k, v, o, lse, BH, Tq, Tk, scale, causal, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
