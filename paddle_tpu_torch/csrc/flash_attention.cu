// Flash attention for Hopper (sm_90a): the forward over float32 K/V or
// over an int8 KV cache with per-(position, KV head) scales, and the
// backward (dK/dV and dQ); float32 operands, or bf16 ones in each
// kernel's kLow instance.
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py ::
//   flash_attention forward (pallas_call at :144 in _fwd; body _fwd_kernel
//     :90) -- the batched causal pass of lm_prefill over a float32 cache
//     and every attention of the training path (full_seq=True);
//   flash_attention backward (_bwd :264): _bwd_dkv_kernel (body :172,
//     pallas_call :276) and _bwd_dq_kernel (body :221, pallas_call :304)
//     with _bwd's delta = rowsum(do * o) (:269) -- the custom_vjp of the
//     training path;
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
// Products (all four kernels): mma.sync.m16n8k8 TF32 tensor-core
//   instructions in the 3xTF32 split, accumulated in float32 registers.
//   Each float32 operand x is split into big = x rounded to TF32 (a
//   10-bit mantissa; nearest, ties away from zero: what cvt.rna.tf32.f32
//   gives) and small = x - big truncated to TF32, and a b = a_small b_big
//   + a_big b_small + a_big b_big.  The dropped a_small b_small and the
//   truncation of the small parts are ~2^-22 of each product, float32's
//   own order, where one TF32 pass keeps 2^-11.
//   The three products of one k-step are summed in a fresh tile and
//   added to the float32 accumulator outside the tensor cores (mma3):
//   their own accumulation truncates, and chained over every k-step it
//   measured 4-6e-6 against the plain versions, 1-2e-6 this way
//   (scripts/probe_flash.py, variant `chained`).
//   The C fragment of a score tile (lane: rows g, g + 8; columns 2t,
//   2t + 1) is the A fragment of the next product once the product's k
//   index is permuted (k = t <-> column 2t, k = t + 4 <-> column 2t + 1)
//   and its B fragment reads the same rows: P and dS never leave the
//   registers.
//
// Bound on this card: bytes at the prefill shapes (dh = 64, T in the
//   tens to hundreds: a few FLOPs per byte of q/k/v/o moved); operations
//   at the training shape (BH 256, T 256, dh 64), where the least time is
//   the float32 FLOPs over TF32's dense rate / 3.
//
// Forward design: one CTA per (b*h, kFwdWarps * 16 q rows), 16 q rows a
//   warp -- Hopper runs CTAs in no order, so the TPU's innermost
//   sequential kv grid axis becomes a loop inside the CTA over 64-row K/V
//   tiles, stopping at the diagonal tile when causal (the TPU kernel's
//   `needed` skip); only a tile that crosses the diagonal or Tk applies
//   the mask.  The warp's q rows stay in registers as raw A fragments
//   (split per use).  K/V tiles arrive through a kFwdStages-deep
//   cp.async ring in dynamic shared memory (row pitch dh + 4: the B
//   fragment reads of both products hit 32 distinct banks); the int8
//   instance cannot cp.async through its widening step, so it loads 16
//   codes a thread into registers and stores float(code) * scale into
//   the same ring.  The online softmax runs on the accumulator fragments,
//   its row max reduced over the 4 lanes that share a row.  What bounds
//   it now: issuing the split (3 integer / float operations per
//   operand element, per warp) and of the float32 adds beside the
//   mma.sync pipe, at 2 CTAs an SM (registers).
//
// Backward (flash_attention_bwd_dq_f32, then flash_attention_bwd_dkv_f32):
//   FlashAttention-2 as the TPU kernels compute it.  The caller supplies
//   the forward's o and lse [BH, Tq]; the dQ kernel, launched first,
//   writes delta = rowsum(do * o) [BH, Tq] (the TPU _bwd leaves it to
//   XLA) beside dq, and the dK/dV kernel reads it.  Both recompute s = q
//   k^T * scale (masked at -1e30, so p is exactly 0 there), p = exp(s -
//   lse), dp = do v^T and ds = p (dp - delta) scale.  dK/dV: dV = p^T
//   do, dK = ds^T q.  dQ: dQ = ds k.
//   Bound on this card: operations at the training shape (4 resp. 3
//   products of T x T x dh per (b, h), ~40 FLOPs per byte moved).
//   Every output row belongs to exactly one CTA (no atomics: the result
//   is the same bit for bit from run to run).
//   dK/dV design: one CTA per (b*h, 64-row K/V tile), 16 K/V rows a warp,
//   the tile resident in shared memory.  It loops over q tiles of
//   bwd_q_rows<dh>() rows, from the diagonal when causal (q rows before
//   it see none of the tile's columns: the TPU kernel's `needed` skip);
//   q, do, lse and delta come through a kBwdStages-deep cp.async ring.
//   Per q tile a warp computes S^T = K Q^T and dP^T = V dO^T (its K/V
//   rows as A fragments), turns them into P^T and dS^T in place, and
//   accumulates dV += P^T dO and dK += dS^T Q in registers: four 3xTF32
//   products.  What bounds it now: as the forward.
//   dQ design: the forward's tiling -- one CTA per (b*h, 64 q rows), 16
//   q rows a warp, a loop over 64-row K/V tiles up to the diagonal when
//   causal, K/V through a kDqStages-deep cp.async ring (pitch dh + 4).
//   The CTA's q and dO rows are staged once into shared memory, where
//   the warp reads its A fragments at every k-step (held in registers
//   they took 64 more floats a lane at dh 64 and spilled at 255:
//   scripts/probe_flash.py, `dq_regs`).  Per K/V tile a warp computes S = Q K^T and dP = dO V^T,
//   turns S into dS in registers and accumulates dQ += dS K with dS as
//   the A fragment (the C -> A permutation of the forward's P V): three
//   3xTF32 products.  delta comes from the staged dO and a read of o.
//   A q row past Tq gets p = 0 and is not written; a K column past Tk
//   is masked.
//
// Element types (JAX's kernels widen every operand on load,
//   flash_attention.py:109-111, and store o, dq, dk and dv in their
//   operand's dtype): each kernel also has a kLow instance, whose q (with
//   o, dO and dq), k (with dk) and v (with dv) are each float32 or bf16
//   as the launch's dts bits say (its C entries are the _bf16 ones).  A
//   bf16 operand is widened to float32 as it is loaded: its K/V, q and dO
//   tiles 4 values a thread through registers into the same float32
//   shared-memory tiles cp.async fills for float32 (the int8 instance's
//   route), its fragments and o rows value by value.  The products, the
//   softmax, lse and delta are the float32 instance's, and each output is
//   rounded once to its dtype.  The float32 and int8 instances (kLow =
//   false) compile as they did and ignore dts.
//
// Head dims: the kernels above are compiled at dh 16, 32, 64 and 128 (the
//   wrappers zero-pad any other dh up to 128 to the next); dh 256, 384 and
//   512 run the _wide kernels below (the same three contracts, the
//   forward's int8 instance included), which split the head dim across
//   the CTA's warps and sum the score tiles' partials through shared
//   memory in warp order (their section says why and how).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

// ------------------------------------------------- tensor-core helpers

// x = big + small as two TF32 operands.  mma.sync reads the top 19 bits
// of a .tf32 register and drops the low 13, so big is x plus half a TF32
// ulp (the tensor cores see x rounded to nearest, ties away from zero:
// cvt.rna.tf32.f32's value) and small is x minus that value, exact in
// float32, which they see truncated.  Three operations an element.
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = __float_as_uint(x) + 0x1000u;
  small = __float_as_uint(x - __uint_as_float(big & 0xffffe000u));
}

// d += a b on one m16n8k8 TF32 tile
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in 3xTF32 for one k-step of 8: the three products, small
// ones first, summed in a fresh tile, then added to d in float32.  The
// tensor cores align and truncate each sum they accumulate, so a tile
// chained through every k-step would collect one truncation per mma --
// a bias toward zero of ~2^-24 each, 96 of them for P V over 256
// columns -- where this keeps those relative to one k-step's own sum,
// and rounds the running sum to nearest.
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4], float b0,
                                     float b1) {
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

// the A fragment {x0, x1, x2, x3} split into big and small parts
__device__ __forceinline__ void split4(float x0, float x1, float x2, float x3,
                                       uint32_t (&big)[4],
                                       uint32_t (&small)[4]) {
  split(x0, big[0], small[0]);
  split(x1, big[1], small[1]);
  split(x2, big[2], small[2]);
  split(x3, big[3], small[3]);
}

// 16 (or 4) bytes global -> shared; valid = false zero-fills
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ------------------------------------------------------ operand types

// The bits of a launch's `dts`: which operands are bf16 (q with o, dO
// and dq; k with dk; v with dv).  Only a kLow instance reads them; every
// other instance reads and writes float32 (or int8 K/V) and ignores dts.
constexpr int kQ = 1, kK = 2, kV = 4;
using bf16 = __nv_bfloat16;

// A read-only operand as the kernels index it: float32, or bf16 in a
// kLow instance whose flag says so (widened on load).  For kLow = false
// it is the float pointer itself.
template <bool kLow>
struct In {
  const void* p;
  bool bf;
  __device__ __forceinline__ float operator[](size_t i) const {
    if constexpr (kLow)
      if (bf) return __bfloat162float(static_cast<const bf16*>(p)[i]);
    return static_cast<const float*>(p)[i];
  }
  __device__ __forceinline__ In operator+(size_t i) const {
    if constexpr (kLow)
      if (bf) return {static_cast<const bf16*>(p) + i, bf};
    return {static_cast<const float*>(p) + i, bf};
  }
  // 4 values at i (16-byte aligned as float32, 8 as bf16)
  __device__ __forceinline__ float4 ld4(size_t i) const {
    if constexpr (kLow)
      if (bf) {
        const uint2 u =
            *reinterpret_cast<const uint2*>(static_cast<const bf16*>(p) + i);
        const float2 a =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
        const float2 b =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
        return make_float4(a.x, a.y, b.x, b.y);
      }
    return *reinterpret_cast<const float4*>(static_cast<const float*>(p) + i);
  }
};

// An output operand: float32, or bf16 (each value rounded once to
// nearest even) in a kLow instance whose flag says so.
template <bool kLow>
struct Out {
  void* p;
  bool bf;
  // 2 adjacent values at i (8-byte aligned as float32)
  __device__ __forceinline__ void st2(size_t i, float a, float b) const {
    if constexpr (kLow)
      if (bf) {
        *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(p) + i) =
            __floats2bfloat162_rn(a, b);
        return;
      }
    *reinterpret_cast<float2*>(static_cast<float*>(p) + i) = make_float2(a, b);
  }
};

// 4 values of src (zero where !in) into dst (16-byte aligned shared
// floats): float32 through cp.async, bf16 loaded, widened and stored
// (visible, as cp.async's copy is, after the consumer's __syncthreads)
template <bool kLow>
__device__ __forceinline__ void stage4(float* dst, In<kLow> src, bool in) {
  if constexpr (kLow)
    if (src.bf) {
      *reinterpret_cast<float4*>(dst) =
          in ? src.ld4(0) : make_float4(0.f, 0.f, 0.f, 0.f);
      return;
    }
  cp_async16(dst, static_cast<const float*>(src.p), in);
}

// ------------------------------------------------------------- forward

constexpr int kKv = 64;           // K/V rows a tile (forward and dK/dV)
constexpr int kFwdWarps = 4;      // 16 q rows each
constexpr int kFwdStages = 2;     // cp.async ring depth
constexpr int kFwdThreads = kFwdWarps * 32;

template <int DH>
constexpr size_t fwd_smem_bytes() {
  return sizeof(float) * kFwdStages * 2 * kKv * (DH + 4);
}

// blockIdx.x = b * H + h.  q rows of (b, h) at q + (b * Tq + row) * D +
// h * DH; K/V rows of (b, g = h / (H / Hkv)) at (b * Tk + t) * Dkv + g *
// DH, in floats or, kInt8, in int8 codes with scales at (b * Tk + t) *
// Hkv + g; o [B, H, Tq, DH].  lse may be null (not written).
template <int DH, bool kInt8, bool kLow>
__global__ void __launch_bounds__(kFwdThreads)
flash_fwd_kernel(const void* __restrict__ q, const void* __restrict__ k,
                 const void* __restrict__ v,
                 const float* __restrict__ kscale,
                 const float* __restrict__ vscale, void* __restrict__ o,
                 float* __restrict__ lse, int H, int Hkv, int Tq, int Tk,
                 float scale, int causal, int dts) {
  constexpr int kP = DH + 4;      // shared row pitch (floats)
  constexpr int kBq = kFwdWarps * 16;
  constexpr int kD8 = DH / 8;     // k-steps of S, n-tiles of O
  extern __shared__ __align__(16) float smem[];

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int grp = h / (H / Hkv);
  const int D = H * DH;
  const int Dkv = Hkv * DH;
  const int q0 = blockIdx.y * kBq;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int r_lo = q0 + warp * 16 + g, r_hi = r_lo + 8;
  const size_t kv_row0 = (size_t)b * Tk;      // first K/V row of batch b
  const int last = causal ? min(q0 + kBq - 1, Tk - 1) : Tk - 1;
  const int n_tiles = last / kKv + 1;
  const In<kLow> kin{k, (dts & kK) != 0}, vin{v, (dts & kV) != 0};
  const Out<kLow> oout{o, (dts & kQ) != 0};

  // K/V tile j into ring slot j % kFwdStages, zero past Tk
  auto stage = [&](int j) {
    float* ks = smem + (j % kFwdStages) * 2 * kKv * kP;
    float* vs = ks + kKv * kP;
    const int t0 = j * kKv;
    if constexpr (kInt8) {
      constexpr int kChunks = DH / 16;        // 16 codes a load
      for (int e = threadIdx.x; e < kKv * kChunks; e += kFwdThreads) {
        const int row = e / kChunks, c = (e % kChunks) * 16, t = t0 + row;
        int4 kc = make_int4(0, 0, 0, 0), vc = kc;
        float sk = 0.f, sv = 0.f;
        if (t < Tk) {
          // a byte offset that is a multiple of 16 (Dkv and DH are)
          const size_t off = (kv_row0 + t) * Dkv + (size_t)grp * DH + c;
          kc = *reinterpret_cast<const int4*>(
              static_cast<const int8_t*>(k) + off);
          vc = *reinterpret_cast<const int4*>(
              static_cast<const int8_t*>(v) + off);
          sk = kscale[(kv_row0 + t) * Hkv + grp];
          sv = vscale[(kv_row0 + t) * Hkv + grp];
        }
        const int8_t* k8 = reinterpret_cast<const int8_t*>(&kc);
        const int8_t* v8 = reinterpret_cast<const int8_t*>(&vc);
        float* kd = ks + row * kP + c;
        float* vd = vs + row * kP + c;
#pragma unroll
        for (int u = 0; u < 16; u += 4) {
          *reinterpret_cast<float4*>(kd + u) = make_float4(
              __fmul_rn(static_cast<float>(k8[u]), sk),
              __fmul_rn(static_cast<float>(k8[u + 1]), sk),
              __fmul_rn(static_cast<float>(k8[u + 2]), sk),
              __fmul_rn(static_cast<float>(k8[u + 3]), sk));
          *reinterpret_cast<float4*>(vd + u) = make_float4(
              __fmul_rn(static_cast<float>(v8[u]), sv),
              __fmul_rn(static_cast<float>(v8[u + 1]), sv),
              __fmul_rn(static_cast<float>(v8[u + 2]), sv),
              __fmul_rn(static_cast<float>(v8[u + 3]), sv));
        }
      }
    } else {
      constexpr int kChunks = DH / 4;         // 4 floats a copy
      for (int e = threadIdx.x; e < kKv * kChunks; e += kFwdThreads) {
        const int row = e / kChunks, c = (e % kChunks) * 4, t = t0 + row;
        const bool in = t < Tk;
        const size_t off = in ? (kv_row0 + t) * Dkv + (size_t)grp * DH + c
                              : 0;
        stage4(ks + row * kP + c, kin + off, in);
        stage4(vs + row * kP + c, vin + off, in);
      }
    }
  };

  for (int j = 0; j < kFwdStages - 1; ++j) {
    if (j < n_tiles) stage(j);
    cp_async_commit();
  }

  // the warp's 16 q rows as raw A fragments, zero past Tq
  const In<kLow> qb = In<kLow>{q, (dts & kQ) != 0} + ((size_t)b * Tq * D + (size_t)h * DH);
  float qa[kD8][4];
#pragma unroll
  for (int kk = 0; kk < kD8; ++kk) {
    const int c = kk * 8 + t4;
    qa[kk][0] = r_lo < Tq ? qb[(size_t)r_lo * D + c] : 0.f;
    qa[kk][1] = r_hi < Tq ? qb[(size_t)r_hi * D + c] : 0.f;
    qa[kk][2] = r_lo < Tq ? qb[(size_t)r_lo * D + c + 4] : 0.f;
    qa[kk][3] = r_hi < Tq ? qb[(size_t)r_hi * D + c + 4] : 0.f;
  }

  // running max (per row, equal over the row's 4 lanes), this lane's
  // share of the row sum, and the O fragments
  float m_lo = kNeg, m_hi = kNeg, l_lo = 0.f, l_hi = 0.f;
  float acc[kD8][4];
#pragma unroll
  for (int n = 0; n < kD8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<kFwdStages - 2>();    // tile j landed (this thread's)
    __syncthreads();                    // ... all threads'; slot j - 1 free
    if (j + kFwdStages - 1 < n_tiles) stage(j + kFwdStages - 1);
    cp_async_commit();
    const float* ks = smem + (j % kFwdStages) * 2 * kKv * kP;
    const float* vs = ks + kKv * kP;
    const int t0 = j * kKv;

    // S = Q K^T over the tile's 64 columns (8 n-tiles)
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kD8; ++kk) {
      uint32_t ab[4], as[4];
      split4(qa[kk][0], qa[kk][1], qa[kk][2], qa[kk][3], ab, as);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float* kr = ks + (n * 8 + g) * kP + kk * 8 + t4;
        mma3(s[n], ab, as, kr[0], kr[4]);
      }
    }

    // scale, mask (only a tile crossing Tk or this warp's diagonal),
    // the online softmax
    const bool masked = t0 + kKv > Tk ||
                        (causal && t0 + kKv - 1 > q0 + warp * 16);
    float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = t0 + n * 8 + 2 * t4 + e;
        float lo = s[n][e] * scale, hi = s[n][2 + e] * scale;
        if (masked) {
          if (col >= Tk || (causal && col > r_lo)) lo = kNeg;
          if (col >= Tk || (causal && col > r_hi)) hi = kNeg;
        }
        s[n][e] = lo;
        s[n][2 + e] = hi;
        mx_lo = fmaxf(mx_lo, lo);
        mx_hi = fmaxf(mx_hi, hi);
      }
    }
#pragma unroll
    for (int x = 1; x < 4; x <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(kFull, mx_lo, x));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(kFull, mx_hi, x));
    }
    const float al_lo = expf(m_lo - mx_lo), al_hi = expf(m_hi - mx_hi);
    m_lo = mx_lo;
    m_hi = mx_hi;
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[n][e] = expf(s[n][e] - m_lo);
        s[n][2 + e] = expf(s[n][2 + e] - m_hi);
        sum_lo += s[n][e];
        sum_hi += s[n][2 + e];
      }
    }
    l_lo = l_lo * al_lo + sum_lo;
    l_hi = l_hi * al_hi + sum_hi;
#pragma unroll
    for (int n = 0; n < kD8; ++n) {
      acc[n][0] *= al_lo;
      acc[n][1] *= al_lo;
      acc[n][2] *= al_hi;
      acc[n][3] *= al_hi;
    }

    // O += P V: P's k-step jj is S's n-tile jj under the permuted k
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      uint32_t ab[4], as[4];
      split4(s[jj][0], s[jj][2], s[jj][1], s[jj][3], ab, as);
      const float* vr = vs + (jj * 8 + 2 * t4) * kP + g;
#pragma unroll
      for (int n = 0; n < kD8; ++n)
        mma3(acc[n], ab, as, vr[n * 8], vr[kP + n * 8]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int x = 1; x < 4; x <<= 1) {
    l_lo += __shfl_xor_sync(kFull, l_lo, x);
    l_hi += __shfl_xor_sync(kFull, l_hi, x);
  }
  const float den_lo = fmaxf(l_lo, 1e-30f), den_hi = fmaxf(l_hi, 1e-30f);
  if (r_lo < Tq) {
    const size_t orow = ((size_t)bh * Tq + r_lo) * DH + 2 * t4;
#pragma unroll
    for (int n = 0; n < kD8; ++n)
      oout.st2(orow + n * 8, acc[n][0] / den_lo, acc[n][1] / den_lo);
    if (lse != nullptr && t4 == 0)
      lse[(size_t)bh * Tq + r_lo] = m_lo + logf(den_lo);
  }
  if (r_hi < Tq) {
    const size_t orow = ((size_t)bh * Tq + r_hi) * DH + 2 * t4;
#pragma unroll
    for (int n = 0; n < kD8; ++n)
      oout.st2(orow + n * 8, acc[n][2] / den_hi, acc[n][3] / den_hi);
    if (lse != nullptr && t4 == 0)
      lse[(size_t)bh * Tq + r_hi] = m_hi + logf(den_hi);
  }
}

// Launch a kernel with its dynamic shared memory.  Above the 48 KB
// default the kernel's limit is raised first, once per device: `raised`
// (one per kernel instance) holds a bit for each device already set, as
// cudaFuncSetAttribute costs microseconds of host time a launch.
template <typename Kernel, typename... Args>
int launch_smem(Kernel kernel, size_t smem, std::atomic<unsigned>& raised,
                dim3 grid, int threads, cudaStream_t st, Args... args) {
  if (smem > 48 * 1024) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    const unsigned bit = dev < 32 ? 1u << dev : 0u;
    if (bit == 0u || !(raised.load() & bit)) {
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
      raised.fetch_or(bit);
    }
  }
  kernel<<<grid, threads, smem, st>>>(args...);
  return static_cast<int>(cudaGetLastError());
}


// ------------------------------------------------------- backward dK/dV

constexpr int kBwdWarps = 4;      // 16 K/V rows each
constexpr int kBwdStages = 2;     // cp.async ring depth
constexpr int kBwdThreads = kBwdWarps * 32;
static_assert(kBwdWarps * 16 == kKv, "a dK/dV CTA holds one K/V tile");

// q rows a staged q tile (registers: S^T and dP^T take 2 * rows / 8 x 4
// floats a lane beside dK and dV's dh).  32 at every dh: probe_flash.py
// timed it faster than 64 at dh 64, and 64 does not fit dh 128.
template <int DH>
__host__ __device__ constexpr int bwd_q_rows() {
  return 32;
}

template <int DH>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (2 * kKv * (DH + 4) +
                          kBwdStages * (2 * bwd_q_rows<DH>() * (DH + 4) +
                                        2 * bwd_q_rows<DH>()));
}

// blockIdx.x = b*h, blockIdx.y = K/V tile.  q/do [BH, Tq, DH], k/v/dk/dv
// [BH, Tk, DH], lse/delta [BH, Tq].
template <int DH, bool kLow>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_dkv_kernel(const void* __restrict__ q, const void* __restrict__ k,
                     const void* __restrict__ v,
                     const void* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, void* __restrict__ dk,
                     void* __restrict__ dv, int Tq, int Tk, float scale,
                     int causal, int dts) {
  constexpr int kP = DH + 4;
  constexpr int kBq = bwd_q_rows<DH>();
  constexpr int kD8 = DH / 8;     // k-steps of S^T / dP^T, n-tiles of dK/dV
  constexpr int kQ8 = kBq / 8;    // n-tiles of S^T / dP^T, k-steps of dK/dV
  constexpr int kSlot = 2 * kBq * kP + 2 * kBq;   // floats a ring slot
  constexpr int kChunks = DH / 4;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* vs = ks + kKv * kP;
  float* ring = vs + kKv * kP;

  const size_t bh = blockIdx.x;
  const int k0 = blockIdx.y * kKv;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int kr_lo = k0 + warp * 16 + g, kr_hi = kr_lo + 8;   // K/V rows
  const In<kLow> qb = In<kLow>{q, (dts & kQ) != 0} + bh * Tq * DH;
  const In<kLow> dob = In<kLow>{dout, (dts & kQ) != 0} + bh * Tq * DH;
  const In<kLow> kin{k, (dts & kK) != 0}, vin{v, (dts & kV) != 0};
  const Out<kLow> dkout{dk, (dts & kK) != 0}, dvout{dv, (dts & kV) != 0};
  const float* lseb = lse + bh * Tq;
  const float* deltab = delta + bh * Tq;

  // the K/V tile: one cp.async group ahead of the ring's
  for (int e = threadIdx.x; e < kKv * kChunks; e += kBwdThreads) {
    const int row = e / kChunks, c = (e % kChunks) * 4;
    const bool in = k0 + row < Tk;
    const size_t off = in ? (bh * Tk + k0 + row) * DH + c : 0;
    stage4(ks + row * kP + c, kin + off, in);
    stage4(vs + row * kP + c, vin + off, in);
  }
  cp_async_commit();

  // causal: q rows before k0 see none of this tile's columns
  const int qt0 = causal ? k0 / kBq : 0;
  const int n_q = (Tq + kBq - 1) / kBq - qt0;

  // q tile qt0 + j (q, do, lse, delta) into ring slot j % kBwdStages
  auto stage = [&](int j) {
    float* qs = ring + (j % kBwdStages) * kSlot;
    float* dos = qs + kBq * kP;
    float* ls = dos + kBq * kP;
    float* dls = ls + kBq;
    const int q0 = (qt0 + j) * kBq;
    for (int e = threadIdx.x; e < kBq * kChunks; e += kBwdThreads) {
      const int row = e / kChunks, c = (e % kChunks) * 4;
      const bool in = q0 + row < Tq;
      const size_t off = in ? (size_t)(q0 + row) * DH + c : 0;
      stage4(qs + row * kP + c, qb + off, in);
      stage4(dos + row * kP + c, dob + off, in);
    }
    for (int e = threadIdx.x; e < kBq; e += kBwdThreads) {
      const bool in = q0 + e < Tq;
      cp_async4(ls + e, lseb + (in ? q0 + e : 0), in);
      cp_async4(dls + e, deltab + (in ? q0 + e : 0), in);
    }
  };

  for (int j = 0; j < kBwdStages - 1; ++j) {
    if (j < n_q) stage(j);
    cp_async_commit();
  }

  float dka[kD8][4], dva[kD8][4];
#pragma unroll
  for (int n = 0; n < kD8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dka[n][i] = dva[n][i] = 0.f;

  const float* kw = ks + (warp * 16 + g) * kP + t4;   // this warp's rows
  const float* vw = vs + (warp * 16 + g) * kP + t4;
  for (int j = 0; j < n_q; ++j) {
    cp_async_wait<kBwdStages - 2>();    // K/V and q tile j landed
    __syncthreads();                    // ... all threads'; slot j - 1 free
    if (j + kBwdStages - 1 < n_q) stage(j + kBwdStages - 1);
    cp_async_commit();
    const float* qs = ring + (j % kBwdStages) * kSlot;
    const float* dos = qs + kBq * kP;
    const float* ls = dos + kBq * kP;
    const float* dls = ls + kBq;
    const int q0 = (qt0 + j) * kBq;

    // S^T = K Q^T and dP^T = V dO^T: rows = this warp's 16 K/V rows,
    // columns = the tile's q rows
    float st[kQ8][4], dpt[kQ8][4];
#pragma unroll
    for (int n = 0; n < kQ8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) st[n][i] = dpt[n][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kD8; ++kk) {
      const float* kr = kw + kk * 8;
      const float* vr = vw + kk * 8;
      uint32_t kb[4], ksm[4], vb[4], vsm[4];
      split4(kr[0], kr[8 * kP], kr[4], kr[8 * kP + 4], kb, ksm);
      split4(vr[0], vr[8 * kP], vr[4], vr[8 * kP + 4], vb, vsm);
#pragma unroll
      for (int n = 0; n < kQ8; ++n) {
        const float* qr = qs + (n * 8 + g) * kP + kk * 8 + t4;
        const float* dr = dos + (n * 8 + g) * kP + kk * 8 + t4;
        mma3(st[n], kb, ksm, qr[0], qr[4]);
        mma3(dpt[n], vb, vsm, dr[0], dr[4]);
      }
    }

    // P^T and dS^T in place; the mask only where the tile crosses the
    // diagonal, p = 0 on q rows past Tq
    const bool diag = causal && q0 < k0 + kKv - 1;
#pragma unroll
    for (int n = 0; n < kQ8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qi = n * 8 + 2 * t4 + e, qrow = q0 + qi;
        const float l = ls[qi], dl = dls[qi];
        float lo = st[n][e] * scale, hi = st[n][2 + e] * scale;
        if (diag) {
          if (kr_lo > qrow) lo = kNeg;
          if (kr_hi > qrow) hi = kNeg;
        }
        const float p_lo = qrow < Tq ? expf(lo - l) : 0.f;
        const float p_hi = qrow < Tq ? expf(hi - l) : 0.f;
        st[n][e] = p_lo;
        st[n][2 + e] = p_hi;
        dpt[n][e] = p_lo * (dpt[n][e] - dl) * scale;
        dpt[n][2 + e] = p_hi * (dpt[n][2 + e] - dl) * scale;
      }
    }

    // dV += P^T dO, dK += dS^T Q: k-step jj is n-tile jj of S^T under
    // the permuted k (q rows jj * 8 + 2t and + 1)
#pragma unroll
    for (int jj = 0; jj < kQ8; ++jj) {
      uint32_t pb[4], ps[4], sb[4], ss[4];
      split4(st[jj][0], st[jj][2], st[jj][1], st[jj][3], pb, ps);
      split4(dpt[jj][0], dpt[jj][2], dpt[jj][1], dpt[jj][3], sb, ss);
      const float* dr = dos + (jj * 8 + 2 * t4) * kP + g;
      const float* qr = qs + (jj * 8 + 2 * t4) * kP + g;
#pragma unroll
      for (int n = 0; n < kD8; ++n) {
        mma3(dva[n], pb, ps, dr[n * 8], dr[kP + n * 8]);
        mma3(dka[n], sb, ss, qr[n * 8], qr[kP + n * 8]);
      }
    }
  }
  cp_async_wait<0>();

  if (kr_lo < Tk) {
    const size_t off = (bh * Tk + kr_lo) * DH + 2 * t4;
#pragma unroll
    for (int n = 0; n < kD8; ++n) {
      dkout.st2(off + n * 8, dka[n][0], dka[n][1]);
      dvout.st2(off + n * 8, dva[n][0], dva[n][1]);
    }
  }
  if (kr_hi < Tk) {
    const size_t off = (bh * Tk + kr_hi) * DH + 2 * t4;
#pragma unroll
    for (int n = 0; n < kD8; ++n) {
      dkout.st2(off + n * 8, dka[n][2], dka[n][3]);
      dvout.st2(off + n * 8, dva[n][2], dva[n][3]);
    }
  }
}

// ---------------------------------------------------------- backward dQ

constexpr int kDqWarps = 4;       // 16 q rows each
constexpr int kDqStages = 2;      // cp.async ring depth
constexpr int kDqThreads = kDqWarps * 32;

template <int DH>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (DH + 4) * (2 * kDqWarps * 16 + kDqStages * 2 * kKv);
}

// blockIdx.x = b*h, blockIdx.y = q tile.  q/do/o/dq [BH, Tq, DH], k/v
// [BH, Tk, DH], lse [BH, Tq]; writes delta [BH, Tq] = rowsum(do o) for
// the dK/dV kernel launched after it.
template <int DH, bool kLow>
__global__ void __launch_bounds__(kDqThreads)
flash_bwd_dq_kernel(const void* __restrict__ q, const void* __restrict__ k,
                    const void* __restrict__ v,
                    const void* __restrict__ dout,
                    const void* __restrict__ o,
                    const float* __restrict__ lse, float* __restrict__ delta,
                    void* __restrict__ dq, int Tq, int Tk, float scale,
                    int causal, int dts) {
  constexpr int kP = DH + 4;
  constexpr int kBq = kDqWarps * 16;
  constexpr int kD8 = DH / 8;     // k-steps of S / dP, n-tiles of dQ
  constexpr int kChunks = DH / 4;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* dos = qs + kBq * kP;
  float* ring = dos + kBq * kP;

  const size_t bh = blockIdx.x;
  const int q0 = blockIdx.y * kBq;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int w0 = warp * 16;                   // the warp's rows in the tile
  const int r_lo = q0 + w0 + g, r_hi = r_lo + 8;
  const In<kLow> kb = In<kLow>{k, (dts & kK) != 0} + bh * Tk * DH;
  const In<kLow> vb = In<kLow>{v, (dts & kV) != 0} + bh * Tk * DH;
  const In<kLow> qin{q, (dts & kQ) != 0}, doin{dout, (dts & kQ) != 0};
  const In<kLow> oin{o, (dts & kQ) != 0};
  const Out<kLow> dqout{dq, (dts & kQ) != 0};
  const int last = causal ? min(q0 + kBq - 1, Tk - 1) : Tk - 1;
  const int n_tiles = last / kKv + 1;

  // the tile's q and dO rows: the first cp.async group, zero past Tq
  for (int e = threadIdx.x; e < kBq * kChunks; e += kDqThreads) {
    const int row = e / kChunks, c = (e % kChunks) * 4;
    const bool in = q0 + row < Tq;
    const size_t off = in ? (bh * Tq + q0 + row) * DH + c : 0;
    stage4(qs + row * kP + c, qin + off, in);
    stage4(dos + row * kP + c, doin + off, in);
  }
  cp_async_commit();

  // K/V tile j into ring slot j % kDqStages, zero past Tk
  auto stage = [&](int j) {
    float* ks = ring + (j % kDqStages) * 2 * kKv * kP;
    float* vs = ks + kKv * kP;
    const int t0 = j * kKv;
    for (int e = threadIdx.x; e < kKv * kChunks; e += kDqThreads) {
      const int row = e / kChunks, c = (e % kChunks) * 4, t = t0 + row;
      const bool in = t < Tk;
      const size_t off = in ? (size_t)t * DH + c : 0;
      stage4(ks + row * kP + c, kb + off, in);
      stage4(vs + row * kP + c, vb + off, in);
    }
  };
  for (int j = 0; j < kDqStages - 1; ++j) {
    if (j < n_tiles) stage(j);
    cp_async_commit();
  }
  cp_async_wait<kDqStages - 1>();     // q and dO landed (this thread's)
  __syncthreads();                    // ... every thread's

  // delta = rowsum(dO o) in float32: a lane sums 4-column runs of rows
  // r_lo and r_hi, the row's 4 lanes reduce by shuffle
  const float* qw = qs + (w0 + g) * kP + t4;  // A fragment base, rows g
  const float* dw = dos + (w0 + g) * kP + t4;
  float dl_lo = 0.f, dl_hi = 0.f;
  {
    const In<kLow> o_lo = oin + (bh * Tq + (r_lo < Tq ? r_lo : 0)) * DH;
    const In<kLow> o_hi = oin + (bh * Tq + (r_hi < Tq ? r_hi : 0)) * DH;
#pragma unroll
    for (int c = 4 * t4; c < DH; c += 16) {
      const float4 a = o_lo.ld4(c);
      const float4 b = o_hi.ld4(c);
      const float* d_lo = dos + (w0 + g) * kP + c;
      const float* d_hi = d_lo + 8 * kP;
      dl_lo = fmaf(d_lo[0], a.x, dl_lo);
      dl_lo = fmaf(d_lo[1], a.y, dl_lo);
      dl_lo = fmaf(d_lo[2], a.z, dl_lo);
      dl_lo = fmaf(d_lo[3], a.w, dl_lo);
      dl_hi = fmaf(d_hi[0], b.x, dl_hi);
      dl_hi = fmaf(d_hi[1], b.y, dl_hi);
      dl_hi = fmaf(d_hi[2], b.z, dl_hi);
      dl_hi = fmaf(d_hi[3], b.w, dl_hi);
    }
  }
#pragma unroll
  for (int x = 1; x < 4; x <<= 1) {
    dl_lo += __shfl_xor_sync(kFull, dl_lo, x);
    dl_hi += __shfl_xor_sync(kFull, dl_hi, x);
  }
  if (t4 == 0) {
    if (r_lo < Tq) delta[bh * Tq + r_lo] = dl_lo;
    if (r_hi < Tq) delta[bh * Tq + r_hi] = dl_hi;
  }
  const float l_lo = r_lo < Tq ? lse[bh * Tq + r_lo] : 0.f;
  const float l_hi = r_hi < Tq ? lse[bh * Tq + r_hi] : 0.f;

  float acc[kD8][4];
#pragma unroll
  for (int n = 0; n < kD8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<kDqStages - 2>();     // tile j landed (this thread's)
    __syncthreads();                    // ... all threads'; slot j - 1 free
    if (j + kDqStages - 1 < n_tiles) stage(j + kDqStages - 1);
    cp_async_commit();
    const float* ks = ring + (j % kDqStages) * 2 * kKv * kP;
    const float* vs = ks + kKv * kP;
    const int t0 = j * kKv;

    // S = Q K^T and dP = dO V^T over the tile's 64 columns (8 n-tiles)
    float s[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = dp[n][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kD8; ++kk) {
      uint32_t qb_[4], qs_[4], db_[4], ds_[4];
      split4(qw[kk * 8], qw[8 * kP + kk * 8], qw[kk * 8 + 4],
             qw[8 * kP + kk * 8 + 4], qb_, qs_);
      split4(dw[kk * 8], dw[8 * kP + kk * 8], dw[kk * 8 + 4],
             dw[8 * kP + kk * 8 + 4], db_, ds_);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float* kr = ks + (n * 8 + g) * kP + kk * 8 + t4;
        const float* vr = vs + (n * 8 + g) * kP + kk * 8 + t4;
        mma3(s[n], qb_, qs_, kr[0], kr[4]);
        mma3(dp[n], db_, ds_, vr[0], vr[4]);
      }
    }

    // dS = P (dP - delta) scale in place of S, P = exp(S scale - lse);
    // the mask only on a tile crossing Tk or this warp's diagonal, p = 0
    // on q rows past Tq
    const bool masked = t0 + kKv > Tk ||
                        (causal && t0 + kKv - 1 > q0 + w0);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = t0 + n * 8 + 2 * t4 + e;
        float lo = s[n][e] * scale, hi = s[n][2 + e] * scale;
        if (masked) {
          if (col >= Tk || (causal && col > r_lo)) lo = kNeg;
          if (col >= Tk || (causal && col > r_hi)) hi = kNeg;
        }
        const float p_lo = r_lo < Tq ? expf(lo - l_lo) : 0.f;
        const float p_hi = r_hi < Tq ? expf(hi - l_hi) : 0.f;
        s[n][e] = p_lo * (dp[n][e] - dl_lo) * scale;
        s[n][2 + e] = p_hi * (dp[n][2 + e] - dl_hi) * scale;
      }
    }

    // dQ += dS K: dS's k-step jj is S's n-tile jj under the permuted k
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      uint32_t ab[4], as[4];
      split4(s[jj][0], s[jj][2], s[jj][1], s[jj][3], ab, as);
      const float* kr = ks + (jj * 8 + 2 * t4) * kP + g;
#pragma unroll
      for (int n = 0; n < kD8; ++n)
        mma3(acc[n], ab, as, kr[n * 8], kr[kP + n * 8]);
    }
  }
  cp_async_wait<0>();

  if (r_lo < Tq) {
    const size_t out = (bh * Tq + r_lo) * DH + 2 * t4;
#pragma unroll
    for (int n = 0; n < kD8; ++n)
      dqout.st2(out + n * 8, acc[n][0], acc[n][1]);
  }
  if (r_hi < Tq) {
    const size_t out = (bh * Tq + r_hi) * DH + 2 * t4;
#pragma unroll
    for (int n = 0; n < kD8; ++n)
      dqout.st2(out + n * 8, acc[n][2], acc[n][3]);
  }
}

// ------------------------------------------------ wide head dims (256+)

// At dh 256, 384 and 512 the templates above do not fit: the forward's
// q tile and 64-row K/V ring take 66.5 KB + 266 KB of shared memory at
// dh 256, and a warp owning 16 rows of an accumulator holds dh / 2
// floats a lane (256 at dh 512).  The _wide kernels split the head dim
// instead: each of kWideWarps warps owns kW = dh / kWideWarps columns of
// the accumulators (o; dq; dk and dv) and forms the score tiles' partial
// products over its columns; the partials meet in shared memory and are
// summed in warp order, so that every warp then holds the same score
// tile, bit for bit from run to run.  A CTA takes 16 rows (q rows, or
// K/V rows for dK/dV) and streams the other side in tiles of
// wide_rows<DH>() rows through a 2-stage cp.async ring.  The products
// are mma3's 3xTF32.
constexpr int kWideWarps = 8;
constexpr int kWideThreads = kWideWarps * 32;

// rows a streamed tile: 32 at dh 256, 16 wider (the ring's two stages
// of two tiles fit the 227 KB a CTA may have)
template <int DH>
__host__ __device__ constexpr int wide_rows() {
  return DH <= 256 ? 32 : 16;
}

// floats of one [16][rows + 8] partial-sum tile (pitch rows + 8)
template <int DH>
__host__ __device__ constexpr int wide_part() {
  return 16 * (wide_rows<DH>() + 8);
}

template <int DH>
constexpr size_t wide_fwd_smem_bytes() {
  return sizeof(float) * (2 * 2 * wide_rows<DH>() * (DH + 4) +
                          (kWideWarps + 1) * wide_part<DH>());
}
template <int DH>
constexpr size_t wide_dq_smem_bytes() {
  return sizeof(float) * (2 * 2 * wide_rows<DH>() * (DH + 4) +
                          2 * (kWideWarps + 1) * wide_part<DH>() +
                          kWideWarps * 16);
}
template <int DH>
constexpr size_t wide_dkv_smem_bytes() {
  return sizeof(float) * (2 * (2 * wide_rows<DH>() * (DH + 4) +
                               2 * wide_rows<DH>()) +
                          2 * (kWideWarps + 1) * wide_part<DH>());
}

// The warp's partial score tiles (kN n-tiles of 8 columns each, as C
// fragments) into its slots of `part`, a barrier, the sum over the warps
// in warp order into `sum`, a barrier, and the full tiles read back into
// `s` by every warp.  kTiles tiles [16][kN * 8]; kTiles * kWideWarps
// slots in `part`, kTiles in `sum`.
template <int kN, int kTiles>
__device__ __forceinline__ void wide_sum(float (&s)[kTiles][kN][4],
                                         float* part, float* sum, int warp,
                                         int g, int t4) {
  constexpr int kCols = kN * 8;
  constexpr int kSP = kCols + 8;
  constexpr int kTile = 16 * kSP;
#pragma unroll
  for (int x = 0; x < kTiles; ++x) {
    float* pw = part + (x * kWideWarps + warp) * kTile;
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      *reinterpret_cast<float2*>(pw + g * kSP + n * 8 + 2 * t4) =
          make_float2(s[x][n][0], s[x][n][1]);
      *reinterpret_cast<float2*>(pw + (g + 8) * kSP + n * 8 + 2 * t4) =
          make_float2(s[x][n][2], s[x][n][3]);
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kTiles * 16 * kCols; e += kWideThreads) {
    const int x = e / (16 * kCols);
    const int at = (e % (16 * kCols)) / kCols * kSP + e % kCols;
    const float* px = part + x * kWideWarps * kTile + at;
    float a = px[0];
#pragma unroll
    for (int w = 1; w < kWideWarps; ++w) a += px[w * kTile];
    sum[x * kTile + at] = a;
  }
  __syncthreads();
#pragma unroll
  for (int x = 0; x < kTiles; ++x) {
    const float* sx = sum + x * kTile;
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      const float2 lo =
          *reinterpret_cast<const float2*>(sx + g * kSP + n * 8 + 2 * t4);
      const float2 hi = *reinterpret_cast<const float2*>(
          sx + (g + 8) * kSP + n * 8 + 2 * t4);
      s[x][n][0] = lo.x;
      s[x][n][1] = lo.y;
      s[x][n][2] = hi.x;
      s[x][n][3] = hi.y;
    }
  }
}

// The forward at a wide head dim: flash_fwd_kernel's contract, one CTA
// per (b * h, 16 q rows).
template <int DH, bool kInt8, bool kLow>
__global__ void __launch_bounds__(kWideThreads)
flash_fwd_wide_kernel(const void* __restrict__ q, const void* __restrict__ k,
                      const void* __restrict__ v,
                      const float* __restrict__ kscale,
                      const float* __restrict__ vscale,
                      void* __restrict__ o, float* __restrict__ lse, int H,
                      int Hkv, int Tq, int Tk, float scale, int causal,
                      int dts) {
  constexpr int kP = DH + 4;
  constexpr int kR = wide_rows<DH>();   // K/V rows a tile
  constexpr int kN = kR / 8;            // n-tiles of S, k-steps of P V
  constexpr int kW = DH / kWideWarps;   // the warp's head-dim columns
  constexpr int kW8 = kW / 8;
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                                  // [2][K, V][kR][kP]
  float* part = ring + 2 * 2 * kR * kP;                // [warps][16][kR + 8]
  float* ssum = part + kWideWarps * wide_part<DH>();   // [16][kR + 8]

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int grp = h / (H / Hkv);
  const int D = H * DH;
  const int Dkv = Hkv * DH;
  const int q0 = blockIdx.y * 16;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int c0 = warp * kW;                 // the warp's first column
  const int r_lo = q0 + g, r_hi = r_lo + 8;
  const size_t kv_row0 = (size_t)b * Tk;
  const int last = causal ? min(q0 + 15, Tk - 1) : Tk - 1;
  const int n_tiles = last / kR + 1;
  const In<kLow> kin{k, (dts & kK) != 0}, vin{v, (dts & kV) != 0};
  const Out<kLow> oout{o, (dts & kQ) != 0};

  // K/V tile j into ring slot j % 2, zero past Tk
  auto stage = [&](int j) {
    float* ks = ring + (j % 2) * 2 * kR * kP;
    float* vs = ks + kR * kP;
    const int t0 = j * kR;
    if constexpr (kInt8) {
      constexpr int kChunks = DH / 16;
      for (int e = threadIdx.x; e < kR * kChunks; e += kWideThreads) {
        const int row = e / kChunks, c = (e % kChunks) * 16, t = t0 + row;
        int4 kc = make_int4(0, 0, 0, 0), vc = kc;
        float sk = 0.f, sv = 0.f;
        if (t < Tk) {
          const size_t off = (kv_row0 + t) * Dkv + (size_t)grp * DH + c;
          kc = *reinterpret_cast<const int4*>(
              static_cast<const int8_t*>(k) + off);
          vc = *reinterpret_cast<const int4*>(
              static_cast<const int8_t*>(v) + off);
          sk = kscale[(kv_row0 + t) * Hkv + grp];
          sv = vscale[(kv_row0 + t) * Hkv + grp];
        }
        const int8_t* k8 = reinterpret_cast<const int8_t*>(&kc);
        const int8_t* v8 = reinterpret_cast<const int8_t*>(&vc);
        float* kd = ks + row * kP + c;
        float* vd = vs + row * kP + c;
#pragma unroll
        for (int u = 0; u < 16; u += 4) {
          *reinterpret_cast<float4*>(kd + u) = make_float4(
              __fmul_rn(static_cast<float>(k8[u]), sk),
              __fmul_rn(static_cast<float>(k8[u + 1]), sk),
              __fmul_rn(static_cast<float>(k8[u + 2]), sk),
              __fmul_rn(static_cast<float>(k8[u + 3]), sk));
          *reinterpret_cast<float4*>(vd + u) = make_float4(
              __fmul_rn(static_cast<float>(v8[u]), sv),
              __fmul_rn(static_cast<float>(v8[u + 1]), sv),
              __fmul_rn(static_cast<float>(v8[u + 2]), sv),
              __fmul_rn(static_cast<float>(v8[u + 3]), sv));
        }
      }
    } else {
      constexpr int kChunks = DH / 4;
      for (int e = threadIdx.x; e < kR * kChunks; e += kWideThreads) {
        const int row = e / kChunks, c = (e % kChunks) * 4, t = t0 + row;
        const bool in = t < Tk;
        const size_t off = in ? (kv_row0 + t) * Dkv + (size_t)grp * DH + c
                              : 0;
        stage4(ks + row * kP + c, kin + off, in);
        stage4(vs + row * kP + c, vin + off, in);
      }
    }
  };
  stage(0);
  cp_async_commit();

  // the warp's columns of the CTA's 16 q rows as raw A fragments
  const In<kLow> qb =
      In<kLow>{q, (dts & kQ) != 0} + ((size_t)b * Tq * D + (size_t)h * DH + c0);
  float qa[kW8][4];
#pragma unroll
  for (int kk = 0; kk < kW8; ++kk) {
    const int c = kk * 8 + t4;
    qa[kk][0] = r_lo < Tq ? qb[(size_t)r_lo * D + c] : 0.f;
    qa[kk][1] = r_hi < Tq ? qb[(size_t)r_hi * D + c] : 0.f;
    qa[kk][2] = r_lo < Tq ? qb[(size_t)r_lo * D + c + 4] : 0.f;
    qa[kk][3] = r_hi < Tq ? qb[(size_t)r_hi * D + c + 4] : 0.f;
  }

  float m_lo = kNeg, m_hi = kNeg, l_lo = 0.f, l_hi = 0.f;
  float acc[kW8][4];
#pragma unroll
  for (int n = 0; n < kW8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<0>();                 // tile j landed (this thread's)
    __syncthreads();                    // ... all threads'; slot j - 1 free
    if (j + 1 < n_tiles) stage(j + 1);
    cp_async_commit();
    const float* ks = ring + (j % 2) * 2 * kR * kP;
    const float* vs = ks + kR * kP;
    const int t0 = j * kR;

    // S = Q K^T over the warp's columns, then summed over the warps
    float s[1][kN][4];
#pragma unroll
    for (int n = 0; n < kN; ++n)
      s[0][n][0] = s[0][n][1] = s[0][n][2] = s[0][n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kW8; ++kk) {
      uint32_t ab[4], as[4];
      split4(qa[kk][0], qa[kk][1], qa[kk][2], qa[kk][3], ab, as);
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        const float* kr = ks + (n * 8 + g) * kP + c0 + kk * 8 + t4;
        mma3(s[0][n], ab, as, kr[0], kr[4]);
      }
    }
    wide_sum<kN, 1>(s, part, ssum, warp, g, t4);

    // scale, mask (a tile crossing Tk or the CTA's diagonal), the
    // online softmax: every warp computes the same values
    const bool masked = t0 + kR > Tk || (causal && t0 + kR - 1 > q0);
    float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
    for (int n = 0; n < kN; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = t0 + n * 8 + 2 * t4 + e;
        float lo = s[0][n][e] * scale, hi = s[0][n][2 + e] * scale;
        if (masked) {
          if (col >= Tk || (causal && col > r_lo)) lo = kNeg;
          if (col >= Tk || (causal && col > r_hi)) hi = kNeg;
        }
        s[0][n][e] = lo;
        s[0][n][2 + e] = hi;
        mx_lo = fmaxf(mx_lo, lo);
        mx_hi = fmaxf(mx_hi, hi);
      }
    }
#pragma unroll
    for (int x = 1; x < 4; x <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(kFull, mx_lo, x));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(kFull, mx_hi, x));
    }
    const float al_lo = expf(m_lo - mx_lo), al_hi = expf(m_hi - mx_hi);
    m_lo = mx_lo;
    m_hi = mx_hi;
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int n = 0; n < kN; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[0][n][e] = expf(s[0][n][e] - m_lo);
        s[0][n][2 + e] = expf(s[0][n][2 + e] - m_hi);
        sum_lo += s[0][n][e];
        sum_hi += s[0][n][2 + e];
      }
    }
    l_lo = l_lo * al_lo + sum_lo;
    l_hi = l_hi * al_hi + sum_hi;
#pragma unroll
    for (int n = 0; n < kW8; ++n) {
      acc[n][0] *= al_lo;
      acc[n][1] *= al_lo;
      acc[n][2] *= al_hi;
      acc[n][3] *= al_hi;
    }

    // O += P V on the warp's columns
#pragma unroll
    for (int jj = 0; jj < kN; ++jj) {
      uint32_t ab[4], as[4];
      split4(s[0][jj][0], s[0][jj][2], s[0][jj][1], s[0][jj][3], ab, as);
      const float* vr = vs + (jj * 8 + 2 * t4) * kP + c0 + g;
#pragma unroll
      for (int n = 0; n < kW8; ++n)
        mma3(acc[n], ab, as, vr[n * 8], vr[kP + n * 8]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int x = 1; x < 4; x <<= 1) {
    l_lo += __shfl_xor_sync(kFull, l_lo, x);
    l_hi += __shfl_xor_sync(kFull, l_hi, x);
  }
  const float den_lo = fmaxf(l_lo, 1e-30f), den_hi = fmaxf(l_hi, 1e-30f);
  if (r_lo < Tq) {
    const size_t orow = ((size_t)bh * Tq + r_lo) * DH + c0 + 2 * t4;
#pragma unroll
    for (int n = 0; n < kW8; ++n)
      oout.st2(orow + n * 8, acc[n][0] / den_lo, acc[n][1] / den_lo);
    if (lse != nullptr && warp == 0 && t4 == 0)
      lse[(size_t)bh * Tq + r_lo] = m_lo + logf(den_lo);
  }
  if (r_hi < Tq) {
    const size_t orow = ((size_t)bh * Tq + r_hi) * DH + c0 + 2 * t4;
#pragma unroll
    for (int n = 0; n < kW8; ++n)
      oout.st2(orow + n * 8, acc[n][2] / den_hi, acc[n][3] / den_hi);
    if (lse != nullptr && warp == 0 && t4 == 0)
      lse[(size_t)bh * Tq + r_hi] = m_hi + logf(den_hi);
  }
}

// dQ at a wide head dim: flash_bwd_dq_kernel's contract (delta written
// for the dK/dV launch after it), one CTA per (b * h, 16 q rows).
template <int DH, bool kLow>
__global__ void __launch_bounds__(kWideThreads)
flash_bwd_dq_wide_kernel(const void* __restrict__ q,
                         const void* __restrict__ k,
                         const void* __restrict__ v,
                         const void* __restrict__ dout,
                         const void* __restrict__ o,
                         const float* __restrict__ lse,
                         float* __restrict__ delta, void* __restrict__ dq,
                         int Tq, int Tk, float scale, int causal, int dts) {
  constexpr int kP = DH + 4;
  constexpr int kR = wide_rows<DH>();
  constexpr int kN = kR / 8;
  constexpr int kW = DH / kWideWarps;
  constexpr int kW8 = kW / 8;
  constexpr int kChunks = DH / 4;
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                                     // [2][K, V][kR][kP]
  float* part = ring + 2 * 2 * kR * kP;                   // [2][warps][tile]
  float* ssum = part + 2 * kWideWarps * wide_part<DH>();  // [2][tile]
  float* dlp = ssum + 2 * wide_part<DH>();                // [warps][16]

  const size_t bh = blockIdx.x;
  const int q0 = blockIdx.y * 16;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int c0 = warp * kW;
  const int r_lo = q0 + g, r_hi = r_lo + 8;
  const In<kLow> kb = In<kLow>{k, (dts & kK) != 0} + bh * Tk * DH;
  const In<kLow> vb = In<kLow>{v, (dts & kV) != 0} + bh * Tk * DH;
  const In<kLow> qin{q, (dts & kQ) != 0}, doin{dout, (dts & kQ) != 0};
  const In<kLow> oin{o, (dts & kQ) != 0};
  const Out<kLow> dqout{dq, (dts & kQ) != 0};
  const int last = causal ? min(q0 + 15, Tk - 1) : Tk - 1;
  const int n_tiles = last / kR + 1;

  // K/V tile j into ring slot j % 2, zero past Tk
  auto stage = [&](int j) {
    float* ks = ring + (j % 2) * 2 * kR * kP;
    float* vs = ks + kR * kP;
    const int t0 = j * kR;
    for (int e = threadIdx.x; e < kR * kChunks; e += kWideThreads) {
      const int row = e / kChunks, c = (e % kChunks) * 4, t = t0 + row;
      const bool in = t < Tk;
      const size_t off = in ? (size_t)t * DH + c : 0;
      stage4(ks + row * kP + c, kb + off, in);
      stage4(vs + row * kP + c, vb + off, in);
    }
  };
  stage(0);
  cp_async_commit();

  // the warp's columns of q and dO as raw A fragments; delta = rowsum(dO
  // o) over the warp's columns and its row's 4 lanes, then the warps'
  // partials added in warp order
  const In<kLow> qr = qin + ((bh * Tq) * DH + c0);
  const In<kLow> dr = doin + ((bh * Tq) * DH + c0);
  const In<kLow> orw = oin + ((bh * Tq) * DH + c0);
  float qa[kW8][4], da[kW8][4];
  float dl_lo = 0.f, dl_hi = 0.f;
#pragma unroll
  for (int kk = 0; kk < kW8; ++kk) {
    const int c = kk * 8 + t4;
    const size_t lo = (size_t)r_lo * DH + c, hi = (size_t)r_hi * DH + c;
    const bool in_lo = r_lo < Tq, in_hi = r_hi < Tq;
    qa[kk][0] = in_lo ? qr[lo] : 0.f;
    qa[kk][1] = in_hi ? qr[hi] : 0.f;
    qa[kk][2] = in_lo ? qr[lo + 4] : 0.f;
    qa[kk][3] = in_hi ? qr[hi + 4] : 0.f;
    da[kk][0] = in_lo ? dr[lo] : 0.f;
    da[kk][1] = in_hi ? dr[hi] : 0.f;
    da[kk][2] = in_lo ? dr[lo + 4] : 0.f;
    da[kk][3] = in_hi ? dr[hi + 4] : 0.f;
    if (in_lo) {
      dl_lo = fmaf(da[kk][0], orw[lo], dl_lo);
      dl_lo = fmaf(da[kk][2], orw[lo + 4], dl_lo);
    }
    if (in_hi) {
      dl_hi = fmaf(da[kk][1], orw[hi], dl_hi);
      dl_hi = fmaf(da[kk][3], orw[hi + 4], dl_hi);
    }
  }
#pragma unroll
  for (int x = 1; x < 4; x <<= 1) {
    dl_lo += __shfl_xor_sync(kFull, dl_lo, x);
    dl_hi += __shfl_xor_sync(kFull, dl_hi, x);
  }
  if (t4 == 0) {
    dlp[warp * 16 + g] = dl_lo;
    dlp[warp * 16 + g + 8] = dl_hi;
  }
  __syncthreads();
  dl_lo = dlp[g];
  dl_hi = dlp[g + 8];
#pragma unroll
  for (int w = 1; w < kWideWarps; ++w) {
    dl_lo += dlp[w * 16 + g];
    dl_hi += dlp[w * 16 + g + 8];
  }
  if (warp == 0 && t4 == 0) {
    if (r_lo < Tq) delta[bh * Tq + r_lo] = dl_lo;
    if (r_hi < Tq) delta[bh * Tq + r_hi] = dl_hi;
  }
  const float l_lo = r_lo < Tq ? lse[bh * Tq + r_lo] : 0.f;
  const float l_hi = r_hi < Tq ? lse[bh * Tq + r_hi] : 0.f;

  float acc[kW8][4];
#pragma unroll
  for (int n = 0; n < kW8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<0>();
    __syncthreads();
    if (j + 1 < n_tiles) stage(j + 1);
    cp_async_commit();
    const float* ks = ring + (j % 2) * 2 * kR * kP;
    const float* vs = ks + kR * kP;
    const int t0 = j * kR;

    // S = Q K^T and dP = dO V^T over the warp's columns, then summed
    float sp[2][kN][4];
#pragma unroll
    for (int n = 0; n < kN; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) sp[0][n][i] = sp[1][n][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kW8; ++kk) {
      uint32_t qb_[4], qs_[4], db_[4], ds_[4];
      split4(qa[kk][0], qa[kk][1], qa[kk][2], qa[kk][3], qb_, qs_);
      split4(da[kk][0], da[kk][1], da[kk][2], da[kk][3], db_, ds_);
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        const float* kr = ks + (n * 8 + g) * kP + c0 + kk * 8 + t4;
        const float* vr = vs + (n * 8 + g) * kP + c0 + kk * 8 + t4;
        mma3(sp[0][n], qb_, qs_, kr[0], kr[4]);
        mma3(sp[1][n], db_, ds_, vr[0], vr[4]);
      }
    }
    wide_sum<kN, 2>(sp, part, ssum, warp, g, t4);

    // dS = P (dP - delta) scale in place of S
    const bool masked = t0 + kR > Tk || (causal && t0 + kR - 1 > q0);
#pragma unroll
    for (int n = 0; n < kN; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = t0 + n * 8 + 2 * t4 + e;
        float lo = sp[0][n][e] * scale, hi = sp[0][n][2 + e] * scale;
        if (masked) {
          if (col >= Tk || (causal && col > r_lo)) lo = kNeg;
          if (col >= Tk || (causal && col > r_hi)) hi = kNeg;
        }
        const float p_lo = r_lo < Tq ? expf(lo - l_lo) : 0.f;
        const float p_hi = r_hi < Tq ? expf(hi - l_hi) : 0.f;
        sp[0][n][e] = p_lo * (sp[1][n][e] - dl_lo) * scale;
        sp[0][n][2 + e] = p_hi * (sp[1][n][2 + e] - dl_hi) * scale;
      }
    }

    // dQ += dS K on the warp's columns
#pragma unroll
    for (int jj = 0; jj < kN; ++jj) {
      uint32_t ab[4], as[4];
      split4(sp[0][jj][0], sp[0][jj][2], sp[0][jj][1], sp[0][jj][3], ab,
             as);
      const float* kr = ks + (jj * 8 + 2 * t4) * kP + c0 + g;
#pragma unroll
      for (int n = 0; n < kW8; ++n)
        mma3(acc[n], ab, as, kr[n * 8], kr[kP + n * 8]);
    }
  }
  cp_async_wait<0>();

  if (r_lo < Tq) {
    const size_t out = (bh * Tq + r_lo) * DH + c0 + 2 * t4;
#pragma unroll
    for (int n = 0; n < kW8; ++n)
      dqout.st2(out + n * 8, acc[n][0], acc[n][1]);
  }
  if (r_hi < Tq) {
    const size_t out = (bh * Tq + r_hi) * DH + c0 + 2 * t4;
#pragma unroll
    for (int n = 0; n < kW8; ++n)
      dqout.st2(out + n * 8, acc[n][2], acc[n][3]);
  }
}

// dK/dV at a wide head dim: flash_bwd_dkv_kernel's contract, one CTA
// per (b * h, 16 K/V rows), q tiles of wide_rows<DH>() rows streamed.
template <int DH, bool kLow>
__global__ void __launch_bounds__(kWideThreads)
flash_bwd_dkv_wide_kernel(const void* __restrict__ q,
                          const void* __restrict__ k,
                          const void* __restrict__ v,
                          const void* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          void* __restrict__ dk, void* __restrict__ dv,
                          int Tq, int Tk, float scale, int causal, int dts) {
  constexpr int kP = DH + 4;
  constexpr int kBq = wide_rows<DH>();    // q rows a tile
  constexpr int kN = kBq / 8;             // n-tiles of S^T, k-steps of dK/dV
  constexpr int kW = DH / kWideWarps;
  constexpr int kW8 = kW / 8;
  constexpr int kChunks = DH / 4;
  constexpr int kSlot = 2 * kBq * kP + 2 * kBq;
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                                     // [2][slot]
  float* part = ring + 2 * kSlot;                         // [2][warps][tile]
  float* ssum = part + 2 * kWideWarps * wide_part<DH>();  // [2][tile]

  const size_t bh = blockIdx.x;
  const int k0 = blockIdx.y * 16;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int c0 = warp * kW;
  const int kr_lo = k0 + g, kr_hi = kr_lo + 8;
  const In<kLow> qb = In<kLow>{q, (dts & kQ) != 0} + bh * Tq * DH;
  const In<kLow> dob = In<kLow>{dout, (dts & kQ) != 0} + bh * Tq * DH;
  const In<kLow> kin{k, (dts & kK) != 0}, vin{v, (dts & kV) != 0};
  const Out<kLow> dkout{dk, (dts & kK) != 0}, dvout{dv, (dts & kV) != 0};
  const float* lseb = lse + bh * Tq;
  const float* deltab = delta + bh * Tq;

  // causal: q rows before k0 see none of this CTA's columns
  const int qt0 = causal ? k0 / kBq : 0;
  const int n_q = (Tq + kBq - 1) / kBq - qt0;

  // q tile qt0 + j (q, do, lse, delta) into ring slot j % 2
  auto stage = [&](int j) {
    float* qs = ring + (j % 2) * kSlot;
    float* dos = qs + kBq * kP;
    float* ls = dos + kBq * kP;
    float* dls = ls + kBq;
    const int q0 = (qt0 + j) * kBq;
    for (int e = threadIdx.x; e < kBq * kChunks; e += kWideThreads) {
      const int row = e / kChunks, c = (e % kChunks) * 4;
      const bool in = q0 + row < Tq;
      const size_t off = in ? (size_t)(q0 + row) * DH + c : 0;
      stage4(qs + row * kP + c, qb + off, in);
      stage4(dos + row * kP + c, dob + off, in);
    }
    for (int e = threadIdx.x; e < kBq; e += kWideThreads) {
      const bool in = q0 + e < Tq;
      cp_async4(ls + e, lseb + (in ? q0 + e : 0), in);
      cp_async4(dls + e, deltab + (in ? q0 + e : 0), in);
    }
  };
  if (n_q > 0) stage(0);
  cp_async_commit();

  // the warp's columns of the CTA's 16 K and V rows as raw A fragments
  const In<kLow> kw = kin + (bh * Tk * DH + c0);
  const In<kLow> vw = vin + (bh * Tk * DH + c0);
  float ka[kW8][4], va[kW8][4];
#pragma unroll
  for (int kk = 0; kk < kW8; ++kk) {
    const int c = kk * 8 + t4;
    const size_t lo = (size_t)kr_lo * DH + c, hi = (size_t)kr_hi * DH + c;
    const bool in_lo = kr_lo < Tk, in_hi = kr_hi < Tk;
    ka[kk][0] = in_lo ? kw[lo] : 0.f;
    ka[kk][1] = in_hi ? kw[hi] : 0.f;
    ka[kk][2] = in_lo ? kw[lo + 4] : 0.f;
    ka[kk][3] = in_hi ? kw[hi + 4] : 0.f;
    va[kk][0] = in_lo ? vw[lo] : 0.f;
    va[kk][1] = in_hi ? vw[hi] : 0.f;
    va[kk][2] = in_lo ? vw[lo + 4] : 0.f;
    va[kk][3] = in_hi ? vw[hi + 4] : 0.f;
  }

  float dka[kW8][4], dva[kW8][4];
#pragma unroll
  for (int n = 0; n < kW8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dka[n][i] = dva[n][i] = 0.f;

  for (int j = 0; j < n_q; ++j) {
    cp_async_wait<0>();
    __syncthreads();
    if (j + 1 < n_q) stage(j + 1);
    cp_async_commit();
    const float* qs = ring + (j % 2) * kSlot;
    const float* dos = qs + kBq * kP;
    const float* ls = dos + kBq * kP;
    const float* dls = ls + kBq;
    const int q0 = (qt0 + j) * kBq;

    // S^T = K Q^T and dP^T = V dO^T over the warp's columns, then summed
    float sp[2][kN][4];
#pragma unroll
    for (int n = 0; n < kN; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) sp[0][n][i] = sp[1][n][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kW8; ++kk) {
      uint32_t kb[4], ksm[4], vb[4], vsm[4];
      split4(ka[kk][0], ka[kk][1], ka[kk][2], ka[kk][3], kb, ksm);
      split4(va[kk][0], va[kk][1], va[kk][2], va[kk][3], vb, vsm);
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        const float* qr = qs + (n * 8 + g) * kP + c0 + kk * 8 + t4;
        const float* dr = dos + (n * 8 + g) * kP + c0 + kk * 8 + t4;
        mma3(sp[0][n], kb, ksm, qr[0], qr[4]);
        mma3(sp[1][n], vb, vsm, dr[0], dr[4]);
      }
    }
    wide_sum<kN, 2>(sp, part, ssum, warp, g, t4);

    // P^T and dS^T in place; the mask only where the tile crosses the
    // diagonal, p = 0 on q rows past Tq
    const bool diag = causal && q0 < k0 + 15;
#pragma unroll
    for (int n = 0; n < kN; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qi = n * 8 + 2 * t4 + e, qrow = q0 + qi;
        const float l = ls[qi], dl = dls[qi];
        float lo = sp[0][n][e] * scale, hi = sp[0][n][2 + e] * scale;
        if (diag) {
          if (kr_lo > qrow) lo = kNeg;
          if (kr_hi > qrow) hi = kNeg;
        }
        const float p_lo = qrow < Tq ? expf(lo - l) : 0.f;
        const float p_hi = qrow < Tq ? expf(hi - l) : 0.f;
        sp[0][n][e] = p_lo;
        sp[0][n][2 + e] = p_hi;
        sp[1][n][e] = p_lo * (sp[1][n][e] - dl) * scale;
        sp[1][n][2 + e] = p_hi * (sp[1][n][2 + e] - dl) * scale;
      }
    }

    // dV += P^T dO, dK += dS^T Q on the warp's columns
#pragma unroll
    for (int jj = 0; jj < kN; ++jj) {
      uint32_t pb[4], ps[4], sb[4], ss[4];
      split4(sp[0][jj][0], sp[0][jj][2], sp[0][jj][1], sp[0][jj][3], pb, ps);
      split4(sp[1][jj][0], sp[1][jj][2], sp[1][jj][1], sp[1][jj][3], sb, ss);
      const float* dr = dos + (jj * 8 + 2 * t4) * kP + c0 + g;
      const float* qr = qs + (jj * 8 + 2 * t4) * kP + c0 + g;
#pragma unroll
      for (int n = 0; n < kW8; ++n) {
        mma3(dva[n], pb, ps, dr[n * 8], dr[kP + n * 8]);
        mma3(dka[n], sb, ss, qr[n * 8], qr[kP + n * 8]);
      }
    }
  }
  cp_async_wait<0>();

  if (kr_lo < Tk) {
    const size_t off = (bh * Tk + kr_lo) * DH + c0 + 2 * t4;
#pragma unroll
    for (int n = 0; n < kW8; ++n) {
      dkout.st2(off + n * 8, dka[n][0], dka[n][1]);
      dvout.st2(off + n * 8, dva[n][0], dva[n][1]);
    }
  }
  if (kr_hi < Tk) {
    const size_t off = (bh * Tk + kr_hi) * DH + c0 + 2 * t4;
#pragma unroll
    for (int n = 0; n < kW8; ++n) {
      dkout.st2(off + n * 8, dka[n][2], dka[n][3]);
      dvout.st2(off + n * 8, dva[n][2], dva[n][3]);
    }
  }
}

template <int DH, bool kInt8, bool kLow>
int launch(const void* q, const void* k, const void* v, const float* ks,
           const float* vs, void* o, float* lse, int B, int H, int Hkv,
           int Tq, int Tk, float scale, int causal, int dts, cudaStream_t st) {
  static std::atomic<unsigned> raised{0u};
  if constexpr (DH > 128) {
    return launch_smem(flash_fwd_wide_kernel<DH, kInt8, kLow>,
                       wide_fwd_smem_bytes<DH>(), raised,
                       dim3(B * H, (Tq + 15) / 16), kWideThreads, st, q, k,
                       v, ks, vs, o, lse, H, Hkv, Tq, Tk, scale, causal, dts);
  } else {
    constexpr int kBq = kFwdWarps * 16;
    return launch_smem(flash_fwd_kernel<DH, kInt8, kLow>,
                       fwd_smem_bytes<DH>(), raised,
                       dim3(B * H, (Tq + kBq - 1) / kBq), kFwdThreads, st, q,
                       k, v, ks, vs, o, lse, H, Hkv, Tq, Tk, scale, causal,
                       dts);
  }
}

template <bool kInt8, bool kLow>
int dispatch(const void* q, const void* k, const void* v, const float* ks,
             const float* vs, void* o, float* lse, int B, int H, int Hkv,
             int Tq, int Tk, int dh, float scale, int causal, int dts,
             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PT_FWD(W)                                                           \
  case W:                                                                   \
    return launch<W, kInt8, kLow>(q, k, v, ks, vs, o, lse, B, H, Hkv, Tq,   \
                                  Tk, scale, causal, dts, st)
  switch (dh) {
    PT_FWD(16);
    PT_FWD(32);
    PT_FWD(64);
    PT_FWD(128);
    PT_FWD(256);
    PT_FWD(384);
    PT_FWD(512);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PT_FWD
}

template <int DH, bool kLow>
int bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
            const float* lse, const float* delta, void* dk, void* dv, int BH,
            int Tq, int Tk, float scale, int causal, int dts,
            cudaStream_t st) {
  static std::atomic<unsigned> raised{0u};
  if constexpr (DH > 128) {
    return launch_smem(flash_bwd_dkv_wide_kernel<DH, kLow>,
                       wide_dkv_smem_bytes<DH>(), raised,
                       dim3(BH, (Tk + 15) / 16), kWideThreads, st, q, k, v,
                       dout, lse, delta, dk, dv, Tq, Tk, scale, causal, dts);
  } else {
    return launch_smem(flash_bwd_dkv_kernel<DH, kLow>, dkv_smem_bytes<DH>(),
                       raised, dim3(BH, (Tk + kKv - 1) / kKv), kBwdThreads,
                       st, q, k, v, dout, lse, delta, dk, dv, Tq, Tk, scale,
                       causal, dts);
  }
}

template <int DH, bool kLow>
int bwd_dq(const void* q, const void* k, const void* v, const void* dout,
           const void* o, const float* lse, float* delta, void* dq, int BH,
           int Tq, int Tk, float scale, int causal, int dts,
           cudaStream_t st) {
  static std::atomic<unsigned> raised{0u};
  if constexpr (DH > 128) {
    return launch_smem(flash_bwd_dq_wide_kernel<DH, kLow>,
                       wide_dq_smem_bytes<DH>(), raised,
                       dim3(BH, (Tq + 15) / 16), kWideThreads, st, q, k, v,
                       dout, o, lse, delta, dq, Tq, Tk, scale, causal, dts);
  } else {
    constexpr int kBq = kDqWarps * 16;
    return launch_smem(flash_bwd_dq_kernel<DH, kLow>, dq_smem_bytes<DH>(),
                       raised, dim3(BH, (Tq + kBq - 1) / kBq), kDqThreads,
                       st, q, k, v, dout, o, lse, delta, dq, Tq, Tk, scale,
                       causal, dts);
  }
}

template <bool kLow>
int dispatch_dkv(const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, const float* delta,
                 void* dk, void* dv, int BH, int Tq, int Tk, int dh,
                 float scale, int causal, int dts, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PT_DKV(W)                                                           \
  case W:                                                                   \
    return bwd_dkv<W, kLow>(q, k, v, dout, lse, delta, dk, dv, BH, Tq, Tk,  \
                            scale, causal, dts, st)
  switch (dh) {
    PT_DKV(16);
    PT_DKV(32);
    PT_DKV(64);
    PT_DKV(128);
    PT_DKV(256);
    PT_DKV(384);
    PT_DKV(512);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PT_DKV
}

template <bool kLow>
int dispatch_dq(const void* q, const void* k, const void* v,
                const void* dout, const void* o, const float* lse,
                float* delta, void* dq, int BH, int Tq, int Tk, int dh,
                float scale, int causal, int dts, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PT_DQ(W)                                                            \
  case W:                                                                   \
    return bwd_dq<W, kLow>(q, k, v, dout, o, lse, delta, dq, BH, Tq, Tk,    \
                           scale, causal, dts, st)
  switch (dh) {
    PT_DQ(16);
    PT_DQ(32);
    PT_DQ(64);
    PT_DQ(128);
    PT_DQ(256);
    PT_DQ(384);
    PT_DQ(512);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PT_DQ
}

template <int DH>
int smem_bytes(int which) {
  if constexpr (DH > 128)
    return static_cast<int>(which == 0   ? wide_fwd_smem_bytes<DH>()
                            : which == 1 ? wide_dkv_smem_bytes<DH>()
                                         : wide_dq_smem_bytes<DH>());
  return static_cast<int>(which == 0   ? fwd_smem_bytes<DH>()
                          : which == 1 ? dkv_smem_bytes<DH>()
                                       : dq_smem_bytes<DH>());
}

}  // namespace

// The entries build in parts, one nvcc each, linked into one library
// (ops/kernels/_build.py passes -DPT_PART=k; a build without it defines
// every entry): part 0 the float32 and int8 entries, 1 the bf16 (kLow) ones.
#ifndef PT_PART
#define PT_PART -1
#endif
#define PT_IN(k) (PT_PART < 0 || PT_PART == (k))

// Each entry returns cudaGetLastError() after the launch (0 = launched).
// The _f32 / _i8 entries are the float32 (and int8 K/V) instances; each
// _bf16 entry is its kernel's kLow instance, whose operands are float32
// or bf16 as the bits of dts (kQ: q with o, do and dq; kK: k with dk;
// kV: v with dv) say.

// q [BH, Tq, dh], k/v [BH, Tk, dh] -> o [BH, Tq, dh], lse [BH, Tq]
#if PT_IN(0)
extern "C" int flash_attention_fwd_f32(const float* q, const float* k,
                                       const float* v, float* o, float* lse,
                                       int BH, int Tq, int Tk, int dh,
                                       float scale, int causal,
                                       void* stream) {
  return dispatch<false, false>(q, k, v, nullptr, nullptr, o, lse, BH, 1, 1,
                                Tq, Tk, dh, scale, causal, 0, stream);
}
#endif
#if PT_IN(1)
extern "C" int flash_attention_fwd_bf16(const void* q, const void* k,
                                        const void* v, void* o, float* lse,
                                        int BH, int Tq, int Tk, int dh,
                                        int dts, float scale, int causal,
                                        void* stream) {
  return dispatch<false, true>(q, k, v, nullptr, nullptr, o, lse, BH, 1, 1,
                               Tq, Tk, dh, scale, causal, dts, stream);
}
#endif

// q [B, Tq, H * dh], k/v [B, Tk, Hkv * dh] int8, ks/vs [B, Tk, Hkv]
// -> o [B, H, Tq, dh]; the _bf16 entry's q and o bf16
#if PT_IN(0)
extern "C" int flash_attention_quant_i8(const float* q, const int8_t* k,
                                        const int8_t* v, const float* ks,
                                        const float* vs, float* o, int B,
                                        int H, int Hkv, int Tq, int Tk,
                                        int dh, float scale, int causal,
                                        void* stream) {
  return dispatch<true, false>(q, k, v, ks, vs, o, nullptr, B, H, Hkv, Tq,
                               Tk, dh, scale, causal, 0, stream);
}
#endif
#if PT_IN(1)
extern "C" int flash_attention_quant_i8_bf16(const void* q, const int8_t* k,
                                             const int8_t* v, const float* ks,
                                             const float* vs, void* o, int B,
                                             int H, int Hkv, int Tq, int Tk,
                                             int dh, float scale, int causal,
                                             void* stream) {
  return dispatch<true, true>(q, k, v, ks, vs, o, nullptr, B, H, Hkv, Tq,
                              Tk, dh, scale, causal, kQ, stream);
}
#endif

// q/do [BH, Tq, dh], k/v [BH, Tk, dh], lse/delta [BH, Tq] -> dk/dv
// [BH, Tk, dh]
#if PT_IN(0)
extern "C" int flash_attention_bwd_dkv_f32(const float* q, const float* k,
                                           const float* v, const float* dout,
                                           const float* lse,
                                           const float* delta, float* dk,
                                           float* dv, int BH, int Tq, int Tk,
                                           int dh, float scale, int causal,
                                           void* stream) {
  return dispatch_dkv<false>(q, k, v, dout, lse, delta, dk, dv, BH, Tq, Tk,
                             dh, scale, causal, 0, stream);
}
#endif
#if PT_IN(1)
extern "C" int flash_attention_bwd_dkv_bf16(const void* q, const void* k,
                                            const void* v, const void* dout,
                                            const float* lse,
                                            const float* delta, void* dk,
                                            void* dv, int BH, int Tq, int Tk,
                                            int dh, int dts, float scale,
                                            int causal, void* stream) {
  return dispatch_dkv<true>(q, k, v, dout, lse, delta, dk, dv, BH, Tq, Tk,
                            dh, scale, causal, dts, stream);
}
#endif

// q/do/o [BH, Tq, dh], k/v [BH, Tk, dh], lse [BH, Tq] -> dq [BH, Tq, dh]
// and delta = rowsum(do o) [BH, Tq], which the dK/dV launch then reads
#if PT_IN(0)
extern "C" int flash_attention_bwd_dq_f32(const float* q, const float* k,
                                          const float* v, const float* dout,
                                          const float* o, const float* lse,
                                          float* delta, float* dq, int BH,
                                          int Tq, int Tk, int dh,
                                          float scale, int causal,
                                          void* stream) {
  return dispatch_dq<false>(q, k, v, dout, o, lse, delta, dq, BH, Tq, Tk, dh,
                            scale, causal, 0, stream);
}
#endif
#if PT_IN(1)
extern "C" int flash_attention_bwd_dq_bf16(const void* q, const void* k,
                                           const void* v, const void* dout,
                                           const void* o, const float* lse,
                                           float* delta, void* dq, int BH,
                                           int Tq, int Tk, int dh, int dts,
                                           float scale, int causal,
                                           void* stream) {
  return dispatch_dq<true>(q, k, v, dout, o, lse, delta, dq, BH, Tq, Tk, dh,
                           scale, causal, dts, stream);
}
#endif

// Dynamic shared memory of one launch, in bytes: which 0 = the forward
// (every instance), 1 = dK/dV, 2 = dQ; -1 for a head dim not taken.
#if PT_IN(0)
extern "C" int flash_attention_smem_bytes(int which, int dh) {
  switch (dh) {
    case 16: return smem_bytes<16>(which);
    case 32: return smem_bytes<32>(which);
    case 64: return smem_bytes<64>(which);
    case 128: return smem_bytes<128>(which);
    case 256: return smem_bytes<256>(which);
    case 384: return smem_bytes<384>(which);
    case 512: return smem_bytes<512>(which);
    default: return -1;
  }
}
#endif
