// Decode attention for Hopper (sm_90a): the four decode-attention kernels
// of the serving steps, one template, each over a float32 or an int8 KV
// cache.
//
// Replaces: paddle_tpu/ops/pallas/decode_attention.py ::
//   decode_attention_slab_chunk   (pallas_call at :605; _chunk_kernel :315)
//   decode_attention_slab         (:454; _slab_kernel :274)
//   decode_attention_paged_chunk  (:675; _paged_chunk_kernel :376, index
//                                  map _kv_map :649)
//   decode_attention_paged        (:530; _paged_kernel :307)
// all built on _accumulate :187 (the masked online softmax), with the
// int8 operands kscale/vscale of each (_check_scales :383; widened in
// _accumulate at :212-213 and :230-231).
//
// Computes: q [S, K, D] (K query lanes per row; K = 1 for the Tq=1
//   kernels, whose q is [S, D]), qpos [S, K] int32 -> out [S, K, D].  Lane
//   i of row r attends the row's logical K/V columns <= qpos[r, i] with a
//   masked online softmax (masked scores sit at -1e30, whose exp is
//   exactly 0), finalized as acc / max(l, 1e-30).  GQA: query head h
//   reads KV head h / (H / Hkv).  Decode-row fast path: when
//   qpos[r, K-1] == qpos[r, 0] the row has one live lane; only lane 0 is
//   computed and lanes 1..K-1 are written as exact zeros (for K = 1 this
//   is just the one lane).
//   K/V source: slab — k/v [S, T, Dkv], row r's column t at row r, t;
//   paged — the shared pool k/v [NB, bs, Dkv] and tables [S, nb_row]
//   int32, row r's column t at pool block tables[r, t / bs], offset
//   t % bs.  Several rows may read one pool block (a shared prefix): the
//   kernel only reads.
//   Int8 cache (kInt8): k/v hold int8 codes and kscale/vscale the f32
//   scale of each (position, KV head), laid out as k/v with Hkv in place
//   of Dkv ([S, T, Hkv] or [NB, bs, Hkv]).  Each code is widened as
//   float(code) * scale before it is stored to shared memory — exactly
//   quant/kv.dequantize_heads' product — and everything after the store
//   is the float32 kernel's, so the int8 kernel equals the float32
//   kernel run on the dequantized cache bit for bit.
//
// Bound on this card: bytes.  Each (row, KV head) stripe of K and V is
//   read from device memory once, up to the row's furthest lane; the
//   work per byte is a few FLOPs, far below the H100's ~20 FLOP/byte
//   float32 ridge.  The int8 cache reads 1/4 + 1/dh of those bytes.
//
// Design: one CTA per (row r, KV head g, group of 8 query vectors), 8
//   warps, one query vector (lane i, head h) per warp.  Hopper runs CTAs
//   in no order, so the TPU kernel's sequential (S, T/blk) grid with
//   scratch carried across steps becomes a loop inside the CTA over
//   32-column K/V tiles of the head's dh-column stripe, from column 0 to
//   the CTA's furthest live lane (the clamp, as the TPU index maps clamp
//   at qpos[r, K-1]).  Before each tile the first warp turns the tile's
//   32 logical columns into row offsets in shared memory: the column
//   itself on the slab, tables[r, t / bs] * bs + t % bs on the pool (one
//   table word per column, the 16 columns of a bs = 16 block reading the
//   same word); on an int8 cache it also reads each column's two scales
//   at that row offset (the scale pool rides the same table walk).
//   Columns past the clamp get no offset and load as zeros (code 0,
//   scale 0), so no table entry past the row's furthest block is ever
//   read and a free row (position 0, table all scratch) reads block 0
//   only.  Tiles are loaded with coalesced 16-byte loads (4 floats, or
//   16 int8 codes) into shared memory (row stride dh + 1, so the per-lane
//   score reads are bank-conflict free) and shared by all warps.  Within
//   a tile, lane c of a warp scores column t0 + c; the running max / sum
//   live in registers, the accumulator is spread over the lanes (dh / 32
//   values each).  Every query vector of the row's group shares the K/V
//   tile, so GQA costs no widened K/V.  A tile past a warp's own position
//   is skipped: on the TPU that visit is a bit-exact no-op (every score
//   masked, alpha = 1).  A bs = 16 pool row walks up to 16 small blocks,
//   two to a tile; the tile is not resized to the block.
//   Head dims: the template's DH is a compiled width (16, 32, 64, 128,
//   256, 384, 512) and dh the head's own, any up to 128 or a multiple of
//   128 up to 512 (the TPU kernel's lane-tileable widths).  A head
//   narrower than its width runs the kPad instance, padded inside the
//   kernel: the shared tiles' and the query's lanes past dh are zeros,
//   so they add exactly 0 to every score and are never written out.  A
//   head of a compiled width runs the instance with dh = DH folded in.
//   Up to DH 128 the tiles are static shared memory, past it dynamic.  K/V load 16 bytes at a
//   time where dh allows it (4 floats, or 16 int8 codes), else one value
//   at a time (dh not a multiple of 4, or of 16 for int8 codes).
//   Later work (ROADMAP): split-KV for the small main-path grid, TMA
//   loads, a tensor-core product, fewer warps for the Tq=1 grids.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kWarps = 8;
constexpr int kTile = 32;
constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

constexpr size_t smem_bytes(int DH) {
  return sizeof(float) * (2 * kTile * (DH + 1) + kWarps * DH);
}

// the tiles of width DH fit the 48 KB of static shared memory
template <int DH>
constexpr bool kStatic = smem_bytes(DH) <= 48 * 1024;

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

// kPaged: K/V from the pool through the row's block table (span =
// nb_row * bs logical columns); else from the row's slab stripe (span =
// T, bs and tables unused).  kInt8: k/v are int8 codes with per-(row,
// KV head) scales kscale/vscale; else float32 and the scales unused.
// kPad: the head's dh_in < DH; else dh_in == DH.
template <int DH, bool kPaged, bool kInt8, bool kPad>
__global__ void __launch_bounds__(kWarps * 32)
attn_kernel(const float* __restrict__ q, const void* __restrict__ k,
            const void* __restrict__ v, const float* __restrict__ kscale,
            const float* __restrict__ vscale, const int* __restrict__ qpos,
            const int* __restrict__ tables, float* __restrict__ out, int K,
            int span, int bs, int nb_row, int H, int Hkv, int dh_in,
            float scale) {
  constexpr int kPerLane = (DH + 31) / 32;   // accumulator values per lane
  constexpr int kLd = DH + 1;                // padded shared row stride
  constexpr int kLoad = kInt8 ? 16 : 4;      // values a 16-byte load
  constexpr int kFloats = 2 * kTile * kLd + kWarps * DH;
  // ks, vs [kTile][kLd] and qs [kWarps][DH]: static shared memory up to
  // the 48 KB default, else dynamic (smem_bytes(DH))
  __shared__ float s_tiles[kStatic<DH> ? kFloats : 1];
  extern __shared__ float dsm[];
  float* ks = kStatic<DH> ? s_tiles : dsm;
  float* vs = ks + kTile * kLd;
  float* qs = vs + kTile * kLd;
  __shared__ long long s_row[kTile];         // source row of each column
  __shared__ float s_ksc[kTile];             // its scales (int8 cache)
  __shared__ float s_vsc[kTile];
  __shared__ int s_hi;

  const int r = blockIdx.x;
  const int g = blockIdx.y;
  const int group = H / Hkv;
  const int nq = K * group;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.z * kWarps + warp;   // query vector of this warp
  const int dh = kPad ? dh_in : DH;
  const int D = H * dh;
  const int Dkv = Hkv * dh;
  const bool vec = dh % kLoad == 0;          // 16-byte loads
  const int* pos_row = qpos + (size_t)r * K;
  const bool decode_row = pos_row[K - 1] == pos_row[0];
  const int i = j / group;                    // query lane
  const int h = g * group + j % group;        // query head
  const bool live = j < nq && (!decode_row || i == 0);
  const int pos = live ? pos_row[i] : -1;

  if (threadIdx.x == 0) s_hi = -1;
  // a padded head's lanes past dh stay 0: tiles only ever write columns
  // < dh (at dh == DH every column read is written)
  if constexpr (kPad)
    for (int e = threadIdx.x; e < 2 * kTile * kLd; e += kWarps * 32) ks[e] = 0.f;
  __syncthreads();
  if (live && lane == 0) atomicMax(&s_hi, pos);
  if (live) {
    const float* qrow = q + ((size_t)r * K + i) * D + (size_t)h * dh;
    for (int d = lane; d < DH; d += 32) qs[warp * DH + d] = d < dh ? qrow[d] : 0.f;
  }
  __syncthreads();
  const int hi = min(s_hi, span - 1);         // the clamp

  const int* tbl = kPaged ? tables + (size_t)r * nb_row : nullptr;
  const size_t slab_row0 = kPaged ? 0 : (size_t)r * span;
  float m = kNeg, l = 0.f;
  float acc[kPerLane];
#pragma unroll
  for (int u = 0; u < kPerLane; ++u) acc[u] = 0.f;

  for (int t0 = 0; t0 <= hi; t0 += kTile) {
    if (threadIdx.x < kTile) {
      const int t = t0 + threadIdx.x;
      long long src = -1;
      if (t <= hi) {
        src = kPaged ? (long long)tbl[t / bs] * bs + t % bs
                     : (long long)(slab_row0 + t);
      }
      s_row[threadIdx.x] = src;
      if constexpr (kInt8) {
        s_ksc[threadIdx.x] = src >= 0 ? kscale[src * Hkv + g] : 0.f;
        s_vsc[threadIdx.x] = src >= 0 ? vscale[src * Hkv + g] : 0.f;
      }
    }
    __syncthreads();
    if (vec) {
      // 16-byte loads, kVec a compiled row; those past dh are skipped
      constexpr int kVec = DH / kLoad;
      for (int e = threadIdx.x; e < kTile * kVec; e += kWarps * 32) {
        const int row = e / kVec;
        const int c = (e % kVec) * kLoad;
        if (c >= dh) continue;
        const long long src = s_row[row];
        float* kd = ks + row * kLd;
        float* vd = vs + row * kLd;
        if constexpr (kInt8) {
          // 16 codes per load at byte offset src * Dkv + g * dh + c, a
          // multiple of 16 (dh is)
          int4 kc = make_int4(0, 0, 0, 0), vc = kc;
          if (src >= 0) {
            const size_t off = (size_t)src * Dkv + (size_t)g * dh + c;
            kc = *reinterpret_cast<const int4*>(
                static_cast<const int8_t*>(k) + off);
            vc = *reinterpret_cast<const int4*>(
                static_cast<const int8_t*>(v) + off);
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
          float4 kv4 = make_float4(0.f, 0.f, 0.f, 0.f), vv4 = kv4;
          if (src >= 0) {
            const size_t off = (size_t)src * Dkv + (size_t)g * dh + c;
            kv4 = *reinterpret_cast<const float4*>(
                static_cast<const float*>(k) + off);
            vv4 = *reinterpret_cast<const float4*>(
                static_cast<const float*>(v) + off);
          }
          kd[c] = kv4.x; kd[c + 1] = kv4.y; kd[c + 2] = kv4.z;
          kd[c + 3] = kv4.w;
          vd[c] = vv4.x; vd[c + 1] = vv4.y; vd[c + 2] = vv4.z;
          vd[c + 3] = vv4.w;
        }
      }
    } else {
      // one value a load (dh is not a multiple of kLoad, so dh < DH)
      for (int e = threadIdx.x; e < kTile * DH; e += kWarps * 32) {
        const int row = e / DH;
        const int c = e % DH;
        if (c >= dh) continue;
        const long long src = s_row[row];
        float kx = 0.f, vx = 0.f;
        if (src >= 0) {
          const size_t off = (size_t)src * Dkv + (size_t)g * dh + c;
          if constexpr (kInt8) {
            kx = __fmul_rn(static_cast<float>(static_cast<const int8_t*>(k)[off]), s_ksc[row]);
            vx = __fmul_rn(static_cast<float>(static_cast<const int8_t*>(v)[off]), s_vsc[row]);
          } else {
            kx = static_cast<const float*>(k)[off];
            vx = static_cast<const float*>(v)[off];
          }
        }
        ks[row * kLd + c] = kx;
        vs[row * kLd + c] = vx;
      }
    }
    __syncthreads();
    if (live && t0 <= pos) {
      const float* kr = ks + lane * kLd;
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < DH; ++d) s = fmaf(qs[warp * DH + d], kr[d], s);
      s *= scale;
      if (t0 + lane > pos) s = kNeg;
      const float m_new = fmaxf(m, warp_max(s));
      const float p = expf(s - m_new);
      const float alpha = expf(m - m_new);
      l = l * alpha + warp_sum(p);
      m = m_new;
#pragma unroll
      for (int u = 0; u < kPerLane; ++u) acc[u] *= alpha;
#pragma unroll 8
      for (int c = 0; c < kTile; ++c) {
        const float pc = __shfl_sync(kFull, p, c);
#pragma unroll
        for (int u = 0; u < kPerLane; ++u) {
          const int d = lane + 32 * u;
          if (d < DH) acc[u] = fmaf(pc, vs[c * kLd + d], acc[u]);
        }
      }
    }
    __syncthreads();
  }

  if (j < nq) {
    float* o = out + ((size_t)r * K + i) * D + (size_t)h * dh;
    const float den = fmaxf(l, 1e-30f);
#pragma unroll
    for (int u = 0; u < kPerLane; ++u) {
      const int d = lane + 32 * u;
      if (d < dh) o[d] = live ? acc[u] / den : 0.f;
    }
  }
}


// Launch one instance.  Past static shared memory (DH >= 256) its tiles
// are dynamic and the instance's limit is raised first, once per
// device: `raised` holds a bit for each device already set, as
// cudaFuncSetAttribute costs microseconds of host time a launch.
template <int DH, bool kPaged, bool kInt8, bool kPad>
cudaError_t start(dim3 grid, cudaStream_t st, const float* q, const void* k,
                  const void* v, const float* kscale, const float* vscale,
                  const int* qpos, const int* tables, float* out, int K,
                  int span, int bs, int nb_row, int H, int Hkv, int dh,
                  float scale) {
  constexpr size_t smem = kStatic<DH> ? 0 : smem_bytes(DH);
  if constexpr (smem > 48 * 1024) {
    static std::atomic<unsigned> raised{0u};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    const unsigned bit = dev < 32 ? 1u << dev : 0u;
    if (bit == 0u || !(raised.load() & bit)) {
      e = cudaFuncSetAttribute(attn_kernel<DH, kPaged, kInt8, kPad>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
      if (e != cudaSuccess) return e;
      raised.fetch_or(bit);
    }
  }
  attn_kernel<DH, kPaged, kInt8, kPad><<<grid, kWarps * 32, smem, st>>>(
      q, k, v, kscale, vscale, qpos, tables, out, K, span, bs, nb_row, H,
      Hkv, dh, scale);
  return cudaSuccess;
}

template <bool kPaged, bool kInt8>
int launch(const float* q, const void* k, const void* v,
           const float* kscale, const float* vscale, const int* qpos,
           const int* tables, float* out, int S, int K, int span, int bs,
           int nb_row, int H, int Hkv, int dh, float scale, void* stream) {
  const int nq = K * (H / Hkv);
  const dim3 grid(S, Hkv, (nq + kWarps - 1) / kWarps);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the compiled width: the next of 16/32/64/128 up to 128, else dh
  // itself (a multiple of 128 up to 512)
  const int width = dh <= 16 ? 16 : dh <= 32 ? 32 : dh <= 64 ? 64 : dh <= 128 ? 128 : dh;
  cudaError_t e;
#define PT_START(W, P)                                                       \
  e = start<W, kPaged, kInt8, P>(grid, st, q, k, v, kscale, vscale, qpos,  \
                                 tables, out, K, span, bs, nb_row, H, Hkv,  \
                                 dh, scale)
#define PT_WIDTH(W)           \
  if (dh == W)                \
    PT_START(W, false);       \
  else                        \
    PT_START(W, true)
  switch (dh < 1 ? 0 : width) {
    case 16: PT_WIDTH(16); break;
    case 32: PT_WIDTH(32); break;
    case 64: PT_WIDTH(64); break;
    case 128: PT_WIDTH(128); break;
    case 256: PT_START(256, false); break;
    case 384: PT_START(384, false); break;
    case 512: PT_START(512, false); break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PT_WIDTH
#undef PT_START
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each entry returns cudaGetLastError() after the launch (0 = launched).
// The _i8 entries take int8 k/v and their f32 scales ks/vs, shaped as
// k/v with Hkv in place of Dkv.

// q [S, K, D], k/v [S, T, Dkv], qpos [S, K] -> out [S, K, D]
extern "C" int decode_attention_slab_chunk_f32(
    const float* q, const float* k, const float* v, const int* qpos,
    float* out, int S, int K, int T, int H, int Hkv, int dh, float scale,
    void* stream) {
  return launch<false, false>(q, k, v, nullptr, nullptr, qpos, nullptr, out,
                              S, K, T, 1, 1, H, Hkv, dh, scale, stream);
}

extern "C" int decode_attention_slab_chunk_i8(
    const float* q, const int8_t* k, const int8_t* v, const float* ks,
    const float* vs, const int* qpos, float* out, int S, int K, int T, int H,
    int Hkv, int dh, float scale, void* stream) {
  return launch<false, true>(q, k, v, ks, vs, qpos, nullptr, out, S, K, T, 1,
                             1, H, Hkv, dh, scale, stream);
}

// q [S, D], k/v [S, T, Dkv], positions [S] -> out [S, D]
extern "C" int decode_attention_slab_f32(
    const float* q, const float* k, const float* v, const int* positions,
    float* out, int S, int T, int H, int Hkv, int dh, float scale,
    void* stream) {
  return launch<false, false>(q, k, v, nullptr, nullptr, positions, nullptr,
                              out, S, 1, T, 1, 1, H, Hkv, dh, scale, stream);
}

extern "C" int decode_attention_slab_i8(
    const float* q, const int8_t* k, const int8_t* v, const float* ks,
    const float* vs, const int* positions, float* out, int S, int T, int H,
    int Hkv, int dh, float scale, void* stream) {
  return launch<false, true>(q, k, v, ks, vs, positions, nullptr, out, S, 1,
                             T, 1, 1, H, Hkv, dh, scale, stream);
}

// q [S, K, D], pool k/v [NB, bs, Dkv], qpos [S, K], tables [S, nb_row]
// -> out [S, K, D]
extern "C" int decode_attention_paged_chunk_f32(
    const float* q, const float* k, const float* v, const int* qpos,
    const int* tables, float* out, int S, int K, int bs, int nb_row, int H,
    int Hkv, int dh, float scale, void* stream) {
  return launch<true, false>(q, k, v, nullptr, nullptr, qpos, tables, out, S,
                             K, nb_row * bs, bs, nb_row, H, Hkv, dh, scale,
                             stream);
}

extern "C" int decode_attention_paged_chunk_i8(
    const float* q, const int8_t* k, const int8_t* v, const float* ks,
    const float* vs, const int* qpos, const int* tables, float* out, int S,
    int K, int bs, int nb_row, int H, int Hkv, int dh, float scale,
    void* stream) {
  return launch<true, true>(q, k, v, ks, vs, qpos, tables, out, S, K,
                            nb_row * bs, bs, nb_row, H, Hkv, dh, scale,
                            stream);
}

// q [S, D], pool k/v [NB, bs, Dkv], positions [S], tables [S, nb_row]
// -> out [S, D]
extern "C" int decode_attention_paged_f32(
    const float* q, const float* k, const float* v, const int* positions,
    const int* tables, float* out, int S, int bs, int nb_row, int H,
    int Hkv, int dh, float scale, void* stream) {
  return launch<true, false>(q, k, v, nullptr, nullptr, positions, tables,
                             out, S, 1, nb_row * bs, bs, nb_row, H, Hkv, dh,
                             scale, stream);
}

extern "C" int decode_attention_paged_i8(
    const float* q, const int8_t* k, const int8_t* v, const float* ks,
    const float* vs, const int* positions, const int* tables, float* out,
    int S, int bs, int nb_row, int H, int Hkv, int dh, float scale,
    void* stream) {
  return launch<true, true>(q, k, v, ks, vs, positions, tables, out, S, 1,
                            nb_row * bs, bs, nb_row, H, Hkv, dh, scale,
                            stream);
}
