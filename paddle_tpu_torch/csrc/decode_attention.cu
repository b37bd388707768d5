// Decode attention for Hopper (sm_90a): the four decode-attention kernels
// of the serving steps, each over a float32 or an int8 KV cache: the two
// chunked ones (K lanes a row) on the split-KV template split_kernel, the
// two Tq=1 ones on attn_kernel.
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
//   float(code) * scale — exactly quant/kv.dequantize_heads' product —
//   and everything after is the float32 kernel's, so the int8 kernel
//   equals the float32 kernel run on the dequantized cache bit for bit.
//   Row independence: a row's output depends on its own q, positions,
//   table and K/V alone, never on S, T, the pool or the other rows.
//
// Bound on this card: bytes.  Each (row, KV head) stripe of K and V is
//   read from device memory once, up to the row's furthest lane; the
//   work per byte is a few FLOPs, far below the H100's ~20 FLOP/byte
//   float32 ridge.  The int8 cache reads 1/4 + 1/dh of those bytes.
//
// Chunked kernels (split_kernel), split-KV: one CTA per (split, KV head
//   g, row r x group of kVecs = 4 query vectors).  A (row, KV head)'s
//   columns [0, hi] (hi: the group's furthest live lane, the clamp) are
//   cut into splits of split_cols(DH) columns (128 up to DH 128),
//   boundaries by column index alone; a CTA whose split starts past hi
//   exits at once, so a row takes as many CTAs as its span needs.  A
//   CTA reads its row's positions (one round trip), then (paged) the
//   split's table words (none past hi), then issues its loads at once
//   through cp.async: q of its live vectors, the split's K tile and
//   (int8) the columns' scales in one group, the V tile in a second, so
//   V is in flight while the scores and the softmax run.  Tiles hold
//   float32 rows at pitch DH + 4 floats, int8 codes at DH + 4 bytes
//   (widened at use), so lanes reading one chunk of consecutive rows hit
//   distinct banks.  The work goes by item, not by warp, so a decode row
//   (one live vector) uses all 256 threads: the scores by (column,
//   part), the dot cut into P parts of interleaved 4-dim chunks, each
//   item scoring every live vector on the K chunk it read with four
//   independent sums a vector, P the most that fills the CTA; the
//   softmax one warp a vector; P.V by (vector, 4-dim chunk, column
//   group), G groups of interleaved columns merged in group order.
//   Where the span needs more than one split, each CTA writes its
//   (m, l, acc) per live vector to the caller's scratch and, after a
//   barrier, its thread 0 fences and takes a ticket (an atomic add on
//   the (row, group, KV head)'s counter); the last to arrive resets the
//   counter to 0 and merges the records in split order, an online
//   softmax over them, into the output: one launch a call, the result a
//   function of the row's splits alone.  One split: the CTA writes the
//   output itself.  probe_decode.py times the choices (the split
//   length, kVecs, cp.async, the items) and where the time goes.
//   Later work (ROADMAP): TMA loads, a tile per paged block, a merge
//   through a cluster's shared memory.
//
// Tq=1 kernels (attn_kernel): one CTA per (row r, KV head g, group of 8
//   query vectors), 8 warps, one query vector (lane i, head h) per warp.  Hopper runs CTAs
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
//   Later work (ROADMAP): the chunked kernels' split-KV design with fewer
//   warps for the Tq=1 grids, TMA loads, a tensor-core product.

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

// The compiled width of a head dh wide: the next of 16/32/64/128 up to
// 128, else dh itself where it is 256, 384 or 512; 0 for any other dh.
inline int compiled_width(int dh) {
  if (dh < 1) return 0;
  if (dh <= 128) return dh <= 16 ? 16 : dh <= 32 ? 32 : dh <= 64 ? 64 : 128;
  return dh == 256 || dh == 384 || dh == 512 ? dh : 0;
}

template <bool kPaged, bool kInt8>
int launch(const float* q, const void* k, const void* v,
           const float* kscale, const float* vscale, const int* qpos,
           const int* tables, float* out, int S, int K, int span, int bs,
           int nb_row, int H, int Hkv, int dh, float scale, void* stream) {
  const int nq = K * (H / Hkv);
  const dim3 grid(S, Hkv, (nq + kWarps - 1) / kWarps);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int width = compiled_width(dh);
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
  switch (width) {
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

// ------------------------------------------------- the chunked kernels

// Columns a split: a compile-time constant of the compiled width, so
// that a row's split boundaries depend on the column index alone.
constexpr int split_cols(int width) {
  return width <= 128 ? 128 : width == 256 ? 32 : 16;
}
template <int DH>
constexpr int kSplit = split_cols(DH);
constexpr int kVecs = 4;          // query vectors a CTA
constexpr int kThreads = 256;
static_assert(kVecs <= kThreads / 32, "the softmax takes a warp a vector");

// Bytes of one K or V tile row in shared memory, padded so that lanes
// reading one chunk of consecutive rows hit distinct banks: float32 rows
// by 16 bytes (an odd count of 16-byte groups a row, for float4 reads),
// int8 rows by 4 (an odd count of words, for char4 reads).
template <int DH, bool kInt8>
constexpr int kRowBytes = kInt8 ? DH + 4 : 4 * (DH + 4);

// Floats a record of the scratch: m, l, 2 floats of padding, acc [DH].
template <int DH>
constexpr int kRec = DH + 4;

template <int DH, bool kInt8>
constexpr size_t split_smem_bytes() {
  constexpr int L = kSplit<DH>;
  return 2 * L * kRowBytes<DH, kInt8>          // K, V tiles
         + sizeof(float) * (kVecs * DH          // q of the live vectors
                            + kVecs * (L > kThreads ? L : kThreads)
                            + kVecs * L         // probabilities
                            + 4 * kThreads      // P.V partial sums
                            + kVecs * DH        // the split's acc
                            + 2 * L             // int8 column scales
                            + 2 * kVecs)        // m, l
         + sizeof(int) * (L + 3 * kVecs + 2);
}

// 16 (or 4) bytes global -> shared, in flight until the group's wait
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The 4 values of a tile row's 4-dim chunk ch: float32 as stored, int8
// codes widened as float(code) * scale, quant/kv.dequantize_heads'
// product
template <bool kInt8>
__device__ __forceinline__ float4 load4(const unsigned char* row, int ch,
                                        float sc) {
  if constexpr (kInt8) {
    const char4 w = *reinterpret_cast<const char4*>(row + 4 * ch);
    return make_float4(__fmul_rn(static_cast<float>(w.x), sc),
                       __fmul_rn(static_cast<float>(w.y), sc),
                       __fmul_rn(static_cast<float>(w.z), sc),
                       __fmul_rn(static_cast<float>(w.w), sc));
  } else {
    return *reinterpret_cast<const float4*>(row + 16 * ch);
  }
}

// One split's columns of one (row, KV head, group of kVecs query
// vectors): the split's K, V (and scales) into shared memory, its
// (m, l, acc) per live vector; the last CTA of the (row, KV head,
// group) to finish merges the splits' records in split order and
// writes the output.  kPaged, kInt8, kPad as attn_kernel's.
template <int DH, bool kPaged, bool kInt8, bool kPad>
__global__ void __launch_bounds__(kThreads)
split_kernel(const float* __restrict__ q, const void* __restrict__ k,
             const void* __restrict__ v, const float* __restrict__ kscale,
             const float* __restrict__ vscale, const int* __restrict__ qpos,
             const int* __restrict__ tables, float* __restrict__ out,
             float* __restrict__ part, int* __restrict__ tickets, int K,
             int span, int bs, int nb_row, int H, int Hkv, int dh_in,
             float scale) {
  constexpr int L = kSplit<DH>;
  constexpr int kRow = kRowBytes<DH, kInt8>;
  constexpr int kVal = kInt8 ? 1 : 4;          // bytes a K/V value
  constexpr int kC4 = DH / 4;                  // 4-dim chunks a row
  constexpr int kSpart = kVecs * (L > kThreads ? L : kThreads);
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* kt = smem;                    // [L][kRow]
  unsigned char* vt = kt + L * kRow;           // [L][kRow]
  float* qs = reinterpret_cast<float*>(vt + L * kRow);   // [kVecs][DH]
  float* spart = qs + kVecs * DH;              // [P][nv][nin] dot parts
  float* pm = spart + kSpart;                  // [nv][L] probabilities
  float4* opart = reinterpret_cast<float4*>(pm + kVecs * L);  // [G][nc]
  float* ores = reinterpret_cast<float*>(opart + kThreads);   // [nv][DH]
  float* ksc = ores + kVecs * DH;              // [L] int8 scales
  float* vsc = ksc + L;
  float* sm = vsc + L;                         // [nv] max
  float* sl = sm + kVecs;                      // [nv] sum
  int* srow = reinterpret_cast<int*>(sl + kVecs);   // [L] source rows
  int* s_pos = srow + L;                       // [kVecs] by slot
  int* s_slot = s_pos + kVecs;                 // [nv] live slots
  int* s_vof = s_slot + kVecs;                 // [kVecs] slot -> live index
  int* s_misc = s_vof + kVecs;                 // nv, last

  const int tid = threadIdx.x;
  const int split = blockIdx.x;
  const int g = blockIdx.y;
  const int group = H / Hkv;
  const int nq = K * group;
  const int Z = (nq + kVecs - 1) / kVecs;
  const int r = blockIdx.z / Z;
  const int z = blockIdx.z % Z;
  const int dh = kPad ? dh_in : DH;
  const int D = H * dh;
  const int Dkv = Hkv * dh;
  const int* pos_row = qpos + (size_t)r * K;

  // the group's vectors (slot u: query vector z * kVecs + u), each
  // live one's position, and the clamp at the furthest (the positions
  // read in one round trip)
  int pos_u[kVecs];
#pragma unroll
  for (int u = 0; u < kVecs; ++u) {
    const int j = z * kVecs + u;
    pos_u[u] = j < nq ? pos_row[j / group] : -1;
  }
  const bool decode_row = pos_row[K - 1] == pos_row[0];
  int hi = -1;
#pragma unroll
  for (int u = 0; u < kVecs; ++u) {
    if (decode_row && (z * kVecs + u) / group > 0) pos_u[u] = -1;
    hi = max(hi, pos_u[u]);
  }
  hi = min(hi, span - 1);
  const int nsplit = hi < 0 ? 1 : hi / L + 1;  // splits holding columns
  if (split >= nsplit) return;
  const int s0 = split * L;
  const int nin = hi < 0 ? 0 : min(L, hi - s0 + 1);   // columns loaded
  if (tid == 0) {
    int nv = 0;
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
      s_pos[u] = pos_u[u];
      s_vof[u] = -1;
      if (pos_u[u] >= s0) {
        s_vof[u] = nv;
        s_slot[nv++] = u;
      }
    }
    s_misc[0] = nv;
  }
  // source rows of the split's columns (the clamp: none past hi)
  if (tid < nin) {
    const int t = s0 + tid;
    srow[tid] = kPaged ? tables[(size_t)r * nb_row + t / bs] * bs + t % bs
                       : r * span + t;
  }
  // a padded head's dims past dh stay 0 in q and the K/V tiles
  if constexpr (kPad) {
    for (int e = tid; e < kVecs * DH; e += kThreads)
      if (e % DH >= dh) qs[e] = 0.f;
    for (int e = tid; e < 2 * L * kRow / 4; e += kThreads)
      if ((4 * e) % kRow + 4 > dh * kVal)
        reinterpret_cast<int*>(kt)[e] = 0;
  }
  __syncthreads();
  const int nv = s_misc[0];

  // group 0: q, the K tile and the scales; group 1: the V tile
  // float32: 16-byte copies where dh % 4 == 0, else one value a copy;
  // int8 codes: 4-byte copies where dh % 4 == 0, else one a load
  const bool vec = !kInt8 && dh % 4 == 0;
  const bool quad = dh * kVal % 4 == 0;
  {
    const int n4 = dh / 4;
    for (int e = tid; e < nv * (dh % 4 == 0 ? n4 : dh); e += kThreads) {
      const int w = dh % 4 == 0 ? n4 : dh;
      const int vv = e / w;
      const int u = s_slot[vv];
      const int jq = z * kVecs + u;
      const int i = jq / group;
      const int h = g * group + jq % group;
      const float* qrow = q + ((size_t)r * K + i) * D + (size_t)h * dh;
      if (dh % 4 == 0)
        cp_async16(qs + vv * DH + 4 * (e % w), qrow + 4 * (e % w));
      else
        cp_async4(qs + vv * DH + e % w, qrow + e % w);
    }
  }
  auto copy_tile = [&](unsigned char* dst, const void* src) {
    const unsigned char* base = static_cast<const unsigned char*>(src);
    if (vec) {
      const int n = dh * kVal / 16;
      for (int e = tid; e < nin * n; e += kThreads) {
        const int c = e / n, b = 16 * (e % n);
        const size_t off = ((size_t)srow[c] * Dkv + (size_t)g * dh) * kVal;
        cp_async16(dst + c * kRow + b, base + off + b);
      }
    } else if (quad) {
      const int n = dh * kVal / 4;
      for (int e = tid; e < nin * n; e += kThreads) {
        const int c = e / n, b = 4 * (e % n);
        const size_t off = ((size_t)srow[c] * Dkv + (size_t)g * dh) * kVal;
        cp_async4(dst + c * kRow + b, base + off + b);
      }
    } else {
      // int8 codes of a head not a multiple of 4 wide: one a load
      for (int e = tid; e < nin * dh; e += kThreads) {
        const int c = e / dh, b = e % dh;
        const size_t off = (size_t)srow[c] * Dkv + (size_t)g * dh;
        dst[c * kRow + b] = base[off + b];
      }
    }
  };
  copy_tile(kt, k);
  if constexpr (kInt8) {
    if (tid < nin) {
      cp_async4(ksc + tid, kscale + (size_t)srow[tid] * Hkv + g);
      cp_async4(vsc + tid, vscale + (size_t)srow[tid] * Hkv + g);
    }
  }
  cp_async_commit();
  copy_tile(vt, v);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  // scores: item (column, part), the dot cut into P parts of interleaved
  // 4-dim chunks so that the split's items fill the CTA; each item
  // scores every live vector on the K chunk it read, four independent
  // sums a vector (the int8 kernel's order is the float32 kernel's, on
  // values widened at use)
  int P = 1;
  while (2 * P * nin <= kThreads && 2 * P <= kC4) P *= 2;
  for (int it = tid; it < nin * P; it += kThreads) {
    const int c = it % nin;
    const int p = it / nin;
    const unsigned char* kr = kt + c * kRow;
    float a[kVecs][4];
#pragma unroll
    for (int vv = 0; vv < kVecs; ++vv)
      a[vv][0] = a[vv][1] = a[vv][2] = a[vv][3] = 0.f;
    for (int ch = p; ch < kC4; ch += P) {
      const float4 kk = load4<kInt8>(kr, ch, kInt8 ? ksc[c] : 0.f);
#pragma unroll
      for (int vv = 0; vv < kVecs; ++vv) {
        if (vv < nv) {
          const float4 qq =
              *reinterpret_cast<const float4*>(qs + vv * DH + 4 * ch);
          a[vv][0] = fmaf(qq.x, kk.x, a[vv][0]);
          a[vv][1] = fmaf(qq.y, kk.y, a[vv][1]);
          a[vv][2] = fmaf(qq.z, kk.z, a[vv][2]);
          a[vv][3] = fmaf(qq.w, kk.w, a[vv][3]);
        }
      }
    }
#pragma unroll
    for (int vv = 0; vv < kVecs; ++vv)
      if (vv < nv)
        spart[(p * nv + vv) * nin + c] =
            (a[vv][0] + a[vv][1]) + (a[vv][2] + a[vv][3]);
  }
  __syncthreads();

  // the softmax of each live vector over the split: one warp a vector
  const int warp = tid >> 5;
  const int lane = tid & 31;
  constexpr int kPer = (L + 31) / 32;
  if (warp < nv) {
    const int pos = s_pos[s_slot[warp]];
    float s[kPer];
    float mx = kNeg;
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int c = lane + 32 * e;
      s[e] = kNeg;
      if (c < nin && s0 + c <= pos) {
        float d = spart[warp * nin + c];
        for (int p = 1; p < P; ++p) d += spart[(p * nv + warp) * nin + c];
        s[e] = d * scale;
      }
      mx = fmaxf(mx, s[e]);
    }
    mx = warp_max(mx);
    float sum = 0.f;
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int c = lane + 32 * e;
      const float pe = c < nin && s0 + c <= pos ? expf(s[e] - mx) : 0.f;
      if (c < L) pm[warp * L + c] = pe;
      sum += pe;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      sm[warp] = mx;
      sl[warp] = sum;
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // P.V: item (vector, 4-dim chunk, column group), G groups of
  // interleaved columns so that the items fill the CTA, merged in group
  // order
  const int nc = nv * kC4;
  int G = 1;
  while (2 * G * nc <= kThreads && 2 * G <= nin) G *= 2;
  for (int it = tid; it < nc * G; it += kThreads) {
    const int ch = it % nc;
    const int grp = it / nc;
    const int vv = ch / kC4;
    const int d4 = ch % kC4;
    const float* pv = pm + vv * L;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int c = grp; c < nin; c += G) {
      const float pc = pv[c];
      const float4 x = load4<kInt8>(vt + c * kRow, d4, kInt8 ? vsc[c] : 0.f);
      acc.x = fmaf(pc, x.x, acc.x);
      acc.y = fmaf(pc, x.y, acc.y);
      acc.z = fmaf(pc, x.z, acc.z);
      acc.w = fmaf(pc, x.w, acc.w);
    }
    if (G == 1)
      *reinterpret_cast<float4*>(ores + vv * DH + 4 * d4) = acc;
    else
      opart[grp * nc + ch] = acc;
  }
  if (G > 1) {
    __syncthreads();
    for (int ch = tid; ch < nc; ch += kThreads) {
      float4 a = opart[ch];
      for (int grp = 1; grp < G; ++grp) {
        const float4 b = opart[grp * nc + ch];
        a.x += b.x;
        a.y += b.y;
        a.z += b.z;
        a.w += b.w;
      }
      *reinterpret_cast<float4*>(ores + (ch / kC4) * DH + 4 * (ch % kC4)) = a;
    }
  }
  __syncthreads();

  const int tix = blockIdx.z * gridDim.y + g;  // (row, group, KV head)
  auto write_out = [&](int u, int d, float val) {
    const int jq = z * kVecs + u;
    const int i = jq / group;
    const int h = g * group + jq % group;
    out[((size_t)r * K + i) * D + (size_t)h * dh + d] = val;
  };
  if (nsplit == 1) {
    // the one split: finalize here (every vector of the group is in
    // its live list or dead)
    for (int e = tid; e < kVecs * dh; e += kThreads) {
      const int u = e / dh, d = e % dh;
      if (z * kVecs + u >= nq) continue;
      const int vv = s_vof[u];
      write_out(u, d, vv < 0 ? 0.f : ores[vv * DH + d] / fmaxf(sl[vv], 1e-30f));
    }
    return;
  }

  // the split's record of each live vector, then the ticket
  constexpr int kR = kRec<DH>;
  float* rec = part + ((size_t)tix * gridDim.x + split) * kVecs * kR;
  for (int e = tid; e < nv * kC4; e += kThreads) {
    const int vv = e / kC4, d4 = e % kC4;
    *reinterpret_cast<float4*>(rec + s_slot[vv] * kR + 4 + 4 * d4) =
        *reinterpret_cast<const float4*>(ores + vv * DH + 4 * d4);
  }
  if (tid < nv) {
    rec[s_slot[tid] * kR] = sm[tid];
    rec[s_slot[tid] * kR + 1] = sl[tid];
  }
  // the CTA's records, seen by thread 0 through the barrier, are made
  // visible to the device by its fence before the ticket (release); the
  // last CTA's thread 0 fences after its ticket before the barrier that
  // lets its threads read the records (acquire)
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    const bool last = atomicAdd(tickets + tix, 1) == nsplit - 1;
    if (last) {
      tickets[tix] = 0;             // ready for the next launch
      __threadfence();
    }
    s_misc[1] = last;
  }
  __syncthreads();
  if (!s_misc[1]) return;

  // the merge of each vector's splits 0 .. its last, in split order, as
  // an online softmax over the records (a running max; num and den
  // rescaled as it grows), every record's loads unrolled to be in
  // flight together
  const float* rec0 = part + (size_t)tix * gridDim.x * kVecs * kR;
  const size_t stride = (size_t)kVecs * kR;
  for (int e = tid; e < kVecs * dh; e += kThreads) {
    const int u = e / dh, d = e % dh;
    if (z * kVecs + u >= nq) continue;
    float val = 0.f;
    if (s_pos[u] >= 0) {
      const float* ru = rec0 + u * kR;
      const int n = min(s_pos[u], hi) / L + 1;
      float mx = kNeg, num = 0.f, den = 0.f;
#pragma unroll 4
      for (int s = 0; s < n; ++s) {
        const float* rs = ru + s * stride;
        const float m = __ldcg(rs);
        const float mn = fmaxf(mx, m);
        const float alpha = expf(mx - mn);
        const float w = expf(m - mn);
        num = fmaf(__ldcg(rs + 4 + d), w, num * alpha);
        den = fmaf(__ldcg(rs + 1), w, den * alpha);
        mx = mn;
      }
      val = num / fmaxf(den, 1e-30f);
    }
    write_out(u, d, val);
  }
}


// Launch one instance (the shared-memory limit raised as start's).
template <int DH, bool kPaged, bool kInt8, bool kPad>
cudaError_t start_split(dim3 grid, cudaStream_t st, const float* q,
                        const void* k, const void* v, const float* kscale,
                        const float* vscale, const int* qpos,
                        const int* tables, float* out, float* part,
                        int* tickets, int K, int span, int bs, int nb_row,
                        int H, int Hkv, int dh, float scale) {
  constexpr size_t smem = split_smem_bytes<DH, kInt8>();
  if constexpr (smem > 48 * 1024) {
    static std::atomic<unsigned> raised{0u};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    const unsigned bit = dev < 32 ? 1u << dev : 0u;
    if (bit == 0u || !(raised.load() & bit)) {
      e = cudaFuncSetAttribute(split_kernel<DH, kPaged, kInt8, kPad>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
      if (e != cudaSuccess) return e;
      raised.fetch_or(bit);
    }
  }
  split_kernel<DH, kPaged, kInt8, kPad><<<grid, kThreads, smem, st>>>(
      q, k, v, kscale, vscale, qpos, tables, out, part, tickets, K, span, bs,
      nb_row, H, Hkv, dh, scale);
  return cudaSuccess;
}

// CTAs a (row, KV head, split): groups of kVecs query vectors
inline int vec_groups(int K, int H, int Hkv) {
  return (K * (H / Hkv) + kVecs - 1) / kVecs;
}

template <bool kPaged, bool kInt8>
int launch_split(const float* q, const void* k, const void* v,
                 const float* kscale, const float* vscale, const int* qpos,
                 const int* tables, float* out, float* part, int* tickets,
                 int S, int K, int span, int bs, int nb_row, int H, int Hkv,
                 int dh, float scale, void* stream) {
  const int width = compiled_width(dh);
  if (width == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int nsplit = (span + split_cols(width) - 1) / split_cols(width);
  const long long zs = static_cast<long long>(S) * vec_groups(K, H, Hkv);
  if (zs > 65535 || Hkv > 65535 ||
      (nsplit > 1 && (part == nullptr || tickets == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(nsplit, Hkv, static_cast<unsigned>(zs));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
#define PT_START(W, P)                                                      \
  e = start_split<W, kPaged, kInt8, P>(grid, st, q, k, v, kscale, vscale, \
                                       qpos, tables, out, part, tickets, K, \
                                       span, bs, nb_row, H, Hkv, dh, scale)
#define PT_WIDTH(W)           \
  if (dh == W)                \
    PT_START(W, false);       \
  else                        \
    PT_START(W, true)
  switch (width) {
    case 16: PT_WIDTH(16); break;
    case 32: PT_WIDTH(32); break;
    case 64: PT_WIDTH(64); break;
    case 128: PT_WIDTH(128); break;
    case 256: PT_START(256, false); break;
    case 384: PT_START(384, false); break;
    default: PT_START(512, false); break;
  }
#undef PT_WIDTH
#undef PT_START
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each entry returns cudaGetLastError() after the launch (0 = launched).
// The _i8 entries take int8 k/v and their f32 scales ks/vs, shaped as
// k/v with Hkv in place of Dkv.  The chunked entries also take the
// caller's scratch `part` (decode_attention_chunk_scratch floats, any
// contents; null where that is 0) and `tickets`
// (decode_attention_chunk_tickets ints, all 0 before the launch and
// left 0 after it).

// Floats of the scratch a chunked entry takes at these shapes (span =
// T, or nb_row * bs on the pool): 0 where one split covers the span, -1
// for a head width the kernels do not take.
extern "C" long long decode_attention_chunk_scratch(int S, int K, int span,
                                                    int H, int Hkv, int dh) {
  const int width = compiled_width(dh);
  if (width == 0) return -1;
  const long long nsplit = (span + split_cols(width) - 1) / split_cols(width);
  if (nsplit <= 1) return 0;
  return static_cast<long long>(S) * vec_groups(K, H, Hkv) * Hkv * nsplit *
         kVecs * (width + 4);
}

// Ints of the tickets a chunked entry takes: one a (row, KV head, group
// of query vectors).
extern "C" long long decode_attention_chunk_tickets(int S, int K, int H,
                                                    int Hkv) {
  return static_cast<long long>(S) * vec_groups(K, H, Hkv) * Hkv;
}

// q [S, K, D], k/v [S, T, Dkv], qpos [S, K] -> out [S, K, D]
extern "C" int decode_attention_slab_chunk_f32(
    const float* q, const float* k, const float* v, const int* qpos,
    float* out, float* part, int* tickets, int S, int K, int T, int H,
    int Hkv, int dh, float scale, void* stream) {
  return launch_split<false, false>(q, k, v, nullptr, nullptr, qpos, nullptr,
                                    out, part, tickets, S, K, T, 1, 1, H, Hkv,
                                    dh, scale, stream);
}

extern "C" int decode_attention_slab_chunk_i8(
    const float* q, const int8_t* k, const int8_t* v, const float* ks,
    const float* vs, const int* qpos, float* out, float* part, int* tickets,
    int S, int K, int T, int H, int Hkv, int dh, float scale, void* stream) {
  return launch_split<false, true>(q, k, v, ks, vs, qpos, nullptr, out, part,
                                   tickets, S, K, T, 1, 1, H, Hkv, dh, scale,
                                   stream);
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
    const int* tables, float* out, float* part, int* tickets, int S, int K,
    int bs, int nb_row, int H, int Hkv, int dh, float scale, void* stream) {
  return launch_split<true, false>(q, k, v, nullptr, nullptr, qpos, tables,
                                   out, part, tickets, S, K, nb_row * bs, bs,
                                   nb_row, H, Hkv, dh, scale, stream);
}

extern "C" int decode_attention_paged_chunk_i8(
    const float* q, const int8_t* k, const int8_t* v, const float* ks,
    const float* vs, const int* qpos, const int* tables, float* out,
    float* part, int* tickets, int S, int K, int bs, int nb_row, int H,
    int Hkv, int dh, float scale, void* stream) {
  return launch_split<true, true>(q, k, v, ks, vs, qpos, tables, out, part,
                                  tickets, S, K, nb_row * bs, bs, nb_row, H,
                                  Hkv, dh, scale, stream);
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
