// Fused whole-sequence peephole LSTM for Hopper (sm_90a), float32:
// forward (lean and residual-saving), BPTT backward, and the dW_r product,
// every recurrent product on the tensor cores in 3xTF32.
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
//   Takes any T >= 1, B >= 1 and D a multiple of 128 whose W_r slice fits
//   in shared memory (D <= 640): every (B, D) the route's rule admits.
//
// Bound on this card: operations.  At the training shape (T=100, B=64,
//   D=512) the recurrent products are 13.3 GFLOP forward and 26.6 GFLOP
//   backward against ~135 / ~150 MB moved: 0.081 / 0.161 ms at TF32's
//   dense rate over 3 (3xTF32, below), 0.198 / 0.397 ms as float32 SIMT.
//
// Products: mma.sync.m16n8k8 TF32 instructions in the 3xTF32 split of
//   csrc/lstm_blocked.cu: each float32 operand x is split into big = x
//   rounded to TF32 and small = x - big (the tensor cores truncate it),
//   a b = a_small b_big + a_big b_small + a_big b_big, each k-step's three
//   summed in a fresh tile and added to the float32 accumulator (chained
//   in the tensor cores they truncate every sum).
//
// Design: the TPU kernel's grid IS the time loop, with W_r (4 MB at
//   D=512) resident in VMEM.  No SM holds W_r here, and CTAs run in
//   parallel, so each recurrence is ONE persistent cooperative launch with
//   one cooperative_groups grid.sync() a step:
//   - CTA (u, g) owns hidden units [16u, 16u + 16) -- their 64 gate
//     columns [gate D + 16u + j] -- and the 16-row b-blocks g, g + NG,
//     g + 2 NG, ... of the batch.  NU = D / 16 unit blocks times NG
//     b-groups, NG as many as stay co-resident (up to the batch's
//     b-blocks): at D=512, B=64 that is 32 x 4 CTAs, at D=640, B=32
//     40 x 2.  A CTA loops over its b-blocks where B is large.
//   - Forward: the CTA's W_r slice, its 64 gate columns over K = D, stays
//     in shared memory for the launch as [n][k] rows at pitch D + 4 (a
//     warp's B-fragment reads hit 32 banks).  Each b-block's product is
//     one m16 tile over 8 n-tiles, h_{t-1}'s rows staged in 128-column
//     chunks through a 3-stage cp.async ring (through L2 only: written by
//     other SMs before the barrier), so a CTA reads only its own rows --
//     a quarter of the L2 traffic of owning every row at B=64.  The 16
//     warps are 4 k-groups x 4 n-groups, 2 n-tiles a warp; k-group q
//     walks k-steps [4q, 4q + 4) of every chunk, and the groups' partial
//     tiles meet in shared memory, summed in a fixed order (bit for bit
//     the same every run).  One thread a (row, unit) then runs the cell,
//     its inputs loaded before the product so that their latency hides
//     behind it; c lives in c_fin, read and written only by its owner
//     thread.  At t = 0, h_{-1} = 0 skips the product.
//   - Backward, over reversed time, K split by unit block: dh_prev =
//     dgates_t @ W_r^T sums over the 4D gate columns, and a CTA computes
//     the dgates of its own 64 columns (phase 1, from the saved acts,
//     into dxs[t] and into a shared-memory tile), so it multiplies that
//     tile by W_r's matching 64 columns (resident as [j][k] for all D
//     rows j, 174 KB at D=640, so D <= 640) into its partial of dh_prev
//     for its rows and every unit, written to the part scratch.  After
//     the step's barrier each CTA sums the NU partials of its own (row,
//     unit)s in unit-block order and merges them with the mask, then runs
//     phase 1 of the next step: one barrier a step, no CTA reading other
//     CTAs' dgates, the partials double-buffered by step parity so that a
//     step's writes never meet the previous step's reads.  The carries of
//     a (row, unit) are read and written by its owner thread only.
//   - dW_r = sum_t h_{t-1}^T dgates_t has no recurrence: after the loop a
//     3xTF32 tiled product [D, (T-1) B] x [(T-1) B, 4D] (h_{-1} = 0 drops
//     t=0), 128 x 64 tiles of 8 warps over 32-row chunks in a 3-stage ring.
//   Later work (ROADMAP B9): wgmma with TMA loads, sharing a b-block's
//   rows across the CTAs of a cluster, cheaper barriers.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;          // 16 warps
constexpr int kWarps = kThreads / 32;
constexpr int kUnits = 16;             // hidden units a CTA owns
constexpr int kRows = 16;              // batch rows of a b-block: one m16 tile
constexpr int kCells = kRows * kUnits; // (row, unit) pairs of a b-block
constexpr int kSmemMax = 232448;       // 227 KB, the opt-in maximum a block
constexpr int kKP = 4 * kUnits + 4;    // backward: pitch of the owned gate columns
constexpr int kMaxNtw = 5;             // backward: D / 128 n-tiles a warp, up to D = 640

// One b-block's product: NT n-tiles of the resident slice over K, the
// rows in KC-column chunks through an S-stage ring, KG k-groups.
template <int NT, int KG, int KC, int S>
struct Prod {
  static constexpr int kNgroups = kWarps / KG;
  static constexpr int kNtw = NT / kNgroups;   // n-tiles a warp
  static_assert(kNgroups * kNtw == NT, "n-tiles split evenly over the n-groups");
  static constexpr int kKs = KC / 8 / KG;      // k-steps a warp a chunk
  static_assert(kKs >= 1, "every k-group has a k-step in each chunk");
  static constexpr int kAP = KC + 4;           // staged row pitch
  static constexpr int kStage = kRows * kAP;
  static constexpr int kPP = NT * 8 + 4;       // partial tile row pitch
  static constexpr int kPart = KG * kRows * kPP;
  static constexpr int kRegion = S * kStage > kPart ? S * kStage : kPart;
  static constexpr int kGroups = KG;
  static constexpr int kChunk = KC;
  static constexpr int kStages = S;
};
using Fwd = Prod<8, 4, 128, 3>;

struct Args {
  const float* xs;      // [T, B, 4D]
  const float* mask;    // [T, B]
  const float* w_r;     // [D, 4D]
  const float* checks;  // [3, D]
  float* hs;            // [T, B, D]
  float* cfin;          // [B, D], the c carry
  float* cs;            // [T, B, D] (residual variant; read by the backward)
  float* acts;          // [T, B, 4D] (residual variant; read by the backward)
  const float* dh_out;  // [T, B, D]
  const float* dcfin;   // [B, D]
  float* dxs;           // [T, B, 4D]
  float* dchk;          // [B, 3D]
  float* dh_carry;      // [B, D]
  float* dc_carry;      // [B, D]
  float* part;          // [2][D / 16][B, D]: dh_prev's partials, by step parity
  int T, B, D;
  int NG;               // b-groups
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

// d += a b in 3xTF32 for one k-step of 8, B already split: the three
// products in a fresh tile, then added to d in float32
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4], uint32_t bb0, uint32_t bs0,
                                     uint32_t bb1, uint32_t bs1) {
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

// The partial products of one b-block: part[q][r][n] (at region, pitch
// P::kPP) = the sum over k-group q's k-steps of A[r0 + r][k] w[n][k], rows
// r >= rows zero.  A is global with row stride lda (read through L2); w is
// the resident slice [NT * 8][K + 4].  Ends with a __syncthreads: the
// partial tiles are complete and the ring is free.
template <class P>
__device__ __forceinline__ void product(const float* A, int lda, int K, int r0, int rows,
                                        const float* w, float* region) {
  constexpr int KC = P::kChunk, S = P::kStages;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int kq = warp % P::kGroups, n_lo = warp / P::kGroups * P::kNtw;
  const int wp = K + 4, nk = K / KC;
  float acc[P::kNtw][4];
#pragma unroll
  for (int n = 0; n < P::kNtw; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  auto load = [&](int kc) {
    float* s = region + (kc % S) * P::kStage;
    for (int e = tid; e < kRows * (KC / 4); e += kThreads) {
      const int r = e / (KC / 4), c = (e % (KC / 4)) * 4;
      const bool ok = r < rows;
      cp_async16(s + r * P::kAP + c, A + (size_t)(r0 + (ok ? r : 0)) * lda + kc * KC + c, ok);
    }
  };
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < nk) load(s);
    cp_async_commit();
  }
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<S - 2>();  // chunk kc landed (this thread's copies)
    __syncthreads();         // ... and every thread's; chunk kc - 1 consumed
    if (kc + S - 1 < nk) load(kc + S - 1);
    cp_async_commit();
    const float* ac = region + (kc % S) * P::kStage + g * P::kAP + t4;
    const float* wc = w + (size_t)(n_lo * 8 + g) * wp + kc * KC + t4;
#pragma unroll
    for (int k8 = 0; k8 < P::kKs; ++k8) {
      const int kk = (kq * P::kKs + k8) * 8;
      const float* ar = ac + kk;
      uint32_t ab[4], as[4];
      split(ar[0], ab[0], as[0]);
      split(ar[8 * P::kAP], ab[1], as[1]);
      split(ar[4], ab[2], as[2]);
      split(ar[8 * P::kAP + 4], ab[3], as[3]);
#pragma unroll
      for (int n = 0; n < P::kNtw; ++n) {
        const float* wr = wc + (size_t)n * 8 * wp + kk;
        uint32_t bb0, bs0, bb1, bs1;
        split(wr[0], bb0, bs0);
        split(wr[4], bb1, bs1);
        mma3(acc[n], ab, as, bb0, bs0, bb1, bs1);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every chunk consumed before the partial tiles overwrite the ring
  float* pt = region + (kq * kRows + g) * P::kPP + n_lo * 8 + 2 * t4;
#pragma unroll
  for (int n = 0; n < P::kNtw; ++n) {
    *reinterpret_cast<float2*>(pt + n * 8) = make_float2(acc[n][0], acc[n][1]);
    *reinterpret_cast<float2*>(pt + 8 * P::kPP + n * 8) = make_float2(acc[n][2], acc[n][3]);
  }
  __syncthreads();
}

// column n of a b-block's partial tiles, the k-groups summed first to last
template <class P>
__device__ __forceinline__ float part_sum(const float* region, int r, int n) {
  const float* p = region + r * P::kPP + n;
  float s = p[0];
#pragma unroll
  for (int q = 1; q < P::kGroups; ++q) s += p[q * kRows * P::kPP];
  return s;
}

template <bool kResid>
__global__ void __launch_bounds__(kThreads, 1) lstm_fwd_kernel(Args p) {
  extern __shared__ __align__(16) float smem[];
  cg::grid_group grid = cg::this_grid();
  const int T = p.T, B = p.B, D = p.D, G = 4 * D;
  const int nu = D / kUnits, nbb = (B + kRows - 1) / kRows;
  const int u0 = (blockIdx.x % nu) * kUnits, bg = blockIdx.x / nu;
  const int wp = D + 4, tid = threadIdx.x;
  float* w = smem;                    // [64][D + 4]: w[n][k] = W_r[k][(n / 16) D + u0 + n % 16]
  float* region = smem + 4 * kUnits * wp;
  for (int e = tid; e < D * 4 * kUnits; e += kThreads) {
    const int k = e / (4 * kUnits), n = e % (4 * kUnits);
    w[n * wp + k] = p.w_r[(size_t)k * G + (n / kUnits) * D + u0 + n % kUnits];
  }
  // this thread's cell in a b-block: (row cr, unit cu)
  const int cr = tid / kUnits, cu = tid % kUnits, col = u0 + cu;
  const bool cell = tid < kCells;
  const float ci = p.checks[col], cf = p.checks[D + col], co = p.checks[2 * D + col];
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const float* hprev = p.hs + (size_t)(t > 0 ? t - 1 : 0) * B * D;
    for (int bb = bg; bb < nbb; bb += p.NG) {
      const int r0 = bb * kRows, rows = min(kRows, B - r0);
      const bool mine = cell && cr < rows;
      const int b = r0 + (mine ? cr : 0);
      const size_t xrow = ((size_t)t * B + b) * G;
      const size_t hidx = (size_t)b * D + col;
      const size_t tidx = (size_t)t * B * D + hidx;
      // the cell's inputs are loaded before the product, which hides
      // their latency
      float xa = 0.f, xi = 0.f, xf = 0.f, xo = 0.f, m = 0.f, c = 0.f, hp = 0.f;
      if (mine) {
        xa = p.xs[xrow + col];
        xi = p.xs[xrow + D + col];
        xf = p.xs[xrow + 2 * D + col];
        xo = p.xs[xrow + 3 * D + col];
        m = p.mask[(size_t)t * B + b];
        if (t > 0) {
          c = p.cfin[hidx];
          hp = hprev[hidx];  // written by this thread at t - 1
        }
      }
      if (t > 0) product<Fwd>(hprev, D, D, r0, rows, w, region);  // h_{-1} = 0 at t = 0
      if (mine) {
        float ga = 0.f, gi = 0.f, gf = 0.f, go = 0.f;
        if (t > 0) {
          ga = part_sum<Fwd>(region, cr, cu);
          gi = part_sum<Fwd>(region, cr, kUnits + cu);
          gf = part_sum<Fwd>(region, cr, 2 * kUnits + cu);
          go = part_sum<Fwd>(region, cr, 3 * kUnits + cu);
        }
        const float a = tanhf(xa + ga);
        const float i = sigmoid(xi + gi + c * ci);
        const float f = sigmoid(xf + gf + c * cf);
        const float cn = a * i + c * f;
        const float o = sigmoid(xo + go + cn * co);
        const float hn = o * tanhf(cn);
        const float h = m * hn + (1.f - m) * hp;
        const float cm = m * cn + (1.f - m) * c;
        p.hs[tidx] = h;
        p.cfin[hidx] = cm;
        if (kResid) {
          p.cs[tidx] = cm;
          p.acts[xrow + col] = a;
          p.acts[xrow + D + col] = i;
          p.acts[xrow + 2 * D + col] = f;
          p.acts[xrow + 3 * D + col] = o;
        }
      }
      __syncthreads();  // the partial tiles read before the next b-block's ring loads
    }
    if (t + 1 < T) grid.sync();  // hs[t] complete on every SM before step t+1
  }
}

// NTW = D / 128: the n-tiles of the partial product a warp takes
template <int NTW>
__global__ void __launch_bounds__(kThreads, 1) lstm_bwd_kernel(Args p) {
  extern __shared__ __align__(16) float smem[];
  cg::grid_group grid = cg::this_grid();
  const int T = p.T, B = p.B, D = p.D, G = 4 * D;
  constexpr int nu = NTW * 8;       // D / 16 unit blocks
  const int nbb = (B + kRows - 1) / kRows;
  const int ub = blockIdx.x % nu, u0 = ub * kUnits, bg = blockIdx.x / nu;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  float* w = smem;                  // [D][kKP]: w[j][k] = W_r[j][(k / 16) D + u0 + k % 16]
  float* at = smem + (size_t)D * kKP;  // [16][kKP]: the b-block's dgates of the owned columns
  for (int e = tid; e < D * 4 * kUnits; e += kThreads) {
    const int j = e / (4 * kUnits), k = e % (4 * kUnits);
    w[j * kKP + k] = p.w_r[(size_t)j * G + (k / kUnits) * D + u0 + k % kUnits];
  }
  // this thread's cell in a b-block: (row cr, unit cu)
  const int cr = tid / kUnits, cu = tid % kUnits, col = u0 + cu;
  const bool cell = tid < kCells;
  const float ci = p.checks[col], cf = p.checks[D + col], co = p.checks[2 * D + col];
  const size_t part_floats = (size_t)nu * B * D;
  __syncthreads();

  for (int s = 0; s < T; ++s) {
    const int t = T - 1 - s;
    const float* pin = p.part + (size_t)((t + 1) & 1) * part_floats;  // step t+1's partials
    float* pout = p.part + (size_t)(t & 1) * part_floats;
    for (int bb = bg; bb < nbb; bb += p.NG) {
      const int r0 = bb * kRows, rows = min(kRows, B - r0);
      if (cell && cr < rows) {
        const int b = r0 + cr;
        const size_t arow = ((size_t)t * B + b) * G;
        const size_t hidx = (size_t)b * D + col;
        const size_t tidx = (size_t)t * B * D + hidx;
        const size_t pidx = (size_t)b * 3 * D + col;
        // every load of the step first, so that their latencies overlap
        const float a = p.acts[arow + col], i = p.acts[arow + D + col];
        const float f = p.acts[arow + 2 * D + col], o = p.acts[arow + 3 * D + col];
        const float ct = p.cs[tidx];
        const float cp = t > 0 ? p.cs[tidx - (size_t)B * D] : 0.f;
        const float m = p.mask[(size_t)t * B + b];
        const float dho = p.dh_out[tidx];
        const float dcm = s > 0 ? p.dc_carry[hidx] : p.dcfin[hidx];
        float dh = 0.f;
        if (s > 0) {
          // dh_prev of step t+1: its NU unit blocks' partials summed in
          // order, merged with that step's mask and carried dh
          const float m1 = p.mask[(size_t)(t + 1) * B + b];
          const float* pr = pin + (size_t)b * D + col;
          float v[nu];
#pragma unroll
          for (int q = 0; q < nu; ++q) v[q] = __ldcg(pr + (size_t)q * B * D);
          float dhp = 0.f;
#pragma unroll
          for (int q = 0; q < nu; ++q) dhp += v[q];
          dh = m1 * dhp + (1.f - m1) * p.dh_carry[hidx];
        }
        dh += dho;
        const float tc = tanhf(ct);
        const float dog = dh * tc * o * (1.f - o);
        const float dc = dh * o * (1.f - tc * tc) + dcm + dog * co;
        const float dag = dc * i * (1.f - a * a);
        const float dig = dc * a * i * (1.f - i);
        const float dfg = dc * cp * f * (1.f - f);
        p.dxs[arow + col] = dag * m;
        p.dxs[arow + D + col] = dig * m;
        p.dxs[arow + 2 * D + col] = dfg * m;
        p.dxs[arow + 3 * D + col] = dog * m;
        float* ar = at + cr * kKP + cu;
        ar[0] = dag * m;
        ar[kUnits] = dig * m;
        ar[2 * kUnits] = dfg * m;
        ar[3 * kUnits] = dog * m;
        const float dcp = dc * f + dig * ci + dfg * cf;
        p.dc_carry[hidx] = m * dcp + (1.f - m) * dcm;
        p.dh_carry[hidx] = dh;  // the merged dh, for step t's pass-through
        const float p0 = s > 0 ? p.dchk[pidx] : 0.f;
        const float p1 = s > 0 ? p.dchk[pidx + D] : 0.f;
        const float p2 = s > 0 ? p.dchk[pidx + 2 * D] : 0.f;
        p.dchk[pidx] = p0 + m * dig * cp;
        p.dchk[pidx + D] = p1 + m * dfg * cp;
        p.dchk[pidx + 2 * D] = p2 + m * dog * ct;
      }
      if (t == 0) continue;  // dh_{-1} is not needed
      __syncthreads();       // the dgates tile complete
      // this unit block's partial of dh_prev for the b-block's rows:
      // pout[ub][b][j] = sum_k at[b - r0][k] w[j][k] over the owned 64
      // gate columns, one n-tile of 8 j's per mma, 8 k-steps each
      float acc[NTW][4];
#pragma unroll
      for (int n = 0; n < NTW; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
      for (int k8 = 0; k8 < 4 * kUnits / 8; ++k8) {
        const float* ar = at + g * kKP + k8 * 8 + t4;
        uint32_t ab[4], as[4];
        split(ar[0], ab[0], as[0]);
        split(ar[8 * kKP], ab[1], as[1]);
        split(ar[4], ab[2], as[2]);
        split(ar[8 * kKP + 4], ab[3], as[3]);
#pragma unroll
        for (int n = 0; n < NTW; ++n) {
          const float* wr = w + (size_t)((warp * NTW + n) * 8 + g) * kKP + k8 * 8 + t4;
          uint32_t bb0, bs0, bb1, bs1;
          split(wr[0], bb0, bs0);
          split(wr[4], bb1, bs1);
          mma3(acc[n], ab, as, bb0, bs0, bb1, bs1);
        }
      }
      float* po = pout + ((size_t)ub * B + r0 + g) * D + 2 * t4;
#pragma unroll
      for (int n = 0; n < NTW; ++n) {
        const int j = (warp * NTW + n) * 8;
        if (g < rows)
          *reinterpret_cast<float2*>(po + j) = make_float2(acc[n][0], acc[n][1]);
        if (g + 8 < rows)
          *reinterpret_cast<float2*>(po + 8 * (size_t)D + j) = make_float2(acc[n][2], acc[n][3]);
      }
      __syncthreads();  // the dgates tile read before the next b-block's cells write it
    }
    if (t > 0) grid.sync();  // every partial of dh_prev written before step t-1 sums them
  }
}

// dwr[M][N] = sum_k h[k][m] g[k][n], both operands row-major over k (h =
// hs[0:T-1] as [K, D], g = dxs[1:T] as [K, 4D]), in 3xTF32: 128 x 64
// tiles, 8 warps of 32 x 32, 32-row k chunks through a 3-stage ring
// (rows past K zero); M a multiple of 128, N of 64.
constexpr int kDwM = 128, kDwN = 64, kDwK = 32, kDwStages = 3;
constexpr int kDwAP = kDwM + 8, kDwBP = kDwN + 8;  // pitches = 8 (mod 32): conflict-free fragments
constexpr int kDwStage = kDwK * (kDwAP + kDwBP);
constexpr size_t kDwSmem = sizeof(float) * kDwStages * kDwStage;

__global__ void __launch_bounds__(256) lstm_dwr_kernel(const float* __restrict__ h,
                                                       const float* __restrict__ g,
                                                       float* __restrict__ dwr, int K, int M,
                                                       int N) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t4 = lane & 3;
  const int m0 = blockIdx.y * kDwM, n0 = blockIdx.x * kDwN;
  const int wm = (warp % 4) * 32, wn = (warp / 4) * 32;
  const int nk = (K + kDwK - 1) / kDwK;
  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  auto load = [&](int kc) {
    float* a = smem + (kc % kDwStages) * kDwStage;
    float* b = a + kDwK * kDwAP;
    const int k0 = kc * kDwK;
    for (int e = tid; e < kDwK * (kDwM / 4); e += 256) {
      const int r = e / (kDwM / 4), c = (e % (kDwM / 4)) * 4;
      const bool ok = k0 + r < K;
      cp_async16(a + r * kDwAP + c, h + (size_t)(ok ? k0 + r : 0) * M + m0 + c, ok);
    }
    for (int e = tid; e < kDwK * (kDwN / 4); e += 256) {
      const int r = e / (kDwN / 4), c = (e % (kDwN / 4)) * 4;
      const bool ok = k0 + r < K;
      cp_async16(b + r * kDwBP + c, g + (size_t)(ok ? k0 + r : 0) * N + n0 + c, ok);
    }
  };
#pragma unroll
  for (int s = 0; s < kDwStages - 1; ++s) {
    if (s < nk) load(s);
    cp_async_commit();
  }
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<kDwStages - 2>();
    __syncthreads();
    if (kc + kDwStages - 1 < nk) load(kc + kDwStages - 1);
    cp_async_commit();
    const float* a = smem + (kc % kDwStages) * kDwStage;
    const float* b = a + kDwK * kDwAP;
#pragma unroll
    for (int k8 = 0; k8 < kDwK / 8; ++k8) {
      uint32_t ab[2][4], as[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {  // A[m][k] = a[k][m]
        const float* ar = a + (k8 * 8 + t4) * kDwAP + wm + i * 16 + gq;
        split(ar[0], ab[i][0], as[i][0]);
        split(ar[8], ab[i][1], as[i][1]);
        split(ar[4 * kDwAP], ab[i][2], as[i][2]);
        split(ar[4 * kDwAP + 8], ab[i][3], as[i][3]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* br = b + (k8 * 8 + t4) * kDwBP + wn + j * 8 + gq;
        uint32_t bb0, bs0, bb1, bs1;
        split(br[0], bb0, bs0);
        split(br[4 * kDwBP], bb1, bs1);
#pragma unroll
        for (int i = 0; i < 2; ++i) mma3(acc[i][j], ab[i], as[i], bb0, bs0, bb1, bs1);
      }
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = m0 + wm + i * 16 + gq, c = n0 + wn + j * 8 + 2 * t4;
      *reinterpret_cast<float2*>(dwr + (size_t)row * N + c) =
          make_float2(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<float2*>(dwr + (size_t)(row + 8) * N + c) =
          make_float2(acc[i][j][2], acc[i][j][3]);
    }
}

size_t fwd_smem(int D) { return sizeof(float) * ((size_t)4 * kUnits * (D + 4) + Fwd::kRegion); }
size_t bwd_smem(int D) { return sizeof(float) * ((size_t)(D + kRows) * kKP); }

bool shape_ok(int T, int B, int D) {
  return T >= 1 && B >= 1 && D >= 128 && D % 128 == 0 && D / 128 <= kMaxNtw &&
         fwd_smem(D) <= (size_t)kSmemMax && bwd_smem(D) <= (size_t)kSmemMax;
}

// A cooperative launch fails unless every CTA can be resident at once:
// D / 16 unit blocks times as many b-groups as then fit (up to the
// batch's b-blocks).
cudaError_t coop_launch(const void* kern, size_t smem, Args& p, cudaStream_t st) {
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
  const int nu = p.D / kUnits, nbb = (p.B + kRows - 1) / kRows, cap = per_sm * sms;
  if (!coop || cap < nu) return cudaErrorCooperativeLaunchTooLarge;
  p.NG = nbb < cap / nu ? nbb : cap / nu;
  void* args[] = {&p};
  e = cudaLaunchCooperativeKernel(kern, dim3(nu * p.NG), dim3(kThreads), args, smem, st);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

int dwr(const float* hs, const float* dxs, float* out, int T, int B, int D, cudaStream_t st) {
  const void* kern = reinterpret_cast<const void*>(lstm_dwr_kernel);
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(kDwSmem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int G = 4 * D;
  lstm_dwr_kernel<<<dim3(G / kDwN, D / kDwM), 256, kDwSmem, st>>>(hs, dxs + (size_t)B * G, out,
                                                                   (T - 1) * B, D, G);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each entry returns the first failing cudaError_t of its launches (0 =
// launched).  D a multiple of 128 up to 640, any T, B >= 1; the caller
// checks shapes.  cs / acts may be null when save_residuals is 0.
extern "C" int lstm_fwd_f32(const float* xs, const float* mask, const float* w_r,
                            const float* checks, float* hs, float* cfin, float* cs,
                            float* acts, int T, int B, int D, int save_residuals,
                            void* stream) {
  if (!shape_ok(T, B, D)) return static_cast<int>(cudaErrorInvalidValue);
  Args p{};
  p.xs = xs, p.mask = mask, p.w_r = w_r, p.checks = checks;
  p.hs = hs, p.cfin = cfin, p.cs = cs, p.acts = acts;
  p.T = T, p.B = B, p.D = D;
  const void* kern = save_residuals ? reinterpret_cast<const void*>(lstm_fwd_kernel<true>)
                                    : reinterpret_cast<const void*>(lstm_fwd_kernel<false>);
  return static_cast<int>(coop_launch(kern, fwd_smem(D), p, static_cast<cudaStream_t>(stream)));
}

// dW_r alone (the second launch of lstm_bwd_f32), from hs [T, B, D] and
// dxs [T, B, 4D].
extern "C" int lstm_dwr_f32(const float* hs, const float* dxs, float* dwr_out, int T, int B,
                            int D, void* stream) {
  if (!shape_ok(T, B, D)) return static_cast<int>(cudaErrorInvalidValue);
  return dwr(hs, dxs, dwr_out, T, B, D, static_cast<cudaStream_t>(stream));
}

// BPTT over reversed time, then dW_r.  dh_carry / dc_carry are [B, D]
// scratch, part [2, D / 16, B, D] scratch; dchk is [B, 3D] per-row
// partials.
extern "C" int lstm_bwd_f32(const float* acts, const float* cs, const float* hs,
                            const float* w_r, const float* checks, const float* mask,
                            const float* dh_out, const float* dcfin, float* dxs, float* dwr_out,
                            float* dchk, float* dh_carry, float* dc_carry, float* part, int T,
                            int B, int D, void* stream) {
  if (!shape_ok(T, B, D)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Args p{};
  p.mask = mask, p.w_r = w_r, p.checks = checks;
  p.cs = const_cast<float*>(cs), p.acts = const_cast<float*>(acts);
  p.dh_out = dh_out, p.dcfin = dcfin, p.dxs = dxs, p.dchk = dchk;
  p.dh_carry = dh_carry, p.dc_carry = dc_carry, p.part = part;
  p.T = T, p.B = B, p.D = D;
  const void* kerns[kMaxNtw] = {
      reinterpret_cast<const void*>(lstm_bwd_kernel<1>),
      reinterpret_cast<const void*>(lstm_bwd_kernel<2>),
      reinterpret_cast<const void*>(lstm_bwd_kernel<3>),
      reinterpret_cast<const void*>(lstm_bwd_kernel<4>),
      reinterpret_cast<const void*>(lstm_bwd_kernel<5>)};
  const int rc = static_cast<int>(coop_launch(kerns[D / 128 - 1], bwd_smem(D), p, st));
  if (rc != 0) return rc;
  return dwr(hs, dxs, dwr_out, T, B, D, st);
}
