// Flash-attention forward for Hopper (sm_90a), plain C interface: two
// entry points over four kernel families: for f32 q the split-key decode
// kernel (A, Tq = 1) and the register-tiled tile kernel (B, Tq > 1) with
// their merge; a scalar template (f32 rows that are not 16-byte aligned,
// bf16 rows that are not, and the ring's partial merge); and a
// tensor-core loop (bf16).
//
// flash_attention_fwd replaces the TPU kernel #1 of
// bigdl_tpu/ops/attention_kernels.py: _fwd_impl / _flash_fwd_kernel (the
// Pallas blockwise online-softmax forward, pallas_call :264).  It computes
// exactly what that kernel computes:
//
//   s   = (q . k) * scale            dot in f32 (bf16 products are exact
//                                    in f32), scale applied AFTER the dot
//   s  += bias                       optional, upcast to f32, read through
//                                    its strides (stride 0 = broadcast)
//   s   = -1e9 where key > row + off optional causal mask; it REPLACES the
//                                    score (the reference's _NEG_INF)
//   p   = softmax over the keys; P is cast to v's dtype before P.V
//         (matters for bf16 V)
//   out = P.V in q's dtype;  lse = m + log(l) in f32 [B*H, Tq]
//
// A key beyond Tk contributes nothing (it is skipped, not given -1e9),
// so any Tq >= 1 and Tk >= 1 work.  A row whose every real key sits at
// -1e9 stays uniform over the real keys, as the plain version makes it.
//
// A row's result depends only on that row, its keys and its bias, bit
// for bit: not on how many rows share the launch, nor on keys that the
// bias masks (a masked key adds exactly 0 to every sum, and a split whose
// keys are all masked is folded in with the weight exp(-1e9 - m) = 0).
// Every tile and split starts at a fixed key position counted from 0 and
// is merged in key order.  That keeps rows served from a slot pool equal
// to a solo generate(), and a bf16-cache row equal to a CPU engine's.
//
// ---- f32 q: kernels A and B (serving, f32 training forwards) ----------
//
// They replace, for f32 q, the scalar template of the first port (one
// block per 16-row query tile walking 32-key tiles in series, single
// 4-byte loads between two barriers, a scalar Q.K loop over D with ~1.25
// shared loads per FMA, and every one of the 16 rows computed at Tq = 1).
// What bounds them on an H100: the pooled decode (S16 H8 Tq1 Tk512 D64)
// reads 16.8 MB of f32 K/V (8.4 MB in bf16) for 0.5 flop a byte, so it is
// bound by device-memory bytes (10 us in f32); a 128-wide chunk over 512
// keys does ~46 flops a byte and is bound by the f32 rate of the CUDA
// cores (2 us), where a block of 4 warps gets only 1/132 of the card.
//
// Kernel A, flash_decode_kernel<TKV, D> (Tq = 1): grid (B*H, splits),
// the keys cut at fixed positions into splits of kSplitKeys, so a
// one-request decode still spreads over 4 blocks a head.  A block streams
// its split's K and V rows into shared memory by 16-byte cp.async copies
// in two groups (K, then V, which lands while Q.K runs); thread j owns key
// j: Q.K from 16-byte reads of a padded K row, the split's max and sum by
// warp butterflies then in warp order, P.V with each warp over a quarter
// of the keys and each lane over D/32 columns, the four warps' sums added
// in warp order.  f32: each split writes (acc, m, l), and
// flash_merge_kernel folds the splits in key order (m' = max(m, m_s),
// l = l e^(m - m') + l_s e^(m_s - m'), acc likewise), out = acc / l; one
// split writes out itself.
//
// Kernel B, flash_tile_kernel<TKV, D> (Tq > 1): a block owns 32 query
// rows of one (b, h), 8 a warp; 64-key K/V tiles stream through two
// cp.async stages of 16-byte copies.  Each lane owns 8 rows x 2 keys of S
// (Q read as broadcast float4s, K as 16-byte vectors of two padded rows:
// 6.4 FMAs a shared load in f32, 7.1 with bf16 K) and 8 rows x D/32
// columns of the accumulator (P as float4s over 4 keys: 5.3 FMAs a load
// at D64); warps whose rows all lie past Tq skip the work.  Each tile is
// its own softmax (its m_t, l_t and acc_t = P_t.V_t) folded into the
// row's state in key order by the merge's own expression, so when
// B*H*(query blocks) is below the SM count the wrapper spreads the tiles
// over blocks (grid z), each writing its tile's state, and the same
// merge folds them: the same bits either way.
//
// The mixed entry (kv_bf16): a bf16 KV cache under the f32 LM (the
// reference serves dtype=bfloat16 caches).  K/V are read as bf16 and
// widened exactly; q, out and lse stay f32.  It rounds where xla_attention
// (the reference's CPU path, and its Tq = 1 decode on any device) and
// plain_attention round: the NORMALISED softmax weights to v's dtype,
// P.V summed in f32.  So the row's m and l must be known before any P is
// rounded, yet K is read once and Q.K computed once: the first pass
// keeps the scores (f32, [B*H, Tq, Tk], a scratch that stays in L2 at
// the serving shapes) and the tiles' (m, l); the row's (m, l) are folded
// from them in key order; the second pass reads V with the scores and
// forms P = exp(s - m) / l rounded to bf16.  The normalised partial sums
// of the splits are added in key order.  A one-split decode does both
// passes in one block with the scores in shared memory; a longer one
// keeps them in the scratch (pass 0 on the split grid), and pass 2, a
// block a row, walks the splits in key order with four V splits in
// flight (kPvStages) and the next split's scores read ahead.  The tile
// kernel does both passes in one block, or, where it spreads its tiles,
// pass 1 (scores, (m, l)), pass 2 (a tile's normalised P.V) and the
// merge (their sum).
//
// Rows that do not start on 16 bytes, or whose D is not a multiple of 4
// (f32) or 8 (bf16 K/V), are not taken by A and B: the wrapper routes
// them to the scalar template (attention_kernels.fwd_kernel), and the
// entry refuses them.
//
// ---- the scalar template (flash_fwd_kernel) ---------------------------
//
// Tiles are FIXED (16 query rows, 32 keys) and key tiles always start at
// position 0.  Work split: grid (B*H, ceil(Tq/16)), 4 warps per block, 4
// query rows per warp.  The TPU's sequential k grid axis becomes the loop
// over K/V tiles in shared memory.  Each lane owns one key of the tile
// for Q.K^T and 32-strided head-dim columns for P.V.  With f32 q and
// bf16 K/V (unaligned rows of the mixed entry) it sweeps the keys twice:
// m and l first, then P normalised, rounded, and P.V.

// flash_attention_partial replaces the TPU kernel #5, the ring-attention
// step flash_attention_partial / _flash_partial_kernel (pallas_call
// :674): the same loop over one VISITING K/V chunk, merged into a carried
// f32 state instead of finished.  It differs from #1 in three places:
//   - (acc, m, l) start from the caller's state (acc_in, m_in, l_in), not
//     from (0, -inf, 0); the ring's fresh state is (0, -1e9, 0);
//   - the causal mask is on GLOBAL positions, q_offset + i >= k_offset + j,
//     which is #1's mask with causal_offset = q_offset - k_offset; a chunk
//     wholly above the diagonal merges nothing (the state passes through);
//   - no epilogue: acc, m and l are written back in f32 (the caller takes
//     acc / l and m + log l after the last chunk).
// No bias (the ring routes a biased call to its plain path).  On an H100
// the ring's chunk pairs (B8 H8 Tc512 D64) do 8 flops per byte of q, k, v
// and state and are bound by operations.  For f32 (and bf16 rows that are
// not 16-byte aligned) the answer is #1's, the scalar template: K/V read
// once per 16-row query tile, no score matrix in device memory, tiles
// above the diagonal skipped.
//
// For bf16 (the LM and sequence-parallel training paths) #1 and #5 run on
// the tensor cores instead: flash_fwd_tc_kernel<kPartial, D>, the
// FlashAttention-2 forward loop on mma.sync.m16n8k16 (tensor_core.cuh says
// why not wgmma yet).  A block of 4 warps owns 64 query rows of one (b,
// h), 16 per warp, with their Q fragments loaded once through ldmatrix and
// kept in registers; 64-key tiles of K and V stream through two cp.async
// stages (zeros beyond Tk and D; D padded to 32, 64 or 128).  Per tile
// each warp forms S = Q . K^T into f32 fragments, scales it, adds #1's
// f32 bias (through its strides; a float2 where the key stride is 1),
// masks it as the scalar kernel does (-1e9 replaces a score the causal
// mask hides, -inf excludes a key beyond Tk), takes row maxima and sums by
// quad shuffles (l from the unrounded P; P = exp2((s - m) log2(e)), which
// costs fewer instructions than expf), casts P to bf16 rounding to
// nearest (the reference's cast to v's dtype) straight from the S
// fragments into A fragments, and adds P . V (V through ldmatrix.trans)
// to acc in the C fragments.  #1 starts from (-inf, 0, 0) and ends with
// out = acc / l rounded to bf16 and lse = m + log l; #5 starts from
// acc_in, m_in, l_in and writes the state back, each element read and
// written by the one thread that owns its fragment slot (m and l by the
// first lane of a quad), so its outputs may alias its inputs.  Tiles are
// fixed and keys start at 0 here too, so a row's result depends on that
// row alone.  The query blocks launch heaviest first (the last rows of a
// causal mask see the most keys), so the long blocks do not trail the
// grid.  The wrapper routes a call here only when the head dim is a
// multiple of 8 and every row of q, k and v starts on 16 bytes; the entry
// points refuse it otherwise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "tensor_core.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kBlockQ = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kBlockK = 32;                     // keys per tile: one per lane
constexpr float kMaskedScore = -1e9f;           // the reference's _NEG_INF

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;  // nullptr when absent
  void* out;          // [B, H, Tq, D] contiguous: q's dtype (#1), f32 acc (#5)
  float* lse;         // [B*H, Tq] contiguous: lse (#1), m (#5)
  float* l_out;       // [B*H, Tq] contiguous, #5 only
  const float* acc_in;  // #5 only: the carried state, f32, contiguous
  const float* m_in;
  const float* l_in;
  // kernels A and B only: the splits' states [rows, parts] (m, l) and
  // [rows, parts, D] (acc), rows = B*H*Tq, and the mixed entry's scores
  // [B*H, Tq, Tk]; carved from the wrapper's scratch
  float* part_m;
  float* part_l;
  float* part_acc;
  float* scores;
  int B, H, Tq, Tk, D;
  long long q_sb, q_sh, q_st;  // element strides; the head-dim stride is 1
  long long k_sb, k_sh, k_st;
  long long v_sb, v_sh, v_st;
  long long b_sb, b_sh, b_sq, b_sk;  // bias strides, 0 on broadcast dims
  float scale;
  int causal;
  int causal_offset;  // key j is visible to row i when j <= i + offset
  int bias_pairs;     // #1's bias: key stride 1, float2 loads aligned
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// xor butterflies: every lane ends with the same bits
__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// T is q's (and out's) element type, TKV k's and v's.  They differ in
// one case only, the mixed entry (f32 q, bf16 K/V: a bf16 KV cache under
// the f32 model), which sweeps the keys twice: the first sweep finds the
// row's max m and sum l, the second forms P = exp(s - m) / l, rounds the
// NORMALISED P to bf16 and adds P.V in f32, the rounding points of
// xla_attention (which rounds the softmax weights to v's dtype) and of
// plain_attention.  One sweep otherwise, P rounded
// unnormalised at the running max, as #1 and #5 always had it.
template <typename T, typename TKV, int DMAX, bool kPartial>
__global__ void __launch_bounds__(kWarps * 32)
    flash_fwd_kernel(const Params p) {
  constexpr bool kMixed = !std::is_same<T, TKV>::value;
  static_assert(!(kMixed && kPartial), "#5 takes q, k, v of one dtype");
  constexpr int kCols = DMAX / 32;  // head-dim columns per lane in P.V
  __shared__ float qs[kBlockQ][DMAX];
  __shared__ float ks[kBlockK][DMAX + 1];  // +1: lane-per-key reads hit
                                           // distinct banks
  __shared__ float vs[kBlockK][DMAX];

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int q0 = blockIdx.y * kBlockQ;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int r0 = warp * kRowsPerWarp;

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const TKV* k = static_cast<const TKV*>(p.k) + b * p.k_sb + h * p.k_sh;
  const TKV* v = static_cast<const TKV*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* bias =
      p.bias == nullptr ? nullptr : p.bias + b * p.b_sb + h * p.b_sh;

  for (int i = tid; i < kBlockQ * DMAX; i += blockDim.x) {
    const int r = i / DMAX, c = i % DMAX, t = q0 + r;
    qs[r][c] = (t < p.Tq && c < p.D) ? to_f32(q[t * p.q_st + c]) : 0.f;
  }

  int n_tiles = (p.Tk + kBlockK - 1) / kBlockK;
  if (kPartial && p.causal &&
      (long long)p.Tq - 1 + p.causal_offset < 0) {
    n_tiles = 0;  // no row of the chunk sees a key: the state passes through
  } else if (p.causal && q0 + p.causal_offset >= 0) {
    // skip key tiles wholly above the diagonal of the block's last row.
    // Only when every row of the block sees at least key 0: a row that
    // sees no key is uniform over ALL keys, so no tile may be dropped.
    const long long last_key =
        (long long)min(q0 + kBlockQ, p.Tq) - 1 + p.causal_offset;
    n_tiles = (int)min((long long)n_tiles, last_key / kBlockK + 1);
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kCols];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int t = q0 + r0 + r;
    const long long row = (long long)bh * p.Tq + t;
    const bool carried = kPartial && t < p.Tq;
    m[r] = carried ? p.m_in[row] : (kPartial ? kMaskedScore : -INFINITY);
    l[r] = carried ? p.l_in[row] : 0.f;
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      const int c = lane + 32 * i;
      acc[r][i] = carried && c < p.D ? p.acc_in[row * p.D + c] : 0.f;
    }
  }

  // the mixed entry's first sweep (sweep 0) reads K alone for m and l
  for (int sweep = kMixed ? 0 : 1; sweep < 2; ++sweep)
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * kBlockK;
    const bool with_v = sweep == 1;
    __syncthreads();  // the previous tile's reads are done
    for (int i = tid; i < kBlockK * DMAX; i += blockDim.x) {
      const int j = i / DMAX, c = i % DMAX, t = k0 + j;
      const bool ok = t < p.Tk && c < p.D;
      ks[j][c] = ok ? to_f32(k[t * p.k_st + c]) : 0.f;
      if (with_v) vs[j][c] = ok ? to_f32(v[t * p.v_st + c]) : 0.f;
    }
    __syncthreads();

    float s[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = 0.f;
    for (int c = 0; c < p.D; ++c) {
      const float kc = ks[lane][c];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r)
        s[r] = fmaf(qs[r0 + r][c], kc, s[r]);
    }

    const int key = k0 + lane;
    const bool key_ok = key < p.Tk;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int t = q0 + r0 + r;
      float x = s[r] * p.scale;
      if (key_ok && t < p.Tq) {
        if (bias != nullptr) x += bias[t * p.b_sq + key * p.b_sk];
        if (p.causal && key > t + p.causal_offset) x = kMaskedScore;
      }
      if (!key_ok) x = -INFINITY;  // excluded from the max and the sums
      float pv;
      if (kMixed && with_v) {
        // m and l are the row's: the normalised P in v's dtype
        const float pu = key_ok ? expf(x - m[r]) : 0.f;
        pv = to_f32(from_f32<TKV>(pu / l[r]));
      } else {
        const float m_new = fmaxf(m[r], warp_max(x));  // finite: key k0
        const float pr = key_ok ? expf(x - m_new) : 0.f;
        const float alpha = expf(m[r] - m_new);
        l[r] = l[r] * alpha + warp_sum(pr);
        m[r] = m_new;
        if (kMixed) continue;  // the first sweep: m and l only
        pv = to_f32(from_f32<TKV>(pr));  // P in v's dtype
#pragma unroll
        for (int i = 0; i < kCols; ++i) acc[r][i] *= alpha;
      }
      for (int j = 0; j < kBlockK; ++j) {
        const float pj = __shfl_sync(0xffffffffu, pv, j);
#pragma unroll
        for (int i = 0; i < kCols; ++i)
          acc[r][i] = fmaf(pj, vs[j][lane + 32 * i], acc[r][i]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int t = q0 + r0 + r;
    if (t >= p.Tq) continue;  // uniform across the warp
    const long long row = (long long)bh * p.Tq + t;
    if constexpr (kPartial) {
      float* acc_out = static_cast<float*>(p.out);
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        const int c = lane + 32 * i;
        if (c < p.D) acc_out[row * p.D + c] = acc[r][i];
      }
      if (lane == 0) {
        p.lse[row] = m[r];
        p.l_out[row] = l[r];
      }
    } else {
      T* out = static_cast<T*>(p.out);
      // the mixed entry's P is normalised already
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        const int c = lane + 32 * i;
        if (c < p.D)
          out[row * p.D + c] =
              from_f32<T>(kMixed ? acc[r][i] : acc[r][i] / l[r]);
      }
      if (lane == 0) p.lse[row] = m[r] + logf(l[r]);
    }
  }
}

// ---- #1 and #5 on the tensor cores (bf16) ----------------------------------

constexpr int kTcWarps = 4;
constexpr int kTcRows = kTcWarps * 16;  // query rows per block, 16 per warp
constexpr int kTcKeys = 64;             // keys per K/V tile
constexpr int kTcStages = 2;
constexpr float kLog2e = 1.4426950408889634f;  // exp(x) = exp2(x log2(e))

template <int DMAX>
struct FwdTc {
  static constexpr int kLd = DMAX + 8;  // padded row: ldmatrix hits 8 banks
  static constexpr size_t kSmem =
      (size_t)(kTcRows + 2 * kTcStages * kTcKeys) * kLd *
      sizeof(__nv_bfloat16);
};

// rows [r0, r0 + n) of a [T, D] bf16 operand (row stride st, contiguous
// columns) into shared rows of DMAX + 8, zeros beyond T and D, by 16-byte
// cp.async copies
template <int DMAX>
__device__ __forceinline__ void load_rows_async(__nv_bfloat16* dst,
                                                const __nv_bfloat16* src,
                                                long long st, int r0, int n,
                                                int T, int D) {
  constexpr int kLd = FwdTc<DMAX>::kLd, kChunks = DMAX / 8;
  for (int i = threadIdx.x; i < n * kChunks; i += kTcWarps * 32) {
    const int r = i / kChunks, c = (i % kChunks) * 8, t = r0 + r;
    const bool inside = t < T && c < D;
    tc::cp_async16(dst + r * kLd + c, inside ? src + t * st + c : src,
                   inside);
  }
}

// #1's f32 bias of row `row` at keys key and key + 1 (zeros beyond Tq and
// Tk): one float2 where the key stride is 1 and the pair is 8-byte
// aligned, else two loads through the strides
__device__ __forceinline__ float2 bias_pair(const Params& p,
                                            const float* bias, int row,
                                            int key) {
  float2 add = make_float2(0.f, 0.f);
  if (row >= p.Tq) return add;
  const float* br = bias + row * p.b_sq;
  if (p.bias_pairs && key + 1 < p.Tk)
    return *reinterpret_cast<const float2*>(br + key);
  if (key < p.Tk) add.x = br[key * p.b_sk];
  if (key + 1 < p.Tk) add.y = br[(key + 1) * p.b_sk];
  return add;
}

// One (b, h) and 64 query rows: the online softmax over 64-key tiles on
// mma.sync.  #5 (kPartial) starts from the carried state and writes it
// back; #1 starts from (m, l, acc) = (-inf, 0, 0), adds the optional f32
// bias after the scale and before the mask, and ends with out = acc / l
// in bf16 and lse = m + log l.
template <bool kPartial, int DMAX>
__global__ void __launch_bounds__(kTcWarps * 32)
    flash_fwd_tc_kernel(const Params p) {
  using bf16 = __nv_bfloat16;
  constexpr int kLd = FwdTc<DMAX>::kLd;
  constexpr int kDk = DMAX / 16;     // 16-deep steps of Q . K^T
  constexpr int kDn = DMAX / 8;      // n8 tiles of acc
  constexpr int kKn = kTcKeys / 8;   // n8 tiles of S
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [kTcRows][kLd]
  bf16* ks = qs + kTcRows * kLd;                 // [kTcStages][kTcKeys][kLd]
  bf16* vs = ks + kTcStages * kTcKeys * kLd;     // [kTcStages][kTcKeys][kLd]

  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  // the last query blocks first: under a causal mask they see the most keys
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTcRows;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t4 = lane % 4;
  const int r_lo = q0 + warp * 16 + g;  // this thread's rows r_lo, r_lo + 8

  const bf16* q = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* bias = kPartial || p.bias == nullptr
                          ? nullptr
                          : p.bias + b * p.b_sb + h * p.b_sh;

  // the scalar kernel's rule at 64-row blocks: a chunk no row sees passes
  // #5's state through; key tiles wholly above the diagonal of the block's
  // last row are skipped only when every row of the block sees key 0 (a
  // row that sees no key is uniform over ALL keys), that is when its
  // first row does
  int n_tiles = (p.Tk + kTcKeys - 1) / kTcKeys;
  if (kPartial && p.causal && (long long)p.Tq - 1 + p.causal_offset < 0) {
    n_tiles = 0;
  } else if (p.causal && q0 + p.causal_offset >= 0) {
    const long long last_key =
        (long long)min(q0 + kTcRows, p.Tq) - 1 + p.causal_offset;
    n_tiles = (int)min((long long)n_tiles, last_key / kTcKeys + 1);
  }

  auto load_kv = [&](int stage, int tile) {
    load_rows_async<DMAX>(ks + stage * kTcKeys * kLd, k, p.k_st,
                          tile * kTcKeys, kTcKeys, p.Tk, p.D);
    load_rows_async<DMAX>(vs + stage * kTcKeys * kLd, v, p.v_st,
                          tile * kTcKeys, kTcKeys, p.Tk, p.D);
  };
  load_rows_async<DMAX>(qs, q, p.q_st, q0, kTcRows, p.Tq, p.D);
  if (n_tiles > 0) load_kv(0, 0);
  tc::cp_async_commit();

  // the state in C fragments: acc (rows g, g + 8 of the warp's 16,
  // columns 2 t4, 2 t4 + 1 of each n8 tile), m and l of the two rows
  float m[2], l[2], acc[kDn][4];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int t = r_lo + hh * 8;
    const long long row = (long long)bh * p.Tq + t;
    float mv = kPartial ? kMaskedScore : -INFINITY, lv = 0.f;
    if (kPartial && t4 == 0 && t < p.Tq) {
      mv = p.m_in[row];
      lv = p.l_in[row];
    }
    m[hh] = __shfl_sync(0xffffffffu, mv, lane & ~3);
    l[hh] = __shfl_sync(0xffffffffu, lv, lane & ~3);
#pragma unroll
    for (int j = 0; j < kDn; ++j) {
      const int c = j * 8 + 2 * t4;
      float2 a = make_float2(0.f, 0.f);
      if (kPartial && t < p.Tq && c < p.D)
        a = *reinterpret_cast<const float2*>(p.acc_in + row * p.D + c);
      acc[j][2 * hh] = a.x;
      acc[j][2 * hh + 1] = a.y;
    }
  }

  tc::cp_async_wait<0>();
  __syncthreads();
  uint32_t qa[kDk][4];  // this warp's 16 rows of Q, kept for every tile
#pragma unroll
  for (int kd = 0; kd < kDk; ++kd)
    tc::ldmatrix_x4(qa[kd],
                    qs + (warp * 16 + lane % 16) * kLd + kd * 16 +
                        (lane / 16) * 8);

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int stage = tile & 1;
    if (tile + 1 < n_tiles) load_kv(stage ^ 1, tile + 1);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();  // this tile's copies have landed
    __syncthreads();
    const bf16* kt = ks + stage * kTcKeys * kLd;
    const bf16* vt = vs + stage * kTcKeys * kLd;

    // S = Q . K^T: 16 rows x 64 keys per warp, f32
    float s[kKn][4];
#pragma unroll
    for (int j = 0; j < kKn; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < kDk; ++kd)
#pragma unroll
      for (int np = 0; np < kKn / 2; ++np) {
        uint32_t kb[4];
        tc::ldmatrix_x4(kb, kt + (np * 16 + lane % 8 + (lane / 16) * 8) * kLd +
                                kd * 16 + ((lane / 8) % 2) * 8);
        tc::mma_bf16(s[2 * np], qa[kd], kb[0], kb[1]);
        tc::mma_bf16(s[2 * np + 1], qa[kd], kb[2], kb[3]);
      }

    // the scale after the dot, then #1's bias
    const int k0 = tile * kTcKeys;
#pragma unroll
    for (int j = 0; j < kKn; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        if (bias != nullptr) {
          const float2 add =
              bias_pair(p, bias, r_lo + hh * 8, k0 + j * 8 + 2 * t4);
          s[j][2 * hh] = s[j][2 * hh] * p.scale + add.x;
          s[j][2 * hh + 1] = s[j][2 * hh + 1] * p.scale + add.y;
        } else {
          s[j][2 * hh] *= p.scale;
          s[j][2 * hh + 1] *= p.scale;
        }
      }

    // the masks and the rows' maxima; a tile whose every key every row of
    // the block sees skips the tests
    const bool open_tile =
        k0 + kTcKeys <= p.Tk &&
        (!p.causal || k0 + kTcKeys - 1 <= q0 + p.causal_offset);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kKn; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e];
        if (!open_tile) {
          const int key = k0 + j * 8 + 2 * t4 + (e % 2);
          if (p.causal && key > r_lo + (e / 2) * 8 + p.causal_offset)
            x = kMaskedScore;
          if (key >= p.Tk) x = -INFINITY;  // excluded from the max and sums
        }
        s[j][e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      const float m_new = fmaxf(m[hh], mx[hh]);  // finite: key k0 exists
      alpha[hh] = exp2f((m[hh] - m_new) * kLog2e);
      m[hh] = m_new;
    }
#pragma unroll
    for (int j = 0; j < kKn; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // 0 beyond Tk
        const float pr = exp2f((s[j][e] - m[e / 2]) * kLog2e);
        s[j][e] = pr;
        rs[e / 2] += pr;
      }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      rs[hh] += __shfl_xor_sync(0xffffffffu, rs[hh], 1);
      rs[hh] += __shfl_xor_sync(0xffffffffu, rs[hh], 2);
      l[hh] = l[hh] * alpha[hh] + rs[hh];  // l from the unrounded P
    }
#pragma unroll
    for (int j = 0; j < kDn; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= alpha[e / 2];

    // P cast to v's dtype (bf16, to nearest), packed as A fragments
    uint32_t pf[kKn][2];
#pragma unroll
    for (int j = 0; j < kKn; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        pf[j][hh] = tc::pack_bf16(s[j][2 * hh], s[j][2 * hh + 1]);

    // acc += P . V, V through ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < kTcKeys / 16; ++kk) {
      const uint32_t pa[4] = {pf[2 * kk][0], pf[2 * kk][1],
                              pf[2 * kk + 1][0], pf[2 * kk + 1][1]};
#pragma unroll
      for (int dn = 0; dn < kDn / 2; ++dn) {
        uint32_t vb[4];
        tc::ldmatrix_x4_trans(
            vb, vt + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * kLd +
                    dn * 16 + (lane / 16) * 8);
        tc::mma_bf16(acc[2 * dn], pa, vb[0], vb[1]);
        tc::mma_bf16(acc[2 * dn + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage
  }
  tc::cp_async_wait<0>();

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int t = r_lo + hh * 8;
    if (t >= p.Tq) continue;
    const long long row = (long long)bh * p.Tq + t;
#pragma unroll
    for (int j = 0; j < kDn; ++j) {
      const int c = j * 8 + 2 * t4;
      if (c >= p.D) continue;
      if constexpr (kPartial)
        *reinterpret_cast<float2*>(static_cast<float*>(p.out) + row * p.D +
                                   c) =
            make_float2(acc[j][2 * hh], acc[j][2 * hh + 1]);
      else  // #1's epilogue: acc / l in q's dtype
        *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(p.out) +
                                           row * p.D + c) =
            __floats2bfloat162_rn(acc[j][2 * hh] / l[hh],
                                  acc[j][2 * hh + 1] / l[hh]);
    }
    if (t4 == 0) {
      if constexpr (kPartial) {
        p.lse[row] = m[hh];
        p.l_out[row] = l[hh];
      } else {
        p.lse[row] = m[hh] + logf(l[hh]);
      }
    }
  }
}

template <bool kPartial, int DMAX>
int launch_tc(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = FwdTc<DMAX>::kSmem;
  if (smem > 48 * 1024) {  // above 48 KB only as opted-in dynamic memory
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_tc_kernel<kPartial, DMAX>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(p.B * p.H, (p.Tq + kTcRows - 1) / kTcRows);
  flash_fwd_tc_kernel<kPartial, DMAX>
      <<<grid, kTcWarps * 32, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// whether every row of q, k and v starts on 16 bytes (head dim contiguous,
// a multiple of 8 bf16 values), as the tensor-core route's copies need
bool rows_aligned(const Params& p) {
  const long long strides[9] = {p.q_sb, p.q_sh, p.q_st, p.k_sb, p.k_sh,
                                p.k_st, p.v_sb, p.v_sh, p.v_st};
  for (long long st : strides)
    if (st % 8 != 0) return false;
  return p.D % 8 == 0 && (uintptr_t)p.q % 16 == 0 &&
         (uintptr_t)p.k % 16 == 0 && (uintptr_t)p.v % 16 == 0;
}

template <bool kPartial>
int launch_tc_for_dim(const Params& p, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!rows_aligned(p)) return (int)cudaErrorInvalidValue;
  if (p.D <= 32) return launch_tc<kPartial, 32>(p, s);
  if (p.D <= 64) return launch_tc<kPartial, 64>(p, s);
  if (p.D <= 128) return launch_tc<kPartial, 128>(p, s);
  return (int)cudaErrorInvalidValue;
}

template <typename T, typename TKV, int DMAX, bool kPartial>
int launch(const Params& p, cudaStream_t stream) {
  const dim3 grid(p.B * p.H, (p.Tq + kBlockQ - 1) / kBlockQ);
  flash_fwd_kernel<T, TKV, DMAX, kPartial>
      <<<grid, kWarps * 32, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, typename TKV, bool kPartial>
int launch_for_dim(const Params& p, cudaStream_t stream) {
  if (p.D <= 32) return launch<T, TKV, 32, kPartial>(p, stream);
  if (p.D <= 64) return launch<T, TKV, 64, kPartial>(p, stream);
  if (p.D <= 128) return launch<T, TKV, 128, kPartial>(p, stream);
  return (int)cudaErrorInvalidValue;
}

template <bool kPartial>
int launch_for_type(int is_bf16, const Params& p, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16
             ? launch_for_dim<__nv_bfloat16, __nv_bfloat16, kPartial>(p, s)
             : launch_for_dim<float, float, kPartial>(p, s);
}

// ---- #1 for f32 q: kernel A (decode), kernel B (tile) and their merge ----

constexpr int kDecThreads = 128;           // kernel A: 4 warps a block
constexpr int kDecWarps = kDecThreads / 32;
constexpr int kSplitKeys = 128;            // kernel A: keys a split
constexpr int kTileWarps = 4;              // kernel B: 4 warps a block,
constexpr int kTileRowsW = 8;              // 8 query rows a warp
constexpr int kTileRows = kTileWarps * kTileRowsW;
constexpr int kTileKeys = 64;              // kernel B: keys a tile, 2 a lane
constexpr int kMergeWarps = 4;             // the merge: a row a warp

// the kernel selector of the C entry (attention_kernels.FWD_KERNELS)
enum FwdKernel { kScalarTemplate = 0, kTensorCore = 1, kDecode = 2, kTile = 3 };

// 16 bytes of shared memory widened to f32: 4 floats, or 8 bf16 (exact)
__device__ __forceinline__ void load16(const float* src, float (&x)[4]) {
  const float4 w = *reinterpret_cast<const float4*>(src);
  x[0] = w.x;
  x[1] = w.y;
  x[2] = w.z;
  x[3] = w.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* src,
                                       float (&x)[8]) {
  const uint4 w = *reinterpret_cast<const uint4*>(src);
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(u[i] << 16);
    x[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

// kC adjacent values of a shared V row widened to f32 (kC = 1, 2 or 4)
template <int kC>
__device__ __forceinline__ void load_cols(const float* src, float (&x)[kC]) {
  if constexpr (kC == 4) {
    load16(src, x);
  } else if constexpr (kC == 2) {
    const float2 w = *reinterpret_cast<const float2*>(src);
    x[0] = w.x;
    x[1] = w.y;
  } else {
    x[0] = src[0];
  }
}
template <int kC>
__device__ __forceinline__ void load_cols(const __nv_bfloat16* src,
                                          float (&x)[kC]) {
  if constexpr (kC == 4) {
    const uint2 w = *reinterpret_cast<const uint2*>(src);
    x[0] = __uint_as_float(w.x << 16);
    x[1] = __uint_as_float(w.x & 0xffff0000u);
    x[2] = __uint_as_float(w.y << 16);
    x[3] = __uint_as_float(w.y & 0xffff0000u);
  } else if constexpr (kC == 2) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(src);
    x[0] = __uint_as_float(w << 16);
    x[1] = __uint_as_float(w & 0xffff0000u);
  } else {
    x[0] = __bfloat162float(src[0]);
  }
}

// rows [r0, r0 + n) of a [T, D] operand (row stride st, contiguous
// columns) into shared rows of ld elements, zeros beyond T and D, by
// 16-byte cp.async copies (D a multiple of 16 bytes)
template <typename T, int DMAX>
__device__ __forceinline__ void copy_rows(T* dst, int ld, const T* src,
                                          long long st, int r0, int n,
                                          int rows, int D, int threads) {
  constexpr int kVec = 16 / sizeof(T), kChunks = DMAX / kVec;
  for (int i = threadIdx.x; i < n * kChunks; i += threads) {
    const int r = i / kChunks, c = (i % kChunks) * kVec, t = r0 + r;
    const bool inside = t < rows && c < D;
    tc::cp_async16(dst + r * ld + c, inside ? src + t * st + c : src,
                   inside);
  }
}

// One fold step in key order: the weights a of the state so far and bb
// of the next tile's or split's, under the new max mn.  The merge and
// kernel B's in-block fold share it, and write l and acc by the same
// expressions (fmaf(x_s, bb, x * a)), so a row folded in one block and a
// row folded by the merge have the same bits.  A split whose keys are all
// masked folds in with bb = exp(-1e9 - m) = 0, a tile skipped above the
// diagonal (m -inf, l 0, acc 0) with bb = 0: both add exactly nothing.
__device__ __forceinline__ void fold_scale(float m, float ms, float& mn,
                                           float& a, float& bb) {
  mn = fmaxf(m, ms);
  a = expf(m - mn);
  bb = expf(ms - mn);
}

// the score of one key: the dot scaled after it, the f32 bias (read
// ahead, 0 without one) added, -1e9 in place of a causally masked score
// (t: the row, key: the key)
__device__ __forceinline__ float masked_score(const Params& p, float bias,
                                              float dot, int t, int key) {
  float x = __fmul_rn(dot, p.scale);
  if (p.bias != nullptr) x = __fadd_rn(x, bias);
  if (p.causal && key > t + p.causal_offset) x = kMaskedScore;
  return x;
}

// the (m, l) of one row folded from its n parts in key order, by
// fold_scale as the merge folds them; the parts read 8 at a time
__device__ __forceinline__ void fold_row(const float* pm, const float* pl,
                                         int n, float& m, float& l) {
  for (int s0 = 0; s0 < n; s0 += 8) {
    float ms[8], ls[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      ms[u] = s0 + u < n ? pm[s0 + u] : 0.f;
      ls[u] = s0 + u < n ? pl[s0 + u] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (s0 + u >= n) break;
      if (s0 + u == 0) {
        m = ms[u];
        l = ls[u];
        continue;
      }
      float mn, a, bb;
      fold_scale(m, ms[u], mn, a, bb);
      l = fmaf(ls[u], bb, __fmul_rn(l, a));
      m = mn;
    }
  }
}

// kernel A's rounding point for the mixed entry: P normalised by the
// row's l first, then rounded to v's dtype (bf16)
__device__ __forceinline__ float decode_p(float x, float m, float l) {
  return __bfloat162float(__float2bfloat16_rn(expf(x - m) / l));
}

constexpr int kPvStages = 4;  // kernel A's pass 2: V splits in flight

template <typename TKV, int DMAX>
struct DecSmem {
  static constexpr int kVec = 16 / sizeof(TKV);
  static constexpr int kLdK = DMAX + kVec;  // +16 bytes: thread j reads
                                            // row j conflict-free
  static constexpr size_t kK = (size_t)kSplitKeys * kLdK * sizeof(TKV);
  static constexpr size_t kV = (size_t)kSplitKeys * DMAX * sizeof(TKV);
  static constexpr size_t kBytes = kK + kV;             // pass 0
  static constexpr size_t kPvBytes = kPvStages * kV;    // pass 2
};

// P.V of one split, P in ps and V's rows in vs: warp w sums its quarter
// of the keys in order, each lane D/32 adjacent columns; the warps' sums
// are added in warp order.  Thread c < DMAX returns column c.
template <typename TKV, int DMAX>
__device__ __forceinline__ float split_pv(const TKV* vs, const float* ps,
                                          float (*red)[DMAX]) {
  constexpr int kC = DMAX / 32, kPerWarp = kSplitKeys / kDecWarps;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float acc[kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) acc[c] = 0.f;
#pragma unroll 4
  for (int j = warp * kPerWarp; j < (warp + 1) * kPerWarp; ++j) {
    const float pj = ps[j];
    float vv[kC];
    load_cols<kC>(vs + j * DMAX + lane * kC, vv);
#pragma unroll
    for (int c = 0; c < kC; ++c) acc[c] = fmaf(pj, vv[c], acc[c]);
  }
#pragma unroll
  for (int c = 0; c < kC; ++c) red[warp][lane * kC + c] = acc[c];
  __syncthreads();
  const int t = threadIdx.x;
  if (t >= DMAX) return 0.f;
  float sum = red[0][t];
#pragma unroll
  for (int w = 1; w < kDecWarps; ++w) sum = __fadd_rn(sum, red[w][t]);
  return sum;
}

constexpr int kDecKeys = (kSplitKeys + kDecThreads - 1) / kDecThreads;

// Kernel A.  pass 0, grid (B*H, splits): one split of one (b, h) row at
// Tq = 1: its scores; f32: its (acc, m, l), or out and lse where the row
// has one split; mixed: the scores and (m, l) to the scratch, or (one
// split) P normalised and P.V here.  pass 2 (mixed, after pass 0), grid
// (B*H): the row's (m, l) folded from the splits', then split by split in
// key order (V through two cp.async stages) P from the kept scores and
// the normalised P.V, the splits' sums added in key order; out and lse.
template <typename TKV, int DMAX>
__global__ void __launch_bounds__(kDecThreads)
    flash_decode_kernel(const Params p, const int pass) {
  constexpr bool kMixed = std::is_same<TKV, __nv_bfloat16>::value;
  constexpr int kVec = 16 / sizeof(TKV);
  using S = DecSmem<TKV, DMAX>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TKV* ks = reinterpret_cast<TKV*>(smem_raw);            // [split][kLdK]
  TKV* vs = reinterpret_cast<TKV*>(smem_raw + S::kK);    // [split][DMAX]
  __shared__ __align__(16) float qs[DMAX];
  __shared__ float ps[kSplitKeys];  // the scores, then P
  __shared__ float red[kDecWarps][DMAX];
  __shared__ float stat[2][kDecWarps];
  __shared__ float row_ml[2];

  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const TKV* k = static_cast<const TKV*>(p.k) + b * p.k_sb + h * p.k_sh;
  const TKV* v = static_cast<const TKV*>(p.v) + b * p.v_sb + h * p.v_sh;
  float* out = static_cast<float*>(p.out);

  if (pass == 2) {
    // the row's splits in key order, V through kPvStages stages, one
    // cp.async group a split (empty past the last)
    const int n_split = (p.Tk + kSplitKeys - 1) / kSplitKeys;
    auto stage = [&](int sp) {
      return reinterpret_cast<TKV*>(smem_raw + (sp % kPvStages) * S::kV);
    };
    for (int sp = 0; sp < kPvStages; ++sp) {
      if (sp < n_split)
        copy_rows<TKV, DMAX>(stage(sp), DMAX, v, p.v_st, sp * kSplitKeys,
                             kSplitKeys, p.Tk, p.D, kDecThreads);
      tc::cp_async_commit();
    }
    // this thread's kept scores of a split, read a split ahead
    const float* row_scores = p.scores + (long long)bh * p.Tk;
    float sc[kDecKeys];
    auto read_scores = [&](int sp) {
#pragma unroll
      for (int i = 0; i < kDecKeys; ++i) {
        const int key = sp * kSplitKeys + tid + i * kDecThreads;
        sc[i] = tid + i * kDecThreads < kSplitKeys && key < p.Tk
                    ? row_scores[key]
                    : 0.f;
      }
    };
    read_scores(0);
    if (tid == 0) {
      fold_row(p.part_m + (long long)bh * n_split,
               p.part_l + (long long)bh * n_split, n_split, row_ml[0],
               row_ml[1]);
    }
    __syncthreads();
    const float m = row_ml[0], l = row_ml[1];
    float acc = 0.f;
    for (int sp = 0; sp < n_split; ++sp) {
      const int k0 = sp * kSplitKeys;
#pragma unroll
      for (int i = 0; i < kDecKeys; ++i) {
        const int j = tid + i * kDecThreads;
        if (j < kSplitKeys)
          ps[j] = k0 + j < p.Tk ? decode_p(sc[i], m, l) : 0.f;
      }
      if (sp + 1 < n_split) read_scores(sp + 1);
      tc::cp_async_wait<kPvStages - 1>();  // this split's V has landed
      __syncthreads();
      const float col = split_pv<TKV, DMAX>(stage(sp), ps, red);
      acc = sp == 0 ? col : __fadd_rn(acc, col);
      __syncthreads();  // ps, red and the stage are free again
      if (sp + kPvStages < n_split)
        copy_rows<TKV, DMAX>(stage(sp), DMAX, v, p.v_st,
                             k0 + kPvStages * kSplitKeys, kSplitKeys, p.Tk,
                             p.D, kDecThreads);
      tc::cp_async_commit();
    }
    tc::cp_async_wait<0>();
    if (tid < p.D) out[(long long)bh * p.D + tid] = acc;
    if (tid == 0) p.lse[bh] = m + logf(l);
    return;
  }

  const int split = blockIdx.y, n_split = gridDim.y;
  const int k0 = split * kSplitKeys;
  const int n = min(kSplitKeys, p.Tk - k0);
  const bool whole = n_split == 1;
  const long long part = (long long)bh * n_split + split;  // row bh
  // two cp.async groups: K first, then V, which lands while Q.K runs
  copy_rows<TKV, DMAX>(ks, S::kLdK, k, p.k_st, k0, kSplitKeys, p.Tk, p.D,
                       kDecThreads);
  tc::cp_async_commit();
  if (!kMixed || whole)
    copy_rows<TKV, DMAX>(vs, DMAX, v, p.v_st, k0, kSplitKeys, p.Tk, p.D,
                         kDecThreads);
  tc::cp_async_commit();
  // q and the bias read while the copies fly
  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  for (int c = tid; c < DMAX; c += kDecThreads) qs[c] = c < p.D ? q[c] : 0.f;
  float bj[kDecKeys];
#pragma unroll
  for (int i = 0; i < kDecKeys; ++i) {
    const int j = tid + i * kDecThreads;
    bj[i] = p.bias != nullptr && j < n
                ? p.bias[b * p.b_sb + h * p.b_sh + (long long)(k0 + j) * p.b_sk]
                : 0.f;
  }
  tc::cp_async_wait<1>();  // K has landed
  __syncthreads();

  float mx = -INFINITY;
#pragma unroll
  for (int i = 0; i < kDecKeys; ++i) {
    const int j = tid + i * kDecThreads;
    if (j >= kSplitKeys) break;
    float x = -INFINITY;  // beyond Tk: out of the max and the sums
    if (j < n) {
      const TKV* kr = ks + j * S::kLdK;
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < DMAX; d += kVec) {
        float kv[kVec], qv[kVec];
        load16(kr + d, kv);
#pragma unroll
        for (int e = 0; e < kVec; e += 4) {
          float q4[4];
          load16(qs + d + e, q4);
#pragma unroll
          for (int u = 0; u < 4; ++u) qv[e + u] = q4[u];
        }
#pragma unroll
        for (int e = 0; e < kVec; ++e) dot = fmaf(qv[e], kv[e], dot);
      }
      x = masked_score(p, bj[i], dot, 0, k0 + j);
    }
    ps[j] = x;
    mx = fmaxf(mx, x);
  }
  // the split's max, then its sum of exp(x - max), by warp butterflies
  // and in warp order
  mx = warp_max(mx);
  if (lane == 0) stat[0][warp] = mx;
  __syncthreads();
  mx = stat[0][0];
#pragma unroll
  for (int w = 1; w < kDecWarps; ++w) mx = fmaxf(mx, stat[0][w]);
  float sum = 0.f;
  for (int j = tid; j < kSplitKeys; j += kDecThreads) {
    const float e = j < n ? expf(ps[j] - mx) : 0.f;
    if (!kMixed) ps[j] = e;  // the f32 route's P, unrounded
    sum = __fadd_rn(sum, e);
  }
  sum = warp_sum(sum);
  if (lane == 0) stat[1][warp] = sum;
  __syncthreads();
  float ls = stat[1][0];
#pragma unroll
  for (int w = 1; w < kDecWarps; ++w) ls = __fadd_rn(ls, stat[1][w]);

  if constexpr (!kMixed) {
    tc::cp_async_wait<0>();
    __syncthreads();  // V has landed; every P is in ps
    const float col = split_pv<TKV, DMAX>(vs, ps, red);
    if (whole) {
      if (tid < p.D) out[(long long)bh * p.D + tid] = col / ls;
      if (tid == 0) p.lse[bh] = mx + logf(ls);
    } else {
      if (tid < p.D) p.part_acc[part * p.D + tid] = col;
      if (tid == 0) {
        p.part_m[part] = mx;
        p.part_l[part] = ls;
      }
    }
    return;
  }
  if (!whole) {  // mixed: the scores and the split's (m, l) are kept
    for (int j = tid; j < n; j += kDecThreads)
      p.scores[(long long)bh * p.Tk + k0 + j] = ps[j];
    if (tid == 0) {
      p.part_m[part] = mx;
      p.part_l[part] = ls;
    }
    return;
  }
  // mixed, one split: the row's (m, l) are the split's
  for (int j = tid; j < kSplitKeys; j += kDecThreads)
    ps[j] = j < n ? decode_p(ps[j], mx, ls) : 0.f;
  tc::cp_async_wait<0>();
  __syncthreads();
  const float col = split_pv<TKV, DMAX>(vs, ps, red);
  if (tid < p.D) out[(long long)bh * p.D + tid] = col;
  if (tid == 0) p.lse[bh] = mx + logf(ls);
}

// The merge of kernels A (f32) and B: row by row, the parts (splits or
// tiles) folded in key order, 8 read at a time.  f32: out = acc / l from
// the folded (acc, m, l); mixed (normalised partial sums): out = their
// sum in key order, lse from the folded (m, l).
template <int DMAX>
__global__ void __launch_bounds__(kMergeWarps * 32)
    flash_merge_kernel(const Params p, const int rows, const int n,
                       const int mixed) {
  constexpr int kC = DMAX / 32;
  const long long row = (long long)blockIdx.x * kMergeWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const float* pm = p.part_m + row * n;
  const float* pl = p.part_l + row * n;
  const float* pa = p.part_acc + row * n * p.D;
  float m = 0.f, l = 0.f, acc[kC];
  for (int s0 = 0; s0 < n; s0 += 8) {
    float ms[8], ls[8], xs[8][kC];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int s = s0 + u;
      ms[u] = s < n ? pm[s] : 0.f;
      ls[u] = s < n ? pl[s] : 0.f;
#pragma unroll
      for (int i = 0; i < kC; ++i) {
        const int c = lane + 32 * i;
        xs[u][i] = s < n && c < p.D ? pa[(long long)s * p.D + c] : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (s0 + u >= n) break;
      if (s0 + u == 0) {
        m = ms[u];
        l = ls[u];
#pragma unroll
        for (int i = 0; i < kC; ++i) acc[i] = xs[u][i];
        continue;
      }
      float mn, a, bb;
      fold_scale(m, ms[u], mn, a, bb);
      l = fmaf(ls[u], bb, __fmul_rn(l, a));
#pragma unroll
      for (int i = 0; i < kC; ++i) {
        if (mixed)
          acc[i] = __fadd_rn(acc[i], xs[u][i]);  // normalised already
        else
          acc[i] = fmaf(xs[u][i], bb, __fmul_rn(acc[i], a));
      }
      m = mn;
    }
  }
  float* out = static_cast<float*>(p.out);
#pragma unroll
  for (int i = 0; i < kC; ++i) {
    const int c = lane + 32 * i;
    if (c < p.D) out[row * p.D + c] = mixed ? acc[i] : acc[i] / l;
  }
  if (lane == 0) p.lse[row] = m + logf(l);
}

// kernel B's rounding point for the mixed entry: the row's P normalised
// by its l first, then rounded to v's dtype (bf16)
__device__ __forceinline__ float tile_p(float s, float m_row, float l_row) {
  return __bfloat162float(__float2bfloat16_rn(expf(s - m_row) / l_row));
}

template <typename TKV, int DMAX>
struct TileSmem {
  static constexpr int kVec = 16 / sizeof(TKV);
  static constexpr int kLdQ = DMAX + 4;          // f32
  static constexpr int kLdK = DMAX + kVec;       // +16 bytes: lane j reads
                                                 // row j conflict-free
  static constexpr int kLdP = kTileKeys + 4;     // f32
  static constexpr size_t kQ = (size_t)kTileRows * kLdQ * 4;
  static constexpr size_t kK = (size_t)kTileKeys * kLdK * sizeof(TKV);
  static constexpr size_t kV = (size_t)kTileKeys * DMAX * sizeof(TKV);
  static constexpr size_t kP = (size_t)kTileRows * kLdP * 4;
  // P, Q, then the K/V stages: two where a block walks its tiles, one
  // where it takes a single tile (then more blocks share an SM)
  static constexpr size_t kStage = kK + kV;
  static constexpr size_t kBytes = kP + kQ + 2 * kStage;
  static constexpr size_t kOneTileBytes = kP + kQ + kStage;
};

// Kernel B: 32 query rows of one (b, h).  pass 0: every tile of the rows
// in this block (f32: scores, the tile's softmax and P.V folded in key
// order, then out and lse; mixed: the scores kept and (m, l) folded in a
// sweep over K, then P normalised, rounded, and P.V in a sweep over V).
// pass 1: tile blockIdx.z alone, its state to the scratch (f32: (acc, m,
// l); mixed: the scores and (m, l)); pass 2 (mixed, after pass 1): the
// rows' (m, l) folded from the tiles', tile blockIdx.z's normalised P.V to
// the scratch.  The merge folds the tiles' states.
template <typename TKV, int DMAX>
__global__ void __launch_bounds__(kTileWarps * 32)
    flash_tile_kernel(const Params p, const int pass) {
  constexpr bool kMixed = std::is_same<TKV, __nv_bfloat16>::value;
  constexpr int kVec = 16 / sizeof(TKV);
  constexpr int kC = DMAX / 32;
  constexpr int kR = kTileRowsW;
  using S = TileSmem<TKV, DMAX>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ps = reinterpret_cast<float*>(smem_raw);              // [32][kLdP]
  float* qs = reinterpret_cast<float*>(smem_raw + S::kP);       // [32][kLdQ]
  // stage s: K [64][kLdK] at stage_k(s), V [64][DMAX] after it
  auto stage_k = [&](int st) {
    return reinterpret_cast<TKV*>(smem_raw + S::kP + S::kQ + st * S::kStage);
  };
  auto stage_v = [&](int st) {
    return reinterpret_cast<TKV*>(smem_raw + S::kP + S::kQ + st * S::kStage +
                                  S::kK);
  };

  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.y * kTileRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * kR;  // the warp's rows q0 + r0 ... q0 + r0 + 7
  const bool live = q0 + r0 < p.Tq;
  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const TKV* k = static_cast<const TKV*>(p.k) + b * p.k_sb + h * p.k_sh;
  const TKV* v = static_cast<const TKV*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* bias =
      p.bias == nullptr ? nullptr : p.bias + b * p.b_sb + h * p.b_sh;
  float* scores = kMixed ? p.scores + (long long)bh * p.Tq * p.Tk : nullptr;

  // key tiles wholly above the diagonal of the block's last row are
  // skipped only when every row of the block sees key 0 and no bias can
  // mask it: a row that sees no key is uniform over ALL keys
  const int n_all = (p.Tk + kTileKeys - 1) / kTileKeys;
  int n_tiles = n_all;
  if (p.causal && bias == nullptr && q0 + p.causal_offset >= 0) {
    const long long last_key =
        (long long)min(q0 + kTileRows, p.Tq) - 1 + p.causal_offset;
    n_tiles = (int)min((long long)n_tiles, last_key / kTileKeys + 1);
  }
  const int t_begin = pass == 0 ? 0 : (int)blockIdx.z;
  const int t_end = pass == 0 ? n_tiles : min(t_begin + 1, n_tiles);

  // the rows' state; a tile skipped above the diagonal keeps it (-inf, 0,
  // 0), which folds in as nothing
  float m[kR], l[kR], acc[kR][kC];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kC; ++c) acc[r][c] = 0.f;
  }
  if (pass == 2) {
    // the rows' (m, l) folded from every tile's in key order, as the merge
    // folds them
    float mr = 0.f, lr = 1.f;
    const int t = q0 + r0 + lane;
    if (lane < kR && t < p.Tq) {
      const long long row = (long long)bh * p.Tq + t;
      fold_row(p.part_m + row * n_all, p.part_l + row * n_all, n_all, mr,
               lr);
    }
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      m[r] = __shfl_sync(0xffffffffu, mr, r);
      l[r] = __shfl_sync(0xffffffffu, lr, r);
    }
  } else {
    copy_rows<float, DMAX>(qs, S::kLdQ, q, p.q_st, q0, kTileRows, p.Tq,
                           p.D, kTileWarps * 32);
  }

  // sweep 0 over K (and, for f32, V): the scores and the tiles' softmax;
  // sweep 1 (mixed) over V: P normalised, rounded, and P.V
  const int sweep_end = kMixed && pass != 1 ? 2 : 1;
  for (int sweep = pass == 2 ? 1 : 0; sweep < sweep_end; ++sweep) {
    const bool with_k = sweep == 0, with_v = !kMixed || sweep == 1;
    auto load = [&](int stage, int tile) {
      if (with_k)
        copy_rows<TKV, DMAX>(stage_k(stage), S::kLdK, k,
                             p.k_st, tile * kTileKeys, kTileKeys, p.Tk, p.D,
                             kTileWarps * 32);
      if (with_v)
        copy_rows<TKV, DMAX>(stage_v(stage), DMAX, v, p.v_st,
                             tile * kTileKeys, kTileKeys, p.Tk, p.D,
                             kTileWarps * 32);
    };
    if (t_begin < t_end) load(0, t_begin);
    tc::cp_async_commit();
    for (int tile = t_begin; tile < t_end; ++tile) {
      const int stage = (tile - t_begin) & 1;
      if (tile + 1 < t_end) load(stage ^ 1, tile + 1);
      tc::cp_async_commit();
      const int k0 = tile * kTileKeys;
      // the tile's bias (sweep 0) or kept scores (sweep 1), read while the
      // copies land
      float ahead[kR][2];
#pragma unroll
      for (int r = 0; r < kR; ++r)
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const int t = q0 + r0 + r, key = k0 + lane + 32 * kk;
          const bool in = live && t < p.Tq && key < p.Tk;
          ahead[r][kk] =
              !in ? 0.f
              : sweep == 1
                  ? scores[(long long)t * p.Tk + key]
                  : bias != nullptr
                        ? bias[(long long)t * p.b_sq + (long long)key * p.b_sk]
                        : 0.f;
        }
      tc::cp_async_wait<1>();  // this tile's copies have landed
      __syncthreads();
      const TKV* kt = stage_k(stage);
      const TKV* vt = stage_v(stage);
      float* pw = ps + r0 * S::kLdP;  // the warp's rows of P
      const bool first = tile == t_begin;
      if (live) {
        float fa[kR], fb[kR];  // the fold's weights of the state, the tile
        if (sweep == 0) {
          // S = Q . K^T: 8 rows x keys lane, lane + 32, each a chain of
          // FMAs over d in order
          float s[kR][2];
#pragma unroll
          for (int r = 0; r < kR; ++r) s[r][0] = s[r][1] = 0.f;
#pragma unroll
          for (int d = 0; d < DMAX; d += kVec) {
            float k0v[kVec], k1v[kVec];
            load16(kt + lane * S::kLdK + d, k0v);
            load16(kt + (lane + 32) * S::kLdK + d, k1v);
#pragma unroll
            for (int r = 0; r < kR; ++r) {
#pragma unroll
              for (int e = 0; e < kVec; e += 4) {
                float q4[4];
                load16(qs + (r0 + r) * S::kLdQ + d + e, q4);
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                  s[r][0] = fmaf(q4[i], k0v[e + i], s[r][0]);
                  s[r][1] = fmaf(q4[i], k1v[e + i], s[r][1]);
                }
              }
            }
          }
#pragma unroll
          for (int r = 0; r < kR; ++r) {
            const int t = q0 + r0 + r;
            float x[2];
#pragma unroll
            for (int kk = 0; kk < 2; ++kk) {
              const int key = k0 + lane + 32 * kk;
              x[kk] = key >= p.Tk ? -INFINITY
                      : t < p.Tq
                          ? masked_score(p, ahead[r][kk], s[r][kk], t, key)
                          : 0.f;
              if (kMixed && t < p.Tq && key < p.Tk)
                scores[(long long)t * p.Tk + key] = x[kk];
            }
            const float mt = warp_max(fmaxf(x[0], x[1]));
            const float e0 = k0 + lane < p.Tk ? expf(x[0] - mt) : 0.f;
            const float e1 = k0 + lane + 32 < p.Tk ? expf(x[1] - mt) : 0.f;
            const float lt = warp_sum(__fadd_rn(e0, e1));
            if (!kMixed) {
              pw[r * S::kLdP + lane] = e0;
              pw[r * S::kLdP + lane + 32] = e1;
            }
            if (first) {
              m[r] = mt;
              l[r] = lt;
              fa[r] = 0.f;
              fb[r] = 1.f;
            } else {
              float mn;
              fold_scale(m[r], mt, mn, fa[r], fb[r]);
              l[r] = fmaf(lt, fb[r], __fmul_rn(l[r], fa[r]));
              m[r] = mn;
            }
          }
        } else {
          // P normalised by the row's (m, l), then rounded, from the kept
          // scores
#pragma unroll
          for (int r = 0; r < kR; ++r) {
#pragma unroll
            for (int kk = 0; kk < 2; ++kk) {
              const int key = k0 + lane + 32 * kk;
              pw[r * S::kLdP + lane + 32 * kk] =
                  key < p.Tk ? tile_p(ahead[r][kk], m[r], l[r]) : 0.f;
            }
          }
        }
        if (with_v) {
          // acc_t = P . V: 8 rows x D/32 columns a lane, keys in order
          __syncwarp();
          float at[kR][kC];
#pragma unroll
          for (int r = 0; r < kR; ++r)
#pragma unroll
            for (int c = 0; c < kC; ++c) at[r][c] = 0.f;
#pragma unroll 2
          for (int j = 0; j < kTileKeys; j += 4) {
            float pr[kR][4];
#pragma unroll
            for (int r = 0; r < kR; ++r) load16(pw + r * S::kLdP + j, pr[r]);
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              float vv[kC];
              load_cols<kC>(vt + (j + jj) * DMAX + lane * kC, vv);
#pragma unroll
              for (int r = 0; r < kR; ++r)
#pragma unroll
                for (int c = 0; c < kC; ++c)
                  at[r][c] = fmaf(pr[r][jj], vv[c], at[r][c]);
            }
          }
#pragma unroll
          for (int r = 0; r < kR; ++r)
#pragma unroll
            for (int c = 0; c < kC; ++c) {
              if (first)
                acc[r][c] = at[r][c];
              else if (kMixed)
                acc[r][c] = __fadd_rn(acc[r][c], at[r][c]);
              else
                acc[r][c] = fmaf(at[r][c], fb[r], __fmul_rn(acc[r][c], fa[r]));
            }
        }
      }
      __syncthreads();  // every warp is done with this stage
    }
    tc::cp_async_wait<0>();
  }

  if (!live) return;
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int t = q0 + r0 + r;
    if (t >= p.Tq) continue;  // uniform across the warp
    const long long row = (long long)bh * p.Tq + t;
    if (pass == 0) {
      float* out = static_cast<float*>(p.out);
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const int col = lane * kC + c;
        if (col < p.D)
          out[row * p.D + col] = kMixed ? acc[r][c] : acc[r][c] / l[r];
      }
      if (lane == 0) p.lse[row] = m[r] + logf(l[r]);
      continue;
    }
    const long long part = row * n_all + blockIdx.z;
    if (pass == 1 && lane == 0) {
      p.part_m[part] = m[r];
      p.part_l[part] = l[r];
    }
    if (!kMixed || pass == 2) {
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const int col = lane * kC + c;
        if (col < p.D) p.part_acc[part * p.D + col] = acc[r][c];
      }
    }
  }
}

template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;  // above 48 KB only as opted-in memory
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

#define RETURN_ON_LAUNCH_ERROR()                     \
  do {                                               \
    const cudaError_t e_ = cudaGetLastError();       \
    if (e_ != cudaSuccess) return (int)e_;           \
  } while (0)

template <int DMAX>
int launch_merge(const Params& p, int rows, int n, bool mixed,
                 cudaStream_t s) {
  flash_merge_kernel<DMAX>
      <<<(rows + kMergeWarps - 1) / kMergeWarps, kMergeWarps * 32, 0, s>>>(
          p, rows, n, mixed);
  RETURN_ON_LAUNCH_ERROR();
  return 0;
}

template <typename TKV, int DMAX>
int launch_decode(const Params& p, int n, cudaStream_t s) {
  constexpr bool kMixed = std::is_same<TKV, __nv_bfloat16>::value;
  using S = DecSmem<TKV, DMAX>;
  constexpr size_t smem = S::kBytes;
  const int e = allow_smem(flash_decode_kernel<TKV, DMAX>,
                           kMixed ? std::max(S::kBytes, S::kPvBytes)
                                  : S::kBytes);
  if (e != 0) return e;
  const dim3 grid(p.B * p.H, n);
  flash_decode_kernel<TKV, DMAX><<<grid, kDecThreads, smem, s>>>(p, 0);
  RETURN_ON_LAUNCH_ERROR();
  if (n == 1) return 0;
  if (kMixed) {  // pass 2 adds the splits' sums itself
    flash_decode_kernel<TKV, DMAX>
        <<<p.B * p.H, kDecThreads, S::kPvBytes, s>>>(p, 2);
    RETURN_ON_LAUNCH_ERROR();
    return 0;
  }
  return launch_merge<DMAX>(p, p.B * p.H, n, false, s);
}

template <typename TKV, int DMAX>
int launch_tile(const Params& p, int n, bool parts, cudaStream_t s) {
  constexpr bool kMixed = std::is_same<TKV, __nv_bfloat16>::value;
  using S = TileSmem<TKV, DMAX>;
  const size_t smem = parts ? S::kOneTileBytes : S::kBytes;
  const int e = allow_smem(flash_tile_kernel<TKV, DMAX>, S::kBytes);
  if (e != 0) return e;
  const dim3 grid(p.B * p.H, (p.Tq + kTileRows - 1) / kTileRows,
                  parts ? n : 1);
  flash_tile_kernel<TKV, DMAX>
      <<<grid, kTileWarps * 32, smem, s>>>(p, parts ? 1 : 0);
  RETURN_ON_LAUNCH_ERROR();
  if (!parts) return 0;
  if (kMixed) {
    flash_tile_kernel<TKV, DMAX><<<grid, kTileWarps * 32, smem, s>>>(p, 2);
    RETURN_ON_LAUNCH_ERROR();
  }
  return launch_merge<DMAX>(p, p.B * p.H * p.Tq, n, kMixed, s);
}

// whether every row of the f32 q and the K/V (f32, or bf16 with kv_bf16)
// starts on 16 bytes, as kernels A and B copy them
bool f32_rows_aligned(const Params& p, int kv_bf16) {
  const long long kv = kv_bf16 ? 8 : 4;  // elements in 16 bytes
  const long long qst[3] = {p.q_sb, p.q_sh, p.q_st};
  const long long kvst[6] = {p.k_sb, p.k_sh, p.k_st, p.v_sb, p.v_sh, p.v_st};
  for (long long st : qst)
    if (st % 4 != 0) return false;
  for (long long st : kvst)
    if (st % kv != 0) return false;
  return p.D % kv == 0 && (uintptr_t)p.q % 16 == 0 &&
         (uintptr_t)p.k % 16 == 0 && (uintptr_t)p.v % 16 == 0;
}

// Kernels A and B: check the call, carve the scratch and launch.  The
// scratch holds, when the row's parts are merged, [rows, n] m and l and
// [rows, n, D] acc, then the mixed entry's scores [B*H, Tq, Tk] where
// they are kept in device memory.
template <typename TKV>
int launch_f32(Params p, int kernel, int split, float* scratch,
               long long scratch_floats, cudaStream_t s) {
  if (!f32_rows_aligned(p, std::is_same<TKV, __nv_bfloat16>::value) ||
      (kernel == kDecode && p.Tq != 1) || p.D > 128)
    return (int)cudaErrorInvalidValue;
  constexpr bool kMixed = std::is_same<TKV, __nv_bfloat16>::value;
  const int n = kernel == kDecode ? (p.Tk + kSplitKeys - 1) / kSplitKeys
                                  : (p.Tk + kTileKeys - 1) / kTileKeys;
  const bool parts = kernel == kDecode ? n > 1 : split != 0;
  const long long rows = (long long)p.B * p.H * p.Tq;
  const bool keep_scores = kMixed && (kernel == kTile || parts);
  const long long need = (parts ? rows * n * (p.D + 2) : 0) +
                         (keep_scores ? rows * p.Tk : 0);
  if (need > scratch_floats || (need > 0 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  float* f = scratch;
  if (parts) {
    p.part_m = f;
    p.part_l = f + rows * n;
    p.part_acc = f + 2 * rows * n;
    f += rows * n * (p.D + 2);
  }
  if (keep_scores) p.scores = f;
  if (kernel == kDecode) {
    if (p.D <= 32) return launch_decode<TKV, 32>(p, n, s);
    if (p.D <= 64) return launch_decode<TKV, 64>(p, n, s);
    return launch_decode<TKV, 128>(p, n, s);
  }
  if (p.D <= 32) return launch_tile<TKV, 32>(p, n, parts, s);
  if (p.D <= 64) return launch_tile<TKV, 64>(p, n, parts, s);
  return launch_tile<TKV, 128>(p, n, parts, s);
}

}  // namespace

// Kernel #1.  Returns cudaGetLastError() after the launches (0 =
// launched).  The caller checks shapes, dtypes and strides before
// calling.  `kernel` picks the kernel (FwdKernel): the scalar template;
// the tensor cores (bf16 q, k, v: flash_fwd_tc_kernel<false, D>, an
// error unless D % 8 == 0 and every row starts on 16 bytes); kernel A
// (f32 q, Tq = 1) or kernel B (f32 q), each an error unless every row
// starts on 16 bytes.  kv_bf16 set is the mixed entry: f32 q with bf16 k
// and v, f32 out and lse (the scalar template in two sweeps, or A or B).
// For A and B the wrapper passes `scratch` of `scratch_floats` f32
// values (attention_kernels.fwd_scratch; an error if it is short) and,
// for B, `split` set to spread the key tiles over blocks.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, const void* bias, void* out,
    void* lse, void* scratch, int is_bf16, int kernel, int kv_bf16,
    int split, int B, int H, int Tq, int Tk, int D,
    long long q_sb, long long q_sh, long long q_st, long long k_sb,
    long long k_sh, long long k_st, long long v_sb, long long v_sh,
    long long v_st, long long b_sb, long long b_sh, long long b_sq,
    long long b_sk, long long scratch_floats, float scale, int causal,
    int causal_offset, void* stream) {
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.bias = static_cast<const float*>(bias);
  p.out = out;
  p.lse = static_cast<float*>(lse);
  p.B = B;
  p.H = H;
  p.Tq = Tq;
  p.Tk = Tk;
  p.D = D;
  p.q_sb = q_sb;
  p.q_sh = q_sh;
  p.q_st = q_st;
  p.k_sb = k_sb;
  p.k_sh = k_sh;
  p.k_st = k_st;
  p.v_sb = v_sb;
  p.v_sh = v_sh;
  p.v_st = v_st;
  p.b_sb = b_sb;
  p.b_sh = b_sh;
  p.b_sq = b_sq;
  p.b_sk = b_sk;
  p.scale = scale;
  p.causal = causal;
  p.causal_offset = causal_offset;
  p.bias_pairs = b_sk == 1 && b_sq % 2 == 0 && b_sb % 2 == 0 &&
                 b_sh % 2 == 0 && (uintptr_t)bias % 8 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kernel) {
    case kScalarTemplate:
      if (!kv_bf16) return launch_for_type<false>(is_bf16, p, stream);
      if (is_bf16) return (int)cudaErrorInvalidValue;
      return launch_for_dim<float, __nv_bfloat16, false>(p, s);
    case kTensorCore:
      if (!is_bf16 || kv_bf16) return (int)cudaErrorInvalidValue;
      return launch_tc_for_dim<false>(p, stream);
    case kDecode:
    case kTile:
      if (is_bf16) return (int)cudaErrorInvalidValue;
      return kv_bf16
                 ? launch_f32<__nv_bfloat16>(p, kernel, split,
                                             static_cast<float*>(scratch),
                                             scratch_floats, s)
                 : launch_f32<float>(p, kernel, split,
                                     static_cast<float*>(scratch),
                                     scratch_floats, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The fixed positions of kernels A's and B's parts, for the wrapper's
// scratch: what = 0 the keys of a split of A, 1 the keys of a tile of B,
// 2 the query rows of a block of B.
extern "C" int flash_attention_fwd_layout(int what) {
  return what == 0 ? kSplitKeys : what == 1 ? kTileKeys : kTileRows;
}

// Kernel #5: merge one visiting K/V chunk into the carried state.  q is
// [B, H, Tq, D], k and v [B, H, Tk, D] (strided; head dim contiguous);
// acc_in/acc_out [B*H, Tq, D] and m/l [B*H, Tq] are contiguous f32 (the
// outputs may alias the inputs: each element is read and written by one
// thread).  q_offset and k_offset are the chunks' global positions.  bf16
// with tensor_cores set runs flash_fwd_tc_kernel<true, D> (an error unless
// D % 8 == 0 and every row starts on 16 bytes), else the scalar template.
extern "C" int flash_attention_partial(
    const void* q, const void* k, const void* v, const void* acc_in,
    const void* m_in, const void* l_in, void* acc_out, void* m_out,
    void* l_out, int is_bf16, int tensor_cores, int B, int H, int Tq,
    int Tk, int D,
    long long q_sb, long long q_sh, long long q_st, long long k_sb,
    long long k_sh, long long k_st, long long v_sb, long long v_sh,
    long long v_st, float scale, int causal, int q_offset, int k_offset,
    void* stream) {
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = acc_out;
  p.lse = static_cast<float*>(m_out);
  p.l_out = static_cast<float*>(l_out);
  p.acc_in = static_cast<const float*>(acc_in);
  p.m_in = static_cast<const float*>(m_in);
  p.l_in = static_cast<const float*>(l_in);
  p.B = B;
  p.H = H;
  p.Tq = Tq;
  p.Tk = Tk;
  p.D = D;
  p.q_sb = q_sb;
  p.q_sh = q_sh;
  p.q_st = q_st;
  p.k_sb = k_sb;
  p.k_sh = k_sh;
  p.k_st = k_st;
  p.v_sb = v_sb;
  p.v_sh = v_sh;
  p.v_st = v_st;
  p.scale = scale;
  p.causal = causal;
  p.causal_offset = q_offset - k_offset;  // global q >= global k
  if (!tensor_cores) return launch_for_type<true>(is_bf16, p, stream);
  if (!is_bf16) return (int)cudaErrorInvalidValue;
  return launch_tc_for_dim<true>(p, stream);
}
