// Flash-attention forward for Hopper (sm_90a), plain C interface: two
// entry points over two kernel templates, a scalar one (f32, and bf16
// rows that are not 16-byte aligned) and a tensor-core one (bf16).
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
//   p   = online softmax over K/V tiles, carried as (m, l, acc) in
//         registers; P is cast to v's dtype before P.V (matters for bf16)
//   out = acc / l in q's dtype;  lse = m + log(l) in f32 [B*H, Tq]
//
// A key beyond Tk contributes nothing (it is skipped, not given -1e9),
// so any Tq >= 1 and Tk >= 1 work.  A row whose every real key sits at
// -1e9 stays uniform over the real keys, as the plain version makes it.
//
// What bounds it on an H100.  The serving path calls it at two shapes:
// the pooled decode (Tq = 1 over a max_len cache) does ~0.5 flop per
// byte of K/V and is bound by device-memory bytes; a 128-wide prefill
// chunk over a 512-key cache does ~46 flops per byte and is bound by
// the f32 rate of the CUDA cores.  Serving runs f32, on the scalar
// template: one block covers a whole 16-row query tile of one (batch,
// head), so each K/V element is read from device memory once per query
// tile (once per decode step), the bias is read through its strides and
// never materialised per head, and no score matrix is ever written to
// device memory.  The LM training shape (B8 H8 T2048 D64 causal bf16)
// does ~34 GFLOP for 8 MB and is bound by the tensor cores: bf16 with
// 16-byte rows runs flash_fwd_tc_kernel<false, D> (below).
//
// The mixed entry (kv_bf16): a bf16 KV cache under the f32 LM (the
// reference serves dtype=bfloat16 caches).  The scalar template reads K/V
// as bf16 (TKV) and upcasts them exactly; q, out and lse stay f32.  It
// rounds where xla_attention (the reference's CPU path, and its Tq = 1
// decode on any device) and plain_attention round: the NORMALISED softmax
// weights to v's dtype, P.V summed in f32.  So it sweeps the keys twice:
// m and l first (K only), then P = exp(s - m) / l rounded to bf16 and P.V
// (K again, and V).  At the chunk shape (Tq 128) the reference's TPU runs
// its flash kernel instead, which rounds the unnormalised P; there this
// entry follows the CPU path.  The second sweep recomputes Q.K: keeping
// the scores between the sweeps is owed perf work, not a requirement.
//
// Tiles are FIXED (16 query rows, 32 keys) and key tiles always start at
// position 0, so a row's result depends only on that row, its keys and
// its bias: not on how many rows share the launch, nor on keys that the
// bias masks (a masked key adds exactly 0 to every sum).  That keeps
// rows served from a slot pool comparable with a solo generate().
//
// Work split: grid (B*H, ceil(Tq/16)), 4 warps per block, 4 query rows
// per warp.  The TPU's sequential k grid axis becomes the loop over K/V
// tiles in shared memory.  Each lane owns one key of the tile for Q.K^T
// and 32-strided head-dim columns for P.V.
//
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

}  // namespace

// Kernel #1.  Returns cudaGetLastError() after the launch (0 =
// launched).  The caller checks shapes, dtypes and strides before
// calling.  bf16 with tensor_cores set runs flash_fwd_tc_kernel<false, D>
// (an error unless D % 8 == 0 and every row of q, k, v starts on 16
// bytes), else the scalar template.  kv_bf16 set is the mixed entry: f32
// q (is_bf16 and tensor_cores unset, else an error) with bf16 k and v,
// f32 out and lse, on the scalar template in two sweeps.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, const void* bias, void* out,
    void* lse, int is_bf16, int tensor_cores, int kv_bf16, int B, int H,
    int Tq, int Tk, int D,
    long long q_sb, long long q_sh, long long q_st, long long k_sb,
    long long k_sh, long long k_st, long long v_sb, long long v_sh,
    long long v_st, long long b_sb, long long b_sh, long long b_sq,
    long long b_sk, float scale, int causal, int causal_offset,
    void* stream) {
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
  if (kv_bf16) {
    if (is_bf16 || tensor_cores) return (int)cudaErrorInvalidValue;
    return launch_for_dim<float, __nv_bfloat16, false>(
        p, static_cast<cudaStream_t>(stream));
  }
  if (!tensor_cores) return launch_for_type<false>(is_bf16, p, stream);
  if (!is_bf16) return (int)cudaErrorInvalidValue;
  return launch_tc_for_dim<false>(p, stream);
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
