// Flash-attention backward for Hopper (sm_90a), plain C interface: five
// kernels, dQ, dK/dV and dBias, and the ring's partial dQ and dK/dV (all
// but dBias with a tensor-core route for bf16).
//
// Replaces the TPU kernels of bigdl_tpu/ops/attention_kernels.py:
//   flash_attention_dq    <- _bwd_impl / _flash_dq_kernel   (#2, pallas_call :483:
//                          scalar FMAs for f32, the tensor cores for bf16)
//   flash_attention_dkv   <- _bwd_impl / _flash_dkv_kernel  (#3, pallas_call :515:
//                          scalar FMAs for f32, the tensor cores for bf16)
//   flash_attention_dbias <- _dbias_impl / _flash_dbias_kernel (#4, pallas_call :549)
//   flash_attention_dq_partial  <- flash_attention_dq_partial /
//                          _flash_dq_partial_kernel  (#6, pallas_call :787)
//   flash_attention_dkv_partial <- flash_attention_dkv_partial /
//                          _flash_dkv_partial_kernel (#7, pallas_call :829)
// They compute what those kernels compute, from the forward kernel's lse
// and Delta = rowsum(dO * O) (a PyTorch op outside, as _bwd_prep is XLA):
//
//   s   = (q . k) * scale (+ bias)    the forward's score: bit for bit in the
//                                     scalar kernels (the same f32 FMA order
//                                     over the head dim); in the bf16
//                                     tensor-core kernels every product
//                                     of two bf16 values is exact in f32 and
//                                     only the order of the head-dim sum
//                                     differs from kernel #1's
//   s   = -1e9 where key > row + off  causal mask: REPLACES the score
//   P   = exp(s - lse)                recomputed per tile, never stored
//   dP  = dO . v                      f32
//   dS  = P * (dP - Delta)            0 where the causal mask replaced the
//                                     score: the gradient of a replaced
//                                     score is zero, as autograd of the
//                                     plain version's masked_fill gives
//   dQ  = scale * sum_k dS . K        dS cast to K's dtype first
//   dV  = sum_q P^T . dO              P cast to dO's dtype first
//   dK  = scale * sum_q dS^T . Q      dS cast to Q's dtype first
//   dBias tile = dS in f32 [B*H, Tq, Tk]; the fold to the bias's broadcast
//                shape is a torch sum outside (as _dbias_impl :560-570)
//
// The partial kernels (#6, #7) are the dQ and dK/dV kernels over ONE
// visiting chunk of ring attention, with the whole sequence's lse and
// Delta.  They keep the reference's dtype rules, which differ from #2/#3:
//   - dO comes in f32 (the ring passes g in f32), while q, k, v keep their
//     dtype: dP = dO . v is an f32 product;
//   - dS is cast to K's (dQ) and Q's (dK) dtype, as in #2/#3, but P is
//     cast to dO's dtype, f32, before P^T . dO: no rounding there;
//   - dQ, dK and dV are written in f32 (the ring sums them over chunks);
//   - the causal mask is on global positions: causal_offset is
//     q_offset - k_offset; no bias;
//   - a row that sees no key of the chunk is not special: its scores are
//     -1e9, so P = exp(-1e9 - lse) = 0 (its lse, of the whole sequence,
//     is finite), as the reference computes it.  So key (query) tiles that
//     no row of the block sees are skipped for every offset.
// The dtype of dO is a template parameter of the dQ and dK/dV kernels:
// #2/#3 take it as q's, #6/#7 as f32, so "P in dO's dtype" is one line.
//
// Masking is the forward's: a key beyond Tk (a row beyond Tq) is skipped,
// never given -1e9.  A row that the causal mask leaves no key (row + off
// < 0) is uniform over the real keys in the forward, so its P is 1/Tk
// exactly here: exp(s - lse) cannot give it, since lse = -1e9 + log(Tk)
// rounds to -1e9 in f32.  Its dS is 0 (every score replaced).
//
// What bounds them on an H100.  The training shape (B8 H8 T2048 D64 bf16,
// causal) does ~2*D flops per visible (query, key) pair and product:
// three products in dQ, four in dK/dV, 10-20 GFLOP per call for a few MB
// of inputs, so they are bound by operations, not bytes.  These kernels
// run scalar f32 FMAs on the CUDA cores (no tensor cores): the design
// answers what it can without wgmma.  Each block keeps its accumulator
// (dQ of 16 rows; dK, dV of 16 keys) in registers for the whole sweep, so
// nothing but the inputs crosses device memory; the tile it streams sits
// in shared memory with its rows padded by one float, so a lane-per-key
// (or lane-per-query) dot product reads distinct banks; causal tiles that
// no row of the block can see are skipped.  No float atomics: the split of
// the reference (dQ streams K/V, dK/dV streams Q/dO) makes every output
// the sum of one block in a fixed order, so two runs give the same bits.
// The partial kernels' chunk pair (B8 H8 Tc512 D64) is the same kind of
// work, 8x smaller than the whole causal sequence, so the same holds for
// them.
//
// dQ in bf16 (#2 on the LM training path) runs on the tensor cores:
// flash_dq_tc_kernel, the FlashAttention-2 forward loop of #1 turned to dQ
// (the comment above the kernel).  dK/dV in bf16 (#3) runs on the tensor
// cores too: flash_dkv_tc_kernel, the FlashAttention-2 dK/dV structure on
// mma.sync.m16n8k16 (tensor_core.cuh says why not wgmma yet).  A block of
// 4 warps owns 64 keys of one (b, h), 16 per warp, with K and V in shared
// memory; tiles of 32 queries of Q and dO, with their lse
// and Delta, stream through two shared-memory stages by cp.async (16-byte
// copies, zero filled beyond Tq and D; element loads where a stride or D
// is not a multiple of 8).  Per tile each warp forms S^T = K . Q^T and
// dP^T = V . dO^T on the tensor cores into f32 registers, forms P and dS
// from them in registers (p_and_ds's arithmetic, with every step rounded
// as torch rounds the plain version), casts P and
// dS to bf16 as the reference does (dO's and Q's dtype), and adds
// dV += P^T . dO and dK += dS^T . Q with P^T and dS^T taken straight from
// its registers as the A operand.  Query tiles wholly before the block's
// first key are skipped.  f32 inputs keep the scalar flash_dq_kernel and
// flash_dkv_kernel: the entry points flash_attention_dq and
// flash_attention_dkv route by dtype and the wrappers count each route.
//
// The ring's dK/dV (#7) with bf16 q, k, v runs on the tensor cores too:
// flash_dkv_partial_tc_kernel, #3's structure with dO in f32.  Two of its
// four products have an f32 operand (dP = dO . V^T, dV = P^T . dO with P
// in dO's dtype), so each f32 operand goes in as three bf16 pieces whose
// sum is exact, and the products keep f32's precision (the comment above
// the kernel).  The ring's dQ (#6) runs #2's loop with dO in f32 in the
// same way: flash_dq_tc_kernel<D, true>, dP over dO's three pieces.  f32
// q, k, v keep the scalar templates; flash_attention_dq_partial and
// flash_attention_dkv_partial take the route as a flag, which the
// wrappers count.
//
// Work split (fixed tiles; ragged edges masked here):
//   dQ    grid (B*H, ceil(Tq/16)): 4 warps x 4 query rows; loops over
//         32-key tiles, lane = key for s and dP, lane = head-dim column
//         for the dS . K accumulation.
//   dK/dV grid (B*H, ceil(Tk/16)): 4 warps x 4 keys; loops over 32-query
//         tiles, lane = query for s and dP, lane = column for the sums.
//   dQ on the tensor cores (bf16) grid (B*H, ceil(Tq/64)): 4 warps x 16
//         rows; loops over 32-key tiles (64 at D 32), two stages; the
//         ring's dQ the same, with dO's rows split into bf16 pieces in
//         shared memory once they land.
//   dK/dV on the tensor cores (bf16) grid (B*H, ceil(Tk/64)): 4 warps x 16
//         keys; loops over 32-query tiles, two stages.
//   the ring's dK/dV on the tensor cores (bf16) grid (B*H, ceil(Tk/64)):
//         as #3's, with dO's tile split into bf16 pieces in shared memory
//         once it lands.
//   dBias grid (B*H, ceil(Tq/16), ceil(Tk/32)): one 16 x 32 tile each.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "tensor_core.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4;
constexpr int kBlockRows = kWarps * kRowsPerWarp;  // q rows (dQ, dBias) or
                                                   // keys (dK/dV) per block
constexpr int kTile = 32;                          // streamed tile: one per lane
constexpr float kMaskedScore = -1e9f;              // the reference's _NEG_INF

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;  // nullptr when absent
  const void* dout;
  const float* lse;    // [B*H, Tq] contiguous
  const float* delta;  // [B*H, Tq] contiguous
  void* out0;          // dq [B,H,Tq,D] | dk [B,H,Tk,D] | ds f32 [B*H,Tq,Tk]
  void* out1;          // dv [B,H,Tk,D] (dK/dV only)
  int B, H, Tq, Tk, D;
  long long q_sb, q_sh, q_st;  // element strides; the head-dim stride is 1
  long long k_sb, k_sh, k_st;
  long long v_sb, v_sh, v_st;
  long long o_sb, o_sh, o_st;        // dO
  long long b_sb, b_sh, b_sq, b_sk;  // bias strides, 0 on broadcast dims
  float scale;
  int causal;
  int causal_offset;  // key j is visible to row i when j <= i + offset
  int vec;            // 16-byte copies: D, the strides and pointers align
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

// x rounded to T and back: the reference's casts before a product
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// P and dS of one (row, key) pair, both in range, from the raw dot
// q . k and dP = dO . v.  Same arithmetic as the forward's score.  A
// partial kernel has no row that sees no key: its lse is the sequence's.
template <bool kPartial>
__device__ __forceinline__ void p_and_ds(const Params& p, const float* bias,
                                         float dot, float dp, float lse,
                                         float delta, int row, int key,
                                         float* pr, float* ds) {
  if (!kPartial && p.causal && row + p.causal_offset < 0) {  // sees no key
    *pr = 1.f / (float)p.Tk;
    *ds = 0.f;
    return;
  }
  if (p.causal && key > row + p.causal_offset) {  // a replaced score
    *pr = expf(kMaskedScore - lse);
    *ds = 0.f;
    return;
  }
  float x = dot * p.scale;
  if (bias != nullptr) x += bias[row * p.b_sq + key * p.b_sk];
  *pr = expf(x - lse);
  *ds = *pr * (dp - delta);
}

// Row tile [r0, r0 + n) of a [T, D] operand (strided rows, contiguous
// columns) into shared memory as f32, zero beyond T and D.
template <typename T, int LD>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          long long st, int r0, int n, int T_,
                                          int D, int dmax) {
  for (int i = threadIdx.x; i < n * dmax; i += blockDim.x) {
    const int r = i / dmax, c = i % dmax, t = r0 + r;
    dst[r * LD + c] = (t < T_ && c < D) ? to_f32(src[t * st + c]) : 0.f;
  }
}

// ---- dQ ------------------------------------------------------------------

template <int DMAX>
constexpr size_t dq_smem_floats() {
  return 2 * kBlockRows * DMAX + 2 * kTile * (DMAX + 1);
}

// T: q, k, v; TO: dO; the output is T, or f32 for the partial kernel
template <typename T, typename TO, int DMAX, bool kPartial>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(const Params p) {
  using TOut = std::conditional_t<kPartial, float, T>;
  constexpr int kCols = DMAX / 32;
  extern __shared__ float smem[];
  float* qs = smem;                            // [kBlockRows][DMAX]
  float* dos = qs + kBlockRows * DMAX;         // [kBlockRows][DMAX]
  float* ks = dos + kBlockRows * DMAX;         // [kTile][DMAX + 1]
  float* vs = ks + kTile * (DMAX + 1);         // [kTile][DMAX + 1]

  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.y * kBlockRows;
  const int lane = threadIdx.x % 32;
  const int r0 = (threadIdx.x / 32) * kRowsPerWarp;

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const TO* dout = static_cast<const TO*>(p.dout) + b * p.o_sb + h * p.o_sh;
  const float* bias =
      p.bias == nullptr ? nullptr : p.bias + b * p.b_sb + h * p.b_sh;

  load_rows<T, DMAX>(qs, q, p.q_st, q0, kBlockRows, p.Tq, p.D, DMAX);
  load_rows<TO, DMAX>(dos, dout, p.o_st, q0, kBlockRows, p.Tq, p.D, DMAX);

  float lse[kRowsPerWarp], delta[kRowsPerWarp], acc[kRowsPerWarp][kCols];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int t = q0 + r0 + r;
    const long long row = (long long)bh * p.Tq + t;
    lse[r] = t < p.Tq ? p.lse[row] : 0.f;
    delta[r] = t < p.Tq ? p.delta[row] : 0.f;
#pragma unroll
    for (int i = 0; i < kCols; ++i) acc[r][i] = 0.f;
  }

  int n_tiles = (p.Tk + kTile - 1) / kTile;
  if (p.causal && (kPartial || q0 + p.causal_offset >= 0)) {
    // key tiles wholly above the block's last row add dS = 0 (a row with
    // no key at all has dS = 0 everywhere, so it needs no tile either)
    const long long last_key =
        (long long)min(q0 + kBlockRows, p.Tq) - 1 + p.causal_offset;
    n_tiles = last_key < 0
                  ? 0
                  : (int)min((long long)n_tiles, last_key / kTile + 1);
  }

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * kTile;
    __syncthreads();  // the previous tile's reads are done
    load_rows<T, DMAX + 1>(ks, k, p.k_st, k0, kTile, p.Tk, p.D, DMAX);
    load_rows<T, DMAX + 1>(vs, v, p.v_st, k0, kTile, p.Tk, p.D, DMAX);
    __syncthreads();

    float s[kRowsPerWarp], dp[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = dp[r] = 0.f;
    for (int c = 0; c < p.D; ++c) {
      const float kc = ks[lane * (DMAX + 1) + c];
      const float vc = vs[lane * (DMAX + 1) + c];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        s[r] = fmaf(qs[(r0 + r) * DMAX + c], kc, s[r]);
        dp[r] = fmaf(dos[(r0 + r) * DMAX + c], vc, dp[r]);
      }
    }

    const int key = k0 + lane;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int t = q0 + r0 + r;
      float pr = 0.f, ds = 0.f;
      if (key < p.Tk && t < p.Tq)
        p_and_ds<kPartial>(p, bias, s[r], dp[r], lse[r], delta[r], t, key,
                           &pr, &ds);
      const float dsk = round_to<T>(ds);  // dS in K's dtype
      for (int j = 0; j < kTile; ++j) {
        const float dj = __shfl_sync(0xffffffffu, dsk, j);
#pragma unroll
        for (int i = 0; i < kCols; ++i)
          acc[r][i] = fmaf(dj, ks[j * (DMAX + 1) + lane + 32 * i], acc[r][i]);
      }
    }
  }

  TOut* dq = static_cast<TOut*>(p.out0);
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int t = q0 + r0 + r;
    if (t >= p.Tq) continue;  // uniform across the warp
    const long long row = (long long)bh * p.Tq + t;
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      const int c = lane + 32 * i;
      if (c < p.D) dq[row * p.D + c] = from_f32<TOut>(acc[r][i] * p.scale);
    }
  }
}

// ---- dK / dV ---------------------------------------------------------------

template <int DMAX>
constexpr size_t dkv_smem_floats() {
  return 2 * kBlockRows * DMAX + 2 * kTile * (DMAX + 1) + 2 * kTile;
}

template <typename T, typename TO, int DMAX, bool kPartial>
__global__ void __launch_bounds__(kThreads) flash_dkv_kernel(const Params p) {
  using TOut = std::conditional_t<kPartial, float, T>;
  constexpr int kCols = DMAX / 32;
  extern __shared__ float smem[];
  float* ks = smem;                         // [kBlockRows][DMAX]
  float* vs = ks + kBlockRows * DMAX;       // [kBlockRows][DMAX]
  float* qs = vs + kBlockRows * DMAX;       // [kTile][DMAX + 1]
  float* dos = qs + kTile * (DMAX + 1);     // [kTile][DMAX + 1]
  float* lse_s = dos + kTile * (DMAX + 1);  // [kTile]
  float* delta_s = lse_s + kTile;           // [kTile]

  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int k0 = blockIdx.y * kBlockRows;
  const int lane = threadIdx.x % 32;
  const int r0 = (threadIdx.x / 32) * kRowsPerWarp;

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const TO* dout = static_cast<const TO*>(p.dout) + b * p.o_sb + h * p.o_sh;
  const float* bias =
      p.bias == nullptr ? nullptr : p.bias + b * p.b_sb + h * p.b_sh;

  load_rows<T, DMAX>(ks, k, p.k_st, k0, kBlockRows, p.Tk, p.D, DMAX);
  load_rows<T, DMAX>(vs, v, p.v_st, k0, kBlockRows, p.Tk, p.D, DMAX);

  float dk[kRowsPerWarp][kCols], dv[kRowsPerWarp][kCols];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int i = 0; i < kCols; ++i) dk[r][i] = dv[r][i] = 0.f;

  // query tiles that no row can reach the block's keys from are skipped:
  // row i sees key j when i >= j - offset.  Rows that see no key at all
  // (i + offset < 0, only when offset < 0) still weigh every key with
  // 1/Tk in dV, so then every tile is walked; not in a partial kernel,
  // where such a row's P is 0.
  int first = 0;
  if (p.causal && (kPartial || p.causal_offset >= 0))
    first = max(0, k0 - p.causal_offset) / kTile;
  const int n_tiles = (p.Tq + kTile - 1) / kTile;

  for (int tile = first; tile < n_tiles; ++tile) {
    const int i0 = tile * kTile;
    __syncthreads();  // the previous tile's reads are done
    load_rows<T, DMAX + 1>(qs, q, p.q_st, i0, kTile, p.Tq, p.D, DMAX);
    load_rows<TO, DMAX + 1>(dos, dout, p.o_st, i0, kTile, p.Tq, p.D, DMAX);
    if (threadIdx.x < kTile) {
      const int t = i0 + threadIdx.x;
      const long long row = (long long)bh * p.Tq + t;
      lse_s[threadIdx.x] = t < p.Tq ? p.lse[row] : 0.f;
      delta_s[threadIdx.x] = t < p.Tq ? p.delta[row] : 0.f;
    }
    __syncthreads();

    float s[kRowsPerWarp], dp[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = dp[r] = 0.f;
    for (int c = 0; c < p.D; ++c) {
      const float qc = qs[lane * (DMAX + 1) + c];
      const float dc = dos[lane * (DMAX + 1) + c];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        s[r] = fmaf(qc, ks[(r0 + r) * DMAX + c], s[r]);
        dp[r] = fmaf(dc, vs[(r0 + r) * DMAX + c], dp[r]);
      }
    }

    const int t = i0 + lane;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int key = k0 + r0 + r;
      float pr = 0.f, ds = 0.f;
      if (key < p.Tk && t < p.Tq)
        p_and_ds<kPartial>(p, bias, s[r], dp[r], lse_s[lane],
                           delta_s[lane], t, key, &pr, &ds);
      const float pd = round_to<TO>(pr);  // P in dO's dtype
      const float dsq = round_to<T>(ds);  // dS in Q's dtype
      for (int j = 0; j < kTile; ++j) {
        const float pj = __shfl_sync(0xffffffffu, pd, j);
        const float dj = __shfl_sync(0xffffffffu, dsq, j);
#pragma unroll
        for (int i = 0; i < kCols; ++i) {
          const int c = j * (DMAX + 1) + lane + 32 * i;
          dv[r][i] = fmaf(pj, dos[c], dv[r][i]);
          dk[r][i] = fmaf(dj, qs[c], dk[r][i]);
        }
      }
    }
  }

  TOut* dk_out = static_cast<TOut*>(p.out0);
  TOut* dv_out = static_cast<TOut*>(p.out1);
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int key = k0 + r0 + r;
    if (key >= p.Tk) continue;  // uniform across the warp
    const long long row = (long long)bh * p.Tk + key;
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      const int c = lane + 32 * i;
      if (c < p.D) {
        dk_out[row * p.D + c] = from_f32<TOut>(dk[r][i] * p.scale);
        dv_out[row * p.D + c] = from_f32<TOut>(dv[r][i]);
      }
    }
  }
}

// ---- dK / dV on the tensor cores (bf16) --------------------------------------

constexpr int kTcWarps = 4;
constexpr int kTcThreads = kTcWarps * 32;
constexpr int kTcKeys = kTcWarps * 16;  // keys per block, 16 per warp

template <int DMAX>
struct DkvTc {
  static constexpr int kQ = 32;  // queries per tile
  static constexpr int kLd = DMAX + 8;  // padded row: ldmatrix hits 8 banks
  static constexpr int kQTiles = kQ / 8;    // n8 tiles of S^T per warp
  static constexpr int kDTiles = DMAX / 8;  // n8 tiles of dK, dV per warp
  static constexpr size_t kSmem =
      (size_t)(2 * kTcKeys + 4 * kQ) * kLd * sizeof(__nv_bfloat16) +
      4 * kQ * sizeof(float);
};

// rows [r0, r0 + n) of a [T, D] bf16 operand (strided rows, contiguous
// columns) into shared memory rows of kLd, zero beyond T and D: 16-byte
// cp.async copies when p.vec, else element loads
template <int DMAX>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst,
                                               const __nv_bfloat16* src,
                                               long long st, int r0, int n,
                                               int T_, int D, int vec) {
  constexpr int kLd = DkvTc<DMAX>::kLd;
  if (vec) {
    constexpr int kChunks = DMAX / 8;
    for (int i = threadIdx.x; i < n * kChunks; i += kTcThreads) {
      const int r = i / kChunks, c = (i % kChunks) * 8, t = r0 + r;
      const bool inside = t < T_ && c < D;
      tc::cp_async16(dst + r * kLd + c, inside ? src + t * st + c : src,
                     inside);
    }
  } else {
    for (int i = threadIdx.x; i < n * DMAX; i += kTcThreads) {
      const int r = i / DMAX, c = i % DMAX, t = r0 + r;
      dst[r * kLd + c] =
          (t < T_ && c < D) ? src[t * st + c] : __float2bfloat16_rn(0.f);
    }
  }
}

// p_and_ds with every elementwise step one rounded f32 operation, as torch
// computes the plain version (no FMA contraction of the scale, bias and lse)
__device__ __forceinline__ void p_and_ds_rn(const Params& p, const float* bias,
                                            float dot, float dp, float lse,
                                            float delta, int row, int key,
                                            float* pr, float* ds) {
  if (p.causal && row + p.causal_offset < 0) {  // sees no key
    *pr = 1.f / (float)p.Tk;
    *ds = 0.f;
    return;
  }
  if (p.causal && key > row + p.causal_offset) {  // a replaced score
    *pr = expf(__fsub_rn(kMaskedScore, lse));
    *ds = 0.f;
    return;
  }
  float x = __fmul_rn(dot, p.scale);
  if (bias != nullptr) x = __fadd_rn(x, bias[row * p.b_sq + key * p.b_sk]);
  *pr = expf(__fsub_rn(x, lse));
  *ds = __fmul_rn(*pr, __fsub_rn(dp, delta));
}

template <int DMAX>
__global__ void __launch_bounds__(kTcThreads, DMAX <= 64 ? 3 : 1)
    flash_dkv_tc_kernel(const Params p) {
  using Cfg = DkvTc<DMAX>;
  constexpr int kQ = Cfg::kQ, kLd = Cfg::kLd;
  constexpr int kQTiles = Cfg::kQTiles, kDTiles = Cfg::kDTiles;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + kTcKeys * kLd;
  __nv_bfloat16* qs = vs + kTcKeys * kLd;  // [2][kQ][kLd]
  __nv_bfloat16* dos = qs + 2 * kQ * kLd;  // [2][kQ][kLd]
  float* lse_s = reinterpret_cast<float*>(dos + 2 * kQ * kLd);  // [2][kQ]
  float* delta_s = lse_s + 2 * kQ;                              // [2][kQ]

  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int k0 = blockIdx.y * kTcKeys;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t4 = lane % 4;
  const int kw = warp * 16;  // this warp's first key in the block

  using bf16 = __nv_bfloat16;
  const bf16* q = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const bf16* dout = static_cast<const bf16*>(p.dout) + b * p.o_sb +
                     h * p.o_sh;
  const float* bias =
      p.bias == nullptr ? nullptr : p.bias + b * p.b_sb + h * p.b_sh;

  // query tiles that no row can reach the block's keys from are skipped
  // (as flash_dkv_kernel); rows that see no key weigh every key with 1/Tk
  int first = 0;
  if (p.causal && p.causal_offset >= 0)
    first = max(0, k0 - p.causal_offset) / kQ;
  const int n_tiles = (p.Tq + kQ - 1) / kQ;

  auto load_queries = [&](int stage, int tile) {
    const int i0 = tile * kQ;
    load_tile_bf16<DMAX>(qs + stage * kQ * kLd, q, p.q_st, i0, kQ, p.Tq, p.D,
                         p.vec);
    load_tile_bf16<DMAX>(dos + stage * kQ * kLd, dout, p.o_st, i0, kQ, p.Tq,
                         p.D, p.vec);
    for (int i = threadIdx.x; i < kQ; i += kTcThreads) {
      const int t = i0 + i;
      const long long row = (long long)bh * p.Tq + t;
      lse_s[stage * kQ + i] = t < p.Tq ? p.lse[row] : 0.f;
      delta_s[stage * kQ + i] = t < p.Tq ? p.delta[row] : 0.f;
    }
  };

  load_tile_bf16<DMAX>(ks, k, p.k_st, k0, kTcKeys, p.Tk, p.D, p.vec);
  load_tile_bf16<DMAX>(vs, v, p.v_st, k0, kTcKeys, p.Tk, p.D, p.vec);
  if (first < n_tiles) load_queries(0, first);
  tc::cp_async_commit();

  float dk[kDTiles][4], dv[kDTiles][4];
#pragma unroll
  for (int j = 0; j < kDTiles; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  for (int tile = first; tile < n_tiles; ++tile) {
    const int stage = (tile - first) & 1;
    if (tile + 1 < n_tiles) load_queries(stage ^ 1, tile + 1);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();  // this tile's copies (and K, V) have landed
    __syncthreads();

    const bf16* qt = qs + stage * kQ * kLd;
    const bf16* ot = dos + stage * kQ * kLd;
    // S^T = K . Q^T and dP^T = V . dO^T: 16 keys x kQ queries per warp
    float s[kQTiles][4], dp[kQTiles][4];
#pragma unroll
    for (int j = 0; j < kQTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < DMAX / 16; ++kd) {
      uint32_t ka[4], va[4];
      const int a_off = (kw + lane % 16) * kLd + kd * 16 + (lane / 16) * 8;
      tc::ldmatrix_x4(ka, ks + a_off);
      tc::ldmatrix_x4(va, vs + a_off);
#pragma unroll
      for (int np = 0; np < kQTiles / 2; ++np) {
        const int b_off = (np * 16 + lane % 8 + (lane / 16) * 8) * kLd +
                          kd * 16 + ((lane / 8) % 2) * 8;
        uint32_t qb[4], ob[4];
        tc::ldmatrix_x4(qb, qt + b_off);
        tc::ldmatrix_x4(ob, ot + b_off);
        tc::mma_bf16(s[2 * np], ka, qb[0], qb[1]);
        tc::mma_bf16(s[2 * np + 1], ka, qb[2], qb[3]);
        tc::mma_bf16(dp[2 * np], va, ob[0], ob[1]);
        tc::mma_bf16(dp[2 * np + 1], va, ob[2], ob[3]);
      }
    }

    // P and dS in registers, as the scalar kernels form them; a tile with
    // no bias, no edge and no masked pair skips the tests
    const int i0 = tile * kQ;
    const bool plain_tile =
        bias == nullptr && k0 + kTcKeys <= p.Tk && i0 + kQ <= p.Tq &&
        (!p.causal || k0 + kTcKeys - 1 <= i0 + p.causal_offset);
#pragma unroll
    for (int j = 0; j < kQTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + kw + g + (e / 2) * 8;
        const int col = j * 8 + 2 * t4 + (e % 2);
        const int row = i0 + col;
        const float lse = lse_s[stage * kQ + col];
        const float delta = delta_s[stage * kQ + col];
        float pr = 0.f, ds = 0.f;
        if (plain_tile) {
          pr = expf(__fsub_rn(__fmul_rn(s[j][e], p.scale), lse));
          ds = __fmul_rn(pr, __fsub_rn(dp[j][e], delta));
        } else if (key < p.Tk && row < p.Tq) {
          p_and_ds_rn(p, bias, s[j][e], dp[j][e], lse, delta, row, key, &pr,
                      &ds);
        }
        s[j][e] = pr;
        dp[j][e] = ds;
      }
    // the reference's casts: P to dO's dtype, dS to Q's dtype (both bf16)
    uint32_t pf[kQTiles][2], df[kQTiles][2];
#pragma unroll
    for (int j = 0; j < kQTiles; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        pf[j][hh] = tc::pack_bf16(s[j][2 * hh], s[j][2 * hh + 1]);
        df[j][hh] = tc::pack_bf16(dp[j][2 * hh], dp[j][2 * hh + 1]);
      }

    // dV += P^T . dO and dK += dS^T . Q, A from registers
#pragma unroll
    for (int kk = 0; kk < kQ / 16; ++kk) {
      const uint32_t pa[4] = {pf[2 * kk][0], pf[2 * kk][1],
                              pf[2 * kk + 1][0], pf[2 * kk + 1][1]};
      const uint32_t da[4] = {df[2 * kk][0], df[2 * kk][1],
                              df[2 * kk + 1][0], df[2 * kk + 1][1]};
#pragma unroll
      for (int dn = 0; dn < kDTiles / 2; ++dn) {
        const int b_off = (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * kLd +
                          dn * 16 + (lane / 16) * 8;
        uint32_t ob[4], qb[4];
        tc::ldmatrix_x4_trans(ob, ot + b_off);
        tc::ldmatrix_x4_trans(qb, qt + b_off);
        tc::mma_bf16(dv[2 * dn], pa, ob[0], ob[1]);
        tc::mma_bf16(dv[2 * dn + 1], pa, ob[2], ob[3]);
        tc::mma_bf16(dk[2 * dn], da, qb[0], qb[1]);
        tc::mma_bf16(dk[2 * dn + 1], da, qb[2], qb[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage
  }
  tc::cp_async_wait<0>();

  bf16* dk_out = static_cast<bf16*>(p.out0);
  bf16* dv_out = static_cast<bf16*>(p.out1);
#pragma unroll
  for (int j = 0; j < kDTiles; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = k0 + kw + g + (e / 2) * 8;
      const int c = j * 8 + 2 * t4 + (e % 2);
      if (key >= p.Tk || c >= p.D) continue;
      const long long at = ((long long)bh * p.Tk + key) * p.D + c;
      dk_out[at] = __float2bfloat16_rn(dk[j][e] * p.scale);
      dv_out[at] = __float2bfloat16_rn(dv[j][e]);
    }
}

// ---- f32 operands as bf16 pieces (the ring's dO, #6 and #7) ----------------

// rows [r0, r0 + n) of a [T, D] f32 operand (strided rows, contiguous
// columns) into shared rows of DMAX floats, zero beyond T and D, by
// 16-byte cp.async copies
template <int DMAX>
__device__ __forceinline__ void load_rows_f32_async(float* dst,
                                                    const float* src,
                                                    long long st, int r0,
                                                    int n, int T_, int D) {
  constexpr int kChunks = DMAX / 4;
  for (int i = threadIdx.x; i < n * kChunks; i += kTcThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 4, t = r0 + r;
    const bool inside = t < T_ && c < D;
    tc::cp_async16(dst + r * DMAX + c, inside ? src + t * st + c : src,
                   inside);
  }
}

// An f32 operand x goes to the tensor cores as three bf16 pieces, hi =
// bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid), whose sum is x
// exactly (for normal x whose pieces stay normal); every bf16 x bf16
// product is exact in f32, so a product against the pieces is the f32
// product up to the order of its sum.  Here the n rows of DMAX floats at
// src (landed in shared memory) become three [n][kLd] bf16 tiles at dst,
// hi, mid, lo, in the layout ldmatrix reads.
template <int DMAX>
__device__ __forceinline__ void split_rows(const float* src,
                                           __nv_bfloat16* dst, int n) {
  constexpr int kLd = DkvTc<DMAX>::kLd;
  for (int i = threadIdx.x; i < n * DMAX / 4; i += kTcThreads) {
    const int r = i / (DMAX / 4), col = (i % (DMAX / 4)) * 4;
    const float4 x4 = *reinterpret_cast<const float4*>(src + r * DMAX + col);
    const float xs[4] = {x4.x, x4.y, x4.z, x4.w};
    uint32_t hi[2], mid[2], lo[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float a = xs[2 * e], c = xs[2 * e + 1];
      const __nv_bfloat162 hi2 = __floats2bfloat162_rn(a, c);
      const float2 do_rest = {a - __low2float(hi2), c - __high2float(hi2)};
      const __nv_bfloat162 mid2 =
          __floats2bfloat162_rn(do_rest.x, do_rest.y);
      hi[e] = tc::bits(hi2);
      mid[e] = tc::bits(mid2);
      lo[e] = tc::bits(__floats2bfloat162_rn(
          do_rest.x - __low2float(mid2), do_rest.y - __high2float(mid2)));
    }
    const int at = r * kLd + col;
    *reinterpret_cast<uint2*>(dst + at) = make_uint2(hi[0], hi[1]);
    *reinterpret_cast<uint2*>(dst + n * kLd + at) = make_uint2(mid[0], mid[1]);
    *reinterpret_cast<uint2*>(dst + 2 * n * kLd + at) =
        make_uint2(lo[0], lo[1]);
  }
}

// ---- dQ on the tensor cores (bf16; #2, and #6 with dO in f32) ----------------

constexpr int kTcRows = kTcWarps * 16;  // query rows per dQ block, 16 per warp

// 32-key K/V tiles from D 64 up (at D 64: 163 registers and 0.43 ms at
// the LM training shape, against 175 and 0.56 with 64-key tiles; PERF.md),
// 64 at D 32.  kPartial (#6): dO in f32, as three bf16 pieces; the shared
// memory holds Q, dO's pieces, K and V in two stages each, and dO's f32
// rows before the split.  The pieces' A fragments stay in registers up to
// D 64 (#6's SP path); at D 128 they would spill, so each key tile reads
// them from shared memory through ldmatrix, as #7 does.
template <int DMAX, bool kPartial = false>
struct DqTc {
  static constexpr int kKeys = DMAX <= 32 ? 64 : 32;  // keys per K/V tile
  static constexpr int kLd = DkvTc<DMAX>::kLd;
  static constexpr int kKn = kKeys / 8;  // n8 tiles of S and dP per warp
  static constexpr int kDk = DMAX / 16;  // 16-deep steps of Q.K^T, dO.V^T
  static constexpr int kDn = DMAX / 8;   // n8 tiles of dQ per warp
  static constexpr int kPieces = kPartial ? 3 : 1;  // dO's bf16 pieces
  static constexpr bool kDoInRegs = !kPartial || DMAX <= 64;
  static constexpr size_t kSmem =
      (size_t)((1 + kPieces) * kTcRows + 4 * kKeys) * kLd *
          sizeof(__nv_bfloat16) +
      (kPartial ? (size_t)kTcRows * DMAX * sizeof(float) : 0);
};

// #1's FlashAttention-2 loop turned to dQ.  One (b, h) and 64 query rows a
// block, 16 a warp, query blocks heaviest first under a causal mask.  Q's
// and dO's A fragments, the rows' lse and Delta and the dQ sum stay in
// registers for the whole sweep; K and V tiles stream through two
// cp.async stages (element loads where p.vec is 0), zero beyond Tk and D.
// Per tile: S = Q . K^T and dP = dO . V^T on the tensor cores (K and V
// through ldmatrix), P and dS per element with every step one rounded f32
// operation (p_and_ds_rn), dS rounded to K's dtype and repacked from its C
// fragments into A fragments, dQ += dS . K with K through ldmatrix.trans
// from the same tile.  Key tiles wholly above the block's last row are
// skipped (they add dS = 0, as does every key of a row that sees none).
// Each block owns its rows: no float atomics, the same bits every launch.
// kPartial (#6, the ring's dQ of one chunk pair): dO comes in f32, so its
// row block is split once into three bf16 pieces whose sum is exact
// (split_rows, #7's split), and dP = dO . V^T is three products over the
// pieces, smallest first, each 16-deep step summed into a fresh tile and
// then added to the running f32 sum (the tensor cores' f32 accumulation
// drops low bits); S and dQ stay one product each, dS rounded to K's
// dtype, bf16: 5 bf16 products a tile where #2 issues 3.  lse and Delta
// are the whole sequence's rows, the causal mask is on global positions
// (causal_offset = q_offset - k_offset), a row that sees no key of the
// chunk has dS = 0 as everywhere, and dQ is written in f32.
template <int DMAX, bool kPartial>
__global__ void __launch_bounds__(kTcThreads)
    flash_dq_tc_kernel(const Params p) {
  using bf16 = __nv_bfloat16;
  using Cfg = DqTc<DMAX, kPartial>;
  constexpr int kKeys = Cfg::kKeys, kLd = Cfg::kLd;
  constexpr int kKn = Cfg::kKn, kDk = Cfg::kDk, kDn = Cfg::kDn;
  constexpr int kPieces = Cfg::kPieces;
  constexpr bool kDoInRegs = Cfg::kDoInRegs;
  using TO = std::conditional_t<kPartial, float, bf16>;  // dO's dtype
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [kTcRows][kLd]
  bf16* dos = qs + kTcRows * kLd;                // [kPieces][kTcRows][kLd]
  bf16* ks = dos + kPieces * kTcRows * kLd;      // [2][kKeys][kLd]
  bf16* vs = ks + 2 * kKeys * kLd;               // [2][kKeys][kLd]
  // kPartial: dO's f32 rows [kTcRows][DMAX], split into dos once landed
  float* dof = reinterpret_cast<float*>(vs + 2 * kKeys * kLd);

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
  const TO* dout = static_cast<const TO*>(p.dout) + b * p.o_sb + h * p.o_sh;
  const float* bias =
      p.bias == nullptr ? nullptr : p.bias + b * p.b_sb + h * p.b_sh;

  int n_tiles = (p.Tk + kKeys - 1) / kKeys;
  if (p.causal) {
    const long long last_key =
        (long long)min(q0 + kTcRows, p.Tq) - 1 + p.causal_offset;
    n_tiles = last_key < 0
                  ? 0
                  : (int)min((long long)n_tiles, last_key / kKeys + 1);
  }

  auto load_kv = [&](int stage, int tile) {
    load_tile_bf16<DMAX>(ks + stage * kKeys * kLd, k, p.k_st, tile * kKeys,
                         kKeys, p.Tk, p.D, p.vec);
    load_tile_bf16<DMAX>(vs + stage * kKeys * kLd, v, p.v_st, tile * kKeys,
                         kKeys, p.Tk, p.D, p.vec);
  };
  load_tile_bf16<DMAX>(qs, q, p.q_st, q0, kTcRows, p.Tq, p.D, p.vec);
  if constexpr (kPartial)
    load_rows_f32_async<DMAX>(dof, dout, p.o_st, q0, kTcRows, p.Tq, p.D);
  else
    load_tile_bf16<DMAX>(dos, dout, p.o_st, q0, kTcRows, p.Tq, p.D, p.vec);
  if (n_tiles > 0) load_kv(0, 0);
  tc::cp_async_commit();

  float lse[2], delta[2], acc[kDn][4];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int t = r_lo + hh * 8;
    const long long row = (long long)bh * p.Tq + t;
    lse[hh] = t < p.Tq ? p.lse[row] : 0.f;
    delta[hh] = t < p.Tq ? p.delta[row] : 0.f;
  }
#pragma unroll
  for (int j = 0; j < kDn; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  tc::cp_async_wait<0>();
  __syncthreads();
  if constexpr (kPartial) {  // dO's rows as their three bf16 pieces
    split_rows<DMAX>(dof, dos, kTcRows);
    __syncthreads();
  }
  auto a_off = [&](int kd) {  // this warp's 16 rows, 16-deep step kd
    return (warp * 16 + lane % 16) * kLd + kd * 16 + (lane / 16) * 8;
  };
  // this warp's 16 rows of Q and of dO (each of dO's pieces: hi, mid, lo)
  uint32_t qa[kDk][4], oa[kDoInRegs ? kDk : 1][kPieces][4];
#pragma unroll
  for (int kd = 0; kd < kDk; ++kd) {
    tc::ldmatrix_x4(qa[kd], qs + a_off(kd));
    if constexpr (kDoInRegs)
#pragma unroll
      for (int piece = 0; piece < kPieces; ++piece)
        tc::ldmatrix_x4(oa[kd][piece],
                        dos + piece * kTcRows * kLd + a_off(kd));
  }

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int stage = tile & 1;
    if (tile + 1 < n_tiles) load_kv(stage ^ 1, tile + 1);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();  // this tile's copies have landed
    __syncthreads();
    const bf16* kt = ks + stage * kKeys * kLd;
    const bf16* vt = vs + stage * kKeys * kLd;

    // S = Q . K^T and dP = dO . V^T: 16 rows x kKeys keys per warp, f32
    float s[kKn][4], dp[kKn][4];
#pragma unroll
    for (int j = 0; j < kKn; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < kDk; ++kd) {
      uint32_t oak[kPieces][4];  // dO's pieces at step kd
#pragma unroll
      for (int piece = 0; piece < kPieces; ++piece) {
        if constexpr (kDoInRegs) {
#pragma unroll
          for (int i = 0; i < 4; ++i) oak[piece][i] = oa[kd][piece][i];
        } else {
          tc::ldmatrix_x4(oak[piece], dos + piece * kTcRows * kLd + a_off(kd));
        }
      }
#pragma unroll
      for (int np = 0; np < kKn / 2; ++np) {
        const int b_off = (np * 16 + lane % 8 + (lane / 16) * 8) * kLd +
                          kd * 16 + ((lane / 8) % 2) * 8;
        uint32_t kb[4], vb[4];
        tc::ldmatrix_x4(kb, kt + b_off);
        tc::ldmatrix_x4(vb, vt + b_off);
        tc::mma_bf16(s[2 * np], qa[kd], kb[0], kb[1]);
        tc::mma_bf16(s[2 * np + 1], qa[kd], kb[2], kb[3]);
        if constexpr (kPartial) {
          // dO's pieces lo, mid, hi into a fresh tile, then the sum
          float tp[2][4] = {};
#pragma unroll
          for (int piece = kPieces - 1; piece >= 0; --piece) {
            tc::mma_bf16(tp[0], oak[piece], vb[0], vb[1]);
            tc::mma_bf16(tp[1], oak[piece], vb[2], vb[3]);
          }
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) dp[2 * np + n][e] += tp[n][e];
        } else {
          tc::mma_bf16(dp[2 * np], oak[0], vb[0], vb[1]);
          tc::mma_bf16(dp[2 * np + 1], oak[0], vb[2], vb[3]);
        }
      }
    }

    // dS in dp's registers; a tile with no bias, no edge and no masked
    // pair skips the tests
    const int k0 = tile * kKeys;
    const bool plain_tile =
        bias == nullptr && k0 + kKeys <= p.Tk && q0 + kTcRows <= p.Tq &&
        (!p.causal || k0 + kKeys - 1 <= q0 + p.causal_offset);
#pragma unroll
    for (int j = 0; j < kKn; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + 2 * t4 + (e % 2);
        const int row = r_lo + (e / 2) * 8;
        float pr = 0.f, ds = 0.f;
        if (plain_tile) {
          pr = expf(__fsub_rn(__fmul_rn(s[j][e], p.scale), lse[e / 2]));
          ds = __fmul_rn(pr, __fsub_rn(dp[j][e], delta[e / 2]));
        } else if (key < p.Tk && row < p.Tq) {
          p_and_ds_rn(p, bias, s[j][e], dp[j][e], lse[e / 2], delta[e / 2],
                      row, key, &pr, &ds);
        }
        dp[j][e] = ds;
      }
    // dS in K's dtype (bf16, to nearest), packed as A fragments
    uint32_t dsa[kKn][2];
#pragma unroll
    for (int j = 0; j < kKn; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        dsa[j][hh] = tc::pack_bf16(dp[j][2 * hh], dp[j][2 * hh + 1]);

    // dQ += dS . K, K through ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      const uint32_t da[4] = {dsa[2 * kk][0], dsa[2 * kk][1],
                              dsa[2 * kk + 1][0], dsa[2 * kk + 1][1]};
#pragma unroll
      for (int dn = 0; dn < kDn / 2; ++dn) {
        uint32_t kb[4];
        tc::ldmatrix_x4_trans(
            kb, kt + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * kLd +
                    dn * 16 + (lane / 16) * 8);
        tc::mma_bf16(acc[2 * dn], da, kb[0], kb[1]);
        tc::mma_bf16(acc[2 * dn + 1], da, kb[2], kb[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage
  }
  tc::cp_async_wait<0>();

  // dQ = scale * sum, in q's dtype (#6: in f32, pairs of columns; D is a
  // multiple of 8 there)
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int t = r_lo + hh * 8;
    if (t >= p.Tq) continue;
    const long long row = (long long)bh * p.Tq + t;
#pragma unroll
    for (int j = 0; j < kDn; ++j) {
      const int c = j * 8 + 2 * t4;
      if constexpr (kPartial) {
        if (c < p.D)
          *reinterpret_cast<float2*>(static_cast<float*>(p.out0) +
                                     row * p.D + c) =
              make_float2(acc[j][2 * hh] * p.scale,
                          acc[j][2 * hh + 1] * p.scale);
      } else {
        bf16* dq = static_cast<bf16*>(p.out0);
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (c + e < p.D)
            dq[row * p.D + c + e] =
                __float2bfloat16_rn(acc[j][2 * hh + e] * p.scale);
      }
    }
  }
}

// ---- the ring's dK / dV (#7) on the tensor cores (bf16 q, k, v; f32 dO) ---

// #3's tiles; the shared memory holds K and V, Q in two stages, dO's three
// bf16 pieces, then in f32 dO in two stages and lse and Delta in two
template <int DMAX>
struct DkvPartialTc : DkvTc<DMAX> {
  using Base = DkvTc<DMAX>;
  static constexpr size_t kSmem =
      (size_t)(2 * kTcKeys + 5 * Base::kQ) * Base::kLd *
          sizeof(__nv_bfloat16) +
      (size_t)(2 * Base::kQ * DMAX + 4 * Base::kQ) * sizeof(float);
};

// The reference's _dkv_accum with dO in f32: dP = dO . V^T and dV = P^T .
// dO have an f32 operand, which a bf16 product would round, so each goes
// to the tensor cores as three bf16 pieces whose sum is exact (split_rows
// for dO, the same steps in registers for P).  Per 32-query tile: S^T =
// K . Q^T (one product),
// dP^T = V . dO^T over dO's pieces (three), dV += P^T . dO over the six
// terms of P's and dO's pieces down to 2^-24 of the product (hi.hi,
// hi.mid, mid.hi, hi.lo, mid.mid, lo.hi), dK += dS^T . Q with dS rounded
// to Q's dtype as #3 does (one): 11 bf16 products where the scalar kernel
// does 4 in f32.  The tensor cores' f32 sums drop low bits, so each
// 16-deep step of S, dP and dV is summed into a fresh tile, smallest
// pieces first, and then added to its running f32 sum.
template <int DMAX>
__global__ void __launch_bounds__(kTcThreads, DMAX <= 64 ? 2 : 1)
    flash_dkv_partial_tc_kernel(const Params p) {
  using bf16 = __nv_bfloat16;
  using Cfg = DkvPartialTc<DMAX>;
  constexpr int kQ = Cfg::kQ, kLd = Cfg::kLd;
  constexpr int kQTiles = Cfg::kQTiles, kDTiles = Cfg::kDTiles;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + kTcKeys * kLd;
  bf16* qs = vs + kTcKeys * kLd;               // [2][kQ][kLd]
  bf16* pieces = qs + 2 * kQ * kLd;            // [3][kQ][kLd]: hi, mid, lo
  // [2][kQ][DMAX]
  float* dof = reinterpret_cast<float*>(pieces + 3 * kQ * kLd);
  float* lse_s = dof + 2 * kQ * DMAX;          // [2][kQ]
  float* delta_s = lse_s + 2 * kQ;             // [2][kQ]

  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int k0 = blockIdx.y * kTcKeys;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t4 = lane % 4;
  const int kw = warp * 16;  // this warp's first key in the block

  const bf16* q = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* dout = static_cast<const float*>(p.dout) + b * p.o_sb +
                      h * p.o_sh;

  // a row that sees none of the block's keys has P = 0 (its lse is the
  // sequence's): query tiles before the first row that sees key k0 are
  // skipped, and a block no row sees writes zeros
  const int n_tiles = (p.Tq + kQ - 1) / kQ;
  int first = 0;
  if (p.causal)
    first = (int)min((long long)n_tiles,
                     max(0LL, (long long)k0 - p.causal_offset) / kQ);

  auto load_queries = [&](int stage, int tile) {
    const int i0 = tile * kQ;
    load_tile_bf16<DMAX>(qs + stage * kQ * kLd, q, p.q_st, i0, kQ, p.Tq, p.D,
                         1);
    load_rows_f32_async<DMAX>(dof + stage * kQ * DMAX, dout, p.o_st, i0, kQ,
                              p.Tq, p.D);
    for (int i = threadIdx.x; i < kQ; i += kTcThreads) {
      const int t = i0 + i;
      const long long row = (long long)bh * p.Tq + t;
      lse_s[stage * kQ + i] = t < p.Tq ? p.lse[row] : 0.f;
      delta_s[stage * kQ + i] = t < p.Tq ? p.delta[row] : 0.f;
    }
  };

  load_tile_bf16<DMAX>(ks, k, p.k_st, k0, kTcKeys, p.Tk, p.D, 1);
  load_tile_bf16<DMAX>(vs, v, p.v_st, k0, kTcKeys, p.Tk, p.D, 1);
  if (first < n_tiles) load_queries(0, first);
  tc::cp_async_commit();

  float dk[kDTiles][4], dv[kDTiles][4];
#pragma unroll
  for (int j = 0; j < kDTiles; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  for (int tile = first; tile < n_tiles; ++tile) {
    const int stage = (tile - first) & 1;
    if (tile + 1 < n_tiles) load_queries(stage ^ 1, tile + 1);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();  // this tile's copies (and K, V) have landed
    __syncthreads();

    // dO's tile as its three bf16 pieces, in the layout ldmatrix reads
    split_rows<DMAX>(dof + stage * kQ * DMAX, pieces, kQ);
    __syncthreads();

    const bf16* qt = qs + stage * kQ * kLd;
    // S^T = K . Q^T and dP^T = V . dO^T: 16 keys x kQ queries per warp,
    // dO's pieces lo, mid, hi; each 16-deep step into a fresh tile
    float s[kQTiles][4], dp[kQTiles][4];
#pragma unroll
    for (int j = 0; j < kQTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < DMAX / 16; ++kd) {
      uint32_t ka[4], va[4];
      const int a_off = (kw + lane % 16) * kLd + kd * 16 + (lane / 16) * 8;
      tc::ldmatrix_x4(ka, ks + a_off);
      tc::ldmatrix_x4(va, vs + a_off);
#pragma unroll
      for (int np = 0; np < kQTiles / 2; ++np) {
        const int b_off = (np * 16 + lane % 8 + (lane / 16) * 8) * kLd +
                          kd * 16 + ((lane / 8) % 2) * 8;
        float ts[2][4] = {}, tp[2][4] = {};
        uint32_t qb[4];
        tc::ldmatrix_x4(qb, qt + b_off);
        tc::mma_bf16(ts[0], ka, qb[0], qb[1]);
        tc::mma_bf16(ts[1], ka, qb[2], qb[3]);
#pragma unroll
        for (int piece = 2; piece >= 0; --piece) {
          uint32_t ob[4];
          tc::ldmatrix_x4(ob, pieces + piece * kQ * kLd + b_off);
          tc::mma_bf16(tp[0], va, ob[0], ob[1]);
          tc::mma_bf16(tp[1], va, ob[2], ob[3]);
        }
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[2 * np + n][e] += ts[n][e];
            dp[2 * np + n][e] += tp[n][e];
          }
      }
    }

    // P = exp(s - lse) and dS = P (dP - Delta), each step one rounded f32
    // operation as torch computes the plain version; -1e9 replaces a score
    // on global causal positions (P = exp(-1e9 - lse) = 0, dS = 0); a tile
    // with no edge and no masked pair skips the tests
    const int i0 = tile * kQ;
    const bool plain_tile =
        k0 + kTcKeys <= p.Tk && i0 + kQ <= p.Tq &&
        (!p.causal || k0 + kTcKeys - 1 <= i0 + p.causal_offset);
#pragma unroll
    for (int j = 0; j < kQTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + kw + g + (e / 2) * 8;
        const int col = j * 8 + 2 * t4 + (e % 2);
        const int row = i0 + col;
        const float lse = lse_s[stage * kQ + col];
        const float delta = delta_s[stage * kQ + col];
        float pr = 0.f, ds = 0.f;
        if (plain_tile || (key < p.Tk && row < p.Tq)) {
          if (!plain_tile && p.causal && key > row + p.causal_offset) {
            pr = expf(__fsub_rn(kMaskedScore, lse));
          } else {
            pr = expf(__fsub_rn(__fmul_rn(s[j][e], p.scale), lse));
            ds = __fmul_rn(pr, __fsub_rn(dp[j][e], delta));
          }
        }
        s[j][e] = pr;
        dp[j][e] = ds;
      }
    // dS in Q's dtype (bf16, to nearest), as #3 casts it
    uint32_t ds_a[kQTiles][2];
#pragma unroll
    for (int j = 0; j < kQTiles; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        ds_a[j][hh] = tc::pack_bf16(dp[j][2 * hh], dp[j][2 * hh + 1]);

    // dV += P^T . dO over P's and dO's pieces, and dK += dS^T . Q; A from
    // registers, B through ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < kQ / 16; ++kk) {
      uint32_t ph[4], pm[4], pl[4];  // P^T's A fragment in three pieces
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float a = s[2 * kk + i][2 * hh], c = s[2 * kk + i][2 * hh + 1];
          const __nv_bfloat162 hi2 = __floats2bfloat162_rn(a, c);
          const float2 p_rest = {a - __low2float(hi2), c - __high2float(hi2)};
          const __nv_bfloat162 mid2 =
              __floats2bfloat162_rn(p_rest.x, p_rest.y);
          const __nv_bfloat162 lo2 =
              __floats2bfloat162_rn(p_rest.x - __low2float(mid2),
                                    p_rest.y - __high2float(mid2));
          ph[2 * i + hh] = tc::bits(hi2);
          pm[2 * i + hh] = tc::bits(mid2);
          pl[2 * i + hh] = tc::bits(lo2);
        }
      const uint32_t da[4] = {ds_a[2 * kk][0], ds_a[2 * kk][1],
                              ds_a[2 * kk + 1][0], ds_a[2 * kk + 1][1]};
#pragma unroll
      for (int dn = 0; dn < kDTiles / 2; ++dn) {
        const int b_off = (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * kLd +
                          dn * 16 + (lane / 16) * 8;
        uint32_t oh[4], om[4], ol[4], qb[4];
        tc::ldmatrix_x4_trans(oh, pieces + b_off);
        tc::ldmatrix_x4_trans(om, pieces + kQ * kLd + b_off);
        tc::ldmatrix_x4_trans(ol, pieces + 2 * kQ * kLd + b_off);
        tc::ldmatrix_x4_trans(qb, qt + b_off);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          float t[4] = {};  // the six terms, smallest first
          tc::mma_bf16(t, pl, oh[2 * n], oh[2 * n + 1]);
          tc::mma_bf16(t, pm, om[2 * n], om[2 * n + 1]);
          tc::mma_bf16(t, ph, ol[2 * n], ol[2 * n + 1]);
          tc::mma_bf16(t, pm, oh[2 * n], oh[2 * n + 1]);
          tc::mma_bf16(t, ph, om[2 * n], om[2 * n + 1]);
          tc::mma_bf16(t, ph, oh[2 * n], oh[2 * n + 1]);
#pragma unroll
          for (int e = 0; e < 4; ++e) dv[2 * dn + n][e] += t[e];
          tc::mma_bf16(dk[2 * dn + n], da, qb[2 * n], qb[2 * n + 1]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage and the pieces
  }
  tc::cp_async_wait<0>();

  float* dk_out = static_cast<float*>(p.out0);
  float* dv_out = static_cast<float*>(p.out1);
#pragma unroll
  for (int j = 0; j < kDTiles; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int key = k0 + kw + g + hh * 8;
      const int c = j * 8 + 2 * t4;
      if (key >= p.Tk || c >= p.D) continue;
      const long long at = ((long long)bh * p.Tk + key) * p.D + c;
      *reinterpret_cast<float2*>(dk_out + at) =
          make_float2(dk[j][2 * hh] * p.scale, dk[j][2 * hh + 1] * p.scale);
      *reinterpret_cast<float2*>(dv_out + at) =
          make_float2(dv[j][2 * hh], dv[j][2 * hh + 1]);
    }
}

// ---- dBias -----------------------------------------------------------------

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
    flash_dbias_kernel(const Params p) {
  extern __shared__ float smem[];
  float* qs = smem;                     // [kBlockRows][DMAX]
  float* dos = qs + kBlockRows * DMAX;  // [kBlockRows][DMAX]
  float* ks = dos + kBlockRows * DMAX;  // [kTile][DMAX + 1]
  float* vs = ks + kTile * (DMAX + 1);  // [kTile][DMAX + 1]

  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.y * kBlockRows;
  const int k0 = blockIdx.z * kTile;
  const int lane = threadIdx.x % 32;
  const int r0 = (threadIdx.x / 32) * kRowsPerWarp;

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* dout = static_cast<const T*>(p.dout) + b * p.o_sb + h * p.o_sh;
  const float* bias =
      p.bias == nullptr ? nullptr : p.bias + b * p.b_sb + h * p.b_sh;

  load_rows<T, DMAX>(qs, q, p.q_st, q0, kBlockRows, p.Tq, p.D, DMAX);
  load_rows<T, DMAX>(dos, dout, p.o_st, q0, kBlockRows, p.Tq, p.D, DMAX);
  load_rows<T, DMAX + 1>(ks, k, p.k_st, k0, kTile, p.Tk, p.D, DMAX);
  load_rows<T, DMAX + 1>(vs, v, p.v_st, k0, kTile, p.Tk, p.D, DMAX);
  __syncthreads();

  float s[kRowsPerWarp], dp[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) s[r] = dp[r] = 0.f;
  for (int c = 0; c < p.D; ++c) {
    const float kc = ks[lane * (DMAX + 1) + c];
    const float vc = vs[lane * (DMAX + 1) + c];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      s[r] = fmaf(qs[(r0 + r) * DMAX + c], kc, s[r]);
      dp[r] = fmaf(dos[(r0 + r) * DMAX + c], vc, dp[r]);
    }
  }

  const int key = k0 + lane;
  float* ds_out = static_cast<float*>(p.out0);
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int t = q0 + r0 + r;
    if (t >= p.Tq || key >= p.Tk) continue;
    const long long row = (long long)bh * p.Tq + t;
    float pr, ds;
    p_and_ds<false>(p, bias, s[r], dp[r], p.lse[row], p.delta[row], t, key,
                    &pr, &ds);
    ds_out[row * p.Tk + key] = ds;
  }
}

// ---- launches --------------------------------------------------------------

enum Which {
  kDq = 0,
  kDkv = 1,
  kDbias = 2,
  kDqPartial = 3,
  kDkvPartial = 4,
  kDkvPartialTc = 5,
  kDqPartialTc = 6
};

template <typename Kernel>
int launch(Kernel kernel, dim3 grid, size_t smem_floats, const Params& p,
           cudaStream_t stream, size_t smem_bytes = 0) {
  const size_t smem = smem_bytes ? smem_bytes : smem_floats * sizeof(float);
  if (smem > 48 * 1024) {  // above 48 KB only as opted-in dynamic memory
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int DMAX>
int launch_which(int which, const Params& p, cudaStream_t stream) {
  const int q_tiles = (p.Tq + kBlockRows - 1) / kBlockRows;
  const int k_tiles = (p.Tk + kBlockRows - 1) / kBlockRows;
  switch (which) {
    case kDq:  // bf16 on the tensor cores, f32 on the scalar kernel
      if constexpr (std::is_same<T, __nv_bfloat16>::value)
        return launch(flash_dq_tc_kernel<DMAX, false>,
                      dim3(p.B * p.H, (p.Tq + kTcRows - 1) / kTcRows), 0, p,
                      stream, DqTc<DMAX>::kSmem);
      else
        return launch(flash_dq_kernel<T, T, DMAX, false>,
                      dim3(p.B * p.H, q_tiles), dq_smem_floats<DMAX>(), p,
                      stream);
    case kDkv:  // bf16 on the tensor cores, f32 on the scalar kernel
      if constexpr (std::is_same<T, __nv_bfloat16>::value)
        return launch(flash_dkv_tc_kernel<DMAX>,
                      dim3(p.B * p.H, (p.Tk + kTcKeys - 1) / kTcKeys), 0, p,
                      stream, DkvTc<DMAX>::kSmem);
      else
        return launch(flash_dkv_kernel<T, T, DMAX, false>,
                      dim3(p.B * p.H, k_tiles), dkv_smem_floats<DMAX>(), p,
                      stream);
    case kDqPartial:  // dO in f32
      return launch(flash_dq_kernel<T, float, DMAX, true>,
                    dim3(p.B * p.H, q_tiles), dq_smem_floats<DMAX>(), p,
                    stream);
    case kDqPartialTc:  // bf16 q, k, v only
      if constexpr (std::is_same<T, __nv_bfloat16>::value)
        return launch(flash_dq_tc_kernel<DMAX, true>,
                      dim3(p.B * p.H, (p.Tq + kTcRows - 1) / kTcRows), 0, p,
                      stream, DqTc<DMAX, true>::kSmem);
      return (int)cudaErrorInvalidValue;
    case kDkvPartial:
      return launch(flash_dkv_kernel<T, float, DMAX, true>,
                    dim3(p.B * p.H, k_tiles), dkv_smem_floats<DMAX>(), p,
                    stream);
    case kDkvPartialTc:  // bf16 q, k, v only
      if constexpr (std::is_same<T, __nv_bfloat16>::value)
        return launch(flash_dkv_partial_tc_kernel<DMAX>,
                      dim3(p.B * p.H, (p.Tk + kTcKeys - 1) / kTcKeys), 0, p,
                      stream, DkvPartialTc<DMAX>::kSmem);
      return (int)cudaErrorInvalidValue;
    case kDbias:
      return launch(flash_dbias_kernel<T, DMAX>,
                    dim3(p.B * p.H, q_tiles, (p.Tk + kTile - 1) / kTile),
                    dq_smem_floats<DMAX>(), p, stream);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_for_dim(int which, const Params& p, cudaStream_t stream) {
  if (p.D <= 32) return launch_which<T, 32>(which, p, stream);
  if (p.D <= 64) return launch_which<T, 64>(which, p, stream);
  if (p.D <= 128) return launch_which<T, 128>(which, p, stream);
  return (int)cudaErrorInvalidValue;
}

int run(int which, const void* q, const void* k, const void* v,
        const void* bias, const void* dout, const void* lse,
        const void* delta, void* out0, void* out1, int is_bf16, int B, int H,
        int Tq, int Tk, int D, long long q_sb, long long q_sh, long long q_st,
        long long k_sb, long long k_sh, long long k_st, long long v_sb,
        long long v_sh, long long v_st, long long o_sb, long long o_sh,
        long long o_st, long long b_sb, long long b_sh, long long b_sq,
        long long b_sk, float scale, int causal, int causal_offset,
        void* stream) {
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.bias = static_cast<const float*>(bias);
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.out0 = out0;
  p.out1 = out1;
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
  p.o_sb = o_sb;
  p.o_sh = o_sh;
  p.o_st = o_st;
  p.b_sb = b_sb;
  p.b_sh = b_sh;
  p.b_sq = b_sq;
  p.b_sk = b_sk;
  p.scale = scale;
  p.causal = causal;
  p.causal_offset = causal_offset;
  const long long strides[12] = {q_sb, q_sh, q_st, k_sb, k_sh, k_st,
                                 v_sb, v_sh, v_st, o_sb, o_sh, o_st};
  const void* ptrs[4] = {q, k, v, dout};
  p.vec = D % 8 == 0;
  for (long long st : strides) p.vec = p.vec && st % 8 == 0;
  for (const void* ptr : ptrs)
    p.vec = p.vec && reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  if (which == kDkvPartialTc || which == kDqPartialTc) {
    // 16-byte rows: q, k, v bf16 (8 values), dO f32 (4 values)
    bool rows = D % 8 == 0;
    for (int i = 0; i < 12; ++i)
      rows = rows && strides[i] % (i < 9 ? 8 : 4) == 0;
    for (const void* ptr : ptrs)
      rows = rows && reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
    if (!rows || !is_bf16) return (int)cudaErrorInvalidValue;
    p.vec = 1;  // every bf16 row copies in 16-byte pieces
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_for_dim<__nv_bfloat16>(which, p, s)
                 : launch_for_dim<float>(which, p, s);
}

}  // namespace

// Each entry returns cudaGetLastError() after its launch (0 = launched).
// The three share one argument list: out0/out1 are dq/unused, dk/dv, and
// ds/unused.  The caller checks shapes, dtypes and strides before calling.
#define BWD_ARGS                                                             \
  const void *q, const void *k, const void *v, const void *bias,            \
      const void *dout, const void *lse, const void *delta, void *out0,      \
      void *out1, int is_bf16, int B, int H, int Tq, int Tk, int D,          \
      long long q_sb, long long q_sh, long long q_st, long long k_sb,        \
      long long k_sh, long long k_st, long long v_sb, long long v_sh,        \
      long long v_st, long long o_sb, long long o_sh, long long o_st,        \
      long long b_sb, long long b_sh, long long b_sq, long long b_sk,        \
      float scale, int causal, int causal_offset, void *stream
#define BWD_CALL(which)                                                      \
  run(which, q, k, v, bias, dout, lse, delta, out0, out1, is_bf16, B, H, Tq, \
      Tk, D, q_sb, q_sh, q_st, k_sb, k_sh, k_st, v_sb, v_sh, v_st, o_sb,     \
      o_sh, o_st, b_sb, b_sh, b_sq, b_sk, scale, causal, causal_offset,      \
      stream)

// #2 and #3: f32 on the scalar kernels, bf16 on the tensor cores
extern "C" int flash_attention_dq(BWD_ARGS) { return BWD_CALL(kDq); }
extern "C" int flash_attention_dkv(BWD_ARGS) { return BWD_CALL(kDkv); }
extern "C" int flash_attention_dbias(BWD_ARGS) { return BWD_CALL(kDbias); }

// The partial kernels (#6, #7) take no bias, dO in f32 and the chunks'
// global positions; out0/out1 are f32 dq/unused and dk/dv.  With
// tensor_cores set, #6 runs flash_dq_tc_kernel<D, true> and #7
// flash_dkv_partial_tc_kernel (bf16 q, k, v and 16-byte rows, else an
// error); else the scalar templates.
#define PARTIAL_ARGS                                                         \
  const void *q, const void *k, const void *v, const void *dout,            \
      const void *lse, const void *delta, void *out0, void *out1,           \
      int is_bf16, int tensor_cores, int B, int H, int Tq, int Tk, int D,   \
      long long q_sb,                                                       \
      long long q_sh, long long q_st, long long k_sb, long long k_sh,       \
      long long k_st, long long v_sb, long long v_sh, long long v_st,       \
      long long o_sb, long long o_sh, long long o_st, float scale,          \
      int causal, int q_offset, int k_offset, void *stream
#define PARTIAL_CALL(which)                                                  \
  run(which, q, k, v, nullptr, dout, lse, delta, out0, out1, is_bf16, B, H, \
      Tq, Tk, D, q_sb, q_sh, q_st, k_sb, k_sh, k_st, v_sb, v_sh, v_st,      \
      o_sb, o_sh, o_st, 0, 0, 0, 0, scale, causal, q_offset - k_offset,     \
      stream)

extern "C" int flash_attention_dq_partial(PARTIAL_ARGS) {
  return PARTIAL_CALL(tensor_cores ? kDqPartialTc : kDqPartial);
}
extern "C" int flash_attention_dkv_partial(PARTIAL_ARGS) {
  return PARTIAL_CALL(tensor_cores ? kDkvPartialTc : kDkvPartial);
}
