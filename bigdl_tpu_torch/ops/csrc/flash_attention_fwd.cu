// Flash-attention forward for Hopper (sm_90a), plain C interface: two
// entry points over one kernel template.
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
// the f32 rate of the CUDA cores (no tensor cores here).  The design
// answers the first: one block covers a whole 16-row query tile of one
// (batch, head), so each K/V element is read from device memory once
// per query tile (once per decode step), the bias is read through its
// strides and never materialised per head, and no score matrix is ever
// written to device memory.  Tensor cores (wgmma) and TMA are later work.
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
// and state and are bound by operations: the design answer is #1's (K/V
// read once per 16-row query tile, no score matrix in device memory, tiles
// above the diagonal skipped); tensor cores are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

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

template <typename T, int DMAX, bool kPartial>
__global__ void __launch_bounds__(kWarps * 32)
    flash_fwd_kernel(const Params p) {
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
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
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

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * kBlockK;
    __syncthreads();  // the previous tile's reads are done
    for (int i = tid; i < kBlockK * DMAX; i += blockDim.x) {
      const int j = i / DMAX, c = i % DMAX, t = k0 + j;
      const bool ok = t < p.Tk && c < p.D;
      ks[j][c] = ok ? to_f32(k[t * p.k_st + c]) : 0.f;
      vs[j][c] = ok ? to_f32(v[t * p.v_st + c]) : 0.f;
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
      const float m_new = fmaxf(m[r], warp_max(x));  // finite: key k0 exists
      const float pr = key_ok ? expf(x - m_new) : 0.f;
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + warp_sum(pr);
      m[r] = m_new;
      const float pv = to_f32(from_f32<T>(pr));  // P in v's dtype
#pragma unroll
      for (int i = 0; i < kCols; ++i) acc[r][i] *= alpha;
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
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        const int c = lane + 32 * i;
        if (c < p.D) out[row * p.D + c] = from_f32<T>(acc[r][i] / l[r]);
      }
      if (lane == 0) p.lse[row] = m[r] + logf(l[r]);
    }
  }
}

template <typename T, int DMAX, bool kPartial>
int launch(const Params& p, cudaStream_t stream) {
  const dim3 grid(p.B * p.H, (p.Tq + kBlockQ - 1) / kBlockQ);
  flash_fwd_kernel<T, DMAX, kPartial><<<grid, kWarps * 32, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, bool kPartial>
int launch_for_dim(const Params& p, cudaStream_t stream) {
  if (p.D <= 32) return launch<T, 32, kPartial>(p, stream);
  if (p.D <= 64) return launch<T, 64, kPartial>(p, stream);
  if (p.D <= 128) return launch<T, 128, kPartial>(p, stream);
  return (int)cudaErrorInvalidValue;
}

template <bool kPartial>
int launch_for_type(int is_bf16, const Params& p, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_for_dim<__nv_bfloat16, kPartial>(p, s)
                 : launch_for_dim<float, kPartial>(p, s);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched).  The
// caller checks shapes, dtypes and strides before calling.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, const void* bias, void* out,
    void* lse, int is_bf16, int B, int H, int Tq, int Tk, int D,
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
  return launch_for_type<false>(is_bf16, p, stream);
}

// Kernel #5: merge one visiting K/V chunk into the carried state.  q is
// [B, H, Tq, D], k and v [B, H, Tk, D] (strided; head dim contiguous);
// acc_in/acc_out [B*H, Tq, D] and m/l [B*H, Tq] are contiguous f32 (the
// outputs may alias the inputs: each element is read and written by one
// thread).  q_offset and k_offset are the chunks' global positions.
extern "C" int flash_attention_partial(
    const void* q, const void* k, const void* v, const void* acc_in,
    const void* m_in, const void* l_in, void* acc_out, void* m_out,
    void* l_out, int is_bf16, int B, int H, int Tq, int Tk, int D,
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
  return launch_for_type<true>(is_bf16, p, stream);
}
