// Kernels #8, #9, #10 and #11 on the tensor cores: the forward and the
// backward of the fused 1x1 conv+BN (conv_bn_matmul_fwd in conv_bn_fwd.cu,
// conv_bn_matmul_bwd_tc in conv_bn_bwd.cu) and of the fused 3x3
// (conv_bn_conv3x3_fwd, conv_bn_conv3x3_bwd_tc), for bf16 inputs, the
// `--fused --bf16` training path.  They compute what the scalar routes
// (MatmulFwd, MatmulDz / MatmulDw, Conv3Fwd, Conv3Dz / Conv3Dw over
// tile_product) compute, at the same rounding points, and replace the same
// TPU kernels (_fwd_kernel, _bwd_kernel, _conv3_fwd_kernel,
// _conv3_bwd_kernel).  The tap count is a template parameter of every
// kernel here: 9 for the 3x3, 1 for the 1x1, which is a 3x3 with one tap
// and no halo (no shifted position, no Pos arithmetic).
//
// Why a redesign.  The scalar routes normalise x (and fold dy) again at
// every load of every pass (each element 9 x ceil(C/64) times), with
// 64-bit divisions per element, and sum with scalar f32 FMAs.  Here:
//
// 1. A prepass forms each operand once, with the scalar routes' own
//    functions (norm_relu, fold_dy), into scratch the wrapper allocates:
//      z   [M, Cp]  bf16  relu((x - mean) * scale + beta) cast to x's dtype
//      dyl [M, Cop] bf16  dy + gm + gs (y - K) cast to dy's dtype, y the
//                         forward's saved output (the backward only)
//      wp  [9, Cp, Cop] bf16, W with its channels padded
//    Cp and Cop are C and Co rounded up to 64 with zeros (the wrapper
//    picks them, tc_channels), so every 16-byte copy and every product
//    tile below is whole in the channel dims.  The 1x1 reads x as z where
//    there is no norm and K is a multiple of 64, dy as dyl where there
//    are no statistics and N is, and (#8) w as wp where K and N are.
// 2. dgrad: dz [M, C] = sum over (tap, co) of dyl(position shifted by the
//    tap) . W[tap]^T, an implicit GEMM: 128 positions x 64 channels per
//    block of 8 warps (32 x 32 each), K in 32-wide chunks of one tap,
//    three cp.async stages.  A shifted row outside the image is a 16-byte
//    copy of source size 0: it reads zeros, as the reference zeroes its
//    halo.  The epilogue is the scalar route's: du = dz where u > 0,
//    dx = du * scale cast to x's dtype, and per-tile partials of
//    sum du * x and sum du over the block's 128 rows in a fixed order
//    (each thread's rows, a shuffle tree over the 8 row groups of a warp,
//    then the 4 warps in turn).  A thread keeps the row and column of
//    each position it loads, so a shift costs no division (Pos).
// 3. wgrad: dW [9 Cp, Cop] = sum over positions of z(shifted)^T . dyl,
//    rows (tap, c), split over positions into parts of `chunk` positions
//    that the wrapper fixes from the shape alone (dw_splits,
//    tc_split_chunk); each split writes its f32 partial and reduce_dw
//    adds them in order and casts to W's dtype.  Both operands are
//    position-major in memory, so they come through ldmatrix.trans.
// 4. fprop (#10; #8 with one tap): y [M, Co] = sum over (tap, c) of
//    z(position shifted by the tap) . wp[tap], the same implicit GEMM as
//    dgrad with B (wp, contiguous along Co) through ldmatrix.trans.  The
//    halo reads zeros of z, which is exactly the reference's SAME padding
//    of z after normalize+ReLU.  The epilogue rounds y to bf16, stores the
//    real columns, and forms the statistics s1 = sum (y - K) and s2 =
//    sum (y - K)^2 from the rounded y as per-tile partials in dgrad's
//    fixed order; launch_reduce adds them.
// 5. #9 (one tap) folds the forward's saved y: the statistics were taken
//    on the rounded y the forward stored, and the fold needs that y bit
//    for bit (a y summed again in another order rounds to its other bf16
//    neighbour now and then, which moves that dyl entry by a whole ulp).
//    The reference's 1x1 recomputes y (_bwd_kernel :203-204); the port
//    saves it, as both packages save the 3x3's, so the prepass forms dyl
//    as #11's does.  Then dgrad, wgrad and the dW sum as for #11, with
//    one tap.
// 6. bf16 x bf16 -> f32 on mma.sync.m16n8k16 (tensor_core.cuh says why
//    not wgmma yet).  No float atomics: two launches give the same bits.
//
// f32 inputs keep the scalar routes (TF32 would round the operands to 10
// bits); the wrappers route by dtype and count each route.

#pragma once

#include "conv_bn_common.cuh"
#include "tensor_core.cuh"

namespace convbn {
namespace tcconv {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128;       // rows of a product tile
constexpr int kBN = 64;        // columns of a product tile
constexpr int kBK = 32;        // depth of one stage
constexpr int kStages = 3;
constexpr int kThreads = 256;  // 8 warps: 4 along rows x 2 along columns
constexpr int kLdK = kBK + 8;  // K-contiguous smem rows (dgrad)
constexpr int kLdA = kBM + 8;  // row-contiguous smem rows (wgrad A)
constexpr int kLdB = kBN + 8;  // column-contiguous smem rows (wgrad B)

// the arrays of one launch; kTaps is 9 (3x3) or 1 (1x1)
struct Problem {
  const bf16* x;    // [M, C]
  const bf16* w;    // [kTaps, C, Co]
  const bf16* y;    // [M, Co], the saved forward output (#9, #11)
  const bf16* dy;   // [M, Co]
  bf16* z;          // [M, Cp] scratch (#8, #9: x itself where pre_z is 0)
  bf16* dyl;        // [M, Cop] scratch (#9: dy itself where pre_dyl is 0)
  bf16* wp;         // [kTaps, Cp, Cop] scratch (#8: w itself where pre_w
                    // is 0)
  bf16* dx;         // [M, C]
  bf16* dw;         // [kTaps, C, Co]
  float* part;      // [splits, kTaps Cp, Cop]
  float *psx, *psu; // [ceil(M / 128), C]
  bf16* yf;         // [M, Co], the forward's output
  float *ps1, *ps2; // [ceil(M / 128), Co], the forward's statistics
  const float *mean, *scale, *beta, *kshift, *gm, *gs;
  Image img;           // the 3x3's image batch (unused with one tap)
  long long M, chunk;  // positions, and positions per dW split
  int C, Co, Cp, Cop, splits, fuse, stats;
  int pre_z, pre_dyl, pre_w;  // whether the prepass stores z, dyl and wp
};

// ---- 1. the prepass -------------------------------------------------------

// z of one entry as the reference forms it: relu((x - mean) * scale +
// beta) cast to x's dtype (bf16), or x itself without a norm
__device__ __forceinline__ bf16 z_entry(float x, float mean, float scale,
                                        float beta, int fuse) {
  return from_f32<bf16>(fuse ? norm_relu<bf16>(x, mean, scale, beta) : x);
}

// dyl of one entry as the reference forms it: dy folded with the
// statistics cotangents, cast to dy's dtype (bf16)
__device__ __forceinline__ bf16 dyl_entry(float dy, float y, float gm,
                                          float gs, float k, int stats) {
  return from_f32<bf16>(fold_dy<bf16>(dy, y, gm, gs, k, stats));
}

// 8 consecutive entries of a row, from element `at` on, in f32, zero from
// the n-th on: one 16-byte load where `vec` (rows a multiple of 8 entries
// long, on 16 bytes) and all 8 are real, else entry by entry
__device__ __forceinline__ void load8(float (&v)[8], const bf16* src,
                                      long long at, int n, bool vec) {
  if (vec && n >= 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(src + at);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[2 * j] = __low2float(h[j]);
      v[2 * j + 1] = __high2float(h[j]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = j < n ? to_f32(src[at + j]) : 0.f;
  }
}

// 8 consecutive f32 entries of a per-channel vector from c0 on, zero from
// the n-th on: two 16-byte loads where `vec` and all 8 are real
__device__ __forceinline__ void load8(float (&v)[8], const float* src,
                                      int c0, int n, bool vec) {
  if (vec && n >= 8) {
    const float4 a = *reinterpret_cast<const float4*>(src + c0);
    const float4 b = *reinterpret_cast<const float4*>(src + c0 + 4);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
    v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = j < n ? src[c0 + j] : 0.f;
  }
}

// whether rows of `row` entries from `base` on start on 16 bytes, in
// whole 8-entry chunks, for each base given
template <typename... Ptrs>
__device__ __forceinline__ bool rows16(int row, const Ptrs*... bases) {
  return row % 8 == 0 &&
         ((reinterpret_cast<uintptr_t>(bases) % 16 == 0) && ...);
}

// one thread per 8 consecutive channels of a row of z (with pre_z), dyl
// (with pre_dyl: the backward) or wp (with pre_w)
template <int kTaps>
__global__ void __launch_bounds__(256) prepass(const Problem p) {
  const long long nz = p.pre_z ? p.M * (p.Cp / 8) : 0;
  const long long ndy = p.pre_dyl ? p.M * (p.Cop / 8) : 0;
  const long long nw = p.pre_w ? (long long)kTaps * p.Cp * (p.Cop / 8) : 0;
  const long long total = nz + ndy + nw;
  const bool x_vec = rows16(p.C, p.x, p.mean, p.scale, p.beta);
  const bool dy_vec = ndy > 0 && rows16(p.Co, p.dy, p.gm, p.gs, p.kshift) &&
                      (!p.stats || rows16(p.Co, p.y));
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    __align__(16) bf16 out[8];
    bf16* dst;
    if (i < nz) {
      const long long m = i / (p.Cp / 8);
      const int c0 = (int)(i % (p.Cp / 8)) * 8;
      float xv[8], mean[8], scale[8], beta[8];
      load8(xv, p.x, m * p.C + c0, p.C - c0, x_vec);
      load8(mean, p.mean, c0, p.C - c0, x_vec);
      load8(scale, p.scale, c0, p.C - c0, x_vec);
      load8(beta, p.beta, c0, p.C - c0, x_vec);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        out[j] = c0 + j < p.C
                     ? z_entry(xv[j], mean[j], scale[j], beta[j], p.fuse)
                     : from_f32<bf16>(0.f);
      dst = p.z + m * p.Cp + c0;
    } else if (i < nz + ndy) {
      const long long r = i - nz;
      const long long m = r / (p.Cop / 8);
      const int c0 = (int)(r % (p.Cop / 8)) * 8;
      float dyv[8], yv[8] = {}, gm[8], gs[8], kshift[8];
      load8(dyv, p.dy, m * p.Co + c0, p.Co - c0, dy_vec);
      if (p.stats) load8(yv, p.y, m * p.Co + c0, p.Co - c0, dy_vec);
      load8(gm, p.gm, c0, p.Co - c0, dy_vec);
      load8(gs, p.gs, c0, p.Co - c0, dy_vec);
      load8(kshift, p.kshift, c0, p.Co - c0, dy_vec);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        out[j] = c0 + j < p.Co
                     ? dyl_entry(dyv[j],
                                 p.stats ? yv[j] : 0.f, gm[j],
                                 gs[j], kshift[j], p.stats)
                     : from_f32<bf16>(0.f);
      dst = p.dyl + m * p.Cop + c0;
    } else {
      const long long r = i - nz - ndy;
      const long long row = r / (p.Cop / 8);  // tap * Cp + c
      const int co0 = (int)(r % (p.Cop / 8)) * 8;
      const int tap = (int)(row / p.Cp), c = (int)(row % p.Cp);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int co = co0 + j;
        out[j] = (c < p.C && co < p.Co)
                     ? p.w[((long long)tap * p.C + c) * p.Co + co]
                     : from_f32<bf16>(0.f);
      }
      dst = p.wp + row * p.Cop + co0;
    }
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(out);
  }
}

// ---- the product tiles ----------------------------------------------------

// 16 bytes of row `pos` of a [rows, ld] operand at column c, or zeros
// where pos < 0 (the image's halo, or a row beyond the problem); `own` is
// a row inside the operand, whose address stands in for an outside one
__device__ __forceinline__ void load_row16(bf16* dst, const bf16* base,
                                           long long pos, long long own,
                                           int ld, int c) {
  const bool halo = pos < 0;
  tc::cp_async16(dst, base + (halo ? own : pos) * ld + c, !halo);  // the halo reads zeros
}

// A position m of the image batch with its row h and column w, so that a
// shift costs no division: the main loops move it along by additions.
// With one tap (the 1x1) only m is kept, and a shift is the position.
template <int kTaps>
struct Pos {
  long long m;
  int h, w;
  __device__ __forceinline__ void set(const Image& img, long long at) {
    m = at;
    if constexpr (kTaps > 1) {
      w = (int)(at % img.W);
      h = (int)(at / img.W % img.H);
    }
  }
  // m + step, with step % W and step / W % H given as dw and dh
  __device__ __forceinline__ void advance(const Image& img, long long step,
                                          int dh, int dw) {
    m += step;
    if constexpr (kTaps > 1) {
      w += dw;
      const int carry = w >= img.W;
      w -= carry ? img.W : 0;
      h += dh + carry;
      h -= h >= img.H ? img.H : 0;
    }
  }
  // the flat index of this position shifted by (dh, dw), or -1 outside
  // the image or at m >= end
  __device__ __forceinline__ long long shifted(const Image& img,
                                               long long end, int dh,
                                               int dw) const {
    if (m >= end) return -1;
    if constexpr (kTaps == 1) return m;
    const int hh = h + dh, ww = w + dw;
    if (hh < 0 || hh >= img.H || ww < 0 || ww >= img.W) return -1;
    return m + (long long)dh * img.W + dw;
  }
};

using Acc = float[2][4][4];  // [16-row tile][8-column tile][fragment]

__device__ __forceinline__ void zero(Acc& acc) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

// The cp.async ring: load(stage, kstep) issues one stage's copies,
// compute(stage) consumes one; nk stages in all.
template <class Load, class Compute>
__device__ __forceinline__ void mainloop(int nk, Load load, Compute compute) {
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(s, s);
    tc::cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    tc::cp_async_wait<kStages - 2>();
    __syncthreads();  // stage kt landed; stage kt - 1 is free for reuse
    const int next = kt + kStages - 1;
    if (next < nk) load(next % kStages, next);
    tc::cp_async_commit();
    compute(kt % kStages);
  }
  tc::cp_async_wait<0>();
  __syncthreads();
}

// ---- 2. dgrad -------------------------------------------------------------

template <int kTaps>
__global__ void __launch_bounds__(kThreads, 3) dgrad(const Problem p) {
  __shared__ __align__(16) bf16 As[kStages][kBM][kLdK];
  __shared__ __align__(16) bf16 Bs[kStages][kBN][kLdK];
  __shared__ float sums[2][4][kBN];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp % 4, wn = warp / 4, g = lane / 4, t4 = lane % 4;
  const long long m0 = (long long)blockIdx.x * kBM;
  const int c0 = blockIdx.y * kBN;
  const int nco = p.Cop / kBK;  // chunks per tap

  // this thread's two A rows (fixed over K) and its B row
  const int a_ch = tid % 4;
  Pos<kTaps> a_m[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) a_m[i].set(p.img, m0 + (tid + i * kThreads) / 4);

  auto load = [&](int st, int kc) {
    const int tap = kc / nco, co0 = (kc % nco) * kBK;
    // dz at (h, w) takes dyl at (h + 1 - dh, w + 1 - dw)
    const int dh = 1 - tap / 3, dw = 1 - tap % 3;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = (tid + i * kThreads) / 4;
      const long long pos = a_m[i].shifted(p.img, p.M, dh, dw);
      load_row16(&As[st][r][a_ch * 8], p.dyl, pos,
                 a_m[i].m < p.M ? a_m[i].m : 0, p.Cop, co0 + a_ch * 8);
    }
    const int r = tid / 4;
    tc::cp_async16(&Bs[st][r][a_ch * 8],
                   p.wp + ((long long)tap * p.Cp + c0 + r) * p.Cop + co0 +
                       a_ch * 8,
                   true);
  };

  // Two-level sums: each stage's 32-deep product goes into a fresh f32
  // tile, added to the running sum with one rounded add per entry.  The
  // tensor cores' own f32 accumulation drops the low bits of its addends
  // (it does not round to nearest), so over 9 * Co products it would
  // drift from the plain version's f32 sums by far more than their
  // rounding; dz feeds the f32 channel sums sum du * x and sum du.
  Acc acc;
  zero(acc);
  auto compute = [&](int st) {
    Acc part;
    zero(part);
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      uint32_t a[2][4], b[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        tc::ldmatrix_x4(a[mi], &As[st][wm * 32 + mi * 16 + lane % 16]
                                  [ks * 16 + (lane / 16) * 8]);
#pragma unroll
      for (int np = 0; np < 2; ++np)
        tc::ldmatrix_x4(b[np],
                        &Bs[st][wn * 32 + np * 16 + lane % 8 + (lane / 16) * 8]
                           [ks * 16 + ((lane / 8) % 2) * 8]);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          tc::mma_bf16(part[mi][ni], a[mi], b[ni / 2][(ni % 2) * 2],
                       b[ni / 2][(ni % 2) * 2 + 1]);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[mi][ni][e] = __fadd_rn(acc[mi][ni][e], part[mi][ni][e]);
  };
  mainloop(kTaps * nco, load, compute);

  // epilogue: du, dx and the per-tile channel partials
  float c1[4][2], c2[4][2];
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int e = 0; e < 2; ++e) c1[ni][e] = c2[ni][e] = 0.f;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long m = m0 + wm * 32 + mi * 16 + g + half * 8;
      if (m >= p.M) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = c0 + wn * 32 + ni * 8 + 2 * t4 + e;
          if (c >= p.C) continue;
          const float dz = acc[mi][ni][half * 2 + e];
          const long long at = m * p.C + c;
          if (p.fuse) {
            const float xv = to_f32(p.x[at]);
            const float u = bn_input(xv, p.mean[c], p.scale[c], p.beta[c]);
            const float du = u > 0.f ? dz : 0.f;
            c1[ni][e] += __fmul_rn(du, xv);
            c2[ni][e] += du;
            p.dx[at] = from_f32<bf16>(__fmul_rn(du, p.scale[c]));
          } else {
            p.dx[at] = from_f32<bf16>(dz);
          }
        }
    }
  if (!p.fuse) return;  // uniform over the block
  // over the warp's 8 row groups, then its 4 warps along the rows
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int off = 4; off < 32; off *= 2) {
        c1[ni][e] += __shfl_xor_sync(0xffffffffu, c1[ni][e], off);
        c2[ni][e] += __shfl_xor_sync(0xffffffffu, c2[ni][e], off);
      }
  if (g == 0)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = wn * 32 + ni * 8 + 2 * t4 + e;
        sums[0][wm][col] = c1[ni][e];
        sums[1][wm][col] = c2[ni][e];
      }
  __syncthreads();
  if (tid < kBN && c0 + tid < p.C) {
    float t1 = 0.f, t2 = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      t1 += sums[0][i][tid];
      t2 += sums[1][i][tid];
    }
    p.psx[(long long)blockIdx.x * p.C + c0 + tid] = t1;
    p.psu[(long long)blockIdx.x * p.C + c0 + tid] = t2;
  }
}

// ---- 3. wgrad -------------------------------------------------------------

template <int kTaps>
__global__ void __launch_bounds__(kThreads) wgrad(const Problem p) {
  __shared__ __align__(16) bf16 As[kStages][kBK][kLdA];  // [position][row]
  __shared__ __align__(16) bf16 Bs[kStages][kBK][kLdB];  // [position][col]
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp % 4, wn = warp / 4, g = lane / 4, t4 = lane % 4;
  const int r0 = blockIdx.x * kBM;  // rows (tap, c) of dW
  const int n0 = blockIdx.y * kBN;  // output channels
  const int rows = kTaps * p.Cp;

  const long long begin = blockIdx.z * p.chunk;
  const long long end = begin + p.chunk < p.M ? begin + p.chunk : p.M;
  const int nk = end > begin ? (int)((end - begin + kBK - 1) / kBK) : 0;

  // this thread's A column chunk (fixed): 8 channels of one tap
  const int a_j = tid % 16;
  const int a_row = r0 + a_j * 8;
  const int a_tap = a_row / p.Cp, a_c = a_row % p.Cp;
  // dW row (dh, dw, c) sums z at (h + dh - 1, w + dw - 1)
  const int a_dh = a_tap / 3 - 1, a_dw = a_tap % 3 - 1;
  const int b_ch = tid % 8;
  // this thread's two A positions of the next stage to load (the stages
  // are loaded in order, kBK positions apart)
  Pos<kTaps> a_m[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    a_m[i].set(p.img, begin + (tid + i * kThreads) / 16);
  int step_w = 0, step_h = 0;
  if constexpr (kTaps > 1) {
    step_w = kBK % p.img.W;
    step_h = kBK / p.img.W % p.img.H;
  }

  auto load = [&](int st, int kt) {
    const long long kbase = begin + (long long)kt * kBK;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int kr = (tid + i * kThreads) / 16;
      const long long pos =
          a_row < rows ? a_m[i].shifted(p.img, end, a_dh, a_dw) : -1;
      load_row16(&As[st][kr][a_j * 8], p.z, pos,
                 a_m[i].m < end ? a_m[i].m : 0, p.Cp,
                 a_row < rows ? a_c : 0);
      a_m[i].advance(p.img, kBK, step_h, step_w);
    }
    const int kr = tid / 8;
    const long long m = kbase + kr;
    tc::cp_async16(&Bs[st][kr][b_ch * 8],
                   p.dyl + (m < end ? m : 0) * p.Cop + n0 + b_ch * 8,
                   m < end);
  };

  Acc acc;
  zero(acc);
  auto compute = [&](int st) {
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      uint32_t a[2][4], b[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        tc::ldmatrix_x4_trans(
            a[mi], &As[st][ks * 16 + lane % 8 + (lane / 16) * 8]
                      [wm * 32 + mi * 16 + ((lane / 8) % 2) * 8]);
#pragma unroll
      for (int np = 0; np < 2; ++np)
        tc::ldmatrix_x4_trans(
            b[np], &Bs[st][ks * 16 + lane % 8 + ((lane / 8) % 2) * 8]
                      [wn * 32 + np * 16 + (lane / 16) * 8]);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          tc::mma_bf16(acc[mi][ni], a[mi], b[ni / 2][(ni % 2) * 2],
                       b[ni / 2][(ni % 2) * 2 + 1]);
    }
  };
  mainloop(nk, load, compute);

  float* out = p.part + (long long)blockIdx.z * rows * p.Cop;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + wm * 32 + mi * 16 + g + half * 8;
      if (r >= rows) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = n0 + wn * 32 + ni * 8 + 2 * t4;
        *reinterpret_cast<float2*>(out + (long long)r * p.Cop + col) =
            make_float2(acc[mi][ni][half * 2], acc[mi][ni][half * 2 + 1]);
      }
    }
}

// dW [kTaps, C, Co] = the splits' partials added in order, cast to W's
// dtype
template <int kTaps>
__global__ void reduce_dw(const Problem p) {
  const long long n = (long long)kTaps * p.C * p.Co;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int co = (int)(i % p.Co);
  const long long t = i / p.Co;
  const int c = (int)(t % p.C), tap = (int)(t / p.C);
  const long long at = ((long long)tap * p.Cp + c) * p.Cop + co;
  const long long step = (long long)kTaps * p.Cp * p.Cop;
  float tot = 0.f;
  for (int s = 0; s < p.splits; ++s) tot += p.part[s * step + at];
  p.dw[i] = from_f32<bf16>(tot);
}

// ---- 4. fprop (#10, #8) -----------------------------------------------------

// y on the tensor cores, then the epilogue stores y and its statistics
// partials
template <int kTaps>
__global__ void __launch_bounds__(kThreads, 2) fprop(const Problem p) {
  __shared__ __align__(16) bf16 As[kStages][kBM][kLdK];  // [position][c]
  __shared__ __align__(16) bf16 Bs[kStages][kBK][kLdB];  // [c][co]
  __shared__ float sums[2][4][kBN];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp % 4, wn = warp / 4, g = lane / 4, t4 = lane % 4;
  const long long m0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int ncp = p.Cp / kBK;  // chunks per tap

  // this thread's two A rows (fixed over K), each with its own h and w:
  // a tile may span several images
  const int a_ch = tid % 4, b_ch = tid % 8;
  Pos<kTaps> a_m[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) a_m[i].set(p.img, m0 + (tid + i * kThreads) / 4);

  auto load = [&](int st, int kc) {
    const int tap = kc / ncp, c0 = (kc % ncp) * kBK;
    // y at (h, w) takes z at (h + dh - 1, w + dw - 1) for tap (dh, dw)
    const int dh = tap / 3 - 1, dw = tap % 3 - 1;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = (tid + i * kThreads) / 4;
      const long long pos = a_m[i].shifted(p.img, p.M, dh, dw);
      load_row16(&As[st][r][a_ch * 8], p.z, pos,
                 a_m[i].m < p.M ? a_m[i].m : 0, p.Cp, c0 + a_ch * 8);
    }
    const int kr = tid / 8;
    tc::cp_async16(&Bs[st][kr][b_ch * 8],
                   p.wp + ((long long)tap * p.Cp + c0 + kr) * p.Cop + n0 +
                       b_ch * 8,
                   true);
  };

  Acc acc;
  zero(acc);
  auto compute = [&](int st) {
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      uint32_t a[2][4], b[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        tc::ldmatrix_x4(a[mi], &As[st][wm * 32 + mi * 16 + lane % 16]
                                  [ks * 16 + (lane / 16) * 8]);
#pragma unroll
      for (int np = 0; np < 2; ++np)
        tc::ldmatrix_x4_trans(
            b[np], &Bs[st][ks * 16 + lane % 8 + ((lane / 8) % 2) * 8]
                      [wn * 32 + np * 16 + (lane / 16) * 8]);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          tc::mma_bf16(acc[mi][ni], a[mi], b[ni / 2][(ni % 2) * 2],
                       b[ni / 2][(ni % 2) * 2 + 1]);
    }
  };
  mainloop(kTaps * ncp, load, compute);

  // epilogue: y cast to bf16 into a [kBM][kBN] tile in shared memory (A's
  // stages, free once the main loop is done), with the statistics of the
  // rounded y; then the tile's rows to y, 16 bytes a thread where Co is a
  // multiple of 8 (whole 128-byte rows of a warp), else entry by entry
  bf16(*ys)[kBN + 8] = reinterpret_cast<bf16(*)[kBN + 8]>(&As[0][0][0]);
  float c1[4][2], c2[4][2];
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int e = 0; e < 2; ++e) c1[ni][e] = c2[ni][e] = 0.f;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = wm * 32 + mi * 16 + g + half * 8;
      const bool real = m0 + r < p.M;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = wn * 32 + ni * 8 + 2 * t4;
        const float y0 = acc[mi][ni][half * 2], y1 = acc[mi][ni][half * 2 + 1];
        const __nv_bfloat162 y2 = __floats2bfloat162_rn(y0, y1);
        *reinterpret_cast<__nv_bfloat162*>(&ys[r][col]) = y2;
        const float yv[2] = {__low2float(y2), __high2float(y2)};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int co = n0 + col + e;
          if (!real || co >= p.Co) continue;
          const float d = __fsub_rn(yv[e], p.kshift[co]);
          c1[ni][e] += d;
          c2[ni][e] += __fmul_rn(d, d);
        }
      }
    }
  __syncthreads();
  const bool vec = p.Co % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(p.yf) % 16 == 0;
  for (int i = tid; i < kBM * (kBN / 8); i += kThreads) {
    const int r = i / (kBN / 8), c = (i % (kBN / 8)) * 8;
    const long long m = m0 + r;
    const int co = n0 + c;
    if (m >= p.M || co >= p.Co) continue;
    bf16* dst = p.yf + m * p.Co + co;
    if (vec) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(&ys[r][c]);
    } else {
      for (int j = 0; j < 8 && co + j < p.Co; ++j) dst[j] = ys[r][c + j];
    }
  }
  if (!p.stats) return;  // uniform over the block
  // over the warp's 8 row groups, then its 4 warps along the rows
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int off = 4; off < 32; off *= 2) {
        c1[ni][e] += __shfl_xor_sync(0xffffffffu, c1[ni][e], off);
        c2[ni][e] += __shfl_xor_sync(0xffffffffu, c2[ni][e], off);
      }
  if (g == 0)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = wn * 32 + ni * 8 + 2 * t4 + e;
        sums[0][wm][col] = c1[ni][e];
        sums[1][wm][col] = c2[ni][e];
      }
  __syncthreads();
  if (tid < kBN && n0 + tid < p.Co) {
    float t1 = 0.f, t2 = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      t1 += sums[0][i][tid];
      t2 += sums[1][i][tid];
    }
    p.ps1[(long long)blockIdx.x * p.Co + n0 + tid] = t1;
    p.ps2[(long long)blockIdx.x * p.Co + n0 + tid] = t2;
  }
}

}  // namespace tcconv
}  // namespace convbn
