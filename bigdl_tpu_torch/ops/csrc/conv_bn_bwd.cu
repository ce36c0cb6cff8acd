// Fused conv+BN backward for Hopper (sm_90a), plain C interface: kernels #9
// and #11 of the port.
//
// Replaces the TPU kernels of bigdl_tpu/ops/conv_bn_kernels.py:
//   conv_bn_matmul_bwd   <- _fused_bwd / _bwd_kernel        (pallas_call :317)
//   conv_bn_conv3x3_bwd  <- _conv3_bwd / _conv3_bwd_kernel  (pallas_call :708)
// and computes what they compute, from the saved inputs and the
// cotangents dy, gm (of s1) and gs (of s2, already doubled outside, as
// _fused_bwd :303-307 does):
//
//   z    = relu((x - mean) * scale + beta) cast to x's dtype (or x)
//   dyl  = (dy + gm + gs * (y - K)) cast to dy's dtype       (with stats)
//        = dy                                                (without)
//          where y is the forward's rounded output, saved by the
//          forward: the reference saves the 3x3's (:549-556) and
//          recomputes the 1x1's as (z . W) cast to dy's dtype (:203-205),
//          the same values; the port saves both
//   dW   = z^T . dyl (the 3x3: nine shifted tiles), f32, cast to W's dtype
//   dz   = dyl . W^T (the 3x3: the transposed conv, taps flipped)
//   du   = dz where u = (x - mean) * scale + beta > 0, else 0
//   dsx  = sum du * x (x in f32, not z), dsu = sum du         (f32)
//   dx   = du * scale cast to x's dtype   (without a norm: dx = dz)
//
// dmean, dscale and dbeta are C-sized algebra on dsx and dsu outside (as
// _fused_bwd :334-343 and _conv3_bwd :723-728 keep them).  The 3x3 pads z
// and dyl with zeros outside the image, as the halo rows of the reference
// are zeroed after normalize+ReLU and masked at the image edge.
//
// The Pallas kernel does all of this in one sequential pass over row
// blocks with dW and the channel sums resident.  Here each entry point
// runs the products as separate passes over a parallel grid (the shared
// tiled product of conv_bn_common.cuh), then fixed-order reductions:
//   dz pass:  one block per 64 x 64 tile of dx; dyl is folded as it is
//             loaded (never stored), dx and the per-tile channel sums are
//             written from registers;
//   dW pass:  split over rows into `splits` parts (a fixed count the
//             wrapper picks to fill the card while keeping the f32
//             partials small), each part's [rows_w, cols] sums written to
//             `dw_part`;
//   reductions: dW = the parts added in order, cast to W's dtype; dsx and
//             dsu = the per-tile sums added in order.
// No float atomics: two launches give the same bits.
//
// What bounds them on an H100.  The 3x3: operations (36 * B * H * W * C *
// Co) at the bf16 tensor-core rate.  The 1x1: bytes at ResNet-50's widths
// (4 * M * K * N operations on M * (K + 2N) rows of inputs and outputs:
// K and N of 64-2048 leave it under the card's 295 operations a byte).
// conv_bn_matmul_bwd and conv_bn_conv3x3_bwd run scalar f32 FMAs on the
// CUDA cores, f32 only; z and dyl are recomputed where they are loaded
// instead of stored.  bf16 takes the tensor-core routes of conv_bn_tc.cuh:
// conv_bn_matmul_bwd_tc (#9: a prepass that stores z, dyl folded from the
// saved y and a padded W where x and dy cannot be read in place, then
// one-tap implicit GEMMs on mma.sync) and conv_bn_conv3x3_bwd_tc (#11: a
// prepass that stores z and dyl once, then nine-tap implicit GEMMs).  The wrappers take them for bf16 and the
// scalar entries for f32.  The entry points return cudaGetLastError().

#include "conv_bn_common.cuh"
#include "conv_bn_tc.cuh"

namespace {

using namespace convbn;

struct Vecs {
  const float *mean, *scale, *beta;  // [C] of the input side
  const float *kshift, *gm, *gs;     // [N] of the output side
  int fuse, stats;
};

// dx, and the channel sums sum du * x and sum du, from this thread's
// entries of dz (rows of x, columns = input channels)
template <typename T>
__device__ __forceinline__ void store_dx_and_sums(
    const float (&acc)[4][4], Tile t, float* sums, const T* x, T* dx,
    const Vecs& v, float* psx, float* psu, long long rows, int cols) {
  float c1[4] = {0.f, 0.f, 0.f, 0.f}, c2[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long row = t.row + i;
    if (row >= rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = t.col + j;
      if (c >= cols) continue;
      const long long at = row * cols + c;
      if (v.fuse) {
        const float xv = to_f32(x[at]);
        const float u = bn_input(xv, v.mean[c], v.scale[c], v.beta[c]);
        const float du = u > 0.f ? acc[i][j] : 0.f;
        c1[j] += __fmul_rn(du, xv);
        c2[j] += du;
        dx[at] = from_f32<T>(__fmul_rn(du, v.scale[c]));
      } else {
        dx[at] = from_f32<T>(acc[i][j]);
      }
    }
  }
  if (v.fuse) column_partials(c1, c2, sums, psx, psu, cols);
}

// a [rows, cols] slice of the dW partials, unrounded
__device__ __forceinline__ void store_part(const float (&acc)[4][4], Tile t,
                                           float* part, long long rows,
                                           int cols) {
  float* out = part + (long long)blockIdx.z * rows * cols;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (t.row + i < rows && t.col + j < cols)
        out[(t.row + i) * cols + t.col + j] = acc[i][j];
}

// ---- the 1x1: x [M,K], W [K,N], dy and yr [M,N] ---------------------------

// dz [M,K] = dyl [M,N] . W^T
template <typename T>
struct MatmulDz {
  const T* x;
  const T* w;
  const T* dy;
  const T* y;
  Vecs v;
  T* dx;
  float *psx, *psu;
  long long rows;  // M
  int cols;        // K
  int depth;       // N
  static constexpr bool kAFastR = true;  // dy is contiguous along N
  static constexpr bool kBFastR = true;  // W [K,N] read as W^T [N,K]
  __device__ void range(int, long long* b, long long* e) const {
    *b = 0;
    *e = depth;
  }
  __device__ float a(long long m, long long n) const {
    const long long at = m * depth + n;
    return fold_dy<T>(to_f32(dy[at]), v.stats ? to_f32(y[at]) : 0.f,
                      v.gm[n], v.gs[n], v.kshift[n], v.stats);
  }
  __device__ float b(long long n, int k) const {
    return to_f32(w[(long long)k * depth + n]);
  }
  __device__ void epilogue(const float (&acc)[4][4], Tile t,
                           float* sums) const {
    store_dx_and_sums(acc, t, sums, x, dx, v, psx, psu, rows, cols);
  }
};

// dW [K,N] partials: sum over a split's rows m of z[m,k] * dyl[m,n]
template <typename T>
struct MatmulDw {
  const T* x;
  const T* dy;
  const T* y;
  Vecs v;
  float* part;
  long long rows;  // K
  int cols;        // N
  long long M;
  int splits;
  static constexpr bool kAFastR = false;  // x [M,K]: contiguous along k
  static constexpr bool kBFastR = false;  // dy [M,N]: contiguous along n
  __device__ void range(int s, long long* b, long long* e) const {
    split_range(M, s, splits, b, e);
  }
  __device__ float a(long long k, long long m) const {
    const float xv = to_f32(x[m * rows + k]);
    return v.fuse ? norm_relu<T>(xv, v.mean[k], v.scale[k], v.beta[k]) : xv;
  }
  __device__ float b(long long m, int n) const {
    const long long at = m * cols + n;
    return fold_dy<T>(to_f32(dy[at]), v.stats ? to_f32(y[at]) : 0.f,
                      v.gm[n], v.gs[n], v.kshift[n], v.stats);
  }
  __device__ void epilogue(const float (&acc)[4][4], Tile t, float*) const {
    store_part(acc, t, part, rows, cols);
  }
};

// ---- the 3x3: x [B,H,W,C], W [3,3,C,Co], y and dy [B,H,W,Co] ------------

// dz [B*H*W, C]: the transposed conv of dyl, r = (3 * dh + dw) * Co + co;
// dz at (h, w) takes dyl at (h + 1 - dh, w + 1 - dw) times W[dh, dw]^T
template <typename T>
struct Conv3Dz {
  const T* x;
  const T* w;
  const T* dy;
  const T* y;
  Vecs v;
  T* dx;
  float *psx, *psu;
  Image img;
  long long rows;  // B * H * W
  int cols;        // C
  int Co;
  static constexpr bool kAFastR = true;  // dy is contiguous along Co
  static constexpr bool kBFastR = true;  // W[dh, dw, c, :] is contiguous
  __device__ void range(int, long long* b, long long* e) const {
    *b = 0;
    *e = 9LL * Co;
  }
  __device__ float a(long long m, long long r) const {
    const int tap = (int)(r / Co), co = (int)(r - (long long)tap * Co);
    const long long pos = img.shifted(m, 1 - tap / 3, 1 - tap % 3);
    if (pos < 0) return 0.f;  // dyl outside the image is zero
    const long long at = pos * Co + co;
    return fold_dy<T>(to_f32(dy[at]), v.stats ? to_f32(y[at]) : 0.f,
                      v.gm[co], v.gs[co], v.kshift[co], v.stats);
  }
  __device__ float b(long long r, int c) const {
    const long long tap = r / Co, co = r - tap * Co;
    return to_f32(w[(tap * cols + c) * Co + co]);
  }
  __device__ void epilogue(const float (&acc)[4][4], Tile t,
                           float* sums) const {
    store_dx_and_sums(acc, t, sums, x, dx, v, psx, psu, rows, cols);
  }
};

// dW [9*C, Co] partials: row (3 * dh + dw) * C + c sums, over a split's
// positions m, z at (h + dh - 1, w + dw - 1) times dyl at m
template <typename T>
struct Conv3Dw {
  const T* x;
  const T* dy;
  const T* y;
  Vecs v;
  float* part;
  Image img;
  long long rows;  // 9 * C
  int cols;        // Co
  int C;
  long long M;
  int splits;
  static constexpr bool kAFastR = false;  // x: contiguous along c
  static constexpr bool kBFastR = false;  // dy: contiguous along co
  __device__ void range(int s, long long* b, long long* e) const {
    split_range(M, s, splits, b, e);
  }
  __device__ float a(long long r, long long m) const {
    const int tap = (int)(r / C), c = (int)(r - (long long)tap * C);
    const long long pos = img.shifted(m, tap / 3 - 1, tap % 3 - 1);
    if (pos < 0) return 0.f;  // z outside the image is zero
    const float xv = to_f32(x[pos * C + c]);
    return v.fuse ? norm_relu<T>(xv, v.mean[c], v.scale[c], v.beta[c]) : xv;
  }
  __device__ float b(long long m, int co) const {
    const long long at = m * cols + co;
    return fold_dy<T>(to_f32(dy[at]), v.stats ? to_f32(y[at]) : 0.f,
                      v.gm[co], v.gs[co], v.kshift[co], v.stats);
  }
  __device__ void epilogue(const float (&acc)[4][4], Tile t, float*) const {
    store_part(acc, t, part, rows, cols);
  }
};

// the reductions that close both entry points
template <typename T>
void reduce_grads(const Vecs& v, const float* dw_part, int splits,
                  long long dw_size, void* dw, const float* psx,
                  const float* psu, long long tiles, int C, float* dsx,
                  float* dsu, cudaStream_t stream) {
  launch_reduce<T>(dw_part, splits, dw_size, static_cast<T*>(dw), stream);
  if (v.fuse) {
    launch_reduce<float>(psx, tiles, C, dsx, stream);
    launch_reduce<float>(psu, tiles, C, dsu, stream);
  }
}

template <typename T>
int matmul_bwd(const void* x, const void* w, const Vecs& v, const void* y,
               const void* dy, void* dx, float* dw_part, void* dw, float* psx,
               float* psu, float* dsx, float* dsu, long long M, int K, int N,
               int splits, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  const T* dyt = static_cast<const T*>(dy);
  const T* yt = static_cast<const T*>(y);
  launch_product(MatmulDz<T>{xt, wt, dyt, yt, v, static_cast<T*>(dx), psx,
                             psu, M, K, N},
                 1, stream);
  launch_product(MatmulDw<T>{xt, dyt, yt, v, dw_part, K, N, M, splits},
                 splits, stream);
  reduce_grads<T>(v, dw_part, splits, (long long)K * N, dw, psx, psu,
                  (M + kBM - 1) / kBM, K, dsx, dsu, stream);
  return (int)cudaGetLastError();
}

template <typename T>
int conv3_bwd(const void* x, const void* w, const Vecs& v, const void* y,
              const void* dy, void* dx, float* dw_part, void* dw, float* psx,
              float* psu, float* dsx, float* dsu, int B, int H, int W, int C,
              int Co, int splits, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* dyt = static_cast<const T*>(dy);
  const T* yt = static_cast<const T*>(y);
  const Image img{B, H, W};
  const long long M = (long long)B * H * W;
  launch_product(Conv3Dz<T>{xt, static_cast<const T*>(w), dyt, yt, v,
                            static_cast<T*>(dx), psx, psu, img, M, C, Co},
                 1, stream);
  launch_product(Conv3Dw<T>{xt, dyt, yt, v, dw_part, img, 9LL * C, Co, C, M,
                            splits},
                 splits, stream);
  reduce_grads<T>(v, dw_part, splits, 9LL * C * Co, dw, psx, psu,
                  (M + kBM - 1) / kBM, C, dsx, dsu, stream);
  return (int)cudaGetLastError();
}

// the tensor-core prepass: one thread per 16-byte chunk of what it stores,
// at most 16 blocks an SM
template <int kTaps>
void launch_prepass(const tcconv::Problem& p, cudaStream_t stream) {
  const long long chunks = (p.pre_z ? p.M * (p.Cp / 8) : 0) +
                           (p.pre_dyl ? p.M * (p.Cop / 8) : 0) +
                           (p.pre_w ? (long long)kTaps * p.Cp * (p.Cop / 8)
                                    : 0);
  const long long blocks = (chunks + 255) / 256;
  tcconv::prepass<kTaps>
      <<<(unsigned)(blocks < 132 * 16 ? blocks : 132 * 16), 256, 0, stream>>>(
          p);
}

// the tensor-core backward once z, dyl and wp are in place: dgrad with
// dx and the channel partials, wgrad's split dW partials, their sum, and
// the channel sums
template <int kTaps>
void launch_tc_grads(const tcconv::Problem& p, float* dsx, float* dsu,
                     cudaStream_t stream) {
  namespace t = tcconv;
  const long long m_tiles = (p.M + t::kBM - 1) / t::kBM;
  t::dgrad<kTaps><<<dim3((unsigned)m_tiles, p.Cp / t::kBN), t::kThreads, 0,
                    stream>>>(p);
  t::wgrad<kTaps><<<dim3((kTaps * p.Cp + t::kBM - 1) / t::kBM,
                         p.Cop / t::kBN, p.splits),
                    t::kThreads, 0, stream>>>(p);
  const long long n_dw = (long long)kTaps * p.C * p.Co;
  t::reduce_dw<kTaps><<<(unsigned)((n_dw + 255) / 256), 256, 0, stream>>>(p);
  if (p.fuse) {
    launch_reduce<float>(p.psx, m_tiles, p.C, dsx, stream);
    launch_reduce<float>(p.psu, m_tiles, p.C, dsu, stream);
  }
}

}  // namespace

extern "C" {

// x [M,K], w [K,N], y and dy [M,N] (y: the forward's saved output, read
// with stats only), dx [M,K], dw [K,N], all f32 (bf16 takes
// conv_bn_matmul_bwd_tc); mean, scale, beta [K] and kshift, gm, gs [N] f32
// (gs doubled); dw_part f32 [splits, K, N]; psx, psu f32 [ceil(M/64), K];
// dsx, dsu f32 [K] (written with a norm only).
int conv_bn_matmul_bwd(const void* x, const void* w, const float* mean,
                       const float* scale, const float* beta,
                       const float* kshift, const void* y, const void* dy,
                       const float* gm, const float* gs, void* dx,
                       float* dw_part, void* dw, float* psx, float* psu,
                       float* dsx, float* dsu, long long M, int K, int N,
                       int fuse_input, int emit_stats, int splits,
                       void* stream) {
  const Vecs v{mean, scale, beta, kshift, gm, gs, fuse_input, emit_stats};
  return matmul_bwd<float>(x, w, v, y, dy, dx, dw_part, dw, psx, psu, dsx,
                           dsu, M, K, N, splits,
                           static_cast<cudaStream_t>(stream));
}

// The 1x1 on the tensor cores, bf16 only: the arguments of
// conv_bn_matmul_bwd, and scratch z [M, Kp] (nullptr: x itself, only
// without a norm and with K == Kp), dyl [M, Np] (nullptr: dy itself, only
// without stats and with N == Np), wp [Kp, Np] (bf16; Kp, Np: K, N rounded
// up to a multiple of 64), dw_part f32 [splits, Kp, Np], psx, psu f32
// [ceil(M/128), K]; split s of the dW sum adds rows [s * chunk,
// (s + 1) * chunk).
int conv_bn_matmul_bwd_tc(const void* x, const void* w, const float* mean,
                          const float* scale, const float* beta,
                          const float* kshift, const void* y, const void* dy,
                          const float* gm, const float* gs, void* dx, void* z,
                          void* dyl, void* wp, float* dw_part, void* dw,
                          float* psx, float* psu, float* dsx, float* dsu,
                          long long M, int K, int N, int fuse_input,
                          int emit_stats, int splits, int Kp, int Np,
                          long long chunk, void* stream) {
  namespace t = convbn::tcconv;
  using bf16 = __nv_bfloat16;
  const bool z_is_x = z == nullptr, dyl_is_dy = dyl == nullptr;
  if (Kp % t::kBN != 0 || Kp < K || Np % t::kBN != 0 || Np < N ||
      chunk < 1 || chunk * splits < M ||
      (z_is_x && (fuse_input || K != Kp || (uintptr_t)x % 16 != 0)) ||
      (dyl_is_dy && (emit_stats || N != Np || (uintptr_t)dy % 16 != 0)))
    return (int)cudaErrorInvalidValue;
  t::Problem p{};
  p.x = static_cast<const bf16*>(x);
  p.w = static_cast<const bf16*>(w);
  p.y = static_cast<const bf16*>(y);
  p.dy = static_cast<const bf16*>(dy);
  p.z = static_cast<bf16*>(z_is_x ? const_cast<void*>(x) : z);
  p.dyl = static_cast<bf16*>(dyl_is_dy ? const_cast<void*>(dy) : dyl);
  p.wp = static_cast<bf16*>(wp);
  p.dx = static_cast<bf16*>(dx);
  p.dw = static_cast<bf16*>(dw);
  p.part = dw_part;
  p.psx = psx;
  p.psu = psu;
  p.mean = mean;
  p.scale = scale;
  p.beta = beta;
  p.kshift = kshift;
  p.gm = gm;
  p.gs = gs;
  p.M = M;
  p.chunk = chunk;
  p.C = K;
  p.Co = N;
  p.Cp = Kp;
  p.Cop = Np;
  p.splits = splits;
  p.fuse = fuse_input;
  p.stats = emit_stats;
  p.pre_z = !z_is_x;
  p.pre_dyl = !dyl_is_dy;  // with stats the fold of the saved y
  p.pre_w = 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  launch_prepass<1>(p, s);
  launch_tc_grads<1>(p, dsx, dsu, s);
  return (int)cudaGetLastError();
}

// x [B,H,W,C], w [3,3,C,Co], y and dy [B,H,W,Co] (y: the forward's saved
// output), dx [B,H,W,C], dw [3,3,C,Co], all f32 (bf16 takes
// conv_bn_conv3x3_bwd_tc); mean, scale, beta [C] and kshift, gm, gs [Co]
// f32; dw_part f32 [splits, 9*C, Co]; psx, psu f32 [ceil(B*H*W/64), C];
// dsx, dsu f32 [C].
int conv_bn_conv3x3_bwd(const void* x, const void* w, const float* mean,
                        const float* scale, const float* beta,
                        const float* kshift, const void* y, const void* dy,
                        const float* gm, const float* gs, void* dx,
                        float* dw_part, void* dw, float* psx, float* psu,
                        float* dsx, float* dsu, int B, int H, int W, int C,
                        int Co, int fuse_input, int emit_stats, int splits,
                        void* stream) {
  const Vecs v{mean, scale, beta, kshift, gm, gs, fuse_input, emit_stats};
  return conv3_bwd<float>(x, w, v, y, dy, dx, dw_part, dw, psx, psu, dsx,
                          dsu, B, H, W, C, Co, splits,
                          static_cast<cudaStream_t>(stream));
}

// The 3x3 on the tensor cores, bf16 only: the arguments of
// conv_bn_conv3x3_bwd, and scratch z [B*H*W, Cp], dyl [B*H*W, Cop], wp
// [9, Cp, Cop] (bf16; Cp, Cop: C, Co rounded up to a multiple of 64),
// dw_part f32 [splits, 9*Cp, Cop], psx, psu f32 [ceil(B*H*W/128), C];
// split s of the dW sum adds positions [s * chunk, (s + 1) * chunk).
int conv_bn_conv3x3_bwd_tc(const void* x, const void* w, const float* mean,
                           const float* scale, const float* beta,
                           const float* kshift, const void* y, const void* dy,
                           const float* gm, const float* gs, void* dx,
                           void* z, void* dyl, void* wp, float* dw_part,
                           void* dw, float* psx, float* psu, float* dsx,
                           float* dsu, int B, int H, int W, int C, int Co,
                           int fuse_input, int emit_stats, int splits,
                           int Cp, int Cop, long long chunk, void* stream) {
  namespace t = convbn::tcconv;
  const long long M = (long long)B * H * W;
  if (Cp % t::kBN != 0 || Cp < C || Cop % t::kBN != 0 || Cop < Co ||
      chunk < 1 || chunk * splits < M)
    return (int)cudaErrorInvalidValue;
  using bf16 = __nv_bfloat16;
  t::Problem p{};
  p.x = static_cast<const bf16*>(x);
  p.w = static_cast<const bf16*>(w);
  p.y = static_cast<const bf16*>(y);
  p.dy = static_cast<const bf16*>(dy);
  p.z = static_cast<bf16*>(z);
  p.dyl = static_cast<bf16*>(dyl);
  p.wp = static_cast<bf16*>(wp);
  p.dx = static_cast<bf16*>(dx);
  p.dw = static_cast<bf16*>(dw);
  p.part = dw_part;
  p.psx = psx;
  p.psu = psu;
  p.mean = mean;
  p.scale = scale;
  p.beta = beta;
  p.kshift = kshift;
  p.gm = gm;
  p.gs = gs;
  p.img = convbn::Image{B, H, W};
  p.M = M;
  p.chunk = chunk;
  p.C = C;
  p.Co = Co;
  p.Cp = Cp;
  p.Cop = Cop;
  p.splits = splits;
  p.fuse = fuse_input;
  p.stats = emit_stats;
  p.pre_z = 1;
  p.pre_dyl = 1;
  p.pre_w = 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  launch_prepass<9>(p, s);
  launch_tc_grads<9>(p, dsx, dsu, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
