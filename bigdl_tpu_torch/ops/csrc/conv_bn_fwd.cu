// Fused conv+BN forward for Hopper (sm_90a), plain C interface: kernels #8
// and #10 of the port.
//
// Replaces the TPU kernels of bigdl_tpu/ops/conv_bn_kernels.py:
//   conv_bn_matmul_fwd   <- _fused_fwd / _fwd_kernel        (pallas_call :274)
//   conv_bn_conv3x3_fwd  <- _conv3_fwd / _conv3_fwd_kernel  (pallas_call :668)
// and computes what they compute:
//
//   z  = relu((x - mean) * scale + beta) cast to x's dtype   (norm given)
//      = x                                                   (no norm)
//   y  = z . W (1x1: x [M,K], W [K,N]) or the NHWC 3x3 stride-1 SAME conv
//        of z with W [3,3,C,Co], summed in f32 and cast to x's dtype
//   s1 = sum over rows of (y - K), s2 = sum of (y - K)^2, f32, on the
//        rounded y (only with a kshift K)
//
// The 3x3 pads z, the normalized activation, not x: a tap that falls
// outside the image reads 0 AFTER normalize+ReLU (_conv3_fwd_kernel
// :472-478, _wshift :448-457); zero-padding x would give relu(beta -
// mean * scale) on the border instead.
//
// What bounds them on an H100.  At ResNet-50's b128 shapes the 3x3 does
// 18*B*H*W*C*Co operations on a few hundred MB, so its bound is the bf16
// tensor-core rate (operations); the 1x1 does 2*M*K*N on M*(K+N) rows, at
// K and N of 64-2048 under the card's 295 operations a byte, so its bound
// is bytes (y, written once, is the most of them).  In f32 both run scalar
// f32 FMAs on the CUDA cores (conv_bn_common.cuh): each block keeps a
// 64 x 64 tile of y in registers, loads each input slice once into shared
// memory with the normalize+ReLU applied on the way, and never writes z to
// device memory; the statistics are summed from the tile in registers, so
// y is not read back.  In bf16 (the `--fused --bf16` path) both run on the
// tensor cores instead (conv_bn_tc.cuh: a prepass that stores z and a
// padded W once where x and W cannot be read in place, then an implicit
// GEMM on mma.sync, one tap for the 1x1): the entry points pick that
// route for bf16 and the scalar one for f32, whose operands the tensor
// cores would round.
//
// Routing differs from the TPU in one place: the reference's VMEM budget
// refuses the 3x3 at C = Co = 512 (stage 4: 9 * 512 * 512 * 6 B > 11 MiB),
// which therefore takes the plain path on a TPU.  This kernel takes it.
// The fused and plain paths compute the same thing, so only the launch
// count differs.
//
// Each entry point launches the product (one block per 64 x 64 tile of y;
// bf16: the prepass where it has anything to store, then one block per
// 128 x 64 tile) and, with a kshift, one fixed-order reduction of the
// per-tile statistics.  It returns cudaGetLastError().

#include "conv_bn_common.cuh"
#include "conv_bn_tc.cuh"

namespace {

using namespace convbn;

// the statistics of this thread's entries and the store of y (rounded)
template <typename T>
__device__ __forceinline__ void store_y_and_stats(
    const float (&acc)[4][4], Tile t, float* sums, T* y, const float* kshift,
    float* p1, float* p2, long long rows, int cols, int stats) {
  float c1[4] = {0.f, 0.f, 0.f, 0.f}, c2[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long row = t.row + i;
    if (row >= rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = t.col + j;
      if (col >= cols) continue;
      const T yv = from_f32<T>(acc[i][j]);  // y cast before the statistics
      y[row * cols + col] = yv;
      if (stats) {
        const float d = __fsub_rn(to_f32(yv), kshift[col]);
        c1[j] += d;
        c2[j] += __fmul_rn(d, d);
      }
    }
  }
  if (stats) column_partials(c1, c2, sums, p1, p2, cols);
}

// #8: y [M,N] = z [M,K] . W [K,N]
template <typename T>
struct MatmulFwd {
  const T* x;
  const T* w;
  const float *mean, *scale, *beta, *kshift;
  T* y;
  float *p1, *p2;
  long long rows;  // M
  int cols;        // N
  int depth;       // K
  int fuse, stats;
  static constexpr bool kAFastR = true;   // x is contiguous along K
  static constexpr bool kBFastR = false;  // W is contiguous along N
  __device__ void range(int, long long* b, long long* e) const {
    *b = 0;
    *e = depth;
  }
  __device__ float a(long long m, long long k) const {
    const float xv = to_f32(x[m * depth + k]);
    return fuse ? norm_relu<T>(xv, mean[k], scale[k], beta[k]) : xv;
  }
  __device__ float b(long long k, int n) const {
    return to_f32(w[k * cols + n]);
  }
  __device__ void epilogue(const float (&acc)[4][4], Tile t,
                           float* sums) const {
    store_y_and_stats(acc, t, sums, y, kshift, p1, p2, rows, cols, stats);
  }
};

// #10 in f32: y [B,H,W,Co] = the 3x3 SAME conv of z [B,H,W,C] with
// W [3,3,C,Co]; the reduction index r = (3 * dh + dw) * C + c
template <typename T>
struct Conv3Fwd {
  const T* x;
  const T* w;
  const float *mean, *scale, *beta, *kshift;
  T* y;
  float *p1, *p2;
  Image img;
  long long rows;  // B * H * W
  int cols;        // Co
  int C;
  int fuse, stats;
  static constexpr bool kAFastR = true;   // x is contiguous along C
  static constexpr bool kBFastR = false;  // W is contiguous along Co
  __device__ void range(int, long long* b, long long* e) const {
    *b = 0;
    *e = 9LL * C;
  }
  __device__ float a(long long m, long long r) const {
    const int tap = (int)(r / C), c = (int)(r - (long long)tap * C);
    const long long pos = img.shifted(m, tap / 3 - 1, tap % 3 - 1);
    const float xv = pos >= 0 ? to_f32(x[pos * C + c]) : 0.f;
    const float zv = fuse ? norm_relu<T>(xv, mean[c], scale[c], beta[c]) : xv;
    return pos >= 0 ? zv : 0.f;  // SAME padding of z: zero after normalize+ReLU
  }
  __device__ float b(long long r, int co) const {
    return to_f32(w[r * cols + co]);
  }
  __device__ void epilogue(const float (&acc)[4][4], Tile t,
                           float* sums) const {
    store_y_and_stats(acc, t, sums, y, kshift, p1, p2, rows, cols, stats);
  }
};

template <class P>
int run_fwd(const P& p, float* s1, float* s2, cudaStream_t stream) {
  launch_product(p, 1, stream);
  if (p.stats) {
    const long long tiles = (p.rows + kBM - 1) / kBM;
    launch_reduce<float>(p.p1, tiles, p.cols, s1, stream);
    launch_reduce<float>(p.p2, tiles, p.cols, s2, stream);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int matmul_fwd(const void* x, const void* w, const float* mean,
               const float* scale, const float* beta, const float* kshift,
               void* y, float* p1, float* p2, float* s1, float* s2,
               long long M, int K, int N, int fuse, int stats,
               cudaStream_t stream) {
  MatmulFwd<T> p{static_cast<const T*>(x), static_cast<const T*>(w), mean,
                 scale, beta, kshift, static_cast<T*>(y), p1, p2, M, N, K,
                 fuse, stats};
  return run_fwd(p, s1, s2, stream);
}

int conv3_fwd(const void* x, const void* w, const float* mean,
              const float* scale, const float* beta, const float* kshift,
              void* y, float* p1, float* p2, float* s1, float* s2, int B,
              int H, int W, int C, int Co, int fuse, int stats,
              cudaStream_t stream) {
  Conv3Fwd<float> p{static_cast<const float*>(x),
                    static_cast<const float*>(w), mean, scale, beta, kshift,
                    static_cast<float*>(y), p1, p2, Image{B, H, W},
                    (long long)B * H * W, Co, C, fuse, stats};
  return run_fwd(p, s1, s2, stream);
}

// The tensor-core forward once its Problem is set: the prepass (where it
// has anything to store), the implicit GEMM with the statistics partials,
// their reduction
template <int kTaps>
int run_fwd_tc(const tcconv::Problem& p, float* s1, float* s2,
               cudaStream_t stream) {
  namespace t = tcconv;
  const long long chunks = (p.pre_z ? p.M * (p.Cp / 8) : 0) +
                           (p.pre_w ? kTaps * (long long)p.Cp * (p.Cop / 8)
                                    : 0);
  if (chunks > 0) {
    const long long blocks = (chunks + 255) / 256;
    t::prepass<kTaps><<<(unsigned)(blocks < 132 * 16 ? blocks : 132 * 16),
                        256, 0, stream>>>(p);
  }
  const long long m_tiles = (p.M + t::kBM - 1) / t::kBM;
  t::fprop<kTaps><<<dim3((unsigned)m_tiles, p.Cop / t::kBN), t::kThreads, 0,
                    stream>>>(p);
  if (p.stats) {
    launch_reduce<float>(p.ps1, m_tiles, p.Co, s1, stream);
    launch_reduce<float>(p.ps2, m_tiles, p.Co, s2, stream);
  }
  return (int)cudaGetLastError();
}

// #10 on the tensor cores (bf16): the prepass of z and wp, the implicit
// GEMM with the statistics partials, their reduction
int conv3_fwd_tc(const void* x, const void* w, const float* mean,
                 const float* scale, const float* beta, const float* kshift,
                 void* y, float* p1, float* p2, float* s1, float* s2,
                 void* z, void* wp, int B, int H, int W, int C, int Co,
                 int Cp, int Cop, int fuse, int stats, cudaStream_t stream) {
  namespace t = tcconv;
  using bf16 = __nv_bfloat16;
  if (Cp % t::kBN != 0 || Cp < C || Cop % t::kBN != 0 || Cop < Co)
    return (int)cudaErrorInvalidValue;
  t::Problem p{};
  p.x = static_cast<const bf16*>(x);
  p.w = static_cast<const bf16*>(w);
  p.z = static_cast<bf16*>(z);
  p.wp = static_cast<bf16*>(wp);
  p.yf = static_cast<bf16*>(y);
  p.ps1 = p1;
  p.ps2 = p2;
  p.mean = mean;
  p.scale = scale;
  p.beta = beta;
  p.kshift = kshift;
  p.img = Image{B, H, W};
  p.M = (long long)B * H * W;
  p.C = C;
  p.Co = Co;
  p.Cp = Cp;
  p.Cop = Cop;
  p.fuse = fuse;
  p.stats = stats;
  p.pre_z = 1;
  p.pre_w = 1;
  return run_fwd_tc<9>(p, s1, s2, stream);
}

// #8 on the tensor cores (bf16): #10's route with one tap.  z is x itself
// (z == nullptr) without a norm where K is a multiple of 64 and x starts
// on 16 bytes, wp is w itself (wp == nullptr) where K and N are multiples
// of 64 and w starts on 16 bytes; else the prepass stores them padded.
int matmul_fwd_tc(const void* x, const void* w, const float* mean,
                  const float* scale, const float* beta, const float* kshift,
                  void* y, float* p1, float* p2, float* s1, float* s2,
                  void* z, void* wp, long long M, int K, int N, int Kp,
                  int Np, int fuse, int stats, cudaStream_t stream) {
  namespace t = tcconv;
  using bf16 = __nv_bfloat16;
  const bool z_is_x = z == nullptr, wp_is_w = wp == nullptr;
  if (Kp % t::kBN != 0 || Kp < K || Np % t::kBN != 0 || Np < N ||
      (z_is_x && (fuse || K != Kp || (uintptr_t)x % 16 != 0)) ||
      (wp_is_w && (K != Kp || N != Np || (uintptr_t)w % 16 != 0)))
    return (int)cudaErrorInvalidValue;
  t::Problem p{};
  p.x = static_cast<const bf16*>(x);
  p.w = static_cast<const bf16*>(w);
  p.z = static_cast<bf16*>(z_is_x ? const_cast<void*>(x) : z);
  p.wp = static_cast<bf16*>(wp_is_w ? const_cast<void*>(w) : wp);
  p.yf = static_cast<bf16*>(y);
  p.ps1 = p1;
  p.ps2 = p2;
  p.mean = mean;
  p.scale = scale;
  p.beta = beta;
  p.kshift = kshift;
  p.img = Image{1, 1, 1};  // unused with one tap
  p.M = M;
  p.C = K;
  p.Co = N;
  p.Cp = Kp;
  p.Cop = Np;
  p.fuse = fuse;
  p.stats = stats;
  p.pre_z = !z_is_x;
  p.pre_w = !wp_is_w;
  return run_fwd_tc<1>(p, s1, s2, stream);
}

}  // namespace

extern "C" {

// x [M,K], w [K,N], y [M,N] (dtype: bf16 ? bfloat16 : float32); mean,
// scale, beta [K] and kshift [N] f32; s1, s2 f32 [N].  f32 takes the
// scalar route: p1, p2 f32 [ceil(M/64), N], z, wp, Kp and Np unused.
// bf16 takes the tensor cores: p1, p2 f32 [ceil(M/128), N], scratch z
// [M, Kp] (nullptr: x itself, only without a norm, with K == Kp and x on
// 16 bytes) and wp [Kp, Np] (nullptr: w itself, only with K == Kp, N ==
// Np and w on 16 bytes), bf16, Kp and Np: K and N rounded up to a
// multiple of 64.  Without a kshift (stats = 0) p1, p2, s1, s2 are unused.
int conv_bn_matmul_fwd(const void* x, const void* w, const float* mean,
                       const float* scale, const float* beta,
                       const float* kshift, void* y, float* p1, float* p2,
                       float* s1, float* s2, void* z, void* wp, int bf16,
                       long long M, int K, int N, int Kp, int Np,
                       int fuse_input, int emit_stats, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? matmul_fwd_tc(x, w, mean, scale, beta, kshift, y, p1, p2, s1,
                              s2, z, wp, M, K, N, Kp, Np, fuse_input,
                              emit_stats, s)
              : matmul_fwd<float>(x, w, mean, scale, beta, kshift, y, p1,
                                  p2, s1, s2, M, K, N, fuse_input,
                                  emit_stats, s);
}

// x [B,H,W,C], w [3,3,C,Co], y [B,H,W,Co]; mean, scale, beta [C] and
// kshift [Co] f32; s1, s2 f32 [Co].  f32 takes the scalar route: p1, p2
// f32 [ceil(B*H*W/64), Co], z, wp, Cp and Cop unused.  bf16 takes the
// tensor cores: p1, p2 f32 [ceil(B*H*W/128), Co], scratch z [B*H*W, Cp]
// and wp [9, Cp, Cop] bf16 (Cp, Cop: C, Co rounded up to a multiple of 64).
int conv_bn_conv3x3_fwd(const void* x, const void* w, const float* mean,
                        const float* scale, const float* beta,
                        const float* kshift, void* y, float* p1, float* p2,
                        float* s1, float* s2, void* z, void* wp, int bf16,
                        int B, int H, int W, int C, int Co, int Cp, int Cop,
                        int fuse_input, int emit_stats, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? conv3_fwd_tc(x, w, mean, scale, beta, kshift, y, p1, p2, s1,
                             s2, z, wp, B, H, W, C, Co, Cp, Cop, fuse_input,
                             emit_stats, s)
              : conv3_fwd(x, w, mean, scale, beta, kshift, y, p1, p2, s1,
                          s2, B, H, W, C, Co, fuse_input, emit_stats, s);
}

}  // extern "C"
