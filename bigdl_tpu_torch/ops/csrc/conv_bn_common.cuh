// Shared core of the fused conv+BN kernels (conv_bn_fwd.cu, conv_bn_bwd.cu):
// one tiled f32 product with pluggable operand loaders and epilogues, the
// reference's elementwise steps written op by op, and a fixed-order
// reduction of per-tile partial sums.
//
// The product.  Every pass of kernels #8-#11 is C[rows, cols] = sum over r
// of A[row, r] * B[r, col], with A and B produced element by element by a
// problem struct (P below) that applies the pass's own arithmetic as it
// loads: the previous BN's normalize+ReLU and its cast (z), the SAME
// padding of a 3x3 conv (implicit GEMM: r = tap * C + channel, a position
// outside the image gives 0), the statistics-cotangent fold of dy.  Tiles
// are fixed: a block of 256 threads computes a 64 x 64 tile of C, 4 x 4
// entries per thread in registers, streaming 16-deep slices of A and B
// through shared memory as f32.  Edges are masked at load (0) and at store.
// Sums are scalar f32 FMAs on the CUDA cores, in one fixed order per entry:
// no tensor cores, no float atomics, so two launches give the same bits.
//
// Reductions over a grid.  The Pallas kernels run their grid in order and
// keep s1, s2, dW and the channel sums in one resident block.  Here tiles
// run in parallel: each tile writes its partial sums (one row of a
// [tiles, n] f32 array, or one [rows, cols] slice of the dW partials) and
// reduce_partials adds them in a fixed order.
//
// Rounding points.  Each elementwise step of the reference is one rounded
// f32 operation here (__fadd_rn, __fmul_rn, __fsub_rn: no FMA contraction),
// as torch computes the plain versions, so z, u and the folded dy equal the
// plain versions' bit for bit; only the order of the products' sums
// differs.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace convbn {

constexpr int kBM = 64;       // rows of C per block
constexpr int kBN = 64;       // columns of C per block
constexpr int kBK = 16;       // depth of one shared-memory slice
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 entries each
constexpr int kReduceLanes = 32;

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

// x rounded to T and back: the reference's casts
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// u = (x - mean) * scale + beta in f32, one rounding per operation
__device__ __forceinline__ float bn_input(float x, float mean, float scale,
                                          float beta) {
  return __fadd_rn(__fmul_rn(__fsub_rn(x, mean), scale), beta);
}

// z = relu(u) cast to x's dtype: the normalized input of the product
// (_fwd_kernel :164, _nz_rows :445)
template <typename T>
__device__ __forceinline__ float norm_relu(float x, float mean, float scale,
                                           float beta) {
  return round_to<T>(fmaxf(bn_input(x, mean, scale, beta), 0.f));
}

// dy with the statistics cotangents folded in, cast to dy's dtype before
// both products (_bwd_kernel :205-206, _conv3_bwd_kernel fold :541-547);
// gs arrives already doubled (the factor 2 of d(y-K)^2 is outside)
template <typename T>
__device__ __forceinline__ float fold_dy(float dy, float y, float gm,
                                         float gs, float k, int stats) {
  if (!stats) return dy;
  return round_to<T>(__fadd_rn(__fadd_rn(dy, gm), __fmul_rn(gs, __fsub_rn(y, k))));
}

struct Tile {
  long long row;  // first of this thread's 4 rows
  int col;        // first of this thread's 4 columns
};

// C tile of this block: rows [blockIdx.x * 64, +64), columns
// [blockIdx.y * 64, +64), the reduction over P::range(blockIdx.z).
// P provides rows, cols, kAFastR / kBFastR (which index of A / B is
// contiguous in memory, for coalesced loads), a(row, r), b(r, col),
// range(split, &begin, &end) and epilogue(acc, tile, smem).
template <class P>
__global__ void __launch_bounds__(kThreads) tile_product(const P p) {
  __shared__ __align__(16) float As[kBK][kBM + 4];
  __shared__ __align__(16) float Bs[kBK][kBN + 4];
  __shared__ __align__(16) float sums[2 * 16 * kBN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const long long row0 = (long long)blockIdx.x * kBM;
  const int col0 = blockIdx.y * kBN;
  long long r_begin, r_end;
  p.range(blockIdx.z, &r_begin, &r_end);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (long long r0 = r_begin; r0 < r_end; r0 += kBK) {
#pragma unroll
    for (int i = 0; i < kBM * kBK / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int rr = P::kAFastR ? idx % kBK : idx / kBM;
      const int mm = P::kAFastR ? idx / kBK : idx % kBM;
      const long long row = row0 + mm, r = r0 + rr;
      As[rr][mm] = (row < p.rows && r < r_end) ? p.a(row, r) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kBN * kBK / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int rr = P::kBFastR ? idx % kBK : idx / kBN;
      const int nn = P::kBFastR ? idx / kBK : idx % kBN;
      const int col = col0 + nn;
      const long long r = r0 + rr;
      Bs[rr][nn] = (col < p.cols && r < r_end) ? p.b(r, col) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 a4 = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float4 b4 = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
      const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  p.epilogue(acc, Tile{row0 + ty * 4, col0 + tx * 4}, sums);
}

// Per-column sums over this block's 64 rows of two quantities, in a fixed
// order (each thread's own rows, then the 16 row groups in turn), written
// as row blockIdx.x of the [tiles, cols] partial arrays p1 and p2.  Every
// thread of the block must call it.
__device__ __forceinline__ void column_partials(const float (&c1)[4],
                                                const float (&c2)[4],
                                                float* sums, float* p1,
                                                float* p2, int cols) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    sums[ty * kBN + tx * 4 + j] = c1[j];
    sums[(16 + ty) * kBN + tx * 4 + j] = c2[j];
  }
  __syncthreads();
  if (threadIdx.x < kBN) {
    const int col = blockIdx.y * kBN + threadIdx.x;
    float t1 = 0.f, t2 = 0.f;
    for (int g = 0; g < 16; ++g) {
      t1 += sums[g * kBN + threadIdx.x];
      t2 += sums[(16 + g) * kBN + threadIdx.x];
    }
    if (col < cols) {
      p1[(long long)blockIdx.x * cols + col] = t1;
      p2[(long long)blockIdx.x * cols + col] = t2;
    }
  }
}

// out[c] = sum over t of part[t * n + c], for c < n, in a fixed order: lane
// ty of 32 sums t = ty, ty + 32, ...; then the 32 lanes are added in turn.
template <typename TO>
__global__ void reduce_partials(const float* __restrict__ part, long long T,
                                long long n, TO* __restrict__ out) {
  __shared__ float s[kReduceLanes][kReduceLanes + 1];
  const long long c = (long long)blockIdx.x * kReduceLanes + threadIdx.x;
  float acc = 0.f;
  if (c < n)
    for (long long t = threadIdx.y; t < T; t += kReduceLanes)
      acc += part[t * n + c];
  s[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && c < n) {
    float tot = 0.f;
    for (int i = 0; i < kReduceLanes; ++i) tot += s[i][threadIdx.x];
    out[c] = from_f32<TO>(tot);
  }
}

template <typename TO>
inline void launch_reduce(const float* part, long long T, long long n, TO* out,
                          cudaStream_t stream) {
  const dim3 block(kReduceLanes, kReduceLanes);
  const dim3 grid((unsigned)((n + kReduceLanes - 1) / kReduceLanes));
  reduce_partials<TO><<<grid, block, 0, stream>>>(part, T, n, out);
}

template <class P>
inline void launch_product(const P& p, int splits, cudaStream_t stream) {
  const dim3 grid((unsigned)((p.rows + kBM - 1) / kBM),
                  (unsigned)((p.cols + kBN - 1) / kBN), (unsigned)splits);
  tile_product<P><<<grid, kThreads, 0, stream>>>(p);
}

// the split's share of a reduction of length n over `splits` parts, in
// whole slices
__device__ __forceinline__ void split_range(long long n, int split,
                                            int splits, long long* b,
                                            long long* e) {
  long long chunk = (n + splits - 1) / splits;
  chunk = (chunk + kBK - 1) / kBK * kBK;
  *b = split * chunk;
  *e = *b + chunk < n ? *b + chunk : n;
}

// position of row m of an NHWC image batch, and the flat index of
// (b, h + dh, w + dw) when that lies inside the image, else -1
struct Image {
  int B, H, W;
  __device__ __forceinline__ long long shifted(long long m, int dh,
                                               int dw) const {
    const int w = (int)(m % W);
    const long long t = m / W;
    const int h = (int)(t % H);
    const long long b = t / H;
    const int hh = h + dh, ww = w + dw;
    if (hh < 0 || hh >= H || ww < 0 || ww >= W) return -1;
    return (b * H + hh) * W + ww;
  }
};

}  // namespace convbn
