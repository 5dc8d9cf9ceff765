// Fused descriptor similarity + per-tile top-2 statistics, sm_90a.
//
// Replaces the Pallas TPU kernel monocularsfm_tpu/ops/pallas_matching.py::
// _match_tile_kernel (with the grid of _match_stats_pallas).  For each image
// pair p = (ia, ib) of a batch and each 128 x 128 tile of the similarity
// matrix A.B^T (bf16 operands, f32 accumulation, masked rows and columns set
// to NEG = -1e30) it writes, for the tile's rows, the row maximum, its column
// index (the first one on ties) and the runner-up, and the same for the
// tile's columns.  ops/matching.py merges the partials across tiles (the
// earlier tile wins ties) and takes the ratio / distance / cross-check
// decision, as the reference does outside its kernel.
//
// One grid covers pairs x row tiles x column tiles, where the reference runs
// its pairs one after another under lax.map.  The N x N similarities never
// reach device memory: partials are 2 * 3 * N * (N / 128) words per pair.
//
// What bounds it on the H100: arithmetic.  Each pair is 2 * N^2 * 128 flops
// (17 GFLOP at N = 8192) against 4 MB of descriptors.  This first version
// runs plain fp32 FMAs on the bf16 values (exact products, so only the
// summation order differs from XLA): a 128 x 128 tile per block, 8 x 8
// outputs per thread, operands staged through shared memory in 32-deep
// slices.  bf16 tensor cores (mma / wgmma) are the later step.
//
// Launched on the caller's stream; allocates nothing.  Returns
// cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128, kBN = 128;  // tile rows (A) and columns (B)
constexpr int kKC = 32;              // depth slice staged in shared memory
constexpr int kThreads = 256;        // 16 x 16 threads, 8 x 8 outputs each
constexpr int kPad = 4;
constexpr float kNeg = -1e30f;

struct Top2 {
  float v1;
  int i1;
  float v2;
};

// Merge two partial top-2 states; on equal maxima the smaller index wins.
__device__ __forceinline__ Top2 merge(Top2 a, Top2 b) {
  const bool take_b = b.v1 > a.v1 || (b.v1 == a.v1 && b.i1 < a.i1);
  Top2 w = take_b ? b : a;
  const Top2 l = take_b ? a : b;
  w.v2 = fmaxf(fmaxf(w.v2, l.v1), l.v2);
  return w;
}

// Fold one value with a larger index than any seen into a top-2 state.
__device__ __forceinline__ void push(Top2& s, float v, int idx) {
  if (v > s.v1) {
    s.v2 = s.v1;
    s.v1 = v;
    s.i1 = idx;
  } else if (v > s.v2) {
    s.v2 = v;
  }
}

__device__ __forceinline__ void stage(const __nv_bfloat16* __restrict__ src,
                                      int D, int k0, float* dst, int rows) {
  // rows x kKC bf16 values, 8 per 16-byte load, stored transposed (k-major).
  for (int v = threadIdx.x; v < rows * (kKC / 8); v += kThreads) {
    const int row = v / (kKC / 8);
    const int kq = v % (kKC / 8);
    const uint4 q =
        __ldg(reinterpret_cast<const uint4*>(src + (size_t)row * D + k0) + kq);
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&q);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      dst[(kq * 8 + e) * (rows + kPad) + row] = __bfloat162float(h[e]);
  }
}

__global__ void __launch_bounds__(kThreads)
match_tile_kernel(const __nv_bfloat16* __restrict__ bank,
                  const uint8_t* __restrict__ mask,
                  const int* __restrict__ pairs,
                  float* __restrict__ rt1, int* __restrict__ ri1,
                  float* __restrict__ rt2, float* __restrict__ ct1,
                  int* __restrict__ ci1, float* __restrict__ ct2, int N,
                  int D) {
  __shared__ float smem[kKC * (kBM + kPad) + kKC * (kBN + kPad)];
  float* As = smem;
  float* Bs = smem + kKC * (kBM + kPad);

  const int cb = blockIdx.x, rb = blockIdx.y, p = blockIdx.z;
  const int num_c = gridDim.x, num_r = gridDim.y;
  const int ia = pairs[2 * p], ib = pairs[2 * p + 1];
  const int row0 = rb * kBM, col0 = cb * kBN;
  const __nv_bfloat16* A = bank + ((size_t)ia * N + row0) * D;
  const __nv_bfloat16* B = bank + ((size_t)ib * N + col0) * D;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < D; k0 += kKC) {
    stage(A, D, k0, As, kBM);
    stage(B, D, k0, Bs, kBN);
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kKC; ++k) {
      float a[8], b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = As[k * (kBM + kPad) + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = Bs[k * (kBN + kPad) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // This thread's rows are row0 + ty + 16 i, its columns col0 + tx + 16 j.
  bool ma[8], mb[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) ma[i] = mask[(size_t)ia * N + row0 + ty + 16 * i];
#pragma unroll
  for (int j = 0; j < 8; ++j) mb[j] = mask[(size_t)ib * N + col0 + tx + 16 * j];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (!(ma[i] && mb[j])) acc[i][j] = kNeg;

  // Row direction: fold own columns in order, then across the 16 lanes
  // (one half-warp) that share the rows.
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    Top2 s{-INFINITY, 0, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j) push(s, acc[i][j], col0 + tx + 16 * j);
#pragma unroll
    for (int off = 8; off >= 1; off >>= 1) {
      Top2 o;
      o.v1 = __shfl_xor_sync(0xffffffffu, s.v1, off);
      o.i1 = __shfl_xor_sync(0xffffffffu, s.i1, off);
      o.v2 = __shfl_xor_sync(0xffffffffu, s.v2, off);
      s = merge(s, o);
    }
    if (tx == 0) {
      const size_t o = ((size_t)p * num_c + cb) * N + row0 + ty + 16 * i;
      rt1[o] = s.v1;
      ri1[o] = s.i1;
      rt2[o] = s.v2;
    }
  }

  // Column direction: fold own rows in order, then across the 16 row
  // groups through shared memory (reusing the operand buffers).
  float* sv1 = smem;
  int* si1 = reinterpret_cast<int*>(smem + 16 * kBN);
  float* sv2 = smem + 2 * 16 * kBN;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    Top2 s{-INFINITY, 0, -INFINITY};
#pragma unroll
    for (int i = 0; i < 8; ++i) push(s, acc[i][j], row0 + ty + 16 * i);
    const int slot = ty * kBN + tx + 16 * j;
    sv1[slot] = s.v1;
    si1[slot] = s.i1;
    sv2[slot] = s.v2;
  }
  __syncthreads();
  if (threadIdx.x < kBN) {
    const int lc = threadIdx.x;
    Top2 s{sv1[lc], si1[lc], sv2[lc]};
    for (int g = 1; g < 16; ++g)
      s = merge(s, Top2{sv1[g * kBN + lc], si1[g * kBN + lc],
                        sv2[g * kBN + lc]});
    const size_t o = ((size_t)p * num_r + rb) * N + col0 + lc;
    ct1[o] = s.v1;
    ci1[o] = s.i1;
    ct2[o] = s.v2;
  }
}

}  // namespace

extern "C" {

// bank (I, N, D) bf16, mask (I, N) uint8, pairs (P, 2) int32 rows of the
// bank.  Row partials (P, N / 128, N) and column partials (P, N / 128, N):
// t1 f32, argmax int32, t2 f32.  N must be a multiple of 128, D of 32.
int sfm_match_tile(const void* bank, const void* mask, const void* pairs,
                   void* rt1, void* ri1, void* rt2, void* ct1, void* ci1,
                   void* ct2, int P, int N, int D, void* stream) {
  if (N % kBM != 0 || N % kBN != 0 || D % kKC != 0 || D <= 0)
    return (int)cudaErrorInvalidValue;
  if (P == 0 || N == 0) return 0;
  dim3 grid(N / kBN, N / kBM, P);
  match_tile_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(bank),
      static_cast<const uint8_t*>(mask), static_cast<const int*>(pairs),
      static_cast<float*>(rt1), static_cast<int*>(ri1),
      static_cast<float*>(rt2), static_cast<float*>(ct1),
      static_cast<int*>(ci1), static_cast<float*>(ct2), N, D);
  return (int)cudaGetLastError();
}

}  // extern "C"
