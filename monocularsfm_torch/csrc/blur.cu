// Separable multi-channel Gaussian blur with replicated borders, sm_90a.
//
// Replaces the two Pallas TPU kernels of monocularsfm_tpu/ops/pallas_blur.py:
//   sfm_blur_vh <- _blur_v_kernel then _blur_h_kernel, fused (the main path)
//   sfm_blur_v  <- _blur_v_kernel  (vertical pass alone)
//   sfm_blur_h  <- _blur_h_kernel  (horizontal pass alone)
// They map a (B, H, W) f32 base to (B, C, H, W): channel c blurred with
// taps[c] along both axes.  The pipeline calls sfm_blur_vh (through
// ops/blur.py::blur_multi) with C=1/T=9 (the base blur) and C=5/T=31 (the
// octave stack); the two single passes stay for checks and comparisons.
//
// Sum order, the same in every kernel: acc = 0, then fmaf with t ascending,
// on each axis.  So sfm_blur_vh equals sfm_blur_h(sfm_blur_v(x)) bit for
// bit, and so did every earlier version of the two passes.
//
// What bounds them on the H100.  The fused pass reads 4 bytes and writes
// 4*C per pixel and does 2*C*T FMAs per pixel: at C=5/T=31 its operations
// (0.18 ms at the fp32 peak on the (4, 1920, 2560) octave-0 stack) outweigh
// its bytes (0.14 ms), at C=1/T=9 its bytes do.  The vertical pass alone
// and the horizontal pass alone are set by their bytes.
//
// sfm_blur_vh.  A block owns a tile of kTW = 128 output columns by TH
// output rows of one image, for all C channels:
//   1. it stages the input slab, rows y0 - r .. y0 + TH + r - 1 and columns
//      x0 - R4 .. x0 + kTW + R4 - 1 (R4 = r rounded up to 4, so every row
//      segment starts 16-byte aligned), clamped to the image, into shared
//      memory with cp.async: 16-byte copies where the four columns lie in
//      the image, four clamped 4-byte copies on the edges and ragged widths;
//   2. the vertical pass writes V, C x TH x (kTW + 2 R4) floats in shared
//      memory, halo columns included.  A halo column is computed on its
//      clamped input column, which is the value blur_h reads at a clamped
//      index.  Each thread holds one column and RV rows and slides its
//      window down the slab: one shared load for RV * C FMAs;
//   3. __syncthreads, then the horizontal pass from V: each thread computes
//      kHVec = 8 adjacent outputs of a row from a register window of
//      kHVec + T - 1 values (read as float4, about five FMAs per loaded
//      word at T=31), with the taps as constant operands, and writes them
//      with streaming stores, to an output whose images lie `out_bstride`
//      floats apart (so it can fill channels 1..C of an octave stack).
// The input is read from device memory about once (the slab overlap is
// served by L2) and the output written once; V never leaves the SM.  V
// holds all channels so that the vertical window serves every channel,
// which keeps shared-memory loads under the FMA time.
// Tiles (fused_rows and the knobs beside it): at C=5/T=31, TH = 24 rows,
// 384 threads, RV = 4, 111 KB of shared memory (slab 34 KB, V 77 KB), two
// blocks and 24 warps per SM; the blocks are persistent, each walking the
// tiles with a stride of the grid and loading its next slab during the
// horizontal pass.  At C=1/T=9, TH = 32 rows, 256 threads, RV = 2, 42 KB,
// one tile per block.  Any other (C, T): TH = 8, at most 199 KB at
// C=8/T=127.  The vertical pass over the halo columns adds 2 R4 / kTW to
// its FMAs (25% at T=31).  tools/blur_ablation.py times these choices
// against others and splits the time.
//
// Bank conflicts.  V's row pitch is 4 (mod 32) floats and a warp's lanes
// map to 16 column groups x 2 rows so that each quarter-warp's float4
// loads cover all 32 banks once; the vertical pass's lanes read and write
// consecutive columns.
//
// sfm_blur_h stages C channels' rows (TH = 16, no vertical halo) the same
// way, in V's layout, and runs the same horizontal code.  sfm_blur_v is a
// single-read strip: a block of 32 x 8 threads owns 32 * VEC columns and
// kStrip output rows, copies the (kStrip + T - 1)-row input slab into shared
// memory once with cp.async (16 bytes a thread where W % 4 == 0, 4 bytes on
// ragged widths), and each thread then sums VEC columns of its rows.
//
// For the two (C, T) the pipeline uses the kernels are instantiated at
// compile time, the tap loops unroll and the taps travel in the kernel's
// parameters (constant bank operands of the FMAs); any other (C <= 8,
// T <= 127) takes the runtime instantiation, whose taps travel in the
// parameters too (4064 bytes).  Borders read clamped indices instead of the
// edge-padded copies the TPU version builds with jnp.pad.
//
// Launched on the caller's stream; allocates nothing.  Each entry point
// returns a CUDA error code (0 on success) after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxC = 8;
constexpr int kMaxT = 127;       // T - 1 <= kMaxT - 1 (halo and slab bound)
constexpr int kSx = 32, kSy = 8; // vertical block: column groups x row lanes
constexpr int kStrip = 64;       // output rows of a vertical block
constexpr int kTW = 128;         // output columns of a fused / horizontal tile
constexpr int kHThreads = 256;   // threads of a horizontal-only block
constexpr int kHVec = 8;         // adjacent outputs of a horizontal thread
constexpr int kHRows = 16;       // output rows of a horizontal-only tile

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// The halo r = (T - 1) / 2 rounded up to a multiple of 4.
__host__ __device__ constexpr int halo4(int T) { return ((T - 1) / 2 + 3) / 4 * 4; }
// Columns of a staged tile: kTW outputs and R4 halo columns on each side.
__host__ __device__ constexpr int tile_cols(int T) { return kTW + 2 * halo4(T); }
// Row pitch of V: at least tile_cols(T), and 4 (mod 32) floats.
__host__ __device__ constexpr int v_pitch(int T) {
  return tile_cols(T) + (36 - tile_cols(T) % 32) % 32;
}
// The fused kernel's tile at a compile-time (C, T), or at C = T = 0 the
// runtime one: output rows, threads, rows of a vertical thread, and whether
// its blocks are persistent.
__host__ __device__ constexpr int fused_rows(int C, int T) {
  return C == 5 && T == 31 ? 24 : (C == 1 && T == 9 ? 32 : 8);
}
__host__ __device__ constexpr int fused_threads(int C, int T) {
  return C == 5 && T == 31 ? 384 : 256;
}
__host__ __device__ constexpr int fused_vrows(int C, int T) {
  return C == 5 && T == 31 ? 4 : 2;
}
__host__ __device__ constexpr bool fused_persistent(int C, int T) {
  return C == 5 && T == 31;
}

// Taps (C, T) row-major, passed by value in the kernel's parameters: N is
// C * T for a compile-time (C, T) and kMaxC * kMaxT (4064 bytes) otherwise.
template <int N>
struct Taps {
  float k[N];
};

template <int CC, int TT>
using TapsOf = Taps<CC ? CC * TT : kMaxC * kMaxT>;

__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool vec) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if (vec)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src)
                 : "memory");
}

// Commits this thread's copies, waits for all of them, then syncs the
// block.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;" ::: "memory");
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  __syncthreads();
}

// Input rows clamp(y0 + i, 0, H - 1), i < rows, columns x0 .. x0 + 32 VEC - 1
// (those below W) of one (H, W) plane into `slab`, 32 VEC floats a row.
template <int VEC>
__device__ __forceinline__ void load_slab(const float* __restrict__ plane,
                                          float* slab, int H, int W, int x0,
                                          int y0, int rows) {
  const int tid = threadIdx.y * kSx + threadIdx.x;
  for (int i = tid; i < rows * kSx; i += kSx * kSy) {
    const int row = i / kSx, g = i % kSx;
    const int x = x0 + g * VEC;
    if (x >= W) continue;
    cp_async(slab + row * (kSx * VEC) + g * VEC,
             plane + (size_t)clampi(y0 + row, 0, H - 1) * W + x, VEC == 4);
  }
  cp_async_wait_all();
}

// Issues the copies of rows clamp(y0 + i, 0, H - 1), i < rows, and columns
// clamp(x0 + j, 0, W - 1), j < cols, of one (H, W) plane into
// dst[i * pitch + j].  x0, cols and pitch are multiples of 4; `vec`: the
// plane is 16-byte aligned and W % 4 == 0.
template <int NT>
__device__ __forceinline__ void copy_tile(const float* __restrict__ plane,
                                          float* dst, int pitch, int H, int W,
                                          int x0, int y0, int rows, int cols,
                                          bool vec) {
  const int groups = cols / 4;
  for (int i = threadIdx.x; i < rows * groups; i += NT) {
    const int row = i / groups, g = i - row * groups;
    const int x = x0 + 4 * g;
    const float* src = plane + (size_t)clampi(y0 + row, 0, H - 1) * W;
    float* d = dst + row * pitch + 4 * g;
    if (vec && x >= 0 && x + 4 <= W) {
      cp_async(d, src + x, true);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        cp_async(d + e, src + clampi(x + e, 0, W - 1), false);
    }
  }
}

// Vertical pass of a fused tile: V[c][y][j] for y < TH, j < tile_cols(T),
// from the slab (TH + T - 1 rows, pitch sw).  A warp task is 32 columns by
// RV rows; each thread slides an RV-row window down its column, one shared
// load for RV * C FMAs.
template <int CC, int TT, int TH, int NT, int RV>
__device__ __forceinline__ void v_pass(const float* slab, float* V,
                                       const TapsOf<CC, TT>& taps, int C,
                                       int T, int sw, int vp) {
  constexpr int kC = CC ? CC : kMaxC;
  const int lane = threadIdx.x & 31;
  const int chunks = (sw + 31) / 32;
  for (int task = threadIdx.x >> 5; task < chunks * (TH / RV); task += NT / 32) {
    const int j = (task % chunks) * 32 + lane;
    const int y = (task / chunks) * RV;
    if (j >= sw) continue;
    float acc[RV][kC];
#pragma unroll
    for (int q = 0; q < RV; ++q)
#pragma unroll
      for (int c = 0; c < kC; ++c) acc[q][c] = 0.f;
    const float* s = slab + y * sw + j;
    float w[RV];
#pragma unroll
    for (int q = 0; q + 1 < RV; ++q) w[q] = s[q * sw];
#pragma unroll
    for (int t = 0; t < T; ++t) {
      w[RV - 1] = s[(t + RV - 1) * sw];
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        if (CC || c < C) {
          const float kt = taps.k[c * T + t];
#pragma unroll
          for (int q = 0; q < RV; ++q) acc[q][c] = fmaf(kt, w[q], acc[q][c]);
        }
      }
#pragma unroll
      for (int q = 0; q + 1 < RV; ++q) w[q] = w[q + 1];
    }
#pragma unroll
    for (int c = 0; c < kC; ++c)
#pragma unroll
      for (int q = 0; q < RV; ++q)
        if (CC || c < C) V[(c * TH + y + q) * vp + j] = acc[q][c];
  }
}

// kHVec adjacent horizontal outputs of channel c: acc[e] = sum_t
// taps[c][t] * row[off + t + e] with off = halo4(T) - r, t ascending.
// `row` is 16-byte aligned.
template <int CC, int TT>
__device__ __forceinline__ void h_outputs(const float* row,
                                          const TapsOf<CC, TT>& taps, int c,
                                          int T, float (&acc)[kHVec]) {
#pragma unroll
  for (int e = 0; e < kHVec; ++e) acc[e] = 0.f;
  if constexpr (TT > 0) {
    constexpr int off = halo4(TT) - (TT - 1) / 2;
    constexpr int n4 = (off + kHVec + TT - 1 + 3) / 4;
    float w[4 * n4];
#pragma unroll
    for (int q = 0; q < n4; ++q) {
      const float4 f = reinterpret_cast<const float4*>(row)[q];
      w[4 * q] = f.x;
      w[4 * q + 1] = f.y;
      w[4 * q + 2] = f.z;
      w[4 * q + 3] = f.w;
    }
#pragma unroll
    for (int t = 0; t < TT; ++t) {
      const float kt = taps.k[c * T + t];
#pragma unroll
      for (int e = 0; e < kHVec; ++e) acc[e] = fmaf(kt, w[off + t + e], acc[e]);
    }
  } else {
    const float* p = row + halo4(T) - (T - 1) / 2;
    float w[kHVec];
#pragma unroll
    for (int e = 0; e < kHVec; ++e) w[e] = p[e];
    for (int t = 0; t < T; ++t) {
      const float kt = taps.k[c * T + t];
#pragma unroll
      for (int e = 0; e < kHVec; ++e) acc[e] = fmaf(kt, w[e], acc[e]);
#pragma unroll
      for (int e = 0; e + 1 < kHVec; ++e) w[e] = w[e + 1];
      if (t + 1 < T) w[kHVec - 1] = p[t + kHVec];
    }
  }
}

// Horizontal pass of a tile of TH rows and kTW columns for every channel,
// from V[c][y][j] (pitch vp, column j at image column x0 - halo4(T) + j),
// into out[c * plane + y * W + x] for y < rows, x < cols (out points at the
// tile's first output).  A warp task is two rows; lane l takes column
// group 4 (l / 8) + l % 4 of row (l / 4) % 2.
template <int CC, int TT, int TH, int NT>
__device__ __forceinline__ void h_pass(const float* V, int vp,
                                       const TapsOf<CC, TT>& taps, int C,
                                       int T, float* __restrict__ out,
                                       size_t plane, int W, int rows, int cols,
                                       bool vec_out) {
  constexpr int kC = CC ? CC : kMaxC;
  const int lane = threadIdx.x & 31;
  const int x = kHVec * (4 * (lane >> 3) + (lane & 3));
  for (int task = threadIdx.x >> 5; task < TH / 2; task += NT / 32) {
    const int y = 2 * task + ((lane >> 2) & 1);
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      if (!(CC || c < C)) continue;
      float acc[kHVec];
      h_outputs<CC, TT>(V + (c * TH + y) * vp + x, taps, c, T, acc);
      if (y >= rows) continue;
      float* d = out + c * plane + (size_t)y * W + x;
      if (vec_out && x + kHVec <= cols) {
#pragma unroll
        for (int q = 0; q < kHVec / 4; ++q)
          __stcs(reinterpret_cast<float4*>(d) + q,
                 make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2],
                             acc[4 * q + 3]));
      } else {
#pragma unroll
        for (int e = 0; e < kHVec; ++e)
          if (x + e < cols) __stcs(d + e, acc[e]);
      }
    }
  }
}

// Vertical pass.  CC/TT > 0: compile-time channels and taps (the tap loop
// unrolls, the taps are constant operands); CC = TT = 0: runtime C and T.
template <int CC, int TT, int VEC>
__global__ void __launch_bounds__(kSx * kSy)
blur_v_kernel(const float* __restrict__ in,
              const __grid_constant__ TapsOf<CC, TT> taps,
              float* __restrict__ out, int H, int W, int C_rt, int T_rt) {
  constexpr int kC = CC ? CC : kMaxC;  // accumulator rows
  const int C = CC ? CC : C_rt;
  const int T = TT ? TT : T_rt;
  extern __shared__ float4 smem4[];
  float* slab = reinterpret_cast<float*>(smem4);
  const int b = blockIdx.z;
  const int x0 = blockIdx.x * kSx * VEC, y0 = blockIdx.y * kStrip;
  const int r = (T - 1) / 2;
  const int out_rows = min(kStrip, H - y0);
  load_slab<VEC>(in + (size_t)b * H * W, slab, H, W, x0, y0 - r,
                 out_rows + T - 1);

  const int x = x0 + threadIdx.x * VEC;
  if (x >= W) return;
  const size_t plane = (size_t)H * W;
  float* dst = out + (size_t)b * C * plane + (size_t)y0 * W + x;
  for (int yl = threadIdx.y; yl < out_rows; yl += kSy) {
    float acc[kC][VEC];
#pragma unroll
    for (int c = 0; c < kC; ++c)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[c][e] = 0.f;
    const float* s = slab + yl * (kSx * VEC) + threadIdx.x * VEC;
#pragma unroll
    for (int t = 0; t < T; ++t) {
      float v[VEC];
      if (VEC == 4) {
        const float4 q = *reinterpret_cast<const float4*>(s + t * (kSx * VEC));
        v[0] = q.x;
        v[1] = q.y;
        v[2] = q.z;
        v[3] = q.w;
      } else {
        v[0] = s[t * (kSx * VEC)];
      }
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        if (CC || c < C) {
          const float w = taps.k[c * T + t];
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[c][e] = fmaf(w, v[e], acc[c][e]);
        }
      }
    }
    float* d = dst + (size_t)yl * W;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      if (CC || c < C) {
        if (VEC == 4)
          __stcs(reinterpret_cast<float4*>(d + c * plane),
                 make_float4(acc[c][0], acc[c][1], acc[c][2], acc[c][3]));
        else
          __stcs(d + c * plane, acc[c][0]);
      }
    }
  }
}

// Fused vertical + horizontal pass; see the note at the top.  Persistent:
// block i takes tiles i, i + gridDim.x, ... (tile = (b, row band, column
// band), column band fastest).
template <int CC, int TT>
__global__ void __launch_bounds__(fused_threads(CC, TT), 2)
blur_vh_kernel(const float* __restrict__ in,
               const __grid_constant__ TapsOf<CC, TT> taps,
               float* __restrict__ out, long long out_bstride, int B, int H,
               int W, int C_rt, int T_rt) {
  constexpr int TH = fused_rows(CC, TT), NT = fused_threads(CC, TT);
  const int C = CC ? CC : C_rt;
  const int T = TT ? TT : T_rt;
  const int sw = tile_cols(T), vp = v_pitch(T);
  extern __shared__ float4 smem4[];
  float* slab = reinterpret_cast<float*>(smem4);
  float* V = slab + (TH + T - 1) * sw;
  const int tiles_x = (W + kTW - 1) / kTW, tiles_y = (H + TH - 1) / TH;
  const int tiles = tiles_x * tiles_y * B;
  const bool vec = W % 4 == 0 && reinterpret_cast<uintptr_t>(in) % 16 == 0;
  const bool vec_out = W % 4 == 0 && out_bstride % 4 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const size_t plane = (size_t)H * W;
  auto load = [&](int tile) {
    const int tx = tile % tiles_x, rest = tile / tiles_x;
    copy_tile<NT>(in + (size_t)(rest / tiles_y) * plane, slab, sw, H, W,
                  tx * kTW - halo4(T), (rest % tiles_y) * TH - (T - 1) / 2,
                  TH + T - 1, sw, vec);
  };

  load(blockIdx.x);  // the grid has no more blocks than tiles
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    cp_async_wait_all();
    v_pass<CC, TT, TH, NT, fused_vrows(CC, TT)>(slab, V, taps, C, T, sw, vp);
    __syncthreads();
    if (tile + gridDim.x < tiles) load(tile + gridDim.x);  // during h_pass
    const int tx = tile % tiles_x, rest = tile / tiles_x;
    const int b = rest / tiles_y, x0 = tx * kTW, y0 = (rest % tiles_y) * TH;
    h_pass<CC, TT, TH, NT>(
        V, vp, taps, C, T, out + b * out_bstride + (size_t)y0 * W + x0, plane,
        W, min(TH, H - y0), min(kTW, W - x0), vec_out);
  }
}

// Horizontal pass alone over (B, C, H, W): a tile of kHRows x kTW outputs
// for every channel of one image, the rows staged in V's layout.
template <int CC, int TT>
__global__ void __launch_bounds__(kHThreads)
blur_h_kernel(const float* __restrict__ in,
              const __grid_constant__ TapsOf<CC, TT> taps,
              float* __restrict__ out, int H, int W, int C_rt, int T_rt) {
  const int C = CC ? CC : C_rt;
  const int T = TT ? TT : T_rt;
  const int vp = v_pitch(T);
  extern __shared__ float4 smem4[];
  float* V = reinterpret_cast<float*>(smem4);
  const int b = blockIdx.z;
  const int x0 = blockIdx.x * kTW, y0 = blockIdx.y * kHRows;
  const size_t plane = (size_t)H * W;
  const bool vec = W % 4 == 0 && reinterpret_cast<uintptr_t>(in) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const float* src = in + (size_t)b * C * plane;
  for (int c = 0; c < C; ++c)
    copy_tile<kHThreads>(src + c * plane, V + c * kHRows * vp, vp, H, W,
                         x0 - halo4(T), y0, kHRows, tile_cols(T), vec);
  cp_async_wait_all();
  h_pass<CC, TT, kHRows, kHThreads>(
      V, vp, taps, C, T, out + (size_t)b * C * plane + (size_t)y0 * W + x0,
      plane, W, min(kHRows, H - y0), min(kTW, W - x0), vec);
}

template <int CC, int TT>
TapsOf<CC, TT> taps_of(const float* taps_host, int C, int T) {
  TapsOf<CC, TT> taps{};
  for (int i = 0; i < C * T; ++i) taps.k[i] = taps_host[i];
  return taps;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

template <int CC, int TT, int VEC>
cudaError_t launch_v(const float* in, const float* taps_host, float* out,
                     int B, int H, int W, int C, int T, cudaStream_t stream) {
  const int smem = (kStrip + T - 1) * kSx * VEC * 4;
  auto kernel = blur_v_kernel<CC, TT, VEC>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 block(kSx, kSy);
  dim3 grid((W + kSx * VEC - 1) / (kSx * VEC), (H + kStrip - 1) / kStrip, B);
  kernel<<<grid, block, smem, stream>>>(in, taps_of<CC, TT>(taps_host, C, T),
                                        out, H, W, C, T);
  return cudaGetLastError();
}

template <int CC, int TT>
cudaError_t launch_v_vec(const float* in, const float* taps_host, float* out,
                         int B, int H, int W, int C, int T,
                         cudaStream_t stream) {
  const bool vec4 = W % 4 == 0 && reinterpret_cast<uintptr_t>(in) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  return vec4 ? launch_v<CC, TT, 4>(in, taps_host, out, B, H, W, C, T, stream)
              : launch_v<CC, TT, 1>(in, taps_host, out, B, H, W, C, T, stream);
}

template <int CC, int TT>
cudaError_t launch_vh(const float* in, const float* taps_host, float* out,
                      long long out_bstride, int B, int H, int W, int C, int T,
                      cudaStream_t stream) {
  const int TH = fused_rows(CC, TT), NT = fused_threads(CC, TT);
  const int smem = ((TH + T - 1) * tile_cols(T) + C * TH * v_pitch(T)) * 4;
  auto kernel = blur_vh_kernel<CC, TT>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  long long grid = (long long)((W + kTW - 1) / kTW) * ((H + TH - 1) / TH) * B;
  if (fused_persistent(CC, TT)) {  // as many blocks as fit on the card
    int device = 0, sms = 0, per_sm = 0;
    err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT,
                                                          smem);
    if (err != cudaSuccess) return err;
    if (per_sm == 0) return cudaErrorInvalidConfiguration;
    if (grid > (long long)sms * per_sm) grid = (long long)sms * per_sm;
  }
  kernel<<<(int)grid, NT, smem, stream>>>(
      in, taps_of<CC, TT>(taps_host, C, T), out, out_bstride, B, H, W, C, T);
  return cudaGetLastError();
}

template <int CC, int TT>
cudaError_t launch_h(const float* in, const float* taps_host, float* out,
                     int B, int H, int W, int C, int T, cudaStream_t stream) {
  const int smem = C * kHRows * v_pitch(T) * 4;
  auto kernel = blur_h_kernel<CC, TT>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((W + kTW - 1) / kTW, (H + kHRows - 1) / kHRows, B);
  kernel<<<grid, kHThreads, smem, stream>>>(
      in, taps_of<CC, TT>(taps_host, C, T), out, H, W, C, T);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// in (B, H, W) and out (B, C, H, W) f32, contiguous, on the device; taps
// (C, T) f32 on the host (copied into the launch's parameters).
int sfm_blur_v(const float* in, const float* taps, float* out, int B, int H,
               int W, int C, int T, void* stream) {
  if (C < 1 || C > kMaxC || T < 1 || T > kMaxT)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0 || W == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (C == 1 && T == 9)
    return (int)launch_v_vec<1, 9>(in, taps, out, B, H, W, C, T, st);
  if (C == 5 && T == 31)
    return (int)launch_v_vec<5, 31>(in, taps, out, B, H, W, C, T, st);
  return (int)launch_v_vec<0, 0>(in, taps, out, B, H, W, C, T, st);
}

// in (B, H, W) f32, contiguous; out: B images of (C, H, W) f32, each
// contiguous, `out_bstride` floats apart (C * H * W for a (B, C, H, W)
// tensor, (C + 1) * H * W for channels 1..C of an octave stack); taps
// (C, T) f32 on the host.
int sfm_blur_vh(const float* in, const float* taps, float* out,
                long long out_bstride, int B, int H, int W, int C, int T,
                void* stream) {
  if (C < 1 || C > kMaxC || T < 1 || T > kMaxT || T % 2 == 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0 || W == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (C == 1 && T == 9)
    return (int)launch_vh<1, 9>(in, taps, out, out_bstride, B, H, W, C, T, st);
  if (C == 5 && T == 31)
    return (int)launch_vh<5, 31>(in, taps, out, out_bstride, B, H, W, C, T, st);
  return (int)launch_vh<0, 0>(in, taps, out, out_bstride, B, H, W, C, T, st);
}

// in and out (B, C, H, W) f32, contiguous, on the device; taps (C, T) f32
// on the host.
int sfm_blur_h(const float* in, const float* taps, float* out, int B, int H,
               int W, int C, int T, void* stream) {
  if (C < 1 || C > kMaxC || T < 1 || T > kMaxT || T % 2 == 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0 || W == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (C == 1 && T == 9)
    return (int)launch_h<1, 9>(in, taps, out, B, H, W, C, T, st);
  if (C == 5 && T == 31)
    return (int)launch_h<5, 31>(in, taps, out, B, H, W, C, T, st);
  return (int)launch_h<0, 0>(in, taps, out, B, H, W, C, T, st);
}

const char* sfm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
