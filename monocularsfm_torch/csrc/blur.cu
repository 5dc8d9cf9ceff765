// Separable multi-channel Gaussian blur with replicated borders, sm_90a.
//
// Replaces the two Pallas TPU kernels of monocularsfm_tpu/ops/pallas_blur.py:
//   sfm_blur_v  <- _blur_v_kernel  (vertical pass)
//   sfm_blur_h  <- _blur_h_kernel  (horizontal pass)
// Together (through ops/blur.py::blur_multi) they map a (B, H, W) f32 base
// to (B, C, H, W): channel c blurred with taps[c] along both axes.  The
// pipeline calls them with C=1/T=9 (the base blur) and C=5/T=31 (the octave
// stack).
//
// What bounds them on the H100: memory.  The vertical pass reads 4 bytes
// and writes 4*C per pixel; its C*T FMAs (155 at C=5/T=31) take about two
// thirds of the time the bytes take.  So the vertical pass is a single-read
// strip: a block of 32 x 8 threads owns 32 * VEC columns and kStrip output
// rows, copies the (kStrip + T - 1)-row input slab into shared memory once
// with cp.async (16 bytes a thread where W % 4 == 0, 4 bytes on ragged
// widths), and each thread then sums VEC columns of its rows from there,
// t ascending per channel as the first version did, so the outputs are
// bit-identical to it.  Device memory sees each input about once (the slab
// overlap, (T - 1) / kStrip, is served by L2) and each output once, written
// with streaming stores.  For the two (C, T) the pipeline uses the kernel is
// instantiated at compile time, the tap loops unroll and the taps travel in
// the kernel's parameters (constant bank operands of the FMAs); any other
// (C <= 8, T <= 127) takes the runtime instantiation, whose taps travel in
// the parameters too (4064 bytes).  The horizontal pass stages a row segment plus its halo
// in shared memory, so every input is read from device memory once.
// Borders read clamped indices instead of the edge-padded copies the TPU
// version builds with jnp.pad.  The vertical result still makes one round
// trip through device memory between the passes; doing both from one
// shared tile is later work.
//
// Launched on the caller's stream; allocates nothing.  Each entry point
// returns a CUDA error code (0 on success) after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxC = 8;
constexpr int kHx = 128;         // horizontal block (one row segment)
constexpr int kMaxT = 127;       // T - 1 <= kMaxT - 1 (halo and slab bound)
constexpr int kSx = 32, kSy = 8; // vertical block: column groups x row lanes
constexpr int kStrip = 64;       // output rows of a vertical block

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Taps (C, T) row-major, passed by value in the kernel's parameters: N is
// C * T for a compile-time (C, T) and kMaxC * kMaxT (4064 bytes) otherwise.
template <int N>
struct Taps {
  float k[N];
};

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
    const float* src = plane + (size_t)clampi(y0 + row, 0, H - 1) * W + x;
    const uint32_t dst = static_cast<uint32_t>(
        __cvta_generic_to_shared(slab + row * (kSx * VEC) + g * VEC));
    if (VEC == 4)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst),
                   "l"(src)
                   : "memory");
    else
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst),
                   "l"(src)
                   : "memory");
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  __syncthreads();
}

template <int CC, int TT>
using TapsOf = Taps<CC ? CC * TT : kMaxC * kMaxT>;

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

template <int CC, int TT, int VEC>
cudaError_t launch_v(const float* in, const float* taps_host, float* out,
                     int B, int H, int W, int C, int T, cudaStream_t stream) {
  TapsOf<CC, TT> taps{};
  for (int i = 0; i < C * T; ++i) taps.k[i] = taps_host[i];
  const int smem = (kStrip + T - 1) * kSx * VEC * 4;
  auto kernel = blur_v_kernel<CC, TT, VEC>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  dim3 block(kSx, kSy);
  dim3 grid((W + kSx * VEC - 1) / (kSx * VEC), (H + kStrip - 1) / kStrip, B);
  kernel<<<grid, block, smem, stream>>>(in, taps, out, H, W, C, T);
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

__global__ void blur_h_kernel(const float* __restrict__ in,
                              const float* __restrict__ taps,
                              float* __restrict__ out,
                              int H, int W, int C, int T) {
  __shared__ float k[kMaxT];
  __shared__ float row[kHx + kMaxT];
  const int bc = blockIdx.z;          // b * C + c
  const int c = bc % C;
  const int y = blockIdx.y;
  const int x0 = blockIdx.x * kHx;
  const int r = (T - 1) / 2;
  for (int i = threadIdx.x; i < T; i += kHx) k[i] = taps[c * T + i];
  const float* src = in + ((size_t)bc * H + y) * W;
  for (int i = threadIdx.x; i < kHx + T - 1; i += kHx)
    row[i] = __ldg(src + clampi(x0 + i - r, 0, W - 1));
  __syncthreads();

  const int x = x0 + threadIdx.x;
  if (x >= W) return;
  float acc = 0.f;
  for (int t = 0; t < T; ++t) acc = fmaf(k[t], row[threadIdx.x + t], acc);
  out[((size_t)bc * H + y) * W + x] = acc;
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

// in (B, C, H, W), taps (C, T), out (B, C, H, W); all f32, contiguous.
int sfm_blur_h(const float* in, const float* taps, float* out, int B, int H,
               int W, int C, int T, void* stream) {
  if (C < 1 || T < 1 || T > kMaxT) return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0 || W == 0) return 0;
  dim3 grid((W + kHx - 1) / kHx, H, B * C);
  blur_h_kernel<<<grid, kHx, 0, (cudaStream_t)stream>>>(in, taps, out, H, W,
                                                        C, T);
  return (int)cudaGetLastError();
}

const char* sfm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
