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
// What bounds them on the H100: memory.  The vertical pass does C*T FMAs per
// input pixel (155 at C=5/T=31) against 4 bytes read and 4*C written, far
// below the ~20 flop/byte where fp32 FMA throughput would bind.  So each
// vertical thread reads its T input rows once and feeds all C channels from
// them, and the horizontal pass stages a row segment plus its halo in shared
// memory so every input is read from device memory once.  Borders read
// clamped indices instead of the edge-padded copies the TPU version builds
// with jnp.pad (those and its (8, 128) alignment padding exist only for
// Mosaic's DMA rules).  The vertical result still makes one round trip
// through device memory between the passes; doing both from one shared
// tile is later work.
//
// Launched on the caller's stream; allocates nothing.  Each entry point
// returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxC = 8;
constexpr int kMaxTaps = 1024;   // C * T
constexpr int kVx = 32, kVy = 8; // vertical block
constexpr int kHx = 128;         // horizontal block (one row segment)
constexpr int kMaxT = 127;       // horizontal halo bound: T - 1 <= kMaxT - 1

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__global__ void blur_v_kernel(const float* __restrict__ in,
                              const float* __restrict__ taps,
                              float* __restrict__ out,
                              int H, int W, int C, int T) {
  __shared__ float k[kMaxTaps];
  const int tid = threadIdx.y * kVx + threadIdx.x;
  for (int i = tid; i < C * T; i += kVx * kVy) k[i] = taps[i];
  __syncthreads();

  const int x = blockIdx.x * kVx + threadIdx.x;
  const int y = blockIdx.y * kVy + threadIdx.y;
  const int b = blockIdx.z;
  if (x >= W || y >= H) return;
  const int r = (T - 1) / 2;
  const float* src = in + (size_t)b * H * W + x;

  float acc[kMaxC];
#pragma unroll
  for (int c = 0; c < kMaxC; ++c) acc[c] = 0.f;
  for (int t = 0; t < T; ++t) {
    const float v = __ldg(src + (size_t)clampi(y + t - r, 0, H - 1) * W);
#pragma unroll
    for (int c = 0; c < kMaxC; ++c)
      if (c < C) acc[c] = fmaf(k[c * T + t], v, acc[c]);
  }
  const size_t plane = (size_t)H * W;
  float* dst = out + (size_t)b * C * plane + (size_t)y * W + x;
#pragma unroll
  for (int c = 0; c < kMaxC; ++c)
    if (c < C) dst[c * plane] = acc[c];
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

// in (B, H, W), taps (C, T), out (B, C, H, W); all f32, contiguous.
int sfm_blur_v(const float* in, const float* taps, float* out, int B, int H,
               int W, int C, int T, void* stream) {
  if (C < 1 || C > kMaxC || T < 1 || C * T > kMaxTaps)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0 || W == 0) return 0;
  dim3 block(kVx, kVy);
  dim3 grid((W + kVx - 1) / kVx, (H + kVy - 1) / kVy, B);
  blur_v_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(in, taps, out, H,
                                                          W, C, T);
  return (int)cudaGetLastError();
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
