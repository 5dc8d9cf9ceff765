// The Schur complement's product of bundle adjustment's PCG path, sm_90a.
//
// It replaces no Pallas kernel: the JAX package's cached-block PCG
// (monocularsfm_tpu/optim/ba.py) leaves this product to XLA, which fuses it
// over its cached layouts on the TPU.  Here one CG step's main work is
//
//   out = U_d x - sum_o W_o y_p(o),   y_p = Vi_p sum_{o of p} W_o^T x_c(o)
//
// over the O weighted observations o: W_o the cached 6x3 coupling block of
// observation o (row-major, (O, 6, 3)), Vi_p the damped 3x3 inverse of its
// point p, x and U_d per camera.  Without U_d (a process group's solve) the
// entry point writes the sum alone: the caller all-reduces it and takes it
// from U_d x.
//
// What bounds it on the H100: bytes.  Per observation it reads W_o (72
// bytes) and its point, camera and camera-order row (12 bytes), writes a
// 6-float payload and reads it back (48 bytes); per point it reads Vi_p (36
// bytes); about 80 flops an observation.  At the NEU global bundle
// (2,710,444 observations, 542,084 points) that is about 377 MB, 0.113 ms
// at 3.35 TB/s, against 0.003 ms of float32 arithmetic.  The plain version
// (ops/schur.py) writes and reads (O, 6, 3) temporaries and gathers: about
// five times the bytes.
//
// Two passes, no float atomics; every sum's order follows from the plans
// alone, so one input gives one result bit for bit:
//
// 1. points_pass.  The observations in point order (sorted by point: the
//    point plan's order, or as they come when they come sorted), cut into
//    tiles of kTile positions; a tile owns the points that start in it
//    (ops/schur.py's tile_starts), so it begins where a point begins.
//    Persistent blocks walk the tiles with a stride of the grid; each
//    stages a tile's W blocks and ids in shared memory with cp.async (16-
//    byte copies when the rows come sorted, a row gather through the order
//    otherwise) while it works on the tile before.  It computes
//    t = W^T x_c for each position, then the thread of each point's first
//    position sums the point's t in position order and applies Vi_p, and
//    each position writes W_o y_p to its row of the camera order.  Tracks
//    of up to kCap - kTile + 1 observations stay staged; the tile's last
//    point may run longer, and its thread finishes it from device memory
//    with the same arithmetic.  So a point's sum is always the sequential
//    sum over its positions, and a track of any length works.
// 2. cams_pass.  One block a camera sums the camera's contiguous payload
//    rows: each thread a strided sequential sum, then a fixed shuffle tree
//    in each warp and the warps' sums in order.  Six threads then form
//    U_d x - sum (or the sum alone).
//
// A payload row takes 8 floats (the last two zero), one whole 32-byte
// sector: the rows are stored scattered, and 6-float rows, which leave
// sectors part written, made a point pass 29% slower on the H100 (0.237
// against 0.184 ms at the NEU bundle) for a quarter fewer payload bytes.  The arithmetic uses the _rn intrinsics, so
// that the compiler contracts nothing differently between the staged and
// the device-memory paths.  Launched on the caller's stream; allocates
// nothing.  The entry point returns a CUDA error code (0 on success) after
// its launches.
//
// An optional device flag `active` (int32) gates both passes: where it reads
// 0 they return at once and leave payload and out as they were.  The PCG
// loop's CUDA graph (optim/pcg.py) replays blocks of CG steps past the
// solver's stop; there the flag keeps a step after the stop from changing
// anything and from costing the pair's bytes.  Eager callers pass null.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// A block owns the points that start in kTile consecutive positions of the
// point order (ops/schur.py's TILE cuts the tiles); it stages up to kCap
// positions, so tails of up to kCap - kTile + 1 observations stay staged.
constexpr int kTile = 128;
constexpr int kCap = kTile + 32;
constexpr int kPointThreads = 128;
constexpr int kCamThreads = 256;
constexpr int kW = 18;              // floats of one 6x3 block
constexpr int kRow = 8;             // floats of one payload row

// t = W^T x for a row-major 6x3 block w.
__device__ __forceinline__ void wt_x(const float* w, const float* x, float* t) {
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    float s = __fmul_rn(w[j], x[0]);
#pragma unroll
    for (int k = 1; k < 6; ++k) s = __fmaf_rn(w[3 * k + j], x[k], s);
    t[j] = s;
  }
}

// r = W y.
__device__ __forceinline__ void w_y(const float* w, const float* y, float* r) {
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    float s = __fmul_rn(w[3 * k], y[0]);
    s = __fmaf_rn(w[3 * k + 1], y[1], s);
    r[k] = __fmaf_rn(w[3 * k + 2], y[2], s);
  }
}

__device__ __forceinline__ void load_x(const float* __restrict__ x, int c,
                                       float* v) {
  const float2* p = reinterpret_cast<const float2*>(x + 6 * (size_t)c);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float2 a = __ldg(p + i);
    v[2 * i] = a.x;
    v[2 * i + 1] = a.y;
  }
}

__device__ __forceinline__ void load_w(const float* __restrict__ W, size_t o,
                                       float* w) {
  const float2* p = reinterpret_cast<const float2*>(W + kW * o);
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    const float2 a = __ldg(p + i);
    w[2 * i] = a.x;
    w[2 * i + 1] = a.y;
  }
}

// A payload row is 8 floats, the last two zero: one whole 32-byte sector.
__device__ __forceinline__ void store_row(float* __restrict__ payload, int row,
                                          const float* r) {
  float4* p = reinterpret_cast<float4*>(payload + kRow * (size_t)row);
  p[0] = make_float4(r[0], r[1], r[2], r[3]);
  p[1] = make_float4(r[4], r[5], 0.f, 0.f);
}

// One tile's staged inputs: its positions' W blocks (from the aligned float
// at or before the first one), points, cameras and camera-order rows.
struct __align__(16) Stage {
  float w[kCap * kW + 4];
  int pt[kCap + 1];                   // pt[i + 1]: point of position b0 + i
  int cam[kCap];
  int slot[kCap];
};
constexpr int kPointSmem = 2 * sizeof(Stage) + kCap * 3 * sizeof(float);

__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src)
                 : "memory");
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(d), "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src)
                 : "memory");
}

// Start the copies of positions [b0, b0 + min(b1 - b0, kCap)) into s.
__device__ __forceinline__ void stage_tile(
    Stage& s, const float* __restrict__ W, const int* __restrict__ order,
    const int* __restrict__ pt, const int* __restrict__ cam,
    const int* __restrict__ slot, int b0, int b1, int n) {
  const int cnt = min(b1 - b0, kCap), tid = threadIdx.x;
  for (int i = tid; i < cnt; i += kPointThreads) {
    cp_async(&s.pt[i + 1], pt + b0 + i, 4);
    cp_async(&s.cam[i], cam + b0 + i, 4);
    cp_async(&s.slot[i], slot + b0 + i, 4);
  }
  if (order == nullptr) {
    const size_t f0 = (size_t)b0 * kW, a0 = f0 & ~(size_t)3;
    const size_t end = (size_t)n * kW;
    const int nf = (int)(f0 - a0) + cnt * kW;
    for (int i = tid; 4 * i < nf; i += kPointThreads) {
      const size_t g = a0 + 4 * (size_t)i;
      if (g + 4 <= end) {
        cp_async(&s.w[4 * i], W + g, 16);
      } else {
        for (int k = 0; g + k < end; ++k) cp_async(&s.w[4 * i + k], W + g + k, 4);
      }
    }
  } else {
    for (int i = tid; i < cnt; i += kPointThreads) {
      const float* src = W + kW * (size_t)__ldg(order + b0 + i);
#pragma unroll
      for (int k = 0; k < 9; ++k) cp_async(&s.w[kW * i + 2 * k], src + 2 * k, 8);
    }
  }
}

// The products of one staged tile, positions [b0, b1).
__device__ __forceinline__ void tile_products(
    const Stage& s, float* sT, const float* __restrict__ W,
    const int* __restrict__ order, const int* __restrict__ cam,
    const int* __restrict__ slot, const float* __restrict__ Vi,
    const float* __restrict__ x, float* __restrict__ payload, int b0, int b1) {
  const int cnt = min(b1 - b0, kCap), tid = threadIdx.x;
  // Gathered rows start at s.w; a contiguous run at b0's offset from the
  // aligned float before it.
  const float* w0 = order ? s.w : s.w + (((size_t)b0 * kW) & 3);
  const int* sPt = s.pt;
  for (int i = tid; i < cnt; i += kPointThreads) {
    float xv[6];
    load_x(x, s.cam[i], xv);
    wt_x(w0 + kW * i, xv, sT + 3 * i);
  }
  __syncthreads();

  for (int i = tid; i < cnt; i += kPointThreads) {
    const int p = sPt[i + 1];
    if (p == sPt[i]) continue;        // not the first position of its point
    float z0 = sT[3 * i], z1 = sT[3 * i + 1], z2 = sT[3 * i + 2];
    int j = i + 1;
    for (; j < cnt && sPt[j + 1] == p; ++j) {
      z0 = __fadd_rn(z0, sT[3 * j]);
      z1 = __fadd_rn(z1, sT[3 * j + 1]);
      z2 = __fadd_rn(z2, sT[3 * j + 2]);
    }
    // Only the tile's last point can run past the staged positions, to b1.
    const int g0 = b0 + cnt, g1 = j == cnt ? b1 : g0;
    for (int g = g0; g < g1; ++g) {
      float w[kW], xv[6], t[3];
      load_w(W, order ? (size_t)__ldg(order + g) : (size_t)g, w);
      load_x(x, __ldg(cam + g), xv);
      wt_x(w, xv, t);
      z0 = __fadd_rn(z0, t[0]);
      z1 = __fadd_rn(z1, t[1]);
      z2 = __fadd_rn(z2, t[2]);
    }
    const float* v = Vi + 9 * (size_t)p;
    float y[3];
#pragma unroll
    for (int a = 0; a < 3; ++a)
      y[a] = __fmaf_rn(__ldg(v + 3 * a + 2), z2,
                       __fmaf_rn(__ldg(v + 3 * a + 1), z1,
                                 __fmul_rn(__ldg(v + 3 * a), z0)));
    for (int k = i; k < j; ++k) {
      sT[3 * k] = y[0];
      sT[3 * k + 1] = y[1];
      sT[3 * k + 2] = y[2];
    }
    for (int h = g0; h < g1; ++h) {
      float w[kW], r[6];
      load_w(W, order ? (size_t)__ldg(order + h) : (size_t)h, w);
      w_y(w, y, r);
      store_row(payload, __ldg(slot + h), r);
    }
  }
  __syncthreads();

  for (int i = tid; i < cnt; i += kPointThreads) {
    float r[6];
    w_y(w0 + kW * i, sT + 3 * i, r);
    store_row(payload, s.slot[i], r);
  }
}

// order: (n,) observation at each point-order position, or null where the
//   observations come in point order;
// pt, cam, slot: (n,) per point-order position, its point, its camera and
//   its row of the camera order; pt is non-decreasing;
// tile_start: (tiles + 1,) the first position of each tile's points;
// W (O, 6, 3), Vi (P, 3, 3), x (C, 6); active null or the gate; payload
// (n, 8) in camera order.
// Persistent blocks walk the tiles with a stride of the grid; each stages
// its next tile (cp.async, two stages) while it works on the current one.
__global__ void __launch_bounds__(kPointThreads)
points_pass(const float* __restrict__ W, const int* __restrict__ order,
            const int* __restrict__ pt, const int* __restrict__ cam,
            const int* __restrict__ slot, const float* __restrict__ Vi,
            const float* __restrict__ x, const int* __restrict__ tile_start,
            const int* __restrict__ active, float* __restrict__ payload, int n,
            int tiles) {
  if (active != nullptr && __ldg(active) == 0) return;
  extern __shared__ __align__(16) unsigned char smem[];
  Stage* st = reinterpret_cast<Stage*>(smem);
  float* sT = reinterpret_cast<float*>(st + 2);  // W^T x, then y, a position
  if (threadIdx.x == 0) st[0].pt[0] = st[1].pt[0] = -1;
  int tile = blockIdx.x;
  int b0 = __ldg(tile_start + tile), b1 = __ldg(tile_start + tile + 1);
  stage_tile(st[0], W, order, pt, cam, slot, b0, b1, n);
  asm volatile("cp.async.commit_group;" ::: "memory");
  for (int k = 0; tile < tiles; ++k, tile += gridDim.x) {
    const int next = tile + gridDim.x;
    int c0 = 0, c1 = 0;
    if (next < tiles) {
      c0 = __ldg(tile_start + next);
      c1 = __ldg(tile_start + next + 1);
      stage_tile(st[(k + 1) & 1], W, order, pt, cam, slot, c0, c1, n);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
    asm volatile("cp.async.wait_group 1;" ::: "memory");
    __syncthreads();
    if (b0 < b1)                      // else inside a point of an earlier tile
      tile_products(st[k & 1], sT, W, order, cam, slot, Vi, x, payload, b0, b1);
    __syncthreads();
    b0 = c0;
    b1 = c1;
  }
}

// payload (n, 8) in camera order; start (C + 1,) each camera's first row;
// U (C, 6, 6) or null, x (C, 6); active null or the gate; out (C, 6).
__global__ void __launch_bounds__(kCamThreads)
cams_pass(const float* __restrict__ payload, const int* __restrict__ start,
          const float* __restrict__ U, const float* __restrict__ x,
          const int* __restrict__ active, float* __restrict__ out) {
  if (active != nullptr && __ldg(active) == 0) return;
  __shared__ float part[kCamThreads / 32][6];
  const int c = blockIdx.x, tid = threadIdx.x;
  const int b = __ldg(start + c), e = __ldg(start + c + 1);
  float a[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
  for (int r = b + tid; r < e; r += kCamThreads) {
    const float4* p = reinterpret_cast<const float4*>(payload + kRow * (size_t)r);
    const float4 u = __ldcs(p), v = __ldcs(p + 1);
    a[0] = __fadd_rn(a[0], u.x);
    a[1] = __fadd_rn(a[1], u.y);
    a[2] = __fadd_rn(a[2], u.z);
    a[3] = __fadd_rn(a[3], u.w);
    a[4] = __fadd_rn(a[4], v.x);
    a[5] = __fadd_rn(a[5], v.y);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int k = 0; k < 6; ++k)
      a[k] = __fadd_rn(a[k], __shfl_down_sync(0xffffffffu, a[k], off));
  if ((tid & 31) == 0)
#pragma unroll
    for (int k = 0; k < 6; ++k) part[tid >> 5][k] = a[k];
  __syncthreads();
  if (tid < 6) {
    float s = part[0][tid];
#pragma unroll
    for (int w = 1; w < kCamThreads / 32; ++w) s = __fadd_rn(s, part[w][tid]);
    if (U != nullptr) {
      const float* u = U + 36 * (size_t)c + 6 * tid;
      const float* xc = x + 6 * (size_t)c;
      float ux = __fmul_rn(__ldg(u), __ldg(xc));
#pragma unroll
      for (int m = 1; m < 6; ++m) ux = __fmaf_rn(__ldg(u + m), __ldg(xc + m), ux);
      s = __fsub_rn(ux, s);
    }
    out[6 * (size_t)c + tid] = s;
  }
}

constexpr int kMaxDevices = 64;
int resident_blocks[kMaxDevices];     // the point pass's grid, by device

}  // namespace

extern "C" {

// U_d x - sum_o W_o Vi_p W_o^T x (or the sum alone where U is null) into
// out (C, 6); payload is (n, 8) scratch; tile_start (tiles + 1,) cut with
// `tile` positions a tile, which must be kTile.  Where active is not null
// and reads 0 on the device, both passes leave payload and out untouched.
// The index arrays are int32; the float arrays float32, contiguous, 16-byte
// aligned.
int sfm_schur_product(const float* W, const int* order, const int* pt,
                      const int* cam, const int* slot, const float* Vi,
                      const float* x, const int* tile_start,
                      const int* cam_start, const float* U, const int* active,
                      float* payload, float* out, int n, int tile, int tiles,
                      int C, void* stream) {
  if (n < 0 || C < 0 || n > (1 << 30) || tile != kTile
      || tiles != (n + kTile - 1) / kTile)
    return (int)cudaErrorInvalidValue;
  if (C == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (n > 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
    if (resident_blocks[dev] == 0) {  // once a device: as many as fit at once
      int sms = 0, per_sm = 0;
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (err == cudaSuccess)
        err = cudaFuncSetAttribute(points_pass,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   kPointSmem);
      if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, points_pass, kPointThreads, kPointSmem);
      if (err != cudaSuccess) return (int)err;
      resident_blocks[dev] = sms * max(per_sm, 1);
    }
    points_pass<<<min(tiles, resident_blocks[dev]), kPointThreads, kPointSmem,
                  st>>>(W, order, pt, cam, slot, Vi, x, tile_start, active,
                        payload, n, tiles);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  cams_pass<<<C, kCamThreads, 0, st>>>(payload, cam_start, U, x, active, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
