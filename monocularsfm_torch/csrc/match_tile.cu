// Fused descriptor similarity + top-2 statistics on the tensor cores, sm_90a.
//
// Replaces the Pallas TPU kernel monocularsfm_tpu/ops/pallas_matching.py::
// _match_tile_kernel (with the grid of _match_stats_pallas).  For each image
// pair p = (ia, ib) of a batch it scans the similarity matrix A.B^T (bf16
// operands, f32 accumulation, masked rows and columns set to NEG = -1e30)
// and writes, per row of A, the maximum, its column (the first one on ties)
// and the runner-up, final; and per column of B the same statistics over
// each block of 128 rows, which ops/match_kernel.py merges (the earlier
// block wins ties).  A and B are two operand sides, each a bank of images
// with its own capacity (N_a rows of A, N_b of B, each a multiple of 128),
// as the reference takes n_a and n_b apart; the batched matcher passes one
// bank as both.  The N_a x N_b similarities never reach device memory.
//
// What bounds it on the H100: the top-2 epilogue.  Each pair is 2 N_a N_b D
// flops (17 GFLOP at N_a = N_b = 8192, D = 128), 17 us at the bf16 tensor-core
// peak; folding each of its similarities into a row and a column top-2
// costs about a dozen instructions on the CUDA cores, several times that,
// and with one 200 KB CTA (8 consumer warps) per SM their dependent
// compare-selects and shared-memory loads wait on latency (PERF.md).
//
// Design.  One CTA per (pair, block of 128 rows of A) walks every 128-column
// tile of B in ascending order (a grid of N_a / 128 x P, N_b / 128 tiles
// each):
//   - warpgroup 2 (the producer; one thread issues, and the warpgroup
//     gives its registers to the consumers with setmaxnreg) loads the A
//     block once with TMA through A's tensor map and streams the B tiles
//     through B's (and their 128 mask bytes) through a ring of kStages
//     stages, 128-byte swizzle, completion on mbarriers;
//   - warpgroups 0 and 1 (64 rows each) run bf16 wgmma m64n128k16, eight
//     k-steps over D = 128, into a register accumulator, and fold it; the
//     two warpgroups run apart (ping-pong), so one's product runs on the
//     tensor cores while the other folds on the CUDA cores.  (A second
//     accumulator per warpgroup, to overlap within it, measured slower:
//     ptxas serialized its wgmma.);
//   - rows: each thread folds its two rows' values of a tile in ascending
//     column order (strict >, so the first index wins; four independent
//     chains per row over ascending column ranges, joined in order) and
//     merges the tile into a running top-2 kept in registers across all
//     tiles; at the end the four lanes of a quad that share a row merge
//     (smaller index wins) and the row statistics are written once;
//   - columns: each warpgroup puts its 64 rows of the tile through shared
//     memory (a row stride of 136 floats keeps the float2 stores free of
//     bank conflicts) under its own named barrier, each thread folds one
//     column over those rows (four chains of 16), and warpgroup 1 hands
//     its half to warpgroup 0 through a double buffer guarded by
//     mbarriers, which merges them into the block's column partial; the
//     two warpgroups never meet at a barrier;
//   - masks: masked columns read NEG in the row fold and masked rows in the
//     shared tile, by selects and minima with no branch, so all threads
//     reach the named barriers together.
//
// Launched on the caller's stream; allocates nothing.  The tensor maps are
// encoded on the host per call through the driver entry point that the
// runtime hands out, so the library needs no -lcuda.  Returns a CUDA error
// code (0 on success) after the launch.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 128;                  // rows of A per CTA
constexpr int kCols = 128;                  // columns of B per tile
constexpr int kDepth = 128;                 // descriptor length D
constexpr int kStages = 3;                  // B ring
constexpr int kHalfBytes = 128 * 128;       // one TMA box: 128 rows x 64 bf16
constexpr int kTileBytes = 2 * kHalfBytes;  // 128 rows x 128 bf16
constexpr int kConsumers = 256;             // warpgroups 0 and 1
constexpr int kThreads = kConsumers + 128;  // + the producer warpgroup
constexpr int kEStride = kCols + 8;         // epilogue row stride, floats
constexpr float kNeg = -1e30f;

// Dynamic shared memory, from a 1024-byte aligned base.
constexpr int kOffA = 0;
constexpr int kOffB = kOffA + kTileBytes;
constexpr int kOffE = kOffB + kStages * kTileBytes;
constexpr int kOffX = kOffE + kRows * kEStride * 4;
constexpr int kOffM = kOffX + 2 * 3 * kCols * 4;
constexpr int kOffBar = kOffM + kStages * kCols;
constexpr int kNumBars = 1 + 2 * kStages + 4;
constexpr int kSmemBytes = kOffBar + kNumBars * 8 + 1024;

struct Top2 {
  float v1;
  int i1;
  float v2;
};

// Merge two top-2 states; on equal maxima the smaller index wins.
__device__ __forceinline__ Top2 merge(Top2 a, Top2 b) {
  const bool take_b = b.v1 > a.v1 || (b.v1 == a.v1 && b.i1 < a.i1);
  Top2 w = take_b ? b : a;
  const Top2 l = take_b ? a : b;
  w.v2 = fmaxf(fmaxf(w.v2, l.v1), l.v2);
  return w;
}

// Fold one value whose index is larger than any seen into a top-2 state
// (strict >, so the first index wins).  The runner-up is the larger of the
// old runner-up and the smaller of the value and the old maximum.
__device__ __forceinline__ void push(Top2& s, float v, int idx) {
  s.i1 = v > s.v1 ? idx : s.i1;
  s.v2 = fmaxf(s.v2, fminf(v, s.v1));
  s.v1 = fmaxf(s.v1, v);
}

// Fold a state `t` whose indices all exceed those of `s` into `s`.
__device__ __forceinline__ void append(Top2& s, const Top2& t) {
  s.i1 = t.v1 > s.v1 ? t.i1 : s.i1;
  s.v2 = fmaxf(fmaxf(s.v2, t.v2), fminf(s.v1, t.v1));
  s.v1 = fmaxf(s.v1, t.v1);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` has completed.  The spin loop
// stays inside the asm, so the compiler sees no divergent branch next to
// the asynchronous wgmma (it would serialize them otherwise).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One TMA box of a bank (64 bf16 of depth starting at `k`, 128 rows
// starting at `row`) into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* map,
                                        uint32_t bar, int k, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(k), "r"(row)
      : "memory");
}

// `bytes` contiguous bytes (16-byte aligned, a multiple of 16) from device
// memory into shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major operand in 128-byte swizzle:
// 8-row atoms of 128 bytes, 1024 bytes apart (SBO); LBO unused.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) | (static_cast<uint64_t>(64) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma: used before an issue and after its wait, never in
// between (a read of an in-flight accumulator serializes the wgmma).
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x 128, f32) = A (64 x 16) . B (128 x 16)^T (+ D when scale_d).
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Issue the product of this warpgroup's 64 rows of A (at `a`) with one B
// tile (at `b`) into `acc`: eight k-steps of 16, 32 bytes apart inside a
// 128-byte swizzled row, the second four in the second TMA box.
__device__ __forceinline__ void issue_tile(float (&acc)[64], uint32_t a,
                                          uint32_t b) {
  fence_acc(acc);
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
  for (int s = 0; s < kDepth / 16; ++s) {
    const uint32_t off = (s / 4) * kHalfBytes + (s % 4) * 32;
    wgmma_m64n128k16(acc, sw128_desc(a + off), sw128_desc(b + off), s > 0);
  }
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// Named barrier of one consumer warpgroup (ids 1 and 2).
__device__ __forceinline__ void wg_sync(int id) {
  asm volatile("bar.sync %0, 128;" ::"r"(id) : "memory");
}

struct Consumer {
  // Accumulator layout of wgmma m64nN (f32), thread `lane` of warp `wi` of
  // the warpgroup: acc[i] is row 16 wi + lane / 4 + 8 ((i / 2) % 2) and
  // column 8 (i / 4) + 2 (lane % 4) + i % 2.
  int lane, half, r0;   // r0: this thread's first row within the CTA
  float lim0, lim1;     // +inf for a valid row, NEG for a masked one
  Top2 s0, s1;          // running row statistics (rows r0, r0 + 8)
  float* E;             // 128 x kEStride floats; rows 64 half .. are ours
  uint8_t* X;           // two buffers of a column half, (v1, i1, v2) x 128
  uint32_t x_full, x_free;  // their mbarriers (two each, 8 bytes apart)

  // Column-mask bits of this thread's 32 columns of the tile staged at `m`.
  __device__ __forceinline__ uint32_t mask_bits(const uint8_t* m) const {
    uint32_t cm = 0;
#pragma unroll
    for (int q = 0; q < kCols / 8; ++q) {
      const uint16_t b =
          *reinterpret_cast<const uint16_t*>(m + 8 * q + 2 * (lane % 4));
      cm |= ((b & 0xFFu) ? 1u : 0u) << (2 * q);
      cm |= ((b >> 8) ? 1u : 0u) << (2 * q + 1);
    }
    return cm;
  }

  // Fold tile j into the row statistics and write the block's column
  // partial for it (ct1/ci1/ct2: this block's row of the partials).  `cm`:
  // this thread's column bits; `col_ok`: the mask of the column this
  // thread folds.  Each warpgroup
  // works on its own rows of E under its own named barrier, so the two
  // run apart and one's product overlaps the other's fold; warpgroup 1
  // hands its column half to warpgroup 0 through X (two buffers,
  // mbarriers).  No thread branches around a named barrier, and the
  // accumulators are only ever written by wgmma.
  __device__ __forceinline__ void epilogue(const float (&acc)[64], uint32_t cm,
                                           bool col_ok, int j, int row_base,
                                           float* __restrict__ ct1,
                                           int* __restrict__ ci1,
                                           float* __restrict__ ct2) {
    const int col0 = j * kCols;
    // After this warpgroup's reads of the previous tile's E.
    wg_sync(1 + half);
    fold_rows(acc, cm, col0);
    wg_sync(1 + half);
    fold_column(col_ok, j, col0, row_base, ct1, ci1, ct2);
  }

  // Rows, and this thread's values into E: masked columns read NEG in the
  // row fold (masked rows are set at the end), masked rows NEG in E, by
  // selects and minima.  Four chains per row over ascending column ranges,
  // so the dependent compare-selects of one chain overlap those of the
  // others.
  __device__ __forceinline__ void fold_rows(const float (&acc)[64],
                                            uint32_t cm, int col0) {
    Top2 t[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int k = 0; k < 4; ++k) t[h][k] = Top2{-INFINITY, 0, -INFINITY};
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int q = i / 4;
      const bool ok = (cm >> (2 * q + i % 2)) & 1u;
      push(t[(i / 2) % 2][q / 4], ok ? acc[i] : kNeg, 8 * q + i % 2);
    }
    const int cbase = col0 + 2 * (lane % 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int k = 1; k < 4; ++k) append(t[h][0], t[h][k]);
      t[h][0].i1 += cbase;
    }
    append(s0, t[0][0]);
    append(s1, t[1][0]);

    // Columns: the tile through shared memory.
#pragma unroll
    for (int q = 0; q < kCols / 8; ++q) {
      const int c = 8 * q + 2 * (lane % 4);
      *reinterpret_cast<float2*>(E + r0 * kEStride + c) = make_float2(
          fminf(acc[4 * q], lim0), fminf(acc[4 * q + 1], lim0));
      *reinterpret_cast<float2*>(E + (r0 + 8) * kEStride + c) = make_float2(
          fminf(acc[4 * q + 2], lim1), fminf(acc[4 * q + 3], lim1));
    }
  }

  // Fold this thread's column of the tile over its warpgroup's 64 rows of
  // E and merge the two halves into the block's column partial.
  __device__ __forceinline__ void fold_column(bool col_ok, int j, int col0,
                                              int row_base,
                                              float* __restrict__ ct1,
                                              int* __restrict__ ci1,
                                              float* __restrict__ ct2) {
    const int c = threadIdx.x % kCols;
    const float* e = E + 64 * half * kEStride + c;
    Top2 u[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) u[k] = Top2{-INFINITY, 0, -INFINITY};
#pragma unroll
    for (int r = 0; r < 16; ++r)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        push(u[k], e[(16 * k + r) * kEStride], 16 * k + r);
#pragma unroll
    for (int k = 1; k < 4; ++k) append(u[0], u[k]);
    Top2 s = u[0];
    s.i1 += row_base + 64 * half;
    if (!col_ok) s = Top2{kNeg, row_base + 64 * half, kNeg};
    const int buf = j & 1;
    const uint32_t round = (j >> 1) & 1;
    float* x1 = reinterpret_cast<float*>(X + buf * 3 * 4 * kCols);
    int* xi = reinterpret_cast<int*>(x1 + kCols);
    float* x2 = x1 + 2 * kCols;
    if (half) {
      mbar_wait(x_free + 8 * buf, round ^ 1);  // read by warpgroup 0 before
      x1[c] = s.v1;
      xi[c] = s.i1;
      x2[c] = s.v2;
      mbar_arrive(x_full + 8 * buf);
    } else {
      mbar_wait(x_full + 8 * buf, round);
      s = merge(s, Top2{x1[c], xi[c], x2[c]});
      mbar_arrive(x_free + 8 * buf);
      ct1[col0 + c] = s.v1;
      ci1[col0 + c] = s.i1;
      ct2[col0 + c] = s.v2;
    }
  }
};

__global__ void __launch_bounds__(kThreads, 1)
match_tile_kernel(const __grid_constant__ CUtensorMap map_a,
                  const __grid_constant__ CUtensorMap map_b,
                  const uint8_t* __restrict__ mask_a,
                  const uint8_t* __restrict__ mask_b,
                  const int* __restrict__ pairs, float* __restrict__ rt1,
                  int* __restrict__ ri1, float* __restrict__ rt2,
                  float* __restrict__ ct1, int* __restrict__ ci1,
                  float* __restrict__ ct2, int N_a, int N_b) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
  const uint32_t base = smem_u32(smem);
  const uint32_t sA = base + kOffA, sB = base + kOffB;
  const uint32_t bar_a = base + kOffBar;
  const uint32_t bar_full = bar_a + 8, bar_empty = bar_a + 8 + 8 * kStages;

  const int rb = blockIdx.x, p = blockIdx.y;
  const int G = gridDim.x, tiles = N_b / kCols;
  const int ia = pairs[2 * p], ib = pairs[2 * p + 1];
  const int row_base = rb * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(bar_a, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, kConsumers);
    }
    for (int b = 0; b < 4; ++b) mbar_init(bar_empty + 8 * (kStages + b), 128);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // Producer: one thread issues every copy.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    if (threadIdx.x == kConsumers) {
      const int arow = ia * N_a + row_base;
      mbar_expect_tx(bar_a, kTileBytes);
      tma_box(sA, &map_a, bar_a, 0, arow);
      tma_box(sA + kHalfBytes, &map_a, bar_a, 64, arow);
      for (int j = 0; j < tiles; ++j) {
        const int s = j % kStages;
        mbar_wait(bar_empty + 8 * s, ((j / kStages) & 1) ^ 1);
        const uint32_t full = bar_full + 8 * s;
        mbar_expect_tx(full, kTileBytes + kCols);
        const uint32_t dst = sB + s * kTileBytes;
        const int brow = ib * N_b + j * kCols;
        tma_box(dst, &map_b, full, 0, brow);
        tma_box(dst + kHalfBytes, &map_b, full, 64, brow);
        bulk_copy(base + kOffM + s * kCols, mask_b + (size_t)brow, kCols,
                  full);
      }
    }
  } else {
    // Consumers: warpgroup `half` owns rows 64 half .. 64 half + 63.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
    Consumer cs;
    cs.lane = lane;
    cs.half = threadIdx.x / 128;
    cs.r0 = 64 * cs.half + 16 * (warp % 4) + lane / 4;
    const bool ok0 = mask_a[(size_t)ia * N_a + row_base + cs.r0] != 0;
    const bool ok1 = mask_a[(size_t)ia * N_a + row_base + cs.r0 + 8] != 0;
    cs.lim0 = ok0 ? INFINITY : kNeg;
    cs.lim1 = ok1 ? INFINITY : kNeg;
    cs.s0 = Top2{-INFINITY, 0, -INFINITY};
    cs.s1 = cs.s0;
    cs.E = reinterpret_cast<float*>(smem + kOffE);
    cs.X = smem + kOffX;
    cs.x_full = bar_empty + 8 * kStages;
    cs.x_free = cs.x_full + 16;
    const uint8_t* sM = smem + kOffM;
    const uint32_t a_wg = sA + cs.half * (64 * 128);
    // This block's row of the column partials, (P, G, N_b) at p * G + rb.
    // (Offsetting the pointers once, not each store, keeps the square
    // pair's time of the one-bank kernel; tools/kernel_ab.py --mode match.)
    const size_t col_out = ((size_t)p * G + rb) * N_b;
    ct1 += col_out;
    ci1 += col_out;
    ct2 += col_out;

    float acc[64];
    mbar_wait(bar_a, 0);
    for (int j = 0; j < tiles; ++j) {
      const int s = j % kStages;
      mbar_wait(bar_full + 8 * s, (j / kStages) & 1);
      issue_tile(acc, a_wg, sB + s * kTileBytes);
      wgmma_wait_all();
      fence_acc(acc);
      const uint8_t* m = sM + s * kCols;
      const uint32_t cm = cs.mask_bits(m);
      const bool col_ok = m[threadIdx.x % kCols] != 0;
      mbar_arrive(bar_empty + 8 * s);
      cs.epilogue(acc, cm, col_ok, j, row_base, ct1, ci1, ct2);
    }

    // Rows: merge the four lanes of each quad, which hold the same rows.
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      Top2 o0{__shfl_xor_sync(0xFFFFFFFFu, cs.s0.v1, off),
              __shfl_xor_sync(0xFFFFFFFFu, cs.s0.i1, off),
              __shfl_xor_sync(0xFFFFFFFFu, cs.s0.v2, off)};
      Top2 o1{__shfl_xor_sync(0xFFFFFFFFu, cs.s1.v1, off),
              __shfl_xor_sync(0xFFFFFFFFu, cs.s1.i1, off),
              __shfl_xor_sync(0xFFFFFFFFu, cs.s1.v2, off)};
      cs.s0 = merge(cs.s0, o0);
      cs.s1 = merge(cs.s1, o1);
    }
    // A masked row reads NEG everywhere: its first column wins.
    if (cs.lim0 < 0.f) cs.s0 = Top2{kNeg, 0, kNeg};
    if (cs.lim1 < 0.f) cs.s1 = Top2{kNeg, 0, kNeg};
    if (lane % 4 == 0) {
      const size_t o = (size_t)p * N_a + row_base + cs.r0;
      rt1[o] = cs.s0.v1;
      ri1[o] = cs.s0.i1;
      rt2[o] = cs.s0.v2;
      rt1[o + 8] = cs.s1.v1;
      ri1[o + 8] = cs.s1.i1;
      rt2[o + 8] = cs.s1.v2;
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// The tensor map of a bank of `rows` rows of 128 bf16: boxes of 128 rows x
// 64 bf16, 128-byte swizzle.
bool encode_bank(EncodeTiled encode, CUtensorMap* map, const void* bank,
                 long long rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)kDepth, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)kDepth * 2};
  const cuuint32_t box[2] = {64, kCols};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(bank), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

extern "C" {

// Side A: bank_a (I_a, N_a, 128) bf16 and mask_a (I_a, N_a) uint8; side B
// likewise with I_b, N_b (the same pointers for one bank); every pointer
// 16-byte aligned.  pairs (P, 2) int32: (row of bank A, row of bank B).
// Writes the row statistics rt1/ri1/rt2 (P, N_a) and the column partials
// ct1/ci1/ct2 (P, N_a / 128, N_b): t1 f32, argmax int32, t2 f32.  N_a and
// N_b must be multiples of 128 and D 128.
int sfm_match_tile(const void* bank_a, const void* mask_a, int I_a, int N_a,
                   const void* bank_b, const void* mask_b, int I_b, int N_b,
                   const void* pairs, void* rt1, void* ri1, void* rt2,
                   void* ct1, void* ci1, void* ct2, int P, int D,
                   void* stream) {
  if (N_a < 0 || N_b < 0 || N_a % kRows != 0 || N_b % kCols != 0 ||
      D != kDepth || I_a <= 0 || I_b <= 0 ||
      reinterpret_cast<uintptr_t>(bank_a) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(mask_a) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(bank_b) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(mask_b) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (P == 0 || N_a == 0 || N_b == 0) return 0;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap map_a, map_b;
  if (!encode_bank(encode, &map_a, bank_a, (long long)I_a * N_a) ||
      !encode_bank(encode, &map_b, bank_b, (long long)I_b * N_b))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      match_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(N_a / kRows, P);
  match_tile_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      map_a, map_b, static_cast<const uint8_t*>(mask_a),
      static_cast<const uint8_t*>(mask_b), static_cast<const int*>(pairs),
      static_cast<float*>(rt1), static_cast<int*>(ri1),
      static_cast<float*>(rt2), static_cast<float*>(ct1),
      static_cast<int*>(ci1), static_cast<float*>(ct2), N_a, N_b);
  return (int)cudaGetLastError();
}

}  // extern "C"
