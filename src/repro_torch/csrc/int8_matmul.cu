// Integer matmul with per-token and per-channel scales, for weight-activation
// quantization (W4A8 / W4A4).
//
// Replaces the Pallas TPU kernel src/repro/kernels/int8_matmul.py
// (int8_matmul -> _i8mm_kernel).  Computes
//   out[m, n] = ((float)sum_k x_q[m, k] * w_q[k, n] * x_scale[m]) * w_scale[n]
// with
//   x_q     (M, K)  int8, row-major with row stride lda >= K (a column slice
//                   of a wider matrix is taken as it is, without a copy)
//   w_q     (K, N)  int8, row-major, contiguous (the reference's layout)
//   x_scale (M,)    f32 per token;  w_scale (N,) f32 per output channel
//   out     (M, N)  f32 or bf16 (out_f32)
// The int32 accumulator is exact in any order of the K sum, and the epilogue
// converts it to f32 (round to nearest) and multiplies by x_scale, then by
// w_scale, each rounded to nearest: the reference's order.  So the result is
// bit-identical to the plain version (kernels/int8_matmul.py::
// int8_matmul_plain, exact in float64) whatever the tile, the split of K or
// the order in which the splits are summed.
//
// What bounds it on an H100: at the prefill shape (M = 512) operations,
// 2*M*K*N int8 multiply-adds against (M + N)*K bytes (0.105 ms for one
// LLaMA-2-7B layer's 7 linears at 1,979 TOPS); at decode (M <= 16) the K*N
// weight bytes (202 MB a layer, 0.061 ms at 3.35 TB/s).
//
// Design (swap-AB: out^T = w_q^T x_q^T).  With 8-bit types wgmma reads a
// shared-memory operand only K-major.  x_q is K-major, so it is B, read from
// shared memory; w_q is N-major, so it is A, in wgmma's register (.rs) form,
// m64n{BM}k32.s32.s8.s8, accumulating in s32 registers.
// - Each stage (128 k bytes) holds the x tile (BM rows of 128 k bytes) and
//   the weight tile (128 k rows of 128 n bytes), both 128-byte swizzled,
//   brought by TMA from one producer warp into a ring of full / empty
//   mbarriers, so the two consumer warpgroups never meet at a block-wide
//   barrier.  x's tensor map carries the row stride lda (w4a8_matmul's
//   column slices).
// - Each consumer warp builds its A fragments for 16 output columns from
//   the weight tile: per 32-deep chunk one ldmatrix.x4.trans, which treats
//   each (n, n + 1) byte pair as one b16, and four byte permutes.  The
//   weight tile's k rows are stored permuted (w_row: a 5-D tensor map) so
//   that the eight rows of each ldmatrix phase fall on eight swizzle rows,
//   free of bank conflicts.
// - A consumer warpgroup builds a stage's four A fragments, issues its four
//   wgmma and waits for them before it writes the A registers again (ptxas
//   serializes a register-operand wgmma whose registers are rewritten while
//   another is in flight, C7513).
// - Two plans of one template (make_plan): M > 16 takes a BM = 128 m tile
//   (2 consumer warpgroups of 64 n + the producer; 6 stages of 32 KB);
//   M <= 16 takes a 16-row tile (m64n16k32; 4 stages of 18 KB).  Where the
//   output tiles fill at most half of 132 SMs (at decode: N <= 8,448) K is
//   split over a thread-block cluster of up to 8 blocks: each leaves its
//   int32 partial tile in shared memory and the blocks write shares of the
//   output, summing the partials through distributed shared memory in rank
//   order.  The epilogue runs once, on the whole sum.  132 (NUM_SMS) is the
//   H100 SXM's count: the plan is a function of the shape alone, so on a
//   part with another count the split fills the card less well, with the
//   same result; int8_matmul_config reports the count it assumed.
// - Epilogue: the int32 tile goes through shared memory as (m, n) and
//   leaves as 16-byte stores, with the scales applied in the reference's
//   order and the edges masked.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W during development, in one
// call of a build-variant script that held each variant bit for bit against
// the plain version (the script and the variants' build-time switches were
// not kept; ms for one LLaMA-2-7B layer's 7 linears, f32 out, L2 flushed by
// a 128 MB write before each launch): 0.265 at M = 512 and 0.151 at M = 4,
// torch._int_mm 0.345 and (x zero-padded to 17 rows) 0.166.
// ldmatrix.trans beat eight 16-bit loads and four more permutes per chunk
// (0.294 / 0.154); the permuted rows beat the natural order (0.269 /
// 0.154); BM = 256 lost (0.328: ptxas serialized its wgmma for registers,
// C7512); 6 stages beat 4 at M > 16 (0.273); aiming the decode split at
// one block an SM beat two (0.159).  The loads alone (consumers that only
// wait and release) took 0.227 / 0.147: the tile stream, not the tensor
// cores, sets the time at both M, from L2 at M = 512 and from device
// memory at M = 4; and one K stage alone (K = 128, N = 4096, M = 4) took
// 0.0075 ms, a fixed cost each of the 7 launches pays.  chip_smoke.py and
// chip_ab.py --kernel int8_matmul time the kernel as it stands.
//
// Edges: ragged M, N and K are masked here (TMA zero-fills past the edges,
// guarded stores), so the wrapper needs no padding.  TMA needs 16-byte
// aligned bases and row strides: x takes it when lda % 16 == 0 and its base
// is aligned, w when N % 16 == 0, K % 8 == 0 (the permuted map) and its base
// is aligned; otherwise the producer warp fills that part of the stage with
// plain loads in the same swizzled layout (same arithmetic).
// int8_matmul_config reports the plan without launching.  The tensor maps
// are encoded on the host at every launch (two cuTensorMapEncodeTiled
// calls, host work only): chip_ab.py --kernel int8_matmul times the
// wrapper's host path per call with and without them (int8_matmul_config
// makes the plan and both maps).
#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "sm90.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int BN = 128;          // output columns n per block (A rows)
constexpr int BK = 128;          // K bytes per stage: one 128-byte x row
constexpr int THREADS = 256;     // consumers: 2 warpgroups, 16 n a warp
constexpr int C_LD = BN + 8;     // epilogue tile row stride (int32)
constexpr int W_BYTES = BK * BN;  // weight tile: 128 k rows of 128 n bytes
constexpr int MAX_SPLITS = 8;    // portable cluster size
constexpr int NUM_SMS = 132;     // H100 SXM: the split is sized for it
constexpr int BM_MAIN = 128;     // m tile of the main plan (M > 16)
constexpr int STAGES_MAIN = 6;   // ring stages of the main plan
constexpr int STAGES_DECODE = 4;  // ring stages of the decode plan

template <int BM, int STAGES>
struct Layout {
  static constexpr int X_BYTES = BM * BK;        // BM rows of 128 k bytes
  static constexpr int STAGE = X_BYTES + W_BYTES;
  static constexpr int SMEM = STAGES * STAGE + 16 * STAGES + 1024;
  static_assert(STAGE % 1024 == 0, "swizzled tiles need 1024-byte bases");
  static_assert(BM * C_LD * 4 <= STAGES * STAGE, "epilogue tile");
};

struct Maps {
  CUtensorMap x, w;
};

struct Args {
  const int8_t* x;
  const int8_t* w;
  const float* x_scale;
  const float* w_scale;
  void* out;
  int M, N, K, lda, out_f32;
  int kt;      // K stages of BK
  int splits;  // blocks over K per output tile: one cluster
  int x_tma, w_tma;
};

// D (64 n x 16 m, s32) += A (64 n x 32 k, s8, registers) * B (32 k x
// 16 m, s8, shared memory via desc)
__device__ __forceinline__ void wgmma_s8(uint32_t (&d)[8],
                                         const uint32_t (&a)[4],
                                         uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1)
      : "memory");
}

// D (64 n x 128 m, s32) += A (64 n x 32 k, s8, registers) * B (32 k x
// 128 m, s8, shared memory via desc)
__device__ __forceinline__ void wgmma_s8(uint32_t (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1)
      : "memory");
}

// Shared row of local k row `k` (0..127) of the weight tile.  The tile is
// stored with bits 1 and 3 of k moved so that the eight k rows one
// ldmatrix phase reads ({0,1,4,5,8,9,12,13} + const) fall on eight
// different swizzle rows (no bank conflict): row = b0 + 2 b2 + 4 (k >> 3)
// + 64 b1 for k = b0 + 2 b1 + 4 b2 + 8 (k >> 3); 32 k rows on are 16 rows
// on, and 16 k rows on are 8 rows on (the same swizzle).
__device__ __forceinline__ int w_row(int k) {
  return (k & 1) + (((k >> 2) & 1) << 1) + ((k >> 3) << 2) +
         (((k >> 1) & 1) << 6);
}

__device__ __forceinline__ int w_k(int r) {  // the inverse of w_row
  return (r & 1) + ((r >> 6) << 1) + (((r >> 1) & 1) << 2) +
         (((r >> 2) & 15) << 3);
}

// A tile of BYTES bytes in 128-byte rows, 128-byte swizzled, filled by the
// warp's lanes from src(i) (byte i of the tile in row-major order, zero
// past the operand's edges): 16 loads in flight a lane before their stores
template <int BYTES, typename Src>
__device__ __forceinline__ void plain_fill(uint8_t* dst, int lane, Src src) {
  constexpr int PER = 16;
  static_assert(BYTES % (32 * PER) == 0, "whole rounds of the warp");
  for (int i0 = lane; i0 < BYTES; i0 += 32 * PER) {
    uint8_t v[PER];
#pragma unroll
    for (int j = 0; j < PER; ++j) v[j] = src(i0 + 32 * j);
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int i = i0 + 32 * j;
      dst[swz(i / 128, i % 128)] = v[j];
    }
  }
}

// Fill ring slot `st` with K stage kt and arm its mbarrier (run by the
// producer warp): the x tile (BM rows of 128 k bytes) and the weight tile
// (128 k rows of 128 n bytes), both 128-byte swizzled, zero past M, N and
// K.  TMA where the operand allows it (lane 0 issues); otherwise the warp's
// lanes load that part plainly into the same layout, and lane 0 arrives
// only after they have.
template <int BM>
__device__ __forceinline__ void load_stage(uint8_t* st, uint32_t bar, int kt,
                                           int m0, int n0, const Args& a,
                                           const Maps& maps, int lane) {
  constexpr int X_BYTES = BM * BK;
  const int k0 = kt * BK;
  uint8_t* wt = st + X_BYTES;
  if (!a.x_tma)
    plain_fill<X_BYTES>(st, lane, [&](int i) -> uint8_t {
      const int gm = m0 + i / BK, gk = k0 + i % BK;
      return gm < a.M && gk < a.K ? a.x[(size_t)gm * a.lda + gk] : 0;
    });
  if (!a.w_tma)
    plain_fill<W_BYTES>(wt, lane, [&](int i) -> uint8_t {
      const int gk = k0 + w_k(i / BN), gn = n0 + i % BN;
      return gk < a.K && gn < a.N ? a.w[(size_t)gk * a.N + gn] : 0;
    });
  if (!a.x_tma || !a.w_tma) {
    fence_proxy_async();  // plain stores, before wgmma reads them
    __syncwarp();
  }
  if (lane == 0) {
    const uint32_t bytes = (a.x_tma ? X_BYTES : 0) + (a.w_tma ? W_BYTES : 0);
    mbar_expect_tx(bar, bytes);  // the one arrival; completes with the bytes
    if (a.x_tma) tma_load_2d(smem_u32(st), &maps.x, k0, m0, bar);
    if (a.w_tma) tma_load_5d(smem_u32(wt), &maps.w, n0, 0, 0, k0 / 8, 0, bar);
  }
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// Where a lane reads the weight tile for its A fragments.  The warp's A rows
// are its 16 output columns (16-byte chunk `warp` of each 128-byte k row),
// the thread holding fragment rows g and g + 8 standing for the adjacent
// columns 2g and 2g + 1, so one 16-bit word of a k row carries both.  For
// ldmatrix.trans lane l gives the row address of matrix l / 8, row l % 8,
// and matrix j takes the k rows {0,1,4,5,8,9,12,13} (+2 for odd j, +16 for
// j >= 2) of a 32-deep chunk, so that thread (g, t) receives the column
// pair's words at k = 4t, 4t+1 (matrix 0) and 4t+2, 4t+3 (matrix 1), and
// the same + 16.
__device__ __forceinline__ uint32_t a_offset(int warp, int lane) {
  const int mtx = lane >> 3, r = lane & 7;
  const int kl =
      ((mtx & 1) << 1) + ((r >> 1) << 2) + (r & 1) + ((mtx >> 1) << 4);
  return swz(w_row(kl), 16 * warp);
}

// The thread's A fragment of 32-deep chunk c, laid out as wgmma .rs (and
// mma.m16n8k32) take 8-bit A: a[0] = row g at k = 4t..4t+3, a[1] = row g + 8
// there, a[2], a[3] the same at k + 16.  `wt` is the weight tile's shared
// address.  The words hold (column 2g, column 2g + 1) byte pairs of two k
// rows; the permutes keep one column of each.  (Eight 16-bit loads and four
// more permutes a chunk measured slower: the source note.)
__device__ __forceinline__ void a_fragment(uint32_t (&a)[4], uint32_t wt,
                                           uint32_t off, int c) {
  uint32_t m[4];
  ldsm_x4_trans(m, wt + c * (w_row(32) - w_row(0)) * BK + off);
  a[0] = prmt(m[0], m[1], 0x6420);
  a[1] = prmt(m[0], m[1], 0x7531);
  a[2] = prmt(m[2], m[3], 0x6420);
  a[3] = prmt(m[2], m[3], 0x7531);
}

// Warps 0-7 are two consumer warpgroups (64 output columns each), warp 8
// the producer.  Block (split, m tile, n tile) walks K stages [kt0, kt1) of
// its split; stage i lives in ring slot i % STAGES behind two mbarriers:
// full (the producer's one arrival plus the TMA bytes) and empty (one
// arrival per consumer warp once its wgmma has read the slot).  The
// splits of one output tile form a thread-block cluster (blockIdx.x is the
// block's rank); after the walk each block leaves its int32 partial tile in
// its shared memory, and the cluster's blocks write shares of the output
// tile, each summing the partials in rank order.
template <int BM, int STAGES, int MIN_BLOCKS>
__global__ void __launch_bounds__(THREADS + 32, MIN_BLOCKS)
int8_matmul_kernel(const __grid_constant__ Maps maps, const Args a) {
  using L = Layout<BM, STAGES>;
  extern __shared__ uint8_t dsmem[];
  uint8_t* ring = dsmem + ((1024 - (smem_u32(dsmem) & 1023)) & 1023);
  const uint32_t full = smem_u32(ring + STAGES * L::STAGE);
  const uint32_t empty = full + 8 * STAGES;

  const int split = blockIdx.x;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.z * BN;
  const int kt0 = split * a.kt / a.splits;
  const int nk = (split + 1) * a.kt / a.splits - kt0;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, THREADS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  uint32_t acc[BM / 2];
#pragma unroll
  for (int i = 0; i < BM / 2; ++i) acc[i] = 0;
  if (warp == THREADS / 32) {  // producer
    if (lane == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(&maps.x) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(&maps.w) : "memory");
    }
    for (int i = 0; i < nk; ++i) {
      const int s = i % STAGES;
      if (i >= STAGES) mbar_wait(empty + 8 * s, (i / STAGES - 1) & 1);
      load_stage<BM>(ring + s * L::STAGE, full + 8 * s, kt0 + i, m0, n0, a,
                     maps, lane);
    }
  } else {
    const uint32_t off = a_offset(warp, lane);
    const uint32_t ring_s = smem_u32(ring);
    uint32_t af[4][4];
    for (int i = 0; i < nk; ++i) {
      const int s = i % STAGES;
      const uint32_t st = ring_s + s * L::STAGE;
      mbar_wait(full + 8 * s, (i / STAGES) & 1);
#pragma unroll
      for (int c = 0; c < 4; ++c) a_fragment(af[c], st + L::X_BYTES, off, c);
      fence_regs(acc);
      fence_regs(af);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < 4; ++c) wgmma_s8(acc, af[c], smem_desc(st + 32 * c));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(af);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }
  }

  // the partial tile: accumulators (columns nl, nl + 1; rows m = 8j + 2t,
  // + 1) into an (m, n) int32 tile over the ring, once every warp is done
  // with the ring
  __syncthreads();
  int* cs = reinterpret_cast<int*>(ring);
  if (warp < THREADS / 32) {
    const int nl = warp * 16 + 2 * (lane >> 2), t = lane & 3;
#pragma unroll
    for (int j = 0; j < BM / 8; ++j) {
      const int m = 8 * j + 2 * t;
      *reinterpret_cast<int2*>(cs + m * C_LD + nl) =
          make_int2(acc[4 * j], acc[4 * j + 2]);
      *reinterpret_cast<int2*>(cs + (m + 1) * C_LD + nl) =
          make_int2(acc[4 * j + 1], acc[4 * j + 3]);
    }
  }
  __syncthreads();
  const int S = a.splits;
  cg::cluster_group cluster = cg::this_cluster();
  if (S > 1) cluster.sync();

  // the output: chunks of 8 columns of one row, interleaved over the
  // cluster's blocks; each sums the partials in rank order (exact), then
  // (float(acc) * x_scale) * w_scale, rounded to nearest at each step, and
  // leaves as 16-byte stores where the row allows them
  constexpr int CHUNKS = BM * (BN / 8);
  for (int c = tid * S + split; c < CHUNKS; c += (THREADS + 32) * S) {
    const int r = c / (BN / 8), ch = c % (BN / 8);
    const int gm = m0 + r, gn = n0 + 8 * ch;
    if (gm >= a.M || gn >= a.N) continue;
    int v[8] = {0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll
    for (int q = 0; q < MAX_SPLITS; ++q) {
      if (q >= S) break;
      const int* src =
          (S > 1 ? cluster.map_shared_rank(cs, q) : cs) + r * C_LD + 8 * ch;
      const int4 lo = reinterpret_cast<const int4*>(src)[0];
      const int4 hi = reinterpret_cast<const int4*>(src)[1];
      v[0] += lo.x; v[1] += lo.y; v[2] += lo.z; v[3] += lo.w;
      v[4] += hi.x; v[5] += hi.y; v[6] += hi.z; v[7] += hi.w;
    }
    const int left = a.N - gn;
    const float xs = a.x_scale[gm];
    float o[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      o[e] = e < left ? __fmul_rn(__fmul_rn(__int2float_rn(v[e]), xs),
                                  a.w_scale[gn + e])
                      : 0.0f;
    const size_t base = (size_t)gm * a.N + gn;
    if (a.out_f32) {
      float* dst = static_cast<float*>(a.out) + base;
      if (left >= 8 && a.N % 4 == 0) {
        reinterpret_cast<float4*>(dst)[0] = make_float4(o[0], o[1], o[2], o[3]);
        reinterpret_cast<float4*>(dst)[1] = make_float4(o[4], o[5], o[6], o[7]);
      } else {
        for (int e = 0; e < 8 && e < left; ++e) dst[e] = o[e];
      }
    } else {
      __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(a.out) + base;
      if (left >= 8 && a.N % 8 == 0) {
        uint32_t p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          __nv_bfloat162 b = __floats2bfloat162_rn(o[2 * e], o[2 * e + 1]);
          p[e] = *reinterpret_cast<uint32_t*>(&b);
        }
        *reinterpret_cast<uint4*>(dst) = make_uint4(p[0], p[1], p[2], p[3]);
      } else {
        for (int e = 0; e < 8 && e < left; ++e)
          dst[e] = __float2bfloat16_rn(o[e]);
      }
    }
  }
  if (S > 1) cluster.sync();  // keep this block's partial until all have read
}

// What one launch takes for these operands: the m tile and ring depth (the
// decode plan at M <= 16, else the main plan), the split of K over a
// cluster, and which operands come by TMA, with their tensor maps.  The
// launch runs on it and int8_matmul_config reports it, so the two cannot
// differ.  Where the output tiles fill at most half the card's SMs, K is
// split to bring the blocks near NUM_SMS (one block an SM: aiming the
// decode plan at two measured slower), at most MAX_SPLITS and one K stage
// a split.  No choice changes the result (the int32 sum is exact in any
// order).
struct Plan {
  int bm, stages, kt, splits, m_tiles, n_tiles, x_tma, w_tma;
  Maps maps;
};

Plan make_plan(const void* x, const void* w, int M, int N, int K, int lda) {
  Plan p = {};
  const bool decode = M <= 16;
  p.bm = decode ? 16 : BM_MAIN;
  p.stages = decode ? STAGES_DECODE : STAGES_MAIN;
  p.kt = (K + BK - 1) / BK;
  p.m_tiles = (M + p.bm - 1) / p.bm;
  p.n_tiles = (N + BN - 1) / BN;
  const int tiles = p.m_tiles * p.n_tiles;
  p.splits = 1;
  if (2 * tiles <= NUM_SMS)
    p.splits = std::max(1, std::min((NUM_SMS + tiles / 2) / tiles,
                                    std::min(MAX_SPLITS, p.kt)));
  // x: (K, M) bytes with row stride lda, boxes of 128 k x bm rows; w: boxes
  // of 128 n x 128 k; both 128-byte swizzled, zero past the edges
  const uint64_t xd[2] = {(uint64_t)K, (uint64_t)M}, xs[1] = {(uint64_t)lda};
  const uint32_t xb[2] = {BK, (uint32_t)p.bm};
  p.x_tma = make_map(&p.maps.x, CU_TENSOR_MAP_DATA_TYPE_UINT8, x, 2, xd, xs,
                     xb, CU_TENSOR_MAP_SWIZZLE_128B);
  // w as (n, b0, b2, k >> 3, b1) with k = b0 + 2 b1 + 4 b2 + 8 (k >> 3):
  // the box lands in w_row order; K % 8 == 0, else plain loads
  const uint64_t n8 = N;
  const uint64_t wd[5] = {n8, 2, 2, (uint64_t)K / 8, 2};
  const uint64_t ws[4] = {n8, 4 * n8, 8 * n8, 2 * n8};
  const uint32_t wb[5] = {BN, 2, 2, BK / 8, 2};
  p.w_tma = K % 8 == 0 &&
            make_map(&p.maps.w, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, 5, wd, ws,
                     wb, CU_TENSOR_MAP_SWIZZLE_128B);
  return p;
}

template <int BM, int STAGES, int MIN_BLOCKS>
int launch_t(const Plan& p, const Args& a, cudaStream_t stream) {
  auto kern = int8_matmul_kernel<BM, STAGES, MIN_BLOCKS>;
  constexpr int SMEM = Layout<BM, STAGES>::SMEM;
  // allowed once: a driver call on every launch would lengthen the host path
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.splits, p.m_tiles, p.n_tiles);
  cfg.blockDim = dim3(THREADS + 32, 1, 1);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = p.splits;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = p.splits > 1 ? 1 : 0;  // one split: no cluster
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kern, p.maps, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int launch_int8_matmul(const void* x, const void* w,
                                  const void* x_scale, const void* w_scale,
                                  void* out, int M, int N, int K, int lda,
                                  int out_f32, void* stream) {
  const Plan p = make_plan(x, w, M, N, K, lda);
  const Args a = {static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
                  static_cast<const float*>(x_scale),
                  static_cast<const float*>(w_scale), out, M, N, K, lda,
                  out_f32, p.kt, p.splits, p.x_tma, p.w_tma};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.bm == 16)
    return launch_t<16, STAGES_DECODE, 2>(p, a, s);
  return launch_t<BM_MAIN, STAGES_MAIN, 1>(p, a, s);
}

// The plan the launch with these operands takes, into cfg[0..10]: m tile,
// n tile, K stage bytes, ring stages, splits (blocks per cluster), K stages,
// m tiles, n tiles, x by TMA, w by TMA, and the SM count the split is sized
// for.  Launches nothing.
extern "C" int int8_matmul_config(const void* x, const void* w, int M, int N,
                                  int K, int lda, int* cfg) {
  const Plan p = make_plan(x, w, M, N, K, lda);
  const int v[11] = {p.bm,      BN,        BK, p.stages,
                     p.splits,  p.kt,      p.m_tiles,     p.n_tiles,
                     p.x_tma,   p.w_tma,   NUM_SMS};
  for (int i = 0; i < 11; ++i) cfg[i] = v[i];
  return 0;
}
