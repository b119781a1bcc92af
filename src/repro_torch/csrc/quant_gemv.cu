// Decode-shaped fused dequantization + GEMV (M <= 32 activation rows).
//
// Replaces the Pallas TPU kernel src/repro/kernels/quant_gemv.py
// (quant_gemv -> _gemv_kernel).  Same function as quant_matmul.cu:
//   out (M, N) bf16 = x (M, K) bf16 @ dequant(packed (K/ppb, N) uint8,
//                                             scale/zero (K/g, N) f32)
// with the dequantized weight (code - zero) * scale computed in f32 and
// rounded to bf16 before the product, and f32 accumulation.
//
// What bounds it on an H100: memory.  At M <= 32 the kernel does 2*M
// operations per weight and reads 1/ppb byte per weight, far below the
// card's ~295 operations per byte, so the packed codes (plus the f32
// scale/zero rows) are the whole cost: 0.019 ms per LLaMA-2-7B layer at W2
// g128.  Next comes the instruction issue of the dequantization and of each
// stage's copies, waits and barrier, which has to stay near two
// instructions per weight to keep up.  Design:
// - Split K so the grid covers the card.  A block owns BN = 128, 64 or 32
//   output columns (one warp per 32) and one of S <= 8 contiguous K ranges;
//   the S blocks of a column tile form a thread-block cluster.  Each block
//   keeps its partial sums in shared memory, and after a cluster barrier
//   every block sums a share of the tile's outputs over the S partials
//   through distributed shared memory, in split order: no atomics, no
//   workspace, no second launch.  BN and S come from make_plan, a function
//   of (N, K, bits, group_size) alone, so every sum has the same order at
//   every M.
// - Keep bytes in flight.  Every thread issues the same few 16-byte
//   cp.async copies of each 128-deep K stage (packed code rows, the x rows,
//   and the scale/zero rows of the groups the stage needs), set up once,
//   into a ring of up to 12 stages.  Ragged N or an unaligned base takes
//   plain loads into the same layout (w_vec / x_vec off).
// - Tensor cores, swap-AB: mma.sync m16n8k16 with the weight as A (16
//   output columns x 16 k) and x as B (16 k x 8 rows).  A warp owns 32
//   columns as two m16 tiles; a thread holds the adjacent columns nq + 2u,
//   nq + 2u + 1 as its two A rows of tile u, so one 4-byte shared load
//   brings the code byte of its four columns, which are dequantized
//   straight into the A registers (at 2 bits through a per-group table of
//   each column's four weights).  A thread's four k slots hold k = 4t ..
//   4t + 3 of the 16, so one 8-byte shared load is its B fragment for both
//   tiles.  The shared loads of 64 k are issued together, ahead of their
//   arithmetic.  x rows past M are zeros in registers, never loaded: one
//   body serves M = 1..32 as 1..4 tiles of 8 rows, and a row's products and
//   sums do not depend on the other rows.
// Groups (template kMode): a group size that is a multiple of 128 (or K)
// keeps one set of per-column constants per group, staged and refreshed at
// the stage where the group starts (kStage); a multiple of 16 stages up to
// 8 group rows per stage and rebuilds the constants per 16-deep chunk
// (kChunk); any other group size reads scale and zero per element from
// global memory (kElem).
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dequant.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int KS = 128;               // K rows per stage: 8 chunks of 16
constexpr int X_LD = KS + 16;         // x row stride in bf16 (288 bytes)
constexpr int MAX_THREADS = 128;      // BN = 128: 4 warps
constexpr int MAX_SPLITS = 8;         // portable cluster size
constexpr int TARGET_BLOCKS = 256;    // ~2 waves on 132 SMs
constexpr int MIN_SPLIT_STAGES = 2;
constexpr int RING_BYTES = 96 * 1024;
constexpr int MAX_STAGES = 12;
constexpr int MAX_SMEM = 200 * 1024;

enum GroupMode { kStage = 0, kChunk = 1, kElem = 2 };

// Every choice of a launch: the launch runs on it and quant_gemv_config
// reports it.  All but the load flags (which change no arithmetic) are a
// function of (N, K, bits, group_size) alone.
struct Plan {
  int ppb;
  int bn;      // output columns per block: 32 per warp
  int splits;  // K ranges = blocks per cluster
  int per;     // stages per K range (the last range may have fewer)
  int stages;  // ring depth
  int mode;    // GroupMode
  int rows;    // group rows staged per stage (kStage 1, kChunk <= 8)
  int spg;     // kStage: stages per group (0: one group spans K)
  int w_vec;   // packed / scale / zero by 16-byte cp.async
  int x_vec;   // x by 16-byte cp.async
};

struct Args {
  const __nv_bfloat16* x;
  const uint8_t* packed;
  const float* scale;
  const float* zero;
  __nv_bfloat16* out;
  int M, N, K, g;
  Plan p;
  int stage, xo, so;  // ring slot bytes; offsets of its x and group rows
};

// packed row stride in a slot: 32 or 96 bytes past a multiple of 128, so
// the 4-byte code loads of a warp's four k rows fall in distinct banks
__host__ __device__ inline int p_ld_of(int bn) {
  return bn + (bn == 32 ? 64 : 32);
}
// bytes of one ring slot: packed rows (stride p_ld_of(bn)), x rows (8 * mt,
// stride X_LD), scale rows then zero rows
__host__ __device__ inline int p_bytes(int ppb, int bn) {
  return (KS / ppb) * p_ld_of(bn);
}
__host__ __device__ inline int stage_bytes(int ppb, int bn, int rows, int mt) {
  return p_bytes(ppb, bn) + 8 * mt * X_LD * 2 + 2 * rows * bn * 4;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// wait until at most n (0 .. MAX_STAGES - 2) groups are pending
__device__ __forceinline__ void cp_async_wait_n(int n) {
  switch (n) {
    case 10: cp_async_wait<10>(); break;
    case 9: cp_async_wait<9>(); break;
    case 8: cp_async_wait<8>(); break;
    case 7: cp_async_wait<7>(); break;
    case 6: cp_async_wait<6>(); break;
    case 5: cp_async_wait<5>(); break;
    case 4: cp_async_wait<4>(); break;
    case 3: cp_async_wait<3>(); break;
    case 2: cp_async_wait<2>(); break;
    case 1: cp_async_wait<1>(); break;
    default: cp_async_wait<0>(); break;
  }
}

// D (16 n x 8 m, f32) += A (16 n x 16 k, bf16) * B (16 k x 8 m, bf16)
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint2 b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// Plain loads of stage kt into ring slot `st` (ragged N or unaligned
// bases): the packed rows and, when `groups`, the group rows from g0 on
// (weights, w_vec off), or the M x rows (x, x_vec off); the same layout as
// the copies, zeros past K, N or the last group.
template <int PPB>
__device__ __noinline__ void plain_weights(uint8_t* st, int kt, bool groups,
                                           int g0, const Args& a, int n0,
                                           int tid, int nt) {
  const Plan& p = a.p;
  constexpr int PR = KS / PPB;
  const int p_ld = p_ld_of(p.bn), kp = a.K / PPB, pr0 = kt * PR;
  for (int i = tid; i < PR * p.bn; i += nt) {
    const int r = i / p.bn, n = i % p.bn;
    const int gr = pr0 + r, gn = n0 + n;
    st[r * p_ld + n] =
        (gr < kp && gn < a.N) ? a.packed[(size_t)gr * a.N + gn] : 0;
  }
  if (!groups) return;
  float* ss = reinterpret_cast<float*>(st + a.so);
  const int ng = a.K / a.g;
  for (int i = tid; i < 2 * p.rows * p.bn; i += nt) {
    const int which = i / (p.rows * p.bn);
    const int j = (i / p.bn) % p.rows, n = i % p.bn;
    const int gg = g0 + j, gn = n0 + n;
    const float* src = which ? a.zero : a.scale;
    ss[(which * p.rows + j) * p.bn + n] =
        (gg < ng && gn < a.N) ? src[(size_t)gg * a.N + gn] : 0.0f;
  }
}

__device__ __noinline__ void plain_x(uint8_t* st, int kt, const Args& a,
                                     int tid, int nt) {
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(st + a.xo);
  for (int i = tid; i < a.M * KS; i += nt) {
    const int m = i / KS, kk = i % KS;
    const int gk = kt * KS + kk;
    xs[m * X_LD + kk] =
        gk < a.K ? a.x[(size_t)m * a.K + gk] : __float2bfloat16(0.0f);
  }
}

// Which stages of a block's K range hold group rows in their slot, and
// from which group on: kChunk every stage, from its first k's group; kStage
// the range's first stage and each stage where a group starts (stage kt0 +
// s with s == 0 or (kt0 + s) % spg == 0, group (kt0 + s) * KS / g); kElem
// none.  The loader and the consumer each keep one walk, built alike and
// stepped once per stage in order, so they agree by construction.  kStage
// walks by a compare and an add a stage: a modulo and a division a stage
// measured slower on the card (the loop is bound by instruction issue).
struct GroupWalk {
  int grp;   // kStage: the group of the last start
  int next;  // kStage: stage offset of the next start (-1: none)

  __device__ GroupWalk(const Args& a, int kt0)
      : grp(a.p.mode == kElem ? 0 : kt0 * KS / a.g),
        next((a.p.mode == kStage && a.p.spg > 0)
                 ? (a.p.spg - kt0 % a.p.spg) % a.p.spg
                 : -1) {}

  // stage offset s (called for s = 0, 1, ... in order): does its slot hold
  // group rows, and from group g0 on?
  __device__ __forceinline__ bool step(const Args& a, int kt0, int s,
                                       int& g0) {
    if (a.p.mode == kElem) return false;
    if (a.p.mode == kChunk) {
      g0 = (kt0 + s) * KS / a.g;
      return true;
    }
    const bool start = s == 0 || s == next;
    if (s == next) next += a.p.spg;
    if (start && s > 0) ++grp;
    g0 = grp;
    return start;
  }
};

// One thread's share of every stage of its block's K range, set up once:
// by 16-byte cp.async, each stage is the same few chunks of the slot (KS /
// 16 / PPB of packed rows, 16 rows apart; x rows m0, m0 + bn / 16, ...; up
// to KS / 32 of group rows) from the same sources moved one stage on, so a
// stage costs a few copies and compares.  A copy past K, N or the last group
// zero-fills.  Stages are issued in order (s = 0, 1, ...), as `walk` needs.
template <int PPB>
struct Loader {
  static constexpr int PR = KS / PPB;  // packed rows a stage
  const uint8_t* pk;        // packed row r0 (column chunk of this thread)
  uint32_t pk_dst;          // its offset in a slot
  int pk_row, pk_lim;       // its row at the range's first stage; real below
  const __nv_bfloat16* xp;  // x row m0 from k x_k on
  uint32_t x_dst;
  int m0, x_k;
  int nsz;                  // group-row chunks: scale or zero of row sz_j
  int sz_j[KS / 32];
  const float* szp[KS / 32];
  uint32_t sz_dst[KS / 32];
  int sz_lim;
  GroupWalk walk;

  __device__ Loader(const Args& a, int n0, int kt0, int tid)
      : walk(a, kt0) {
    const Plan& p = a.p;
    const int cpr = p.bn / 16, p_ld = p_ld_of(p.bn);
    const int r0 = tid / cpr, q = tid % cpr;
    const int gn = n0 + 16 * q;
    pk_row = kt0 * PR + r0;
    pk_lim = gn < a.N ? a.K / PPB : 0;
    pk = a.packed + (size_t)pk_row * a.N + (gn < a.N ? gn : 0);
    pk_dst = r0 * p_ld + 16 * q;
    const int xq = tid % (KS / 8);
    m0 = tid / (KS / 8);
    x_k = kt0 * KS + 8 * xq;
    xp = a.x + (size_t)m0 * a.K + x_k;
    x_dst = a.xo + 2 * (m0 * X_LD + 8 * xq);
    const int cprz = p.bn / 4, gz = n0 + 4 * (tid % cprz);
    sz_lim = gz < a.N ? a.K / a.g : 0;
    nsz = 0;
#pragma unroll
    for (int u = 0; u < KS / 32; ++u) {
      const int jj = tid / cprz + 4 * u;  // 0 .. 2 * rows - 1: scale, zero
      sz_j[u] = 0;
      szp[u] = a.scale;
      sz_dst[u] = 0;
      if (jj < 2 * p.rows) {
        const int which = jj / p.rows;
        sz_j[u] = jj % p.rows;
        szp[u] = (which ? a.zero : a.scale) + (size_t)sz_j[u] * a.N +
                 (gz < a.N ? gz : 0);
        sz_dst[u] = a.so + 4 * (jj * p.bn + 4 * (tid % cprz));
        nsz = u + 1;
      }
    }
  }

  // fill ring slot `slot` (shared address; `st` the same as a pointer)
  // with stage offset s of the range starting at kt0
  __device__ void issue(uint32_t slot, uint8_t* st, int s, int kt0,
                        const Args& a, int n0, int tid) {
    const Plan& p = a.p;
    const int nt = p.bn;
    int g0 = 0;
    const bool gl = walk.step(a, kt0, s, g0);
    if (p.w_vec) {
      const int p_ld = p_ld_of(p.bn);
#pragma unroll
      for (int u = 0; u < PR / 16; ++u) {
        const bool ok = pk_row + s * PR + 16 * u < pk_lim;
        cp_async16(slot + pk_dst + 16 * u * p_ld,
                   ok ? pk + (size_t)(s * PR + 16 * u) * a.N : a.packed,
                   ok ? 16 : 0);
      }
      if (gl) {
#pragma unroll
        for (int u = 0; u < KS / 32; ++u) {
          if (u >= nsz) break;
          const bool ok = g0 + sz_j[u] < sz_lim;
          cp_async16(slot + sz_dst[u],
                     ok ? szp[u] + (size_t)g0 * a.N : a.scale, ok ? 16 : 0);
        }
      }
    } else {
      plain_weights<PPB>(st, kt0 + s, gl, g0, a, n0, tid, nt);
    }
    if (p.x_vec) {
      const bool ok = x_k + s * KS < a.K;
      const int mstep = nt / (KS / 8);
      for (int m = m0, u = 0; m < a.M; m += mstep, ++u)
        cp_async16(slot + x_dst + 2 * u * mstep * X_LD,
                   ok ? xp + (size_t)u * mstep * a.K + s * KS : a.x,
                   ok ? 16 : 0);
    } else {
      plain_x(st, kt0 + s, a, tid, nt);
    }
  }
};

// The A fragment of one 16-deep chunk of a tile for the thread's columns
// n, n + 1 (fragment rows g, g + 8) at k slots (2t, 2t+1) = k 4t, 4t+1
// (af[0] column n, af[1] column n + 1) and (2t+8, 2t+9) = k 4t+2, 4t+3
// (af[2], af[3]), from the low 16 bits of w[r], the code pair of the r-th
// packed row holding those k.  kElem reads scale and zero of element (k +
// i, n + column) from global memory; the 2-bit table path is lut_quad.
template <int PPB, int kMode>
__device__ __forceinline__ void dequant_chunk(uint32_t (&af)[4],
                                              const uint32_t (&w)[4 / PPB],
                                              const GroupConst<PPB>& gc,
                                              const Args& a, int k, int n) {
  constexpr int FB = 8 / PPB;
  constexpr uint32_t MASK = (1u << FB) - 1;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // column n + i
      uint32_t cd[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kk = 2 * h + e;  // k = 4t + kk
        cd[e] = (w[kk / PPB] >> (8 * i + (kk % PPB) * FB)) & MASK;
      }
      if constexpr (kMode == kElem) {
        float wv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int gk = k + 2 * h + e, gn = n + i;
          wv[e] = 0.0f;
          if (gk < a.K && gn < a.N) {
            const size_t gi = (size_t)(gk / a.g) * a.N + gn;
            wv[e] = __fmul_rn(__fsub_rn(__fsub_rn(code_f(cd[e]), 8388608.0f),
                                        __ldg(a.zero + gi)),
                              __ldg(a.scale + gi));
          }
        }
        af[2 * h + i] = pack_bf16x2(wv[0], wv[1]);
      } else {
        af[2 * h + i] = dequant_pair(code_f(cd[0]), code_f(cd[1]),
                                     i ? gc.s.y : gc.s.x, i ? gc.z.y : gc.z.x,
                                     i ? gc.zp1 : gc.zp0, gc.zint);
      }
    }
  }
}

// the constants of staged group row j for the thread's columns nq .. nq + 3
// (gc[u]: columns nq + 2u, nq + 2u + 1; `sz`: the slot's scale rows, its
// `rows` zero rows follow them)
template <int PPB>
__device__ __forceinline__ void group_rows(GroupConst<PPB> (&gc)[2],
                                           const uint8_t* sz, int rows,
                                           int bn, int j, int nq) {
  const float* f = reinterpret_cast<const float*>(sz);
  const float4 s4 = *reinterpret_cast<const float4*>(f + j * bn + nq);
  const float4 z4 = *reinterpret_cast<const float4*>(f + (rows + j) * bn + nq);
  gc[0] = make_group_const<PPB>(make_float2(s4.x, s4.y),
                                make_float2(z4.x, z4.y));
  gc[1] = make_group_const<PPB>(make_float2(s4.z, s4.w),
                                make_float2(z4.z, z4.w));
}

// 2 bits, both tiles at once: from w (the code bytes of columns nq .. nq
// + 3) shifted right by sh, the two codes of each column pick two of its
// four weights from gc[u].lut (columns nq + 2u, nq + 2u + 1): one nibble
// spread and two selector permutes serve all four columns.
__device__ __forceinline__ void lut_quad(uint32_t w, int sh,
                                         const GroupConst<4> (&gc)[2],
                                         uint32_t& a00, uint32_t& a01,
                                         uint32_t& a10, uint32_t& a11) {
  const uint32_t x = w >> sh;
  const uint32_t n = ((x << 2) & 0x30303030u) | (x & 0x03030303u);
  const uint32_t s01 = prmt(0x76543210u, 0, n);
  const uint32_t s23 = prmt(0x76543210u, 0, n >> 16);
  a00 = prmt(gc[0].lut[0][0], gc[0].lut[0][1], s01);
  a01 = prmt(gc[0].lut[1][0], gc[0].lut[1][1], s01 >> 16);
  a10 = prmt(gc[1].lut[0][0], gc[1].lut[0][1], s23);
  a11 = prmt(gc[1].lut[1][0], gc[1].lut[1][1], s23 >> 16);
}

// Each warp owns 32 output columns as two m16 tiles: thread (g8, t) holds
// columns nq + 2u, nq + 2u + 1 (nq = 32 * warp + 4 * g8) as rows g8 and
// g8 + 8 of tile u, so one 4-byte shared load brings the code byte of all
// four of its columns, and each x fragment feeds both tiles.
template <int PPB, int MT, int kMode>
__global__ void __launch_bounds__(MAX_THREADS)
quant_gemv_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) uint8_t smem[];
  const Plan& p = a.p;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, t = lane & 3;
  const int nq = 32 * warp + 4 * g8;  // this thread's columns nq .. nq + 3
  const int n0 = blockIdx.x * p.bn;
  const int split = blockIdx.y;       // = the block's rank in its cluster
  const int KT = (a.K + KS - 1) / KS;
  const int kt0 = split * p.per;
  const int nst = min(p.per, KT - kt0);
  const int p_ld = p_ld_of(p.bn);
  const uint32_t ring = smem_u32(smem);

  float acc[MT][2][4];
#pragma unroll
  for (int j = 0; j < MT; ++j)
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][u][i] = 0.0f;

  Loader<PPB> ld(a, n0, kt0, tid);
  GroupWalk walk(a, kt0);  // the consumer's: the same stages as the loader's
  for (int s = 0; s < p.stages - 1; ++s) {
    if (s < nst)
      ld.issue(ring + s * a.stage, smem + s * a.stage, s, kt0, a, n0, tid);
    cp_async_commit();
  }
  // offsets in a slot: the thread's code bytes in packed row 4t / PPB and
  // one chunk further; its B fragment in x row g8
  const int p_off = (4 * t / PPB) * p_ld + nq;
  const int p_step = (16 / PPB) * p_ld;
  const int x_off = a.xo + 2 * (g8 * X_LD + 4 * t);
  bool mrow[MT];
#pragma unroll
  for (int j = 0; j < MT; ++j) mrow[j] = 8 * j + g8 < a.M;
  GroupConst<PPB> gc[2] = {};
  int lslot = p.stages - 1, cslot = 0;
  for (int it = 0; it < nst; ++it) {
    // every copy of stage `it` has landed for every thread, and every warp
    // is done with the slot refilled next (stage it - 1)
    cp_async_wait_n(p.stages - 2);
    __syncthreads();
    const int nxt = it + p.stages - 1;
    if (nxt < nst)
      ld.issue(ring + lslot * a.stage, smem + lslot * a.stage, nxt, kt0, a,
               n0, tid);
    cp_async_commit();
    lslot = lslot + 1 == p.stages ? 0 : lslot + 1;

    const int kst = (kt0 + it) * KS;
    const uint8_t* st = smem + cslot * a.stage;
    cslot = cslot + 1 == p.stages ? 0 : cslot + 1;
    if constexpr (kMode == kStage) {
      int g0;
      if (walk.step(a, kt0, it, g0))
        group_rows<PPB>(gc, st + a.so, 1, p.bn, 0, nq);
    }
#pragma unroll
    for (int q4 = 0; q4 < KS / 64; ++q4) {  // 64 k (4 chunks) at a time
      const int k0 = kst + 64 * q4;
      const uint8_t* sq = st + q4 * 4 * p_step;
      // the shared loads first: code bytes, then x fragments
      uint32_t w[4][4 / PPB];
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int r = 0; r < 4 / PPB; ++r)
          w[c][r] = *reinterpret_cast<const uint32_t*>(sq + p_off +
                                                       c * p_step + r * p_ld);
      uint2 b[4][MT];
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int j = 0; j < MT; ++j)
          b[c][j] = mrow[j] ? *reinterpret_cast<const uint2*>(
                                  st + x_off +
                                  2 * (8 * j * X_LD + 64 * q4 + 16 * c))
                            : make_uint2(0u, 0u);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if constexpr (kMode == kChunk)
          group_rows<PPB>(gc, st + a.so, p.rows, p.bn,
                          (k0 + 16 * c) / a.g - kst / a.g, nq);
        uint32_t af[2][4];
        if constexpr (PPB == 4 && kMode != kElem) {
#pragma unroll
          for (int h = 0; h < 2; ++h)
            lut_quad(w[c][0], 4 * h, gc, af[0][2 * h], af[0][2 * h + 1],
                     af[1][2 * h], af[1][2 * h + 1]);
        } else {
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            uint32_t wu[4 / PPB];
#pragma unroll
            for (int r = 0; r < 4 / PPB; ++r) wu[r] = w[c][r] >> (16 * u);
            dequant_chunk<PPB, kMode>(af[u], wu, gc[u], a,
                                      k0 + 16 * c + 4 * t, n0 + nq + 2 * u);
          }
        }
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int j = 0; j < MT; ++j) mma_16816(acc[j][u], af[u], b[c][j]);
      }
    }
  }

  // partial sums into shared memory over the ring: red[m * bn + n]; then
  // the cluster's blocks meet
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int j = 0; j < MT; ++j) {
    const int m = 8 * j + 2 * t;
    *reinterpret_cast<float4*>(red + m * p.bn + nq) =
        make_float4(acc[j][0][0], acc[j][0][2], acc[j][1][0], acc[j][1][2]);
    *reinterpret_cast<float4*>(red + (m + 1) * p.bn + nq) =
        make_float4(acc[j][0][1], acc[j][0][3], acc[j][1][1], acc[j][1][3]);
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  // block `split` sums its share of the tile's M x bn outputs over the
  // splits' partials, in split order
  const int nt = p.bn, S = p.splits, lbn = __ffs(p.bn) - 1;
  for (int i = split * nt + tid; i < a.M * p.bn; i += S * nt) {
    float sum = 0.0f;
    for (int r = 0; r < S; ++r) sum += cluster.map_shared_rank(red, r)[i];
    const int n = n0 + (i & (p.bn - 1));
    if (n < a.N) a.out[(size_t)(i >> lbn) * a.N + n] = __float2bfloat16(sum);
  }
  cluster.sync();  // keep this block's partials until every block has read
}

Plan make_plan(const void* x, const void* packed, const void* scale,
               const void* zero, int N, int K, int bits, int g) {
  Plan p = {};
  p.ppb = bits == 2 ? 4 : bits == 8 ? 1 : 2;
  p.mode = (g % KS == 0 || g == K) ? kStage : (g % 16 == 0) ? kChunk : kElem;
  p.rows = p.mode == kStage   ? 1
           : p.mode == kChunk ? (KS % g == 0 ? KS / g : (KS - 1) / g + 2)
                              : 0;
  p.spg = (p.mode == kStage && g != K) ? g / KS : 0;
  const int KT = (K + KS - 1) / KS;
  for (int bn = 128; bn >= 32; bn /= 2) {
    const int tiles = (N + bn - 1) / bn;
    int s = (TARGET_BLOCKS + tiles - 1) / tiles;
    s = s < MAX_SPLITS ? s : MAX_SPLITS;
    const int most = KT / MIN_SPLIT_STAGES;
    s = s < most ? s : most;
    s = s > 1 ? s : 1;
    p.bn = bn;
    p.per = KT > s ? (KT + s - 1) / s : 1;  // K = 0: one empty range
    p.splits = (KT + p.per - 1) / p.per;  // no empty K range
    if (tiles * p.splits >= TARGET_BLOCKS) break;
  }
  p.stages = RING_BYTES / stage_bytes(p.ppb, p.bn, p.rows, 4);
  p.stages = p.stages < MAX_STAGES ? p.stages : MAX_STAGES;
  p.stages = p.stages > 2 ? p.stages : 2;
  auto aligned = [](const void* q) {
    return (reinterpret_cast<uintptr_t>(q) & 15) == 0;
  };
  p.w_vec = N % 16 == 0 && aligned(packed) && aligned(scale) && aligned(zero);
  p.x_vec = K % 8 == 0 && aligned(x);
  return p;
}

template <int PPB, int MT, int kMode>
int launch_t(const Args& a, cudaStream_t stream) {
  auto kern = quant_gemv_kernel<PPB, MT, kMode>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const Plan& p = a.p;
  Args am = a;
  am.stage = stage_bytes(PPB, p.bn, p.rows, MT);
  am.xo = p_bytes(PPB, p.bn);
  am.so = am.xo + 8 * MT * X_LD * 2;
  const int red = 8 * MT * p.bn * 4;  // the partial sums, over the ring
  int smem = p.stages * am.stage;
  smem = smem > red ? smem : red;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.N + p.bn - 1) / p.bn, p.splits, 1);
  cfg.blockDim = dim3(p.bn, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = 1;
  at[0].val.clusterDim.y = p.splits;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kern, am);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int PPB, int kMode>
int launch_rows(const Args& a, cudaStream_t stream) {
  if (a.M <= 8) return launch_t<PPB, 1, kMode>(a, stream);
  if (a.M <= 16) return launch_t<PPB, 2, kMode>(a, stream);
  if (a.M <= 24) return launch_t<PPB, 3, kMode>(a, stream);
  return launch_t<PPB, 4, kMode>(a, stream);
}

template <int PPB>
int launch_ppb(const Args& a, cudaStream_t stream) {
  if (a.p.mode == kStage) return launch_rows<PPB, kStage>(a, stream);
  if (a.p.mode == kChunk) return launch_rows<PPB, kChunk>(a, stream);
  return launch_rows<PPB, kElem>(a, stream);
}

}  // namespace

extern "C" int launch_quant_gemv(const void* x, const void* packed,
                                 const void* scale, const void* zero,
                                 void* out, int M, int N, int K, int bits,
                                 int group_size, void* stream) {
  if (M < 1 || M > 32) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  if (N < 1) return 0;
  if (K < 1)  // an empty sum: zeros
    return static_cast<int>(
        cudaMemsetAsync(out, 0, sizeof(__nv_bfloat16) * M * N, st));
  Args a{static_cast<const __nv_bfloat16*>(x),
         static_cast<const uint8_t*>(packed),
         static_cast<const float*>(scale),
         static_cast<const float*>(zero),
         static_cast<__nv_bfloat16*>(out),
         M, N, K, group_size,
         make_plan(x, packed, scale, zero, N, K, bits, group_size),
         0, 0, 0};
  if (a.p.ppb == 4) return launch_ppb<4>(a, st);
  if (a.p.ppb == 1) return launch_ppb<1>(a, st);
  return launch_ppb<2>(a, st);
}

// The configuration a launch with these operands takes (at any M), into
// cfg[0..11]: BN, splits, stages per split, ring stages, group mode (0 per
// stage, 1 per chunk, 2 per element), group rows per stage, stages per
// group, 2-bit table, weights by cp.async, x by cp.async, K rows per stage,
// warps per block.  Launches nothing.
extern "C" int quant_gemv_config(const void* x, const void* packed,
                                 const void* scale, const void* zero, int N,
                                 int K, int bits, int group_size, int* cfg) {
  const Plan p = make_plan(x, packed, scale, zero, N, K, bits, group_size);
  const int v[12] = {p.bn,     p.splits, p.per,
                     p.stages, p.mode,   p.rows,
                     p.spg,    p.ppb == 4 && p.mode != kElem,
                     p.w_vec,  p.x_vec,  KS,
                     p.bn / 32};
  for (int i = 0; i < 12; ++i) cfg[i] = v[i];
  return 0;
}
