// Fused packed-weight dequantization + matmul for prefill-shaped products,
// alone or batched over the experts of an MoE layer.
//
// Replaces the Pallas TPU kernels src/repro/kernels/quant_matmul.py
// (quant_matmul -> _qmm_kernel, and quant_matmul_experts ->
// _qmm_expert_kernel).  Computes out = x @ dequant(packed) with
//   x      (M, K)      bf16, row-major
//   packed (K/ppb, N)  uint8, packed row r field f holds input row r*ppb + f
//   scale, zero (K/group_size, N) f32
//   out    (M, N)      bf16
// launch_quant_matmul_experts runs the same kernel over E experts in ONE
// launch: every operand gains a leading expert dim and the expert is
// blockIdx.z (the tensor maps' third coordinate, and an offset of the
// pointers that a single-matrix launch, at blockIdx.z = 0, also adds).  It
// also takes `rows`, an int32 (E,) count: out[e, m] = x[e, m] @ W[e] for m <
// rows[e] (clamped to [0, M]) and +0 past it; a null `rows` is M everywhere.
// Every choice that sets the order of accumulation (the row tile, the
// K-stage order, no split of K) is a function of (M, N, K, bits,
// group_size) alone, and none of them reads `rows`, so each kept row is
// bit-identical to E separate quant_matmul launches (the reference's
// fused-vs-unrolled contract).
// The dequantized weight (code - zero) * scale is computed in f32 and rounded
// to bf16 BEFORE the product (the reference's rounding contract: code - zero
// is exact, then one f32 multiply, then one rounding); products accumulate
// in f32 and the output is rounded to bf16 once.
//
// What bounds it on an H100: at the prefill shape (M = 512 rows) the product
// is bound by the tensor cores (2*M*K*N operations against K*N/ppb weight
// bytes: 0.210 ms per LLaMA-2-7B layer at 989 TFLOP/s).  Next come the
// dequantization (code -> bf16 weight, redone by each 128-row block of M)
// and the register-operand wgmma, which holds its warp until it has read
// the A registers, so a warpgroup's dequantization and its MMA do not
// overlap; the two warpgroups of a block overlap each other's.  The MoE
// expert products run at C = 8..40 capacity rows (160 in the packed
// perplexity), where the bound is bytes: at a routed decode step (4 or 8
// slots, top-8 of 128 experts) only the experts that hold a row need their
// weight read, about 29 or 52 of 128, so the bound is those experts' packed
// weight and group rows, ~0.014 / ~0.024 ms a Qwen3-30B-A3B layer.
//
// Design for that traffic:
// - The row tile BM (wgmma's N) is sized to M: the smallest of 8, 32 and 64
//   that holds M, else 128 (always 128 for per-element groups).  At C = 8 a
//   128-row tile did 16x the tensor work and TMA-copied 15/16 zero-filled x
//   rows a stage.  tools/qmm_variants.py chose the set: 8 beats 16 by 2-4%
//   at C = 8, 16 reads the same as 32 at C = 16 (so it is not built), 32
//   beats 64 by ~18% at C = 24 and 32, 64 beats 128 at C = 40 and M = 33..64.
//   The ring stays at 4 stages.
// - A block whose first row is at or past its expert's count writes +0 to
//   its output tile and returns before the producer issues a load: an
//   expert with no routed row costs a launch slot and a zero store, not its
//   weight bytes.  Inside a kept tile, rows past the count are stored as +0.
//   The count is read once by every thread of the block; the K loop, the
//   stage order and the tile never read it.  The dispatch guarantees x is
//   zero past each count, so for finite dequantized weights the skipped
//   rows' products are +0 as well and the result equals the reference's; a
//   NaN or inf scale (0 * inf) is outside the contract.
// What sets the time at these shapes is not bytes but a latency chain in
// each block's serial K loop (32 stages at K = 2048): per stage a consumer
// warpgroup dequantizes its A fragments, issues 4 wgmma and waits for them
// before the next stage's dequantization, so the two latencies add stage
// after stage, and a routed decode step has too few live blocks (~1.3 an
// SM) to hide them.  tools/qmm_variants.py's ablations show it: the stage
// without its MMA, or without its dequantization, costs little more than
// the loads and the ring's handshake; the two together cost several times
// the sum of those increments.  Untried at these tiles (measured only at
// 128 rows, below): dequantizing stage k+1 while stage k's wgmma runs,
// with two A fragment sets and wait_group 1.  Then a split of K over
// blocks, which changes the order of accumulation against the
// single-matrix plan and so waits for a change of both.  Each stage keeps
// its code offsets in registers, computes its wgmma descriptor once, and
// builds the 2-bit table without the integral-zero test (dequant.cuh).
//
// Swap-AB: out^T = W^T x^T, so the weight is the MMA's A operand:
// - The dequantized weight never touches shared memory.  Each warp owns 16
//   output columns; each thread unpacks its own codes straight into the A
//   fragment of wgmma's register (.rs) form, m64n{BM}k16.  A thread's two
//   fragment rows are adjacent columns, so one 16-bit load brings both
//   columns' code byte; its byte offsets are computed once per kernel.
//   Scale and zero come from group rows staged with each 64-deep K stage;
//   their per-column constants are rebuilt only when the group changes (or
//   per 16-deep chunk for groups shorter than a stage): no per-element
//   division and no per-element global load.  At 2 bits each column's four
//   weights are computed once per group, and per code byte one permute
//   builds both columns' selectors and two more pick their weight pairs.
// - x is the B operand, read by wgmma from shared memory: x is row-major
//   (M, K), i.e. K-major for B; each stage holds BM rows x 64 k (128 bytes,
//   BM / 8 swizzle atoms of 8 rows) in the 128-byte swizzle the descriptor
//   declares.
// - Loads are TMA, issued by a producer warp (3-D tensor maps, the expert
//   as the third dimension; the hardware swizzles, zero-fills rows past the
//   edges and signals an mbarrier) into a ring with full and empty
//   mbarriers, so the two consumer warpgroups never meet at a block-wide
//   barrier.  Per-thread 16-byte cp.async copies were tried first: at
//   ~1,200 copies per stage a block moved ~19 KB per microsecond whether
//   the rows were real or zero-filled, twice the MMA time.
// - A consumer warpgroup dequantizes stage kt, issues its four wgmma and
//   waits for them (wait_group 0) before it writes the A registers again.
//   Measured on an H100, this plain order beat a double-buffered A (ptxas
//   serializes wgmma whose register inputs are written while another is in
//   flight, C7513), an enforced ping-pong of the two warpgroups, A staged
//   through shared memory for the SS form, and two stages per wait.
// - Block: 288 threads = 2 consumer warpgroups (64 output columns each) and
//   the producer warp; tile 128 n x BM m; accumulators stay in registers.
// - Epilogue: accumulators go through shared memory as an (m, n) bf16 tile
//   and leave as coalesced 16-byte stores, masked at the ragged edges.
//
// Edges: ragged M, N and K are masked here (zero-filled stages, guarded
// stores), so the wrapper needs no padding.  TMA needs 16-byte aligned rows:
// x takes it when K % 8 == 0 and its base is aligned, the weight operands
// when N % 16 == 0 and their bases are aligned; otherwise the producer warp
// fills that part of the stage with plain loads in the same layout (same
// arithmetic).  The staged group rows serve any group_size that is a
// multiple of 16 or equals K (one group per 16-deep k chunk); any other
// group size reads scale and zero per element (kGeneral, 128-row tile
// only).  One host function, make_plan, makes these choices for the
// launch, and quant_matmul_config reports them without launching.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dequant.cuh"
#include "sm90.cuh"

namespace {

constexpr int BN = 128;          // output columns n per block (A rows)
constexpr int BK = 64;           // K per stage: one 128-byte x row
constexpr int STAGES = 4;
constexpr int THREADS = 256;     // consumers: 2 warpgroups, 16 n rows a warp
constexpr int MAX_GROUPS = 4;    // group rows a stage spans (g % 16 == 0)
constexpr int C_LD = BN + 8;     // epilogue tile row stride (bf16)

// A ring slot for a row tile of BM x rows (wgmma's N)
template <int PPB, int BM>
struct Layout {
  static constexpr int X_BYTES = BM * BK * 2;      // BM rows of 128 bytes
  static constexpr int P_BYTES = (BK / PPB) * BN;  // rows of 128 bytes
  static constexpr int SZ_FLOATS = MAX_GROUPS * BN;  // per scale / zero
  static constexpr int STAGE = X_BYTES + P_BYTES + 2 * SZ_FLOATS * 4;
  static constexpr int SMEM = STAGES * STAGE + 16 * STAGES + 1024;
  static_assert(BM % 8 == 0 && BM >= 8 && BM <= 128, "row tile");
  static_assert(STAGE % 1024 == 0, "swizzled tiles need 1024-byte bases");
  static_assert(BM * C_LD * 2 <= STAGES * STAGE, "epilogue tile");
};

struct TmaMaps {
  CUtensorMap x, packed, scale, zero;
};

// D (64 n x BM m, f32) += A (64 n x 16 k, bf16, registers) * B (16 k x
// BM m, bf16, shared memory via desc)
template <int BM>
__device__ __forceinline__ void wgmma_rs(float (&d)[BM / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc) {
  if constexpr (BM == 8) {
    asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1)
      : "memory");
  } else if constexpr (BM == 32) {
    asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1)
      : "memory");
  } else if constexpr (BM == 64) {
    asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1)
      : "memory");
  } else {
    static_assert(BM == 128, "no wgmma wrapper for this row tile");
    asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1)
      : "memory");
  }
}

struct Operands {
  const __nv_bfloat16* x;
  const uint8_t* packed;
  const float* scale;
  const float* zero;
  int M, N, K, group_size;
  int m0, n0, e;
  bool x_tma, w_tma;
  bool one_group;  // every stage lies in one group (g % BK == 0 or g == K)
};

// Fill ring slot `st` with K stage kt and arm its mbarrier (run by the
// producer warp): the x tile (BM x BK), the packed rows (BK/PPB x BN), both
// 128-byte swizzled, and, unless kGeneral, the group rows of scale and zero
// from the stage's first group on (one row, or MAX_GROUPS when groups are
// shorter than a stage).  TMA where the operand allows it (lane 0 issues);
// otherwise the warp's lanes load that part plainly, and lane 0 arrives
// only after they have.
template <int PPB, int BM, bool kGeneral>
__device__ __forceinline__ void load_stage(uint8_t* st, uint32_t bar, int kt,
                                           const Operands& o,
                                           const TmaMaps& maps, int lane) {
  using L = Layout<PPB, BM>;
  const int k0 = kt * BK;
  uint8_t* ps = st + L::X_BYTES;
  float* ss = reinterpret_cast<float*>(ps + L::P_BYTES);
  float* zs = ss + L::SZ_FLOATS;
  const int rows = kGeneral ? 0 : (o.one_group ? 1 : MAX_GROUPS);
  const int g0 = kGeneral ? 0 : k0 / o.group_size;
  if (!o.x_tma) {
    __nv_bfloat16* xp = reinterpret_cast<__nv_bfloat16*>(st);
    for (int i = lane; i < BM * BK; i += 32) {
      const int r = i / BK, kk = i % BK;
      const int gm = o.m0 + r, gk = k0 + kk;
      xp[swz(r, 2 * kk) / 2] = (gm < o.M && gk < o.K)
                                   ? o.x[(size_t)gm * o.K + gk]
                                   : __float2bfloat16(0.0f);
    }
  }
  if (!o.w_tma) {
    constexpr int PR = BK / PPB;
    const int kp_rows = o.K / PPB, pr0 = k0 / PPB;
    for (int i = lane; i < PR * BN; i += 32) {
      const int r = i / BN, n = i % BN;
      const int gr = pr0 + r, gn = o.n0 + n;
      ps[swz(r, n)] =
          (gr < kp_rows && gn < o.N) ? o.packed[(size_t)gr * o.N + gn] : 0;
    }
    const int ng = o.K / o.group_size;
    for (int i = lane; i < 2 * rows * BN; i += 32) {
      const int which = i / (rows * BN);
      const int j = (i / BN) % rows, n = i % BN;
      const int gg = g0 + j, gn = o.n0 + n;
      const float* src = which ? o.zero : o.scale;
      (which ? zs : ss)[j * BN + n] =
          (gg < ng && gn < o.N) ? src[(size_t)gg * o.N + gn] : 0.0f;
    }
  }
  if (!o.x_tma || !o.w_tma) {
    fence_proxy_async();  // plain stores, before wgmma reads them
    __syncwarp();
  }
  if (lane == 0) {
    const uint32_t bytes =
        (o.x_tma ? L::X_BYTES : 0) +
        (o.w_tma ? L::P_BYTES + 2 * rows * BN * 4 : 0);
    mbar_expect_tx(bar, bytes);  // the one arrival; completes with the bytes
    if (o.x_tma) tma_load_3d(smem_u32(st), &maps.x, k0, o.m0, o.e, bar);
    if (o.w_tma) {
      tma_load_3d(smem_u32(ps), &maps.packed, o.n0, k0 / PPB, o.e, bar);
      if (rows) {
        tma_load_3d(smem_u32(ss), &maps.scale, o.n0, g0, o.e, bar);
        tma_load_3d(smem_u32(zs), &maps.zero, o.n0, g0, o.e, bar);
      }
    }
  }
}

__device__ __forceinline__ uint32_t lds_u16(uint32_t addr) {
  uint16_t v;
  asm volatile("ld.shared.u16 %0, [%1];\n" : "=h"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ float2 lds_f2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"(addr));
  return v;
}

// Scale and zero of the thread's two columns for one group (GroupConst in
// dequant.cuh); `sz` is the stage's scale rows (shared address), zero rows
// follow them
template <int PPB>
__device__ __forceinline__ GroupConst<PPB> group_const(uint32_t sz, int row,
                                                       int nl) {
  return make_group_const<PPB>(
      lds_f2(sz + 4 * (row * BN + nl)),
      lds_f2(sz + 4 * (MAX_GROUPS * BN + row * BN + nl)));
}

// Offsets in a ring slot of the code bytes a thread reads each stage: chunk
// c, half h, and (8 bits only) the second k of the pair
template <int PPB>
struct CodeOffsets {
  uint32_t v[4][2][PPB == 1 ? 2 : 1];
};

template <int PPB, int BM>
__device__ __forceinline__ CodeOffsets<PPB> code_offsets(int nl, int t) {
  CodeOffsets<PPB> off;
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < (PPB == 1 ? 2 : 1); ++e)
        off.v[c][h][e] = Layout<PPB, BM>::X_BYTES +
                         swz((16 * c + 8 * h + 2 * t + e) / PPB, nl);
  return off;
}

template <int PPB>
__device__ __forceinline__ void pin_offsets(CodeOffsets<PPB>& off) {
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < (PPB == 1 ? 2 : 1); ++e)
        asm volatile("" : "+r"(off.v[c][h][e]));
}

// The warp's A fragments of one stage (4 chunks of 16 k), laid out as
// wgmma .rs (and mma.m16n8k16) take A: the thread holds fragment rows g and
// g + 8 (g = lane / 4) at k = 2t, 2t+1, 2t+8, 2t+9 of each chunk (t =
// lane % 4).  Rows g and g + 8 stand for the adjacent output columns nl and
// nl + 1 (nl = 16 * warp + 2g), so one 16-bit load brings both columns'
// code bytes and one 8-byte load their scale (or zero).
template <int PPB, int BM, bool kGeneral>
__device__ __forceinline__ void dequant(uint32_t (&a)[4][4], uint32_t st,
                                        int kt, const Operands& o,
                                        GroupConst<PPB>& g, bool refresh,
                                        const CodeOffsets<PPB>& off, int nl,
                                        int t) {
  constexpr int FB = 8 / PPB;
  constexpr uint32_t MASK = (1u << FB) - 1;
  const uint32_t sz =
      st + Layout<PPB, BM>::X_BYTES + Layout<PPB, BM>::P_BYTES;
  const int k0 = kt * BK;
  if (!kGeneral && refresh) g = group_const<PPB>(sz, 0, nl);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (!kGeneral && !o.one_group && c > 0) {
      // one group per 16-deep chunk; a chunk past K reads a staged row
      // (its x is zero)
      const int j = min(k0 + 16 * c, o.K - 1) / o.group_size -
                    k0 / o.group_size;
      g = group_const<PPB>(sz, j, nl);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kl = 16 * c + 8 * h + 2 * t;  // even: a pair shares a byte
      // bytes of columns nl (low) and nl + 1 (high) for k = kl and kl + 1
      const uint32_t w0 = lds_u16(st + off.v[c][h][0]);
      const uint32_t w1 = PPB == 1 ? lds_u16(st + off.v[c][h][PPB == 1])
                                   : w0;
      const int sh0 = (kl % PPB) * FB, sh1 = ((kl + 1) % PPB) * FB;
      if (PPB == 4 && !kGeneral) {
        // 2 bits: codes c0 | c1 << 2 of each column pick two of its four
        // weights.  Spread to nibbles (c0, c1, c0', c1'), the first permute
        // turns them into the byte selectors (2c0, 2c0 + 1, 2c1, 2c1 + 1)
        // of both columns, one per half word.
        const uint32_t x = w0 >> sh0;
        const uint32_t n = ((x << 2) & 0x3030u) | (x & 0x0303u);
        const uint32_t sel = prmt(0x76543210u, 0, n);
        a[c][2 * h] = prmt(g.lut[0][0], g.lut[0][1], sel);
        a[c][1 + 2 * h] = prmt(g.lut[1][0], g.lut[1][1], sel >> 16);
        continue;
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {  // column nl + i = fragment row g + 8i
        const uint32_t c0 = (w0 >> (8 * i + sh0)) & MASK;
        const uint32_t c1 = (w1 >> (8 * i + sh1)) & MASK;
        if (kGeneral) {
          float w[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int gk = k0 + kl + e, gn = o.n0 + nl + i;
            w[e] = 0.0f;
            if (gk < o.K && gn < o.N) {
              const size_t gi = (size_t)(gk / o.group_size) * o.N + gn;
              w[e] = __fmul_rn(
                  __fsub_rn(__fsub_rn(code_f(e ? c1 : c0), 8388608.0f),
                            o.zero[gi]),
                  o.scale[gi]);
            }
          }
          a[c][i + 2 * h] = pack_bf16x2(w[0], w[1]);
        } else {
          a[c][i + 2 * h] = dequant_pair(code_f(c0), code_f(c1),
                                         i ? g.s.y : g.s.x, i ? g.z.y : g.z.x,
                                         i ? g.zp1 : g.zp0, g.zint);
        }
      }
    }
  }
}

// Warps 0-7 are two consumer warpgroups (64 output columns each), warp 8
// the producer.  Stage kt lives in ring slot kt % STAGES behind two
// mbarriers: full (the producer's one arrival plus the TMA bytes) and empty
// (one arrival per consumer warp once its wgmma has read the slot).  The
// two consumer warpgroups run free of each other; the producer keeps up to
// STAGES stages in flight.  blockIdx.z names the expert (0 for a single
// matrix); `rows` (or null) its count of kept rows.
template <int PPB, int BM, bool kGeneral>
__global__ void __launch_bounds__(THREADS + 32, 1)
quant_matmul_kernel(const __grid_constant__ TmaMaps maps,
                    const __nv_bfloat16* __restrict__ x,
                    const uint8_t* __restrict__ packed,
                    const float* __restrict__ scale,
                    const float* __restrict__ zero,
                    const int* __restrict__ rows,
                    __nv_bfloat16* __restrict__ out,
                    int M, int N, int K, int group_size, int x_tma,
                    int w_tma) {
  using L = Layout<PPB, BM>;
  const int tid = threadIdx.x;
  const int m0 = (int)blockIdx.y * BM, n0 = (int)blockIdx.x * BN;
  const size_t ex = blockIdx.z;
  out += ex * (size_t)M * N;
  // rows kept in this expert: its count clamped to [0, M]
  const int kept = rows == nullptr ? M : min(max(rows[ex], 0), M);
  const bool vec_out = (N % 8) == 0;
  if (m0 >= kept) {
    // no kept row in this tile: +0 out, no load
    for (int c = tid; c < BM * (BN / 8); c += THREADS + 32) {
      const int gm = m0 + c / (BN / 8), gn = n0 + (c % (BN / 8)) * 8;
      if (gm >= M || gn >= N) continue;
      __nv_bfloat16* dst = out + (size_t)gm * N + gn;
      if (vec_out && gn + 8 <= N) {
        *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
      } else {
        for (int e = 0; e < 8 && gn + e < N; ++e)
          dst[e] = __float2bfloat16(0.0f);
      }
    }
    return;
  }

  extern __shared__ uint8_t dsmem[];
  uint8_t* ring = dsmem + ((1024 - (smem_u32(dsmem) & 1023)) & 1023);
  const uint32_t full = smem_u32(ring + STAGES * L::STAGE);
  const uint32_t empty = full + 8 * STAGES;

  x += ex * (size_t)M * K;
  packed += ex * (size_t)(K / PPB) * N;
  scale += ex * (size_t)(K / group_size) * N;
  zero += ex * (size_t)(K / group_size) * N;
  const int warp = tid >> 5, lane = tid & 31;
  Operands o{x, packed, scale, zero, M, N, K, group_size, m0, n0,
             (int)blockIdx.z, x_tma != 0, w_tma != 0,
             group_size % BK == 0 || group_size == K};
  const int KT = (K + BK - 1) / BK;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, THREADS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == THREADS / 32) {  // producer
    for (int kt = 0; kt < KT; ++kt) {
      const int s = kt % STAGES;
      if (kt >= STAGES) mbar_wait(empty + 8 * s, (kt / STAGES - 1) & 1);
      load_stage<PPB, BM, kGeneral>(ring + s * L::STAGE, full + 8 * s, kt, o,
                                    maps, lane);
    }
    return;
  }

  const int nl = warp * 16 + 2 * (lane >> 2);  // this thread's columns nl, +1
  const int t = lane & 3;
  float acc[BM / 2];
#pragma unroll
  for (int i = 0; i < BM / 2; ++i) acc[i] = 0.0f;
  uint32_t a[4][4];
  CodeOffsets<PPB> off = code_offsets<PPB, BM>(nl, t);
  const uint32_t ring_s = smem_u32(ring);
  // stages per group: the group constants are rebuilt only when it changes
  const int per_group = !o.one_group ? 1
                        : group_size == K ? KT
                                          : group_size / BK;
  GroupConst<PPB> g{};
  int left = 0;  // stages before the group changes
  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt % STAGES;
    const uint32_t st = ring_s + s * L::STAGE;
    mbar_wait(full + 8 * s, (kt / STAGES) & 1);
    // keep the offsets in registers (ptxas otherwise recomputes them,
    // ~40 instructions a stage)
    pin_offsets(off);
    const bool refresh = left == 0;
    left = (refresh ? per_group : left) - 1;
    dequant<PPB, BM, kGeneral>(a, st, kt, o, g, refresh, off, nl, t);
    fence_regs(acc);
    fence_regs(a);
    wgmma_fence();
    // chunk c starts 32 bytes on: 2 in the descriptor's address field
    const uint64_t d0 = smem_desc(st);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      wgmma_rs<BM>(acc, a[c], d0 + 2 * c);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(a);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);
  }

  // epilogue: accumulators (columns nl, nl + 1; rows m = 8j + 2t, + 1) into
  // an (m, n) bf16 tile over the ring, then coalesced row stores, +0 for
  // rows past the count; a named barrier holds the 256 consumer threads
  // (the producer has left)
  asm volatile("bar.sync 1, %0;\n" ::"n"(THREADS) : "memory");
  __nv_bfloat16* cs = reinterpret_cast<__nv_bfloat16*>(ring);
#pragma unroll
  for (int j = 0; j < BM / 8; ++j) {
    const int m = 8 * j + 2 * t;
    *reinterpret_cast<uint32_t*>(cs + m * C_LD + nl) =
        pack_bf16x2(acc[4 * j], acc[4 * j + 2]);
    *reinterpret_cast<uint32_t*>(cs + (m + 1) * C_LD + nl) =
        pack_bf16x2(acc[4 * j + 1], acc[4 * j + 3]);
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(THREADS) : "memory");
  for (int c = tid; c < BM * (BN / 8); c += THREADS) {
    const int r = c / (BN / 8), ch = c % (BN / 8);
    const int gm = o.m0 + r, gn = o.n0 + ch * 8;
    if (gm >= M || gn >= N) continue;
    const bool live = gm < kept;
    const __nv_bfloat16* src = cs + r * C_LD + ch * 8;
    __nv_bfloat16* dst = out + (size_t)gm * N + gn;
    if (vec_out && gn + 8 <= N) {
      *reinterpret_cast<uint4*>(dst) =
          live ? *reinterpret_cast<const uint4*>(src) : make_uint4(0, 0, 0, 0);
    } else {
      for (int e = 0; e < 8 && gn + e < N; ++e)
        dst[e] = live ? src[e] : __float2bfloat16(0.0f);
    }
  }
}

// A 3-D map of contiguous rows (d0 innermost, d2 = experts) read in boxes
// of b0 x b1 x 1; false where TMA cannot take the operand (the kernel then
// loads it plainly)
bool make_map3(CUtensorMap* map, CUtensorMapDataType type, int esize,
               const void* base, uint64_t d0, uint64_t d1, uint64_t d2,
               uint32_t b0, uint32_t b1, CUtensorMapSwizzle swizzle) {
  const uint64_t dims[3] = {d0, d1, d2};
  const uint64_t strides[2] = {d0 * esize, d0 * d1 * esize};
  const uint32_t box[3] = {b0, b1, 1};
  return make_map(map, type, base, 3, dims, strides, box, swizzle);
}

// What one launch takes for these operands (E = 1 for a single matrix):
// the row tile, the group path, the group rows a stage holds, the 2-bit
// table, and which operands come by TMA, with their tensor maps.  The
// launch runs on it and quant_matmul_config reports it, so the two cannot
// differ.  Everything but the TMA flags (which change no arithmetic) is a
// function of (M, N, K, bits, group_size) alone.
struct Plan {
  int ppb;
  int bm;          // x rows a block (wgmma's N)
  int staged;      // group rows staged per K stage (g % 16 == 0 or g == K)
  int group_rows;  // rows a stage holds: 1, MAX_GROUPS (g < BK), 0 if not
  int lut;         // 2 bits, staged: the per-group table of the 4 weights
  int x_tma, w_tma;
  TmaMaps maps;
};

// The row tiles a plan picks from, ascending and ending at 128: the
// smallest that holds M rows (per-element groups, kGeneral, always take
// 128).  Each tile is one instantiation per bit width.
template <int... BM>
struct Tiles {};
using RowTiles = Tiles<8, 32, 64, 128>;

template <int... BM>
int row_tile(Tiles<BM...>, int M, bool staged) {
  int bm = 128;
  if (staged) ((M <= BM ? (bm = BM, true) : false) || ...);
  return bm;
}

Plan make_plan(const void* x, const void* packed, const void* scale,
               const void* zero, int E, int M, int N, int K, int bits,
               int group_size) {
  Plan p = {};
  p.ppb = bits == 2 ? 4 : bits == 8 ? 1 : 2;
  // staged group rows serve any group that is constant over each 16-deep
  // k chunk; any other group size reads scale and zero per element
  p.staged = group_size % 16 == 0 || group_size == K;
  p.bm = row_tile(RowTiles{}, M, p.staged);
  p.group_rows = !p.staged ? 0
                 : (group_size % BK == 0 || group_size == K) ? 1
                                                             : MAX_GROUPS;
  p.lut = p.ppb == 4 && p.staged;
  p.x_tma = make_map3(&p.maps.x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, K,
                      M, E, BK, p.bm, CU_TENSOR_MAP_SWIZZLE_128B);
  const int ng = K / group_size;
  p.w_tma = (N % 16 == 0) &&
            make_map3(&p.maps.packed, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1,
                      packed, N, K / p.ppb, E, BN, BK / p.ppb,
                      CU_TENSOR_MAP_SWIZZLE_128B);
  if (p.w_tma && p.staged)
    p.w_tma = make_map3(&p.maps.scale, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                        scale, N, ng, E, BN, p.group_rows,
                        CU_TENSOR_MAP_SWIZZLE_NONE) &&
              make_map3(&p.maps.zero, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                        zero, N, ng, E, BN, p.group_rows,
                        CU_TENSOR_MAP_SWIZZLE_NONE);
  return p;
}

template <int PPB, int BM, bool kGeneral>
int launch_cfg(const Plan& p, const void* x, const void* packed,
               const void* scale, const void* zero, const int* rows,
               void* out, int E, int M, int N, int K, int group_size,
               cudaStream_t stream) {
  using L = Layout<PPB, BM>;
  auto kern = quant_matmul_kernel<PPB, BM, kGeneral>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, E);
  kern<<<grid, THREADS + 32, L::SMEM, stream>>>(
      p.maps, static_cast<const __nv_bfloat16*>(x),
      static_cast<const uint8_t*>(packed), static_cast<const float*>(scale),
      static_cast<const float*>(zero), rows,
      static_cast<__nv_bfloat16*>(out), M, N, K, group_size, p.x_tma,
      p.w_tma);
  return static_cast<int>(cudaGetLastError());
}

template <int PPB, int... BM>
int launch_tile(Tiles<BM...>, const Plan& p, const void* x,
                const void* packed, const void* scale, const void* zero,
                const int* rows, void* out, int E, int M, int N, int K,
                int group_size, cudaStream_t s) {
  if (!p.staged)
    return launch_cfg<PPB, 128, true>(p, x, packed, scale, zero, rows, out,
                                      E, M, N, K, group_size, s);
  int err = static_cast<int>(cudaErrorInvalidValue);
  ((p.bm == BM ? (err = launch_cfg<PPB, BM, false>(
                      p, x, packed, scale, zero, rows, out, E, M, N, K,
                      group_size, s),
                  true)
               : false) ||
   ...);
  return err;
}

int launch(const void* x, const void* packed, const void* scale,
           const void* zero, const int* rows, void* out, int E, int M, int N,
           int K, int bits, int group_size, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Plan p =
      make_plan(x, packed, scale, zero, E, M, N, K, bits, group_size);
  if (p.ppb == 4)
    return launch_tile<4>(RowTiles{}, p, x, packed, scale, zero, rows, out,
                          E, M, N, K, group_size, s);
  if (p.ppb == 1)
    return launch_tile<1>(RowTiles{}, p, x, packed, scale, zero, rows, out,
                          E, M, N, K, group_size, s);
  return launch_tile<2>(RowTiles{}, p, x, packed, scale, zero, rows, out, E,
                        M, N, K, group_size, s);
}

}  // namespace

extern "C" int launch_quant_matmul(const void* x, const void* packed,
                                   const void* scale, const void* zero,
                                   void* out, int M, int N, int K, int bits,
                                   int group_size, void* stream) {
  return launch(x, packed, scale, zero, nullptr, out, 1, M, N, K, bits,
                group_size, stream);
}

// rows: int32 (E,) row counts on the device (each clamped to [0, M] by the
// kernel), or null (M everywhere)
extern "C" int launch_quant_matmul_experts(const void* x, const void* packed,
                                           const void* scale, const void* zero,
                                           const void* rows, void* out, int E,
                                           int M, int N, int K, int bits,
                                           int group_size, void* stream) {
  return launch(x, packed, scale, zero, static_cast<const int*>(rows), out,
                E, M, N, K, bits, group_size, stream);
}

// The configuration the launch with these arguments takes (E = 1: the
// single-matrix launch), into cfg[0..8]: BN, BM, BK, STAGES, staged group
// rows, group rows per stage, 2-bit table, x by TMA, weights by TMA.
// Launches nothing.
extern "C" int quant_matmul_config(const void* x, const void* packed,
                                   const void* scale, const void* zero, int E,
                                   int M, int N, int K, int bits,
                                   int group_size, int* cfg) {
  const Plan p =
      make_plan(x, packed, scale, zero, E, M, N, K, bits, group_size);
  const int v[9] = {BN, p.bm, BK, STAGES, p.staged, p.group_rows, p.lut,
                    p.x_tma, p.w_tma};
  for (int i = 0; i < 9; ++i) cfg[i] = v[i];
  return 0;
}
