// TesseraQ soft-weight materialization (paper Eq. 4 + Eq. 9) and its
// gradient, for the Soften phase of progressive adaptive rounding.
//
// Replaces the Pallas TPU kernel src/repro/kernels/soft_round.py
// (soft_round -> _soft_round_kernel), which has a forward only; the
// backward here is what the reference obtains from jax.grad of the same
// function.  Layout: grouped (ng, g, n) for base, nu, hard and the output,
// (ng, n) for v, scale and zero, all row-major; an optional per-input-row
// divisor act (AWQ's act_scale, length act_ng * g) shared by every block of
// act_ng groups, so a folded expert stack (E * act_ng, g, n) reads row r of
// group grp at act[(grp % act_ng) * g + r].
//
//   alpha = hard == 0 ? sigmoid(nu) : (hard > 0 ? 1 : 0)
//   u     = base + zero + alpha
//   q     = clip(u, 0, qmax)
//   s_eff = dst ? scale * 2 sigmoid(v) : scale
//   out   = (q - zero) * s_eff                    [ / act[row] ]
//
// Backward, given dout (ng, g, n), with d = dout [ / act[row] ]:
//   dnu = d * s_eff * clip'(u) * sigmoid'(nu) * [hard == 0]
//   dv  = sum over the g rows of d * (q - zero), times
//         scale * 2 sigmoid'(v)                          (dst only)
// clip'(u) is 1 strictly inside (0, qmax), 0 outside, and 1/2 at u == 0 and
// u == qmax: jnp.clip is max/min, whose gradient splits a tie evenly.  The
// division by act is the same IEEE division (div.rn.f32; no fast math)
// that PyTorch applies outside the kernel when it is not folded in, in the
// same place in the chain, so the fused launch is bit-identical to the
// kernel followed (forward) or preceded (backward) by that division.
//
// What bounds it on an H100: bytes.  Per element the forward moves 13 bytes
// in total (reads base and nu, f32, and hard, int8: 9; writes 4), the
// backward 17 (reads dout too: 13; writes dnu: 4); the per-group v, scale
// and zero and the per-row act are 1/g and 1/n of that.  Neither is near
// the card's ~20 operations per byte, but each element costs ~50
// instructions (σ is an accurate expf and an IEEE reciprocal), so the
// design keeps 16-byte loads in flight while the arithmetic stays off the
// critical path:
//   * One mapping for both directions.  A block owns a 128-column tile of
//     one group: each thread owns 4 consecutive columns (16-byte loads of
//     base, nu and dout, a 4-byte load of hard, 16-byte stores), so one warp
//     covers a row of the tile, and the block's 8 warps take interleaved
//     rows.  Each warp issues the loads of ROWS = 2 rows before it computes
//     either; 64 registers a thread let 4 blocks share an SM (~100 KB of
//     loads in flight an SM in the backward).  Frozen and soft entries take
//     the same instructions (σ computed, then selected): no divergence.
//   * Rows split when the column tiles alone do not give enough blocks: the
//     per-channel leaves (ng = 1, g = K = 4096 or 11008) have only 32 or 86
//     tiles.  Rank s takes the s-th contiguous range of the group's rows.
//     In the backward the ranks of a (group, tile) are one thread-block
//     cluster (up to 8): dv is summed per thread over its rows, then over
//     the block's warps in warp order in shared memory, then over the ranks
//     in rank order through distributed shared memory: no atomics, no
//     workspace, one launch.  The forward has no sum: it splits up to 128
//     ways with no cluster, and its consecutive blocks are neighbouring
//     tiles of one range, so blocks running together read neighbouring
//     bytes.
//   * The plan (warps, split, rows per split) is a function of (ng, g, n)
//     and the direction alone, never of the part's SM count, so dv has one
//     summation order per shape on any card.  n % 4 != 0 or a pointer off
//     its alignment takes scalar loads and stores in the same mapping and
//     the same order (the edge path changes how bytes move, not the
//     arithmetic).
//   * The grid is one-dimensional (group, tile, rank): ng is bounded only
//     by the grid's 2^31 - 1 blocks, not by gridDim.y.
// Development readings (NVIDIA H100 80GB HBM3, 700 W; build variants timed
// in one call, PERF.md): ROWS 4, 8 or a register double buffer, 16 warps
// a block, a 16-block cluster, interleaved ranks and L2 prefetch hints were
// each slower or no faster at the per-channel backward than this plan.
// soft_round_config reports the plan without a launch.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int VEC = 4;              // columns per thread
constexpr int TILE = 32 * VEC;      // columns per block: one warp's width
constexpr int ROWS = 2;             // rows a warp loads before computing
constexpr int MAX_WARPS = 8;
constexpr int MIN_BLOCKS = 4;       // per SM: 64 registers a thread
constexpr int MAX_SPLITS = 8;       // backward: the portable cluster size
constexpr int TARGET_BLOCKS = 512;  // backward; constants, never the SM count
constexpr int MAX_FSPLITS = 128;    // forward: no sum, no cluster
constexpr int FTARGET_BLOCKS = 4096;
constexpr long long MAX_BLOCKS = 0x7fffffffLL;

struct Plan {
  int warps;   // warps per block, interleaved over rows
  int splits;  // row ranges of a group = blocks per cluster
  int per;     // rows per range (the last may have fewer)
  int tiles;   // 128-column tiles
  int vec;     // 16-byte loads and stores (else the scalar edge path)
  long long blocks;
};

Plan make_plan(int ng, int g, int n, bool aligned, bool bwd) {
  Plan p;
  p.warps = MAX_WARPS;
  while (p.warps > 1 && (p.warps / 2) * ROWS >= g) p.warps /= 2;
  p.tiles = (n + TILE - 1) / TILE;
  const long long base = static_cast<long long>(ng) * p.tiles;
  const long long target = bwd ? TARGET_BLOCKS : FTARGET_BLOCKS;
  const long long most_s = bwd ? MAX_SPLITS : MAX_FSPLITS;
  long long s = 1;
  if (base < target) {
    s = (target + base - 1) / base;
    s = s < most_s ? s : most_s;
    const int most = g / (p.warps * ROWS);  // a range holds a full pass
    s = s < most ? s : most;
    s = s > 1 ? s : 1;
  }
  p.per = static_cast<int>((g + s - 1) / s);
  p.splits = (g + p.per - 1) / p.per;  // no empty range
  p.blocks = base * p.splits;
  p.vec = n % VEC == 0 && aligned;
  return p;
}

struct Args {
  const float* dout;  // backward only
  const float* base;
  const float* nu;
  const int8_t* hard;
  const float* v;
  const float* scale;
  const float* zero;
  const float* act;   // null: no division
  float* out;         // θ̂ (forward) or dν (backward)
  float* dv;          // backward with DST
  int g, n, act_ng, dst;
  float qmax;
  Plan p;
};

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// m: the thread's live columns (1..4); the scalar path zero-fills the rest
template <bool kVec>
__device__ __forceinline__ void ld4(const float* __restrict__ p, long long e,
                                    int m, float (&x)[VEC]) {
  if constexpr (kVec) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p + e));
    x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) x[k] = k < m ? __ldg(p + e + k) : 0.0f;
  }
}

// the 4 hard bytes of a thread's columns, packed (column k in byte k)
template <bool kVec>
__device__ __forceinline__ uint32_t ldh(const int8_t* __restrict__ p,
                                        long long e, int m) {
  if constexpr (kVec) {
    return __ldg(reinterpret_cast<const unsigned int*>(p + e));
  } else {
    uint32_t h = 0;
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      if (k < m) h |= static_cast<uint32_t>(static_cast<uint8_t>(p[e + k]))
                      << (8 * k);
    return h;
  }
}

template <bool kVec>
__device__ __forceinline__ void st4(float* __restrict__ p, long long e, int m,
                                    const float (&x)[VEC]) {
  if constexpr (kVec) {
    *reinterpret_cast<float4*>(p + e) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      if (k < m) p[e + k] = x[k];
  }
}

// One body for both directions: block b takes rank `rank` (a contiguous
// range of `per` rows) of column tile `tile` of group `grp`.
template <bool kBwd, bool kVec, bool kAct>
__global__ void __launch_bounds__(MAX_WARPS * 32, MIN_BLOCKS)
soft_round_kernel(const Args a) {
  const int W = a.p.warps, S = a.p.splits;
  // the backward's split ranks of a (group, tile) are consecutive blocks:
  // one cluster; the forward's tiles of a (group, split) are, so blocks
  // running together read neighbouring bytes
  const unsigned T = a.p.tiles;
  const int rank = static_cast<int>(kBwd ? blockIdx.x % S : blockIdx.x / T % S);
  const int tile = static_cast<int>(kBwd ? blockIdx.x / S % T : blockIdx.x % T);
  const long long grp = blockIdx.x / (S * T);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = a.g, n = a.n;
  const int col0 = tile * TILE + lane * VEC;
  const int m = n - col0 < VEC ? n - col0 : VEC;  // <= 0: no live column

  float z[VEC], se[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    z[k] = 0.0f;
    se[k] = 0.0f;
    if (k < m) {
      const long long gi = grp * n + col0 + k;
      const float s = a.scale[gi];
      z[k] = a.zero[gi];
      se[k] = a.dst ? s * (2.0f * sigmoid_f(a.v[gi])) : s;
    }
  }
  // this warp's rows: r0, r0 + W, ... below r1 (its split's range)
  const long long r_end = static_cast<long long>(rank + 1) * a.p.per;
  const long long r1 = g < r_end ? g : r_end;
  const long long r0 = static_cast<long long>(rank) * a.p.per + warp;
  const long long cnt = r0 < r1 ? (r1 - r0 + W - 1) / W : 0;
  const long long es = static_cast<long long>(W) * n;  // between its rows
  long long e = (grp * g + r0) * n + col0;             // its first element
  const float* act = kAct ? a.act + (grp % a.act_ng) * g + r0 : nullptr;
  float acc[VEC] = {0.0f, 0.0f, 0.0f, 0.0f};

  struct Rows {
    float b[ROWS][VEC], w[ROWS][VEC], d[ROWS][VEC], as[ROWS];
    uint32_t h[ROWS];
  };
  // the loads of this warp's next `rows` rows (all ROWS when rows ==
  // ROWS), issued before any of them is used
  auto load = [&](Rows& R, int rows) {
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      if (i < rows) {
        const long long ei = e + i * es;
        ld4<kVec>(a.base, ei, m, R.b[i]);
        ld4<kVec>(a.nu, ei, m, R.w[i]);
        R.h[i] = ldh<kVec>(a.hard, ei, m);
        if constexpr (kBwd) ld4<kVec>(a.dout, ei, m, R.d[i]);
        if constexpr (kAct) R.as[i] = __ldg(act + i * W);
      }
    }
  };
  auto compute = [&](const Rows& R, int rows) {
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      if (i < rows) {
        float o[VEC];
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          const int8_t hk = static_cast<int8_t>(R.h[i] >> (8 * k));
          const float sg = sigmoid_f(R.w[i][k]);  // branch-free: selected
          const float al = hk == 0 ? sg : (hk > 0 ? 1.0f : 0.0f);
          const float u = R.b[i][k] + z[k] + al;
          const float q = fminf(fmaxf(u, 0.0f), a.qmax);
          if constexpr (kBwd) {
            float dk = R.d[i][k];
            if constexpr (kAct) dk = dk / R.as[i];
            const float cgr = (u > 0.0f && u < a.qmax)
                                  ? 1.0f
                                  : ((u == 0.0f || u == a.qmax) ? 0.5f
                                                                : 0.0f);
            const float dsig = hk == 0 ? al * (1.0f - al) : 0.0f;
            o[k] = ((dk * se[k]) * cgr) * dsig;
            acc[k] += dk * (q - z[k]);
          } else {
            o[k] = (q - z[k]) * se[k];
            if constexpr (kAct) o[k] = o[k] / R.as[i];
          }
        }
        st4<kVec>(a.out, e + i * es, m, o);
      }
    }
  };
  if (m > 0) {
    long long left = cnt;
    for (; left >= ROWS; left -= ROWS) {  // full passes: no row checks
      Rows R;
      load(R, ROWS);
      compute(R, ROWS);
      e += ROWS * es;
      if constexpr (kAct) act += ROWS * W;
    }
    if (left > 0) {
      Rows R;
      load(R, static_cast<int>(left));
      compute(R, static_cast<int>(left));
    }
  }

  if constexpr (kBwd) {
    if (!a.dst) return;  // uniform over the cluster
    __shared__ float part[MAX_WARPS][TILE];
    __shared__ float blk[TILE];
#pragma unroll
    for (int k = 0; k < VEC; ++k) part[warp][lane * VEC + k] = acc[k];
    __syncthreads();
    // the block's partial of each column: its warps in warp order
    for (int c = threadIdx.x; c < TILE; c += blockDim.x) {
      float tot = 0.0f;
      for (int q = 0; q < W; ++q) tot += part[q][c];
      blk[c] = tot;
    }
    cg::cluster_group cluster = cg::this_cluster();
    if (S > 1)
      cluster.sync();
    else
      __syncthreads();
    // rank c % S sums column c over the cluster's partials in rank order
    for (int c = threadIdx.x; c < TILE; c += blockDim.x) {
      const int col = tile * TILE + c;
      if (c % S != rank || col >= n) continue;
      float tot = 0.0f;
      for (int q = 0; q < S; ++q)
        tot += (S > 1 ? cluster.map_shared_rank(blk, q) : blk)[c];
      const long long gi = grp * n + col;
      const float sv = sigmoid_f(a.v[gi]);
      a.dv[gi] = ((tot * a.scale[gi]) * 2.0f) * (sv * (1.0f - sv));
    }
    if (S > 1) cluster.sync();  // keep this block's partial until all read
  }
}

template <bool kBwd, bool kVec, bool kAct>
cudaError_t launch_t(const Args& a, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(a.p.blocks), 1, 1);
  cfg.blockDim = dim3(a.p.warps * 32, 1, 1);
  cfg.stream = stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = a.p.splits;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  // the forward has no sum: its split blocks need no cluster
  cfg.numAttrs = (kBwd && a.p.splits > 1) ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, soft_round_kernel<kBwd, kVec, kAct>, a);
}

template <bool kBwd>
int launch(const Args& a, cudaStream_t stream) {
  cudaError_t err;
  if (a.p.vec)
    err = a.act ? launch_t<kBwd, true, true>(a, stream)
                : launch_t<kBwd, true, false>(a, stream);
  else
    err = a.act ? launch_t<kBwd, false, true>(a, stream)
                : launch_t<kBwd, false, false>(a, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// the 16-byte path's alignment: every per-element f32 array on 16 bytes
// (null: not used), hard on 4; with n % 4 == 0 every row start follows
bool aligned_all(const void* dout, const void* base, const void* nu,
                 const void* hard, const void* out) {
  return aligned16(dout) && aligned16(base) && aligned16(nu) &&
         aligned16(out) && (reinterpret_cast<uintptr_t>(hard) & 3) == 0;
}

bool bad_shape(int ng, int g, int n, const void* act, int act_ng) {
  return ng < 1 || g < 1 || n < 1 ||
         (act != nullptr && (act_ng < 1 || ng % act_ng != 0));
}

}  // namespace

extern "C" int soft_round_fwd(const void* base, const void* nu,
                              const void* hard, const void* v,
                              const void* scale, const void* zero,
                              const void* act, void* out, int ng, int g,
                              int n, int act_ng, int qmax, int dst,
                              void* stream) {
  if (bad_shape(ng, g, n, act, act_ng))
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = make_plan(ng, g, n,
                           aligned_all(nullptr, base, nu, hard, out), false);
  if (p.blocks > MAX_BLOCKS) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{nullptr,
               static_cast<const float*>(base),
               static_cast<const float*>(nu),
               static_cast<const int8_t*>(hard),
               static_cast<const float*>(v),
               static_cast<const float*>(scale),
               static_cast<const float*>(zero),
               static_cast<const float*>(act),
               static_cast<float*>(out),
               nullptr,
               g, n, act_ng, dst, static_cast<float>(qmax), p};
  return launch<false>(a, static_cast<cudaStream_t>(stream));
}

extern "C" int soft_round_bwd(const void* dout, const void* base,
                              const void* nu, const void* hard, const void* v,
                              const void* scale, const void* zero,
                              const void* act, void* dnu, void* dv, int ng,
                              int g, int n, int act_ng, int qmax, int dst,
                              void* stream) {
  if (bad_shape(ng, g, n, act, act_ng))
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = make_plan(ng, g, n, aligned_all(dout, base, nu, hard, dnu),
                           true);
  if (p.blocks > MAX_BLOCKS) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const float*>(dout),
               static_cast<const float*>(base),
               static_cast<const float*>(nu),
               static_cast<const int8_t*>(hard),
               static_cast<const float*>(v),
               static_cast<const float*>(scale),
               static_cast<const float*>(zero),
               static_cast<const float*>(act),
               static_cast<float*>(dnu),
               static_cast<float*>(dv),
               g, n, act_ng, dst, static_cast<float>(qmax), p};
  return launch<true>(a, static_cast<cudaStream_t>(stream));
}

// The plan a launch with these operands takes (dout null for the forward,
// out the θ̂ or dν buffer), into cfg[0..7]: columns per thread, columns per
// block, warps per block, rows a warp has in flight, splits (blocks per
// cluster in the backward), rows per split, column tiles, 16-byte path.
// The grid is ng x tiles x splits blocks.  Launches nothing.
extern "C" int soft_round_config(const void* dout, const void* base,
                                 const void* nu, const void* hard,
                                 const void* out, int ng, int g, int n,
                                 int* cfg) {
  if (bad_shape(ng, g, n, nullptr, 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = make_plan(ng, g, n, aligned_all(dout, base, nu, hard, out),
                           dout != nullptr);
  const int v[8] = {VEC,     TILE,    p.warps, ROWS,
                    p.splits, p.per, p.tiles, p.vec};
  for (int i = 0; i < 8; ++i) cfg[i] = v[i];
  return 0;
}
