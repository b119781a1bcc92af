// Slot-aware single-token decode attention, over the dense slot-major cache
// and over a paged KV pool.
//
// Replaces the Pallas TPU kernels src/repro/kernels/decode_attention.py
// (decode_attention -> _decode_attn_kernel and paged_decode_attention ->
// _paged_decode_attn_kernel).
//   q      (B, Hkv, G, D)  bf16   GQA query rows grouped by their KV head
//   dense: k, v (B, S, Hkv, D) bf16, the cache lanes, read in place
//   paged: k, v (P, psz, Hkv, D) bf16 page pools, ptab (B, W) int32; logical
//          position t of slot b lives in pool row (ptab[b, t / psz], t % psz)
//   kv_len, q_pos  (B,) int32; active (B,) int32 or null (every slot live)
//   out    (B, Hkv, G, D)  bf16
// Slot b attends to positions t < n_b = min(kv_len[b], q_pos[b] + 1, S)
// (S = W * psz when paged): the reference's masks (kpos < kv_len) &
// (kpos <= q_pos).  Scores are q.k.scale in f32; the softmax is online with
// a running max (initialised to -1e30, as the reference) and sum; the
// output is acc / max(l, 1e-30), rounded to bf16.  An inactive slot (and a
// slot with no visible position) writes exact zeros and reads no K/V.  The
// kernel never reads a position at or past n_b, so a page table entry past
// a slot's visible positions (unallocated) is never read.
//
// What bounds it on an H100: memory at long lanes, latency at short ones.
// Each live position costs 4*D bytes of K and V per KV head against 4*G*D
// operations, at most 8 operations a byte for G <= 8, far under the ~295 at
// which the card stops being bound by its memory: the products stay on the
// CUDA cores in f32.  At decode sizes (a few MB) the launch, two dependent
// DRAM round trips (the slot's length, then its K/V) and each warp's chain
// of dependent instructions take most of the time, so the design keeps
// bytes in flight and cuts instructions and barriers per byte:
// - 16-byte copies into a shared-memory ring.  A K/V row of one head (D
//   contiguous bf16) is covered by `tpr` lanes, 8 values a lane (D = 128:
//   16 lanes, so a warp takes two rows a step).  Each lane copies its own
//   16-byte chunks of `u` row steps (a batch: 6 positions, 3 KB a warp at
//   G = 1, D = 128; else up to 8 positions, 4 KB) by cp.async into its warp's ring of STAGES slots, STAGES - 1
//   batches ahead of the one in use, and reads back only what it copied:
//   no barrier inside the walk.  A row's offset is resolved once per row;
//   the paged walk divides by the page size with a multiply-shift and
//   reads the page table once per warp run (the run's entries in one
//   register per lane, picked by a shuffle) unless the run spans more than
//   32 pages.  D not a multiple of 8, or an unaligned base, takes plain
//   loads into the same ring.
// - The online softmax in registers.  Each lane group (the lanes of one row
//   slot) keeps its running max, sum and accumulator in registers for the
//   block's query rows (G is cut into blocks of MAX_GT = 2 rows: more rows
//   a block lengthen every warp's chain more than the re-read K/V, mostly
//   from L2, costs); the q.k reduction is a shuffle across the row's lanes
//   and the exponentials are the hardware's (__expf: ex2 of x log2 e,
//   within a few f32 ulps, far inside the bf16 output's rounding).
// - The sequence split, then merged in a fixed order, in one launch
//   (flash-decoding).  Each warp of a block (8, or 4 where the registers
//   are short) owns a fixed run of `run` logical positions; a long lane, or
//   a shape with few (KV head, row chunk) pairs, is split over `splits`
//   blocks that form a thread-block cluster.  A warp merges its lane
//   groups by shuffles in lane order and leaves (m, l, acc) in shared
//   memory; the block merges its warps in warp order; then, after a
//   cluster barrier, each block merges a share of the outputs over the
//   blocks' partials in split order through distributed shared memory:
//   m = max m_i, l = sum l_i exp(m_i - m), acc = sum acc_i exp(m_i - m).
//   An empty warp or block contributes m = -1e30, l = 0, acc = 0, exact
//   zeros.  With one split the block writes the output itself (the
//   cluster merge of one partial is the identity).  No atomics, no
//   workspace, no second launch.
// - One plan, a function of (S, Hkv, G, D) alone (make_plan; the 16-byte
//   load flag changes no arithmetic).  Dense S = W * psz, so the dense and
//   the paged kernel take the same plan and the same order and are bit-
//   identical at any page size; a slot's output does not depend on the
//   other slots or on B; two launches on the same operands are bit-equal.
//   decode_attention_config reports the plan without launching.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int MAX_SPLITS = 8;        // portable cluster size
constexpr int MAX_GT = 2;            // query rows a block takes
constexpr int MAX_CPL = 4;           // D <= 32 lanes x 8 x 4 = 1024
constexpr int FILL_CHUNKS = 32;      // (KV head, row chunk) x splits to aim at
constexpr int MAX_RUN = 48;          // positions a warp takes before a split
constexpr int STAGES = 2;            // ring slots a warp (one batch each)
constexpr float NEG_BIG = -1e30f;

// Every choice of a launch: the launch runs on it and decode_attention_config
// reports it.  All but `vec` (which changes no arithmetic) are a function of
// (S, Hkv, G, D) alone.
struct Plan {
  int tpr;     // lanes per K/V row (a power of two)
  int ltpr;    // log2(tpr)
  int cpl;     // 8-element chunks a lane holds per row
  int gt;      // query rows per block
  int gz;      // blocks along G: ceil(G / gt)
  int u;       // row steps a warp loads before using them
  int nw;      // warps per block
  int splits;  // blocks per (slot, KV head, row chunk): one cluster
  int run;     // positions per warp
  int vec;     // K/V by 16-byte loads
};

// row steps a batch: 4 16-byte K/V words a lane (D <= 256: 8 positions a
// warp, 4 KB), or 3 at one query row of D <= 256 (the LLaMA runs of 18
// positions are then three whole batches, and the smaller ring leaves room
// for more blocks: measured faster there, and no slower at long lanes)
__host__ __device__ constexpr int steps_of(int cpl, int gt) {
  return cpl == 1 && gt == 1 ? 3 : 4 / cpl;
}

// warps per block: 8 where a lane's query rows and accumulators leave the
// registers for it (G * D <= 256 a lane group), else 4
__host__ __device__ constexpr int nw_of(int cpl, int gt) {
  return cpl * gt <= 2 ? 8 : 4;
}

Plan make_plan(const void* k, const void* v, int S, int Hkv, int G, int D) {
  Plan p = {};
  const int chunks = (D + 7) / 8;
  // a row's 16-byte chunks over up to 32 lanes (D = 128: 16 lanes, 8
  // values each), then up to MAX_GT query rows
  p.tpr = 1;
  p.ltpr = 0;
  while (p.tpr < chunks && p.tpr < 32) {
    p.tpr *= 2;
    ++p.ltpr;
  }
  p.cpl = 1;
  while (p.cpl * 8 * p.tpr < D) p.cpl *= 2;
  p.gt = 1;
  while (p.gt < G && p.gt < MAX_GT) p.gt *= 2;
  p.gz = (G + p.gt - 1) / p.gt;
  p.u = steps_of(p.cpl, p.gt);
  p.nw = nw_of(p.cpl, p.gt);
  const int NW = p.nw;
  const int rpw = 32 / p.tpr;
  const int batch = rpw * p.u;          // positions a warp takes a batch
  // long lanes split so no warp walks more than MAX_RUN positions; few
  // (KV head, row chunk) pairs split to fill the card; no split so fine
  // that a warp has less than one batch of positions
  int s_len = (S + NW * MAX_RUN - 1) / (NW * MAX_RUN);
  int s_fill = (FILL_CHUNKS + Hkv * p.gz - 1) / (Hkv * p.gz);
  int s_most = (S + NW * batch - 1) / (NW * batch);
  int s = s_len > s_fill ? s_len : s_fill;
  s = s < s_most ? s : s_most;
  s = s < MAX_SPLITS ? s : MAX_SPLITS;
  s = s > 1 ? s : 1;
  int run = (S + s * NW - 1) / (s * NW);
  run = (run + rpw - 1) / rpw * rpw;    // whole row steps
  run = run > 0 ? run : rpw;
  p.run = run;
  p.splits = (S + NW * run - 1) / (NW * run);  // no split past S
  p.splits = p.splits > 1 ? p.splits : 1;
  auto aligned = [](const void* a) {
    return (reinterpret_cast<uintptr_t>(a) & 15) == 0;
  };
  p.vec = D % 8 == 0 && aligned(k) && aligned(v);
  return p;
}

// t / d for 0 <= t < 2^31 by a multiply and a shift (d >= 1)
struct FastDiv {
  int d;
  unsigned mul;
  int shr;
  FastDiv() = default;
  explicit FastDiv(int div) : d(div), mul(0), shr(0) {
    if (d > 1) {
      int l = 0;
      while ((1 << l) < d) ++l;
      const int p = 31 + l;
      mul = static_cast<unsigned>(((1ull << p) + d - 1) / d);
      shr = p - 32;
    }
  }
  __device__ int operator()(int t) const {
    return d == 1 ? t : static_cast<int>(__umulhi(t, mul) >> shr);
  }
};

// Row index (into the (rows, Hkv, D) view of the cache or the pool) of
// logical position t of slot b.  begin() is called once per warp run
// [t0, t1) by every lane of the warp; row() by every lane (t clamped into
// the run), so the shuffle inside sees the whole warp.
struct DenseRows {
  int S;
  size_t base;
  __device__ void begin(int b, int, int, int) { base = (size_t)b * S; }
  __device__ size_t row(int t) const { return base + t; }
};

struct PagedRows {
  const int* ptab;
  int W;
  FastDiv psz;
  const int* trow;
  int first, entry;
  bool held;
  __device__ void begin(int b, int t0, int t1, int lane) {
    trow = ptab + (size_t)b * W;
    entry = 0;
    first = psz(t0);
    const int pages = psz(t1 - 1) - first + 1;
    held = pages <= 32;
    if (held && lane < pages) entry = trow[first + lane];
  }
  __device__ size_t row(int t) const {
    const int pg = psz(t);
    const int page = held ? __shfl_sync(0xffffffffu, entry, pg - first)
                          : trow[pg];
    return (size_t)page * psz.d + (t - pg * psz.d);
  }
};

struct Args {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const int* kv_len;
  const int* q_pos;
  const int* active;
  __nv_bfloat16* out;
  int S, Hkv, G, D;
  float scale;
  Plan p;
  FastDiv hkv;  // blockIdx.x = b * Hkv + h
  FastDiv dd;   // output i = g * D + d
};

// the 8 bf16 of a 16-byte word, widened in place
__device__ inline void widen(const uint4& w, float* f) {
  const unsigned u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(u[i] << 16);
    f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

// up to 8 bf16 (the first `left` of them) by plain loads, packed as one
// 16-byte word with zeros after; out of line, so the 16-byte path's code
// stays small
__device__ __noinline__ uint4 gather8(const __nv_bfloat16* src, int left) {
  unsigned u[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const unsigned lo = 2 * i < left ? __bfloat16_as_ushort(src[2 * i]) : 0u;
    const unsigned hi =
        2 * i + 1 < left ? __bfloat16_as_ushort(src[2 * i + 1]) : 0u;
    u[i] = lo | (hi << 16);
  }
  return make_uint4(u[0], u[1], u[2], u[3]);
}

// (m, l, acc) of one warp in shared memory: m[MAX_GT], l[MAX_GT], acc[gt * D]
__host__ __device__ inline int part_floats(int gt, int D) {
  return 2 * MAX_GT + gt * D;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One ring slot holds a batch: K then V, U row steps of 32 / tpr rows of
// 8 * tpr * CPL bf16 each (256 * CPL values a step, whatever tpr is).
template <int CPL, int U>
__host__ __device__ constexpr int slot_elems() {
  return 2 * U * 256 * CPL;
}

// floats of one warp's region of shared memory: its ring of STAGES slots,
// which its (m, l, acc) partial reuses after the walk
template <int CPL, int GT>
__host__ __device__ inline int warp_floats(int D) {
  const int ring = STAGES * slot_elems<CPL, steps_of(CPL, GT)>() / 2;
  const int part = (part_floats(GT, D) + 3) / 4 * 4;
  return ring > part ? ring : part;
}

// Issue the copies of one batch (U row steps from t0) into a ring slot:
// the lane's own chunks of its row slot r, by 16-byte cp.async (or plain
// loads and a shared store).  Positions past t_end, and chunks past D, are
// not read; the lane that copies a chunk is the lane that reads it.
template <int CPL, int U, typename Rows>
__device__ __forceinline__ void issue_batch(const Args& a, const Rows& rows,
                                            int t0, int t_end, int r, int li,
                                            size_t hd, __nv_bfloat16* slot) {
  const int tpr = a.p.tpr, rpw = 32 >> a.p.ltpr, D = a.D;
  const int rw = 8 * CPL * tpr;         // a row's values in the slot
  const size_t rs = (size_t)a.Hkv * D;  // elements between cache rows
#pragma unroll
  for (int s = 0; s < U; ++s) {
    const int t = t0 + s * rpw + r;
    const bool ok = t < t_end;
    const size_t off = rows.row(ok ? t : t_end - 1) * rs + hd;
    __nv_bfloat16* ks = slot + (s * rpw + r) * rw;
    __nv_bfloat16* vs = ks + U * 256 * CPL;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int c = li + j * tpr;
      if (!ok || 8 * c >= D) continue;
      const size_t at = off + 8 * c;
      if (a.p.vec) {
        cp_async16(ks + 8 * c, a.k + at);
        cp_async16(vs + 8 * c, a.v + at);
      } else {
        *reinterpret_cast<uint4*>(ks + 8 * c) = gather8(a.k + at, D - 8 * c);
        *reinterpret_cast<uint4*>(vs + 8 * c) = gather8(a.v + at, D - 8 * c);
      }
    }
  }
}

// The K/V words of one batch back from its ring slot (zeros where nothing
// was copied).
template <int CPL, int U>
__device__ __forceinline__ void read_batch(const __nv_bfloat16* slot, int t0,
                                           int t_end, int r, int li, int tpr,
                                           int rpw, int D,
                                           uint4 (&kw)[U][CPL],
                                           uint4 (&vw)[U][CPL]) {
  const int rw = 8 * CPL * tpr;
#pragma unroll
  for (int s = 0; s < U; ++s) {
    const bool ok = t0 + s * rpw + r < t_end;
    const __nv_bfloat16* ks = slot + (s * rpw + r) * rw;
    const __nv_bfloat16* vs = ks + U * 256 * CPL;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int c = li + j * tpr;
      const bool in = ok && 8 * c < D;
      kw[s][j] = in ? *reinterpret_cast<const uint4*>(ks + 8 * c)
                    : make_uint4(0u, 0u, 0u, 0u);
      vw[s][j] = in ? *reinterpret_cast<const uint4*>(vs + 8 * c)
                    : make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// One batch into the lane group's running (m, l, acc): the scores (reduced
// across the row's lanes), the batch's max, then the probabilities and the
// P.V update.
template <int CPL, int GT, int U>
__device__ __forceinline__ void softmax_batch(
    const float (&qr)[GT][8 * CPL], float (&m)[GT], float (&l)[GT],
    float (&acc)[GT][8 * CPL], const uint4 (&kw)[U][CPL],
    const uint4 (&vw)[U][CPL], int t0, int t_end, int r, int tpr, int rpw) {
  constexpr int E = 8 * CPL;
  bool ok[U];
  float sc[U][GT];
#pragma unroll
  for (int s = 0; s < U; ++s) {
    ok[s] = t0 + s * rpw + r < t_end;
    float kf[E];
#pragma unroll
    for (int j = 0; j < CPL; ++j) widen(kw[s][j], kf + 8 * j);
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      float dot = 0.0f;
#pragma unroll
      for (int e = 0; e < E; ++e) dot = fmaf(qr[g][e], kf[e], dot);
      sc[s][g] = dot;
    }
  }
  // every score's shuffles at one offset together
  for (int off = tpr / 2; off > 0; off /= 2)
#pragma unroll
    for (int s = 0; s < U; ++s)
#pragma unroll
      for (int g = 0; g < GT; ++g)
        sc[s][g] += __shfl_xor_sync(0xffffffffu, sc[s][g], off);
  // sc becomes the probabilities
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    float bm = NEG_BIG;
#pragma unroll
    for (int s = 0; s < U; ++s)
      if (ok[s]) bm = fmaxf(bm, sc[s][g]);
    const float mn = fmaxf(m[g], bm);
    const float corr = __expf(m[g] - mn);
    float ps = 0.0f;
#pragma unroll
    for (int s = 0; s < U; ++s) {
      sc[s][g] = ok[s] ? __expf(sc[s][g] - mn) : 0.0f;
      ps += sc[s][g];
    }
    l[g] = l[g] * corr + ps;
    m[g] = mn;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] *= corr;
  }
#pragma unroll
  for (int s = 0; s < U; ++s) {
    float vf[E];
#pragma unroll
    for (int j = 0; j < CPL; ++j) widen(vw[s][j], vf + 8 * j);
#pragma unroll
    for (int g = 0; g < GT; ++g)
#pragma unroll
      for (int e = 0; e < E; ++e)
        acc[g][e] = fmaf(sc[s][g], vf[e], acc[g][e]);
  }
}

template <int CPL, int GT, typename Rows>
__global__ void __launch_bounds__(32 * nw_of(CPL, GT))
decode_attention_kernel(const Args a, Rows rows) {
  constexpr int NW = nw_of(CPL, GT);
  constexpr int THREADS = 32 * NW;
  constexpr int E = 8 * CPL;            // values a lane holds per row
  constexpr int U = steps_of(CPL, GT);
  extern __shared__ float smem[];
  const Plan& p = a.p;
  const int D = a.D;
  const int b = a.hkv(blockIdx.x);
  const int h = blockIdx.x - b * a.Hkv;
  const int split = blockIdx.y;         // = the block's rank in its cluster
  const int g0 = blockIdx.z * GT;
  const int gn = min(GT, a.G - g0);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int tpr = p.tpr;
  const int rpw = 32 >> p.ltpr;         // rows a warp step
  const int r = lane >> p.ltpr;         // the lane's row slot in a step
  const int li = lane & (tpr - 1);      // its place in the row
  const size_t qoff = (((size_t)b * a.Hkv + h) * a.G + g0) * D;
  __nv_bfloat16* o = a.out + qoff;

  // the slot's length and liveness first (the K/V copies wait on them),
  // then the lane's elements of each query row, scaled: d = 8 * (li + j *
  // tpr) + e; the reads overlap
  int n = min(a.kv_len[b], a.q_pos[b] + 1);
  const bool dead = a.active != nullptr && a.active[b] == 0;
  float qr[GT][E];
  const bool qvec = D % 8 == 0 && (reinterpret_cast<uintptr_t>(a.q) & 15) == 0;
#pragma unroll
  for (int g = 0; g < GT; ++g)
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int c = li + j * tpr;
      uint4 w = make_uint4(0u, 0u, 0u, 0u);
      if (g < gn && 8 * c < D) {
        const __nv_bfloat16* src = a.q + qoff + g * D + 8 * c;
        w = qvec ? __ldg(reinterpret_cast<const uint4*>(src))
                 : gather8(src, D - 8 * c);
      }
      widen(w, qr[g] + 8 * j);
#pragma unroll
      for (int e = 0; e < 8; ++e) qr[g][8 * j + e] *= a.scale;
    }
  n = min(n, a.S);
  if (dead || n <= 0) {
    for (int i = split * THREADS + tid; i < gn * D; i += p.splits * THREADS)
      o[i] = __float2bfloat16(0.0f);
    return;  // every block of the cluster returns here: no barrier waits
  }

  float m[GT], l[GT], acc[GT][E];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m[g] = NEG_BIG;
    l[g] = 0.0f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.0f;
  }

  // the warp's run through its ring of STAGES slots: STAGES - 1 batches'
  // copies in flight ahead of the batch in use (a run of up to STAGES
  // batches is in flight whole before the first wait)
  const int t_begin = (split * NW + warp) * p.run;
  const int t_end = min(t_begin + p.run, n);
  const size_t hd = (size_t)h * D;
  // a warp's region: its ring, later its partial (16-byte aligned)
  const int wr = warp_floats<CPL, GT>(D);
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem + warp * wr);
  if (t_begin < t_end) {
    rows.begin(b, t_begin, t_end, lane);
    const int step = U * rpw;
    const int nb = (t_end - t_begin + step - 1) / step;
#pragma unroll
    for (int k = 0; k < STAGES - 1; ++k) {
      if (k < nb)
        issue_batch<CPL, U>(a, rows, t_begin + k * step, t_end, r, li, hd,
                            ring + k * slot_elems<CPL, U>());
      cp_async_commit();
    }
    for (int k = 0; k < nb; ++k) {
      const int kn = k + STAGES - 1;
      if (kn < nb)
        issue_batch<CPL, U>(a, rows, t_begin + kn * step, t_end, r, li, hd,
                            ring + (kn % STAGES) * slot_elems<CPL, U>());
      cp_async_commit();
      cp_async_wait<STAGES - 1>();
      uint4 kw[U][CPL], vw[U][CPL];
      const int t0 = t_begin + k * step;
      read_batch<CPL, U>(ring + (k % STAGES) * slot_elems<CPL, U>(), t0, t_end,
                         r, li, tpr, rpw, D, kw, vw);
      softmax_batch<CPL, GT, U>(qr, m, l, acc, kw, vw, t0, t_end, r, tpr,
                                rpw);
    }
    cp_async_wait<0>();
  }

  // merge the warp's lane groups in lane order: (lo, hi) with lo the group
  // whose lanes have bit `off` clear, so both lanes compute one expression
  for (int off = tpr; off < 32; off *= 2) {
    const bool upper = (lane & off) != 0;
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float l2 = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float mlo = upper ? m2 : m[g], mhi = upper ? m[g] : m2;
      const float llo = upper ? l2 : l[g], lhi = upper ? l[g] : l2;
      const float mn = fmaxf(mlo, mhi);
      const float clo = __expf(mlo - mn), chi = __expf(mhi - mn);
      l[g] = llo * clo + lhi * chi;
      m[g] = mn;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float a2 = __shfl_xor_sync(0xffffffffu, acc[g][e], off);
        const float alo = upper ? a2 : acc[g][e];
        const float ahi = upper ? acc[g][e] : a2;
        acc[g][e] = alo * clo + ahi * chi;
      }
    }
  }
  // the warps' partials, then the block's, in shared memory
  float* bpart = smem + NW * wr;
  if (lane < tpr) {
    float* mine = smem + warp * wr;  // over the warp's own ring
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      if (lane == 0) {
        mine[g] = m[g];
        mine[MAX_GT + g] = l[g];
      }
#pragma unroll
      for (int j = 0; j < CPL; ++j)
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int d = 8 * (li + j * tpr) + e;
          if (d < D) mine[2 * MAX_GT + g * D + d] = acc[g][8 * j + e];
        }
    }
  }
  __syncthreads();
  // merge the block's warps in warp order (an empty warp has m = -1e30, l =
  // 0, acc = 0 and adds exact zeros)
  const int outs = gn * D;
#pragma unroll 1
  for (int i = tid; i < outs; i += THREADS) {
    const int g = a.dd(i);
    float mw[NW], lw[NW], aw[NW];
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float* pw = smem + w * wr;
      mw[w] = pw[g];
      lw[w] = pw[MAX_GT + g];
      aw[w] = pw[2 * MAX_GT + i];
    }
    float mx = mw[0];
#pragma unroll
    for (int w = 1; w < NW; ++w) mx = fmaxf(mx, mw[w]);
    float ls = 0.0f, as = 0.0f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float c = __expf(mw[w] - mx);
      ls = fmaf(lw[w], c, ls);
      as = fmaf(aw[w], c, as);
    }
    if (p.splits == 1) {  // the cluster merge of one partial is the identity
      o[i] = __float2bfloat16(as / fmaxf(ls, 1e-30f));
      continue;
    }
    bpart[2 * MAX_GT + i] = as;
    if (i == g * D) {
      bpart[g] = mx;
      bpart[MAX_GT + g] = ls;
    }
  }

  if (p.splits == 1) return;

  // the cluster's blocks meet; block `split` merges its share of the
  // outputs over the blocks' partials in split order, every load of them
  // issued before the arithmetic
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
#pragma unroll 1
  for (int i = split * THREADS + tid; i < outs; i += p.splits * THREADS) {
    const int g = a.dd(i);
    float mc[MAX_SPLITS], lc[MAX_SPLITS], ac[MAX_SPLITS];
#pragma unroll
    for (int c = 0; c < MAX_SPLITS; ++c) {
      mc[c] = NEG_BIG;
      lc[c] = ac[c] = 0.0f;
      if (c < p.splits) {
        const float* pc = cluster.map_shared_rank(bpart, c);
        mc[c] = pc[g];
        lc[c] = pc[MAX_GT + g];
        ac[c] = pc[2 * MAX_GT + i];
      }
    }
    float mx = mc[0];
#pragma unroll
    for (int c = 1; c < MAX_SPLITS; ++c) mx = fmaxf(mx, mc[c]);
    float ls = 0.0f, as = 0.0f;
#pragma unroll
    for (int c = 0; c < MAX_SPLITS; ++c) {
      if (c < p.splits) {
        const float e = __expf(mc[c] - mx);
        ls = fmaf(lc[c], e, ls);
        as = fmaf(ac[c], e, as);
      }
    }
    o[i] = __float2bfloat16(as / fmaxf(ls, 1e-30f));
  }
  cluster.sync();  // keep this block's partials until every block has read
}

// bytes of dynamic shared memory: the warps' rings (each warp's partial
// goes over its own), then the block's partial
template <int CPL, int GT>
int smem_bytes(int D) {
  return (nw_of(CPL, GT) * warp_floats<CPL, GT>(D) + part_floats(GT, D)) *
         static_cast<int>(sizeof(float));
}

template <int CPL, int GT, typename Rows>
int launch_t(const Args& a, Rows rows, int B, cudaStream_t stream) {
  auto kern = decode_attention_kernel<CPL, GT, Rows>;
  constexpr int NW = nw_of(CPL, GT);
  // the most this instantiation takes (D <= 256 * CPL), allowed once: a
  // driver call on every launch would lengthen the host's path
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes<CPL, GT>(256 * CPL));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int smem = smem_bytes<CPL, GT>(a.D);
  const Plan& p = a.p;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * a.Hkv, p.splits, p.gz);
  cfg.blockDim = dim3(32 * NW, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = 1;
  at[0].val.clusterDim.y = p.splits;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = p.splits > 1 ? 1 : 0;  // one split: no cluster
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kern, a, rows);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename Rows>
int launch(const Args& a, Rows rows, int B, cudaStream_t stream) {
  switch (a.p.cpl * 16 + a.p.gt) {
    case 16 + 1: return launch_t<1, 1>(a, rows, B, stream);
    case 16 + 2: return launch_t<1, 2>(a, rows, B, stream);
    case 32 + 1: return launch_t<2, 1>(a, rows, B, stream);
    case 32 + 2: return launch_t<2, 2>(a, rows, B, stream);
    case 64 + 1: return launch_t<4, 1>(a, rows, B, stream);
    case 64 + 2: return launch_t<4, 2>(a, rows, B, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

Args make_args(const void* q, const void* k, const void* v,
               const void* kv_len, const void* q_pos, const void* active,
               void* out, int S, int Hkv, int G, int D, float scale) {
  return Args{static_cast<const __nv_bfloat16*>(q),
              static_cast<const __nv_bfloat16*>(k),
              static_cast<const __nv_bfloat16*>(v),
              static_cast<const int*>(kv_len),
              static_cast<const int*>(q_pos),
              static_cast<const int*>(active),
              static_cast<__nv_bfloat16*>(out),
              S, Hkv, G, D, scale,
              make_plan(k, v, S, Hkv, G, D), FastDiv(Hkv), FastDiv(D)};
}

bool supported(int B, int S, int Hkv, int G, int D) {
  return B > 0 && S >= 0 && Hkv > 0 && G > 0 && D > 0 &&
         D <= 32 * 8 * MAX_CPL;
}

}  // namespace

extern "C" int launch_decode_attention(const void* q, const void* k,
                                       const void* v, const void* kv_len,
                                       const void* q_pos, const void* active,
                                       void* out, int B, int S, int Hkv, int G,
                                       int D, float scale, void* stream) {
  if (!supported(B, S, Hkv, G, D))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a = make_args(q, k, v, kv_len, q_pos, active, out, S, Hkv, G, D,
                           scale);
  return launch(a, DenseRows{S, 0}, B, static_cast<cudaStream_t>(stream));
}

extern "C" int launch_paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool, const void* ptab,
    const void* kv_len, const void* q_pos, const void* active, void* out,
    int B, int W, int psz, int Hkv, int G, int D, float scale, void* stream) {
  const int S = W * psz;
  if (!supported(B, S, Hkv, G, D))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a = make_args(q, k_pool, v_pool, kv_len, q_pos, active, out, S,
                           Hkv, G, D, scale);
  PagedRows rows = {};
  rows.ptab = static_cast<const int*>(ptab);
  rows.W = W;
  rows.psz = FastDiv(psz);
  return launch(a, rows, B, static_cast<cudaStream_t>(stream));
}

// The plan a launch with these K/V bases and shapes takes (dense S, or
// W * psz when paged), into cfg[0..8]: lanes per K/V row, 8-element chunks
// a lane holds, query rows per block, blocks along G, row steps a batch,
// splits (blocks per cluster), positions per warp, 16-byte loads, warps per
// block.  Launches nothing.
extern "C" int decode_attention_config(const void* k, const void* v, int S,
                                       int Hkv, int G, int D, int* cfg) {
  if (!supported(1, S, Hkv, G, D))
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = make_plan(k, v, S, Hkv, G, D);
  const int vals[9] = {p.tpr, p.cpl, p.gt, p.gz, p.u,
                       p.splits, p.run, p.vec, p.nw};
  for (int i = 0; i < 9; ++i) cfg[i] = vals[i];
  return 0;
}
