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
//   kv_len, q_pos, active  (B,) int32
//   out    (B, Hkv, G, D)  bf16
// Slot b attends to positions t < n_b = min(kv_len[b], q_pos[b] + 1, S)
// (S = W * psz when paged): the reference's masks (kpos < kv_len) &
// (kpos <= q_pos).  Softmax is online in f32 with a running max
// (initialised to -1e30, as the reference) and sum; the output is
// acc / max(l, 1e-30).  An inactive slot (and a slot with no visible
// position) writes exact zeros and reads no K/V.  The kernel never reads a
// position at or past n_b, so a page table entry past a slot's visible
// positions (unallocated) is never read.
//
// What bounds it on an H100: memory.  Each live position costs 2*D bf16
// reads per KV head against 4*G*D operations, so the K/V bytes of the live
// positions set the floor.  Design: one 128-thread block per (slot, KV head)
// holds the G query rows (scaled, f32) in shared memory and walks the live
// LOGICAL positions in 32-position tiles: each row's offset is resolved as
// it is loaded (b*S + t for the dense cache, through the page table for the
// pool; with D = 128 a warp reads one table entry per row, a broadcast), the
// K and V tile rows (contiguous D-wide runs) are loaded coalesced into
// shared memory as f32, each warp reduces whole (query row,
// position) dot products with shuffles, one thread per query row updates
// the running max/sum, and each thread updates the accumulator of the
// (row, d) entries it owns.  The two kernels are one template that differs
// only in the row-offset policy, so they do the same arithmetic in the same
// order: dense and paged decode are bit-identical at any page size.  With
// B*Hkv = 128..256 blocks at the main-path shapes the grid roughly fills the
// card; splitting long sequences across blocks (flash-decoding) and cp.async
// loads are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int DA_THREADS = 128;
constexpr int DA_WARPS = DA_THREADS / 32;
constexpr int DA_T = 32;          // positions per tile
constexpr float NEG_BIG = -1e30f;

// element offset of (slot b, KV head h, logical position t, d = 0)
struct DenseRows {
  int S, Hkv, D;
  __device__ size_t operator()(int b, int h, int t) const {
    return (((size_t)b * S + t) * Hkv + h) * D;
  }
};

struct PagedRows {
  const int* ptab;
  int W, psz, Hkv, D;
  __device__ size_t operator()(int b, int h, int t) const {
    const size_t page = (size_t)ptab[(size_t)b * W + t / psz];
    return ((page * psz + t % psz) * Hkv + h) * D;
  }
};

template <typename Rows>
__global__ void __launch_bounds__(DA_THREADS)
decode_attention_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v, Rows rows,
                        const int* __restrict__ kv_len,
                        const int* __restrict__ q_pos,
                        const int* __restrict__ active,
                        __nv_bfloat16* __restrict__ out,
                        int S, int Hkv, int G, int D, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                // G*D   scaled query rows
  float* accs = qs + G * D;        // G*D   output accumulators
  float* ks = accs + G * D;        // T*D   K tile
  float* vs = ks + DA_T * D;       // T*D   V tile
  float* ps = vs + DA_T * D;       // G*T   scores, then probabilities
  float* ms = ps + G * DA_T;       // G     running max
  float* ls = ms + G;              // G     running sum
  float* cs = ls + G;              // G     this tile's correction

  const int b = blockIdx.x / Hkv;
  const int h = blockIdx.x % Hkv;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const size_t qoff = ((size_t)b * Hkv + h) * G * D;
  __nv_bfloat16* o = out + qoff;

  int n = min(kv_len[b], q_pos[b] + 1);
  n = min(n, S);
  if (active[b] == 0 || n <= 0) {
    for (int i = tid; i < G * D; i += DA_THREADS) o[i] = __float2bfloat16(0.0f);
    return;
  }

  for (int i = tid; i < G * D; i += DA_THREADS) {
    qs[i] = __bfloat162float(q[qoff + i]) * scale;
    accs[i] = 0.0f;
  }
  for (int g = tid; g < G; g += DA_THREADS) {
    ms[g] = NEG_BIG;
    ls[g] = 0.0f;
  }
  __syncthreads();

  for (int t0 = 0; t0 < n; t0 += DA_T) {
    const int tn = min(DA_T, n - t0);
    for (int i = tid; i < tn * D; i += DA_THREADS) {
      const size_t off = rows(b, h, t0 + i / D) + i % D;
      ks[i] = __bfloat162float(k[off]);
      vs[i] = __bfloat162float(v[off]);
    }
    __syncthreads();

    for (int pair = warp; pair < G * tn; pair += DA_WARPS) {
      const int g = pair / tn;
      const int t = pair % tn;
      float sum = 0.0f;
      for (int d = lane; d < D; d += 32) sum += qs[g * D + d] * ks[t * D + d];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) ps[g * DA_T + t] = sum;
    }
    __syncthreads();

    for (int g = tid; g < G; g += DA_THREADS) {
      float tile_max = NEG_BIG;
      for (int t = 0; t < tn; ++t) tile_max = fmaxf(tile_max, ps[g * DA_T + t]);
      const float m_prev = ms[g];
      const float m_new = fmaxf(m_prev, tile_max);
      float psum = 0.0f;
      for (int t = 0; t < tn; ++t) {
        const float p = expf(ps[g * DA_T + t] - m_new);
        ps[g * DA_T + t] = p;
        psum += p;
      }
      const float corr = expf(m_prev - m_new);
      ls[g] = ls[g] * corr + psum;
      ms[g] = m_new;
      cs[g] = corr;
    }
    __syncthreads();

    for (int i = tid; i < G * D; i += DA_THREADS) {
      const int g = i / D;
      const int d = i % D;
      float a = accs[i] * cs[g];
      for (int t = 0; t < tn; ++t) a += ps[g * DA_T + t] * vs[t * D + d];
      accs[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < G * D; i += DA_THREADS)
    o[i] = __float2bfloat16(accs[i] / fmaxf(ls[i / D], 1e-30f));
}

template <typename Rows>
int launch(const void* q, const void* k, const void* v, Rows rows,
           const void* kv_len, const void* q_pos, const void* active,
           void* out, int B, int S, int Hkv, int G, int D, float scale,
           void* stream) {
  const size_t smem =
      sizeof(float) * ((size_t)2 * G * D + (size_t)2 * DA_T * D +
                       (size_t)G * DA_T + (size_t)3 * G);
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        decode_attention_kernel<Rows>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  decode_attention_kernel<Rows><<<B * Hkv, DA_THREADS, smem,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), rows,
      static_cast<const int*>(kv_len), static_cast<const int*>(q_pos),
      static_cast<const int*>(active), static_cast<__nv_bfloat16*>(out), S,
      Hkv, G, D, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int launch_decode_attention(const void* q, const void* k,
                                       const void* v, const void* kv_len,
                                       const void* q_pos, const void* active,
                                       void* out, int B, int S, int Hkv, int G,
                                       int D, float scale, void* stream) {
  return launch(q, k, v, DenseRows{S, Hkv, D}, kv_len, q_pos, active, out, B,
                S, Hkv, G, D, scale, stream);
}

extern "C" int launch_paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool, const void* ptab,
    const void* kv_len, const void* q_pos, const void* active, void* out,
    int B, int W, int psz, int Hkv, int G, int D, float scale, void* stream) {
  return launch(q, k_pool, v_pool,
                PagedRows{static_cast<const int*>(ptab), W, psz, Hkv, D},
                kv_len, q_pos, active, out, B, W * psz, Hkv, G, D, scale,
                stream);
}
