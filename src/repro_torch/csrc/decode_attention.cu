// Slot-aware single-token decode attention over the dense slot-major cache.
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py
// (decode_attention -> _decode_attn_kernel).
//   q      (B, Hkv, G, D)  bf16   GQA query rows grouped by their KV head
//   k, v   (B, S, Hkv, D)  bf16   the cache lanes, read in place
//   kv_len, q_pos, active  (B,) int32
//   out    (B, Hkv, G, D)  bf16
// Slot b attends to positions t < n_b = min(kv_len[b], q_pos[b] + 1, S):
// the reference's masks (kpos < kv_len) & (kpos <= q_pos).  Softmax is
// online in f32 with a running max (initialised to -1e30, as the reference)
// and sum; the output is acc / max(l, 1e-30).  An inactive slot (and a slot
// with no visible position) writes exact zeros and reads no K/V.  The kernel
// never reads a position at or past S.
//
// What bounds it on an H100: memory.  Each live position costs 2*D bf16
// reads per KV head against 4*G*D operations, so the K/V bytes of the live
// positions set the floor.  Design: one 128-thread block per (slot, KV head)
// holds the G query rows (scaled, f32) in shared memory and walks the live
// positions in 32-position tiles: the K and V tile rows (contiguous D-wide
// runs of the cache) are loaded coalesced into shared memory as f32, each
// warp reduces whole (query row, position) dot products with shuffles, one
// thread per query row updates the running max/sum, and each thread updates
// the accumulator of the (row, d) entries it owns.  With B*Hkv = 128 blocks
// at the main-path shape the grid roughly fills the card; splitting long
// sequences across blocks (flash-decoding) is a later PR's work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int DA_THREADS = 128;
constexpr int DA_WARPS = DA_THREADS / 32;
constexpr int DA_T = 32;          // positions per tile
constexpr float NEG_BIG = -1e30f;

__global__ void __launch_bounds__(DA_THREADS)
decode_attention_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
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

  const size_t pos_stride = (size_t)Hkv * D;
  const __nv_bfloat16* kb = k + ((size_t)b * S * Hkv + h) * D;
  const __nv_bfloat16* vb = v + ((size_t)b * S * Hkv + h) * D;

  for (int t0 = 0; t0 < n; t0 += DA_T) {
    const int tn = min(DA_T, n - t0);
    for (int i = tid; i < tn * D; i += DA_THREADS) {
      const int t = i / D;
      const int d = i % D;
      const size_t off = (size_t)(t0 + t) * pos_stride + d;
      ks[i] = __bfloat162float(kb[off]);
      vs[i] = __bfloat162float(vb[off]);
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

}  // namespace

extern "C" int launch_decode_attention(const void* q, const void* k,
                                       const void* v, const void* kv_len,
                                       const void* q_pos, const void* active,
                                       void* out, int B, int S, int Hkv, int G,
                                       int D, float scale, void* stream) {
  const size_t smem =
      sizeof(float) * ((size_t)2 * G * D + (size_t)2 * DA_T * D +
                       (size_t)G * DA_T + (size_t)3 * G);
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        decode_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  decode_attention_kernel<<<B * Hkv, DA_THREADS, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(kv_len),
      static_cast<const int*>(q_pos), static_cast<const int*>(active),
      static_cast<__nv_bfloat16*>(out), S, Hkv, G, D, scale);
  return static_cast<int>(cudaGetLastError());
}
