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
// launch_quant_matmul_experts runs the same kernel body over E experts in
// ONE launch: every operand gains a leading expert dim (x (E, M, K), packed
// (E, K/ppb, N), scale/zero (E, K/group_size, N), out (E, M, N)), the
// expert is blockIdx.z, and each block first offsets its five pointers by
// its expert's stride (the kExperts instantiation; the single-matrix one
// has no offset arithmetic: with it, that kernel measured ~4% slower on an
// H100).  Past that offset a block runs exactly the arithmetic of a
// single-matrix launch on that expert's operands, so the batched result is
// bit-identical to E separate quant_matmul launches (the reference's
// fused-vs-unrolled contract).  Like the reference, every expert's tiles
// are read even when its capacity rows are all zero.
// The dequantized weight (code - zero) * scale is computed in f32 and rounded
// to bf16 BEFORE the product (the reference's rounding contract); products
// accumulate in f32 and the output is rounded to bf16 once.
//
// What bounds it on an H100: at the prefill shape (M = 512 rows) the product
// is compute-bound (2*M*K*N operations against K*N/ppb weight bytes).  The
// design feeds the tensor cores through WMMA (bf16 16x16x16 fragments, f32
// accumulators): each 256-thread block owns a 128x128 output tile, walks K in
// 32-deep steps, stages the x tile and the freshly dequantized weight tile in
// shared memory, and keeps the accumulators in registers.  Each packed byte
// is read once per block row; the dequantization is redone by every block
// row (M / 128 of them), which is cheap next to the tensor-core work.  There
// is no software pipelining yet (loads and MMAs alternate behind
// __syncthreads), which is what a later PR speeds up (cp.async/TMA ring,
// wgmma).
//
// For the MoE expert products (M = capacity rows, 8..40 on the main path)
// one 128-row tile covers M, so every weight byte is read and dequantized
// once: the batched product is bound by the packed-weight bytes at decode
// and by dequantization work at prefill, not by the tensor cores.
//
// Edges: ragged M and N edges and a K that is not a multiple of the K step
// are masked here (zero-filled tiles, guarded stores), so the wrapper needs
// no padding.  The group row of input row k is k / group_size, which covers
// groups smaller or larger than the K step and per-channel (group_size == K).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int THREADS = 256;      // 8 warps: 4 along M x 2 along N
constexpr int WM = 32;            // warp tile rows (2 fragments)
constexpr int WN = 64;            // warp tile cols (4 fragments)
constexpr int A_LD = BK + 8;      // padded smem row strides (bf16 elements)
constexpr int B_LD = BN + 8;

template <bool kExperts>
__global__ void __launch_bounds__(THREADS)
quant_matmul_kernel(const __nv_bfloat16* __restrict__ x,
                    const uint8_t* __restrict__ packed,
                    const float* __restrict__ scale,
                    const float* __restrict__ zero,
                    __nv_bfloat16* __restrict__ out,
                    int M, int N, int K, int ppb, int group_size, int vec_x) {
  __shared__ __align__(128) __nv_bfloat16 As[BM * A_LD];
  __shared__ __align__(128) __nv_bfloat16 Bs[BK * B_LD];
  __shared__ __align__(128) float Cs[THREADS / 32][16 * 16];

  const int fbits = 8 / ppb;
  const int fmask = (1 << fbits) - 1;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int wm = (warp % 4) * WM;
  const int wn = (warp / 4) * WN;
  const int kp_rows = K / ppb;

  if constexpr (kExperts) {
    // blockIdx.z names the expert
    const size_t ex = blockIdx.z;
    x += ex * (size_t)M * K;
    packed += ex * (size_t)kp_rows * N;
    scale += ex * (size_t)(K / group_size) * N;
    zero += ex * (size_t)(K / group_size) * N;
    out += ex * (size_t)M * N;
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < K; k0 += BK) {
    // x tile (BM x BK) in 8-element chunks
    for (int c = tid; c < BM * (BK / 8); c += THREADS) {
      const int r = c / (BK / 8);
      const int kc = (c % (BK / 8)) * 8;
      const int gm = m0 + r;
      const int gk = k0 + kc;
      __nv_bfloat16* dst = &As[r * A_LD + kc];
      if (vec_x && gm < M && gk + 8 <= K) {
        *reinterpret_cast<uint4*>(dst) =
            *reinterpret_cast<const uint4*>(&x[(size_t)gm * K + gk]);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = (gm < M && gk + e < K) ? x[(size_t)gm * K + gk + e]
                                          : __float2bfloat16(0.0f);
      }
    }
    // dequantized weight tile (BK x BN): one packed byte per step
    const int prow0 = k0 / ppb;
    const int prows = BK / ppb;
    for (int idx = tid; idx < prows * BN; idx += THREADS) {
      const int pr = idx / BN;
      const int n = idx % BN;
      const int gpr = prow0 + pr;
      const int gn = n0 + n;
      const uint32_t byte =
          (gpr < kp_rows && gn < N) ? packed[(size_t)gpr * N + gn] : 0u;
      for (int f = 0; f < ppb; ++f) {
        const int kk = pr * ppb + f;
        const int gk = k0 + kk;
        float w = 0.0f;
        if (gk < K && gn < N) {
          const size_t gi = (size_t)(gk / group_size) * N + gn;
          const float code = (float)((byte >> (f * fbits)) & fmask);
          w = (code - zero[gi]) * scale[gi];
        }
        Bs[kk * B_LD + n] = __float2bfloat16(w);
      }
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> b[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], &As[(wm + i * 16) * A_LD + kk], A_LD);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(b[j], &Bs[kk * B_LD + wn + j * 16], B_LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: each warp stages one 16x16 fragment at a time and stores the
  // in-bounds part as bf16
  float* cs = Cs[warp];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int gm = m0 + wm + i * 16 + e / 16;
        const int gn = n0 + wn + j * 16 + e % 16;
        if (gm < M && gn < N)
          out[(size_t)gm * N + gn] = __float2bfloat16(cs[e]);
      }
      __syncwarp();
    }
  }
}

}  // namespace

namespace {

template <bool kExperts>
int launch(const void* x, const void* packed, const void* scale,
           const void* zero, void* out, int E, int M, int N, int K, int bits,
           int group_size, void* stream) {
  const int ppb = bits == 2 ? 4 : (bits == 8 ? 1 : 2);
  // 16-byte x loads: K % 8 == 0 keeps every row (and every expert's
  // (M, K) slab) 16-byte aligned once the base pointer is
  const int vec_x = (K % 8 == 0) && ((reinterpret_cast<uintptr_t>(x) & 15) == 0);
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, E);
  quant_matmul_kernel<kExperts>
      <<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(packed),
      static_cast<const float*>(scale), static_cast<const float*>(zero),
      static_cast<__nv_bfloat16*>(out), M, N, K, ppb, group_size, vec_x);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int launch_quant_matmul(const void* x, const void* packed,
                                   const void* scale, const void* zero,
                                   void* out, int M, int N, int K, int bits,
                                   int group_size, void* stream) {
  return launch<false>(x, packed, scale, zero, out, 1, M, N, K, bits,
                       group_size, stream);
}

extern "C" int launch_quant_matmul_experts(const void* x, const void* packed,
                                           const void* scale, const void* zero,
                                           void* out, int E, int M, int N,
                                           int K, int bits, int group_size,
                                           void* stream) {
  return launch<true>(x, packed, scale, zero, out, E, M, N, K, bits,
                      group_size, stream);
}
