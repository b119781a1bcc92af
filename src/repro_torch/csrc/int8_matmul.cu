// Integer matmul with per-token and per-channel scales, for weight-activation
// quantization (W4A8 / W4A4).
//
// Replaces the Pallas TPU kernel src/repro/kernels/int8_matmul.py
// (int8_matmul -> _i8mm_kernel).  Computes
//   out[m, n] = ((float)sum_k x_q[m, k] * w_q[k, n] * x_scale[m]) * w_scale[n]
// with
//   x_q     (M, K)  int8, row-major with row stride lda >= K (a column slice
//                   of a wider matrix is taken as it is, without a copy)
//   w_q     (K, N)  int8, row-major, contiguous
//   x_scale (M,)    f32 per token;  w_scale (N,) f32 per output channel
//   out     (M, N)  f32 or bf16 (out_f32)
// The int32 accumulator is exact, and the epilogue converts it to f32
// (round to nearest) and multiplies by x_scale, then by w_scale, each
// rounded to nearest: the reference's order.  So the result does not depend
// on the order of the K sum, and it is bit-identical to the plain version
// (kernels/int8_matmul.py::int8_matmul_plain), which accumulates exactly in
// float64.
//
// What bounds it on an H100: at the prefill shape (M = 512) the product is
// bound by operations (2*M*K*N int8 operations against (M + N)*K bytes);
// at decode (M <= 16) by the K*N weight bytes.  The design feeds the int8
// tensor cores through WMMA (signed char 16x16x16 fragments, int32
// accumulators).  A block owns a BM x BN output tile and walks K in 64-byte
// steps; each step's x and w tiles are staged in shared memory in 16-byte
// k-slabs (each fragment reads one contiguous 256-byte slab, 32-byte
// aligned as WMMA requires), and the next step's tiles are loaded into
// registers while the tensor cores work on the current one.  Two tile
// shapes: 128 x 128 (8 warps, 32 x 64 each) for M > 16, and 16 x 64 (4
// warps, one fragment each) for decode-sized M, which puts 4x more blocks
// on the weight stream.  No wgmma, TMA or split-K yet: the speed work of a
// later change.
//
// Edges: ragged M, N and K are masked here (zero-filled tiles, guarded
// stores); 16-byte loads are used where the row stride and base pointer
// allow them, byte loads elsewhere.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BK = 64;            // K bytes per main-loop step
constexpr int KS = 16;            // WMMA fragment depth
constexpr int NSLAB = BK / KS;    // k-slabs per step
constexpr int SLAB_PAD = 32;      // bytes between slabs: fewer bank conflicts
                                  // on the stores, 32-byte aligned slabs

template <int WARPS_M, int WARPS_N, int FM, int FN>
struct Tile {
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  static constexpr int BM = WARPS_M * FM * 16;
  static constexpr int BN = WARPS_N * FN * 16;
  // shared layout: As[k-slab][row][16], Bs[column block of 16][k][16]
  static constexpr int A_SLAB = BM * KS + SLAB_PAD;
  static constexpr int B_SLAB = BK * 16 + SLAB_PAD;
  static constexpr int A_CHUNKS = BM * BK / 16;   // 16-byte chunks per tile
  static constexpr int B_CHUNKS = BK * BN / 16;
  static constexpr int A_PER = (A_CHUNKS + THREADS - 1) / THREADS;
  static constexpr int B_PER = (B_CHUNKS + THREADS - 1) / THREADS;
};

// 16 bytes at p[0..15]; bytes at or past `limit` (and every byte when !ok)
// read as 0.  `vec`: p is 16-byte aligned, so a full chunk is one load.
__device__ __forceinline__ uint4 load_chunk(const int8_t* p, bool ok,
                                            int limit, bool vec) {
  if (ok && vec && limit >= 16) return *reinterpret_cast<const uint4*>(p);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  if (ok) {
#pragma unroll
    for (int e = 0; e < 16; ++e)
      if (e < limit)
        w[e / 4] |= (uint32_t)(uint8_t)p[e] << (8 * (e % 4));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <int WARPS_M, int WARPS_N, int FM, int FN>
__global__ void __launch_bounds__(32 * WARPS_M * WARPS_N)
int8_matmul_kernel(const int8_t* __restrict__ x,
                   const int8_t* __restrict__ w,
                   const float* __restrict__ x_scale,
                   const float* __restrict__ w_scale,
                   void* __restrict__ out,
                   int M, int N, int K, int lda, int out_f32, int vec_a,
                   int vec_b) {
  using T = Tile<WARPS_M, WARPS_N, FM, FN>;
  __shared__ __align__(128) signed char As[NSLAB * T::A_SLAB];
  __shared__ __align__(128) signed char Bs[(T::BN / 16) * T::B_SLAB];
  __shared__ __align__(128) int Cs[WARPS_M * WARPS_N][16 * 16];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int m0 = blockIdx.y * T::BM;
  const int n0 = blockIdx.x * T::BN;
  const int wm = (warp % WARPS_M) * FM * 16;
  const int wn = (warp / WARPS_M) * FN * 16;

  uint4 a_reg[T::A_PER];
  uint4 b_reg[T::B_PER];

  // chunk c of the A tile: row c / NSLAB, k-slab c % NSLAB; of the B tile:
  // k row c / (BN/16), column block c % (BN/16)
  auto load_tiles = [&](int k0) {
#pragma unroll
    for (int i = 0; i < T::A_PER; ++i) {
      const int c = tid + i * T::THREADS;
      if (c < T::A_CHUNKS) {
        const int r = c / NSLAB;
        const int gk = k0 + (c % NSLAB) * KS;
        a_reg[i] = load_chunk(x + (size_t)(m0 + r) * lda + gk, m0 + r < M,
                              K - gk, vec_a);
      }
    }
#pragma unroll
    for (int i = 0; i < T::B_PER; ++i) {
      const int c = tid + i * T::THREADS;
      if (c < T::B_CHUNKS) {
        const int kr = c / (T::BN / 16);
        const int gn = n0 + (c % (T::BN / 16)) * 16;
        b_reg[i] = load_chunk(w + (size_t)(k0 + kr) * N + gn, k0 + kr < K,
                              N - gn, vec_b);
      }
    }
  };
  auto store_tiles = [&]() {
#pragma unroll
    for (int i = 0; i < T::A_PER; ++i) {
      const int c = tid + i * T::THREADS;
      if (c < T::A_CHUNKS)
        *reinterpret_cast<uint4*>(
            &As[(c % NSLAB) * T::A_SLAB + (c / NSLAB) * KS]) = a_reg[i];
    }
#pragma unroll
    for (int i = 0; i < T::B_PER; ++i) {
      const int c = tid + i * T::THREADS;
      if (c < T::B_CHUNKS)
        *reinterpret_cast<uint4*>(
            &Bs[(c % (T::BN / 16)) * T::B_SLAB + (c / (T::BN / 16)) * 16]) =
            b_reg[i];
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0);

  if (K > 0) load_tiles(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
    store_tiles();
    __syncthreads();
    if (k0 + BK < K) load_tiles(k0 + BK);   // in flight during the MMAs
#pragma unroll
    for (int s = 0; s < NSLAB; ++s) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char,
                     wmma::row_major> a[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char,
                     wmma::row_major> b[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(a[i], &As[s * T::A_SLAB + (wm + i * 16) * KS],
                               KS);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(
            b[j], &Bs[((wn + j * 16) / 16) * T::B_SLAB + s * KS * 16], 16);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: each warp stages one 16x16 fragment at a time and writes the
  // in-bounds part, (float(acc) * x_scale) * w_scale, rounded to nearest
  int* cs = Cs[warp];
#pragma unroll
  for (int i = 0; i < FM; ++i) {
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int gm = m0 + wm + i * 16 + e / 16;
        const int gn = n0 + wn + j * 16 + e % 16;
        if (gm < M && gn < N) {
          float v = __int2float_rn(cs[e]);
          v = __fmul_rn(v, x_scale[gm]);
          v = __fmul_rn(v, w_scale[gn]);
          const size_t o = (size_t)gm * N + gn;
          if (out_f32)
            static_cast<float*>(out)[o] = v;
          else
            static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(v);
        }
      }
      __syncwarp();
    }
  }
}

template <int WARPS_M, int WARPS_N, int FM, int FN>
int launch(const void* x, const void* w, const void* x_scale,
           const void* w_scale, void* out, int M, int N, int K, int lda,
           int out_f32, void* stream) {
  using T = Tile<WARPS_M, WARPS_N, FM, FN>;
  const int vec_a =
      (lda % 16 == 0) && ((reinterpret_cast<uintptr_t>(x) & 15) == 0);
  const int vec_b =
      (N % 16 == 0) && ((reinterpret_cast<uintptr_t>(w) & 15) == 0);
  dim3 grid((N + T::BN - 1) / T::BN, (M + T::BM - 1) / T::BM);
  int8_matmul_kernel<WARPS_M, WARPS_N, FM, FN>
      <<<grid, T::THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
          static_cast<const float*>(x_scale),
          static_cast<const float*>(w_scale), out, M, N, K, lda, out_f32,
          vec_a, vec_b);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int launch_int8_matmul(const void* x, const void* w,
                                  const void* x_scale, const void* w_scale,
                                  void* out, int M, int N, int K, int lda,
                                  int out_f32, void* stream) {
  if (M <= 16)
    return launch<1, 4, 1, 1>(x, w, x_scale, w_scale, out, M, N, K, lda,
                              out_f32, stream);
  return launch<4, 2, 2, 4>(x, w, x_scale, w_scale, out, M, N, K, lda,
                            out_f32, stream);
}
