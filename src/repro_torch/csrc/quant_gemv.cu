// Decode-shaped fused dequantization + GEMV (M <= 32 activation rows).
//
// Replaces the Pallas TPU kernel src/repro/kernels/quant_gemv.py
// (quant_gemv -> _gemv_kernel).  Same function as quant_matmul.cu:
//   out (M, N) bf16 = x (M, K) bf16 @ dequant(packed (K/ppb, N) uint8,
//                                             scale/zero (K/g, N) f32)
// with the dequantized weight rounded to bf16 before the product and f32
// accumulation.  M is the live decode-slot count and is never padded.
//
// What bounds it on an H100: memory.  At M = 4 the kernel does 2*M
// operations per weight and reads 1/ppb byte per weight, far below the
// card's ~295 operations per byte, so the packed-code stream (plus the f32
// scale/zero rows) is the whole cost.  Design for that stream:
//   * each block owns 128 output columns; lane l of every warp takes columns
//     4l..4l+3 and loads their packed bytes as one 32-bit word, so a warp
//     reads 128 consecutive bytes of a packed row (coalesced);
//   * the 8 warps of a block split the packed rows of each K chunk, so 8
//     rows are in flight per block; their partial sums meet in shared memory
//     at the end, added in a fixed warp order (deterministic);
//   * x is staged in 256-row K chunks in shared memory as f32 (up to 32
//     rows, 32 KB), read back as broadcasts;
//   * M*4 f32 accumulators per thread live in registers (the row count is a
//     template parameter, so the loops unroll);
//   * scale/zero are reloaded only when a thread's K walk crosses a group.
// Occupancy is the known weakness: one block per 128-column tile gives only
// 32-86 blocks at N = 4096-11008 on 132 SMs, too few loads in flight to
// reach the memory rate.  Splitting K across blocks (with a fixed-order
// second-pass reduction) is the first thing a later PR fixes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int GV_THREADS = 256;
constexpr int GV_WARPS = GV_THREADS / 32;
constexpr int GV_BN = 128;   // 32 lanes x 4 columns
constexpr int GV_KC = 256;   // x rows staged per chunk

template <int MT, int PPB>
__global__ void __launch_bounds__(GV_THREADS)
quant_gemv_kernel(const __nv_bfloat16* __restrict__ x,
                  const uint8_t* __restrict__ packed,
                  const float* __restrict__ scale,
                  const float* __restrict__ zero,
                  __nv_bfloat16* __restrict__ out,
                  int M, int N, int K, int group_size, int vec) {
  constexpr int FBITS = 8 / PPB;
  constexpr int FMASK = (1 << FBITS) - 1;
  __shared__ float xs[MT][GV_KC];
  __shared__ float red[GV_WARPS][GV_BN];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n0 = blockIdx.x * GV_BN + lane * 4;

  float acc[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0.0f;
  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float z[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  int g_next = 0;  // first input row of the next group along this warp's walk

  for (int k0 = 0; k0 < K; k0 += GV_KC) {
    const int kc = min(GV_KC, K - k0);
    __syncthreads();
    for (int i = threadIdx.x; i < MT * GV_KC; i += GV_THREADS) {
      const int m = i / GV_KC;
      const int k = i % GV_KC;
      xs[m][k] = (m < M && k < kc)
                     ? __bfloat162float(x[(size_t)m * K + k0 + k])
                     : 0.0f;
    }
    __syncthreads();
    const int prows = kc / PPB;
#pragma unroll 4
    for (int pr = warp; pr < prows; pr += GV_WARPS) {
      const size_t row = (size_t)(k0 / PPB + pr) * N;
      uint32_t word = 0u;
      if (vec) {
        if (n0 < N)
          word = __ldg(reinterpret_cast<const unsigned int*>(packed + row + n0));
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (n0 + c < N) word |= (uint32_t)packed[row + n0 + c] << (8 * c);
      }
#pragma unroll
      for (int f = 0; f < PPB; ++f) {
        const int k = pr * PPB + f;
        const int gk = k0 + k;
        if (gk >= g_next) {
          const int g = gk / group_size;
          g_next = (g + 1) * group_size;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int n = n0 + c;
            s[c] = n < N ? scale[(size_t)g * N + n] : 0.0f;
            z[c] = n < N ? zero[(size_t)g * N + n] : 0.0f;
          }
        }
        float w[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float code = (float)((word >> (8 * c + f * FBITS)) & FMASK);
          w[c] = __bfloat162float(__float2bfloat16((code - z[c]) * s[c]));
        }
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const float xv = xs[m][k];
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[m][c] = fmaf(xv, w[c], acc[m][c]);
        }
      }
    }
  }

  // fixed-order reduction of the 8 warps' partial sums, one row at a time
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    __syncthreads();
#pragma unroll
    for (int c = 0; c < 4; ++c) red[warp][lane * 4 + c] = acc[m][c];
    __syncthreads();
    if (m < M && threadIdx.x < GV_BN) {
      const int n = blockIdx.x * GV_BN + threadIdx.x;
      float sum = 0.0f;
#pragma unroll
      for (int w = 0; w < GV_WARPS; ++w) sum += red[w][threadIdx.x];
      if (n < N) out[(size_t)m * N + n] = __float2bfloat16(sum);
    }
  }
}

template <int PPB>
cudaError_t launch_rows(const __nv_bfloat16* x, const uint8_t* packed,
                        const float* scale, const float* zero,
                        __nv_bfloat16* out, int M, int N, int K,
                        int group_size, int vec, cudaStream_t stream) {
  dim3 grid((N + GV_BN - 1) / GV_BN);
#define GV_LAUNCH(MT)                                                      \
  quant_gemv_kernel<MT, PPB><<<grid, GV_THREADS, 0, stream>>>(             \
      x, packed, scale, zero, out, M, N, K, group_size, vec)
  if (M <= 1) GV_LAUNCH(1);
  else if (M <= 2) GV_LAUNCH(2);
  else if (M <= 4) GV_LAUNCH(4);
  else if (M <= 8) GV_LAUNCH(8);
  else if (M <= 16) GV_LAUNCH(16);
  else GV_LAUNCH(32);
#undef GV_LAUNCH
  return cudaGetLastError();
}

}  // namespace

extern "C" int launch_quant_gemv(const void* x, const void* packed,
                                 const void* scale, const void* zero,
                                 void* out, int M, int N, int K, int bits,
                                 int group_size, void* stream) {
  if (M < 1 || M > 32) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = (N % 4 == 0) &&
                  ((reinterpret_cast<uintptr_t>(packed) & 3) == 0);
  auto xp = static_cast<const __nv_bfloat16*>(x);
  auto pp = static_cast<const uint8_t*>(packed);
  auto sp = static_cast<const float*>(scale);
  auto zp = static_cast<const float*>(zero);
  auto op = static_cast<__nv_bfloat16*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bits == 2)
    err = launch_rows<4>(xp, pp, sp, zp, op, M, N, K, group_size, vec, st);
  else if (bits == 8)
    err = launch_rows<1>(xp, pp, sp, zp, op, M, N, K, group_size, vec, st);
  else
    err = launch_rows<2>(xp, pp, sp, zp, op, M, N, K, group_size, vec, st);
  return static_cast<int>(err);
}
