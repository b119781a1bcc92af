// TesseraQ soft-weight materialization (paper Eq. 4 + Eq. 9) and its
// gradient, for the Soften phase of progressive adaptive rounding.
//
// Replaces the Pallas TPU kernel src/repro/kernels/soft_round.py
// (soft_round -> _soft_round_kernel), which has a forward only; the
// backward here is what the reference obtains from jax.grad of the same
// function.  Layout: grouped (ng, g, n) for base, nu, hard and the output,
// (ng, n) for v, scale and zero, all row-major.
//
//   alpha = hard == 0 ? sigmoid(nu) : (hard > 0 ? 1 : 0)
//   u     = base + zero + alpha
//   q     = clip(u, 0, qmax)
//   s_eff = dst ? scale * 2 sigmoid(v) : scale
//   out   = (q - zero) * s_eff
//
// Backward, given dout (ng, g, n):
//   dnu = dout * s_eff * clip'(u) * sigmoid'(nu) * [hard == 0]
//   dv  = sum over the g rows of dout * (q - zero), times
//         scale * 2 sigmoid'(v)                          (dst only)
// clip'(u) is 1 strictly inside (0, qmax), 0 outside, and 1/2 at u == 0 and
// u == qmax: jnp.clip is max/min, whose gradient splits a tie evenly.
//
// What bounds it on an H100: bytes.  The forward reads 13 bytes per
// element (base, nu f32, hard int8) and writes 4; the per-group v/scale/zero
// are 1/g of that.  The backward reads 17 and writes 4.  Neither does more
// than ~20 operations per element, far below the card's ~20 operations per
// byte, so the design only keeps loads coalesced and in flight:
//   * forward: a flat grid-stride loop; when n % 4 == 0 and the pointers are
//     16-byte aligned each thread moves 4 consecutive columns with 16-byte
//     loads (4-byte loads for hard);
//   * backward: a block owns 32 columns of one group and 8 row slices; warp
//     y reads rows y, y+8, ... of those 32 columns (128-byte coalesced rows),
//     writes dnu directly and keeps a per-column partial of dv in a
//     register.  The 8 partials are summed in shared memory in slice order
//     by one thread per column: no atomics, so repeated runs are bit-for-bit
//     identical.
// Ragged n is masked inside the kernels; the reference's (8, 512) block
// alignment requirement does not exist here.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int FWD_THREADS = 256;
constexpr int BWD_COLS = 32;
constexpr int BWD_SLICES = 8;

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ float soft_alpha(float nu, int8_t hard) {
  return hard == 0 ? sigmoid_f(nu) : (hard > 0 ? 1.0f : 0.0f);
}

template <int V>
__global__ void __launch_bounds__(FWD_THREADS)
soft_round_fwd_kernel(const float* __restrict__ base,
                      const float* __restrict__ nu,
                      const int8_t* __restrict__ hard,
                      const float* __restrict__ v,
                      const float* __restrict__ scale,
                      const float* __restrict__ zero,
                      float* __restrict__ out, long long n_vec, int g, int n,
                      float qmax, int dst) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long gn = static_cast<long long>(g) * n;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       t < n_vec; t += stride) {
    const long long e = t * V;
    const long long grp = e / gn;
    const int col = static_cast<int>(e % n);
    const long long gi = grp * n + col;
    float b[V], w[V], s[V], z[V], vv[V];
    int8_t h[V];
    if constexpr (V == 4) {
      const float4 b4 = *reinterpret_cast<const float4*>(base + e);
      const float4 w4 = *reinterpret_cast<const float4*>(nu + e);
      const char4 h4 = *reinterpret_cast<const char4*>(hard + e);
      const float4 s4 = *reinterpret_cast<const float4*>(scale + gi);
      const float4 z4 = *reinterpret_cast<const float4*>(zero + gi);
      b[0] = b4.x; b[1] = b4.y; b[2] = b4.z; b[3] = b4.w;
      w[0] = w4.x; w[1] = w4.y; w[2] = w4.z; w[3] = w4.w;
      h[0] = h4.x; h[1] = h4.y; h[2] = h4.z; h[3] = h4.w;
      s[0] = s4.x; s[1] = s4.y; s[2] = s4.z; s[3] = s4.w;
      z[0] = z4.x; z[1] = z4.y; z[2] = z4.z; z[3] = z4.w;
      if (dst) {
        const float4 v4 = *reinterpret_cast<const float4*>(v + gi);
        vv[0] = v4.x; vv[1] = v4.y; vv[2] = v4.z; vv[3] = v4.w;
      }
    } else {
      b[0] = base[e]; w[0] = nu[e]; h[0] = hard[e];
      s[0] = scale[gi]; z[0] = zero[gi];
      if (dst) vv[0] = v[gi];
    }
    float o[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float a = soft_alpha(w[k], h[k]);
      const float q = fminf(fmaxf(b[k] + z[k] + a, 0.0f), qmax);
      const float se = dst ? s[k] * (2.0f * sigmoid_f(vv[k])) : s[k];
      o[k] = (q - z[k]) * se;
    }
    if constexpr (V == 4) {
      *reinterpret_cast<float4*>(out + e) = make_float4(o[0], o[1], o[2],
                                                        o[3]);
    } else {
      out[e] = o[0];
    }
  }
}

__global__ void __launch_bounds__(BWD_COLS * BWD_SLICES)
soft_round_bwd_kernel(const float* __restrict__ dout,
                      const float* __restrict__ base,
                      const float* __restrict__ nu,
                      const int8_t* __restrict__ hard,
                      const float* __restrict__ v,
                      const float* __restrict__ scale,
                      const float* __restrict__ zero,
                      float* __restrict__ dnu, float* __restrict__ dv,
                      int g, int n, float qmax, int dst) {
  __shared__ float part[BWD_SLICES][BWD_COLS];
  const int lane = threadIdx.x;            // column within the block
  const int slice = threadIdx.y;           // row slice
  const int col = blockIdx.x * BWD_COLS + lane;
  const long long grp = blockIdx.y;
  const bool live = col < n;
  float acc = 0.0f;
  if (live) {
    const long long gi = grp * n + col;
    const float s = scale[gi];
    const float z = zero[gi];
    const float se = dst ? s * (2.0f * sigmoid_f(v[gi])) : s;
    const long long row0 = grp * g;
#pragma unroll 4
    for (int r = slice; r < g; r += BWD_SLICES) {
      const long long e = (row0 + r) * n + col;
      const float d = dout[e];
      const float w = nu[e];
      const int8_t h = hard[e];
      const float a = soft_alpha(w, h);
      const float u = base[e] + z + a;
      const float q = fminf(fmaxf(u, 0.0f), qmax);
      const float cg = (u > 0.0f && u < qmax)
                           ? 1.0f
                           : ((u == 0.0f || u == qmax) ? 0.5f : 0.0f);
      const float dsig = h == 0 ? a * (1.0f - a) : 0.0f;
      dnu[e] = ((d * se) * cg) * dsig;
      acc += d * (q - z);
    }
  }
  if (!dst) return;
  part[slice][lane] = acc;
  __syncthreads();
  if (slice == 0 && live) {
    float tot = 0.0f;
#pragma unroll
    for (int k = 0; k < BWD_SLICES; ++k) tot += part[k][lane];
    const long long gi = grp * n + col;
    const float sv = sigmoid_f(v[gi]);
    dv[gi] = ((tot * scale[gi]) * 2.0f) * (sv * (1.0f - sv));
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" int soft_round_fwd(const void* base, const void* nu,
                              const void* hard, const void* v,
                              const void* scale, const void* zero, void* out,
                              int ng, int g, int n, int qmax, int dst,
                              void* stream) {
  if (ng < 1 || g < 1 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long total = static_cast<long long>(ng) * g * n;
  const bool vec = n % 4 == 0 && aligned16(base) && aligned16(nu) &&
                   aligned16(out) && aligned16(scale) && aligned16(zero) &&
                   (!dst || aligned16(v)) &&
                   (reinterpret_cast<uintptr_t>(hard) & 3) == 0;
  const long long n_vec = vec ? total / 4 : total;
  long long blocks = (n_vec + FWD_THREADS - 1) / FWD_THREADS;
  if (blocks > 132 * 32) blocks = 132 * 32;
  auto st = static_cast<cudaStream_t>(stream);
  auto bp = static_cast<const float*>(base);
  auto np_ = static_cast<const float*>(nu);
  auto hp = static_cast<const int8_t*>(hard);
  auto vp = static_cast<const float*>(v);
  auto sp = static_cast<const float*>(scale);
  auto zp = static_cast<const float*>(zero);
  auto op = static_cast<float*>(out);
  const float qm = static_cast<float>(qmax);
  const unsigned nb = static_cast<unsigned>(blocks);
  if (vec)
    soft_round_fwd_kernel<4><<<nb, FWD_THREADS, 0, st>>>(
        bp, np_, hp, vp, sp, zp, op, n_vec, g, n, qm, dst);
  else
    soft_round_fwd_kernel<1><<<nb, FWD_THREADS, 0, st>>>(
        bp, np_, hp, vp, sp, zp, op, n_vec, g, n, qm, dst);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int soft_round_bwd(const void* dout, const void* base,
                              const void* nu, const void* hard, const void* v,
                              const void* scale, const void* zero, void* dnu,
                              void* dv, int ng, int g, int n, int qmax,
                              int dst, void* stream) {
  if (ng < 1 || g < 1 || n < 1 || ng > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + BWD_COLS - 1) / BWD_COLS, ng);
  const dim3 block(BWD_COLS, BWD_SLICES);
  soft_round_bwd_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dout), static_cast<const float*>(base),
      static_cast<const float*>(nu), static_cast<const int8_t*>(hard),
      static_cast<const float*>(v), static_cast<const float*>(scale),
      static_cast<const float*>(zero), static_cast<float*>(dnu),
      static_cast<float*>(dv), g, n, static_cast<float>(qmax), dst);
  return static_cast<int>(cudaGetLastError());
}
