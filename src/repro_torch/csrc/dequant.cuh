// Dequantization helpers shared by quant_matmul.cu and quant_gemv.cu.
//
// Both kernels build the dequantized weight straight into the A register
// fragment of a tensor-core MMA (wgmma .rs or mma.sync m16n8k16), two
// adjacent output columns per thread, with the rounding contract of the
// plain version: (code - zero) in f32 (exact), one f32 multiply by scale,
// one rounding to bf16.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float code_f(uint32_t bits) {
  return __uint_as_float(bits | 0x4B000000u);  // 2^23 + bits, exactly
}

// w = (code - z) * s for the two codes of a pair; cf holds 2^23 + code.
// With an integral z, 2^23 + z is exact and one subtraction gives code - z
// exactly, as the plain two-step form does.
__device__ __forceinline__ uint32_t dequant_pair(float cf0, float cf1,
                                                 float s, float z, float zp,
                                                 bool zint) {
  float d0, d1;
  if (zint) {
    d0 = __fsub_rn(cf0, zp);
    d1 = __fsub_rn(cf1, zp);
  } else {
    d0 = __fsub_rn(__fsub_rn(cf0, 8388608.0f), z);
    d1 = __fsub_rn(__fsub_rn(cf1, 8388608.0f), z);
  }
  return pack_bf16x2(__fmul_rn(d0, s), __fmul_rn(d1, s));
}

// Scale and zero of a thread's two columns for one group, with what the
// integral-zero shortcut needs; at 2 bits (PPB == 4) also each column's four
// weights as bf16 (lut[i][0] = w(0) | w(1) << 16, lut[i][1] = w(2) | w(3)
// << 16), with dequant_pair's arithmetic.
template <int PPB>
struct GroupConst {
  float2 s, z;
  float zp0, zp1;  // 2^23 + z
  bool zint;       // both zeros integral and |z| < 2^22
  uint32_t lut[2][2];
};

template <int PPB>
__device__ __forceinline__ GroupConst<PPB> make_group_const(float2 s,
                                                            float2 z) {
  GroupConst<PPB> g;
  g.s = s;
  g.z = z;
  g.zint = z.x == rintf(z.x) && z.y == rintf(z.y) &&
           fabsf(z.x) < 4194304.0f && fabsf(z.y) < 4194304.0f;
  g.zp0 = __fadd_rn(z.x, 8388608.0f);
  g.zp1 = __fadd_rn(z.y, 8388608.0f);
  if constexpr (PPB == 4) {
    // c - z rounded once: what either path of dequant_pair gives (exact
    // for an integral z), without the integral-zero test
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float sc = i ? s.y : s.x, zc = i ? z.y : z.x;
        g.lut[i][h] =
            pack_bf16x2(__fmul_rn(__fsub_rn((float)(2 * h), zc), sc),
                        __fmul_rn(__fsub_rn((float)(2 * h + 1), zc), sc));
      }
  }
  return g;
}

}  // namespace
