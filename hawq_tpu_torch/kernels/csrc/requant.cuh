// The dyadic requant of one int32 value, shared by the GEMM epilogues
// (gemm_s8.cuh requant_s8) and the pool's requant-in-front form (pool.cu):
//
//   clip(floor(f32(v) * mult + 0.5), lo, hi)
//
// with a rounded multiply and then a rounded add (__fmul_rn, __fadd_rn):
// nvcc (--fmad=true) would otherwise contract them into one FMA, which
// rounds once and flips borderline values against the reference.  The
// result is an integer-valued float in [lo, hi].
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace hawq {

__device__ __forceinline__ float requant_f32(int32_t v, float mult, float lo,
                                             float hi) {
  const float f = __fadd_rn(__fmul_rn(__int2float_rn(v), mult), 0.5f);
  return fminf(fmaxf(floorf(f), lo), hi);
}

}  // namespace hawq
