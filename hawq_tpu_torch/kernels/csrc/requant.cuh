// The dyadic requant of one int32 value, shared by the GEMM epilogues
// (requant_s8), the pool's requant-in-front form (pool.cu) and
// the engines' standalone requant (requant.cu):
//
//   clip(floor(f32(v) * mult + 0.5), lo, hi)
//
// with a rounded multiply and then a rounded add (__fmul_rn, __fadd_rn):
// nvcc (--fmad=true) would otherwise contract them into one FMA, which
// rounds once and flips borderline values against the reference.  The
// result is an integer-valued float in [lo, hi].
//
// The residual requant-add of a bottleneck (the Hopper core's RESIDUAL
// epilogue) rounds both branches so, adds them in float32 (rounded, as
// quant/ops.py requant_add_int32 adds: above 2^24 an int add would differ)
// and casts the sum to int32 before the ReLU.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace hawq {

// floor(f32(v) * mult + 0.5), unclipped
__device__ __forceinline__ float round_mult_f32(int32_t v, float mult) {
  return floorf(__fadd_rn(__fmul_rn(__int2float_rn(v), mult), 0.5f));
}

__device__ __forceinline__ float requant_f32(int32_t v, float mult, float lo,
                                             float hi) {
  return fminf(fmaxf(round_mult_f32(v, mult), lo), hi);
}

// clip(floor(f32(v) * mult + 0.5), lo, hi) as int8: the GEMM core's requant
// epilogue
__device__ __forceinline__ int8_t requant_s8(int32_t v, float mult, int lo,
                                            int hi) {
  return (int8_t)__float2int_rz(requant_f32(v, mult, (float)lo, (float)hi));
}

// max(int32(round(v, mult) + round(id, mult_id)), 0)
__device__ __forceinline__ int32_t requant_add_relu(int32_t v, float mult,
                                                    int32_t id, float mult_id) {
  return max(__float2int_rz(__fadd_rn(round_mult_f32(v, mult),
                                      round_mult_f32(id, mult_id))), 0);
}

}  // namespace hawq
