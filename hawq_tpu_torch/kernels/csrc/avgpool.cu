// A1: the integer 3x3/stride-1/pad-1 average pool of InceptionV3's pool
// branches, with the q_pool_act requant that always follows it.
//
// Replaces hawq_tpu/inference/engine_inception.py int_avgpool_3x3
// (engine_inception.py:336-348, XLA's reduce_window: the TPU package has no
// Pallas kernel for it) and the requant after it (:424-426).  Per output
// element, in the reference's order:
//
//   s   = the int32 sum of the 3x3 window, zero border of 1 (divisor 9
//         always, the border counted);
//   q   = trunc(f32(s) / 9 + 0.01), a true division (__fdiv_rn) and a
//         rounded add; f32(s) is exact, |s| <= 9 * 32767 < 2^24;
//   out = clip(floor(q * mult[c] + 0.5), lo, hi) -> int8, a rounded
//         multiply, then a rounded add (__fmul_rn, __fadd_rn): nvcc would
//         otherwise contract them into an FMA, which rounds once and flips
//         borderline values against the reference.
//
// Input (B, H, W, C) int32 or int16 (the engine's 9-16-bit container), or
// int8 (a config that keeps the pool's input at 8 bits), NHWC; mult a
// float32 scalar (mult_stride 0) or a (C,) vector (1); output (B, H, W, C)
// int8.
//
// Bound on the H100: bytes (each input element read once, one int8 written
// per element; 9 adds and a division per output are far below the card's
// rates).  The design is the simple one: a thread per output pixel and
// 4-channel vector (V = 4: one 16-byte load of int32, 8 bytes of int16, 4
// of int8, per tap), consecutive threads on consecutive vectors of one pixel
// so a warp's loads cover whole lines; the nine reads of an input are
// served by L1/L2.
// Where C % 4 or a pointer is not aligned the wrapper picks V = 1, one
// channel a thread.  32-bit index arithmetic (the wrapper checks the size).
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ Vec<T, V> load_vec(const T* p) {
  Vec<T, V> r;
  if constexpr (sizeof(r) == 16) {
    *reinterpret_cast<uint4*>(&r) = __ldg(reinterpret_cast<const uint4*>(p));
  } else if constexpr (sizeof(r) == 8) {
    *reinterpret_cast<uint2*>(&r) = __ldg(reinterpret_cast<const uint2*>(p));
  } else if constexpr (sizeof(r) == 4) {
    *reinterpret_cast<uint32_t*>(&r) =
        __ldg(reinterpret_cast<const uint32_t*>(p));
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) r.v[e] = __ldg(p + e);
  }
  return r;
}

template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
    avgpool3x3_requant_kernel(const T* __restrict__ x,
                              const float* __restrict__ mult,
                              int8_t* __restrict__ out, int H, int W, int C,
                              int total, int mult_stride, float lo,
                              float hi) {
  const int t = blockIdx.x * THREADS + threadIdx.x;
  if (t >= total) return;
  const int cv = C / V;
  const int c0 = (t % cv) * V;
  const int pix = t / cv;            // (b * H + y) * W + x
  const int px = pix % W;
  const int py = (pix / W) % H;
  int32_t s[V];
#pragma unroll
  for (int e = 0; e < V; ++e) s[e] = 0;
#pragma unroll
  for (int dy = -1; dy <= 1; ++dy) {
    if (py + dy < 0 || py + dy >= H) continue;
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx) {
      if (px + dx < 0 || px + dx >= W) continue;
      const Vec<T, V> a =
          load_vec<T, V>(x + (size_t)(pix + dy * W + dx) * C + c0);
#pragma unroll
      for (int e = 0; e < V; ++e) s[e] += (int32_t)a.v[e];
    }
  }
  int8_t r[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const float q =
        truncf(__fadd_rn(__fdiv_rn(__int2float_rn(s[e]), 9.0f), 0.01f));
    const float m = __ldg(mult + (c0 + e) * mult_stride);
    const float f = __fadd_rn(__fmul_rn(q, m), 0.5f);
    r[e] = (int8_t)fminf(fmaxf(floorf(f), lo), hi);
  }
  int8_t* o = out + (size_t)pix * C + c0;
  if constexpr (V == 4) {
    char4 w;
    w.x = r[0];
    w.y = r[1];
    w.z = r[2];
    w.w = r[3];
    *reinterpret_cast<char4*>(o) = w;
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) o[e] = r[e];
  }
}

template <typename T, int V>
int launch(const void* x, const float* mult, int8_t* out, int B, int H,
           int W, int C, int mult_stride, int lo, int hi,
           cudaStream_t stream) {
  const long long total = (long long)B * H * W * (C / V);
  if (total < 1 || (long long)B * H * W * C > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  const int blocks = (int)((total + THREADS - 1) / THREADS);
  avgpool3x3_requant_kernel<T, V><<<blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(x), mult, out, H, W, C, (int)total, mult_stride,
      (float)lo, (float)hi);
  return (int)cudaGetLastError();
}

}  // namespace

// in_code 0: int16 input, 1: int32, 2: int8; vec 4 (C % 4, x 4*sizeof(T)-
// and out 4-byte aligned) or 1.  Returns cudaGetLastError() after the launch.
extern "C" int hawq_avgpool3x3_requant(const void* x, const float* mult,
                                       int8_t* out, int B, int H, int W,
                                       int C, int in_code, int mult_stride,
                                       int lo, int hi, int vec,
                                       cudaStream_t stream) {
  if (B < 1 || H < 1 || W < 1 || C < 1 || (vec == 4 && C % 4))
    return (int)cudaErrorInvalidValue;
  if (in_code == 1)
    return vec == 4 ? launch<int32_t, 4>(x, mult, out, B, H, W, C,
                                         mult_stride, lo, hi, stream)
                    : launch<int32_t, 1>(x, mult, out, B, H, W, C,
                                         mult_stride, lo, hi, stream);
  if (in_code == 0)
    return vec == 4 ? launch<int16_t, 4>(x, mult, out, B, H, W, C,
                                         mult_stride, lo, hi, stream)
                    : launch<int16_t, 1>(x, mult, out, B, H, W, C,
                                         mult_stride, lo, hi, stream);
  if (in_code == 2)
    return vec == 4 ? launch<int8_t, 4>(x, mult, out, B, H, W, C,
                                        mult_stride, lo, hi, stream)
                    : launch<int8_t, 1>(x, mult, out, B, H, W, C,
                                        mult_stride, lo, hi, stream);
  return (int)cudaErrorInvalidValue;
}
