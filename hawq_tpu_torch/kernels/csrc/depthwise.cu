// Depthwise 3x3 int8 convolution, pad 1, stride 1 or 2, NHWC: per channel c
// the sum over the window of x * w in int32, plus bias[c] ("acc" form); and
// the same accumulator clamped to [0, hi6[c]] (MobileNetV2's ReLU6 on the
// integer side) and requantized to int8, clip(floor(f32(acc) * mult[c] +
// 0.5), lo, hi) ("requant" form).
//
// The TPU package has no Pallas kernel for it: its MobileNetV2 engine runs
// the depthwise conv as XLA's int8 grouped convolution
// (hawq_tpu/inference/engine_mobilenet.py conv_acc, _conv_i8 with groups =
// C) or as nine shifted int32 multiply-adds (_dw_shifted).  CUDA PyTorch has
// no integer convolution, so the port needs a kernel of its own.
//
// Bound on the H100: bytes.  An output takes 9 int8 multiply-adds and no
// tensor core; the input is read once from device memory, the weights (9 x C
// bytes) and the per-channel vectors stay in L1 / L2.  Design:
//
//  * one thread per (output pixel, 16 channels): 16-byte loads of int8, and
//    consecutive lanes on consecutive channel groups of one pixel, so a
//    warp's loads are whole 128-byte lines of a pixel row;
//  * the nine taps are read through L1 / L2 (a stride-1 input is used by
//    nine outputs, neighbours in the warp or the block); the 9 x 16 weights
//    are loaded once into registers;
//  * the zero border is a predicate: a tap outside the image adds nothing,
//    the same as a zero activation (never the dtype minimum);
//  * where C is not a multiple of 16 or a pointer is not 16-byte aligned,
//    the wrapper picks the one-channel form (V = 1) of the same walk (the
//    tiny test models have C = 8);
//  * the requant is hawq::requant_f32 (requant.cuh): a rounded multiply and
//    then a rounded add, never an FMA.
#include <cstdint>

#include <cuda_runtime.h>

#include "requant.cuh"

namespace {

constexpr int THREADS = 256;

// V int8 values of consecutive channels.
template <int V>
struct Chunk;

template <>
struct Chunk<16> {
  uint4 u;
  __device__ __forceinline__ int get(int e) const {   // e constant (unrolled)
    const uint32_t word = e < 4 ? u.x : e < 8 ? u.y : e < 12 ? u.z : u.w;
    return (int)(int8_t)(word >> (8 * (e & 3)));
  }
};

template <>
struct Chunk<1> {
  int8_t v;
  __device__ __forceinline__ int get(int) const { return v; }
};

template <int V>
__device__ __forceinline__ Chunk<V> load_chunk(const int8_t* p) {
  Chunk<V> c;
  if constexpr (V == 16) {
    c.u = __ldg(reinterpret_cast<const uint4*>(p));
  } else {
    c.v = __ldg(p);
  }
  return c;
}

template <typename T>
__device__ __forceinline__ T from_bits(int v);

template <>
__device__ __forceinline__ int32_t from_bits<int32_t>(int v) { return v; }

template <>
__device__ __forceinline__ float from_bits<float>(int v) {
  return __int_as_float(v);
}

// V consecutive 4-byte values (bias, hi6, mult) of channels c0 ..
template <int V, typename T>
__device__ __forceinline__ void load_words(const T* p, T (&r)[V]) {
  if constexpr (V == 16) {           // four 16-byte loads of 4-byte values
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(p) + q);
      r[4 * q] = from_bits<T>(v.x);
      r[4 * q + 1] = from_bits<T>(v.y);
      r[4 * q + 2] = from_bits<T>(v.z);
      r[4 * q + 3] = from_bits<T>(v.w);
    }
  } else {
    r[0] = __ldg(p);
  }
}

// One thread: output pixel (b, oy, ox), channels c0 .. c0 + V - 1.
// total = B * OH * OW * (C / V).
template <int V, bool REQUANT>
__global__ void __launch_bounds__(THREADS)
dwconv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
              const int32_t* __restrict__ bias,
              const int32_t* __restrict__ hi6,
              const float* __restrict__ mult, void* __restrict__ out,
              int total, int H, int W, int C, int OH, int OW, int stride,
              float lo, float hi) {
  const int t = blockIdx.x * THREADS + threadIdx.x;
  if (t >= total) return;
  const int nv = C / V;
  const int c0 = (t % nv) * V;
  const int pix = t / nv;                       // (b * OH + oy) * OW + ox
  const int ox = pix % OW;
  const int boy = pix / OW;
  const int oy = boy % OH;
  const int b = boy / OH;

  int acc[V];
  load_words<V, int32_t>(bias + c0, acc);
  Chunk<V> wt[9];
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) wt[tap] = load_chunk<V>(w + tap * C + c0);

  const int iy0 = oy * stride - 1;
  const int ix0 = ox * stride - 1;
  const int8_t* img = x + (size_t)b * H * W * C + c0;
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    const int iy = iy0 + dy;
    if (iy < 0 || iy >= H) continue;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const int ix = ix0 + dx;
      if (ix < 0 || ix >= W) continue;
      const Chunk<V> xv = load_chunk<V>(img + (iy * W + ix) * C);
#pragma unroll
      for (int e = 0; e < V; ++e)
        acc[e] += xv.get(e) * wt[dy * 3 + dx].get(e);
    }
  }

  if constexpr (!REQUANT) {
    int32_t* o = static_cast<int32_t*>(out) + (size_t)pix * C + c0;
    if constexpr (V == 16) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        reinterpret_cast<int4*>(o)[q] = make_int4(
            acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
    } else {
      o[0] = acc[0];
    }
  } else {
    int32_t top[V];
    float m[V];
    load_words<V, int32_t>(hi6 + c0, top);
    load_words<V, float>(mult + c0, m);
    int8_t q[V];
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const int32_t a = min(max(acc[e], 0), top[e]);     // ReLU6
      q[e] = (int8_t)__float2int_rz(hawq::requant_f32(a, m[e], lo, hi));
    }
    int8_t* o = static_cast<int8_t*>(out) + (size_t)pix * C + c0;
    if constexpr (V == 16) {
      uint32_t words[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        words[k] = (uint32_t)(uint8_t)q[4 * k]
                   | (uint32_t)(uint8_t)q[4 * k + 1] << 8
                   | (uint32_t)(uint8_t)q[4 * k + 2] << 16
                   | (uint32_t)(uint8_t)q[4 * k + 3] << 24;
      *reinterpret_cast<uint4*>(o) =
          make_uint4(words[0], words[1], words[2], words[3]);
    } else {
      o[0] = q[0];
    }
  }
}

template <int V, bool REQUANT>
int launch(const int8_t* x, const int8_t* w, const int32_t* bias,
           const int32_t* hi6, const float* mult, void* out, int B, int H,
           int W, int C, int stride, int lo, int hi, cudaStream_t stream) {
  if (B < 1 || H < 1 || W < 1 || C < 1 || C % V
      || (stride != 1 && stride != 2))
    return (int)cudaErrorInvalidValue;
  const int OH = (H - 1) / stride + 1;
  const int OW = (W - 1) / stride + 1;
  const long long total = (long long)B * OH * OW * (C / V);
  const long long in_elems = (long long)B * H * W * C;
  const long long out_elems = (long long)B * OH * OW * C;
  if (total > INT32_MAX || in_elems > INT32_MAX || out_elems > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  const int blocks = (int)((total + THREADS - 1) / THREADS);
  dwconv_kernel<V, REQUANT><<<blocks, THREADS, 0, stream>>>(
      x, w, bias, hi6, mult, out, (int)total, H, W, C, OH, OW, stride,
      (float)lo, (float)hi);
  return (int)cudaGetLastError();
}

}  // namespace

// x (B, H, W, C) int8, w (3, 3, 1, C) int8 (HWIO, as frozen), bias (C,)
// int32 -> out (B, (H-1)/s+1, (W-1)/s+1, C) int32.  vec: 1 for 16 channels
// a thread (C % 16 == 0, every pointer 16-byte aligned), 0 for one.
extern "C" int hawq_dwconv_acc(const int8_t* x, const int8_t* w,
                               const int32_t* bias, int32_t* out, int B,
                               int H, int W, int C, int stride, int vec,
                               cudaStream_t stream) {
  return vec ? launch<16, false>(x, w, bias, nullptr, nullptr, out, B, H, W,
                                 C, stride, 0, 0, stream)
             : launch<1, false>(x, w, bias, nullptr, nullptr, out, B, H, W,
                                C, stride, 0, 0, stream);
}

// The same accumulator clamped to [0, hi6[c]], then clip(floor(f32(acc) *
// mult[c] + 0.5), lo, hi) -> out int8; hi6 (C,) int32, mult (C,) float32.
extern "C" int hawq_dwconv_requant(const int8_t* x, const int8_t* w,
                                   const int32_t* bias, const int32_t* hi6,
                                   const float* mult, int8_t* out, int B,
                                   int H, int W, int C, int stride, int lo,
                                   int hi, int vec, cudaStream_t stream) {
  return vec ? launch<16, true>(x, w, bias, hi6, mult, out, B, H, W, C,
                                stride, lo, hi, stream)
             : launch<1, true>(x, w, bias, hi6, mult, out, B, H, W, C,
                               stride, lo, hi, stream);
}
