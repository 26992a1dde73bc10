// A1: the integer 3x3/stride-1/pad-1 average pool of InceptionV3's pool
// branches, with the q_pool_act requant that always follows it and, where
// the caller passes in_mult, the branch's q_input_act requant in front.
//
// Replaces hawq_tpu/inference/engine_inception.py int_avgpool_3x3
// (engine_inception.py:336-348, XLA's reduce_window: the TPU package has no
// Pallas kernel for it), the requant after it (:424-426) and, fused, the
// requant in front of it (:410-411).  Per element, in the reference's
// order:
//
//   h   = clip(floor(f32(x) * in_mult[c] + 0.5), in_lo, in_hi), the
//         requant in front (h = x without in_mult);
//   s   = the int32 sum of the 3x3 window of h, zero border of 1 (divisor
//         9 always, the border counted; requant(0) = 0, so the border of
//         the requantized tensor is zero too);
//   q   = trunc(f32(s) / 9 + 0.01), a true division (__fdiv_rn) and a
//         rounded add;
//   out = clip(floor(q * mult[c] + 0.5), lo, hi) -> int8.
//
// Both requants are a rounded multiply and then a rounded add (__fmul_rn,
// __fadd_rn): nvcc would otherwise contract them into an FMA, which rounds
// once and flips borderline values against the reference.  The clip comes
// before the floor here; the bounds are integers, so that is the same
// value, and it keeps |f| < 2^22, where floor is one add rounded down onto
// 1.5 * 2^23 (floor_small) and a small integer converts to float exactly by
// the same constant (float_small), adds in place of the float-to-integer
// conversions and roundings, which run on a slower pipe.  Where |s| < 9 * 2^16 (a requant in
// front to at most 16 bits, or 16- and 8-bit inputs) q is s / 9 toward
// zero, one more for a negative multiple of 9: below 2^16 a float32 has 8
// fraction bits, so fl(s / 9) lies within 2^-9 of s / 9, whose fraction is
// 0 or at least 1/9 away from the next integer, and the + 0.01 moves trunc
// only where s / 9 is a negative integer.  The kernel takes it as
// trunc((s + [s < 0]) / 9) with a multiply by fl(1/9) and a floor
// (pool_quotient; tests/test_torch_avgpool_walk.py holds it equal to the
// division at every such s).  An int32 input without the requant in front
// keeps the division.
//
// Input (B, H, W, C) int32 or int16 (the engine's 9-16-bit container), or
// int8, NHWC; in_mult and mult float32 scalars (stride 0) or (C,) vectors
// (stride 1); output (B, H, W, C) int8.
//
// Bound on the H100: bytes, each input element read once and one int8
// written per element (16.0 M elements x 5 bytes at InceptionV3 b8 299^2
// on the int32 container: 0.0239 ms).  The first design (a thread per
// output pixel and 4-channel word, nine 16-byte reads per output through
// L1/L2) ran at 28 % of it, with its times in L2 and streamed from
// device memory within 3 %.  At these sizes a call lasts a few
// microseconds: a launch, then each block's staging and its arithmetic
// one after the other, with the tiles about one wave of resident blocks.
// Blocks that walked two or four tiles each, their next tile's copies in
// flight while they summed the current one, were slower on the card (fewer
// warps to hide the arithmetic's latency), and so were tiles staged in
// chunks of rows, a barrier each (PERF.md §6).  This design:
//
//  * a tile is `th` output rows x `tw` columns of one image x a slab of
//    `cs` channel units (V = 4 channels, one 16-byte int32 word, or V = 1),
//    one a block.  The block stages it with its one-pixel halo in shared
//    memory once: cp.async copies of 16 bytes (one word of int32, two of
//    int16, four of int8; one word where C or the pointer allows no more),
//    consecutive threads on consecutive copies of a pixel's channels, the
//    border zero-filled by the copy (source size 0);
//  * the requant in front, and the widening of 16- and 8-bit inputs to
//    int32, is applied once per staged element: each thread converts the
//    copies it issued once they have landed (in place for int32, from a raw
//    region after the tile otherwise).  Halo elements are converted by
//    each block that stages them, the same way;
//  * a thread owns one output column of the tile and one channel unit, and
//    walks down the column: one row 3-sum per staged row (three
//    shared-memory reads, lanes on consecutive words: no bank conflict) and
//    a 3-row window slid down the column, th outputs a thread, each output
//    two more adds; integer sums are exact in any order;
//  * the tile rule is on the host (kernels/avgpool.py avgpool_plan), which
//    also walks this kernel's tiles in torch (avgpool_walk_plain).
// One channel a thread (V = 1: C % 4, or x not aligned to a word) stages
// through registers, one element a load.
//
// The quotient form (hawq_avgpool3x3, kernels/avgpool.py int_avgpool3x3)
// is the same kernel with both requants compiled out (OUT_RQ false): it
// writes q as int32, the exact counterpart of engine_inception.py
// int_avgpool_3x3 (XLA's reduce_window and the truncating division), for
// the reference-checkpoint replay, which requantizes around it in float64.
// Its bound is bytes too: the input read once, four bytes written per
// element.
#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int MAX_THREADS = 512;
constexpr int MAX_SMEM = 96 * 1024;
constexpr float MAGIC = 12582912.0f;      // 1.5 * 2^23
constexpr int MAGIC_BITS = 0x4B400000;    // its bits

struct Tile {
  int B, H, W, C;
  int cs, tw, th;          // channel units, output columns and rows a tile
  int tiles_y;             // row tiles of an image
  int rows_in, cols_in;    // the staged rectangle: th + 2, tw + 2
  int raw_words;           // the raw region's offset (16- and 8-bit input)
  int in_stride, mult_stride;
  float in_lo, in_hi, lo, hi;
};

// floor(f) for |f| < 2^22: 1.5 * 2^23 + f rounded down is 1.5 * 2^23 +
// floor(f) exactly (the sum's ulp is 1), and its low mantissa bits hold it
__device__ __forceinline__ int floor_small(float f) {
  return __float_as_int(__fadd_rd(f, MAGIC)) - MAGIC_BITS;
}

// f32(v) for |v| < 2^22, exact
__device__ __forceinline__ float float_small(int v) {
  return __fsub_rn(__int_as_float(v + MAGIC_BITS), MAGIC);
}

template <typename T>
__device__ __forceinline__ float to_f32(T v) {
  if constexpr (sizeof(T) == 4) return __int2float_rn(v);
  else return float_small((int)v);
}

// the requant in front: clip(floor(f32(v) * m + 0.5), lo, hi)
template <typename T>
__device__ __forceinline__ int32_t requant_in(T v, float m, float lo,
                                              float hi) {
  const float f = __fadd_rn(__fmul_rn(to_f32(v), m), 0.5f);
  return floor_small(fminf(fmaxf(f, lo), hi));
}

// q = trunc(f32(s) / 9 + 0.01).  BOUNDED (|s| < 9 * 2^16): s / 9 toward
// zero, one more for a negative multiple of 9, which is trunc(x / 9) of x =
// s + [s < 0]; |x| * fl(1/9) rounded has floor |x| / 9's floor (fl(1/9) >
// 1/9, and the product's errors stay under 2^-7, less than the 1/9 by which
// a fraction of |x| / 9 misses the next integer), and the sign is y's
template <bool BOUNDED>
__device__ __forceinline__ float pool_quotient(int32_t s) {
  if constexpr (BOUNDED) {
    const float y = __fmul_rn(float_small(s - (s >> 31)), 1.0f / 9.0f);
    return copysignf(__fsub_rn(__fadd_rd(fabsf(y), MAGIC), MAGIC), y);
  } else {
    return truncf(__fadd_rn(__fdiv_rn(__int2float_rn(s), 9.0f), 0.01f));
  }
}

// the requant after: clip(floor(q * m + 0.5), lo, hi), its low byte
__device__ __forceinline__ uint32_t requant_out(float q, float m, float lo,
                                                float hi) {
  const float f = __fadd_rn(__fmul_rn(q, m), 0.5f);
  return (uint32_t)floor_small(fminf(fmaxf(f, lo), hi)) & 0xFFu;
}

// ---- copies into shared memory (cp.async, zero-filled outside the image)
template <int BYTES>
__device__ __forceinline__ void copy_async(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? BYTES : 0;
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(n));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(d), "l"(src), "n"(BYTES), "r"(n));
  }
}

// This thread's copies have landed.
__device__ __forceinline__ void copies_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// ---- end of copies

template <typename T, int N>
struct alignas(sizeof(T) * N) Raw {
  T v[N];
};

// Stage tile (b, ty) of block (slab, tile column) as int32 [row][column]
// [unit][V].  Thread tid takes copy k of the staged pixels p0, p0 + pstep,
// .. (V = 4: a copy moves WPC words by cp.async, then the thread converts
// it; V = 1: one element through registers).
template <typename T, int V, int COPY, bool IN_RQ>
__device__ __forceinline__ void stage(const T* __restrict__ x,
                                      const float* __restrict__ in_mult,
                                      const Tile& t, int32_t* tile, int b,
                                      int ty) {
  constexpr int WPC = V == 4 ? COPY / (4 * (int)sizeof(T)) : 1;
  constexpr int NM = V == 4 ? 4 * WPC : 1;      // channels a copy
  using Chunk = Raw<T, NM>;
  const int tid = threadIdx.x + t.cs * threadIdx.y;
  const int c0 = blockIdx.x * t.cs * V;
  const int cpp = t.cs / WPC;
  const int k = tid % cpp, p0 = tid / cpp, pstep = t.cs * t.tw / cpp;
  const int px_in = t.rows_in * t.cols_in;
  const int iy0 = ty * t.th - 1, ix0 = blockIdx.y * t.tw - 1;
  const T* img = x + (size_t)b * t.H * t.W * t.C + c0 + k * NM;
  float m[NM];
#pragma unroll
  for (int e = 0; e < NM; ++e)
    m[e] = IN_RQ ? __ldg(in_mult + (c0 + k * NM + e) * t.in_stride) : 0.0f;
  if constexpr (V == 4) {
    Chunk* raw = reinterpret_cast<Chunk*>(sizeof(T) < 4 ? tile + t.raw_words
                                                        : tile);
    const int rstep = pstep / t.cols_in, cstep = pstep - rstep * t.cols_in;
    int r = p0 / t.cols_in, cc = p0 - r * t.cols_in;
    for (int p = p0; p < px_in; p += pstep) {
      const int iy = iy0 + r, ix = ix0 + cc;
      const bool valid = iy >= 0 && iy < t.H && ix >= 0 && ix < t.W;
      copy_async<COPY>(raw + p * cpp + k,
                       valid ? img + ((size_t)iy * t.W + ix) * t.C : x,
                       valid);
      r += rstep;
      cc += cstep;
      if (cc >= t.cols_in) {
        cc -= t.cols_in;
        ++r;
      }
    }
    copies_wait_all();
    if constexpr (IN_RQ || sizeof(T) < 4) {
      for (int p = p0; p < px_in; p += pstep) {
        const Chunk v = raw[p * cpp + k];      // this thread's own copy
        int4* dst = reinterpret_cast<int4*>(tile) + p * t.cs + k * WPC;
#pragma unroll
        for (int w = 0; w < WPC; ++w) {
          int32_t h[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const T a = v.v[4 * w + e];
            h[e] = IN_RQ ? requant_in(a, m[4 * w + e], t.in_lo, t.in_hi)
                         : (int32_t)a;
          }
          dst[w] = make_int4(h[0], h[1], h[2], h[3]);
        }
      }
    }
  } else {
    for (int p = p0; p < px_in; p += pstep) {
      const int r = p / t.cols_in, cc = p - r * t.cols_in;
      const int iy = iy0 + r, ix = ix0 + cc;
      int32_t h = 0;
      if (iy >= 0 && iy < t.H && ix >= 0 && ix < t.W) {
        const T a = __ldg(img + ((size_t)iy * t.W + ix) * t.C);
        h = IN_RQ ? requant_in(a, m[0], t.in_lo, t.in_hi) : (int32_t)a;
      }
      tile[p * t.cs + k] = h;
    }
  }
}

template <int V>
struct Sum {
  int32_t v[V];
};

// the 3-sum of staged columns col .. col + 2 of one row, unit u (the next
// column is cs units on)
template <int V>
__device__ __forceinline__ Sum<V> row_sum(const int32_t* row, int cs) {
  Sum<V> s;
  if constexpr (V == 4) {
    const int4 a = reinterpret_cast<const int4*>(row)[0];
    const int4 b = reinterpret_cast<const int4*>(row)[cs];
    const int4 c = reinterpret_cast<const int4*>(row)[2 * cs];
    s.v[0] = a.x + b.x + c.x;
    s.v[1] = a.y + b.y + c.y;
    s.v[2] = a.z + b.z + c.z;
    s.v[3] = a.w + b.w + c.w;
  } else {
    s.v[0] = row[0] + row[cs] + row[2 * cs];
  }
  return s;
}

// Block (slab, tile column, image x tile row); thread (unit u =
// threadIdx.x, column col = threadIdx.y).  OUT_RQ: the requant after, int8
// out; else the int32 quotient (then IN_RQ is false too).
template <typename T, int V, int COPY, bool IN_RQ, bool OUT_RQ>
__global__ void __launch_bounds__(MAX_THREADS)
avgpool3x3_kernel(const T* __restrict__ x, const float* __restrict__ in_mult,
                  const float* __restrict__ mult, void* __restrict__ out,
                  const Tile t) {
  static_assert(OUT_RQ || !IN_RQ, "the requant in front needs the one after");
  constexpr bool BOUNDED = IN_RQ || sizeof(T) < 4;
  extern __shared__ __align__(16) int32_t tile[];
  const int b = blockIdx.z / t.tiles_y;
  const int ty = blockIdx.z - b * t.tiles_y;
  stage<T, V, COPY, IN_RQ>(x, in_mult, t, tile, b, ty);
  __syncthreads();

  const int u = threadIdx.x, col = threadIdx.y;
  const int ox = blockIdx.y * t.tw + col;
  if (ox >= t.W) return;
  const int oy0 = ty * t.th;
  const int rows = min(t.th, t.H - oy0);
  const int c = blockIdx.x * t.cs * V + u * V;   // this thread's channel
  float m[V];
#pragma unroll
  for (int e = 0; e < V; ++e)
    m[e] = OUT_RQ ? __ldg(mult + (c + e) * t.mult_stride) : 0.0f;
  const int row_words = t.cols_in * t.cs * V;
  const size_t out_row = (size_t)t.W * t.C;
  const int32_t* row = tile + (col * t.cs + u) * V;
  const size_t o0 = (((size_t)b * t.H + oy0) * t.W + ox) * t.C + c;
  Sum<V> r1 = row_sum<V>(row, t.cs);
  Sum<V> r2 = row_sum<V>(row + row_words, t.cs);
  row += 2 * row_words;
  for (int y = 0; y < rows; ++y, row += row_words) {
    const Sum<V> r0 = r1;
    r1 = r2;
    r2 = row_sum<V>(row, t.cs);
    const size_t o = o0 + y * out_row;
    if constexpr (OUT_RQ) {
      uint32_t word = 0;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float q = pool_quotient<BOUNDED>(r0.v[e] + r1.v[e] + r2.v[e]);
        word |= requant_out(q, m[e], t.lo, t.hi) << (8 * e);
      }
      if constexpr (V == 4) {
        *reinterpret_cast<uint32_t*>(static_cast<int8_t*>(out) + o) = word;
      } else {
        static_cast<int8_t*>(out)[o] = (int8_t)word;
      }
    } else {
      int32_t q[V];
#pragma unroll
      for (int e = 0; e < V; ++e)   // an integral float: converts exactly
        q[e] = __float2int_rz(
            pool_quotient<BOUNDED>(r0.v[e] + r1.v[e] + r2.v[e]));
      if constexpr (V == 4) {
        *reinterpret_cast<int4*>(static_cast<int32_t*>(out) + o) =
            make_int4(q[0], q[1], q[2], q[3]);
      } else {
        static_cast<int32_t*>(out)[o] = q[0];
      }
    }
  }
}

template <typename T, int V, int COPY, bool IN_RQ, bool OUT_RQ>
int launch_tile(const void* x, const float* in_mult, const float* mult,
                void* out, const Tile& t, int smem, cudaStream_t stream) {
  auto kernel = avgpool3x3_kernel<T, V, COPY, IN_RQ, OUT_RQ>;
  if (smem > 48 * 1024) {
    const int err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err) return err;
  }
  const int slabs = t.C / V / t.cs;
  const int tiles_x = (t.W + t.tw - 1) / t.tw;
  if (tiles_x > 65535 || (long long)t.B * t.tiles_y > 65535)
    return (int)cudaErrorInvalidValue;
  kernel<<<dim3(slabs, tiles_x, t.B * t.tiles_y), dim3(t.cs, t.tw), smem,
           stream>>>(static_cast<const T*>(x), in_mult, mult, out, t);
  return (int)cudaGetLastError();
}

// mult null: the quotient form (in_mult null too)
template <typename T>
int launch(const void* x, const float* in_mult, const float* mult,
           void* out, Tile& t, int vec, int copy, cudaStream_t stream) {
  const int es = (int)sizeof(T);
  // vec 4: copies of 16 bytes (C * sizeof(T) % 16, cs a multiple of the
  // words a copy moves) or of one word; vec 1: through registers
  const bool four = vec == 4 && t.C % 4 == 0
                    && (copy == 4 * es
                        || (copy == 16 && (t.C * es) % 16 == 0
                            && t.cs % (16 / (4 * es)) == 0));
  if (!(four || vec == 1) || (t.C / vec) % t.cs)
    return (int)cudaErrorInvalidValue;
  t.rows_in = t.th + 2;
  t.cols_in = t.tw + 2;
  t.tiles_y = (t.H + t.th - 1) / t.th;
  const long long words = (long long)t.rows_in * t.cols_in * t.cs * vec;
  t.raw_words = (int)words;
  const long long smem = 4 * words + (vec == 4 && es < 4 ? words * es : 0);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  const bool rq = in_mult != nullptr;
#define HAWQ_AP(V, COPY)                                                  \
  if (vec == V && (V == 1 || copy == COPY))                               \
    return !mult ? launch_tile<T, V, COPY, false, false>(                 \
                       x, in_mult, mult, out, t, (int)smem, stream)       \
           : rq  ? launch_tile<T, V, COPY, true, true>(                   \
                       x, in_mult, mult, out, t, (int)smem, stream)       \
                 : launch_tile<T, V, COPY, false, true>(                  \
                       x, in_mult, mult, out, t, (int)smem, stream);
  HAWQ_AP(4, 16)
  if constexpr (sizeof(T) < 4) {
    HAWQ_AP(4, 4 * sizeof(T))
  }
  HAWQ_AP(1, 0)
#undef HAWQ_AP
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x (B, H, W, C): in_code 0 int16, 1 int32, 2 int8.  in_mult: null (no
// requant in front) or a float32 scalar (in_stride 0) / (C,) vector (1),
// with the bounds [in_lo, in_hi] of at most 16 bits; mult likewise
// (mult_stride), out int8 in [lo, hi].  The tile plan
// (kernels/avgpool.py AvgPlan): vec, 4 or 1 channels a thread (4: C % 4, x
// aligned to 4 * sizeof(T) bytes); copy, the bytes a staging copy moves
// (16, or one word); cs, channel units a tile; tw, th, output columns and
// rows a tile.  Returns cudaGetLastError() after the launch.
extern "C" int hawq_avgpool3x3_requant(const void* x, const float* in_mult,
                                       const float* mult, int8_t* out, int B,
                                       int H, int W, int C, int in_code,
                                       int in_stride, int in_lo, int in_hi,
                                       int mult_stride, int lo, int hi,
                                       int vec, int copy, int cs, int tw,
                                       int th, cudaStream_t stream) {
  if (B < 1 || H < 1 || W < 1 || C < 1 || cs < 1 || tw < 1 || th < 1
      || cs * tw > MAX_THREADS || !mult || (in_mult && (in_lo < -32768
                                                        || in_hi > 65535)))
    return (int)cudaErrorInvalidValue;
  Tile t{};
  t.B = B; t.H = H; t.W = W; t.C = C;
  t.cs = cs; t.tw = tw; t.th = th;
  t.in_stride = in_stride;
  t.mult_stride = mult_stride;
  t.in_lo = (float)in_lo; t.in_hi = (float)in_hi;
  t.lo = (float)lo; t.hi = (float)hi;
  if (in_code == 1)
    return launch<int32_t>(x, in_mult, mult, out, t, vec, copy, stream);
  if (in_code == 0)
    return launch<int16_t>(x, in_mult, mult, out, t, vec, copy, stream);
  if (in_code == 2)
    return launch<int8_t>(x, in_mult, mult, out, t, vec, copy, stream);
  return (int)cudaErrorInvalidValue;
}

// The quotient form: x (B, H, W, C) as above, out (B, H, W, C) int32, q =
// trunc(f32(s) / 9 + 0.01) of each window's sum, no requant.  The same
// tile plan.  Returns cudaGetLastError() after the launch.
extern "C" int hawq_avgpool3x3(const void* x, int32_t* out, int B, int H,
                               int W, int C, int in_code, int vec, int copy,
                               int cs, int tw, int th, cudaStream_t stream) {
  if (B < 1 || H < 1 || W < 1 || C < 1 || cs < 1 || tw < 1 || th < 1
      || cs * tw > MAX_THREADS)
    return (int)cudaErrorInvalidValue;
  Tile t{};
  t.B = B; t.H = H; t.W = W; t.C = C;
  t.cs = cs; t.tw = tw; t.th = th;
  if (in_code == 1)
    return launch<int32_t>(x, nullptr, nullptr, out, t, vec, copy, stream);
  if (in_code == 0)
    return launch<int16_t>(x, nullptr, nullptr, out, t, vec, copy, stream);
  if (in_code == 2)
    return launch<int8_t>(x, nullptr, nullptr, out, t, vec, copy, stream);
  return (int)cudaErrorInvalidValue;
}
