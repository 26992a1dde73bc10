// 3x3/stride-2/pad-1 max-pool on the fold4 layout, and the same pool with the
// init conv's requant (+ ReLU) in front.
//
// Replaces hawq_tpu/kernels/pool.py maxpool_folded (pool.py:69, _pool_kernel
// :41).  Input (B, Hq, Wq, 4N) in channel order (py, px, n): logical pixel
// (2a+py, 2b+px) lives at x[a, b, py, px, n].  Output pixel (i, j) is the max
// over logical rows {2i-1, 2i, 2i+1} and columns {2j-1, 2j, 2j+1}, i.e. over
// (i-1, py=1), (i, py=0), (i, py=1) and likewise in j; row or column -1 is
// the pool's border and contributes nothing (a predicate, not a fill value).
// With the row max rm_px(j) = max(x[i, j, 0, px], x[i, j, 1, px],
// x[i-1, j, 1, px]), out(i, j) = max(rm_0(j), rm_1(j), rm_1(j-1)).
//
// Bound on the H100: bytes (the input read once, a quarter of it written).
// What held the first version at 3x its bound was instructions: one thread
// per output element, nine scalar 2-byte loads each (every input loaded
// ~2.25 times) and three 64-bit divisions per element.  Here:
//
//  * each thread owns one 16-byte vector of channels (8 int16, or 4 int32 /
//    float32), and consecutive lanes take consecutive vectors of one (py, px)
//    plane, so a warp's loads are whole 128-byte lines; where N * element
//    size is not a multiple of 16 or a pointer is not 16-byte aligned the
//    wrapper picks the one-element form (V = 1) of the same walk;
//  * each thread walks a run of RUN = 4 output columns j along one row i and
//    keeps rm_1(j-1) in registers as the "left" term, so every input vector
//    is loaded once as "self" and once more only as the py = 1 "up" term of
//    the row below (rm_1 of the column before the run is loaded afresh);
//  * 32-bit index arithmetic, done once per thread; no grid-stride loop: the
//    grid is B * Hq * ceil(Wq / RUN) * (N / V) threads.
//
// On the H100 runs of 8 and 16 columns left too few threads in flight at
// the engine's shape (8, 56, 56, 256), so RUN is fixed at 4.
// chip_sweep_sm90.py times both forms with the input in L2 and streamed
// from device memory, against their bytes bound.
//
// maxpool_folded_requant: the input is the init conv's (B, Hq, Wq, 4N) int32
// accumulator, and each of the nine loaded values is requantized with its
// own channel's multiplier (mult[(py*2 + px) * N + n]: clip(floor(f32(v) *
// mult + 0.5), lo, hi), requant.cuh, ReLU as lo = 0) before the max, so the
// result equals pool(relu(requant(acc))) for any multipliers.  It replaces
// the requant's elementwise passes and the pool's own launch with one read
// of the accumulator (the 3x3/s2 window crosses the conv's output tiles, so
// the pool stays a kernel of its own after the conv).
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "requant.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int RUN = 4;     // output columns one thread walks

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ Vec<T, V> load_vec(const T* p) {
  Vec<T, V> r;
  if constexpr (sizeof(r) == 16) {
    *reinterpret_cast<uint4*>(&r) = __ldg(reinterpret_cast<const uint4*>(p));
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) r.v[e] = __ldg(p + e);
  }
  return r;
}

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const Vec<T, V>& r) {
  if constexpr (sizeof(r) == 16) {
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(&r);
  } else if constexpr (sizeof(r) == 8) {
    *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(&r);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) p[e] = r.v[e];
  }
}

template <typename T>
__device__ __forceinline__ T vmax(T a, T b) { return a > b ? a : b; }

template <typename T, int V>
__device__ __forceinline__ Vec<T, V> vmax(const Vec<T, V>& a,
                                          const Vec<T, V>& b) {
  Vec<T, V> r;
  if constexpr (sizeof(T) == 2 && V % 2 == 0) {     // two int16 per word
    const uint32_t* wa = reinterpret_cast<const uint32_t*>(&a);
    const uint32_t* wb = reinterpret_cast<const uint32_t*>(&b);
    uint32_t* wr = reinterpret_cast<uint32_t*>(&r);
#pragma unroll
    for (int w = 0; w < V / 2; ++w) wr[w] = __vmaxs2(wa[w], wb[w]);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) r.v[e] = vmax(a.v[e], b.v[e]);
  }
  return r;
}

// The values a thread works on: T as loaded.
template <typename T, int V>
struct PlainLoad {
  using Acc = T;
  int n;
  __device__ __forceinline__ Vec<T, V> operator()(const T* q, int plane) const {
    return load_vec<T, V>(q + plane * n);
  }
};

// The int32 accumulator requantized on load, each channel with its own
// multiplier (four planes of V, loaded once per thread).
template <int V>
struct RequantLoad {
  using Acc = float;
  int n;
  float lo, hi;
  Vec<float, V> mult[4];
  __device__ __forceinline__ Vec<float, V> operator()(const int32_t* q,
                                                      int plane) const {
    const Vec<int32_t, V> a = load_vec<int32_t, V>(q + plane * n);
    Vec<float, V> r;
#pragma unroll
    for (int e = 0; e < V; ++e)
      r.v[e] = hawq::requant_f32(a.v[e], mult[plane].v[e], lo, hi);
    return r;
  }
};

template <typename Out, typename Acc, int V>
__device__ __forceinline__ void store_out(Out* p, const Vec<Acc, V>& m) {
  if constexpr (std::is_same_v<Out, Acc>) {
    store_vec<Out, V>(p, m);
  } else {                                         // requantized: integer-
    Vec<Out, V> r;                                 // valued floats in range
#pragma unroll
    for (int e = 0; e < V; ++e) r.v[e] = (Out)__float2int_rz(m.v[e]);
    store_vec<Out, V>(p, r);
  }
}

// One thread: channel vector v of output row (b, i), columns j0 ..
// j0+RUN-1.  rows = B * Hq, runs = ceil(Wq / RUN), nv = N / V.
template <typename In, typename Out, int V, typename Load>
__device__ __forceinline__ void walk(const In* __restrict__ x,
                                     Out* __restrict__ out, const Load& load,
                                     int t, int Hq, int Wq, int N, int runs,
                                     int nv) {
  using Acc = typename Load::Acc;
  const int v = t % nv;
  const int run = t / nv;
  const int row = run / runs;                    // b * Hq + i
  const int j0 = (run - row * runs) * RUN;
  const bool up = row % Hq != 0;                 // row i - 1 is in the image
  const int pix = 4 * N;                         // elements of an input pixel
  const In* p = x + (row * Wq + j0) * pix + v * V;
  const In* pu = p - Wq * pix;
  Out* o = out + (row * Wq + j0) * N + v * V;
  Vec<Acc, V> left;                              // rm_1 of the column before
  if (j0 > 0) {
    left = vmax(load(p - pix, 1), load(p - pix, 3));
    if (up) left = vmax(left, load(pu - pix, 3));
  }
#pragma unroll
  for (int r = 0; r < RUN; ++r) {
    if (j0 + r >= Wq) break;
    const In* q = p + r * pix;
    Vec<Acc, V> rm0 = vmax(load(q, 0), load(q, 2));
    Vec<Acc, V> rm1 = vmax(load(q, 1), load(q, 3));
    if (up) {
      const In* qu = pu + r * pix;
      rm0 = vmax(rm0, load(qu, 2));
      rm1 = vmax(rm1, load(qu, 3));
    }
    Vec<Acc, V> m = vmax(rm0, rm1);
    if (j0 + r > 0) m = vmax(m, left);
    store_out<Out, Acc, V>(o + r * N, m);
    left = rm1;
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
maxpool_folded_kernel(const T* __restrict__ x, T* __restrict__ out,
                      int total, int Hq, int Wq, int N, int runs) {
  const int t = blockIdx.x * THREADS + threadIdx.x;
  if (t >= total) return;
  walk<T, T, V>(x, out, PlainLoad<T, V>{N}, t, Hq, Wq, N, runs, N / V);
}

template <typename Out, int V>
__global__ void __launch_bounds__(THREADS)
maxpool_folded_requant_kernel(const int32_t* __restrict__ acc,
                              const float* __restrict__ mult,
                              Out* __restrict__ out, int total, int Hq,
                              int Wq, int N, int runs, float lo, float hi) {
  const int t = blockIdx.x * THREADS + threadIdx.x;
  if (t >= total) return;
  const int nv = N / V;
  RequantLoad<V> load{N, lo, hi, {}};
#pragma unroll
  for (int plane = 0; plane < 4; ++plane)
    load.mult[plane] = load_vec<float, V>(mult + plane * N + (t % nv) * V);
  walk<int32_t, Out, V>(acc, out, load, t, Hq, Wq, N, runs, nv);
}

// Threads of the grid, or -1 where the shape is not one the walk takes.
int grid_threads(int B, int Hq, int Wq, int N, int V) {
  if (B < 1 || Hq < 1 || Wq < 1 || N < 1 || N % V) return -1;
  const long long total =
      (long long)B * Hq * ((Wq + RUN - 1) / RUN) * (N / V);
  const long long elems = (long long)B * Hq * Wq * 4 * N;
  if (total > INT32_MAX || elems > INT32_MAX) return -1;
  return (int)total;
}

template <typename T, int V>
int launch_pool(const void* x, void* out, int B, int Hq, int Wq, int N,
                cudaStream_t stream) {
  const int total = grid_threads(B, Hq, Wq, N, V);
  if (total < 0) return (int)cudaErrorInvalidValue;
  maxpool_folded_kernel<T, V><<<(total + THREADS - 1) / THREADS, THREADS, 0,
                                stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), total, Hq, Wq, N,
      (Wq + RUN - 1) / RUN);
  return (int)cudaGetLastError();
}

template <typename Out, int V>
int launch_requant(const int32_t* acc, const float* mult, void* out, int B,
                   int Hq, int Wq, int N, int lo, int hi,
                   cudaStream_t stream) {
  const int total = grid_threads(B, Hq, Wq, N, V);
  if (total < 0) return (int)cudaErrorInvalidValue;
  maxpool_folded_requant_kernel<Out, V>
      <<<(total + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
          acc, mult, static_cast<Out*>(out), total, Hq, Wq, N,
          (Wq + RUN - 1) / RUN, (float)lo, (float)hi);
  return (int)cudaGetLastError();
}

template <typename T>
int pool_dtype(const void* x, void* out, int B, int Hq, int Wq, int N,
               int vec, cudaStream_t stream) {
  return vec ? launch_pool<T, 16 / sizeof(T)>(x, out, B, Hq, Wq, N, stream)
             : launch_pool<T, 1>(x, out, B, Hq, Wq, N, stream);
}

template <typename Out>
int requant_dtype(const int32_t* acc, const float* mult, void* out, int B,
                  int Hq, int Wq, int N, int lo, int hi, int vec,
                  cudaStream_t stream) {
  return vec ? launch_requant<Out, 4>(acc, mult, out, B, Hq, Wq, N, lo, hi,
                                      stream)
             : launch_requant<Out, 1>(acc, mult, out, B, Hq, Wq, N, lo, hi,
                                      stream);
}

}  // namespace

// x (B, Hq, Wq, 4N) -> out (B, Hq, Wq, N); dtype: 0 = int16, 1 = int32,
// 2 = float32.  vec: 1 for 16-byte channel vectors (N * element size a
// multiple of 16, both pointers 16-byte aligned), 0 for one element a
// thread.
extern "C" int hawq_maxpool_folded(const void* x, void* out, int B, int Hq,
                                   int Wq, int N, int dtype, int vec,
                                   cudaStream_t stream) {
  switch (dtype) {
    case 0: return pool_dtype<int16_t>(x, out, B, Hq, Wq, N, vec, stream);
    case 1: return pool_dtype<int32_t>(x, out, B, Hq, Wq, N, vec, stream);
    case 2: return pool_dtype<float>(x, out, B, Hq, Wq, N, vec, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// acc (B, Hq, Wq, 4N) int32, mult (4N,) float32 in the fold's (py, px, n)
// order -> out (B, Hq, Wq, N) pool(clip(requant(acc), lo, hi)); out_dtype:
// 0 = int16, 1 = int32.  vec: 1 for 4 channels a thread (N % 4 == 0, acc
// and mult 16-byte aligned, out 8-byte aligned), 0 for one.
extern "C" int hawq_maxpool_folded_requant(const int32_t* acc,
                                           const float* mult, void* out,
                                           int B, int Hq, int Wq, int N,
                                           int lo, int hi, int out_dtype,
                                           int vec, cudaStream_t stream) {
  switch (out_dtype) {
    case 0:
      return requant_dtype<int16_t>(acc, mult, out, B, Hq, Wq, N, lo, hi, vec,
                                    stream);
    case 1:
      return requant_dtype<int32_t>(acc, mult, out, B, Hq, Wq, N, lo, hi, vec,
                                    stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
