// The engines' native requant in one pass: integer tensors (int8, int16 or
// int32, last axis C) -> clip(floor(f32(v) * mult + 0.5), lo, hi) as int8,
// int16 or int32, with a scalar or per-channel (last axis) float32 dyadic
// multiplier (requant.cuh requant_f32, the GEMM epilogues' op order).  A
// ReLU in front is lo = 0: the requant is monotone and maps 0 to 0.  One
// launch takes 1 to MAX_PIECES pieces with equal leading shapes, each with
// its own input dtype and multiplier, and writes each into its slice of one
// output (row r of a piece at out + r * ld + its first channel): one piece
// is the standalone requant, several a unit's branches requantized straight
// into their concat.
//
// Replaces no TPU kernel: hawq_tpu's engines leave this requant to XLA,
// which fuses its convert, multiply, add, floor, clamp and convert into one
// loop (and the concat after it).  The port ran them as six PyTorch
// elementwise kernels over float32 temporaries (quant/ops.py
// requant_int32), about 45 bytes moved for each int32 element turned into
// int8 against the 5 that the pass needs.
//
// Bound on the H100: bytes (each input element read once, each output
// written once; no arithmetic to speak of).  The design streams them:
//
//  * each thread takes V elements a step, V = 16 / the narrowest element
//    size of the launch, so the narrowest side moves as one 16-byte access
//    and the wider ones as two or four (int32 -> int8: four 16-byte loads,
//    one 16-byte store); the wrapper picks this vector form where every
//    pointer (and each per-channel multiplier) is 16-byte aligned and,
//    where a vector's channel or row matters, C is a multiple of V, else
//    the one-element form (V = 1) of the same walk;
//  * the pieces' vectors are laid end to end; a grid of a few blocks per SM
//    strides over them, piece after piece (the descriptors are one
//    __grid_constant__ parameter; a concat's current one is copied into
//    registers); the few elements past a piece's last whole vector are
//    taken by block 0, one a thread;
//  * the input type is a template value where the pieces share one (every
//    call of the engines), read from each piece's descriptor otherwise;
//  * the channel of a vector is its offset modulo C; a per-channel
//    multiplier (at most a few thousand floats, cached) is read through
//    __ldg, four at a time, a scalar one once a step.
//
// 32-bit offsets: the wrapper keeps every element count below 2^31.
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "requant.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_PIECES = 8;     // kernels/requant.py RQ_MAX_PIECES

struct Piece {
  const void* x;
  const float* mult;
  unsigned numel, nvec, C, off;   // off: the piece's first output channel
  int in_dtype;                   // 0 int8, 1 int16, 2 int32
  int per_channel;
};

struct Pieces {
  Piece p[MAX_PIECES];
  unsigned start[MAX_PIECES + 1];   // running sum of the pieces' nvec
  int n;
};

template <typename T, int V>
struct alignas(sizeof(T) * V >= 16 ? 16 : sizeof(T) * V) Pack {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ Pack<T, V> load_pack(const T* p) {
  Pack<T, V> r;
  if constexpr (sizeof(r) >= 16) {
    const uint4* q = reinterpret_cast<const uint4*>(p);
    uint4* d = reinterpret_cast<uint4*>(&r);
#pragma unroll
    for (int k = 0; k < (int)(sizeof(r) / 16); ++k) d[k] = __ldg(q + k);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) r.v[e] = __ldg(p + e);
  }
  return r;
}

template <typename T, int V>
__device__ __forceinline__ void store_pack(T* p, const Pack<T, V>& r) {
  if constexpr (sizeof(r) >= 16) {
    uint4* q = reinterpret_cast<uint4*>(p);
    const uint4* s = reinterpret_cast<const uint4*>(&r);
#pragma unroll
    for (int k = 0; k < (int)(sizeof(r) / 16); ++k) q[k] = s[k];
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) p[e] = r.v[e];
  }
}

template <typename In, typename Out>
__device__ __forceinline__ Out requant_one(In v, float mult, float lo,
                                           float hi) {
  return static_cast<Out>(
      __float2int_rz(hawq::requant_f32(static_cast<int32_t>(v), mult, lo, hi)));
}

// One step of V elements of piece p from its element i, written at out;
// m0: a scalar multiplier, read once a walk.
template <typename In, typename Out, int V>
__device__ __forceinline__ void step(const Piece& p, unsigned i, unsigned c,
                                     float m0, Out* out, float lo, float hi) {
  const Pack<In, V> a = load_pack<In, V>(static_cast<const In*>(p.x) + i);
  float m[V];
  if (!p.per_channel) {
#pragma unroll
    for (int e = 0; e < V; ++e) m[e] = m0;
  } else if constexpr (V % 4 == 0) {
    const float4* q = reinterpret_cast<const float4*>(p.mult + c);
#pragma unroll
    for (int k = 0; k < V / 4; ++k) {
      const float4 f = __ldg(q + k);
      m[4 * k] = f.x;
      m[4 * k + 1] = f.y;
      m[4 * k + 2] = f.z;
      m[4 * k + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) m[e] = __ldg(p.mult + c + e);
  }
  Pack<Out, V> r;
#pragma unroll
  for (int e = 0; e < V; ++e)
    r.v[e] = requant_one<In, Out>(a.v[e], m[e], lo, hi);
  store_pack<Out, V>(out, r);
}

// In: the pieces' input type where they share one, else Mixed (each
// piece's in_dtype read at run time).
struct Mixed {};

template <typename In, typename Out, int V>
__device__ __forceinline__ void step_as(const Piece& p, unsigned i,
                                        unsigned c, float m0, Out* out,
                                        float lo, float hi) {
  if constexpr (std::is_same_v<In, Mixed>) {
    switch (p.in_dtype) {
      case 0: step<int8_t, Out, V>(p, i, c, m0, out, lo, hi); break;
      case 1: step<int16_t, Out, V>(p, i, c, m0, out, lo, hi); break;
      default: step<int32_t, Out, V>(p, i, c, m0, out, lo, hi); break;
    }
  } else {
    step<In, Out, V>(p, i, c, m0, out, lo, hi);
  }
}

// Steps v0, v0 + stride, ... below past of piece p, whose first step is
// first.
template <typename In, typename Out, int V>
__device__ __forceinline__ void walk(const Piece& p, unsigned v0,
                                     unsigned first, unsigned past,
                                     unsigned stride, Out* out, unsigned ld,
                                     float lo, float hi) {
  const float m0 = __ldg(p.mult);
  for (unsigned v = v0; v < past; v += stride) {
    const unsigned i = (v - first) * V;
    unsigned c = 0, o = i;
    if (p.per_channel || p.C != ld) {
      const unsigned row = i / p.C;
      c = i - row * p.C;
      o = row * ld + p.off + c;
    }
    step_as<In, Out, V>(p, i, c, m0, out + o, lo, hi);
  }
}

template <typename In, typename Out, int V>
__global__ void __launch_bounds__(THREADS)
    requant_kernel(const __grid_constant__ Pieces ps, Out* __restrict__ out,
                   unsigned ld, float lo, float hi) {
  const unsigned stride = gridDim.x * THREADS;
  unsigned v = blockIdx.x * THREADS + threadIdx.x;
  if (ps.n == 1) {           // the standalone requant: the descriptor read
    walk<In, Out, V>(ps.p[0], v, 0, ps.start[1], stride, out, ld, lo, hi);
  } else {                   // in place; a concat: piece by piece, each
    for (int k = 0; k < ps.n; ++k) {     // descriptor once in registers
      const Piece p = ps.p[k];
      const unsigned first = ps.start[k], past = ps.start[k + 1];
      walk<In, Out, V>(p, v, first, past, stride, out, ld, lo, hi);
      if (v < past) v += (past - v + stride - 1) / stride * stride;
    }
  }
  if (blockIdx.x == 0) {     // the ragged tails, past the last whole vector
    for (int q = 0; q < ps.n; ++q) {
      const Piece& t = ps.p[q];
      for (unsigned i = t.nvec * V + threadIdx.x; i < t.numel; i += THREADS) {
        const unsigned row = i / t.C, c = i - row * t.C;
        step_as<In, Out, 1>(t, i, c, __ldg(t.mult),
                            out + row * ld + t.off + c, lo, hi);
      }
    }
  }
}

template <typename In, typename Out, int V>
int launch(const Pieces& ps, void* out, int ld, int lo, int hi, int blocks,
           cudaStream_t stream) {
  requant_kernel<In, Out, V><<<blocks, THREADS, 0, stream>>>(
      ps, static_cast<Out*>(out), (unsigned)ld, (float)lo, (float)hi);
  return (int)cudaGetLastError();
}

// vec: 1, or 16 / the narrowest element size of the launch (the wrapper's
// plan): for one input type 16 / min(sizeof(In), sizeof(Out)); for mixed
// ones, of which the narrowest is int8 or int16, 16 or 8.
template <typename In, typename Out>
int by_vec(const Pieces& ps, void* out, int ld, int vec, int lo, int hi,
           int blocks, cudaStream_t stream) {
  if (vec == 1) return launch<In, Out, 1>(ps, out, ld, lo, hi, blocks, stream);
  if constexpr (std::is_same_v<In, Mixed>) {
    if (vec == 16)
      return launch<In, Out, 16>(ps, out, ld, lo, hi, blocks, stream);
    if constexpr (sizeof(Out) >= 2)
      if (vec == 8)
        return launch<In, Out, 8>(ps, out, ld, lo, hi, blocks, stream);
  } else {
    constexpr int V = 16 / (sizeof(In) < sizeof(Out) ? sizeof(In)
                                                     : sizeof(Out));
    if (vec == V) return launch<In, Out, V>(ps, out, ld, lo, hi, blocks, stream);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename Out>
int by_in(const Pieces& ps, int in_dtype, void* out, int ld, int vec, int lo,
          int hi, int blocks, cudaStream_t stream) {
  switch (in_dtype) {
    case 0: return by_vec<int8_t, Out>(ps, out, ld, vec, lo, hi, blocks, stream);
    case 1: return by_vec<int16_t, Out>(ps, out, ld, vec, lo, hi, blocks, stream);
    case 2: return by_vec<int32_t, Out>(ps, out, ld, vec, lo, hi, blocks, stream);
    default: return by_vec<Mixed, Out>(ps, out, ld, vec, lo, hi, blocks, stream);
  }
}

}  // namespace

// n pieces -> out (rows of ld elements).  desc: 8 int64 a piece, in order
// x, mult (addresses), numel, nvec, C, off (its first output channel),
// in dtype, per_channel (mult holds C floats, else one).  Dtypes: 0 =
// int8, 1 = int16, 2 = int32.  vec: the elements of a step (the wrapper's
// plan, kernels/requant.py rq_plan; 1 for one element a step, nvec =
// numel).  blocks: the grid.
extern "C" int hawq_requant(const long long* desc, int n, void* out, int ld,
                            int out_dtype, int vec, int lo, int hi,
                            int blocks, cudaStream_t stream) {
  if (n < 1 || n > MAX_PIECES || ld < 1 || blocks < 1)
    return (int)cudaErrorInvalidValue;
  Pieces ps{};
  ps.n = n;
  for (int k = 0; k < n; ++k) {
    const long long* d = desc + 8 * k;
    Piece& p = ps.p[k];
    p.x = reinterpret_cast<const void*>(d[0]);
    p.mult = reinterpret_cast<const float*>(d[1]);
    p.numel = (unsigned)d[2];
    p.nvec = (unsigned)d[3];
    p.C = (unsigned)d[4];
    p.off = (unsigned)d[5];
    p.in_dtype = (int)d[6];
    p.per_channel = (int)d[7];
    if (d[2] < 1 || d[3] < 0 || d[3] * vec > d[2] || d[4] < 1 ||
        d[5] + d[4] > ld || d[6] < 0 || d[6] > 2)
      return (int)cudaErrorInvalidValue;
    ps.start[k + 1] = ps.start[k] + p.nvec;
  }
  int in_dtype = ps.p[0].in_dtype;      // one input type, or -1: mixed
  for (int k = 1; k < n; ++k)
    if (ps.p[k].in_dtype != in_dtype) in_dtype = -1;
  switch (out_dtype) {
    case 0:
      return by_in<int8_t>(ps, in_dtype, out, ld, vec, lo, hi, blocks, stream);
    case 1:
      return by_in<int16_t>(ps, in_dtype, out, ld, vec, lo, hi, blocks, stream);
    case 2:
      return by_in<int32_t>(ps, in_dtype, out, ld, vec, lo, hi, blocks, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
