// Global (min, max) of a float32 tensor in one read.
//
// Replaces hawq_tpu/kernels/reduce.py minmax_1pass (reduce.py:63,
// _minmax_kernel :37): the range statistic of every QuantAct in QAT.  The
// TPU kernel walks the tensor in sequential 4096x128 blocks and leaves a
// tail to a second reduction on the host side of the call; here every
// thread of a grid that fills the card strides over the whole flattened
// tensor, so there is no chunking and no separate tail.
//
// Bound on the H100: bytes.  The tensor is read once (4n bytes) and eight
// bytes are written; there is one compare per value.  The design therefore
// spends everything on the read: 16-byte loads where the pointer allows
// (a scalar head up to the first 16-byte boundary and a scalar tail after
// the last whole float4), four loads in flight per thread, per-thread
// running (min, max), warp shuffles, one partial pair per block in a
// workspace.  The finish is a second, one-block launch over the partials
// (no atomic counter to keep zeroed between calls, nothing on the host).
//
// Semantics are torch.amin / torch.amax: a NaN anywhere gives NaN for both
// (fminf / fmaxf would drop it, so the compares are written out), +-inf
// pass through.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 8;

// b replaces a when it is smaller, or when it is NaN; once a is NaN every
// compare with it is false and it stays.
__device__ __forceinline__ float nan_min(float a, float b) {
  return (b < a || b != b) ? b : a;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (b > a || b != b) ? b : a;
}

__device__ __forceinline__ void block_reduce_store(float mn, float mx,
                                                   float* out_min,
                                                   float* out_max) {
  __shared__ float smin[THREADS / 32];
  __shared__ float smax[THREADS / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    mn = nan_min(mn, __shfl_xor_sync(0xffffffffu, mn, off));
    mx = nan_max(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    smin[warp] = mn;
    smax[warp] = mx;
  }
  __syncthreads();
  if (warp == 0) {
    // every warp of the block holds at least one real value (see callers),
    // so the unused lanes repeat warp 0's
    mn = smin[lane < THREADS / 32 ? lane : 0];
    mx = smax[lane < THREADS / 32 ? lane : 0];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      mn = nan_min(mn, __shfl_xor_sync(0xffffffffu, mn, off));
      mx = nan_max(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    }
    if (lane == 0) {
      *out_min = mn;
      *out_max = mx;
    }
  }
}

// Partial (min, max) of each block.  head = scalars before the first
// 16-byte boundary, nvec = whole float4s after it, then the scalar tail.
// Every thread starts from x[0], a real element, so no identity value is
// needed and a block that finds no work still reports valid partials.
__global__ void __launch_bounds__(THREADS)
minmax_partial_kernel(const float* __restrict__ x, long long n, int head,
                      long long nvec, float* __restrict__ pmin,
                      float* __restrict__ pmax) {
  float mn = x[0], mx = mn;
  const float4* v = reinterpret_cast<const float4*>(x + head);
  const long long stride = (long long)gridDim.x * THREADS;
  long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  for (; i + 3 * stride < nvec; i += 4 * stride) {
    float4 a = v[i], b = v[i + stride], c = v[i + 2 * stride],
           d = v[i + 3 * stride];
    const float f[16] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w,
                         c.x, c.y, c.z, c.w, d.x, d.y, d.z, d.w};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      mn = nan_min(mn, f[j]);
      mx = nan_max(mx, f[j]);
    }
  }
  for (; i < nvec; i += stride) {
    float4 a = v[i];
    const float f[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      mn = nan_min(mn, f[j]);
      mx = nan_max(mx, f[j]);
    }
  }
  if (blockIdx.x == 0) {      // head and tail: fewer than 4 scalars each
    const long long tail0 = head + 4 * nvec;
    if (threadIdx.x < head) {
      float s = x[threadIdx.x];
      mn = nan_min(mn, s);
      mx = nan_max(mx, s);
    }
    if (tail0 + threadIdx.x < n) {
      float s = x[tail0 + threadIdx.x];
      mn = nan_min(mn, s);
      mx = nan_max(mx, s);
    }
  }
  block_reduce_store(mn, mx, pmin + blockIdx.x, pmax + blockIdx.x);
}

// One block over the partials → out[0] = min, out[1] = max.
__global__ void __launch_bounds__(THREADS)
minmax_finish_kernel(const float* __restrict__ pmin,
                     const float* __restrict__ pmax, int blocks,
                     float* __restrict__ out) {
  float mn = pmin[0], mx = pmax[0];
  for (int i = threadIdx.x; i < blocks; i += THREADS) {
    mn = nan_min(mn, pmin[i]);
    mx = nan_max(mx, pmax[i]);
  }
  block_reduce_store(mn, mx, out, out + 1);
}

}  // namespace

// Number of partial pairs the workspace must hold (2 * this many floats).
extern "C" int hawq_minmax_max_blocks() { return MAX_BLOCKS; }

// x: n >= 1 float32 values; ws: 2 * MAX_BLOCKS floats; out: 2 floats.
extern "C" int hawq_minmax_f32(const float* x, long long n, float* ws,
                               float* out, cudaStream_t stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  int head = (int)(((16 - (reinterpret_cast<uintptr_t>(x) & 15)) & 15) / 4);
  if (head > n) head = (int)n;
  long long nvec = (n - head) / 4;
  long long want = (nvec + (long long)THREADS * 4 - 1) / ((long long)THREADS * 4);
  int blocks = (int)(want < 1 ? 1 : (want > MAX_BLOCKS ? MAX_BLOCKS : want));
  float* pmin = ws;
  float* pmax = ws + MAX_BLOCKS;
  minmax_partial_kernel<<<blocks, THREADS, 0, stream>>>(x, n, head, nvec, pmin,
                                                        pmax);
  int code = (int)cudaGetLastError();
  if (code != 0) return code;
  minmax_finish_kernel<<<1, THREADS, 0, stream>>>(pmin, pmax, blocks, out);
  return (int)cudaGetLastError();
}
