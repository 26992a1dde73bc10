// 3x3/stride-2/pad-1 max-pool on the fold4 layout.
//
// Replaces hawq_tpu/kernels/pool.py maxpool_folded (pool.py:69, _pool_kernel
// :41).  Input (B, Hq, Wq, 4N) in channel order (py, px, n): logical pixel
// (2a+py, 2b+px) lives at x[a, b, py, px, n].  Output pixel (i, j) is the max
// over logical rows {2i-1, 2i, 2i+1} and columns {2j-1, 2j, 2j+1}, i.e. over
// (i-1, py=1), (i, py=0), (i, py=1) and likewise in j; row or column -1 is
// the pool's border and contributes nothing (the dtype minimum).
//
// Bound on the H100: bytes.  It reads the input once (each output reads
// 9 values, 5 of them shared with neighbours through L1/L2) and writes a
// quarter of that; no arithmetic beyond compares.  One thread per output
// element, consecutive threads on consecutive channels, so loads coalesce.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

template <typename T>
__device__ __forceinline__ T vmax(T a, T b) { return a > b ? a : b; }

template <typename T>
__global__ void maxpool_folded_kernel(const T* __restrict__ x, T* __restrict__ out,
                                      int B, int Hq, int Wq, int N) {
  long long total = (long long)B * Hq * Wq * N;
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += stride) {
    int n = (int)(idx % N);
    long long pix = idx / N;
    int j = (int)(pix % Wq);
    int i = (int)((pix / Wq) % Hq);
    const T* p = x + pix * 4 * N + n;          // (i, j), channel n
    const T* pl = p - 4 * (long long)N;        // (i, j-1)
    const T* pu = p - 4 * (long long)N * Wq;   // (i-1, j)
    const T* pul = pu - 4 * (long long)N;      // (i-1, j-1)
    // row max at (i, j) for px = 0, 1; channel offsets py*2N + px*N
    T r0 = vmax(p[0], p[2 * N]);
    T r1 = vmax(p[N], p[3 * N]);
    if (i > 0) {
      r0 = vmax(r0, pu[2 * N]);
      r1 = vmax(r1, pu[3 * N]);
    }
    T m = vmax(r0, r1);
    if (j > 0) {
      T l = vmax(pl[N], pl[3 * N]);
      if (i > 0) l = vmax(l, pul[3 * N]);
      m = vmax(m, l);
    }
    out[idx] = m;
  }
}

template <typename T>
int launch(const void* x, void* out, int B, int Hq, int Wq, int N,
           cudaStream_t stream) {
  long long total = (long long)B * Hq * Wq * N;
  int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 132 * 64) blocks = 132 * 64;
  if (blocks < 1) blocks = 1;
  maxpool_folded_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), B, Hq, Wq, N);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = int16, 1 = int32, 2 = float32.
extern "C" int hawq_maxpool_folded(const void* x, void* out, int B, int Hq,
                                   int Wq, int N, int dtype,
                                   cudaStream_t stream) {
  switch (dtype) {
    case 0: return launch<int16_t>(x, out, B, Hq, Wq, N, stream);
    case 1: return launch<int32_t>(x, out, B, Hq, Wq, N, stream);
    case 2: return launch<float>(x, out, B, Hq, Wq, N, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
