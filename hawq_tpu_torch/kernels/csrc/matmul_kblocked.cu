// int8 matmul with K accumulated in pieces and one requant at the end.
//
// Replaces hawq_tpu/kernels/matmul.py int8_matmul_requant_kblocked
// (matmul.py:322, _int8_kblocked_kernel :299).  The TPU kernel walks K as
// the last, sequential grid dimension, adds each K block's product into an
// int32 scratch that stays in fast memory, and requantizes on the last K
// step.  Blocks on Hopper run in parallel and share no scratch, so the same
// decomposition becomes split-K: grid (M tiles, N tiles, K splits); each
// block runs the gemm_s8.cuh tile loop over its K range and adds its int32
// partial into a zeroed (M, N) int32 workspace with atomicAdd (integer adds
// commute, so the sum is exact whatever the order); a counter per output
// tile tells the last block to arrive, which reads the tile's sums back,
// adds the bias and applies the requant epilogue once.  With one split the
// block requantizes from its registers and the workspace is not touched.
// (A second form, measured on the H100, wrote each split's partial tile to
// its own workspace slice with plain stores and let the last block sum the
// slices: no atomics and no (M, N) memset, yet 1.3-1.5x slower than this
// one on the split shapes, so the atomics stay.)
//
// Bound on the H100: as int8_matmul_requant, M*K + K*N + M*N bytes against
// 2*M*K*N int8 operations.  What the split buys is blocks: the stage-4
// shapes of ResNet-50 at batch 8 (M = 392) have 28 to 56 output tiles for
// 132 SMs, and K = 512..2048 to split.  What it costs is the workspace
// traffic (8 bytes per output and split, mostly in L2), which the bound
// does not count; measured, the cost outweighs the gain at these shapes.
#include "gemm_s8.cuh"

namespace hawq {

// ws: M*N int32 sums, then one arrival counter per output tile; all zero at
// launch.
__global__ void __launch_bounds__(THREADS)
gemm_s8_splitk_kernel(const GemmArgs p, int32_t* ws, int tiles_per_split) {
  __shared__ __align__(16) uint8_t As[BM * LDS];
  __shared__ __align__(16) uint8_t Bs[BN * LDS];
  __shared__ int is_last;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int g = lane >> 2, t4 = lane & 3;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int k_begin = blockIdx.z * tiles_per_split * BK;
  const int k_end = min(p.K, k_begin + tiles_per_split * BK);
  const bool split = gridDim.z > 1;

  int32_t acc[2][4][4];
  gemm_s8_mainloop<false, false>(p, m0, n0, k_begin, k_end, As, Bs, acc);

  if (split) {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          int m = m0 + wm * 32 + mi * 16 + g + (r >> 1) * 8;
          int n = n0 + wn * 32 + ni * 8 + t4 * 2 + (r & 1);
          if (m < p.M && n < p.N)
            atomicAdd(ws + (long long)m * p.N + n, acc[mi][ni][r]);
        }
    __threadfence();              // this block's sums before its arrival
    __syncthreads();
    if (threadIdx.x == 0) {
      int32_t* counter = ws + (long long)p.M * p.N
                         + blockIdx.y * gridDim.x + blockIdx.x;
      is_last = atomicAdd(counter, 1) == (int)gridDim.z - 1;
    }
    __syncthreads();
    if (!is_last) return;
    __threadfence();              // the other blocks' sums before the reads
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        int m = m0 + wm * 32 + mi * 16 + g + (r >> 1) * 8;
        int n = n0 + wn * 32 + ni * 8 + t4 * 2 + (r & 1);
        if (m >= p.M || n >= p.N) continue;
        long long o = (long long)m * p.N + n;
        int32_t v = (split ? __ldcg(ws + o) : acc[mi][ni][r]) + p.bias[n];
        static_cast<int8_t*>(p.out)[o] = requant_s8(v, p.mult[n], p.lo, p.hi);
      }
}

}  // namespace hawq

// splits >= 1 pieces of K, each a whole number of 64-wide K tiles; ws holds
// M*N + tiles_m*tiles_n zeroed int32 values when splits > 1 (unused, may be
// null, when splits == 1).
extern "C" int hawq_int8_matmul_kblocked(const int8_t* x, const int8_t* w,
                                         const int32_t* bias,
                                         const float* mult, int8_t* out,
                                         int32_t* ws, int M, int K, int N,
                                         int lo, int hi, int splits, int vec_a,
                                         int vec_b, cudaStream_t stream) {
  using namespace hawq;
  GemmArgs p{};
  p.a = x;
  p.w = w;
  p.bias = bias;
  p.mult = mult;
  p.out = out;
  p.M = M;
  p.N = N;
  p.K = K;
  p.C = K;
  p.lo = lo;
  p.hi = hi;
  p.vec_a = vec_a;
  p.vec_b = vec_b;
  int k_tiles = (K + BK - 1) / BK;
  if (splits < 1 || splits > k_tiles) return (int)cudaErrorInvalidValue;
  int tiles_per_split = (k_tiles + splits - 1) / splits;
  // no empty split: the last one starts inside K
  int z = (k_tiles + tiles_per_split - 1) / tiles_per_split;
  if (z > 1 && ws == nullptr) return (int)cudaErrorInvalidValue;
  dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN, z);
  gemm_s8_splitk_kernel<<<grid, THREADS, 0, stream>>>(p, ws, tiles_per_split);
  return (int)cudaGetLastError();
}
