// int8 matmul with fused bias + dyadic requant (or int32 accumulator)
// epilogue, with int8 or nibble-packed int4 weights.
//
// Replaces hawq_tpu/kernels/matmul.py int8_matmul_requant (matmul.py:68),
// int8_matmul_acc (matmul.py:189), int4w_matmul_requant (matmul.py:134) and
// int4w_matmul_acc (matmul.py:234).  Bound on the H100: the 1x1 convs of
// ResNet-50 at batch 8 do 2*M*K*N int8 operations over M*K + K*N + M*N
// (requant) or 4*M*N (acc) bytes; most of them sit near or below the card's
// ridge (~590 int8 ops per byte), so bytes bound them and the epilogue's
// fusion (the int32 accumulator never reaches device memory on the requant
// path) is what the design keeps.  With int4 weights the weight term is
// K/2*N bytes while the operations stay 2*M*K*N over the unpacked K: the
// weights leave device memory packed and are unpacked to int8 in the W
// loader, so the stage-4 layers, where the weights dominate the bytes at
// batch 8, read half of them.  The core is gemm_s8.cuh.
#include "gemm_s8.cuh"

extern "C" int hawq_int8_matmul(const int8_t* x, const int8_t* w,
                                const int32_t* bias, const float* mult,
                                void* out, int M, int K, int N, int lo, int hi,
                                int requant, int int4, int vec_a, int vec_b,
                                cudaStream_t stream) {
  hawq::GemmArgs p{};
  p.a = x;
  p.w = w;
  p.bias = bias;
  p.mult = mult;
  p.out = out;
  p.M = M;
  p.N = N;
  p.K = K;
  p.C = K;        // int4: one split-K block over the whole of K
  p.lo = lo;
  p.hi = hi;
  p.vec_a = vec_a;
  p.vec_b = vec_b;
  return hawq::launch_gemm_s8<false>(p, requant, int4, stream);
}
