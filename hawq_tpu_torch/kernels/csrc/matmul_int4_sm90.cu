// Matmuls with nibble-packed int4 weights on the Hopper-native core
// (gemm_s8_sm90.cuh, its INT4 form: the packed weights stream through the
// TMA ring and are unpacked to int8 in shared memory by the consumer warps),
// with fused bias + dyadic requant, or returning the int32 accumulator + bias.
//
// hawq_int4w_matmul_sm90 replaces hawq_tpu/kernels/matmul.py
// int4w_matmul_requant (matmul.py:134): bound on the H100 by its bytes
// (M K + K N / 2 + M N).  hawq_int4w_matmul_acc_sm90 replaces
// int4w_matmul_acc (matmul.py:234): bound by its bytes, of which the int32
// output is most; it leaves in whole 128-byte lines through TMA.  Both take
// every shape with an even K (kernels/matmul.py sm90_operands pads what TMA
// cannot read as it is).  x is (M, K) row-major; the weights arrive as the
// map of their prepare_weights_int4 handle (N, Kpad / 2); bm is the rows
// of a block's tile, 64 or 128 (two consumer warpgroups that share each
// unpacked B tile); the other arguments are those of the int8 entry points.
#include "gemm_s8_sm90.cuh"

extern "C" int hawq_int4w_matmul_sm90(const int8_t* x, const void* wmap_bytes,
                                      const int32_t* bias, const float* mult,
                                      int8_t* out, int M, int K, int N, int lo,
                                      int hi, int bk, int bn, int bm,
                                      int smem_extra, cudaStream_t stream) {
  return hawq_sm90::matmul_entry<true, true>(x, wmap_bytes, bias, mult, out, M,
                                             K, N, lo, hi, bk, bn, bm,
                                             smem_extra, stream);
}

extern "C" int hawq_int4w_matmul_acc_sm90(const int8_t* x,
                                          const void* wmap_bytes,
                                          const int32_t* bias, int32_t* out,
                                          int M, int K, int N, int bk, int bn,
                                          int bm, int smem_extra,
                                          cudaStream_t stream) {
  return hawq_sm90::matmul_entry<false, true>(x, wmap_bytes, bias, nullptr,
                                              out, M, K, N, 0, 0, bk, bn, bm,
                                              smem_extra, stream);
}
