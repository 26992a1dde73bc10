// int8 matmul with fused bias + dyadic requant on the Hopper-native core
// (gemm_s8_sm90.cuh: TMA ring, mbarriers, wgmma).
//
// Replaces hawq_tpu/kernels/matmul.py int8_matmul_requant (matmul.py:68) at
// every shape (kernels/matmul.py sm90_operands pads a K, an N or a pointer
// that is not a multiple of 16 first).  Bound on the H100 by its bytes
// (M K + K N + M N).  x is (M, K) row-major; the weights arrive
// as the map of their prepared (N, Kpad) K-major copy; the int8 tile leaves
// through shared memory as one dense 64 x BN TMA box.
//
// The same entry runs hawq_tpu/kernels/matmul.py int8_matmul_requant_kblocked
// (matmul.py:322) on this core: its K accumulated on chip, one requant at
// the end, is what one block's K loop does here.
#include "gemm_s8_sm90.cuh"

extern "C" int hawq_int8_matmul_requant_sm90(
    const int8_t* x, const void* wmap_bytes, const int32_t* bias,
    const float* mult, int8_t* out, int M, int K, int N, int lo, int hi,
    int bk, int bn, int smem_extra, cudaStream_t stream) {
  return hawq_sm90::matmul_entry<true, false>(x, wmap_bytes, bias, mult, out,
                                              M, K, N, lo, hi, bk, bn,
                                              hawq_sm90::BM, smem_extra,
                                              stream);
}
