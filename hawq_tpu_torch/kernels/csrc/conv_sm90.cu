// Stride-1 implicit-GEMM int8 convolution on the Hopper-native core
// (gemm_s8_sm90.cuh: TMA ring, mbarriers, wgmma), with fused bias + dyadic
// requant, or returning the int32 accumulator + bias.
//
// hawq_int8_conv_sm90 replaces hawq_tpu/kernels/conv.py int8_conv_requant
// (conv.py:228, through _conv_call / _conv_kernel / _tap_dot): bound on the
// H100 by its int8 operations at C >= 128 and by its bytes at C = 64.
// hawq_int8_conv_acc_sm90 replaces int8_conv_acc (conv.py:243, the same
// kernel with acc_only): bound by its bytes, of which the int32 output is
// most (4 bytes per output against 1 per input); the tile leaves through
// shared memory and TMA in whole 128-byte lines.  Both take every shape:
// the wrapper zero-pads a slab whose C, or an output whose N, misses TMA's
// 16 bytes first (kernels/matmul.py sm90_operands).  The arguments are
// those of hawq_sm90::conv_entry.
#include "gemm_s8_sm90.cuh"

extern "C" int hawq_int8_conv_sm90(const int8_t* xp, const void* wmap_bytes,
                                   const int32_t* bias, const float* mult,
                                   int8_t* out, int B, int H, int W, int C,
                                   int kh, int kw, int N, int lo, int hi,
                                   int row_taps, int cpad, int bk, int bn,
                                   int th, int tw, int pad_h, int pad_w,
                                   int smem_extra, cudaStream_t stream) {
  return hawq_sm90::conv_entry<true, false>(
      xp, wmap_bytes, bias, mult, out, B, H, W, C, kh, kw, N, lo, hi,
      row_taps, cpad, bk, bn, th, tw, pad_h, pad_w, smem_extra, stream);
}

extern "C" int hawq_int8_conv_acc_sm90(const int8_t* xp,
                                       const void* wmap_bytes,
                                       const int32_t* bias, int32_t* out,
                                       int B, int H, int W, int C, int kh,
                                       int kw, int N, int row_taps, int cpad,
                                       int bk, int bn, int th, int tw,
                                       int pad_h, int pad_w, int smem_extra,
                                       cudaStream_t stream) {
  return hawq_sm90::conv_entry<false, false>(
      xp, wmap_bytes, bias, nullptr, out, B, H, W, C, kh, kw, N, 0, 0,
      row_taps, cpad, bk, bn, th, tw, pad_h, pad_w, smem_extra, stream);
}
