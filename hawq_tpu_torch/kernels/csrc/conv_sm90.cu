// Stride-1 implicit-GEMM int8 convolution with fused bias + dyadic requant
// on the Hopper-native core (gemm_s8_sm90.cuh: TMA ring, mbarriers, wgmma).
//
// Replaces hawq_tpu/kernels/conv.py int8_conv_requant (conv.py:228, through
// _conv_call / _conv_kernel / _tap_dot) for the shapes the core takes
// (kernels/matmul.py sm90_route); the others, and the accumulator forms,
// stay on conv.cu.  Bound on the H100 by its int8 operations at C >= 128 and
// by its bytes at C = 64.  The arguments are those of
// hawq_sm90::conv_requant_entry.
#include "gemm_s8_sm90.cuh"

extern "C" int hawq_int8_conv_sm90(const int8_t* xp, const void* wmap_bytes,
                                   const int32_t* bias, const float* mult,
                                   int8_t* out, int B, int H, int W, int C,
                                   int kh, int kw, int N, int lo, int hi,
                                   int cpad, int bk, int bn, int th, int tw,
                                   int pad_h, int pad_w, int smem_extra,
                                   cudaStream_t stream) {
  return hawq_sm90::conv_requant_entry<false>(
      xp, wmap_bytes, bias, mult, out, B, H, W, C, kh, kw, N, lo, hi, cpad, bk,
      bn, th, tw, pad_h, pad_w, smem_extra, stream);
}
