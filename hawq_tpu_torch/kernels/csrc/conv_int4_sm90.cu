// Stride-1 implicit-GEMM convolution with nibble-packed int4 weights on the
// Hopper-native core (gemm_s8_sm90.cuh, its INT4 form: the packed weights
// stream through the TMA ring and are unpacked to int8 in shared memory by
// the consumer warps), with fused bias + dyadic requant, or returning the
// int32 accumulator + bias.
//
// hawq_int4w_conv_sm90 replaces hawq_tpu/kernels/conv.py int4w_conv_requant
// (conv.py:254, the int4 branch of _tap_dot): bound on the H100 like the
// int8 conv (operations at C >= 128, bytes at C = 64) with half the weight
// bytes.  hawq_int4w_conv_acc_sm90 replaces int4w_conv_acc (conv.py:265):
// bound by its bytes, of which the int32 output is most; it leaves in whole
// 128-byte lines through TMA.  Both take every shape with an even C
// (kernels/matmul.py sm90_operands pads what TMA cannot read as it is).
// The weights arrive as the map of their
// prepare_weights_int4 handle (N, taps*Cpad/2); the other arguments are
// those of hawq_sm90::conv_entry.
#include "gemm_s8_sm90.cuh"

extern "C" int hawq_int4w_conv_sm90(const int8_t* xp, const void* wmap_bytes,
                                    const int32_t* bias, const float* mult,
                                    int8_t* out, int B, int H, int W, int C,
                                    int kh, int kw, int N, int lo, int hi,
                                    int row_taps, int cpad, int bk, int bn,
                                    int th, int tw, int pad_h, int pad_w,
                                    int smem_extra, cudaStream_t stream) {
  return hawq_sm90::conv_entry<true, true>(
      xp, wmap_bytes, bias, mult, out, B, H, W, C, kh, kw, N, lo, hi,
      row_taps, cpad, bk, bn, th, tw, pad_h, pad_w, smem_extra, stream);
}

extern "C" int hawq_int4w_conv_acc_sm90(const int8_t* xp,
                                        const void* wmap_bytes,
                                        const int32_t* bias, int32_t* out,
                                        int B, int H, int W, int C, int kh,
                                        int kw, int N, int row_taps,
                                        int cpad, int bk, int bn, int th,
                                        int tw, int pad_h, int pad_w,
                                        int smem_extra, cudaStream_t stream) {
  return hawq_sm90::conv_entry<false, true>(
      xp, wmap_bytes, bias, nullptr, out, B, H, W, C, kh, kw, N, 0, 0,
      row_taps, cpad, bk, bn, th, tw, pad_h, pad_w, smem_extra, stream);
}
