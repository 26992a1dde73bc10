// Stride-1 implicit-GEMM convolution with nibble-packed int4 weights and
// fused bias + dyadic requant on the Hopper-native core (gemm_s8_sm90.cuh,
// its INT4 form: the packed weights stream through the TMA ring and are
// unpacked to int8 in shared memory by the consumer warps).
//
// Replaces hawq_tpu/kernels/conv.py int4w_conv_requant (conv.py:254, the int4
// branch of _tap_dot) for the shapes the core takes (kernels/matmul.py
// sm90_route); the others, and int4w_conv_acc, stay on conv.cu.  Bound on
// the H100 like the int8 conv (operations at C >= 128, bytes at C = 64) with
// half the weight bytes.  The weights arrive as the map of their
// prepare_weights_int4 handle (N, taps*Cpad/2); the other arguments are
// those of hawq_sm90::conv_requant_entry.
#include "gemm_s8_sm90.cuh"

extern "C" int hawq_int4w_conv_sm90(const int8_t* xp, const void* wmap_bytes,
                                    const int32_t* bias, const float* mult,
                                    int8_t* out, int B, int H, int W, int C,
                                    int kh, int kw, int N, int lo, int hi,
                                    int cpad, int bk, int bn, int th, int tw,
                                    int pad_h, int pad_w, int smem_extra,
                                    cudaStream_t stream) {
  return hawq_sm90::conv_requant_entry<true>(
      xp, wmap_bytes, bias, mult, out, B, H, W, C, kh, kw, N, lo, hi, cpad, bk,
      bn, th, tw, pad_h, pad_w, smem_extra, stream);
}
