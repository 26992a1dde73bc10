// Stride-1 implicit-GEMM convolution with fused bias + dyadic requant (or
// int32 accumulator) epilogue, with int8 or nibble-packed int4 weights.
//
// Replaces hawq_tpu/kernels/conv.py int8_conv_requant (conv.py:228),
// int8_conv_acc (conv.py:243), int4w_conv_requant (conv.py:254) and
// int4w_conv_acc (conv.py:265), all through _conv_call/_conv_kernel/_tap_dot
// (the int4 branch at conv.py:150-159).  Input is the zero-padded
// (B, Hp, Wp*C) int8 slab of prepare_conv_input, weights the (kh*kw*C, N)
// flattened HWIO kernel, or its per-tap split-C packing (kh*kw*C/2, N) for
// int4; stride 2 is rewritten to stride 1 outside by space-to-depth.  The
// GEMM view is M = B*H*W output pixels, K = kh*kw*C, N: each A row is
// gathered tap by tap from the slab (no im2col tensor in device memory).
// Bound on the H100: the stride-1 3x3 convs of ResNet-50 at batch 8 do
// 2*M*K*N int8 operations over B*Hp*Wp*C + K*N + M*N bytes, about 550 to
// 1200 ops per byte, around and above the card's ridge (~590), so
// operations bound them summed over the forward; the folded init conv
// (C = 48, N = 256) is bound by its bytes.  The requant epilogue is fused so
// that only int8 leaves the kernel; int4 weights are read packed (K/2*N
// bytes) and unpacked in the W loader, the operations counted over the
// unpacked K.  The core is gemm_s8.cuh.  All four kernels run on the
// Hopper-native core (conv_sm90.cu, conv_int4_sm90.cu) wherever
// kernels/matmul.py sm90_route takes the call; this file keeps the others.
#include "gemm_s8.cuh"

extern "C" int hawq_int8_conv(const int8_t* xp, const int8_t* w,
                              const int32_t* bias, const float* mult,
                              void* out, int B, int H, int W, int C, int kh,
                              int kw, int N, int lo, int hi, int requant,
                              int int4, int vec_a, int vec_b,
                              cudaStream_t stream) {
  hawq::GemmArgs p{};
  p.a = xp;
  p.w = w;
  p.bias = bias;
  p.mult = mult;
  p.out = out;
  p.M = B * H * W;
  p.N = N;
  p.K = kh * kw * C;
  p.H = H;
  p.W = W;
  p.C = C;
  p.kw = kw;
  p.Hp = H + kh - 1;
  p.Wp = W + kw - 1;
  p.lo = lo;
  p.hi = hi;
  p.vec_a = vec_a;
  p.vec_b = vec_b;
  return hawq::launch_gemm_s8<true>(p, requant, int4, stream);
}
