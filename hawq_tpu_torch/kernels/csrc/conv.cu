// Stride-1 implicit-GEMM int8 convolution with fused bias + dyadic requant
// (or int32 accumulator) epilogue.
//
// Replaces hawq_tpu/kernels/conv.py int8_conv_requant (conv.py:228) and
// int8_conv_acc (conv.py:243), both through _conv_call/_conv_kernel/_tap_dot.
// Input is the zero-padded (B, Hp, Wp*C) int8 slab of prepare_conv_input,
// weights the (kh*kw*C, N) flattened HWIO kernel; stride 2 is rewritten to
// stride 1 outside by space-to-depth.  The GEMM view is M = B*H*W output
// pixels, K = kh*kw*C, N: each A row is gathered tap by tap from the slab
// (no im2col tensor in device memory).  Bound on the H100: the 3x3 convs of
// ResNet-50 at batch 8 do 2*M*K*N int8 operations over B*Hp*Wp*C + K*N +
// M*N bytes, 64 to 260 ops per byte, below the card's ridge, so bytes bound
// them; the requant epilogue is fused so that only int8 leaves the kernel.
// The core is gemm_s8.cuh.
#include "gemm_s8.cuh"

extern "C" int hawq_int8_conv(const int8_t* xp, const int8_t* w,
                              const int32_t* bias, const float* mult,
                              void* out, int B, int H, int W, int C, int kh,
                              int kw, int N, int lo, int hi, int requant,
                              int vec_a, int vec_b, cudaStream_t stream) {
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
  return hawq::launch_gemm_s8<true>(p, requant, stream);
}
