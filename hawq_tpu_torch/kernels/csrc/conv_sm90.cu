// Stride-1 implicit-GEMM int8 convolution with fused bias + dyadic requant
// on the Hopper-native core (gemm_s8_sm90.cuh: TMA ring, mbarriers, wgmma).
//
// Replaces hawq_tpu/kernels/conv.py int8_conv_requant (conv.py:228, through
// _conv_call / _conv_kernel / _tap_dot) for the shapes the core takes
// (kernels/matmul.py sm90_route); the others, and the accumulator and int4
// forms, stay on conv.cu.  Bound on the H100 by its int8 operations at
// C >= 128 and by its bytes at C = 64.  xp is the zero-padded (B, Hp, Wp*C)
// slab, or, with pad_h / pad_w, the activations that lack that many rows /
// columns of zero border on each side, which TMA then supplies; the weights
// arrive as the map of their prepared (N, taps*Cpad)
// K-major copy; an M tile is a th x tw rectangle of output pixels, so that
// every tap of it is one 4-D TMA box of the slab.
#include "gemm_s8_sm90.cuh"

extern "C" int hawq_int8_conv_sm90(const int8_t* xp, const void* wmap_bytes,
                                   const int32_t* bias, const float* mult,
                                   int8_t* out, int B, int H, int W, int C,
                                   int kh, int kw, int N, int lo, int hi,
                                   int cpad, int bk, int bn, int th, int tw,
                                   int pad_h, int pad_w, int smem_extra,
                                   cudaStream_t stream) {
  using namespace hawq_sm90;
  if (th * tw != BM) return (int)cudaErrorInvalidValue;
  const int Hp = H + kh - 1 - 2 * pad_h, Wp = W + kw - 1 - 2 * pad_w;
  CUtensorMap amap, wmap, omap;
  std::memcpy(&wmap, wmap_bytes, sizeof(wmap));
  {
    const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)Wp, (cuuint64_t)Hp,
                                (cuuint64_t)B};
    const cuuint64_t strides[3] = {(cuuint64_t)C, (cuuint64_t)Wp * C,
                                   (cuuint64_t)Hp * Wp * C};
    const cuuint32_t box[4] = {(cuuint32_t)bk, (cuuint32_t)tw, (cuuint32_t)th,
                               1};
    int code = encode_map(&amap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, xp, dims,
                          strides, box, k_swizzle(bk));
    if (code) return code;
  }
  {
    const cuuint64_t dims[4] = {(cuuint64_t)N, (cuuint64_t)W, (cuuint64_t)H,
                                (cuuint64_t)B};
    const cuuint64_t strides[3] = {(cuuint64_t)N, (cuuint64_t)W * N,
                                   (cuuint64_t)H * W * N};
    const cuuint32_t box[4] = {(cuuint32_t)bn, (cuuint32_t)tw, (cuuint32_t)th,
                               1};
    int code = encode_map(&omap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, out, dims,
                          strides, box, CU_TENSOR_MAP_SWIZZLE_NONE);
    if (code) return code;
  }
  Args p{};
  p.bias = bias;
  p.mult = mult;
  p.N = N;
  p.lo = lo;
  p.hi = hi;
  p.kw = kw;
  p.chunks = cpad / bk;
  p.cpad = cpad;
  p.k_tiles = kh * kw * p.chunks;
  p.tiles_x = (W + tw - 1) / tw;
  p.tiles_y = (H + th - 1) / th;
  p.th = th;
  p.tw = tw;
  p.pad_y = pad_h;
  p.pad_x = pad_w;
  dim3 grid(B * p.tiles_x * p.tiles_y, (N + bn - 1) / bn);
  return launch<true, true>(amap, wmap, omap, p, grid, bk, bn, smem_extra,
                            stream);
}
