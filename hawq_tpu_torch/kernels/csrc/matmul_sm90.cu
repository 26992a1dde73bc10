// int8 matmul returning the int32 accumulator + bias on the Hopper-native
// core (gemm_s8_sm90.cuh: TMA ring, mbarriers, wgmma).
//
// Replaces hawq_tpu/kernels/matmul.py int8_matmul_acc (matmul.py:189) for
// the shapes the core takes (kernels/matmul.py sm90_route); the others, and
// the requant and int4 forms, stay on matmul.cu.  Bound on the H100 by its
// int32 stores (4 M N of its M K + K N + 4 M N bytes): the tile leaves
// through shared memory in whole 128-byte lines.  x is (M, K) row-major; the
// weights arrive as the map of their prepared (N, Kpad) K-major copy.
#include "gemm_s8_sm90.cuh"

// Encodes the tensor map of prepared weights wt (N, Kpad) for BK x BN boxes
// into the 128 bytes at map_out.
extern "C" int hawq_sm90_weight_map(void* map_out, const int8_t* wt, int N,
                                    int Kpad, int bk, int bn) {
  CUtensorMap map;
  int code = hawq_sm90::encode_weight_map(&map, wt, N, Kpad, bk, bn);
  if (code == 0) std::memcpy(map_out, &map, sizeof(map));
  return code;
}

extern "C" int hawq_int8_matmul_sm90(const int8_t* x, const void* wmap_bytes,
                                     const int32_t* bias, int32_t* out, int M,
                                     int K, int N, int bk, int bn,
                                     int smem_extra, cudaStream_t stream) {
  using namespace hawq_sm90;
  CUtensorMap amap, wmap, omap;
  std::memcpy(&wmap, wmap_bytes, sizeof(wmap));
  {
    const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)M};
    const cuuint64_t strides[1] = {(cuuint64_t)K};
    const cuuint32_t box[2] = {(cuuint32_t)bk, (cuuint32_t)BM};
    int code = encode_map(&amap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, x, dims,
                          strides, box, k_swizzle(bk));
    if (code) return code;
  }
  {
    const cuuint64_t dims[2] = {(cuuint64_t)N, (cuuint64_t)M};
    const cuuint64_t strides[1] = {(cuuint64_t)N * 4};
    const cuuint32_t box[2] = {32, (cuuint32_t)BM};
    int code = encode_map(&omap, CU_TENSOR_MAP_DATA_TYPE_INT32, 2, out, dims,
                          strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
    if (code) return code;
  }
  Args p{};
  p.bias = bias;
  p.N = N;
  p.k_tiles = (K + bk - 1) / bk;
  dim3 grid((M + BM - 1) / BM, (N + bn - 1) / bn);
  return launch<false, false>(amap, wmap, omap, p, grid, bk, bn, smem_extra,
                              stream);
}
