// int8 matmul returning the int32 accumulator + bias on the Hopper-native
// core (gemm_s8_sm90.cuh: TMA ring, mbarriers, wgmma).
//
// Replaces hawq_tpu/kernels/matmul.py int8_matmul_acc (matmul.py:189) at
// every shape (kernels/matmul.py sm90_operands pads what TMA cannot read as
// it is).  Bound on the H100 by its int32 stores (4 M N of its
// M K + K N + 4 M N bytes): the tile leaves through shared memory in whole
// 128-byte lines.  x is (M, K) row-major; the
// weights arrive as the map of their prepared (N, Kpad) K-major copy.
//
// hawq_int8_matmul_residual_sm90 is the same matmul with the residual
// epilogue (gemm_s8_sm90.cuh RESIDUAL): the bottleneck's last 1x1 conv
// leaves as the unit's int32 carrier,
//
//   out = max(int32(round(acc + bias, mult) + round(identity, mult_id)), 0)
//
// the engine's requant-add and ReLU (quant/ops.py requant_add_int32), which
// hawq_tpu runs as XLA ops after int8_matmul_acc.  It reads the identity
// (M, N) int32 in place of writing and re-reading the accumulator.
//
// hawq_int8_matmul_residual_requant_sm90 also leaves as the next unit's
// entry requant of that carrier (gemm_s8_sm90.cuh ENTRY),
//
//   entry = clip(floor(f32(out) * mult_in + 0.5), lo, hi) as int8,
//
// one scalar mult_in, the standalone requant's op order (requant.cu), so
// that the next unit reads one byte an element of it in place of the
// carrier's four.  With out null the carrier is not stored: the engine
// passes that where the next unit takes its identity from its own conv and
// no capture reads the carrier.
#include "gemm_s8_sm90.cuh"

// Encodes the tensor map of prepared weights wt, N rows of row_bytes, for
// boxes of box_bytes x bn, into the 128 bytes at map_out.
extern "C" int hawq_sm90_weight_map(void* map_out, const int8_t* wt, int N,
                                    int row_bytes, int box_bytes, int bn) {
  CUtensorMap map;
  int code = hawq_sm90::encode_weight_map(&map, wt, N, row_bytes, box_bytes,
                                          bn);
  if (code == 0) std::memcpy(map_out, &map, sizeof(map));
  return code;
}

extern "C" int hawq_int8_matmul_sm90(const int8_t* x, const void* wmap_bytes,
                                     const int32_t* bias, int32_t* out, int M,
                                     int K, int N, int bk, int bn,
                                     int smem_extra, cudaStream_t stream) {
  return hawq_sm90::matmul_entry<false, false>(x, wmap_bytes, bias, nullptr,
                                               out, M, K, N, 0, 0, bk, bn,
                                               hawq_sm90::BM, smem_extra,
                                               stream);
}

extern "C" int hawq_int8_matmul_residual_sm90(
    const int8_t* x, const void* wmap_bytes, const int32_t* bias,
    const float* mult, const int32_t* identity, const float* mult_id,
    int32_t* out, int M, int K, int N, int bk, int bn, int smem_extra,
    cudaStream_t stream) {
  return hawq_sm90::matmul_entry<false, false, true>(
      x, wmap_bytes, bias, mult, out, M, K, N, 0, 0, bk, bn, hawq_sm90::BM,
      smem_extra, stream, identity, mult_id);
}

extern "C" int hawq_int8_matmul_residual_requant_sm90(
    const int8_t* x, const void* wmap_bytes, const int32_t* bias,
    const float* mult, const int32_t* identity, const float* mult_id,
    const float* mult_in, int32_t* out, int8_t* entry, int M, int K, int N,
    int lo, int hi, int bk, int bn, int smem_extra, cudaStream_t stream) {
  return hawq_sm90::matmul_entry<false, false, true, true>(
      x, wmap_bytes, bias, mult, out, M, K, N, lo, hi, bk, bn, hawq_sm90::BM,
      smem_extra, stream, identity, mult_id, entry, mult_in);
}
