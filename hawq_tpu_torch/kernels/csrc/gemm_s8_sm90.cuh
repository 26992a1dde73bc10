// Hopper-native int8 GEMM core: TMA loads into a swizzled shared-memory ring,
// mbarrier hand-over between one producer warp and one consumer warpgroup,
// wgmma s8*s8->s32 from shared memory, and an epilogue that leaves through
// shared memory and TMA stores.
//
//   out[m, n] = epilogue(sum_k A[m, k] * W[k, n] + bias[n])
//
// the port's one integer GEMM core, for every conv and matmul kernel:
//
//  * int8_conv_requant (CONV, REQUANT): replaces hawq_tpu/kernels/conv.py
//    int8_conv_requant (conv.py:228, through _conv_call / _conv_kernel /
//    _tap_dot).  On the H100 the 3x3 convs of stages 2-4 are bound by their
//    int8 operations (550-1200 ops per byte against a ridge of ~590), the
//    C = 64 convs of stage 1 by their bytes; an earlier mma.sync core was
//    held 45x above that bound by one shared-memory stage, two
//    __syncthreads per 64-deep K step, mma.sync fed by 4-byte shared loads,
//    and a 4x4 byte transpose of W by every block on every K tile.
//  * int8_matmul_acc (!CONV, !REQUANT): replaces hawq_tpu/kernels/matmul.py
//    int8_matmul_acc (matmul.py:189).  Its int32 output is nine tenths of its
//    bytes, so its stores bound it; that core stored 4 bytes per lane with
//    an 8-byte lane stride.
//  * int8_matmul_acc_residual (!CONV, !REQUANT, RESIDUAL): the bottleneck's
//    last 1x1 conv with the unit's residual requant-add and ReLU in its
//    epilogue, so that it leaves as the int32 carrier and its accumulator
//    never reaches device memory (see "Residual epilogue" below); with
//    ENTRY (int8_matmul_acc_residual_requant, int8_matmul_residual_requant)
//    it also leaves as the next unit's int8 entry requant of that carrier,
//    and stores the carrier only where something reads it.
//  * int8_matmul_requant (!CONV, REQUANT): replaces hawq_tpu/kernels/matmul.py
//    int8_matmul_requant (matmul.py:68), the first 1x1 conv of every
//    bottleneck unit.  Bound by its bytes (M K + K N + M N); the matmul
//    producer and the conv's int8 epilogue, with a 2-D output map.
//  * int4w_conv_requant (CONV, REQUANT, INT4): replaces hawq_tpu/kernels/conv.py
//    int4w_conv_requant (conv.py:254, the int4 branch of _tap_dot).  Same
//    bounds as the int8 conv with half the weight bytes.  wgmma has no 4-bit
//    integer type, so the weights stream nibble-packed through the ring and
//    are unpacked to int8 inside the kernel (see "Packed weights" below).
//  * int8_conv_acc (CONV, !REQUANT) and int4w_conv_acc (CONV, !REQUANT,
//    INT4): replace hawq_tpu/kernels/conv.py int8_conv_acc (conv.py:243) and
//    int4w_conv_acc (conv.py:265): the engine's init conv, the second 3x3
//    conv of a basic block, every k x k conv of the QAT forward.  Bound by
//    their bytes: the int32 output is 4 bytes per output against 1 per
//    input.  The conv producer with int8_matmul_acc's epilogue, stored
//    through a 4-D int32 map in whole 128-byte lines.
//  * int4w_matmul_requant (!CONV, REQUANT, INT4) and int4w_matmul_acc
//    (!CONV, !REQUANT, INT4): replace hawq_tpu/kernels/matmul.py
//    int4w_matmul_requant (matmul.py:134) and int4w_matmul_acc
//    (matmul.py:234), the 1x1 convs of a bottleneck whose weights are 4-bit.
//    Bound by their bytes like their int8 twins (M K + K N / 2 + M N for the
//    requant, the int32 output for the accumulator), with half the weight
//    bytes: the matmul producer loads the packed box at column kt * BK / 2,
//    and the consumers unpack it as for the conv.
//  * int8_matmul_requant_kblocked: replaces hawq_tpu/kernels/matmul.py
//    int8_matmul_requant_kblocked (matmul.py:322) as the int8_matmul_requant
//    form itself.  The TPU kernel keeps its int32 accumulator in on-chip
//    scratch across a sequential K grid and requantizes at the last K step;
//    here one block's register accumulators walk the whole K through the
//    ring and requantize once: no split-K workspace.
//
// What the design does about that:
//
//  * wgmma.mma_async m64nBNk32 s8*s8->s32 (exact int32), BN in {32, 64, 128},
//    accumulators in registers.  For 8-bit operands wgmma reads both A and B
//    K-major from shared memory, so W is laid out once, outside the kernel,
//    as (N, taps * Cpad) K-major with every tap's C channels zero-padded to
//    Cpad, a multiple of 64 (prepare_weights in kernels/matmul.py): no
//    transpose in the kernel.
//  * A ring of STAGES = 4 stages of (64 + BN) * BK bytes ((64 + BN / 2) * BK
//    with packed weights) in dynamic shared memory, BK = 128 bytes (128-byte swizzle) where Cpad is a multiple of
//    128, else 64 (64-byte swizzle).  (A deeper ring was tried on the H100
//    and was no faster at any ResNet-50 shape, and slower where it cost
//    resident blocks: one block alone takes in a 12 KB stage per 0.16 us,
//    78 GB/s (chip_sweep_sm90.py), which is the SM's rate, not the ring's.)
//    The lane 0 of the warp after the consumers' is the producer: it
//    waits on empty[s], arms full[s] with the stage's bytes and starts two
//    TMA tensor loads; the consumer warps wait on full[s], start the
//    BK / 32 wgmmas of the stage, keep one wgmma group in flight and release
//    the previous stage through empty[s].  No __syncthreads in the K loop.
//  * Matmul A: a 2-D tensor map over x (M, K); ragged M and K are zero-filled
//    by TMA's out-of-bounds rule.  Conv A: an M tile is a th x tw rectangle of
//    output pixels of one image, th * tw = 64 (conv_tile_plan in
//    kernels/conv.py: 8x8 at 56x56, 14x14 and 7x7, 4x16 at 28x28), so tap
//    (dy, dx), channel chunk c0 is one box {BK, tw, th, 1} of a 4-D map over
//    the padded slab (B, Hp, Wp, C) at (c0, ox0 + dx, oy0 + dy, b): 64 K-major
//    rows with no division and no per-thread address.  Pixels of the
//    rectangle outside the image are computed on neighbouring or zero-filled
//    data and dropped by the store.  The map may also lie over the unpadded
//    activations (B, H, W, C): the box then starts at (ox0 + dx - pad_x,
//    oy0 + dy - pad_y), negative at the image's edge, and TMA's zero fill is
//    the conv's zero border, so that no padded copy is made first.
//  * Tensor maps are encoded on the host inside the C entry points
//    (cuTensorMapEncodeTiled through cudaGetDriverEntryPoint) and passed as
//    __grid_constant__ parameters; the weight map is encoded once per
//    prepared weight and tile width and handed in.
//  * The epilogue adds the bias (and requants with requant.cuh's requant_s8,
//    rounded multiply then rounded add) in registers, stages the tile in the
//    ring's shared memory, and one thread stores it with TMA: int32 tiles as
//    64 x 32 chunks in the 128-byte swizzle (conflict-free 8-byte shared
//    stores, whole 128-byte lines to device memory), int8 tiles as one dense
//    64 x BN box; rows and columns outside (M, N), or outside the image for
//    the conv's 4-D output map (B, H, W, N), are dropped by TMA.
//  * Enough blocks without a global workspace: one 64 x BN tile per block,
//    several blocks resident per SM (at most 96 KB of ring each), and the
//    wrapper narrows BN until the grid fills the card (sm90_tile_n in
//    kernels/matmul.py): stage 4 of ResNet-50 at batch 8 runs 8 x 16 tiles
//    of 64 x 32.  No split-K workspace, no cluster.
//
// Packed weights (INT4).  The handle (prepare_weights_int4 in
// kernels/matmul.py) is (N, taps * Cpad / 2) bytes, K-major like the int8
// handle; inside every BK-channel chunk, byte i holds channel c0 + i in its
// low nibble and channel c0 + BK/2 + i in its high nibble.  A ring stage is
// the A tile plus the BN x BK/2 packed tile (a 2-D box in the BK/2-byte
// swizzle).  After full[s] the four consumer warps read the packed tile 16
// bytes a thread (every load of a step before its first store), sign-extend
// the low and the high nibbles (two operations per word) into two whole
// 16-byte units of the int8 B tile - units u and u + BK/32 of the row: no
// byte shuffle, no transpose - and store them into one of two unpack buffers
// in the BK-byte swizzle that make_desc expects; both the loads and the
// stores are free of bank conflicts (eight lanes take eight consecutive rows
// of one unit).  Then fence.proxy.async (without it the wgmmas read stale
// bytes: seen on the H100), the wait for the previous stage's wgmma group,
// one bar.sync of the consumers, and the stage's wgmmas with A from the ring
// and B from the buffer.  The wait stands before the bar.sync so that every
// warp's group kt - 1 has finished before any warp, one iteration later,
// rewrites the buffer that group read: the unpack of stage kt overlaps the
// wgmmas of stage kt - 1.  The wrapper keeps BN at 64 or 32 for the packed
// conv (sm90_tile_n): what the unpack moves through shared memory grows with
// BN.  Every 64-row tile unpacks the whole weight matrix again, so the packed
// matmul may also run WG = 2 consumer warpgroups on a 128-row tile: all 256
// consumer threads unpack each B tile once into the shared buffer and both
// warpgroups issue their wgmmas on it, each on its own 64 rows of A (half
// the unpack work and weight bytes per output row, half the blocks).  On
// the H100 it is the faster where N >= 1024 (by up to 22 % at the ResNet-50
// shapes) and for a single K step on a large grid, slower elsewhere: the
// wrapper picks it there (sm90_tile_m), and the packed matmul's BN stops
// at 64 too.
// Tried on the H100 and dropped, each bit-equal and none faster over the
// 3x3 convs of ResNet-50 at batch 8: four dedicated unpack warps feeding the
// consumers through a second pair of mbarriers (two or three buffers), and
// the swapped product out^T = W^T X^T with the weights unpacked in registers
// as the wgmma A operand (no shared-memory round trip, but only 64-wide
// channel tiles, so half the blocks at 7x7 and 14x14).
//
// Residual epilogue (RESIDUAL, the int8 accumulator matmul only).  The
// identity, an int32 (M, N) tensor (the identity conv's accumulator or the
// previous carrier), is read through a map of the output's geometry into the
// staged chunks, which then lie at the end of the ring: the producer lane,
// after its last K tile, waits until every ring stage under them has been
// released for the last time (a K of at most four stages, every conv3 of
// ResNet-50, never fills the last ones, so the load starts at once) and
// loads the tile on an mbarrier of its own.  The consumers release the last
// stage too, wait for that barrier, and turn each staged identity value into
//
//   max(int32(round(acc + bias, mult) + round(identity, mult_id)), 0)
//
// in place (requant.cuh requant_add_relu: quant/ops.py requant_add_int32's
// float32 op order); the TMA store is the accumulator's.  Rows and columns
// outside (M, N) are neither read nor stored: the maps clip them.
//
// Entry requant (ENTRY, with RESIDUAL).  The next unit's entry requant reads
// the whole carrier back to write one byte an element; here each carrier
// value, still in registers, is also turned into
//
//   clip(floor(f32(carrier) * mult_in + 0.5), lo, hi)
//
// with one scalar mult_in (requant.cuh requant_s8, the op order of the
// standalone requant in requant.cu, so the bytes are its bytes): two
// requants in a row, kept as two.  The int8 tile is staged as one dense
// 64 x BN box at the ring's start, below the identity's chunks (the ring's
// front stages are free once the last K tile is consumed), and leaves
// through a second map, (M, N) int8, beside the carrier's store.  With
// carrier = 0 (the next unit takes its identity from its own conv, and no
// capture reads the carrier) the carrier is neither staged nor stored.
//
// Every row stride and base pointer handed in is a multiple of 16 bytes, as
// TMA needs: kernels/matmul.py sm90_operands zero-pads a call's operands to
// that first, so that this core takes every shape.  A failure here is
// returned to the caller.
#pragma once

#include <cstdint>
#include <cstring>

#include <cuda.h>
#include <cuda_runtime.h>

#include "requant.cuh"

namespace hawq_sm90 {

constexpr int BM = 64;                // rows of one consumer warpgroup's tile
constexpr int STAGES = 4;
constexpr int CONSUMER_THREADS = 128;  // one warpgroup
// threads of a block with WG consumer warpgroups and the producer warp
template <int WG>
__host__ __device__ constexpr int threads() {
  return WG * CONSUMER_THREADS + 32;
}
constexpr int ENCODE_ERROR = 10000;   // + CUresult, for a failed map encode

struct Args {
  const int32_t* bias;   // (N,)
  const float* mult;     // (N,), requant only
  int N;
  int k_tiles;           // BK-deep steps: taps * chunks for the conv
  int lo, hi;            // requant clip bounds
  int kw, chunks, cpad;  // conv: taps per row, BK chunks per tap, padded C
  int tiles_x, tiles_y;  // conv: th x tw pixel rectangles per image
  int th, tw;
  int pad_y, pad_x;      // conv: rows / columns of zero border that TMA supplies
};

// The epilogue's tensor maps: the output's, and with RESIDUAL the identity's
// (the output's geometry) and its multipliers; with ENTRY also the entry
// requant's output map and multiplier, and whether the carrier is stored.
// The kernels without a residual keep their one map where it was among the
// parameters.
template <bool RESIDUAL, bool ENTRY = false>
struct OutMaps {
  CUtensorMap out;
};

template <>
struct OutMaps<true, false> {
  CUtensorMap out;
  CUtensorMap identity;   // (M, N) int32
  const float* mult_id;   // (N,)
};

template <>
struct OutMaps<true, true> {
  CUtensorMap out;        // unused with carrier = 0
  CUtensorMap identity;   // (M, N) int32
  const float* mult_id;   // (N,)
  CUtensorMap entry;      // (M, N) int8
  const float* mult_in;   // one value
  int carrier;            // 0: the carrier is not stored
};

// ---------------------------------------------------------------------------
// PTX wrappers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Spin until the barrier's phase differs from ``parity``.  A wait that lasts
// four seconds means a load that never landed: trap, so that the launch
// fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  uint32_t spins = 0;
  unsigned long long t0 = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if ((++spins & 1023u) == 0) {
      unsigned long long now;
      asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(now));
      if (t0 == 0) t0 = now;
      if (now - t0 > 4000000000ull) __trap();
    }
  }
}

__device__ __forceinline__ void tma_prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(map) : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(map), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2,
                                            int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(map), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, uint32_t src,
                                             int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(map),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src,
                                             int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(map),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store_commit_and_wait() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

template <int WG>
__device__ __forceinline__ void consumer_sync() {   // the consumer warps
  asm volatile("bar.sync 1, %0;\n" ::"n"(WG * CONSUMER_THREADS) : "memory");
}

// Shared-memory matrix descriptor of a K-major tile whose rows are BK bytes,
// written by TMA in the BK-byte swizzle: 8-row groups 8 * BK bytes apart
// (SBO); the leading offset is unused for swizzled K-major tiles.  The tile
// base is 1024-byte aligned, so the base offset field is 0; a 32-byte K step
// inside the swizzle row is +2 on the (address >> 4) field.
template <int BK>
__device__ __forceinline__ uint64_t make_desc(uint32_t saddr) {
  constexpr uint64_t layout = BK == 128 ? 1 : 2;   // 128-byte / 64-byte swizzle
  constexpr uint64_t sbo = (8 * BK) >> 4;
  return static_cast<uint64_t>((saddr & 0x3FFFFu) >> 4) | (1ull << 16) |
         (sbo << 32) | (layout << 62);
}

// Byte offset ``off`` of a tile whose rows are ROW bytes (32, 64 or 128) in
// the ROW-byte swizzle, as TMA writes it and wgmma reads it: the 16-byte
// unit index is XORed with the bits above the 128-byte line.  The tile base
// is 1024-byte aligned.
template <int ROW>
__device__ __forceinline__ int swizzled(int off) {
  return off ^ (((off >> 7) & (ROW / 16 - 1)) << 4);
}

// Four packed int4 values (one per byte, low or high nibble) -> four
// sign-extended int8 bytes: bit 3 of each byte is copied into bits 4..7
// (u | (u & 0x08)*0x1E per byte; no carries cross a byte).
__device__ __forceinline__ uint32_t sext_nibbles(uint32_t v, bool high) {
  uint32_t u = (high ? v >> 4 : v) & 0x0F0F0F0Fu;
  return u | ((u & 0x08080808u) * 0x1Eu);
}

// The packed BN x BK/2 tile at ``packed`` -> the int8 BN x BK tile at ``dst``,
// both swizzled, by the NT consumer threads.  Item i is the 16-byte packed
// unit u of row r, with i % 8 the row inside an 8-row group, so that the
// eight lanes of a quarter warp hit eight different bank groups on the load
// and on both stores.
template <int BK, int BN, int NT>
__device__ __forceinline__ void unpack_b_tile(const uint8_t* __restrict__ packed,
                                              uint8_t* __restrict__ dst,
                                              int tid) {
  constexpr int PB = BK / 2;          // packed bytes per row
  constexpr int UNITS = PB / 16;      // 16-byte units per packed row
  constexpr int ITEMS = BN * UNITS;
  constexpr int PER_THREAD = (ITEMS + NT - 1) / NT;
  // every load first, then the arithmetic and the stores: the loads of one
  // item do not wait behind the stores of the item before
  uint4 v[PER_THREAD];
#pragma unroll
  for (int it = 0; it < PER_THREAD; ++it) {
    const int i = it * NT + tid;
    const int g = i >> 3;
    const int r = (g / UNITS) * 8 + (i & 7);
    const int u = g % UNITS;
    if (ITEMS % NT == 0 || i < ITEMS)
      v[it] = *reinterpret_cast<const uint4*>(
          packed + swizzled<PB>(r * PB + u * 16));
  }
#pragma unroll
  for (int it = 0; it < PER_THREAD; ++it) {
    const int i = it * NT + tid;
    const int g = i >> 3;
    const int r = (g / UNITS) * 8 + (i & 7);
    const int u = g % UNITS;
    if (ITEMS % NT == 0 || i < ITEMS) {
      uint4 lo, hi;
      lo.x = sext_nibbles(v[it].x, false);
      lo.y = sext_nibbles(v[it].y, false);
      lo.z = sext_nibbles(v[it].z, false);
      lo.w = sext_nibbles(v[it].w, false);
      hi.x = sext_nibbles(v[it].x, true);
      hi.y = sext_nibbles(v[it].y, true);
      hi.z = sext_nibbles(v[it].z, true);
      hi.w = sext_nibbles(v[it].w, true);
      *reinterpret_cast<uint4*>(dst + swizzled<BK>(r * BK + u * 16)) = lo;
      *reinterpret_cast<uint4*>(dst + swizzled<BK>(r * BK + (u + UNITS) * 16)) =
          hi;
    }
  }
}

// d (64 x BN, int32) = or += A (64 x 32, K-major) * B (BN x 32, K-major).
// Thread t of the warpgroup holds rows 16 * (t / 32) + (t % 32) / 4 (+ 8) and
// columns 8 j + 2 (t % 4) (+ 1): d[4 j + 0, 1] in the first row, d[4 j + 2,
// 3] in the second.
template <int BN>
__device__ __forceinline__ void wgmma_s8(int32_t (&d)[BN / 2], uint64_t da,
                                         uint64_t db, int scale_d);

template <>
__device__ __forceinline__ void wgmma_s8<32>(int32_t (&d)[16], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      " %0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p;\n}\n"
      :
      "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
      "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
      "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
      "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8<64>(int32_t (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      " %0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n}\n"
      :
      "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
      "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
      "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
      "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
      "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
      "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
      "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
      "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8<128>(int32_t (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      " %0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      :
      "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
      "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
      "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
      "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
      "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
      "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
      "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
      "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
      "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
      "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
      "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
      "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
      "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
      "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
      "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
      "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

// Bytes of one ring stage: the A tile of WG * 64 rows and the B tile,
// packed with INT4.
template <int BK, int BN, bool INT4, int WG>
__host__ __device__ constexpr int stage_bytes() {
  return WG * BM * BK + (INT4 ? BN * BK / 2 : BN * BK);
}

// Dynamic shared memory of one block: the ring, with INT4 the two unpack
// buffers, 1024 bytes of slack to align it (the swizzle patterns repeat every
// 1024 bytes), and the 2 * STAGES barriers, with RESIDUAL one more for the
// identity.  The epilogue's staging tile reuses the ring and the unpack
// buffers behind it.
template <int BK, int BN, bool INT4, int WG, bool RESIDUAL = false>
constexpr int smem_bytes() {
  return STAGES * stage_bytes<BK, BN, INT4, WG>() + (INT4 ? 2 * BN * BK : 0) +
         1024 + 2 * STAGES * 8 + (RESIDUAL ? 8 : 0);
}

// One WG * 64 x BN output tile per block: WG consumer warpgroups, each with
// its own 64 rows of A and its own accumulators, on one B tile.  With ENTRY
// p.lo and p.hi are the entry requant's clip bounds.
template <bool CONV, bool REQUANT, bool INT4, int BK, int BN, int WG,
          bool RESIDUAL = false, bool ENTRY = false>
__global__ void __launch_bounds__(threads<WG>())
gemm_s8_sm90_kernel(const __grid_constant__ CUtensorMap amap,
                    const __grid_constant__ CUtensorMap wmap,
                    const __grid_constant__ OutMaps<RESIDUAL, ENTRY> omaps,
                    const Args p) {
  static_assert(WG == 1 || (!CONV && INT4),
                "two consumer warpgroups: only the packed matmul");
  static_assert(!RESIDUAL || (!CONV && !REQUANT && !INT4),
                "the residual epilogue: only the int8 accumulator matmul");
  static_assert(!ENTRY || RESIDUAL,
                "the entry requant: only with the residual epilogue");
  constexpr int TM = WG * BM;                    // rows of the block's tile
  constexpr int CONSUMERS = WG * CONSUMER_THREADS;
  constexpr int A_BYTES = TM * BK;
  constexpr int STAGE_BYTES = stage_bytes<BK, BN, INT4, WG>();
  constexpr int UNPACK_BYTES = INT4 ? BN * BK : 0;
  // the staged output: int8 as one dense TM x BN box, int32 as TM x 32
  // chunks in the 128-byte swizzle
  constexpr int CHUNK_COLS = REQUANT ? BN : 32;
  constexpr int CHUNKS = BN / CHUNK_COLS;
  constexpr int CHUNK_BYTES = TM * CHUNK_COLS * (REQUANT ? 1 : 4);
  static_assert(CHUNKS * CHUNK_BYTES <= STAGES * STAGE_BYTES + 2 * UNPACK_BYTES,
                "the staged output tile must fit in the ring");
  // the staged chunks: at the ring's start, or with RESIDUAL at its end,
  // over the stages from UNDER on
  constexpr int OUT_OFF =
      RESIDUAL ? STAGES * STAGE_BYTES - CHUNKS * CHUNK_BYTES : 0;
  constexpr int UNDER = OUT_OFF / STAGE_BYTES;
  static_assert(OUT_OFF % 1024 == 0, "the swizzle's 1024-byte alignment");
  // ENTRY: the int8 entry tile at the ring's start, below the identity
  static_assert(!ENTRY || TM * BN <= OUT_OFF,
                "the entry tile must lie below the staged identity");
  constexpr int CHAINS = 2;
  bool carrier = true;               // whether the output map is stored
  if constexpr (ENTRY) carrier = omaps.carrier != 0;

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  uint8_t* ring_ptr = smem_raw + (ring - raw);
  const uint32_t unpacked = ring + STAGES * STAGE_BYTES;
  const uint32_t full = unpacked + 2 * UNPACK_BYTES;
  const uint32_t empty = full + STAGES * 8;
  const uint32_t id_full = empty + STAGES * 8;   // RESIDUAL: the identity

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int n0 = blockIdx.y * BN;
  int m0 = blockIdx.x * TM;          // matmul: first row of the tile
  int b = 0, oy0 = 0, ox0 = 0;       // conv: image and corner of the rectangle
  if (CONV) {
    const int per = p.tiles_x * p.tiles_y;
    b = blockIdx.x / per;
    const int r = blockIdx.x - b * per;
    const int ty = r / p.tiles_x;
    oy0 = ty * p.th;
    ox0 = (r - ty * p.tiles_x) * p.tw;
  }

  if (tid == CONSUMERS) {            // the producer lane: descriptors on their way
    tma_prefetch_map(&amap);
    tma_prefetch_map(&wmap);
    if (carrier) tma_prefetch_map(&omaps.out);
    if constexpr (RESIDUAL) tma_prefetch_map(&omaps.identity);
    if constexpr (ENTRY) tma_prefetch_map(&omaps.entry);
  }
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s * 8, 1);    // the producer's arrive + the bytes
      mbar_init(empty + s * 8, 4 * WG);   // one lane of each consumer warp
    }
    if (RESIDUAL) mbar_init(id_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMERS / 32) {
    // ---- producer: one lane keeps the ring full ----
    if (lane == 0) {
      uint32_t stage = 0, parity = 1;     // the first pass finds every stage empty
      int dy = 0, dx = 0, chunk = 0, kcol = 0;
      for (int kt = 0; kt < p.k_tiles; ++kt) {
        mbar_wait(empty + stage * 8, parity);
        const uint32_t a_s = ring + stage * STAGE_BYTES;
        const uint32_t bar = full + stage * 8;
        mbar_expect_tx(bar, STAGE_BYTES);
        if (CONV) {
          tma_load_4d(a_s, &amap, bar, chunk * BK, ox0 + dx - p.pad_x,
                      oy0 + dy - p.pad_y, b);
          const int wcol = kcol + chunk * BK;
          tma_load_2d(a_s + A_BYTES, &wmap, bar, INT4 ? wcol / 2 : wcol, n0);
          if (++chunk == p.chunks) {
            chunk = 0;
            kcol += p.cpad;
            if (++dx == p.kw) {
              dx = 0;
              ++dy;
            }
          }
        } else {
          tma_load_2d(a_s, &amap, bar, kt * BK, m0);
          tma_load_2d(a_s + A_BYTES, &wmap, bar, INT4 ? kt * BK / 2 : kt * BK,
                      n0);
        }
        if (++stage == STAGES) {
          stage = 0;
          parity ^= 1;
        }
      }
      if constexpr (RESIDUAL) {
        // the identity into the staged chunks, once the stages under them
        // are released: the waits of the next STAGES tiles, for those stages
        for (int i = 0; i < STAGES; ++i) {
          if (stage >= UNDER) mbar_wait(empty + stage * 8, parity);
          if (++stage == STAGES) {
            stage = 0;
            parity ^= 1;
          }
        }
        const int chunks = min(CHUNKS, (p.N - n0 + 31) / 32);
        mbar_expect_tx(id_full, chunks * CHUNK_BYTES);
        for (int c = 0; c < chunks; ++c)
          tma_load_2d(ring + OUT_OFF + c * CHUNK_BYTES, &omaps.identity,
                      id_full, n0 + c * 32, m0);
      }
    }
    return;
  }

  // ---- consumers: wgmma over the stages as they land ----
  // Each warpgroup multiplies its own 64 rows of the A tile.
  const uint32_t a_rows = (tid / CONSUMER_THREADS) * BM * BK;
  // The BK / 32 wgmmas of a stage alternate between CHAINS accumulator
  // sets, summed in the epilogue: wgmmas into one set wait for each other,
  // wgmmas into different sets overlap (on the H100 two sets were faster
  // than one at K = 4096 on a full grid and equal at the ResNet shapes).
  int32_t acc[CHAINS][BN / 2];
#pragma unroll
  for (int c = 0; c < CHAINS; ++c)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[c][i] = 0;
  {
    uint32_t stage = 0, parity = 0, prev = 0;
    for (int kt = 0; kt < p.k_tiles; ++kt) {
      mbar_wait(full + stage * 8, parity);
      const uint32_t a_s = ring + stage * STAGE_BYTES;
      uint32_t b_s = a_s + A_BYTES;
      if (INT4) {
        // the stage's packed tile -> int8 in unpack buffer kt % 2, while the
        // wgmmas of the stage before run; then that group is waited for, so
        // that after the bar.sync no warp is still reading the other buffer
        const int off = STAGE_BYTES * STAGES + (kt & 1) * UNPACK_BYTES;
        unpack_b_tile<BK, BN, CONSUMERS>(
            ring_ptr + stage * STAGE_BYTES + A_BYTES, ring_ptr + off, tid);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        if (kt > 0) {
          wgmma_wait<0>();
          if (lane == 0) mbar_arrive(empty + prev * 8);
        }
        consumer_sync<WG>();
        b_s = ring + off;
      }
      const uint64_t da = make_desc<BK>(a_s + a_rows);
      const uint64_t db = make_desc<BK>(b_s);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < BK / 32; ++ks)
        wgmma_s8<BN>(acc[ks % CHAINS], da + 2 * ks, db + 2 * ks, 1);
      wgmma_commit();
      if (!INT4 && kt > 0) {        // the group before this one has finished
        wgmma_wait<1>();
        if (lane == 0) mbar_arrive(empty + prev * 8);
      }
      prev = stage;
      if (++stage == STAGES) {
        stage = 0;
        parity ^= 1;
      }
    }
    wgmma_wait<0>();
    if (RESIDUAL && lane == 0) mbar_arrive(empty + prev * 8);  // the last
  }
  consumer_sync<WG>();              // every warp is done reading the ring
  if (RESIDUAL) mbar_wait(id_full, 0);

  // ---- epilogue: registers -> staged tile -> TMA store ----
  const int row0 = warp * 16 + (lane >> 2);
  const int q2 = (lane & 3) * 2;
  float mult_in = 0.f;
  if constexpr (ENTRY) mult_in = __ldg(omaps.mult_in);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = j * 8 + q2;
    const int n = n0 + col;
    const int32_t bias0 = n < p.N ? __ldg(p.bias + n) : 0;
    const int32_t bias1 = n + 1 < p.N ? __ldg(p.bias + n + 1) : 0;
    float mult0 = 0.f, mult1 = 0.f, mid0 = 0.f, mid1 = 0.f;
    if (REQUANT || RESIDUAL) {
      mult0 = n < p.N ? __ldg(p.mult + n) : 0.f;
      mult1 = n + 1 < p.N ? __ldg(p.mult + n + 1) : 0.f;
    }
    if constexpr (RESIDUAL) {
      mid0 = n < p.N ? __ldg(omaps.mult_id + n) : 0.f;
      mid1 = n + 1 < p.N ? __ldg(omaps.mult_id + n + 1) : 0.f;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + h * 8;
      int32_t v0 = bias0, v1 = bias1;
#pragma unroll
      for (int c = 0; c < CHAINS; ++c) {
        v0 += acc[c][4 * j + 2 * h];
        v1 += acc[c][4 * j + 2 * h + 1];
      }
      if (REQUANT) {
        const uint32_t lo8 = (uint8_t)hawq::requant_s8(v0, mult0, p.lo, p.hi);
        const uint32_t hi8 = (uint8_t)hawq::requant_s8(v1, mult1, p.lo, p.hi);
        *reinterpret_cast<uint16_t*>(ring_ptr + row * BN + col) =
            (uint16_t)(lo8 | (hi8 << 8));
      } else {
        const int cc = col & 31;
        const int unit = (cc >> 2) ^ (row & 7);
        int2* slot = reinterpret_cast<int2*>(
            ring_ptr + OUT_OFF + (col >> 5) * CHUNK_BYTES + row * 128 +
            unit * 16 + (cc & 3) * 4);
        if constexpr (RESIDUAL) {     // the staged identity, in place
          const int2 id = *slot;
          v0 = hawq::requant_add_relu(v0, mult0, id.x, mid0);
          v1 = hawq::requant_add_relu(v1, mult1, id.y, mid1);
        }
        if constexpr (ENTRY) {        // the carrier's entry requant
          const uint32_t lo8 =
              (uint8_t)hawq::requant_s8(v0, mult_in, p.lo, p.hi);
          const uint32_t hi8 =
              (uint8_t)hawq::requant_s8(v1, mult_in, p.lo, p.hi);
          *reinterpret_cast<uint16_t*>(ring_ptr + row * BN + col) =
              (uint16_t)(lo8 | (hi8 << 8));
        }
        if (carrier) *slot = make_int2(v0, v1);
      }
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  consumer_sync<WG>();
  if (tid == 0) {
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
      const int nc = n0 + c * CHUNK_COLS;
      if (nc >= p.N || !carrier) break;
      if (CONV)
        tma_store_4d(&omaps.out, ring + c * CHUNK_BYTES, nc, ox0, oy0, b);
      else
        tma_store_2d(&omaps.out, ring + OUT_OFF + c * CHUNK_BYTES, nc, m0);
    }
    if constexpr (ENTRY) tma_store_2d(&omaps.entry, ring, n0, m0);
    tma_store_commit_and_wait();    // the block's shared memory must outlive it
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the libcuda that the runtime has loaded: the
// library needs no link against it.
inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &status);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                              cudaEnableDefault, &status);
#endif
    if (err != cudaSuccess || status != cudaDriverEntryPointSuccess) f = nullptr;
    return reinterpret_cast<EncodeTiledFn>(f);
  }();
  return fn;
}

// A tiled map of ``rank`` dimensions, innermost first; strides[i] is the byte
// stride of dimension i + 1.  Out-of-bounds elements load as zeros and are
// not stored.  Returns 0, or ENCODE_ERROR + the CUresult.
inline int encode_map(CUtensorMap* map, CUtensorMapDataType dtype, int rank,
                      const void* base, const cuuint64_t* dims,
                      const cuuint64_t* strides, const cuuint32_t* box,
                      CUtensorMapSwizzle swizzle) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return ENCODE_ERROR;
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  CUresult res = fn(map, dtype, (cuuint32_t)rank, const_cast<void*>(base), dims,
                    strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                    CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                    CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : ENCODE_ERROR + (int)res;
}

// The swizzle of a tile whose rows are ``row_bytes`` (32, 64 or 128) wide.
inline CUtensorMapSwizzle k_swizzle(int row_bytes) {
  return row_bytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
         : row_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                           : CU_TENSOR_MAP_SWIZZLE_32B;
}

// The map of prepared weights wt, N K-major rows of ``row_bytes``, for boxes
// of ``box_bytes`` x BN: int8 weights (N, Kpad) with BK-byte boxes, packed
// int4 weights (N, Kpad / 2) with BK/2-byte boxes.
inline int encode_weight_map(CUtensorMap* map, const int8_t* wt, int N,
                             int row_bytes, int box_bytes, int bn) {
  if (box_bytes != 32 && box_bytes != 64 && box_bytes != 128)
    return (int)cudaErrorInvalidValue;
  const cuuint64_t dims[2] = {(cuuint64_t)row_bytes, (cuuint64_t)N};
  const cuuint64_t strides[1] = {(cuuint64_t)row_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_bytes, (cuuint32_t)bn};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, wt, dims, strides,
                    box, k_swizzle(box_bytes));
}

template <bool CONV, bool REQUANT, bool INT4, int BK, int BN, int WG,
          bool RESIDUAL, bool ENTRY>
inline int launch_one(const CUtensorMap& amap, const CUtensorMap& wmap,
                      const OutMaps<RESIDUAL, ENTRY>& omaps, const Args& p,
                      dim3 grid, int smem_extra, cudaStream_t stream) {
  // above 48 KB the dynamic shared memory size is opted into, once per
  // instantiation, device and size
  constexpr int MAX_DEVICES = 64;
  static int configured[MAX_DEVICES] = {};
  const int smem = smem_bytes<BK, BN, INT4, WG, RESIDUAL>() + smem_extra;
  auto kernel =
      gemm_s8_sm90_kernel<CONV, REQUANT, INT4, BK, BN, WG, RESIDUAL, ENTRY>;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device >= MAX_DEVICES || smem != configured[device]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) {
      cudaGetLastError();
      return (int)err;
    }
    if (device < MAX_DEVICES) configured[device] = smem;
  }
  kernel<<<grid, threads<WG>(), smem, stream>>>(amap, wmap, omaps, p);
  return (int)cudaGetLastError();
}

template <bool CONV, bool REQUANT, bool INT4, int WG = 1,
          bool RESIDUAL = false, bool ENTRY = false>
inline int launch(const CUtensorMap& amap, const CUtensorMap& wmap,
                  const OutMaps<RESIDUAL, ENTRY>& omaps, const Args& p,
                  dim3 grid, int bk, int bn, int smem_extra,
                  cudaStream_t stream) {
#define HAWQ_SM90_CASE(K, N)                                                 \
  if (bk == K && bn == N)                                                    \
    return launch_one<CONV, REQUANT, INT4, K, N, WG, RESIDUAL, ENTRY>(       \
        amap, wmap, omaps, p, grid, smem_extra, stream);
  HAWQ_SM90_CASE(64, 32)
  HAWQ_SM90_CASE(64, 64)
  HAWQ_SM90_CASE(64, 128)
  HAWQ_SM90_CASE(128, 32)
  HAWQ_SM90_CASE(128, 64)
  HAWQ_SM90_CASE(128, 128)
#undef HAWQ_SM90_CASE
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// the entry points' bodies
// ---------------------------------------------------------------------------

// x (M, K) int8 row-major times the prepared weights behind ``wmap_bytes``
// (with INT4 their nibble-packed handle): the int32 accumulator + bias (out
// int32, bm x 32 boxes in the 128-byte swizzle), or with REQUANT its requant
// (out int8, one dense bm x BN box), or with RESIDUAL the residual epilogue's
// int32 carrier over ``identity`` (M, N) int32, read in the output's boxes,
// with ``mult`` and ``mult_id`` (N,) float32; with ENTRY also its entry
// requant into ``entry`` (M, N) int8, by the one float32 at ``mult_in``
// into [lo, hi], and the carrier stored only where ``out`` is not null.
// bm, the rows of a block's tile, is 64, or 128 (two consumer warpgroups)
// with INT4.
template <bool REQUANT, bool INT4, bool RESIDUAL = false, bool ENTRY = false>
inline int matmul_entry(const int8_t* x, const void* wmap_bytes,
                        const int32_t* bias, const float* mult, void* out,
                        int M, int K, int N, int lo, int hi, int bk, int bn,
                        int bm, int smem_extra, cudaStream_t stream,
                        const int32_t* identity = nullptr,
                        const float* mult_id = nullptr,
                        int8_t* entry = nullptr,
                        const float* mult_in = nullptr) {
  if (bm != BM && !(INT4 && bm == 2 * BM)) return (int)cudaErrorInvalidValue;
  CUtensorMap amap, wmap;
  OutMaps<RESIDUAL, ENTRY> omaps{};
  std::memcpy(&wmap, wmap_bytes, sizeof(wmap));
  {
    const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)M};
    const cuuint64_t strides[1] = {(cuuint64_t)K};
    const cuuint32_t box[2] = {(cuuint32_t)bk, (cuuint32_t)bm};
    int code = encode_map(&amap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, x, dims,
                          strides, box, k_swizzle(bk));
    if (code) return code;
  }
  {
    const cuuint64_t dims[2] = {(cuuint64_t)N, (cuuint64_t)M};
    const cuuint64_t strides[1] = {(cuuint64_t)N * (REQUANT ? 1 : 4)};
    const cuuint32_t box[2] = {(cuuint32_t)(REQUANT ? bn : 32),
                               (cuuint32_t)bm};
    int code = 0;
    if (!ENTRY || out != nullptr)
      code = encode_map(&omaps.out,
                        REQUANT ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                : CU_TENSOR_MAP_DATA_TYPE_INT32,
                        2, out, dims, strides, box,
                        REQUANT ? CU_TENSOR_MAP_SWIZZLE_NONE
                                : CU_TENSOR_MAP_SWIZZLE_128B);
    if (code) return code;
    if constexpr (RESIDUAL) {
      code = encode_map(&omaps.identity, CU_TENSOR_MAP_DATA_TYPE_INT32, 2,
                        identity, dims, strides, box,
                        CU_TENSOR_MAP_SWIZZLE_128B);
      if (code) return code;
      omaps.mult_id = mult_id;
    }
    if constexpr (ENTRY) {          // int8, one dense bn x bm box
      const cuuint64_t strides8[1] = {(cuuint64_t)N};
      const cuuint32_t box8[2] = {(cuuint32_t)bn, (cuuint32_t)bm};
      code = encode_map(&omaps.entry, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, entry,
                        dims, strides8, box8, CU_TENSOR_MAP_SWIZZLE_NONE);
      if (code) return code;
      omaps.mult_in = mult_in;
      omaps.carrier = out != nullptr;
    }
  }
  Args p{};
  p.bias = bias;
  p.mult = mult;
  p.N = N;
  p.lo = lo;
  p.hi = hi;
  p.k_tiles = (K + bk - 1) / bk;
  dim3 grid((M + bm - 1) / bm, (N + bn - 1) / bn);
  if constexpr (INT4) {
    if (bm == 2 * BM)
      return launch<false, REQUANT, true, 2>(amap, wmap, omaps, p, grid, bk,
                                             bn, smem_extra, stream);
  }
  return launch<false, REQUANT, INT4, 1, RESIDUAL, ENTRY>(
      amap, wmap, omaps, p, grid, bk, bn, smem_extra, stream);
}

// The stride-1 conv over xp: the zero-padded (B, Hp, Wp*C) slab, or with
// pad_h / pad_w the activations that lack that many rows / columns of zero
// border on each side, which TMA then supplies.  The weights behind
// ``wmap_bytes`` are the prepared (N, taps*Cpad) K-major copy, or with INT4
// its nibble-packed (N, taps*Cpad/2) form; an M tile is a th x tw rectangle
// of output pixels, so that every tap of it is one 4-D TMA box of the slab.
// With row_taps = kw (pad_w 0) a kernel row is one tap: the map's pixels are
// kw*C bytes wide and C bytes apart, so that they overlap and one box holds
// the row's kw taps of every pixel of the rectangle (TMA reads overlapping
// rows as they are; the weights are laid out a row to a tap, Cpad the row's
// kw*C rounded up to 64).
// With REQUANT the output is the int8 (B, H, W, N) requant (one dense
// {BN, tw, th, 1} box); without, the int32 accumulator + bias (mult, lo and
// hi unused), stored as {32, tw, th, 1} boxes in the 128-byte swizzle: a
// box's 128-byte rows are the rectangle's pixels in row-major order, the
// order of the tile's rows, so the epilogue's int32 chunks go out as they
// are staged.
template <bool REQUANT, bool INT4>
inline int conv_entry(const int8_t* xp, const void* wmap_bytes,
                      const int32_t* bias, const float* mult, void* out, int B,
                      int H, int W, int C, int kh, int kw, int N, int lo,
                      int hi, int row_taps, int cpad, int bk, int bn, int th,
                      int tw, int pad_h, int pad_w, int smem_extra,
                      cudaStream_t stream) {
  if (th * tw != BM) return (int)cudaErrorInvalidValue;
  if (row_taps != 1 && (row_taps != kw || pad_w != 0))
    return (int)cudaErrorInvalidValue;
  const int Hp = H + kh - 1 - 2 * pad_h, Wp = W + kw - 1 - 2 * pad_w;
  CUtensorMap amap, wmap;
  OutMaps<false> omaps;
  std::memcpy(&wmap, wmap_bytes, sizeof(wmap));
  {
    const cuuint64_t dims[4] = {(cuuint64_t)row_taps * C,
                                (cuuint64_t)(Wp - row_taps + 1),
                                (cuuint64_t)Hp, (cuuint64_t)B};
    const cuuint64_t strides[3] = {(cuuint64_t)C, (cuuint64_t)Wp * C,
                                   (cuuint64_t)Hp * Wp * C};
    const cuuint32_t box[4] = {(cuuint32_t)bk, (cuuint32_t)tw, (cuuint32_t)th,
                               1};
    int code = encode_map(&amap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, xp, dims,
                          strides, box, k_swizzle(bk));
    if (code) return code;
  }
  {
    const cuuint64_t elem = REQUANT ? 1 : 4;
    const cuuint64_t dims[4] = {(cuuint64_t)N, (cuuint64_t)W, (cuuint64_t)H,
                                (cuuint64_t)B};
    const cuuint64_t strides[3] = {(cuuint64_t)N * elem,
                                   (cuuint64_t)W * N * elem,
                                   (cuuint64_t)H * W * N * elem};
    const cuuint32_t box[4] = {(cuuint32_t)(REQUANT ? bn : 32), (cuuint32_t)tw,
                               (cuuint32_t)th, 1};
    int code = encode_map(&omaps.out,
                          REQUANT ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                  : CU_TENSOR_MAP_DATA_TYPE_INT32,
                          4, out, dims, strides, box,
                          REQUANT ? CU_TENSOR_MAP_SWIZZLE_NONE
                                  : CU_TENSOR_MAP_SWIZZLE_128B);
    if (code) return code;
  }
  Args p{};
  p.bias = bias;
  p.mult = mult;
  p.N = N;
  p.lo = lo;
  p.hi = hi;
  p.kw = kw / row_taps;
  p.chunks = cpad / bk;
  p.cpad = cpad;
  p.k_tiles = kh * p.kw * p.chunks;
  p.tiles_x = (W + tw - 1) / tw;
  p.tiles_y = (H + th - 1) / th;
  p.th = th;
  p.tw = tw;
  p.pad_y = pad_h;
  p.pad_x = pad_w;
  dim3 grid(B * p.tiles_x * p.tiles_y, (N + bn - 1) / bn);
  return launch<true, REQUANT, INT4>(amap, wmap, omaps, p, grid, bk, bn,
                                     smem_extra, stream);
}

}  // namespace hawq_sm90
