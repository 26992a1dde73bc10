// Depthwise 3x3 int8 convolution, pad 1, stride 1 or 2, NHWC: per channel c
// the sum over the window of x * w in int32, plus bias[c] ("acc" form); and
// the same accumulator clamped to [0, hi6[c]] (MobileNetV2's ReLU6 on the
// integer side) and requantized to int8, clip(floor(f32(acc) * mult[c] +
// 0.5), lo, hi) ("requant" form).
//
// The TPU package has no Pallas kernel for it: its MobileNetV2 engine runs
// the depthwise conv as XLA's int8 grouped convolution
// (hawq_tpu/inference/engine_mobilenet.py conv_acc, _conv_i8 with groups =
// C) or as nine shifted int32 multiply-adds (_dw_shifted).  CUDA PyTorch has
// no integer convolution, so the port needs a kernel of its own.
//
// Bound on the H100: bytes.  An output takes 9 int8 multiply-adds and no
// tensor core; the input is read once from device memory and the output
// written once (int8 for the requant form, int32 for the accumulator form,
// whose output is most of its bytes).  The first design (one thread per
// output pixel and 16 channels) reached 11 % of that bound per MobileNetV2
// b8 forward: ~3 integer instructions per product (a byte extract, a sign
// extension, then the multiply-add), every input pixel loaded again by up
// to nine threads through L1, the per-channel vectors reloaded by every
// thread, and 55-92 blocks of 256 threads at the 14x14 / 7x7 maps, fewer
// than the card's 132 SMs.  This design:
//
//  * a tile is `rows` output rows of one image, `ng` groups of P output
//    columns and a slab of `cs` channel units.  A block stages the tile's
//    input rectangle with its one-pixel halo in shared memory ((R+2) x
//    (W_t+2) pixels at stride 1, (2R+1) x (2W_t+1) at stride 2, plus the
//    few columns that round a thread's read up to whole words) with
//    cp.async, which zero-fills outside the image: the border is zeros,
//    never the dtype's minimum;
//  * blocks are persistent along the tile rows: block (slab, tile column,
//    image x row chunk) walks tile rows ty0, ty0 + nty, .., about one wave
//    of resident blocks in all, with two staging buffers, so that the next
//    tile's copies are in flight while the current one is computed; the
//    weights, bias, hi6 and mult are loaded once a block-thread, while the
//    first copies are in flight, and no index is divided per tile;
//  * a thread takes one channel unit (V = 4 channels, one 32-bit word of a
//    pixel, where C % 4 == 0 and the pointers allow; else V = 1) and P
//    output pixels along a row.  Per kernel row it loads the 4G words of
//    the columns its P pixels read and, for V = 4, transposes each run of
//    4 columns x 4 channels with eight `prmt`s (__byte_perm), so that each
//    channel holds words of 4 neighbouring columns.  For V = 1 the staging
//    already stores the tile channel-major, and a thread loads those words
//    as they are.  A pixel's three taps of the row are one funnel `prmt`
//    of two such words, and one __dp4a against the row's weight word (w0,
//    w1, w2, 0) adds them: exact s8 x s8 products summed in s32, the same
//    integers as the nine shifted multiply-adds;
//  * the shared-memory layout keeps a warp's reads on distinct banks: after
//    every s*P staged columns `padg` words of pad, and a row pitch `rp`,
//    chosen on the host so that lane t of a warp reads word t (mod 32);
//  * the requant is hawq::requant_f32 (requant.cuh): a rounded multiply and
//    then a rounded add, never an FMA.  The accumulator form stores 16
//    bytes a thread, consecutive lanes on consecutive channel words.
//
// What is left (chip_smoke.py phase 8, H100): at b8 most calls take 2-4
// tile lifetimes of latency (the graph node, the staging copies, the
// products, the requant) rather than their bytes; at b32 the accumulator
// form's large calls reach ~70 % of their bound.
//
// The wrapper (kernels/depthwise.py dw_plan) picks V, the copy width, P and
// the tile per call from (B, H, W, C, stride) and the pointers;
// dwconv_walk_plain there walks the same tiles, byte selections and dp4a
// groupings in torch integer ops.
#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "requant.cuh"

namespace {

constexpr int MAX_THREADS = 256;
constexpr int MAX_SMEM = 160 * 1024;     // both staging buffers

struct Tile {
  int B, H, W, C, OH, OW;
  int cs;             // channel units (words for V = 4, channels for V = 1)
  int ng, rows;       // pixel groups along a row, output rows
  int tiles_x, tiles_y, slabs;
  int rows_in, cols_in;   // the staged rectangle, pixels
  int padg, rp;       // V = 4: pad words after each s*P columns, row pitch
  int plane;          // V = 1: words a channel's plane takes
  int stage_words;    // one staging buffer
  int nty;            // row chunks: a block walks tile rows ty0 + k * nty
  float lo, hi;
};

// ---- copies into shared memory (cp.async, zero-filled outside the image)
__device__ __forceinline__ void copy16(void* dst, const void* src,
                                       bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void copy4(void* dst, const void* src,
                                      bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void copies_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Every group but the one committed last has landed.
__device__ __forceinline__ void copies_wait_all_but_last() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
// ---- end of copies

// Rows a_0..a_3 (byte j of a_i: column i, channel j) -> t_j (byte i of t_j:
// channel j, column i).
__device__ __forceinline__ void transpose4(uint32_t a0, uint32_t a1,
                                           uint32_t a2, uint32_t a3,
                                           uint32_t (&t)[4]) {
  const uint32_t p0 = __byte_perm(a0, a1, 0x5140);
  const uint32_t p1 = __byte_perm(a0, a1, 0x7362);
  const uint32_t q0 = __byte_perm(a2, a3, 0x5140);
  const uint32_t q1 = __byte_perm(a2, a3, 0x7362);
  t[0] = __byte_perm(p0, q0, 0x5410);
  t[1] = __byte_perm(p0, q0, 0x7632);
  t[2] = __byte_perm(p1, q1, 0x5410);
  t[3] = __byte_perm(p1, q1, 0x7632);
}

// Bytes r .. r + 3 of the 8-byte run (lo, hi): the three taps a pixel whose
// first column is byte r reads, and one byte beyond (its weight is 0).
template <int R>
__device__ __forceinline__ uint32_t taps_at(uint32_t lo, uint32_t hi) {
  if constexpr (R == 0) {
    return lo;
  } else {
    return __byte_perm(lo, hi, R | (R + 1) << 4 | (R + 2) << 8
                                   | (R + 3) << 12);
  }
}

// acc[j][e] += the taps of kernel row dy for pixel j, channel e: pixel j's
// first column is byte s*j of the run T[e][0..G).
template <int V, int S, int P, int G>
__device__ __forceinline__ void row_products(const uint32_t (&T)[V][G],
                                             const int (&wr)[V],
                                             int (&acc)[P][V]) {
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int o = S * j;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const uint32_t lo = T[e][o >> 2];
      const uint32_t hi = (o >> 2) + 1 < G ? T[e][(o >> 2) + 1] : 0u;
      uint32_t taps;
      switch (o & 3) {
        case 0: taps = taps_at<0>(lo, hi); break;
        case 1: taps = taps_at<1>(lo, hi); break;
        case 2: taps = taps_at<2>(lo, hi); break;
        default: taps = taps_at<3>(lo, hi); break;
      }
      acc[j][e] = __dp4a((int)taps, wr[e], acc[j][e]);
    }
  }
}

// A tile: channel slab, tile column, tile row, image.
struct Coords {
  int slab, tx, ty, b;
};

// Which staging copies a thread issues: column chunks c1, c1 + lanes, ..
// of a staged row, in rows ry0, ry0 + rstep, .. (the same for every tile).
struct Stager {
  int lanes, rstep, c1, ry0;
  bool active;
};

__device__ __forceinline__ Stager stager(int row_chunks, int threads,
                                         int tid) {
  Stager st;
  st.lanes = min(threads, row_chunks);
  st.rstep = threads / st.lanes;
  st.ry0 = tid / st.lanes;
  st.c1 = tid - st.ry0 * st.lanes;
  st.active = tid < st.lanes * st.rstep;
  return st;
}

// Stage one tile's input rectangle with its halo into `buf`: V = 4, pixel
// words [row][column][unit] (with the bank pads) by cp.async, zero-filled
// outside the image; V = 1, channel-major bytes [unit][row][column].
template <int V, int S, int P, int COPY>
__device__ __forceinline__ void stage(const int8_t* __restrict__ x,
                                      const Tile& t, const Coords& c,
                                      const Stager& st, uint32_t* buf) {
  constexpr int SP = S * P;
  if (!st.active) return;
  const int iy0 = c.ty * t.rows * S - 1;       // staged row 0 in the image
  const int ix0 = c.tx * t.ng * SP - 1;        // staged column 0
  const int8_t* img = x + (size_t)c.b * t.H * t.W * t.C;
  if constexpr (V == 4) {
    constexpr int WORDS = COPY / 4;            // words a copy moves
    const int per_px = t.cs / WORDS;
    const int8_t* base = img + c.slab * t.cs * 4;
    for (int c1 = st.c1; c1 < t.cols_in * per_px; c1 += st.lanes) {
      const int cx = c1 / per_px;
      const int k = c1 - cx * per_px;
      const int ix = ix0 + cx;
      const bool col_ok = ix >= 0 && ix < t.W;
      uint32_t* dst = buf + cx * t.cs + (cx / SP) * t.padg + k * WORDS;
      const int8_t* src = base + (ptrdiff_t)ix * t.C + k * COPY;
      for (int ry = st.ry0; ry < t.rows_in; ry += st.rstep) {
        const int iy = iy0 + ry;
        const bool valid = col_ok && iy >= 0 && iy < t.H;
        const int8_t* from = valid ? src + (ptrdiff_t)iy * t.W * t.C : x;
        if constexpr (COPY == 16) copy16(dst + ry * t.rp, from, valid);
        else copy4(dst + ry * t.rp, from, valid);
      }
    }
  } else {
    uint8_t* sb = reinterpret_cast<uint8_t*>(buf);
    const int8_t* base = img + c.slab * t.cs;
    for (int c1 = st.c1; c1 < t.cols_in * t.cs; c1 += st.lanes) {
      const int cx = c1 / t.cs;
      const int ci = c1 - cx * t.cs;
      const int ix = ix0 + cx;
      const bool col_ok = ix >= 0 && ix < t.W;
      for (int ry = st.ry0; ry < t.rows_in; ry += st.rstep) {
        const int iy = iy0 + ry;
        const bool valid = col_ok && iy >= 0 && iy < t.H;
        sb[(ci * t.plane + ry * (t.cols_in / 4)) * 4 + cx] =
            valid ? (uint8_t)__ldg(base + ((ptrdiff_t)iy * t.W + ix) * t.C
                                   + ci)
                  : (uint8_t)0;
      }
    }
  }
}

// Block (slab, tile column, image x row chunk) walks the tile rows ty0,
// ty0 + nty, .. with two staging buffers: the next tile's copies are in
// flight while the current one is computed.  One thread: channel unit u =
// threadIdx.x of the slab, pixel group g = threadIdx.y, output row r =
// threadIdx.z of the tile.
template <bool REQUANT, int V, int S, int P, int COPY>
__global__ void __launch_bounds__(MAX_THREADS)
dwconv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
              const int32_t* __restrict__ bias,
              const int32_t* __restrict__ hi6,
              const float* __restrict__ mult, void* __restrict__ out,
              const Tile t) {
  constexpr int G = (S * (P - 1) + 3 + 3) / 4;   // words of columns a row
  constexpr int SP = S * P;                      // columns between groups
  extern __shared__ __align__(16) uint32_t smem[];
  const int u = threadIdx.x, g = threadIdx.y, r = threadIdx.z;
  const int threads = t.cs * t.ng * t.rows;
  const Stager st = stager(V == 4 ? t.cols_in * (t.cs / (COPY / 4))
                                  : t.cols_in * t.cs,
                           threads, u + t.cs * (g + t.ng * r));
  // this thread's first word of a staged row (V = 4) or of its plane
  const int lane_off = V == 4 ? g * (SP * t.cs + t.padg) + u
                              : u * t.plane + g * (SP / 4);
  const int row_words = V == 4 ? t.rp : t.cols_in / 4;

  Coords c;
  c.slab = blockIdx.x;
  c.tx = blockIdx.y;
  c.b = blockIdx.z / t.nty;
  c.ty = blockIdx.z - c.b * t.nty;
  if (c.ty >= t.tiles_y) return;
  stage<V, S, P, COPY>(x, t, c, st, smem);
  if constexpr (V == 4) copies_commit();

  // the slab's weights and vectors while the staging copies are in flight
  const int c0 = (c.slab * t.cs + u) * V;      // first channel
  int wr[3][V], b0[V];
  if constexpr (V == 4) {
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      uint32_t tw[4];
      transpose4(__ldg(reinterpret_cast<const uint32_t*>(
                     w + (dy * 3 + 0) * t.C + c0)),
                 __ldg(reinterpret_cast<const uint32_t*>(
                     w + (dy * 3 + 1) * t.C + c0)),
                 __ldg(reinterpret_cast<const uint32_t*>(
                     w + (dy * 3 + 2) * t.C + c0)),
                 0u, tw);
#pragma unroll
      for (int e = 0; e < 4; ++e) wr[dy][e] = (int)tw[e];
    }
  } else {
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
      wr[dy][0] = (int)((uint32_t)(uint8_t)__ldg(w + (dy * 3) * t.C + c0)
                        | (uint32_t)(uint8_t)__ldg(w + (dy * 3 + 1) * t.C
                                                   + c0) << 8
                        | (uint32_t)(uint8_t)__ldg(w + (dy * 3 + 2) * t.C
                                                   + c0) << 16);
  }
  int top[V];
  float m[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    b0[e] = __ldg(bias + c0 + e);
    if constexpr (REQUANT) {
      top[e] = __ldg(hi6 + c0 + e);
      m[e] = __ldg(mult + c0 + e);
    }
  }

  for (int buf = 0; c.ty < t.tiles_y; c.ty += t.nty, buf ^= 1) {
    if (c.ty + t.nty < t.tiles_y) {
      Coords cn = c;
      cn.ty += t.nty;
      stage<V, S, P, COPY>(x, t, cn, st, smem + (buf ^ 1) * t.stage_words);
    }
    if constexpr (V == 4) copies_commit();
    if constexpr (V == 4) copies_wait_all_but_last();
    __syncthreads();                       // this tile's buffer is staged

    int acc[P][V];
#pragma unroll
    for (int e = 0; e < V; ++e)
#pragma unroll
      for (int j = 0; j < P; ++j) acc[j][e] = b0[e];
    const uint32_t* cur = smem + buf * t.stage_words + lane_off;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const uint32_t* row = cur + (S * r + dy) * row_words;
      uint32_t T[V][G];
      if constexpr (V == 4) {
#pragma unroll
        for (int k = 0; k < G; ++k) {
          uint32_t a[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)     // column g*SP + 4k + i
            a[i] = row[(4 * k + i) * t.cs + ((4 * k + i) / SP) * t.padg];
          uint32_t tt[4];
          transpose4(a[0], a[1], a[2], a[3], tt);
#pragma unroll
          for (int e = 0; e < 4; ++e) T[e][k] = tt[e];
        }
      } else {
#pragma unroll
        for (int k = 0; k < G; ++k) T[0][k] = row[k];
      }
      int wrow[V];
#pragma unroll
      for (int e = 0; e < V; ++e) wrow[e] = wr[dy][e];
      row_products<V, S, P, G>(T, wrow, acc);
    }

    const int oy = c.ty * t.rows + r;
    const int ox0 = (c.tx * t.ng + g) * P;
    if (oy < t.OH) {
      const size_t pix0 = ((size_t)c.b * t.OH + oy) * t.OW + ox0;
      if constexpr (!REQUANT) {
        int32_t* o = static_cast<int32_t*>(out) + pix0 * t.C + c0;
#pragma unroll
        for (int j = 0; j < P; ++j) {
          if (ox0 + j >= t.OW) break;
          if constexpr (V == 4) {
            *reinterpret_cast<int4*>(o + (size_t)j * t.C) =
                make_int4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
          } else {
            o[(size_t)j * t.C] = acc[j][0];
          }
        }
      } else {
        int8_t* o = static_cast<int8_t*>(out) + pix0 * t.C + c0;
#pragma unroll
        for (int j = 0; j < P; ++j) {
          if (ox0 + j >= t.OW) break;
          uint32_t word = 0;
#pragma unroll
          for (int e = 0; e < V; ++e) {
            const int32_t a = min(max(acc[j][e], 0), top[e]);     // ReLU6
            const int q =
                __float2int_rz(hawq::requant_f32(a, m[e], t.lo, t.hi));
            word |= (uint32_t)(uint8_t)q << (8 * e);
          }
          if constexpr (V == 4) {
            *reinterpret_cast<uint32_t*>(o + (size_t)j * t.C) = word;
          } else {
            o[(size_t)j * t.C] = (int8_t)word;
          }
        }
      }
    }
    __syncthreads();                       // done reading this buffer
  }
}

template <bool REQUANT, int V, int S, int P, int COPY>
int launch_tile(const int8_t* x, const int8_t* w, const int32_t* bias,
                const int32_t* hi6, const float* mult, void* out,
                const Tile& t, int smem, cudaStream_t stream) {
  auto kernel = dwconv_kernel<REQUANT, V, S, P, COPY>;
  const int threads = t.cs * t.ng * t.rows;
  int err = 0;
  if (smem > 48 * 1024)
    err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (!err) err = (int)cudaGetDevice(&dev);
  if (!err)
    err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev);
  if (!err)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, threads, smem);
  if (err) return err;
  // about one wave of resident blocks: each (slab, tile column, image)
  // takes nty chunks of the tile rows
  const long long per_row = (long long)t.slabs * t.tiles_x * t.B;
  const long long slots = (long long)(per_sm > 1 ? per_sm : 1) * sms;
  Tile tt = t;
  tt.nty = (int)(slots / per_row > 1 ? slots / per_row : 1);
  if (tt.nty > t.tiles_y) tt.nty = t.tiles_y;
  if (t.tiles_x > 65535 || (long long)t.B * tt.nty > 65535)
    return (int)cudaErrorInvalidValue;
  kernel<<<dim3(t.slabs, t.tiles_x, t.B * tt.nty), dim3(t.cs, t.ng, t.rows),
           smem, stream>>>(x, w, bias, hi6, mult, out, tt);
  return (int)cudaGetLastError();
}

template <bool REQUANT>
int launch(const int8_t* x, const int8_t* w, const int32_t* bias,
           const int32_t* hi6, const float* mult, void* out, int B, int H,
           int W, int C, int stride, int lo, int hi, int vec, int copy,
           int p, int cs, int ng, int rows, cudaStream_t stream) {
  if (B < 1 || H < 1 || W < 1 || C < 1 || (stride != 1 && stride != 2)
      || cs < 1 || ng < 1 || rows < 1)
    return (int)cudaErrorInvalidValue;
  // the forms: V = 4 with 16- or 4-byte copies and P of 2 or 4; V = 1 with
  // s*P = 4 (its rows are read as whole words of 4 columns)
  const bool four = vec == 4 && C % 4 == 0 && (p == 2 || p == 4)
                    && (copy == 4 || (copy == 16 && cs % 4 == 0));
  const bool one = vec == 1 && copy == 1 && p * stride == 4;
  if (!(four || one) || (C / vec) % cs || cs * ng * rows > MAX_THREADS)
    return (int)cudaErrorInvalidValue;
  Tile t{};
  t.B = B; t.H = H; t.W = W; t.C = C;
  t.OH = (H - 1) / stride + 1;
  t.OW = (W - 1) / stride + 1;
  if ((long long)B * H * W * C > INT32_MAX
      || (long long)B * t.OH * t.OW * C > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  t.cs = cs; t.ng = ng; t.rows = rows;
  t.tiles_x = (t.OW + ng * p - 1) / (ng * p);
  t.tiles_y = (t.OH + rows - 1) / rows;
  t.slabs = C / vec / cs;
  const int sp = stride * p;
  const int words = (stride * (p - 1) + 3 + 3) / 4;
  t.rows_in = stride * (rows - 1) + 3;
  t.cols_in = sp * (ng - 1) + 4 * words;
  t.lo = (float)lo; t.hi = (float)hi;
  if (vec == 4) {
    // lane l = u + cs * (g + ng * r) reads word l (mod 32) of a column
    // offset: a group pitch of sp * cs + padg = cs (mod 32) words, and a
    // row pitch with stride * rp = cs * ng (mod 32) where that is solvable
    // in steps of 4 words (16-byte copies stay aligned)
    const int step = copy / 4;
    t.padg = ((cs - sp * cs) % 32 + 32) % 32;
    const int groups_in = (t.cols_in + sp - 1) / sp;
    const int rp0 = t.cols_in * cs + groups_in * t.padg;
    t.rp = rp0;
    for (int pad = 0; pad < 32; pad += step) {
      if (((stride * (rp0 + pad) - cs * ng) % 32 + 32) % 32 == 0) {
        t.rp = rp0 + pad;
        break;
      }
    }
    t.stage_words = t.rows_in * t.rp;
  } else {
    // a channel's plane of rows_in x cols_in bytes, an odd number of words
    // so that consecutive channels fall on distinct banks
    t.plane = t.rows_in * t.cols_in / 4;
    t.plane += (t.plane % 2 == 0);
    t.stage_words = t.plane * cs;
  }
  t.stage_words += (-t.stage_words) & 3;   // the second buffer 16-byte aligned
  const long long smem = 2LL * t.stage_words * 4;
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;

#define HAWQ_DW(V, S, P, COPY)                                              \
  if (vec == V && stride == S && p == P && copy == COPY)                   \
    return launch_tile<REQUANT, V, S, P, COPY>(x, w, bias, hi6, mult, out, \
                                               t, (int)smem, stream);
  HAWQ_DW(4, 1, 4, 16) HAWQ_DW(4, 1, 2, 16) HAWQ_DW(4, 2, 4, 16)
  HAWQ_DW(4, 2, 2, 16) HAWQ_DW(4, 1, 4, 4) HAWQ_DW(4, 1, 2, 4)
  HAWQ_DW(4, 2, 4, 4) HAWQ_DW(4, 2, 2, 4) HAWQ_DW(1, 1, 4, 1)
  HAWQ_DW(1, 2, 2, 1)
#undef HAWQ_DW
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x (B, H, W, C) int8, w (3, 3, 1, C) int8 (HWIO, as frozen), bias (C,)
// int32 -> out (B, (H-1)/s+1, (W-1)/s+1, C) int32.  The tile plan
// (kernels/depthwise.py DwPlan): vec, 4 or 1 channels a thread (4: C % 4,
// x, w and out 4-byte aligned); copy, the staging's bytes a copy (16: also
// C % 16, x 16-byte aligned and out 16-byte aligned; 4; 1 for vec 1); p,
// output pixels a thread; cs, channel units a block; ng, pixel groups a
// block along a row; rows, output rows a block.
extern "C" int hawq_dwconv_acc(const int8_t* x, const int8_t* w,
                               const int32_t* bias, int32_t* out, int B,
                               int H, int W, int C, int stride, int vec,
                               int copy, int p, int cs, int ng, int rows,
                               cudaStream_t stream) {
  return launch<false>(x, w, bias, nullptr, nullptr, out, B, H, W, C, stride,
                       0, 0, vec, copy, p, cs, ng, rows, stream);
}

// The same accumulator clamped to [0, hi6[c]], then clip(floor(f32(acc) *
// mult[c] + 0.5), lo, hi) -> out int8; hi6 (C,) int32, mult (C,) float32.
extern "C" int hawq_dwconv_requant(const int8_t* x, const int8_t* w,
                                   const int32_t* bias, const int32_t* hi6,
                                   const float* mult, int8_t* out, int B,
                                   int H, int W, int C, int stride, int lo,
                                   int hi, int vec, int copy, int p, int cs,
                                   int ng, int rows, cudaStream_t stream) {
  return launch<true>(x, w, bias, hi6, mult, out, B, H, W, C, stride, lo, hi,
                      vec, copy, p, cs, ng, rows, stream);
}
