// Shared int8 tensor-core GEMM core for the conv and matmul kernels.
//
// out[m, n] = epilogue(sum_k A[m, k] * W[k, n] + bias[n])
//
// A is read through a row map: for the matmul A[m, k] = x[m*K + k]; for the
// implicit-GEMM conv, row m is output pixel (b, oy, ox) and k = (dy*kw + dx)*C
// + c reads the zero-padded slab xp[b, oy+dy, (ox+dx)*C + c].  W is the
// (K, N) row-major int8 weight; it is transposed into shared memory in 4x4
// byte blocks so that each mma B fragment is one 32-bit shared load.
//
// With INT4, W arrives nibble-packed, (K/2, N) bytes: in each tap block of C
// unpacked rows (the matmul is one tap, C = K), packed row t*C/2 + c holds
// row c in its low nibble and row c + C/2 in its high nibble.  The W loader
// reads the packed bytes and sign-extends the wanted nibble of each to an
// int8 on the way into shared memory; the product itself is the same s8*s8
// mma (Hopper's tensor cores have no 4-bit integer type).
//
// Products run on mma.sync.m16n8k32 s8*s8->s32 (exact int32 accumulation).
// A 128-thread block computes a 64x64 tile, each warp 32x32, K in steps of
// 64 with a register prefetch of the next K tile.  Ragged M, N and K edges
// are masked; 16-byte A loads and 4-byte W loads are used where the wrapper
// says shapes and pointers allow, byte loads otherwise.
//
// The requant epilogue is clip(floor(f32(acc + bias) * mult[n] + 0.5)) with
// a rounded multiply and then a rounded add (__fmul_rn, __fadd_rn): nvcc
// would otherwise contract them into one FMA, which rounds once and flips
// borderline values against the reference.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "requant.cuh"

namespace hawq {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 64;
constexpr int LDS = BK + 16;   // smem row stride in bytes: 20 words, so the
                               // 8 fragment rows of a warp hit distinct banks
constexpr int THREADS = 128;

struct GemmArgs {
  const int8_t* a;      // x (M, K) for the matmul, padded slab for the conv
  const int8_t* w;      // (K, N)
  const int32_t* bias;  // (N,)
  const float* mult;    // (N,), requant only
  void* out;            // (M, N) int8 (requant) or int32 (acc)
  int M, N, K;              // K counts unpacked rows
  int H, W, C, kw, Hp, Wp;  // conv geometry (output H, W; slab Hp, Wp);
                            // C is also the int4 tap block (K for the matmul)
  int lo, hi;               // requant clip bounds
  int vec_a, vec_b;         // 16-byte A loads / 4-byte W loads allowed
};

__device__ __forceinline__ void mma_s8(int32_t (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Offset of A[m, k] from the row base of m.
template <bool CONV>
__device__ __forceinline__ long long a_col_offset(const GemmArgs& p, int k) {
  if (!CONV) return k;
  int t = k / p.C;
  int c = k - t * p.C;
  int dy = t / p.kw;
  int dx = t - dy * p.kw;
  return ((long long)dy * p.Wp + dx) * p.C + c;
}

template <bool CONV>
__device__ __forceinline__ long long a_row_base(const GemmArgs& p, int m) {
  if (!CONV) return (long long)m * p.K;
  int hw = p.H * p.W;
  int b = m / hw;
  int r = m - b * hw;
  int oy = r / p.W;
  int ox = r - oy * p.W;
  return (((long long)b * p.Hp + oy) * p.Wp + ox) * p.C;
}

// Two 16-byte chunks of the A tile per thread: rows tid/4 and tid/4 + 32,
// byte offset (tid % 4) * 16 within the K tile.
template <bool CONV>
__device__ __forceinline__ void load_a(const GemmArgs& p, const long long (&rb)[2],
                                       const bool (&rv)[2], int k0, int tid,
                                       uint4 (&ra)[2]) {
  int kc = k0 + (tid & 3) * 16;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (p.vec_a) {
      if (rv[i] && kc < p.K) {
        ra[i] = *reinterpret_cast<const uint4*>(p.a + rb[i] + a_col_offset<CONV>(p, kc));
      } else {
        ra[i] = make_uint4(0, 0, 0, 0);
      }
    } else {
      uint32_t wv[4] = {0, 0, 0, 0};
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        int k = kc + j;
        if (rv[i] && k < p.K) {
          uint32_t byte = (uint8_t)p.a[rb[i] + a_col_offset<CONV>(p, k)];
          wv[j >> 2] |= byte << ((j & 3) * 8);
        }
      }
      ra[i] = make_uint4(wv[0], wv[1], wv[2], wv[3]);
    }
  }
}

// Four packed int4 values (one per byte, low or high nibble) → four
// sign-extended int8 bytes: bit 3 of each byte is copied into bits 4..7
// (u | (u & 0x08)·0x1E per byte; no carries cross a byte).  A masked zero
// byte stays 0.
__device__ __forceinline__ uint32_t sext_nibbles(uint32_t v, bool high) {
  uint32_t u = (high ? v >> 4 : v) & 0x0F0F0F0Fu;
  return u | ((u & 0x08080808u) * 0x1Eu);
}

// Two 4x4 byte blocks of the W tile per thread: block id = tid + 128 i,
// k rows (id % 16) * 4 .. +3 (the same four rows for both blocks), n
// columns (id / 16) * 4 .. +3.  Each of the four words holds 4 n-bytes of
// one k row.  With INT4 the four rows' packed offsets and nibbles are
// worked out once per K tile: one division, then a step per row.  The words
// stay packed here; bit r of ``hmask`` says that row r takes the high
// nibbles, and store_tiles unpacks them, so that no instruction waits on
// the loads before the mma loop that they overlap.
template <bool INT4>
__device__ __forceinline__ void load_b(const GemmArgs& p, int k0, int n0, int tid,
                                       uint32_t (&rb)[2][4], uint32_t& hmask) {
  const int kr = k0 + (tid & 15) * 4;
  long long roff[4];
  hmask = 0;
  if (INT4) {      // unpacked row k → packed row t*C/2 + c mod C/2, nibble
    const int h = p.C >> 1;
    int t = kr / p.C;
    int c = kr - t * p.C;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      bool high = c >= h;
      hmask |= (uint32_t)high << r;
      roff[r] = (long long)(t * h + (high ? c - h : c)) * p.N;
      if (++c == p.C) {
        c = 0;
        ++t;
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < 4; ++r) roff[r] = (long long)(kr + r) * p.N;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    int nc = n0 + ((tid + i * THREADS) >> 4) * 4;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      uint32_t v = 0;
      if (kr + r < p.K) {
        const int8_t* row = p.w + roff[r];
        if (p.vec_b) {
          if (nc < p.N) v = *reinterpret_cast<const uint32_t*>(row + nc);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (nc + j < p.N) v |= (uint32_t)(uint8_t)row[nc + j] << (j * 8);
        }
      }
      rb[i][r] = v;
    }
  }
}

template <bool INT4>
__device__ __forceinline__ void store_tiles(uint8_t* As, uint8_t* Bs, int tid,
                                            const uint4 (&ra)[2],
                                            const uint32_t (&rb)[2][4],
                                            uint32_t hmask) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    int row = (tid >> 2) + i * 32;
    *reinterpret_cast<uint4*>(As + row * LDS + (tid & 3) * 16) = ra[i];
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    int id = tid + i * THREADS;
    int kr = (id & 15) * 4;
    int nc = (id >> 4) * 4;
    uint32_t b[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      b[r] = INT4 ? sext_nibbles(rb[i][r], (hmask >> r) & 1) : rb[i][r];
    // 4x4 byte transpose: word j of the result holds column n = nc + j
    // for k rows kr .. kr+3.
    uint32_t t0 = __byte_perm(b[0], b[1], 0x5140);
    uint32_t t1 = __byte_perm(b[0], b[1], 0x7362);
    uint32_t t2 = __byte_perm(b[2], b[3], 0x5140);
    uint32_t t3 = __byte_perm(b[2], b[3], 0x7362);
    *reinterpret_cast<uint32_t*>(Bs + (nc + 0) * LDS + kr) = __byte_perm(t0, t2, 0x5410);
    *reinterpret_cast<uint32_t*>(Bs + (nc + 1) * LDS + kr) = __byte_perm(t0, t2, 0x7632);
    *reinterpret_cast<uint32_t*>(Bs + (nc + 2) * LDS + kr) = __byte_perm(t1, t3, 0x5410);
    *reinterpret_cast<uint32_t*>(Bs + (nc + 3) * LDS + kr) = __byte_perm(t1, t3, 0x7632);
  }
}

// The tile loop: accumulates A[m0.., k] * W[k, n0..] for k in [k_begin, k_end)
// into the warp's 32x32 piece of the block's 64x64 tile.  k_begin must be a
// multiple of BK; loads beyond p.K are masked, so k_end may be ragged only
// where it equals p.K.
template <bool CONV, bool INT4>
__device__ __forceinline__ void gemm_s8_mainloop(const GemmArgs& p, int m0, int n0,
                                                 int k_begin, int k_end,
                                                 uint8_t* As, uint8_t* Bs,
                                                 int32_t (&acc)[2][4][4]) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int g = lane >> 2, t4 = lane & 3;

  long long rbase[2];
  bool rvalid[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    int m = m0 + (tid >> 2) + i * 32;
    rvalid[i] = m < p.M;
    rbase[i] = rvalid[i] ? a_row_base<CONV>(p, m) : 0;
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0;

  uint4 ra[2];
  uint32_t rb[2][4];
  uint32_t hmask;
  load_a<CONV>(p, rbase, rvalid, k_begin, tid, ra);
  load_b<INT4>(p, k_begin, n0, tid, rb, hmask);

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    store_tiles<INT4>(As, Bs, tid, ra, rb, hmask);
    __syncthreads();
    if (k0 + BK < k_end) {        // prefetch the next K tile into registers
      load_a<CONV>(p, rbase, rvalid, k0 + BK, tid, ra);
      load_b<INT4>(p, k0 + BK, n0, tid, rb, hmask);
    }
#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      uint32_t af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const uint8_t* base = As + (wm * 32 + mi * 16 + g) * LDS + ks + t4 * 4;
        af[mi][0] = *reinterpret_cast<const uint32_t*>(base);
        af[mi][1] = *reinterpret_cast<const uint32_t*>(base + 8 * LDS);
        af[mi][2] = *reinterpret_cast<const uint32_t*>(base + 16);
        af[mi][3] = *reinterpret_cast<const uint32_t*>(base + 8 * LDS + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const uint8_t* base = Bs + (wn * 32 + ni * 8 + g) * LDS + ks + t4 * 4;
        uint32_t b0 = *reinterpret_cast<const uint32_t*>(base);
        uint32_t b1 = *reinterpret_cast<const uint32_t*>(base + 16);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) mma_s8(acc[mi][ni], af[mi], b0, b1);
      }
    }
    __syncthreads();
  }
}

// clip(floor(f32(v) * mult + 0.5), lo, hi) as int8: a rounded multiply, then
// a rounded add (see the note at the top of this file; requant.cuh).
__device__ __forceinline__ int8_t requant_s8(int32_t v, float mult, int lo, int hi) {
  return (int8_t)__float2int_rz(requant_f32(v, mult, (float)lo, (float)hi));
}

template <bool CONV, bool REQUANT, bool INT4>
__global__ void __launch_bounds__(THREADS)
gemm_s8_kernel(const GemmArgs p) {
  __shared__ __align__(16) uint8_t As[BM * LDS];
  __shared__ __align__(16) uint8_t Bs[BN * LDS];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int g = lane >> 2, t4 = lane & 3;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  int32_t acc[2][4][4];
  gemm_s8_mainloop<CONV, INT4>(p, m0, n0, 0, p.K, As, Bs, acc);

  // Epilogue: c0, c1 at row g, columns 2*t4 + {0, 1}; c2, c3 at row g + 8.
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        int m = m0 + wm * 32 + mi * 16 + g + (r >> 1) * 8;
        int n = n0 + wn * 32 + ni * 8 + t4 * 2 + (r & 1);
        if (m >= p.M || n >= p.N) continue;
        int32_t v = acc[mi][ni][r] + p.bias[n];
        long long o = (long long)m * p.N + n;
        if (REQUANT) {
          static_cast<int8_t*>(p.out)[o] = requant_s8(v, p.mult[n], p.lo, p.hi);
        } else {
          static_cast<int32_t*>(p.out)[o] = v;
        }
      }
    }
  }
}

template <bool CONV>
inline int launch_gemm_s8(const GemmArgs& p, int requant, int int4,
                          cudaStream_t stream) {
  dim3 grid((p.M + BM - 1) / BM, (p.N + BN - 1) / BN);
  if (requant && int4)
    gemm_s8_kernel<CONV, true, true><<<grid, THREADS, 0, stream>>>(p);
  else if (requant)
    gemm_s8_kernel<CONV, true, false><<<grid, THREADS, 0, stream>>>(p);
  else if (int4)
    gemm_s8_kernel<CONV, false, true><<<grid, THREADS, 0, stream>>>(p);
  else
    gemm_s8_kernel<CONV, false, false><<<grid, THREADS, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace hawq
