// hawq_preproc — native host data plane of the port's serving pipeline:
// the host-side loops that would otherwise hold the card back.
//   * bilinear resize + center-crop + mean/std normalize (uint8 HWC ->
//     float32 HWC), threaded across a batch
//   * the 4x4 block folds of the init-conv input
//     (hawq_tpu_torch/inference/fold.py)
//
// The JAX package's csrc/hawq_preproc.cpp code for these two, so both give
// the same bytes.  Its quantize_int8, pack_int4_splitk and fold4 entries are
// left out: numpy is as fast or faster for them on the H100 machine's host
// (PERF.md, "host input prep"), and the port runs numpy there.  A plain C
// ABI consumed through ctypes (hawq_tpu_torch/utils/preproc.py), built there
// at first use with g++ -O3 -march=native -std=c++17 -fPIC -shared -pthread.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

int hw_threads() {
  unsigned n = std::thread::hardware_concurrency();
  return n == 0 ? 2 : static_cast<int>(n);
}

// Run fn(i) for i in [0, n) over a transient thread pool.
template <typename F>
void parallel_for(int64_t n, F fn) {
  const int nt = std::min<int64_t>(hw_threads(), n);
  if (nt <= 1) {
    for (int64_t i = 0; i < n; ++i) fn(i);
    return;
  }
  std::atomic<int64_t> next(0);
  std::vector<std::thread> threads;
  threads.reserve(nt);
  for (int t = 0; t < nt; ++t) {
    threads.emplace_back([&] {
      for (;;) {
        int64_t i = next.fetch_add(1);
        if (i >= n) return;
        fn(i);
      }
    });
  }
  for (auto& th : threads) th.join();
}

// Bilinear sample of channel c at (y, x) from a uint8 HWC image.
inline float bilinear(const uint8_t* img, int h, int w, int c_stride, int c,
                      float y, float x) {
  const int y0 = std::max(0, std::min(h - 1, static_cast<int>(y)));
  const int x0 = std::max(0, std::min(w - 1, static_cast<int>(x)));
  const int y1 = std::min(h - 1, y0 + 1);
  const int x1 = std::min(w - 1, x0 + 1);
  const float fy = y - static_cast<float>(y0);
  const float fx = x - static_cast<float>(x0);
  const float v00 = img[(y0 * w + x0) * c_stride + c];
  const float v01 = img[(y0 * w + x1) * c_stride + c];
  const float v10 = img[(y1 * w + x0) * c_stride + c];
  const float v11 = img[(y1 * w + x1) * c_stride + c];
  return v00 * (1 - fy) * (1 - fx) + v01 * (1 - fy) * fx +
         v10 * fy * (1 - fx) + v11 * fy * fx;
}

}  // namespace

extern "C" {

// uint8 HWC images (all h_in x w_in x 3) -> resize shorter side to `resize`,
// center-crop `crop`, normalize ((v/255 - mean) / std) -> float32 NHWC out.
void preprocess_batch(const uint8_t* images, int batch, int h_in, int w_in,
                      int resize, int crop, const float* mean,
                      const float* std, float* out) {
  const int64_t in_sz = static_cast<int64_t>(h_in) * w_in * 3;
  const int64_t out_sz = static_cast<int64_t>(crop) * crop * 3;
  float rh, rw;
  if (w_in < h_in) {
    rw = static_cast<float>(resize);
    rh = rw * h_in / w_in;
  } else {
    rh = static_cast<float>(resize);
    rw = rh * w_in / h_in;
  }
  const float sy = h_in / rh, sx = w_in / rw;
  const float oy = (rh - crop) * 0.5f, ox = (rw - crop) * 0.5f;
  float sd[3], m[3];
  for (int c = 0; c < 3; ++c) {
    sd[c] = std[c];
    m[c] = mean[c];
  }
  parallel_for(batch, [&](int64_t b) {
    const uint8_t* img = images + b * in_sz;
    float* dst = out + b * out_sz;
    for (int y = 0; y < crop; ++y) {
      const float say = (oy + y + 0.5f) * sy - 0.5f;
      for (int x = 0; x < crop; ++x) {
        const float sax = (ox + x + 0.5f) * sx - 0.5f;
        for (int c = 0; c < 3; ++c) {
          const float v =
              bilinear(img, h_in, w_in, 3, c, say, sax) / 255.0f;
          dst[(y * crop + x) * 3 + c] = (v - m[c]) / sd[c];
        }
      }
    }
  });
}

// 4x4 block fold of the init-conv input: a pure permutation done while
// assembling the batch, so the device never touches a C-minor image.
// Generalized for arbitrary pad-before / folded dims; the port calls it for
// the 3x3/s2 folds (hawq_tpu_torch/inference/fold.py fold4_images_3x3s2:
// MobileNetV2 pad0=1, InceptionV3 pad0=0).
// (B, H, W, C) -> (B, fh, fw, 16C); spatial position
// (4*by + ry - pad0, 4*bx + rx - pad0) lands in block channel (ry, rx);
// out-of-image positions are zero padding.
void fold4_general(const uint8_t* x, int batch, int h, int w, int c,
                   int elem_size, int pad0, int fh, int fw, uint8_t* out) {
  const int pc = c * elem_size;                 // bytes per pixel
  const int64_t in_row = static_cast<int64_t>(w) * pc;
  const int64_t in_img = in_row * h;
  const int64_t out_img = static_cast<int64_t>(fh) * fw * 16 * pc;
  parallel_for(static_cast<int64_t>(batch) * fh, [&](int64_t t) {
    const int64_t b = t / fh;
    const int by = t % fh;
    uint8_t* dst = out + b * out_img +
                   static_cast<int64_t>(by) * fw * 16 * pc;
    std::memset(dst, 0, static_cast<size_t>(fw) * 16 * pc);
    for (int ry = 0; ry < 4; ++ry) {
      const int y = by * 4 + ry - pad0;
      if (y < 0 || y >= h) continue;
      const uint8_t* src_row = x + b * in_img + y * in_row;
      for (int bx = 0; bx < fw; ++bx) {
        for (int rx = 0; rx < 4; ++rx) {
          const int xx = bx * 4 + rx - pad0;
          if (xx < 0 || xx >= w) continue;
          std::memcpy(dst + (static_cast<int64_t>(bx) * 16 +
                             ry * 4 + rx) * pc,
                      src_row + static_cast<int64_t>(xx) * pc, pc);
        }
      }
    }
  });
}

}  // extern "C"
