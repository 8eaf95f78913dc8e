// Host batch assembly for the per-step engine and the raw-window path.
//
// The port's own copy of the three entry points of the JAX package's
// native batcher: a fused gather + uint8 -> float32 convert + affine
// normalize (+ per-row horizontal mirror, or gray -> RGB gains) into a
// caller's buffer, which on the card's host is a pinned staging buffer
// the copy to the card reads.  Rows are split across threads.
//
// Built with g++ at first use by ops/_build.py::build_host, with
// -ffp-contract=off: `x * scale + shift` stays one float32 multiply
// then one add, bit-equal to numpy's, never a fused multiply-add.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

void gather_rows_worker(const uint8_t* src, const int64_t* idx,
                        int64_t row_elems, float scale, float shift,
                        float* dst, int64_t row_begin, int64_t row_end) {
  for (int64_t r = row_begin; r < row_end; ++r) {
    const uint8_t* in = src + idx[r] * row_elems;
    float* out = dst + r * row_elems;
    for (int64_t e = 0; e < row_elems; ++e) {
      out[e] = static_cast<float>(in[e]) * scale + shift;
    }
  }
}

void gather_rows_flip_worker(const uint8_t* src, const int64_t* idx,
                             int64_t h, int64_t w, int64_t c, float scale,
                             float shift, const uint8_t* flip, float* dst,
                             int64_t row_begin, int64_t row_end) {
  // rows whose mask is set are mirrored along the width axis (the flip
  // is re-drawn for every batch, so it arrives as a per-row mask)
  const int64_t row_elems = h * w * c;
  for (int64_t r = row_begin; r < row_end; ++r) {
    const uint8_t* in = src + idx[r] * row_elems;
    float* out = dst + r * row_elems;
    if (!flip[r]) {
      for (int64_t e = 0; e < row_elems; ++e) {
        out[e] = static_cast<float>(in[e]) * scale + shift;
      }
      continue;
    }
    for (int64_t y = 0; y < h; ++y) {
      const uint8_t* in_row = in + y * w * c;
      float* out_row = out + y * w * c;
      for (int64_t x = 0; x < w; ++x) {
        const uint8_t* ip = in_row + (w - 1 - x) * c;
        float* op = out_row + x * c;
        for (int64_t ch = 0; ch < c; ++ch) {
          op[ch] = static_cast<float>(ip[ch]) * scale + shift;
        }
      }
    }
  }
}

void gather_tile3_worker(const uint8_t* src, const int64_t* idx,
                         int64_t row_elems, const float* gains, float scale,
                         float shift, float* dst, int64_t row_begin,
                         int64_t row_end) {
  // gray row -> 3-channel row with per-image RGB gains
  for (int64_t r = row_begin; r < row_end; ++r) {
    const uint8_t* in = src + idx[r] * row_elems;
    float* out = dst + r * row_elems * 3;
    const float g0 = gains[r * 3 + 0], g1 = gains[r * 3 + 1],
                g2 = gains[r * 3 + 2];
    for (int64_t e = 0; e < row_elems; ++e) {
      const float v = static_cast<float>(in[e]) * scale + shift;
      out[e * 3 + 0] = v * g0;
      out[e * 3 + 1] = v * g1;
      out[e * 3 + 2] = v * g2;
    }
  }
}

template <typename Fn>
void parallel_rows(int64_t n_rows, int n_threads, Fn fn) {
  if (n_threads <= 1 || n_rows < 2 * n_threads) {
    fn(0, n_rows);
    return;
  }
  std::vector<std::thread> threads;
  const int64_t chunk = (n_rows + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    const int64_t begin = t * chunk;
    const int64_t end = begin + chunk < n_rows ? begin + chunk : n_rows;
    if (begin >= end) break;
    threads.emplace_back([=] { fn(begin, end); });
  }
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// dst[r] = src[idx[r]] * scale + shift, rows of row_elems uint8 -> f32
void eadgan_gather_norm_u8(const uint8_t* src, const int64_t* idx,
                           int64_t n_rows, int64_t row_elems, float scale,
                           float shift, float* dst, int n_threads) {
  parallel_rows(n_rows, n_threads, [=](int64_t b, int64_t e) {
    gather_rows_worker(src, idx, row_elems, scale, shift, dst, b, e);
  });
}

// dst[r] = maybe-mirrored src[idx[r]] * scale + shift; flip is a
// per-row uint8 mask (1 = mirror the width axis)
void eadgan_gather_norm_flip_u8(const uint8_t* src, const int64_t* idx,
                                int64_t n_rows, int64_t h, int64_t w,
                                int64_t c, float scale, float shift,
                                const uint8_t* flip, float* dst,
                                int n_threads) {
  parallel_rows(n_rows, n_threads, [=](int64_t b, int64_t e) {
    gather_rows_flip_worker(src, idx, h, w, c, scale, shift, flip, dst, b, e);
  });
}

// gray -> RGB with per-image channel gains (n_rows x 3)
void eadgan_gather_colorize_u8(const uint8_t* src, const int64_t* idx,
                               int64_t n_rows, int64_t row_elems,
                               const float* gains, float scale, float shift,
                               float* dst, int n_threads) {
  parallel_rows(n_rows, n_threads, [=](int64_t b, int64_t e) {
    gather_tile3_worker(src, idx, row_elems, gains, scale, shift, dst, b, e);
  });
}

}  // extern "C"
