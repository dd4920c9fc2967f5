// retr_tpu_torch native preprocessing core: a copy of retr_tpu's native/preprocess.cc
// (the same code; built and loaded by retr_tpu_torch/native/__init__.py).
//
// The reference's per-sample image work runs inside PIL/torchvision C code
// (data_utils/refcoco.py:147-171). This is the equivalent native component for the
// retr_tpu host pipeline: pad-to-square + PIL-BILINEAR-exact fixed-point resize for
// uint8 images, and the reference's mask path (floor/ceil True-padding +
// torch-bilinear 2-tap resize + nonzero cast), with a multithreaded batch API.
//
// Bit-exactness contract: identical output to retr_tpu_torch.ops.image.pil_resize_uint8 /
// pad_uint8_to_square / pad_mask_to_square + torch_bilinear_weights (the numpy
// implementations are the executable spec; tests/test_torch_native.py enforces equality).
//
// Build: g++ -O3 -march=native -shared -fPIC -std=c++17 -o libretr_preprocess.so preprocess.cc -lpthread
// (-march=native optional: it only enables wider auto-vectorization; output is
// bit-identical with plain -O3 because all arithmetic is integer fixed-point.)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int kPrecisionBits = 32 - 8 - 2;  // Pillow Resample.c

// round-half-to-even (Python round / PIL ImageOps.pad centering)
inline long round_half_even(double x) {
  double r = std::nearbyint(x);  // default FE_TONEAREST = half-to-even
  return static_cast<long>(r);
}

struct Coeffs {
  // sparse per-output-pixel support windows (PIL-style): bounds[o] = {xmin, count},
  // k packed at o*kmax. Only ~2*scale taps per output pixel are nonzero.
  //
  // int32 is exact: bilinear weights are non-negative and the quantized taps sum to
  // ~2^22 (kPrecisionBits), so max acc = 255 * (2^22 + n/2) + 2^21 < 2^31.
  std::vector<int32_t> k;
  std::vector<int> xmin;
  std::vector<int> count;
  int kmax = 0;
  int in_size = 0;
  int out_size = 0;
};

// PIL precompute_coeffs for BILINEAR (support=1), quantized like Pillow 8bpc.
Coeffs pil_coeffs(int in_size, int out_size) {
  Coeffs c;
  c.in_size = in_size;
  c.out_size = out_size;
  const double scale = static_cast<double>(in_size) / out_size;
  const double filterscale = std::max(scale, 1.0);
  const double support = 1.0 * filterscale;
  const double inv = 1.0 / filterscale;
  c.kmax = static_cast<int>(std::ceil(support)) * 2 + 1;
  c.k.assign(static_cast<size_t>(out_size) * c.kmax, 0);
  c.xmin.resize(out_size);
  c.count.resize(out_size);
  std::vector<double> w(c.kmax);
  for (int xx = 0; xx < out_size; ++xx) {
    const double center = (xx + 0.5) * scale;
    int xmin = std::max(static_cast<int>(center - support + 0.5), 0);
    int xmax = std::min(static_cast<int>(center + support + 0.5), in_size);
    int n = xmax - xmin;
    double ssum = 0.0;
    for (int i = 0; i < n; ++i) {
      double v = 1.0 - std::fabs((xmin + i - center + 0.5) * inv);
      if (v < 0.0) v = 0.0;
      w[i] = v;
      ssum += v;
    }
    int32_t* krow = c.k.data() + static_cast<size_t>(xx) * c.kmax;
    for (int i = 0; i < n; ++i) {
      double kk = (ssum != 0.0) ? (w[i] / ssum) : 0.0;
      double scaled = kk * (1 << kPrecisionBits);
      krow[i] = static_cast<int32_t>(scaled < 0 ? scaled - 0.5 : scaled + 0.5);
    }
    c.xmin[xx] = xmin;
    c.count[xx] = n;
  }
  return c;
}

inline uint8_t clip8(int32_t acc) {
  int32_t v = acc >> kPrecisionBits;
  if (v < 0) return 0;
  if (v > 255) return 255;
  return static_cast<uint8_t>(v);
}

// Blocked transpose of the spatial dims of an HWC uint8 image:
// dstT[x * h * c + y * c + ch] = src[y * w * c + x * c + ch].
void transpose_hwc(const uint8_t* src, int h, int w, int channels, uint8_t* dstT) {
  constexpr int kB = 32;
  for (int yb = 0; yb < h; yb += kB) {
    const int ye = std::min(yb + kB, h);
    for (int xb = 0; xb < w; xb += kB) {
      const int xe = std::min(xb + kB, w);
      for (int y = yb; y < ye; ++y) {
        const uint8_t* s = src + (static_cast<size_t>(y) * w + xb) * channels;
        uint8_t* d = dstT + (static_cast<size_t>(xb) * h + y) * channels;
        const size_t dstride = static_cast<size_t>(h) * channels;
        for (int x = xb; x < xe; ++x) {
          for (int ch = 0; ch < channels; ++ch) d[ch] = s[ch];
          s += channels;
          d += dstride;
        }
      }
    }
  }
}

// One separable-convolution pass along the LEADING spatial dim of a [len_conv,
// len_keep, C] uint8 buffer -> [out, len_keep, C]. Because the convolved dim is
// leading, the inner loop is a contiguous saxpy over len_keep*C elements that the
// compiler vectorizes (int32 accumulators; exactness per the Coeffs comment).
void conv_pass_leading(const uint8_t* src, int len_keep, int channels,
                       const Coeffs& c, int32_t* __restrict acc, uint8_t* dst) {
  const size_t row = static_cast<size_t>(len_keep) * channels;
  const int32_t half = 1 << (kPrecisionBits - 1);
  for (int o = 0; o < c.out_size; ++o) {
    const int32_t* krow = c.k.data() + static_cast<size_t>(o) * c.kmax;
    const int n = c.count[o];
    for (size_t j = 0; j < row; ++j) acc[j] = half;
    for (int i = 0; i < n; ++i) {
      const int32_t k = krow[i];
      const uint8_t* __restrict s = src + (static_cast<size_t>(c.xmin[o]) + i) * row;
      for (size_t j = 0; j < row; ++j) acc[j] += k * s[j];
    }
    uint8_t* d = dst + static_cast<size_t>(o) * row;
    for (size_t j = 0; j < row; ++j) d[j] = clip8(acc[j]);
  }
}

// Resize a uint8 HWC image (already square, side m) to out x out, PIL-exact:
// horizontal pass then vertical pass with per-pass rounding (Pillow's two-pass
// 8bpc pipeline). Each pass runs over a transposed layout so the support-window
// accumulation is a contiguous vectorizable loop instead of a strided gather —
// this is what took the scalar core from 165 img/s to Pillow-beating throughput.
void pil_resize_square(const uint8_t* img, int m, int channels, int out,
                       uint8_t* dst) {
  Coeffs cw = pil_coeffs(m, out);
  std::vector<int32_t> acc(static_cast<size_t>(std::max(m, out)) * channels);
  // horizontal conv via transpose: img [m,m,C] -> T [m(x),m(y),C];
  // convolve leading x -> tmpT [out(x), m(y), C]; transpose back.
  std::vector<uint8_t> T(static_cast<size_t>(m) * m * channels);
  transpose_hwc(img, m, m, channels, T.data());
  std::vector<uint8_t> tmpT(static_cast<size_t>(out) * m * channels);
  conv_pass_leading(T.data(), m, channels, cw, acc.data(), tmpT.data());
  std::vector<uint8_t> tmp(static_cast<size_t>(m) * out * channels);
  transpose_hwc(tmpT.data(), out, m, channels, tmp.data());
  // vertical conv: y is already the leading dim of tmp [m(y), out(x), C].
  conv_pass_leading(tmp.data(), out, channels, cw, acc.data(), dst);
}

// ---------------------------------------------------------------------------------
// RGB fast path: pad-to-square + resize without ever materializing padded pixels.
//
// The black pad contributes zero to every tap, so each conv pass just clamps its
// support window to the real-pixel range ([x0, x0+w) horizontally, [y0, y0+h)
// vertically) — identical accumulator values to convolving the padded square.
// Pixels travel as RGBX uint32 lanes so both transposes are plain 4-byte moves
// and the conv saxpy runs over a x4-channel row (the X lane computes zeros and is
// stripped at the final store).
// ---------------------------------------------------------------------------------

// img [h, w, 3] uint8 -> dstT [w, h] uint32 (RGBX, X=0), blocked transpose+widen.
void transpose_widen_rgbx(const uint8_t* img, int h, int w, uint32_t* dstT) {
  const uint8_t* end = img + static_cast<size_t>(h) * w * 3;
  constexpr int kB = 48;
  for (int yb = 0; yb < h; yb += kB) {
    const int ye = std::min(yb + kB, h);
    for (int xb = 0; xb < w; xb += kB) {
      const int xe = std::min(xb + kB, w);
      for (int y = yb; y < ye; ++y) {
        const uint8_t* s = img + (static_cast<size_t>(y) * w + xb) * 3;
        uint32_t* d = dstT + static_cast<size_t>(xb) * h + y;
        for (int x = xb; x < xe; ++x, s += 3, d += h) {
          uint32_t v;
          if (s + 4 <= end) {
            std::memcpy(&v, s, 4);
            v &= 0x00FFFFFFu;
          } else {  // very last pixel of the image: no 4th byte to overread
            v = static_cast<uint32_t>(s[0]) | (static_cast<uint32_t>(s[1]) << 8) |
                (static_cast<uint32_t>(s[2]) << 16);
          }
          *d = v;
        }
      }
    }
  }
}

// [rows, cols] uint32 -> [cols, rows] uint32, blocked.
void transpose_u32(const uint32_t* src, int rows, int cols, uint32_t* dst) {
  constexpr int kB = 48;
  for (int rb = 0; rb < rows; rb += kB) {
    const int re = std::min(rb + kB, rows);
    for (int cb = 0; cb < cols; cb += kB) {
      const int ce = std::min(cb + kB, cols);
      for (int r = rb; r < re; ++r) {
        const uint32_t* s = src + static_cast<size_t>(r) * cols + cb;
        uint32_t* d = dst + static_cast<size_t>(cb) * rows + r;
        for (int c = cb; c < ce; ++c, ++s, d += rows) *d = *s;
      }
    }
  }
}

// Conv along the leading dim with the support window clamped to the real rows
// [lo, lo+real_len) of the virtual padded input; src holds ONLY the real rows.
// row_bytes = len_keep * 4 (RGBX). dst rows are RGBX unless compact_rgb, in which
// case each group of 4 lanes is stored as 3 bytes (the final pass writing HWC RGB).
void conv_pass_clamped_rgbx(const uint8_t* src, int row_bytes, const Coeffs& c,
                            int lo, int real_len, int32_t* __restrict acc,
                            uint8_t* dst, bool compact_rgb) {
  const int32_t half = 1 << (kPrecisionBits - 1);
  const size_t out_row = compact_rgb ? static_cast<size_t>(row_bytes) / 4 * 3
                                     : static_cast<size_t>(row_bytes);
  for (int o = 0; o < c.out_size; ++o) {
    const int32_t* krow = c.k.data() + static_cast<size_t>(o) * c.kmax;
    const int xmin = c.xmin[o];
    const int i0 = std::max(0, lo - xmin);
    const int i1 = std::min(c.count[o], lo + real_len - xmin);
    for (int j = 0; j < row_bytes; ++j) acc[j] = half;
    for (int i = i0; i < i1; ++i) {
      const int32_t k = krow[i];
      const uint8_t* __restrict s =
          src + static_cast<size_t>(xmin + i - lo) * row_bytes;
      for (int j = 0; j < row_bytes; ++j) acc[j] += k * s[j];
    }
    uint8_t* d = dst + static_cast<size_t>(o) * out_row;
    if (compact_rgb) {
      for (int p = 0; p < row_bytes / 4; ++p) {
        d[3 * p] = clip8(acc[4 * p]);
        d[3 * p + 1] = clip8(acc[4 * p + 1]);
        d[3 * p + 2] = clip8(acc[4 * p + 2]);
      }
    } else {
      for (int j = 0; j < row_bytes; ++j) d[j] = clip8(acc[j]);
    }
  }
}

// Fused pad-to-square + PIL-exact resize for RGB, zero padded-pixel traffic.
void pad_resize_rgb(const uint8_t* img, int h, int w, int out, uint8_t* dst) {
  const int m = std::max(h, w);
  long y0 = 0, x0 = 0;
  if (w < m) x0 = round_half_even((m - w) * 0.5);
  else if (h < m) y0 = round_half_even((m - h) * 0.5);
  Coeffs c = pil_coeffs(m, out);
  std::vector<int32_t> acc(static_cast<size_t>(std::max(h, out)) * 4);
  // pass 1 (horizontal): transpose+widen [h,w,3] -> [w(x), h(y)] RGBX, conv x.
  std::vector<uint32_t> T(static_cast<size_t>(w) * h);
  transpose_widen_rgbx(img, h, w, T.data());
  std::vector<uint32_t> tmpT(static_cast<size_t>(out) * h);
  conv_pass_clamped_rgbx(reinterpret_cast<const uint8_t*>(T.data()), h * 4, c,
                         static_cast<int>(x0), w, acc.data(),
                         reinterpret_cast<uint8_t*>(tmpT.data()), false);
  // pass 2 (vertical): transpose back to [h(y), out(x)] RGBX, conv y, emit RGB.
  std::vector<uint32_t> tmp(static_cast<size_t>(h) * out);
  transpose_u32(tmpT.data(), out, h, tmp.data());
  conv_pass_clamped_rgbx(reinterpret_cast<const uint8_t*>(tmp.data()), out * 4, c,
                         static_cast<int>(y0), h, acc.data(), dst, true);
}

// pad to square (black fill, ImageOps.pad banker's-round centering) into buf.
void pad_square_image(const uint8_t* img, int h, int w, int channels,
                      std::vector<uint8_t>* buf, int* m_out) {
  int m = std::max(h, w);
  *m_out = m;
  buf->assign(static_cast<size_t>(m) * m * channels, 0);
  long y0 = 0, x0 = 0;
  if (w < m) x0 = round_half_even((m - w) * 0.5);
  else if (h < m) y0 = round_half_even((m - h) * 0.5);
  for (int y = 0; y < h; ++y) {
    std::memcpy(buf->data() + ((y0 + y) * static_cast<size_t>(m) + x0) * channels,
                img + static_cast<size_t>(y) * w * channels,
                static_cast<size_t>(w) * channels);
  }
}

// mask: pad True (1) with floor/ceil centering (utils.py:242-256), then
// torch-bilinear (align_corners=false, antialias=false) resize; out = any
// positive-weight tap hits a True pixel.
void pad_resize_mask(const uint8_t* mask, int h, int w, int out, uint8_t* dst) {
  int m = std::max(h, w);
  std::vector<uint8_t> sq(static_cast<size_t>(m) * m, 1);
  long y0 = 0, x0 = 0;
  if (w < m) x0 = (m - w) / 2;        // floor leading
  else if (h < m) y0 = (m - h) / 2;
  for (int y = 0; y < h; ++y)
    std::memcpy(sq.data() + (y0 + y) * static_cast<size_t>(m) + x0,
                mask + static_cast<size_t>(y) * w, w);

  const double scale = static_cast<double>(m) / out;
  std::vector<int> t0(out), t1(out);
  std::vector<double> f1(out);
  for (int o = 0; o < out; ++o) {
    double src = std::max((o + 0.5) * scale - 0.5, 0.0);
    int a = std::min(static_cast<int>(std::floor(src)), m - 1);
    int b = std::min(a + 1, m - 1);
    t0[o] = a;
    t1[o] = b;
    f1[o] = src - a;
  }
  // nonzero-sum semantics: True iff any tap with weight > 0 is True.
  for (int oy = 0; oy < out; ++oy) {
    for (int ox = 0; ox < out; ++ox) {
      double w00 = (1.0 - f1[oy]) * (1.0 - f1[ox]);
      double w01 = (1.0 - f1[oy]) * f1[ox];
      double w10 = f1[oy] * (1.0 - f1[ox]);
      double w11 = f1[oy] * f1[ox];
      bool v = false;
      if (w00 > 0.0 && sq[static_cast<size_t>(t0[oy]) * m + t0[ox]]) v = true;
      if (!v && w01 > 0.0 && sq[static_cast<size_t>(t0[oy]) * m + t1[ox]]) v = true;
      if (!v && w10 > 0.0 && sq[static_cast<size_t>(t1[oy]) * m + t0[ox]]) v = true;
      if (!v && w11 > 0.0 && sq[static_cast<size_t>(t1[oy]) * m + t1[ox]]) v = true;
      dst[static_cast<size_t>(oy) * out + ox] = v ? 1 : 0;
    }
  }
}

}  // namespace

extern "C" {

// Single image: pad-to-square + PIL-exact resize. dst is out*out*channels.
int retr_pad_resize_image(const uint8_t* img, int h, int w, int channels,
                          int out, uint8_t* dst) {
  if (h <= 0 || w <= 0 || out <= 0 || channels <= 0) return -1;
  if (channels == 3) {
    pad_resize_rgb(img, h, w, out, dst);
    return 0;
  }
  std::vector<uint8_t> sq;
  int m = 0;
  pad_square_image(img, h, w, channels, &sq, &m);
  pil_resize_square(sq.data(), m, channels, out, dst);
  return 0;
}

int retr_pad_resize_mask(const uint8_t* mask, int h, int w, int out, uint8_t* dst) {
  if (h <= 0 || w <= 0 || out <= 0) return -1;
  pad_resize_mask(mask, h, w, out, dst);
  return 0;
}

// Batched, multithreaded: images given as a packed array of per-sample (h, w)
// variable-size buffers via offsets.
int retr_pad_resize_batch(const uint8_t* data, const int64_t* offsets,
                          const int32_t* heights, const int32_t* widths, int n,
                          int channels, int out, uint8_t* dst, int n_threads) {
  if (n <= 0) return -1;
  n_threads = std::max(1, std::min(n_threads, n));
  std::vector<std::thread> threads;
  auto work = [&](int t) {
    for (int i = t; i < n; i += n_threads) {
      retr_pad_resize_image(data + offsets[i], heights[i], widths[i], channels,
                            out, dst + static_cast<size_t>(i) * out * out * channels);
    }
  };
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(work, t);
  for (auto& th : threads) th.join();
  return 0;
}

}  // extern "C"
