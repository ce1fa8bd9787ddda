// SLIC superpixel assignment and segment-mean replacement for the
// superpixels op of heavy_aug2 (reference
// dataset/data_generator_mscmrseg.py:185-214, iaa.Superpixels).
//
// A copy of slcl_tpu/native/slic.cpp, built with the same g++ flags, so both
// packages segment an image identically. The numpy k-means in
// slcl_torch/data/transforms.py is the plain version. This is the standard
// SLIC algorithm (Achanta et al., 2012): grid-seeded cluster centers in
// (y, x, intensity) space, each Lloyd iteration restricted to a 2S x 2S
// window around each center. Grayscale-only (the datasets are
// single-channel cardiac MR/CT slices).
//
// C ABI, bound with ctypes by slcl_torch/data/slic.py.
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// gray:   (h*w) float32, any range (intensity distances are scaled by the
//         dynamic range so behavior is range-invariant, matching the
//         Python fallback's s_in normalization)
// assign: (h*w) int32 out — superpixel id per pixel, in [0, n_centers)
// returns the number of centers actually seeded (g*g), or -1 on bad args.
int slcl_slic_assign(const float* gray, int h, int w, int grid, int iters,
                     float compactness, int32_t* assign) {
  if (h <= 0 || w <= 0 || grid < 1 || iters < 0) return -1;
  const int g = grid;
  const int k = g * g;
  const float step_y = static_cast<float>(h) / g;
  const float step_x = static_cast<float>(w) / g;
  const float S = std::sqrt(step_y * step_x);  // nominal superpixel size

  float vmin = gray[0], vmax = gray[0];
  const int64_t n = static_cast<int64_t>(h) * w;
  for (int64_t i = 1; i < n; ++i) {
    vmin = gray[i] < vmin ? gray[i] : vmin;
    vmax = gray[i] > vmax ? gray[i] : vmax;
  }
  const float range = (vmax - vmin) > 1e-6f ? (vmax - vmin) : 1e-6f;
  // relative weight of spatial vs intensity distance; compactness plays
  // skimage's role (higher -> squarer segments)
  const float inv_s2 = compactness / (S * S);
  const float inv_c2 = 1.0f / (0.3f * range * 0.3f * range);

  std::vector<float> cy(k), cx(k), cv(k);
  for (int i = 0; i < g; ++i)
    for (int j = 0; j < g; ++j) {
      const int c = i * g + j;
      cy[c] = (i + 0.5f) * step_y;
      cx[c] = (j + 0.5f) * step_x;
      int yy = static_cast<int>(cy[c]); if (yy >= h) yy = h - 1;
      int xx = static_cast<int>(cx[c]); if (xx >= w) xx = w - 1;
      cv[c] = gray[static_cast<int64_t>(yy) * w + xx];
    }

  std::vector<float> best(n);
  std::vector<float> sum_y(k), sum_x(k), sum_v(k);
  std::vector<int64_t> cnt(k);

  for (int it = 0; it < iters; ++it) {
    std::fill(best.begin(), best.end(), 1e30f);
    for (int64_t i = 0; i < n; ++i) assign[i] = -1;
    // scatter pass: each center claims pixels in its 2S x 2S window
    for (int c = 0; c < k; ++c) {
      const int y0 = std::max(0, static_cast<int>(cy[c] - 2 * step_y));
      const int y1 = std::min(h, static_cast<int>(cy[c] + 2 * step_y) + 1);
      const int x0 = std::max(0, static_cast<int>(cx[c] - 2 * step_x));
      const int x1 = std::min(w, static_cast<int>(cx[c] + 2 * step_x) + 1);
      for (int y = y0; y < y1; ++y) {
        const float dy = y - cy[c];
        const int64_t row = static_cast<int64_t>(y) * w;
        for (int x = x0; x < x1; ++x) {
          const float dx = x - cx[c];
          const float dv = gray[row + x] - cv[c];
          const float d = (dy * dy + dx * dx) * inv_s2 + dv * dv * inv_c2;
          if (d < best[row + x]) {
            best[row + x] = d;
            assign[row + x] = c;
          }
        }
      }
    }
    // orphans (possible when centers drift): nearest grid cell
    for (int64_t i = 0; i < n; ++i)
      if (assign[i] < 0) {
        const int y = static_cast<int>(i / w), x = static_cast<int>(i % w);
        int gy = static_cast<int>(y / step_y); if (gy >= g) gy = g - 1;
        int gx = static_cast<int>(x / step_x); if (gx >= g) gx = g - 1;
        assign[i] = gy * g + gx;
      }
    if (it == iters - 1) break;
    // update pass
    std::fill(sum_y.begin(), sum_y.end(), 0.f);
    std::fill(sum_x.begin(), sum_x.end(), 0.f);
    std::fill(sum_v.begin(), sum_v.end(), 0.f);
    std::fill(cnt.begin(), cnt.end(), 0);
    for (int64_t i = 0; i < n; ++i) {
      const int c = assign[i];
      sum_y[c] += static_cast<float>(i / w);
      sum_x[c] += static_cast<float>(i % w);
      sum_v[c] += gray[i];
      cnt[c] += 1;
    }
    for (int c = 0; c < k; ++c)
      if (cnt[c] > 0) {
        cy[c] = sum_y[c] / cnt[c];
        cx[c] = sum_x[c] / cnt[c];
        cv[c] = sum_v[c] / cnt[c];
      }
  }
  if (iters == 0) {  // pure grid assignment
    for (int64_t i = 0; i < n; ++i) {
      const int y = static_cast<int>(i / w), x = static_cast<int>(i % w);
      int gy = static_cast<int>(y / step_y); if (gy >= g) gy = g - 1;
      int gx = static_cast<int>(x / step_x); if (gx >= g) gx = g - 1;
      assign[i] = gy * g + gx;
    }
  }
  return k;
}

// Segment-mean replacement: out[i] = mean of img over segment assign[i]
// where replace[assign[i]] != 0, else img[i]. img may be multi-channel
// (ch-major last, contiguous (h*w, ch)).
void slcl_segment_replace(const float* img, const int32_t* assign,
                          const uint8_t* replace, int64_t n, int ch, int k,
                          float* out) {
  std::vector<double> sums(static_cast<size_t>(k) * ch, 0.0);
  std::vector<int64_t> cnt(k, 0);
  for (int64_t i = 0; i < n; ++i) {
    const int c = assign[i];
    cnt[c] += 1;
    for (int j = 0; j < ch; ++j) sums[static_cast<size_t>(c) * ch + j] += img[i * ch + j];
  }
  for (int64_t i = 0; i < n; ++i) {
    const int c = assign[i];
    if (replace[c] && cnt[c] > 0) {
      for (int j = 0; j < ch; ++j)
        out[i * ch + j] =
            static_cast<float>(sums[static_cast<size_t>(c) * ch + j] / cnt[c]);
    } else {
      for (int j = 0; j < ch; ++j) out[i * ch + j] = img[i * ch + j];
    }
  }
}

}  // extern "C"
