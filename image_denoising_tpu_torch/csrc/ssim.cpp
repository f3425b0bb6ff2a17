// Native MATLAB-equivalent SSIM for the port's host metrics path (the port's own
// copy of the SSIM in the repository's `native` directory, built by
// ops/_build.py::build_host).
//
// The eval CLIs score every frame with SSIM (utils_eval.py:19-47 semantics):
// five 11×11 Gaussian correlations in float64 with REFLECT_101 borders and a
// [5:-5] valid crop. In Python (scipy.ndimage.correlate) this dominates the
// host side of large eval runs; here the window is applied as two separable
// 1-D passes in C++ (identical result — the window is an outer product).
//
// C ABI: ssim_gray(img1, img2, h, w) -> SSIM scalar; images are row-major
// float64 in the [0,255] domain.

#include <array>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

constexpr int kK = 11;
constexpr int kR = kK / 2;  // 5
constexpr double kC1 = (0.01 * 255) * (0.01 * 255);
constexpr double kC2 = (0.03 * 255) * (0.03 * 255);

// cv2.getGaussianKernel(11, 1.5), normalized. Magic-static init: callers
// may invoke ssim_gray from several Python threads at once (the CLI
// --host_workers pool), and C++11 guarantees thread-safe one-time init.
const double* gauss_kernel() {
  static const std::array<double, kK> k = [] {
    std::array<double, kK> v{};
    double sum = 0.0;
    for (int i = 0; i < kK; ++i) {
      const double x = i - (kK - 1) / 2.0;
      v[i] = std::exp(-(x * x) / (2.0 * 1.5 * 1.5));
      sum += v[i];
    }
    for (int i = 0; i < kK; ++i) v[i] /= sum;
    return v;
  }();
  return k.data();
}

// REFLECT_101 index (edge not repeated): -1 -> 1, n -> n-2.
inline int mirror(int i, int n) {
  while (i < 0 || i >= n) {
    if (i < 0) i = -i;
    if (i >= n) i = 2 * n - 2 - i;
  }
  return i;
}

// Separable correlation with mirror borders: out has the same h×w extent.
void filt(const std::vector<double>& in, std::vector<double>& tmp,
          std::vector<double>& out, int h, int w) {
  const double* k = gauss_kernel();
  // row pass (along w)
  for (int y = 0; y < h; ++y) {
    const double* row = in.data() + static_cast<size_t>(y) * w;
    double* trow = tmp.data() + static_cast<size_t>(y) * w;
    for (int x = 0; x < w; ++x) {
      double acc = 0.0;
      for (int t = -kR; t <= kR; ++t) acc += k[t + kR] * row[mirror(x + t, w)];
      trow[x] = acc;
    }
  }
  // column pass (along h)
  for (int y = 0; y < h; ++y) {
    double* orow = out.data() + static_cast<size_t>(y) * w;
    for (int x = 0; x < w; ++x) {
      double acc = 0.0;
      for (int t = -kR; t <= kR; ++t)
        acc += k[t + kR] * tmp[static_cast<size_t>(mirror(y + t, h)) * w + x];
      orow[x] = acc;
    }
  }
}

}  // namespace

extern "C" {

double ssim_gray(const double* img1, const double* img2, int h, int w) {
  const size_t n = static_cast<size_t>(h) * w;
  std::vector<double> a(img1, img1 + n), b(img2, img2 + n);
  std::vector<double> aa(n), bb(n), ab(n);
  for (size_t i = 0; i < n; ++i) {
    aa[i] = a[i] * a[i];
    bb[i] = b[i] * b[i];
    ab[i] = a[i] * b[i];
  }
  std::vector<double> tmp(n), mu1(n), mu2(n), s11(n), s22(n), s12(n);
  filt(a, tmp, mu1, h, w);
  filt(b, tmp, mu2, h, w);
  filt(aa, tmp, s11, h, w);
  filt(bb, tmp, s22, h, w);
  filt(ab, tmp, s12, h, w);

  double sum = 0.0;
  int64_t count = 0;
  for (int y = kR; y < h - kR; ++y) {
    for (int x = kR; x < w - kR; ++x) {
      const size_t i = static_cast<size_t>(y) * w + x;
      const double m1 = mu1[i], m2 = mu2[i];
      const double m1sq = m1 * m1, m2sq = m2 * m2, m12 = m1 * m2;
      const double v1 = s11[i] - m1sq;
      const double v2 = s22[i] - m2sq;
      const double cov = s12[i] - m12;
      sum += ((2 * m12 + kC1) * (2 * cov + kC2)) /
             ((m1sq + m2sq + kC1) * (v1 + v2 + kC2));
      ++count;
    }
  }
  return count ? sum / count : 0.0;
}

}  // extern "C"
