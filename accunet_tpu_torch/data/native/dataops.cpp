// Host-side data ops of the port's input pipeline, counterpart of
// accunet_tpu/data/native/dataops.cpp: the bilinear and nearest resizes,
// the per-image standardisation and the mask binarisation of
// accunet_tpu_torch/data/dataset.py, in C++ for the one-core loader.
// Bound with ctypes and built with g++ at first use by
// accunet_tpu_torch/data/native_loader.py.
//
// Each op computes what the dataset's numpy path computes, in the same
// order and type, so the results agree with it: the nearest resize picks
// the source pixel by cv2's INTER_NEAREST rule in double (not by the float
// scale JAX's copy uses), the bilinear resize takes half-pixel centres and
// blends in double as numpy does, and the standardisation takes the mean
// and the unbiased standard deviation in double. Built with
// -ffp-contract=off, so no multiply-add is fused into one rounding that
// numpy's two roundings would not match.

#include <algorithm>
#include <cmath>

extern "C" {

// Bilinear resize with half-pixel centres: src (h, w) float32 row-major ->
// dst (oh, ow) float64.
void accunet_resize_bilinear(const float* src, int h, int w, double* dst, int oh, int ow) {
  for (int y = 0; y < oh; ++y) {
    const double ys = (y + 0.5) * h / oh - 0.5;
    const int y0 = std::min(std::max(static_cast<int>(std::floor(ys)), 0), h - 1);
    const int y1 = std::min(y0 + 1, h - 1);
    const double fy = std::min(std::max(ys - y0, 0.0), 1.0);
    for (int x = 0; x < ow; ++x) {
      const double xs = (x + 0.5) * w / ow - 0.5;
      const int x0 = std::min(std::max(static_cast<int>(std::floor(xs)), 0), w - 1);
      const int x1 = std::min(x0 + 1, w - 1);
      const double fx = std::min(std::max(xs - x0, 0.0), 1.0);
      const double top = src[y0 * w + x0] * (1 - fx) + src[y0 * w + x1] * fx;
      const double bot = src[y1 * w + x0] * (1 - fx) + src[y1 * w + x1] * fx;
      dst[y * ow + x] = top * (1 - fy) + bot * fy;
    }
  }
}

// Nearest resize by cv2's INTER_NEAREST rule: source index
// min(floor(i * (1.0 / (out / in))), in - 1) in double.
void accunet_resize_nearest(const float* src, int h, int w, float* dst, int oh, int ow) {
  const double sy = 1.0 / (static_cast<double>(oh) / h);
  const double sx = 1.0 / (static_cast<double>(ow) / w);
  for (int y = 0; y < oh; ++y) {
    const int yi = std::min(static_cast<int>(std::floor(y * sy)), h - 1);
    for (int x = 0; x < ow; ++x) {
      const int xi = std::min(static_cast<int>(std::floor(x * sx)), w - 1);
      dst[y * ow + x] = src[yi * w + xi];
    }
  }
}

// In place over n elements: (x - mean) / (std + 1e-8), std unbiased (n - 1),
// as torch's .std() that the reference loader calls.
void accunet_standardize(double* x, long n) {
  double mean = 0.0;
  for (long i = 0; i < n; ++i) mean += x[i];
  mean /= n;
  double var = 0.0;
  for (long i = 0; i < n; ++i) {
    const double d = x[i] - mean;
    var += d * d;
  }
  const double denom = std::sqrt(var / (n > 1 ? n - 1 : 1)) + 1e-8;
  for (long i = 0; i < n; ++i) x[i] = (x[i] - mean) / denom;
}

// In place over n elements: 1 where x > 0, else 0.
void accunet_binarize(float* x, long n) {
  for (long i = 0; i < n; ++i) x[i] = x[i] > 0.0f ? 1.0f : 0.0f;
}

}  // extern "C"
