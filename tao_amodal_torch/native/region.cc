// The port's copy of the JAX package's native/region.cc, built into the
// port's host library by tao_amodal_torch/native/lib.py.
//
// Polygon region overlap for VOT-style SOT evaluation.
//
// Capability-parity with the reference's vendored VOT region kernel
// (visualization/tao/third_party/pysot/toolkit/utils/src/region.c):
// rasterization-based overlap between two polygons (or axis-aligned
// rectangles given as 4-point polygons), with optional frame bounds.
// Fresh implementation: even-odd scanline rasterizer over the joint
// integer bounding box.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

struct Bounds {
  double left, top, right, bottom;
};

Bounds poly_bounds(const double* xy, int k) {
  Bounds b{1e30, 1e30, -1e30, -1e30};
  for (int i = 0; i < k; ++i) {
    b.left = std::min(b.left, xy[2 * i]);
    b.right = std::max(b.right, xy[2 * i]);
    b.top = std::min(b.top, xy[2 * i + 1]);
    b.bottom = std::max(b.bottom, xy[2 * i + 1]);
  }
  return b;
}

// Even-odd rasterization of a polygon onto a grid with origin
// (ox, oy), size (w, h), pixel centers at integer+0.5 offsets.
void rasterize(const double* xy, int k, double ox, double oy, int w,
               int h, std::vector<uint8_t>& out) {
  out.assign(static_cast<size_t>(w) * h, 0);
  std::vector<double> nodes;
  for (int row = 0; row < h; ++row) {
    double py = oy + row;  // sample at pixel top-left like VOT
    nodes.clear();
    for (int i = 0; i < k; ++i) {
      double x1 = xy[2 * i], y1 = xy[2 * i + 1];
      double x2 = xy[2 * ((i + 1) % k)], y2 = xy[2 * ((i + 1) % k) + 1];
      if ((y1 <= py && y2 > py) || (y2 <= py && y1 > py)) {
        nodes.push_back(x1 + (py - y1) / (y2 - y1) * (x2 - x1));
      }
    }
    std::sort(nodes.begin(), nodes.end());
    for (size_t i = 0; i + 1 < nodes.size(); i += 2) {
      int cs = static_cast<int>(std::ceil(nodes[i] - ox));
      int ce = static_cast<int>(std::floor(nodes[i + 1] - ox));
      cs = std::max(cs, 0);
      ce = std::min(ce, w - 1);
      for (int c = cs; c <= ce; ++c) out[row * w + c] = 1;
    }
  }
}

}  // namespace

extern "C" {

// Overlap (intersection-over-union) of two polygons with k1/k2 points.
// bounds_w/bounds_h > 0 clip both polygons to [0,w) x [0,h).
double region_polygon_overlap(const double* p1, int k1, const double* p2,
                              int k2, int bounds_w, int bounds_h) {
  Bounds b1 = poly_bounds(p1, k1), b2 = poly_bounds(p2, k2);
  double left = std::floor(std::min(b1.left, b2.left));
  double top = std::floor(std::min(b1.top, b2.top));
  double right = std::ceil(std::max(b1.right, b2.right));
  double bottom = std::ceil(std::max(b1.bottom, b2.bottom));
  if (bounds_w > 0) {
    left = std::max(left, 0.0);
    right = std::min(right, static_cast<double>(bounds_w));
  }
  if (bounds_h > 0) {
    top = std::max(top, 0.0);
    bottom = std::min(bottom, static_cast<double>(bounds_h));
  }
  int w = static_cast<int>(right - left) + 1;
  int h = static_cast<int>(bottom - top) + 1;
  if (w <= 0 || h <= 0) return 0.0;

  std::vector<uint8_t> m1, m2;
  rasterize(p1, k1, left, top, w, h, m1);
  rasterize(p2, k2, left, top, w, h, m2);
  int64_t inter = 0, uni = 0;
  for (size_t i = 0; i < m1.size(); ++i) {
    inter += m1[i] & m2[i];
    uni += m1[i] | m2[i];
  }
  return uni > 0 ? static_cast<double>(inter) / uni : 0.0;
}

// Batch overlap of a predicted trajectory vs gt polygons, both packed
// as ragged arrays.  out[i] = overlap of pred i vs gt i.
void region_overlap_trajectory(const double* pred, const int64_t* pred_off,
                               const double* gt, const int64_t* gt_off,
                               int n, int bounds_w, int bounds_h,
                               double* out) {
  for (int i = 0; i < n; ++i) {
    int k1 = static_cast<int>((pred_off[i + 1] - pred_off[i]) / 2);
    int k2 = static_cast<int>((gt_off[i + 1] - gt_off[i]) / 2);
    out[i] = region_polygon_overlap(pred + pred_off[i], k1,
                                    gt + gt_off[i], k2, bounds_w,
                                    bounds_h);
  }
}

}  // extern "C"
