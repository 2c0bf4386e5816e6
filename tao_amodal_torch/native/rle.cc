// Run-length mask codec: the host library of the port's segm evaluation.
//
// The port's own copy of the RLE functions of the JAX package's
// tao_amodal_tpu/native/rle.cc (which rebuilt the capability of
// pycocotools' maskApi.c around a two-pointer run sweep): encode,
// decode, area, the union or intersection of two RLEs, IoU of a pair and
// of two lists without decoding, the tight box, and polygon
// rasterization in pycocotools' convention.  The box helpers of that
// file are not carried (no ported caller needs them).  Added here: the
// counts' LEB128-style string form (pycocotools' rleToString and
// rleFrString), which the JAX package computes in Python, so that the
// evaluators do not spend their time in it.
//
// Representation: column-major (Fortran) runs of alternating 0/1
// pixels, first run counts zeros.  counts are uint32.  All functions
// are extern "C" for ctypes (tao_amodal_torch/native/lib.py builds this
// file with g++ and binds it).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// Iterator over an RLE as (end_position, value) boundaries.
struct RunCursor {
  const uint32_t* counts;
  int m;
  int idx = 0;
  uint64_t end = 0;  // exclusive end of current run
  int value = 0;     // value of current run (runs alternate, start at 0)

  explicit RunCursor(const uint32_t* c, int n) : counts(c), m(n) {
    if (m > 0) end = counts[0];
    value = 0;
  }
  bool done() const { return idx >= m; }
  void advance() {
    ++idx;
    value ^= 1;
    if (idx < m) end += counts[idx];
  }
};

// Sweep two RLEs in lockstep, calling fn(len, va, vb) per joint run.
template <typename F>
void sweep(const uint32_t* a, int ma, const uint32_t* b, int mb, F&& fn) {
  RunCursor ca(a, ma), cb(b, mb);
  uint64_t pos = 0;
  while (!ca.done() && !cb.done()) {
    uint64_t next = std::min(ca.end, cb.end);
    if (next > pos) fn(next - pos, ca.value, cb.value);
    pos = next;
    if (ca.end == next) ca.advance();
    if (cb.end == next) cb.advance();
  }
}

// Append a run of `len` pixels of `val` to an under-construction counts
// vector (merging adjacent equal-valued runs).
struct RunBuilder {
  std::vector<uint32_t> counts;
  int cur_val = 0;

  void push(uint64_t len, int val) {
    if (len == 0) return;
    if (counts.empty()) {
      if (val == 1) counts.push_back(0);  // leading zero-run
      counts.push_back(static_cast<uint32_t>(len));
      cur_val = val;
      return;
    }
    if (val == cur_val) {
      counts.back() += static_cast<uint32_t>(len);
    } else {
      counts.push_back(static_cast<uint32_t>(len));
      cur_val = val;
    }
  }
};

}  // namespace

extern "C" {

// mask[h*w] column-major -> counts_out; returns number of runs, or -1
// if it would exceed max_counts.
int rle_encode(const uint8_t* mask, int64_t n, uint32_t* counts_out,
               int max_counts) {
  int m = 0;
  int64_t i = 0;
  int cur = 0;
  while (i < n) {
    int64_t j = i;
    while (j < n && mask[j] == cur) ++j;
    if (m >= max_counts) return -1;
    counts_out[m++] = static_cast<uint32_t>(j - i);
    i = j;
    cur ^= 1;
  }
  if (n == 0 && max_counts > 0) return 0;
  return m;
}

void rle_decode(const uint32_t* counts, int m, uint8_t* mask_out,
                int64_t n) {
  std::memset(mask_out, 0, n);
  uint64_t pos = 0;
  for (int i = 0; i < m && pos < static_cast<uint64_t>(n); ++i) {
    if (i & 1) {
      uint64_t end = std::min<uint64_t>(pos + counts[i], n);
      std::memset(mask_out + pos, 1, end - pos);
    }
    pos += counts[i];
  }
}

double rle_area(const uint32_t* counts, int m) {
  double a = 0;
  for (int i = 1; i < m; i += 2) a += counts[i];
  return a;
}

// Union (intersect=0) or intersection (intersect=1); returns run count
// or -1 on overflow of out capacity.
int rle_merge_pair(const uint32_t* a, int ma, const uint32_t* b, int mb,
                   int intersect, uint32_t* out, int max_counts) {
  RunBuilder rb;
  sweep(a, ma, b, mb, [&](uint64_t len, int va, int vb) {
    int v = intersect ? (va & vb) : (va | vb);
    rb.push(len, v);
  });
  if (static_cast<int>(rb.counts.size()) > max_counts) return -1;
  std::copy(rb.counts.begin(), rb.counts.end(), out);
  return static_cast<int>(rb.counts.size());
}

// IoU of two RLEs without decoding; iscrowd uses dt area denominator.
double rle_iou_pair(const uint32_t* dt, int mdt, const uint32_t* gt,
                    int mgt, int iscrowd) {
  double inter = 0;
  sweep(dt, mdt, gt, mgt, [&](uint64_t len, int va, int vb) {
    if (va && vb) inter += static_cast<double>(len);
  });
  double da = rle_area(dt, mdt), ga = rle_area(gt, mgt);
  double denom = iscrowd ? da : (da + ga - inter);
  return denom > 0 ? inter / denom : 0.0;
}

// Pairwise IoU matrix over packed ragged RLE arrays.
// counts: concatenated runs; offsets[i]..offsets[i+1] delimit RLE i.
void rle_iou_matrix(const uint32_t* dt_counts, const int64_t* dt_off,
                    int n_dt, const uint32_t* gt_counts,
                    const int64_t* gt_off, int n_gt,
                    const uint8_t* iscrowd, double* out) {
  for (int i = 0; i < n_dt; ++i) {
    const uint32_t* d = dt_counts + dt_off[i];
    int md = static_cast<int>(dt_off[i + 1] - dt_off[i]);
    for (int j = 0; j < n_gt; ++j) {
      const uint32_t* g = gt_counts + gt_off[j];
      int mg = static_cast<int>(gt_off[j + 1] - gt_off[j]);
      out[i * n_gt + j] =
          rle_iou_pair(d, md, g, mg, iscrowd ? iscrowd[j] : 0);
    }
  }
}

// Tight xywh bbox of an RLE with image height h.
void rle_to_bbox(const uint32_t* counts, int m, int h, double* bbox) {
  int64_t xmin = INT64_MAX, xmax = -1, ymin = INT64_MAX, ymax = -1;
  uint64_t pos = 0;
  for (int i = 0; i < m; ++i) {
    if (i & 1 && counts[i] > 0) {
      uint64_t s = pos, e = pos + counts[i] - 1;
      int64_t cs = s / h, ce = e / h;
      int64_t rs = s % h, re = e % h;
      xmin = std::min(xmin, cs);
      xmax = std::max(xmax, ce);
      if (cs == ce) {
        ymin = std::min(ymin, rs);
        ymax = std::max(ymax, re);
      } else {  // spans a column boundary -> full rows covered
        ymin = 0;
        ymax = h - 1;
      }
    }
    pos += counts[i];
  }
  if (xmax < 0) {
    bbox[0] = bbox[1] = bbox[2] = bbox[3] = 0;
    return;
  }
  bbox[0] = static_cast<double>(xmin);
  bbox[1] = static_cast<double>(ymin);
  bbox[2] = static_cast<double>(xmax - xmin + 1);
  bbox[3] = static_cast<double>(ymax - ymin + 1);
}

// Polygon -> RLE, pycocotools boundary convention (5x upsampled walk,
// column-crossing parity).  Returns run count or -1 on overflow.
int rle_from_poly(const double* xy, int k, int h, int w, uint32_t* out,
                  int max_counts) {
  const double scale = 5.0;
  std::vector<int64_t> x(k + 1), y(k + 1);
  for (int j = 0; j < k; ++j) {
    // C-cast truncation toward zero (pycocotools rleFrPoly uses '(int)'
    // conversion, not floor) so negative out-of-frame amodal coordinates
    // rasterize identically to the reference.
    x[j] = static_cast<int64_t>(std::trunc(scale * xy[2 * j] + 0.5));
    y[j] = static_cast<int64_t>(std::trunc(scale * xy[2 * j + 1] + 0.5));
  }
  x[k] = x[0];
  y[k] = y[0];

  // Dense boundary walk.
  std::vector<int64_t> u, v;
  for (int j = 0; j < k; ++j) {
    int64_t xs = x[j], xe = x[j + 1], ys = y[j], ye = y[j + 1];
    int64_t dx = std::abs(xe - xs), dy = std::abs(ys - ye);
    bool flip = (dx >= dy && xs > xe) || (dx < dy && ys > ye);
    if (flip) {
      std::swap(xs, xe);
      std::swap(ys, ye);
    }
    if (dx >= dy) {
      double s = dx > 0 ? static_cast<double>(ye - ys) / dx : 0.0;
      for (int64_t d = 0; d <= dx; ++d) {
        int64_t t = flip ? dx - d : d;
        u.push_back(t + xs);
        v.push_back(
            static_cast<int64_t>(std::trunc(ys + s * t + 0.5)));
      }
    } else {
      double s = dy > 0 ? static_cast<double>(xe - xs) / dy : 0.0;
      for (int64_t d = 0; d <= dy; ++d) {
        int64_t t = flip ? dy - d : d;
        v.push_back(t + ys);
        u.push_back(
            static_cast<int64_t>(std::trunc(xs + s * t + 0.5)));
      }
    }
  }

  // Column crossings, downsampled to pixel grid.
  std::vector<uint64_t> crossings;
  for (size_t j = 1; j < u.size(); ++j) {
    if (u[j] == u[j - 1]) continue;
    double xd = static_cast<double>(std::min(u[j], u[j - 1]) == u[j]
                                        ? u[j]
                                        : u[j] - 1);
    xd = (xd + 0.5) / scale - 0.5;
    if (std::floor(xd) != xd || xd < 0 || xd > w - 1) continue;
    double yd = static_cast<double>(std::min(v[j], v[j - 1]));
    yd = (yd + 0.5) / scale - 0.5;
    yd = std::min(std::max(yd, 0.0), static_cast<double>(h));
    yd = std::ceil(yd);
    crossings.push_back(static_cast<uint64_t>(xd) * h +
                        static_cast<uint64_t>(yd));
  }
  std::sort(crossings.begin(), crossings.end());
  crossings.push_back(static_cast<uint64_t>(h) * w);

  // Delta-encode; fold zero-length runs into the previous run.
  std::vector<uint32_t> counts;
  uint64_t prev = 0;
  for (size_t j = 0; j < crossings.size(); ++j) {
    uint64_t d = crossings[j] - prev;
    prev = crossings[j];
    if (j == 0) {
      counts.push_back(static_cast<uint32_t>(d));
    } else if (d > 0) {
      counts.push_back(static_cast<uint32_t>(d));
    } else {
      ++j;
      if (j < crossings.size()) {
        uint64_t d2 = crossings[j] - prev;
        prev = crossings[j];
        counts.back() += static_cast<uint32_t>(d2);
      }
    }
  }
  if (static_cast<int>(counts.size()) > max_counts) return -1;
  std::copy(counts.begin(), counts.end(), out);
  return static_cast<int>(counts.size());
}

// counts -> pycocotools' string (5 bits a character, bit 5 the
// continuation, offset 48; counts after the first two delta-coded
// against the one two back).  Returns its length, or -1 past max_len.
int rle_compress(const uint32_t* counts, int m, char* out, int max_len) {
  int n = 0;
  for (int i = 0; i < m; ++i) {
    int64_t x = counts[i];
    if (i > 2) x -= static_cast<int64_t>(counts[i - 2]);
    bool more = true;
    while (more) {
      int c = static_cast<int>(x & 0x1f);
      x >>= 5;  // arithmetic: x stays negative
      more = !((x == 0 && !(c & 0x10)) || (x == -1 && (c & 0x10)));
      if (more) c |= 0x20;
      if (n >= max_len) return -1;
      out[n++] = static_cast<char>(c + 48);
    }
  }
  return n;
}

// pycocotools' string -> counts (int64: a malformed string may decode
// to negative runs, as the Python decoder gives them).  Returns the
// number of counts, or -1 past max_counts.
int rle_decompress(const char* s, int64_t len, int64_t* out,
                   int max_counts) {
  int m = 0;
  int64_t p = 0;
  while (p < len) {
    int64_t x = 0;
    int k = 0;
    bool more = true;
    while (more && p < len) {
      const int c = static_cast<unsigned char>(s[p]) - 48;
      x |= static_cast<int64_t>(c & 0x1f) << (5 * k);
      more = (c & 0x20) != 0;
      ++p;
      if (!more && (c & 0x10)) x |= -1LL << (5 * (k + 1));
      ++k;
    }
    if (m > 2) x += out[m - 2];
    if (m >= max_counts) return -1;
    out[m++] = x;
  }
  return m;
}

// Pairwise IoU of xywh boxes, out [n_dt, n_gt] row-major: pycocotools'
// bbIou, with the detection's area alone as the denominator where
// iscrowd[j] (iscrowd may be null: no crowd).  The same formulas as
// ops/boxes.py::box_iou_matrix on numpy float64.
void bbox_iou_matrix(const double* dt, int n_dt, const double* gt,
                     int n_gt, const uint8_t* iscrowd, double* out) {
  for (int i = 0; i < n_dt; ++i) {
    const double dx = dt[4 * i], dy = dt[4 * i + 1], dw = dt[4 * i + 2],
                 dh = dt[4 * i + 3];
    const double da = dw * dh;
    for (int j = 0; j < n_gt; ++j) {
      const double gx = gt[4 * j], gy = gt[4 * j + 1], gw = gt[4 * j + 2],
                   gh = gt[4 * j + 3];
      const double iw = std::min(dx + dw, gx + gw) - std::max(dx, gx);
      const double ih = std::min(dy + dh, gy + gh) - std::max(dy, gy);
      const double inter = (iw > 0 && ih > 0) ? iw * ih : 0.0;
      const double denom =
          (iscrowd && iscrowd[j]) ? da : da + gw * gh - inter;
      out[i * n_gt + j] = denom > 0 ? inter / denom : 0.0;
    }
  }
}

// Greedy NMS over xywh boxes already sorted by descending score:
// keep[j] = 0 where a kept box before it has IoU > thr with it.
void bbox_nms(const double* boxes, int n, double thr, uint8_t* keep) {
  for (int i = 0; i < n; ++i) keep[i] = 1;
  for (int i = 0; i < n; ++i) {
    if (!keep[i]) continue;
    for (int j = i + 1; j < n; ++j) {
      if (!keep[j]) continue;
      double iou;
      bbox_iou_matrix(boxes + 4 * i, 1, boxes + 4 * j, 1, nullptr, &iou);
      if (iou > thr) keep[j] = 0;
    }
  }
}

}  // extern "C"
