// Native host NMS — the small-N per-call fast path: the port's copy of the
// JAX package's `native/nms.cpp`, code line for line.
//
// At ~10 boxes a frame the fixed device-dispatch cost of the NMS kernel
// (ops/nms.py) dwarfs the math; the reference's scalar CPU loop
// (src/utils/nms.rs:32-72) is the model for this one, which `utils/nms.py`
// takes for frames of at most 64 boxes on the CPU: greedy rank-descending
// suppression with the asymmetric overlap criterion
// intersection(i, j) / area(j) > threshold, rotated intersections via
// Sutherland-Hodgman clipping (bbox.rs:476-509 semantics: `too_far` circle
// prune, general clip path — no axis-aligned shortcut for rotated pairs),
// axis-aligned closed form when neither box has an angle.
//
// C ABI:
//   nms_host(boxes[n*5] vec5 rank-sorted desc, n, threshold, oriented,
//            keep[n] u8 out) -> 0
//   nms_host_batch(boxes[b*n*5], b, n, threshold, oriented, keep[b*n]) -> 0

#include <algorithm>
#include <cmath>
#include <cstdint>

namespace {

struct Quad {
  double x[8], y[8];
  int n;
};

inline void box_vertices(const float* b, Quad& q) {
  // vec5 = (xc, yc, angle, aspect, height); vertex order per bbox.rs:287-330
  const double a = b[2];
  const double c = std::cos(a), s = std::sin(a);
  const double hw = static_cast<double>(b[3]) * b[4] * 0.5;
  const double hh = static_cast<double>(b[4]) * 0.5;
  const double r1x = -hw * c - hh * s, r1y = -hw * s + hh * c;
  const double r2x = hw * c - hh * s, r2y = hw * s + hh * c;
  const double x = b[0], y = b[1];
  q.x[0] = x + r1x; q.y[0] = y + r1y;
  q.x[1] = x + r2x; q.y[1] = y + r2y;
  q.x[2] = x - r1x; q.y[2] = y - r1y;
  q.x[3] = x - r2x; q.y[3] = y - r2y;
  q.n = 4;
}

// Sutherland-Hodgman: clip polygon p by the half-plane left of c1->c2
// (inside = cross <= 0, clipping.rs:12-15).
inline void clip_edge(const Quad& p, double c1x, double c1y, double c2x,
                      double c2y, Quad& out) {
  out.n = 0;
  const double ex = c2x - c1x, ey = c2y - c1y;
  for (int i = 0; i < p.n; ++i) {
    const int j = (i + p.n - 1) % p.n;
    const double sx = p.x[j], sy = p.y[j];
    const double vx = p.x[i], vy = p.y[i];
    const double side_s = ex * (sy - c1y) - ey * (sx - c1x);
    const double side_v = ex * (vy - c1y) - ey * (vx - c1x);
    const bool in_s = side_s <= 0.0, in_v = side_v <= 0.0;
    if (in_v != in_s) {
      // line(s,v) x line(c1,c2), clipping.rs:17-38
      const double dcx = sx - vx, dcy = sy - vy;
      const double dpx = c1x - c2x, dpy = c1y - c2y;
      const double n1 = sx * vy - sy * vx;
      const double n2 = c1x * c2y - c1y * c2x;
      const double den = dcx * dpy - dcy * dpx;
      if (den != 0.0) {
        out.x[out.n] = (n1 * dpx - n2 * dcx) / den;
        out.y[out.n] = (n1 * dpy - n2 * dcy) / den;
        ++out.n;
      }
    }
    if (in_v) {
      out.x[out.n] = vx;
      out.y[out.n] = vy;
      ++out.n;
    }
  }
}

inline double poly_area(const Quad& p) {
  if (p.n < 3) return 0.0;
  double s = 0.0;
  for (int i = 0; i < p.n; ++i) {
    const int j = (i + 1) % p.n;
    s += p.x[i] * p.y[j] - p.x[j] * p.y[i];
  }
  return std::abs(s) * 0.5;
}

inline double rotated_intersection(const float* a, const float* b) {
  // too_far prune (bbox.rs:452-462)
  const double hwa = static_cast<double>(a[3]) * a[4] * 0.5;
  const double hha = static_cast<double>(a[4]) * 0.5;
  const double hwb = static_cast<double>(b[3]) * b[4] * 0.5;
  const double hhb = static_cast<double>(b[4]) * 0.5;
  const double ra = std::sqrt(hwa * hwa + hha * hha);
  const double rb = std::sqrt(hwb * hwb + hhb * hhb);
  const double dx = static_cast<double>(a[0]) - b[0];
  const double dy = static_cast<double>(a[1]) - b[1];
  if (dx * dx + dy * dy > (ra + rb) * (ra + rb)) return 0.0;
  // recentre the pair for f32-origin stability (ops/geometry.py parity)
  float ac[5], bc[5];
  const float mx = 0.5f * (a[0] + b[0]), my = 0.5f * (a[1] + b[1]);
  for (int k = 0; k < 5; ++k) { ac[k] = a[k]; bc[k] = b[k]; }
  ac[0] -= mx; ac[1] -= my; bc[0] -= mx; bc[1] -= my;
  Quad qa, qb, t1, t2;
  box_vertices(ac, qa);
  box_vertices(bc, qb);
  clip_edge(qa, qb.x[3], qb.y[3], qb.x[0], qb.y[0], t1);
  clip_edge(t1, qb.x[0], qb.y[0], qb.x[1], qb.y[1], t2);
  clip_edge(t2, qb.x[1], qb.y[1], qb.x[2], qb.y[2], t1);
  clip_edge(t1, qb.x[2], qb.y[2], qb.x[3], qb.y[3], t2);
  return poly_area(t2);
}

inline double aligned_intersection(const float* a, const float* b) {
  const double aw = static_cast<double>(a[3]) * a[4];
  const double bw = static_cast<double>(b[3]) * b[4];
  const double iw = std::min(a[0] + aw * 0.5, b[0] + bw * 0.5) -
                    std::max(a[0] - aw * 0.5, b[0] - bw * 0.5);
  const double ih =
      std::min(static_cast<double>(a[1]) + a[4] * 0.5,
               static_cast<double>(b[1]) + b[4] * 0.5) -
      std::max(static_cast<double>(a[1]) - a[4] * 0.5,
               static_cast<double>(b[1]) - b[4] * 0.5);
  return (iw > 0.0 && ih > 0.0) ? iw * ih : 0.0;
}

}  // namespace

extern "C" {

int nms_host(const float* boxes, int n, float threshold, int oriented,
             uint8_t* keep) {
  for (int i = 0; i < n; ++i) keep[i] = 1;
  for (int i = 0; i < n; ++i) {
    if (!keep[i]) continue;
    const float* a = boxes + static_cast<size_t>(i) * 5;
    for (int j = i + 1; j < n; ++j) {
      if (!keep[j]) continue;
      const float* b = boxes + static_cast<size_t>(j) * 5;
      const double inter = oriented ? rotated_intersection(a, b)
                                    : aligned_intersection(a, b);
      if (inter <= 0.0) continue;
      const double area_j = static_cast<double>(b[3]) * b[4] * b[4];
      if (inter / area_j > threshold) keep[j] = 0;
    }
  }
  return 0;
}

int nms_host_batch(const float* boxes, int b, int n, float threshold,
                   int oriented, uint8_t* keep) {
  for (int i = 0; i < b; ++i) {
    nms_host(boxes + static_cast<size_t>(i) * n * 5, n, threshold, oriented,
             keep + static_cast<size_t>(i) * n);
  }
  return 0;
}

}  // extern "C"
