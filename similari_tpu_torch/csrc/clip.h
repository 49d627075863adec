// Scalar f32 rotated-box intersection — op-order parity with the device
// kernel (ops/geometry.py quad_intersection_area / rotated_intersection):
// the same Green's-theorem boundary integral with per-edge Liang–Barsky
// clipping, the same pair recentring, all in f32.  The host tracker steps
// (sortstep.cpp / visualstep.cpp) use this so host and device engines stay
// id-exact on oriented streams ON THE CPU TEST MESH, where both sides use
// the exact JV solver.  On the card the device engine resolves near-ties
// differently by construction (the auction solver, and above the
// block-sort gate the x-sorted clip kernel), which is within the
// reference's own tie nondeterminism, not an exactness target.  nms.cpp
// keeps its own f64 Sutherland–Hodgman path (its parity target is the
// reference's semantics, src/utils/bbox.rs:476-509, not the general step).
// The port's copy of the JAX package's `native/clip.h`, code line for line.

#pragma once

#include <cmath>

// FP contraction OFF for every clip function: the collinear tie-break tests
// `a == 0.0f` where a = dx*(sy-py) - dy*(sx-px).  Under -ffp-contract=fast
// (the -O3 default) GCC fuses that into an FMA whose unrounded product
// leaves a tiny residual exactly when the terms cancel — so IDENTICAL boxes
// (pred == det after track birth, e.g. a static object with quantized
// coords) failed the tie detection and scored IoU 0 (neither pass counts
// the shared edges) or ~1/eps (both passes count; union cancels to ~0),
// where the device kernel (ops/geometry.py) and the NumPy oracle
// (trackers/host_geometry.py) — both separately-rounded — give exactly 1.
// Locked by tests/test_torch_native.py (rotated_iou_pairs).
#pragma GCC push_options
#pragma GCC optimize("fp-contract=off")

namespace similari_clip {

struct QuadF {
  float x[4], y[4];
};

// Per-box rotation offsets (angle/size only — independent of position and
// of the per-pair recentring).  Hoisting these out of the pair loop kills
// the cos/sin per pair, bit-exactly: box_vertices computes
// q.x[0] = center_x + r1x with the SAME r1x whether the center was
// recentred first or not.
struct QuadRot {
  float r1x, r1y, r2x, r2y;
  // circumradius sqrt(hw^2 + hh^2): per-box constant, hoisted so the
  // too_far early-out in rotated_intersection_pre_f32 pays zero sqrts per
  // pair (bit-exact — the same f32 expression the per-pair form computed)
  float rad;
};

inline void box_rot_f32(const float* b, QuadRot& r) {
  const float c = std::cos(b[2]);
  const float s = std::sin(b[2]);
  const float hw = b[3] * b[4] * 0.5f;
  const float hh = b[4] * 0.5f;
  r.r1x = -hw * c - hh * s; r.r1y = -hw * s + hh * c;
  r.r2x = hw * c - hh * s;  r.r2y = hw * s + hh * c;
  r.rad = std::sqrt(hw * hw + hh * hh);
}

inline void quad_from_rot(float cx, float cy, const QuadRot& r, QuadF& q) {
  q.x[0] = cx + r.r1x; q.y[0] = cy + r.r1y;
  q.x[1] = cx + r.r2x; q.y[1] = cy + r.r2y;
  q.x[2] = cx - r.r1x; q.y[2] = cy - r.r1y;
  q.x[3] = cx - r.r2x; q.y[3] = cy - r.r2y;
}

// geometry.box_vertices order, vec5 = (xc, yc, angle, aspect, height)
inline void box_vertices_f32(const float* b, QuadF& q) {
  QuadRot r;
  box_rot_f32(b, r);
  quad_from_rot(b[0], b[1], r, q);
}

inline float cross2(float ax, float ay, float bx, float by) {
  return ax * by - ay * bx;
}

#if defined(__GNUC__) && defined(__SSE2__)
#define SIMILARI_CLIP_SIMD 1
typedef float v16sf __attribute__((vector_size(64)));
typedef int v16si __attribute__((vector_size(64)));
#endif

// geometry._boundary_integral: sum of cross(p0, p1) over A's edges clipped
// to convex quad B (Liang–Barsky per edge; collinear tie-break per pass).
//
// All 16 (edge, halfplane) pairs are evaluated in ONE 16-lane vector (GCC
// vector extensions — the same tool as visualstep.cpp dot_f32; a
// strict-FP scalar loop with the data-dependent max/min chain never
// auto-vectorizes; AVX-512 executes the 16-lane ops natively, narrower
// machines get compiler-synthesized splits).  Lane = edge*4 + halfplane;
// the per-edge t0/t1/para reductions are in-register shuffles over the
// 4-lane groups.  Bit-exact vs the scalar form: per-lane arithmetic is
// identical and the only cross-lane ops are max/min/OR, which are exact
// under any association.
inline float boundary_integral_f32(const QuadF& A, const QuadF& B,
                                   bool tie_pass) {
  float total = 0.0f;
#ifdef SIMILARI_CLIP_SIMD
  // B halfplanes tiled across the 4 edge groups
  const v16sf px = {B.x[0], B.x[1], B.x[2], B.x[3], B.x[0], B.x[1], B.x[2],
                    B.x[3], B.x[0], B.x[1], B.x[2], B.x[3], B.x[0], B.x[1],
                    B.x[2], B.x[3]};
  const v16sf py = {B.y[0], B.y[1], B.y[2], B.y[3], B.y[0], B.y[1], B.y[2],
                    B.y[3], B.y[0], B.y[1], B.y[2], B.y[3], B.y[0], B.y[1],
                    B.y[2], B.y[3]};
  const float dx0 = B.x[1] - B.x[0], dx1 = B.x[2] - B.x[1],
              dx2 = B.x[3] - B.x[2], dx3 = B.x[0] - B.x[3];
  const float dy0 = B.y[1] - B.y[0], dy1 = B.y[2] - B.y[1],
              dy2 = B.y[3] - B.y[2], dy3 = B.y[0] - B.y[3];
  const v16sf dx = {dx0, dx1, dx2, dx3, dx0, dx1, dx2, dx3,
                    dx0, dx1, dx2, dx3, dx0, dx1, dx2, dx3};
  const v16sf dy = {dy0, dy1, dy2, dy3, dy0, dy1, dy2, dy3,
                    dy0, dy1, dy2, dy3, dy0, dy1, dy2, dy3};
  // A edges broadcast within their group
  const v16sf sx = {A.x[0], A.x[0], A.x[0], A.x[0], A.x[1], A.x[1], A.x[1],
                    A.x[1], A.x[2], A.x[2], A.x[2], A.x[2], A.x[3], A.x[3],
                    A.x[3], A.x[3]};
  const v16sf sy = {A.y[0], A.y[0], A.y[0], A.y[0], A.y[1], A.y[1], A.y[1],
                    A.y[1], A.y[2], A.y[2], A.y[2], A.y[2], A.y[3], A.y[3],
                    A.y[3], A.y[3]};
  const float ex0 = A.x[1] - A.x[0], ex1 = A.x[2] - A.x[1],
              ex2 = A.x[3] - A.x[2], ex3 = A.x[0] - A.x[3];
  const float ey0 = A.y[1] - A.y[0], ey1 = A.y[2] - A.y[1],
              ey2 = A.y[3] - A.y[2], ey3 = A.y[0] - A.y[3];
  const v16sf dex = {ex0, ex0, ex0, ex0, ex1, ex1, ex1, ex1,
                     ex2, ex2, ex2, ex2, ex3, ex3, ex3, ex3};
  const v16sf dey = {ey0, ey0, ey0, ey0, ey1, ey1, ey1, ey1,
                     ey2, ey2, ey2, ey2, ey3, ey3, ey3, ey3};
  const v16sf zero = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f,
                      0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  const v16sf one = {1.0f, 1.0f, 1.0f, 1.0f, 1.0f, 1.0f, 1.0f, 1.0f,
                     1.0f, 1.0f, 1.0f, 1.0f, 1.0f, 1.0f, 1.0f, 1.0f};
  const v16sf a = dx * (sy - py) - dy * (sx - px);
  const v16sf b = dx * dey - dy * dex;
  const v16si bz = b == zero;
  const v16sf tt = -a / (bz ? one : b);
  v16sf t0v = (b < zero) ? tt : zero;
  v16sf t1v = (b > zero) ? tt : one;
  v16si para = bz & (a > zero);
  if (tie_pass) {
    const v16si same_dir = (dx * dex + dy * dey) >= zero;
    para |= bz & (a == zero) & same_dir;
  }
  // in-group reductions: swap-within-pairs then swap-pairs
  const v16si m1 = {1, 0, 3, 2, 5, 4, 7, 6, 9, 8, 11, 10, 13, 12, 15, 14};
  const v16si m2 = {2, 3, 0, 1, 6, 7, 4, 5, 10, 11, 8, 9, 14, 15, 12, 13};
  v16sf r = __builtin_shuffle(t0v, m1);
  t0v = (t0v > r) ? t0v : r;
  r = __builtin_shuffle(t0v, m2);
  t0v = (t0v > r) ? t0v : r;
  r = __builtin_shuffle(t1v, m1);
  t1v = (t1v < r) ? t1v : r;
  r = __builtin_shuffle(t1v, m2);
  t1v = (t1v < r) ? t1v : r;
  para |= __builtin_shuffle(para, m1);
  para |= __builtin_shuffle(para, m2);
  // branchless tail: the old 4-iteration scalar loop paid ~2 unpredictable
  // branches per group (clip outcomes are data-dependent near-50/50 on
  // overlapping pairs); compute every group's segment cross in-vector and
  // mask, then add the 4 group lanes in the same order the loop did.
  // Masked lanes can hold inf/NaN from the t = -a/b division — the select
  // (not a multiply) keeps them out of the sum.
  const v16sf p0x = sx + t0v * dex, p0y = sy + t0v * dey;
  const v16sf p1x = sx + t1v * dex, p1y = sy + t1v * dey;
  const v16sf crossv = p0x * p1y - p0y * p1x;
  const v16si keep = ~para & (t1v > t0v);
  const v16sf contrib = keep ? crossv : zero;
  total = ((contrib[0] + contrib[4]) + contrib[8]) + contrib[12];
#else
  for (int i = 0; i < 4; ++i) {
    const int i1 = (i + 1) & 3;
    const float sx = A.x[i], sy = A.y[i];
    const float dex = A.x[i1] - sx, dey = A.y[i1] - sy;
    float t0 = 0.0f, t1 = 1.0f;
    bool ok = true;
    for (int h = 0; h < 4; ++h) {
      const int h1 = (h + 1) & 3;
      const float px = B.x[h], py = B.y[h];
      const float dx = B.x[h1] - px, dy = B.y[h1] - py;
      const float a = cross2(dx, dy, sx - px, sy - py);
      const float b = cross2(dx, dy, dex, dey);
      const float tt = -a / (b == 0.0f ? 1.0f : b);
      if (b < 0.0f) t0 = std::max(t0, tt);
      if (b > 0.0f) t1 = std::min(t1, tt);
      bool para_out = (b == 0.0f) && (a > 0.0f);
      if (tie_pass) {
        const bool same_dir = dx * dex + dy * dey >= 0.0f;
        para_out = para_out || ((b == 0.0f) && (a == 0.0f) && same_dir);
      }
      ok = ok && !para_out;
    }
    if (ok && t1 > t0) {
      const float p0x = sx + t0 * dex, p0y = sy + t0 * dey;
      const float p1x = sx + t1 * dex, p1y = sy + t1 * dey;
      total += cross2(p0x, p0y, p1x, p1y);
    }
  }
#endif
  return total;
}

// geometry.rotated_intersection with the per-box rotation offsets already
// computed (the hot-loop form: no trig per pair).
inline float rotated_intersection_pre_f32(const float* a, const QuadRot& ar,
                                          const float* b, const QuadRot& br) {
  const float ddx = a[0] - b[0], ddy = a[1] - b[1];
  const float md = ar.rad + br.rad;
  if (ddx * ddx + ddy * ddy > md * md) return 0.0f;
  const float mx = 0.5f * (a[0] + b[0]), my = 0.5f * (a[1] + b[1]);
  QuadF qa, qb;
  quad_from_rot(a[0] - mx, a[1] - my, ar, qa);
  quad_from_rot(b[0] - mx, b[1] - my, br, qb);
  const float s = boundary_integral_f32(qa, qb, false) +
                  boundary_integral_f32(qb, qa, true);
  return std::abs(s) * 0.5f;
}

// geometry.rotated_intersection: too_far pairs are exactly 0; the pair is
// recentred around the midpoint of the two centers before clipping.
inline float rotated_intersection_f32(const float* a, const float* b) {
  QuadRot ar, br;
  box_rot_f32(a, ar);
  box_rot_f32(b, br);
  return rotated_intersection_pre_f32(a, ar, b, br);
}

// universal_iou semantics (`bbox.rs:512-535`): returns IoU, 0 when the
// intersection is empty (the caller treats 0 as "no edge").
inline float rotated_iou_pre_f32(const float* a, const QuadRot& ar,
                                 const float* b, const QuadRot& br) {
  const float inter = rotated_intersection_pre_f32(a, ar, b, br);
  if (!(inter > 0.0f)) return 0.0f;
  const float uni = a[3] * a[4] * a[4] + b[3] * b[4] * b[4] - inter;
  // uni > 0 guards degenerate zero-area boxes (geometry.universal_iou
  // parity: float roundoff can leave inter marginally above a ~0 union)
  if (!(uni > 0.0f)) return 0.0f;
  return inter / uni;
}

inline float rotated_iou_f32(const float* a, const float* b) {
  QuadRot ar, br;
  box_rot_f32(a, ar);
  box_rot_f32(b, br);
  return rotated_iou_pre_f32(a, ar, b, br);
}

}  // namespace similari_clip

#pragma GCC pop_options
