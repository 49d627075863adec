// Native host SORT step — the interactive per-call fast path: the port's
// copy of the JAX package's `native/sortstep.cpp`, code line for line.
//
// One C call executes a full SORT epoch on the host SoA state: compatible-
// track selection, spatial-hash candidate generation (the `too_far` circle
// prune, the reference's src/utils/bbox.rs:452-462), IoU or chi2-gated
// Mahalanobis weights (sort/metric.rs:38-77), the exact augmented-LP voting
// (sort/voting.rs:27-100) via dominance reduction + bipartite-component
// decomposition + the JV solver in lap.cpp, the decomposed-block Kalman
// update (kalman_2d_box.rs:86-148, same recurrences as ops/kalman.py), and
// the in-place state write-back.
//
// Semantics mirror trackers/host_sort.py (its NumPy twin,
// `host_sort_step_numpy`) and the general step (trackers/sort_step.py).
//
// C ABI: sort_step_host(...) -> 0 ok, 1 = capacity overflow.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

#include "clip.h"
#include "kf.h"

extern "C" int lap_solve_max(const float* weights, int R, int C,
                             int32_t* out_col);

namespace {

constexpr float kChi2Gate = 11.070f;        // CHI2INV95[4], kalman_2d_box.rs:174
constexpr float kChi2Upper = 100.0f;        // CHI2_UPPER_BOUND

using similari_kf::KfRow;
using similari_kf::kf_initiate;
using similari_kf::kf_predict;
using similari_kf::kf_update;

inline float box_radius(const float* b) {
  const float hw = b[3] * b[4] * 0.5f;
  const float hh = b[4] * 0.5f;
  return std::sqrt(hw * hw + hh * hh);
}

struct DSU {
  std::vector<int32_t> p;
  explicit DSU(int n) : p(n) { for (int i = 0; i < n; ++i) p[i] = i; }
  int find(int x) { while (p[x] != x) x = p[x] = p[p[x]]; return x; }
  void unite(int a, int b) { p[find(a)] = find(b); }
};

}  // namespace

extern "C" {

// Pairwise rotated IoU over n (a, b) box rows — a test/debug export so the
// clip's float behavior can be locked bitwise against the NumPy oracle
// (trackers/host_geometry.py) and across refactors of clip.h, which the
// id-level fuzz suites alone cannot pin down to the ulp.
int rotated_iou_pairs(const float* a, const float* b, int n, float* out) {
  for (int i = 0; i < n; ++i)
    out[i] = similari_clip::rotated_iou_f32(a + static_cast<size_t>(i) * 5,
                                            b + static_cast<size_t>(i) * 5);
  return 0;
}

// Bulk Kalman smoothing: initiate from z[0], then predict+update per row
// (the reference's `benches/kalman_bbox.rs:15-31` loop as ONE call — the
// per-call Python object API pays ~18 us/step in interpreter overhead;
// this runs the identical recurrence at ~50 ns/step).
int kf_box_sequence(const float* z, int n, float pw, float vw,
                    float* out_mean) {
  if (n <= 0) return 0;
  KfRow s;
  kf_initiate(z, pw, vw, s);
  std::memcpy(out_mean, s.mp, 5 * sizeof(float));
  for (int i = 1; i < n; ++i) {
    kf_predict(pw, vw, s);
    kf_update(z + static_cast<size_t>(i) * 5, pw, s);
    std::memcpy(out_mean + static_cast<size_t>(i) * 5, s.mp,
                5 * sizeof(float));
  }
  return 0;
}

// Bulk 2D-point Kalman smoothing over P independent keypoint chains:
// z[N, P, 2] C-contig -> out[N, P, 2].  P = 1 is Point2DKalmanFilter's
// `filter_sequence`; the Vec2D flavor passes its whole keypoint vector so
// all chains advance in one cache-friendly pass.  Same decomposed-block
// recurrence as kalman_2d_point.rs:25-137 / utils/kalman._NpFilter
// (kind="point"): stds are k*weight with no height scaling, measurement
// noise std = position_weight.
int kf_point_sequence(const float* z, int n, int p, float pw, float vw,
                      float* out_mean) {
  if (n <= 0 || p <= 0) return 0;
  const int m = 2 * p;  // independent scalar components per time step
  std::vector<float> mp(z, z + m), mv(m, 0.0f);
  const float sp0 = 2.0f * pw, sv0 = 10.0f * vw;
  std::vector<float> cpp(m, sp0 * sp0), cpv(m, 0.0f), cvv(m, sv0 * sv0);
  std::memcpy(out_mean, mp.data(), m * sizeof(float));
  const float qp = pw * pw, qv = vw * vw, r = pw * pw;
  for (int i = 1; i < n; ++i) {
    const float* zi = z + static_cast<size_t>(i) * m;
    float* oi = out_mean + static_cast<size_t>(i) * m;
    for (int k = 0; k < m; ++k) {
      // predict
      mp[k] += mv[k];
      cpp[k] = cpp[k] + 2.0f * cpv[k] + cvv[k] + qp;
      cpv[k] += cvv[k];
      cvv[k] += qv;
      // update
      const float S = cpp[k] + r;
      const float nu = zi[k] - mp[k];
      const float gp = cpp[k] / S;
      const float gv = cpv[k] / S;
      mp[k] += nu * gp;
      mv[k] += nu * gv;
      const float cpp0 = cpp[k], cpv0 = cpv[k];
      cpp[k] = cpp0 - cpp0 * gp;
      cpv[k] = cpv0 - cpp0 * gv;
      cvv[k] = cvv[k] - cpv0 * gv;
      oi[k] = mp[k];
    }
  }
  return 0;
}

// clang-format off
int sort_step_host(
    // --- static config ---
    int method,                 // 0 = iou, 1 = maha
    int oriented,               // rotated boxes: IoU via the f32 clip (clip.h)
    float iou_threshold, float min_confidence, int max_idle_epochs,
    float position_weight, float velocity_weight, float new_track_threshold,
    const float* constraints, int n_constraints,  // (delta, max_dist) pairs, ascending delta
    // --- state (SoA, capacity T, history H) ---
    float* kf_mp, float* kf_mv, float* kf_cpp, float* kf_cpv, float* kf_cvv,  // [T,5]
    float* pred_box, float* obs_box,                                          // [T,5]
    float* conf, uint8_t* active, int32_t* last_epoch, int32_t* length,
    int32_t* track_id,
    float* hist_obs, float* hist_pred, float* hist_conf,  // [T,H,5] x2, [T,H]
    int T, int H, int next_id,
    // --- detections ---
    const float* det_box, const float* det_conf, int D, int epoch,
    // --- outputs ---
    int32_t* out_slot, int32_t* out_id, uint8_t* out_is_new,
    float* out_pred, int32_t* out_length, int32_t* out_next_id) {
  // clang-format on
  if (D <= 0) { *out_next_id = next_id; return 0; }

  // ---- compatible track columns --------------------------------------
  std::vector<int32_t> cols;
  cols.reserve(T);
  for (int t = 0; t < T; ++t) {
    if (active[t] && (epoch - last_epoch[t]) <= max_idle_epochs)
      cols.push_back(t);
  }
  const int C = static_cast<int>(cols.size());

  // ---- candidate pairs via a uniform grid on track centers ------------
  // too_far prune: |c_i - c_j| <= r_i + r_j (bbox.rs:452-462); grid cell =
  // max track radius, scan radius ceil((r_i + rmax)/cell).
  std::vector<float> trk_r(C);
  float rmax = 1.0f;
  const float kPosInf = std::numeric_limits<float>::infinity();
  float xmin = kPosInf, ymin = kPosInf;
  float xmax = -kPosInf, ymax = -kPosInf;
  for (int c = 0; c < C; ++c) {
    const float* b = pred_box + static_cast<size_t>(cols[c]) * 5;
    trk_r[c] = box_radius(b);
    rmax = std::max(rmax, trk_r[c]);
    xmin = std::min(xmin, b[0]); xmax = std::max(xmax, b[0]);
    ymin = std::min(ymin, b[1]); ymax = std::max(ymax, b[1]);
  }
  // CSR adjacency: per detection, (col index, weight) of nonzero edges
  std::vector<int32_t> e_col;
  std::vector<float> e_w;
  std::vector<int32_t> e_off(D + 1, 0);

  // oriented IoU: per-box rotation offsets hoisted out of the pair loop
  // (the cos/sin pair dominated the clip cost; bit-exact, clip.h)
  std::vector<similari_clip::QuadRot> det_rot, trk_rot;
  if (method == 0 && oriented) {
    det_rot.resize(D);
    trk_rot.resize(C);
    for (int i = 0; i < D; ++i)
      similari_clip::box_rot_f32(det_box + static_cast<size_t>(i) * 5,
                                 det_rot[i]);
    for (int c = 0; c < C; ++c)
      similari_clip::box_rot_f32(
          pred_box + static_cast<size_t>(cols[c]) * 5, trk_rot[c]);
  }

  auto pair_weight = [&](int i, int c) -> float {
    const float* a = det_box + static_cast<size_t>(i) * 5;
    const int t = cols[c];
    const float* b = pred_box + static_cast<size_t>(t) * 5;
    const float cf = std::max(det_conf[i], min_confidence);
    if (n_constraints) {
      const int delta = epoch - last_epoch[t];
      float allowed = std::numeric_limits<float>::infinity();
      for (int k = 0; k < n_constraints; ++k) {
        if (delta <= static_cast<int>(constraints[2 * k])) {
          allowed = constraints[2 * k + 1];
          break;
        }
      }
      const float dx = a[0] - b[0], dy = a[1] - b[1];
      const float rd = box_radius(a) + trk_r[c];
      const float d2r = std::sqrt(dx * dx + dy * dy) /
                        std::sqrt(rd * rd + 1e-5f);
      if (!(d2r <= allowed)) return 0.0f;
    }
    if (method == 0 && oriented) {  // rotated IoU (geometry.py op order)
      const float iou = similari_clip::rotated_iou_pre_f32(
          a, det_rot[i], b, trk_rot[c]);
      if (!(iou > 0.0f)) return 0.0f;
      const float m = iou * cf;
      return (m >= iou_threshold) ? m : 0.0f;
    }
    if (method == 0) {  // IoU (aligned)
      const float aw = a[3] * a[4], tw = b[3] * b[4];
      const float iw = std::min(a[0] + aw * 0.5f, b[0] + tw * 0.5f) -
                       std::max(a[0] - aw * 0.5f, b[0] - tw * 0.5f);
      const float ih = std::min(a[1] + a[4] * 0.5f, b[1] + b[4] * 0.5f) -
                       std::max(a[1] - a[4] * 0.5f, b[1] - b[4] * 0.5f);
      if (!(iw > 0.0f && ih > 0.0f)) return 0.0f;
      const float inter = iw * ih;
      const float uni = aw * a[4] + tw * b[4] - inter;
      const float m = (inter / uni) * cf;
      return (m >= iou_threshold) ? m : 0.0f;
    }
    // Mahalanobis: too_far prune then chi2-gated inverted cost / conf
    const float dx = a[0] - b[0], dy = a[1] - b[1];
    const float md = box_radius(a) + trk_r[c];
    if (dx * dx + dy * dy > md * md) return 0.0f;
    const float* mp = kf_mp + static_cast<size_t>(t) * 5;
    const float* cpp = kf_cpp + static_cast<size_t>(t) * 5;
    const float p = mp[4];
    float d2 = 0.0f;
    for (int k = 0; k < 5; ++k) {
      const float rs = (k == 3) ? 1e-1f : position_weight * p;
      const float S = cpp[k] + rs * rs;
      const float nu = a[k] - mp[k];
      d2 += nu * nu / S;
    }
    if (d2 > kChi2Gate) return 0.0f;
    return (kChi2Upper - d2) / cf;
  };

  if (C > 0) {
    const bool brute = static_cast<long>(D) * C <= 4096;
    if (brute) {
      for (int i = 0; i < D; ++i) {
        for (int c = 0; c < C; ++c) {
          const float w = pair_weight(i, c);
          if (w > 0.0f) { e_col.push_back(c); e_w.push_back(w); }
        }
        e_off[i + 1] = static_cast<int32_t>(e_col.size());
      }
    } else {
      // cell >= extent/1022 keeps the grid <= 1024 wide WITHOUT clamping
      // (clamped track cells + unclamped detection windows would miss
      // candidates when scenes span a huge area)
      const float cell = std::max(
          std::max(rmax, 1.0f),
          std::max((xmax - xmin) / 1022.0f, (ymax - ymin) / 1022.0f));
      const int gx = std::min(1024, std::max(1, static_cast<int>((xmax - xmin) / cell) + 1));
      const int gy = std::min(1024, std::max(1, static_cast<int>((ymax - ymin) / cell) + 1));
      std::vector<int32_t> head(static_cast<size_t>(gx) * gy, -1), nxt(C, -1);
      auto cell_of = [&](float x, float y) {
        int cx = static_cast<int>((x - xmin) / cell);
        int cy = static_cast<int>((y - ymin) / cell);
        cx = std::min(std::max(cx, 0), gx - 1);
        cy = std::min(std::max(cy, 0), gy - 1);
        return cy * gx + cx;
      };
      for (int c = 0; c < C; ++c) {
        const float* b = pred_box + static_cast<size_t>(cols[c]) * 5;
        const int id = cell_of(b[0], b[1]);
        nxt[c] = head[id];
        head[id] = c;
      }
      for (int i = 0; i < D; ++i) {
        const float* a = det_box + static_cast<size_t>(i) * 5;
        const float reach = box_radius(a) + rmax;
        const int span = static_cast<int>(reach / cell) + 1;
        // clamp with floor semantics so far-outside detections still scan
        // the nearest boundary cells (pair_weight re-checks true distance)
        int cx0 = static_cast<int>(std::floor((a[0] - xmin) / cell));
        int cy0 = static_cast<int>(std::floor((a[1] - ymin) / cell));
        cx0 = std::min(std::max(cx0, 0), gx - 1);
        cy0 = std::min(std::max(cy0, 0), gy - 1);
        for (int cy = std::max(cy0 - span, 0); cy <= std::min(cy0 + span, gy - 1); ++cy) {
          for (int cx = std::max(cx0 - span, 0); cx <= std::min(cx0 + span, gx - 1); ++cx) {
            for (int c = head[static_cast<size_t>(cy) * gx + cx]; c >= 0; c = nxt[c]) {
              const float w = pair_weight(i, c);
              if (w > 0.0f) { e_col.push_back(c); e_w.push_back(w); }
            }
          }
        }
        e_off[i + 1] = static_cast<int32_t>(e_col.size());
      }
    }
  }

  // ---- dominance reduction: drop columns whose best weight < theta ----
  const float theta = new_track_threshold;
  std::vector<float> colmax(C, 0.0f);
  for (size_t e = 0; e < e_col.size(); ++e)
    colmax[e_col[e]] = std::max(colmax[e_col[e]], e_w[e]);

  // ---- bipartite components over surviving edges (DSU on D + C nodes) -
  DSU dsu(D + C);
  for (int i = 0; i < D; ++i)
    for (int32_t e = e_off[i]; e < e_off[i + 1]; ++e)
      if (colmax[e_col[e]] >= theta) dsu.unite(i, D + e_col[e]);

  std::vector<int32_t> tgt(D, -1);  // matched col (into cols) or -1 = new

  // group rows by component root; singleton rows take their best column
  std::vector<int32_t> root(D);
  std::vector<int32_t> comp_rows(D);
  for (int i = 0; i < D; ++i) { root[i] = dsu.find(i); comp_rows[i] = i; }
  std::sort(comp_rows.begin(), comp_rows.end(),
            [&](int a, int b) { return root[a] < root[b]; });

  std::vector<int32_t> cmap(C, -1);      // col -> local index scratch
  std::vector<int32_t> loc_cols;
  std::vector<float> mat;
  std::vector<int32_t> sol;
  for (int s = 0; s < D;) {
    int e2 = s;
    while (e2 < D && root[comp_rows[e2]] == root[comp_rows[s]]) ++e2;
    const int nr = e2 - s;
    if (nr == 1) {
      const int i = comp_rows[s];
      float best = 0.0f;
      int bc = -1;
      for (int32_t e = e_off[i]; e < e_off[i + 1]; ++e) {
        if (colmax[e_col[e]] < theta) continue;
        if (e_w[e] > best) { best = e_w[e]; bc = e_col[e]; }
      }
      if (bc >= 0 && best >= theta) tgt[i] = bc;
      s = e2;
      continue;
    }
    // local column set
    loc_cols.clear();
    for (int k = s; k < e2; ++k) {
      const int i = comp_rows[k];
      for (int32_t e = e_off[i]; e < e_off[i + 1]; ++e) {
        const int c = e_col[e];
        if (colmax[c] >= theta && cmap[c] < 0) {
          cmap[c] = static_cast<int32_t>(loc_cols.size());
          loc_cols.push_back(c);
        }
      }
    }
    const int nc = static_cast<int>(loc_cols.size());
    mat.assign(static_cast<size_t>(nr) * (nr + nc), 0.0f);
    for (int k = 0; k < nr; ++k) {
      mat[static_cast<size_t>(k) * (nr + nc) + k] = theta;  // private diag
      const int i = comp_rows[s + k];
      for (int32_t e = e_off[i]; e < e_off[i + 1]; ++e) {
        const int c = e_col[e];
        if (colmax[c] >= theta)
          mat[static_cast<size_t>(k) * (nr + nc) + nr + cmap[c]] = e_w[e];
      }
    }
    sol.assign(nr, -1);
    if (lap_solve_max(mat.data(), nr, nr + nc, sol.data()) != 0) return 2;
    for (int k = 0; k < nr; ++k)
      if (sol[k] >= nr) tgt[comp_rows[s + k]] = loc_cols[sol[k] - nr];
    for (int c : loc_cols) cmap[c] = -1;
    s = e2;
  }

  // ---- slot allocation -------------------------------------------------
  std::vector<int32_t> slot(D);
  int free_cursor = 0;
  int n_new = 0;
  for (int i = 0; i < D; ++i) {
    if (tgt[i] >= 0) {
      slot[i] = cols[tgt[i]];
    } else {
      while (free_cursor < T && active[free_cursor]) ++free_cursor;
      if (free_cursor >= T) return 1;  // overflow: caller grows + retries
      slot[i] = free_cursor++;
      ++n_new;
    }
  }

  // ---- Kalman + write-back --------------------------------------------
  int new_rank = 0;
  for (int i = 0; i < D; ++i) {
    const float* z = det_box + static_cast<size_t>(i) * 5;
    const int t = slot[i];
    const size_t t5 = static_cast<size_t>(t) * 5;
    KfRow s;
    const bool matched = tgt[i] >= 0;
    if (matched) {
      similari_kf::load_row(t, s, kf_mp, kf_mv, kf_cpp, kf_cpv, kf_cvv);
    } else {
      kf_initiate(z, position_weight, velocity_weight, s);
    }
    kf_predict(position_weight, velocity_weight, s);
    kf_update(z, position_weight, s);
    similari_kf::store_row(s, t, kf_mp, kf_mv, kf_cpp, kf_cpv, kf_cvv);
    std::memcpy(pred_box + t5, s.mp, 5 * sizeof(float));
    std::memcpy(obs_box + t5, z, 5 * sizeof(float));
    conf[t] = det_conf[i];
    const int32_t len = matched ? length[t] + 1 : 1;
    const int32_t id = matched ? track_id[t] : next_id + (++new_rank);
    active[t] = 1;
    last_epoch[t] = epoch;
    length[t] = len;
    track_id[t] = id;
    const int hix = (len - 1) % H;
    std::memcpy(hist_obs + (static_cast<size_t>(t) * H + hix) * 5, z,
                5 * sizeof(float));
    std::memcpy(hist_pred + (static_cast<size_t>(t) * H + hix) * 5, s.mp,
                5 * sizeof(float));
    hist_conf[static_cast<size_t>(t) * H + hix] = det_conf[i];

    out_slot[i] = t;
    out_id[i] = id;
    out_is_new[i] = matched ? 0 : 1;
    std::memcpy(out_pred + static_cast<size_t>(i) * 5, s.mp,
                5 * sizeof(float));
    out_length[i] = len;
  }
  *out_next_id = next_id + n_new;
  return 0;
}

}  // extern "C"
