// Native host VisualSORT step — the small-N per-call fast path: the port's
// copy of the JAX package's `native/visualstep.cpp`, code line for line.
//
// One C call runs a full VisualSORT epoch on the host SoA state with the
// exact semantics of trackers/visual_step.py (and the NumPy twin
// trackers/host_visual.py, which this replaces for small frames):
// compatible-track selection (+spatio-temporal constraints), IoU or
// chi2-gated Mahalanobis positional weights (visual_sort/metric.rs:156-198),
// gallery feature distances with the quality/area/own-area gates and
// TopN-style votes/weights (metric.rs:200-295, voting/best.rs:92-103), the
// cascade voting — closed-form greedy best-fit claim, then the exact
// augmented LP on the positional remainder via lap.cpp — and the gallery
// maintenance (quality-sorted eviction, collect gates, first-feature
// bypass) plus the decomposed-block Kalman update (kf.h).
//
// Sized for interactive frames (the distance loop is O(D*C*K*F) scalar
// unless the caller passes the BLAS product, `native.py::_visual_dmat`):
// frames past 128 detections use the NumPy/BLAS twin, bulk throughput the
// device engines.
//
// C ABI: visual_step_host(...) -> 0 ok, 1 overflow.

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

constexpr float kChi2Gate = 11.070f;   // CHI2INV95[4], kalman_2d_box.rs:174
constexpr float kChi2Upper = 100.0f;
constexpr float kNeg = -1e30f;

inline float box_radius(const float* b) {
  const float hw = b[3] * b[4] * 0.5f;
  const float hh = b[4] * 0.5f;
  return std::sqrt(hw * hw + hh * hh);
}

// SIMD dot product with two independent 8-lane accumulators.  A naive
// `acc += a[i]*b[i]` loop is a serial float dependency chain that g++ will
// NOT vectorize under strict FP semantics (~2 cycles/element measured);
// GCC vector extensions keep the lane-wise order deterministic and measured
// ~4-6x faster at F=512 — this loop is the whole cost of the interactive
// VisualSORT call (D*C*K*F elements).
#if defined(__GNUC__) || defined(__clang__)
typedef float v8sf __attribute__((vector_size(32)));
inline float dot_f32(const float* a, const float* b, int n) {
  v8sf acc0 = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  v8sf acc1 = acc0;
  int i = 0;
  for (; i + 16 <= n; i += 16) {
    v8sf va0, vb0, va1, vb1;
    std::memcpy(&va0, a + i, 32);
    std::memcpy(&vb0, b + i, 32);
    std::memcpy(&va1, a + i + 8, 32);
    std::memcpy(&vb1, b + i + 8, 32);
    acc0 += va0 * vb0;
    acc1 += va1 * vb1;
  }
  for (; i + 8 <= n; i += 8) {
    v8sf va, vb;
    std::memcpy(&va, a + i, 32);
    std::memcpy(&vb, b + i, 32);
    acc0 += va * vb;
  }
  const v8sf acc = acc0 + acc1;
  float s = ((acc[0] + acc[4]) + (acc[1] + acc[5])) +
            ((acc[2] + acc[6]) + (acc[3] + acc[7]));
  for (; i < n; ++i) s += a[i] * b[i];
  return s;
}
#else
inline float dot_f32(const float* a, const float* b, int n) {
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  int i = 0;
  for (; i + 8 <= n; i += 8)
    for (int l = 0; l < 8; ++l) acc[l] += a[i + l] * b[i + l];
  float s = ((acc[0] + acc[4]) + (acc[1] + acc[5])) +
            ((acc[2] + acc[6]) + (acc[3] + acc[7]));
  for (; i < n; ++i) s += a[i] * b[i];
  return s;
}
#endif

}  // namespace

extern "C" {

// clang-format off
int visual_step_host(
    // --- config ---
    // fcfg: [0] iou_threshold [1] positional_min_confidence
    //       [2] visual_threshold [3] visual_minimal_area
    //       [4] quality_use [5] quality_collect [6] own_area_use
    //       [7] own_area_collect [8] position_weight [9] velocity_weight
    //       [10] new_track_threshold
    const float* fcfg,
    // icfg: [0] positional_kind (0 iou, 1 maha) [1] visual_kind (0 euc, 1 cos)
    //       [2] min_votes [3] minimal_track_length [4] max_idle_epochs
    //       [5] n_constraints [6] oriented (rotated boxes -> f32 clip IoU)
    const int32_t* icfg,
    const float* constraints,  // (delta, max_dist) pairs, ascending delta
    // --- state (SoA; capacity T, history H, gallery K, feature dim F) ---
    float* kf_mp, float* kf_mv, float* kf_cpp, float* kf_cpv, float* kf_cvv,
    float* pred_box, float* obs_box, float* conf,
    uint8_t* active, int32_t* last_epoch, int32_t* length, int32_t* track_id,
    float* feats, float* feat_quality, uint8_t* feat_valid,
    int32_t* collected, int32_t* voting_type,
    float* hist_obs, float* hist_pred, float* hist_conf,
    float* hist_feat, uint8_t* hist_feat_valid,
    int T, int H, int K, int F, int next_id,
    // --- detections ---
    const float* det_box, const float* det_conf, const float* det_feat,
    const uint8_t* det_feat_valid, const float* det_quality,
    const float* det_own_area,
    // dmat[D, C*K]: det_feat @ feats[cols]^T in COLS-COMPACT layout,
    // precomputed by the caller with a real GEMM over the active columns
    // only (the Python wrapper uses the 1-thread-pinned BLAS: 96 GFLOP/s
    // vs ~29 for the row-dot loop — the all-pairs gallery scoring IS the
    // interactive visual call at 512-d).  The caller replicates the cols
    // rule (active && epoch-last_epoch <= max_idle, slot order);
    // dmat_cols cross-checks the replica and must equal C.  dmat NULL
    // (dmat_cols < 0) -> in-step dot_f32.
    const float* dmat, int dmat_cols, int D, int epoch,
    // --- outputs ---
    int32_t* out_slot, int32_t* out_id, uint8_t* out_is_new, float* out_pred,
    int32_t* out_length, int32_t* out_vt, int32_t* out_next_id) {
  // clang-format on
  if (D <= 0) { *out_next_id = next_id; return 0; }
  const float iou_thr = fcfg[0], pos_min_conf = fcfg[1], vis_thr = fcfg[2];
  const float min_area = fcfg[3], q_use = fcfg[4], q_collect = fcfg[5];
  const float oa_use = fcfg[6], oa_collect = fcfg[7];
  const float pw = fcfg[8], vw = fcfg[9], theta = fcfg[10];
  const bool maha = icfg[0] == 1, cosine = icfg[1] == 1;
  const int min_votes = icfg[2], mtl = icfg[3], max_idle = icfg[4];
  const int n_cons = icfg[5];
  const bool oriented = icfg[6] == 1;

  // ---- compatible columns ---------------------------------------------
  std::vector<int32_t> cols;
  cols.reserve(T);
  for (int t = 0; t < T; ++t)
    if (active[t] && (epoch - last_epoch[t]) <= max_idle) cols.push_back(t);
  const int C = static_cast<int>(cols.size());

  std::vector<uint8_t> compat(static_cast<size_t>(D) * C, 1);
  if (n_cons && C) {
    for (int i = 0; i < D; ++i) {
      const float* a = det_box + static_cast<size_t>(i) * 5;
      for (int c = 0; c < C; ++c) {
        const float* b = pred_box + static_cast<size_t>(cols[c]) * 5;
        const int delta = epoch - last_epoch[cols[c]];
        float allowed = std::numeric_limits<float>::infinity();
        for (int k = 0; k < n_cons; ++k) {
          if (delta <= static_cast<int>(constraints[2 * k])) {
            allowed = constraints[2 * k + 1];
            break;
          }
        }
        const float dx = a[0] - b[0], dy = a[1] - b[1];
        const float rd = box_radius(a) + box_radius(b);
        const float d2r =
            std::sqrt(dx * dx + dy * dy) / std::sqrt(rd * rd + 1e-5f);
        compat[static_cast<size_t>(i) * C + c] = (d2r <= allowed) ? 1 : 0;
      }
    }
  }

  // ---- positional weights P[D,C] (0 = no edge) ------------------------
  // oriented IoU: per-box rotation offsets hoisted out of the pair loop
  // (no trig per pair; bit-exact, clip.h)
  std::vector<similari_clip::QuadRot> det_rot, trk_rot;
  if (!maha && oriented) {
    det_rot.resize(D);
    trk_rot.resize(C);
    for (int i = 0; i < D; ++i)
      similari_clip::box_rot_f32(det_box + static_cast<size_t>(i) * 5,
                                 det_rot[i]);
    for (int c = 0; c < C; ++c)
      similari_clip::box_rot_f32(
          pred_box + static_cast<size_t>(cols[c]) * 5, trk_rot[c]);
  }
  std::vector<float> P(static_cast<size_t>(D) * C, 0.0f);
  for (int i = 0; i < D; ++i) {
    const float* a = det_box + static_cast<size_t>(i) * 5;
    const float cf = std::max(det_conf[i], pos_min_conf);
    for (int c = 0; c < C; ++c) {
      if (!compat[static_cast<size_t>(i) * C + c]) continue;
      const int t = cols[c];
      const float* b = pred_box + static_cast<size_t>(t) * 5;
      float w = 0.0f;
      if (!maha && oriented) {
        const float iou = similari_clip::rotated_iou_pre_f32(
            a, det_rot[i], b, trk_rot[c]);
        if (!(iou > 0.0f)) continue;
        const float m = iou * cf;
        if (m < iou_thr) continue;
        w = m;
      } else if (!maha) {
        const float aw = a[3] * a[4], tw = b[3] * b[4];
        const float iw = std::min(a[0] + aw * 0.5f, b[0] + tw * 0.5f) -
                         std::max(a[0] - aw * 0.5f, b[0] - tw * 0.5f);
        const float ih = std::min(a[1] + a[4] * 0.5f, b[1] + b[4] * 0.5f) -
                         std::max(a[1] - a[4] * 0.5f, b[1] - b[4] * 0.5f);
        if (!(iw > 0.0f && ih > 0.0f)) continue;
        const float inter = iw * ih;
        const float uni = aw * a[4] + tw * b[4] - inter;
        const float m = (inter / uni) * cf;
        if (m < iou_thr) continue;
        w = m;
      } else {
        const float dx = a[0] - b[0], dy = a[1] - b[1];
        const float md = box_radius(a) + box_radius(b);
        if (dx * dx + dy * dy > md * md) continue;  // too_far
        const float* mp = kf_mp + static_cast<size_t>(t) * 5;
        const float* cpp = kf_cpp + static_cast<size_t>(t) * 5;
        const float p = mp[4];
        float d2 = 0.0f;
        for (int k = 0; k < 5; ++k) {
          const float rs = (k == 3) ? 1e-1f : pw * p;
          const float S = cpp[k] + rs * rs;
          const float nu = a[k] - mp[k];
          d2 += nu * nu / S;
        }
        const float cost = (d2 > kChi2Gate) ? 0.0f : (kChi2Upper - d2);
        w = cost / cf;
        if (w <= 0.0f) continue;
      }
      P[static_cast<size_t>(i) * C + c] = w;
    }
  }

  // ---- candidate gates -------------------------------------------------
  std::vector<uint8_t> use_gate(D), collect_gate(D);
  for (int i = 0; i < D; ++i) {
    const float* a = det_box + static_cast<size_t>(i) * 5;
    const float area = a[3] * a[4] * a[4];
    const bool area_ok = area >= min_area;
    use_gate[i] = det_feat_valid[i] && det_quality[i] >= q_use &&
                  det_own_area[i] >= oa_use && area_ok;
    collect_gate[i] = det_feat_valid[i] && det_quality[i] >= q_collect &&
                      det_own_area[i] >= oa_collect && area_ok;
  }

  // ---- gallery distances + votes/weights -------------------------------
  // two passes: first find the global max over metric-passed distances
  // (the reference's max_dist), then accumulate weights = sum(max_dist - d)
  std::vector<float> qn(D);
  for (int i = 0; i < D; ++i) {
    const float* q = det_feat + static_cast<size_t>(i) * F;
    qn[i] = dot_f32(q, q, F);
  }
  std::vector<float> dist(static_cast<size_t>(D) * C * K, 0.0f);
  std::vector<uint8_t> dvalid3(static_cast<size_t>(D) * C * K, 0);
  float max_dist = kNeg;
  bool any_valid = false;
  if (dmat && dmat_cols != C) return 3;  // caller's cols replica diverged
  for (int c = 0; c < C; ++c) {
    const int t = cols[c];
    if (collected[t] < mtl) continue;
    for (int k = 0; k < K; ++k) {
      if (!feat_valid[static_cast<size_t>(t) * K + k]) continue;
      const float* g = feats + (static_cast<size_t>(t) * K + k) * F;
      const float gn = dot_f32(g, g, F);
      const float* drow = dmat ? dmat + static_cast<size_t>(c) * K + k
                               : nullptr;
      const size_t dstride = static_cast<size_t>(C) * K;
      for (int i = 0; i < D; ++i) {
        if (!use_gate[i] || !compat[static_cast<size_t>(i) * C + c]) continue;
        const float* q = det_feat + static_cast<size_t>(i) * F;
        const float dot = drow ? drow[static_cast<size_t>(i) * dstride]
                               : dot_f32(q, g, F);
        float w;
        bool ok;
        if (!cosine) {
          const float d2 = std::max(qn[i] + gn - 2.0f * dot, 0.0f);
          w = std::sqrt(d2);
          ok = w <= vis_thr;
        } else {
          const float den = std::sqrt(qn[i] * gn);
          const float sim = dot / (den > 0.0f ? den : 1.0f);
          ok = sim >= vis_thr;
          w = 1.0f - sim;
        }
        if (!ok) continue;
        const size_t ix = (static_cast<size_t>(i) * C + c) * K + k;
        dist[ix] = w;
        dvalid3[ix] = 1;
        any_valid = true;
        if (w > max_dist) max_dist = w;
      }
    }
  }
  std::vector<int32_t> votes(static_cast<size_t>(D) * C, 0);
  std::vector<float> weight(static_cast<size_t>(D) * C, 0.0f);
  if (any_valid) {
    for (int i = 0; i < D; ++i)
      for (int c = 0; c < C; ++c) {
        int v = 0;
        float w = 0.0f;
        for (int k = 0; k < K; ++k) {
          const size_t ix = (static_cast<size_t>(i) * C + c) * K + k;
          if (dvalid3[ix]) { ++v; w += max_dist - dist[ix]; }
        }
        votes[static_cast<size_t>(i) * C + c] = v;
        weight[static_cast<size_t>(i) * C + c] = w;
      }
  }

  // ---- closed-form greedy best-fit (visual_step.py formulation) --------
  std::vector<int32_t> t1(D, 0);
  std::vector<uint8_t> has_any(D, 0), wins_visual(D, 0);
  std::vector<uint8_t> claimed(C, 0);
  if (C) {
    // wm = eligible ? weight : -inf; t1 = row argmax (first max)
    std::vector<float> colmaxw(C, kNeg);
    std::vector<int32_t> best_query(C, 0);
    for (int i = 0; i < D; ++i) {
      float best = kNeg;
      int bc = 0;
      for (int c = 0; c < C; ++c) {
        const size_t ix = static_cast<size_t>(i) * C + c;
        const float w = votes[ix] >= min_votes ? weight[ix] : kNeg;
        if (w > best) { best = w; bc = c; }
        if (votes[ix] >= min_votes) has_any[i] = 1;
        if (w > colmaxw[c]) { colmaxw[c] = w; best_query[c] = i; }
      }
      t1[i] = bc;
    }
    for (int i = 0; i < D; ++i)
      if (has_any[i] && best_query[t1[i]] == i) {
        wins_visual[i] = 1;
        claimed[t1[i]] = 1;
      }
  }

  // ---- positional LP on the remainder ----------------------------------
  std::vector<int32_t> tgt_col(D, -1);
  {
    std::vector<int32_t> rows, ocols;
    for (int i = 0; i < D; ++i)
      if (!has_any[i]) rows.push_back(i);
    for (int c = 0; c < C; ++c)
      if (!claimed[c]) ocols.push_back(c);
    const int R = static_cast<int>(rows.size());
    const int OC = static_cast<int>(ocols.size());
    if (R) {
      std::vector<float> a(static_cast<size_t>(R) * (R + OC), 0.0f);
      for (int r = 0; r < R; ++r) {
        a[static_cast<size_t>(r) * (R + OC) + r] = theta;
        for (int c2 = 0; c2 < OC; ++c2)
          a[static_cast<size_t>(r) * (R + OC) + R + c2] =
              P[static_cast<size_t>(rows[r]) * C + ocols[c2]];
      }
      std::vector<int32_t> sol(R, -1);
      if (lap_solve_max(a.data(), R, R + OC, sol.data()) != 0) return 2;
      for (int r = 0; r < R; ++r)
        if (sol[r] >= R) tgt_col[rows[r]] = ocols[sol[r] - R];
    }
  }

  // ---- slot allocation -------------------------------------------------
  std::vector<int32_t> slot(D);
  int free_cursor = 0, n_new = 0;
  for (int i = 0; i < D; ++i) {
    const bool matched = wins_visual[i] || tgt_col[i] >= 0;
    if (matched) {
      slot[i] = cols[wins_visual[i] ? t1[i] : tgt_col[i]];
    } else {
      while (free_cursor < T && active[free_cursor]) ++free_cursor;
      if (free_cursor >= T) return 1;  // overflow (caller grows+retries)
      slot[i] = free_cursor++;
      ++n_new;
    }
  }

  // ---- KF + gallery + write-back ---------------------------------------
  int new_rank = 0;
  for (int i = 0; i < D; ++i) {
    const float* z = det_box + static_cast<size_t>(i) * 5;
    const int t = slot[i];
    const bool matched = wins_visual[i] || tgt_col[i] >= 0;
    similari_kf::KfRow s;
    if (matched) {
      similari_kf::load_row(t, s, kf_mp, kf_mv, kf_cpp, kf_cpv, kf_cvv);
    } else {
      similari_kf::kf_initiate(z, pw, vw, s);
    }
    similari_kf::kf_predict(pw, vw, s);
    similari_kf::kf_update(z, pw, s);
    similari_kf::store_row(s, t, kf_mp, kf_mv, kf_cpp, kf_cpv, kf_cvv);

    const size_t t5 = static_cast<size_t>(t) * 5;
    std::memcpy(pred_box + t5, s.mp, 5 * sizeof(float));
    std::memcpy(obs_box + t5, z, 5 * sizeof(float));
    conf[t] = det_conf[i];

    // gallery bookkeeping (`visual_sort/metric.rs:297-374`)
    uint8_t* fv = feat_valid + static_cast<size_t>(t) * K;
    float* fq = feat_quality + static_cast<size_t>(t) * K;
    if (!matched)
      for (int k = 0; k < K; ++k) fv[k] = 0;
    int n_f = 0;
    for (int k = 0; k < K; ++k) n_f += fv[k] ? 1 : 0;
    if (n_f >= K) {  // evict lowest-quality live lane (first argmin)
      int ek = 0;
      float mq = std::numeric_limits<float>::infinity();
      for (int k = 0; k < K; ++k)
        if (fv[k] && fq[k] < mq) { mq = fq[k]; ek = k; }
      fv[ek] = 0;
    }
    const bool keep_new =
        det_feat_valid[i] && (!matched || collect_gate[i]);
    int freek = 0;
    for (int k = 0; k < K; ++k)
      if (!fv[k]) { freek = k; break; }
    if (keep_new) {
      std::memcpy(feats + (static_cast<size_t>(t) * K + freek) * F,
                  det_feat + static_cast<size_t>(i) * F, F * sizeof(float));
      fq[freek] = det_quality[i];
      fv[freek] = 1;
    }
    int coll = 0;
    for (int k = 0; k < K; ++k) coll += fv[k] ? 1 : 0;
    collected[t] = coll;

    const int32_t len = matched ? length[t] + 1 : 1;
    const int32_t id = matched ? track_id[t] : next_id + (++new_rank);
    active[t] = 1;
    last_epoch[t] = epoch;
    length[t] = len;
    track_id[t] = id;
    voting_type[t] = wins_visual[i] ? 0 : 1;
    const int hix = (len - 1) % H;
    std::memcpy(hist_obs + (static_cast<size_t>(t) * H + hix) * 5, z,
                5 * sizeof(float));
    std::memcpy(hist_pred + (static_cast<size_t>(t) * H + hix) * 5, s.mp,
                5 * sizeof(float));
    hist_conf[static_cast<size_t>(t) * H + hix] = det_conf[i];
    std::memcpy(hist_feat + (static_cast<size_t>(t) * H + hix) * F,
                det_feat + static_cast<size_t>(i) * F, F * sizeof(float));
    hist_feat_valid[static_cast<size_t>(t) * H + hix] = det_feat_valid[i];

    out_slot[i] = t;
    out_id[i] = id;
    out_is_new[i] = matched ? 0 : 1;
    std::memcpy(out_pred + static_cast<size_t>(i) * 5, s.mp,
                5 * sizeof(float));
    out_length[i] = len;
    out_vt[i] = wins_visual[i] ? 0 : 1;
  }
  *out_next_id = next_id + n_new;
  return 0;
}

}  // extern "C"
