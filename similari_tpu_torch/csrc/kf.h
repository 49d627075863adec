// Shared decomposed-block Kalman helpers for the native host steps (the
// port's copy of the JAX package's `native/kf.h`, code line for line).
//
// Same recurrences as ops/kalman.py / kalman_2d_box.rs:58-148: the motion
// model never couples components, so the 10x10 covariance is five
// independent 2x2 blocks (cpp, cpv, cvv per component); the aspect slot
// (k==3) uses constant noise stds instead of height-scaled ones.

#ifndef SIMILARI_NATIVE_KF_H_
#define SIMILARI_NATIVE_KF_H_

#include <cstring>

namespace similari_kf {

struct KfRow {
  float mp[5], mv[5], cpp[5], cpv[5], cvv[5];
};

inline void kf_initiate(const float* z, float pw, float vw, KfRow& s) {
  const float p = z[4];
  for (int k = 0; k < 5; ++k) {
    const float sp = (k == 3) ? 1e-2f : 2.0f * pw * p;
    const float sv = (k == 3) ? 1e-5f : 10.0f * vw * p;
    s.mp[k] = z[k];
    s.mv[k] = 0.0f;
    s.cpp[k] = sp * sp;
    s.cpv[k] = 0.0f;
    s.cvv[k] = sv * sv;
  }
}

inline void kf_predict(float pw, float vw, KfRow& s) {
  const float p = s.mp[4];
  for (int k = 0; k < 5; ++k) {
    const float qp = (k == 3) ? 1e-2f : pw * p;
    const float qv = (k == 3) ? 1e-5f : vw * p;
    s.mp[k] += s.mv[k];
    s.cpp[k] = s.cpp[k] + 2.0f * s.cpv[k] + s.cvv[k] + qp * qp;
    s.cpv[k] += s.cvv[k];
    s.cvv[k] += qv * qv;
  }
}

inline void kf_update(const float* z, float pw, KfRow& s) {
  const float p = s.mp[4];
  for (int k = 0; k < 5; ++k) {
    const float rs = (k == 3) ? 1e-1f : pw * p;
    const float S = s.cpp[k] + rs * rs;
    const float nu = z[k] - s.mp[k];
    const float gp = s.cpp[k] / S;
    const float gv = s.cpv[k] / S;
    s.mp[k] += nu * gp;
    s.mv[k] += nu * gv;
    const float cpp0 = s.cpp[k], cpv0 = s.cpv[k];
    s.cpp[k] = cpp0 - cpp0 * gp;
    s.cpv[k] = cpv0 - cpp0 * gv;
    s.cvv[k] = s.cvv[k] - cpv0 * gv;
  }
}

inline void load_row(int t, KfRow& s, const float* mp, const float* mv,
                     const float* cpp, const float* cpv, const float* cvv) {
  const size_t o = static_cast<size_t>(t) * 5;
  std::memcpy(s.mp, mp + o, 5 * sizeof(float));
  std::memcpy(s.mv, mv + o, 5 * sizeof(float));
  std::memcpy(s.cpp, cpp + o, 5 * sizeof(float));
  std::memcpy(s.cpv, cpv + o, 5 * sizeof(float));
  std::memcpy(s.cvv, cvv + o, 5 * sizeof(float));
}

inline void store_row(const KfRow& s, int t, float* mp, float* mv, float* cpp,
                      float* cpv, float* cvv) {
  const size_t o = static_cast<size_t>(t) * 5;
  std::memcpy(mp + o, s.mp, 5 * sizeof(float));
  std::memcpy(mv + o, s.mv, 5 * sizeof(float));
  std::memcpy(cpp + o, s.cpp, 5 * sizeof(float));
  std::memcpy(cpv + o, s.cpv, 5 * sizeof(float));
  std::memcpy(cvv + o, s.cvv, 5 * sizeof(float));
}

}  // namespace similari_kf

#endif  // SIMILARI_NATIVE_KF_H_
