// Exact linear assignment solver (Hungarian / successive shortest paths),
// host C++: the port's copy of the JAX package's `native/lap.cpp`.
//
// The reference votes with the `pathfinding` crate's kuhn_munkres
// (`voting.rs:86`); this is the host-side exact equivalent.  The port uses
// it for `assignment="native"` (`ops/assignment.py`) and for the voting LP
// of the host engines (`trackers/host_sort.py`, `trackers/host_visual.py`),
// batched across scenes with a thread pool.
//
// Algorithm: potentials-based shortest augmenting path (e-maxx formulation),
// O(R^2 * C), rectangular R <= C, minimization.  Doubles internally for
// stable potentials on f32 inputs.  The code is the JAX package's line for
// line and builds with its flags (`_build.py::HOST_FLAGS`), so the two
// return the same columns, ties included.
//
// C ABI:
//   lap_solve(costs[R*C] row-major float, R, C, out_col[R] int32)  -> 0/err
//   lap_solve_batch_max(weights[B*R*C], B, R, C, out_col[B*R], n_threads)
//   Maximization wrappers negate internally.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <limits>
#include <thread>
#include <vector>

namespace {

constexpr double kInf = std::numeric_limits<double>::infinity();

// Minimize sum of costs over a perfect matching on rows. R <= C required.
int solve_min(const float* a, int R, int C, int32_t* row_to_col) {
  if (R <= 0) return 0;
  if (R > C) return 1;
  // 1-based arrays; p[j] = row matched to column j (0 = none)
  std::vector<double> u(R + 1, 0.0), v(C + 1, 0.0);
  std::vector<int> p(C + 1, 0), way(C + 1, 0);
  for (int i = 1; i <= R; ++i) {
    p[0] = i;
    int j0 = 0;
    std::vector<double> minv(C + 1, kInf);
    std::vector<char> used(C + 1, 0);
    do {
      used[j0] = 1;
      int i0 = p[j0], j1 = -1;
      double delta = kInf;
      const float* row = a + (static_cast<size_t>(i0) - 1) * C;
      for (int j = 1; j <= C; ++j) {
        if (used[j]) continue;
        double cur = static_cast<double>(row[j - 1]) - u[i0] - v[j];
        if (cur < minv[j]) {
          minv[j] = cur;
          way[j] = j0;
        }
        if (minv[j] < delta) {
          delta = minv[j];
          j1 = j;
        }
      }
      if (j1 < 0) return 2;  // infeasible (inf costs)
      for (int j = 0; j <= C; ++j) {
        if (used[j]) {
          u[p[j]] += delta;
          v[j] -= delta;
        } else {
          minv[j] -= delta;
        }
      }
      j0 = j1;
    } while (p[j0] != 0);
    do {
      int j1 = way[j0];
      p[j0] = p[j1];
      j0 = j1;
    } while (j0);
  }
  for (int j = 1; j <= C; ++j) {
    if (p[j] > 0) row_to_col[p[j] - 1] = j - 1;
  }
  return 0;
}

}  // namespace

extern "C" {

int lap_solve(const float* costs, int R, int C, int32_t* out_col) {
  return solve_min(costs, R, C, out_col);
}

int lap_solve_max(const float* weights, int R, int C, int32_t* out_col) {
  std::vector<float> neg(static_cast<size_t>(R) * C);
  for (size_t i = 0; i < neg.size(); ++i) neg[i] = -weights[i];
  return solve_min(neg.data(), R, C, out_col);
}

int lap_solve_batch_max(const float* weights, int B, int R, int C,
                        int32_t* out_col, int n_threads) {
  if (n_threads <= 0) {
    n_threads = static_cast<int>(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 1;
  }
  n_threads = std::min(n_threads, B);
  std::vector<int> errs(std::max(n_threads, 1), 0);
  auto work = [&](int t) {
    for (int b = t; b < B; b += n_threads) {
      int e = lap_solve_max(weights + static_cast<size_t>(b) * R * C, R, C,
                            out_col + static_cast<size_t>(b) * R);
      if (e) errs[t] = e;
    }
  };
  if (n_threads == 1) {
    work(0);
  } else {
    std::vector<std::thread> pool;
    pool.reserve(n_threads);
    for (int t = 0; t < n_threads; ++t) pool.emplace_back(work, t);
    for (auto& th : pool) th.join();
  }
  for (int e : errs)
    if (e) return e;
  return 0;
}

}  // extern "C"
