// Device functions shared by the fused SORT and VisualSORT frame kernels
// (fused_track.cu): block-wide reductions and scans, the box sanitizer, the
// aligned IoU weight, the per-row Kalman step, and the one-block forward
// auction of the VisualSORT kernel (the SORT kernel splits its auction
// over a cluster, fused_track.cu).
//
// Every helper runs on one thread block of NT threads (the block-wide
// reductions and the scan take another count, NTB, as a template
// argument: the SORT kernel's cluster blocks are smaller).  Ties always go to
// the lowest index, as in the reference (`similari_tpu/ops/pallas_sort.py`
// `_row_argmax`, `forward_auction`); no atomic decides a winner.
//
// The file is compiled with --fmad=false: each product and sum is rounded
// on its own, in the order written here, which is the order of the plain
// PyTorch versions (`similari_tpu_torch/ops/fused_sort.py`,
// `fused_visual.py`).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace ft {

constexpr int NT = 1024;        // threads per block
constexpr int NW = NT / 32;     // warps per block
constexpr float NEG = -1e30f;   // the reference's masked value
constexpr int MAX_AUCTION_ROUNDS = 3000;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }
__device__ __forceinline__ int warp_id() { return threadIdx.x >> 5; }

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// Block-wide max; every thread gets the result.  `red` holds NTB / 32
// floats.
template <int NTB = NT>
__device__ float block_max(float v, float* red) {
  v = warp_max(v);
  __syncthreads();
  if (lane_id() == 0) red[warp_id()] = v;
  __syncthreads();
  return warp_max(lane_id() < NTB / 32 ? red[lane_id()] : -INFINITY);
}

// In-place inclusive prefix sum of a[0..n) in shared memory.
// `red` holds NTB / 32 ints.
template <int NTB = NT>
__device__ void block_scan_inclusive(int* a, int n, int* red) {
  constexpr int NWB = NTB / 32;
  const int lane = lane_id(), w = warp_id();
  int carry = 0;
  for (int base = 0; base < n; base += NTB) {
    const int i = base + threadIdx.x;
    int v = i < n ? a[i] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      int y = __shfl_up_sync(FULL, v, o);
      if (lane >= o) v += y;
    }
    __syncthreads();
    if (lane == 31) red[w] = v;
    __syncthreads();
    if (w == 0) {
      int x = lane < NWB ? red[lane] : 0;
      for (int o = 1; o < 32; o <<= 1) {
        int y = __shfl_up_sync(FULL, x, o);
        if (lane >= o) x += y;
      }
      red[lane] = x;
    }
    __syncthreads();
    if (i < n) a[i] = v + carry + (w > 0 ? red[w - 1] : 0);
    carry += red[NWB - 1];
    __syncthreads();
  }
}

// First-max (value, index) merge across a warp, plus the largest value
// other than the chosen maximum.  Lanes hold (b1, i1, b2) over disjoint
// column sets.
__device__ __forceinline__ void warp_top2(float& b1, int& i1, float& b2) {
  for (int o = 16; o > 0; o >>= 1) {
    float ob1 = __shfl_xor_sync(FULL, b1, o);
    int oi1 = __shfl_xor_sync(FULL, i1, o);
    float ob2 = __shfl_xor_sync(FULL, b2, o);
    bool take = (ob1 > b1) || (ob1 == b1 && oi1 < i1);
    float nb2 = take ? fmaxf(b1, ob2) : fmaxf(ob1, b2);
    if (take) { b1 = ob1; i1 = oi1; }
    b2 = nb2;
  }
}

// First-max (value, index) across a warp.
__device__ __forceinline__ void warp_argmax(float& v, int& i) {
  for (int o = 16; o > 0; o >>= 1) {
    float ov = __shfl_xor_sync(FULL, v, o);
    int oi = __shfl_xor_sync(FULL, i, o);
    if (ov > v || (ov == v && oi < i)) { v = ov; i = oi; }
  }
}

// Padded rows may carry zero boxes; a zero height makes the Kalman update
// divide 0/0, so they become the unit box (0,0,0,1,1):
// box * valid + (1 - valid) * unit, as the reference writes it.
__device__ __forceinline__ float sanitize(float b, float vf, int j) {
  const float unit = j >= 3 ? 1.0f : 0.0f;
  return b * vf + (1.0f - vf) * unit;
}

// Squared noise std of component j: (k*weight * h)^2, or cnst^2 for the
// aspect component.  `kw` is k*weight, folded in double by the host.
__device__ __forceinline__ float var5(float kw, float cnst, float h, int j) {
  const float s = (j == 3) ? cnst : kw * h;
  return s * s;
}

struct KalmanWeights {
  float pw2;   // 2 * position_weight   (initial position std)
  float pw1;   // position_weight       (process and measurement std)
  float vw10;  // 10 * velocity_weight  (initial velocity std)
  float vw1;   // velocity_weight       (process std)
};

// One detection's Kalman step for component j of five: the matched track's
// filter (g_*, with g_mp4 / g_mv4 its height and height velocity) or a new
// filter initiated at z, then predict and update with z; zh is z's height.
struct KFRow { float mp, mv, cpp, cpv, cvv; };

__device__ __forceinline__ KFRow kf_step(
    const KalmanWeights& kw, bool matched, int j, float z, float zh,
    float g_mp, float g_mv, float g_cpp, float g_cpv, float g_cvv,
    float g_mp4, float g_mv4) {
  const float p_mp = matched ? g_mp : z;
  const float p_mv = matched ? g_mv : 0.0f;
  const float p_cpp = matched ? g_cpp : var5(kw.pw2, 1e-2f, zh, j);
  const float p_cpv = matched ? g_cpv : 0.0f;
  const float p_cvv = matched ? g_cvv : var5(kw.vw10, 1e-5f, zh, j);
  const float hh = matched ? g_mp4 : zh;               // p_mp[4]
  const float hv = matched ? g_mv4 : 0.0f;             // p_mv[4]
  // predict
  const float qp = var5(kw.pw1, 1e-2f, hh, j);
  const float qv = var5(kw.vw1, 1e-5f, hh, j);
  const float n_mp = p_mp + p_mv;
  const float n_cpp = p_cpp + 2.0f * p_cpv + p_cvv + qp;
  const float n_cpv = p_cpv + p_cvv;
  const float n_cvv = p_cvv + qv;
  // update
  const float r = var5(kw.pw1, 1e-1f, hh + hv, j);
  const float S = fmaxf(n_cpp + r, 1e-30f);  // degenerate-row guard
  const float nu = z - n_mp;
  const float gp = n_cpp / S;
  const float gvn = n_cpv / S;
  KFRow o;
  o.mp = n_mp + nu * gp;
  o.mv = p_mv + nu * gvn;
  o.cpp = n_cpp - n_cpp * gp;
  o.cpv = n_cpv - n_cpp * gvn;
  o.cvv = n_cvv - n_cpv * gvn;
  return o;
}

// Aligned IoU of detection box b (xc, yc, _, aspect, h) with predicted track
// box p, in the reference's operation order.  Returns inter via *inter.
__device__ __forceinline__ float aligned_iou(const float* b, const float* p,
                                             float* inter_out) {
  const float aw = b[3] * b[4];
  const float tw = p[3] * p[4];
  const float ix = fminf(b[0] + aw * 0.5f, p[0] + tw * 0.5f)
                 - fmaxf(b[0] - aw * 0.5f, p[0] - tw * 0.5f);
  const float iy = fminf(b[1] + b[4] * 0.5f, p[1] + p[4] * 0.5f)
                 - fmaxf(b[1] - b[4] * 0.5f, p[1] - p[4] * 0.5f);
  const float inter = (ix > 0.0f && iy > 0.0f) ? ix * iy : 0.0f;
  const float uni = aw * b[4] + tw * p[4] - inter;
  *inter_out = inter;
  return inter / (inter > 0.0f ? uni : 1.0f);
}

// Shared-memory working set of the auction.
struct AuctionSmem {
  float* prices;  // [D+T]
  int* c2r;       // [D+T]
  int* r2c;       // [D]
  float* bid;     // [D]
  int* jb;        // [D]
  int* win;       // [D]
};

// Jacobi forward auction on the augmented weights A[D, D+T]
// (replaces `similari_tpu/ops/pallas_sort.py::forward_auction`).
// A[r, j<D] = thr if j == r and row r is valid, else 0 (the new-track
// diagonal is never stored); A[r, D+t] = W[r*T + t] in global memory.
// Leaves r2c[r] = the column of row r (>= D: a track).  Padded rows start
// assigned.  Rows that are still unassigned bid on their first-max column;
// the highest bid wins a column, the lowest row among equal bids; outbid
// owners return to the pool.  At most 3000 rounds.
// Adds this call's rounds and bids to *rounds / *bids (thread 0).
__device__ void forward_auction(const float* __restrict__ W, int D, int T,
                                float thr, const int* rvalid, float eps,
                                AuctionSmem s, int* rounds, int* bids) {
  const int N = D + T;
  const int tid = threadIdx.x, lane = lane_id(), w = warp_id();
  for (int j = tid; j < N; j += NT) { s.prices[j] = 0.0f; s.c2r[j] = -1; }
  if (tid < D) s.r2c[tid] = rvalid[tid] ? -1 : 0;
  __syncthreads();
  int it = 0, nbids = 0;
  while (true) {
    const int pending = __syncthreads_count(tid < D && s.r2c[tid] < 0
                                            && rvalid[tid]);
    if (pending == 0 || it >= MAX_AUCTION_ROUNDS) break;
    nbids += pending;
    // bids: one warp per unassigned row
    for (int r = w; r < D; r += NW) {
      if (s.r2c[r] >= 0) continue;
      float b1 = -INFINITY, b2 = -INFINITY;
      int i1 = N;
      const bool rv = rvalid[r] != 0;
      const float* Wr = W + (size_t)r * T;
      for (int j = lane; j < N; j += 32) {
        const float a = j < D ? ((j == r && rv) ? thr : 0.0f) : Wr[j - D];
        const float v = a - s.prices[j];
        if (v > b1) { b2 = b1; b1 = v; i1 = j; }
        else if (v > b2) { b2 = v; }
      }
      warp_top2(b1, i1, b2);
      if (lane == 0) {
        s.bid[r] = s.prices[i1] + (b1 - b2) + eps;
        s.jb[r] = i1;
      }
    }
    __syncthreads();
    // winners: highest bid per column, lowest row on ties
    if (tid < D) {
      int won = 0;
      if (s.r2c[tid] < 0) {
        const int j = s.jb[tid];
        const float b = s.bid[tid];
        won = b > NEG * 0.5f;
        for (int q = 0; q < D && won; ++q) {
          if (q == tid || s.r2c[q] >= 0 || s.jb[q] != j) continue;
          const float bq = s.bid[q];
          if (bq > b || (bq == b && q < tid)) won = 0;
        }
      }
      s.win[tid] = won;
    }
    __syncthreads();
    // apply: evict the previous owner, take the column at the bid price
    if (tid < D && s.win[tid]) {
      const int j = s.jb[tid];
      const int old = s.c2r[j];
      if (old >= 0) s.r2c[old] = -1;
      s.c2r[j] = tid;
      s.prices[j] = s.bid[tid];
      s.r2c[tid] = j;
    }
    __syncthreads();
    ++it;
  }
  if (tid == 0) { *rounds += it; *bids += nbids; }
}

// Free-slot allocation shared by both kernels: the r-th new detection
// (in row order) takes the r-th free slot (in slot order).
// freef[T]: free flags (kept); frank[T]: scratch; flist[T] out: flist[k] =
// the k-th free slot.  nr[D]: is_new flags in, inclusive new ranks out.
// Returns (n_new, n_free) to every thread.
__device__ void allocate_slots(const int* freef, int* frank, int* flist,
                               int T, int* nr, int D, int* red, int* n_new,
                               int* n_free) {
  for (int t = threadIdx.x; t < T; t += NT) frank[t] = freef[t];
  __syncthreads();
  block_scan_inclusive(frank, T, red);
  block_scan_inclusive(nr, D, red);
  for (int t = threadIdx.x; t < T; t += NT)
    if (freef[t]) flist[frank[t] - 1] = t;
  __syncthreads();
  *n_free = frank[T - 1];
  *n_new = nr[D - 1];
}

// Slot of a detection: its matched track, else the free slot of its new
// rank (T-1 when there is none; such rows never write).
__device__ __forceinline__ int slot_of(bool matched, int tgt, int rank,
                                       const int* flist, int n_free, int T) {
  if (matched) return tgt;
  return (rank >= 1 && rank <= n_free) ? flist[rank - 1] : T - 1;
}

}  // namespace ft
