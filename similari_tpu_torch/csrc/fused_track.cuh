// Device functions shared by the fused SORT and VisualSORT frame kernels
// (fused_track.cu): block-wide reductions and scans, the box sanitizer, the
// aligned IoU weight, the per-row Kalman step, and the forward auction that
// both kernels split over their thread-block cluster (`cluster_auction`).
//
// The block-wide helpers take the block's thread count, NTB, as a template
// argument.  Ties always go to the lowest index, as in the reference
// (`similari_tpu/ops/pallas_sort.py` `_row_argmax`, `forward_auction`); no
// atomic decides a winner.
//
// The file is compiled with --fmad=false: each product and sum is rounded
// on its own, in the order written here, which is the order of the plain
// PyTorch versions (`similari_tpu_torch/ops/fused_sort.py`,
// `fused_visual.py`).
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace ft {

namespace cg = cooperative_groups;

constexpr int MAX_ROWS = 1024;  // detections per frame
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
template <int NTB>
__device__ float block_max(float v, float* red) {
  v = warp_max(v);
  __syncthreads();
  if (lane_id() == 0) red[warp_id()] = v;
  __syncthreads();
  return warp_max(lane_id() < NTB / 32 ? red[lane_id()] : -INFINITY);
}

// In-place inclusive prefix sum of a[0..n) in shared memory.
// `red` holds NTB / 32 ints.
template <int NTB>
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

// In-place inclusive prefix sum of a[0..n) in shared memory by one warp
// (every lane calls it), 32 items at a time with a carry: no block
// barrier, for the short row vectors.
__device__ __forceinline__ void warp_scan_inclusive(int* a, int n) {
  const int lane = lane_id();
  int carry = 0;
  for (int base = 0; base < n; base += 32) {
    const int i = base + lane;
    int v = i < n ? a[i] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, v, o);
      if (lane >= o) v += y;
    }
    if (i < n) a[i] = v + carry;
    carry += __shfl_sync(FULL, v, 31);
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

// Appends i to list[] (its count *n in shared memory) where `push`, with
// one shared-memory atomic per warp; every lane of the warp calls it.  The
// order within the list is arbitrary.
__device__ __forceinline__ void warp_push(bool push, int i, int* list,
                                          int* n) {
  const unsigned m = __ballot_sync(FULL, push);
  if (m == 0) return;  // uniform across the warp
  const int lane = lane_id(), leader = __ffs(m) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(n, __popc(m));
  base = __shfl_sync(FULL, base, leader);
  if (push) list[base + __popc(m & ((1u << lane) - 1u))] = i;
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

// A bid of round `round` as one 64-bit word whose unsigned order is the
// auction's within a round (the higher bid, then the lower row) and puts
// every round above the ones before it, so a column's key needs no reset
// between rounds: round + 1 in bits 52-63 (at most 3000 rounds), the
// float's bits made order-preserving in bits 20-51 (bids are > 0, never
// -0), the inverted row in bits 0-19 (D <= 1024).
__device__ __forceinline__ unsigned long long bid_key(int round, float bid,
                                                      int row) {
  const unsigned b = __float_as_uint(bid);
  const unsigned ord = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return ((unsigned long long)(round + 1) << 52)
       | ((unsigned long long)ord << 20) | (unsigned long long)(0xFFFFF - row);
}

// One block's working set of `cluster_auction`, in shared memory except
// the column arrays, which may lie in device memory.
struct ClusterAuction {
  int* r2c;  // [D] the column of each row (>= D: a track)
  int* jb;  // [D] the column each bidding row bids on
  float* bid;  // [D] the round's bid of each bidding row
  int* plist;  // [2, D] the bidding rows of this round and the next
  int* np;  // [2] their counts
  float4* part;  // [2, D] this block's (b1, i1, b2) of each bidding row
  float* prices;  // [D + T] every column's, alike in every block
  int* c2r;  // [D + T]
  unsigned long long* key;  // [D + T] the best (round, bid, row) so far
  int* wok;  // [nt] own track column: its owner row's weight passes thr
};

// Jacobi forward auction on the augmented weights A[D, D+T] over a
// cluster of G blocks of NTB threads (replaces
// `similari_tpu/ops/pallas_sort.py::forward_auction`).  A[r, j<D] = thr
// if j == r (only valid rows bid), else 0; A[r, D+t] = W[r, t].  Block g
// owns the diagonal columns [d0, d0 + nd) and the track columns
// tb + q*STRIDE (q < nt), whose weights it holds as Wl[D, nt]; every block
// keeps the rows' r2c and all columns' prices and owners, and updates them
// alike from the same data, so they need no exchange.  An auction round is
// one cluster barrier: each block scans its own columns for every bidding
// row (a few lanes per row) and publishes a (first max, column, runner-up)
// partial; after the barrier every block reads the G partials through
// distributed shared memory, merges them (ties to the lower column), and
// resolves every bid itself (a shared-memory atomicMax per column on
// `bid_key`): the highest bid wins a column, the lowest row among equal
// bids; outbid owners return to the pool.  Padded rows start assigned, at
// most 3000 rounds.  Leaves r2c[r] = the column of row r, wok[q] for each
// own track column its final owner's weight >= thr, and the rounds and
// bids in *rounds / *bids; adds its cluster barriers to *barriers.  Ends
// with a cluster barrier, after which any block may read another's wok.
template <int G, int NTB, int STRIDE>
__device__ void cluster_auction(cg::cluster_group& cluster,
                                const ClusterAuction& s, const float* Wl,
                                const int* valid, int D, int T, int d0,
                                int nd, int tb, int nt, float thr, float eps,
                                int* rounds_out, int* bids_out,
                                int* barriers) {
  constexpr int NWB = NTB / 32;
  const int N = D + T, tid = threadIdx.x, lane = lane_id(), w = warp_id();
  for (int j = tid; j < N; j += NTB) {
    s.prices[j] = 0.0f;
    s.c2r[j] = -1;
    s.key[j] = 0ull;
  }
  if (tid == 0) s.np[0] = 0;
  __syncthreads();
  for (int r0 = tid - lane; r0 < D; r0 += NTB) {  // warp by warp
    const int r = r0 + lane;
    if (r < D) s.r2c[r] = valid[r] ? -1 : 0;
    warp_push(r < D && valid[r], r, s.plist, &s.np[0]);
  }
  __syncthreads();
  // lanes per bidding row in the scan of own columns
  const int ncol = nd + nt;
  const int L = ncol > 256 ? 32 : ncol > 64 ? 16 : 8;
  const int sub = lane % L, grp = lane / L, gpw = 32 / L;
  int rounds = 0, bids = 0;
  while (true) {
    const int cur = rounds & 1, nxt = cur ^ 1;
    const int np = s.np[cur];
    if (np == 0 || rounds >= MAX_AUCTION_ROUNDS) break;
    bids += np;
    const int* pl = s.plist + cur * D;
    // this block's first max, its column and the runner-up of each
    // bidding row over its own columns, L lanes per row
    for (int k0 = w * gpw; k0 < np; k0 += NWB * gpw) {
      const int k = k0 + grp;
      const int r = k < np ? pl[k] : -1;
      float b1 = -INFINITY, b2 = -INFINITY;
      int i1 = N;
      if (r >= 0) {
        for (int q = sub; q < ncol; q += L) {
          float v;
          int j;
          if (q < nd) {
            j = d0 + q;
            v = (j == r ? thr : 0.0f) - s.prices[j];
          } else {
            const int t = q - nd;
            j = D + tb + t * STRIDE;
            v = Wl[r * nt + t] - s.prices[j];
          }
          if (v > b1) { b2 = b1; b1 = v; i1 = j; }
          else if (v > b2) { b2 = v; }
        }
      }
      for (int o = L / 2; o > 0; o >>= 1) {
        const float ob1 = __shfl_xor_sync(FULL, b1, o);
        const int oi1 = __shfl_xor_sync(FULL, i1, o);
        const float ob2 = __shfl_xor_sync(FULL, b2, o);
        const bool take = (ob1 > b1) || (ob1 == b1 && oi1 < i1);
        const float nb2 = take ? fmaxf(b1, ob2) : fmaxf(ob1, b2);
        if (take) { b1 = ob1; i1 = oi1; }
        b2 = nb2;
      }
      if (r >= 0 && sub == 0)
        s.part[cur * D + r] = make_float4(b1, __int_as_float(i1), b2, 0.0f);
    }
    cluster.sync();
    ++*barriers;
    // every block merges every bidding row's partials in block order and
    // keeps, per column, the best key of the round
    for (int k = tid; k < np; k += NTB) {
      const int r = pl[k];
      float4 p[G];
#pragma unroll
      for (int h = 0; h < G; ++h)
        p[h] = *cluster.map_shared_rank(&s.part[cur * D + r], h);
      float b1 = -INFINITY, b2 = -INFINITY;
      int i1 = N;
#pragma unroll
      for (int h = 0; h < G; ++h) {
        const int oi1 = __float_as_int(p[h].y);
        const bool take = (p[h].x > b1) || (p[h].x == b1 && oi1 < i1);
        const float nb2 = take ? fmaxf(b1, p[h].z) : fmaxf(p[h].x, b2);
        if (take) { b1 = p[h].x; i1 = oi1; }
        b2 = nb2;
      }
      const float bid = s.prices[i1] + (b1 - b2) + eps;
      s.jb[r] = i1;
      s.bid[r] = bid;
      if (bid > NEG * 0.5f) atomicMax(&s.key[i1], bid_key(rounds, bid, r));
    }
    if (tid == 0) s.np[nxt] = 0;
    __syncthreads();
    // winners take their columns at their bids; outbid owners and the
    // losers bid in the next round
    int* nl = s.plist + nxt * D;
    for (int k0 = tid - lane; k0 < np; k0 += NTB) {  // warp by warp
      const int k = k0 + lane;
      int push = -1;
      if (k < np) {
        const int r = pl[k], j = s.jb[r];
        const float bid = s.bid[r];
        if (bid > NEG * 0.5f && s.key[j] == bid_key(rounds, bid, r)) {
          const int old = s.c2r[j];
          if (old >= 0) {
            s.r2c[old] = -1;
            push = old;
          }
          s.c2r[j] = r;
          s.prices[j] = bid;
          s.r2c[r] = j;
          const int q = j - D - tb;
          if (q >= 0 && q % STRIDE == 0 && q / STRIDE < nt)
            s.wok[q / STRIDE] = Wl[r * nt + q / STRIDE] >= thr;
        } else {
          push = r;
        }
      }
      warp_push(push >= 0, push, nl, &s.np[nxt]);
    }
    __syncthreads();
    ++rounds;
  }
  // the owners' match flags are read across the cluster after this
  cluster.sync();
  ++*barriers;
  *rounds_out = rounds;
  *bids_out = bids;
}

}  // namespace ft
