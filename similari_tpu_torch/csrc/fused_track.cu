// Fused SORT and VisualSORT frame kernels for Hopper (sm_90a).
//
// fused_sort_kernel replaces `similari_tpu/ops/pallas_sort.py::_kernel`
// (with `forward_auction`, `_row_argmax`, `_cumsum_rows`);
// fused_visual_kernel replaces `similari_tpu/ops/pallas_visual.py::_kernel`
// (with `_col_argmax` and the same helpers), together with
// gallery_dots.cu, which computes its gallery product.
//
// Each launch runs C consecutive frames of one sequence on ONE thread block
// of 1024 threads: a loop over frames inside the kernel, __syncthreads()
// between phases, the tracker state read and written in place in device
// memory (it stays L2-resident: 4.2 MB at T=512, K=3, F=512), per-row and
// per-track vectors in shared memory, and the [D, T] matrices in global
// scratch buffers the wrapper allocates.  The TPU's one-hot matmul
// scatters and gathers become indexed loads and stores.  The frame loop is
// sequential (frame s matches against the gallery that frames < s left),
// so it stays on one block, one SM of 132.
//
// The gallery product leaves the loop.  The scan writes a gallery lane only
// by copying a candidate row of the chunk into it, so every lane a frame-s
// candidate meets holds its launch-start value or a chunk row of an earlier
// frame.  gallery_dots_kernel, launched on the same stream just before,
// computes every such dot product (and the rows' norms) on the whole card,
// bf16 on the tensor cores; the scan keeps a lane-source table src[T*K] in
// shared memory (lane -> column of that product, updated where a row
// enters a lane) and, for each gated (candidate, lane) pair, gathers the
// dot and both norms through it.
//
// Bound at the main-path shapes (D=128 after pad_pow2(100), T=512, K=3,
// F=512): the state moves about 8.4 MB per launch (read + write), 1.3 us
// each way at 3.35 TB/s, and the ~30,000 gated pairs per frame are L2
// gathers.  Neither is the limit: the single block's serial phases are.
// On an H100 (PERF.md section 5, from the `prof` phase stamps) a frame
// takes ~0.22 ms: the [D, T] votes, positional and argmax passes ~60%,
// the auction rounds (each a few block barriers) ~15%, the state write
// ~12%, the gallery gather ~10%; the product adds ~0.06 ms per chunk.
// What the design does about it: unassigned rows only are re-scanned each
// auction round; gallery pairs are listed once per frame from compacted
// (candidate, lane) lists; nothing leaves the block between phases except
// through L2.  Shared-memory staging of the state and a cluster for the
// [D, T] passes are left for later.
//
// Ids must match the reference exactly: ties go to the lowest index
// everywhere, the r-th new detection takes the r-th free slot, and on
// overflow (n_new > n_free) the frame writes nothing while next_id still
// advances.

#include <cuda_runtime.h>

#include "fused_track.cuh"

using namespace ft;

namespace {

constexpr int MAX_CONSTRAINTS = 8;
constexpr int MAX_SMEM = 232448;  // bytes a block may use on sm_90

struct Carve {
  char* base;
  size_t off = 0;
  __host__ __device__ explicit Carve(char* b) : base(b) {}
  template <class X>
  __host__ __device__ X* take(size_t n) {
    off = (off + 15) & ~size_t(15);
    X* p = reinterpret_cast<X*>(base + off);
    off += n * sizeof(X);
    return p;
  }
};

// ----------------------------------------------------------------------------
// SORT
// ----------------------------------------------------------------------------

struct SortArgs {
  const float* box;  // [C, D, 5]
  const float* conf;  // [C, D]
  const int* valid;  // [C, D]
  float *mp, *mv, *cpp, *cpv, *cvv, *pred, *obs;  // [T, 5] state
  float* tconf;  // [T]
  int *active, *last, *length, *tid, *nid;  // [T], nid [1]
  int *o_ids, *o_slots;  // [C, D]
  float* o_pred;  // [C, D, 5]
  int* o_ovf;  // [C]
  int* o_stats;  // [C, 3] auction rounds, bids, gallery pairs
  float* W;  // [D, T] scratch
  int C, D, T, epoch0, max_idle, recycle;
  float thr, min_conf;
  KalmanWeights kw;
};

struct SortSmem {
  float *box, *conf;
  int *valid, *matched, *tgt, *nr, *slot;
  int *act, *compat, *freef, *frank, *flist;
  float* redf;
  int* redi;
  AuctionSmem a;
  __host__ __device__ size_t carve(char* base, int D, int T) {
    Carve c(base);
    box = c.take<float>(5 * D);
    conf = c.take<float>(D);
    valid = c.take<int>(D);
    matched = c.take<int>(D);
    tgt = c.take<int>(D);
    nr = c.take<int>(D);
    slot = c.take<int>(D);
    act = c.take<int>(T);
    compat = c.take<int>(T);
    freef = c.take<int>(T);
    frank = c.take<int>(T);
    flist = c.take<int>(T);
    redf = c.take<float>(NW);
    redi = c.take<int>(NW);
    a.prices = c.take<float>(D + T);
    a.c2r = c.take<int>(D + T);
    a.r2c = c.take<int>(D);
    a.bid = c.take<float>(D);
    a.jb = c.take<int>(D);
    a.win = c.take<int>(D);
    return c.off;
  }
};

// max of the augmented matrix's diagonal block as seen by one thread
__device__ __forceinline__ float diag_max(int tid, int D, const int* valid,
                                          float thr) {
  if (tid < D) return valid[tid] ? (D >= 2 ? fmaxf(thr, 0.0f) : thr) : 0.0f;
  return D >= 2 ? 0.0f : -INFINITY;
}

// Kalman step of one detection against its slot's stored filter (matched)
// or a new filter at z.  A is SortArgs or VisualArgs (same state columns).
template <class A>
__device__ void kalman_rows(const A& a, bool matched, int sl, const float* z,
                            KFRow* u) {
  for (int j = 0; j < 5; ++j)
    u[j] = kf_step(a.kw, matched, j, z[j], z[4], a.mp[sl * 5 + j],
                   a.mv[sl * 5 + j], a.cpp[sl * 5 + j], a.cpv[sl * 5 + j],
                   a.cvv[sl * 5 + j], a.mp[sl * 5 + 4], a.mv[sl * 5 + 4]);
}

// Writes the SORT columns of one updated slot.
template <class A>
__device__ void write_sort_columns(const A& a, int sl, const KFRow* u,
                                   const float* z, float conf, int epoch,
                                   int new_len, int new_id) {
  for (int j = 0; j < 5; ++j) {
    a.mp[sl * 5 + j] = u[j].mp;
    a.mv[sl * 5 + j] = u[j].mv;
    a.cpp[sl * 5 + j] = u[j].cpp;
    a.cpv[sl * 5 + j] = u[j].cpv;
    a.cvv[sl * 5 + j] = u[j].cvv;
    a.pred[sl * 5 + j] = u[j].mp;
    a.obs[sl * 5 + j] = z[j];
  }
  a.tconf[sl] = conf;
  a.active[sl] = 1;
  a.last[sl] = epoch;
  a.length[sl] = new_len;
  a.tid[sl] = new_id;
}

__global__ void __launch_bounds__(NT, 1) fused_sort_kernel(SortArgs a) {
  extern __shared__ __align__(16) char smem[];
  SortSmem sm;
  sm.carve(smem, a.D, a.T);
  const int D = a.D, T = a.T, tid = threadIdx.x;
  for (int s = 0; s < a.C; ++s) {
    const int epoch = a.epoch0 + s;
    const int nid0 = *a.nid;
    // ---- rows and tracks ------------------------------------------------
    if (tid < D) {
      const int v = a.valid[s * D + tid] > 0;
      const float vf = v ? 1.0f : 0.0f;
      for (int j = 0; j < 5; ++j)
        sm.box[tid * 5 + j] = sanitize(a.box[(s * D + tid) * 5 + j], vf, j);
      sm.conf[tid] = a.conf[s * D + tid];
      sm.valid[tid] = v;
    }
    for (int t = tid; t < T; t += NT) {
      const int act0 = a.active[t] > 0;
      const int comp = act0 && (epoch - a.last[t]) <= a.max_idle;
      const int act = a.recycle ? comp : act0;
      sm.act[t] = act;
      sm.compat[t] = comp;
      sm.freef[t] = !act;
    }
    __syncthreads();
    // ---- weights: aligned IoU x confidence, gated -----------------------
    float lmax = diag_max(tid, D, sm.valid, a.thr);
    for (int idx = tid; idx < D * T; idx += NT) {
      const int r = idx / T, t = idx - r * T;
      float inter;
      const float iou = aligned_iou(&sm.box[r * 5], &a.pred[t * 5], &inter);
      const float m = iou * fmaxf(sm.conf[r], a.min_conf);
      const float w = (sm.compat[t] && inter > 0.0f && m >= a.thr) ? m : 0.0f;
      a.W[idx] = w;
      lmax = fmaxf(lmax, w);
    }
    const float span = fmaxf(block_max(lmax, sm.redf), 1e-6f);
    const float eps = span / (float)fmax(4096.0, 64.0 * D);
    int rounds = 0, bids = 0;
    forward_auction(a.W, D, T, a.thr, sm.valid, eps, sm.a, &rounds, &bids);
    // ---- match --------------------------------------------------------
    if (tid < D) {
      const int c = sm.a.r2c[tid];
      const int tg = min(max(c - D, 0), T - 1);
      const bool m = sm.valid[tid] && c >= D && a.W[tid * T + tg] >= a.thr;
      sm.matched[tid] = m;
      sm.tgt[tid] = tg;
      sm.nr[tid] = sm.valid[tid] && !m;
    }
    __syncthreads();
    int n_new, n_free;
    allocate_slots(sm.freef, sm.frank, sm.flist, T, sm.nr, D, sm.redi,
                   &n_new, &n_free);
    const bool ovf = n_new > n_free;
    // ---- Kalman step, ids, outputs (reads state at the slot) -----------
    KFRow u[5];
    int sl = 0, new_len = 0, new_id = 0;
    if (tid < D) {
      const bool m = sm.matched[tid];
      sl = slot_of(m, sm.tgt[tid], sm.nr[tid], sm.flist, n_free, T);
      kalman_rows(a, m, sl, &sm.box[tid * 5], u);
      new_len = m ? a.length[sl] + 1 : 1;
      new_id = m ? a.tid[sl] : nid0 + sm.nr[tid];
      a.o_ids[s * D + tid] = new_id;
      a.o_slots[s * D + tid] = sl;
      for (int j = 0; j < 5; ++j) a.o_pred[(s * D + tid) * 5 + j] = u[j].mp;
    }
    __syncthreads();
    // ---- state write (dropped on overflow) ------------------------------
    if (a.recycle)
      for (int t = tid; t < T; t += NT) a.active[t] = sm.act[t];
    __syncthreads();
    if (tid < D && sm.valid[tid] && !ovf) {
      write_sort_columns(a, sl, u, &sm.box[tid * 5], sm.conf[tid], epoch,
                         new_len, new_id);
    }
    __syncthreads();
    if (tid == 0) {
      *a.nid = nid0 + n_new;
      a.o_ovf[s] = ovf;
      a.o_stats[s * 3 + 0] = rounds;
      a.o_stats[s * 3 + 1] = bids;
      a.o_stats[s * 3 + 2] = 0;
    }
    __syncthreads();
  }
}

// ----------------------------------------------------------------------------
// VisualSORT
// ----------------------------------------------------------------------------

struct VisualArgs {
  const float *box, *conf;  // [C, D, 5], [C, D]
  const int* valid;  // [C, D]
  const float* feat;  // [C, D, F]
  const int* fvalid;  // [C, D]
  const float *qual, *oa;  // [C, D]
  float *mp, *mv, *cpp, *cpv, *cvv, *pred, *obs;  // [T, 5]
  float* tconf;  // [T]
  int *active, *last, *length, *tid;  // [T]
  float* gf;  // [T, K, F] gallery
  float* gq;  // [T, K]
  int* gv;  // [T, K]
  int *coll, *vt;  // [T]
  float* lastf;  // [T, F]
  int *lastfv, *nid;  // [T], [1]
  int *o_ids, *o_slots;  // [C, D]
  float* o_pred;  // [C, D, 5]
  int *o_vt, *o_new, *o_len, *o_ovf, *o_stats;  // [C, D] x3, [C], [C, 3]
  float* P;  // [D, T] positional weights (then the masked remainder)
  unsigned char* cdt;  // [D, T] compatibility incl. constraints
  float* wd;  // [K, D, T] gallery distances (gated pairs only)
  unsigned char* okb;  // [K, D, T] metric passed (gated pairs only)
  float* Wm;  // [D, T] best-fit weights
  const float* dots;  // [C*D, T*K + C*D] gallery_dots.cu's products
  const float* norms;  // [T*K + C*D] their rows' sums of squares
  long long* prof;  // [C, NSTAMP] phase stamps, or null
  int C, D, T, K, F, epoch0, max_idle, recycle, min_track_len, min_votes;
  int maha, euclid, n_cons;
  float thr, pos_min_conf, vis_thr, min_area, q_use, q_collect, oa_use,
      oa_collect;
  KalmanWeights kw;
  int cons_dd[MAX_CONSTRAINTS];  // ascending
  float cons_md[MAX_CONSTRAINTS];
};

struct VisualSmem {
  float *box, *conf, *qual, *oa, *qn, *rdet;
  int *valid, *featok, *use, *collect, *lr, *t1, *hasany, *wins, *tgt, *vt;
  int *rowopen, *matched, *nr, *newlane, *slot;
  int *act, *compat, *freef, *frank, *flist, *tg, *gvbits, *bestq, *claimed;
  float* rtrk;
  int* lt;  // [K, T]
  float* gn;  // [K, T]
  int* src;  // [T*K] lane -> column of `dots` holding its value
  float* redf;
  int* redi;
  int* counts;  // [1 + K]: rows listed, tracks listed per plane
  int* npairs;  // [1]
  AuctionSmem a;
  __host__ __device__ size_t carve(char* base, int D, int T, int K) {
    Carve c(base);
    box = c.take<float>(5 * D);
    conf = c.take<float>(D);
    qual = c.take<float>(D);
    oa = c.take<float>(D);
    qn = c.take<float>(D);
    rdet = c.take<float>(D);
    valid = c.take<int>(D);
    featok = c.take<int>(D);
    use = c.take<int>(D);
    collect = c.take<int>(D);
    lr = c.take<int>(D);
    t1 = c.take<int>(D);
    hasany = c.take<int>(D);
    wins = c.take<int>(D);
    tgt = c.take<int>(D);
    vt = c.take<int>(D);
    rowopen = c.take<int>(D);
    matched = c.take<int>(D);
    nr = c.take<int>(D);
    newlane = c.take<int>(D);
    slot = c.take<int>(D);
    act = c.take<int>(T);
    compat = c.take<int>(T);
    freef = c.take<int>(T);
    frank = c.take<int>(T);
    flist = c.take<int>(T);
    tg = c.take<int>(T);
    gvbits = c.take<int>(T);
    bestq = c.take<int>(T);
    claimed = c.take<int>(T);
    rtrk = c.take<float>(T);
    lt = c.take<int>((size_t)K * T);
    gn = c.take<float>((size_t)K * T);
    src = c.take<int>((size_t)T * K);
    redf = c.take<float>(NW);
    redi = c.take<int>(NW);
    counts = c.take<int>(1 + K);
    npairs = c.take<int>(1);
    a.prices = c.take<float>(D + T);
    a.c2r = c.take<int>(D + T);
    a.r2c = c.take<int>(D);
    a.bid = c.take<float>(D);
    a.jb = c.take<int>(D);
    a.win = c.take<int>(D);
    return c.off;
  }
};

// Phase boundaries of a VisualSORT frame, stamped from %globaltimer (ns)
// into VisualArgs::prof[s * NSTAMP + k] when prof is not null.  A stamp
// first waits for the whole block, so a profiled launch runs each phase
// on its own; an unprofiled launch (prof null) runs no extra barrier.
enum {
  ST_START, ST_ROWS, ST_LISTS, ST_POS, ST_NORMS, ST_DIST, ST_VOTES,
  ST_ARGMAX, ST_AUCTION, ST_SLOTS, ST_WRITE, NSTAMP
};

__device__ __forceinline__ void stamp(long long* prof, int s, int k) {
  if (prof == nullptr) return;  // uniform across the block
  __syncthreads();
  if (threadIdx.x == 0) {
    long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    prof[s * NSTAMP + k] = t;
  }
}

// One warp lists the indices i < n with flag(i) in ascending order.
template <class Flag>
__device__ void warp_compact(int n, Flag flag, int* out, int* count) {
  const int lane = lane_id();
  int total = 0;
  for (int base = 0; base < n; base += 32) {
    const int i = base + lane;
    const bool f = i < n && flag(i);
    const unsigned m = __ballot_sync(FULL, f);
    if (f) out[total + __popc(m & ((1u << lane) - 1u))] = i;
    total += __popc(m);
  }
  if (lane == 0) *count = total;
}

__global__ void __launch_bounds__(NT, 1) fused_visual_kernel(VisualArgs a) {
  extern __shared__ __align__(16) char smem[];
  VisualSmem sm;
  sm.carve(smem, a.D, a.T, a.K);
  const int D = a.D, T = a.T, K = a.K, F = a.F, TK = T * K;
  const size_t W = (size_t)TK + (size_t)a.C * D;  // columns of a.dots
  const int tid = threadIdx.x, lane = lane_id(), w = warp_id();
  // every lane starts as its launch-start value, column t*K + i
  for (int j = tid; j < TK; j += NT) sm.src[j] = j;
  __syncthreads();
  for (int s = 0; s < a.C; ++s) {
    const int epoch = a.epoch0 + s;
    const int nid0 = *a.nid;
    const float* feat = a.feat + (size_t)s * D * F;
    stamp(a.prof, s, ST_START);
    // ---- rows: sanitized boxes, candidate feature gates ----------------
    if (tid < D) {
      const int i = s * D + tid;
      const int v = a.valid[i] > 0;
      const float vf = v ? 1.0f : 0.0f;
      float b[5];
      for (int j = 0; j < 5; ++j) {
        b[j] = sanitize(a.box[i * 5 + j], vf, j);
        sm.box[tid * 5 + j] = b[j];
      }
      const int fok = a.fvalid[i] > 0;
      const float q = a.qual[i], o = a.oa[i];
      const bool area_ok = b[3] * b[4] * b[4] >= a.min_area;
      sm.conf[tid] = a.conf[i];
      sm.valid[tid] = v;
      sm.featok[tid] = fok;
      sm.qual[tid] = q;
      sm.oa[tid] = o;
      sm.use[tid] = fok && v && q >= a.q_use && o >= a.oa_use && area_ok;
      sm.collect[tid] = fok && q >= a.q_collect && o >= a.oa_collect && area_ok;
      const float hw = b[3] * b[4] * 0.5f, hh = b[4] * 0.5f;
      sm.rdet[tid] = sqrtf(hw * hw + hh * hh);
    }
    // ---- tracks ---------------------------------------------------------
    for (int t = tid; t < T; t += NT) {
      const int act0 = a.active[t] > 0;
      const int comp = act0 && (epoch - a.last[t]) <= a.max_idle;
      const int act = a.recycle ? comp : act0;
      sm.act[t] = act;
      sm.compat[t] = comp;
      sm.freef[t] = !act;
      sm.tg[t] = a.coll[t] >= a.min_track_len;
      int bits = 0;
      for (int i = 0; i < K; ++i) bits |= (a.gv[t * K + i] > 0) << i;
      sm.gvbits[t] = bits;
      sm.claimed[t] = 0;
      const float* p = &a.pred[t * 5];
      const float hw = p[3] * p[4] * 0.5f, hh = p[4] * 0.5f;
      sm.rtrk[t] = sqrtf(hw * hw + hh * hh);
    }
    if (tid == 0) *sm.npairs = 0;
    __syncthreads();
    stamp(a.prof, s, ST_ROWS);
    // ---- candidate / gallery-lane lists --------------------------------
    if (w == 0) {
      warp_compact(D, [&](int r) { return sm.use[r] != 0; }, sm.lr,
                   &sm.counts[0]);
    } else if (w <= K) {
      const int i = w - 1;
      warp_compact(T, [&](int t) {
        return sm.tg[t] && ((sm.gvbits[t] >> i) & 1) && sm.compat[t];
      }, sm.lt + i * T, &sm.counts[1 + i]);
    }
    stamp(a.prof, s, ST_LISTS);
    // ---- positional weights + compatibility with constraints -----------
    for (int idx = tid; idx < D * T; idx += NT) {
      const int r = idx / T, t = idx - r * T;
      const float* b = &sm.box[r * 5];
      const float* p = &a.pred[t * 5];
      const float dx = b[0] - p[0], dy = b[1] - p[1];
      const float cd2 = dx * dx + dy * dy;
      const float rsum = sm.rdet[r] + sm.rtrk[t];
      bool cd = sm.compat[t] != 0;
      if (a.n_cons > 0) {
        const int delta = epoch - a.last[t];
        float allowed = 3.0e38f;
        for (int c = 0; c < a.n_cons; ++c)
          if (delta <= a.cons_dd[c]) { allowed = a.cons_md[c]; break; }
        const float d2r = sqrtf(cd2) / sqrtf(rsum * rsum + 1e-5f);
        cd = cd && d2r <= allowed;
      }
      a.cdt[idx] = cd;
      const float cc = fmaxf(sm.conf[r], a.pos_min_conf);
      float m;
      bool pv;
      if (!a.maha) {
        float inter;
        m = aligned_iou(b, p, &inter) * cc;
        pv = cd && inter > 0.0f && m >= a.thr;
      } else {
        // Mahalanobis vs the stored KF state, chi2-gated and inverted
        const float* mt = &a.mp[t * 5];
        const float* ct = &a.cpp[t * 5];
        float d2 = 0.0f;
        for (int k = 0; k < 5; ++k) {
          const float rk = k == 3 ? 0.1f : a.kw.pw1 * mt[4];
          const float S = fmaxf(ct[k] + rk * rk, 1e-30f);
          const float nu = b[k] - mt[k];
          d2 = d2 + nu * nu / S;
        }
        const float cost = d2 > 11.070f ? 0.0f : 100.0f - d2;
        m = cost / cc;
        pv = cd && !(cd2 > rsum * rsum);
      }
      a.P[idx] = pv ? m : 0.0f;
    }
    __syncthreads();
    stamp(a.prof, s, ST_POS);
    const int nlr = sm.counts[0];
    // ---- norms of this frame's rows and of the listed lanes -------------
    if (tid < D) sm.qn[tid] = a.norms[TK + s * D + tid];
    for (int i = 0; i < K; ++i) {
      const int nt = sm.counts[1 + i];
      for (int k = tid; k < nt; k += NT) {
        const int t = sm.lt[i * T + k];
        sm.gn[i * T + t] = a.norms[sm.src[t * K + i]];
      }
    }
    __syncthreads();
    stamp(a.prof, s, ST_NORMS);
    // ---- gallery distances on the gated (candidate, lane) pairs --------
    // (the dot of row r and lane (t, i) is dots[s*D + r, src[t*K + i]])
    const float* drow = a.dots + (size_t)s * D * W;
    float lmax = NEG;
    int npairs = 0;
    for (int i = 0; i < K; ++i) {
      const int nt = sm.counts[1 + i];
      const int* Lt = sm.lt + i * T;
      for (int idx = tid; idx < nlr * nt; idx += NT) {
        const int k = idx / nt;
        const int r = sm.lr[k], t = Lt[idx - k * nt];
        if (!a.cdt[r * T + t]) continue;
        const float acc = drow[(size_t)r * W + sm.src[t * K + i]];
        const float qn = sm.qn[r], gn = sm.gn[i * T + t];
        float wv;
        bool ok;
        if (a.euclid) {
          wv = sqrtf(fmaxf(qn + gn - 2.0f * acc, 0.0f));
          ok = wv <= a.vis_thr;
        } else {
          const float den = sqrtf(qn) * sqrtf(gn);
          const float sim = acc / (den > 0.0f ? den : 1.0f);
          ok = sim >= a.vis_thr;
          wv = 1.0f - sim;
        }
        const size_t o = ((size_t)i * D + r) * T + t;
        a.wd[o] = wv;
        a.okb[o] = ok;
        if (ok) lmax = fmaxf(lmax, wv);
        ++npairs;
      }
    }
    if (npairs) atomicAdd(sm.npairs, npairs);
    const float max_dist = block_max(lmax, sm.redf);
    stamp(a.prof, s, ST_DIST);
    // ---- votes and best-fit weights -------------------------------------
    for (int idx = tid; idx < D * T; idx += NT) {
      const int r = idx / T, t = idx - r * T;
      int votes = 0;
      float weight = 0.0f;
      if (sm.use[r] && a.cdt[idx] && sm.tg[t]) {
        for (int i = 0; i < K; ++i) {
          const size_t o = ((size_t)i * D + r) * T + t;
          if (((sm.gvbits[t] >> i) & 1) && a.okb[o]) {
            ++votes;
            weight = weight + (max_dist - a.wd[o]);
          }
        }
      }
      a.Wm[idx] = (votes >= a.min_votes && sm.valid[r]) ? weight : NEG;
    }
    __syncthreads();
    stamp(a.prof, s, ST_VOTES);
    // best track per candidate (first max) and heaviest candidate per track
    for (int r = w; r < D; r += NW) {
      float v = -INFINITY;
      int ix = T;
      for (int t = lane; t < T; t += 32) {
        const float x = a.Wm[r * T + t];
        if (x > v) { v = x; ix = t; }
      }
      warp_argmax(v, ix);
      if (lane == 0) { sm.t1[r] = ix; sm.hasany[r] = v > NEG; }
    }
    for (int t = tid; t < T; t += NT) {
      float v = a.Wm[t];
      int ix = 0;
      for (int r = 1; r < D; ++r) {
        const float x = a.Wm[r * T + t];
        if (x > v) { v = x; ix = r; }
      }
      sm.bestq[t] = ix;
    }
    __syncthreads();
    if (tid < D) {
      const bool win = sm.hasany[tid] && sm.bestq[sm.t1[tid]] == tid;
      sm.wins[tid] = win;
      if (win) sm.claimed[sm.t1[tid]] = 1;
      sm.rowopen[tid] = sm.valid[tid] && !sm.hasany[tid];
    }
    __syncthreads();
    stamp(a.prof, s, ST_ARGMAX);
    // ---- positional auction on the remainder ----------------------------
    lmax = diag_max(tid, D, sm.valid, a.thr);
    for (int idx = tid; idx < D * T; idx += NT) {
      const int r = idx / T, t = idx - r * T;
      const float pm = (sm.rowopen[r] && sm.act[t] && !sm.claimed[t])
                           ? a.P[idx] : 0.0f;
      a.P[idx] = pm;
      lmax = fmaxf(lmax, pm);
    }
    const float span = fmaxf(block_max(lmax, sm.redf), 1e-6f);
    const float eps = span / (float)fmax(4096.0, 64.0 * D);
    int rounds = 0, bids = 0;
    forward_auction(a.P, D, T, a.thr, sm.valid, eps, sm.a, &rounds, &bids);
    if (tid < D) {
      const int c = sm.a.r2c[tid];
      const int ptgt = min(max(c - D, 0), T - 1);
      const bool pos = sm.rowopen[tid] && c >= D && a.P[tid * T + ptgt] >= a.thr;
      const bool win = sm.wins[tid];
      const bool m = win || pos;
      sm.matched[tid] = m;
      sm.tgt[tid] = win ? sm.t1[tid] : ptgt;
      sm.vt[tid] = win ? 0 : 1;
      sm.nr[tid] = sm.valid[tid] && !m;
    }
    __syncthreads();
    stamp(a.prof, s, ST_AUCTION);
    int n_new, n_free;
    allocate_slots(sm.freef, sm.frank, sm.flist, T, sm.nr, D, sm.redi,
                   &n_new, &n_free);
    const bool ovf = n_new > n_free;
    // ---- Kalman step, ids, gallery bookkeeping (reads state at slot) ----
    KFRow u[5];
    int sl = 0, new_len = 0, new_id = 0, finalv = 0, collected = 0;
    if (tid < D) {
      const bool m = sm.matched[tid];
      const bool is_new = sm.valid[tid] && !m;
      sl = slot_of(m, sm.tgt[tid], sm.nr[tid], sm.flist, n_free, T);
      sm.slot[tid] = sl;
      kalman_rows(a, m, sl, &sm.box[tid * 5], u);
      new_len = m ? a.length[sl] + 1 : 1;
      new_id = m ? a.tid[sl] : nid0 + sm.nr[tid];
      // live lanes of the target row, quality-sorted eviction
      int galv = 0;
      if (m)
        for (int i = 0; i < K; ++i) galv |= (a.gv[sl * K + i] > 0) << i;
      const int n_f = __popc(galv);
      float minq = 3.0e38f;
      for (int i = 0; i < K; ++i)
        if ((galv >> i) & 1) minq = fminf(minq, a.gq[sl * K + i]);
      int evict_k = K;
      for (int i = K - 1; i >= 0; --i)
        if (((galv >> i) & 1) && a.gq[sl * K + i] <= minq) evict_k = i;
      if (n_f >= K && evict_k < K) galv &= ~(1 << evict_k);
      // a brand-new track's first feature bypasses the collect gate
      const bool keep_new = sm.featok[tid] && (is_new || sm.collect[tid]);
      int free_k = 0;
      for (int i = K - 1; i >= 0; --i)
        if (!((galv >> i) & 1)) free_k = i;
      const int nl = keep_new ? (1 << free_k) : 0;
      finalv = galv | nl;
      collected = __popc(finalv);
      sm.newlane[tid] = nl;
      a.o_ids[s * D + tid] = new_id;
      a.o_slots[s * D + tid] = sl;
      a.o_vt[s * D + tid] = sm.vt[tid];
      a.o_new[s * D + tid] = is_new;
      a.o_len[s * D + tid] = new_len;
      for (int j = 0; j < 5; ++j) a.o_pred[(s * D + tid) * 5 + j] = u[j].mp;
    }
    __syncthreads();
    stamp(a.prof, s, ST_SLOTS);
    // ---- state write (dropped on overflow) ------------------------------
    if (a.recycle)
      for (int t = tid; t < T; t += NT) a.active[t] = sm.act[t];
    __syncthreads();
    if (tid < D && sm.valid[tid] && !ovf) {
      write_sort_columns(a, sl, u, &sm.box[tid * 5], sm.conf[tid], epoch,
                         new_len, new_id);
      const int nl = sm.newlane[tid];
      for (int i = 0; i < K; ++i) {
        // quality and validity of every lane are rewritten for the slot;
        // the lane this row enters now holds chunk row s*D + tid
        if ((nl >> i) & 1) {
          a.gq[sl * K + i] = sm.qual[tid];
          sm.src[sl * K + i] = TK + s * D + tid;
        }
        a.gv[sl * K + i] = (finalv >> i) & 1;
      }
      a.coll[sl] = collected;
      a.vt[sl] = sm.vt[tid];
      a.lastfv[sl] = sm.featok[tid];
    }
    // feature rows: the newest feature, and the gallery lane it enters
    for (int r = w; r < D; r += NW) {
      if (!sm.valid[r] || ovf) continue;
      const int slr = sm.slot[r], nl = sm.newlane[r];
      const float* q = feat + (size_t)r * F;
      for (int f = lane; f < F; f += 32) {
        const float x = q[f];
        a.lastf[(size_t)slr * F + f] = x;
        for (int i = 0; i < K; ++i)
          if ((nl >> i) & 1) a.gf[((size_t)slr * K + i) * F + f] = x;
      }
    }
    __syncthreads();
    if (tid == 0) {
      *a.nid = nid0 + n_new;
      a.o_ovf[s] = ovf;
      a.o_stats[s * 3 + 0] = rounds;
      a.o_stats[s * 3 + 1] = bids;
      a.o_stats[s * 3 + 2] = *sm.npairs;
    }
    __syncthreads();
    stamp(a.prof, s, ST_WRITE);
  }
}

}  // namespace

// ----------------------------------------------------------------------------
// C interface (loaded with ctypes)
// ----------------------------------------------------------------------------

extern "C" int fused_sort_launch(
    const void* box, const void* conf, const void* valid,
    void* mp, void* mv, void* cpp, void* cpv, void* cvv, void* pred, void* obs,
    void* tconf, void* active, void* last, void* length, void* tid, void* nid,
    void* o_ids, void* o_slots, void* o_pred, void* o_ovf, void* o_stats,
    void* W,
    int C, int D, int T, int epoch0, int max_idle, int recycle,
    float thr, float min_conf, float pw2, float pw1, float vw10, float vw1,
    void* stream) {
  if (D < 1 || D > NT || T < 1 || C < 1) return (int)cudaErrorInvalidValue;
  SortSmem probe;
  const size_t bytes = probe.carve(nullptr, D, T);
  if (bytes > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      fused_sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (e != cudaSuccess) return (int)e;
  SortArgs a;
  a.box = (const float*)box; a.conf = (const float*)conf;
  a.valid = (const int*)valid;
  a.mp = (float*)mp; a.mv = (float*)mv; a.cpp = (float*)cpp;
  a.cpv = (float*)cpv; a.cvv = (float*)cvv; a.pred = (float*)pred;
  a.obs = (float*)obs; a.tconf = (float*)tconf;
  a.active = (int*)active; a.last = (int*)last; a.length = (int*)length;
  a.tid = (int*)tid; a.nid = (int*)nid;
  a.o_ids = (int*)o_ids; a.o_slots = (int*)o_slots;
  a.o_pred = (float*)o_pred; a.o_ovf = (int*)o_ovf;
  a.o_stats = (int*)o_stats; a.W = (float*)W;
  a.C = C; a.D = D; a.T = T; a.epoch0 = epoch0; a.max_idle = max_idle;
  a.recycle = recycle; a.thr = thr; a.min_conf = min_conf;
  a.kw = KalmanWeights{pw2, pw1, vw10, vw1};
  fused_sort_kernel<<<1, NT, bytes, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int fused_visual_launch(
    const void* box, const void* conf, const void* valid, const void* feat,
    const void* fvalid, const void* qual, const void* oa,
    void* mp, void* mv, void* cpp, void* cpv, void* cvv, void* pred, void* obs,
    void* tconf, void* active, void* last, void* length, void* tid,
    void* gf, void* gq, void* gv, void* coll, void* vt, void* lastf,
    void* lastfv, void* nid,
    void* o_ids, void* o_slots, void* o_pred, void* o_vt, void* o_new,
    void* o_len, void* o_ovf, void* o_stats,
    void* P, void* cdt, void* wd, void* okb, void* Wm,
    const void* dots, const void* norms,
    int C, int D, int T, int K, int F, int epoch0, int max_idle, int recycle,
    int min_track_len, int min_votes, int maha, int euclid, int n_cons,
    float thr, float pos_min_conf, float vis_thr, float min_area, float q_use,
    float q_collect, float oa_use, float oa_collect, float pw2, float pw1,
    float vw10, float vw1,
    const int* cons_dd, const float* cons_md, void* prof,
    void* stream) {
  if (D < 1 || D > NT || T < 1 || C < 1 || K < 1 || K > 31 || F < 1 ||
      n_cons < 0 || n_cons > MAX_CONSTRAINTS)
    return (int)cudaErrorInvalidValue;
  VisualSmem probe;
  const size_t bytes = probe.carve(nullptr, D, T, K);
  if (bytes > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      fused_visual_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (e != cudaSuccess) return (int)e;
  VisualArgs a;
  a.box = (const float*)box; a.conf = (const float*)conf;
  a.valid = (const int*)valid; a.feat = (const float*)feat;
  a.fvalid = (const int*)fvalid; a.qual = (const float*)qual;
  a.oa = (const float*)oa;
  a.mp = (float*)mp; a.mv = (float*)mv; a.cpp = (float*)cpp;
  a.cpv = (float*)cpv; a.cvv = (float*)cvv; a.pred = (float*)pred;
  a.obs = (float*)obs; a.tconf = (float*)tconf;
  a.active = (int*)active; a.last = (int*)last; a.length = (int*)length;
  a.tid = (int*)tid;
  a.gf = (float*)gf; a.gq = (float*)gq; a.gv = (int*)gv;
  a.coll = (int*)coll; a.vt = (int*)vt; a.lastf = (float*)lastf;
  a.lastfv = (int*)lastfv; a.nid = (int*)nid;
  a.o_ids = (int*)o_ids; a.o_slots = (int*)o_slots;
  a.o_pred = (float*)o_pred; a.o_vt = (int*)o_vt; a.o_new = (int*)o_new;
  a.o_len = (int*)o_len; a.o_ovf = (int*)o_ovf; a.o_stats = (int*)o_stats;
  a.P = (float*)P; a.cdt = (unsigned char*)cdt; a.wd = (float*)wd;
  a.okb = (unsigned char*)okb; a.Wm = (float*)Wm;
  a.dots = (const float*)dots; a.norms = (const float*)norms;
  a.prof = (long long*)prof;
  a.C = C; a.D = D; a.T = T; a.K = K; a.F = F; a.epoch0 = epoch0;
  a.max_idle = max_idle; a.recycle = recycle; a.min_track_len = min_track_len;
  a.min_votes = min_votes; a.maha = maha; a.euclid = euclid;
  a.n_cons = n_cons;
  a.thr = thr; a.pos_min_conf = pos_min_conf; a.vis_thr = vis_thr;
  a.min_area = min_area; a.q_use = q_use; a.q_collect = q_collect;
  a.oa_use = oa_use; a.oa_collect = oa_collect;
  a.kw = KalmanWeights{pw2, pw1, vw10, vw1};
  for (int c = 0; c < MAX_CONSTRAINTS; ++c) {
    a.cons_dd[c] = c < n_cons ? cons_dd[c] : 0;
    a.cons_md[c] = c < n_cons ? cons_md[c] : 0.0f;
  }
  fused_visual_kernel<<<1, NT, bytes, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
