// Fused SORT and VisualSORT frame kernels for Hopper (sm_90a).
//
// Each launch runs C consecutive frames of one sequence: a loop over frames
// inside the kernel, since frame s needs the state frame s-1 left.  The
// TPU's one-hot matmul scatters and gathers become indexed loads and
// stores.
//
// fused_sort_kernel replaces `similari_tpu/ops/pallas_sort.py::_kernel`
// (with `forward_auction`, `_row_argmax`, `_cumsum_rows`), which keeps the
// whole chunk's state in VMEM.  On this card the frame is latency-bound,
// not bound by bytes or operations: at D=128 (pad_pow2(100)), T=512 a
// 16-frame launch moves ~0.2 MB and needs ~21 MFLOP, 0.36 us at the card's
// f32 rate (chip_smoke.py's bound), yet one block on one SM took 70 us per
// frame (PERF.md section 5): the [D, T] weights pass on one SM's issue rate
// (59%) and auction rounds of ~9.5 us each (four barriers of 1024
// threads, every column of a bidding row read from L2, an O(D) winner
// loop per row).  The design runs the chunk on ONE CLUSTER of G = 8
// blocks of 512 threads (cudaLaunchKernelEx with a cluster dimension; the
// shape measured fastest of 2-16 blocks and 256 or 512 threads, PERF.md
// section 6):
//   - block g owns track columns [g*ceil(T/G), ...) and diagonal columns
//     [g*ceil(D/G), ...); it computes its [D, ceil(T/G)] slice of the
//     weights into shared memory (32 KB at the main-path shape) from
//     per-row and per-track edge terms, one track column per thread, and
//     keeps the state of its slots in shared memory for the whole launch
//     (read once at the start, written once at the end), as the TPU kept
//     it in VMEM.  Slices that do not fit go to device memory, the same
//     code with other pointers (the launcher's plan says which);
//   - an auction round is one cluster barrier: each block scans its own
//     columns for every bidding row (a few lanes per row) and publishes
//     a (first max, column, runner-up) partial; after the barrier every
//     block reads the G partials through distributed shared memory,
//     merges them in block order, and resolves every bid itself against
//     its own copy of all columns' prices and owners (a shared-memory
//     atomicMax per column on a (round, bid, lowest row) key): O(bidding
//     rows) per round, and the copies stay equal without an exchange;
//   - per frame two more barriers: the span (the max weight) with the
//     free-slot counts, and the match flags, which a column's owner sets.
//     Free slots are ranked by an exclusive scan of the blocks' counts;
//     the block that owns a row's slot runs its Kalman step and writes.
//
// fused_visual_kernel replaces `similari_tpu/ops/pallas_visual.py::_kernel`
// (with `_col_argmax` and the same helpers), together with
// gallery_dots.cu, which computes its gallery product.  The scan writes a
// gallery lane only by copying a candidate row of the chunk into it, so
// every lane a frame-s candidate meets holds its launch-start value or a
// chunk row of an earlier frame.  gallery_dots_kernel, launched on the same
// stream just before, computes every such dot product (and the rows'
// norms) on the whole card, bf16 on the tensor cores; the scan keeps a
// lane-source table (lane -> column of that product, updated where a row
// enters a lane) and, for each gated (candidate, lane) pair, gathers the
// dot and both norms through it.
//
// Bound at the main-path shapes (D=128, T=512, K=3, F=512): the state
// moves about 8.4 MB per launch (read + write), 1.3 us each way at 3.35
// TB/s, and the ~30,000 gated pairs per frame are L2 gathers.  Neither is
// the limit: the frame's serial passes and barriers are.  On one block of
// 1024 threads a frame took ~0.23 ms (PERF.md section 5, from the `prof`
// phase stamps): the [D, T] positional, votes and argmax passes ~57%, the
// auction ~15%, the state write ~15%, the gallery gather ~10%.  The design
// runs the chunk on ONE CLUSTER of G blocks, as the SORT kernel does:
//   - the slots are dealt to the blocks in turn (slot t to block t % G:
//     the live tracks fill the lowest slots, so each block gets about a
//     G-th of them); block g keeps its slots' per-track vectors, lane
//     sources and state in shared memory for the whole launch, and runs
//     the frame's [D, nt] passes on its own columns with the matrices in
//     shared memory (positional weights and compatibility; the gated
//     gallery distances, for the block's max; votes and best-fit weights,
//     which gather each gated pair's dot again; each column's heaviest
//     row).  Matrices or state that do not fit go to device memory, the
//     same code with other pointers (the launcher's plan says which);
//   - what crosses blocks goes through distributed shared memory after a
//     cluster barrier: the max distance with the gated pairs and the free
//     slots (a bit mask per block), each row's first max over each block's
//     columns with each column's heaviest row (a row wins its best track
//     where it is that track's heaviest row), and the span; the auction is
//     the SORT kernel's (`cluster_auction`), one barrier a round and one
//     for the match flags;
//   - every block computes the rows' vectors, the free-slot list of the
//     cluster in slot order and so every row's slot itself; the block that
//     owns a row's slot runs its Kalman step, gallery bookkeeping, state
//     and feature writes and outputs.

// Ids must match the reference exactly: ties go to the lowest index
// everywhere, the r-th new detection takes the r-th free slot, and on
// overflow (n_new > n_free) the frame writes nothing while next_id still
// advances.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fused_track.cuh"

namespace cg = cooperative_groups;
using namespace ft;

namespace {

constexpr int MAX_CONSTRAINTS = 8;
constexpr int MAX_SMEM = 232448;  // bytes a block may use on sm_90
constexpr int SORT_CLUSTER = 8;  // fused SORT: blocks per cluster (G)
constexpr int SORT_THREADS = 512;  // and threads per block
constexpr int VISUAL_CLUSTER = 16;  // fused VisualSORT: blocks per cluster
constexpr int VISUAL_THREADS = 512;  // and threads per block

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
  int* o_stats;  // [C, 3] auction rounds, bids, 0
  float* W;  // [D, T] scratch, when !w_smem: block g's [D, nt] slice at
             // D * g * Tc
  char* cols;  // [G, 16 (D+T)] bytes of scratch, when !cols_smem: block
               // g's column arrays
  long long* prof;  // [C, NSORT + 1] phase stamps and cluster barriers
  int C, D, T, epoch0, max_idle, recycle;
  int Dc, Tc;  // diagonal and track columns per block
  int w_smem, st_smem, cols_smem;  // W slice, state slice and column
                                   // arrays in shared memory
  float thr, min_conf;
  KalmanWeights kw;
};

// One block's view of the tracker state: its slots [g*Tc, g*Tc + nt),
// indexed from 0, in shared memory or in place in device memory.
struct SlotState {
  float *mp, *mv, *cpp, *cpv, *cvv, *pred, *obs, *tconf;  // [nt, 5] / [nt]
  int *active, *last, *length, *tid;  // [nt]
};

struct SortSmem {
  float *box, *redge, *cc, *conf;  // [D, 5], [5, D], [D], [D]
  int *valid, *r2c, *jb, *rank, *matched;  // [D]
  float* bid;  // [D] the round's bid of each bidding row
  int* plist;  // [2, D] the bidding rows of this round and the next
  int* np;  // [2] their counts
  float4* part;  // [2, D] this block's (b1, i1, b2) of each bidding row
  float* prices;  // [D + T] every column's, alike in every block
  int* c2r;  // [D + T]
  unsigned long long* key;  // [D + T] the best (round, bid, row) so far
  int* wok;  // [Tc] own track column: its owner row's W passes thr
  float* tedge;  // [5, Tc]
  int *act, *compat, *frank, *flist;  // [Tc]
  float *xmax, *gmax;  // [2] by frame parity, read by the cluster; [G]
  int *xcnt, *gcnt;  // free slots, the same way
  float* redf;  // [32]
  int* redi;  // [32]
  SlotState st;  // when st_smem
  float* W;  // [D, Tc] when w_smem
  __host__ __device__ size_t carve(char* base, int D, int T, int Tc,
                                   bool cols_smem, bool st_smem,
                                   bool w_smem) {
    Carve c(base);
    box = c.take<float>(5 * D);
    redge = c.take<float>(5 * D);
    cc = c.take<float>(D);
    conf = c.take<float>(D);
    valid = c.take<int>(D);
    r2c = c.take<int>(D);
    jb = c.take<int>(D);
    rank = c.take<int>(D);
    matched = c.take<int>(D);
    bid = c.take<float>(D);
    plist = c.take<int>(2 * D);
    np = c.take<int>(2);
    part = c.take<float4>(2 * D);
    if (cols_smem) {
      prices = c.take<float>(D + T);
      c2r = c.take<int>(D + T);
      key = c.take<unsigned long long>(D + T);
    }
    wok = c.take<int>(Tc);
    tedge = c.take<float>(5 * Tc);
    act = c.take<int>(Tc);
    compat = c.take<int>(Tc);
    frank = c.take<int>(Tc);
    flist = c.take<int>(Tc);
    xmax = c.take<float>(2);
    gmax = c.take<float>(SORT_CLUSTER);
    xcnt = c.take<int>(2);
    gcnt = c.take<int>(SORT_CLUSTER);
    redf = c.take<float>(32);
    redi = c.take<int>(32);
    if (st_smem) {
      float** f5[] = {&st.mp, &st.mv, &st.cpp, &st.cpv, &st.cvv, &st.pred,
                      &st.obs};
      for (float** p : f5) *p = c.take<float>(5 * Tc);
      st.tconf = c.take<float>(Tc);
      int** i1[] = {&st.active, &st.last, &st.length, &st.tid};
      for (int** p : i1) *p = c.take<int>(Tc);
    }
    W = w_smem ? c.take<float>((size_t)D * Tc) : nullptr;
    return c.off;
  }
};

// The slots [t0, t0 + n) of the state in device memory.
__device__ SlotState global_slots(const SortArgs& a, int t0) {
  return SlotState{a.mp + t0 * 5, a.mv + t0 * 5, a.cpp + t0 * 5,
                   a.cpv + t0 * 5, a.cvv + t0 * 5, a.pred + t0 * 5,
                   a.obs + t0 * 5, a.tconf + t0, a.active + t0,
                   a.last + t0, a.length + t0, a.tid + t0};
}

// Copies n slots between two views (launch start and end).
__device__ void copy_slots(const SlotState& to, const SlotState& from, int n,
                           int nthreads) {
  for (int i = threadIdx.x; i < 5 * n; i += nthreads) {
    to.mp[i] = from.mp[i]; to.mv[i] = from.mv[i]; to.cpp[i] = from.cpp[i];
    to.cpv[i] = from.cpv[i]; to.cvv[i] = from.cvv[i];
    to.pred[i] = from.pred[i]; to.obs[i] = from.obs[i];
  }
  for (int i = threadIdx.x; i < n; i += nthreads) {
    to.tconf[i] = from.tconf[i]; to.active[i] = from.active[i];
    to.last[i] = from.last[i]; to.length[i] = from.length[i];
    to.tid[i] = from.tid[i];
  }
}

// Phase boundaries of a SORT frame, stamped into SortArgs::prof[s * NSORT
// + k].
enum {
  SS_START, SS_ROWS, SS_WEIGHTS, SS_SPAN, SS_AUCTION, SS_MATCH, SS_SLOTS,
  SS_KALMAN, SS_WRITE, NSORT
};

// max of the augmented matrix's diagonal block as seen by one thread
__device__ __forceinline__ float diag_max(int tid, int D, const int* valid,
                                          float thr) {
  if (tid < D) return valid[tid] ? (D >= 2 ? fmaxf(thr, 0.0f) : thr) : 0.0f;
  return D >= 2 ? 0.0f : -INFINITY;
}

// Kalman step of one detection against its slot's stored filter (matched)
// or a new filter at z; `a` holds the state (VisualArgs, SlotState).
template <class A>
__device__ void kalman_rows(const KalmanWeights& kw, const A& a, bool matched,
                            int sl, const float* z, KFRow* u) {
  for (int j = 0; j < 5; ++j)
    u[j] = kf_step(kw, matched, j, z[j], z[4], a.mp[sl * 5 + j],
                   a.mv[sl * 5 + j], a.cpp[sl * 5 + j], a.cpv[sl * 5 + j],
                   a.cvv[sl * 5 + j], a.mp[sl * 5 + 4], a.mv[sl * 5 + 4]);
}

// Writes the SORT columns of one updated slot (VisualArgs, SlotState).
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

// A phase boundary of the SORT cluster: the whole cluster first meets
// (only when profiling), then block 0 stamps.
__device__ __forceinline__ void cluster_stamp(long long* prof, int i,
                                              cg::cluster_group& cluster) {
  if (prof == nullptr) return;  // uniform across the cluster
  cluster.sync();
  if (cluster.block_rank() == 0 && threadIdx.x == 0) {
    long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    prof[i] = t;
  }
}

// The C frames of one sequence on one cluster of G blocks (see the note at
// the top).  Block g owns the diagonal columns [g*Dc, g*Dc + nd) and the
// track columns D + [g*Tc, g*Tc + nt) of the augmented [D, D+T] matrix:
// it scans them for bids, and holds their W slice and the state of slots
// [g*Tc, ...).  Every block keeps the rows' vectors (boxes, r2c, ranks)
// and the auction's prices and owners of all D+T columns, and updates them
// alike from the same data, so they need no exchange; what crosses blocks,
// through distributed shared memory, is the frame's max weight and free
// counts, each round's per-block bid partials, and the match flags.
__global__ void __launch_bounds__(SORT_THREADS, 1)
fused_sort_kernel(SortArgs a) {
  constexpr int NTB = SORT_THREADS, G = SORT_CLUSTER;
  extern __shared__ __align__(16) char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  SortSmem sm;
  sm.carve(smem, a.D, a.T, a.Tc, a.cols_smem, a.st_smem, a.w_smem);
  const int D = a.D, T = a.T, N = D + T, Dc = a.Dc, Tc = a.Tc;
  const int g = (int)cluster.block_rank();
  const int d0 = g * Dc, nd = max(min(D - d0, Dc), 0);
  const int t0 = g * Tc, nt = max(min(T - t0, Tc), 0);
  const int tid = threadIdx.x;
  const float thr = a.thr;
  if (!a.cols_smem) {  // [N] prices, [N] c2r, [N] keys in device memory
    char* base = a.cols + (size_t)g * 16 * N;
    sm.prices = reinterpret_cast<float*>(base);
    sm.c2r = reinterpret_cast<int*>(base + (size_t)4 * N);
    sm.key = reinterpret_cast<unsigned long long*>(base + (size_t)8 * N);
  }
  const SlotState gst = global_slots(a, t0);
  SlotState st = gst;
  if (a.st_smem) {
    st = sm.st;
    copy_slots(st, gst, nt, NTB);
    __syncthreads();
  }
  float* const Wl = a.w_smem ? sm.W : a.W + (size_t)D * t0;  // [D, nt]
  int nid = *a.nid;
  for (int s = 0; s < a.C; ++s) {
    const int epoch = a.epoch0 + s, par = s & 1;
    long long* const pf = a.prof ? a.prof + s * (NSORT + 1) : nullptr;
    int barriers = 0;
    cluster_stamp(pf, SS_START, cluster);
    // ---- rows (all D, in every block) and own tracks --------------------
    for (int r = tid; r < D; r += NTB) {
      const int i = s * D + r;
      const int v = a.valid[i] > 0;
      const float vf = v ? 1.0f : 0.0f;
      float b[5];
      for (int j = 0; j < 5; ++j) {
        b[j] = sanitize(a.box[i * 5 + j], vf, j);
        sm.box[r * 5 + j] = b[j];
      }
      // aligned_iou's row terms, in its operation order
      const float aw = b[3] * b[4];
      sm.redge[0 * D + r] = b[0] + aw * 0.5f;
      sm.redge[1 * D + r] = b[0] - aw * 0.5f;
      sm.redge[2 * D + r] = b[1] + b[4] * 0.5f;
      sm.redge[3 * D + r] = b[1] - b[4] * 0.5f;
      sm.redge[4 * D + r] = aw * b[4];
      sm.conf[r] = a.conf[i];
      sm.cc[r] = fmaxf(a.conf[i], a.min_conf);
      sm.valid[r] = v;
    }
    for (int t = tid; t < nt; t += NTB) {
      const int act0 = st.active[t] > 0;
      const int comp = act0 && (epoch - st.last[t]) <= a.max_idle;
      const int act = a.recycle ? comp : act0;
      sm.act[t] = act;
      sm.compat[t] = comp;
      sm.frank[t] = !act;
      const float* p = &st.pred[t * 5];
      const float tw = p[3] * p[4];
      sm.tedge[0 * Tc + t] = p[0] + tw * 0.5f;
      sm.tedge[1 * Tc + t] = p[0] - tw * 0.5f;
      sm.tedge[2 * Tc + t] = p[1] + p[4] * 0.5f;
      sm.tedge[3 * Tc + t] = p[1] - p[4] * 0.5f;
      sm.tedge[4 * Tc + t] = tw * p[4];
    }
    __syncthreads();
    // own free slots in slot order (frank: inclusive ranks)
    block_scan_inclusive<NTB>(sm.frank, nt, sm.redi);
    for (int t = tid; t < nt; t += NTB)
      if (!sm.act[t]) sm.flist[sm.frank[t] - 1] = t;
    const int own_free = nt > 0 ? sm.frank[nt - 1] : 0;
    cluster_stamp(pf, SS_ROWS, cluster);
    // ---- weights: this block's [D, nt] slice ----------------------------
    // A thread takes one track column (its terms in registers) and every
    // rs-th row; a pair whose boxes do not overlap is 0 without dividing.
    float lmax = -INFINITY;
    if (g == 0)
      for (int r = tid; r < D; r += NTB)
        lmax = fmaxf(lmax, diag_max(r, D, sm.valid, thr));
    if (nt > 0) {
      const int rs = max(NTB / nt, 1);
      for (int c = tid; c < rs * nt; c += NTB) {
        const int r0 = c / nt, t = c - r0 * nt;
        const float txr = sm.tedge[t], txl = sm.tedge[Tc + t];
        const float tyt = sm.tedge[2 * Tc + t], tyb = sm.tedge[3 * Tc + t];
        const float tar = sm.tedge[4 * Tc + t];
        const bool comp = sm.compat[t] != 0;
        for (int r = r0; r < D; r += rs) {
          const float ix = fminf(sm.redge[r], txr) - fmaxf(sm.redge[D + r], txl);
          const float iy = fminf(sm.redge[2 * D + r], tyt)
                         - fmaxf(sm.redge[3 * D + r], tyb);
          float wv = 0.0f;
          if (comp && ix > 0.0f && iy > 0.0f) {
            const float inter = ix * iy;
            if (inter > 0.0f) {
              const float uni = sm.redge[4 * D + r] + tar - inter;
              const float m = inter / uni * sm.cc[r];
              if (m >= thr) wv = m;
            }
          }
          Wl[r * nt + t] = wv;
          lmax = fmaxf(lmax, wv);
        }
      }
    }
    cluster_stamp(pf, SS_WEIGHTS, cluster);
    // ---- span and free counts across the cluster ------------------------
    const float bmax = block_max<NTB>(lmax, sm.redf);
    if (tid == 0) { sm.xmax[par] = bmax; sm.xcnt[par] = own_free; }
    cluster.sync();
    ++barriers;
    if (tid < G) {
      sm.gmax[tid] = cluster.map_shared_rank(sm.xmax, tid)[par];
      sm.gcnt[tid] = cluster.map_shared_rank(sm.xcnt, tid)[par];
    }
    __syncthreads();
    float amax = -INFINITY;
    int pre = 0, n_free = 0;
    for (int h = 0; h < G; ++h) {
      amax = fmaxf(amax, sm.gmax[h]);
      pre += h < g ? sm.gcnt[h] : 0;
      n_free += sm.gcnt[h];
    }
    const float span = fmaxf(amax, 1e-6f);
    const float eps = span / (float)fmax(4096.0, 64.0 * D);
    cluster_stamp(pf, SS_SPAN, cluster);
    // ---- auction (Jacobi rounds over the cluster) ------------------------
    int rounds = 0, bids = 0;
    cluster_auction<G, NTB, 1>(
        cluster, ClusterAuction{sm.r2c, sm.jb, sm.bid, sm.plist, sm.np,
                                sm.part, sm.prices, sm.c2r, sm.key, sm.wok},
        Wl, sm.valid, D, T, d0, nd, t0, nt, thr, eps, &rounds, &bids,
        &barriers);
    cluster_stamp(pf, SS_AUCTION, cluster);
    // ---- match: the column's owner block holds W[r, j - D] >= thr --------
    for (int r = tid; r < D; r += NTB) {
      const int j = sm.r2c[r];
      int m = 0;
      if (sm.valid[r] && j >= D) {
        const int h = (j - D) / Tc;
        m = *cluster.map_shared_rank(&sm.wok[j - D - h * Tc], h);
      }
      sm.matched[r] = m;
      sm.rank[r] = sm.valid[r] && !m;
    }
    __syncthreads();
    cluster_stamp(pf, SS_MATCH, cluster);
    // ---- slots: the r-th new row takes the r-th free slot of the cluster
    block_scan_inclusive<NTB>(sm.rank, D, sm.redi);
    const int n_new = sm.rank[D - 1];
    const bool ovf = n_new > n_free;
    cluster_stamp(pf, SS_SLOTS, cluster);
    // ---- Kalman step, ids, outputs, state write (dropped on overflow) ---
    if (a.recycle)
      for (int t = tid; t < nt; t += NTB) st.active[t] = sm.act[t];
    __syncthreads();
    for (int r = tid; r < D; r += NTB) {
      const bool m = sm.matched[r];
      const int k = sm.rank[r];
      int sl, b;
      if (m) {
        sl = sm.r2c[r] - D;
        b = sl / Tc;
      } else if (k >= 1 && k <= n_free) {
        b = -1;  // the block whose free slots hold rank k
        for (int h = 0, c = 0; h < G && b < 0; c += sm.gcnt[h], ++h)
          if (k <= c + sm.gcnt[h]) b = h;
        sl = b == g ? t0 + sm.flist[k - pre - 1] : -1;
      } else {
        sl = T - 1;
        b = sl / Tc;
      }
      if (b != g) continue;
      const int t = sl - t0;
      const float* z = &sm.box[r * 5];
      KFRow u[5];
      kalman_rows(a.kw, st, m, t, z, u);
      const int new_len = m ? st.length[t] + 1 : 1;
      const int new_id = m ? st.tid[t] : nid + k;
      a.o_ids[s * D + r] = new_id;
      a.o_slots[s * D + r] = sl;
      for (int j = 0; j < 5; ++j) a.o_pred[(s * D + r) * 5 + j] = u[j].mp;
      if (sm.valid[r] && !ovf)
        write_sort_columns(st, t, u, z, sm.conf[r], epoch, new_len, new_id);
    }
    cluster_stamp(pf, SS_KALMAN, cluster);
    // ---- the frame's counters -------------------------------------------
    nid += n_new;
    if (g == 0 && tid == 0) {
      a.o_ovf[s] = ovf;
      a.o_stats[s * 3 + 0] = rounds;
      a.o_stats[s * 3 + 1] = bids;
      a.o_stats[s * 3 + 2] = 0;
      if (pf) pf[NSORT] = barriers;
    }
    __syncthreads();
    cluster_stamp(pf, SS_WRITE, cluster);
  }
  if (a.st_smem) {
    __syncthreads();
    copy_slots(gst, st, nt, NTB);
  }
  if (g == 0 && tid == 0) *a.nid = nid;
  // no block may leave while another can still read its shared memory
  cluster.sync();
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
  float* mats;  // when !m_smem: [G, D, Tc] P, then [G, D, Tc] Wm (f32),
                // then [G, D, Tc] compatibility bytes; block g's at g*D*Tc
  char* cols;  // [G, 16 (D+T)] bytes of scratch, when !cols_smem
  const float* dots;  // [C*D, T*K + C*D] gallery_dots.cu's products
  const float* norms;  // [T*K + C*D] their rows' sums of squares
  long long* prof;  // [C, NSTAMP + 1] phase stamps and cluster barriers
  int C, D, T, K, F, epoch0, max_idle, recycle, min_track_len, min_votes;
  int maha, euclid, n_cons;
  int Dc, Tc;  // diagonal columns and slots per block
  int m_smem, st_smem, cols_smem;  // [D, Tc] matrices, state slice and
                                   // column arrays in shared memory
  float thr, pos_min_conf, vis_thr, min_area, q_use, q_collect, oa_use,
      oa_collect;
  KalmanWeights kw;
  int cons_dd[MAX_CONSTRAINTS];  // ascending
  float cons_md[MAX_CONSTRAINTS];
};

// Slots are dealt to the blocks in turn: slot t lies in block t % G, at
// index t / G there.  New tracks take the lowest free slots, so the live
// tracks sit in the lowest slots; dealt in turn, each block holds about a
// G-th of them (and of their gated gallery pairs), where a contiguous
// split would leave most blocks none.
__device__ __forceinline__ int vowner(int t) { return t % VISUAL_CLUSTER; }
__device__ __forceinline__ int vindex(int t) { return t / VISUAL_CLUSTER; }

// One block's view of the VisualSORT state: its slots, indexed from 0, in
// shared memory, or the whole state in device memory (SlotState for the
// SORT columns).
struct VisualSlots {
  SlotState s;
  float* gq;  // [n, K]
  int* gv;  // [n, K]
  int *coll, *vt, *lastfv;  // [n]
};

struct VisualSmem {
  // rows, alike in every block
  float *box, *conf, *qual, *oa, *qn, *rdet;  // [D, 5], [D] x5
  int *valid, *featok, *use, *collect, *lr, *t1, *hasany, *wins, *tgt, *vt;
  int *rowopen, *matched, *nr, *newlane, *finalv, *slot, *wrows;  // [D]
  int* flist;  // [D] the cluster's first D free slots in slot order
  float2* rowpart;  // [D] this block's (first max, column) of each row
  int *r2c, *jb;  // [D] the auction's rows (see ClusterAuction)
  float* bid;  // [D]
  int* plist;  // [2, D]
  int* np;  // [2]
  float4* part;  // [2, D]
  float* prices;  // [D + T] when cols_smem
  int* c2r;  // [D + T]
  unsigned long long* key;  // [D + T]
  // own slots, index q for slot g + q*G
  int *act, *compat, *tg, *gvbits, *bestq, *claimed, *wok;  // [Tc]
  float* rtrk;  // [Tc]
  int* lt;  // [Tc] listed own tracks: matured and compatible
  float* gn;  // [K, Tc] their live lanes' norms
  int* src;  // [Tc*K] own lane -> column of `dots` holding its value
  float2* colpart;  // [NTB] (max, row) of a group of rows of a column
  unsigned *fmask, *gmask;  // [2, MW] own free slots by frame parity; [G, MW]
  unsigned* fw;  // [TW] the cluster's free slots in slot order
  float *xd, *xs;  // [2] max distance and span partials, by frame parity
  int* xp;  // [2] gated pairs
  float *gd, *gs;  // [G] every block's, staged
  int* gp;  // [G]
  float* redf;  // [32]
  int* redi;  // [32]
  int* counts;  // [4]: rows listed, own tracks listed, rows written, free
                // slots of the cluster
  int* npairs;  // [1]
  VisualSlots st;  // when st_smem
  float *P, *Wm;  // [D, Tc] when m_smem: positional weights (then the
                  // masked remainder), best-fit weights
  unsigned char* cdt;  // [D, Tc] compatibility with constraints
  __host__ __device__ size_t carve(char* base, int D, int T, int K, int Tc,
                                   bool cols_smem, bool st_smem,
                                   bool m_smem) {
    constexpr int G = VISUAL_CLUSTER;
    const int MW = (Tc + 31) / 32, TW = (T + 31) / 32;
    Carve c(base);
    box = c.take<float>(5 * D);
    float** f1[] = {&conf, &qual, &oa, &qn, &rdet};
    for (float** p : f1) *p = c.take<float>(D);
    int** i1[] = {&valid, &featok, &use, &collect, &lr, &t1, &hasany, &wins,
                  &tgt, &vt, &rowopen, &matched, &nr, &newlane, &finalv,
                  &slot, &wrows, &flist};
    for (int** p : i1) *p = c.take<int>(D);
    rowpart = c.take<float2>(D);
    r2c = c.take<int>(D);
    jb = c.take<int>(D);
    bid = c.take<float>(D);
    plist = c.take<int>(2 * D);
    np = c.take<int>(2);
    part = c.take<float4>(2 * D);
    if (cols_smem) {
      prices = c.take<float>(D + T);
      c2r = c.take<int>(D + T);
      key = c.take<unsigned long long>(D + T);
    }
    int** i2[] = {&act, &compat, &tg, &gvbits, &bestq, &claimed, &wok};
    for (int** p : i2) *p = c.take<int>(Tc);
    rtrk = c.take<float>(Tc);
    lt = c.take<int>(Tc);
    gn = c.take<float>((size_t)K * Tc);
    src = c.take<int>((size_t)Tc * K);
    colpart = c.take<float2>(VISUAL_THREADS);
    fmask = c.take<unsigned>(2 * MW);
    gmask = c.take<unsigned>(G * MW);
    fw = c.take<unsigned>(TW);
    xd = c.take<float>(2);
    xs = c.take<float>(2);
    xp = c.take<int>(2);
    gd = c.take<float>(G);
    gs = c.take<float>(G);
    gp = c.take<int>(G);
    redf = c.take<float>(32);
    redi = c.take<int>(32);
    counts = c.take<int>(4);
    npairs = c.take<int>(1);
    if (st_smem) {
      float** f5[] = {&st.s.mp, &st.s.mv, &st.s.cpp, &st.s.cpv, &st.s.cvv,
                      &st.s.pred, &st.s.obs};
      for (float** p : f5) *p = c.take<float>(5 * Tc);
      st.s.tconf = c.take<float>(Tc);
      int** i3[] = {&st.s.active, &st.s.last, &st.s.length, &st.s.tid};
      for (int** p : i3) *p = c.take<int>(Tc);
      st.gq = c.take<float>((size_t)K * Tc);
      st.gv = c.take<int>((size_t)K * Tc);
      int** i4[] = {&st.coll, &st.vt, &st.lastfv};
      for (int** p : i4) *p = c.take<int>(Tc);
    }
    if (m_smem) {
      P = c.take<float>((size_t)D * Tc);
      Wm = c.take<float>((size_t)D * Tc);
      cdt = c.take<unsigned char>((size_t)D * Tc);
    }
    return c.off;
  }
};

// Phase boundaries of a VisualSORT frame, stamped into
// VisualArgs::prof[s * (NSTAMP + 1) + k]; the frame's cluster barriers go
// to its last column.
enum {
  ST_START, ST_ROWS, ST_LISTS, ST_POS, ST_NORMS, ST_DIST, ST_VOTES,
  ST_ARGMAX, ST_AUCTION, ST_SLOTS, ST_WRITE, NSTAMP
};

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

// Gallery distance of a candidate and a lane from their dot product and
// norms: whether the metric passes, the distance in *wv.
__device__ __forceinline__ bool lane_distance(const VisualArgs& a, float acc,
                                              float qn, float gn, float* wv) {
  if (a.euclid) {
    *wv = sqrtf(fmaxf(qn + gn - 2.0f * acc, 0.0f));
    return *wv <= a.vis_thr;
  }
  const float den = sqrtf(qn) * sqrtf(gn);
  const float sim = acc / (den > 0.0f ? den : 1.0f);
  *wv = 1.0f - sim;
  return sim >= a.vis_thr;
}

// The gallery distances of a candidate and own track q over the track's
// live lanes (bit i of `bits`), four lanes' dots gathered (from the
// candidate's row dr of the product) before any is used: calls pass(wv)
// for each lane whose metric passes, in lane order; returns the lanes
// scored.
template <class Pass>
__device__ __forceinline__ int pair_lanes(const VisualArgs& a,
                                          const float* dr, const int* src,
                                          const float* gn, int Tc, int q,
                                          int bits, float qn, Pass pass) {
  const int K = a.K;
  int n = 0;
  for (int i0 = 0; i0 < K; i0 += 4) {
    float acc[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u;
      acc[u] = (i < K && ((bits >> i) & 1)) ? dr[src[q * K + i]] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u;
      if (i < K && ((bits >> i) & 1)) {
        float wv;
        if (lane_distance(a, acc[u], qn, gn[i * Tc + q], &wv)) pass(wv);
        ++n;
      }
    }
  }
  return n;
}

// Copies the features of the n rows this block writes (rows[k], own slot
// index slot[rows[k]]) into lastf and the gallery lane each row enters
// (bit k of newlane[row]), in units of V (float4 where every row is
// aligned, else float), four units in flight per thread.
template <class V>
__device__ void write_features(const VisualArgs& a, const float* feat,
                               const int* rows, const int* slot,
                               const int* newlane, int n, int g) {
  constexpr int G = VISUAL_CLUSTER, NTB = VISUAL_THREADS, U = 4;
  const int K = a.K, FV = (int)(a.F * sizeof(float) / sizeof(V));
  const V* x = reinterpret_cast<const V*>(feat);
  V* lastf = reinterpret_cast<V*>(a.lastf);
  V* gf = reinterpret_cast<V*>(a.gf);
  for (int j0 = threadIdx.x; j0 < n * FV; j0 += U * NTB) {
    V v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = j0 + u * NTB;
      if (j < n * FV) v[u] = x[(size_t)rows[j / FV] * FV + j % FV];
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = j0 + u * NTB;
      if (j >= n * FV) break;
      const int r = rows[j / FV], f = j % FV, nl = newlane[r];
      const size_t sl = (size_t)(g + slot[r] * G);
      lastf[sl * FV + f] = v[u];
      for (int k = 0; k < K; ++k)
        if ((nl >> k) & 1) gf[(sl * K + k) * FV + f] = v[u];
    }
  }
}

// Copies block g's n slots (slot g + q*G) from device memory into its
// shared-memory view at the launch's start (in), or back at its end.
__device__ void move_visual_slots(const VisualArgs& a, const VisualSlots& sh,
                                  int g, int n, bool in) {
  constexpr int G = VISUAL_CLUSTER;
  auto mv = [&](auto* dv, auto* sv, int width) {
    for (int i = threadIdx.x; i < width * n; i += VISUAL_THREADS) {
      const int q = i / width;
      const size_t gi = (size_t)(g + q * G) * width + (i - q * width);
      if (in) sv[i] = dv[gi]; else dv[gi] = sv[i];
    }
  };
  mv(a.mp, sh.s.mp, 5); mv(a.mv, sh.s.mv, 5); mv(a.cpp, sh.s.cpp, 5);
  mv(a.cpv, sh.s.cpv, 5); mv(a.cvv, sh.s.cvv, 5); mv(a.pred, sh.s.pred, 5);
  mv(a.obs, sh.s.obs, 5); mv(a.tconf, sh.s.tconf, 1);
  mv(a.active, sh.s.active, 1); mv(a.last, sh.s.last, 1);
  mv(a.length, sh.s.length, 1); mv(a.tid, sh.s.tid, 1);
  mv(a.gq, sh.gq, a.K); mv(a.gv, sh.gv, a.K); mv(a.coll, sh.coll, 1);
  mv(a.vt, sh.vt, 1); mv(a.lastfv, sh.lastfv, 1);
}

// The C frames of one sequence on one cluster of G blocks (see the note at
// the top).  Block g owns the slots g, g + G, ... (`vowner`): it holds
// their per-track vectors, lane sources, [D, nt] matrices and state, runs
// the positional, gallery, vote and column-argmax passes over them, and
// the Kalman step and write of every row whose slot it owns; the
// diagonal columns [g*Dc, ...) of the auction.  Every block computes the
// rows' vectors (boxes, gates, ranks, slots) itself.  What crosses
// blocks, through distributed shared memory, is the frame's max
// distance, gated pairs and free slots (one barrier), each row's first
// max and each column's heaviest row (one), the span (one), and the
// auction's bids and match flags (one barrier a round, then one).
__global__ void __launch_bounds__(VISUAL_THREADS, 1)
fused_visual_kernel(VisualArgs a) {
  constexpr int NTB = VISUAL_THREADS, NWB = NTB / 32, G = VISUAL_CLUSTER;
  extern __shared__ __align__(16) char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  VisualSmem sm;
  sm.carve(smem, a.D, a.T, a.K, a.Tc, a.cols_smem, a.st_smem, a.m_smem);
  const int D = a.D, T = a.T, K = a.K, F = a.F, TK = T * K, Tc = a.Tc;
  const int N = D + T, MW = (Tc + 31) / 32, TW = (T + 31) / 32;
  const size_t W = (size_t)TK + (size_t)a.C * D;  // columns of a.dots
  const int g = (int)cluster.block_rank();
  const int d0 = g * a.Dc, nd = max(min(D - d0, a.Dc), 0);
  const int nt = g < T ? (T - 1 - g) / G + 1 : 0;  // own slots
  const int tid = threadIdx.x, lane = lane_id(), w = warp_id();
  if (!a.cols_smem) {  // [N] prices, [N] c2r, [N] keys in device memory
    char* base = a.cols + (size_t)g * 16 * N;
    sm.prices = reinterpret_cast<float*>(base);
    sm.c2r = reinterpret_cast<int*>(base + (size_t)4 * N);
    sm.key = reinterpret_cast<unsigned long long*>(base + (size_t)8 * N);
  }
  if (!a.m_smem) {
    const size_t off = (size_t)g * D * Tc, all = (size_t)G * D * Tc;
    sm.P = a.mats + off;
    sm.Wm = a.mats + all + off;
    sm.cdt = reinterpret_cast<unsigned char*>(a.mats + 2 * all) + off;
  }
  // the state: own slot q at index q of the shared-memory view, or at
  // index g + q*G of the state in device memory
  VisualSlots st{SlotState{a.mp, a.mv, a.cpp, a.cpv, a.cvv, a.pred, a.obs,
                           a.tconf, a.active, a.last, a.length, a.tid},
                 a.gq, a.gv, a.coll, a.vt, a.lastfv};
  int sbase = g, sstep = G;
  if (a.st_smem) {
    st = sm.st;
    sbase = 0;
    sstep = 1;
    move_visual_slots(a, st, g, nt, true);
  }
  // every own lane starts as its launch-start value, column t*K + i
  for (int j = tid; j < nt * K; j += NTB) {
    const int q = j / K;
    sm.src[j] = (g + q * G) * K + (j - q * K);
  }
  __syncthreads();
  const ClusterAuction auc{sm.r2c, sm.jb, sm.bid, sm.plist, sm.np, sm.part,
                           sm.prices, sm.c2r, sm.key, sm.wok};
  // rs groups of rows per own column in the [D, nt] passes: a thread takes
  // one column (its terms in registers) and every rs-th row
  const int rs = nt > 0 ? max(NTB / nt, 1) : 1;
  // the feature rows move as 16-byte vectors where F and every row allow
  const bool vec = (F & 3) == 0 &&
      (((uintptr_t)a.feat | (uintptr_t)a.lastf | (uintptr_t)a.gf) & 15) == 0;
  int nid = *a.nid;
  for (int s = 0; s < a.C; ++s) {
    const int epoch = a.epoch0 + s, par = s & 1;
    long long* const pf = a.prof ? a.prof + s * (NSTAMP + 1) : nullptr;
    int barriers = 0;
    const float* feat = a.feat + (size_t)s * D * F;
    const float* drow = a.dots + (size_t)s * D * W;
    cluster_stamp(pf, ST_START, cluster);
    // ---- rows (all D, in every block): boxes, candidate feature gates ---
    for (int r = tid; r < D; r += NTB) {
      const int i = s * D + r;
      const int v = a.valid[i] > 0;
      const float vf = v ? 1.0f : 0.0f;
      float b[5];
      for (int j = 0; j < 5; ++j) {
        b[j] = sanitize(a.box[i * 5 + j], vf, j);
        sm.box[r * 5 + j] = b[j];
      }
      const int fok = a.fvalid[i] > 0;
      const float q = a.qual[i], o = a.oa[i];
      const bool area_ok = b[3] * b[4] * b[4] >= a.min_area;
      sm.conf[r] = a.conf[i];
      sm.valid[r] = v;
      sm.featok[r] = fok;
      sm.qual[r] = q;
      sm.oa[r] = o;
      sm.use[r] = fok && v && q >= a.q_use && o >= a.oa_use && area_ok;
      sm.collect[r] = fok && q >= a.q_collect && o >= a.oa_collect && area_ok;
      const float hw = b[3] * b[4] * 0.5f, hh = b[4] * 0.5f;
      sm.rdet[r] = sqrtf(hw * hw + hh * hh);
      sm.qn[r] = a.norms[TK + s * D + r];
    }
    // ---- own tracks -------------------------------------------------------
    for (int q = tid; q < nt; q += NTB) {
      const int i = sbase + q * sstep;
      const int act0 = st.s.active[i] > 0;
      const int comp = act0 && (epoch - st.s.last[i]) <= a.max_idle;
      sm.act[q] = a.recycle ? comp : act0;
      sm.compat[q] = comp;
      sm.tg[q] = st.coll[i] >= a.min_track_len;
      int bits = 0;
      for (int k = 0; k < K; ++k) bits |= (st.gv[i * K + k] > 0) << k;
      sm.gvbits[q] = bits;
      sm.claimed[q] = 0;
      const float* p = &st.s.pred[i * 5];
      const float hw = p[3] * p[4] * 0.5f, hh = p[4] * 0.5f;
      sm.rtrk[q] = sqrtf(hw * hw + hh * hh);
    }
    if (tid == 0) *sm.npairs = 0;
    __syncthreads();
    cluster_stamp(pf, ST_ROWS, cluster);
    // ---- lists: candidate rows, own listed tracks, own free slots --------
    if (w == 0)
      warp_compact(D, [&](int r) { return sm.use[r] != 0; }, sm.lr,
                   &sm.counts[0]);
    else if (w == 1)
      warp_compact(nt, [&](int q) { return sm.tg[q] && sm.compat[q]; },
                   sm.lt, &sm.counts[1]);
    for (int wd = w; wd < MW; wd += NWB) {
      const int q = wd * 32 + lane;
      const unsigned m = __ballot_sync(FULL, q < nt && !sm.act[q]);
      if (lane == 0) sm.fmask[par * MW + wd] = m;
    }
    __syncthreads();
    cluster_stamp(pf, ST_LISTS, cluster);
    // ---- positional weights + compatibility with constraints: [D, nt] ----
    for (int c = tid; c < rs * nt; c += NTB) {
      const int r0 = c / nt, q = c - r0 * nt, i = sbase + q * sstep;
      float p[5], mt[5], ct[5];
      for (int j = 0; j < 5; ++j) {
        p[j] = st.s.pred[i * 5 + j];
        mt[j] = st.s.mp[i * 5 + j];
        ct[j] = st.s.cpp[i * 5 + j];
      }
      const float rt = sm.rtrk[q];
      const bool comp = sm.compat[q] != 0;
      float allowed = 3.0e38f;
      if (a.n_cons > 0) {
        const int delta = epoch - st.s.last[i];
        for (int k = 0; k < a.n_cons; ++k)
          if (delta <= a.cons_dd[k]) { allowed = a.cons_md[k]; break; }
      }
      for (int r = r0; r < D; r += rs) {
        const float* b = &sm.box[r * 5];
        const float dx = b[0] - p[0], dy = b[1] - p[1];
        const float cd2 = dx * dx + dy * dy;
        const float rsum = sm.rdet[r] + rt;
        bool cd = comp;
        if (a.n_cons > 0) {
          const float d2r = sqrtf(cd2) / sqrtf(rsum * rsum + 1e-5f);
          cd = cd && d2r <= allowed;
        }
        sm.cdt[r * nt + q] = cd;
        const float cc = fmaxf(sm.conf[r], a.pos_min_conf);
        float m;
        bool pv;
        if (!a.maha) {
          float inter;
          m = aligned_iou(b, p, &inter) * cc;
          pv = cd && inter > 0.0f && m >= a.thr;
        } else {
          // Mahalanobis vs the stored KF state, chi2-gated and inverted
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
        sm.P[r * nt + q] = pv ? m : 0.0f;
      }
    }
    __syncthreads();
    cluster_stamp(pf, ST_POS, cluster);
    const int nlr = sm.counts[0], nlt = sm.counts[1];
    // ---- norms of the listed tracks' live lanes --------------------------
    for (int j = tid; j < nlt * K; j += NTB) {
      const int q = sm.lt[j / K], i = j - (j / K) * K;
      if ((sm.gvbits[q] >> i) & 1)
        sm.gn[i * Tc + q] = a.norms[sm.src[q * K + i]];
    }
    __syncthreads();
    cluster_stamp(pf, ST_NORMS, cluster);
    // ---- gallery distances on own gated (candidate, lane) pairs: the
    // block's max and its count; the votes pass gathers them again.  A
    // thread takes a (listed row, listed track) pair and its live lanes
    // (the dot of row r and lane (t, i) is dots[s*D + r, src[t*K + i]])
    float lmax = NEG;
    int npairs = 0;
    for (int j = tid; j < nlr * nlt; j += NTB) {
      const int k = j / nlt;
      const int r = sm.lr[k], q = sm.lt[j - k * nlt];
      if (!sm.cdt[r * nt + q]) continue;
      npairs += pair_lanes(a, drow + (size_t)r * W, sm.src, sm.gn, Tc, q,
                           sm.gvbits[q], sm.qn[r],
                           [&](float wv) { lmax = fmaxf(lmax, wv); });
    }
    if (npairs) atomicAdd(sm.npairs, npairs);
    const float bmax = block_max<NTB>(lmax, sm.redf);
    if (tid == 0) {
      sm.xd[par] = bmax;
      sm.xp[par] = *sm.npairs;
    }
    cluster.sync();
    ++barriers;
    if (tid < G) sm.gd[tid] = *cluster.map_shared_rank(&sm.xd[par], tid);
    __syncthreads();
    float max_dist = NEG;
    for (int h = 0; h < G; ++h) max_dist = fmaxf(max_dist, sm.gd[h]);
    cluster_stamp(pf, ST_DIST, cluster);
    // ---- votes and best-fit weights: a pair with no vote first, then the
    // gated pairs ------------------------------------------------------------
    for (int j = tid; j < D * nt; j += NTB)
      sm.Wm[j] = (0 >= a.min_votes && sm.valid[j / nt]) ? 0.0f : NEG;
    __syncthreads();
    for (int j = tid; j < nlr * nlt; j += NTB) {
      const int k = j / nlt;
      const int r = sm.lr[k], q = sm.lt[j - k * nlt];
      if (!sm.cdt[r * nt + q]) continue;
      int votes = 0;
      float weight = 0.0f;
      pair_lanes(a, drow + (size_t)r * W, sm.src, sm.gn, Tc, q, sm.gvbits[q],
                 sm.qn[r], [&](float wv) {
                   ++votes;
                   weight = weight + (max_dist - wv);
                 });
      sm.Wm[r * nt + q] =
          (votes >= a.min_votes && sm.valid[r]) ? weight : NEG;
    }
    __syncthreads();
    cluster_stamp(pf, ST_VOTES, cluster);
    // ---- argmaxes: each row's first max over own columns (one warp per
    // row), each own column's heaviest row (rs groups of rows, merged) ----
    for (int r = w; r < D; r += NWB) {
      float v = -INFINITY;
      int ix = T;
      for (int q = lane; q < nt; q += 32) {
        const float x = sm.Wm[r * nt + q];
        if (x > v) { v = x; ix = g + q * G; }
      }
      warp_argmax(v, ix);
      if (lane == 0) sm.rowpart[r] = make_float2(v, __int_as_float(ix));
    }
    for (int c = tid; c < rs * nt; c += NTB) {
      const int r0 = c / nt, q = c - r0 * nt;
      float v = -INFINITY;
      int ix = D;
      for (int r = r0; r < D; r += rs) {
        const float x = sm.Wm[r * nt + q];
        if (x > v) { v = x; ix = r; }
      }
      if (rs == 1) sm.bestq[q] = ix;
      else sm.colpart[c] = make_float2(v, __int_as_float(ix));
    }
    __syncthreads();
    if (rs > 1) {
      for (int q = tid; q < nt; q += NTB) {
        float v = -INFINITY;
        int ix = D;
        for (int r0 = 0; r0 < rs; ++r0) {
          const float2 p = sm.colpart[r0 * nt + q];
          const int pi = __float_as_int(p.y);
          if (p.x > v || (p.x == v && pi < ix)) { v = p.x; ix = pi; }
        }
        sm.bestq[q] = ix;
      }
    }
    cluster.sync();
    ++barriers;
    // the partials merged (ties to the lower column), G lanes per row, one
    // per block, U rows a lane with their remote reads in flight together;
    // a row wins its best track when it is that track's heaviest row, read
    // from its owner
    constexpr int RPW = 32 / G, U = 4;
    for (int r00 = w * RPW * U; r00 < D; r00 += NWB * RPW * U) {
      float v[U];
      int ix[U], bq[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int r = r00 + u * RPW + lane / G;
        v[u] = -INFINITY;
        ix[u] = T;
        if (r < D) {
          const float2 p =
              *cluster.map_shared_rank(&sm.rowpart[r], lane % G);
          v[u] = p.x;
          ix[u] = __float_as_int(p.y);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
        for (int o = G / 2; o > 0; o >>= 1) {
          const float ov = __shfl_xor_sync(FULL, v[u], o);
          const int oi = __shfl_xor_sync(FULL, ix[u], o);
          if (ov > v[u] || (ov == v[u] && oi < ix[u])) {
            v[u] = ov;
            ix[u] = oi;
          }
        }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int r = r00 + u * RPW + lane / G;
        bq[u] = -1;
        if (r < D && lane % G == 0 && v[u] > NEG)
          bq[u] = *cluster.map_shared_rank(&sm.bestq[vindex(ix[u])],
                                           vowner(ix[u]));
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int r = r00 + u * RPW + lane / G;
        if (r >= D || lane % G != 0) continue;
        const bool any = v[u] > NEG, win = any && bq[u] == r;
        sm.t1[r] = ix[u];
        sm.hasany[r] = any;
        sm.wins[r] = win;
        if (win && vowner(ix[u]) == g) sm.claimed[vindex(ix[u])] = 1;
        sm.rowopen[r] = sm.valid[r] && !any;
      }
    }
    __syncthreads();
    cluster_stamp(pf, ST_ARGMAX, cluster);
    // ---- positional auction on the remainder -----------------------------
    float pmax = -INFINITY;
    if (g == 0)
      for (int r = tid; r < D; r += NTB)
        pmax = fmaxf(pmax, diag_max(r, D, sm.valid, a.thr));
    for (int c = tid; c < rs * nt; c += NTB) {
      const int r0 = c / nt, q = c - r0 * nt;
      const bool open = sm.act[q] && !sm.claimed[q];
      for (int r = r0; r < D; r += rs) {
        const float pm = (open && sm.rowopen[r]) ? sm.P[r * nt + q] : 0.0f;
        sm.P[r * nt + q] = pm;
        pmax = fmaxf(pmax, pm);
      }
    }
    const float bspan = block_max<NTB>(pmax, sm.redf);
    if (tid == 0) sm.xs[par] = bspan;
    cluster.sync();
    ++barriers;
    if (tid < G) sm.gs[tid] = *cluster.map_shared_rank(&sm.xs[par], tid);
    __syncthreads();
    float amax = -INFINITY;
    for (int h = 0; h < G; ++h) amax = fmaxf(amax, sm.gs[h]);
    const float span = fmaxf(amax, 1e-6f);
    const float eps = span / (float)fmax(4096.0, 64.0 * D);
    int rounds = 0, bids = 0;
    cluster_auction<G, NTB, G>(cluster, auc, sm.P, sm.valid, D, T, d0, nd, g,
                               nt, a.thr, eps, &rounds, &bids, &barriers);
    // a row the auction gave a track matches where the track's owner block
    // holds its weight >= thr
    for (int r = tid; r < D; r += NTB) {
      const int c = sm.r2c[r];
      const int ptgt = min(max(c - D, 0), T - 1);
      const bool pos = sm.rowopen[r] && c >= D &&
          *cluster.map_shared_rank(&sm.wok[vindex(c - D)], vowner(c - D));
      const bool win = sm.wins[r];
      const bool m = win || pos;
      sm.matched[r] = m;
      sm.tgt[r] = win ? sm.t1[r] : ptgt;
      sm.vt[r] = win ? 0 : 1;
      sm.nr[r] = sm.valid[r] && !m;
    }
    __syncthreads();
    cluster_stamp(pf, ST_AUCTION, cluster);
    // ---- slots: the r-th new row takes the r-th free slot of the cluster,
    // in slot order, from every block's free mask -------------------------
    for (int i = tid; i < G * MW; i += NTB)
      sm.gmask[i] = *cluster.map_shared_rank(&sm.fmask[par * MW + i % MW],
                                             i / MW);
    if (tid < G) sm.gp[tid] = *cluster.map_shared_rank(&sm.xp[par], tid);
    __syncthreads();
    for (int wd = w; wd < TW; wd += NWB) {
      const int t = wd * 32 + lane, q = vindex(t);
      const bool f = t < T &&
          ((sm.gmask[vowner(t) * MW + (q >> 5)] >> (q & 31)) & 1);
      const unsigned m = __ballot_sync(FULL, f);
      if (lane == 0) sm.fw[wd] = m;
    }
    __syncthreads();
    if (w == 0) {
      warp_scan_inclusive(sm.nr, D);  // the rows' new ranks
    } else if (w == 1) {
      // a word of 32 slots per lane: the free slots before it (a warp
      // scan of the words' counts with a carry), then its own in order
      int carry = 0;
      for (int wd0 = 0; wd0 < TW; wd0 += 32) {
        const int wd = wd0 + lane;
        const unsigned m = wd < TW ? sm.fw[wd] : 0u;
        int c = __popc(m);
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(FULL, c, o);
          if (lane >= o) c += y;
        }
        int k = carry + c - __popc(m);
        for (unsigned x = m; x; x &= x - 1u)
          if (++k <= D) sm.flist[k - 1] = wd * 32 + __ffs(x) - 1;
        carry += __shfl_sync(FULL, c, 31);
      }
      if (lane == 0) sm.counts[3] = carry;
    }
    __syncthreads();
    const int n_new = sm.nr[D - 1], n_free = sm.counts[3];
    const bool ovf = n_new > n_free;
    // ---- Kalman step, ids, gallery bookkeeping, outputs: the block that
    // owns a row's slot (its matched track, else the free slot of its new
    // rank, else T-1) -------------------------------------------------------
    for (int r = tid; r < D; r += NTB) {
      const bool m = sm.matched[r];
      const int k = sm.nr[r];
      const int sl = m ? sm.tgt[r]
                       : (k >= 1 && k <= n_free) ? sm.flist[k - 1] : T - 1;
      sm.slot[r] = -1;
      if (vowner(sl) != g) continue;
      const int q = vindex(sl), i = sbase + q * sstep;
      const bool is_new = sm.valid[r] && !m;
      KFRow u[5];
      kalman_rows(a.kw, st.s, m, i, &sm.box[r * 5], u);
      // live lanes of the target row, quality-sorted eviction
      int galv = 0;
      if (m)
        for (int j = 0; j < K; ++j) galv |= (st.gv[i * K + j] > 0) << j;
      const int n_f = __popc(galv);
      float minq = 3.0e38f;
      for (int j = 0; j < K; ++j)
        if ((galv >> j) & 1) minq = fminf(minq, st.gq[i * K + j]);
      int evict_k = K;
      for (int j = K - 1; j >= 0; --j)
        if (((galv >> j) & 1) && st.gq[i * K + j] <= minq) evict_k = j;
      if (n_f >= K && evict_k < K) galv &= ~(1 << evict_k);
      // a brand-new track's first feature bypasses the collect gate
      const bool keep_new = sm.featok[r] && (is_new || sm.collect[r]);
      int free_k = 0;
      for (int j = K - 1; j >= 0; --j)
        if (!((galv >> j) & 1)) free_k = j;
      const int nl = keep_new ? (1 << free_k) : 0;
      sm.newlane[r] = nl;
      sm.finalv[r] = galv | nl;
      if (sm.valid[r] && !ovf) sm.slot[r] = q;  // the rows this block writes
      a.o_ids[s * D + r] = m ? st.s.tid[i] : nid + k;
      a.o_slots[s * D + r] = sl;
      a.o_vt[s * D + r] = sm.vt[r];
      a.o_new[s * D + r] = is_new;
      a.o_len[s * D + r] = m ? st.s.length[i] + 1 : 1;
      for (int j = 0; j < 5; ++j) a.o_pred[(s * D + r) * 5 + j] = u[j].mp;
    }
    __syncthreads();
    cluster_stamp(pf, ST_SLOTS, cluster);
    // ---- state write of own slots (dropped on overflow) -------------------
    if (a.recycle)
      for (int q = tid; q < nt; q += NTB)
        st.s.active[sbase + q * sstep] = sm.act[q];
    if (w == 0)
      warp_compact(D, [&](int r) { return sm.slot[r] >= 0; }, sm.wrows,
                   &sm.counts[2]);
    __syncthreads();
    const int nw = sm.counts[2];
    for (int k = tid; k < nw; k += NTB) {
      const int r = sm.wrows[k], q = sm.slot[r];
      const int i = sbase + q * sstep;
      const bool m = sm.matched[r];
      KFRow u[5];  // again: rows never share a slot they write
      kalman_rows(a.kw, st.s, m, i, &sm.box[r * 5], u);
      write_sort_columns(st.s, i, u, &sm.box[r * 5], sm.conf[r], epoch,
                         m ? st.s.length[i] + 1 : 1,
                         m ? st.s.tid[i] : nid + sm.nr[r]);
      const int nl = sm.newlane[r], fv = sm.finalv[r];
      for (int j = 0; j < K; ++j) {
        // quality and validity of every lane are rewritten for the slot;
        // the lane this row enters now holds chunk row s*D + r
        if ((nl >> j) & 1) {
          st.gq[i * K + j] = sm.qual[r];
          sm.src[q * K + j] = TK + s * D + r;
        }
        st.gv[i * K + j] = (fv >> j) & 1;
      }
      st.coll[i] = __popc(fv);
      st.vt[i] = sm.vt[r];
      st.lastfv[i] = sm.featok[r];
    }
    // feature rows of own slots: the newest feature, and the gallery lane
    // it enters, spread over the block
    if (vec)
      write_features<float4>(a, feat, sm.wrows, sm.slot, sm.newlane, nw, g);
    else
      write_features<float>(a, feat, sm.wrows, sm.slot, sm.newlane, nw, g);
    __syncthreads();
    // ---- the frame's counters ---------------------------------------------
    nid += n_new;
    if (g == 0 && tid == 0) {
      int pairs = 0;
      for (int h = 0; h < G; ++h) pairs += sm.gp[h];
      a.o_ovf[s] = ovf;
      a.o_stats[s * 3 + 0] = rounds;
      a.o_stats[s * 3 + 1] = bids;
      a.o_stats[s * 3 + 2] = pairs;
      if (pf) pf[NSTAMP] = barriers;
    }
    __syncthreads();
    cluster_stamp(pf, ST_WRITE, cluster);
  }
  if (a.st_smem) {
    __syncthreads();
    move_visual_slots(a, st, g, nt, false);
  }
  if (g == 0 && tid == 0) *a.nid = nid;
  // no block may leave while another can still read its shared memory
  cluster.sync();
}

// Where a block of the SORT cluster keeps its data: the storage bits (4 the
// column arrays, prices, owners and keys of all D+T columns; 2 its state
// slice; 1 its W slice in shared memory, in that order of preference, the
// rest in device memory) and the shared bytes per block; -1 when D is out
// of range.
int sort_storage(int D, int T, size_t* bytes) {
  if (D < 1 || D > MAX_ROWS || T < 1) return -1;
  const int Tc = (T + SORT_CLUSTER - 1) / SORT_CLUSTER;
  SortSmem probe;
  const int tiers[] = {7, 6, 4, 0};
  for (int s : tiers) {
    *bytes = probe.carve(nullptr, D, T, Tc, s & 4, s & 2, s & 1);
    if (*bytes <= MAX_SMEM) return s;
  }
  return -1;
}

// Launches kernel(a) as one cluster of G blocks of nt threads with `bytes`
// of dynamic shared memory on `stream`; returns the CUDA error.
template <class Args>
int launch_cluster(void (*kernel)(Args), const Args& a, int G, int nt,
                   size_t bytes, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess && G > 8)  // past the portable cluster size
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(G);
  cfg.blockDim = dim3(nt);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = G;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, a);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// Where a block of the VisualSORT cluster keeps its data: the storage bits
// (4 the auction's column arrays of all D+T columns; 2 its state slice; 1
// its [D, Tc] matrices in shared memory, the first combination that fits
// in that order of preference, the rest in device memory) and the shared
// bytes per block; -1 when the shape is out of range or nothing fits.
int visual_storage(int D, int T, int K, size_t* bytes) {
  *bytes = 0;
  if (D < 1 || D > MAX_ROWS || T < 1 || K < 1 || K > 31) return -1;
  const int Tc = (T + VISUAL_CLUSTER - 1) / VISUAL_CLUSTER;
  VisualSmem probe;
  for (int s = 7; s >= 0; --s) {
    *bytes = probe.carve(nullptr, D, T, K, Tc, s & 4, s & 2, s & 1);
    if (*bytes <= MAX_SMEM) return s;
  }
  return -1;
}

}  // namespace

// ----------------------------------------------------------------------------
// C interface (loaded with ctypes)
// ----------------------------------------------------------------------------

// The launch plan of the SORT kernel at D rows and T slots: plan[4] (host)
// receives the cluster size, the threads per block, the storage (see
// sort_storage) and the shared bytes per block.
extern "C" int fused_sort_plan(int D, int T, int* plan) {
  size_t bytes = 0;
  const int storage = sort_storage(D, T, &bytes);
  if (storage < 0) return (int)cudaErrorInvalidValue;
  plan[0] = SORT_CLUSTER;
  plan[1] = SORT_THREADS;
  plan[2] = storage;
  plan[3] = (int)bytes;
  return 0;
}

// One cluster of SORT_CLUSTER blocks.  W ([D, T] f32) and cols ([G, 16
// (D+T)] bytes) are the device-memory scratch of the W slices and the
// column arrays; each may be null where the plan keeps them in shared
// memory, and a launch whose plan needs a null one is refused.
extern "C" int fused_sort_launch(
    const void* box, const void* conf, const void* valid,
    void* mp, void* mv, void* cpp, void* cpv, void* cvv, void* pred, void* obs,
    void* tconf, void* active, void* last, void* length, void* tid, void* nid,
    void* o_ids, void* o_slots, void* o_pred, void* o_ovf, void* o_stats,
    void* W, void* cols,
    int C, int D, int T, int epoch0, int max_idle, int recycle,
    float thr, float min_conf, float pw2, float pw1, float vw10, float vw1,
    void* prof, void* stream) {
  size_t bytes = 0;
  const int storage = sort_storage(D, T, &bytes);
  if (storage < 0 || C < 1 || (!(storage & 1) && W == nullptr) ||
      (!(storage & 4) && cols == nullptr))
    return (int)cudaErrorInvalidValue;
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
  a.o_stats = (int*)o_stats; a.W = (float*)W; a.cols = (char*)cols;
  a.prof = (long long*)prof;
  a.C = C; a.D = D; a.T = T; a.epoch0 = epoch0; a.max_idle = max_idle;
  a.recycle = recycle;
  a.Dc = (D + SORT_CLUSTER - 1) / SORT_CLUSTER;
  a.Tc = (T + SORT_CLUSTER - 1) / SORT_CLUSTER;
  a.cols_smem = (storage & 4) != 0;
  a.st_smem = (storage & 2) != 0;
  a.w_smem = (storage & 1) != 0;
  a.thr = thr; a.min_conf = min_conf;
  a.kw = KalmanWeights{pw2, pw1, vw10, vw1};
  return launch_cluster(fused_sort_kernel, a, SORT_CLUSTER, SORT_THREADS,
                        bytes, stream);
}

// The launch plan of the VisualSORT kernel at D rows, T slots and K lanes:
// plan[4] (host) receives the cluster size, the threads per block, the
// storage (see visual_storage) and the shared bytes per block; returns
// non-zero where the launcher refuses the shape.
extern "C" int fused_visual_plan(int D, int T, int K, int* plan) {
  size_t bytes = 0;
  const int storage = visual_storage(D, T, K, &bytes);
  plan[0] = VISUAL_CLUSTER;
  plan[1] = VISUAL_THREADS;
  plan[2] = storage;
  plan[3] = (int)bytes;
  return storage < 0 ? (int)cudaErrorInvalidValue : 0;
}

// One cluster of VISUAL_CLUSTER blocks.  mats ([G, D, Tc] f32 twice, then
// [G, D, Tc] bytes) and cols ([G, 16 (D+T)] bytes) are the device-memory
// scratch of the matrices and the column arrays; each may be null where
// the plan keeps them in shared memory, and a launch whose plan needs a
// null one is refused.
extern "C" int fused_visual_launch(
    const void* box, const void* conf, const void* valid, const void* feat,
    const void* fvalid, const void* qual, const void* oa,
    void* mp, void* mv, void* cpp, void* cpv, void* cvv, void* pred, void* obs,
    void* tconf, void* active, void* last, void* length, void* tid,
    void* gf, void* gq, void* gv, void* coll, void* vt, void* lastf,
    void* lastfv, void* nid,
    void* o_ids, void* o_slots, void* o_pred, void* o_vt, void* o_new,
    void* o_len, void* o_ovf, void* o_stats,
    void* mats, void* cols, const void* dots, const void* norms,
    int C, int D, int T, int K, int F, int epoch0, int max_idle, int recycle,
    int min_track_len, int min_votes, int maha, int euclid, int n_cons,
    float thr, float pos_min_conf, float vis_thr, float min_area, float q_use,
    float q_collect, float oa_use, float oa_collect, float pw2, float pw1,
    float vw10, float vw1,
    const int* cons_dd, const float* cons_md, void* prof,
    void* stream) {
  size_t bytes = 0;
  const int storage = visual_storage(D, T, K, &bytes);
  if (storage < 0 || C < 1 || F < 1 || n_cons < 0 ||
      n_cons > MAX_CONSTRAINTS || (!(storage & 1) && mats == nullptr) ||
      (!(storage & 4) && cols == nullptr))
    return (int)cudaErrorInvalidValue;
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
  a.mats = (float*)mats; a.cols = (char*)cols;
  a.dots = (const float*)dots; a.norms = (const float*)norms;
  a.prof = (long long*)prof;
  a.C = C; a.D = D; a.T = T; a.K = K; a.F = F; a.epoch0 = epoch0;
  a.max_idle = max_idle; a.recycle = recycle; a.min_track_len = min_track_len;
  a.min_votes = min_votes; a.maha = maha; a.euclid = euclid;
  a.n_cons = n_cons;
  a.Dc = (D + VISUAL_CLUSTER - 1) / VISUAL_CLUSTER;
  a.Tc = (T + VISUAL_CLUSTER - 1) / VISUAL_CLUSTER;
  a.cols_smem = (storage & 4) != 0;
  a.st_smem = (storage & 2) != 0;
  a.m_smem = (storage & 1) != 0;
  a.thr = thr; a.pos_min_conf = pos_min_conf; a.vis_thr = vis_thr;
  a.min_area = min_area; a.q_use = q_use; a.q_collect = q_collect;
  a.oa_use = oa_use; a.oa_collect = oa_collect;
  a.kw = KalmanWeights{pw2, pw1, vw10, vw1};
  for (int c = 0; c < MAX_CONSTRAINTS; ++c) {
    a.cons_dd[c] = c < n_cons ? cons_dd[c] : 0;
    a.cons_md[c] = c < n_cons ? cons_md[c] : 0.0f;
  }
  return launch_cluster(fused_visual_kernel, a, VISUAL_CLUSTER,
                        VISUAL_THREADS, bytes, stream);
}
