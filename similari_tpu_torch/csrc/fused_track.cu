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
// gallery_dots.cu, which computes its gallery product.  It runs on ONE
// thread block of 1024 threads: __syncthreads() between phases, the
// tracker state read and written in place in device memory (it stays
// L2-resident: 4.2 MB at T=512, K=3, F=512), per-row and per-track vectors
// in shared memory, and the [D, T] matrices in global scratch buffers the
// wrapper allocates.
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
// Bound at the main-path shapes (D=128, T=512, K=3, F=512): the state
// moves about 8.4 MB per launch (read + write), 1.3 us each way at 3.35
// TB/s, and the ~30,000 gated pairs per frame are L2 gathers.  Neither is
// the limit: the single block's serial phases are.  On an H100 (PERF.md
// section 5, from the `prof` phase stamps) a frame takes ~0.22 ms: the
// [D, T] votes, positional and argmax passes ~60%, the auction rounds
// (each a few block barriers) ~15%, the state write ~12%, the gallery
// gather ~10%; the product adds ~0.06 ms per chunk.  Unassigned rows only
// are re-scanned each auction round; gallery pairs are listed once per
// frame from compacted (candidate, lane) lists.
//
// Ids must match the reference exactly: ties go to the lowest index
// everywhere, the r-th new detection takes the r-th free slot, and on
// overflow (n_new > n_free) the frame writes nothing while next_id still
// advances.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "fused_track.cuh"

namespace cg = cooperative_groups;
using namespace ft;

namespace {

constexpr int MAX_CONSTRAINTS = 8;
constexpr int MAX_SMEM = 232448;  // bytes a block may use on sm_90
constexpr int SORT_CLUSTER = 8;  // fused SORT: blocks per cluster (G)
constexpr int SORT_THREADS = 512;  // and threads per block

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

// A phase boundary, from %globaltimer (ns), into prof[i] when prof is not
// null.  A stamp first waits for the whole block, so a profiled launch
// runs each phase on its own; an unprofiled launch (prof null) runs no
// extra barrier.
__device__ __forceinline__ void stamp(long long* prof, int i) {
  if (prof == nullptr) return;  // uniform across the block
  __syncthreads();
  if (threadIdx.x == 0) {
    long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    prof[i] = t;
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
  constexpr int NTB = SORT_THREADS, NWB = NTB / 32, G = SORT_CLUSTER;
  extern __shared__ __align__(16) char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  SortSmem sm;
  sm.carve(smem, a.D, a.T, a.Tc, a.cols_smem, a.st_smem, a.w_smem);
  const int D = a.D, T = a.T, N = D + T, Dc = a.Dc, Tc = a.Tc;
  const int g = (int)cluster.block_rank();
  const int d0 = g * Dc, nd = max(min(D - d0, Dc), 0);
  const int t0 = g * Tc, nt = max(min(T - t0, Tc), 0);
  const int tid = threadIdx.x, lane = lane_id(), w = warp_id();
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
    // ---- auction (Jacobi rounds; see forward_auction) -------------------
    for (int j = tid; j < N; j += NTB) {
      sm.prices[j] = 0.0f;
      sm.c2r[j] = -1;
      sm.key[j] = 0ull;
    }
    if (tid == 0) sm.np[0] = 0;
    __syncthreads();
    for (int r = tid; r < D; r += NTB) {
      sm.r2c[r] = sm.valid[r] ? -1 : 0;
      if (sm.valid[r]) sm.plist[atomicAdd(&sm.np[0], 1)] = r;
    }
    __syncthreads();
    // lanes per bidding row in the scan of own columns
    const int ncol = nd + nt;
    const int L = ncol > 256 ? 32 : ncol > 64 ? 16 : 8;
    const int sub = lane % L, grp = lane / L, gpw = 32 / L;
    int rounds = 0, bids = 0;
    while (true) {
      const int cur = rounds & 1, nxt = cur ^ 1;
      const int np = sm.np[cur];
      if (np == 0 || rounds >= MAX_AUCTION_ROUNDS) break;
      bids += np;
      const int* pl = sm.plist + cur * D;
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
              v = (j == r ? thr : 0.0f) - sm.prices[j];
            } else {
              const int t = q - nd;
              j = D + t0 + t;
              v = Wl[r * nt + t] - sm.prices[j];
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
          sm.part[cur * D + r] = make_float4(b1, __int_as_float(i1), b2, 0.0f);
      }
      cluster.sync();
      ++barriers;
      // every block merges every bidding row's partials in block order and
      // keeps, per column, the best key of the round
      for (int k = tid; k < np; k += NTB) {
        const int r = pl[k];
        float4 p[G];
#pragma unroll
        for (int h = 0; h < G; ++h)
          p[h] = *cluster.map_shared_rank(&sm.part[cur * D + r], h);
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
        const float bid = sm.prices[i1] + (b1 - b2) + eps;
        sm.jb[r] = i1;
        sm.bid[r] = bid;
        if (bid > NEG * 0.5f) atomicMax(&sm.key[i1], bid_key(rounds, bid, r));
      }
      if (tid == 0) sm.np[nxt] = 0;
      __syncthreads();
      // winners take their columns at their bids; outbid owners and the
      // losers bid in the next round
      int* nl = sm.plist + nxt * D;
      for (int k = tid; k < np; k += NTB) {
        const int r = pl[k], j = sm.jb[r];
        const float bid = sm.bid[r];
        if (bid > NEG * 0.5f && sm.key[j] == bid_key(rounds, bid, r)) {
          const int old = sm.c2r[j];
          if (old >= 0) {
            sm.r2c[old] = -1;
            nl[atomicAdd(&sm.np[nxt], 1)] = old;
          }
          sm.c2r[j] = r;
          sm.prices[j] = bid;
          sm.r2c[r] = j;
          const int t = j - D - t0;
          if (t >= 0 && t < nt) sm.wok[t] = Wl[r * nt + t] >= thr;
        } else {
          nl[atomicAdd(&sm.np[nxt], 1)] = r;
        }
      }
      __syncthreads();
      ++rounds;
    }
    // the owners' match flags are read across the cluster below
    cluster.sync();
    ++barriers;
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

// Phase boundaries of a VisualSORT frame, stamped into
// VisualArgs::prof[s * NSTAMP + k] (see `stamp`).
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
    stamp(a.prof, s * NSTAMP + ST_START);
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
    stamp(a.prof, s * NSTAMP + ST_ROWS);
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
    stamp(a.prof, s * NSTAMP + ST_LISTS);
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
    stamp(a.prof, s * NSTAMP + ST_POS);
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
    stamp(a.prof, s * NSTAMP + ST_NORMS);
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
    stamp(a.prof, s * NSTAMP + ST_DIST);
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
    stamp(a.prof, s * NSTAMP + ST_VOTES);
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
    stamp(a.prof, s * NSTAMP + ST_ARGMAX);
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
    stamp(a.prof, s * NSTAMP + ST_AUCTION);
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
      kalman_rows(a.kw, a, m, sl, &sm.box[tid * 5], u);
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
    stamp(a.prof, s * NSTAMP + ST_SLOTS);
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
    stamp(a.prof, s * NSTAMP + ST_WRITE);
  }
}

// Where a block of the SORT cluster keeps its data: the storage bits (4 the
// column arrays, prices, owners and keys of all D+T columns; 2 its state
// slice; 1 its W slice in shared memory, in that order of preference, the
// rest in device memory) and the shared bytes per block; -1 when D is out
// of range.
int sort_storage(int D, int T, size_t* bytes) {
  if (D < 1 || D > NT || T < 1) return -1;
  const int Tc = (T + SORT_CLUSTER - 1) / SORT_CLUSTER;
  SortSmem probe;
  const int tiers[] = {7, 6, 4, 0};
  for (int s : tiers) {
    *bytes = probe.carve(nullptr, D, T, Tc, s & 4, s & 2, s & 1);
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
  cudaError_t e = cudaFuncSetAttribute(
      fused_sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(SORT_CLUSTER);
  cfg.blockDim = dim3(SORT_THREADS);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = SORT_CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, fused_sort_kernel, a);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// The launch of the VisualSORT kernel at D rows, T slots and K lanes:
// plan[2] (host) receives the threads of its one block and its shared
// bytes; returns non-zero where the launcher refuses the shape.
extern "C" int fused_visual_plan(int D, int T, int K, int* plan) {
  VisualSmem probe;
  const size_t bytes = probe.carve(nullptr, D, T, K);
  plan[0] = NT;
  plan[1] = (int)bytes;
  if (D < 1 || D > NT || T < 1 || K < 1 || K > 31 || bytes > MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  return 0;
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
