// Gallery votes and the greedy BestFit claim of the general VisualSORT
// step, for sm_90a.
//
// Replaces no TPU kernel: the JAX package's general step computes the
// votes and BestFit in XLA (similari_tpu/trackers/visual_step.py
// `visual_votes` and the closed-form claim after it), which keeps its
// [S, D, T, K] intermediates fused; eager PyTorch wrote each of them to
// device memory, some 25 passes over [S, D, T, K] f32 and 10 over the
// [S, D, T] weights a step.  Plain PyTorch version:
// similari_tpu_torch/ops/visual_votes.py::visual_best_fit_plain; wrapper:
// `visual_best_fit`.
//
// What it computes, per scene s, from the gallery product dot [D, T*K]
// (f32, `torch.matmul` outside) and the norms the step takes with it
// (ops/distances.py::gram), in the plain version's operation order:
//   1. each lane (d, t, k): the distance w (euclidean: sqrt(clamp(qn + gn
//      - 2 dot, 0)); cosine: 1 - dot / (qn gn or 1)), the threshold, and
//      the gates use_gate[d] & compat[d, t] & track_gate[t] &
//      feat_valid[t, k];
//   2. the scene's largest passing distance M over every lane, -1e30 for
//      a lane that does not pass (a max: exact in any order);
//   3. each (d, t): votes, the weight sum over k in lane order from 0 of
//      (passing ? M - w_k : 0), eligible = votes >= min_votes &
//      det_valid[d], and val = eligible ? weight : -1e30;
//   4. t1[d] = the first max of val over t, has_any[d] = any eligible;
//   5. best_query[t] = the first max of val over d; wins[d] = has_any[d] &
//      best_query[t1[d]] == d;
//   6. claimed[t] = wins[b] & t1[b] == t with b = best_query[t]: track t
//      is claimed iff its heaviest row wins it, which is the plain step's
//      scatter of the winners' t1 without the scatter.
// First max: NaN ranks below every number and -0 equals +0, as in
// ops/assignment.py::first_argmax; the lowest index wins a tie.  Every
// float operation is the plain version's, rounded once (--fmad=false,
// IEEE sqrt and division), so the outputs are bit-equal to it.
//
// Bound: bytes.  The inputs are read once (dot dominates: 4 S D T K
// bytes, 315 MB at S=1024, D=128, T=200, K=3) and the outputs written
// once; 0.096 ms at 3.35 TB/s there.  No [S, D, T, K] or [S, D, T]
// tensor is written.
//
// Design.  Step 2 is a max over the whole scene and must be complete
// before any weight of step 3 exists, and the [D, T] weights of a large
// scene do not fit in shared memory (256 x 512 x 4 B = 512 KB).  So the
// kernel makes two passes and keeps no weight tile:
//   - pass A reads each gated lane's product once, computes its distance
//     and the max, and records in a bit mask which (d, t) pairs have a
//     passing lane (one 32-bit word per row and 32 tracks);
//   - pass B forms every weight from that mask: a pair without a passing
//     lane weighs 0 with 0 votes, so only the passing pairs, a few a row
//     on tracking traffic, recompute their distances, bit for bit; each
//     weight goes at once into packed first-max keys (ordered float << 32
//     | ~index), a row key per detection and a column key per track.
// A scene runs on one cluster of G blocks of 512 threads, its rows split
// into G contiguous slices; G is the smallest power of two that puts two
// blocks on every SM (1 at S=1024, 2 at S=256, 8 for one scene), at most
// 8 and at most D.  In pass A a warp takes items of 32 tracks (one a
// lane, its K lanes read as K consecutive floats) by 8 rows.  In pass B a
// warp owns 8 rows and visits all tracks, so a row key is one warp's
// (shuffles, no atomics); the column keys take one 64-bit atomicMax per
// (track, 8 rows).  (Row keys
// that every warp of a row updated with 64-bit shared atomics made the
// kernel 0.07 ms slower at S=1024, D=128, T=200 on an H100; staging the
// products in shared memory with cp.async to keep more loads in flight
// gained nothing.)  The blocks exchange the max, the column keys and
// their rows' t1 and wins through distributed shared memory.  The mask
// and the column keys take shared memory in that order of preference
// where not both fit (the storage bits 2, 1 of `visual_votes_plan`):
// without the mask pass B recomputes every pair, and column keys that do
// not fit live in device memory, one array per scene, read after the
// cluster barrier past L1.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;  // rows of a warp's item
constexpr int kMaxCluster = 8;
// dynamic shared bytes: the card's 232,448 a block less room for the
// static arrays
constexpr int kMaxSmem = 231424;
constexpr float kNeg = -1e30f;  // the plain version's fill
constexpr int kEuclidean = 0;
// storage bits: what lives in shared memory
constexpr int kMask = 2, kColumns = 1;

struct Args {
  const float* dot;                 // [S, D, T*K]
  const float* qn;                  // [S, D]
  const float* gn;                  // [S, T*K]
  const unsigned char* use_gate;    // [S, D]
  const unsigned char* compat;      // [S, D, T], strides below, t stride 1
  const unsigned char* track_gate;  // [S, T]
  const unsigned char* feat_valid;  // [S, T, K]
  const unsigned char* det_valid;   // [S, D]
  long long compat_s, compat_d;     // compat's scene and row strides
  long long* t1;                    // [S, D]
  unsigned char* has_any;           // [S, D]
  unsigned char* wins;              // [S, D]
  unsigned char* claimed;           // [S, T]
  unsigned long long* colkey;       // [S, T] scratch when not in shared
  int d, t, k, kind, min_votes, storage;
  float threshold;
};

// Shared bytes of one block of a G-block cluster with `storage`: its
// rows' keys, t1, has_any and wins; the pass mask; the column keys.
size_t smem_bytes(int d, int t, int G, int storage) {
  const size_t per = (d + G - 1) / G;
  const size_t ctiles = (t + 31) / 32;
  size_t bytes = per * (8 + 4 + 1 + 1);
  if (storage & kMask) bytes += sizeof(unsigned int) * per * ctiles;
  if (storage & kColumns) bytes += sizeof(unsigned long long) * t;
  return bytes;
}

// first_argmax's order as an unsigned key: NaN as -inf, -0 as +0
__device__ __forceinline__ unsigned long long pack(float v, int index) {
  if (v != v) v = -INFINITY;
  if (v == 0.0f) v = 0.0f;
  const unsigned int u = __float_as_uint(v);
  const unsigned int o = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(o) << 32) |
         (0xFFFFFFFFu - static_cast<unsigned int>(index));
}

__device__ __forceinline__ int unpack(unsigned long long key) {
  return static_cast<int>(0xFFFFFFFFu - static_cast<unsigned int>(key));
}

__device__ __forceinline__ unsigned long long max64(unsigned long long a,
                                                    unsigned long long b) {
  return a > b ? a : b;
}

// One lane's distance; *ok whether it passes the threshold, in the plain
// version's order (ops/distances.py::from_gram).
__device__ __forceinline__ float lane_distance(float dot, float qn, float gn,
                                               const Args& a, bool* ok) {
  if (a.kind == kEuclidean) {
    float d2 = __fsub_rn(__fadd_rn(qn, gn), __fmul_rn(2.0f, dot));
    d2 = d2 < 0.0f ? 0.0f : d2;  // torch.clamp(min=0): NaN stays NaN
    const float w = __fsqrt_rn(d2);
    *ok = w <= a.threshold;
    return w;
  }
  const float denom = __fmul_rn(qn, gn);
  const float sim = __fdiv_rn(dot, denom > 0.0f ? denom : 1.0f);
  *ok = sim >= a.threshold;
  return __fsub_rn(1.0f, sim);
}

__global__ void __launch_bounds__(kThreads)
visual_votes_kernel(const Args a) {
  cg::cluster_group cluster = cg::this_cluster();
  const int G = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int s = blockIdx.x / G;
  const int D = a.d, T = a.t, K = a.k, TK = T * K;
  const int per = (D + G - 1) / G;
  const int r0 = min(D, rank * per), r1 = min(D, r0 + per);
  const int rows = r1 - r0;
  const int ctiles = (T + 31) / 32;
  const int rgroups = (rows + kRows - 1) / kRows;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // shared memory in smem_bytes' order: 8-byte arrays first
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* p = smem;
  auto* rowkey = reinterpret_cast<unsigned long long*>(p);
  p += 8ull * per;
  unsigned long long* colkey_s = nullptr;
  if (a.storage & kColumns) {
    colkey_s = reinterpret_cast<unsigned long long*>(p);
    p += 8ull * T;
  }
  unsigned int* mask = nullptr;  // [rows, ctiles] pass bits
  if (a.storage & kMask) {
    mask = reinterpret_cast<unsigned int*>(p);
    p += 4ull * per * ctiles;
  }
  int* t1_s = reinterpret_cast<int*>(p);
  p += 4ull * per;
  unsigned char* any_s = p;
  unsigned char* wins_s = p + per;
  __shared__ float warp_max[kWarps];
  __shared__ float block_max;
  __shared__ unsigned long long warp_rows[kWarps][kRows];
  unsigned long long* colkey =
      colkey_s ? colkey_s : a.colkey + static_cast<long long>(s) * T;

  const float* dot = a.dot + static_cast<long long>(s) * D * TK;
  const float* qn = a.qn + static_cast<long long>(s) * D;
  const float* gn = a.gn + static_cast<long long>(s) * TK;
  const unsigned char* use_gate = a.use_gate + static_cast<long long>(s) * D;
  const unsigned char* compat = a.compat + s * a.compat_s;
  const unsigned char* track_gate =
      a.track_gate + static_cast<long long>(s) * T;
  const unsigned char* feat_valid =
      a.feat_valid + static_cast<long long>(s) * TK;
  const unsigned char* det_valid = a.det_valid + static_cast<long long>(s) * D;

  // shared column keys are this block's; device-memory ones the scene's,
  // cleared in slices by the cluster's blocks
  const int cper = (T + G - 1) / G;
  const int c0 = colkey_s ? 0 : min(T, rank * cper);
  const int c1 = colkey_s ? T : min(T, c0 + cper);
  for (int t = c0 + tid; t < c1; t += kThreads) colkey[t] = 0ull;

  // pass A: the gated lanes' distances, the scene's largest passing one
  // and the pairs with a passing lane; a warp's item is 32 tracks by
  // kRows rows
  float m = -INFINITY;
  for (int item = warp; item < ctiles * rgroups; item += kWarps) {
    const int ct = item % ctiles;
    const int t = ct * 32 + lane;
    const int d0 = r0 + (item / ctiles) * kRows, n = min(r1 - d0, kRows);
    const bool col_ok = t < T && track_gate[t] != 0;
    for (int r = 0; r < n; ++r) {
      const int d = d0 + r;
      bool passed = false;
      if (col_ok && use_gate[d] != 0 && compat[d * a.compat_d + t] != 0) {
        const float* row = dot + static_cast<long long>(d) * TK + t * K;
        for (int k = 0; k < K; ++k) {
          bool ok = false;
          float w = 0.0f;
          if (feat_valid[t * K + k] != 0)
            w = lane_distance(row[k], qn[d], gn[t * K + k], a, &ok);
          m = fmaxf(m, ok ? w : kNeg);
          passed |= ok;
        }
      } else {
        m = fmaxf(m, kNeg);
      }
      const unsigned int word = __ballot_sync(0xFFFFFFFFu, passed);
      if (mask != nullptr && lane == 0) mask[(d - r0) * ctiles + ct] = word;
    }
  }
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xFFFFFFFFu, m, off));
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  if (tid == 0) {
    float b = -INFINITY;
    for (int w = 0; w < kWarps; ++w) b = fmaxf(b, warp_max[w]);
    block_max = b;
  }
  cluster.sync();
  float M = -INFINITY;
  for (int r = 0; r < G; ++r)
    M = fmaxf(M, *cluster.map_shared_rank(&block_max, r));

  // pass B: the weights, reduced into row and column first-max keys.  A
  // warp owns kRows rows and visits every 32 tracks, so its row keys need
  // no atomics.  A pair without a passing lane weighs 0 with 0 votes; an
  // ineligible pair is -1e30, so a tile's row with no eligible pair keys
  // its lowest track, and a lane's ineligible rows their lowest
  for (int rg = warp; rg < rgroups; rg += kWarps) {
    const int d0 = r0 + rg * kRows, n = min(r1 - d0, kRows);
    if (lane < kRows) warp_rows[warp][lane] = 0ull;
    unsigned int any_rows = 0;  // bit r: row r has an eligible pair
    __syncwarp();
    for (int ct = 0; ct < ctiles; ++ct) {
      const int t = ct * 32 + lane;
      const bool in = t < T;
      const bool col_ok = in && track_gate[t] != 0;
      unsigned long long cbest = 0ull;
      int first_out = -1;  // the lane's first ineligible row
      for (int r = 0; r < n; ++r) {
        const int d = d0 + r;
        const unsigned int word =
            mask != nullptr ? mask[(d - r0) * ctiles + ct] : 0xFFFFFFFFu;
        bool eligible = false;
        float weight = 0.0f;
        if (in) {
          int votes = 0;
          if (((word >> lane) & 1u) && col_ok && use_gate[d] != 0 &&
              compat[d * a.compat_d + t] != 0) {
            const float* row = dot + static_cast<long long>(d) * TK + t * K;
            for (int k = 0; k < K; ++k) {
              bool ok = false;
              float w = 0.0f;
              if (feat_valid[t * K + k] != 0)
                w = lane_distance(row[k], qn[d], gn[t * K + k], a, &ok);
              votes += ok;
              weight = __fadd_rn(weight, ok ? __fsub_rn(M, w) : 0.0f);
            }
          }
          eligible = votes >= a.min_votes && det_valid[d] != 0;
          if (eligible)
            cbest = max64(cbest, pack(weight, d));
          else if (first_out < 0)
            first_out = d;
        }
        unsigned long long rkey;
        if (__ballot_sync(0xFFFFFFFFu, eligible) != 0u) {
          any_rows |= 1u << r;
          rkey = in ? pack(eligible ? weight : kNeg, t) : 0ull;
          for (int off = 16; off > 0; off >>= 1)
            rkey = max64(rkey, __shfl_xor_sync(0xFFFFFFFFu, rkey, off));
        } else {
          rkey = pack(kNeg, ct * 32);
        }
        if (lane == 0) warp_rows[warp][r] = max64(warp_rows[warp][r], rkey);
      }
      if (in) {
        if (first_out >= 0) cbest = max64(cbest, pack(kNeg, first_out));
        atomicMax(&colkey[t], cbest);
      }
    }
    __syncwarp();
    if (lane < n) {
      rowkey[d0 - r0 + lane] = warp_rows[warp][lane];
      any_s[d0 - r0 + lane] = (any_rows >> lane) & 1u;
    }
    __syncwarp();
  }
  cluster.sync();

  // a track's heaviest row: the max of the blocks' column keys
  auto best_query = [&](int t) -> int {
    if (colkey_s == nullptr) return unpack(__ldcg(&colkey[t]));
    unsigned long long key = 0ull;
    for (int r = 0; r < G; ++r)
      key = max64(key, cluster.map_shared_rank(colkey_s, r)[t]);
    return unpack(key);
  };

  const long long out0 = static_cast<long long>(s) * D;
  for (int i = tid; i < rows; i += kThreads) {
    const int d = r0 + i;
    const int t1 = unpack(rowkey[i]);
    const bool win = any_s[i] != 0 && best_query(t1) == d;
    t1_s[i] = t1;
    wins_s[i] = win;
    a.t1[out0 + d] = t1;
    a.has_any[out0 + d] = any_s[i];
    a.wins[out0 + d] = win;
  }
  cluster.sync();

  // claimed: each block writes a slice of the tracks, reading the owner
  // block's t1 and wins of the track's heaviest row
  for (int t = rank * cper + tid; t < min(T, (rank + 1) * cper);
       t += kThreads) {
    const int b = best_query(t);
    const int owner = b / per;
    const int i = b - owner * per;
    const bool claim = cluster.map_shared_rank(wins_s, owner)[i] != 0 &&
                       cluster.map_shared_rank(t1_s, owner)[i] == t;
    a.claimed[static_cast<long long>(s) * T + t] = claim;
  }
  // no block leaves while another may read its shared memory
  cluster.sync();
}

}  // namespace

// The launch plan at (s, d, t): plan[0] = cluster size G, plan[1] =
// storage bits (2 pass mask, 1 column keys in shared memory: the first
// combination that fits, from 3 down; without column scratch only those
// with bit 1), plan[2] = shared bytes a block.  Returns the device
// query's CUDA error, or cudaErrorInvalidValue when nothing fits.
extern "C" int visual_votes_plan(int s, int d, int t, int have_scratch,
                                 int* plan) {
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  int G = 1;
  while (G < kMaxCluster && 2 * G <= d &&
         static_cast<long long>(s) * G < 2LL * sms)
    G *= 2;
  for (int storage = 3; storage >= 0; --storage) {
    if (!have_scratch && !(storage & kColumns)) continue;
    const size_t bytes = smem_bytes(d, t, G, storage);
    if (bytes <= kMaxSmem) {
      plan[0] = G;
      plan[1] = storage;
      plan[2] = static_cast<int>(bytes);
      return 0;
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// dot f32 [s, d, t*k], qn [s, d], gn [s, t*k], the gates as bytes (0/1)
// use_gate [s, d], compat [s, d, t] at element strides (compat_s,
// compat_d, 1), track_gate [s, t], feat_valid [s, t, k], det_valid [s, d];
// outputs t1 int64 [s, d], has_any, wins [s, d] and claimed [s, t] as
// bytes; colkey int64 [s, t] scratch for column keys outside shared
// memory, or null.  kind 0 euclidean, 1 cosine.  (cluster, storage,
// smem) is `visual_votes_plan`'s plan at (s, d, t); a plan without column
// keys in shared memory needs the scratch.  Launches on `stream`;
// returns the launch's CUDA error.
extern "C" int visual_votes_launch(
    const float* dot, const float* qn, const float* gn,
    const unsigned char* use_gate, const unsigned char* compat,
    const unsigned char* track_gate, const unsigned char* feat_valid,
    const unsigned char* det_valid, long long* t1, unsigned char* has_any,
    unsigned char* wins, unsigned char* claimed, unsigned long long* colkey,
    long long compat_s, long long compat_d, int s, int d, int t, int k,
    int kind, int min_votes, float threshold, int cluster, int storage,
    int smem, cudaStream_t stream) {
  if (s <= 0 || d <= 0 || t <= 0 || k <= 0 || cluster < 1 ||
      cluster > kMaxCluster || storage < 0 || storage > 3 || smem < 0 ||
      smem > kMaxSmem ||
      static_cast<size_t>(smem) < smem_bytes(d, t, cluster, storage) ||
      (!(storage & kColumns) && colkey == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = cluster;

  Args a;
  a.dot = dot;
  a.qn = qn;
  a.gn = gn;
  a.use_gate = use_gate;
  a.compat = compat;
  a.track_gate = track_gate;
  a.feat_valid = feat_valid;
  a.det_valid = det_valid;
  a.compat_s = compat_s;
  a.compat_d = compat_d;
  a.t1 = t1;
  a.has_any = has_any;
  a.wins = wins;
  a.claimed = claimed;
  a.colkey = colkey;
  a.d = d;
  a.t = t;
  a.k = k;
  a.kind = kind;
  a.min_votes = min_votes;
  a.storage = storage;
  a.threshold = threshold;
  cudaError_t e = cudaFuncSetAttribute(
      visual_votes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned int>(s) * G);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = G;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, visual_votes_kernel, a);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}
