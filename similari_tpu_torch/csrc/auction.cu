// The scene-batched SORT voting auction with private fallback columns, for
// sm_90a: one launch solves every scene, and each scene bids to
// convergence on the card.
//
// Replaces no TPU kernel: the JAX package's general step solves this
// auction in XLA (similari_tpu/ops/assignment.py `auction_lap_fallback`
// under the step's vmap).  Plain PyTorch version:
// similari_tpu_torch/ops/assignment.py::auction_lap_fallback_plain (the
// rounds `_fb_round` under `_run_rounds`); wrappers: `auction_lap_fallback`
// and `solve_voting`.  The eager rounds made some ten passes over the
// whole [S, D, T] weights a round, three rounds always, then a host check
// a round until no row was pending.
//
// What it computes, per scene s of the weights W [D, T] (the metric with
// `edges`' mask applied as it loads, where the masks are given), round for
// round as the plain version:
//   - eps = max(max(amax W, theta) - min(amin W, 0), 1e-6) * (1 / div),
//     div = max(4096, 64 D), D the padded row count; the product by the
//     rounded reciprocal is how PyTorch divides a CUDA tensor by a Python
//     number, so the plain rounds on the card take the same eps;
//   - each round, every pending row r (all rows at first) takes the
//     values v = W[r] - prices, their first max v1 at column j (NaN ranks
//     below every number) and v2, the max of the others (NaN if any other
//     is NaN, at least -1e30);
//   - a row with theta >= v1 takes its private fallback column for good;
//     the others bid prices[j] + (v1 - max(v2, theta)) + eps on j;
//   - a column takes its highest bid above -5e29, the lowest row among
//     equal bids; its owner is evicted and bids again in the next round,
//     as do the losers;
//   - a scene stops when no row is pending (a further round would change
//     nothing in it), or after `cap` = max(3, max_iters) rounds; a row
//     still pending keeps its own diagonal column.
// Output per row: D + its track column, or its row index (the fallback).
// Every float operation is the plain version's, rounded once
// (--fmad=false), so the columns are bit-equal to it.
//
// Counters: each scene's rounds go to `scene_rounds` where given, and the
// call's max(min_rounds, the batch's largest) is added to acc[0], the
// plain version's `auction.rounds` for the call: the last block to finish
// adds it (acc[1] holds the running max, acc[2] the finished blocks, both
// back to 0 after the call), so no host value is needed.
//
// Bound: bytes.  W is read once, 4 S D T bytes (420 MB at S=4096, D=128,
// T=200: 0.125 ms at 3.35 TB/s), and the columns written once, 8 S D.
//
// Design.  A scene is one block; its threads (128 to 512, from D) scan
// rows L lanes a row (8, 16 or 32, from T), in 16-byte loads where the
// rows are aligned, 4 loads in flight a lane.  Round 1 visits every row
// and takes the scene's min and max in the same pass: the values and
// first maxes do not depend on eps, only the bids do, so eps is a block
// reduction between the scan and the bids.  Later rounds re-read only the
// pending rows, whose list (`ft::warp_push`) is kept in shared memory with
// the rows' columns and scan results (25 bytes a row) and, where they fit,
// the columns' prices, owners, round keys and valid flags (17 bytes a
// column; else in device scratch, one slice a scene).  A bid is one
// 64-bit shared atomicMax on its column's key (ordered bid << 32 |
// inverted row); the winner reads its own key back, takes the column and
// clears the key, so keys need no round field and no reset pass.  W stays
// in device memory and is never copied.

#include <cuda_runtime.h>
#include <math.h>

#include "fused_track.cuh"

namespace {

constexpr int kMaxThreads = 512;
// dynamic shared bytes: the card's 232,448 a block less room for the
// static arrays
constexpr int kMaxSmem = 231424;
constexpr float kNeg = -1e30f;  // the plain version's fill
constexpr int kColumns = 1;     // storage bit: column arrays in shared
constexpr int kUnroll = 4;      // loads in flight a lane

struct Args {
  const float* w;              // [S, D, T]
  const unsigned char* rv;     // [S, D] row valid, or null (raw weights)
  const unsigned char* cv;     // [S, T] column valid, or null
  long long* out;              // [S, D]
  int* scene_rounds;           // [S] or null
  unsigned long long* acc;     // [3] or null
  unsigned char* scratch;      // column arrays a scene, when not shared
  int d, t, cap, min_rounds, storage;
  float theta, inv_div;
};

__host__ __device__ __forceinline__ int padded(int t) { return (t + 3) & ~3; }

__host__ __device__ __forceinline__ size_t align16(size_t n) {
  return (n + 15) & ~static_cast<size_t>(15);
}

// key u64, price f32, owner i32, valid u8 a column
__host__ __device__ __forceinline__ size_t col_bytes(int t) {
  return align16(17ull * padded(t));
}

// r2c, column, v1, v2 and the two pending lists (i32 / f32), valid u8 a row
__host__ __device__ __forceinline__ size_t row_bytes(int d) {
  return align16(25ull * d);
}

// the bid's order as an unsigned key: the higher bid, then the lower row
__device__ __forceinline__ unsigned long long pack(float bid, int row) {
  if (bid == 0.0f) bid = 0.0f;  // -0 as +0
  const unsigned b = __float_as_uint(bid);
  const unsigned o = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return (static_cast<unsigned long long>(o) << 32) |
         (0xFFFFFFFFu - static_cast<unsigned>(row));
}

// A lane's running first max (b1 at column i1), the max of its other
// values (b2) and its count of NaN values.
struct Top {
  float b1, b2;
  int i1, nan;
};

__device__ __forceinline__ void take(Top& tp, float v, int j) {
  const bool isn = v != v;
  tp.nan += isn;
  const float vn = isn ? -INFINITY : v;
  if (vn > tp.b1) {
    tp.b2 = tp.b1;
    tp.b1 = vn;
    tp.i1 = j;
  } else if (vn > tp.b2) {
    tp.b2 = vn;
  }
}

// The weight as `edges` makes it: the metric on valid pairs unless NaN,
// else 0 (an invalid row's loads are skipped: they are 0 already).
template <bool MASKED>
__device__ __forceinline__ float edge(float m, unsigned char col_ok) {
  return (!MASKED || (col_ok && m == m)) ? m : 0.0f;
}

struct Stats {
  float mx, mn;
  bool nan;
  __device__ __forceinline__ void add(float w) {
    mx = fmaxf(mx, w);
    mn = fminf(mn, w);
    nan |= w != w;
  }
};

// Scan row `wrow` with lane `sub` of L: columns 4 (VEC) or 1 at a time,
// kUnroll loads issued before any is used; in round 1 also the scene's
// min, max and NaN flag of the weights.
template <int L, bool VEC, bool MASKED, bool FIRST>
__device__ __forceinline__ void scan_row(const float* __restrict__ wrow,
                                         bool row_ok, const float* prices,
                                         const unsigned char* valid, int T,
                                         int sub, Top& tp, Stats& st) {
  if (VEC) {
    const int T4 = T >> 2;
    const float4* w4 = reinterpret_cast<const float4*>(wrow);
    const float4* p4 = reinterpret_cast<const float4*>(prices);
    const uchar4* c4 = reinterpret_cast<const uchar4*>(valid);
    for (int q0 = sub; q0 < T4; q0 += L * kUnroll) {
      float4 wv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int q = q0 + u * L;
        wv[u] = (q < T4 && (!MASKED || row_ok))
                    ? __ldg(w4 + q)
                    : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int q = q0 + u * L;
        if (q < T4) {
          const float4 p = p4[q];
          const uchar4 c = MASKED ? c4[q] : make_uchar4(1, 1, 1, 1);
          const float x0 = edge<MASKED>(wv[u].x, c.x);
          const float x1 = edge<MASKED>(wv[u].y, c.y);
          const float x2 = edge<MASKED>(wv[u].z, c.z);
          const float x3 = edge<MASKED>(wv[u].w, c.w);
          if (FIRST) {
            st.add(x0);
            st.add(x1);
            st.add(x2);
            st.add(x3);
          }
          take(tp, __fsub_rn(x0, p.x), 4 * q);
          take(tp, __fsub_rn(x1, p.y), 4 * q + 1);
          take(tp, __fsub_rn(x2, p.z), 4 * q + 2);
          take(tp, __fsub_rn(x3, p.w), 4 * q + 3);
        }
      }
    }
  } else {
    for (int q0 = sub; q0 < T; q0 += L * kUnroll) {
      float wv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int q = q0 + u * L;
        wv[u] = (q < T && (!MASKED || row_ok)) ? __ldg(wrow + q) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int q = q0 + u * L;
        if (q < T) {
          const float x = edge<MASKED>(wv[u], valid[q]);
          if (FIRST) st.add(x);
          take(tp, __fsub_rn(x, prices[q]), q);
        }
      }
    }
  }
}

template <int L, bool VEC, bool MASKED>
__global__ void __launch_bounds__(kMaxThreads)
auction_fb_kernel(const Args a) {
  const int s = blockIdx.x;
  const int D = a.d, T = a.t, Tp = padded(T);
  const int NTB = blockDim.x, NWB = NTB >> 5;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int gpw = 32 / L;  // rows a warp scans at once
  const int sub = lane % L, grp = lane / L;

  // column arrays first (16-byte aligned: float4 price loads), then rows
  extern __shared__ __align__(16) unsigned char smem[];
  const bool shared_cols = (a.storage & kColumns) != 0;
  unsigned char* cols = shared_cols
                            ? smem
                            : a.scratch + static_cast<long long>(s) *
                                              col_bytes(T);
  auto* key = reinterpret_cast<unsigned long long*>(cols);
  float* prices = reinterpret_cast<float*>(cols + 8ll * Tp);
  int* c2r = reinterpret_cast<int*>(cols + 12ll * Tp);
  unsigned char* valid = cols + 16ll * Tp;
  unsigned char* rows = smem + (shared_cols ? col_bytes(T) : 0);
  int* r2c = reinterpret_cast<int*>(rows);  // -1 pending, -2 fallback
  int* jb = r2c + D;                        // the row's first-max column
  float* vb = reinterpret_cast<float*>(jb + D);  // v1, then the bid
  float* v2 = vb + D;
  int* list = reinterpret_cast<int*>(v2 + D);  // [2, D] pending rows
  unsigned char* row_ok = reinterpret_cast<unsigned char*>(list + 2 * D);
  __shared__ int np[2];
  __shared__ float red_mx[kMaxThreads / 32], red_mn[kMaxThreads / 32];
  __shared__ int red_nan[kMaxThreads / 32];
  __shared__ float eps_s;

  const float* W = a.w + static_cast<long long>(s) * D * T;
  for (int j = tid; j < Tp; j += NTB) {
    key[j] = 0ull;
    prices[j] = 0.0f;
    c2r[j] = -1;
    valid[j] = j >= T                ? 0
               : MASKED ? (a.cv[static_cast<long long>(s) * T + j] != 0)
                        : 1;
  }
  for (int r = tid; r < D; r += NTB) {
    r2c[r] = -1;
    list[r] = r;
    row_ok[r] = MASKED ? (a.rv[static_cast<long long>(s) * D + r] != 0) : 1;
  }
  if (tid == 0) np[0] = D;
  __syncthreads();

  const int first_col = VEC ? 4 * sub : sub;
  Stats st{-INFINITY, INFINITY, false};
  int rounds = 0, cur = 0;
  while (true) {
    const int n = np[cur];
    if (n == 0 || rounds >= a.cap) break;
    const int* pl = list + cur * D;
    int* nl = list + (cur ^ 1) * D;

    // scan: each pending row's first max, its column and the max of the
    // others, L lanes a row
    for (int k0 = warp * gpw; k0 < n; k0 += NWB * gpw) {
      const int k = k0 + grp;
      const int r = k < n ? pl[k] : -1;
      Top tp{-INFINITY, -INFINITY, first_col < T ? first_col : 0x7fffffff,
             0};
      if (r >= 0) {
        const float* wrow = W + static_cast<long long>(r) * T;
        if (rounds == 0)
          scan_row<L, VEC, MASKED, true>(wrow, row_ok[r], prices, valid, T,
                                         sub, tp, st);
        else
          scan_row<L, VEC, MASKED, false>(wrow, row_ok[r], prices, valid, T,
                                          sub, tp, st);
      }
#pragma unroll
      for (int o = L / 2; o > 0; o >>= 1) {
        const float ob1 = __shfl_xor_sync(ft::FULL, tp.b1, o);
        const int oi1 = __shfl_xor_sync(ft::FULL, tp.i1, o);
        const float ob2 = __shfl_xor_sync(ft::FULL, tp.b2, o);
        const int on = __shfl_xor_sync(ft::FULL, tp.nan, o);
        const bool better = ob1 > tp.b1 || (ob1 == tp.b1 && oi1 < tp.i1);
        const float nb2 = better ? fmaxf(tp.b1, ob2) : fmaxf(ob1, tp.b2);
        if (better) {
          tp.b1 = ob1;
          tp.i1 = oi1;
        }
        tp.b2 = nb2;
        tp.nan += on;
      }
      if (r >= 0 && sub == 0) {
        int nan = tp.nan;
        if (nan > 0 && tp.b1 == -INFINITY) {
          // the first max may itself be a NaN: only the others count
          const long long at = static_cast<long long>(r) * T + tp.i1;
          const float x = (!MASKED || row_ok[r]) ? W[at] : 0.0f;
          const float v = __fsub_rn(edge<MASKED>(x, valid[tp.i1]),
                                    prices[tp.i1]);
          nan -= v != v;
        }
        jb[r] = tp.i1;
        vb[r] = tp.b1;
        v2[r] = nan > 0 ? __int_as_float(0x7fc00000) : fmaxf(tp.b2, kNeg);
      }
    }
    if (rounds == 0) {
      // the scene's eps, from round 1's pass over every weight
      float mx = st.mx, mn = st.mn;
      for (int o = 16; o > 0; o >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(ft::FULL, mx, o));
        mn = fminf(mn, __shfl_xor_sync(ft::FULL, mn, o));
      }
      const int any_nan = __any_sync(ft::FULL, st.nan);
      if (lane == 0) {
        red_mx[warp] = mx;
        red_mn[warp] = mn;
        red_nan[warp] = any_nan;
      }
      __syncthreads();
      if (tid == 0) {
        bool nan = false;
        for (int i = 0; i < NWB; ++i) {
          mx = fmaxf(mx, red_mx[i]);
          mn = fminf(mn, red_mn[i]);
          nan |= red_nan[i] != 0;
        }
        const float qnan = __int_as_float(0x7fc00000);
        const float wmax = nan ? qnan : fmaxf(mx, a.theta);
        const float wmin = nan ? qnan : fminf(mn, 0.0f);
        float span = __fsub_rn(wmax, wmin);
        span = span != span ? span : fmaxf(span, 1e-6f);
        eps_s = __fmul_rn(span, a.inv_div);
      }
    }
    if (tid == 0) np[cur ^ 1] = 0;
    __syncthreads();

    // bids: the fallback for good where theta >= v1, else a bid on the
    // first-max column, kept if it beats the column's best of the round
    const float eps = eps_s;
    for (int k = tid; k < n; k += NTB) {
      const int r = pl[k];
      const float v1 = vb[r];
      if (a.theta >= v1) {
        r2c[r] = -2;
      } else {
        const float b2 = v2[r];
        const float c = b2 != b2 ? b2 : fmaxf(b2, a.theta);
        const int j = jb[r];
        const float bid =
            __fadd_rn(__fadd_rn(prices[j], __fsub_rn(v1, c)), eps);
        vb[r] = bid;
        if (bid > kNeg * 0.5f) atomicMax(&key[j], pack(bid, r));
      }
    }
    __syncthreads();

    // the winners take their columns at their bids and clear the keys;
    // outbid owners and the losers bid in the next round
    for (int k0 = tid - lane; k0 < n; k0 += NTB) {  // warp by warp
      const int k = k0 + lane;
      int push = -1;
      if (k < n) {
        const int r = pl[k];
        if (r2c[r] != -2) {
          const int j = jb[r];
          const float bid = vb[r];
          // a key in device memory was raised by atomics at L2: read it
          // past L1
          const unsigned long long kj =
              shared_cols ? key[j] : __ldcg(&key[j]);
          if (bid > kNeg * 0.5f && kj == pack(bid, r)) {
            const int old = c2r[j];
            if (old >= 0) {
              r2c[old] = -1;
              push = old;
            }
            c2r[j] = r;
            prices[j] = bid;
            r2c[r] = j;
            key[j] = 0ull;
          } else {
            push = r;
          }
        }
      }
      ft::warp_push(push >= 0, push, nl, &np[cur ^ 1]);
    }
    __syncthreads();
    ++rounds;
    cur ^= 1;
  }

  const long long out0 = static_cast<long long>(s) * D;
  for (int r = tid; r < D; r += NTB) {
    const int c = r2c[r];
    a.out[out0 + r] = c >= 0 ? static_cast<long long>(D) + c : r;
  }
  if (tid == 0) {
    if (a.scene_rounds != nullptr) a.scene_rounds[s] = rounds;
    if (a.acc != nullptr) {
      atomicMax(&a.acc[1], static_cast<unsigned long long>(rounds));
      __threadfence();
      const unsigned long long done = atomicAdd(&a.acc[2], 1ull);
      if (done == gridDim.x - 1) {  // the call's last block
        __threadfence();
        const unsigned long long m = atomicExch(&a.acc[1], 0ull);
        const unsigned long long lo =
            static_cast<unsigned long long>(a.min_rounds);
        atomicAdd(&a.acc[0], m > lo ? m : lo);
        atomicExch(&a.acc[2], 0ull);
      }
    }
  }
}

template <int L, bool VEC, bool MASKED>
cudaError_t launch(const Args& a, int s, int threads, int smem,
                   cudaStream_t stream) {
  auto* kernel = auction_fb_kernel<L, VEC, MASKED>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned int>(s));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  e = cudaLaunchKernelEx(&cfg, kernel, a);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <int L>
cudaError_t launch_l(const Args& a, bool vec, bool masked, int s,
                     int threads, int smem, cudaStream_t stream) {
  if (vec)
    return masked ? launch<L, true, true>(a, s, threads, smem, stream)
                  : launch<L, true, false>(a, s, threads, smem, stream);
  return masked ? launch<L, false, true>(a, s, threads, smem, stream)
                : launch<L, false, false>(a, s, threads, smem, stream);
}

}  // namespace

// The launch plan at (s, d, t): plan[0] threads a block (128 to 512, from
// D and the lanes), plan[1] lanes a row (8, 16 or 32, from T, as
// `ft::cluster_auction` picks them), plan[2] storage (1: the column arrays
// in shared memory; 0: in device scratch of `auction_fb_scratch_bytes`),
// plan[3] shared bytes a block.  Returns cudaErrorInvalidValue where the
// rows alone do not fit in shared memory (D past ~9,200) or an axis is
// empty.
extern "C" int auction_fb_plan(int s, int d, int t, int* plan) {
  if (s < 1 || d < 1 || t < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int lanes = t > 256 ? 32 : t > 64 ? 16 : 8;
  int threads = 128;
  while (threads < kMaxThreads &&
         static_cast<long long>(threads) * 8 < static_cast<long long>(d) * lanes)
    threads *= 2;
  const size_t rb = row_bytes(d), cb = col_bytes(t);
  if (rb > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  const int storage = rb + cb <= static_cast<size_t>(kMaxSmem) ? kColumns : 0;
  plan[0] = threads;
  plan[1] = lanes;
  plan[2] = storage;
  plan[3] = static_cast<int>(storage ? rb + cb : rb);
  return 0;
}

// Device scratch bytes for the column arrays of s scenes outside shared
// memory.
extern "C" long long auction_fb_scratch_bytes(int s, int t) {
  return static_cast<long long>(s) * static_cast<long long>(col_bytes(t));
}

// w f32 [s, d, t]; rv [s, d] and cv [s, t] as bytes (0/1), both null for
// raw weights (no mask, no NaN rule); out int64 [s, d]; scene_rounds int32
// [s] or null; acc uint64 [3] (the rounds counter, see above) or null;
// scratch for the column arrays where `storage` has no bit 1, else null.
// cap = the rounds a scene may run, min_rounds the fewest a call counts;
// theta the new-track threshold and inv_div 1 / max(4096, 64 d), both
// rounded to f32; (threads, lanes, storage, smem) `auction_fb_plan`'s
// plan; vec 1 where w's rows are 16-byte aligned (t % 4 == 0 and an
// aligned base).  Launches on `stream`; returns the launch's CUDA error.
extern "C" int auction_fb_launch(const float* w, const unsigned char* rv,
                                 const unsigned char* cv, long long* out,
                                 int* scene_rounds, unsigned long long* acc,
                                 unsigned char* scratch, int s, int d, int t,
                                 int cap, int min_rounds, float theta,
                                 float inv_div, int threads, int lanes,
                                 int storage, int smem, int vec,
                                 cudaStream_t stream) {
  if (s < 1 || d < 1 || t < 1 || cap < 1 || threads < 32 ||
      threads > kMaxThreads || threads % 32 != 0 ||
      (lanes != 8 && lanes != 16 && lanes != 32) || storage < 0 ||
      storage > 1 || smem < 0 || smem > kMaxSmem ||
      static_cast<size_t>(smem) <
          row_bytes(d) + (storage ? col_bytes(t) : 0) ||
      (!storage && scratch == nullptr) || (rv == nullptr) != (cv == nullptr) ||
      (vec && (t % 4 != 0 || reinterpret_cast<size_t>(w) % 16 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.w = w;
  a.rv = rv;
  a.cv = cv;
  a.out = out;
  a.scene_rounds = scene_rounds;
  a.acc = acc;
  a.scratch = scratch;
  a.d = d;
  a.t = t;
  a.cap = cap;
  a.min_rounds = min_rounds;
  a.storage = storage;
  a.theta = theta;
  a.inv_div = inv_div;
  const bool masked = rv != nullptr;
  cudaError_t e;
  if (lanes == 32)
    e = launch_l<32>(a, vec != 0, masked, s, threads, smem, stream);
  else if (lanes == 16)
    e = launch_l<16>(a, vec != 0, masked, s, threads, smem, stream);
  else
    e = launch_l<8>(a, vec != 0, masked, s, threads, smem, stream);
  return static_cast<int>(e);
}
