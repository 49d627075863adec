// Rotated-box IoU / intersection area with `too_far` tile skipping, for
// sm_90a.
//
// Replaces the TPU kernel similari_tpu/ops/pallas_clip.py:96 `_pair_block`
// (with `_pair_integral` :57).  Plain PyTorch version:
// similari_tpu_torch/ops/clip.py::pair_block_plain; wrapper: `clip_pairs`.
//
// What it computes, per (detection, track) pair of clip columns
// (xc, yc, r1x, r1y, r2x, r2y, radius, area): 0 when the enclosing circles
// do not meet, else the intersection area of the two rotated rectangles by
// the Green's-theorem boundary integral (each edge of one quad clipped to
// the other by Liang-Barsky, two passes, the second with the collinear
// tie-break), then the IoU with a `union > 0` guard, or the raw area.
//
// Design.  A block of 256 threads owns a 32 x 32 tile of pairs, the unit
// the skip works on.  The tile's 32 + 32 clip columns are staged in shared
// memory; each thread runs the ~10-flop `too_far` test for four pairs and
// the block lists the tile's in-radius pairs in shared memory.  A tile
// with none writes its zeros with 16-byte stores.  Otherwise the block's
// 32 groups of 8 lanes take the listed pairs one per group: lane
// 4 p + e clips edge e of pass p (p 0: A's edges against B; 1: B's against
// A, with the tie-break), its 4 half-plane tests and divisions, and the
// group's first lane gathers the 8 edge terms by shuffles and adds them in
// the plain version's order, (((c0 + c1) + c2) + c3) per pass, then the
// two passes, so the result is bit-equal to it.  The results land in a
// shared 32 x 32 tile that the block writes with 16-byte stores.  Before,
// one thread ran up to four pairs' 32 clips one after another.
//
// A launch covers S scenes, grid.z one scene each (at most 65535 a
// launch; the launcher splits more): each block offsets its scene's
// det8, trk8 and out by the per-scene strides and then runs exactly the
// single-scene code, so each scene's [D, T] is bit-equal to a launch on
// that scene alone, and its tiles skip on its own boxes.
//
// Bound: on x-sorted inputs most tiles skip, and the work is the clip of
// the in-radius pairs (f32 operations) against writing the [S, D, T]
// result (bytes); at D=500, T=2000 the write, 4 MB, is the larger.
//
// Built with --fmad=false (similari_tpu_torch/_build.py): a contracted
// multiply-add would break the exact b == 0 / a == 0 collinear tests, and
// identical boxes would score IoU 0 or ~1/eps.  No fast math here.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;
constexpr int kThreads = 256;
constexpr int kGroups = kThreads / 8;  // groups of 8 lanes, one pair each
constexpr int kCols = 8;

// v[i] for a lane-dependent i, by selects (no local-memory indexing).
__device__ __forceinline__ float pick(const float v[4], int i) {
  return (i & 2) ? ((i & 1) ? v[3] : v[2]) : ((i & 1) ? v[1] : v[0]);
}

// The edge (sx, sy) -> (ex, ey) of one quad clipped to the other quad
// (bx, by) by Liang-Barsky (vertices already recentred around the pair's
// midpoint): its term of the boundary integral, in the plain version's
// operation order; `tie_pass` adds the collinear tie-break.
__device__ __forceinline__ float edge_term(float sx, float sy, float ex,
                                           float ey, const float bx[4],
                                           const float by[4],
                                           bool tie_pass) {
  const float dex = ex - sx;
  const float dey = ey - sy;
  float t0 = 0.0f;
  float t1 = 1.0f;
  bool ok = true;
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    const float px = bx[h];
    const float py = by[h];
    const float dx = bx[(h + 1) & 3] - px;
    const float dy = by[(h + 1) & 3] - py;
    const float a = dx * (sy - py) - dy * (sx - px);
    const float b = dx * dey - dy * dex;
    const float tt = -a / (b == 0.0f ? 1.0f : b);
    if (b < 0.0f) t0 = fmaxf(t0, tt);
    if (b > 0.0f) t1 = fminf(t1, tt);
    const bool same_dir = dx * dex + dy * dey >= 0.0f;
    const bool para_out =
        ((b == 0.0f) && (a > 0.0f)) ||
        (tie_pass && (b == 0.0f) && (a == 0.0f) && same_dir);
    ok = ok && !para_out;
  }
  const float p0x = sx + t0 * dex;
  const float p0y = sy + t0 * dey;
  const float p1x = sx + t1 * dex;
  const float p1y = sy + t1 * dey;
  return (ok && t1 > t0) ? p0x * p1y - p0y * p1x : 0.0f;
}

// Writes the tile's 32 x 32 values v(r, c) (rows and columns past the
// edge skipped), one 16-byte store a thread where the rows allow it.
template <class Value>
__device__ __forceinline__ void write_tile(float* out, int row0, int col0,
                                           int d, int t, bool vec, Value v) {
  const int r = threadIdx.x >> 3, c = (threadIdx.x & 7) * 4;
  const int row = row0 + r, col = col0 + c;
  if (row >= d) return;
  float* p = out + (size_t)row * t + col;
  if (vec && col + 3 < t) {
    *reinterpret_cast<float4*>(p) =
        make_float4(v(r, c), v(r, c + 1), v(r, c + 2), v(r, c + 3));
  } else {
    for (int k = 0; k < 4 && col + k < t; ++k) p[k] = v(r, c + k);
  }
}

template <bool kWantIou>
__global__ void __launch_bounds__(kThreads)
clip_pairs_kernel(const float* __restrict__ det8,
                  const float* __restrict__ trk8, float* __restrict__ out,
                  int* __restrict__ tiles_run, int d, int t,
                  long long det_stride, long long trk_stride,
                  long long out_stride) {
  __shared__ float sdet[kTile][kCols];
  __shared__ float strk[kTile][kCols + 1];
  __shared__ float res[kTile][kTile + 1];
  __shared__ short list[kTile * kTile];  // in-radius pairs: r * 32 + c
  __shared__ int count;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;
  det8 += blockIdx.z * det_stride;
  trk8 += blockIdx.z * trk_stride;
  out += blockIdx.z * out_stride;
  // 16-byte stores need every row of every scene 16-byte aligned
  const bool vec = (t & 3) == 0 && (out_stride & 3) == 0;
  for (int k = tid; k < kTile * kCols; k += kThreads) {
    const int r = k / kCols;
    const int c = k % kCols;
    sdet[r][c] = row0 + r < d ? det8[(size_t)(row0 + r) * kCols + c] : 0.0f;
    strk[r][c] = col0 + r < t ? trk8[(size_t)(col0 + r) * kCols + c] : 0.0f;
  }
  if (tid == 0) count = 0;
  __syncthreads();

  // the far test: warp w takes rows w + 8 k, lane its column; each warp
  // appends its in-radius pairs to the list
  const bool col_in = col0 + lane < t;
#pragma unroll
  for (int k = 0; k < kTile / 8; ++k) {
    const int r = warp + 8 * k;
    const float ddx = sdet[r][0] - strk[lane][0];
    const float ddy = sdet[r][1] - strk[lane][1];
    const float md = sdet[r][6] + strk[lane][6];
    const bool near = row0 + r < d && col_in && !(ddx * ddx + ddy * ddy > md * md);
    res[r][lane] = 0.0f;
    const unsigned m = __ballot_sync(0xffffffffu, near);
    int base = 0;
    if (lane == 0 && m) base = atomicAdd(&count, __popc(m));
    base = __shfl_sync(0xffffffffu, base, 0);
    if (near) list[base + __popc(m & ((1u << lane) - 1))] = (short)(r * kTile + lane);
  }
  __syncthreads();
  const int n = count;
  if (n == 0) {
    write_tile(out, row0, col0, d, t, vec, [](int, int) { return 0.0f; });
    return;
  }
  if (tiles_run != nullptr && tid == 0) atomicAdd(tiles_run, 1);

  const int grp = tid >> 3, li = tid & 7, pass = li >> 2, edge = li & 3;
  const unsigned gmask = 0xffu << (lane & 24);
  for (int q = grp; q < n; q += kGroups) {
    const int pr = list[q];
    const int r = pr / kTile, c = pr % kTile;
    const float ddx = sdet[r][0] - strk[c][0];
    const float ddy = sdet[r][1] - strk[c][1];
    const float hx = 0.5f * ddx;  // a_centre - midpoint
    const float hy = 0.5f * ddy;
    const float a_r1x = sdet[r][2];
    const float a_r1y = sdet[r][3];
    const float a_r2x = sdet[r][4];
    const float a_r2y = sdet[r][5];
    const float b_r1x = strk[c][2];
    const float b_r1y = strk[c][3];
    const float b_r2x = strk[c][4];
    const float b_r2y = strk[c][5];
    const float ax[4] = {hx + a_r1x, hx + a_r2x, hx - a_r1x, hx - a_r2x};
    const float ay[4] = {hy + a_r1y, hy + a_r2y, hy - a_r1y, hy - a_r2y};
    const float bx[4] = {b_r1x - hx, b_r2x - hx, -b_r1x - hx, -b_r2x - hx};
    const float by[4] = {b_r1y - hy, b_r2y - hy, -b_r1y - hy, -b_r2y - hy};
    // pass 0 clips A's edge to B, pass 1 B's edge to A (tie-break)
    float qx[4], qy[4], ox[4], oy[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      qx[k] = pass ? bx[k] : ax[k];
      qy[k] = pass ? by[k] : ay[k];
      ox[k] = pass ? ax[k] : bx[k];
      oy[k] = pass ? ay[k] : by[k];
    }
    const int next = (edge + 1) & 3;
    const float term = edge_term(pick(qx, edge), pick(qy, edge),
                                 pick(qx, next), pick(qy, next), ox, oy,
                                 pass == 1);
    float e[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      e[k] = __shfl_sync(gmask, term, (lane & 24) + k);
    if (li == 0) {
      const float s = (((e[0] + e[1]) + e[2]) + e[3]) +
                      (((e[4] + e[5]) + e[6]) + e[7]);
      const float inter = fabsf(s) * 0.5f;
      float v = inter;
      if (kWantIou) {
        const float uni = sdet[r][7] + strk[c][7] - inter;
        v = (inter > 0.0f && uni > 0.0f) ? inter / uni : 0.0f;
      }
      res[r][c] = v;
    }
  }
  __syncthreads();
  write_tile(out, row0, col0, d, t, vec,
             [&](int r, int c) { return res[r][c]; });
}

}  // namespace

// det8 [s, d, 8] and trk8 [s, t, 8] f32 clip columns -> out [s, d, t],
// rows of 8 (or t) contiguous floats, scene k's at k * det_stride,
// k * trk_stride and k * out_stride floats.  tiles_run (may be null) is
// increased by the number of tiles that ran the clip, over every scene.
// Returns the first failing launch's cudaGetLastError().
extern "C" int clip_pairs_launch(const float* det8, const float* trk8,
                                 float* out, int* tiles_run, int s, int d,
                                 int t, long long det_stride,
                                 long long trk_stride, long long out_stride,
                                 int want_iou, cudaStream_t stream) {
  if (s <= 0 || d <= 0 || t <= 0) return 0;
  constexpr int kMaxScenes = 65535;  // grid.z's limit
  for (int k0 = 0; k0 < s; k0 += kMaxScenes) {
    const int n = s - k0 < kMaxScenes ? s - k0 : kMaxScenes;
    const dim3 grid((t + kTile - 1) / kTile, (d + kTile - 1) / kTile, n);
    const float* det = det8 + k0 * det_stride;
    const float* trk = trk8 + k0 * trk_stride;
    float* o = out + k0 * out_stride;
    if (want_iou) {
      clip_pairs_kernel<true><<<grid, kThreads, 0, stream>>>(
          det, trk, o, tiles_run, d, t, det_stride, trk_stride, out_stride);
    } else {
      clip_pairs_kernel<false><<<grid, kThreads, 0, stream>>>(
          det, trk, o, tiles_run, d, t, det_stride, trk_stride, out_stride);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
