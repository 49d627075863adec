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
// Design.  A block of 32 x 8 threads owns a 32 x 32 tile of pairs, each
// thread one track column and four detection rows.  The tile's 32 + 32
// clip columns are staged in shared memory (the track side padded to 9
// floats a row, so a warp reading one column each hits 32 banks).  Every
// thread first runs the ~10-flop `too_far` test for its pairs;
// __syncthreads_or decides whether the tile runs the ~640-flop clip at
// all, and a skipped tile writes zeros.  The result is per pair, so the
// ragged edge is bounds-checked instead of padded.
//
// Bound: on x-sorted inputs most tiles skip, and the work is the clip of
// the in-radius pairs (f32 operations) against writing the [D, T] result
// (bytes); at D=500, T=2000 the write, 4 MB, is the larger.
//
// Built with --fmad=false (similari_tpu_torch/_build.py): a contracted
// multiply-add would break the exact b == 0 / a == 0 collinear tests, and
// identical boxes would score IoU 0 or ~1/eps.  No fast math here.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;
constexpr int kRowsPerThread = 4;  // blockDim = (32, 8)
constexpr int kCols = 8;

// Boundary integral of A's edges clipped to B (vertices already recentred
// around the pair's midpoint), in the plain version's operation order.
__device__ __forceinline__ float pair_integral(const float ax[4],
                                               const float ay[4],
                                               const float bx[4],
                                               const float by[4],
                                               bool tie_pass) {
  float total = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float sx = ax[i];
    const float sy = ay[i];
    const float dex = ax[(i + 1) & 3] - sx;
    const float dey = ay[(i + 1) & 3] - sy;
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
      bool para_out = (b == 0.0f) && (a > 0.0f);
      if (tie_pass) {
        const bool same_dir = dx * dex + dy * dey >= 0.0f;
        para_out = para_out || ((b == 0.0f) && (a == 0.0f) && same_dir);
      }
      ok = ok && !para_out;
    }
    const float p0x = sx + t0 * dex;
    const float p0y = sy + t0 * dey;
    const float p1x = sx + t1 * dex;
    const float p1y = sy + t1 * dey;
    const float contrib = (ok && t1 > t0) ? p0x * p1y - p0y * p1x : 0.0f;
    total = i == 0 ? contrib : total + contrib;
  }
  return total;
}

template <bool kWantIou>
__global__ void __launch_bounds__(256)
clip_pairs_kernel(const float* __restrict__ det8,
                  const float* __restrict__ trk8, float* __restrict__ out,
                  int* __restrict__ tiles_run, int d, int t) {
  __shared__ float sdet[kTile][kCols];
  __shared__ float strk[kTile][kCols + 1];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int row0 = blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;
  for (int k = ty * 32 + tx; k < kTile * kCols; k += 256) {
    const int r = k / kCols;
    const int c = k % kCols;
    sdet[r][c] = row0 + r < d ? det8[(size_t)(row0 + r) * kCols + c] : 0.0f;
    strk[r][c] = col0 + r < t ? trk8[(size_t)(col0 + r) * kCols + c] : 0.0f;
  }
  __syncthreads();

  const int col = col0 + tx;
  const float txc = strk[tx][0];
  const float tyc = strk[tx][1];
  const float trad = strk[tx][6];
  bool far[kRowsPerThread];
  bool any_near = false;
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int r = ty + 8 * k;
    const float ddx = sdet[r][0] - txc;
    const float ddy = sdet[r][1] - tyc;
    const float md = sdet[r][6] + trad;
    far[k] = row0 + r >= d || col >= t || ddx * ddx + ddy * ddy > md * md;
    any_near = any_near || !far[k];
  }
  const bool run = __syncthreads_or(any_near) != 0;
  if (run && tiles_run != nullptr && tx == 0 && ty == 0) {
    atomicAdd(tiles_run, 1);
  }
  if (col >= t) return;

  const float b_r1x = strk[tx][2];
  const float b_r1y = strk[tx][3];
  const float b_r2x = strk[tx][4];
  const float b_r2y = strk[tx][5];
  const float tarea = strk[tx][7];
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int r = ty + 8 * k;
    if (row0 + r >= d) break;
    float v = 0.0f;
    if (run && !far[k]) {
      const float ddx = sdet[r][0] - txc;
      const float ddy = sdet[r][1] - tyc;
      const float hx = 0.5f * ddx;  // a_centre - midpoint
      const float hy = 0.5f * ddy;
      const float a_r1x = sdet[r][2];
      const float a_r1y = sdet[r][3];
      const float a_r2x = sdet[r][4];
      const float a_r2y = sdet[r][5];
      const float ax[4] = {hx + a_r1x, hx + a_r2x, hx - a_r1x, hx - a_r2x};
      const float ay[4] = {hy + a_r1y, hy + a_r2y, hy - a_r1y, hy - a_r2y};
      const float bx[4] = {b_r1x - hx, b_r2x - hx, -b_r1x - hx, -b_r2x - hx};
      const float by[4] = {b_r1y - hy, b_r2y - hy, -b_r1y - hy, -b_r2y - hy};
      const float s = pair_integral(ax, ay, bx, by, false) +
                      pair_integral(bx, by, ax, ay, true);
      const float inter = fabsf(s) * 0.5f;
      if (kWantIou) {
        const float uni = sdet[r][7] + tarea - inter;
        v = (inter > 0.0f && uni > 0.0f) ? inter / uni : 0.0f;
      } else {
        v = inter;
      }
    }
    out[(size_t)(row0 + r) * t + col] = v;
  }
}

}  // namespace

// det8 [d, 8] and trk8 [t, 8] row-major f32 clip columns -> out [d, t].
// tiles_run (may be null) is increased by the number of tiles that ran the
// clip.  Returns the launch's cudaGetLastError().
extern "C" int clip_pairs_launch(const float* det8, const float* trk8,
                                 float* out, int* tiles_run, int d, int t,
                                 int want_iou, cudaStream_t stream) {
  if (d <= 0 || t <= 0) return 0;
  const dim3 block(32, 8);
  const dim3 grid((t + kTile - 1) / kTile, (d + kTile - 1) / kTile);
  if (want_iou) {
    clip_pairs_kernel<true><<<grid, block, 0, stream>>>(det8, trk8, out,
                                                        tiles_run, d, t);
  } else {
    clip_pairs_kernel<false><<<grid, block, 0, stream>>>(det8, trk8, out,
                                                         tiles_run, d, t);
  }
  return static_cast<int>(cudaGetLastError());
}
