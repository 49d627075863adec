// The gallery products of one fused VisualSORT chunk, for Hopper (sm_90a).
//
// Replaces the gallery matmul inside `similari_tpu/ops/pallas_visual.py::
// _kernel` (:245-265), which runs on the TPU's matrix unit frame by frame.
// Here the product leaves the frame loop: within a launch of C frames the
// scan (`fused_track.cu::fused_visual_kernel`) writes the gallery only by
// copying a candidate row of the chunk into a lane, so every lane a frame-s
// candidate can meet holds either its value at the start of the launch or
// the feature row of a candidate of an earlier frame s' < s.  Every dot
// product the scan can need is therefore one entry of
//
//   dots[N, M + N] = X . [G ; X]^T,  X = feat[C*D, F], G = gallery[T*K, F]
//
// (column j < M: launch-start lane j = t*K + i; column M + x: chunk row x =
// s*D + r), computed here once per chunk on a grid that fills the card,
// before the scan starts.  Blocks of the X part whose rows all lie in frames
// not after their columns' frames are never read and are skipped.  Beside
// it, norms[M + N]: the f32 sum of squares of each column's row, taken from
// the unrounded values (the reference's norms, `pallas_visual.py:251-256`).
//
// Precision: with bf16 distance inputs both operands are rounded to bf16
// and multiplied on the tensor cores (mma.sync m16n8k16, f32 accumulation),
// as the TPU kernel feeds its matrix unit; with f32 inputs each thread
// multiplies in exact f32 with explicit fused multiply-adds, never TF32.
//
// Bound at the main path (N = 16 x 128, M = 512 x 3, F = 512, bf16): the
// 5.1M products the scan can read are 5.2 GFLOP, 5.3 us at 989 TFLOP/s,
// against ~7 MB read and ~20 MB of them written, 8.3 us at 3.35 TB/s: the
// output bytes bound it.  The design is simple first: 64 x 64 output
// tiles, one block of 4 warps each, f32 tiles of 32 along F staged in
// shared memory by cp.async, double-buffered, rounded to bf16 as the
// fragments are built.  It takes ~0.064 ms on an H100 (PERF.md), 13% of
// the bound; warp-specialised TMA + wgmma and a bf16 or compacted output
// are left for later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64, BN = 64, BK = 32;  // output tile, depth per stage
constexpr int THREADS = 128;              // 4 warps
constexpr int NORM_WARPS = THREADS / 32;  // norm rows per norm block

struct DotsArgs {
  const float* x;  // [N, F] chunk rows
  const float* g;  // [M, F] gallery lanes at launch start
  float* dots;     // [N, M + N]
  float* norms;    // [M + N]
  int N, M, F, D;  // D: rows per frame
  int tiles_m, n_tiles;
};

// Row j of the column operand [G ; X].
__device__ __forceinline__ const float* col_row(const DotsArgs& a, int j) {
  return j < a.M ? a.g + (size_t)j * a.F : a.x + (size_t)(j - a.M) * a.F;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(bytes));
}

// Stages rows [row0, row0 + 64) x depth [k0, k0 + BK) of one operand into
// s[64][LDS]; rows past `nrows` and depth past F are zero-filled.  VEC: F is
// a multiple of 4 and the bases are 16-byte aligned.
template <bool VEC, int LDS, class RowPtr>
__device__ __forceinline__ void load_tile(float* s, RowPtr rowp, int row0,
                                          int nrows, int k0, int F,
                                          const float* any) {
  const int tid = threadIdx.x;
  if (VEC) {
#pragma unroll
    for (int q = 0; q < (64 * BK / 4) / THREADS; ++q) {
      const int idx = tid + q * THREADS;
      const int r = idx / (BK / 4), c = (idx % (BK / 4)) * 4;
      const int row = row0 + r, k = k0 + c;
      const bool in = row < nrows && k < F;
      cp_async16(&s[r * LDS + c], in ? rowp(row) + k : any, in ? 16 : 0);
    }
  } else {
#pragma unroll 4
    for (int q = 0; q < (64 * BK) / THREADS; ++q) {
      const int idx = tid + q * THREADS;
      const int r = idx / BK, c = idx % BK;
      const int row = row0 + r, k = k0 + c;
      const bool in = row < nrows && k < F;
      cp_async4(&s[r * LDS + c], in ? rowp(row) + k : any, in ? 4 : 0);
    }
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float2 v) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);  // .x low half
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Whether output tile (bm, bn) holds an entry the scan reads: any gallery
// column, or a chunk row of a later frame than a chunk-row column.
__device__ __forceinline__ bool tile_needed(const DotsArgs& a, int r0,
                                            int c0) {
  if (c0 < a.M) return true;
  const int rlast = min(r0 + BM, a.N) - 1;
  return rlast / a.D > (c0 - a.M) / a.D;
}

// One warp per column row: the f32 sum of squares of its unrounded values.
__device__ void norm_rows(const DotsArgs& a, int nb) {
  const int lane = threadIdx.x & 31;
  const int j = nb * NORM_WARPS + (threadIdx.x >> 5);
  if (j >= a.M + a.N) return;
  const float* p = col_row(a, j);
  float acc = 0.0f;
  for (int f = lane; f < a.F; f += 32) acc = acc + p[f] * p[f];
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0) a.norms[j] = acc;
}

template <bool BF16, bool VEC>
__global__ void __launch_bounds__(THREADS) gallery_dots_kernel(DotsArgs a) {
  // bf16 fragments read float2 at a row stride of 40 words and f32 tiles
  // float4 at 36: both conflict-free across the threads of one request
  constexpr int LDS = BF16 ? BK + 8 : BK + 4;
  __shared__ __align__(16) float As[2][BM * LDS];
  __shared__ __align__(16) float Bs[2][BN * LDS];
  if ((int)blockIdx.x >= a.n_tiles) {
    norm_rows(a, blockIdx.x - a.n_tiles);
    return;
  }
  const int bm = blockIdx.x % a.tiles_m, bn = blockIdx.x / a.tiles_m;
  const int r0 = bm * BM, c0 = bn * BN;
  if (!tile_needed(a, r0, c0)) return;  // uniform across the block
  const int W = a.M + a.N, F = a.F, tid = threadIdx.x;
  auto xrow = [&](int i) { return a.x + (size_t)i * F; };
  auto crow = [&](int j) { return col_row(a, j); };
  const int nk = (F + BK - 1) / BK;

  // bf16: warp (wm, wn) owns 32 x 32 outputs, 2 x 4 mma tiles of 16 x 8
  const int lane = tid & 31, w = tid >> 5, grp = lane >> 2, tig = lane & 3;
  const int wm = w >> 1, wn = w & 1;
  float acc[BF16 ? 2 : 4][BF16 ? 4 : 8][BF16 ? 4 : 1];
  // f32: thread (ty, tx) owns rows ty + 16 i (i < 4), cols tx + 8 j (j < 8)
  const int ty = tid >> 3, tx = tid & 7;
#pragma unroll
  for (int i = 0; i < (BF16 ? 2 : 4); ++i)
#pragma unroll
    for (int j = 0; j < (BF16 ? 4 : 8); ++j)
#pragma unroll
      for (int e = 0; e < (BF16 ? 4 : 1); ++e) acc[i][j][e] = 0.0f;

  load_tile<VEC, LDS>(As[0], xrow, r0, a.N, 0, F, a.x);
  load_tile<VEC, LDS>(Bs[0], crow, c0, W, 0, F, a.x);
  asm volatile("cp.async.commit_group;\n" ::);
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) {
      load_tile<VEC, LDS>(As[cur ^ 1], xrow, r0, a.N, (kt + 1) * BK, F, a.x);
      load_tile<VEC, LDS>(Bs[cur ^ 1], crow, c0, W, (kt + 1) * BK, F, a.x);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncthreads();
    const float* As_ = As[cur];
    const float* Bs_ = Bs[cur];
    if constexpr (BF16) {
#pragma unroll
      for (int ks = 0; ks < BK; ks += 16) {
        uint32_t af[2][4], bf[4][2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const float* p = As_ + (wm * 32 + mi * 16 + grp) * LDS + ks + 2 * tig;
          af[mi][0] = pack_bf16(*reinterpret_cast<const float2*>(p));
          af[mi][1] = pack_bf16(*reinterpret_cast<const float2*>(p + 8 * LDS));
          af[mi][2] = pack_bf16(*reinterpret_cast<const float2*>(p + 8));
          af[mi][3] = pack_bf16(
              *reinterpret_cast<const float2*>(p + 8 * LDS + 8));
        }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const float* p = Bs_ + (wn * 32 + ni * 8 + grp) * LDS + ks + 2 * tig;
          bf[ni][0] = pack_bf16(*reinterpret_cast<const float2*>(p));
          bf[ni][1] = pack_bf16(*reinterpret_cast<const float2*>(p + 8));
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], af[mi], bf[ni]);
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < BK; kk += 4) {
        float4 av[4], bv[8];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          av[i] = *reinterpret_cast<const float4*>(As_ + (ty + 16 * i) * LDS + kk);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          bv[j] = *reinterpret_cast<const float4*>(Bs_ + (tx + 8 * j) * LDS + kk);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            float c = acc[i][j][0];
            c = __fmaf_rn(av[i].x, bv[j].x, c);
            c = __fmaf_rn(av[i].y, bv[j].y, c);
            c = __fmaf_rn(av[i].z, bv[j].z, c);
            c = __fmaf_rn(av[i].w, bv[j].w, c);
            acc[i][j][0] = c;
          }
      }
    }
    __syncthreads();  // the next stage's copies overwrite this buffer
  }
  asm volatile("cp.async.wait_group 0;\n" ::);

  if constexpr (BF16) {
    // c0, c1: (row grp, cols 2 tig, 2 tig + 1); c2, c3: row grp + 8
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = r0 + wm * 32 + mi * 16 + grp + (e >> 1) * 8;
          const int col = c0 + wn * 32 + ni * 8 + 2 * tig + (e & 1);
          if (row < a.N && col < W) a.dots[(size_t)row * W + col] = acc[mi][ni][e];
        }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int row = r0 + ty + 16 * i, col = c0 + tx + 8 * j;
        if (row < a.N && col < W) a.dots[(size_t)row * W + col] = acc[i][j][0];
      }
  }
}

template <bool BF16, bool VEC>
cudaError_t launch(const DotsArgs& a, int blocks, cudaStream_t stream) {
  gallery_dots_kernel<BF16, VEC><<<blocks, THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// ----------------------------------------------------------------------------
// C interface (loaded with ctypes)
// ----------------------------------------------------------------------------

// x f32[N, F] (N = C * D chunk rows, D rows per frame), g f32[M, F]
// (M = T * K lanes); writes dots f32[N, M + N] (the blocks the scan reads)
// and norms f32[M + N].
extern "C" int gallery_dots_launch(const void* x, const void* g, void* dots,
                                   void* norms, int N, int M, int F, int D,
                                   int bf16, void* stream) {
  if (N < 1 || M < 1 || F < 1 || D < 1) return (int)cudaErrorInvalidValue;
  DotsArgs a;
  a.x = (const float*)x; a.g = (const float*)g;
  a.dots = (float*)dots; a.norms = (float*)norms;
  a.N = N; a.M = M; a.F = F; a.D = D;
  a.tiles_m = (N + BM - 1) / BM;
  const long long tiles =
      (long long)a.tiles_m * ((M + N + BN - 1) / BN);
  const long long norm_blocks = (M + N + NORM_WARPS - 1) / NORM_WARPS;
  if (tiles + norm_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  a.n_tiles = (int)tiles;
  const int blocks = (int)(tiles + norm_blocks);
  const bool vec = F % 4 == 0 && ((uintptr_t)x % 16) == 0 &&
                   ((uintptr_t)g % 16) == 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return (int)(vec ? launch<true, true>(a, blocks, s)
                     : launch<true, false>(a, blocks, s));
  return (int)(vec ? launch<false, true>(a, blocks, s)
                   : launch<false, false>(a, blocks, s));
}
