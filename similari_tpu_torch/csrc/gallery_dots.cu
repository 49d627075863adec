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
// before the scan starts.  Tiles of the X part whose rows all lie in frames
// not after their columns' frames are never read and are skipped.  Beside
// it, norms[M + N]: the f32 sum of squares of each column's row, taken from
// the unrounded values (the reference's norms, `pallas_visual.py:251-256`).
//
// bf16 distance inputs (the main path) take two kernels.
//  - `gallery_dots_stage_kernel` reads each row of [G ; X] once: it writes
//    the row's norm and a bf16 copy rounded to nearest even, zero-padded
//    to a multiple of 64 (TMA needs 16-byte row strides, wgmma a depth of
//    16; the zeros add exactly nothing to an f32 sum).  Each operand is
//    rounded once, not once per tile that reads it.
//  - `gallery_dots_wgmma_kernel` multiplies: one block per needed 192 x 256
//    output tile; a ring of 4 shared-memory stages (64 deep, 56 KB each)
//    is filled by TMA with 128-byte swizzled tiles, each stage's arrival
//    signalled on an mbarrier; three warpgroups each run m64n256k16 wgmma
//    on 64 of the tile's rows with f32 accumulators in registers, and
//    once all three are done with a stage one thread refills it, 4
//    k-tiles ahead; the accumulators go straight to `dots`.  At the main
//    path's shape 114 of 154 tiles are needed: one wave on 132 SMs.
// f32 inputs take `gallery_dots_kernel`: 64 x 64 tiles, f32 tiles staged by
// cp.async, each thread multiplying in exact f32 with explicit fused
// multiply-adds, never TF32, and norm blocks beside them.
//
// Bound at the main path (N = 16 x 128, M = 512 x 3, F = 512, bf16): the
// 5.1M products the scan can read are 5.2 GFLOP, 5.3 us at 989 TFLOP/s,
// against ~7 MB read and ~20 MB of them written, 8.3 us at 3.35 TB/s: the
// output bytes bound it.  The needed tiles re-read ~51 MB of bf16
// operands from L2 (the 64 x 64 f32 design of before read ~330 MB and took
// ~0.064 ms, 13% of the bound; 128 x 256 tiles, 160 of them in two waves,
// read ~61 MB and took ~0.025; PERF.md has the times).

#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

// ----------------------------------------------------------------------------
// bf16: staging pass
// ----------------------------------------------------------------------------

constexpr int KT = 64;  // bf16 copy's width unit: one 128-byte swizzle row
constexpr int STAGE_WARPS = 8;  // rows per staging block

// One warp per row j of [G ; X]: the f32 sum of squares of its unrounded
// values, and its bf16 copy, zero-padded to Fp columns.
template <bool VEC>
__global__ void __launch_bounds__(STAGE_WARPS * 32)
gallery_dots_stage_kernel(const float* __restrict__ x,
                          const float* __restrict__ g,
                          __nv_bfloat16* __restrict__ stage,
                          float* __restrict__ norms, int N, int M, int F,
                          int Fp) {
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.x * STAGE_WARPS + (threadIdx.x >> 5);
  if (j >= M + N) return;
  const float* src = j < M ? g + (size_t)j * F : x + (size_t)(j - M) * F;
  __nv_bfloat16* dst = stage + (size_t)j * Fp;
  float acc = 0.0f;
  if (VEC) {
    for (int q = lane; q < F / 4; q += 32) {
      const float4 v = reinterpret_cast<const float4*>(src)[q];
      acc = acc + v.x * v.x;
      acc = acc + v.y * v.y;
      acc = acc + v.z * v.z;
      acc = acc + v.w * v.w;
      __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
      __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
      uint2 packed;
      packed.x = *reinterpret_cast<const uint32_t*>(&lo);
      packed.y = *reinterpret_cast<const uint32_t*>(&hi);
      reinterpret_cast<uint2*>(dst)[q] = packed;
    }
  } else {
    for (int f = lane; f < F; f += 32) {
      const float v = src[f];
      acc = acc + v * v;
      dst[f] = __float2bfloat16_rn(v);
    }
  }
  for (int f = F + lane; f < Fp; f += 32) dst[f] = __float2bfloat16_rn(0.0f);
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0) norms[j] = acc;
}

// ----------------------------------------------------------------------------
// bf16: TMA + wgmma product
// ----------------------------------------------------------------------------

constexpr int CONSUMERS = 3;  // warpgroups of 64 output rows each
constexpr int TM = 64 * CONSUMERS, TN = 256;  // output tile
constexpr int BOX = 64;  // rows of one TMA box (A: 3, B: 4 boxes a stage)
constexpr int STAGES = 4;
constexpr int A_BYTES = TM * KT * 2;  // 24 KB
constexpr int B_BYTES = TN * KT * 2;  // 32 KB
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
// 384 threads: 168 registers each, room for 128 accumulators
constexpr int WG_THREADS = 128 * CONSUMERS;
// the ring, 1 KB of slack to align it to the swizzle's 1024 bytes, and
// each stage's barrier: 230,432 of 232,448 bytes
constexpr int WG_SMEM = STAGES * STAGE_BYTES + 1024 + STAGES * 8;

struct WgArgs {
  float* dots;  // [N, W]
  int N, M, D, W, nk, tiles_m;
};

// Whether output tile (r0, c0) of tm x tn holds an entry the scan reads:
// any gallery column, or a chunk row of a later frame than a chunk-row
// column.
__device__ __forceinline__ bool tile_needed(int N, int M, int D, int tm,
                                            int r0, int c0) {
  if (c0 < M) return true;
  const int rlast = min(r0 + tm, N) - 1;
  return rlast / D > (c0 - M) / D;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Waits until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// One box of the staging tensor (coordinates: column k, row) into shared
// memory, completing `bytes` on the barrier.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int k, int row, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(dst), "l"((uint64_t)map), "r"(bar), "r"(k), "r"(row)
      : "memory");
}

// wgmma descriptor of a K-major tile with 128-byte swizzle: rows of 128
// bytes, 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d[64 x 256] += A[64 x 16] . B[256 x 16]^T, both K-major in shared memory.
__device__ __forceinline__ void wgmma_256(float* d, uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));  // scale-d: D = A B + D
}

// One block per output tile of TM x TN: blockIdx.x = bn * tiles_m + bm.
// The map covers the staging [M + N, Fp] bf16 in boxes of 64 x BOX rows.
__global__ void __launch_bounds__(WG_THREADS, 1)
gallery_dots_wgmma_kernel(const __grid_constant__ CUtensorMap map,
                          WgArgs a) {
  const int bm = blockIdx.x % a.tiles_m, bn = blockIdx.x / a.tiles_m;
  const int r0 = bm * TM, c0 = bn * TN;
  if (!tile_needed(a.N, a.M, a.D, TM, r0, c0)) return;  // uniform

  extern __shared__ char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;  // swizzle atoms: 1 KB
  const uint32_t bars = ring + STAGES * STAGE_BYTES;
  auto full = [&](int s) { return bars + 8 * s; };
  // thread 0 fills stage s with k-tile kt: 3 boxes of A, 4 of B
  auto load = [&](int kt, int s) {
    const uint32_t sa = ring + s * STAGE_BYTES, sb = sa + A_BYTES;
    mbar_expect_tx(full(s), STAGE_BYTES);
    for (int b = 0; b < TM / BOX; ++b)
      tma_load(sa + b * BOX * KT * 2, &map, kt * KT, a.M + r0 + b * BOX,
               full(s));
    for (int b = 0; b < TN / BOX; ++b)
      tma_load(sb + b * BOX * KT * 2, &map, kt * KT, c0 + b * BOX, full(s));
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(full(s), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int kt = 0; kt < STAGES && kt < a.nk; ++kt) load(kt, kt);
  }
  __syncthreads();

  // warpgroup wg owns rows r0 + 64 wg .. + 63 of the tile
  const int wg = threadIdx.x / 128;
  float d[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) d[i] = 0.0f;
  for (int kt = 0; kt < a.nk; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(full(s), (kt / STAGES) & 1);
    __syncwarp();  // wgmma is .aligned: the warp converged
    const uint32_t sa = ring + s * STAGE_BYTES + wg * 64 * KT * 2;
    const uint32_t sb = ring + s * STAGE_BYTES + A_BYTES;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk)  // 32 bytes a k-step
      wgmma_256(d, sw128_desc(sa + 32 * kk), sw128_desc(sb + 32 * kk));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    // every warpgroup is done with stage s: refill it, STAGES k-tiles on
    __syncthreads();
    if (threadIdx.x == 0 && kt + STAGES < a.nk) load(kt + STAGES, s);
  }
  // d[4j + 2h + e]: row 16 warp + lane/4 + 8h, column 8j + 2 (lane%4) + e
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int row0 = r0 + wg * 64 + warp * 16 + (lane >> 2);
  const int col0 = c0 + 2 * (lane & 3);
  const bool pairs = (a.W & 1) == 0;  // float2 stores stay aligned
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row >= a.N) continue;
    float* out = a.dots + (size_t)row * a.W;
#pragma unroll
    for (int j = 0; j < TN / 8; ++j) {
      const int col = col0 + 8 * j;
      const float v0 = d[4 * j + 2 * h], v1 = d[4 * j + 2 * h + 1];
      if (pairs && col + 1 < a.W) {
        *reinterpret_cast<float2*>(out + col) = make_float2(v0, v1);
      } else {
        if (col < a.W) out[col] = v0;
        if (col + 1 < a.W) out[col + 1] = v1;
      }
    }
  }
}

// ----------------------------------------------------------------------------
// f32: exact products, 64 x 64 tiles staged by cp.async
// ----------------------------------------------------------------------------

constexpr int BM = 64, BN = 64, BK = 32;  // output tile, depth per stage
constexpr int THREADS = 128;              // 4 warps
constexpr int NORM_WARPS = THREADS / 32;  // norm rows per norm block
constexpr int LDS = BK + 4;  // f32 tiles read as float4, conflict-free

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
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes));
}

// Stages rows [row0, row0 + 64) x depth [k0, k0 + BK) of one operand into
// s[64][LDS]; rows past `nrows` and depth past F are zero-filled.  VEC: F is
// a multiple of 4 and the bases are 16-byte aligned.
template <bool VEC, class RowPtr>
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

// One warp per column row: the f32 sum of squares of its values.
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

template <bool VEC>
__global__ void __launch_bounds__(THREADS) gallery_dots_kernel(DotsArgs a) {
  __shared__ __align__(16) float As[2][BM * LDS];
  __shared__ __align__(16) float Bs[2][BN * LDS];
  if ((int)blockIdx.x >= a.n_tiles) {
    norm_rows(a, blockIdx.x - a.n_tiles);
    return;
  }
  const int bm = blockIdx.x % a.tiles_m, bn = blockIdx.x / a.tiles_m;
  const int r0 = bm * BM, c0 = bn * BN;
  if (!tile_needed(a.N, a.M, a.D, BM, r0, c0)) return;  // uniform
  const int W = a.M + a.N, F = a.F, tid = threadIdx.x;
  auto xrow = [&](int i) { return a.x + (size_t)i * F; };
  auto crow = [&](int j) { return col_row(a, j); };
  const int nk = (F + BK - 1) / BK;

  // thread (ty, tx) owns rows ty + 16 i (i < 4), cols tx + 8 j (j < 8)
  const int ty = tid >> 3, tx = tid & 7;
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  load_tile<VEC>(As[0], xrow, r0, a.N, 0, F, a.x);
  load_tile<VEC>(Bs[0], crow, c0, W, 0, F, a.x);
  asm volatile("cp.async.commit_group;\n" ::);
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) {
      load_tile<VEC>(As[cur ^ 1], xrow, r0, a.N, (kt + 1) * BK, F, a.x);
      load_tile<VEC>(Bs[cur ^ 1], crow, c0, W, (kt + 1) * BK, F, a.x);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncthreads();
    const float* As_ = As[cur];
    const float* Bs_ = Bs[cur];
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
          float c = acc[i][j];
          c = __fmaf_rn(av[i].x, bv[j].x, c);
          c = __fmaf_rn(av[i].y, bv[j].y, c);
          c = __fmaf_rn(av[i].z, bv[j].z, c);
          c = __fmaf_rn(av[i].w, bv[j].w, c);
          acc[i][j] = c;
        }
    }
    __syncthreads();  // the next stage's copies overwrite this buffer
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int row = r0 + ty + 16 * i, col = c0 + tx + 8 * j;
      if (row < a.N && col < W) a.dots[(size_t)row * W + col] = acc[i][j];
    }
}

// ----------------------------------------------------------------------------
// host side
// ----------------------------------------------------------------------------

using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

// The driver's tensor-map encoder, from the driver library the process
// already uses (no link against it).
EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    return h ? (EncodeTiled)dlsym(h, "cuTensorMapEncodeTiled") : nullptr;
  }();
  return fn;
}

cudaError_t launch_bf16(const float* x, const float* g, float* dots,
                        float* norms, __nv_bfloat16* stage, int N, int M,
                        int F, int D, cudaStream_t s) {
  const int W = M + N, Fp = (F + KT - 1) / KT * KT;
  const bool vec = F % 4 == 0 && ((uintptr_t)x % 16) == 0 &&
                   ((uintptr_t)g % 16) == 0;
  const int sblocks = (W + STAGE_WARPS - 1) / STAGE_WARPS;
  if (vec)
    gallery_dots_stage_kernel<true><<<sblocks, STAGE_WARPS * 32, 0, s>>>(
        x, g, stage, norms, N, M, F, Fp);
  else
    gallery_dots_stage_kernel<false><<<sblocks, STAGE_WARPS * 32, 0, s>>>(
        x, g, stage, norms, N, M, F, Fp);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  const EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorSharedObjectSymbolNotFound;
  CUtensorMap map;
  const cuuint64_t dims[2] = {(cuuint64_t)Fp, (cuuint64_t)W};
  const cuuint64_t strides[1] = {(cuuint64_t)Fp * 2};
  const cuuint32_t box[2] = {KT, BOX};
  const cuuint32_t estrides[2] = {1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, (void*)stage, dims,
             strides, box, estrides, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(gallery_dots_wgmma_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           WG_SMEM);
  if (e != cudaSuccess) return e;
  WgArgs a;
  a.dots = dots; a.N = N; a.M = M; a.D = D; a.W = W; a.nk = Fp / KT;
  a.tiles_m = (N + TM - 1) / TM;
  const long long tiles = (long long)a.tiles_m * ((W + TN - 1) / TN);
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  gallery_dots_wgmma_kernel<<<(int)tiles, WG_THREADS, WG_SMEM, s>>>(map, a);
  return cudaGetLastError();
}

cudaError_t launch_f32(const float* x, const float* g, float* dots,
                       float* norms, int N, int M, int F, int D,
                       cudaStream_t s) {
  DotsArgs a;
  a.x = x; a.g = g; a.dots = dots; a.norms = norms;
  a.N = N; a.M = M; a.F = F; a.D = D;
  a.tiles_m = (N + BM - 1) / BM;
  const long long tiles = (long long)a.tiles_m * ((M + N + BN - 1) / BN);
  const long long norm_blocks = (M + N + NORM_WARPS - 1) / NORM_WARPS;
  if (tiles + norm_blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  a.n_tiles = (int)tiles;
  const int blocks = (int)(tiles + norm_blocks);
  const bool vec = F % 4 == 0 && ((uintptr_t)x % 16) == 0 &&
                   ((uintptr_t)g % 16) == 0;
  if (vec)
    gallery_dots_kernel<true><<<blocks, THREADS, 0, s>>>(a);
  else
    gallery_dots_kernel<false><<<blocks, THREADS, 0, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// ----------------------------------------------------------------------------
// C interface (loaded with ctypes)
// ----------------------------------------------------------------------------

// x f32[N, F] (N = C * D chunk rows, D rows per frame), g f32[M, F]
// (M = T * K lanes); writes dots f32[N, M + N] (the tiles the scan reads)
// and norms f32[M + N].  bf16: `stage` is the bf16 [M + N, Fp] scratch of
// the rounded copy (Fp = F rounded up to 64, 16-byte aligned); f32: unused.
extern "C" int gallery_dots_launch(const void* x, const void* g, void* dots,
                                   void* norms, void* stage, int N, int M,
                                   int F, int D, int bf16, void* stream) {
  if (N < 1 || M < 1 || F < 1 || D < 1 || (bf16 && stage == nullptr) ||
      (bf16 && (uintptr_t)stage % 16 != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return (int)launch_bf16((const float*)x, (const float*)g, (float*)dots,
                            (float*)norms, (__nv_bfloat16*)stage, N, M, F, D,
                            s);
  return (int)launch_f32((const float*)x, (const float*)g, (float*)dots,
                         (float*)norms, N, M, F, D, s);
}
