// The bf16 GEMM of the fused kernels (K3 fused_mlp_fwd.cu, K4
// fused_vit_block_fwd.cu, K5 fused_vit_block_bwd.cu) for Hopper (sm_90a):
// C (M x N) = A (M x K) . B^T with B logical (N x K), fp32 accumulation,
// and an epilogue functor that turns each row's 8 consecutive fp32 sums into
// the caller's outputs (fused_vit_block.cuh: BlockEpi).
//
// Layouts. Each operand is stored K-major ([mn][k], row stride ld) or
// MN-major ([k][mn]); the three the callers use are x.W (A K-major, B
// MN-major: W stored (K, N)), g.W^T (both K-major: the backward's data
// gradients read W as stored) and A^T.B (both MN-major: the weight
// gradients, summed over the rows of two row-major activations).
//
// Design (hopper-kernels guide section 1; the same machinery as K1,
// flash_attention_fwd.cu, through sm90.cuh):
//   * 128 x BN output tiles, BN in {128, 192} picked per call by `plan`
//     (waves of the card's 132 SMs: every N here, 768, 2304 and 3072, is a
//     multiple of both), 64-deep k steps: one 128-byte swizzle atom of
//     bf16, so a K-major tile row is one swizzled 128-byte line;
//   * persistent: min(tiles, SMs) blocks of 512 threads walk the tiles
//     (blockIdx.x, then every gridDim.x-th), so a tile's epilogue overlaps
//     the next tile's loads and products. The first warpgroup is the
//     producer: one thread issues the TMA loads of each k step into a ring
//     of kStages stages (3-4, as many as shared memory holds beside the
//     epilogue's staging) on full/empty mbarriers. Its warps 2-3 and the
//     second warpgroup are the epilogue's; both warpgroups give most of
//     their registers to the two consumer warpgroups (setmaxnreg), which
//     own 64 rows each and share the B tile;
//   * TMA: 2-D tensor maps encoded per call on the host (sm90.cuh:
//     encode_fn), 128-byte swizzle. A K-major tile is one box of (64 k,
//     rows); an MN-major one is boxes of (64 mn, 64 k), 8 KB each, side by
//     side. Rows past M are zero-filled by TMA (a ragged last row tile
//     needs no padding in device memory) and masked in the epilogue;
//   * wgmma m64nBNk16 from shared memory, 4 per k step, A and B each in
//     either major-ness (the transpose bits). Descriptors: K-major,
//     8-row groups 1024 bytes apart (SBO), a k16 step +32 bytes; MN-major,
//     8-k-row groups 1024 bytes apart (SBO), 64-wide mn blocks 8192 bytes
//     apart (LBO), a k16 step +2048 bytes. One wgmma group stays in flight
//     while the next stage is awaited; a stage is released when its group
//     has completed;
//   * the epilogue overlaps the next tile's products: a consumer writes its
//     64 x BN fp32 sums into its own staging tile in shared memory (padded
//     rows: no bank conflicts either way) and goes on to the next tile. The
//     functor then runs on the staged sums in 8-column chunks of one row
//     (bias, residual and outputs in 16-byte loads and stores): part on
//     six epilogue warps (on epi_full/epi_empty mbarriers), part on the
//     consumers, a few chunks after each k step's wgmmas are issued
//     (`Share`). At K = 768 the GELU epilogues cost about as much time as
//     the products: K3's fc1 at the encode's (36928, 768) -> 3072 ran at
//     280-330 TFLOP/s with its epilogue after the products, and at 460
//     this way (chip_smoke.py phase 12, H100 80GB HBM3, 700 W);
//   * split-K: the split is part of the tile index; the splits write fixed
//     fp32 partials that the caller adds in order, no atomics, so every
//     result is bitwise identical run to run.
// K must be a multiple of 64 and N of BN; M is any positive count.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <cmath>

#include "sm90.cuh"

namespace gemm90 {

using namespace sm90;

constexpr int kBM = 128;      // output rows per tile, 64 per consumer warpgroup
constexpr int kBK = 64;       // depth of a k step
constexpr int kThreads = 512; // producer and epilogue warpgroups, two consumer warpgroups
constexpr int kBoxBytes = 64 * kBK * 2;  // one 64 x 64 bf16 box, 8 KB
constexpr int kSmemLimit = 232448;       // a block's dynamic shared memory
constexpr int kEpiThreads = 192;         // warps 2-7: the epilogue's
constexpr int kEpiFirst = 64;            // threadIdx.x of its first thread
constexpr int kBarStage = 1;             // named barriers 1, 2: each consumer's staging

template <int BN>
struct Cfg {
  static constexpr int kABytes = kBM * kBK * 2;
  static constexpr int kStageBytes = kABytes + BN * kBK * 2;
  // a consumer's 64 x BN fp32 tile, rows padded by 8 floats (no bank
  // conflicts writing the accumulator fragments or reading 8-column chunks)
  static constexpr int kEpiLd = BN + 8;
  static constexpr int kEpiBytes = 2 * 64 * kEpiLd * 4;
  static constexpr int kChunks = 64 * BN / 8;  // 8-column chunks of a staging tile
  static constexpr int kFit = (kSmemLimit - 1024 - kEpiBytes - 256) / kStageBytes;
  static constexpr int kStages = kFit < 6 ? kFit : 6;
  static constexpr int kOffEpi = kStages * kStageBytes;
  static constexpr int kOffBar = kOffEpi + kEpiBytes;
  static constexpr int kSmem = kOffBar + 16 * kStages + 32 + 1024;  // + alignment slack
};

// the work of one launch: tiles of ceil(M / 128) x N / BN x splits
struct Shape {
  int M, N, K;
  int k_split;  // depth of one split, a multiple of kBK
  int splits;
};

struct Tile {
  int m0, n0, split, k0, nk;
};

template <int BN>
__device__ __forceinline__ Tile tile_of(int t, const Shape& sh) {
  const int n_tiles = sh.N / BN;
  const int mn = ((sh.M + kBM - 1) / kBM) * n_tiles;
  Tile tl;
  tl.split = t / mn;
  tl.m0 = (t % mn) / n_tiles * kBM;
  tl.n0 = (t % n_tiles) * BN;
  tl.k0 = tl.split * sh.k_split;
  tl.nk = (min(sh.K, tl.k0 + sh.k_split) - tl.k0) / kBK;
  return tl;
}

// one (64, rows) box of a 2-D tensor map into shared memory
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int inner, int outer) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(inner), "r"(outer)
      : "memory");
}

// ---------------------------------------------------------------------------
// wgmma m64nBNk16, bf16 in, fp32 accumulators; kTA / kTB: A / B MN-major
// ---------------------------------------------------------------------------

#define GM_F8(i)                                                                    \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),       \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define GM_F32(i) GM_F8(i), GM_F8(i + 8), GM_F8(i + 16), GM_F8(i + 24)
#define GM_D64                                                                      \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "          \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define GM_D96                                                                      \
  GM_D64 ", %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, "  \
  "%78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, " \
  "%94, %95"
template <int BN, bool kTA, bool kTB>
struct Wgmma;

template <bool kTA, bool kTB>
struct Wgmma<128, kTA, kTB> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{" GM_D64 "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
        : GM_F32(0), GM_F32(32)
        : "l"(da), "l"(db), "r"(acc), "n"(int(kTA)), "n"(int(kTB)));
  }
};

template <bool kTA, bool kTB>
struct Wgmma<192, kTA, kTB> {
  static __device__ __forceinline__ void mma(float (&d)[96], uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
        "{" GM_D96 "}, %96, %97, p, 1, 1, %99, %100;\n}\n"
        : GM_F32(0), GM_F32(32), GM_F32(64)
        : "l"(da), "l"(db), "r"(acc), "n"(int(kTA)), "n"(int(kTB)));
  }
};

#undef GM_D96
#undef GM_D64
#undef GM_F32
#undef GM_F8

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

// The epilogue of row r, columns 8 col .. 8 col + 7 of consumer c's staging
// tile (64 x BN fp32, row stride BN + 8) through the functor.
template <int BN, class Epi>
__device__ __forceinline__ void run_chunk(const Epi& epi, const float* stage, int r, int col,
                                          const Tile& tl, int c, int M) {
  const float* src = stage + r * (BN + 8) + 8 * col;
  // a quarter warp reads 8 chunks of one row: its upper four threads take
  // their second half first, so no two hit one bank
  const int h = (col >> 2) & 1;
  const float4 first = *reinterpret_cast<const float4*>(src + 4 * h);
  const float4 second = *reinterpret_cast<const float4*>(src + 4 * (1 - h));
  const float4 lo = h ? second : first;
  const float4 hi = h ? first : second;
  const float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  const int m = tl.m0 + c * 64 + r;
  if (m < M) epi.store8(m, tl.n0 + 8 * col, tl.split, v);
}

// How a staging tile's chunks are shared: each consumer thread runs kOwn of
// them itself (the tile's last 128 * kOwn), a few after each of the next
// tile's k steps, beside its wgmmas; the epilogue warps run the first
// kEpiChunks. Epi::kConsumerEighths sets the consumers' share: measured at
// K = 768 on an H100, a store is fastest with all of it on the epilogue
// warps, the GELU functors with a quarter and GELU' with half on the
// consumers (the six epilogue warps alone fall behind them).
template <int BN, class Epi>
struct Share {
  static constexpr int kOwn = Cfg<BN>::kChunks / 128 * Epi::kConsumerEighths / 8;
  static constexpr int kEpiChunks = Cfg<BN>::kChunks - 128 * kOwn;
  static_assert(kEpiChunks % (BN / 8) == 0, "the epilogue warps' share is whole rows");
};

template <int BN, bool kTA, bool kTB, class Epi>
__global__ void __launch_bounds__(kThreads, 1) gemm_bf16(const __grid_constant__ CUtensorMap tm_a,
                                                         const __grid_constant__ CUtensorMap tm_b,
                                                         const Epi epi, const Shape sh) {
  using C = Cfg<BN>;
  using Sh = Share<BN, Epi>;
  constexpr int S = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // 128-byte swizzle atoms are 1 KB
  uint8_t* smem = smem_raw + (base - raw);
  auto full = [&](int s) { return base + C::kOffBar + 8 * s; };
  auto empty = [&](int s) { return base + C::kOffBar + 8 * (S + s); };
  // a consumer's staging tile holds sums (epi_full) or has been read (epi_empty)
  auto epi_full = [&](int c) { return base + C::kOffBar + 8 * (2 * S + c); };
  auto epi_empty = [&](int c) { return base + C::kOffBar + 8 * (2 * S + 2 + c); };
  const int tiles = ((sh.M + kBM - 1) / kBM) * (sh.N / BN) * sh.splits;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      bar_init(full(s), 1);
      bar_init(empty(s), 8);  // one arrival per consumer warp
    }
    for (int c = 0; c < 2; ++c) {
      bar_init(epi_full(c), 128);  // every thread of consumer c
      bar_init(epi_empty(c), kEpiThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // broadcast, so that the compiler sees a warp-uniform value
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x / 128), 0);
  if (wg < 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    if (threadIdx.x == 0) {
      // ---- producer: one thread keeps the ring full, across tiles ----
      int it = 0;  // k steps loaded so far: the ring's stage and phase
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const Tile tl = tile_of<BN>(t, sh);
        for (int kt = 0; kt < tl.nk; ++kt, ++it) {
          const int s = it % S;
          bar_wait(empty(s), ((it / S) & 1) ^ 1);
          bar_expect_tx(full(s), C::kStageBytes);
          const uint32_t a_dst = base + s * C::kStageBytes;
          const uint32_t b_dst = a_dst + C::kABytes;
          const int k = tl.k0 + kt * kBK;
          if (kTA) {
            tma_load_2d(a_dst, &tm_a, full(s), tl.m0, k);
            tma_load_2d(a_dst + kBoxBytes, &tm_a, full(s), tl.m0 + 64, k);
          } else {
            tma_load_2d(a_dst, &tm_a, full(s), k, tl.m0);
          }
          if (kTB) {
#pragma unroll
            for (int j = 0; j < BN / 64; ++j) {
              tma_load_2d(b_dst + j * kBoxBytes, &tm_b, full(s), tl.n0 + 64 * j, k);
            }
          } else {
            tma_load_2d(b_dst, &tm_b, full(s), k, tl.n0);
          }
        }
      }
    } else if (threadIdx.x >= kEpiFirst) {
      // ---- epilogue: warps 1-3 run the functor on each consumer's staged
      // sums while the consumers run the next tile's products ----
      const int et = threadIdx.x - kEpiFirst;
      for (int t = blockIdx.x, n = 0; t < tiles; t += gridDim.x, ++n) {
        const Tile tl = tile_of<BN>(t, sh);
        for (int c = 0; c < 2; ++c) {
          bar_wait(epi_full(c), n & 1);
          const float* stage = reinterpret_cast<const float*>(smem + C::kOffEpi) + c * 64 * C::kEpiLd;
          // kEpiThreads is a whole number of rows' chunks: a thread keeps
          // its column and steps down the rows
          static_assert(kEpiThreads % (BN / 8) == 0, "epilogue threads per row");
          const int col = et % (BN / 8);
          for (int r = et / (BN / 8); r < Sh::kEpiChunks / (BN / 8);
               r += kEpiThreads / (BN / 8)) {
            run_chunk<BN>(epi, stage, r, col, tl, c, sh.M);
          }
          bar_arrive(epi_empty(c));
        }
      }
    }
  } else {
    // ---- consumers: 64 rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 200;\n");
    const int cw = wg - 2;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane / 4;   // accumulator row group
    const int t4 = lane % 4;  // thread within the quad
    float* stage = reinterpret_cast<float*>(smem + C::kOffEpi) + cw * 64 * C::kEpiLd;
    // the previous tile's own chunks still to run (`owed`), a few after each
    // k step's wgmmas are issued
    Tile prev{};
    int owed = 0;
    auto drain = [&](int n) {
      for (; n > 0 && owed > 0; --n, --owed) {
        const int idx = Sh::kEpiChunks + tid + 128 * (Sh::kOwn - owed);
        run_chunk<BN>(epi, stage, idx / (BN / 8), idx % (BN / 8), prev, cw, sh.M);
      }
    };
    int it = 0;  // k steps consumed so far
    for (int t = blockIdx.x, n = 0; t < tiles; t += gridDim.x, ++n) {
      const Tile tl = tile_of<BN>(t, sh);
      const int per_step = (Sh::kOwn + tl.nk - 1) / tl.nk;
      // n-tile j = i / 4 of acc holds columns 8j + 2*t4 + (i & 1), rows
      // 16*warp + g + 8*((i / 2) & 1) of this warpgroup's 64
      float acc[BN / 2];
      for (int kt = 0; kt < tl.nk; ++kt, ++it) {
        const int s = it % S;
        bar_wait(full(s), (it / S) & 1);
        // this warpgroup's 64 rows of A: the first or second 8 KB of the
        // stage in either major-ness
        const uint32_t a = base + s * C::kStageBytes + cw * kBoxBytes;
        const uint32_t b = base + s * C::kStageBytes + C::kABytes;
        const uint64_t da = smem_desc(a, kTA ? kBoxBytes : 16, 1024);
        const uint64_t db = smem_desc(b, kTB ? kBoxBytes : 16, 1024);
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          // +2048 bytes (MN-major: 16 k rows) or +32 (K-major), in 16-byte units
          Wgmma<BN, kTA, kTB>::mma(acc, da + (kTA ? 128 : 2) * kk, db + (kTB ? 128 : 2) * kk,
                                   kt > 0 || kk > 0);
        }
        wgmma_commit();
        drain(per_step);
        if (kt > 0) {  // the previous step's products are done: free its stage
          wgmma_wait<1>();
          fence_regs(acc);
          __syncwarp();
          if (lane == 0) bar_arrive(empty((it - 1) % S));
        }
      }
      wgmma_wait<0>();
      fence_regs(acc);
      __syncwarp();
      if (lane == 0) bar_arrive(empty((it - 1) % S));

      // stage the sums once the last tile's chunks are all out: this
      // warpgroup's (a named barrier) and the epilogue warps' (epi_empty)
      drain(Sh::kOwn);
      bar_wait(epi_empty(cw), (n & 1) ^ 1);
      named_sync(kBarStage + cw, 128);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          *reinterpret_cast<float2*>(stage + (warp * 16 + g + 8 * r) * C::kEpiLd + 8 * j + 2 * t4) =
              make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
        }
      }
      named_sync(kBarStage + cw, 128);
      prev = tl;
      owed = Sh::kOwn;
      bar_arrive(epi_full(cw));
    }
    drain(Sh::kOwn);
  }
}

// ---------------------------------------------------------------------------
// host: the plan of a call and the launch
// ---------------------------------------------------------------------------

// The tile width and split of one call, from a model of its time on an H100
// SXM (132 SMs; a fixed count, so the plan, and with it the rounding of a
// split sum, depends on the shape alone): a 128 x BN tile's k step costs
// BN / 64 units (one unit ~ a 128 x 64 x 64 product, ~0.23 us at 600
// TFLOP/s), a tile 4 more (pipeline fill, epilogue); the tiles run in
// rounds of 132; each split past the first writes and re-reads M x N fp32
// partials (8 bytes an element, ~690 KB a unit at 3 TB/s). Ties keep the
// wider tile and the fewer splits.
struct Plan {
  int bn, depth, count;
};

constexpr int kPlanSMs = 132;

inline Plan plan(int M, int N, int K, bool split) {
  const int steps = K / kBK;
  Plan best{0, K, 1};
  double best_cost = 0.0;
  const int widths[2] = {192, 128};
  for (int bn : widths) {
    if (N % bn != 0) continue;
    const double tiles = static_cast<double>((M + kBM - 1) / kBM) * (N / bn);
    for (int want = 1; want <= (split ? 16 : 1) && want <= steps; ++want) {
      const int per = (steps + want - 1) / want;
      const int count = (steps + per - 1) / per;
      if (count != want) continue;  // the same split as a smaller want
      double cost = std::ceil(tiles * count / kPlanSMs) * (per * bn / 64.0 + 4.0);
      if (count > 1) cost += count * 8.0 * M * N / 690e3;
      if (best.bn == 0 || cost < best_cost * 0.999) {
        best = Plan{bn, per * kBK, count};
        best_cost = cost;
      }
    }
  }
  return best;
}

// a (inner, outer) bf16 map with row stride ld (elements), a (64, box_outer)
// box and the 128-byte swizzle; elements past either extent read as zeros
inline bool make_map_2d(CUtensorMap* map, const void* ptr, long long inner, long long outer,
                        long long ld, int box_outer) {
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_outer)};
  const cuuint32_t elem_strides[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides, box,
            elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN, bool kTA, bool kTB, class Epi>
cudaError_t launch_bn(const void* a, long long lda, const void* b, long long ldb, const Shape& sh,
                      const Epi& epi, cudaStream_t s) {
  using C = Cfg<BN>;
  cudaError_t err = cudaFuncSetAttribute(gemm_bf16<BN, kTA, kTB, Epi>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return err;
  CUtensorMap ta, tb;
  if (!make_map_2d(&ta, a, kTA ? sh.M : sh.K, kTA ? sh.K : sh.M, lda, kTA ? 64 : kBM) ||
      !make_map_2d(&tb, b, kTB ? sh.N : sh.K, kTB ? sh.K : sh.N, ldb, kTB ? 64 : BN)) {
    return cudaErrorInvalidValue;
  }
  int sms = 0;
  err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const long long tiles = static_cast<long long>((sh.M + kBM - 1) / kBM) * (sh.N / BN) * sh.splits;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const int blocks = static_cast<int>(std::min<long long>(tiles, sms));
  gemm_bf16<BN, kTA, kTB, Epi><<<blocks, kThreads, C::kSmem, s>>>(ta, tb, epi, sh);
  return cudaGetLastError();
}

// C = A . B^T through `epi`, as `plan` tiles and splits it: a (M x K) K-major
// or, with kTA, (K x M) MN-major, row stride lda; b likewise (N x K) or
// (K x N). The caller's functor sees the split of each partial.
template <bool kTA, bool kTB, class Epi>
cudaError_t gemm(const void* a, long long lda, const void* b, long long ldb, const Plan& pl,
                 int M, int N, int K, const Epi& epi, cudaStream_t s) {
  if (M <= 0 || K % kBK != 0 || pl.bn == 0) return cudaErrorInvalidValue;
  const Shape sh{M, N, K, pl.depth, pl.count};
  switch (pl.bn) {
    case 192:
      return launch_bn<192, kTA, kTB>(a, lda, b, ldb, sh, epi, s);
    default:
      return launch_bn<128, kTA, kTB>(a, lda, b, ldb, sh, epi, s);
  }
}

}  // namespace gemm90
