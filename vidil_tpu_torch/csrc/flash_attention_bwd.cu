// Flash-attention backward for Hopper (sm_90a): dq, dk, dv of
// o = softmax(q k^T / sqrt(D)) v, from the saved o and the forward's
// logsumexp rows.
//
// Replaces the TPU kernel vidil_tpu/ops/flash_attention.py:_flash_backward
// (body _flash_bwd_kernel). It computes the same function with the same
// rounding points:
//   * q is pre-scaled by 1/sqrt(D) in the input dtype (the wrapper passes
//     the scale already rounded to that dtype);
//   * Delta = rowsum(g * o) in fp32;
//   * s = q k^T and dp = g v^T accumulate in fp32; p = exp(s - lse) is fp32
//     and is rounded to v's dtype only as the operand of p^T g;
//   * ds = p * (dp - Delta) is rounded to the input dtype before both of its
//     products (ds k and ds^T q);
//   * dk = ds^T q_scaled and dv = p^T g accumulate in fp32 over the whole
//     query axis and are rounded once;
//   * dq accumulates in fp32, is rounded to the dtype, and is then
//     multiplied by the dtype-rounded scale in that dtype;
//   * keys past Lk have p = 0 (the TPU kernel's -1e30 score); query rows past
//     Lq contribute nothing. Nothing is padded in device memory.
// The bf16 kernels apply the scale to the fp32 scores, and to the fp32 dk
// sums, instead of to q: at D = 64 it is 0.125, a power of two, so
// (q * 0.125) k^T = 0.125 (q k^T) and ds^T (q * 0.125) = 0.125 (ds^T q) bit
// for bit, short of subnormal q (as K1 does since its redesign).
//
// p = exp(s - lse) is computed as 2^(s c - lse log2(e)), c = scale log2(e):
// one FMA and the SFU's ex2 (K1's way), which can differ from expf in the
// last fp32 bits and so move a bf16 rounding of p or ds by one ulp.
//
// Design. The TPU kernel held the whole padded query axis in one VMEM block
// so that dk/dv needed no accumulation across programs. On Hopper the
// blocks run in parallel and in no order, so the work is two kernels that
// need no atomics (results are identical run to run; an atomic dq, which
// would save the two recomputed products, is not):
//   1. dq: work items of (batch*head, 128 query rows), walking 128-key
//      tiles: s = q k^T, dp = g v^T, ds, dq += ds k. It computes Delta for
//      its rows and writes it, with lse log2(e), into a (B*H, 2, Lq rounded
//      up to 64) fp32 scratch for kernel 2; past Lq the copy holds +inf and
//      Delta 0, so that a padded query row gets p = 2^-inf = 0 there with no
//      mask.
//   2. dk/dv: work items of (batch*head, 128 keys), walking 64-row query
//      tiles: s^T = k q^T, dp^T = v g^T, p^T, ds^T, dv += p^T g,
//      dk += ds^T q; 7 products in all where one pass with an atomic dq
//      would run 5.
//   bf16: persistent blocks (one per SM, walking the items) of three
//     warpgroups, as K1's (flash_attention_fwd.cu): a producer whose one
//     thread issues TMA loads on 4-D tensor maps (sm90.cuh:make_map_4d,
//     the strided views need no copy; rows past L read as zeros) and gives
//     its registers away (setmaxnreg), and two consumer warpgroups that own
//     64 of the item's rows each. The item's own operands (q and g in
//     kernel 1, k and v in kernel 2, 128 rows each) are double-buffered
//     across items; the walked tiles (k and v, or q and g with their 64
//     lse and Delta values, the latter by 1-D bulk copies) stream through
//     a ring of kStages stages on full/empty mbarriers, shared by both
//     consumers. Every product is a wgmma: s and dp (or their transposes)
//     are SS (m64n128k16 in kernel 1, m64n64k16 in kernel 2) from K-major
//     tiles; ds k, p^T g and ds^T q are RS m64n64k16 whose A operand is the
//     bf16 p or ds packed in registers straight from the fp32 accumulator
//     fragment (it is already the A fragment: no transposed copy in shared
//     memory), and whose B operand (k, g or q in its natural (row, D)
//     layout) is read MN-major. Turn j of an item issues tile j's two SS
//     products with tile j-1's RS ones as one wgmma group, and the two
//     consumers take turns on named barriers (ping-pong), so that one's
//     exponentials overlap the other's products. Ragged tails are masked
//     in registers.
//   fp32: one thread per row (q rows in kernel 1, keys in kernel 2), plain
//     fp32 FMAs (no TF32): fp32 is not a main-path dtype.
// Inputs take batch/head/sequence strides with unit stride over D: q, k, v
// arrive as head-split views of the QKV projection, g as a view of the
// merge_heads gradient, o as the forward's (B, Lq, H, D) allocation.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): at the 224-px
// trainer shape (48, 12, 197, 64) bf16 it reads q, k, v, o, g and lse and
// writes dq, dk, dv (~117 MB) -> ~35 us by bytes, against 14.3 GFLOP of
// the five products -> ~14.5 us; at the 384-px shape (32, 12, 577, 64)
// ~228 MB -> 68 us and 81.8 GFLOP -> ~83 us (the 7 products run here: 114.5
// GFLOP, 116 us at the dense peak).
// Measured (chip_smoke.py phase 7b, one H100 80GB HBM3 at 700 W): at
// (32, 12, 577, 64) bf16 views, 0.346 ms of device time (dq kernel 0.154,
// dk/dv 0.192: 331 TFLOP/s over the 7 products, 236 over the bound's 5)
// against SDPA backward's 0.360; at (48, 12, 197, 64) 0.131 (0.068 +
// 0.064) against 0.133; by single launch 0.426 and 0.226 ms. What holds it:
// at 197 the padded tiles (197 rows and keys each run as 256: 59% of the
// (q, k) work is real) and each item's loads; at 577 the two recomputed
// products and the m64n64 shapes of kernel 2.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kD = 64;        // head dim
constexpr int kBlock = 64;    // fp32 kernels: rows per tile (q rows or keys)
constexpr int kBlockQ32 = 16; // q rows per tile in the fp32 dk/dv kernel
constexpr int kStatAlign = 64;  // the scratch's rows are Lq rounded up to this

// bf16 (wgmma) tiling
constexpr int kRows = 128;    // an item's rows: q rows (kernel 1) or keys (kernel 2)
constexpr int kDqTile = 128;  // kernel 1's walked tiles: 128 keys
constexpr int kDkTile = 64;   // kernel 2's walked tiles: 64 q rows
constexpr int kStages = 4;    // ring depth of walked tiles
constexpr int kThreads = 384; // producer warpgroup + two consumer warpgroups
constexpr int kBoxRows = 64;  // rows of one TMA box (8 KB of bf16 over D = 64)
constexpr int kBoxBytes = kBoxRows * kD * 2;
constexpr int kResBytes = kRows * kD * 2;           // one 128-row item operand, 16 KB
constexpr int kStatBytes = kDkTile * 4;             // 64 fp32 lse or Delta values
constexpr int kBarTurn = 1;   // named barriers 1, 2: each consumer's wgmma turn
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* g;
  const float* lse;   // (B*H, Lq), contiguous
  float* stats;       // (B*H, 2, Lq_pad) scratch: lse copy, Delta (kernel 1 writes)
  void* dq;
  void* dk;
  void* dv;
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  long long g_sb, g_sh, g_ss;
  long long dq_sb, dq_sh, dq_ss;
  long long dk_sb, dk_sh, dk_ss;
  long long dv_sb, dv_sh, dv_ss;
  int B, H, Lq, Lk, Lq_pad;
  float scale;
};

__device__ __forceinline__ float* lse_row(const Params& p, int bh) {
  return p.stats + static_cast<long long>(2 * bh) * p.Lq_pad;
}
__device__ __forceinline__ float* delta_row(const Params& p, int bh) {
  return p.stats + static_cast<long long>(2 * bh + 1) * p.Lq_pad;
}

// Shared memory of a bf16 block whose walked tiles have kWalk rows:
// barriers and buffers at fixed offsets from a 1 KB-aligned base (128-byte
// swizzle atoms are 1 KB): two item buffers of two 128-row operands, the
// ring of walked tiles (two operands a stage), 64 lse and Delta values a
// stage (kernel 2).
template <int kWalk>
struct Smem {
  static constexpr int kWalkBytes = kWalk * kD * 2;
  static constexpr int kOffStage = 2 * 2 * kResBytes;
  static constexpr int kOffStat = kOffStage + kStages * 2 * kWalkBytes;
  static constexpr int kOffBar = kOffStat + kStages * 2 * kStatBytes;
  static constexpr int kBytes = kOffBar + 8 * (4 + 2 * kStages) + 1024;  // + alignment slack
  uint32_t base;
  uint8_t* ptr;
  // item buffer r (0, 1), operand i (0, 1): 128 rows
  __device__ uint32_t res(int r, int i) const { return base + (2 * r + i) * kResBytes; }
  // stage s, operand i: kWalk rows
  __device__ uint32_t tile(int s, int i) const {
    return base + kOffStage + (2 * s + i) * kWalkBytes;
  }
  // stage s, stat i (0: lse log2(e), 1: Delta): 64 floats
  __device__ uint32_t stat(int s, int i) const {
    return base + kOffStat + (2 * s + i) * kStatBytes;
  }
  __device__ const float* stat_ptr(int s, int i) const {
    return reinterpret_cast<const float*>(ptr + kOffStat + (2 * s + i) * kStatBytes);
  }
  __device__ uint32_t res_full(int r) const { return base + kOffBar + 8 * r; }
  __device__ uint32_t res_empty(int r) const { return base + kOffBar + 8 * (2 + r); }
  __device__ uint32_t full(int s) const { return base + kOffBar + 8 * (4 + s); }
  __device__ uint32_t empty(int s) const { return base + kOffBar + 8 * (4 + kStages + s); }

  __device__ static Smem init() {
    extern __shared__ uint8_t smem_raw[];
    const uint32_t raw = smem_u32(smem_raw);
    const uint32_t aligned = (raw + 1023u) & ~1023u;
    Smem sm{aligned, smem_raw + (aligned - raw)};
    if (threadIdx.x == 0) {
      for (int r = 0; r < 2; ++r) {
        bar_init(sm.res_full(r), 1);
        bar_init(sm.res_empty(r), 8);  // one arrival per consumer warp
      }
      for (int s = 0; s < kStages; ++s) {
        bar_init(sm.full(s), 1);
        bar_init(sm.empty(s), 8);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    return sm;
  }

  // The producer thread's loads for item n: its two 128-row operands (maps
  // ma, mb at rows row0) into item buffer n & 1, then `tiles` walked tiles
  // of maps ta, tb (with 64 lse and Delta values each when `lse`) into the
  // ring, in 64-row TMA boxes. `it` counts the walked tiles loaded so far:
  // the ring's stage and phase.
  __device__ void produce_item(int n, const CUtensorMap* ma, const CUtensorMap* mb, int row0,
                               const CUtensorMap* ta, const CUtensorMap* tb, int tiles,
                               const float* lse, const float* delta, int h, int b,
                               int& it) const {
    const int r = n & 1;
    if (n >= 2) bar_wait(res_empty(r), ((n >> 1) - 1) & 1);  // item n - 2 is done with it
    bar_expect_tx(res_full(r), 2 * kResBytes);
    for (int box = 0; box < kRows / kBoxRows; ++box) {
      tma_load(res(r, 0) + box * kBoxBytes, ma, res_full(r), row0 + box * kBoxRows, h, b);
      tma_load(res(r, 1) + box * kBoxBytes, mb, res_full(r), row0 + box * kBoxRows, h, b);
    }
    for (int j = 0; j < tiles; ++j, ++it) {
      const int s = it % kStages;
      bar_wait(empty(s), ((it / kStages) & 1) ^ 1);
      bar_expect_tx(full(s), 2 * kWalkBytes + (lse != nullptr ? 2 * kStatBytes : 0));
      for (int box = 0; box < kWalk / kBoxRows; ++box) {
        tma_load(tile(s, 0) + box * kBoxBytes, ta, full(s), j * kWalk + box * kBoxRows, h, b);
        tma_load(tile(s, 1) + box * kBoxBytes, tb, full(s), j * kWalk + box * kBoxRows, h, b);
      }
      if (lse != nullptr) {
        bulk_load(stat(s, 0), lse + j * kWalk, kStatBytes, full(s));
        bulk_load(stat(s, 1), delta + j * kWalk, kStatBytes, full(s));
      }
    }
  }
};

// ---------------------------------------------------------------------------
// bf16 kernel 1: dq (and Delta), items of (batch*head, 128 q rows)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dq_bf16(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_g,
    const Params p) {
  using Sm = Smem<kDqTile>;
  const Sm sm = Sm::init();
  const int q_tiles = (p.Lq + kRows - 1) / kRows;
  const int items = p.B * p.H * q_tiles;
  const int k_tiles = (p.Lk + kDqTile - 1) / kDqTile;
  // broadcast, so that the compiler sees a warp-uniform value
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x / 128), 0);
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      int it = 0;
      for (int w = blockIdx.x, n = 0; w < items; w += gridDim.x, ++n) {
        const int bh = w / q_tiles;
        sm.produce_item(n, &tm_q, &tm_g, (w % q_tiles) * kRows, &tm_k, &tm_v, k_tiles, nullptr,
                        nullptr, bh % p.H, bh / p.H, it);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int cw = wg - 1;  // consumer warpgroup: rows 64 cw .. 64 cw + 63 of the item
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;   // accumulator row group: rows g and g + 8 of the warp's 16
  const int t4 = lane % 4;  // thread within the quad
  const float c = p.scale * kLog2e;
  if (cw == 1) named_arrive(kBarTurn, 256);  // consumer 0 takes the first turn
  int it = 0;
  for (int w = blockIdx.x, n = 0; w < items; w += gridDim.x, ++n, it += k_tiles) {
    const bool last_item = w + static_cast<int>(gridDim.x) >= items;
    const int bh = w / q_tiles;
    const int b = bh / p.H;
    const int h = bh % p.H;
    const int r = n & 1;
    // this thread's two q rows
    int rows[2];
    bool valid[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rows[i] = (w % q_tiles) * kRows + cw * 64 + warp * 16 + g + 8 * i;
      valid[i] = rows[i] < p.Lq;
    }
    // Delta = rowsum(g * o) in fp32: the quad shares its two rows, 16
    // columns a thread; written with lse log2(e) for kernel 2
    float lse_l2[2], delta_r[2];
    const __nv_bfloat16* gp = static_cast<const __nv_bfloat16*>(p.g) + b * p.g_sb + h * p.g_sh;
    const __nv_bfloat16* op = static_cast<const __nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float d = 0.f;
      if (valid[i]) {
        const uint4* gv = reinterpret_cast<const uint4*>(gp + rows[i] * p.g_ss + 16 * t4);
        const uint4* ov = reinterpret_cast<const uint4*>(op + rows[i] * p.o_ss + 16 * t4);
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const uint4 ga = gv[q], oa = ov[q];
          const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&ga);
          const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&oa);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 gf = __bfloat1622float2(g2[e]), of = __bfloat1622float2(o2[e]);
            d = fmaf(gf.x, of.x, d);
            d = fmaf(gf.y, of.y, d);
          }
        }
      }
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      d += __shfl_xor_sync(0xffffffffu, d, 2);
      delta_r[i] = d;
      lse_l2[i] = valid[i] ? p.lse[static_cast<long long>(bh) * p.Lq + rows[i]] * kLog2e : 0.f;
      if (t4 == 0 && rows[i] < p.Lq_pad) {
        lse_row(p, bh)[rows[i]] = valid[i] ? lse_l2[i] : INFINITY;
        delta_row(p, bh)[rows[i]] = d;
      }
    }

    bar_wait(sm.res_full(r), (n >> 1) & 1);
    const uint64_t desc_q = smem_desc(sm.res(r, 0) + cw * kBoxBytes, 16, 1024);
    const uint64_t desc_g = smem_desc(sm.res(r, 1) + cw * kBoxBytes, 16, 1024);
    float acc[32];  // dq: n-tile j = i / 4 holds head dims 8j + 2 t4 + (i & 1), rows g, g + 8
    uint32_t dsa[32];  // the last tile's ds as the A operand of ds k
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      acc[i] = 0.f;
      dsa[i] = 0u;
    }
    // Turn j issues tile j's s = q k^T and dp = g v^T (j < k_tiles) and tile
    // j-1's dq += ds k (j > 0) as one wgmma group; the consumers take turns
    // (named barriers), so that one's exponentials overlap the other's
    // products
    for (int j = 0; j <= k_tiles; ++j) {
      const bool ss = j < k_tiles;
      const bool rs = j > 0;
      const int s_cur = (it + j) % kStages;
      const int s_prev = (it + j - 1) % kStages;
      if (ss) bar_wait(sm.full(s_cur), ((it + j) / kStages) & 1);
      float sc[64], dp[64];  // fresh arrays, written by the wgmmas alone
      named_sync(kBarTurn + cw, 256);
      fence_regs(acc);
      fence_regs(dsa);
      wgmma_fence();
      if (ss) {
        const uint64_t desc_k = smem_desc(sm.tile(s_cur, 0), 16, 1024);
        const uint64_t desc_v = smem_desc(sm.tile(s_cur, 1), 16, 1024);
#pragma unroll
        for (int kc = 0; kc < kD / 16; ++kc) wgmma_m64n128_ss(sc, desc_q + 2 * kc, desc_k + 2 * kc, kc > 0);
#pragma unroll
        for (int kc = 0; kc < kD / 16; ++kc) wgmma_m64n128_ss(dp, desc_g + 2 * kc, desc_v + 2 * kc, kc > 0);
      }
      if (rs) {  // k read MN-major (its natural (key, D) layout)
        const uint64_t desc_k = smem_desc(sm.tile(s_prev, 0), 16, 1024);
#pragma unroll
        for (int kk = 0; kk < kDqTile / 16; ++kk) {
          wgmma_m64n64_rs(acc, dsa[4 * kk], dsa[4 * kk + 1], dsa[4 * kk + 2], dsa[4 * kk + 3],
                          desc_k + 128 * kk);
        }
      }
      wgmma_commit();
      if (cw == 0 || ss || !last_item) named_arrive(kBarTurn + 1 - cw, 256);
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(dsa);
      if (rs) warp_arrive(sm.empty(s_prev));
      if (j == k_tiles - 1) warp_arrive(sm.res_empty(r));  // the last q and g read
      if (!ss) continue;
      fence_regs(sc);
      fence_regs(dp);
      // ds = p (dp - Delta), p = exp(s * scale - lse) = 2^(s c - lse log2(e)),
      // 0 past Lk; packed in pairs as the A operand of ds k (pair i: n-tile
      // i / 2, row g + 8 (i & 1))
      const int key0 = j * kDqTile + 2 * t4;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int rr = i & 1;
        const int key = key0 + 8 * (i / 2);
        const float p0 = key < p.Lk ? ex2(fmaf(sc[2 * i], c, -lse_l2[rr])) : 0.f;
        const float p1 = key + 1 < p.Lk ? ex2(fmaf(sc[2 * i + 1], c, -lse_l2[rr])) : 0.f;
        dsa[i] = pack_bf16x2(p0 * (dp[2 * i] - delta_r[rr]), p1 * (dp[2 * i + 1] - delta_r[rr]));
      }
    }

    // dq = round(acc) * round(scale), in bf16
    const __nv_bfloat162 scale_b = __bfloat162bfloat162(__float2bfloat16_rn(p.scale));
    __nv_bfloat16* dq = static_cast<__nv_bfloat16*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (!valid[i]) continue;
      __nv_bfloat16* out = dq + rows[i] * p.dq_ss + 2 * t4;
#pragma unroll
      for (int jn = 0; jn < kD / 8; ++jn) {
        const __nv_bfloat162 v = __floats2bfloat162_rn(acc[4 * jn + 2 * i], acc[4 * jn + 2 * i + 1]);
        *reinterpret_cast<__nv_bfloat162*>(out + 8 * jn) = __hmul2(v, scale_b);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 kernel 2: dk, dv, items of (batch*head, 128 keys)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dkdv_bf16(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_g,
    const Params p) {
  using Sm = Smem<kDkTile>;
  const Sm sm = Sm::init();
  const int k_items = (p.Lk + kRows - 1) / kRows;
  const int items = p.B * p.H * k_items;
  const int q_tiles = p.Lq_pad / kDkTile;
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x / 128), 0);
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      int it = 0;
      for (int w = blockIdx.x, n = 0; w < items; w += gridDim.x, ++n) {
        const int bh = w / k_items;
        sm.produce_item(n, &tm_k, &tm_v, (w % k_items) * kRows, &tm_q, &tm_g, q_tiles,
                        lse_row(p, bh), delta_row(p, bh), bh % p.H, bh / p.H, it);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int cw = wg - 1;  // consumer warpgroup: keys 64 cw .. 64 cw + 63 of the item
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const float c = p.scale * kLog2e;
  if (cw == 1) named_arrive(kBarTurn, 256);  // consumer 0 takes the first turn
  int it = 0;
  for (int w = blockIdx.x, n = 0; w < items; w += gridDim.x, ++n, it += q_tiles) {
    const bool last_item = w + static_cast<int>(gridDim.x) >= items;
    const int bh = w / k_items;
    const int b = bh / p.H;
    const int h = bh % p.H;
    const int r = n & 1;
    bar_wait(sm.res_full(r), (n >> 1) & 1);
    const uint64_t desc_k = smem_desc(sm.res(r, 0) + cw * kBoxBytes, 16, 1024);
    const uint64_t desc_v = smem_desc(sm.res(r, 1) + cw * kBoxBytes, 16, 1024);
    // dk, dv: n-tile j = i / 4 holds head dims 8j + 2 t4 + (i & 1), keys g, g + 8
    float dk[32], dv[32];
    uint32_t pa[16], dsa[16];  // the last tile's p^T and ds^T as A operands
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) pa[i] = dsa[i] = 0u;
    // Turn j issues tile j's s^T = k q^T and dp^T = v g^T (j < q_tiles) and
    // tile j-1's dv += p^T g and dk += ds^T q (j > 0) as one wgmma group, the
    // consumers taking turns as in kernel 1
    for (int j = 0; j <= q_tiles; ++j) {
      const bool ss = j < q_tiles;
      const bool rs = j > 0;
      const int s_cur = (it + j) % kStages;
      const int s_prev = (it + j - 1) % kStages;
      if (ss) bar_wait(sm.full(s_cur), ((it + j) / kStages) & 1);
      float st[32], dpt[32];  // rows: this warpgroup's keys; columns: the tile's q rows
      named_sync(kBarTurn + cw, 256);
      fence_regs(dk);
      fence_regs(dv);
      fence_regs(pa);
      fence_regs(dsa);
      wgmma_fence();
      if (ss) {
        const uint64_t desc_q = smem_desc(sm.tile(s_cur, 0), 16, 1024);
        const uint64_t desc_g = smem_desc(sm.tile(s_cur, 1), 16, 1024);
#pragma unroll
        for (int kc = 0; kc < kD / 16; ++kc) wgmma_m64n64_ss(st, desc_k + 2 * kc, desc_q + 2 * kc, kc > 0);
#pragma unroll
        for (int kc = 0; kc < kD / 16; ++kc) wgmma_m64n64_ss(dpt, desc_v + 2 * kc, desc_g + 2 * kc, kc > 0);
      }
      if (rs) {  // g and q read MN-major
        const uint64_t desc_q = smem_desc(sm.tile(s_prev, 0), 16, 1024);
        const uint64_t desc_g = smem_desc(sm.tile(s_prev, 1), 16, 1024);
#pragma unroll
        for (int kk = 0; kk < kDkTile / 16; ++kk) {
          wgmma_m64n64_rs(dv, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3],
                          desc_g + 128 * kk);
        }
#pragma unroll
        for (int kk = 0; kk < kDkTile / 16; ++kk) {
          wgmma_m64n64_rs(dk, dsa[4 * kk], dsa[4 * kk + 1], dsa[4 * kk + 2], dsa[4 * kk + 3],
                          desc_q + 128 * kk);
        }
      }
      wgmma_commit();
      if (cw == 0 || ss || !last_item) named_arrive(kBarTurn + 1 - cw, 256);
      wgmma_wait<0>();
      fence_regs(dk);
      fence_regs(dv);
      fence_regs(pa);
      fence_regs(dsa);
      if (rs) warp_arrive(sm.empty(s_prev));
      if (j == q_tiles - 1) warp_arrive(sm.res_empty(r));  // the last k and v read
      if (!ss) continue;
      fence_regs(st);
      fence_regs(dpt);
      // p^T = exp(s^T * scale - lse) = 2^(s^T c - lse log2(e)) (0 on query
      // rows past Lq, whose copy is +inf), ds^T = p^T (dp^T - Delta); pair i
      // holds the tile's q rows 8 (i / 2) + 2 t4 + {0, 1}
      const float* lse_s = sm.stat_ptr(s_cur, 0);
      const float* delta_s = sm.stat_ptr(s_cur, 1);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int col = 8 * (i / 2) + 2 * t4;
        const float2 l2 = *reinterpret_cast<const float2*>(lse_s + col);
        const float2 d2 = *reinterpret_cast<const float2*>(delta_s + col);
        const float p0 = ex2(fmaf(st[2 * i], c, -l2.x));
        const float p1 = ex2(fmaf(st[2 * i + 1], c, -l2.y));
        pa[i] = pack_bf16x2(p0, p1);
        dsa[i] = pack_bf16x2(p0 * (dpt[2 * i] - d2.x), p1 * (dpt[2 * i + 1] - d2.y));
      }
    }

    // dk = round(acc * scale) (exact: a power of two), dv = round(acc)
    __nv_bfloat16* dkp = static_cast<__nv_bfloat16*>(p.dk) + b * p.dk_sb + h * p.dk_sh;
    __nv_bfloat16* dvp = static_cast<__nv_bfloat16*>(p.dv) + b * p.dv_sb + h * p.dv_sh;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int key = (w % k_items) * kRows + cw * 64 + warp * 16 + g + 8 * i;
      if (key >= p.Lk) continue;
#pragma unroll
      for (int jn = 0; jn < kD / 8; ++jn) {
        const int col = 8 * jn + 2 * t4;
        *reinterpret_cast<uint32_t*>(dkp + key * p.dk_ss + col) =
            pack_bf16x2(dk[4 * jn + 2 * i] * p.scale, dk[4 * jn + 2 * i + 1] * p.scale);
        *reinterpret_cast<uint32_t*>(dvp + key * p.dv_ss + col) =
            pack_bf16x2(dv[4 * jn + 2 * i], dv[4 * jn + 2 * i + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// fp32 kernel 1: dq (and Delta), one thread per q row, plain FMAs
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(64) flash_bwd_dq_f32(const Params p) {
  __shared__ __align__(16) float k_s[kBlock][kD];
  __shared__ __align__(16) float v_s[kBlock][kD];

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int row = blockIdx.y * kBlock + tid;
  const bool valid = row < p.Lq;

  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* o = static_cast<const float*>(p.o) + b * p.o_sb + h * p.o_sh;
  const float* gr = static_cast<const float*>(p.g) + b * p.g_sb + h * p.g_sh;
  float* dq = static_cast<float*>(p.dq) + b * p.dq_sb + h * p.dq_sh;

  float qr[kD], grow[kD], acc[kD];
  float delta = 0.f;
#pragma unroll
  for (int d = 0; d < kD; ++d) {
    qr[d] = valid ? q[row * p.q_ss + d] * p.scale : 0.f;
    grow[d] = valid ? gr[row * p.g_ss + d] : 0.f;
    delta = fmaf(grow[d], valid ? o[row * p.o_ss + d] : 0.f, delta);
    acc[d] = 0.f;
  }
  const float lse = valid ? p.lse[static_cast<long long>(bh) * p.Lq + row] : 0.f;
  if (valid) delta_row(p, bh)[row] = delta;

  for (int n0 = 0; n0 < p.Lk; n0 += kBlock) {
    __syncthreads();
    for (int i = tid; i < kBlock * kD / 4; i += blockDim.x) {
      const int r = i / (kD / 4);
      const int c = (i % (kD / 4)) * 4;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vv = make_float4(0.f, 0.f, 0.f, 0.f);
      if (n0 + r < p.Lk) {
        kv = *reinterpret_cast<const float4*>(k + (n0 + r) * p.k_ss + c);
        vv = *reinterpret_cast<const float4*>(v + (n0 + r) * p.v_ss + c);
      }
      *reinterpret_cast<float4*>(&k_s[r][c]) = kv;
      *reinterpret_cast<float4*>(&v_s[r][c]) = vv;
    }
    __syncthreads();
    if (!valid) continue;
    const int n_valid = min(kBlock, p.Lk - n0);
#pragma unroll 1
    for (int j = 0; j < n_valid; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < kD; ++d) {
        s = fmaf(qr[d], k_s[j][d], s);
        dp = fmaf(grow[d], v_s[j][d], dp);
      }
      const float ds = expf(s - lse) * (dp - delta);
#pragma unroll
      for (int d = 0; d < kD; ++d) acc[d] = fmaf(ds, k_s[j][d], acc[d]);
    }
  }
  if (valid) {
#pragma unroll
    for (int d = 0; d < kD; ++d) dq[row * p.dq_ss + d] = acc[d] * p.scale;
  }
}

// ---------------------------------------------------------------------------
// fp32 kernel 2: dk, dv, one thread per key, plain FMAs
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(64) flash_bwd_dkdv_f32(const Params p) {
  __shared__ float k_s[kBlock][kD + 1];  // +1: each thread reads its own row
  __shared__ float v_s[kBlock][kD + 1];
  __shared__ __align__(16) float q_s[kBlockQ32][kD];
  __shared__ __align__(16) float g_s[kBlockQ32][kD];
  __shared__ float lse_s[kBlockQ32];
  __shared__ float delta_s[kBlockQ32];

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int key = blockIdx.y * kBlock + tid;
  const bool valid = key < p.Lk;

  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* gr = static_cast<const float*>(p.g) + b * p.g_sb + h * p.g_sh;
  float* dk = static_cast<float*>(p.dk) + b * p.dk_sb + h * p.dk_sh;
  float* dv = static_cast<float*>(p.dv) + b * p.dv_sb + h * p.dv_sh;
  const float* lse = p.lse + static_cast<long long>(bh) * p.Lq;
  const float* delta = delta_row(p, bh);

  float dk_acc[kD], dv_acc[kD];
#pragma unroll
  for (int d = 0; d < kD; ++d) {
    k_s[tid][d] = valid ? k[key * p.k_ss + d] : 0.f;
    v_s[tid][d] = valid ? v[key * p.v_ss + d] : 0.f;
    dk_acc[d] = 0.f;
    dv_acc[d] = 0.f;
  }

  for (int m0 = 0; m0 < p.Lq; m0 += kBlockQ32) {
    __syncthreads();
    for (int i = tid; i < kBlockQ32 * kD / 4; i += blockDim.x) {
      const int r = i / (kD / 4);
      const int c = (i % (kD / 4)) * 4;
      float4 qv = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 gv = make_float4(0.f, 0.f, 0.f, 0.f);
      if (m0 + r < p.Lq) {
        qv = *reinterpret_cast<const float4*>(q + (m0 + r) * p.q_ss + c);
        gv = *reinterpret_cast<const float4*>(gr + (m0 + r) * p.g_ss + c);
      }
      qv.x *= p.scale; qv.y *= p.scale; qv.z *= p.scale; qv.w *= p.scale;
      *reinterpret_cast<float4*>(&q_s[r][c]) = qv;
      *reinterpret_cast<float4*>(&g_s[r][c]) = gv;
    }
    if (tid < kBlockQ32) {
      const bool ok = m0 + tid < p.Lq;
      lse_s[tid] = ok ? lse[m0 + tid] : 0.f;
      delta_s[tid] = ok ? delta[m0 + tid] : 0.f;
    }
    __syncthreads();
    if (!valid) continue;
    const int n_valid = min(kBlockQ32, p.Lq - m0);
#pragma unroll 1
    for (int j = 0; j < n_valid; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < kD; ++d) {
        s = fmaf(k_s[tid][d], q_s[j][d], s);
        dp = fmaf(v_s[tid][d], g_s[j][d], dp);
      }
      const float pr = expf(s - lse_s[j]);
      const float ds = pr * (dp - delta_s[j]);
#pragma unroll
      for (int d = 0; d < kD; ++d) {
        dv_acc[d] = fmaf(pr, g_s[j][d], dv_acc[d]);
        dk_acc[d] = fmaf(ds, q_s[j][d], dk_acc[d]);
      }
    }
  }
  if (valid) {
#pragma unroll
    for (int d = 0; d < kD; ++d) {
      dk[key * p.dk_ss + d] = dk_acc[d];
      dv[key * p.dv_ss + d] = dv_acc[d];
    }
  }
}

}  // namespace

// dtype: 0 = bf16, 1 = fp32. Strides are in elements; the last dim has unit
// stride. lse is a contiguous (B*H, Lq) fp32 input; stats a contiguous
// (B*H, 2, round_up(Lq, 64)) fp32 scratch. Launches the dq kernel, then the
// dk/dv kernel, on `stream`; returns cudaGetLastError() after the launches
// (0 on success).
extern "C" int vidil_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o, const void* g,
    const float* lse, float* stats, void* dq, void* dk, void* dv,
    int dtype, int device, int B, int H, int Lq, int Lk, int D,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    long long g_sb, long long g_sh, long long g_ss,
    long long dq_sb, long long dq_sh, long long dq_ss,
    long long dk_sb, long long dk_sh, long long dk_ss,
    long long dv_sb, long long dv_sh, long long dv_ss,
    float scale, void* stream) {
  if (D != kD || B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int Lq_pad = (Lq + kStatAlign - 1) / kStatAlign * kStatAlign;
  Params p{q, k, v, o, g, lse, stats, dq, dk, dv,
           q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
           o_sb, o_sh, o_ss, g_sb, g_sh, g_ss,
           dq_sb, dq_sh, dq_ss, dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, dv_ss,
           B, H, Lq, Lk, Lq_pad, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    CUtensorMap tq, tk, tv, tg;
    if (!make_map_4d(&tq, q, B, H, Lq, q_sb, q_sh, q_ss, kBoxRows) ||
        !make_map_4d(&tk, k, B, H, Lk, k_sb, k_sh, k_ss, kBoxRows) ||
        !make_map_4d(&tv, v, B, H, Lk, v_sb, v_sh, v_ss, kBoxRows) ||
        !make_map_4d(&tg, g, B, H, Lq, g_sb, g_sh, g_ss, kBoxRows)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    int sms = 0;
    err = sm_count(&sms);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long dq_items = static_cast<long long>(B) * H * ((Lq + kRows - 1) / kRows);
    const long long dkdv_items = static_cast<long long>(B) * H * ((Lk + kRows - 1) / kRows);
    if (std::max(dq_items, dkdv_items) > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
    constexpr int kDqSmem = Smem<kDqTile>::kBytes;
    constexpr int kDkSmem = Smem<kDkTile>::kBytes;
    err = cudaFuncSetAttribute(flash_bwd_dq_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kDqSmem);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(flash_bwd_dkdv_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kDkSmem);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_bwd_dq_bf16<<<static_cast<int>(std::min<long long>(dq_items, sms)), kThreads, kDqSmem,
                        s>>>(tq, tk, tv, tg, p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_bwd_dkdv_bf16<<<static_cast<int>(std::min<long long>(dkdv_items, sms)), kThreads,
                          kDkSmem, s>>>(tq, tk, tv, tg, p);
  } else if (dtype == 1) {
    const dim3 grid_q(B * H, (Lq + kBlock - 1) / kBlock);
    const dim3 grid_k(B * H, (Lk + kBlock - 1) / kBlock);
    flash_bwd_dq_f32<<<grid_q, kBlock, 0, s>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_bwd_dkdv_f32<<<grid_k, kBlock, 0, s>>>(p);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
