// The experts' grouped GEMM (kernel K7) for Hopper (sm_90a):
//   out[o_e : o_{e+1}] = epi(x[o_e : o_{e+1}] . w[e]^T)   for every expert e,
// x (R, K) bf16, the routed rows sorted by expert; w (E, N, K) bf16, every
// expert's weight; offsets (E + 1,) int32 on the device, o_E = R; out (R, N)
// bf16; epi relu(.)^2 (Nemotron-H's up projection), SwiGLU (Kimi Linear's
// up projection: w's rows hold the gate's and the up's interleaved in
// blocks of 8, rows 16m..16m+7 the gate's 8m..8m+7 and rows 16m+8..16m+15
// the up's, and out (R, N / 2) gets SiLU(gate) * up of each column) or the
// identity (the down projection). fp32 accumulation; the activation on the
// fp32 sums; one rounding to bf16 (the rounding points of the plain
// version, ops/grouped_expert_gemm.py:grouped_expert_gemm_ref). Rows past
// o_E (pairs routed to experts another card holds) are left alone.
//
// Replaces no TPU kernel: the JAX package runs no mixture of experts. It is
// the port's first GEMM whose weight matrix changes with the row and whose
// row counts are known only on the device: the router's output decides how
// many rows each expert gets, and no host reads it, so a decode step that
// calls it can be captured into a CUDA graph.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s). Prefill, ~1.7k
// rows an expert: 2 R N K operations (2.2 TFLOP for 216k rows at N 1856, K
// 2688) against 1.3 GB of weights and rows: bound by operations. Decode, 0-3
// rows an expert: ~69 of 128 experts hit by 96 rows, each expert's 10 MB
// weight read once: bound by bytes (~0.2 ms a call), the operations ~1 us.
//
// Design, on the machinery of gemm_sm90.cuh (its wgmma m64n192k16 shape, its
// 2-D TMA maps with the 128-byte swizzle) and sm90.cuh (mbarriers):
//   * tiles of 128 rows of one expert x 192 columns; an expert's last row
//     tile reaches into the next expert's rows (or past R, read as zeros by
//     TMA) and its last column tile into the next expert's weight rows (or
//     past E N): the epilogue stores neither;
//   * the tile list is worked out in each block from the offsets (a prefix
//     count of each expert's row tiles in shared memory, a binary search a
//     tile), so the launch needs only an upper bound of tiles, ceil(R / 128)
//     + E row tiles, and the host never waits;
//   * persistent: min(upper bound, SMs) blocks of 384 threads walk the tiles
//     (blockIdx.x, then every gridDim.x-th; the column tiles of a row tile
//     are neighbours, so a wave shares its experts' weights in L2). Thread 0
//     is the producer: it keeps a ring of 5 stages of (128 x 64) x and
//     (192 x 64) w tiles full with TMA loads on full/empty mbarriers, across
//     tiles; two consumer warpgroups run 4 wgmma per 64-deep step on 64 rows
//     each, one group in flight while the next stage is awaited, and store
//     their fragments straight from registers (16-byte runs of a row). The
//     tile is L2-bound at 128 x 128 (64 operations a byte of a k step's
//     tiles: 317 TFLOP/s at the prefill's up projection on an H100); 192
//     columns read 78;
//   * the expert weights a launch reads: the block that starts an expert's
//     first tile adds one to a device counter (the roofline's bytes).
//   * SwiGLU: a tile's 192 columns are 12 whole blocks of 16 (its n0 a
//     multiple of 16), so a thread's n-tiles 2i and 2i+1 hold the gate's and
//     the up's values of the same two output columns: the epilogue takes
//     SiLU(g) * u on the fp32 accumulators and stores 96 columns.
// K must be a multiple of 64, N of 8 (SwiGLU: of 16); E at most 256.

#include "gemm_sm90.cuh"

namespace {

using namespace gemm90;

constexpr int kTileM = 128;
constexpr int kTileN = 192;          // wgmma m64n192k16: 78 operations a byte of a k step's tiles
constexpr int kThreadsK7 = 384;      // the producer's warpgroup, two consumer warpgroups
constexpr int kMaxExperts = 256;
constexpr int kABytesK7 = kTileM * kBK * 2;
constexpr int kStageBytesK7 = kABytesK7 + kTileN * kBK * 2;
constexpr int kRing = 5;             // 5 x 40 KB stages
constexpr int kOffBarK7 = kRing * kStageBytesK7;
constexpr int kSmemK7 = kOffBarK7 + 16 * kRing + 1024;  // + alignment slack

struct Args {
  const int* offsets;
  __nv_bfloat16* out;
  unsigned long long* experts_read;
  int R, N, K, E, epi;
};

enum Epilogue { kEpiStore = 0, kEpiRelu2 = 1, kEpiSwiglu = 2 };

struct TileK7 {
  int e, m0, m_end, n0, first;  // first: the expert's first tile
};

__device__ __forceinline__ TileK7 tile_at(int t, int n_tiles, const int* tile_start,
                                          const int* row_start, int E) {
  const int mt = t / n_tiles;
  int lo = 0, hi = E;  // the e with tile_start[e] <= mt < tile_start[e + 1]
  while (hi - lo > 1) {
    const int mid = (lo + hi) / 2;
    if (tile_start[mid] <= mt) lo = mid; else hi = mid;
  }
  while (tile_start[lo + 1] <= mt) ++lo;  // experts without rows share a start
  TileK7 tl;
  tl.e = lo;
  tl.m0 = row_start[lo] + (mt - tile_start[lo]) * kTileM;
  tl.m_end = row_start[lo + 1];
  tl.n0 = (t % n_tiles) * kTileN;
  tl.first = mt == tile_start[lo] && tl.n0 == 0;
  return tl;
}

__global__ void __launch_bounds__(kThreadsK7, 1)
    grouped_gemm_bf16(const __grid_constant__ CUtensorMap tm_x,
                      const __grid_constant__ CUtensorMap tm_w, const Args a) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ int tile_start[kMaxExperts + 1];
  __shared__ int row_start[kMaxExperts + 1];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // 128-byte swizzle atoms are 1 KB
  auto full = [&](int s) { return base + kOffBarK7 + 8 * s; };
  auto empty = [&](int s) { return base + kOffBarK7 + 8 * (kRing + s); };

  if (threadIdx.x == 0) {
    int acc = 0;
    for (int e = 0; e < a.E; ++e) {
      const int r0 = a.offsets[e];
      row_start[e] = r0;
      tile_start[e] = acc;
      acc += (a.offsets[e + 1] - r0 + kTileM - 1) / kTileM;
    }
    row_start[a.E] = a.offsets[a.E];
    tile_start[a.E] = acc;
    for (int s = 0; s < kRing; ++s) {
      bar_init(full(s), 1);
      bar_init(empty(s), 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int n_tiles = (a.N + kTileN - 1) / kTileN;
  const int tiles = tile_start[a.E] * n_tiles;
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x / 128), 0);

  if (wg == 0) {
    if (threadIdx.x != 0) return;
    // ---- producer: one thread keeps the ring full, across tiles ----
    const int nk = a.K / kBK;
    int it = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const TileK7 tl = tile_at(t, n_tiles, tile_start, row_start, a.E);
      if (tl.first && a.experts_read != nullptr) atomicAdd(a.experts_read, 1ull);
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % kRing;
        bar_wait(empty(s), ((it / kRing) & 1) ^ 1);
        bar_expect_tx(full(s), kStageBytesK7);
        const uint32_t x_dst = base + s * kStageBytesK7;
        tma_load_2d(x_dst, &tm_x, full(s), kt * kBK, tl.m0);
        tma_load_2d(x_dst + kABytesK7, &tm_w, full(s), kt * kBK, tl.e * a.N + tl.n0);
      }
    }
    return;
  }

  // ---- consumers: 64 rows each ----
  const int cw = wg - 1;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;   // accumulator row group
  const int t4 = lane % 4;  // thread within the quad
  const int nk = a.K / kBK;
  int it = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const TileK7 tl = tile_at(t, n_tiles, tile_start, row_start, a.E);
    // n-tile j = i / 4 of acc holds columns 8j + 2*t4 + (i & 1), rows
    // 16*warp + g + 8*((i / 2) & 1) of this warpgroup's 64
    float acc[kTileN / 2];
    for (int kt = 0; kt < nk; ++kt, ++it) {
      const int s = it % kRing;
      bar_wait(full(s), (it / kRing) & 1);
      const uint32_t xa = base + s * kStageBytesK7 + cw * kBoxBytes;
      const uint32_t wb = base + s * kStageBytesK7 + kABytesK7;
      const uint64_t da = smem_desc(xa, 16, 1024);
      const uint64_t db = smem_desc(wb, 16, 1024);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        Wgmma<kTileN, false, false>::mma(acc, da + 2 * kk, db + 2 * kk, kt > 0 || kk > 0);
      }
      wgmma_commit();
      if (kt > 0) {  // the previous step's products are done: free its stage
        wgmma_wait<1>();
        fence_regs(acc);
        __syncwarp();
        if (lane == 0) bar_arrive(empty((it - 1) % kRing));
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) bar_arrive(empty((it - 1) % kRing));

    // epilogue: this expert's rows and the real columns, straight from registers
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int m = tl.m0 + cw * 64 + warp * 16 + g + 8 * r;
      if (m >= tl.m_end) continue;
      if (a.epi == kEpiSwiglu) {
        __nv_bfloat16* half = a.out + static_cast<long long>(m) * (a.N / 2);
#pragma unroll
        for (int j = 0; j < kTileN / 8; j += 2) {
          const int n = tl.n0 + 8 * j;  // the gate's block; the up's is the next 8 columns
          if (n >= a.N) continue;
          const float g0 = acc[4 * j + 2 * r], g1 = acc[4 * j + 2 * r + 1];
          const float u0 = acc[4 * (j + 1) + 2 * r], u1 = acc[4 * (j + 1) + 2 * r + 1];
          const float v0 = g0 / (1.f + __expf(-g0)) * u0;
          const float v1 = g1 / (1.f + __expf(-g1)) * u1;
          *reinterpret_cast<uint32_t*>(half + n / 2 + 2 * t4) = pack_bf16x2(v0, v1);
        }
        continue;
      }
      __nv_bfloat16* row = a.out + static_cast<long long>(m) * a.N;
#pragma unroll
      for (int j = 0; j < kTileN / 8; ++j) {
        const int n = tl.n0 + 8 * j + 2 * t4;
        if (n >= a.N) continue;
        float v0 = acc[4 * j + 2 * r], v1 = acc[4 * j + 2 * r + 1];
        if (a.epi == kEpiRelu2) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
          v0 *= v0;
          v1 *= v1;
        }
        *reinterpret_cast<uint32_t*>(row + n) = pack_bf16x2(v0, v1);
      }
    }
  }
}

}  // namespace

// x (R, K), w (E, N, K), out (R, N) ((R, N / 2) for SwiGLU): bf16,
// contiguous, 16-byte aligned; offsets (E + 1,) int32 on the same device;
// experts_read a device counter (unsigned 64-bit) or null; epi 0 store, 1
// relu^2, 2 SwiGLU. Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int vidil_grouped_expert_gemm(const void* x, const void* w, const void* offsets,
                                         void* out, void* experts_read, int device, int R, int N,
                                         int K, int E, int epi, void* stream) {
  if (R <= 0 || N <= 0 || K <= 0 || K % kBK || N % 8 || E < 1 || E > kMaxExperts ||
      epi < kEpiStore || epi > kEpiSwiglu || (epi == kEpiSwiglu && N % 16))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(grouped_gemm_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemK7);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap tx, tw;
  if (!make_map_2d(&tx, x, K, R, K, kTileM) ||
      !make_map_2d(&tw, w, K, static_cast<long long>(E) * N, K, kTileN)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int sms = 0;
  err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long bound =
      (static_cast<long long>(R + kTileM - 1) / kTileM + E) * ((N + kTileN - 1) / kTileN);
  const int blocks = static_cast<int>(std::min<long long>(bound, sms));
  const Args args{static_cast<const int*>(offsets), static_cast<__nv_bfloat16*>(out),
                  static_cast<unsigned long long*>(experts_read), R, N, K, E, epi};
  grouped_gemm_bf16<<<blocks, kThreadsK7, kSmemK7, static_cast<cudaStream_t>(stream)>>>(tx, tw,
                                                                                         args);
  return static_cast<int>(cudaGetLastError());
}
