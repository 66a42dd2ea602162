// Fused pre-LN ViT block, backward, for Hopper (sm_90a): dx and the 12
// parameter gradients of one block from its input x and the output gradient g.
//
// Replaces the TPU kernel vidil_tpu/ops/fused_vit_block.py:_fused_block_backward
// (body _block_bwd_kernel). It first recomputes the forward from x with the
// forward's own pieces (fused_vit_block.cuh), keeping this layer's
// intermediates in a workspace that is freed after the call, so only x is
// saved per layer (the memory profile of full rematerialisation). Then it
// follows _block_bwd_kernel step by step, with its rounding points:
//   db2 = colsum(g);  dw2 = a^T . g;  da = g . w2^T (fp32)
//   dhh32 = da * gelu'(hh);  db1 = colsum(dhh32), unrounded
//   dw1 = h2^T . round(dhh);  dh2 = round(dhh) . w1^T (fp32)
//   dln2s = colsum(dh2 * xhat2);  dln2b = colsum(dh2)
//   dy = g + LN2 backward (fp32);  dbproj = colsum(dy)
//   dwproj = attn^T . round(dy);  do = round(round(dy) . wproj^T)
//   attention, per (frame, head), with p32 recomputed from the saved row max
//   and sum: dv = round(p32)^T . do; dp = do . v^T (fp32);
//   D = sum_k dp * p32 (not rowsum(g * o)); ds = p32 * (dp - D);
//   dsb = round(ds * scale); dq = dsb . k and dk = dsb^T . q with q unscaled;
//   dq, dk, dv accumulate in fp32 and are rounded once into dqkv
//   dbqkv = colsum of the fp32 dq, dk, dv, unrounded;  dwqkv = h1^T . dqkv
//   dh1 = dqkv . wqkv^T;  dln1s, dln1b as for LN2
//   dx = round(dy + LN1 backward)
// The gradients are fp32, summed over every row; the wrapper casts the
// linears' ones to their (bf16) dtype, as the TPU package does.
//
// Design. The TPU kernel accumulates the weight gradients in VMEM across its
// sequential grid. Hopper blocks run in parallel and in no order, so every
// sum over rows here is a fixed-order reduction and results are identical
// run to run (no atomics): the weight-gradient GEMMs (A^T . B over all B*Lp
// rows) split the rows into a fixed number of slices and add the slices'
// fp32 partials in order; the column sums add fixed row chunks, then the
// chunks in order. The bf16 attention backward is two persistent kernels
// on the machinery of flash_attention_bwd.cu (K2): a producer warpgroup
// whose one thread issues TMA loads on 4-D tensor maps of the QKV
// workspace and of do (setmaxnreg gives its registers away), a ring of
// stages on full/empty mbarriers, two consumer warpgroups taking ping-pong
// turns on named barriers; s and dp (or their transposes) are SS wgmma, and
// dsb.k, round(p32)^T.do and dsb^T.q RS wgmma whose A operand is packed
// straight from the fp32 accumulator fragment.
//   * dq pass: items of (frame*head, 128 query rows). D needs the whole row
//     of dp * p32 before any ds, and the row's fp32 p32 and dp do not fit
//     (64 rows x up to 640 keys x 8 bytes a consumer: 327 KB), so the item
//     walks its 128-key tiles twice: walk 1 for D, walk 2 for ds and dq
//     (9 products in all with the dk/dv pass, against 7 for K2, whose D
//     comes from rowsum(g * o)). It writes each row's raw max, sum, 1/sum
//     and D into a stats scratch, 64 rows a 1 KB tile.
//   * dk/dv pass: items of (frame*head, 128 keys), walking 64-row query
//     tiles with their stats tiles (one bulk copy each).
//   * p32 is formed as the recompute's forward forms it, 2^((S - M) c) by
//     the SFU and the IEEE quotient by the row sum (sm90.cuh:div_rn), so it
//     matches the forward's p for the same scores; the scale 0.125 (head
//     dim 64) is a power of two, applied to fp32 values exactly.
//   * key tiles and key items wholly past true_len are not walked (their
//     terms are exact zeros); the ragged tile is masked in registers.
//   * dbqkv: each consumer's epilogue writes the fp32 column sums of its 64
//     rows of dq (or dk and dv) into a fixed slot of a (B*Lp / 64, 3D)
//     buffer, and one launch adds the slots in order, so no fp32 copy of
//     dqkv is kept (the workspace's largest term before).
// The fp32 passes (not a main-path dtype) are one thread per row or key,
// plain FMAs, and their dbqkv a column sum of dqkv.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): at the 224-px
// trainer shape (48 frames, 256 padded tokens, 768 wide) the TPU cost model
// counts three times the forward's operations, 550 GFLOP (~0.56 ms); the
// recompute and the device-memory intermediates make this kernel do and
// move more than that. Its 11 products (3 of the recompute, 4 data and 4
// weight gradients: 464 GFLOP, 0.47 ms at peak) run on the wgmma + TMA
// GEMM of gemm_sm90.cuh; the weight gradients' split-K comes from its tile
// plan (3-4 partials for dwproj, dw1 and dw2 at 12,288 rows, none for
// dwqkv). The attention backward alone reads qkv and do and writes dqkv
// (~132 MB, 0.040 ms) against its 5 needed products (0.019 ms at peak).
// Device time per call (chip_smoke.py phase 8, torch.profiler; H100 80GB
// HBM3, 700 W): at the trainer block 1.63 ms, the library block's autograd
// 1.60: GEMMs 0.99 (11 launches, 467 TFLOP/s), attention 0.24 (3: the
// recompute's forward 0.045, the dq pass 0.098, the dk/dv pass 0.097; the
// two passes were 0.89 on mma.sync), column sums 0.18 (11), LayerNorm rows
// 0.16 (4), split sums 0.06 (3); at (32, 640, 768) 3.03 against 2.83:
// attention 0.84 (the passes 0.29 + 0.31; 3.47 on mma.sync). The passes
// alone: 0.206 ms against SDPA backward's 0.179 at the trainer block,
// 0.621 against 0.477 at 640. What is left: the dk/dv pass's m64n64
// products (its 64-row query tiles), the dq pass's second walk, and the
// other column sums and the LayerNorm rows folded into the GEMMs'
// epilogues.

#include "fused_vit_block.cuh"

using namespace vit_block;

namespace {

// ---------------------------------------------------------------------------
// column sums over rows, fixed order
// ---------------------------------------------------------------------------

constexpr int kColChunk = 256;  // rows per partial sum

// part[c][j] = sum over the rows of chunk c of src[row][j] (and, with kXhat,
// part[chunks + c][j] = sum of src * xhat with xhat = (x - mean) * rstd: the
// LayerNorm scale's gradient, the first of the two being the bias's).
// Block (32 columns) x (8 row lanes); grid (N / 32, chunks).
template <typename S, typename X, bool kXhat>
__global__ void __launch_bounds__(256) colsum_partial(const S* src, int M, int N, const X* x,
                                                      const float* mean, const float* rstd,
                                                      float* part) {
  __shared__ float s0[8][33];
  __shared__ float s1[8][33];
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  const int j = blockIdx.x * 32 + tx;
  const int c = blockIdx.y;
  const int r_end = min(M, (c + 1) * kColChunk);
  float a0 = 0.f, a1 = 0.f;
  for (int r = c * kColChunk + ty; r < r_end; r += 8) {
    const long long i = static_cast<long long>(r) * N + j;
    const float v = to_f(src[i]);
    a0 += v;
    if (kXhat) a1 += v * ((to_f(x[i]) - mean[r]) * rstd[r]);
  }
  s0[ty][tx] = a0;
  s1[ty][tx] = a1;
  __syncthreads();
  if (ty == 0) {
    float t0 = 0.f, t1 = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      t0 += s0[i][tx];
      t1 += s1[i][tx];
    }
    part[static_cast<long long>(c) * N + j] = t0;
    if (kXhat) part[static_cast<long long>(gridDim.y + c) * N + j] = t1;
  }
}

__global__ void colsum_final(const float* part, int chunks, int N, float* out0, float* out1) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= N) return;
  float t = 0.f;
  for (int c = 0; c < chunks; ++c) t += part[static_cast<long long>(c) * N + j];
  out0[j] = t;
  if (out1 != nullptr) {
    t = 0.f;
    for (int c = 0; c < chunks; ++c) t += part[static_cast<long long>(chunks + c) * N + j];
    out1[j] = t;
  }
}

int col_chunks(int M) { return (M + kColChunk - 1) / kColChunk; }

// out0 = colsum(src); with x: out1 = colsum(src * xhat) (LayerNorm grads:
// out0 the bias's, out1 the scale's)
template <typename S, typename X, bool kXhat>
cudaError_t colsum(const S* src, int M, int N, const X* x, const float* mean, const float* rstd,
                   float* part, float* out0, float* out1, cudaStream_t s) {
  const int chunks = col_chunks(M);
  colsum_partial<S, X, kXhat><<<dim3(N / 32, chunks), 256, 0, s>>>(src, M, N, x, mean, rstd, part);
  VB_LAUNCHED();
  colsum_final<<<(N + 255) / 256, 256, 0, s>>>(part, chunks, N, out0, out1);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// weight gradients: dst (I, J) = A^T . B over all rows, split-K in fixed order
// ---------------------------------------------------------------------------

__global__ void sum_splits(const float* part, int splits, long long n, float* out) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float v = 0.f;
    for (int sp = 0; sp < splits; ++sp) v += part[sp * n + i];
    out[i] = v;
  }
}

// dst (I, J) = A^T . B over all rows: both operands MN-major; with more than
// one split, the splits' fp32 partials are added in order by sum_splits
template <typename T>
cudaError_t weight_grad(const T* a, int I, const T* b, int J, int rows, float* part, float* dst,
                        cudaStream_t s) {
  const SplitK sk = gemm_split<T>(I, J, rows, true);
  GemmArgs p{a, I, b, J, nullptr, nullptr, nullptr, sk.count > 1 ? part : dst, J, I, J, rows, rows};
  VB_CHECK((gemm<T, true, true, kEpiF32>(p, true, s)));  // the same split
  if (sk.count == 1) return cudaSuccess;
  sum_splits<<<264, 256, 0, s>>>(part, sk.count, static_cast<long long>(I) * J, dst);
  return cudaGetLastError();
}

template <typename T>
long long weight_grad_partials(int I, int J, int rows) {
  const SplitK sk = gemm_split<T>(I, J, rows, true);
  return sk.count > 1 ? static_cast<long long>(sk.count) * I * J : 0;
}

// ---------------------------------------------------------------------------
// LayerNorm backward over rows
// ---------------------------------------------------------------------------

// v = res + r * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat)),
// dxhat = dh * s, xhat = (x - mean) * r; out = round(v), out32 = v if given.
// One warp per row.
template <typename T, typename R>
__global__ void __launch_bounds__(256) ln_bwd_rows(const float* dh, const T* x, const float* mean,
                                                   const float* rstd, const float* s, const R* res,
                                                   float* out32, T* out, int M, int D) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const long long base = static_cast<long long>(row) * D;
  const float mu = mean[row], r = rstd[row];
  float s1 = 0.f, s2 = 0.f;
  for (int j = lane; j < D; j += 32) {
    const float xh = (to_f(x[base + j]) - mu) * r;
    const float dxh = dh[base + j] * s[j];
    s1 += dxh;
    s2 += dxh * xh;
  }
  s1 = warp_sum(s1) / D;
  s2 = warp_sum(s2) / D;
  for (int j = lane; j < D; j += 32) {
    const float xh = (to_f(x[base + j]) - mu) * r;
    const float dxh = dh[base + j] * s[j];
    const float v = to_f(res[base + j]) + r * (dxh - s1 - xh * s2);
    if (out32 != nullptr) out32[base + j] = v;
    out[base + j] = from_f<T>(v);
  }
}

// ---------------------------------------------------------------------------
// attention backward
// ---------------------------------------------------------------------------

struct AttnBwdArgs {
  const void* qkv;       // (B, Lp, 3D)
  const void* dout;      // do: (B, Lp, D), rounded
  const float* row_max;  // (B*H, Lp) from the forward recompute: max(s), s = q k^T * scale
  const float* row_sum;  // (B*H, Lp): sum of exp(s - max)
  float* stats;          // (B*H, Lp / 64, 4, 64), written by the dq pass (stat_at)
  void* dqkv;            // (B, Lp, 3D): dq, dk, dv rounded to T
  float* part;           // bf16: (B*Lp / 64, 3D) column sums of 64-row slots; fp32: chunk partials
  float* dbqkv;          // (3D,) fp32: the column sums of unrounded dq, dk, dv
  int B, H, Lp, D, true_len;
  float scale;
};

// The dq pass's per-row statistics for the dk/dv pass, in tiles of 64 rows
// (one 1 KB bulk copy a tile): the raw row max M (row_max / scale, exact:
// the scale is 2^-3), the row sum l, its reciprocal, and D.
constexpr int kStatRows = 64;
enum { kStatMax = 0, kStatSum = 1, kStatInv = 2, kStatDelta = 3 };

__device__ __forceinline__ long long stat_at(const AttnBwdArgs& p, int bh, int row, int e) {
  return ((static_cast<long long>(bh) * (p.Lp / kStatRows) + row / kStatRows) * 4 + e) *
             kStatRows + row % kStatRows;
}

__device__ __forceinline__ float prob(float s, float scale, bool masked, float m, float l) {
  return masked ? 0.f : expf(s * scale - m) / l;
}

// bf16: persistent wgmma + TMA kernels on the machinery of
// flash_attention_bwd.cu (K2), with K5's rounding points.
namespace attn90 {

using namespace sm90;

constexpr int kRows = 128;     // an item's rows: query rows (dq pass) or keys (dk/dv pass)
constexpr int kDqWalk = 128;   // the dq pass's walked tiles: 128 keys
constexpr int kDkWalk = 64;    // the dk/dv pass's walked tiles: 64 query rows
constexpr int kStages = 4;     // ring depth of walked tiles
constexpr int kThreads = 384;  // producer warpgroup + two consumer warpgroups
constexpr int kBoxRows = 64;   // rows of one TMA box (8 KB of bf16 over 64 head dims)
constexpr int kBoxBytes = kBoxRows * kDh * 2;
constexpr int kResBytes = kRows * kDh * 2;              // one 128-row item operand, 16 KB
constexpr int kStatBytes = 4 * kStatRows * 4;           // a stats tile, 1 KB
constexpr int kSumBytes = 4 * kDh * 4;                  // 4 warps' column sums of 64 columns
constexpr int kBarTurn = 1;    // named barriers 1, 2: each consumer's wgmma turn
constexpr int kBarSum = 3;     // named barriers 3, 4: each consumer's column sums
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of a block whose walked tiles have kWalk rows, at fixed
// offsets from a 1 KB-aligned base (128-byte swizzle atoms are 1 KB): two
// item buffers of two 128-row operands, the ring of walked tiles (two
// operands and a stats tile a stage), each consumer's two column-sum
// buffers, the mbarriers.
template <int kWalk>
struct Smem {
  static constexpr int kWalkBytes = kWalk * kDh * 2;
  static constexpr int kOffStage = 2 * 2 * kResBytes;
  static constexpr int kOffStat = kOffStage + kStages * 2 * kWalkBytes;
  static constexpr int kOffSum = kOffStat + kStages * kStatBytes;
  static constexpr int kOffBar = kOffSum + 2 * 2 * kSumBytes;
  static constexpr int kBytes = kOffBar + 8 * (4 + 2 * kStages) + 1024;  // + alignment slack
  uint32_t base;
  uint8_t* ptr;
  // item buffer r (0, 1), operand i (0, 1): 128 rows
  __device__ uint32_t res(int r, int i) const { return base + (2 * r + i) * kResBytes; }
  // stage s, operand i: kWalk rows
  __device__ uint32_t tile(int s, int i) const {
    return base + kOffStage + (2 * s + i) * kWalkBytes;
  }
  __device__ uint32_t stat(int s) const { return base + kOffStat + s * kStatBytes; }
  __device__ const float* stat_ptr(int s) const {
    return reinterpret_cast<const float*>(ptr + kOffStat + s * kStatBytes);
  }
  // consumer cw's column-sum buffer i: [warp][64]
  __device__ float* sums(int cw, int i) const {
    return reinterpret_cast<float*>(ptr + kOffSum + (2 * cw + i) * kSumBytes);
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
};

// p = exp(s * scale - m) / l in place over one 128-key tile of raw scores
// s = q k^T (m64n128 fragment: value i is key key0 + 8 (i / 4) + (i & 1),
// row g + 8 ((i / 2) & 1)), as the recompute's forward forms it:
// 2^((S - M) c), c = scale log2(e), and the IEEE quotient by l
// (sm90.cuh:div_rn); 0 at keys at or past `valid` (kMask)
template <bool kMask>
__device__ __forceinline__ void probs(float (&s)[64], int key0, int valid, const float (&m)[2],
                                      const float (&l)[2], const float (&inv)[2], float c) {
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int rr = (i / 2) & 1;
    const bool keep = !kMask || key0 + 8 * (i / 4) + (i & 1) < valid;
    s[i] = keep ? div_rn(ex2((s[i] - m[rr]) * c), l[rr], inv[rr]) : 0.f;
  }
}

// The column sums over a consumer warpgroup's 64 rows of an m64n64 fp32
// accumulator (value i: column 8 (i / 4) + 2 t4 + (i & 1), row g + 8
// ((i / 2) & 1) of each warp's 16) into dst[0..63], in a fixed order: the
// thread's two rows, the warp's 8 row groups (shuffles), then its 4 warps
// in order through `sums` (no atomics: identical run to run).
__device__ __forceinline__ void column_sums(const float (&acc)[32], float* sums, int cw,
                                            float* dst) {
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  float c[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) c[i] = acc[4 * (i / 2) + (i & 1)] + acc[4 * (i / 2) + 2 + (i & 1)];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
#pragma unroll
    for (int off = 4; off < 32; off *= 2) c[i] += __shfl_xor_sync(0xffffffffu, c[i], off);
  }
  if (lane < 4) {
#pragma unroll
    for (int i = 0; i < 16; ++i) sums[warp * kDh + 8 * (i / 2) + 2 * lane + (i & 1)] = c[i];
  }
  named_sync(kBarSum + cw, 128);
  if (tid < kDh) dst[tid] = ((sums[tid] + sums[kDh + tid]) + sums[2 * kDh + tid]) + sums[3 * kDh + tid];
}

// This thread's two rows of an m64n64 accumulator (rows g, g + 8 of its
// warp's 16), rounded, into the (row, 64) bf16 block at `out` (stride ld)
__device__ __forceinline__ void store_rows(const float (&acc)[32], bf16* out, long long ld,
                                           int t4) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int jn = 0; jn < kDh / 8; ++jn) {
      *reinterpret_cast<uint32_t*>(out + 8 * i * ld + 8 * jn + 2 * t4) =
          pack_bf16x2(acc[4 * jn + 2 * i], acc[4 * jn + 2 * i + 1]);
    }
  }
}

// dq pass: items of (frame*head, 128 query rows). D needs the whole row of
// dp * p before any ds, and a row's fp32 p and dp over up to 640 keys do not
// fit in registers or shared memory (64 rows x 640 keys x 8 bytes a
// consumer), so the item walks its key tiles twice: walk 1 forms s = q k^T
// and dp = do v^T and sums D = sum_k dp * p; walk 2 forms them again, then
// dsb = round(p (dp - D) scale) and dq += dsb k. Key tiles wholly past
// true_len are not walked (their terms are exact zeros).
__global__ void __launch_bounds__(kThreads, 1) attn_bwd_dq_wgmma(
    const __grid_constant__ CUtensorMap tm_qkv, const __grid_constant__ CUtensorMap tm_do,
    const AttnBwdArgs p) {
  using Sm = Smem<kDqWalk>;
  const Sm sm = Sm::init();
  const int q_items = p.Lp / kRows;
  const int items = p.B * p.H * q_items;
  const int nk = (p.true_len + kDqWalk - 1) / kDqWalk;  // key tiles holding an unmasked key
  const int turns = 2 * nk;
  // broadcast, so that the compiler sees a warp-uniform value
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x / 128), 0);
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      int it = 0;  // walked tiles loaded so far: the ring's stage and phase
      for (int w = blockIdx.x, n = 0; w < items; w += gridDim.x, ++n) {
        const int bh = w / q_items;
        const int b = bh / p.H;
        const int h = bh % p.H;
        const int r = n & 1;
        if (n >= 2) bar_wait(sm.res_empty(r), ((n >> 1) - 1) & 1);  // item n - 2 is done with it
        bar_expect_tx(sm.res_full(r), 2 * kResBytes);
        for (int box = 0; box < kRows / kBoxRows; ++box) {
          const int row = (w % q_items) * kRows + box * kBoxRows;
          tma_load(sm.res(r, 0) + box * kBoxBytes, &tm_qkv, sm.res_full(r), row, h, b);  // q
          tma_load(sm.res(r, 1) + box * kBoxBytes, &tm_do, sm.res_full(r), row, h, b);   // do
        }
        for (int t = 0; t < turns; ++t, ++it) {
          const int s = it % kStages;
          const int key = (t % nk) * kDqWalk;
          bar_wait(sm.empty(s), ((it / kStages) & 1) ^ 1);
          bar_expect_tx(sm.full(s), 2 * Sm::kWalkBytes);
          for (int box = 0; box < kDqWalk / kBoxRows; ++box) {
            tma_load(sm.tile(s, 0) + box * kBoxBytes, &tm_qkv, sm.full(s), key + box * kBoxRows,
                     p.H + h, b);  // k
            tma_load(sm.tile(s, 1) + box * kBoxBytes, &tm_qkv, sm.full(s), key + box * kBoxRows,
                     2 * p.H + h, b);  // v
          }
        }
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
  const long long ld = 3LL * p.D;
  if (cw == 1) named_arrive(kBarTurn, 256);  // consumer 0 takes the first turn
  int it = 0;
  for (int w = blockIdx.x, n = 0; w < items; w += gridDim.x, ++n, it += turns) {
    const bool last_item = w + static_cast<int>(gridDim.x) >= items;
    const int bh = w / q_items;
    const int b = bh / p.H;
    const int h = bh % p.H;
    const int r = n & 1;
    const int row0 = (w % q_items) * kRows + cw * 64;  // this consumer's 64 rows
    int rows[2];
    float mx[2], l[2], inv[2], dsum[2] = {0.f, 0.f}, delta[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rows[i] = row0 + warp * 16 + g + 8 * i;
      const long long at = static_cast<long long>(bh) * p.Lp + rows[i];
      mx[i] = p.row_max[at] / p.scale;
      l[i] = p.row_sum[at];
      inv[i] = __frcp_rn(l[i]);
    }
    bar_wait(sm.res_full(r), (n >> 1) & 1);
    const uint64_t desc_q = smem_desc(sm.res(r, 0) + cw * kBoxBytes, 16, 1024);
    const uint64_t desc_do = smem_desc(sm.res(r, 1) + cw * kBoxBytes, 16, 1024);
    float acc[32];     // dq: n-tile j = i / 4 holds head dims 8j + 2 t4 + (i & 1), rows g, g + 8
    uint32_t dsa[32];  // the last tile's dsb as the A operand of dsb k
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      acc[i] = 0.f;
      dsa[i] = 0u;
    }
    // Turn j issues tile j's s and dp (j < turns; tiles nk.. are walk 2's)
    // and, in walk 2, tile j-1's dq += dsb k as one wgmma group; the
    // consumers take turns (named barriers), so that one's exponentials
    // overlap the other's products
    for (int j = 0; j <= turns; ++j) {
      const bool ss = j < turns;
      const bool rs = j > nk;
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
        for (int kc = 0; kc < kDh / 16; ++kc) {
          wgmma_m64n128_ss(sc, desc_q + 2 * kc, desc_k + 2 * kc, kc > 0);
        }
#pragma unroll
        for (int kc = 0; kc < kDh / 16; ++kc) {
          wgmma_m64n128_ss(dp, desc_do + 2 * kc, desc_v + 2 * kc, kc > 0);
        }
      }
      if (rs) {  // k read MN-major (its natural (key, D) layout)
        const uint64_t desc_k = smem_desc(sm.tile(s_prev, 0), 16, 1024);
#pragma unroll
        for (int kk = 0; kk < kDqWalk / 16; ++kk) {
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
      if (j == turns - 1) warp_arrive(sm.res_empty(r));  // the last q and do read
      if (!ss) continue;
      fence_regs(sc);
      fence_regs(dp);
      const bool walk2 = j >= nk;
      if (!walk2) warp_arrive(sm.empty(s_cur));  // walk 1 is done with the tile
      const int kt = walk2 ? j - nk : j;
      if ((kt + 1) * kDqWalk > p.true_len) {
        probs<true>(sc, kt * kDqWalk + 2 * t4, p.true_len, mx, l, inv, c);
      } else {
        probs<false>(sc, kt * kDqWalk + 2 * t4, p.true_len, mx, l, inv, c);
      }
      if (!walk2) {
#pragma unroll
        for (int i = 0; i < 64; ++i) dsum[(i / 2) & 1] += dp[i] * sc[i];
        if (j == nk - 1) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            delta[i] = quad_sum(dsum[i]);
            if (t4 == 0) {
              p.stats[stat_at(p, bh, rows[i], kStatMax)] = mx[i];
              p.stats[stat_at(p, bh, rows[i], kStatSum)] = l[i];
              p.stats[stat_at(p, bh, rows[i], kStatInv)] = inv[i];
              p.stats[stat_at(p, bh, rows[i], kStatDelta)] = delta[i];
            }
          }
        }
      } else {
        // dsb = round(p (dp - D) scale), packed in pairs as the A operand of
        // dsb k (pair i: n-tile i / 2, row g + 8 (i & 1))
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const float d = delta[i & 1];
          dsa[i] = pack_bf16x2(sc[2 * i] * (dp[2 * i] - d) * p.scale,
                               sc[2 * i + 1] * (dp[2 * i + 1] - d) * p.scale);
        }
      }
    }

    // dq rounded into its qkv columns; its fp32 column sums into the slot
    bf16* out = static_cast<bf16*>(p.dqkv) + (static_cast<long long>(b) * p.Lp + rows[0]) * ld +
                h * kDh;
    store_rows(acc, out, ld, t4);
    column_sums(acc, sm.sums(cw, 0), cw,
                p.part + (static_cast<long long>(b) * (p.Lp / kStatRows) + row0 / kStatRows) * ld +
                    h * kDh);
  }
}

// dk/dv pass: items of (frame*head, 128 keys), walking 64-row query tiles
// with their stats tiles: s^T = k q^T and dp^T = v do^T (SS m64n64),
// p^T, dsb^T = round(p^T (dp^T - D) scale), dv += round(p^T) do and
// dk += dsb^T q (RS m64n64). Items wholly past true_len are not walked:
// their dk and dv are zeros.
__global__ void __launch_bounds__(kThreads, 1) attn_bwd_dkdv_wgmma(
    const __grid_constant__ CUtensorMap tm_qkv, const __grid_constant__ CUtensorMap tm_do,
    const AttnBwdArgs p) {
  using Sm = Smem<kDkWalk>;
  const Sm sm = Sm::init();
  const int k_items = p.Lp / kRows;
  const int k_live = (p.true_len + kRows - 1) / kRows;  // key items holding an unmasked key
  const int items = p.B * p.H * k_live;
  const int q_tiles = p.Lp / kDkWalk;
  const long long ld = 3LL * p.D;
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x / 128), 0);
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      int it = 0;
      for (int w = blockIdx.x, n = 0; w < items; w += gridDim.x, ++n) {
        const int bh = w / k_live;
        const int b = bh / p.H;
        const int h = bh % p.H;
        const int r = n & 1;
        if (n >= 2) bar_wait(sm.res_empty(r), ((n >> 1) - 1) & 1);
        bar_expect_tx(sm.res_full(r), 2 * kResBytes);
        for (int box = 0; box < kRows / kBoxRows; ++box) {
          const int key = (w % k_live) * kRows + box * kBoxRows;
          tma_load(sm.res(r, 0) + box * kBoxBytes, &tm_qkv, sm.res_full(r), key, p.H + h, b);
          tma_load(sm.res(r, 1) + box * kBoxBytes, &tm_qkv, sm.res_full(r), key, 2 * p.H + h, b);
        }
        for (int j = 0; j < q_tiles; ++j, ++it) {
          const int s = it % kStages;
          bar_wait(sm.empty(s), ((it / kStages) & 1) ^ 1);
          bar_expect_tx(sm.full(s), 2 * Sm::kWalkBytes + kStatBytes);
          tma_load(sm.tile(s, 0), &tm_qkv, sm.full(s), j * kDkWalk, h, b);  // q
          tma_load(sm.tile(s, 1), &tm_do, sm.full(s), j * kDkWalk, h, b);   // do
          bulk_load(sm.stat(s), p.stats + stat_at(p, bh, j * kDkWalk, 0), kStatBytes, sm.full(s));
        }
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
  // key items wholly past true_len: zeros in dk, dv and their slots (before
  // the live items: after them, ptxas spilled the live loop's registers)
  const int dead = p.B * p.H * (k_items - k_live);
  const int t = threadIdx.x - 128;  // 0 .. 255 over both consumers
  for (int w = blockIdx.x; w < dead; w += gridDim.x) {
    const int bh = w / (k_items - k_live);
    const int b = bh / p.H;
    const int h = bh % p.H;
    const int key0 = (k_live + w % (k_items - k_live)) * kRows;
    for (int i = t; i < kRows * 2 * (kDh / 8); i += 256) {  // 16-byte stores
      const int key = key0 + i / (2 * (kDh / 8));
      const int col = (1 + (i / (kDh / 8)) % 2) * p.D + h * kDh + 8 * (i % (kDh / 8));
      *reinterpret_cast<uint4*>(static_cast<bf16*>(p.dqkv) +
                                (static_cast<long long>(b) * p.Lp + key) * ld + col) =
          make_uint4(0u, 0u, 0u, 0u);
    }
    const int slot = b * (p.Lp / kStatRows) + key0 / kStatRows + t / (2 * kDh);
    p.part[slot * ld + (1 + (t / kDh) % 2) * p.D + h * kDh + t % kDh] = 0.f;
  }
  if (cw == 1) named_arrive(kBarTurn, 256);  // consumer 0 takes the first turn
  int it = 0;
  for (int w = blockIdx.x, n = 0; w < items; w += gridDim.x, ++n, it += q_tiles) {
    const bool last_item = w + static_cast<int>(gridDim.x) >= items;
    const int bh = w / k_live;
    const int b = bh / p.H;
    const int h = bh % p.H;
    const int r = n & 1;
    const int key0 = (w % k_live) * kRows + cw * 64;  // this consumer's 64 keys
    bool masked[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) masked[i] = key0 + warp * 16 + g + 8 * i >= p.true_len;
    bar_wait(sm.res_full(r), (n >> 1) & 1);
    const uint64_t desc_k = smem_desc(sm.res(r, 0) + cw * kBoxBytes, 16, 1024);
    const uint64_t desc_v = smem_desc(sm.res(r, 1) + cw * kBoxBytes, 16, 1024);
    // dk, dv: n-tile j = i / 4 holds head dims 8j + 2 t4 + (i & 1), keys g, g + 8
    float dk[32], dv[32];
    uint32_t pa[16], dsa[16];  // the last tile's p^T and dsb^T as A operands
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) pa[i] = dsa[i] = 0u;
    // Turn j issues tile j's s^T and dp^T (j < q_tiles) and tile j-1's
    // dv += p^T do and dk += dsb^T q (j > 0) as one wgmma group, the
    // consumers taking turns as in the dq pass
    for (int j = 0; j <= q_tiles; ++j) {
      const bool ss = j < q_tiles;
      const bool rs = j > 0;
      const int s_cur = (it + j) % kStages;
      const int s_prev = (it + j - 1) % kStages;
      if (ss) bar_wait(sm.full(s_cur), ((it + j) / kStages) & 1);
      float st[32], dpt[32];  // rows: this warpgroup's keys; columns: the tile's query rows
      named_sync(kBarTurn + cw, 256);
      fence_regs(dk);
      fence_regs(dv);
      fence_regs(pa);
      fence_regs(dsa);
      wgmma_fence();
      if (ss) {
        const uint64_t desc_q = smem_desc(sm.tile(s_cur, 0), 16, 1024);
        const uint64_t desc_do = smem_desc(sm.tile(s_cur, 1), 16, 1024);
#pragma unroll
        for (int kc = 0; kc < kDh / 16; ++kc) {
          wgmma_m64n64_ss(st, desc_k + 2 * kc, desc_q + 2 * kc, kc > 0);
        }
#pragma unroll
        for (int kc = 0; kc < kDh / 16; ++kc) {
          wgmma_m64n64_ss(dpt, desc_v + 2 * kc, desc_do + 2 * kc, kc > 0);
        }
      }
      if (rs) {  // do and q read MN-major
        const uint64_t desc_q = smem_desc(sm.tile(s_prev, 0), 16, 1024);
        const uint64_t desc_do = smem_desc(sm.tile(s_prev, 1), 16, 1024);
#pragma unroll
        for (int kk = 0; kk < kDkWalk / 16; ++kk) {
          wgmma_m64n64_rs(dv, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3],
                          desc_do + 128 * kk);
        }
#pragma unroll
        for (int kk = 0; kk < kDkWalk / 16; ++kk) {
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
      // p^T = 2^((S^T - M) c) / l, 0 at masked keys; dsb^T = round(p^T
      // (dp^T - D) scale); pair i holds the tile's query rows 8 (i / 2) +
      // 2 t4 + {0, 1} of key g + 8 (i & 1)
      const float* tstat = sm.stat_ptr(s_cur);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int col = 8 * (i / 2) + 2 * t4;
        const float2 m2 = *reinterpret_cast<const float2*>(tstat + kStatMax * kStatRows + col);
        const float2 l2 = *reinterpret_cast<const float2*>(tstat + kStatSum * kStatRows + col);
        const float2 i2 = *reinterpret_cast<const float2*>(tstat + kStatInv * kStatRows + col);
        const float2 d2 = *reinterpret_cast<const float2*>(tstat + kStatDelta * kStatRows + col);
        const bool off = masked[i & 1];
        const float p0 = off ? 0.f : div_rn(ex2((st[2 * i] - m2.x) * c), l2.x, i2.x);
        const float p1 = off ? 0.f : div_rn(ex2((st[2 * i + 1] - m2.y) * c), l2.y, i2.y);
        pa[i] = pack_bf16x2(p0, p1);
        dsa[i] = pack_bf16x2(p0 * (dpt[2 * i] - d2.x) * p.scale,
                             p1 * (dpt[2 * i + 1] - d2.y) * p.scale);
      }
    }

    // dk and dv rounded into their qkv columns; their fp32 column sums into
    // the slot
    const long long row = static_cast<long long>(b) * p.Lp + key0 + warp * 16 + g;
    bf16* out = static_cast<bf16*>(p.dqkv) + row * ld + h * kDh;
    store_rows(dk, out + p.D, ld, t4);
    store_rows(dv, out + 2 * p.D, ld, t4);
    float* slot = p.part + (static_cast<long long>(b) * (p.Lp / kStatRows) + key0 / kStatRows) * ld +
                  h * kDh;
    column_sums(dk, sm.sums(cw, 0), cw, slot + p.D);
    column_sums(dv, sm.sums(cw, 1), cw, slot + 2 * p.D);
  }
}

cudaError_t attention_backward_bf16(const AttnBwdArgs& a, cudaStream_t s) {
  CUtensorMap tq, td;
  const long long ld = 3LL * a.D;
  // q, k and v of head h are heads h, H + h and 2H + h of the QKV workspace
  if (!make_map_4d(&tq, a.qkv, a.B, 3 * a.H, a.Lp, a.Lp * ld, kDh, ld, kBoxRows) ||
      !make_map_4d(&td, a.dout, a.B, a.H, a.Lp, static_cast<long long>(a.Lp) * a.D, kDh, a.D,
                   kBoxRows)) {
    return cudaErrorInvalidValue;
  }
  int sms = 0;
  VB_CHECK(sm_count(&sms));
  const int dq_items = a.B * a.H * (a.Lp / kRows);
  const int dk_items = a.B * a.H * ((a.true_len + kRows - 1) / kRows);
  constexpr int kDqSmem = Smem<kDqWalk>::kBytes;
  constexpr int kDkSmem = Smem<kDkWalk>::kBytes;
  VB_CHECK(cudaFuncSetAttribute(attn_bwd_dq_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                kDqSmem));
  VB_CHECK(cudaFuncSetAttribute(attn_bwd_dkdv_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                kDkSmem));
  attn_bwd_dq_wgmma<<<std::min(dq_items, sms), kThreads, kDqSmem, s>>>(tq, td, a);
  VB_LAUNCHED();
  attn_bwd_dkdv_wgmma<<<std::min(dk_items, sms), kThreads, kDkSmem, s>>>(tq, td, a);
  return cudaGetLastError();
}

}  // namespace attn90

// fp32 dq pass: one thread per query row, plain FMAs.
__global__ void __launch_bounds__(64) attn_bwd_dq_f32(const AttnBwdArgs p) {
  __shared__ __align__(16) float k_s[kAttnTile][kDh];
  __shared__ __align__(16) float v_s[kAttnTile][kDh];

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int row = blockIdx.y * kAttnTile + tid;
  const long long ld = 3LL * p.D;
  const float* q = static_cast<const float*>(p.qkv) + b * p.Lp * ld + h * kDh;
  const float* k = q + p.D;
  const float* v = q + 2 * p.D;
  const float* dout = static_cast<const float*>(p.dout) + b * p.Lp * static_cast<long long>(p.D) + h * kDh;

  float qr[kDh], dr[kDh];
#pragma unroll
  for (int d = 0; d < kDh; ++d) {
    qr[d] = q[row * ld + d];
    dr[d] = dout[static_cast<long long>(row) * p.D + d];
  }
  const float m = p.row_max[static_cast<long long>(bh) * p.Lp + row];
  const float l = p.row_sum[static_cast<long long>(bh) * p.Lp + row];

  float acc[kDh];
#pragma unroll
  for (int d = 0; d < kDh; ++d) acc[d] = 0.f;
  float delta = 0.f;
  for (int pass = 0; pass < 2; ++pass) {
    for (int n0 = 0; n0 < p.Lp; n0 += kAttnTile) {
      __syncthreads();
      for (int i = tid; i < kAttnTile * kDh / 4; i += blockDim.x) {
        const int r = i / (kDh / 4);
        const int c = (i % (kDh / 4)) * 4;
        *reinterpret_cast<float4*>(&k_s[r][c]) = *reinterpret_cast<const float4*>(k + (n0 + r) * ld + c);
        *reinterpret_cast<float4*>(&v_s[r][c]) = *reinterpret_cast<const float4*>(v + (n0 + r) * ld + c);
      }
      __syncthreads();
#pragma unroll 1
      for (int j = 0; j < kAttnTile; ++j) {
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int d = 0; d < kDh; ++d) {
          s = fmaf(qr[d], k_s[j][d], s);
          dp = fmaf(dr[d], v_s[j][d], dp);
        }
        const float pr = prob(s, p.scale, key_masked(n0 + j, p.true_len, p.Lp), m, l);
        if (pass == 0) {
          delta += dp * pr;
        } else {
          const float dsb = pr * (dp - delta) * p.scale;
#pragma unroll
          for (int d = 0; d < kDh; ++d) acc[d] = fmaf(dsb, k_s[j][d], acc[d]);
        }
      }
    }
  }
  p.stats[stat_at(p, bh, row, kStatDelta)] = delta;
  float* out = static_cast<float*>(p.dqkv) + (static_cast<long long>(b) * p.Lp + row) * ld + h * kDh;
#pragma unroll
  for (int d = 0; d < kDh; ++d) out[d] = acc[d];
}

// fp32 dk/dv pass: one thread per key, plain FMAs; the query rows are staged
// 16 at a time.
constexpr int kQRows32 = 16;

__global__ void __launch_bounds__(64) attn_bwd_dkdv_f32(const AttnBwdArgs p) {
  __shared__ float k_s[kAttnTile][kDh + 1];  // +1: each thread reads its own row
  __shared__ float v_s[kAttnTile][kDh + 1];
  __shared__ __align__(16) float q_s[kQRows32][kDh];
  __shared__ __align__(16) float do_s[kQRows32][kDh];
  __shared__ float m_s[kQRows32];
  __shared__ float l_s[kQRows32];
  __shared__ float delta_s[kQRows32];

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int key = blockIdx.y * kAttnTile + tid;
  const long long ld = 3LL * p.D;
  const float* q = static_cast<const float*>(p.qkv) + b * p.Lp * ld + h * kDh;
  const float* k = q + p.D;
  const float* v = q + 2 * p.D;
  const float* dout = static_cast<const float*>(p.dout) + b * p.Lp * static_cast<long long>(p.D) + h * kDh;
  const long long stat0 = static_cast<long long>(bh) * p.Lp;
  const bool masked = key_masked(key, p.true_len, p.Lp);

  float dk_acc[kDh], dv_acc[kDh];
#pragma unroll
  for (int d = 0; d < kDh; ++d) {
    k_s[tid][d] = k[key * ld + d];
    v_s[tid][d] = v[key * ld + d];
    dk_acc[d] = 0.f;
    dv_acc[d] = 0.f;
  }

  for (int m0 = 0; m0 < p.Lp; m0 += kQRows32) {
    __syncthreads();
    for (int i = tid; i < kQRows32 * kDh / 4; i += blockDim.x) {
      const int r = i / (kDh / 4);
      const int c = (i % (kDh / 4)) * 4;
      *reinterpret_cast<float4*>(&q_s[r][c]) = *reinterpret_cast<const float4*>(q + (m0 + r) * ld + c);
      *reinterpret_cast<float4*>(&do_s[r][c]) =
          *reinterpret_cast<const float4*>(dout + static_cast<long long>(m0 + r) * p.D + c);
    }
    if (tid < kQRows32) {
      m_s[tid] = p.row_max[stat0 + m0 + tid];
      l_s[tid] = p.row_sum[stat0 + m0 + tid];
      delta_s[tid] = p.stats[stat_at(p, bh, m0 + tid, kStatDelta)];
    }
    __syncthreads();
#pragma unroll 1
    for (int j = 0; j < kQRows32; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < kDh; ++d) {
        s = fmaf(q_s[j][d], k_s[tid][d], s);
        dp = fmaf(do_s[j][d], v_s[tid][d], dp);
      }
      const float pr = prob(s, p.scale, masked, m_s[j], l_s[j]);
      const float dsb = pr * (dp - delta_s[j]) * p.scale;
#pragma unroll
      for (int d = 0; d < kDh; ++d) {
        dv_acc[d] = fmaf(pr, do_s[j][d], dv_acc[d]);
        dk_acc[d] = fmaf(dsb, q_s[j][d], dk_acc[d]);
      }
    }
  }
  float* out = static_cast<float*>(p.dqkv) + (static_cast<long long>(b) * p.Lp + key) * ld + h * kDh;
#pragma unroll
  for (int d = 0; d < kDh; ++d) {
    out[p.D + d] = dk_acc[d];
    out[2 * p.D + d] = dv_acc[d];
  }
}

// dq, dk, dv (rounded, into dqkv), the stats scratch and dbqkv: bf16 by the
// two wgmma passes, whose epilogues leave the column sums of their fp32
// values by 64-row slot, then the slots added in order; fp32 by the
// plain-FMA passes and a column sum of dqkv (which is then unrounded)
template <typename T>
cudaError_t attention_backward(const AttnBwdArgs& a, cudaStream_t s) {
  const int N = 3 * a.D;
  if constexpr (std::is_same<T, bf16>::value) {
    VB_CHECK(attn90::attention_backward_bf16(a, s));
    colsum_final<<<(N + 255) / 256, 256, 0, s>>>(a.part, a.B * a.Lp / kStatRows, N, a.dbqkv,
                                                  nullptr);
    return cudaGetLastError();
  } else {
    const dim3 grid(a.B * a.H, a.Lp / kAttnTile);
    attn_bwd_dq_f32<<<grid, kAttnTile, 0, s>>>(a);
    VB_LAUNCHED();
    attn_bwd_dkdv_f32<<<grid, kAttnTile, 0, s>>>(a);
    VB_LAUNCHED();
    return colsum<float, float, false>(static_cast<const float*>(a.dqkv), a.B * a.Lp, N, nullptr,
                                       nullptr, nullptr, a.part, a.dbqkv, nullptr, s);
  }
}

// floats of the `part` buffer attention_backward needs: the bf16 passes'
// 64-row slots (enough for the fp32 column sum's chunk partials too)
long long attention_partials(const Dims& d) {
  return static_cast<long long>(d.M()) / kStatRows * 3 * d.D;
}

// ---------------------------------------------------------------------------
// the backward chain of one layer
// ---------------------------------------------------------------------------

struct Grads {
  float *dln1s, *dln1b, *dwqkv, *dbqkv, *dwproj, *dbproj, *dln2s, *dln2b, *dw1, *db1, *dw2, *db2;
};

template <typename T>
struct BwdBufs {
  FwdBufs<T> f;
  float *dhh32, *dh, *dy32, *stats, *wpart, *cpart;
  T *dhh, *dyb, *dout, *dqkvb;
};

template <typename T>
size_t bwd_workspace(const Dims& d, char* base, BwdBufs<T>* out) {
  Carve c{base, 0};
  const long long M = d.M();
  BwdBufs<T> w;
  w.f = carve_fwd<T>(c, d, true);
  w.dhh32 = c.take<float>(M * d.Dm);
  w.dhh = c.take<T>(M * d.Dm);
  w.dh = c.take<float>(M * d.D);
  w.dy32 = c.take<float>(M * d.D);
  w.dyb = c.take<T>(M * d.D);
  w.dout = c.take<T>(M * d.D);
  w.dqkvb = c.take<T>(M * 3 * d.D);
  w.stats = c.take<float>(4 * M * d.H);
  const long long wpart = std::max(
      std::max(weight_grad_partials<T>(d.Dm, d.D, d.M()), weight_grad_partials<T>(d.D, d.Dm, d.M())),
      std::max(weight_grad_partials<T>(d.D, d.D, d.M()), weight_grad_partials<T>(d.D, 3 * d.D, d.M())));
  w.wpart = c.take<float>(std::max(wpart, 1LL));
  w.cpart = c.take<float>(
      std::max(2LL * col_chunks(d.M()) * std::max(d.Dm, 3 * d.D), attention_partials(d)));
  if (out != nullptr) *out = w;
  return c.off;
}

template <typename T>
cudaError_t block_backward(const BlockWeights& w, const T* x, const T* g, T* dx, const Grads& gr,
                           const BwdBufs<T>& bb, const Dims& d, cudaStream_t s) {
  const FwdBufs<T>& f = bb.f;
  const int M = d.M(), D = d.D, Dm = d.Dm;
  VB_CHECK(block_forward<T>(w, x, nullptr, f, d, s));  // recompute, with the statistics

  // MLP
  VB_CHECK((colsum<T, T, false>(g, M, D, nullptr, nullptr, nullptr, bb.cpart, gr.db2, nullptr, s)));
  VB_CHECK(weight_grad<T>(f.a, Dm, g, D, M, bb.wpart, gr.dw2, s));
  VB_CHECK((gemm1<T, false, false, kEpiDGelu>(g, D, w.w2, D, nullptr, f.hh, bb.dhh, bb.dhh32, Dm,
                                              M, Dm, D, s)));
  VB_CHECK((colsum<float, T, false>(bb.dhh32, M, Dm, nullptr, nullptr, nullptr, bb.cpart, gr.db1,
                                    nullptr, s)));
  VB_CHECK(weight_grad<T>(f.h2, D, bb.dhh, Dm, M, bb.wpart, gr.dw1, s));
  VB_CHECK((gemm1<T, false, false, kEpiF32>(bb.dhh, Dm, w.w1, Dm, nullptr, nullptr, nullptr, bb.dh,
                                            D, M, D, Dm, s)));
  // LN2
  VB_CHECK((colsum<float, T, true>(bb.dh, M, D, f.y, f.mean2, f.rstd2, bb.cpart, gr.dln2b,
                                   gr.dln2s, s)));
  ln_bwd_rows<T, T><<<(M + 7) / 8, 256, 0, s>>>(bb.dh, f.y, f.mean2, f.rstd2, w.ln2s, g, bb.dy32,
                                                 bb.dyb, M, D);
  VB_LAUNCHED();
  // proj
  VB_CHECK((colsum<float, T, false>(bb.dy32, M, D, nullptr, nullptr, nullptr, bb.cpart, gr.dbproj,
                                    nullptr, s)));
  VB_CHECK(weight_grad<T>(f.attn, D, bb.dyb, D, M, bb.wpart, gr.dwproj, s));
  VB_CHECK((gemm1<T, false, false, kEpiStore>(bb.dyb, D, w.wproj, D, nullptr, nullptr, bb.dout,
                                              nullptr, D, M, D, D, s)));
  // attention, with dbqkv
  const AttnBwdArgs attn{f.qkv, bb.dout, f.row_max, f.row_sum, bb.stats, bb.dqkvb, bb.cpart,
                         gr.dbqkv, d.B, d.H, d.Lp, D, d.true_len,
                         1.f / sqrtf(static_cast<float>(kDh))};
  VB_CHECK(attention_backward<T>(attn, s));
  // qkv
  VB_CHECK(weight_grad<T>(f.h1, D, bb.dqkvb, 3 * D, M, bb.wpart, gr.dwqkv, s));
  VB_CHECK((gemm1<T, false, false, kEpiF32>(bb.dqkvb, 3 * D, w.wqkv, 3 * D, nullptr, nullptr,
                                            nullptr, bb.dh, D, M, D, 3 * D, s)));
  // LN1
  VB_CHECK((colsum<float, T, true>(bb.dh, M, D, x, f.mean1, f.rstd1, bb.cpart, gr.dln1b, gr.dln1s,
                                   s)));
  ln_bwd_rows<T, float><<<(M + 7) / 8, 256, 0, s>>>(bb.dh, x, f.mean1, f.rstd1, w.ln1s, bb.dy32,
                                                     nullptr, dx, M, D);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run(const BlockWeights& w, const void* x, const void* g, void* dx, const Grads& gr,
                void* ws, const Dims& d, cudaStream_t s) {
  BwdBufs<T> bb;
  bwd_workspace<T>(d, static_cast<char*>(ws), &bb);
  return block_backward<T>(w, static_cast<const T*>(x), static_cast<const T*>(g),
                           static_cast<T*>(dx), gr, bb, d, s);
}

}  // namespace

// Bytes of workspace the backward needs (-1 for dimensions it does not take).
extern "C" long long vidil_fused_block_bwd_workspace(int dtype, int B, int Lp, int D, int Dm,
                                                     int H) {
  const Dims d{B, Lp, D, Dm, H, Lp, 0.f};
  if (!dims_ok(d)) return -1;
  return static_cast<long long>(dtype == 0 ? bwd_workspace<bf16>(d, nullptr, nullptr)
                                           : bwd_workspace<float>(d, nullptr, nullptr));
}

// The split-K partials of the four weight gradients (dw2, dw1, dwproj, dwqkv)
// at these dimensions, into out[4]; -1 for dimensions the backward does not
// take.
extern "C" int vidil_fused_block_bwd_wgrad_splits(int dtype, int B, int Lp, int D, int Dm, int H,
                                                  int* out) {
  const Dims d{B, Lp, D, Dm, H, Lp, 0.f};
  if (!dims_ok(d) || (dtype != 0 && dtype != 1)) return -1;
  const int ij[4][2] = {{Dm, D}, {D, Dm}, {D, D}, {D, 3 * D}};
  for (int i = 0; i < 4; ++i) {
    out[i] = dtype == 0 ? gemm_split<bf16>(ij[i][0], ij[i][1], d.M(), true).count
                        : gemm_split<float>(ij[i][0], ij[i][1], d.M(), true).count;
  }
  return 0;
}

// The block's attention backward alone (the chain's dq and dk/dv passes,
// with dbqkv) on a (B, Lp, 3D) QKV workspace, the rounded (B, Lp, D) output
// gradient do and the recompute's (B*H, Lp) fp32 row max and row sum: dqkv
// (B, Lp, 3D) in the dtype, stats (B*H, Lp / 64, 4, 64) fp32 (the raw row
// max, the row sum, its reciprocal, D), dbqkv (3D,) fp32; part is a
// (B*Lp / 64, 3D) fp32 scratch. dtype as below; every tensor contiguous.
// Returns cudaGetLastError() after the launches.
extern "C" int vidil_fused_block_attention_bwd(const void* qkv, const void* dout,
                                               const float* row_max, const float* row_sum,
                                               float* stats, void* dqkv, float* part,
                                               float* dbqkv, int dtype, int device, int B, int Lp,
                                               int D, int H, int true_len, void* stream) {
  const Dims d{B, Lp, D, 128, H, true_len, 0.f};
  if (!dims_ok(d) || (dtype != 0 && dtype != 1)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const AttnBwdArgs a{qkv, dout, row_max, row_sum, stats, dqkv, part, dbqkv, B, H, Lp, D,
                      true_len, 1.f / sqrtf(static_cast<float>(kDh))};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = dtype == 0 ? attention_backward<bf16>(a, s) : attention_backward<float>(a, s);
  return static_cast<int>(err);
}

// dtype: 0 = bf16, 1 = fp32 (x, g, dx, the linears' weights and biases);
// LayerNorm parameters and the 12 gradients are fp32. Every tensor is
// contiguous, shapes as in vidil_fused_block_fwd; each gradient has its
// parameter's shape. Returns cudaGetLastError() after the launches.
extern "C" int vidil_fused_block_bwd(
    const void* x, const float* ln1s, const float* ln1b, const void* wqkv, const void* bqkv,
    const void* wproj, const void* bproj, const float* ln2s, const float* ln2b, const void* w1,
    const void* b1, const void* w2, const void* b2, const void* g, void* dx, float* dln1s,
    float* dln1b, float* dwqkv, float* dbqkv, float* dwproj, float* dbproj, float* dln2s,
    float* dln2b, float* dw1, float* db1, float* dw2, float* db2, void* ws, int dtype, int device,
    int B, int Lp, int D, int Dm, int H, int true_len, float eps, void* stream) {
  const Dims d{B, Lp, D, Dm, H, true_len, eps};
  if (!dims_ok(d) || (dtype != 0 && dtype != 1)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const BlockWeights w{ln1s, ln1b, wqkv, bqkv, wproj, bproj, ln2s, ln2b, w1, b1, w2, b2};
  const Grads gr{dln1s, dln1b, dwqkv, dbqkv, dwproj, dbproj, dln2s, dln2b, dw1, db1, dw2, db2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = dtype == 0 ? run<bf16>(w, x, g, dx, gr, ws, d, s) : run<float>(w, x, g, dx, gr, ws, d, s);
  return static_cast<int>(err);
}
