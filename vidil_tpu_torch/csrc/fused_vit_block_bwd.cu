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
//   dsb = round(ds * scale); dq = dsb . k and dk = dsb^T . q with q unscaled,
//   both kept fp32 in dqkv32
//   dbqkv = colsum(dqkv32), unrounded;  dwqkv = h1^T . round(dqkv32)
//   dh1 = round(dqkv32) . wqkv^T;  dln1s, dln1b as for LN2
//   dx = round(dy + LN1 backward)
// The gradients are fp32, summed over every row; the wrapper casts the
// linears' ones to their (bf16) dtype, as the TPU package does.
//
// Design. The TPU kernel accumulates the weight gradients in VMEM across its
// sequential grid. Hopper blocks run in parallel and in no order, so every
// sum over rows here is a fixed-order reduction and results are identical
// run to run: the weight-gradient GEMMs (A^T . B over all B*Lp rows) split
// the rows into a fixed number of slices and add the slices' fp32 partials in
// order; the column sums add fixed row chunks, then the chunks in order; the
// attention backward is split like flash_attention_bwd.cu into a dq pass (one
// block per 64 query rows, which also computes D) and a dk/dv pass (one
// block per 64 keys, looping over the query tiles), with no atomics.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): at the 224-px
// trainer shape (48 frames, 256 padded tokens, 768 wide) the TPU cost model
// counts three times the forward's operations, 550 GFLOP (~0.56 ms); the
// recompute, the split attention passes and the device-memory intermediates
// make this kernel do and move more than that. Its 11 products (3 of the
// recompute, 4 data and 4 weight gradients: 464 GFLOP, 0.47 ms at peak) run
// on the wgmma + TMA GEMM of gemm_sm90.cuh; the weight gradients' split-K
// comes from its tile plan (3-4 partials for dwproj, dw1 and dw2 at 12,288
// rows, none for dwqkv). Device time per call at that shape, by part
// (chip_smoke.py phase 8, torch.profiler; H100 80GB HBM3, 700 W): GEMMs
// 0.99 ms (11 launches, 469 TFLOP/s), attention 0.93 ms (the recompute's
// forward on the block's wgmma + TMA attention, ~0.045 of it, and the dq
// and dk/dv passes, mma.sync), column sums 0.22 ms (12), LayerNorm rows
// 0.16 ms (4), split sums 0.06 ms (3): 2.37 ms. What is left: the dq and
// dk/dv passes on the structure of flash_attention_bwd.cu's wgmma + TMA
// kernels, and the column sums and LayerNorm rows folded into the GEMMs'
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
  const float* row_max;  // (B*H, Lp) from the forward recompute
  const float* row_sum;
  float* delta;          // (B*H, Lp): D, written by the dq pass
  float* dqkv32;         // (B, Lp, 3D) fp32
  void* dqkv;            // (B, Lp, 3D) rounded copy
  int H, Lp, D, true_len;
  float scale;
};

__device__ __forceinline__ float prob(float s, float scale, bool masked, float m, float l) {
  return masked ? 0.f : expf(s * scale - m) / l;
}

template <typename T>
__device__ __forceinline__ void store_pair(const AttnBwdArgs& p, long long i, float v0, float v1) {
  p.dqkv32[i] = v0;
  p.dqkv32[i + 1] = v1;
  static_cast<T*>(p.dqkv)[i] = from_f<T>(v0);
  static_cast<T*>(p.dqkv)[i + 1] = from_f<T>(v1);
}

// bf16 dq pass: one block of 4 warps per (frame*head, 64 query rows). Loop 1
// over the key tiles computes D = sum_k dp * p32 per row; loop 2 forms
// dsb = round(p32 * (dp - D) * scale) and accumulates dq = dsb . k.
__global__ void __launch_bounds__(128) attn_bwd_dq_bf16(const AttnBwdArgs p) {
  __shared__ __align__(16) AttnTile q_s;
  __shared__ __align__(16) AttnTile do_s;
  __shared__ __align__(16) AttnTile k_s;
  __shared__ __align__(16) AttnTile v_s;
  __shared__ __align__(16) AttnTile kt_s;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int m0 = blockIdx.y * kAttnTile;
  const long long ld = 3LL * p.D;
  const bf16* q = static_cast<const bf16*>(p.qkv) + b * p.Lp * ld + h * kDh;
  const bf16* k = q + p.D;
  const bf16* v = q + 2 * p.D;
  const bf16* dout = static_cast<const bf16*>(p.dout) + b * p.Lp * static_cast<long long>(p.D) + h * kDh;

  stage_tile(q, ld, m0, &q_s, nullptr);
  stage_tile(dout, p.D, m0, &do_s, nullptr);
  __syncthreads();
  const int r0 = warp * 16;
  uint32_t qa[kDh / 16][4];
  uint32_t da[kDh / 16][4];
  load_a_frags(q_s, r0, g, t4, qa);
  load_a_frags(do_s, r0, g, t4, da);
  float m_r[2], l_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long row = static_cast<long long>(bh) * p.Lp + m0 + r0 + g + 8 * r;
    m_r[r] = p.row_max[row];
    l_r[r] = p.row_sum[row];
  }

  float dsum[2] = {0.f, 0.f};
  for (int n0 = 0; n0 < p.Lp; n0 += kAttnTile) {
    __syncthreads();
    stage_tile(k, ld, n0, &k_s, nullptr);
    stage_tile(v, ld, n0, &v_s, nullptr);
    __syncthreads();
    float s[kAttnTile / 8][4], dp[kAttnTile / 8][4];
    mma_rows(qa, k_s, g, t4, s);
    mma_rows(da, v_s, g, t4, dp);
#pragma unroll
    for (int j = 0; j < kAttnTile / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool masked = key_masked(n0 + j * 8 + t4 * 2 + (e & 1), p.true_len, p.Lp);
        dsum[e >> 1] += dp[j][e] * prob(s[j][e], p.scale, masked, m_r[e >> 1], l_r[e >> 1]);
      }
    }
  }
  float delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float t = dsum[r];
    t += __shfl_xor_sync(0xffffffffu, t, 1);
    t += __shfl_xor_sync(0xffffffffu, t, 2);
    delta_r[r] = t;
    if (t4 == 0) p.delta[static_cast<long long>(bh) * p.Lp + m0 + r0 + g + 8 * r] = t;
  }

  float acc[kDh / 8][4];
#pragma unroll
  for (int dn = 0; dn < kDh / 8; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  for (int n0 = 0; n0 < p.Lp; n0 += kAttnTile) {
    __syncthreads();
    stage_tile(k, ld, n0, &k_s, &kt_s);
    stage_tile(v, ld, n0, &v_s, nullptr);
    __syncthreads();
    float s[kAttnTile / 8][4], dp[kAttnTile / 8][4];
    mma_rows(qa, k_s, g, t4, s);
    mma_rows(da, v_s, g, t4, dp);
#pragma unroll
    for (int j = 0; j < kAttnTile / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const bool masked = key_masked(n0 + j * 8 + t4 * 2 + (e & 1), p.true_len, p.Lp);
        const float pr = prob(s[j][e], p.scale, masked, m_r[r], l_r[r]);
        s[j][e] = pr * (dp[j][e] - delta_r[r]) * p.scale;  // ds * scale, fp32
      }
    }
    uint32_t dsa[kAttnTile / 16][4];
    c_to_a(s, dsa);                  // dsb = round(ds * scale)
    mma_acc(dsa, kt_s, g, t4, acc);  // dq += dsb k
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long row = static_cast<long long>(b) * p.Lp + m0 + r0 + g + 8 * r;
#pragma unroll
    for (int dn = 0; dn < kDh / 8; ++dn) {
      store_pair<bf16>(p, row * ld + h * kDh + dn * 8 + t4 * 2, acc[dn][2 * r], acc[dn][2 * r + 1]);
    }
  }
}

// bf16 dk/dv pass: one block of 4 warps per (frame*head, 64 keys), 16 keys a
// warp, looping over the query tiles; scores are computed transposed
// (rows = keys).
__global__ void __launch_bounds__(128) attn_bwd_dkdv_bf16(const AttnBwdArgs p) {
  __shared__ __align__(16) AttnTile q_s;    // q tile [q][d]; first the k tile
  __shared__ __align__(16) AttnTile do_s;   // do tile [q][d]; first the v tile
  __shared__ __align__(16) AttnTile qt_s;   // q tile transposed [d][q]
  __shared__ __align__(16) AttnTile dot_s;  // do tile transposed [d][q]
  __shared__ float m_s[kAttnTile];
  __shared__ float l_s[kAttnTile];
  __shared__ float delta_s[kAttnTile];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int n0 = blockIdx.y * kAttnTile;
  const long long ld = 3LL * p.D;
  const bf16* q = static_cast<const bf16*>(p.qkv) + b * p.Lp * ld + h * kDh;
  const bf16* k = q + p.D;
  const bf16* v = q + 2 * p.D;
  const bf16* dout = static_cast<const bf16*>(p.dout) + b * p.Lp * static_cast<long long>(p.D) + h * kDh;
  const long long stat0 = static_cast<long long>(bh) * p.Lp;

  stage_tile(k, ld, n0, &q_s, nullptr);
  stage_tile(v, ld, n0, &do_s, nullptr);
  __syncthreads();
  const int r0 = warp * 16;
  uint32_t ka[kDh / 16][4];
  uint32_t va[kDh / 16][4];
  load_a_frags(q_s, r0, g, t4, ka);
  load_a_frags(do_s, r0, g, t4, va);
  bool masked[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) masked[r] = key_masked(n0 + r0 + g + 8 * r, p.true_len, p.Lp);

  float dk_acc[kDh / 8][4];
  float dv_acc[kDh / 8][4];
#pragma unroll
  for (int dn = 0; dn < kDh / 8; ++dn) {
    dk_acc[dn][0] = dk_acc[dn][1] = dk_acc[dn][2] = dk_acc[dn][3] = 0.f;
    dv_acc[dn][0] = dv_acc[dn][1] = dv_acc[dn][2] = dv_acc[dn][3] = 0.f;
  }

  for (int m0 = 0; m0 < p.Lp; m0 += kAttnTile) {
    __syncthreads();
    stage_tile(q, ld, m0, &q_s, &qt_s);
    stage_tile(dout, p.D, m0, &do_s, &dot_s);
    if (tid < kAttnTile) {
      m_s[tid] = p.row_max[stat0 + m0 + tid];
      l_s[tid] = p.row_sum[stat0 + m0 + tid];
      delta_s[tid] = p.delta[stat0 + m0 + tid];
    }
    __syncthreads();

    float pt[kAttnTile / 8][4];
    mma_rows(ka, q_s, g, t4, pt);  // s^T = k q^T
#pragma unroll
    for (int j = 0; j < kAttnTile / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + t4 * 2 + (e & 1);
        pt[j][e] = prob(pt[j][e], p.scale, masked[e >> 1], m_s[col], l_s[col]);  // p32^T
      }
    }
    uint32_t pa[kAttnTile / 16][4];
    c_to_a(pt, pa);                     // round(p32)
    mma_acc(pa, dot_s, g, t4, dv_acc);  // dv += round(p32)^T do

    float dst[kAttnTile / 8][4];
    mma_rows(va, do_s, g, t4, dst);  // dp^T = v do^T
#pragma unroll
    for (int j = 0; j < kAttnTile / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + t4 * 2 + (e & 1);
        dst[j][e] = pt[j][e] * (dst[j][e] - delta_s[col]) * p.scale;  // ds^T * scale
      }
    }
    uint32_t dsa[kAttnTile / 16][4];
    c_to_a(dst, dsa);                   // dsb^T
    mma_acc(dsa, qt_s, g, t4, dk_acc);  // dk += dsb^T q
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long row = static_cast<long long>(b) * p.Lp + n0 + r0 + g + 8 * r;
#pragma unroll
    for (int dn = 0; dn < kDh / 8; ++dn) {
      const long long c = row * ld + h * kDh + dn * 8 + t4 * 2;
      store_pair<bf16>(p, c + p.D, dk_acc[dn][2 * r], dk_acc[dn][2 * r + 1]);
      store_pair<bf16>(p, c + 2 * p.D, dv_acc[dn][2 * r], dv_acc[dn][2 * r + 1]);
    }
  }
}

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
  p.delta[static_cast<long long>(bh) * p.Lp + row] = delta;
  const long long base = (static_cast<long long>(b) * p.Lp + row) * ld + h * kDh;
#pragma unroll
  for (int d = 0; d < kDh; d += 2) store_pair<float>(p, base + d, acc[d], acc[d + 1]);
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
      delta_s[tid] = p.delta[stat0 + m0 + tid];
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
  const long long base = (static_cast<long long>(b) * p.Lp + key) * ld + h * kDh;
#pragma unroll
  for (int d = 0; d < kDh; d += 2) {
    store_pair<float>(p, base + p.D + d, dk_acc[d], dk_acc[d + 1]);
    store_pair<float>(p, base + 2 * p.D + d, dv_acc[d], dv_acc[d + 1]);
  }
}

template <typename T>
cudaError_t attention_backward(const AttnBwdArgs& a, int B, cudaStream_t s) {
  const dim3 grid(B * a.H, a.Lp / kAttnTile);
  if constexpr (std::is_same<T, bf16>::value) {
    attn_bwd_dq_bf16<<<grid, 128, 0, s>>>(a);
    VB_LAUNCHED();
    attn_bwd_dkdv_bf16<<<grid, 128, 0, s>>>(a);
  } else {
    attn_bwd_dq_f32<<<grid, kAttnTile, 0, s>>>(a);
    VB_LAUNCHED();
    attn_bwd_dkdv_f32<<<grid, kAttnTile, 0, s>>>(a);
  }
  return cudaGetLastError();
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
  float *dhh32, *dh, *dy32, *dqkv32, *delta, *wpart, *cpart;
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
  w.dqkv32 = c.take<float>(M * 3 * d.D);
  w.dqkvb = c.take<T>(M * 3 * d.D);
  w.delta = c.take<float>(M * d.H);
  const long long wpart = std::max(
      std::max(weight_grad_partials<T>(d.Dm, d.D, d.M()), weight_grad_partials<T>(d.D, d.Dm, d.M())),
      std::max(weight_grad_partials<T>(d.D, d.D, d.M()), weight_grad_partials<T>(d.D, 3 * d.D, d.M())));
  w.wpart = c.take<float>(std::max(wpart, 1LL));
  w.cpart = c.take<float>(2LL * col_chunks(d.M()) * std::max(d.Dm, 3 * d.D));
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
  // attention
  const AttnBwdArgs attn{f.qkv, bb.dout, f.row_max, f.row_sum, bb.delta, bb.dqkv32, bb.dqkvb,
                         d.H, d.Lp, D, d.true_len, 1.f / sqrtf(static_cast<float>(kDh))};
  VB_CHECK(attention_backward<T>(attn, d.B, s));
  // qkv
  VB_CHECK((colsum<float, T, false>(bb.dqkv32, M, 3 * D, nullptr, nullptr, nullptr, bb.cpart,
                                    gr.dbqkv, nullptr, s)));
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
