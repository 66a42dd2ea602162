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
//     Lq contribute nothing. Bounds mask both tails: nothing is padded in
//     device memory.
//
// Design. The TPU kernel held the whole padded query axis in one VMEM block
// so that dk/dv needed no accumulation across programs. On Hopper the
// blocks run in parallel and in no order, so the work is split into two
// kernels that need no atomics (results are identical run to run):
//   1. dq: one block per (batch*head, 64-row q tile), looping over 64-key
//      tiles. It first computes Delta for its rows once and writes it to a
//      scratch (B*H, Lq) array for kernel 2.
//   2. dk/dv: one block per (batch*head, 64-key tile), looping over q tiles;
//      it recomputes s and p from lse.
//   bf16: 4 warps, each owning 16 rows (q rows in kernel 1, keys in kernel 2);
//         every product is mma.sync m16n8k16 (bf16 in, fp32 accumulate). The
//         fp32 score/probability fragments turn into bf16 A operands in
//         registers. Operands needed as "col" B fragments in both
//         orientations (k in kernel 1; q and g in kernel 2) are staged in
//         shared memory twice, once transposed.
//   fp32: one thread per row (q rows in kernel 1, keys in kernel 2), plain
//         fp32 FMAs (no TF32).
// Inputs take batch/head/sequence strides with unit stride over D: q, k, v
// arrive as head-split views of the QKV projection, g as a view of the
// merge_heads gradient, o as the forward's (B, Lq, H, D) allocation.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): at the 224-px
// trainer shape (48, 12, 197, 64) bf16 it reads q, k, v, o, g and lse and
// writes dq, dk, dv (~117 MB) -> ~35 us by bytes, against 14.3 GFLOP of
// the five products (q k^T, g v^T, p^T g, ds^T q, ds k) -> ~14.5 us; at the
// 384-px shape (32, 12, 577, 64) ~228 MB -> 68 us and 81.8 GFLOP -> ~83 us.
// This kernel recomputes q k^T and g v^T in both passes (7 products, not 5)
// and stages single-buffered tiles through shared memory; wgmma, TMA and
// double buffering are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;        // head dim
constexpr int kBlock = 64;    // rows per tile (q rows or keys)
constexpr int kPad = 8;       // shared-memory row padding (bf16 elements)
constexpr int kBlockQ32 = 16; // q rows per tile in the fp32 dk/dv kernel

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* g;
  const float* lse;   // (B*H, Lq), contiguous
  float* delta;       // (B*H, Lq) scratch: written by the dq kernel
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
  int H, Lq, Lk;
  float scale;
};

__device__ __forceinline__ void mma_bf16_16816(float c[4], const uint32_t a[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

typedef __nv_bfloat16 Tile[kBlock][kD + kPad];

// Stage rows [r0, r0 + 64) of a (rows, 64) bf16 matrix into `s` (and its
// transpose into `t` when given), scaled by `scale` and rounded to bf16 when
// `scale` is not 1; rows at or past `n` are zero.
__device__ __forceinline__ void stage_tile(const __nv_bfloat16* src, long long stride, int r0,
                                           int n, float scale, Tile* s, Tile* t) {
  for (int i = threadIdx.x; i < kBlock * kD / 8; i += blockDim.x) {
    const int r = i / (kD / 8);
    const int c = (i % (kD / 8)) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + r < n) val = *reinterpret_cast<const uint4*>(src + (r0 + r) * stride + c);
    __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&val);
    if (scale != 1.f) {
#pragma unroll
      for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16_rn(__bfloat162float(e[j]) * scale);
    }
    if (s != nullptr) *reinterpret_cast<uint4*>(&(*s)[r][c]) = val;
    if (t != nullptr) {
#pragma unroll
      for (int j = 0; j < 8; ++j) (*t)[c + j][r] = e[j];
    }
  }
}

// A fragments (m16 x k16, 4 chunks over D = 64) of rows [r0, r0 + 16) of `s`.
__device__ __forceinline__ void load_a_frags(const Tile& s, int r0, int g, int t4,
                                             uint32_t a[kD / 16][4]) {
#pragma unroll
  for (int kc = 0; kc < kD / 16; ++kc) {
    const int c = kc * 16 + t4 * 2;
    a[kc][0] = ld_u32(&s[r0 + g][c]);
    a[kc][1] = ld_u32(&s[r0 + g + 8][c]);
    a[kc][2] = ld_u32(&s[r0 + g][c + 8]);
    a[kc][3] = ld_u32(&s[r0 + g + 8][c + 8]);
  }
}

// c[j] = a (16 x 64) times rows [8j, 8j + 8) of `b` (the B operand stored
// [n][k], k over D), for the 8 n-tiles of a 64-wide tile.
__device__ __forceinline__ void mma_rows(const uint32_t a[kD / 16][4], const Tile& b, int g,
                                         int t4, float c[kBlock / 8][4]) {
#pragma unroll
  for (int j = 0; j < kBlock / 8; ++j) {
    c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < kD / 16; ++kc) {
      const __nv_bfloat16* br = &b[j * 8 + g][kc * 16 + t4 * 2];
      mma_bf16_16816(c[j], a[kc], ld_u32(br), ld_u32(br + 8));
    }
  }
}

// acc (16 x 64 over D) += a (16 x 64, A fragments over the tile's 64 rows)
// times `bt` (the B operand stored [d][row]).
__device__ __forceinline__ void mma_acc(const uint32_t a[kBlock / 16][4], const Tile& bt, int g,
                                        int t4, float acc[kD / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < kBlock / 16; ++kk) {
#pragma unroll
    for (int dn = 0; dn < kD / 8; ++dn) {
      const __nv_bfloat16* br = &bt[dn * 8 + g][kk * 16 + t4 * 2];
      mma_bf16_16816(acc[dn], a[kk], ld_u32(br), ld_u32(br + 8));
    }
  }
}

// C fragments of n-tiles 2kk and 2kk + 1 form the A fragment of columns
// [16kk, 16kk + 16): rounds c to bf16 and packs it.
__device__ __forceinline__ void c_to_a(const float c[kBlock / 8][4], uint32_t a[kBlock / 16][4]) {
#pragma unroll
  for (int j = 0; j < kBlock / 8; ++j) {
    const int kk = j >> 1;
    const int hi = (j & 1) * 2;
    a[kk][hi + 0] = pack_bf16(__float2bfloat16_rn(c[j][0]), __float2bfloat16_rn(c[j][1]));
    a[kk][hi + 1] = pack_bf16(__float2bfloat16_rn(c[j][2]), __float2bfloat16_rn(c[j][3]));
  }
}

// ---------------------------------------------------------------------------
// bf16 kernel 1: dq (and Delta), one block per (batch*head, 64 q rows)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(128) flash_bwd_dq_bf16(const Params p) {
  __shared__ __align__(16) Tile q_s;   // pre-scaled q tile
  __shared__ __align__(16) Tile g_s;   // g tile
  __shared__ __align__(16) Tile k_s;   // k tile [key][d]
  __shared__ __align__(16) Tile v_s;   // v tile [key][d]
  __shared__ __align__(16) Tile kt_s;  // k tile transposed [d][key]
  __shared__ float delta_s[kBlock];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int m0 = blockIdx.y * kBlock;

  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const __nv_bfloat16* o = static_cast<const __nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;
  const __nv_bfloat16* gr = static_cast<const __nv_bfloat16*>(p.g) + b * p.g_sb + h * p.g_sh;
  __nv_bfloat16* dq = static_cast<__nv_bfloat16*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
  const float* lse = p.lse + static_cast<long long>(bh) * p.Lq;
  float* delta = p.delta + static_cast<long long>(bh) * p.Lq;

  stage_tile(q, p.q_ss, m0, p.Lq, p.scale, &q_s, nullptr);
  stage_tile(gr, p.g_ss, m0, p.Lq, 1.f, &g_s, nullptr);
  __syncthreads();
  // Delta = rowsum(g * o) in fp32, once per q row
  if (tid < kBlock) {
    float d = 0.f;
    if (m0 + tid < p.Lq) {
      const __nv_bfloat16* orow = o + (m0 + tid) * p.o_ss;
#pragma unroll
      for (int c = 0; c < kD; c += 8) {
        const uint4 ov = *reinterpret_cast<const uint4*>(orow + c);
        const __nv_bfloat16* oe = reinterpret_cast<const __nv_bfloat16*>(&ov);
#pragma unroll
        for (int j = 0; j < 8; ++j) d = fmaf(__bfloat162float(g_s[tid][c + j]), __bfloat162float(oe[j]), d);
      }
      delta[m0 + tid] = d;
    }
    delta_s[tid] = d;
  }
  __syncthreads();

  const int r0 = warp * 16;
  uint32_t qa[kD / 16][4];
  uint32_t ga[kD / 16][4];
  load_a_frags(q_s, r0, g, t4, qa);
  load_a_frags(g_s, r0, g, t4, ga);
  float lse_r[2], delta_r[2];
  bool valid_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = m0 + r0 + g + 8 * r;
    valid_r[r] = row < p.Lq;
    lse_r[r] = valid_r[r] ? lse[row] : 0.f;
    delta_r[r] = delta_s[r0 + g + 8 * r];
  }

  float acc[kD / 8][4];
#pragma unroll
  for (int dn = 0; dn < kD / 8; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;

  for (int n0 = 0; n0 < p.Lk; n0 += kBlock) {
    __syncthreads();  // every warp is done with the previous tile
    stage_tile(k, p.k_ss, n0, p.Lk, 1.f, &k_s, &kt_s);
    stage_tile(v, p.v_ss, n0, p.Lk, 1.f, &v_s, nullptr);
    __syncthreads();

    float s[kBlock / 8][4];
    float dp[kBlock / 8][4];
    mma_rows(qa, k_s, g, t4, s);   // s = q_scaled k^T
    mma_rows(ga, v_s, g, t4, dp);  // dp = g v^T
#pragma unroll
    for (int j = 0; j < kBlock / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const bool ok = valid_r[r] && (n0 + j * 8 + t4 * 2 + (e & 1) < p.Lk);
        const float pr = ok ? expf(s[j][e] - lse_r[r]) : 0.f;
        s[j][e] = pr * (dp[j][e] - delta_r[r]);  // ds, fp32
      }
    }
    uint32_t dsa[kBlock / 16][4];
    c_to_a(s, dsa);                  // ds rounded to bf16
    mma_acc(dsa, kt_s, g, t4, acc);  // dq += ds k
  }

  const __nv_bfloat16 scale_b = __float2bfloat16_rn(p.scale);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = m0 + r0 + g + 8 * r;
    if (row < p.Lq) {
      __nv_bfloat16* out = dq + row * p.dq_ss;
#pragma unroll
      for (int dn = 0; dn < kD / 8; ++dn) {
        const __nv_bfloat16 lo = __hmul(__float2bfloat16_rn(acc[dn][2 * r]), scale_b);
        const __nv_bfloat16 hi = __hmul(__float2bfloat16_rn(acc[dn][2 * r + 1]), scale_b);
        *reinterpret_cast<uint32_t*>(out + dn * 8 + t4 * 2) = pack_bf16(lo, hi);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 kernel 2: dk, dv, one block per (batch*head, 64 keys)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(128) flash_bwd_dkdv_bf16(const Params p) {
  __shared__ __align__(16) Tile q_s;   // pre-scaled q tile [q][d]; first the k tile
  __shared__ __align__(16) Tile g_s;   // g tile [q][d]; first the v tile
  __shared__ __align__(16) Tile qt_s;  // q tile transposed [d][q]
  __shared__ __align__(16) Tile gt_s;  // g tile transposed [d][q]
  __shared__ float lse_s[kBlock];
  __shared__ float delta_s[kBlock];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int n0 = blockIdx.y * kBlock;

  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const __nv_bfloat16* gr = static_cast<const __nv_bfloat16*>(p.g) + b * p.g_sb + h * p.g_sh;
  __nv_bfloat16* dk = static_cast<__nv_bfloat16*>(p.dk) + b * p.dk_sb + h * p.dk_sh;
  __nv_bfloat16* dv = static_cast<__nv_bfloat16*>(p.dv) + b * p.dv_sb + h * p.dv_sh;
  const float* lse = p.lse + static_cast<long long>(bh) * p.Lq;
  const float* delta = p.delta + static_cast<long long>(bh) * p.Lq;

  // this warp's 16 keys of k and v, as A fragments
  stage_tile(k, p.k_ss, n0, p.Lk, 1.f, &q_s, nullptr);
  stage_tile(v, p.v_ss, n0, p.Lk, 1.f, &g_s, nullptr);
  __syncthreads();
  const int r0 = warp * 16;
  uint32_t ka[kD / 16][4];
  uint32_t va[kD / 16][4];
  load_a_frags(q_s, r0, g, t4, ka);
  load_a_frags(g_s, r0, g, t4, va);
  bool key_ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) key_ok[r] = n0 + r0 + g + 8 * r < p.Lk;

  float dk_acc[kD / 8][4];
  float dv_acc[kD / 8][4];
#pragma unroll
  for (int dn = 0; dn < kD / 8; ++dn) {
    dk_acc[dn][0] = dk_acc[dn][1] = dk_acc[dn][2] = dk_acc[dn][3] = 0.f;
    dv_acc[dn][0] = dv_acc[dn][1] = dv_acc[dn][2] = dv_acc[dn][3] = 0.f;
  }

  for (int m0 = 0; m0 < p.Lq; m0 += kBlock) {
    __syncthreads();  // every warp is done with the previous tile
    stage_tile(q, p.q_ss, m0, p.Lq, p.scale, &q_s, &qt_s);
    stage_tile(gr, p.g_ss, m0, p.Lq, 1.f, &g_s, &gt_s);
    if (tid < kBlock) {
      const bool ok = m0 + tid < p.Lq;
      lse_s[tid] = ok ? lse[m0 + tid] : 0.f;
      delta_s[tid] = ok ? delta[m0 + tid] : 0.f;
    }
    __syncthreads();

    // transposed scores: rows = this warp's keys, columns = the tile's q rows
    float pt[kBlock / 8][4];
    mma_rows(ka, q_s, g, t4, pt);  // s^T = k q_scaled^T
#pragma unroll
    for (int j = 0; j < kBlock / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + t4 * 2 + (e & 1);
        const bool ok = key_ok[e >> 1] && (m0 + col < p.Lq);
        pt[j][e] = ok ? expf(pt[j][e] - lse_s[col]) : 0.f;  // p^T, fp32
      }
    }
    uint32_t pa[kBlock / 16][4];
    c_to_a(pt, pa);                    // p rounded to v's dtype
    mma_acc(pa, gt_s, g, t4, dv_acc);  // dv += p^T g

    float dst[kBlock / 8][4];
    mma_rows(va, g_s, g, t4, dst);  // dp^T = v g^T
#pragma unroll
    for (int j = 0; j < kBlock / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + t4 * 2 + (e & 1);
        dst[j][e] = pt[j][e] * (dst[j][e] - delta_s[col]);  // ds^T, fp32
      }
    }
    uint32_t dsa[kBlock / 16][4];
    c_to_a(dst, dsa);                   // ds rounded to bf16
    mma_acc(dsa, qt_s, g, t4, dk_acc);  // dk += ds^T q_scaled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = n0 + r0 + g + 8 * r;
    if (row < p.Lk) {
      __nv_bfloat16* dkr = dk + row * p.dk_ss;
      __nv_bfloat16* dvr = dv + row * p.dv_ss;
#pragma unroll
      for (int dn = 0; dn < kD / 8; ++dn) {
        *reinterpret_cast<uint32_t*>(dkr + dn * 8 + t4 * 2) =
            pack_bf16(__float2bfloat16_rn(dk_acc[dn][2 * r]), __float2bfloat16_rn(dk_acc[dn][2 * r + 1]));
        *reinterpret_cast<uint32_t*>(dvr + dn * 8 + t4 * 2) =
            pack_bf16(__float2bfloat16_rn(dv_acc[dn][2 * r]), __float2bfloat16_rn(dv_acc[dn][2 * r + 1]));
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
  if (valid) p.delta[static_cast<long long>(bh) * p.Lq + row] = delta;

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
  const float* delta = p.delta + static_cast<long long>(bh) * p.Lq;

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
// stride. lse and delta are contiguous (B*H, Lq) fp32; delta is scratch.
// Launches the dq kernel, then the dk/dv kernel, on `stream`; returns
// cudaGetLastError() after the launches (0 on success).
extern "C" int vidil_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o, const void* g,
    const float* lse, float* delta, void* dq, void* dk, void* dv,
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
  Params p{q, k, v, o, g, lse, delta, dq, dk, dv,
           q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
           o_sb, o_sh, o_ss, g_sb, g_sh, g_ss,
           dq_sb, dq_sh, dq_ss, dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, dv_ss,
           H, Lq, Lk, scale};
  const dim3 grid_q(B * H, (Lq + kBlock - 1) / kBlock);
  const dim3 grid_k(B * H, (Lk + kBlock - 1) / kBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    flash_bwd_dq_bf16<<<grid_q, 128, 0, s>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_bwd_dkdv_bf16<<<grid_k, 128, 0, s>>>(p);
  } else if (dtype == 1) {
    flash_bwd_dq_f32<<<grid_q, kBlock, 0, s>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_bwd_dkdv_f32<<<grid_k, kBlock, 0, s>>>(p);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
