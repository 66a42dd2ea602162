// The chunked state-space-dual (SSD) scan of Mamba-2's prefill over packed
// prompts (kernel K8), for Hopper (sm_90a). For every prompt and head h, with
// a_t = dt_t A_h and the prompt's tokens cut into chunks of 128 from its
// first one:
//   y_i = exp(cs_i) C_i . h_in^T + sum_{j<=i} exp(cs_i - cs_j) (C_i . B_j) dt_j x_j + D_h x_i
//   h_out = exp(cs_last) h_in + sum_j exp(cs_last - cs_j) dt_j x_j B_j^T
// where cs is the inclusive sum of a within the chunk and h (64 x 128 float32)
// enters a prompt's first chunk as zero. y is written in token order, (T, H,
// 64) float32; each prompt's last h to its row of the final states.
//
// Replaces no TPU kernel: the JAX package has no state-space layer. It was
// added because the plain path (ops/ssd.py:ssd_chunked_ref) materialises
// every intermediate in device memory in float32: gathered, padded and
// head-major copies of x, B and C, the (chunks, 8, 128, 128) decay matrices
// of each group, a chunk-state tensor and an entering-state tensor of ~614
// MB each at a 36k-token prefill, a chunk-ordered y and its gather back to
// token order, and ~24 small launches for the pass across chunks. That took
// ~19.5 ms a Mamba layer on an H100.
//
// Precision is the plain path's: every sum, the state, the cumulative decay,
// its exponentials and y are float32, and every product is exact, as an fp32
// FMA's is. The products run on the tensor cores (mma.sync m16n8k16, bf16 in,
// float32 sums) because one operand of each is exact in bf16 (x, B and C
// arrive in bf16): the other, a float32 value v (the decay-weighted C.B^T dt,
// the decay-weighted dt x, the entering state), is split into three bf16
// terms hi = bf16(v), mid = bf16(v - hi), lo = bf16(v - hi - mid), whose sum
// is v exactly (8 + 8 + 8 significant bits), and each term's product with the
// exact operand is exact in float32. No TF32 and no single bf16 rounding of a
// float32 value. No atomics: every sum runs in a fixed order, so a call gives
// the same bits every time.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): at the LM cell's
// layer (T ~36.4k tokens, H 64, P 64, G 8, N 128) the call reads x, B, C
// (12 KB a token in bf16) and dt and writes y (16 KB a token in float32):
// ~1.05 GB, 0.31 ms. Its products at three bf16 terms each (C.B^T once a head,
// the intra-chunk product, the read-out from the entering state and the chunk
// state) are ~2 x 18.5M multiply-adds a (chunk, head): ~0.7 TFLOP, 0.7 ms at
// the dense rate. So the operations bound it, at about 1.4x the bytes.
//
// Design:
//   * one block of 8 warps per (prompt, head), the prompts longest first, that
//     walks its prompt's chunks in order and carries the 64 x 128 float32
//     state in registers (32 values a thread): no chunk state reaches device
//     memory. 16 prompts x 64 heads = 1024 blocks, one resident an SM;
//   * x, B and C are read in place from the packed (T, ...) rows of the
//     convolution's output (strided views), dt from (T, H), by each prompt's
//     start and length; rows past a prompt's end are zero-filled (dt 0, x 0:
//     they decay nothing and add nothing). The next chunk's rows are copied
//     with cp.async while this one computes (two buffers of 80 KB in shared
//     memory, rows XOR-swizzled by 16-byte pieces, so ldmatrix reads them
//     without bank conflicts);
//   * warp 0 takes the chunk's cumulative decay (a warp scan) and its
//     exponentials; then each warp owns 16 rows of the chunk (warps w and w +
//     4, which share a scheduler, take row tiles w and 7 - w, so each
//     scheduler has the same share of the causal triangle). It computes C.B^T
//     for its rows 16 columns at a time, weights them by exp(cs_i - cs_j) dt_j
//     under the causal mask in registers, splits them into three bf16
//     fragments and multiplies them into its rows' y straight from registers
//     (an mma's float32 output fragment is the next one's bf16 input
//     fragment). Its y starts as the read-out from the entering state (C
//     times the state's three bf16 terms, in shared memory), scaled by
//     exp(cs_i); D x is added and y stored to its tokens' rows;
//   * then each warp updates 16 x 64 of the state: decayed by exp(cs_last),
//     plus (x dt exp(cs_last - cs_j))^T B over the chunk, the first operand
//     split in three; and writes its three bf16 terms to shared memory for
//     the next chunk's read-out, or at the prompt's end the float32 state to
//     the final states.
// Takes P 64, N 128, chunks of 128, float32 dt, A and D, bf16 x, B and C with
// unit stride inside a row and 16-byte-aligned rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kL = 128;  // chunk slots
constexpr int kP = 64;   // head dim
constexpr int kN = 128;  // state size
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;

// shared memory (bytes): two buffers of the chunk's x, B, C; the state's
// three bf16 terms; dt (two buffers), cs, exp(cs), the state weights, decay
constexpr int kXRow = kP * 2;                 // 128 bytes, 8 pieces of 16
constexpr int kBRow = kN * 2;                 // 256 bytes, 16 pieces
constexpr int kOffX = 0;
constexpr int kOffB = kOffX + kL * kXRow;
constexpr int kOffC = kOffB + kL * kBRow;
constexpr int kBufBytes = kOffC + kL * kBRow;  // 81920
constexpr int kOffHs = 2 * kBufBytes;
constexpr int kHsBytes = kP * kBRow;           // one term of the state, rows p of 128 n
constexpr int kOffDt = kOffHs + 3 * kHsBytes;
constexpr int kOffCs = kOffDt + 2 * kL * 4;
constexpr int kOffEcs = kOffCs + kL * 4;
constexpr int kOffWs = kOffEcs + kL * 4;
constexpr int kOffDecay = kOffWs + kL * 4;
constexpr int kSmem = kOffDecay + 16;          // 215,568 bytes
static_assert(kSmem <= 232448, "shared memory of one block");

struct Args {
  const __nv_bfloat16* x;  // (T, H, 64) rows of sx elements
  const __nv_bfloat16* B;  // (T, G, 128) rows of sb elements
  const __nv_bfloat16* C;  // (T, G, 128) rows of sc elements
  const float* dt;         // (T, H)
  const float* A;          // (H,)
  const float* D;          // (H,)
  const int* prompts;      // (n, 3): index, start, length; longest first
  float* y;                // (T, H, 64)
  float* final_state;      // (n, H, 64, 128)
  long long sx, sb, sc;
  int H, G;
};

// byte offset of 16-byte piece `piece` of row `row` (rows of row_bytes)
__device__ __forceinline__ uint32_t swz(int row, int piece, int row_bytes) {
  return static_cast<uint32_t>(row * row_bytes + ((piece ^ (row & 7)) << 4));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a . b, m16n8k16, bf16 operands, float32 sums
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (v0, v1) = hi + mid + lo exactly, each a bf16 pair (v0 in the low half)
__device__ __forceinline__ void split3(float v0, float v1, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  const float r0 = __fsub_rn(v0, hf.x), r1 = __fsub_rn(v1, hf.y);
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const float2 mf = __bfloat1622float2(m);
  hi = bits(h);
  mid = bits(m);
  lo = bits(__floats2bfloat162_rn(__fsub_rn(r0, mf.x), __fsub_rn(r1, mf.y)));
}

__device__ __forceinline__ float2 unpack(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
}

// the chunk's rows (tok0 .. tok0 + valid - 1) of x, B, C and dt into `buf`
__device__ __forceinline__ void load_chunk(const Args& a, uint32_t buf, uint32_t dt_dst,
                                           int tok0, int valid, int head, int group, int tid) {
#pragma unroll
  for (int q = tid; q < kL * 8; q += kThreads) {
    const int r = q >> 3, c = q & 7;
    const bool ok = r < valid;
    const long long row = ok ? tok0 + r : 0;
    cp_async16(buf + kOffX + swz(r, c, kXRow), a.x + row * a.sx + head * kP + c * 8, ok);
  }
#pragma unroll
  for (int q = tid; q < kL * 16; q += kThreads) {
    const int r = q >> 4, c = q & 15;
    const bool ok = r < valid;
    const long long row = ok ? tok0 + r : 0;
    cp_async16(buf + kOffB + swz(r, c, kBRow), a.B + row * a.sb + group * kN + c * 8, ok);
    cp_async16(buf + kOffC + swz(r, c, kBRow), a.C + row * a.sc + group * kN + c * 8, ok);
  }
  if (tid < kL) {
    const bool ok = tid < valid;
    const long long row = ok ? tok0 + tid : 0;
    cp_async4(dt_dst + tid * 4, a.dt + row * a.H + head, ok);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__global__ void __launch_bounds__(kThreads, 1) ssd_scan_chunked(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  float* cs = reinterpret_cast<float*>(smem + kOffCs);
  float* ecs = reinterpret_cast<float*>(smem + kOffEcs);
  float* ws = reinterpret_cast<float*>(smem + kOffWs);
  float* decay = reinterpret_cast<float*>(smem + kOffDecay);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int head = blockIdx.x % a.H, k = blockIdx.x / a.H;
  const int group = head / (a.H / a.G);
  const int idx = a.prompts[3 * k], start = a.prompts[3 * k + 1], len = a.prompts[3 * k + 2];
  const int n_chunks = (len + kL - 1) / kL;
  const float A_h = a.A[head], D_h = a.D[head];

  // the state rows p = 16 mt + g (+ 8), columns n = 64 nh + 8 nt + 2 t (+ 1)
  const int mt = warp & 3, nh = warp >> 2;
  float hacc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) hacc[nt][e] = 0.f;

  // this warp's rows of the chunk: i0 = 16 tile + g and i0 + 8
  const int tile = warp < 4 ? warp : 11 - warp;
  const int i0 = 16 * tile + g;

  // ldmatrix x4: lane l gives the address of row l % 8 of 8 x 8 block l / 8, here as (row,
  // 16-byte piece) offsets into a tile: an A fragment from rows of m; two n-tiles' B fragments
  // from rows of n (or, by .trans, an A fragment from rows of k); two n-tiles' B fragments from
  // rows of k, by .trans
  const int r_a = lane & 15, p_a = lane >> 4;
  const int r_b = (lane & 7) + 8 * (lane >> 4), p_b = (lane >> 3) & 1;
  const int r_t = (lane & 7) + 8 * ((lane >> 3) & 1), p_t = lane >> 4;

  if (n_chunks > 0) load_chunk(a, sbase, sbase + kOffDt, start, min(len, kL), head, group, tid);

  for (int c = 0; c < n_chunks; ++c) {
    const int cur = c & 1;
    const uint32_t buf = sbase + cur * kBufBytes;
    const float* dts = reinterpret_cast<const float*>(smem + kOffDt + cur * kL * 4);
    const int tok0 = start + c * kL;
    const int valid = min(len - c * kL, kL);
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // chunk c is in; every warp is done with chunk c - 1
    if (c + 1 < n_chunks) {
      load_chunk(a, sbase + (cur ^ 1) * kBufBytes, sbase + kOffDt + (cur ^ 1) * kL * 4,
                 tok0 + kL, min(len - (c + 1) * kL, kL), head, group, tid);
    }

    if (warp == 0) {  // cs = inclusive sum of dt A over the chunk, and its exponentials
      float v[4], s = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s = __fadd_rn(s, __fmul_rn(dts[4 * lane + e], A_h));  // dt A rounded, as the plain path
        v[e] = s;
      }
      float incl = s;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += o;
      }
      float before = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) before = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] += before;
      const float last = __shfl_sync(0xffffffffu, v[3], 31);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 4 * lane + e;
        cs[j] = v[e];
        ecs[j] = expf(v[e]);
        ws[j] = expf(last - v[e]) * dts[j];
      }
      if (lane == 0) decay[0] = expf(last);
    }
    __syncthreads();

    // ---- y of this warp's 16 rows ----
    const uint32_t xs = buf + kOffX, bs = buf + kOffB, csm = buf + kOffC;
    uint32_t cf[8][4];  // C rows i, k = state index
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) ldsm_x4(cf[ks], csm + swz(16 * tile + r_a, 2 * ks + p_a, kBRow));
    float acc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    if (c > 0) {  // the read-out from the entering state: C h^T, times exp(cs_i)
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
#pragma unroll
          for (int s = 0; s < 3; ++s) {
            uint32_t b[4];
            ldsm_x4(b, sbase + kOffHs + s * kHsBytes + swz(16 * q + r_b, 2 * ks + p_b, kBRow));
            mma(acc[2 * q], cf[ks], b[0], b[1]);
            mma(acc[2 * q + 1], cf[ks], b[2], b[3]);
          }
        }
      }
      const float e0 = ecs[i0], e1 = ecs[i0 + 8];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        acc[n][0] *= e0;
        acc[n][1] *= e0;
        acc[n][2] *= e1;
        acc[n][3] *= e1;
      }
    }
    const float csi0 = cs[i0], csi1 = cs[i0 + 8];
    for (int kk = 0; kk <= tile; ++kk) {  // columns j = 16 kk .. 16 kk + 15
      float cb[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) {
        uint32_t b[4];
        ldsm_x4(b, bs + swz(16 * kk + r_b, 2 * ks + p_b, kBRow));
        mma(cb[0], cf[ks], b[0], b[1]);
        mma(cb[1], cf[ks], b[2], b[3]);
      }
      // W[i, j] = exp(cs_i - cs_j) (C_i . B_j) dt_j for j <= i, as the next
      // product's A fragment: (row g, j 2t..2t+1), (row g+8, ...), (row g, j + 8), (row g+8, j + 8)
      float w[2][4];
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = 16 * kk + 8 * h2 + 2 * t + e;
          const float csj = cs[j], dtj = dts[j];
          w[h2][e] = j <= i0 ? expf(csi0 - csj) * cb[h2][e] * dtj : 0.f;
          w[h2][2 + e] = j <= i0 + 8 ? expf(csi1 - csj) * cb[h2][2 + e] * dtj : 0.f;
        }
      }
      uint32_t wf[3][4];
      split3(w[0][0], w[0][1], wf[0][0], wf[1][0], wf[2][0]);
      split3(w[0][2], w[0][3], wf[0][1], wf[1][1], wf[2][1]);
      split3(w[1][0], w[1][1], wf[0][2], wf[1][2], wf[2][2]);
      split3(w[1][2], w[1][3], wf[0][3], wf[1][3], wf[2][3]);
#pragma unroll
      for (int q = 0; q < 4; ++q) {  // x rows j, columns p = 16 q ..
        uint32_t b[4];
        ldsm_x4_t(b, xs + swz(16 * kk + r_t, 2 * q + p_t, kXRow));
#pragma unroll
        for (int s = 2; s >= 0; --s) {
          mma(acc[2 * q], wf[s], b[0], b[1]);
          mma(acc[2 * q + 1], wf[s], b[2], b[3]);
        }
      }
    }
    // + D x, stored to the tokens' rows
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = i0 + 8 * half;
      if (i < valid) {
        float* yrow = a.y + (static_cast<long long>(tok0 + i) * a.H + head) * kP;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const uint32_t off = xs - sbase + swz(i, n, kXRow) + 4 * t;
          const float2 xv = unpack(*reinterpret_cast<const uint32_t*>(smem + off));
          float2 out;
          out.x = acc[n][2 * half] + D_h * xv.x;
          out.y = acc[n][2 * half + 1] + D_h * xv.y;
          *reinterpret_cast<float2*>(yrow + 8 * n + 2 * t) = out;
        }
      }
    }
    __syncthreads();  // every warp has read the entering state's terms

    // ---- the state: h = exp(cs_last) h + sum_j (x_j dt_j exp(cs_last - cs_j)) B_j^T ----
    const float dec = decay[0];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) hacc[nt][e] *= dec;
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {  // j = 16 ks ..
      uint32_t xa[4];  // x^T rows p = 16 mt .., columns j
      ldsm_x4_t(xa, xs + swz(16 * ks + r_b, 2 * mt + p_b, kXRow));
      const int j = 16 * ks + 2 * t;
      const float w0 = ws[j], w1 = ws[j + 1], w8 = ws[j + 8], w9 = ws[j + 9];
      uint32_t af[3][4];
      float2 v = unpack(xa[0]);
      split3(v.x * w0, v.y * w1, af[0][0], af[1][0], af[2][0]);
      v = unpack(xa[1]);
      split3(v.x * w0, v.y * w1, af[0][1], af[1][1], af[2][1]);
      v = unpack(xa[2]);
      split3(v.x * w8, v.y * w9, af[0][2], af[1][2], af[2][2]);
      v = unpack(xa[3]);
      split3(v.x * w8, v.y * w9, af[0][3], af[1][3], af[2][3]);
#pragma unroll
      for (int q = 0; q < 4; ++q) {  // B rows j, columns n = 64 nh + 16 q ..
        uint32_t b[4];
        ldsm_x4_t(b, bs + swz(16 * ks + r_t, 8 * nh + 2 * q + p_t, kBRow));
#pragma unroll
        for (int s = 2; s >= 0; --s) {
          mma(hacc[2 * q], af[s], b[0], b[1]);
          mma(hacc[2 * q + 1], af[s], b[2], b[3]);
        }
      }
    }
    if (c + 1 < n_chunks) {  // the state's three bf16 terms for the next chunk's read-out
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int p = 16 * mt + g + 8 * half;
          uint32_t hi, mid, lo;
          split3(hacc[nt][2 * half], hacc[nt][2 * half + 1], hi, mid, lo);
          const uint32_t off = kOffHs + swz(p, 8 * nh + nt, kBRow) + 4 * t;
          *reinterpret_cast<uint32_t*>(smem + off) = hi;
          *reinterpret_cast<uint32_t*>(smem + off + kHsBytes) = mid;
          *reinterpret_cast<uint32_t*>(smem + off + 2 * kHsBytes) = lo;
        }
      }
    }
  }

  // the prompt's final state (zero for an empty prompt)
  float* fs = a.final_state + (static_cast<long long>(idx) * a.H + head) * kP * kN;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = 16 * mt + g + 8 * half;
      *reinterpret_cast<float2*>(fs + p * kN + 64 * nh + 8 * nt + 2 * t) =
          make_float2(hacc[nt][2 * half], hacc[nt][2 * half + 1]);
    }
  }
}

}  // namespace

// x, B, C: bf16 row pointers with row strides sx, sb, sc (elements); the
// rest as Args. Launches one block per (prompt, head) on `stream`; returns
// the launch's cudaError_t.
extern "C" int vidil_ssd_chunk_scan(const void* x, const void* B, const void* C, const void* dt,
                                    const void* A, const void* D, const void* prompts, void* y,
                                    void* final_state, long long sx, long long sb, long long sc,
                                    int H, int G, int n_prompts, int device, void* stream) {
  if (H <= 0 || G <= 0 || H % G || n_prompts <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(ssd_scan_chunked, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args args{static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(B),
                  static_cast<const __nv_bfloat16*>(C), static_cast<const float*>(dt),
                  static_cast<const float*>(A), static_cast<const float*>(D),
                  static_cast<const int*>(prompts), static_cast<float*>(y),
                  static_cast<float*>(final_state), sx, sb, sc, H, G};
  ssd_scan_chunked<<<n_prompts * H, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(args);
  return static_cast<int>(cudaGetLastError());
}
