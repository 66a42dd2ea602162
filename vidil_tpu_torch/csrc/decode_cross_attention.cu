// The decode's cross-attention over a precomputed memory, for Hopper (sm_90a):
//   out = softmax(q k^T / sqrt(Dh)) v
// for G*L query rows that share one memory row, with no mask.
//
// Replaces no TPU kernel: the JAX package leaves this product to XLA. It was
// added because the plain PyTorch path (models/layers.py:grouped_softmax_attention)
// upcasts cross K to fp32, copies the head-split views of K and V contiguous and
// runs a permute, scale, softmax, cast and permute chain around two batched
// products: about 340 MB of traffic a layer and pass for the 57 MB that K and V
// are. It keeps that path's arithmetic and rounding points:
//   * fp32 logits from exact bf16 products, then times 1/sqrt(Dh);
//   * an fp32 softmax over all Lk keys (max, exp, sum, divide), normalised;
//   * the probabilities rounded to v's dtype (probs.to(v.dtype));
//   * the product with V accumulated in fp32, rounded once to the output dtype.
//
// Operands: q and out (B*G, L, H*Dh), contiguous, as the query projection gives
// them and the out projection reads them (query row (b*G + g, l), head h at
// column h*Dh); k and v (B, H, Lk, Dh) with any batch, head and key strides and
// unit stride over Dh: the head-split views of (B, Lk, H*Dh) buffers, read in
// place.
//
// Bound on an H100 SXM (3.35 TB/s HBM): at the CapFilt beam step (B 32 memory
// rows, H 12, G 3 beams, L 1, Lk 577, Dh 64) the call reads 56.7 MB of K and V
// and 0.15 MB of q and writes 0.15 MB: 17.0 us. Its 4*B*H*G*L*Lk*Dh = 170 MFLOP
// are 3 operations a byte, so the card's memory is the only limit, and the
// design moves each byte of K and V once:
//   * one block of 128 threads per (memory row, head) pair and chunk of 4 query
//     rows (384 blocks at CapFilt's step, about three per SM, all resident at
//     once; a prefill's 12 rows take 3 chunks); adjacent blocks take adjacent
//     heads of one memory row;
//   * kLanes = Dh / kVec threads share a key, each loading 16 bytes of it, so a
//     warp reads whole 128-byte lines; 8 keys a thread, double-buffered in
//     registers, keep two batches of loads in flight, and V's first batch is
//     issued before the softmax. With no arithmetic, this mapping moves a
//     step's K and V in 19-20 us on an H100 SXM at 700 W (85 % of the bound);
//   * the arithmetic between the loads has no branch: every block computes all
//     4 rows (a missing row's query is zero), and a key's 4 partial dot
//     products are summed over its 8 threads (Dh 64, bf16) by a transposing
//     reduction: each lane keeps half its values and adds its partner's other
//     half, 4 shuffles where one row at a time takes 12. With a branch per row
//     and 12 shuffles the step took 28.5 us, with these 24.4;
//   * all logits of a block's rows live in shared memory (rows * Lk fp32), so
//     the softmax runs over the whole row in one pass, in the plain path's order
//     of operations: no split-K, no running rescale, no atomics. Every sum runs
//     in a fixed order (lane shuffles, then the warps' partial sums in warp
//     order), so an eager call, a capture and a replay give the same bits;
//   * products on the CUDA cores: at 3 operations a byte, tensor cores buy
//     nothing here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 3;  // blocks an SM keeps resident (the registers' cap)
constexpr int kRows = 4;       // query rows a block owns
constexpr int kUnroll = 8;     // keys a thread loads per batch

__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ void unpack(const float4& u, float (&f)[4]) {
  f[0] = u.x;
  f[1] = u.y;
  f[2] = u.z;
  f[3] = u.w;
}

template <typename T>
struct Vec;
template <>
struct Vec<__nv_bfloat16> {
  using type = uint4;  // 8 bf16
  static constexpr int n = 8;
  __device__ static float get(__nv_bfloat16 x) { return __bfloat162float(x); }
  __device__ static float round(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }
  __device__ static __nv_bfloat16 store(float x) { return __float2bfloat16_rn(x); }
};
template <>
struct Vec<float> {
  using type = float4;
  static constexpr int n = 4;
  __device__ static float get(float x) { return x; }
  __device__ static float round(float x) { return x; }
  __device__ static float store(float x) { return x; }
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  long long k_sb, k_sh, k_sl;  // element strides of k: memory row, head, key
  long long v_sb, v_sh, v_sl;
  int G, L, H, Lk;
  float scale;
};

// The kRows partial dot products of one key, summed over its kLanes threads
// (lanes part = 0 .. kLanes - 1 of a group): at offset o = kLanes/2, kLanes/4,
// ... each lane keeps half of its values, adds its partner's other half, and
// so ends with one row's sum, the row given by the bits of part that were
// tested; the offsets left sum that one value. Returns the sum; *row is its
// row, held alike by the kLanes / kRows lanes that differ below those bits.
template <int kLanes>
__device__ __forceinline__ float reduce_rows(float (&v)[kRows], int part, int* row) {
  static_assert(kLanes >= kRows, "a key's lanes hold every row");
  int r = 0;
#pragma unroll
  for (int n = kRows, o = kLanes / 2; n > 1; n /= 2, o /= 2) {
    const bool upper = part & o;
#pragma unroll
    for (int i = 0; i < n / 2; ++i) {
      const float send = upper ? v[i] : v[i + n / 2];
      const float keep = upper ? v[i + n / 2] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
    r += upper ? n / 2 : 0;
  }
  float s = v[0];
#pragma unroll
  for (int o = kLanes / kRows / 2; o > 0; o /= 2) s += __shfl_xor_sync(0xffffffffu, s, o);
  *row = r;
  return s;
}

// dynamic shared memory, floats: the logits (kRows x Lk), later reused for
// the warps' partial sums (kWarps x kRows x kDh), then the queries
template <int kDh>
__host__ __device__ constexpr size_t smem_floats_before_q(int Lk) {
  return static_cast<size_t>(kRows) * (Lk > kWarps * kDh ? Lk : kWarps * kDh);
}

// grid (B*H, ceil(G*L / kRows))
template <typename T, int kDh>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    decode_cross_attention_kernel(const Params p) {
  using V = Vec<T>;
  using Load = typename V::type;
  constexpr int kVec = V::n;
  constexpr int kLanes = kDh / kVec;         // threads that share a key
  constexpr int kKeysWarp = 32 / kLanes;     // keys a warp loads at once
  constexpr int kKeysStep = kWarps * kKeysWarp;
  constexpr int kKeysBatch = kKeysStep * kUnroll;
  static_assert(kLanes <= 32 && (kLanes & (kLanes - 1)) == 0, "Dh / vec");

  const int H = p.H, Lk = p.Lk, R = p.G * p.L;
  extern __shared__ float smem[];
  float* s_p = smem;    // [kRows][Lk]: logits, then probabilities
  float* s_red = smem;  // [kWarps][kRows][kDh], once the probabilities are read
  float* s_q = smem + smem_floats_before_q<kDh>(Lk);  // [kRows][kDh]

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int row0 = blockIdx.y * kRows;
  const int nrows = min(kRows, R - row0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int sub = lane / kLanes, part = lane % kLanes;
  const int D = H * kDh;

  // query row r of this block: (b*G + g, l) with g*L + l = row0 + r
  auto qrow = [&](int r) -> long long {
    const int gl = row0 + r;
    return ((long long)(b * p.G + gl / p.L) * p.L + gl % p.L) * D + (long long)h * kDh;
  };
  for (int i = threadIdx.x; i < kRows * kDh; i += kThreads) {
    const int r = i / kDh, d = i % kDh;
    s_q[i] = r < nrows ? V::get(static_cast<const T*>(p.q)[qrow(r) + d]) : 0.f;
  }

  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh + part * kVec;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh + part * kVec;
  const int key0 = warp * kKeysWarp + sub;  // this thread's first key of a batch
  auto load = [&](const T* base, long long sl, int batch, Load (&dst)[kUnroll]) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = batch + u * kKeysStep + key0;
      dst[u] = j < Lk ? __ldg(reinterpret_cast<const Load*>(base + j * sl)) : Load{};
    }
  };
  Load cur[kUnroll], nxt[kUnroll];
  load(kb, p.k_sl, 0, cur);
  __syncthreads();
  float qf[kRows][kVec];  // this thread's slice of every row's query
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int e = 0; e < kVec; ++e) qf[r][e] = s_q[r * kDh + part * kVec + e];

  // logits: each thread's 16 bytes of a key against every row's query slice,
  // summed over the key's kLanes threads
  for (int batch = 0; batch < Lk; batch += kKeysBatch) {
    if (batch + kKeysBatch < Lk) load(kb, p.k_sl, batch + kKeysBatch, nxt);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float kf[kVec], dot[kRows];
      unpack(cur[u], kf);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        dot[r] = 0.f;
#pragma unroll
        for (int e = 0; e < kVec; ++e) dot[r] = fmaf(qf[r][e], kf[e], dot[r]);
      }
      int r;
      const float s = reduce_rows<kLanes>(dot, part, &r);
      const int j = batch + u * kKeysStep + key0;
      if (part % (kLanes / kRows) == 0 && j < Lk) s_p[r * Lk + j] = s * p.scale;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) cur[u] = nxt[u];
  }
  load(vb, p.v_sl, 0, cur);  // V's first batch, in flight through the softmax
  __syncthreads();

  // softmax: a warp per row, in the plain path's order (max, exp(x - max),
  // sum, divide), the probabilities rounded to v's dtype; a missing row
  // keeps its zero logits, which the products below ignore
  for (int r = warp; r < nrows; r += kWarps) {
    float* row = s_p + r * Lk;
    float m = -INFINITY;
    for (int j = lane; j < Lk; j += 32) m = fmaxf(m, row[j]);
#pragma unroll
    for (int o = 16; o > 0; o /= 2) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float sum = 0.f;
    for (int j = lane; j < Lk; j += 32) {
      const float e = expf(row[j] - m);
      row[j] = e;
      sum += e;
    }
#pragma unroll
    for (int o = 16; o > 0; o /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    for (int j = lane; j < Lk; j += 32) row[j] = V::round(row[j] / sum);
  }
  __syncthreads();

  // context: each thread's 16 bytes of a V row times every row's probability
  // (keys past Lk load zeros and read a zero probability)
  float acc[kRows][kVec];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[r][e] = 0.f;
  for (int batch = 0; batch < Lk; batch += kKeysBatch) {
    if (batch + kKeysBatch < Lk) load(vb, p.v_sl, batch + kKeysBatch, nxt);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = batch + u * kKeysStep + key0;
      float vf[kVec];
      unpack(cur[u], vf);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float pr = j < Lk ? s_p[r * Lk + j] : 0.f;
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[r][e] = fmaf(pr, vf[e], acc[r][e]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) cur[u] = nxt[u];
  }
  __syncthreads();  // every probability read: s_red takes their place
  // the sums over a warp's keys (lanes of one part), then over the warps
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      float a = acc[r][e];
#pragma unroll
      for (int o = kLanes; o < 32; o *= 2) a += __shfl_xor_sync(0xffffffffu, a, o);
      if (sub == 0) s_red[(warp * kRows + r) * kDh + part * kVec + e] = a;
    }
  }
  __syncthreads();
  T* out = static_cast<T*>(p.out);
  for (int i = threadIdx.x; i < nrows * kDh; i += kThreads) {
    const int r = i / kDh, d = i % kDh;
    float a = s_red[r * kDh + d];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) a += s_red[(w * kRows + r) * kDh + d];
    out[qrow(r) + d] = V::store(a);
  }
}

template <typename T, int kDh>
cudaError_t launch(const Params& p, int B, cudaStream_t s) {
  const size_t smem =
      sizeof(float) * (smem_floats_before_q<kDh>(p.Lk) + static_cast<size_t>(kRows) * kDh);
  auto kernel = decode_cross_attention_kernel<T, kDh>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(B * p.H, (p.G * p.L + kRows - 1) / kRows);
  kernel<<<grid, kThreads, smem, s>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, int B, int Dh, cudaStream_t s) {
  switch (Dh) {
    case 32: return launch<T, 32>(p, B, s);
    case 64: return launch<T, 64>(p, B, s);
    case 128: return launch<T, 128>(p, B, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = bf16, 1 = fp32 for q, k, v and out. q and out contiguous
// (B*G, L, H*Dh); k and v (B, H, Lk, Dh) by their element strides, unit
// stride over Dh. Dh in {32, 64, 128}; pointers and strides 16-byte aligned;
// the block's shared memory, 16 bytes x (max(Lk, 4 Dh) + Dh), at most 227 KB.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int vidil_decode_cross_attention(const void* q, const void* k, const void* v, void* out,
                                            int dtype, int device, int B, int G, int L, int H,
                                            int Lk, int Dh, long long k_sb, long long k_sh,
                                            long long k_sl, long long v_sb, long long v_sh,
                                            long long v_sl, float scale, void* stream) {
  if (B <= 0 || G <= 0 || L <= 0 || H <= 0 || Lk <= 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Params p{q, k, v, out, k_sb, k_sh, k_sl, v_sb, v_sh, v_sl, G, L, H, Lk, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = dtype == 0 ? dispatch<__nv_bfloat16>(p, B, Dh, s) : dispatch<float>(p, B, Dh, s);
  return static_cast<int>(err);
}
