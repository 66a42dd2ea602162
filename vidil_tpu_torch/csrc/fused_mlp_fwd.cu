// Fused transformer MLP forward for Hopper (sm_90a):
//   out = fc2(GELU(fc1(x))) for x (M, D), W1 (D, Dm), W2 (Dm, D).
//
// Replaces the TPU kernel vidil_tpu/ops/fused_mlp.py:_fused_mlp_forward
// (pl.pallas_call at :82, body _mlp_kernel :60) with its rounding points:
//   * both products accumulate in fp32;
//   * b1 is added in fp32 and GELU runs in fp32 on the UNROUNDED sum (K4's
//     epilogue rounds its fc1 output first; this one does not);
//   * GELU's erf is the TPU kernel's A&S 7.1.26 approximation (gelu_as_f);
//   * the activation is rounded once to x's dtype;
//   * b2 is added in fp32, then the result is rounded.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): at the ViT-B/384
// encode of a visual-tokenization chunk (36,928 rows, 768 -> 3072 -> 768) the
// two products are 4*M*D*Dm = 348.5 GFLOP (0.352 ms) against 122.9 MB of x,
// out and weights (0.037 ms), so the call is bound by operations.
//
// Design. The TPU kernel keeps both weight matrices and a row block's
// (rows, 3072) intermediate in VMEM. An SM has 227 KB of shared memory, and
// keeping the intermediate on chip would need a 128 x 768 fp32 accumulator
// per row tile of fc2 (384 KB), more than one SM holds. So this kernel is two
// launches of the shared bf16 GEMM (gemm_sm90.cuh: wgmma from TMA-loaded,
// 128-byte-swizzled tiles in a 3-4 stage mbarrier ring, a producer warp,
// two consumer warpgroups and six epilogue warps, persistent blocks, 16-byte
// epilogue stores): fc1
// with the kEpiGeluF32 epilogue into an (M, Dm) bf16 intermediate the
// wrapper allocates, then fc2 with kEpiStore. The intermediate's round trip
// is 2 * M * Dm * 2 bytes: 100 MB at an ITM block's 8192 rows, ~0.03 ms at
// 3.35 TB/s against the call's 0.078 ms bound, so the call stays bound by
// operations. Rows need no padding: TMA reads rows past M as zeros and the
// epilogue stores none of them. The fp32 instance is the simple 64 x 64 FMA
// tile (fp32 is not the main path's dtype).

#include "fused_vit_block.cuh"

using namespace vit_block;

namespace {

template <typename T>
cudaError_t run(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
                void* act, void* out, int M, int D, int Dm, cudaStream_t s) {
  // act = round(gelu(x . w1 + b1)), GELU on the fp32 sum
  VB_CHECK((gemm1<T, false, true, kEpiGeluF32>(x, D, w1, Dm, b1, nullptr, act, nullptr, Dm, M, Dm,
                                               D, s)));
  // out = round(act . w2 + b2)
  return gemm1<T, false, true, kEpiStore>(act, Dm, w2, D, b2, nullptr, out, nullptr, D, M, D, Dm,
                                          s);
}

}  // namespace

// dtype: 0 = bf16, 1 = fp32 for every tensor. All contiguous: x and out
// (M, D), w1 (D, Dm), b1 (Dm,), w2 (Dm, D), b2 (D,), act (M, Dm) scratch.
// D and Dm must be multiples of 128, the pointers 16-byte aligned; M is any
// positive row count. Returns cudaGetLastError() after the two launches (0
// on success).
extern "C" int vidil_fused_mlp_fwd(const void* x, const void* w1, const void* b1, const void* w2,
                                   const void* b2, void* act, void* out, int dtype, int device,
                                   int M, int D, int Dm, void* stream) {
  if (M <= 0 || D <= 0 || Dm <= 0 || D % 128 || Dm % 128 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = dtype == 0 ? run<bf16>(x, w1, b1, w2, b2, act, out, M, D, Dm, s)
                   : run<float>(x, w1, b1, w2, b2, act, out, M, D, Dm, s);
  return static_cast<int>(err);
}
