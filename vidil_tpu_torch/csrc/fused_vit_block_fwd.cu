// Fused pre-LN ViT block, forward, for Hopper (sm_90a):
//   y = x + proj(MHA(LN1 x));  out = y + fc2(GELU(fc1(LN2 y))).
//
// Replaces the TPU kernel vidil_tpu/ops/fused_vit_block.py:_fused_block_forward
// (body _block_kernel). It computes the same function with the same rounding
// points:
//   * LN1 and LN2 with fp32 statistics, rounded to the input dtype;
//   * each GEMM accumulates in fp32, adds its bias (given in the input dtype)
//     in fp32 and is rounded: qkv, proj, fc1, fc2;
//   * attention per (frame, head): q is not pre-scaled, the fp32 scores are
//     multiplied by 1/sqrt(Dh), keys at or past true_len score -1e30 (only
//     when the token axis is padded), p = e / sum(e) in fp32 rounded before
//     p.v, each head's output rounded;
//   * the residuals x + proj and y + fc2 are added in fp32 and rounded;
//   * GELU (exact erf) runs in fp32 on the rounded fc1 output and is rounded.
//     The TPU kernel's erf is an A&S approximation (max error 1.5e-7).
//
// Design. The TPU kernel runs all of a frame's block in one program with the
// four weight matrices resident in 100 MB of VMEM. An H100 SM has 227 KB of
// shared memory, so here one C call runs a chain of seven launches per layer
// on the caller's stream (fused_vit_block.cuh): LN1, the QKV GEMM, the
// attention, the proj GEMM with the residual epilogue, LN2, the fc1 GEMM with
// the GELU epilogue, the fc2 GEMM with the residual epilogue. The
// intermediates live in a workspace the wrapper allocates.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): at the 224-px
// trainer shape (48 frames, 256 padded tokens, 768 wide) the block does
// 2*12288*768*(4*768 + 2*3072 + 2*256) = 183 GFLOP against ~45 MB of x, out
// and weights, so it is bound by operations (~0.19 ms). Its four products
// (174 GFLOP) run on the wgmma + TMA GEMM of gemm_sm90.cuh, shared with K3
// and K5. The attention (attn_fwd_wgmma) reads q, k and v from the 56.6 MB
// QKV workspace and writes the 18.9 MB output: bound by bytes, ~0.023 ms,
// against 9.7 GFLOP (~0.010 ms). It runs on K1's TMA + wgmma machinery: one
// pass with the whole 256-key score row in registers at Lp <= 256, three
// passes (max, sum, p v) with the scores recomputed at Lp = 640.
// Measured (chip_smoke.py phase 8, one H100 80GB HBM3 at 700 W): the
// attention launch alone takes 0.044 ms of device time at the trainer block
// (SDPA with the key mask 0.053) and 0.228 at (32, 640, 768) (SDPA 0.165);
// the whole chain 0.464 ms of device time at the trainer block (the library
// block 0.477), 0.893 at the 384-px block.
// Left: the LayerNorm rows and the seven launches with every intermediate in
// device memory.

#include "fused_vit_block.cuh"

using namespace vit_block;

namespace {

Dims make_dims(int B, int Lp, int D, int Dm, int H, int true_len, float eps) {
  return Dims{B, Lp, D, Dm, H, true_len, eps};
}

template <typename T>
size_t fwd_workspace(const Dims& d, char* base, FwdBufs<T>* f) {
  Carve c{base, 0};
  FwdBufs<T> bufs = carve_fwd<T>(c, d, false);
  if (f != nullptr) *f = bufs;
  return c.off;
}

template <typename T>
cudaError_t run(const BlockWeights& w, const void* x, void* out, void* ws, const Dims& d,
                cudaStream_t s) {
  FwdBufs<T> f;
  fwd_workspace<T>(d, static_cast<char*>(ws), &f);
  return block_forward<T>(w, static_cast<const T*>(x), static_cast<T*>(out), f, d, s);
}

}  // namespace

// Bytes of workspace the forward needs (-1 for dimensions it does not take).
extern "C" long long vidil_fused_block_fwd_workspace(int dtype, int B, int Lp, int D, int Dm,
                                                     int H) {
  const Dims d = make_dims(B, Lp, D, Dm, H, Lp, 0.f);
  if (!dims_ok(d)) return -1;
  return static_cast<long long>(dtype == 0 ? fwd_workspace<bf16>(d, nullptr, nullptr)
                                           : fwd_workspace<float>(d, nullptr, nullptr));
}

// The block's attention alone (the chain's third launch), on a (B, Lp, 3D)
// QKV workspace: out (B, Lp, D), and with non-null row_max and row_sum the
// (B*H, Lp) fp32 statistics K5's recompute keeps. dtype as below; every
// tensor contiguous. Returns cudaGetLastError() after the launch.
extern "C" int vidil_fused_block_attention(const void* qkv, void* out, float* row_max,
                                           float* row_sum, int dtype, int device, int B, int Lp,
                                           int D, int H, int true_len, void* stream) {
  const Dims d = make_dims(B, Lp, D, 128, H, true_len, 0.f);
  if (!dims_ok(d) || (dtype != 0 && dtype != 1) || (row_max == nullptr) != (row_sum == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const AttnArgs a{qkv, out, row_max, row_sum, H, Lp, D, true_len,
                   1.f / sqrtf(static_cast<float>(kDh))};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = dtype == 0 ? attention_forward<bf16>(a, B, s) : attention_forward<float>(a, B, s);
  return static_cast<int>(err);
}

// dtype: 0 = bf16, 1 = fp32 (x, the linears' weights and biases, out);
// LayerNorm parameters are fp32. Every tensor is contiguous: x and out
// (B, Lp, D), wqkv (D, 3D), wproj (D, D), w1 (D, Dm), w2 (Dm, D). Returns
// cudaGetLastError() after the launches (0 on success).
extern "C" int vidil_fused_block_fwd(const void* x, const float* ln1s, const float* ln1b,
                                     const void* wqkv, const void* bqkv, const void* wproj,
                                     const void* bproj, const float* ln2s, const float* ln2b,
                                     const void* w1, const void* b1, const void* w2,
                                     const void* b2, void* out, void* ws, int dtype, int device,
                                     int B, int Lp, int D, int Dm, int H, int true_len,
                                     float eps, void* stream) {
  const Dims d = make_dims(B, Lp, D, Dm, H, true_len, eps);
  if (!dims_ok(d) || (dtype != 0 && dtype != 1)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const BlockWeights w{ln1s, ln1b, wqkv, bqkv, wproj, bproj, ln2s, ln2b, w1, b1, w2, b2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = dtype == 0 ? run<bf16>(w, x, out, ws, d, s) : run<float>(w, x, out, ws, d, s);
  return static_cast<int>(err);
}
