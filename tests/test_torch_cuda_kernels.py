"""The port's CUDA kernels against their plain twins, on a card.

Marked `cuda`; they skip on a host without CUDA (a CUDA kernel has no CPU
mode). This file imports neither JAX nor vidil_tpu, so it also runs on a
machine that has only the port's dependencies:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from vidil_tpu_torch.models.layers import merge_heads, mlp, split_heads
from vidil_tpu_torch.ops import flash_attention as fa
from vidil_tpu_torch.ops import fused_mlp as fm


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode (chip_smoke.py runs it)")
    return torch.device("cuda")


def _qkv(B, H, Lq, Lk, D, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s, dtype=np.float32)
                 for s in ((B, H, Lq, D), (B, H, Lk, D), (B, H, Lk, D)))


# the bf16 kernel's tile edges (64 rows per consumer warpgroup, 128 per
# block, 128 keys per tile), beside the first shapes
EDGE_LQ = (1, 63, 65, 127, 129, 577)
EDGE_LK = (1, 64, 127, 128, 129, 197, 577)
FWD_SHAPES = [(1, 2, 96, 200, 64), (2, 3, 577, 577, 64), (1, 1, 1, 1, 64), (1, 2, 65, 64, 64)]
FWD_SHAPES += [(1, 2, lq, lk, 64) for lq in EDGE_LQ for lk in EDGE_LK
               if (1, 2, lq, lk, 64) not in FWD_SHAPES]


# (tolerance) kernel vs twin at the kernel's own tiling (KERNEL_BLOCK_K[dtype]
# keys): the fp32 summation order differs, and the bf16 kernel's exp2 differs
# from torch.exp in the last fp32 bits; either can move a bf16 rounding by
# one ulp
@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.bfloat16, 1e-2), (torch.float32, 2e-5)])
@pytest.mark.parametrize("B,H,Lq,Lk,D", FWD_SHAPES)
def test_flash_kernel_matches_twin(cuda_device, dtype, atol, B, H, Lq, Lk, D):
    q, k, v = (torch.from_numpy(x).to(cuda_device, dtype) for x in _qkv(B, H, Lq, Lk, D, 6))
    before = fa.launch_counts["flash_attention_fwd"]
    got = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.launch_counts["flash_attention_fwd"] == before + 1
    want = fa.flash_attention_ref(q, k, v, block_k=fa.KERNEL_BLOCK_K[dtype])
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_kernel_is_deterministic(cuda_device, dtype):
    """No atomics: two forward runs give the same bits, o and lse."""
    q, k, v = (torch.from_numpy(x).to(cuda_device, dtype) for x in _qkv(3, 4, 577, 577, 64, 10))
    first, second = fa._launch(q, k, v, with_lse=True), fa._launch(q, k, v, with_lse=True)
    for a, b in zip(first, second):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    torch.testing.assert_close(fa._launch(q, k, v), fa._launch(q, k, v), atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.bfloat16, 1e-2), (torch.float32, 2e-5)])
def test_flash_kernel_grouped_itm_fold(cuda_device, dtype, atol):
    """The grouped ITM folds G texts' query rows of one frame into one
    (B, H, G*L, D) view (models/med.py:_grouped_attention): the kernel on
    the view gives the bits of a contiguous copy and agrees with the twin."""
    B, G, L, H, Lk = 3, 4, 24, 2, 577
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal((B * G, L, H * 64), dtype=np.float32))
    q = split_heads(x.to(cuda_device, dtype), H)
    qf = q.reshape(B, G, H, L, 64).transpose(1, 2).reshape(B, H, G * L, 64)
    assert qf.data_ptr() == q.data_ptr()  # a view, not a copy
    k, v = (split_heads(torch.from_numpy(rng.standard_normal((B, Lk, H * 64), dtype=np.float32))
                        .to(cuda_device, dtype), H) for _ in range(2))
    got = fa.flash_attention(qf, k, v)
    torch.testing.assert_close(got, fa.flash_attention(qf.contiguous(), k, v), atol=0, rtol=0)
    want = fa.flash_attention_ref(qf, k, v, block_k=fa.KERNEL_BLOCK_K[dtype])
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.bfloat16, 1e-2), (torch.float32, 2e-5)])
@pytest.mark.parametrize("L", [16, 13, 35])
def test_flash_kernel_retrieval_rerank_fold(cuda_device, dtype, atol, L):
    """The retrieval rerank's block (evals/retrieval.py, k_test 64, 8 rows
    of 8 frames at 224 px): 64 texts of L tokens per video fold into a
    (8, 12, 64 L, 64) view over the video's (8, 12, 1576, 64) memory; L 13
    and L 35 (the tokenizer's cap) leave the query axis off the kernel's
    128-row tiles. The gate sends
    the shape to the kernel, which agrees with its twin on the view."""
    B, G, H, Lk = 8, 64, 12, 8 * 197
    rng = np.random.default_rng(12 + L)
    x = torch.from_numpy(rng.standard_normal((B * G, L, H * 64), dtype=np.float32))
    q = split_heads(x.to(cuda_device, dtype), H)
    qf = q.reshape(B, G, H, L, 64).transpose(1, 2).reshape(B, H, G * L, 64)
    k, v = (split_heads(torch.from_numpy(rng.standard_normal((B, Lk, H * 64), dtype=np.float32))
                        .to(cuda_device, dtype), H) for _ in range(2))
    assert fa._flash_profitable(qf, k, None)
    before = fa.launch_counts["flash_attention_fwd"]
    got = fa.attention_auto(qf, k, v)
    torch.cuda.synchronize()
    assert fa.launch_counts["flash_attention_fwd"] == before + 1
    want = fa.flash_attention_ref(qf, k, v, block_k=fa.KERNEL_BLOCK_K[dtype])
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_kernel_strided_views_bitwise(cuda_device, dtype):
    """Head-split views of a fused QKV projection give the same bits as
    contiguous copies."""
    x = torch.randn((3, 70, 3 * 2 * 64), device=cuda_device).to(dtype)
    q, k, v = (split_heads(t, 2) for t in x.chunk(3, dim=-1))
    got = merge_heads(fa.flash_attention(q, k, v))
    want = merge_heads(fa.flash_attention(q.contiguous(), k.contiguous(), v.contiguous()))
    torch.testing.assert_close(got, want, atol=0, rtol=0)


@pytest.mark.cuda
def test_flash_kernel_rejects_what_it_does_not_take(cuda_device):
    q = torch.randn((1, 2, 8, 32), device=cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q, q, q)
    h = q.half()
    with pytest.raises(TypeError, match="bf16 or fp32"):
        fa.flash_attention(h, h, h)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [32, 128])
def test_bf16_kernels_reject_head_dim_other_than_64(cuda_device, D):
    """K1, K2 and the fused block's attention (K4, K5's recompute) take head
    dim 64 only: in bf16 each wrapper raises on another, with no launch."""
    q = torch.randn((1, 2, 130, D), device=cuda_device).to(torch.bfloat16)
    lse = torch.zeros((1, 2, 130), device=cuda_device)
    before = {**fa.launch_counts, **fvb.launch_counts}
    with pytest.raises(ValueError, match="head dim"):
        fa._launch(q, q, q, with_lse=True)
    with pytest.raises(ValueError, match="head dim"):
        fa._launch_bwd(q, q, q, q, lse, q)
    H = 256 // D
    qkv = torch.zeros((1, 128, 3 * 256), device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        fvb._launch_attention(qkv, 100, H, with_stats=True)
    args, _ = _block_args(1, 128, 256, 4, torch.bfloat16, cuda_device, 17)
    with pytest.raises(ValueError, match="head dim"):
        fvb._launch_fwd(args, 100, H, 1e-6)
    assert {**fa.launch_counts, **fvb.launch_counts} == before


def _rel_err(got, want, scale=None):
    """max |got - want| over `scale` (default max |want|), in fp32."""
    want = want.float()
    scale = want.abs().max() if scale is None else scale
    return ((got.float() - want).abs().max() / max(float(scale), 1e-30)).item()


# (tolerance) lse of the kernel vs the twin at the kernel's tiling. fp32:
# summation order of the scores and of the row sum. bf16: an fp32 order
# difference in a score can flip the bf16 rounding of one p term of the
# row sum by one ulp (<= 2**-8, p <= 1), and l >= 1, so lse moves <= 2**-8
LSE_ATOL = {torch.bfloat16: 2.0 ** -8, torch.float32: 1e-5}
# (tolerance) backward kernel vs twin, relative to the largest twin
# gradient of the call: the fp32 sums run in another order, which can move
# the bf16 rounding of ds and of the outputs by one ulp (2**-8 relative);
# fp32 differs in order alone. (Per gradient, a dq that is zero up to
# rounding, as with one key, would make any relative bar meaningless.)
BWD_RTOL = {torch.bfloat16: 1e-2, torch.float32: 1e-5}
LSE_SHAPES = [(1, 2, 96, 200, 64), (4, 3, 197, 197, 64), (1, 2, 65, 64, 64)]
LSE_SHAPES += [(1, 2, lq, lk, 64) for lq in EDGE_LQ for lk in EDGE_LK
               if (1, 2, lq, lk, 64) not in LSE_SHAPES]
# the bf16 kernels' items are 128 rows (q rows in the dq pass, keys in the
# dk/dv pass) over 64-row tiles: (2, 3, 130, 577, 64) is ragged in both
# axes at once (a 2-row q item, a 1-key last tile, a 65-key last item)
BWD_SHAPES = [(2, 3, 197, 197, 64), (1, 2, 577, 577, 64), (1, 2, 65, 130, 64), (1, 1, 1, 1, 64),
              (2, 3, 130, 577, 64), (1, 2, 577, 130, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.bfloat16, 1e-2), (torch.float32, 2e-5)])
@pytest.mark.parametrize("B,H,Lq,Lk,D", LSE_SHAPES)
def test_flash_kernel_lse_matches_twin(cuda_device, dtype, atol, B, H, Lq, Lk, D):
    q, k, v = (torch.from_numpy(x).to(cuda_device, dtype) for x in _qkv(B, H, Lq, Lk, D, 7))
    before = dict(fa.launch_counts)
    o, lse = fa._launch(q, k, v, with_lse=True)
    torch.cuda.synchronize()
    assert fa.launch_counts["flash_attention_fwd_lse"] == before["flash_attention_fwd_lse"] + 1
    assert fa.launch_counts["flash_attention_fwd"] == before["flash_attention_fwd"]
    want_o, want_lse = fa.flash_attention_ref(q, k, v, block_k=fa.KERNEL_BLOCK_K[dtype],
                                              return_lse=True)
    torch.testing.assert_close(o.float(), want_o.float(), atol=atol, rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=LSE_ATOL[dtype], rtol=0)
    # the inference launch gives the same o, bit for bit
    torch.testing.assert_close(fa._launch(q, k, v), o, atol=0, rtol=0)


def _bwd_inputs(B, H, Lq, Lk, D, dtype, device, seed):
    q, k, v = (torch.from_numpy(x).to(device, dtype) for x in _qkv(B, H, Lq, Lk, D, seed))
    g = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal(
        (B, H, Lq, D), dtype=np.float32)).to(device, dtype)
    o, lse = fa.flash_attention_ref(q, k, v, block_k=fa.KERNEL_BLOCK_K[dtype], return_lse=True)
    return q, k, v, o, lse, g


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,H,Lq,Lk,D", BWD_SHAPES)
def test_flash_bwd_kernel_matches_twin(cuda_device, dtype, B, H, Lq, Lk, D):
    q, k, v, o, lse, g = _bwd_inputs(B, H, Lq, Lk, D, dtype, cuda_device, 8)
    before = fa.launch_counts["flash_attention_bwd"]
    got = fa._launch_bwd(q, k, v, o, lse, g)
    torch.cuda.synchronize()
    assert fa.launch_counts["flash_attention_bwd"] == before + 1
    want = fa.flash_attention_bwd_ref(q, k, v, o, lse, g)
    scale = max(float(w.float().abs().max()) for w in want)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert bool(torch.isfinite(a).all()), name
        assert _rel_err(a, b, scale) <= BWD_RTOL[dtype], (name, _rel_err(a, b, scale))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_bwd_kernel_is_deterministic_and_takes_views(cuda_device, dtype):
    """No atomics: two runs give the same bits. q, k, v as head-split views
    of one QKV projection and g as a view of a merge_heads gradient give
    the same bits as contiguous copies."""
    B, L, H = 3, 197, 2
    x = torch.randn((B, L, 3 * H * 64), device=cuda_device).to(dtype)
    q, k, v = (split_heads(t, H) for t in x.chunk(3, dim=-1))
    o, lse = fa._launch(q, k, v, with_lse=True)
    g = split_heads(torch.randn((B, L, H * 64), device=cuda_device).to(dtype), H)
    first = fa._launch_bwd(q, k, v, o, lse, g)
    second = fa._launch_bwd(q, k, v, o, lse, g)
    contiguous = fa._launch_bwd(*(t.contiguous() for t in (q, k, v, o, lse, g)))
    for a, b, c in zip(first, second, contiguous):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
        torch.testing.assert_close(a, c, atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.bfloat16, 0.02), (torch.float32, 1e-4)])
def test_function_grads_match_dot_product_attention(cuda_device, dtype, rtol):
    """The autograd Function on the card: the kernels' gradients against
    autograd through dot_product_attention (tolerance relative to max
    |grad|: fp32 summation order; bf16 as the JAX package's bar for its
    Pallas backward, tests/test_flash_attention.py)."""
    from vidil_tpu_torch.models.layers import dot_product_attention

    q, k, v = (torch.from_numpy(x).to(cuda_device, dtype).requires_grad_(True)
               for x in _qkv(2, 3, 197, 197, 64, 9))
    before = dict(fa.launch_counts)
    out = fa.flash_attention(q, k, v)
    got = torch.autograd.grad(out.float().square().sum(), (q, k, v))
    assert fa.launch_counts["flash_attention_fwd_lse"] == before["flash_attention_fwd_lse"] + 1
    assert fa.launch_counts["flash_attention_bwd"] == before["flash_attention_bwd"] + 1
    ref = dot_product_attention(q, k, v)
    want = torch.autograd.grad(ref.float().square().sum(), (q, k, v))
    for a, b in zip(got, want):
        assert a is not None
        assert _rel_err(a, b) < rtol
    with torch.no_grad():
        fa.flash_attention(q, k, v)
    assert fa.launch_counts["flash_attention_fwd"] == before["flash_attention_fwd"] + 1


# ---------------------------------------------------------------------------
# the fused ViT block: K4 (forward) and K5 (backward) against their twins
# ---------------------------------------------------------------------------

from vidil_tpu_torch.ops import fused_vit_block as fvb  # noqa: E402

# (tolerance) K4 vs its twin, max abs error over max |out|: the fp32 sums
# (GEMM depth, LayerNorm, softmax) run in another order and erff/expf/rsqrtf
# differ from torch's by an ulp or two, which can flip the bf16 rounding of
# an intermediate (qkv, p, a head's output, fc1, GELU) by one ulp; the
# flipped values reach the output through the next product, a few ulps of
# max |out| (2**-8 each). fp32 differs in order and last bits alone.
FWD_RTOL = {torch.bfloat16: 2.0 ** -6, torch.float32: 1e-5}
# (tolerance) K5 vs its twin, per gradient, max abs error over that
# gradient's max |twin|: as for K4, plus the roundings of dhh, dy, do, dsb
# and dqkv that feed the weight-gradient sums over all rows.
BLOCK_BWD_RTOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# (B, Lp, D, H, true_len): a padded 197-token axis, an unpadded one, 577 -> 640,
# and a ragged 128-token axis (one key chunk of the attention)
BLOCK_SHAPES = [(2, 256, 128, 2, 197), (3, 128, 256, 4, 128), (1, 640, 128, 2, 577),
                (2, 128, 128, 2, 100)]


def _block_args(B, Lp, D, H, dtype, device, seed):
    """x and the block's 12 parameters (linears in `dtype`, LayerNorm fp32),
    and an output gradient that is zero on the pad rows."""
    rng = np.random.default_rng(seed)
    Dm = 4 * D

    def t(shape, scale, shift=0.0, dt=dtype):
        a = rng.standard_normal(shape, dtype=np.float32) * scale + shift
        return torch.from_numpy(a).to(device, dt)

    args = (t((B, Lp, D), 1.0),
            t((D,), 0.1, 1.0, torch.float32), t((D,), 0.05, 0.0, torch.float32),
            t((D, 3 * D), D ** -0.5), t((3 * D,), 0.02),
            t((D, D), D ** -0.5), t((D,), 0.02),
            t((D,), 0.1, 1.0, torch.float32), t((D,), 0.05, 0.0, torch.float32),
            t((D, Dm), D ** -0.5), t((Dm,), 0.02),
            t((Dm, D), Dm ** -0.5), t((D,), 0.02))
    return args, t((B, Lp, D), 1.0)


# (tolerance) the block's attention launch vs its twin. out: a flip of the
# bf16 rounding of one p (the fp32 sums run in another order) moves it by at
# most 2**-7 p |v|, at most 2**-7 max |v| over a row's flips (p sums to 1),
# and the output's own rounding one ulp more: 2**-6 max |v| in bf16; fp32
# differs in order alone. Row max: the fp32 sum of 64 products in another
# order, a few ulps of sum |q k| / 8; row sum: that in each exp plus the
# order of up to 640 terms (and the fp32 kernel's running rescale)
ATTN_OUT_TOL = {torch.bfloat16: 2.0 ** -6, torch.float32: 1e-5}
ATTN_MAX_ATOL, ATTN_SUM_RTOL = 1e-4, 2e-4
# (B, Lp, D, H, true_len): one 128-key chunk, the trainers' one-pass 256, the
# three-pass 640, each with a ragged true_len; the unpadded 256
ATTN_SHAPES = [(3, 128, 128, 2, 100), (2, 256, 256, 4, 197), (1, 640, 128, 2, 577),
               (2, 256, 128, 2, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("with_stats", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,Lp,D,H,true_len", ATTN_SHAPES)
def test_fused_block_attention_matches_twin(cuda_device, dtype, with_stats, B, Lp, D, H,
                                            true_len):
    """The attention launch of K4 (and, with statistics, of K5's recompute)
    alone on a QKV workspace: its twin's output and statistics, bitwise
    run to run."""
    rng = np.random.default_rng(18)
    qkv = torch.from_numpy(rng.standard_normal((B, Lp, 3 * D), dtype=np.float32)).to(
        cuda_device, dtype)
    before = fvb.launch_counts["fused_vit_block_attention"]
    got = fvb._launch_attention(qkv, true_len, H, with_stats=with_stats)
    again = fvb._launch_attention(qkv, true_len, H, with_stats=with_stats)
    torch.cuda.synchronize()
    assert fvb.launch_counts["fused_vit_block_attention"] == before + 2
    want = fvb.block_attention_ref(qkv, true_len=true_len, num_heads=H, with_stats=with_stats)
    if not with_stats:
        got, again, want = (got,), (again,), (want,)
    for a, b in zip(got, again):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    out, ref = got[0], want[0]
    assert out.shape == (B, Lp, D) and out.dtype == dtype and bool(torch.isfinite(out).all())
    v_max = qkv[..., 2 * D:].float().abs().max().item()
    assert (out.float() - ref.float()).abs().max().item() <= ATTN_OUT_TOL[dtype] * v_max
    if with_stats:
        torch.testing.assert_close(got[1], want[1], atol=ATTN_MAX_ATOL, rtol=0)
        torch.testing.assert_close(got[2], want[2], atol=0, rtol=ATTN_SUM_RTOL)


# (tolerance) K5's attention backward alone vs its twin, per part (dq, dk,
# dv; dbqkv), max abs error over that part's max |twin|: both round at the
# same points (p for p^T do, dsb, the output); the fp32 sums run in another
# order, which can flip the output's one rounding (2**-8 of an element) and,
# rarely, a rounding of p or dsb (2**-8 of one product term): 2**-7 in
# bf16; fp32 order alone, 1e-5. D is formed in fp32 from fp32 p and dp in
# both dtypes: 1e-5.
ATTN_BWD_TOL = {torch.bfloat16: 2.0 ** -7, torch.float32: 1e-5}
ATTN_BWD_DELTA_TOL = 1e-5
# (B, Lp, D, H, true_len): a key item wholly past true_len (100 of 256), a
# last 128-key tile holding one key (257 of 384), the trainers' 197 of 256,
# the unpadded 256, the 384-px 577 of 640
ATTN_BWD_SHAPES = [(2, 256, 128, 2, 100), (2, 384, 256, 4, 257), (3, 256, 256, 4, 197),
                   (2, 256, 128, 2, 256), (1, 640, 128, 2, 577)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,Lp,D,H,true_len", ATTN_BWD_SHAPES)
def test_fused_block_attention_bwd_matches_twin(cuda_device, dtype, B, Lp, D, H, true_len):
    """K5's attention backward alone (its dq and dk/dv passes with dbqkv) on
    K4's statistics: its twin's dqkv, D and dbqkv, bitwise run to run, and
    exact zeros at the masked keys' dk and dv."""
    rng = np.random.default_rng(19)
    qkv = torch.from_numpy(rng.standard_normal((B, Lp, 3 * D), dtype=np.float32)).to(
        cuda_device, dtype)
    do = torch.from_numpy(rng.standard_normal((B, Lp, D), dtype=np.float32) * 0.1).to(
        cuda_device, dtype)
    _, row_max, row_sum = fvb._launch_attention(qkv, true_len, H, with_stats=True)
    before = fvb.launch_counts["fused_vit_block_attention_bwd"]
    got = fvb._launch_attention_bwd(qkv, do, row_max, row_sum, true_len, H)
    again = fvb._launch_attention_bwd(qkv, do, row_max, row_sum, true_len, H)
    torch.cuda.synchronize()
    assert fvb.launch_counts["fused_vit_block_attention_bwd"] == before + 2
    for a, b in zip(got, again):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    want = fvb.block_attention_bwd_ref(qkv, do, row_max, row_sum, true_len=true_len,
                                       num_heads=H)
    dqkv = got[0]
    assert dqkv.shape == (B, Lp, 3 * D) and dqkv.dtype == dtype
    assert bool(torch.isfinite(dqkv).all())
    for i in range(3):
        part = slice(i * D, (i + 1) * D)
        assert _rel_err(dqkv[..., part], want[0][..., part]) <= ATTN_BWD_TOL[dtype], i
    assert _rel_err(got[2], want[2]) <= ATTN_BWD_TOL[dtype]
    assert _rel_err(got[1], want[1]) <= ATTN_BWD_DELTA_TOL
    assert not dqkv[:, true_len:, D:].float().any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,Lp,D,H,true_len", BLOCK_SHAPES)
def test_fused_block_fwd_kernel_matches_twin(cuda_device, dtype, B, Lp, D, H, true_len):
    args, _ = _block_args(B, Lp, D, H, dtype, cuda_device, 11)
    before = fvb.launch_counts["fused_vit_block_fwd"]
    got = fvb._launch_fwd(args, true_len, H, 1e-6)
    torch.cuda.synchronize()
    assert fvb.launch_counts["fused_vit_block_fwd"] == before + 1
    want = fvb.fused_block_ref(*args, true_len=true_len, num_heads=H, eps=1e-6)
    assert got.dtype == dtype and got.shape == want.shape
    assert bool(torch.isfinite(got).all())  # pad rows included
    assert _rel_err(got, want) <= FWD_RTOL[dtype], _rel_err(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,Lp,D,H,true_len", BLOCK_SHAPES)
def test_fused_block_bwd_kernel_matches_twin(cuda_device, dtype, B, Lp, D, H, true_len):
    args, g = _block_args(B, Lp, D, H, dtype, cuda_device, 12)
    g[:, true_len:] = 0  # the sliced-off pad rows get no gradient
    before = fvb.launch_counts["fused_vit_block_bwd"]
    got = fvb._launch_bwd(args, g, true_len, H, 1e-6)
    torch.cuda.synchronize()
    assert fvb.launch_counts["fused_vit_block_bwd"] == before + 1
    want = fvb.fused_block_bwd_ref(*args, g, true_len=true_len, num_heads=H, eps=1e-6)
    names = ("dx", "dln1s", "dln1b", "dwqkv", "dbqkv", "dwproj", "dbproj", "dln2s", "dln2b",
             "dw1", "db1", "dw2", "db2")
    errs = {}
    for name, a, b in zip(names, got, want):
        assert a.shape == b.shape, name
        assert bool(torch.isfinite(a).all()), name
        errs[name] = _rel_err(a, b)
    assert max(errs.values()) <= BLOCK_BWD_RTOL[dtype], errs


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fused_block_bwd_kernel_is_deterministic(cuda_device, dtype):
    """Fixed-order reductions, no atomics: two runs give the same bits."""
    args, g = _block_args(2, 256, 256, 4, dtype, cuda_device, 13)
    first = fvb._launch_bwd(args, g, 197, 4, 1e-6)
    second = fvb._launch_bwd(args, g, 197, 4, 1e-6)
    for a, b in zip(first, second):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


# the trainers' ViT-B/16 block at 224 px: D / Dm / 3D = 768 / 3072 / 2304, so
# the GEMM runs in all three operand layouts (x.W, g.W^T, A^T.B) with all
# five epilogues of K4 and K5
TRAINER_BLOCK = (48, 256, 768, 12, 197)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fused_block_kernels_at_the_trainer_block(cuda_device, dtype):
    """K4 and K5 at the trainer block against their twins, each bitwise
    equal run to run."""
    B, Lp, D, H, true_len = TRAINER_BLOCK
    args, g = _block_args(B, Lp, D, H, dtype, cuda_device, 15)
    g[:, true_len:] = 0
    out = fvb._launch_fwd(args, true_len, H, 1e-6)
    torch.testing.assert_close(out, fvb._launch_fwd(args, true_len, H, 1e-6), atol=0, rtol=0)
    want = fvb.fused_block_ref(*args, true_len=true_len, num_heads=H, eps=1e-6)
    assert _rel_err(out, want) <= FWD_RTOL[dtype], _rel_err(out, want)
    got = fvb._launch_bwd(args, g, true_len, H, 1e-6)
    for a, b in zip(got, fvb._launch_bwd(args, g, true_len, H, 1e-6)):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    want = fvb.fused_block_bwd_ref(*args, g, true_len=true_len, num_heads=H, eps=1e-6)
    errs = [_rel_err(a, b) for a, b in zip(got, want)]
    assert max(errs) <= BLOCK_BWD_RTOL[dtype], errs


@pytest.mark.cuda
@pytest.mark.parametrize("B,Lp,splits", [(48, 256, "some > 1"), (1, 128, "all 1")])
def test_fused_block_bwd_weight_grad_splits(cuda_device, B, Lp, splits):
    """K5 in bf16 at a row count whose weight gradients are summed from
    several split-K partials (12,288 rows) and at one where each is a
    single product (128 rows): the twin's gradients either way, bitwise run
    to run."""
    _, _, D, H, _ = TRAINER_BLOCK
    counts = fvb.weight_grad_splits(torch.bfloat16, B, Lp, D, 4 * D, H)
    assert (max(counts) > 1) if splits == "some > 1" else (max(counts) == 1), counts
    true_len = min(Lp, 197)
    args, g = _block_args(B, Lp, D, H, torch.bfloat16, cuda_device, 16)
    g[:, true_len:] = 0
    got = fvb._launch_bwd(args, g, true_len, H, 1e-6)
    for a, b in zip(got, fvb._launch_bwd(args, g, true_len, H, 1e-6)):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    want = fvb.fused_block_bwd_ref(*args, g, true_len=true_len, num_heads=H, eps=1e-6)
    errs = [_rel_err(a, b) for a, b in zip(got, want)]
    assert max(errs) <= BLOCK_BWD_RTOL[torch.bfloat16], errs


@pytest.mark.cuda
def test_fused_vit_block_function_on_the_card(cuda_device):
    """fused_vit_block on CUDA: one K4 launch forward, one K5 launch
    backward with pallas_bwd, none with the autograd recompute; the two
    backward strategies agree within the JAX package's bar for its two bf16
    backward strategies (0.06 of max |dx|, tests/test_fused_vit_block.py)."""
    args, g = _block_args(2, 256, 128, 2, torch.bfloat16, cuda_device, 14)
    g[:, 197:] = 0
    params = {"norm1": {"scale": args[1], "bias": args[2]},
              "attn": {"qkv": {"kernel": args[3], "bias": args[4]},
                       "proj": {"kernel": args[5], "bias": args[6]}},
              "norm2": {"scale": args[7], "bias": args[8]},
              "mlp": {"fc1": {"kernel": args[9], "bias": args[10]},
                      "fc2": {"kernel": args[11], "bias": args[12]}}}
    grads = []
    for pallas_bwd in (True, False):
        x = args[0].clone().requires_grad_(True)
        before = dict(fvb.launch_counts)
        out = fvb.fused_vit_block(params, x, 2, 1e-6, 197, pallas_bwd=pallas_bwd)
        (dx,) = torch.autograd.grad(out, x, g)
        assert fvb.launch_counts["fused_vit_block_fwd"] == before["fused_vit_block_fwd"] + 1
        assert (fvb.launch_counts["fused_vit_block_bwd"]
                == before["fused_vit_block_bwd"] + int(pallas_bwd))
        grads.append(dx)
    assert _rel_err(grads[0], grads[1]) <= 0.06


# ---------------------------------------------------------------------------
# the fused MLP (K3)
# ---------------------------------------------------------------------------

# (tolerance) K3 vs its plain version on the same rounding points. bf16: the
# fp32 sums run in another order and erff/expf differ from torch's by an
# ulp, which can flip the rounding of an activation (moving an output by
# |w2| times its ulp) or of an output: 1e-2 of max |out|. fp32: order only.
MLP_BAR = {torch.bfloat16: 1e-2, torch.float32: 3e-5}


def _mlp_args(shape, D, Dm, dtype, device, seed):
    rng = np.random.default_rng(seed)

    def t(s, scale):
        return torch.from_numpy(rng.standard_normal(s, dtype=np.float32) * scale).to(device, dtype)

    return (t(shape, 1.0), t((D, Dm), D ** -0.5), t((Dm,), 0.02), t((Dm, D), Dm ** -0.5),
            t((D,), 0.02))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,D,Dm", [((300, 256), 256, 512), ((3, 100, 128), 128, 512),
                                        ((2048, 768), 768, 3072)])
def test_fused_mlp_kernel_matches_plain_version(cuda_device, dtype, shape, D, Dm):
    """Row counts that are and are not multiples of the kernel's 128-row
    tile (the kernel masks the ragged tile), leading dims kept; run to run
    bitwise."""
    args = _mlp_args(shape, D, Dm, dtype, cuda_device, 21)
    before = fm.launch_counts["fused_mlp_fwd"]
    got = fm._launch(*args)
    again = fm._launch(*args)
    torch.cuda.synchronize()
    assert fm.launch_counts["fused_mlp_fwd"] == before + 2
    want = fm.fused_mlp_ref(*args)
    assert got.shape == want.shape == args[0].shape and got.dtype == dtype
    torch.testing.assert_close(got, again, atol=0, rtol=0)
    err = (got.float() - want.float()).abs().max().item()
    limit = MLP_BAR[dtype] * (want.float().abs().max().item() if dtype == torch.bfloat16 else 1)
    assert err <= limit, (err, limit)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows", [300, 36928])
def test_fused_mlp_kernel_ragged_rows(cuda_device, dtype, rows):
    """K3 at ViT-B widths (768 -> 3072) on row counts that leave a ragged
    last 128-row tile (the BLIP encode of a chunk has 36,928 rows), with no
    row padding in device memory: the plain version's result, bitwise run
    to run."""
    args = _mlp_args((rows, 768), 768, 3072, dtype, cuda_device, 24)
    got = fm._launch(*args)
    torch.testing.assert_close(got, fm._launch(*args), atol=0, rtol=0)
    want = fm.fused_mlp_ref(*args)
    assert got.shape == (rows, 768)
    err = (got.float() - want.float()).abs().max().item()
    limit = MLP_BAR[dtype] * (want.float().abs().max().item() if dtype == torch.bfloat16 else 1)
    assert err <= limit, (err, limit)


@pytest.mark.cuda
def test_fused_mlp_function_grads_on_the_card(cuda_device):
    """fused_mlp on CUDA: one K3 launch forward; the gradient is autograd
    through the plain mlp, so it equals autograd of layers.mlp (fp32)."""
    args = _mlp_args((2, 150, 256), 256, 1024, torch.float32, cuda_device, 22)
    g = torch.randn(args[0].shape, device=cuda_device)
    leaves = [a.clone().requires_grad_(True) for a in args]
    params = {"fc1": {"kernel": leaves[1], "bias": leaves[2]},
              "fc2": {"kernel": leaves[3], "bias": leaves[4]}}
    before = fm.launch_counts["fused_mlp_fwd"]
    got = torch.autograd.grad(fm.fused_mlp(params, leaves[0]), leaves, g)
    assert fm.launch_counts["fused_mlp_fwd"] == before + 1
    want = torch.autograd.grad(mlp(params, leaves[0]), leaves, g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
def test_fused_mlp_kernel_rejects_what_it_does_not_take(cuda_device):
    args = _mlp_args((4, 96), 96, 384, torch.float32, cuda_device, 23)
    with pytest.raises(ValueError, match="multiples of 128"):
        fm._launch(*args)
    args = _mlp_args((4, 128), 128, 512, torch.float16, cuda_device, 23)
    with pytest.raises(TypeError, match="bf16 or fp32"):
        fm._launch(*args)


# ---------------------------------------------------------------------------
# the decode's variants and the on-device resize (no kernel of their own:
# plain torch ops, held on the card to their exact or CPU results)
# ---------------------------------------------------------------------------

def _tiny_decoder(device):
    """A two-layer MED decoder with the LM head, 128 wide (2 heads of 64),
    sin-fill weights on `device`."""
    from vidil_tpu_torch.config import MedConfig
    from vidil_tpu_torch.models import blip, convert
    from vidil_tpu_torch.utils.synth import synth_tree

    cfg = MedConfig(vocab_size=300, hidden_size=128, num_layers=2, num_heads=2,
                    intermediate_size=256, max_position_embeddings=64, encoder_width=128)
    params = convert.from_jax_params(synth_tree(blip.med_shapes(cfg, with_lm_head=True), device,
                                                salt=5.0, amplitude=0.2))
    return {"text_decoder": params}, cfg


@pytest.mark.cuda
@pytest.mark.parametrize("native", [(240, 320), (480, 640)])
def test_resize_on_the_card_matches_the_cpu(cuda_device, native):
    """resize_on_device's resize on the card against the same function on
    the CPU: the sums run in another order, so a uint8 rounding tie may
    flip by one level, and only that."""
    from vidil_tpu_torch.ops import image

    g = torch.Generator().manual_seed(native[0])
    frames = torch.randint(0, 256, (4,) + native + (3,), generator=g, dtype=torch.uint8)
    want = image.resize_bicubic_uint8(frames, 384)
    got = image.resize_bicubic_uint8(frames.to(cuda_device), 384).cpu()
    diff = (got - want).abs()
    assert diff.max().item() <= 1
    assert (diff > 0).sum().item() <= 1e-4 * diff.numel()


@pytest.mark.cuda
def test_sampling_on_the_card_follows_its_generator(cuda_device):
    from vidil_tpu_torch.models import blip
    from vidil_tpu_torch.ops.generation import GenerationConfig

    params, cfg = _tiny_decoder(cuda_device)
    embeds = torch.randn(6, 40, 128, generator=torch.Generator().manual_seed(1)).to(cuda_device)
    prompt = torch.tensor([[30, 5, 6, 7]] * 6, dtype=torch.int32, device=cuda_device)
    gen = GenerationConfig(max_length=16, min_length=5, num_beams=1, eos_token_id=13,
                           pad_token_id=0, repetition_penalty=1.1, top_p=0.9)

    def run(seed):
        g = torch.Generator(device=cuda_device).manual_seed(seed)
        return blip.blip_generate_ids(params, embeds, prompt, cfg, gen, sample=True,
                                      generator=g).cpu()

    a, b, c = run(0), run(0), run(1)
    assert torch.equal(a, b) and not torch.equal(a[:, 4:], c[:, 4:])
    assert torch.equal(a[:, :4], prompt.cpu())


@pytest.mark.cuda
def test_decode_structure_variants_are_token_identical_on_the_card(cuda_device):
    """decode_layer_unroll and decode_lazy_reorder, each and both, give the
    stock beam decode's tokens in fp32 on the card (the same products on
    the same values)."""
    from vidil_tpu_torch.models import blip
    from vidil_tpu_torch.ops.generation import GenerationConfig

    params, cfg = _tiny_decoder(cuda_device)
    embeds = torch.randn(4, 40, 128, generator=torch.Generator().manual_seed(2)).to(cuda_device)
    prompt = torch.tensor([[30, 5, 6, 7]] * 4, dtype=torch.int32, device=cuda_device)
    gen = GenerationConfig(max_length=16, min_length=5, num_beams=3, eos_token_id=13,
                           pad_token_id=0)
    kw = dict(beam_group_kv=True)
    stock = blip.blip_generate_ids(params, embeds, prompt, cfg, gen, **kw)
    for flags in (dict(decode_layer_unroll=True), dict(decode_lazy_reorder=True),
                  dict(decode_layer_unroll=True, decode_lazy_reorder=True)):
        got = blip.blip_generate_ids(params, embeds, prompt, cfg, gen, **kw, **flags)
        assert torch.equal(got, stock), flags
