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


# (tolerance) kernel vs twin at the kernel's own 64-key tiling: only the
# fp32 summation order differs, which can move a bf16 rounding by one ulp
@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.bfloat16, 1e-2), (torch.float32, 2e-5)])
@pytest.mark.parametrize("B,H,Lq,Lk,D", [(1, 2, 96, 200, 64), (2, 3, 577, 577, 64),
                                         (1, 1, 1, 1, 64), (1, 2, 65, 64, 64)])
def test_flash_kernel_matches_twin(cuda_device, dtype, atol, B, H, Lq, Lk, D):
    q, k, v = (torch.from_numpy(x).to(cuda_device, dtype) for x in _qkv(B, H, Lq, Lk, D, 6))
    before = fa.launch_counts["flash_attention_fwd"]
    got = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.launch_counts["flash_attention_fwd"] == before + 1
    want = fa.flash_attention_ref(q, k, v, block_k=fa.KERNEL_BLOCK_K)
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
BWD_SHAPES = [(2, 3, 197, 197, 64), (1, 2, 577, 577, 64), (1, 2, 65, 130, 64), (1, 1, 1, 1, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.bfloat16, 1e-2), (torch.float32, 2e-5)])
@pytest.mark.parametrize("B,H,Lq,Lk,D", [(1, 2, 96, 200, 64), (4, 3, 197, 197, 64),
                                         (1, 2, 65, 64, 64)])
def test_flash_kernel_lse_matches_twin(cuda_device, dtype, atol, B, H, Lq, Lk, D):
    q, k, v = (torch.from_numpy(x).to(cuda_device, dtype) for x in _qkv(B, H, Lq, Lk, D, 7))
    before = dict(fa.launch_counts)
    o, lse = fa._launch(q, k, v, with_lse=True)
    torch.cuda.synchronize()
    assert fa.launch_counts["flash_attention_fwd_lse"] == before["flash_attention_fwd_lse"] + 1
    assert fa.launch_counts["flash_attention_fwd"] == before["flash_attention_fwd"]
    want_o, want_lse = fa.flash_attention_ref(q, k, v, block_k=fa.KERNEL_BLOCK_K, return_lse=True)
    torch.testing.assert_close(o.float(), want_o.float(), atol=atol, rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=LSE_ATOL[dtype], rtol=0)
    # the inference launch gives the same o, bit for bit
    torch.testing.assert_close(fa._launch(q, k, v), o, atol=0, rtol=0)


def _bwd_inputs(B, H, Lq, Lk, D, dtype, device, seed):
    q, k, v = (torch.from_numpy(x).to(device, dtype) for x in _qkv(B, H, Lq, Lk, D, seed))
    g = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal(
        (B, H, Lq, D), dtype=np.float32)).to(device, dtype)
    o, lse = fa.flash_attention_ref(q, k, v, block_k=fa.KERNEL_BLOCK_K, return_lse=True)
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
# (B, Lp, D, H, true_len): a padded 197-token axis, an unpadded one, 577 -> 640
BLOCK_SHAPES = [(2, 256, 128, 2, 197), (3, 128, 256, 4, 128), (1, 640, 128, 2, 577)]


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
    tile (the wrapper pads), leading dims kept; run to run bitwise."""
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
