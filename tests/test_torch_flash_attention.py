"""The port's flash-attention forward (vidil_tpu_torch/ops/flash_attention.py)
against the JAX package's Pallas kernel, run in interpret mode on the CPU.

The CUDA kernel itself runs only on a card: its tests are in
tests/test_torch_cuda_kernels.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vidil_tpu.ops.flash_attention import flash_attention as jax_flash
from vidil_tpu_torch.models.layers import dot_product_attention, merge_heads, split_heads
from vidil_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(1)


def _qkv(B, H, Lq, Lk, D, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, Lq, D), dtype=np.float32)
    k = rng.standard_normal((B, H, Lk, D), dtype=np.float32)
    v = rng.standard_normal((B, H, Lk, D), dtype=np.float32)
    return q, k, v


# ragged Lk (not a multiple of 128 or of the kernel's 64-key tile), Lq != Lk,
# and the ViT's 577 tokens at a small batch
SHAPES = [(2, 3, 40, 77, 16), (1, 2, 96, 200, 64), (1, 2, 577, 577, 64)]


@pytest.mark.parametrize("B,H,Lq,Lk,D", SHAPES)
def test_twin_matches_jax_kernel_fp32(B, H, Lq, Lk, D):
    q, k, v = _qkv(B, H, Lq, Lk, D)
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True))
    got = fa.flash_attention_ref(*map(torch.from_numpy, (q, k, v))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("B,H,Lq,Lk,D", SHAPES)
def test_twin_matches_jax_kernel_bf16(B, H, Lq, Lk, D):
    """bf16: both round q·scale and p to bf16 at the same points; what
    remains is fp32 summation order and the final bf16 rounding, so the
    bar is one bf16 ulp at |o| <= 2 (2**-7 = 7.8e-3)."""
    q, k, v = _qkv(B, H, Lq, Lk, D, seed=1)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = np.asarray(jax_flash(jq, jk, jv, interpret=True).astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    got = fa.flash_attention_ref(tq, tk, tv).float().numpy()
    np.testing.assert_allclose(got, want, atol=7.8e-3, rtol=0)


@pytest.mark.parametrize("block_k", [None, *sorted(set(fa.KERNEL_BLOCK_K.values())), 16])
def test_twin_tiling_agrees_fp32(block_k):
    """The online softmax gives the same function at any tile width."""
    q, k, v = _qkv(2, 2, 50, 130, 64, seed=2)
    ref = dot_product_attention(*map(torch.from_numpy, (q, k, v))).numpy()
    got = fa.flash_attention_ref(*map(torch.from_numpy, (q, k, v)), block_k=block_k).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("B,H,Lq,Lk,D", [(1, 2, 577, 577, 64), (1, 2, 96, 577, 64)])
def test_twin_at_kernel_tiles_matches_jax_kernel_bf16(B, H, Lq, Lk, D):
    """The twin walking the bf16 CUDA kernel's key tiles (where its running
    max advances, and so where p is rounded) against the JAX kernel in bf16,
    at the ViT and grouped-ITM shapes: the Hopper tile keeps the TPU
    kernel's rounding within the bar of test_twin_matches_jax_kernel_bf16
    (one bf16 ulp at |o| <= 2, 7.8e-3)."""
    q, k, v = _qkv(B, H, Lq, Lk, D, seed=1)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = np.asarray(jax_flash(jq, jk, jv, interpret=True).astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    got = fa.flash_attention_ref(tq, tk, tv, block_k=fa.KERNEL_BLOCK_K[torch.bfloat16])
    np.testing.assert_allclose(got.float().numpy(), want, atol=7.8e-3, rtol=0)


@pytest.mark.parametrize("Lq,Lk,dtype,want", [
    (577, 577, torch.bfloat16, (5, 5, 65)), (96, 577, torch.bfloat16, (1, 5, 65)),
    (197, 197, torch.bfloat16, (2, 2, 69)), (1, 128, torch.bfloat16, (1, 1, 128)),
    (129, 129, torch.bfloat16, (2, 2, 1)), (577, 577, torch.float32, (10, 10, 1)),
    (64, 64, torch.float32, (1, 1, 64))])
def test_kernel_tiles(Lq, Lk, dtype, want):
    """The forward kernel's query tiles, key tiles and the ragged last key
    tile's real keys (the twin's key tiles at block_k=KERNEL_BLOCK_K)."""
    assert fa.kernel_tiles(Lq, Lk, dtype) == want
    q_tiles, k_tiles, tail = want
    assert (k_tiles - 1) * fa.KERNEL_BLOCK_K[dtype] + tail == Lk
    assert (q_tiles - 1) * fa.KERNEL_BLOCK_M[dtype] < Lq <= q_tiles * fa.KERNEL_BLOCK_M[dtype]


def test_tma_operand_copies_only_expanded_bf16():
    """The bf16 kernel reads through TMA tensor maps, whose strides must be
    non-zero: an expanded bf16 operand is copied out, a strided view is
    passed as it is, and fp32 (read through pointers) is never copied."""
    expanded = torch.zeros((1, 2, 1, 64), dtype=torch.bfloat16).expand(3, 2, 5, 64)
    got = fa._tma_operand(expanded)
    assert got.is_contiguous() and torch.equal(got, expanded)
    view = torch.zeros((3, 2, 6, 64), dtype=torch.bfloat16)[:, :, 1:]
    assert fa._tma_operand(view) is view
    expanded32 = torch.zeros((1, 2, 1, 64)).expand(3, 2, 5, 64)
    assert fa._tma_operand(expanded32) is expanded32


def test_heads_last_empty_is_head_split_of_a_heads_last_allocation():
    o = fa._heads_last_empty(3, 4, 5, 64, torch.zeros(1, dtype=torch.bfloat16))
    want = torch.empty((3, 5, 4, 64), dtype=torch.bfloat16).transpose(1, 2)
    assert (o.shape, o.stride(), o.dtype) == (want.shape, want.stride(), want.dtype)
    assert merge_heads(o).data_ptr() == o.data_ptr()  # a view, not a copy


@pytest.mark.parametrize("with_lse", [False, True])
def test_fwd_args_follow_the_c_entry(with_lse):
    """The forward C entry's arguments: five pointers, dtype code, device,
    B, H, Lq, Lk, D, four (batch, head, seq) stride triples, scale, stream;
    one per argtype that `_kernel_fns` declares."""
    x = torch.zeros((2, 7, 3, 4, 64), dtype=torch.bfloat16)  # a fused-QKV output
    q, k, v = (x[:, :, i].transpose(1, 2) for i in range(3))
    q = q[:, :, :5]
    o = fa._heads_last_empty(2, 4, 5, 64, q)
    lse = torch.empty((2, 4, 5)) if with_lse else None
    args = fa._fwd_args(q, k, v, o, lse, 1234)
    assert len(args) == 5 + 7 + 12 + 2
    assert args[:5] == (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                        lse.data_ptr() if with_lse else None)
    assert args[5:12] == (fa._DTYPE_CODE[torch.bfloat16], None, 2, 4, 5, 7, 64)
    assert args[12:24] == (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3])
    assert args[24:] == (0.125, 1234)


def test_bwd_args_follow_the_c_entry():
    """The backward C entry's arguments: ten pointers (q, k, v, o, g, lse,
    the stats scratch, dq, dk, dv), dtype code, device, B, H, Lq, Lk, D,
    eight (batch, head, seq) stride triples, scale, stream; one per argtype
    that `_kernel_fns` declares."""
    x = torch.zeros((2, 7, 3, 4, 64), dtype=torch.bfloat16)  # a fused-QKV output
    q, k, v = (x[:, :, i].transpose(1, 2) for i in range(3))
    q = q[:, :, :5]
    o = fa._heads_last_empty(2, 4, 5, 64, q)
    g = split_heads(torch.zeros((2, 5, 4 * 64), dtype=torch.bfloat16), 4)
    lse = torch.empty((2, 4, 5))
    stats = fa._bwd_stats_empty(2, 4, 5, q.device)
    dq = fa._heads_last_empty(2, 4, 5, 64, q)
    dk, dv = (fa._heads_last_empty(2, 4, 7, 64, k) for _ in range(2))
    args = fa._bwd_args(q, k, v, o, lse, g, stats, dq, dk, dv, 1234)
    assert len(args) == 10 + 7 + 24 + 2
    assert args[:10] == tuple(t.data_ptr() for t in (q, k, v, o, g, lse, stats, dq, dk, dv))
    assert args[10:17] == (fa._DTYPE_CODE[torch.bfloat16], None, 2, 4, 5, 7, 64)
    assert args[17:41] == tuple(st for t in (q, k, v, o, g, dq, dk, dv) for st in t.stride()[:3])
    assert args[41:] == (0.125, 1234)


@pytest.mark.parametrize("Lq,rows", [(1, 64), (64, 64), (65, 128), (197, 256), (577, 640)])
def test_bwd_stats_scratch_rounds_rows_up_to_the_tile(Lq, rows):
    """The backward's scratch holds a copy of the lse rows and Delta per
    (batch*head), each Lq rounded up to the dk/dv kernel's 64-row q tile
    (its padded rows get lse = +inf: p = 0 there)."""
    stats = fa._bwd_stats_empty(3, 2, Lq, torch.device("cpu"))
    assert stats.shape == (6, 2, rows) and stats.dtype == torch.float32
    assert rows % fa.KERNEL_STATS_ALIGN == 0 and rows - fa.KERNEL_STATS_ALIGN < Lq <= rows


def test_cpu_wrapper_runs_twin_without_counting():
    q, k, v = map(torch.from_numpy, _qkv(1, 2, 33, 70, 64, seed=3))
    fa.reset_launch_counts()
    got = fa.flash_attention(q, k, v)
    torch.testing.assert_close(got, fa.flash_attention_ref(q, k, v), atol=0, rtol=0)
    assert fa.launch_counts["flash_attention_fwd"] == 0


def test_attention_auto_dispatch():
    """Small shapes fail the reference's gate, so unmasked and biased
    calls alike take dot_product_attention, as the JAX package's
    attention_auto does off its kernel."""
    q, k, v = map(torch.from_numpy, _qkv(1, 2, 8, 12, 16, seed=4))
    bias = torch.zeros((1, 1, 8, 12))
    bias[..., -3:] = -10000.0
    torch.testing.assert_close(fa.attention_auto(q, k, v), dot_product_attention(q, k, v),
                               atol=0, rtol=0)
    torch.testing.assert_close(fa.attention_auto(q, k, v, bias=bias),
                               dot_product_attention(q, k, v, bias=bias), atol=0, rtol=0)


# (q shape, k shape, with a bias): the K1 shapes of the port's main paths
# (PERF.md), the reference test's shapes, and the gate's edges
GATE_CASES = {
    "vit_384": ((32, 12, 577, 64), (32, 12, 577, 64), False),
    "itm_fold_96_rows": ((32, 12, 96, 64), (32, 12, 577, 64), False),
    "clip_l_257": ((64, 16, 257, 64), (64, 16, 257, 64), False),
    "blip_vt_fold": ((4, 12, 2048, 64), (4, 12, 577, 64), False),
    "train_224": ((48, 12, 197, 64), (48, 12, 197, 64), False),
    "capfilt_filter_fold_140": ((128, 12, 140, 64), (128, 12, 640, 64), False),
    "decode_step": ((96, 12, 1, 64), (96, 12, 2308, 64), False),
    "lq_127": ((64, 12, 127, 64), (64, 12, 577, 64), False),
    "lq_128": ((64, 12, 128, 64), (64, 12, 577, 64), False),
    "both_axes_511": ((16, 12, 511, 64), (16, 12, 511, 64), False),
    "lq_512": ((16, 12, 512, 64), (16, 12, 511, 64), False),
    "lk_511": ((32, 12, 200, 64), (32, 12, 511, 64), False),
    "lk_512": ((32, 12, 200, 64), (32, 12, 512, 64), False),
    "logits_just_under_128mib": ((8, 16, 512, 64), (8, 16, 511, 64), False),
    "logits_at_128mib": ((8, 16, 512, 64), (8, 16, 512, 64), False),
    "head_dim_256": ((32, 12, 577, 256), (32, 12, 577, 256), False),
    "head_dim_257": ((32, 12, 577, 257), (32, 12, 577, 257), False),
    "bias": ((32, 12, 577, 64), (32, 12, 577, 64), True),
}


@pytest.mark.parametrize("case", list(GATE_CASES))
def test_flash_gate_matches_jax(case):
    """The port's _flash_profitable is the JAX package's, shape by shape
    (shape-only operands: nothing is allocated)."""
    import jax

    from vidil_tpu.ops.flash_attention import _flash_profitable as jax_gate

    qs, ks, with_bias = GATE_CASES[case]
    bias_shape = (1, 1, qs[2], ks[2])
    want = jax_gate(jax.ShapeDtypeStruct(qs, jnp.bfloat16), jax.ShapeDtypeStruct(ks, jnp.bfloat16),
                    jax.ShapeDtypeStruct(bias_shape, jnp.float32) if with_bias else None)
    meta = lambda shape, dt=torch.bfloat16: torch.empty(shape, dtype=dt, device="meta")
    got = fa._flash_profitable(meta(qs), meta(ks),
                               meta(bias_shape, torch.float32) if with_bias else None)
    assert got == want


@pytest.mark.parametrize("case,route", [
    ("train_224", "plain"), ("clip_l_257", "plain"), ("itm_fold_96_rows", "plain"),
    ("vit_384", "flash"), ("blip_vt_fold", "flash")])
def test_attention_auto_routes_main_path_shapes(monkeypatch, case, route):
    """In bf16, the 224-px trainer, CLIP-L and the 96-row ITM fold take
    dot_product_attention; ViT-B/384 and the BLIP rerank fold take
    flash_attention (the kernel on the card)."""
    calls = []
    monkeypatch.setattr(fa, "flash_attention", lambda q, k, v: calls.append("flash"))
    monkeypatch.setattr(fa, "dot_product_attention",
                        lambda q, k, v, bias=None: calls.append("plain"))
    qs, ks, _ = GATE_CASES[case]
    q, k, v = (torch.empty(s, dtype=torch.bfloat16, device="meta") for s in (qs, ks, ks))
    fa.attention_auto(q, k, v)
    assert calls == [route]


def test_strided_views_match_contiguous():
    """The ViT hands the kernel head-split views of one QKV projection, and
    the grouped ITM folds (B*G, H, L, D) into (B, H, G*L, D) by view."""
    rng = np.random.default_rng(5)
    B, G, L, H, Dh = 2, 3, 5, 2, 64
    x = torch.from_numpy(rng.standard_normal((B * G, L, 3 * H * Dh), dtype=np.float32))
    q, k, v = (split_heads(t, H) for t in x.chunk(3, dim=-1))
    got = merge_heads(fa.flash_attention(q, k, v))
    want = merge_heads(fa.flash_attention(q.contiguous(), k.contiguous(), v.contiguous()))
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    qf = q.reshape(B, G, H, L, Dh).transpose(1, 2).reshape(B, H, G * L, Dh)
    assert qf.data_ptr() == q.data_ptr()  # a view, not a copy
    kk, vv = k[::G].contiguous(), v[::G].contiguous()
    torch.testing.assert_close(fa.flash_attention(qf, kk, vv),
                               fa.flash_attention(qf.contiguous(), kk, vv), atol=0, rtol=0)


def test_rejects_mismatched_operands():
    q, k, v = map(torch.from_numpy, _qkv(1, 2, 4, 6, 16))
    with pytest.raises(ValueError):
        fa.flash_attention(q, k[:, :1], v[:, :1])
    with pytest.raises(TypeError):
        fa.flash_attention(q, k.double(), v)


# ---------------------------------------------------------------------------
# training: the forward's lse rows, the backward, the autograd Function
# ---------------------------------------------------------------------------

import jax  # noqa: E402

from vidil_tpu.ops import flash_attention as jfa  # noqa: E402

# the trainer's 197 tokens, the 384-px 577, and a ragged Lq != Lk case
TRAIN_SHAPES = [(1, 2, 197, 197, 64), (1, 2, 577, 577, 64), (1, 2, 130, 150, 64)]


def _g(B, H, Lq, D, seed):
    return np.random.default_rng(seed).standard_normal((B, H, Lq, D), dtype=np.float32)


@pytest.mark.parametrize("B,H,Lq,Lk,D", TRAIN_SHAPES)
def test_twin_lse_matches_jax_forward_with_stats(B, H, Lq, Lk, D):
    """(o, lse) of the twin against _flash_forward(with_stats=True) in
    interpret mode: fp32 at atol 2e-5 (tests/test_flash_attention.py pins
    the same for lse); bf16 o at one bf16 ulp at |o| <= 2 (7.8e-3), bf16 lse
    at 2**-8 (an fp32-order flip of one bf16 p term of the row sum, l >= 1)."""
    q, k, v = _qkv(B, H, Lq, Lk, D, seed=11)
    for jdt, tdt, o_tol, lse_tol in ((jnp.float32, torch.float32, 2e-5, 2e-5),
                                     (jnp.bfloat16, torch.bfloat16, 7.8e-3, 2.0 ** -8)):
        wo, wl = jfa._flash_forward(*(jnp.asarray(x, jdt) for x in (q, k, v)),
                                    interpret=True, with_stats=True)
        go, gl = fa.flash_attention_ref(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
                                        return_lse=True)
        np.testing.assert_allclose(go.float().numpy(), np.asarray(wo.astype(jnp.float32)),
                                   atol=o_tol, rtol=0)
        assert gl.dtype == torch.float32
        np.testing.assert_allclose(gl.numpy(), np.asarray(wl), atol=lse_tol, rtol=0)


@pytest.mark.parametrize("B,H,Lq,Lk,D", TRAIN_SHAPES)
def test_bwd_twin_matches_jax_backward(B, H, Lq, Lk, D):
    """flash_attention_bwd_ref against _flash_backward in interpret mode,
    given the same (o, lse) from the JAX forward. fp32 at atol 2e-5; bf16
    at the bar of tests/test_flash_attention.py (max abs diff / max |ref|
    < 0.02), here held at 1e-2."""
    q, k, v = _qkv(B, H, Lq, Lk, D, seed=12)
    g = _g(B, H, Lq, D, 13)
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        jq, jk, jv, jg = (jnp.asarray(x, jdt) for x in (q, k, v, g))
        o, lse = jfa._flash_forward(jq, jk, jv, interpret=True, with_stats=True)
        want = jfa._flash_backward(jq, jk, jv, o, lse, jg, interpret=True)
        to_t = lambda x: torch.from_numpy(np.array(x.astype(jnp.float32))).to(tdt)
        got = fa.flash_attention_bwd_ref(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
                                         to_t(o), torch.from_numpy(np.asarray(lse)),
                                         torch.from_numpy(g).to(tdt))
        for a, b in zip(got, want):
            assert a.dtype == tdt
            a, b = a.float().numpy(), np.asarray(b.astype(jnp.float32))
            if tdt == torch.float32:
                np.testing.assert_allclose(a, b, atol=2e-5, rtol=0)
            else:
                assert np.abs(a - b).max() / np.abs(b).max() < 1e-2


def _interpret_jax_kernels(monkeypatch):
    """The JAX custom VJP with both Pallas kernels in interpret mode, as
    tests/test_flash_attention.py runs it (patched in this test only)."""
    fwd, bwd = jfa._flash_forward, jfa._flash_backward
    monkeypatch.setattr(jfa, "_flash_forward",
                        lambda q, k, v, interpret=False, with_stats=False:
                            fwd(q, k, v, interpret=True, with_stats=with_stats))
    monkeypatch.setattr(jfa, "_flash_backward", lambda *a, interpret=False: bwd(*a, interpret=True))


@pytest.mark.parametrize("B,H,Lq,Lk,D", [(1, 2, 197, 197, 64), (1, 2, 130, 150, 64)])
def test_function_grads_match_jax_custom_vjp(monkeypatch, B, H, Lq, Lk, D):
    """FlashAttentionFunction's gradients against jax.vjp of the JAX
    package's flash custom VJP, fp32, atol 5e-4 / rtol 1e-4 (the JAX
    test's bar)."""
    _interpret_jax_kernels(monkeypatch)
    q, k, v = _qkv(B, H, Lq, Lk, D, seed=14)
    g = _g(B, H, Lq, D, 15)
    _, vjp = jax.vjp(jfa.flash_attention, *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(g))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = fa.flash_attention(tq, tk, tv)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-4, rtol=1e-4)


def test_flash_attention_is_differentiable_through_the_function():
    """The gradient goes through FlashAttentionFunction (the kernels on
    CUDA, the twins here), not through plain-op autograd: its fp64 gradcheck
    holds, and its q/k/v gradients match dot_product_attention's (atol
    1e-6: that function's logits are fp32)."""
    rng = np.random.default_rng(16)
    q, k, v = (torch.from_numpy(rng.standard_normal(s)).requires_grad_(True)
               for s in ((1, 2, 9, 8), (1, 2, 11, 8), (1, 2, 11, 8)))
    out = fa.flash_attention(q, k, v)
    assert type(out.grad_fn).__name__ == "FlashAttentionFunctionBackward"
    assert torch.autograd.gradcheck(fa.flash_attention, (q, k, v))
    g = torch.from_numpy(rng.standard_normal(out.shape))
    got = torch.autograd.grad(out, (q, k, v), g)
    want = torch.autograd.grad(dot_product_attention(q, k, v), (q, k, v), g)
    for a, b in zip(got, want):
        assert a is not None
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


def test_no_grad_forward_skips_the_lse():
    """Without a gradient to take, the forward is the inference one (no
    lse rows saved, no graph)."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 2, 9, 11, 16, seed=17))
    out = fa.flash_attention(q, k, v)
    assert out.grad_fn is None
    with torch.no_grad():
        out = fa.flash_attention(q.requires_grad_(True), k, v)
    assert out.grad_fn is None


def test_double_backward_raises():
    """The backward kernel records no graph, so a second derivative through
    the Function raises on every device, the CPU twins included, instead
    of coming out silently wrong on CUDA."""
    q, k, v = (torch.from_numpy(x).requires_grad_(True) for x in _qkv(1, 2, 9, 11, 16, seed=18))
    out = fa.flash_attention(q, k, v)
    (dq,) = torch.autograd.grad(out.square().sum(), (q,), create_graph=True)
    assert dq.requires_grad
    with pytest.raises(RuntimeError, match="once_differentiable"):
        dq.sum().backward()
