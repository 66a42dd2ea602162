"""The port's fused ViT block (vidil_tpu_torch.ops.fused_vit_block) and the
fused schedule of its vit_forward against the JAX package's, on the CPU.

The JAX kernels run in interpret mode (their own CPU tests' way); the
port's Function runs its plain twins on CPU tensors. Inputs come from
numpy seeds and go through both packages. Widths are small (128-256, two
to four heads of 64). Each test states its tolerance.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vidil_tpu.config import MedConfig as JMed, ViTConfig as JViT
from vidil_tpu.models.vit import init_block, init_vit, vit_forward as j_vit_forward
from vidil_tpu.ops import fused_vit_block as J
from vidil_tpu.train.common import training_cfgs as j_training_cfgs
from vidil_tpu_torch.config import MedConfig, ViTConfig
from vidil_tpu_torch.models import convert, vit
from vidil_tpu_torch.ops import fused_vit_block as F
from vidil_tpu_torch.train.common import training_cfgs

torch.set_num_threads(1)

EPS = 1e-6
GRAD_NAMES = ("dln1s", "dln1b", "dwqkv", "dbqkv", "dwproj", "dbproj", "dln2s", "dln2b",
              "dw1", "db1", "dw2", "db2")


def _block(D, seed):
    """JAX block params (numpy) with LayerNorm parameters away from 1 and 0
    and non-zero biases, so that every gradient is exercised."""
    p = jax.tree.map(np.asarray, init_block(jax.random.PRNGKey(seed), D, 4 * D))
    rng = np.random.default_rng(seed)
    for ln in ("norm1", "norm2"):
        p[ln] = {"scale": (1 + 0.1 * rng.standard_normal(D)).astype(np.float32),
                 "bias": (0.05 * rng.standard_normal(D)).astype(np.float32)}
    for lin in (p["attn"]["qkv"], p["attn"]["proj"], p["mlp"]["fc1"], p["mlp"]["fc2"]):
        lin["bias"] = (0.02 * rng.standard_normal(lin["bias"].shape)).astype(np.float32)
    return p


def _flat(p, dtype=None):
    """(ln1s, ln1b, wqkv, bqkv, wproj, bproj, ln2s, ln2b, w1, b1, w2, b2) as
    numpy, the linears cast to `dtype` as fused_vit_block casts them."""
    cast = (lambda a: a) if dtype is None else (lambda a: np.asarray(jnp.asarray(a, dtype)))
    a, m = p["attn"], p["mlp"]
    return (p["norm1"]["scale"], p["norm1"]["bias"],
            cast(a["qkv"]["kernel"]), cast(a["qkv"]["bias"]),
            cast(a["proj"]["kernel"]), cast(a["proj"]["bias"]),
            p["norm2"]["scale"], p["norm2"]["bias"],
            cast(m["fc1"]["kernel"]), cast(m["fc1"]["bias"]),
            cast(m["fc2"]["kernel"]), cast(m["fc2"]["bias"]))


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(np.asarray(a, np.float32)))
    return t if dtype is None else t.to(dtype)


def _x(B, L, D, seed):
    lp = (L + 127) // 128 * 128
    x = np.zeros((B, lp, D), np.float32)
    x[:, :L] = np.random.default_rng(seed).standard_normal((B, L, D)) * 0.5
    return x, lp


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


SHAPES = [(3, 130, 128, 2), (2, 70, 256, 4)]  # (B, L, D, H): L pads to 256 and 128


# ---------------------------------------------------------------------------
# the twins against the JAX kernels (interpret mode) and _block_ref_xla
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,L,D,H", SHAPES)
def test_fwd_twin_matches_jax_kernel_fp32(B, L, D, H):
    """(tolerance) fp32 atol 5e-5 / rtol 1e-4: the JAX package's own bar for
    its kernel against the XLA block; it covers the A&S erf of the TPU
    kernel (1.5e-7) against the exact erf here, and summation order."""
    p = _block(D, 0)
    x, lp = _x(B, L, D, 1)
    want = np.asarray(J.fused_vit_block(p, jnp.asarray(x), H, EPS, true_len=L, interpret=True))
    xla = np.asarray(J._block_ref_xla(jnp.asarray(x), *map(jnp.asarray, _flat(p)), true_len=L,
                                      num_heads=H, eps=EPS))
    got = F.fused_block_ref(_t(x), *map(_t, _flat(p)), true_len=L, num_heads=H, eps=EPS).numpy()
    np.testing.assert_allclose(got[:, :L], want[:, :L], atol=5e-5, rtol=1e-4)
    np.testing.assert_allclose(got[:, :L], xla[:, :L], atol=5e-5, rtol=1e-4)
    assert np.isfinite(got).all()  # pad rows too


@pytest.mark.parametrize("B,L,D,H", SHAPES)
def test_fwd_twin_matches_jax_kernel_bf16(B, L, D, H):
    """(tolerance) bf16: at most 2 bf16 ulps of max |out| (both round at the
    same points; an fp32 order or erf difference can flip one rounding)."""
    p = _block(D, 2)
    x, lp = _x(B, L, D, 3)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(J.fused_vit_block(p, xb, H, EPS, true_len=L, interpret=True)
                      .astype(jnp.float32))
    flat = _flat(p, jnp.bfloat16)
    args = [_t(a, torch.bfloat16) if i in (2, 3, 4, 5, 8, 9, 10, 11) else _t(a)
            for i, a in enumerate(flat)]
    got = F.fused_block_ref(_t(np.asarray(xb.astype(jnp.float32)), torch.bfloat16), *args,
                            true_len=L, num_heads=H, eps=EPS).float().numpy()
    ulp = 2.0 ** (math.floor(math.log2(np.abs(want[:, :L]).max())) - 7)
    assert np.abs(got[:, :L] - want[:, :L]).max() <= 2 * ulp


@pytest.mark.parametrize("B,L,D,H", SHAPES)
def test_bwd_twin_matches_jax_kernel(B, L, D, H):
    """dx and all 12 gradients of the backward twin against the JAX backward
    kernel in interpret mode, fp32. (tolerance) 2e-4 of each gradient's max
    |.|: summation order over rows and the erf difference."""
    p = _block(D, 4)
    x, lp = _x(B, L, D, 5)
    g = np.random.default_rng(6).standard_normal(x.shape).astype(np.float32)
    g[:, L:] = 0  # the sliced-off pad rows get no gradient
    want = J._fused_block_backward(jnp.asarray(x), *map(jnp.asarray, _flat(p)), jnp.asarray(g),
                                   true_len=L, num_heads=H, eps=EPS, interpret=True)
    got = F.fused_block_bwd_ref(_t(x), *map(_t, _flat(p)), _t(g), true_len=L, num_heads=H,
                                eps=EPS)
    assert _rel(got[0][:, :L], np.asarray(want[0])[:, :L]) <= 2e-4
    for name, a, b in zip(GRAD_NAMES, got[1:], want[1:]):
        assert a.shape == b.shape, name
        assert _rel(a, b) <= 2e-4, (name, _rel(a, b))


def test_bwd_twin_is_the_gradient_fp64():
    """In fp64 no rounding point rounds, so the hand-derived backward must be
    autograd's gradient of the plain block (tolerance 1e-9 relative)."""
    p = _block(128, 7)
    x, lp = _x(2, 100, 128, 8)
    args = [_t(a).double() for a in (x, *_flat(p))]
    g = torch.from_numpy(np.random.default_rng(9).standard_normal(x.shape))
    got = F.fused_block_bwd_ref(*args, g, true_len=100, num_heads=2, eps=EPS)
    leaves = [a.clone().requires_grad_(True) for a in args]
    out = F.block_ref(*leaves, true_len=100, num_heads=2, eps=EPS)
    want = torch.autograd.grad(out, leaves, g)
    for name, a, b in zip(("dx",) + GRAD_NAMES, got, want):
        assert _rel(a.numpy(), b.numpy()) <= 1e-9, name
    # and the forward twin is the plain block
    ref = F.fused_block_ref(*args, true_len=100, num_heads=2, eps=EPS)
    assert _rel(ref.numpy(), out.detach().numpy()) <= 1e-12


def test_function_on_cpu_runs_the_twins_without_counting():
    p = convert.from_jax_params(_block(128, 10))
    x, _ = _x(1, 128, 128, 11)
    xt = _t(x).requires_grad_(True)
    before = dict(F.launch_counts)
    out = F.fused_vit_block(p, xt, 2, EPS, 128, pallas_bwd=True)
    out.square().sum().backward()
    assert xt.grad is not None and F.launch_counts == before
    xt = _t(x).requires_grad_(True)
    out = F.fused_vit_block(p, xt, 2, EPS, 128, pallas_bwd=True)
    (gx,) = torch.autograd.grad(out.square().sum(), xt, create_graph=True)
    with pytest.raises(RuntimeError):  # K5 records no graph: no double backward
        torch.autograd.grad(gx.sum(), xt)


def test_results_do_not_depend_on_frames_per_program():
    """`frames_per_program` / `bwd_frames` are the TPU grid's; the port's
    kernels tile on their own, so outputs and gradients are identical for
    any value (the JAX kernel agrees with itself to 1e-6 across them, its
    test_batch_padding_to_frames_per_program)."""
    p = convert.from_jax_params(_block(128, 12))
    x, _ = _x(3, 100, 128, 13)
    outs = []
    for frames, bwd_frames in ((1, 1), (2, 3)):
        xt = _t(x).requires_grad_(True)
        out = F.fused_vit_block(p, xt, 2, EPS, 100, frames_per_program=frames,
                                pallas_bwd=True, bwd_frames=bwd_frames)
        out.square().sum().backward()
        outs.append((out.detach(), xt.grad))
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    jax_outs = [np.asarray(J.fused_vit_block(jax.tree.map(np.asarray, convert.to_jax_params(p)),
                                             jnp.asarray(x), 2, EPS, true_len=100,
                                             frames_per_program=f, interpret=True))
                for f in (1, 2)]
    np.testing.assert_allclose(jax_outs[0], jax_outs[1], atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# vit_forward's fused schedule against the JAX package's
# ---------------------------------------------------------------------------

VIT_KW = dict(image_size=48, patch_size=16, hidden_size=128, num_layers=2, num_heads=2)


@pytest.mark.parametrize("fused_bwd,remat", [(False, False), (True, False), (True, True)])
def test_vit_forward_fused_matches_jax(fused_bwd, remat):
    """Outputs and gradients of the fused vit_forward (10 tokens padded to
    128, fp32, interpret / twins) against JAX's in the same configuration:
    without the backward kernel both differentiate a recompute of the plain
    block; with it, the backward kernel (under remat too: the pair is its
    own remat). (tolerance) outputs 1e-4 (the JAX fused-vs-classic bar);
    gradients 2e-4 of each leaf's max |.|."""
    kw = dict(VIT_KW, remat=remat, use_fused_block=True, use_fused_block_bwd=fused_bwd,
              fused_block_interpret=True)
    jcfg, cfg = JViT(**kw), ViTConfig(**kw)
    jp = jax.tree.map(np.asarray, init_vit(jax.random.PRNGKey(14), jcfg))
    rng = np.random.default_rng(15)
    imgs = rng.standard_normal((2, 48, 48, 3)).astype(np.float32) * 0.3
    # a fixed random projection of the output: sum(out**2) after the final
    # LayerNorm is nearly constant, and its gradient mostly rounding noise
    proj = rng.standard_normal((2, 10, 128)).astype(np.float32)

    def jloss(p):
        return jnp.sum(j_vit_forward(p, jnp.asarray(imgs), jcfg) * proj)

    jout = np.asarray(j_vit_forward(jp, jnp.asarray(imgs), jcfg))
    jgrads = jax.grad(jloss)(jp)

    tp = convert.from_jax_params(jp)
    for _, t in convert.named_leaves(tp):
        t.requires_grad_(True)
    before = dict(F.launch_counts)
    out = vit.vit_forward(tp, torch.from_numpy(imgs), cfg)
    (out * torch.from_numpy(proj)).sum().backward()
    assert F.launch_counts == before  # CPU: the twins, not the kernels
    np.testing.assert_allclose(out.detach().numpy(), jout, atol=1e-4, rtol=1e-4)
    want = dict(jax.tree_util.tree_leaves_with_path(jgrads))
    got = dict(jax.tree_util.tree_leaves_with_path(convert.to_jax_params(
        jax.tree.map(lambda t: t.grad, tp, is_leaf=lambda t: isinstance(t, torch.Tensor)))))
    assert got.keys() == want.keys()
    for k in want:
        assert _rel(got[k], want[k]) <= 2e-4, (jax.tree_util.keystr(k), _rel(got[k], want[k]))


def test_fused_gate_keeps_narrow_and_cpu_configs_classic(monkeypatch):
    """The gate of JAX's vit_forward: without interpret a CPU tensor runs the
    classic schedule, and so does a width that is not a multiple of 128; a
    forward-only request under remat stays classic too."""
    called = []
    monkeypatch.setattr(vit, "fused_vit_block", lambda *a, **k: called.append(1))
    x = torch.zeros((1, 10, 128))
    assert not vit.use_fused_schedule(ViTConfig(**VIT_KW, use_fused_block=True), x)
    assert not vit.use_fused_schedule(
        ViTConfig(**dict(VIT_KW, hidden_size=32, num_heads=4), use_fused_block=True,
                  fused_block_interpret=True), x[..., :32])
    assert not vit.use_fused_schedule(
        ViTConfig(**VIT_KW, remat=True, use_fused_block=True, fused_block_interpret=True), x)
    assert vit.use_fused_schedule(
        ViTConfig(**VIT_KW, remat=True, use_fused_block=True, use_fused_block_bwd=True,
                  fused_block_interpret=True), x)
    assert not called


# ---------------------------------------------------------------------------
# training_cfgs: the schedule a trainer runs, against the JAX package's
# ---------------------------------------------------------------------------

START = {"plain": {}, "forward_only": {"use_fused_block": True},
         "pair": {"use_fused_block": True, "use_fused_block_bwd": True}}
FIELDS = ("use_fused_block", "use_fused_block_bwd", "use_fused_mlp", "remat")


@pytest.mark.parametrize("env", ["0", "1", None])
@pytest.mark.parametrize("default_fused_bwd", [True, False])
@pytest.mark.parametrize("start", sorted(START))
def test_training_cfgs_matches_jax(monkeypatch, env, default_fused_bwd, start):
    if env is None:
        monkeypatch.delenv("VIDIL_TPU_TRAIN_FUSED_BLOCK", raising=False)
    else:
        monkeypatch.setenv("VIDIL_TPU_TRAIN_FUSED_BLOCK", env)
    med_kw = dict(hidden_size=128, num_heads=2, num_layers=1)
    jv, jm = j_training_cfgs(JViT(**VIT_KW, **START[start]), JMed(**med_kw),
                             default_fused_bwd=default_fused_bwd)
    v, m = training_cfgs(ViTConfig(**VIT_KW, **START[start]), MedConfig(**med_kw),
                         default_fused_bwd=default_fused_bwd)
    assert {f: getattr(v, f) for f in FIELDS} == {f: getattr(jv, f) for f in FIELDS}
    assert (m.remat, m.use_fused_mlp) == (jm.remat, jm.use_fused_mlp)
    if env is None and default_fused_bwd and start != "forward_only":
        assert v.use_fused_block and v.use_fused_block_bwd  # the trainers' default


def test_training_cfgs_turns_the_fused_mlp_off_under_autodiff(monkeypatch):
    """The configs take K3's switch, and training_cfgs turns it off under
    autodiff in both towers, as JAX's does."""
    monkeypatch.delenv("VIDIL_TPU_TRAIN_FUSED_BLOCK", raising=False)
    vit, med = ViTConfig(**VIT_KW, use_fused_mlp=True), MedConfig(use_fused_mlp=True)
    assert vit.use_fused_mlp and med.use_fused_mlp
    v, m = training_cfgs(vit, med)
    jv, jm = j_training_cfgs(JViT(**VIT_KW, use_fused_mlp=True), JMed(use_fused_mlp=True))
    assert not v.use_fused_mlp and not m.use_fused_mlp and v.use_fused_block
    assert (v.use_fused_mlp, m.use_fused_mlp, v.use_fused_block) == (
        jv.use_fused_mlp, jm.use_fused_mlp, jv.use_fused_block)
