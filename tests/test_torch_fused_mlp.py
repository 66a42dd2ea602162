"""The fused MLP (kernel K3): the port's plain version against the JAX
package's Pallas kernel in interpret mode, `mlp_auto`'s gate, and the
gradient of `FusedMLPFunction` against the JAX package's recompute vjp.
The CUDA kernel itself is checked on the card
(tests/test_torch_cuda_kernels.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vidil_tpu.models.layers import init_mlp
from vidil_tpu.ops.fused_mlp import _erf_f32, _mlp_ref, fused_mlp as j_fused_mlp
from vidil_tpu_torch.models import layers
from vidil_tpu_torch.ops import fused_mlp as fm

torch.set_num_threads(1)


def _params(D, Dh, seed):
    """JAX-initialised MLP params (numpy) and their tensors."""
    p = jax.tree.map(lambda a: np.array(a), init_mlp(jax.random.PRNGKey(seed), D, Dh))
    rng = np.random.default_rng(seed)
    for lin in p.values():  # non-zero biases, so that both bias adds count
        lin["bias"] = (0.02 * rng.standard_normal(lin["bias"].shape)).astype(np.float32)
    return p, {k: {n: torch.from_numpy(v) for n, v in lin.items()} for k, lin in p.items()}


def _bf16_np(a):
    """numpy float32 array holding the values of `a` rounded to bf16."""
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


# the three shapes of tests/test_fused_mlp.py: row padding, exact blocks,
# fewer rows than one block
@pytest.mark.parametrize("rows,D,Dh,block_m", [(70, 128, 512, 64), (128, 128, 512, 64),
                                               (33, 256, 1024, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_matches_jax_kernel(rows, D, Dh, block_m, dtype):
    """(tolerance) fp32: both products are fp32 sums in another order, and
    the erf is the same A&S formula: 1e-5 absolute. bf16: the sums are exact
    products summed in fp32, so a difference in order can flip one rounding
    of an activation (which moves an output by |w2| times its ulp) or of the
    output: one bf16 ulp at the output's largest magnitude."""
    p, tp = _params(D, Dh, rows)
    x = np.random.default_rng(rows).standard_normal((rows, D)).astype(np.float32)
    if dtype == "bfloat16":
        jp = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16), p)
        want = np.asarray(j_fused_mlp(jp, jnp.asarray(x).astype(jnp.bfloat16), block_m=block_m,
                                      interpret=True).astype(jnp.float32))
        args = [torch.from_numpy(_bf16_np(a)).bfloat16()
                for a in (x, p["fc1"]["kernel"], p["fc1"]["bias"], p["fc2"]["kernel"],
                          p["fc2"]["bias"])]
        got = fm.fused_mlp_ref(*args)
        assert got.dtype == torch.bfloat16
        ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
        assert np.abs(got.float().numpy() - want).max() <= ulp
    else:
        want = np.asarray(j_fused_mlp(p, jnp.asarray(x), block_m=block_m, interpret=True))
        got = fm.fused_mlp_ref(torch.from_numpy(x), tp["fc1"]["kernel"], tp["fc1"]["bias"],
                               tp["fc2"]["kernel"], tp["fc2"]["bias"])
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_erf_matches_jax_kernel_erf():
    """The A&S erf of the plain version against the TPU kernel's formula and
    against the exact erf (its published bound is 1.5e-7; ~6e-7 in fp32)."""
    x = np.linspace(-6.0, 6.0, 200001, dtype=np.float32)
    got = fm._erf_as(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(_erf_f32(jnp.asarray(x))), atol=2e-7, rtol=0)
    assert np.abs(got - torch.erf(torch.from_numpy(x)).numpy()).max() < 1e-6
    assert fm._erf_as(torch.zeros(1)).item() == 0.0


def test_mlp_auto_dispatch(monkeypatch):
    """The gate of JAX's test_mlp_auto_dispatch: a CPU tensor takes the plain
    mlp (equal bit for bit); `interpret` takes K3's plain version; below
    2048 rows, with a non-GELU activation, or with weights over the limit,
    the plain mlp runs; dtype= casts before either path."""
    p, tp = _params(128, 512, 4)
    big = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (layers._FUSED_MLP_MIN_ROWS, 128)).astype(np.float32))
    plain = layers.mlp(tp, big)
    fused = fm.fused_mlp_ref(big, tp["fc1"]["kernel"], tp["fc1"]["bias"], tp["fc2"]["kernel"],
                             tp["fc2"]["bias"])
    assert not torch.equal(plain, fused)  # the two paths are told apart below
    assert torch.equal(layers.mlp_auto(tp, big, use_fused=True), plain)
    assert torch.equal(layers.mlp_auto(tp, big, use_fused=True, interpret=True), fused)
    assert torch.equal(layers.mlp_auto(tp, big, interpret=True), plain)  # not asked for
    small = big[:16]
    assert torch.equal(layers.mlp_auto(tp, small, use_fused=True, interpret=True),
                       layers.mlp(tp, small))
    assert torch.equal(layers.mlp_auto(tp, big, act=layers.quick_gelu, use_fused=True,
                                       interpret=True),
                       layers.mlp(tp, big, act=layers.quick_gelu))
    want = np.asarray(_mlp_ref(jnp.asarray(big.numpy()), *(p[k][n] for k in ("fc1", "fc2")
                                                          for n in ("kernel", "bias"))))
    np.testing.assert_allclose(fused.numpy(), want, atol=1e-5, rtol=0)
    bf = layers.mlp_auto(tp, big, dtype=torch.bfloat16, use_fused=True, interpret=True)
    cast = {k: {n: v.bfloat16() for n, v in lin.items()} for k, lin in tp.items()}
    assert bf.dtype == torch.bfloat16
    assert torch.equal(bf, fm.fused_mlp_ref(big.bfloat16(), cast["fc1"]["kernel"],
                                            cast["fc1"]["bias"], cast["fc2"]["kernel"],
                                            cast["fc2"]["bias"]))
    assert torch.equal(layers.mlp_auto(tp, small, dtype=torch.bfloat16, use_fused=True),
                       layers.mlp(tp, small, dtype=torch.bfloat16))
    monkeypatch.setattr(layers, "_FUSED_MLP_MAX_WEIGHT_BYTES", 2 * 128 * 512 * 4 - 1)
    assert torch.equal(layers.mlp_auto(tp, big, use_fused=True, interpret=True), plain)


def test_fused_mlp_function_grads_match_jax_vjp():
    """The gradient: autograd through the plain mlp recompute, as JAX's
    _fused_mlp_vjp_bwd; in fp32 against jax.vjp(_mlp_ref)."""
    p, tp = _params(64, 256, 3)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 10, 64)).astype(np.float32)
    g = rng.standard_normal((2, 10, 64)).astype(np.float32)
    names = [(k, n) for k in ("fc1", "fc2") for n in ("kernel", "bias")]
    _, vjp = jax.vjp(_mlp_ref, jnp.asarray(x), *(jnp.asarray(p[k][n]) for k, n in names))
    want = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(x).requires_grad_(True)] + [
        tp[k][n].clone().requires_grad_(True) for k, n in names]
    params = {k: {} for k in ("fc1", "fc2")}
    for (k, n), t in zip(names, leaves[1:]):
        params[k][n] = t
    out = fm.fused_mlp(params, leaves[0])
    assert out.shape == x.shape
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=1e-5)


def test_vit_and_med_route_their_mlp_through_k3(monkeypatch):
    """ViTConfig/MedConfig.use_fused_mlp reach mlp_auto in the ViT block and
    the MED FFN: with the gate lowered and interpret forced, both towers run
    K3's plain version, and agree with the JAX towers doing the same."""
    import functools

    from vidil_tpu.config import MedConfig as JMed, ViTConfig as JViT
    from vidil_tpu.models import layers as jlayers, med as jmed, vit as jvit
    from vidil_tpu_torch.config import MedConfig, ViTConfig
    from vidil_tpu_torch.models import convert, med, vit

    for lay, modules in ((jlayers, (jvit, jmed)), (layers, (vit, med))):
        monkeypatch.setattr(lay, "_FUSED_MLP_MIN_ROWS", 8)
        for mod in modules:
            monkeypatch.setattr(mod, "mlp_auto", functools.partial(lay.mlp_auto, interpret=True))
    calls = []
    ref = fm.fused_mlp_ref
    monkeypatch.setattr(fm, "fused_mlp_ref", lambda *a: calls.append(1) or ref(*a))
    vkw = dict(image_size=32, patch_size=16, hidden_size=32, num_layers=2, num_heads=4,
               use_fused_mlp=True)
    mkw = dict(vocab_size=50, hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
               max_position_embeddings=16, encoder_width=32, use_fused_mlp=True)
    jp_vit = jvit.init_vit(jax.random.PRNGKey(0), JViT(**vkw))
    jp_med = jmed.init_med(jax.random.PRNGKey(1), JMed(**mkw))
    rng = np.random.default_rng(5)
    img = rng.standard_normal((3, 32, 32, 3)).astype(np.float32)
    ids = rng.integers(1, 50, (3, 6)).astype(np.int32)
    want_v = np.asarray(jvit.vit_forward(jp_vit, jnp.asarray(img), JViT(**vkw)))
    want_m = np.asarray(jmed.med_forward(jp_med, jnp.asarray(ids), cfg=JMed(**mkw), mode="text"))
    tv = convert.from_jax_params(jax.tree.map(np.asarray, jp_vit))
    tm = convert.from_jax_params(jax.tree.map(np.asarray, jp_med))
    got_v = vit.vit_forward(tv, torch.from_numpy(img), ViTConfig(**vkw))
    got_m = med.med_forward(tm, torch.from_numpy(ids), cfg=MedConfig(**mkw), mode="text")
    assert len(calls) == 4  # 2 ViT blocks + 2 MED layers
    np.testing.assert_allclose(got_v.detach().numpy(), want_v, atol=2e-5, rtol=0)
    np.testing.assert_allclose(got_m.detach().numpy(), want_m, atol=2e-5, rtol=0)
