"""The remaining BLIP model functions of the port against the JAX package,
fp32 on the CPU: NLVR2 (forward and loss), the BLIP embedding extractor
(ITM and ITC), blip_itc_features, med_pooler, the ViT's return_attn path
and the Flax .npz ViT loader. The JAX side's weights are its own inits,
carried across with from_jax_params. Bars: ViT 2e-5, MED 3e-5 (PARITY.md).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vidil_tpu.config import MedConfig as JMed, ViTConfig as JViT
from vidil_tpu.models import blip as jblip, med as jmed, vit as jvit
from vidil_tpu.models.blip_embedding import blip_embedding_forward as j_embedding_forward
from vidil_tpu.models.blip_embedding import init_blip_embedding
from vidil_tpu.models.blip_nlvr import init_blip_nlvr, nlvr_forward as j_nlvr_forward
from vidil_tpu.models.blip_nlvr import nlvr_loss as j_nlvr_loss
from vidil_tpu_torch.config import MedConfig, ViTConfig
from vidil_tpu_torch.models import blip, convert, med, vit
from vidil_tpu_torch.models.blip_embedding import blip_embedding_forward
from vidil_tpu_torch.models.blip_nlvr import nlvr_forward, nlvr_loss
from vidil_tpu_torch.utils.synth import synth_tree

torch.set_num_threads(1)

VIT_KW = dict(image_size=32, patch_size=16, hidden_size=32, num_layers=2, num_heads=4)
MED_KW = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
              intermediate_size=64, max_position_embeddings=64, encoder_width=32)
JV, JM = JViT(**VIT_KW), JMed(**MED_KW)
PV, PM = ViTConfig(**VIT_KW), MedConfig(**MED_KW)
VIT_ATOL, MED_ATOL = 2e-5, 3e-5


def _port(tree):
    return convert.from_jax_params(jax.tree.map(np.asarray, tree))


def _t(x):
    return torch.from_numpy(np.array(x))


def _inputs(seed, n_img, n_text, L=8):
    rng = np.random.RandomState(seed)
    imgs = rng.randn(n_img, 32, 32, 3).astype(np.float32)
    ids = rng.randint(4, 64, (n_text, L)).astype(np.int32)
    mask = np.ones((n_text, L), np.int32)
    mask[0, L - 3:] = 0  # a padded text
    return imgs, ids, mask


@pytest.mark.parametrize("fusion_layer", [0, 1, 2])
def test_nlvr_forward_and_loss_match_jax(fusion_layer):
    """fusion_layer 0: every layer merges; 2: every layer averages; 1: both."""
    jp = init_blip_nlvr(jax.random.PRNGKey(0), JV, JM, fusion_layer=fusion_layer)
    tp = _port(jp)
    assert isinstance(tp["nlvr"], list) and len(tp["nlvr"]) == MED_KW["num_layers"]
    imgs, ids, mask = _inputs(0, 4, 2)
    img0, img1 = imgs[:2], imgs[2:]
    want = np.asarray(j_nlvr_forward(jp, jnp.asarray(img0), jnp.asarray(img1), jnp.asarray(ids),
                                     jnp.asarray(mask), JV, JM, fusion_layer=fusion_layer))
    got = nlvr_forward(tp, _t(img0), _t(img1), _t(ids), _t(mask), PV, PM,
                       fusion_layer=fusion_layer)
    assert got.dtype == torch.float32 and got.shape == (2, 2)
    np.testing.assert_allclose(got.numpy(), want, atol=MED_ATOL, rtol=0)
    targets = np.array([0, 1], np.int32)
    want_loss = float(j_nlvr_loss(jnp.asarray(want), jnp.asarray(targets)))
    np.testing.assert_allclose(float(nlvr_loss(got, _t(targets))), want_loss, atol=MED_ATOL)
    # both images matter
    swapped = nlvr_forward(tp, _t(img1), _t(img0), _t(ids), _t(mask), PV, PM,
                           fusion_layer=fusion_layer)
    assert not torch.allclose(swapped, got)


def test_nlvr_params_round_trip_and_shapes():
    """from_jax_params carries the stacked (L, ...) nlvr denses into the
    per-layer list and to_jax_params stacks them back; blip_nlvr_shapes
    gives the JAX init's layout, so synthetic weights fill the same tree."""
    jp = jax.tree.map(np.asarray, init_blip_nlvr(jax.random.PRNGKey(1), JV, JM))
    back = convert.to_jax_params(convert.from_jax_params(jp))
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_flatten_with_path(jp)[0],
                                jax.tree_util.tree_flatten_with_path(back)[0]):
        assert str(pa) == str(pb)
        np.testing.assert_array_equal(a, b)
    shapes = jax.tree.map(lambda a: tuple(a.shape), jp)
    assert blip.blip_nlvr_shapes(PV, PM) == shapes
    synth = convert.from_jax_params(synth_tree(blip.blip_nlvr_shapes(PV, PM), "cpu"))
    imgs, ids, mask = _inputs(1, 4, 2)
    out = nlvr_forward(synth, _t(imgs[:2]), _t(imgs[2:]), _t(ids), _t(mask), PV, PM,
                       fusion_layer=1)
    assert torch.isfinite(out).all()


def test_blip_embedding_modes_match_jax():
    jp = init_blip_embedding(jax.random.PRNGKey(1), JV, JM, embed_dim=8)
    tp = _port(jp)
    imgs, ids, mask = _inputs(1, 3, 2)
    want = np.asarray(j_embedding_forward(jp, jnp.asarray(imgs[:2]), jnp.asarray(ids),
                                          jnp.asarray(mask), JV, JM, match_head="itm"))
    got = blip_embedding_forward(tp, _t(imgs[:2]), _t(ids), _t(mask), PV, PM, match_head="itm")
    assert got.shape == (2, 2)
    np.testing.assert_allclose(got.numpy(), want, atol=MED_ATOL, rtol=0)
    wants = j_embedding_forward(jp, jnp.asarray(imgs), jnp.asarray(ids), jnp.asarray(mask),
                                JV, JM, match_head="itc")
    gots = blip_embedding_forward(tp, _t(imgs), _t(ids), _t(mask), PV, PM, match_head="itc")
    for name, g, w, n in zip(("image_feat", "text_feat", "sim"), gots, wants,
                             ((3, 8), (2, 8), (3, 2))):
        assert tuple(g.shape) == n, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=MED_ATOL, rtol=0,
                                   err_msg=name)
    np.testing.assert_allclose(gots[0].norm(dim=-1).numpy(), 1.0, atol=1e-5)
    np.testing.assert_allclose(gots[1].norm(dim=-1).numpy(), 1.0, atol=1e-5)


def test_blip_itc_features_match_jax():
    jp = jblip.init_blip_itm(jax.random.PRNGKey(2), JV, JM, embed_dim=16)
    tp = _port(jp)
    rng = np.random.RandomState(2)
    image_embeds = rng.randn(5, 5, 32).astype(np.float32)
    _, ids, mask = _inputs(2, 0, 3)
    want = jblip.blip_itc_features(jp, jnp.asarray(image_embeds), jnp.asarray(ids),
                                   jnp.asarray(mask), JM)
    got = blip.blip_itc_features(tp, _t(image_embeds), _t(ids), _t(mask), PM)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=MED_ATOL, rtol=0)


def test_med_pooler_matches_jax():
    jp = jmed.init_med(jax.random.PRNGKey(3), JM, with_pooler=True)
    tp = _port(jp)
    _, ids, mask = _inputs(3, 0, 3)
    jh = jmed.med_forward(jp, jnp.asarray(ids), jnp.asarray(mask), cfg=JM, mode="text")
    th = med.med_forward(tp, _t(ids), _t(mask), cfg=PM, mode="text")
    want = np.asarray(jmed.med_pooler(jp, jh))
    got = med.med_pooler(tp, th)
    assert got.shape == (3, 32)
    np.testing.assert_allclose(got.numpy(), want, atol=MED_ATOL, rtol=0)


@pytest.mark.parametrize("use_fused_mlp", [False, True])
def test_vit_return_attn_matches_jax(use_fused_mlp):
    """Per-layer (B, H, L, L) softmax maps and the embeddings against JAX;
    the embeddings also equal the classic forward's. With use_fused_mlp the
    MLP takes mlp_auto's route (its plain version at this row count), as
    in JAX."""
    kw = dict(VIT_KW, use_fused_mlp=use_fused_mlp)
    jcfg, pcfg = JViT(**kw), ViTConfig(**kw)
    jp = jvit.init_vit(jax.random.PRNGKey(0), jcfg)
    tp = _port(jp)
    x = np.random.RandomState(4).randn(2, 32, 32, 3).astype(np.float32)
    want, want_attn = jvit.vit_forward(jp, jnp.asarray(x), jcfg, return_attn=True)
    got, got_attn = vit.vit_forward(tp, _t(x), pcfg, return_attn=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=VIT_ATOL, rtol=0)
    assert len(got_attn) == jcfg.num_layers
    for g, w in zip(got_attn, want_attn):
        assert g.shape == (2, jcfg.num_heads, jcfg.seq_len, jcfg.seq_len)
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=VIT_ATOL, rtol=0)
        torch.testing.assert_close(g.sum(-1), torch.ones(g.shape[:-1]), atol=1e-5, rtol=0)
    torch.testing.assert_close(got, vit.vit_forward(tp, _t(x), pcfg), atol=1e-5, rtol=0)


def _flax_npz(cfg, seed):
    """A Google vision_transformer Flax .npz tree written from a JAX init:
    per-head q/k/v/out kernels, the (ph, pw, c, D) conv kernel."""
    p = jax.tree.map(np.asarray, jvit.init_vit(jax.random.PRNGKey(seed), cfg))
    D, H = cfg.hidden_size, cfg.num_heads
    dh, P = D // H, cfg.patch_size
    z = {"embedding/kernel": p["patch_embed"]["kernel"].reshape(P, P, 3, D),
         "embedding/bias": p["patch_embed"]["bias"],
         "cls": p["cls_token"],
         "Transformer/posembed_input/pos_embedding": p["pos_embed"],
         "Transformer/encoder_norm/scale": p["norm"]["scale"],
         "Transformer/encoder_norm/bias": p["norm"]["bias"]}
    for i in range(cfg.num_layers):
        b = jax.tree.map(lambda a: a[i], p["blocks"])
        f = f"Transformer/encoderblock_{i}/"
        a = f + "MultiHeadDotProductAttention_1/"
        for j, n in enumerate(("query", "key", "value")):
            z[a + f"{n}/kernel"] = b["attn"]["qkv"]["kernel"][:, j * D:(j + 1) * D].reshape(D, H, dh)
            z[a + f"{n}/bias"] = b["attn"]["qkv"]["bias"][j * D:(j + 1) * D].reshape(H, dh)
        z[a + "out/kernel"] = b["attn"]["proj"]["kernel"].reshape(H, dh, D)
        z[a + "out/bias"] = b["attn"]["proj"]["bias"]
        for ln, name in (("LayerNorm_0", "norm1"), ("LayerNorm_2", "norm2")):
            z[f + f"{ln}/scale"] = b[name]["scale"]
            z[f + f"{ln}/bias"] = b[name]["bias"]
        for d, name in (("Dense_0", "fc1"), ("Dense_1", "fc2")):
            z[f + f"MlpBlock_3/{d}/kernel"] = b["mlp"][name]["kernel"]
            z[f + f"MlpBlock_3/{d}/bias"] = b["mlp"][name]["bias"]
    return z


@pytest.mark.parametrize("image_size", [32, 64])
def test_load_vit_flax_npz_matches_jax(tmp_path, image_size):
    """The port's loader against the JAX package's on one .npz, leaf for
    leaf (64 px resizes the 2x2 position grid to 4x4), and the loaded ViT's
    embeddings against JAX's."""
    from vidil_tpu.models.convert import load_vit_flax_npz as j_load

    kw = dict(VIT_KW, image_size=image_size)
    jcfg, pcfg = JViT(**kw), ViTConfig(**kw)
    path = str(tmp_path / "vit.npz")
    np.savez(path, **_flax_npz(JV, seed=5))
    want = j_load(path, jcfg)
    got = convert.load_vit_flax_npz(path, pcfg)
    ref = _port(want)
    leaves, ref_leaves = sorted(convert.named_leaves(got)), sorted(convert.named_leaves(ref))
    assert [p for p, _ in leaves] == [p for p, _ in ref_leaves]
    for (name, g), (_, w) in zip(leaves, ref_leaves):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-6, rtol=0, err_msg=name)
    x = np.random.RandomState(6).randn(2, image_size, image_size, 3).astype(np.float32)
    np.testing.assert_allclose(vit.vit_forward(got, _t(x), pcfg).numpy(),
                               np.asarray(jvit.vit_forward(want, jnp.asarray(x), jcfg)),
                               atol=VIT_ATOL, rtol=0)
    # a mapping loads as a path does
    got2 = convert.load_vit_flax_npz(dict(np.load(path)), pcfg)
    torch.testing.assert_close(got2["blocks"][1]["attn"]["qkv"]["kernel"],
                               got["blocks"][1]["attn"]["qkv"]["kernel"], atol=0, rtol=0)
