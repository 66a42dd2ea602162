"""Module parity of the port (vidil_tpu_torch) with the JAX package in fp32
on the CPU: layers, ViT, MED (text / multimodal / grouped), the decode
prefill and step, ITM scores, the checkpoint converters and frame ingest.

The same seeded numpy inputs and the same synthetic BLIP checkpoints go to
both packages: the JAX side converts them with vidil_tpu.models.convert,
the port with its from_jax_params (and its own .pth converter).
Bars: ViT 2e-5, MED 3e-5 (the JAX package's own oracle bars, PARITY.md).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vidil_tpu.config import MedConfig as JMed, ViTConfig as JViT
from vidil_tpu.models import blip as jblip, convert as jconvert, layers as jlayers, med as jmed
from vidil_tpu.models.testing import make_blip_decoder_ckpt, make_blip_itm_ckpt
from vidil_tpu.ops import image as jimage
from vidil_tpu_torch.config import MedConfig, ViTConfig
from vidil_tpu_torch.models import blip, convert, layers, med
from vidil_tpu_torch.ops import image

torch.set_num_threads(1)

VIT_KW = dict(image_size=32, patch_size=16, hidden_size=32, num_layers=2, num_heads=4)
MED_KW = dict(vocab_size=120, hidden_size=32, num_layers=2, num_heads=4,
              intermediate_size=64, max_position_embeddings=64, encoder_width=32)
JV, JM = JViT(**VIT_KW), JMed(**MED_KW)
PV, PM = ViTConfig(**VIT_KW), MedConfig(**MED_KW)
VIT_ATOL, MED_ATOL = 2e-5, 3e-5


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def decoder():
    sd = make_blip_decoder_ckpt(JV, JM)
    jp = jconvert.convert_blip_decoder(sd, JV, JM)
    return sd, jp, convert.from_jax_params(_np_tree(jp))


@pytest.fixture(scope="module")
def itm():
    sd = make_blip_itm_ckpt(JV, JM)
    jp = jconvert.convert_blip_itm(sd, JV, JM)
    return sd, jp, convert.from_jax_params(_np_tree(jp))


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_linear_layer_norm_gelu_mlp():
    x = _rand((3, 5, 16), 0)
    lin = {"kernel": _rand((16, 24), 1), "bias": _rand((24,), 2)}
    ln = {"scale": 1 + 0.1 * _rand((16,), 3), "bias": 0.1 * _rand((16,), 4)}
    mlp_p = {"fc1": lin, "fc2": {"kernel": _rand((24, 16), 5), "bias": _rand((16,), 6)}}
    tp = convert.from_jax_params({"lin": lin, "ln": ln, "mlp": mlp_p})
    jx, tx = jnp.asarray(x), _t(x)
    np.testing.assert_allclose(layers.linear(tp["lin"], tx).numpy(),
                               np.asarray(jlayers.linear(lin, jx)), atol=1e-5)
    np.testing.assert_allclose(layers.layer_norm(tp["ln"], tx, 1e-6).numpy(),
                               np.asarray(jlayers.layer_norm(ln, jx, 1e-6)), atol=1e-5)
    np.testing.assert_allclose(layers.gelu(tx).numpy(), np.asarray(jlayers.gelu(jx)), atol=1e-6)
    np.testing.assert_allclose(layers.mlp(tp["mlp"], tx).numpy(),
                               np.asarray(jlayers.mlp(mlp_p, jx)), atol=1e-5)
    # bf16: x, kernel and bias cast, product rounded, bias added in bf16
    got = layers.linear(tp["lin"], tx, dtype=torch.bfloat16)
    want = jlayers.linear(lin, jx, dtype=jnp.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=0.05, rtol=0.02)


def test_heads_and_dot_product_attention():
    x = _rand((2, 7, 32), 7)
    q, k, v = (_rand((2, 4, 7, 8), s) for s in (8, 9, 10))
    bias = np.where(np.arange(7) < 5, 0.0, -10000.0).astype(np.float32)[None, None, None]
    np.testing.assert_array_equal(layers.split_heads(_t(x), 4).numpy(),
                                  np.asarray(jlayers.split_heads(jnp.asarray(x), 4)))
    np.testing.assert_array_equal(layers.merge_heads(layers.split_heads(_t(x), 4)).numpy(), x)
    got = layers.dot_product_attention(_t(q), _t(k), _t(v), bias=_t(bias)).numpy()
    want = np.asarray(jlayers.dot_product_attention(*map(jnp.asarray, (q, k, v)),
                                                    bias=jnp.asarray(bias)))
    np.testing.assert_allclose(got, want, atol=1e-5)


# ---------------------------------------------------------------------------
# ViT
# ---------------------------------------------------------------------------

def test_vit_forward_parity(decoder):
    sd, jp, tp = decoder
    img = _rand((3, 32, 32, 3), 11)
    want = np.asarray(jblip.encode_images(jp, jnp.asarray(img), JV))
    got = blip.encode_images(tp, _t(img), PV).numpy()
    assert got.shape == (3, PV.seq_len, 32)
    np.testing.assert_allclose(got, want, atol=VIT_ATOL, rtol=0)


def test_pth_converter_matches_from_jax_params(decoder, itm):
    """The port's .pth converter (incl. the conv -> (P*P*C, D) patch kernel
    reorder) gives the same encodings as the JAX converter's tree."""
    img = _t(_rand((2, 32, 32, 3), 12))
    for (sd, _, tp), conv in ((decoder, convert.convert_blip_decoder),
                              (itm, convert.convert_blip_itm)):
        direct = conv(sd, PV, PM)
        torch.testing.assert_close(blip.encode_images(direct, img, PV),
                                   blip.encode_images(tp, img, PV), atol=0, rtol=0)


def test_interpolate_pos_embed_matches_jax():
    from vidil_tpu.models.vit import interpolate_pos_embed as jinterp
    from vidil_tpu_torch.models.vit import interpolate_pos_embed

    pe = _rand((1, 1 + 4 * 4, 8), 13)
    got = interpolate_pos_embed(pe, 6 * 6)
    np.testing.assert_allclose(got, np.asarray(jinterp(jnp.asarray(pe), 6 * 6)), atol=1e-6)
    assert got.shape == (1, 37, 8)


# ---------------------------------------------------------------------------
# MED
# ---------------------------------------------------------------------------

def _text(n, L, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, MED_KW["vocab_size"], (n, L)).astype(np.int32)
    lens = rng.integers(3, L + 1, n)
    mask = (np.arange(L)[None] < lens[:, None]).astype(np.int32)
    return ids, mask


@pytest.mark.parametrize("mode,group_size,is_decoder", [
    ("text", 1, False), ("multimodal", 1, False), ("multimodal", 3, False),
    ("multimodal", 1, True)])
def test_med_forward_parity(itm, decoder, mode, group_size, is_decoder):
    _, jp, tp = decoder if is_decoder else itm
    tower = "text_decoder" if is_decoder else "text_encoder"
    n_img = 2
    ids, mask = _text(n_img * group_size, 9, 14)
    enc = _rand((n_img, 17, 32), 15)
    kw = dict(mode=mode, is_decoder=is_decoder, group_size=group_size)
    enc_j = jnp.asarray(enc) if mode == "multimodal" else None
    enc_t = _t(enc) if mode == "multimodal" else None
    want = np.asarray(jmed.med_forward(jp[tower], jnp.asarray(ids), jnp.asarray(mask), enc_j,
                                       cfg=JM, **kw))
    got = med.med_forward(tp[tower], _t(ids), _t(mask), enc_t, cfg=PM, **kw).numpy()
    np.testing.assert_allclose(got, want, atol=MED_ATOL, rtol=0)


def test_grouped_cross_attention_with_bias(itm):
    """The bias path of _grouped_attention (no flash fold)."""
    _, jp, tp = itm
    ids, mask = _text(4, 6, 16)
    enc = _rand((2, 11, 32), 17)
    emask = np.ones((2, 11), np.int32)
    emask[1, 8:] = 0
    want = np.asarray(jmed.med_forward(jp["text_encoder"], jnp.asarray(ids), jnp.asarray(mask),
                                       jnp.asarray(enc), jnp.asarray(emask), cfg=JM,
                                       group_size=2))
    got = med.med_forward(tp["text_encoder"], _t(ids), _t(mask), _t(enc), _t(emask), cfg=PM,
                          group_size=2).numpy()
    np.testing.assert_allclose(got, want, atol=MED_ATOL, rtol=0)


@pytest.mark.parametrize("beam_size", [1, 3])
def test_decode_prefill_and_step_logits(decoder, beam_size):
    """Prefill over the prompt, then two cached steps: logits and the
    head-folded (layers, B, L, H*Dh) cache match the JAX package's."""
    _, jp, tp = decoder
    nb, B, Lp, max_len = 3, 2, 4, 10
    enc = _rand((B, 17, 32), 18)
    kv_src = enc if beam_size > 1 else np.repeat(enc, nb, axis=0)
    prompt = np.repeat(np.array([[30, 5, 6, 7]], np.int32), B * nb, axis=0)
    jd, td = jp["text_decoder"], tp["text_decoder"]
    jk, jv = jmed.precompute_cross_kv(jd, jnp.asarray(kv_src), JM)
    tk, tv = med.precompute_cross_kv(td, _t(kv_src), PM)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=MED_ATOL)
    jc = jmed.init_self_cache(JM, B * nb, max_len)
    tc = med.init_self_cache(PM, B * nb, max_len)
    jh, jc = jmed.med_decode_prefill(jd, jnp.asarray(prompt), jc, jk, jv, None, JM,
                                     beam_size=beam_size)
    th, tc = med.med_decode_prefill(td, _t(prompt), tc, tk, tv, None, PM, beam_size=beam_size)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=MED_ATOL)
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]), atol=MED_ATOL)
    tokens = np.array([9, 13, 40, 2, 77, 5], np.int32)
    for step in (Lp, Lp + 1):
        jl, jc = jmed.med_decode_step(jd, jnp.asarray(tokens), step, jc, jk, jv, None, JM,
                                      beam_size=beam_size)
        tl, tc = med.med_decode_step(td, _t(tokens), step, tc, tk, tv, None, PM,
                                     beam_size=beam_size)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=MED_ATOL)
        tokens = (tokens + 3) % MED_KW["vocab_size"]
    np.testing.assert_allclose(tc["v"].numpy(), np.asarray(jc["v"]), atol=MED_ATOL)


def test_itm_scores_grouped(itm):
    """blip_itm_scores with group_size: G texts per image memory."""
    _, jp, tp = itm
    G = 4
    ids, mask = _text(3 * G, 10, 19)
    img = _rand((3, PV.seq_len, 32), 20)
    for group_size, img_rows in ((G, img), (1, np.repeat(img, G, axis=0))):
        want = np.asarray(jblip.blip_itm_scores(jp, jnp.asarray(img_rows), jnp.asarray(ids),
                                                jnp.asarray(mask), JM, group_size=group_size))
        got = blip.blip_itm_scores(tp, _t(img_rows), _t(ids), _t(mask), PM,
                                   group_size=group_size)
        assert got.dtype == torch.float32 and got.shape == (3 * G, 2)
        np.testing.assert_allclose(got.numpy(), want, atol=MED_ATOL, rtol=0)


def test_unported_switches_raise(itm):
    _, _, tp = itm
    ids, mask = _text(2, 5, 21)
    with pytest.raises(NotImplementedError):
        MedConfig(**MED_KW, remat_policy="dots")
    # self_fold is accepted: the unfolded run is the fold's exact result
    base = med.med_forward(tp["text_encoder"], _t(ids), _t(mask), cfg=PM, mode="text")
    folded = med.med_forward(tp["text_encoder"], _t(ids), _t(mask), cfg=PM, mode="text",
                             self_fold=2)
    assert torch.equal(folded, base)
    # the fused MLP (K3) is ported: the config takes the switch
    assert ViTConfig(**VIT_KW, use_fused_mlp=True).use_fused_mlp


# ---------------------------------------------------------------------------
# frame ingest
# ---------------------------------------------------------------------------

def test_preprocess_rgb_and_yuv420_match_jax():
    frames = np.random.default_rng(22).integers(0, 256, (3, 32, 32, 3)).astype(np.uint8)
    want = np.asarray(jimage.preprocess_any(jnp.asarray(frames), 32))
    np.testing.assert_array_equal(image.preprocess_any(_t(frames), 32).numpy(), want)
    yuv = image.rgb_to_yuv420(frames)
    jyuv = jimage.rgb_to_yuv420(frames)
    for a, b in zip(yuv, jyuv):
        np.testing.assert_array_equal(a, b)
    want = np.asarray(jimage.preprocess_any(jimage.YUV420Frames(*map(jnp.asarray, jyuv)), 32))
    got = image.preprocess_any(image.YUV420Frames(*map(_t, yuv)), 32).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    with pytest.raises(NotImplementedError):  # resize_on_device is not ported
        image.preprocess_any(_t(frames[:, :16]), 32)
