"""The port's CLIP (models/clip.py, convert_clip, the CLIP BPE tokenizer)
against the JAX package's, in fp32 on tiny towers. The HF-layout state
dict is made with numpy from a seed (no transformers).
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vidil_tpu.config import CLIPConfig as JCLIPConfig
from vidil_tpu.models import clip as jclip
from vidil_tpu.models.convert import convert_clip as j_convert_clip
from vidil_tpu.models.layers import quick_gelu as j_quick_gelu
from vidil_tpu.tokenizer import (
    ClipBPETokenizer as JTok,
    trimmed_pad_len as j_trimmed_pad_len,
    write_test_clip_bpe as j_write_bpe,
)
from vidil_tpu_torch.config import CLIPConfig
from vidil_tpu_torch.models import clip, convert, layers
from vidil_tpu_torch.tokenizer import ClipBPETokenizer, trimmed_pad_len, write_test_clip_bpe

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(image_size=28, patch_size=14, vision_hidden_size=32, vision_layers=2,
          vision_heads=4, vision_intermediate_size=64, vocab_size=512, text_hidden_size=32,
          text_layers=2, text_heads=4, text_intermediate_size=64, max_text_len=16,
          projection_dim=24)
JCFG, CFG = JCLIPConfig(**KW), CLIPConfig(**KW)
ATOL = 2e-5  # fp32: the same products and softmax, summed in another order


@pytest.fixture(scope="module")
def params():
    jp = jclip.init_clip(jax.random.PRNGKey(0), JCFG)
    # non-trivial LayerNorm and bias parameters
    leaves, tree = jax.tree.flatten(jp)
    rng = np.random.default_rng(0)
    leaves = [np.asarray(a) + 0.05 * rng.standard_normal(np.shape(a)).astype(np.float32)
              for a in leaves]
    jp = jax.tree.unflatten(tree, [jnp.asarray(a) for a in leaves])
    return jp, convert.from_jax_params(jax.tree.map(np.array, jp))


def _ids(rng, B, L, n_real):
    """CLIP-style ids: sot, words, eot (the largest id), then eot pads."""
    ids = np.full((B, L), KW["vocab_size"] - 1, np.int64)
    for b, n in enumerate(n_real):
        ids[b, 0] = KW["vocab_size"] - 2
        ids[b, 1:n - 1] = rng.integers(1, KW["vocab_size"] - 2, n - 2)
    return ids


def test_towers_and_embeddings_match_jax(params):
    jp, tp = params
    rng = np.random.default_rng(1)
    img = rng.standard_normal((3, 28, 28, 3)).astype(np.float32)
    ids = _ids(rng, 3, 12, (12, 7, 3))
    jh, jpool = jclip.clip_vision_forward(jp, jnp.asarray(img), JCFG)
    th, tpool = clip.clip_vision_forward(tp, torch.from_numpy(img), CFG)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tpool.numpy(), np.asarray(jpool), atol=ATOL, rtol=0)
    jh, jpool = jclip.clip_text_forward(jp, jnp.asarray(ids), JCFG)
    th, tpool = clip.clip_text_forward(tp, torch.from_numpy(ids), CFG)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tpool.numpy(), np.asarray(jpool), atol=ATOL, rtol=0)
    # pooled at the first eot: the pads hold the same (largest) id
    np.testing.assert_array_equal(tpool.numpy()[1], th.numpy()[1, 6])
    for normalize in (True, False):
        want = np.asarray(jclip.clip_image_embeds(jp, jnp.asarray(img), JCFG, normalize=normalize))
        got = clip.clip_image_embeds(tp, torch.from_numpy(img), CFG, normalize=normalize)
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
        want = np.asarray(jclip.clip_text_embeds(jp, jnp.asarray(ids), JCFG, normalize=normalize))
        got = clip.clip_text_embeds(tp, torch.from_numpy(ids), CFG, normalize=normalize)
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
        if normalize:
            np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=-1), 1.0, atol=1e-6)


def test_bf16_embeddings_close_to_jax(params):
    """(tolerance) bf16 compute: both packages round at the same linears
    and, at these shapes, both take plain attention (the reference's gate);
    the fp32 sums still run in another order, so a few bf16 ulps of a
    unit-norm embedding."""
    jp, tp = params
    rng = np.random.default_rng(2)
    img = rng.standard_normal((2, 28, 28, 3)).astype(np.float32)
    ids = _ids(rng, 2, 10, (10, 5))
    want = np.asarray(jclip.clip_image_embeds(jp, jnp.asarray(img), JCFG, dtype=jnp.bfloat16)
                      .astype(jnp.float32))
    got = clip.clip_image_embeds(tp, torch.from_numpy(img), CFG, dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=0.03, rtol=0)
    want = np.asarray(jclip.clip_text_embeds(jp, jnp.asarray(ids), JCFG, dtype=jnp.bfloat16)
                      .astype(jnp.float32))
    got = clip.clip_text_embeds(tp, torch.from_numpy(ids), CFG, dtype=torch.bfloat16)
    np.testing.assert_allclose(got.float().numpy(), want, atol=0.03, rtol=0)


def _hf_state_dict(seed, pre_spelling):
    """An HF CLIPModel state dict at the tiny sizes, made with numpy."""
    rng = np.random.default_rng(seed)
    r = lambda *s: (0.1 * rng.standard_normal(s)).astype(np.float32)
    sd = {}

    def tower(prefix, d, m, n):
        for i in range(n):
            b = f"{prefix}.layers.{i}."
            for ln in ("layer_norm1", "layer_norm2"):
                sd[b + ln + ".weight"], sd[b + ln + ".bias"] = 1 + r(d), r(d)
            for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
                sd[b + f"self_attn.{proj}.weight"], sd[b + f"self_attn.{proj}.bias"] = r(d, d), r(d)
            sd[b + "mlp.fc1.weight"], sd[b + "mlp.fc1.bias"] = r(m, d), r(m)
            sd[b + "mlp.fc2.weight"], sd[b + "mlp.fc2.bias"] = r(d, m), r(d)

    dv, dt, P = KW["vision_hidden_size"], KW["text_hidden_size"], KW["patch_size"]
    sd["vision_model.embeddings.patch_embedding.weight"] = r(dv, 3, P, P)
    sd["vision_model.embeddings.class_embedding"] = r(dv)
    sd["vision_model.embeddings.position_embedding.weight"] = r((28 // P) ** 2 + 1, dv)
    sd[f"vision_model.{pre_spelling}.weight"], sd[f"vision_model.{pre_spelling}.bias"] = r(dv), r(dv)
    tower("vision_model.encoder", dv, KW["vision_intermediate_size"], KW["vision_layers"])
    sd["vision_model.post_layernorm.weight"], sd["vision_model.post_layernorm.bias"] = r(dv), r(dv)
    sd["text_model.embeddings.token_embedding.weight"] = r(KW["vocab_size"], dt)
    sd["text_model.embeddings.position_embedding.weight"] = r(KW["max_text_len"], dt)
    tower("text_model.encoder", dt, KW["text_intermediate_size"], KW["text_layers"])
    sd["text_model.final_layer_norm.weight"] = r(dt)
    sd["text_model.final_layer_norm.bias"] = r(dt)
    sd["visual_projection.weight"] = r(KW["projection_dim"], dv)
    sd["text_projection.weight"] = r(KW["projection_dim"], dt)
    sd["logit_scale"] = np.asarray(2.6592, np.float32)
    return sd


@pytest.mark.parametrize("pre_spelling", ["pre_layrnorm", "pre_layernorm"])
def test_convert_clip_matches_jax(pre_spelling):
    sd = _hf_state_dict(3, pre_spelling)
    want = j_convert_clip(sd, JCFG)
    got = convert.convert_clip({k: torch.from_numpy(v) for k, v in sd.items()}, CFG)
    assert len(got["vision"]["layers"]) == 2 and len(got["text"]["layers"]) == 2
    back = convert.to_jax_params(got)
    assert jax.tree.structure(back) == jax.tree.structure(jax.tree.map(np.asarray, want))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        assert a.shape == np.shape(b)  # logit_scale is 0-d in both
        np.testing.assert_array_equal(a, np.asarray(b))
    # the patch kernel in patchify order: the embedding equals the conv's
    img = np.random.default_rng(4).standard_normal((1, 28, 28, 3)).astype(np.float32)
    conv = torch.nn.functional.conv2d(torch.from_numpy(img).permute(0, 3, 1, 2),
                                      torch.from_numpy(sd["vision_model.embeddings."
                                                          "patch_embedding.weight"]), stride=14)
    from vidil_tpu_torch.models.vit import patchify

    emb = patchify(torch.from_numpy(img), 14) @ got["vision"]["patch_embed"]["kernel"]
    np.testing.assert_allclose(emb[0].numpy(), conv[0].flatten(1).t().numpy(), atol=1e-5)


def test_clip_shapes_match_jax_init():
    shapes = clip.clip_shapes(CFG)
    want = jax.tree.map(lambda a: tuple(np.shape(a)), jclip.init_clip(jax.random.PRNGKey(0), JCFG))
    flat = lambda t: {k: (flat(v) if isinstance(v, dict) else tuple(v)) for k, v in t.items()}
    assert flat(shapes) == want


def test_clip_bpe_tokenizer_matches_jax(tmp_path):
    words = ["a", "photo", "of", "dog", "running", "red", "kitchen", "person"]
    write_test_clip_bpe(str(tmp_path / "v.json"), str(tmp_path / "m.txt"), words)
    j_write_bpe(str(tmp_path / "jv.json"), str(tmp_path / "jm.txt"), words)
    assert (tmp_path / "v.json").read_bytes() == (tmp_path / "jv.json").read_bytes()
    assert (tmp_path / "m.txt").read_bytes() == (tmp_path / "jm.txt").read_bytes()
    tok = ClipBPETokenizer(str(tmp_path / "v.json"), str(tmp_path / "m.txt"), max_len=16)
    jtok = JTok(str(tmp_path / "jv.json"), str(tmp_path / "jm.txt"), max_len=16)
    texts = ["A photo of dog", "a Running DOG's red kitchen!", "café ünïcode 中文 42",
             "person   person\tphoto", "x" * 40]
    vg = os.path.join(REPO, "visual_token_ontology", "vg")
    for name in sorted(os.listdir(vg)):
        with open(os.path.join(vg, name)) as f:
            terms = list(json.load(f))
        texts += [f"A photo of {t}" for t in terms[:150]]
    for padding in ("max_length", "longest"):
        enc = tok(texts, padding=padding, truncation=True, max_length=16)
        jenc = jtok(texts, padding=padding, truncation=True, max_length=16)
        np.testing.assert_array_equal(enc.input_ids, jenc.input_ids)
        np.testing.assert_array_equal(enc.attention_mask, jenc.attention_mask)
    assert [tok.decode(r) for r in enc.input_ids[:5]] == [jtok.decode(r) for r in jenc.input_ids[:5]]
    assert (enc.input_ids.max(), tok.eos_token_id) == (tok.vocab_size - 1, tok.vocab_size - 1)


def test_quick_gelu_and_trimmed_pad_len_match_jax():
    x = np.linspace(-8, 8, 1001, dtype=np.float32)
    np.testing.assert_allclose(layers.quick_gelu(torch.from_numpy(x)).numpy(),
                               np.asarray(j_quick_gelu(jnp.asarray(x))), atol=1e-6, rtol=0)
    assert layers.ACT2FN["quick_gelu"] is layers.quick_gelu
    for lengths in ((3, 5), (9,), (35, 2), (40,)):
        mask = np.zeros((len(lengths), 40), np.int32)
        for i, n in enumerate(lengths):
            mask[i, :n] = 1
        assert trimmed_pad_len(mask) == j_trimmed_pad_len(mask)
