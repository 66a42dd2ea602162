"""Nucleus sampling of the port against the JAX package, in fp32 on the CPU.

torch and JAX draw different random streams, so sampling is held to JAX by
feeding the port JAX's own per-step Gumbel noise: jax.random.categorical
draws argmax(logits + gumbel(key)) (asserted first), and JAX's
nucleus_sample uses keys = split(rng_key, T), keys[cur_len - Lp] at each
step. With that noise the port's tokens must equal JAX's, token for token.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vidil_tpu.config import MedConfig as JMed, ViTConfig as JViT
from vidil_tpu.models import blip as jblip, convert as jconvert, med as jmed
from vidil_tpu.models.testing import make_blip_decoder_ckpt
from vidil_tpu.ops import generation as jgen
from vidil_tpu_torch.config import MedConfig
from vidil_tpu_torch.models import blip, convert, med
from vidil_tpu_torch.ops import generation as gen_ops
from vidil_tpu_torch.ops.generation import GenerationConfig

torch.set_num_threads(1)

VIT_KW = dict(image_size=32, patch_size=16, hidden_size=32, num_layers=2, num_heads=4)
MED_KW = dict(vocab_size=120, hidden_size=32, num_layers=2, num_heads=4,
              intermediate_size=64, max_position_embeddings=64, encoder_width=32)
JM, PM = JMed(**MED_KW), MedConfig(**MED_KW)
# the reference's sampling settings (top_p 0.9, repetition penalty 1.1);
# this seed's decoder draws eos 77 in some rows within the run, so finished
# rows and their pads take part
GEN = dict(max_length=16, min_length=5, num_beams=1, eos_token_id=77, pad_token_id=0,
           repetition_penalty=1.1, top_p=0.9)


def jax_noise(key, steps: int, B: int, V: int):
    """The Gumbel noise JAX's nucleus_sample adds at each step, (T, B, V)."""
    keys = jax.random.split(key, steps)
    return torch.from_numpy(np.stack([np.asarray(jax.random.gumbel(keys[t], (B, V), jnp.float32))
                                      for t in range(steps)]))


@pytest.fixture(scope="module")
def model():
    jv = JViT(**VIT_KW)
    jp = jconvert.convert_blip_decoder(make_blip_decoder_ckpt(jv, JM, seed=3), jv, JM)
    tp = convert.from_jax_params(jax.tree.map(np.asarray, jp))
    embeds = np.random.default_rng(4).standard_normal((6, 5, 32), dtype=np.float32)
    prompt = np.repeat(np.array([[30, 5, 6, 7]], np.int32), 6, axis=0)
    return jp, tp, embeds, prompt


def test_jax_categorical_is_gumbel_argmax():
    """The premise of every parity test here: jax.random.categorical(key, l)
    is argmax(l + gumbel(key, l.shape)), -inf entries included, and the
    port's gumbel_argmax gives the same draw from that noise."""
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((64, 50)).astype(np.float32) * 3
    logits[rng.random(logits.shape) < 0.4] = -np.inf
    for seed in range(5):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jax.random.categorical(key, jnp.asarray(logits), axis=-1))
        g = np.array(jax.random.gumbel(key, logits.shape, jnp.float32))
        np.testing.assert_array_equal(np.argmax(logits + g, axis=-1), want)
        got = gen_ops.gumbel_argmax(torch.from_numpy(logits), torch.from_numpy(g))
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("top_p", [0.1, 0.5, 0.9, 0.99])
def test_top_p_filter_matches_jax(top_p):
    """The kept sets equal JAX's on many random rows: peaked and flat rows,
    rows with -inf entries (min-length's eos mask) and with tied logits at
    the threshold."""
    rng = np.random.default_rng(1)
    rows = [rng.standard_normal((600, 61)) * s for s in (0.3, 1.0, 4.0)]
    tied = np.round(rng.standard_normal((300, 61)) * 2) / 2  # many exact ties
    masked = rng.standard_normal((300, 61)) * 2
    masked[:, 5] = -np.inf
    logits = np.concatenate(rows + [tied, masked]).astype(np.float32)
    want = np.asarray(jgen._top_p_filter(jnp.asarray(logits), top_p))
    got = gen_ops._top_p_filter(torch.from_numpy(logits), top_p).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_array_equal(got, want)
    assert (~np.isinf(got)).sum(axis=1).min() >= 1  # always one token left


def _decoder_closures(tp, jp, embeds):
    """The decoder's prefill/step closures in both packages over the same
    cross-attention memory (no beams)."""
    dec_j, dec_t = jp["text_decoder"], tp["text_decoder"]
    ck, cv = jmed.precompute_cross_kv(dec_j, jnp.asarray(embeds), JM)
    cb = jmed.invert_attention_mask(jnp.ones(embeds.shape[:2], jnp.int32))
    jc = jblip.make_decoder_closures(jp, ck, cv, cb, JM)
    tck, tcv = med.precompute_cross_kv(dec_t, torch.from_numpy(embeds), PM)
    tc = blip.make_decoder_closures(tp, tck, tcv, PM)
    return jc, tc


@pytest.mark.parametrize("early_exit", [True, False])
def test_nucleus_sample_token_identical_to_jax(model, early_exit):
    jp, tp, embeds, prompt = model
    B, Lp = prompt.shape
    gen_kw = dict(GEN, early_exit=early_exit)
    (jpre, jstep, _), (tpre, tstep, _) = _decoder_closures(tp, jp, embeds)
    key = jax.random.PRNGKey(11)
    want = np.asarray(jgen.nucleus_sample(
        jnp.asarray(prompt), jmed.init_self_cache(JM, B, GEN["max_length"]), jpre, jstep,
        jgen.GenerationConfig(**gen_kw), key))
    noise = jax_noise(key, GEN["max_length"] - Lp, B, MED_KW["vocab_size"])
    got = gen_ops.nucleus_sample(
        torch.from_numpy(prompt), med.init_self_cache(PM, B, GEN["max_length"]), tpre, tstep,
        GenerationConfig(**gen_kw), noise=noise)
    assert got.dtype == torch.int32 and got.shape == (B, GEN["max_length"])
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want[:, :Lp], prompt)
    assert (want == GEN["eos_token_id"]).any()  # finished rows take part
    for row in want:  # pad after eos
        eos = np.flatnonzero(row[Lp:] == GEN["eos_token_id"])
        if len(eos):
            assert (row[Lp + eos[0] + 1:] == GEN["pad_token_id"]).all()
            assert Lp + eos[0] >= GEN["min_length"]


@pytest.mark.parametrize("seed", [0, 7])
def test_blip_generate_ids_sample_token_identical_to_jax(model, seed):
    jp, tp, embeds, prompt = model
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jblip.blip_generate_ids(
        jp, jnp.asarray(embeds), jnp.asarray(prompt), JM, jgen.GenerationConfig(**GEN),
        sample=True, rng_key=key))
    noise = jax_noise(key, GEN["max_length"] - prompt.shape[1], prompt.shape[0],
                      MED_KW["vocab_size"])
    got = blip.blip_generate_ids(tp, torch.from_numpy(embeds), torch.from_numpy(prompt), PM,
                                 GenerationConfig(**GEN), sample=True, noise=noise)
    np.testing.assert_array_equal(got.numpy(), want)


def test_sampling_draws_from_the_generator(model):
    """A generator seeded alike gives the same tokens; another seed gives
    others; nucleus_sample refuses to run with neither noise nor
    generator."""
    _, tp, embeds, prompt = model

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        return blip.blip_generate_ids(tp, torch.from_numpy(embeds), torch.from_numpy(prompt),
                                      PM, GenerationConfig(**GEN), sample=True, generator=g)

    a, b, c = run(0), run(0), run(1)
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert not torch.equal(a[:, prompt.shape[1]:], c[:, prompt.shape[1]:])
    with pytest.raises(ValueError):
        blip.blip_generate_ids(tp, torch.from_numpy(embeds), torch.from_numpy(prompt), PM,
                               GenerationConfig(**GEN), sample=True)


def test_gumbel_noise_draws_are_finite_and_seeded():
    g = torch.Generator().manual_seed(3)
    x = gen_ops.gumbel_noise((4096, 8), g, "cpu")
    assert torch.isfinite(x).all()
    # a standard Gumbel has mean Euler's gamma and variance pi^2 / 6
    assert abs(x.mean().item() - 0.5772) < 0.03
    assert abs(x.var().item() - np.pi ** 2 / 6) < 0.1
    y = gen_ops.gumbel_noise((4096, 8), torch.Generator().manual_seed(3), "cpu")
    torch.testing.assert_close(x, y, atol=0, rtol=0)
