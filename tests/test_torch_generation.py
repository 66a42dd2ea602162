"""Beam search (and nucleus sampling) of the port against the JAX package,
token for token in fp32 on the CPU, through blip_generate_ids (cross-K/V
grouped per item or replicated per beam), plus the fused filter's
device-side ITM ids.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vidil_tpu.config import MedConfig as JMed, ViTConfig as JViT
from vidil_tpu.models import blip as jblip, convert as jconvert
from vidil_tpu.models.testing import make_blip_decoder_ckpt
from vidil_tpu.ops.generation import GenerationConfig as JGen
from vidil_tpu.pipeline import fused_filter as jff
from vidil_tpu_torch.config import MedConfig
from vidil_tpu_torch.models import blip, convert
from vidil_tpu_torch.ops.generation import GenerationConfig, _topk_stable
from vidil_tpu_torch.pipeline import fused_filter as ff

torch.set_num_threads(1)

VIT_KW = dict(image_size=32, patch_size=16, hidden_size=32, num_layers=2, num_heads=4)
MED_KW = dict(vocab_size=120, hidden_size=32, num_layers=2, num_heads=4,
              intermediate_size=64, max_position_embeddings=64, encoder_width=32)
JM, PM = JMed(**MED_KW), MedConfig(**MED_KW)


@pytest.fixture(scope="module")
def model():
    jv = JViT(**VIT_KW)
    jp = jconvert.convert_blip_decoder(make_blip_decoder_ckpt(jv, JM, seed=3), jv, JM)
    tp = convert.from_jax_params(jax.tree.map(np.asarray, jp))
    embeds = np.random.default_rng(4).standard_normal((4, 5, 32), dtype=np.float32)
    prompt = np.repeat(np.array([[30, 5, 6, 7]], np.int32), 4, axis=0)
    return jp, tp, embeds, prompt


def _generate(model, beam_group_kv, **gen_kw):
    jp, tp, embeds, prompt = model
    want = np.asarray(jblip.blip_generate_ids(
        jp, jnp.asarray(embeds), jnp.asarray(prompt), JM, JGen(**gen_kw),
        beam_group_kv=beam_group_kv))
    got = blip.blip_generate_ids(tp, torch.from_numpy(embeds), torch.from_numpy(prompt), PM,
                                 GenerationConfig(**gen_kw), beam_group_kv=beam_group_kv)
    assert got.dtype == torch.int32
    return got.numpy(), want


# eos 13 is generated early by this seed's decoder, so finished hypotheses,
# the stop heuristic and the legacy finalize all take part
GEN = dict(max_length=14, min_length=5, num_beams=3, eos_token_id=13, pad_token_id=0)


@pytest.mark.parametrize("beam_group_kv", [False, True])
@pytest.mark.parametrize("length_norm", ["legacy", "modern"])
def test_beam_search_token_identical(model, beam_group_kv, length_norm):
    got, want = _generate(model, beam_group_kv, length_norm=length_norm, **GEN)
    np.testing.assert_array_equal(got, want)
    assert (want == GEN["eos_token_id"]).any()  # the fixture exercises eos


@pytest.mark.parametrize("gen_kw", [
    dict(repetition_penalty=1.3),
    dict(min_length=9, length_penalty=0.7),
    dict(num_beams=2, max_length=9),
])
def test_beam_search_processors_token_identical(model, gen_kw):
    got, want = _generate(model, True, **{**GEN, **gen_kw})
    np.testing.assert_array_equal(got, want)


def test_early_exit_gives_same_tokens(model):
    _, tp, embeds, prompt = model
    outs = [blip.blip_generate_ids(tp, torch.from_numpy(embeds), torch.from_numpy(prompt), PM,
                                   GenerationConfig(**GEN, early_exit=e), beam_group_kv=True)
            for e in (True, False)]
    torch.testing.assert_close(outs[0], outs[1], atol=0, rtol=0)


def test_topk_tie_order_is_lower_index_first():
    x = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0, float("-inf")]])
    vals, idx = _topk_stable(x, 4)
    assert idx.tolist() == [[1, 2, 4, 3]]
    _, jidx = jax.lax.top_k(jnp.asarray(x.numpy()), 4)
    assert np.asarray(jidx).tolist() == idx.tolist()


def test_sampling_is_not_ported(model):
    """Nucleus sampling through blip_generate_ids, which the port once
    refused: token-identical to the JAX package's when fed JAX's per-step
    Gumbel noise (keys = split(key, T); tests/test_torch_sampling.py holds
    the premise and the rest)."""
    jp, tp, embeds, prompt = model
    gen_kw = dict(GEN, num_beams=1, repetition_penalty=1.1, top_p=0.9)
    key = jax.random.PRNGKey(2)
    want = np.asarray(jblip.blip_generate_ids(
        jp, jnp.asarray(embeds), jnp.asarray(prompt), JM, JGen(**gen_kw), sample=True,
        rng_key=key))
    steps = GEN["max_length"] - prompt.shape[1]
    keys = jax.random.split(key, steps)
    noise = torch.from_numpy(np.stack([
        np.array(jax.random.gumbel(keys[t], (len(prompt), MED_KW["vocab_size"]), jnp.float32))
        for t in range(steps)]))
    got = blip.blip_generate_ids(tp, torch.from_numpy(embeds), torch.from_numpy(prompt), PM,
                                 GenerationConfig(**gen_kw), sample=True, noise=noise)
    np.testing.assert_array_equal(got.numpy(), want)


def test_itm_ids_from_seqs_matches_jax_and_mirror():
    rng = np.random.default_rng(5)
    seqs = rng.integers(1000, 1100, (6, 20)).astype(np.int32)
    seqs[:, :4] = [30, 5, 6, 7]
    seqs[0, 9] = 102            # [SEP] after 5 caption tokens
    seqs[1, 12:] = 0            # pad
    seqs[2, 4] = 102            # empty caption
    args = (4, 101, 102, 0, 24)
    ids, mask = ff.itm_ids_from_seqs(torch.from_numpy(seqs), *args)
    jids, jmask = jff.itm_ids_from_seqs(jnp.asarray(seqs), *args)
    nids, nmask = ff.itm_ids_from_seqs_np(seqs, *args)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    np.testing.assert_array_equal(ids.numpy(), nids)
    np.testing.assert_array_equal(mask.numpy(), nmask)
    for cfg in ({}, {"keep_original_caption": True},
                {"keep_original_caption": True, "filter_generated_only": True},
                {"caption": False}):
        assert ff.fused_applicable(cfg) == jff.fused_applicable(cfg)
