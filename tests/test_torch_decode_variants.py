"""The decode's variants in the port against the JAX package, fp32 on the CPU:
the cross-attention block over a precomputed memory (grouped across the
beams, or one row per beam), the per-layer cache (`decode_layer_unroll`)
and the ancestry-gather beam reorder (`decode_lazy_reorder`).

Counterparts of tests/test_generation.py's decode-structure tests, each
run on the port and held to the JAX function on the same inputs.
"""

import tempfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vidil_tpu.config import MedConfig as JMed
from vidil_tpu.models import blip as jblip, blip_vqa as jvqa, med as jmed
from vidil_tpu.ops.generation import GenerationConfig as JGen
from vidil_tpu_torch.config import MedConfig
from vidil_tpu_torch.models import blip, blip_vqa, convert, med
from vidil_tpu_torch.ops.generation import GenerationConfig

torch.set_num_threads(1)

CFG_KW = dict(vocab_size=61, hidden_size=32, num_layers=2, num_heads=4,
              intermediate_size=64, max_position_embeddings=64, encoder_width=32)
JM, PM = JMed(**CFG_KW), MedConfig(**CFG_KW)
EOS, PAD = 5, 0


def _port(tree):
    return convert.from_jax_params(jax.tree.map(np.asarray, tree))


def _t(x):
    return torch.from_numpy(np.array(x))


def _decoder(seed):
    jp = jmed.init_med(jax.random.PRNGKey(seed), JM, with_lm_head=True)
    return {"text_decoder": jp}, {"text_decoder": _port(jp)}


def _generate(jparams, tparams, enc, prompt, gen_kw, **kw):
    """Both packages' blip_generate_ids on the same inputs."""
    want = np.asarray(jblip.blip_generate_ids(jparams, jnp.asarray(enc), jnp.asarray(prompt),
                                              JM, JGen(**gen_kw), **kw))
    got = blip.blip_generate_ids(tparams, _t(enc), _t(prompt), PM, GenerationConfig(**gen_kw),
                                 **kw).numpy()
    return got, want


def _cross_layer0(seed):
    jl = jax.tree.map(lambda x: x[0], jmed.init_med(jax.random.PRNGKey(seed), JM)["layers"])
    return jl["cross_attn"], _port(jl["cross_attn"])


def _kv(key_seed, shape):
    return np.array(jax.random.normal(jax.random.PRNGKey(key_seed), shape))


# ---------------------------------------------------------------------------
# the cross-attention block over a precomputed memory
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("beam_size", [1, 3])
def test_grouped_cross_attention_matches_jax(beam_size):
    """The decode's cross-attention block on a precomputed fp32 memory
    matches JAX's on the same memory; at beam size 3 the grouped block
    (the beams of one item share its memory row) matches the beam-size-1
    block over the memory repeated per beam."""
    H, Lk, Dh, B = 4, 6, 8, 2
    jl, tl = _cross_layer0(1)
    x = _kv(2, (B * beam_size, 3, CFG_KW["hidden_size"]))
    k, v = _kv(3, (B, H, Lk, Dh)), _kv(4, (B, H, Lk, Dh))
    eps = PM.layer_norm_eps
    out = med._attn_block_precomputed_kv(tl, _t(x), _t(k), _t(v), eps, beam_size=beam_size)
    want = np.asarray(jmed._attn_block_precomputed_kv(jl, jnp.asarray(x), jnp.asarray(k),
                                                      jnp.asarray(v), None, H, eps,
                                                      beam_size=beam_size))
    np.testing.assert_allclose(out.numpy(), want, atol=5e-6, rtol=0)
    if beam_size > 1:
        k_rep, v_rep = (_t(a).repeat_interleave(beam_size, 0) for a in (k, v))
        flat = med._attn_block_precomputed_kv(tl, _t(x), k_rep, v_rep, eps)
        torch.testing.assert_close(out, flat, rtol=0, atol=2e-6)


# ---------------------------------------------------------------------------
# decode structure: per-layer cache and lazy reorder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("unroll,lazy", [(True, False), (False, True), (True, True)])
def test_decode_restructure_flags_bit_identical(unroll, lazy):
    """decode_layer_unroll / decode_lazy_reorder change the cache's layout
    and the beam reorder, not the tokens: identical to the stock decode
    with and without beam_group_kv, and to JAX's decode with the same
    flags."""
    jp, tp = _decoder(3)
    B, Lp, nb, max_len = 2, 3, 3, 14
    prompt = np.random.RandomState(5).randint(6, 61, size=(B, Lp)).astype(np.int32)
    enc = _kv(9, (B, 5, CFG_KW["encoder_width"]))
    gen_kw = dict(max_length=max_len, min_length=5, num_beams=nb, eos_token_id=EOS,
                  pad_token_id=PAD)
    for group in (False, True):
        stock = blip.blip_generate_ids(tp, _t(enc), _t(prompt), PM, GenerationConfig(**gen_kw),
                                       beam_group_kv=group).numpy()
        got, want = _generate(jp, tp, enc, prompt, gen_kw, beam_group_kv=group,
                              decode_layer_unroll=unroll, decode_lazy_reorder=lazy)
        np.testing.assert_array_equal(got, stock)
        np.testing.assert_array_equal(got, want)


def test_decode_restructure_sample_path_bit_identical():
    """Sampling with decode_layer_unroll (and the lazy reorder, which the
    sample path drops) equals stock sampling and JAX's under JAX's noise."""
    jp, tp = _decoder(1)
    B, Lp, max_len = 4, 3, 18
    prompt = np.random.RandomState(4).randint(6, 61, size=(B, Lp)).astype(np.int32)
    enc = _kv(2, (B, 5, CFG_KW["encoder_width"]))
    gen_kw = dict(max_length=max_len, min_length=8, eos_token_id=EOS, pad_token_id=PAD,
                  repetition_penalty=1.1, top_p=0.9)
    key = jax.random.PRNGKey(0)
    keys = jax.random.split(key, max_len - Lp)
    noise = torch.from_numpy(np.stack([np.array(jax.random.gumbel(k, (B, 61), jnp.float32))
                                       for k in keys]))
    want = np.asarray(jblip.blip_generate_ids(jp, jnp.asarray(enc), jnp.asarray(prompt), JM,
                                              JGen(**gen_kw), sample=True, rng_key=key,
                                              decode_layer_unroll=True,
                                              decode_lazy_reorder=True))
    outs = [blip.blip_generate_ids(tp, _t(enc), _t(prompt), PM, GenerationConfig(**gen_kw),
                                   sample=True, noise=noise, **kw).numpy()
            for kw in ({}, dict(decode_layer_unroll=True, decode_lazy_reorder=True))]
    np.testing.assert_array_equal(outs[1], outs[0])
    np.testing.assert_array_equal(outs[1], want)


def test_lazy_reorder_reads_the_physically_reordered_cache():
    """One reorder + step: the lazy cache's reads through anc equal the
    rows a physical reorder moves, and the step's logits are equal."""
    jp, tp = _decoder(2)
    dec = tp["text_decoder"]
    B, Lp, T = 3, 2, 8
    ids = _t(np.random.RandomState(1).randint(6, 61, size=(B, Lp)).astype(np.int32))
    outs = []
    for lazy in (False, True):
        cache = med.init_self_cache(PM, B, T, unrolled=lazy, lazy_reorder=lazy)
        _, cache = med.med_decode_prefill(dec, ids, cache, None, None, PM)
        cache = med.reorder_cache(cache, torch.tensor([2, 0, 0]))
        logits, cache = med.med_decode_step(dec, torch.tensor([7, 8, 9]), Lp, cache, None, None,
                                            PM)
        cache = med.reorder_cache(cache, torch.tensor([1, 1, 2]))
        logits2, cache = med.med_decode_step(dec, torch.tensor([10, 11, 12]), Lp + 1, cache,
                                             None, None, PM)
        outs.append((logits, logits2, cache))
    torch.testing.assert_close(outs[1][0], outs[0][0], atol=0, rtol=0)
    torch.testing.assert_close(outs[1][1], outs[0][1], atol=0, rtol=0)
    anc = outs[1][2]["anc"]
    assert anc.dtype == torch.int32
    pos = torch.arange(T)[None, :]
    for i in range(PM.num_layers):
        lazy_k = outs[1][2]["k"][i][anc, pos]
        torch.testing.assert_close(lazy_k[:, :Lp + 2], outs[0][2]["k"][i][:, :Lp + 2], atol=0,
                                   rtol=0)


@pytest.mark.parametrize("unroll,lazy", [(True, False), (False, True)])
def test_vqa_generate_decode_structure_flags(unroll, lazy):
    """vqa_generate_ids takes the two decode-structure flags: the answers
    are token-identical to its stock decode and to JAX's with the flags."""
    from vidil_tpu.tokenizer import BlipTokenizer, write_test_vocab

    with tempfile.TemporaryDirectory() as tmp:
        vocab = f"{tmp}/vocab.txt"
        write_test_vocab(vocab, ["what", "is", "a", "man", "dog", "yes", "no"])
        tok = BlipTokenizer(vocab)
    cfg_kw = dict(CFG_KW, vocab_size=tok.vocab_size)
    jcfg, pcfg = JMed(**cfg_kw), MedConfig(**cfg_kw)
    jp = {"text_encoder": jmed.init_med(jax.random.PRNGKey(4), jcfg),
          "text_decoder": jmed.init_med(jax.random.PRNGKey(5), jcfg, with_lm_head=True)}
    tp = _port(jp)
    rng = np.random.RandomState(3)
    video = rng.randn(2, 7, 32).astype(np.float32)
    qids = rng.randint(5, tok.vocab_size, size=(2, 6)).astype(np.int32)
    qmask = np.ones_like(qids)
    kw = dict(max_length=8, num_beams=3, beam_group_kv=True)
    want = np.asarray(jvqa.vqa_generate_ids(jp, jnp.asarray(video), jnp.asarray(qids),
                                            jnp.asarray(qmask), jcfg, tok,
                                            decode_layer_unroll=unroll,
                                            decode_lazy_reorder=lazy, **kw))
    stock = blip_vqa.vqa_generate_ids(tp, _t(video), _t(qids), _t(qmask), pcfg, tok, **kw)
    got = blip_vqa.vqa_generate_ids(tp, _t(video), _t(qids), _t(qmask), pcfg, tok,
                                    decode_layer_unroll=unroll, decode_lazy_reorder=lazy, **kw)
    torch.testing.assert_close(got, stock, atol=0, rtol=0)
    np.testing.assert_array_equal(got.numpy(), want)
