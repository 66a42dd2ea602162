"""The decode's variants in the port against the JAX package, fp32 on the CPU:
int8 cross-K/V (`cross_kv_int8`: True stores the memory as per-row int8,
"dot" also runs the attention products int8 x int8), the per-layer cache
(`decode_layer_unroll`) and the ancestry-gather beam reorder
(`decode_lazy_reorder`).

Counterparts of tests/test_cross_kv_int8.py and tests/test_generation.py's
decode-structure tests, each run on the port and held to the JAX function
on the same inputs. The int8 products must be exact (the JAX dots
accumulate in int32); the "dot" context may differ from JAX's only where a
probability's int8 rounding flipped (an ulp of difference in the fp32
softmax that lands on a rounding tie): each flip moves the context by one
int8 step of p8 times the V8 entry, and that is the bar.
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
# quantization and the int8 attention block
# ---------------------------------------------------------------------------

def test_quantize_roundtrip_error_bound():
    k = _kv(0, (2, 3, 4, 7, 8))
    kq, vq = med.quantize_cross_kv(_t(k), _t(k * 2.0))
    deq = kq["q8"].float() * kq["scale"]
    # per-row absmax/127 symmetric quantization: |err| <= scale/2 per entry
    assert float((deq - _t(k)).abs().sub(kq["scale"] / 2).max()) <= 1e-6
    deq_v = vq["q8"].float() * vq["scale"]
    torch.testing.assert_close(deq_v, deq * 2.0, atol=1e-5, rtol=0)
    # the JAX package's quantization, bit for bit
    jkq, jvq = jmed.quantize_cross_kv(jnp.asarray(k), jnp.asarray(k * 2.0))
    for got, want in ((kq, jkq), (vq, jvq)):
        assert got["q8"].dtype == torch.int8 and got["scale"].dtype == torch.float32
        np.testing.assert_array_equal(got["q8"].numpy(), np.asarray(want["q8"]))
        np.testing.assert_array_equal(got["scale"].numpy(), np.asarray(want["scale"]))


@pytest.mark.parametrize("beam_size", [1, 3])
def test_scale_factoring_exact(beam_size):
    """The quantized memory through the block == its dequantized tensors fed
    to the same block (the scale factoring adds no error), and the block
    matches JAX's on the quantized memory."""
    H, Lk, Dh, B = 4, 6, 8, 2
    jl, tl = _cross_layer0(1)
    x = _kv(2, (B * beam_size, 3, CFG_KW["hidden_size"]))
    k, v = _kv(3, (B, H, Lk, Dh)), _kv(4, (B, H, Lk, Dh))
    kq, vq = med.quantize_cross_kv(_t(k), _t(v))
    k_deq, v_deq = kq["q8"].float() * kq["scale"], vq["q8"].float() * vq["scale"]
    eps = PM.layer_norm_eps
    out_q = med._attn_block_precomputed_kv(tl, _t(x), kq, vq, None, H, eps, beam_size=beam_size)
    out_d = med._attn_block_precomputed_kv(tl, _t(x), k_deq, v_deq, None, H, eps,
                                           beam_size=beam_size)
    torch.testing.assert_close(out_q, out_d, rtol=1e-5, atol=1e-5)
    jkq, jvq = jmed.quantize_cross_kv(jnp.asarray(k), jnp.asarray(v))
    want = np.asarray(jmed._attn_block_precomputed_kv(jl, jnp.asarray(x), jkq, jvq, None, H, eps,
                                                      beam_size=beam_size))
    np.testing.assert_allclose(out_q.numpy(), want, atol=3e-5, rtol=0)


@pytest.mark.parametrize("beam_group_kv,mode", [(False, True), (True, True), (True, "dot")])
def test_generate_int8_runs_and_tracks_fp(beam_group_kv, mode):
    """int8 generation against the fp decode (majority agreement, as in
    JAX: rounding may flip a beam choice on a random tiny model) and
    against JAX's int8 generation (token-identical)."""
    jp, tp = _decoder(3)
    B, Lp, nb, max_len = 2, 3, 3, 14
    prompt = np.random.RandomState(5).randint(6, 61, size=(B, Lp)).astype(np.int32)
    enc = _kv(9, (B, 5, CFG_KW["encoder_width"]))
    gen_kw = dict(max_length=max_len, min_length=5, num_beams=nb, eos_token_id=EOS,
                  pad_token_id=PAD)
    fp = blip.blip_generate_ids(tp, _t(enc), _t(prompt), PM, GenerationConfig(**gen_kw),
                                beam_group_kv=beam_group_kv).numpy()
    got, want = _generate(jp, tp, enc, prompt, gen_kw, beam_group_kv=beam_group_kv,
                          cross_kv_int8=mode)
    assert got.shape == fp.shape
    assert float(np.mean(got == fp)) >= 0.5
    np.testing.assert_array_equal(got, want)


def test_generate_int8_exact_when_rows_representable(monkeypatch):
    """Cross-K/V whose rows are exact int8 multiples quantize losslessly, so
    int8 generation is token-IDENTICAL to the fp decode on the same (snapped)
    memory — any fault in the scale plumbing shows here."""
    jp, tp = _decoder(7)
    B, Lp, nb, max_len = 2, 3, 3, 12
    prompt = np.random.RandomState(11).randint(6, 61, size=(B, Lp)).astype(np.int32)
    enc = _kv(13, (B, 5, CFG_KW["encoder_width"]))
    gen = GenerationConfig(max_length=max_len, min_length=5, num_beams=nb, eos_token_id=EOS,
                           pad_token_id=PAD)
    k, v = med.precompute_cross_kv(tp["text_decoder"], _t(enc), PM)
    kq, vq = med.quantize_cross_kv(k, v)
    snapped = (kq["q8"].float() * kq["scale"], vq["q8"].float() * vq["scale"])
    monkeypatch.setattr(med, "precompute_cross_kv", lambda *a, **kw: snapped)
    fp = blip.blip_generate_ids(tp, _t(enc), _t(prompt), PM, gen, beam_group_kv=True)
    q8 = blip.blip_generate_ids(tp, _t(enc), _t(prompt), PM, gen, beam_group_kv=True,
                                cross_kv_int8=True)
    torch.testing.assert_close(q8, fp, atol=0, rtol=0)


def _jax_int8_dot_context(q5, kq, vq, scale):
    """The JAX package's int8-dot context (models/med.py's grouped branch),
    with its p8 and ps: int32 products, fp32 scales."""
    qs = jnp.maximum(jnp.max(jnp.abs(q5), axis=-1, keepdims=True).astype(jnp.float32),
                     1e-12) / 127.0
    q8 = jnp.clip(jnp.round(q5.astype(jnp.float32) / qs), -127, 127).astype(jnp.int8)
    logits = jnp.einsum("bnhqd,bhkd->bnhqk", q8, kq["q8"], preferred_element_type=jnp.int32)
    logits = logits.astype(jnp.float32) * (qs * scale) * kq["scale"][:, None, :, None, :, 0]
    probs = jax.nn.softmax(logits, axis=-1)
    pv = probs * vq["scale"][:, None, :, None, :, 0]
    ps = jnp.maximum(jnp.max(pv, axis=-1, keepdims=True), 1e-20) / 127.0
    p8 = jnp.clip(jnp.round(pv / ps), -127, 127).astype(jnp.int8)
    ctx = jnp.einsum("bnhqk,bhkd->bnhqd", p8, vq["q8"], preferred_element_type=jnp.int32)
    return np.asarray(ctx.astype(jnp.float32) * ps), np.asarray(p8), np.asarray(ps)


@pytest.mark.parametrize("Lk,peaked", [(400, False), (2308, False), (2308, True)])
def test_int8_dot_context_error_bound(Lk, peaked, record_property):
    """'dot' against the int8 store on long memories (a hot key per row
    included): the block outputs within 1e-3, as in JAX. Against JAX: the
    int8 x int8 products equal JAX's int32 dots exactly, at Lk 2308 too
    (past the 1040 keys an fp32 sum of int8 products holds exactly), and
    the context differs only by the flipped p8 entries: |ctx - ctx_jax| <=
    ps * sum over flipped keys of |dp8| |V8| (plus fp32 rounding)."""
    H, Dh, B, nb = 4, 8, 2, 3
    jl, tl = _cross_layer0(1)
    x = _kv(2, (B * nb, 1, CFG_KW["hidden_size"]))
    k, v = _kv(3, (B, H, Lk, Dh)), _kv(4, (B, H, Lk, Dh))
    if peaked:
        k[:, :, 0] *= 4.0  # a hot key per row -> a long near-zero tail
    eps = PM.layer_norm_eps
    kq, vq = med.quantize_cross_kv(_t(k), _t(v))
    out_store = med._attn_block_precomputed_kv(tl, _t(x), kq, vq, None, H, eps, beam_size=nb)
    out_dot = med._attn_block_precomputed_kv(tl, _t(x), kq, vq, None, H, eps, beam_size=nb,
                                             int8_dot=True)
    torch.testing.assert_close(out_dot, out_store, rtol=0, atol=1e-3)

    # the exact int8 products, both operands int8
    a8 = np.random.default_rng(Lk).integers(-127, 128, (B, H, 3, Lk)).astype(np.int8)
    want_int = np.asarray(jnp.einsum("bhqk,bhkd->bhqd", jnp.asarray(a8), jnp.asarray(vq["q8"]),
                                     preferred_element_type=jnp.int32))
    got_int = med.int8_matmul(_t(a8), vq["q8"]).numpy()
    np.testing.assert_array_equal(got_int, want_int.astype(got_int.dtype))
    full = np.full((B, H, 3, Lk), 127, np.int8)  # the largest sums: 127**2 * Lk
    np.testing.assert_array_equal(
        med.int8_matmul(_t(full), torch.full((B, H, Lk, Dh), 127, dtype=torch.int8)).numpy(),
        np.full((B, H, 3, Dh), 127 * 127 * Lk))

    # the context against JAX's, on the same q
    q = med.split_heads(med.linear(tl["query"], _t(x)), H)
    q5 = q.reshape(B, nb, H, 1, Dh)
    scale = 1.0 / np.sqrt(Dh)
    got = med._int8_dot_attention(q5, kq, vq, None, scale).numpy()
    jkq, jvq = jmed.quantize_cross_kv(jnp.asarray(k), jnp.asarray(v))
    want, p8_j, ps_j = _jax_int8_dot_context(jnp.asarray(q5.numpy()), jkq, jvq, scale)
    # that context is JAX's: its block output from it is the JAX function's
    from vidil_tpu.models import layers as jlayers

    jctx = jlayers.merge_heads(jnp.asarray(want).reshape(B * nb, H, 1, Dh))
    jblock = jlayers.layer_norm(jl["norm"], jlayers.linear(jl["out"], jctx) + jnp.asarray(x), eps)
    np.testing.assert_allclose(np.asarray(jblock), np.asarray(jmed._attn_block_precomputed_kv(
        jl, jnp.asarray(x), jkq, jvq, None, H, eps, beam_size=nb, int8_dot=True)),
        atol=1e-6, rtol=0)
    p8, _ = med._int8_dot_probs(q5, kq, vq, None, scale)
    p8 = p8.numpy()
    dp8 = np.abs(p8.astype(np.int32) - p8_j.astype(np.int32))  # (B, nb, H, 1, Lk)
    flips = int((dp8 > 0).sum())
    record_property("p8_flips", flips)
    assert dp8.max() <= 1
    v8 = np.abs(np.asarray(jvq["q8"]).astype(np.float64))  # (B, H, Lk, Dh)
    bar = np.einsum("bnhqk,bhkd->bnhqd", dp8.astype(np.float64), v8) * ps_j
    fp32 = 4 * np.finfo(np.float32).eps * np.abs(want) + 1e-7
    print(f"Lk {Lk} peaked {peaked}: {flips} flipped p8 entries of {p8.size}")
    assert (np.abs(got - want) <= bar + fp32).all(), f"{flips} flipped p8 entries"


# ---------------------------------------------------------------------------
# decode structure: per-layer cache and lazy reorder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("unroll,lazy", [(True, False), (False, True), (True, True)])
def test_decode_restructure_flags_bit_identical(unroll, lazy):
    """decode_layer_unroll / decode_lazy_reorder change the cache's layout
    and the beam reorder, not the tokens: identical to the stock decode on
    every beam_group_kv x cross_kv_int8 combination, and to JAX's decode
    with the same flags."""
    jp, tp = _decoder(3)
    B, Lp, nb, max_len = 2, 3, 3, 14
    prompt = np.random.RandomState(5).randint(6, 61, size=(B, Lp)).astype(np.int32)
    enc = _kv(9, (B, 5, CFG_KW["encoder_width"]))
    gen_kw = dict(max_length=max_len, min_length=5, num_beams=nb, eos_token_id=EOS,
                  pad_token_id=PAD)
    for group, int8 in ((False, False), (True, False), (True, True), (True, "dot")):
        stock = blip.blip_generate_ids(tp, _t(enc), _t(prompt), PM, GenerationConfig(**gen_kw),
                                       beam_group_kv=group, cross_kv_int8=int8).numpy()
        got, want = _generate(jp, tp, enc, prompt, gen_kw, beam_group_kv=group,
                              cross_kv_int8=int8, decode_layer_unroll=unroll,
                              decode_lazy_reorder=lazy)
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
        _, cache = med.med_decode_prefill(dec, ids, cache, None, None, None, PM)
        cache = med.reorder_cache(cache, torch.tensor([2, 0, 0]))
        logits, cache = med.med_decode_step(dec, torch.tensor([7, 8, 9]), Lp, cache, None, None,
                                            None, PM)
        cache = med.reorder_cache(cache, torch.tensor([1, 1, 2]))
        logits2, cache = med.med_decode_step(dec, torch.tensor([10, 11, 12]), Lp + 1, cache,
                                             None, None, None, PM)
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
