"""The port's SBERT MPNet encoder (vidil_tpu_torch/models/mpnet.py) against
the JAX package's (vidil_tpu/models/mpnet.py) on the CPU in fp32, on a tiny
transformers MPNetModel built from a config (hidden 32, 2 layers, 4 heads):
bucket math, position bias, forward, pooling, the weights carried across,
the tokenizer, the local-snapshot encoder (.bin and .safetensors), the
safetensors reader, and the refusals (a model name, CUDA without a card).
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from vidil_tpu.models import mpnet as jm
from vidil_tpu_torch.models import mpnet as pm
from vidil_tpu_torch.models.convert import from_jax_params

torch.set_num_threads(1)

KW = dict(vocab_size=120, hidden_size=32, num_layers=2, num_heads=4,
          intermediate_size=64, max_position_embeddings=64)
JCFG, PCFG = jm.MPNetConfig(**KW), pm.MPNetConfig(**KW)
# the JAX package's own bar against HF MPNetModel (tests/test_mpnet.py:46)
FWD_ATOL = 5e-5
# unit-norm fp32 embeddings: a few fp32 ulps of |e| <= 1 after the pooling sums
EMBED_ATOL = 1e-5
MAX_L = 514  # all-mpnet-base-v2's max_position_embeddings


@pytest.fixture(scope="module")
def hf_mpnet():
    from transformers import MPNetConfig as HFCfg
    from transformers import MPNetModel

    cfg = HFCfg(vocab_size=KW["vocab_size"], hidden_size=KW["hidden_size"],
                num_hidden_layers=KW["num_layers"], num_attention_heads=KW["num_heads"],
                intermediate_size=KW["intermediate_size"],
                max_position_embeddings=KW["max_position_embeddings"],
                hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    torch.manual_seed(0)
    m = MPNetModel(cfg, add_pooling_layer=False)
    m.eval()
    return m


@pytest.fixture(scope="module")
def params(hf_mpnet):
    sd = dict(hf_mpnet.state_dict())
    return jm.convert_mpnet(sd, JCFG), pm.convert_mpnet(sd, PCFG)


def _batch(seed, B=3, L=40):
    """Random ids with padded rows: row 1 padded from 30, row 2 from 5. L
    <= max_position_embeddings - 2: position ids start after the pad id."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(4, KW["vocab_size"], size=(B, L)).astype(np.int32)
    ids[1, 30:] = 1
    ids[2, 5:] = 1
    return ids, (ids != 1).astype(np.int32)


def test_relative_position_bucket_matches_jax_at_every_length():
    """Integer-identical buckets for every L in 1..514: the JAX package's
    buckets of the (514, 514) grid hold every relative position up to
    +-513; each L's grid is its top-left (L, L) block, which the JAX
    function also gives when called at that L (checked at the edges)."""
    pos = np.arange(MAX_L, dtype=np.int32)
    want = np.asarray(jm.relative_position_bucket(jnp.asarray(pos[None, :] - pos[:, None])))
    for L in range(1, MAX_L + 1):
        p = torch.arange(L)
        got = pm.relative_position_bucket(p[None, :] - p[:, None])
        np.testing.assert_array_equal(got.numpy(), want[:L, :L], err_msg=f"L={L}")
    for L in (1, 2, 8, 9, 17, 33, 65, 128, 129, 513):
        q = np.arange(L, dtype=np.int32)
        np.testing.assert_array_equal(
            np.asarray(jm.relative_position_bucket(jnp.asarray(q[None, :] - q[:, None]))),
            want[:L, :L])
        np.testing.assert_array_equal(pm._buckets(L, 32).numpy(), want[:L, :L])
    assert want.min() == 0 and want.max() == 31


@pytest.mark.parametrize("L", [1, 9, 128, MAX_L])
def test_compute_position_bias_is_exact(L):
    table = np.random.RandomState(L).randn(32, 12).astype(np.float32)
    want = np.asarray(jm.compute_position_bias(jnp.asarray(table), L))
    got = pm.compute_position_bias(torch.from_numpy(table), L).numpy()
    assert got.shape == (1, 12, L, L)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed,L", [(0, 40), (1, 9), (2, 62)])
def test_mpnet_forward_matches_jax_and_hf(hf_mpnet, params, seed, L):
    jp, pp = params
    ids, mask = _batch(seed, L=L)
    want = np.asarray(jm.mpnet_forward(jp, jnp.asarray(ids), jnp.asarray(mask), JCFG))
    got = pm.mpnet_forward(pp, torch.from_numpy(ids).long(), torch.from_numpy(mask), PCFG)
    np.testing.assert_allclose(got.numpy(), want, atol=FWD_ATOL, rtol=0)
    with torch.no_grad():
        hf = hf_mpnet(torch.from_numpy(ids).long(),
                      attention_mask=torch.from_numpy(mask)).last_hidden_state.numpy()
    np.testing.assert_allclose(got.numpy(), hf, atol=FWD_ATOL, rtol=0)


def test_sbert_embed_matches_jax(params):
    jp, pp = params
    ids, mask = _batch(3)
    want = np.asarray(jm.sbert_embed(jp, jnp.asarray(ids), jnp.asarray(mask), JCFG))
    got = pm.sbert_embed(pp, torch.from_numpy(ids).long(), torch.from_numpy(mask), PCFG).numpy()
    np.testing.assert_allclose(got, want, atol=EMBED_ATOL, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-6)


def test_params_carried_from_jax_give_the_same_outputs(params):
    """from_jax_params of the JAX package's pytree (stacked layers, a bare
    relative_attention_bias leaf) is the port's converted tree, leaf for
    leaf, and gives the same forward."""
    jp, pp = params
    carried = from_jax_params(jax.tree.map(np.asarray, jp))
    assert len(carried["layers"]) == KW["num_layers"]
    assert isinstance(carried["relative_attention_bias"], torch.Tensor)
    for (a, x), (b, y) in zip(sorted(_leaves(carried)), sorted(_leaves(pp))):
        assert a == b and torch.equal(x, y), a
    ids, mask = _batch(4)
    args = (torch.from_numpy(ids).long(), torch.from_numpy(mask), PCFG)
    assert torch.equal(pm.mpnet_forward(carried, *args), pm.mpnet_forward(pp, *args))


def _leaves(tree, prefix=""):
    from vidil_tpu_torch.models.convert import named_leaves

    return named_leaves(tree, prefix)


def test_hf_state_dict_round_trip_and_synthetic_shapes(hf_mpnet, params):
    """to_hf_state_dict inverts convert_mpnet (chip_smoke.py writes its
    full-width snapshot with it), and mpnet_shapes is the converted tree's
    layout, stacked as the JAX package stacks it."""
    from vidil_tpu_torch.utils.synth import synth_tree

    _, pp = params
    sd = dict(hf_mpnet.state_dict())
    back = pm.to_hf_state_dict(pp)
    assert set(back) == set(sd) - {"embeddings.position_ids"}
    assert all(torch.equal(back[k], sd[k]) for k in back)
    synth = from_jax_params(synth_tree(pm.mpnet_shapes(PCFG), "cpu"))
    again = pm.convert_mpnet(pm.to_hf_state_dict(synth), PCFG)
    for (a, x), (b, y) in zip(sorted(_leaves(synth)), sorted(_leaves(again))):
        assert a == b and torch.equal(x, y), a


# tests/test_mpnet.py's vocab words, after the specials
TEST_WORDS = ["a", "video", "of", "cat", "##s", "dog", "running", "the", "person", "play",
              "##ing", "!"]
TEXTS = ["a video of cats", "the dog running!", "person playing",
         "A Video OF unknownword dogs", ""]
# max_length 128 (the encoders' default) needs 130 positions: the
# RoBERTa-style ids start after the pad id
SNAPSHOT_POSITIONS = 130


def write_tiny_snapshot(root, words, seed=0, fmt="bin"):
    """A local SBERT snapshot of a tiny random transformers MPNetModel
    (hidden 32, 2 layers, 4 heads) whose vocab holds the specials and
    `words`: config.json, vocab.txt and pytorch_model.bin, or
    model.safetensors with a sentence-transformers "mpnet." key prefix."""
    from transformers import MPNetConfig as HFCfg
    from transformers import MPNetModel

    os.makedirs(root, exist_ok=True)
    vocab = ["<s>", "<pad>", "</s>", "<unk>", "[UNK]"] + list(dict.fromkeys(words)) + ["<mask>"]
    with open(os.path.join(root, "vocab.txt"), "w") as f:
        f.write("\n".join(vocab) + "\n")
    cfg = {"vocab_size": len(vocab), "hidden_size": 32, "num_hidden_layers": 2,
           "num_attention_heads": 4, "intermediate_size": 64,
           "max_position_embeddings": SNAPSHOT_POSITIONS}
    with open(os.path.join(root, "config.json"), "w") as f:
        json.dump(cfg, f)
    torch.manual_seed(seed)
    model = MPNetModel(HFCfg(**cfg, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0),
                       add_pooling_layer=False)
    if fmt == "bin":
        torch.save(model.state_dict(), os.path.join(root, "pytorch_model.bin"))
    else:
        from safetensors.torch import save_file

        save_file({"mpnet." + k: v.contiguous() for k, v in model.state_dict().items()},
                  os.path.join(root, "model.safetensors"))
    return str(root)


def jax_encoder(root, dtype, **kw):
    """The JAX package's encoder of a write_tiny_snapshot directory in
    `dtype` (its make_sbert_encoder fixes bf16)."""
    from vidil_tpu.models.convert import load_torch_state_dict
    from vidil_tpu.tokenizer import MPNetTokenizer

    with open(os.path.join(root, "config.json")) as f:
        hf = json.load(f)
    cfg = jm.MPNetConfig(vocab_size=hf["vocab_size"], hidden_size=hf["hidden_size"],
                         num_layers=hf["num_hidden_layers"],
                         num_heads=hf["num_attention_heads"],
                         intermediate_size=hf["intermediate_size"],
                         max_position_embeddings=hf["max_position_embeddings"])
    name = next(f for f in ("pytorch_model.bin", "model.safetensors")
                if os.path.exists(os.path.join(root, f)))
    sd = load_torch_state_dict(os.path.join(root, name))
    prefix = "mpnet." if any(k.startswith("mpnet.") for k in sd) else ""
    return jm.make_tpu_sbert_encoder(jm.convert_mpnet(sd, cfg, prefix=prefix), cfg,
                                     MPNetTokenizer(os.path.join(root, "vocab.txt")),
                                     dtype=dtype, **kw)


def test_mpnet_tokenizer_ids_match_jax_and_hf(tmp_path):
    from transformers import MPNetTokenizer as HFTok

    from vidil_tpu.tokenizer import MPNetTokenizer as JTok
    from vidil_tpu_torch.tokenizer import MPNetTokenizer

    vocab = os.path.join(write_tiny_snapshot(tmp_path, TEST_WORDS), "vocab.txt")
    ours, theirs, hf = MPNetTokenizer(vocab), JTok(vocab), HFTok(vocab_file=vocab)
    for kw in (dict(padding="max_length", truncation=True, max_length=12),
               dict(padding="max_length", truncation=True, max_length=4)):
        got, want = ours(TEXTS, **kw), theirs(TEXTS, **kw)
        np.testing.assert_array_equal(got.input_ids, want.input_ids)
        np.testing.assert_array_equal(got.attention_mask, want.attention_mask)
        ref = hf(TEXTS, **kw)
        np.testing.assert_array_equal(got.input_ids, np.asarray(ref["input_ids"], np.int32))
        np.testing.assert_array_equal(got.attention_mask,
                                      np.asarray(ref["attention_mask"], np.int32))
    assert (ours.pad_token_id, ours.cls_token_id, ours.sep_token_id, ours.unk_token_id) == \
        (theirs.pad_token_id, theirs.cls_token_id, theirs.sep_token_id, theirs.unk_token_id)


def test_full_width_synthetic_vocab_layout(tmp_path):
    """write_mpnet_vocab puts the specials at all-mpnet-base-v2's ids; HF's
    MPNetTokenizer reads it the same way."""
    from transformers import MPNetTokenizer as HFTok

    from vidil_tpu_torch.tokenizer import MPNET_VOCAB_SIZE, MPNetTokenizer, write_mpnet_vocab

    vocab = str(tmp_path / "vocab.txt")
    write_mpnet_vocab(vocab)
    tok = MPNetTokenizer(vocab)
    assert tok.vocab_size == MPNET_VOCAB_SIZE == 30527
    assert [tok.vocab[t] for t in ("<s>", "<pad>", "</s>", "<unk>", "[UNK]", "<mask>")] == \
        [0, 1, 2, 3, 104, 30526]
    assert (tok.cls_token_id, tok.pad_token_id, tok.sep_token_id, tok.unk_token_id) == \
        (0, 1, 2, 104)
    texts = ["word5 word77 word30000", "Word12, word999 unknown!"]
    got = tok(texts, padding="max_length", truncation=True, max_length=10)
    ref = HFTok(vocab_file=vocab)(texts, padding="max_length", truncation=True, max_length=10)
    np.testing.assert_array_equal(got.input_ids, np.asarray(ref["input_ids"], np.int32))


@pytest.mark.parametrize("fmt", ["bin", "safetensors"])
def test_make_sbert_encoder_local_snapshot_matches_jax_fp32(tmp_path, fmt):
    from vidil_tpu_torch.pipeline.generate_prompts import make_sbert_encoder

    root = write_tiny_snapshot(tmp_path, TEST_WORDS, fmt=fmt)
    enc = make_sbert_encoder(root, max_length=12, device="cpu", dtype=torch.float32)
    # batches of 64 (the port's default) against the JAX package's batches
    # of 2: batching does not enter the arithmetic
    got = enc(TEXTS)
    want = jax_encoder(root, jnp.float32, max_length=12, batch_size=2)(TEXTS)
    assert got.shape == (len(TEXTS), 32) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=EMBED_ATOL, rtol=0)


def test_bf16_encoder_close_to_jax_bf16(tmp_path):
    """At the default bf16 the two packages round differently (the
    products' accumulation order, GELU in bf16); the embeddings agree in
    direction."""
    from vidil_tpu.pipeline.generate_prompts import make_sbert_encoder as jmake
    from vidil_tpu_torch.pipeline.generate_prompts import make_sbert_encoder

    root = write_tiny_snapshot(tmp_path, TEST_WORDS)
    got = make_sbert_encoder(root, max_length=12, device="cpu")(TEXTS)
    want = jmake(root, max_length=12)(TEXTS)
    assert float((got * want).sum(-1).min()) > 0.999


def test_sbert_encoder_refuses_a_name_and_a_missing_card(tmp_path, monkeypatch):
    """No download route and no silent CPU: a model name raises, and so
    does the default device on a host without CUDA."""
    from vidil_tpu_torch.evals import qa
    from vidil_tpu_torch.pipeline.generate_prompts import make_sbert_encoder

    with pytest.raises(ValueError, match="not a local directory"):
        make_sbert_encoder("all-mpnet-base-v2", device="cpu")
    monkeypatch.delenv("VIDIL_SBERT_MODEL", raising=False)
    with pytest.raises(ValueError, match="not a local directory"):
        qa._default_encoder("cpu")
    root = write_tiny_snapshot(tmp_path, TEST_WORDS)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_sbert_encoder(root)
    monkeypatch.setenv("VIDIL_SBERT_MODEL", root)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        qa._default_encoder()
    assert qa._default_encoder("cpu")(["a dog"]).shape == (1, 32)


def test_load_safetensors_matches_the_safetensors_package(tmp_path):
    """The port's own reader of the format against safetensors' writer and
    reader: every dtype the reader maps, 0-d, empty and non-contiguous
    sources, a metadata header."""
    from safetensors.torch import load_file, save_file

    from vidil_tpu_torch.models.convert import load_safetensors, load_torch_state_dict

    g = torch.Generator().manual_seed(0)
    tensors = {
        "f32": torch.randn(3, 5, generator=g),
        "f64": torch.randn(4, generator=g, dtype=torch.float64),
        "f16": torch.randn(2, 3, generator=g).half(),
        "bf16": torch.randn(7, 3, generator=g).bfloat16(),
        "i64": torch.arange(6).reshape(2, 3),
        "i32": torch.arange(5, dtype=torch.int32) - 2,
        "i16": torch.tensor([-3, 4], dtype=torch.int16),
        "i8": torch.tensor([-1, 2, 3], dtype=torch.int8),
        "u8": torch.tensor([0, 255], dtype=torch.uint8),
        "bool": torch.tensor([True, False, True]),
        "scalar": torch.tensor(2.5),
        "empty": torch.zeros(0, 4),
        "transposed": torch.randn(3, 4, generator=g).t().contiguous(),
    }
    path = str(tmp_path / "m.safetensors")
    save_file(tensors, path, metadata={"format": "pt"})
    got, want = load_safetensors(path), load_file(path)
    assert set(got) == set(want) == set(tensors)
    for k in tensors:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), k
    via = load_torch_state_dict(path)
    assert all(torch.equal(via[k], want[k]) for k in want)
