"""The port's random initialisation (vidil_tpu_torch: the ``init_*``
functions of models/, create_train_state and create_pretrain_state of
train/retrieval.py and train/pretrain.py, the trainer CLIs without
``pretrained``) against the JAX package's, on the CPU at a small size: ViT 64 wide, 2 layers, 4 heads at 64
px; MED 64 wide, 2 layers, vocabulary 128; CLIP towers 64 wide, 2 layers.

JAX's key streams cannot be reproduced, so the trees are held to JAX's
distributions, not its numbers: the same key set, shapes and dtypes as
``convert.from_jax_params`` of the JAX init; the constant leaves bit for
bit; every random leaf of 2000 or more elements against the JAX leaf by a
two-sample Kolmogorov-Smirnov test (p >= 1e-6), its mean within 6
sigma_eff / sqrt(n) of 0 (sigma_eff: 0.8796 * 0.02 for a normal of std
0.02 truncated at 2 sigma, 0.02 for CLIP's plain-normal leaves, 1 /
sqrt(embed_dim) for a unit-norm queue column); every truncated leaf within
2 sigma. Then the port's init carried into the JAX package gives the same
first train step, and BLIP_Base's features and the CapFilt engine's
`caption_frames` agree with JAX's on it. Each test states its tolerance.
"""

import functools
import json
import os
import sys
import types

import numpy as np
import pytest
import torch
from scipy import stats

import jax
import jax.numpy as jnp
import optax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from vidil_tpu.config import CLIPConfig as JCLIP, MedConfig as JMed, ViTConfig as JViT
from vidil_tpu.models import blip as JB, blip_embedding as JE, blip_nlvr as JN, blip_pretrain as JP
from vidil_tpu.models import blip_retrieval as JR, blip_vqa as JQ, clip as JC, layers as JL
from vidil_tpu.models import med as JM, vit as JV
from vidil_tpu.train import pretrain as JTP, retrieval as JTR
from vidil_tpu_torch.config import CLIPConfig, MedConfig, ViTConfig
from vidil_tpu_torch.models import blip as B, blip_embedding as E, blip_nlvr as N
from vidil_tpu_torch.models import blip_pretrain as P, blip_retrieval as R, blip_vqa as Q
from vidil_tpu_torch.models import clip as C, convert, layers as L, med as M, vit as V
from vidil_tpu_torch.train import pretrain as TP, retrieval as TR
from vidil_tpu_torch.utils.seeding import init_generator

torch.set_num_threads(1)

VIT_KW = dict(image_size=64, patch_size=16, hidden_size=64, num_layers=2, num_heads=4)
MED_KW = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
              intermediate_size=256, max_position_embeddings=64, encoder_width=64)
CLIP_KW = dict(image_size=28, patch_size=14, vision_hidden_size=64, vision_layers=2,
               vision_heads=4, vision_intermediate_size=256, vocab_size=128,
               text_hidden_size=64, text_layers=2, text_heads=4, text_intermediate_size=256,
               max_text_len=16, projection_dim=64)
EMBED, QUEUE = 32, 128

STD = 0.02
TRUNC_SCALE = 0.8796  # std of a unit normal truncated at +-2
KS_MIN_N, KS_P = 2000, 1e-6
# CLIP's leaves drawn as 0.02 * a plain normal (models/clip.py:init_clip)
PLAIN = {"vision/patch_embed/kernel", "vision/class_embedding", "vision/pos_embed",
         "text/pos_embed", "visual_projection/kernel", "text_projection/kernel"}


def _jv():
    return JViT(**VIT_KW), JMed(**MED_KW)


def _pv():
    return ViTConfig(**VIT_KW), MedConfig(**MED_KW)


def _state_tree(params, params_m, queue):
    image, text, idx, ptr = queue
    return {"params": params, "params_m": params_m,
            "queue": {"image": image, "text": text, "idx": idx,
                      "ptr": torch.tensor(int(ptr), dtype=torch.int32)}}


def _jax_state(create, key):
    vit, med = _jv()
    state = jax.jit(lambda k: create(k, vit, med, JTR.make_optimizer(1e-3), embed_dim=EMBED,
                                     queue_size=QUEUE))(key)
    carried = convert.from_jax_train_state(jax.tree.map(np.asarray, state))
    return _state_tree(carried["params"], carried["params_m"], carried["queue"])


def _port_state(create, seed):
    state = create(None, 1e-3, vit_cfg=ViTConfig(**VIT_KW), med_cfg=MedConfig(**MED_KW),
                   embed_dim=EMBED, queue_size=QUEUE, seed=seed, device="cpu")
    detached = convert.to_device(state.params, "cpu")
    return _state_tree(detached, state.params_m, state.queue)


# name -> (the JAX init of a key, the port's init of a seed): the ten init
# functions (init_med with both heads), the embedding extractor's alias,
# create_train_state and create_pretrain_state
CASES = {
    "init_vit": (lambda k: JV.init_vit(k, JViT(**VIT_KW)),
                 lambda s: V.init_vit(init_generator(s), ViTConfig(**VIT_KW))),
    "init_med": (lambda k: JM.init_med(k, JMed(**MED_KW), with_lm_head=True, with_pooler=True),
                 lambda s: M.init_med(init_generator(s), MedConfig(**MED_KW), with_lm_head=True,
                                      with_pooler=True)),
    "init_blip_decoder": (lambda k: JB.init_blip_decoder(k, *_jv()),
                          lambda s: B.init_blip_decoder(init_generator(s), *_pv())),
    "init_blip_itm": (lambda k: JB.init_blip_itm(k, *_jv(), EMBED),
                      lambda s: B.init_blip_itm(init_generator(s), *_pv(), EMBED)),
    "init_blip_base": (lambda k: JB.init_blip_base(k, *_jv()),
                       lambda s: B.init_blip_base(init_generator(s), *_pv())),
    "init_blip_vqa": (lambda k: JQ.init_blip_vqa(k, *_jv()),
                      lambda s: Q.init_blip_vqa(init_generator(s), *_pv())),
    "init_blip_nlvr": (lambda k: JN.init_blip_nlvr(k, *_jv()),
                       lambda s: N.init_blip_nlvr(init_generator(s), *_pv())),
    "init_blip_embedding": (lambda k: JE.init_blip_embedding(k, *_jv(), EMBED),
                            lambda s: E.init_blip_embedding(init_generator(s), *_pv(), EMBED)),
    "init_retrieval_params": (lambda k: JR.init_retrieval_params(k, *_jv(), EMBED),
                              lambda s: R.init_retrieval_params(init_generator(s), *_pv(),
                                                                EMBED)),
    "init_pretrain_params": (lambda k: JP.init_pretrain_params(k, *_jv(), EMBED),
                             lambda s: P.init_pretrain_params(init_generator(s), *_pv(), EMBED)),
    "init_clip": (lambda k: JC.init_clip(k, JCLIP(**CLIP_KW)),
                  lambda s: C.init_clip(init_generator(s), CLIPConfig(**CLIP_KW))),
    "create_train_state": (functools.partial(_jax_state, JTR.create_train_state),
                           functools.partial(_port_state, TR.create_train_state)),
    "create_pretrain_state": (functools.partial(_jax_state, JTP.create_pretrain_state),
                              functools.partial(_port_state, TP.create_pretrain_state)),
}

# the layer-level initializers: the same checks on one call each
LAYER_CASES = {
    "trunc_normal": (lambda k: {"x": JL.trunc_normal(k, (64, 96), std=0.05)},
                     lambda s: {"x": L.trunc_normal(init_generator(s), (64, 96), std=0.05)}),
    "init_linear": (lambda k: JL.init_linear(k, 64, 96),
                    lambda s: L.init_linear(init_generator(s), 64, 96)),
    "init_layer_norm": (lambda k: JL.init_layer_norm(96), lambda s: L.init_layer_norm(96)),
    "init_embedding": (lambda k: JL.init_embedding(k, 128, 64),
                       lambda s: L.init_embedding(init_generator(s), 128, 64)),
    "init_mlp": (lambda k: JL.init_mlp(k, 64, 256), lambda s: L.init_mlp(init_generator(s), 64, 256)),
    "init_block": (lambda k: JV.init_block(k, 64, 256),
                   lambda s: V.init_block(init_generator(s), 64, 256)),
    "init_med_layer": (lambda k: JM.init_med_layer(k, JMed(**MED_KW)),
                       lambda s: M.init_med_layer(init_generator(s), MedConfig(**MED_KW))),
    "_init_tower_layer": (lambda k: JC._init_tower_layer(k, 64, 256),
                          lambda s: C._init_tower_layer(init_generator(s), 64, 256)),
}
ALL_CASES = {**CASES, **LAYER_CASES}


@functools.lru_cache(maxsize=None)
def _jax_tree(name):
    """The JAX init at PRNGKey(0) as a port tree of CPU tensors."""
    tree = ALL_CASES[name][0](jax.random.PRNGKey(0))
    if name.startswith("create_"):
        return tree
    return convert.from_jax_params(jax.tree.map(np.asarray, tree))


def _leaves(tree):
    return {path: t.detach() for path, t in convert.named_leaves(tree)}


def _sigma(path, name):
    """(sigma_eff, truncated) of a random leaf."""
    if path.startswith("queue/"):
        return 1.0 / np.sqrt(EMBED), False
    if name == "init_clip" and path in PLAIN:
        return STD, False
    return TRUNC_SCALE * (0.05 if name == "trunc_normal" else STD), True


def _constant(t):
    return bool((t == t.reshape(-1)[0]).all()) if t.numel() else True


@pytest.mark.parametrize("name", list(ALL_CASES))
def test_init_tree_matches_the_jax_layout(name):
    """The key set, every leaf's shape and dtype: those of
    convert.from_jax_params (for a state, convert.from_jax_train_state) of
    the JAX init at the same config; every leaf fp32 but the queue's idx
    and pointer."""
    got, want = _leaves(ALL_CASES[name][1](0)), _leaves(_jax_tree(name))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        assert (tuple(got[path].shape), got[path].dtype) == (tuple(w.shape), w.dtype), path
        assert got[path].dtype == torch.float32 or path in ("queue/idx", "queue/ptr"), path


@pytest.mark.parametrize("name", list(ALL_CASES))
def test_constant_leaves_are_exact(name):
    """Every leaf that the JAX init fills with one value (zeros, ones,
    temp 0.07, logit_scale 2.6592, the queue's idx -100 and pointer 0) is
    the same bit for bit; every leaf that JAX draws is drawn."""
    got, want = _leaves(ALL_CASES[name][1](0)), _leaves(_jax_tree(name))
    consts = 0
    for path, w in want.items():
        if _constant(w):
            consts += 1
            assert torch.equal(got[path], w), path
        else:
            assert not _constant(got[path]), path
    assert consts > 0 or name in ("trunc_normal", "init_embedding")


@pytest.mark.parametrize("name", [n for n in ALL_CASES if n != "init_layer_norm"])
def test_random_leaves_follow_the_jax_distribution(name):
    """Every random leaf of >= 2000 elements: a two-sample KS test against
    the JAX leaf at p >= 1e-6 and a mean within 6 sigma_eff / sqrt(n) of 0;
    every truncated leaf within 2 sigma (JAX's bound; the momentum towers
    are copies of the parameters)."""
    got, want = _leaves(ALL_CASES[name][1](0)), _leaves(_jax_tree(name))
    tested = 0
    for path, w in want.items():
        if _constant(w):
            continue
        g = got[path].double().reshape(-1).numpy()
        sigma, truncated = _sigma(path, name)
        if truncated:
            bound = 2 * sigma / TRUNC_SCALE
            assert np.abs(g).max() <= bound and np.abs(w.numpy()).max() <= bound, path
        if g.size < KS_MIN_N:
            continue
        tested += 1
        p = stats.ks_2samp(g, w.double().reshape(-1).numpy()).pvalue
        assert p >= KS_P, (path, p)
        assert abs(g.mean()) <= 6 * sigma / np.sqrt(g.size), (path, g.mean())
    assert tested > 0


@pytest.mark.parametrize("name", [n for n in ALL_CASES if n != "init_layer_norm"])
def test_seed_makes_the_tree(name):
    """One seed gives the same tree bit for bit; another seed changes every
    random leaf."""
    port = ALL_CASES[name][1]
    a, b, c = _leaves(port(0)), _leaves(port(0)), _leaves(port(1))
    for path in a:
        assert torch.equal(a[path], b[path]), path
        if not _constant(a[path]) and not path.startswith("params_m/"):
            assert not torch.equal(a[path], c[path]), path


@pytest.mark.parametrize("std", [0.02, 1.0])
def test_trunc_normal_cuts_at_two_sigma(std):
    """10^6 draws: every |x| <= 2 std, the sample std within 1% of 0.8796
    std (the std of a normal truncated at 2 sigma), where
    torch.nn.init.trunc_normal_'s default bounds (-2, 2 absolute) leave a
    std-0.02 normal uncut."""
    x = L.trunc_normal(init_generator(3), (1000, 1000), std=std)
    assert x.abs().max() <= 2 * std
    assert abs(x.std().item() / (TRUNC_SCALE * std) - 1) < 0.01
    assert x.abs().max() > 1.99 * std  # the tails reach the cut


# ---------------------------------------------------------------------------
# the port's init in the JAX package: the same first step
# ---------------------------------------------------------------------------

PROMPT_LENGTH = 3


def _grad_capture():
    """An optax transformation whose state becomes the gradients it was
    given: JAX's own train step then hands back its step-1 gradients."""
    return optax.GradientTransformation(
        init=lambda p: jax.tree.map(jnp.zeros_like, p),
        update=lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


def _port_grads(params):
    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node.grad
    return convert.to_jax_params(walk(params))


def _text(rng, B, L, first, vocab=128):
    mask = np.ones((B, L), np.int32)
    mask[-1, L - 3:] = 0
    ids = rng.randint(6, vocab, size=(B, L)).astype(np.int32) * mask
    ids[:, 0] = first
    return ids, mask


def _caption(rng):
    ids, mask = _text(rng, 2, 12, 1)
    batch = {"video": rng.randn(2, 2, 64, 64, 3).astype(np.float32) * 0.1,
             "input_ids": ids, "attention_mask": mask}
    from vidil_tpu.train.caption import create_caption_train_state, make_caption_train_step
    from vidil_tpu_torch.train import caption

    params = B.init_blip_decoder(init_generator(0), *_pv())
    jstate = create_caption_train_state(convert.to_jax_params(params), _grad_capture())
    jstate, jm = jax.jit(make_caption_train_step(*_jv(), _grad_capture(),
                                                 prompt_length=PROMPT_LENGTH))(jstate, batch)
    state = caption.create_caption_train_state(params, 1e-4, device="cpu")
    state, m = caption.make_caption_train_step(*_pv(), prompt_length=PROMPT_LENGTH)(state, batch)
    return {"loss": (m["loss"], jm["loss"])}, state.params, jstate.opt_state


def _vqa(rng):
    q_ids, q_mask = _text(rng, 2, 9, 3)
    a_ids, a_mask = _text(rng, 3, 5, 1)
    batch = {"video": rng.randn(2, 2, 64, 64, 3).astype(np.float32) * 0.1,
             "question_ids": q_ids, "question_mask": q_mask, "answer_ids": a_ids,
             "answer_mask": a_mask, "answer_question_index": np.array([0, 0, 1], np.int32),
             "weights": np.array([0.2, 0.3, 0.2], np.float32)}
    from vidil_tpu.train.vqa import create_vqa_train_state, make_vqa_train_step
    from vidil_tpu_torch.train import vqa

    params = Q.init_blip_vqa(init_generator(0), *_pv())
    jstate = create_vqa_train_state(convert.to_jax_params(params), _grad_capture())
    jstate, jm = jax.jit(make_vqa_train_step(*_jv(), _grad_capture()))(jstate, batch)
    state = vqa.create_vqa_train_state(params, 1e-4, device="cpu")
    state, m = vqa.make_vqa_train_step(*_pv())(state, batch)
    return {"loss": (m["loss"], jm["loss"])}, state.params, jstate.opt_state


def _momentum(rng, pretrain):
    """Retrieval or pretraining at a batch of 2 with distinct videos: each
    row's only admissible hard negative is the other row, so JAX's draw and
    the port's negatives agree. JAX's step-1 gradient is its first Adam
    moment over 1 - b1."""
    ids, mask = _text(rng, 2, 10, 2)
    enc, dec = ids.copy(), ids.copy()
    enc[:, 0], dec[:, 0] = 3, 1
    batch = {"video": rng.randn(2, 2, 64, 64, 3).astype(np.float32) * 0.1, "text_ids": ids,
             "enc_ids": enc, "text_mask": mask}
    batch.update({"dec_ids": dec} if pretrain else {"idx": np.array([0, 1], np.int32)})
    init = P.init_pretrain_params if pretrain else R.init_retrieval_params
    jcreate, jmake = ((JTP.create_pretrain_state, JTP.make_pretrain_step) if pretrain
                      else (JTR.create_train_state, JTR.make_retrieval_train_step))
    create, make = ((TP.create_pretrain_state, TP.make_pretrain_step) if pretrain
                    else (TR.create_train_state, TR.make_retrieval_train_step))
    params = init(init_generator(0), *_pv(), EMBED)
    opt = JTR.make_optimizer(1e-3)
    jstate = jax.jit(lambda k, p: jcreate(k, *_jv(), opt, embed_dim=EMBED, queue_size=QUEUE,
                                          params=p))(jax.random.PRNGKey(0),
                                                     convert.to_jax_params(params))
    carried = convert.from_jax_train_state(jax.tree.map(np.asarray, jstate))
    jstate, jm = jax.jit(jmake(*_jv(), opt))(jstate, batch, 0.4, jax.random.PRNGKey(5))
    state = create(carried["params"], 1e-3, embed_dim=EMBED, params_m=carried["params_m"],
                   queue=carried["queue"], device="cpu")
    negatives = (torch.tensor([1, 0]), torch.tensor([1, 0]))
    state, m = make(*_pv())(state, batch, 0.4, None, negatives=negatives)
    mu = jax.tree.map(lambda w: np.asarray(w) / np.float32(0.1), jstate.opt_state.inner_state[0].mu)
    keys = ("loss", "loss_ita", "loss_itm") + (("loss_lm",) if pretrain else ())
    return {k: (m[k], jm[k]) for k in keys}, state.params, mu


STEPS = {"caption": _caption, "vqa": _vqa,
         "retrieval": functools.partial(_momentum, pretrain=False),
         "pretrain": functools.partial(_momentum, pretrain=True)}


@pytest.mark.parametrize("trainer", list(STEPS))
def test_port_init_in_jax_gives_the_same_first_step(trainer):
    """The port's init (seed 0) carried into the JAX package's step, fp32,
    the same batch: the losses at rtol 1e-5 and every gradient leaf at atol
    1e-5 of its leaf's max |g|, at least 1e-6 of the model's largest (the
    existing steps' bars: the attention twins and XLA sum in another order,
    and the attention key biases' gradients are rounding noise)."""
    losses, params, want = STEPS[trainer](np.random.RandomState(7))
    for key, (got, jgot) in losses.items():
        np.testing.assert_allclose(float(got), float(jgot), rtol=1e-5, err_msg=key)
    got = dict(jax.tree_util.tree_leaves_with_path(_port_grads(params)))
    want = dict(jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, want)))
    assert got.keys() == want.keys() and len(got) > 40
    g_max = max(np.abs(w).max() for w in want.values())
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=0,
                                   atol=1e-5 * max(np.abs(w).max(), 1e-6 * g_max),
                                   err_msg=jax.tree_util.keystr(path))


@functools.lru_cache(maxsize=None)
def _chip_smoke():
    import importlib.util

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location("chip_smoke_bars",
                                                  os.path.join(repo, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_first_pretraining_losses_at_the_init_within_the_derived_bars(seed):
    """chip_smoke.py phase 19 (b) holds the first pretraining step from the
    init to bars derived for any width (`p19_loss_bars`: the ITM loss from
    ln 2 - 0.15 to its value at 3 sigma of the head's logit difference,
    the LM loss within ln V - 0.3 and ln V + 0.6). At 64 wide, vocabulary
    128, fp32, batch 4, the port's init from three seeds lands inside
    them, and the momentum towers' copy leaves the first step's ITM near
    its centre, ln 2 + s^2 / 8, s the logit difference's std."""
    cs = _chip_smoke()
    bars = cs.p19_loss_bars(MED_KW["hidden_size"], MED_KW["vocab_size"])
    rng = np.random.RandomState(seed)
    ids, mask = _text(rng, 4, 10, 2)
    enc, dec = ids.copy(), ids.copy()
    enc[:, 0], dec[:, 0] = 3, 1
    batch = {"video": rng.randn(4, 2, 64, 64, 3).astype(np.float32), "text_ids": ids,
             "enc_ids": enc, "dec_ids": dec, "text_mask": mask}
    state = TP.create_pretrain_state(None, 1e-4, vit_cfg=ViTConfig(**VIT_KW),
                                     med_cfg=MedConfig(**MED_KW), embed_dim=EMBED,
                                     queue_size=QUEUE, seed=seed, device="cpu")
    _, m = TP.make_pretrain_step(*_pv())(state, batch, 0.4, torch.Generator().manual_seed(seed))
    for key in ("loss_itm", "loss_lm"):
        lo, hi = bars[key]
        assert lo <= float(m[key]) <= hi, (key, float(m[key]), bars[key])
    s = bars["itm_logit_diff_std"]
    assert abs(float(m["loss_itm"]) - (np.log(2) + s * s / 8)) < 3 * s / 6


# ---------------------------------------------------------------------------
# BLIP_Base's features, caption_frames
# ---------------------------------------------------------------------------

# PARITY.md's fp32 bars: the ViT's output, and the MED's
FEATURE_ATOL = {"image": 2e-5, "text": 3e-5, "multimodal": 3e-5}


@pytest.mark.parametrize("mode", list(FEATURE_ATOL))
def test_blip_base_features_match_jax(mode):
    """blip_base_features on the port's BLIP_Base init, fp32, each mode
    against the JAX package's on the same weights and inputs, [ENC]
    substituted at position 0 in the multimodal mode."""
    params = B.init_blip_base(init_generator(0), *_pv())
    rng = np.random.RandomState(9)
    images = rng.randn(2, 64, 64, 3).astype(np.float32)
    ids, mask = _text(rng, 2, 10, 2)
    want = np.asarray(JB.blip_base_features(
        convert.to_jax_params(params), mode, *_jv(), images=jnp.asarray(images),
        text_ids=jnp.asarray(ids), text_mask=jnp.asarray(mask), enc_token_id=3))
    t_ids = torch.from_numpy(ids).long()
    got = B.blip_base_features(params, mode, *_pv(), images=torch.from_numpy(images),
                               text_ids=t_ids, text_mask=torch.from_numpy(mask).long(),
                               enc_token_id=3)
    assert t_ids[0, 0] == 2  # the caller's ids are left as they are
    np.testing.assert_allclose(got.numpy(), want, atol=FEATURE_ATOL[mode], rtol=0)


def test_blip_base_features_refuse_an_unknown_mode():
    with pytest.raises(ValueError, match="unknown feature mode"):
        B.blip_base_features({}, "video", *_pv())


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """The JAX CapFilt engine and the port's over the port's init (seed 0
    captioner, seed 1 filterer), fp32, 3 beams, 16 tokens."""
    from vidil_tpu.pipeline.capfilt import CapFiltEngine as JEngine
    from vidil_tpu.tokenizer import BlipTokenizer as JTok
    from vidil_tpu_torch.pipeline.capfilt import CapFiltEngine
    from vidil_tpu_torch.tokenizer import BlipTokenizer, write_test_vocab

    words = ["a", "picture", "of", "man", "dog", "cat", "runs", "plays", "beach", "park",
             "the", "on", "in", "ball", "red", "blue", "walks", "jumps", "sits", "tree"]
    vocab = str(tmp_path_factory.mktemp("vocab") / "vocab.txt")
    write_test_vocab(vocab, words)
    med = dict(MED_KW, vocab_size=BlipTokenizer(vocab).vocab_size)
    cap = B.init_blip_decoder(init_generator(0), ViTConfig(**VIT_KW), MedConfig(**med))
    fil = B.init_blip_itm(init_generator(1), ViTConfig(**VIT_KW), MedConfig(**med))
    opts = dict(num_beams=3, max_length=16, min_length=5)
    jeng = JEngine(convert.to_jax_params(cap), convert.to_jax_params(fil), JTok(vocab),
                   JViT(**VIT_KW), JMed(**med), dtype=None, **opts)
    peng = CapFiltEngine(cap, fil, BlipTokenizer(vocab), ViTConfig(**VIT_KW), MedConfig(**med),
                         dtype=torch.float32, device="cpu", **opts)
    frames = np.random.RandomState(3).randint(0, 256, size=(4, 64, 64, 3), dtype=np.uint8)
    return jeng, peng, frames


def test_caption_frames_token_identical_to_jax(engines):
    """Beam mode, fp32: the same 4 caption strings as the JAX engine's
    caption_frames on the same weights and frames."""
    jeng, peng, frames = engines
    got = peng.caption_frames(frames)
    assert len(got) == 4 and all(isinstance(t, str) for t in got)
    assert got == jeng.caption_frames(frames)


def test_caption_frames_samples_from_the_generator(engines):
    """Sample mode: one string per frame, the same under one seed (and with
    no generator, seed 0), and other tokens under another seed."""
    _, peng, frames = engines
    sample = lambda seed: peng.caption_frames(frames, mode="sample",
                                              generator=torch.Generator().manual_seed(seed))
    a = sample(0)
    assert len(a) == 4 and a == sample(0) == peng.caption_frames(frames, mode="sample")
    assert a != sample(1)


# ---------------------------------------------------------------------------
# the trainer CLIs without `pretrained`: the init, drawn
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """A tiny trainer config with no `pretrained`: ViT and MED 64 wide, a
    test vocabulary, and (for the pretraining CLI, whose dataset keeps the
    annotations whose video file exists) empty video files."""
    from vidil_tpu_torch.tokenizer import BlipTokenizer, write_test_vocab

    root = tmp_path_factory.mktemp("torch_init_cli")
    vocab = str(root / "vocab.txt")
    write_test_vocab(vocab, ["a", "test", "caption"])
    med_path = str(root / "med_config.json")
    with open(med_path, "w") as f:
        json.dump({"vocab_size": BlipTokenizer(vocab).vocab_size, "hidden_size": 64,
                   "num_hidden_layers": 2, "num_attention_heads": 4, "intermediate_size": 256,
                   "max_position_embeddings": 64, "encoder_width": 64,
                   "add_cross_attention": True}, f)
    (root / "videos").mkdir()
    with open(root / "train.jsonl", "w") as f:
        for vi in range(4):
            (root / "videos" / f"video{vi}.mp4").touch()
            f.write(json.dumps({"caption": "a test caption", "clip_name": f"video{vi}"}) + "\n")
    config = dict(bert_vocab=vocab, vit="tiny", image_size=64, med_config=med_path,
                  vit_config={k: v for k, v in VIT_KW.items() if k != "image_size"},
                  train_video_root=str(root / "videos"), train_ann_jsonl=str(root / "train.jsonl"),
                  num_frm_train=2, frm_sampling_strategy="uniform", batch_size=2,
                  queue_size=8, init_lr=1e-5, max_epoch=0)
    return types.SimpleNamespace(root=root, config=config)


def _cli_params(cli_name, workdir, seed=42):
    """(the parameters a trainer CLI starts from without `pretrained`, run
    with --seed `seed`; the port's init of the CLI's model at its configs
    from the seed the CLI should draw from)."""
    import importlib

    cli = importlib.import_module(f"vidil_tpu_torch.{cli_name}")
    if cli_name == "pretrain_video":
        args = types.SimpleNamespace(output_dir=str(workdir.root / "out"), seed=seed,
                                     world_size=1, dist_url="env://", distributed=False,
                                     device="cpu")
        vit_cfg, med_cfg, _ = cli.build(dict(workdir.config))
        return (cli.main(args, dict(workdir.config)).params,
                P.init_pretrain_params(init_generator(seed), vit_cfg, med_cfg))
    build = getattr(cli, "build_model_and_tokenizer", None) or cli.build
    params, _, vit_cfg, med_cfg = build(dict(workdir.config), "cpu")
    return params, CLIS[cli_name][1](init_generator(0), vit_cfg, med_cfg)


# CLI -> (the JAX init it draws, the port's, the leaf checked)
CLIS = {
    "train_caption_video": (JB.init_blip_decoder, B.init_blip_decoder,
                            "visual_encoder/blocks/0/attn/qkv/kernel"),
    "train_vqa_video": (JQ.init_blip_vqa, Q.init_blip_vqa,
                        "text_decoder/embeddings/word/embedding"),
    "train_retrieval_video": (JR.init_retrieval_params, R.init_retrieval_params,
                              "text_encoder/layers/1/mlp/fc1/kernel"),
    "pretrain_video": (JP.init_pretrain_params, P.init_pretrain_params,
                       "decoder_attn/0/cross_attn/key/kernel"),
}


@pytest.mark.parametrize("cli_name", list(CLIS))
def test_cli_without_pretrained_draws_the_init(cli_name, workdir):
    """No `pretrained`: the caption, VQA and retrieval CLIs start from
    their model's init drawn from seed 0 (JAX: PRNGKey(0)), the
    pretraining CLI from --seed (JAX: PRNGKey(seed)), bit for bit: one leaf
    against the JAX init's by the KS test (p >= 1e-6) and within 2 sigma,
    the whole tree equal to the port's init from that seed, and the
    pretraining tree another under another --seed."""
    j_init, _, leaf = CLIS[cli_name]
    med = JMed.from_json(workdir.config["med_config"], encoder_width=64)
    if cli_name == "pretrain_video":  # widened to the tokenizer's [DEC] / [ENC]
        med = JMed(**{**med.__dict__, "vocab_size": med.vocab_size + 2})
    want = _leaves(convert.from_jax_params(jax.tree.map(
        np.asarray, j_init(jax.random.PRNGKey(0), JViT(**VIT_KW), med))))[leaf]
    params, drawn = _cli_params(cli_name, workdir)
    got, drawn = _leaves(params), _leaves(drawn)
    x = got[leaf].double().reshape(-1).numpy()
    assert x.size >= KS_MIN_N and np.abs(x).max() <= 2 * STD
    assert stats.ks_2samp(x, want.double().reshape(-1).numpy()).pvalue >= KS_P
    assert sorted(got) == sorted(drawn) and all(torch.equal(got[p], drawn[p]) for p in got)
    if cli_name == "pretrain_video":
        other, _ = _cli_params(cli_name, workdir, seed=43)
        assert not torch.equal(got[leaf], _leaves(other)[leaf])
