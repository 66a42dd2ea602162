"""The port's BLIP video pretraining (vidil_tpu_torch: models/blip_pretrain.py,
train/pretrain.py, train/frame_selection.py and the pretrain_video CLI)
against the JAX package's, on the CPU at a tiny size: ViT 32 wide, 2
layers, 4 heads at 32 px; MED 32 wide, 2 layers. Inputs come from numpy
seeds and go through both packages. Each test states its tolerance.
"""

import json
import os
import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from vidil_tpu.config import MedConfig as JMed, ViTConfig as JViT
from vidil_tpu.models import blip_retrieval as JR
from vidil_tpu.train import pretrain as JP
from vidil_tpu.train.retrieval import make_optimizer as j_make_optimizer
from vidil_tpu_torch.config import MedConfig, ViTConfig
from vidil_tpu_torch.models import blip_pretrain as BP, convert
from vidil_tpu_torch.models.blip import blip_pretrain_shapes
from vidil_tpu_torch.train import pretrain as P
from vidil_tpu_torch.utils.synth import synth_tree

torch.set_num_threads(1)

VIT_KW = dict(image_size=32, patch_size=16, hidden_size=32, num_layers=2, num_heads=4)
MED_KW = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
              intermediate_size=64, max_position_embeddings=64, encoder_width=32)
EMBED, QUEUE = 8, 16


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(seed=0, B=4, N=2, L=10):
    rng = np.random.RandomState(seed)
    ids = rng.randint(6, 64, size=(B, L)).astype(np.int32)
    mask = np.ones((B, L), np.int32)
    mask[2, 6:] = 0
    ids[mask == 0] = 0
    enc, dec = ids.copy(), ids.copy()
    enc[:, 0] = 3
    dec[:, 0] = 1
    return {"video": rng.randn(B, N, 32, 32, 3).astype(np.float32) * 0.1, "text_ids": ids,
            "enc_ids": enc, "dec_ids": dec, "text_mask": mask}


def _synth_np(shapes, salt):
    """One set of weights for both packages: `utils/synth.py`'s sin fill in
    the JAX layout, as numpy (quicker than compiling JAX's random init)."""
    return jax.tree.map(lambda t: t.numpy(), synth_tree(shapes, "cpu", salt=salt))


def _jax_state(opt):
    """JAX's pretraining state over synthetic weights, in one compiled
    program (eager dispatch compiles op by op)."""
    params = _synth_np(blip_pretrain_shapes(ViTConfig(**VIT_KW), MedConfig(**MED_KW), EMBED), 4.0)
    params["temp"] = np.asarray(0.07, np.float32)
    return jax.jit(lambda key, p: JP.create_pretrain_state(
        key, JViT(**VIT_KW), JMed(**MED_KW), opt, embed_dim=EMBED, queue_size=QUEUE,
        params=p))(jax.random.PRNGKey(0), params)


def _port_state(jstate, lr):
    carried = convert.from_jax_train_state(_np_tree(jstate))
    return P.create_pretrain_state(carried["params"], lr, params_m=carried["params_m"],
                                   queue=carried["queue"], device="cpu")


@jax.jit
def _jax_pretrain_negatives(state, batch, rng, momentum=0.995):
    """The draws JAX's pretrain_loss makes inside, reproduced from its split
    key: categorical over log(softmax(sim[:, :B]) + 1e-4) with the diagonal
    zeroed, the similarities against the momentum features after the
    step's momentum update."""
    vit, med = JViT(**VIT_KW), JMed(**MED_KW)
    params = state.params
    pm = JR.momentum_update(params, state.params_m, momentum)
    temp = jnp.clip(params["temp"], 0.001, 0.5)
    video, ids, mask = (batch[k] for k in ("video", "text_ids", "text_mask"))
    _, vfeat = JR._video_features(params, video, vit)
    tfeat = JR._text_features(params, ids, mask, med)
    _, vfeat_m = JR._video_features(pm, video, vit)
    tfeat_m = JR._text_features(pm, ids, mask, med)
    B = video.shape[0]
    sim_i2t = (vfeat @ jnp.concatenate([tfeat_m.T, state.queue.text], axis=1)) / temp
    sim_t2i = (tfeat @ jnp.concatenate([vfeat_m.T, state.queue.image], axis=1)) / temp
    diag = jnp.eye(B, dtype=bool)
    w_t2i = jnp.where(diag, 0.0, jax.nn.softmax(sim_t2i[:, :B], axis=1) + 1e-4)
    w_i2t = jnp.where(diag, 0.0, jax.nn.softmax(sim_i2t[:, :B], axis=1) + 1e-4)
    k1, k2 = jax.random.split(rng)
    return (jax.random.categorical(k1, jnp.log(w_t2i), axis=1),
            jax.random.categorical(k2, jnp.log(w_i2t), axis=1))


def jax_pretrain_negatives(state, batch, rng):
    return tuple(torch.from_numpy(np.array(n)).long()
                 for n in _jax_pretrain_negatives(state, batch, rng))


def _grads(state):
    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node.grad
    return convert.to_jax_params(walk(state.params))


def test_two_steps_match_jax():
    """fp32, the same weights, queue and batches, JAX's negatives carried
    across each step, AdamW at lr 1e-3. Step 1: the three losses at rtol
    1e-5; every gradient leaf (the tied encoder/decoder leaves hold both
    towers' sums; JAX's is its first Adam moment over 1 - b1) at atol 1e-5
    of its leaf's scale, at least 1e-6 of the model's largest (the
    attention key biases' gradients are rounding noise); the queue's new
    columns within the MED bar (3e-5), its idx slots -100, its pointer
    advanced by the batch. Step 2: the momentum towers at atol 1e-6 (a few
    fp32 ulps at the weights' scale: the libraries round the update's
    parts in another order) and the queues within the MED bar."""
    opt = j_make_optimizer(1e-3)
    jstate = _jax_state(opt)
    state = _port_state(jstate, 1e-3)
    j_step = jax.jit(JP.make_pretrain_step(JViT(**VIT_KW), JMed(**MED_KW), opt))
    step = P.make_pretrain_step(ViTConfig(**VIT_KW), MedConfig(**MED_KW))
    for i in range(2):
        batch, rng = _batch(10 + i), jax.random.PRNGKey(30 + i)
        negatives = jax_pretrain_negatives(jstate, batch, rng)
        jstate, jm = j_step(jstate, batch, 0.4, rng)
        state, m = step(state, batch, 0.4, None, negatives=negatives)
        if i == 0:
            for key in ("loss_ita", "loss_itm", "loss_lm", "loss"):
                np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-5, err_msg=key)
            mu = _np_tree(jstate.opt_state.inner_state[0].mu)
            got = dict(jax.tree_util.tree_leaves_with_path(_grads(state)))
            want = {p: w / np.float32(0.1) for p, w in jax.tree_util.tree_leaves_with_path(mu)}
            assert got.keys() == want.keys() and len(got) > 50
            g_max = max(np.abs(w).max() for w in want.values())
            for path, w in want.items():
                np.testing.assert_allclose(got[path], w, rtol=0,
                                           atol=1e-5 * max(np.abs(w).max(), 1e-6 * g_max),
                                           err_msg=jax.tree_util.keystr(path))
            assert state.queue.ptr == int(jstate.queue.ptr) == 4
            assert (state.queue.idx.numpy() == -100).all()
        for name in ("image", "text"):
            np.testing.assert_allclose(getattr(state.queue, name).numpy(),
                                       np.asarray(getattr(jstate.queue, name)), atol=3e-5, rtol=0)
    got = convert.to_jax_params(state.params_m)
    assert jax.tree.structure(got) == jax.tree.structure(_np_tree(jstate.params_m))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(_np_tree(jstate.params_m))):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)


def test_tied_decoder_shares_tensors_and_sums_gradients():
    """The decoder's embeddings, FFNs and FFN norms are the encoder's
    tensor objects (AdamW holds each once), its attention and head its
    own; a shared leaf's gradient is the LM loss's plus the ITA+ITM
    losses' (atol 1e-7: one fp32 sum of two addends in another order);
    one step moves the shared FFN and the decoder's attention (the
    counterpart of tests/test_train_steps.py's tying test)."""
    params = BP.synth_pretrain_params(ViTConfig(**VIT_KW), MedConfig(**MED_KW), embed_dim=EMBED,
                                      salt=3.0)
    dec = BP.tied_decoder_params(params)
    enc = params["text_encoder"]
    assert dec["embeddings"] is enc["embeddings"]
    for d, e, own in zip(dec["layers"], enc["layers"], params["decoder_attn"]):
        assert d["mlp"] is e["mlp"] and d["mlp_norm"] is e["mlp_norm"]
        assert d["self_attn"] is own["self_attn"] and d["self_attn"] is not e["self_attn"]

    state = P.create_pretrain_state(params, 1e-3, embed_dim=EMBED, queue_size=QUEUE, seed=0,
                                    device="cpu")
    leaves = [p for _, p in convert.named_leaves(state.params)]
    assert len({id(p) for p in state.optimizer.param_groups[0]["params"]}) == len(leaves)
    batch = P.batch_tensors(_batch(2), "cpu")
    negatives = (torch.tensor([1, 0, 3, 2]), torch.tensor([2, 3, 0, 1]))
    vit, med = ViTConfig(**VIT_KW), MedConfig(**MED_KW)
    shared = state.params["text_encoder"]["layers"][0]["mlp"]["fc1"]["kernel"]

    def grad_of(pick):
        ita, itm, lm, _ = BP.pretrain_loss(
            state.params, state.params_m, state.queue, batch["video"], batch["text_ids"],
            batch["enc_ids"], batch["dec_ids"], batch["text_mask"], 0.4, None, vit, med,
            negatives=negatives)
        return torch.autograd.grad(pick(ita, itm, lm), shared)[0]

    g_lm = grad_of(lambda ita, itm, lm: lm)
    g_rest = grad_of(lambda ita, itm, lm: ita + itm)
    g_all = grad_of(lambda ita, itm, lm: ita + itm + lm)
    assert g_lm.abs().max() > 0 and g_rest.abs().max() > 0
    torch.testing.assert_close(g_all, g_lm + g_rest, atol=1e-7, rtol=0)

    ffn0 = shared.detach().clone()
    attn0 = state.params["decoder_attn"][0]["self_attn"]["query"]["kernel"].detach().clone()
    step = P.make_pretrain_step(vit, med)
    state, m = step(state, _batch(2), 0.4, torch.Generator().manual_seed(0))
    assert all(np.isfinite(float(m[k])) for k in ("loss", "loss_ita", "loss_itm", "loss_lm"))
    assert not torch.equal(shared, ffn0)
    assert not torch.equal(state.params["decoder_attn"][0]["self_attn"]["query"]["kernel"], attn0)


def test_select_frame_and_sentence_matches_jax():
    """The same ITM weights, frames and caption: the port picks JAX's frame
    and sentence (the sentence split is the port's own copy of the
    splitter); the scores it picks by agree within the MED bar."""
    from vidil_tpu.tokenizer import BlipTokenizer as JTok, write_test_vocab
    from vidil_tpu.train.frame_selection import select_frame_and_sentence as jselect
    from vidil_tpu.train.frame_selection import sentence_tokenization as jsplit
    from vidil_tpu_torch.tokenizer import BlipTokenizer
    from vidil_tpu_torch.train.frame_selection import (
        select_frame_and_sentence,
        sentence_tokenization,
    )

    import tempfile

    words = ["a", "dog", "runs", "the", "man", "sings", "on", "stage", "cat", "sleeps"]
    with tempfile.TemporaryDirectory() as tmp:
        vocab = os.path.join(tmp, "vocab.txt")
        write_test_vocab(vocab, words)
        jtok, tok = JTok(vocab), BlipTokenizer(vocab)
    med = dict(MED_KW, vocab_size=jtok.vocab_size)
    from vidil_tpu.models import convert as jconvert
    from vidil_tpu.models.testing import make_blip_itm_ckpt

    # random-normal weights: their ITM scores spread beyond both packages' rounding
    jvit, jmed = JViT(**VIT_KW), JMed(**med)
    jp = _np_tree(jconvert.convert_blip_itm(make_blip_itm_ckpt(jvit, jmed, 8, seed=5), jvit, jmed))
    tp = convert.from_jax_params(jp)
    for text in ("dog", "a cat sleeps * the dog runs / a man sings"):  # fallback, punctuation
        assert sentence_tokenization(text) == jsplit(text)
    text = "A dog runs. The man sings on stage; a cat sleeps\nthe dog"
    frames = np.random.RandomState(6).randn(3, 32, 32, 3).astype(np.float32) * 0.5
    jframe, jsent = jselect(jp, frames, text, jtok, JViT(**VIT_KW), JMed(**med))
    frame, sent = select_frame_and_sentence(tp, frames, text, tok, ViTConfig(**VIT_KW),
                                            MedConfig(**med))
    assert sent == jsent and len(jsplit(text)) == 4
    np.testing.assert_array_equal(np.asarray(frame), np.asarray(jframe))


# ---------------------------------------------------------------------------
# the CLI, on synthetic mp4s
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    cv2 = pytest.importorskip("cv2")
    from vidil_tpu.tokenizer import BlipTokenizer, write_test_vocab

    root = tmp_path_factory.mktemp("torch_pretrain_cli")
    videos = root / "videos"
    videos.mkdir()
    for vi in range(4):
        w = cv2.VideoWriter(str(videos / f"video{vi}.mp4"), cv2.VideoWriter_fourcc(*"mp4v"),
                            10, (64, 48))
        for i in range(20):
            w.write(np.full((48, 64, 3), (i * 9 + vi * 30) % 255, np.uint8))
        w.release()
    with open(root / "train.jsonl", "w") as f:
        for vi in range(4):
            for j in range(2):
                f.write(json.dumps({"caption": f"a test caption {vi} {j}",
                                    "clip_name": f"video{vi}"}) + "\n")
    vocab = str(root / "vocab.txt")
    write_test_vocab(vocab, ["a", "test", "caption", "0", "1", "2", "3"])
    med_path = str(root / "bert_config.json")
    with open(med_path, "w") as f:
        # 2 words short of the tokenizer: [DEC] and [ENC] widen it
        json.dump({"vocab_size": BlipTokenizer(vocab).vocab_size - 2, "hidden_size": 32,
                   "num_hidden_layers": 2, "num_attention_heads": 4,
                   "intermediate_size": 64, "max_position_embeddings": 64,
                   "encoder_width": 32, "add_cross_attention": True}, f)
    config = dict(
        dataset="pretrain", train_video_root=str(videos), train_ann_jsonl=str(root / "train.jsonl"),
        num_frm_train=2, frm_sampling_strategy="uniform", height=None, width=None,
        start_time=None, end_time=None, fps=-1, video_representation="concat_frame",
        bert_vocab=vocab, vit="tiny", vit_config={k: v for k, v in VIT_KW.items()
                                                  if k != "image_size"},
        med_config=med_path, batch_size=4, batch_size_tpu=8, init_lr=1e-5, warmup_lr=1e-6,
        warmup_steps=1, lr_decay_rate=0.9, queue_size=18, alpha=0.4, image_size=32,
        weight_decay=0.05, min_lr=1e-6, max_epoch=1)
    return types.SimpleNamespace(root=root, config=config)


def _args(out_dir):
    os.makedirs(out_dir, exist_ok=True)
    return types.SimpleNamespace(output_dir=out_dir, seed=42, world_size=1, dist_url="env://",
                                 distributed=False, device="cpu")


def test_pretrain_cli_logs_checkpoints_and_resumes(workdir, capsys):
    """One epoch on the CPU: a log.txt line with the three losses (finite),
    checkpoint_00.npz that the JAX package's load_checkpoint reads with
    the JAX pretraining model's key set and shapes (the vocabulary widened
    to the tokenizer's), checkpoint_last.npz that its load_train_state
    reads; resume continues from the saved step."""
    from vidil_tpu.models.blip_pretrain import init_pretrain_params as j_init
    from vidil_tpu.utils.checkpoint import load_checkpoint as j_load
    from vidil_tpu.utils.checkpoint import load_train_state as j_load_state
    from vidil_tpu_torch import pretrain_video as cli

    out = str(workdir.root / "out")
    state = cli.main(_args(out), dict(workdir.config))
    assert "ignoring batch_size_tpu=8" in capsys.readouterr().out
    assert state.step == 2 and state.queue.ptr == 8
    log = [json.loads(line) for line in open(os.path.join(out, "log.txt"))]
    assert {"loss_ita", "loss_itm", "loss_lm", "lr", "epoch"} <= set(log[-1])
    assert all(np.isfinite(log[-1][k]) for k in ("loss_ita", "loss_itm", "loss_lm"))

    med = JMed.from_json(workdir.config["med_config"])
    med = JMed(**{**med.__dict__, "vocab_size": med.vocab_size + 2})
    want = jax.eval_shape(lambda: j_init(jax.random.PRNGKey(0), JViT(**VIT_KW), med))
    shapes = lambda t: {jax.tree_util.keystr(p): np.shape(x)
                        for p, x in jax.tree_util.tree_leaves_with_path(t)}
    params, meta = j_load(os.path.join(out, "checkpoint_00.npz"))
    assert meta == {"epoch": 0} and shapes(params) == shapes(want)
    template = jax.eval_shape(lambda: JP.create_pretrain_state(
        jax.random.PRNGKey(0), JViT(**VIT_KW), med, j_make_optimizer(1e-5), queue_size=16))
    restored, meta = j_load_state(os.path.join(out, "checkpoint_last.npz"), template)
    assert meta == {"epoch": 0} and int(restored.step) == 2
    np.testing.assert_array_equal(restored.queue.image, state.queue.image.numpy())

    resumed = cli.main(_args(str(workdir.root / "resumed")),
                       dict(workdir.config, max_epoch=2,
                            resume=os.path.join(out, "checkpoint_last.npz")))
    assert resumed.step == 4 and resumed.queue.ptr == 0
    log = [json.loads(line) for line in open(workdir.root / "resumed" / "log.txt")]
    assert [entry["epoch"] for entry in log] == [1]
    assert os.path.exists(workdir.root / "resumed" / "checkpoint_01.npz")


def test_pretrain_cli_defaults_to_cuda_and_refuses_mesh_keys(workdir):
    from vidil_tpu_torch import pretrain_video as cli

    assert cli.parse_args([]).device == "cuda"
    # data_parallel x model_parallel must be the launch's world: a grid the
    # world does not fit raises ValueError
    with pytest.raises(ValueError, match="data_parallel"):
        cli.main(_args(str(workdir.root / "refused")), dict(workdir.config, data_parallel=2))
    with pytest.raises(ValueError, match="model_parallel"):
        cli.main(_args(str(workdir.root / "refused")), dict(workdir.config, model_parallel=2))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(types.SimpleNamespace(**dict(vars(_args(str(workdir.root / "nocuda"))),
                                                  device="cuda")), dict(workdir.config))
