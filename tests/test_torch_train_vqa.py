"""The port's BLIP video-QA fine-tune (vidil_tpu_torch.models.blip_vqa,
train.vqa and its CLI) and the trainers' fused-block schedule, against the
JAX package's, on the CPU. Tiny sizes: ViT 32 wide, 2 layers at 32 px and
MED 32 wide for the classic schedule; ViT and MED 128 wide (two heads of
64), the ViT at 48 px, for the fused one, whose JAX kernels run in
interpret mode and whose port kernels run as their plain twins. Inputs come from numpy seeds and go
through both packages. Each test states its tolerance.
"""

import json
import os
import random
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from vidil_tpu.config import MedConfig as JMed, ViTConfig as JViT
from vidil_tpu.models import blip as JB, blip_vqa as JQ, convert as jconvert
from vidil_tpu.models.blip import init_blip_decoder
from vidil_tpu.models.blip_vqa import init_blip_vqa
from vidil_tpu.models.testing import make_med_sd, make_vit_sd, save_torch_ckpt
from vidil_tpu.train.caption import create_caption_train_state as j_create_caption
from vidil_tpu.train.caption import make_caption_train_step as j_caption_step
from vidil_tpu.train.vqa import create_vqa_train_state as j_create_vqa
from vidil_tpu.train.vqa import make_vqa_train_step as j_vqa_step
from vidil_tpu_torch.config import MedConfig, ViTConfig
from vidil_tpu_torch.models import blip as B, blip_vqa as Q, convert
from vidil_tpu_torch.ops import fused_vit_block as FV
from vidil_tpu_torch.train import caption as C, vqa as V

torch.set_num_threads(1)

VIT_KW = dict(image_size=32, patch_size=16, hidden_size=32, num_layers=2, num_heads=4)
MED_KW = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
              intermediate_size=64, max_position_embeddings=64, encoder_width=32)
# the fused schedule's sizes: a width the fused block takes (a multiple of
# 128, heads of 64); 48 px gives 10 tokens, padded to 128
FUSED_VIT_KW = dict(image_size=48, patch_size=16, hidden_size=128, num_layers=2, num_heads=2,
                    fused_block_interpret=True)
# (the VQA decoder cross-attends the question encoder's states, so MED's
# width is the ViT's, as in BLIP-base)
FUSED_MED_KW = dict(MED_KW, hidden_size=128, num_heads=2, intermediate_size=256,
                    encoder_width=128)


class FakeTok:
    bos_token_id = 1
    sep_token_id = 5
    pad_token_id = 0
    enc_token_id = 3


def _grad_capture():
    """An optax transformation whose state becomes the gradients it was
    given: JAX's own train step then hands back its step-1 gradients."""
    return optax.GradientTransformation(
        init=lambda p: jax.tree.map(jnp.zeros_like, p),
        update=lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


def _port_grads(state):
    def grads(node):
        if isinstance(node, dict):
            return {k: grads(v) for k, v in node.items()}
        if isinstance(node, list):
            return [grads(v) for v in node]
        return node.grad
    return convert.to_jax_params(grads(state.params))


def _assert_grads_match(state, want_grads, rel):
    """Every parameter gradient at atol `rel` * max |g| of its leaf, the
    scale at least 1e-6 of the model's largest gradient (leaves whose
    gradient is zero in exact arithmetic, such as the attention key
    biases, hold rounding noise on both sides)."""
    got = dict(jax.tree_util.tree_leaves_with_path(_port_grads(state)))
    want = dict(jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, want_grads)))
    assert got.keys() == want.keys() and len(got) > 40
    g_max = max(np.abs(w).max() for w in want.values())
    for path, w in want.items():
        assert got[path].shape == w.shape, path
        np.testing.assert_allclose(got[path], w, atol=rel * max(np.abs(w).max(), 1e-6 * g_max),
                                   rtol=0, err_msg=jax.tree_util.keystr(path))
    return got


def _vqa_batch(seed, image_size, vocab=64):
    """2 questions x 2 frames, 3 answers (ragged: 2 + 1), a padded tail on
    one question and one answer."""
    rng = np.random.RandomState(seed)
    q_mask = np.ones((2, 9), np.int32)
    q_mask[1, 7:] = 0
    q_ids = rng.randint(6, vocab, size=(2, 9)).astype(np.int32) * q_mask
    q_ids[:, 0] = FakeTok.enc_token_id
    a_mask = np.ones((3, 5), np.int32)
    a_mask[2, 3:] = 0
    a_ids = rng.randint(6, vocab, size=(3, 5)).astype(np.int32) * a_mask
    a_ids[:, 0] = FakeTok.bos_token_id
    return {"video": rng.randn(2, 2, image_size, image_size, 3).astype(np.float32) * 0.1,
            "question_ids": q_ids, "question_mask": q_mask,
            "answer_ids": a_ids, "answer_mask": a_mask,
            "answer_question_index": np.array([0, 0, 1], np.int32),
            "weights": np.array([0.2, 0.3, 0.2], np.float32)}


def _vqa_params(vit_kw, med_kw, seed):
    return jax.tree.map(np.asarray, init_blip_vqa(jax.random.PRNGKey(seed), JViT(**vit_kw),
                                                  JMed(**med_kw)))


# ---------------------------------------------------------------------------
# the model: loss, step, generation, ranking, conversion
# ---------------------------------------------------------------------------

def test_vqa_train_loss_matches_jax():
    """vqa_train_loss (the answer_question_index gather, per-answer weights,
    / B) on the same weights, embeddings and ids, fp32, atol 1e-6."""
    params = _vqa_params(VIT_KW, MED_KW, 0)
    b = _vqa_batch(1, 32)
    embeds = np.random.RandomState(2).randn(2, 10, 32).astype(np.float32)
    keys = ("question_ids", "question_mask", "answer_ids", "answer_mask", "answer_question_index")
    want = float(JQ.vqa_train_loss(params, jnp.asarray(embeds), *(jnp.asarray(b[k]) for k in keys),
                                   jnp.asarray(b["weights"]), JMed(**MED_KW), batch_size=2))
    got = float(Q.vqa_train_loss(convert.from_jax_params(params), torch.from_numpy(embeds),
                                 *(torch.from_numpy(b[k]).long() for k in keys),
                                 torch.from_numpy(b["weights"]), MedConfig(**MED_KW),
                                 batch_size=2))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_vqa_train_step_matches_jax_loss_and_grads():
    """The classic schedule (32 wide): step-1 loss at rtol 1e-5 and every
    gradient at 1e-5 of its leaf's max |g| (fp32; the attention twin and
    XLA sum in another order)."""
    params = _vqa_params(VIT_KW, MED_KW, 3)
    batch = _vqa_batch(4, 32)
    jstate = j_create_vqa(params, _grad_capture())
    jstate, jm = jax.jit(j_vqa_step(JViT(**VIT_KW), JMed(**MED_KW), _grad_capture()))(
        jstate, batch)
    state = V.create_vqa_train_state(convert.from_jax_params(params), 1e-4, device="cpu")
    step = V.make_vqa_train_step(ViTConfig(**VIT_KW), MedConfig(**MED_KW))
    state, m = step(state, batch)
    assert state.step == 1
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    got = _assert_grads_match(state, jstate.opt_state, 1e-5)
    assert all(np.abs(g).max() > 0 for p, g in got.items() if "qkv" in jax.tree_util.keystr(p))


@pytest.fixture(scope="module")
def trained():
    """Weights after a few JAX VQA steps on one batch, so that generation
    and ranking see a decoder with preferences, and the embeddings and
    question ids of that batch."""
    from vidil_tpu.train.retrieval import make_optimizer

    jv, jm = JViT(**VIT_KW), JMed(**MED_KW)
    opt = make_optimizer(1e-3)
    state = j_create_vqa(init_blip_vqa(jax.random.PRNGKey(5), jv, jm), opt)
    batch = _vqa_batch(6, 32)
    step = jax.jit(j_vqa_step(jv, jm, opt))
    for _ in range(3):
        state, _ = step(state, batch)
    params = jax.tree.map(np.asarray, state.params)
    embeds = np.array(JB.encode_video_frames(params, jnp.asarray(batch["video"]), jv))
    return params, convert.from_jax_params(params), embeds, batch


@pytest.mark.parametrize("beam_group_kv", [False, True])
def test_vqa_generate_ids_token_identical(trained, beam_group_kv):
    """Beam answers (3 beams, 8 tokens) from [DEC], fp32: token for token."""
    jp, tp, embeds, b = trained
    want = np.asarray(JQ.vqa_generate_ids(
        jp, jnp.asarray(embeds), jnp.asarray(b["question_ids"]), jnp.asarray(b["question_mask"]),
        JMed(**MED_KW), FakeTok, max_length=8, beam_group_kv=beam_group_kv))
    got = Q.vqa_generate_ids(tp, torch.from_numpy(embeds),
                             torch.from_numpy(b["question_ids"]).long(),
                             torch.from_numpy(b["question_mask"]).long(), MedConfig(**MED_KW),
                             FakeTok, max_length=8, beam_group_kv=beam_group_kv)
    assert got.shape == (2, 8) and (got[:, 0] == FakeTok.bos_token_id).all()
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("k", [4, 12])
def test_rank_answer_index_identical(trained, k):
    """Top-k first-token candidates, then the grouped full-answer rerank:
    the same answer indices (k = the whole list included)."""
    jp, tp, embeds, b = trained
    rng = np.random.RandomState(7)
    answers = rng.randint(6, 64, size=(12, 4)).astype(np.int32)
    answers[:, 0] = FakeTok.bos_token_id
    mask = np.ones_like(answers)
    mask[::3, 3:] = 0
    answers = answers * mask
    want = np.asarray(JQ.rank_answer(
        jp, jnp.asarray(embeds), jnp.asarray(b["question_ids"]), jnp.asarray(b["question_mask"]),
        jnp.asarray(answers), jnp.asarray(mask), k=k, med_cfg=JMed(**MED_KW), tokenizer=FakeTok))
    got = Q.rank_answer(tp, torch.from_numpy(embeds), torch.from_numpy(b["question_ids"]).long(),
                        torch.from_numpy(b["question_mask"]).long(),
                        torch.from_numpy(answers).long(), torch.from_numpy(mask).long(), k=k,
                        med_cfg=MedConfig(**MED_KW), tokenizer=FakeTok)
    np.testing.assert_array_equal(got.numpy(), want)


def _vqa_state_dict(vit_cfg, med_cfg, seed=0):
    """A BLIP_VQA state dict with the reference's key names."""
    rng = np.random.default_rng(seed)
    sd = make_vit_sd(vit_cfg, rng)
    sd.update(make_med_sd(med_cfg, rng, prefix="text_encoder."))
    sd.update(make_med_sd(med_cfg, rng, prefix="text_decoder.bert.",
                          lm_head_prefix="text_decoder."))
    return sd


def test_convert_blip_vqa_matches_jax():
    """Exactly the JAX converter's arrays, and the shapes of blip_vqa_shapes."""
    jv, jm = JViT(**VIT_KW), JMed(**MED_KW)
    sd = _vqa_state_dict(jv, jm)
    want = jax.tree.map(np.asarray, jconvert.convert_blip_vqa(sd, jv, jm))
    got = convert.to_jax_params(convert.convert_blip_vqa(
        {k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
        ViTConfig(**VIT_KW), MedConfig(**MED_KW)))
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)
    shapes = Q.blip_vqa_shapes(ViTConfig(**VIT_KW), MedConfig(**MED_KW))
    want_shapes = {jax.tree_util.keystr(p): np.shape(x)
                   for p, x in jax.tree_util.tree_leaves_with_path(want)}
    assert {jax.tree_util.keystr(p): tuple(s) for p, s in jax.tree_util.tree_leaves_with_path(
        shapes, is_leaf=lambda x: isinstance(x, tuple))} == want_shapes


# ---------------------------------------------------------------------------
# the trainers on the fused schedule, against JAX's (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("trainer", ["caption", "vqa"])
def test_fused_schedule_step_matches_jax(monkeypatch, trainer):
    """The trainers' default schedule, `training_cfgs` with the fused pair,
    at a width the fused block takes: JAX's step runs its K4/K5 kernels in
    interpret mode, the port's its twins of them. fp32: the step-1 loss at
    rtol 1e-5 and every gradient at 2e-4 of its leaf's max |g| (the twins'
    exact erf against the kernels' A&S erf, and the summation order over
    the padded rows)."""
    monkeypatch.delenv("VIDIL_TPU_TRAIN_FUSED_BLOCK", raising=False)
    jv, jm = JViT(**FUSED_VIT_KW), JMed(**FUSED_MED_KW)
    pv, pm = ViTConfig(**FUSED_VIT_KW), MedConfig(**FUSED_MED_KW)
    if trainer == "caption":
        params = jax.tree.map(np.asarray, init_blip_decoder(jax.random.PRNGKey(8), jv, jm))
        rng = np.random.RandomState(9)
        ids = rng.randint(6, 64, size=(2, 10)).astype(np.int32)
        ids[:, 0] = 1
        batch = {"video": rng.randn(2, 2, 48, 48, 3).astype(np.float32) * 0.1,
                 "input_ids": ids, "attention_mask": np.ones((2, 10), np.int32)}
        jstate = j_create_caption(params, _grad_capture())
        jstep = j_caption_step(jv, jm, _grad_capture(), prompt_length=3)
        state = C.create_caption_train_state(convert.from_jax_params(params), 1e-4, device="cpu")
        step = C.make_caption_train_step(pv, pm, prompt_length=3)
    else:
        params = _vqa_params(FUSED_VIT_KW, FUSED_MED_KW, 10)
        batch = _vqa_batch(11, 48)
        jstate = j_create_vqa(params, _grad_capture())
        jstep = j_vqa_step(jv, jm, _grad_capture())
        state = V.create_vqa_train_state(convert.from_jax_params(params), 1e-4, device="cpu")
        step = V.make_vqa_train_step(pv, pm)
    jstate, jmetrics = jax.jit(jstep)(jstate, batch)
    calls = []
    real = FV.fused_vit_block
    monkeypatch.setattr("vidil_tpu_torch.models.vit.fused_vit_block",
                        lambda *a, **k: calls.append(k["pallas_bwd"]) or real(*a, **k))
    before = dict(FV.launch_counts)
    state, m = step(state, batch)
    assert calls == [True] * pv.num_layers  # the fused pair ran, block by block
    assert FV.launch_counts == before  # CPU: the twins, not the kernels
    np.testing.assert_allclose(float(m["loss"]), float(jmetrics["loss"]), rtol=1e-5)
    got = _assert_grads_match(state, jstate.opt_state, 2e-4)
    qkv = [g for p, g in got.items() if "visual_encoder" in jax.tree_util.keystr(p)
           and "qkv" in jax.tree_util.keystr(p)]
    assert qkv and all(np.abs(g).max() > 0 for g in qkv)


# ---------------------------------------------------------------------------
# data and the CLI, on synthetic mp4s
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    cv2 = pytest.importorskip("cv2")
    from vidil_tpu.tokenizer import BlipTokenizer, write_test_vocab

    root = tmp_path_factory.mktemp("torch_vqa_cli")
    videos = root / "videos"
    videos.mkdir()
    for vi in range(4):
        w = cv2.VideoWriter(str(videos / f"video{vi}.mp4"), cv2.VideoWriter_fourcc(*"mp4v"),
                            10, (64, 48))
        for i in range(20):
            w.write(np.full((48, 64, 3), (i * 9 + vi * 30) % 255, np.uint8))
        w.release()
    words = ["what", "is", "in", "the", "video", "red", "blue", "cat", "dog", "0", "1", "2", "3"]
    with open(root / "train.jsonl", "w") as f:
        for vi in range(4):
            for j in range(2):
                f.write(json.dumps({"question": f"What is in the video {vi}?",
                                    "answer": words[5 + (vi + j) % 4],
                                    "video_id": f"video{vi}"}) + "\n")
    with open(root / "test.jsonl", "w") as f:
        for vi in range(4):
            f.write(json.dumps({"question": f"what is in the video {vi}",
                                "answer": "cat", "video_id": f"video{vi}",
                                "question_id": 100 + vi}) + "\n")
    with open(root / "answer_list.json", "w") as f:
        json.dump(["red", "blue", "cat", "dog", "red cat"], f)
    vocab = str(root / "vocab.txt")
    write_test_vocab(vocab, words)
    med_path = str(root / "med_config.json")
    with open(med_path, "w") as f:
        json.dump({"vocab_size": BlipTokenizer(vocab).vocab_size, "hidden_size": 32,
                   "num_hidden_layers": 2, "num_attention_heads": 4,
                   "intermediate_size": 64, "max_position_embeddings": 64,
                   "encoder_width": 32, "add_cross_attention": True}, f)
    ckpt = str(root / "vqa.pth")
    save_torch_ckpt(_vqa_state_dict(JViT(**VIT_KW), JMed.from_json(med_path)), ckpt)
    config = dict(
        video_root=str(videos), train_ann_jsonl=str(root / "train.jsonl"),
        test_ann_jsonl=str(root / "test.jsonl"), answer_list_json=str(root / "answer_list.json"),
        num_frm_train=2, num_frm_test=2, frm_sampling_strategy="uniform",
        height=None, width=None, start_time=None, end_time=None, fps=-1,
        video_representation="concat_frame", pretrained=ckpt, bert_vocab=vocab,
        vit="tiny", vit_config={k: v for k, v in VIT_KW.items() if k != "image_size"},
        med_config=med_path, batch_size_train=2, batch_size_train_tpu=4, batch_size_test=3,
        init_lr=1e-4, image_size=32, inference="generate", k_test=3, weight_decay=0.05,
        min_lr=0, max_epoch=1)
    return types.SimpleNamespace(root=root, config=config)


def test_vqa_data_matches_jax_package(workdir):
    """Seeded alike (random, np.random), the port's VQADataset (both splits,
    pre_question included) and vqa_collate give the JAX package's arrays
    and strings, exactly."""
    from vidil_tpu.data import datasets as jd
    from vidil_tpu.data.text_utils import pre_question as j_pre_question
    from vidil_tpu_torch.data import datasets as pd
    from vidil_tpu_torch.data.text_utils import pre_question

    out = []
    for mod in (jd, pd):
        random.seed(5)
        np.random.seed(5)
        train = mod.VQADataset(dict(workdir.config), split="train")
        test = mod.VQADataset(dict(workdir.config), split="test")
        out.append((mod.vqa_collate([train[i] for i in range(3)]),
                    [test[i] for i in range(len(test))]))
    (jtrain, jtest), (ptrain, ptest) = out
    np.testing.assert_array_equal(ptrain[0], jtrain[0])
    assert ptrain[1:3] == jtrain[1:3] and ptrain[4] == jtrain[4] == [1, 1, 1]
    np.testing.assert_array_equal(ptrain[3], jtrain[3])
    assert ptrain[1][0] == "what is in the video 0?"
    assert len(ptest) == len(jtest) == 4
    for (jv, jq, jid), (pv, pq, pid) in zip(jtest, ptest):
        np.testing.assert_array_equal(pv, jv)
        assert (pq, pid) == (jq, jid)
    for q in ("What's this? (a) dog; #1: yes!", "x " * 60, "trailing   "):
        assert pre_question(q) == j_pre_question(q)


def _cli_args(out_dir, evaluate=False):
    result_dir = os.path.join(out_dir, "result")
    os.makedirs(result_dir, exist_ok=True)
    return types.SimpleNamespace(output_dir=out_dir, result_dir=result_dir, evaluate=evaluate,
                                 seed=42, world_size=1, dist_url="env://", distributed=False,
                                 device="cpu")


def test_cli_trains_answers_checkpoints_and_resumes(workdir, capsys):
    """main(args, config) on the CPU for one epoch: a results json with an
    answer for every test question, checkpoint_best.npz that the JAX
    package's load_checkpoint reads with the JAX trainer's key set and
    shapes, and a resume that continues from the saved step."""
    from vidil_tpu.utils.checkpoint import load_checkpoint as j_load
    from vidil_tpu_torch import train_vqa_video as cli

    out = str(workdir.root / "out")
    state = cli.main(_cli_args(out), dict(workdir.config))
    assert "ignoring batch_size_train_tpu=4" in capsys.readouterr().out
    steps = 8 // 2  # 8 train questions, batch 2, drop_last
    assert state.step == steps
    results = json.load(open(os.path.join(out, "result", "vqa_result_epoch0.json")))
    assert sorted(r["question_id"] for r in results) == [100, 101, 102, 103]
    assert all(isinstance(r["answer"], str) for r in results)

    params, meta = j_load(os.path.join(out, "checkpoint_best.npz"))
    assert meta["epoch"] == 0
    want = init_blip_vqa(jax.random.PRNGKey(0), JViT(**VIT_KW),
                         JMed.from_json(workdir.config["med_config"]))
    shapes = lambda t: {jax.tree_util.keystr(p): np.shape(x)
                        for p, x in jax.tree_util.tree_leaves_with_path(t)}
    assert shapes(params) == shapes(want)

    resumed = cli.main(_cli_args(str(workdir.root / "resumed")),
                       dict(workdir.config, max_epoch=2,
                            resume=os.path.join(out, "checkpoint_last.npz")))
    assert resumed.step == 2 * steps
    assert os.path.exists(workdir.root / "resumed" / "result" / "vqa_result_epoch1.json")
    assert not os.path.exists(workdir.root / "resumed" / "result" / "vqa_result_epoch0.json")


def test_cli_rank_inference_answers_from_the_list(workdir):
    """--evaluate with inference: rank picks each answer from
    answer_list_json (top k_test first-token candidates, then the rerank)."""
    from vidil_tpu_torch import train_vqa_video as cli

    out = str(workdir.root / "rank")
    state = cli.main(_cli_args(out, evaluate=True), dict(workdir.config, inference="rank"))
    assert state.step == 0
    results = json.load(open(os.path.join(out, "result", "vqa_result_epoch0.json")))
    answer_list = json.load(open(workdir.config["answer_list_json"]))
    assert len(results) == 4 and all(r["answer"] in answer_list for r in results)


def test_cli_defaults_to_cuda_and_refuses_unported_keys(workdir):
    from vidil_tpu_torch import train_vqa_video as cli

    assert cli.parse_args([]).device == "cuda"
    for key, value in (("data_parallel", 2), ("model_parallel", 2),
                       ("optimizer_sharding", "zero1")):
        with pytest.raises(NotImplementedError, match=key):
            cli.main(_cli_args(str(workdir.root / "refused")), dict(workdir.config, **{key: value}))
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    args = _cli_args(str(workdir.root / "nocuda"))
    args.device = "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(args, dict(workdir.config))
