"""The port's caption trainer (vidil_tpu_torch.train.caption and its CLI)
against the JAX package's, on the CPU at a tiny size: ViT 32 wide, 2
layers, 4 heads at 32 px; MED 32 wide, 2 layers. Inputs come from numpy
seeds and go through both packages. Each test states its tolerance.
"""

import dataclasses
import json
import os
import random
import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from vidil_tpu.config import MedConfig as JMed, ViTConfig as JViT
from vidil_tpu.models import blip as JB, med as JM
from vidil_tpu.models.blip import init_blip_decoder
from vidil_tpu.train.caption import create_caption_train_state as j_create
from vidil_tpu.train.caption import make_caption_train_step as j_make_step
from vidil_tpu.train.retrieval import make_optimizer as j_make_optimizer
from vidil_tpu_torch.config import MedConfig, ViTConfig
from vidil_tpu_torch.models import blip as B, convert, med as M
from vidil_tpu_torch.train import caption as C
from vidil_tpu_torch.train.common import make_optimizer, resolve_train_batch, set_lr

torch.set_num_threads(1)

VIT_KW = dict(image_size=32, patch_size=16, hidden_size=32, num_layers=2, num_heads=4)
MED_KW = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
              intermediate_size=64, max_position_embeddings=64, encoder_width=32)
PROMPT_LENGTH = 3


def _jax_params(seed=0):
    params = init_blip_decoder(jax.random.PRNGKey(seed), JViT(**VIT_KW), JMed(**MED_KW))
    return jax.tree.map(np.asarray, params)


def _batch(seed=0, B=2, N=2, L=12):
    rng = np.random.RandomState(seed)
    mask = np.ones((B, L), np.int32)
    mask[1, 9:] = 0  # padded tail of one caption
    ids = rng.randint(6, 64, size=(B, L)).astype(np.int32)
    ids[:, 0] = 1
    ids[mask == 0] = 0
    return {"video": rng.randn(B, N, 32, 32, 3).astype(np.float32) * 0.1,
            "input_ids": ids, "attention_mask": mask}


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


def _leaves(tree):
    return dict(jax.tree_util.tree_leaves_with_path(tree))


def test_train_step_matches_jax_loss_and_grads():
    """fp32, the same numpy weights and batch: step-1 loss at rtol 1e-5
    (the port's attention twin and XLA's attention sum in another order)
    and every parameter gradient at atol 1e-5 * max |g| of its leaf. The
    attention key biases have a gradient that is zero in exact arithmetic
    (softmax ignores a constant added to a row of logits), so both sides
    hold rounding noise there: a leaf's scale is at least 1e-6 of the
    largest gradient of the model."""
    params = _jax_params()
    batch = _batch()
    jstate = j_create(params, _grad_capture())
    jstate, jm = jax.jit(j_make_step(JViT(**VIT_KW), JMed(**MED_KW), _grad_capture(),
                                     prompt_length=PROMPT_LENGTH))(jstate, batch)
    want_grads = jax.tree.map(np.asarray, jstate.opt_state)

    state = C.create_caption_train_state(convert.from_jax_params(params), 1e-4, device="cpu")
    step = C.make_caption_train_step(ViTConfig(**VIT_KW), MedConfig(**MED_KW),
                                     prompt_length=PROMPT_LENGTH)
    state, m = step(state, batch)
    assert state.step == 1
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    got, want = _leaves(_port_grads(state)), _leaves(want_grads)
    assert got.keys() == want.keys() and len(got) > 40
    g_max = max(np.abs(w).max() for w in want.values())
    for path, w in want.items():
        g = got[path]
        assert g.shape == w.shape, path
        np.testing.assert_allclose(g, w, atol=1e-5 * max(np.abs(w).max(), 1e-6 * g_max), rtol=0,
                                   err_msg=jax.tree_util.keystr(path))
    # the ViT qkv kernels get a gradient through the attention Function
    assert all(np.abs(g).max() > 0 for p, g in got.items() if "qkv" in jax.tree_util.keystr(p))


def test_adamw_matches_optax():
    """The optimizer alone: optax.adamw (the JAX trainer's make_optimizer)
    and the port's AdamW on the same gradients for two steps, with the LR
    changed between them as the per-epoch schedule does; params at atol
    1e-7, a few fp32 ulps of parameters at the model's init scale (|p| <
    0.25; the two libraries round the update's parts in another order)."""
    rng = np.random.RandomState(1)
    params = {"a": {"kernel": 0.05 * rng.randn(5, 3).astype(np.float32)},
              "blocks": {"w": 0.05 * rng.randn(2, 4).astype(np.float32)}}
    grads = [jax.tree.map(lambda x: rng.randn(*x.shape).astype(np.float32), params)
             for _ in range(2)]
    opt = j_make_optimizer(1e-2, weight_decay=0.05)
    jp, js = params, opt.init(params)
    port = convert.from_jax_params(params)
    leaves = {n: t.clone().requires_grad_(True) for n, t in convert.named_leaves(port)}
    topt = make_optimizer({"x": list(leaves.values())}, 1e-2, weight_decay=0.05)
    for i, g in enumerate(grads):
        lr = 1e-2 / (i + 1)
        js.hyperparams["learning_rate"] = jnp.asarray(lr)
        set_lr(topt, lr)
        upd, js = opt.update(g, js, jp)
        jp = optax.apply_updates(jp, upd)
        gp = dict(convert.named_leaves(convert.from_jax_params(g)))
        for n, t in leaves.items():
            t.grad = gp[n].clone()
        topt.step()
    want = dict(convert.named_leaves(convert.from_jax_params(jax.tree.map(np.asarray, jp))))
    for n, t in leaves.items():
        np.testing.assert_allclose(t.detach().numpy(), want[n].numpy(), atol=1e-7, rtol=0)


@pytest.mark.parametrize("reduction", ["mean", "none"])
def test_lm_loss_matches_jax(reduction):
    """med_lm_loss with label smoothing 0.1 and -100 labels, atol 1e-6 and
    rtol 2.4e-7: the per-sample sums of "none" reach ~33, where one fp32
    ulp is 3.8e-6."""
    rng = np.random.RandomState(2)
    logits = rng.randn(3, 7, 11).astype(np.float32) * 3
    labels = rng.randint(0, 11, size=(3, 7))
    labels[0, 2:4] = -100
    labels[2, :] = -100
    want = np.asarray(JM.med_lm_loss(jnp.asarray(logits), jnp.asarray(labels),
                                     label_smoothing=0.1, reduction=reduction))
    got = M.med_lm_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                        label_smoothing=0.1, reduction=reduction).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=2.4e-7)


def test_caption_loss_matches_jax():
    """blip_caption_loss (prompt and pad masking of the labels) on the same
    weights, embeddings and ids, fp32, atol 1e-6."""
    params = _jax_params(3)
    batch = _batch(4)
    embeds = np.random.RandomState(5).randn(2, 10, 32).astype(np.float32)
    want = float(JB.blip_caption_loss(params, jnp.asarray(embeds), jnp.asarray(batch["input_ids"]),
                                      jnp.asarray(batch["attention_mask"]), JMed(**MED_KW),
                                      prompt_length=PROMPT_LENGTH))
    got = float(B.blip_caption_loss(convert.from_jax_params(params), torch.from_numpy(embeds),
                                    torch.from_numpy(batch["input_ids"]).long(),
                                    torch.from_numpy(batch["attention_mask"]).long(),
                                    MedConfig(**MED_KW), prompt_length=PROMPT_LENGTH))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_remat_gives_the_same_step():
    """torch.utils.checkpoint is scheduling only: ViT and MED remat on or
    off give the same loss and gradients, bit for bit."""
    params = convert.from_jax_params(_jax_params(6))
    batch = _batch(7)
    out = []
    for vit_remat, med_remat in ((False, False), (True, True)):
        state = C.create_caption_train_state(params, 1e-4, device="cpu")
        step = C.make_caption_train_step(ViTConfig(**VIT_KW, remat=vit_remat),
                                         MedConfig(**MED_KW), PROMPT_LENGTH,
                                         med_remat=med_remat)
        state, m = step(state, batch)
        out.append((float(m["loss"]), _port_grads(state)))
    assert out[0][0] == out[1][0]
    for a, b in zip(jax.tree.leaves(out[0][1]), jax.tree.leaves(out[1][1])):
        np.testing.assert_array_equal(a, b)


def test_to_jax_params_inverts_from_jax_params():
    params = _jax_params(8)
    back = convert.to_jax_params(convert.from_jax_params(params))
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("cfg", [
    dict(vit=dict(use_fused_mlp=True)), dict(vit=dict(remat=True, remat_policy="dots")),
    dict(med=dict(use_fused_mlp=True)), dict(med=dict(remat_policy="dots"))])
def test_unported_switches_raise(cfg):
    with pytest.raises(NotImplementedError):
        ViTConfig(**VIT_KW, **cfg.get("vit", {}))
        MedConfig(**MED_KW, **cfg.get("med", {}))


def test_fused_schedule_request_raises(monkeypatch):
    """Asking for the fused schedule raised until the fused block (K4/K5)
    was ported; now VIDIL_TPU_TRAIN_FUSED_BLOCK=1 keeps a forward-only
    request, unset gives the pair, and what still raises is the fused MLP
    (K3) that a fused request cannot bring along."""
    from vidil_tpu_torch.train.common import training_cfgs

    monkeypatch.delenv("VIDIL_TPU_TRAIN_FUSED_BLOCK", raising=False)
    vit, med = training_cfgs(ViTConfig(**VIT_KW), MedConfig(**MED_KW))
    assert med.remat and not vit.remat
    assert vit.use_fused_block and vit.use_fused_block_bwd
    monkeypatch.setenv("VIDIL_TPU_TRAIN_FUSED_BLOCK", "1")
    vit, _ = training_cfgs(ViTConfig(**VIT_KW, use_fused_block=True), MedConfig(**MED_KW))
    assert vit.use_fused_block and not vit.use_fused_block_bwd
    with pytest.raises(NotImplementedError, match="use_fused_mlp"):
        dataclasses.replace(vit, use_fused_mlp=True)


def test_resolve_train_batch_reads_the_reference_key(capsys):
    assert resolve_train_batch({"train_batch_size": 12, "train_batch_size_tpu": 64},
                               "train_batch_size") == 12
    assert "ignoring train_batch_size_tpu=64" in capsys.readouterr().out
    assert resolve_train_batch({"train_batch_size": 8}, "train_batch_size") == 8


def test_step_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        C.create_caption_train_state(convert.from_jax_params(_jax_params()), 1e-4)


# ---------------------------------------------------------------------------
# data and the CLI, on synthetic mp4s (the fixture of tests/test_cli_train.py)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    cv2 = pytest.importorskip("cv2")
    from vidil_tpu.models.testing import make_blip_decoder_ckpt, save_torch_ckpt
    from vidil_tpu.tokenizer import BlipTokenizer, write_test_vocab

    root = tmp_path_factory.mktemp("torch_train_cli")
    videos = root / "videos"
    videos.mkdir()
    for vi in range(4):
        w = cv2.VideoWriter(str(videos / f"video{vi}.mp4"), cv2.VideoWriter_fourcc(*"mp4v"),
                            10, (64, 48))
        for i in range(20):
            w.write(np.full((48, 64, 3), (i * 9 + vi * 30) % 255, np.uint8))
        w.release()
    for name, n_per_video in (("train", 2), ("val", 1), ("test", 1)):
        with open(root / f"{name}.jsonl", "w") as f:
            k = 0
            for vi in range(4):
                for j in range(n_per_video):
                    f.write(json.dumps({"caption": f"a test caption {vi} {j}",
                                        "clip_name": f"video{vi}", "sen_id": k}) + "\n")
                    k += 1
    vocab = str(root / "vocab.txt")
    write_test_vocab(vocab, ["a", "test", "caption", "video", "of", "0", "1", "2", "3"])
    med_path = str(root / "med_config.json")
    with open(med_path, "w") as f:
        json.dump({"vocab_size": BlipTokenizer(vocab).vocab_size, "hidden_size": 32,
                   "num_hidden_layers": 2, "num_attention_heads": 4,
                   "intermediate_size": 64, "max_position_embeddings": 64,
                   "encoder_width": 32, "add_cross_attention": True}, f)
    vit_kw = {k: v for k, v in VIT_KW.items() if k != "image_size"}
    ckpt = str(root / "decoder.pth")
    save_torch_ckpt(make_blip_decoder_ckpt(JViT(**VIT_KW), JMed.from_json(med_path)), ckpt)
    config = dict(
        video_root=str(videos), train_ann_jsonl=str(root / "train.jsonl"),
        val_ann_jsonl=str(root / "val.jsonl"), test_ann_jsonl=str(root / "test.jsonl"),
        num_frm_train=2, num_frm_test=2, frm_sampling_strategy="uniform",
        height=None, width=None, start_time=None, end_time=None, fps=-1,
        video_representation="concat_frame", pretrained=ckpt, bert_vocab=vocab,
        vit="tiny", vit_config=vit_kw, med_config=med_path,
        train_batch_size=2, train_batch_size_tpu=4, test_batch_size=2, init_lr=1e-4,
        image_size=32, max_length=12, min_length=2, num_beams=2,
        prompt="a video of ", weight_decay=0.05, min_lr=0, max_epoch=1)
    return types.SimpleNamespace(root=root, config=config)


def test_caption_data_matches_jax_package(workdir):
    """Seeded alike (random, np.random), the port's CaptionTrainDataset +
    PrefetchLoader and CaptionEvalDataset give the same arrays and captions
    as the JAX package's, exactly. One worker: the transforms draw from
    the global RNGs, so their order must be fixed."""
    from vidil_tpu.data import datasets as jd
    from vidil_tpu_torch.data import datasets as pd

    out = []
    for mod in (jd, pd):
        random.seed(5)
        np.random.seed(5)
        ds = mod.CaptionTrainDataset(dict(workdir.config), prompt="a video of ")
        loader = mod.PrefetchLoader(ds, 3, shuffle=True, drop_last=True, seed=1, num_workers=1)
        loader.set_epoch(1)
        ev = mod.CaptionEvalDataset(workdir.config["video_root"], workdir.config["val_ann_jsonl"],
                                    num_frm=2, max_img_size=32)
        out.append((list(loader), [ev[i] for i in range(len(ev))]))
    (jtrain, jeval), (ptrain, peval) = out
    assert len(ptrain) == len(jtrain) == 2
    for (jv, jc), (pv, pc) in zip(jtrain, ptrain):
        np.testing.assert_array_equal(pv, jv)
        assert pc == jc and all(c.startswith("a video of ") for c in pc)
    for (jv, jid), (pv, pid) in zip(jeval, peval):
        np.testing.assert_array_equal(pv, jv)
        assert pid == jid


def _cli_args(out_dir, evaluate=False):
    result_dir = os.path.join(out_dir, "result")
    os.makedirs(result_dir, exist_ok=True)
    return types.SimpleNamespace(output_dir=out_dir, result_dir=result_dir, evaluate=evaluate,
                                 seed=42, world_size=1, dist_url="env://", distributed=False,
                                 device="cpu")


def test_cli_trains_evaluates_checkpoints_and_resumes(workdir, capsys):
    """main(args, config) on the CPU for one epoch: checkpoints, log and
    results; checkpoint_best.npz loads through the JAX package's
    load_checkpoint with the JAX trainer's key set and shapes; resume
    restores the parameters, the AdamW moments and the step."""
    from vidil_tpu.utils.checkpoint import load_checkpoint as j_load
    from vidil_tpu_torch import train_caption_video as cli
    from vidil_tpu_torch.utils.checkpoint import load_train_state

    out = str(workdir.root / "out")
    state = cli.main(_cli_args(out), dict(workdir.config))
    assert "ignoring train_batch_size_tpu=4" in capsys.readouterr().out
    steps = 8 // 2  # 8 train captions, batch 2, drop_last
    assert state.step == steps
    for name in ("checkpoint_best.npz", "checkpoint_last.npz", "log.txt"):
        assert os.path.exists(os.path.join(out, name)), name
    log = [json.loads(line) for line in open(os.path.join(out, "log.txt"))]
    assert "test_CIDEr" in log[-1] and log[-1]["epoch"] == 0
    results = json.load(open(os.path.join(out, "result", "test_epoch0.json")))
    assert {r["video_id"] for r in results} == {f"video{i}" for i in range(4)}

    params, meta = j_load(os.path.join(out, "checkpoint_best.npz"))
    assert meta["epoch"] == 0
    want = init_blip_decoder(jax.random.PRNGKey(0), JViT(**VIT_KW),
                             JMed.from_json(workdir.config["med_config"]))
    shapes = lambda t: {jax.tree_util.keystr(p): np.shape(x)
                        for p, x in jax.tree_util.tree_leaves_with_path(t)}
    assert shapes(params) == shapes(want)

    # the saved train state restores into a fresh one
    fresh = C.create_caption_train_state(
        cli.build_model_and_tokenizer(workdir.config)[0], 1e-4, device="cpu")
    fresh, meta = load_train_state(os.path.join(out, "checkpoint_last.npz"), fresh)
    assert meta == {"epoch": 0} and fresh.step == steps
    for (_, a), (_, b) in zip(convert.named_leaves(fresh.params), convert.named_leaves(state.params)):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
        sa, sb = fresh.optimizer.state[a], state.optimizer.state[b]
        for key in ("exp_avg", "exp_avg_sq", "step"):
            torch.testing.assert_close(sa[key], sb[key], atol=0, rtol=0)

    # resume: epoch 1 of 2 continues from the saved step
    resumed = cli.main(_cli_args(str(workdir.root / "resumed")),
                       dict(workdir.config, max_epoch=2,
                            resume=os.path.join(out, "checkpoint_last.npz")))
    assert resumed.step == 2 * steps
    log = [json.loads(line) for line in open(workdir.root / "resumed" / "log.txt")]
    assert [entry["epoch"] for entry in log] == [1]


def test_cli_defaults_to_cuda_and_refuses_unported_keys(workdir):
    from vidil_tpu_torch import train_caption_video as cli

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
