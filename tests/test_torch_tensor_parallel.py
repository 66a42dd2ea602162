"""Tensor parallelism in the port (a (data, model) grid of ranks) against the
JAX package, on the CPU in fp32.

Two launches of gloo ranks (`parallel.dryrun.run_ranks`), a 2 x 2 grid and a
1 x 2 grid, run the caption, VQA, retrieval and pretraining steps at a
global batch of 4 (each data rank its rows, each model rank its heads and
hidden columns); the 2 x 2 launch also runs the caption step under ZeRO-1
with a save and reload of its state, and the 1 x 2 launch the pretraining
CLI for one step. The gradients are gathered into whole leaves.

Bars, each with its derivation:

* caption and VQA, the global loss at rtol 1e-5 and every gradient leaf at
  `dryrun.grad_bar` against JAX's one-device global-batch step: a
  row-parallel linear (proj, out, fc2) sums its two ranks' fp32 partial
  products, which reassociates its contraction as the data ranks' partial
  gradient sums reassociate theirs; on these towers that moves no leaf
  past the parity tests' bar.
* retrieval and pretraining: their fp32 gradients carry an error of their
  own of up to 1e-3 of a leaf's largest entry on these tiny synthetic
  towers (the contrastive logits over the queue at temperature 0.07, and
  leaves that are near-cancelling sums). The exact gradient g64 is the
  port's one-process loss evaluated in float64 on the same draws
  (`_float64_grads`; the tensor-parallel float64 evaluation equals it to
  1e-13, `test_momentum_float64_tensor_parallel_is_exact`). Let e be the
  one-process fp32 step's distance from g64, per leaf. Another rounding
  order redraws an error of that size, so the tensor-parallel step and
  JAX's each lie within 4 e + grad_bar of g64, and so within twice that of
  each other (the triangle inequality through g64).
* ZeRO-1 under a model axis: bitwise the plain AdamW step (each data rank
  updates its partition with the same arithmetic), and the saved and
  reloaded state bitwise its moments and its parameters.
* the pretraining CLI (bf16 towers, one step): its checkpoint_last.npz is
  read by JAX's `load_train_state`. Its loader draws the train
  augmentations in threads, so the frames are not the one-process CLI's
  and only what no frame moves is compared with it: the parameters within
  2 lr (AdamW's first step moves a parameter by lr * g / (|g| + eps), at
  most lr, whatever g is), the momentum towers bitwise (they move before
  the step's gradient), the queues' pointers, ids and untouched columns
  bitwise; the 8 new feature columns have unit norm within 2**-6 (four
  bf16 units); every file's moments are a first step's (exp_avg_sq =
  0.1 * exp_avg**2, rtol 1e-5).
"""

import concurrent.futures
import json
import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from vidil_tpu.config import MedConfig as JMed, ViTConfig as JViT
from vidil_tpu.models.blip import init_blip_decoder
from vidil_tpu.models.blip_vqa import init_blip_vqa
from vidil_tpu.train import pretrain as JP, retrieval as JTR
from vidil_tpu.train.caption import create_caption_train_state as j_create_caption
from vidil_tpu.train.caption import make_caption_train_step as j_caption_step
from vidil_tpu.train.vqa import create_vqa_train_state as j_create_vqa
from vidil_tpu.train.vqa import make_vqa_train_step as j_vqa_step
from vidil_tpu_torch.config import MedConfig, ViTConfig
from vidil_tpu_torch.models import convert
from vidil_tpu_torch.models.blip import blip_pretrain_shapes, blip_retrieval_shapes
from vidil_tpu_torch.parallel import dryrun as D
from vidil_tpu_torch.parallel import mesh, sharding
from vidil_tpu_torch.utils.checkpoint import _flatten, save_checkpoint
from vidil_tpu_torch.utils.synth import synth_tree

torch.set_num_threads(1)

B = 4
VIT_KW = dict(image_size=32, patch_size=16, hidden_size=32, num_layers=2, num_heads=4)
MED_KW = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
              intermediate_size=64, max_position_embeddings=64, encoder_width=32)
JV, JM = JViT(**VIT_KW), JMed(**MED_KW)
EMBED, QUEUE, GEN_SEED, LR = 8, 16, 5, 1e-4
GRIDS = {"2x2": (2, 2), "1x2": (1, 2)}
KINDS = ("caption", "vqa", "retrieval", "pretrain")


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _grad_capture():
    """An optax transformation whose state becomes the gradients it was
    given: JAX's own train step then hands back its gradients."""
    return optax.GradientTransformation(
        init=lambda p: jax.tree.map(jnp.zeros_like, p),
        update=lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


def _text(rng, n, L, first, pads):
    mask = np.ones((n, L), np.int64)
    for b, pad in enumerate(pads):
        if pad:
            mask[b, L - pad:] = 0
    ids = rng.randint(6, 64, size=(n, L)).astype(np.int64) * mask
    ids[:, 0] = first
    return ids, mask


def _batches(rng):
    """Global batches of 4 whose data ranks hold different numbers of valid
    tokens and of answers (a mean of per-rank means would be another
    loss)."""
    video = lambda: rng.randn(B, 2, 32, 32, 3).astype(np.float32) * 0.1  # noqa: E731
    ids, mask = _text(rng, B, 12, 1, (0, 5, 2, 7))
    out = {"caption": {"video": video(), "input_ids": ids, "attention_mask": mask}}
    n = [2, 1, 1, 3]
    q_ids, q_mask = _text(rng, B, 9, 3, (0, 2, 0, 0))
    a_ids, a_mask = _text(rng, sum(n), 5, 1, (0, 0, 2, 0, 0, 3, 0))
    out["vqa"] = {"video": video(), "question_ids": q_ids, "question_mask": q_mask,
                  "answer_ids": a_ids, "answer_mask": a_mask,
                  "answer_question_index": np.repeat(np.arange(B), n),
                  "weights": rng.uniform(0.1, 0.5, sum(n)).astype(np.float32)}
    for kind in ("retrieval", "pretrain"):
        ids, mask = _text(rng, B, 10, 0, (0, 3, 6, 0))
        enc, dec = ids.copy(), ids.copy()
        enc[:, 0], dec[:, 0] = 3, 1
        batch = {"video": video(), "text_ids": ids, "enc_ids": enc, "text_mask": mask}
        if kind == "pretrain":
            batch["dec_ids"] = dec
        else:
            batch["idx"] = np.asarray([0, 1, 1, 2], np.int64)  # two texts of video 1
        out[kind] = batch
    return out


def _momentum_state(kind):
    """The JAX package's train state (grad-capturing optimizer) over
    synthetic weights, with its queue."""
    shapes = blip_retrieval_shapes if kind == "retrieval" else blip_pretrain_shapes
    params = jax.tree.map(lambda t: t.numpy(), synth_tree(
        shapes(ViTConfig(**VIT_KW), MedConfig(**MED_KW), EMBED), "cpu", salt=3.0))
    params["temp"] = np.asarray(0.07, np.float32)
    create = JTR.create_train_state if kind == "retrieval" else JP.create_pretrain_state
    return jax.jit(lambda key, p: create(key, JV, JM, _grad_capture(), embed_dim=EMBED,
                                         queue_size=QUEUE, params=p))(jax.random.PRNGKey(1),
                                                                      params)


# ---------------------------------------------------------------------------
# the pretraining CLI's workspace
# ---------------------------------------------------------------------------

def _pretrain_workspace(root):
    import cv2

    from vidil_tpu_torch.tokenizer import BlipTokenizer, write_test_vocab

    videos = os.path.join(root, "videos")
    os.makedirs(videos)
    for vi in range(4):
        w = cv2.VideoWriter(os.path.join(videos, f"video{vi}.mp4"),
                            cv2.VideoWriter_fourcc(*"mp4v"), 10, (64, 48))
        for i in range(20):
            w.write(np.full((48, 64, 3), (i * 9 + vi * 30) % 255, np.uint8))
        w.release()
    with open(os.path.join(root, "train.jsonl"), "w") as f:
        for vi in range(4):
            for j in range(2):
                f.write(json.dumps({"caption": f"a test caption {vi} {j}",
                                    "clip_name": f"video{vi}"}) + "\n")
    vocab = os.path.join(root, "vocab.txt")
    write_test_vocab(vocab, ["a", "test", "caption", "0", "1", "2", "3"])
    med_path = os.path.join(root, "bert_config.json")
    with open(med_path, "w") as f:
        json.dump({"vocab_size": BlipTokenizer(vocab).vocab_size - 2, "hidden_size": 32,
                   "num_hidden_layers": 2, "num_attention_heads": 4,
                   "intermediate_size": 64, "max_position_embeddings": 64,
                   "encoder_width": 32, "add_cross_attention": True}, f)
    # one step: the 8 pairs in one global batch of 8
    return dict(dataset="pretrain", train_video_root=videos,
                train_ann_jsonl=os.path.join(root, "train.jsonl"), num_frm_train=2,
                frm_sampling_strategy="uniform", height=None, width=None, start_time=None,
                end_time=None, fps=-1, video_representation="concat_frame", bert_vocab=vocab,
                vit="tiny", vit_config={k: v for k, v in VIT_KW.items() if k != "image_size"},
                med_config=med_path, batch_size=8, init_lr=LR, warmup_lr=LR, warmup_steps=1,
                lr_decay_rate=0.9, queue_size=18, alpha=0.4, image_size=32, weight_decay=0.05,
                min_lr=1e-6, max_epoch=1)


def _trainer_workspaces(root, pretrain_config):
    """The caption, VQA and retrieval trainers' configs (synthetic weights,
    one epoch) beside the pretraining workspace's videos."""
    from vidil_tpu_torch.tokenizer import BlipTokenizer

    caption = next(ph["config"] for ph in D.write_cli_workspace(os.path.join(root, "caption"),
                                                                 3, 2, 2)
                   if ph["kind"] == "train_caption")
    videos = pretrain_config["train_video_root"]
    med_path = os.path.join(root, "med_full.json")
    with open(pretrain_config["med_config"]) as f:
        med = json.load(f)
    with open(med_path, "w") as f:
        json.dump(dict(med, vocab_size=BlipTokenizer(pretrain_config["bert_vocab"]).vocab_size),
                  f)

    def jsonl(name, rows):
        path = os.path.join(root, name)
        with open(path, "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in rows)
        return path

    words = ["a", "test", "caption"]
    vqa_rows = [{"question": f"a test {vi}", "answer": words[(vi + j) % 3],
                 "video_id": f"video{vi}"} for vi in range(4) for j in range(2)]
    with open(os.path.join(root, "answer_list.json"), "w") as f:
        json.dump(words, f)
    common = dict(num_frm_train=2, num_frm_test=2, frm_sampling_strategy="uniform",
                  height=None, width=None, start_time=None, end_time=None, fps=-1,
                  video_representation="concat_frame", bert_vocab=pretrain_config["bert_vocab"],
                  vit="tiny", vit_config=pretrain_config["vit_config"], med_config=med_path,
                  image_size=32, weight_decay=0.05, min_lr=0, max_epoch=1, init_lr=LR)
    vqa = dict(common, video_root=videos, train_ann_jsonl=jsonl("vqa_train.jsonl", vqa_rows),
               test_ann_jsonl=jsonl("vqa_test.jsonl", [dict(r, question_id=i) for i, r in
                                                       enumerate(vqa_rows[::2])]),
               answer_list_json=os.path.join(root, "answer_list.json"), batch_size_train=4,
               batch_size_test=2, inference="rank", k_test=2)
    pairs = [{"caption": f"a test caption {vi} {j}", "clip_name": f"video{vi}"}
             for vi in range(4) for j in range(2)]
    retrieval = dict(common, dataset="msrvtt", train_video_root=videos, eval_video_root=videos,
                     train_ann_jsonl=jsonl("ret_train.jsonl", pairs),
                     val_ann_jsonl=jsonl("ret_val.jsonl", pairs[::2]),
                     test_ann_jsonl=jsonl("ret_test.jsonl", pairs[::2]), batch_size_train=4,
                     batch_size_test=2, queue_size=16, alpha=0.4, k_test=2,
                     negative_all_rank=True)
    return {"train_caption": caption, "train_vqa": vqa, "train_retrieval": retrieval}


def _cli_args(out_dir):
    os.makedirs(out_dir, exist_ok=True)
    return types.SimpleNamespace(output_dir=out_dir, seed=42, world_size=1, dist_url="env://",
                                 distributed=False, device="cpu")


# ---------------------------------------------------------------------------
# the launches
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def run(tmp_path_factory):
    spec = str(tmp_path_factory.mktemp("torch_tensor_parallel"))
    batches = _batches(np.random.RandomState(0))
    base = {"vit": VIT_KW, "med": MED_KW, "lr": LR}
    inputs = {"caption": (_np_tree(init_blip_decoder(jax.random.PRNGKey(0), JV, JM)),),
              "vqa": (_np_tree(init_blip_vqa(jax.random.PRNGKey(3), JV, JM)),)}
    for kind in ("retrieval", "pretrain"):
        jstate = _momentum_state(kind)
        carried = convert.from_jax_train_state(_np_tree(jstate))
        save_checkpoint(os.path.join(spec, f"{kind}_params_m.npz"), carried["params_m"])
        q = carried["queue"]
        np.savez(os.path.join(spec, f"{kind}_queue.npz"), image=q.image.numpy(),
                 text=q.text.numpy(), idx=q.idx.numpy(), ptr=np.asarray(q.ptr))
        inputs[kind] = (_np_tree(jstate.params), jstate)
    for kind, (params, *_) in inputs.items():
        save_checkpoint(os.path.join(spec, f"{kind}_params.npz"), convert.from_jax_params(params))
        np.savez(os.path.join(spec, f"{kind}_batch.npz"), **batches[kind])
    ws = os.path.join(spec, "ws")
    cli_config = _pretrain_workspace(ws)
    trainers = _trainer_workspaces(ws, cli_config)

    def phases(model_grid):
        out = []
        for kind in KINDS:
            ph = {"name": kind, "kind": kind, "model": 2, **base}
            if kind == "caption":
                ph["prompt_length"] = 3
            if kind in ("retrieval", "pretrain"):
                ph.update(alpha=0.4, gen_seed=GEN_SEED)
            out.append(ph)
        if model_grid == "2x2":
            out.append({**out[0], "name": "caption_zero1", "inputs": "caption", "zero1": True,
                        "save_state": True})
        else:
            out.append({"name": "pretrain_cli", "kind": "pretrain_cli",
                        "config": dict(cli_config, model_parallel=2)})
            out += [{"name": kind, "kind": kind, "config": dict(config, model_parallel=2)}
                    for kind, config in trainers.items()]
        return out

    dirs = {}
    for name in GRIDS:
        dirs[name] = os.path.join(spec, name)
        os.makedirs(dirs[name])
        D.write_spec(dirs[name], phases(name))
        for f in os.listdir(spec):
            if f.endswith(".npz"):
                os.link(os.path.join(spec, f), os.path.join(dirs[name], f))
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        futures = {name: pool.submit(D.run_ranks, data * model, dirs[name],
                                     os.path.join(dirs[name], "out"), 300)
                   for name, (data, model) in GRIDS.items()}
        results = {name: f.result() for name, f in futures.items()}
    for name, res in results.items():
        for rank, (rc, out, err) in enumerate(res):
            assert rc == 0, f"{name} rank {rank} exited {rc}\n{out[-3000:]}\n{err[-3000:]}"
    got = {name: {ph: dict(np.load(os.path.join(dirs[name], "out", f"{ph}.npz")))
                  for ph in KINDS + (("caption_zero1",) if name == "2x2" else ())}
           for name in GRIDS}
    one_cli = os.path.join(spec, "one_cli")
    from vidil_tpu_torch import pretrain_video as cli

    cli.main(_cli_args(one_cli), dict(cli_config))
    return types.SimpleNamespace(spec=spec, inputs=inputs, batches=batches, got=got,
                                 cli=(one_cli, os.path.join(dirs["1x2"], "out", "pretrain_cli")),
                                 cli_config=cli_config, out=os.path.join(dirs["1x2"], "out"))


def _grads(npz: dict) -> dict:
    return {k[5:]: v for k, v in npz.items() if k.startswith("grad/")}


def _assert_grads(have: dict, want: dict, factor: float = 1.0):
    assert have.keys() == want.keys() and len(want) > 40
    g_max = max(float(np.abs(w).max()) for w in want.values())
    for path, w in want.items():
        np.testing.assert_allclose(have[path], w, rtol=0, atol=factor * D.grad_bar(w, g_max),
                                   err_msg=path)


@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("kind", ["caption", "vqa"])
def test_step_matches_jax_global_batch(run, grid, kind):
    (params,) = run.inputs[kind]
    batch = run.batches[kind]
    if kind == "caption":
        jstate = j_create_caption(params, _grad_capture())
        jstate, jm = jax.jit(j_caption_step(JV, JM, _grad_capture(), prompt_length=3))(jstate,
                                                                                      batch)
    else:
        jstate = j_create_vqa(params, _grad_capture())
        jstate, jm = jax.jit(j_vqa_step(JV, JM, _grad_capture()))(jstate, batch)
    got = run.got[grid][kind]
    np.testing.assert_allclose(got["loss"], float(jm["loss"]), rtol=1e-5)
    _assert_grads(_grads(got), _flatten(_np_tree(jstate.opt_state)))


def _float64_grads(run, kind, negatives, grid=None):
    """The port's retrieval or pretraining loss in float64 (its fp32 islands
    too) on the given draws, after the step's momentum update, in one
    process or on `grid`'s shards: {JAX path: the whole gradient}."""
    from vidil_tpu_torch.models.blip_pretrain import pretrain_loss
    from vidil_tpu_torch.models.blip_retrieval import (
        QueueState,
        _map,
        momentum_update,
        retrieval_loss,
    )

    to64 = lambda t: t.to(torch.float64)  # noqa: E731
    load = lambda name: sharding.shard_params(  # noqa: E731
        D.load_tree(os.path.join(run.spec, f"{kind}_{name}.npz")), grid)
    mp = pytest.MonkeyPatch()
    mp.setattr(torch.Tensor, "float", lambda self, *a, **k: to64(self))
    try:
        params = _map(lambda t: to64(t).requires_grad_(True), load("params"))
        params_m = _map(to64, load("params_m"))
        q = np.load(os.path.join(run.spec, f"{kind}_queue.npz"))
        queue = QueueState(to64(torch.from_numpy(q["image"])), to64(torch.from_numpy(q["text"])),
                           torch.from_numpy(q["idx"]), int(q["ptr"]))
        b = {k: torch.from_numpy(v) for k, v in run.batches[kind].items()}
        b = {k: to64(v) if k == "video" else v.long() for k, v in b.items()}
        momentum_update(params, params_m, 0.995)
        neg = tuple(torch.from_numpy(n).long() for n in negatives)
        vit, med = ViTConfig(**VIT_KW), MedConfig(**MED_KW)
        if kind == "retrieval":
            losses = retrieval_loss(params, params_m, queue, b["video"], b["text_ids"],
                                    b["enc_ids"], b["text_mask"], 0.4, b["idx"], None, vit, med,
                                    negatives=neg, grid=grid)[:2]
        else:
            losses = pretrain_loss(params, params_m, queue, b["video"], b["text_ids"],
                                   b["enc_ids"], b["dec_ids"], b["text_mask"], 0.4, None, vit,
                                   med, negatives=neg, grid=grid)[:3]
        sum(losses).backward()
        grads = _map(lambda t: t.grad if t.grad is not None else torch.zeros_like(t), params)
        return {k: v.astype(np.float64)
                for k, v in D.jax_flat(sharding.gather_params(grads, grid)).items()}
    finally:
        mp.undo()


def _port_one_process(run, kind):
    """The port's one-process fp32 step on the global batch: its npz."""
    from vidil_tpu_torch.parallel.dryrun import _train_phase

    ph = {"name": f"{kind}_one", "kind": kind, "inputs": kind, "vit": VIT_KW, "med": MED_KW,
          "lr": LR, "alpha": 0.4, "gen_seed": GEN_SEED}
    out = os.path.join(run.spec, "one")
    os.makedirs(out, exist_ok=True)
    _train_phase(run.spec, out, ph)
    return dict(np.load(os.path.join(out, f"{kind}_one.npz")))


_REFERENCES: dict = {}


def _momentum_references(run, kind):
    """(the port's one-process fp32 step, JAX's step and metrics on its
    draws, the float64 gradient): computed once per kind."""
    if kind not in _REFERENCES:
        _, jstate = run.inputs[kind]
        one = _port_one_process(run, kind)
        negatives = (one["neg_video"], one["neg_text"])
        draws = iter(jnp.asarray(n, jnp.int32) for n in negatives)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax.random, "categorical", lambda key, logits, axis=-1: next(draws))
            make = JTR.make_retrieval_train_step if kind == "retrieval" else JP.make_pretrain_step
            jnew, jm = jax.jit(make(JV, JM, _grad_capture()))(jstate, run.batches[kind], 0.4,
                                                              jax.random.PRNGKey(0))
        _REFERENCES[kind] = (one, jnew, jm, _float64_grads(run, kind, negatives))
    return _REFERENCES[kind]


@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("kind", ["retrieval", "pretrain"])
def test_momentum_step_matches_jax_global_batch(run, grid, kind):
    """The ranks drew the one process's negatives over the global batch;
    the losses, queues and, within the bars of the module docstring, the
    gradients are JAX's on those draws."""
    got = run.got[grid][kind]
    one, jnew, jm, exact = _momentum_references(run, kind)
    for a, b in zip((got["neg_video"], got["neg_text"]), (one["neg_video"], one["neg_text"])):
        np.testing.assert_array_equal(a, b)
    for key in [k for k in ("loss", "loss_ita", "loss_itm", "loss_lm") if k in jm]:
        np.testing.assert_allclose(got[key], float(jm[key]), rtol=1e-5, err_msg=key)
    mine, theirs, ones = _grads(got), _flatten(_np_tree(jnew.opt_state)), _grads(one)
    g_max = max(float(np.abs(g).max()) for g in exact.values())
    for path, g in exact.items():
        bar = 4 * float(np.abs(ones[path] - g).max()) + D.grad_bar(g, g_max)
        assert float(np.abs(mine[path] - g).max()) <= bar, path
        assert float(np.abs(mine[path] - theirs[path]).max()) <= 2 * bar, path
    for name in ("image", "text"):
        np.testing.assert_allclose(got[f"queue_{name}"], np.asarray(getattr(jnew.queue, name)),
                                   atol=3e-5, rtol=0)
    np.testing.assert_array_equal(got["queue_idx"], np.asarray(jnew.queue.idx))
    assert int(got["queue_ptr"]) == int(jnew.queue.ptr) == B


def test_zero1_under_tensor_parallel_equals_adamw(run):
    """The 2 x 2 caption step under ZeRO-1 (each data rank updates its
    partition of its model rank's shards): bitwise the plain AdamW step;
    its saved state reloads its moments bitwise, and the reloaded shards
    gather into the step's whole parameters bitwise (save gathers, load
    slices)."""
    plain, zero1 = run.got["2x2"]["caption"], run.got["2x2"]["caption_zero1"]
    params = [k for k in plain if k.startswith("param/")]
    assert len(params) > 40
    for k in params:
        np.testing.assert_array_equal(zero1[k], plain[k], err_msg=k)
        np.testing.assert_array_equal(zero1[f"reloaded_{k}"], plain[k], err_msg=k)
    assert bool(zero1["reload_equal"])


def test_pretrain_cli_state_is_read_by_jax(run):
    """The pretraining CLI over a 1 x 2 grid: its checkpoint_last.npz in the
    JAX leaf layout with whole leaves, within the bars of the module
    docstring of the one-process CLI's."""
    from vidil_tpu.utils.checkpoint import load_train_state as j_load_state
    from vidil_tpu.train.retrieval import make_optimizer as j_make_optimizer

    med = JMed.from_json(run.cli_config["med_config"])
    med = JMed(**{**med.__dict__, "vocab_size": med.vocab_size + 2})
    template = jax.eval_shape(lambda: JP.create_pretrain_state(
        jax.random.PRNGKey(0), JViT(**VIT_KW), med, j_make_optimizer(LR), queue_size=16))
    states = [j_load_state(os.path.join(d, "checkpoint_last.npz"), template)
              for d in run.cli]
    (one, meta_one), (tp, meta_tp) = states
    assert meta_one == meta_tp == {"epoch": 0} and int(one.step) == int(tp.step) == 1
    for a, b in zip(jax.tree.leaves(one.params), jax.tree.leaves(tp.params)):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=0,
                                   atol=2 * LR * (1 + 1e-3) + 1e-6)
    for a, b in zip(jax.tree.leaves(one.params_m), jax.tree.leaves(tp.params_m)):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
    assert int(one.queue.ptr) == int(tp.queue.ptr) == 8
    np.testing.assert_array_equal(np.asarray(tp.queue.idx), np.asarray(one.queue.idx))
    for name in ("image", "text"):
        mine, theirs = np.asarray(getattr(tp.queue, name)), np.asarray(getattr(one.queue, name))
        np.testing.assert_array_equal(mine[:, 8:], theirs[:, 8:])
        np.testing.assert_allclose(np.linalg.norm(mine[:, :8], axis=0), 1.0, atol=2.0 ** -6)
    for state in (one, tp):
        adam = next(x for x in jax.tree_util.tree_leaves(
            state.opt_state, is_leaf=lambda x: hasattr(x, "mu")) if hasattr(x, "mu"))
        for m, v in zip(jax.tree.leaves(adam.mu), jax.tree.leaves(adam.nu)):
            np.testing.assert_allclose(np.asarray(v), 0.1 * np.asarray(m) ** 2, rtol=1e-5,
                                       atol=1e-30)


@pytest.mark.parametrize("cli", ["train_caption", "train_vqa", "train_retrieval",
                                 "pretrain_cli"])
def test_trainer_cli_trains_over_a_model_axis(run, cli):
    """Each of the four trainer CLIs with ``model_parallel: 2`` over the
    1 x 2 grid: one epoch, its evaluation on the gathered weights and its
    files, the checkpoints with whole leaves (the JAX package's
    `load_checkpoint` reads the parameters in the one-process shapes)."""
    from vidil_tpu.utils.checkpoint import load_checkpoint as j_load

    out = os.path.join(run.out, cli)
    best = "checkpoint_00.npz" if cli == "pretrain_cli" else "checkpoint_best.npz"
    params, _ = j_load(os.path.join(out, best))
    vit = params["visual_encoder"]["blocks"]
    assert vit["attn"]["qkv"]["kernel"].shape == (2, 32, 96)
    assert vit["mlp"]["fc2"]["kernel"].shape == (2, 128, 32)
    assert os.path.exists(os.path.join(out, "checkpoint_last.npz"))
    if cli == "train_vqa":
        result = json.load(open(os.path.join(out, "result", "vqa_result_epoch0.json")))
        assert sorted(r["question_id"] for r in result) == [0, 1, 2, 3]
        assert {r["answer"] for r in result} <= {"a", "test", "caption"}
    else:
        log = [json.loads(line) for line in open(os.path.join(out, "log.txt"))]
        assert len(log) == 1 and log[0]["epoch"] == 0
        assert all(np.isfinite(v) for k, v in log[0].items()
                   if isinstance(v, float) and k != "best_epoch")


@pytest.mark.parametrize("kind", ["retrieval", "pretrain"])
def test_momentum_float64_tensor_parallel_is_exact(run, kind, tmp_path):
    """The tensor-parallel retrieval and pretraining losses in float64 over a
    1 x 2 grid equal the one process's to 1e-13 of the largest gradient:
    the model axis changes only the rounding (the fp32 bars above)."""
    got = run.got["1x2"][kind]
    negatives = (got["neg_video"], got["neg_text"])
    one = _momentum_references(run, kind)[3]
    np.savez(tmp_path / "neg.npz", video=negatives[0], text=negatives[1])
    worker = tmp_path / "worker.py"
    worker.write_text(f'''
import sys, numpy as np, torch
sys.path.insert(0, {os.path.dirname(os.path.abspath(__file__))!r})
import test_torch_tensor_parallel as T
from vidil_tpu_torch.parallel.mesh import make_grid
from vidil_tpu_torch.utils import dist
torch.set_num_threads(1)
dist.init_distributed_mode(backend="gloo", device="cpu")
grid = make_grid(1, 2)
n = np.load({str(tmp_path / "neg.npz")!r})
run = T.types.SimpleNamespace(spec={run.spec!r}, batches=T._batches(np.random.RandomState(0)))
g = T._float64_grads(run, {kind!r}, (n["video"], n["text"]), grid)
if dist.get_rank() == 0:
    np.savez({str(tmp_path / "tp.npz")!r}, **g)
dist.destroy_distributed()
''')
    import sys

    res = D.spawn_ranks(2, [sys.executable, str(worker)], str(tmp_path / "logs"), 300,
                        env={"OMP_NUM_THREADS": "1"})
    for rank, (rc, out, err) in enumerate(res):
        assert rc == 0, f"rank {rank} exited {rc}\n{out[-3000:]}\n{err[-3000:]}"
    tp = dict(np.load(tmp_path / "tp.npz"))
    g_max = max(float(np.abs(g).max()) for g in one.values())
    assert tp.keys() == one.keys()
    for path, g in one.items():
        assert float(np.abs(tp[path] - g).max()) <= 1e-13 * g_max, path


# ---------------------------------------------------------------------------
# without ranks
# ---------------------------------------------------------------------------

def _trees():
    from vidil_tpu_torch.models import blip, blip_vqa

    vit, med = ViTConfig(**VIT_KW), MedConfig(**MED_KW)
    shapes = {"decoder": blip.blip_decoder_shapes(vit, med),
              "vqa": blip_vqa.blip_vqa_shapes(vit, med),
              "retrieval": blip.blip_retrieval_shapes(vit, med, EMBED),
              "pretrain": blip.blip_pretrain_shapes(vit, med, EMBED)}
    return {k: convert.from_jax_params(synth_tree(v, "cpu", salt=1.0)) for k, v in shapes.items()}


@pytest.mark.parametrize("divisible_by", [1, 2, 3, 5])
def test_partition_table_equals_jax_model_partition_spec(divisible_by):
    """Every leaf's spec is JAX's `model_partition_spec` of the same leaf in
    the JAX layout (the stacked layer axis dropped), the `divisible_by`
    rule included: at 3 the 32-wide dimensions stay replicated while the
    fused qkv's 96 columns shard, at 5 every leaf stays replicated."""
    from jax.sharding import PartitionSpec as P

    from vidil_tpu.parallel.sharding import model_partition_spec as j_spec

    for name, tree in _trees().items():
        jax_tree = convert.to_jax_params(tree)
        want = {jax.tree_util.keystr(p, simple=True, separator="/"): s
                for p, s in jax.tree_util.tree_leaves_with_path(
                    j_spec(jax_tree, divisible_by=divisible_by),
                    is_leaf=lambda x: isinstance(x, P))}
        got = sharding.model_partition_spec(tree, divisible_by=divisible_by)
        seen = set()
        for path, spec in got.items():
            parts = path.split("/")
            stacked = any(p.isdigit() for p in parts)
            jpath = "/".join(p for p in parts if not p.isdigit())
            assert P(*((None,) + spec if stacked and spec else spec)) == want[jpath], (name, path)
            seen.add(jpath)
        assert seen == set(want), name
        n_sharded = sum(bool(s) for s in got.values())
        assert (n_sharded > 0) == (divisible_by != 5), (name, divisible_by)


def test_shards_tile_every_leaf():
    """`shard_params` over the model ranks of a grid: the ranks' slices of
    a sharded leaf tile it (concatenated along the sharded axis in rank
    order), the fused qkv by heads (rank m: its heads of q, of k, of v);
    the replicated leaves are the tree's own. A width the model axis does
    not divide raises ValueError."""
    tree = _trees()["pretrain"]
    specs = sharding.model_partition_spec(tree, divisible_by=2)
    shards = [sharding.shard_params(tree, mesh.Grid(model=2, model_rank=m)) for m in range(2)]
    full = dict(convert.named_leaves(tree))
    local = [dict(convert.named_leaves(s)) for s in shards]
    for path, t in full.items():
        spec = specs[path]
        if not spec:
            assert all(loc[path] is t for loc in local), path
            continue
        axis = spec.index("model")
        if path.endswith(("qkv/kernel", "qkv/bias")):
            parts = [loc[path].unflatten(axis, (3, -1)) for loc in local]
            joined = torch.cat(parts, dim=axis + 1).flatten(axis, axis + 1)
            d = t.shape[axis] // 3
            q0 = t.narrow(axis, 0, d // 2)
            assert torch.equal(local[0][path].narrow(axis, 0, d // 2), q0), path
        else:
            joined = torch.cat([loc[path] for loc in local], dim=axis)
        assert torch.equal(joined, t), path
    with pytest.raises(ValueError, match="model_parallel 3"):
        sharding.shard_params(tree, mesh.Grid(model=3))


@pytest.mark.parametrize("data,model", [(2, 2), (1, 2), (4, 2), (2, 4), (8, 1)])
def test_grid_rank_order_equals_make_mesh(data, model):
    from vidil_tpu.parallel.mesh import make_mesh

    devices = jax.local_devices(backend="cpu")[: data * model]
    m = make_mesh(data=data, model=model, devices=devices)
    ids = np.vectorize(lambda d: devices.index(d))(m.devices)
    np.testing.assert_array_equal(mesh.rank_grid(data, model), ids)


def test_attention_gate_reads_the_global_shape(monkeypatch):
    """A data rank's (8, 12, 577, 64) call in a data world of 2 routes as the
    JAX package's `_flash_profitable` routes the global (16, 12, 577, 64):
    to the flash kernel (255.7 MB of logits); on its own it would not
    (127.8 MB). A model rank's 6 of 12 heads at 16 rows route as the 12
    heads. Through `vit_forward` too (ViT-B/384, one block, shapes only)."""
    from vidil_tpu.ops.flash_attention import _flash_profitable as j_gate
    from vidil_tpu_torch.models import vit as V
    from vidil_tpu_torch.ops import flash_attention as fa

    calls = []
    monkeypatch.setattr(fa, "flash_attention", lambda q, k, v: calls.append(
        ("flash", tuple(q.shape))) or torch.empty_like(q))
    monkeypatch.setattr(fa, "dot_product_attention", lambda q, k, v, bias=None: calls.append(
        ("plain", tuple(q.shape))) or torch.empty_like(q))
    shape = lambda *s: types.SimpleNamespace(shape=s)  # noqa: E731
    for local, grid in (((8, 12, 577, 64), (2, 1)), ((8, 12, 577, 64), (1, 1)),
                        ((16, 6, 577, 64), (1, 2)), ((8, 6, 577, 64), (2, 2)),
                        ((16, 6, 577, 64), (1, 1))):
        q = torch.empty(local, device="meta")
        calls.clear()
        fa.attention_auto(q, q, q, grid=grid)
        glob = (local[0] * grid[0], local[1] * grid[1]) + local[2:]
        want = "flash" if j_gate(shape(*glob), shape(*glob), None) else "plain"
        assert calls == [(want, local)], (local, grid)
    assert j_gate(shape(16, 12, 577, 64), shape(16, 12, 577, 64), None)
    assert not j_gate(shape(8, 12, 577, 64), shape(8, 12, 577, 64), None)

    cfg = ViTConfig(image_size=384, hidden_size=768, num_layers=1, num_heads=12)
    from vidil_tpu_torch.models import blip

    params = jax.tree.map(lambda s: torch.empty(s, device="meta"),
                          blip.vit_shapes(cfg), is_leaf=lambda s: isinstance(s, tuple))
    params = convert.from_jax_params(params)
    images = torch.empty((8, 384, 384, 3), device="meta")
    for grid, want in ((mesh.Grid(data=2), "flash"), (mesh.Grid(), "plain"), (None, "plain")):
        calls.clear()
        V.vit_forward(params, images, cfg, grid=grid)
        assert calls == [(want, (8, 12, 577, 64))], grid
