"""The port's data-parallel train steps against the JAX package's
one-process step at the global batch, on the CPU in fp32: one launch of two
gloo ranks (`parallel.dryrun.run_ranks`) runs a caption, a VQA, a
retrieval and a pretraining step, each rank on its rows of a global batch
of 4, and the summed gradients and global losses must equal JAX's
global-batch step on the same weights (through the port's converter).

The batches hold the trap the port must avoid: the ranks' rows carry
different numbers of valid tokens (caption, pretraining LM) and of answers
(VQA), so a mean of per-rank means would be another loss. The retrieval and
pretraining steps draw their hard negatives in the step, over the global
batch; the test hands the same draws to JAX's loss (its categorical draws
replaced by them) and checks that they equal the port's one-process draws
from the same generator.

Bars, each with its derivation: the losses at rtol 1e-5 and every gradient
leaf at `dryrun.grad_bar` (1e-5 of the leaf's largest entry, at least 1e-6
of the model's largest gradient; for the 0-d ``temp``, a sum of terms that
may cancel, 1e-5 of the larger of |g| and 1): the bars of the one-process
parity tests (tests/test_torch_train_caption.py, test_torch_retrieval.py),
since the ranks' partial sums only add in another order. The momentum
trainers' gradients are held to the port's own one-process step at that
bar (the ranks' order is all that differs), and to JAX's at twice it: on
these inputs the port's one-process retrieval step itself lies at 1.25x
the bar from JAX's (the ViT attention projection's kernel, 1% of its
entries, relative 1.4e-5: the two libraries' fp32 rounding orders through
the ITA and ITM mixtures), and the ranks add at most 0.08x the bar to
that. The queues: the MED bar (3e-5); their idx slots and pointers equal.
"""

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
from vidil_tpu_torch.utils.checkpoint import _flatten, save_checkpoint
from vidil_tpu_torch.utils.synth import synth_tree

torch.set_num_threads(1)

WORLD, B = 2, 4
VIT_KW = dict(image_size=32, patch_size=16, hidden_size=32, num_layers=2, num_heads=4)
MED_KW = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
              intermediate_size=64, max_position_embeddings=64, encoder_width=32)
JV, JM = JViT(**VIT_KW), JMed(**MED_KW)
EMBED, QUEUE = 8, 16
GEN_SEED = 5


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _grad_capture():
    """An optax transformation whose state becomes the gradients it was
    given: JAX's own train step then hands back its gradients."""
    return optax.GradientTransformation(
        init=lambda p: jax.tree.map(jnp.zeros_like, p),
        update=lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


def _caption_batch(rng):
    """4 captions, their pad tails 0, 5, 2 and 7 long: rank 0 holds 19
    valid tokens of the LM loss, rank 1 holds 14."""
    mask = np.ones((B, 12), np.int64)
    for b, pad in enumerate((0, 5, 2, 7)):
        mask[b, 12 - pad:] = 0
    ids = rng.randint(6, 64, size=(B, 12)).astype(np.int64) * mask
    ids[:, 0] = 1
    return {"video": rng.randn(B, 2, 32, 32, 3).astype(np.float32) * 0.1,
            "input_ids": ids, "attention_mask": mask}


def _vqa_batch(rng):
    """4 questions; answers ragged 2 + 1 (rank 0) and 1 + 3 (rank 1)."""
    q_mask = np.ones((B, 9), np.int64)
    q_mask[1, 7:] = 0
    q_ids = rng.randint(6, 64, size=(B, 9)).astype(np.int64) * q_mask
    q_ids[:, 0] = 3
    n = [2, 1, 1, 3]
    a_mask = np.ones((sum(n), 5), np.int64)
    a_mask[2, 3:] = 0
    a_mask[5, 2:] = 0
    a_ids = rng.randint(6, 64, size=(sum(n), 5)).astype(np.int64) * a_mask
    a_ids[:, 0] = 1
    return {"video": rng.randn(B, 2, 32, 32, 3).astype(np.float32) * 0.1,
            "question_ids": q_ids, "question_mask": q_mask, "answer_ids": a_ids,
            "answer_mask": a_mask, "answer_question_index": np.repeat(np.arange(B), n),
            "weights": rng.uniform(0.1, 0.5, sum(n)).astype(np.float32)}


def _momentum_batch(rng, pretrain):
    mask = np.ones((B, 10), np.int64)
    mask[1, 7:] = 0
    mask[2, 4:] = 0
    ids = rng.randint(6, 64, size=(B, 10)).astype(np.int64) * mask
    enc, dec = ids.copy(), ids.copy()
    enc[:, 0], dec[:, 0] = 3, 1
    batch = {"video": rng.randn(B, 2, 32, 32, 3).astype(np.float32) * 0.1, "text_ids": ids,
             "enc_ids": enc, "text_mask": mask}
    if pretrain:
        batch["dec_ids"] = dec
    else:
        batch["idx"] = np.asarray([0, 1, 1, 2], np.int64)  # two texts of video 1
    return batch


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


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    spec = str(tmp_path_factory.mktemp("torch_dist_train"))
    many = os.path.join(spec, "many")
    rng = np.random.RandomState(0)
    base = {"vit": VIT_KW, "med": MED_KW, "lr": 1e-4}
    phases, inputs = [], {}

    params = _np_tree(init_blip_decoder(jax.random.PRNGKey(0), JV, JM))
    batch = _caption_batch(rng)
    inputs["caption"] = (params, batch)
    phases.append({"name": "caption", "kind": "caption", "prompt_length": 3, **base})

    params = _np_tree(init_blip_vqa(jax.random.PRNGKey(3), JV, JM))
    inputs["vqa"] = (params, _vqa_batch(rng))
    phases.append({"name": "vqa", "kind": "vqa", **base})

    for kind in ("retrieval", "pretrain"):
        jstate = _momentum_state(kind)
        carried = convert.from_jax_train_state(_np_tree(jstate))
        save_checkpoint(os.path.join(spec, f"{kind}_params_m.npz"), carried["params_m"])
        q = carried["queue"]
        np.savez(os.path.join(spec, f"{kind}_queue.npz"), image=q.image.numpy(),
                 text=q.text.numpy(), idx=q.idx.numpy(), ptr=np.asarray(q.ptr))
        inputs[kind] = (_np_tree(jstate.params), _momentum_batch(rng, kind == "pretrain"),
                        jstate)
        phases.append({"name": kind, "kind": kind, "alpha": 0.4, "gen_seed": GEN_SEED, **base})

    for name, (params, batch, *_) in inputs.items():
        save_checkpoint(os.path.join(spec, f"{name}_params.npz"), convert.from_jax_params(params))
        np.savez(os.path.join(spec, f"{name}_batch.npz"), **batch)
    D.write_spec(spec, phases)
    results = D.run_ranks(WORLD, spec, many, timeout=300)
    for rank, (rc, out, err) in enumerate(results):
        assert rc == 0, f"rank {rank} exited {rc}\n{out[-3000:]}\n{err[-3000:]}"
    got = {name: dict(np.load(os.path.join(many, f"{name}.npz"))) for name in inputs}
    return types.SimpleNamespace(spec=spec, inputs=inputs, got=got, phases=phases)


def _assert_grads(got: dict, want: dict, factor: float = 1.0):
    """Every gradient of `got` (``grad/<path>``) against `want` ({path:
    array}) at `factor` times `dryrun.grad_bar`."""
    have = {k[5:]: v for k, v in got.items() if k.startswith("grad/")}
    assert have.keys() == want.keys() and len(want) > 40
    g_max = max(float(np.abs(w).max()) for w in want.values())
    for path, w in want.items():
        np.testing.assert_allclose(have[path], w, rtol=0, atol=factor * D.grad_bar(w, g_max),
                                   err_msg=path)


def test_caption_step_matches_jax_global_batch(run):
    params, batch = run.inputs["caption"]
    jstate = j_create_caption(params, _grad_capture())
    jstate, jm = jax.jit(j_caption_step(JV, JM, _grad_capture(), prompt_length=3))(jstate, batch)
    got = run.got["caption"]
    np.testing.assert_allclose(got["loss"], float(jm["loss"]), rtol=1e-5)
    _assert_grads(got, _flatten(_np_tree(jstate.opt_state)))


def test_vqa_step_matches_jax_global_batch(run):
    params, batch = run.inputs["vqa"]
    jstate = j_create_vqa(params, _grad_capture())
    jstate, jm = jax.jit(j_vqa_step(JV, JM, _grad_capture()))(jstate, batch)
    got = run.got["vqa"]
    np.testing.assert_allclose(got["loss"], float(jm["loss"]), rtol=1e-5)
    _assert_grads(got, _flatten(_np_tree(jstate.opt_state)))


def _port_one_process(kind, run):
    """The port's one-process step on the global batch with the same
    generator: its outputs (draws, gradients)."""
    from vidil_tpu_torch.parallel.dryrun import _train_phase

    ph = dict(next(p for p in run.phases if p["name"] == kind), name=f"{kind}_one",
              inputs=kind)
    out = os.path.join(run.spec, "one")
    os.makedirs(out, exist_ok=True)
    _train_phase(run.spec, out, ph)
    return dict(np.load(os.path.join(out, f"{kind}_one.npz")))


@pytest.mark.parametrize("kind", ["retrieval", "pretrain"])
def test_momentum_step_matches_jax_global_batch(run, kind, monkeypatch):
    """The two-rank step drew its negatives over the global batch: the
    same draws and, within the summation-order bar, the same gradients as
    the port's one process from the same generator. JAX's step with those
    draws gives the same losses, gradients (twice the bar, module
    docstring) and queues."""
    params, batch, jstate = run.inputs[kind]
    got = run.got[kind]
    negatives = (got["neg_video"], got["neg_text"])
    assert negatives[0].shape == (B,) and negatives[1].shape == (B,)
    one = _port_one_process(kind, run)
    for a, b in zip(negatives, (one["neg_video"], one["neg_text"])):
        np.testing.assert_array_equal(a, b)
    _assert_grads(got, {k[5:]: v for k, v in one.items() if k.startswith("grad/")})

    draws = iter(jnp.asarray(n, jnp.int32) for n in negatives)
    monkeypatch.setattr(jax.random, "categorical", lambda key, logits, axis=-1: next(draws))
    make = JTR.make_retrieval_train_step if kind == "retrieval" else JP.make_pretrain_step
    jnew, jm = jax.jit(make(JV, JM, _grad_capture()))(jstate, batch, 0.4,
                                                      jax.random.PRNGKey(0))
    for key in [k for k in ("loss", "loss_ita", "loss_itm", "loss_lm") if k in jm]:
        np.testing.assert_allclose(got[key], float(jm[key]), rtol=1e-5, err_msg=key)
    _assert_grads(got, _flatten(_np_tree(jnew.opt_state)), factor=2.0)
    for name in ("image", "text"):
        np.testing.assert_allclose(got[f"queue_{name}"], np.asarray(getattr(jnew.queue, name)),
                                   atol=3e-5, rtol=0)
    np.testing.assert_array_equal(got["queue_idx"], np.asarray(jnew.queue.idx))
    assert int(got["queue_ptr"]) == int(jnew.queue.ptr) == B
