"""``remat_policy: "dots"`` in the port (models/layers.py:remat_policy): the
selective checkpoint that keeps the plain GEMMs' outputs (aten.mm/addmm)
and recomputes the batched attention products and the elementwise ops, as
JAX's ``dots_with_no_batch_dims_saveable`` does. On the CPU in fp32, at the
parity tests' small sizes: the gradients bitwise those of the full remat
(a saved GEMM output is the value the recompute would produce), within the
parity bar (`dryrun.grad_bar`) of JAX's caption step under its "dots"
policy, and more bytes kept after the forward than under the full remat.
"""

import gc
import weakref

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

import jax
import jax.numpy as jnp
import optax

from vidil_tpu.config import MedConfig as JMed, ViTConfig as JViT
from vidil_tpu.models.blip import init_blip_decoder
from vidil_tpu.train.caption import create_caption_train_state as j_create
from vidil_tpu.train.caption import make_caption_train_step as j_step
from vidil_tpu_torch.config import MedConfig, ViTConfig
from vidil_tpu_torch.models import blip, convert
from vidil_tpu_torch.parallel.dryrun import grad_bar
from vidil_tpu_torch.train.caption import create_caption_train_state, make_caption_train_step
from vidil_tpu_torch.utils.checkpoint import _flatten

torch.set_num_threads(1)

VIT_KW = dict(image_size=32, patch_size=16, hidden_size=32, num_layers=2, num_heads=4)
MED_KW = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
              intermediate_size=64, max_position_embeddings=64, encoder_width=32)


def _cfgs(policy):
    return (ViTConfig(**VIT_KW, remat=True, remat_policy=policy),
            MedConfig(**MED_KW, remat=True, remat_policy=policy))


@pytest.fixture(scope="module")
def inputs():
    params = jax.tree.map(np.asarray, init_blip_decoder(jax.random.PRNGKey(0), JViT(**VIT_KW),
                                                        JMed(**MED_KW)))
    rng = np.random.RandomState(0)
    mask = np.ones((3, 12), np.int64)
    mask[1, 8:] = 0
    ids = rng.randint(6, 64, size=(3, 12)).astype(np.int64) * mask
    ids[:, 0] = 1
    batch = {"video": rng.randn(3, 2, 32, 32, 3).astype(np.float32) * 0.1,
             "input_ids": ids, "attention_mask": mask}
    return params, batch


def _loss(params, batch, policy):
    vit, med = _cfgs(policy)
    video = torch.from_numpy(batch["video"])
    embeds = blip.encode_video_frames(params, video, vit)
    return blip.blip_caption_loss(params, embeds, torch.from_numpy(batch["input_ids"]),
                                  torch.from_numpy(batch["attention_mask"]), med,
                                  prompt_length=3)


def _grads(jparams, batch, policy):
    params = convert.from_jax_params(jparams)
    leaves = [p.requires_grad_(True) for _, p in convert.named_leaves(params)]
    _loss(params, batch, policy).backward()
    return [p.grad for p in leaves]


def test_dots_gradients_bitwise_full_remat(inputs):
    params, batch = inputs
    full, dots = _grads(params, batch, None), _grads(params, batch, "dots")
    assert len(full) > 40
    for a, b in zip(full, dots):
        assert torch.equal(a, b)


def test_dots_step_matches_jax_dots_step(inputs):
    """The port's caption step and JAX's, both under "dots" (ViT and MED),
    from the same weights: the loss at rtol 1e-5 and every gradient leaf
    at the parity tests' bar."""
    params, batch = inputs
    capture = optax.GradientTransformation(
        init=lambda p: jax.tree.map(jnp.zeros_like, p),
        update=lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))
    jv = JViT(**VIT_KW, remat=True, remat_policy="dots")
    jm = JMed(**MED_KW, remat=True, remat_policy="dots")
    jstate, jm_out = jax.jit(j_step(jv, jm, capture, prompt_length=3))(
        j_create(params, capture), batch)
    want = _flatten(jax.tree.map(np.asarray, jstate.opt_state))
    state = create_caption_train_state(convert.from_jax_params(params), 1e-4, device="cpu")
    state, m = make_caption_train_step(*_cfgs("dots"), prompt_length=3)(state, batch)
    np.testing.assert_allclose(float(m["loss"]), float(jm_out["loss"]), rtol=1e-5)
    got = _flatten(convert.to_jax_params(jax.tree.map(
        lambda t: t.grad, state.params, is_leaf=lambda t: isinstance(t, torch.Tensor))))
    g_max = max(float(np.abs(w).max()) for w in want.values())
    assert got.keys() == want.keys()
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=0, atol=grad_bar(w, g_max), err_msg=path)


class _Live(TorchDispatchMode):
    """Every tensor the ops make, by weak reference: those still alive once
    the forward returns are what the autograd graph and the checkpoint
    keep for the backward."""

    def __init__(self):
        super().__init__()
        self.made = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor):
                self.made.append((weakref.ref(t), t.untyped_storage().data_ptr(),
                                  t.untyped_storage().nbytes()))
        return out

    def live_bytes(self):
        gc.collect()
        return sum(dict((ptr, n) for ref, ptr, n in self.made if ref() is not None).values())


def test_dots_keeps_more_bytes_than_full_remat(inputs):
    """The saved-tensor hooks of an outer `saved_tensors_hooks` do not see
    what a checkpoint keeps (the checkpoint's own hooks are innermost), so
    the bytes are counted as the tensors made in the forward that are
    still alive after it: the full remat keeps the layers' inputs only, the
    "dots" policy the plain GEMM outputs besides."""
    jparams, batch = inputs
    kept = {}
    for policy in (None, "dots"):
        params = convert.from_jax_params(jparams)
        for _, p in convert.named_leaves(params):
            p.requires_grad_(True)
        with _Live() as live:
            loss = _loss(params, batch, policy)
        kept[policy] = live.live_bytes()
        loss.backward()
    assert kept["dots"] > kept[None] > 0
