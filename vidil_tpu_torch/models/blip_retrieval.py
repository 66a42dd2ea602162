"""BLIP retrieval (video): the ITA + ITM training losses, momentum towers and
feature queues.

Counterpart of ``vidil_tpu/models/blip_retrieval.py``. The momentum towers
and the queues are explicit state beside the parameters; the step updates
them in place (`momentum_update`, `dequeue_and_enqueue`). The batch is the
global one (the reference's ``negative_all_rank=True``).

Data parallelism (a `parallel/mesh.py:Grid`'s data axis): each data rank
holds its rows of the global batch, and the losses are its shares of the
global batch's (they sum to the one-process losses). The ITA rows meet the
data ranks' momentum features (`concat_all_gather` over the data group),
which also enter the queues, so every rank keeps the same queues. The hard
negatives are drawn over the global batch: every rank computes the global
similarities, draws the global (B,) index vectors from the same seeded
generator and takes its slice; a negative video from another data rank
reaches its ITM rows through `all_gather_with_grad`, whose backward
returns the gradient to the rank that encoded it. Under the grid's model
axis the towers (the momentum ones too) run on this rank's heads
(`vit_forward`, `med_forward`); the model ranks of one data rank compute
the same losses and queues.

Hard negatives: the JAX package draws them with ``jax.random.categorical``
over masked log-weights. Its key streams cannot be reproduced here, so the
port samples the same distribution by Gumbel-max (`sample_categorical`)
from a `torch.Generator`; `retrieval_loss` also takes the two index vectors
(``negatives``), which is how the tests run both packages on the same
draws.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vidil_tpu_torch.config import MedConfig, ViTConfig
from vidil_tpu_torch.models import med as M
from vidil_tpu_torch.models.blip import init_blip_itm
from vidil_tpu_torch.models.convert import named_leaves
from vidil_tpu_torch.models.layers import linear
from vidil_tpu_torch.models.vit import vit_forward
from vidil_tpu_torch.ops.generation import gumbel_argmax, gumbel_noise
from vidil_tpu_torch.parallel.collectives import all_gather_with_grad, concat_all_gather

MOMENTUM_KEYS = ("visual_encoder", "text_encoder", "vision_proj", "text_proj")


def init_retrieval_params(generator: torch.Generator, vit_cfg: ViTConfig, med_cfg: MedConfig,
                          embed_dim: int = 256, device=None):
    """Random retrieval parameters: the ITM model's (`init_blip_itm`) and
    the contrastive temperature ``temp``, 0.07."""
    params = init_blip_itm(generator, vit_cfg, med_cfg, embed_dim, device)
    params["temp"] = torch.tensor(0.07, device=params["itm_head"]["bias"].device)
    return params


class QueueState(NamedTuple):
    """Feature queues: image/text (embed_dim, Q) fp32, idx (1, Q) int32
    (-100 = empty), ptr the next slot (a host int: the batch is fixed, so
    the pointer never needs the device)."""

    image: torch.Tensor
    text: torch.Tensor
    idx: torch.Tensor
    ptr: int


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def init_momentum_params(params):
    """Momentum copies of the four towers: real copies (detached, no grad),
    not aliases of the trained parameters."""
    return {k: _map(lambda t: t.detach().clone(), params[k]) for k in MOMENTUM_KEYS}


def init_queue(generator: torch.Generator, embed_dim: int, queue_size: int,
               device=None) -> QueueState:
    """Unit-norm random queues (columns), drawn from `generator`."""
    img = torch.randn((embed_dim, queue_size), generator=generator, device=device)
    txt = torch.randn((embed_dim, queue_size), generator=generator, device=device)
    return QueueState(image=img / img.norm(dim=0, keepdim=True),
                      text=txt / txt.norm(dim=0, keepdim=True),
                      idx=torch.full((1, queue_size), -100, dtype=torch.int32, device=device),
                      ptr=0)


@torch.no_grad()
def momentum_update(params, params_m, momentum: float = 0.995):
    """params_m = params_m * m + params * (1 - m), in place (two products
    and a sum, as the JAX package computes it)."""
    pm = [t for k in MOMENTUM_KEYS for _, t in named_leaves(params_m[k])]
    p = [t.detach() for k in MOMENTUM_KEYS for _, t in named_leaves(params[k])]
    torch._foreach_mul_(pm, momentum)
    torch._foreach_add_(pm, torch._foreach_mul(p, 1.0 - momentum))
    return params_m


@torch.no_grad()
def dequeue_and_enqueue(queue: QueueState, image_feat, text_feat, idxs) -> QueueState:
    """Write the batch's features at ptr, in place, and advance it. The
    queue size must be a multiple of the batch (the reference asserts it)."""
    B = image_feat.shape[0]
    Q = queue.image.shape[1]
    if Q % B:
        raise ValueError(f"queue size {Q} is not a multiple of the batch {B}")
    ptr = queue.ptr
    queue.image[:, ptr:ptr + B] = image_feat.t().to(queue.image.dtype)
    queue.text[:, ptr:ptr + B] = text_feat.t().to(queue.text.dtype)
    queue.idx[:, ptr:ptr + B] = idxs.reshape(1, -1).to(torch.int32)
    return queue._replace(ptr=(ptr + B) % Q)


def sample_categorical(generator: torch.Generator, log_weights):
    """One draw per row of softmax(log_weights) (rows may hold -inf or
    -1e9): Gumbel-max with noise from `generator` on the weights' device,
    the draw nucleus sampling makes (ops/generation.py)."""
    return gumbel_argmax(log_weights, gumbel_noise(log_weights.shape, generator,
                                                   log_weights.device))


def _normalize(feat):
    """feat / ||feat|| with the norm taken in fp32 and cast back to the
    feature dtype (the JAX package's rounding)."""
    return feat / feat.float().norm(dim=-1, keepdim=True).to(feat.dtype)


def video_features(params, video, vit_cfg: ViTConfig, dtype=None, grid=None):
    """(B, N, S, S, C) -> (video_embeds (B, N*(P+1), D), video_feat (B, E)):
    per-frame CLS features projected, mean-pooled over frames, normalized;
    the full token grid feeds cross-attention."""
    B, N = video.shape[:2]
    embeds = vit_forward(params["visual_encoder"], video.reshape((B * N,) + video.shape[2:]),
                         vit_cfg, dtype=dtype, grid=grid)
    feat = linear(params["vision_proj"], embeds[:, 0, :], dtype=dtype)
    feat = _normalize(feat.reshape(B, N, -1).mean(dim=1))
    return embeds.reshape(B, N * embeds.shape[1], embeds.shape[2]), feat


def text_features(params, text_ids, text_mask, med_cfg: MedConfig, dtype=None, grid=None):
    hidden = M.med_forward(params["text_encoder"], text_ids, text_mask, cfg=med_cfg,
                           mode="text", dtype=dtype, grid=grid)
    return _normalize(linear(params["text_proj"], hidden[:, 0, :], dtype=dtype))


def _div_temp(x, temp):
    """x / temp with the JAX package's promotion: a bf16 product over the
    fp32 temperature is fp32 there (torch would keep bf16)."""
    return x.float() / temp


def _global_mean(rows, n_global: int):
    """The mean over a global batch of `n_global` rows of which `rows` are
    this rank's: ``rows.mean()`` on one rank."""
    if rows.shape[0] == n_global:
        return rows.mean()
    return rows.sum() / n_global


def _rank_offset(n_local: int, grid):
    """(this data rank's first row in the global batch, the global batch)."""
    if grid is None:
        return 0, n_local
    return grid.data_rank * n_local, n_local * grid.data


def _data_gather(x, grid, with_grad: bool = False):
    """`x` gathered over the grid's data group (with its gradient when
    `with_grad`); `x` itself without a data axis."""
    if grid is None or not grid.data_parallel:
        return x
    if with_grad:
        return all_gather_with_grad(x, grid.data_group)
    return concat_all_gather(x, grid.data_group)


def ita_loss(video_feat, text_feat, video_feat_m, text_feat_m, queue: QueueState, temp,
             alpha, offset: int = 0):
    """The contrastive loss against the momentum features and the queues,
    with in-batch diagonal targets mixed by alpha.

    video_feat/text_feat are this rank's rows; video_feat_m/text_feat_m the
    global batch's momentum features (the world's, gathered), of which the
    rank's rows start at `offset`. Returns (this rank's share of the loss,
    sim_i2t, sim_t2i) with the rank's rows of the similarities."""
    B = video_feat.shape[0]
    n_global = video_feat_m.shape[0]
    video_feat_all = torch.cat([video_feat_m.t().float(), queue.image], dim=1)  # (E, B+Q)
    text_feat_all = torch.cat([text_feat_m.t().float(), queue.text], dim=1)
    with torch.no_grad():
        own_video_m = video_feat_m[offset:offset + B].float()
        own_text_m = text_feat_m[offset:offset + B].float()
        sim_i2t_m = (own_video_m @ text_feat_all) / temp
        sim_t2i_m = (own_text_m @ video_feat_all) / temp
        eye = torch.eye(n_global, sim_i2t_m.shape[1], device=sim_i2t_m.device)[offset:offset + B]
        i2t_targets = alpha * torch.softmax(sim_i2t_m, dim=1) + (1 - alpha) * eye
        t2i_targets = alpha * torch.softmax(sim_t2i_m, dim=1) + (1 - alpha) * eye
    sim_i2t = _div_temp(video_feat @ text_feat_all.to(video_feat.dtype), temp)
    sim_t2i = _div_temp(text_feat @ video_feat_all.to(text_feat.dtype), temp)
    loss_i2t = _global_mean(-(torch.log_softmax(sim_i2t, dim=1) * i2t_targets).sum(dim=1),
                            n_global)
    loss_t2i = _global_mean(-(torch.log_softmax(sim_t2i, dim=1) * t2i_targets).sum(dim=1),
                            n_global)
    return (loss_i2t + loss_t2i) / 2, sim_i2t, sim_t2i


def itm_loss(params, enc_ids, text_mask, video_embeds, neg_video_idx, neg_text_idx,
             med_cfg: MedConfig, dtype=None, grid=None):
    """ITM over B positives and 2B negatives (each video with a sampled
    text, each text with a sampled video); the memory mask is all ones, as
    in the JAX package (so the cross-attention carries a zero bias).

    The inputs are this rank's rows; the negative indices (this rank's
    slice of the global index vectors) point into the global batch, whose
    texts and video embeddings are gathered over `grid`'s data axis (the
    embeddings with their gradient). Returns the rank's share of the mean
    over the global batch's 3B rows."""
    B = enc_ids.shape[0]
    world_embeds = _data_gather(video_embeds, grid, with_grad=True)
    world_ids = _data_gather(enc_ids, grid)
    world_mask = _data_gather(text_mask, grid)
    video_atts = torch.ones(video_embeds.shape[:2], dtype=torch.int32, device=enc_ids.device)
    pos_hidden = M.med_forward(params["text_encoder"], enc_ids, text_mask,
                               encoder_hidden_states=video_embeds,
                               encoder_attention_mask=video_atts, cfg=med_cfg,
                               mode="multimodal", dtype=dtype, grid=grid)
    text_ids_all = torch.cat([enc_ids, world_ids[neg_text_idx]], dim=0)
    text_atts_all = torch.cat([text_mask, world_mask[neg_text_idx]], dim=0)
    video_embeds_all = torch.cat([world_embeds[neg_video_idx], video_embeds], dim=0)
    video_atts_all = torch.cat([video_atts, video_atts], dim=0)
    neg_hidden = M.med_forward(params["text_encoder"], text_ids_all, text_atts_all,
                               encoder_hidden_states=video_embeds_all,
                               encoder_attention_mask=video_atts_all, cfg=med_cfg,
                               mode="multimodal", dtype=dtype, grid=grid)
    vl = torch.cat([pos_hidden[:, 0, :], neg_hidden[:, 0, :]], dim=0)
    logits = linear(params["itm_head"], vl, dtype=dtype).float()
    labels = torch.cat([torch.ones(B, dtype=torch.long, device=vl.device),
                        torch.zeros(2 * B, dtype=torch.long, device=vl.device)])
    logp = torch.log_softmax(logits, dim=-1)
    rows = -torch.gather(logp, 1, labels[:, None])
    return _global_mean(rows, 3 * world_ids.shape[0])


def momentum_features(params_m, video, text_ids, text_mask, vit_cfg: ViTConfig,
                      med_cfg: MedConfig, dtype=None, grid=None):
    """The momentum towers' features of the global batch: this rank's rows,
    gathered over `grid`'s data axis."""
    with torch.no_grad():
        _, video_feat_m = video_features(params_m, video, vit_cfg, dtype=dtype, grid=grid)
        text_feat_m = text_features(params_m, text_ids, text_mask, med_cfg, dtype=dtype,
                                    grid=grid)
    return _data_gather(video_feat_m, grid), _data_gather(text_feat_m, grid)


def retrieval_loss(params, params_m, queue: QueueState, video, text_ids, enc_ids, text_mask,
                   alpha, idx, generator, vit_cfg: ViTConfig, med_cfg: MedConfig, dtype=None,
                   negatives=None, grid=None):
    """ITA + ITM losses. Returns (loss_ita, loss_itm, aux); aux holds the
    global batch's momentum features and idx for the queue update, and the
    negatives drawn (global index vectors).

    video (B, N, S, S, C) normalized frames; text_ids [CLS]-prefixed;
    enc_ids the same with [ENC] at position 0; idx (B,) video ids (texts
    of one video are not each other's negatives). negatives: None to draw
    them from `generator`, or (neg_video_idx, neg_text_idx), each (B,) over
    the global batch. grid (`parallel/mesh.py:Grid`): the inputs are this
    data rank's rows of the global batch and the losses its shares, the
    towers on this rank's heads under a model axis (module docstring).
    """
    temp = params["temp"].clamp(0.001, 0.5)
    offset, n_global = _rank_offset(video.shape[0], grid)
    rows = slice(offset, offset + video.shape[0])

    video_embeds, video_feat = video_features(params, video, vit_cfg, dtype=dtype, grid=grid)
    text_feat = text_features(params, text_ids, text_mask, med_cfg, dtype=dtype, grid=grid)
    video_feat_m, text_feat_m = momentum_features(params_m, video, text_ids, text_mask, vit_cfg,
                                                  med_cfg, dtype=dtype, grid=grid)
    idx_all = _data_gather(idx, grid)

    loss_ita, _, _ = ita_loss(video_feat, text_feat, video_feat_m, text_feat_m, queue, temp,
                              alpha, offset=offset)

    if negatives is None:
        with torch.no_grad():
            video_feat_all = _data_gather(video_feat, grid)
            text_feat_all = _data_gather(text_feat, grid)
            same = idx_all.reshape(-1, 1) == idx_all.reshape(1, -1)
            sim_i2t_b = _div_temp(video_feat_all @ text_feat_all.t(), temp)
            sim_t2i_b = _div_temp(text_feat_all @ video_feat_all.t(), temp)
            logw_i2t = torch.log_softmax(sim_i2t_b, dim=1).masked_fill(same, -1e9)
            logw_t2i = torch.log_softmax(sim_t2i_b, dim=1).masked_fill(same, -1e9)
            negatives = (sample_categorical(generator, logw_t2i),
                         sample_categorical(generator, logw_i2t))
    neg_video_idx, neg_text_idx = negatives
    assert neg_video_idx.shape[0] == n_global, "negatives index the global batch"
    loss_itm = itm_loss(params, enc_ids, text_mask, video_embeds, neg_video_idx[rows],
                        neg_text_idx[rows], med_cfg, dtype=dtype, grid=grid)
    aux = {"video_feat_m": video_feat_m, "text_feat_m": text_feat_m, "idx": idx_all,
           "negatives": negatives}
    return loss_ita, loss_itm, aux
