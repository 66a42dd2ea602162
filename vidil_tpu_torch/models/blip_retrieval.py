"""BLIP retrieval (video): the ITA + ITM training losses, momentum towers and
feature queues.

Counterpart of ``vidil_tpu/models/blip_retrieval.py``. The momentum towers
and the queues are explicit state beside the parameters; the step updates
them in place (`momentum_update`, `dequeue_and_enqueue`). The batch is the
global one (the reference's ``negative_all_rank=True``).

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
from vidil_tpu_torch.models.convert import named_leaves
from vidil_tpu_torch.models.layers import linear
from vidil_tpu_torch.models.vit import vit_forward
from vidil_tpu_torch.ops.generation import gumbel_argmax, gumbel_noise

MOMENTUM_KEYS = ("visual_encoder", "text_encoder", "vision_proj", "text_proj")


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


def video_features(params, video, vit_cfg: ViTConfig, dtype=None):
    """(B, N, S, S, C) -> (video_embeds (B, N*(P+1), D), video_feat (B, E)):
    per-frame CLS features projected, mean-pooled over frames, normalized;
    the full token grid feeds cross-attention."""
    B, N = video.shape[:2]
    embeds = vit_forward(params["visual_encoder"], video.reshape((B * N,) + video.shape[2:]),
                         vit_cfg, dtype=dtype)
    feat = linear(params["vision_proj"], embeds[:, 0, :], dtype=dtype)
    feat = _normalize(feat.reshape(B, N, -1).mean(dim=1))
    return embeds.reshape(B, N * embeds.shape[1], embeds.shape[2]), feat


def text_features(params, text_ids, text_mask, med_cfg: MedConfig, dtype=None):
    hidden = M.med_forward(params["text_encoder"], text_ids, text_mask, cfg=med_cfg,
                           mode="text", dtype=dtype)
    return _normalize(linear(params["text_proj"], hidden[:, 0, :], dtype=dtype))


def _div_temp(x, temp):
    """x / temp with the JAX package's promotion: a bf16 product over the
    fp32 temperature is fp32 there (torch would keep bf16)."""
    return x.float() / temp


def ita_loss(video_feat, text_feat, video_feat_m, text_feat_m, queue: QueueState, temp,
             alpha):
    """The contrastive loss against the momentum features and the queues,
    with in-batch diagonal targets mixed by alpha."""
    B = video_feat.shape[0]
    video_feat_all = torch.cat([video_feat_m.t().float(), queue.image], dim=1)  # (E, B+Q)
    text_feat_all = torch.cat([text_feat_m.t().float(), queue.text], dim=1)
    with torch.no_grad():
        sim_i2t_m = (video_feat_m.float() @ text_feat_all) / temp
        sim_t2i_m = (text_feat_m.float() @ video_feat_all) / temp
        eye = torch.eye(B, sim_i2t_m.shape[1], device=sim_i2t_m.device)
        i2t_targets = alpha * torch.softmax(sim_i2t_m, dim=1) + (1 - alpha) * eye
        t2i_targets = alpha * torch.softmax(sim_t2i_m, dim=1) + (1 - alpha) * eye
    sim_i2t = _div_temp(video_feat @ text_feat_all.to(video_feat.dtype), temp)
    sim_t2i = _div_temp(text_feat @ video_feat_all.to(text_feat.dtype), temp)
    loss_i2t = -(torch.log_softmax(sim_i2t, dim=1) * i2t_targets).sum(dim=1).mean()
    loss_t2i = -(torch.log_softmax(sim_t2i, dim=1) * t2i_targets).sum(dim=1).mean()
    return (loss_i2t + loss_t2i) / 2, sim_i2t, sim_t2i


def itm_loss(params, enc_ids, text_mask, video_embeds, neg_video_idx, neg_text_idx,
             med_cfg: MedConfig, dtype=None):
    """ITM over B positives and 2B negatives (each video with a sampled
    text, each text with a sampled video); the memory mask is all ones, as
    in the JAX package (so the cross-attention carries a zero bias)."""
    B = enc_ids.shape[0]
    video_atts = torch.ones(video_embeds.shape[:2], dtype=torch.int32, device=enc_ids.device)
    pos_hidden = M.med_forward(params["text_encoder"], enc_ids, text_mask,
                               encoder_hidden_states=video_embeds,
                               encoder_attention_mask=video_atts, cfg=med_cfg,
                               mode="multimodal", dtype=dtype)
    text_ids_all = torch.cat([enc_ids, enc_ids[neg_text_idx]], dim=0)
    text_atts_all = torch.cat([text_mask, text_mask[neg_text_idx]], dim=0)
    video_embeds_all = torch.cat([video_embeds[neg_video_idx], video_embeds], dim=0)
    video_atts_all = torch.cat([video_atts, video_atts], dim=0)
    neg_hidden = M.med_forward(params["text_encoder"], text_ids_all, text_atts_all,
                               encoder_hidden_states=video_embeds_all,
                               encoder_attention_mask=video_atts_all, cfg=med_cfg,
                               mode="multimodal", dtype=dtype)
    vl = torch.cat([pos_hidden[:, 0, :], neg_hidden[:, 0, :]], dim=0)
    logits = linear(params["itm_head"], vl, dtype=dtype).float()
    labels = torch.cat([torch.ones(B, dtype=torch.long, device=vl.device),
                        torch.zeros(2 * B, dtype=torch.long, device=vl.device)])
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, 1, labels[:, None]).mean()


def retrieval_loss(params, params_m, queue: QueueState, video, text_ids, enc_ids, text_mask,
                   alpha, idx, generator, vit_cfg: ViTConfig, med_cfg: MedConfig, dtype=None,
                   negatives=None):
    """ITA + ITM losses. Returns (loss_ita, loss_itm, aux); aux holds the
    momentum features for the queue update, the batch's idx, and the
    negatives drawn.

    video (B, N, S, S, C) normalized frames; text_ids [CLS]-prefixed;
    enc_ids the same with [ENC] at position 0; idx (B,) video ids (texts
    of one video are not each other's negatives). negatives: None to draw
    them from `generator`, or (neg_video_idx, neg_text_idx), each (B,).
    """
    temp = params["temp"].clamp(0.001, 0.5)

    video_embeds, video_feat = video_features(params, video, vit_cfg, dtype=dtype)
    text_feat = text_features(params, text_ids, text_mask, med_cfg, dtype=dtype)
    with torch.no_grad():
        _, video_feat_m = video_features(params_m, video, vit_cfg, dtype=dtype)
        text_feat_m = text_features(params_m, text_ids, text_mask, med_cfg, dtype=dtype)

    loss_ita, _, _ = ita_loss(video_feat, text_feat, video_feat_m, text_feat_m, queue, temp,
                              alpha)

    if negatives is None:
        with torch.no_grad():
            same = idx.reshape(-1, 1) == idx.reshape(1, -1)
            sim_i2t_b = _div_temp(video_feat @ text_feat.t(), temp)
            sim_t2i_b = _div_temp(text_feat @ video_feat.t(), temp)
            logw_i2t = torch.log_softmax(sim_i2t_b, dim=1).masked_fill(same, -1e9)
            logw_t2i = torch.log_softmax(sim_t2i_b, dim=1).masked_fill(same, -1e9)
            negatives = (sample_categorical(generator, logw_t2i),
                         sample_categorical(generator, logw_i2t))
    neg_video_idx, neg_text_idx = negatives
    loss_itm = itm_loss(params, enc_ids, text_mask, video_embeds, neg_video_idx, neg_text_idx,
                        med_cfg, dtype=dtype)
    aux = {"video_feat_m": video_feat_m, "text_feat_m": text_feat_m, "idx": idx,
           "negatives": negatives}
    return loss_ita, loss_itm, aux
