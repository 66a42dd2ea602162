"""Retrieval fine-tuning: the ITA + ITM train step with momentum towers and
feature queues.

Counterpart of ``vidil_tpu/train/retrieval.py``: AdamW (`common.make_optimizer`)
over fp32 master parameters, the towers computing in ``dtype`` (bf16 in the
trainer). A step updates the momentum towers first, then takes the loss and
its gradient, the AdamW update, the clamp of ``temp`` to [0.001, 0.5], and
writes the momentum features into the queues. The ViT keeps the classic
schedule (``default_fused_bwd=False``, as in the JAX package): at 224 px the
reference's gate sends its attention to the plain path, and the MED's
attention carries a bias, so the step launches none of the port's kernels.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from vidil_tpu_torch.config import MedConfig, ViTConfig
from vidil_tpu_torch.models.blip_retrieval import (
    QueueState,
    dequeue_and_enqueue,
    init_momentum_params,
    init_queue,
    momentum_update,
    retrieval_loss,
)
from vidil_tpu_torch.models.convert import to_device
from vidil_tpu_torch.parallel.collectives import psum
from vidil_tpu_torch.train.common import (
    TrainState,
    apply_gradients,
    create_train_state as create_base_state,
    training_cfgs,
)
from vidil_tpu_torch.utils.dist import is_dist_avail_and_initialized
from vidil_tpu_torch.utils.seeding import make_generator


@dataclass
class RetrievalTrainState(TrainState):
    params_m: dict | None = None  # momentum towers (MOMENTUM_KEYS), no grad
    queue: QueueState | None = None


def create_train_state(params, init_lr: float, weight_decay: float = 0.05, *,
                       embed_dim: int = 256, queue_size: int = 57600, seed: int = 0,
                       params_m=None, queue: QueueState | None = None,
                       device="cuda") -> RetrievalTrainState:
    """Master parameters on `device` (``temp`` = 0.07 when missing), their
    momentum copies (or `params_m`, copied) and the queues (or `queue`,
    copied; else drawn from ``make_generator(seed, -1)``)."""
    if "temp" not in params:
        params = {**params, "temp": torch.tensor(0.07, dtype=torch.float32)}
    base = create_base_state(params, init_lr, weight_decay, device=device)
    dev = base.device
    if params_m is None:
        params_m = init_momentum_params(base.params)
    else:
        params_m = init_momentum_params(to_device(params_m, dev))
    if queue is None:
        queue = init_queue(make_generator(seed, -1, dev), embed_dim, queue_size, device=dev)
    else:
        queue = QueueState(*(t.to(dev, copy=True) for t in queue[:3]), int(queue.ptr))
    return RetrievalTrainState(base.params, base.optimizer, dev, base.step, params_m, queue)


def batch_tensors(batch: dict, device) -> dict:
    """numpy arrays or tensors -> tensors on `device`: the video fp32, the
    token ids, masks and video ids int64."""
    return {k: torch.as_tensor(v, device=device).float() if k == "video"
            else torch.as_tensor(v, device=device).long() for k, v in batch.items()}


def finish_step(state: RetrievalTrainState, loss, aux,
                data_parallel: bool = False) -> RetrievalTrainState:
    """The step's tail shared with pretraining: backward (the gradients
    summed over the ranks under `data_parallel`) and AdamW, the temperature
    clamp, the queue update from the global batch's momentum features."""
    apply_gradients(state, loss, data_parallel)
    with torch.no_grad():
        state.params["temp"].clamp_(0.001, 0.5)
    state.queue = dequeue_and_enqueue(state.queue, aux["video_feat_m"], aux["text_feat_m"],
                                      aux["idx"])
    return state


def step_metrics(data_parallel: bool, **losses) -> dict:
    """The step's losses, detached; the global batch's (summed over the
    ranks' shares) under `data_parallel`."""
    return {k: psum(v) if data_parallel else v.detach() for k, v in losses.items()}


def make_retrieval_train_step(vit_cfg: ViTConfig, med_cfg: MedConfig, momentum: float = 0.995,
                              dtype=None, med_remat: bool = True):
    """step(state, batch, alpha, generator, negatives=None) -> (state, metrics),
    updating `state` in place.

    batch: video (B, N, S, S, C), text_ids / enc_ids / text_mask (B, L),
    idx (B,). generator: the draws of the hard negatives, unless
    `negatives` gives them (see `retrieval_loss`). After a step the
    parameters' ``.grad`` hold its gradients.

    Under a process group (one rank included) the batch is this rank's rows
    of the global batch, every rank passes a generator seeded alike, and
    the metrics are the global batch's losses. The metrics also hold the
    step's ``negatives``, (neg_video_idx, neg_text_idx) over the global
    batch."""
    vit_cfg, med_cfg = training_cfgs(vit_cfg, med_cfg, med_remat, default_fused_bwd=False)

    def train_step(state: RetrievalTrainState, batch, alpha, generator, negatives=None):
        dp = is_dist_avail_and_initialized()
        b = batch_tensors(batch, state.device)
        momentum_update(state.params, state.params_m, momentum)
        loss_ita, loss_itm, aux = retrieval_loss(
            state.params, state.params_m, state.queue, b["video"], b["text_ids"], b["enc_ids"],
            b["text_mask"], alpha, b["idx"], generator, vit_cfg, med_cfg, dtype=dtype,
            negatives=negatives, data_parallel=dp)
        loss = loss_ita + loss_itm
        state = finish_step(state, loss, aux, dp)
        metrics = step_metrics(dp, loss=loss, loss_ita=loss_ita, loss_itm=loss_itm)
        return state, {**metrics, "negatives": aux["negatives"]}

    return train_step
