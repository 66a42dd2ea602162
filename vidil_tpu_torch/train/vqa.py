"""Video VQA fine-tune: the train step.

Counterpart of ``vidil_tpu/train/vqa.py``: AdamW over fp32 master
parameters, the weighted answer LM loss over a flattened ragged answer list
(`vqa_train_loss`). ``dtype`` is the compute dtype of the towers (bf16 in
the trainer). The ViT's schedule comes from `training_cfgs` with its
default: the fused block pair (kernels K4 forward, K5 backward) on the card.
"""

from __future__ import annotations

import torch

from vidil_tpu_torch.config import MedConfig, ViTConfig
from vidil_tpu_torch.models import blip as B
from vidil_tpu_torch.models.blip_vqa import vqa_train_loss
from vidil_tpu_torch.train.common import (
    TrainState,
    apply_gradients,
    create_train_state,
    model_batch,
    step_grid,
    step_metrics,
    training_cfgs,
)

# the JAX package's names for the trainers' shared state
VQATrainState = TrainState
create_vqa_train_state = create_train_state


def make_vqa_train_step(vit_cfg: ViTConfig, med_cfg: MedConfig, dtype=None,
                        med_remat: bool = True, grid=None):
    """step(state, batch) -> (state, {"loss"}); updates `state` in place.

    batch: video (B, N, S, S, C), question_ids/question_mask (B, Lq) with
    [ENC] first, answer_ids/answer_mask (A, La) flattened over the ragged
    per-question answers, answer_question_index (A,), weights (A,); numpy
    arrays or tensors. After a step the parameters' ``.grad`` hold that
    step's gradients.

    The step runs on the state's grid (`common.step_grid`; `grid` here, as
    in the caption step, for the ViT's schedule). Under its data axis (a
    process group, one rank included) the batch is this data rank's
    questions of the global batch and their answers (`vqa_collate` over the
    loader's rows); the weighted answer loss is divided by the global
    batch's questions, the gradients are summed over the data group. Under
    its model axis the towers run on this rank's heads.
    """
    vit_cfg, med_cfg = training_cfgs(vit_cfg, med_cfg, med_remat,
                                     model_parallel=grid.model if grid is not None else 1)

    def train_step(state: TrainState, batch):
        g = step_grid(state)
        dev = state.device
        b = model_batch(
            {k: torch.as_tensor(batch[k], device=dev).long()
             for k in ("question_ids", "question_mask", "answer_ids", "answer_mask",
                       "answer_question_index")}
            | {k: torch.as_tensor(batch[k], dtype=torch.float32, device=dev)
               for k in ("video", "weights")}, g)
        embeds = B.encode_video_frames(state.params, b["video"], vit_cfg, dtype=dtype, grid=g)
        loss = vqa_train_loss(state.params, embeds, b["question_ids"], b["question_mask"],
                              b["answer_ids"], b["answer_mask"], b["answer_question_index"],
                              b["weights"], med_cfg, batch_size=b["video"].shape[0] * g.data,
                              dtype=dtype, grid=g)
        return apply_gradients(state, loss, g), step_metrics(g, loss=loss)

    return train_step
