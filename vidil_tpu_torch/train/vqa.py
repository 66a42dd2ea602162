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
from vidil_tpu_torch.parallel.collectives import psum
from vidil_tpu_torch.train.common import (
    TrainState,
    apply_gradients,
    create_train_state,
    training_cfgs,
)
from vidil_tpu_torch.utils.dist import get_world_size, is_dist_avail_and_initialized

# the JAX package's names for the trainers' shared state
VQATrainState = TrainState
create_vqa_train_state = create_train_state


def make_vqa_train_step(vit_cfg: ViTConfig, med_cfg: MedConfig, dtype=None,
                        med_remat: bool = True):
    """step(state, batch) -> (state, {"loss"}); updates `state` in place.

    batch: video (B, N, S, S, C), question_ids/question_mask (B, Lq) with
    [ENC] first, answer_ids/answer_mask (A, La) flattened over the ragged
    per-question answers, answer_question_index (A,), weights (A,); numpy
    arrays or tensors. After a step the parameters' ``.grad`` hold that
    step's gradients.

    Under a process group (one rank included) the batch is this rank's
    questions of the global batch and their answers (`vqa_collate` over the
    loader's rows); the weighted answer loss is divided by the global
    batch's questions, the gradients are summed over the ranks.
    """
    vit_cfg, med_cfg = training_cfgs(vit_cfg, med_cfg, med_remat)

    def train_step(state: TrainState, batch):
        dp = is_dist_avail_and_initialized()
        dev = state.device
        ids = {k: torch.as_tensor(batch[k], device=dev).long()
               for k in ("question_ids", "question_mask", "answer_ids", "answer_mask",
                         "answer_question_index")}
        video = torch.as_tensor(batch["video"], dtype=torch.float32, device=dev)
        weights = torch.as_tensor(batch["weights"], dtype=torch.float32, device=dev)
        embeds = B.encode_video_frames(state.params, video, vit_cfg, dtype=dtype)
        loss = vqa_train_loss(state.params, embeds, ids["question_ids"], ids["question_mask"],
                              ids["answer_ids"], ids["answer_mask"],
                              ids["answer_question_index"], weights, med_cfg,
                              batch_size=video.shape[0] * (get_world_size() if dp else 1),
                              dtype=dtype)
        return apply_gradients(state, loss, dp), {"loss": psum(loss) if dp else loss.detach()}

    return train_step
