"""Video captioning fine-tune: the train step and ITM frame selection.

Counterpart of ``vidil_tpu/train/caption.py``: AdamW with a per-epoch LR,
LM loss with prompt masking. 'concat_frame' feeds all frame tokens;
'single_frame' picks the best frame per caption by ITM argmax
(`select_frame_itm`). Master parameters are fp32; ``dtype`` is the compute
dtype of the towers (bf16 in the trainer), as in the JAX step.
"""

from __future__ import annotations

import torch

from vidil_tpu_torch.config import MedConfig, ViTConfig
from vidil_tpu_torch.models import blip as B
from vidil_tpu_torch.train.common import (
    TrainState,
    apply_gradients,
    create_train_state,
    training_cfgs,
)


# the JAX package's names for the trainers' shared state
CaptionTrainState = TrainState
create_caption_train_state = create_train_state


def make_caption_train_step(vit_cfg: ViTConfig, med_cfg: MedConfig, prompt_length: int,
                            dtype=None, med_remat: bool = True):
    """step(state, batch) -> (state, {"loss"}); updates `state` in place.

    batch: video (B, N, S, S, C) normalized, input_ids (B, L) starting with
    [DEC], attention_mask (B, L); numpy arrays or tensors. 'single_frame'
    batches expose the chosen frame as N == 1. After a step the parameters'
    ``.grad`` hold that step's gradients.
    """
    vit_cfg, med_cfg = training_cfgs(vit_cfg, med_cfg, med_remat)

    def train_step(state: TrainState, batch):
        dev = state.device
        video = torch.as_tensor(batch["video"], dtype=torch.float32, device=dev)
        ids = torch.as_tensor(batch["input_ids"], device=dev).long()
        mask = torch.as_tensor(batch["attention_mask"], device=dev).long()
        embeds = B.encode_video_frames(state.params, video, vit_cfg, dtype=dtype)
        loss = B.blip_caption_loss(state.params, embeds, ids, mask, med_cfg,
                                   prompt_length=prompt_length, dtype=dtype)
        return apply_gradients(state, loss), {"loss": loss.detach()}

    return train_step


@torch.no_grad()
def select_frame_itm(itm_params, frames, text_ids, text_mask,
                     vit_cfg: ViTConfig, med_cfg: MedConfig, dtype=None) -> int:
    """'single_frame' selection: the frame of ONE video (frames (N, S, S, C))
    with the highest ITM match probability for its caption."""
    N = frames.shape[0]
    embeds = B.encode_images(itm_params, frames, vit_cfg, dtype=dtype)
    ids = text_ids.reshape(1, -1).expand(N, -1)
    mask = text_mask.reshape(1, -1).expand(N, -1)
    logits = B.blip_itm_scores(itm_params, embeds, ids, mask, med_cfg, dtype=dtype)
    return int(torch.softmax(logits, dim=1)[:, 1].argmax())
