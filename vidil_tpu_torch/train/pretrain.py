"""Video pretraining: the ITA + ITM + LM train step.

Counterpart of ``vidil_tpu/train/pretrain.py``: the retrieval step's state
and tail (momentum update first; AdamW, the ``temp`` clamp and the queue
update after), the triple loss of `models/blip_pretrain.py`, and the
trainers' default ViT schedule (``default_fused_bwd=True``): on the card
at 224 px each block of the trained tower runs kernel K4 forward and K5
backward, and each block of the momentum tower K4.
"""

from __future__ import annotations

from vidil_tpu_torch.config import MedConfig, ViTConfig
from vidil_tpu_torch.models.blip_pretrain import pretrain_loss
from vidil_tpu_torch.models.blip_retrieval import momentum_update
from vidil_tpu_torch.train.common import training_cfgs
from vidil_tpu_torch.utils.dist import is_dist_avail_and_initialized
from vidil_tpu_torch.train.retrieval import (
    RetrievalTrainState,
    batch_tensors,
    create_train_state,
    finish_step,
    step_metrics,
)

# the JAX package's names: the state has the retrieval state's fields
PretrainState = RetrievalTrainState
create_pretrain_state = create_train_state


def make_pretrain_step(vit_cfg: ViTConfig, med_cfg: MedConfig, momentum: float = 0.995,
                       dtype=None, med_remat: bool = True):
    """step(state, batch, alpha, generator, negatives=None) -> (state, metrics),
    updating `state` in place. batch: video, text_ids, enc_ids, dec_ids,
    text_mask. The queue's idx slots are written as -100. Under a process
    group, and the metrics' ``negatives``: as the retrieval step's."""
    vit_cfg, med_cfg = training_cfgs(vit_cfg, med_cfg, med_remat)

    def train_step(state: PretrainState, batch, alpha, generator, negatives=None):
        dp = is_dist_avail_and_initialized()
        b = batch_tensors(batch, state.device)
        momentum_update(state.params, state.params_m, momentum)
        ita, itm, lm, aux = pretrain_loss(
            state.params, state.params_m, state.queue, b["video"], b["text_ids"], b["enc_ids"],
            b["dec_ids"], b["text_mask"], alpha, generator, vit_cfg, med_cfg, dtype=dtype,
            negatives=negatives, data_parallel=dp)
        loss = ita + itm + lm
        state = finish_step(state, loss, aux, dp)
        metrics = step_metrics(dp, loss=loss, loss_ita=ita, loss_itm=itm, loss_lm=lm)
        return state, {**metrics, "negatives": aux["negatives"]}

    return train_step
