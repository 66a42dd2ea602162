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
from vidil_tpu_torch.models.blip_pretrain import init_pretrain_params, pretrain_loss
from vidil_tpu_torch.models.blip_retrieval import momentum_update
from vidil_tpu_torch.train.common import model_batch, step_grid, step_metrics, training_cfgs
from vidil_tpu_torch.train.retrieval import (
    RetrievalTrainState,
    batch_tensors,
    create_train_state,
    draw_params,
    finish_step,
)

# the JAX package's name: the state has the retrieval state's fields
PretrainState = RetrievalTrainState


def create_pretrain_state(params, init_lr: float, weight_decay: float = 0.05, *,
                          vit_cfg: ViTConfig | None = None, med_cfg: MedConfig | None = None,
                          embed_dim: int = 256, seed: int = 0, device="cuda",
                          **kw) -> PretrainState:
    """`train.retrieval.create_train_state` over the pretraining model:
    `params` None draws `init_pretrain_params` at `vit_cfg` / `med_cfg`
    from ``init_generator(seed)`` on the state's device, as the JAX
    package draws them from its key. `kw`: create_train_state's."""
    if params is None:
        params = draw_params(init_pretrain_params, vit_cfg, med_cfg, embed_dim, seed, device)
    return create_train_state(params, init_lr, weight_decay, embed_dim=embed_dim, seed=seed,
                              device=device, **kw)


def make_pretrain_step(vit_cfg: ViTConfig, med_cfg: MedConfig, momentum: float = 0.995,
                       dtype=None, med_remat: bool = True, grid=None):
    """step(state, batch, alpha, generator, negatives=None) -> (state, metrics),
    updating `state` in place. batch: video, text_ids, enc_ids, dec_ids,
    text_mask. The queue's idx slots are written as -100. The grid, and
    the metrics' ``negatives``: as the retrieval step's."""
    vit_cfg, med_cfg = training_cfgs(vit_cfg, med_cfg, med_remat,
                                     model_parallel=grid.model if grid is not None else 1)

    def train_step(state: PretrainState, batch, alpha, generator, negatives=None):
        g = step_grid(state)
        b = model_batch(batch_tensors(batch, state.device), g)
        momentum_update(state.params, state.params_m, momentum)
        ita, itm, lm, aux = pretrain_loss(
            state.params, state.params_m, state.queue, b["video"], b["text_ids"], b["enc_ids"],
            b["dec_ids"], b["text_mask"], alpha, generator, vit_cfg, med_cfg, dtype=dtype,
            negatives=negatives, grid=g)
        loss = ita + itm + lm
        state = finish_step(state, loss, aux, g)
        metrics = step_metrics(g, loss=loss, loss_ita=ita, loss_itm=itm, loss_lm=lm)
        return state, {**metrics, "negatives": aux["negatives"]}

    return train_step
