"""BLIP video pretraining: the ITA + ITM + LM triple loss.

Counterpart of ``vidil_tpu/models/blip_pretrain.py``. Beside the retrieval
loss's ITA: in-batch negatives drawn from ``softmax(sim[:, :B]) + 1e-4``
with a zeroed diagonal, a queue whose idx slots stay -100, and a caption LM
loss through a text decoder whose non-attention weights are the text
encoder's (the reference ties them, skip_key '/attention').

The tie holds the same tensors: `tied_decoder_params` assembles the
decoder's tree from the encoder's embeddings, FFNs and FFN norms and the
decoder's own attention blocks and LM head, so both towers' gradients add
up in one leaf, and AdamW sees each shared leaf once.
"""

from __future__ import annotations

import torch

from vidil_tpu_torch.config import MedConfig, ViTConfig
from vidil_tpu_torch.models import med as M
from vidil_tpu_torch.models.blip_retrieval import (
    QueueState,
    ita_loss,
    itm_loss,
    sample_categorical,
    text_features,
    video_features,
)


def init_pretrain_params(vit_cfg: ViTConfig, med_cfg: MedConfig, embed_dim: int = 256,
                         device="cpu", salt: float = 0.0):
    """Synthetic pretraining parameters (`utils.synth.synth_tree` over
    `blip.blip_pretrain_shapes`), port layout, ``temp`` 0.07. The JAX
    package initialises randomly from a key; its numbers cannot be
    reproduced here."""
    from vidil_tpu_torch.models.blip import blip_pretrain_shapes
    from vidil_tpu_torch.models.convert import from_jax_params
    from vidil_tpu_torch.utils.synth import synth_tree

    params = from_jax_params(synth_tree(blip_pretrain_shapes(vit_cfg, med_cfg, embed_dim),
                                        device, salt=salt))
    params["temp"].fill_(0.07)
    return params


def tied_decoder_params(params):
    """The decoder's MED tree: the encoder's embeddings, FFN and FFN norm
    tensors (the same objects), the decoder's own self- and
    cross-attention per layer, and its LM head."""
    enc = params["text_encoder"]
    return {
        "embeddings": enc["embeddings"],
        "layers": [{"self_attn": own["self_attn"], "cross_attn": own["cross_attn"],
                    "mlp": shared["mlp"], "mlp_norm": shared["mlp_norm"]}
                   for own, shared in zip(params["decoder_attn"], enc["layers"])],
        "cls": params["decoder_cls"],
    }


def pretrain_loss(params, params_m, queue: QueueState, video, text_ids, enc_ids, dec_ids,
                  text_mask, alpha, generator, vit_cfg: ViTConfig, med_cfg: MedConfig,
                  dtype=None, negatives=None):
    """Returns (loss_ita, loss_itm, loss_lm, aux).

    text_ids [CLS]-prefixed (max_length 30), enc_ids with [ENC] and dec_ids
    with [DEC] at position 0. negatives: None to draw them from
    `generator`, or (neg_video_idx, neg_text_idx), each (B,)."""
    temp = params["temp"].clamp(0.001, 0.5)
    B = video.shape[0]

    video_embeds, video_feat = video_features(params, video, vit_cfg, dtype=dtype)
    text_feat = text_features(params, text_ids, text_mask, med_cfg, dtype=dtype)
    with torch.no_grad():
        _, video_feat_m = video_features(params_m, video, vit_cfg, dtype=dtype)
        text_feat_m = text_features(params_m, text_ids, text_mask, med_cfg, dtype=dtype)

    loss_ita, sim_i2t, sim_t2i = ita_loss(video_feat, text_feat, video_feat_m, text_feat_m,
                                          queue, temp, alpha)

    if negatives is None:
        with torch.no_grad():
            diag = torch.eye(B, dtype=torch.bool, device=video.device)
            w_t2i = (torch.softmax(sim_t2i[:, :B].float(), dim=1) + 1e-4).masked_fill(diag, 0.0)
            w_i2t = (torch.softmax(sim_i2t[:, :B].float(), dim=1) + 1e-4).masked_fill(diag, 0.0)
            negatives = (sample_categorical(generator, torch.log(w_t2i)),
                         sample_categorical(generator, torch.log(w_i2t)))
    neg_video_idx, neg_text_idx = negatives
    loss_itm = itm_loss(params, enc_ids, text_mask, video_embeds, neg_video_idx, neg_text_idx,
                        med_cfg, dtype=dtype)

    dec_params = tied_decoder_params(params)
    dec_targets = dec_ids.masked_fill(dec_ids == med_cfg.pad_token_id, -100)
    video_atts = torch.ones(video_embeds.shape[:2], dtype=torch.int32, device=video.device)
    hidden = M.med_forward(dec_params, dec_ids, text_mask, encoder_hidden_states=video_embeds,
                           encoder_attention_mask=video_atts, cfg=med_cfg, mode="multimodal",
                           is_decoder=True, dtype=dtype)
    lm_logits = M.med_lm_logits(dec_params, hidden, med_cfg, dtype=dtype)
    loss_lm = M.med_lm_loss(lm_logits, dec_targets, label_smoothing=med_cfg.label_smoothing)

    aux = {"video_feat_m": video_feat_m, "text_feat_m": text_feat_m,
           "idx": torch.full((B,), -100, dtype=torch.int32, device=video.device),
           "negatives": negatives}
    return loss_ita, loss_itm, loss_lm, aux
