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
    _data_gather,
    _rank_offset,
    init_retrieval_params,
    ita_loss,
    itm_loss,
    momentum_features,
    sample_categorical,
    text_features,
    video_features,
)


def init_pretrain_params(generator: torch.Generator, vit_cfg: ViTConfig, med_cfg: MedConfig,
                         embed_dim: int = 256, device=None):
    """Random pretraining parameters (the JAX package's distributions): the
    retrieval model's (`init_retrieval_params`, ``temp`` 0.07), then the
    decoder's own parts, drawn as a MED with an LM head draws them: each
    layer's self- and cross-attention (``decoder_attn``) and the LM head
    (``decoder_cls``). Its embeddings, FFNs and FFN norms are the text
    encoder's (`tied_decoder_params`), so none is drawn for it."""
    params = init_retrieval_params(generator, vit_cfg, med_cfg, embed_dim, device)
    device = params["temp"].device
    d = med_cfg.hidden_size
    params["decoder_attn"] = [
        {"self_attn": M.init_attention(generator, d, d, device),
         "cross_attn": M.init_attention(generator, d, med_cfg.encoder_width, device)}
        for _ in range(med_cfg.num_layers)]
    params["decoder_cls"] = M.init_lm_head(generator, med_cfg, device)
    return params


def synth_pretrain_params(vit_cfg: ViTConfig, med_cfg: MedConfig, embed_dim: int = 256,
                          device="cpu", salt: float = 0.0):
    """Synthetic pretraining parameters (`utils.synth.synth_tree` over
    `blip.blip_pretrain_shapes`), port layout, ``temp`` 0.07: deterministic
    sin-fill weights for tests that need one fixed tree in both packages.
    They are not the reference's distribution (`init_pretrain_params`)."""
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
                  dtype=None, negatives=None, grid=None):
    """Returns (loss_ita, loss_itm, loss_lm, aux).

    text_ids [CLS]-prefixed (max_length 30), enc_ids with [ENC] and dec_ids
    with [DEC] at position 0. negatives: None to draw them from
    `generator`, or (neg_video_idx, neg_text_idx), each (B,) over the
    global batch. grid (`parallel/mesh.py:Grid`): the inputs are this data
    rank's rows of the global batch and the losses its shares
    (`models/blip_retrieval.py`): the in-batch weights are the global
    batch's similarity rows, gathered over the data axis, and the LM mean
    is over the global batch's tokens; the towers run on this rank's heads
    under a model axis."""
    temp = params["temp"].clamp(0.001, 0.5)
    B = video.shape[0]
    offset, n_global = _rank_offset(B, grid)
    rows = slice(offset, offset + B)

    video_embeds, video_feat = video_features(params, video, vit_cfg, dtype=dtype, grid=grid)
    text_feat = text_features(params, text_ids, text_mask, med_cfg, dtype=dtype, grid=grid)
    video_feat_m, text_feat_m = momentum_features(params_m, video, text_ids, text_mask, vit_cfg,
                                                  med_cfg, dtype=dtype, grid=grid)

    loss_ita, sim_i2t, sim_t2i = ita_loss(video_feat, text_feat, video_feat_m, text_feat_m,
                                          queue, temp, alpha, offset=offset)

    if negatives is None:
        with torch.no_grad():
            s_t2i, s_i2t = sim_t2i[:, :n_global].float(), sim_i2t[:, :n_global].float()
            s_t2i, s_i2t = _data_gather(s_t2i, grid), _data_gather(s_i2t, grid)
            diag = torch.eye(n_global, dtype=torch.bool, device=video.device)
            w_t2i = (torch.softmax(s_t2i, dim=1) + 1e-4).masked_fill(diag, 0.0)
            w_i2t = (torch.softmax(s_i2t, dim=1) + 1e-4).masked_fill(diag, 0.0)
            negatives = (sample_categorical(generator, torch.log(w_t2i)),
                         sample_categorical(generator, torch.log(w_i2t)))
    neg_video_idx, neg_text_idx = negatives
    assert neg_video_idx.shape[0] == n_global, "negatives index the global batch"
    loss_itm = itm_loss(params, enc_ids, text_mask, video_embeds, neg_video_idx[rows],
                        neg_text_idx[rows], med_cfg, dtype=dtype, grid=grid)

    dec_params = tied_decoder_params(params)
    dec_targets = dec_ids.masked_fill(dec_ids == med_cfg.pad_token_id, -100)
    video_atts = torch.ones(video_embeds.shape[:2], dtype=torch.int32, device=video.device)
    hidden = M.med_forward(dec_params, dec_ids, text_mask, encoder_hidden_states=video_embeds,
                           encoder_attention_mask=video_atts, cfg=med_cfg, mode="multimodal",
                           is_decoder=True, dtype=dtype, grid=grid)
    lm_logits = M.med_lm_logits(dec_params, hidden, med_cfg, dtype=dtype)
    loss_lm = M.med_lm_loss(lm_logits, dec_targets, label_smoothing=med_cfg.label_smoothing,
                            grid=grid)

    aux = {"video_feat_m": video_feat_m, "text_feat_m": text_feat_m,
           "idx": torch.full((n_global,), -100, dtype=torch.int32, device=video.device),
           "negatives": negatives}
    return loss_ita, loss_itm, loss_lm, aux
