"""BLIP embedding extractor: the ITM model's layout, scored by its ITM head
or compared by its contrastive (ITC) features.

Counterpart of ``vidil_tpu/models/blip_embedding.py``; its random init is
the ITM model's (`init_blip_embedding`), synthetic weights come from
`models/blip.py:blip_itm_shapes`.
"""

from __future__ import annotations

from vidil_tpu_torch.config import MedConfig, ViTConfig
from vidil_tpu_torch.models.blip import (
    blip_itc_features,
    blip_itm_scores,
    encode_images,
    init_blip_itm,
)

init_blip_embedding = init_blip_itm


def blip_embedding_forward(params, images, text_ids, text_mask, vit_cfg: ViTConfig,
                           med_cfg: MedConfig, match_head: str = "itc", dtype=None):
    """match_head 'itm' -> (N, 2) ITM logits, images and texts paired row
    by row; 'itc' -> (image_feat (N, E), text_feat (M, E), sim (N, M))."""
    image_embeds = encode_images(params, images, vit_cfg, dtype=dtype)
    if match_head == "itm":
        return blip_itm_scores(params, image_embeds, text_ids, text_mask, med_cfg, dtype=dtype)
    image_feat, text_feat = blip_itc_features(params, image_embeds, text_ids, text_mask,
                                              med_cfg, dtype=dtype)
    return image_feat, text_feat, image_feat @ text_feat.t()
