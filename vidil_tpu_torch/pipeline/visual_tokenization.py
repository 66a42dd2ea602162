"""Visual tokenization: zero-shot frame tagging against ontologies.

Counterpart of ``vidil_tpu/pipeline/visual_tokenization.py``. Every frame
embedding of a chunk is scored against every ontology text embedding of a
category (cosine similarity), then each frame keeps its top-k terms and a
frequency vote aggregates them per video. Two encoders:

* 'clip': CLIP towers, cosine scores only; the score is an fp32 product on
  the device (TF32 off, as the JAX package's ``Precision.HIGHEST``).
* 'blip': BLIP-retrieval ViT + MED, cosine scores on the host (a numpy
  product, as in the JAX package), then an ITM rerank of each frame's top
  k_test texts through grouped cross-attention.

The ontology's text embeddings are computed once per run in blocks of 512
texts and cached by the caller (`text_cache`). The JAX package runs all
blocks (and groups of rerank blocks) as one scanned program; here they are
a loop over the same blocks, which gives the same numbers per block
because rows are independent. Per-frame ``np.argsort(score)[::-1][:topk]``
and the vote stay on the host in the reference's exact form.

In bf16 the BLIP embeddings reach the host as fp32 copies of their bf16
values (the JAX package keeps numpy bf16), so the BLIP score is an fp32
product there. `make_clip_kmeans_selector` is not ported (it needs
scikit-learn).
"""

from __future__ import annotations

import json
import os
from collections import defaultdict

import numpy as np
import torch

from vidil_tpu_torch.config import CLIPConfig, MedConfig, ViTConfig
from vidil_tpu_torch.models import blip as B
from vidil_tpu_torch.models import med as M
from vidil_tpu_torch.models.clip import clip_image_embeds, clip_text_embeds
from vidil_tpu_torch.models.convert import to_device
from vidil_tpu_torch.models.layers import cast_linears, linear
from vidil_tpu_torch.ops.image import preprocess_any
from vidil_tpu_torch.pipeline.capfilt import resolve_device
from vidil_tpu_torch.tokenizer import trimmed_pad_len

# reference: run_visual_tokenization.py:471-472
OMIT_KEYWORDS = [
    "media player", "video", "playing video", "audio", "sound", "taking video",
    "water mark", "water marked", "watermark", "watermarks", "for sale in",
    "sold from", "stock", "sold on", "by viewers", "are provided by",
    "are posted on", "for more", "tag with", "stream from", "viewed from",
    "showing video of", "are on at", "shuttlecock", "shutter",
    "shutter is white", "shutters have bones", "tape is looped",
    "bliss wants you", "thumbnail", "technique",
]

EMBEDDING_BATCH_LIMIT_TEXT = 512  # reference :470


def get_prefix_prompt_functions(version: str) -> dict:
    """reference :56-80 — v0: identity; v1: 'A photo of {x}'."""
    if version == "v0":
        fn = lambda x: x
    elif version == "v1":
        fn = lambda x: f"A photo of {x}"
    else:
        raise ValueError(f"unknown prompt version {version}")
    return {"objects": fn, "attributes": fn, "scenes": fn, "verbs": fn}


def load_ontology(paths: dict, omit_keywords=OMIT_KEYWORDS) -> dict:
    """Load + filter ontology term lists with the reference's exact
    (order-preserving, iterate-while-removing) semantics (:383-406)."""
    def load(p):
        with open(p) as f:
            return json.load(f)

    object_texts = load(paths["objects"])
    attribute_texts = load(paths["attributes"])
    scene_texts = load(paths["scenes"])
    verb_texts = load(paths["verbs"])
    if isinstance(verb_texts, dict):
        verb_texts = list(verb_texts.keys())
    # NOTE: the reference mutates the list while iterating it (:389-391),
    # which skips the element after each removal — replicated exactly.
    for key in attribute_texts:
        if key in object_texts:
            attribute_texts.remove(key)
    for key in omit_keywords:
        if key in object_texts:
            object_texts.remove(key)
        if key in attribute_texts:
            attribute_texts.remove(key)
        if key in scene_texts:
            scene_texts.remove(key)
        if key in verb_texts:
            verb_texts.remove(key)
    return {
        "objects": object_texts,
        "attributes": attribute_texts,
        "scenes": scene_texts,
        "verbs": verb_texts,
    }


def ontology_paths(ontology: str, root: str) -> dict:
    """reference :369-381 — file layout of the vg / vg_tencent ontologies."""
    if ontology == "vg":
        return {
            "objects": os.path.join(root, "vg/openimage_classes_all_cleaned_fictional_characters.json"),
            "attributes": os.path.join(root, "vg/vg_original_attributes_synsets_keys_cleaned_remove_similar0.9.json"),
            "scenes": os.path.join(root, "vg/place365_ontology.json"),
            "verbs": os.path.join(root, "vg/vg_srl_selected_object_synsets_keys_remove_similar0.9.json"),
        }
    if ontology == "vg_tencent":
        return {
            "objects": os.path.join(root, "vg_tencent/tencent_ml_images_objects.json"),
            "attributes": os.path.join(root, "vg_tencent/vg_original_attributes_synsets_keys_cleaned_remove_similar0.9.json"),
            "scenes": os.path.join(root, "vg/place365_ontology.json"),
            "verbs": os.path.join(root, "vg_tencent/vg_srl_selected_object_synsets_keys_remove_similar0.9.json"),
        }
    raise ValueError(f"unknown ontology {ontology}")


def aggregate_frame_tokens(frame_tokens: list[dict]) -> dict:
    """Frequency vote over per-frame top-k lists (reference :173-187)."""
    keys = frame_tokens[0].keys()
    aggregated = {key: [] for key in keys}
    topk = len(frame_tokens[0]["objects"])
    num_frm = len(frame_tokens)
    for key in keys:
        if frame_tokens[0][key] == []:
            continue
        count_dict = defaultdict(int)
        for j in range(topk):
            for i in range(num_frm):
                count_dict[frame_tokens[i][key][j]] += 1
        candidates = sorted(count_dict.items(), key=lambda x: x[1], reverse=True)
        aggregated[key] = [t for t, _ in candidates[:topk]]
    return aggregated


def clip_preprocess_pil(frames_u8: np.ndarray, size: int = 224) -> np.ndarray:
    """(F, H, W, C) uint8 -> (F, size, size, C) uint8 via PIL bicubic
    shortest-side resize + center crop (HF CLIPImageProcessor defaults)."""
    from PIL import Image

    out = np.empty((len(frames_u8), size, size, 3), np.uint8)
    for i, frm in enumerate(frames_u8):
        img = Image.fromarray(frm)
        w, h = img.size
        short, long = (w, h) if w <= h else (h, w)
        new_short = size
        new_long = int(size * long / short)
        nw, nh = (new_short, new_long) if w <= h else (new_long, new_short)
        img = img.resize((nw, nh), Image.BICUBIC)
        left = (nw - size) // 2
        top = (nh - size) // 2
        out[i] = np.asarray(img.crop((left, top, left + size, top + size)))
    return out


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

def _text_blocks(n: int, *arrays):
    """Yield the rows of `arrays` (n rows each) in blocks of
    EMBEDDING_BATCH_LIMIT_TEXT: one block of n rows when n fits, else full
    blocks with the last padded by repeating the last row (the JAX
    package's block shapes)."""
    bs = EMBEDDING_BATCH_LIMIT_TEXT
    if n <= bs:
        yield arrays
        return
    pad = -n % bs
    arrays = [np.concatenate([a, np.repeat(a[-1:], pad, axis=0)]) if pad else a for a in arrays]
    for s in range(0, n + pad, bs):
        yield [a[s:s + bs] for a in arrays]


class _Engine:
    def __init__(self, params, dtype, device):
        self.device = resolve_device(device)
        self.dtype = None if dtype == torch.float32 else dtype  # fp32: no casts
        # linear weights cast once here rather than on every call
        self.params = cast_linears(to_device(params, self.device), self.dtype)

    def _put(self, x):
        if isinstance(x, torch.Tensor):
            return x.to(self.device, non_blocking=True)
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)


class ClipTokenizationEngine(_Engine):
    """encoder_version='clip': cosine scoring only (reference :295-296)."""

    def __init__(self, clip_params, clip_cfg: CLIPConfig, clip_tokenizer, dtype=None,
                 device="cuda"):
        super().__init__(clip_params, dtype, device)
        self.cfg = clip_cfg
        self.tok = clip_tokenizer

    @torch.no_grad()
    def embed_texts(self, texts: list[str]) -> torch.Tensor:
        """(n, D) text embeddings on the device, in blocks of 512 (reference
        :84-96)."""
        ids = self.tok(texts, padding="max_length", truncation=True,
                       max_length=self.cfg.max_text_len).input_ids
        out = [clip_text_embeds(self.params, self._put(blk), self.cfg, dtype=self.dtype)
               for (blk,) in _text_blocks(len(texts), ids)]
        return torch.cat(out)[:len(texts)]

    @torch.no_grad()
    def embed_frames(self, frames_u8) -> torch.Tensor:
        """(F, S, S, C) uint8, already CLIP-preprocessed (host or device) ->
        (F, D) on the device."""
        x = preprocess_any(self._put(frames_u8), self.cfg.image_size)
        return clip_image_embeds(self.params, x, self.cfg, dtype=self.dtype)

    @torch.no_grad()
    def pool_frames(self, frames_u8) -> np.ndarray:
        """The vision pooler_output (F, D_vision) on the host: the
        post-LayerNorm CLS states before the visual projection, the
        reference's clip-kmeans clustering feature (reference:
        data/video_pretrain_dataset.py:199-202)."""
        from vidil_tpu_torch.models.clip import clip_vision_forward

        x = preprocess_any(self._put(frames_u8), self.cfg.image_size)
        pooled = clip_vision_forward(self.params, x, self.cfg, dtype=self.dtype)[1]
        return pooled.float().cpu().numpy()

    @torch.no_grad()
    def score(self, image_embeds, text_embeds) -> np.ndarray:
        """(F, n) cosine scores, an fp32 product on the device, to the host."""
        return torch.matmul(image_embeds.float(), text_embeds.float().t()).cpu().numpy()


class BlipTokenizationEngine(_Engine):
    """encoder_version='blip': cosine + per-frame ITM rerank (reference
    :113-133,277-293), on BLIP-retrieval parameters (the ITM layout)."""

    def __init__(self, params, vit_cfg: ViTConfig, med_cfg: MedConfig, tokenizer,
                 k_test: int = 128, dtype=None, device="cuda"):
        super().__init__(params, dtype, device)
        self.vit_cfg = vit_cfg
        self.med_cfg = med_cfg
        self.tok = tokenizer
        self.k_test = k_test

    @torch.no_grad()
    def _embed_texts(self, ids, mask) -> np.ndarray:
        """One block of texts -> (n, D) normalised text_proj([CLS]), as fp32
        on the host."""
        hidden = M.med_forward(self.params["text_encoder"], self._put(ids), self._put(mask),
                               cfg=self.med_cfg, mode="text", dtype=self.dtype)
        feat = linear(self.params["text_proj"], hidden[:, 0, :], dtype=self.dtype)
        feat = feat / torch.linalg.vector_norm(feat, dim=-1, keepdim=True)
        return feat.float().cpu().numpy()

    def embed_texts(self, texts: list[str]):
        """Returns (text_embeds, text_ids, text_atts) on the host; the ids get
        [ENC] at position 0 for the ITM rerank (reference :114-133). The
        reference's fixed 35-token padding is trimmed to the batch's longest
        text (rounded up to 8): masked pads add exactly 0, so the numbers
        are the same."""
        enc = self.tok(texts, padding="max_length", truncation=True, max_length=35)
        L = trimmed_pad_len(enc.attention_mask)
        ids = np.ascontiguousarray(np.asarray(enc.input_ids)[:, :L])
        atts = np.ascontiguousarray(np.asarray(enc.attention_mask)[:, :L])
        embeds = np.concatenate([self._embed_texts(i, m)
                                 for i, m in _text_blocks(len(texts), ids, atts)])[:len(texts)]
        text_ids = ids.copy()
        text_ids[:, 0] = self.tok.enc_token_id
        return embeds, text_ids, atts

    @torch.no_grad()
    def embed_frames(self, frames_u8):
        """Returns (feats (F, P, D) on the device, embeds (F, E) fp32 on the
        host); the features stay on the device for the rerank."""
        x = preprocess_any(self._put(frames_u8), self.vit_cfg.image_size)
        feats = B.encode_images(self.params, x, self.vit_cfg, dtype=self.dtype)
        emb = linear(self.params["vision_proj"], feats[:, 0, :], dtype=self.dtype)
        emb = emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True)
        return feats, emb.float().cpu().numpy()

    def score(self, image_embeds, text_embeds):
        return image_embeds @ text_embeds.T

    @torch.no_grad()
    def _itm(self, image_feats, ids, mask):
        """image_feats (R, P, D), ids/mask (R*k, L) on the device: each
        frame's k candidate texts share one frame memory through grouped
        cross-attention -> (R*k,) ITM logits[:, 1] on the device."""
        k = ids.shape[0] // image_feats.shape[0]
        logits = B.blip_itm_scores(self.params, image_feats, ids, mask, self.med_cfg,
                                   dtype=self.dtype, group_size=k)
        return logits[:, 1]

    def rerank(self, sims_row, image_feat, text_ids, text_atts):
        """ITM rerank of the top k_test texts for one frame (reference
        :277-293): score = itm_logit[:, 1] + topk_sim at the top-k indices,
        -100 elsewhere."""
        return self.rerank_block(sims_row[None], image_feat[None], text_ids, text_atts)[0]

    def rerank_block(self, sims_rows, image_feats, text_ids, text_atts):
        """Rerank of R frames' top-k_test texts in one call. sims_rows
        (R, n_texts) host; image_feats (R, P, D). Returns (R, n_texts) with
        -100 outside each row's top k."""
        R, n_texts = sims_rows.shape
        k = min(self.k_test, n_texts)
        topk_idx = np.argsort(sims_rows, axis=1)[:, ::-1][:, :k]
        flat = topk_idx.reshape(-1)
        scores = self._itm(self._put(image_feats), self._put(text_ids[flat]),
                           self._put(text_atts[flat])).float().cpu().numpy().reshape(R, k)
        out = np.full(sims_rows.shape, -100.0, np.float32)
        for r in range(R):
            out[r, topk_idx[r]] = scores[r] + sims_rows[r][topk_idx[r]]
        return out

    def rerank_all(self, sims, image_feats, text_ids, text_atts, rows_per_block: int = 4):
        """ITM rerank of every frame row, `rows_per_block` rows per call:
        the computation of `rerank_block` over ceil(N / R) blocks (the last
        padded by repeating its last row, results dropped), enqueued without
        a host sync, with one copy of all scores to the host at the end.
        sims (N, n_texts) host; image_feats (N', P, D) on the device, N' >= N
        (rows past N are never gathered)."""
        N, n_texts = sims.shape
        k = min(self.k_test, n_texts)
        R = rows_per_block
        nb = -(-N // R)
        topk_idx = np.argsort(sims, axis=1)[:, ::-1][:, :k]  # (N, k)
        row_idx = np.concatenate([np.arange(N), np.full(nb * R - N, N - 1)])
        flat = topk_idx[row_idx].reshape(-1)
        ids_all, atts_all = self._put(text_ids[flat]), self._put(text_atts[flat])
        rows_dev = self._put(row_idx)
        feats = image_feats.to(self.device)
        itm = torch.cat([
            self._itm(feats[rows_dev[b * R:(b + 1) * R]],
                      ids_all[b * R * k:(b + 1) * R * k], atts_all[b * R * k:(b + 1) * R * k])
            for b in range(nb)])
        itm = itm.float().cpu().numpy().reshape(nb * R, k)[:N]
        scores = np.full(sims.shape, -100.0, np.float32)
        rows = np.arange(N)[:, None]
        scores[rows, topk_idx] = itm + sims[rows, topk_idx]
        return scores


# ---------------------------------------------------------------------------
# a chunk of videos
# ---------------------------------------------------------------------------

def predict_videos(
    engine,
    video_frames: dict,
    captions: dict,
    visual_token_texts: dict,
    prompt_functions: dict,
    topk_visualize: int = 5,
    text_cache: dict | None = None,
    pad_to_videos: int = 0,
) -> dict:
    """Score every frame of every video against every ontology category.

    video_frames: {video_id: (F, S, S, C) uint8 preprocessed frames}, host
    numpy or device tensors (the CLI uploads them from its decode threads).
    captions: {video_id: caption}. pad_to_videos: pad the frame batch to this
    many videos by repeating the last video, so every chunk runs one shape;
    pad rows are computed and dropped, and rows are independent, so real
    rows do not depend on them. Returns the reference's
    videoid_2_visual_tokens structure (:268-314).
    """
    blip_mode = isinstance(engine, BlipTokenizationEngine)
    video_ids = list(video_frames.keys())
    num_frm = next(iter(video_frames.values())).shape[0]

    frames_list = [video_frames[v] for v in video_ids]
    if pad_to_videos and len(video_ids) < pad_to_videos:
        frames_list = frames_list + [frames_list[-1]] * (pad_to_videos - len(video_ids))
    if any(isinstance(f, torch.Tensor) for f in frames_list):
        all_frames = torch.cat([engine._put(f) for f in frames_list])
    else:
        all_frames = np.concatenate(frames_list)
    n_real = len(video_ids) * num_frm
    # the padded rows go through scoring (and the rerank); they are sliced
    # off at the final score[:n_real]
    if blip_mode:
        image_feats, image_embeds = engine.embed_frames(all_frames)
    else:
        image_embeds = engine.embed_frames(all_frames)

    result = {
        vid: {"frame_tokens": [defaultdict(list) for _ in range(num_frm)], "caption": captions[vid]}
        for vid in video_ids
    }

    for key in visual_token_texts.keys():
        texts = [prompt_functions[key](t) for t in visual_token_texts[key]]
        if text_cache is not None and key in text_cache:
            text_side = text_cache[key]
        else:
            text_side = engine.embed_texts(texts)
            if text_cache is not None:
                text_cache[key] = text_side
        if blip_mode:
            text_embeds, text_ids, text_atts = text_side
        else:
            text_embeds = text_side

        sims = engine.score(image_embeds, text_embeds)  # (n_frames_padded, n_texts)
        if blip_mode:
            score = engine.rerank_all(sims, image_feats, text_ids, text_atts)
        else:
            score = sims

        score = score[:n_real].reshape(len(video_ids), num_frm, -1)
        for j, vid in enumerate(video_ids):
            for frm_idx in range(num_frm):
                frm_score = score[j][frm_idx]
                inds = np.argsort(frm_score)[::-1][:topk_visualize]
                result[vid]["frame_tokens"][frm_idx][key] = [visual_token_texts[key][ii] for ii in inds]

    for vid, obj in result.items():
        obj["frame_tokens"] = [dict(ft) for ft in obj["frame_tokens"]]
        obj["aggregated_tokens"] = aggregate_frame_tokens(obj["frame_tokens"])
    return result


def make_clip_kmeans_selector(engine: ClipTokenizationEngine, downsample_ratio: int = 2):
    """clip-kmeans frame selection (reference:
    data/video_pretrain_dataset.py:189-216; the JAX package's
    ``make_clip_kmeans_selector``): embed every `downsample_ratio`-th frame
    with CLIP (`pool_frames`), cluster the features with scikit-learn's
    ``KMeans(n_clusters=num_frm, random_state=0)``, and draw one frame per
    cluster with np.random. selector(vr, num_frm) -> sorted frame indices.

    scikit-learn is imported here, on the host, as the JAX package imports
    it; where it is missing this raises ImportError saying so."""
    try:
        from sklearn.cluster import KMeans
    except ImportError as e:
        raise ImportError("vidil_tpu_torch: the clip-kmeans frame selector needs scikit-learn "
                          "(sklearn.cluster.KMeans) on the host; install it or choose another "
                          "frm_sampling_strategy") from e

    def selector(vr, num_frm: int):
        vlen = len(vr)
        downsampled = np.arange(vlen, step=downsample_ratio, dtype=int)
        frames = vr.get_batch(downsampled)
        pre = clip_preprocess_pil(frames, engine.cfg.image_size)
        emb = engine.pool_frames(pre)
        labels = KMeans(n_clusters=num_frm, random_state=0).fit(emb).labels_
        out = []
        for i in range(num_frm):
            masked = np.where(labels == i)[0]
            out.append(downsampled[np.random.choice(masked)])
        return sorted(out)

    return selector
