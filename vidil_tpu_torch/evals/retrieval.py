"""Video-text retrieval evaluation: the full similarity matrix, then the
k_test ITM rerank of each row's top k.

Counterpart of ``vidil_tpu/evals/retrieval.py``: score = itm_logit +
similarity at each row's top-k positions and -100 elsewhere. The rerank
runs in blocks of `rows_per_batch` rows x k pairs; v2t shares one video
memory across a row's k texts, t2v regroups the pairs by video into
buckets of G texts (`build_t2v_buckets`), so both directions run grouped
cross-attention (`self_fold` is passed on; see `med_forward`).
The JAX package scans the blocks of a dispatch in one program; here a
dispatch is a Python loop over the same blocks, padded the same way, and
the next dispatch is enqueued before the previous one's scores are read
back (their copy to the host is queued behind them, not behind the next;
the block indices are on the device before the first dispatch).

Over several ranks each rank reranks its `shard_range` of the v2t rows
and of the t2v rows (every rank holds all features), and the ranks' score
matrices combine by an all-gather: ``sum(0) + 100 * (world - 1)``, the JAX
package's formula (each entry is -100 on every rank but the one that
scored it).
"""

from __future__ import annotations

import numpy as np
import torch

from vidil_tpu_torch.config import MedConfig, ViTConfig
from vidil_tpu_torch.models import blip as B
from vidil_tpu_torch.models import med as M
from vidil_tpu_torch.models.layers import linear
from vidil_tpu_torch.tokenizer import trimmed_pad_len
from vidil_tpu_torch.utils import get_world_size, is_dist_avail_and_initialized, shard_range


def build_t2v_buckets(topk, start: int, end: int, G: int):
    """Per-video text buckets for the t2v rerank (the JAX package's, as it is).

    topk: (end - start, k) video ids per text row, rank order. Returns
    (bucket_vid (nb,), bucket_txt (nb, G), bucket_real (nb,)): for each
    video (ascending id), its texts in text-row order chunked into buckets
    of G, padded with each chunk's last real element. The layout decides
    the rerank's block shapes."""
    k = topk.shape[1]
    cols = topk.reshape(-1).astype(np.int64)
    rows = np.repeat(np.arange(start, end, dtype=np.int64), k)
    order = np.argsort(cols, kind="stable")
    cols_s, rows_s = cols[order], rows[order]
    uniq, starts_u, counts = np.unique(cols_s, return_index=True, return_counts=True)
    nb_per = -(-counts // G)  # buckets per video
    vid_idx = np.repeat(np.arange(len(uniq)), nb_per)
    within = np.concatenate([np.arange(n) for n in nb_per])
    bucket_real = np.minimum(counts[vid_idx] - within * G, G)
    base = starts_u[vid_idx] + within * G
    gather = base[:, None] + np.minimum(np.arange(G)[None, :], (bucket_real - 1)[:, None])
    return uniq[vid_idx], rows_s[gather], bucket_real


def _normalize(feat):
    return feat / feat.float().norm(dim=-1, keepdim=True).to(feat.dtype)


class RetrievalEvaluator:
    """The retrieval eval of one model on one device (the params' device).

    dtype: the towers' compute dtype (bf16 in the trainer). self_fold: the
    JAX package's texts per folded self-attention sequence in the rerank
    (the port runs the fold's exact result unfolded, `med_forward`). t2v_group: texts per t2v bucket, None =
    min(64, k_test). blocks_per_dispatch: rerank blocks per dispatch."""

    def __init__(self, params, vit_cfg: ViTConfig, med_cfg: MedConfig, tokenizer,
                 k_test: int = 64, dtype=torch.bfloat16, rows_per_batch: int = 8,
                 blocks_per_dispatch: int = 8, self_fold: int = 8,
                 t2v_group: int | None = None):
        self.params = params
        self.device = params["vision_proj"]["kernel"].device
        self.vit_cfg = vit_cfg
        self.med_cfg = med_cfg
        self.tok = tokenizer
        self.k_test = k_test
        self.dtype = dtype
        self.rows_per_batch = rows_per_batch
        self.blocks_per_dispatch = blocks_per_dispatch
        self.self_fold = self_fold
        self.t2v_group = t2v_group

    def _put(self, x):
        return torch.as_tensor(np.asarray(x), device=self.device)

    @torch.no_grad()
    def _text_side(self, ids, mask):
        # no self_fold here, as in the JAX package: 256 rows x 35 tokens
        hidden = M.med_forward(self.params["text_encoder"], ids, mask, cfg=self.med_cfg,
                               mode="text", dtype=self.dtype)
        feat = linear(self.params["text_proj"], hidden[:, 0, :], dtype=self.dtype)
        return _normalize(feat).float()

    @torch.no_grad()
    def _video_side(self, video):
        Bv, N = video.shape[:2]
        feats = B.encode_images(self.params, video.reshape((Bv * N,) + video.shape[2:]),
                                self.vit_cfg, dtype=self.dtype)
        emb = linear(self.params["vision_proj"], feats[:, 0, :], dtype=self.dtype)
        emb = _normalize(emb.reshape(Bv, N, -1).mean(dim=1))
        return feats.reshape(Bv, N * feats.shape[1], feats.shape[2]), emb.float()

    def compute_text_features(self, texts: list[str], batch_size: int = 256):
        """Text embeddings (host fp32) of batches of 256, and the ids with
        [ENC] at position 0 and their masks, trimmed to the corpus's padded
        length (`trimmed_pad_len`; the pads are masked, so it changes no
        score)."""
        embeds, ids, atts = [], [], []
        for i in range(0, len(texts), batch_size):
            enc = self.tok(texts[i:i + batch_size], padding="max_length", truncation=True,
                           max_length=35)
            e = self._text_side(self._put(enc.input_ids).long(),
                                self._put(enc.attention_mask).long())
            embeds.append(e.cpu().numpy())
            ids.append(enc.input_ids)
            atts.append(enc.attention_mask)
        text_ids = np.concatenate(ids)
        text_ids[:, 0] = self.tok.enc_token_id
        text_atts = np.concatenate(atts)
        L = trimmed_pad_len(text_atts)
        return (np.concatenate(embeds), np.ascontiguousarray(text_ids[:, :L]),
                np.ascontiguousarray(text_atts[:, :L]))

    def compute_video_features(self, video_batches):
        """video_batches: iterable of (B, N, S, S, C) normalized arrays or
        tensors. Returns (video_feats, a tensor left on the device,
        video_embeds, host fp32)."""
        feats, embeds = [], []
        for video in video_batches:
            f, e = self._video_side(torch.as_tensor(video, device=self.device))
            feats.append(f)
            embeds.append(e.cpu().numpy())
        return torch.cat(feats), np.concatenate(embeds)

    # --- rerank blocks: (R rows or buckets) x (k or G texts) ---

    @torch.no_grad()
    def _itm_grouped(self, vf, tids, tatts, vids, txts):
        """ITM logits of R video memories x G texts each, grouped (one
        memory per group of G texts, no replication), folded by
        `self_fold`. Returns (R, G) fp32."""
        R, G = txts.shape
        flat = txts.reshape(-1)
        logits = B.blip_itm_scores(self.params, vf[vids], tids[flat], tatts[flat], self.med_cfg,
                                   dtype=self.dtype, group_size=G, self_fold=self.self_fold)
        return logits[:, 1].reshape(R, G)

    def _blocks(self, vf, tids, tatts):
        """blocks_fn(vids_b (n, R), txts_b (n, R, G)) -> (n, R, G) ITM
        logits, block by block (v2t: rows and their top k; t2v: buckets)."""
        def run(vids_b, txts_b):
            return torch.stack([self._itm_grouped(vf, tids, tatts, v, t)
                                for v, t in zip(vids_b, txts_b)])
        return run

    def _rerank_rows(self, sims, itm_blocks_fn):
        """v2t: each row's top k by host argsort (np.argsort[::-1], the
        reference's order), R-row blocks (the last padded by repeating its
        last row), scored by `itm_blocks_fn(rows_b, topk_b) -> (n, R, k)`."""
        n_rows, n_cols = sims.shape
        k = min(self.k_test, n_cols)
        R = max(1, self.rows_per_batch)
        scores = np.full(sims.shape, -100.0, np.float32)
        start, end = shard_range(n_rows)
        rows_list, topk_list, reals = [], [], []
        for block_start in range(start, end, R):
            rows = list(range(block_start, min(end, block_start + R)))
            reals.append(len(rows))
            while len(rows) < R:
                rows.append(rows[-1])
            rows_arr = np.asarray(rows, np.int64)
            rows_list.append(rows_arr)
            topk_list.append(np.argsort(sims[rows_arr], axis=1)[:, ::-1][:, :k])
        if not rows_list:
            return scores
        rows_mat, topk_mat = np.stack(rows_list), np.stack(topk_list)
        itm = self._dispatch_blocks(itm_blocks_fn, rows_mat, topk_mat)
        valid = np.arange(R)[None, :] < np.asarray(reals)[:, None]
        rr, cc = rows_mat[valid], topk_mat[valid]
        scores[rr[:, None], cc] = itm[valid] + sims[rr[:, None], cc]
        return scores

    def _dispatch_blocks(self, blocks_fn, *stacked):
        """Run stacked blocks in dispatches of `blocks_per_dispatch` (the
        last one padded by repeating its last block; the extra results are
        dropped), one dispatch in flight: dispatch i+1 is enqueued before
        dispatch i's scores are read back. Every dispatch's block indices
        go to the device in one copy before the loop (a copy from pageable
        host memory waits for the stream, so one inside the loop would
        wait for the previous dispatch's work). On the card each
        dispatch's scores go to pinned host memory by a copy queued right
        behind it, with an event to wait on."""
        n_blocks = stacked[0].shape[0]
        SB = max(1, self.blocks_per_dispatch)
        pad = (-n_blocks) % SB
        on_device = [self._put(np.concatenate([a, np.repeat(a[-1:], pad, axis=0)]) if pad else a)
                     for a in stacked]
        outs, pending = [], None
        for off in range(0, n_blocks, SB):
            dev = blocks_fn(*(a[off:off + SB] for a in on_device))  # enqueue only
            copy = _to_host_async(dev)
            if pending is not None:
                outs.append(_read(pending[0])[:pending[1]])
            pending = (copy, min(SB, n_blocks - off))
        if pending is not None:
            outs.append(_read(pending[0])[:pending[1]])
        return np.concatenate(outs)

    def t2v_plan(self, sims_t2v):
        """The t2v buckets of this rank's text rows (`shard_range`) of a
        (texts, videos) similarity matrix, padded to whole blocks of
        `rows_per_batch`: (vids_b (n, R), txts_b (n, R, G), bucket_vid,
        bucket_txt, bucket_real) — the blocks the rerank runs; None when the
        rank has no rows."""
        n_rows, n_cols = sims_t2v.shape
        k = min(self.k_test, n_cols)
        G = max(1, min(self.t2v_group or 64, k))
        R = max(1, self.rows_per_batch)
        start, end = shard_range(n_rows)
        if start >= end:
            return None
        topk = np.argsort(sims_t2v[start:end], axis=1)[:, ::-1][:, :k]
        bucket_vid, bucket_txt, bucket_real = build_t2v_buckets(topk, start, end, G)
        nb = len(bucket_vid)
        pad = (-nb) % R
        if pad:
            bucket_vid = np.concatenate([bucket_vid, np.repeat(bucket_vid[-1:], pad)])
            bucket_txt = np.concatenate([bucket_txt, np.repeat(bucket_txt[-1:], pad, axis=0)])
        return (bucket_vid.reshape(-1, R), bucket_txt.reshape(-1, R, G),
                bucket_vid[:nb], bucket_txt[:nb], bucket_real)

    def _rerank_t2v_bucketed(self, sims, vf, tids, tatts):
        """t2v: invert each text's top-k videos into per-video buckets of G
        texts and score each bucket against its one video memory. The same
        pairs and the same score as a row-major t2v rerank."""
        scores = np.full(sims.shape, -100.0, np.float32)
        plan = self.t2v_plan(sims)
        if plan is None:
            return scores
        vids_b, txts_b, bucket_vid, bucket_txt, bucket_real = plan
        G = txts_b.shape[-1]
        itm = self._dispatch_blocks(self._blocks(vf, tids, tatts), vids_b, txts_b)
        nb = len(bucket_vid)
        flat = itm.reshape(-1, G)[:nb]
        valid = np.arange(G)[None, :] < bucket_real[:, None]
        rr = bucket_txt[valid]
        cc = np.repeat(bucket_vid, bucket_real)
        scores[rr, cc] = flat[valid] + sims[rr, cc]
        return scores

    def score_matrices(self, video_feats, video_embeds, text_embeds, text_ids, text_atts):
        """Full v2t (videos, texts) and t2v (texts, videos) score matrices;
        over several ranks each reranks its rows and the ranks combine
        (module docstring). Every rank calls it with the same features."""
        world = get_world_size()
        if world > 1 and not is_dist_avail_and_initialized():
            raise RuntimeError("vidil_tpu_torch: a retrieval eval over several ranks needs "
                               "an initialised process group")
        sims = np.asarray(video_embeds) @ np.asarray(text_embeds).T
        vf = torch.as_tensor(video_feats, device=self.device)
        tids = self._put(text_ids).long()
        tatts = self._put(text_atts).long()
        score_v2t = self._rerank_rows(sims, self._blocks(vf, tids, tatts))
        score_t2v = self._rerank_t2v_bucketed(sims.T, vf, tids, tatts)
        if world > 1:
            score_v2t, score_t2v = (_combine_ranks(s, world) for s in (score_v2t, score_t2v))
        return score_v2t, score_t2v


def _combine_ranks(scores, world: int):
    """The ranks' score matrices, all-gathered and combined as the JAX
    package does: ``sum(0) + 100 * (world - 1)`` in fp32."""
    from vidil_tpu_torch.parallel.collectives import concat_all_gather
    from vidil_tpu_torch.utils.dist import collective_device

    t = torch.from_numpy(scores).to(collective_device())
    every = concat_all_gather(t[None]).cpu().numpy()
    return every.sum(axis=0) + 100.0 * (world - 1)


def _to_host_async(t):
    """Start the copy of `t` to the host: on the card into pinned memory,
    queued behind the work that makes `t`, with an event recorded after it."""
    if not t.is_cuda:
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


def _read(copy):
    host, done = copy
    if done is not None:
        done.synchronize()
    return host.numpy()


def itm_eval(scores_v2t, scores_t2v, txt2vid, vid2txt) -> dict:
    """R@1/5/10, their means and the median rank (the JAX package's, as it is)."""
    ranks = np.zeros(scores_v2t.shape[0])
    for index, score in enumerate(scores_v2t):
        inds = np.argsort(score)[::-1]
        ranks[index] = np.where(inds == vid2txt[index])[0][0]
    tr1 = 100.0 * len(np.where(ranks < 1)[0]) / len(ranks)
    tr5 = 100.0 * len(np.where(ranks < 5)[0]) / len(ranks)
    tr10 = 100.0 * len(np.where(ranks < 10)[0]) / len(ranks)

    ranks = np.zeros(scores_t2v.shape[0])
    for index, score in enumerate(scores_t2v):
        inds = np.argsort(score)[::-1]
        ranks[index] = np.where(inds == txt2vid[index])[0][0]
    mdR = np.median(ranks + 1)
    vr1 = 100.0 * len(np.where(ranks < 1)[0]) / len(ranks)
    vr5 = 100.0 * len(np.where(ranks < 5)[0]) / len(ranks)
    vr10 = 100.0 * len(np.where(ranks < 10)[0]) / len(ranks)

    tr_mean = (tr1 + tr5 + tr10) / 3
    vr_mean = (vr1 + vr5 + vr10) / 3
    return {
        "txt_r1": tr1, "txt_r5": tr5, "txt_r10": tr10, "txt_r_mean": tr_mean,
        "vid_r1": vr1, "vid_r5": vr5, "vid_r10": vr10, "vid_r_mean": vr_mean,
        "vid_mdR": mdR, "r_mean": (tr_mean + vr_mean) / 2,
    }
