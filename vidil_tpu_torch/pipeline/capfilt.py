"""CapFilt: per-frame BLIP captioning + ITM filtering, batched on the device.

Counterpart of ``vidil_tpu/pipeline/capfilt.py``. Frames of many videos
are captioned in one beam-search (or nucleus-sampling) run (batch =
videos × num_frm), and the ITM filter scores all (caption, frame) pairs of
a chunk in one grouped call — softmax[:, 1], then max/avg over frames
against the threshold. Frames arrive at image_size or at their native
size (``resize_on_device``: the encode resizes them, `preprocess_any`).

``dispatch_chunk`` enqueues a chunk's whole device chain (filterer
encode -> captioner encode -> decode -> fused-filter ITM) without a
host sync and starts the copies of the small results to pinned host
memory; ``complete_chunk`` waits for them and does the string work. The
fused filter builds the ITM ids on the device from the generated tokens;
the host then verifies each row and re-scores any that re-tokenize
differently through the classic path, so results always equal the
classic path's.

Spans (`utils/profiling.py:annotate`) name the stages of both halves:
``capfilt.dispatch`` holds the frames' upload, both encodes, the decode's
(`ops/generation.py`), the fused ITM's enqueue and the early readback;
``capfilt.complete`` holds the wait for the chunk's results, the
detokenization, the dedup with the original captions' sentences
(``capfilt.split``, made only where the configuration keeps them), and the
filter's host checks with any classic re-score (``capfilt.fallback``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from vidil_tpu_torch.config import MedConfig, ViTConfig
from vidil_tpu_torch.models import blip as B
from vidil_tpu_torch.models.convert import to_device
from vidil_tpu_torch.models.layers import cast_linears
from vidil_tpu_torch.ops.decode_graph import DecodeGraphs
from vidil_tpu_torch.ops.generation import GenerationConfig
from vidil_tpu_torch.ops.image import CLIP_MEAN, CLIP_STD, YUV420Frames, preprocess_any
from vidil_tpu_torch.pipeline.fused_filter import (
    fused_applicable,
    itm_ids_from_seqs,
    itm_ids_from_seqs_np,
)
from vidil_tpu_torch.pipeline.sentences import split_sentences
from vidil_tpu_torch.utils.pinned import PinnedArena
from vidil_tpu_torch.utils.profiling import annotate


def resolve_device(device) -> torch.device:
    """The port's entry points run on CUDA unless the caller asks for the
    CPU; asking for CUDA on a host without it raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    return device


# ---------------------------------------------------------------------------
# host-side preprocessing
# ---------------------------------------------------------------------------

def preprocess_frames_pil(frames_u8: np.ndarray, image_size: int) -> np.ndarray:
    """(F, H, W, C) uint8 -> (F, S, S, C) uint8 by PIL bicubic resize (the
    reference's torchvision/PIL path)."""
    from PIL import Image

    out = np.empty((len(frames_u8), image_size, image_size, 3), np.uint8)
    for i, frm in enumerate(frames_u8):
        img = Image.fromarray(frm).resize((image_size, image_size), Image.BICUBIC)
        out[i] = np.asarray(img)
    return out


def original_caption_sentences(texts: list[str], do_sentence_tokenization: bool) -> list[str]:
    if do_sentence_tokenization:
        out = []
        for original_cap in texts:
            for sent in split_sentences(original_cap.replace("\n", ". ")):
                if len(sent) > 3:
                    out.append(sent.strip())
        return out
    return [cap.replace("\n", ". ").strip() for cap in texts]


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _num_frames(frames) -> int:
    return frames.num_frames if isinstance(frames, YUV420Frames) else frames.shape[0]


def _concat_frames(frame_list):
    """Concatenate per-video frames along the frame axis: uint8 RGB arrays
    or YUV420Frames, as host numpy or device tensors."""
    def cat(parts):
        return torch.cat(parts, dim=0) if isinstance(parts[0], torch.Tensor) else np.concatenate(parts, axis=0)

    if isinstance(frame_list[0], YUV420Frames):
        return YUV420Frames(*(cat([f[i] for f in frame_list]) for i in range(3)))
    return cat(frame_list)


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------

@dataclass
class CapFiltResult:
    video_id: str
    unfiltered_text: list[str]
    text: list[str]


@dataclass
class ChunkDispatch:
    """Device work of one chunk, in flight (see CapFiltEngine.dispatch_chunk)."""

    chunk: list[dict]
    config: dict
    num_frm: int
    seqs_dev: object | None      # (V*F, max_length) caption token ids
    frame_embeds: object | None  # (V, F, P, D) filterer ViT outputs
    itm_probs: object | None = None  # (V, T, F) fused-filter probs
    n_real: int | None = None    # videos before tail-chunk padding (counters)
    seqs_host: object | None = None       # pinned host copies, valid after `ready`
    itm_probs_host: object | None = None
    ready: object | None = None           # CUDA event recorded after the copies


class CapFiltEngine:
    """Captioner + filterer over chunks of videos, on one device."""

    def __init__(
        self,
        captioner_params,
        filterer_params,
        tokenizer,
        vit_cfg: ViTConfig,
        med_cfg: MedConfig,
        *,
        prompt: str = "a picture of ",
        num_beams: int = 3,
        max_length: int = 20,
        min_length: int = 5,
        top_p: float = 0.9,
        itm_max_text_len: int = 35,
        dtype=torch.bfloat16,
        length_norm: str = "legacy",
        beam_group_kv: bool = False,
        decode_layer_unroll: bool = False,
        decode_lazy_reorder: bool = False,
        fused_filter: bool = True,
        device="cuda",
    ):
        """decode_layer_unroll and decode_lazy_reorder select the decode's
        cache layout and beam reorder (`blip_generate_ids`); top_p is the
        sampling mode's nucleus; length_norm the beam search's dialect
        ("legacy" | "modern", `ops/generation.py`).

        The decode runs all its steps (no host sync inside it), so on the
        card a beam decode of a shape seen before replays CUDA graphs
        (`ops/decode_graph.py`); the same tokens as the reference's early
        exit. On the card the chunk's small device->host copies start right
        after its dispatch (`dispatch_chunk`)."""
        self.device = resolve_device(device)
        if length_norm not in ("legacy", "modern"):
            raise ValueError(f"unknown length_norm: {length_norm!r}")
        self._readback = PinnedArena()
        if dtype == torch.float32:
            dtype = None  # fp32 params: no casts
        self.dtype = dtype
        self.beam_group_kv = beam_group_kv
        self.decode_kw = dict(decode_layer_unroll=decode_layer_unroll,
                              decode_lazy_reorder=decode_lazy_reorder)
        self.fused_filter = fused_filter
        # the beam decode's CUDA graphs, by shape (`blip_beam_search`)
        self.decode_graphs = DecodeGraphs()
        # how often the fused filter's host verification re-scored videos
        # through the classic path
        self.fused_fallback_videos = 0
        self.fused_total_videos = 0

        # linear weights cast once here rather than on every call
        self.captioner_params = cast_linears(to_device(captioner_params, self.device), dtype)
        self.filterer_params = cast_linears(to_device(filterer_params, self.device), dtype)
        self.tok = tokenizer
        self.vit_cfg = vit_cfg
        self.med_cfg = med_cfg
        self.prompt = prompt
        self.itm_max_text_len = itm_max_text_len

        # prompt ids: [DEC] + prompt tokens, trailing [SEP] cut
        prompt_ids = tokenizer.encode(prompt)
        prompt_ids[0] = tokenizer.bos_token_id
        self.prompt_ids = np.asarray(prompt_ids[:-1], np.int32)
        self.prompt_length = len(prompt_ids) - 1
        self._prompt_dev = torch.from_numpy(self.prompt_ids).to(self.device)

        # fused-filter ITM text length: [CLS] + at most max_length - Lp
        # caption tokens + [SEP], rounded up to 8 (masked pads add exactly 0)
        self.itm_text_len_fused = min(
            itm_max_text_len, _round_up(max_length - len(self.prompt_ids) + 2, 8))

        # early_exit=False: no host sync inside the decode (same tokens)
        self.gen_beam = GenerationConfig(
            max_length=max_length, min_length=min_length, num_beams=num_beams,
            eos_token_id=tokenizer.sep_token_id, pad_token_id=tokenizer.pad_token_id,
            repetition_penalty=1.0, length_norm=length_norm, early_exit=False,
        )
        # the reference's sampling settings (models/blip.py: top_p 0.9,
        # repetition_penalty 1.1), one row per frame
        self.gen_sample = GenerationConfig(
            max_length=max_length, min_length=min_length, num_beams=1,
            eos_token_id=tokenizer.sep_token_id, pad_token_id=tokenizer.pad_token_id,
            repetition_penalty=1.1, top_p=top_p, length_norm=length_norm, early_exit=False,
        )

    # -- device programs ----------------------------------------------------

    def _put(self, x):
        if isinstance(x, YUV420Frames):
            return YUV420Frames(*(self._put(p) for p in x))
        if isinstance(x, torch.Tensor):
            return x.to(self.device, non_blocking=True)
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    def _encode(self, params, frames):
        with annotate("capfilt.encode"):
            x = preprocess_any(frames, self.vit_cfg.image_size, CLIP_MEAN, CLIP_STD)
            return B.encode_images(params, x, self.vit_cfg, dtype=self.dtype)

    def encode_captioner(self, frames):
        """(F, H, W, C) uint8 frames (or YUV420Frames) -> (F, P, D) embeddings."""
        return self._encode(self.captioner_params, self._put(frames))

    def generate_beam(self, embeds):
        """(N, P, D) captioner embeddings -> (N, max_length) token ids."""
        prompt = self._prompt_dev[None].expand(embeds.shape[0], -1)
        return B.blip_generate_ids(self.captioner_params, embeds, prompt, self.med_cfg,
                                   self.gen_beam, dtype=self.dtype,
                                   beam_group_kv=self.beam_group_kv, graphs=self.decode_graphs,
                                   **self.decode_kw)

    def generate_sample(self, embeds, generator: torch.Generator):
        """(N, P, D) captioner embeddings -> (N, max_length) token ids by
        nucleus sampling, one row per frame, drawn from `generator` (a
        generator on the engine's device)."""
        prompt = self._prompt_dev[None].expand(embeds.shape[0], -1)
        return B.blip_generate_ids(self.captioner_params, embeds, prompt, self.med_cfg,
                                   self.gen_sample, sample=True, generator=generator,
                                   dtype=self.dtype, **self.decode_kw)

    def encode_filter_frames(self, frames, num_frm: int):
        """(V*F, H, W, C) uint8 -> (V, F, P, D) filterer embeddings."""
        embeds = self._encode(self.filterer_params, self._put(frames))
        V = _num_frames(frames) // num_frm
        return embeds.reshape((V, num_frm) + tuple(embeds.shape[1:]))

    def _itm_grouped(self, frame_embeds, text_ids, text_mask):
        """frame_embeds (V, F, P, D), text ids/mask (V, T, L) -> probs
        (V, T, F). All T texts of a video share each frame's memory through
        grouped cross-attention."""
        V, F = frame_embeds.shape[:2]
        T, L = text_ids.shape[1:]
        img = frame_embeds.reshape((V * F,) + tuple(frame_embeds.shape[2:]))
        # query rows ordered (v, f, t): the t-rows of a group share frame (v, f)
        ids = text_ids[:, None].expand(V, F, T, L).reshape(V * F * T, L)
        mask = text_mask[:, None].expand(V, F, T, L).reshape(V * F * T, L)
        logits = B.blip_itm_scores(self.filterer_params, img, ids, mask, self.med_cfg,
                                   dtype=self.dtype, group_size=T)
        probs = torch.softmax(logits, dim=1)[:, 1].reshape(V, F, T)
        return probs.permute(0, 2, 1)

    def _itm_fused(self, frame_embeds, seqs):
        """Fused filter: ITM ids built on the device from the generated
        sequences; every frame's caption scored against every frame of its
        video -> probs (V, T=round_up(F, 4), F)."""
        V, F = frame_embeds.shape[:2]
        ids, tmask = itm_ids_from_seqs(
            seqs, len(self.prompt_ids), self.tok.cls_token_id, self.tok.sep_token_id,
            self.tok.pad_token_id, self.itm_text_len_fused)
        L = ids.shape[1]
        ids = ids.reshape(V, F, L)
        tmask = tmask.reshape(V, F, L)
        # pad rows to the classic path's text-count bucket (zero ids, mask
        # [1, 0, ...]) so both paths run the same group size
        T = _round_up(F, 4)
        if T != F:
            pad_ids = torch.zeros((V, T - F, L), dtype=torch.int32, device=ids.device)
            pad_mask = torch.zeros_like(pad_ids)
            pad_mask[:, :, 0] = 1
            ids = torch.cat([ids, pad_ids], dim=1)
            tmask = torch.cat([tmask, pad_mask], dim=1)
        return self._itm_grouped(frame_embeds, ids, tmask)

    # -- captioning ---------------------------------------------------------

    def caption_frames(self, frames_u8, mode: str = "beam", generator=None) -> list[str]:
        """(F, S, S, C) uint8 frames -> F caption strings, one per frame,
        through the captioner's encode and the beam decode, or with `mode`
        other than 'beam' the nucleus sampling of `dispatch_chunk`, drawing
        from `generator` (a generator on the engine's device; one seeded
        with 0 when None)."""
        embeds = self.encode_captioner(frames_u8)
        if mode == "beam":
            seqs = self.generate_beam(embeds)
        else:
            if generator is None:
                generator = torch.Generator(device=self.device).manual_seed(0)
            seqs = self.generate_sample(embeds, generator)
        return B.decode_captions(self.tok, seqs.cpu().numpy(), self.prompt)

    # -- filtering ----------------------------------------------------------

    def filter_captions_batch(self, frame_embeds, texts_per_video: list[list[str]],
                              threshold: float, mode: str = "max_filter",
                              text_bucket: int = 4) -> list[list[str]]:
        """Score all (text, frame) pairs of a chunk in one grouped ITM call.
        frame_embeds: (V, F, P, D) on the device; texts are tokenized on the
        host and padded per video to a bucketed T."""
        V, F = frame_embeds.shape[:2]
        n_texts = [len(t) for t in texts_per_video]
        T = _round_up(max(n_texts, default=0), text_bucket)
        if T == 0:
            return [[] for _ in range(V)]
        flat = [text for texts in texts_per_video for text in texts]
        enc = self.tok(flat, padding="max_length", truncation=True,
                       max_length=self.itm_max_text_len)
        L = enc.input_ids.shape[1]
        ids = np.zeros((V, T, L), np.int32)
        mask = np.zeros_like(ids)
        pos = 0
        for v, n in enumerate(n_texts):
            ids[v, :n] = enc.input_ids[pos:pos + n]
            mask[v, :n] = enc.attention_mask[pos:pos + n]
            pos += n
        mask[:, :, 0] = 1  # [CLS] always attended (incl. padded rows)
        probs = self._itm_grouped(frame_embeds, self._put(ids), self._put(mask)).cpu().numpy()
        agg = probs.max(axis=2) if mode == "max_filter" else probs.sum(axis=2) / F
        out: list[list[str]] = [[] for _ in range(V)]
        for v, texts in enumerate(texts_per_video):
            for t, text in enumerate(texts):
                if agg[v, t] > threshold:
                    out[v].append(text)
        return out

    # -- full CapFilt over a chunk ------------------------------------------

    def dispatch_chunk(self, chunk: list[dict], config: dict, rng=None,
                       n_real: int | None = None) -> ChunkDispatch:
        """Enqueue a chunk's device work without blocking the host.

        chunk items: {'video_id': str, 'frames': (F, H, W, C) uint8 or
        YUV420Frames (host or device; at image_size, or all at one native
        size that the encode resizes), 'text': [original captions]}.
        config keys follow the reference yaml (caption / filter /
        filter_generated_only / keep_original_caption / threshold /
        filter_mode / generation_mode / do_sentence_tokenization).
        generation_mode other than 'beam' samples, drawing from `rng`, a
        torch.Generator on the engine's device (one seeded with 0 when
        none is given).
        """
        with annotate("capfilt.dispatch"):
            F = _num_frames(chunk[0]["frames"])
            with annotate("capfilt.upload"):
                frames = self._put(_concat_frames([c["frames"] for c in chunk]))
            need_filter = config.get("filter", True)
            seqs = None
            itm_probs = None
            # the filter's encode before the decode, which it does not need:
            # behind a decode replayed from CUDA graphs (≈ 100 ms of device
            # work) the launch queue (≈ 1000 launches) fills, and the
            # encode's launches would hold the host until the decode drains
            frame_embeds = self.encode_filter_frames(frames, F) if need_filter else None
            if config.get("caption", True):
                embeds = self._encode(self.captioner_params, frames)
                if config.get("generation_mode", "beam") != "beam":
                    if rng is None:
                        rng = torch.Generator(device=self.device).manual_seed(0)
                    seqs = self.generate_sample(embeds, rng)
                else:
                    seqs = self.generate_beam(embeds)
            if self.fused_filter and seqs is not None and need_filter and fused_applicable(config):
                with annotate("capfilt.itm"):
                    itm_probs = self._itm_fused(frame_embeds, seqs)
            d = ChunkDispatch(chunk, config, F, seqs, frame_embeds, itm_probs, n_real=n_real)
            if self.device.type == "cuda":
                # start the small device->host copies now, into pinned memory
                with annotate("capfilt.readback"):
                    if seqs is not None:
                        d.seqs_host = self._readback.copy(seqs)
                    if itm_probs is not None:
                        d.itm_probs_host = self._readback.copy(itm_probs)
                    d.ready = torch.cuda.Event()
                    d.ready.record()
            return d

    @staticmethod
    def _host(d: ChunkDispatch, dev, host):
        if dev is None:
            return None
        if host is not None:
            d.ready.synchronize()
            return host.numpy()
        return dev.cpu().numpy()

    def complete_chunk(self, d: ChunkDispatch) -> list[CapFiltResult]:
        """Wait for a dispatched chunk's device work and assemble results."""
        with annotate("capfilt.complete"):
            chunk, config, F = d.chunk, d.config, d.num_frm
            with annotate("capfilt.wait"):
                seqs_np = self._host(d, d.seqs_dev, d.seqs_host)
            with annotate("capfilt.detokenize"):
                captions = (None if seqs_np is None
                            else B.decode_captions(self.tok, seqs_np, self.prompt))

            generated_per_video: list[list[str]] = []
            # every video's candidates, which are also its unfiltered text
            candidates_per_video: list[list[str]] = []
            keep_original = config.get("keep_original_caption", False)
            with annotate("capfilt.sentences"):
                for v, item in enumerate(chunk):
                    # the originals' sentences are candidates only when kept
                    # or when nothing was generated
                    if captions is None or keep_original:
                        with annotate("capfilt.split"):
                            orig = original_caption_sentences(
                                item.get("text", []),
                                config.get("do_sentence_tokenization", True))
                    if captions is None:
                        generated_per_video.append([])
                        candidates_per_video.append(orig)
                    else:
                        dedup: list[str] = []
                        for cap in captions[v * F:(v + 1) * F]:
                            if cap not in dedup:
                                dedup.append(cap)
                        generated_per_video.append(dedup)
                        candidates_per_video.append(orig + dedup if keep_original else dedup)

            results = []
            if not config.get("filter", True):
                for v, item in enumerate(chunk):
                    results.append(CapFiltResult(item["video_id"], candidates_per_video[v],
                                                 candidates_per_video[v]))
                return results
            generated_only = config.get("filter_generated_only", False)
            to_filter = generated_per_video if generated_only else candidates_per_video
            with annotate("capfilt.filter_check"):
                if d.itm_probs is not None:
                    filtered = self._fused_filter_results(d, to_filter, captions, seqs_np)
                else:
                    filtered = self.filter_captions_batch(
                        d.frame_embeds, to_filter, config["threshold"],
                        config.get("filter_mode", "max_filter"))
            for v, item in enumerate(chunk):
                if generated_only:
                    # item['text'] keeps the raw original captions when they
                    # were kept (or nothing was generated), else starts empty
                    if captions is None or keep_original:
                        base = list(item.get("text", []))
                    else:
                        base = []
                    text = base + filtered[v]
                else:
                    text = filtered[v]
                results.append(CapFiltResult(item["video_id"], candidates_per_video[v], text))
            return results

    def _fused_filter_results(self, d: ChunkDispatch, to_filter: list[list[str]],
                              captions: list[str], seqs_np: np.ndarray) -> list[list[str]]:
        """Fused-path replacement for filter_captions_batch: each text's
        score is read from the device probs at its first-occurrence frame
        row after verifying that re-tokenizing the decoded caption gives
        exactly the ids the device scored; videos with any unstable row are
        re-scored in one classic call with the same text bucket."""
        config, F = d.config, d.num_frm
        probs = self._host(d, d.itm_probs, d.itm_probs_host)  # (V, T, F)
        mode = config.get("filter_mode", "max_filter")
        threshold = config["threshold"]
        n_real = len(to_filter) if d.n_real is None else min(d.n_real, len(to_filter))
        self.fused_total_videos += n_real

        # the fused rows are bucketed to round_up(F, 4), the classic ones to
        # round_up(max #texts, 4): equal shapes only when the buckets agree
        max_n = max((len(t) for t in to_filter), default=0)
        T_classic = _round_up(max_n, 4)
        if max_n > 0 and T_classic != probs.shape[1]:
            self.fused_fallback_videos += n_real
            with annotate("capfilt.fallback"):
                return self.filter_captions_batch(d.frame_embeds, to_filter, threshold, mode)

        Lf = self.itm_text_len_fused
        dev_ids, _ = itm_ids_from_seqs_np(
            seqs_np, len(self.prompt_ids), self.tok.cls_token_id,
            self.tok.sep_token_id, self.tok.pad_token_id, Lf)
        out: list[list[str] | None] = []
        fallback: list[int] = []
        for v, texts in enumerate(to_filter):
            caps_v = captions[v * F:(v + 1) * F]
            keep: list[str] = []
            ok = True
            if texts:
                enc = self.tok(texts, padding="max_length", truncation=True,
                               max_length=self.itm_max_text_len)
                for t_idx, t in enumerate(texts):
                    f0 = caps_v.index(t) if t in caps_v else -1
                    if (f0 < 0
                            or (enc.input_ids[t_idx][Lf:] != self.tok.pad_token_id).any()
                            or not np.array_equal(enc.input_ids[t_idx][:Lf],
                                                  dev_ids[v * F + f0])):
                        ok = False
                        break
                    row = probs[v, f0]
                    agg = row.max() if mode == "max_filter" else row.sum() / F
                    if agg > threshold:
                        keep.append(t)
            if ok:
                out.append(keep)
            else:
                out.append(None)
                fallback.append(v)
        if fallback:
            self.fused_fallback_videos += sum(1 for v in fallback if v < n_real)
            with annotate("capfilt.fallback"):
                idx = torch.as_tensor(fallback, device=d.frame_embeds.device)
                rescored = self.filter_captions_batch(
                    d.frame_embeds[idx], [to_filter[v] for v in fallback], threshold, mode,
                    text_bucket=T_classic)
            for v, res in zip(fallback, rescored):
                out[v] = res
        return out

    def run_chunk(self, chunk: list[dict], config: dict, rng=None) -> list[CapFiltResult]:
        """Process one chunk of videos (dispatch + complete)."""
        return self.complete_chunk(self.dispatch_chunk(chunk, config, rng))
