"""Frame-sampling strategies, bit-for-bit with the reference.

Replicates every strategy in the reference (run_video_CapFilt.py:47-91,
data/video_pretrain_dataset.py:131-216) including its integer-truncation
semantics (``np.arange(start, end, vlen/num_frm, dtype=int)``) and its use
of the *host* ``random`` module (seeded with seed+rank), which is
load-bearing for reproducing headtail/rand selections.
"""

from __future__ import annotations

import random

import numpy as np

from vidil_tpu_torch.data.video_reader import VideoReader


def sample_frame_indices(
    vlen: int,
    num_frm: int,
    strategy: str,
    start_idx: int = 0,
    end_idx: int | None = None,
    clip_selector=None,
):
    """Return the frame indices for one video.

    clip_selector: callable(vlen, num_frm) -> indices, used for
    'clip-kmeans' (CLIP-embedding KMeans selection; see
    vidil_tpu_torch.pipeline.visual_tokenization.make_clip_kmeans_selector).
    """
    end_idx = vlen if end_idx is None else end_idx
    if strategy == "uniform":
        return np.arange(start_idx, end_idx, vlen / num_frm, dtype=int)
    if strategy == "nlvl_uniform":
        return np.arange(start_idx, end_idx, vlen / num_frm).astype(int)
    if strategy == "nlvl_rand":
        idx = np.arange(start_idx, end_idx, vlen / num_frm).astype(int)
        strides = [idx[i] - idx[i - 1] for i in range(1, len(idx))] + [vlen - idx[-1]]
        perturb = np.array([np.random.randint(0, s) for s in strides])
        return idx + perturb
    if strategy == "rand":
        return np.array(sorted(random.sample(range(vlen), num_frm)))
    if strategy == "headtail":
        head = sorted(random.sample(range(vlen // 2), num_frm // 2))
        tail = sorted(random.sample(range(vlen // 2, vlen), num_frm // 2))
        return np.array(head + tail)
    if strategy == "clip-kmeans":
        assert clip_selector is not None, "clip-kmeans needs a CLIP selector"
        return np.asarray(clip_selector(vlen, num_frm))
    raise NotImplementedError(f"Invalid sampling strategy {strategy} ")


def load_video_frames(
    video_path: str,
    strategy: str,
    num_frm: int,
    height: int | None = None,
    width: int | None = None,
    start_time=None,
    end_time=None,
    fps: float = -1,
    clip_selector=None,
):
    """Decode sampled frames; None on failure (the reference's corrupt-video
    tolerance: run_video_CapFilt.py:88-91 returns None and the caller skips).

    Returns (num_frm, H, W, C) RGB uint8 or None.
    """
    try:
        if not height or not width:
            vr = VideoReader(video_path)
        else:
            vr = VideoReader(video_path, width=width, height=height)
        vlen = len(vr)
        if start_time or end_time:
            assert fps > 0, "must provide video fps if specifying start and end time."
            start_idx = min(int(start_time * fps), vlen)
            end_idx = min(int(end_time * fps), vlen)
        else:
            start_idx, end_idx = 0, vlen
        if strategy == "clip-kmeans" and clip_selector is not None:
            indices = clip_selector(vr, num_frm)
        else:
            indices = sample_frame_indices(vlen, num_frm, strategy, start_idx, end_idx)
        return vr.get_batch(indices)
    except Exception as e:  # noqa: BLE001 — mirror the reference's skip-on-error
        print(e)
        return None
