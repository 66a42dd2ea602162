"""Frame ingest on the device: RGB uint8 or YUV420 planes -> CLIP-normalized
float32 NHWC.

Counterpart of ``vidil_tpu/ops/image.py``. Frames arrive at `image_size`
(the host did the PIL bicubic resize, the reference's byte-parity path)
or at their native size (``resize_on_device``): then a bicubic resize
with uint8 rounding runs on the device, the JAX package's
``jax.image.resize(method="bicubic", antialias=True)``.

That resize is not ``F.interpolate(mode="bicubic")``: it uses the Keys
kernel with a = -0.5 (torch: a = -0.75 with clamped edge taps), stretches
the kernel by the scale on a downscale (the antialias), normalises each
output's weights over the in-range taps and zeroes an output whose sample
point falls outside the input. `resize_weights` builds that dense (in,
out) matrix per axis, in JAX's fp32 arithmetic; the resize is two fp32
products (TF32 is off, see the package's ``__init__``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# CLIP normalization stats used by every BLIP pipeline in the reference
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def _keys_cubic(x):
    """Keys' cubic convolution kernel, a = -0.5, at x >= 0 (JAX's
    `_fill_keys_cubic_kernel`, operation for operation)."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def resize_weights(in_size: int, out_size: int, device=None):
    """(in_size, out_size) fp32 weights of an antialiased bicubic resize
    along one axis: `jax._src.image.scale.compute_weight_mat` with the
    Keys kernel, scale out/in and no translation. Built on `device` (no
    host-to-device copy, which would wait for the device's queued work)."""
    f32 = dict(dtype=torch.float32, device=device)
    inv_scale = torch.full((), in_size / out_size, **f32)
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample_f = (torch.arange(out_size, **f32) + 0.5) * inv_scale - 0.5
    x = (sample_f[None, :] - torch.arange(in_size, **f32)[:, None]).abs()
    weights = _keys_cubic(x / kernel_scale)
    total = weights.sum(dim=0, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    weights = torch.where(total.abs() > eps,
                          weights / torch.where(total != 0, total, torch.ones_like(total)),
                          torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights))


def resize_bicubic(x, size: int):
    """float (B, H, W, C) -> float32 (B, size, size, C): the antialiased
    bicubic resize, rows then columns, each a dense fp32 product (an axis
    already at `size` is left as it is, as in jax.image.resize)."""
    x = x.float()
    B, H, W, C = x.shape
    if H != size:
        x = torch.einsum("bhwc,hs->bswc", x, resize_weights(H, size, x.device))
    if W != size:
        x = torch.einsum("bhwc,ws->bhsc", x, resize_weights(W, size, x.device))
    return x


def resize_bicubic_uint8(frames, size: int):
    """(B, H, W, C) uint8 -> (B, size, size, C) uint8-quantized float32:
    the bicubic resize, then round half to even and clamp to [0, 255]
    (PIL's resize semantics: float filtering, then uint8 rounding)."""
    return torch.clamp(torch.round(resize_bicubic(frames, size)), 0, 255)


def normalize(frames01, mean=CLIP_MEAN, std=CLIP_STD):
    """(..., C) in [0, 1] -> CLIP-normalized."""
    mean = torch.as_tensor(mean, dtype=torch.float32, device=frames01.device)
    std = torch.as_tensor(std, dtype=torch.float32, device=frames01.device)
    return (frames01 - mean) / std


def preprocess_frames(frames, image_size: int, mean=CLIP_MEAN, std=CLIP_STD):
    """uint8 (B, H, W, C) -> normalized float32 (B, S, S, C)."""
    return normalize(resize_bicubic_uint8(frames, image_size) / 255.0, mean, std)


def preprocess_video_batch(videos, image_size: int, mean=CLIP_MEAN, std=CLIP_STD):
    """uint8 (B, N, H, W, C) -> normalized (B, N, S, S, C)."""
    B, N = videos.shape[:2]
    out = preprocess_frames(videos.reshape((B * N,) + tuple(videos.shape[2:])), image_size,
                            mean, std)
    return out.reshape((B, N) + tuple(out.shape[1:]))


class YUV420Frames(NamedTuple):
    """Planar full-range BT.601 frames: y (F, H, W), u/v (F, H/2, W/2), uint8
    (numpy arrays on the host, tensors on the device)."""

    y: object
    u: object
    v: object

    @property
    def num_frames(self) -> int:
        return self.y.shape[0]


def yuv420_to_rgb(y, u, v):
    """uint8 planes (F, H, W) + 2x(F, H/2, W/2) -> float32 RGB (F, H, W, 3)
    in [0, 255]. Full-range BT.601; chroma upsampled by 2x2 replication."""
    yf = y.float()

    def up(c):
        return c.float().repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)

    d = up(u) - 128.0
    e = up(v) - 128.0
    r = yf + 1.402 * e
    g = yf - 0.344136 * d - 0.714136 * e
    b = yf + 1.772 * d
    return torch.stack([r, g, b], dim=-1).clamp(0.0, 255.0)


def preprocess_any(frames, image_size: int, mean=CLIP_MEAN, std=CLIP_STD):
    """uint8 RGB (B, H, W, 3) or YUV420Frames planes -> CLIP-normalized
    float32 (B, S, S, 3), with S = image_size. Frames at another size than
    S (``resize_on_device``) are converted to RGB at their native size
    first, then resized with uint8 rounding."""
    if isinstance(frames, YUV420Frames):
        x = yuv420_to_rgb(*frames)
    else:
        x = frames.float()
    if tuple(x.shape[1:3]) != (image_size, image_size):
        x = torch.clamp(torch.round(resize_bicubic(x, image_size)), 0.0, 255.0)
    return normalize(x / 255.0, mean, std)


def rgb_to_yuv420(frames_u8: np.ndarray) -> YUV420Frames:
    """Host-side uint8 RGB (F, H, W, 3) -> full-range BT.601 I420 planes
    (numpy). Chroma is 2x2 box-averaged. H and W must be even."""
    f = frames_u8.astype(np.float32)
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    u = -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0
    v = 0.5 * r - 0.418688 * g - 0.081312 * b + 128.0
    sub = lambda c: (c[:, 0::2, 0::2] + c[:, 1::2, 0::2] + c[:, 0::2, 1::2] + c[:, 1::2, 1::2]) * 0.25
    to_u8 = lambda c: np.clip(np.round(c), 0, 255).astype(np.uint8)
    return YUV420Frames(to_u8(y), to_u8(sub(u)), to_u8(sub(v)))
