"""Host-side training/eval frame transforms.

Equivalent of the reference training pipeline (reference:
data/__init__.py:25-43): RandomResizedCrop(bicubic, scale 0.5-1.0) +
RandomHorizontalFlip + RandAugment(2, 5, [Identity, AutoContrast,
Brightness, Sharpness, Equalize, ShearX, ShearY, TranslateX, TranslateY,
Rotate]) + CLIP-normalize; test = bicubic resize + normalize. Augment ops
use PIL with the reference's magnitude mappings (transform/randaugment.py:
MAX_LEVEL=10, translate_const=10, replace (128,128,128)).

The port's own copy of ``vidil_tpu/data/transforms.py``; PIL is imported
when a transform runs, not when the module is imported.
"""

from __future__ import annotations

import random

import numpy as np

from vidil_tpu_torch.ops.image import CLIP_MEAN, CLIP_STD

MAX_LEVEL = 10
TRANSLATE_CONST = 10
REPLACE = (128, 128, 128)


def _pil():
    """PIL's Image, ImageEnhance and ImageOps, imported on first use."""
    from PIL import Image, ImageEnhance, ImageOps

    return Image, ImageEnhance, ImageOps


def _enhance_factor(level: float) -> float:
    return (level / MAX_LEVEL) * 1.8 + 0.1


def _signed(level: float, scale: float) -> float:
    v = (level / MAX_LEVEL) * scale
    return -v if np.random.random() < 0.5 else v


def _affine(img, coeffs):
    Image, _, _ = _pil()
    return img.transform(img.size, Image.AFFINE, coeffs, resample=Image.BILINEAR,
                         fillcolor=REPLACE)


def _posterize(img, bits: int):
    """reference transform/randaugment.py:179-184,251-256.

    The reference masks with np.uint8(255 << (8 - bits)), which on its
    era's wrapping numpy equals PIL's posterize mask for bits 1-4 and
    wraps to 0 at bits == 0 — i.e. level < 2.5 BLACKS OUT the image
    (on numpy >= 2 the same expression raises OverflowError, so the
    reference op cannot run at all there). We reproduce the legacy-wrap
    semantics exactly (tests/test_randaugment_reference_oracle.py)."""
    Image, _, ImageOps = _pil()
    if bits == 0:
        return Image.new(img.mode, img.size, 0)
    return ImageOps.posterize(img, bits)


def _cutout(img, pad_size: int, replace=(0, 0, 0)):
    """Random square patch replaced with a constant (reference:
    transform/randaugment.py:194-205 — center uniform over the image,
    box clipped at the borders, half-pad on each side)."""
    arr = np.array(img)
    H, W = arr.shape[0], arr.shape[1]
    rh, rw = np.random.random(2)
    pad = pad_size // 2
    ch, cw = int(rh * H), int(rw * W)
    x1, x2 = max(ch - pad, 0), min(ch + pad, H)
    y1, y2 = max(cw - pad, 0), min(cw + pad, W)
    arr[x1:x2, y1:y2] = np.array(replace, dtype=arr.dtype)
    return _pil()[0].fromarray(arr)


AUG_OPS = {
    "Identity": lambda img, level: img,
    "AutoContrast": lambda img, level: _pil()[2].autocontrast(img),
    "Equalize": lambda img, level: _pil()[2].equalize(img),
    "Rotate": lambda img, level: img.rotate(_signed(level, 30), resample=_pil()[0].BILINEAR,
                                            fillcolor=REPLACE),
    "Solarize": lambda img, level: _pil()[2].solarize(img, int((level / MAX_LEVEL) * 256)),
    "Color": lambda img, level: _pil()[1].Color(img).enhance(_enhance_factor(level)),
    "Contrast": lambda img, level: _pil()[1].Contrast(img).enhance(_enhance_factor(level)),
    "Brightness": lambda img, level: _pil()[1].Brightness(img).enhance(_enhance_factor(level)),
    "Sharpness": lambda img, level: _pil()[1].Sharpness(img).enhance(_enhance_factor(level)),
    "ShearX": lambda img, level: _affine(img, (1, _signed(level, 0.3), 0, 0, 1, 0)),
    "ShearY": lambda img, level: _affine(img, (1, 0, 0, _signed(level, 0.3), 1, 0)),
    "TranslateX": lambda img, level: _affine(img, (1, 0, _signed(level, TRANSLATE_CONST), 0, 1, 0)),
    "TranslateY": lambda img, level: _affine(img, (1, 0, 0, 0, 1, _signed(level, TRANSLATE_CONST))),
    "Posterize": lambda img, level: _posterize(img, int((level / MAX_LEVEL) * 4)),
    # Available but not in any policy, mirroring the reference:
    # cutout_func/cutout_level_to_args exist outside its dispatch dict
    # (reference: transform/randaugment.py:194-205,232-238; cutout_const=10
    # matches translate_const's treatment of level); Invert is the upstream
    # RandAugment op the reference's vintage dropped.
    "Invert": lambda img, level: _pil()[2].invert(img),
    "Cutout": lambda img, level: _cutout(img, int((level / MAX_LEVEL) * TRANSLATE_CONST)),
}

DEFAULT_TRAIN_AUGS = ["Identity", "AutoContrast", "Brightness", "Sharpness", "Equalize",
                      "ShearX", "ShearY", "TranslateX", "TranslateY", "Rotate"]

# the reference's full dispatch pool (transform/randaugment.py arg_dict:
# 14 ops; Invert/Cutout are NOT in it and must not enter the default pool)
REFERENCE_OP_POOL = [n for n in AUG_OPS if n not in ("Invert", "Cutout")]


class RandomAugment:
    """N random ops at magnitude M, each applied with prob 0.5
    (reference: transform/randaugment.py:311-332)."""

    def __init__(self, N: int = 2, M: int = 10, augs=None):
        self.N = N
        self.M = M
        self.augs = augs or REFERENCE_OP_POOL

    def __call__(self, img):
        for name in np.random.choice(self.augs, self.N):
            if np.random.random() > 0.5:
                continue
            img = AUG_OPS[name](img, self.M)
        return img


def random_resized_crop(img, size: int, min_scale: float = 0.5):
    """torchvision RandomResizedCrop semantics: random area in
    [min_scale, 1.0], aspect in [3/4, 4/3], bicubic resize to size."""
    Image, _, _ = _pil()
    w, h = img.size
    area = w * h
    for _ in range(10):
        target_area = area * random.uniform(min_scale, 1.0)
        ar = np.exp(random.uniform(np.log(3 / 4), np.log(4 / 3)))
        cw = int(round(np.sqrt(target_area * ar)))
        ch = int(round(np.sqrt(target_area / ar)))
        if 0 < cw <= w and 0 < ch <= h:
            x = random.randint(0, w - cw)
            y = random.randint(0, h - ch)
            return img.crop((x, y, x + cw, y + ch)).resize((size, size), Image.BICUBIC)
    # fallback: center crop
    s = min(w, h)
    x, y = (w - s) // 2, (h - s) // 2
    return img.crop((x, y, x + s, y + s)).resize((size, size), Image.BICUBIC)


def normalize_u8(arr_u8: np.ndarray) -> np.ndarray:
    mean = np.asarray(CLIP_MEAN, np.float32)
    std = np.asarray(CLIP_STD, np.float32)
    return ((arr_u8.astype(np.float32) / 255.0) - mean) / std


class TrainTransform:
    """Per-frame train transform -> normalized float32 HWC."""

    def __init__(self, image_size: int, min_scale: float = 0.5,
                 augs=DEFAULT_TRAIN_AUGS, rand_n: int = 2, rand_m: int = 5):
        self.image_size = image_size
        self.min_scale = min_scale
        self.randaug = RandomAugment(rand_n, rand_m, augs)

    def __call__(self, frame_u8: np.ndarray) -> np.ndarray:
        Image, _, _ = _pil()
        img = Image.fromarray(frame_u8)
        img = random_resized_crop(img, self.image_size, self.min_scale)
        if random.random() < 0.5:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
        img = self.randaug(img)
        return normalize_u8(np.asarray(img))


class TestTransform:
    def __init__(self, image_size: int):
        self.image_size = image_size

    def __call__(self, frame_u8: np.ndarray) -> np.ndarray:
        Image, _, _ = _pil()
        img = Image.fromarray(frame_u8).resize((self.image_size, self.image_size), Image.BICUBIC)
        return normalize_u8(np.asarray(img))
