"""Image-domain datasets kept from upstream BLIP (vestigial in VidIL;
reference: data/{coco_karpathy,flickr30k,nocaps,nlvr,pretrain,vqa}_dataset.py):
the port's own copy of ``vidil_tpu/data/image_datasets.py``.

Minimal numpy/PIL equivalents so image-side BLIP training/eval runs in
the port too. Items are (image float32 HWC, text, ...) tuples. PIL is
imported when an image is read.
"""

from __future__ import annotations

import json
import os
import random

import numpy as np

from vidil_tpu_torch.data.text_utils import pre_caption, pre_question
from vidil_tpu_torch.data.transforms import TestTransform, TrainTransform


def _load_image(path: str) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"))


class CocoKarpathyTrain:
    """(image, caption, img_idx) (reference: data/coco_karpathy_dataset.py)."""

    def __init__(self, ann_json: str, image_root: str, image_size: int,
                 max_words: int = 30, prompt: str = ""):
        self.annotation = json.load(open(ann_json))
        self.image_root = image_root
        self.transform = TrainTransform(image_size)
        self.max_words = max_words
        self.prompt = prompt
        self.img_ids = {}
        n = 0
        for ann in self.annotation:
            if ann["image_id"] not in self.img_ids:
                self.img_ids[ann["image_id"]] = n
                n += 1

    def __len__(self):
        return len(self.annotation)

    def __getitem__(self, index):
        ann = self.annotation[index]
        image = self.transform(_load_image(os.path.join(self.image_root, ann["image"])))
        caption = self.prompt + pre_caption(ann["caption"], self.max_words)
        return image, caption, self.img_ids[ann["image_id"]]


class ImageCaptionEval:
    """(image, image_id) for COCO/NoCaps-style eval ann
    (reference: coco_karpathy_dataset.py eval classes, nocaps_dataset.py)."""

    def __init__(self, ann_json: str, image_root: str, image_size: int):
        self.annotation = json.load(open(ann_json))
        self.image_root = image_root
        self.transform = TestTransform(image_size)

    def __len__(self):
        return len(self.annotation)

    def __getitem__(self, index):
        ann = self.annotation[index]
        image = self.transform(_load_image(os.path.join(self.image_root, ann["image"])))
        img_id = ann.get("img_id")
        if img_id is None:
            img_id = int(ann["image"].split("/")[-1].strip(".jpg").split("_")[-1])
        return image, img_id


class Flickr30kRetrieval:
    """Eval retrieval over flickr-style ann (reference: flickr30k_dataset.py):
    exposes .text / .txt2img / .img2txt maps."""

    def __init__(self, ann_json: str, image_root: str, image_size: int, max_words: int = 30):
        self.annotation = json.load(open(ann_json))
        self.image_root = image_root
        self.transform = TestTransform(image_size)
        self.text = []
        self.image = []
        self.txt2img = {}
        self.img2txt = {}
        txt_id = 0
        for img_id, ann in enumerate(self.annotation):
            self.image.append(ann["image"])
            self.img2txt[img_id] = []
            for caption in ann["caption"]:
                self.text.append(pre_caption(caption, max_words))
                self.img2txt[img_id].append(txt_id)
                self.txt2img[txt_id] = img_id
                txt_id += 1

    def __len__(self):
        return len(self.annotation)

    def __getitem__(self, index):
        image = self.transform(_load_image(os.path.join(self.image_root, self.image[index])))
        return image, index


class NLVRDataset:
    """(image0, image1, sentence, label) pairs (reference: nlvr_dataset.py)."""

    LABELS = {"True": 1, "False": 0}

    def __init__(self, ann_json: str, image_root: str, image_size: int, train: bool = True):
        self.annotation = json.load(open(ann_json))
        self.image_root = image_root
        self.transform = TrainTransform(image_size) if train else TestTransform(image_size)

    def __len__(self):
        return len(self.annotation)

    def __getitem__(self, index):
        ann = self.annotation[index]
        image0 = self.transform(_load_image(os.path.join(self.image_root, ann["images"][0])))
        image1 = self.transform(_load_image(os.path.join(self.image_root, ann["images"][1])))
        sentence = pre_caption(ann["sentence"], 40)
        return image0, image1, sentence, self.LABELS[ann["label"]]


class CocoVQADataset:
    """COCO-VQA (reference: data/vqa_dataset.py:21-85): train items
    (image, question, answers, weights) with answer-frequency weights."""

    def __init__(self, ann_json: str, image_root: str, image_size: int,
                 split: str = "train", answer_list_json: str | None = None):
        self.annotation = json.load(open(ann_json))
        self.image_root = image_root
        self.split = split
        self.transform = TrainTransform(image_size) if split == "train" else TestTransform(image_size)
        if answer_list_json:
            self.answer_list = json.load(open(answer_list_json))

    def __len__(self):
        return len(self.annotation)

    def __getitem__(self, index):
        ann = self.annotation[index]
        image = self.transform(_load_image(os.path.join(self.image_root, ann["image"])))
        if self.split == "test":
            return image, pre_question(ann["question"]), ann["question_id"]
        if "answers" in ann:
            counts = {}
            for a in ann["answers"]:
                counts[a] = counts.get(a, 0) + 1
            answers = list(counts.keys())
            weights = [c / len(ann["answers"]) for c in counts.values()]
        else:
            answers, weights = [ann["answer"]], [0.2]
        return image, pre_question(ann["question"]), answers, weights


class ImagePretrainDataset:
    """Web-scale (image, caption) pairs from ann file lists
    (reference: data/pretrain_dataset.py)."""

    def __init__(self, ann_files: list[str], image_size: int, max_words: int = 30):
        self.annotation = []
        for f in ann_files:
            self.annotation += json.load(open(f))
        self.transform = TrainTransform(image_size)
        self.max_words = max_words

    def __len__(self):
        return len(self.annotation)

    def __getitem__(self, index):
        ann = self.annotation[index]
        caption = ann["caption"]
        if isinstance(caption, list):
            caption = random.choice(caption)
        image = self.transform(_load_image(ann["image"]))
        return image, pre_caption(caption, self.max_words)
