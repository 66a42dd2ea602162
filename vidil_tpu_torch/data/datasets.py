"""Caption, VQA and retrieval training/eval datasets and a threaded
prefetch loader: the port's own copy of the trainers' part of
``vidil_tpu/data/datasets.py`` (`RetrievalTrainDataset`,
`RetrievalEvalDataset`, `CaptionTrainDataset`, `CaptionEvalDataset`,
`VideoToCaptionsDataset`, `VQADataset`, `vqa_collate`, `PrefetchLoader`).
Items are numpy arrays, batching is plain stacking, and a thread pool
decodes video ahead of the device.

Corrupt-video tolerance matches the reference: 3 decode retries, then a
random substitute during training (video_pretrain_dataset.py:112-120) or
an error during eval.
"""

from __future__ import annotations

import json
import os
import random
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from vidil_tpu_torch.data.sampling import load_video_frames
from vidil_tpu_torch.data.text_utils import pre_caption, pre_question
from vidil_tpu_torch.data.transforms import TestTransform, TrainTransform


def load_jsonl(path: str) -> list:
    with open(path) as f:
        return [json.loads(l) for l in f]


def _decode(video_path: str, config: dict, num_frm_key: str = "num_frm_train",
            retries: int = 3):
    for _ in range(retries):
        frames = load_video_frames(
            video_path, config["frm_sampling_strategy"], config[num_frm_key],
            height=config.get("height"), width=config.get("width"),
            start_time=config.get("start_time"), end_time=config.get("end_time"),
            fps=config.get("fps", -1),
        )
        if frames is not None:
            return frames
    return None


class RetrievalTrainDataset:
    """(frames, caption, idx) triplets from pseudo-label / gt jsonl
    (reference: data/msrvtt_dataset.py:30-134)."""

    def __init__(self, config: dict, max_words: int = 30, prompt: str = ""):
        self.config = config
        video_fmt = config.get("video_fmt", ".mp4")
        roots = config.get("train_video_root", config.get("video_root"))
        anns = config["train_ann_jsonl"]
        if isinstance(anns, str):
            anns, roots = [anns], [roots]
        self.video_roots = roots
        self.annotation = []
        self.video_id_2_caption = [defaultdict(list) for _ in anns]
        skip_count = 0
        for i, ann_path in enumerate(anns):
            for obj in load_jsonl(ann_path):
                video_id = obj["clip_name"]
                obj["video_root_idx"] = i
                path = os.path.join(roots[i], f"{video_id}{video_fmt}")
                if os.path.exists(path):
                    self.video_id_2_caption[i][video_id].append(obj["caption"])
                    self.annotation.append(obj)
                else:
                    skip_count += 1
        print("training video-text pair number:", len(self.annotation))
        print("skipped non-exist video number:", skip_count)
        self.video_fmt = video_fmt
        self.max_words = max_words
        self.prompt = prompt
        self.transform = TrainTransform(config["image_size"])
        # per-video contrastive idx labels (reference :93-98)
        self.video_id_2_index = [{} for _ in anns]
        n = 0
        for i in range(len(anns)):
            for vid in self.video_id_2_caption[i].keys():
                self.video_id_2_index[i][vid] = n
                n += 1

    def __len__(self):
        return len(self.annotation)

    def __getitem__(self, index):
        ann = self.annotation[index]
        i = ann["video_root_idx"]
        path = os.path.join(self.video_roots[i], f'{ann["clip_name"]}{self.video_fmt}')
        frames = _decode(path, self.config)
        if frames is None:
            sub = random.randint(0, len(self.annotation) - 1)
            print(f"ERROR: cannot load video:{path}; load random instead")
            return self[sub]
        video = np.stack([self.transform(f) for f in frames])
        caption = self.prompt + pre_caption(ann["caption"], self.max_words)
        return video, caption, self.video_id_2_index[i][ann["clip_name"]]


class RetrievalEvalDataset:
    """(frames, index), with .text / .txt2video / .video2txt: one caption
    per video, the identity maps (reference: data/video_eval_dataset.py:35-130)."""

    def __init__(self, video_root: str, ann_jsonl: str, num_frm: int = 8,
                 frm_sampling_strategy: str = "uniform", max_img_size: int = 384,
                 video_fmt: str = ".mp4"):
        original = load_jsonl(ann_jsonl)
        self.annotation = [a for a in original
                           if os.path.exists(os.path.join(video_root, a["clip_name"] + video_fmt))]
        print("original ann len:", len(original), "| skip non-exist:",
              len(original) - len(self.annotation))
        self.config = dict(frm_sampling_strategy=frm_sampling_strategy,
                           num_frm_test=num_frm, height=None, width=None,
                           start_time=None, end_time=None, fps=-1)
        self.video_root = video_root
        self.video_fmt = video_fmt
        self.transform = TestTransform(max_img_size)
        self.text = [pre_caption(a["caption"], 40) for a in self.annotation]
        self.txt2video = list(range(len(self.annotation)))
        self.video2txt = self.txt2video

    def __len__(self):
        return len(self.annotation)

    def __getitem__(self, index):
        ann = self.annotation[index]
        path = os.path.join(self.video_root, ann["clip_name"] + self.video_fmt)
        frames = _decode(path, self.config, num_frm_key="num_frm_test")
        if frames is None:
            raise IOError(f"cannot decode eval video {path}")
        return np.stack([self.transform(f) for f in frames]), index


class CaptionTrainDataset(RetrievalTrainDataset):
    """Same jsonl format; returns (frames, prompt+caption)
    (reference: caption_* branches of data/__init__.py:76-95)."""

    def __getitem__(self, index):
        video, caption, _ = super().__getitem__(index)
        return video, caption


class CaptionEvalDataset:
    """(frames, video_id); groups multi-reference gt by clip_name
    (reference: data/video_eval_dataset.py:133-230)."""

    def __init__(self, video_root: str, ann_jsonl: str, num_frm: int = 8,
                 frm_sampling_strategy: str = "uniform", max_img_size: int = 384,
                 video_fmt: str = ".mp4"):
        lines = load_jsonl(ann_jsonl)
        self.gt = defaultdict(list)
        for line in lines:
            self.gt[line["clip_name"]].append(line["caption"])
        self.video_ids = [v for v in self.gt.keys()
                          if os.path.exists(os.path.join(video_root, v + video_fmt))]
        self.config = dict(frm_sampling_strategy=frm_sampling_strategy,
                           num_frm_test=num_frm, height=None, width=None,
                           start_time=None, end_time=None, fps=-1)
        self.video_root = video_root
        self.video_fmt = video_fmt
        self.transform = TestTransform(max_img_size)

    def __len__(self):
        return len(self.video_ids)

    def __getitem__(self, index):
        vid = self.video_ids[index]
        frames = _decode(os.path.join(self.video_root, vid + self.video_fmt),
                         self.config, num_frm_key="num_frm_test")
        if frames is None:
            raise IOError(f"cannot decode eval video {vid}")
        return np.stack([self.transform(f) for f in frames]), vid


class VideoToCaptionsDataset:
    """(frames, [captions]) items from videoid-keyed ann jsons (reference:
    data/video_pretrain_dataset.py:219-378 pretrain_video_to_captions_dataset
    and :379+ visual_tokenization_dataset share this shape). Also exposes
    the raw .annotation list like the reference."""

    def __init__(self, config: dict, max_words: int = 64, train: bool = False):
        self.config = config
        ann_jsons = config["train_ann_jsons"]
        roots = config["video_roots"]
        fmts = config["video_formats"]
        if isinstance(ann_jsons, str):
            ann_jsons, roots, fmts = [ann_jsons], [roots], [fmts]
        annotation: dict = {}
        skipped = 0
        for ann_path, root, fmt in zip(ann_jsons, roots, fmts):
            with open(ann_path) as f:
                ann = json.load(f)
            items = ann.items() if isinstance(ann, dict) else (
                (o["video_id"], o["texts"]) for o in ann)
            for vid, texts in items:
                path = os.path.join(root, f"{vid}.{fmt}")
                if not os.path.exists(path):
                    print(f"ERROR: video file not found, skipped:{path}")
                    skipped += 1
                    continue
                if vid in annotation:
                    annotation[vid]["caption"] += list(texts)
                else:
                    annotation[vid] = {"video": path, "caption": list(texts)}
        self.annotation = list(annotation.values())
        print("num of video skipped:", skipped)
        print("num of video considering:", len(self.annotation))
        size = config["image_size"]
        self.transform = TrainTransform(size) if train else TestTransform(size)
        self.max_words = max_words
        self.train = train

    def __len__(self):
        return len(self.annotation)

    def __getitem__(self, index):
        ann = self.annotation[index]
        frames = _decode(ann["video"], self.config)
        if frames is None:
            if self.train:
                return self[random.randint(0, len(self.annotation) - 1)]
            return None, None  # reference: visual_tokenization_dataset :466-467
        video = np.stack([self.transform(f) for f in frames])
        return video, ann["caption"]


class VQADataset:
    """MSRVTT/MSVD-QA (reference: data/vqa_dataset.py:88-211).

    train: (frames, question, [answer], [0.2]); test: (frames, question,
    question_id).
    """

    def __init__(self, config: dict, split: str = "train"):
        self.split = split
        self.config = config
        ann_key = f"{split}_ann_jsonl" if f"{split}_ann_jsonl" in config else "train_ann_jsonl"
        self.annotation = load_jsonl(config[ann_key])
        for i, a in enumerate(self.annotation):
            a.setdefault("question_id", i)
        self.video_root = config["video_root"]
        self.video_fmt = config.get("video_fmt", ".mp4")
        if split == "train":
            self.transform = TrainTransform(config["image_size"])
            self.num_frm_key = "num_frm_train"
        else:
            self.transform = TestTransform(config["image_size"])
            self.num_frm_key = "num_frm_test"

    def __len__(self):
        return len(self.annotation)

    def __getitem__(self, index):
        ann = self.annotation[index]
        path = os.path.join(self.video_root, ann["video_id"] + self.video_fmt)
        frames = _decode(path, self.config, num_frm_key=self.num_frm_key)
        if frames is None:
            if self.split == "train":
                return self[random.randint(0, len(self.annotation) - 1)]
            raise IOError(f"cannot decode eval video {path}")
        video = np.stack([self.transform(f) for f in frames])
        question = pre_question(ann["question"])
        if self.split == "train":
            answers = [ann["answer"]]
            weights = [0.2]  # reference: data/vqa_dataset.py:147-152
            return video, question, answers, weights
        return video, question, ann["question_id"]


def vqa_collate(batch):
    """Flatten ragged answers with per-question counts
    (reference: data/vqa_dataset.py:214)."""
    videos, questions, answer_lists, weight_lists, n = [], [], [], [], []
    for video, question, answers, weights in batch:
        videos.append(video)
        questions.append(question)
        answer_lists += answers
        weight_lists += weights
        n.append(len(answers))
    return np.stack(videos), questions, answer_lists, np.asarray(weight_lists, np.float32), n


class PrefetchLoader:
    """Threaded batch loader: decodes/transforms items ahead of compute.

    Over several ranks: ``rank_rows=(rank, world)`` yields this rank's
    rows of each global batch of `batch_size` (`parallel.mesh.local_rows`;
    every rank draws the same shuffle, and drops the last partial batch, so
    every rank takes as many steps); ``item_range=(start, end)`` loads only
    those items, in order (a rank's eval shard)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 num_workers: int = 8, collate_fn=None, drop_last: bool = False,
                 seed: int = 42, rank_rows: tuple[int, int] | None = None,
                 item_range: tuple[int, int] | None = None):
        if rank_rows is not None:
            from vidil_tpu_torch.parallel.mesh import local_rows

            assert drop_last, "a rank's rows of the global batches need drop_last"
            rank_rows = local_rows(batch_size, *rank_rows)
        self.rank_rows = rank_rows
        self.item_range = item_range
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = num_workers
        self.collate_fn = collate_fn or self._default_collate
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0

    @staticmethod
    def _default_collate(items):
        cols = list(zip(*items))
        out = []
        for col in cols:
            if isinstance(col[0], np.ndarray):
                out.append(np.stack(col))
            elif isinstance(col[0], (int, np.integer)):
                out.append(np.asarray(col))
            else:
                out.append(list(col))
        return tuple(out)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _items(self):
        if self.item_range is None:
            return list(range(len(self.dataset)))
        return list(range(*self.item_range))

    def __len__(self):
        n = len(self._items())
        return n // self.batch_size if self.drop_last else (n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        order = self._items()
        if self.shuffle:
            random.Random(self.seed + self.epoch).shuffle(order)
        batches = [order[i : i + self.batch_size] for i in range(0, len(order), self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]
        if self.rank_rows is not None:
            batches = [b[self.rank_rows] for b in batches]
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            pending = []
            it = iter(batches)
            # keep 2 batches in flight
            for _ in range(2):
                b = next(it, None)
                if b is not None:
                    pending.append(pool.map(self.dataset.__getitem__, b))
            while pending:
                batch_items = list(pending.pop(0))
                b = next(it, None)
                if b is not None:
                    pending.append(pool.map(self.dataset.__getitem__, b))
                yield self.collate_fn(batch_items)
