"""Dataset factory: the reference's create_dataset / create_sampler /
create_loader API (reference: data/__init__.py:23-141), the port's own copy
of ``vidil_tpu/data/factory.py``.

The sampler role (DistributedSampler) is absorbed by PrefetchLoader's
seeded shuffle and the rank's `shard_range`; create_sampler returns each
rank's shard bounds for API parity.
"""

from __future__ import annotations

from vidil_tpu_torch.data.datasets import (
    CaptionEvalDataset,
    CaptionTrainDataset,
    PrefetchLoader,
    RetrievalEvalDataset,
    RetrievalTrainDataset,
    VQADataset,
    vqa_collate,
)
from vidil_tpu_torch.utils.io import shard_range


def create_dataset(dataset: str, config: dict):
    """Dispatch on the reference dataset names (reference: data/__init__.py:45-103)."""
    if dataset == "pretrain_video":
        return RetrievalTrainDataset(dict(config), max_words=config.get("max_words", 30))

    if dataset.startswith("retrieval_"):
        train = RetrievalTrainDataset(dict(config))
        eval_root = config.get("eval_video_root", config.get("video_root"))
        val, test = (RetrievalEvalDataset(eval_root, config[key], num_frm=config["num_frm_test"],
                                          frm_sampling_strategy="uniform",
                                          max_img_size=config["image_size"])
                     for key in ("val_ann_jsonl", "test_ann_jsonl"))
        return train, val, test

    if dataset.startswith("caption_"):
        train = CaptionTrainDataset(dict(config), prompt=config.get("prompt", ""))
        val, test = (CaptionEvalDataset(config["video_root"], config[key],
                                        num_frm=config["num_frm_test"],
                                        frm_sampling_strategy=config["frm_sampling_strategy"],
                                        max_img_size=config["image_size"])
                     for key in ("val_ann_jsonl", "test_ann_jsonl"))
        return train, val, test

    if dataset.startswith("vqa_"):
        return VQADataset(config, split="train"), VQADataset(config, split="test")

    raise NotImplementedError(f"unknown dataset {dataset}")


def create_sampler(datasets, shuffles, num_tasks: int, global_rank: int):
    """Each rank's contiguous shard bounds (DistributedSampler analogue)."""
    return [shard_range(len(d), rank=global_rank, world_size=num_tasks) for d in datasets]


def create_loader(datasets, samplers, batch_size, num_workers, is_trains, collate_fns,
                  seed: int = 42):
    """reference: data/__init__.py:120-141."""
    loaders = []
    for dataset, bs, n_worker, is_train, collate_fn in zip(
        datasets, batch_size, num_workers, is_trains, collate_fns
    ):
        if collate_fn == "vqa":
            collate_fn = vqa_collate
        loaders.append(PrefetchLoader(dataset, bs, shuffle=is_train,
                                      num_workers=n_worker, collate_fn=collate_fn,
                                      drop_last=is_train, seed=seed))
    return loaders
