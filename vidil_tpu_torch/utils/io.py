"""Host JSON I/O and the per-rank shard -> rank-0 merge contract: the port's
own copy of ``vidil_tpu/utils/io.py``. Each rank takes a contiguous slice
of the work list, writes ``tmp/{rank}*.json``, barriers, and rank 0 merges
(the reference's arithmetic and file layout, so downstream tooling is
unchanged and the merged files do not depend on the number of ranks)."""

from __future__ import annotations

import json
import os
import shutil

from vidil_tpu_torch.utils.dist import barrier, get_rank, get_world_size, is_main_process


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def save_json(path: str, obj, indent: int | None = 4) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=indent)


def shard_range(n_items: int, rank: int | None = None, world_size: int | None = None):
    """Contiguous per-rank slice: ``step = len//world + 1``,
    ``start = rank*step``, ``end = min(len, start+step)``."""
    rank = get_rank() if rank is None else rank
    world_size = get_world_size() if world_size is None else world_size
    step = n_items // world_size + 1
    start = rank * step
    end = min(n_items, start + step)
    return start, end


def merge_rank_jsons(tmp_dir: str, out_path: str, suffix: str = ".json", cleanup: bool = False):
    """Barrier, then rank 0 merges the dicts of ``tmp_dir/{rank}{suffix}``
    in rank order into ``out_path`` (indent 4) and returns the merged dict;
    the other ranks return None. ``cleanup`` removes `tmp_dir` after."""
    barrier()
    if not is_main_process():
        return None
    merged: dict = {}
    for r in range(get_world_size()):
        merged.update(load_json(os.path.join(tmp_dir, f"{r}{suffix}")))
    save_json(out_path, merged)
    if cleanup:
        shutil.rmtree(tmp_dir)
    return merged
