"""The port as a package: it imports neither JAX nor any module of
vidil_tpu, and its own copies of the host modules (tokenizer, sentence
splitter, frame sampling, rank sharding) behave as the JAX package's do.
"""

import json
import os
import pkgutil
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

import vidil_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(1)


def _port_modules():
    names = ["vidil_tpu_torch"]
    for info in pkgutil.walk_packages(vidil_tpu_torch.__path__, "vidil_tpu_torch."):
        names.append(info.name)
    return names


def test_port_imports_no_jax_and_no_vidil_tpu():
    mods = _port_modules()
    assert "vidil_tpu_torch.run_video_CapFilt" in mods and len(mods) > 30
    for name in ("train_caption_video", "train.caption", "train.common", "utils.checkpoint",
                 "utils.logging", "utils.schedules", "data.datasets", "data.transforms",
                 "data.text_utils", "evals.caption", "evals.caption_metrics",
                 "run_visual_tokenization", "pipeline.visual_tokenization", "models.clip",
                 "ops.fused_mlp", "models.mpnet", "pipeline.prompts", "pipeline.generate_prompts",
                 "pipeline.gpt3", "evals.qa", "evals.vlep", "generate_prompts_fixed_prefix",
                 "generate_prompts_random_prefix",
                 "generate_prompts_random_prefix_in_context_selection",
                 "generate_prompts_random_prefix_vlep_multichoice",
                 "utils_gpt3.process_gpt3_response", "utils_gpt3.gpt3_response_to_jsonl",
                 "eval_video_qa_result", "eval_vlep", "eval_video_captioning_results",
                 "models.blip_retrieval", "models.blip_pretrain", "evals.retrieval",
                 "train.retrieval", "train.pretrain", "train.frame_selection",
                 "train_retrieval_video", "eval_retrieval_video", "pretrain_video",
                 "parallel", "parallel.collectives", "parallel.mesh", "parallel.sharding",
                 "parallel.dryrun", "utils.dist", "utils.io", "utils.profiling", "data.factory",
                 "data.image_datasets", "models.testing"):
        assert f"vidil_tpu_torch.{name}" in mods, name
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'vidil_tpu')\n"
        "             or m.startswith(('jax.', 'vidil_tpu.')))\n"
        "print(json.dumps(bad))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_chip_smoke_imports_only_the_port():
    """chip_smoke.py runs on the card's machine, which has no JAX."""
    src = open(os.path.join(REPO, "chip_smoke.py")).read()
    assert "import jax" not in src and "vidil_tpu." not in src.replace("vidil_tpu_torch.", "")


def test_tokenizer_copy_matches_jax_package(tmp_path):
    from vidil_tpu.tokenizer import BlipTokenizer as JTok, write_test_vocab as jwrite
    from vidil_tpu_torch.tokenizer import BlipTokenizer, write_bench_vocab, write_test_vocab

    words = ["a", "picture", "of", "man", "##s", "dog", "run", "##ning", ".", ","]
    write_test_vocab(str(tmp_path / "p.txt"), words)
    jwrite(str(tmp_path / "j.txt"), words)
    assert (tmp_path / "p.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()
    tok, jtok = BlipTokenizer(str(tmp_path / "p.txt")), JTok(str(tmp_path / "j.txt"))
    texts = ["A picture of a man running.", "dogs, MEN; [SEP] x", "café ünïcode 中文"]
    enc, jenc = tok(texts, padding="max_length", max_length=12, truncation=True), \
        jtok(texts, padding="max_length", max_length=12, truncation=True)
    np.testing.assert_array_equal(enc.input_ids, jenc.input_ids)
    np.testing.assert_array_equal(enc.attention_mask, jenc.attention_mask)
    assert tok.decode(enc.input_ids[0]) == jtok.decode(jenc.input_ids[0])
    write_bench_vocab(str(tmp_path / "bench.txt"))
    assert BlipTokenizer(str(tmp_path / "bench.txt")).vocab_size == 30524


def test_sentences_sampling_and_sharding_copies():
    from vidil_tpu.data.sampling import sample_frame_indices as jsample
    from vidil_tpu.pipeline.sentences import split_sentences_rules as jsplit
    from vidil_tpu.utils.io import shard_range as jshard
    from vidil_tpu_torch.data.sampling import sample_frame_indices
    from vidil_tpu_torch.pipeline.sentences import split_sentences_rules
    from vidil_tpu_torch.utils.io import shard_range

    text = 'Mr. Smith sat down. a man sings... then "stop." Dr. Who ran. v1.2 ok! fine'
    assert split_sentences_rules(text) == jsplit(text)
    for strategy in ("uniform", "nlvl_uniform", "rand", "headtail"):
        random.seed(3)
        np.random.seed(3)
        want = jsample(40, 4, strategy)
        random.seed(3)
        np.random.seed(3)
        np.testing.assert_array_equal(sample_frame_indices(40, 4, strategy), want)
    for n, rank, world in ((10, 0, 1), (10, 1, 3), (7, 2, 3)):
        assert shard_range(n, rank, world) == jshard(n, rank, world)


def test_single_process_dist_and_multiprocess_refusal(monkeypatch):
    from vidil_tpu_torch import utils

    assert (utils.get_rank(), utils.get_world_size(), utils.is_main_process()) == (0, 1, True)
    utils.barrier()  # a no-op
    # a world without ranks is no rendezvous: it raises instead of running
    # one process as if it were the world
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="RANK"):
        utils.init_distributed_mode()


def test_synth_tree_is_deterministic_and_well_conditioned():
    from vidil_tpu_torch.config import MedConfig, ViTConfig
    from vidil_tpu_torch.models import blip, convert
    from vidil_tpu_torch.utils.synth import synth_tree

    vit = ViTConfig(image_size=32, patch_size=16, hidden_size=32, num_layers=2, num_heads=4)
    medc = MedConfig(vocab_size=50, hidden_size=32, num_layers=2, num_heads=4,
                     intermediate_size=64, max_position_embeddings=16, encoder_width=32)
    shapes = blip.blip_itm_shapes(vit, medc, embed_dim=8)
    a, b = synth_tree(shapes, "cpu", salt=2.0), synth_tree(shapes, "cpu", salt=2.0)
    params = convert.from_jax_params(a)
    assert len(params["visual_encoder"]["blocks"]) == 2
    assert torch.equal(params["visual_encoder"]["blocks"][1]["norm1"]["scale"], torch.ones(32))
    assert torch.equal(a["text_encoder"]["layers"]["mlp"]["fc1"]["kernel"],
                       b["text_encoder"]["layers"]["mlp"]["fc1"]["kernel"])
    w = a["visual_encoder"]["patch_embed"]["kernel"]
    assert w.shape == (16 * 16 * 3, 32) and 0 < w.abs().max() <= 0.05
    itm = blip.blip_itm_scores(params, torch.zeros((2, vit.seq_len, 32)),
                               torch.ones((8, 5), dtype=torch.int32),
                               torch.ones((8, 5), dtype=torch.int32), medc, group_size=4)
    assert itm.shape == (8, 2) and torch.isfinite(itm).all()


def test_trainer_host_module_copies_match_jax_package():
    """The port's copies of the caption trainer's host modules: caption
    cleanup, result merge, LR schedules, caption metrics."""
    from vidil_tpu.data.text_utils import pre_caption as jpre
    from vidil_tpu.evals.caption_metrics import compute_caption_scores as jscores
    from vidil_tpu.utils.schedules import cosine_lr_schedule as jcos, warmup_lr_schedule as jwarm
    from vidil_tpu_torch.data.text_utils import pre_caption
    from vidil_tpu_torch.evals.caption_metrics import compute_caption_scores
    from vidil_tpu_torch.utils.schedules import cosine_lr_schedule, warmup_lr_schedule

    for text in ("A man (in red) is #1: singing!!  ", "x " * 60, "Dogs; run~ fast."):
        assert pre_caption(text, 30) == jpre(text, 30)
    for epoch in range(4):
        assert cosine_lr_schedule(epoch, 4, 5e-6, 0) == jcos(epoch, 4, 5e-6, 0)
        assert warmup_lr_schedule(epoch, 3, 1e-6, 1e-4) == jwarm(epoch, 3, 1e-6, 1e-4)
    gts = {"v0": ["a man is singing", "someone sings a song"], "v1": ["a dog runs on grass"]}
    res = {"v0": ["a man sings"], "v1": ["a dog is running"]}
    assert compute_caption_scores(gts, res) == jscores(gts, res)


def test_metric_logger_and_save_result(tmp_path, capsys):
    from vidil_tpu_torch.data.text_utils import save_result
    from vidil_tpu_torch.utils.logging import MetricLogger

    logger = MetricLogger(delimiter="  ")
    for x in logger.log_every(range(3), 1, "h"):
        logger.update(loss=float(x), lr=torch.tensor(0.5))
    assert logger.loss.global_avg == 1.0 and logger.lr.value == 0.5
    assert "Total time" in capsys.readouterr().out
    path = save_result([{"video_id": "a", "caption": "x"}, {"video_id": "a", "caption": "y"}],
                       str(tmp_path), "r", remove_duplicate="video_id")
    assert json.load(open(path)) == [{"video_id": "a", "caption": "x"}]


def test_kernel_library_hash_covers_included_headers(tmp_path, monkeypatch):
    """A kernel library is named by a hash of its source and of every
    csrc/ header the source includes, directly or through another header:
    editing only a shared header must give a new library, not a stale one."""
    from vidil_tpu_torch.ops import _build

    for name in ("fused_vit_block_bwd", "fused_mlp_fwd"):
        assert [p.name for p in _build.source_files(name)] == [
            f"{name}.cu", "fused_vit_block.cuh", "gemm_sm90.cuh", "sm90.cuh"]
    assert [p.name for p in _build.source_files("flash_attention_fwd")] == [
        "flash_attention_fwd.cu", "sm90.cuh"]
    (tmp_path / "k.cu").write_text('#include "a.cuh"\n#include <cuda_runtime.h>\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n  #  include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    monkeypatch.setattr(_build, "SOURCES", {"k": "k.cu"})
    assert [p.name for p in _build.source_files("k")] == ["k.cu", "a.cuh", "b.cuh"]
    before = _build.library_path("k")
    assert _build.library_path("k") == before
    (tmp_path / "b.cuh").write_text("// v2\n")
    assert _build.library_path("k") != before
