"""The port's CapFilt CLI (python -m vidil_tpu_torch.run_video_CapFilt)
against the JAX CLI (run_video_CapFilt.py) on one tiny fixture in fp32:
the two output JSON files must be byte-identical, for RGB and for YUV420
transfer, and with resize_on_device. Also: sampling is seeded by --seed,
the engine refuses CUDA on a host without it, and asking for an unported
option raises instead of doing something else.
"""

import json
import os
import sys
import types

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from vidil_tpu.config import MedConfig as JMed, ViTConfig as JViT
from vidil_tpu.models.testing import make_blip_decoder_ckpt, make_blip_itm_ckpt, save_torch_ckpt
from vidil_tpu.tokenizer import write_test_vocab

torch.set_num_threads(1)

VIT_KW = dict(patch_size=16, hidden_size=32, num_layers=2, num_heads=4)
IMAGE_SIZE = 32
OUTPUTS = ("video_text_Cap.json", "video_text_CapFilt.json")
# "unused": the canonical BERT layout, whose [unusedN] ids a random decoder
# emits and which do not survive decode -> re-tokenize, so every video takes
# the fused filter's classic fallback; "words": plain words only, which
# re-tokenize stably, so the fused ITM scores decide
VOCABS = ("unused", "words")
# decoder seed of the "words" fixture: its captions never hold a
# mid-sequence [PAD], so no video falls back (seed 0 does)
WORDS_DECODER_SEED = 4
# keeps some of the "words" captions and drops others; no ITM probability
# of the fixture lies within 5e-4 of it
THRESHOLD = 0.485


def _write_vocab(kind, path):
    if kind == "unused":
        write_test_vocab(path, ["a", "picture", "of", "original", "caption", "second",
                                "sentence", "video", "0", "1", "2", ".", "man", "dog", "cat"])
        return
    words = (["[PAD]", "a", "picture", "of"] + [f"word{i}" for i in range(96)]
             + ["[UNK]", "[CLS]", "[SEP]", "[MASK]"] + [f"tok{i}" for i in range(20)])
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(words) + "\n")


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    import cv2

    root = tmp_path_factory.mktemp("torch_capfilt_cli")
    videos = root / "videos"
    videos.mkdir()
    ann = {}
    for vi in range(3):
        path = str(videos / f"video{vi}.mp4")
        w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10, (64, 48))
        for i in range(30):
            frame = np.zeros((48, 64, 3), np.uint8)
            frame[:, :, vi % 3] = (i * 7 + vi * 50) % 255
            frame[: 10 + i, :, (vi + 1) % 3] = 120
            w.write(frame)
        w.release()
        ann[f"video{vi}"] = [f"original caption {vi}. second sentence {vi}"]
    ann["missing_video"] = ["should be skipped"]
    ann_path = str(root / "ann.json")
    with open(ann_path, "w") as f:
        json.dump(ann, f)

    from vidil_tpu.tokenizer import BlipTokenizer

    vit_cfg = JViT(image_size=IMAGE_SIZE, **VIT_KW)
    models = {}
    for kind in VOCABS:
        vocab_path = str(root / f"vocab_{kind}.txt")
        _write_vocab(kind, vocab_path)
        med_cfg_path = str(root / f"med_config_{kind}.json")
        with open(med_cfg_path, "w") as f:
            json.dump({"vocab_size": BlipTokenizer(vocab_path).vocab_size, "hidden_size": 32,
                       "num_hidden_layers": 2, "num_attention_heads": 4,
                       "intermediate_size": 64, "max_position_embeddings": 64,
                       "encoder_width": 32, "add_cross_attention": True}, f)
        med_cfg = JMed.from_json(med_cfg_path)
        cap_ckpt = str(root / f"captioner_{kind}.pth")
        fil_ckpt = str(root / f"filterer_{kind}.pth")
        seed = WORDS_DECODER_SEED if kind == "words" else 0
        save_torch_ckpt(make_blip_decoder_ckpt(vit_cfg, med_cfg, seed=seed), cap_ckpt)
        save_torch_ckpt(make_blip_itm_ckpt(vit_cfg, med_cfg), fil_ckpt)
        models[kind] = dict(med_config=med_cfg_path, bert_vocab=vocab_path,
                            caption_model_ckpt=cap_ckpt, filterer_model_ckpt=fil_ckpt)
    config = dict(
        video_roots=str(videos), video_formats="mp4", train_ann_jsons=ann_path,
        frm_sampling_strategy="uniform", height=None, width=None,
        start_time=None, end_time=None, fps=-1,
        caption=True, filter=True, filter_generated_only=True,
        keep_original_caption=False, filter_mode="max_filter",
        generation_mode="beam", threshold=-1.0, num_frm_CapFilt=4,
        do_sentence_tokenization=True, compute_dtype="float32",
        vit="tiny", vit_config=VIT_KW, image_size=IMAGE_SIZE, videos_per_batch=2,
        **models["unused"],
    )
    return types.SimpleNamespace(root=root, config=config, models=models)


def _args(out_dir, device):
    os.makedirs(out_dir, exist_ok=True)
    return types.SimpleNamespace(output_dir=out_dir, seed=42, world_size=1,
                                 dist_url="env://", distributed=False, device=device)


def _read(out_dir):
    out = {}
    for name in OUTPUTS:
        with open(os.path.join(out_dir, name), "rb") as f:
            out[name] = f.read()
    return out


@pytest.mark.parametrize("transfer_format,vocab,threshold", [
    ("rgb", "unused", -1.0), ("rgb", "words", THRESHOLD), ("yuv420", "words", THRESHOLD)])
def test_cli_outputs_byte_identical_to_jax_cli(workdir, transfer_format, vocab, threshold):
    import run_video_CapFilt as jax_cli
    from vidil_tpu_torch import run_video_CapFilt as torch_cli

    config = dict(workdir.config, transfer_format=transfer_format, threshold=threshold,
                  **workdir.models[vocab])
    tag = f"{transfer_format}_{vocab}"
    jax_dir = str(workdir.root / f"jax_{tag}")
    torch_dir = str(workdir.root / f"torch_{tag}")
    jax_cli.main(_args(jax_dir, "cpu"), dict(config))
    torch_cli.main(_args(torch_dir, "cpu"), dict(config))
    want, got = _read(jax_dir), _read(torch_dir)
    assert got == want
    cap = json.loads(got["video_text_Cap.json"])
    assert set(cap) == {"video0", "video1", "video2"}
    assert all(isinstance(t, str) and t for texts in cap.values() for t in texts)
    assert not os.path.exists(os.path.join(torch_dir, "tmp"))
    capfilt = json.loads(got["video_text_CapFilt.json"])
    n_cap, n_kept = (sum(map(len, d.values())) for d in (cap, capfilt))
    if threshold > 0:  # the threshold keeps some captions and drops others
        assert 0 < n_kept < n_cap
    else:
        assert n_kept == n_cap


def test_cli_unported_options_raise(workdir):
    """A data axis the launch does not have raises (data_parallel: 2 on one
    rank). The options ported since (data_parallel: true, which runs on
    the launch's ranks; resize_on_device; generation_mode 'sample') build
    an engine."""
    from vidil_tpu_torch import run_video_CapFilt as torch_cli

    with pytest.raises(ValueError, match="data_parallel"):
        torch_cli.build_engine(dict(workdir.config, data_parallel=2), device="cpu")
    for key, value in (("data_parallel", True), ("resize_on_device", True),
                       ("generation_mode", "sample")):
        torch_cli.build_engine(dict(workdir.config, **{key: value}), device="cpu")


@pytest.mark.parametrize("transfer_format,native", [("rgb", None), ("yuv420", None),
                                                    ("rgb", (40, 56))])
def test_cli_resize_on_device_byte_identical_to_jax_cli(workdir, transfer_format, native):
    """resize_on_device: the frames go to the engine at their native 48x64
    (or, with native_height/native_width 40x56, every video is an off-spec
    one that the host resamples to it, with one warning) and the encode
    resizes them to 32 px: the outputs equal the JAX CLI's byte for byte."""
    import run_video_CapFilt as jax_cli
    from vidil_tpu_torch import run_video_CapFilt as torch_cli

    config = dict(workdir.config, transfer_format=transfer_format, threshold=THRESHOLD,
                  resize_on_device=True, **workdir.models["words"])
    if native is not None:
        config.update(native_height=native[0], native_width=native[1])
    tag = f"resize_{transfer_format}_{native}"
    jax_dir = str(workdir.root / f"jax_{tag}")
    torch_dir = str(workdir.root / f"torch_{tag}")
    jax_cli.main(_args(jax_dir, "cpu"), dict(config))
    torch_cli.main(_args(torch_dir, "cpu"), dict(config))
    want, got = _read(jax_dir), _read(torch_dir)
    assert got == want
    cap = json.loads(got["video_text_Cap.json"])
    assert set(cap) == {"video0", "video1", "video2"}
    assert all(isinstance(t, str) and t for texts in cap.values() for t in texts)


def test_cli_sample_mode_is_seeded(workdir):
    """generation_mode 'sample': every chunk draws from a generator seeded
    with --seed, so two runs with one seed write the same files, another
    seed other captions."""
    from vidil_tpu_torch import run_video_CapFilt as torch_cli

    config = dict(workdir.config, generation_mode="sample", threshold=-1.0,
                  **workdir.models["words"])
    outs = []
    for name, seed in (("a", 42), ("b", 42), ("c", 7)):
        out_dir = str(workdir.root / f"torch_sample_{name}")
        args = _args(out_dir, "cpu")
        args.seed = seed
        torch_cli.main(args, dict(config))
        outs.append(_read(out_dir))
    assert outs[0] == outs[1]
    cap = json.loads(outs[0]["video_text_Cap.json"])
    assert set(cap) == {"video0", "video1", "video2"}
    assert all(isinstance(t, str) and t for texts in cap.values() for t in texts)
    assert outs[2]["video_text_Cap.json"] != outs[0]["video_text_Cap.json"]


def test_cli_parses_reference_flags():
    from vidil_tpu_torch import run_video_CapFilt as torch_cli

    args = torch_cli.parse_args(["--config", "c.yaml", "--output_dir", "o"])
    assert (args.config, args.output_dir, args.device, args.seed) == ("c.yaml", "o", "cuda", 42)


def test_engine_defaults_to_cuda_and_raises_without_it(workdir):
    """Entry points run on CUDA unless the caller asks for the CPU."""
    from vidil_tpu_torch import run_video_CapFilt as torch_cli
    from vidil_tpu_torch.pipeline.capfilt import CapFiltEngine

    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    engine = torch_cli.build_engine(dict(workdir.config), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CapFiltEngine(engine.captioner_params, engine.filterer_params, engine.tok,
                      engine.vit_cfg, engine.med_cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_cli.build_engine(dict(workdir.config))
