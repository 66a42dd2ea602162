"""The port's host modules against their JAX counterparts on the same files:
`utils/profiling.py` (device_memory_stats, a CPU trace),
`data/factory.py`, `data/datasets.py:VideoToCaptionsDataset`, the
`data/text_utils.py` file-lock poll and `pre_caption_minimum`, the yaml and
dataclass helpers of `config.py`, `data/image_datasets.py` and
`models/testing.py`. Outputs are equal (the random train augmentations
under the same Python and numpy seeds), the yaml dumps byte-identical.
"""

import dataclasses
import json
import os
import random
import types

import numpy as np
import pytest
import torch

from vidil_tpu import config as jconfig
from vidil_tpu.data import datasets as jdatasets, factory as jfactory
from vidil_tpu.data import image_datasets as jimage, text_utils as jtext
from vidil_tpu.models import testing as jtesting
from vidil_tpu_torch import config as pconfig
from vidil_tpu_torch.data import datasets as pdatasets, factory as pfactory
from vidil_tpu_torch.data import image_datasets as pimage, text_utils as ptext
from vidil_tpu_torch.models import testing as ptesting
from vidil_tpu_torch.parallel import dryrun as D
from vidil_tpu_torch.utils import profiling as pprofiling

torch.set_num_threads(1)


def _same(a, b):
    """Equal items: arrays exactly, containers element by element."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert a == b


def _items(jds, pds, n=None, seed=0):
    """Every item (or the first n) of both datasets, each under the same
    Python and numpy seeds."""
    assert len(jds) == len(pds)
    for i in range(len(pds) if n is None else n):
        random.seed(seed + i)
        np.random.seed(seed + i)
        want = jds[i]
        random.seed(seed + i)
        np.random.seed(seed + i)
        _same(pds[i], want)


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """The dry run's synthetic videos, video-keyed ann json and caption
    jsonls (`dryrun.write_cli_workspace`)."""
    root = str(tmp_path_factory.mktemp("torch_host_modules"))
    cli = {ph["kind"]: ph["config"] for ph in D.write_cli_workspace(root, 3, 2, 2)}
    return types.SimpleNamespace(root=root, train=cli["train_caption"], vistok=cli["vistok"])


def test_device_memory_stats_keys():
    stats = pprofiling.device_memory_stats()
    assert stats == {} if not torch.cuda.is_available() else set(stats) == {
        "bytes_in_use", "peak_bytes_in_use", "bytes_limit"}


def test_trace_writes_a_chrome_trace_with_the_range(tmp_path):
    """On the CPU the trace holds the host ops and the annotated range,
    named with the program's span prefix."""
    with pprofiling.trace(str(tmp_path)) as prof:
        with pprofiling.annotate("host_module_range"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    files = [f for f in os.listdir(tmp_path) if f.endswith(".pt.trace.json")]
    assert len(files) == 1 and prof is not None
    trace = json.load(open(tmp_path / files[0]))
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "vidil.host_module_range" in names and any("mm" in str(n) for n in names)


@pytest.mark.parametrize("dataset", ["caption_msrvtt", "retrieval_msrvtt", "pretrain_video"])
def test_factory_datasets_match_jax(workspace, dataset):
    config = dict(workspace.train, num_frm_test=2, eval_video_root=workspace.train["video_root"])
    want, got = (f.create_dataset(dataset, config) for f in (jfactory, pfactory))
    if dataset == "pretrain_video":
        want, got = (want,), (got,)
    assert len(want) == len(got)
    for jds, pds in zip(want, got):
        _items(jds, pds, n=2)
    sizes = [len(d) for d in got]
    assert (pfactory.create_sampler(got, [True] * len(got), 2, 1)
            == jfactory.create_sampler(want, [True] * len(got), 2, 1))
    loaders = pfactory.create_loader(got, [None] * len(got), [2] * len(got), [1] * len(got),
                                     [False] * len(got), [None] * len(got))
    assert [len(ld) for ld in loaders] == [(n + 1) // 2 for n in sizes]


def test_factory_unknown_dataset_raises():
    with pytest.raises(NotImplementedError, match="unknown dataset"):
        pfactory.create_dataset("nlvr_video", {})


@pytest.mark.parametrize("train", [False, True])
def test_video_to_captions_dataset_matches_jax(workspace, capsys, train):
    config = dict(workspace.vistok, image_size=32, num_frm_train=2)
    jds = jdatasets.VideoToCaptionsDataset(config, train=train)
    jout = capsys.readouterr().out
    pds = pdatasets.VideoToCaptionsDataset(config, train=train)
    assert capsys.readouterr().out == jout
    assert pds.annotation == jds.annotation and len(pds) == 3
    _items(jds, pds)


def test_text_utils_match_jax(tmp_path):
    path = str(tmp_path / "f.json")
    for mod in (jtext, ptext):
        assert not mod.is_locked(path) and not mod.wait_for_file(path, 0.01, 0.02)
    with open(path, "w") as f:
        f.write("{}")
    for mod in (jtext, ptext):
        assert not mod.is_locked(path) and mod.wait_for_file(path, 0.01, 0.02)
    for text in ("  A  man\n", "two   words here  " * 30, "Keeps (punctuation) and CASE!\n",
                 ""):
        for n in (3, 50):
            assert ptext.pre_caption_minimum(text, n) == jtext.pre_caption_minimum(text, n)


def test_yaml_and_asdict_match_jax(tmp_path):
    config = {"z": 1, "a": [1, 2.5, "x"], "m": {"k": None, "b": True}, "s": "text"}
    for mod, name in ((jconfig, "jax"), (pconfig, "port")):
        mod.dump_yaml_config(config, str(tmp_path / name))
    want = open(tmp_path / "jax" / "config.yaml", "rb").read()
    assert open(tmp_path / "port" / "config.yaml", "rb").read() == want
    path = str(tmp_path / "port" / "config.yaml")
    assert pconfig.load_yaml_config(path) == jconfig.load_yaml_config(path) == config
    pconfig.dump_yaml_config(config, str(tmp_path / "sorted"), sort_keys=True)
    assert list(pconfig.load_yaml_config(str(tmp_path / "sorted" / "config.yaml"))) == sorted(
        config)
    for jcls, pcls in ((jconfig.MedConfig, pconfig.MedConfig),
                       (jconfig.CLIPConfig, pconfig.CLIPConfig)):
        got, want = pconfig.asdict(pcls()), jconfig.asdict(jcls())
        assert got == dataclasses.asdict(pcls())
        assert {k: got[k] for k in want if k in got} == {k: want[k] for k in want if k in got}


def _write_images(root, names, seed=0):
    from PIL import Image

    rng = np.random.RandomState(seed)
    for name in names:
        path = os.path.join(root, name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        Image.fromarray(rng.randint(0, 256, (40, 48, 3)).astype(np.uint8)).save(path)


def test_image_datasets_match_jax(tmp_path):
    root = str(tmp_path)
    names = [f"val2014/COCO_val2014_{i:012d}.jpg" for i in range(3)]
    _write_images(root, names)

    def ann(name, rows):
        path = os.path.join(root, name)
        with open(path, "w") as f:
            json.dump(rows, f)
        return path

    coco = ann("coco.json", [{"image": n, "caption": f"A Dog (runs) #{i}.", "image_id": i % 2}
                             for i, n in enumerate(names)])
    evals = ann("eval.json", [{"image": names[0]}, {"image": names[1], "img_id": 7}])
    flickr = ann("flickr.json", [{"image": n, "caption": [f"Cap {i}!", "Two; words"]}
                                 for i, n in enumerate(names)])
    nlvr = ann("nlvr.json", [{"images": names[:2], "sentence": "Left: dogs.", "label": "True"},
                             {"images": names[1:], "sentence": "Right", "label": "False"}])
    vqa = ann("vqa.json", [{"image": names[0], "question": "What (color)?",
                            "answers": ["red", "red", "blue"], "question_id": 1},
                           {"image": names[1], "question": "Is it?", "answer": "yes",
                            "question_id": 2}])
    pre = ann("pre.json", [{"image": os.path.join(root, names[2]), "caption": ["a", "b c"]},
                           {"image": os.path.join(root, names[0]), "caption": "One. Two"}])
    cases = [("CocoKarpathyTrain", (coco, root, 24), {"prompt": "a picture of "}),
             ("ImageCaptionEval", (evals, root, 24), {}),
             ("Flickr30kRetrieval", (flickr, root, 24), {}),
             ("NLVRDataset", (nlvr, root, 24), {"train": True}),
             ("NLVRDataset", (nlvr, root, 24), {"train": False}),
             ("CocoVQADataset", (vqa, root, 24), {"split": "train"}),
             ("CocoVQADataset", (vqa, root, 24), {"split": "test"}),
             ("ImagePretrainDataset", ([pre], 24), {})]
    for cls, args, kw in cases:
        jds, pds = getattr(jimage, cls)(*args, **kw), getattr(pimage, cls)(*args, **kw)
        _items(jds, pds)
        if cls == "Flickr30kRetrieval":
            assert (pds.text, pds.txt2img, pds.img2txt) == (jds.text, jds.txt2img, jds.img2txt)


def test_testing_checkpoints_match_jax(tmp_path):
    from vidil_tpu.config import MedConfig as JMed, ViTConfig as JViT

    kw_v = dict(image_size=32, patch_size=16, hidden_size=32, num_layers=2, num_heads=4)
    kw_m = dict(vocab_size=40, hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
                max_position_embeddings=16, encoder_width=32)
    jv, jm = JViT(**kw_v), JMed(**kw_m)
    pv, pm = pconfig.ViTConfig(**kw_v), pconfig.MedConfig(**kw_m)
    pairs = [(jtesting.make_blip_decoder_ckpt(jv, jm), ptesting.make_blip_decoder_ckpt(pv, pm)),
             (jtesting.make_blip_itm_ckpt(jv, jm, embed_dim=8),
              ptesting.make_blip_itm_ckpt(pv, pm, embed_dim=8)),
             (jtesting.make_vit_sd(jv, np.random.default_rng(4)),
              ptesting.make_vit_sd(pv, np.random.default_rng(4)))]
    for want, got in pairs:
        assert got.keys() == want.keys() and len(got) > 20
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    ptesting.save_torch_ckpt(pairs[0][1], str(tmp_path / "p.pth"))
    jtesting.save_torch_ckpt(pairs[0][0], str(tmp_path / "j.pth"))
    a, b = (torch.load(tmp_path / f, weights_only=True)["model"] for f in ("p.pth", "j.pth"))
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
