"""The port's visual tokenization (python -m vidil_tpu_torch.run_visual_tokenization,
pipeline/visual_tokenization.py) against the JAX package's on tiny
fixtures in fp32: the CLIs' visual_tokens.json byte-identical for both
encoders (BLIP with the fused MLP switch on and off), the host code's
copies, the blocked rerank, padding row-independence, and the BLIP engine
with kernel K3 forced on both sides.
"""

import functools
import json
import os
import sys
import types

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp

from vidil_tpu.config import MedConfig as JMed, ViTConfig as JViT
from vidil_tpu.models.testing import make_blip_itm_ckpt, save_torch_ckpt
from vidil_tpu.pipeline import visual_tokenization as jvt
from vidil_tpu.tokenizer import BlipTokenizer as JBlipTok, write_test_clip_bpe, write_test_vocab
from vidil_tpu_torch import run_visual_tokenization as pcli
from vidil_tpu_torch.pipeline import visual_tokenization as pvt

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VIT_KW = dict(patch_size=16, hidden_size=32, num_layers=2, num_heads=4)
IMAGE_SIZE = 32
ONTOLOGY = {"objects": ["dog", "cat", "bird"], "attributes": ["red", "blue", "shiny"],
            "scenes": ["beach", "park", "kitchen"], "verbs": ["running", "sitting", "eating"]}


def _write_videos(root, n, frames):
    import cv2

    videos = root / "videos"
    videos.mkdir()
    ann = {}
    for vi in range(n):
        w = cv2.VideoWriter(str(videos / f"vid{vi}.mp4"), cv2.VideoWriter_fourcc(*"mp4v"), 10,
                            (64, 48))
        for i in range(frames):
            frame = np.zeros((48, 64, 3), np.uint8)
            frame[:, :, vi % 3] = (i * 9 + vi * 60) % 255
            frame[::4, :, (vi + 1) % 3] = (i * 23) % 255
            w.write(frame)
        w.release()
        ann[f"vid{vi}"] = [f"caption for video {vi}"]
    ann_path = str(root / "ann.json")
    with open(ann_path, "w") as f:
        json.dump(ann, f)
    onto = root / "onto"
    onto.mkdir()
    paths = {}
    for key, terms in ONTOLOGY.items():
        paths[key] = str(onto / f"{key}.json")
        with open(paths[key], "w") as f:
            json.dump(terms, f)
    return dict(video_roots=str(videos), video_formats="mp4", train_ann_jsons=ann_path,
                frm_sampling_strategy="uniform", height=None, width=None, start_time=None,
                end_time=None, fps=-1, ontology="custom", ontology_paths=paths,
                topk_visualize=2, prompt_version_visual_tokenization="v1", save_frames=False,
                early_stop_step=-1, videos_per_batch=2, compute_dtype="float32"), ann


@pytest.fixture(scope="module")
def clip_workdir(tmp_path_factory):
    from transformers import CLIPConfig as HFCLIPConfig
    from transformers import CLIPModel, CLIPTextConfig, CLIPVisionConfig

    root = tmp_path_factory.mktemp("torch_vistok_clip")
    config, ann = _write_videos(root, 3, 24)
    words = ["a", "photo", "of"] + [t for terms in ONTOLOGY.values() for t in terms]
    vocab_path, merges_path = str(root / "vocab.json"), str(root / "merges.txt")
    write_test_clip_bpe(vocab_path, merges_path, words)
    with open(vocab_path) as f:
        vocab_size = len(json.load(f))
    text_cfg = CLIPTextConfig(vocab_size=vocab_size, hidden_size=32, intermediate_size=64,
                              num_hidden_layers=2, num_attention_heads=4,
                              max_position_embeddings=16, hidden_act="quick_gelu",
                              bos_token_id=vocab_size - 2, eos_token_id=vocab_size - 1)
    vision_cfg = CLIPVisionConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                                  num_attention_heads=4, image_size=28, patch_size=14,
                                  hidden_act="quick_gelu")
    torch.manual_seed(0)
    hf = CLIPModel(HFCLIPConfig.from_text_vision_configs(text_cfg, vision_cfg, projection_dim=24))
    ckpt_path = str(root / "clip.pth")
    torch.save(hf.state_dict(), ckpt_path)
    config.update(
        num_frm_visual_tokenization=4,
        clip_config=dict(image_size=28, patch_size=14, vision_hidden_size=32,
                         vision_layers=2, vision_heads=4, vision_intermediate_size=64,
                         vocab_size=vocab_size, text_hidden_size=32, text_layers=2,
                         text_heads=4, text_intermediate_size=64, max_text_len=16,
                         projection_dim=24),
        clip_ckpt=ckpt_path, clip_vocab=vocab_path, clip_merges=merges_path)
    return types.SimpleNamespace(root=root, config=config, ann=ann)


@pytest.fixture(scope="module")
def blip_workdir(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_vistok_blip")
    config, ann = _write_videos(root, 3, 20)
    vocab_path = str(root / "vocab.txt")
    write_test_vocab(vocab_path, ["a", "photo", "of", "caption", "for", "video", "0", "1", "2"]
                     + [t for terms in ONTOLOGY.values() for t in terms])
    vocab_size = JBlipTok(vocab_path).vocab_size
    med_path = str(root / "med.json")
    with open(med_path, "w") as f:
        json.dump({"vocab_size": vocab_size, "hidden_size": 32, "num_hidden_layers": 2,
                   "num_attention_heads": 4, "intermediate_size": 64,
                   "max_position_embeddings": 64, "encoder_width": 32,
                   "add_cross_attention": True}, f)
    ckpt = str(root / "retrieval.pth")
    save_torch_ckpt(make_blip_itm_ckpt(JViT(image_size=IMAGE_SIZE, **VIT_KW),
                                       JMed.from_json(med_path), embed_dim=8), ckpt)
    config.update(num_frm_visual_tokenization=2, blip_model_visual_tokenization=ckpt,
                  vit="tiny", vit_config=dict(VIT_KW), image_size=IMAGE_SIZE,
                  med_config=med_path, bert_vocab=vocab_path, k_test=2)
    return types.SimpleNamespace(root=root, config=config, ann=ann)


def _run_cli(cli, out_dir, config, encoder):
    args = types.SimpleNamespace(output_dir=str(out_dir), seed=42, world_size=1,
                                 dist_url="env://", distributed=False, device="cpu",
                                 encoder_version=encoder)
    os.makedirs(out_dir, exist_ok=True)
    cli.main(args, dict(config))
    assert not os.path.exists(os.path.join(out_dir, "tmp"))
    with open(os.path.join(out_dir, "visual_tokens.json"), "rb") as f:
        return f.read()


@pytest.mark.parametrize("case", ["clip", "blip", "blip_fused_mlp"])
def test_cli_visual_tokens_byte_identical_to_jax(case, clip_workdir, blip_workdir):
    import run_visual_tokenization as jcli

    wd = clip_workdir if case == "clip" else blip_workdir
    config = dict(wd.config)
    if case == "blip_fused_mlp":
        config["vit_config"] = dict(VIT_KW, use_fused_mlp=True)
    encoder = case.split("_")[0]
    want = _run_cli(jcli, wd.root / f"jax_{case}", config, encoder)
    got = _run_cli(pcli, wd.root / f"port_{case}", config, encoder)
    assert got == want
    tokens = json.loads(got)
    assert set(tokens) == set(wd.ann)
    for vid, obj in tokens.items():
        assert obj["caption"] == wd.ann[vid]
        assert len(obj["frame_tokens"]) == config["num_frm_visual_tokenization"]
        for ft in obj["frame_tokens"]:
            for key, terms in ONTOLOGY.items():
                assert len(ft[key]) == 2 and set(ft[key]) <= set(terms)


def test_host_code_copies_match_jax(tmp_path):
    """Prompts, the ontology loader (with its mutate-while-iterating quirk),
    the vendored vg / vg_tencent counts, the vote and the CLIP crop."""
    for v in ("v0", "v1"):
        assert ({k: f("dog") for k, f in pvt.get_prefix_prompt_functions(v).items()}
                == {k: f("dog") for k, f in jvt.get_prefix_prompt_functions(v).items()})
    files = {"objects": ["red", "blue", "dog"], "attributes": ["red", "blue", "shiny", "video"],
             "scenes": ["beach", "stock"], "verbs": {"running": 1, "sound": 2}}
    paths = {}
    for key, data in files.items():
        paths[key] = str(tmp_path / f"{key}.json")
        with open(paths[key], "w") as f:
            json.dump(data, f)
    assert pvt.load_ontology(paths) == jvt.load_ontology(paths)
    assert pvt.load_ontology(paths)["attributes"] == ["blue", "shiny"]
    assert pvt.OMIT_KEYWORDS == jvt.OMIT_KEYWORDS
    root = os.path.join(REPO, "visual_token_ontology")
    for onto in ("vg", "vg_tencent"):
        assert pvt.ontology_paths(onto, root) == jvt.ontology_paths(onto, root)
        got = pvt.load_ontology(pvt.ontology_paths(onto, root))
        assert got == jvt.load_ontology(jvt.ontology_paths(onto, root))
    assert {k: len(v) for k, v in got.items()} == {
        "objects": 11163, "attributes": 15157, "scenes": 365, "verbs": 7410}
    vg = pvt.load_ontology(pvt.ontology_paths("vg", root))
    assert {k: len(v) for k, v in vg.items()} == {
        "objects": 19958, "attributes": 15026, "scenes": 365, "verbs": 7410}
    rng = np.random.default_rng(0)
    frame_tokens = [{k: list(rng.choice(ONTOLOGY[k], 2, replace=False)) for k in ONTOLOGY}
                    for _ in range(4)]
    frame_tokens[0]["attributes"] = []
    assert pvt.aggregate_frame_tokens(frame_tokens) == jvt.aggregate_frame_tokens(frame_tokens)
    for shape in [(300, 480), (480, 300), (100, 90)]:
        frames = rng.integers(0, 256, size=(2, *shape, 3), dtype=np.uint8)
        np.testing.assert_array_equal(pvt.clip_preprocess_pil(frames, 224),
                                      jvt.clip_preprocess_pil(frames, 224))


def _frames(n, seed, size=IMAGE_SIZE):
    return np.random.RandomState(seed).randint(0, 256, (n, size, size, 3)).astype(np.uint8)


def test_rerank_all_matches_blocked_rerank(blip_workdir):
    """rerank_all (one call per block, one copy to the host) equals
    rerank_block block by block, tail-row padding and -100 fill included."""
    engine = pcli.build_blip_engine(dict(blip_workdir.config), device="cpu")
    texts = ["A photo of dog", "A photo of cat", "A photo of bird", "A photo of beach",
             "A photo of park"]
    text_embeds, text_ids, text_atts = engine.embed_texts(texts)
    assert text_ids[0, 0] == engine.tok.enc_token_id and text_ids.shape[1] < 35
    feats, embeds = engine.embed_frames(_frames(5, 1))
    sims = engine.score(embeds, text_embeds)
    fast = engine.rerank_all(sims, feats, text_ids, text_atts, rows_per_block=2)
    R, blocks = 2, []
    for s in range(0, 5, R):
        e = min(5, s + R)
        idx = list(range(s, e)) + [e - 1] * (R - (e - s))
        rows = sims[np.asarray(idx)]
        blocks.append(engine.rerank_block(rows, feats[torch.as_tensor(idx)], text_ids,
                                          text_atts)[: e - s])
    np.testing.assert_array_equal(fast, np.concatenate(blocks))
    assert (fast == -100.0).sum() == 5 * (len(texts) - engine.k_test)
    np.testing.assert_array_equal(engine.rerank(sims[0], feats[0], text_ids, text_atts), fast[0])


@pytest.mark.parametrize("encoder", ["clip", "blip"])
def test_embed_texts_in_blocks_matches_one_block(encoder, clip_workdir, blip_workdir,
                                                 monkeypatch):
    """Ontologies longer than one 512-text block run block by block, the
    last padded with copies of the last text; rows are independent."""
    wd = clip_workdir if encoder == "clip" else blip_workdir
    build = pcli.build_clip_engine if encoder == "clip" else pcli.build_blip_engine
    engine = build(dict(wd.config), device="cpu")
    texts = [f"A photo of {t} {i}" for i, t in enumerate(ONTOLOGY["objects"] * 4)]
    ref = engine.embed_texts(texts)  # one block of 12
    monkeypatch.setattr(pvt, "EMBEDDING_BATCH_LIMIT_TEXT", 5)
    got = engine.embed_texts(texts)  # 3 blocks of 5, the last padded
    if encoder == "clip":
        ref, got = (ref,), (got,)
    np.testing.assert_allclose(np.asarray(got[0]), np.asarray(ref[0]), atol=1e-6, rtol=0)
    for a, b in zip(got[1:], ref[1:]):
        np.testing.assert_array_equal(a, b)
    assert len(got[0]) == len(texts)


@pytest.mark.parametrize("encoder", ["clip", "blip"])
def test_predict_videos_padding_row_independent(encoder, clip_workdir, blip_workdir):
    """Tail chunks are padded to the chunk's video count with copies of the
    last video; the real rows' tokens do not depend on it."""
    wd = clip_workdir if encoder == "clip" else blip_workdir
    build = pcli.build_clip_engine if encoder == "clip" else pcli.build_blip_engine
    engine = build(dict(wd.config), device="cpu")
    size = 28 if encoder == "clip" else IMAGE_SIZE
    onto = pvt.load_ontology(wd.config["ontology_paths"])
    fns = pvt.get_prefix_prompt_functions("v1")
    frames = {f"v{i}": _frames(2, 3 + i, size) for i in range(2)}
    caps = {k: [f"caption {k}"] for k in frames}
    cache = {}
    padded = pvt.predict_videos(engine, dict(frames), caps, onto, fns, topk_visualize=2,
                                text_cache=cache, pad_to_videos=5)
    plain = pvt.predict_videos(engine, {k: torch.from_numpy(v) for k, v in frames.items()},
                               caps, onto, fns, topk_visualize=2, pad_to_videos=0)
    assert padded == plain and sorted(padded) == ["v0", "v1"] and set(cache) == set(ONTOLOGY)


def test_blip_engine_with_k3_forced_matches_jax(blip_workdir, monkeypatch):
    """K3 in situ: the BLIP engine's ViT encode, text embeddings and ITM
    rerank with use_fused_mlp in both towers and the fused MLP forced on
    both sides (mlp_auto with interpret=True and a 8-row gate): the JAX
    kernel in interpret mode against the port's plain version of K3."""
    from vidil_tpu.models import layers as jlayers, med as jmed, vit as jvit
    from vidil_tpu.models.convert import convert_blip_retrieval as jconvert, load_torch_state_dict
    from vidil_tpu_torch.config import MedConfig, ViTConfig
    from vidil_tpu_torch.models import convert, layers as players, med as pmed, vit as pvit
    from vidil_tpu_torch.ops import fused_mlp as fm
    from vidil_tpu_torch.tokenizer import BlipTokenizer

    for layers, modules in ((jlayers, (jvit, jmed)), (players, (pvit, pmed))):
        monkeypatch.setattr(layers, "_FUSED_MLP_MIN_ROWS", 8)
        for mod in modules:
            monkeypatch.setattr(mod, "mlp_auto", functools.partial(layers.mlp_auto,
                                                                   interpret=True))
    calls = []
    ref = fm.fused_mlp_ref
    monkeypatch.setattr(fm, "fused_mlp_ref", lambda *a: calls.append(a[0].shape) or ref(*a))

    c = blip_workdir.config
    sd = load_torch_state_dict(c["blip_model_visual_tokenization"])
    jv = JViT(image_size=IMAGE_SIZE, **VIT_KW, use_fused_mlp=True)
    jm = JMed.from_json(c["med_config"], use_fused_mlp=True)
    pv = ViTConfig(image_size=IMAGE_SIZE, **VIT_KW, use_fused_mlp=True)
    pm = MedConfig.from_json(c["med_config"], use_fused_mlp=True)
    jengine = jvt.BlipTokenizationEngine(jconvert(sd, jv, jm, with_momentum=False), jv, jm,
                                         JBlipTok(c["bert_vocab"]), k_test=2)
    pengine = pvt.BlipTokenizationEngine(convert.convert_blip_retrieval(sd, pv, pm, False), pv,
                                         pm, BlipTokenizer(c["bert_vocab"]), k_test=2,
                                         device="cpu")
    texts = [f"A photo of {t}" for t in ONTOLOGY["objects"] + ONTOLOGY["scenes"]]
    frames = _frames(4, 5)
    jfeats, jemb = jengine.embed_frames(frames)
    pfeats, pemb = pengine.embed_frames(frames)
    np.testing.assert_allclose(pfeats.numpy(), np.asarray(jfeats), atol=1e-5, rtol=0)
    np.testing.assert_allclose(pemb, jemb, atol=1e-5, rtol=0)
    jt, pt = jengine.embed_texts(texts), pengine.embed_texts(texts)
    np.testing.assert_allclose(pt[0], jt[0], atol=1e-5, rtol=0)
    for a, b in zip(pt[1:], jt[1:]):
        np.testing.assert_array_equal(a, b)
    sims = pengine.score(pemb, pt[0])
    want = jengine.rerank_block(sims, jnp.asarray(jfeats), *jt[1:])
    got = pengine.rerank_block(sims, pfeats, *pt[1:])
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # K3's plain version ran in the ViT (4 frames x 5 tokens), the text
    # encoder (6 texts) and the ITM (4 frames x 2 texts), 2 layers each
    assert [tuple(s) for s in calls] == [(4, 5, 32)] * 2 + [(6, 8, 32)] * 2 + [(8, 8, 32)] * 2


@pytest.mark.parametrize("with_momentum", [True, False])
def test_convert_blip_retrieval_matches_jax(with_momentum):
    """BLIP_Retrieval checkpoints: the ITM tree, plus the momentum encoders
    (`_m` keys) when asked for, and the temperature."""
    import jax

    from vidil_tpu.models.convert import convert_blip_retrieval as jconvert
    from vidil_tpu_torch.config import MedConfig, ViTConfig
    from vidil_tpu_torch.models import convert

    jv, jm = JViT(image_size=IMAGE_SIZE, **VIT_KW), JMed(
        vocab_size=40, hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
        max_position_embeddings=16, encoder_width=32)
    sd = make_blip_itm_ckpt(jv, jm, embed_dim=8)
    momentum = make_blip_itm_ckpt(jv, jm, embed_dim=8, seed=2)
    for prefix in ("visual_encoder.", "text_encoder.", "vision_proj.", "text_proj."):
        for k, v in momentum.items():
            if k.startswith(prefix):
                sd[prefix[:-1] + "_m." + k[len(prefix):]] = v
    sd["temp"] = np.asarray([0.07], np.float32)
    want = jax.tree.map(np.asarray, jconvert(sd, jv, jm, with_momentum=with_momentum))
    pv, pm = ViTConfig(image_size=IMAGE_SIZE, **VIT_KW), MedConfig(**{
        f: getattr(jm, f) for f in ("vocab_size", "hidden_size", "num_layers", "num_heads",
                                    "intermediate_size", "max_position_embeddings",
                                    "encoder_width")})
    got = convert.to_jax_params(convert.convert_blip_retrieval(
        {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, pv, pm,
        with_momentum=with_momentum))
    assert ("momentum" in got) == with_momentum and got["temp"].shape == ()
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_unported_and_device_guards(clip_workdir, monkeypatch):
    # data_parallel: true runs on the launch's ranks; a data axis the
    # launch does not have raises
    pcli.build_clip_engine(dict(clip_workdir.config, data_parallel=True), device="cpu")
    with pytest.raises(ValueError, match="data_parallel"):
        pcli.build_clip_engine(dict(clip_workdir.config, data_parallel=2), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pcli.build_clip_engine(dict(clip_workdir.config))  # --device cuda is the default
    assert pcli.parse_args([]).device == "cuda"
    # clip-kmeans: a selector where scikit-learn is installed; where it is
    # missing, an ImportError that says so
    assert callable(pvt.make_clip_kmeans_selector(None))
    monkeypatch.setitem(sys.modules, "sklearn", None)
    monkeypatch.setitem(sys.modules, "sklearn.cluster", None)
    with pytest.raises(ImportError, match="scikit-learn"):
        pvt.make_clip_kmeans_selector(None)


class _FrameReader:
    """A decoded video's frames behind the VideoReader calls the selector
    makes (len, get_batch)."""

    def __init__(self, frames):
        self.frames = frames

    def __len__(self):
        return len(self.frames)

    def get_batch(self, idx):
        return self.frames[np.asarray(idx)]


def test_clip_kmeans_selector_matches_jax(clip_workdir):
    """The port's clip-kmeans selector on the JAX CLI's CLIP checkpoint
    picks JAX's frames from the same video under the same np.random seed:
    the pooled CLS features agree to fp32 rounding, KMeans(random_state=0)
    clusters them alike, and the draws come from the same stream."""
    pytest.importorskip("sklearn")
    sys.path.insert(0, REPO)
    import run_visual_tokenization as jcli

    rng = np.random.RandomState(11)
    base = rng.randint(0, 256, (4, 48, 64, 3)).astype(np.uint8)
    # 24 frames in 4 scenes of 6, each with its own small noise
    frames = np.concatenate([np.clip(b[None].astype(int) + rng.randint(-6, 7, (6, 48, 64, 3)),
                                     0, 255).astype(np.uint8) for b in base])
    jengine = jcli.build_clip_engine(dict(clip_workdir.config))
    pengine = pcli.build_clip_engine(dict(clip_workdir.config), device="cpu")
    pre = jvt.clip_preprocess_pil(frames[::2], 28)
    np.testing.assert_allclose(pengine.pool_frames(pre), np.asarray(jengine.pool_frames(pre)),
                               atol=1e-5, rtol=0)
    picks = []
    for make, engine in ((jvt.make_clip_kmeans_selector, jengine),
                         (pvt.make_clip_kmeans_selector, pengine)):
        np.random.seed(3)
        picks.append([int(i) for i in make(engine)(_FrameReader(frames), 4)])
    assert picks[0] == picks[1] and len(set(picks[1])) == 4
