"""The port's BLIP retrieval family (vidil_tpu_torch: med_forward's
self_fold, evals/retrieval.py, models/blip_retrieval.py, train/retrieval.py,
the train/eval CLIs and the train state's checkpoints) against the JAX
package's, on the CPU at a tiny size: ViT 32 wide, 2 layers, 4 heads at
32 px; MED 32 wide (64 for the fold), 2 layers. Inputs come from numpy
seeds and go through both packages. Tolerances: the PARITY.md bars (atol
3e-5 for MED outputs), unless a test states another and why.
"""

import functools
import json
import os
import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from vidil_tpu.config import MedConfig as JMed, ViTConfig as JViT
from vidil_tpu.models import blip as JB, med as JM
from vidil_tpu.models import blip_retrieval as JR
from vidil_tpu.train import retrieval as JTR
from vidil_tpu_torch.config import MedConfig, ViTConfig
from vidil_tpu_torch.evals import retrieval as ER
from vidil_tpu_torch.models import blip as B, blip_retrieval as R, convert, med as M
from vidil_tpu_torch.train import retrieval as TR
from vidil_tpu_torch.utils.synth import synth_tree

torch.set_num_threads(1)

MED_ATOL = 3e-5
VIT_KW = dict(image_size=32, patch_size=16, hidden_size=32, num_layers=2, num_heads=4)
MED_KW = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
              intermediate_size=64, max_position_embeddings=64, encoder_width=32)
EMBED, QUEUE = 8, 16


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _itm_np(vit, med, embed_dim, seed=1):
    """Random-normal BLIP-ITM weights (`vidil_tpu.models.testing`'s state
    dict through the JAX converter) as numpy: their similarities and ITM
    scores spread far beyond the packages' rounding, so ranks are stable."""
    from vidil_tpu.models import convert as jconvert
    from vidil_tpu.models.testing import make_blip_itm_ckpt

    return _np_tree(jconvert.convert_blip_itm(make_blip_itm_ckpt(vit, med, embed_dim, seed),
                                              vit, med))


def _synth_np(shapes, salt):
    """One set of weights for both packages: `utils/synth.py`'s sin fill in
    the JAX layout, as numpy (quicker than compiling JAX's random init)."""
    return jax.tree.map(lambda t: t.numpy(), synth_tree(shapes, "cpu", salt=salt))


# ---------------------------------------------------------------------------
# med_forward self_fold (mirrors tests/test_self_fold.py)
# ---------------------------------------------------------------------------

FOLD_MED = dict(vocab_size=1000, hidden_size=64, num_layers=2, num_heads=4,
                intermediate_size=128, encoder_width=64)
FOLD_VIT = dict(image_size=32, patch_size=16, hidden_size=64, num_layers=2, num_heads=4)


@pytest.fixture(scope="module")
def fold_params():
    jp = _synth_np(B.blip_itm_shapes(ViTConfig(**FOLD_VIT), MedConfig(**FOLD_MED), 32), 1.0)
    return jp, convert.from_jax_params(jp)


# JAX's side compiled as one program per case (eager dispatch compiles op by op)
_j_itm_scores = jax.jit(JB.blip_itm_scores, static_argnames=("med_cfg", "group_size", "self_fold"))
_j_med_forward = jax.jit(JM.med_forward, static_argnames=("cfg", "mode", "self_fold"))


def _fold_inputs(n_mem, G, L, Lk, seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(4, 900, size=(n_mem * G, L)).astype(np.int32)
    mask = np.ones((n_mem * G, L), np.int32)
    for i in range(0, n_mem * G, 3):  # ragged padding inside the folds
        mask[i, L - 2:] = 0
    return ids, mask, rng.randn(n_mem, Lk, 64).astype(np.float32) * 0.3


@pytest.mark.parametrize("group_size,fold", [(8, 2), (8, 4), (8, 8), (6, 4)])
def test_self_fold_grouped_is_bitwise_and_matches_jax(fold_params, group_size, fold):
    """Grouped ITM scores (6 texts with fold 4 clamp to gcd 2): the folded
    fp32 run equals the unfolded one bit for bit, and JAX's folded run
    within the MED bar."""
    jp, tp = fold_params
    ids, mask, mem = _fold_inputs(3, group_size, 12, 20, seed=group_size + fold)
    cfg = MedConfig(**FOLD_MED)
    base = B.blip_itm_scores(tp, _t(mem), _t(ids).long(), _t(mask).long(), cfg,
                             group_size=group_size)
    folded = B.blip_itm_scores(tp, _t(mem), _t(ids).long(), _t(mask).long(), cfg,
                               group_size=group_size, self_fold=fold)
    assert torch.equal(folded, base)
    want = _j_itm_scores(jp, mem, ids, mask, JMed(**FOLD_MED), group_size=group_size,
                         self_fold=fold)
    np.testing.assert_allclose(folded.numpy(), np.asarray(want), atol=MED_ATOL, rtol=0)


@pytest.mark.parametrize("mode", ["text", "ungrouped_cross"])
def test_self_fold_text_mode_and_ungrouped_cross(fold_params, mode):
    """Text mode folds (4 rows per sequence) bit for bit; a 1:1 text-memory
    cross-attention never folds. Both within the MED bar of JAX."""
    jp, tp = fold_params
    ids, mask, mem = _fold_inputs(8, 1, 12, 20, seed=3)
    kw = {} if mode == "text" else dict(encoder_hidden_states=_t(mem))
    jkw = {} if mode == "text" else dict(encoder_hidden_states=jnp.asarray(mem))
    med_mode = "text" if mode == "text" else "multimodal"
    cfg = MedConfig(**FOLD_MED)
    base = M.med_forward(tp["text_encoder"], _t(ids).long(), _t(mask).long(), cfg=cfg,
                         mode=med_mode, **kw)
    folded = M.med_forward(tp["text_encoder"], _t(ids).long(), _t(mask).long(), cfg=cfg,
                           mode=med_mode, self_fold=4, **kw)
    assert folded.shape == base.shape and torch.equal(folded, base)
    want = _j_med_forward(jp["text_encoder"], ids, mask, cfg=JMed(**FOLD_MED), mode=med_mode,
                          self_fold=4, **jkw)
    np.testing.assert_allclose(folded.numpy(), np.asarray(want), atol=MED_ATOL, rtol=0)


# ---------------------------------------------------------------------------
# the retrieval eval
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_build_t2v_buckets_matches_jax(seed):
    """Integer-identical buckets on fuzzed top-k (skewed: few videos get
    most texts), for several group sizes."""
    from vidil_tpu.evals.retrieval import build_t2v_buckets as jbuild

    rng = np.random.RandomState(seed)
    n_texts, n_videos, k = 40, 25, 6
    weights = rng.pareto(1.0, n_videos) + 0.01
    topk = np.stack([rng.choice(n_videos, k, replace=False, p=weights / weights.sum())
                     for _ in range(n_texts)])
    for G in (1, 3, 4, 8):
        got, want = ER.build_t2v_buckets(topk, 5, 5 + n_texts, G), jbuild(topk, 5, 5 + n_texts, G)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def _corpus(n=12, seed=4):
    from vidil_tpu.tokenizer import write_test_vocab

    rng = np.random.RandomState(seed)
    texts = [" ".join(f"tok{j}" for j in rng.randint(0, 100, size=rng.randint(3, 9)))
             for _ in range(n)]
    videos = rng.randn(n, 2, 32, 32, 3).astype(np.float32) * 0.2
    return texts, videos, write_test_vocab


def test_score_matrices_match_jax_fp32(tmp_path):
    """The evaluator end to end in fp32 (text and video features, the v2t
    rerank and the bucketed t2v rerank, 3 rerank blocks per direction over
    2 dispatches with padding): the -100 pattern identical, the scores
    within the MED bar, the itm_eval dicts equal."""
    from vidil_tpu.evals.retrieval import RetrievalEvaluator as JEval, itm_eval as jitm
    from vidil_tpu.tokenizer import BlipTokenizer as JTok
    from vidil_tpu_torch.tokenizer import BlipTokenizer

    med = dict(MED_KW, vocab_size=256)
    jp = _itm_np(JViT(**VIT_KW), JMed(**med), 16)
    texts, videos, write_vocab = _corpus()
    vocab = str(tmp_path / "vocab.txt")
    write_vocab(vocab, [f"tok{i}" for i in range(120)])
    kw = dict(k_test=5, rows_per_batch=4, blocks_per_dispatch=2)

    ev = JEval(jp, JViT(**VIT_KW), JMed(**med), JTok(vocab), dtype=jnp.float32, **kw)
    te, ti, ta = ev.compute_text_features(texts)
    vf, ve = ev.compute_video_features([videos[:8], videos[8:]])
    jv2t, jt2v = ev.score_matrices(vf, ve, te, ti, ta)

    pe = ER.RetrievalEvaluator(convert.from_jax_params(jp), ViTConfig(**VIT_KW), MedConfig(**med),
                               BlipTokenizer(vocab), dtype=torch.float32, **kw)
    te2, ti2, ta2 = pe.compute_text_features(texts)
    np.testing.assert_array_equal(ti2, ti)
    vf2, ve2 = pe.compute_video_features([videos[:8], videos[8:]])
    v2t, t2v = pe.score_matrices(vf2, ve2, te2, ti2, ta2)
    for got, want in ((v2t, jv2t), (t2v, jt2v)):
        np.testing.assert_array_equal(got == -100, want == -100)
        assert (got != -100).sum(axis=1).tolist() == [5] * len(texts)
        np.testing.assert_allclose(got, want, atol=MED_ATOL, rtol=0)
    ids = list(range(len(texts)))
    assert ER.itm_eval(v2t, t2v, ids, ids) == jitm(jv2t, jt2v, ids, ids)


def test_score_matrices_refuse_multiple_ranks(monkeypatch):
    """Several ranks without a process group cannot combine their rows:
    the eval raises instead of returning one rank's shard (the sharded
    eval itself: tests/test_torch_dist.py)."""
    pe = ER.RetrievalEvaluator({"vision_proj": {"kernel": torch.zeros(1)}}, None, None, None)
    monkeypatch.setattr(ER, "get_world_size", lambda: 2)
    with pytest.raises(RuntimeError, match="process group"):
        pe.score_matrices(None, np.zeros((1, 1)), np.zeros((1, 1)), None, None)


# ---------------------------------------------------------------------------
# the loss and the train step
# ---------------------------------------------------------------------------

def _batch(seed=0, B=4, N=2, L=10):
    rng = np.random.RandomState(seed)
    ids = rng.randint(4, 64, size=(B, L)).astype(np.int32)
    mask = np.ones((B, L), np.int32)
    mask[1, 7:] = 0
    ids[mask == 0] = 0
    enc = ids.copy()
    enc[:, 0] = 3
    return {"video": rng.randn(B, N, 32, 32, 3).astype(np.float32) * 0.1, "text_ids": ids,
            "enc_ids": enc, "text_mask": mask,
            "idx": np.asarray([0, 1, 1, 2][:B], np.int32)}  # two texts of video 1


@functools.lru_cache(maxsize=None)
def _jax_state():
    """JAX's train state (AdamW at lr 1e-3) over synthetic weights, made
    once, in one compiled program (eager dispatch compiles op by op)."""
    opt = JTR.make_optimizer(1e-3)
    params = _synth_np(B.blip_retrieval_shapes(ViTConfig(**VIT_KW), MedConfig(**MED_KW), EMBED),
                       3.0)
    params["temp"] = np.asarray(0.07, np.float32)
    state = jax.jit(lambda key, p: JTR.create_train_state(
        key, JViT(**VIT_KW), JMed(**MED_KW), opt, embed_dim=EMBED, queue_size=QUEUE,
        params=p))(jax.random.PRNGKey(1), params)
    return opt, state


@jax.jit
def _jax_retrieval_negatives(params, batch, rng):
    """The draws JAX's retrieval_loss makes inside, reproduced from its
    split key: categorical over the masked log-softmax of the in-batch
    similarities."""
    vit, med = JViT(**VIT_KW), JMed(**MED_KW)
    temp = jnp.clip(params["temp"], 0.001, 0.5)
    _, vfeat = JR._video_features(params, jnp.asarray(batch["video"]), vit)
    tfeat = JR._text_features(params, jnp.asarray(batch["text_ids"]),
                              jnp.asarray(batch["text_mask"]), med)
    idx = jnp.asarray(batch["idx"]).reshape(-1, 1)
    same = idx == idx.T
    logw_i2t = jnp.where(same, -1e9, jax.nn.log_softmax((vfeat @ tfeat.T) / temp, axis=1))
    logw_t2i = jnp.where(same, -1e9, jax.nn.log_softmax((tfeat @ vfeat.T) / temp, axis=1))
    k1, k2 = jax.random.split(rng)
    return (jax.random.categorical(k1, logw_t2i, axis=1),
            jax.random.categorical(k2, logw_i2t, axis=1))


def jax_retrieval_negatives(params, batch, rng):
    return tuple(np.array(n) for n in _jax_retrieval_negatives(params, batch, rng))


def _port_state(jstate, lr=1e-4):
    carried = convert.from_jax_train_state(_np_tree(jstate))
    return TR.create_train_state(carried["params"], lr, params_m=carried["params_m"],
                                 queue=carried["queue"], device="cpu")


def _negatives(n):
    return tuple(torch.from_numpy(np.array(a)).long() for a in n)


def _grads(state):
    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node.grad
    return convert.to_jax_params(walk(state.params))


def test_two_steps_match_jax():
    """fp32, the same weights, queue and batches, JAX's negatives carried
    across each step, AdamW at lr 1e-3. Step 1: the losses at rtol 1e-5;
    every gradient leaf (JAX's is its first Adam moment over 1 - b1) at
    atol 1e-5 of its leaf's scale, at least 1e-6 of the model's largest
    (the attention twins and XLA sum in another order, and the key biases'
    gradients are rounding noise). Both steps: the queues' contents within
    the MED bar, their idx slots and pointers equal. Step 2: the momentum
    towers at atol 1e-6 (a few fp32 ulps at the weights' scale: both
    libraries round the update's parts in another order)."""
    opt, jstate = _jax_state()
    state = _port_state(jstate, lr=1e-3)
    j_step = jax.jit(JTR.make_retrieval_train_step(JViT(**VIT_KW), JMed(**MED_KW), opt))
    step = TR.make_retrieval_train_step(ViTConfig(**VIT_KW), MedConfig(**MED_KW))
    for i in range(2):
        batch, rng = _batch(10 + i), jax.random.PRNGKey(20 + i)
        negatives = jax_retrieval_negatives(jstate.params, batch, rng)
        jstate, jm = j_step(jstate, batch, 0.4, rng)
        state, m = step(state, batch, 0.4, None, negatives=_negatives(negatives))
        if i == 0:
            for key in ("loss_ita", "loss_itm", "loss"):
                np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-5, err_msg=key)
            mu = _np_tree(jstate.opt_state.inner_state[0].mu)
            got = dict(jax.tree_util.tree_leaves_with_path(_grads(state)))
            want = {p: w / np.float32(0.1) for p, w in jax.tree_util.tree_leaves_with_path(mu)}
            assert got.keys() == want.keys() and len(got) > 40
            g_max = max(np.abs(w).max() for w in want.values())
            for path, w in want.items():
                np.testing.assert_allclose(got[path], w, rtol=0,
                                           atol=1e-5 * max(np.abs(w).max(), 1e-6 * g_max),
                                           err_msg=jax.tree_util.keystr(path))
        assert state.queue.ptr == int(jstate.queue.ptr) == 4 * (i + 1)
        for name in ("image", "text"):
            np.testing.assert_allclose(getattr(state.queue, name).numpy(),
                                       np.asarray(getattr(jstate.queue, name)),
                                       atol=MED_ATOL, rtol=0)
        np.testing.assert_array_equal(state.queue.idx.numpy(), np.asarray(jstate.queue.idx))
    assert state.step == int(jstate.step) == 2
    for a, b in zip(jax.tree.leaves(convert.to_jax_params(state.params_m)),
                    jax.tree.leaves(_np_tree(jstate.params_m))):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)


def test_sampled_negatives_follow_the_masked_distribution():
    """The port's own draws (Gumbel-max from a torch.Generator): a text's
    own video is never drawn (-1e9), and over many draws the frequencies
    follow softmax of the log-weights (3 sigma of a binomial)."""
    logw = torch.log_softmax(torch.tensor([[0.0, 1.0, 2.0, -1.0]]), dim=1)
    logw = logw.masked_fill(torch.tensor([[False, True, False, False]]), -1e9)
    g = torch.Generator().manual_seed(0)
    n = 20000
    draws = R.sample_categorical(g, logw.expand(n, 4).contiguous())
    freq = torch.bincount(draws, minlength=4).double() / n
    p = torch.softmax(logw.double(), dim=1)[0]
    assert freq[1] == 0
    assert torch.all((freq - p).abs() <= 3 * torch.sqrt(p * (1 - p) / n) + 1e-12)


def test_step_runs_with_its_own_draws_and_defaults_to_cuda():
    _, jstate = _jax_state()
    state = _port_state(jstate)
    step = TR.make_retrieval_train_step(ViTConfig(**VIT_KW), MedConfig(**MED_KW))
    from vidil_tpu_torch.utils.seeding import make_generator

    state, m = step(state, _batch(3), 0.4, make_generator(42, 0))
    assert np.isfinite(float(m["loss"])) and 0.001 <= state.params["temp"].item() <= 0.5
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TR.create_train_state(convert.from_jax_train_state(_np_tree(jstate))["params"], 1e-4)


def test_train_state_round_trips_through_jax_load_train_state(tmp_path):
    """save_train_state writes the JAX package's leaf layout: JAX's
    load_train_state restores it into its own template, and the arrays
    are the port's (params, momentum towers, queues, AdamW moments,
    step); load_train_state here reads it back bit for bit."""
    from vidil_tpu.utils.checkpoint import load_train_state as j_load
    from vidil_tpu_torch.utils.checkpoint import load_train_state, save_train_state

    _, jstate = _jax_state()
    state = _port_state(jstate)
    step = TR.make_retrieval_train_step(ViTConfig(**VIT_KW), MedConfig(**MED_KW))
    state, _ = step(state, _batch(4), 0.4, torch.Generator().manual_seed(1))
    path = str(tmp_path / "last")
    save_train_state(path, state, meta={"epoch": 0})
    restored, meta = j_load(path, jstate)
    assert meta == {"epoch": 0} and int(restored.step) == 1 and int(restored.queue.ptr) == 4
    for a, b in zip(jax.tree.leaves(restored.params),
                    jax.tree.leaves(convert.to_jax_params(state.params))):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jax.tree.leaves(restored.params_m),
                    jax.tree.leaves(convert.to_jax_params(state.params_m))):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(restored.queue.image, state.queue.image.numpy())
    mu = restored.opt_state.inner_state[0].mu
    exp_avg = {n: state.optimizer.state[p]["exp_avg"]
               for n, p in convert.named_leaves(state.params)}
    np.testing.assert_array_equal(mu["itm_head"]["kernel"], exp_avg["itm_head/kernel"].numpy())
    assert float(restored.opt_state.hyperparams["learning_rate"]) == pytest.approx(1e-4)

    fresh = _port_state(jstate)
    fresh, _ = load_train_state(path, fresh)
    assert fresh.step == 1 and fresh.queue.ptr == 4
    assert torch.equal(fresh.queue.text, state.queue.text)
    for (_, a), (_, b) in zip(convert.named_leaves(fresh.params),
                              convert.named_leaves(state.params)):
        assert torch.equal(a, b)
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(fresh.optimizer.state[a][key], state.optimizer.state[b][key])


# ---------------------------------------------------------------------------
# the CLIs, on synthetic mp4s (the workspace of tests/test_cli_train.py)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    cv2 = pytest.importorskip("cv2")
    from vidil_tpu.models.testing import make_blip_itm_ckpt, save_torch_ckpt
    from vidil_tpu.tokenizer import BlipTokenizer, write_test_vocab

    root = tmp_path_factory.mktemp("torch_retrieval_cli")
    videos = root / "videos"
    videos.mkdir()
    rng = np.random.RandomState(0)
    for vi in range(4):
        w = cv2.VideoWriter(str(videos / f"video{vi}.mp4"), cv2.VideoWriter_fourcc(*"mp4v"),
                            10, (64, 48))
        base = rng.randint(0, 256, (48, 64, 3))
        for i in range(20):
            w.write(((base + i * 7 + vi * 60) % 256).astype(np.uint8))
        w.release()
    words = ["a", "dog", "cat", "man", "runs", "sings", "on", "the", "grass", "stage"]
    captions = ["a dog runs on the grass", "a man sings on the stage", "a cat runs",
                "the man runs on the grass"]
    for name, n_per_video in (("train", 2), ("val", 1), ("test", 1)):
        with open(root / f"{name}.jsonl", "w") as f:
            for vi in range(4):
                for j in range(n_per_video):
                    f.write(json.dumps({"caption": captions[(vi + j) % 4],
                                        "clip_name": f"video{vi}"}) + "\n")
    vocab = str(root / "vocab.txt")
    write_test_vocab(vocab, words)
    med_path = str(root / "med_config.json")
    with open(med_path, "w") as f:
        json.dump({"vocab_size": BlipTokenizer(vocab).vocab_size, "hidden_size": 32,
                   "num_hidden_layers": 2, "num_attention_heads": 4,
                   "intermediate_size": 64, "max_position_embeddings": 64,
                   "encoder_width": 32, "add_cross_attention": True}, f)
    ckpt = str(root / "itm.pth")
    save_torch_ckpt(make_blip_itm_ckpt(JViT(**VIT_KW), JMed.from_json(med_path),
                                       embed_dim=256), ckpt)
    config = dict(
        dataset="msrvtt", train_video_root=str(videos), train_ann_jsonl=str(root / "train.jsonl"),
        eval_video_root=str(videos), val_ann_jsonl=str(root / "val.jsonl"),
        test_ann_jsonl=str(root / "test.jsonl"), num_frm_train=2, num_frm_test=2,
        frm_sampling_strategy="uniform", height=None, width=None, start_time=None,
        end_time=None, fps=-1, video_representation="concat_frame", pretrained=ckpt,
        bert_vocab=vocab, vit="tiny",
        vit_config={k: v for k, v in VIT_KW.items() if k != "image_size"},
        med_config=med_path, batch_size_train=4, batch_size_train_tpu=8, batch_size_test=2,
        init_lr=1e-5, image_size=32, queue_size=18, alpha=0.4, k_test=3,
        negative_all_rank=True, weight_decay=0.05, min_lr=0, max_epoch=1)
    return types.SimpleNamespace(root=root, config=config)


def _args(out_dir, evaluate=False):
    os.makedirs(out_dir, exist_ok=True)
    return types.SimpleNamespace(output_dir=out_dir, evaluate=evaluate, seed=42, world_size=1,
                                 dist_url="env://", distributed=False, device="cpu")


R_KEYS = {"txt_r1", "txt_r5", "txt_r10", "txt_r_mean", "vid_r1", "vid_r5", "vid_r10",
          "vid_r_mean", "vid_mdR", "r_mean"}


def test_train_cli_logs_checkpoints_and_resumes(workdir, capsys):
    """One epoch on the CPU: log.txt with the val/test metric keys,
    checkpoint_best.npz that the JAX package's load_checkpoint reads with
    the JAX model's key set and shapes, checkpoint_last.npz that its
    load_train_state reads; resume continues from the saved step."""
    from vidil_tpu.utils.checkpoint import load_checkpoint as j_load
    from vidil_tpu.utils.checkpoint import load_train_state as j_load_state
    from vidil_tpu_torch import train_retrieval_video as cli

    out = str(workdir.root / "out")
    state = cli.main(_args(out), dict(workdir.config))
    assert "ignoring batch_size_train_tpu=8" in capsys.readouterr().out
    assert state.step == 2 and state.queue.ptr == 8 and state.queue.image.shape == (256, 16)
    log = [json.loads(line) for line in open(os.path.join(out, "log.txt"))]
    assert set(log[-1]) == ({f"val_{k}" for k in R_KEYS} | {f"test_{k}" for k in R_KEYS}
                            | {"epoch", "best_epoch"})
    assert log[-1]["epoch"] == 0 and 0 <= log[-1]["val_r_mean"] <= 100

    med = JMed.from_json(workdir.config["med_config"])
    want = jax.eval_shape(lambda: JR.init_retrieval_params(jax.random.PRNGKey(0),
                                                           JViT(**VIT_KW), med))
    shapes = lambda t: {jax.tree_util.keystr(p): np.shape(x)
                        for p, x in jax.tree_util.tree_leaves_with_path(t)}
    # 4 videos: every r@10 is 100, so val r_mean > 0 saves epoch 0 as the best
    params, meta = j_load(os.path.join(out, "checkpoint_best.npz"))
    assert meta == {"epoch": 0} and shapes(params) == shapes(want)
    opt = JTR.make_optimizer(1e-5)
    template = jax.eval_shape(lambda: JTR.create_train_state(
        jax.random.PRNGKey(0), JViT(**VIT_KW), med, opt, queue_size=16))
    restored, meta = j_load_state(os.path.join(out, "checkpoint_last.npz"), template)
    assert meta == {"epoch": 0} and int(restored.step) == 2 and int(restored.queue.ptr) == 8

    resumed = cli.main(_args(str(workdir.root / "resumed")),
                       dict(workdir.config, max_epoch=2,
                            resume=os.path.join(out, "checkpoint_last.npz")))
    assert resumed.step == 4 and resumed.queue.ptr == 0
    log = [json.loads(line) for line in open(workdir.root / "resumed" / "log.txt")]
    assert [entry["epoch"] for entry in log] == [1]


def test_eval_cli_matches_jax_cli(workdir):
    """--evaluate on the same .pth (bf16 on both sides, as both CLIs run):
    evaluate.txt of the port equals the JAX CLI's. The corpus's ranks do
    not hinge on bf16 rounding: the port's fp32 evaluation of the val
    split gives the same metrics as its bf16 one."""
    import train_retrieval_video as jcli
    from vidil_tpu_torch import train_retrieval_video as cli
    from vidil_tpu_torch.data.datasets import RetrievalEvalDataset

    jout, pout = str(workdir.root / "jeval"), str(workdir.root / "peval")
    jcli.main(_args(jout, evaluate=True), dict(workdir.config))
    cli.main(_args(pout, evaluate=True), dict(workdir.config))
    jlog = [json.loads(line) for line in open(os.path.join(jout, "evaluate.txt"))]
    plog = [json.loads(line) for line in open(os.path.join(pout, "evaluate.txt"))]
    assert plog == jlog and set(plog[0]) >= {"val_r_mean", "test_r_mean"}
    assert not os.path.exists(os.path.join(pout, "checkpoint_last.npz"))

    cfg = workdir.config
    params, tok, vit, med = cli.build(cfg)
    val = RetrievalEvalDataset(cfg["eval_video_root"], cfg["val_ann_jsonl"], num_frm=2,
                               max_img_size=32)
    fp32 = cli.run_eval(params, val, tok, vit, med, cfg, dtype=torch.float32)
    assert {f"val_{k}": v for k, v in fp32.items()} == {
        k: v for k, v in plog[0].items() if k.startswith("val_")}


def test_cli_flags_default_to_cuda_and_refuse_mesh_keys(workdir):
    from vidil_tpu_torch import train_retrieval_video as cli

    args = cli.parse_args([])
    assert args.device == "cuda" and not args.evaluate
    args = cli.parse_args(["--config", "c.yaml"], evaluate_flag=False,
                          default_output="output/retrieval_eval")
    assert args.evaluate and args.output_dir == "output/retrieval_eval"
    # data_parallel x model_parallel must be the launch's world (one rank
    # here): a grid the world does not fit raises ValueError; an unknown
    # optimizer sharding is refused
    for key, value, error in (("data_parallel", 2, ValueError),
                              ("optimizer_sharding", "zero3", ValueError),
                              ("model_parallel", 2, ValueError)):
        with pytest.raises(error, match=key):
            cli.main(_args(str(workdir.root / "refused")), dict(workdir.config, **{key: value}))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(types.SimpleNamespace(**dict(vars(_args(str(workdir.root / "nocuda"))),
                                                  device="cuda")), dict(workdir.config))
