"""The port's multi-process runtime (vidil_tpu_torch.utils.dist, utils.io,
parallel/) on the CPU: one launch of two gloo ranks in fresh subprocesses
(`parallel.dryrun.run_ranks`, env rendezvous on a free port) runs every
phase below, then each test reads its part:

* rendezvous, rank-gated print, barrier, `merge_rank_jsons` byte-identical
  to one process's merge;
* the collectives' semantics, as tests/test_collectives.py states them for
  the JAX package: the gathered forward is the concatenation, the gradient
  is the all-reduced cotangent's own slice, `concat_all_gather` blocks the
  gradient, `psum` / `pmean`;
* `MetricLogger`'s global average over the two ranks;
* the sharded retrieval eval against the JAX package's one-process
  `RetrievalEvaluator.score_matrices` at atol 1e-4 (its own bar in
  tests/test_multiprocess_dist.py);
* the CapFilt and visual-tokenization CLIs' merged files byte-identical to
  one process's (fp32, synthetic weights; each rank's shard a whole number
  of chunks), and the caption trainer CLI over the two ranks;
* a ZeRO-1 retrieval step equal to the plain AdamW step, and its saved
  train state read by the JAX package's `load_train_state`.

Also here, without the launch: the two faults this slice fixed against the
reference (ViTConfig.use_flash; the parameters CapFiltEngine,
blip_generate_ids and convert_med rejected), each held to the JAX package
in fp32.
"""

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
from vidil_tpu_torch.config import MedConfig, ViTConfig
from vidil_tpu_torch.models import convert
from vidil_tpu_torch.parallel import dryrun as D
from vidil_tpu_torch.utils.checkpoint import save_checkpoint

torch.set_num_threads(1)

WORLD = 2
VIT_KW = dict(image_size=32, patch_size=16, hidden_size=32, num_layers=2, num_heads=4)
MED_KW = dict(vocab_size=256, hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
              max_position_embeddings=64, encoder_width=32)
RET_MED_KW = dict(MED_KW, vocab_size=64)
EMBED, QUEUE = 8, 16


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _eval_inputs(spec, root):
    """The eval corpus (12 videos x 12 texts, k_test 5) through the JAX
    evaluator (its scores are the reference) and the port's features for
    the ranks."""
    from vidil_tpu.evals.retrieval import RetrievalEvaluator as JEval
    from vidil_tpu.models import convert as jconvert
    from vidil_tpu.models.testing import make_blip_itm_ckpt
    from vidil_tpu.tokenizer import BlipTokenizer as JTok, write_test_vocab
    from vidil_tpu_torch.evals.retrieval import RetrievalEvaluator
    from vidil_tpu_torch.tokenizer import BlipTokenizer

    jv, jm = JViT(**VIT_KW), JMed(**MED_KW)
    jp = _np_tree(jconvert.convert_blip_itm(make_blip_itm_ckpt(jv, jm, 16, 1), jv, jm))
    rng = np.random.RandomState(4)
    texts = [" ".join(f"tok{j}" for j in rng.randint(0, 100, size=rng.randint(3, 9)))
             for _ in range(12)]
    videos = rng.randn(12, 2, 32, 32, 3).astype(np.float32) * 0.2
    vocab = os.path.join(root, "eval_vocab.txt")
    write_test_vocab(vocab, [f"tok{i}" for i in range(120)])
    kw = dict(k_test=5, rows_per_batch=2, blocks_per_dispatch=2)
    ev = JEval(jp, jv, jm, JTok(vocab), dtype=jnp.float32, **kw)
    te, ti, ta = ev.compute_text_features(texts)
    vf, ve = ev.compute_video_features([videos[:8], videos[8:]])
    want = ev.score_matrices(vf, ve, te, ti, ta)

    tp = convert.from_jax_params(jp)
    pe = RetrievalEvaluator(tp, ViTConfig(**VIT_KW), MedConfig(**MED_KW), BlipTokenizer(vocab),
                            dtype=torch.float32, **kw)
    te2, ti2, ta2 = pe.compute_text_features(texts)
    vf2, ve2 = pe.compute_video_features([videos[:8], videos[8:]])
    save_checkpoint(os.path.join(spec, "eval_params.npz"), tp)
    np.savez(os.path.join(spec, "eval_features.npz"), video_feats=vf2.numpy(),
             video_embeds=ve2, text_embeds=te2, text_ids=ti2, text_atts=ta2)
    return {"name": "eval", "kind": "eval", "vit": VIT_KW, "med": MED_KW, "k_test": 5,
            "rows_per_batch": 2}, want


def _ret_batch(seed=0, B=4, N=2, L=10):
    rng = np.random.RandomState(seed)
    ids = rng.randint(4, 64, size=(B, L)).astype(np.int64)
    mask = np.ones((B, L), np.int64)
    mask[1, 7:] = 0
    ids[mask == 0] = 0
    enc = ids.copy()
    enc[:, 0] = 3
    return {"video": rng.randn(B, N, 32, 32, 3).astype(np.float32) * 0.1, "text_ids": ids,
            "enc_ids": enc, "text_mask": mask, "idx": np.asarray([0, 1, 1, 2][:B], np.int64)}


def _zero1_inputs(spec):
    """A retrieval train state of the JAX package (synthetic weights, its
    queue), carried into the port's inputs; the same step with and without
    ZeRO-1, both saving their train state."""
    from vidil_tpu.train import retrieval as JTR
    from vidil_tpu_torch.models.blip import blip_retrieval_shapes
    from vidil_tpu_torch.utils.synth import synth_tree

    vit, med = ViTConfig(**VIT_KW), MedConfig(**RET_MED_KW)
    params = jax.tree.map(lambda t: t.numpy(),
                          synth_tree(blip_retrieval_shapes(vit, med, EMBED), "cpu", salt=3.0))
    params["temp"] = np.asarray(0.07, np.float32)
    opt = JTR.make_optimizer(1e-4)
    jstate = jax.jit(lambda key, p: JTR.create_train_state(
        key, JViT(**VIT_KW), JMed(**RET_MED_KW), opt, embed_dim=EMBED, queue_size=QUEUE,
        params=p))(jax.random.PRNGKey(1), params)
    carried = convert.from_jax_train_state(_np_tree(jstate))
    save_checkpoint(os.path.join(spec, "ret_params.npz"), carried["params"])
    save_checkpoint(os.path.join(spec, "ret_params_m.npz"), carried["params_m"])
    q = carried["queue"]
    np.savez(os.path.join(spec, "ret_queue.npz"), image=q.image.numpy(), text=q.text.numpy(),
             idx=q.idx.numpy(), ptr=np.asarray(q.ptr))
    np.savez(os.path.join(spec, "ret_batch.npz"), **_ret_batch())
    base = {"kind": "retrieval", "inputs": "ret", "vit": VIT_KW, "med": RET_MED_KW,
            "lr": 1e-4, "alpha": 0.4, "gen_seed": 5, "save_state": True}
    return [dict(base, name="ret_plain"), dict(base, name="ret_zero1", zero1=True)], jstate


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_dist"))
    spec, many, one = (os.path.join(root, d) for d in ("spec", "many", "one"))
    os.makedirs(spec)
    eval_phase, eval_want = _eval_inputs(spec, root)
    zero_phases, jstate = _zero1_inputs(spec)
    # 3 videos, 2 a chunk: rank 0 takes 2 (one chunk), rank 1 the third;
    # the caption trainer at a global batch of 2
    cli_phases = D.write_cli_workspace(os.path.join(root, "ws"), 3, 2, WORLD)
    D.write_spec(spec, [{"name": "runtime", "kind": "runtime"}, eval_phase, *zero_phases,
                        *cli_phases])
    results = D.run_ranks(WORLD, spec, many, timeout=300)
    for rank, (rc, out, err) in enumerate(results):
        assert rc == 0, f"rank {rank} exited {rc}\n{out[-3000:]}\n{err[-3000:]}"
    for ph in cli_phases[:2]:  # the one-process runs of the two inference CLIs
        D._cli_phase(spec, one, ph)
    recs = [json.load(open(os.path.join(many, f"runtime_rank{r}.json"))) for r in range(WORLD)]
    return types.SimpleNamespace(root=root, spec=spec, many=many, one=one, recs=recs,
                                 eval_want=eval_want, jstate=jstate, outputs=results)


# ---------------------------------------------------------------------------
# rendezvous, print gating, barrier, merge
# ---------------------------------------------------------------------------

def test_rendezvous_rank_gating_and_barrier(run):
    """Each rank joined the gloo group from RANK / WORLD_SIZE / MASTER_*;
    only rank 0 prints unless ``force=True``; both passed the barrier."""
    assert [(r["rank"], r["world"], r["backend"]) for r in run.recs] == [
        (0, 2, "gloo"), (1, 2, "gloo")]
    assert run.recs[0]["printed"] == ["gated line", "forced line"]
    assert run.recs[1]["printed"] == ["forced line"]


def test_merge_rank_jsons_byte_identical_to_one_process(run, tmp_path):
    """Rank 0's merge of the two ranks' tmp files, byte for byte the file
    one process writes from the same items; tmp/ removed; rank 1 got None."""
    from vidil_tpu_torch.utils.io import merge_rank_jsons, save_json

    assert run.recs[0]["merged_keys"] == ["k0_0", "k0_1", "k1_0", "k1_1"]
    assert run.recs[1]["merged_keys"] is None
    assert not os.path.exists(os.path.join(run.many, "merge_tmp"))
    tmp = tmp_path / "tmp"
    tmp.mkdir()
    save_json(str(tmp / "0.json"), {f"k{r}_{i}": i for r in range(2) for i in range(2)})
    merge_rank_jsons(str(tmp), str(tmp_path / "merged.json"))
    assert (tmp_path / "merged.json").read_bytes() == open(
        os.path.join(run.many, "merged.json"), "rb").read()


# ---------------------------------------------------------------------------
# the collectives (tests/test_collectives.py's semantics)
# ---------------------------------------------------------------------------

def test_all_gather_with_grad_forward_is_the_concatenation(run):
    xs = [np.arange(6, dtype=np.float32).reshape(3, 2) + 10 * r for r in range(WORLD)]
    for rec in run.recs:
        np.testing.assert_array_equal(rec["gathered"], np.concatenate(xs))


def test_all_gather_with_grad_backward_is_all_reduce_then_slice(run):
    """Rank r weights the gathered (6, 2) tensor by arange * (r + 1); the
    cotangents all-reduce to arange * 3 and each rank keeps its 3 rows."""
    total = sum(np.arange(12, dtype=np.float32).reshape(6, 2) * (r + 1) for r in range(WORLD))
    for rec in run.recs:
        r = rec["rank"]
        np.testing.assert_array_equal(rec["grad"], total[3 * r:3 * r + 3])


def test_concat_all_gather_blocks_the_gradient(run):
    for rec in run.recs:
        assert rec["concat_requires_grad"] is False
        np.testing.assert_array_equal(rec["concat"], rec["gathered"])


def test_psum_and_pmean(run):
    for rec in run.recs:
        assert rec["psum"] == [2.0, 3.0]  # [1 + 1, 1 + 2]
        assert rec["pmean"] == [1.0]  # (0 + 2) / 2
        assert rec["psum_int"] == [3]


def test_metric_logger_global_avg_over_two_ranks(run):
    """Rank 0 logs 0; rank 1 logs 10 and 11: count 3, total 21."""
    for rec in run.recs:
        assert rec["count"] == 3 and rec["global_avg"] == pytest.approx(7.0, abs=1e-12)


# ---------------------------------------------------------------------------
# the sharded retrieval eval, the inference CLIs, ZeRO-1
# ---------------------------------------------------------------------------

def test_sharded_retrieval_eval_matches_jax(run):
    """Each rank reranked its rows of both directions; the combined
    matrices equal the JAX package's one-process scores at atol 1e-4 (its
    bar for the multi-process eval), with the same -100 pattern."""
    got = np.load(os.path.join(run.many, "eval.npz"))
    for name, want in zip(("v2t", "t2v"), run.eval_want):
        np.testing.assert_array_equal(got[name] == -100, want == -100)
        assert ((got[name] != -100).sum(axis=1) == 5).all()
        np.testing.assert_allclose(got[name], want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("phase,files", [
    ("capfilt", ("video_text_Cap.json", "video_text_CapFilt.json")),
    ("vistok", ("visual_tokens.json",)),
])
def test_inference_cli_byte_identical_to_one_process(run, phase, files):
    for name in files:
        got = open(os.path.join(run.many, phase, name), "rb").read()
        assert got == open(os.path.join(run.one, phase, name), "rb").read(), name
        assert len(json.loads(got)) == 3
    assert not os.path.exists(os.path.join(run.many, phase, "tmp"))


def test_caption_trainer_cli_over_two_ranks(run):
    """The caption trainer CLI over two ranks (each its row of every global
    batch of 2, its half of the val and test videos): one epoch logged by
    rank 0 with the caption metrics, the merged result files holding every
    video once, and checkpoints the JAX package's `load_checkpoint` reads."""
    from vidil_tpu.utils.checkpoint import load_checkpoint as j_load

    out = os.path.join(run.many, "train_caption")
    log = [json.loads(line) for line in open(os.path.join(out, "log.txt"))]
    assert len(log) == 1 and log[0]["epoch"] == 0 and "test_CIDEr" in log[0]
    for split in ("val", "test"):
        result = json.load(open(os.path.join(out, "result", f"{split}_epoch0.json")))
        assert sorted(r["video_id"] for r in result) == ["video0", "video1", "video2"]
    params, _ = j_load(os.path.join(out, "checkpoint_best"))
    assert params["visual_encoder"]["patch_embed"]["kernel"].shape == (768, 32)


def test_zero1_step_equals_plain_adamw(run):
    """ZeRO-1 over two ranks: each rank updates its partition's moments
    from the summed gradients and broadcasts; the parameters, gradients,
    losses and queues equal the plain AdamW step's bit for bit, and so do
    the saved train states (the moments consolidated on rank 0); each
    state file loads back into a fresh state of its kind."""
    plain = np.load(os.path.join(run.many, "ret_plain.npz"))
    zero = np.load(os.path.join(run.many, "ret_zero1.npz"))
    assert set(plain.files) == set(zero.files)
    for k in plain.files:
        np.testing.assert_array_equal(zero[k], plain[k], err_msg=k)
    a = np.load(os.path.join(run.many, "ret_plain_state.npz"))
    b = np.load(os.path.join(run.many, "ret_zero1_state.npz"))
    assert set(a.files) == set(b.files) and len(a.files) > 100
    for k in a.files:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    # load_train_state put every moment back (under ZeRO-1 into its owner
    # rank's partition), as the consolidated moments show
    assert bool(zero["reload_equal"]) and bool(plain["reload_equal"])


def test_zero1_state_is_read_by_jax_load_train_state(run):
    """The ZeRO-1 step's state file in the JAX package's leaf layout: its
    `load_train_state` restores it into its own template with the step's
    parameters and a non-zero first moment for every weight."""
    from vidil_tpu.utils.checkpoint import load_train_state as j_load

    restored, _ = j_load(os.path.join(run.many, "ret_zero1_state"), run.jstate)
    assert int(restored.step) == 1 and int(restored.queue.ptr) == 4
    got = np.load(os.path.join(run.many, "ret_zero1.npz"))
    flat = {k[6:]: got[k] for k in got.files if k.startswith("param/")}
    from vidil_tpu_torch.utils.checkpoint import _flatten

    for path, arr in _flatten(_np_tree(restored.params)).items():
        np.testing.assert_array_equal(arr, flat[path], err_msg=path)
    mu = _flatten(_np_tree(restored.opt_state.inner_state[0].mu))
    assert np.abs(mu["itm_head/kernel"]).max() > 0
    assert np.abs(mu["visual_encoder/patch_embed/kernel"]).max() > 0


# ---------------------------------------------------------------------------
# launch rules
# ---------------------------------------------------------------------------

def test_nccl_refuses_more_ranks_than_gpus(monkeypatch):
    """NCCL cannot put two ranks on one GPU: a rank without its own GPU
    raises with the reason, before any process group exists."""
    from vidil_tpu_torch.utils import dist

    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="one GPU per rank"):
        dist.init_distributed_mode(backend="nccl", device="cuda")
    assert not dist.is_dist_avail_and_initialized()


def test_data_axis_rules():
    """data_parallel: absent, 0 or true take the world (one rank here); N
    times model_parallel must equal it, and a grid the world does not fit
    raises ValueError naming both sizes. Rank r's rows of a
    batch of B are [r B / N, (r + 1) B / N); without a process group
    `rank_batch` gives the whole batch, a VQA batch's answers re-indexed
    as they came."""
    from vidil_tpu_torch.parallel import mesh

    for cfg in ({}, {"data_parallel": 0}, {"data_parallel": True}, {"data_parallel": 1},
                {"model_parallel": 1}):
        grid = mesh.grid_from_config(cfg)
        assert (grid.data, grid.model, grid.data_parallel) == (1, 1, False)
    with pytest.raises(ValueError, match="data_parallel 2 x model_parallel 1"):
        mesh.grid_from_config({"data_parallel": 2})
    with pytest.raises(ValueError, match="model_parallel 2"):
        mesh.grid_from_config({"model_parallel": 2})
    with pytest.raises(ValueError, match="data_parallel 1 x model_parallel 2"):
        mesh.grid_from_config({"data_parallel": 1, "model_parallel": 2})
    assert mesh.local_rows(8, 1, 2) == slice(4, 8)
    with pytest.raises(AssertionError):
        mesh.local_rows(6, 0, 4)
    batch = {"video": np.arange(4), "question_ids": np.arange(4), "question_mask": np.arange(4),
             "answer_ids": np.arange(6), "answer_mask": np.arange(6), "weights": np.arange(6),
             "answer_question_index": np.array([0, 1, 1, 2, 3, 3])}
    whole = D.rank_batch(batch, vqa=True)
    assert whole.keys() == batch.keys()
    for k in batch:
        np.testing.assert_array_equal(whole[k], batch[k], err_msg=k)


class _Items:
    """A dataset of `n` items shaped as the train sets' (a video array, a
    caption, an id) or the VQA set's (a video, a question, its ragged
    answers and their weights)."""

    def __init__(self, n, vqa):
        self.n, self.vqa = n, vqa

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        video = np.full((2, 4, 4, 3), i, np.float32)
        if self.vqa:
            answers = [f"answer {i} {j}" for j in range(1 + i % 3)]
            return video, f"question {i}", answers, [0.5 / len(answers)] * len(answers)
        return video, f"caption {i}", i


@pytest.mark.parametrize("vqa", [False, True])
def test_loader_rank_rows_concatenate_to_global_batch(vqa):
    """The trainers' split: over two ranks (`rank_rows`, the same shuffle)
    each rank's batches, concatenated in rank order, are the one process's
    global batches, epoch by epoch; the VQA batches through `vqa_collate`
    (the ragged answers follow their questions). A rank's rows need
    drop_last, so that every rank takes as many steps."""
    from vidil_tpu_torch.data.datasets import PrefetchLoader, vqa_collate

    kw = dict(batch_size=4, shuffle=True, drop_last=True, num_workers=2, seed=3,
              collate_fn=vqa_collate if vqa else None)
    data = _Items(11, vqa)
    loaders = [PrefetchLoader(data, **kw)] + [PrefetchLoader(data, rank_rows=(r, 2), **kw)
                                              for r in range(2)]
    for epoch in range(2):
        for loader in loaders:
            loader.set_epoch(epoch)
        whole, *ranks = ([list(b) for b in loader] for loader in loaders)
        assert len(whole) == 2 and all(len(r) == len(whole) for r in ranks)
        for b, parts in zip(whole, zip(*ranks)):
            assert all(len(p[0]) == 2 for p in parts)  # two rows a rank
            for col, got in enumerate(zip(*parts)):
                if isinstance(b[col], np.ndarray):
                    np.testing.assert_array_equal(np.concatenate(got), b[col])
                else:
                    assert [x for g in got for x in g] == list(b[col])
    with pytest.raises(AssertionError, match="drop_last"):
        PrefetchLoader(data, 4, rank_rows=(0, 2))
    with pytest.raises(AssertionError, match="must divide"):
        PrefetchLoader(data, 3, drop_last=True, rank_rows=(0, 2))


# ---------------------------------------------------------------------------
# the faults fixed against the reference (fp32, CPU)
# ---------------------------------------------------------------------------

def test_use_flash_false_takes_plain_attention_at_384(monkeypatch):
    """At the 384-px ViT view (32, 12, 577, 64) the reference's gate sends
    the attention to the flash kernel; ``use_flash=False`` sends it to the
    plain path (0 K1 launches on the card). Shapes only: meta tensors."""
    from vidil_tpu_torch.ops import flash_attention as fa

    calls = []
    monkeypatch.setattr(fa, "flash_attention", lambda q, k, v: calls.append("flash"))
    monkeypatch.setattr(fa, "dot_product_attention",
                        lambda q, k, v, bias=None: calls.append("plain"))
    q = torch.empty((32, 12, 577, 64), device="meta")
    fa.attention_auto(q, q, q)
    fa.attention_auto(q, q, q, use_flash=False)
    assert calls == ["flash", "plain"]
    assert ViTConfig(use_flash=False).use_flash is False and ViTConfig().use_flash is True


def test_vit_use_flash_false_encode_matches_jax():
    """The encode with ``use_flash=False`` on both sides, the same weights
    and images: within the ViT bar (2e-5, PARITY.md)."""
    from vidil_tpu.models import blip as jblip
    from vidil_tpu.models.blip import init_blip_decoder
    from vidil_tpu_torch.models import blip

    jv, pv = JViT(**VIT_KW, use_flash=False), ViTConfig(**VIT_KW, use_flash=False)
    jp = _np_tree(init_blip_decoder(jax.random.PRNGKey(0), jv, JMed(**MED_KW)))
    img = np.random.default_rng(11).standard_normal((3, 32, 32, 3), dtype=np.float32)
    want = np.asarray(jblip.encode_images(jp, jnp.asarray(img), jv))
    got = blip.encode_images(convert.from_jax_params(jp), torch.from_numpy(img), pv).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


def test_cli_runs_with_vit_config_use_flash_false(run):
    """A CapFilt yaml with ``vit_config: {use_flash: false}`` runs (the JAX
    CLI takes it), and at these shapes, which the gate keeps plain anyway,
    writes the default run's files."""
    ph = next(p for p in json.load(open(os.path.join(run.spec, "spec.json")))["phases"]
              if p["kind"] == "capfilt")
    ph = dict(ph, name="capfilt_no_flash",
              config=dict(ph["config"], vit_config=dict(ph["config"]["vit_config"],
                                                        use_flash=False)))
    D._cli_phase(run.spec, run.one, ph)
    for name in ("video_text_Cap.json", "video_text_CapFilt.json"):
        assert open(os.path.join(run.one, "capfilt_no_flash", name), "rb").read() == \
            open(os.path.join(run.one, "capfilt", name), "rb").read()


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """The JAX CapFilt engine and the port's on the same weights, fp32."""
    from vidil_tpu.models.blip import init_blip_decoder, init_blip_itm
    from vidil_tpu.pipeline.capfilt import CapFiltEngine as JEngine
    from vidil_tpu.tokenizer import BlipTokenizer as JTok, write_test_vocab
    from vidil_tpu_torch.tokenizer import BlipTokenizer

    words = ["a", "picture", "of", "video", "man", "dog", "cat", "runs", "plays", "beach",
             "park", "the", "on", "in", "guitar", "ball", "red", "blue", "big", "small",
             "walks", "jumps", "sits", "eats", "food", "water", "tree", "house", "car",
             "street", "sky"]
    vocab = str(tmp_path_factory.mktemp("vocab") / "vocab.txt")
    write_test_vocab(vocab, words)
    jv = JViT(**VIT_KW)
    jm = JMed(**dict(MED_KW, vocab_size=JTok(vocab).vocab_size))
    cap = _np_tree(init_blip_decoder(jax.random.PRNGKey(0), jv, jm))
    fil = _np_tree(init_blip_itm(jax.random.PRNGKey(1), jv, jm))
    return cap, fil, vocab, jm, JEngine, JTok, BlipTokenizer


@pytest.mark.parametrize("length_norm", ["legacy", "modern"])
def test_capfilt_engine_length_norm_token_identical_to_jax(engines, length_norm):
    """CapFiltEngine(length_norm=...): the beam decode of 4 frames token-identical to the JAX engine's, fp32."""
    from vidil_tpu_torch.pipeline.capfilt import CapFiltEngine

    cap, fil, vocab, jm, JEngine, JTok, BlipTokenizer = engines
    kw = dict(num_beams=3, max_length=16, min_length=5, length_norm=length_norm)
    jeng = JEngine(cap, fil, JTok(vocab), JViT(**VIT_KW), jm, dtype=None, **kw)
    peng = CapFiltEngine(convert.from_jax_params(cap), convert.from_jax_params(fil),
                         BlipTokenizer(vocab), ViTConfig(**VIT_KW),
                         MedConfig(**dict(MED_KW, vocab_size=jm.vocab_size)),
                         dtype=torch.float32, device="cpu", **kw)
    assert peng.gen_beam.length_norm == length_norm
    frames = np.random.RandomState(3).randint(0, 256, size=(4, 32, 32, 3), dtype=np.uint8)
    want = np.asarray(jeng._caption(jeng._put(frames), jax.random.PRNGKey(0)))
    got = peng.generate_beam(peng.encode_captioner(frames)).numpy()
    np.testing.assert_array_equal(got, want)


def test_blip_generate_ids_fp32_cache_matches_jax(engines, monkeypatch):
    """blip_generate_ids(cache_dtype=float32): the cache in that dtype (a
    bf16 decode keeps an fp32 self-K/V cache), and the fp32 decode equal to
    the JAX package's with the same argument."""
    from vidil_tpu.models import blip as jblip
    from vidil_tpu.ops.generation import GenerationConfig as JGen
    from vidil_tpu_torch.models import blip, med
    from vidil_tpu_torch.ops.generation import GenerationConfig

    cap, _, _, jm, *_ = engines
    pm = MedConfig(**dict(MED_KW, vocab_size=jm.vocab_size))
    gen_kw = dict(max_length=14, min_length=3, num_beams=3, eos_token_id=102, pad_token_id=0)
    rng = np.random.RandomState(5)
    enc = rng.randn(2, 5, 32).astype(np.float32)
    prompt = np.asarray([[101, 104, 105], [101, 106, 107]], np.int32)
    want = np.asarray(jblip.blip_generate_ids(cap, jnp.asarray(enc), jnp.asarray(prompt), jm,
                                              JGen(**gen_kw), cache_dtype=jnp.float32))
    tp = convert.from_jax_params(cap)
    got = blip.blip_generate_ids(tp, torch.from_numpy(enc), torch.from_numpy(prompt), pm,
                                 GenerationConfig(**gen_kw), cache_dtype=torch.float32).numpy()
    np.testing.assert_array_equal(got, want)

    dtypes = []
    real = med.init_self_cache

    def spy(*args, **kw):
        dtypes.append(kw["dtype"])
        return real(*args, **kw)

    monkeypatch.setattr(med, "init_self_cache", spy)
    blip.blip_generate_ids(tp, torch.from_numpy(enc), torch.from_numpy(prompt), pm,
                           GenerationConfig(**gen_kw), dtype=torch.bfloat16,
                           cache_dtype=torch.float32)
    blip.blip_generate_ids(tp, torch.from_numpy(enc), torch.from_numpy(prompt), pm,
                           GenerationConfig(**gen_kw), dtype=torch.bfloat16)
    assert dtypes == [torch.float32, torch.bfloat16]


def test_convert_med_with_pooler_matches_jax():
    """convert_med(with_pooler=True) takes ``pooler.dense`` from a state dict
    that has it; the pooled output equals the JAX package's converter's,
    within the MED bar (3e-5). Without the flag no pooler is taken."""
    from vidil_tpu.models import convert as jconvert, med as jmed
    from vidil_tpu.models.testing import make_blip_itm_ckpt
    from vidil_tpu_torch.models import med

    jv, jm = JViT(**VIT_KW), JMed(**MED_KW)
    sd = make_blip_itm_ckpt(jv, jm)
    rng = np.random.default_rng(7)
    sd["text_encoder.pooler.dense.weight"] = rng.standard_normal((32, 32), dtype=np.float32) * .1
    sd["text_encoder.pooler.dense.bias"] = rng.standard_normal(32, dtype=np.float32) * .1
    jp = jconvert.convert_med(sd, jm, "text_encoder.", with_pooler=True)
    tp = convert.convert_med(sd, MedConfig(**MED_KW), "text_encoder.", with_pooler=True)
    assert "pooler" not in convert.convert_med(sd, MedConfig(**MED_KW), "text_encoder.")
    ids = rng.integers(4, 200, (3, 8)).astype(np.int32)
    mask = np.ones((3, 8), np.int32)
    mask[0, 5:] = 0
    jh = jmed.med_forward(jp, jnp.asarray(ids), jnp.asarray(mask), cfg=jm, mode="text")
    th = med.med_forward(tp, torch.from_numpy(ids), torch.from_numpy(mask),
                         cfg=MedConfig(**MED_KW), mode="text")
    np.testing.assert_allclose(med.med_pooler(tp, th).numpy(), np.asarray(jmed.med_pooler(jp, jh)),
                               atol=3e-5, rtol=0)
