"""Multi-process dry run of the port's (data, model) grid on the CPU (gloo).

    python -m vidil_tpu_torch.parallel.dryrun N

Counterpart of ``vidil_tpu/parallel/dryrun.py`` for the torch idiom (one
process per device): the parent writes tiny synthetic inputs, runs every
phase in one process (no process group) and then in N fresh subprocesses
that meet by env rendezvous over gloo, and holds the N-rank results to the
one-process ones. As in JAX's dry run, the train phases run over a grid
with a model axis of 2 when N is even (N/2 x 2), else over N data ranks:

* ``runtime``: rendezvous, rank-gated print, barrier, the collectives'
  semantics, `MetricLogger`'s cross-rank averages, `merge_rank_jsons`;
* ``caption``, ``vqa``, ``retrieval``, ``pretrain``: one train step each at
  a global batch of 2N rows (each data rank its rows, each model rank its
  heads): the losses at rtol 1e-5,
  the summed gradients within the parity tests' bar (`grad_bar`: the
  ranks' partial sums add in another order), and the updated parameters
  within what that gradient bar allows AdamW's first step (`param_bar`);
* ``capfilt`` and ``vistok``: the two inference CLIs (BLIP CapFilt, the
  CLIP visual tokenization) on synthetic weights, whose merged files must
  be byte-identical to one process's; ``train_caption``: the caption
  trainer CLI for one epoch (each rank its rows and its eval shard), its
  log and checkpoints written by rank 0 (on the grid too).

The gradients a tensor-parallel phase writes are gathered into whole
leaves (`gather_params`). The row-parallel linears' partial sums add in
another order than one process's product, as the data ranks' gradient
sums do, so the same bars hold. The phase runner (`run_phases`) and the
launcher (`spawn_ranks`) also serve the tests, which write their own
inputs and hold the ranks' results to the JAX package.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


# ---------------------------------------------------------------------------
# launching the ranks
# ---------------------------------------------------------------------------

def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(world: int, argv: list, log_dir: str, timeout: float = 600.0,
                env: dict | None = None):
    """Run `argv` in `world` fresh subprocesses from the repo's root, which
    meet by env rendezvous (torchrun's variables, a free localhost port);
    returns [(rc, stdout, stderr)] per rank. Each rank writes to its own
    files in `log_dir` (a full pipe would stall a rank inside a
    collective); a rank still running after `timeout` seconds is killed,
    and so are the others."""
    port = free_port()
    os.makedirs(log_dir, exist_ok=True)
    procs = []
    for rank in range(world):
        rank_env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                        LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                        PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
        rank_env.update(env or {})
        logs = [os.path.join(log_dir, f"rank{rank}.{k}") for k in ("out", "err")]
        with open(logs[0], "w") as out, open(logs[1], "w") as err:
            procs.append((subprocess.Popen(argv, cwd=REPO, env=rank_env, stdout=out,
                                           stderr=err), logs))
    try:
        for p, _ in procs:
            p.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [(p.returncode, *(open(f).read() for f in logs)) for p, logs in procs]


def run_ranks(world: int, spec_dir: str, out_dir: str, timeout: float = 600.0):
    """`run_phases` of `spec_dir` over `world` gloo ranks on the CPU, one
    thread each (`spawn_ranks`)."""
    argv = [sys.executable, "-m", "vidil_tpu_torch.parallel.dryrun", "--worker", spec_dir,
            out_dir]
    return spawn_ranks(world, argv, out_dir, timeout, env={"OMP_NUM_THREADS": "1"})


def _worker(spec_dir: str, out_dir: str) -> None:
    from vidil_tpu_torch.utils.dist import destroy_distributed, init_distributed_mode

    torch.set_num_threads(1)
    init_distributed_mode(backend="gloo", device="cpu")
    run_phases(spec_dir, out_dir)
    destroy_distributed()


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def load_tree(path: str):
    """A port tree from a `save_checkpoint` file."""
    from vidil_tpu_torch.models.convert import from_jax_params
    from vidil_tpu_torch.utils.checkpoint import load_checkpoint

    return from_jax_params(load_checkpoint(path)[0])


def jax_flat(tree) -> dict:
    """A port tree -> {'/'-joined JAX-layout path: numpy array}."""
    from vidil_tpu_torch.models.convert import to_jax_params
    from vidil_tpu_torch.utils.checkpoint import _flatten

    return _flatten(to_jax_params(tree))


def write_spec(spec_dir: str, phases: list) -> None:
    from vidil_tpu_torch.utils.io import save_json

    save_json(os.path.join(spec_dir, "spec.json"), {"phases": phases})


# ---------------------------------------------------------------------------
# the phases
# ---------------------------------------------------------------------------

def _cfgs(ph):
    from vidil_tpu_torch.config import MedConfig, ViTConfig

    return ViTConfig(**ph["vit"]), MedConfig(**ph["med"])


def _grads(params):
    from vidil_tpu_torch.models.blip_retrieval import _map

    return _map(lambda t: t.grad if t.grad is not None else torch.zeros_like(t), params)


def _stack(rows):
    return torch.stack(rows) if isinstance(rows[0], torch.Tensor) else np.stack(rows)


def rank_batch(batch: dict, vqa: bool = False, grid=None) -> dict:
    """This rank's rows of one global `batch` (arrays or tensors that share
    dim 0), drawn as the trainers draw theirs: through `PrefetchLoader`
    over `loader_shards(grid=grid)` (the whole batch without a process
    group; the data rank's rows on a grid). A
    VQA batch's answers, flattened over the ragged per-question lists
    (``answer_question_index``), go through `vqa_collate` with their
    questions and come back indexed by the rank's rows."""
    from vidil_tpu_torch.data.datasets import PrefetchLoader, vqa_collate
    from vidil_tpu_torch.train.common import loader_shards

    n = len(batch["video"])
    if vqa:
        index = np.asarray(batch["answer_question_index"])
        items = [(batch["video"][i], (batch["question_ids"][i], batch["question_mask"][i]),
                  [(batch["answer_ids"][j], batch["answer_mask"][j])
                   for j in np.flatnonzero(index == i)],
                  [float(batch["weights"][j]) for j in np.flatnonzero(index == i)])
                 for i in range(n)]

        def collate(rows):
            video, questions, answers, weights, counts = vqa_collate(rows)
            return {"video": video, "question_ids": _stack([q for q, _ in questions]),
                    "question_mask": _stack([m for _, m in questions]),
                    "answer_ids": _stack([a for a, _ in answers]),
                    "answer_mask": _stack([m for _, m in answers]),
                    "answer_question_index": np.repeat(np.arange(len(counts)), counts),
                    "weights": weights}
    else:
        items = [{k: v[i] for k, v in batch.items()} for i in range(n)]

        def collate(rows):
            return {k: _stack([r[k] for r in rows]) for k in batch}
    loader = PrefetchLoader(items, n, drop_last=True, num_workers=1, collate_fn=collate,
                            **loader_shards(grid=grid))
    return next(iter(loader))


def _train_phase(spec_dir, out_dir, ph):
    """One train step of `ph["kind"]` from `{inputs}_params.npz` (and, for
    the momentum trainers, `{inputs}_params_m.npz` and `{inputs}_queue.npz`)
    on `{inputs}_batch.npz`, where `inputs` defaults to the phase's name,
    over a grid whose model axis is ``model`` (default 1) under a process
    group; ``zero1`` wraps the optimizer in ZeRO-1. ``save_state`` saves the train
    state to `{name}_state.npz` and loads it back into a fresh state (under
    ZeRO-1 each rank keeps its partition's moments). Rank 0 writes
    `{name}.npz`: the metrics, the gradients (``grad/<path>``), the updated
    parameters (``param/<path>``), for the momentum trainers the negatives
    drawn and the queues, and with ``save_state`` whether the reloaded
    moments equal the step's (``reload_equal``). On a model axis the
    gradients and parameters are gathered whole first, and with
    ``save_state`` the file also holds the reloaded state's gathered
    parameters and moments."""
    from vidil_tpu_torch.models.blip_retrieval import QueueState
    from vidil_tpu_torch.models.convert import named_leaves
    from vidil_tpu_torch.parallel.mesh import make_grid
    from vidil_tpu_torch.parallel.sharding import (
        apply_optimizer_sharding,
        gather_params,
        optimizer_state,
    )
    from vidil_tpu_torch.utils.checkpoint import load_train_state, save_train_state
    from vidil_tpu_torch.utils.dist import (
        barrier,
        get_world_size,
        is_dist_avail_and_initialized,
        is_main_process,
    )
    from vidil_tpu_torch.utils.seeding import make_generator

    name, kind = ph["name"], ph["kind"]
    prefix = ph.get("inputs", name)  # another phase's input files
    path = lambda suffix: os.path.join(spec_dir, f"{prefix}_{suffix}.npz")  # noqa: E731
    vit_cfg, med_cfg = _cfgs(ph)
    grid = None
    if is_dist_avail_and_initialized():
        tp = ph.get("model", 1)
        grid = make_grid(get_world_size() // tp, tp)
    data = np.load(path("batch"))
    batch = rank_batch({k: data[k] for k in data.files}, vqa=kind == "vqa", grid=grid)
    lr, extra = ph.get("lr", 1e-4), {}
    if kind in ("caption", "vqa"):
        from vidil_tpu_torch.train import caption as C, vqa as V

        create = C.create_caption_train_state  # the trainers' shared state
        if kind == "caption":
            step = C.make_caption_train_step(vit_cfg, med_cfg, ph["prompt_length"], grid=grid)
        else:
            step = V.make_vqa_train_step(vit_cfg, med_cfg, grid=grid)
        make_state = lambda: create(load_tree(path("params")), lr, device="cpu",  # noqa: E731
                                    grid=grid)
        run = lambda state: step(state, batch)  # noqa: E731
    else:
        from vidil_tpu_torch.train import pretrain as P, retrieval as R

        def make_state():
            q = np.load(path("queue"))
            queue = QueueState(*(torch.from_numpy(q[k]) for k in ("image", "text", "idx")),
                               int(q["ptr"]))
            return R.create_train_state(load_tree(path("params")), lr,
                                        params_m=load_tree(path("params_m")), queue=queue,
                                        device="cpu", grid=grid)

        make = R.make_retrieval_train_step if kind == "retrieval" else P.make_pretrain_step
        step = make(vit_cfg, med_cfg, grid=grid)
        gen = make_generator(ph.get("gen_seed", 0), 0)
        run = lambda state: step(state, batch, ph.get("alpha", 0.4), gen)  # noqa: E731
    sharding = {"optimizer_sharding": "zero1" if ph.get("zero1") else None}
    state, metrics = run(apply_optimizer_sharding(make_state(), sharding))
    if kind in ("retrieval", "pretrain"):
        extra = {"queue_image": state.queue.image.numpy(), "queue_text": state.queue.text.numpy(),
                 "queue_idx": state.queue.idx.numpy(), "queue_ptr": np.asarray(state.queue.ptr),
                 **dict(zip(("neg_video", "neg_text"),
                            (n.numpy() for n in metrics.pop("negatives"))))}
    if ph.get("save_state"):
        file = os.path.join(out_dir, f"{name}_state")
        save_train_state(file, state)
        barrier()  # rank 0 writes the file; every rank reads it
        reloaded, _ = load_train_state(file, apply_optimizer_sharding(make_state(), sharding))
        want, got = optimizer_state(state.optimizer), optimizer_state(reloaded.optimizer)
        # (under ZeRO-1 the data group's first rank holds the consolidated moments)
        extra["reload_equal"] = np.asarray(bool(want) and all(
            torch.equal(want[p][key], got[q][key])
            for (_, p), (_, q) in zip(named_leaves(state.params), named_leaves(reloaded.params))
            for key in ("exp_avg", "exp_avg_sq")))
        if grid is not None and grid.tensor_parallel:
            extra.update({f"reloaded_param/{k}": v for k, v in
                          jax_flat(gather_params(reloaded.params, grid)).items()})
    grads, params = gather_params(_grads(state.params), grid), gather_params(state.params, grid)
    if not is_main_process():
        return
    out = {k: np.asarray(float(v)) for k, v in metrics.items()}
    out.update({f"grad/{k}": v for k, v in jax_flat(grads).items()})
    out.update({f"param/{k}": v for k, v in jax_flat(params).items()})
    np.savez(os.path.join(out_dir, f"{name}.npz"), **out, **extra)


def _eval_phase(spec_dir, out_dir, ph):
    """`RetrievalEvaluator.score_matrices` on given features; rank 0 writes
    the two matrices."""
    from vidil_tpu_torch.evals.retrieval import RetrievalEvaluator
    from vidil_tpu_torch.utils.dist import is_main_process

    name = ph["name"]
    vit_cfg, med_cfg = _cfgs(ph)
    params = load_tree(os.path.join(spec_dir, f"{name}_params.npz"))
    f = np.load(os.path.join(spec_dir, f"{name}_features.npz"))
    ev = RetrievalEvaluator(params, vit_cfg, med_cfg, None, k_test=ph["k_test"],
                            dtype=torch.float32, rows_per_batch=ph.get("rows_per_batch", 2),
                            blocks_per_dispatch=2, t2v_group=ph.get("t2v_group"))
    v2t, t2v = ev.score_matrices(torch.from_numpy(f["video_feats"]), f["video_embeds"],
                                 f["text_embeds"], f["text_ids"], f["text_atts"])
    if is_main_process():
        np.savez(os.path.join(out_dir, f"{name}.npz"), v2t=v2t, t2v=t2v)


def _cli_phase(spec_dir, out_dir, ph):
    """A CLI's `main` (`CLI_MODULES`: CapFilt, visual tokenization, the four
    trainers) on the spec's config into `out_dir/name`; a config's model
    axis only under a process group (one process is the 1 x 1 grid)."""
    import argparse
    import importlib

    from vidil_tpu_torch.utils.dist import is_dist_avail_and_initialized

    name = ph["name"]
    args = argparse.Namespace(output_dir=os.path.join(out_dir, name), device="cpu",
                              seed=ph.get("seed", 42), config="", world_size=1,
                              dist_url="env://", distributed=True,
                              encoder_version=ph.get("encoder_version", "clip"),
                              result_dir=os.path.join(out_dir, name, "result"), evaluate=False)
    os.makedirs(args.result_dir, exist_ok=True)
    cli = importlib.import_module(f"vidil_tpu_torch.{CLI_MODULES[ph['kind']]}")
    config = dict(ph["config"])
    if not is_dist_avail_and_initialized():
        config.pop("model_parallel", None)
    cli.main(args, config)


CLI_MODULES = {"capfilt": "run_video_CapFilt", "vistok": "run_visual_tokenization",
               "train_caption": "train_caption_video", "train_vqa": "train_vqa_video",
               "train_retrieval": "train_retrieval_video", "pretrain_cli": "pretrain_video"}


def _runtime_phase(spec_dir, out_dir, ph):
    """The runtime's own contract on this rank; writes
    `runtime_rank{r}.json` (skipped in one process)."""
    import builtins
    import io
    from contextlib import redirect_stdout

    from vidil_tpu_torch.parallel import collectives as C
    from vidil_tpu_torch.utils import dist, io as uio
    from vidil_tpu_torch.utils.logging import MetricLogger

    if not dist.is_dist_avail_and_initialized():
        return
    rank, world = dist.get_rank(), dist.get_world_size()
    rec: dict = {"rank": rank, "world": world, "backend": torch.distributed.get_backend()}
    buf = io.StringIO()
    with redirect_stdout(buf):
        builtins.print("gated line")
        builtins.print("forced line", force=True)
    rec["printed"] = buf.getvalue().splitlines()
    dist.barrier()

    x = torch.arange(6, dtype=torch.float32).reshape(3, 2) + 10 * rank
    x.requires_grad_(True)
    gathered = C.all_gather_with_grad(x)
    w = torch.arange(gathered.numel(), dtype=torch.float32).reshape(gathered.shape) * (rank + 1)
    (gathered * w).sum().backward()
    rec["gathered"] = gathered.detach().tolist()
    rec["grad"] = x.grad.tolist()
    y = x.detach().clone().requires_grad_(True)
    rec["concat_requires_grad"] = C.concat_all_gather(y).requires_grad
    rec["concat"] = C.concat_all_gather(y).tolist()
    rec["psum"] = C.psum(torch.tensor([1.0, rank + 1.0])).tolist()
    rec["pmean"] = C.pmean(torch.tensor([2.0 * rank])).tolist()
    rec["psum_int"] = C.psum(torch.tensor([rank + 1])).tolist()

    logger = MetricLogger()
    for v in range(rank + 1):  # rank r logs r + 1 values
        logger.update(loss=float(10 * rank + v))
    logger.synchronize_between_processes()
    rec["global_avg"] = logger.loss.global_avg
    rec["count"] = logger.loss.count

    tmp = os.path.join(out_dir, "merge_tmp")
    os.makedirs(tmp, exist_ok=True)
    uio.save_json(os.path.join(tmp, f"{rank}.json"), {f"k{rank}_{i}": i for i in range(2)})
    merged = uio.merge_rank_jsons(tmp, os.path.join(out_dir, "merged.json"), cleanup=True)
    rec["merged_keys"] = None if merged is None else sorted(merged)
    uio.save_json(os.path.join(out_dir, f"runtime_rank{rank}.json"), rec)


RUNNERS = {"caption": _train_phase, "vqa": _train_phase, "retrieval": _train_phase,
           "pretrain": _train_phase, "eval": _eval_phase, "runtime": _runtime_phase,
           **dict.fromkeys(CLI_MODULES, _cli_phase)}


def run_phases(spec_dir: str, out_dir: str) -> None:
    """Every phase of ``spec_dir/spec.json``, in order, into `out_dir`: on
    this rank's rows under a process group, else on the whole batches."""
    from vidil_tpu_torch.utils.io import load_json

    os.makedirs(out_dir, exist_ok=True)
    for ph in load_json(os.path.join(spec_dir, "spec.json"))["phases"]:
        RUNNERS[ph["kind"]](spec_dir, out_dir, ph)


# ---------------------------------------------------------------------------
# the dry run's own inputs and bars
# ---------------------------------------------------------------------------

VIT_KW = dict(image_size=32, patch_size=16, hidden_size=32, num_layers=2, num_heads=4)
MED_KW = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
              max_position_embeddings=64, encoder_width=32)
EMBED = 8
LR = 1e-4


def _text_batch(rng, B, L, first):
    """Token ids with [PAD] tails of different lengths (the ranks hold
    different numbers of valid tokens) and `first` at position 0."""
    ids = rng.randint(6, MED_KW["vocab_size"], size=(B, L)).astype(np.int64)
    mask = np.ones((B, L), np.int64)
    for b in range(B):
        mask[b, L - 1 - (b * 3) % (L - 4):] = 0 if b % 2 else 1
    ids[mask == 0] = 0
    ids[:, 0] = first
    return ids, mask


def write_train_inputs(spec_dir: str, world: int, seed: int = 0) -> list:
    """The four train phases at a global batch of 2 * world rows, synthetic
    weights (`utils/synth.py`), numpy-seeded batches; returns their spec
    entries."""
    from vidil_tpu_torch.config import MedConfig, ViTConfig
    from vidil_tpu_torch.models import blip, blip_vqa
    from vidil_tpu_torch.models.blip_retrieval import init_momentum_params, init_queue
    from vidil_tpu_torch.models.convert import from_jax_params
    from vidil_tpu_torch.utils.checkpoint import save_checkpoint
    from vidil_tpu_torch.utils.seeding import make_generator
    from vidil_tpu_torch.utils.synth import synth_tree

    vit, med = ViTConfig(**VIT_KW), MedConfig(**MED_KW)
    B = 2 * world
    rng = np.random.RandomState(seed)
    video = lambda: rng.randn(B, 2, 32, 32, 3).astype(np.float32) * 0.1  # noqa: E731
    path = lambda name, suffix: os.path.join(spec_dir, f"{name}_{suffix}.npz")  # noqa: E731
    base = {"vit": VIT_KW, "med": MED_KW, "lr": LR}
    phases = []

    params = from_jax_params(synth_tree(blip.blip_decoder_shapes(vit, med), "cpu", salt=1.0))
    save_checkpoint(path("caption", "params"), params)
    ids, mask = _text_batch(rng, B, 12, 1)
    np.savez(path("caption", "batch"), video=video(), input_ids=ids, attention_mask=mask)
    phases.append({"name": "caption", "kind": "caption", "prompt_length": 3, **base})

    params = from_jax_params(synth_tree(blip_vqa.blip_vqa_shapes(vit, med), "cpu", salt=2.0))
    save_checkpoint(path("vqa", "params"), params)
    q_ids, q_mask = _text_batch(rng, B, 9, 3)
    n_answers = [1 + (b % 3) for b in range(B)]  # ragged: the ranks hold different counts
    a_ids, a_mask = _text_batch(rng, sum(n_answers), 5, 1)
    np.savez(path("vqa", "batch"), video=video(), question_ids=q_ids, question_mask=q_mask,
             answer_ids=a_ids, answer_mask=a_mask,
             answer_question_index=np.repeat(np.arange(B), n_answers),
             weights=rng.uniform(0.1, 0.5, sum(n_answers)).astype(np.float32))
    phases.append({"name": "vqa", "kind": "vqa", **base})

    for kind, shapes, salt in (("retrieval", blip.blip_retrieval_shapes, 3.0),
                               ("pretrain", blip.blip_pretrain_shapes, 4.0)):
        params = from_jax_params(synth_tree(shapes(vit, med, EMBED), "cpu", salt=salt))
        params["temp"].fill_(0.07)
        save_checkpoint(path(kind, "params"), params)
        save_checkpoint(path(kind, "params_m"), init_momentum_params(params))
        q = init_queue(make_generator(seed, -1), EMBED, 4 * B)
        np.savez(path(kind, "queue"), image=q.image.numpy(), text=q.text.numpy(),
                 idx=q.idx.numpy(), ptr=np.asarray(q.ptr))
        ids, mask = _text_batch(rng, B, 10, 2)
        enc, dec = ids.copy(), ids.copy()
        enc[:, 0], dec[:, 0] = 3, 1
        batch = {"video": video(), "text_ids": ids, "enc_ids": enc, "text_mask": mask,
                 "idx": np.arange(B) // 2}  # two texts per video
        if kind == "pretrain":
            batch["dec_ids"] = dec
            del batch["idx"]
        np.savez(path(kind, "batch"), **batch)
        phases.append({"name": kind, "kind": kind, "alpha": 0.4, "gen_seed": seed + 7, **base})
    return phases


def write_clip_checkpoint(path: str, cfg) -> None:
    """A CLIP checkpoint of `cfg`'s shapes in the HF CLIPModel layout that
    `convert_clip` reads, its weights synthetic (`utils/synth.py`)."""
    from vidil_tpu_torch.models.clip import clip_shapes
    from vidil_tpu_torch.utils.synth import synth_tree

    tree = synth_tree(clip_shapes(cfg), "cpu", salt=4.0)  # the JAX layout: stacked layers
    sd = {}

    def lin(prefix, node):
        sd[prefix + ".weight"], sd[prefix + ".bias"] = node["kernel"].T, node["bias"]

    def ln(prefix, node):
        sd[prefix + ".weight"], sd[prefix + ".bias"] = node["scale"], node["bias"]

    def tower(prefix, layers, n):
        for i in range(n):
            b = f"{prefix}.layers.{i}."

            def at(node, i=i):
                return {k: v[i] for k, v in node.items()}

            ln(b + "layer_norm1", at(layers["norm1"]))
            for ours, hf in (("query", "q"), ("key", "k"), ("value", "v"), ("out", "out")):
                lin(b + f"self_attn.{hf}_proj", at(layers["attn"][ours]))
            ln(b + "layer_norm2", at(layers["norm2"]))
            lin(b + "mlp.fc1", at(layers["mlp"]["fc1"]))
            lin(b + "mlp.fc2", at(layers["mlp"]["fc2"]))

    v, t, P = tree["vision"], tree["text"], cfg.patch_size
    sd["vision_model.embeddings.patch_embedding.weight"] = (
        v["patch_embed"]["kernel"].reshape(P, P, 3, -1).permute(3, 2, 0, 1))
    sd["vision_model.embeddings.class_embedding"] = v["class_embedding"]
    sd["vision_model.embeddings.position_embedding.weight"] = v["pos_embed"]
    ln("vision_model.pre_layrnorm", v["pre_norm"])
    tower("vision_model.encoder", v["layers"], cfg.vision_layers)
    ln("vision_model.post_layernorm", v["post_norm"])
    sd["text_model.embeddings.token_embedding.weight"] = t["token_embedding"]["embedding"]
    sd["text_model.embeddings.position_embedding.weight"] = t["pos_embed"]
    tower("text_model.encoder", t["layers"], cfg.text_layers)
    ln("text_model.final_layer_norm", t["final_norm"])
    sd["visual_projection.weight"] = tree["visual_projection"]["kernel"].T
    sd["text_projection.weight"] = tree["text_projection"]["kernel"].T
    sd["logit_scale"] = tree["logit_scale"]
    torch.save({k: x.contiguous() for k, x in sd.items()}, path)


def write_cli_workspace(root: str, n_videos: int, videos_per_batch: int,
                        train_batch: int) -> list:
    """Synthetic mp4s, vocabularies, an ontology and caption jsonls;
    returns the spec entries of the CapFilt CLI (BLIP, synthetic weights,
    fp32), the CLIP visual-tokenization CLI (a checkpoint of synthetic
    weights, fp32) and the caption trainer CLI (one epoch, synthetic
    weights, a global batch of `train_batch`)."""
    import cv2

    from vidil_tpu_torch.config import CLIPConfig
    from vidil_tpu_torch.tokenizer import BlipTokenizer, write_test_clip_bpe, write_test_vocab
    from vidil_tpu_torch.utils.io import save_json

    videos = os.path.join(root, "videos")
    os.makedirs(videos, exist_ok=True)
    ann = {}
    for vi in range(n_videos):
        w = cv2.VideoWriter(os.path.join(videos, f"video{vi}.mp4"),
                            cv2.VideoWriter_fourcc(*"mp4v"), 10, (64, 48))
        for i in range(16):
            frame = np.zeros((48, 64, 3), np.uint8)
            frame[:, :, vi % 3] = (i * 7 + vi * 50) % 255
            frame[: 10 + i, :, (vi + 1) % 3] = 120
            w.write(frame)
        w.release()
        ann[f"video{vi}"] = [f"original caption {vi}. second sentence {vi}"]
    save_json(os.path.join(root, "ann.json"), ann)
    words = ["a", "picture", "of", "original", "caption", "second", "sentence", "video", "man",
             "dog", "cat", "red", "blue", "beach", "park", "running", "sitting"]
    vocab = os.path.join(root, "vocab.txt")
    write_test_vocab(vocab, words)
    med_json = os.path.join(root, "med.json")
    save_json(med_json, {"vocab_size": BlipTokenizer(vocab).vocab_size, "hidden_size": 32,
                         "num_hidden_layers": 2, "num_attention_heads": 4,
                         "intermediate_size": 64, "max_position_embeddings": 64,
                         "encoder_width": 32, "add_cross_attention": True})
    common = dict(video_roots=videos, video_formats="mp4",
                  train_ann_jsons=os.path.join(root, "ann.json"), frm_sampling_strategy="uniform",
                  height=None, width=None, start_time=None, end_time=None, fps=-1,
                  compute_dtype="float32", videos_per_batch=videos_per_batch,
                  data_parallel=True)
    capfilt = dict(common, synthetic_weights=True, caption=True, filter=True,
                   filter_generated_only=True, keep_original_caption=False,
                   filter_mode="max_filter", generation_mode="beam",
                   threshold=-1.0, num_frm_CapFilt=2, do_sentence_tokenization=True,
                   vit="tiny", vit_config={k: v for k, v in VIT_KW.items() if k != "image_size"},
                   image_size=32, med_config=med_json, bert_vocab=vocab)
    onto = {"objects": ["dog", "cat"], "attributes": ["red", "blue"],
            "scenes": ["beach", "park"], "verbs": ["running", "sitting"]}
    paths = {}
    for key, terms in onto.items():
        paths[key] = os.path.join(root, f"onto_{key}.json")
        save_json(paths[key], terms)
    bpe = [os.path.join(root, "vocab.json"), os.path.join(root, "merges.txt")]
    write_test_clip_bpe(*bpe, words=["a", "photo", "of"] + [t for v in onto.values() for t in v])
    with open(bpe[0]) as f:
        clip_vocab = len(json.load(f))
    clip_config = dict(image_size=28, patch_size=14, vision_hidden_size=32, vision_layers=2,
                       vision_heads=4, vision_intermediate_size=64, vocab_size=clip_vocab,
                       text_hidden_size=32, text_layers=2, text_heads=4,
                       text_intermediate_size=64, max_text_len=16, projection_dim=24)
    clip_ckpt = os.path.join(root, "clip.pth")
    write_clip_checkpoint(clip_ckpt, CLIPConfig(**clip_config))
    vistok = dict(common, num_frm_visual_tokenization=2, ontology="custom",
                  ontology_paths=paths, topk_visualize=2, prompt_version_visual_tokenization="v1",
                  save_frames=False, early_stop_step=-1, clip_vocab=bpe[0], clip_merges=bpe[1],
                  clip_config=clip_config, clip_ckpt=clip_ckpt)
    for split, per_video in (("train", 2), ("val", 1), ("test", 1)):
        with open(os.path.join(root, f"{split}.jsonl"), "w") as f:
            for vi in range(n_videos):
                for j in range(per_video):
                    f.write(json.dumps({"caption": f"a video of a dog {vi} {j}",
                                        "clip_name": f"video{vi}"}) + "\n")
    train = dict(common, synthetic_weights=True, video_root=videos,
                 **{f"{s}_ann_jsonl": os.path.join(root, f"{s}.jsonl")
                    for s in ("train", "val", "test")},
                 num_frm_train=2, num_frm_test=2, vit="tiny", vit_config=capfilt["vit_config"],
                 image_size=32, med_config=med_json, bert_vocab=vocab,
                 train_batch_size=train_batch, test_batch_size=videos_per_batch,
                 init_lr=1e-4, max_length=12, min_length=2, num_beams=2, max_epoch=1)
    return [{"name": "capfilt", "kind": "capfilt", "config": capfilt},
            {"name": "vistok", "kind": "vistok", "encoder_version": "clip", "config": vistok},
            {"name": "train_caption", "kind": "train_caption", "config": train}]


def grad_bar(g, g_max: float) -> float:
    """The atol of a gradient leaf `g` against another summation order:
    1e-5 of the leaf's largest entry, at least 1e-6 of the model's largest
    gradient `g_max` (leaves that are zero in exact arithmetic, such as the
    attention key biases, hold rounding noise). A 0-d leaf (``temp``) is a
    sum of B * (B + Q) terms of up to |sim| / temp**2 ~ 1e2 that may
    cancel to O(0.1): its rounding is relative to the terms, not to the
    sum, so its bar is 1e-5 of the larger of |g| and 1."""
    if np.ndim(g) == 0:
        return 1e-5 * max(float(np.abs(g)), 1.0)
    return 1e-5 * max(float(np.abs(g).max()), 1e-6 * g_max)


# The momentum trainers on a model axis: their fp32 gradients carry an error
# of their own, up to 1e-3 of a leaf's largest entry on these tiny synthetic
# towers (the one-process step against its float64 evaluation, measured in
# tests/test_torch_tensor_parallel.py, where the tensor-parallel step's
# float64 evaluation equals the one process's to 1e-13). A model axis
# rounds the forward's row-parallel sums in another order, which redraws
# that error: the two fp32 steps may differ by twice it, 2e-3 = 200 times
# `grad_bar`. The data axis changes no forward value and keeps the bar.
TP_MOMENTUM_FACTOR = 200.0


ADAM_EPS = 1e-8


def param_bar(g, bar: float, lr: float):
    """The atol of the parameters after AdamW's first step, elementwise,
    when the gradient `g` may be off by `bar`: the step moves a parameter
    by lr * g / (|g| + eps) (the decay is the same on both sides), whose
    slope in g is lr * eps / (|g| + eps)**2, so an error of at most `bar`
    moves it by at most lr * eps * bar / (|g| - bar + eps)**2, plus 1e-6
    of fp32 rounding; where |g| <= bar the sign itself is rounding noise
    and the bar is 2 * lr."""
    g = np.abs(g)
    slope = lr * ADAM_EPS * bar / (np.maximum(g - bar, 0.0) + ADAM_EPS) ** 2
    return np.where(g <= bar, 2 * lr * (1 + 1e-3), 1e-6 + slope)


def train_bars(ref: dict, got: dict, lr: float, factor: float = 1.0) -> list:
    """Where the N-rank step of a train phase leaves the one-process one's
    bars (module docstring), the gradient and parameter bars times
    `factor`: [message], empty when it holds."""
    bad = []
    for k in (k for k in ref if "/" not in k and not k.startswith("queue")):
        if not np.allclose(got[k], ref[k], rtol=1e-5, atol=0):
            bad.append(f"{k}: {float(got[k])} != {float(ref[k])}")
    grads = {k[5:]: ref[k] for k in ref if k.startswith("grad/")}
    g_max = max(float(np.abs(g).max()) for g in grads.values())
    for path, g in grads.items():
        bar = factor * grad_bar(g, g_max)
        if not np.allclose(got[f"grad/{path}"], g, rtol=0, atol=bar):
            bad.append(f"grad/{path}: {float(np.abs(got[f'grad/{path}'] - g).max())} > {bar}")
        diff = np.abs(got[f"param/{path}"] - ref[f"param/{path}"])
        if (diff > param_bar(g, bar, lr) * max(factor, 1.0)).any():
            bad.append(f"param/{path}: max diff {float(diff.max())}")
    for k in ("queue_image", "queue_text"):
        if k in ref and not np.allclose(got[k], ref[k], rtol=0, atol=3e-5):
            bad.append(k)
    for k in ("queue_idx", "queue_ptr"):
        if k in ref and not np.array_equal(got[k], ref[k]):
            bad.append(k)
    return bad


def main(world: int) -> None:
    """Run the dry run at `world` ranks; raise SystemExit on any failure."""
    torch.set_num_threads(1)
    with tempfile.TemporaryDirectory() as root:
        spec = os.path.join(root, "spec")
        os.makedirs(spec)
        phases = [{"name": "runtime", "kind": "runtime"}]
        phases += write_train_inputs(spec, world)
        # each rank's shard a whole number of chunks: n // world + 1 = 2 per rank
        phases += write_cli_workspace(os.path.join(root, "ws"), 2 * world - 1, 2, world)
        model = 2 if world % 2 == 0 else 1  # JAX's dry run: a model axis of 2 when N is even
        for ph in phases:
            if ph["kind"] in ("caption", "vqa", "retrieval", "pretrain"):
                ph["model"] = model
            elif ph["kind"] == "train_caption":
                ph["config"]["model_parallel"] = model
        write_spec(spec, phases)
        one, many = os.path.join(root, "one"), os.path.join(root, "many")
        run_phases(spec, one)  # the trainer CLI's files: not compared
        results = run_ranks(world, spec, many)
        for rank, (rc, out, err) in enumerate(results):
            if rc != 0:
                raise SystemExit(f"dryrun({world}): rank {rank} exited {rc}\n{out}\n{err}")
        recs = [json.load(open(os.path.join(many, f"runtime_rank{r}.json")))
                for r in range(world)]
        ok = all(r["world"] == world and r["rank"] == i for i, r in enumerate(recs))
        ok &= [r["printed"] for r in recs] == [["gated line", "forced line"]] + \
            [["forced line"]] * (world - 1)
        ok &= recs[0]["merged_keys"] == sorted(f"k{r}_{i}" for r in range(world) for i in range(2))
        if not ok:
            raise SystemExit(f"dryrun({world}): runtime records {recs}")
        print(f"dryrun({world}) runtime ok: rendezvous, print gating, barrier, collectives, "
              f"merge", flush=True)
        for ph in phases:
            if ph["kind"] in ("caption", "vqa", "retrieval", "pretrain"):
                ref = dict(np.load(os.path.join(one, f"{ph['name']}.npz")))
                got = dict(np.load(os.path.join(many, f"{ph['name']}.npz")))
                factor = TP_MOMENTUM_FACTOR if model > 1 and ph["kind"] in (
                    "retrieval", "pretrain") else 1.0
                bad = train_bars(ref, got, ph["lr"], factor)
                if bad:
                    raise SystemExit(f"dryrun({world}) {ph['name']}: " + "; ".join(bad[:8])
                                     + f" ({len(bad)} in all)")
                print(f"dryrun({world}) {ph['name']} ok on a {world // model} x {model} grid: "
                      f"loss {float(got['loss']):.6f} (one process {float(ref['loss']):.6f}), "
                      f"{sum(k.startswith('grad/') for k in got)} gradients", flush=True)
            elif ph["kind"] == "train_caption":
                # each rank draws its own rows' augmentations, so the trained
                # weights are not the one process's: the run and its files
                log = [json.loads(line) for line in open(os.path.join(many, ph["name"],
                                                                       "log.txt"))]
                if not (len(log) == 1 and "test_CIDEr" in log[0] and all(
                        os.path.exists(os.path.join(many, ph["name"], f"checkpoint_{n}.npz"))
                        for n in ("best", "last"))):
                    raise SystemExit(f"dryrun({world}) train_caption: {log}")
                print(f"dryrun({world}) train_caption ok: one epoch, log and checkpoints",
                      flush=True)
            elif ph["kind"] in ("capfilt", "vistok"):
                names = (("video_text_Cap.json", "video_text_CapFilt.json")
                         if ph["kind"] == "capfilt" else ("visual_tokens.json",))
                for n in names:
                    a = open(os.path.join(one, ph["name"], n), "rb").read()
                    b = open(os.path.join(many, ph["name"], n), "rb").read()
                    if a != b:
                        raise SystemExit(f"dryrun({world}) {ph['name']}: {n} differs")
                print(f"dryrun({world}) {ph['name']} ok: {', '.join(names)} byte-identical",
                      flush=True)


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--worker":
        _worker(sys.argv[2], sys.argv[3])
    else:
        main(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
