"""Caption fine-tune cells: the port's `make_caption_train_step` on one
process per card, data parallel over the cell's chips under NCCL as the
trainer runs under torchrun.

Set-up draws the model's weights on the device, builds the train state
(fp32 master weights, AdamW) and the step, makes this rank's rows of a
pool of distinct global batches on the host, and drives the state
through its first three steps on batches 0-2: they warm up every shape
and are what the check compares. The same state then steps through the
pool until `--seconds` have passed, each step ending in the loss on the
host (`float(metrics["loss"])`, as the trainer logs it). Afterwards rank 0
runs the plain reference's three steps on the global batches
(`reference/judge_train.py`).
"""

from __future__ import annotations

import contextlib
import gc
import json
import os

import torch

import flops
import generate
import harness
import weights
from reference import judge_train

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
CHECK_STEPS = 3


@contextlib.contextmanager
def patched(pairs):
    """Set (object, attribute, value) triples, and restore them on exit."""
    old = [(o, a, getattr(o, a)) for o, a, _ in pairs]
    try:
        for o, a, v in pairs:
            setattr(o, a, v)
        yield
    finally:
        for o, a, v in old:
            setattr(o, a, v)


def _spans_on_program(spans):
    """Spans around the calls the step makes into each layer (traced runs):
    the ViT forward, the decoder's loss, the backward with the all-reduce
    and AdamW, the all-reduce alone, and the K4 / K5 launches."""
    from vidil_tpu_torch.models import blip
    from vidil_tpu_torch.ops import fused_vit_block as fvb
    from vidil_tpu_torch.parallel import collectives
    from vidil_tpu_torch.train import caption

    if not spans.on:
        return []
    return [(blip, "encode_video_frames", spans.host_span("vit_forward", blip.encode_video_frames)),
            (blip, "blip_caption_loss", spans.host_span("med_loss", blip.blip_caption_loss)),
            (caption, "apply_gradients", spans.host_span("backward_adamw",
                                                         caption.apply_gradients)),
            (collectives, "all_reduce_grads", spans.host_span("all_reduce",
                                                              collectives.all_reduce_grads)),
            (fvb, "_launch_fwd", spans.device_span("k4", fvb._launch_fwd)),
            (fvb, "_launch_bwd", spans.device_span("k5", fvb._launch_bwd))]


def _faults(fault):
    """Break the timed path for the benchmark's own tests of its check."""
    from vidil_tpu_torch.parallel import collectives
    from vidil_tpu_torch.train import caption

    if fault == "exchange":
        return [(collectives, "all_reduce_grads", lambda *a, **k: None)]
    if fault == "unchanged":
        return [(caption, "apply_gradients", lambda state, loss, grid=None: state)]
    if fault in (None, "half"):
        return []
    raise ValueError(f"caption_train has no fault {fault!r}")


def _feed(batch, fault):
    if fault != "half":
        return batch
    n = len(batch["input_ids"]) // 2
    return {k: v[:n] for k, v in batch.items()}


def run(ctx, procs=()):
    from vidil_tpu_torch.config import MedConfig, ViTConfig
    from vidil_tpu_torch.train.caption import create_caption_train_state, make_caption_train_step
    from vidil_tpu_torch.utils import dist

    cfg, t, dev = ctx.config, ctx.traffic, ctx.device
    tr = cfg["train"]
    world, rank = ctx.world, ctx.rank
    if world > 1:
        dist.init_distributed_mode(device=dev)
    vit_cfg = ViTConfig(**cfg["vit"], remat=cfg["vit_grad_ckpt"])
    med_cfg = MedConfig(**cfg["med"])
    prompt_length = generate.prompt_length(t)
    params0 = weights.draw(weights.captioner_spec(cfg), ctx.seed, dev, salt=1)
    state = create_caption_train_state(params0, tr["init_lr"], tr["weight_decay"], device=dev)
    step = make_caption_train_step(vit_cfg, med_cfg, prompt_length, dtype=DTYPES[tr["dtype"]],
                                   med_remat=tr["med_remat"])
    B = t["videos"] // world  # this rank's rows of each global batch
    rows = range(rank * B, (rank + 1) * B)
    pool = [generate.caption_batch(t, ctx.seed, b, rows) for b in range(t["pool_batches"])]

    spans = harness.Spans(ctx.trace, dev)
    with patched(_faults(ctx.fault)), patched(_spans_on_program(spans)):
        step_call = spans.host_span("train_step", step)
        losses = []
        for s in range(CHECK_STEPS):
            state, m = step_call(state, _feed(pool[s], ctx.fault))
            losses.append(float(m["loss"]))
            if s == 0:
                g1 = judge_train.program_reading(state, params0, 1)
        delta = judge_train.program_reading(state, params0, CHECK_STEPS)
        del params0
        spans.clear()
        if ctx.trace:
            harness.Profile.warm_up(dev)
        harness.freeze_heap()
        setup_s = harness.clock() - ctx.t0

        step_s, k, prof = [], CHECK_STEPS, None
        flag = torch.zeros(1, dtype=torch.int32, device=dev)
        t_start = harness.clock()
        deadline = t_start + ctx.seconds
        while True:
            if ctx.trace and k == CHECK_STEPS + t["profile_from"]:
                prof = harness.Profile(dev).__enter__()
            t0 = harness.clock()
            state, m = step_call(state, _feed(pool[k % len(pool)], ctx.fault))
            float(m["loss"])
            step_s.append(harness.clock() - t0)
            k += 1
            if prof is not None and prof.window_s is None and \
                    k == CHECK_STEPS + t["profile_from"] + t["profile_steps"]:
                prof.__exit__(None, None, None)
                prof.units = t["profile_steps"]
            if _stop(harness.clock() >= deadline, flag, world):
                break
        t_end = harness.clock()
        if prof is not None and prof.window_s is None:
            prof.__exit__(None, None, None)
            prof.units = k - CHECK_STEPS - t["profile_from"]
    gc.unfreeze()
    window_s = t_end - t_start
    steps = k - CHECK_STEPS
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    summary = prof.summary() if prof is not None else None
    out = {"attempted": steps, "failed": 0, "quartiles_ms": harness.quartiles_ms(step_s),
           "e2e": {"samples_per_s": steps * t["videos"] / window_s,
                   "step_ms_p90": harness.p90(step_s) * 1e3, "setup_s": setup_s}}
    # this rank's batches, times the ranks: the global step's work
    batch_flops = [flops.caption_step_flops(cfg, t["frames"], b["attention_mask"].sum(1).tolist())
                   for b in pool]
    window_flops = world * sum(batch_flops[(CHECK_STEPS + i) % len(pool)] for i in range(steps))
    if ctx.trace:
        tokens = (cfg["vit"]["image_size"] // cfg["vit"]["patch_size"]) ** 2 + 1
        width = cfg["vit"]["hidden_size"]
        out["trace"] = {"host_ms": spans.host_ms(), "device_ms": spans.device_ms(),
                        "steps": steps, "window_s": window_s, "chips": world,
                        "flops": window_flops, "profile": summary,
                        "k4_bound_s": flops.block_bound_s(B * t["frames"], tokens, width),
                        "k5_bound_s": flops.block_bound_s(B * t["frames"], tokens, width,
                                                          backward=True)}
    mine = {"peak": peak, "busy_s": summary["busy_s"] if summary else None,
            "window_s": summary["window_s"] if summary else None}
    del state, step, step_call, m
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ranks = _gather(ctx, mine, world, rank)
    if world > 1:
        dist.destroy_distributed()
    if rank != 0:
        return out
    peak = max(r["peak"] for r in ranks)
    out["device"] = harness.device_info(dev, world, peak)
    if ctx.trace and summary is not None:
        busy = [r["busy_s"] for r in ranks if r["busy_s"] is not None]
        out["device"]["busy_s"] = sum(busy) / len(busy)
        out["device"]["window_s"] = summary["window_s"]
        out["breakdown"] = harness.breakdown(summary)
    for p in procs:  # every rank has freed its card before the reference runs
        p.wait()
    batches = judge_train.global_batches(t, ctx.seed, CHECK_STEPS)
    params = weights.draw(weights.captioner_spec(cfg), ctx.seed, dev, salt=1)
    ref = judge_train.reference_steps(cfg, params, batches, prompt_length, dev,
                                      rows_per_block=B)
    prog = {"losses": losses, "g1": g1, "delta": delta}
    readings = judge_train.numbers(prog, ref)
    out["checks"] = {k: v for k, v in readings.items() if not k.startswith("_")}
    out["detail"] = {k: v for k, v in readings.items() if k.startswith("_")}
    if ctx.control:
        params = weights.draw(weights.captioner_spec(cfg), ctx.seed, dev, salt=1)
        ctl = judge_train.reference_steps(cfg, params, batches, prompt_length, dev, "fp8",
                                          rows_per_block=B)
        out["control"] = judge_train.numbers(ctl, ref)
    return out


def _stop(mine: bool, flag, world) -> bool:
    """Rank 0's clock decides when every rank stops."""
    if world == 1:
        return mine
    import torch.distributed as td

    flag.fill_(int(mine))
    td.broadcast(flag, 0)
    return bool(flag.item())


def _gather(ctx, mine, world, rank) -> list[dict]:
    """Every rank's peak memory and traced busy seconds, at rank 0, through
    files under TMPDIR after a barrier."""
    if world == 1:
        return [mine]
    import torch.distributed as td

    path = os.path.join(ctx.tmp, "portbench_rank{}.json")
    os.makedirs(ctx.tmp, exist_ok=True)
    with open(path.format(rank), "w") as f:
        json.dump(mine, f)
    td.barrier()
    if rank != 0:
        return []
    out = []
    for r in range(world):
        with open(path.format(r)) as f:
            out.append(json.load(f))
    return out
