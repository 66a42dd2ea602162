"""Language-model cells: the port's `LMAnswerEngine` answering chunks of
VidIL's few-shot prompts in a closed loop with one chunk in flight, as
`vidil_tpu_torch.answer_prompts` runs it (dispatch chunk n+1, then
complete chunk n).

Set-up draws the model's weights on the device from the seed
(`weights_lm.py`: the benchmark's own draw, in the layout the plain
reference documents, handed to the program and the reference alike),
writes the whole-word vocabulary,
makes the traffic's pool of distinct chunks on the host (`lm_traffic.py`)
and runs `warmup_chunks` chunks through the loop: the first decode runs
eager, the second is captured into CUDA graphs, the third replays them.
The window then dispatches chunks from the pool until `--seconds` have
passed and completes the one in flight. Afterwards one completed chunk,
drawn from the seed, is served again eagerly with the engine's probe on
(its logits and expert ids), and `check_prompts` of its prompts are held
against the plain reference teacher-forced on the window's own answers
(`reference/judge_lm.py`). A fourth check ties the eager re-serve to the
window: ``rerun_mismatched_tokens``, how many of the chunk's answer tokens,
over every prompt, the re-serve gives otherwise than the window's graphed
decode did (limit 0.5, so none: the replay is bitwise the eager decode).
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

import flops_lm
import harness
import lm_traffic
import weights_lm
from reference import judge_lm

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _fault_patches(fault, engine):
    """(object, attribute, value) triples that break the timed path, for
    the benchmark's own tests of its check."""
    from vidil_tpu_torch.ops import moe, ssd

    if fault is None:
        return []
    if fault == "no_shared_expert":
        return [(moe, "shared_expert", lambda x, up, down: torch.zeros_like(x))]
    if fault == "top5":
        route = moe.route
        return [(moe, "route", lambda x, w, b, k, scale, norm: route(x, w, b, k - 1, scale, norm))]
    if fault == "gate_by_biased_scores":
        def route_biased(x, w, b, k, scale, norm):
            biased = torch.sigmoid(torch.nn.functional.linear(x.float(), w.float())) + b.float()
            top = torch.topk(biased, k, dim=-1)
            g = top.values / (top.values.sum(-1, keepdim=True) + 1e-20) if norm else top.values
            return top.indices, g * scale
        return [(moe, "route", route_biased)]
    if fault == "no_d_skip":
        chunked, step = ssd.ssd_chunked, ssd.ssd_step
        return [(ssd, "ssd_chunked", lambda x, dt, A, B, C, D, *a: chunked(
                    x, dt, A, B, C, torch.zeros_like(D), *a)),
                (ssd, "ssd_step", lambda st, x, dt, A, B, C, D: step(
                    st, x, dt, A, B, C, torch.zeros_like(D)))]
    if fault == "graphed_decode_drift":
        # the window's graphed decode serves one token otherwise; the eager
        # re-serve of the check does not go through the graphs
        run = engine.decode_graphs.run

        def drifted(key, fn, *inputs):
            tokens = run(key, fn, *inputs)[0].clone()
            tokens[-1, -1] = (tokens[-1, -1] + 1) % engine.cfg.vocab_size
            return (tokens,)
        return [(engine.decode_graphs, "run", drifted)]
    if fault == "state_reset":
        prefill = engine._prefill

        def reset_after(ids, packed, cache):
            out = prefill(ids, packed, cache)
            for name, t in cache.items():
                if name.startswith(("conv", "ssm")):
                    t.zero_()
            return out
        return [(engine, "_prefill", reset_after)]
    raise ValueError(f"lm_answer has no fault {fault!r}")


def _patched(pairs):
    old = [(o, a, getattr(o, a)) for o, a, _ in pairs]
    for o, a, v in pairs:
        setattr(o, a, v)
    return old


def run(ctx, procs=()):
    gc.collect()  # a run before this one in the process (calibration) may leave its model in cycles
    from vidil_tpu_torch.config import NemotronHConfig
    from vidil_tpu_torch.ops import grouped_expert_gemm as k7
    from vidil_tpu_torch.pipeline.lm_answer import LMAnswerEngine, WordTokenizer

    c, t, dev = ctx.config, ctx.traffic, ctx.device
    cfg = NemotronHConfig.from_dict(c)
    cuda = dev.type == "cuda"
    params = weights_lm.draw(c, ctx.seed, dev, DTYPES[c["dtype"]])
    tok = WordTokenizer.from_file(lm_traffic.write_vocab(lm_traffic.vocab_path(),
                                                         cfg.vocab_size))
    pool = lm_traffic.prompt_pool(t, ctx.seed, tok)
    P = len(pool)
    n_moe = cfg.hybrid_override_pattern.count("E")
    engine = LMAnswerEngine(params, cfg, tok, max_prompt_tokens=t["max_prompt_tokens"],
                            max_new_tokens=t["max_new_tokens"], device=dev)
    restore = _patched(_fault_patches(ctx.fault, engine))
    spans = harness.Spans(ctx.trace, dev)
    engine._prefill = spans.device_span("prefill", engine._prefill)
    engine._decode = spans.device_span("decode", engine._decode)
    dispatch = spans.host_span("dispatch", engine.dispatch_chunk)
    complete = spans.host_span("complete", engine.complete_chunk)
    counter = k7.experts_read(dev)
    lengths_of = [[len(tok.encode(p)) for p in chunk] for chunk in pool]
    tokens_of, chunk_s, start_of, read = {}, [], {}, {}

    def loop(first, deadline, limit=None, prof_from=None, prof_n=0):
        """Chunks first, first+1, ... dispatched until `deadline` (or
        `limit` of them), each completed after the next one's dispatch; a
        profile, when asked for, covers chunks prof_from .. prof_from +
        prof_n - 1 (as the CapFilt driver's loop)."""
        k, inflight, prof, done_prof = first, None, None, None
        while True:
            if k == prof_from:
                prof = harness.Profile(dev).__enter__()
                read["before"] = counter.clone()
            new = None
            if harness.clock() < deadline and (limit is None or k < first + limit):
                start_of[k] = harness.clock()
                new = (k, dispatch(pool[k % P]))
                k += 1
            if inflight is not None:
                j, d = inflight
                complete(d)
                chunk_s.append(harness.clock() - start_of[j])
                tokens_of[j] = d.tokens.cpu().numpy()
            if prof is not None and (k == prof_from + prof_n or new is None):
                prof.__exit__(None, None, None)
                read["after"] = counter.clone()
                prof.units = k - prof_from
                prof, done_prof = None, prof
            inflight = new
            if new is None:
                return k - first, harness.clock(), done_prof

    with torch.no_grad():
        w = t["warmup_chunks"]
        loop(-w, float("inf"), limit=w)
        if cuda:
            torch.cuda.synchronize()
        spans.clear()
        chunk_s.clear()
        tokens_of.clear()
        if ctx.trace:
            harness.Profile.warm_up(dev)
        harness.freeze_heap()
        setup_s = harness.clock() - ctx.t0

        t_start = harness.clock()
        n, t_end, prof = loop(0, t_start + ctx.seconds,
                              prof_from=t["profile_from"] if ctx.trace else None,
                              prof_n=t["profile_chunks"])
    window_s = t_end - t_start
    done = sorted(tokens_of)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    gc.unfreeze()
    answered = t["prompts"] * len(done)
    out = {"attempted": n, "failed": n - len(done), "quartiles_ms": harness.quartiles_ms(chunk_s),
           "e2e": {"samples_per_s": answered / window_s,
                   "chunk_ms_p90": harness.p90(chunk_s) * 1e3 if chunk_s else float("inf"),
                   "setup_s": setup_s},
           "device": harness.device_info(dev, ctx.world, peak)}
    if ctx.trace:
        summary = prof.summary() if prof is not None else None
        profiled = [j % P for j in range(t["profile_from"], t["profile_from"] + t["profile_chunks"])]
        B, A = t["prompts"], t["max_new_tokens"]
        decode_experts = int((read["after"] - read["before"])[0]) if "after" in read else 0
        out["trace"] = {
            "host_ms": spans.host_ms(), "device_ms": spans.device_ms(), "chunks": n,
            "window_s": window_s, "chips": ctx.world, "profile": summary,
            "flops": sum(flops_lm.chunk_flops(c, lengths_of[j % P], A) for j in done),
            "k7_bound_s": flops_lm.k7_bound_s(
                c, [cfg.num_experts_per_tok * sum(lengths_of[j]) for j in profiled
                    for _ in range(2 * n_moe)],
                len(profiled) * (A - 1) * 2 * n_moe, B * cfg.num_experts_per_tok,
                decode_experts)}
        if summary is not None:
            out["device"]["busy_s"] = summary["busy_s"]
            out["device"]["window_s"] = summary["window_s"]
            out["breakdown"] = harness.breakdown(summary)

    # the check: one completed chunk served again with the probe on
    engine.decode_graphs = None
    engine._caches.clear()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    rng = np.random.default_rng([int(ctx.seed) % (1 << 63), 5])
    j = int(rng.choice(done))
    prompts = pool[j % P]
    rows = sorted(int(r) for r in rng.choice(len(prompts), t["check_prompts"], replace=False))
    engine.probe = {}
    with torch.no_grad():
        again = engine.dispatch_chunk(prompts)
        engine.complete_chunk(again)
    ids, packing = engine.encode(prompts)
    starts = packing.starts
    records = [judge_lm.record(ids[starts[r]:starts[r] + packing.lengths[r]], tokens_of[j][r],
                               engine.probe, r, int(starts[r]), n_moe) for r in rows]
    mismatch = int(np.count_nonzero(again.tokens.cpu().numpy() != tokens_of[j]))
    for o, a, v in restore:
        setattr(o, a, v)
    del engine, again
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    readings = judge_lm.numbers(c, params, records, dev)
    reference_s = time.perf_counter() - t0
    out["checks"] = dict({k: v for k, v in readings.items() if not k.startswith("_")},
                         rerun_mismatched_tokens=mismatch)
    out["detail"] = dict({k: v for k, v in readings.items() if k.startswith("_")},
                         _chunk=j, _rows=rows, _reference_s=reference_s)
    if ctx.control:
        out["control"] = judge_lm.numbers(c, params, records, dev, served="fp8")
    return out
