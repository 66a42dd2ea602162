"""The Kimi Linear language-model cell: the port's `LMAnswerEngine`
answering chunks of VidIL's few-shot prompts with Kimi Linear in a closed
loop with one chunk in flight, as `vidil_tpu_torch.answer_prompts` runs
it (dispatch chunk n+1, then complete chunk n). The loop, the warm-up (an
eager decode, a captured one, a replayed one), the window and the check
are the Nemotron-H cell's (`drivers/lm_answer.py`); what differs:

* the weights (`weights_kimi.py`), the operations (`flops_kimi.py`) and the
  reference (`reference/judge_kimi.py`, the sampled prompts as one batch)
  are Kimi Linear's;
* a traced run records CUDA events around each KDA and each MLA mixer call
  of the prefill (`kimi_linear.kda_prefill`, `mla_prefill`), read as
  `kda_ms.lm` and `mla_ms.lm`, and K7's prefill rows from the program's
  counter of the rows its held experts took (`moe.held_rows`).

The check's four numbers and their meaning are the Nemotron-H cell's:
``logit_gap``, ``answer_gap``, ``route_flip_share`` against the reference,
and ``rerun_mismatched_tokens`` (limit 0.5: the replayed decode is bitwise
the eager one).
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

import flops_kimi
import harness
import lm_traffic
import weights_kimi
from reference import judge_kimi

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _fault_patches(fault, engine):
    """(object, attribute, value) triples that break the timed path, for
    the benchmark's own tests of its check and the limits' calibration."""
    from vidil_tpu_torch.models import kimi_linear
    from vidil_tpu_torch.ops import kda, moe

    if fault is None:
        return []
    if fault == "decay_per_head":  # one decay a head: the channels' mean
        gate = kda.gate
        return [(kda, "gate", lambda a, A_log, dt_bias: gate(a, A_log, dt_bias).mean(
            -1, keepdim=True).expand(-1, A_log.shape[0], a.shape[-1] // A_log.shape[0]))]
    if fault == "no_delta":  # S <- Diag(alpha) S + beta k v^T
        def wy(A, beta, Kg, V):
            return torch.zeros_like(Kg), V * beta.unsqueeze(-1)

        def write(state, k, v, beta):
            state.add_(k.unsqueeze(-1) * (beta.unsqueeze(-1) * v).unsqueeze(-2))
        return [(kda, "_wy", wy), (kda, "_write", write)]
    if fault == "no_kv_norm":
        return [(kimi_linear, "latent_norm", lambda c, w, eps: c * w)]
    if fault == "all_experts_held":  # pairs of experts held elsewhere computed on these
        routed = moe.routed_experts

        def every(x, idx, w, up, down, first=0, act="relu2"):
            return routed(x, first + (idx - first) % up.shape[0], w, up, down, first, act)
        return [(moe, "routed_experts", every)]
    if fault == "gate_by_biased_scores":
        def route_biased(x, w, b, k, scale, norm):
            biased = torch.sigmoid(torch.nn.functional.linear(x.float(), w.float())) + b.float()
            top = torch.topk(biased, k, dim=-1)
            g = top.values / (top.values.sum(-1, keepdim=True) + 1e-20) if norm else top.values
            return top.indices, g * scale
        return [(moe, "route", route_biased)]
    if fault == "graphed_decode_drift":
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
                if name.startswith(("conv", "kda")):
                    t.zero_()
            return out
        return [(engine, "_prefill", reset_after)]
    raise ValueError(f"lm_answer_kimi has no fault {fault!r}")


def _patched(pairs):
    old = [(o, a, getattr(o, a)) for o, a, _ in pairs]
    for o, a, v in pairs:
        setattr(o, a, v)
    return old


def run(ctx, procs=()):
    gc.collect()  # a run before this one in the process (calibration) may leave its model in cycles
    from vidil_tpu_torch.config import KimiLinearConfig
    from vidil_tpu_torch.models import kimi_linear
    from vidil_tpu_torch.ops import grouped_expert_gemm as k7
    from vidil_tpu_torch.ops import moe
    from vidil_tpu_torch.pipeline.lm_answer import LMAnswerEngine, WordTokenizer

    c, t, dev = ctx.config, ctx.traffic, ctx.device
    cfg = KimiLinearConfig.from_dict(c)
    cuda = dev.type == "cuda"
    params = weights_kimi.draw(c, ctx.seed, dev, DTYPES[c["dtype"]])
    tok = WordTokenizer.from_file(lm_traffic.write_vocab(lm_traffic.vocab_path(),
                                                         cfg.vocab_size))
    pool = lm_traffic.prompt_pool(t, ctx.seed, tok)
    P = len(pool)
    n_moe = cfg.num_hidden_layers - cfg.first_k_dense_replace
    engine = LMAnswerEngine(params, cfg, tok, max_prompt_tokens=t["max_prompt_tokens"],
                            max_new_tokens=t["max_new_tokens"], device=dev)
    restore = _patched(_fault_patches(ctx.fault, engine))
    spans = harness.Spans(ctx.trace, dev)
    restore += _patched([(kimi_linear, "kda_prefill",
                          spans.device_span("kda", kimi_linear.kda_prefill)),
                         (kimi_linear, "mla_prefill",
                          spans.device_span("mla", kimi_linear.mla_prefill))])
    engine._prefill = spans.device_span("prefill", engine._prefill)
    engine._decode = spans.device_span("decode", engine._decode)
    dispatch = spans.host_span("dispatch", engine.dispatch_chunk)
    complete = spans.host_span("complete", engine.complete_chunk)
    counters = (k7.experts_read(dev), moe.held_rows(dev))
    lengths_of = [[len(tok.encode(p)) for p in chunk] for chunk in pool]
    tokens_of, chunk_s, start_of, read = {}, [], {}, {}

    def loop(first, deadline, limit=None, prof_from=None, prof_n=0):
        """Chunks first, first+1, ... dispatched until `deadline` (or
        `limit` of them), each completed after the next one's dispatch; a
        profile, when asked for, covers chunks prof_from .. prof_from +
        prof_n - 1 (as the Nemotron-H driver's loop)."""
        k, inflight, prof, done_prof = first, None, None, None
        while True:
            if k == prof_from:
                prof = harness.Profile(dev).__enter__()
                read["before"] = [x.clone() for x in counters]
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
                read["after"] = [x.clone() for x in counters]
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
        n_prof = summary["units"] if summary is not None else 0
        B, A = t["prompts"], t["max_new_tokens"]
        delta = [int((a - b)[0]) for a, b in zip(read["after"], read["before"])] \
            if "after" in read else [0, 0]
        out["trace"] = {
            "host_ms": spans.host_ms(), "device_ms": spans.device_ms(), "chunks": n,
            "window_s": window_s, "chips": ctx.world, "profile": summary,
            "flops": sum(flops_kimi.chunk_flops(c, lengths_of[j % P], A) for j in done),
            "k7_bound_s": flops_kimi.k7_bound_s(
                c, delta[1], n_prof * (A - 1) * 2 * n_moe,
                B * cfg.num_experts_per_token * flops_kimi.held_share(c), delta[0])}
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
    records = [judge_kimi.record(ids[starts[r]:starts[r] + packing.lengths[r]], tokens_of[j][r],
                                 engine.probe, r, int(starts[r]), n_moe) for r in rows]
    mismatch = int(np.count_nonzero(again.tokens.cpu().numpy() != tokens_of[j]))
    for o, a, v in reversed(restore):
        setattr(o, a, v)
    del engine, again
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    readings = judge_kimi.numbers(c, params, records, dev)
    reference_s = time.perf_counter() - t0
    out["checks"] = dict({k: v for k, v in readings.items() if not k.startswith("_")},
                         rerun_mismatched_tokens=mismatch)
    out["detail"] = dict({k: v for k, v in readings.items() if k.startswith("_")},
                         _chunk=j, _rows=rows, _reference_s=reference_s)
    if ctx.control:
        out["control"] = judge_kimi.numbers(c, params, records, dev, served="fp8")
    return out
