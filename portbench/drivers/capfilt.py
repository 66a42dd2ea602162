"""CapFilt cells: the port's `CapFiltEngine` over chunks of videos, in a
closed loop with one chunk in flight, as `run_video_CapFilt` runs it
(dispatch chunk n+1, then complete chunk n).

Set-up draws the captioner's and the filterer's weights on the device,
builds the engine, makes the traffic's pool of distinct chunks on the
host (frames in pinned memory, as the CLI's loader stages them) and runs
`warmup_chunks` chunks through the loop. The window then
dispatches chunks from the pool until `--seconds` have passed and
completes the one in flight. Afterwards a sample of the completed chunks,
drawn from the seed and holding the longest caption, is held against the
plain reference (`reference/judge_capfilt.py`).
"""

from __future__ import annotations

import gc
from collections import defaultdict

import numpy as np
import torch

import flops
import generate
import harness
import weights
from reference import judge_capfilt

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def model_config(cfg: dict) -> dict:
    """The configuration with the prompt's decoder length filled in."""
    g = dict(cfg["generation"])
    g["prompt_length"] = 1 + len(generate.word_ids(g["prompt"]))
    return dict(cfg, generation=g)


def make_engine(cfg, seed, device):
    from vidil_tpu_torch.config import MedConfig, ViTConfig
    from vidil_tpu_torch.pipeline.capfilt import CapFiltEngine
    from vidil_tpu_torch.tokenizer import BlipTokenizer

    cap = weights.draw(weights.captioner_spec(cfg), seed, device, salt=1)
    fil = weights.draw(weights.filterer_spec(cfg), seed, device, salt=2)
    tok = BlipTokenizer(generate.write_vocab(generate.vocab_path()))
    g, e = cfg["generation"], cfg["engine"]
    return CapFiltEngine(
        cap, fil, tok, ViTConfig(**cfg["vit"]), MedConfig(**cfg["med"]), prompt=g["prompt"],
        num_beams=g["num_beams"], max_length=g["max_length"], min_length=g["min_length"],
        itm_max_text_len=cfg["itm_max_text_len"], dtype=DTYPES[e["dtype"]],
        length_norm=g["length_norm"], beam_group_kv=e["beam_group_kv"],
        fused_filter=e["fused_filter"], device=device)


def _plant(engine, fault):
    """Break the timed path for the benchmark's own tests of its check."""
    if fault == "token":
        gen = engine.generate_beam

        def altered(embeds):
            seqs = gen(embeds).clone()
            i = engine.prompt_length + 1  # the caption's second token
            seqs[:, i] = (seqs[:, i] + 7919) % 30000 + 104  # another word
            return seqs

        engine.generate_beam = altered
    elif fault == "answer":
        itm = engine._itm_grouped
        engine._itm_grouped = lambda *a, **k: 1.0 - itm(*a, **k)
    elif fault is not None:
        raise ValueError(f"capfilt has no fault {fault!r}")


def _chunk_flops(cfg, pcfg, V, F, seqs, texts):
    """Matmul operations one chunk needs: the encodes, the beam decode and
    the ITM over its real text tokens."""
    total = 0.0
    n = V * F
    if pcfg.get("caption", True):
        total += flops.vit_flops(n, cfg["vit"]) + flops.beam_decode_flops(n, cfg)
    if pcfg.get("filter", True):
        total += flops.vit_flops(n, cfg["vit"])
        lengths = judge_capfilt.itm_text_lengths(cfg, pcfg, seqs, texts, V, F)
        total += flops.itm_flops(n, [lengths[v] for v in range(V) for _ in range(F)], cfg)
    return total


def run(ctx, procs=()):
    cfg = model_config(ctx.config)
    t = ctx.traffic
    pcfg = t["capfilt"]
    dev = ctx.device
    V, F = t["videos"], t["frames"]
    engine = make_engine(cfg, ctx.seed, dev)
    _plant(engine, ctx.fault)
    pool = generate.capfilt_pool(t, ctx.seed)
    P = len(pool)
    cuda = dev.type == "cuda"
    staged = [[torch.from_numpy(v["frames"]).pin_memory() if cuda else v["frames"] for v in c]
              for c in pool]

    def loaded(k):
        """Chunk k as the CLI's loader hands it to the engine: each video's
        frames uploaded from pinned memory, the host not waiting for the
        copy (`run_video_CapFilt.py`'s `to_device`)."""
        return [dict(v, frames=f.to(dev, non_blocking=True) if cuda else f)
                for v, f in zip(pool[k % P], staged[k % P])]

    spans = harness.Spans(ctx.trace, dev)
    current = {"chunk": None}
    probs_of = defaultdict(list)  # chunk -> outputs of its grouped ITM calls
    itm = engine._itm_grouped

    def itm_kept(*a, **k):
        out = itm(*a, **k)
        probs_of[current["chunk"]].append(out)
        return out

    engine._itm_grouped = spans.device_span("itm", itm_kept)
    engine._encode = spans.device_span("encode", engine._encode)
    engine.generate_beam = spans.host_span("decode", engine.generate_beam)
    dispatch = spans.host_span("dispatch", engine.dispatch_chunk)
    complete = spans.host_span("complete", engine.complete_chunk)

    seqs_of, results_of, chunk_s, start_of = {}, {}, [], {}

    def finish(j, d):
        current["chunk"] = j
        res = complete(d)
        done = harness.clock()
        if d.seqs_dev is not None:
            seqs_of[j] = d.seqs_host if d.seqs_host is not None else d.seqs_dev.cpu()
        results_of[j] = res
        return done

    def loop(first, deadline, limit=None, prof_from=None, prof_n=0):
        """Chunks first, first+1, ... dispatched until `deadline` (or
        `limit` of them), each completed after the next one's dispatch.
        A profile, when asked for, covers the dispatches of chunks
        prof_from .. prof_from + prof_n - 1 with the completions between
        them. Returns the chunks dispatched, the clock at the last
        completion and the profile."""
        k, inflight, prof, done_prof = first, None, None, None
        while True:
            if k == prof_from:
                prof = harness.Profile(dev).__enter__()
            new = None
            if harness.clock() < deadline and (limit is None or k < first + limit):
                current["chunk"] = k
                start_of[k] = harness.clock()
                new = (k, dispatch(loaded(k), pcfg))
                k += 1
            if inflight is not None:
                j, d = inflight
                chunk_s.append(finish(j, d) - start_of[j])
            if prof is not None and (k == prof_from + prof_n or new is None):
                prof.__exit__(None, None, None)
                prof.units = k - prof_from
                prof, done_prof = None, prof
            inflight = new
            if new is None:
                return k - first, harness.clock(), done_prof

    w = t["warmup_chunks"]
    loop(-w, float("inf"), limit=w)
    if cuda:
        torch.cuda.synchronize()
    spans.clear()
    chunk_s.clear()
    results_of.clear()
    seqs_of.clear()
    probs_of.clear()
    if ctx.trace:
        harness.Profile.warm_up(dev)
    harness.freeze_heap()
    setup_s = harness.clock() - ctx.t0

    t_start = harness.clock()
    n, t_end, prof = loop(0, t_start + ctx.seconds, prof_from=t["profile_from"] if ctx.trace
                          else None, prof_n=t["profile_chunks"])
    window_s = t_end - t_start
    done = sorted(results_of)
    attempted, failed = n, n - len(done)
    frames = V * F * len(done)

    seqs_np = {j: np.asarray(s.numpy()) for j, s in seqs_of.items()}
    probs_np = {j: [p.float().cpu().numpy() for p in ps] for j, ps in probs_of.items()}
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    gc.unfreeze()
    out = {"attempted": attempted, "failed": failed, "quartiles_ms": harness.quartiles_ms(chunk_s),
           "e2e": {"frames_per_s": frames / window_s,
                   "chunk_ms_p90": harness.p90(chunk_s) * 1e3 if chunk_s else float("inf"),
                   "setup_s": setup_s},
           "device": harness.device_info(dev, ctx.world, peak)}
    total_flops = sum(_chunk_flops(cfg, pcfg, V, F, seqs_np.get(j),
                                   [r.unfiltered_text for r in results_of[j]]) for j in done)
    if ctx.trace:
        summary = prof.summary() if prof is not None else None
        vit = cfg["vit"]
        tokens = (vit["image_size"] // vit["patch_size"]) ** 2 + 1
        out["trace"] = {"host_ms": spans.host_ms(), "device_ms": spans.device_ms(),
                        "chunks": n, "window_s": window_s, "flops": total_flops,
                        "chips": ctx.world, "profile": summary,
                        "k1_bound_s": flops.attention_bound_s(
                            V * F, vit["num_heads"], tokens, tokens,
                            vit["hidden_size"] // vit["num_heads"])}
        if summary is not None:
            out["device"]["busy_s"] = summary["busy_s"]
            out["device"]["window_s"] = summary["window_s"]
            out["breakdown"] = harness.breakdown(summary)

    # the check, after the program's state is freed
    del engine, dispatch, complete, itm, itm_kept
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    sample = _sample(ctx.seed, done, seqs_np, t["check_chunks"],
                     cfg["generation"]["prompt_length"])
    records = [judge_capfilt.record(pool[j % P], seqs_np.get(j),
                                    probs_np.get(j, []), results_of[j], V, F) for j in sample]
    limits = ctx.workload.get("limits", {})
    cap = weights.draw(weights.captioner_spec(cfg), ctx.seed, dev, salt=1) \
        if pcfg.get("caption", True) else None
    fil = weights.draw(weights.filterer_spec(cfg), ctx.seed, dev, salt=2)
    readings = judge_capfilt.numbers(cfg, pcfg, cap, fil, records, dev,
                                     band=limits.get("itm_gap", 0.0))
    out["checks"] = {k: v for k, v in readings.items() if not k.startswith("_")}
    out["detail"] = {k: v for k, v in readings.items() if k.startswith("_")}
    if ctx.control:
        out["control"] = judge_capfilt.numbers(cfg, pcfg, cap, fil, records, dev,
                                               band=limits.get("itm_gap", 0.0), served="fp8")
    return out


def _sample(seed, done, seqs_np, n, prompt_length):
    """`n` completed chunks drawn from the seed, the one holding the
    longest caption among them."""
    if not done:
        return []
    rng = np.random.default_rng([int(seed) % (1 << 63), 3])
    pick = list(rng.choice(done, size=min(n, len(done)), replace=False))
    if seqs_np:
        longest = max(done, key=lambda j: judge_capfilt.longest_caption(seqs_np[j],
                                                                           prompt_length))
        if longest not in pick:
            pick[-1] = longest
    return sorted(int(j) for j in pick)
