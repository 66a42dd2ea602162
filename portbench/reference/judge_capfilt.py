"""The check of a CapFilt run: what the timed path produced for a sample of
its chunks, held against the plain reference (`model.py`, float32, TF32
off) on the same frames, weights and texts.

Two numbers, each compared with its cell's limit:

* ``decode_gap`` (cells that caption): along each frame's caption as the
  port's beam search chose it, the reference's log-probabilities at every
  generated position, up to and including the first [SEP]. Beam search
  with b beams keeps a token only from the 2b best of its beam's row, so a
  token may lie below the row's best by a margin that depends on the
  weights, not on rounding; it may not lie below the row's 2b-th best.
  The number is the widest gap by which a served token lies below the
  reference's k-th best log-probability, k = 2b for beam tokens (and k = 1
  for the argmax tokens of the control), with [SEP] barred before
  min_length as the search bars it.
* ``itm_gap``: the widest difference between the port's ITM match
  probability and the reference's, over every (text, frame) pair its
  grouped ITM call scored in the sample's chunks, with the ITM text ids
  worked out again here from the port's tokens (fused filter) or from the
  texts (filter-only); and 1 where a caption was kept or dropped against
  the reference's aggregate probability by more than the limit (`band`)
  from the threshold.

``served="fp8"`` reads the control instead: the reference computed with
float8 e4m3 operands in every linear put in the program's place (its
argmax token at each position of the port's captions, its probabilities,
its keep decisions).
"""

from __future__ import annotations

import numpy as np
import torch

import generate
from reference import model as M


def record(chunk, seqs, probs_list, results, V, F) -> dict:
    """What the check needs of one completed chunk: its frames, the
    port's tokens (V*F, T) or None, the port's first grouped-ITM output
    over the whole chunk (V, T, F), and per video the texts that were
    filtered and those kept."""
    main = next((p for p in probs_list if p.shape[0] == V), None)
    return {"frames": np.concatenate([c["frames"] for c in chunk]), "seqs": seqs,
            "probs": main, "texts": [c["text"] for c in chunk],
            "unfiltered": [r.unfiltered_text for r in results],
            "kept": [r.text for r in results], "n_results": len(results), "V": V, "F": F}


def candidates(rec, v, cfg, caption: bool) -> list[str]:
    """The texts video v's keep decisions are made on, worked out here: its
    frames' captions (the port's tokens spelled out, the prompt cut, first
    occurrences in frame order), or its original captions."""
    if not caption:
        return _sentences(rec["texts"][v])
    prompt = cfg["generation"]["prompt"]
    out = []
    for row in rec["seqs"][v * rec["F"]:(v + 1) * rec["F"]]:
        cap = generate.decode(row)[len(prompt):]
        if cap not in out:
            out.append(cap)
    return out


def _sentences(texts):
    """The original captions as the engine filters them: one sentence each
    (no sentence-ending marks in the traffic's captions), stripped."""
    return [t.strip() for t in texts if len(t.strip()) > 3]


def caption_ends(seqs: np.ndarray, prompt_length: int) -> np.ndarray:
    """Per row, the index of the last position to judge: the first [SEP]
    at or after the prompt, else the last position."""
    T = seqs.shape[1]
    tail = seqs[:, prompt_length:] == generate.SEP
    return np.where(tail.any(axis=1), tail.argmax(axis=1) + prompt_length, T - 1)


def longest_caption(seqs: np.ndarray, prompt_length: int) -> int:
    return int(caption_ends(seqs, prompt_length).max())


def fused_text_ids(seqs: np.ndarray, prompt_length: int, limit: int) -> list[list[int]]:
    """The ITM ids of each generated caption: [CLS], its tokens after the
    prompt up to the first [SEP] or [PAD] (at most `limit` - 2), [SEP]."""
    out = []
    for row in seqs[:, prompt_length:prompt_length + limit - 2]:
        cap = []
        for tok in row:
            if tok in (generate.SEP, generate.PAD):
                break
            cap.append(int(tok))
        out.append([generate.CLS] + cap + [generate.SEP])
    return out


def text_ids(text: str, limit: int) -> list[int]:
    return [generate.CLS] + generate.word_ids(text)[: limit - 2] + [generate.SEP]


def fused_limit(cfg) -> int:
    g = cfg["generation"]
    return min(cfg["itm_max_text_len"], -(-(g["max_length"] - g["prompt_length"] + 2) // 8) * 8)


def itm_text_lengths(cfg, pcfg, seqs, texts, V, F) -> list[list[int]]:
    """Per video, the real token counts of the texts its ITM call scores
    (flops accounting)."""
    if pcfg.get("caption", True) and seqs is not None:
        ids = fused_text_ids(seqs, cfg["generation"]["prompt_length"], fused_limit(cfg))
        return [[len(ids[v * F + f]) for f in range(F)] for v in range(V)]
    return [[len(text_ids(s, cfg["itm_max_text_len"])) for s in _sentences(tx)] for tx in texts]


def _pad(rows: list[list[int]], device):
    L = max(len(r) for r in rows)
    ids = torch.zeros((len(rows), L), dtype=torch.long, device=device)
    mask = torch.zeros_like(ids)
    for i, r in enumerate(rows):
        ids[i, : len(r)] = torch.tensor(r)
        mask[i, : len(r)] = 1
    return ids, mask


def _encode(p, frames_u8, cfg, device, prec, block=16):
    out = []
    for i in range(0, len(frames_u8), block):
        x = M.normalize_uint8(torch.from_numpy(frames_u8[i:i + block]).to(device))
        out.append(M.vit(p["visual_encoder"], x, cfg["vit"], prec))
    return torch.cat(out)


def _itm_video(fil, memory_v, rows, cfg, device, prec):
    """P(match) of each text row against each of one video's frames:
    (n_texts, F)."""
    F = memory_v.shape[0]
    ids, mask = _pad(rows, device)
    n = len(rows)
    ids = ids[None].expand(F, n, -1).reshape(F * n, -1)
    mask = mask[None].expand(F, n, -1).reshape(F * n, -1)
    p = M.itm_probs(fil, ids, mask, memory_v, cfg["med"], prec, group=n)
    return p.reshape(F, n).t()


def _aggregate(p, mode):
    return p.max(dim=-1).values if mode == "max_filter" else p.mean(dim=-1)


@torch.no_grad()
def numbers(cfg, pcfg, cap, fil, records, device, band: float, served: str = "program") -> dict:
    """The check's numbers over the sampled chunks (see the module's
    docstring); keys starting with "_" are diagnostics."""
    M.exact_fp32()
    g = cfg["generation"]
    Lp, nb = g["prompt_length"], g["num_beams"]
    thr, mode = pcfg["threshold"], pcfg.get("filter_mode", "max_filter")
    decode_gap, prob_gap, faults, n_tokens, n_pairs = 0.0, 0.0, 0, 0, 0
    caption = pcfg.get("caption", True)
    missing = 0
    for rec in records:
        V, F = rec["V"], rec["F"]
        missing += rec["n_results"] != V
        if caption:
            seqs = rec["seqs"]
            emb = _encode(cap, rec["frames"], cfg, device, "fp32")
            ref = _decoder_logp(cap, emb, seqs, cfg, device, "fp32")
            if served == "program":
                tokens, k = torch.from_numpy(seqs[:, 1:]).long().to(device), 2 * nb
            else:
                ctl = _decoder_logp(cap, _encode(cap, rec["frames"], cfg, device, "fp8"), seqs,
                                    cfg, device, "fp8")
                tokens, k = _bar_early_sep(ctl, g["min_length"]).argmax(dim=-1), 1
            gap, n = _token_gap(ref, tokens, k, seqs, Lp, g["min_length"])
            decode_gap, n_tokens = max(decode_gap, gap), n_tokens + n
            del emb, ref
        mem = _encode(fil, rec["frames"], cfg, device, "fp32")
        mem_c = _encode(fil, rec["frames"], cfg, device, "fp8") if served == "fp8" else None
        if caption:
            rows = fused_text_ids(rec["seqs"], Lp, fused_limit(cfg))
        for v in range(V):
            if caption:
                scored = rows[v * F:(v + 1) * F]
            else:
                scored = [text_ids(s, cfg["itm_max_text_len"]) for s in _sentences(rec["texts"][v])]
            p_ref = _itm_video(fil, mem[v * F:(v + 1) * F], scored, cfg, device, "fp32")
            if served == "program":
                if rec["probs"] is None:
                    faults += 1
                    continue
                p_srv = torch.from_numpy(rec["probs"][v, : len(scored)]).to(device)
            else:
                p_srv = _itm_video(fil, mem_c[v * F:(v + 1) * F], scored, cfg, device, "fp8")
            prob_gap = max(prob_gap, (p_srv.float() - p_ref).abs().max().item())
            n_pairs += p_ref.numel()
            # keep decisions, against the reference's aggregate of each text
            texts = candidates(rec, v, cfg, caption)
            if served == "program" and v < rec["n_results"] and texts != rec["unfiltered"][v]:
                faults += 1
            if not texts:
                continue
            trows = [text_ids(s, cfg["itm_max_text_len"]) for s in texts]
            agg = _aggregate(p_ref if not caption else _itm_video(
                fil, mem[v * F:(v + 1) * F], trows, cfg, device, "fp32"), mode)
            if served == "program":
                kept = [v < rec["n_results"] and s in rec["kept"][v] for s in texts]
            else:
                kept = (_aggregate(p_srv if not caption else _itm_video(
                    fil, mem_c[v * F:(v + 1) * F], trows, cfg, device, "fp8"), mode) > thr).tolist()
            for a, keep in zip(agg.tolist(), kept):
                faults += (keep and a < thr - band) or (not keep and a > thr + band)
        del mem, mem_c
    out = {"itm_gap": 1.0 if faults or missing else prob_gap,
           "_prob_gap": prob_gap, "_decision_faults": faults, "_pairs": n_pairs,
           "_missing_results": missing}
    if caption:
        out["decode_gap"] = decode_gap
        out["_tokens"] = n_tokens
    return out


def _decoder_logp(cap, emb, seqs, cfg, device, prec, block=32):
    """Log-probabilities (N, T-1, vocab) of the token at each position 1..T-1
    given the ones before it, by one causal pass over the port's tokens."""
    out = []
    for i in range(0, len(seqs), block):
        ids = torch.from_numpy(seqs[i:i + block]).long().to(device)
        mask = torch.ones_like(ids)
        h = M.med(cap["text_decoder"], ids, mask, emb[i:i + block], cfg["med"], prec, causal=True)
        logits = M.lm_logits(cap["text_decoder"], h[:, :-1], cfg["med"], prec)
        out.append(torch.log_softmax(logits, dim=-1))
    return torch.cat(out)


def _bar_early_sep(logp, min_length):
    """[SEP] barred at the positions before min_length, as the search bars
    it (position i of `logp` predicts token i + 1)."""
    logp = logp.clone()
    pos = torch.arange(1, logp.shape[1] + 1, device=logp.device)
    logp[:, pos < min_length, generate.SEP] = -float("inf")
    return logp


def _token_gap(ref, tokens, k, seqs, Lp, min_length):
    """Widest max(0, kth-best - served) over the judged positions, and how
    many positions were judged."""
    ref = _bar_early_sep(ref, min_length)
    pos = torch.arange(1, seqs.shape[1], device=ref.device)
    kth = ref.topk(k, dim=-1).values[..., -1]
    served = ref.gather(-1, tokens[..., None])[..., 0]
    ends = torch.from_numpy(caption_ends(seqs, Lp)).to(ref.device)
    judged = (pos[None] >= Lp) & (pos[None] <= ends[:, None])
    gap = torch.where(judged, (kth - served).clamp_min(0), torch.zeros_like(kth))
    return gap.max().item(), int(judged.sum())
