"""Batched beam search and nucleus sampling on the device.

Counterpart of ``vidil_tpu/ops/generation.py``: `beam_search`, a
fixed-shape loop over decode steps with the beam bookkeeping (hypothesis
store, stop heuristic, length normalization) vectorized over the batch,
in two dialects (``GenerationConfig.length_norm``): ``"legacy"``
(transformers v4.15, the reference's captions) and ``"modern"``
(transformers >= 4.50); `nucleus_sample`, HF's ``do_sample=True,
top_p=...`` with one Gumbel-max draw per step; and `greedy_search`, a
fixed number of argmax tokens after a prefill (the language-model stage,
`pipeline/lm_answer.py`).

The model is abstracted behind three closures:

  prefill_fn(ids, cache)            -> (last_logits, cache)   # prompt pass
  step_fn(tokens, step_idx, cache)  -> (logits, cache)        # one token
  reorder_fn(cache, flat_beam_idx)  -> cache                  # beam gather

Tie order matches ``jax.lax.top_k`` / ``jnp.argsort(stable=True)``: the
lower index first. ``torch.topk`` promises no tie order, so the top
candidates come from a stable descending sort.

The loop is host-driven and, with ``early_exit=False``, never reads
device values, so a whole decode is enqueued without a host sync.
``early_exit=True`` checks after each step whether every batch row is
done (one host sync per step); the outputs are the same either way,
because steps after a row is done change nothing.

Random draws come from an explicit ``torch.Generator`` on the logits'
device; torch and JAX draw different streams, so sampling is held to the
JAX package by feeding both the same per-step noise (`nucleus_sample`'s
``noise``).

Spans (`utils/profiling.py:annotate`) name each part of a decode:
``decode.prefill`` (the prompt pass and the loop's initial state),
``decode.select`` (one step's bookkeeping: scores, top-k or the draw,
hypotheses, the stop rule), ``decode.reorder`` (the cache's beam gather) and
``decode.step`` (one token through the decoder). `beam_search` enters
them as pieces (``piece``), which CUDA graphs can capture and replay
(`ops/decode_graph.py`).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from vidil_tpu_torch.ops.decode_graph import eager_piece
from vidil_tpu_torch.utils.profiling import annotate

NEG_INF = -1e9
HYP_INVALID = -1e30


@dataclass(frozen=True)
class GenerationConfig:
    max_length: int = 30
    min_length: int = 10
    num_beams: int = 3
    eos_token_id: int = 102  # BERT [SEP]
    pad_token_id: int = 0
    repetition_penalty: float = 1.0
    length_penalty: float = 1.0
    top_p: float = 0.9
    length_norm: str = "legacy"  # "legacy" (reference parity) | "modern"
    early_exit: bool = True


def _apply_repetition_penalty(scores, seqs, cur_len: int, penalty: float):
    """HF RepetitionPenaltyLogitsProcessor on the tokens in seqs[:, :cur_len]."""
    if penalty == 1.0:
        return scores
    presence = torch.zeros_like(scores, dtype=torch.bool)
    presence.scatter_(1, seqs[:, :cur_len].long(), True)
    penalized = torch.where(scores < 0, scores * penalty, scores / penalty)
    return torch.where(presence, penalized, scores)


def _apply_min_length(scores, cur_len: int, min_length: int, eos_token_id: int):
    """HF MinLengthLogitsProcessor: eos impossible while len < min_length."""
    if cur_len < min_length:
        scores = scores.clone()
        scores[:, eos_token_id] = float("-inf")
    return scores


def _top_p_filter(logits, top_p: float):
    """HF TopPLogitsWarper: keep the smallest prefix of the descending-prob
    distribution whose mass reaches top_p (always >= 1 token); a token is
    dropped when the mass *before* it exceeds top_p, so ties at the
    threshold stay."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    sorted_probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(sorted_probs, dim=-1)
    remove_sorted = (cum - sorted_probs) > top_p
    inf = torch.full_like(sorted_logits, float("inf"))
    threshold = torch.where(remove_sorted, inf, sorted_logits).amin(dim=-1, keepdim=True)
    return torch.where(logits < threshold, torch.full_like(logits, float("-inf")), logits)


def gumbel_noise(shape, generator: torch.Generator, device):
    """Standard Gumbel noise G = -log(-log U), U uniform from `generator`,
    clamped into (0, 1) so that G is finite."""
    u = torch.rand(shape, generator=generator, device=device)
    u = u.clamp_(torch.finfo(torch.float32).tiny, 1.0 - 2.0 ** -24)
    return -torch.log(-torch.log(u))


def gumbel_argmax(log_weights, noise):
    """One draw per row of softmax(log_weights) (rows may hold -inf):
    argmax(log_weights + G), the first index on ties. This is how
    jax.random.categorical draws, so JAX's noise gives JAX's draw."""
    return torch.argmax(log_weights.float() + noise, dim=-1)


def _topk_stable(x, k: int):
    """Top-k along the last axis, lower index first on ties (jax.lax.top_k)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _take_rows(x, idx):
    """x (B, N, ...) gathered along axis 1 by idx (B, K) -> (B, K, ...)."""
    b = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[b, idx]


def beam_search(prompt_ids, init_cache, prefill_fn, step_fn, reorder_fn, gen: GenerationConfig,
                piece=eager_piece):
    """Batched beam search.

    prompt_ids: (B, Lp) int — the same (unpadded) prompt length per row.
    init_cache: cache sized for batch B*num_beams and gen.max_length.
    Returns sequences (B, max_length) int32 padded with pad_token_id, and
    scores (B,) fp32 — the length-normalized best-hypothesis scores.
    piece(span): the context of each piece of the search, its spans
    eagerly; every tensor operation lies inside one, so that a capture
    (`ops/decode_graph.py`) records all of them.
    """
    B, Lp = prompt_ids.shape
    nb = gen.num_beams
    lp = gen.length_penalty
    modern = gen.length_norm == "modern"
    if gen.max_length <= Lp:
        raise ValueError("max_length must exceed prompt length")
    dev = prompt_ids.device
    max_len = gen.max_length

    with piece("decode.prefill"):
        flat_prompt = prompt_ids.to(torch.int32).repeat_interleave(nb, dim=0)  # (B*nb, Lp)
        last_logits, cache = prefill_fn(flat_prompt, init_cache)
        V = last_logits.shape[-1]

        seqs = torch.full((B * nb, max_len), gen.pad_token_id, dtype=torch.int32, device=dev)
        seqs[:, :Lp] = flat_prompt
        beam_scores = torch.full((B, nb), NEG_INF, dtype=torch.float32, device=dev)
        beam_scores[:, 0] = 0.0
        hyp_s = torch.full((B, nb), HYP_INVALID, dtype=torch.float32, device=dev)
        hyp_q = torch.full((B, nb, max_len), gen.pad_token_id, dtype=torch.int32, device=dev)
        hyp_l = torch.zeros((B, nb), dtype=torch.int32, device=dev)
        blocked = torch.zeros((B,), dtype=torch.bool, device=dev)
        batch_offset = torch.arange(B, device=dev) * nb
        rank = torch.arange(2 * nb, device=dev)

    for cur_len in range(Lp, max_len):
        if gen.early_exit and bool(blocked.all()):
            break
        with piece("decode.select"):
            logp = torch.log_softmax(last_logits.float(), dim=-1)
            logp = _apply_repetition_penalty(logp, seqs, cur_len, gen.repetition_penalty)
            logp = _apply_min_length(logp, cur_len, gen.min_length, gen.eos_token_id)
            scores = (logp + beam_scores.reshape(-1)[:, None]).reshape(B, nb * V)
            top_scores, top_idx = _topk_stable(scores, 2 * nb)
            top_tokens = (top_idx % V).to(torch.int32)
            top_beams = top_idx // V
            beam_seqs = seqs.reshape(B, nb, max_len)

            # --- candidate hypotheses (only ranks < num_beams are eligible) ---
            is_eos = top_tokens == gen.eos_token_id
            hits = (is_eos | (cur_len + 1 >= max_len)) if modern else is_eos
            cand_valid = hits & (rank < nb)[None] & ~blocked[:, None]
            norm_len = float(cur_len + 1 - Lp) if modern else float(cur_len)
            cand_scores = torch.where(cand_valid, top_scores / (norm_len ** lp),
                                      torch.full_like(top_scores, HYP_INVALID))
            cand_seqs = _take_rows(beam_seqs, top_beams)  # (B, 2nb, max_len)
            if modern:
                cand_seqs = cand_seqs.clone()
                cand_seqs[:, :, cur_len] = top_tokens
                cand_lens = torch.full((B, 2 * nb), cur_len + 1, dtype=torch.int32, device=dev)
            else:
                cand_lens = torch.full((B, 2 * nb), cur_len, dtype=torch.int32, device=dev)
            merged_s = torch.cat([hyp_s, cand_scores], dim=1)
            order = torch.argsort(-merged_s, dim=1, stable=True)[:, :nb]
            hyp_s = torch.gather(merged_s, 1, order)
            hyp_q = _take_rows(torch.cat([hyp_q, cand_seqs], dim=1), order)
            hyp_l = torch.gather(torch.cat([hyp_l, cand_lens], dim=1), 1, order)

            # --- next running beams ---
            if modern:
                running = top_scores + hits.float() * NEG_INF
                nxt_scores, sel = _topk_stable(running, nb)
                nxt_tokens = torch.gather(top_tokens, 1, sel)
                nxt_beams = torch.gather(top_beams, 1, sel)
            else:
                # first num_beams non-eos candidates in rank order; done rows
                # emit pad / beam 0 / score 0
                key = torch.where(is_eos, 2 * nb + rank, rank)
                sel = torch.argsort(key, dim=1)[:, :nb]
                bl = blocked[:, None]
                nxt_scores = torch.where(bl, 0.0, torch.gather(top_scores, 1, sel))
                nxt_tokens = torch.where(bl, gen.pad_token_id, torch.gather(top_tokens, 1, sel))
                nxt_beams = torch.where(bl, 0, torch.gather(top_beams, 1, sel))

            # --- stop heuristic ---
            valid = hyp_s > HYP_INVALID / 2
            count = valid.sum(dim=1)
            worst = torch.where(valid, hyp_s, torch.full_like(hyp_s, float("inf"))).amin(dim=1)
            if modern:
                best_possible = nxt_scores.amax(dim=1) / (float(cur_len + 1 - Lp) ** lp)
            else:
                best_possible = top_scores[:, 0] / (float(cur_len) ** lp)
            blocked = blocked | ((count == nb) & (worst >= best_possible))

            flat_idx = (batch_offset[:, None] + nxt_beams).reshape(-1)
            seqs = seqs[flat_idx]
            flat_tokens = nxt_tokens.reshape(-1).to(torch.int32)
            seqs[:, cur_len] = flat_tokens
            beam_scores = nxt_scores.to(torch.float32)
        if cur_len + 1 < max_len:
            # the last step's logits would feed no further step
            with piece("decode.reorder"):
                cache = reorder_fn(cache, flat_idx)
            with piece("decode.step"):
                last_logits, cache = step_fn(flat_tokens, cur_len, cache)

    with piece(None):  # --- finalize ---
        beam_seqs = seqs.reshape(B, nb, max_len)
        if not modern:
            # legacy: rows not done force-add all running beams (length =
            # max_length) before the best hypothesis is picked
            final_norm = beam_scores / (float(max_len) ** lp)
            cand = torch.where(blocked[:, None], torch.full_like(final_norm, HYP_INVALID),
                               final_norm)
            merged_s = torch.cat([hyp_s, cand], dim=1)
            order = torch.argsort(-merged_s, dim=1, stable=True)[:, :nb]
            hyp_s = torch.gather(merged_s, 1, order)
            hyp_q = _take_rows(torch.cat([hyp_q, beam_seqs], dim=1), order)
            full = torch.full((B, nb), max_len, dtype=torch.int32, device=dev)
            hyp_l = torch.gather(torch.cat([hyp_l, full], dim=1), 1, order)
        best = torch.argmax(hyp_s, dim=1)
        seq = hyp_q[torch.arange(B, device=dev), best]  # (B, max_len)
        ln = hyp_l[torch.arange(B, device=dev), best][:, None]
        pos = torch.arange(max_len, device=dev)[None]
        if not modern:
            # legacy appends eos at position `len` when there is room
            seq = torch.where((pos == ln) & (ln < max_len), gen.eos_token_id, seq)
            seq = torch.where(pos > ln, gen.pad_token_id, seq)
        else:
            seq = torch.where(pos >= ln, gen.pad_token_id, seq)
        seq = seq.to(torch.int32)
        out_scores = hyp_s[torch.arange(B, device=dev), best]
    return seq, out_scores


def nucleus_sample(prompt_ids, init_cache, prefill_fn, step_fn, gen: GenerationConfig,
                   generator: torch.Generator | None = None, noise=None):
    """Batched top-p sampling (HF ``do_sample=True, top_p=...``): per step,
    repetition penalty, min-length, the top-p filter, then one Gumbel-max
    draw per row. A finished row emits pad; with ``gen.early_exit`` the
    loop stops when every row is done (the tokens are those of the full
    run).

    prompt_ids: (B, Lp); init_cache sized for batch B. The noise of step
    t (= cur_len - Lp) is `gumbel_noise` from `generator`, or
    ``noise[t]`` when `noise` (T, B, V) is given (the tests feed the JAX
    package's per-step draws). Returns (B, max_length) int32 padded with
    pad_token_id."""
    B, Lp = prompt_ids.shape
    if gen.max_length <= Lp:
        raise ValueError("max_length must exceed prompt length")
    if noise is None and generator is None:
        raise ValueError("nucleus_sample needs a generator or the noise")
    dev = prompt_ids.device
    max_len = gen.max_length
    with annotate("decode.prefill"):
        prompt_ids = prompt_ids.to(torch.int32)
        last_logits, cache = prefill_fn(prompt_ids, init_cache)
        seqs = torch.full((B, max_len), gen.pad_token_id, dtype=torch.int32, device=dev)
        seqs[:, :Lp] = prompt_ids
        finished = torch.zeros((B,), dtype=torch.bool, device=dev)
    for cur_len in range(Lp, max_len):
        if gen.early_exit and bool(finished.all()):
            break
        with annotate("decode.select"):
            logits = last_logits.float()
            logits = _apply_repetition_penalty(logits, seqs, cur_len, gen.repetition_penalty)
            logits = _apply_min_length(logits, cur_len, gen.min_length, gen.eos_token_id)
            logits = _top_p_filter(logits, gen.top_p)
            g = (noise[cur_len - Lp] if noise is not None
                 else gumbel_noise(logits.shape, generator, logits.device))
            sampled = gumbel_argmax(logits, g).to(torch.int32)
            tokens = torch.where(finished, torch.full_like(sampled, gen.pad_token_id), sampled)
            seqs[:, cur_len] = tokens
            finished = finished | (tokens == gen.eos_token_id)
        if cur_len + 1 < max_len:
            with annotate("decode.step"):
                last_logits, cache = step_fn(tokens, cur_len, cache)
    return seqs


def greedy_search(first_logits, cache, step_fn, max_new_tokens: int, eos_token_id: int,
                  pad_token_id: int, piece=eager_piece):
    """`max_new_tokens` greedy tokens a row after a prefill whose
    last-position logits are `first_logits` (B, V): the argmax (the first
    index on ties), then ``step_fn(tokens, cache) -> (logits, cache)`` for
    each further token. A row that has emitted eos emits pad. The loop
    never reads the device and keeps its shapes, so a capture
    (`ops/decode_graph.py`) can record it: each step is one piece in the
    span ``lm.decode``. Returns (B, max_new_tokens) int32."""
    B = first_logits.shape[0]
    with piece("lm.decode"):
        out = torch.full((B, max_new_tokens), pad_token_id, dtype=torch.int32,
                         device=first_logits.device)
        tokens = torch.argmax(first_logits, dim=-1)
        out[:, 0] = tokens.to(torch.int32)
        finished = tokens == eos_token_id
    for t in range(1, max_new_tokens):
        with piece("lm.decode"):
            logits, cache = step_fn(tokens, cache)
            nxt = torch.argmax(logits, dim=-1)
            nxt = torch.where(finished, torch.full_like(nxt, pad_token_id), nxt)
            out[:, t] = nxt.to(torch.int32)
            finished = finished | (nxt == eos_token_id)
            tokens = nxt
    return out
