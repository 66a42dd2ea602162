"""The check of a language-model run: what the timed path produced for a
sample of prompts of one completed chunk, held against the plain reference
(`nemotron_h.py`, float32, TF32 off), teacher-forced on the program's own
prompt and answer tokens.

A record holds, for one prompt, its ids, the answer tokens the timed
window served, and what the program computed along them when the chunk
was served again eagerly with the engine's probe on: the logits at each
answer position and each MoE layer's expert ids at each token. The
reference is forced onto the program's expert sets too (`nemotron_h.
forward(chosen=...)`, gated by its own scores): with random weights a
near-tie among 128 experts' scores decided the other way by a rounding
moves the hidden state enough to flip more choices in every later layer,
so an unforced float32 pass leaves the bf16 program's path within a few
layers (on an H100 at the cell's size: 3 % of the expert sets differ at
the first MoE layer, 90 % at the last) and measures that cascade, not the
program. Three numbers, each compared with its cell's limit:

* ``logit_gap``: over every decoded position, the widest difference
  between the program's logits and the reference's, relative to the
  reference's largest logit at that position; the worst position;
* ``answer_gap``: how far a served token's log-probability lies below
  the reference's best at its position (greedy keeps the best, so the
  gap is rounding's), up to the first </s>, in log-probability as the
  beam cell's ``decode_gap``;
* ``route_flip_share``: the share of (token, MoE layer) pairs whose set of
  chosen experts differs from the set the reference would choose at the
  same point of the forced path.

``served="fp8"`` reads the control instead: the reference computed with
float8 operands (`nemotron_h.forward(prec="fp8")`) put in the program's
place, its argmax token judged at each position.
"""

from __future__ import annotations

import torch

from reference import nemotron_h as R

EOS = 3


def record(prompt_ids, answer, probe, row: int, start: int, n_moe: int) -> dict:
    """What the check needs of prompt `row` of a probed chunk: prompt_ids
    (L,), the window's answer tokens (A,), the probe's logits (A, V) and
    its expert ids (L + A - 1, k) per MoE layer. `start` is the prompt's
    first packed token; the probe lists the prefill's n_moe route tensors
    first, then n_moe a decode step."""
    L = len(prompt_ids)
    logits = torch.stack([lg[row] for lg in probe["logits"]]).float().cpu()
    routes = []
    steps = (len(probe["route"]) - n_moe) // n_moe
    for layer in range(n_moe):
        pre = probe["route"][layer][start:start + L]
        dec = [probe["route"][n_moe * (1 + s) + layer][row:row + 1] for s in range(steps)]
        routes.append(torch.cat([pre, *dec]).cpu())
    return {"ids": torch.as_tensor(prompt_ids), "answer": torch.as_tensor(answer),
            "logits": logits, "routes": routes}


def _judged(answer) -> int:
    """Answer positions up to and including the first </s>."""
    hits = (answer == EOS).nonzero()
    return int(hits[0]) + 1 if len(hits) else len(answer)


def _flips(a, b) -> tuple[int, int]:
    n = min(len(a), len(b))
    if a.shape[1] != b.shape[1]:  # another number of experts a token: every set differs
        return n, n
    sa = torch.sort(a[:n], dim=-1).values
    sb = torch.sort(b[:n], dim=-1).values
    return int((sa != sb).any(-1).sum()), n


@torch.no_grad()
def numbers(cfg: dict, params, records, device, served: str = "program") -> dict:
    """The check's numbers over the records (see the module's docstring);
    keys starting with "_" are diagnostics."""
    R.exact_fp32()
    logit_gap, answer_gap, flips, pairs, positions = 0.0, 0.0, 0, 0, 0
    for rec in records:
        ids = torch.cat([rec["ids"], rec["answer"].long()]).to(device)
        L, A = len(rec["ids"]), len(rec["answer"])
        chosen = rec["routes"]
        ref, ref_routes = R.forward(params, cfg, ids, "fp32", logits_from=L - 1, chosen=chosen)
        ref = ref[:A]
        n = _judged(rec["answer"])
        if served == "program":
            got, got_routes = rec["logits"].to(device), rec["routes"]
            tokens = rec["answer"].long().to(device)
        else:
            got, got_routes = R.forward(params, cfg, ids, "fp8", logits_from=L - 1, chosen=chosen)
            got = got[:A]
            tokens = got.argmax(-1)
        rel = (got[:n] - ref[:n]).abs().amax(-1) / ref[:n].abs().amax(-1)
        logit_gap = max(logit_gap, rel.max().item())
        logp = torch.log_softmax(ref[:n], dim=-1)
        served_lp = logp.gather(-1, tokens[:n, None])[:, 0]
        answer_gap = max(answer_gap, (logp.amax(-1) - served_lp).max().item())
        for mine, theirs in zip(got_routes, ref_routes):
            f, m = _flips(mine.to(device), theirs[: L + A - 1])
            flips, pairs = flips + f, pairs + m
        positions += n
        del ref, got, logp
    return {"logit_gap": logit_gap, "answer_gap": answer_gap,
            "route_flip_share": flips / pairs if pairs else 1.0,
            "_positions": positions, "_route_pairs": pairs}
