"""The check of the Kimi Linear cell: what the timed path produced for a
sample of prompts of one completed chunk, held against the plain reference
(`kimi_linear.py`, float32, TF32 off), teacher-forced on the program's own
prompt and answer tokens and forced onto its expert sets. The same three
numbers as the Nemotron-H cell's (`judge_lm.py`, whose records this
reads): ``logit_gap``, ``answer_gap`` and ``route_flip_share``. The
reference runs the sampled prompts as one batch (its delta rule token by
token over all of them at once), so the check stays within seconds at the
cell's lengths.

``served="fp8"`` reads the control instead: the reference computed with
float8 operands (`kimi_linear.forward_batch(prec="fp8")`) put in the
program's place, its argmax token judged at each position.
"""

from __future__ import annotations

import torch

from reference import kimi_linear as R
from reference.judge_lm import _flips, _judged, record  # noqa: F401  (record: the driver's)


@torch.no_grad()
def numbers(cfg: dict, params, records, device, served: str = "program") -> dict:
    """The check's numbers over the records (see `judge_lm.numbers`); keys
    starting with "_" are diagnostics."""
    R.exact_fp32()
    seqs = [torch.cat([rec["ids"], rec["answer"].long()]) for rec in records]
    froms = [len(rec["ids"]) - 1 for rec in records]
    chosen = [rec["routes"] for rec in records]
    refs = R.forward_batch(params, cfg, seqs, "fp32", froms, chosen)
    controls = R.forward_batch(params, cfg, seqs, "fp8", froms, chosen) \
        if served == "fp8" else None
    logit_gap, answer_gap, flips, pairs, positions = 0.0, 0.0, 0, 0, 0
    for i, rec in enumerate(records):
        L, A = len(rec["ids"]), len(rec["answer"])
        ref, ref_routes = refs[i]
        ref = ref[:A]
        n = _judged(rec["answer"])
        if controls is None:
            got, got_routes = rec["logits"].to(device), rec["routes"]
            tokens = rec["answer"].long().to(device)
        else:
            got, got_routes = controls[i]
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
    return {"logit_gap": logit_gap, "answer_gap": answer_gap,
            "route_flip_share": flips / pairs if pairs else 1.0,
            "_positions": positions, "_route_pairs": pairs}
