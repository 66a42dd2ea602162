"""The check of a caption-training run: the program's first three steps,
which set-up drives through the window's own step call on three distinct
global batches, against the plain reference's three steps from the same
weights on the same global batches (`model.py`, float32, TF32 off, AdamW
written out here).

Three numbers, each compared with its cell's limit:

* ``loss_gap``: the widest relative gap between the program's loss and
  the reference's, over the three steps;
* ``grad_gap``: the first step's gradient as the optimizer got it (the
  program's from AdamW's first moment after one step, m / (1 - beta1));
  per parameter leaf the gap between the program's norm and the
  reference's, over the reference's norm of that leaf or of the median
  leaf, whichever is larger; the worst leaf;
* ``update_gap``: the same for each leaf's change over the three steps,
  leaving out leaves whose reference gradient is under a thousandth of the
  median leaf's (nought but rounding, as a key bias under softmax; AdamW
  moves them by their rounding's sign alone).
"""

from __future__ import annotations

import math

import torch

import generate
import weights
from reference import model as M

BETAS, EPS = (0.9, 0.999), 1e-8


def program_reading(state, params0, step_index: int) -> dict:
    """Per-leaf norms read from the program's train state: after step 1,
    the gradient AdamW holds; after step 3, the change from `params0`."""
    opt = state.optimizer
    out = {}
    for path, p in weights.leaves(state.params):
        if step_index == 1:
            m = opt.state.get(p, {}).get("exp_avg", torch.zeros_like(p))
            out[path] = torch.linalg.vector_norm(m) / (1.0 - BETAS[0])
        else:
            out[path] = torch.linalg.vector_norm(p.detach() - _get(params0, path))
    keys = list(out)
    vals = torch.stack(list(out.values())).tolist()
    return dict(zip(keys, vals))


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _rows(batch, lo, hi, device):
    return (torch.from_numpy(batch["video"][lo:hi]).to(device),
            torch.from_numpy(batch["input_ids"][lo:hi]).to(device),
            torch.from_numpy(batch["attention_mask"][lo:hi]).to(device))


def reference_steps(cfg, params, batches, prompt_length, device, prec="fp32",
                    rows_per_block=12) -> dict:
    """Three AdamW steps of the plain model from `params` (replaced in
    place by leaves that require grad) on the global `batches`. Returns the
    losses, the first gradient's per-leaf norms and the per-leaf norms of
    the change after the steps."""
    M.exact_fp32()
    tr = cfg["train"]
    lr, wd = tr["init_lr"], tr["weight_decay"]
    leaves = [(path, t) for path, t in weights.leaves(params)]
    p0 = {path: t.detach().clone() for path, t in leaves}
    ps = {path: t.detach().clone().requires_grad_(True) for path, t in leaves}
    tree = weights.nest(ps)
    m = {k: torch.zeros_like(v) for k, v in ps.items()}
    v2 = {k: torch.zeros_like(v) for k, v in ps.items()}
    losses, g1 = [], None
    for step, batch in enumerate(batches, start=1):
        n_rows = len(batch["input_ids"])
        ids_all = torch.from_numpy(batch["input_ids"])
        mask_all = torch.from_numpy(batch["attention_mask"])
        pos = torch.arange(1, ids_all.shape[1])[None]
        count = int(((mask_all[:, 1:] == 1) & (pos >= prompt_length)).sum())
        for p in ps.values():
            p.grad = None
        total = 0.0
        for lo in range(0, n_rows, rows_per_block):
            video, ids, mask = _rows(batch, lo, lo + rows_per_block, device)
            B, N = video.shape[:2]
            emb = M.vit(tree["visual_encoder"], video.reshape((B * N,) + video.shape[2:]),
                        cfg["vit"], prec)
            emb = emb.reshape(B, N * emb.shape[1], emb.shape[2])
            loss, _ = M.caption_loss(tree, emb, ids, mask, prompt_length, cfg["med"], prec,
                                     count=count)
            loss.backward()
            total += loss.item()
        losses.append(total)
        with torch.no_grad():
            if step == 1:
                g1 = {k: torch.linalg.vector_norm(p.grad).item() for k, p in ps.items()}
            for k, p in ps.items():
                g = p.grad
                m[k].mul_(BETAS[0]).add_(g, alpha=1 - BETAS[0])
                v2[k].mul_(BETAS[1]).addcmul_(g, g, value=1 - BETAS[1])
                mh = m[k] / (1 - BETAS[0] ** step)
                vh = v2[k] / (1 - BETAS[1] ** step)
                p.mul_(1 - lr * wd).sub_(lr * mh / (vh.sqrt() + EPS))
    with torch.no_grad():
        delta = {k: torch.linalg.vector_norm(p - p0[k]).item() for k, p in ps.items()}
    return {"losses": losses, "g1": g1, "delta": delta}


def _median(xs):
    xs = sorted(xs)
    n = len(xs)
    return xs[n // 2] if n % 2 else 0.5 * (xs[n // 2 - 1] + xs[n // 2])


def _worst(got: dict, want: dict, keys) -> tuple[float, str]:
    med = _median([want[k] for k in keys])
    worst, name = 0.0, ""
    for k in keys:
        gap = abs(got[k] - want[k]) / max(want[k], med, 1e-30)
        if gap > worst:
            worst, name = gap, ".".join(map(str, k))
    return worst, name


def numbers(prog: dict, ref: dict) -> dict:
    """The three numbers of `prog` (the program's, or the control's
    reading) against `ref`; keys starting with "_" are diagnostics."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    if len(prog["losses"]) != len(ref["losses"]) or not all(map(math.isfinite, prog["losses"])):
        loss_gap = math.inf
    keys = list(ref["g1"])
    grad_gap, grad_leaf = _worst(prog["g1"], ref["g1"], keys)
    med = _median([ref["g1"][k] for k in keys])
    moving = [k for k in keys if ref["g1"][k] >= 1e-3 * med]
    update_gap, update_leaf = _worst(prog["delta"], ref["delta"], moving)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "update_gap": update_gap,
            "_grad_leaf": grad_leaf, "_update_leaf": update_leaf,
            "_left_out": [".".join(map(str, k)) for k in keys if k not in moving],
            "_losses": prog["losses"], "_ref_losses": ref["losses"]}


def global_batches(t, seed, steps=3) -> list[dict]:
    """The global batches of the program's first `steps` steps."""
    return [generate.caption_batch(t, seed, b, range(t["videos"])) for b in range(steps)]
