"""Checkpoints of the caption and VQA trainers.

* `save_checkpoint` / `load_checkpoint`: model parameters in the JAX
  package's npz format (``vidil_tpu/utils/checkpoint.py``): '/'-joined paths
  of the JAX-layout tree (per-layer lists stacked along a leading layer
  axis, `convert.to_jax_params`), plus a ``__meta__`` JSON entry. The JAX
  package's `load_checkpoint` reads the port's files and the other way round.
* `save_train_state` / `load_train_state`: the full train state for
  ``resume:`` — parameters, both AdamW moments and the optimizer's step
  count per parameter, and the train step — under named keys of the port's
  own (``params/<path>``, ``exp_avg/<path>``, ``exp_avg_sq/<path>``,
  ``adam_step/<path>``, ``step``). The JAX package's train-state files are
  an optax pytree by leaf index; there is nothing in them to match.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from vidil_tpu_torch.models.convert import named_leaves, to_jax_params


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def _unflatten(flat: dict):
    tree: dict = {}
    for path, value in flat.items():
        parts = path.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _with_meta(flat: dict, meta: dict | None) -> dict:
    if meta is not None:
        flat["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    return flat


def _read(path: str):
    data = np.load(_npz_path(path), allow_pickle=False)
    meta = None
    if "__meta__" in data.files:
        meta = json.loads(bytes(data["__meta__"]).decode())
    return data, meta


def save_checkpoint(path: str, params, meta: dict | None = None) -> None:
    """Port params -> ``path`` (.npz) in the JAX package's layout."""
    np.savez(path, **_with_meta(_flatten(to_jax_params(params)), meta))


def load_checkpoint(path: str):
    """Returns (JAX-layout numpy tree, meta dict or None); convert with
    `convert.from_jax_params`."""
    data, meta = _read(path)
    return _unflatten({k: data[k] for k in data.files if k != "__meta__"}), meta


def save_train_state(path: str, state, meta: dict | None = None) -> None:
    """A trainer's state (train/common.py:TrainState) -> ``path`` (.npz)."""
    flat = {"step": np.asarray(state.step, np.int64)}
    for name, p in named_leaves(state.params):
        flat[f"params/{name}"] = p.detach().cpu().numpy()
        st = state.optimizer.state.get(p, {})
        for key in ("exp_avg", "exp_avg_sq", "step"):
            if key in st:
                flat[f"{'adam_step' if key == 'step' else key}/{name}"] = \
                    np.asarray(st[key].detach().cpu().numpy())
    np.savez(path, **_with_meta(flat, meta))


def load_train_state(path: str, state):
    """Restore a file of `save_train_state` into `state` (built fresh for
    the same configuration) in place. Returns (state, meta or None)."""
    data, meta = _read(path)
    named = named_leaves(state.params)
    want = {f"params/{name}" for name, _ in named}
    have = {k for k in data.files if k.startswith("params/")}
    if want != have:
        raise ValueError(f"train state {path} does not match the model: "
                         f"{len(want - have)} missing, {len(have - want)} unexpected parameters")
    with torch.no_grad():
        for name, p in named:
            arr = data[f"params/{name}"]
            if arr.shape != tuple(p.shape):
                raise ValueError(f"{name}: shape {arr.shape} != model {tuple(p.shape)}")
            p.copy_(torch.from_numpy(arr))
            if f"exp_avg/{name}" in data.files:
                state.optimizer.state[p] = {
                    "step": torch.tensor(float(data[f"adam_step/{name}"])),
                    "exp_avg": torch.from_numpy(data[f"exp_avg/{name}"]).to(p.device),
                    "exp_avg_sq": torch.from_numpy(data[f"exp_avg_sq/{name}"]).to(p.device),
                }
    state.step = int(data["step"])
    return state, meta
