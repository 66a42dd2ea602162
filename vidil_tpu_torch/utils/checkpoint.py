"""Checkpoints of the port's trainers.

* `save_checkpoint` / `load_checkpoint`: model parameters in the JAX
  package's npz format (``vidil_tpu/utils/checkpoint.py``): '/'-joined paths
  of the JAX-layout tree (per-layer lists stacked along a leading layer
  axis, `convert.to_jax_params`), plus a ``__meta__`` JSON entry. The JAX
  package's `load_checkpoint` reads the port's files and the other way round.
* `save_train_state` / `load_train_state`: the full train state for
  ``resume:`` — parameters, both AdamW moments and the optimizer's step
  count per parameter, and the train step — under named keys of the port's
  own (``params/<path>``, ``exp_avg/<path>``, ``exp_avg_sq/<path>``,
  ``adam_step/<path>``, ``step``).
* The retrieval and pretraining states (with momentum towers and queues)
  are saved instead as the JAX package's `save_train_state` saves its
  ``RetrievalTrainState`` / ``PretrainState``: one ``leaf_NNNNN`` array per
  leaf of that NamedTuple in JAX's flatten order (dict keys sorted,
  per-layer lists stacked), the optax ``inject_hyperparams(adamw)`` state
  in the layout of optax 0.2. The JAX package's `load_train_state` reads
  these files, and `load_train_state` here reads them back: their momentum
  towers and queues carry across to the JAX package.
* Why two layouts: a caption or VQA state has nothing that must cross to
  the JAX package (its parameters do, through `save_checkpoint`), and its
  named keys keep each parameter's own AdamW step count, which the leaf
  layout's one optax count cannot hold (a parameter that got no gradient in
  a step has a lower count in torch's AdamW). Loading a leaf-layout file
  gives every parameter the state's step.
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
    """A trainer's state (train/common.py:TrainState, or the retrieval /
    pretraining state, see the module docstring) -> ``path`` (.npz)."""
    if getattr(state, "params_m", None) is not None:
        leaves = {f"leaf_{i:05d}": _host(*leaf) for i, leaf in enumerate(_jax_state_leaves(state))}
        np.savez(path, **_with_meta(leaves, meta))
        return
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
    if "leaf_00000" in data.files:
        return _load_jax_state(data, state), meta
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


# ---------------------------------------------------------------------------
# the JAX package's leaf layout of RetrievalTrainState / PretrainState
# ---------------------------------------------------------------------------

def _jax_order(tree):
    """[(tensors, stacked)] of a port tree in JAX's flatten order: dict keys
    sorted; a per-layer list gives one leaf per sub-path, its layers'
    tensors stacked along a leading axis."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _jax_order(tree[k])]
    if isinstance(tree, list):
        per_layer = [_jax_order(layer) for layer in tree]
        return [([layer[j][0][0] for layer in per_layer], True)
                for j in range(len(per_layer[0]))]
    return [([tree], False)]


def _jax_state_leaves(state):
    """The leaves of the JAX package's (Retrieval|Pre)TrainState in its
    flatten order, each as (tensors, stacked): params, params_m, the queue
    (image, text, idx, ptr), the optax state (count; hyperparams b1, b2,
    eps, eps_root, learning_rate, weight_decay; adam count, mu, nu) and
    step. Scalars are numpy arrays; a moment the optimizer has not made yet
    is the zeros it starts from."""
    group = state.optimizer.param_groups[0]
    q = state.queue

    def scalar(v, dtype=np.float32):
        return [np.asarray(v, dtype)], False

    def moment(key, p):
        st = state.optimizer.state.get(p)
        return st[key] if st else torch.zeros_like(p)

    params = _jax_order(state.params)
    count = scalar(state.step, np.int32)
    return (params + _jax_order(state.params_m)
            + [([q.image], False), ([q.text], False), ([q.idx], False), scalar(q.ptr, np.int32)]
            + [count] + [scalar(v) for v in (*group["betas"], group["eps"], 0.0, group["lr"],
                                             group["weight_decay"])] + [count]
            + [([moment(key, p) for p in ts], st)
               for key in ("exp_avg", "exp_avg_sq") for ts, st in params]
            + [count])


def _host(tensors, stacked):
    arrays = [t if isinstance(t, np.ndarray) else t.detach().cpu().numpy() for t in tensors]
    return np.stack(arrays) if stacked else arrays[0]


def _shape(tensors, stacked):
    shape = tuple(np.shape(tensors[0]))
    return (len(tensors),) + shape if stacked else shape


def _load_jax_state(data, state):
    """Restore a leaf-layout file into a freshly built retrieval/pretraining
    state in place: params, momentum towers, queues, AdamW moments, step."""
    params = _jax_order(state.params)
    q = state.queue
    tensors = params + _jax_order(state.params_m) + [([q.image], False), ([q.text], False),
                                                      ([q.idx], False)]
    n_p, ptr_at = len(params), len(tensors)
    mu_at = ptr_at + 9  # after ptr, the optax count, 6 hyperparams, adam count
    keys = sorted(k for k in data.files if k != "__meta__")
    if len(keys) != mu_at + 2 * n_p + 1:
        raise ValueError(f"train state has {len(keys)} leaves, the model {mu_at + 2 * n_p + 1}")
    arrays = [data[k] for k in keys]
    moments = params + params
    for (ts, stacked), arr in zip(tensors + moments, arrays[:ptr_at] + arrays[mu_at:-1]):
        if arr.shape != _shape(ts, stacked):
            raise ValueError(f"train state leaf shape {arr.shape} does not match the model's "
                             f"{_shape(ts, stacked)}")
    step = int(arrays[-1])

    def layer(arr, stacked, i):
        return torch.from_numpy(np.array(arr[i] if stacked else arr))

    with torch.no_grad():
        for (ts, stacked), arr in zip(tensors, arrays):
            for i, t in enumerate(ts):
                t.copy_(layer(arr, stacked, i))
        for j, (ts, stacked) in enumerate(params):
            for i, p in enumerate(ts):
                state.optimizer.state[p] = {
                    "step": torch.tensor(float(step)),
                    "exp_avg": layer(arrays[mu_at + j], stacked, i).to(p.device),
                    "exp_avg_sq": layer(arrays[mu_at + n_p + j], stacked, i).to(p.device),
                }
    state.queue = state.queue._replace(ptr=int(arrays[ptr_at]))
    state.step = step
    return state
