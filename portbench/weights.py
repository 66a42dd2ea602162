"""Random BLIP weights from a seed, drawn on the device in a few large
calls, at BLIP's initial distribution: every linear kernel, embedding,
[CLS] token and position embedding truncated normal with std 0.02 (cut at
two standard deviations), every bias zero, every LayerNorm scale one.

`draw(spec, seed, device)` lays one flat buffer of truncated-normal draws
over the spec's leaves in order, so the same seed gives the same tree on
any call; the program and the reference are handed trees from it. The
tree's layout is the one the port's models take: (in, out) kernels,
``blocks`` and ``layers`` as lists.
"""

from __future__ import annotations

import math

import torch

STD = 0.02
_U = (math.erf(-math.sqrt(2.0)), math.erf(math.sqrt(2.0)))  # inverse-CDF range of +-2 std


def _lin(i, o):
    return {"kernel": ((i, o), "normal"), "bias": ((o,), "zeros")}


def _ln(d):
    return {"scale": ((d,), "ones"), "bias": ((d,), "zeros")}


def vit_spec(c: dict) -> dict:
    d, p = c["hidden_size"], c["patch_size"]
    m = int(d * c["mlp_ratio"])
    block = {"norm1": _ln(d), "attn": {"qkv": _lin(d, 3 * d), "proj": _lin(d, d)},
             "norm2": _ln(d), "mlp": {"fc1": _lin(d, m), "fc2": _lin(m, d)}}
    return {"patch_embed": _lin(p * p * 3, d),
            "cls_token": ((1, 1, d), "normal"),
            "pos_embed": ((1, (c["image_size"] // p) ** 2 + 1, d), "normal"),
            "blocks": [block] * c["num_layers"],
            "norm": _ln(d)}


def med_spec(c: dict, lm_head: bool) -> dict:
    d, w = c["hidden_size"], c["encoder_width"]

    def attn(kv):
        return {"query": _lin(d, d), "key": _lin(kv, d), "value": _lin(kv, d), "out": _lin(d, d),
                "norm": _ln(d)}

    layer = {"self_attn": attn(d), "cross_attn": attn(w),
             "mlp": {"fc1": _lin(d, c["intermediate_size"]),
                     "fc2": _lin(c["intermediate_size"], d)},
             "mlp_norm": _ln(d)}
    tree = {"embeddings": {"word": {"embedding": ((c["vocab_size"], d), "normal")},
                           "position": {"embedding": ((c["max_position_embeddings"], d), "normal")},
                           "norm": _ln(d)},
            "layers": [layer] * c["num_layers"]}
    if lm_head:
        tree["cls"] = {"transform": {"dense": _lin(d, d), "norm": _ln(d)},
                       "bias": ((c["vocab_size"],), "zeros")}
    return tree


def captioner_spec(cfg: dict) -> dict:
    """BLIP_Decoder: the ViT and the MED decoder with its LM head."""
    return {"visual_encoder": vit_spec(cfg["vit"]), "text_decoder": med_spec(cfg["med"], True)}


def filterer_spec(cfg: dict) -> dict:
    """BLIP_ITM: the ViT, the MED encoder, the contrastive projections and
    the ITM head."""
    d, e = cfg["med"]["hidden_size"], cfg["itm_embed_dim"]
    return {"visual_encoder": vit_spec(cfg["vit"]), "text_encoder": med_spec(cfg["med"], False),
            "vision_proj": _lin(cfg["vit"]["hidden_size"], e), "text_proj": _lin(d, e),
            "itm_head": _lin(d, 2)}


def leaves(tree, prefix=()):
    """(path, leaf) pairs of a spec or a parameter tree, in a fixed order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], prefix + (k,))
    elif isinstance(tree, list):
        for i, t in enumerate(tree):
            yield from leaves(t, prefix + (i,))
    else:
        yield prefix, tree


def draw(spec, seed: int, device, salt: int = 0) -> dict:
    """The tree of `spec` with fresh float32 leaves on `device`: one uniform
    draw for all truncated-normal leaves (a generator on `device` seeded
    from `seed` and `salt`), mapped through the normal's inverse CDF."""
    normal = [shape for _, (shape, kind) in leaves(spec) if kind == "normal"]
    total = sum(math.prod(s) for s in normal)
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1000003 + salt) % (1 << 63))
    flat = torch.empty(total, dtype=torch.float32, device=device)
    flat.uniform_(*_U, generator=gen)
    flat.erfinv_().mul_(STD * math.sqrt(2.0)).clamp_(-2.0 * STD, 2.0 * STD)
    # leaves take their pieces in `leaves` order, the order they were cut in
    pieces = iter(flat.split([math.prod(s) for s in normal]))
    out = {}
    for path, (shape, kind) in leaves(spec):
        if kind == "normal":
            t = next(pieces).view(shape)
        elif kind == "ones":
            t = torch.ones(shape, device=device)
        else:
            t = torch.zeros(shape, device=device)
        out[path] = t
    return nest(out)


def nest(flat: dict):
    """{path: tensor} -> nested dicts, with integer keys as lists."""
    root: dict = {}
    for path, t in flat.items():
        node = root
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t

    def fix(node):
        if not isinstance(node, dict):
            return node
        if node and all(isinstance(k, int) for k in node):
            return [fix(node[i]) for i in range(len(node))]
        return {k: fix(v) for k, v in node.items()}

    return fix(root)
