"""Checkpoint converters into the port's parameter trees.

The port keeps the JAX package's parameter names and layouts — linear
kernels ``(in, out)``, the ViT patch kernel ``(P*P*C, D)`` in patchify's
(ph, pw, c) order — except that per-layer parameters are a list of dicts
(``blocks`` / ``layers``) instead of one stacked leading axis.

* `convert_blip_decoder` / `convert_blip_itm` / `convert_blip_retrieval` /
  `convert_blip_vqa`: a BLIP torch ``.pth`` state dict (reference key names)
  -> port params.
* `convert_clip`: an HF ``CLIPModel`` state dict -> port params.
* `from_jax_params`: the JAX package's parameter pytree, as numpy arrays
  (or tensors) with stacked layers -> port params.
* `to_jax_params`: its inverse, port params -> the JAX layout as numpy
  arrays (checkpoints in the JAX package's format).
* `from_jax_train_state`: the JAX package's ``RetrievalTrainState`` /
  ``PretrainState`` -> the parts the port's retrieval and pretraining
  states are built from (`train.retrieval.create_train_state`); the way
  back is `utils.checkpoint.save_train_state`.
"""

from __future__ import annotations

import numpy as np
import torch

from vidil_tpu_torch.config import CLIPConfig, MedConfig, ViTConfig

# per-layer subtrees: the ViT's blocks, a MED tower's layers and the
# pretraining decoder's own attention blocks (models/blip_pretrain.py)
STACKED_KEYS = ("blocks", "layers", "decoder_attn")


def _t(x):
    if isinstance(x, torch.Tensor):
        return x
    x = np.asarray(x)
    # a transposed view, or a read-only view of a JAX array; copy() keeps a
    # 0-d array 0-d, where np.ascontiguousarray would make it 1-d
    if not (x.flags.c_contiguous and x.flags.writeable):
        x = x.copy()
    return torch.from_numpy(x)


def from_jax_params(tree):
    """JAX-layout params -> port params: every leaf becomes a tensor, and
    the stacked per-layer subtrees (`STACKED_KEYS`) become lists of
    per-layer dicts."""
    def conv(node):
        if isinstance(node, dict):
            return {k: (_unstack(v) if k in STACKED_KEYS else conv(v)) for k, v in node.items()}
        return _t(node)

    def _unstack(node):
        stacked = conv(node)
        n = _first_leaf(stacked).shape[0]
        return [_index(stacked, i) for i in range(n)]

    return conv(tree)


def to_jax_params(tree):
    """Port params -> JAX-layout params: every leaf becomes a numpy array
    (detached, on the host), and each per-layer list (``blocks``,
    ``layers``) becomes one subtree stacked along a leading layer axis."""
    def conv(node):
        if isinstance(node, dict):
            return {k: (_stack([conv(x) for x in v]) if k in STACKED_KEYS else conv(v))
                    for k, v in node.items()}
        return node.detach().cpu().numpy()

    return conv(tree)


def from_jax_train_state(jax_state) -> dict:
    """A JAX ``RetrievalTrainState`` / ``PretrainState`` whose leaves are
    numpy arrays (or anything np.asarray takes) -> {"params", "params_m",
    "queue" (a `QueueState`, ptr an int), "step"}, port trees of CPU
    tensors. The optax moments are not carried."""
    from vidil_tpu_torch.models.blip_retrieval import QueueState

    q = jax_state.queue
    return {"params": from_jax_params(jax_state.params),
            "params_m": from_jax_params(jax_state.params_m),
            "queue": QueueState(_t(q.image), _t(q.text), _t(q.idx), int(np.asarray(q.ptr))),
            "step": int(np.asarray(jax_state.step))}


def _stack(nodes):
    if isinstance(nodes[0], dict):
        return {k: _stack([n[k] for n in nodes]) for k in nodes[0]}
    return np.stack(nodes)


def named_leaves(tree, prefix: str = ""):
    """[(path, tensor)] of a port tree in a fixed order: dict keys as
    inserted, list items by index, '/'-joined."""
    if isinstance(tree, dict):
        return [item for k, v in tree.items() for item in named_leaves(v, f"{prefix}{k}/")]
    if isinstance(tree, list):
        return [item for i, v in enumerate(tree) for item in named_leaves(v, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def _first_leaf(node):
    while isinstance(node, dict):
        node = next(iter(node.values()))
    return node


def _index(node, i):
    if isinstance(node, dict):
        return {k: _index(v, i) for k, v in node.items()}
    return node[i]


def to_device(tree, device):
    """Move every tensor of a parameter tree to `device`."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, device) for v in tree]
    return tree.to(device)


# ---------------------------------------------------------------------------
# BLIP torch state dicts (reference key names)
# ---------------------------------------------------------------------------

def _np(x):
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def _lin(sd, prefix):
    return {"kernel": _t(_np(sd[prefix + ".weight"]).T), "bias": _t(_np(sd[prefix + ".bias"]))}


def _ln(sd, prefix):
    return {"scale": _t(_np(sd[prefix + ".weight"])), "bias": _t(_np(sd[prefix + ".bias"]))}


def convert_vit(sd: dict, cfg: ViTConfig, prefix: str = "visual_encoder.") -> dict:
    p = prefix
    conv_w = _np(sd[p + "patch_embed.proj.weight"])  # (D, C, P, P)
    D = conv_w.shape[0]
    kernel = conv_w.transpose(2, 3, 1, 0).reshape(-1, D)  # (P*P*C, D), (ph, pw, c) order
    blocks = []
    for i in range(cfg.num_layers):
        b = f"{p}blocks.{i}."
        blocks.append({
            "norm1": _ln(sd, b + "norm1"),
            "attn": {"qkv": _lin(sd, b + "attn.qkv"), "proj": _lin(sd, b + "attn.proj")},
            "norm2": _ln(sd, b + "norm2"),
            "mlp": {"fc1": _lin(sd, b + "mlp.fc1"), "fc2": _lin(sd, b + "mlp.fc2")},
        })
    pos_embed = _np(sd[p + "pos_embed"])
    if pos_embed.shape[1] != cfg.seq_len:
        from vidil_tpu_torch.models.vit import interpolate_pos_embed

        pos_embed = interpolate_pos_embed(pos_embed, cfg.num_patches)
    return {
        "patch_embed": {"kernel": _t(kernel), "bias": _t(_np(sd[p + "patch_embed.proj.bias"]))},
        "cls_token": _t(_np(sd[p + "cls_token"])),
        "pos_embed": _t(pos_embed),
        "blocks": blocks,
        "norm": _ln(sd, p + "norm"),
    }


def convert_med(sd: dict, cfg: MedConfig, prefix: str = "",
                lm_head_prefix: str | None = None) -> dict:
    """A BERT/MED tower; prefix e.g. ``"text_encoder."`` or
    ``"text_decoder.bert."``; lm_head_prefix e.g. ``"text_decoder."`` also
    pulls ``cls.predictions.*`` (the decoder weight is tied to the word
    embedding)."""
    p = prefix
    layers = []
    for i in range(cfg.num_layers):
        b = f"{p}encoder.layer.{i}."
        layer = {
            "self_attn": {
                "query": _lin(sd, b + "attention.self.query"),
                "key": _lin(sd, b + "attention.self.key"),
                "value": _lin(sd, b + "attention.self.value"),
                "out": _lin(sd, b + "attention.output.dense"),
                "norm": _ln(sd, b + "attention.output.LayerNorm"),
            },
            "mlp": {"fc1": _lin(sd, b + "intermediate.dense"), "fc2": _lin(sd, b + "output.dense")},
            "mlp_norm": _ln(sd, b + "output.LayerNorm"),
        }
        if cfg.add_cross_attention and (b + "crossattention.self.query.weight") in sd:
            layer["cross_attn"] = {
                "query": _lin(sd, b + "crossattention.self.query"),
                "key": _lin(sd, b + "crossattention.self.key"),
                "value": _lin(sd, b + "crossattention.self.value"),
                "out": _lin(sd, b + "crossattention.output.dense"),
                "norm": _ln(sd, b + "crossattention.output.LayerNorm"),
            }
        layers.append(layer)
    params = {
        "embeddings": {
            "word": {"embedding": _t(_np(sd[p + "embeddings.word_embeddings.weight"]))},
            "position": {"embedding": _t(_np(sd[p + "embeddings.position_embeddings.weight"]))},
            "norm": _ln(sd, p + "embeddings.LayerNorm"),
        },
        "layers": layers,
    }
    if lm_head_prefix is not None:
        h = lm_head_prefix
        params["cls"] = {
            "transform": {"dense": _lin(sd, h + "cls.predictions.transform.dense"),
                          "norm": _ln(sd, h + "cls.predictions.transform.LayerNorm")},
            "bias": _t(_np(sd[h + "cls.predictions.bias"])),
        }
        dec_key = h + "cls.predictions.decoder.weight"
        if dec_key in sd and not np.allclose(_np(sd[dec_key]),
                                             _np(sd[p + "embeddings.word_embeddings.weight"])):
            raise ValueError("checkpoint has an untied LM decoder weight; the port "
                             "assumes tied embeddings (as all BLIP checkpoints are)")
    return params


_SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
}


def load_safetensors(path: str) -> dict:
    """A ``.safetensors`` file -> {name: CPU tensor}, without the
    safetensors package: an 8-byte little-endian header length, a JSON
    header of {name: {dtype, shape, data_offsets}} (and ``__metadata__``),
    then the raw little-endian buffers, offsets relative to the header's
    end."""
    import json
    import struct

    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = bytearray(f.read())
    sd = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        begin, end = info["data_offsets"]
        dtype = _SAFETENSORS_DTYPES[info["dtype"]]
        t = torch.frombuffer(data, dtype=dtype, count=(end - begin) // dtype.itemsize,
                             offset=begin) if end > begin else torch.empty(0, dtype=dtype)
        sd[name] = t.reshape(info["shape"]).clone()
    return sd


def load_torch_state_dict(path: str) -> dict:
    if path.endswith(".safetensors"):
        return load_safetensors(path)
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("model", ckpt) if isinstance(ckpt, dict) else ckpt
    return {k: v.detach() if isinstance(v, torch.Tensor) else v for k, v in sd.items()}


def convert_blip_decoder(sd: dict, vit_cfg: ViTConfig, med_cfg: MedConfig) -> dict:
    """BLIP_Decoder checkpoint -> {'visual_encoder', 'text_decoder'}."""
    return {
        "visual_encoder": convert_vit(sd, vit_cfg, "visual_encoder."),
        "text_decoder": convert_med(sd, med_cfg, prefix="text_decoder.bert.",
                                    lm_head_prefix="text_decoder."),
    }


def convert_blip_itm(sd: dict, vit_cfg: ViTConfig, med_cfg: MedConfig) -> dict:
    """BLIP_ITM checkpoint -> {'visual_encoder', 'text_encoder', projections, 'itm_head'}."""
    return {
        "visual_encoder": convert_vit(sd, vit_cfg, "visual_encoder."),
        "text_encoder": convert_med(sd, med_cfg, prefix="text_encoder."),
        "vision_proj": _lin(sd, "vision_proj"),
        "text_proj": _lin(sd, "text_proj"),
        "itm_head": _lin(sd, "itm_head"),
    }


def convert_blip_retrieval(sd: dict, vit_cfg: ViTConfig, med_cfg: MedConfig,
                           with_momentum: bool = True) -> dict:
    """BLIP_Retrieval[_Video] checkpoint -> the ITM tree, plus the momentum
    encoders under 'momentum' (when asked for and present) and 'temp'."""
    params = convert_blip_itm(sd, vit_cfg, med_cfg)
    if with_momentum and "visual_encoder_m.cls_token" in sd:
        params["momentum"] = {
            "visual_encoder": convert_vit(sd, vit_cfg, "visual_encoder_m."),
            "text_encoder": convert_med(sd, med_cfg, prefix="text_encoder_m."),
            "vision_proj": _lin(sd, "vision_proj_m"),
            "text_proj": _lin(sd, "text_proj_m"),
        }
    if "temp" in sd:
        params["temp"] = _t(_np(sd["temp"]).reshape(()))
    return params


def convert_blip_vqa(sd: dict, vit_cfg: ViTConfig, med_cfg: MedConfig) -> dict:
    """BLIP_VQA checkpoint -> {'visual_encoder', 'text_encoder', 'text_decoder'}."""
    return {
        "visual_encoder": convert_vit(sd, vit_cfg, "visual_encoder."),
        "text_encoder": convert_med(sd, med_cfg, prefix="text_encoder."),
        "text_decoder": convert_med(sd, med_cfg, prefix="text_decoder.bert.",
                                    lm_head_prefix="text_decoder."),
    }


# ---------------------------------------------------------------------------
# HF CLIP
# ---------------------------------------------------------------------------

def _clip_tower_layers(sd, prefix, n_layers):
    layers = []
    for i in range(n_layers):
        b = f"{prefix}.layers.{i}."
        layers.append({
            "norm1": _ln(sd, b + "layer_norm1"),
            "attn": {
                "query": _lin(sd, b + "self_attn.q_proj"),
                "key": _lin(sd, b + "self_attn.k_proj"),
                "value": _lin(sd, b + "self_attn.v_proj"),
                "out": _lin(sd, b + "self_attn.out_proj"),
            },
            "norm2": _ln(sd, b + "layer_norm2"),
            "mlp": {"fc1": _lin(sd, b + "mlp.fc1"), "fc2": _lin(sd, b + "mlp.fc2")},
        })
    return layers


def convert_clip(sd: dict, cfg: CLIPConfig) -> dict:
    """HF CLIPModel state dict -> port CLIP params; the patch convolution
    becomes a (P*P*C, D) kernel in patchify's (ph, pw, c) order."""
    conv_w = _np(sd["vision_model.embeddings.patch_embedding.weight"])  # (D, C, P, P)
    D = conv_w.shape[0]
    pre = "vision_model.pre_layrnorm"  # HF's spelling; later versions fix it
    if pre + ".weight" not in sd:
        pre = "vision_model.pre_layernorm"
    vision = {
        "patch_embed": {"kernel": _t(conv_w.transpose(2, 3, 1, 0).reshape(-1, D))},
        "class_embedding": _t(_np(sd["vision_model.embeddings.class_embedding"])),
        "pos_embed": _t(_np(sd["vision_model.embeddings.position_embedding.weight"])),
        "pre_norm": _ln(sd, pre),
        "layers": _clip_tower_layers(sd, "vision_model.encoder", cfg.vision_layers),
        "post_norm": _ln(sd, "vision_model.post_layernorm"),
    }
    text = {
        "token_embedding": {
            "embedding": _t(_np(sd["text_model.embeddings.token_embedding.weight"]))},
        "pos_embed": _t(_np(sd["text_model.embeddings.position_embedding.weight"])),
        "layers": _clip_tower_layers(sd, "text_model.encoder", cfg.text_layers),
        "final_norm": _ln(sd, "text_model.final_layer_norm"),
    }
    return {
        "vision": vision,
        "text": text,
        "visual_projection": {"kernel": _t(_np(sd["visual_projection.weight"]).T)},
        "text_projection": {"kernel": _t(_np(sd["text_projection.weight"]).T)},
        "logit_scale": _t(_np(sd["logit_scale"]).reshape(())),
    }
