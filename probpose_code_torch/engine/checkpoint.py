"""Checkpoints: reference ``.pth`` files, and weights moved from the JAX package.

``load_checkpoint`` loads a reference mmpose state dict straight into the
port's modules (the names are the reference's). ``state_dict_from_jax``
turns the JAX package's ``{"params", "batch_stats"}`` tree of numpy arrays
into the port's state dict: the inverse of
``probpose_code_tpu/engine/checkpoint.py:convert_torch_state_dict``
(``:680-836``) for the ViT + ProbMapHead and ViT + HeatmapHead families (a
neck has no parameters).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict

import numpy as np
import torch


def load_checkpoint(model, path: str) -> None:
    """Load a reference ``.pth`` (a state dict, or ``{"state_dict": ...}``)
    into ``model.module``, every key matched. Only tensors and containers are
    unpickled."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    model.module.load_state_dict(obj.get("state_dict", obj), strict=True)


def _conv(kernel: np.ndarray) -> np.ndarray:  # flax HWIO -> torch OIHW
    return np.transpose(kernel, (3, 2, 0, 1))


def _deconv(kernel: np.ndarray) -> np.ndarray:
    # flax ConvTranspose HWIO with flipped taps -> torch (in, out, kh, kw)
    return np.transpose(kernel[::-1, ::-1], (2, 3, 0, 1))


def state_dict_from_jax(variables: Dict[str, Any]) -> "OrderedDict[str, torch.Tensor]":
    """JAX ``{"params", "batch_stats"}`` (ViT + ProbMapHead or HeatmapHead)
    -> torch state dict."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    sd: Dict[str, np.ndarray] = {}

    bb = params["backbone"]
    sd["backbone.pos_embed"] = bb["pos_embed"]
    sd["backbone.patch_embed.projection.weight"] = _conv(bb["patch_embed"]["kernel"])
    sd["backbone.patch_embed.projection.bias"] = bb["patch_embed"]["bias"]
    i = 0
    while f"block{i}" in bb:
        blk, p = bb[f"block{i}"], f"backbone.layers.{i}"
        for src, dst in (("ln1", "ln1"), ("ln2", "ln2")):
            sd[f"{p}.{dst}.weight"] = blk[src]["scale"]
            sd[f"{p}.{dst}.bias"] = blk[src]["bias"]
        for src, dst in (("qkv", "attn.qkv"), ("proj", "attn.proj")):
            sd[f"{p}.{dst}.weight"] = blk["attn"][src]["kernel"].T
            sd[f"{p}.{dst}.bias"] = blk["attn"][src]["bias"]
        for src, dst in (("mlp_fc1", "ffn.layers.0.0"), ("mlp_fc2", "ffn.layers.1")):
            sd[f"{p}.{dst}.weight"] = blk[src]["kernel"].T
            sd[f"{p}.{dst}.bias"] = blk[src]["bias"]
        i += 1
    sd["backbone.ln1.weight"] = bb["ln_final"]["scale"]
    sd["backbone.ln1.bias"] = bb["ln_final"]["bias"]

    head, head_s = params["head"], stats.get("head", {})

    def bn(prefix, p_node, s_node):
        sd[f"{prefix}.weight"] = p_node["scale"]
        sd[f"{prefix}.bias"] = p_node["bias"]
        sd[f"{prefix}.running_mean"] = s_node["mean"]
        sd[f"{prefix}.running_var"] = s_node["var"]
        sd[f"{prefix}.num_batches_tracked"] = np.zeros((), np.int64)

    deconv = head.get("deconv_layers", {})
    j = 0
    while f"deconv{j}" in deconv:
        sd[f"head.deconv_layers.{3 * j}.weight"] = _deconv(deconv[f"deconv{j}"]["kernel"])
        bn(f"head.deconv_layers.{3 * j + 1}", deconv[f"bn{j}"], head_s["deconv_layers"][f"bn{j}"])
        j += 1
    conv = head.get("conv_layers", {})
    j = 0
    while f"conv{j}" in conv:  # HeatmapHead's ConvStack
        sd[f"head.conv_layers.{3 * j}.weight"] = _conv(conv[f"conv{j}"]["kernel"])
        sd[f"head.conv_layers.{3 * j}.bias"] = conv[f"conv{j}"]["bias"]
        bn(f"head.conv_layers.{3 * j + 1}", conv[f"bn{j}"], head_s["conv_layers"][f"bn{j}"])
        j += 1
    if "final_layer" in head:
        sd["head.final_layer.weight"] = _conv(head["final_layer"]["kernel"])
        sd["head.final_layer.bias"] = head["final_layer"]["bias"]
    for name in ("probability_layers", "visibility_layers", "oks_layers", "error_layers"):
        if name not in head:  # HeatmapHead has no towers
            continue
        tower, tower_s = head[name], head_s[name]
        j = 0
        while f"conv{j}" in tower:
            sd[f"head.{name}.{4 * j}.weight"] = _conv(tower[f"conv{j}"]["kernel"])
            sd[f"head.{name}.{4 * j}.bias"] = tower[f"conv{j}"]["bias"]
            bn(f"head.{name}.{4 * j + 1}", tower[f"bn{j}"], tower_s[f"bn{j}"])
            j += 1
        sd[f"head.{name}.{4 * j}.weight"] = _conv(tower["final"]["kernel"])
        sd[f"head.{name}.{4 * j}.bias"] = tower["final"]["bias"]

    return OrderedDict((k, torch.from_numpy(np.array(v, copy=True))) for k, v in sd.items())
