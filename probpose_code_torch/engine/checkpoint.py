"""Checkpoints: reference ``.pth`` files, and weights moved from the JAX package.

``save_checkpoint`` writes the runner's checkpoints (the port's copy of
``probpose_code_tpu/engine/checkpoint.py:26-68``, ``save_checkpoint`` and
``latest_checkpoint``) in mmpose's ``.pth`` layout instead of the JAX
package's orbax directories: ``state_dict`` under the reference names,
``meta`` (``epoch``, ``iter`` and ``step``, ``dataset_meta``) and
``optimizer`` (the AdamW moments by parameter name and their update count),
written by ``torch.save`` and read back by ``load_checkpoint``, by the JAX
package's ``load_torch_checkpoint`` (``convert_torch_state_dict``) and by
mmpose. ``latest_checkpoint`` finds the newest ``epoch_N.pth``.

``load_checkpoint`` loads a reference mmpose checkpoint straight into the
port's modules (the names are the reference's): a bare state dict, or a file
written by mmpose's runner, ``{"state_dict": ..., "meta": {"dataset_meta":
...}, ...}``, whose metainfo holds numpy arrays. Like the JAX package's
``load_torch_checkpoint`` (``probpose_code_tpu/engine/checkpoint.py:1020``)
and ``load_weights`` (``apis/inference.py:77-104``), keys the file lacks keep
their initial values. Unlike the JAX package, it does not unpickle arbitrary
classes unless told to: tensors, containers and numpy arrays only, and
``trusted=True`` for a file that carries anything else.
``state_dict_from_jax`` turns the JAX package's ``{"params", "batch_stats"}``
tree of numpy arrays into the port's state dict: the inverse of
``probpose_code_tpu/engine/checkpoint.py:convert_torch_state_dict``
(``:680-836``) for the ViT and HRNet backbones with a ProbMapHead, a
DoubleProbMapHead (its ``first_head`` and ``second_head`` towers under the
ProbMapHead's tower names) or a HeatmapHead (a neck has no parameters).
"""

from __future__ import annotations

import logging
import os
import os.path as osp
import pickle
import re
from collections import OrderedDict
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from probpose_code_torch.engine.optim import AdamState

logger = logging.getLogger(__name__)


def _numpy_globals() -> List[Any]:
    """What ``torch.load(weights_only=True)`` must admit to rebuild numpy
    arrays and scalars: the array reconstructor and ``scalar`` under the names
    numpy 1.x and 2.x pickle them by, ``ndarray``, ``dtype``, the dtype
    classes of every numeric, boolean, string and datetime type, and
    ``bytes``, by which an empty array's data is pickled (the face tables'
    empty ``sigmas`` and skeleton colours)."""
    multiarray = (getattr(np, "_core", None) or np.core).multiarray
    allowed: List[Any] = [np.ndarray, np.dtype, bytes]
    for fn in (multiarray._reconstruct, multiarray.scalar):
        allowed += [(fn, f"{module}.{fn.__name__}") for module in ("numpy.core.multiarray", "numpy._core.multiarray")]
    allowed += sorted({type(np.dtype(code)) for code in "?bBhHiIlLqQefdgFDGSUMm"}, key=str)
    return allowed


def read_checkpoint(path: str, trusted: bool = False) -> Dict[str, Any]:
    """The object a ``.pth`` file holds; see ``load_checkpoint`` for
    ``trusted``."""
    if trusted:
        return torch.load(path, map_location="cpu", weights_only=False)
    try:
        with torch.serialization.safe_globals(_numpy_globals()):
            return torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as err:
        raise pickle.UnpicklingError(
            f"{path} holds objects other than tensors, containers and numpy arrays; "
            f"pass trusted=True to unpickle it fully if its source is trusted.\n{err}"
        ) from err


def save_checkpoint(path: str, model, optimizer, opt_state: AdamState, meta: Dict[str, Any], **extra) -> None:
    """Write ``model``'s weights, ``optimizer``'s state ``opt_state`` and
    ``meta`` to ``path`` as one ``.pth`` file (see the module); ``extra``
    entries are stored beside them. The file is written under a temporary
    name and renamed, so a reader never sees half of it. The JAX runner
    ignores ``max_keep_ckpts`` and so does the port: every checkpoint
    stays."""
    ckpt = dict(
        meta=dict(meta),
        state_dict=OrderedDict((k, v.detach().cpu()) for k, v in model.module.state_dict().items()),
        optimizer=dict(count=int(opt_state.count),
                       mu={n: t.cpu() for n, t in zip(optimizer.names, opt_state.mu)},
                       nu={n: t.cpu() for n, t in zip(optimizer.names, opt_state.nu)}),
        **extra,
    )
    tmp = f"{path}.tmp"
    torch.save(ckpt, tmp)
    os.replace(tmp, path)


def adam_state_from_checkpoint(optimizer, saved: Dict[str, Any]) -> AdamState:
    """A checkpoint's ``optimizer`` entry as the AdamState of ``optimizer``,
    its moments on the parameters' devices; a parameter the file lacks
    raises."""
    missing = [n for n in optimizer.names if n not in saved["mu"]]
    if missing:
        raise KeyError(f"the checkpoint's optimizer state lacks {len(missing)} parameters (first: {missing[:3]})")
    return AdamState(
        count=int(saved["count"]),
        mu=[saved["mu"][n].to(p.device, p.dtype) for n, p in zip(optimizer.names, optimizer.params)],
        nu=[saved["nu"][n].to(p.device, p.dtype) for n, p in zip(optimizer.names, optimizer.params)],
    )


def latest_checkpoint(work_dir: str) -> Optional[str]:
    """The newest ``epoch_N.pth`` in a work dir, or None."""
    if not osp.isdir(work_dir):
        return None
    epochs = [int(m.group(1)) for m in (re.fullmatch(r"epoch_(\d+)\.pth", n) for n in os.listdir(work_dir)) if m]
    return osp.join(work_dir, f"epoch_{max(epochs)}.pth") if epochs else None


def load_checkpoint(model, path: str, trusted: bool = False) -> Dict[str, Any]:
    """Load a reference ``.pth`` into ``model.module``: a state dict, or a
    runner's ``{"state_dict": ..., "meta": ...}``.

    Without ``trusted`` only tensors, containers and numpy arrays are
    unpickled, and a file that holds any other class is refused;
    ``trusted=True`` unpickles everything, as ``torch.load`` with
    ``weights_only=False`` does (only for files from a trusted source).
    Parameters and buffers the file lacks keep their values, and are logged
    and returned; keys the model lacks are logged and ignored. It raises
    ``KeyError`` when no key of the file is the model's, or when keys are
    missing and unknown ones stand beside them (another model, or a
    ``module.`` prefix), and ``RuntimeError`` on a shape that differs. Returns ``{"missing_keys": [...], "meta": {...}}``, the
    file's ``meta`` (empty for a bare state dict).
    """
    obj = read_checkpoint(path, trusted)
    state = obj.get("state_dict", obj)
    own = model.module.state_dict()
    missing = [k for k in own if k not in state]
    unexpected = [k for k in state if k not in own]
    if len(unexpected) == len(state) or (missing and unexpected):
        # a file for another model, or the model's keys under other names
        # (a ``module.`` prefix): loading it would leave initial weights
        raise KeyError(f"{path} does not hold this model's weights: {len(missing)} of its keys are missing "
                       f"(first: {missing[:3]}) and {len(unexpected)} keys are unknown (first: {unexpected[:3]})")
    model.module.load_state_dict(state, strict=False)
    if missing:
        logger.warning("%s lacks %d keys, which keep their initial values: %s", path, len(missing), ", ".join(missing))
    if unexpected:
        logger.warning("%s has %d keys the model does not use: %s", path, len(unexpected), ", ".join(unexpected))
    return dict(missing_keys=missing, meta=obj.get("meta", {}))


def _conv(kernel: np.ndarray) -> np.ndarray:  # flax HWIO -> torch OIHW
    return np.transpose(kernel, (3, 2, 0, 1))


def _deconv(kernel: np.ndarray) -> np.ndarray:
    # flax ConvTranspose HWIO with flipped taps -> torch (in, out, kh, kw)
    return np.transpose(kernel[::-1, ::-1], (2, 3, 0, 1))


def _vit_from_jax(sd: Dict[str, np.ndarray], bb: Dict[str, Any]) -> None:
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


def _bn_from_jax(sd: Dict[str, np.ndarray], prefix: str, p_node: Dict[str, Any], s_node: Dict[str, Any]) -> None:
    sd[f"{prefix}.weight"] = p_node["scale"]
    sd[f"{prefix}.bias"] = p_node["bias"]
    sd[f"{prefix}.running_mean"] = s_node["mean"]
    sd[f"{prefix}.running_var"] = s_node["var"]
    sd[f"{prefix}.num_batches_tracked"] = np.zeros((), np.int64)


_HRNET_FUSE = re.compile(r"fuse(\d+)_(\d+)(?:_down(\d+))?_(conv|bn)$")


def _hrnet_from_jax(sd: Dict[str, np.ndarray], bb: Dict[str, Any], bb_s: Dict[str, Any]) -> None:
    """The inverse of ``probpose_code_tpu/engine/checkpoint.py:
    convert_torch_hrnet_backbone`` (``:90-180``): flax module names -> mmpose's."""

    def put(prefix, node, stats, name):
        if name.endswith("conv") or name.startswith("conv"):
            sd[f"{prefix}.weight"] = _conv(node[name]["kernel"])
        else:
            _bn_from_jax(sd, prefix, node[name], stats[name])

    def block(prefix, node, stats):
        for name in node:
            torch_name = {"downsample_conv": "downsample.0", "downsample_bn": "downsample.1"}.get(name, name)
            put(f"{prefix}.{torch_name}", node, stats, name)

    for name in ("conv1", "bn1", "conv2", "bn2"):
        put(f"backbone.{name}", bb, bb_s, name)
    for name in bb:
        m = re.fullmatch(r"layer1_block(\d+)", name)
        if m:
            block(f"backbone.layer1.{m.group(1)}", bb[name], bb_s.get(name, {}))
            continue
        m = re.fullmatch(r"transition(\d+)_(\d+)_(conv|bn)", name)
        if m:
            t, b, kind = int(m.group(1)), int(m.group(2)), m.group(3)
            # stage t has t branches: branch t is the new one, a nested Sequential
            nested = ".0" if b == t else ""
            put(f"backbone.transition{t}.{b}{nested}.{0 if kind == 'conv' else 1}", bb, bb_s, name)
            continue
        m = re.fullmatch(r"stage(\d+)_module(\d+)", name)
        if m:
            prefix, node, stats = f"backbone.stage{m.group(1)}.{m.group(2)}", bb[name], bb_s.get(name, {})
            for sub in node:
                b = re.fullmatch(r"branch(\d+)_block(\d+)", sub)
                if b:
                    block(f"{prefix}.branches.{b.group(1)}.{b.group(2)}", node[sub], stats.get(sub, {}))
                    continue
                i, j, k, kind = _HRNET_FUSE.match(sub).groups()
                step = "" if k is None else f".{k}"
                put(f"{prefix}.fuse_layers.{i}.{j}{step}.{0 if kind == 'conv' else 1}", node, stats, sub)


def state_dict_from_jax(variables: Dict[str, Any]) -> "OrderedDict[str, torch.Tensor]":
    """JAX ``{"params", "batch_stats"}`` (a ViT or an HRNet; a ProbMapHead,
    a DoubleProbMapHead or a HeatmapHead) -> torch state dict."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    sd: Dict[str, np.ndarray] = {}

    bb = params["backbone"]
    if "patch_embed" in bb:
        _vit_from_jax(sd, bb)
    else:
        _hrnet_from_jax(sd, bb, stats.get("backbone", {}))

    head, head_s = params["head"], stats.get("head", {})

    def tower(prefix, node, node_s):
        """A heatmap tower: deconv stack, conv stack, final layer."""
        deconv = node.get("deconv_layers", {})
        j = 0
        while f"deconv{j}" in deconv:
            sd[f"{prefix}.deconv_layers.{3 * j}.weight"] = _deconv(deconv[f"deconv{j}"]["kernel"])
            _bn_from_jax(sd, f"{prefix}.deconv_layers.{3 * j + 1}", deconv[f"bn{j}"], node_s["deconv_layers"][f"bn{j}"])
            j += 1
        conv = node.get("conv_layers", {})
        j = 0
        while f"conv{j}" in conv:  # HeatmapHead's ConvStack
            sd[f"{prefix}.conv_layers.{3 * j}.weight"] = _conv(conv[f"conv{j}"]["kernel"])
            sd[f"{prefix}.conv_layers.{3 * j}.bias"] = conv[f"conv{j}"]["bias"]
            _bn_from_jax(sd, f"{prefix}.conv_layers.{3 * j + 1}", conv[f"bn{j}"], node_s["conv_layers"][f"bn{j}"])
            j += 1
        if "final_layer" in node:
            sd[f"{prefix}.final_layer.weight"] = _conv(node["final_layer"]["kernel"])
            sd[f"{prefix}.final_layer.bias"] = node["final_layer"]["bias"]

    tower("head", head, head_s)
    for name in ("first_head", "second_head"):  # DoubleProbMapHead's two towers
        if name in head:
            tower(f"head.{name}", head[name], head_s.get(name, {}))
    for name in ("probability_layers", "visibility_layers", "oks_layers", "error_layers"):
        if name not in head:  # HeatmapHead has no towers
            continue
        node, node_s = head[name], head_s[name]
        j = 0
        while f"conv{j}" in node:
            sd[f"head.{name}.{4 * j}.weight"] = _conv(node[f"conv{j}"]["kernel"])
            sd[f"head.{name}.{4 * j}.bias"] = node[f"conv{j}"]["bias"]
            _bn_from_jax(sd, f"head.{name}.{4 * j + 1}", node[f"bn{j}"], node_s[f"bn{j}"])
            j += 1
        sd[f"head.{name}.{4 * j}.weight"] = _conv(node["final"]["kernel"])
        sd[f"head.{name}.{4 * j}.bias"] = node["final"]["bias"]

    return OrderedDict((k, torch.from_numpy(np.array(v, copy=True))) for k, v in sd.items())
