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
ProbMapHead's tower names) or a HeatmapHead (a neck has no parameters); and
for the classic CNN backbones (ResNet, ResNetV1d, ResNeXt, the SE, SC,
split-attention, ShuffleNet, VGG, AlexNet and ViPNAS families, by rules
from the JAX module names to mmpose's) and ViPNASHead, whose JAX head
keeps a transposed conv a group (``deconv{i}_g{j}``): their kernels,
concatenated along the input axis, are one grouped ``ConvTranspose2d``
weight. The JAX converter has no inverse for those families but ResNet and
ResNeXt's 7x7 stem (``:839``). RTMPose's and RTMW's CSPNeXt, RTMW's
CSPNeXtPAFPN and the SimCC heads (RTMCCHead, SimCCHead, RTMWHead) take the
names that ``convert_torch_cspnext_backbone`` (``:183``),
``convert_torch_cspnext_pafpn`` (``:573``) and ``_convert_rtmw_head``
(``:621``) read, so one weights file loads in both packages; HourglassNet,
CPM, MSPN / RSN, CPMHead and MSPNHead, which no JAX converter reads, take
mmpose's names as a reading of its modules gives them
(``models/backbones/multistage.py``, ``models/heads/multistage_heads.py``),
and so do LiteHRNet, SwinTransformer, HRFormer and PVT / PVTv2 where their
structure is mmpose's (``models/backbones/litehrnet.py``,
``transformers.py``; flax LayerNorm's ``scale`` is torch's ``weight``, PVT's
``q`` and ``kv`` are stacked into ``in_proj_weight`` / ``in_proj_bias``).
The regression heads take the JAX heads' variables the same way
(``models/heads/regression_head.py``, ``integral_regression_head.py``,
``vis_head.py`` list their names): ``head.fc``, RLEHead's flow
``head.flow.s{i}.Dense_{j}`` / ``t{i}`` (with the flow's constant buffers),
the integral heads' ``deconv_layers`` and ``final_layer``, and
VisPredictHead's ``vis_fc`` and ``pose_head``.
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


# The CNN backbones of the classic families: for each, rules that name the
# mmpose module of each flax module of the JAX backbone (its path joined by
# "/"), a template for ``re.Match.expand`` or a function of the match.
_CONV_BN = r"(conv|bn)"


def _resnet_rules(bb):
    """ResNet, ResNetV1d, ResNeXt (``resnet.py``): the 7x7 or deep stem."""
    return [(r"conv1|bn1", r"\g<0>"), (r"stem_(conv|bn)(\d)", r"stem.\2.\1"),
            (r"layer(\d)_block(\d+)/((?:conv|bn)\d)", r"layer\1.\2.\3"),
            (r"layer(\d)_block(\d+)/downsample_conv", r"layer\1.\2.downsample.0"),
            (r"layer(\d)_block(\d+)/downsample_bn", r"layer\1.\2.downsample.1")]


def _resnet_like_rules(bb):
    """SEResNet, SEResNeXt, SCNet (``classic.py:_ResNetLike``): ConvBNReLU's
    ``conv`` / ``bn`` under each name."""
    block = r"layer(\d)_block(\d+)/"
    return [(r"conv1/conv", "conv1"), (r"conv1/bn", "bn1"),
            (block + r"conv(\d)/conv", r"layer\1.\2.conv\3"), (block + r"conv(\d)/bn", r"layer\1.\2.bn\3"),
            (block + r"se/fc(\d)", r"layer\1.\2.se_layer.conv\3.conv"),
            (block + r"k1/conv", r"layer\1.\2.k1.0"), (block + r"k1/bn", r"layer\1.\2.k1.1"),
            (block + r"k2/conv", r"layer\1.\2.scconv.k2.1"), (block + r"k2/bn", r"layer\1.\2.scconv.k2.2"),
            (block + r"k([34])/conv", r"layer\1.\2.scconv.k\3.0"), (block + r"k([34])/bn", r"layer\1.\2.scconv.k\3.1"),
            (block + r"downsample/conv", r"layer\1.\2.downsample.0"),
            (block + r"downsample/bn", r"layer\1.\2.downsample.1")]


def _resnest_rules(bb):
    """ResNeSt (``litehrnet.py:250``); stages count from 0 in JAX, and a
    strided projection sits behind its average pool."""

    def block(m, name):
        return f"layer{int(m[1]) + 1}.{m[2]}.{name}"

    def down(m):
        return block(m, f"downsample.{(int(m[1]) > 0) + (m[3] == 'bn')}")

    sa = dict(conv="conv2.conv", bn0="conv2.bn0", fc1="conv2.fc1", fc_bn="conv2.bn1", fc2="conv2.fc2")
    return [(r"stem(\d)/" + _CONV_BN, r"stem.\1.\2"),
            (r"l(\d)_b(\d+)_conv([13])/" + _CONV_BN, lambda m: block(m, f"{m[4]}{m[3]}")),
            (r"l(\d)_b(\d+)_sa/(conv|bn0|fc1|fc_bn|fc2)", lambda m: block(m, sa[m[3]])),
            (r"l(\d)_b(\d+)_down/" + _CONV_BN, down)]


def _shufflenet_v1_rules(bb):
    unit = r"layer(\d)_(\d+)/"
    return [(r"conv1/" + _CONV_BN, r"conv1.\1"),
            (unit + r"g_conv1", r"layers.\1.\2.g_conv_1x1_compress.conv"),
            (unit + r"bn1", r"layers.\1.\2.g_conv_1x1_compress.bn"),
            (unit + r"dw_conv", r"layers.\1.\2.depthwise_conv3x3_bn.conv"),
            (unit + r"bn2", r"layers.\1.\2.depthwise_conv3x3_bn.bn"),
            (unit + r"g_conv2", r"layers.\1.\2.g_conv_1x1_expand.conv"),
            (unit + r"bn3", r"layers.\1.\2.g_conv_1x1_expand.bn")]


def _shufflenet_v2_rules(bb):
    unit = r"layer(\d)_(\d+)/"
    return [(r"conv1/" + _CONV_BN, r"conv1.\1"), (r"conv_last/" + _CONV_BN, r"layers.3.\1"),
            (unit + r"short_dw", r"layers.\1.\2.branch1.0.conv"), (unit + r"short_bn1", r"layers.\1.\2.branch1.0.bn"),
            (unit + r"short_pw/" + _CONV_BN, r"layers.\1.\2.branch1.1.\3"),
            (unit + r"pw1/" + _CONV_BN, r"layers.\1.\2.branch2.0.\3"),
            (unit + r"dw", r"layers.\1.\2.branch2.1.conv"), (unit + r"dw_bn", r"layers.\1.\2.branch2.1.bn"),
            (unit + r"pw2/" + _CONV_BN, r"layers.\1.\2.branch2.2.\3")]


def _vgg_rules(bb):
    """VGG: one ``features`` sequence, each stage's convs then its pool."""
    convs = [sum(re.fullmatch(rf"stage{i}_conv\d+", k) is not None for k in bb) for i in range(5)]

    def index(m):
        return f"features.{sum(n + 1 for n in convs[:int(m[1])]) + int(m[2])}"

    return [(r"stage(\d)_conv(\d+)/" + _CONV_BN, lambda m: f"{index(m)}.{m[3]}"),
            (r"stage(\d)_conv(\d+)", lambda m: f"{index(m)}.conv")]


def _alexnet_rules(bb):
    return [(r"conv([1-5])", lambda m: f"features.{(0, 3, 6, 8, 10)[int(m[1]) - 1]}")]


def _vipnas_resnet_rules(bb):
    def block(m, name):
        return f"layer{int(m[1]) + 1}.{m[2]}.{name}"

    return [(r"stem_conv", "conv1"), (r"stem_bn", "bn1"),
            (r"l(\d)_b(\d+)_conv([13])/" + _CONV_BN, lambda m: block(m, f"{m[4]}{m[3]}")),
            (r"l(\d)_b(\d+)_(conv2|bn2)", lambda m: block(m, m[3])),
            (r"l(\d)_b(\d+)_att/fc(\d)", lambda m: block(m, f"attention.conv{m[3]}.conv")),
            (r"l(\d)_b(\d+)_down/" + _CONV_BN, lambda m: block(m, f"downsample.{int(m[3] == 'bn')}"))]


def _vipnas_mbv3_rules(bb):
    """ViPNAS-MobileNetV3: the blocks numbered from 1 across its stages."""
    depth = {}
    for k in bb:
        m = re.fullmatch(r"l(\d)_b(\d+)_dw", k)
        if m:
            depth[int(m[1])] = max(depth.get(int(m[1]), 0), int(m[2]) + 1)

    def layer(m, name):
        return f"layer{sum(depth[i] for i in depth if i < int(m[1])) + int(m[2]) + 1}.{name}"

    parts = dict(expand="expand_conv", project="linear_conv")
    return [(r"stem_conv", "conv1.conv"), (r"stem_bn", "conv1.bn"),
            (r"l(\d)_b(\d+)_(expand|project)/" + _CONV_BN, lambda m: layer(m, f"{parts[m[3]]}.{m[4]}")),
            (r"l(\d)_b(\d+)_dw", lambda m: layer(m, "depthwise_conv.conv")),
            (r"l(\d)_b(\d+)_dw_bn", lambda m: layer(m, "depthwise_conv.bn")),
            (r"l(\d)_b(\d+)_se/fc(\d)", lambda m: layer(m, f"se.conv{m[3]}.conv"))]


def _cspnext_rules(bb):
    """CSPNeXt (the inverse of ``convert_torch_cspnext_backbone``,
    ``engine/checkpoint.py:183``): a stage's CSP layer sits behind its SPP
    bottleneck where it has one."""

    def csp(m):
        return f"stage{m[1]}.{2 if f'stage{m[1]}_spp' in bb else 1}"

    return [(r"stem(\d)/" + _CONV_BN, r"stem.\1.\2"), (r"stage(\d)_conv/" + _CONV_BN, r"stage\1.0.\2"),
            (r"stage(\d)_spp/(conv\d)/" + _CONV_BN, r"stage\1.1.\2.\3"),
            (r"stage(\d)_csp/attention/fc", lambda m: f"{csp(m)}.attention.fc")] + [
        (r"stage(\d)_csp/" + pattern, lambda m, name=name: f"{csp(m)}.{m.expand(name)}")
        for pattern, name in _CSP_LAYER]


# a CSP layer's modules under the flax names and mmpose's, the groups after the layer's own
_CSP_LAYER = [(r"(main_conv|short_conv|final_conv)/" + _CONV_BN, r"\2.\3"),
              (r"block(\d+)/conv1/" + _CONV_BN, r"blocks.\2.conv1.\3"),
              (r"block(\d+)/conv2/(depthwise|pointwise)/" + _CONV_BN, r"blocks.\2.conv2.\3_conv.\4")]


def _pafpn_rules(neck):
    """CSPNeXtPAFPN (the inverse of ``convert_torch_cspnext_pafpn``, ``:573``):
    ``reduce{i}`` / ``top_down{i}`` are ``reduce_layers.{n - 1 - i}`` /
    ``top_down_blocks.{n - 1 - i}`` for n levels."""
    n = 1 + sum(re.fullmatch(r"reduce\d+", k) is not None for k in neck)
    rules = [(r"reduce(\d+)/" + _CONV_BN, lambda m: f"reduce_layers.{n - 1 - int(m[1])}.{m[2]}"),
             (r"down(\d+)/" + _CONV_BN, r"downsamples.\1.\2"), (r"out_conv(\d+)/" + _CONV_BN, r"out_convs.\1.\2")]
    for pattern, name in _CSP_LAYER:
        rules.append((r"top_down(\d+)/" + pattern,
                      lambda m, name=name: f"top_down_blocks.{n - 1 - int(m[1])}.{m.expand(name)}"))
        rules.append((r"bottom_up(\d+)/" + pattern, lambda m, name=name: f"bottom_up_blocks.{m[1]}.{m.expand(name)}"))
    return rules


def _block(name):
    """A basic block's or bottleneck's module under mmpose's name."""
    return {"downsample_conv": "downsample.0", "downsample_bn": "downsample.1"}.get(name, name)


def _hourglass_rules(bb):
    return [(r"stem_conv/" + _CONV_BN, r"stem.0.\1"),
            (r"stem_res/block(\d+)/(\w+)", lambda m: f"stem.1.{m[1]}.{_block(m[2])}"),
            (r"hourglass(\d+)/((?:low2/)*)(up1|low1|low2|low3)/block(\d+)/(\w+)",
             lambda m: f"hourglass_modules.{m[1]}.{m[2].replace('/', '.')}{m[3]}.{m[4]}.{_block(m[5])}"),
            (r"inter(\d+)/block0/(\w+)", lambda m: f"inters.{m[1]}.{_block(m[2])}"),
            (r"conv1x1_(\d+)/" + _CONV_BN, r"conv1x1s.\1.\2"), (r"out_conv(\d+)/" + _CONV_BN, r"out_convs.\1.\2"),
            (r"remap(\d+)/" + _CONV_BN, r"remap_convs.\1.\2")]


def _cpm_rules(bb):
    stem, middle = (0, 2, 4, 6, 7, 8), (0, 2, 4)
    return [(r"stem(\d)/" + _CONV_BN, lambda m: f"stem.{stem[int(m[1])]}.{m[2]}"), (r"stem_out", "stem.9.conv"),
            (r"middle(\d)/" + _CONV_BN, lambda m: f"middle.{middle[int(m[1])]}.{m[2]}"),
            (r"middle_conv(\d+)/" + _CONV_BN, r"middle_conv.\1.0.\2"),
            (r"stage(\d+)_conv(\d)/" + _CONV_BN, r"cpm_stages.\1.model.\2.\3"),
            (r"stage(\d+)_out0/" + _CONV_BN, r"out_convs.\1.0.\2"), (r"stage(\d+)_out1", r"out_convs.\1.1.conv")]


def _multistage_rules(bb):
    """MSPN and RSN: ``stage{i}/down{j}_block{b}`` is the stage's
    ``downsample.layer{j + 1}.{b}``, ``stage{i}/up{j}`` its ``upsample.up{j}``."""
    rsn = "conv2_1_1" in bb["stage0"]["down0_block0"]
    stages = "multi_stage_rsn" if rsn else "multi_stage_mspn"

    def block(m, name):
        return f"{stages}.{m[1]}.downsample.layer{int(m[2]) + 1}.{m[3]}.{name}"

    down = r"stage(\d+)/down(\d+)_block(\d+)/"
    rules = [(r"top/" + _CONV_BN, r"top.top.0.\1"),
             (r"stage(\d+)/up(\d+)/(\w+)/" + _CONV_BN, rf"{stages}.\1.upsample.up\2.\3.\4"),
             (down + r"downsample/" + _CONV_BN, lambda m: block(m, f"downsample.{m[4]}"))]
    if rsn:
        parts = dict(conv1="conv_bn_relu1", conv3="conv_bn3")
        return rules + [(down + r"(conv[13])/" + _CONV_BN, lambda m: block(m, f"{parts[m[4]]}.{m[5]}")),
                        (down + r"conv2_(\d+)_(\d+)/" + _CONV_BN, lambda m: block(m, f"conv_bn_relu2_{m[4]}_{m[5]}.{m[6]}"))]
    return rules + [(down + r"((?:conv|bn)\d)", lambda m: block(m, m[4])),
                    (down + r"downsample_(conv|bn)", lambda m: block(m, f"downsample.{m[4]}"))]


def _litehrnet_rules(bb):
    """LiteHRNet (``models/backbones/litehrnet.py``)."""
    block = r"s(\d)_m(\d+)_b(\d+)/"
    layer = r"stage\1.\2.layers.\3."
    fuse = r"s(\d)_m(\d+)_fuse(\d)_(\d)"
    return [(r"stem/(conv1|b1_pw|b2_expand|b2_linear)/" + _CONV_BN,
             lambda m: f"stem.{_LITE_STEM[m[1]]}.{m[2]}"),
            (r"stem/(b1_dw|b2_dw)(_bn)?", lambda m: f"stem.{_LITE_STEM[m[1]]}.{'bn' if m[2] else 'conv'}"),
            (r"t(\d)_proj(\d)/" + _CONV_BN, r"transition\1.\2.\3"),
            (r"t(\d)_dw(\d)", r"transition\1.\2.0"), (r"t(\d)_dw_bn(\d)", r"transition\1.\2.1"),
            (r"t(\d)_pw(\d)/" + _CONV_BN, lambda m: f"transition{m[1]}.{m[2]}.{2 + (m[3] == 'bn')}"),
            (block + r"crw/(conv[12])/" + _CONV_BN, layer + r"cross_resolution_weighting.\4.\5"),
            (block + r"dw(\d)", layer + r"depthwise_convs.\4.conv"),
            (block + r"dw_bn(\d)", layer + r"depthwise_convs.\4.bn"),
            (block + r"sw(\d)/fc([12])", layer + r"spatial_weighting.\4.conv\5.conv"),
            (fuse + r"/" + _CONV_BN, lambda m: f"stage{m[1]}.{m[2]}.fuse_layers.{m[3]}.{m[4]}.{int(m[5] == 'bn')}"),
            (fuse + r"_(dw|dwbn)(\d)", lambda m: f"stage{m[1]}.{m[2]}.fuse_layers.{m[3]}.{m[4]}.{m[6]}."
                                             f"{int(m[5] == 'dwbn')}"),
            (fuse + r"_pw(\d)/" + _CONV_BN, lambda m: f"stage{m[1]}.{m[2]}.fuse_layers.{m[3]}.{m[4]}.{m[5]}."
                                                    f"{2 + (m[6] == 'bn')}"),
            (r"head_dw(\d)", r"head_layer.projects.\1.depthwise_conv.conv"),
            (r"head_dw_bn(\d)", r"head_layer.projects.\1.depthwise_conv.bn"),
            (r"head_pw(\d)/" + _CONV_BN, r"head_layer.projects.\1.pointwise_conv.\2")]


_LITE_STEM = dict(conv1="conv1", b1_dw="branch1.0", b1_pw="branch1.1", b2_expand="expand_conv",
                  b2_dw="depthwise_conv", b2_linear="linear_conv")


def _swin_rules(bb):
    """SwinTransformer (``models/backbones/transformers.py``)."""
    block = r"stage(\d)_block(\d+)/"
    blocks = r"stages.\1.blocks.\2."
    return [(r"patch_embed", "patch_embed.projection"), (r"patch_norm", "patch_embed.norm"),
            (block + r"(norm[12])", blocks + r"\3"), (block + r"attn", blocks + "attn.w_msa"),
            (block + r"attn/(qkv|proj)", blocks + r"attn.w_msa.\3"),
            (block + r"mlp/fc1", blocks + "ffn.layers.0.0"), (block + r"mlp/fc2", blocks + "ffn.layers.1"),
            (r"merge_norm(\d)", r"stages.\1.downsample.norm"),
            (r"merge_reduction(\d)", r"stages.\1.downsample.reduction"), (r"out_norm(\d)", r"norm\1")]


def _hrformer_rules(bb):
    """HRFormer (``models/backbones/transformers.py``); its stages count from
    0 in JAX, from 2 in mmpose."""

    def stage(m):
        return f"stage{int(m[1]) + 2}.{m[2]}"

    ffn = dict(ffn1="fc1", ffn_dw="dw3x3", ffn2="fc2")
    block = r"s(\d)_m(\d+)_br(\d)_blk(\d+)"
    return [(r"stem([12])/conv", r"conv\1"), (r"stem([12])/bn", r"bn\1"), (r"layer1_b(\d)/(\w+)", r"layer1.\1.\2"),
            (r"t0_b0/" + _CONV_BN, lambda m: f"transition1.0.{int(m[1] == 'bn')}"),
            (r"t0_b1/" + _CONV_BN, lambda m: f"transition1.1.0.{int(m[1] == 'bn')}"),
            (r"t(\d)_new/" + _CONV_BN, lambda m: f"transition{int(m[1]) + 1}.{int(m[1]) + 1}.0.{int(m[2] == 'bn')}"),
            (block + r"/(norm[12])", lambda m: f"{stage(m)}.branches.{m[3]}.{m[4]}.{m[5]}"),
            (block + r"/attn", lambda m: f"{stage(m)}.branches.{m[3]}.{m[4]}.attn.attn"),
            (block + r"/attn/(qkv|proj)", lambda m: f"{stage(m)}.branches.{m[3]}.{m[4]}.attn.attn.{m[5]}"),
            (block + r"/(ffn1|ffn_dw|ffn2)", lambda m: f"{stage(m)}.branches.{m[3]}.{m[4]}.ffn.{ffn[m[5]]}"),
            (r"s(\d)_m(\d+)_f(\d)_(\d)/" + _CONV_BN,
             lambda m: f"{stage(m)}.fuse_layers.{m[3]}.{m[4]}.{int(m[5] == 'bn')}"),
            (r"s(\d)_m(\d+)_f(\d)_(\d)_d(\d)/" + _CONV_BN,
             lambda m: f"{stage(m)}.fuse_layers.{m[3]}.{m[4]}.{m[5]}.{int(m[6] == 'bn')}")]


def _pvt_rules(bb):
    """PVT / PVTv2 (``models/backbones/transformers.py``): the blocks follow
    ``pos_embed`` where there is one; ``q`` and ``kv`` are stacked after
    (``_pvt_in_proj``)."""
    offset = int("pos_embed0" in bb)
    conv_ffn = "dwconv" in bb.get("s0_b0_mlp", {})

    def block(m, name):
        return f"layers.{m[1]}.1.{int(m[2]) + offset}.{name}"

    attn = dict(q="attn.attn.q", kv="attn.attn.kv", proj="attn.attn.out_proj", sr="attn.sr", sr_norm="attn.norm")
    mlp = dict(fc1="ffn.layers.0", dwconv="ffn.layers.1", fc2=f"ffn.layers.{4 if conv_ffn else 3}")
    return [(r"patch_embed(\d)", r"layers.\1.0.projection"), (r"embed_norm(\d)", r"layers.\1.0.norm"),
            (r"stage_norm(\d)", r"layers.\1.2"), (r"s(\d)_b(\d+)_(norm[12])", lambda m: block(m, m[3])),
            (r"s(\d)_b(\d+)_attn/(q|kv|proj|sr|sr_norm)", lambda m: block(m, attn[m[3]])),
            (r"s(\d)_b(\d+)_mlp/(fc1|dwconv|fc2)", lambda m: block(m, mlp[m[3]]))]


def _pvt_from_jax(sd: Dict[str, np.ndarray], bb: Dict[str, Any]) -> None:
    """PVT's position embeddings (the backbone's own arrays), its other
    modules by ``_pvt_rules``, then each attention's ``q`` and ``kv`` stacked
    as ``in_proj_weight`` / ``in_proj_bias``."""
    for name, value in bb.items():
        if name.startswith("pos_embed"):
            sd[f"backbone.layers.{name[len('pos_embed'):]}.1.0.pos_embed"] = value
    _cnn_from_jax(sd, {k: v for k, v in bb.items() if isinstance(v, dict)}, {}, _pvt_rules(bb), dense="linear",
                  leaf_names=_LAYER_NORM)
    for key in [k for k in sd if k.endswith(".attn.attn.q.weight")]:
        prefix = key[:-len("q.weight")]
        for leaf, stacked in (("weight", "in_proj_weight"), ("bias", "in_proj_bias")):
            sd[prefix + stacked] = np.concatenate([sd.pop(f"{prefix}q.{leaf}"), sd.pop(f"{prefix}kv.{leaf}")])


# flax LayerNorm's scale is torch's weight
_LAYER_NORM = dict(scale="weight")


def _cnn_rules(bb: Dict[str, Any]):
    """The rules of the JAX backbone ``bb``'s family, told by its modules'
    names, or None (a ViT or an HRNet)."""
    if "stem_res" in bb:
        return _hourglass_rules
    if "middle0" in bb:
        return _cpm_rules
    if "top" in bb and "stage0" in bb:
        return _multistage_rules
    if "stage1_conv" in bb:
        return _cspnext_rules
    if "stem_conv" in bb:
        return _vipnas_mbv3_rules if "l1_b0_expand" in bb else _vipnas_resnet_rules
    if "stem0" in bb:
        return _resnest_rules
    if "layer0_0" in bb:
        return _shufflenet_v1_rules if "g_conv1" in bb["layer0_0"] else _shufflenet_v2_rules
    if "stage0_conv0" in bb:
        return _vgg_rules
    if "conv5" in bb:
        return _alexnet_rules
    if "layer2_block0" in bb:
        return _resnet_like_rules if "conv" in bb["layer1_block0"]["conv1"] else _resnet_rules
    return None


def _modules(tree: Dict[str, Any], path=()):
    """(path, leaves) of each flax module in ``tree`` that holds arrays."""
    leaves = {k: v for k, v in tree.items() if not isinstance(v, dict)}
    if leaves:
        yield path, leaves
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _modules(v, path + (k,))


def _cnn_from_jax(sd: Dict[str, np.ndarray], bb: Dict[str, Any], bb_s: Dict[str, Any], rules,
                  prefix: str = "backbone", dense: str = "conv", leaf_names: Optional[Dict[str, str]] = None) -> None:
    """Each flax module of ``bb`` under its mmpose name after ``prefix``: a
    conv's kernel (a transposed conv's, ``deconv*``, flipped) and bias, a
    ``Dense``'s as a 1x1 conv (``dense="conv"``) or a linear layer
    (``"linear"``), a BatchNorm's scale, bias and statistics; another
    module's arrays (ScaleNorm's ``g``, the GAU's ``gamma``, ``beta``,
    ``res_scale``, a window attention's ``relative_position_bias_table``)
    under their own names, or those ``leaf_names`` gives (LayerNorm's
    ``scale``: ``weight``)."""
    for path, leaves in _modules(bb):
        joined = "/".join(path)
        for pattern, name in rules:
            m = re.fullmatch(pattern, joined)
            if m:
                key = f"{prefix}." + (name(m) if callable(name) else m.expand(name))
                break
        else:
            raise KeyError(f"state_dict_from_jax: no torch name for the JAX {prefix}'s module {joined}")
        stats = bb_s
        for part in path:
            stats = stats.get(part, {})
        if "kernel" in leaves:
            kernel = leaves["kernel"]
            if kernel.ndim == 4:
                sd[f"{key}.weight"] = _deconv(kernel) if path[-1].startswith("deconv") else _conv(kernel)
            else:
                sd[f"{key}.weight"] = kernel.T if dense == "linear" else kernel.T[:, :, None, None]
            if "bias" in leaves:
                sd[f"{key}.bias"] = leaves["bias"]
        elif "mean" in stats:
            _bn_from_jax(sd, key, leaves, stats)
        else:
            for leaf, value in leaves.items():
                leaf = (leaf_names or {}).get(leaf, "res_scale.scale" if leaf == "res_scale" else leaf)
                sd[f"{key}.{leaf}"] = value


# The SimCC heads' and the multi-stage heads' modules under mmpose's names (their JAX converters'
# ``_convert_rtmw_head``, ``:621``, and ``_convert_rtmcc_head``, ``:540``, read them)
_GAU = [(r"gau", "gau"), (r"gau/(ln|uv|o)", r"gau.\1")]
_RTMW_HEAD = _GAU + [(r"(final_layer2?|conv_dec)_" + _CONV_BN, r"\1.\2"), (r"(mlp2?)_norm", r"\1.0"),
                     (r"(mlp2?)", r"\1.1"), (r"(cls_[xy])", r"\1")]
_RTMCC_HEAD = _GAU + [(r"final_layer", "final_layer"), (r"mlp_norm", "mlp.0"), (r"mlp_fc", "mlp.1"),
                      (r"(cls_[xy])", r"\1")]
_SIMCC_HEAD = [(r"deconv_layers/deconv(\d+)", lambda m: f"deconv_layers.{3 * int(m[1])}"),
               (r"deconv_layers/bn(\d+)", lambda m: f"deconv_layers.{3 * int(m[1]) + 1}"),
               (r"(final_layer|mlp_head_[xy])", r"\1")]
_CPM_HEAD = [(r"deconv(\d+)/deconv(\d+)", lambda m: f"multi_deconv_layers.{m[1]}.{3 * int(m[2])}"),
             (r"deconv(\d+)/bn(\d+)", lambda m: f"multi_deconv_layers.{m[1]}.{3 * int(m[2]) + 1}"),
             (r"final(\d+)", r"multi_final_layers.\1")]
_PRM = dict(prm1_conv="conv_bn_relu_prm_1.conv", prm1_bn="conv_bn_relu_prm_1.bn", mid_fc0="middle_path.0",
            mid_bn0="middle_path.1", mid_fc1="middle_path.3", mid_bn1="middle_path.4",
            bottom_conv1="bottom_path.0.conv", bottom_bn1="bottom_path.0.bn",
            bottom_dw="bottom_path.1.depthwise_conv.conv", bottom_dw_bn="bottom_path.1.depthwise_conv.bn",
            bottom_pw="bottom_path.1.pointwise_conv.conv", bottom_pw_bn="bottom_path.1.pointwise_conv.bn")


def _mspn_head_rules(head):
    units = sum(re.fullmatch(r"s0_u\d+_conv1", k) is not None for k in head)
    parts = dict(conv1="conv_layers.0.conv", bn1="conv_layers.0.bn", conv2="conv_layers.1.conv", bn2="conv_layers.1.bn")

    def layer(m):
        return f"predict_layers.{int(m[1]) * units + int(m[2])}"

    return [(r"s(\d+)_u(\d+)_(conv[12]|bn[12])", lambda m: f"{layer(m)}.{parts[m[3]]}"),
            (r"s(\d+)_u(\d+)_prm/(\w+)", lambda m: f"{layer(m)}.prm.{_PRM[m[3]]}")]


def _head_rules(head: Dict[str, Any]):
    """The rules of the SimCC and multi-stage heads, told by their modules'
    names, or None (the heatmap, ProbMap and ViPNAS heads)."""
    if "final_layer2_conv" in head:
        return _RTMW_HEAD
    if "mlp_fc" in head:
        return _RTMCC_HEAD
    if "mlp_head_x" in head:
        return _SIMCC_HEAD
    if "final0" in head:
        return _CPM_HEAD
    if "s0_u0_conv1" in head:
        return _mspn_head_rules(head)
    return None


def flow_state_from_jax(flow: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """The JAX RealNVP's parameters (``s{i}`` / ``t{i}``, three ``Dense``
    layers each) under the port's ``RealNVP`` names (``s.{i}.{0,2,4}``,
    ``t.{i}.{0,2,4}``), with its constant buffers (the prior's ``loc`` and
    ``cov``, the ``mask``)."""
    sd = {}
    for i in range(6):
        for net in ("s", "t"):
            for j in range(3):
                node = flow[f"{net}{i}"][f"Dense_{j}"]
                sd[f"{net}.{i}.{2 * j}.weight"] = np.asarray(node["kernel"]).T
                sd[f"{net}.{i}.{2 * j}.bias"] = np.asarray(node["bias"])
    sd.update(loc=np.zeros(2, np.float32), cov=np.eye(2, dtype=np.float32),
              mask=np.array([[0, 1], [1, 0]] * 3, np.float32))
    return sd


def state_dict_from_jax(variables: Dict[str, Any]) -> "OrderedDict[str, torch.Tensor]":
    """JAX ``{"params", "batch_stats"}`` (a ViT, an HRNet or a classic CNN:
    ResNet, ResNetV1d, ResNeXt, SEResNet, SEResNeXt, SCNet, ResNeSt,
    ShuffleNetV1 / V2, VGG, AlexNet, ViPNAS_ResNet, ViPNAS_MobileNetV3,
    CSPNeXt, HourglassNet, CPM, MSPN, RSN, LiteHRNet, SwinTransformer,
    HRFormer, PVT / PVTv2; a CSPNeXtPAFPN neck; a
    ProbMapHead, a DoubleProbMapHead, a HeatmapHead, a ViPNASHead, an
    RTMCCHead, a SimCCHead, an RTMWHead, a CPMHead, an MSPNHead, a
    RegressionHead, an RLEHead, an IntegralRegressionHead / DSNTHead or a
    VisPredictHead around a heatmap head) -> torch state dict."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    sd: Dict[str, np.ndarray] = {}

    bb, bb_s = params["backbone"], stats.get("backbone", {})
    rules = _cnn_rules(bb)
    if "patch_embed0" in bb:
        _pvt_from_jax(sd, bb)
    elif "patch_norm" in bb:
        _cnn_from_jax(sd, bb, bb_s, _swin_rules(bb), dense="linear", leaf_names=_LAYER_NORM)
    elif "t0_b0" in bb:
        _cnn_from_jax(sd, bb, bb_s, _hrformer_rules(bb), dense="linear", leaf_names=_LAYER_NORM)
    elif "b1_dw" in bb.get("stem", {}):
        _cnn_from_jax(sd, bb, bb_s, _litehrnet_rules(bb))
    elif "patch_embed" in bb:
        _vit_from_jax(sd, bb)
    elif rules is not None:
        _cnn_from_jax(sd, bb, bb_s, rules(bb))
    else:
        _hrnet_from_jax(sd, bb, bb_s)
    if "neck" in params:  # CSPNeXtPAFPN; the other necks have no parameters
        _cnn_from_jax(sd, params["neck"], stats.get("neck", {}), _pafpn_rules(params["neck"]), prefix="neck")

    head, head_s = params["head"], stats.get("head", {})
    rules = _head_rules(head)
    if rules is not None:
        _cnn_from_jax(sd, head, head_s, rules, prefix="head", dense="linear")
        return OrderedDict((k, torch.from_numpy(np.array(v, copy=True))) for k, v in sd.items())

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

    def dense(name, node):
        sd[f"{name}.weight"] = node["kernel"].T
        sd[f"{name}.bias"] = node["bias"]

    tower("head", head, head_s)
    if "fc" in head:  # RegressionHead, RLEHead
        dense("head.fc", head["fc"])
    if "flow" in head:  # RLEHead's RealNVP
        sd.update({f"head.loss.flow_model.{k}": v for k, v in flow_state_from_jax(head["flow"]).items()})
    if "vis_fc" in head:  # VisPredictHead: the visibility layer and the wrapped (heatmap) head
        dense("head.vis_head.2", head["vis_fc"])
        tower("head.pose_head", head["pose_head"], head_s.get("pose_head", {}))
    j = 0
    while f"deconv{j}_g0" in head:  # ViPNASHead: the groups' kernels along the input axis, one grouped weight
        groups = sum(re.fullmatch(rf"deconv{j}_g\d+", k) is not None for k in head)
        sd[f"head.deconv_layers.{3 * j}.weight"] = np.concatenate(
            [_deconv(head[f"deconv{j}_g{g}"]["kernel"]) for g in range(groups)], axis=0)
        _bn_from_jax(sd, f"head.deconv_layers.{3 * j + 1}", head[f"deconv_bn{j}"], head_s[f"deconv_bn{j}"])
        j += 1
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
