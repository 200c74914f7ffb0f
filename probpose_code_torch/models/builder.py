"""Model construction from config dicts, and the PoseModel runtime wrapper.

Port of ``probpose_code_tpu/models/builder.py``: ``build_pose_estimator``
(``:39``) reads the same reference-style config dicts, ``build_loss_modules``
(``:132``) builds the head's losses, and ``PoseModel`` owns the module, its
predict program for top-down ProbMapHead, DoubleProbMapHead, HeatmapHead
(and ViPNASHead; CPMHead and MSPNHead, the last of their maps), the SimCC
heads (RTMCCHead, SimCCHead, RTMWHead), the regression heads (RegressionHead,
RLEHead, IntegralRegressionHead, DSNTHead) and VisPredictHead around any of
them (preprocess ->
original and mirrored crops as one doubled batch -> flip-TTA average -> the
expected-OKS decode, ``:815-832``, argmax and DARK-UDP for the UDP codec, argmax and the
quarter-pixel step or DARK for the MSRA codec, ``:870-908``, the Megvii
codec's own decode (the JAX predict takes the UDP branch), SimCC's joint
argmax, ``:833-837``, or the regression head's coordinates times the input
size, ``:841-844``; VisPredictHead's visibility averaged over the flip pair,
``:787-796``) and its loss (``loss_fn``, ``:406``, ``:486``, with the
targets and DoubleProbMap's bbox mask made on the device by
``device_preprocess_batch``, ``:363``; CPMHead's ``cpm_head_loss``,
``:490-493``; RLEHead's RLELoss through the head's flow, ``topdown.py:550-561``;
VisPredictHead's wrapped loss and ``loss_vis``, ``:523-537``). MSPNHead's and
the integral heads' training is refused (``UNTRAINED_HEADS``).
"""

from __future__ import annotations

import contextlib
import copy
import math
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from probpose_code_torch.ops.bbox_mask import render_bbox_mask
from probpose_code_torch.ops.encode import (
    DEVICE_CODECS,
    generate_gaussian_device,
    generate_probmaps_device,
    regression_labels_device,
    generate_simcc_labels_device,
    generate_udp_gaussian_device,
    generate_unbiased_gaussian_device,
    integral_regression_labels_device,
    probmap_encode_scales,
)
from probpose_code_torch.ops.kernels.jpeg import decode_batch
from probpose_code_torch.ops.kernels.photometric import augment
from probpose_code_torch.ops.photometric import AUGMENT_KEYS
from probpose_code_torch.ops.warp import warp_affine_batch
from probpose_code_torch.registry import MODELS

from . import losses  # noqa: F401  (registers)
from .backbones import classic, resnest, vipnas  # noqa: F401  (register)
from .backbones.cspnext import CSPNeXt  # noqa: F401  (registers)
from .backbones.hrnet import HRNet  # noqa: F401  (registers)
from .backbones.litehrnet import LiteHRNet  # noqa: F401  (registers)
from .backbones.mobilenet_v2 import MobileNetV2  # noqa: F401  (registers)
from .backbones.multistage import CPM, MSPN, RSN, HourglassNet  # noqa: F401  (register)
from .backbones.resnet import ResNet  # noqa: F401  (registers)
from .backbones.transformers import (  # noqa: F401  (register)
    HRFormer,
    PyramidVisionTransformer,
    PyramidVisionTransformerV2,
    SwinTransformer,
)
from .backbones.vit import VisionTransformer  # noqa: F401  (registers)
from .heads.heatmap_head import HeatmapHead, ViPNASHead  # noqa: F401  (registers)
from .heads.integral_regression_head import DSNTHead, IntegralRegressionHead  # noqa: F401  (register)
from .heads.multistage_heads import CPMHead, MSPNHead, cpm_head_loss, mspn_head_loss  # noqa: F401  (register)
from .heads.probmap_head import DoubleProbMapHead, ProbMapHead  # noqa: F401  (registers)
from .heads.regression_head import RegressionHead, RLEHead  # noqa: F401  (register)
from .heads.rtmcc_head import RTMCCHead, RTMWHead, SimCCHead  # noqa: F401  (register)
from .heads.vis_head import VisPredictHead  # noqa: F401  (registers)
from .necks.necks import CSPNeXtPAFPN, FeatureMapProcessor, GlobalAveragePooling  # noqa: F401  (register)
from .pose_estimators.topdown import (
    INTEGRAL_HEADS,
    TopdownPoseEstimator,
    double_probmap_head_loss,
    double_probmap_head_predict,
    heatmap_head_loss,
    heatmap_head_predict,
    preprocess_inputs,
    probmap_head_loss,
    probmap_head_predict,
    regression_head_loss,
    regression_head_predict,
    simcc_head_loss,
    simcc_head_predict,
    vis_head_loss,
)

HEAD_TYPES = ("ProbMapHead", "DoubleProbMapHead", "HeatmapHead", "ViPNASHead", "CPMHead", "MSPNHead", "RTMCCHead",
              "SimCCHead", "RTMWHead", "RegressionHead", "RLEHead", "IntegralRegressionHead", "DSNTHead",
              "VisPredictHead")
# the heads whose outputs take the regression heads' predict
REGRESSION_HEADS = ("RegressionHead", "RLEHead", *INTEGRAL_HEADS)
# the heads whose heatmaps take HeatmapHead's predict (the multi-stage heads' last map) and loss (theirs apart)
HEATMAP_HEADS = ("HeatmapHead", "ViPNASHead", "CPMHead", "MSPNHead")
# the codecs whose decode a heatmap head runs
HEATMAP_DECODERS = ("UDPHeatmap", "MSRAHeatmap", "MegviiHeatmap")
# the heads whose (x, y) vectors take SimCC's predict and loss
SIMCC_HEADS = ("RTMCCHead", "SimCCHead", "RTMWHead")
# heads the port serves and does not train, and why
_INTEGRAL_REASON = (
    "integral regression training (IntegralRegressionHead / DSNTHead): the configs' MultipleLossWrapper takes lists "
    "of outputs and targets, and the JAX package's regression_head_loss hands it the coordinate array, so its "
    "loss_fn fails its assertion and the JAX package cannot train these configs; the port serves them")
UNTRAINED_HEADS = dict(MSPNHead=(
    "MSPN / RSN training: mspn_head_loss reads multi-level targets (multilevel_heatmaps) that no codec route of "
    "the JAX package makes (its collate ships heatmaps only), so the JAX package cannot train these configs "
    "either; the port serves them"), IntegralRegressionHead=_INTEGRAL_REASON, DSNTHead=_INTEGRAL_REASON)


def _adapt_backbone_cfg(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """Accept ``type='mmpretrain.VisionTransformer'`` and its kwargs
    (``patch_cfg.padding``); drop the torch-side ``init_cfg`` and the ViT's
    and HRNet's optimizer-side ``frozen_stages``; the other backbones take
    their config as it is (``ResNet`` freezes its ``frozen_stages``)."""
    cfg = copy.deepcopy(dict(cfg))
    if cfg.get("type") in ("mmpretrain.VisionTransformer", "VisionTransformer"):
        cfg["type"] = "VisionTransformer"
        patch_cfg = cfg.pop("patch_cfg", None)
        if patch_cfg and "padding" in patch_cfg:
            cfg["patch_padding"] = patch_cfg["padding"]
    cfg.pop("init_cfg", None)
    if cfg.get("type") in ("VisionTransformer", "HRNet"):
        cfg.pop("frozen_stages", None)
    return cfg


def _feature_map_size(backbone, neck, input_size: Tuple[int, int]) -> Tuple[int, int]:
    """(w, h) of the last feature map at ``input_size`` (w, h): one forward of
    a zero crop on the CPU in evaluation mode (no BatchNorm statistics
    move). The SimCC heads' classifiers take w * h inputs (the flax heads'
    from the data; a config's ``in_featuremap_size`` may not match it, as the
    MPII config's (6, 8) at 256 x 256)."""
    w, h = input_size
    modules = [m for m in (backbone, neck) if m is not None]
    modes = [m.training for m in modules]
    with torch.no_grad():
        for m in modules:
            m.eval()
        feats = backbone(torch.zeros(1, 3, h, w))
        if neck is not None:
            feats = neck(feats)
        for m, mode in zip(modules, modes):
            m.train(mode)
    last = feats[-1] if isinstance(feats, (tuple, list)) else feats
    return int(last.shape[3]), int(last.shape[2])


def build_pose_estimator(cfg: Dict[str, Any]):
    """Build the module tree from a model config dict. Returns (module, aux),
    aux carrying the data_preprocessor / test_cfg / head / backbone configs."""
    cfg = copy.deepcopy(dict(cfg))
    model_type = cfg.pop("type", "TopdownPoseEstimator")
    data_preprocessor = cfg.pop("data_preprocessor", None) or {}
    test_cfg = cfg.pop("test_cfg", None) or {}
    cfg.pop("train_cfg", None)
    backbone_cfg = cfg.pop("backbone")
    head_cfg = cfg.pop("head")
    neck_cfg = cfg.pop("neck", None)

    bb_cfg = _adapt_backbone_cfg(backbone_cfg)
    decoder = head_cfg.get("decoder") or {}
    if getattr(MODELS.get(bb_cfg.get("type")), "sized_by_input", False) and "input_size" in decoder:
        # parameters whose shapes the flax modules take from the data (a window's relative position table,
        # PVT's pos_embed): the torch ones from the codec's input
        w, h = decoder["input_size"]
        bb_cfg.setdefault("img_size", (h, w))
    backbone = MODELS.build(bb_cfg)
    neck_kwargs, head_kwargs = {}, {}
    # the flax necks and heads take their input widths from the data: the port's take the widths the
    # backbone (and neck) give, where the config's differ (RTMW-m: CSPNeXt-m gives 384 and 768 channels to a
    # neck of in_channels=[512, 768])
    if neck_cfg and neck_cfg.get("type") == "CSPNeXtPAFPN":
        neck_kwargs["feat_channels"] = backbone.out_channels
    neck = MODELS.build(dict(neck_cfg, **neck_kwargs)) if neck_cfg else None
    if head_cfg.get("type") == "RTMWHead":
        head_kwargs["feat_channels"] = (neck or backbone).out_channels
    if head_cfg.get("type") in ("SimCCHead", "RTMWHead"):
        head_kwargs["in_featuremap_size"] = _feature_map_size(backbone, neck, tuple(head_cfg["input_size"]))
    head = MODELS.build(dict(head_cfg, **head_kwargs))
    estimator_cls = MODELS.get(model_type) if isinstance(model_type, str) else model_type
    if estimator_cls is None:
        raise KeyError(f"unknown pose estimator type {model_type}")
    module = estimator_cls(backbone=backbone, head=head, neck=neck)
    aux = dict(
        data_preprocessor=data_preprocessor,
        test_cfg=test_cfg,
        head_cfg=dict(head_cfg),
        backbone_cfg=dict(backbone_cfg),
    )
    return module, aux


_LOSS_DEFAULTS = dict(
    keypoint_loss=dict(type="KeypointMSELoss", use_target_weight=True),
    probability_loss=dict(type="BCELoss", use_target_weight=True),
    visibility_loss=dict(type="BCELoss", use_target_weight=True),
    oks_loss=dict(type="MSELoss", use_target_weight=True),
    error_loss=dict(type="L1LogLoss", use_target_weight=True),
)


def build_loss_modules(head_cfg: Dict[str, Any]) -> Dict[str, Any]:
    """The ProbMap heads' five loss configs as callables, under the keys
    ``keypoint``, ``probability``, ``visibility``, ``oks`` and ``error``; a
    single-loss head's ``loss`` (HeatmapHead) replaces ``keypoint``
    (``builder.py:145-147``). VisPredictHead's ``loss`` supervises the
    visibility (``vis``; ``BCELoss`` without target weights where it has
    none) and its wrapped head's the pose (``keypoint``; ``KeypointMSELoss``
    where it has none), ``:148-156``."""
    out = {
        key.replace("_loss", ""): MODELS.build(dict(head_cfg.get(key) or default))
        for key, default in _LOSS_DEFAULTS.items()
    }
    if head_cfg.get("loss"):
        out["keypoint"] = MODELS.build(dict(head_cfg["loss"]))
    if head_cfg.get("type") == "VisPredictHead":
        out["vis"] = out.pop("keypoint", None) if head_cfg.get("loss") else MODELS.build(
            dict(type="BCELoss", use_target_weight=False))
        inner = dict(head_cfg.get("pose_cfg") or {})
        out["keypoint"] = MODELS.build(dict(inner.get("loss") or _LOSS_DEFAULTS["keypoint_loss"]))
    return out


@contextlib.contextmanager
def full_f32_precision():
    """No TF32 in products or convolutions for the duration (the counterpart
    of ``_predict_precision`` = "highest", ``builder.py:588-599``: TF32-like
    drift flips argmax decodes)."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


class StageClock:
    """The time one stage of the device's input work takes (``name``: the
    JPEG decode, the photometric augment), summed over spans, on two
    clocks: the host's (``<name>_host``: the issuing thread blocked in the
    stage, work on host threads included) and, for a CUDA device, the
    card's (``<name>``: CUDA events around the stage's work on the current
    stream, the host's part included only where the stream waits for it;
    the host's clock again on the CPU)."""

    def __init__(self, name: str):
        self.name = name
        self._events: List[Tuple[torch.cuda.Event, torch.cuda.Event]] = []
        self._host = 0.0
        self._card = 0.0

    @contextlib.contextmanager
    def span(self, device: torch.device):
        events = None
        if device.type == "cuda":
            events = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            events[0].record()
        t0 = time.perf_counter()
        yield
        seconds = time.perf_counter() - t0
        self._host += seconds
        if events is None:
            self._card += seconds
        else:
            events[1].record()
            self._events.append(events)

    def take(self) -> Dict[str, float]:
        """Seconds in the stage since the last ``take``: ``<name>`` (the
        card's clock; waits for the events) and ``<name>_host``."""
        card = self._card
        for start, end in self._events:
            end.synchronize()
            card += start.elapsed_time(end) / 1000
        times = {self.name: card, f"{self.name}_host": self._host}
        self._events, self._host, self._card = [], 0.0, 0.0
        return times


class PoseModel:
    """Runtime handle: the module on its device, the predict program and the
    loss. ``loss_fn`` runs the module in training mode and ``predict`` in
    evaluation mode; ``train()`` / ``eval()`` switch it explicitly."""

    def __init__(self, cfg: Dict[str, Any], metainfo: Optional[dict] = None, device="cuda"):
        self.cfg = copy.deepcopy(dict(cfg))
        self.module, self.aux = build_pose_estimator(cfg)
        head_cfg = self.aux["head_cfg"]
        self.head_type = head_cfg.get("type")
        if self.head_type not in HEAD_TYPES or not isinstance(self.module, TopdownPoseEstimator):
            raise NotImplementedError(f"the port runs top-down models with a head of {HEAD_TYPES} only")
        # VisPredictHead: the wrapped head decodes, with its codec (``builder.py:190-192``)
        self.pose_cfg = dict(head_cfg.get("pose_cfg") or {}) if self.head_type == "VisPredictHead" else head_cfg
        self.pose_head_type = self.pose_cfg.get("type")
        if self.pose_head_type not in HEAD_TYPES or self.pose_head_type == "VisPredictHead":
            raise NotImplementedError(f"VisPredictHead wraps a head of {HEAD_TYPES} (not itself) only")
        self.decoder_cfg = self.pose_cfg.get("decoder") or {}
        if "input_size" in self.decoder_cfg:
            self.input_size = tuple(self.decoder_cfg["input_size"])
        else:
            self.input_size = tuple(self.aux["test_cfg"].get("input_size", (192, 256)))
        self.metainfo = metainfo
        self.cfg_full = None  # the whole config, set by apis.init_model: the crop reads its test pipeline
        self.device = torch.device(device)
        self.module.to(self.device).eval()
        self.loss_modules = build_loss_modules(head_cfg)
        self.decode_clock = StageClock("decode")  # the JPEG decodes of device_preprocess_batch
        self.augment_clock = StageClock("augment")  # and its photometric augmentations

    def train(self, mode: bool = True) -> "PoseModel":
        """Training mode: batch statistics in BatchNorm (running statistics
        updated), stochastic depth on. A ViT layer with tanh-GELU runs K3; one
        with exact GELU (ViTPose) runs the eager block, whose attention is K4.
        Evaluation mode runs K1 (see ``models/backbones/vit.py``)."""
        self.module.train(mode)
        return self

    def eval(self) -> "PoseModel":
        return self.train(False)

    def batch_stats(self) -> Dict[str, torch.Tensor]:
        """The BatchNorm running statistics by state-dict name (live buffers)."""
        return {k: v for k, v in self.module.named_buffers() if k.endswith(("running_mean", "running_var"))}

    def init_weights(self, seed: int = 0) -> None:
        """Random weights from a seeded generator: lecun-normal products,
        pos_embed and the relative position tables N(0, 0.02), unit norms and
        scales (ScaleNorm's ``g``, the GAU's ``res_scale``), zero biases."""
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for name, p in self.module.named_parameters():
                if name.endswith(("pos_embed", "relative_position_bias_table")):
                    value = torch.randn(p.shape, generator=gen) * 0.02
                elif p.dim() >= 2:
                    fan_in = p.shape[1] * math.prod(p.shape[2:])
                    value = torch.randn(p.shape, generator=gen) / math.sqrt(fan_in)
                elif name.endswith(("weight", ".g", "res_scale.scale")):
                    value = torch.ones(p.shape)
                else:
                    value = torch.zeros(p.shape)
                p.copy_(value)

    def is_low_precision(self) -> bool:
        dtypes = (self.aux["backbone_cfg"].get("dtype"), self.aux["head_cfg"].get("dtype"))
        return any(str(d) == "bfloat16" for d in dtypes)

    def preprocess(self, images: torch.Tensor) -> torch.Tensor:
        dp = self.aux["data_preprocessor"]
        return preprocess_inputs(
            images,
            mean=dp.get("mean", (0.0, 0.0, 0.0)),
            std=dp.get("std", (1.0, 1.0, 1.0)),
            bgr_to_rgb=dp.get("bgr_to_rgb", False),
        )

    def flip_indices(self):
        if self.metainfo:
            return list(self.metainfo["flip_indices"])
        return list(range(self.pose_cfg.get("out_channels", self.pose_cfg.get("num_joints", 17))))

    def make_predict(self):
        """(B, H, W, 3) raw crops on the model's device -> decoded predictions."""
        test_cfg = self.aux["test_cfg"]
        flip_test = test_cfg.get("flip_test", False)
        shift_heatmap = test_cfg.get("shift_heatmap", False)
        freeze_oks = self.aux["head_cfg"].get("freeze_oks", False)
        flip_indices = self.flip_indices()
        head_type = self.pose_head_type
        if head_type in HEATMAP_HEADS and self.decoder_cfg.get("type", "UDPHeatmap") not in HEATMAP_DECODERS:
            raise NotImplementedError(f"the {self.decoder_cfg['type']} decode is not ported yet "
                                      f"({', '.join(HEATMAP_DECODERS)} are)")
        precision = contextlib.nullcontext if self.is_low_precision() else full_f32_precision

        def decode(outputs, outputs_flipped):
            if head_type in REGRESSION_HEADS:
                return regression_head_predict(outputs, outputs_flipped, flip_indices, self.input_size, head_type)
            if head_type in SIMCC_HEADS:
                return simcc_head_predict(outputs, outputs_flipped, flip_indices,
                                          simcc_split_ratio=self.decoder_cfg.get("simcc_split_ratio", 2.0))
            if head_type in HEATMAP_HEADS:
                return heatmap_head_predict(
                    outputs, outputs_flipped, flip_indices, self.decoder_cfg, input_size=self.input_size,
                    shift_heatmap=shift_heatmap,
                )
            if head_type == "DoubleProbMapHead":
                return double_probmap_head_predict(
                    outputs, outputs_flipped, flip_indices, self.decoder_cfg, input_size=self.input_size,
                    shift_heatmap=shift_heatmap, freeze_oks=freeze_oks,
                )
            return probmap_head_predict(
                outputs, outputs_flipped, flip_indices, input_size=self.input_size,
                shift_heatmap=shift_heatmap, freeze_oks=freeze_oks,
            )

        def predict(images: torch.Tensor) -> Dict[str, torch.Tensor]:
            self.eval()
            with torch.inference_mode(), precision():
                x = self.preprocess(images)
                outputs_flipped = None
                if flip_test:
                    # original and mirrored crops as one doubled batch
                    B = x.shape[0]
                    both = self.module(torch.cat([x, torch.flip(x, dims=[2])], dim=0))
                    if isinstance(both, dict):
                        outputs = {k: v[:B] for k, v in both.items()}
                        outputs_flipped = {k: v[B:] for k, v in both.items()}
                    elif isinstance(both, (tuple, list)):  # SimCC's (x, y) vectors, the multi-stage heads' maps
                        outputs = type(both)(v[:B] for v in both)
                        outputs_flipped = type(both)(v[B:] for v in both)
                    else:
                        outputs, outputs_flipped = both[:B], both[B:]
                else:
                    outputs = self.module(x)
                if self.head_type == "VisPredictHead":
                    # unwrapped: the visibility averaged over the flip pair (its channels permuted), the
                    # wrapped head decoded as usual
                    outputs, visible = outputs
                    if outputs_flipped is not None:
                        outputs_flipped, visible_flipped = outputs_flipped
                        idx = torch.as_tensor(flip_indices, device=visible.device)
                        visible = (visible + visible_flipped[:, idx]) * 0.5
                    preds = decode(outputs, outputs_flipped)
                    preds["keypoints_visible"] = visible
                    return preds
                return decode(outputs, outputs_flipped)

        return predict

    def predict(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        # built per call, not kept on the model: a kept closure over ``self``
        # would be a reference cycle, and the model (and its device memory)
        # would outlive its last reference until the garbage collector runs
        return self.make_predict()(images)

    def device_preprocess_batch(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """The device half of the input pipeline, on the batch's device
        (``builder.py:363-404``). A canvas batch (``canvas`` / ``warp_mat``
        from ``TopdownAffine``'s canvas form) is warped into ``inputs`` by
        the gather; a JPEG batch (``jpeg`` / ``jpeg_info`` / ``jpeg_path`` /
        ``jpeg_image`` / ``jpeg_warp_mat`` / ``jpeg_index`` from its JPEG
        form, ``datasets.loader.collate_pose_samples``) is first
        decoded on that device into one zeroed buffer (``ops.kernels.jpeg.
        decode_batch``: the port's decode on the card, the plain decoder on
        the CPU; timed by ``decode_clock``) and warped from it, each crop to its place
        in the batch. Crops are rounded to uint8 values as the JAX pipeline's
        host warp (cv2.warpAffine) gives them; a batch from RTMPose's
        photometric transforms (``hsv_gains``, ``photometric``,
        ``blur_ksize``, ``median_ksize``, ``dropout_rects``) then has them applied to its
        crops in the JAX order (``ops/kernels/photometric.py:augment``;
        timed by ``augment_clock``). A batch that
        carries heatmap-space keypoints (``kpts_hm`` (B, K, 2),
        ``kpts_visible`` (B, K)) instead of target maps gets its maps
        encoded: UDP gaussians for the UDPHeatmap codec, MSRA gaussians
        (or their unbiased form) for MSRAHeatmap, expected-OKS maps for the
        ProbMap family, for SimCCLabel (``kpts_hm`` its bins) the
        ``keypoint_x_labels`` / ``keypoint_y_labels``, for RegressionLabel
        (``kpts_hm`` in input pixels) the ``keypoint_labels``, for
        IntegralRegressionLabel (the same) the labels and the sum-normalized
        MSRA maps; a DoubleProbMap batch
        both windows' maps
        (``heatmaps`` from ``kpts_hm``, ``out_heatmaps`` from
        ``kpts_hm_out``) and, from ``bbox_mask_rect`` / ``bbox_mask_mat``,
        the (B, 1, h, w) uint8 ``bbox_mask`` (``ops/bbox_mask.py``)."""
        if not {"canvas", "jpeg", "kpts_hm"} & set(batch):
            return batch
        batch = dict(batch)
        crops = []  # (places in the batch or None for all, crops)
        if "jpeg" in batch:
            mats = batch.pop("jpeg_warp_mat")
            with self.decode_clock.span(mats.device):
                images, _ = decode_batch(batch.pop("jpeg"), mats.device, names=batch.pop("jpeg_path"),
                                         infos=batch.pop("jpeg_info"))
            crops.append((batch.pop("jpeg_index"),
                          warp_affine_batch(images, mats, self.input_size, image_index=batch.pop("jpeg_image"))))
        if "canvas" in batch:
            crops.append((None, warp_affine_batch(batch.pop("canvas"), batch.pop("warp_mat"), self.input_size)))
        if len(crops) == 2:  # a mixed batch: the canvases fill the places the JPEGs leave
            (index, jpeg_crops), (_, canvas_crops) = crops
            inputs = jpeg_crops.new_empty((len(index) + len(canvas_crops), *jpeg_crops.shape[1:]))
            rest = torch.ones(len(inputs), dtype=torch.bool, device=inputs.device)
            rest[index] = False
            inputs[index] = jpeg_crops
            inputs[rest] = canvas_crops
        elif crops:
            inputs = crops[0][1]
        if crops:
            inputs = inputs.round().clamp(0, 255)
            if set(AUGMENT_KEYS) & set(batch):
                with self.augment_clock.span(inputs.device):
                    inputs = augment(inputs, **{k: batch.pop(k) for k in AUGMENT_KEYS if k in batch})
            batch["inputs"] = inputs
        if "kpts_hm" not in batch or {"heatmaps", "keypoint_x_labels", "keypoint_labels"} & set(batch):
            return batch
        dc = self.decoder_cfg
        if dc.get("type", "ProbMap") not in DEVICE_CODECS:
            raise NotImplementedError(f"device encode for the {dc.get('type')} codec is not ported yet")
        kpts = batch.pop("kpts_hm")
        vis = batch.pop("kpts_visible")
        hm_size = tuple(dc.get("heatmap_size", (48, 64)))
        if dc.get("type") == "RegressionLabel":
            batch["keypoint_labels"] = regression_labels_device(kpts, tuple(dc["input_size"]))
        elif dc.get("type") == "IntegralRegressionLabel":
            batch["keypoint_labels"], batch["heatmaps"] = integral_regression_labels_device(
                kpts, vis, tuple(dc["input_size"]), hm_size, float(dc["sigma"]), dc.get("normalize", True))
        elif dc.get("type") == "SimCCLabel":
            batch["keypoint_x_labels"], batch["keypoint_y_labels"] = generate_simcc_labels_device(
                kpts, vis, tuple(dc["input_size"]), dc.get("simcc_split_ratio", 2.0), dc.get("sigma", 6.0),
                dc.get("smoothing_type", "gaussian"), dc.get("normalize", True), dc.get("label_smooth_weight", 0.0))
        elif dc.get("type") == "MSRAHeatmap":
            gen = generate_unbiased_gaussian_device if dc.get("unbiased", False) else generate_gaussian_device
            batch["heatmaps"] = gen(kpts, vis, hm_size, float(dc["sigma"]))
        elif dc.get("type") == "UDPHeatmap":
            batch["heatmaps"] = generate_udp_gaussian_device(kpts, vis, hm_size, float(dc.get("sigma", 2.0)))
        elif dc.get("type") == "DoubleProbMap":
            scales = probmap_encode_scales(kpts.shape[1], hm_size, float(dc.get("sigma", -1.0)), dtype=np.float64)
            batch["heatmaps"] = generate_probmaps_device(kpts, vis, hm_size, scales)
            batch["out_heatmaps"] = generate_probmaps_device(batch.pop("kpts_hm_out"), vis, hm_size, scales)
            if "bbox_mask_rect" in batch:
                batch["bbox_mask"] = render_bbox_mask(batch.pop("bbox_mask_rect"), batch.pop("bbox_mask_mat"),
                                                      self.input_size)
        else:
            scales = probmap_encode_scales(kpts.shape[1], hm_size, float(dc.get("sigma", -1.0)))
            batch["heatmaps"] = generate_probmaps_device(kpts, vis, hm_size, scales)
        return batch

    def loss_fn(self, batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None):
        """One forward in training mode and the head's loss. ``batch``:
        ``inputs`` (B, H, W, 3) raw 0-255 crops, ``heatmaps`` (SimCC:
        ``keypoint_x_labels`` / ``keypoint_y_labels``) or ``kpts_hm`` /
        ``kpts_visible``, and the codec's ``keypoint_weights`` (and, for
        ProbMapHead, ``in_image``, ``annotated``, ``keypoints_visibility``).
        ``generator`` draws the stochastic-depth masks. Returns ``(total, (loss_dict, new_state))``
        as the JAX package does; ``new_state["batch_stats"]`` holds the
        running statistics this forward updated."""
        if self.head_type in UNTRAINED_HEADS and "multilevel_heatmaps" not in batch:
            raise NotImplementedError(UNTRAINED_HEADS[self.head_type])
        self.train()
        batch = self.device_preprocess_batch(batch)
        outputs = self.module(self.preprocess(batch["inputs"]), generator)
        if self.head_type == "CPMHead":
            losses = cpm_head_loss(outputs, batch, self.loss_modules["keypoint"])
        elif self.head_type == "MSPNHead":
            losses = mspn_head_loss(outputs, batch, self.loss_modules["keypoint"],
                                    list(self.aux["head_cfg"].get("level_indices", [])))
        elif self.head_type in HEATMAP_HEADS:
            losses = heatmap_head_loss(outputs, batch, self.loss_modules["keypoint"])
        elif self.head_type in SIMCC_HEADS:
            losses = simcc_head_loss(outputs, batch, self.loss_modules["keypoint"])
        elif self.head_type in ("RegressionHead", "RLEHead"):
            losses = regression_head_loss(outputs, batch, self.loss_modules["keypoint"], self.head_type,
                                          log_phi_fn=getattr(self.module.head, "log_phi", None))
        elif self.head_type == "VisPredictHead":
            if self.pose_head_type not in HEATMAP_HEADS:
                raise NotImplementedError(f"VisPredictHead trains a wrapped heatmap head only, not "
                                          f"{self.pose_head_type}")
            losses = vis_head_loss(outputs, batch, self.loss_modules)
        elif self.head_type == "DoubleProbMapHead":
            losses = double_probmap_head_loss(
                outputs, batch, self.loss_modules, self.aux["head_cfg"], input_size=self.input_size,
            )
        else:
            losses = probmap_head_loss(
                outputs, batch, self.loss_modules, self.aux["head_cfg"], input_size=self.input_size,
            )
        total = sum(v for k, v in losses.items() if k.startswith("loss_"))
        return total, (losses, {"batch_stats": self.batch_stats()})
