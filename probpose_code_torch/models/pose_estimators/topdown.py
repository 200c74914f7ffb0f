"""Top-down pose estimator and its predict and loss programs.

Port of ``probpose_code_tpu/models/pose_estimators/topdown.py``:
``TopdownPoseEstimator`` (``:41``), ``preprocess_inputs`` (``:74``),
``probmap_head_predict`` (``:659-703``), the ProbMap loss program
(``:94-251``), the DoubleProbMap programs (``merge_double_heatmaps_device``,
``double_probmap_head_loss`` and ``double_probmap_head_predict``,
``:254-475``), ``heatmap_head_loss`` (``:637-651``) and the SimCC programs
``simcc_head_loss`` (``:475``) and ``simcc_head_predict`` (``:504``); and
the plain heatmap head's decode of ``probpose_code_tpu/models/builder.py:
make_predict`` (``:870-908``). ProbMap: the OKS and error targets come from
the fast decode of the ground-truth and predicted heatmaps on the device,
the training monitors (PCK, balanced binary accuracies, MAEs) are computed
beside the losses, and the predict decode goes through K2
(``ops/kernels/expected_oks.py``). Plain heatmaps: flip average, then
argmax and DARK-UDP for the UDP codec, argmax and the quarter-pixel step
(or DARK with ``unbiased``) for the MSRA codec. SimCC: flip average of
the vectors, then the joint argmax over the split ratio.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from probpose_code_torch.codecs.utils.oks_map import COCO_KPT_SIGMAS
from probpose_code_torch.ops.decode import (
    argmax_probmap_decode_batch,
    dark_refine_batch,
    dark_udp_refine_batch,
    quarter_offset_refine_batch,
    simcc_maximum_batch,
)
from probpose_code_torch.ops.heatmap import heatmap_maximum_batch
from probpose_code_torch.ops.kernels.expected_oks import expected_oks_decode
from probpose_code_torch.ops.tta import flip_heatmaps, flip_vectors
from probpose_code_torch.registry import MODELS


@MODELS.register_module()
class TopdownPoseEstimator(nn.Module):
    """backbone -> neck (if any) -> head, the JAX estimator's order
    (``topdown.py:48-72``). Input (B, H, W, 3) normalised, NHWC like the JAX
    package; the backbone, neck and head run NCHW."""

    def __init__(self, backbone: nn.Module, head: nn.Module, neck: Optional[nn.Module] = None):
        super().__init__()
        self.backbone = backbone
        self.neck = neck
        self.head = head

    def forward(self, inputs: torch.Tensor, generator: Optional[torch.Generator] = None):
        """``generator`` draws the backbone's stochastic-depth masks in training."""
        feats = self.backbone(inputs.permute(0, 3, 1, 2), generator)
        if self.neck is not None:
            feats = self.neck(feats)
        return self.head(feats)


def preprocess_inputs(
    images: torch.Tensor,
    mean: Sequence[float],
    std: Sequence[float],
    bgr_to_rgb: bool = True,
) -> torch.Tensor:
    """(B, H, W, 3) raw 0-255 -> normalised float32."""
    x = images.float()
    if bgr_to_rgb:
        x = torch.flip(x, dims=[-1])
    mean = torch.tensor(mean, dtype=torch.float32, device=x.device)
    std = torch.tensor(std, dtype=torch.float32, device=x.device)
    return (x - mean) / std


def probmap_head_predict(
    outputs: Dict[str, torch.Tensor],
    outputs_flipped: Optional[Dict[str, torch.Tensor]],
    flip_indices,
    input_size: Tuple[int, int] = (192, 256),
    shift_heatmap: bool = False,
    freeze_oks: bool = False,
) -> Dict[str, torch.Tensor]:
    """Flip-TTA average + expected-OKS decode (reference
    ``probmap_head.py:predict:715-804``)."""
    heatmaps = outputs["heatmaps"]
    probs = outputs["probabilities"]
    vis = outputs["visibilities"]
    oks = outputs["oks"]
    errs = outputs["errors"]

    if outputs_flipped is not None:
        hm_f = flip_heatmaps(outputs_flipped["heatmaps"], flip_indices=flip_indices, shift_heatmap=shift_heatmap)
        heatmaps = (heatmaps + hm_f) * 0.5
        idx = torch.as_tensor(flip_indices, device=probs.device)
        probs = (probs + outputs_flipped["probabilities"][:, idx]) * 0.5
        vis = (vis + outputs_flipped["visibilities"][:, idx]) * 0.5
        oks = (oks + outputs_flipped["oks"][:, idx]) * 0.5
        errs = (errs + outputs_flipped["errors"][:, idx]) * 0.5

    B, K, H, W = heatmaps.shape
    keypoints, scores = expected_oks_decode(heatmaps.contiguous(), input_size)
    errs = errs / torch.sqrt(torch.tensor(H**2 + W**2, dtype=torch.float32))

    keypoint_scores = oks if not freeze_oks else scores
    return dict(
        keypoints=keypoints,
        keypoint_scores=keypoint_scores,
        keypoints_conf=scores,
        keypoints_probs=probs,
        keypoints_visible=vis,
        keypoints_oks=oks,
        keypoints_error=errs,
        heatmaps=heatmaps,
    )


def heatmap_head_predict(
    heatmaps: torch.Tensor,
    heatmaps_flipped: Optional[torch.Tensor],
    flip_indices,
    decoder_cfg: Dict[str, Any],
    input_size: Tuple[int, int] = (192, 256),
    shift_heatmap: bool = False,
) -> Dict[str, torch.Tensor]:
    """Flip-TTA average in heatmap mode, then the codec's decode to input
    space (``builder.py:884-908``): for UDP argmax + DARK-UDP, scaled by
    input / (W - 1); for MSRA argmax + the quarter-pixel step (DARK with
    ``unbiased``), scaled by input / W. ``PoseModel.make_predict`` refuses
    the other codecs."""
    if heatmaps_flipped is not None:
        heatmaps = (heatmaps + flip_heatmaps(heatmaps_flipped, flip_indices=flip_indices,
                                             shift_heatmap=shift_heatmap)) * 0.5
    B, K, H, W = heatmaps.shape
    locs, vals = heatmap_maximum_batch(heatmaps)
    blur = decoder_cfg.get("blur_kernel_size", 11)
    if decoder_cfg.get("type", "UDPHeatmap") == "MSRAHeatmap":
        if decoder_cfg.get("unbiased", False):
            locs = dark_refine_batch(locs, heatmaps, blur)
        else:
            locs = quarter_offset_refine_batch(locs, heatmaps)
        scale = [input_size[0] / W, input_size[1] / H]
    else:
        locs = dark_udp_refine_batch(locs, heatmaps, blur)
        scale = [input_size[0] / (W - 1), input_size[1] / (H - 1)]
    scale = torch.tensor(scale, dtype=torch.float32, device=locs.device)
    return dict(keypoints=locs * scale, keypoint_scores=vals, heatmaps=heatmaps)


def heatmap_head_loss(
    heatmaps: torch.Tensor,
    batch: Dict[str, torch.Tensor],
    loss_module: Any,
) -> Dict[str, torch.Tensor]:
    """The plain HeatmapHead loss (reference ``heatmap_head.py:loss:270``):
    ``loss_kpt`` and the PCK monitor ``acc_pose``."""
    return {
        "loss_kpt": loss_module(heatmaps, batch["heatmaps"], batch["keypoint_weights"]),
        "acc_pose": _pose_pck_accuracy(heatmaps.detach(), batch["heatmaps"], batch["keypoint_weights"] > 0.5),
    }


def simcc_head_loss(
    outputs: Tuple[torch.Tensor, torch.Tensor],
    batch: Dict[str, torch.Tensor],
    loss_module: Any,
) -> Dict[str, torch.Tensor]:
    """The SimCC heads' loss (reference ``rtmcc_head.py:loss``): ``loss_kpt``,
    the loss module (``KLDiscretLoss``) over both vectors, and the monitor
    ``acc_pose``: the PCK of the joint argmax at half a tenth of the vector
    lengths."""
    pred_x, pred_y = outputs
    gt_x, gt_y = batch["keypoint_x_labels"], batch["keypoint_y_labels"]
    weights = batch["keypoint_weights"]
    dt_locs, _ = simcc_maximum_batch(pred_x.detach(), pred_y.detach())
    gt_locs, _ = simcc_maximum_batch(gt_x, gt_y)
    norm = torch.tensor([pred_x.shape[-1], pred_y.shape[-1]], dtype=torch.float32, device=pred_x.device) / 10.0 / 2.0
    dist = torch.linalg.norm((dt_locs - gt_locs) / norm, dim=-1)
    valid = (weights > 0.5) & (gt_locs[..., 0] >= 0)
    correct = (dist < 0.5) & valid
    return {
        "loss_kpt": loss_module((pred_x, pred_y), (gt_x, gt_y), weights),
        "acc_pose": correct.sum() / torch.clamp(valid.sum(), min=1),
    }


def simcc_head_predict(
    outputs: Tuple[torch.Tensor, torch.Tensor],
    outputs_flipped: Optional[Tuple[torch.Tensor, torch.Tensor]],
    flip_indices,
    simcc_split_ratio: float = 2.0,
) -> Dict[str, torch.Tensor]:
    """Flip-TTA average of both vectors (before the argmax), then the joint
    argmax over the split ratio (reference ``rtmcc_head.py:predict``)."""
    pred_x, pred_y = outputs
    if outputs_flipped is not None:
        fx, fy = flip_vectors(*outputs_flipped, flip_indices)
        pred_x = (pred_x + fx) * 0.5
        pred_y = (pred_y + fy) * 0.5
    locs, scores = simcc_maximum_batch(pred_x, pred_y)
    return dict(keypoints=locs / simcc_split_ratio, keypoint_scores=scores, keypoint_x_labels=pred_x,
                keypoint_y_labels=pred_y)


# --------------------------------------------------------------------------
# ProbMap head: training targets, losses and monitors, all on the device
# --------------------------------------------------------------------------


def _fast_decode_to_input_space(heatmaps: torch.Tensor, input_size: Tuple[int, int]) -> torch.Tensor:
    """Argmax + DARK-UDP decode -> input-space coords (B, K, 2)."""
    B, K, H, W = heatmaps.shape
    locs, _ = argmax_probmap_decode_batch(heatmaps, 11)
    scale = torch.tensor([input_size[0] / (W - 1), input_size[1] / (H - 1)], dtype=torch.float32,
                         device=locs.device)
    return locs * scale


def compute_oks_targets(
    gt_coords: torch.Tensor, dt_coords: torch.Tensor, weight: torch.Tensor,
    kpt_sigmas: Optional[np.ndarray] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-keypoint OKS between decoded ground truth and prediction, with the
    reference's training constants: a fixed 64 x 48 box, area 64*48*0.53,
    per keypoint. ``weight`` (B, K) gates keypoints; an instance without a
    valid keypoint gets zero targets and weight 0."""
    K = gt_coords.shape[1]
    sigmas = torch.as_tensor(np.asarray(kpt_sigmas if kpt_sigmas is not None else COCO_KPT_SIGMAS)[:K],
                             dtype=torch.float32, device=gt_coords.device)
    vars_ = (sigmas * 2) ** 2
    tmparea = 48.0 * 64.0 * 0.53
    w = weight.float()
    g = gt_coords * w[..., None]
    d = dt_coords * w[..., None]
    valid = w > 0
    has_any = valid.sum(dim=1) > 0  # (B,)
    dx = d[..., 0] - g[..., 0]
    dy = d[..., 1] - g[..., 1]
    e = (dx ** 2 + dy ** 2) / vars_[None] / (tmparea + 1e-9) / 2.0
    oks = torch.exp(-e) * valid
    oks = torch.where(has_any[:, None], oks, torch.zeros_like(oks))
    return oks, has_any.float()


def _balanced_visibility_weights(annotated_in, gt_vis, gt_annotated):
    """Reweight annotated keypoints so that the invisible and the visible
    populations weigh the same (reference ``probmap_head.py:883-889``)."""
    invisible_in = (gt_vis == 0) & (gt_annotated > 0.5)
    visible_in = (gt_vis > 0) & (gt_annotated > 0.5)
    w = annotated_in.float()
    w = torch.where(invisible_in, 1.0 / (invisible_in.sum() + 1e-10), w)
    w = torch.where(visible_in, 1.0 / (visible_in.sum() + 1e-10), w)
    positive_min = torch.where(w > 0, w, torch.full_like(w, float("inf"))).min()
    positive_min = torch.where(torch.isfinite(positive_min), positive_min, torch.ones_like(positive_min))
    return w / positive_min


def _pose_pck_accuracy(dt_heatmaps, gt_heatmaps, mask, thr: float = 0.05):
    """PCK of the argmax locations, normalised by heatmap_size / 10."""
    B, K, H, W = dt_heatmaps.shape
    dt_locs, _ = heatmap_maximum_batch(dt_heatmaps)
    gt_locs, _ = heatmap_maximum_batch(gt_heatmaps)
    norm = torch.tensor([W, H], dtype=torch.float32, device=dt_locs.device) / 10.0
    dist = torch.linalg.norm((dt_locs - gt_locs) / norm, dim=-1)
    valid = mask & (gt_locs[..., 0] >= 0)
    correct = (dist < thr * 10.0) & valid
    return correct.sum() / torch.clamp(valid.sum(), min=1)


def _balanced_binary_accuracy(dt, gt, mask):
    """Best-threshold balanced accuracy (the deterministic form of the
    reference's ``get_binary_accuracy`` with force_balanced=True)."""
    thresholds = torch.arange(0.1, 1.0, 0.05, dtype=torch.float32, device=dt.device)
    gt_b = gt > 0.5
    pos = (gt_b & (mask > 0)).float()
    neg = ((~gt_b) & (mask > 0)).float()
    n_pos = torch.clamp(pos.sum(), min=1.0)
    n_neg = torch.clamp(neg.sum(), min=1.0)
    preds = dt[None] > thresholds[:, None, None]
    tp = (preds * pos[None]).sum(dim=(1, 2))
    tn = ((~preds) * neg[None]).sum(dim=(1, 2))
    balanced = 0.5 * (tp / n_pos + tn / n_neg)
    has_both = (pos.sum() > 0) & (neg.sum() > 0)
    return torch.where(has_both, balanced.max(), torch.zeros_like(n_pos))


def probmap_head_loss(
    outputs: Dict[str, torch.Tensor],
    batch: Dict[str, torch.Tensor],
    loss_modules: Dict[str, Any],
    head_cfg: Dict[str, Any],
    input_size: Tuple[int, int] = (192, 256),
) -> Dict[str, torch.Tensor]:
    """The ProbMapHead loss dict (reference ``probmap_head.py:806-942``):
    ``loss_kpt``, ``loss_probability``, ``loss_visibility``, ``loss_oks``,
    ``loss_error`` and the monitors ``acc_pose``, ``acc_prob``, ``acc_vis``,
    ``mae_oks``, ``mae_err``."""
    dt_heatmaps = outputs["heatmaps"]
    B, C, H, W = dt_heatmaps.shape
    dt_probs = outputs["probabilities"].reshape(B, C)
    dt_vis = outputs["visibilities"].reshape(B, C)
    dt_oks = outputs["oks"].reshape(B, C)
    dt_errs = outputs["errors"].reshape(B, C)

    gt_heatmaps = batch["heatmaps"]
    gt_probs = batch["in_image"].float().reshape(B, C)
    gt_annotated = batch["annotated"].float().reshape(B, C)
    gt_vis = batch["keypoints_visibility"].float().reshape(B, C)
    keypoint_weights = batch["keypoint_weights"].reshape(B, C)

    freeze_oks = head_cfg.get("freeze_oks", False)
    freeze_error = head_cfg.get("freeze_error", True)
    zeros = torch.zeros((B, C), dtype=torch.float32, device=dt_heatmaps.device)
    if (not freeze_error) or (not freeze_oks):
        gt_coords = _fast_decode_to_input_space(gt_heatmaps.detach(), input_size)
        dt_coords = _fast_decode_to_input_space(dt_heatmaps.detach(), input_size)
    gt_errs = zeros if freeze_error else torch.linalg.norm(gt_coords - dt_coords, dim=-1)
    if freeze_oks:
        gt_oks = zeros
    else:
        gt_oks, _ = compute_oks_targets(gt_coords, dt_coords, (gt_probs > 0.5) & (gt_annotated > 0.5))

    annotated_in = (gt_annotated > 0.5) & (gt_probs > 0.5)
    heatmap_weights = gt_annotated if head_cfg.get("learn_heatmaps_from_zeros", False) else keypoint_weights

    losses: Dict[str, torch.Tensor] = {}
    losses["loss_kpt"] = loss_modules["keypoint"](dt_heatmaps, gt_heatmaps, heatmap_weights, per_pixel=True).mean()
    losses["loss_probability"] = loss_modules["probability"](dt_probs, gt_probs, gt_annotated)
    vis_weights = _balanced_visibility_weights(annotated_in, gt_vis, gt_annotated)
    losses["loss_visibility"] = loss_modules["visibility"](dt_vis, gt_vis, vis_weights)
    losses["loss_oks"] = loss_modules["oks"](dt_oks, gt_oks, annotated_in.float())
    losses["loss_error"] = loss_modules["error"](dt_errs, gt_errs, annotated_in.float())

    losses["acc_pose"] = _pose_pck_accuracy(dt_heatmaps.detach(), gt_heatmaps, keypoint_weights > 0.5)
    losses["acc_prob"] = _balanced_binary_accuracy(dt_probs.detach(), gt_probs, gt_annotated > 0.5)
    losses["acc_vis"] = _balanced_binary_accuracy(dt_vis.detach(), gt_vis, annotated_in)
    mask_f = annotated_in.float()
    denom = torch.clamp(mask_f.sum(), min=1.0)
    losses["mae_oks"] = ((dt_oks.detach() - gt_oks).abs() * mask_f).sum() / denom
    losses["mae_err"] = ((dt_errs.detach() - gt_errs).abs() * mask_f).sum() / denom
    return losses


# --------------------------------------------------------------------------
# DoubleProbMap head: the two windows merged, its loss and its predict
# --------------------------------------------------------------------------


def resize_nearest_indices(size_in: int, size_out: int, device=None) -> torch.Tensor:
    """The rows ``jax.image.resize(..., "nearest")`` samples: the half-pixel
    centres ``floor((i + 0.5) * size_in / size_out)`` (``F.interpolate``'s
    "nearest" samples ``floor(i * size_in / size_out)``)."""
    idx = np.floor((np.arange(size_out) + 0.5) * (size_in / size_out)).astype(np.int64)
    return torch.as_tensor(np.minimum(idx, size_in - 1), device=device)


def merge_double_heatmaps_device(
    heatmaps1: torch.Tensor, heatmaps2: torch.Tensor, bbox_mask: Optional[torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per (sample, keypoint): the in-window map where the out-window map's
    first argmax falls inside ``bbox_mask`` ((B, 1, Hm, Wm) at any size,
    nearest-resized to the map), else the out-window map; None means the
    whole crop. Returns (merged (B, K, H, W), hout_in (B, K) bool)."""
    B, K, H, W = heatmaps1.shape
    amax = torch.argmax(heatmaps2.reshape(B, K, H * W), dim=-1)
    if bbox_mask is None:
        hout_in = torch.ones((B, K), dtype=torch.bool, device=heatmaps1.device)
    else:
        mask = bbox_mask.reshape(B, bbox_mask.shape[-2], bbox_mask.shape[-1]).float()
        rows = resize_nearest_indices(mask.shape[1], H, mask.device)
        cols = resize_nearest_indices(mask.shape[2], W, mask.device)
        mask = mask[:, rows][:, :, cols].reshape(B, 1, H * W).expand(B, K, H * W)
        hout_in = torch.gather(mask, 2, amax[..., None])[..., 0] > 0.5
    merged = torch.where(hout_in[..., None, None], heatmaps1, heatmaps2)
    return merged, hout_in


def double_probmap_head_loss(
    outputs: Dict[str, torch.Tensor],
    batch: Dict[str, torch.Tensor],
    loss_modules: Dict[str, Any],
    head_cfg: Dict[str, Any],
    input_size: Tuple[int, int] = (192, 256),
) -> Dict[str, torch.Tensor]:
    """The DoubleProbMapHead loss dict (reference ``DP_head.py:loss:1293``):
    ``loss_kpt`` (the first tower on the in-window maps), ``loss_kpt2`` (the
    second on the out-window maps), ``loss_probability``,
    ``loss_visibility``, ``loss_oks``, ``loss_error`` and the monitors
    ``acc_pose1``, ``acc_pose2``, ``acc_prob``, ``acc_vis``, ``mae_oks``,
    ``mae_err``. The OKS and error targets compare the merged prediction with
    the out-window ground truth. ``split_heatmaps_by`` picks the towers'
    keypoints: "in/all" (the first the in-window ones, the second all
    annotated ones), "in/out" or "visibility"."""
    dt_heatmaps1 = outputs["heatmaps"]
    dt_heatmaps2 = outputs["out_heatmaps"]
    B, C, H, W = dt_heatmaps1.shape
    dt_probs = outputs["probabilities"].reshape(B, C)
    dt_vis = outputs["visibilities"].reshape(B, C)
    dt_oks = outputs["oks"].reshape(B, C)
    dt_errs = outputs["errors"].reshape(B, C)

    gt_in_heatmaps = batch["heatmaps"].reshape(B, C, H, W)
    gt_out_heatmaps = batch["out_heatmaps"].reshape(B, C, H, W)
    gt_probs = batch["in_image"].float().reshape(B, C)
    gt_annotated = batch["annotated"].float().reshape(B, C)
    gt_vis = batch["keypoints_visibility"].float().reshape(B, C)
    # keypoints_in_image also knows blackout crops (it is in_image AND-ed with itself otherwise)
    gt_in_image = batch.get("keypoints_in_image")
    gt_in_image = gt_probs if gt_in_image is None else gt_in_image.float().reshape(B, C) * gt_probs

    merged_dt, _ = merge_double_heatmaps_device(dt_heatmaps1.detach(), dt_heatmaps2.detach(), batch.get("bbox_mask"))

    freeze_oks = head_cfg.get("freeze_oks", False)
    freeze_error = head_cfg.get("freeze_error", False)
    zeros = torch.zeros((B, C), dtype=torch.float32, device=dt_heatmaps1.device)
    if (not freeze_error) or (not freeze_oks):
        gt_coords = _fast_decode_to_input_space(gt_out_heatmaps, input_size)
        dt_coords = _fast_decode_to_input_space(merged_dt, input_size)
    gt_errs = zeros if freeze_error else torch.linalg.norm(gt_coords - dt_coords, dim=-1)
    if freeze_oks:
        gt_oks = zeros
    else:
        gt_oks, _ = compute_oks_targets(gt_coords, dt_coords, (gt_probs > 0.5) & (gt_annotated > 0.5))

    annotated_in = (gt_annotated > 0.5) & (gt_probs > 0.5)
    split = head_cfg.get("split_heatmaps_by", "in/all")
    if split == "visibility":
        weights1, weights2 = (gt_vis > 0.5) & annotated_in, (gt_vis <= 0.5) & annotated_in
    elif split == "in/out":
        weights1, weights2 = (gt_in_image > 0.5) & annotated_in, (gt_in_image <= 0.5) & annotated_in
    else:  # in/all
        weights1, weights2 = (gt_in_image > 0.5) & annotated_in, annotated_in

    mask_f = annotated_in.float()
    losses: Dict[str, torch.Tensor] = {}
    losses["loss_kpt"] = loss_modules["keypoint"](dt_heatmaps1, gt_in_heatmaps, weights1.float())
    losses["loss_kpt2"] = loss_modules["keypoint"](dt_heatmaps2, gt_out_heatmaps, weights2.float())
    losses["loss_probability"] = loss_modules["probability"](dt_probs, gt_probs, gt_annotated)
    losses["loss_visibility"] = loss_modules["visibility"](dt_vis, gt_vis, mask_f)
    losses["loss_oks"] = loss_modules["oks"](dt_oks, gt_oks, mask_f)
    losses["loss_error"] = loss_modules["error"](dt_errs, gt_errs, mask_f)

    losses["acc_pose1"] = _pose_pck_accuracy(dt_heatmaps1.detach(), gt_in_heatmaps, weights1)
    losses["acc_pose2"] = _pose_pck_accuracy(dt_heatmaps2.detach(), gt_out_heatmaps, weights2)
    losses["acc_prob"] = _balanced_binary_accuracy(dt_probs.detach(), gt_probs, gt_annotated > 0.5)
    losses["acc_vis"] = _balanced_binary_accuracy(dt_vis.detach(), gt_vis, annotated_in)
    denom = torch.clamp(mask_f.sum(), min=1.0)
    losses["mae_oks"] = ((dt_oks.detach() - gt_oks).abs() * mask_f).sum() / denom
    losses["mae_err"] = ((dt_errs.detach() - gt_errs).abs() * mask_f).sum() / denom
    return losses


def double_probmap_head_predict(
    outputs: Dict[str, torch.Tensor],
    outputs_flipped: Optional[Dict[str, torch.Tensor]],
    flip_indices,
    decoder_cfg: Dict[str, Any],
    input_size: Tuple[int, int] = (192, 256),
    shift_heatmap: bool = False,
    freeze_oks: bool = False,
) -> Dict[str, torch.Tensor]:
    """Flip-TTA over both towers and the four scalars, both windows decoded
    by K2 in one launch at the identity scale (heatmap pixels), each mapped
    to input space by its window (``locs / (hm - 1) * act_wh + act_tl``, the
    JAX order of operations); a keypoint keeps its in-window prediction where
    the out-window one lands inside the crop, else the out-window one
    (reference ``DP_head.py:_merge_predictions:1460``, without a mask, as
    ``make_predict`` passes none)."""
    heatmaps1 = outputs["heatmaps"]
    heatmaps2 = outputs["out_heatmaps"]
    probs, vis, oks, errs = (outputs[k] for k in ("probabilities", "visibilities", "oks", "errors"))
    if outputs_flipped is not None:
        heatmaps1 = (heatmaps1 + flip_heatmaps(outputs_flipped["heatmaps"], flip_indices=flip_indices,
                                               shift_heatmap=shift_heatmap)) * 0.5
        heatmaps2 = (heatmaps2 + flip_heatmaps(outputs_flipped["out_heatmaps"], flip_indices=flip_indices,
                                               shift_heatmap=shift_heatmap)) * 0.5
        idx = torch.as_tensor(flip_indices, device=probs.device)
        probs = (probs + outputs_flipped["probabilities"][:, idx]) * 0.5
        vis = (vis + outputs_flipped["visibilities"][:, idx]) * 0.5
        oks = (oks + outputs_flipped["oks"][:, idx]) * 0.5
        errs = (errs + outputs_flipped["errors"][:, idx]) * 0.5

    B, K, H, W = heatmaps1.shape
    locs, scores = expected_oks_decode(torch.cat([heatmaps1, heatmaps2]).contiguous(), None)
    input_wh = torch.tensor(input_size, dtype=torch.float32, device=locs.device)
    hm_wh = torch.tensor([W - 1, H - 1], dtype=torch.float32, device=locs.device)

    def window_to_input(window_locs, pad):
        act_wh = input_wh * float(pad)
        act_tl = input_wh / 2.0 - act_wh / 2.0
        return window_locs / hm_wh * act_wh + act_tl

    kpts_in = window_to_input(locs[:B], decoder_cfg.get("in_heatmap_padding", 1.0))
    kpts_out = window_to_input(locs[B:], decoder_cfg.get("out_heatmap_padding", 1.25))
    scores_in, scores_out = scores[:B], scores[B:]
    # does the out-window prediction land inside the crop? (round half to even, as jnp.round)
    xi = torch.round(kpts_out[..., 0]).to(torch.int32)
    yi = torch.round(kpts_out[..., 1]).to(torch.int32)
    hout_in = (xi >= 0) & (xi < input_size[0]) & (yi >= 0) & (yi < input_size[1])

    errs = errs / torch.sqrt(torch.tensor(H**2 + W**2, dtype=torch.float32))
    conf = torch.where(hout_in, scores_in, scores_out)
    return dict(
        keypoints=torch.where(hout_in[..., None], kpts_in, kpts_out),
        keypoint_scores=oks if not freeze_oks else conf,
        keypoints_conf=conf,
        keypoints_probs=probs,
        keypoints_visible=vis,
        keypoints_oks=oks,
        keypoints_error=errs,
        heatmaps=heatmaps1,
        out_heatmaps=heatmaps2,
    )
