"""Top-down pose estimator and the ProbMap predict program pieces.

Port of ``probpose_code_tpu/models/pose_estimators/topdown.py``:
``TopdownPoseEstimator`` (``:41``), ``preprocess_inputs`` (``:74``) and
``probmap_head_predict`` (``:659-703``). The decode goes through K2
(``ops/kernels/expected_oks.py``) on every predict.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from probpose_code_torch.ops.kernels.expected_oks import expected_oks_decode
from probpose_code_torch.ops.tta import flip_heatmaps
from probpose_code_torch.registry import MODELS


@MODELS.register_module()
class TopdownPoseEstimator(nn.Module):
    """backbone (+ neck) -> head. Input (B, H, W, 3) normalised, NHWC like
    the JAX package; the backbone runs NCHW."""

    def __init__(self, backbone: nn.Module, head: nn.Module, neck: Optional[nn.Module] = None):
        super().__init__()
        if neck is not None:
            raise NotImplementedError("necks are not ported yet")
        self.backbone = backbone
        self.head = head

    def forward(self, inputs: torch.Tensor):
        feats = self.backbone(inputs.permute(0, 3, 1, 2))
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
