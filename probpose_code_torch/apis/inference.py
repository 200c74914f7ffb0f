"""User-facing inference API of the port.

Port of ``probpose_code_tpu/apis/inference.py``: ``init_model`` (``:29``)
and ``inference_topdown`` (``:130``). Every crop of a call is cut on the
device (``ops/warp.py``, no OpenCV), and all crops go through one predict
call; the keypoints are mapped back to the image as in
``engine/runner.py:attach_predictions`` (``:389-418``).
"""

from __future__ import annotations

import os
from typing import List, Optional, Union

import numpy as np
import torch

from probpose_code_torch.config import Config
from probpose_code_torch.datasets.metainfo import parse_pose_metainfo
from probpose_code_torch.engine.checkpoint import load_checkpoint
from probpose_code_torch.models.builder import PoseModel
from probpose_code_torch.ops.warp import warp_affine_batch
from probpose_code_torch.structures.bbox import (
    bbox_xywh2xyxy,
    bbox_xyxy2cs,
    fix_aspect_ratio,
    get_udp_warp_matrix,
)
from probpose_code_torch.structures.data_sample import InstanceData, PoseDataSample

INPUT_PADDING = 1.25  # the top-down recipes' bbox padding (GetBBoxCenterScale / TopdownAffine)
PROBMAP_FIELDS = ("keypoints_probs", "keypoints_visible", "keypoints_oks", "keypoints_error", "keypoints_conf")


def init_model(
    config: Union[str, os.PathLike, dict],
    checkpoint: Optional[str] = None,
    device: Optional[Union[str, torch.device]] = None,
    cfg_options: Optional[dict] = None,
) -> PoseModel:
    """Build a PoseModel from a config file or dict, on ``device``.

    ``device=None`` means the card: it raises when CUDA is absent, and never
    falls back to the CPU on its own; pass ``device="cpu"`` for the CPU.
    Without a checkpoint the weights are random, drawn from seed 0.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("init_model: no CUDA device; pass device='cpu' to run on the CPU")
        device = "cuda"
    if isinstance(config, (str, os.PathLike)):
        config = Config.fromfile(config)
    elif not isinstance(config, Config):
        config = Config.fromdict(dict(config))
    if cfg_options:
        config.merge_from_dict(cfg_options)

    dataset_cfg = config.get("test_dataloader", config.get("val_dataloader", {})) or {}
    metainfo_cfg = (dataset_cfg.get("dataset", {}) or {}).get("metainfo") or {"dataset_name": "coco"}
    metainfo = parse_pose_metainfo(dict(metainfo_cfg))

    model_cfg = config["model"] if "model" in config else config
    model = PoseModel(model_cfg, metainfo=metainfo, device=device)
    if checkpoint is not None:
        load_checkpoint(model, checkpoint)
    else:
        model.init_weights(seed=0)
    return model


def crop_batch(image: np.ndarray, bboxes: np.ndarray, input_size, device):
    """UDP crops of ``bboxes`` (N, 4 xyxy) from one (H, W, 3) image at
    ``input_size`` (w, h), cut on ``device`` and rounded to uint8 values like
    cv2.warpAffine. Returns (crops (N, h, w, 3) float32, centers (N, 2),
    scales (N, 2))."""
    w, h = input_size
    center, scale = bbox_xyxy2cs(bboxes.astype(np.float32), padding=INPUT_PADDING)
    scale = fix_aspect_ratio(scale, aspect_ratio=w / h)
    mats = np.stack([get_udp_warp_matrix(c, s, 0.0, output_size=(w, h)) for c, s in zip(center, scale)])
    src = torch.from_numpy(np.ascontiguousarray(image)).to(device)[None]
    crops = warp_affine_batch(src, torch.from_numpy(mats), (w, h))
    return crops.round().clamp(0, 255), center, scale


def inference_topdown(
    model: PoseModel,
    img: np.ndarray,
    bboxes: Optional[Union[List, np.ndarray]] = None,
    bbox_format: str = "xyxy",
) -> List[PoseDataSample]:
    """Estimate one pose per bbox of one (H, W, 3) BGR uint8 image. Each
    sample's ``pred_instances`` holds ``keypoints`` and ``keypoint_scores``,
    and a ProbMapHead's presence, visibility, OKS, error and confidence
    fields."""
    if not isinstance(img, np.ndarray):
        raise TypeError("inference_topdown takes the image as a numpy array (the port reads no files)")
    h, w = img.shape[:2]
    if bboxes is None or len(bboxes) == 0:
        bboxes = np.array([[0, 0, w, h]], dtype=np.float32)
    else:
        bboxes = np.asarray(bboxes, dtype=np.float32).reshape(-1, 4)
        if bbox_format not in ("xyxy", "xywh"):
            raise ValueError(f"bbox_format {bbox_format!r}")
        if bbox_format == "xywh":
            bboxes = bbox_xywh2xyxy(bboxes)

    crops, centers, scales = crop_batch(img, bboxes, model.input_size, model.device)
    preds = {k: v.float().cpu().numpy() for k, v in model.predict(crops).items() if k != "heatmaps"}

    in_wh = np.asarray(model.input_size, dtype=np.float32)
    metainfo = model.metainfo or parse_pose_metainfo({"dataset_name": "coco"})
    samples = []
    for i in range(len(bboxes)):
        kpts = preds["keypoints"][i] / in_wh * scales[i] + centers[i] - 0.5 * scales[i]
        sample = PoseDataSample(metainfo=dict(
            id=i, img_id=0, img_path=None, img_shape=(h, w), ori_shape=(h, w),
            input_size=tuple(model.input_size), input_center=centers[i], input_scale=scales[i],
            flip_indices=metainfo["flip_indices"], dataset_name=metainfo["dataset_name"],
        ))
        sample.gt_instances = InstanceData(bboxes=bboxes[i][None], bbox_scores=np.ones(1, np.float32))
        inst = InstanceData(keypoints=kpts[None].astype(np.float32))
        inst.keypoint_scores = preds["keypoint_scores"][i][None]
        for name in PROBMAP_FIELDS:  # only a ProbMapHead predicts them
            if name in preds:
                inst.set_field(preds[name][i][None], name)
        inst.bboxes = bboxes[i][None]
        inst.bbox_scores = np.ones(1, np.float32)
        sample.pred_instances = inst
        samples.append(sample)
    return samples
