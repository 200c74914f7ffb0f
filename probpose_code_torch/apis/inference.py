"""User-facing inference API of the port.

Port of ``probpose_code_tpu/apis/inference.py``: ``init_model`` (``:29``,
with ``load_weights``, ``:77``) and ``inference_topdown`` (``:130``). Every
crop of a call is cut on the device (``ops/warp.py``, no OpenCV) as the
``TopdownAffine`` of the config's test pipeline sets it (``use_udp``,
``input_padding``; ``_default_val_pipeline``, ``:115``), and all crops go
through one predict call; the keypoints are mapped back to the image as in
``engine/runner.py:attach_predictions`` (``:389-418``). The image may be a
file path, as in the JAX package (``:140-141``, ``cv2.imread``): a JPEG is
decoded on the model's device (``ops/kernels/jpeg.py`` on the card,
``datasets/jpeg.py`` on the CPU) and cropped there, never copied back to
the host; a PNG is read
by ``datasets/png.py``.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from probpose_code_torch.config import Config
from probpose_code_torch.datasets import config_metainfo
from probpose_code_torch.datasets.metainfo import parse_pose_metainfo
from probpose_code_torch.datasets.transforms.loading import read_image_bytes
from probpose_code_torch.engine.checkpoint import load_checkpoint
from probpose_code_torch.engine.runner import HEATMAP_KEYS
from probpose_code_torch.models.builder import PoseModel
from probpose_code_torch.ops.warp import warp_affine_batch
from probpose_code_torch.structures.bbox import (
    bbox_xywh2xyxy,
    bbox_xyxy2cs,
    fix_aspect_ratio,
    get_udp_warp_matrix,
    get_warp_matrix,
)
from probpose_code_torch.structures.data_sample import InstanceData, PoseDataSample

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
    The weights are random, drawn from seed 0, and then the checkpoint's,
    where one is given (``engine.checkpoint.load_checkpoint``: keys it lacks
    keep their random values); its ``meta.dataset_meta``, where present,
    becomes the model's metainfo. The config stays on the model as
    ``cfg_full``, from which ``inference_topdown`` reads its crop.
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

    # the test set's metainfo: its config's, else its class's table, else COCO's (the JAX ``init_model``)
    dataset = (config.get("test_dataloader", config.get("val_dataloader", {})) or {}).get("dataset")
    metainfo = parse_pose_metainfo(config_metainfo(dataset))

    model_cfg = config["model"] if "model" in config else config
    model = PoseModel(model_cfg, metainfo=metainfo, device=device)
    model.init_weights(seed=0)
    if checkpoint is not None:
        dataset_meta = load_checkpoint(model, checkpoint)["meta"].get("dataset_meta")
        if dataset_meta:
            model.metainfo = dataset_meta
    model.cfg_full = config
    return model


def topdown_affine(config) -> Tuple[bool, float]:
    """``(use_udp, input_padding)`` of the ``TopdownAffine`` in the test
    pipeline of ``config`` (``test_dataloader``, else ``val_dataloader``),
    with the transform's defaults (False, 1.25) for a field it leaves out;
    (True, 1.25) when the config has no such pipeline, as the JAX package's
    ``_default_val_pipeline``."""
    loader = (config or {}).get("test_dataloader", (config or {}).get("val_dataloader")) or {}
    pipeline = (loader.get("dataset") or {}).get("pipeline")
    if not pipeline:
        return True, 1.25
    for t in pipeline:
        if t.get("type") == "TopdownAffine":
            return bool(t.get("use_udp", False)), float(t.get("input_padding", 1.25))
    raise ValueError("the config's test pipeline has no TopdownAffine to crop with")


def crop_batch(image: Union[np.ndarray, torch.Tensor], bboxes: np.ndarray, input_size, device, config=None):
    """Crops of ``bboxes`` (N, 4 xyxy) from one (H, W, 3) image (an array,
    or a tensor, which stays where it is when it is on ``device``) at
    ``input_size`` (w, h), cut on ``device`` and rounded to uint8 values like
    cv2.warpAffine, with the warp (UDP or not) and the box padding of the
    ``TopdownAffine`` of ``config`` (``topdown_affine``), rotation 0.
    Returns (crops (N, h, w, 3) float32, centers (N, 2), scales (N, 2))."""
    w, h = input_size
    use_udp, padding = topdown_affine(config)
    center, scale = bbox_xyxy2cs(bboxes.astype(np.float32), padding=padding)
    scale = fix_aspect_ratio(scale, aspect_ratio=w / h)
    warp_matrix = get_udp_warp_matrix if use_udp else get_warp_matrix
    mats = np.stack([warp_matrix(c, s, 0.0, output_size=(w, h)) for c, s in zip(center, scale)])
    if not isinstance(image, torch.Tensor):
        image = torch.from_numpy(np.ascontiguousarray(image))
    src = image.to(device)[None]
    crops = warp_affine_batch(src, torch.from_numpy(mats), (w, h))
    return crops.round().clamp(0, 255), center, scale


def inference_topdown(
    model: PoseModel,
    img: Union[str, os.PathLike, np.ndarray, torch.Tensor],
    bboxes: Optional[Union[List, np.ndarray]] = None,
    bbox_format: str = "xyxy",
) -> List[PoseDataSample]:
    """Estimate one pose per bbox of one image: a file path (a JPEG decoded
    on the model's device, a PNG on the host; ``read_image_bytes``), or an (H, W, 3) BGR uint8 array or tensor. Each
    sample's ``pred_instances`` holds ``keypoints`` and ``keypoint_scores``,
    and a ProbMap head's presence, visibility, OKS, error and confidence
    fields; its ``img_path`` is the path, where one was given."""
    img_path = None
    if isinstance(img, (str, os.PathLike)):
        img_path = str(img)
        with open(img_path, "rb") as f:
            img = read_image_bytes(f.read(), img_path, model.device)
    elif not isinstance(img, (np.ndarray, torch.Tensor)):
        raise TypeError("inference_topdown takes a file path or an (H, W, 3) BGR uint8 array or tensor")
    h, w = img.shape[:2]
    if bboxes is None or len(bboxes) == 0:
        bboxes = np.array([[0, 0, w, h]], dtype=np.float32)
    else:
        bboxes = np.asarray(bboxes, dtype=np.float32).reshape(-1, 4)
        if bbox_format not in ("xyxy", "xywh"):
            raise ValueError(f"bbox_format {bbox_format!r}")
        if bbox_format == "xywh":
            bboxes = bbox_xywh2xyxy(bboxes)

    crops, centers, scales = crop_batch(img, bboxes, model.input_size, model.device, model.cfg_full)
    preds = {k: v.float().cpu().numpy() for k, v in model.predict(crops).items()
             if k not in HEATMAP_KEYS}

    in_wh = np.asarray(model.input_size, dtype=np.float32)
    metainfo = model.metainfo or parse_pose_metainfo({"dataset_name": "coco"})
    samples = []
    for i in range(len(bboxes)):
        kpts = preds["keypoints"][i] / in_wh * scales[i] + centers[i] - 0.5 * scales[i]
        sample = PoseDataSample(metainfo=dict(
            id=i, img_id=0, img_path=img_path, img_shape=(h, w), ori_shape=(h, w),
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
