"""Common pipeline transforms (host-side NumPy).

The port's own copy of ``probpose_code_tpu/datasets/transforms/common.py``
(reference ``common_transforms.py``): ``GetBBoxCenterScale`` (``:28``) and
the train transforms ``RandomFlip`` (``:47``), ``RandomHalfBody``
(``:124``), ``RandomBBoxTransform`` (``:206``) and ``GenerateTarget``
(``:569``). The random transforms draw from NumPy's global generator in the
JAX transforms' order, so that the loader's per-batch seed gives the JAX
pipeline's draws. ``GenerateTarget`` takes only the JAX transform's
device-deferred form (``_device_defer``, ``:603-650``): the maps are
rendered on the device by ``PoseModel.device_preprocess_batch``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from probpose_code_torch.codecs.msra_heatmap import MSRAHeatmap
from probpose_code_torch.codecs.simcc_label import SimCCLabel
from probpose_code_torch.codecs.utils.gaussian_heatmap import gaussian_weights
from probpose_code_torch.ops.encode import DEVICE_CODECS
from probpose_code_torch.registry import TRANSFORMS

CODECS = dict(MSRAHeatmap=MSRAHeatmap, SimCCLabel=SimCCLabel)
from probpose_code_torch.structures.bbox import bbox_cs2xyxy, bbox_xyxy2cs, flip_bbox
from probpose_code_torch.structures.keypoint import flip_keypoints


@TRANSFORMS.register_module()
class GetBBoxCenterScale:
    """bbox (xyxy) -> bbox_center / bbox_scale with padding; stores
    ``bbox_xyxy_wrt_input`` for the ProbPose activation-window logic."""

    def __init__(self, padding: float = 1.25):
        self.padding = padding

    def __call__(self, results: Dict) -> Optional[dict]:
        results["bbox_xyxy_wrt_input"] = results["bbox"]
        if "bbox_center" in results and "bbox_scale" in results:
            results["bbox_scale"] = results["bbox_scale"] * self.padding
        else:
            center, scale = bbox_xyxy2cs(results["bbox"], padding=self.padding)
            results["bbox_center"] = center
            results["bbox_scale"] = scale
        return results


@TRANSFORMS.register_module()
class RandomFlip:
    """Random horizontal/vertical/diagonal flip of image + boxes + keypoints.
    A JPEG sample (``img_bytes`` from ``LoadImage``) keeps its pixels: the
    flip is recorded in ``flip`` / ``flip_direction`` and folded into the
    warp by ``TopdownAffine``, as the JAX package's lazy path does for the
    horizontal flip (``loading.py:materialize_image``)."""

    def __init__(self, prob: Union[float, List[float]] = 0.5, direction: Union[str, List[str]] = "horizontal"):
        self.prob = prob
        self.direction = direction

    def _choose_direction(self) -> Optional[str]:
        if isinstance(self.direction, str):
            direction_list = [self.direction, None]
        else:
            direction_list = list(self.direction) + [None]
        if isinstance(self.prob, list):
            prob_list = list(self.prob) + [1 - sum(self.prob)]
        else:
            single = self.prob / (len(direction_list) - 1)
            prob_list = [single] * (len(direction_list) - 1) + [1.0 - self.prob]
        return np.random.choice(direction_list, p=prob_list)

    def __call__(self, results: dict) -> dict:
        flip_dir = self._choose_direction()
        if flip_dir is None:
            results["flip"] = False
            results["flip_direction"] = None
            return results

        results["flip"] = True
        results["flip_direction"] = flip_dir
        h, w = results.get("input_size", results["img_shape"])
        axes = {"horizontal": 1, "vertical": 0}.get(flip_dir, (0, 1))
        if isinstance(results["img"], list):
            raise NotImplementedError("RandomFlip: multi-frame samples are not ported yet")
        if "img_bytes" not in results:  # a JPEG's flip is folded into its warp by TopdownAffine
            results["img"] = np.flip(results["img"], axis=axes)

        for key, fmt in (("bbox", "xyxy"), ("bbox_xyxy_wrt_input", "xyxy"), ("bbox_center", "center")):
            if results.get(key, None) is not None:
                results[key] = flip_bbox(results[key], image_size=(w, h), bbox_format=fmt, direction=flip_dir)

        if results.get("keypoints", None) is not None:
            kw = dict(image_size=(w, h), flip_indices=results["flip_indices"], direction=flip_dir)
            keypoints, keypoints_visible = flip_keypoints(results["keypoints"], results.get("keypoints_visible"), **kw)
            _, keypoints_visibility = flip_keypoints(results["keypoints"], results.get("keypoints_visibility"), **kw)
            results["keypoints"] = keypoints
            results["keypoints_visible"] = keypoints_visible
            results["keypoints_visibility"] = keypoints_visibility
        return results


@TRANSFORMS.register_module()
class RandomHalfBody:
    """Random crop to upper/lower body when enough keypoints are visible."""

    def __init__(
        self,
        min_total_keypoints: int = 9,
        min_upper_keypoints: int = 2,
        min_lower_keypoints: int = 3,
        padding: float = 1.5,
        prob: float = 0.3,
        upper_prioritized_prob: float = 0.7,
    ):
        self.min_total_keypoints = min_total_keypoints
        self.min_upper_keypoints = min_upper_keypoints
        self.min_lower_keypoints = min_lower_keypoints
        self.padding = padding
        self.prob = prob
        self.upper_prioritized_prob = upper_prioritized_prob

    def _half_body_bbox(self, keypoints, half_body_ids):
        selected = keypoints[half_body_ids]
        center = selected.mean(axis=0)[:2]
        x1, y1 = selected.min(axis=0)
        x2, y2 = selected.max(axis=0)
        scale = np.array([x2 - x1, y2 - y1], dtype=center.dtype) * self.padding
        return center, scale

    def _half_body_exact_bbox(self, keypoints, half_body_ids, bbox):
        center, scale = self._half_body_bbox(keypoints, half_body_ids)
        x1, y1 = center - scale / 2
        x2, y2 = center + scale / 2
        return np.array([max(x1, bbox[0]), max(y1, bbox[1]), min(x2, bbox[2]), min(y2, bbox[3])])

    def _select(self, keypoints_visible, upper_body_ids, lower_body_ids):
        if keypoints_visible.ndim == 3:
            keypoints_visible = keypoints_visible[..., 0]
        out = []
        for visible in keypoints_visible:
            if visible.sum() < self.min_total_keypoints or np.random.rand() > self.prob:
                out.append(None)
                continue
            upper = [i for i in upper_body_ids if visible[i] > 0]
            lower = [i for i in lower_body_ids if visible[i] > 0]
            prefer_upper = np.random.rand() < self.upper_prioritized_prob
            if len(upper) < self.min_upper_keypoints and len(lower) < self.min_lower_keypoints:
                out.append(None)
            elif len(lower) < self.min_lower_keypoints:
                out.append(upper)
            elif len(upper) < self.min_upper_keypoints:
                out.append(lower)
            else:
                out.append(upper if prefer_upper else lower)
        return out

    def __call__(self, results: Dict) -> Optional[dict]:
        half_body_ids = self._select(results["keypoints_visible"], results["upper_body_ids"],
                                     results["lower_body_ids"])
        boxes = np.asarray(results["bbox_xyxy_wrt_input"]).reshape(-1, 4)
        centers, scales, bboxes_wrt = [], [], []
        for i, indices in enumerate(half_body_ids):
            if indices is None:
                centers.append(results["bbox_center"][i])
                scales.append(results["bbox_scale"][i])
                bboxes_wrt.append(boxes[i])
            else:
                c, s = self._half_body_bbox(results["keypoints"][i], indices)
                centers.append(c)
                scales.append(s)
                bboxes_wrt.append(self._half_body_exact_bbox(results["keypoints"][i], indices, boxes[i]))
        results["bbox_center"] = np.stack(centers)
        results["bbox_scale"] = np.stack(scales)
        results["bbox_xyxy_wrt_input"] = np.stack(bboxes_wrt)
        return results


@TRANSFORMS.register_module()
class RandomBBoxTransform:
    """Truncated-normal shift/scale/rotate jitter of the bbox."""

    def __init__(
        self,
        shift_factor: float = 0.16,
        shift_prob: float = 0.3,
        scale_factor: Tuple[float, float] = (0.5, 1.5),
        scale_prob: float = 1.0,
        rotate_factor: float = 80.0,
        rotate_prob: float = 0.6,
    ):
        self.shift_factor = shift_factor
        self.shift_prob = shift_prob
        self.scale_factor = scale_factor
        self.scale_prob = scale_prob
        self.rotate_factor = rotate_factor
        self.rotate_prob = rotate_prob

    @staticmethod
    def _truncnorm_rvs(shape) -> np.ndarray:
        """Standard normal truncated to [-1, 1] by rejection: the distribution
        of ``scipy.stats.truncnorm.rvs(-1, 1)``, drawn as the JAX transform
        draws it."""
        out = np.random.randn(*shape)
        bad = np.abs(out) > 1.0
        while bad.any():
            out[bad] = np.random.randn(int(bad.sum()))
            bad = np.abs(out) > 1.0
        return out

    def _params(self, n: int):
        rv = self._truncnorm_rvs((n, 4)).astype(np.float32)
        offset = rv[:, :2] * self.shift_factor
        offset = np.where(np.random.rand(n, 1) < self.shift_prob, offset, 0.0)
        lo, hi = self.scale_factor
        scale = rv[:, 2:3] * (hi - lo) * 0.5 + (hi + lo) * 0.5
        scale = np.where(np.random.rand(n, 1) < self.scale_prob, scale, 1.0)
        rotate = rv[:, 3] * self.rotate_factor
        rotate = np.where(np.random.rand(n) < self.rotate_prob, rotate, 0.0)
        return offset, scale, rotate

    def __call__(self, results: Dict) -> Optional[dict]:
        bbox_scale = results["bbox_scale"]
        offset, scale, rotate = self._params(bbox_scale.shape[0])
        results["bbox_center"] = results["bbox_center"] + offset * bbox_scale
        results["bbox_scale"] = results["bbox_scale"] * scale
        results["bbox_rotation"] = rotate

        bbox_wrt = results.get("bbox_xyxy_wrt_input")
        if bbox_wrt is not None:
            _c, _s = bbox_xyxy2cs(bbox_wrt, padding=1.0)
            _c = _c + offset * _s
            _s = _s * scale
            results["bbox_xyxy_wrt_input"] = bbox_cs2xyxy(_c, _s).flatten()
        return results


@TRANSFORMS.register_module()
class GenerateTarget:
    """The training targets of one instance, deferred to the device: the
    heatmap-space keypoints (``device_kpts_hm``) and their visibility go to
    the batch, and ``PoseModel.device_preprocess_batch`` renders the maps on
    the model's device (expected-OKS maps for the ProbMap family, UDP
    gaussians for ``UDPHeatmap``, MSRA gaussians for ``MSRAHeatmap``, the
    x and y labels for ``SimCCLabel``); every other output of the JAX host
    codec is made here by its formulas. ``MSRAHeatmap`` ships its
    heatmap-space keypoints in float64 (``input / heatmap`` scale, the
    codec's own, ``codecs/msra_heatmap.py``): its centre is ``trunc(k +
    0.5)``, which a float32 keypoint can move by a pixel. ``SimCCLabel``
    ships the keypoints' bins (``around(k * ratio)``). Both take their
    weights from the port's codec. ``DoubleProbMap`` (``probpose_code_tpu/
    codecs/double_probmap.py:29-131``, encoded on the host in the JAX
    package) ships the keypoints in both windows' frames, in float64 as the
    codec computes them (``device_kpts_hm``: the in-window, padding
    ``in_heatmap_padding``; ``device_kpts_hm_out``: the out-window), and its
    ``in_image`` is the out-window keypoint inside the heatmap. The JAX
    transform's host encode (the (K, 64, 48) maps made in the pipeline) is
    not ported: another encoder, a list of encoders, or a ``combined``
    heatmap type raises. Its ``target_type``, ``multilevel`` and ``device``
    are set by no config and are not ported."""

    def __init__(self, encoder, use_dataset_keypoint_weights: bool = False):
        if isinstance(encoder, (list, tuple)):
            raise NotImplementedError("GenerateTarget: several encoders are not ported yet")
        self.type = encoder.get("type")
        if self.type not in DEVICE_CODECS or encoder.get("heatmap_type", "gaussian") != "gaussian":
            raise NotImplementedError(
                f"GenerateTarget: the {self.type} codec (heatmap_type {encoder.get('heatmap_type', 'gaussian')!r}) "
                f"is not ported; the port encodes {DEVICE_CODECS} (gaussian) on the device")
        self.use_dataset_keypoint_weights = use_dataset_keypoint_weights
        self.input_size = tuple(encoder["input_size"])
        self.sigma = encoder.get("sigma", 2.0)
        if self.type in CODECS:  # the port's copy of the codec gives the keypoints and weights
            self.codec = CODECS[self.type](**{k: v for k, v in encoder.items() if k != "type"})
            return
        self.heatmap_size = tuple(encoder["heatmap_size"])
        self.scale_factor = ((np.array(self.input_size) - 1) / (np.array(self.heatmap_size) - 1)).astype(np.float32)
        if self.type == "DoubleProbMap":
            # the codec's windows (``double_probmap.py:56-68``): top-left and
            # keypoint -> heatmap scale, in its float64 / float32 types
            input_wh, hm_wh = np.array(self.input_size), np.array(self.heatmap_size)
            self.windows = []
            for pad in (encoder.get("in_heatmap_padding", 1.0), encoder.get("out_heatmap_padding", 1.25)):
                act_wh = input_wh * pad
                self.windows.append((input_wh / 2 - act_wh / 2, ((act_wh - 1) / (hm_wh - 1)).astype(np.float32)))

    def _double_probmap(self, keypoints, keypoints_visible) -> Dict:
        """DoubleProbMap's outputs but its maps (``double_probmap.py:82-131``)."""
        kpts_in, kpts_out = ((keypoints[..., :2] - tl) / scale for tl, scale in self.windows)
        weights = np.asarray(keypoints_visible).copy()
        weights[keypoints_visible >= 0.5] = 1
        W, H = self.heatmap_size
        in_image = ((kpts_out[:, :, 0] >= 0) & (kpts_out[:, :, 0] < W)
                    & (kpts_out[:, :, 1] >= 0) & (kpts_out[:, :, 1] < H))
        return dict(keypoint_weights=weights, out_kpt_weights=weights.copy(), annotated=keypoints_visible > 0,
                    in_image=in_image, keypoints_scaled=keypoints, device_kpts_hm=kpts_in,
                    device_kpts_hm_out=kpts_out)

    def _device_defer(self, keypoints, keypoints_visible) -> Dict:
        assert keypoints.shape[0] == 1, "device target generation is per-instance (topdown)"
        if keypoints_visible is None:
            keypoints_visible = np.ones(keypoints.shape[:2], dtype=np.float32)
        if self.type == "DoubleProbMap":
            encoded = self._double_probmap(keypoints, keypoints_visible)
            encoded["device_kpts_visible"] = np.asarray(keypoints_visible, np.float32)
            encoded["label_mapping_table"] = dict(keypoint_weights="keypoint_weights")
            return encoded
        if self.type in CODECS:
            codec = self.codec
            if self.type == "MSRAHeatmap":
                kpts = codec.heatmap_keypoints(keypoints[..., :2])
                weights = gaussian_weights(codec.heatmap_size, kpts, keypoints_visible, codec.sigma, codec.unbiased)
            else:
                kpts = codec.bins(keypoints[..., :2]).astype(np.float32)
                weights = codec.keypoint_weights(keypoints[..., :2], keypoints_visible)
            return dict(keypoint_weights=weights, device_kpts_hm=kpts,
                        device_kpts_visible=np.asarray(keypoints_visible, np.float32),
                        label_mapping_table=dict(keypoint_weights="keypoint_weights"))
        kpts_hm = (keypoints[..., :2] / self.scale_factor).astype(np.float32)
        weights = np.asarray(keypoints_visible, np.float32).copy()
        if self.type == "UDPHeatmap":
            # visible keypoints whose 3-sigma window misses the map get no weight
            W, H = self.heatmap_size
            radius = self.sigma * 3
            mu = np.trunc(kpts_hm + 0.5)
            lt = np.trunc(mu - radius)
            rb = np.trunc(mu + radius + 1)
            in_bounds = ~((lt[..., 0] >= W) | (lt[..., 1] >= H) | (rb[..., 0] < 0) | (rb[..., 1] < 0))
            weights[(keypoints_visible >= 0.5) & ~in_bounds] = 0
            encoded = dict(keypoint_weights=weights)
        else:  # the ProbMap family: exp(-finite) > 0, so every visible keypoint weighs 1
            weights[keypoints_visible >= 0.5] = 1
            in_image = ((keypoints[:, :, 0] >= 0) & (keypoints[:, :, 0] < self.input_size[0])
                        & (keypoints[:, :, 1] >= 0) & (keypoints[:, :, 1] < self.input_size[1]))
            encoded = dict(keypoint_weights=weights, annotated=keypoints_visible > 0, in_image=in_image,
                           keypoints_scaled=keypoints, heatmap_keypoints=kpts_hm)
        encoded["device_kpts_hm"] = kpts_hm
        encoded["device_kpts_visible"] = np.asarray(keypoints_visible, np.float32)
        encoded["label_mapping_table"] = dict(keypoint_weights="keypoint_weights")
        return encoded

    def __call__(self, results: Dict) -> Optional[dict]:
        if results.get("transformed_keypoints", None) is not None:
            keypoints = results["transformed_keypoints"]
        elif results.get("keypoints", None) is not None:
            keypoints = results["keypoints"]
        else:
            raise ValueError("GenerateTarget requires 'transformed_keypoints' or 'keypoints'")
        keypoints_visible = results["keypoints_visible"]
        if keypoints_visible.ndim == 3 and keypoints_visible.shape[2] == 2:
            keypoints_visible, results["keypoints_visible_weights"] = keypoints_visible[..., 0], keypoints_visible[..., 1]
            results["keypoints_visible"] = keypoints_visible
        encoded = self._device_defer(keypoints, keypoints_visible)
        if self.use_dataset_keypoint_weights:
            encoded["keypoint_weights"] = encoded["keypoint_weights"] * results["dataset_keypoint_weights"]
        results.update(encoded)
        return results
