"""KeypointConverter: one dataset's keypoints in another's layout.

The port's own copy of ``probpose_code_tpu/datasets/transforms/
converting.py:19`` (reference ``mmpose/datasets/transforms/converting.py:11``):
1-to-1 mappings and 2-to-1 midpoint interpolation, the flip indices remapped
as the JAX class remaps them, and ``keypoints_visible`` stacked with
``keypoints_visible_weights`` (1 on the target slots the mapping covers),
which ``GenerateTarget`` splits again.

One addition: the ProbPose ``keypoints_visibility`` flag (v == 2) is mapped
as ``keypoints_visible`` is. The JAX class leaves it at the source's
keypoint count, so ``RandomFlip`` indexes it out of range with the target's
flip indices and a batch cannot stack it.
"""

from __future__ import annotations

from typing import List, Tuple, Union

import numpy as np

from probpose_code_torch.registry import TRANSFORMS


@TRANSFORMS.register_module()
class KeypointConverter:
    def __init__(self, num_keypoints: int, mapping: Union[List[Tuple[int, int]], List[Tuple[Tuple, int]]]):
        self.num_keypoints = num_keypoints
        source_index, target_index = zip(*mapping) if len(mapping) else ((), ())
        self.interpolation = any(isinstance(x, (list, tuple)) for x in source_index)
        self.source_index = [x[0] if isinstance(x, (list, tuple)) else x for x in source_index]
        self.source_index2 = [x[1] if isinstance(x, (list, tuple)) else x for x in source_index]
        self.target_index = list(target_index)

    def _convert(self, values: np.ndarray, shape) -> np.ndarray:
        """``values`` (N, K_source, ...) in the target layout (N, K, ...):
        0 on the slots the mapping does not cover, and the product of the
        two sources (the midpoint for coordinates) where it interpolates."""
        out = np.zeros(shape)
        if self.interpolation and values.ndim == 3:
            out[:, self.target_index] = 0.5 * (values[:, self.source_index] + values[:, self.source_index2])
        elif self.interpolation:
            out[:, self.target_index] = values[:, self.source_index] * values[:, self.source_index2]
        else:
            out[:, self.target_index] = values[:, self.source_index]
        return out

    def _flip_indices(self, flip_indices: List[int]) -> List[int]:
        if self.interpolation:
            flip = [x1 if x1 == x2 else -1 for x1, x2 in zip(self.source_index, self.source_index2)]
            return [self.source_index.index(x) if x in self.source_index else i for i, x in enumerate(flip)]
        new_flip = list(range(self.num_keypoints))
        src_to_tgt = dict(zip(self.source_index, self.target_index))
        for s, t in zip(self.source_index, self.target_index):
            new_flip[t] = src_to_tgt.get(flip_indices[s] if s < len(flip_indices) else s, t)
        return new_flip

    def __call__(self, results: dict) -> dict:
        num_instances = results["keypoints"].shape[0]
        if "keypoints_visible" not in results:
            results["keypoints_visible"] = np.ones((num_instances, results["keypoints"].shape[1]))
        if results["keypoints_visible"].ndim > 2:
            results["keypoints_visible"] = results["keypoints_visible"][:, :, 0]

        key = "keypoints_3d" if "keypoints_3d" in results else "keypoints"
        last = max(self.source_index + self.source_index2, default=-1)
        if last >= results[key].shape[1]:
            raise ValueError(f"KeypointConverter: the mapping reads keypoint {last}, the sample has "
                             f"{results[key].shape[1]} ({results.get('dataset_name')})")
        shape = (num_instances, self.num_keypoints)
        keypoints = self._convert(results[key], shape + (results[key].shape[-1],))
        keypoints_visible = self._convert(results["keypoints_visible"], shape)
        keypoints_visible_weights = np.zeros(shape)
        keypoints_visible_weights[:, self.target_index] = 1.0
        if "keypoints_visibility" in results:
            results["keypoints_visibility"] = self._convert(np.asarray(results["keypoints_visibility"]),
                                                            shape).astype(np.float32)

        results[key] = keypoints
        results["keypoints_visible"] = np.stack([keypoints_visible, keypoints_visible_weights], axis=2)
        if results.get("flip_indices") is not None:
            results["flip_indices"] = self._flip_indices(results["flip_indices"])
        return results
