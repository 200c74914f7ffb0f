"""Keypoint accuracy functions (host NumPy).

The port's own copy of ``probpose_code_tpu/evaluation/functional/
keypoint_eval.py:21-70`` (reference ``mmpose/evaluation/functional/
keypoint_eval.py``): normalized distances, PCK, its AUC, the normalized
mean error and the end-point error, which ``metrics/keypoint_2d_metrics.py``
reads. The heatmap and SimCC forms of PCK (``pose_pck_accuracy``,
``simcc_pck_accuracy``) come with the families that log them.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _calc_distances(preds, gts, mask, norm_factor) -> np.ndarray:
    """(N, K) normalized distances transposed to (K, N); -1 where masked
    or where the sample's norm factor has a 0."""
    N, K, _ = preds.shape
    _mask = mask.copy()
    _mask[np.where((norm_factor == 0).sum(1))[0], :] = False
    distances = np.full((N, K), -1, dtype=np.float32)
    norm_factor = norm_factor.astype(np.float64).copy()
    norm_factor[np.where(norm_factor <= 0)] = 1e6
    distances[_mask] = np.linalg.norm(((preds - gts) / norm_factor[:, None, :])[_mask], axis=-1)
    return distances.T


def _distance_acc(distances: np.ndarray, thr: float = 0.5) -> float:
    valid = distances != -1
    n = valid.sum()
    if n > 0:
        return (distances[valid] < thr).sum() / n
    return -1


def keypoint_pck_accuracy(pred, gt, mask, thr, norm_factor) -> Tuple[np.ndarray, float, int]:
    """Each keypoint's PCK at ``thr`` (-1 where none is valid), their mean
    over the valid ones, and how many are valid."""
    distances = _calc_distances(pred, gt, mask, norm_factor)
    acc = np.array([_distance_acc(d, thr) for d in distances])
    valid_acc = acc[acc >= 0]
    cnt = len(valid_acc)
    avg_acc = valid_acc.mean() if cnt > 0 else 0.0
    return acc, avg_acc, cnt


def keypoint_auc(pred, gt, mask, norm_factor, num_thrs: int = 20) -> float:
    """The mean PCK over ``num_thrs`` thresholds in [0, 1) of a distance
    normalized by ``norm_factor`` pixels."""
    nor = np.tile(np.array([[norm_factor, norm_factor]]), (pred.shape[0], 1))
    avg_accs = []
    for i in range(num_thrs):
        thr = 1.0 * i / num_thrs
        _, avg_acc, _ = keypoint_pck_accuracy(pred, gt, mask, thr, nor)
        avg_accs.append(avg_acc)
    return float(np.mean(avg_accs))


def keypoint_nme(pred, gt, mask, normalize_factor) -> float:
    """The mean over the masked keypoints of their distance over the norm
    factor (N, 2) of their sample (the JAX function's float32, as a float)."""
    distances = _calc_distances(pred, gt, mask, normalize_factor)
    distance_valid = distances[distances != -1]
    return float(distance_valid.sum() / max(len(distance_valid), 1))


def keypoint_epe(pred, gt, mask) -> float:
    """The mean end-point error in pixels over the masked keypoints."""
    distances = _calc_distances(pred, gt, mask, np.ones((pred.shape[0], pred.shape[2]), dtype=np.float32))
    distance_valid = distances[distances != -1]
    return float(distance_valid.sum() / max(len(distance_valid), 1))
