"""Pose NMS on the host (NumPy).

The port's own copy of ``oks_iou``, ``oks_nms`` and ``soft_oks_nms`` from
``probpose_code_tpu/evaluation/functional/nms.py`` (reference
``mmpose/evaluation/functional/nms.py:58,119,198``), which ``CocoMetric``
runs over each image's instances.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from probpose_code_torch.codecs.utils.oks_map import COCO_KPT_SIGMAS


def oks_iou(
    g: np.ndarray,
    d: np.ndarray,
    a_g: float,
    a_d: np.ndarray,
    sigmas: Optional[np.ndarray] = None,
    vis_thr: Optional[float] = None,
) -> np.ndarray:
    """OKS between instance g (K*3,) and instances d (N, K*3), vectorized."""
    if sigmas is None:
        sigmas = COCO_KPT_SIGMAS
    vars_ = (np.asarray(sigmas) * 2) ** 2
    xg, yg, vg = g[0::3], g[1::3], g[2::3]
    if len(d) == 0:  # the reference's per-instance loop is a no-op here
        return np.zeros(0, dtype=np.float64)
    d = np.asarray(d).reshape(len(d), -1)
    xd, yd, vd = d[:, 0::3], d[:, 1::3], d[:, 2::3]

    dx = xd - xg[None]
    dy = yd - yg[None]
    denom = ((a_g + np.asarray(a_d)) / 2 + np.spacing(1))[:, None]
    e = (dx**2 + dy**2) / vars_[None] / denom / 2  # (N, K)

    if vis_thr is not None:
        valid = (vg[None] > vis_thr) & (vd > vis_thr)
        n_valid = valid.sum(axis=1)
        s = np.where(valid, np.exp(-e), 0.0).sum(axis=1)
        ious = np.where(n_valid > 0, s / np.maximum(n_valid, 1), 0.0)
    else:
        ious = np.exp(-e).mean(axis=1)
    return ious.astype(np.float32)


def _db_scores(kpts_db: List[dict], score_per_joint: bool) -> np.ndarray:
    if score_per_joint:
        return np.array([k["score"].mean() for k in kpts_db])
    return np.array([k["score"] for k in kpts_db])


def oks_nms(
    kpts_db: List[dict],
    thr: float,
    sigmas: Optional[np.ndarray] = None,
    vis_thr: Optional[float] = None,
    score_per_joint: bool = False,
):
    """Greedy OKS NMS; retain overlap < thr."""
    if len(kpts_db) == 0:
        return []
    scores = _db_scores(kpts_db, score_per_joint)
    kpts = np.array([np.asarray(k["keypoints"]).flatten() for k in kpts_db])
    areas = np.array([k["area"] for k in kpts_db])

    order = scores.argsort()[::-1]
    keep: List[int] = []
    while len(order) > 0:
        i = order[0]
        keep.append(int(i))
        if len(order) == 1:
            break
        ious = oks_iou(kpts[i], kpts[order[1:]], areas[i], areas[order[1:]], sigmas, vis_thr)
        order = order[1:][ious <= thr]
    return np.array(keep)


def soft_oks_nms(
    kpts_db: List[dict],
    thr: float,
    max_dets: int = 20,
    sigmas: Optional[np.ndarray] = None,
    vis_thr: Optional[float] = None,
    score_per_joint: bool = False,
):
    """Soft NMS with gaussian OKS rescoring."""
    if len(kpts_db) == 0:
        return []
    scores = _db_scores(kpts_db, score_per_joint)
    kpts = np.array([np.asarray(k["keypoints"]).flatten() for k in kpts_db])
    areas = np.array([k["area"] for k in kpts_db])

    order = scores.argsort()[::-1]
    scores = scores[order]
    keep = []
    while len(order) > 0 and len(keep) < max_dets:
        i = order[0]
        ious = oks_iou(kpts[i], kpts[order[1:]], areas[i], areas[order[1:]], sigmas, vis_thr)
        order = order[1:]
        scores = scores[1:] * np.exp(-(ious**2) / thr)  # gaussian rescoring
        resort = scores.argsort()[::-1]
        order = order[resort]
        scores = scores[resort]
        keep.append(int(i))
    return np.array(keep, dtype=np.intp)
