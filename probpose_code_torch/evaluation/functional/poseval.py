"""PoseTrack18's per-joint AP (the poseval protocol), in NumPy.

The port's own copy of ``probpose_code_tpu/evaluation/functional/poseval.py``
(``_head_norm``, ``_match_frame``, ``_voc_ap`` and ``evaluate_ap``,
``:46-175``, with the joint groups and stat names), which reimplements the
external ``poseval`` package that mmpose's ``PoseTrack18Metric`` calls:

- distances are normalized per ground-truth pose by its head size (PCKh:
  0.6 times the diagonal of ``bbox_head``; else twice the head_bottom /
  head_top segment; else the box's diagonal); a joint is correct below 0.5;
- per frame, predicted poses are assigned 1:1 to ground-truth poses by the
  Hungarian assignment that maximizes the count of correct joints
  (``scipy.optimize.linear_sum_assignment``), keeping pairs with a count
  above 0; every prediction of a frame counts, matched or not;
- per joint, the detections of all frames are ranked by their score, and AP
  is the area under the interpolated precision-recall curve, with recall
  over the annotated ground-truth joints.

The stats are the groups' mean APs (Head ... Ankl) and ``AP`` over the used
joints, in percent.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

# PoseTrack18 joint order (reference metainfo posetrack18.json):
# 0 nose, 1 head_bottom, 2 head_top, 3-4 ears (unused), 5-6 shoulders,
# 7-8 elbows, 9-10 wrists, 11-12 hips, 13-14 knees, 15-16 ankles
JOINT_GROUPS = {
    "Head": [0, 1, 2],
    "Shou": [5, 6],
    "Elb": [7, 8],
    "Wri": [9, 10],
    "Hip": [11, 12],
    "Knee": [13, 14],
    "Ankl": [15, 16],
}
STAT_NAMES = ["Head AP", "Shou AP", "Elb AP", "Wri AP", "Hip AP", "Knee AP", "Ankl AP", "AP"]


def _head_norm(gt_pose: Dict) -> float:
    """PCKh reference length for one GT pose.

    Prefers the annotated head bbox (PoseTrack ``bbox_head``); falls back to
    the head_top/head_bottom keypoint segment, then to the instance bbox.
    """
    hb = gt_pose.get("bbox_head")
    if hb is not None and len(hb) == 4 and (hb[2] > 0 or hb[3] > 0):
        return 0.6 * float(np.hypot(hb[2], hb[3]))
    k = np.asarray(gt_pose["keypoints"], np.float64).reshape(-1, 3)
    if k.shape[0] > 2 and k[1, 2] > 0 and k[2, 2] > 0:
        seg = np.linalg.norm(k[1, :2] - k[2, :2])
        if seg > 0:
            return 0.6 * seg * 2.0
    bb = gt_pose.get("bbox")
    if bb is not None and len(bb) >= 4:
        return 0.6 * float(np.hypot(bb[2], bb[3]))
    return 1.0


def _match_frame(
    gt_poses: List[Dict], pred_poses: List[Dict], dist_thresh: float = 0.5
) -> List[Tuple[int, int]]:
    """1:1 pose assignment maximizing the PCKh-correct joint count."""
    if not gt_poses or not pred_poses:
        return []
    counts = np.zeros((len(pred_poses), len(gt_poses)), np.int64)
    for pi, pred in enumerate(pred_poses):
        pk = np.asarray(pred["keypoints"], np.float64).reshape(-1, 3)
        for gi, gt in enumerate(gt_poses):
            gk = np.asarray(gt["keypoints"], np.float64).reshape(-1, 3)
            norm = _head_norm(gt)
            K = min(len(pk), len(gk))
            vis = gk[:K, 2] > 0
            d = np.linalg.norm(pk[:K, :2] - gk[:K, :2], axis=-1) / max(norm, 1e-9)
            counts[pi, gi] = int(((d < dist_thresh) & vis).sum())
    from scipy.optimize import linear_sum_assignment

    rows, cols = linear_sum_assignment(-counts)
    return [(int(r), int(c)) for r, c in zip(rows, cols) if counts[r, c] > 0]


def _voc_ap(scores: np.ndarray, is_tp: np.ndarray, n_gt: int) -> float:
    """Interpolated AP from score-ranked detections (PASCAL/poseval style)."""
    if n_gt == 0:
        return float("nan")
    if scores.size == 0:
        return 0.0
    order = np.argsort(-scores)
    tp = is_tp[order].astype(np.float64)
    fp = 1.0 - tp
    tp_cum = np.cumsum(tp)
    fp_cum = np.cumsum(fp)
    recall = tp_cum / n_gt
    precision = tp_cum / np.maximum(tp_cum + fp_cum, 1e-9)
    # monotone interpolation
    for i in range(len(precision) - 2, -1, -1):
        precision[i] = max(precision[i], precision[i + 1])
    # area under PR
    idx = np.where(np.diff(np.concatenate([[0.0], recall])) > 0)[0]
    return float(np.sum(precision[idx] * np.diff(np.concatenate([[0.0], recall]))[idx]))


def evaluate_ap(
    gt_frames: Dict[str, List[Dict]],
    pred_frames: Dict[str, List[Dict]],
    dist_thresh: float = 0.5,
    num_joints: int = 17,
) -> List[Tuple[str, float]]:
    """Per-joint-group AP over frames.

    Args:
        gt_frames / pred_frames: frame-key -> list of pose dicts with
            ``keypoints`` (K*3 flat, v/score in the 3rd column); GT poses may
            carry ``bbox_head``; predictions may carry per-joint ``scores``.

    Returns:
        ``[(stat_name, value), ...]`` matching the reference's
        ``stats_names`` list (posetrack18_metric.py:242).
    """
    per_joint_scores: List[List[float]] = [[] for _ in range(num_joints)]
    per_joint_tp: List[List[bool]] = [[] for _ in range(num_joints)]
    per_joint_ngt = np.zeros(num_joints, np.int64)

    for key, gt_poses in gt_frames.items():
        pred_poses = pred_frames.get(key, [])
        for gt in gt_poses:
            gk = np.asarray(gt["keypoints"], np.float64).reshape(-1, 3)
            vis = gk[:, 2] > 0
            for j in range(min(num_joints, len(vis))):
                per_joint_ngt[j] += int(vis[j])

        matches = _match_frame(gt_poses, pred_poses, dist_thresh)
        matched_preds = {pi: gi for pi, gi in matches}
        for pi, pred in enumerate(pred_poses):
            pk = np.asarray(pred["keypoints"], np.float64).reshape(-1, 3)
            jscores = np.asarray(pred.get("scores", pk[:, 2]), np.float64).reshape(-1)
            gi = matched_preds.get(pi)
            if gi is not None:
                gt = gt_poses[gi]
                gk = np.asarray(gt["keypoints"], np.float64).reshape(-1, 3)
                norm = max(_head_norm(gt), 1e-9)
            for j in range(min(num_joints, len(pk))):
                if jscores[j] <= 0:
                    continue  # joint not predicted
                tp = False
                if gi is not None and j < len(gk) and gk[j, 2] > 0:
                    tp = bool(np.linalg.norm(pk[j, :2] - gk[j, :2]) / norm < dist_thresh)
                per_joint_scores[j].append(float(jscores[j]))
                per_joint_tp[j].append(tp)

    ap = np.array(
        [
            _voc_ap(np.asarray(per_joint_scores[j]), np.asarray(per_joint_tp[j]), int(per_joint_ngt[j]))
            for j in range(num_joints)
        ]
    )
    stats = []
    for name, idxs in JOINT_GROUPS.items():
        vals = ap[[i for i in idxs if i < num_joints]]
        vals = vals[~np.isnan(vals)]
        stats.append((f"{name} AP", float(np.mean(vals) * 100) if vals.size else float("nan")))
    # total excludes the unused ear joints, like the poseval cumulative row
    used = sorted({i for idxs in JOINT_GROUPS.values() for i in idxs if i < num_joints})
    total = ap[used]
    total = total[~np.isnan(total)]
    stats.append(("AP", float(np.mean(total) * 100) if total.size else float("nan")))
    return stats
