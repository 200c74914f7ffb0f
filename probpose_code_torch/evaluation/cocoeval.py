"""COCO keypoint evaluation with the ProbPose Ex-OKS / Ex-mAP extension.

The port's own copy of ``probpose_code_tpu/evaluation/cocoeval.py``
(reference ``mmpose/evaluation/metrics/_cocoeval.py``) for the body
``keypoints`` iouType, CrowdPose's ``keypoints_crowd`` (``:49``, ``:70``,
``:213-228``: the same keypoint field, one ignore flag for every
visibility level, set where the annotation is a crowd and ``ignore``d, or
has exactly 2 keypoints) and COCO-WholeBody's part iouTypes
``keypoints_body`` / ``_foot`` / ``_face`` / ``_lefthand`` / ``_righthand``
/ ``_wholebody`` (``:40-90``, ``:143``, ``:204-240``: each reads its own
field, ``body`` the first 17 rows of ``keypoints``, ``wholebody`` the five
fields in turn; a part's detections are ranked by ``<part>_score``, which
falls back to ``score``). ``segm`` (RLE mask IoU, ``:339``) and ``bbox``
raise: they come with the bottom-up slice. Neither are the JAX
package's diagnostic bbox-center pairs (``matched_pairs``) ported: no stat
reads them.

- visibility-level stacks: precision/recall carry an extra V axis; level 0
  is "any annotated" (v>0), further levels are the distinct visibility
  values present in the GT (1, 2, and 3 = out-of-image).
- ``extended_oks`` (``computeExtendedOks``): GT v==3 marks out-of-image
  keypoints (from ``pad_to_contain`` > padding); penalty distances use the
  extended activation-window bbox (``fix_bbox_aspect_ratio`` with 3/4
  aspect + padding): pred-in/GT-out -> distance of the pred to the nearest
  window edge, pred-out/GT-in -> GT's distance to the nearest edge,
  both-out -> 0. A prediction is "in" when its confidence reaches
  ``confidence_thr``.
- ``match_by_bbox``: greedy matching by nearest bbox center among
  candidates above the IoU threshold (within 20 px).
- if every GT in an image is ignored, all its detections are ignored too.
- ``summarize`` gives the stats CocoMetric reads: AP, AP (v=k)..., AP .5,
  AP .75, AP (M), AP (L), AR, AR .5, AR .75, AR (M), AR (L), OKS (the mean
  matched localization similarity).
"""

from __future__ import annotations

import copy
from collections import defaultdict
from typing import List, Optional

import numpy as np

from probpose_code_torch.codecs.utils.oks_map import COCO_KPT_SIGMAS
from probpose_code_torch.structures.keypoint import fix_bbox_aspect_ratio


# COCO-WholeBody's keypoint fields, in the order of its 133 keypoints
WHOLEBODY_PARTS = ("keypoints", "foot_kpts", "face_kpts", "lefthand_kpts", "righthand_kpts")
PART_IOU_TYPES = ("keypoints_body", "keypoints_foot", "keypoints_face", "keypoints_lefthand",
                  "keypoints_righthand", "keypoints_wholebody")
IOU_TYPES = ("keypoints", "keypoints_crowd", *PART_IOU_TYPES)


def _fields(iou_type: str) -> tuple:
    """The annotation fields an iouType reads, in order."""
    if iou_type == "keypoints_wholebody":
        return WHOLEBODY_PARTS
    if iou_type in PART_IOU_TYPES and iou_type != "keypoints_body":
        return (iou_type[len("keypoints_"):] + "_kpts",)
    return ("keypoints",)


def _extract_keypoints(ann: dict, iou_type: str) -> np.ndarray:
    """The flat [x, y, v] * K vector of an annotation that ``iou_type``
    reads (``keypoints_body``: the first 17 keypoints)."""
    vals = np.concatenate([np.array(ann[f], dtype=np.float64).flatten() for f in _fields(iou_type)])
    return vals[: 17 * 3] if iou_type == "keypoints_body" else vals


def _set_keypoint_vis(ann: dict, iou_type: str, vis: np.ndarray) -> None:
    """Write normalized visibilities back into the fields ``iou_type`` reads."""
    vis = vis.astype(int).tolist()
    off = 0
    for field in _fields(iou_type):
        arr = list(np.array(ann[field]).flatten())
        n = len(arr) // 3
        arr[2::3] = vis[off:off + n]
        ann[field] = arr
        off += n


def _score_key_for(iou_type: str) -> str:
    """The detection field a part iouType ranks by (``<part>_score``; the
    body part and the others rank by ``score``)."""
    if iou_type in PART_IOU_TYPES and iou_type != "keypoints_body":
        return iou_type[len("keypoints_"):] + "_score"
    return "score"


class Params:
    """Evaluation parameters (the keypoint preset)."""

    def __init__(self, iouType: str = "keypoints"):
        if iouType not in IOU_TYPES:
            raise NotImplementedError(f"iouType {iouType!r}: the port evaluates the keypoint iouTypes only, "
                                      f"{IOU_TYPES}")
        self.iouThrs = np.linspace(0.5, 0.95, 10, endpoint=True)
        self.recThrs = np.linspace(0.0, 1.00, 101, endpoint=True)
        self.imgIds: List[int] = []
        self.catIds: List[int] = []
        self.useCats = 1
        self.maxDets = [20]
        self.areaRng = [[0, 1e5**2], [32**2, 96**2], [96**2, 1e5**2]]
        self.areaRngLbl = ["all", "medium", "large"]
        self.iouType = iouType


class COCOeval:
    def __init__(
        self,
        cocoGt=None,
        cocoDt=None,
        iouType: str = "keypoints",
        sigmas: Optional[np.ndarray] = None,
        use_area: bool = True,
        extended_oks: bool = False,
        match_by_bbox: bool = False,
        confidence_thr: float = 0.5,
        padding: float = 1.25,
        ignore_near_bbox: bool = False,
    ):
        self.sigmas = np.asarray(sigmas) if sigmas is not None else COCO_KPT_SIGMAS.copy()
        self.cocoGt = copy.deepcopy(cocoGt)
        self.cocoDt = copy.deepcopy(cocoDt)
        self.params = Params(iouType=iouType)
        self.evalImgs: List = []
        self.eval: dict = {}
        self._gts = defaultdict(list)
        self._dts = defaultdict(list)
        self.stats: np.ndarray = np.array([])
        self.stats_names: List[str] = []
        self.ious = {}
        if cocoGt is not None:
            self.params.imgIds = sorted(cocoGt.getImgIds())
            self.params.catIds = sorted(cocoGt.getCatIds())
        self.use_area = use_area
        self.score_key = _score_key_for(iouType)
        self.extended_oks = extended_oks
        self.confidence_thr = confidence_thr
        self.match_by_bbox = match_by_bbox
        self.padding = padding
        self.ignore_near_bbox = ignore_near_bbox
        self.gt_visibilities: List[int] = []
        self.loc_similarities: List[float] = []
        self.verbose = True

    def _log(self, *args):
        if self.verbose:
            print(*args)

    # ------------------------------------------------------------------
    # preparation
    # ------------------------------------------------------------------

    def _prepare(self):
        p = self.params
        if p.useCats:
            gts = self.cocoGt.loadAnns(self.cocoGt.getAnnIds(imgIds=p.imgIds, catIds=p.catIds))
            dts = self.cocoDt.loadAnns(self.cocoDt.getAnnIds(imgIds=p.imgIds, catIds=p.catIds))
        else:
            gts = self.cocoGt.loadAnns(self.cocoGt.getAnnIds(imgIds=p.imgIds))
            dts = self.cocoDt.loadAnns(self.cocoDt.getAnnIds(imgIds=p.imgIds))

        # ---- pass 1: visibility relabeling + level discovery -----------
        vis_levels = set()
        for gt in gts:
            g = _extract_keypoints(gt, p.iouType)
            vis = g[2::3].copy()

            if self.ignore_near_bbox:
                x0, y0, w, h = gt["bbox"]
                x1, y1 = x0 + w, y0 + h
                tol_x, tol_y = 0.05 * w, 0.05 * h
                x, y = g[0::3], g[1::3]
                near = (
                    ((np.abs(x - x0) < tol_x) & (y > y0 - tol_y) & (y < y1 + tol_y))
                    | ((np.abs(x - x1) < tol_x) & (y > y0 - tol_y) & (y < y1 + tol_y))
                    | ((np.abs(y - y0) < tol_y) & (x > x0 - tol_x) & (x < x1 + tol_x))
                    | ((np.abs(y - y1) < tol_y) & (x > x0 - tol_x) & (x < x1 + tol_x))
                )
                vis[near] = 0

            if not self.extended_oks:
                # classic OKS knows only v in {1, 2}
                vis[~((vis == 1) | (vis == 2))] = 0
            elif "pad_to_contain" in gt:
                # v==3 <=> keypoint outside the activation window
                pad = np.array(gt["pad_to_contain"], dtype=np.float64)
                pad[vis <= 0] = -1.0
                out_mask = pad > self.padding
                vis[(vis > 2) & (~out_mask)] = 1
                vis[out_mask] = 3

            vis_levels.update(np.unique(vis.astype(int)).tolist())
            _set_keypoint_vis(gt, p.iouType, vis)

        self.gt_visibilities = sorted(v for v in vis_levels if v > 0)
        self._log(f"Evaluating {len(self.gt_visibilities) + 1} levels of visibility: {self.gt_visibilities}")

        # ---- pass 2: per-level ignore flags ----------------------------
        n_levels = len(self.gt_visibilities) + 1
        for gt in gts:
            if p.iouType == "keypoints_crowd":
                base_ignore = gt.get("ignore", 0) and gt.get("iscrowd", 0)
                gt["ignore"] = [bool(base_ignore) or gt["num_keypoints"] == 2] * n_levels
                continue
            vis = _extract_keypoints(gt, p.iouType)[2::3]
            unique_vis = np.unique(vis[vis > 0].astype(int))
            # level k (k>=1) ignored unless the GT has a keypoint of that
            # visibility; level 0 ignored when nothing is annotated
            # (reference :361-368 — note it overrides the crowd flag)
            ignore = np.ones(n_levels, dtype=bool)
            for uv in unique_vis:
                if uv in self.gt_visibilities:
                    ignore[self.gt_visibilities.index(uv) + 1] = False
            ignore[0] = len(unique_vis) <= 0
            gt["ignore"] = ignore.tolist()

        self._gts = defaultdict(list)
        self._dts = defaultdict(list)
        for gt in gts:
            self._gts[gt["image_id"], gt["category_id"]].append(gt)
        for dt in dts:
            d = _extract_keypoints(dt, p.iouType)
            if self.score_key not in dt:
                dt[self.score_key] = dt["score"]
            if "visibilities" not in dt:
                dt["visibilities"] = d[2::3]
            if np.count_nonzero(d[2::3] > 0) == 0:
                continue
            self._dts[dt["image_id"], dt["category_id"]].append(dt)

        self.evalImgs = []
        self.eval = {}

    # ------------------------------------------------------------------
    # OKS / IoU surfaces
    # ------------------------------------------------------------------

    def computeExtendedOks(self, imgId, catId, original: bool = False):
        """[D x G] OKS per visibility level (level 0 = any annotated)."""
        p = self.params
        gts = self._gts[imgId, catId]
        dts = self._dts[imgId, catId]
        inds = np.argsort([-d[self.score_key] for d in dts], kind="mergesort")
        dts = [dts[i] for i in inds][: p.maxDets[-1]]
        n_levels = len(self.gt_visibilities) + 1
        if len(gts) == 0 or len(dts) == 0:
            return [[] for _ in range(n_levels)]

        sigmas = self.sigmas
        vars_ = (sigmas * 2) ** 2
        K = len(sigmas)
        padding = 1.0 if original else self.padding
        assert self.padding >= 1.0

        # detection arrays (D, K)
        d_all = np.stack([_extract_keypoints(d, p.iouType) for d in dts])
        xd, yd = d_all[:, 0::3], d_all[:, 1::3]
        cd = np.clip(d_all[:, 2::3], 0, 1)
        if self.confidence_thr is not None:
            cd = (cd >= self.confidence_thr).astype(int)

        ious = [np.zeros((len(dts), len(gts))) for _ in range(n_levels)]

        for j, gt in enumerate(gts):
            g = _extract_keypoints(gt, p.iouType)
            xg, yg, vg = g[0::3], g[1::3], g[2::3]
            gt_in_img = vg < 3

            vis_masks = [vg > 0] + [vg == v for v in self.gt_visibilities]

            bb = gt["bbox"]
            if original:
                x0, x1 = bb[0] - bb[2], bb[0] + bb[2] * 2
                y0, y1 = bb[1] - bb[3], bb[1] + bb[3] * 2
            else:
                bb_xyxy = np.array([bb[0], bb[1], bb[0] + bb[2], bb[1] + bb[3]])
                x0, y0, x1, y1 = fix_bbox_aspect_ratio(bb_xyxy, padding=self.padding, bbox_format="xyxy")

            # pairwise squared distances (D, K)
            dist_sq = (xd - xg[None]) ** 2 + (yd - yg[None]) ** 2
            if not original:
                # distance of pred / gt to the nearest window edge
                de_pred = np.minimum(xd - x0, x1 - xd) ** 2 + np.minimum(yd - y0, y1 - yd) ** 2
                de_gt = (np.minimum(xg - x0, x1 - xg) ** 2 + np.minimum(yg - y0, y1 - yg) ** 2)[None]
                pred_in = cd == 1
                dist_sq = np.where(~gt_in_img[None] & pred_in, de_pred, dist_sq)
                dist_sq = np.where(gt_in_img[None] & ~pred_in, np.broadcast_to(de_gt, dist_sq.shape), dist_sq)
                dist_sq = np.where(~gt_in_img[None] & ~pred_in, 0.0, dist_sq)

            # out-of-window penalty when the GT has no keypoint of a level
            dx_out = np.maximum(0, x0 - xd) + np.maximum(0, xd - x1)
            dy_out = np.maximum(0, y0 - yd) + np.maximum(0, yd - y1)
            dist_sq_out = dx_out**2 + dy_out**2

            tmparea = gt["bbox"][3] * gt["bbox"][2] * 0.53
            if self.use_area:
                tmparea = gt["area"]
            denom = vars_[None] * (tmparea + np.spacing(1)) * 2

            e_in = dist_sq / denom
            e_out = dist_sq_out / denom

            for level, vis_mask in enumerate(vis_masks):
                k1 = np.count_nonzero(vis_mask)
                if k1 > 0:
                    e = e_in[:, vis_mask]
                else:
                    e = e_out
                loc_oks = np.exp(-e).sum(axis=1) / e.shape[1]
                ious[level][:, j] = loc_oks
        return ious

    # ------------------------------------------------------------------
    # matching
    # ------------------------------------------------------------------

    def evaluate(self):
        p = self.params
        p.imgIds = list(np.unique(p.imgIds))
        if p.useCats:
            p.catIds = list(np.unique(p.catIds))
        p.maxDets = sorted(p.maxDets)

        self._prepare()
        catIds = p.catIds if p.useCats else [-1]

        if self.match_by_bbox:
            self._log("Matching by bbox...")
        if self.extended_oks:
            self._log("Using extended OKS...")

        self.ious = {
            (imgId, catId): self.computeExtendedOks(imgId, catId, original=not self.extended_oks)
            for imgId in p.imgIds
            for catId in catIds
        }

        maxDet = p.maxDets[-1]
        n_levels = len(self.gt_visibilities) + 1
        self.loc_similarities = []
        self.evalImgs = [
            self.evaluateImg(imgId, catId, areaRng, maxDet, iou_i=iou_i)
            for catId in catIds
            for iou_i in range(n_levels)
            for areaRng in p.areaRng
            for imgId in p.imgIds
        ]
        self._n_levels = n_levels

        if self.loc_similarities:
            self._log(f"Loc similarity: {np.mean(self.loc_similarities):.4f}")
        self._paramsEval = copy.deepcopy(self.params)

    def evaluateImg(self, imgId, catId, aRng, maxDet, iou_i=0):
        p = self.params
        iouThrs = p.iouThrs
        gt = self._gts[imgId, catId]
        dt = self._dts[imgId, catId]
        if len(gt) == 0 and len(dt) == 0:
            return None

        for g in gt:
            if "area" not in g or not self.use_area:
                tmp_area = g["bbox"][2] * g["bbox"][3] * 0.53
            else:
                tmp_area = g["area"]
            ignore_flags = g["ignore"] if isinstance(g["ignore"], (list, np.ndarray)) else [g["ignore"]]
            level = min(iou_i, len(ignore_flags) - 1)
            g["_ignore"] = 1 if (ignore_flags[level] or tmp_area < aRng[0] or tmp_area > aRng[1]) else 0

        gtind = np.argsort([g["_ignore"] for g in gt], kind="mergesort")
        gt = [gt[i] for i in gtind]
        dtind = np.argsort([-d[self.score_key] for d in dt], kind="mergesort")
        dt = [dt[i] for i in dtind[:maxDet]]
        iscrowd = [int(o.get("iscrowd", 0)) for o in gt]

        iou_levels = self.ious[imgId, catId]
        iou = iou_levels[min(iou_i, len(iou_levels) - 1)] if len(iou_levels) else []
        if len(iou):
            iou = iou[:, gtind]

        T, G, D = len(iouThrs), len(gt), len(dt)
        gtm = -np.ones((T, G), dtype=np.int64)
        dtm = -np.ones((T, D), dtype=np.int64)
        gtIg = np.array([g["_ignore"] for g in gt])
        dtIg = np.zeros((T, D))

        if len(iou):
            for tind, t in enumerate(iouThrs):
                for dind, d in enumerate(dt):
                    best_iou = min(t, 1 - 1e-10)
                    m = -1
                    if self.match_by_bbox:
                        closest_dist = 20
                        d_bbox = np.array(d["bbox"])
                        d_center = d_bbox[:2] + d_bbox[2:] / 2
                        for gind, g in enumerate(gt):
                            g_bbox = np.array(g["bbox"])
                            g_center = g_bbox[:2] + g_bbox[2:] / 2
                            if gtm[tind, gind] >= 0 and not iscrowd[gind]:
                                continue
                            if m > -1 and gtIg[m] == 0 and gtIg[gind] == 1:
                                break
                            if iou[dind, gind] < t:
                                continue
                            abs_dist = np.abs(d_center - g_center).sum()
                            if abs_dist < closest_dist:
                                closest_dist = abs_dist
                                m = gind
                                best_iou = iou[dind, gind]
                    else:
                        for gind, g in enumerate(gt):
                            if gtm[tind, gind] >= 0 and not iscrowd[gind]:
                                continue
                            if m > -1 and gtIg[m] == 0 and gtIg[gind] == 1:
                                break
                            if iou[dind, gind] < best_iou:
                                continue
                            best_iou = iou[dind, gind]
                            m = gind

                    if m == -1:
                        continue
                    self.loc_similarities.append(best_iou)
                    dtIg[tind, dind] = gtIg[m]
                    dtm[tind, dind] = gt[m]["id"]
                    gtm[tind, m] = d["id"]

        # unmatched detections outside the area range are ignored
        a = np.array([d.get("area", 0) < aRng[0] or d.get("area", 0) > aRng[1] for d in dt]).reshape(1, D)
        dtIg = np.logical_or(dtIg, np.logical_and(dtm < 0, np.repeat(a, T, 0)))
        if G > 0 and np.all(gtIg):
            dtIg[:] = True

        return {
            "image_id": imgId,
            "category_id": catId,
            "aRng": aRng,
            "maxDet": maxDet,
            "dtIds": [d["id"] for d in dt],
            "gtIds": [g["id"] for g in gt],
            "dtMatches": dtm,
            "gtMatches": gtm,
            "dtScores": [d[self.score_key] for d in dt],
            "gtIgnore": gtIg,
            "dtIgnore": dtIg,
            "gtIndices": gtind,
        }

    # ------------------------------------------------------------------
    # accumulation / summary
    # ------------------------------------------------------------------

    def accumulate(self, p=None):
        if not self.evalImgs:
            raise RuntimeError("Please run evaluate() first")
        if p is None:
            p = self.params
        p.catIds = p.catIds if p.useCats == 1 else [-1]
        T = len(p.iouThrs)
        R = len(p.recThrs)
        K = len(p.catIds) if p.useCats else 1
        A = len(p.areaRng)
        M = len(p.maxDets)
        V = getattr(self, "_n_levels", 1)
        precision = -np.ones((T, V, R, K, A, M))
        recall = -np.ones((T, V, K, A, M))
        scores = -np.ones((T, V, R, K, A, M))

        I = len(p.imgIds)
        for k in range(K):
            for v in range(V):
                for a in range(A):
                    base = ((k * V + v) * A + a) * I
                    for m, maxDet in enumerate(p.maxDets):
                        E = [self.evalImgs[base + i] for i in range(I)]
                        E = [e for e in E if e is not None]
                        if not E:
                            continue
                        dtScores = np.concatenate([e["dtScores"][:maxDet] for e in E])
                        inds = np.argsort(-dtScores, kind="mergesort")
                        dtScoresSorted = dtScores[inds]
                        dtm = np.concatenate([e["dtMatches"][:, :maxDet] for e in E], axis=1)[:, inds]
                        dtIg = np.concatenate([e["dtIgnore"][:, :maxDet] for e in E], axis=1)[:, inds]
                        gtIg = np.concatenate([e["gtIgnore"] for e in E])
                        npig = np.count_nonzero(gtIg == 0)
                        if npig == 0:
                            continue
                        tps = np.logical_and(dtm >= 0, np.logical_not(dtIg))
                        fps = np.logical_and(dtm < 0, np.logical_not(dtIg))
                        tp_sum = np.cumsum(tps, axis=1).astype(np.float64)
                        fp_sum = np.cumsum(fps, axis=1).astype(np.float64)
                        for t in range(T):
                            tp, fp = tp_sum[t], fp_sum[t]
                            nd = len(tp)
                            rc = tp / npig
                            pr = tp / (fp + tp + np.spacing(1))
                            recall[t, v, k, a, m] = rc[-1] if nd else 0
                            # precision envelope (monotone decreasing)
                            pr = pr.tolist()
                            for i in range(nd - 1, 0, -1):
                                if pr[i] > pr[i - 1]:
                                    pr[i - 1] = pr[i]
                            q = np.zeros(R)
                            ss = np.zeros(R)
                            rec_inds = np.searchsorted(rc, p.recThrs, side="left")
                            for ri, pi in enumerate(rec_inds):
                                if pi < nd:
                                    q[ri] = pr[pi]
                                    ss[ri] = dtScoresSorted[pi]
                            precision[t, v, :, k, a, m] = q
                            scores[t, v, :, k, a, m] = ss

        self.eval = dict(
            params=p,
            counts=[T, V, R, K, A, M],
            precision=precision,
            recall=recall,
            scores=scores,
        )

    def _summarize(self, ap=1, iouThr=None, areaRng="all", maxDets=20, visibility=None):
        p = self.params
        aind = [i for i, lbl in enumerate(p.areaRngLbl) if lbl == areaRng]
        mind = [i for i, mDet in enumerate(p.maxDets) if mDet == maxDets]
        v = 0 if visibility is None else self.gt_visibilities.index(visibility) + 1

        if ap == 1:
            s = self.eval["precision"]
            if iouThr is not None:
                s = s[np.where(iouThr == p.iouThrs)[0]]
            s = s[:, v, :, :, aind, mind]
        else:
            s = self.eval["recall"]
            if iouThr is not None:
                s = s[np.where(iouThr == p.iouThrs)[0]]
            s = s[:, v, :, aind, mind]
        valid = s[s > -1]
        mean_s = np.mean(valid) if len(valid) else -1

        if self.verbose:
            title = "Average Precision" if ap == 1 else "Average Recall"
            type_str = "(AP)" if ap == 1 else "(AR)"
            iou_str = (
                f"{p.iouThrs[0]:0.2f}:{p.iouThrs[-1]:0.2f}" if iouThr is None else f"{iouThr:0.2f}"
            )
            if v > 0:
                vis_str = f"[{int(visibility)}]"
            elif self.extended_oks:
                vis_str = "[>0]"
            else:
                vis_str = "[1,2]"
            print(
                f" {title:<18} {type_str} @[ IoU={iou_str:<9} | area={areaRng:>6s} |"
                f" maxDets={maxDets:>3d} | vis={vis_str:>5s} ] = {mean_s: 0.3f}"
            )
        return mean_s

    def summarize(self):
        if not self.eval:
            raise RuntimeError("Please run accumulate() first")
        self.stats, self.stats_names = self._summarize_kps()

    def _summarize_kps(self):
        num_vis = len(self.gt_visibilities)
        stats = np.zeros(11 + num_vis)
        names: List[Optional[str]] = [None] * len(stats)

        stats[0] = self._summarize(1, maxDets=20)
        names[0] = "AP"
        for vi, v in enumerate(self.gt_visibilities):
            stats[1 + vi] = self._summarize(1, maxDets=20, visibility=v)
            names[1 + vi] = f"AP (v={v:d})"
        rows = [
            (1, 0.5, "all", "AP .5"),
            (1, 0.75, "all", "AP .75"),
            (1, None, "medium", "AP (M)"),
            (1, None, "large", "AP (L)"),
            (0, None, "all", "AR"),
            (0, 0.5, "all", "AR .5"),
            (0, 0.75, "all", "AR .75"),
            (0, None, "medium", "AR (M)"),
            (0, None, "large", "AR (L)"),
        ]
        for off, (ap, it, ar, name) in enumerate(rows):
            stats[1 + num_vis + off] = self._summarize(ap, iouThr=it, areaRng=ar, maxDets=20)
            names[1 + num_vis + off] = name
        stats[10 + num_vis] = float(np.mean(self.loc_similarities)) if len(self.loc_similarities) else 0.0
        names[10 + num_vis] = "OKS"
        return stats, names
