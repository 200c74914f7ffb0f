"""COCO-WholeBody's evaluation on the CPU against the JAX package: COCOeval's
six part iouTypes and ``CocoWholeBodyMetric``.

Bars, with their reasons:
- COCOeval's ``keypoints_body`` / ``_foot`` / ``_face`` / ``_lefthand`` /
  ``_righthand`` / ``_wholebody`` to 1e-12, as the body iouType is held
  (``tests/test_torch_cocoeval.py``): the same float64 arithmetic. The sets
  have parts left unannotated (a level ignored per part), keypoints of
  v = 1 and 2, detections that carry their own ``<part>_score`` and ones
  that fall back to ``score``, and both ``use_area`` settings;
- ``CocoWholeBodyMetric``'s whole result dict to 1e-12, on the golden
  annotations in COCO-WholeBody's layout (``chip_smoke.
  wholebody_set_from_coco``) and 133-keypoint predictions with noise,
  under three scoring modes, with and without OKS NMS over the 133 sigmas
  (duplicates that NMS drops among the predictions).
"""

import copy
import json
from pathlib import Path

import numpy as np
import pytest

from chip_smoke import wholebody_set_from_coco
from probpose_code_torch.datasets.coco_api import COCO
from probpose_code_torch.datasets.metainfo import parse_pose_metainfo
from probpose_code_torch.evaluation import CocoWholeBodyMetric
from probpose_code_torch.evaluation.cocoeval import COCOeval, PART_IOU_TYPES, WHOLEBODY_PARTS
from probpose_code_torch.structures.data_sample import InstanceData, PoseDataSample

GOLDEN = Path(__file__).parent / "golden"
PART_SIZES = dict(zip(WHOLEBODY_PARTS, (17, 6, 68, 21, 21)))


def _wholebody_sets(seed):
    """Whole-body ground truth on 8 images (each of the four parts after the
    body unannotated with probability 0.25, visibilities 0 / 1 / 2) and
    detections near it, some with their own part scores, seeded."""
    rng = np.random.RandomState(seed)
    images, gts, dts = [], [], []
    for i in range(1, 9):
        images.append(dict(id=i, width=640, height=480))
        for _ in range(rng.randint(1, 4)):
            x, y, w, h = rng.uniform(10, 300), rng.uniform(10, 200), rng.uniform(60, 300), rng.uniform(80, 260)
            gt = dict(id=len(gts) + 1, image_id=i, category_id=1, bbox=[x, y, w, h], area=w * h * rng.uniform(0.4, 1),
                      iscrowd=0)
            det = dict(image_id=i, category_id=1, score=float(rng.rand()))
            for field, n in PART_SIZES.items():
                v = rng.choice([0, 1, 2], n, p=[0.15, 0.25, 0.6])
                if field != "keypoints" and rng.rand() < 0.25:
                    v[:] = 0
                kpts = np.stack([rng.uniform(x, x + w, n), rng.uniform(y, y + h, n), v], 1) * (v > 0)[:, None]
                gt[field] = kpts.reshape(-1).tolist()
                d = np.stack([rng.uniform(x, x + w, n), rng.uniform(y, y + h, n), rng.rand(n)], 1)
                near = kpts[:, :2] + rng.randn(n, 2) * rng.uniform(0.5, 15)
                d[:, :2] = np.where(rng.rand(n, 1) < 0.8, near, d[:, :2])
                det[field] = d.reshape(-1).tolist()
                if field != "keypoints" and rng.rand() < 0.5:
                    det[field.replace("_kpts", "_score")] = float(rng.rand())
            gt["num_keypoints"] = int(np.count_nonzero(np.array(gt["keypoints"])[2::3]))
            gts.append(gt)
            dts.append(det)
    cats = [dict(id=1, name="person")]
    return dict(images=images, annotations=gts, categories=cats), dts


@pytest.mark.parametrize("use_area", [False, True])
@pytest.mark.parametrize("iou_type", PART_IOU_TYPES)
def test_part_cocoeval_equals_jax(iou_type, use_area):
    from probpose_code_tpu.datasets.coco_api import COCO as JaxCOCO
    from probpose_code_tpu.evaluation.cocoeval import COCOeval as JaxCOCOeval

    gt, dts = _wholebody_sets(seed=3)
    sigmas = parse_pose_metainfo(dict(dataset_name="coco_wholebody"))["sigmas"]
    cuts = dict(zip(PART_IOU_TYPES, [(0, 17), (17, 23), (23, 91), (91, 112), (112, 133), (0, 133)]))
    lo, hi = cuts[iou_type]
    evals = []
    for coco_cls, eval_cls in ((COCO, COCOeval), (JaxCOCO, JaxCOCOeval)):
        coco = coco_cls(dataset=copy.deepcopy(gt))
        ev = eval_cls(coco, coco.loadRes(copy.deepcopy(dts)), iouType=iou_type, sigmas=sigmas[lo:hi],
                      use_area=use_area)
        ev.verbose = False
        ev.evaluate()
        ev.accumulate()
        ev.summarize()
        evals.append(ev)
    ours, ref = evals
    assert ours.stats_names == ref.stats_names and ours.gt_visibilities == ref.gt_visibilities == [1, 2]
    assert 0 < ours.stats[0] < 1
    np.testing.assert_allclose(ours.stats, ref.stats, rtol=0, atol=1e-12)
    np.testing.assert_allclose(ours.loc_similarities, ref.loc_similarities, rtol=0, atol=1e-12)
    # the part's own levels: a GT whose part is unannotated is ignored at level 0
    ignored = [g["ignore"][0] for gts in ours._gts.values() for g in gts]
    assert (0 < sum(ignored) < len(ignored)) == (iou_type not in ("keypoints_body", "keypoints_wholebody"))
    if iou_type not in ("keypoints_body", "keypoints_wholebody"):
        key = iou_type[len("keypoints_"):] + "_score"
        ranked = [d for dts_ in ours._dts.values() for d in dts_]
        assert any(d[key] != d["score"] for d in ranked) and any(d[key] == d["score"] for d in ranked)


def test_part_cocoeval_refuses_the_box_iou_types():
    gt, dts = _wholebody_sets(seed=0)
    coco = COCO(dataset=gt)
    for iou_type in ("bbox", "segm"):
        with pytest.raises(NotImplementedError, match="keypoint iouTypes only"):
            COCOeval(coco, coco.loadRes(copy.deepcopy(dts)), iouType=iou_type)


@pytest.fixture(scope="module")
def wholebody_gt(tmp_path_factory):
    path = tmp_path_factory.mktemp("wb") / "wholebody.json"
    wholebody_set_from_coco(GOLDEN / "e2e_coco.json", path)
    return path


def _samples(gt_file, sample_cls, instance_cls, seed):
    """133-keypoint predictions for every annotation of ``gt_file``: its
    keypoints with noise (unannotated ones anywhere in the box), keypoint
    scores, and a copy of every fifth one a fifth of a pixel away under a
    new id (which OKS NMS drops)."""
    gt = json.loads(Path(gt_file).read_text())
    rng = np.random.RandomState(seed)
    samples = []
    for ann in gt["annotations"]:
        full = np.concatenate([np.array(ann[f]).reshape(-1, 3) for f in WHOLEBODY_PARTS])
        x, y, w, h = ann["bbox"]
        xy = np.where(full[:, 2:] > 0, full[:, :2], [x, y] + rng.rand(133, 2) * [w, h])
        xy = xy + rng.randn(133, 2) * rng.uniform(0.5, 6)
        for copy_id in ([ann["id"], 10000 + ann["id"]] if ann["id"] % 5 == 0 else [ann["id"]]):
            xy = xy + rng.randn(133, 2) * 0.2
            s = sample_cls()
            s.set_metainfo(dict(id=copy_id, img_id=ann["image_id"], category_id=1))
            pred = instance_cls()
            pred.set_field(xy[None].astype(np.float32), "keypoints")
            pred.set_field(rng.uniform(0.05, 1.0, (1, 133)).astype(np.float32), "keypoint_scores")
            s.pred_instances = pred
            gti = instance_cls()
            gti.set_field(np.array([rng.uniform(0.5, 1.0)], np.float32), "bbox_scores")
            s.gt_instances = gti
            samples.append(s)
    return samples


CASES = {
    "bbox_no_nms": dict(score_mode="bbox", nms_mode="none"),
    "bbox_keypoint_oks_nms": dict(score_mode="bbox_keypoint", nms_mode="oks_nms"),
    "keypoint_oks_nms": dict(score_mode="keypoint", nms_mode="oks_nms", nms_thr=0.5),
}


@pytest.mark.parametrize("case", list(CASES))
def test_metric_equals_jax(case, wholebody_gt, tmp_path):
    import probpose_code_tpu.evaluation  # noqa: F401  (registers the JAX metric)
    from probpose_code_tpu.datasets.metainfo import parse_pose_metainfo as jax_metainfo
    from probpose_code_tpu.evaluation import CocoWholeBodyMetric as JaxCocoWholeBodyMetric
    from probpose_code_tpu.structures import InstanceData as JaxInstanceData
    from probpose_code_tpu.structures import PoseDataSample as JaxPoseDataSample

    results = []
    for cls, meta, sample_cls, instance_cls, extra in (
            (CocoWholeBodyMetric, parse_pose_metainfo, PoseDataSample, InstanceData, {}),
            (JaxCocoWholeBodyMetric, jax_metainfo, JaxPoseDataSample, JaxInstanceData,
             dict(outfile_prefix=str(tmp_path / "jax")))):
        metric = cls(ann_file=str(wholebody_gt), **CASES[case], **extra)
        metric.dataset_meta = meta(dict(dataset_name="coco_wholebody"))
        metric.process(None, _samples(wholebody_gt, sample_cls, instance_cls, seed=1))
        results.append(metric.evaluate(1))
    ours, ref = results
    assert list(ours) == list(ref)
    families = ("coco/body_AP", "coco/foot_AP", "coco/face_AP", "coco/lefthand_AP", "coco/righthand_AP", "coco/AP")
    assert set(families) <= set(ours) and all(0 < ours[k] < 1 for k in families)
    for k in ref:
        assert ours[k] == pytest.approx(ref[k], abs=1e-12, rel=0), k
    kept = json.loads((tmp_path / "jax.keypoints.json").read_text())
    assert len(kept) < 74 if "oks_nms" in case else len(kept) == 74
