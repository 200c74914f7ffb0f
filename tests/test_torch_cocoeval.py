"""The port's COCOeval (Ex-OKS, match_by_bbox) and OKS NMS against the
reference's golden stats and the JAX package.

- ``tests/golden/cocoeval_{gt,dt}.json`` reproduce ``cocoeval_stats.npz`` for
  the four variants of ``tests/test_evaluation/test_cocoeval_golden.py``, to
  its tolerance (1e-6);
- on seeded random detections the stats, and the mean matched similarity,
  equal the JAX COCOeval's to 1e-12;
- ``oks_nms`` and ``soft_oks_nms`` keep the JAX functions' indices.
"""

import copy
import json
from pathlib import Path

import numpy as np
import pytest

from probpose_code_torch.datasets.coco_api import COCO
from probpose_code_torch.evaluation.cocoeval import COCOeval
from probpose_code_torch.evaluation.functional.nms import oks_nms, soft_oks_nms

GOLDEN = Path(__file__).parent / "golden"
VARIANTS = {
    "classic": dict(extended_oks=False, match_by_bbox=False),
    "extended": dict(extended_oks=True, match_by_bbox=False),
    "extended_bbox": dict(extended_oks=True, match_by_bbox=True),
    "classic_noarea": dict(extended_oks=False, match_by_bbox=False, use_area=False),
}


def run_eval(coco_cls, eval_cls, gt, dt, **kwargs):
    ev = eval_cls(coco_cls(dataset=copy.deepcopy(gt)), coco_cls(dataset=copy.deepcopy(dt)), iouType="keypoints",
                  **kwargs)
    ev.verbose = False
    ev.evaluate()
    ev.accumulate()
    ev.summarize()
    return ev


@pytest.fixture(scope="module")
def golden():
    gt = json.loads((GOLDEN / "cocoeval_gt.json").read_text())
    dt = json.loads((GOLDEN / "cocoeval_dt.json").read_text())
    return gt, dt, np.load(GOLDEN / "cocoeval_stats.npz", allow_pickle=True)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_stats_match_reference(golden, name):
    gt, dt, stats = golden
    ev = run_eval(COCO, COCOeval, gt, dt, **VARIANTS[name])
    assert ev.stats_names == [str(n) for n in stats[f"{name}_names"]]
    np.testing.assert_allclose(ev.stats, stats[f"{name}_stats"], atol=1e-6, err_msg=name)
    np.testing.assert_allclose(np.mean(ev.loc_similarities), stats[f"{name}_loc_sim"][0], atol=1e-6)


def random_detections(gt, seed):
    """Detections near each GT instance (noise, dropped and extra ones,
    confidences on both sides of the threshold), seeded."""
    rng = np.random.RandomState(seed)
    anns = []
    for ann in gt["annotations"]:
        for _ in range(rng.randint(0, 3)):
            kpts = np.array(ann["keypoints"], np.float64).reshape(-1, 3)
            kpts[:, :2] += rng.randn(len(kpts), 2) * rng.uniform(1, 30)
            kpts[:, 2] = rng.rand(len(kpts))
            x, y, w, h = ann["bbox"]
            bbox = [x + rng.randn() * 5, y + rng.randn() * 5, w * rng.uniform(0.8, 1.2), h * rng.uniform(0.8, 1.2)]
            anns.append(dict(id=len(anns) + 1, image_id=ann["image_id"], category_id=1, bbox=bbox,
                             area=float(bbox[2] * bbox[3]), keypoints=kpts.reshape(-1).tolist(), score=float(rng.rand())))
    return dict(images=gt["images"], categories=gt["categories"], annotations=anns)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", list(VARIANTS))
def test_stats_match_jax_on_random_detections(golden, name, seed):
    from probpose_code_tpu.datasets.coco_api import COCO as JaxCOCO
    from probpose_code_tpu.evaluation.cocoeval import COCOeval as JaxCOCOeval

    gt = golden[0]
    dt = random_detections(gt, seed)
    kwargs = dict(VARIANTS[name], confidence_thr=0.4)
    ours = run_eval(COCO, COCOeval, gt, dt, **kwargs)
    ref = run_eval(JaxCOCO, JaxCOCOeval, gt, dt, **kwargs)
    assert ours.stats_names == ref.stats_names
    np.testing.assert_allclose(ours.stats, ref.stats, rtol=0, atol=1e-12)
    np.testing.assert_allclose(ours.loc_similarities, ref.loc_similarities, rtol=0, atol=1e-12)


def kpts_db(seed, n=40):
    """Instances of one image in the CocoMetric's NMS form: overlapping
    groups of poses, (K, 3) keypoints with the probability in the v slot."""
    rng = np.random.RandomState(seed)
    poses = rng.uniform(50, 300, (5, 1, 2)) + rng.randn(5, 17, 2) * 30
    db = []
    for i in range(n):
        kpts = poses[i % 5] + rng.randn(17, 2) * rng.uniform(0.5, 8)
        db.append(dict(keypoints=np.concatenate([kpts, rng.rand(17, 1)], axis=1), score=float(rng.rand()),
                       area=float(rng.uniform(500, 8000))))
    return db


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_oks_nms_and_soft_oks_nms_keep_the_jax_indices(seed):
    from probpose_code_tpu.datasets.metainfo import parse_pose_metainfo
    from probpose_code_tpu.evaluation.functional import nms as jax_nms

    sigmas = parse_pose_metainfo({"dataset_name": "coco"})["sigmas"]
    db = kpts_db(seed)
    for thr in (0.5, 0.9):
        want = jax_nms.oks_nms(db, thr, sigmas=sigmas)
        got = oks_nms(db, thr, sigmas=sigmas)
        assert 0 < len(got) < len(db)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(soft_oks_nms(db, thr, sigmas=sigmas), jax_nms.soft_oks_nms(db, thr, sigmas=sigmas))
    np.testing.assert_array_equal(oks_nms(db, 0.9, vis_thr=0.3), jax_nms.oks_nms(db, 0.9, vis_thr=0.3))
