"""PoseTrack18Metric and its per-joint AP (the poseval protocol) on the CPU,
against the JAX package, and the PoseTrack18 recipes.

The frames are the golden fixture's 24 images as three videos in PoseTrack18's
layout (``chip_smoke.posetrack_set``): every other person with a
``bbox_head`` (the others fall back to the box), the last frame's persons
with no annotated keypoint. The predictions are the ground truth moved by
seeded noise, a stray pose in some frames, and poses on the frame without
ground truth (false positives all).

The JAX metric reads its ground-truth frames from ``coco.imgToAnns``, which
its COCO index does not have: it finds no ground truth and its table is NaN
(``test_jax_metric_finds_no_ground_truth``). The comparisons give the JAX
metric's index that name (``img_to_anns`` under ``imgToAnns``), which the
port's metric reads as ``img_to_anns``. Every stat name and value must
agree: the same NumPy arithmetic on both sides, exactly.
"""

import json

import numpy as np
import pytest
import torch

from chip_smoke import POSETRACK_VIDEOS, posetrack_set
from probpose_code_torch.apis import init_model
from probpose_code_torch.config import Config
from probpose_code_torch.datasets.metainfo import parse_pose_metainfo
from probpose_code_torch.evaluation.functional.poseval import evaluate_ap
from probpose_code_torch.evaluation.metrics.posetrack18_metric import PoseTrack18Metric
from probpose_code_torch.tools import test as test_cli
from probpose_code_tpu.datasets.metainfo import parse_pose_metainfo as jax_parse_pose_metainfo
from probpose_code_tpu.evaluation.functional.poseval import evaluate_ap as jax_evaluate_ap
from probpose_code_tpu.evaluation.metrics.wholebody_and_more import PoseTrack18Metric as JaxPoseTrack18Metric

TD = "configs/body_2d_keypoint/topdown_heatmap/posetrack18/"
CONFIGS = [TD + name for name in (
    "td-hm_hrnet-w32_8xb64-20e_posetrack18-256x192.py", "td-hm_hrnet-w32_8xb64-20e_posetrack18-384x288.py",
    "td-hm_hrnet-w48_8xb32-20e_posetrack18-192x256.py", "td-hm_hrnet-w48_8xb32-20e_posetrack18-288x384.py",
    "td-hm_hrnet-w48_8xb64-20e_posetrack18-256x192.py", "td-hm_hrnet-w48_8xb64-20e_posetrack18-384x288.py",
    "td-hm_res50_8xb64-20e_posetrack18-256x192.py")]
STATS = ["Head AP", "Shou AP", "Elb AP", "Wri AP", "Hip AP", "Knee AP", "Ankl AP", "AP"]


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    root = tmp_path_factory.mktemp("posetrack")
    options = posetrack_set(root)
    return root, json.loads((root / "annotations/posetrack18_val.json").read_text()), options


def predictions(gt, seed=0):
    """Samples in the metrics' input format: each person's keypoints moved
    by N(0, 4 px), keypoint scores in (0.3, 1), a stray pose in every third
    frame, and the persons of the frame without ground truth predicted as
    well."""
    rng = np.random.RandomState(seed)
    samples = []
    for i, a in enumerate(gt["annotations"]):
        kpts = np.asarray(a["keypoints"], np.float64).reshape(-1, 3)[:, :2]
        if not kpts.any():  # the frame without ground truth: a pose in its box
            x, y, w, h = a["bbox"]
            kpts = np.stack([rng.uniform(x, x + w, 17), rng.uniform(y, y + h, 17)], -1)
        kpts = kpts + rng.normal(0, 4, kpts.shape)
        samples.append(sample(i, a["image_id"], kpts, rng))
    for j, im in enumerate(gt["images"][::3]):
        samples.append(sample(1000 + j, im["id"], rng.uniform(0, 200, (17, 2)), rng))
    return samples


def sample(i, img_id, kpts, rng):
    return dict(id=i, img_id=img_id, category_id=1,
                pred_instances=dict(keypoints=kpts[None].astype(np.float32),
                                    keypoint_scores=rng.uniform(0.3, 1, (1, 17)).astype(np.float32)),
                gt_instances=dict(bbox_scores=np.ones(1, np.float32)))


def run(metric, samples, meta):
    """The metric's results; NumPy's global generator seeded first (CocoMetric's
    balanced visibility accuracy shuffles with it, in both packages)."""
    np.random.seed(0)
    metric.dataset_meta = meta
    metric.process(None, samples)
    return metric.evaluate()


def test_evaluate_ap_equals_jax(frames):
    """``evaluate_ap`` on the frames and the noisy poses: the Hungarian
    matching by PCKh-correct joints, the unmatched and the stray poses and
    the frame without ground truth as false positives, the ears left out of
    the total. The same stat names and values as the JAX function."""
    _, gt, _ = frames
    gt_frames = {}
    for a in gt["annotations"]:
        gt_frames.setdefault(a["image_id"], []).append(
            dict(keypoints=a["keypoints"], bbox_head=a.get("bbox_head"), bbox=a["bbox"]))
    pred_frames = {}
    for s in predictions(gt, seed=1):
        k = np.concatenate([s["pred_instances"]["keypoints"][0], s["pred_instances"]["keypoint_scores"][0][:, None]], 1)
        pred_frames.setdefault(s["img_id"], []).append(dict(keypoints=k.ravel().tolist()))
    got, want = evaluate_ap(gt_frames, pred_frames), jax_evaluate_ap(gt_frames, pred_frames)
    assert [k for k, _ in got] == [k for k, _ in want] == STATS
    np.testing.assert_array_equal([v for _, v in got], [v for _, v in want])
    assert all(0 < v < 100 for _, v in got)
    no_truth = {k: v for k, v in gt_frames.items() if not any(any(p["keypoints"]) for p in v)}
    assert len(no_truth) == 1  # a frame whose persons have no annotated keypoint: its predictions count as false


def test_posetrack_metric_equals_jax(frames, tmp_path):
    """The metric over the synthetic frames: its table (``coco/Head AP`` ...
    ``coco/AP``) and the COCO AP of the flat results (``coco/coco_AP`` ...)
    equal the JAX metric's (its index given the name it reads); the
    submission files are one a video and the flat ``all.keypoints.json``."""
    root, gt, _ = frames
    ann = str(root / "annotations/posetrack18_val.json")
    samples = predictions(gt)
    ours = PoseTrack18Metric(ann_file=ann, outfile_prefix=str(tmp_path / "sub"))
    got = run(ours, samples, parse_pose_metainfo(dict(dataset_name="posetrack18")))
    theirs = JaxPoseTrack18Metric(ann_file=ann)
    theirs.coco.imgToAnns = theirs.coco.img_to_anns
    want = run(theirs, samples, jax_parse_pose_metainfo(dict(dataset_name="posetrack18")))
    assert list(got) == list(want)
    assert [k for k in got if k[5:] in STATS] == [f"coco/{k}" for k in STATS] and "coco/coco_AP" in got
    np.testing.assert_array_equal(np.array(list(got.values())), np.array(list(want.values())))
    assert 0 < got["coco/AP"] < 100
    written = sorted(p.name for p in (tmp_path / "sub").iterdir())
    assert written == sorted([f"images_val_{v:06d}_mpii_test.json" for v in range(POSETRACK_VIDEOS)]
                             + ["all.keypoints.json"])


def test_jax_metric_finds_no_ground_truth(frames):
    """The JAX metric as it is: ``getattr(self.coco, "imgToAnns", {})``
    finds nothing, so every AP of its table is NaN (the COCO AP is not)."""
    root, gt, _ = frames
    theirs = JaxPoseTrack18Metric(ann_file=str(root / "annotations/posetrack18_val.json"))
    assert not hasattr(theirs.coco, "imgToAnns")
    want = run(theirs, predictions(gt), jax_parse_pose_metainfo(dict(dataset_name="posetrack18")))
    assert all(np.isnan(want[f"coco/{k}"]) for k in STATS)
    assert np.isfinite(want["coco/coco_AP"])


def test_tools_test_prints_the_posetrack_table(frames, capsys):
    """``python -m probpose_code_torch.tools.test`` on the ResNet-50
    PoseTrack18 recipe (narrowed) over the synthetic videos with the
    detections file: the table and the COCO AP printed, finite."""
    _, _, options = frames
    narrow = dict(type="ResNet", depth=18, stem_channels=16, base_channels=4, out_indices=(3,))
    test_cli.main([TD + "td-hm_res50_8xb64-20e_posetrack18-256x192.py", "--device", "cpu", "--cfg-options",
                   *options, f"model.backbone={narrow!r}", "model.head.in_channels=32",
                   "model.head.deconv_out_channels=(8,8,8)", "test_dataloader.num_workers=0"])
    lines = dict(line.split(": ", 1) for line in capsys.readouterr().out.splitlines() if line.startswith("coco/"))
    assert [k for k in lines if k[5:] in STATS] == [f"coco/{k}" for k in STATS]
    assert all(np.isfinite(float(lines[f"coco/{k}"])) for k in STATS + ["coco_AP"])


@pytest.mark.parametrize("config", CONFIGS, ids=lambda c: c.split("/")[-1].removesuffix(".py"))
def test_posetrack_config_builds(config):
    """Each PoseTrack18 recipe (the PoseWarper one, whose neck and video
    dataset are not ported, apart) builds through ``init_model`` at full
    width, and its evaluator is the port's ``PoseTrack18Metric``."""
    cfg = Config.fromfile(config)
    torch.manual_seed(0)
    model = init_model(cfg, device="cpu")
    assert model.head_type == "HeatmapHead" and model.metainfo["dataset_name"] == "posetrack18"
    assert cfg["test_evaluator"]["type"] == "PoseTrack18Metric"
    metric = PoseTrack18Metric(**{k: v for k, v in cfg["test_evaluator"].items() if k not in ("type", "ann_file")})
    assert metric.outfile_prefix is None
