"""``NME`` and ``keypoint_nme`` against the JAX package on seeded samples
with noisy predictions: the whole result dict at 1e-12 (the same float64
NumPy arithmetic in both), under both ``norm_mode``s, for WFLW, 300W, COFW
and LaPa (the inter-ocular pair of ``DEFAULT_KEYPOINT_INDICES``, by the
metric's ``dataset_meta``) and AFLW (its configs' ``norm_item="bbox_size"``,
which no sample carries: the box's longer side). Then the configs'
``save_best="NME", rule="less"`` through the port's ``Runner``: the lowest
``nme/NME`` is the best."""

import types

import numpy as np
import pytest

from probpose_code_torch.datasets.metainfo import parse_pose_metainfo
from probpose_code_torch.engine.runner import Runner
from probpose_code_torch.evaluation.functional.keypoint_eval import keypoint_nme
from probpose_code_torch.registry import METRICS
from probpose_code_tpu.evaluation.functional.keypoint_eval import keypoint_nme as jax_keypoint_nme
from probpose_code_tpu.registry import METRICS as JAX_METRICS

FACES = {"wflw": 98, "300w": 68, "cofw": 29, "lapa": 106, "aflw": 19}
MODES = {
    "keypoint_distance": dict(type="NME", norm_mode="keypoint_distance"),
    "keypoint_indices": dict(type="NME", norm_mode="keypoint_distance", keypoint_indices=[3, 7]),
    "box_size": dict(type="NME", norm_mode="use_norm_item", norm_item="box_size"),
    "bbox_size": dict(type="NME", norm_mode="use_norm_item", norm_item="bbox_size"),
}


def samples(seed, k, n=20):
    """``n`` dict samples of ``k`` keypoints, one face each: predictions
    with noise of 0.5 to 8 px, some keypoints unannotated, every third
    sample with its own ``box_size``, every fifth without a box."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        x, y, s = rng.uniform(0, 100), rng.uniform(0, 100), rng.uniform(30, 120)
        gt = np.stack([x + rng.rand(1, k) * s, y + rng.rand(1, k) * s], -1)
        pred = gt + rng.randn(1, k, 2) * rng.uniform(0.5, 8)
        gt_inst = dict(keypoints=gt, keypoints_visible=(rng.rand(1, k) < 0.9).astype(np.float32))
        if i % 5:
            gt_inst["bboxes"] = np.array([[x, y, x + s * rng.uniform(0.8, 1.2), y + s]])
        if i % 3 == 0:
            gt_inst["box_size"] = np.array([s * rng.uniform(0.9, 1.1)])
        out.append(dict(pred_instances=dict(keypoints=pred, keypoint_scores=np.ones((1, k))), gt_instances=gt_inst))
    return out


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("face", list(FACES))
def test_nme_equals_jax(face, mode):
    data = samples(sum(map(ord, face + mode)), FACES[face])
    ours, ref = METRICS.build(dict(MODES[mode])), JAX_METRICS.build(dict(MODES[mode]))
    ours.dataset_meta = parse_pose_metainfo(dict(dataset_name=face))
    ref.dataset_meta = ours.dataset_meta
    for lo in range(0, len(data), 8):
        ours.process(None, data[lo:lo + 8])
        ref.process(None, data[lo:lo + 8])
    got, want = ours.evaluate(len(data)), ref.evaluate(len(data))
    assert list(got) == list(want) == ["nme/NME"]
    assert got["nme/NME"] == pytest.approx(want["nme/NME"], rel=1e-12, abs=1e-12)
    assert np.isfinite(got["nme/NME"]) and got["nme/NME"] > 0


def test_keypoint_nme_equals_jax():
    rng = np.random.RandomState(5)
    pred, gt = rng.uniform(0, 50, (12, 19, 2)), rng.uniform(0, 50, (12, 19, 2))
    mask = rng.rand(12, 19) < 0.8
    norm = rng.uniform(0, 40, (12, 2))
    norm[3] = 0  # a sample whose norm is 0 is left out
    assert keypoint_nme(pred, gt, mask, norm) == pytest.approx(jax_keypoint_nme(pred, gt, mask, norm), rel=1e-12)


def test_nme_refuses_another_mode():
    with pytest.raises(ValueError, match="norm_mode"):
        METRICS.build(dict(type="NME", norm_mode="inter_pupil"))


def test_save_best_nme_rule_less_keeps_the_lowest():
    """``Runner._maybe_save_best`` under the face configs' ``save_best="NME",
    rule="less"``: a lower ``nme/NME`` saves ``best.pth``, a higher one
    does not."""
    saved = []
    runner = types.SimpleNamespace(save_best="NME", save_best_rule="less", best_metric=np.inf, work_dir="work",
                                   log=lambda msg: None, save_checkpoint=saved.append)
    for value in (0.2, 0.3, 0.1, 0.15):
        Runner._maybe_save_best(runner, {"nme/NME": value, "pck/PCK": 1 - value})
    assert runner.best_metric == 0.1 and saved == ["work/best.pth"] * 2
