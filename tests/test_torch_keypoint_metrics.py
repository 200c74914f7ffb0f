"""The PCK / PCKh / AUC / EPE metrics and their functions against the JAX
package, on seeded samples: tolerance 1e-12 (the same float64 NumPy
arithmetic in both). The samples carry ``head_size`` as the JAX test
``tests/test_evaluation/test_mpii_pck.py`` gives it (the JAX ``MpiiDataset``
sets none), and a ``KeypointConverter``'s stacked ``keypoints_visible``
(N, K, 2) on some."""

import numpy as np
import pytest

from probpose_code_torch.evaluation.functional import keypoint_eval
from probpose_code_torch.registry import METRICS
from probpose_code_tpu.evaluation.functional import keypoint_eval as jax_keypoint_eval
from probpose_code_tpu.registry import METRICS as JAX_METRICS

METRIC_CFGS = {
    "pck_bbox": dict(type="PCKAccuracy", thr=0.1),
    "pck_all_norms": dict(type="PCKAccuracy", thr=0.2, norm_item=["bbox", "head", "torso"]),
    "mpii": dict(type="MpiiPCKAccuracy"),
    "mpii_other_count": dict(type="MpiiPCKAccuracy", thr=0.3),
    "jhmdb": dict(type="JhmdbPCKAccuracy", thr=0.2),
    "auc": dict(type="AUC"),
    "auc_short": dict(type="AUC", norm_factor=12, num_thrs=7),
    "epe": dict(type="EPE"),
}


def samples(seed, n=24, k=16):
    """``n`` dict samples of ``k`` keypoints (one person each, some with no
    annotated keypoint, every fourth with the stacked visibility)."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        gt = rng.uniform(0, 200, (1, k, 2))
        pred = gt + rng.randn(1, k, 2) * rng.uniform(0.5, 25)
        visible = (rng.rand(1, k) < 0.8).astype(np.float32) * (i % 7 != 3)
        if i % 4 == 0:
            visible = np.stack([visible, np.ones_like(visible)], -1)
        x, y = rng.uniform(0, 50, 2)
        out.append(dict(
            pred_instances=dict(keypoints=pred, keypoint_scores=rng.rand(1, k)),
            gt_instances=dict(keypoints=gt, keypoints_visible=visible,
                              bboxes=np.array([[x, y, x + rng.uniform(20, 150), y + rng.uniform(20, 150)]]),
                              head_size=np.array([rng.uniform(5, 40)]))))
    return out


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", list(METRIC_CFGS))
def test_metric_equals_jax(name, seed):
    cfg = METRIC_CFGS[name]
    k = 15 if name == "mpii_other_count" else 16
    data = samples(seed, k=k)
    ours, ref = METRICS.build(dict(cfg)), JAX_METRICS.build(dict(cfg))
    for lo in range(0, len(data), 8):
        ours.process(None, data[lo:lo + 8])
        ref.process(None, data[lo:lo + 8])
    got, want = ours.evaluate(len(data)), ref.evaluate(len(data))
    assert list(got) == list(want) and got
    prefix = {"PCKAccuracy": "pck", "MpiiPCKAccuracy": "mpii", "JhmdbPCKAccuracy": "jhmdb", "AUC": "auc",
              "EPE": "epe"}[cfg["type"]]
    assert all(key.startswith(prefix + "/") for key in got)
    for key in got:
        assert np.isfinite(got[key]), key
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-12, err_msg=key)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_functions_equal_jax(seed):
    rng = np.random.RandomState(seed)
    gt = rng.uniform(0, 100, (30, 17, 2))
    pred = gt + rng.randn(30, 17, 2) * 6
    mask = rng.rand(30, 17) < 0.7
    mask[3] = False
    norm = rng.uniform(5, 50, (30, 2))
    norm[5, 0] = 0  # a sample with a zero norm is masked out
    for thr in (0.05, 0.2, 0.5):
        acc, avg, cnt = keypoint_eval.keypoint_pck_accuracy(pred, gt, mask, thr, norm)
        want = jax_keypoint_eval.keypoint_pck_accuracy(pred, gt, mask, thr, norm)
        np.testing.assert_allclose(acc, want[0], rtol=0, atol=1e-12)
        assert abs(avg - want[1]) <= 1e-12 and cnt == want[2]
    for factor, n in ((30, 20), (8, 5)):
        assert abs(keypoint_eval.keypoint_auc(pred, gt, mask, factor, n)
                   - jax_keypoint_eval.keypoint_auc(pred, gt, mask, factor, n)) <= 1e-12
    assert abs(keypoint_eval.keypoint_epe(pred, gt, mask) - jax_keypoint_eval.keypoint_epe(pred, gt, mask)) <= 1e-12
    np.testing.assert_array_equal(keypoint_eval._calc_distances(pred, gt, mask, norm),
                                  jax_keypoint_eval._calc_distances(pred, gt, mask, norm))


def test_pck_refuses_an_unknown_norm_item():
    with pytest.raises(ValueError, match="norm_item 'elbow'"):
        METRICS.build(dict(type="PCKAccuracy", norm_item="elbow"))
