"""The port's predict path end to end on the golden tiny ProbPose fixture.

``init_model(..., device="cpu")`` with ``tests/golden/e2e_weights.pth`` and
``inference_topdown`` over the 24 images of ``e2e_pipeline.npz``, held to the
bars of ``tests/test_apis/test_e2e_parity.py:121-158``: keypoint error
p99 < 1 px and max < 5 px against the reference decode, the aux fields
within atol 2e-3, and COCO AP and Ex-OKS AP within 0.01 of the reference,
scored with the port's own ``CocoMetric`` (``tests/test_torch_coco_metric.py``
holds it equal to the JAX package's). On the CPU every ViT layer goes
through K1's wrapper to its plain twin, and the decode through K2's.
"""

import numpy as np
import pytest
import torch

from chip_smoke import GOLDEN, TINY_CFG, golden_errors, golden_samples
from probpose_code_torch.apis import init_model


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tier-1 runs six test workers at once: torch's default of one thread per
    core in each of them oversubscribes the CPU, so this module runs torch on
    one thread and restores the setting after it."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def run():
    model = init_model(TINY_CFG, checkpoint=str(GOLDEN / "e2e_weights.pth"), device="cpu")
    return golden_samples(model)


def test_keypoints_and_aux_fields(run):
    err, aux = golden_errors(*run)
    assert np.percentile(err, 99) < 1.0, f"p99 keypoint error {np.percentile(err, 99):.3f}px"
    assert err.max() < 5.0, f"max keypoint error {err.max():.3f}px"
    for field, max_err in aux.items():
        assert max_err < 2e-3, field


def test_coco_ap(run):
    from probpose_code_torch.datasets.metainfo import parse_pose_metainfo
    from probpose_code_torch.evaluation import CocoMetric

    data, samples = run
    metric = CocoMetric(
        ann_file=str(GOLDEN / "e2e_coco.json"), extended=[False, True], match_by_bbox=[False, False],
        ignore_border_points=[False, False], padding=1.25, score_thresh_type="prob", keypoint_score_thr=0.45,
    )
    metric.dataset_meta = parse_pose_metainfo({"dataset_name": "coco"})
    metric.process(None, samples)
    results = metric.compute_metrics(metric.results)
    assert results["prob_thr"] == pytest.approx(float(data["prob_thr"]), abs=1e-6)
    assert abs(results["AP"] - data["stats"][0]) < 0.01, results["AP"]
    assert abs(results["Ex_AP"] - data["Ex_stats"][0]) < 0.01, results["Ex_AP"]


def test_sample_contract(run):
    s = run[1][0]
    for key in ("input_center", "input_scale", "input_size", "img_shape", "flip_indices"):
        assert key in s.metainfo
    inst = s.pred_instances
    assert inst.keypoints.shape == (1, 17, 2) and inst.keypoint_scores.shape == (1, 17)
    assert inst.bboxes.shape == (1, 4) and s.gt_instances.bbox_scores.shape == (1,)


def test_flagship_config_file_at_small_width():
    """The flagship config file through ``init_model`` (its mmpretrain type,
    patch_cfg, init_cfg, drop_path_rate, bf16 dtype strings, loss dicts and
    CombinedDataset metainfo), cut to width 64 and one layer so the CPU run
    stays small, then one bf16 predict with flip-TTA on two boxes."""
    from chip_smoke import FLAGSHIP
    from probpose_code_torch.apis import inference_topdown

    model = init_model(FLAGSHIP, device="cpu", cfg_options={
        "model.backbone.arch": dict(embed_dims=64, num_layers=1, num_heads=4, feedforward_channels=128),
        "model.head.in_channels": 64,
        "model.head.deconv_out_channels": (32, 32),
    })
    assert model.is_low_precision() and model.aux["test_cfg"]["flip_test"]
    assert model.module.backbone.dtype == torch.bfloat16 and model.input_size == (192, 256)
    img = (np.random.RandomState(0).rand(120, 160, 3) * 255).astype(np.uint8)
    samples = inference_topdown(model, img, np.array([[10, 10, 90, 110], [50, 5, 150, 115]], np.float32))
    assert len(samples) == 2
    for s in samples:
        assert s.pred_instances.keypoints.shape == (1, 17, 2)
        assert np.isfinite(s.pred_instances.keypoints).all()
        assert np.isfinite(s.pred_instances.keypoints_oks).all()
