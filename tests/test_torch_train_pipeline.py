"""The port's train pipeline and train loader against the JAX package's.

The data: ``chip_smoke.mini_coco_set``, six smooth PNG images with twelve
persons made from a seed; the pipeline is the flagship's
``train_pipeline`` (``chip_smoke.TRAIN_PIPELINE``). The JAX side runs it as
the config writes it: ``cv2.warpAffine`` on the host and the ProbMap codec's
host encode.

- Under the same seed before each sample, both pipelines draw the same
  augmentations: ``flip``, ``flip_direction``, ``bbox_center``,
  ``bbox_scale``, ``bbox_rotation`` and ``transformed_keypoints`` equal to
  1e-6 (both compute in the same float types; the bar leaves room for
  summation order only), the labels (``keypoint_weights``, ``in_image``,
  ``annotated``, ``keypoints_visibility``) exactly;
- the port's canvases warped by ``device_preprocess_batch`` are within one
  grey level of the JAX ``cv2.warpAffine`` crops, flipped and rotated
  samples among them, and its maps encoded from ``kpts_hm`` match the JAX
  host codec's to atol 2e-5 (the bars of
  ``tests/test_datasets/test_device_pipeline.py:68,79``);
- a rotated region larger than the 640 x 640 canvas is downscaled as the
  JAX canvas form does it;
- the shuffled train loader gives the JAX ``DataLoader``'s batches (order,
  canvases, keypoints and labels) at epochs 0 and 1, in this process and
  from two worker processes; ``GenerateTarget`` refuses a codec it cannot
  encode on the device.
"""

import copy

import numpy as np
import pytest
import torch

from chip_smoke import TINY_CFG, TRAIN_PIPELINE, mini_coco_set
from probpose_code_torch.datasets.loader import DataLoader, collate_pose_samples, stop_workers
from probpose_code_torch.datasets.transforms.common import GenerateTarget
from probpose_code_torch.datasets.transforms.topdown import TopdownAffine
from probpose_code_torch.models.builder import PoseModel
from probpose_code_torch.registry import DATASETS

SEED = 1000  # the seed before sample i is SEED + i


@pytest.fixture(scope="module")
def ann(tmp_path_factory):
    return mini_coco_set(tmp_path_factory.mktemp("mini"))


def dataset_cfg(ann, pipeline):
    return dict(type="CocoDataset", data_root=str(ann.parent), ann_file=ann.name, data_prefix=dict(img="imgs/"),
                test_mode=False, pipeline=pipeline)


def jax_build(cfg):
    import probpose_code_tpu.datasets  # noqa: F401  (registers)
    from probpose_code_tpu.registry import DATASETS as JAX_DATASETS

    return JAX_DATASETS.build(copy.deepcopy(cfg))


def seeded(ds):
    out = []
    for i in range(len(ds)):
        np.random.seed(SEED + i)
        out.append(ds[i])
    return out


@pytest.fixture(scope="module")
def unpacked(ann):
    """Both pipelines without PackPoseInputs: the transforms' results."""
    cfg = dataset_cfg(ann, TRAIN_PIPELINE[:-1])
    return seeded(DATASETS.build(cfg)), seeded(jax_build(cfg))


@pytest.fixture(scope="module")
def packed(ann):
    cfg = dataset_cfg(ann, TRAIN_PIPELINE)
    return seeded(DATASETS.build(cfg)), seeded(jax_build(cfg))


def test_augmentations_and_labels_equal_jax(unpacked):
    ours, ref = unpacked
    assert len(ours) == len(ref) == 12
    flips = [r["flip"] for r in ref]
    rotations = [float(r["bbox_rotation"][0]) for r in ref]
    assert any(flips) and not all(flips) and any(rotations) and not all(rotations)
    for a, b in zip(ours, ref):
        assert (a["flip"], a["flip_direction"]) == (b["flip"], b["flip_direction"])
        for key in ("bbox_center", "bbox_scale", "bbox_rotation", "transformed_keypoints", "input_center",
                    "input_scale", "bbox_xyxy_wrt_input", "keypoints", "heatmap_keypoints"):
            assert np.asarray(a[key]).dtype == np.asarray(b[key]).dtype, key
            np.testing.assert_allclose(a[key], b[key], rtol=1e-6, atol=1e-6, err_msg=key)
        for key in ("keypoint_weights", "in_image", "annotated", "keypoints_visibility", "keypoints_visible"):
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_crops_and_maps_equal_jax(packed):
    """The port's batch through ``device_preprocess_batch`` on the CPU
    against the JAX pipeline's cv2 crops and host-encoded maps; the labels
    stacked by both collates."""
    import probpose_code_tpu.datasets.loader as jax_loader

    ours, ref = packed
    batch = collate_pose_samples(ours)
    want = jax_loader.collate_pose_samples(ref)
    arrays = {k: torch.from_numpy(v) for k, v in batch.items() if isinstance(v, np.ndarray)}
    got = PoseModel(TINY_CFG["model"], device="cpu").device_preprocess_batch(arrays)
    assert got["inputs"].shape == want["inputs"].shape == (12, 256, 192, 3)
    diff = np.abs(got["inputs"].numpy() - want["inputs"].astype(np.float32))
    assert diff.max() <= 1.0, diff.max()
    np.testing.assert_allclose(got["heatmaps"].numpy(), want["heatmaps"], atol=2e-5)
    for key in ("keypoint_weights", "in_image", "annotated", "keypoints_visibility"):
        assert batch[key].dtype == np.float32
        np.testing.assert_array_equal(batch[key], want[key], err_msg=key)


def test_rotated_region_larger_than_canvas_gives_the_jax_canvas():
    from probpose_code_tpu.datasets.transforms.topdown import TopdownAffine as JaxTopdownAffine

    rng = np.random.RandomState(3)
    img = rng.randint(0, 256, (900, 1000, 3)).astype(np.uint8)
    results = dict(img=img, bbox_xyxy_wrt_input=np.array([[150.0, 200.0, 620.0, 700.0]], np.float32),
                   bbox_rotation=np.array([35.0], np.float32),
                   keypoints=rng.uniform(100, 800, (1, 17, 2)).astype(np.float32))
    kw = dict(input_size=(192, 256), use_udp=True)
    ours = TopdownAffine(**kw)(copy.deepcopy(results))
    ref = JaxTopdownAffine(device_warp=True, **kw)(copy.deepcopy(results))
    # the rotated crop's source region (about 930 x 900 pixels of the image)
    # is downscaled until its height fills the canvas
    assert ours["canvas"][-1].any() and not ours["canvas"][:, -1].any()
    assert np.abs(ours["canvas"].astype(int) - ref["canvas"]).max() <= 1
    np.testing.assert_allclose(ours["warp_mat"], ref["warp_mat"], rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(ours["transformed_keypoints"], ref["transformed_keypoints"], rtol=1e-6)


@pytest.mark.parametrize("num_workers", [0, 2])
def test_shuffled_loader_batches_equal_jax(ann, num_workers):
    """Batches of 5 over 12 instances (the last two dropped) at epochs 0 and
    1; the JAX side runs the device-deferred form of the pipeline, whose
    batches carry the port's arrays."""
    import probpose_code_tpu.datasets.loader as jax_loader

    jax_pipeline = copy.deepcopy(TRAIN_PIPELINE)
    jax_pipeline[5]["device_warp"] = True
    jax_pipeline[6]["device"] = True
    ours = DataLoader(DATASETS.build(dataset_cfg(ann, TRAIN_PIPELINE)), 5, shuffle=True, drop_last=True,
                      num_workers=num_workers, seed=3, persistent_workers=True)
    ref = jax_loader.DataLoader(jax_build(dataset_cfg(ann, jax_pipeline)), 5, shuffle=True, drop_last=True,
                                num_workers=0, seed=3)
    try:
        orders = []
        for epoch in (0, 1):
            ours.set_epoch(epoch)
            ref.set_epoch(epoch)
            got, want = list(ours), list(ref)
            assert len(ours) == len(got) == len(want) == 2
            for a, b in zip(got, want):
                b = {k.replace("_sep", ""): v for k, v in b.items()}
                ids = [s.metainfo["id"] for s in a["data_samples"]]
                assert ids == [s.metainfo["id"] for s in b["data_samples"]]
                orders.append(ids)
                assert set(a) == set(b) - {"bbox_mask"}
                for k in ("canvas", "warp_mat", "kpts_hm", "kpts_visible", "keypoint_weights", "in_image",
                          "annotated", "keypoints_visibility"):
                    assert a[k].dtype == b[k].dtype, k
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert orders[:2] != orders[2:]  # each epoch its own order
    finally:
        ours.close()
        stop_workers()


def test_generate_target_takes_only_device_codecs():
    with pytest.raises(NotImplementedError, match="MegviiHeatmap"):
        GenerateTarget(encoder=dict(type="MegviiHeatmap", input_size=(192, 256), heatmap_size=(48, 64),
                                    kernel_size=11))
    with pytest.raises(NotImplementedError, match="combined"):
        GenerateTarget(encoder=dict(type="UDPHeatmap", input_size=(192, 256), heatmap_size=(48, 64),
                                    heatmap_type="combined"))
