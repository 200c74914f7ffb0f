"""``KeypointConverter``, ``AicDataset`` and the combined dataset that mixes
AIC into COCO, against the JAX package.

- ``KeypointConverter`` gives the JAX class's output, key by key and
  exactly, on a 1-to-1 mapping (the AIC+COCO recipe's) and on a mapping with
  2-to-1 midpoints, with and without flip indices; it also maps
  ``keypoints_visibility``, which the JAX class leaves at the source's
  keypoint count (held against the mapping by hand);
- the AIC metainfo parses to the JAX package's ``aic.json`` table;
- ``CombinedDataset`` runs each sub-dataset's pipeline, then the shared
  metainfo keys, then the shared pipeline: the AIC+COCO recipe's train
  pipeline up to ``GenerateTarget`` (``use_dataset_keypoint_weights``) over
  ``chip_smoke.mini_coco_set`` and its AIC copy (``chip_smoke.
  aic_from_coco``) equals the JAX pieces composed in that order (the JAX
  sub-dataset's ``get_data_info``, the JAX ``KeypointConverter`` with the
  visibility flag mapped, the shared metainfo keys, the JAX pipeline) under
  the same seed: keypoints, visibility and the (17,) keypoint weights
  exactly, and so are the SimCC labels the port renders from the shipped
  bins; a sub-dataset without a pipeline gives its ``get_data_info``.
"""

import copy

import numpy as np
import pytest
import torch

from chip_smoke import AIC_TO_COCO, RTMPOSE, aic_from_coco, mini_coco_set
from probpose_code_torch.config import Config
from probpose_code_torch.datasets.loader import collate_pose_samples
from probpose_code_torch.datasets.metainfo import parse_pose_metainfo
from probpose_code_torch.datasets.transforms.converting import KeypointConverter
from probpose_code_torch.datasets.transforms.formatting import PackPoseInputs
from probpose_code_torch.models.builder import PoseModel
from probpose_code_torch.registry import DATASETS
from probpose_code_tpu.datasets.metainfo import parse_pose_metainfo as jax_parse_pose_metainfo
from probpose_code_tpu.datasets.transforms.converting import KeypointConverter as JaxKeypointConverter
from tests.test_torch_datasets import assert_same, jax_build

AIC_COCO = RTMPOSE.parent / "rtmpose-m_8xb256-420e_aic-coco-256x192.py"
RECIPE = Config.fromfile(str(AIC_COCO))
MIDPOINTS = [((0, 1), 0), (2, 1), ((3, 4), 2), (5, 4), ((6, 6), 3)]


def _plain(obj):
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    return obj


def _results(k, seed, visible_ndim=2):
    rng = np.random.RandomState(seed)
    visible = rng.choice([0.0, 1.0], (2, k), p=[0.3, 0.7])
    return dict(keypoints=rng.uniform(0, 200, (2, k, 2)).astype(np.float32),
                keypoints_visible=np.stack([visible, np.ones_like(visible)], -1) if visible_ndim == 3 else visible,
                keypoints_visibility=(visible * rng.randint(0, 2, (2, k))).astype(np.float32),
                flip_indices=list(rng.permutation(k)))


@pytest.mark.parametrize("mapping,num_keypoints,source", [(AIC_TO_COCO, 17, 14), (MIDPOINTS, 5, 7)],
                         ids=["one_to_one", "midpoints"])
@pytest.mark.parametrize("flip", [True, False])
@pytest.mark.parametrize("visible_ndim", [2, 3])
def test_keypoint_converter_equals_jax(mapping, num_keypoints, source, flip, visible_ndim):
    results = _results(source, seed=num_keypoints + visible_ndim, visible_ndim=visible_ndim)
    if not flip:
        del results["flip_indices"]
    ours = KeypointConverter(num_keypoints, mapping)(copy.deepcopy(results))
    ref = JaxKeypointConverter(num_keypoints, mapping)(copy.deepcopy(results))
    visibility = ours.pop("keypoints_visibility")
    ref.pop("keypoints_visibility")
    assert_same(ours, ref, "converted")
    assert ours["keypoints"].shape == (2, num_keypoints, 2) and ours["keypoints_visible"].shape == (2, num_keypoints, 2)
    # the flag the JAX class leaves alone, mapped as keypoints_visible is
    src = np.asarray([m[0] if isinstance(m[0], int) else m[0][0] for m in mapping])
    src2 = np.asarray([m[0] if isinstance(m[0], int) else m[0][1] for m in mapping])
    want = np.zeros((2, num_keypoints), np.float32)
    flag = results["keypoints_visibility"]
    want[:, [m[1] for m in mapping]] = flag[:, src] * flag[:, src2]
    assert visibility.dtype == np.float32
    np.testing.assert_array_equal(visibility, want)


def test_aic_metainfo_equals_jax():
    ours, ref = parse_pose_metainfo(dict(dataset_name="aic")), jax_parse_pose_metainfo(dict(dataset_name="aic"))
    assert_same(ours, ref, "aic")


@pytest.fixture(scope="module")
def mixed(tmp_path_factory):
    """The AIC+COCO recipe's train set over the mini COCO set and its AIC copy."""
    root = tmp_path_factory.mktemp("mix")
    ann = mini_coco_set(root)
    aic_from_coco(ann, root / "aic.json")
    cfg = _plain(dict(RECIPE["train_dataloader"]["dataset"]))
    for sub, name in zip(cfg["datasets"], ("ann.json", "aic.json")):
        sub.update(data_root=str(root), ann_file=name, data_prefix=dict(img="imgs/"))
    cfg["pipeline"] = cfg["pipeline"][:-1]  # up to GenerateTarget: the transforms' results
    return cfg


def _jax_composed(ds, idx):
    """The JAX pieces in mmpose's order: the sub-dataset's sample through its
    own pipeline (the JAX ``KeypointConverter``, with the visibility flag
    mapped as the port maps it), the shared metainfo keys, the shared
    pipeline."""
    ds_idx, j = ds._map_index(idx)
    sub = ds.datasets[ds_idx]
    info = sub.get_data_info(j)
    visibility = info["keypoints_visibility"]
    info = sub.pipeline(info)
    if info["keypoints"].shape[1] != visibility.shape[1]:
        mapped = np.zeros((1, 17), np.float32)
        mapped[:, [t for _, t in AIC_TO_COCO]] = visibility[:, [s for s, _ in AIC_TO_COCO]]
        info["keypoints_visibility"] = mapped
    for key in ("upper_body_ids", "lower_body_ids", "flip_pairs", "flip_indices", "dataset_keypoint_weights",
                "skeleton_links"):
        info[key] = ds.metainfo[key]
    return ds.pipeline(info)


def test_combined_dataset_runs_sub_pipelines_as_jax_composed(mixed):
    ours, ref = DATASETS.build(copy.deepcopy(mixed)), jax_build(mixed)
    assert len(ours) == len(ref) == 24
    samples, flips = [], 0
    for idx in range(len(ours)):
        np.random.seed(500 + idx)
        a = ours[idx]
        np.random.seed(500 + idx)
        b = _jax_composed(ref, idx)
        flips += bool(b["flip"])
        assert a["keypoints_visible"].shape == b["keypoints_visible"].shape == (1, 17)
        for key in ("keypoints", "transformed_keypoints", "keypoints_visible", "keypoints_visibility",
                    "keypoint_weights", "flip_indices"):
            np.testing.assert_array_equal(np.asarray(a[key]), np.asarray(b[key]), err_msg=f"{idx} {key}")
        if idx >= 12:  # AIC: the converter's weights (0 off the mapping) times COCO's joint weights
            assert a["keypoints_visible_weights"].shape == (1, 17)
            np.testing.assert_array_equal(a["keypoints_visible_weights"], b["keypoints_visible_weights"])
            assert not a["keypoint_weights"][0, :5].any()
        samples.append((a, b))
    assert 0 < flips < len(ours)
    # the SimCC labels the card renders from the shipped bins, against the JAX host encode
    batch = collate_pose_samples([PackPoseInputs()(copy.deepcopy(a)) for a, _ in samples])
    model = PoseModel(_plain(dict(RECIPE["model"])), device="cpu")
    labels = model.device_preprocess_batch({k: torch.from_numpy(v) for k, v in batch.items()
                                            if k in ("kpts_hm", "kpts_visible")})
    for key in ("keypoint_x_labels", "keypoint_y_labels"):
        want = np.stack([b[key][0] for _, b in samples])
        np.testing.assert_array_equal(labels[key].numpy(), want, err_msg=key)
    np.testing.assert_array_equal(batch["keypoint_weights"], np.stack([b["keypoint_weights"][0] for _, b in samples]))


def test_combined_dataset_without_sub_pipelines_gives_get_data_info(mixed):
    cfg = copy.deepcopy(mixed)
    cfg["datasets"] = [dict(cfg["datasets"][0], pipeline=[]), dict(cfg["datasets"][0], type="CocoCropDataset")]
    ours, ref = DATASETS.build(cfg), jax_build(cfg)
    for idx in (0, 13):
        assert_same(ours.get_data_info(idx), ref.get_data_info(idx), f"combined {idx}")
