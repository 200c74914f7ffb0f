"""The port's top-down crop follows the config's ``TopdownAffine``.

The JAX package cuts each crop with the ``TopdownAffine`` of the config's
test pipeline (``probpose_code_tpu/apis/inference.py:115-127``,
``datasets/transforms/topdown.py:141-155``): the UDP warp matrix or the
standard one, and the transform's ``input_padding``. The port's
``get_warp_matrix`` equals the JAX one; a non-UDP config's crops equal the
crops of the JAX pipeline within one intensity unit, the bar of
``test_torch_decode.py:test_device_crop_matches_cv2_crop``; and the two
shipped configs still crop with UDP at padding 1.25.
"""

import numpy as np
import pytest

from chip_smoke import FLAGSHIP, TINY_CFG, VITPOSE
from probpose_code_torch.apis import crop_batch
from probpose_code_torch.apis.inference import topdown_affine
from probpose_code_torch.config import Config
from probpose_code_torch.structures.bbox import get_warp_matrix
from probpose_code_tpu.datasets import Compose
from probpose_code_tpu.structures.bbox import get_warp_matrix as jax_get_warp_matrix


def test_get_warp_matrix_matches_jax():
    rng = np.random.RandomState(3)
    for _ in range(20):
        center = rng.uniform(-50, 700, 2)
        scale = rng.uniform(5, 600, 2)
        rot = float(rng.choice([0.0, rng.uniform(-45, 45)]))
        size = (int(rng.randint(8, 400)), int(rng.randint(8, 400)))
        got = get_warp_matrix(center, scale, rot, output_size=size)
        want = jax_get_warp_matrix(center, scale, rot, output_size=size).astype(np.float32)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def config_with_affine(**affine):
    pipeline = [dict(type="LoadImage"), dict(type="GetBBoxCenterScale"),
                dict(type="TopdownAffine", input_size=(192, 256), **affine), dict(type="PackPoseInputs")]
    return dict(TINY_CFG, test_dataloader=dict(dataset=dict(type="CocoDataset", pipeline=pipeline)))


def test_non_udp_crop_matches_the_jax_pipeline():
    cfg = config_with_affine(use_udp=False, input_padding=1.0)
    assert topdown_affine(cfg) == (False, 1.0)
    rng = np.random.RandomState(9)
    img = (rng.rand(300, 400, 3) * 255).astype(np.uint8)
    boxes = np.array([[40.0, 30.0, 330.0, 280.0], [150.5, 20.25, 220.0, 290.0], [-20.0, 100.0, 90.0, 310.0]],
                     np.float32)
    pipe = Compose([t for t in cfg["test_dataloader"]["dataset"]["pipeline"] if t["type"] != "LoadImage"])
    want, metas = [], []
    for b in boxes:
        out = pipe(dict(img=img.copy(), img_shape=(300, 400), ori_shape=(300, 400), bbox=b[None],
                        bbox_score=np.ones(1, np.float32), id=0, img_id=0))
        want.append(np.asarray(out["inputs"], np.float32))
        metas.append(out["data_samples"].metainfo)
    crops, centers, scales = crop_batch(img, boxes, (192, 256), "cpu", cfg)
    assert np.abs(crops.numpy() - np.stack(want)).max() <= 1.0
    np.testing.assert_allclose(centers, np.stack([m["input_center"] for m in metas]).reshape(-1, 2), rtol=1e-6)
    np.testing.assert_allclose(scales, np.stack([m["input_scale"] for m in metas]).reshape(-1, 2), rtol=1e-6)
    # the UDP crop of the same boxes is another crop: the setting is read, not ignored
    udp, _, _ = crop_batch(img, boxes, (192, 256), "cpu", config_with_affine(use_udp=True, input_padding=1.0))
    assert np.abs(udp.numpy() - crops.numpy()).max() > 1.0


@pytest.mark.parametrize("config", [FLAGSHIP, VITPOSE])
def test_shipped_configs_crop_with_udp_and_padding_1_25(config):
    assert topdown_affine(Config.fromfile(config)) == (True, 1.25)


def test_defaults_of_the_transform_and_of_a_config_without_pipeline():
    assert topdown_affine(config_with_affine()) == (False, 1.25)
    assert topdown_affine(TINY_CFG) == (True, 1.25)
    assert topdown_affine(None) == (True, 1.25)
    cfg = config_with_affine()
    cfg["test_dataloader"]["dataset"]["pipeline"] = [dict(type="GetBBoxCenterScale")]
    with pytest.raises(ValueError, match="TopdownAffine"):
        topdown_affine(cfg)
