"""Checkpoint files as mmpose's runner writes them, through the port's loader.

A runner's ``.pth`` holds ``{"meta": {"dataset_meta": ..., ...},
"state_dict": ...}``, and its metainfo holds numpy arrays (``sigmas``,
``joint_weights``). The port's ``init_model`` must read such a file as the
JAX package's does (``probpose_code_tpu/apis/inference.py:77-104``): the
file's metainfo becomes the model's, and the golden crops predict within
the bars of ``test_torch_e2e.py`` (keypoints p99 < 1 px and max < 5 px, the
aux fields atol 2e-3) of the JAX package loading the same file. The JAX
converter indexes every key (``engine/checkpoint.py:108-117``), so the cases
with a key missing, keys that are not the model's, an unknown class or a
wrong shape run the port alone.
"""

import argparse
import json
import logging
import pickle

import numpy as np
import pytest
import torch

from chip_smoke import GOLDEN, TINY_CFG
from probpose_code_torch.apis import crop_batch, init_model
from probpose_code_torch.engine.checkpoint import load_checkpoint
from probpose_code_tpu.apis import init_model as jax_init_model
from probpose_code_tpu.datasets.metainfo import parse_pose_metainfo as jax_metainfo

HEAD_KEY = "head.final_layer.bias"


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
def weights():
    return torch.load(GOLDEN / "e2e_weights.pth", map_location="cpu", weights_only=True)


def runner_file(path, state_dict, **meta):
    """Write ``state_dict`` as mmpose's runner does, with the COCO metainfo
    (numpy sigmas, joint weights and colours) under ``meta.dataset_meta``."""
    meta = dict(dataset_meta=jax_metainfo({"dataset_name": "coco"}), epoch=210, iter=491400, seed=0, **meta)
    torch.save({"meta": meta, "state_dict": state_dict}, path)
    return str(path)


def golden_crops(n=4):
    """The first ``n`` annotated boxes of the golden fixture, cut by the port."""
    data = np.load(GOLDEN / "e2e_pipeline.npz")
    gt = json.loads((GOLDEN / "e2e_coco.json").read_text())
    image_id = gt["images"][0]["id"]
    boxes = np.array([[x, y, x + w, y + h] for x, y, w, h in
                      (a["bbox"] for a in gt["annotations"] if a["image_id"] == image_id)], np.float32)
    crops, _, _ = crop_batch(data[f"img_{image_id}"], boxes[:n], (192, 256), "cpu")
    return crops


def test_runner_checkpoint_loads_as_the_jax_package_loads_it(tmp_path, weights):
    path = runner_file(tmp_path / "epoch_210.pth", weights)
    model = init_model(TINY_CFG, checkpoint=path, device="cpu")
    jax_model = jax_init_model(TINY_CFG, checkpoint=path)
    assert isinstance(model.metainfo["sigmas"], np.ndarray)
    np.testing.assert_array_equal(model.metainfo["sigmas"], jax_model.metainfo["sigmas"])
    assert model.metainfo["flip_indices"] == jax_model.metainfo["flip_indices"]

    crops = golden_crops()
    got = {k: v.numpy() for k, v in model.predict(crops).items()}
    want = {k: np.asarray(v) for k, v in jax_model.make_predict(jit=False)(jax_model.variables, crops.numpy()).items()}
    err = np.linalg.norm(got["keypoints"] - want["keypoints"], axis=-1)
    assert np.percentile(err, 99) < 1.0 and err.max() < 5.0, err.max()
    for field in ("keypoints_probs", "keypoints_visible", "keypoints_oks", "keypoints_error", "keypoints_conf"):
        np.testing.assert_allclose(got[field], want[field], atol=2e-3, err_msg=field)


def test_missing_key_keeps_its_initial_value_and_is_reported(tmp_path, weights, caplog):
    path = runner_file(tmp_path / "partial.pth", {k: v for k, v in weights.items() if k != HEAD_KEY})
    with caplog.at_level(logging.WARNING, logger="probpose_code_torch.engine.checkpoint"):
        model = init_model(TINY_CFG, checkpoint=path, device="cpu")
    assert HEAD_KEY in caplog.text
    fresh = init_model(TINY_CFG, device="cpu")
    got, init = model.module.state_dict(), fresh.module.state_dict()
    assert torch.equal(got[HEAD_KEY], init[HEAD_KEY])
    assert all(torch.equal(got[k], v) for k, v in weights.items() if k != HEAD_KEY)
    assert load_checkpoint(fresh, path)["missing_keys"] == [HEAD_KEY]


def test_unknown_class_needs_trusted(tmp_path, weights):
    path = runner_file(tmp_path / "with_namespace.pth", weights, cfg=argparse.Namespace(lr=5e-4))
    with pytest.raises(pickle.UnpicklingError, match="trusted=True"):
        init_model(TINY_CFG, checkpoint=path, device="cpu")
    model = init_model(TINY_CFG, device="cpu")
    result = load_checkpoint(model, path, trusted=True)
    assert result["missing_keys"] == [] and result["meta"]["cfg"].lr == 5e-4
    assert torch.equal(model.module.state_dict()[HEAD_KEY], weights[HEAD_KEY])


def test_shape_mismatch_raises(tmp_path, weights):
    wrong = dict(weights)
    wrong[HEAD_KEY] = torch.zeros(wrong[HEAD_KEY].numel() + 1)
    with pytest.raises(RuntimeError, match="size mismatch"):
        init_model(TINY_CFG, checkpoint=runner_file(tmp_path / "wrong.pth", wrong), device="cpu")


@pytest.mark.parametrize("rename", [
    pytest.param(lambda k: f"module.{k}", id="ddp_prefix"),
    pytest.param(lambda k: f"other_model.{k.replace('.', '_')}", id="no_key_shared"),
])
def test_file_of_other_keys_raises(tmp_path, weights, rename):
    """A file whose keys are not the model's (a DDP ``module.`` prefix, or
    another model's names) is refused, not taken as a file that lacks keys."""
    path = runner_file(tmp_path / "renamed.pth", {rename(k): v for k, v in weights.items()})
    with pytest.raises(KeyError, match="does not hold this model's weights"):
        init_model(TINY_CFG, checkpoint=path, device="cpu")
