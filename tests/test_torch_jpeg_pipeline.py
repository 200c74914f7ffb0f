"""The port's JPEG path through its pipelines and entry points against the
JAX package's, on the CPU.

The data: ``chip_smoke.mini_coco_set``'s six images written as JPEG files by
``cv2.imencode`` (4:2:0 baseline, one progressive, one stored turned with an
EXIF orientation of 6, one grayscale), with its twelve persons. The JAX side
reads them with ``cv2.imread`` and crops with ``cv2.warpAffine``; the port
ships the files' bytes and decodes and warps them in
``PoseModel.device_preprocess_batch`` (the plain decoder on the CPU).

- a val batch of the flagship's val pipeline: crops within one grey level
  of the JAX pipeline's, each file decoded once;
- a train batch (the flagship's train pipeline: flips, half bodies,
  rotations) under per-sample seeds: the same draws, crops within one grey
  level, maps within 2e-5, the labels equal (the bars of
  ``tests/test_torch_train_pipeline.py``); vertical and diagonal flips,
  which the port folds into the warp, too;
- a ``CombinedDataset`` of the JPEG set and a PNG set: one batch mixing
  both forms, its crops in the samples' order;
- ``inference_topdown(model, path)`` on a golden JPEG against the JAX
  ``inference_topdown(path)`` (``tests/test_torch_e2e.py``'s bars);
- ``tools.serve`` in a thread: a POSTed JPEG answers ``inference_topdown``'s
  JSON, an EXIF-turned one that of the image ``cv2.imdecode`` gives, a body
  that is no image 400;
- (slow) the full-geometry val over the golden JPEGs against the committed
  JAX reference (``chip_smoke.run_val_jpeg``).
"""

import copy
import json
import struct
import threading
import urllib.error
import urllib.request

import cv2
import numpy as np
import pytest
import torch

from chip_smoke import (
    GOLDEN,
    GOLDEN_JPEG,
    TINY_CFG,
    TRAIN_PIPELINE,
    VAL_PIPELINE,
    full_fixture_state,
    mini_coco_set,
    run_val_jpeg,
)
from probpose_code_torch.apis import inference_topdown, init_model
from probpose_code_torch.datasets.loader import HOST_KEYS, collate_pose_samples
from probpose_code_torch.datasets.transforms.loading import LoadImage
from probpose_code_torch.datasets.transforms.topdown import TopdownAffine
from probpose_code_torch.models.builder import PoseModel
from probpose_code_torch.registry import DATASETS
from probpose_code_torch.tools import serve

SEED = 1000  # the seed before sample i is SEED + i
WEIGHTS = str(GOLDEN / "e2e_weights.pth")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tier-1 runs six test workers at once; one torch thread in this module."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def with_orientation(data: bytes, orientation: int) -> bytes:
    """``data`` with an APP1 Exif segment holding ``orientation`` after APP0."""
    tiff = b"MM\x00*" + struct.pack(">IH", 8, 1) + struct.pack(">HHIHH", 0x0112, 3, 1, orientation, 0)
    payload = b"Exif\x00\x00" + tiff + struct.pack(">I", 0)
    end = 4 + int.from_bytes(data[4:6], "big")
    return data[:end] + b"\xff\xe1" + struct.pack(">H", len(payload) + 2) + payload + data[end:]


@pytest.fixture(scope="module")
def sets(tmp_path_factory):
    """(JPEG annotation file, PNG annotation file) of the mini set."""
    png = mini_coco_set(tmp_path_factory.mktemp("mini_png"))
    root = tmp_path_factory.mktemp("mini_jpeg")
    (root / "imgs").mkdir()
    gt = json.loads(png.read_text())
    for im in gt["images"]:
        img = cv2.imread(str(png.parent / "imgs" / im["file_name"]), cv2.IMREAD_COLOR)
        params, orientation = [cv2.IMWRITE_JPEG_QUALITY, 95], 0
        if im["id"] == 2:
            params += [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]
        elif im["id"] == 3:  # stored turned: orientation 6 (transpose, then flip left-right) gives it back
            img, orientation = np.ascontiguousarray(np.flip(img, axis=1).transpose(1, 0, 2)), 6
        elif im["id"] == 4:
            img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
        data = cv2.imencode(".jpg", img, params)[1].tobytes()
        im["file_name"] = f"{im['id']}.jpg"
        (root / "imgs" / im["file_name"]).write_bytes(with_orientation(data, orientation) if orientation else data)
    (root / "ann.json").write_text(json.dumps(gt))
    return root / "ann.json", png


def dataset_cfg(ann, pipeline, test_mode):
    return dict(type="CocoDataset", data_root=str(ann.parent), ann_file=ann.name, data_prefix=dict(img="imgs/"),
                test_mode=test_mode, pipeline=pipeline)


def jax_build(cfg):
    import probpose_code_tpu.datasets  # noqa: F401  (registers)
    from probpose_code_tpu.registry import DATASETS as JAX_DATASETS

    return JAX_DATASETS.build(copy.deepcopy(cfg))


def seeded(ds, indices=None):
    out = []
    for i in indices if indices is not None else range(len(ds)):
        np.random.seed(SEED + i)
        out.append(ds[i])
    return out


def device_batch(batch):
    """The batch as ``Runner.to_device`` hands it to the model on the CPU."""
    out = {k: torch.from_numpy(v) for k, v in batch.items() if isinstance(v, np.ndarray)}
    out.update({k: batch[k] for k in HOST_KEYS if k in batch})
    return out


def crops_and_reference(samples, ref_samples):
    import probpose_code_tpu.datasets.loader as jax_loader

    batch = collate_pose_samples(samples)
    got = PoseModel(TINY_CFG["model"], device="cpu").device_preprocess_batch(device_batch(batch))
    want = jax_loader.collate_pose_samples(ref_samples)
    return batch, got, want


def assert_crops_within_one(got, want):
    assert got["inputs"].shape == want["inputs"].shape
    diff = np.abs(got["inputs"].numpy() - want["inputs"].astype(np.float32))
    assert diff.max() <= 1.0, diff.max()


def test_val_batch_equals_jax(sets):
    ann = sets[0]
    cfg = dataset_cfg(ann, VAL_PIPELINE, test_mode=True)
    ours, ref = DATASETS.build(cfg), jax_build(cfg)
    batch, got, want = crops_and_reference([ours[i] for i in range(len(ours))], [ref[i] for i in range(len(ref))])
    assert "canvas" not in batch and len(batch["jpeg_warp_mat"]) == 12
    assert len(batch["jpeg"]) == 6 and batch["jpeg_path"][0].endswith("1.jpg")  # each file once
    assert got["inputs"].shape == (12, 256, 192, 3)
    assert_crops_within_one(got, want)
    assert [s.metainfo["ori_shape"] for s in batch["data_samples"]] == \
        [s.metainfo["ori_shape"] for s in want["data_samples"]]


def test_train_batch_equals_jax(sets):
    cfg = dataset_cfg(sets[0], TRAIN_PIPELINE, test_mode=False)
    ours, ref = seeded(DATASETS.build(cfg)), seeded(jax_build(cfg))
    flips = [s["data_samples"].metainfo["flip"] for s in ref]
    assert any(flips) and not all(flips)
    assert [s["data_samples"].metainfo["flip"] for s in ours] == flips
    batch, got, want = crops_and_reference(ours, ref)
    assert_crops_within_one(got, want)
    np.testing.assert_allclose(got["heatmaps"].numpy(), want["heatmaps"], atol=2e-5)
    for key in ("keypoint_weights", "in_image", "annotated", "keypoints_visibility"):
        np.testing.assert_array_equal(batch[key], want[key], err_msg=key)


def test_vertical_and_diagonal_flips_fold_into_the_warp(sets):
    pipeline = copy.deepcopy(VAL_PIPELINE)
    pipeline.insert(2, dict(type="RandomFlip", direction=["vertical", "diagonal"], prob=[0.4, 0.4]))
    cfg = dataset_cfg(sets[0], pipeline, test_mode=True)
    ours, ref = seeded(DATASETS.build(cfg)), seeded(jax_build(cfg))
    directions = [s["data_samples"].metainfo["flip_direction"] for s in ref]
    assert {"vertical", "diagonal"} <= set(directions)
    assert [s["data_samples"].metainfo["flip_direction"] for s in ours] == directions
    _, got, want = crops_and_reference(ours, ref)
    assert_crops_within_one(got, want)


def test_mixed_jpeg_and_png_batch_keeps_the_order(sets):
    jpeg_ann, png_ann = sets
    sub = [dict(dataset_cfg(a, [], test_mode=True), pipeline=[]) for a in (jpeg_ann, png_ann)]
    cfg = dict(type="CombinedDataset", metainfo=dict(dataset_name="coco"), datasets=sub, pipeline=VAL_PIPELINE,
               test_mode=True)
    ours, ref = DATASETS.build(cfg), jax_build(cfg)
    indices = list(range(7, 17))  # five JPEG samples, then five PNG ones
    batch, got, want = crops_and_reference([ours[i] for i in indices], [ref[i] for i in indices])
    assert len(batch["canvas"]) == 5 and batch["jpeg_index"].tolist() == [0, 1, 2, 3, 4]
    assert_crops_within_one(got, want)
    assert [s.metainfo["id"] for s in batch["data_samples"]] == [s.metainfo["id"] for s in want["data_samples"]]


def test_unported_options_raise_and_lazy_is_accepted():
    LoadImage(lazy=True)  # the JAX key is taken: the port's JPEG path is always the deferred one
    with pytest.raises(NotImplementedError, match="item 3"):
        TopdownAffine(input_size=(192, 256), fast_decode=True)
    # the bbox mask is ported (on by default, as in the JAX transform)
    assert TopdownAffine(input_size=(192, 256)).with_bbox_mask is True
    with pytest.raises(NotImplementedError, match="pad_to_aspect_ratio"):
        LoadImage(pad_to_aspect_ratio=True)


def golden_boxes(image_id):
    gt = json.loads((GOLDEN / "e2e_coco.json").read_text())
    return np.array([[a["bbox"][0], a["bbox"][1], a["bbox"][0] + a["bbox"][2], a["bbox"][1] + a["bbox"][3]]
                     for a in gt["annotations"] if a["image_id"] == image_id], np.float32)


@pytest.fixture(scope="module")
def model():
    return init_model(TINY_CFG, checkpoint=WEIGHTS, device="cpu")


def test_inference_topdown_on_a_jpeg_path_equals_jax(model):
    from probpose_code_tpu.apis import inference_topdown as jax_inference_topdown
    from probpose_code_tpu.apis import init_model as jax_init_model

    path = str(GOLDEN_JPEG / "golden" / "7.jpg")
    boxes = golden_boxes(7)
    ours = inference_topdown(model, path, boxes)
    ref = jax_inference_topdown(jax_init_model(TINY_CFG, checkpoint=WEIGHTS), path, bboxes=boxes)
    assert len(ours) == len(ref) == len(boxes) and ours[0].metainfo["img_path"] == path
    err = np.linalg.norm(np.stack([s.pred_instances.keypoints for s in ours])
                         - np.stack([np.asarray(s.pred_instances.keypoints) for s in ref]), axis=-1)
    assert np.percentile(err, 99) < 1.0 and err.max() < 5.0, err.max()
    for field in ("keypoint_scores", "keypoints_probs", "keypoints_visible"):
        a = np.stack([s.pred_instances[field] for s in ours])
        b = np.stack([np.asarray(s.pred_instances[field]) for s in ref])
        np.testing.assert_allclose(a, b, atol=2e-3, err_msg=field)


def post(port, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/predict", data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"null")


def test_serve_answers_inference_topdown(model):
    server = serve.make_server(model, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        path = GOLDEN_JPEG / "golden" / "3.jpg"
        status, answer = post(server.server_port, path.read_bytes())
        assert status == 200 and answer == serve.payload(inference_topdown(model, str(path)))
        turned = (GOLDEN_JPEG / "formats" / "exif6.jpg").read_bytes()
        status, answer = post(server.server_port, turned)
        decoded = cv2.imdecode(np.frombuffer(turned, np.uint8), cv2.IMREAD_COLOR)  # turned, as cv2 5 does
        assert status == 200 and answer == serve.payload(inference_topdown(model, decoded))
        status, answer = post(server.server_port, b"not an image")
        assert status == 400 and "not a decodable image" in answer["error"]
    finally:
        server.shutdown()
        server.server_close()
        thread.join()


@pytest.mark.slow
def test_full_geometry_jpeg_val_against_the_jax_reference():
    report, _ = run_val_jpeg("cpu", full_fixture_state())
    assert report["ok"], report
