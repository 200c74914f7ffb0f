"""The face and hand families on the CPU against the JAX package: the twelve
metainfo tables, the ten plain datasets and the three the port reads as
mmpose does (``CocoWholeBodyFaceDataset``, ``CocoWholeBodyHandDataset``,
``HalpeHandDataset``), the face6 and hand5 mixes and train pipelines at 106
and 21 keypoints, ``AdaptiveWingLoss``, the narrow RTMPose-m face,
HRNetV2-w18 (98 maps of 64 x 64, under ``KeypointMSELoss`` and
``AdaptiveWingLoss``) and MobileNetV2 hand models, the face fixtures, and
the entry points (``tools.test`` on the WFLW HRNetV2 recipe, a
``tools.train`` epoch of the face6 mix). No face or hand file is in the
repository: every set is the golden persons (or the mini COCO set's) in the
dataset's layout, ``chip_smoke.face_hand_sets_from_coco``.

Bars, with their reasons:
- metainfo and the plain datasets exactly: they are tables and copies. The
  ``pad_to_contain`` of a count whose (x, y, v) rows make an even length
  (WFLW, 300W, LaPa, COCO-WholeBody-Face) is the JAX function's on rows read
  as rows (``tests/test_torch_body8.py``'s handling): it reads them as
  (x, y) pairs (ROADMAP section 3);
- the three departed datasets: their JAX faults, each a test of its own,
  and the port's instances against the file they read, exactly;
- the pipelines over the golden JPEGs, one seed a sample: keypoints, weights
  (LaPa's joint weights through ``use_dataset_keypoint_weights``) and the
  SimCC labels exactly (``tests/test_torch_rtmpose_train.py``'s bars); the
  mixes' converters exactly;
- ``AdaptiveWingLoss`` and its gradient: rel 1e-5 (f32 pow and log1p in
  another order);
- the narrow models (weights through ``convert_torch_state_dict``; the head's
  ``conv_layers`` and MobileNetV2, which it does not name, by hand): the
  predict program's maps or SimCC vectors at 1e-5 of their range and its
  keypoints exactly, the first step's loss dict at rel 2e-5
  (``tests/test_torch_rtmpose.py`` and ``test_torch_classic_heatmap.py``'s
  bars). MobileNetV2 at 257 x 257: its stride-2 convolutions pad one pixel
  on each side (mmpose's), the JAX module's "SAME" pads an even side only
  after it, and the two agree where every strided side is odd; its own test
  shows both departures (the padding, and ``out_indices``);
- the face fixtures: ``chip_smoke.model_fixture_report`` (``UDP_BARS``, the
  NME in place of the AP);
- the entry points: ``nme/NME`` printed and finite; the face6 epoch's first
  loss dict equal to ``make_train_step``'s (both on the CPU: exactly) and
  its best checkpoint the epoch of the lowest NME.
"""

import copy
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import (
    FACE_FIXTURES,
    FACE_SETS,
    face_hand_options,
    face_hand_sets_from_coco,
    golden_jpeg_set,
    mini_coco_set,
    model_fixture_report,
)
from probpose_code_torch.config import Config, parse_cfg_option
from probpose_code_torch.datasets.base_dataset import FACE_HAND_DATASETS
from probpose_code_torch.datasets.loader import collate_pose_samples
from probpose_code_torch.datasets.metainfo import parse_pose_metainfo
from probpose_code_torch.datasets.transforms.common import GetBBoxCenterScale, RandomFlip
from probpose_code_torch.engine.checkpoint import read_checkpoint
from probpose_code_torch.engine.optim import build_optimizer
from probpose_code_torch.evaluation import PCKAccuracy
from probpose_code_torch.models.builder import PoseModel
from probpose_code_torch.parallel import create_train_state, make_train_step
from probpose_code_torch.registry import DATASETS, MODELS
from probpose_code_torch.tools import test as test_cli
from probpose_code_torch.tools import train as train_cli
from probpose_code_tpu.datasets.metainfo import parse_pose_metainfo as jax_parse_pose_metainfo
from probpose_code_tpu.datasets.transforms.common import GetBBoxCenterScale as JaxGetBBoxCenterScale
from probpose_code_tpu.datasets.transforms.common import RandomFlip as JaxRandomFlip
from probpose_code_tpu.datasets.transforms.converting import KeypointConverter as JaxKeypointConverter
from probpose_code_tpu.engine.checkpoint import _convert_head, convert_torch_state_dict
from probpose_code_tpu.engine.optim import build_optimizer as jax_build_optimizer
from probpose_code_tpu.models import PoseModel as JaxPoseModel
from probpose_code_tpu.parallel import create_train_state as jax_create_train_state
from probpose_code_tpu.parallel import make_train_step as jax_make_train_step
from probpose_code_tpu.registry import MODELS as JAX_MODELS
from tests.test_torch_body8 import _jax_pad_to_contain
from tests.test_torch_classic_heatmap import _crops, _smooth_crops, seeded_state_dict
from tests.test_torch_datasets import assert_same, jax_build
from tests.test_torch_rtmpose_train import _first_step_equals_make_train_step, _plain, _seeded, _tensors
from tests.test_torch_wholebody import HRNET_NARROW_EXTRA, _train_batches

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "golden"
FACE6 = ROOT / "configs/face_2d_keypoint/rtmpose/face6/rtmpose-m_8xb256-120e_face6-256x256.py"
HAND5 = ROOT / "configs/hand_2d_keypoint/rtmpose/hand5/rtmpose-m_8xb256-210e_hand5-256x256.py"
WFLW_HRNET = ROOT / "configs/face_2d_keypoint/topdown_heatmap/wflw/td-hm_hrnetv2-w18_8xb64-60e_wflw-256x256.py"
WFLW_AWING = ROOT / "configs/face_2d_keypoint/topdown_heatmap/wflw/td-hm_hrnetv2-w18_awing-8xb64-60e_wflw-256x256.py"
HAND_MBV2 = ROOT / ("configs/hand_2d_keypoint/topdown_heatmap/coco_wholebody_hand/"
                    "td-hm_mobilenetv2_8xb32-210e_coco-wholebody-hand-256x256.py")
TABLES = ["300w", "300wlp", "wflw", "cofw", "aflw", "lapa", "coco_wholebody_face", "onehand10k", "freihand2d",
          "rhd2d", "panoptic_hand2d", "coco_wholebody_hand"]
RTMPOSE_NARROW = ["model.backbone.widen_factor=0.125", "model.backbone.deepen_factor=0.167",
                  "model.head.in_channels=128", "model.head.gau_cfg.hidden_dims=32", "model.head.gau_cfg.s=16"]
# HRNet's narrow widths (8-64) with the four-branch output the neck concatenates (120 channels)
_HRNET_EXTRA = dict(HRNET_NARROW_EXTRA, stage4=dict(HRNET_NARROW_EXTRA["stage4"], multiscale_output=True))
HRNET_NARROW = [f"model.backbone.extra={_HRNET_EXTRA!r}", "model.head.in_channels=120",
                "model.head.conv_out_channels=(120,)"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tier-1 runs six test workers at once; one torch thread each."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def sets(tmp_path_factory):
    """The golden persons in every face and hand layout (no images)."""
    root = tmp_path_factory.mktemp("face_hand")
    face_hand_sets_from_coco(GOLDEN / "e2e_coco.json", root)
    return root


def _build(kind, root, build=DATASETS.build, **kw):
    return build(dict(type=kind, data_root=str(root), ann_file=f"{kind}.json", data_prefix=dict(img="imgs/"),
                      test_mode=True, **kw))


# -- metainfo and the plain datasets ------------------------------------------------


@pytest.mark.parametrize("name", TABLES)
def test_metainfo_equals_jax(name):
    ours, ref = parse_pose_metainfo(dict(dataset_name=name)), jax_parse_pose_metainfo(dict(dataset_name=name))
    assert_same(ours, ref, name)
    assert not ours["upper_body_ids"] and not ours["lower_body_ids"]


@pytest.mark.parametrize("kind", list(FACE_HAND_DATASETS))
def test_plain_dataset_equals_jax(kind, sets):
    """Each plain class on the golden persons in its layout: keypoints,
    visibility, bbox, area and ``pad_to_contain`` exactly, as every other
    field of the data list."""
    ours, ref = _build(kind, sets), _build(kind, sets, jax_build)
    num = parse_pose_metainfo(dict(dataset_name=FACE_HAND_DATASETS[kind]))["num_keypoints"]
    assert len(ours) == len(ref) == (62 if kind in FACE_SETS else 124)
    if (3 * num) % 2 == 0:
        for a, b in zip(ours.data_list, ref.data_list):
            assert len(b["pad_to_contain"]) == 3 * num // 2 and len(a["pad_to_contain"]) == num
            b["pad_to_contain"] = _jax_pad_to_contain(b)
    assert_same(ours.data_list, ref.data_list, kind)
    assert ours.data_list[0]["keypoints"].shape == (1, num, 2)


@pytest.mark.parametrize("kind", ["WFLWDataset", "Face300WDataset", "AFLWDataset"])
def test_face_boxes_are_the_files_bbox_not_center_and_scale(kind, sets):
    """The JAX parser (copied) takes each box from ``bbox``; mmpose's WFLW,
    300W and AFLW classes build it from ``center`` and ``scale`` x 200 (a
    square 1.25 times the face here), and AFLW's NME norm from
    ``box_size``, which neither reads."""
    ours = _build(kind, sets)
    anns = {a["id"]: a for a in json.loads((sets / f"{kind}.json").read_text())["annotations"]}
    for info in ours.data_list:
        a = anns[info["id"]]
        x, y, w, h = a["bbox"]
        np.testing.assert_allclose(info["bbox"][0], [x, y, x + w, y + h], rtol=1e-6)
        side = a["scale"] * 200
        mmpose_box = np.array([*np.subtract(a["center"], side / 2), *np.add(a["center"], side / 2)])
        assert np.abs(info["bbox"][0] - mmpose_box).max() > 0.1 * w
        assert "box_size" not in info and "bbox_size" not in info


def test_panoptic_sets_no_head_size(sets):
    """The JAX ``PanopticHand2DDataset`` (copied) sets no ``head_size`` from
    its file, so the configs' ``PCKAccuracy(norm_item="head")`` cannot run:
    it raises a ``KeyError`` on the port's samples."""
    info = _build("PanopticHand2DDataset", sets).data_list[0]
    assert "head_size" not in info and "head_size" in info["raw_ann_info"]
    metric = PCKAccuracy(thr=0.7, norm_item="head")
    sample = dict(pred_instances=dict(keypoints=info["keypoints"]),
                  gt_instances=dict(keypoints=info["keypoints"], keypoints_visible=info["keypoints_visible"]))
    with pytest.raises(KeyError):
        metric.process(None, [sample])


# -- the three datasets the port reads as mmpose does ----------------------------------


def _flip_jax(info):
    return JaxRandomFlip(prob=1.0)(JaxGetBBoxCenterScale()(dict(info, img=np.zeros((480, 640, 3), np.uint8),
                                                                img_shape=(480, 640))))


def _flip(info):
    return RandomFlip(prob=1.0)(GetBBoxCenterScale()(dict(info, img=np.zeros((480, 640, 3), np.uint8),
                                                          img_shape=(480, 640))))


def test_jax_coco_wholebody_face_reads_the_body_and_flip_fails(sets):
    """The JAX ``CocoWholeBodyFaceDataset`` (``datasets/zoo.py:44``) is the
    COCO parser under the 68-keypoint table: a person's 17 body keypoints
    in the person's box, and ``RandomFlip``'s 68 flip indices run past
    them."""
    ref = _build("CocoWholeBodyFaceDataset", sets, jax_build)
    info = ref.get_data_info(0)
    assert len(ref) == 62 and info["keypoints"].shape == (1, 17, 2) and len(info["flip_indices"]) == 68
    with pytest.raises(IndexError):
        _flip_jax(info)


def test_coco_wholebody_face_reads_the_face(sets):
    """mmpose's reading: ``face_kpts`` in ``face_box`` (clipped to the image),
    none where ``face_valid`` is false; the flip runs on 68 rows."""
    ours = _build("CocoWholeBodyFaceDataset", sets)
    gt = json.loads((sets / "CocoWholeBodyFaceDataset.json").read_text())
    images = {im["id"]: im for im in gt["images"]}
    valid = [a for a in gt["annotations"] if a["face_valid"] and max(a["face_kpts"]) > 0]
    assert 0 < len(ours) == len(valid) < 62
    for info, a in zip(ours.data_list, valid):
        kpts = np.array(a["face_kpts"], np.float32).reshape(1, 68, 3)
        np.testing.assert_array_equal(info["keypoints"], kpts[..., :2])
        np.testing.assert_array_equal(info["keypoints_visible"], np.minimum(1, kpts[..., 2]))
        x, y, w, h = a["face_box"]
        im = images[a["image_id"]]
        box = np.clip([x, y, x + w, y + h], 0, [im["width"] - 1, im["height"] - 1] * 2)
        np.testing.assert_array_equal(info["bbox"][0], box.astype(np.float32))
        assert info["id"] == a["id"] and info["pad_to_contain"].shape == (68,)
    assert _flip(ours.get_data_info(0))["keypoints"].shape == (1, 68, 2)


def test_jax_coco_wholebody_hand_reads_the_body_once_a_person(sets):
    """The JAX ``CocoWholeBodyHandDataset`` (``datasets/zoo.py:50``) is the
    COCO parser under the 21-keypoint table: one instance a person, its 17
    body keypoints in the person's box, not one a hand."""
    ref = _build("CocoWholeBodyHandDataset", sets, jax_build)
    info = ref.get_data_info(0)
    assert len(ref) == 62 and info["keypoints"].shape == (1, 17, 2) and len(info["flip_indices"]) == 21


def test_coco_wholebody_hand_reads_each_hand(sets):
    """mmpose's reading: an instance for each valid hand, left then right,
    from ``<side>hand_kpts`` in ``<side>hand_box`` (not clipped), its id a
    running count."""
    ours = _build("CocoWholeBodyHandDataset", sets)
    gt = json.loads((sets / "CocoWholeBodyHandDataset.json").read_text())
    hands = [(a, side) for a in gt["annotations"] for side in ("left", "right")
             if a[f"{side}hand_valid"] and max(a[f"{side}hand_kpts"]) > 0]
    assert 62 < len(ours) == len(hands) < 124
    for n, (info, (a, side)) in enumerate(zip(ours.data_list, hands)):
        kpts = np.array(a[f"{side}hand_kpts"], np.float32).reshape(1, 21, 3)
        np.testing.assert_array_equal(info["keypoints"], kpts[..., :2])
        x, y, w, h = a[f"{side}hand_box"]
        np.testing.assert_array_equal(info["bbox"][0], np.array([x, y, x + w, y + h], np.float32))
        assert info["id"] == n and info["img_id"] == a["image_id"]


def test_jax_halpe_hand_reads_136_rows_against_21(sets):
    """The JAX ``HalpeHandDataset`` (``datasets/zoo.py:52``) is the COCO
    parser under the 21-keypoint table: all 136 of Halpe's rows, one
    instance a person, and ``RandomFlip``'s 21 flip indices keep 21 of
    them."""
    ref = _build("HalpeHandDataset", sets, jax_build)
    info = ref.get_data_info(0)
    assert len(ref) == 62 and info["keypoints"].shape == (1, 136, 2) and len(info["flip_indices"]) == 21
    assert _flip_jax(info)["keypoints"].shape == (1, 21, 2)


def test_halpe_hand_reads_each_hand(sets):
    """The port's reading: rows 94-114 the left hand, 115-135 the right, an
    instance for each hand with an annotated keypoint, its box the least
    one around those keypoints, its id a running count."""
    ours = _build("HalpeHandDataset", sets)
    gt = json.loads((sets / "HalpeHandDataset.json").read_text())
    hands = []
    for a in gt["annotations"]:
        rows = np.array(a["keypoints"], np.float32).reshape(136, 3)
        hands += [rows[first:first + 21] for first in (94, 115) if (rows[first:first + 21, 2] > 0).any()]
    assert len(ours) == len(hands) == 124
    for n, (info, kpts) in enumerate(zip(ours.data_list, hands)):
        np.testing.assert_array_equal(info["keypoints"][0], kpts[:, :2])
        xy = kpts[kpts[:, 2] > 0, :2]
        np.testing.assert_array_equal(info["bbox"][0], np.concatenate([xy.min(0), xy.max(0)]))
        assert info["id"] == n


# -- the mixes and the train pipelines -----------------------------------------------


def _mix_subs():
    return [(name, i) for name, config in (("face6", FACE6), ("hand5", HAND5))
            for i in range(len(Config.fromfile(str(config))["train_dataloader"]["dataset"]["datasets"]))]


@pytest.mark.parametrize("recipe,index", _mix_subs())
def test_mix_sub_dataset_equals_jax(recipe, index, sets):
    """A sub-dataset of the face6 or hand5 mix through the port's
    ``CombinedDataset`` (LaPa's or COCO-WholeBody-Hand's 106 or 21
    keypoints) against the JAX dataset with the JAX ``KeypointConverter``
    applied by hand (the JAX ``CombinedDataset`` skips the sub-pipelines):
    keypoints, visibility and the mix's flip indices exactly. The three
    departed classes against the JAX converter on the port's own data list."""
    cfg = Config.fromfile(str(FACE6 if recipe == "face6" else HAND5))
    sub = _plain(dict(cfg["train_dataloader"]["dataset"]["datasets"][index]))
    sub.update(data_root=str(sets), ann_file=f"{sub['type']}.json", data_prefix=dict(img="imgs/"))
    combined = _plain(dict(cfg["train_dataloader"]["dataset"]))
    combined.update(datasets=[sub], pipeline=[])
    ours = DATASETS.build(combined)
    departed = sub["type"] in ("CocoWholeBodyFaceDataset", "CocoWholeBodyHandDataset", "HalpeHandDataset")
    ref = DATASETS.build(dict(sub, pipeline=[])) if departed else jax_build(dict(sub, pipeline=[]))
    converter = [t for t in sub["pipeline"] if t["type"] == "KeypointConverter"]
    num = parse_pose_metainfo(combined["metainfo"])["num_keypoints"]
    assert len(ours) == len(ref) > 40 and num == (106 if recipe == "face6" else 21)
    for idx in range(0, len(ours), 7):
        info = ref.get_data_info(idx)
        if converter:
            info = JaxKeypointConverter(**{k: v for k, v in converter[0].items() if k != "type"})(info)
        got = ours[idx]
        assert got["keypoints"].shape == (1, num, 2)
        for key in ("keypoints", "keypoints_visible"):
            np.testing.assert_array_equal(got[key], info[key], err_msg=f"{recipe} {sub['type']} {idx} {key}")
        assert got["flip_indices"] == ours.metainfo["flip_indices"]


@pytest.fixture(scope="module")
def golden_faces(tmp_path_factory):
    """The golden JPEGs with their persons' faces in LaPa's layout and hands
    in OneHand10K's."""
    root = tmp_path_factory.mktemp("golden_faces")
    _, ann = golden_jpeg_set(root)
    face_hand_sets_from_coco(ann, root, ["LapaDataset", "OneHand10KDataset"])
    return root


@pytest.mark.parametrize("recipe,kind,num", [("face6", "LapaDataset", 106), ("hand5", "OneHand10KDataset", 21)])
def test_recipe_pipeline_equals_jax(recipe, kind, num, golden_faces):
    """12 instances of the golden JPEGs through the recipe's train pipeline
    in both packages, one seed a sample (``RandomHalfBody`` with no upper or
    lower ids, ``GenerateTarget`` with the dataset's joint weights), then
    the SimCC labels made on the device against the JAX pipeline's."""
    config = Config.fromfile(str(FACE6 if recipe == "face6" else HAND5))
    pipeline = config["train_pipeline"]

    def cfg(steps):
        return dict(type=kind, data_root=str(golden_faces), ann_file=f"{kind}.json", data_prefix=dict(img="imgs/"),
                    test_mode=False, pipeline=_plain(steps))

    n = 12
    packed = _seeded(DATASETS.build(cfg(pipeline)), n)
    unpacked = _seeded(DATASETS.build(cfg(pipeline[:-1])), n)
    ref = _seeded(jax_build(cfg(pipeline[:-1])), n)
    meta = parse_pose_metainfo(dict(dataset_name=FACE_HAND_DATASETS[kind]))
    for a, b in zip(unpacked, ref):
        assert a["transformed_keypoints"].shape == (1, num, 2)
        for key in ("transformed_keypoints", "keypoint_weights", "keypoints_visible", "bbox_scale"):
            np.testing.assert_array_equal(np.asarray(a[key]), np.asarray(b[key]), err_msg=key)
        assert set(np.unique(b["keypoint_weights"])) <= {0.0, *meta["dataset_keypoint_weights"]}
    _, model_cfg = _narrow(FACE6 if recipe == "face6" else HAND5, RTMPOSE_NARROW)
    model = PoseModel(model_cfg, metainfo=meta, device="cpu")
    collated = collate_pose_samples(packed)
    batch = _tensors({k: v for k, v in collated.items() if isinstance(v, np.ndarray)})
    batch.update({k: v for k, v in collated.items() if k.startswith("jpeg") and k not in batch})
    got = model.device_preprocess_batch(dict(batch))
    np.testing.assert_array_equal(got["keypoint_weights"].numpy(), np.stack([r["keypoint_weights"][0] for r in ref]))
    for key in ("keypoint_x_labels", "keypoint_y_labels"):
        assert got[key].shape == (n, num, 512)
        np.testing.assert_array_equal(got[key].numpy(), np.stack([r[key][0] for r in ref]), err_msg=key)


# -- AdaptiveWingLoss -------------------------------------------------------------


def test_adaptive_wing_loss_and_gradient_equal_jax():
    rng = np.random.RandomState(6)
    target = np.exp(-rng.rand(3, 5, 16, 16) * 8).astype(np.float32)
    output = (target + rng.randn(3, 5, 16, 16) * rng.choice([0.05, 0.6], (3, 5, 16, 16))).astype(np.float32)
    weights = (rng.rand(3, 5) > 0.3).astype(np.float32)
    cfg = dict(type="AdaptiveWingLoss", use_target_weight=True)
    theirs = JAX_MODELS.build(dict(cfg))
    want, want_grad = jax.value_and_grad(lambda o: theirs(o, jnp.asarray(target), jnp.asarray(weights)))(
        jnp.asarray(output))
    o = torch.from_numpy(output).requires_grad_()
    got = MODELS.build(dict(cfg))(o, torch.from_numpy(target), torch.from_numpy(weights))
    got.backward()
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-5)
    np.testing.assert_allclose(o.grad.numpy(), np.asarray(want_grad), rtol=1e-5, atol=1e-8)


# -- the narrow models --------------------------------------------------------------


def _narrow(config, options):
    cfg = Config.fromfile(str(config))
    cfg.merge_from_dict(dict(parse_cfg_option(o) for o in options))
    return cfg, _plain(dict(cfg["model"]))


def _jax_variables(sd):
    """The JAX variables of a port state dict: ``convert_torch_state_dict``,
    with the head's ``conv_layers`` (which it does not name) by hand, or a
    MobileNetV2 backbone (which it does not know) and its head."""
    arrays = {k: v.numpy().copy() for k, v in sd.items() if not k.endswith("num_batches_tracked")}

    def conv(w):
        return np.transpose(w, (2, 3, 1, 0))

    if "backbone.conv1.conv.weight" in arrays:  # MobileNetV2
        params, stats = {}, {}

        def put(name, bn_name, prefix):
            params[name[0]] = params.get(name[0], {})
            node_p, node_s = params, stats
            for part in name[:-1]:
                node_p = node_p.setdefault(part, {})
                node_s = node_s.setdefault(part, {})
            node_p[name[-1]] = {"kernel": conv(arrays[f"{prefix}.conv.weight"])}
            node_p[bn_name] = {"scale": arrays[f"{prefix}.bn.weight"], "bias": arrays[f"{prefix}.bn.bias"]}
            node_s[bn_name] = {"mean": arrays[f"{prefix}.bn.running_mean"], "var": arrays[f"{prefix}.bn.running_var"]}

        put(["conv1"], "bn1", "backbone.conv1")
        put(["conv2"], "bn2", "backbone.conv2")
        for key in arrays:
            parts = key.split(".")
            if parts[1].startswith("layer") and parts[3] == "conv" and key.endswith(".conv.weight"):
                s, b, j = int(parts[1][5:]), int(parts[2]), int(parts[4])
                n = sum(k.startswith(f"backbone.layer{s}.{b}.conv.") and k.endswith(".conv.weight") for k in arrays)
                name = (("expand", "depthwise", "project") if n == 3 else ("depthwise", "project"))[j]
                put([f"layer{s}_block{b}", f"{name}_conv"], f"{name}_bn", f"backbone.layer{s}.{b}.conv.{j}")
        head_p, head_s = _convert_head(arrays)
        return {"params": {"backbone": params, "head": head_p}, "batch_stats": {"backbone": stats, "head": head_s}}
    variables = convert_torch_state_dict(arrays)
    i = 0
    while f"head.conv_layers.{3 * i}.weight" in arrays:
        c, bn = f"head.conv_layers.{3 * i}", f"head.conv_layers.{3 * i + 1}"
        layers = variables["params"]["head"].setdefault("conv_layers", {})
        layers[f"conv{i}"] = {"kernel": conv(arrays[f"{c}.weight"]), "bias": arrays[f"{c}.bias"]}
        layers[f"bn{i}"] = {"scale": arrays[f"{bn}.weight"], "bias": arrays[f"{bn}.bias"]}
        variables["batch_stats"]["head"].setdefault("conv_layers", {})[f"bn{i}"] = {
            "mean": arrays[f"{bn}.running_mean"], "var": arrays[f"{bn}.running_var"]}
        i += 1
    return variables


# the MobileNetV2 hand model narrowed, at 257 x 257 (odd at every stride-2 convolution), its JAX twin's
# ``out_indices=(8,)`` the port's 7 (the last 1x1 conv)
MBV2_NARROW = ["model.backbone.widen_factor=0.25", "model.head.deconv_out_channels=(8, 8, 8)",
               "model.head.decoder.input_size=(257, 257)", "model.head.decoder.heatmap_size=(72, 72)",
               "codec.input_size=(257, 257)", "codec.heatmap_size=(72, 72)"]
NARROW_MODELS = {
    "rtmpose_face6": (FACE6, RTMPOSE_NARROW, "lapa", 106),
    "hrnetv2_wflw_mse": (WFLW_HRNET, HRNET_NARROW, "wflw", 98),
    "hrnetv2_wflw_awing": (WFLW_AWING, HRNET_NARROW, "wflw", 98),
    "mobilenetv2_hand": (HAND_MBV2, MBV2_NARROW, "coco_wholebody_hand", 21),
}


@pytest.mark.parametrize("name", list(NARROW_MODELS))
def test_narrow_model_loss_and_predict_match_jax(name):
    """The recipe's model narrowed, one state dict for both packages: the
    predict program on two crops, then the first step of each package's
    train step under the recipe's optimizer (targets from each package's
    ``GenerateTarget``)."""
    config, options, dataset, K = NARROW_MODELS[name]
    recipe, cfg = _narrow(config, options)
    size = tuple(cfg["head"]["decoder"]["input_size"])
    jax_cfg = copy.deepcopy(cfg)
    if cfg["backbone"]["type"] == "MobileNetV2":
        jax_cfg["backbone"]["out_indices"] = (8,)
    sd = seeded_state_dict(cfg, seed=51)
    ours = PoseModel(cfg, metainfo=parse_pose_metainfo(dict(dataset_name=dataset)), device="cpu")
    ours.module.load_state_dict(sd, strict=True)
    jm = JaxPoseModel(jax_cfg, metainfo=jax_parse_pose_metainfo(dict(dataset_name=dataset)))
    variables = _jax_variables(sd)
    crops = _crops(2, seed=52, size=size[::-1])
    want = {k: np.asarray(v) for k, v in jm.make_predict(jit=False)(variables, crops).items()}
    got = ours.predict(torch.from_numpy(crops))
    outputs = ("keypoint_x_labels", "keypoint_y_labels") if "keypoint_x_labels" in want else ("heatmaps",)
    for key in outputs:
        assert got[key].shape[:2] == (2, K)
        assert np.abs(got[key].numpy() - want[key]).max() < 1e-5 * np.abs(want[key]).max(), key
    np.testing.assert_array_equal(got["keypoints"].numpy(), want["keypoints"])
    np.testing.assert_allclose(got["keypoint_scores"].numpy(), want["keypoint_scores"], rtol=1e-5, atol=1e-5)

    codec = _plain(dict(recipe["codec"]))
    wrapper, schedule = _plain(dict(recipe["optim_wrapper"])), _plain(list(recipe["param_scheduler"]))
    jax_batch, port_batch = _train_batches(codec, seed=53, K=K)
    if size != (256, 192):  # ``_train_batches`` cuts 256 x 192 crops
        jax_batch["inputs"] = _smooth_crops(2, 54, size=size[::-1])
        port_batch["inputs"] = torch.from_numpy(jax_batch["inputs"])
    tx, _ = jax_build_optimizer(variables["params"], wrapper, schedule, 2, 10)
    _, metrics = jax_make_train_step(jm, tx, mesh=None, donate=False)(
        jax_create_train_state(variables, tx), jax_batch, jax.random.PRNGKey(0))
    optimizer, _ = build_optimizer(ours, wrapper, schedule, 2, 10)
    _, mine = make_train_step(ours, optimizer)(create_train_state(ours, optimizer), port_batch,
                                               torch.Generator().manual_seed(0))
    for key in ("loss_kpt", "acc_pose", "loss"):
        assert float(mine[key]) == pytest.approx(float(metrics[key]), rel=2e-5, abs=1e-6), key


def test_mobilenet_v2_departs_from_jax_at_256():
    """The port's MobileNetV2 is mmpose's: ``out_indices=(7,)`` the last 1x1
    conv's 1280 channels (the JAX module's 7 is the seventh stage, 320
    channels at full width, under a head the configs give
    ``in_channels=1280``), and its
    stride-2 convolutions pad a pixel on each side (the JAX "SAME" pads an
    even side only after it): at 256 x 256 the features differ from the
    JAX module's ``(8,)``, at 257 x 257 they agree."""
    cfg = dict(type="MobileNetV2", widen_factor=0.25, out_indices=(7,))
    sd = {f"backbone.{k}": v for k, v in MODELS.build(dict(cfg)).state_dict().items()}
    variables = _jax_variables(sd)
    ours = MODELS.build(dict(cfg)).eval()
    ours.load_state_dict({k[9:]: v for k, v in sd.items()})
    jax_bb = {k: v["backbone"] for k, v in variables.items()}
    for out_indices, channels in (((7,), 80), ((8,), 1280)):  # 320 x widen_factor, and 1280
        ref = JAX_MODELS.build(dict(cfg, out_indices=out_indices))
        x = _crops(1, seed=55, size=(256, 256)) / 255
        assert ref.apply(jax_bb, jnp.asarray(x))[0].shape[-1] == channels
    for side, agree in ((256, False), (257, True)):
        x = _crops(1, seed=55, size=(side, side)) / 255
        want = np.asarray(JAX_MODELS.build(dict(cfg, out_indices=(8,))).apply(jax_bb, jnp.asarray(x))[0])
        with torch.no_grad():
            got = ours(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())[0].permute(0, 2, 3, 1).numpy()
        assert got.shape == want.shape == (1, (side + 31) // 32, (side + 31) // 32, 1280)
        assert (np.abs(got - want).max() < 1e-4 * np.abs(want).max()) == agree, side


# -- the face fixtures -------------------------------------------------------------


@pytest.mark.parametrize("fixture", FACE_FIXTURES, ids=[f["name"] for f in FACE_FIXTURES])
def test_face_fixture_through_inference_topdown_and_nme(fixture):
    """``chip_smoke.model_fixture_report``, the card's ``face_golden`` check,
    on the CPU."""
    report = model_fixture_report(fixture, device="cpu")
    assert report["instances"] == 62 and report["sane"] > 0.97, report
    assert report["p99"] < 1.0 and report["over_5px"] <= 1, report
    assert report["scores"] < 2e-3 and report["d_AP"] < 0.01, report
    assert report["outputs_rel"] < 1e-4 and report["ok"], report


# -- the entry points --------------------------------------------------------------


def test_tools_test_prints_nme_on_the_wflw_hrnetv2_recipe(tmp_path, capsys, golden_faces):
    """``python -m probpose_code_torch.tools.test`` on the HRNetV2-w18 WFLW
    recipe (narrowed) over the golden JPEGs' faces in WFLW's layout."""
    face_hand_sets_from_coco(GOLDEN / "e2e_coco.json", tmp_path, ["WFLWDataset"])
    options = HRNET_NARROW + [f"test_dataloader.dataset.data_root={golden_faces}",
                              f"test_dataloader.dataset.ann_file={tmp_path / 'WFLWDataset.json'}",
                              "test_dataloader.dataset.data_prefix.img=imgs/", "test_dataloader.num_workers=0"]
    test_cli.main([str(WFLW_HRNET), "--device", "cpu", "--cfg-options", *options])
    lines = dict(line.split(": ", 1) for line in capsys.readouterr().out.splitlines() if line.startswith("nme/"))
    assert set(lines) == {"nme/NME"} and np.isfinite(float(lines["nme/NME"]))


def test_tools_train_runs_the_face6_mix(tmp_path):
    """Two epochs of the face6 recipe (narrowed, batch 16) over the mini COCO
    set's persons in the six sets' layouts (LaPa, COCO-WholeBody-Face, WFLW,
    300W, COFW and Halpe, each through its converter to LaPa's 106), val on
    LaPa by ``NME`` after each, the best checkpoint the lowest ``nme/NME``,
    the first loss dict equal to ``make_train_step``'s."""
    ann = mini_coco_set(tmp_path)
    cfg = Config.fromfile(str(FACE6))
    options = RTMPOSE_NARROW + face_hand_options(cfg, "train_dataloader", tmp_path, ann) + face_hand_options(
        cfg, "val_dataloader", tmp_path, ann) + [
        "train_dataloader.batch_size=16", "train_dataloader.num_workers=0", "val_dataloader.num_workers=0",
        "train_cfg.max_epochs=2", "train_cfg.val_interval=1", "default_hooks.logger.interval=1",
        "custom_hooks.1.switch_epoch=1"]
    work = tmp_path / "work"
    runner = train_cli.main([str(FACE6), "--work-dir", str(work), "--device", "cpu", "--cfg-options", *options])
    datasets = runner.train_loader.dataset.datasets
    assert [type(d).__name__ for d in datasets] == ["LapaDataset", "CocoWholeBodyFaceDataset", "WFLWDataset",
                                                   "Face300WDataset", "COFWDataset", "HalpeDataset"]
    assert runner.metainfo["num_keypoints"] == 106 and runner.save_best == "NME"
    log = (work / "train.log").read_text()
    vals = [float(line.split("nme/NME: ")[1].split()[0]) for line in log.splitlines() if "val: " in line]
    assert len(vals) == 2 and all(np.isfinite(vals))
    best = read_checkpoint(str(work / "best.pth"))  # LaPa's empty sigmas and skeleton colours load untrusted
    assert best["meta"]["best_score"] == pytest.approx(min(vals), rel=1e-4)
    assert best["meta"]["epoch"] == 1 + int(np.argmin(vals))
    _first_step_equals_make_train_step(runner)
