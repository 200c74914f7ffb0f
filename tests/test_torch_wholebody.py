"""The COCO-WholeBody family on the CPU against the JAX package: the
``coco_wholebody`` and ``ubody2d`` metainfo, ``CocoWholeBodyDataset`` and
``UBody2dDataset``, the train pipelines at 133 keypoints, the narrow
RTMPose-m and HRNet-w32 whole-body models, and the entry points
(``tools.test`` on the RTMPose whole-body recipe, a ``tools.train`` epoch of
the COCO + UBody recipe).

Bars, with their reasons:
- metainfo and datasets exactly: they are tables and copies. The port's
  ``UBody2dDataset`` equals the JAX ``CocoWholeBodyDataset`` under the
  ``ubody2d`` table with the scene's ``sample_interval`` (mmpose's class);
  the JAX ``UBody2dDataset`` reads 17 keypoints against the 133 of its table,
  and the JAX ``RandomFlip`` then indexes past them (its own test);
- the train pipelines (RTMPose-m's with SimCC, HRNet-w32's with MSRA) over
  the golden JPEGs in COCO-WholeBody's layout, one seed a sample: keypoints
  and weights exactly, the SimCC labels exactly, the MSRA maps rendered on
  the device to 1e-6 (``tests/test_torch_classic_heatmap.py``'s bar: float64
  gaussians rounded to float32 in another order), the augmented crops as
  ``tests/test_torch_rtmpose_train.py`` holds them;
- the narrow models (a few channels, 133 outputs; weights through
  ``convert_torch_state_dict``): the first step's loss dict at rel 2e-5 and
  the predict program's SimCC vectors or maps at 1e-5 of their range, its
  keypoints exactly (``tests/test_torch_rtmpose.py`` and
  ``test_torch_classic_heatmap.py``'s bars);
- the entry points: ``CocoWholeBodyMetric``'s six AP families printed and
  finite; the UBody mix keeps the scenes' sampled images, trains one epoch
  and its first loss dict equals ``make_train_step``'s (both on the CPU:
  exactly).
"""

import copy
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from chip_smoke import (
    UBODY,
    WHOLEBODY_FIXTURE,
    WHOLEBODY_RECIPES,
    copy_instances,
    golden_jpeg_set,
    mini_coco_set,
    model_fixture_report,
    ubody_sets,
    wholebody_set_from_coco,
)
from probpose_code_torch.config import Config
from probpose_code_torch.datasets.loader import collate_pose_samples
from probpose_code_torch.datasets.metainfo import parse_pose_metainfo
from probpose_code_torch.datasets.transforms.common import GetBBoxCenterScale, RandomFlip
from probpose_code_torch.models.builder import PoseModel
from probpose_code_torch.ops import photometric
from probpose_code_torch.ops.kernels.photometric import augment
from probpose_code_torch.registry import DATASETS
from probpose_code_torch.tools import test as test_cli
from probpose_code_torch.tools import train as train_cli
from probpose_code_tpu.datasets.metainfo import parse_pose_metainfo as jax_parse_pose_metainfo
from probpose_code_tpu.engine.checkpoint import convert_torch_state_dict
from probpose_code_tpu.engine.optim import build_optimizer as jax_build_optimizer
from probpose_code_tpu.models import PoseModel as JaxPoseModel
from probpose_code_tpu.parallel import create_train_state as jax_create_train_state
from probpose_code_tpu.parallel import make_train_step as jax_make_train_step
from tests.test_torch_classic_heatmap import seeded_state_dict
from tests.test_torch_datasets import assert_same, jax_build
from tests.test_torch_rtmpose_train import _first_step_equals_make_train_step, _plain, _seeded, _tensors

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "golden"
RTMPOSE_WB, HRNET_WB = WHOLEBODY_RECIPES["rtmpose"], WHOLEBODY_RECIPES["hrnet"]
RTMPOSE_NARROW = ["model.backbone.widen_factor=0.125", "model.backbone.deepen_factor=0.167",
                  "model.head.in_channels=128", "model.head.gau_cfg.hidden_dims=32", "model.head.gau_cfg.s=16"]
# one module and one block a branch, widths 8-64
HRNET_NARROW_EXTRA = dict(
    stage1=dict(num_modules=1, num_branches=1, block="BOTTLENECK", num_blocks=(1,), num_channels=(8,)),
    stage2=dict(num_modules=1, num_branches=2, block="BASIC", num_blocks=(1, 1), num_channels=(8, 16)),
    stage3=dict(num_modules=1, num_branches=3, block="BASIC", num_blocks=(1, 1, 1), num_channels=(8, 16, 32)),
    stage4=dict(num_modules=1, num_branches=4, block="BASIC", num_blocks=(1, 1, 1, 1), num_channels=(8, 16, 32, 64)),
)
META = dict(dataset_name="coco_wholebody")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tier-1 runs six test workers at once; one torch thread each."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _narrow(config):
    """The model of ``config``, narrowed: CSPNeXt widen 0.125 / deepen 0.167
    with a GAU of 32 / 16, or HRNet's ``HRNET_NARROW_EXTRA``."""
    cfg = _plain(dict(Config.fromfile(str(config))["model"]))
    if cfg["backbone"]["type"] == "CSPNeXt":
        cfg["backbone"].update(deepen_factor=0.167, widen_factor=0.125)
        cfg["head"].update(in_channels=128)
        cfg["head"]["gau_cfg"].update(hidden_dims=32, s=16)
    else:
        cfg["backbone"]["extra"] = copy.deepcopy(HRNET_NARROW_EXTRA)
        cfg["head"].update(in_channels=8)
    return cfg


# -- metainfo and datasets ---------------------------------------------------


@pytest.mark.parametrize("name", ["coco_wholebody", "ubody2d"])
def test_metainfo_equals_jax(name):
    ours, ref = parse_pose_metainfo(dict(dataset_name=name)), jax_parse_pose_metainfo(dict(dataset_name=name))
    assert_same(ours, ref, name)
    assert ours["num_keypoints"] == 133 and len(ours["upper_body_ids"]) == 11 and len(ours["lower_body_ids"]) == 12


@pytest.fixture(scope="module")
def wholebody(tmp_path_factory):
    """The golden annotations in COCO-WholeBody's layout, and a copy of
    them over 120 instances (image ids 1000 k + i: a tenth of the copies
    kept by ``sample_interval=10``)."""
    root = tmp_path_factory.mktemp("wholebody")
    wholebody_set_from_coco(GOLDEN / "e2e_coco.json", root / "wholebody.json")
    copy_instances(root / "wholebody.json", 120, root / "copies.json")
    return root


@pytest.mark.parametrize("kind", ["CocoWholeBodyDataset", "UBody2dDataset"])
def test_dataset_equals_jax(kind, wholebody):
    """Every instance's info exactly: 133 keypoints from the five fields,
    their visibility (v == 2), ``pad_to_contain`` (133 keypoints are an odd
    count: the JAX ``find_min_padding_exact`` reads the (x, y, v) rows as
    rows) and area. ``UBody2dDataset`` against the JAX
    ``CocoWholeBodyDataset`` under ``ubody2d`` with the same
    ``sample_interval``."""
    cfg = dict(type=kind, data_root=str(wholebody), ann_file="copies.json", data_prefix=dict(img="imgs/"),
               test_mode=True)
    if kind == "UBody2dDataset":
        cfg["sample_interval"] = 10
    ref_cfg = dict(cfg, type="CocoWholeBodyDataset", metainfo=dict(dataset_name="ubody2d")) \
        if kind == "UBody2dDataset" else cfg
    ours, ref = DATASETS.build(cfg), jax_build(ref_cfg)
    anns = json.loads((wholebody / "copies.json").read_text())["annotations"]
    kept = [a for a in anns if a["image_id"] % cfg.get("sample_interval", 1) == 0]
    assert len(ours) == len(ref) == len(kept)
    assert len(kept) == 120 if kind == "CocoWholeBodyDataset" else 0 < len(kept) < 120
    assert_same(ours.data_list, ref.data_list, kind)
    info = ours.data_list[0]
    assert info["keypoints"].shape == (1, 133, 2) and info["pad_to_contain"].shape == (133,)
    gt = kept[0]
    assert info["keypoints_visibility"][0, 17:23].tolist() == [float(v == 2) for v in gt["foot_kpts"][2::3]]


def test_jax_ubody2d_dataset_reads_17_keypoints_and_flip_fails(wholebody):
    """The JAX ``UBody2dDataset`` (``datasets/zoo.py:66``) is the COCO
    parser under the 133-keypoint ``ubody2d`` table: a UBody file's body
    keypoints only, and ``RandomFlip``'s 133 flip indices run past them.
    The port's class reads the five fields, and the flip runs."""
    from probpose_code_tpu.datasets.transforms.common import GetBBoxCenterScale as JaxGetBBoxCenterScale
    from probpose_code_tpu.datasets.transforms.common import RandomFlip as JaxRandomFlip

    cfg = dict(type="UBody2dDataset", data_root=str(wholebody), ann_file="wholebody.json",
               data_prefix=dict(img="imgs/"), test_mode=True)
    ref = jax_build(cfg)
    info = ref.get_data_info(0)
    assert info["keypoints"].shape == (1, 17, 2) and len(info["flip_indices"]) == 133
    with pytest.raises(IndexError):
        JaxRandomFlip(prob=1.0)(JaxGetBBoxCenterScale()(dict(info, img=np.zeros((480, 640, 3), np.uint8),
                                                             img_shape=(480, 640))))
    ours = DATASETS.build(cfg).get_data_info(0)
    flipped = RandomFlip(prob=1.0)(GetBBoxCenterScale()(dict(ours, img=np.zeros((480, 640, 3), np.uint8),
                                                             img_shape=(480, 640))))
    assert flipped["keypoints"].shape == (1, 133, 2)


# -- the train pipelines at 133 keypoints -------------------------------------


@pytest.fixture(scope="module")
def golden_wholebody(tmp_path_factory):
    """The golden JPEGs with their annotations in COCO-WholeBody's layout."""
    root = tmp_path_factory.mktemp("golden_wholebody")
    _, ann = golden_jpeg_set(root)
    wholebody_set_from_coco(ann, root / "wholebody.json")
    return root / "wholebody.json"


def _dataset_cfg(ann, pipeline):
    return dict(type="CocoWholeBodyDataset", data_root=str(Path(ann).parent), ann_file=Path(ann).name,
                data_prefix=dict(img="imgs/"), test_mode=False, pipeline=_plain(pipeline))


@pytest.mark.parametrize("config", [RTMPOSE_WB, HRNET_WB], ids=["rtmpose", "hrnet"])
def test_recipe_pipeline_equals_jax_at_133_keypoints(config, golden_wholebody):
    """12 instances of the golden JPEGs through the recipe's train pipeline
    in both packages, one seed a sample: ``RandomFlip``'s 133 flip indices,
    ``RandomHalfBody``'s upper and lower ids, the targets on the device."""
    pipeline = Config.fromfile(str(config))["train_pipeline"]
    target = next(i for i, t in enumerate(pipeline) if t["type"] == "GenerateTarget")
    n = 12
    packed = _seeded(DATASETS.build(_dataset_cfg(golden_wholebody, pipeline)), n)
    unpacked = _seeded(DATASETS.build(_dataset_cfg(golden_wholebody, pipeline[:-1])), n)
    ref = _seeded(jax_build(_dataset_cfg(golden_wholebody, pipeline[:-1])), n)
    for a, b in zip(unpacked, ref):
        assert a["transformed_keypoints"].shape == (1, 133, 2)
        for key in ("transformed_keypoints", "keypoint_weights", "keypoints_visible", "bbox_scale"):
            np.testing.assert_array_equal(np.asarray(a[key]), np.asarray(b[key]), err_msg=key)

    model = PoseModel(_narrow(config), metainfo=parse_pose_metainfo(META), device="cpu")
    collated = collate_pose_samples(packed)
    batch = _tensors({k: v for k, v in collated.items() if isinstance(v, np.ndarray)})
    batch.update({k: v for k, v in collated.items() if k.startswith("jpeg") and k not in batch})
    params = {k: batch[k] for k in photometric.AUGMENT_KEYS if k in batch}
    got = model.device_preprocess_batch(dict(batch))
    np.testing.assert_array_equal(got["keypoint_weights"].numpy(), np.stack([r["keypoint_weights"][0] for r in ref]))
    if "keypoint_x_labels" in ref[0]:
        for key in ("keypoint_x_labels", "keypoint_y_labels"):
            assert got[key].shape[1] == 133
            np.testing.assert_array_equal(got[key].numpy(), np.stack([r[key][0] for r in ref]), err_msg=key)
    else:
        assert got["heatmaps"].shape == (n, 133, 64, 48)
        np.testing.assert_allclose(got["heatmaps"].numpy(), np.stack([r["heatmaps"] for r in ref]), atol=1e-6)
    if not params:
        return
    # the augment: the port's ops on the JAX pipeline's own crops give its augmented crops
    ref_crops = np.stack([r["img"] for r in _seeded(jax_build(_dataset_cfg(golden_wholebody, pipeline[:6])), n)])
    same = augment(torch.from_numpy(ref_crops).float(), **params)
    np.testing.assert_array_equal(same.numpy(), np.stack([r["img"] for r in ref]))
    assert target == len(pipeline) - 2


# -- the narrow models -------------------------------------------------------


def _train_batches(codec, seed, K=133):
    """Two crops with input-space keypoints (some outside, some
    unannotated): the JAX batch with its host codec's targets, the port's
    with what its GenerateTarget ships."""
    from probpose_code_torch.datasets.transforms.common import GenerateTarget
    from probpose_code_tpu.datasets.transforms.common import GenerateTarget as JaxGenerateTarget
    from tests.test_torch_classic_heatmap import _smooth_crops

    rng = np.random.RandomState(seed)
    ours, theirs = GenerateTarget(encoder=dict(codec)), JaxGenerateTarget(encoder=dict(codec))
    port, jaxb = [], []
    for _ in range(2):
        kpts = np.stack([rng.uniform(-20, 212, (1, K)), rng.uniform(-20, 276, (1, K))], -1).astype(np.float32)
        vis = (rng.rand(1, K) > 0.2).astype(np.float32)
        port.append(ours({"transformed_keypoints": kpts.copy(), "keypoints_visible": vis.copy()}))
        jaxb.append(theirs({"transformed_keypoints": kpts.copy(), "keypoints_visible": vis.copy()}))
    inputs = _smooth_crops(2, seed + 1)
    targets = ("keypoint_x_labels", "keypoint_y_labels") if codec["type"] == "SimCCLabel" else ("heatmaps",)
    jax_batch = dict(inputs=inputs, keypoint_weights=np.stack([r["keypoint_weights"][0] for r in jaxb]),
                     **{k: np.stack([r[k][0] if k != "heatmaps" else r[k] for r in jaxb]).astype(np.float32)
                        for k in targets})
    port_batch = dict(inputs=torch.from_numpy(inputs),
                      kpts_hm=torch.from_numpy(np.stack([r["device_kpts_hm"][0] for r in port])),
                      kpts_visible=torch.from_numpy(np.stack([r["device_kpts_visible"][0] for r in port])),
                      keypoint_weights=torch.from_numpy(np.stack([r["keypoint_weights"][0] for r in port])))
    return jax_batch, port_batch


@pytest.mark.parametrize("config", [RTMPOSE_WB, HRNET_WB], ids=["rtmpose", "hrnet"])
def test_narrow_model_loss_and_predict_match_jax(config):
    """The recipe's model narrowed, 133 outputs, one state dict for both
    packages: the predict program on two crops, then the first step of
    each package's train step under the recipe's optimizer."""
    from tests.test_torch_classic_heatmap import _crops
    from probpose_code_torch.engine.optim import build_optimizer
    from probpose_code_torch.parallel import create_train_state, make_train_step

    recipe = Config.fromfile(str(config))
    cfg = _narrow(config)
    sd = seeded_state_dict(cfg, seed=41)
    ours = PoseModel(cfg, metainfo=parse_pose_metainfo(META), device="cpu")
    ours.module.load_state_dict(sd, strict=True)
    jm = JaxPoseModel(cfg, metainfo=jax_parse_pose_metainfo(META))
    variables = convert_torch_state_dict({k: v.numpy() for k, v in sd.items()})
    crops = _crops(2, seed=42)
    want = {k: np.asarray(v) for k, v in jm.make_predict(jit=False)(variables, crops).items()}
    got = ours.predict(torch.from_numpy(crops))
    outputs = ("keypoint_x_labels", "keypoint_y_labels") if "keypoint_x_labels" in want else ("heatmaps",)
    for key in outputs:
        assert got[key].shape[:2] == (2, 133)
        assert np.abs(got[key].numpy() - want[key]).max() < 1e-5 * np.abs(want[key]).max(), key
    assert got["keypoints"].shape == (2, 133, 2)
    np.testing.assert_array_equal(got["keypoints"].numpy(), want["keypoints"])
    np.testing.assert_allclose(got["keypoint_scores"].numpy(), want["keypoint_scores"], rtol=1e-5, atol=1e-5)

    wrapper, schedule = _plain(dict(recipe["optim_wrapper"])), _plain(list(recipe["param_scheduler"]))
    jax_batch, port_batch = _train_batches(_plain(dict(recipe["codec"])), seed=43)
    tx, _ = jax_build_optimizer(variables["params"], wrapper, schedule, 2, 10)
    _, metrics = jax_make_train_step(jm, tx, mesh=None, donate=False)(
        jax_create_train_state(variables, tx), jax_batch, jax.random.PRNGKey(0))
    optimizer, _ = build_optimizer(ours, wrapper, schedule, 2, 10)
    _, mine = make_train_step(ours, optimizer)(create_train_state(ours, optimizer), port_batch,
                                               torch.Generator().manual_seed(0))
    for name in ("loss_kpt", "acc_pose", "loss"):
        assert float(mine[name]) == pytest.approx(float(metrics[name]), rel=2e-5, abs=1e-6), name


def test_wholebody_fixture_through_inference_topdown_and_the_metric():
    """``chip_smoke.model_fixture_report``, the card's ``wholebody_golden``
    check, on the CPU: the narrow RTMPose whole-body fixture."""
    report = model_fixture_report(WHOLEBODY_FIXTURE, device="cpu")
    assert report["instances"] == 62 and report["sane"] > 0.97, report
    assert report["p99"] < 1.0 and report["over_5px"] <= 1, report
    assert report["scores"] < 2e-3 and report["d_AP"] < 0.01, report
    assert report["outputs_rel"] < 1e-4 and report["ok"], report


# -- the entry points --------------------------------------------------------


def test_tools_test_prints_the_six_ap_families(tmp_path, capsys, golden_wholebody):
    """``python -m probpose_code_torch.tools.test`` on the RTMPose whole-body
    recipe (narrowed) over the golden JPEGs in COCO-WholeBody's layout, the
    ground-truth boxes: ``CocoWholeBodyMetric``'s stats for the body, the
    feet, the face, both hands and the whole body, finite."""
    root = golden_wholebody.parent
    options = RTMPOSE_NARROW + [f"test_dataloader.dataset.data_root={root}", "test_dataloader.dataset.ann_file="
                                f"{golden_wholebody.name}", "test_dataloader.dataset.data_prefix.img=imgs/",
                                "test_dataloader.dataset.bbox_file=None", "test_dataloader.num_workers=0",
                                f"test_evaluator.ann_file={golden_wholebody}"]
    test_cli.main([str(RTMPOSE_WB), "--device", "cpu", "--cfg-options", *options])
    lines = dict(line.split(": ", 1) for line in capsys.readouterr().out.splitlines()
                 if line.startswith("coco/") and ": " in line)
    families = {f"coco/{p}AP" for p in ("body_", "foot_", "face_", "lefthand_", "righthand_", "")}
    assert families <= set(lines) and {"coco/AR", "coco/OKS"} <= set(lines)
    assert all(np.isfinite(float(v)) for v in lines.values())


def test_tools_train_runs_the_ubody_mix(tmp_path):
    """One epoch of the COCO + UBody recipe (narrowed) over the mini set:
    COCO's 12 instances and the 15 scenes' sampled ones (``ubody_sets``:
    each scene keeps the images whose id ``sample_interval=10`` keeps),
    133 keypoints through every pipeline, val by ``CocoWholeBodyMetric``,
    the first loss dict equal to ``make_train_step``'s."""
    ann = mini_coco_set(tmp_path)
    cfg = Config.fromfile(str(UBODY))
    sets, kept = ubody_sets(cfg, tmp_path, ann)
    options = RTMPOSE_NARROW + sets + [
        "train_dataloader.batch_size=16", "train_dataloader.num_workers=0",
        f"val_dataloader.dataset.data_root={tmp_path}",
        "val_dataloader.dataset.ann_file=train_dataloader_0.json", "val_dataloader.dataset.data_prefix.img=imgs/",
        "val_dataloader.dataset.bbox_file=None", "val_dataloader.num_workers=0",
        f"val_evaluator.ann_file={tmp_path / 'train_dataloader_0.json'}", "train_cfg.max_epochs=1",
        "train_cfg.val_interval=1", "default_hooks.logger.interval=1", "default_hooks.checkpoint.save_best=coco/AP"]
    work = tmp_path / "work"
    runner = train_cli.main([str(UBODY), "--work-dir", str(work), "--device", "cpu", "--cfg-options", *options])
    datasets = runner.train_loader.dataset.datasets
    assert len(datasets) == 16 and [type(d).__name__ for d in datasets[1:]] == ["UBody2dDataset"] * 15
    assert len(runner.train_loader.dataset) == kept and 12 < kept < 12 * 16
    assert all(0 < len(d) < 12 for d in datasets[1:])
    assert runner.state.step == kept // 16 and runner.metainfo["num_keypoints"] == 133  # the last part batch dropped
    log = (work / "train.log").read_text()
    assert "new best coco/AP" in log and (work / "best.pth").exists()
    val = [line for line in log.splitlines() if "val: " in line][-1]
    assert all(f"coco/{p}AP: " in val for p in ("body_", "foot_", "face_", "lefthand_", "righthand_"))
    _first_step_equals_make_train_step(runner)
