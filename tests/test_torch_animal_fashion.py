"""The animal, fashion and ExLPose families on the CPU against the JAX
package: the fourteen metainfo tables, the twelve dataset classes,
DeepFashion's ``subset`` (the JAX reading and the port's), a narrow AP-10K
HRNet's predict scored by ``CocoMetric`` under AP-10K's sigmas, a narrow
Animal Kingdom ResNet's scored by PCK at 0.05, and every shipped config of
the families built in the port, the three ViPNAS_ResNet DeepFashion ones
also predicting in their narrow form. No animal or fashion file is in the repository: every
set is the golden persons (``tests/golden/e2e_coco.json``) with keypoints
drawn in their boxes, ``chip_smoke.animal_fashion_set_from_coco``.

Bars, with their reasons:
- the tables and the data lists exactly: they are copies. The source
  tables' ``id`` fields repeat a number in three places (AP-10K's skeleton
  link 7, DeepFashion's keypoint 4, DeepFashion2's link 227), which no
  reader uses: the raw tables are held without them, the parsed ones whole.
  The ``pad_to_contain`` of an even keypoint count is the JAX function's on
  rows read as rows (``tests/test_torch_body8.py``'s handling);
- the narrow models (one state dict for both packages): heatmaps at 1e-5 of
  their range and the MSRA keypoints exactly
  (``tests/test_torch_face_hand.py``'s bars); the metrics on each package's
  own predictions to 1e-9 (COCOeval) and 1e-12 (PCK), the bars of
  ``tests/test_torch_coco_metric.py`` and ``test_torch_keypoint_metrics.py``.
"""

import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from chip_smoke import animal_fashion_set_from_coco
from probpose_code_torch.config import Config, parse_cfg_option
from probpose_code_torch.datasets import config_metainfo
from probpose_code_torch.datasets.base_dataset import ANIMAL_FASHION_DATASETS
from probpose_code_torch.datasets.metainfo import DATASET_METAINFO, parse_pose_metainfo
from probpose_code_torch.datasets.transforms.common import RandomFlip
from probpose_code_torch.engine.optim import build_optimizer
from probpose_code_torch.models.builder import PoseModel
from probpose_code_torch.registry import DATASETS, EVALUATORS, METRICS
from probpose_code_torch.structures.data_sample import InstanceData, PoseDataSample
from probpose_code_tpu.datasets.metainfo import parse_pose_metainfo as jax_parse_pose_metainfo
from probpose_code_tpu.models import PoseModel as JaxPoseModel
from tests.test_torch_body8 import RES50_NARROW, RTMPOSE_NARROW, _jax_pad_to_contain
from tests.test_torch_classic_heatmap import _smooth_crops, seeded_state_dict
from tests.test_torch_datasets import assert_same, jax_build
from tests.test_torch_face_hand import _jax_variables, _narrow
from tests.test_torch_wholebody import HRNET_NARROW_EXTRA

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "golden"
JAX_TABLES = ROOT / "probpose_code_tpu" / "datasets" / "metainfo" / "data"
TABLES = ["ap10k", "animalpose", "horse10", "macaque", "fly", "locust", "zebra", "atrw", "ak", "deepfashion_full",
          "deepfashion_upper", "deepfashion_lower", "deepfashion2", "exlpose"]
KINDS = {**ANIMAL_FASHION_DATASETS, "DeepFashionDataset": "deepfashion_full"}
AP10K_HRNET = ROOT / "configs/animal_2d_keypoint/topdown_heatmap/ap10k/td-hm_hrnet-w32_8xb64-210e_ap10k-256x256.py"
AK_RES50 = ROOT / "configs/animal_2d_keypoint/topdown_heatmap/ak/td-hm_res50_8xb64-300e_ak-256x256.py"
HRNET_NARROW = [f"model.backbone.extra={HRNET_NARROW_EXTRA!r}", "model.head.in_channels=8"]
# every shipped config of the families
CONFIGS = sorted(str(p.relative_to(ROOT)) for p in [
    *(ROOT / "configs/animal_2d_keypoint").rglob("*.py"), *(ROOT / "configs/fashion_2d_keypoint").rglob("*.py"),
    *(ROOT / "configs/body_2d_keypoint/topdown_heatmap/exlpose").glob("*.py")])
VIPNAS_NARROW = ["model.backbone.wid=(16,16,32,32,64)", "model.backbone.dep=(None,1,2,2,1)",
                 "model.head.in_channels=64", "model.head.deconv_out_channels=(32,32,32)"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tier-1 runs six test workers at once; one torch thread each."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _num_keypoints(table):
    return len(DATASET_METAINFO[table]["keypoint_info"])


@pytest.fixture(scope="module")
def sets(tmp_path_factory):
    """The golden persons at each table's keypoint count, ``<count>.json``
    (no images)."""
    root = tmp_path_factory.mktemp("animal_fashion")
    for num in {_num_keypoints(t) for t in TABLES}:
        animal_fashion_set_from_coco(GOLDEN / "e2e_coco.json", root / f"{num}.json", num)
    return root


def _dataset_cfg(kind, root, num, **kw):
    return dict(type=kind, data_root=str(root), ann_file=f"{num}.json", data_prefix=dict(img="imgs/"),
                test_mode=True, **kw)


# -- metainfo and datasets -----------------------------------------------------------


def _without_ids(table):
    return {k: ([{f: v for f, v in row.items() if f != "id"} for row in table[k].values()]
                if k in ("keypoint_info", "skeleton_info") else table[k]) for k in table}


@pytest.mark.parametrize("name", TABLES)
def test_table_equals_jax(name):
    ours, ref = parse_pose_metainfo(dict(dataset_name=name)), jax_parse_pose_metainfo(dict(dataset_name=name))
    assert_same(ours, ref, name)
    raw = json.loads(json.dumps(DATASET_METAINFO[name]))
    assert _without_ids(raw) == _without_ids(json.loads((JAX_TABLES / f"{name}.json").read_text()))


@pytest.mark.parametrize("kind", list(KINDS))
def test_dataset_equals_jax(kind, sets):
    """Each class on the golden persons in its layout: the data list
    exactly, and the table that the class names."""
    num = _num_keypoints(KINDS[kind])
    cfg = _dataset_cfg(kind, sets, num, **({"subset": "full"} if kind == "DeepFashionDataset" else {}))
    ours, ref = DATASETS.build(cfg), jax_build(cfg)
    assert len(ours) == len(ref) == 62
    if (3 * num) % 2 == 0:
        for a, b in zip(ours.data_list, ref.data_list):
            assert len(b["pad_to_contain"]) == 3 * num // 2 and len(a["pad_to_contain"]) == num
            b["pad_to_contain"] = _jax_pad_to_contain(b)
    assert_same(ours.data_list, ref.data_list, kind)
    assert ours.data_list[0]["keypoints"].shape == (1, num, 2)
    assert_same({k: v for k, v in ours.metainfo.items() if k != "CLASSES"},
                {k: v for k, v in ref.metainfo.items() if k != "CLASSES"}, kind)


def test_jax_deepfashion_reads_every_subset_under_eight_keypoints(sets):
    """The JAX ``DeepFashionDataset`` takes ``subset`` into its ``**kwargs``
    (``datasets/base_dataset.py:44-57``): the upper subset's 6 keypoints
    meet the full table's 8 flip indices, which index past them."""
    ref = jax_build(_dataset_cfg("DeepFashionDataset", sets, 6, subset="upper"))
    assert ref.metainfo["dataset_name"] == "deepfashion_full" and ref.metainfo["num_keypoints"] == 8
    assert len(ref.metainfo["flip_indices"]) == 8 and ref.data_list[0]["keypoints"].shape == (1, 6, 2)
    with pytest.raises(IndexError):
        ref.data_list[0]["keypoints"][:, ref.metainfo["flip_indices"]]


@pytest.mark.parametrize("subset,num", [("full", 8), ("upper", 6), ("lower", 4)])
def test_deepfashion_subset_picks_its_table(subset, num, sets):
    """The port reads ``subset`` as mmpose does: the table of the subset, its
    flip indices, and a flipped sample of the subset's keypoints; a config
    without ``subset`` reads the full set, another value raises."""
    ours = DATASETS.build(_dataset_cfg("DeepFashionDataset", sets, num, subset=subset))
    table = parse_pose_metainfo(dict(dataset_name=f"deepfashion_{subset}"))
    assert ours.metainfo["dataset_name"] == f"deepfashion_{subset}" and ours.metainfo["num_keypoints"] == num
    assert ours.metainfo["flip_indices"] == table["flip_indices"]
    assert config_metainfo(dict(type="DeepFashionDataset", subset=subset)) == dict(dataset_name=f"deepfashion_{subset}")
    info = ours.get_data_info(0)
    info.update(img=np.zeros((240, 320, 3), np.uint8), img_shape=(240, 320))
    kpts = info["keypoints"].copy()
    flipped = RandomFlip(prob=1.0)(info)
    assert flipped["keypoints"].shape == (1, num, 2)
    np.testing.assert_array_equal(flipped["keypoints"][0, table["flip_indices"], 1], kpts[0, :, 1])
    assert config_metainfo(dict(type="DeepFashionDataset")) == dict(dataset_name="deepfashion_full")
    with pytest.raises(ValueError, match="subset"):
        config_metainfo(dict(type="DeepFashionDataset", subset="middle"))


# -- narrow models and their metrics ------------------------------------------------


def _both_models(config, options, table, seed):
    recipe, cfg = _narrow(config, options)
    sd = seeded_state_dict(cfg, seed=seed)
    ours = PoseModel(cfg, metainfo=parse_pose_metainfo(dict(dataset_name=table)), device="cpu")
    ours.module.load_state_dict(sd, strict=True)
    jm = JaxPoseModel(cfg, metainfo=jax_parse_pose_metainfo(dict(dataset_name=table)))
    return recipe, ours, jm, _jax_variables(sd)


def _predictions(config, options, table, seed, n=4):
    """Both packages' predict programs on ``n`` crops: heatmaps within 1e-5
    of their range, keypoints exactly; returns each package's keypoints
    (n, K, 2) in input pixels and the recipe."""
    recipe, ours, jm, variables = _both_models(config, options, table, seed)
    crops = _smooth_crops(n, seed + 1, size=(256, 256))
    want = {k: np.asarray(v) for k, v in jm.make_predict(jit=False)(variables, crops).items()}
    got = {k: v.numpy() for k, v in ours.predict(torch.from_numpy(crops)).items()}
    K = _num_keypoints(table)
    assert got["heatmaps"].shape == (n, K, 64, 64)
    assert np.abs(got["heatmaps"] - want["heatmaps"]).max() < 1e-5 * np.abs(want["heatmaps"]).max()
    np.testing.assert_array_equal(got["keypoints"], want["keypoints"])
    np.testing.assert_allclose(got["keypoint_scores"], want["keypoint_scores"], rtol=1e-5, atol=1e-5)
    return recipe, got, want


def _image_keypoints(ann, kpts):
    """An instance's prediction in image pixels: its annotated keypoints
    moved by a tenth of its box times the model's offset from the crop's
    centre (input pixels of a 256 x 256 crop)."""
    gt = np.asarray(ann["keypoints"], np.float64).reshape(-1, 3)[:, :2]
    return (gt + (kpts / 256.0 - 0.5) * 0.2 * np.asarray(ann["bbox"][2:]))[None]


def test_ap10k_hrnet_predict_and_coco_metric_match_jax(sets):
    """A narrow AP-10K HRNet-w32 (the recipe's MSRA codec, 17 keypoints at
    256 x 256) on both packages, its predictions scored over the golden
    persons in AP-10K's layout by each package's ``CocoMetric`` with
    AP-10K's sigmas (not COCO's: the AP moves with them)."""
    import probpose_code_tpu.evaluation  # noqa: F401  (registers the JAX metric)
    from probpose_code_tpu.registry import METRICS as JAX_METRICS
    from probpose_code_tpu.structures import InstanceData as JaxInstanceData
    from probpose_code_tpu.structures import PoseDataSample as JaxPoseDataSample

    recipe, got, want = _predictions(AP10K_HRNET, HRNET_NARROW, "ap10k", seed=61)
    ann_file = sets / "17.json"
    gt = json.loads(ann_file.read_text())
    images = {im["id"]: im for im in gt["images"]}
    results = {}
    for name, registry, sample_cls, instance_cls, meta, kpts in (
            ("port", METRICS, PoseDataSample, InstanceData, parse_pose_metainfo, got["keypoints"]),
            ("jax", JAX_METRICS, JaxPoseDataSample, JaxInstanceData, jax_parse_pose_metainfo, want["keypoints"])):
        samples = []
        for i, ann in enumerate(gt["annotations"]):
            s = sample_cls()
            im = images[ann["image_id"]]
            s.set_metainfo(dict(id=ann["id"], img_id=ann["image_id"], category_id=1, raw_ann_info=dict(ann),
                                ori_shape=(im["height"], im["width"]), dataset_name="ap10k"))
            pred = instance_cls()
            pred.set_field(_image_keypoints(ann, kpts[i % len(kpts)]).astype(np.float32), "keypoints")
            pred.set_field(got["keypoint_scores"][i % len(kpts)][None], "keypoint_scores")
            x, y, w, h = ann["bbox"]
            pred.set_field(np.array([[x, y, x + w, y + h]], np.float32), "bboxes")
            s.pred_instances = pred
            truth = instance_cls()
            truth.set_field(np.ones(1, np.float32), "bbox_scores")
            s.gt_instances = truth
            samples.append(s)
        for sigmas in ("ap10k", "coco"):
            metric = registry.build(dict(recipe["val_evaluator"], ann_file=str(ann_file)))
            metric.dataset_meta = dict(meta(dict(dataset_name="ap10k")),
                                       sigmas=meta(dict(dataset_name=sigmas))["sigmas"])
            metric.process(None, samples)
            results[name, sigmas] = metric.evaluate()
    for sigmas in ("ap10k", "coco"):
        ours, ref = results["port", sigmas], results["jax", sigmas]
        assert list(ours) == list(ref)
        for k in ref:
            assert ours[k] == pytest.approx(ref[k], abs=1e-9), k
    assert 0.0 < results["port", "ap10k"]["coco/AP"] < 1.0
    assert results["port", "ap10k"]["coco/AP"] != results["port", "coco"]["coco/AP"]


def test_animal_kingdom_pck_matches_jax(sets):
    """A narrow Animal Kingdom ResNet-50 (23 keypoints) on both packages, its
    predictions scored over the golden persons in the set's layout by each
    package's ``PCKAccuracy(thr=0.05)``, the recipe's."""
    import probpose_code_tpu.evaluation  # noqa: F401  (registers the JAX metric)
    from probpose_code_tpu.registry import METRICS as JAX_METRICS

    recipe, got, want = _predictions(AK_RES50, RES50_NARROW, "ak", seed=71)
    gt = json.loads((sets / "23.json").read_text())["annotations"]
    results = []
    for registry, kpts in ((METRICS, got["keypoints"]), (JAX_METRICS, want["keypoints"])):
        samples = []
        for i, ann in enumerate(gt):
            rows = np.asarray(ann["keypoints"], np.float64).reshape(1, -1, 3)
            x, y, w, h = ann["bbox"]
            samples.append(dict(
                pred_instances=dict(keypoints=_image_keypoints(ann, kpts[i % len(kpts)]),
                                    keypoint_scores=np.ones((1, rows.shape[1]))),
                gt_instances=dict(keypoints=rows[..., :2], keypoints_visible=np.minimum(1, rows[..., 2]),
                                  bboxes=np.array([[x, y, x + w, y + h]]))))
        metric = registry.build(dict(recipe["val_evaluator"]))
        assert metric.thr == 0.05
        metric.process(None, samples)
        results.append(metric.evaluate(len(samples)))
    ours, ref = results
    assert list(ours) == list(ref) == ["pck/PCK"]
    assert ours["pck/PCK"] == pytest.approx(ref["pck/PCK"], rel=0, abs=1e-12)
    assert 0.0 < ours["pck/PCK"] < 1.0


# -- every config --------------------------------------------------------------------


def _narrowed(config):
    """The config with its backbone narrowed (ResNet, HRNet, CSPNeXt,
    ViPNAS_ResNet), its depth, input size, head and keypoints kept."""
    cfg = Config.fromfile(str(ROOT / config))
    kind = cfg["model"]["backbone"]["type"]
    if kind == "ResNet":
        options = [o for o in RES50_NARROW if "deconv" not in o]
    elif kind == "HRNet":
        options = HRNET_NARROW
    elif kind == "ViPNAS_ResNet":
        options = VIPNAS_NARROW
    else:
        assert kind == "CSPNeXt", kind
        options = RTMPOSE_NARROW[:2] + ["model.head.in_channels=128"]
        if cfg["model"]["head"]["type"] == "RTMCCHead":
            options = RTMPOSE_NARROW
    cfg.merge_from_dict(dict(parse_cfg_option(o) for o in options))
    return cfg


@pytest.mark.parametrize("config", CONFIGS)
def test_config_builds_in_the_port(config):
    """Each shipped animal, fashion and ExLPose config, narrowed: its
    datasets' classes and tables (keypoints the head's outputs), the model,
    the optimizer and each evaluator build in the port."""
    cfg = _narrowed(config)
    K = cfg["model"]["head"]["out_channels"]
    for loader in ("train_dataloader", "val_dataloader", "test_dataloader"):
        dataset = cfg[loader]["dataset"]
        assert DATASETS.get(dataset["type"]) is not None, dataset["type"]
        assert parse_pose_metainfo(config_metainfo(dataset))["num_keypoints"] == K, loader
    meta = parse_pose_metainfo(config_metainfo(cfg["train_dataloader"]["dataset"]))
    model = PoseModel(copy.deepcopy(cfg["model"]), metainfo=meta, device="cpu")
    build_optimizer(model, cfg["optim_wrapper"], cfg["param_scheduler"], 10, cfg["train_cfg"]["max_epochs"])
    for key in ("val_evaluator", "test_evaluator"):
        metrics = copy.deepcopy(cfg[key])
        for metric in metrics if isinstance(metrics, list) else [metrics]:
            if metric.get("ann_file"):  # the dataset's file is not here: the golden persons' instead
                metric["ann_file"] = str(GOLDEN / "e2e_coco.json")
        evaluator = EVALUATORS.build(dict(type="Evaluator", metrics=metrics))
        evaluator.dataset_meta = meta
        assert evaluator.metrics


@pytest.mark.parametrize("config", [c for c in CONFIGS if "vipnas" in c])
def test_vipnas_fashion_config_predicts(config):
    """The ViPNAS_ResNet DeepFashion configs, narrowed, through predict on two
    crops at their 192 x 256 input: heatmaps of the subset's keypoints, the
    keypoints inside the crop. (At this even side the port pads as mmpose
    does, not as the JAX module does: ``tests/test_torch_cnn_backbones.py``
    holds the two apart.)"""
    cfg = _narrowed(config)
    meta = parse_pose_metainfo(config_metainfo(cfg["test_dataloader"]["dataset"]))
    model = PoseModel(copy.deepcopy(cfg["model"]), metainfo=meta, device="cpu")
    model.init_weights(0)
    out = model.predict(torch.from_numpy(_smooth_crops(2, 81)))
    K = meta["num_keypoints"]
    assert out["heatmaps"].shape == (2, K, 64, 48)
    kpts = out["keypoints"].numpy()
    assert kpts.shape == (2, K, 2) and np.isfinite(kpts).all()
    assert (kpts >= -0.5).all() and (kpts[..., 0] <= 192).all() and (kpts[..., 1] <= 256).all()
