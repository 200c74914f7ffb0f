"""RTMPose's body8 recipes on the CPU against the JAX package: the body
datasets' metainfo and parsers, the recipes' keypoint mappings,
``PhotometricDistortion``, COCOeval's ``keypoints_crowd``, and
``tools.train`` / ``tools.test`` on the body8, halpe26 and CrowdPose
recipes.

Bars, with their reasons:
- metainfo, datasets and mappings exactly: they are tables and copies;
- ``PhotometricDistortion``: the worker half makes the JAX transform's
  draws (the generator ends in the JAX state) and the plain card half gives
  the JAX transform's bytes, under both shipped orders; the hue step's
  remainder equals NumPy's float32 one on every integer hue and a sweep of
  deltas, and hue 180 converts as cv2 converts it (tolerance 0: the
  augment is bit for bit);
- COCOeval's crowd iouType to 1e-12, as the body iouType is held
  (``tests/test_torch_cocoeval.py``): the same float64 arithmetic;
- ``tools.train`` / ``tools.test`` end to end on narrow models: finite
  metrics under the recipes' keys, the best checkpoint by ``auc/AUC``, and
  the first loss dict equal to ``make_train_step``'s (both on the CPU:
  exactly).
The PCK / AUC / EPE metrics are held in ``tests/test_torch_keypoint_metrics.py``.
"""

import copy
from collections import Counter

import jax
import numpy as np
import pytest
import torch

from chip_smoke import (
    AUGMENT_FIXTURE,
    BODY8,
    CROWDPOSE,
    HALPE26,
    all_hsv_triples,
    body_set_from_coco,
    copy_instances,
    halpe26_repair_options,
    mini_coco_set,
    recipe_sets,
)
from probpose_code_torch.config import Config, parse_cfg_option
from probpose_code_torch.datasets.base_dataset import BODY_DATASETS
from probpose_code_torch.datasets.coco_api import COCO
from probpose_code_torch.datasets.metainfo import parse_pose_metainfo
from probpose_code_torch.datasets.transforms.common import Albumentation, PhotometricDistortion, YOLOXHSVRandomAug
from probpose_code_torch.evaluation.cocoeval import COCOeval
from probpose_code_torch.models.builder import PoseModel
from probpose_code_torch.ops import photometric
from probpose_code_torch.ops.kernels.photometric import augment
from probpose_code_torch.registry import DATASETS
from probpose_code_torch.tools import test as test_cli
from probpose_code_torch.tools import train as train_cli
from probpose_code_tpu.datasets.metainfo import parse_pose_metainfo as jax_parse_pose_metainfo
from probpose_code_tpu.datasets.transforms.common import Albumentation as JaxAlbumentation
from probpose_code_tpu.datasets.transforms.common import PhotometricDistortion as JaxPhotometricDistortion
from probpose_code_tpu.datasets.transforms.common import YOLOXHSVRandomAug as JaxYOLOXHSVRandomAug
from probpose_code_tpu.datasets.transforms.converting import KeypointConverter as JaxKeypointConverter
from probpose_code_tpu.engine.checkpoint import convert_torch_state_dict
from probpose_code_tpu.models import PoseModel as JaxPoseModel
from tests.golden_torch.make_augment_fixtures import cv2_photometric
from tests.test_torch_datasets import assert_same, jax_build
from tests.test_torch_rtmpose_train import _first_step_equals_make_train_step, _plain

BODY_TABLES = ["crowdpose", "mpii", "jhmdb", "halpe", "halpe26", "posetrack18", "ochuman", "humanart"]
NEW_DATASETS = ["CrowdPoseDataset", "MpiiDataset", "JhmdbDataset", "HalpeDataset", "PoseTrack18Dataset",
                "OCHumanDataset", "HumanArtDataset"]
BODY8_CONFIGS = sorted(p.name for p in BODY8.parent.glob("*.py"))
RTMPOSE_NARROW = ["model.backbone.widen_factor=0.125", "model.backbone.deepen_factor=0.167",
                  "model.head.in_channels=128", "model.head.gau_cfg.hidden_dims=32", "model.head.gau_cfg.s=16"]
RES50_NARROW = ["model.backbone.base_channels=4", "model.backbone.stem_channels=16", "model.head.in_channels=128",
                "model.head.deconv_out_channels=(8, 8, 8)"]
RECIPES = {"body8": Config.fromfile(str(BODY8)), "halpe26": Config.fromfile(str(HALPE26))}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tier-1 runs six test workers at once; one torch thread each."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _repaired(cfg):
    """``cfg`` with ``halpe26_repair_options`` merged (a no-op for body8)."""
    cfg = copy.deepcopy(cfg)
    if cfg["train_dataloader"]["dataset"]["metainfo"]["dataset_name"] == "halpe26":
        cfg.merge_from_dict(dict(parse_cfg_option(o) for o in halpe26_repair_options(cfg)))
    return cfg


@pytest.fixture(scope="module")
def mini(tmp_path_factory):
    """The mini COCO set (6 PNG images, 12 persons) and a copy of its first
    two instances."""
    root = tmp_path_factory.mktemp("mini")
    ann = mini_coco_set(root)
    copy_instances(ann, 2, root / "two.json")
    return root, ann


# -- metainfo and datasets ---------------------------------------------------


@pytest.mark.parametrize("name", BODY_TABLES)
def test_metainfo_equals_jax(name):
    ours, ref = parse_pose_metainfo(dict(dataset_name=name)), jax_parse_pose_metainfo(dict(dataset_name=name))
    assert_same(ours, ref, name)


def _jax_pad_to_contain(info):
    """The JAX ``find_min_padding_exact`` on an instance's (x, y) rows, -1
    where the keypoint is not annotated: what it gives (x, y, v) rows
    of an odd keypoint count, which it reads as rows."""
    from probpose_code_tpu.structures.keypoint import find_min_padding_exact

    pad = find_min_padding_exact(info["bbox"], info["keypoints"].reshape(-1, 2))
    pad[info["keypoints_visible"].reshape(-1) <= 0] = -1.0
    return pad


@pytest.mark.parametrize("kind", NEW_DATASETS)
def test_dataset_equals_jax(kind, mini):
    """Each dataset on the mini set written in its layout (CrowdPose's with
    a ``crowdIndex``): the data list and a sample's info exactly. The
    ``pad_to_contain`` of an even keypoint count (CrowdPose, MPII, Halpe) is
    the JAX function's on rows read as rows, which it reads as (x, y) pairs
    of the flat vector (``structures/keypoint.py:find_min_padding_exact``)."""
    root, ann = mini
    num = parse_pose_metainfo(dict(dataset_name=BODY_DATASETS[kind]))["num_keypoints"]
    body_set_from_coco(ann, root / f"{kind}.json", kind, [(k, k % 17) for k in range(num)])
    cfg = dict(type=kind, data_root=str(root), ann_file=f"{kind}.json", data_prefix=dict(img="imgs/"), test_mode=True)
    ours, ref = DATASETS.build(cfg), jax_build(cfg)
    assert len(ours) == len(ref) == 12
    if num % 2 == 0:
        for a, b in zip(ours.data_list, ref.data_list):
            assert len(b["pad_to_contain"]) == 3 * num // 2
            b["pad_to_contain"] = _jax_pad_to_contain(b)
            assert len(a["pad_to_contain"]) == num
    assert_same(ours.data_list, ref.data_list, kind)
    assert ("crowd_index" in ours.data_list[0]) == (kind == "CrowdPoseDataset")


def _sub_datasets():
    """(recipe, index of the sub-dataset) of every train sub-dataset of the
    body8 and halpe26 recipes."""
    return [(r, i) for r, cfg in RECIPES.items() for i in range(len(cfg["train_dataloader"]["dataset"]["datasets"]))]


@pytest.mark.parametrize("recipe,index", _sub_datasets())
def test_recipe_mapping_equals_jax(recipe, index, mini):
    """A sub-dataset of the recipe's mix (its file the mini set in its
    layout) through the port's ``CombinedDataset`` against the JAX dataset
    with the JAX ``KeypointConverter`` applied by hand (the JAX
    ``CombinedDataset`` skips the sub-pipelines): keypoints, their
    visibility and the remapped flip indices exactly."""
    root, ann = mini
    cfg = _repaired(RECIPES[recipe])
    recipe_sets(cfg, "train_dataloader", root, ann)
    sub = _plain(dict(cfg["train_dataloader"]["dataset"]["datasets"][index]))
    sub.update(data_root=str(root), ann_file=f"train_dataloader_{index}.json", data_prefix=dict(img="imgs/"))
    combined = _plain(dict(cfg["train_dataloader"]["dataset"]))
    combined.update(datasets=[sub], pipeline=[])
    ours, ref = DATASETS.build(combined), jax_build(dict(sub, pipeline=[]))
    converter = [t for t in sub["pipeline"] if t["type"] == "KeypointConverter"]
    num = parse_pose_metainfo(combined["metainfo"])["num_keypoints"]
    assert len(ours) == len(ref) == 12
    for idx in range(len(ours)):
        info = ref.get_data_info(idx)
        if converter:
            info = JaxKeypointConverter(**{k: v for k, v in converter[0].items() if k != "type"})(info)
        got = ours[idx]
        assert got["keypoints"].shape == (1, num, 2)
        for key in ("keypoints", "keypoints_visible"):
            np.testing.assert_array_equal(got[key], info[key], err_msg=f"{recipe} {sub['type']} {idx} {key}")
        assert got["flip_indices"] == ours.metainfo["flip_indices"]


def test_shipped_halpe26_mix_is_refused_by_name(mini):
    """The halpe26 configs' Halpe sub-dataset has no converter (136
    keypoints into a 26-keypoint mix) and their COCO one reads COCO-WholeBody's
    feet from a 17-keypoint file: each is refused by name, not in the
    collate (``halpe26_repair_options`` gives mmpose's converters)."""
    root, ann = mini
    cfg = RECIPES["halpe26"]
    recipe_sets(_repaired(cfg), "train_dataloader", root, ann)
    subs = _plain(list(cfg["train_dataloader"]["dataset"]["datasets"]))
    for i, sub in enumerate(subs):
        sub.update(data_root=str(root), ann_file=f"train_dataloader_{i}.json", data_prefix=dict(img="imgs/"))
    combined = dict(_plain(dict(cfg["train_dataloader"]["dataset"])), pipeline=[])
    with pytest.raises(ValueError, match="HalpeDataset.*has 136 keypoints.*KeypointConverter"):
        DATASETS.build(dict(combined, datasets=[subs[5]]))[0]
    with pytest.raises(ValueError, match="KeypointConverter: the mapping reads keypoint 22, the sample has 17"):
        DATASETS.build(dict(combined, datasets=[subs[0]]))[0]


# -- PhotometricDistortion ----------------------------------------------------


@pytest.mark.parametrize("recipe", ["body8", "halpe26"])
def test_photometric_draws_and_bytes_equal_jax(recipe):
    """The recipe's photometric transforms (body8: YOLOX HSV, the
    distortion, Albumentation; halpe26: the last two) under seeds 0..47 on
    the fixture's crops: the JAX chain's crop equals the port's ops with
    the port's recorded parameters, cv2 with the recorded row equals the
    JAX distortion alone, and NumPy's generator ends in the JAX state."""
    pipeline = [t for t in RECIPES[recipe]["train_pipeline"]
                if t["type"] in ("YOLOXHSVRandomAug", "PhotometricDistortion", "Albumentation")]
    kinds = [t["type"] for t in pipeline]
    assert kinds == (["YOLOXHSVRandomAug"] if recipe == "body8" else []) + ["PhotometricDistortion", "Albumentation"]
    albu = _plain(pipeline[-1]["transforms"])
    ours = [YOLOXHSVRandomAug()] * (recipe == "body8") + [PhotometricDistortion(), Albumentation(albu)]
    ref = [JaxYOLOXHSVRandomAug()] * (recipe == "body8") + [JaxPhotometricDistortion(), JaxAlbumentation(albu)]
    crops = np.load(AUGMENT_FIXTURE)["crops"]
    fired = Counter()
    for seed in range(48):
        crop = crops[seed % len(crops)]
        np.random.seed(seed)
        want = dict(img=crop.copy())
        for t in ref:
            want = t(want)
            if isinstance(t, JaxPhotometricDistortion):
                distorted = want["img"].copy()
        jax_state = np.random.get_state()
        np.random.seed(seed)
        params = dict(warp_mat=np.eye(2, 3, dtype=np.float32), input_size=(192, 256))
        for t in ours:
            params = t(params)
        state = np.random.get_state()
        assert state[0] == jax_state[0] and all(np.array_equal(a, b) for a, b in zip(state[1:], jax_state[1:]))
        row = params["photometric"]
        assert row.dtype == np.float32 and row.shape == (8,)
        before = crop if recipe == "halpe26" else augment(
            torch.from_numpy(crop[None]).float(), hsv_gains=torch.from_numpy(params["hsv_gains"][None]))[0].numpy()
        before = before.astype(np.uint8)
        np.testing.assert_array_equal(cv2_photometric(before, row), distorted, err_msg=f"cv2 with the row, {seed}")
        batch = {k: torch.from_numpy(np.asarray(params[k])[None]) for k in photometric.AUGMENT_KEYS if k in params}
        got = augment(torch.from_numpy(crop[None]).float(), **batch)[0].numpy()
        np.testing.assert_array_equal(got, want["img"], err_msg=f"the port's ops, seed {seed}")
        fired.update(name for name, v in zip(("brightness", "contrast", "saturation", "hue", "contrast_after"),
                                             row[:5]) if v != (1.0 if "contrast" in name or name == "saturation"
                                                               else 0.0))
        fired.update(["order"] if list(row[5:]) != [0, 1, 2] else [])
    assert len(fired) == 6 and min(fired.values()) > 0, fired


def test_photometric_hue_180_and_the_remainder_sweep():
    """The hue step's remainder against NumPy's float32 one on every
    integer hue with 20,000 deltas and the edges (sums just below 0 give
    180); hue 180 through ``hsv_to_bgr`` and the card's table against cv2
    (its vector path: not hue 0's bytes)."""
    import cv2

    hue = np.arange(180, dtype=np.float32)[:, None]
    deltas = np.concatenate([np.random.RandomState(0).uniform(-18, 18, 20000).astype(np.float32),
                             np.float32([-1e-6, -7.6e-6, -7.7e-6, 0.0, -0.0, 1e-6, -18, 18])])
    got = photometric.numpy_remainder(torch.from_numpy(hue + deltas), 180.0).numpy()
    want = (hue + deltas) % np.float32(180)
    np.testing.assert_array_equal(got, want)
    assert (want == 180).sum() >= 2
    triples = all_hsv_triples([180])
    want = cv2.cvtColor(triples, cv2.COLOR_HSV2BGR)
    assert not np.array_equal(want, cv2.cvtColor(all_hsv_triples([0]), cv2.COLOR_HSV2BGR))
    np.testing.assert_array_equal(photometric.hsv_to_bgr(torch.from_numpy(triples)).numpy().astype(np.uint8), want)


def test_photometric_lookup_equals_plain_and_refuses_other_widths():
    """The card kernel's route (its float32 steps around the two tables,
    filled here on the CPU) against the plain version on the fixture's
    crops under rows that reach hue 180; a crop width off cv2's whole blocks
    raises."""
    fx = np.load(AUGMENT_FIXTURE)
    img = torch.from_numpy(fx["crops"]).float()
    rows = torch.from_numpy(fx["photometric"][:len(img)])
    assert rows[0, 3] == np.float32(-1e-6)
    want = photometric.photometric_distortion(img, rows)
    tables = photometric.hsv_tables("cpu")
    assert tables[1].shape == (181 << 16, 3)
    to_hsv, to_bgr = tables

    def lookup_hsv(bgr):
        b, g, r = bgr.to(torch.int32).unbind(-1)
        return to_hsv[(r << 16) | (g << 8) | b].to(torch.int32)

    def lookup_bgr(hsv):
        h, s, v = hsv.to(torch.int32).unbind(-1)
        return to_bgr[(h << 16) | (s << 8) | v].to(torch.float32)

    np.testing.assert_array_equal(photometric._distort(img, rows, lookup_hsv, lookup_bgr).numpy(), want.numpy())
    with pytest.raises(ValueError, match="width of 200"):
        photometric.photometric_distortion(torch.zeros(1, 8, 200, 3), rows[:1])


@pytest.mark.parametrize("order", [("PhotometricDistortion", "YOLOXHSVRandomAug"),
                                   ("Albumentation", "PhotometricDistortion"),
                                   ("PhotometricDistortion", "PhotometricDistortion")])
def test_photometric_distortion_refuses_another_order(order):
    build = dict(YOLOXHSVRandomAug=YOLOXHSVRandomAug, PhotometricDistortion=PhotometricDistortion,
                 Albumentation=lambda: Albumentation([dict(type="Blur", p=1.0)]))
    results = build[order[0]]()(dict(warp_mat=np.eye(2, 3, dtype=np.float32), input_size=(192, 256)))
    with pytest.raises(NotImplementedError, match="in that order"):
        build[order[1]]()(results)


# -- COCOeval's keypoints_crowd ------------------------------------------------


def _crowd_sets(seed):
    """CrowdPose ground truth (14 keypoints, some with exactly 2, a crowd
    and an ``ignore``) on 8 images and detections near it, seeded."""
    rng = np.random.RandomState(seed)
    images, gts, dts = [], [], []
    for i in range(1, 9):
        images.append(dict(id=i, width=400, height=300, crowdIndex=float(rng.rand())))
        for _ in range(rng.randint(1, 4)):
            x, y, w, h = rng.uniform(10, 150), rng.uniform(10, 100), rng.uniform(40, 200), rng.uniform(60, 190)
            v = rng.choice([0, 1, 2], 14, p=[0.2, 0.3, 0.5])
            if rng.rand() < 0.2:
                v[:] = 0
                v[:2] = 2
            kpts = np.stack([rng.uniform(x, x + w, 14), rng.uniform(y, y + h, 14), v], 1) * (v > 0)[:, None]
            gts.append(dict(id=len(gts) + 1, image_id=i, category_id=1, bbox=[x, y, w, h], area=w * h,
                            iscrowd=int(rng.rand() < 0.1), ignore=int(rng.rand() < 0.5),
                            num_keypoints=int((v > 0).sum()), keypoints=kpts.reshape(-1).tolist()))
            for _ in range(rng.randint(0, 3)):
                d = kpts.copy()
                d[:, :2] += rng.randn(14, 2) * rng.uniform(1, 25)
                d[:, 2] = rng.rand(14)
                dts.append(dict(id=len(dts) + 1, image_id=i, category_id=1, keypoints=d.reshape(-1).tolist(),
                                score=float(rng.rand()), bbox=[x, y, w, h], area=w * h))
    cats = [dict(id=1, name="person")]
    return dict(images=images, annotations=gts, categories=cats), dict(images=images, annotations=dts, categories=cats)


@pytest.mark.parametrize("use_area", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_crowd_cocoeval_equals_jax(seed, use_area):
    from probpose_code_tpu.datasets.coco_api import COCO as JaxCOCO
    from probpose_code_tpu.evaluation.cocoeval import COCOeval as JaxCOCOeval

    gt, dt = _crowd_sets(seed)
    sigmas = parse_pose_metainfo(dict(dataset_name="crowdpose"))["sigmas"]
    evals = []
    for coco_cls, eval_cls in ((COCO, COCOeval), (JaxCOCO, JaxCOCOeval)):
        ev = eval_cls(coco_cls(dataset=copy.deepcopy(gt)), coco_cls(dataset=copy.deepcopy(dt)),
                      iouType="keypoints_crowd", sigmas=sigmas, use_area=use_area)
        ev.verbose = False
        ev.evaluate()
        ev.accumulate()
        ev.summarize()
        evals.append(ev)
    ours, ref = evals
    assert ours.stats_names == ref.stats_names and 0 < ours.stats[0] < 1
    np.testing.assert_allclose(ours.stats, ref.stats, rtol=0, atol=1e-12)
    np.testing.assert_allclose(ours.loc_similarities, ref.loc_similarities, rtol=0, atol=1e-12)
    ignored = [g["ignore"][0] for gts in ours._gts.values() for g in gts]
    assert 0 < sum(ignored) < len(ignored)


# -- the configs and their entry points ---------------------------------------


def _narrow_rtmpose(cfg):
    cfg = copy.deepcopy(cfg)
    cfg.merge_from_dict(dict(parse_cfg_option(o) for o in RTMPOSE_NARROW))
    return cfg


def _state_dict_matches_jax(cfg):
    """The port's state dict of ``cfg``'s model, through the JAX package's
    converter, has the JAX model's tree and shapes (``jax.eval_shape``: no
    weights made on the JAX side)."""
    meta = parse_pose_metainfo(dict(cfg["train_dataloader"]["dataset"]["metainfo"]))
    sd = PoseModel(_plain(dict(cfg["model"])), metainfo=meta, device="cpu").module.state_dict()
    converted = convert_torch_state_dict({k: v.numpy() for k, v in sd.items()})
    jax_model = JaxPoseModel(_plain(dict(cfg["model"])), metainfo=jax_parse_pose_metainfo(
        dict(cfg["train_dataloader"]["dataset"]["metainfo"])))
    init = jax.eval_shape(lambda: jax_model.init(seed=0))
    for part in ("params", "batch_stats"):
        assert jax.tree_util.tree_structure(converted[part]) == jax.tree_util.tree_structure(init[part])
        for a, b in zip(jax.tree_util.tree_leaves(converted[part]), jax.tree_util.tree_leaves(init[part])):
            assert a.shape == b.shape
    return sd


@pytest.mark.parametrize("config", BODY8_CONFIGS)
def test_body8_config_builds_as_jax(config):
    """Each of the 13 body8 configs, narrowed (its depth, input size and
    keypoints kept), builds in the port with the JAX model's names and
    shapes."""
    cfg = Config.fromfile(str(BODY8.parent / config))
    sd = _state_dict_matches_jax(_narrow_rtmpose(cfg))
    assert sd["head.final_layer.weight"].shape[0] == cfg["model"]["head"]["out_channels"]


@pytest.mark.slow
@pytest.mark.parametrize("config", BODY8_CONFIGS)
def test_body8_config_builds_as_jax_at_full_width(config):
    _state_dict_matches_jax(Config.fromfile(str(BODY8.parent / config)))


def _recipe_options(recipe, root, ann):
    """``--cfg-options`` that run a recipe narrowed on the CPU over the mini
    set: each train sub-dataset two instances in its layout (halpe26's val
    sub-datasets too, its configs repaired), COCO's val set the mini one."""
    cfg = _repaired(RECIPES[recipe])
    copy_instances(ann, 2, root / "two.json")
    options = RTMPOSE_NARROW + recipe_sets(cfg, "train_dataloader", root, root / "two.json")
    options += ["train_dataloader.num_workers=0", "val_dataloader.num_workers=0", "train_cfg.max_epochs=1",
                "train_cfg.val_interval=1", "default_hooks.logger.interval=1"]
    if recipe == "halpe26":
        options += halpe26_repair_options(cfg) + recipe_sets(cfg, "val_dataloader", root, root / "two.json")
        return options + ["train_dataloader.batch_size=7"]
    return options + ["train_dataloader.batch_size=8", f"val_dataloader.dataset.data_root={root}",
                      f"val_dataloader.dataset.ann_file={ann.name}", "val_dataloader.dataset.data_prefix.img=imgs/",
                      "val_dataloader.dataset.bbox_file=None", f"val_evaluator.ann_file={ann}"]


@pytest.mark.parametrize("recipe", ["body8", "halpe26"])
def test_tools_train_runs_the_recipe(recipe, tmp_path):
    """One epoch of 2 steps over the recipe's mix (8 sub-datasets of 2
    instances, or 7), then val: COCO's AP (body8) or ``pck/PCK`` and
    ``auc/AUC`` over the eight-way mix (halpe26, the best checkpoint by
    AUC); every sample's crop augmented; the first loss dict equals
    ``make_train_step``'s."""
    ann = mini_coco_set(tmp_path)
    work = tmp_path / "work"
    runner = train_cli.main([str(BODY8 if recipe == "body8" else HALPE26), "--work-dir", str(work), "--device", "cpu",
                             "--cfg-options", *_recipe_options(recipe, tmp_path, ann)])
    assert runner.state.step == 2 and all(t["augment"] > 0 for t in runner.train_times)
    assert len(runner.train_loader.dataset.datasets) == (8 if recipe == "body8" else 7)
    log = (work / "train.log").read_text()
    _first_step_equals_make_train_step(runner)
    if recipe == "body8":
        assert "val: coco/" in log and runner.metainfo["num_keypoints"] == 17
        return
    assert runner.metainfo["dataset_name"] == "halpe26" and len(runner.val_loader.dataset) == 16
    assert "new best auc/AUC" in log and (work / "best.pth").exists()
    val = [line for line in log.splitlines() if "val: " in line][-1]
    assert "pck/PCK: " in val and "auc/AUC: " in val
    # tools.test on the best checkpoint over the same mix
    assert test_cli.main([str(HALPE26), str(work / "best.pth"), "--device", "cpu", "--cfg-options", *[
        "test" + o[3:] if o.startswith("val_") else o for o in _recipe_options(recipe, tmp_path, ann)
        if o.startswith(("val_dataloader", "model."))]]) is None


def test_tools_test_runs_the_crowdpose_recipe(tmp_path, capsys):
    """``tools.test`` on the CrowdPose ResNet-50 recipe (narrowed) over the
    mini set in CrowdPose's layout: ``crowdpose/`` stats from the crowd
    iouType, finite."""
    ann = mini_coco_set(tmp_path)
    body_set_from_coco(ann, tmp_path / "crowdpose.json", "CrowdPoseDataset",
                       [(k, t) for k, t in enumerate(range(5, 17))] + [(12, 0), (13, 1)])
    options = RES50_NARROW + [f"test_dataloader.dataset.data_root={tmp_path}",
                              "test_dataloader.dataset.ann_file=crowdpose.json",
                              "test_dataloader.dataset.data_prefix.img=imgs/", "test_dataloader.dataset.bbox_file=None",
                              "test_dataloader.num_workers=0", f"test_evaluator.ann_file={tmp_path / 'crowdpose.json'}"]
    test_cli.main([str(CROWDPOSE), "--device", "cpu", "--cfg-options", *options])
    lines = dict(line.split(": ", 1) for line in capsys.readouterr().out.splitlines()
                 if line.startswith("crowdpose/") and ": " in line)
    assert {"crowdpose/AP", "crowdpose/AR", "crowdpose/OKS"} <= set(lines)
    assert all(np.isfinite(float(v)) for v in lines.values())
