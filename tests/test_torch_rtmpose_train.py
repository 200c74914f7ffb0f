"""RTMPose-m's training recipe on the CPU: the photometric augmentations
against OpenCV and the JAX transforms, the stage-2 switch, and
``tools.train`` on the RTMPose-m and AIC+COCO recipes.

Bars, with their reasons:
- ``ops/photometric.py`` (the plain versions, which a CPU batch runs and
  the card's forms are held to) against cv2, tolerance 0: the colour
  conversions on all 2^24 BGR colours and all 180 x 256 x 256 HSV triples;
  the blur and the median for k = 3, 5, 7 on crops and on tiles that hit
  every window sum; CoarseDropout and the four ops in a row on the golden
  crops; the card's HSV jitter through its tables against the plain one,
  and both refuse a crop width off cv2's whole blocks;
- the fixture the card is held to (``tests/golden_torch/augment_fixture.
  npz``, cv2's digests): the port's ops on the CPU give its bytes;
- the worker halves make the JAX transforms' draws: under one seed, cv2 with
  the recorded parameters gives the JAX transforms' crop exactly, so do the
  port's ops, and NumPy's global generator ends in the JAX state; they
  refuse an order the device does not apply;
- the recipe's whole train pipeline over the golden JPEGs against the JAX
  pipeline: keypoints, weights and SimCC labels exactly; the augmented crops
  exactly wherever the two pipelines' crops agree before the augment (over
  each pixel's 7 x 7 neighbourhood; the port's warp and cv2's differ by one
  grey level on a few pixels), and the port's ops on the JAX crop exactly;
- a mixed batch (PNG canvases and JPEG files) applies each sample's
  parameters to its own crop;
- ``PipelineSwitchHook``: the batches after the switch from two kept worker
  processes equal those made in process;
- ``tools.train`` trains both recipes (narrow CSPNeXt) two epochs across the
  switch, and its first loss dict equals ``make_train_step``'s on the same
  batch, weights and generator seed (both on the CPU: exactly).
"""

import copy
import json
from collections import Counter
from pathlib import Path
from types import SimpleNamespace

import cv2
import numpy as np
import pytest
import torch

from chip_smoke import (
    AUGMENT_FIXTURE,
    RTMPOSE,
    aic_from_coco,
    all_bgr_colours,
    all_hsv_triples,
    augment_fixture_params,
    augment_fixture_report,
    golden_jpeg_set,
    golden_png_set,
    mini_coco_set,
    window_sum_tiles,
)
from probpose_code_torch.config import Config
from probpose_code_torch.datasets.loader import DataLoader, collate_pose_samples, stop_workers
from probpose_code_torch.datasets.transforms.common import Albumentation, YOLOXHSVRandomAug
from probpose_code_torch.engine.checkpoint import read_checkpoint
from probpose_code_torch.engine.hooks import PipelineSwitchHook
from probpose_code_torch.engine.optim import build_optimizer
from probpose_code_torch.models.builder import PoseModel
from probpose_code_torch.ops import photometric
from probpose_code_torch.ops.kernels.photometric import augment
from probpose_code_torch.parallel import create_train_state, make_train_step
from probpose_code_torch.registry import DATASETS
from probpose_code_torch.tools import train as train_cli
from probpose_code_tpu.datasets.transforms.common import Albumentation as JaxAlbumentation
from probpose_code_tpu.datasets.transforms.common import YOLOXHSVRandomAug as JaxYOLOXHSVRandomAug
from tests.golden_torch.make_augment_fixtures import cv2_ops
from tests.test_torch_datasets import jax_build

RECIPE = Config.fromfile(str(RTMPOSE))
AIC_COCO = RTMPOSE.parent / "rtmpose-m_8xb256-420e_aic-coco-256x192.py"
NARROW = ["model.backbone.widen_factor=0.125", "model.backbone.deepen_factor=0.167", "model.head.in_channels=128",
          "model.head.gau_cfg.hidden_dims=32", "model.head.gau_cfg.s=16"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tier-1 runs six test workers at once; one torch thread each."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _plain(obj):
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    return obj


def _narrow_model():
    cfg = _plain(dict(RECIPE["model"]))
    cfg["backbone"].update(deepen_factor=0.167, widen_factor=0.125)
    cfg["head"].update(in_channels=128)
    cfg["head"]["gau_cfg"].update(hidden_dims=32, s=16)
    return cfg


@pytest.fixture(scope="module")
def crops():
    return np.load(AUGMENT_FIXTURE)["crops"]


def _tensors(params):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in params.items()}


# -- the ops against cv2 ----------------------------------------------------


@pytest.mark.parametrize("direction", ["bgr_to_hsv", "hsv_to_bgr"])
def test_colour_conversions_equal_cv2_on_every_input(direction):
    """Every colour (rows of 256) and every HSV triple (rows of 192, the
    crop's width), in slices of 2^20 pixels."""
    if direction == "bgr_to_hsv":
        inputs, code, port = all_bgr_colours(), cv2.COLOR_BGR2HSV, photometric.bgr_to_hsv
    else:
        inputs, code, port = all_hsv_triples(), cv2.COLOR_HSV2BGR, photometric.hsv_to_bgr
    want = cv2.cvtColor(inputs, code)
    rows = (1 << 20) // inputs.shape[1]
    bad = sum(int((port(torch.from_numpy(inputs[i:i + rows])).numpy() != want[i:i + rows]).any(-1).sum())
              for i in range(0, len(inputs), rows))
    assert bad == 0, f"{bad} of {inputs.shape[0] * inputs.shape[1]} pixels differ from cv2"


@pytest.mark.parametrize("k", [3, 5, 7])
def test_blur_and_median_equal_cv2(k, crops):
    """Two golden crops and a noise crop, and the window-sum tiles: every
    sum 0 .. 255 k² of a window, at its tile's centre."""
    noise = np.random.RandomState(k).randint(0, 256, (1, 256, 192, 3)).astype(np.uint8)
    for imgs in (np.concatenate([crops[:2], noise]), window_sum_tiles(k)[None]):
        x = torch.from_numpy(imgs).float()
        blur, median = photometric.box_blur(x, k).numpy(), photometric.median_blur(x, k).numpy()
        for img, b, m in zip(imgs, blur, median):
            np.testing.assert_array_equal(b, cv2.blur(img, (k, k)))
            np.testing.assert_array_equal(m, cv2.medianBlur(img, k))


def test_coarse_dropout_and_the_ops_in_a_row_equal_cv2(crops):
    """The fixture's parameters on its crops (16 samples: every pair of blur
    and median kernel sizes, holes or none), each op's result against the
    cv2 chain; and holes clipped at the crop's edge as a NumPy slice."""
    params = augment_fixture_params(16, len(crops), seed=11)
    stages = ("hsv_gains", "blur_ksize", "median_ksize", "dropout_rects")
    img = torch.from_numpy(crops[params["index"]]).float()
    want = [cv2_ops(crops[i], *(params[k][j] for k in stages)) for j, i in enumerate(params["index"])]
    for s, key in enumerate(stages):
        img = augment(img, **{key: torch.from_numpy(params[key])})
        for j in range(len(img)):
            np.testing.assert_array_equal(img[j].numpy(), want[j][s], err_msg=f"{key} sample {j}")
    rects = np.array([[[240, 180, 40, 30], [0, 0, 0, 5]], [[0, 10, 5, 500], [3, 3, 2, 2]]], np.int32)
    got = photometric.coarse_dropout(torch.from_numpy(crops[:2]).float(), torch.from_numpy(rects)).numpy()
    for img, holes, out in zip(crops[:2].copy(), rects, got):
        for y, x, h, w in holes:
            img[y:y + h, x:x + w] = 0
        np.testing.assert_array_equal(out, img)


def test_hsv_lookup_equals_plain_and_refuses_other_widths(crops):
    """The card's HSV jitter, two gathers from ``hsv_tables`` (filled here
    on the CPU by the plain conversions), against ``yolox_hsv`` on the
    golden crops and a noise crop under random and extreme gains; both
    refuse a crop width that cv2 does not convert in whole blocks of 32."""
    tables = photometric.hsv_tables("cpu")
    noise = np.random.RandomState(5).randint(0, 256, (1, 256, 192, 3)).astype(np.uint8)
    img = torch.from_numpy(np.concatenate([crops, noise])).float()
    rng = np.random.RandomState(6)
    for gains in (rng.uniform(-1, 1, (len(img), 3)) * [5, 30, 30], np.tile([[179, 255, 255]], (len(img), 1)),
                  np.tile([[-179, -255, -255]], (len(img), 1))):
        gains = torch.from_numpy(gains.astype(np.int16))
        assert torch.equal(photometric.yolox_hsv_lookup(img, gains, tables), photometric.yolox_hsv(img, gains))
    for fn in (photometric.yolox_hsv, lambda x, g: photometric.yolox_hsv_lookup(x, g, tables)):
        with pytest.raises(ValueError, match="width of 190"):
            fn(img[:, :, :190], gains)


def test_augment_fixture_holds_on_the_cpu():
    """``chip_smoke.augment_fixture_report``, the card's
    ``rtmpose_augment`` check, on the CPU over the fixture's first 32
    samples (every pair of kernel sizes twice)."""
    report = augment_fixture_report("cpu", limit=32)
    assert report["ok"], report


# -- the worker halves against the JAX transforms ---------------------------


@pytest.mark.parametrize("stage", ["train_pipeline", "train_pipeline_stage2"])
def test_worker_draws_equal_jax(stage, crops):
    """The recipe's ``YOLOXHSVRandomAug`` and ``Albumentation`` under seeds
    0..59 on the golden crops: the JAX transforms' crop equals cv2 and the
    port's ops with the port's recorded parameters, and the global
    generator ends where the JAX transforms leave it."""
    hsv_cfg, albu_cfg = (_plain(t) for t in RECIPE[stage][6:8])
    assert (hsv_cfg["type"], albu_cfg["type"]) == ("YOLOXHSVRandomAug", "Albumentation")
    ours = [YOLOXHSVRandomAug(), Albumentation(albu_cfg["transforms"])]
    ref = [JaxYOLOXHSVRandomAug(), JaxAlbumentation(albu_cfg["transforms"])]
    fired = Counter()
    for seed in range(60):
        crop = crops[seed % len(crops)]
        np.random.seed(seed)
        want = dict(img=crop.copy())
        for t in ref:
            want = t(want)
        jax_state = np.random.get_state()
        np.random.seed(seed)
        params = dict(warp_mat=np.eye(2, 3, dtype=np.float32), input_size=(192, 256))
        for t in ours:
            params = t(params)
        state = np.random.get_state()
        assert state[0] == jax_state[0] and all(np.array_equal(a, b) for a, b in zip(state[1:], jax_state[1:]))
        assert params["hsv_gains"].dtype == np.int16 and params["dropout_rects"].shape == (1, 4)
        chain = cv2_ops(crop, params["hsv_gains"], int(params["blur_ksize"]), int(params["median_ksize"]),
                        params["dropout_rects"])
        np.testing.assert_array_equal(chain[-1], want["img"], err_msg=f"cv2 with the port's draws, seed {seed}")
        batch = _tensors({k: np.asarray(params[k])[None] for k in photometric.AUGMENT_KEYS if k in params})
        got = augment(torch.from_numpy(crop[None]).float(), **batch)[0].numpy()
        np.testing.assert_array_equal(got, want["img"], err_msg=f"the port's ops, seed {seed}")
        fired.update(k for k in ("blur_ksize", "median_ksize") if params[k])
        fired.update(["dropout"] if params["dropout_rects"].any() else [])
        fired.update(["hsv"] if params["hsv_gains"].any() else [])
    assert min(fired[k] for k in ("blur_ksize", "median_ksize", "dropout", "hsv")) > 0, fired


@pytest.mark.parametrize("op", ["GridDropout", "GaussNoise"])
def test_albumentation_refuses_an_op_outside_the_three(op):
    with pytest.raises(KeyError, match=op):
        Albumentation([dict(type="Blur", p=0.1), dict(type=op, p=0.5)])


def test_albumentation_refuses_another_order_and_a_fill():
    with pytest.raises(NotImplementedError, match="order"):
        Albumentation([dict(type="MedianBlur"), dict(type="Blur")])
    with pytest.raises(NotImplementedError, match="fill_value"):
        Albumentation([dict(type="CoarseDropout", fill_value=128)])
    with pytest.raises(NotImplementedError, match="TopdownAffine"):
        YOLOXHSVRandomAug()(dict(img=np.zeros((4, 4, 3), np.uint8)))


@pytest.mark.parametrize("order", [("Albumentation", "YOLOXHSVRandomAug"), ("YOLOXHSVRandomAug", "YOLOXHSVRandomAug"),
                                   ("Albumentation", "Albumentation")])
def test_photometric_transforms_refuse_another_order(order):
    """The device applies the HSV gains, then (in the body8 recipes)
    PhotometricDistortion, then Albumentation's ops, each once: a pipeline
    in another order, or with one of them twice, raises at its second
    transform."""
    build = dict(YOLOXHSVRandomAug=YOLOXHSVRandomAug,
                 Albumentation=lambda: Albumentation([dict(type="Blur", p=1.0)]))
    results = build[order[0]]()(dict(warp_mat=np.eye(2, 3, dtype=np.float32), input_size=(192, 256)))
    with pytest.raises(NotImplementedError, match="YOLOXHSVRandomAug, PhotometricDistortion, Albumentation in that "
                                                  "order"):
        build[order[1]]()(results)


# -- the recipe's pipeline --------------------------------------------------


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    return golden_jpeg_set(tmp_path_factory.mktemp("golden_jpeg"))[1]


def _dataset_cfg(ann, pipeline):
    return dict(type="CocoDataset", data_root=str(Path(ann).parent), ann_file=Path(ann).name,
                data_prefix=dict(img="imgs/"), test_mode=False, pipeline=_plain(pipeline))


def _seeded(ds, n, first=300):
    out = []
    for i in range(n):
        np.random.seed(first + i)
        out.append(ds[i])
    return out


def test_recipe_pipeline_equals_jax_on_the_golden_jpegs(golden):
    """16 instances of the golden JPEGs through the recipe's train pipeline
    in both packages, one seed a sample."""
    pipeline = RECIPE["train_pipeline"]
    n = 16
    packed = _seeded(DATASETS.build(_dataset_cfg(golden, pipeline)), n)
    unpacked = _seeded(DATASETS.build(_dataset_cfg(golden, pipeline[:-1])), n)
    ref = _seeded(jax_build(_dataset_cfg(golden, pipeline[:-1])), n)
    ref_crops = np.stack([r["img"] for r in _seeded(jax_build(_dataset_cfg(golden, pipeline[:6])), n)])
    for a, b in zip(unpacked, ref):
        for key in ("transformed_keypoints", "keypoint_weights", "keypoints_visible"):
            np.testing.assert_array_equal(np.asarray(a[key]), np.asarray(b[key]), err_msg=key)

    model = PoseModel(_narrow_model(), device="cpu")
    batch = _tensors({k: v for k, v in collate_pose_samples(packed).items() if isinstance(v, np.ndarray)})
    batch.update({k: v for k, v in collate_pose_samples(packed).items() if k.startswith("jpeg") and k not in batch})
    params = {k: batch[k] for k in photometric.AUGMENT_KEYS if k in batch}
    got = model.device_preprocess_batch(dict(batch))
    before = model.device_preprocess_batch({k: v for k, v in batch.items() if k not in params})["inputs"]
    for key in ("keypoint_x_labels", "keypoint_y_labels"):
        np.testing.assert_array_equal(got[key].numpy(), np.stack([r[key][0] for r in ref]), err_msg=key)
    np.testing.assert_array_equal(got["keypoint_weights"].numpy(), np.stack([r["keypoint_weights"][0] for r in ref]))

    want = np.stack([r["img"] for r in ref])
    disagree = torch.from_numpy((before.numpy() != ref_crops).any(-1)[:, None].astype(np.float32))
    agree = ~torch.nn.functional.max_pool2d(disagree, 7, stride=1, padding=3)[:, 0].bool().numpy()
    assert agree.mean() > 0.99, agree.mean()
    np.testing.assert_array_equal(got["inputs"].numpy()[agree], want[agree])
    # the port's ops on the JAX pipeline's own crops
    same = augment(torch.from_numpy(ref_crops).float(), **params)
    np.testing.assert_array_equal(same.numpy(), want)
    assert int((params["blur_ksize"] > 0).sum()) + int((params["median_ksize"] > 0).sum()) > 0


def test_mixed_batch_applies_each_sample_its_parameters(tmp_path, golden):
    """PNG canvases and JPEG files in one batch (as a ``CombinedDataset``
    may mix them) against each sample alone."""
    png = golden_png_set(tmp_path)[1]
    pipeline = copy.deepcopy(_plain(RECIPE["train_pipeline"]))
    pipeline[7]["transforms"][0]["p"] = pipeline[7]["transforms"][1]["p"] = 0.7
    samples = []
    for i, ann in enumerate((png, golden, png, golden, golden)):
        np.random.seed(40 + i)
        samples.append(DATASETS.build(_dataset_cfg(ann, pipeline))[3 * i])
    model = PoseModel(_narrow_model(), device="cpu")

    def inputs(group):
        batch = collate_pose_samples(group)
        arrays = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v) for k, v in batch.items()
                  if k != "data_samples"}
        return model.device_preprocess_batch(arrays)["inputs"]

    mixed = inputs(samples)
    assert mixed.shape == (5, 256, 192, 3)
    for i, sample in enumerate(samples):
        torch.testing.assert_close(mixed[i], inputs([sample])[0], rtol=0, atol=0)
    batch = collate_pose_samples(samples)
    assert batch["hsv_gains"].shape == (5, 3) and batch["dropout_rects"].shape == (5, 1, 4)
    assert batch["blur_ksize"].any() and batch["median_ksize"].any()


# -- the stage-2 switch and tools.train -------------------------------------


def test_pipeline_switch_reaches_kept_workers(tmp_path):
    """Three epochs of the recipe over the mini COCO set, the switch before
    the second: two kept workers give the batches made in process; the
    switched batches differ from unswitched ones."""
    ann = mini_coco_set(tmp_path)
    stage2 = _plain(RECIPE["train_pipeline_stage2"])

    def run(num_workers, switch=True):
        loader = DataLoader(DATASETS.build(_dataset_cfg(ann, RECIPE["train_pipeline"])), 4, shuffle=True,
                            drop_last=True, num_workers=num_workers, seed=3, with_data_samples=False,
                            persistent_workers=True)
        runner = SimpleNamespace(train_loader=loader, log=lambda msg: None)
        hook = PipelineSwitchHook(switch_epoch=1 if switch else 99, switch_pipeline=stage2)
        epochs = []
        try:
            for epoch in range(3):
                hook.before_train_epoch(runner, epoch)
                loader.set_epoch(epoch)
                epochs.append(list(loader))
        finally:
            loader.close()
        return epochs

    try:
        here, kept, unswitched = run(0), run(2), run(0, switch=False)
    finally:
        stop_workers()
    for epoch, (a, b) in enumerate(zip(here, kept)):
        assert len(a) == len(b) == 3
        for x, y in zip(a, b):
            assert set(x) == set(y)
            for key in x:
                if isinstance(x[key], np.ndarray):
                    np.testing.assert_array_equal(x[key], y[key], err_msg=f"epoch {epoch} {key}")
    same = [np.array_equal(x["warp_mat"], y["warp_mat"]) for e in (1, 2) for x, y in zip(here[e], unswitched[e])]
    assert np.array_equal(here[0][0]["warp_mat"], unswitched[0][0]["warp_mat"]) and not all(same)


def _train_options(recipe, root, ann):
    data = ["train_dataloader.num_workers=0", "train_dataloader.batch_size=6",
            f"val_dataloader.dataset.data_root={root}", f"val_dataloader.dataset.ann_file={ann.name}",
            "val_dataloader.dataset.data_prefix.img=imgs/", "val_dataloader.dataset.bbox_file=None",
            "val_dataloader.num_workers=0", f"val_evaluator.ann_file={ann}"]
    if recipe == "aic_coco":
        aic_from_coco(ann, root / "aic.json")
        for i, name in enumerate((ann.name, "aic.json")):
            data += [f"train_dataloader.dataset.datasets.{i}.data_root={root}",
                     f"train_dataloader.dataset.datasets.{i}.ann_file={name}",
                     f"train_dataloader.dataset.datasets.{i}.data_prefix.img=imgs/"]
    else:
        data += [f"train_dataloader.dataset.data_root={root}", f"train_dataloader.dataset.ann_file={ann.name}",
                 "train_dataloader.dataset.data_prefix.img=imgs/"]
    return NARROW + data + ["train_cfg.max_epochs=2", "train_cfg.val_interval=2", "custom_hooks.1.switch_epoch=1",
                            "default_hooks.logger.interval=1", "default_hooks.checkpoint.interval=1"]


def _train(recipe, root, *extra):
    """``tools.train`` on the recipe over the mini COCO set under ``root``
    (and its AIC copy), narrowed, on the CPU."""
    ann = root / "data" / "ann.json"
    if not ann.exists():
        mini_coco_set(ann.parent)
    config = RTMPOSE if recipe == "coco" else AIC_COCO
    options = _train_options(recipe, ann.parent, ann)
    flags = [o for o in extra if o.startswith("--")]
    options += [o for o in extra if not o.startswith("--")]
    return train_cli.main([str(config), "--work-dir", str(root / "work"), "--device", "cpu", *flags,
                           "--cfg-options", *options])


@pytest.fixture(scope="module")
def straight(tmp_path_factory):
    root = tmp_path_factory.mktemp("straight")
    return root, _train("coco", root)


def _first_step_equals_make_train_step(runner):
    """The first step again, through make_train_step on the same batch (from
    a new loader: the runner's dataset now holds the stage-2 pipeline)."""
    cfg = runner.cfg
    model = PoseModel(cfg["model"], metainfo=runner.metainfo, device="cpu")
    model.init_weights(seed=0)
    optimizer, _ = build_optimizer(model, cfg["optim_wrapper"], cfg["param_scheduler"], len(runner.train_loader),
                                   runner.max_epochs)
    batch = runner.to_device(runner.build_train_loader().load(0, 0))
    _, metrics = make_train_step(model, optimizer)(create_train_state(model, optimizer), batch,
                                                   torch.Generator().manual_seed(cfg["seed"]))
    direct = {k: float(v) for k, v in metrics.items()}
    assert {k: runner.train_log[0][k] for k in direct} == direct
    return direct


@pytest.mark.parametrize("recipe", ["coco", "aic_coco"])
def test_tools_train_runs_the_recipe_across_the_switch(recipe, straight, tmp_path):
    root, runner = straight if recipe == "coco" else (tmp_path, _train(recipe, tmp_path))
    work = root / "work"
    steps = 2 if recipe == "coco" else 4  # 12 COCO instances (and 12 AIC) in batches of 6
    assert runner.state.step == 2 * steps and len(runner.train_log) == 2 * steps
    log = (work / "train.log").read_text()
    assert "pipeline switch at epoch 1" in log and log.count("val: coco/") == 1
    assert {"epoch_1.pth", "epoch_2.pth"} <= {p.name for p in work.iterdir()}
    assert all(np.isfinite(v) for entry in runner.train_log for v in entry.values())
    assert all(t["augment"] > 0 for t in runner.train_times)
    ema = runner.hooks[0]
    assert type(ema).__name__ == "EMAHook" and ema.update_buffers and ema.ema_buffers
    direct = _first_step_equals_make_train_step(runner)
    scalars = [json.loads(line) for line in (work / "vis_data" / "scalars.json").read_text().splitlines()]
    assert scalars[0]["train/loss_kpt"] == direct["loss_kpt"]


def test_resume_across_the_switch_equals_straight(straight, tmp_path):
    """One epoch, then ``--resume`` for the second (the switch comes first
    in the resumed run): the live weights, the EMA's average, the Adam
    moments and the last loss dict equal two epochs straight, bitwise. The
    checkpoint holds the average as its weights and the live weights as
    ``ema_state_dict``, as mmengine's EMAHook writes them."""
    _, runner = straight
    first = _train("coco", tmp_path, "train_cfg.max_epochs=1")
    assert first.state.step == 2
    ckpt = read_checkpoint(str(tmp_path / "work" / "epoch_1.pth"))
    live = first.model.module.state_dict()
    assert all(torch.equal(ckpt["ema_state_dict"][k], live[k]) for k in ckpt["ema_state_dict"])
    assert not all(torch.equal(ckpt["state_dict"][k], live[k]) for k in ckpt["ema_state_dict"])
    resumed = _train("coco", tmp_path, "--resume")
    assert "pipeline switch at epoch 1" in (tmp_path / "work" / "train.log").read_text()
    assert resumed.state.step == runner.state.step == 4 and resumed.train_log[-1] == runner.train_log[-1]
    a, b = runner.model.module.state_dict(), resumed.model.module.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    for x, y in ((runner.hooks[0], resumed.hooks[0]), (runner.state.opt_state, resumed.state.opt_state)):
        pairs = zip(x.ema_params + x.ema_buffers, y.ema_params + y.ema_buffers) if hasattr(x, "ema_params") \
            else zip(x.mu + x.nu, y.mu + y.nu)
        assert all(torch.equal(u, v) for u, v in pairs)
