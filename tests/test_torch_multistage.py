"""HourglassNet, CPM, MSPN / RSN, CPMHead, MSPNHead and the Megvii decode on
the CPU: the port against the JAX package on the same weights and inputs.

The weights are the JAX module's variables drawn by NumPy from a seed
(``tests/test_torch_cnn_backbones.py:jax_variables``), carried to the port by
``state_dict_from_jax`` and loaded with ``strict=True``; the inputs are drawn
by NumPy and fed to both. The models are narrow: two stacks or stages, 16-32
channels (CPM's stem is at full width: the module has no width option).

The hourglass runs only at even sides (its 2x repeat meets the skip), where
the JAX stem conv's "SAME" padding is (2, 3) and the port's mmpose's (3, 3):
it is held with JAX's padding put in front of the port's stem conv here in the
test (``chip_smoke.jax_same_padding``), and one test shows the departure.
MSPN and RSN are held at 33 x 33, where their one strided "SAME" conv (the 7x7
``top``) sees an odd side and the two agree, with ``out_shape`` the largest
unit's size (every resize an upsampling). CPM pads explicitly and agrees at
any side. The JAX side runs jitted without XLA's backend optimisations
(``jax_run``).

Bars, with their reasons (``tests/test_torch_cnn_backbones.py``'s): features
and heatmaps within 1e-5 of the JAX output's largest value (f32 on both
sides, summation order); MSRA keypoints 1e-3 heatmap pixels (the JAX
package's bar for a decode) and scores 1e-5; in training mode, in f64 on both
sides (BatchNorm networks' gradients at two small crops move 1-4% between two
right f32 implementations, ``tests/test_torch_cnn_backbones.py``), the loss within 1e-5 relative,
each parameter's gradient within 1e-5 of its own l2 norm and the running
statistics within 1e-5 of their largest value; the losses 1e-6 relative; the
Megvii decode's keypoints 1e-3 input pixels and scores 1e-6 against the
codec's own NumPy decode (its blur in f64, the port's in f32).
"""

import copy
import re
import tempfile
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import HOURGLASS_FIXTURE, MSPN_FIXTURE, jax_same_padding, model_fixture_report
from probpose_code_torch.apis import inference_topdown, init_model
from probpose_code_torch.apis.inference import crop_batch
from probpose_code_torch.config import Config
from probpose_code_torch.datasets import config_metainfo
from probpose_code_torch.datasets.metainfo import parse_pose_metainfo
from probpose_code_torch.engine.checkpoint import state_dict_from_jax
from probpose_code_torch.engine.optim import build_optimizer
from probpose_code_torch.engine.runner import Runner
from probpose_code_torch.models.builder import PoseModel
from probpose_code_torch.models.heads.multistage_heads import cpm_head_loss, mspn_head_loss
from probpose_code_torch.models.losses import KeypointMSELoss
from probpose_code_torch.ops.decode import megvii_decode_batch
from probpose_code_torch.registry import DATASETS
from probpose_code_tpu.codecs import MegviiHeatmap
from probpose_code_tpu.models import PoseModel as JaxPoseModel
from probpose_code_tpu.models.heads import multistage_heads as jheads
from probpose_code_tpu.models.losses.heatmap_loss import KeypointMSELoss as JaxKeypointMSELoss
from tests.test_torch_classic_heatmap import _smooth_crops
from tests.test_torch_cnn_backbones import _np, jax_run, jax_variables, port_in_float64

ROOT = Path(__file__).resolve().parents[1]
META = {"flip_indices": [0, 2, 1, 4, 3, 6, 5, 8, 7, 10, 9, 12, 11, 14, 13, 16, 15], "num_keypoints": 17}
REL = 1e-5
_MSE = dict(type="KeypointMSELoss", use_target_weight=True)
_PRE = dict(type="PoseDataPreprocessor", mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375],
            bgr_to_rgb=True)


def _model(backbone, head, input_size, heatmap_size, codec="MSRAHeatmap"):
    decoder = dict(type=codec, input_size=input_size, heatmap_size=heatmap_size)
    decoder.update(sigma=2) if codec == "MSRAHeatmap" else decoder.update(kernel_size=5)
    return dict(type="TopdownPoseEstimator", data_preprocessor=_PRE, backbone=backbone,
                head=dict(head, loss=_MSE, decoder=decoder), test_cfg=dict(flip_test=True))


MODELS = {
    "hourglass": (_model(dict(type="HourglassNet", num_stacks=2, downsample_times=2, stage_channels=(16, 16, 24),
                              stage_blocks=(1, 1, 2), feat_channel=16),
                         dict(type="CPMHead", in_channels=16, out_channels=17, num_stages=2,
                              deconv_out_channels=(8,)), (64, 64), (32, 32)), (64, 64)),
    "cpm": (_model(dict(type="CPM", out_channels=17, num_stages=3, feat_channels=16, middle_channels=8),
                   dict(type="CPMHead", in_channels=17, out_channels=17, num_stages=3), (48, 64), (6, 8)),
            (64, 48)),
    "mspn": (_model(dict(type="MSPN", unit_channels=16, num_stages=2, num_units=4, num_blocks=(1, 2, 1, 1),
                         res_top_channels=8),
                    dict(type="MSPNHead", num_stages=2, num_units=4, out_shape=(9, 9), unit_channels=16,
                         out_channels=17, level_indices=[0, 1, 2, 3, 1, 2, 3, 3]), (33, 33), (9, 9)), (33, 33)),
    "rsn": (_model(dict(type="RSN", unit_channels=16, num_stages=2, num_units=4, num_blocks=(1, 1, 1, 1),
                        res_top_channels=8, expand_times=8, num_steps=3),
                   dict(type="MSPNHead", num_stages=2, num_units=4, out_shape=(9, 9), unit_channels=16,
                        out_channels=17, use_prm=True, level_indices=[0, 1, 2, 3, 1, 2, 3, 3]),
                   (33, 33), (9, 9), codec="MegviiHeatmap"), (33, 33)),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tier-1 runs six test workers at once; one torch thread each."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def both_models(name, seed, cfg=None):
    """(port model, JAX model, JAX variables) of ``MODELS[name]`` on one set of
    weights; the hourglass's stem padded as JAX pads it."""
    cfg = cfg or MODELS[name][0]
    h, w = MODELS[name][1]
    jm = JaxPoseModel(cfg, metainfo=META)
    variables = jax_variables(jm.module, (1, h, w, 3), seed)
    ours = PoseModel(cfg, metainfo=META, device="cpu")
    ours.module.load_state_dict(state_dict_from_jax(variables), strict=True)
    if name == "hourglass":
        jax_same_padding(ours.module.backbone.stem[0])
    return ours, jm, variables


_PREDICTS = {}


def predicts(name, seed):
    """(port model, JAX model, JAX variables, the port's predict, the JAX
    predict) on two crops, made once a module."""
    if (name, seed) not in _PREDICTS:
        ours, jm, variables = both_models(name, seed)
        crops = _crops(2, MODELS[name][1], seed=seed + 1)
        ref = {k: np.asarray(v) for k, v in jax_run(jm.make_predict(jit=False), variables, crops).items()}
        _PREDICTS[name, seed] = ours, jm, variables, crops, ours.predict(torch.from_numpy(crops)), ref
    return _PREDICTS[name, seed]


def _crops(n, side, seed):
    return np.round(np.random.RandomState(seed).rand(n, *side, 3) * 255).astype(np.float32)


def assert_maps(got, want):
    got = got if isinstance(got, (list, tuple)) else [got]
    want = want if isinstance(want, (list, tuple)) else [want]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        assert np.abs(g.detach().numpy() - w).max() < REL * np.abs(w).max()


# -- each model's outputs, features and predict ------------------------------------------


@pytest.mark.parametrize("name", list(MODELS))
def test_model_matches_jax(name):
    """Each stage's (and unit's) heatmaps of the estimator, the backbone's
    features, and the predict program with flip-TTA and the decode (MSRA, or
    for the RSN the Megvii decode against the codec's, see
    ``test_megvii_predict_departs_from_jax``)."""
    ours, jm, variables, crops, got, ref = predicts(name, seed=3)
    side = MODELS[name][1]
    with torch.no_grad():
        x = ours.preprocess(torch.from_numpy(crops))
        feats = ours.module.backbone(x.permute(0, 3, 1, 2))
        outs = ours.module.head(feats)

    def jax_both(v, crops):
        feats = jm.module.apply(v, jm.preprocess(crops), method=lambda m, x: m.backbone(x, train=False))
        return feats, jm.module.apply(v, jm.preprocess(crops), train=False)

    want, want_outs = jax_run(jax_both, variables, crops)
    assert_maps(outs, want_outs)
    if name in ("mspn", "rsn"):  # a list over stages of lists over units
        assert [len(f) for f in feats] == [len(f) for f in want] == [4, 4]
        feats, want = sum(feats, []), sum(want, [])
    assert_maps(feats, [np.transpose(np.asarray(w), (0, 3, 1, 2)) for w in want])
    assert_maps(got["heatmaps"], ref["heatmaps"])
    if name == "rsn":
        return
    H, W = ref["heatmaps"].shape[2:]
    np.testing.assert_allclose(got["keypoints"].numpy(), ref["keypoints"], atol=1e-3 * side[1] / W)
    np.testing.assert_allclose(got["keypoint_scores"].numpy(), ref["keypoint_scores"], atol=1e-5)


def test_hourglass_stem_padding_departs_from_jax_at_an_even_side():
    """Without the test's substitution the port's stem conv pads (3, 3) as
    mmpose does and the JAX module's "SAME" (2, 3): at 64 x 64 the features
    differ by far more than the bar."""
    cfg, (h, w) = MODELS["hourglass"]
    jm = JaxPoseModel(cfg, metainfo=META)
    variables = jax_variables(jm.module, (1, h, w, 3), seed=5)
    ours = PoseModel(cfg, metainfo=META, device="cpu")
    ours.module.load_state_dict(state_dict_from_jax(variables), strict=True)
    assert ours.module.backbone.stem[0].conv.padding == (3, 3)
    crops = _crops(1, (h, w), seed=6)
    want = np.asarray(jax_run(lambda v, c: jm.forward(v, c)[-1], variables, crops))
    with torch.no_grad():
        got = ours.module(ours.preprocess(torch.from_numpy(crops)))[-1].numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() > 1e-2 * np.abs(want).max()


# -- training mode --------------------------------------------------------------------


@pytest.mark.parametrize("name", ["hourglass", "cpm"])
def test_training_step_matches_jax(name):
    """One training step of two smooth crops with BatchNorm in training mode
    and ``sum_stages mean(w * out ** 2)`` as the loss (``w`` drawn from a
    seed): the loss, every parameter's gradient and the updated running
    statistics, in f64 on both sides (the JAX modules' ``dtype``, the port's
    convolutions and its f32 casts, ``port_in_float64``)."""
    cfg, side = MODELS[name]
    side = (32, 24) if name == "cpm" else side
    cfg64 = copy.deepcopy(cfg)
    cfg64["backbone"]["dtype"] = cfg64["head"]["dtype"] = jnp.float64
    x = ((_smooth_crops(2, 22, size=side) - 127.5) / 60).astype(np.float64)
    with jax.enable_x64(True), port_in_float64():
        jm = JaxPoseModel(cfg64, metainfo=META)
        variables = jax.tree_util.tree_map(lambda a: a.astype(np.float64),
                                           jax_variables(jm.module, (1, *side, 3), 21))
        ours = PoseModel(cfg, metainfo=META, device="cpu")
        ours.module.load_state_dict(state_dict_from_jax(variables), strict=True)
        ours.module.double().train()
        ours.module.backbone.dtype = torch.float64
        if name == "hourglass":
            jax_same_padding(ours.module.backbone.stem[0])
        shapes = [o.shape for o in jax.eval_shape(lambda v: jm.module.apply(v, x, train=False), variables)]
        ws = [np.random.RandomState(23 + i).uniform(0.5, 1.5, s) for i, s in enumerate(shapes)]

        def jax_loss(params):
            outs, new = jm.module.apply({"params": params, "batch_stats": variables["batch_stats"]}, x, train=True,
                                        mutable=["batch_stats"])
            return sum(jnp.mean(w * o ** 2) for w, o in zip(ws, outs)), new

        (loss, new), grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(variables["params"])
        outs = ours.module(torch.from_numpy(x))
        ours_loss = sum((torch.from_numpy(w) * o ** 2).mean() for w, o in zip(ws, outs))
        ours_loss.backward()
        want = state_dict_from_jax({"params": _np(grads), "batch_stats": _np(new["batch_stats"])})
    assert outs[-1].dtype == torch.float64
    assert float(ours_loss.detach()) == pytest.approx(float(loss), rel=1e-5)
    for key, p in ours.module.named_parameters():
        w = want[key].numpy()
        assert np.linalg.norm(p.grad.numpy() - w) <= 1e-5 * np.linalg.norm(w), key
    for key, buf in ours.module.named_buffers():
        if key.endswith(("running_mean", "running_var")):
            w = want[key].numpy()
            assert np.abs(buf.numpy() - w).max() <= 1e-5 * np.abs(w).max(), key


def test_cpm_head_loss_matches_jax():
    """``cpm_head_loss``: each stage's MSE against the one target, summed."""
    rng = np.random.RandomState(1)
    outs = [rng.randn(3, 17, 8, 6).astype(np.float32) for _ in range(4)]
    batch = dict(heatmaps=rng.rand(3, 17, 8, 6).astype(np.float32),
                 keypoint_weights=rng.randint(0, 2, (3, 17)).astype(np.float32))
    want = jheads.cpm_head_loss([jnp.asarray(o) for o in outs], {k: jnp.asarray(v) for k, v in batch.items()},
                                JaxKeypointMSELoss(use_target_weight=True))
    got = cpm_head_loss([torch.from_numpy(o) for o in outs], {k: torch.from_numpy(v) for k, v in batch.items()},
                        KeypointMSELoss(use_target_weight=True))
    assert float(got["loss_kpt"]) == pytest.approx(float(want["loss_kpt"]), rel=1e-6)


def test_mspn_head_loss_matches_jax():
    """``mspn_head_loss`` on synthetic multi-level targets: each (stage, unit)
    map against the level ``level_indices`` picks, with that level's
    weights."""
    rng = np.random.RandomState(2)
    levels = [0, 1, 2, 3, 1, 2, 3, 3]
    outs = [rng.randn(2, 17, 16, 12).astype(np.float32) for _ in levels]
    targets = [rng.rand(2, 17, 16, 12).astype(np.float32) for _ in range(4)]
    weights = rng.randint(0, 2, (2, 4, 17)).astype(np.float32)
    want = jheads.mspn_head_loss([jnp.asarray(o) for o in outs], dict(
        multilevel_heatmaps=[jnp.asarray(t) for t in targets], multilevel_keypoint_weights=jnp.asarray(weights)),
        JaxKeypointMSELoss(use_target_weight=True), levels)
    got = mspn_head_loss([torch.from_numpy(o) for o in outs], dict(
        multilevel_heatmaps=[torch.from_numpy(t) for t in targets],
        multilevel_keypoint_weights=torch.from_numpy(weights)), KeypointMSELoss(use_target_weight=True), levels)
    assert float(got["loss_kpt"]) == pytest.approx(float(want["loss_kpt"]), rel=1e-6)


RSN18 = "configs/body_2d_keypoint/topdown_heatmap/coco/td-hm_rsn18_8xb32-210e_coco-256x192.py"


def test_mspn_training_is_refused_as_the_jax_package_cannot_train_it():
    """The JAX package's MSPN / RSN loss reads ``multilevel_heatmaps``, which
    no codec of it makes (its collate ships ``heatmaps``): its loss on such a
    batch raises ``KeyError``. The port refuses the step and ``tools.train``
    (``Runner.train``) by the head's name before reading any data."""
    cfg, side = MODELS["rsn"]
    jm = JaxPoseModel(cfg, metainfo=META)
    variables = jax_variables(jm.module, (1, *side, 3), seed=9)
    batch = dict(inputs=_crops(2, side, seed=10), heatmaps=np.zeros((2, 17, 9, 9), np.float32),
                 keypoint_weights=np.ones((2, 17), np.float32))
    with pytest.raises(KeyError, match="multilevel_heatmaps"):
        jax.jit(jm.loss_fn)(variables, {k: jnp.asarray(v) for k, v in batch.items()})
    ours = PoseModel(cfg, metainfo=META, device="cpu")
    with pytest.raises(NotImplementedError, match="MSPN / RSN training"):
        ours.loss_fn({k: torch.from_numpy(v) for k, v in batch.items()})
    with tempfile.TemporaryDirectory() as tmp:
        runner = Runner(Config.fromfile(str(ROOT / RSN18)), device="cpu", work_dir=tmp)
        with pytest.raises(NotImplementedError, match="MSPN / RSN training"):
            runner.train()
        assert runner.train_loader is None


# -- the Megvii decode --------------------------------------------------------------------


def _megvii_maps(seed, B=3, K=17, H=16, W=12):
    """Smooth random maps with peaks at each kind of place: inside, on the
    border rows and columns, one in from them, and maps with no positive
    value."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:H, :W]
    maps = np.zeros((B, K, H, W), np.float32)
    for b in range(B):
        for k in range(K):
            px, py = rng.randint(0, W), rng.randint(0, H)
            if k < 4:
                px, py = [(0, 5), (W - 1, 7), (1, 1), (W - 2, H - 2)][k]
            maps[b, k] = 200 * np.exp(-((xx - px) ** 2 + (yy - py) ** 2) / rng.uniform(2, 8)) + rng.rand(H, W)
    maps[0, 5] = -maps[0, 5]
    return maps


def test_megvii_decode_matches_the_codec():
    """The batched decode against ``MegviiHeatmap.decode``, map by map."""
    maps = _megvii_maps(seed=4)
    codec = MegviiHeatmap(input_size=(48, 64), heatmap_size=(12, 16), kernel_size=5)
    kpts, scores = megvii_decode_batch(torch.from_numpy(maps), 5, (48, 64))
    for b in range(len(maps)):
        want_k, want_s = codec.decode(maps[b])
        np.testing.assert_allclose(kpts[b].numpy(), want_k[0], atol=1e-3)
        np.testing.assert_allclose(scores[b].numpy(), want_s[0], rtol=1e-6)


def test_megvii_predict_departs_from_jax():
    """The JAX predict sends the Megvii codec down its UDP branch
    (``probpose_code_tpu/models/builder.py:901-904``: argmax and DARK-UDP,
    input / (W - 1)); the port decodes as the codec does. On the RSN's
    flip-averaged maps the port's keypoints and scores are the codec's
    decode of the JAX maps, and the JAX predict's are not."""
    _, _, _, _, got, ref = predicts("rsn", seed=3)
    codec = MegviiHeatmap(input_size=(33, 33), heatmap_size=(9, 9), kernel_size=5)
    decoded = [codec.decode(m) for m in ref["heatmaps"]]
    want_k = np.concatenate([k for k, _ in decoded])
    want_s = np.concatenate([s for _, s in decoded])
    np.testing.assert_allclose(got["keypoints"].numpy(), want_k, atol=1e-3)
    np.testing.assert_allclose(got["keypoint_scores"].numpy(), want_s, rtol=1e-5)
    assert np.abs(ref["keypoints"] - want_k).max() > 0.5
    assert np.abs(ref["keypoint_scores"] - want_s).max() > 0.5


# -- init_model -> inference_topdown ----------------------------------------------------------


@pytest.mark.parametrize("fixture", [HOURGLASS_FIXTURE, MSPN_FIXTURE], ids=lambda f: f["name"])
def test_fixture_through_inference_topdown_and_coco_metric(fixture):
    """``chip_smoke.model_fixture_report``, the card's ``multistage_golden``
    check, on the CPU: ``init_model`` with the fixture's weights (strict; the
    hourglass's stem padded as JAX pads it), ``inference_topdown`` over the
    golden images, ``CocoMetric``; the maps of the fixture's crops against
    the JAX package's. The CPM fixture (its full-width stem at 256 x 192 too
    slow for the CPU here) is held on the card only; CPM's path is held by
    ``test_cpm_through_inference_topdown``."""
    report = model_fixture_report(fixture, device="cpu")
    assert report["instances"] == 62 and report["sane"] > 0.97, report
    assert report["p99"] < 1.0 and report["over_5px"] <= 1, report
    assert report["scores"] < 2e-3 and report["d_AP"] < 0.01, report
    assert report["outputs_rel"] < 1e-4, report
    assert report["ok"]


def test_cpm_through_inference_topdown():
    """CPM (``MODELS["cpm"]`` at 48 x 64) through ``init_model`` with a
    weights file and ``inference_topdown`` on two boxes of an image: the
    keypoints in the image and scores against the JAX predict's on the same
    crops, mapped as ``attach_predictions`` maps them."""
    ours, jm, variables = both_models("cpm", seed=11)
    cfg = dict(model=MODELS["cpm"][0], test_dataloader=dict(dataset=dict(pipeline=[
        dict(type="LoadImage"), dict(type="GetBBoxCenterScale"), dict(type="TopdownAffine", input_size=(48, 64)),
        dict(type="PackPoseInputs")])))
    img = np.round(np.random.RandomState(12).rand(120, 100, 3) * 255).astype(np.uint8)
    boxes = np.array([[10, 5, 90, 110], [0, 20, 60, 80]], np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp, "cpm.pth")
        torch.save(ours.module.state_dict(), path)
        model = init_model(Config(cfg), checkpoint=str(path), device="cpu")
    samples = inference_topdown(model, img, boxes)
    crops, centers, scales = crop_batch(img, boxes, (48, 64), "cpu", model.cfg_full)
    ref = {k: np.asarray(v) for k, v in jax_run(jm.make_predict(jit=False), variables, crops.numpy()).items()}
    want = ref["keypoints"] / np.float32([48, 64]) * scales[:, None] + centers[:, None] - 0.5 * scales[:, None]
    got = np.stack([s.pred_instances.keypoints[0] for s in samples])
    np.testing.assert_allclose(got, want, atol=1e-3 * float(scales.max()) / 6)
    np.testing.assert_allclose(np.stack([s.pred_instances.keypoint_scores[0] for s in samples]),
                               ref["keypoint_scores"], atol=1e-5)


# -- every shipped config ----------------------------------------------------------------


FAMILIES = ("HourglassNet", "CPM", "MSPN", "RSN")
CONFIGS = sorted(str(p.relative_to(ROOT)) for p in (ROOT / "configs").rglob("*.py")
                 if re.search(r"backbone=dict\(\s*type=[\"'](%s)[\"']" % "|".join(FAMILIES), p.read_text())
                 and "TopdownPoseEstimator" in p.read_text())


def test_the_families_count():
    """12 hourglass, 8 CPM and 8 MSPN / RSN configs are top-down; the
    bottom-up hourglass (associative embedding) waits for the bottom-up
    slice."""
    names = [Path(c).name for c in CONFIGS]
    assert (sum("hourglass" in n for n in names), sum("cpm" in n for n in names),
            sum("mspn" in n or "rsn" in n for n in names)) == (12, 8, 8)
    assert not any("associative_embedding" in c for c in CONFIGS)


@pytest.mark.parametrize("config", CONFIGS)
def test_shipped_config_builds_in_the_port(config):
    """Each shipped top-down config of the families through
    ``init_model(..., device="cpu")`` at its full depth and width, without a
    forward: the model, its datasets' classes and tables (keypoints the
    head's outputs) and the optimizer."""
    cfg = Config.fromfile(str(ROOT / config))
    with mock.patch.object(torch.nn.modules.conv._ConvNd, "reset_parameters", lambda self: None):
        model = init_model(cfg, device="cpu")
    K = cfg["model"]["head"]["out_channels"]
    assert model.metainfo["num_keypoints"] == K
    for loader in ("train_dataloader", "val_dataloader", "test_dataloader"):
        dataset = cfg[loader]["dataset"]
        assert DATASETS.get(dataset["type"]) is not None, dataset["type"]
        assert parse_pose_metainfo(config_metainfo(dataset))["num_keypoints"] == K, loader
    build_optimizer(model, cfg["optim_wrapper"], cfg["param_scheduler"], 10, cfg["train_cfg"]["max_epochs"])
