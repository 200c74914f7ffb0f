"""SimCCHead, RTMW (CSPNeXtPAFPN, RTMWHead) and the cocktail14 datasets on
the CPU: the port against the JAX package on the same weights and inputs.

The weights are the JAX module's variables drawn by NumPy from a seed
(``tests/test_torch_cnn_backbones.py:jax_variables``), carried to the port by
``state_dict_from_jax`` and loaded with ``strict=True``, or, for the round
trip, the port's own seeded weights read by the JAX package's converter
(``convert_torch_state_dict``: ``convert_torch_cspnext_pafpn``,
``_convert_rtmw_head``). The models are narrow (ResNet-18 of width 4 to 32,
CSPNeXt of widen 0.125 and a GAU of 32 / 16); RTMW's neck takes
``in_channels`` narrower than the backbone's widths, as RTMW-m's config does.

The JAX ``TopdownPoseEstimator`` calls its neck without ``train``
(``probpose_code_tpu/models/pose_estimators/topdown.py:65-66``), so RTMW's
neck runs its BatchNorm on the running statistics in training and never
updates them; the port trains it as mmpose does (one test shows the
departure; the gradient test holds the port with its neck in evaluation
mode, as the JAX package runs it).

Bars, with their reasons (``tests/test_torch_rtmpose.py``'s and
``tests/test_torch_cnn_backbones.py``'s): features and SimCC vectors within
1e-5 of the JAX output's largest value (f32 on both sides, summation order);
the SimCC decode's keypoints exact but where two top bins lie within
``chip_smoke.SIMCC_TIE_REL`` (none on these inputs), scores 1e-5; in
training mode, in f64 on both sides, the loss within 1e-5 relative, each
parameter's gradient within 1e-5 of its own l2 norm and the running
statistics within 1e-5 of their largest value.
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

from chip_smoke import RTMW_FIXTURE, cocktail14_sets, interhand_set_from_coco, mini_coco_set, model_fixture_report
from probpose_code_torch.apis import inference_topdown, init_model
from probpose_code_torch.apis.inference import crop_batch
from probpose_code_torch.config import Config
from probpose_code_torch.datasets import config_metainfo
from probpose_code_torch.datasets.metainfo import parse_pose_metainfo
from probpose_code_torch.engine.checkpoint import state_dict_from_jax
from probpose_code_torch.engine.optim import build_optimizer
from probpose_code_torch.models.builder import PoseModel
from probpose_code_torch.registry import DATASETS
from probpose_code_torch.tools import test as test_cli
from probpose_code_torch.tools import train as train_cli
from probpose_code_tpu.datasets.metainfo import parse_pose_metainfo as jax_parse_pose_metainfo
from probpose_code_tpu.engine.checkpoint import convert_torch_state_dict
from probpose_code_tpu.models import PoseModel as JaxPoseModel
from probpose_code_tpu.models.heads.rtmcc_head import _pixel_shuffle
from tests.test_torch_body8 import _jax_pad_to_contain
from tests.test_torch_classic_heatmap import _smooth_crops
from tests.test_torch_cnn_backbones import _np, jax_run, jax_variables, port_in_float64
from tests.test_torch_datasets import assert_same, jax_build
from tests.test_torch_rtmpose_train import _first_step_equals_make_train_step

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "golden"
RTMW = ROOT / "configs/wholebody_2d_keypoint/rtmpose/cocktail14/rtmw-m_8xb1024-270e_cocktail14-256x192.py"
META = {"flip_indices": [0, 2, 1, 4, 3, 6, 5, 8, 7, 10, 9, 12, 11, 14, 13, 16, 15], "num_keypoints": 17}
REL = 1e-5
_PRE = dict(type="PoseDataPreprocessor", mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375],
            bgr_to_rgb=True)
_KLD = dict(type="KLDiscretLoss", use_target_weight=True, beta=10.0, label_softmax=True)


def _simcc(deconv, input_size=(64, 64)):
    """A narrow ResNet-18 with SimCCHead, its config's ``in_featuremap_size``
    (6, 8) whatever the map (the head measures it, as the flax head reads
    it from the data)."""
    return dict(type="TopdownPoseEstimator", data_preprocessor=_PRE,
                backbone=dict(type="ResNet", depth=18, stem_channels=8, base_channels=4, out_indices=(3,)),
                head=dict(type="SimCCHead", in_channels=32, out_channels=17, input_size=input_size,
                          in_featuremap_size=(6, 8), deconv_out_channels=deconv, loss=_KLD,
                          decoder=dict(type="SimCCLabel", input_size=input_size, sigma=6.0, simcc_split_ratio=2.0)),
                test_cfg=dict(flip_test=True))


def _rtmw(input_size=(64, 64), keypoints=17):
    """RTMW_FIXTURE's narrow model (``in_channels`` [48, 96] beside CSPNeXt's
    64 and 128 channels)."""
    cfg = copy.deepcopy(RTMW_FIXTURE["cfg"]["model"])
    w, h = input_size
    cfg["head"].update(input_size=input_size, out_channels=keypoints, in_featuremap_size=(w // 32, h // 32),
                       decoder=dict(cfg["head"]["decoder"], input_size=input_size))
    return cfg


MODELS = {"simcc": (_simcc((8, 8)), (64, 64)), "simcc_wo_deconv": (_simcc(None), (64, 64)),
          "rtmw": (_rtmw(), (64, 64))}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tier-1 runs six test workers at once; one torch thread each."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def both_models(name, seed):
    """(port model, JAX model, JAX variables) of ``MODELS[name]`` on one set of weights."""
    cfg, (h, w) = MODELS[name]
    jm = JaxPoseModel(cfg, metainfo=META)
    variables = jax_variables(jm.module, (1, h, w, 3), seed)
    ours = PoseModel(cfg, metainfo=META, device="cpu")
    ours.module.load_state_dict(state_dict_from_jax(variables), strict=True)
    return ours, jm, variables


def _crops(n, side, seed):
    return np.round(np.random.RandomState(seed).rand(n, *side, 3) * 255).astype(np.float32)


def assert_close(got, want):
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        assert np.abs(g.detach().numpy() - w).max() < REL * np.abs(w).max()


def assert_simcc_predict(got, ref):
    assert_close([got["keypoint_x_labels"], got["keypoint_y_labels"]],
                 [ref["keypoint_x_labels"], ref["keypoint_y_labels"]])
    np.testing.assert_array_equal(got["keypoints"].numpy(), ref["keypoints"])
    np.testing.assert_allclose(got["keypoint_scores"].numpy(), ref["keypoint_scores"], atol=1e-5)


# -- each model's outputs, features and predict ------------------------------------------


@pytest.mark.parametrize("name", list(MODELS))
def test_model_matches_jax(name):
    """The backbone's features, the neck's (RTMW) and the head's SimCC
    vectors, and the predict program (flip-TTA, the joint argmax)."""
    ours, jm, variables = both_models(name, seed=len(name))
    crops = _crops(2, MODELS[name][1], seed=3)

    def jax_all(v, crops):
        x = jm.preprocess(crops)
        feats = jm.module.apply(v, x, method=lambda m, x: m.backbone(x, train=False))
        necked = jm.module.apply(v, x, method=lambda m, x: m.extract_feat(x, train=False))
        return feats, necked, jm.module.apply(v, x, train=False), jm.make_predict(jit=False)(v, crops)

    feats_ref, neck_ref, outs_ref, ref = jax_run(jax_all, variables, crops)
    with torch.no_grad():
        x = ours.preprocess(torch.from_numpy(crops)).permute(0, 3, 1, 2)
        feats = ours.module.backbone(x)
        necked = feats if ours.module.neck is None else ours.module.neck(feats)
        outs = ours.module.head(necked)
    nhwc = [np.transpose(np.asarray(f), (0, 3, 1, 2)) for f in feats_ref]
    assert_close(feats, nhwc)
    assert_close(necked, [np.transpose(np.asarray(f), (0, 3, 1, 2)) for f in neck_ref])
    assert_close(outs, outs_ref)
    assert_simcc_predict(ours.predict(torch.from_numpy(crops)), {k: np.asarray(v) for k, v in ref.items()})


def test_rtmw_round_trip_through_the_jax_converter():
    """The port's seeded RTMW weights (``chip_smoke.seeded_fixture_state``'s
    draws) under mmpose's names, read by the JAX package's
    ``convert_torch_state_dict`` (``convert_torch_cspnext_backbone``,
    ``convert_torch_cspnext_pafpn``, ``_convert_rtmw_head``): the JAX forward
    equals the port's, and ``state_dict_from_jax`` gives the state dict back."""
    from chip_smoke import randomize_batch_stats

    ours = PoseModel(MODELS["rtmw"][0], metainfo=META, device="cpu")
    ours.init_weights(seed=4)
    randomize_batch_stats(ours.module, seed=5)
    sd = {k: v.numpy() for k, v in ours.module.state_dict().items()}
    variables = convert_torch_state_dict(sd)
    for key, value in state_dict_from_jax(variables).items():
        assert np.array_equal(value.numpy(), sd[key]), key
    crops = _crops(2, (64, 64), seed=6)
    jm = JaxPoseModel(MODELS["rtmw"][0], metainfo=META)
    with torch.no_grad():
        got = ours.module(ours.preprocess(torch.from_numpy(crops)))
    assert_close(got, jax_run(jm.forward, variables, crops))


def test_rtmw_m_takes_the_backbone_widths():
    """RTMW-m's shipped config at full width: CSPNeXt-m gives 384 and 768
    channels (1/16 and 1/32), the neck's ``in_channels`` are [512, 768].
    The JAX modules read their input widths from the data (their shapes by
    ``jax.eval_shape``); the port's convolutions take the same widths."""
    cfg = copy.deepcopy(Config.fromfile(str(RTMW))["model"])
    jm = JaxPoseModel(cfg, metainfo=parse_pose_metainfo(dict(dataset_name="coco_wholebody")))
    x = jnp.zeros((1, 256, 192, 3))
    variables = jax.eval_shape(lambda: jm.module.init(jax.random.PRNGKey(0), x, train=False))
    backbone, neck, head = jax.eval_shape(lambda v: (
        jm.module.apply(v, x, method=lambda m, x: m.backbone(x, train=False)),
        jm.module.apply(v, x, method=lambda m, x: m.extract_feat(x, train=False)),
        jm.module.apply(v, x, train=False)), variables)
    assert [b.shape for b in backbone] == [(1, 16, 12, 384), (1, 8, 6, 768)]
    assert [n.shape for n in neck] == [(1, 16, 12, 512), (1, 8, 6, 768)]
    assert [h.shape for h in head] == [(1, 133, 384), (1, 133, 512)]
    with mock.patch.object(torch.nn.modules.conv._ConvNd, "reset_parameters", lambda self: None):
        model = PoseModel(cfg, device="cpu").module
    assert model.backbone.out_channels == (384, 768) and model.neck.out_channels == (512, 768)
    # the build measured the map by a forward in evaluation mode: no BatchNorm statistic moved
    assert all(bool((v == 1).all()) for k, v in model.named_buffers() if k.endswith("running_var"))
    widths = {name: (m.conv.in_channels, m.conv.out_channels) for name, m in (
        ("reduce1", model.neck.reduce_layers[0]), ("top_down1", model.neck.top_down_blocks[0].main_conv),
        ("down0", model.neck.downsamples[0]), ("bottom_up0", model.neck.bottom_up_blocks[0].main_conv),
        ("head.conv_dec", model.head.conv_dec), ("head.final_layer2", model.head.final_layer2))}
    assert widths == {"reduce1": (768, 512), "top_down1": (896, 256), "down0": (512, 512),
                      "bottom_up0": (1024, 384), "head.conv_dec": (192, 192), "head.final_layer2": (704, 133)}
    assert model.neck.top_down_blocks[0].final_conv.conv.out_channels == 512
    assert model.neck.bottom_up_blocks[0].final_conv.conv.out_channels == 768
    carried = state_dict_from_jax(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), variables))
    assert {k: tuple(v.shape) for k, v in carried.items()} == {k: tuple(v.shape) for k, v in
                                                               model.state_dict().items()}


def test_pixel_shuffle_is_torch_s():
    """The JAX ``_pixel_shuffle`` (NHWC) is ``nn.PixelShuffle(2)`` on the
    same tensor in NCHW."""
    x = np.random.RandomState(1).randn(2, 3, 5, 16).astype(np.float32)
    want = np.transpose(np.asarray(_pixel_shuffle(jnp.asarray(x), 2)), (0, 3, 1, 2))
    got = torch.nn.PixelShuffle(2)(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(got.numpy(), want)


def test_simcc_head_reads_the_map_it_gets():
    """The MPII SimCC config (256 x 256) sets ``in_featuremap_size=(6, 8)``
    where ResNet-50 gives 8 x 8, and sets no ``deconv_out_channels``: its
    file name says "wo-deconv", but both packages run the head's default
    stack of three deconvolutions (as they do for the MobileNetV2
    "wo-deconv" config), to 64 x 64. The flax head's classifiers take 4,096
    inputs from the data, and so do the port's."""
    cfg = copy.deepcopy(Config.fromfile(str(
        ROOT / "configs/body_2d_keypoint/simcc/mpii/simcc_res50_wo-deconv-8xb64-210e_mpii-256x256.py"))["model"])
    jm = JaxPoseModel(cfg, metainfo=META)
    shapes = jax.eval_shape(lambda: jm.module.init(jax.random.PRNGKey(0), jnp.zeros((1, 256, 256, 3)), train=False))
    assert shapes["params"]["head"]["mlp_head_x"]["kernel"].shape == (4096, 512)
    assert "deconv_layers" in shapes["params"]["head"]
    with mock.patch.object(torch.nn.modules.conv._ConvNd, "reset_parameters", lambda self: None):
        head = PoseModel(cfg, device="cpu").module.head
    assert head.mlp_head_x.in_features == head.mlp_head_y.in_features == 4096
    assert len(head.deconv_layers) == 9


# -- training mode --------------------------------------------------------------------


@pytest.mark.parametrize("name", ["simcc", "rtmw"])
def test_training_step_matches_jax(name):
    """One training step of two smooth crops, BatchNorm in training mode (the
    port's RTMW neck in evaluation mode, as the JAX estimator runs it) and
    ``mean(w_x * x ** 2) + mean(w_y * y ** 2)`` of the SimCC vectors as the
    loss (``w`` drawn from a seed): the loss, every parameter's gradient and
    the updated running statistics, in f64 on both sides."""
    cfg, side = MODELS[name]
    cfg64 = copy.deepcopy(cfg)
    for part in ("backbone", "neck", "head"):
        if part in cfg64:
            cfg64[part]["dtype"] = jnp.float64
    x = ((_smooth_crops(2, 22, size=side) - 127.5) / 60).astype(np.float64)
    ours = PoseModel(cfg, metainfo=META, device="cpu")  # built in f32: its build runs the backbone once
    with jax.enable_x64(True), port_in_float64():
        jm = JaxPoseModel(cfg64, metainfo=META)
        variables = jax.tree_util.tree_map(lambda a: a.astype(np.float64),
                                           jax_variables(jm.module, (1, *side, 3), 21))
        ours.module.load_state_dict(state_dict_from_jax(variables), strict=True)
        ours.module.double().train()
        if ours.module.neck is not None:
            ours.module.neck.eval()
        if hasattr(ours.module.backbone, "dtype"):
            ours.module.backbone.dtype = torch.float64
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
    assert outs[0].dtype == torch.float64
    assert float(ours_loss.detach()) == pytest.approx(float(loss), rel=1e-5)
    for key, p in ours.module.named_parameters():
        w = want[key].numpy()
        assert np.linalg.norm(p.grad.numpy() - w) <= 1e-5 * np.linalg.norm(w), key
    for key, buf in ours.module.named_buffers():
        if key.endswith(("running_mean", "running_var")):
            w = want[key].numpy()
            assert np.abs(buf.numpy() - w).max() <= 1e-5 * np.abs(w).max(), key


def test_rtmw_neck_batchnorm_departs_from_jax():
    """In a training forward the JAX RTMW's neck keeps its running statistics
    (its estimator calls the neck without ``train``); the port's neck
    updates them from the batch, as mmpose's does."""
    ours, jm, variables = both_models("rtmw", seed=7)
    crops = _crops(2, (64, 64), seed=8)
    _, new = jax_run(lambda v, c: jm.forward(v, c, train=True, mutable=["batch_stats"]), variables, crops)
    neck_before, neck_after = _np(variables["batch_stats"]["neck"]), _np(new["batch_stats"]["neck"])
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree_util.tree_leaves(neck_before),
                                                    jax.tree_util.tree_leaves(neck_after)))
    before = {k: v.clone() for k, v in ours.module.neck.named_buffers() if k.endswith("running_mean")}
    ours.train()
    ours.module(ours.preprocess(torch.from_numpy(crops)))
    assert all(not torch.equal(v, before[k]) for k, v in ours.module.neck.named_buffers() if k in before)


# -- init_model -> inference_topdown, and the entry points ------------------------------------


def test_rtmw_fixture_through_inference_topdown_and_the_metric():
    """``chip_smoke.model_fixture_report``, the card's ``multistage_golden``
    check of RTMW, on the CPU: the narrow RTMW with 133 keypoints, its ties
    left out."""
    report = model_fixture_report(RTMW_FIXTURE, device="cpu")
    assert report["instances"] == 62 and report["sane"] > 0.97, report
    assert report["p99"] < 1.0 and report["over_5px"] <= 1, report
    assert report["scores"] < 2e-3 and report["d_AP"] < 0.01, report
    assert report["outputs_rel"] < 1e-4 and report["ok"], report


def test_simcc_through_inference_topdown():
    """The SimCC ResNet (``MODELS["simcc"]``) through ``init_model`` with a
    weights file and ``inference_topdown`` on two boxes of an image: the
    keypoints in the image and scores against the JAX predict's on the same
    crops, mapped as ``attach_predictions`` maps them."""
    ours, jm, variables = both_models("simcc", seed=11)
    cfg = dict(model=MODELS["simcc"][0], test_dataloader=dict(dataset=dict(pipeline=[
        dict(type="LoadImage"), dict(type="GetBBoxCenterScale"), dict(type="TopdownAffine", input_size=(64, 64)),
        dict(type="PackPoseInputs")])))
    img = np.round(np.random.RandomState(12).rand(120, 100, 3) * 255).astype(np.uint8)
    boxes = np.array([[10, 5, 90, 110], [0, 20, 60, 80]], np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp, "simcc.pth")
        torch.save(ours.module.state_dict(), path)
        model = init_model(Config(cfg), checkpoint=str(path), device="cpu")
    samples = inference_topdown(model, img, boxes)
    crops, centers, scales = crop_batch(img, boxes, (64, 64), "cpu", model.cfg_full)
    ref = {k: np.asarray(v) for k, v in jax_run(jm.make_predict(jit=False), variables, crops.numpy()).items()}
    want = ref["keypoints"] / np.float32([64, 64]) * scales[:, None] + centers[:, None] - 0.5 * scales[:, None]
    np.testing.assert_allclose(np.stack([s.pred_instances.keypoints[0] for s in samples]), want, rtol=1e-6)
    np.testing.assert_allclose(np.stack([s.pred_instances.keypoint_scores[0] for s in samples]),
                               ref["keypoint_scores"], atol=1e-5)


RTMW_NARROW = ["model.backbone.widen_factor=0.125", "model.backbone.deepen_factor=0.167",
               "model.neck.in_channels=[48,96]", "model.neck.num_csp_blocks=1", "model.head.in_channels=96",
               "model.head.gau_cfg.hidden_dims=32", "model.head.gau_cfg.s=16"]


def test_tools_train_runs_the_cocktail14_mix(tmp_path, capsys):
    """``tools.train`` on the RTMW recipe (narrowed) over the mini set in each
    of the 14 datasets' layouts (``cocktail14_sets``: four combined sets, the
    UBody scenes a fifth), 133 keypoints through every sub-pipeline and
    ``KeypointConverter``: two epochs across the pipeline switch, a val pass
    by ``CocoWholeBodyMetric``, the first loss dict equal to
    ``make_train_step``'s; then ``tools.test`` on the last checkpoint."""
    ann = mini_coco_set(tmp_path)
    cfg = Config.fromfile(str(RTMW))
    wholebody = tmp_path / "train_dataloader_wholebody.json"
    options = RTMW_NARROW + cocktail14_sets(cfg, tmp_path, ann) + [
        "train_dataloader.batch_size=101", "train_dataloader.num_workers=0",
        f"val_dataloader.dataset.data_root={tmp_path}", f"val_dataloader.dataset.ann_file={wholebody.name}",
        "val_dataloader.dataset.data_prefix.img=imgs/", "val_dataloader.dataset.bbox_file=None",
        "val_dataloader.num_workers=0", f"val_evaluator.ann_file={wholebody}", "train_cfg.max_epochs=2",
        "train_cfg.val_interval=2", "custom_hooks.1.switch_epoch=1", "default_hooks.logger.interval=1"]
    work = tmp_path / "work"
    runner = train_cli.main([str(RTMW), "--work-dir", str(work), "--device", "cpu", "--cfg-options", *options])
    dataset = runner.train_loader.dataset
    assert [type(d).__name__ for d in dataset.datasets] == ["CombinedDataset"] * 4 and len(dataset) == 202
    assert runner.state.step == 4 and runner.metainfo["num_keypoints"] == 133
    log = (work / "train.log").read_text()
    assert "pipeline switch at epoch 1" in log and log.count("val: coco/") == 1
    assert all(np.isfinite(v) for entry in runner.train_log for v in entry.values())
    _first_step_equals_make_train_step(runner)
    capsys.readouterr()
    test_options = [o for o in options if o.startswith(("model.", "val_", "test_"))] + [
        f"test_dataloader.dataset.data_root={tmp_path}", f"test_dataloader.dataset.ann_file={wholebody.name}",
        "test_dataloader.dataset.data_prefix.img=imgs/", "test_dataloader.dataset.bbox_file=None",
        "test_dataloader.num_workers=0", f"test_evaluator.ann_file={wholebody}"]
    test_cli.main([str(RTMW), str(work / "epoch_2.pth"), "--device", "cpu", "--cfg-options", *test_options])
    lines = dict(line.split(": ", 1) for line in capsys.readouterr().out.splitlines()
                 if line.startswith("coco/") and ": " in line)
    assert {"coco/AP", "coco/body_AP", "coco/face_AP"} <= set(lines)
    assert all(np.isfinite(float(v)) for v in lines.values())


# -- the cocktail14 datasets ---------------------------------------------------------------


@pytest.mark.parametrize("name", ["humanart21", "interhand2d"])
def test_metainfo_equals_jax(name):
    ours, ref = parse_pose_metainfo(dict(dataset_name=name)), jax_parse_pose_metainfo(dict(dataset_name=name))
    assert_same(ours, ref, name)
    assert ours["num_keypoints"] == 21


def test_datasets_equal_jax(tmp_path):
    """``HumanArt21Dataset`` and ``InterHand2DDoubleDataset`` against the JAX
    classes: every instance's info exactly, the InterHand config's
    ``camera_param_file`` and ``joint_file`` taken into the COCO-style
    parser's keyword arguments (the JAX reading; mmpose's class reads those
    files). InterHand's 42 keypoints are an even count: its
    ``pad_to_contain`` is the JAX function's on rows read as rows
    (``tests/test_torch_body8.py:_jax_pad_to_contain``, the port's departure)."""
    from chip_smoke import body_set_from_coco

    ann = GOLDEN / "e2e_coco.json"
    body_set_from_coco(ann, tmp_path / "humanart.json", "HumanArt21Dataset", [(k, k) for k in range(17)])
    interhand_set_from_coco(ann, tmp_path / "interhand.json")
    for kind, name, extra in (("HumanArt21Dataset", "humanart.json", {}),
                              ("InterHand2DDoubleDataset", "interhand.json",
                               dict(camera_param_file="camera.json", joint_file="joint.json", sample_interval=10))):
        cfg = dict(type=kind, data_root=str(tmp_path), ann_file=name, data_prefix=dict(img="imgs/"), **extra)
        ours, ref = DATASETS.build(cfg), jax_build(cfg)
        assert len(ours) == len(ref) > 0
        if kind == "InterHand2DDoubleDataset":
            for a, b in zip(ours.data_list, ref.data_list):
                assert len(b["pad_to_contain"]) == 63 and len(a["pad_to_contain"]) == 42
                b["pad_to_contain"] = _jax_pad_to_contain(b)
        assert_same(ours.data_list, ref.data_list, kind)
        assert ours.metainfo["dataset_name"] == ref.metainfo["dataset_name"]


# -- every shipped config ----------------------------------------------------------------


CONFIGS = sorted(str(p.relative_to(ROOT)) for p in (ROOT / "configs").rglob("*.py")
                 if re.search(r"type=[\"'](SimCCHead|RTMWHead)[\"']", p.read_text()))
# built in ``tests/test_torch_cnn_backbones.py`` with its backbone's family
SIMCC_VIPNAS = "configs/body_2d_keypoint/simcc/coco/simcc_vipnas-mbv3_8xb64-210e_coco-256x192.py"


def test_the_families_count():
    assert len(CONFIGS) == 7 and SIMCC_VIPNAS in CONFIGS


@pytest.mark.parametrize("config", [c for c in CONFIGS if c != SIMCC_VIPNAS])
def test_shipped_config_builds_in_the_port(config):
    """Each shipped SimCC and RTMW config through ``init_model(...,
    device="cpu")`` at its full depth and width, without a forward: the
    model, its datasets' classes and tables (keypoints the head's outputs;
    the cocktail14 mix's fourteen) and the optimizer."""
    cfg = Config.fromfile(str(ROOT / config))
    with mock.patch.object(torch.nn.modules.conv._ConvNd, "reset_parameters", lambda self: None):
        model = init_model(cfg, device="cpu")
    K = cfg["model"]["head"]["out_channels"]
    assert model.metainfo["num_keypoints"] == K

    def leaves(d):
        return [x for sub in d["datasets"] for x in leaves(sub)] if d["type"] == "CombinedDataset" else [d]

    for loader in ("train_dataloader", "val_dataloader", "test_dataloader"):
        dataset = cfg[loader]["dataset"]
        assert parse_pose_metainfo(config_metainfo(dataset))["num_keypoints"] == K, loader
        for d in leaves(dataset):
            assert DATASETS.get(d["type"]) is not None, d["type"]
    build_optimizer(model, cfg["optim_wrapper"], cfg["param_scheduler"], 10, cfg["train_cfg"]["max_epochs"])
