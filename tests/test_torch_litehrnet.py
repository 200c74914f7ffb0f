"""LiteHRNet on the CPU: the port against the JAX package on the same weights and inputs.

The weights are the JAX module's variables drawn by NumPy from a seed
(``lite_variables``), carried to the port by ``state_dict_from_jax`` and
loaded with ``strict=True``; the inputs are drawn by NumPy and fed to both.
The models are narrow (widths 8-32, one module of one block a stage).

The JAX module cannot be jitted: its cross-resolution weighting splits its
channels at ``jnp.cumsum`` of its widths, a traced value under ``jax.jit``
(``test_jax_litehrnet_cannot_be_jitted``). Its eager ``apply`` defines what
it computes, and the forward is held against it. Eager, each operation
compiles on its first shapes: a training step's gradient took about a minute
here. So the gradients and the variables' shapes are taken with ``jax.jit``
under ``jax.ensure_compile_time_eval()``, which computes the split points
while tracing (they depend on no input) and stages everything else as jit
does; the forward and the predict program are the eager JAX ones (the
predict's doubled batch of two boxes has the shapes of the forward's four
crops, whose compiled operations it reuses).

LiteHRNet runs only at even sides (its pools meet the coarsest branch at
sides that are multiples of 32 in the configs), where the JAX "SAME"
convolutions of stride 2 pad (0, 1) and the port's pad (1, 1) as mmpose's
do. The port is held with JAX's padding put in front of its strided convs
here in the test (``chip_smoke.jax_same_strided``: the module has no such
option), and one test shows the departure.

Bars, with their reasons (``tests/test_torch_cnn_backbones.py``'s): features
and heatmaps within 1e-5 of the JAX output's largest value (f32 on both
sides, summation order); MSRA keypoints 1e-3 heatmap pixels and scores 1e-5;
in training mode, in f64 on both sides, the loss within 1e-5 relative, each
parameter's gradient within 1e-5 of its own l2 norm (of ``ZERO_GRAD`` where it
is 0 in exact arithmetic) and the running statistics within 1e-5 of their
largest value.
"""

import re
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import LITEHRNET_FIXTURE, jax_same_strided, model_fixture_report
from probpose_code_torch.apis import inference_topdown, init_model
from probpose_code_torch.apis.inference import crop_batch
from probpose_code_torch.config import Config
from probpose_code_torch.engine import checkpoint
from probpose_code_torch.engine.checkpoint import state_dict_from_jax
from probpose_code_torch.models.backbones import litehrnet
from probpose_code_torch.models.builder import PoseModel
from probpose_code_tpu.models import PoseModel as JaxPoseModel
from probpose_code_tpu.models.backbones import litehrnet as jlite
from tests.test_torch_classic_heatmap import _smooth_crops
from tests.test_torch_cnn_backbones import FAST_COMPILE, _np, port_in_float64

ROOT = Path(__file__).resolve().parents[1]
META = {"flip_indices": [0, 2, 1, 4, 3, 6, 5, 8, 7, 10, 9, 12, 11, 14, 13, 16, 15], "num_keypoints": 17}
REL = 1e-5
# a gradient that is 0 in exact arithmetic (the bias of a BatchNorm that a conv and a BatchNorm in training mode
# follow: the second one takes the batch mean away) is f64 rounding on both sides, about 1e-17 here; the others
# are above 1e-4
ZERO_GRAD = 1e-10
# two stages (2 and 3 branches) of one module of one block: every kind of transition (a projection of the
# stem's 16 channels to 8, a new branch in each stage), the fuse's two-step chain, the head over three branches
EXTRA = dict(stem=dict(stem_channels=16, out_channels=16, expand_ratio=1), num_stages=2, stages_spec=dict(
    num_modules=(1, 1), num_branches=(2, 3), num_blocks=(1, 1), module_type=("LITE",) * 2, with_fuse=(True,) * 2,
    reduce_ratios=(4, 4), num_channels=((8, 16), (8, 16, 24))), with_head=True)
SIDE = (64, 64)
CFG = dict(
    type="TopdownPoseEstimator",
    data_preprocessor=dict(type="PoseDataPreprocessor", mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375],
                           bgr_to_rgb=True),
    backbone=dict(type="LiteHRNet", extra=EXTRA),
    head=dict(type="HeatmapHead", in_channels=8, out_channels=17, deconv_out_channels=None,
              loss=dict(type="KeypointMSELoss", use_target_weight=True),
              decoder=dict(type="MSRAHeatmap", input_size=SIDE, heatmap_size=(16, 16), sigma=2)),
    test_cfg=dict(flip_test=True))
FAMILY_CONFIGS = sorted(str(p.relative_to(ROOT)) for p in (ROOT / "configs").rglob("*.py")
                        if re.search(r"backbone=dict\(\s*type=[\"']LiteHRNet[\"']", p.read_text()))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tier-1 runs six test workers at once; one torch thread each."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def draw(shapes, seed):
    """Arrays of ``shapes`` (a tree of shapes) drawn by NumPy from ``seed``:
    kernels N(0, 1 / fan-in), BatchNorm scales and variances in [0.5, 1.5),
    means in [-0.2, 0.2), the rest N(0, 0.1)
    (``tests/test_torch_cnn_backbones.py:jax_variables``)."""
    rng = np.random.RandomState(seed)

    def one(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            return (rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        if name == "mean":
            return rng.uniform(-0.2, 0.2, shape).astype(np.float32)
        return (0.1 * rng.randn(*shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(one, shapes)


def lite_variables(module, inputs, seed, **kwargs):
    """The variables of the flax ``module`` (which ``jax.eval_shape`` cannot
    trace on its own, see the module docstring) for ``inputs`` (arrays or
    lists of arrays), drawn from ``seed``."""
    abstract = jax.tree_util.tree_map(lambda a: jax.ShapeDtypeStruct(np.shape(a), jnp.float32), inputs)
    with jax.ensure_compile_time_eval():
        shapes = jax.eval_shape(lambda key, x: module.init(key, x, **kwargs), jax.random.PRNGKey(0), abstract)
    return draw(shapes, seed)


def jit_in_compile_time_eval(fn, *args):
    """``fn(*args)`` jitted under ``jax.ensure_compile_time_eval()`` (the module
    docstring) without XLA's backend optimisations."""
    with jax.ensure_compile_time_eval():
        return jax.jit(fn).lower(*args).compile(compiler_options=FAST_COMPILE)(*args)


def carried(variables, path, prefix):
    """The port's state dict of a JAX sub-module's ``variables``, placed at
    ``path`` in a JAX LiteHRNet's tree and carried by its rules, under the
    port's names after ``prefix``."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    for part in reversed(path.split("/")):
        params, stats = {part: params}, {part: stats}
    sd = {}
    checkpoint._cnn_from_jax(sd, _np(params), _np(stats), checkpoint._litehrnet_rules(params))
    return {k.removeprefix(f"backbone.{prefix}"): torch.from_numpy(np.array(v)) for k, v in sd.items()}


def nchw(a):
    return np.transpose(np.asarray(a), (0, 3, 1, 2))


def assert_close(got, want):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    assert np.abs(got.detach().numpy() - want).max() < REL * np.abs(want).max()


# -- the JAX module under jit ---------------------------------------------------------------


def test_jax_litehrnet_cannot_be_jitted():
    """The JAX LiteHRNet's forward and the JAX predict program of a LiteHRNet
    model raise ``ConcretizationTypeError`` under ``jax.jit`` (the split at
    ``jnp.cumsum`` of the widths); the port splits at Python ints and serves
    and trains them (``test_inference_topdown_matches_jax``,
    ``test_training_step_matches_jax``)."""
    jm = JaxPoseModel(CFG, metainfo=META)
    x = np.zeros((1, *SIDE, 3), np.float32)
    variables = lite_variables(jm.module, x, seed=0, train=False)
    with pytest.raises(jax.errors.ConcretizationTypeError, match="split"):
        jax.jit(lambda v, x: jm.module.apply(v, x, train=False))(variables, x)
    with pytest.raises(jax.errors.ConcretizationTypeError, match="split"):
        jm.make_predict()(variables, x)
    with pytest.raises(jax.errors.ConcretizationTypeError):
        jax.eval_shape(lambda: jlite.LiteHRNet(extra=EXTRA).init(jax.random.PRNGKey(0), jnp.zeros((1, *SIDE, 3))))


# -- each module ---------------------------------------------------------------------------


def _branches(seed, channels, side=16, n=2):
    rng = np.random.RandomState(seed)
    return [rng.randn(n, side // 2 ** j, side // 2 ** j, c).astype(np.float32) for j, c in enumerate(channels)]


def test_spatial_weighting_matches_jax():
    """``SpatialWeighting`` (ratio 4) on a (2, 12, 8, 8) map: the JAX module
    jitted, the port's ``SELayer`` of its width through ``se_layer``'s twin."""
    x = np.random.RandomState(1).randn(2, 8, 8, 12).astype(np.float32)
    jm = jlite.SpatialWeighting(ratio=4)
    variables = lite_variables(jm, x, seed=2)
    ours = litehrnet.spatial_weighting(12, 4)
    ours.load_state_dict(carried(variables, "s0_m0_b0/sw0", "stage0.0.layers.0.spatial_weighting.0."), strict=True)
    want = jax.jit(jm.apply)(variables, x)
    with torch.no_grad():
        assert_close(ours(torch.from_numpy(nchw(x)), torch.float32), nchw(want))


def test_cross_resolution_weighting_matches_eager_jax():
    """``CrossResolutionWeighting`` over three branches (16, 8 and 4 a side;
    the pools by 4 and 2): the JAX module's eager ``apply``, its BatchNorm
    on the running statistics (``train=False`` in the JAX module), the port in
    evaluation mode."""
    xs = _branches(3, (4, 8, 12))
    jm = jlite.CrossResolutionWeighting((4, 8, 12), ratio=4)
    variables = lite_variables(jm, xs, seed=4)
    ours = litehrnet.CrossResolutionWeighting((4, 8, 12), 4).eval()
    ours.load_state_dict(carried(variables, "s0_m0_b0/crw", "stage0.0.layers.0.cross_resolution_weighting."),
                         strict=True)
    want = jm.apply(variables, xs)
    with torch.no_grad():
        got = ours([torch.from_numpy(nchw(x)) for x in xs], torch.float32)
    for g, w in zip(got, want):
        assert_close(g, nchw(w))


def test_conditional_channel_weighting_matches_eager_jax():
    """``ConditionalChannelWeighting`` over three branches (8, 16 and 24
    channels): the eager JAX module, both in evaluation mode."""
    xs = _branches(5, (8, 16, 24))
    jm = jlite.ConditionalChannelWeighting((8, 16, 24), reduce_ratio=4)
    variables = lite_variables(jm, xs, seed=6)
    ours = litehrnet.ConditionalChannelWeighting((8, 16, 24), 4).eval()
    ours.load_state_dict(carried(variables, "s0_m0_b0", "stage0.0.layers.0."), strict=True)
    want = jm.apply(variables, xs)
    with torch.no_grad():
        got = ours([torch.from_numpy(nchw(x)) for x in xs], torch.float32)
    for g, w in zip(got, want):
        assert_close(g, nchw(w))


@pytest.mark.parametrize("stem,out,expand", [(16, 16, 1), (16, 24, 2)], ids=["same", "wider"])
def test_lite_stem_matches_jax(stem, out, expand):
    """``LiteStem`` at 32 x 24, jitted (it has no split at traced points),
    with JAX's stride-2 padding in the port (``jax_same_strided``): the stem
    whose widths are equal and the one whose output is wider (``inc`` and
    ``linear_conv``'s width by the other rule)."""
    x = np.random.RandomState(7).randn(2, 32, 24, 3).astype(np.float32)
    jm = jlite.LiteStem(stem, out, expand)
    variables = lite_variables(jm, x, seed=8, train=False)
    ours = litehrnet.LiteStem(3, stem, out, expand).eval()
    ours.load_state_dict(carried(variables, "stem", "stem."), strict=True)
    want = jax.jit(lambda v, x: jm.apply(v, x, train=False))(variables, x)
    with torch.no_grad(), jax_same_strided():
        assert_close(ours(torch.from_numpy(nchw(x)), torch.float32), nchw(want))


# -- the whole backbone and the estimator ------------------------------------------------------


_CACHE = {}


def models(seed=11):
    """(port model with the JAX variables, JAX model, JAX variables, four
    crops, the JAX estimator's eager backbone features and heatmaps on them),
    made once a module."""
    if seed not in _CACHE:
        jm = JaxPoseModel(CFG, metainfo=META)
        crops = np.random.RandomState(seed + 1).randn(4, *SIDE, 3).astype(np.float32)
        variables = lite_variables(jm.module, crops, seed, train=False)
        ours = PoseModel(CFG, metainfo=META, device="cpu")
        ours.module.load_state_dict(state_dict_from_jax(_np(variables)), strict=True)
        ours.module.eval()
        feats = jm.module.apply(variables, crops, method=lambda m, x: m.backbone(x, train=False))
        maps = jm.module.apply(variables, crops, train=False)
        _CACHE[seed] = ours, jm, variables, crops, feats, maps
    return _CACHE[seed]


def test_litehrnet_matches_eager_jax():
    """The backbone's features and the estimator's heatmaps on four crops
    against the JAX module's eager ``apply`` (``jax_same_strided`` in the
    port)."""
    ours, jm, variables, crops, feats, maps = models()
    x = torch.from_numpy(nchw(crops))
    with torch.no_grad(), jax_same_strided():
        got_feats = ours.module.backbone(x)
        got_maps = ours.module.head(got_feats)
    assert len(got_feats) == len(feats) == 1
    assert_close(got_feats[0], nchw(feats[0]))
    assert_close(got_maps, maps)


def test_stride_two_padding_departs_from_jax_at_even_sides():
    """Without the test's substitution the port's strided convs pad (1, 1),
    as mmpose's do, and the JAX module's "SAME" (0, 1) at the even sides
    LiteHRNet runs at: the features differ by far more than the bar."""
    ours, _, _, crops, feats, _ = models()
    assert ours.module.backbone.stem.conv1.conv.padding == (1, 1)
    assert ours.module.backbone.stem.depthwise_conv.conv.stride == (2, 2)
    with torch.no_grad():
        got = ours.module.backbone(torch.from_numpy(nchw(crops)))[0].numpy()
    want = nchw(feats[0])
    assert got.shape == want.shape
    assert np.abs(got - want).max() > 1e-2 * np.abs(want).max()


def _train_step(cfg64, variables, x, ws, crw_eval):
    """The JAX loss, gradients and new statistics of ``mean(w * out ** 2)``,
    and the port's loss (its gradients and statistics in the model), both in
    f64; the port's cross-resolution BatchNorms in evaluation mode where
    ``crw_eval``."""
    with jax.enable_x64(True), port_in_float64():
        jm = JaxPoseModel(cfg64, metainfo=META)
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)

        def jax_loss(params):
            out, new = jm.module.apply({"params": params, "batch_stats": v64["batch_stats"]}, x, train=True,
                                       mutable=["batch_stats"])
            return jnp.mean(ws * out ** 2), new

        (loss, new), grads = jit_in_compile_time_eval(jax.value_and_grad(jax_loss, has_aux=True), v64["params"])
        ours = PoseModel(CFG, metainfo=META, device="cpu")
        ours.module.load_state_dict(state_dict_from_jax(_np(variables)), strict=True)
        ours.module.double().train()
        ours.module.backbone.dtype = torch.float64
        if crw_eval:
            for m in ours.module.modules():
                if isinstance(m, litehrnet.CrossResolutionWeighting):
                    m.eval()
        with jax_same_strided():
            out = ours.module(torch.from_numpy(x))
        ours_loss = (torch.from_numpy(ws) * out ** 2).mean()
        ours_loss.backward()
        want = state_dict_from_jax({"params": _np(grads), "batch_stats": _np(new["batch_stats"])})
    return float(loss), want, ours, float(ours_loss.detach())


_TRAINED = {}


def trained():
    if not _TRAINED:
        _, _, variables, _, _, _ = models()
        cfg64 = dict(CFG, backbone=dict(CFG["backbone"], dtype=jnp.float64), head=dict(CFG["head"], dtype=jnp.float64))
        x = ((_smooth_crops(2, 13, size=SIDE) - 127.5) / 60).astype(np.float64)
        ws = np.random.RandomState(14).uniform(0.5, 1.5, (2, 17, 16, 16))
        _TRAINED["step"] = _train_step(cfg64, variables, x, ws, crw_eval=True)
        _TRAINED["inputs"] = variables, x, ws
    return _TRAINED


def test_training_step_matches_jax():
    """One training step of two smooth crops, BatchNorm in training mode, with
    ``mean(w * out ** 2)`` of the heatmaps as the loss (``w`` drawn from a
    seed), in f64 on both sides: the loss, every parameter's gradient and the
    running statistics; the port's cross-resolution BatchNorms on their
    running statistics, as the JAX module's (see
    ``test_cross_resolution_batchnorm_trains``)."""
    loss, want, ours, ours_loss = trained()["step"]
    assert ours_loss == pytest.approx(loss, rel=1e-5)
    for key, p in ours.module.named_parameters():
        w = want[key].numpy()
        assert np.linalg.norm(p.grad.numpy() - w) <= 1e-5 * max(np.linalg.norm(w), ZERO_GRAD), key
    for key, buf in ours.module.named_buffers():
        if key.endswith(("running_mean", "running_var")):
            w = want[key].numpy()
            assert np.abs(buf.numpy() - w).max() <= 1e-5 * np.abs(w).max(), key


def test_cross_resolution_batchnorm_trains():
    """The JAX cross-resolution weighting calls its BatchNorms with
    ``train=False``: in a training step it normalises by the running
    statistics and leaves them as they were. The port trains them, as
    mmpose does: in the same step (the test's other BatchNorms trained in both)
    its statistics move and its loss departs from the JAX one."""
    variables, x, ws = trained()["inputs"]
    loss, want, _, _ = trained()["step"]
    cfg64 = dict(CFG, backbone=dict(CFG["backbone"], dtype=jnp.float64), head=dict(CFG["head"], dtype=jnp.float64))
    start = state_dict_from_jax(_np(variables))
    crw = [k for k in want if ".cross_resolution_weighting." in k and k.endswith("running_mean")]
    assert len(crw) == 4
    for key in crw:
        np.testing.assert_array_equal(want[key].numpy(), start[key].numpy())
    _, _, ours, ours_loss = _train_step(cfg64, variables, x, ws, crw_eval=False)
    moved = dict(ours.module.named_buffers())
    for key in crw:
        assert np.abs(moved[key].numpy() - start[key].numpy()).max() > 1e-3, key
    assert abs(ours_loss - loss) > 1e-6 * abs(loss)  # f64: the two agree to 1e-12 with the same statistics


def test_inference_topdown_matches_jax():
    """The narrow model through ``init_model`` with a weights file and
    ``inference_topdown`` on two boxes of an image (flip-TTA): the keypoints
    in the image and their scores against the eager JAX predict program on
    the same crops (``jax_same_strided`` in the port), mapped as
    ``attach_predictions`` maps them."""
    ours, jm, variables, _, _, _ = models()
    cfg = dict(model=CFG, test_dataloader=dict(dataset=dict(pipeline=[
        dict(type="LoadImage"), dict(type="GetBBoxCenterScale"), dict(type="TopdownAffine", input_size=SIDE),
        dict(type="PackPoseInputs")])))
    img = np.round(np.random.RandomState(15).rand(120, 100, 3) * 255).astype(np.uint8)
    boxes = np.array([[10, 5, 90, 110], [0, 20, 60, 80]], np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp, "litehrnet.pth")
        torch.save(ours.module.state_dict(), path)
        model = init_model(Config(cfg), checkpoint=str(path), device="cpu")
    with jax_same_strided():
        samples = inference_topdown(model, img, boxes)
    crops, centers, scales = crop_batch(img, boxes, SIDE, "cpu", model.cfg_full)
    ref = {k: np.asarray(v) for k, v in jm.make_predict(jit=False)(variables, crops.numpy()).items()}
    want = ref["keypoints"] / np.float32(SIDE) * scales[:, None] + centers[:, None] - 0.5 * scales[:, None]
    got = np.stack([s.pred_instances.keypoints[0] for s in samples])
    np.testing.assert_allclose(got, want, atol=1e-3 * float(scales.max()) / 16)
    np.testing.assert_allclose(np.stack([s.pred_instances.keypoint_scores[0] for s in samples]),
                               ref["keypoint_scores"], atol=1e-5)


# -- the fixture and every shipped config ---------------------------------------------------------


def test_fixture_through_inference_topdown_and_coco_metric():
    """``chip_smoke.model_fixture_report``, the card's ``topdown_rest_golden``
    check of the LiteHRNet fixture, on the CPU: ``init_model`` with its
    weights, JAX's stride-2 padding, ``inference_topdown`` over the 62 golden
    persons, ``CocoMetric``; the maps of the fixture's crops against the JAX
    module's eager ones."""
    report = model_fixture_report(LITEHRNET_FIXTURE, device="cpu")
    assert report["instances"] == 62 and report["p99"] < 1.0 and report["scores"] < 2e-3, report
    assert report["outputs_rel"] < 1e-4 and report["ok"], report


@pytest.mark.slow
def test_litehrnet_18_at_full_geometry_matches_eager_jax():
    """LiteHRNet-18 (the default ``extra``: widths 40-320, 2, 4 and 2 modules)
    at 256 x 192 against the JAX module's eager ``apply`` on one input
    (JAX's stride-2 padding substituted): a minute or more here."""
    x = np.random.RandomState(31).randn(1, 256, 192, 3).astype(np.float32)
    jm = jlite.LiteHRNet()
    variables = lite_variables(jm, x, seed=32, train=False)
    ours = litehrnet.LiteHRNet().eval()
    sd = state_dict_from_jax({"params": {"backbone": _np(variables["params"]), "head": {}},
                              "batch_stats": {"backbone": _np(variables["batch_stats"])}})
    ours.load_state_dict({k.removeprefix("backbone."): v for k, v in sd.items()}, strict=True)
    want = jm.apply(variables, x)[0]
    with torch.no_grad(), jax_same_strided():
        assert_close(ours(torch.from_numpy(nchw(x)))[0], nchw(want))


def test_the_family_count():
    """14 shipped configs run LiteHRNet: six COCO (-18 and -30 at 256 x 192,
    384 x 288 and 288 x 384), two MPII and six hand sets."""
    assert len(FAMILY_CONFIGS) == 14
    assert sum("/coco/" in c for c in FAMILY_CONFIGS) == 6
    assert sum(c.startswith("configs/hand_2d_keypoint") for c in FAMILY_CONFIGS) == 6


@pytest.mark.parametrize("config", FAMILY_CONFIGS)
def test_config_builds(config):
    """Each shipped LiteHRNet config builds through ``init_model`` on the CPU
    at full width and depth (no forward), and its ``tools.train`` optimizer
    from the config."""
    from probpose_code_torch.engine.optim import build_optimizer

    cfg = Config.fromfile(str(ROOT / config))
    model = init_model(cfg, device="cpu")
    backbone = model.module.backbone
    assert isinstance(backbone, litehrnet.LiteHRNet)
    widths = cfg["model"]["backbone"].get("extra", litehrnet.DEFAULT_EXTRA)["stages_spec"]["num_channels"][-1]
    assert [p.pointwise_conv.conv.out_channels for p in backbone.head_layer.projects] == list(widths[::-1][1:]) + [
        widths[0]]
    build_optimizer(model, cfg["optim_wrapper"], cfg["param_scheduler"], 100, cfg["train_cfg"]["max_epochs"])
