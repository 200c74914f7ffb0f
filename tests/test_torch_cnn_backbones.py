"""The ResNet-like and small CNN backbones and ViPNASHead on the CPU, the port
against the JAX package on the same weights and inputs.

The weights are the JAX module's variables drawn by NumPy from a seed (every
kernel, bias, BatchNorm scale and statistic; ``jax_variables``), carried to
the port by ``state_dict_from_jax`` and loaded with ``strict=True``; the
inputs are drawn by NumPy and fed to both. The JAX side runs jitted.

The JAX modules pad every "SAME" convolution of stride 2 only after an even
side, where the port pads ``k // 2`` on each side as mmpose does. So the SE,
SC, ShuffleNet and ViPNAS families are held at sides of the form 32k + 1,
where every strided input is odd and the two agree: 65, and SCNet at 97 (at
65 its last stage's 3 x 3 maps pool to nothing under its 4 x 4 average pool,
and the JAX module divides by zero). ResNeSt runs in JAX at no odd side (its
projections' 2 x 2 pool floors where its main branch pads), so it is held at
64 with JAX's (0, 1) padding put in front of the port's first stem conv here
in the test (``_jax_padded_stem``: the module has no such option), and its
stem conv alone at 65. ResNetV1d, ResNeXt, VGG and AlexNet pad explicitly in
JAX and are held at 128 x 96. One test per family shows the departure at an
even side.

Bars, with their reasons (``tests/test_torch_classic_heatmap.py``'s):
features and heatmaps within 1e-5 of the JAX output's largest value (f32 on
both sides, summation order); MSRA keypoints 1e-3 heatmap pixels (the JAX
package's bar for a decode) and scores 1e-5; in training mode, in f64 (see
``test_training_step_matches_jax``), the loss within 1e-5 relative, each
parameter's gradient within 1e-5 of its own l2 norm and the running
statistics within 1e-5 of their largest value (f64 on both sides gives about
1e-7).
"""

import contextlib
import copy
import re
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probpose_code_torch.apis import init_model
from probpose_code_torch.config import Config
from probpose_code_torch.datasets import config_metainfo
from probpose_code_torch.datasets.metainfo import parse_pose_metainfo
from probpose_code_torch.engine.checkpoint import state_dict_from_jax
from probpose_code_torch.engine.optim import build_optimizer
from probpose_code_torch.models.builder import PoseModel
from probpose_code_torch.registry import DATASETS, EVALUATORS
from probpose_code_torch.registry import MODELS as PORT_MODELS
from probpose_code_tpu.models import PoseModel as JaxPoseModel
from probpose_code_tpu.registry import MODELS as JAX_MODELS
from tests.test_torch_classic_heatmap import _smooth_crops

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "golden"
META = {"flip_indices": [0, 2, 1, 4, 3, 6, 5, 8, 7, 10, 9, 12, 11, 14, 13, 16, 15], "num_keypoints": 17}
FAMILIES = ("ResNetV1d", "ResNeXt", "SCNet", "SEResNet", "ResNeSt", "ShuffleNetV1", "ShuffleNetV2", "VGG", "AlexNet",
            "ViPNAS_ResNet", "ViPNAS_MobileNetV3")
# every shipped config whose model is one of the families
CONFIGS = sorted(str(p.relative_to(ROOT)) for p in (ROOT / "configs").rglob("*.py")
                 if re.search(r"backbone=dict\(\s*type=[\"'](%s)[\"']" % "|".join(FAMILIES), p.read_text()))
RESNEST_269 = [c for c in CONFIGS if "resnest269" in c]
SIMCC_MBV3 = "configs/body_2d_keypoint/simcc/coco/simcc_vipnas-mbv3_8xb64-210e_coco-256x192.py"
BUILT = [c for c in CONFIGS if c not in RESNEST_269 and c != SIMCC_MBV3]
REL = 1e-5
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tier-1 runs six test workers at once; one torch thread each."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_variables(module, shape, seed, **kwargs):
    """Variables of the flax ``module`` for an input of ``shape``, drawn by
    NumPy from ``seed`` (its init traced by ``jax.eval_shape``, not run):
    kernels N(0, 1 / fan-in), BatchNorm scales in [0.5, 1.5), biases N(0,
    0.1), running means in [-0.2, 0.2) and variances in [0.5, 1.5)."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), jnp.zeros(shape), train=False, **kwargs))
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            return (rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))).astype(np.float32)
        if name == "scale" or name == "var":
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        if name == "mean":
            return rng.uniform(-0.2, 0.2, shape).astype(np.float32)
        return (0.1 * rng.randn(*shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def backbone_state(variables):
    """The port's backbone state dict of JAX backbone variables."""
    sd = state_dict_from_jax({"params": {"backbone": variables["params"], "head": {}},
                              "batch_stats": {"backbone": variables.get("batch_stats", {})}})
    return {k.removeprefix("backbone."): v for k, v in sd.items()}


def both_backbones(cfg, side, seed):
    """(the JAX module's jitted eval forward, its variables, the port's module
    with them, in eval mode)."""
    jm = JAX_MODELS.build(dict(cfg))
    h, w = (side, side) if np.isscalar(side) else side
    variables = jax_variables(jm, (1, h, w, 3), seed)
    ours = PORT_MODELS.build(dict(cfg))
    ours.load_state_dict(backbone_state(variables), strict=True)
    return jm, variables, ours.eval()


def jax_run(fn, *args):
    """``fn(*args)`` jitted, compiled without XLA's backend optimisations
    (half the compile time of a ResNet-50 on the CPU; the arithmetic is the
    same)."""
    return jax.jit(fn).lower(*args).compile(compiler_options=FAST_COMPILE)(*args)


def jax_features(jm, variables, x):
    return jax_run(lambda v, x: jm.apply(v, x, train=False), variables, x)


def _inputs(n, side, seed):
    h, w = (side, side) if np.isscalar(side) else side
    return np.random.RandomState(seed).randn(n, h, w, 3).astype(np.float32)


def assert_features(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.transpose(np.asarray(w), (0, 3, 1, 2))
        assert tuple(g.shape) == w.shape
        assert np.abs(g.detach().numpy() - w).max() < REL * np.abs(w).max()


def _jax_padded_stem(ours):
    """The port's ResNeSt with JAX's "SAME" padding of an even input at its
    first (stride-2) stem conv, (0, 1) in each direction: a test-side
    substitution of that conv's forward."""
    first = ours.stem[0]
    first.conv.padding = (0, 0)
    first_forward = first.forward
    first.forward = lambda x, dtype: first_forward(torch.nn.functional.pad(x, (0, 1, 0, 1)), dtype)
    return ours


def _forward(module, x, dtype=torch.float32):
    """A ConvModule's or a backbone's call on NHWC numpy ``x``."""
    t = torch.from_numpy(x).permute(0, 3, 1, 2)
    return module(t) if not hasattr(module, "conv") else module(t, dtype)


# -- each backbone's features -----------------------------------------------------------


CASES = {
    "SEResNet-50": (dict(type="SEResNet", depth=50), 65),
    "SEResNeXt-50": (dict(type="SEResNeXt", depth=50), 65),
    "SCNet-50": (dict(type="SCNet", depth=50), 97),
    "ViPNAS_ResNet": (dict(type="ViPNAS_ResNet", depth=50), 65),
    "ViPNAS_MobileNetV3": (dict(type="ViPNAS_MobileNetV3"), 65),
    "ShuffleNetV1": (dict(type="ShuffleNetV1", groups=3, out_indices=(0, 1, 2)), 65),
    "ShuffleNetV2": (dict(type="ShuffleNetV2", widen_factor=1.0, out_indices=(0, 3)), 65),
    "ResNetV1d-50": (dict(type="ResNetV1d", depth=50, stem_channels=16, base_channels=8, out_indices=(2, 3)),
                     (128, 96)),
    "ResNeXt-50": (dict(type="ResNeXt", depth=50, out_indices=(3,)), (128, 96)),
    "VGG16-bn": (dict(type="VGG", depth=16, with_bn=True, out_indices=(3, 4)), (128, 96)),
    "AlexNet": (dict(type="AlexNet"), (128, 96)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_backbone_matches_jax(name):
    cfg, side = CASES[name]
    jm, variables, ours = both_backbones(cfg, side, seed=len(name))
    x = _inputs(2, side, seed=3)
    with torch.no_grad():
        got = _forward(ours, x)
    assert_features(got, jax_features(jm, variables, x))


def test_resnest_matches_jax_with_its_stem_padding():
    """ResNeSt-50 at 64 x 64 (JAX's stem padding substituted, see the module
    docstring), and its first stem conv alone at 65 x 65 as the port runs it."""
    jm, variables, ours = both_backbones(dict(type="ResNeSt", depth=50), 64, seed=5)
    x = _inputs(2, 64, seed=6)
    with torch.no_grad():
        got = _forward(_jax_padded_stem(ours), x)
    assert_features(got, jax_features(jm, variables, x))

    from probpose_code_tpu.models.backbones.multistage import ConvBNReLU

    stem = ConvBNReLU(32, 3, stride=2)
    x = _inputs(2, 65, seed=7)
    v = jax_variables(stem, x.shape, seed=8)
    port = PORT_MODELS.build(dict(type="ResNeSt", depth=50)).stem[0].eval()
    port.load_state_dict({k.removeprefix("stem.0."): t for k, t in backbone_state(
        {"params": {"stem0": v["params"]}, "batch_stats": {"stem0": v["batch_stats"]}}).items()}, strict=True)
    with torch.no_grad():
        assert_features([_forward(port, x)], [stem.apply(v, x)])


DEPARTURES = {
    "SEResNet": dict(type="SEResNet", depth=50),
    "SCNet": dict(type="SCNet", depth=50),
    "ResNeSt": dict(type="ResNeSt", depth=50),
    "ShuffleNetV1": dict(type="ShuffleNetV1", groups=3),
    "ShuffleNetV2": dict(type="ShuffleNetV2"),
    "ViPNAS_ResNet": dict(type="ViPNAS_ResNet"),
    "ViPNAS_MobileNetV3": dict(type="ViPNAS_MobileNetV3"),
}


@pytest.mark.parametrize("family", list(DEPARTURES))
def test_padding_departs_from_jax_at_an_even_side(family):
    """At 128 x 128 the JAX "SAME" strided convs pad after the input only,
    the port's on both sides (mmpose's): the features differ by far more than
    the bar."""
    jm, variables, ours = both_backbones(DEPARTURES[family], 128, seed=13)
    x = _inputs(1, 128, seed=14)
    want = np.transpose(np.asarray(jax_features(jm, variables, x)[-1]), (0, 3, 1, 2))
    with torch.no_grad():
        got = _forward(ours, x)[-1].numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() > 1e-2 * np.abs(want).max()


# -- training mode --------------------------------------------------------------------


TRAINED = {
    "SEResNet-50": (dict(type="SEResNet", depth=50), 65),
    "SCNet-50": (dict(type="SCNet", depth=50), 97),
    "ResNeSt-50": (dict(type="ResNeSt", depth=50), 64),
}


@contextlib.contextmanager
def port_in_float64():
    """The port's f32 casts (``Tensor.float``: its BatchNorm and outputs) as
    f64 casts for the duration; its modules take ``.double()`` and ``dtype``
    float64 for their convolutions."""
    saved = torch.Tensor.float
    torch.Tensor.float = lambda self, *args, **kwargs: self.double()
    try:
        yield
    finally:
        torch.Tensor.float = saved


@pytest.mark.parametrize("name", list(TRAINED))
def test_training_step_matches_jax(name):
    """One training step of two crops with BatchNorm in training mode
    (ResNeSt's ``fc_bn`` on the batch of pooled vectors too) and
    ``mean(w * out ** 2)`` of the last stage as the loss (``w`` drawn from a
    seed): the loss, every parameter's gradient and the updated running
    statistics. Both sides compute in f64 (the JAX module's ``dtype``, the
    port's convolutions and its f32 casts, ``port_in_float64``): in f32 the
    gradients of these networks at two small crops move 1-4% between the
    two packages, and 0.4% between the JAX module in f32 and in f64, so f32
    rounding, not the arithmetic, would decide them."""
    cfg, side = TRAINED[name]
    x = ((_smooth_crops(2, 22, size=(side, side)) - 127.5) / 60).astype(np.float64)
    with jax.enable_x64(True), port_in_float64():
        jm = JAX_MODELS.build(dict(cfg, dtype=jnp.float64))
        variables = jax.tree_util.tree_map(lambda a: a.astype(np.float64), jax_variables(jm, (1, side, side, 3), 21))
        ours = PORT_MODELS.build(dict(cfg))
        ours.load_state_dict(backbone_state(variables), strict=True)
        ours.double().train()
        ours.dtype = torch.float64
        if name.startswith("ResNeSt"):
            _jax_padded_stem(ours)
        out_shape = jax.eval_shape(lambda v: jm.apply(v, x, train=False), variables)[-1].shape
        w = np.random.RandomState(23).uniform(0.5, 1.5, out_shape)

        def jax_loss(params):
            outs, new = jm.apply({"params": params, "batch_stats": variables["batch_stats"]}, x, train=True,
                                 mutable=["batch_stats"])
            return jnp.mean(w * outs[-1] ** 2), new

        (loss, new), grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(variables["params"])
        got = _forward(ours, x)[-1]
        ours_loss = (torch.from_numpy(w).permute(0, 3, 1, 2) * got ** 2).mean()
        ours_loss.backward()
        want = backbone_state({"params": _np(grads), "batch_stats": _np(new["batch_stats"])})
    assert got.dtype == torch.float64
    assert float(ours_loss.detach()) == pytest.approx(float(loss), rel=1e-5)
    params = dict(ours.named_parameters())
    assert set(params) <= set(want)
    for key, p in params.items():
        w = want[key].numpy()
        assert np.linalg.norm(p.grad.numpy() - w) <= 1e-5 * np.linalg.norm(w), key
    for key, buf in ours.named_buffers():
        if key.endswith(("running_mean", "running_var")):
            w = want[key].numpy()
            assert np.abs(buf.numpy() - w).max() <= 1e-5 * np.abs(w).max(), key


FROZEN = {
    "frozen_stages=1": dict(type="ResNetV1d", depth=50, stem_channels=16, base_channels=8, frozen_stages=1),
    "FrozenBatchNorm2d": dict(type="ResNet", depth=18, stem_channels=16, base_channels=8,
                              norm_cfg=dict(type="FrozenBatchNorm2d")),
}


@pytest.mark.parametrize("name", list(FROZEN))
def test_frozen_parts_match_jax(name):
    """``ResNet``'s ``frozen_stages`` (the stem and stage 1 of a narrow
    ResNetV1d-50) and ``FrozenBatchNorm2d`` (every BatchNorm of a narrow
    ResNet-18) in one training step, in f64 as ``test_training_step_matches_jax``:
    the loss, every gradient (zero behind the frozen outputs and for the
    frozen BatchNorms' scales and biases) and the running statistics (those
    of the frozen parts unchanged)."""
    cfg, side = FROZEN[name], (64, 48)
    x = ((_smooth_crops(2, 31, size=side) - 127.5) / 60).astype(np.float64)
    with jax.enable_x64(True), port_in_float64():
        jm = JAX_MODELS.build(dict(cfg, dtype=jnp.float64))
        variables = jax.tree_util.tree_map(lambda a: a.astype(np.float64), jax_variables(jm, (1, *side, 3), 32))
        ours = PORT_MODELS.build(dict(cfg))
        ours.load_state_dict(backbone_state(variables), strict=True)
        ours.double().train()
        ours.dtype = torch.float64
        before = {k: v.clone() for k, v in ours.named_buffers()}

        def jax_loss(params):
            outs, new = jm.apply({"params": params, "batch_stats": variables["batch_stats"]}, x, train=True,
                                 mutable=["batch_stats"])
            return jnp.mean(outs[-1] ** 2), new

        (loss, new), grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(variables["params"])
        ours_loss = (_forward(ours, x)[-1] ** 2).mean()
        ours_loss.backward()
        want = backbone_state({"params": _np(grads), "batch_stats": _np(new["batch_stats"])})
    assert float(ours_loss.detach()) == pytest.approx(float(loss), rel=1e-5)
    frozen = 0
    for key, p in ours.named_parameters():
        w = want[key].numpy()
        g = p.grad.numpy() if p.grad is not None else np.zeros_like(w)
        assert np.linalg.norm(g - w) <= 1e-5 * np.linalg.norm(w), key
        frozen += not np.any(w)
    for key, buf in ours.named_buffers():
        if key.endswith(("running_mean", "running_var")):
            w = want[key].numpy()
            assert np.abs(buf.numpy() - w).max() <= 1e-5 * np.abs(w).max(), key
    moved = [k for k, v in ours.named_buffers() if k.endswith("running_mean") and not torch.equal(v, before[k])]
    if name == "FrozenBatchNorm2d":
        assert not moved and frozen == sum(k.endswith(("bn1.weight", "bn1.bias", "bn2.weight", "bn2.bias"))
                                           or ".downsample.1." in k for k, _ in ours.named_parameters())
    else:
        assert moved and not any(k.startswith(("stem.", "layer1.")) for k in moved)
        assert frozen == sum(k.startswith(("stem.", "layer1.")) for k, _ in ours.named_parameters())


# -- ViPNASHead ----------------------------------------------------------------------


VIPNAS_MODEL = dict(
    type="TopdownPoseEstimator",
    data_preprocessor=dict(type="PoseDataPreprocessor", mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375],
                           bgr_to_rgb=True),
    backbone=dict(type="ViPNAS_ResNet", depth=50, wid=(16, 16, 32, 32, 64), dep=(None, 1, 2, 2, 1)),
    head=dict(type="ViPNASHead", in_channels=64, out_channels=17, deconv_out_channels=(32, 32, 32),
              deconv_num_groups=(16, 16, 16), loss=dict(type="KeypointMSELoss", use_target_weight=True),
              decoder=dict(type="MSRAHeatmap", input_size=(65, 97), heatmap_size=(24, 32), sigma=2)),
    test_cfg=dict(flip_test=True))


def test_vipnas_head_predict_matches_jax():
    """A narrow ViPNAS_ResNet with ViPNASHead (16 groups a deconvolution) at
    97 x 65: its heatmaps, and the predict program with flip-TTA and the MSRA
    decode, against the JAX model's on the JAX weights."""
    jm = JaxPoseModel(VIPNAS_MODEL, metainfo=META)
    variables = jax_variables(jm.module, (1, 97, 65, 3), seed=1)
    ours = PoseModel(VIPNAS_MODEL, metainfo=META, device="cpu")
    ours.module.load_state_dict(state_dict_from_jax(variables), strict=True)
    assert ours.module.head.deconv_layers[0].groups == 16
    assert tuple(ours.module.head.deconv_layers[0].weight.shape) == (64, 2, 4, 4)
    crops = np.round(np.random.RandomState(2).rand(2, 97, 65, 3) * 255).astype(np.float32)
    ref = np.asarray(jm.forward(variables, crops))
    with torch.no_grad():
        heatmaps = ours.module(ours.preprocess(torch.from_numpy(crops)))
    assert heatmaps.shape == ref.shape == (2, 17, 32, 24)
    assert np.abs(heatmaps.numpy() - ref).max() < REL * np.abs(ref).max()
    want = {k: np.asarray(v) for k, v in jm.make_predict(jit=True)(variables, crops).items()}
    got = ours.predict(torch.from_numpy(crops))
    assert np.abs(got["heatmaps"].numpy() - want["heatmaps"]).max() < REL * np.abs(want["heatmaps"]).max()
    np.testing.assert_allclose(got["keypoints"].numpy(), want["keypoints"], atol=1e-3 * 97 / 32)
    np.testing.assert_allclose(got["keypoint_scores"].numpy(), want["keypoint_scores"], atol=1e-5)


# -- every shipped config -------------------------------------------------------------


def _model_cfg(config):
    return copy.deepcopy(Config.fromfile(str(ROOT / config))["model"])


def _distinct_models(configs):
    """One config for each distinct backbone config and head (its type and
    deconvolutions)."""
    cases = {}
    for config in configs:
        model = _model_cfg(config)
        head = model["head"]
        cases.setdefault(repr((model["backbone"], head["type"], head.get("deconv_out_channels"),
                               head.get("deconv_num_groups"))), config)
    return sorted(cases.values())


SHAPE_CASES = _distinct_models(BUILT)


@pytest.mark.parametrize("config", SHAPE_CASES)
def test_shipped_model_keys_and_shapes_match_jax(config):
    """Each distinct backbone and head of the shipped configs at its full depth
    and width: the JAX model's variables (``jax.eval_shape`` of its init, as
    zeros) carried by ``state_dict_from_jax`` have the port's keys and
    shapes."""
    cfg = _model_cfg(config)
    jm = JaxPoseModel(cfg, metainfo=META)
    shapes = jax.eval_shape(lambda: jm.module.init(jax.random.PRNGKey(0), jnp.zeros((1, 128, 128, 3)), train=False))
    carried = state_dict_from_jax(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes))
    with torch.device("meta"):
        module = PORT_MODELS.build(dict(cfg["backbone"]))
        head = PORT_MODELS.build(dict(cfg["head"]))
    ours = {f"backbone.{k}": tuple(v.shape) for k, v in module.state_dict().items()}
    ours.update({f"head.{k}": tuple(v.shape) for k, v in head.state_dict().items()})
    assert {k: tuple(v.shape) for k, v in carried.items()} == ours


@pytest.mark.parametrize("config", RESNEST_269)
def test_resnest_269_is_refused(config):
    """The JAX ResNeSt has depths 50-200 (``litehrnet.py:262``): both refuse 269."""
    cfg = _model_cfg(config)
    with pytest.raises(KeyError):
        JaxPoseModel(cfg, metainfo=META).init(seed=0)
    with pytest.raises(KeyError, match="269"):
        init_model(Config.fromfile(str(ROOT / config)), device="cpu")


def test_simcc_vipnas_config_is_refused():
    """The SimCC ViPNAS-MobileNetV3 config waits for ``SimCCHead``; it and
    the three ResNeSt-269 configs are the four of the families' 84 that the
    port refuses."""
    assert (len(CONFIGS), len(RESNEST_269), len(BUILT)) == (84, 3, 80)
    with pytest.raises(KeyError, match="SimCCHead"):
        init_model(Config.fromfile(str(ROOT / SIMCC_MBV3)), device="cpu")


@pytest.mark.parametrize("config", BUILT)
def test_shipped_config_builds_in_the_port(config):
    """Each shipped config of the families (but the refused four) through
    ``init_model(..., device="cpu")`` at its full depth and width, without a
    forward: the model, its datasets' classes and tables (keypoints the
    head's outputs), the optimizer and each evaluator."""
    cfg = Config.fromfile(str(ROOT / config))
    # torch's default initialisation of the convolutions, which ``init_weights`` draws anew, is left out
    with mock.patch.object(torch.nn.modules.conv._ConvNd, "reset_parameters", lambda self: None):
        model = init_model(cfg, device="cpu")
    K = cfg["model"]["head"]["out_channels"]
    assert model.metainfo["num_keypoints"] == K
    for loader in ("train_dataloader", "val_dataloader", "test_dataloader"):
        dataset = cfg[loader]["dataset"]
        assert DATASETS.get(dataset["type"]) is not None, dataset["type"]
        assert parse_pose_metainfo(config_metainfo(dataset))["num_keypoints"] == K, loader
    build_optimizer(model, cfg["optim_wrapper"], cfg["param_scheduler"], 10, cfg["train_cfg"]["max_epochs"])
    for key in ("val_evaluator", "test_evaluator"):
        metrics = copy.deepcopy(cfg[key])
        for metric in metrics if isinstance(metrics, list) else [metrics]:
            if metric.get("ann_file"):  # the dataset's file is not here: the golden persons' instead
                metric["ann_file"] = str(GOLDEN / "e2e_coco.json")
        evaluator = EVALUATORS.build(dict(type="Evaluator", metrics=metrics))
        evaluator.dataset_meta = model.metainfo
        assert evaluator.metrics


# -- SCNet's gate kernels' arithmetic -------------------------------------------------


def _taps(d, n_in, scale):
    """``csrc/sc_gate.cu:taps`` in f32: the two source rows of output row d
    and their weights."""
    s = np.float32(scale) * (np.float32(d) + np.float32(0.5)) - np.float32(0.5)
    s = max(s, np.float32(0.0))
    i0 = int(s)
    l1 = np.float32(s - np.float32(i0))
    return i0, i0 + (1 if i0 < n_in - 1 else 0), np.float32(1.0) - l1, l1


def _window(i, n_out, scale):
    """``csrc/sc_gate.cu:sc_gate_resize_backward_kernel``'s rows (or
    columns) of the output that it visits for source row i."""
    lo = int(np.floor((np.float32(i) - np.float32(0.5)) / np.float32(scale) - np.float32(0.5))) - 1
    hi = int(np.ceil((np.float32(i) + np.float32(1.5)) / np.float32(scale) - np.float32(0.5))) + 1
    return max(0, lo), min(n_out - 1, hi)


@pytest.mark.parametrize("r", [2, 3, 4, 5])
def test_sc_gate_kernel_steps_match_the_twin(r):
    """The kernels' resize on the CPU: its taps give ``F.interpolate``'s
    bilinear upsample (half-pixel centres) of every pooled size SCNet meets,
    and the backward's window visits every output row and column that
    reaches a source row, so its gather is the resize's adjoint; the whole
    backward, emulated in f64 from those taps, against autograd through the
    twin (``sc_gate.self_calibration_plain``) in f64."""
    from probpose_code_torch.ops.kernels.sc_gate import self_calibration_plain

    for n_out in list(range(r, 70)) + [96, 128, 193, 257]:
        n_in = n_out // r
        scale = np.float32(n_in) / np.float32(n_out)
        weights = np.zeros((n_out, n_in))
        for d in range(n_out):
            i0, i1, l0, l1 = _taps(d, n_in, scale)
            weights[d, i0] += l0
            weights[d, i1] += l1
        src = np.random.RandomState(n_out).randn(1, 1, n_in, 1).astype(np.float32)
        up = torch.nn.functional.interpolate(torch.from_numpy(src), size=(n_out, 1), mode="bilinear",
                                             align_corners=False)
        np.testing.assert_allclose(weights @ src[0, 0, :, 0], up[0, 0, :, 0].numpy(), rtol=0,
                                   atol=REL * np.abs(src).max())  # f32 rounding of PyTorch's sums
        for i in range(n_in):
            lo, hi = _window(i, n_out, scale)
            reached = np.nonzero(weights[:, i])[0]
            assert reached.size and lo <= reached.min() and reached.max() <= hi, (n_out, i)

    rng = np.random.RandomState(r)
    H, W = 13 * r + r - 1, 7 * r + 1
    h, w = H // r, W // r
    x, k3, dy = (rng.randn(2, 3, H, W) for _ in range(3))
    k2 = rng.randn(2, 3, h, w)
    Wy = np.zeros((H, h))
    Wx = np.zeros((W, w))
    for mat, n_out, n_in in ((Wy, H, h), (Wx, W, w)):
        for d in range(n_out):
            i0, i1, l0, l1 = _taps(d, n_in, np.float32(n_in) / np.float32(n_out))
            mat[d, i0] += l0
            mat[d, i1] += l1
    s = 1 / (1 + np.exp(-(x + Wy @ k2 @ Wx.T)))
    dx = dy * k3 * s * (1 - s)
    want = (k3 * s, dx, Wy.T @ dx @ Wx, dy * s)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, k2, k3)]
    out = self_calibration_plain(*leaves)
    got = (out, *torch.autograd.grad(out, leaves, torch.from_numpy(dy)))
    for g, w_ in zip(got, (want[0], want[1], want[2], want[3])):
        np.testing.assert_allclose(g.detach().numpy(), w_, rtol=0, atol=1e-6 * np.abs(w_).max())



@pytest.mark.parametrize("radix", [1, 2, 4])
def test_split_attention_kernel_steps_match_the_twin(radix):
    """The split attention kernels' arithmetic on the CPU in f64
    (``csrc/split_attention.cu``): the weights a softmax over the radix with
    its maximum subtracted (a sigmoid at radix 1), the gradient of the splits
    ``dy * att``, and of the logits the softmax's Jacobian applied to the dot
    products ``dy . splits`` over space, ``att * (d - sum(att * d))`` (the
    sigmoid's ``d * att * (1 - att)``), against autograd through the twin
    (``split_attention.split_attention_plain``)."""
    from probpose_code_torch.ops.kernels.split_attention import split_attention_plain

    rng = np.random.RandomState(radix)
    splits, logits, dy = rng.randn(2, radix, 5, 7, 3), 3 * rng.randn(2, radix, 5), rng.randn(2, 5, 7, 3)
    if radix == 1:
        att = 1 / (1 + np.exp(-logits))
    else:
        e = np.exp(logits - logits.max(axis=1, keepdims=True))
        att = e / e.sum(axis=1, keepdims=True)
    dots = np.einsum("bchw,brchw->brc", dy, splits)
    dlogits = dots * att * (1 - att) if radix == 1 else att * (dots - (att * dots).sum(axis=1, keepdims=True))
    want = ((splits * att[..., None, None]).sum(axis=1), dy[:, None] * att[..., None, None], dlogits)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (splits, logits)]
    out = split_attention_plain(*leaves)
    got = (out, *torch.autograd.grad(out, leaves, torch.from_numpy(dy)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=0, atol=1e-12 * np.abs(w).max())
