"""ViTPose-L and ViTPose-H (ViT + the classic deconvolutional ``HeatmapHead``,
UDP codec) on the CPU: the port against the JAX package, on the same weights
and inputs.

The configs are the recipes
``configs/body_2d_keypoint/topdown_heatmap/coco/td-hm_ViTPose-large_8xb64-210e_coco-256x192.py``
and ``td-hm_ViTPose-huge_8xb64-210e_coco-256x192.py`` shrunk to 2 ViT layers
of 2 heads: shaped like ViT-L's heads (width 128, d = 64, feed-forward 512)
and like ViT-H's (width 160, d = 80, feed-forward 640; the JAX kernel's shape
rule takes d = 80, ``vit_layer.py:131-135``). Both run in f32 with exact
(erf) GELU at the recipe's 256 x 192 input (192 tokens); the head keeps the
recipes' two deconvolutions (kernel 4, stride 2) at 32 channels and gives
64 x 48 UDP maps. ``drop_path_rate`` is 0 where the two packages are
compared (their random streams differ). The JAX variables move to the port
through ``state_dict_from_jax``. The port runs its defaults: K1's twin in
predict, and in training, since the GELU is exact, the eager block with
K4's twin. The JAX side runs its XLA graph, or its fused layer kernel in
interpret mode (``fused_layers=True``).

The bars are ``tests/test_torch_vitpose.py``'s, with its reasons (both sides
in f32, other summation orders, K1's unshifted softmax): heatmaps atol 1e-5;
predict keypoints 1e-3 heatmap pixels, times the length of the decode's
Newton step where it leaves the pixel (``test_predict_matches_jax``), and
scores 1e-5; the loss dict rel
1e-4 and every gradient within 1e-4 of that parameter's largest; three
optimizer steps with losses at rel 2e-5 and each parameter within 2e-3 of
its change in l2 norm. Plain Adam on the ViT-L-shaped model is held to these
bars with both packages in f64 (the ``f64`` fixture), since in f32 rounding
alone carries it over (``test_three_optimizer_steps_match_jax``).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probpose_code_torch.config import Config
from probpose_code_torch.engine.checkpoint import state_dict_from_jax
from probpose_code_torch.engine.optim import build_optimizer
from probpose_code_torch.models.backbones import vit as vit_module
from probpose_code_torch.models.builder import PoseModel
from probpose_code_torch.ops.heatmap import heatmap_maximum_batch
from probpose_code_torch.ops.kernels.vit_layer import fits
from probpose_code_torch.parallel import create_train_state, make_train_step
from probpose_code_tpu.engine.optim import build_optimizer as jax_build_optimizer
from probpose_code_tpu.models import PoseModel as JaxPoseModel
from probpose_code_tpu.parallel import create_train_state as jax_create_train_state
from probpose_code_tpu.parallel import make_train_step as jax_make_train_step
from tests.test_torch_vitpose import MAX_EPOCHS, META, SCHEDULE, STEPS, STEPS_PER_EPOCH, _np, _plain, make_batch

COCO = "configs/body_2d_keypoint/topdown_heatmap/coco/"
RECIPES = {
    "large": Config.fromfile(COCO + "td-hm_ViTPose-large_8xb64-210e_coco-256x192.py"),
    "huge": Config.fromfile(COCO + "td-hm_ViTPose-huge_8xb64-210e_coco-256x192.py"),
}
# the 192x256 recipes' optimizer: plain Adam, no layer decay, no clipping
ADAM_RECIPE = Config.fromfile(COCO + "td-hm_ViTPose-large_8xb32-210e_coco-192x256.py")
# the narrow shapes: ViT-L's heads (d = 64) and ViT-H's (d = 80)
ARCHS = {
    "large": dict(embed_dims=128, num_layers=2, num_heads=2, feedforward_channels=512),
    "huge": dict(embed_dims=160, num_layers=2, num_heads=2, feedforward_channels=640),
}
# the four shipped configs that set no ``deconv_out_channels``: the head's default three deconvolutions
DEFAULT_DECONV = ["td-hm_ViTPose-small_8xb64-210e_coco-256x192.py", "td-hm_ViTPose-base_8xb64-210e_coco-256x192.py",
                  "td-hm_ViTPose-large_8xb32-210e_coco-192x256.py", "td-hm_ViTPose-huge_8xb32-210e_coco-192x256.py"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tier-1 runs six test workers at once; one torch thread each."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _cfg(arch, dtype=None, **backbone):
    """The narrow model of the arch; ``dtype``, where given, that of its
    backbone and head."""
    cfg = copy.deepcopy(_plain(dict(RECIPES[arch]["model"])))
    cfg["backbone"].update(arch=ARCHS[arch], drop_path_rate=0.0, **backbone)
    cfg["head"].update(in_channels=ARCHS[arch]["embed_dims"], deconv_out_channels=(32, 32))
    if dtype is not None:
        cfg["backbone"]["dtype"] = cfg["head"]["dtype"] = dtype
    return cfg


def _optim_wrapper(recipe):
    return copy.deepcopy(_plain(dict(recipe["optim_wrapper"])))


@pytest.fixture(scope="module", params=["large", "huge"])
def arch(request):
    """A narrow model of the arch: its JAX variables (seed 0) and a batch."""
    name = request.param
    return name, _np(JaxPoseModel(_cfg(name), metainfo=META).init(seed=0)), make_batch(2, seed=0)


def _port_model(arch_name, variables, dtype=None, **backbone):
    model = PoseModel(_cfg(arch_name, dtype, **backbone), metainfo=META, device="cpu")
    if dtype == "float64":
        model.module.double()
    model.module.load_state_dict(state_dict_from_jax(variables), strict=True)
    return model


@pytest.fixture
def f64(monkeypatch):
    """Both packages computing the training step in f64, a witness of what
    f32 rounding does (neither package computes in f64 otherwise): JAX's
    x64 mode, every ``jnp.float32`` of the JAX package read as f64 and
    ``"float64"`` a config dtype of both; the port's ``Tensor.float`` keeping
    f64 (its LayerNorm, softmax, head and loss cast through it)."""
    import sys

    from probpose_code_tpu.models import builder as jax_builder

    class F64Numpy:  # jax.numpy with float32 read as float64
        float32 = jnp.float64

        def __getattr__(self, name):
            return getattr(jnp, name)

    for name, mod in list(sys.modules.items()):
        if name.startswith("probpose_code_tpu") and getattr(mod, "jnp", None) is jnp:
            monkeypatch.setattr(mod, "jnp", F64Numpy())
    monkeypatch.setitem(jax_builder._DTYPE_MAP, "float64", jnp.float64)
    monkeypatch.setitem(vit_module._DTYPES, "float64", torch.float64)
    to_float = torch.Tensor.float
    monkeypatch.setattr(torch.Tensor, "float",
                        lambda t, *a, **k: t if t.dtype == torch.float64 else to_float(t, *a, **k))
    with jax.enable_x64(True):
        yield


def test_full_archs_take_k1_in_predict_and_k4_in_training():
    """At full width every ViT-L (C = 1024, 16 heads of 64) and ViT-H (C =
    1280, 16 heads of 80) layer meets K1's shape rule at 192 tokens, and the
    recipes ask for exact GELU, which K3 does not compute: predict runs K1,
    training the eager block with K4. On the narrow model each layer goes so
    (the kernels' wrappers counted through stand-ins)."""
    for name, (C, H) in (("large", (1024, 16)), ("huge", (1280, 16))):
        backbone = RECIPES[name]["model"]["backbone"]
        arch = vit_module.VIT_ARCH_ZOO[backbone["arch"]]
        assert (arch["embed_dims"], arch["num_heads"]) == (C, H)
        assert fits(192, C, H) and not backbone.get("approximate_gelu", False)
        assert backbone["patch_padding"] == 2 and backbone.get("dtype", "float32") == "float32"
    calls = dict(k1=0, k3=0, k4=0)

    def counted(key, fn):
        def wrapper(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        return wrapper

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(vit_module, "vit_layer_prepared", counted("k1", vit_module.vit_layer_prepared))
        mp.setattr(vit_module, "vit_layer_train", counted("k3", vit_module.vit_layer_train))
        mp.setattr(vit_module, "fused_attention", counted("k4", vit_module.fused_attention))
        backbone = vit_module.VisionTransformer(arch=ARCHS["huge"], drop_path_rate=0.55).eval()
        x = torch.randn(1, 3, 256, 192)
        with torch.inference_mode():
            backbone(x)
        assert calls == dict(k1=2, k3=0, k4=0)
        backbone.train()
        backbone(x, torch.Generator().manual_seed(0))[0].sum().backward()
        assert calls == dict(k1=2, k3=0, k4=2)


@pytest.mark.parametrize("route", ["k1", "eager"])
def test_heatmaps_match_jax(arch, route):
    """``k1``: the port's K1 twin against the JAX fused layer kernel
    (interpret mode); ``eager``: the port's eager block (K4's twin) against
    the JAX XLA graph."""
    name, variables, _ = arch
    fused = route == "k1"
    model = _port_model(name, variables, fused_layers=None if fused else False)
    x = np.random.RandomState(2).randn(2, 256, 192, 3).astype(np.float32)
    want = np.asarray(JaxPoseModel(_cfg(name, fused_layers=fused)).module.apply(variables, x, train=False))
    with torch.inference_mode():
        got = model.module(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 17, 64, 48)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_predict_matches_jax(arch):
    """The predict program (flip-TTA on one doubled batch, argmax + DARK-UDP,
    input-space scale) against the JAX ``make_predict`` on the same crops:
    the averaged heatmaps and the scores, each map's argmax exactly, and the
    keypoints at 1e-3 heatmap pixels times the length of the JAX
    DARK-UDP step where it exceeds one pixel. The step is a Newton step that
    divides by the blurred log-map's curvature, which random weights leave
    near 0: it carried one keypoint 14 heatmap pixels off the map at ViT-L's
    shape, and there heatmaps within 1e-5 gave keypoints 5.7e-3 pixels
    apart (measured); the same decode of the same maps differed by 3.8e-3
    (f32 in another order). Where the step stays within a pixel, as on a
    peak, the bar is the JAX package's for a decode."""
    name, variables, _ = arch
    crops = np.round(np.random.RandomState(6).rand(2, 256, 192, 3) * 255).astype(np.float32)
    want = {k: np.array(v) for k, v in JaxPoseModel(_cfg(name), metainfo=META).make_predict(jit=False)(
        variables, crops).items()}
    got = {k: v.numpy() for k, v in _port_model(name, variables).predict(torch.from_numpy(crops)).items()}
    assert set(got) == set(want) == {"keypoints", "keypoint_scores", "heatmaps"}
    np.testing.assert_allclose(got["heatmaps"], want["heatmaps"], atol=1e-5)
    np.testing.assert_allclose(got["keypoint_scores"], want["keypoint_scores"], atol=1e-5)
    argmax = [heatmap_maximum_batch(torch.from_numpy(side["heatmaps"]))[0].numpy() for side in (got, want)]
    np.testing.assert_array_equal(*argmax)
    to_hm = np.array([(48 - 1) / 192, (64 - 1) / 256], np.float32)  # input -> heatmap pixels
    step = np.linalg.norm(want["keypoints"] * to_hm - argmax[1], axis=-1, keepdims=True)
    assert (np.abs(got["keypoints"] - want["keypoints"]) * to_hm <= 1e-3 * np.maximum(step, 1.0)).all()


def test_loss_dict_and_every_gradient_match_jax(arch):
    name, variables, batch = arch
    jm = JaxPoseModel(_cfg(name), metainfo=META)

    def loss(params):
        return jm.loss_fn({"params": params, **{k: v for k, v in variables.items() if k != "params"}}, batch,
                          rngs={"dropout": jax.random.PRNGKey(0)})

    (total, (losses, _)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(variables["params"])
    want_grads = {k: v.numpy() for k, v in state_dict_from_jax(
        {"params": _np(grads), "batch_stats": variables["batch_stats"]}).items()}
    model = _port_model(name, variables)
    got_total, (got_losses, _) = model.loss_fn({k: torch.tensor(np.asarray(v)) for k, v in batch.items()})
    got_total.backward()
    assert set(got_losses) == set(losses) == {"loss_kpt", "acc_pose"}
    for k, want in losses.items():
        assert float(got_losses[k]) == pytest.approx(float(want), rel=1e-4), k
    assert float(got_total) == pytest.approx(float(total), rel=1e-4)
    got_grads = {n: p.grad.numpy() for n, p in model.module.named_parameters()}
    assert set(got_grads) <= set(want_grads)
    for n, got in got_grads.items():
        want = want_grads[n]
        assert got.shape == want.shape and np.abs(want).max() > 0, n
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max(), n


def _three_steps_match_jax(name, variables, batch, recipe, dtype=None):
    """Three steps of ``recipe``'s optimizer chain in both packages from the
    same variables and batch: the losses at rel 2e-5, and every parameter and
    BatchNorm statistic within 2e-3 of its change in l2 norm."""
    wrapper = _optim_wrapper(recipe)
    jm = JaxPoseModel(_cfg(name, dtype), metainfo=META)
    tx, _ = jax_build_optimizer(variables["params"], wrapper, SCHEDULE, STEPS_PER_EPOCH, MAX_EPOCHS)
    state = jax_create_train_state(variables, tx)
    jax_step = jax_make_train_step(jm, tx, mesh=None, donate=False)
    model = _port_model(name, variables, dtype)
    optimizer, _ = build_optimizer(model, wrapper, SCHEDULE, STEPS_PER_EPOCH, MAX_EPOCHS)
    port_state = create_train_state(model, optimizer)
    port_step = make_train_step(model, optimizer)
    tbatch = {k: torch.tensor(np.asarray(v)) for k, v in batch.items()}
    if "paramwise_cfg" in wrapper:
        scales = {g["lr_scale"] for g in optimizer.groups}
        rate, layers = wrapper["paramwise_cfg"]["layer_decay_rate"], wrapper["paramwise_cfg"]["num_layers"]
        assert scales == {rate ** (layers + 1 - i) for i in (0, 1, 2, layers + 1)}
    else:
        assert {g["lr_scale"] for g in optimizer.groups} == {1.0} and optimizer.max_norm is None
    for _ in range(STEPS):
        state, want = jax_step(state, batch, jax.random.PRNGKey(0))
        port_state, got = port_step(port_state, tbatch, torch.Generator().manual_seed(0))
        assert set(got) == set(want)
        for k in want:
            assert float(got[k]) == pytest.approx(float(want[k]), rel=2e-5, abs=1e-6), k
    # every parameter and BatchNorm's running statistics
    start = {k: v.numpy() for k, v in state_dict_from_jax(variables).items() if not k.endswith("num_batches_tracked")}
    final = {k: v.numpy() for k, v in state_dict_from_jax(
        {"params": _np(state.params), "batch_stats": _np(state.batch_stats)}).items() if k in start}
    got = {k: v.numpy() for k, v in model.module.state_dict().items()}
    for n, want in final.items():
        change = want - start[n]
        assert got[n].dtype == want.dtype == np.dtype(dtype or "float32"), n
        assert np.abs(change).max() > 0, n
        assert np.linalg.norm(got[n] - want) <= 2e-3 * np.linalg.norm(change), n


# each recipe's optimizer on the model of its arch: AdamW with layer decay 0.8 over 24 layers (ViT-L) and 0.85
# over 32 (ViT-H), both clipped at 1.0, and the 192x256 recipes' plain Adam on the ViT-H-shaped model
@pytest.mark.parametrize("name,recipe", [("large", RECIPES["large"]), ("huge", RECIPES["huge"]),
                                         ("huge", ADAM_RECIPE)], ids=["adamw_0.8", "adamw_0.85", "adam"])
def test_three_optimizer_steps_match_jax(name, recipe):
    """Three steps of the recipe's optimizer chain in both packages, in f32.
    Measured (each parameter's l2 difference over its change; bar 2e-3):
    AdamW 0.8 on the ViT-L-shaped model 1.90e-3 (``layers.1.ln2.weight``),
    AdamW 0.85 on the ViT-H-shaped one 1.84e-3 (``layers.0.ln1.weight``),
    plain Adam there 6.8e-4; under AdamW every other tensor below 5.4e-4.
    Plain Adam on the ViT-L-shaped model measured 3.09e-3 in f32, over the
    bar on five tensors: ``layers.1.ln2.weight`` 3.09e-3,
    ``layers.0.ln1.weight`` 2.75e-3, ``layers.1.ln1.weight`` 2.45e-3,
    ``head.deconv_layers.0.weight`` 2.25e-3 and ``layers.1.ffn.layers.0.0.weight``
    2.23e-3 (this file's ``_three_steps_match_jax`` with its last assertion
    lifted). The same three steps with both packages in f64 agree to 5.1e-6
    on each of those (``test_plain_adam_matches_jax_in_f64``): at full lr
    Adam divides each first moment by its spread, and where the moment
    nearly cancels the packages' f32 rounding moves the step, not the port's
    arithmetic. So that case runs in f64, and the f32 case on the
    ViT-H-shaped model."""
    variables = _np(JaxPoseModel(_cfg(name), metainfo=META).init(seed=0))
    _three_steps_match_jax(name, variables, make_batch(2, seed=0), recipe)


def test_plain_adam_matches_jax_in_f64(arch, f64):
    """The 192x256 recipes' plain Adam, three steps, with both packages in
    f64 (``f64``) from the f32 case's variables and batch, held to the f32
    case's bars. Measured: on the ViT-L-shaped model every tensor within
    6.0e-5 of its change (``layers.0.ln1.bias``; 2.8e-6 on
    ``layers.1.ln1.weight``, less on ``layers.1.ln2.weight``), against
    3.09e-3 in f32 (``test_three_optimizer_steps_match_jax``); on the
    ViT-H-shaped one within 7.8e-6, against 6.8e-4 in f32. The inputs still
    pass the port's f32 normalisation constants."""
    name, variables, batch = arch
    lift = lambda a: a.astype(np.float64) if a.dtype == np.float32 else a  # noqa: E731
    _three_steps_match_jax(name, jax.tree_util.tree_map(lift, variables), {k: lift(v) for k, v in batch.items()},
                           ADAM_RECIPE, dtype="float64")


@pytest.mark.parametrize("config", DEFAULT_DECONV)
def test_configs_without_deconv_channels_give_128x96_maps_as_jax(config):
    """Four shipped configs set no ``deconv_out_channels``, so their heads
    take the default three deconvolutions of 256 and give 128 x 96 maps
    beside the codec's 64 x 48: the JAX package builds them so, and so does
    the port (not a port fault; the backbone narrowed, the head as
    shipped)."""
    recipe = Config.fromfile(COCO + config)
    cfg = copy.deepcopy(_plain(dict(recipe["model"])))
    assert "deconv_out_channels" not in cfg["head"] and recipe["codec"]["heatmap_size"] == (48, 64)
    arch = dict(ARCHS["large"], embed_dims=32, feedforward_channels=64)
    cfg["backbone"].update(arch=arch)
    cfg["head"].update(in_channels=32)
    x = np.zeros((1, 256, 192, 3), np.float32)
    jm = JaxPoseModel(cfg, metainfo=META)
    want = jax.eval_shape(lambda: jm.module.apply(jm.init(seed=0), jnp.asarray(x), train=False))
    model = PoseModel(cfg, metainfo=META, device="cpu")
    with torch.inference_mode():
        got = model.module(torch.from_numpy(x))
    assert tuple(want.shape) == tuple(got.shape) == (1, 17, 128, 96)
    assert [tuple(m.weight.shape) for m in model.module.head.deconv_layers if isinstance(m, torch.nn.ConvTranspose2d)] \
        == [(32, 256, 4, 4), (256, 256, 4, 4), (256, 256, 4, 4)]


@pytest.mark.slow
@pytest.mark.parametrize("name", ["large", "huge"])
def test_full_width_builds_as_jax(name):
    """The recipe at full width: the port's state dict, through the JAX
    converter, has the JAX model's tree and shapes (``jax.eval_shape``)."""
    from probpose_code_tpu.engine.checkpoint import convert_torch_state_dict

    cfg = _plain(dict(RECIPES[name]["model"]))
    sd = PoseModel(cfg, metainfo=META, device="cpu").module.state_dict()
    converted = convert_torch_state_dict({k: v.numpy() for k, v in sd.items()},
                                         num_layers=vit_module.VIT_ARCH_ZOO[name]["num_layers"])
    init = jax.eval_shape(lambda: JaxPoseModel(cfg, metainfo=META).init(seed=0))
    for part in ("params", "batch_stats"):
        assert jax.tree_util.tree_structure(converted[part]) == jax.tree_util.tree_structure(init[part])
        for a, b in zip(jax.tree_util.tree_leaves(converted[part]), jax.tree_util.tree_leaves(init[part])):
            assert a.shape == b.shape
