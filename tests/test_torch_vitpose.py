"""ViTPose-B-simple (ViT + FeatureMapProcessor + HeatmapHead, UDP codec) on
the CPU: the port against the JAX package, on the same weights and inputs.

The config is the recipe
``configs/body_2d_keypoint/topdown_heatmap/coco/td-hm_ViTPose-base-simple_8xb64-210e_coco-256x192.py``
shrunk to 2 ViT layers of width 64 with 2 heads (d = 32) and a feed-forward
width of 256, in f32 with exact (erf) GELU, at the recipe's 256 x 192 input
(192 tokens), bilinear x4 neck, 3 x 3 final layer and 64 x 48 UDP maps.
``drop_path_rate`` is 0 where the two packages are compared (their random
streams differ). The JAX ``HeatmapHead`` reads the recipe's
``final_layer=dict(kernel_size=3)`` as a 1 x 1 layer (inside the bound flax
module the dict is a ``FrozenDict``, which its ``isinstance(..., dict)``
test misses); the port builds the recipe's 3 x 3 layer, so both packages
are also given ``final_layer_kernel_size=3``, which the JAX head does read. The JAX variables move to the port through
``state_dict_from_jax``. The JAX side runs its XLA graph; the port runs its
defaults: K1's twin in predict, and in training, since the GELU is exact,
the eager block with K4's twin.

Bars, with their reasons: both sides compute in f32 and differ in summation
order, and K1's twin uses the clamped, unshifted softmax where the JAX graph
shifts by the maximum (the same values in exact arithmetic):
- the neck against ``jax.image.resize``: atol 1e-6 (one bilinear formula);
- heatmaps: atol 1e-5; UDP targets: atol 1e-6;
- predict with flip-TTA: keypoints atol 1e-3 heatmap pixels, the JAX
  package's bar for a decode (``tests/test_ops/test_pallas_decode.py:63``),
  and scores 1e-5. DARK-UDP's Newton step divides by the blurred log-map's
  curvature, which random weights leave small: heatmaps that differ by
  1.2e-6 moved one keypoint by 4.7e-4 heatmap pixels (measured), while the
  decode itself, given the same heatmaps, agrees to 3e-5 input pixels;
- the loss dict: rel 1e-4; every gradient: max |diff| <= 1e-4 of that
  parameter's largest |gradient|;
- three AdamW steps with layer decay 0.75: losses rel 2e-5, and each
  parameter's difference, in l2 norm, within 2e-3 of its change (the bars
  of ``tests/test_torch_train.py``, with its reasons).
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
from probpose_code_torch.models.builder import PoseModel
from probpose_code_torch.models.necks.necks import FeatureMapProcessor
from probpose_code_torch.ops.encode import generate_udp_gaussian_device
from probpose_code_torch.parallel import create_train_state, make_train_step
from probpose_code_tpu.engine.checkpoint import convert_torch_state_dict
from probpose_code_tpu.engine.optim import build_optimizer as jax_build_optimizer
from probpose_code_tpu.engine.optim import make_lr_scale_tree, make_wd_mask_tree
from probpose_code_tpu.models import PoseModel as JaxPoseModel
from probpose_code_tpu.models.necks.necks import FeatureMapProcessor as JaxFeatureMapProcessor
from probpose_code_tpu.ops.encode import generate_udp_gaussian_device as jax_generate_udp_gaussian_device
from probpose_code_tpu.parallel import create_train_state as jax_create_train_state
from probpose_code_tpu.parallel import make_train_step as jax_make_train_step

RECIPE = Config.fromfile(
    "configs/body_2d_keypoint/topdown_heatmap/coco/td-hm_ViTPose-base-simple_8xb64-210e_coco-256x192.py"
)
META = {"flip_indices": [0, 2, 1, 4, 3, 6, 5, 8, 7, 10, 9, 12, 11, 14, 13, 16, 15]}
# a warmup and a milestone inside the first steps, so the lr moves
SCHEDULE = [
    dict(type="LinearLR", begin=0, end=4, start_factor=0.25, by_epoch=False),
    dict(type="MultiStepLR", begin=0, end=10, milestones=[1], gamma=0.5, by_epoch=True),
]
STEPS_PER_EPOCH, MAX_EPOCHS, STEPS = 2, 10, 3


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
        return type(obj)(_plain(v) for v in obj)
    return obj


def _cfg(drop_path_rate=0.0):
    cfg = copy.deepcopy(_plain(dict(RECIPE["model"])))
    cfg["backbone"].update(arch=dict(embed_dims=64, num_layers=2, num_heads=2, feedforward_channels=256),
                           drop_path_rate=drop_path_rate)
    cfg["head"].update(in_channels=64, final_layer_kernel_size=3)
    return cfg


def _optim_wrapper():
    return copy.deepcopy(_plain(dict(RECIPE["optim_wrapper"])))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def make_batch(B, seed):
    """Raw crops, heatmap-space keypoints (some outside the 48 x 64 map, some
    invisible) and the codec's keypoint weights."""
    rng = np.random.RandomState(seed)
    kpts = np.stack([rng.uniform(-6, 54, (B, 17)), rng.uniform(-6, 70, (B, 17))], axis=-1).astype(np.float32)
    vis = (rng.rand(B, 17) > 0.2).astype(np.float32)
    return dict(
        inputs=np.round(rng.rand(B, 256, 192, 3) * 255).astype(np.float32),
        kpts_hm=kpts, kpts_visible=vis, keypoint_weights=vis.copy(),
    )


def _torch_batch(batch):
    return {k: torch.tensor(np.asarray(v)) for k, v in batch.items()}


@pytest.fixture(scope="module")
def setup():
    variables = _np(JaxPoseModel(_cfg(), metainfo=META).init(seed=0))
    return variables, make_batch(2, seed=0)


def _port_model(variables, **kw):
    model = PoseModel(_cfg(**kw), metainfo=META, device="cpu")
    model.module.load_state_dict(state_dict_from_jax(variables), strict=True)
    return model


def test_recipe_final_layer_kernel_sizes():
    """The recipe's head as shipped (``final_layer=dict(kernel_size=3,
    padding=1)``, no ``final_layer_kernel_size``): the JAX package builds a
    1 x 1 final layer, the port the recipe's 3 x 3 one. This pins the
    divergence; the other tests give both packages
    ``final_layer_kernel_size=3``."""
    cfg = _cfg()
    del cfg["head"]["final_layer_kernel_size"]
    assert cfg["head"]["final_layer"] == dict(kernel_size=3, padding=1)
    jax_weight = state_dict_from_jax(_np(JaxPoseModel(cfg, metainfo=META).init(seed=0)))["head.final_layer.weight"]
    port_weight = PoseModel(cfg, metainfo=META, device="cpu").module.state_dict()["head.final_layer.weight"]
    assert tuple(jax_weight.shape) == (17, 64, 1, 1)
    assert tuple(port_weight.shape) == (17, 64, 3, 3)


def test_neck_matches_jax_resize():
    """x4 bilinear upsampling and ReLU, and the select / concat form."""
    rng = np.random.RandomState(0)
    a = rng.randn(2, 16, 12, 8).astype(np.float32)  # NHWC, as the JAX neck takes it
    b = rng.randn(2, 8, 6, 4).astype(np.float32)
    for kw, inputs in ((dict(scale_factor=4.0, apply_relu=True), (a,)),
                       (dict(select_index=(0, 1), concat=True, scale_factor=2.0), (a, b))):
        want = JaxFeatureMapProcessor(**kw).apply({}, tuple(map(jnp.asarray, inputs)))
        got = FeatureMapProcessor(**kw)(tuple(torch.from_numpy(x).permute(0, 3, 1, 2) for x in inputs))
        assert len(got) == len(want) == 1
        np.testing.assert_allclose(got[0].permute(0, 2, 3, 1).numpy(), np.asarray(want[0]), atol=1e-6)


def test_udp_targets_match_jax():
    rng = np.random.RandomState(1)
    kpts = np.stack([rng.uniform(-12, 60, (3, 17)), rng.uniform(-12, 76, (3, 17))], axis=-1).astype(np.float32)
    kpts[0, :4] = [[-12.0, 10.0], [50.5, 3.2], [20.3, -6.6], [55.0, 70.0]]  # windows off or partly off the map
    vis = (rng.rand(3, 17) > 0.2).astype(np.float32)
    vis[0, :4] = 1.0
    want = np.asarray(jax_generate_udp_gaussian_device(jnp.asarray(kpts), jnp.asarray(vis), (48, 64), 2.0))
    got = generate_udp_gaussian_device(torch.from_numpy(kpts), torch.from_numpy(vis), (48, 64), 2.0).numpy()
    assert got.shape == (3, 17, 64, 48)
    np.testing.assert_allclose(got, want, atol=1e-6)
    # windows off the map, and two whose centres lie off it but whose windows reach it
    assert not want[0, 0].any() and not want[0, 3].any() and want[0, 1].any() and want[0, 2].any()


@pytest.mark.parametrize("fused_layers", [None, False], ids=["k1_twin", "eager_k4_twin"])
def test_heatmaps_match_jax(setup, fused_layers):
    variables, _ = setup
    cfg = _cfg()
    cfg["backbone"]["fused_layers"] = fused_layers
    model = PoseModel(cfg, device="cpu")
    model.module.load_state_dict(state_dict_from_jax(variables), strict=True)
    x = np.random.RandomState(2).randn(2, 256, 192, 3).astype(np.float32)
    want = np.asarray(JaxPoseModel(_cfg()).module.apply(variables, x, train=False))
    with torch.inference_mode():
        got = model.module(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 17, 64, 48)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_predict_matches_jax(setup):
    """The predict program (flip-TTA on one doubled batch, argmax + DARK-UDP,
    input-space scale) against the JAX ``make_predict`` on the same crops."""
    variables, _ = setup
    crops = np.round(np.random.RandomState(6).rand(3, 256, 192, 3) * 255).astype(np.float32)
    want = {k: np.asarray(v) for k, v in JaxPoseModel(_cfg(), metainfo=META).make_predict(jit=False)(
        variables, crops).items()}
    got = {k: v.numpy() for k, v in _port_model(variables).predict(torch.from_numpy(crops)).items()}
    assert set(got) == set(want) == {"keypoints", "keypoint_scores", "heatmaps"}
    to_hm = np.array([(48 - 1) / 192, (64 - 1) / 256], np.float32)  # input -> heatmap pixels
    np.testing.assert_allclose(got["keypoints"] * to_hm, want["keypoints"] * to_hm, atol=1e-3)
    np.testing.assert_allclose(got["keypoint_scores"], want["keypoint_scores"], atol=1e-5)
    np.testing.assert_allclose(got["heatmaps"], want["heatmaps"], atol=1e-5)


def test_inference_topdown_gives_heatmap_fields_only(setup):
    """``inference_topdown`` with a heatmap head: keypoints and scores in
    image space, mapped from the predict program's input-space keypoints,
    and none of the ProbMapHead's fields."""
    from probpose_code_torch.apis import inference_topdown
    from probpose_code_torch.apis.inference import crop_batch

    variables, _ = setup
    model = PoseModel(_cfg(), device="cpu")  # the COCO metainfo, as init_model gives it
    model.module.load_state_dict(state_dict_from_jax(variables), strict=True)
    rng = np.random.RandomState(7)
    img = (rng.rand(120, 160, 3) * 255).astype(np.uint8)
    boxes = np.array([[10, 10, 90, 110], [50, 5, 150, 115]], np.float32)
    samples = inference_topdown(model, img, boxes)
    crops, centers, scales = crop_batch(img, boxes, model.input_size, "cpu")
    pred = model.predict(crops)["keypoints"].numpy()
    for i, s in enumerate(samples):
        inst = s.pred_instances
        assert {k for k, _ in inst.items()} == {"keypoints", "keypoint_scores", "bboxes", "bbox_scores"}
        assert inst.keypoints.shape == (1, 17, 2) and inst.keypoint_scores.shape == (1, 17)
        want = pred[i] / np.array(model.input_size, np.float32) * scales[i] + centers[i] - 0.5 * scales[i]
        np.testing.assert_allclose(inst.keypoints[0], want, atol=1e-3)


def test_other_heatmap_codecs_are_refused():
    """Only the UDP, MSRA and Megvii decodes of a plain heatmap head are
    ported: another codec is refused when the predict program is made, not
    decoded as UDP."""
    cfg = _cfg()
    cfg["head"]["decoder"] = dict(type="ArgMaxProbMap", input_size=(192, 256), heatmap_size=(48, 64), sigma=-1)
    with pytest.raises(NotImplementedError, match="ArgMaxProbMap"):
        PoseModel(cfg, metainfo=META, device="cpu").make_predict()


@pytest.fixture(scope="module")
def jax_run(setup):
    """The JAX package on one batch (value and grad) and over three steps."""
    variables, batch = setup
    jm = JaxPoseModel(_cfg(), metainfo=META)

    def loss(params):
        return jm.loss_fn({"params": params, **{k: v for k, v in variables.items() if k != "params"}}, batch,
                          rngs={"dropout": jax.random.PRNGKey(0)})

    (total, (losses, _)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(variables["params"])
    tx, _ = jax_build_optimizer(variables["params"], _optim_wrapper(), SCHEDULE, STEPS_PER_EPOCH, MAX_EPOCHS)
    state = jax_create_train_state(variables, tx)
    step = jax_make_train_step(jm, tx, mesh=None, donate=False)
    step_losses = []
    for _ in range(STEPS):
        state, metrics = step(state, batch, jax.random.PRNGKey(0))
        step_losses.append({k: float(v) for k, v in metrics.items()})
    return dict(
        total=float(total), losses={k: float(v) for k, v in losses.items()},
        grads={k: v.numpy() for k, v in state_dict_from_jax({"params": _np(grads)}).items()},
        step_losses=step_losses,
        final={k: v.numpy() for k, v in state_dict_from_jax({"params": _np(state.params)}).items()},
    )


@pytest.fixture(scope="module")
def torch_run(setup):
    """The port on the same batch: one loss and backward, then three steps."""
    variables, batch = setup
    tbatch = _torch_batch(batch)
    model = _port_model(variables)
    total, (losses, _) = model.loss_fn(tbatch)
    total.backward()
    side = dict(
        total=float(total.detach()), losses={k: float(v.detach()) for k, v in losses.items()},
        grads={n: p.grad.numpy().copy() for n, p in model.module.named_parameters()},
    )
    model = _port_model(variables)
    optimizer, _ = build_optimizer(model, _optim_wrapper(), SCHEDULE, STEPS_PER_EPOCH, MAX_EPOCHS)
    state = create_train_state(model, optimizer)
    step = make_train_step(model, optimizer)
    side["step_losses"] = []
    for _ in range(STEPS):
        state, metrics = step(state, tbatch, torch.Generator().manual_seed(0))
        side["step_losses"].append({k: float(v) for k, v in metrics.items()})
    side["final"] = {k: v.numpy().copy() for k, v in model.module.state_dict().items()}
    return side


def test_loss_dict_matches_jax(jax_run, torch_run):
    assert set(torch_run["losses"]) == set(jax_run["losses"]) == {"loss_kpt", "acc_pose"}
    for k, want in jax_run["losses"].items():
        assert torch_run["losses"][k] == pytest.approx(want, rel=1e-4), k
    assert torch_run["total"] == pytest.approx(jax_run["total"], rel=1e-4)


def test_every_gradient_matches_jax(jax_run, torch_run):
    assert set(torch_run["grads"]) == set(jax_run["grads"])
    for name, got in torch_run["grads"].items():
        want = jax_run["grads"][name]
        assert got.shape == want.shape, name
        assert np.abs(want).max() > 0, name
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max(), name


def test_three_adamw_steps_match_jax(setup, jax_run, torch_run):
    variables, _ = setup
    for got, want in zip(torch_run["step_losses"], jax_run["step_losses"]):
        assert set(got) == set(want)
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=2e-5, abs=1e-6), k
    start = {k: v.numpy() for k, v in state_dict_from_jax(variables).items()}
    for name, want in jax_run["final"].items():
        change = want - start[name]
        assert np.abs(change).max() > 0, name
        assert np.linalg.norm(torch_run["final"][name] - want) <= 2e-3 * np.linalg.norm(change), name


def test_recipe_optimizer_groups_match_jax(setup):
    """The recipe's optimizer: each parameter's lr scale (layer decay 0.75)
    and weight-decay switch equal the JAX package's. Neither package reads
    the recipe's ``custom_keys`` (whose bias entry is spelled
    ``decay_multi``): biases, norms (one-dimensional) and ``pos_embed`` go
    without decay by the JAX mask's own rule."""
    variables, _ = setup
    model = _port_model(variables)
    wrapper = _optim_wrapper()
    assert wrapper["paramwise_cfg"]["custom_keys"]["bias"] == dict(decay_multi=0.0)
    optimizer, lr_fn = build_optimizer(model, wrapper, RECIPE["param_scheduler"], 2341, 210)
    _, jax_lr_fn = jax_build_optimizer(variables["params"], wrapper, RECIPE["param_scheduler"], 2341, 210)
    names = list(model.module.state_dict())
    marked = {k: torch.full(v.shape, float(i)) for i, (k, v) in enumerate(model.module.state_dict().items())}
    tree = convert_torch_state_dict(marked, num_layers=2)["params"]
    leaves = [names[int(np.asarray(leaf).flat[0])] for leaf in jax.tree_util.tree_leaves(tree)]
    scale_of = dict(zip(leaves, jax.tree_util.tree_leaves(make_lr_scale_tree(tree, num_layers=12, decay_rate=0.75))))
    decays_of = dict(zip(leaves, jax.tree_util.tree_leaves(make_wd_mask_tree(tree))))
    assert set(scale_of) == set(optimizer.names)
    assert scale_of["head.final_layer.weight"] == 1.0
    assert scale_of["backbone.pos_embed"] == pytest.approx(0.75 ** 13)
    assert not decays_of["backbone.layers.0.ln1.weight"] and decays_of["head.final_layer.weight"]
    for group in optimizer.groups:
        for i in group["index"]:
            name = optimizer.names[i]
            assert group["lr_scale"] == pytest.approx(scale_of[name], rel=1e-12), name
            assert group["weight_decay"] == (0.1 if decays_of[name] else 0.0), name
    for k in (0, 1, 250, 499, 500, 2341 * 170, 2341 * 200):
        assert lr_fn(k) == pytest.approx(float(jax_lr_fn(k)), rel=1e-6), k


def test_drop_path_training_descends(setup):
    """The recipe's drop_path 0.3 in training: five steps on one batch lower
    the loss, with a gradient every step."""
    variables, batch = setup
    model = _port_model(variables, drop_path_rate=0.3)
    optimizer, _ = build_optimizer(model, _optim_wrapper(), None)
    state = create_train_state(model, optimizer)
    step = make_train_step(model, optimizer)
    gen = torch.Generator().manual_seed(0)
    tbatch = _torch_batch(batch)
    losses = []
    for _ in range(5):
        state, metrics = step(state, tbatch, gen)
        losses.append(float(metrics["loss"]))
        assert float(metrics["grad_norm"]) > 0
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses
