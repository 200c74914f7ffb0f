"""The coordinate-regression recipes on the CPU (``configs/face_2d_keypoint/
topdown_regression/wflw/``: ResNet-50, ``GlobalAveragePooling``,
``RegressionHead`` with 98 joints, the ``RegressionLabel`` codec and the
SmoothL1, Wing and SoftWing losses) against the JAX package on the same
weights and inputs.

The JAX package cannot build the shipped configs: its ``RegressionHead``
pools by itself (``models/heads/regression_heads.py:38``) after the
configs' ``GlobalAveragePooling`` neck has pooled to (B, C), and its
``init`` raises ``IndexError`` (its own test below). The port's head is the
``fc`` layer alone, as mmpose's, so the port's model equals the JAX model
built without the neck, which pools once: every comparison here holds the
port's config (with the neck) against that one. One torch state dict under
mmpose's names feeds both; the JAX side takes ``head.fc`` by hand
(``convert_torch_state_dict`` converts the backbone).

Bars, with their reasons:
- the codec: labels and weights exactly (float64 division rounded once on
  both sides); the decode (flip average, shifted mirror, times the input
  size) at 1e-5 px (f32);
- the losses and their gradients: rel 1e-6 (the same f32 formulas);
- the narrow model (ResNet-18, 4-32 channels): its predict program's
  keypoints at 1e-3 px (the JAX package's bar for a decode: a regression
  head has no argmax, only f32 noise), the first step's loss dict at rel
  2e-5 under each loss, and three Adam steps as ``tests/
  test_torch_classic_heatmap.py`` holds them (each parameter within 2e-3
  of its change, BatchNorm statistics rel 1e-4);
- ``tools.test`` on the WingLoss config (narrowed) over the synthetic WFLW
  set: ``nme/NME`` printed and finite.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import face_hand_sets_from_coco, golden_jpeg_set
from probpose_code_torch.config import Config
from probpose_code_torch.datasets.metainfo import parse_pose_metainfo
from probpose_code_torch.datasets.transforms.common import GenerateTarget
from probpose_code_torch.engine.optim import build_optimizer
from probpose_code_torch.models.builder import PoseModel
from probpose_code_torch.models.necks.necks import GlobalAveragePooling
from probpose_code_torch.models.pose_estimators.topdown import regression_head_predict
from probpose_code_torch.parallel import create_train_state, make_train_step
from probpose_code_torch.registry import MODELS
from probpose_code_torch.tools import test as test_cli
from probpose_code_tpu.datasets.metainfo import parse_pose_metainfo as jax_parse_pose_metainfo
from probpose_code_tpu.datasets.transforms.common import GenerateTarget as JaxGenerateTarget
from probpose_code_tpu.engine.checkpoint import convert_torch_state_dict
from probpose_code_tpu.engine.optim import build_optimizer as jax_build_optimizer
from probpose_code_tpu.models import PoseModel as JaxPoseModel
from probpose_code_tpu.models.pose_estimators.topdown import regression_head_predict as jax_regression_head_predict
from probpose_code_tpu.parallel import create_train_state as jax_create_train_state
from probpose_code_tpu.parallel import make_train_step as jax_make_train_step
from probpose_code_tpu.registry import MODELS as JAX_MODELS
from tests.test_torch_classic_heatmap import _crops, _smooth_crops, seeded_state_dict
from tests.test_torch_rtmpose_train import _plain

WFLW_REG = "configs/face_2d_keypoint/topdown_regression/wflw/td-reg_res50_{}8xb64-210e_wflw-256x256.py"
LOSSES = {"SmoothL1Loss": "", "WingLoss": "wingloss_", "SoftWingLoss": "softwingloss_"}
CODEC = dict(type="RegressionLabel", input_size=(256, 256))
META = dict(dataset_name="wflw")
NARROW_BACKBONE = dict(type="ResNet", depth=18, stem_channels=16, base_channels=4, out_indices=(3,))
STEPS_PER_EPOCH, MAX_EPOCHS, STEPS = 2, 10, 3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tier-1 runs six test workers at once; one torch thread each."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def recipe(loss):
    return Config.fromfile(WFLW_REG.format(LOSSES[loss]))


def narrow(loss):
    """The recipe's model on ResNet-18 with 4-32 channels (its neck and
    head as shipped)."""
    cfg = _plain(dict(recipe(loss)["model"]))
    cfg["backbone"] = dict(NARROW_BACKBONE)
    cfg["head"]["in_channels"] = 32
    return cfg


def jax_model(cfg):
    """The JAX model of ``cfg`` without its neck: the only form the JAX
    package builds (its head pools)."""
    return JaxPoseModel({k: v for k, v in cfg.items() if k != "neck"}, metainfo=jax_parse_pose_metainfo(META))


def jax_variables(sd):
    variables = convert_torch_state_dict({k: v.numpy().copy() for k, v in sd.items() if not k.startswith("head.")})
    variables["params"]["head"] = {"fc": {"kernel": sd["head.fc.weight"].numpy().T.copy(),
                                          "bias": sd["head.fc.bias"].numpy().copy()}}
    return variables


def both_models(loss, seed):
    cfg = narrow(loss)
    sd = seeded_state_dict(cfg, seed)
    ours = PoseModel(cfg, metainfo=parse_pose_metainfo(META), device="cpu")
    ours.module.load_state_dict(sd, strict=True)
    return ours, jax_model(cfg), jax_variables(sd)


# -- the JAX package's fault ----------------------------------------------------


def test_jax_regression_config_with_its_neck_does_not_build():
    """The JAX ``RegressionHead`` pools the (B, C) output of the configs'
    ``GlobalAveragePooling`` neck again: ``init`` raises ``IndexError``.
    Without the neck it builds, ``head.fc`` (C, 196), and returns (B, 98, 2);
    the port builds the config as it is, ``head.fc`` a (196, C) linear layer."""
    cfg = narrow("WingLoss")
    with pytest.raises(IndexError):
        JaxPoseModel(cfg, metainfo=jax_parse_pose_metainfo(META)).init((1, 64, 64, 3))
    jm = jax_model(cfg)
    jm.init((1, 64, 64, 3))
    assert jm.variables["params"]["head"]["fc"]["kernel"].shape == (32, 196)
    ours = PoseModel(cfg, metainfo=parse_pose_metainfo(META), device="cpu")
    assert isinstance(ours.module.neck, GlobalAveragePooling) and ours.module.head.fc.weight.shape == (196, 32)
    assert ours.module(torch.zeros(1, 64, 64, 3)).shape == (1, 98, 2)


# -- the codec, the neck, the decode and the losses --------------------------------


def test_regression_label_encode_equals_jax():
    """The port's ``GenerateTarget`` ships the input-space keypoints and the
    codec's weights; ``device_preprocess_batch`` makes the labels."""
    rng = np.random.RandomState(3)
    ours, theirs = GenerateTarget(encoder=dict(CODEC)), JaxGenerateTarget(encoder=dict(CODEC))
    model = PoseModel(narrow("WingLoss"), metainfo=parse_pose_metainfo(META), device="cpu")
    for dtype in (np.float32, np.float64):
        kpts = rng.uniform(-10, 266, (1, 98, 2)).astype(dtype)
        kpts[0, :4] = [[0, 0], [255, 255], [255.5, 3], [-0.25, 9]]  # on and off the edges
        vis = (rng.rand(1, 98) > 0.2).astype(np.float32)
        got = ours({"transformed_keypoints": kpts.copy(), "keypoints_visible": vis.copy()})
        want = theirs({"transformed_keypoints": kpts.copy(), "keypoints_visible": vis.copy()})
        np.testing.assert_array_equal(got["keypoint_weights"], want["keypoint_weights"])
        batch = model.device_preprocess_batch(dict(kpts_hm=torch.from_numpy(got["device_kpts_hm"]),
                                                   kpts_visible=torch.from_numpy(got["device_kpts_visible"])))
        assert batch["keypoint_labels"].dtype == torch.float32
        np.testing.assert_array_equal(batch["keypoint_labels"].numpy(), want["keypoint_labels"])


def test_gap_and_decode_equal_jax():
    rng = np.random.RandomState(4)
    feats = rng.randn(3, 8, 5, 7).astype(np.float32)
    want = np.asarray(JAX_MODELS.build(dict(type="GAP")).apply({}, jnp.asarray(feats.transpose(0, 2, 3, 1))))
    got = MODELS.build(dict(type="GlobalAveragePooling"))((torch.from_numpy(feats),))[0]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    coords, flipped = rng.rand(3, 98, 2).astype(np.float32), rng.rand(3, 98, 2).astype(np.float32)
    flip = parse_pose_metainfo(META)["flip_indices"]
    want = jax_regression_head_predict(jnp.asarray(coords), jnp.asarray(flipped), flip, (256, 256), "RegressionHead")
    got = regression_head_predict(torch.from_numpy(coords), torch.from_numpy(flipped), flip, (256, 256))
    for key in ("keypoints", "keypoint_scores"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=0, atol=1e-5, err_msg=key)


@pytest.mark.parametrize("loss", list(LOSSES))
def test_losses_and_gradients_equal_jax(loss):
    rng = np.random.RandomState(5)
    pred, target = rng.uniform(-0.2, 1.2, (4, 98, 2)).astype(np.float32), rng.rand(4, 98, 2).astype(np.float32)
    pred[0, :3] = target[0, :3] + 1e-3  # small errors (at exactly 0 |x|'s subgradient is torch's 0, JAX's 1)
    pred[1, :3] = target[1, :3] + 30  # errors past the wings' bends
    weights = (rng.rand(4, 98) > 0.3).astype(np.float32)
    cfg = dict(type=loss, use_target_weight=True)
    theirs = JAX_MODELS.build(dict(cfg))
    want, want_grad = jax.value_and_grad(lambda p: theirs(p, jnp.asarray(target), jnp.asarray(weights)))(
        jnp.asarray(pred))
    p = torch.from_numpy(pred).requires_grad_()
    got = MODELS.build(dict(cfg))(p, torch.from_numpy(target), torch.from_numpy(weights))
    got.backward()
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-6)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_grad), rtol=1e-6, atol=1e-9)


# -- the narrow model ------------------------------------------------------------


def _train_batches(seed, B=2):
    """``B`` crops of smooth patterns with input-space keypoints (some
    outside, some unannotated): the JAX batch with the host codec's labels,
    the port's with what its GenerateTarget ships."""
    rng = np.random.RandomState(seed)
    ours, theirs = GenerateTarget(encoder=dict(CODEC)), JaxGenerateTarget(encoder=dict(CODEC))
    port, jaxb = [], []
    for _ in range(B):
        kpts = rng.uniform(-20, 276, (1, 98, 2)).astype(np.float32)
        vis = (rng.rand(1, 98) > 0.2).astype(np.float32)
        port.append(ours({"transformed_keypoints": kpts.copy(), "keypoints_visible": vis.copy()}))
        jaxb.append(theirs({"transformed_keypoints": kpts.copy(), "keypoints_visible": vis.copy()}))
    inputs = _smooth_crops(B, seed + 1, size=(256, 256))
    jax_batch = dict(inputs=inputs, keypoint_labels=np.stack([r["keypoint_labels"][0] for r in jaxb]),
                     keypoint_weights=np.stack([r["keypoint_weights"][0] for r in jaxb]))
    port_batch = dict(inputs=torch.from_numpy(inputs),
                      kpts_hm=torch.from_numpy(np.stack([r["device_kpts_hm"][0] for r in port])),
                      kpts_visible=torch.from_numpy(np.stack([r["device_kpts_visible"][0] for r in port])),
                      keypoint_weights=torch.from_numpy(np.stack([r["keypoint_weights"][0] for r in port])))
    return jax_batch, port_batch


@pytest.mark.parametrize("loss", list(LOSSES))
def test_narrow_model_predict_and_loss_match_jax(loss):
    ours, jm, variables = both_models(loss, seed=31)
    crops = _crops(2, seed=32, size=(256, 256))
    want = {k: np.asarray(v) for k, v in jm.make_predict(jit=False)(variables, crops).items()}
    got = ours.predict(torch.from_numpy(crops))
    assert got["keypoints"].shape == (2, 98, 2)
    np.testing.assert_allclose(got["keypoints"].numpy(), want["keypoints"], rtol=0, atol=1e-3)
    np.testing.assert_array_equal(got["keypoint_scores"].numpy(), want["keypoint_scores"])

    cfg = recipe(loss)
    wrapper, schedule = _plain(dict(cfg["optim_wrapper"])), _plain(list(cfg["param_scheduler"]))
    jax_batch, port_batch = _train_batches(seed=33)
    tx, _ = jax_build_optimizer(variables["params"], wrapper, schedule, STEPS_PER_EPOCH, MAX_EPOCHS)
    _, metrics = jax_make_train_step(jm, tx, mesh=None, donate=False)(
        jax_create_train_state(variables, tx), jax_batch, jax.random.PRNGKey(0))
    optimizer, _ = build_optimizer(ours, wrapper, schedule, STEPS_PER_EPOCH, MAX_EPOCHS)
    _, mine = make_train_step(ours, optimizer)(create_train_state(ours, optimizer), port_batch,
                                               torch.Generator().manual_seed(0))
    for name in ("loss_kpt", "acc_pose", "loss"):
        assert float(mine[name]) == pytest.approx(float(metrics[name]), rel=2e-5, abs=1e-6), name


def test_loss_and_three_adam_steps_match_jax():
    """The WingLoss recipe's optimizer (Adam, 5e-4, its linear warm-up) over
    three steps on the narrow model and one batch of two crops."""
    ours, jm, variables = both_models("WingLoss", seed=41)
    cfg = recipe("WingLoss")
    wrapper, schedule = _plain(dict(cfg["optim_wrapper"])), _plain(list(cfg["param_scheduler"]))
    jax_batch, port_batch = _train_batches(seed=42)
    tx, _ = jax_build_optimizer(variables["params"], wrapper, schedule, STEPS_PER_EPOCH, MAX_EPOCHS)
    state = jax_create_train_state(variables, tx)
    step = jax_make_train_step(jm, tx, mesh=None, donate=False)
    want = []
    for _ in range(STEPS):
        state, metrics = step(state, jax_batch, jax.random.PRNGKey(0))
        want.append({k: float(v) for k, v in metrics.items()})
    start = {k: v.clone() for k, v in ours.module.state_dict().items()}
    optimizer, _ = build_optimizer(ours, wrapper, schedule, STEPS_PER_EPOCH, MAX_EPOCHS)
    tstate, tstep = create_train_state(ours, optimizer), make_train_step(ours, optimizer)
    for k in range(STEPS):
        tstate, metrics = tstep(tstate, port_batch, torch.Generator().manual_seed(0))
        for name in ("loss_kpt", "acc_pose", "loss"):
            assert float(metrics[name]) == pytest.approx(want[k][name], rel=2e-5, abs=1e-6), (k, name)

    final, begin = jax_variables(ours.module.state_dict()), jax_variables(start)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(jax.tree_util.tree_map(np.asarray, state.params)))
    flat_begin = dict(jax.tree_util.tree_leaves_with_path(begin["params"]))
    flat_got = jax.tree_util.tree_leaves_with_path(final["params"])
    assert len(flat_got) == len(flat_want)
    for path, g in flat_got:
        w, s = flat_want[path], flat_begin[path]
        change = np.linalg.norm(w - s)
        assert change > 0, path
        assert np.linalg.norm(g - w) <= 2e-3 * change, path
    got_stats = dict(jax.tree_util.tree_leaves_with_path(final["batch_stats"]))
    for path, w in jax.tree_util.tree_leaves_with_path(jax.tree_util.tree_map(np.asarray, state.batch_stats)):
        np.testing.assert_allclose(got_stats[path], w, rtol=1e-4, atol=1e-6, err_msg=str(path))


# -- the entry point ---------------------------------------------------------------


def test_tools_test_prints_nme_on_the_regression_recipe(tmp_path, capsys):
    """``python -m probpose_code_torch.tools.test`` on the WingLoss config
    (narrowed) over the golden JPEGs' faces in WFLW's layout."""
    _, ann = golden_jpeg_set(tmp_path)
    face_hand_sets_from_coco(ann, tmp_path, ["WFLWDataset"])
    options = [f"model.backbone={NARROW_BACKBONE!r}", "model.head.in_channels=32",
               f"test_dataloader.dataset.data_root={tmp_path}", "test_dataloader.dataset.ann_file=WFLWDataset.json",
               "test_dataloader.dataset.data_prefix.img=imgs/", "test_dataloader.num_workers=0"]
    test_cli.main([WFLW_REG.format(LOSSES["WingLoss"]), "--device", "cpu", "--cfg-options", *options])
    lines = dict(line.split(": ", 1) for line in capsys.readouterr().out.splitlines() if line.startswith("nme/"))
    assert set(lines) == {"nme/NME"} and np.isfinite(float(lines["nme/NME"]))
