"""The integral regression heads (IntegralRegressionHead / DSNTHead), their
codec and losses, and VisPredictHead, on the CPU against the JAX package on
the same weights and inputs.

The models are the shipped configs' (``configs/body_2d_keypoint/
integral_regression/coco/``, ``td-hm-vis_res50_8xb64-210e_coco-aic-256x192-
merge.py``) on a ResNet-18 of 4-32 channels with deconvolutions of 8
channels (``tests/test_torch_rle.py:narrow_cfg``), their JAX variables drawn
by NumPy from a seed and carried to the port by ``state_dict_from_jax``.

The JAX package cannot train the integral configs: their
``MultipleLossWrapper`` takes lists, and ``regression_head_loss`` hands it the
coordinate array (its test below). The port serves them and refuses their
training by name (``models/builder.py:UNTRAINED_HEADS``); their predict is
held here, and their loss modules as functions.

Bars, with their reasons:
- the soft-argmax and the predicts (flip-TTA): keypoints 1e-3 px (f32
  noise, the JAX package's bar for a decode), scores and visibilities 1e-5;
- the integral codec: labels and weights exactly, the sum-normalized maps
  within 1e-6 of their largest (f32 sums in another order);
- JSDiscretLoss and the wrapper: rel 1e-5 (the same f32 formulas, summed
  over some 10^4 cells in another order), their gradients 1e-5 of the
  largest;
- VisPredictHead's step: the loss dict rel 2e-5, the gradients of
  ``vis_head`` and the wrapped head's ``final_layer`` within 1e-4 of each
  parameter's largest (f32 through a BatchNorm in training mode);
- the fixtures (``chip_smoke.DSNT_FIXTURE``, ``VIS_FIXTURE``) through
  ``init_model`` and ``inference_topdown``: ``model_fixture_report``'s bars.
"""

import glob

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import DSNT_FIXTURE, VIS_FIXTURE, model_fixture_report
from probpose_code_torch.apis import init_model
from probpose_code_torch.config import Config
from probpose_code_torch.datasets.loader import collate_pose_samples
from probpose_code_torch.datasets.transforms.common import GenerateTarget
from probpose_code_torch.engine.checkpoint import state_dict_from_jax
from probpose_code_torch.models.builder import UNTRAINED_HEADS
from probpose_code_torch.registry import MODELS, TRANSFORMS
from probpose_code_torch.structures import InstanceData, PoseDataSample
from probpose_code_torch.tools import train as train_cli
from probpose_code_tpu.datasets.loader import collate_pose_samples as jax_collate_pose_samples
from probpose_code_tpu.datasets.transforms.common import GenerateTarget as JaxGenerateTarget
from probpose_code_tpu.registry import MODELS as JAX_MODELS
from probpose_code_tpu.structures import InstanceData as JaxInstanceData
from probpose_code_tpu.structures import PoseDataSample as JaxPoseDataSample
from tests.test_torch_classic_heatmap import _smooth_crops
from tests.test_torch_rle import _np, close, models

IPR = "configs/body_2d_keypoint/integral_regression/coco/ipr_res50_{}-210e_coco-{}.py"
INTEGRAL = {"ipr_192x256": IPR.format("8xb64", "192x256"), "debias_256x256": IPR.format("debias-8xb64", "256x256"),
            "dsnt_192x256": IPR.format("dsnt-8xb64", "192x256")}
VIS = "configs/body_2d_keypoint/topdown_heatmap/coco/td-hm-vis_res50_8xb64-210e_coco-aic-256x192-merge.py"
CONFIGS = sorted(glob.glob("configs/body_2d_keypoint/integral_regression/coco/*.py")) + [VIS]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tier-1 runs six test workers at once; one torch thread each."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _crops(n, seed, w, h):
    return np.round(np.random.RandomState(seed).rand(n, h, w, 3) * 255).astype(np.float32)


# -- the integral heads ----------------------------------------------------------------------------------------


def test_soft_argmax_at_beta_10_on_peaked_maps():
    """The debias configs' beta = 10 on maps with one peak of 60 (exp(600)
    overflows f32): both heads, their ``final_layer`` the identity so that the
    maps are the input, give the same finite expectation, within a fortieth
    of a cell of the peak, normalized by W and H."""
    B, K, H, W = 2, 3, 8, 6
    rng = np.random.RandomState(1)
    maps = rng.uniform(-1, 1, (B, K, H, W)).astype(np.float32)
    peaks = [(rng.randint(W), rng.randint(H)) for _ in range(B * K)]
    for (x, y), m in zip(peaks, maps.reshape(B * K, H, W)):
        m[y, x] = 60.0
    assert not np.isfinite(np.exp(np.float32(10 * 60.0)))
    cfg = dict(in_channels=K, in_featuremap_size=(W, H), num_joints=K, beta=10.0, deconv_out_channels=None)
    jax_head = JAX_MODELS.build(dict(cfg, type="DSNTHead"))
    eye = np.eye(K, dtype=np.float32)
    variables = {"params": {"final_layer": {"kernel": eye[None, None], "bias": np.zeros(K, np.float32)}}}
    want, _ = jax_head.apply(variables, jnp.asarray(maps.transpose(0, 2, 3, 1)))
    head = MODELS.build(dict(cfg, type="DSNTHead"))
    head.load_state_dict({"final_layer.weight": torch.from_numpy(eye[:, :, None, None]),
                          "final_layer.bias": torch.zeros(K)})
    got, heatmaps = head(torch.from_numpy(maps))
    np.testing.assert_array_equal(heatmaps.detach().numpy(), maps)
    got = got.detach().numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-3 / max(W, H))
    cells = np.array(peaks, np.float32).reshape(B, K, 2) / np.array([W, H], np.float32)
    np.testing.assert_allclose(got, cells, rtol=0, atol=1 / 40 / max(W, H))


@pytest.mark.parametrize("name", list(INTEGRAL))
def test_integral_predict_matches_jax(name):
    """The IPR (beta 1), debias (beta 10) and DSNT recipes' predict on two
    crops: flip-TTA over the soft-argmax coordinates, shifted, times the
    input size; every score 1."""
    ours, jm, variables = models(INTEGRAL[name], 41)
    w, h = jm.input_size
    crops = _crops(2, 42, w, h)
    want = {k: np.asarray(v) for k, v in jm.make_predict(jit=False)(variables, crops).items()}
    got = ours.predict(torch.from_numpy(crops))
    np.testing.assert_allclose(got["keypoints"].numpy(), want["keypoints"], rtol=0, atol=1e-3)
    np.testing.assert_array_equal(got["keypoint_scores"].numpy(), want["keypoint_scores"])


def test_integral_label_encode_matches_jax():
    """The integral codec (256 x 256 input, 64 x 64 maps): the port's
    ``GenerateTarget`` ships the input-space keypoints and the weights,
    ``device_preprocess_batch`` makes the labels and the sum-normalized MSRA
    maps; the JAX host codec makes all three."""
    ours, _, _ = models(INTEGRAL["debias_256x256"], 41)
    codec = dict(ours.decoder_cfg)
    rng = np.random.RandomState(5)
    port, want = [], []
    for _ in range(3):
        kpts = rng.uniform(-10, 266, (1, 17, 2)).astype(np.float32)
        kpts[0, :2] = [[0, 0], [255, 3]]
        vis = (rng.rand(1, 17) > 0.2).astype(np.float32)
        port.append(GenerateTarget(encoder=dict(codec))({"transformed_keypoints": kpts.copy(),
                                                         "keypoints_visible": vis.copy()}))
        want.append(JaxGenerateTarget(encoder=dict(codec))({"transformed_keypoints": kpts.copy(),
                                                            "keypoints_visible": vis.copy()}))
    batch = ours.device_preprocess_batch(dict(
        kpts_hm=torch.from_numpy(np.stack([r["device_kpts_hm"][0] for r in port])),
        kpts_visible=torch.from_numpy(np.stack([r["device_kpts_visible"][0] for r in port]))))
    np.testing.assert_array_equal(np.stack([r["keypoint_weights"][0] for r in port]),
                                  np.stack([r["keypoint_weights"][0] for r in want]))
    np.testing.assert_array_equal(batch["keypoint_labels"].numpy(), np.stack([r["keypoint_labels"][0] for r in want]))
    close(batch["heatmaps"], np.stack([r["heatmaps"] for r in want]), 1e-6, "heatmaps")


def test_js_discret_loss_and_wrapper_match_jax():
    """JSDiscretLoss (with and without target weights) and its gradient, and
    the integral configs' MultipleLossWrapper on lists, as functions."""
    rng = np.random.RandomState(7)
    pred = rng.rand(3, 17, 16, 12).astype(np.float32)
    pred /= pred.sum(axis=(-1, -2), keepdims=True)
    gt = rng.rand(3, 17, 16, 12).astype(np.float32) ** 4
    gt /= gt.sum(axis=(-1, -2), keepdims=True)
    weights = (rng.rand(3, 17) > 0.3).astype(np.float32)
    for use in (True, False):
        cfg = dict(type="JSDiscretLoss", use_target_weight=use)
        want, want_grad = jax.value_and_grad(lambda p: JAX_MODELS.build(dict(cfg))(p, jnp.asarray(gt),
                                                                                   jnp.asarray(weights)))(
            jnp.asarray(pred))
        p = torch.from_numpy(pred).requires_grad_()
        got = MODELS.build(dict(cfg))(p, torch.from_numpy(gt), torch.from_numpy(weights))
        got.backward()
        assert float(got.detach()) == pytest.approx(float(want), rel=1e-5)
        close(p.grad, want_grad, 1e-5, "d/dpred")
    coords, labels = rng.rand(3, 17, 2).astype(np.float32), rng.rand(3, 17, 2).astype(np.float32)
    wrapper = dict(type="MultipleLossWrapper", losses=[dict(type="SmoothL1Loss", use_target_weight=True),
                                                       dict(type="JSDiscretLoss", use_target_weight=True)])
    want = JAX_MODELS.build(dict(wrapper))([jnp.asarray(coords), jnp.asarray(pred)],
                                           [jnp.asarray(labels), jnp.asarray(gt)], jnp.asarray(weights))
    got = MODELS.build(dict(wrapper))([torch.from_numpy(coords), torch.from_numpy(pred)],
                                      [torch.from_numpy(labels), torch.from_numpy(gt)], torch.from_numpy(weights))
    assert [float(g) for g in got] == pytest.approx([float(w) for w in want], rel=1e-5)


def test_integral_training_fails_in_jax_and_is_refused_by_name(tmp_path):
    """The JAX ``loss_fn`` of an integral config fails the wrapper's
    assertion (it gets the coordinate array, not a list); the port's
    ``loss_fn`` and ``tools.train`` refuse the config with the reason."""
    ours, jm, variables = models(INTEGRAL["dsnt_192x256"], 41)
    rng = np.random.RandomState(9)
    batch = dict(inputs=_smooth_crops(2, 9, size=(256, 192)), keypoint_labels=rng.rand(2, 17, 2).astype(np.float32),
                 keypoint_weights=np.ones((2, 17), np.float32),
                 heatmaps=rng.rand(2, 17, 64, 48).astype(np.float32))
    with pytest.raises(AssertionError):
        jm.loss_fn(variables, {k: jnp.asarray(v) for k, v in batch.items()}, rngs={"dropout": jax.random.PRNGKey(0)})
    reason = UNTRAINED_HEADS["DSNTHead"]
    assert UNTRAINED_HEADS["IntegralRegressionHead"] == reason and "MultipleLossWrapper" in reason
    with pytest.raises(NotImplementedError, match="integral regression training"):
        ours.loss_fn({k: torch.from_numpy(v) for k, v in batch.items()})
    with pytest.raises(NotImplementedError, match="integral regression training"):
        train_cli.main([INTEGRAL["debias_256x256"], "--device", "cpu", "--work-dir", str(tmp_path)])


def test_dsnt_fixture_through_inference_topdown():
    """``chip_smoke.model_fixture_report`` on the DSNT fixture (beta 10), the
    card's ``regression_golden`` check, on the CPU."""
    report = model_fixture_report(DSNT_FIXTURE, device="cpu")
    assert report["ok"], report


# -- VisPredictHead ----------------------------------------------------------------------------------------------


@pytest.mark.parametrize("visible_weights", [True, False], ids=["visible_weights", "no_visible_weights"])
def test_vis_predict_and_training_step_match_jax(visible_weights):
    """The Vis recipe's predict (the wrapped heatmap head's keypoints and
    scores, the visibility averaged over the flip pair) and one step's
    ``loss_kpt``, ``loss_vis`` and the gradients of ``vis_head`` and the
    wrapped head's ``final_layer``: with ``keypoints_visible_weights`` in the
    batch, and without (ones)."""
    ours, jm, variables = models(VIS, 51)
    crops = _crops(2, 52, 192, 256)
    want = {k: np.asarray(v) for k, v in jm.make_predict(jit=False)(variables, crops).items()}
    got = ours.predict(torch.from_numpy(crops))
    np.testing.assert_allclose(got["keypoints"].numpy(), want["keypoints"], rtol=0, atol=1e-3)
    for key in ("keypoint_scores", "keypoints_visible"):
        np.testing.assert_allclose(got[key].numpy(), want[key], rtol=0, atol=1e-5, err_msg=key)

    rng = np.random.RandomState(53)
    batch = dict(inputs=_smooth_crops(2, 54, size=(256, 192)), heatmaps=rng.rand(2, 17, 64, 48).astype(np.float32),
                 keypoint_weights=(rng.rand(2, 17) > 0.3).astype(np.float32))
    if visible_weights:
        batch["keypoints_visible_weights"] = rng.uniform(0, 1, (2, 17)).astype(np.float32)

    def jax_loss(params):
        total, (losses, _) = jm.loss_fn({"params": params, "batch_stats": variables["batch_stats"]},
                                        {k: jnp.asarray(v) for k, v in batch.items()},
                                        rngs={"dropout": jax.random.PRNGKey(0)})
        return total, losses

    (_, want_losses), grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(variables["params"])
    saved = {k: v.clone() for k, v in ours.module.state_dict().items()}
    total, (losses, _) = ours.loss_fn({k: torch.from_numpy(v) for k, v in batch.items()})
    total.backward()
    ours.module.load_state_dict(saved)  # the step moved the BatchNorm statistics; the cached model keeps the JAX ones
    for name in ("loss_kpt", "loss_vis"):
        assert float(losses[name]) == pytest.approx(float(want_losses[name]), rel=2e-5, abs=1e-7), name
    want_grads = state_dict_from_jax({"params": _np(grads), "batch_stats": _np(variables["batch_stats"])})
    params = dict(ours.module.named_parameters())
    checked = [k for k in want_grads if k.startswith(("head.vis_head.", "head.pose_head.final_layer."))]
    assert len(checked) == 4
    for key in checked:
        close(params[key].grad, want_grads[key], 1e-4, key)
    for p in ours.module.parameters():
        p.grad = None


def _samples(structures, converted):
    """Two top-down samples as the pipeline leaves them: the first from a
    set without a KeypointConverter (COCO: no ``keypoints_visible_weights``),
    the second through AIC's (weights 1 on its mapped slots)."""
    data, inst = structures
    out = []
    for i, has in enumerate((False, converted)):
        labels = dict(keypoint_weights=np.ones((1, 17), np.float32))
        if has:
            labels["keypoints_visible_weights"] = np.tile((np.arange(17) < 12).astype(np.float32), (1, 1))
        sample = data(metainfo=dict(id=i))
        sample.gt_instance_labels = inst(**labels)
        sample.gt_instances = inst(keypoints_visible=np.ones((1, 17), np.float32))
        out.append(dict(data_samples=sample, canvas=np.zeros((4, 4, 3), np.uint8), warp_mat=np.eye(2, 3),
                        device_kpts_hm=np.zeros((1, 17, 2), np.float32),
                        device_kpts_visible=np.ones((1, 17), np.float32)))
    return out


def test_mixed_batch_visible_weights():
    """The Vis recipe trains on ``CombinedDataset`` (COCO + AIC): a batch
    mixes samples with and without ``keypoints_visible_weights``. The port's
    collate gives the unconverted samples ones (the loss's weight for a
    batch without any); the JAX collate stacks the first sample's keys and
    raises ``AttributeError`` when the first has them and a later one has
    none."""
    batch = collate_pose_samples(_samples((PoseDataSample, InstanceData), True)[::-1])
    np.testing.assert_array_equal(batch["keypoints_visible_weights"][0], (np.arange(17) < 12).astype(np.float32))
    np.testing.assert_array_equal(batch["keypoints_visible_weights"][1], np.ones(17, np.float32))
    assert "keypoints_visible_weights" not in collate_pose_samples(_samples((PoseDataSample, InstanceData), False))
    with pytest.raises(AttributeError):
        jax_collate_pose_samples(_samples((JaxPoseDataSample, JaxInstanceData), True)[::-1])


def test_vis_fixture_through_inference_topdown():
    """``chip_smoke.model_fixture_report`` on the Vis fixture: keypoints,
    scores and the visibility through ``init_model`` and
    ``inference_topdown``, on the CPU."""
    report = model_fixture_report(VIS_FIXTURE, device="cpu")
    assert report["ok"], report


@pytest.mark.parametrize("config", CONFIGS, ids=lambda c: c.split("/")[-1].removesuffix(".py"))
def test_integral_and_vis_config_builds(config):
    """Each shipped integral and Vis config builds through ``init_model`` at
    full width, and its training pipeline's ``GenerateTarget`` through the
    registry; the integral configs' loss wrapper builds too."""
    cfg = Config.fromfile(config)
    model = init_model(cfg, device="cpu")
    head = cfg["model"]["head"]
    assert type(model.module.head).__name__ == head["type"]
    codec = head["pose_cfg"]["decoder"] if head["type"] == "VisPredictHead" else head["decoder"]
    assert model.decoder_cfg["type"] == codec["type"]
    if head["type"] == "DSNTHead":
        assert type(model.loss_modules["keypoint"]).__name__ == "MultipleLossWrapper"
        assert model.module.head.beta == head.get("beta", 1.0)
    else:
        assert model.module.head.vis_head[2].out_features == 17
    targets = [t for t in cfg["train_pipeline"] if t["type"] == "GenerateTarget"]
    assert len(targets) == 1 and TRANSFORMS.build(dict(targets[0])).type == codec["type"]
