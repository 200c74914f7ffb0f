"""The port's HRNet, plain Adam and the HRNet + UDP fixture against the JAX package.

- Features: a two-module, two-block HRNet (widths 8-64) built by both
  packages; the JAX variables (BatchNorm statistics randomized) move to the
  port through ``state_dict_from_jax``; every output branch
  (``multiscale_output``) and the HeatmapHead's maps on the same numpy
  crops, f32: relative max error < 1e-5 (both compute in f32 and differ in
  summation order; measured about 1e-6).
- Training: a tiny HRNet (``TINY_HRNET_EXTRA``, one block a branch) +
  HeatmapHead (UDP targets) through each
  package's train step with the HRNet recipe's optimizer (plain ``Adam``,
  its ``LinearLR`` warmup and ``MultiStepLR``, here over a few steps):
  three steps' losses at rtol 2e-5, and every parameter's change within 2e-3
  of itself in l2 norm (``tests/test_torch_train.py``'s bars and reasons);
  the BatchNorm statistics after them at rtol 1e-4.
- Names: mmpose's HRNet state dict (``tests/golden/e2e_udp_weights.pth``)
  loads with ``strict=True``, and ``state_dict_from_jax`` gives the same
  keys.
- The UDP fixture (``tests/test_apis/test_e2e_parity_udp.py:105-124``'s
  bars): ``init_model`` with the fixture's weights, ``inference_topdown`` on
  its images and ``CocoMetric``: keypoints p99 < 1 px against the reference,
  at most one beyond 5 px, scores within 2e-3, AP within 0.01.
- The shipped ``td-hm_hrnet-w32_udp`` config builds on the CPU only when
  asked, and its model predicts at full width.
"""

import copy
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from chip_smoke import HRNET, UDP_FIXTURE_CFG, udp_fixture_report
from probpose_code_torch.apis import init_model
from probpose_code_torch.engine.checkpoint import state_dict_from_jax
from probpose_code_torch.engine.optim import build_optimizer
from probpose_code_torch.models.builder import PoseModel
from probpose_code_torch.parallel import create_train_state, make_train_step
from probpose_code_tpu.codecs import UDPHeatmap
from probpose_code_tpu.engine.optim import build_optimizer as jax_build_optimizer
from probpose_code_tpu.models import PoseModel as JaxPoseModel
from probpose_code_tpu.parallel import create_train_state as jax_create_train_state
from probpose_code_tpu.parallel import make_train_step as jax_make_train_step
from tests.test_engine.test_torch_conversion import TINY_HRNET_EXTRA

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "golden"
UDP_CODEC = dict(type="UDPHeatmap", input_size=(192, 256), heatmap_size=(48, 64), sigma=2)
# two modules in stage 3, two blocks a branch: the module chain and the block chain
DEEPER_EXTRA = dict(
    stage1=dict(num_modules=1, num_branches=1, block="BOTTLENECK", num_blocks=(2,), num_channels=(8,)),
    stage2=dict(num_modules=1, num_branches=2, block="BASIC", num_blocks=(2, 2), num_channels=(8, 16)),
    stage3=dict(num_modules=2, num_branches=3, block="BASIC", num_blocks=(2, 2, 2), num_channels=(8, 16, 32)),
    stage4=dict(num_modules=2, num_branches=4, block="BASIC", num_blocks=(1, 1, 1, 1), num_channels=(8, 16, 32, 64)),
)
OPTIM = dict(optimizer=dict(type="Adam", lr=5e-4))
SCHEDULE = [
    dict(type="LinearLR", begin=0, end=4, start_factor=0.001, by_epoch=False),
    dict(type="MultiStepLR", begin=0, end=10, milestones=[1], gamma=0.1, by_epoch=True),
]
STEPS_PER_EPOCH, MAX_EPOCHS, STEPS = 2, 10, 3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tier-1 runs six test workers at once; one torch thread each."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _cfg(extra=TINY_HRNET_EXTRA, multiscale=False):
    return dict(
        type="TopdownPoseEstimator",
        data_preprocessor=dict(type="PoseDataPreprocessor", mean=[123.675, 116.28, 103.53],
                               std=[58.395, 57.12, 57.375], bgr_to_rgb=True),
        backbone=dict(type="HRNet", in_channels=3, extra=extra, multiscale_output=multiscale),
        # the head reads the last branch: the finest, or with multiscale_output the coarsest
        head=dict(type="HeatmapHead", in_channels=extra["stage4"]["num_channels"][-1] if multiscale else 8,
                  out_channels=17, deconv_out_channels=None,
                  loss=dict(type="KeypointMSELoss", use_target_weight=True), decoder=UDP_CODEC),
        test_cfg=dict(flip_test=True, flip_mode="heatmap", shift_heatmap=False),
    )


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _randomize_stats(variables, seed):
    rng = np.random.RandomState(seed)

    def fill(tree):
        return {k: fill(v) if isinstance(v, dict) else (
            rng.uniform(-0.2, 0.2, v.shape) if k == "mean" else rng.uniform(0.5, 1.5, v.shape)).astype(np.float32)
            for k, v in tree.items()}

    return dict(variables, batch_stats=fill(variables["batch_stats"]))


def _crops(n, seed, size=(256, 192)):
    return np.round(np.random.RandomState(seed).rand(n, *size, 3) * 255).astype(np.float32)


def test_features_and_heatmaps_match_jax():
    """Every branch of a two-module, two-block HRNet (``multiscale_output``:
    the single-branch fuse of the last module is held by the Adam steps
    and the UDP fixture)."""
    extra, multiscale = DEEPER_EXTRA, True
    jm = JaxPoseModel(_cfg(extra, multiscale))
    variables = _randomize_stats(_np(jm.init(seed=1)), seed=2)
    ours = PoseModel(_cfg(extra, multiscale), device="cpu")
    ours.module.load_state_dict(state_dict_from_jax(variables), strict=True)
    ours.eval()
    crops = _crops(2, seed=3, size=(128, 96))  # stage 4's coarsest branch is 4 x 3
    x = jm.preprocess(crops)
    want = jm.module.apply(variables, x, method=lambda m, x: m.backbone(x, train=False))
    with torch.no_grad():
        got = ours.module.backbone(ours.preprocess(torch.from_numpy(crops)).permute(0, 3, 1, 2))
        heatmaps = ours.module(ours.preprocess(torch.from_numpy(crops)))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        w = np.transpose(np.asarray(w), (0, 3, 1, 2))
        assert g.shape == w.shape
        assert np.abs(g.numpy() - w).max() < 1e-5 * np.abs(w).max()
    ref = np.asarray(jm.forward(variables, crops))
    assert np.abs(heatmaps.numpy() - ref).max() < 1e-5 * np.abs(ref).max()


def _train_batch(seed):
    """Two crops with UDP targets of random keypoints (some outside the map
    or unannotated), as the JAX host codec encodes them."""
    rng = np.random.RandomState(seed)
    codec = UDPHeatmap(input_size=(192, 256), heatmap_size=(48, 64), sigma=2)
    maps, weights = [], []
    for _ in range(2):
        kpts = np.stack([rng.uniform(-20, 212, (1, 17)), rng.uniform(-20, 276, (1, 17))], -1).astype(np.float32)
        enc = codec.encode(kpts, (rng.rand(1, 17) > 0.2).astype(np.float32))
        maps.append(enc["heatmaps"])
        weights.append(enc["keypoint_weights"][0])
    return dict(inputs=_crops(2, seed + 1), heatmaps=np.stack(maps).astype(np.float32),
                keypoint_weights=np.stack(weights).astype(np.float32))


def test_three_adam_steps_match_jax():
    variables = _np(JaxPoseModel(_cfg()).init(seed=4))
    batch = _train_batch(5)
    jm = JaxPoseModel(_cfg())
    tx, jax_lr = jax_build_optimizer(variables["params"], OPTIM, SCHEDULE, STEPS_PER_EPOCH, MAX_EPOCHS)
    state = jax_create_train_state(variables, tx)
    step = jax_make_train_step(jm, tx, mesh=None, donate=False)
    want = []
    for _ in range(STEPS):
        state, metrics = step(state, batch, jax.random.PRNGKey(0))
        want.append({k: float(v) for k, v in metrics.items()})
    final = {k: v.numpy() for k, v in state_dict_from_jax(
        {"params": _np(state.params), "batch_stats": _np(state.batch_stats)}).items()}

    model = PoseModel(_cfg(), device="cpu")
    model.module.load_state_dict(state_dict_from_jax(variables), strict=True)
    optimizer, lr_fn = build_optimizer(model, OPTIM, SCHEDULE, STEPS_PER_EPOCH, MAX_EPOCHS)
    assert [lr_fn(k) for k in range(6)] == pytest.approx([float(jax_lr(k)) for k in range(6)], rel=1e-6)
    assert len(optimizer.groups) == 1 and optimizer.groups[0]["weight_decay"] == 0.0
    tstate = create_train_state(model, optimizer)
    tstep = make_train_step(model, optimizer)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    for k in range(STEPS):
        tstate, metrics = tstep(tstate, tbatch, torch.Generator().manual_seed(0))
        got = {name: float(v) for name, v in metrics.items()}
        assert set(got) >= {"loss_kpt", "acc_pose", "loss"}
        for name in ("loss_kpt", "acc_pose", "loss"):
            assert got[name] == pytest.approx(want[k][name], rel=2e-5, abs=1e-6), (k, name)

    start = {k: v.numpy() for k, v in state_dict_from_jax(variables).items()}
    ours = {k: v.numpy() for k, v in model.module.state_dict().items()}
    for name, w in final.items():
        g = ours[name]
        if name.endswith("num_batches_tracked"):
            continue
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6, err_msg=name)
            continue
        change = np.linalg.norm(w - start[name])
        assert change > 0, name
        assert np.linalg.norm(g - w) <= 2e-3 * change, name


def test_adam_weight_decay_applies_to_every_parameter():
    """optax's ``add_decayed_weights`` without a mask (``optim.py:194-197``)."""
    model = PoseModel(_cfg(), device="cpu")
    optimizer, _ = build_optimizer(model, dict(optimizer=dict(type="Adam", lr=1e-3, weight_decay=1e-4)))
    assert len(optimizer.groups) == 1 and optimizer.groups[0]["weight_decay"] == 1e-4
    assert len(optimizer.groups[0]["index"]) == len(list(model.module.parameters()))
    adamw, _ = build_optimizer(model, dict(optimizer=dict(type="AdamW", lr=1e-3, weight_decay=1e-4)))
    assert {g["weight_decay"] for g in adamw.groups} == {0.0, 1e-4}


def test_mmpose_state_dict_loads_strict():
    ours = PoseModel(_cfg(), device="cpu")
    reference = torch.load(GOLDEN / "e2e_udp_weights.pth", map_location="cpu", weights_only=True)
    ours.module.load_state_dict(reference, strict=True)
    moved = state_dict_from_jax(_np(JaxPoseModel(_cfg()).init(seed=0)))
    assert set(moved) == set(reference) == set(ours.module.state_dict())
    for k, v in moved.items():
        assert v.shape == reference[k].shape, k


def test_udp_fixture_through_inference_topdown_and_coco_metric():
    """``chip_smoke.udp_fixture_report``, the card's ``hrnet_golden`` check,
    on the CPU: ``init_model`` with the fixture's mmpose weights (strict),
    ``inference_topdown`` over its images, ``CocoMetric``."""
    model = init_model(UDP_FIXTURE_CFG, checkpoint=str(GOLDEN / "e2e_udp_weights.pth"), device="cpu")
    report = udp_fixture_report(model)
    assert report["instances"] == 17 and report["sane"] > 0.97
    assert report["p99"] < 1.0 and report["over_5px"] <= 1, report
    assert report["scores"] < 2e-3 and report["d_AP"] < 0.01, report
    assert report["ok"]


def test_shipped_w32_config_builds_on_the_cpu_only_when_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_model(str(HRNET))
    model = init_model(str(HRNET), device="cpu")
    n_params = sum(p.numel() for p in model.module.parameters())
    assert 28e6 < n_params < 29e6  # HRNet-w32 + a 1x1 head: 28.5 M
    preds = model.predict(torch.from_numpy(_crops(1, seed=7)))
    assert preds["keypoints"].shape == (1, 17, 2) and torch.isfinite(preds["keypoints"]).all()
    assert preds["heatmaps"].shape == (1, 17, 64, 48)
    # the config's optimizer is plain Adam, with no weight decay
    optimizer, _ = build_optimizer(model, copy.deepcopy(dict(model.cfg_full["optim_wrapper"])),
                                   model.cfg_full["param_scheduler"], 10, 210)
    assert [g["weight_decay"] for g in optimizer.groups] == [0.0]
