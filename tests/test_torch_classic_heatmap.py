"""The classic heatmap recipes on the CPU: the MSRA codec (and its DARK form)
and ResNet, the port against the JAX package on the same weights and inputs.

One torch state dict under mmpose's names (the port's module, its weights
drawn from a seed and its BatchNorm statistics randomized) feeds both
stacks: the JAX side loads it through ``convert_torch_state_dict``.

Bars, with their reasons:
- encodes: maps atol 1e-6 (both compute the codec's arithmetic, float64 for
  the MSRA form and f32 for the unbiased one; the last bit of exp may
  differ), weights exact; against the port's codec copy, the JAX codec and
  ``tests/golden/gaussians.npz``, with keypoints on .5 boundaries (the
  centre's rounding) and outside the map;
- the quarter-pixel and DARK decodes: 1e-5 px against ``decode.npz`` and the
  JAX functions (the same f32 formulas);
- features and heatmaps: relative 1e-5 (f32 on both sides, summation order);
- predict keypoints on peaked maps: 1e-3 px, the JAX package's bar for a
  decode (``tests/test_ops/test_pallas_decode.py:63``);
- the loss dict and three Adam steps (on ResNet-18, see the test):
  ``tests/test_torch_hrnet.py``'s bars (losses rel 2e-5, each parameter
  within 2e-3 of its change in l2 norm, BatchNorm statistics rel 1e-4);
- the golden fixture (``tests/golden_torch/classic_fixture.npz``, made by
  ``make_model_fixtures.py`` with the JAX package): ``chip_smoke.UDP_BARS``,
  as the card's ``classic_golden`` phase holds it.
"""

import copy

import jax
import numpy as np
import pytest
import torch

from chip_smoke import CLASSIC_FIXTURE, CLASSIC_RECIPES, model_fixture_report
from probpose_code_torch.apis import init_model
from probpose_code_torch.codecs.msra_heatmap import MSRAHeatmap
from probpose_code_torch.codecs.utils.gaussian_heatmap import (
    generate_gaussian_heatmaps,
    generate_unbiased_gaussian_heatmaps,
)
from probpose_code_torch.datasets.transforms.common import GenerateTarget
from probpose_code_torch.engine.optim import build_optimizer
from probpose_code_torch.models.builder import PoseModel
from probpose_code_torch.models.pose_estimators.topdown import heatmap_head_predict
from probpose_code_torch.ops import decode as tdecode
from probpose_code_torch.ops.encode import generate_gaussian_device, generate_unbiased_gaussian_device
from probpose_code_torch.parallel import create_train_state, make_train_step
from probpose_code_tpu.codecs import MSRAHeatmap as JaxMSRAHeatmap
from probpose_code_tpu.codecs.utils import gaussian_heatmap as jgauss
from probpose_code_tpu.datasets.transforms.common import GenerateTarget as JaxGenerateTarget
from probpose_code_tpu.engine.checkpoint import convert_torch_state_dict
from probpose_code_tpu.engine.optim import build_optimizer as jax_build_optimizer
from probpose_code_tpu.models import PoseModel as JaxPoseModel
from probpose_code_tpu.ops import decode as jdecode
from probpose_code_tpu.parallel import create_train_state as jax_create_train_state
from probpose_code_tpu.parallel import make_train_step as jax_make_train_step

GOLDEN = "tests/golden"
META = {"flip_indices": [0, 2, 1, 4, 3, 6, 5, 8, 7, 10, 9, 12, 11, 14, 13, 16, 15]}
MSRA = dict(type="MSRAHeatmap", input_size=(192, 256), heatmap_size=(48, 64), sigma=2)
DARK = dict(MSRA, unbiased=True)
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


def _cfg(depth=50, codec=DARK, deconv=(8, 8, 8)):
    """A narrow SimpleBaseline: ResNet (stem 16, base width 4) and a deconv head."""
    return dict(
        type="TopdownPoseEstimator",
        data_preprocessor=dict(type="PoseDataPreprocessor", mean=[123.675, 116.28, 103.53],
                               std=[58.395, 57.12, 57.375], bgr_to_rgb=True),
        backbone=dict(type="ResNet", depth=depth, stem_channels=16, base_channels=4, out_indices=(3,)),
        head=dict(type="HeatmapHead", in_channels=32 if depth < 50 else 128, out_channels=17,
                  deconv_out_channels=deconv, deconv_kernel_sizes=(4,) * len(deconv),
                  loss=dict(type="KeypointMSELoss", use_target_weight=True), decoder=codec),
        test_cfg=dict(flip_test=True),
    )


def randomize_batch_stats(module: torch.nn.Module, seed: int) -> None:
    """Every BatchNorm's running mean in [-0.2, 0.2) and variance in [0.5, 1.5)."""
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for name, buf in module.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(torch.from_numpy(rng.uniform(-0.2, 0.2, buf.shape).astype(np.float32)))
            elif name.endswith("running_var"):
                buf.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, buf.shape).astype(np.float32)))


def seeded_state_dict(cfg, seed):
    """The port's module of ``cfg`` with weights from ``seed`` and randomized
    BatchNorm statistics, as a state dict under mmpose's names."""
    model = PoseModel(cfg, metainfo=META, device="cpu")
    model.init_weights(seed)
    randomize_batch_stats(model.module, seed + 1)
    return {k: v.clone() for k, v in model.module.state_dict().items()}


def both_models(cfg, seed):
    """(port model, JAX model, JAX variables) on one state dict."""
    sd = seeded_state_dict(cfg, seed)
    ours = PoseModel(cfg, metainfo=META, device="cpu")
    ours.module.load_state_dict(sd, strict=True)
    jm = JaxPoseModel(cfg, metainfo=META)
    variables = convert_torch_state_dict({k: v.numpy() for k, v in sd.items()})
    return ours, jm, variables


def _crops(n, seed, size=(256, 192)):
    return np.round(np.random.RandomState(seed).rand(n, *size, 3) * 255).astype(np.float32)


def _smooth_crops(n, seed, size=(256, 192)):
    """Crops of smooth stripes and blobs, as images are, rounded to uint8
    values: on uniform noise the BatchNorm backward of a random network
    cancels most of each gradient, and f32 rounding decides the sign of
    the small elements that Adam then turns into full steps."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:size[0], :size[1]].astype(np.float64)
    img = 127.5 + 60 * np.sin(xx[None, ..., None] / rng.uniform(6, 14, (n, 1, 1, 3))
                              + yy[None, ..., None] / rng.uniform(8, 16, (n, 1, 1, 3)))
    img += 30 * np.cos(yy / rng.uniform(15, 30, (n, 1, 1)))[..., None] + rng.uniform(-10, 10, (n, *size, 3))
    return np.round(np.clip(img, 0, 255)).astype(np.float32)


def _boundary_keypoints(seed, n=6, W=48, H=64):
    """(n, 17, 2) heatmap-space keypoints: random ones, ones on .5 (where the
    centre's rounding turns), ones just inside and outside the 3-sigma reach
    of the map, and far outside."""
    rng = np.random.RandomState(seed)
    kpts = np.stack([rng.uniform(-10, W + 10, (n, 17)), rng.uniform(-10, H + 10, (n, 17))], -1)
    kpts[:, :6] = np.round(kpts[:, :6]) + 0.5
    kpts[:, 6] = (-6.5, -7.5)
    kpts[:, 7] = (W + 5.5, H + 6.5)
    kpts[:, 8] = (-6.4, 30.0)
    kpts[:, 9] = (-300.0, 400.0)
    return kpts


@pytest.mark.parametrize("unbiased", [False, True], ids=["msra", "unbiased"])
def test_gaussians_match_golden(unbiased):
    data = np.load(f"{GOLDEN}/gaussians.npz")
    kpts, vis = data["keypoints"], data["visible"]
    name = "unbiased" if unbiased else "msra"
    host = generate_unbiased_gaussian_heatmaps if unbiased else generate_gaussian_heatmaps
    maps, weights = host((48, 64), kpts.copy(), vis.copy(), sigma=2.0)
    np.testing.assert_allclose(maps, data[name], atol=1e-6)
    np.testing.assert_array_equal(weights, data[f"{name}_w"])
    device = generate_unbiased_gaussian_device if unbiased else generate_gaussian_device
    got = device(torch.from_numpy(kpts.astype(np.float64)), torch.from_numpy(vis), (48, 64), 2.0)
    assert got.dtype == torch.float32 and got.shape == (2, 17, 64, 48)
    np.testing.assert_allclose(got.amax(dim=0).numpy(), data[name], atol=1e-6)  # instances combine by max


@pytest.mark.parametrize("unbiased", [False, True], ids=["msra", "unbiased"])
@pytest.mark.parametrize("sigma", [2.0, 3.0])
def test_gaussians_match_jax_at_boundaries(unbiased, sigma):
    kpts = _boundary_keypoints(seed=int(sigma) + 3 * unbiased)
    vis = (np.random.RandomState(9).rand(len(kpts), 17) > 0.2).astype(np.float32)
    jfn = jgauss.generate_unbiased_gaussian_heatmaps if unbiased else jgauss.generate_gaussian_heatmaps
    ours = generate_unbiased_gaussian_heatmaps if unbiased else generate_gaussian_heatmaps
    device = generate_unbiased_gaussian_device if unbiased else generate_gaussian_device
    got = device(torch.from_numpy(kpts), torch.from_numpy(vis), (48, 64), sigma).numpy()
    gated = []
    for n in range(len(kpts)):
        want, want_w = jfn((48, 64), kpts[n:n + 1].copy(), vis[n:n + 1].copy(), sigma)
        mine, mine_w = ours((48, 64), kpts[n:n + 1].copy(), vis[n:n + 1].copy(), sigma)
        np.testing.assert_allclose(got[n], want, atol=1e-6, err_msg=str(n))
        np.testing.assert_array_equal(mine, want)
        np.testing.assert_array_equal(mine_w, want_w)
        gated.append((vis[n] >= 0.5) & (mine_w[0] == 0))
    assert 0 < np.sum(gated) < (vis >= 0.5).sum()  # some visible keypoints miss the map, not all


@pytest.mark.parametrize("codec", [MSRA, DARK], ids=["msra", "dark"])
def test_generate_target_then_device_encode_match_the_jax_codec(codec):
    """Input-space keypoints whose heatmap coordinate lands on .5 (x / 4 =
    k + 0.5), through the port's GenerateTarget (weights in the worker,
    float64 keypoints shipped) and the device encode, against the JAX
    GenerateTarget's host encode."""
    rng = np.random.RandomState(4)
    ours, theirs = GenerateTarget(encoder=dict(codec)), JaxGenerateTarget(encoder=dict(codec))
    port_codec, jax_codec = MSRAHeatmap(**{k: v for k, v in codec.items() if k != "type"}), JaxMSRAHeatmap(
        **{k: v for k, v in codec.items() if k != "type"})
    for trial in range(4):
        kpts = np.stack([rng.uniform(-40, 232, (1, 17)), rng.uniform(-40, 296, (1, 17))], -1).astype(np.float32)
        kpts[0, :5] = np.round(kpts[0, :5] / 4) * 4 + 2.0  # heatmap coordinate k + 0.5
        vis = (rng.rand(1, 17) > 0.2).astype(np.float32)
        a = ours({"transformed_keypoints": kpts.copy(), "keypoints_visible": vis.copy()})
        b = theirs({"transformed_keypoints": kpts.copy(), "keypoints_visible": vis.copy()})
        assert a["device_kpts_hm"].dtype == np.float64
        np.testing.assert_array_equal(a["keypoint_weights"], b["keypoint_weights"])
        gen = generate_unbiased_gaussian_device if codec.get("unbiased") else generate_gaussian_device
        maps = gen(torch.from_numpy(a["device_kpts_hm"]), torch.from_numpy(a["device_kpts_visible"]), (48, 64),
                   2.0)
        np.testing.assert_allclose(maps[0].numpy(), b["heatmaps"], atol=1e-6, err_msg=str(trial))
        np.testing.assert_array_equal(port_codec.encode(kpts, vis)["heatmaps"], jax_codec.encode(kpts, vis)["heatmaps"])


def test_quarter_and_dark_decodes_match_golden():
    data = np.load(f"{GOLDEN}/decode.npz")
    hm = torch.from_numpy(data["heatmaps"])[None]
    locs = torch.from_numpy(data["locs_max"])[None]
    np.testing.assert_allclose(tdecode.quarter_offset_refine_batch(locs, hm).numpy(), data["quarter"], atol=1e-5)
    np.testing.assert_allclose(tdecode.dark_refine_batch(locs, hm, 11).numpy(), data["dark"], atol=1e-5)


def test_quarter_and_dark_decodes_match_jax():
    """Peaks everywhere, the border rows and columns among them (the
    asymmetric validity tests), on noisy maps."""
    rng = np.random.RandomState(5)
    B, K, H, W = 3, 17, 64, 48
    yy, xx = np.mgrid[:H, :W]
    cy = rng.randint(0, H, (B, K, 1, 1)).astype(np.float64)
    cx = rng.randint(0, W, (B, K, 1, 1)).astype(np.float64)
    cy[0, :4, 0, 0], cx[0, :4, 0, 0] = (0, 1, H - 2, H - 1), (W - 1, 1, 0, W - 2)
    hm = (np.exp(-((yy - cy - 0.3) ** 2 + (xx - cx + 0.2) ** 2) / 6.0) + 0.01 * rng.rand(B, K, H, W))
    hm = hm.astype(np.float32)
    locs, _ = tdecode.heatmap_maximum_batch(torch.from_numpy(hm))
    for ours, theirs in ((lambda l, h: tdecode.quarter_offset_refine_batch(l, h), jdecode.quarter_offset_refine_batch),
                         (lambda l, h: tdecode.dark_refine_batch(l, h, 11), jdecode.dark_refine_batch)):
        got = ours(locs, torch.from_numpy(hm)).numpy()
        want = np.asarray(theirs(locs.numpy(), hm))
        np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("codec", [MSRA, DARK], ids=["msra", "dark"])
def test_predict_keypoints_on_peaked_maps_match_the_jax_codec(codec):
    """``heatmap_head_predict`` (flip average, decode, input / W scale) on
    peaked maps against the JAX codec's decode of the same averaged maps."""
    from chip_smoke import peaked_heatmaps

    hm = peaked_heatmaps(4, 17, 64, 48, seed=6)
    flipped = peaked_heatmaps(4, 17, 64, 48, seed=7)
    res = heatmap_head_predict(torch.from_numpy(hm), torch.from_numpy(flipped), META["flip_indices"], codec)
    averaged = res["heatmaps"].numpy()
    jax_codec = JaxMSRAHeatmap(**{k: v for k, v in codec.items() if k != "type"})
    port_codec = MSRAHeatmap(**{k: v for k, v in codec.items() if k != "type"})
    for b in range(4):
        want, scores = jax_codec.decode(averaged[b].copy())
        np.testing.assert_allclose(res["keypoints"][b].numpy(), want[0], atol=1e-3)
        np.testing.assert_allclose(res["keypoint_scores"][b].numpy(), scores[0], atol=1e-6)
        np.testing.assert_allclose(port_codec.decode(averaged[b])[0][0], want[0], atol=1e-3)


@pytest.mark.parametrize("depth", [18, 50])
def test_resnet_features_and_heatmaps_match_jax(depth):
    cfg = _cfg(depth)
    ours, jm, variables = both_models(cfg, seed=depth)
    ours.eval()
    crops = _crops(2, seed=3, size=(128, 96))
    x = jm.preprocess(crops)
    want = jm.module.apply(variables, x, method=lambda m, x: m.backbone(x, train=False))
    with torch.no_grad():
        got = ours.module.backbone(ours.preprocess(torch.from_numpy(crops)).permute(0, 3, 1, 2))
        heatmaps = ours.module(ours.preprocess(torch.from_numpy(crops)))
    assert len(got) == len(want) == 1
    w = np.transpose(np.asarray(want[0]), (0, 3, 1, 2))
    assert got[0].shape == w.shape
    assert np.abs(got[0].numpy() - w).max() < 1e-5 * np.abs(w).max()
    ref = np.asarray(jm.forward(variables, crops))
    assert heatmaps.shape == ref.shape
    assert np.abs(heatmaps.numpy() - ref).max() < 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("codec", [MSRA, DARK], ids=["msra", "dark"])
def test_predict_matches_jax(codec):
    """The whole predict program with flip-TTA on the same crops."""
    cfg = _cfg(codec=codec)
    ours, jm, variables = both_models(cfg, seed=11)
    crops = _crops(2, seed=12)
    want = {k: np.asarray(v) for k, v in jm.make_predict(jit=False)(variables, crops).items()}
    got = ours.predict(torch.from_numpy(crops))
    assert np.abs(got["heatmaps"].numpy() - want["heatmaps"]).max() < 1e-5 * np.abs(want["heatmaps"]).max()
    np.testing.assert_allclose(got["keypoints"].numpy(), want["keypoints"], atol=1e-3 * 4)  # 1e-3 heatmap px
    np.testing.assert_allclose(got["keypoint_scores"].numpy(), want["keypoint_scores"], atol=1e-5)


def _train_batches(codec, seed):
    """Two crops with input-space keypoints (some outside, some unannotated):
    the JAX batch with the host codec's maps, the port's with what its
    GenerateTarget ships (the maps rendered by ``device_preprocess_batch``)."""
    rng = np.random.RandomState(seed)
    ours, theirs = GenerateTarget(encoder=dict(codec)), JaxGenerateTarget(encoder=dict(codec))
    port, jaxb = [], []
    for _ in range(2):
        kpts = np.stack([rng.uniform(-20, 212, (1, 17)), rng.uniform(-20, 276, (1, 17))], -1).astype(np.float32)
        vis = (rng.rand(1, 17) > 0.2).astype(np.float32)
        port.append(ours({"transformed_keypoints": kpts.copy(), "keypoints_visible": vis.copy()}))
        jaxb.append(theirs({"transformed_keypoints": kpts.copy(), "keypoints_visible": vis.copy()}))
    inputs = _smooth_crops(2, seed + 1)
    jax_batch = dict(inputs=inputs, heatmaps=np.stack([r["heatmaps"] for r in jaxb]).astype(np.float32),
                     keypoint_weights=np.stack([r["keypoint_weights"][0] for r in jaxb]).astype(np.float32))
    port_batch = dict(inputs=torch.from_numpy(inputs),
                      kpts_hm=torch.from_numpy(np.stack([r["device_kpts_hm"][0] for r in port])),
                      kpts_visible=torch.from_numpy(np.stack([r["device_kpts_visible"][0] for r in port])),
                      keypoint_weights=torch.from_numpy(np.stack([r["keypoint_weights"][0] for r in port])))
    return jax_batch, port_batch


@pytest.mark.parametrize("codec", [MSRA, DARK], ids=["msra", "dark"])
def test_loss_and_three_adam_steps_match_jax(codec):
    """On the narrow ResNet-18, two crops of smooth image-like patterns
    (measured: each parameter within 2.6e-4 of its change). The narrow
    ResNet-50's bottlenecks (4 to 32 channels) make BatchNorm's training
    backward ill-conditioned in f32 at this batch: both packages' f32
    backbone gradients lie about 2% from a float64 run of the port (median
    over tensors), so they cannot agree better than that; its forward is
    held above, and the card trains it at full width (``res50_train``)."""
    cfg = _cfg(depth=18, codec=codec)
    ours, jm, variables = both_models(cfg, seed=21)
    jax_batch, port_batch = _train_batches(codec, seed=22)
    tx, jax_lr = jax_build_optimizer(variables["params"], OPTIM, SCHEDULE, STEPS_PER_EPOCH, MAX_EPOCHS)
    state = jax_create_train_state(variables, tx)
    step = jax_make_train_step(jm, tx, mesh=None, donate=False)
    want = []
    for _ in range(STEPS):
        state, metrics = step(state, jax_batch, jax.random.PRNGKey(0))
        want.append({k: float(v) for k, v in metrics.items()})
    final_params = jax.tree_util.tree_map(np.asarray, state.params)

    start = {k: v.clone() for k, v in ours.module.state_dict().items()}
    optimizer, lr_fn = build_optimizer(ours, OPTIM, SCHEDULE, STEPS_PER_EPOCH, MAX_EPOCHS)
    assert [lr_fn(k) for k in range(6)] == pytest.approx([float(jax_lr(k)) for k in range(6)], rel=1e-6)
    tstate, tstep = create_train_state(ours, optimizer), make_train_step(ours, optimizer)
    for k in range(STEPS):
        tstate, metrics = tstep(tstate, port_batch, torch.Generator().manual_seed(0))
        got = {name: float(v) for name, v in metrics.items()}
        for name in ("loss_kpt", "acc_pose", "loss"):
            assert got[name] == pytest.approx(want[k][name], rel=2e-5, abs=1e-6), (k, name)

    # the final parameters, moved to JAX's tree by the same converter
    final = convert_torch_state_dict({k: v.numpy() for k, v in ours.module.state_dict().items()})
    begin = convert_torch_state_dict({k: v.numpy() for k, v in start.items()})
    flat_got = jax.tree_util.tree_leaves_with_path(final["params"])
    flat_want = dict(jax.tree_util.tree_leaves_with_path(final_params))
    flat_begin = dict(jax.tree_util.tree_leaves_with_path(begin["params"]))
    assert len(flat_got) == len(flat_want)
    for path, g in flat_got:
        w, s = flat_want[path], flat_begin[path]
        change = np.linalg.norm(w - s)
        assert change > 0, path
        assert np.linalg.norm(g - w) <= 2e-3 * change, path
    got_stats = dict(jax.tree_util.tree_leaves_with_path(final["batch_stats"]))
    for path, w in jax.tree_util.tree_leaves_with_path(jax.tree_util.tree_map(np.asarray, state.batch_stats)):
        np.testing.assert_allclose(got_stats[path], w, rtol=1e-4, atol=1e-6, err_msg=str(path))


@pytest.mark.parametrize("depth", [18, 50])
def test_reference_names_load_strict(depth):
    """The port's names are mmpose's: the JAX package's converter, written
    for mmpose's keys, reads every one of them into a tree of the JAX model's
    own structure and shapes, and the same dict loads into a fresh port
    model with ``strict=True``."""
    cfg = _cfg(depth)
    sd = seeded_state_dict(cfg, seed=1)
    for key in ("backbone.conv1.weight", "backbone.bn1.running_var", "backbone.layer1.0.conv1.weight",
                "backbone.layer2.0.downsample.0.weight", "backbone.layer4.1.bn2.weight",
                "head.deconv_layers.0.weight", "head.deconv_layers.1.running_mean", "head.final_layer.bias"):
        assert key in sd, key
    converted = convert_torch_state_dict({k: v.numpy() for k, v in sd.items()})
    init = JaxPoseModel(cfg, metainfo=META).init(seed=0)
    for part in ("params", "batch_stats"):
        assert (jax.tree_util.tree_structure(converted[part])
                == jax.tree_util.tree_structure(jax.tree_util.tree_map(np.asarray, init[part])))
        for a, b in zip(jax.tree_util.tree_leaves(converted[part]), jax.tree_util.tree_leaves(init[part])):
            assert a.shape == b.shape
    n_tensors = sum(1 for k in sd if not k.endswith("num_batches_tracked"))
    n_leaves = sum(len(jax.tree_util.tree_leaves(converted[p])) for p in ("params", "batch_stats"))
    assert n_tensors == n_leaves
    PoseModel(cfg, metainfo=META, device="cpu").module.load_state_dict(sd, strict=True)


@pytest.mark.parametrize("name", sorted(CLASSIC_RECIPES))
def test_configs_build_on_the_cpu_only_when_asked(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_model(str(CLASSIC_RECIPES[name]))
    model = init_model(str(CLASSIC_RECIPES[name]), device="cpu")
    n_params = sum(p.numel() for p in model.module.parameters())
    if "res50" in name:
        assert 33.9e6 < n_params < 34.1e6  # SimpleBaseline ResNet-50: 34.0 M
    else:
        assert 28e6 < n_params < 29e6  # HRNet-w32 + a 1x1 head: 28.5 M
    assert model.decoder_cfg["type"] == "MSRAHeatmap"
    assert model.decoder_cfg.get("unbiased", False) == ("dark" in name)
    optimizer, _ = build_optimizer(model, copy.deepcopy(dict(model.cfg_full["optim_wrapper"])),
                                   model.cfg_full["param_scheduler"], 10, 210)
    assert [g["weight_decay"] for g in optimizer.groups] == [0.0]


def test_res50_dark_config_predicts_at_full_width():
    model = init_model(str(CLASSIC_RECIPES["res50_dark"]), device="cpu")
    preds = model.predict(torch.from_numpy(_crops(1, seed=7)))
    assert preds["keypoints"].shape == (1, 17, 2) and torch.isfinite(preds["keypoints"]).all()
    assert preds["heatmaps"].shape == (1, 17, 64, 48)


def test_classic_fixture_through_inference_topdown_and_coco_metric():
    """``chip_smoke.model_fixture_report``, the card's ``classic_golden``
    check, on the CPU: ``init_model`` with the fixture's weights (strict),
    ``inference_topdown`` over the golden images, ``CocoMetric``; the maps
    of the fixture's crops against the JAX package's."""
    report = model_fixture_report(CLASSIC_FIXTURE, device="cpu")
    assert report["instances"] == 62 and report["sane"] > 0.97, report
    assert report["p99"] < 1.0 and report["over_5px"] <= 1, report
    assert report["scores"] < 2e-3 and report["d_AP"] < 0.01, report
    assert report["outputs_rel"] < 1e-4, report
    assert report["ok"]
