"""RTMPose (CSPNeXt, RTMCCHead with its GAU, the SimCC codec) on the CPU: the
port against the JAX package on the same weights and inputs.

One torch state dict under mmpose's names (the port's module, its weights
drawn from a seed and its BatchNorm statistics randomized) feeds both
stacks: the JAX side loads it through ``convert_torch_state_dict``.

Bars, with their reasons:
- features, SimCC vectors, ScaleNorm and the GAU: relative 1e-5 (f32 on
  both sides, summation order);
- the SimCC encode: atol 1e-6 against the port's codec copy and the JAX
  codec (float64 gaussians rounded to f32 once), weights exact; keypoints
  whose bins round half to even and keypoints out of bounds among them;
- ``simcc_maximum_batch`` and the flip: exact against ``simcc.npz`` and the
  JAX functions (an argmax, a max, a permutation);
- ``KLDiscretLoss``: relative 1e-5;
- three AdamW steps under the recipe's ``paramwise_cfg``: the bars of
  ``tests/test_torch_hrnet.py`` (losses rel 2e-5, each parameter within
  2e-3 of its change in l2 norm), and each parameter's decay switch equal
  to the JAX mask's;
- the golden fixture (``tests/golden_torch/rtmpose_fixture.npz``):
  ``chip_smoke.UDP_BARS``, as the card's ``rtmpose_golden`` phase holds it.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import RTMPOSE, RTMPOSE_FIXTURE, mini_coco_set, model_fixture_report
from probpose_code_torch.apis import init_model
from probpose_code_torch.codecs.simcc_label import SimCCLabel
from probpose_code_torch.config import Config
from probpose_code_torch.datasets.transforms.common import GenerateTarget
from probpose_code_torch.engine.optim import build_optimizer
from probpose_code_torch.models.builder import PoseModel
from probpose_code_torch.models.losses import KLDiscretLoss
from probpose_code_torch.models.utils.rtmcc_block import RTMCCBlock, ScaleNorm, rope
from probpose_code_torch.ops.decode import simcc_maximum_batch
from probpose_code_torch.ops.encode import generate_simcc_labels_device
from probpose_code_torch.ops.tta import flip_vectors
from probpose_code_torch.parallel import create_train_state, make_train_step
from probpose_code_torch.tools import train as train_cli
from probpose_code_tpu.codecs import SimCCLabel as JaxSimCCLabel
from probpose_code_tpu.datasets.transforms.common import GenerateTarget as JaxGenerateTarget
from probpose_code_tpu.engine.checkpoint import convert_torch_state_dict
from probpose_code_tpu.engine.optim import build_optimizer as jax_build_optimizer
from probpose_code_tpu.engine.optim import make_wd_mask_tree
from probpose_code_tpu.models import PoseModel as JaxPoseModel
from probpose_code_tpu.models.losses.classification_loss import KLDiscretLoss as JaxKLDiscretLoss
from probpose_code_tpu.models.utils import rtmcc_block as jblock
from probpose_code_tpu.ops import decode as jdecode
from probpose_code_tpu.ops import tta as jtta
from probpose_code_tpu.parallel import create_train_state as jax_create_train_state
from probpose_code_tpu.parallel import make_train_step as jax_make_train_step
from tests.test_torch_classic_heatmap import META, _crops, _smooth_crops, both_models

RECIPE = Config.fromfile(str(RTMPOSE))
CODEC = dict(type="SimCCLabel", input_size=(192, 256), sigma=(4.9, 5.66), simcc_split_ratio=2.0, normalize=False,
             use_dark=False)
SCHEDULE = [
    dict(type="LinearLR", start_factor=0.001, by_epoch=False, begin=0, end=4),
    dict(type="CosineAnnealingLR", eta_min=1e-4, begin=1, end=10, by_epoch=True),
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


def _cfg(widen=0.125, hidden=32, s=16, codec=CODEC):
    """The recipe's model, narrowed: CSPNeXt widen 0.125 / deepen 0.167 and
    a GAU of width ``hidden``."""
    cfg = copy.deepcopy(_plain(dict(RECIPE["model"])))
    cfg["backbone"].update(deepen_factor=0.167, widen_factor=widen)
    cfg["head"].update(in_channels=int(1024 * widen), decoder=dict(codec))
    cfg["head"]["gau_cfg"].update(hidden_dims=hidden, s=s)
    return cfg


def test_cspnext_features_and_simcc_vectors_match_jax():
    cfg = _cfg()
    ours, jm, variables = both_models(cfg, seed=31)
    ours.eval()
    crops = _crops(2, seed=3)
    x = jm.preprocess(crops)
    want = jm.module.apply(variables, x, method=lambda m, x: m.backbone(x, train=False))
    with torch.no_grad():
        got = ours.module.backbone(ours.preprocess(torch.from_numpy(crops)).permute(0, 3, 1, 2))
        px, py = ours.module(ours.preprocess(torch.from_numpy(crops)))
    w = np.transpose(np.asarray(want[0]), (0, 3, 1, 2))
    assert got[0].shape == w.shape == (2, 128, 8, 6)
    assert np.abs(got[0].numpy() - w).max() < 1e-5 * np.abs(w).max()
    rx, ry = (np.asarray(v) for v in jm.forward(variables, crops))
    assert px.shape == rx.shape == (2, 17, 384) and py.shape == ry.shape == (2, 17, 512)
    for g, r in ((px, rx), (py, ry)):
        assert np.abs(g.numpy() - r).max() < 1e-5 * np.abs(r).max()


def test_every_stage_and_the_stem_match_jax():
    """``out_indices`` 0-4: the stem and each stage (the SPP bottleneck and
    a CSP layer without identity in the last)."""
    cfg = _cfg()
    cfg["backbone"]["out_indices"] = (0, 1, 2, 3, 4)
    ours, jm, variables = both_models(cfg, seed=32)
    ours.eval()
    crops = _crops(1, seed=4, size=(128, 96))
    want = jm.module.apply(variables, jm.preprocess(crops), method=lambda m, x: m.backbone(x, train=False))
    with torch.no_grad():
        got = ours.module.backbone(ours.preprocess(torch.from_numpy(crops)).permute(0, 3, 1, 2))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        w = np.transpose(np.asarray(w), (0, 3, 1, 2))
        assert g.shape == w.shape
        assert np.abs(g.numpy() - w).max() < 1e-5 * np.abs(w).max()


def test_scale_norm_matches_jax():
    x = np.random.RandomState(0).randn(2, 17, 48).astype(np.float32)
    x[0, 0] = 0.0  # the eps floor
    norm = ScaleNorm(48)
    with torch.no_grad():
        norm.g.fill_(1.7)
    want = jblock.ScaleNorm().apply({"params": {"g": np.array([1.7], np.float32)}}, x)
    got = norm(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-7)


def test_rope_matches_jax():
    x = np.random.RandomState(1).randn(2, 17, 2, 16).astype(np.float32)
    np.testing.assert_allclose(rope(torch.from_numpy(x), axis=1).numpy(), np.asarray(jblock.rope(x, axis=1)),
                               rtol=1e-5, atol=1e-5)


def _gau_params(block: RTMCCBlock):
    p = dict(ln={"g": block.ln.g.detach().numpy()}, uv={"kernel": block.uv.weight.detach().numpy().T},
             gamma=block.gamma.detach().numpy(), beta=block.beta.detach().numpy(),
             o={"kernel": block.o.weight.detach().numpy().T}, res_scale=block.res_scale.scale.detach().numpy())
    if block.w is not None:
        p["w"] = block.w.detach().numpy()
    return p


@pytest.mark.parametrize("use_rel_bias, pos_enc, act_fn", [(False, False, "SiLU"), (True, False, "ReLU"),
                                                           (False, True, "SiLU")],
                         ids=["rtmpose", "rel_bias", "rope"])
def test_gau_matches_jax(use_rel_bias, pos_enc, act_fn):
    """The GAU with each option: the relative position bias and rope each
    held on their own (RTMPose-m sets neither)."""
    torch.manual_seed(0)
    block = RTMCCBlock(17, 32, 32, s=16, act_fn=act_fn, use_rel_bias=use_rel_bias, pos_enc=pos_enc)
    with torch.no_grad():
        for p in block.parameters():
            p.copy_(torch.randn(p.shape) * 0.5 + (1.0 if p.dim() == 1 and p is not block.w else 0.0))
    x = np.random.RandomState(2).randn(2, 17, 32).astype(np.float32)
    jb = jblock.RTMCCBlock(num_token=17, in_token_dims=32, out_token_dims=32, s=16, act_fn=act_fn,
                           use_rel_bias=use_rel_bias, pos_enc=pos_enc)
    want = np.asarray(jb.apply({"params": _gau_params(block)}, x))
    got = block(torch.from_numpy(x)).detach().numpy()
    assert np.abs(got - want).max() < 1e-5 * np.abs(want).max()
    if use_rel_bias:
        bias = block.rel_pos_bias(17).detach().numpy()
        np.testing.assert_array_equal(bias, np.asarray(jb.apply({"params": _gau_params(block)}, block.w.detach().numpy(),
                                                                17, method=jb._rel_pos_bias)))
        assert bias[0, 16] == block.w[32] and bias[16, 0] == block.w[0]


def _simcc_cases(seed):
    """Input-space keypoints: random, ones whose bins round half to even
    (x * 2 = k + 0.5), ones whose 3-sigma window just misses or touches the
    vectors, and far outside."""
    rng = np.random.RandomState(seed)
    kpts = np.stack([rng.uniform(-20, 212, (3, 17)), rng.uniform(-20, 276, (3, 17))], -1).astype(np.float32)
    kpts[:, :4] = np.floor(kpts[:, :4]) + np.array([0.25, 0.75], np.float32)
    kpts[:, 4] = (-8.0, -9.0)
    kpts[:, 5] = (-7.0, 270.0)
    kpts[:, 6] = (199.5, 264.75)
    kpts[:, 7] = (-500.0, 900.0)
    vis = (rng.rand(3, 17) > 0.2).astype(np.float32)
    return kpts, vis


@pytest.mark.parametrize("smoothing, normalize, lsw", [("gaussian", False, 0.0), ("gaussian", True, 0.0),
                                                       ("standard", False, 0.0), ("standard", False, 0.1)],
                         ids=["gaussian", "gaussian_normalized", "standard", "standard_smoothed"])
def test_simcc_encode_matches_jax(smoothing, normalize, lsw):
    kw = dict(input_size=(192, 256), smoothing_type=smoothing, sigma=(4.9, 5.66) if smoothing == "gaussian" else 6.0,
              simcc_split_ratio=2.0, normalize=normalize, label_smooth_weight=lsw)
    ours, theirs = SimCCLabel(**kw), JaxSimCCLabel(**kw)
    kpts, vis = _simcc_cases(seed=len(smoothing) + normalize)
    for n in range(len(kpts)):
        want = theirs.encode(kpts[n:n + 1], vis[n:n + 1])
        mine = ours.encode(kpts[n:n + 1], vis[n:n + 1])
        for key in ("keypoint_x_labels", "keypoint_y_labels", "keypoint_weights"):
            np.testing.assert_array_equal(mine[key], want[key], err_msg=key)
        bins = torch.from_numpy(ours.bins(kpts[n:n + 1]).astype(np.float32))
        x, y = generate_simcc_labels_device(bins, torch.from_numpy(vis[n:n + 1]), (192, 256), 2.0, kw["sigma"],
                                            smoothing, normalize, lsw)
        np.testing.assert_allclose(x.numpy(), want["keypoint_x_labels"], atol=1e-6)
        np.testing.assert_allclose(y.numpy(), want["keypoint_y_labels"], atol=1e-6)
    assert ours.split_sizes() == (384, 512)
    assert (mine["keypoint_weights"] == 0).any() or smoothing == "standard"


def test_generate_target_then_device_encode_match_the_jax_codec():
    ours, theirs = GenerateTarget(encoder=dict(CODEC)), JaxGenerateTarget(encoder=dict(CODEC))
    kpts, vis = _simcc_cases(seed=7)
    for n in range(len(kpts)):
        a = ours({"transformed_keypoints": kpts[n:n + 1].copy(), "keypoints_visible": vis[n:n + 1].copy()})
        b = theirs({"transformed_keypoints": kpts[n:n + 1].copy(), "keypoints_visible": vis[n:n + 1].copy()})
        np.testing.assert_array_equal(a["keypoint_weights"], b["keypoint_weights"])
        x, y = generate_simcc_labels_device(torch.from_numpy(a["device_kpts_hm"]),
                                            torch.from_numpy(a["device_kpts_visible"]), (192, 256), 2.0,
                                            CODEC["sigma"], normalize=False)
        np.testing.assert_allclose(x.numpy(), b["keypoint_x_labels"], atol=1e-6)
        np.testing.assert_allclose(y.numpy(), b["keypoint_y_labels"], atol=1e-6)


def test_simcc_maximum_and_flip_match_golden_and_jax():
    data = np.load("tests/golden/simcc.npz")
    sx, sy = torch.from_numpy(data["simcc_x"]), torch.from_numpy(data["simcc_y"])
    locs, vals = simcc_maximum_batch(sx, sy)
    np.testing.assert_array_equal(locs.numpy(), data["locs"])
    np.testing.assert_array_equal(vals.numpy(), data["vals"])
    neg = -sx.abs()  # every score <= 0: locations -1
    jl, jv = jdecode.simcc_maximum_batch(neg.numpy(), data["simcc_y"])
    tl, tv = simcc_maximum_batch(neg, sy)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert (tl.numpy() == -1).all()
    codec_kw = dict(input_size=(192, 256), sigma=(4.9, 5.66), simcc_split_ratio=2.0)
    want_k, want_s = JaxSimCCLabel(**codec_kw).decode(data["simcc_x"].copy(), data["simcc_y"].copy())
    got_k, got_s = SimCCLabel(**codec_kw).decode(data["simcc_x"], data["simcc_y"])
    np.testing.assert_array_equal(got_k, want_k)
    np.testing.assert_array_equal(got_s, want_s)
    fx, fy = flip_vectors(sx, sy, META["flip_indices"])
    jx, jy = jtta.flip_vectors(data["simcc_x"], data["simcc_y"], META["flip_indices"])
    np.testing.assert_array_equal(fx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(fy.numpy(), np.asarray(jy))


@pytest.mark.parametrize("label_softmax, mask", [(True, None), (False, [0, 5])], ids=["recipe", "masked"])
def test_kl_discret_loss_matches_jax(label_softmax, mask):
    rng = np.random.RandomState(3)
    pred = (rng.randn(3, 17, 384).astype(np.float32), rng.randn(3, 17, 512).astype(np.float32))
    gt = (rng.rand(3, 17, 384).astype(np.float32), rng.rand(3, 17, 512).astype(np.float32))
    w = (rng.rand(3, 17) > 0.3).astype(np.float32)
    kw = dict(beta=10.0, label_softmax=label_softmax, use_target_weight=True, mask=mask, mask_weight=2.0)
    want = float(JaxKLDiscretLoss(**kw)(pred, gt, w))
    got = float(KLDiscretLoss(**kw)(tuple(map(torch.from_numpy, pred)), tuple(map(torch.from_numpy, gt)),
                                    torch.from_numpy(w)))
    assert got == pytest.approx(want, rel=1e-5)


def test_predict_matches_jax():
    cfg = _cfg()
    ours, jm, variables = both_models(cfg, seed=33)
    crops = _crops(2, seed=5)
    want = {k: np.asarray(v) for k, v in jm.make_predict(jit=False)(variables, crops).items()}
    got = ours.predict(torch.from_numpy(crops))
    for key in ("keypoint_x_labels", "keypoint_y_labels"):
        assert np.abs(got[key].numpy() - want[key]).max() < 1e-5 * np.abs(want[key]).max(), key
    np.testing.assert_array_equal(got["keypoints"].numpy(), want["keypoints"])
    np.testing.assert_allclose(got["keypoint_scores"].numpy(), want["keypoint_scores"], rtol=1e-5, atol=1e-6)


def _train_batches(seed):
    rng = np.random.RandomState(seed)
    ours, theirs = GenerateTarget(encoder=dict(CODEC)), JaxGenerateTarget(encoder=dict(CODEC))
    port, jaxb = [], []
    for _ in range(2):
        kpts = np.stack([rng.uniform(-20, 212, (1, 17)), rng.uniform(-20, 276, (1, 17))], -1).astype(np.float32)
        vis = (rng.rand(1, 17) > 0.2).astype(np.float32)
        port.append(ours({"transformed_keypoints": kpts.copy(), "keypoints_visible": vis.copy()}))
        jaxb.append(theirs({"transformed_keypoints": kpts.copy(), "keypoints_visible": vis.copy()}))
    inputs = _smooth_crops(2, seed + 1)
    jax_batch = dict(inputs=inputs, keypoint_weights=np.stack([r["keypoint_weights"][0] for r in jaxb]),
                     **{k: np.stack([r[k][0] for r in jaxb]) for k in ("keypoint_x_labels", "keypoint_y_labels")})
    port_batch = dict(inputs=torch.from_numpy(inputs),
                      kpts_hm=torch.from_numpy(np.stack([r["device_kpts_hm"][0] for r in port])),
                      kpts_visible=torch.from_numpy(np.stack([r["device_kpts_visible"][0] for r in port])),
                      keypoint_weights=torch.from_numpy(np.stack([r["keypoint_weights"][0] for r in port])))
    return jax_batch, port_batch


def _optim_wrapper():
    return copy.deepcopy(_plain(dict(RECIPE["optim_wrapper"])))


def test_loss_and_three_adamw_steps_match_jax():
    """The recipe's AdamW (lr 4e-3, weight decay 0.05, its ``paramwise_cfg``)
    over a short LinearLR then CosineAnnealingLR; the SimCC labels rendered
    by ``device_preprocess_batch`` on the port's side, by the JAX host codec
    on the other."""
    cfg = _cfg()
    ours, jm, variables = both_models(cfg, seed=34)
    jax_batch, port_batch = _train_batches(seed=35)
    wrapper = _optim_wrapper()
    tx, jax_lr = jax_build_optimizer(variables["params"], wrapper, SCHEDULE, STEPS_PER_EPOCH, MAX_EPOCHS)
    state = jax_create_train_state(variables, tx)
    step = jax_make_train_step(jm, tx, mesh=None, donate=False)
    want = []
    for _ in range(STEPS):
        state, metrics = step(state, jax_batch, jax.random.PRNGKey(0))
        want.append({k: float(v) for k, v in metrics.items()})
    final_params = jax.tree_util.tree_map(np.asarray, state.params)

    start = {k: v.clone() for k, v in ours.module.state_dict().items()}
    optimizer, lr_fn = build_optimizer(ours, wrapper, SCHEDULE, STEPS_PER_EPOCH, MAX_EPOCHS)
    assert [lr_fn(k) for k in range(20)] == pytest.approx([float(jax_lr(k)) for k in range(20)], rel=1e-6)
    tstate, tstep = create_train_state(ours, optimizer), make_train_step(ours, optimizer)
    for k in range(STEPS):
        tstate, metrics = tstep(tstate, port_batch, torch.Generator().manual_seed(0))
        got = {name: float(v) for name, v in metrics.items()}
        assert set(got) >= {"loss_kpt", "acc_pose", "loss"}
        for name in ("loss_kpt", "acc_pose", "loss"):
            assert got[name] == pytest.approx(want[k][name], rel=2e-5, abs=1e-6), (k, name)

    final = convert_torch_state_dict({k: v.numpy() for k, v in ours.module.state_dict().items()})["params"]
    begin = dict(jax.tree_util.tree_leaves_with_path(
        convert_torch_state_dict({k: v.numpy() for k, v in start.items()})["params"]))
    flat_want = dict(jax.tree_util.tree_leaves_with_path(final_params))
    for path, g in jax.tree_util.tree_leaves_with_path(final):
        w, s = flat_want[path], begin[path]
        change = np.linalg.norm(w - s)
        assert change > 0, path
        assert np.linalg.norm(g - w) <= 2e-3 * change, path


def test_recipe_decay_mask_is_the_jax_one():
    """``paramwise_cfg=dict(norm_decay_mult=0, bias_decay_mult=0)`` is read by
    neither package: the decay switch is the JAX mask's rule (two or more
    dims, not a bias, not ``pos_embed``), so the GAU's (2, s) ``gamma`` and
    ``beta`` decay and its 1-D scales do not."""
    cfg = _cfg()
    model = PoseModel(cfg, metainfo=META, device="cpu")
    wrapper = _optim_wrapper()
    assert wrapper["paramwise_cfg"] == dict(norm_decay_mult=0, bias_decay_mult=0)
    optimizer, _ = build_optimizer(model, wrapper, RECIPE["param_scheduler"], 10, 420)
    names = list(model.module.state_dict())
    marked = {k: torch.full(v.shape, float(i)) for i, (k, v) in enumerate(model.module.state_dict().items())}
    tree = convert_torch_state_dict(marked)["params"]
    leaves = [names[int(np.asarray(leaf).flat[0])] for leaf in jax.tree_util.tree_leaves(tree)]
    decays_of = dict(zip(leaves, jax.tree_util.tree_leaves(make_wd_mask_tree(tree))))
    assert set(decays_of) == set(optimizer.names)
    assert decays_of["head.gau.gamma"] and decays_of["head.gau.beta"] and not decays_of["head.gau.res_scale.scale"]
    for group in optimizer.groups:
        assert group["lr_scale"] == 1.0
        for i in group["index"]:
            assert group["weight_decay"] == (0.05 if decays_of[optimizer.names[i]] else 0.0), optimizer.names[i]


def test_reference_names_load_strict():
    """The JAX package's converter, written for mmpose's keys, reads every
    one of the port's names into a tree of the JAX model's own structure and
    shapes; the dict loads into a fresh port model with ``strict=True``."""
    from tests.test_torch_classic_heatmap import seeded_state_dict

    cfg = _cfg()
    sd = seeded_state_dict(cfg, seed=1)
    for key in ("backbone.stem.0.conv.weight", "backbone.stem.2.bn.running_var", "backbone.stage1.0.conv.weight",
                "backbone.stage1.1.blocks.0.conv2.depthwise_conv.conv.weight", "backbone.stage1.1.attention.fc.bias",
                "backbone.stage4.1.conv2.bn.weight", "backbone.stage4.2.final_conv.conv.weight",
                "head.final_layer.bias", "head.mlp.0.g", "head.mlp.1.weight", "head.gau.uv.weight",
                "head.gau.res_scale.scale", "head.cls_x.weight", "head.cls_y.weight"):
        assert key in sd, key
    converted = convert_torch_state_dict({k: v.numpy() for k, v in sd.items()})
    init = JaxPoseModel(cfg, metainfo=META).init(seed=0)
    for part in ("params", "batch_stats"):
        assert (jax.tree_util.tree_structure(converted[part])
                == jax.tree_util.tree_structure(jax.tree_util.tree_map(np.asarray, init[part])))
        for a, b in zip(jax.tree_util.tree_leaves(converted[part]), jax.tree_util.tree_leaves(init[part])):
            assert a.shape == b.shape
    PoseModel(cfg, metainfo=META, device="cpu").module.load_state_dict(sd, strict=True)


def test_config_builds_on_the_cpu_only_when_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_model(str(RTMPOSE))
    model = init_model(str(RTMPOSE), device="cpu")
    n_params = sum(p.numel() for p in model.module.parameters())
    assert 13.5e6 < n_params < 13.7e6  # RTMPose-m: 13.59 M
    preds = model.predict(torch.from_numpy(_crops(1, seed=7)))
    assert preds["keypoints"].shape == (1, 17, 2) and torch.isfinite(preds["keypoints"]).all()
    assert preds["keypoint_x_labels"].shape == (1, 17, 384) and preds["keypoint_y_labels"].shape == (1, 17, 512)


@pytest.mark.parametrize("missing", ["PipelineSwitchHook", "YOLOXHSVRandomAug", "Albumentation"])
def test_tools_train_refuses_the_recipe_by_name(missing, tmp_path):
    """RTMPose's training needs pieces the port has not ported:
    ``tools.train`` names the first one it meets: the recipe's
    ``PipelineSwitchHook``, then (the hooks left out) ``YOLOXHSVRandomAug``,
    then (that left out too) ``Albumentation``."""
    ann = mini_coco_set(tmp_path / "data")
    pipeline = _plain(RECIPE["train_pipeline"])
    if missing == "Albumentation":
        pipeline = [t for t in pipeline if t["type"] != "YOLOXHSVRandomAug"]
    config = tmp_path / "rtmpose.py"
    config.write_text(f"_base_ = [{str(RTMPOSE)!r}]\n"
                      f"train_dataloader = dict(num_workers=0, dataset=dict(data_root={str(ann.parent)!r}, "
                      f"ann_file={ann.name!r}, data_prefix=dict(img='imgs/'), pipeline={pipeline!r}))\n"
                      + ("" if missing == "PipelineSwitchHook" else "custom_hooks = []\n"))
    with pytest.raises(KeyError, match=missing):
        train_cli.main([str(config), "--work-dir", str(tmp_path / "work"), "--device", "cpu"])


def test_tools_test_evaluates_the_recipe(tmp_path, capsys):
    """``python -m probpose_code_torch.tools.test`` on the RTMPose config
    (narrowed by ``--cfg-options``) over the golden JPEGs on the CPU: the
    recipe's ``PipelineSwitchHook``, a training hook, stays out of the
    evaluation, and the SimCC predictions reach ``CocoMetric``."""
    from chip_smoke import golden_jpeg_set
    from probpose_code_torch.tools import test as test_cli

    _, ann = golden_jpeg_set(tmp_path)
    options = ["model.backbone.widen_factor=0.125", "model.backbone.deepen_factor=0.167", "model.head.in_channels=128",
               "model.head.gau_cfg.hidden_dims=32", "model.head.gau_cfg.s=16",
               f"test_dataloader.dataset.data_root={tmp_path}", f"test_dataloader.dataset.ann_file={ann.name}",
               "test_dataloader.dataset.data_prefix.img=imgs/", "test_dataloader.num_workers=0",
               f"test_evaluator.ann_file={ann}"]
    test_cli.main([str(RTMPOSE), "--device", "cpu", "--cfg-options", *options])
    lines = dict(line.split(": ", 1) for line in capsys.readouterr().out.splitlines()
                 if line.startswith("coco/") and ": " in line)
    assert {"coco/AP", "coco/AR", "coco/OKS"} <= set(lines)
    assert all(np.isfinite(float(v)) for v in lines.values())


def test_rtmpose_fixture_through_inference_topdown_and_coco_metric():
    """``chip_smoke.model_fixture_report``, the card's ``rtmpose_golden``
    check, on the CPU."""
    report = model_fixture_report(RTMPOSE_FIXTURE, device="cpu")
    assert report["instances"] == 62 and report["sane"] > 0.97, report
    assert report["p99"] < 1.0 and report["over_5px"] <= 1, report
    assert report["scores"] < 2e-3 and report["d_AP"] < 0.01, report
    assert report["outputs_rel"] < 1e-4, report
    assert report["ok"]
