"""The port's losses, training decode, target encode and monitors against the
JAX package's, on the same numpy inputs.

Everything here is f32 on both sides, computed with the same formulas; they
differ in summation order only. Bars: rtol 1e-5, atol 1e-6 on values, atol
1e-5 on the blur (two passes of 11 taps) and 1e-4 heatmap pixels on the
decoded coordinates (a log and a 2x2 solve amplify the blur's last bits),
and exact equality on integer decisions (argmax locations, gathers).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probpose_code_torch.models import losses as tl
from probpose_code_torch.models.builder import PoseModel
from probpose_code_torch.models.pose_estimators import topdown as ttd
from probpose_code_torch.ops import decode as tdec
from probpose_code_torch.ops import encode as tenc
from probpose_code_torch.ops import heatmap as thm
from probpose_code_tpu.models.losses import classification_loss as jcls
from probpose_code_tpu.models.losses import heatmap_loss as jhl
from probpose_code_tpu.models.losses import regression_loss as jreg
from probpose_code_tpu.models.pose_estimators import topdown as jtd
from probpose_code_tpu.ops import decode as jdec
from probpose_code_tpu.ops import encode as jenc
from probpose_code_tpu.ops import heatmap as jhm

B, K, H, W = 3, 17, 64, 48


def close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got.detach() if torch.is_tensor(got) else got, np.float32),
                               np.asarray(want, np.float32), rtol=rtol, atol=atol)


def _maps(seed, peaked=True):
    rng = np.random.RandomState(seed)
    if not peaked:
        return rng.rand(B, K, H, W).astype(np.float32)
    yy, xx = np.mgrid[:H, :W]
    cy = rng.uniform(-3, H + 3, (B, K, 1, 1))
    cx = rng.uniform(-3, W + 3, (B, K, 1, 1))
    maps = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * rng.uniform(1, 3, (B, K, 1, 1))))
    maps[0, :3] = 0.0  # invisible keypoints: all-zero maps
    return maps.astype(np.float32)


def _weights(seed):
    rng = np.random.RandomState(seed)
    return (rng.rand(B, K) > 0.3).astype(np.float32)


@pytest.mark.parametrize("oks_type", ["minus", "plus", "both"])
@pytest.mark.parametrize("mode", ["per_pixel", "per_keypoint", "mean"])
def test_oks_heatmap_loss(oks_type, mode):
    out, tgt, w = _maps(0, peaked=False), _maps(1), _weights(2)
    mask = (np.random.RandomState(3).rand(B, 1, H, W) > 0.2).astype(np.float32)
    kw = dict(use_target_weight=True, skip_empty_channel=True, smoothing_weight=0.05,
              gaussian_weight=0.1, oks_type=oks_type, loss_weight=0.7)
    flags = dict(per_pixel=mode == "per_pixel", per_keypoint=mode == "per_keypoint")
    want = jhl.OKSHeatmapLoss(**kw)(jnp.asarray(out), jnp.asarray(tgt), jnp.asarray(w), jnp.asarray(mask), **flags)
    got = tl.OKSHeatmapLoss(**kw)(*map(torch.from_numpy, (out, tgt, w, mask)), **flags)
    close(got, want)


def test_sobel_taps_are_not_flipped():
    """A ramp rising along x: cross-correlation with [1, 0, -1] gives a
    negative x-gradient (a flipped kernel would give a positive one)."""
    ramp = np.tile(np.arange(W, dtype=np.float32), (1, 1, H, 1))
    got = tl.heatmap_loss._sobel_gradients(torch.from_numpy(ramp))
    close(got, jhl._sobel_gradients(jnp.asarray(ramp)))
    from probpose_code_torch.models.losses.heatmap_loss import _SOBEL_X

    assert _SOBEL_X[0] == (1.0, 0.0, -1.0)


@pytest.mark.parametrize("per_pixel", [False, True])
def test_keypoint_mse_loss(per_pixel):
    out, tgt, w = _maps(4, peaked=False), _maps(5), _weights(6)
    kw = dict(use_target_weight=True, skip_empty_channel=True, loss_weight=0.5)
    want = jhl.KeypointMSELoss(**kw)(jnp.asarray(out), jnp.asarray(tgt), jnp.asarray(w), per_pixel=per_pixel)
    got = tl.KeypointMSELoss(**kw)(*map(torch.from_numpy, (out, tgt, w)), per_pixel=per_pixel)
    close(got, want)


@pytest.mark.parametrize("use_sigmoid", [True, False])
@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_bce_loss(use_sigmoid, reduction):
    rng = np.random.RandomState(7)
    out = (rng.rand(B, K) if use_sigmoid else 4 * rng.randn(B, K)).astype(np.float32)
    out[0, 0], out[0, 1] = (0.0, 1.0) if use_sigmoid else (40.0, -40.0)  # the clip and the stable form
    tgt = (rng.rand(B, K) > 0.5).astype(np.float32)
    w = rng.rand(B, K).astype(np.float32)
    kw = dict(use_target_weight=True, use_sigmoid=use_sigmoid, reduction=reduction, loss_weight=2.0)
    want = jcls.BCELoss(**kw)(jnp.asarray(out), jnp.asarray(tgt), jnp.asarray(w))
    got = tl.BCELoss(**kw)(*map(torch.from_numpy, (out, tgt, w)))
    close(got, want)


@pytest.mark.parametrize("name", ["MSELoss", "L1LogLoss"])
def test_regression_losses(name):
    rng = np.random.RandomState(8)
    out = np.abs(rng.randn(B, K) * 3).astype(np.float32)
    tgt = np.abs(rng.randn(B, K) * 3).astype(np.float32)
    w = (rng.rand(B, K) > 0.4).astype(np.float32)
    for use_w in (True, False):
        want = getattr(jreg, name)(use_target_weight=use_w, loss_weight=1.5)(jnp.asarray(out), jnp.asarray(tgt), jnp.asarray(w))
        got = getattr(tl, name)(use_target_weight=use_w, loss_weight=1.5)(*map(torch.from_numpy, (out, tgt, w)))
        close(got, want)


def test_losses_are_registered():
    from probpose_code_torch.registry import MODELS

    for name in ("OKSHeatmapLoss", "KeypointMSELoss", "BCELoss", "MSELoss", "L1LogLoss"):
        assert name in MODELS


def test_gaussian_blur_batch():
    maps = _maps(9)
    close(thm.gaussian_blur_batch(torch.from_numpy(maps), 11), jhm.gaussian_blur_batch(jnp.asarray(maps), 11), atol=1e-5)


def test_heatmap_maximum_takes_the_first_of_a_tie():
    maps = _maps(10)
    maps[1, 4] = 0.0
    maps[1, 4, 10, 7] = maps[1, 4, 10, 9] = maps[1, 4, 30, 2] = 0.5  # a three-way tie
    maps[2, 5] = -1.0  # max <= 0: location -1
    got_l, got_v = thm.heatmap_maximum_batch(torch.from_numpy(maps))
    want_l, want_v = jhm.heatmap_maximum_batch(jnp.asarray(maps))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    close(got_v, want_v)
    assert got_l[1, 4].tolist() == [7.0, 10.0] and got_l[2, 5].tolist() == [-1.0, -1.0]


def test_argmax_probmap_decode_batch():
    """Noisy maps with a peak at least 3 px inside (as the JAX package's own
    test draws them, ``tests/test_ops/test_device_ops.py:30``: at the border
    the DARK Hessian is near-singular and amplifies the last bits of the
    blur), all-zero maps (location -1, whose taps wrap as
    ``take_along_axis`` wraps them) and a flat map (a singular Hessian,
    dropped by the pseudo-inverse). Bar: 1e-4 heatmap pixels."""
    rng = np.random.RandomState(11)
    maps = rng.rand(B, K, H, W).astype(np.float32) * 0.08
    yy, xx = np.mgrid[:H, :W]
    cy = rng.uniform(3, H - 4, (B, K, 1, 1))
    cx = rng.uniform(3, W - 4, (B, K, 1, 1))
    maps += np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 8.0).astype(np.float32)
    maps[0, :3] = 0.0
    maps[2, 6] = 0.25
    got_l, got_v = tdec.argmax_probmap_decode_batch(torch.from_numpy(maps))
    want_l, want_v = jdec.argmax_probmap_decode_batch(jnp.asarray(maps))
    close(got_l, want_l, rtol=0, atol=1e-4)
    close(got_v, want_v)


def test_gather_hw_reads_as_take_along_axis():
    maps = np.arange(2 * 3 * 4, dtype=np.float32).reshape(1, 2, 3, 4)
    x = np.array([[-1, 4]])
    y = np.array([[0, 2]])
    for xx, yy in ((x, y), (x - 20, y), (x, y + 5)):
        got = thm.gather_hw(torch.from_numpy(maps), torch.from_numpy(xx), torch.from_numpy(yy))
        want = jhm.gather_hw(jnp.asarray(maps), jnp.asarray(xx), jnp.asarray(yy))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_compute_oks_targets():
    rng = np.random.RandomState(12)
    gt = rng.uniform(0, 192, (B, K, 2)).astype(np.float32)
    dt = (gt + rng.randn(B, K, 2) * 4).astype(np.float32)
    weight = rng.rand(B, K) > 0.3
    weight[1] = False  # an instance with no valid keypoint
    got = ttd.compute_oks_targets(torch.from_numpy(gt), torch.from_numpy(dt), torch.from_numpy(weight))
    want = jtd.compute_oks_targets(jnp.asarray(gt), jnp.asarray(dt), jnp.asarray(weight))
    for g, w in zip(got, want):
        close(g, w)
    assert float(got[1][1]) == 0.0


def test_balanced_visibility_weights():
    rng = np.random.RandomState(13)
    annotated = (rng.rand(B, K) > 0.2).astype(np.float32)
    vis = ((rng.rand(B, K) > 0.5) * annotated).astype(np.float32)
    annotated_in = (annotated > 0.5) & (rng.rand(B, K) > 0.1)
    got = ttd._balanced_visibility_weights(*map(torch.from_numpy, (annotated_in, vis, annotated)))
    want = jtd._balanced_visibility_weights(*map(jnp.asarray, (annotated_in, vis, annotated)))
    close(got, want)
    none = np.zeros((B, K), np.float32)  # nothing annotated: no positive weight, min falls back to 1
    close(ttd._balanced_visibility_weights(torch.from_numpy(none > 0), torch.from_numpy(none), torch.from_numpy(none)),
          jtd._balanced_visibility_weights(jnp.asarray(none > 0), jnp.asarray(none), jnp.asarray(none)))


def test_monitors():
    dt, gt = _maps(14), _maps(15)
    gt[0, 5:9] = dt[0, 5:9]  # some exact hits
    mask = _weights(16) > 0.5
    close(ttd._pose_pck_accuracy(torch.from_numpy(dt), torch.from_numpy(gt), torch.from_numpy(mask)),
          jtd._pose_pck_accuracy(jnp.asarray(dt), jnp.asarray(gt), jnp.asarray(mask)))
    rng = np.random.RandomState(17)
    p = rng.rand(B, K).astype(np.float32)
    t = (rng.rand(B, K) > 0.5).astype(np.float32)
    for m in (mask, np.ones((B, K), bool), (t > 0.5)):  # the last has one class only
        close(ttd._balanced_binary_accuracy(*map(torch.from_numpy, (p, t, m))),
              jtd._balanced_binary_accuracy(*map(jnp.asarray, (p, t, m))))


def test_generate_probmaps_device():
    rng = np.random.RandomState(18)
    kpts = np.stack([rng.uniform(-5, W + 5, (B, K)), rng.uniform(-5, H + 5, (B, K))], -1).astype(np.float32)
    vis = rng.rand(B, K).astype(np.float32)
    for sigma in (-1.0, 2.0):
        scales = tenc.probmap_encode_scales(K, (W, H), sigma)
        np.testing.assert_array_equal(scales, jenc.probmap_encode_scales(K, (W, H), sigma))
        got = tenc.generate_probmaps_device(torch.from_numpy(kpts), torch.from_numpy(vis), (W, H), scales)
        want = jenc.generate_probmaps_device(jnp.asarray(kpts), jnp.asarray(vis), (W, H), scales)
        close(got, want)


def test_device_preprocess_batch_encodes_targets():
    """A batch with heatmap-space keypoints gets the maps the JAX builder
    makes; a batch that already has maps passes through."""
    from probpose_code_tpu.models import PoseModel as JaxPoseModel
    from tests.test_models.test_probpose_model import TINY_PROBPOSE_CFG

    rng = np.random.RandomState(19)
    kpts = rng.uniform(-5, 50, (2, K, 2)).astype(np.float32)
    vis = (rng.rand(2, K) > 0.3).astype(np.float32)
    want = JaxPoseModel(TINY_PROBPOSE_CFG).device_preprocess_batch(dict(kpts_hm=jnp.asarray(kpts), kpts_visible=jnp.asarray(vis)))
    model = PoseModel(TINY_PROBPOSE_CFG, device="cpu")
    got = model.device_preprocess_batch(dict(kpts_hm=torch.from_numpy(kpts), kpts_visible=torch.from_numpy(vis)))
    assert set(got) == set(want) == {"heatmaps"}
    close(got["heatmaps"], want["heatmaps"])
    batch = dict(heatmaps=torch.zeros(1))
    assert model.device_preprocess_batch(batch) is batch
    with pytest.raises(NotImplementedError):
        model.device_preprocess_batch(dict(canvas=torch.zeros(1)))
