"""The port's decode, TTA and crop ops against the JAX package's.

The plain twin of K2 (``probpose_code_torch.ops.decode``) runs against the
Pallas kernel ``heatmap_expected_value_pallas_fused`` in interpret mode and
against the XLA ``heatmap_expected_value_batch``, on peaked maps as the JAX
package's own test does (``tests/test_ops/test_pallas_decode.py:44-64``:
locs atol 1e-3, vals atol 1e-5; conv-only atol 1e-4), and against the
golden ``decode.npz``. ``flip_heatmaps`` and ``warp_affine_batch`` are held
to their JAX counterparts on the same inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from chip_smoke import peaked_heatmaps
from probpose_code_torch.ops import decode as tdecode
from probpose_code_torch.ops.heatmap import gather_hw
from probpose_code_torch.ops.kernels.expected_oks import expected_oks_decode, oks_convolve
from probpose_code_torch.ops.tta import flip_heatmaps
from probpose_code_torch.ops.warp import invert_affine, warp_affine_batch
from probpose_code_tpu.ops import decode as jdecode
from probpose_code_tpu.ops import heatmap as jheatmap
from probpose_code_tpu.ops import tta as jtta
from probpose_code_tpu.ops import warp as jwarp
from probpose_code_tpu.ops.pallas.expected_oks import (
    heatmap_expected_value_pallas_fused,
    oks_convolve_pallas,
)

LOCS_ATOL, VALS_ATOL, CONV_ATOL = 1e-3, 1e-5, 1e-4


def peaked(B=4, K=17, H=64, W=48, seed=1):
    return peaked_heatmaps(B, K, H, W, seed)


def test_plain_decode_matches_pallas_fused_and_xla():
    hm = peaked()
    with pltpu.force_tpu_interpret_mode():
        locs_p, vals_p = heatmap_expected_value_pallas_fused(jnp.asarray(hm))
    locs_x, vals_x = jdecode.heatmap_expected_value_batch(jnp.asarray(hm))
    locs, vals = tdecode.heatmap_expected_value_batch(torch.from_numpy(hm))
    for want_l, want_v in ((locs_p, vals_p), (locs_x, vals_x)):
        np.testing.assert_allclose(locs.numpy(), np.asarray(want_l), atol=LOCS_ATOL)
        np.testing.assert_allclose(vals.numpy(), np.asarray(want_v), atol=VALS_ATOL)


def test_plain_conv_matches_pallas_conv():
    hm = np.clip(np.random.RandomState(0).rand(2, 17, 64, 48), 0, 1).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(oks_convolve_pallas(jnp.asarray(hm)))
    np.testing.assert_allclose(tdecode.oks_convolve_plain(torch.from_numpy(hm)).numpy(), want, atol=CONV_ATOL)
    # the conv-only wrapper takes a CPU tensor to the same plain twin
    np.testing.assert_array_equal(oks_convolve(torch.from_numpy(hm)).numpy(),
                                  tdecode.oks_convolve_plain(torch.from_numpy(hm)).numpy())


def test_filter_taps_are_the_operator_band():
    Ay, Ax, R = tdecode.oks_separable_bank(17, 64, 48)
    taps = tdecode.oks_filter_taps(17, 64, 48)
    assert taps.shape == (17, 2 * R + 1) and R == 9
    for i in (0, 10, 63):
        np.testing.assert_array_equal(Ay[:, i, i:i + 2 * R + 1], taps)
    for i in (0, 47):
        np.testing.assert_array_equal(Ax[:, i, i:i + 2 * R + 1], taps)


def test_golden_expected_value(golden):
    g = golden("decode")
    locs, vals = tdecode.heatmap_expected_value_batch(torch.from_numpy(g["heatmaps"][None].copy()))
    np.testing.assert_allclose(locs[0].numpy(), g["locs_exp"], atol=1e-4)
    np.testing.assert_allclose(vals[0].numpy(), g["vals_exp"], atol=1e-6)


def test_decode_to_input_space_matches_jax():
    hm = peaked(B=3, seed=7)
    want_l, want_v = jdecode.expected_oks_decode_to_input_space(jnp.asarray(hm), (192, 256))
    got_l, got_v = expected_oks_decode(torch.from_numpy(hm), (192, 256))  # CPU -> plain twin
    scale = np.array([192 / 47, 256 / 63], np.float32)
    np.testing.assert_allclose(got_l.numpy() / scale, np.asarray(want_l) / scale, atol=LOCS_ATOL)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), atol=VALS_ATOL)


def test_subpixel_and_gather_match_jax():
    rng = np.random.RandomState(3)
    maps = rng.rand(2, 5, 16, 12).astype(np.float32)
    locs = np.stack([rng.randint(0, 12, (2, 5)), rng.randint(0, 16, (2, 5))], -1).astype(np.float32)
    want = jdecode.subpixel_refine_batch(jnp.asarray(maps), jnp.asarray(locs))
    got = tdecode.subpixel_refine_batch(torch.from_numpy(maps), torch.from_numpy(locs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    x, y = locs[..., 0].astype(np.int32), locs[..., 1].astype(np.int32)
    np.testing.assert_array_equal(
        gather_hw(torch.from_numpy(maps), torch.from_numpy(x), torch.from_numpy(y)).numpy(),
        np.asarray(jheatmap.gather_hw(jnp.asarray(maps), jnp.asarray(x), jnp.asarray(y))),
    )


def test_symmetric_pad_matches_numpy():
    a = np.arange(2 * 3 * 7 * 5, dtype=np.float32).reshape(2, 3, 7, 5)
    want = np.pad(a, ((0, 0), (0, 0), (4, 4), (4, 4)), mode="symmetric")
    np.testing.assert_array_equal(tdecode.symmetric_pad(torch.from_numpy(a), 4).numpy(), want)


@pytest.mark.parametrize("shift", [False, True])
def test_flip_heatmaps_matches_jax(shift):
    hm = np.random.RandomState(4).rand(2, 17, 8, 6).astype(np.float32)
    fi = [0, 2, 1, 4, 3, 6, 5, 8, 7, 10, 9, 12, 11, 14, 13, 16, 15]
    want = jtta.flip_heatmaps(jnp.asarray(hm), flip_indices=fi, flip_mode="heatmap", shift_heatmap=shift)
    got = flip_heatmaps(torch.from_numpy(hm), flip_indices=fi, shift_heatmap=shift)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _mats(n, seed):
    rng = np.random.RandomState(seed)
    from probpose_code_torch.structures.bbox import get_udp_warp_matrix

    return np.stack([
        get_udp_warp_matrix(rng.uniform(40, 80, 2), rng.uniform(30, 120, 2), rng.uniform(-30, 30), (24, 32))
        for _ in range(n)
    ])


def test_warp_affine_batch_matches_jax():
    rng = np.random.RandomState(5)
    imgs = (rng.rand(3, 90, 110, 3) * 255).astype(np.float32)
    mats = _mats(3, 6)
    want = jwarp.warp_affine_batch(jnp.asarray(imgs), jnp.asarray(mats), (24, 32))
    got = warp_affine_batch(torch.from_numpy(imgs), torch.from_numpy(mats), (24, 32))
    # same float formula; 1e-3 of 255 covers reassociation in the bilinear blend
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3)
    np.testing.assert_allclose(
        invert_affine(torch.from_numpy(mats)).numpy(), np.asarray(jwarp.invert_affine(jnp.asarray(mats))), rtol=1e-6
    )
    # one image shared by every crop, as inference_topdown cuts them
    shared = warp_affine_batch(torch.from_numpy(imgs[:1]), torch.from_numpy(mats), (24, 32))
    want_shared = jwarp.warp_affine_batch(jnp.asarray(np.repeat(imgs[:1], 3, 0)), jnp.asarray(mats), (24, 32))
    np.testing.assert_allclose(shared.numpy(), np.asarray(want_shared), atol=1e-3)


def test_device_crop_matches_cv2_crop():
    """The port's crop (float warp, rounded to uint8 values) lands within one
    intensity unit of the JAX host pipeline's cv2.warpAffine crop, the bar of
    ``tests/test_datasets/test_device_pipeline.py:62-67``."""
    from probpose_code_torch.apis import crop_batch
    from probpose_code_tpu.datasets import Compose

    rng = np.random.RandomState(8)
    img = (rng.rand(300, 400, 3) * 255).astype(np.uint8)
    boxes = np.array([[40.0, 30.0, 330.0, 280.0], [150.5, 20.25, 220.0, 290.0]], np.float32)
    pipe = Compose([
        dict(type="GetBBoxCenterScale"),
        dict(type="TopdownAffine", input_size=(192, 256), use_udp=True, input_padding=1.25),
        dict(type="PackPoseInputs"),
    ])
    want = []
    for b in boxes:
        out = pipe(dict(img=img.copy(), img_shape=(300, 400), ori_shape=(300, 400), bbox=b[None],
                        bbox_score=np.ones(1, np.float32), id=0, img_id=0))
        want.append(np.asarray(out["inputs"], np.float32))
        meta = out["data_samples"].metainfo
    crops, centers, scales = crop_batch(img, boxes, (192, 256), "cpu")
    assert np.abs(crops.numpy() - np.stack(want)).max() <= 1.0
    np.testing.assert_allclose(centers[-1], meta["input_center"], rtol=1e-6)
    np.testing.assert_allclose(scales[-1], meta["input_scale"], rtol=1e-6)
