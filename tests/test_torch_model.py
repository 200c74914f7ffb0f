"""The port's ViT + ProbMapHead against the JAX package's, on the same weights.

A small ProbPose (2 ViT layers of width 64, 4 heads, 32 tokens) is built by
both packages from one config. The JAX variables move to the port through
``state_dict_from_jax``; the same numpy input then goes through both.

Bars:
- f32: relative max error < 1e-5 on the backbone and atol 1e-5 on every head
  output; both compute in f32 and differ in summation order only (measured
  about 6e-7).
- bf16: relative max error < 3e-2 on the backbone, the JAX package's bar for
  bf16 layers (``tests/test_ops/test_vit_layer_fused.py:107``). The JAX CPU
  path is the eager block (max-shifted softmax, bf16 residual) while the
  port's auto path is K1's math (clamped exp, f32 x1), and bf16 keeps 8 bits,
  so the head outputs are held at atol 3e-2 after the bf16 deconvs and towers
  (measured at most 6.5e-3).
"""

import copy

import jax
import numpy as np
import pytest
import torch

from chip_smoke import GOLDEN, TINY_CFG
from probpose_code_torch.engine.checkpoint import load_checkpoint, state_dict_from_jax
from probpose_code_torch.models.builder import PoseModel
from probpose_code_tpu.engine.checkpoint import convert_torch_state_dict
from probpose_code_tpu.models import PoseModel as JaxPoseModel

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tier-1 runs six test workers at once: torch's default of one thread per
    core in each of them oversubscribes the CPU, so this module runs torch on
    one thread and restores the setting after it."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


CFG = dict(
    type="TopdownPoseEstimator",
    data_preprocessor=dict(
        type="PoseDataPreprocessor", mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375], bgr_to_rgb=True,
    ),
    backbone=dict(
        type="mmpretrain.VisionTransformer",
        arch=dict(embed_dims=64, num_layers=2, num_heads=4, feedforward_channels=128),
        img_size=(128, 64), patch_size=16, qkv_bias=True, drop_path_rate=0.1, with_cls_token=False,
        out_type="featmap", patch_cfg=dict(padding=2), init_cfg=None,
    ),
    head=dict(
        type="ProbMapHead", in_channels=64, out_channels=17, deconv_out_channels=(32, 32),
        deconv_kernel_sizes=(4, 4), keypoint_loss=dict(type="OKSHeatmapLoss", use_target_weight=True),
        normalize=1.0, freeze_error=True, freeze_oks=False,
        decoder=dict(type="ProbMap", input_size=(64, 128), heatmap_size=(16, 32), sigma=-1),
    ),
    test_cfg=dict(flip_test=True, flip_mode="heatmap", shift_heatmap=False),
)


def _cfg(dtype=None, fused_layers=None):
    cfg = copy.deepcopy(CFG)
    if dtype:
        cfg["backbone"].update(dtype=dtype, approximate_gelu=True)
        cfg["head"]["dtype"] = dtype
    if fused_layers is not None:
        cfg["backbone"]["fused_layers"] = fused_layers
    return cfg


def _randomize_stats(variables, seed):
    """Give the BN running stats non-trivial values so the move is tested."""
    rng = np.random.RandomState(seed)

    def fill(tree):
        return {
            k: fill(v) if isinstance(v, dict) else (
                np.abs(rng.randn(*v.shape)).astype(np.float32) + 0.5 if k == "var"
                else (0.1 * rng.randn(*v.shape)).astype(np.float32))
            for k, v in tree.items()
        }

    return {"params": jax.tree_util.tree_map(np.asarray, variables["params"]),
            "batch_stats": fill(jax.tree_util.tree_map(np.asarray, variables["batch_stats"]))}


@pytest.fixture(scope="module")
def variables():
    jm = JaxPoseModel(_cfg())
    return _randomize_stats(jm.init(seed=3), 4)


def _both(variables, dtype=None, fused_layers=None):
    jm = JaxPoseModel(_cfg(dtype))
    tm = PoseModel(_cfg(dtype, fused_layers), device="cpu")
    tm.module.load_state_dict(state_dict_from_jax(variables), strict=True)
    x = np.random.RandomState(5).randn(2, 128, 64, 3).astype(np.float32)
    jfeat = np.asarray(jm.module.apply(variables, x, method=lambda m, z: m.backbone(z)[-1]))
    jout = {k: np.asarray(v) for k, v in jm.module.apply(variables, x, train=False).items()}
    with torch.inference_mode():
        tx = torch.from_numpy(x)
        tfeat = tm.module.backbone(tx.permute(0, 3, 1, 2))[0].permute(0, 2, 3, 1).float().numpy()
        tout = {k: v.float().numpy() for k, v in tm.module(tx).items()}
    return jfeat, jout, tfeat, tout


@pytest.mark.parametrize("fused_layers", [None, False])
def test_f32_matches_flax(variables, fused_layers):
    jfeat, jout, tfeat, tout = _both(variables, fused_layers=fused_layers)
    assert tfeat.shape == jfeat.shape == (2, 8, 4, 64)
    assert np.abs(tfeat - jfeat).max() / np.abs(jfeat).max() < 1e-5
    assert set(tout) == set(jout)
    for k in jout:
        assert tout[k].shape == jout[k].shape, k
        np.testing.assert_allclose(tout[k], jout[k], atol=1e-5, err_msg=k)


@pytest.mark.parametrize("fused_layers", [None, False])
def test_bf16_matches_flax(variables, fused_layers):
    jfeat, jout, tfeat, tout = _both(variables, dtype="bfloat16", fused_layers=fused_layers)
    assert np.abs(tfeat - jfeat).max() / np.abs(jfeat).max() < 3e-2
    for k in jout:
        np.testing.assert_allclose(tout[k], jout[k], atol=3e-2, err_msg=k)


def test_state_dict_round_trip(variables):
    back = convert_torch_state_dict(state_dict_from_jax(variables), num_layers=2)
    flat_want = jax.tree_util.tree_flatten_with_path(variables)[0]
    flat_got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_got) == len(flat_want)
    for path, leaf in flat_want:
        np.testing.assert_array_equal(np.asarray(flat_got[path]), leaf, err_msg=str(path))


def test_golden_weights_load_strict():
    model = PoseModel(TINY_CFG["model"], device="cpu")
    load_checkpoint(model, str(GOLDEN / "e2e_weights.pth"))  # strict=True
    ref = torch.load(GOLDEN / "e2e_weights.pth", weights_only=True)
    got = model.module.state_dict()
    assert set(got) == set(ref)
    for k, v in ref.items():
        assert torch.equal(got[k], v), k


def test_init_weights_is_seeded():
    a, b, c = (PoseModel(_cfg(), device="cpu") for _ in range(3))
    a.init_weights(0)
    b.init_weights(0)
    c.init_weights(1)
    sa, sb, sc = (m.module.state_dict() for m in (a, b, c))
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["backbone.pos_embed"], sc["backbone.pos_embed"])


def test_predict_matches_jax(variables):
    """The whole predict program (flip-TTA on one doubled batch, decode to
    input space) against the JAX ``make_predict`` on the same uint8-valued
    crops. f32: keypoints atol 1e-3 input pixels, every other field atol
    1e-5; both sides compute in f32 and differ in summation order only."""
    meta = {"flip_indices": [0, 2, 1, 4, 3, 6, 5, 8, 7, 10, 9, 12, 11, 14, 13, 16, 15]}
    jm = JaxPoseModel(_cfg(), metainfo=meta)
    tm = PoseModel(_cfg(), metainfo=meta, device="cpu")
    tm.module.load_state_dict(state_dict_from_jax(variables), strict=True)
    crops = np.round(np.random.RandomState(6).rand(3, 128, 64, 3) * 255).astype(np.float32)
    want = {k: np.asarray(v) for k, v in jm.make_predict(jit=False)(variables, crops).items()}
    got = {k: v.numpy() for k, v in tm.predict(torch.from_numpy(crops)).items()}
    assert set(got) == set(want)
    np.testing.assert_allclose(got["keypoints"], want["keypoints"], atol=1e-3)
    for k in want:
        if k != "keypoints":
            np.testing.assert_allclose(got[k], want[k], atol=1e-5, err_msg=k)


def test_block_keeps_kernel_weights_until_they_change():
    """A block prepares K1's operands once, reuses them without autograd, and
    prepares them again after an in-place change; the layer's output is the
    one of freshly prepared weights (exact: same casts, same code)."""
    from probpose_code_torch.models.backbones.vit import TransformerBlock

    torch.manual_seed(7)
    block = TransformerBlock(64, 4, 128, dtype=torch.float32)
    x = torch.randn(2, 16, 64)
    with torch.no_grad():
        first = block.kernel_weights()
        assert block.kernel_weights() is first
        block.attn.qkv.weight.add_(0.5)
        second = block.kernel_weights()
        assert second is not first
        got = block(x)
    fresh = block.kernel_weights()  # autograd on: prepared anew, not kept
    assert fresh is not second and fresh[2].requires_grad
    for a, b in zip(second, fresh):
        assert torch.equal(a, b.detach())
    with torch.no_grad():
        block._prepared = None
        assert torch.equal(got, block(x))


def test_float16_is_rejected_when_built():
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        PoseModel(_cfg(dtype="float16"), device="cpu")
