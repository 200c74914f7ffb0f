"""SwinTransformer, HRFormer and PVT / PVTv2 on the CPU: the port against the JAX package on the same weights and inputs.

The weights are the JAX module's variables drawn by NumPy from a seed
(``tests/test_torch_cnn_backbones.py:jax_variables``), carried to the port by
``state_dict_from_jax`` (a module alone: by its family's rules, placed where
a backbone holds it) and loaded with ``strict=True``; the inputs are drawn by
NumPy and fed to both. The JAX side runs jitted. The models are narrow
(widths 8-128, one or two blocks a stage).

Swin and PVT are held at sides that are multiples of 32, where their strided
convs (the patch embeds and the spatial reductions, kernel = stride) pad
nothing in either package, and PVTv2's overlapping embeds pad explicitly in
both. At a side that is no multiple of 4 the JAX Swin's "SAME" patch embed
pads and the port's (mmpose's) does not (``test_strided_padding_departs``).
HRFormer's strided 3x3 convs pad 1 on each side here, as mmpose's, and (0, 1)
in JAX at an even side: it is held at 65 x 97, where every strided input is
odd (five strided convs deep) and the two agree, and at an even side with JAX's padding put in front of
the port's strided convs here in the test (``chip_smoke.jax_same_strided``).

Bars, with their reasons (``tests/test_torch_cnn_backbones.py``'s): features
and heatmaps within 1e-5 of the JAX output's largest value (f32 on both
sides, summation order); MSRA keypoints 1e-3 heatmap pixels and scores 1e-5;
in training mode, in f64 on both sides (HRFormer's BatchNorms), the loss
within 1e-5 relative, each parameter's gradient within 1e-5 of its own l2
norm and the running statistics within 1e-5 of their largest value.
"""

import re
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import TOPDOWN_REST_FIXTURES, jax_same_strided, model_fixture_report
from probpose_code_torch.apis import inference_topdown, init_model
from probpose_code_torch.apis.inference import crop_batch
from probpose_code_torch.config import Config
from probpose_code_torch.engine import checkpoint
from probpose_code_torch.engine.checkpoint import state_dict_from_jax
from probpose_code_torch.engine.optim import build_optimizer
from probpose_code_torch.models.backbones import transformers as tt
from probpose_code_torch.models.builder import PoseModel
from probpose_code_tpu.models import PoseModel as JaxPoseModel
from probpose_code_tpu.models.backbones import nas_and_3d as jn
from probpose_code_tpu.models.backbones import transformers as jt
from tests.test_torch_cnn_backbones import _np, jax_run, jax_variables, port_in_float64
from tests.test_torch_litehrnet import draw

ROOT = Path(__file__).resolve().parents[1]
META = {"flip_indices": [0, 2, 1, 4, 3, 6, 5, 8, 7, 10, 9, 12, 11, 14, 13, 16, 15], "num_keypoints": 17}
REL = 1e-5
FAMILIES = ("SwinTransformer", "HRFormer", "PyramidVisionTransformer", "PyramidVisionTransformerV2")
FAMILY_CONFIGS = sorted(str(p.relative_to(ROOT)) for p in (ROOT / "configs").rglob("*.py")
                        if re.search(r"backbone=dict\(\s*type=[\"'](%s)[\"']" % "|".join(FAMILIES), p.read_text()))
SWIN_T = "configs/body_2d_keypoint/topdown_heatmap/coco/td-hm_swin-t-p4-w7_8xb32-210e_coco-256x192.py"
PVT_S = "configs/body_2d_keypoint/topdown_heatmap/coco/td-hm_pvt-s_8xb64-210e_coco-256x192.py"

# the narrow backbones: (the JAX module's config, the input side (H, W)); Swin at 64 x 96 has windows of 7 with
# padding and the shift mask (16 x 24), of 4 with a shift of 3 (4 x 6) and of 2 without a shift (2 x 3)
BACKBONES = {
    "swin": (dict(type="SwinTransformer", embed_dims=16, depths=(2, 2, 2, 2), num_heads=(1, 2, 2, 4),
                  out_indices=(0, 1, 2, 3)), (64, 96)),
    "hrformer": (dict(type="HRFormer", base_channels=8, depths=(1, 1, 1), multiscale_output=True), (65, 97)),
    "pvt": (dict(type="PyramidVisionTransformer", embed_dims=(16, 32, 40, 64), num_layers=(1, 1, 2, 1),
                 num_heads=(1, 2, 5, 8)), (64, 96)),
    "pvtv2": (dict(type="PyramidVisionTransformerV2", embed_dims=8, num_layers=(1, 1, 2, 1)), (64, 96)),
}
JAX_BACKBONES = dict(SwinTransformer=jt.SwinTransformer, HRFormer=jn.HRFormer,
                     PyramidVisionTransformer=jt.PyramidVisionTransformer,
                     PyramidVisionTransformerV2=jt.PyramidVisionTransformerV2)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tier-1 runs six test workers at once; one torch thread each."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def jax_backbone(name, **kw):
    cfg, side = BACKBONES[name]
    cfg = dict(cfg, **kw)
    return JAX_BACKBONES[cfg["type"]](**{k: v for k, v in cfg.items() if k != "type"}), side


def port_backbone(name, variables, side=None, **kw):
    cfg, built_side = BACKBONES[name]
    cfg = dict(cfg, **kw)
    ours = getattr(tt, cfg.pop("type"))(img_size=side or built_side, **cfg)
    sd = state_dict_from_jax({"params": {"backbone": _np(variables["params"]), "head": {}},
                              "batch_stats": {"backbone": _np(variables.get("batch_stats", {}))}})
    ours.load_state_dict({k.removeprefix("backbone."): v for k, v in sd.items()}, strict=True)
    return ours.eval()


def carried(rules, variables, path, prefix):
    """The port's state dict of a JAX sub-module's ``variables``, placed at
    ``path`` in its backbone's tree and carried by the family's ``rules``,
    under the port's names after ``prefix``."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    for part in reversed(path.split("/")):
        params, stats = {part: params}, {part: stats}
    sd = {}
    checkpoint._cnn_from_jax(sd, _np(params), _np(stats), rules(params), dense="linear",
                             leaf_names=checkpoint._LAYER_NORM)
    return {k.removeprefix(f"backbone.{prefix}"): torch.from_numpy(np.array(v)) for k, v in sd.items()}


def nchw(a):
    return np.transpose(np.asarray(a), (0, 3, 1, 2))


def assert_close(got, want):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    assert np.abs(got.detach().numpy() - want).max() < REL * np.abs(want).max()


def _randn(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def module_variables(module, seed, shape, *args):
    """The variables of the flax ``module`` called on a zero input of
    ``shape`` (and ``args``), drawn from ``seed`` (``draw``)."""
    return draw(jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), jnp.zeros(shape), *args)), seed)


# -- each module ---------------------------------------------------------------------------


def test_window_partition_and_reverse_match_jax():
    """The windows of a (2, 14, 21, 3) map, row-major, and back."""
    x = _randn(1, 2, 14, 21, 3)
    wins = tt.window_partition(torch.from_numpy(x), 7)
    np.testing.assert_array_equal(wins.numpy(), np.asarray(jt.window_partition(jnp.asarray(x), 7)))
    np.testing.assert_array_equal(tt.window_reverse(wins, 7, 14, 21).numpy(), x)


def test_mlp_matches_jax():
    """``Mlp`` (fc1, exact GELU, fc2) on (2, 5, 16) tokens: ``transformers.mlp``."""
    x = _randn(2, 2, 5, 16)
    jm = jt.Mlp(64, 16)
    variables = module_variables(jm, 3, x.shape)
    ffn = tt.FFN(16, 64)
    ffn.load_state_dict(carried(checkpoint._swin_rules, variables, "stage0_block0/mlp", "stages.0.blocks.0.ffn."),
                        strict=True)
    with torch.no_grad():
        assert_close(tt.mlp(ffn, torch.from_numpy(x), torch.float32), jax.jit(jm.apply)(variables, x))


def jax_apply(module, variables, *args):
    return jax_run(lambda v, *a: module.apply(v, *a), variables, *args)


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "shift_mask"])
def test_window_attention_matches_jax(masked):
    """``WindowAttention`` (16 channels, two heads, windows of 4): the
    relative position bias from its table, with and without the shifted
    windows' mask (two images of four windows each)."""
    ws, C = 4, 16
    x = _randn(4, 8, ws * ws, C)
    mask = tt.shift_mask(8, 8, ws, 2) if masked else None
    jm = jt.WindowAttention(C, 2, ws)
    variables = module_variables(jm, 5, x.shape)
    ours = tt.WindowMSA(C, 2, ws)
    ours.load_state_dict(carried(checkpoint._swin_rules, variables, "stage0_block0/attn",
                                 "stages.0.blocks.0.attn.w_msa."), strict=True)
    want = jax_run(lambda v, x, m: jm.apply(v, x, m), variables, x, mask) if masked else jax_apply(jm, variables, x)
    with torch.no_grad():
        got = ours(torch.from_numpy(x), torch.from_numpy(mask) if masked else None, torch.float32)
    assert_close(got, want)


@pytest.mark.parametrize("hw,shift", [((10, 13), 3), ((6, 4), 2), ((7, 7), 3)],
                         ids=["padded_shifted", "window_covers_shifted", "window_fits"])
def test_swin_block_matches_jax(hw, shift):
    """``SwinBlock`` (window 7, 16 channels): padded to whole windows and
    shifted; the window shrunk to the map's side (4) with a shift under it;
    the window the map itself."""
    x = _randn(6, 2, *hw, 16)
    jm = jt.SwinBlock(16, 2, 7, shift=shift)
    variables = module_variables(jm, 7, x.shape)
    ours = tt.SwinBlock(16, 2, 7, shift, 4.0, hw).eval()
    ours.load_state_dict(carried(checkpoint._swin_rules, variables, "stage0_block0", "stages.0.blocks.0."),
                         strict=True)
    assert ours.ws == min(7, *hw)
    with torch.no_grad():
        assert_close(ours(torch.from_numpy(x), torch.float32), jax.jit(jm.apply)(variables, x))


def test_hrformer_block_matches_jax():
    """``HRFormerBlock`` (16 channels, two heads) on a 9 x 11 map: padded to
    whole windows, the conv FFN with its depthwise conv's bias."""
    x = _randn(8, 2, 9, 11, 16)
    jm = jn.HRFormerBlock(16, 2)
    variables = module_variables(jm, 9, x.shape)
    ours = tt.HRFormerBlock(16, 2, 7, (9, 11)).eval()
    ours.load_state_dict(carried(checkpoint._hrformer_rules, variables, "s0_m0_br0_blk0",
                                 "stage2.0.branches.0.0."), strict=True)
    with torch.no_grad():
        assert_close(ours(torch.from_numpy(x), torch.float32), jax.jit(jm.apply)(variables, x))


@pytest.mark.parametrize("sr", [1, 2])
def test_sr_attention_matches_jax(sr):
    """``SRAttention`` (40 channels, five heads) over an 8 x 6 grid, keys and
    values from the grid itself or reduced by a stride-2 conv and its
    LayerNorm."""
    x = _randn(10, 2, 48, 40)
    jm = jt.SRAttention(40, 5, sr)
    variables = module_variables(jm, 11, x.shape, (8, 6))
    ours = tt.SRAttention(40, 5, sr).eval()
    sd = {}
    checkpoint._pvt_from_jax(sd, {"s0_b0_attn": _np(variables["params"])})
    ours.load_state_dict({k.removeprefix("backbone.layers.0.1.0.attn."): torch.from_numpy(np.array(v))
                          for k, v in sd.items()}, strict=True)
    want = jax.jit(lambda v, x: jm.apply(v, x, (8, 6)))(variables, x)
    with torch.no_grad():
        assert_close(ours(torch.from_numpy(x), (8, 6), torch.float32), want)


@pytest.mark.parametrize("use_conv", [False, True], ids=["pvt", "pvtv2"])
def test_mix_ffn_matches_jax(use_conv):
    """``MixFFN`` (16 -> 64 -> 16) over a 6 x 8 grid, with and without its
    depthwise 3x3 conv (with a bias)."""
    x = _randn(12, 2, 48, 16)
    jm = jt.MixFFN(64, 16, use_conv=use_conv)
    variables = module_variables(jm, 13, x.shape, (6, 8))
    ours = tt.MixFFN(16, 64, use_conv).eval()
    sd = {}
    checkpoint._pvt_from_jax(sd, {"s0_b0_mlp": _np(variables["params"])})
    ours.load_state_dict({k.removeprefix("backbone.layers.0.1.0.ffn."): torch.from_numpy(np.array(v))
                          for k, v in sd.items()}, strict=True)
    want = jax.jit(lambda v, x: jm.apply(v, x, (6, 8)))(variables, x)
    with torch.no_grad():
        assert_close(ours(torch.from_numpy(x), (6, 8), torch.float32), want)


# -- the backbones ------------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(BACKBONES))
def test_backbone_matches_jax(name):
    """Each backbone's every output (Swin's and PVT's four stages, HRFormer's
    four branches) on two inputs."""
    jm, side = jax_backbone(name)
    x = _randn(14, 2, *side, 3)
    variables = jax_variables(jm, x.shape, 15)
    ours = port_backbone(name, variables)
    want = jax_run(lambda v, x: jm.apply(v, x, train=False), variables, x)
    with torch.no_grad():
        got = ours(torch.from_numpy(nchw(x)))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert_close(g, nchw(w))


@pytest.mark.parametrize("name", list(BACKBONES))
def test_training_step_matches_jax(name):
    """One training step of two inputs with ``sum_i mean(w_i * out_i ** 2)``
    over the backbone's outputs as the loss (``w_i`` drawn from a seed), in f64
    on both sides (HRFormer's BatchNorms in training mode): the loss, every
    parameter's gradient and the running statistics."""
    jm, side = jax_backbone(name, dtype=jnp.float64)
    x = (0.5 * np.random.RandomState(16).randn(2, *side, 3)).astype(np.float64)
    with jax.enable_x64(True), port_in_float64():
        drawn = jax_variables(jm, x.shape, 17)  # f32 values, exact in f64
        variables = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), drawn)
        ours = port_backbone(name, drawn)
        ours.double().train()
        ours.dtype = torch.float64
        shapes = [o.shape for o in jax.eval_shape(lambda v: jm.apply(v, x, train=False), variables)]
        ws = [np.random.RandomState(18 + i).uniform(0.5, 1.5, s) for i, s in enumerate(shapes)]

        def jax_loss(params):
            outs, new = jm.apply({"params": params, "batch_stats": variables.get("batch_stats", {})}, x, train=True,
                                 mutable=["batch_stats"])
            return sum(jnp.mean(w * o ** 2) for w, o in zip(ws, outs)), new

        (loss, new), grads = jax_run(jax.value_and_grad(jax_loss, has_aux=True), variables["params"])
        outs = ours(torch.from_numpy(nchw(x)))
        ours_loss = sum((torch.from_numpy(nchw(w)) * o ** 2).mean() for w, o in zip(ws, outs))
        ours_loss.backward()
        want = state_dict_from_jax({"params": {"backbone": _np(grads), "head": {}},
                                    "batch_stats": {"backbone": _np(new.get("batch_stats", {}))}})
    assert outs[-1].dtype == torch.float64
    assert float(ours_loss.detach()) == pytest.approx(float(loss), rel=1e-5)
    for key, p in ours.named_parameters():
        w = want[f"backbone.{key}"].numpy()
        assert np.linalg.norm(p.grad.numpy() - w) <= 1e-5 * np.linalg.norm(w), key
    for key, buf in ours.named_buffers():
        if key.endswith(("running_mean", "running_var")):
            w = want[f"backbone.{key}"].numpy()
            assert np.abs(buf.numpy() - w).max() <= 1e-5 * np.abs(w).max(), key


# -- sizes, padding ----------------------------------------------------------------------------


def test_sizes_set_by_the_input():
    """Swin-T's relative position tables and PVT-S's ``pos_embed``s, built by
    ``init_model`` from the configs (the codec's input size) and at 384 x 288,
    against the JAX modules' parameters at those inputs (``jax.eval_shape``):
    at 256 x 192 Swin-T's stage 4 (8 x 6) has windows of 6 and 121 rows, at
    384 x 288 (12 x 9) 169; PVT-S's first ``pos_embed`` is (1, 3072, 64) and
    its last (1, 48, 512) at 256 x 192."""
    for config, module in ((SWIN_T, jt.SwinTransformer(depths=(2, 2, 6, 2))), (PVT_S, jt.PyramidVisionTransformer())):
        cfg = Config.fromfile(str(ROOT / config))
        built = init_model(cfg, device="cpu").module.backbone
        for side in ((256, 192), (384, 288)):
            if side == (256, 192):
                ours = built
            else:
                kw = {k: v for k, v in cfg["model"]["backbone"].items() if k != "type"}
                ours = type(built)(img_size=side, **kw)
            shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), jnp.zeros((1, *side, 3))))["params"]
            if isinstance(ours, tt.SwinTransformer):
                got = [b.attn.w_msa.relative_position_bias_table.shape[0] for s in ours.stages for b in s.blocks]
                want = [shapes[f"stage{i}_block{b}"]["attn"]["relative_position_bias_table"].shape[0]
                        for i, d in enumerate((2, 2, 6, 2)) for b in range(d)]
                assert got == want
                assert got[-1] == (121 if side == (256, 192) else 169) and got[0] == 169
            else:
                got = [tuple(layer[1][0].pos_embed.shape) for layer in ours.layers]
                assert got == [tuple(shapes[f"pos_embed{i}"].shape) for i in range(4)]
                if side == (256, 192):
                    assert got[0] == (1, 3072, 64) and got[-1] == (1, 48, 512)


@pytest.mark.parametrize("name", list(BACKBONES))
def test_refuses_an_input_size_it_was_not_built_for(name):
    """A backbone built for one input size refuses another with a
    ``ValueError`` that names both; it does not interpolate."""
    cfg, side = BACKBONES[name]
    ours = getattr(tt, cfg["type"])(img_size=side, **{k: v for k, v in cfg.items() if k != "type"})
    with pytest.raises(ValueError, match=r"built for inputs of \(%d, %d\)" % side):
        ours(torch.zeros(1, 3, side[0] + 32, side[1]))


def test_strided_padding_departs():
    """HRFormer at an even side (64 x 64): the port's strided 3x3 convs pad (1,
    1), the JAX "SAME" (0, 1): the outputs differ by far more than the bar,
    and agree with JAX's padding put in front of the port's convs
    (``jax_same_strided``). Swin at a width that is no multiple of 4 (98): the
    JAX "SAME" patch embed pads and the port's does not, and the grids
    differ."""
    jm, _ = jax_backbone("hrformer")
    x = _randn(19, 2, 64, 64, 3)
    variables = jax_variables(jm, x.shape, 20)
    ours = port_backbone("hrformer", variables, side=(64, 64))
    want = nchw(jax_run(lambda v, x: jm.apply(v, x, train=False), variables, x)[0])
    with torch.no_grad():
        plain = ours(torch.from_numpy(nchw(x)))[0].numpy()
        with jax_same_strided():
            same = ours(torch.from_numpy(nchw(x)))[0]
    assert plain.shape == want.shape
    assert np.abs(plain - want).max() > 1e-2 * np.abs(want).max()
    assert_close(same, want)

    swin, _ = jax_backbone("swin", out_indices=(0,))
    shapes = jax.eval_shape(lambda: swin.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 98, 3))))
    want_grid = jax.eval_shape(lambda v: swin.apply(v, jnp.zeros((1, 64, 98, 3))), shapes)[0].shape[1:3]
    ours = tt.SwinTransformer(16, (2, 2, 2, 2), (1, 2, 2, 4), out_indices=(0,), img_size=(64, 98))
    with torch.no_grad():
        got_grid = ours(torch.zeros(1, 3, 64, 98))[0].shape[2:]
    assert tuple(want_grid) == (16, 25) and tuple(got_grid) == (16, 24)


# -- the estimators through init_model -> inference_topdown -----------------------------------------


_HEADS = dict(swin=(128, (16, 16, 16), (64, 96), (24, 16)), hrformer=(8, None, (97, 65), (25, 17)),
              pvtv2=(64, (16, 16, 16), (64, 96), (24, 16)))


@pytest.mark.parametrize("name", list(_HEADS))
def test_inference_topdown_matches_jax(name):
    """A narrow model of each family (PVTv2 for PVT's: the same module with
    the conv FFN) with a HeatmapHead (MSRA) through ``init_model`` with a
    weights file and ``inference_topdown`` on two boxes of an image
    (flip-TTA): the keypoints in the image and their scores against the JAX
    predict program on the same crops, mapped as ``attach_predictions`` maps
    them; and ``PoseModel.predict``'s heatmaps on those crops."""
    in_channels, deconv, (w, h), heatmap = _HEADS[name]
    backbone = dict(BACKBONES[name][0])
    backbone["out_indices" if name != "hrformer" else "multiscale_output"] = (3,) if name != "hrformer" else False
    cfg = dict(type="TopdownPoseEstimator", data_preprocessor=dict(
        type="PoseDataPreprocessor", mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375], bgr_to_rgb=True),
        backbone=backbone, head=dict(type="HeatmapHead", in_channels=in_channels, out_channels=17,
                                     deconv_out_channels=deconv, deconv_kernel_sizes=(4,) * len(deconv or ()),
                                     loss=dict(type="KeypointMSELoss", use_target_weight=True),
                                     decoder=dict(type="MSRAHeatmap", input_size=(w, h), heatmap_size=heatmap,
                                                  sigma=2)),
        test_cfg=dict(flip_test=True))
    jm = JaxPoseModel(cfg, metainfo=META)
    variables = jax_variables(jm.module, (1, h, w, 3), 21)
    full = dict(model=cfg, test_dataloader=dict(dataset=dict(pipeline=[
        dict(type="LoadImage"), dict(type="GetBBoxCenterScale"), dict(type="TopdownAffine", input_size=(w, h)),
        dict(type="PackPoseInputs")])))
    img = np.round(np.random.RandomState(22).rand(160, 130, 3) * 255).astype(np.uint8)
    boxes = np.array([[10, 5, 120, 150], [0, 20, 70, 100]], np.float32)
    ours = PoseModel(cfg, metainfo=META, device="cpu")
    ours.module.load_state_dict(state_dict_from_jax(_np(variables)), strict=True)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp, f"{name}.pth")
        torch.save(ours.module.state_dict(), path)
        model = init_model(Config(full), checkpoint=str(path), device="cpu")
    samples = inference_topdown(model, img, boxes)
    crops, centers, scales = crop_batch(img, boxes, (w, h), "cpu", model.cfg_full)
    ref = {k: np.asarray(v) for k, v in jax_run(jm.make_predict(jit=False), variables, crops.numpy()).items()}
    assert_close(model.predict(crops)["heatmaps"], ref["heatmaps"])
    want = ref["keypoints"] / np.float32([w, h]) * scales[:, None] + centers[:, None] - 0.5 * scales[:, None]
    got = np.stack([s.pred_instances.keypoints[0] for s in samples])
    np.testing.assert_allclose(got, want, atol=1e-3 * float(scales.max()) / heatmap[0])
    np.testing.assert_allclose(np.stack([s.pred_instances.keypoint_scores[0] for s in samples]),
                               ref["keypoint_scores"], atol=1e-5)


@pytest.mark.slow
@pytest.mark.parametrize("config", [SWIN_T, PVT_S, "configs/body_2d_keypoint/topdown_heatmap/coco/"
                                    "td-hm_hrformer-small_8xb32-210e_coco-256x192.py"], ids=["swin_t", "pvt_s",
                                                                                        "hrformer_small"])
def test_backbone_at_full_geometry_matches_jax(config):
    """Swin-T, PVT-S and HRFormer-small at their configs' width and depth, 256
    x 192 (HRFormer with JAX's stride-2 padding substituted), against the
    jitted JAX module on one input: a minute or more here."""
    cfg = Config.fromfile(str(ROOT / config))["model"]["backbone"]
    kw = {k: v for k, v in cfg.items() if k != "type"}
    jm = JAX_BACKBONES[cfg["type"]](**kw)
    x = _randn(33, 1, 256, 192, 3)
    variables = jax_variables(jm, x.shape, 34)
    ours = getattr(tt, cfg["type"])(img_size=(256, 192), **kw).eval()
    sd = state_dict_from_jax({"params": {"backbone": _np(variables["params"]), "head": {}},
                              "batch_stats": {"backbone": _np(variables.get("batch_stats", {}))}})
    ours.load_state_dict({k.removeprefix("backbone."): v for k, v in sd.items()}, strict=True)
    want = jax_run(lambda v, x: jm.apply(v, x, train=False), variables, x)
    with torch.no_grad(), jax_same_strided():
        got = ours(torch.from_numpy(nchw(x)))
    for g, w in zip(got, want):
        assert_close(g, nchw(w))


@pytest.mark.parametrize("name", ["swin", "hrformer", "pvtv2"])
def test_fixture_through_inference_topdown_and_coco_metric(name):
    """``chip_smoke.model_fixture_report``, the card's ``topdown_rest_golden``
    check, on the CPU for the Swin, HRFormer (257 x 193) and PVTv2 fixtures:
    ``init_model`` with the fixture's weights, ``inference_topdown`` over the
    62 golden persons, ``CocoMetric``; the maps of the fixture's crops
    against the JAX package's."""
    report = model_fixture_report(next(f for f in TOPDOWN_REST_FIXTURES if f["name"] == name), device="cpu")
    assert report["instances"] == 62 and report["p99"] < 1.0 and report["scores"] < 2e-3, report
    assert report["outputs_rel"] < 1e-4 and report["ok"], report


# -- every shipped config ------------------------------------------------------------------------


def test_the_family_count():
    """12 shipped configs run these backbones, all COCO 256 x 192 or 384 x 288:
    six Swin (T, S, B and L), four HRFormer (small and base), PVT-S and
    PVTv2-b2."""
    names = [Path(c).name for c in FAMILY_CONFIGS]
    assert len(names) == 12
    assert (sum("swin" in n for n in names), sum("hrformer" in n for n in names),
            sum("pvt" in n for n in names)) == (6, 4, 2)


@pytest.mark.parametrize("config", FAMILY_CONFIGS)
def test_config_builds(config):
    """Each shipped config builds through ``init_model`` on the CPU at full
    width and depth (no forward), the backbone built for the codec's input
    size, and its ``tools.train`` optimizer from the config."""
    cfg = Config.fromfile(str(ROOT / config))
    model = init_model(cfg, device="cpu")
    w, h = cfg["codec"]["input_size"]
    assert model.module.backbone.img_size == (h, w)
    build_optimizer(model, cfg["optim_wrapper"], cfg["param_scheduler"], 100, cfg["train_cfg"]["max_epochs"])
