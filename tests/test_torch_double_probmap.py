"""The port's DoubleProbPose pieces against the JAX package, on the same inputs.

The model is the JAX package's ``TINY_DP_CFG`` (``tests/test_models/
test_double_probmap.py``: 2 ViT layers of width 64, DoubleProbMapHead with
2 deconvs to 64 x 48) in f32 with ``drop_path_rate=0``; the JAX variables
(BatchNorm statistics randomized) move to the port through
``state_dict_from_jax``. Bars, with their reasons:

- the device encode of both windows against ``DoubleProbMap.encode`` and
  ``tests/golden/double_probmap.npz``: maps atol 1e-6 (both compute the
  window keypoints and the maps in float64 and round once to f32),
  ``in_image``, ``annotated`` and the weights exactly;
- the bbox mask bit for bit: the port's rectangle and matrix
  (``TopdownAffine``) rendered by ``ops/bbox_mask.py`` against the mask
  ``cv2.warpAffine`` makes on the JAX route, over boxes partly outside the
  image, flips, ``RandomBBoxTransform`` rotations, UDP and plain warps, from
  an array and from a JPEG file; the torch render bit for bit against the
  NumPy one;
- the merge's ``hout_in`` and merged maps exactly (a comparison and a
  select);
- the head in f32: atol 1e-5 on every output (``tests/test_torch_model.py``'s
  bar: summation order only);
- the loss dict on the JAX test's batch (``make_batch``): rtol 1e-5, atol
  1e-6, through ``loss_fn`` and, for each ``split_heatmaps_by`` with and
  without the bbox mask and ``freeze_error``, through the loss program on
  the head outputs, whose gradient with respect to each output is held at
  rtol 1e-5 (measured 3e-8 absolute). Deeper, the gradients are checked for
  where they flow, not held to a bar: no sparsemax follows these towers, so
  the heatmap loss's gradient is nearly constant over each map and each
  tower's BatchNorm backward subtracts that constant; two f32
  implementations then differ by their rounding times the cancellation
  (measured up to 3.8e-2 of the second tower's deconv gradient under
  "in/out"; a BatchNorm alone, fed an upstream gradient 3000 times its own
  variation, gives 7.6e-4 between the two packages);
- predict with flip-TTA: keypoints atol 1e-3 input pixels, every other field
  atol 1e-5;
- ``python -m probpose_code_torch.tools.train`` on a tiny DoubleProbPose
  config over ``chip_smoke.mini_coco_set``: its first loss dict within rel
  1e-3 of the JAX ``double_probmap_head_loss`` on the batch that the JAX
  pipeline's own per-sample outputs give (``gt_instances.out_heatmaps``,
  ``bbox_mask``, ``keypoints_in_image``: the JAX collate drops them). The
  crops differ by up to one grey level where cv2 rounds
  (``tests/test_torch_train_runner.py``'s bar).
"""

import copy
import random
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import DPM as DPM_CONFIG
from chip_smoke import DPM_CODEC, GOLDEN_JPEG, TRAIN_PIPELINE, mini_coco_set, tiny_train_cfg
from probpose_code_torch.apis import init_model
from probpose_code_torch.datasets.metainfo import parse_pose_metainfo
from probpose_code_torch.datasets.transforms import common as tcommon
from probpose_code_torch.datasets.transforms import loading as tloading
from probpose_code_torch.datasets.transforms.topdown import TopdownAffine
from probpose_code_torch.engine.checkpoint import state_dict_from_jax
from probpose_code_torch.engine.hooks import Hook
from probpose_code_torch.models.builder import PoseModel
from probpose_code_torch.models.pose_estimators.topdown import (
    double_probmap_head_loss,
    merge_double_heatmaps_device,
)
from probpose_code_torch.ops.bbox_mask import render_bbox_mask, render_bbox_mask_numpy
from probpose_code_torch.ops.encode import generate_probmaps_device, probmap_encode_scales
from probpose_code_torch.tools import train as train_cli
from probpose_code_tpu.codecs import DoubleProbMap
from probpose_code_tpu.models import PoseModel as JaxPoseModel
from probpose_code_tpu.models.pose_estimators.topdown import (
    double_probmap_head_loss as jax_double_probmap_head_loss,
)
from tests.test_models.test_double_probmap import TINY_DP_CFG, make_batch

ROOT = Path(__file__).resolve().parents[1]
CODEC = DPM_CODEC
META = parse_pose_metainfo({"dataset_name": "coco"})


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tier-1 runs six test workers at once; one torch thread each."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _cfg(**head):
    cfg = copy.deepcopy(TINY_DP_CFG)
    cfg["backbone"]["drop_path_rate"] = 0.0
    cfg["head"].update(head)
    return cfg


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _randomize_stats(variables, seed):
    rng = np.random.RandomState(seed)

    def fill(tree):
        return {k: fill(v) if isinstance(v, dict) else (
            rng.uniform(-0.2, 0.2, v.shape) if k == "mean" else rng.uniform(0.5, 1.5, v.shape)).astype(np.float32)
            for k, v in tree.items()}

    return dict(variables, batch_stats=fill(variables["batch_stats"]))


@pytest.fixture(scope="module")
def base_variables():
    """The tiny model's JAX variables, BatchNorm statistics randomized: one
    flax init for the module (the switches change no parameter)."""
    return _randomize_stats(_np(JaxPoseModel(_cfg(), metainfo=META).init(seed=0)), seed=1)


def _with_conv_stack(variables, seed):
    """``variables`` with a 3x3 conv stack of 16 channels before each
    tower's final layer, drawn from ``seed``."""
    rng = np.random.RandomState(seed)
    variables = copy.deepcopy(variables)
    params, stats = variables["params"]["head"], variables["batch_stats"]["head"]
    for tower in ("first_head", "second_head"):
        c_in = params[tower]["final_layer"]["kernel"].shape[2]
        params[tower]["conv_layers"] = dict(
            conv0=dict(kernel=(rng.randn(3, 3, c_in, 16) / np.sqrt(9 * c_in)).astype(np.float32),
                       bias=rng.uniform(-0.1, 0.1, 16).astype(np.float32)),
            bn0=dict(scale=rng.uniform(0.5, 1.5, 16).astype(np.float32),
                     bias=rng.uniform(-0.2, 0.2, 16).astype(np.float32)))
        stats[tower]["conv_layers"] = dict(bn0=dict(mean=rng.uniform(-0.2, 0.2, 16).astype(np.float32),
                                                    var=rng.uniform(0.5, 1.5, 16).astype(np.float32)))
        params[tower]["final_layer"]["kernel"] = (rng.randn(1, 1, 16, 17) / 4).astype(np.float32)
    return variables


def _pair(variables, **head):
    """The JAX model and the port's, on the same variables."""
    jm = JaxPoseModel(_cfg(**head), metainfo=META)
    jm.variables = variables
    ours = PoseModel(_cfg(**head), metainfo=META, device="cpu")
    ours.module.load_state_dict(state_dict_from_jax(variables), strict=True)
    return jm, ours


def _torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


# -- item 1: both windows' targets --------------------------------------------


def _encode_ours(keypoints, visible):
    """GenerateTarget's deferred outputs, then the device render."""
    out = tcommon.GenerateTarget(encoder=CODEC)(dict(transformed_keypoints=keypoints, keypoints_visible=visible))
    scales = probmap_encode_scales(17, (48, 64), -1.0, dtype=np.float64)
    vis = torch.from_numpy(out["device_kpts_visible"])
    maps = [generate_probmaps_device(torch.from_numpy(out[k]), vis, (48, 64), scales)[0].numpy()
            for k in ("device_kpts_hm", "device_kpts_hm_out")]
    return out, maps


@pytest.mark.parametrize("source", ["golden", "random"])
def test_device_encode_matches_codec(source, golden):
    codec = DoubleProbMap(input_size=(192, 256), heatmap_size=(48, 64), sigma=-1, in_heatmap_padding=1.0,
                          out_heatmap_padding=1.25)
    if source == "golden":
        g = golden("double_probmap")
        keypoints, visible = g["keypoints"].copy(), g["visible"].copy()
        refs = [dict(heatmaps=g["heatmaps"], out_heatmaps=g["out_heatmaps"][0], in_image=g["in_image"] > 0,
                     annotated=g["annotated"] > 0, keypoint_weights=g["keypoint_weights"])]
        cases = [(keypoints, visible)]
    else:
        rng = np.random.RandomState(11)
        cases = [(np.stack([rng.uniform(-40, 232, (1, 17)), rng.uniform(-50, 306, (1, 17))], -1).astype(np.float32),
                  (rng.rand(1, 17) > 0.2).astype(np.float32)) for _ in range(8)]
        refs = []
        for keypoints, visible in cases:
            enc = codec.encode(keypoints.copy(), visible.copy())
            refs.append(dict(heatmaps=enc["heatmaps"], out_heatmaps=enc["out_heatmaps"][0],
                             in_image=enc["in_image"], annotated=enc["annotated"],
                             keypoint_weights=enc["keypoint_weights"]))
    for (keypoints, visible), ref in zip(cases, refs):
        out, (maps_in, maps_out) = _encode_ours(keypoints, visible)
        np.testing.assert_allclose(maps_in, ref["heatmaps"], rtol=0, atol=1e-6)
        np.testing.assert_allclose(maps_out, ref["out_heatmaps"], rtol=0, atol=1e-6)
        np.testing.assert_array_equal(out["in_image"], ref["in_image"])
        np.testing.assert_array_equal(out["annotated"], ref["annotated"])
        np.testing.assert_array_equal(out["keypoint_weights"], ref["keypoint_weights"])
        np.testing.assert_array_equal(out["out_kpt_weights"], ref["keypoint_weights"])
    # the windows' in_image is the out-window point inside the heatmap, not ProbMap's input-space test
    if source == "random":
        assert any(o["in_image"].sum() != ((k >= 0) & (k < [192, 256])).all(-1).sum()
                   for o, (k, _) in ((_encode_ours(k, v)[0], (k, v)) for k, v in cases))


def test_combined_heatmap_type_is_refused():
    with pytest.raises(NotImplementedError, match="combined"):
        tcommon.GenerateTarget(encoder=dict(CODEC, heatmap_type="combined"))


# -- item 2: the bbox mask ----------------------------------------------------


def _mask_pipelines(use_udp, flip, rotate):
    """The transforms up to TopdownAffine, as (port, JAX) callables."""
    from probpose_code_tpu.datasets.transforms import common as jcommon
    from probpose_code_tpu.datasets.transforms import loading as jloading
    from probpose_code_tpu.datasets.transforms.topdown import TopdownAffine as JaxTopdownAffine

    def chain(mod, load, affine):
        steps = [load(), mod.GetBBoxCenterScale(), mod.RandomFlip(prob=1.0 if flip else 0.0),
                 mod.RandomBBoxTransform(rotate_prob=1.0 if rotate else 0.0, shift_prob=1.0, scale_prob=1.0),
                 affine(input_size=(192, 256), use_udp=use_udp, input_padding=1.25)]

        def run(results):
            for t in steps:
                results = t(results)
            return results

        return run

    return chain(tcommon, tloading.LoadImage, TopdownAffine), chain(jcommon, jloading.LoadImage, JaxTopdownAffine)


@pytest.mark.parametrize("use_udp", [True, False], ids=["udp", "plain"])
@pytest.mark.parametrize("flip", [False, True], ids=["noflip", "flip"])
@pytest.mark.parametrize("rotate", [False, True], ids=["norot", "rot"])
@pytest.mark.parametrize("source", ["array", "jpeg"])
def test_bbox_mask_bit_for_bit_against_cv2(use_udp, flip, rotate, source):
    ours_run, jax_run = _mask_pipelines(use_udp, flip, rotate)
    rng = np.random.RandomState(8 * (source == "jpeg") + 4 * use_udp + 2 * flip + rotate)
    jpeg = GOLDEN_JPEG / "golden" / "1.jpg"
    jpeg_shape = tloading.LoadImage()(dict(img_path=str(jpeg)))["img_shape"]
    rects, mats, want = [], [], []
    for i in range(12):
        if source == "jpeg":
            H, W = jpeg_shape
            base = dict(img_path=str(jpeg))
        else:
            H, W = rng.randint(120, 480, 2)
            base = dict(img=rng.randint(0, 256, (H, W, 3)).astype(np.uint8))
        # boxes partly outside the image on any side, some nearly all out
        x0, y0 = rng.uniform(-0.4 * W, 0.9 * W), rng.uniform(-0.4 * H, 0.9 * H)
        box = np.array([[x0, y0, x0 + rng.uniform(8, 0.8 * W), y0 + rng.uniform(8, 0.8 * H)]], np.float32)
        results = [dict(copy.deepcopy(base), bbox=box.copy(), img_shape=(H, W), flip_indices=META["flip_indices"])
                   for _ in range(2)]
        np.random.seed(1000 + i)
        ours = ours_run(results[0])
        np.random.seed(1000 + i)
        ref = jax_run(results[1])
        assert ours.get("flip", False) == flip and bool(ref.get("flip", False)) == flip
        rects.append(ours["bbox_mask_rect"])
        mats.append(ours["bbox_mask_mat"])
        want.append(ref["bbox_mask"])
    rects, mats, want = np.stack(rects), np.stack(mats), np.stack(want)
    got = render_bbox_mask_numpy(rects, mats, (192, 256))
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape == (12, 1, 256, 192)
    assert 0 < want.mean() < 1  # the sweep covers masks neither empty nor full
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        render_bbox_mask(torch.from_numpy(rects), torch.from_numpy(mats), (192, 256)).numpy(), got)


def test_with_bbox_mask_off_ships_nothing():
    img = np.zeros((100, 120, 3), np.uint8)
    results = dict(img=img, bbox_xyxy_wrt_input=np.array([[10.0, 10.0, 60.0, 90.0]]), img_shape=(100, 120))
    out = TopdownAffine(input_size=(192, 256), with_bbox_mask=False)(results)
    assert "bbox_mask_rect" not in out and "bbox_mask_mat" not in out


# -- items 4 and 5: head, merge, loss, predict --------------------------------


def test_merge_hout_in_exact():
    from probpose_code_tpu.models.pose_estimators.topdown import merge_double_heatmaps_device as jax_merge

    rng = np.random.RandomState(5)
    B, K, H, W = 3, 17, 64, 48
    h1 = rng.rand(B, K, H, W).astype(np.float32)
    h2 = rng.rand(B, K, H, W).astype(np.float32)
    mask = np.zeros((B, 1, 256, 192), np.uint8)
    for b in range(B):
        x0, y0 = rng.randint(0, 150), rng.randint(0, 200)
        mask[b, 0, y0:y0 + rng.randint(10, 150), x0:x0 + rng.randint(10, 120)] = 1
    for m in (mask, None):
        got = merge_double_heatmaps_device(torch.from_numpy(h1), torch.from_numpy(h2),
                                           None if m is None else torch.from_numpy(m))
        want = jax_merge(jnp.asarray(h1), jnp.asarray(h2), None if m is None else jnp.asarray(m))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        if m is not None:
            assert 0 < got[1].float().mean() < 1


@pytest.mark.parametrize("head", [{}, dict(conv_out_channels=(16,), conv_kernel_sizes=(3,), normalize=True)],
                         ids=["shipped", "conv_sigmoid"])
def test_head_outputs_match_jax(head, base_variables):
    variables = _with_conv_stack(base_variables, seed=3) if head else base_variables
    jm, ours = _pair(variables, **head)
    x = make_batch(2, seed=2)["inputs"]
    want = jm.forward(variables, x)
    ours.eval()
    with torch.no_grad():
        got = ours.module(ours.preprocess(torch.from_numpy(np.array(x))))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=1e-5, err_msg=k)


def _loss_batch(with_mask=True):
    batch = make_batch(2, seed=0)
    batch["keypoints_in_image"] = batch["in_image"] * (np.arange(17) % 5 != 0)  # a blackout crop's keypoints
    if not with_mask:
        batch.pop("bbox_mask")
    return batch


def test_loss_dict_matches_jax_and_gradients_flow(base_variables):
    variables = base_variables
    jm, ours = _pair(variables)
    batch = _loss_batch()
    total, (losses, _) = jax.jit(lambda v, b: jm.loss_fn(v, b, rngs={"dropout": jax.random.PRNGKey(0)}))(
        variables, batch)
    got_total, (got, _) = ours.loss_fn(_torch_batch(batch))
    assert set(got) == set(losses)
    for k, v in losses.items():
        assert float(got[k].detach()) == pytest.approx(float(v), rel=1e-5, abs=1e-6), k
    assert float(got_total.detach()) == pytest.approx(float(total), rel=1e-5)
    # where gradient flows: both towers and the backbone learn; the frozen error tower does not
    got_total.backward()
    params = dict(ours.module.named_parameters())
    for name in ("head.first_head.deconv_layers.0.weight", "head.second_head.deconv_layers.0.weight",
                 "head.second_head.final_layer.bias", "backbone.layers.0.attn.qkv.weight"):
        assert float(params[name].grad.abs().max()) > 0, name
    assert all(p.grad is None for n, p in params.items() if n.startswith("head.error_layers."))


@pytest.fixture(scope="module")
def train_outputs(base_variables):
    """The head outputs of one training-mode forward, on each side."""
    jm, ours = _pair(base_variables)
    x = make_batch(2, seed=0)["inputs"]
    want, _ = jm.module.apply(base_variables, jm.preprocess(x), train=True, rngs={"dropout": jax.random.PRNGKey(0)},
                              mutable=["batch_stats"])
    ours.train()
    with torch.no_grad():
        got = ours.module(ours.preprocess(torch.from_numpy(np.array(x))))
    return want, got, jm, ours


@pytest.mark.parametrize("split,freeze_error,with_mask", [
    ("in/all", True, True), ("in/out", False, True), ("visibility", True, False), ("in/all", False, False)])
def test_head_loss_and_output_gradients_match_jax(train_outputs, split, freeze_error, with_mask):
    jax_outputs, outputs, jm, ours = train_outputs
    head_cfg = dict(ours.aux["head_cfg"], split_heatmaps_by=split, freeze_error=freeze_error)
    batch = _loss_batch(with_mask)

    def head_loss(o):
        values = jax_double_probmap_head_loss(o, batch, jm.loss_modules, head_cfg)
        return sum(v for k, v in values.items() if k.startswith("loss_")), values

    (_, want), want_grads = jax.value_and_grad(head_loss, has_aux=True)(jax_outputs)
    leaves = {k: v.clone().requires_grad_(True) for k, v in outputs.items()}
    got = double_probmap_head_loss(leaves, _torch_batch(batch), ours.loss_modules, head_cfg)
    sum(v for k, v in got.items() if k.startswith("loss_")).backward()
    assert set(got) == set(want)
    for k, v in want.items():
        assert float(got[k].detach()) == pytest.approx(float(v), rel=1e-5, abs=1e-6), k
    for k, v in leaves.items():
        w = np.asarray(want_grads[k])
        np.testing.assert_allclose(v.grad.numpy(), w, rtol=1e-5, atol=1e-5 * np.abs(w).max(), err_msg=k)


def test_detach_second_heatmaps_cuts_the_backbone_gradient(base_variables):
    _, ours = _pair(base_variables, detach_second_heatmaps=True)
    ours.train()
    out = ours.module(ours.preprocess(torch.from_numpy(np.array(make_batch(2, seed=1)["inputs"]))))
    backbone = [p for n, p in ours.module.named_parameters() if n.startswith("backbone.")]
    grads = torch.autograd.grad(out["out_heatmaps"].sum(), backbone, allow_unused=True, retain_graph=True)
    assert all(g is None for g in grads)
    grads = torch.autograd.grad(out["heatmaps"].sum(), backbone, allow_unused=True)
    assert any(g is not None and g.abs().max() > 0 for g in grads)


def test_predict_flip_tta_matches_jax(base_variables):
    jm, ours = _pair(base_variables)
    x = np.array(make_batch(3, seed=3)["inputs"])
    want = {k: np.asarray(v) for k, v in jm.make_predict(jit=True)(base_variables, jnp.asarray(x)).items()}
    got = {k: v.numpy() for k, v in ours.predict(torch.from_numpy(x)).items()}
    assert set(got) == set(want)
    np.testing.assert_allclose(got["keypoints"], want["keypoints"], rtol=0, atol=1e-3)
    for k in want:
        if k != "keypoints":
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5, err_msg=k)
    # both windows take part: some keypoints come from the out-window (outside the crop)
    outside = (got["keypoints"] < 0) | (got["keypoints"] >= [192, 256])
    assert outside.any() and not outside.all()


def test_shipped_config_builds_on_the_cpu_only_when_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_model(str(DPM_CONFIG))
    model = init_model(str(DPM_CONFIG), device="cpu")
    assert model.head_type == "DoubleProbMapHead" and model.is_low_precision()
    names = set(model.module.state_dict())
    assert {"head.first_head.deconv_layers.0.weight", "head.second_head.final_layer.bias",
            "head.oks_layers.12.weight"} <= names


# -- the slice: tools.train on a tiny DoubleProbPose config --------------------


class Record(Hook):
    def __init__(self):
        self.losses = []

    def after_train_iter(self, runner, step, metrics):
        self.losses.append({k: float(v) for k, v in metrics.items()})


class LoadWeights(Hook):
    """Start from the JAX variables (the runner's own seed-0 weights
    replaced before its first step)."""

    def __init__(self, state_dict):
        self.state_dict = state_dict

    def before_run(self, runner):
        runner.model.module.load_state_dict(self.state_dict, strict=True)


def _jax_batch(samples):
    """The batch of the JAX pipeline's per-sample outputs, with what the
    DoubleProbMap loss reads and the JAX collate drops."""
    def inst(name):
        return np.stack([np.asarray(s["data_samples"].gt_instances[name]).reshape(-1) for s in samples])

    return dict(
        inputs=np.stack([s["inputs"] for s in samples]).astype(np.float32),
        heatmaps=np.stack([s["data_samples"].gt_fields.heatmaps for s in samples]).astype(np.float32),
        out_heatmaps=np.stack([np.asarray(s["data_samples"].gt_instances.out_heatmaps)[0]
                               for s in samples]).astype(np.float32),
        bbox_mask=np.stack([s["data_samples"].gt_instances.bbox_mask for s in samples]),
        keypoint_weights=np.stack([s["data_samples"].gt_instance_labels.keypoint_weights[0] for s in samples]),
        in_image=inst("in_image").astype(np.float32),
        annotated=(inst("keypoints_visible") > 0).astype(np.float32),
        keypoints_visibility=inst("keypoints_visibility").astype(np.float32),
        keypoints_in_image=inst("keypoints_in_image").astype(np.float32),
    )


def test_tools_train_first_losses_match_jax_loss(tmp_path, base_variables):
    import probpose_code_tpu.datasets  # noqa: F401  (registers)
    from probpose_code_tpu.registry import DATASETS as JAX_DATASETS

    ann = mini_coco_set(tmp_path / "data")
    cfg = tiny_train_cfg(ann, batch_size=6)
    cfg["model"] = _cfg()
    pipeline = copy.deepcopy(TRAIN_PIPELINE)
    pipeline[6] = dict(type="GenerateTarget", encoder=CODEC)
    cfg["train_dataloader"]["dataset"]["pipeline"] = pipeline
    cfg.pop("val_evaluator")
    cfg.update(train_cfg=dict(max_epochs=1, val_interval=10))
    cfg_file = tmp_path / "cfg.py"
    cfg_file.write_text("".join(f"{k} = {v!r}\n" for k, v in cfg.items()))

    jm = JaxPoseModel(cfg["model"], metainfo=META)
    variables = base_variables
    record = Record()
    runner = train_cli.main([str(cfg_file), "--work-dir", str(tmp_path / "work"), "--device", "cpu"],
                            hooks=[LoadWeights(state_dict_from_jax(variables)), record])
    assert runner.state.step == 2

    # the first batch through the JAX pipeline, under the loader's seed
    loader = runner.train_loader
    chunk = loader._tasks.index_batches(0)[0]
    seed = loader._tasks.task_seed(0, 0)
    np.random.seed(seed % (2**32))
    random.seed(seed)
    dataset = JAX_DATASETS.build(copy.deepcopy(cfg["train_dataloader"]["dataset"]))
    batch = _jax_batch([dataset[int(j)] for j in chunk])
    assert batch["bbox_mask"].shape == (6, 1, 256, 192) and 0 < batch["bbox_mask"].mean() < 1
    _, (want, _) = jax.jit(lambda v, b: jm.loss_fn(v, b, rngs={"dropout": jax.random.PRNGKey(0)}))(variables, batch)
    got = record.losses[0]
    for k, v in want.items():
        assert got[k] == pytest.approx(float(v), rel=1e-3, abs=1e-6), k
    assert {"loss_kpt", "loss_kpt2", "acc_pose1", "acc_pose2"} <= set(got)
