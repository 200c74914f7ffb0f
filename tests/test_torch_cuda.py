"""The CUDA kernels against their plain twins, on the card.

These tests need an NVIDIA card with the CUDA toolkit; elsewhere they skip.
They import no JAX, so they run where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

They cover shapes beyond the ones that ``chip_smoke.py`` holds: ragged
tiles, head widths of 8 and above 128, maps whose filter needs more than
48 KB of shared memory, maps whose sides are no multiple of K2's strip, a
filter radius equal to the shorter side, a tap count that runs K2's
runtime-D instance, flat maps and equal peaks whose argmax is a tie, and
all-NaN maps; DoubleProbPose (the tiny model with its head) predicting
and taking one train step on the card against the CPU, its bbox mask on the
card bit for bit against NumPy, and one HRNet train step against the CPU;
training through the runner (the tiny config's ``Runner.train``
by ``tools/train.py``'s main, two epochs, K3's launches a step counted, no
process left running); the val path (``Runner.val`` over the golden tiny fixture's
PNG files with two worker processes started after CUDA, canvases warped on
the card as on the CPU; ``python -m
probpose_code_torch.tools.test`` without ``--device``, on the card); K1 and K3
forward and backward at those shapes and at the flagship layer's widths,
with and without stochastic-depth masks; in bf16 and f32 also MLP widths
that are not a multiple of 8, keys streamed through shared memory and the
widest heads (in f32 also a wide head whose keys are streamed); K3's
gradients bitwise equal across two runs (no atomics); a bf16 head too wide
for shared memory refused; one train step of the tiny config through K3;
K4 on strided and contiguous inputs, ragged N, head widths from 8 to 824,
and keys beyond the one-pass instance (two passes, streamed); and one
ViTPose-B-simple train step, whose twelve layers run K4 and not K3; the
JPEG decode (bit for bit; nvJPEG's batched decode, the yardstick, within its
bars) against the plain decoder on every fixture of ``tests/golden_torch``, a fresh zeroed
buffer for each batch, the truncated stream refused; the val path over JPEG files (decoded on the card, one
decode a batch) and ``tools.serve`` answering ``inference_topdown``'s JSON;
the device encodes of the MSRA codec (and its unbiased form) and of the
SimCC labels against the port's host codecs, and the classic and RTMPose
model fixtures on the card; the photometric median kernel, the HSV
tables and PhotometricDistortion against their plain versions and against
cv2's fixture; the GAU kernels, forward and backward, against their plain
twin on ragged token counts and widths, and RTMPose's head on the card
through them against the CPU; MobileNetV2's depthwise 3x3 kernels (forward,
input and weight gradients) on channel counts beside the 32 of a tile and
odd sides at both strides (a count that is no multiple of 4 refused), and
AdaptiveWingLoss's kernels with and without weights, SCNet's gate
kernels (forward and the gradients of its three inputs, bit for bit across
two runs) on odd sides and pooled sizes of each ratio SCNet meets, and
ResNeSt's split attention kernels at radix 1 to 4 on planes smaller and
larger than a block, against their plain twins.
Bars are ``chip_smoke.py``'s, with its reasons.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

from chip_smoke import (
    GOLDEN,
    EXACT_BARS,
    GOLDEN_JPEG,
    NVJPEG_BARS,
    K4_BF16_REL,
    K4_F32_ATOL,
    VITPOSE,
    K1_BF16_REL,
    K2_CONV_ATOL,
    K2_LOCS_ATOL,
    K2_VALS_ATOL,
    K3_BF16_REL,
    K3_F32_FWD,
    K3_F32_GRAD,
    SERVE_KPT_ATOL,
    SERVE_SCORE_ATOL,
    AWING_REL,
    SC_GATE_GRAD_REL,
    SC_GATE_REL,
    SPLIT_ATTENTION_GRAD_REL,
    SPLIT_ATTENTION_REL,
    DEPTHWISE_GRAD_REL,
    DEPTHWISE_REL,
    GAU_GRAD_REL,
    GAU_REL,
    HRNET_REL,
    K1_F32_REL,
    TINY_CFG,
    UDP_FIXTURE_CFG,
    VIT_LARGE_SHAPES,
    KeepSamples,
    NvjpegBatched,
    Smoke,
    golden_errors,
    golden_jpeg_set,
    golden_png_set,
    golden_samples,
    golden_val_cfg,
    k3_errors,
    kernel_counters,
    layer_inputs,
    peaked_heatmaps,
    qkv_views,
    synthetic_dpm_batch,
    synthetic_train_batch,
    tiny_dpm_cfg,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc (run on the card)")


LAYER_SHAPES = [(3, 24, 40, 5, 72), (1, 8, 64, 8, 256), (2, 200, 272, 2, 544), (4, 192, 384, 12, 1536)]


@pytest.mark.parametrize("B,N,C,H,F", LAYER_SHAPES)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_vit_layer_matches_plain(card, B, N, C, H, F, dtype):
    from probpose_code_torch.ops.kernels.vit_layer import vit_layer, vit_layer_plain, vit_layer_prepared

    dt = getattr(torch, dtype)
    approx = dtype == "bfloat16"
    bar = K1_BF16_REL if approx else K1_F32_REL
    x, p = layer_inputs(B, N, C, F, dt, seed=B + N)
    kw = dict(num_heads=H, approximate_gelu=approx, dtype=dt)
    before = vit_layer_prepared.launches
    got = vit_layer(x, *p, **kw).float()
    want = vit_layer_plain(x, *p, **kw).float()
    assert vit_layer_prepared.launches == before + 1
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() / want.abs().max().item() < bar


@pytest.mark.parametrize("C,H,F", VIT_LARGE_SHAPES, ids=["vitl", "vith"])
def test_vit_layer_matches_plain_at_vit_large_and_huge(card, C, H, F):
    """K1's f32 instance with erf GELU at ViT-L's width (16 heads of 64) and
    ViT-H's (16 heads of 80: the two-pass attention) against its twin."""
    from probpose_code_torch.ops.kernels.vit_layer import vit_layer, vit_layer_plain

    x, p = layer_inputs(4, 192, C, F, torch.float32, seed=C)
    kw = dict(num_heads=H, approximate_gelu=False, dtype=torch.float32)
    with torch.inference_mode():
        got, want = vit_layer(x, *p, **kw), vit_layer_plain(x, *p, **kw)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() / want.abs().max().item() < K1_F32_REL


@pytest.mark.parametrize("D", [64, 80])
def test_attention_matches_plain_at_vit_large_and_huge_heads(card, D):
    """K4 in f32 over 16 heads of 64 (ViT-L) and of 80 (ViT-H) on strided
    qkv views: the forward at ``K4_F32_ATOL`` and the gradient through the
    Function at ``K4_GRAD_ATOL`` (``Smoke.k4_f32_errors`` raises on
    either)."""
    Smoke.k4_f32_errors(8, 192, 16, D, seed=D)


# the shipped shapes, then maps whose sides are no multiple of K2's 16-output
# strip, a filter radius equal to the shorter side, and the runtime-D instance
@pytest.mark.parametrize("B,K,H,W", [(5, 17, 64, 48), (2, 17, 128, 96), (3, 4, 32, 24),
                                     (2, 17, 50, 37), (1, 17, 9, 148), (2, 17, 16, 12)])
def test_expected_oks_matches_plain(card, B, K, H, W):
    from probpose_code_torch.ops.decode import expected_oks_decode_to_input_space, oks_convolve_plain
    from probpose_code_torch.ops.kernels.expected_oks import expected_oks_decode, oks_convolve

    hm = torch.from_numpy(peaked_heatmaps(B, K, H, W, seed=H)).cuda()
    size = (4 * W, 4 * H)
    scale = torch.tensor([size[0] / (W - 1), size[1] / (H - 1)], device="cuda")
    locs, vals = expected_oks_decode(hm, size)
    locs_p, vals_p = expected_oks_decode_to_input_space(hm, size)
    assert ((locs - locs_p) / scale).abs().max().item() < K2_LOCS_ATOL
    assert (vals - vals_p).abs().max().item() < K2_VALS_ATOL
    assert (oks_convolve(hm) - oks_convolve_plain(hm)).abs().max().item() < K2_CONV_ATOL


def test_expected_oks_flat_maps_take_the_first_index(card):
    from probpose_code_torch.ops.decode import expected_oks_decode_to_input_space
    from probpose_code_torch.ops.kernels.expected_oks import expected_oks_decode

    hm = torch.zeros(2, 17, 64, 48, device="cuda")
    locs, vals = expected_oks_decode(hm, (192, 256))
    locs_p, vals_p = expected_oks_decode_to_input_space(hm, (192, 256))
    assert torch.equal(locs, locs_p) and torch.equal(vals, vals_p)


def test_expected_oks_instances_of_the_edge_shapes(card):
    """The edge shapes of ``test_expected_oks_matches_plain``: 9 x 148 has a
    filter radius equal to its shorter side, 16 x 12 a tap count (D = 9)
    with no register instance, so it runs the runtime-D instance; the
    shipped shapes' tap counts have register instances."""
    from probpose_code_torch.ops.decode import oks_filter_taps
    from probpose_code_torch.ops.kernels.expected_oks import register_taps

    assert oks_filter_taps(17, 9, 148).shape[1] // 2 == 9
    assert not register_taps(oks_filter_taps(17, 16, 12).shape[1])
    assert all(register_taps(oks_filter_taps(K, H, W).shape[1])
               for K, H, W in ((17, 64, 48), (17, 128, 96), (4, 32, 24), (17, 32, 24)))


def test_expected_oks_equal_maxima_take_the_first_index(card):
    """Equal unit peaks, each farther than the filter radius from the others,
    at points that fall in different strips, warps and halves of a warp: the
    convolved maxima are the same bits (one product of two taps), and the
    first index wins, as torch.argmax's; bitwise equal to the plain twin."""
    from probpose_code_torch.ops.decode import expected_oks_decode_to_input_space
    from probpose_code_torch.ops.kernels.expected_oks import expected_oks_decode

    hm = torch.zeros(3, 17, 64, 48)
    points = [(44, 36), (20, 40), (20, 12), (52, 5), (33, 33), (20, 26)]
    for k in range(17):
        for y, x in points[k % 4:]:
            hm[:, k, y, x] = 1.0
    hm = hm.cuda()
    locs, vals = expected_oks_decode(hm, (192, 256))
    locs_p, vals_p = expected_oks_decode_to_input_space(hm, (192, 256))
    assert torch.equal(locs, locs_p) and torch.equal(vals, vals_p)


def test_expected_oks_all_nan_map_gives_index_0(card):
    from probpose_code_torch.ops.kernels.expected_oks import expected_oks_decode

    hm = torch.full((2, 17, 64, 48), float("nan"), device="cuda")
    hm[1, 3] = torch.from_numpy(peaked_heatmaps(1, 1, 64, 48, seed=0))[0, 0].cuda()
    locs, _ = expected_oks_decode(hm, (192, 256))
    keep = torch.ones(2, 17, dtype=torch.bool)
    keep[1, 3] = False
    assert torch.equal(locs[keep.cuda()], torch.zeros(33, 2, device="cuda"))
    assert locs[1, 3].abs().sum() > 0


def test_kernels_reject_what_they_do_not_take(card):
    from probpose_code_torch.ops.kernels.expected_oks import expected_oks_decode
    from probpose_code_torch.ops.kernels.vit_layer import vit_layer

    with pytest.raises(ValueError):
        expected_oks_decode(torch.zeros(2, 17, 48, 64, device="cuda").transpose(2, 3), (192, 256))
    x, p = layer_inputs(2, 16, 64, 128, torch.float32, seed=0)
    with pytest.raises(TypeError):
        vit_layer(x, *p, num_heads=4, dtype=torch.bfloat16)


def test_golden_fixture_on_the_card(card):
    from probpose_code_torch.apis import init_model

    model = init_model(TINY_CFG, checkpoint=str(GOLDEN / "e2e_weights.pth"))
    err, aux = golden_errors(*golden_samples(model))
    assert np.percentile(err, 99) < 1.0 and err.max() < 5.0
    assert max(aux.values()) < 2e-3


def test_val_path_on_the_card(card, tmp_path):
    from probpose_code_torch.datasets.loader import DataLoader, stop_workers
    from probpose_code_torch.engine.checkpoint import load_checkpoint
    from probpose_code_torch.engine.runner import Runner

    data, ann = golden_png_set(tmp_path)
    runner = Runner.from_cfg(golden_val_cfg(TINY_CFG["model"], ann, batch_size=16, num_workers=2))
    load_checkpoint(runner.model, str(GOLDEN / "e2e_weights.pth"))
    evaluator = KeepSamples(runner.build_evaluator())
    counters = kernel_counters()
    for c in counters.values():
        c.launches = 0
    try:
        metrics = runner.val(evaluator)
    finally:
        stop_workers()
    assert counters["vit_layer"].launches == 2 * 4 and counters["expected_oks"].launches == 4
    err, aux = golden_errors(data, evaluator.samples)
    assert len(evaluator.samples) == 62 and np.percentile(err, 99) < 1.0 and max(aux.values()) < 2e-3
    assert abs(metrics["coco/AP"] - data["stats"][0]) < 0.01 and abs(metrics["coco/Ex_AP"] - data["Ex_stats"][0]) < 0.01

    batch = next(iter(DataLoader(runner.val_dataset, 16, num_workers=0)))
    arrays = {k: torch.from_numpy(v) for k, v in batch.items() if isinstance(v, np.ndarray)}
    want = runner.model.device_preprocess_batch(arrays)["inputs"]
    got = runner.model.device_preprocess_batch({k: v.cuda() for k, v in arrays.items()})["inputs"]
    assert got.is_cuda and (got.cpu() - want).abs().max() <= 1.0


def test_cli_on_the_card(card, tmp_path):
    data, ann = golden_png_set(tmp_path)
    cfg = golden_val_cfg(TINY_CFG["model"], ann, batch_size=32, num_workers=2)
    (tmp_path / "cfg.py").write_text("".join(f"{k} = {v!r}\n" for k, v in cfg.items()))
    out = subprocess.run(
        [sys.executable, "-m", "probpose_code_torch.tools.test", str(tmp_path / "cfg.py"), str(GOLDEN / "e2e_weights.pth")],
        cwd=GOLDEN.parents[1], capture_output=True, text=True, timeout=600,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    printed = dict(line.rsplit(": ", 1) for line in out.stdout.splitlines() if line.startswith("coco/"))
    assert abs(float(printed["coco/AP"]) - data["stats"][0]) < 0.01
    assert abs(float(printed["coco/Ex_AP"]) - data["Ex_stats"][0]) < 0.01


@pytest.mark.parametrize("B,N,C,H,F", LAYER_SHAPES)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("masked", [False, True])
def test_vit_layer_train_matches_plain(card, B, N, C, H, F, dtype, masked):
    from probpose_code_torch.ops.kernels.vit_layer_train import vit_layer_train_backward, vit_layer_train_forward

    dt = getattr(torch, dtype)
    before = (vit_layer_train_forward.launches, vit_layer_train_backward.launches)
    errs = k3_errors(B, N, C, H, F, dt, masked, seed=B + N)
    assert (vit_layer_train_forward.launches, vit_layer_train_backward.launches) == (before[0] + 1, before[1] + 1)
    for name, err in errs.items():
        bar = K3_BF16_REL if dt == torch.bfloat16 else K3_F32_FWD if name == "out" else K3_F32_GRAD
        assert err < bar, (name, err)


def test_vit_layer_train_rejects_what_it_does_not_take(card):
    from probpose_code_torch.ops.kernels.vit_layer_train import vit_layer_train

    x, p = layer_inputs(2, 16, 64, 128, torch.float32, seed=0)
    with pytest.raises(TypeError):
        vit_layer_train(x, *p, num_heads=4, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="K3 rule"):
        vit_layer_train(x[:, :12].contiguous(), *p, num_heads=4, dtype=torch.float32)


def test_vit_layer_train_backward_is_deterministic(card):
    """Two backward runs on the same inputs give the same bits: the weight
    gradients are row-split products summed in a fixed order, no atomics."""
    from probpose_code_torch.ops.kernels.vit_layer import _fold_q_scale
    from probpose_code_torch.ops.kernels.vit_layer_train import (
        _operands, vit_layer_train_backward, vit_layer_train_forward,
    )

    B, N, C, H, F = 4, 192, 384, 12, 1536
    x, p = layer_inputs(B, N, C, F, torch.bfloat16, seed=3)
    m1 = torch.tensor([0.0, 1 / 0.9, 1 / 0.9, 1 / 0.9], device="cuda")
    m2 = torch.tensor([1 / 0.9, 1 / 0.9, 1 / 0.9, 0.0], device="cuda")
    g = torch.randn(B, N, C, generator=torch.Generator().manual_seed(4)).cuda().bfloat16()
    w_qkv, b_qkv = _fold_q_scale(p[2], p[3], C // H)
    ops = _operands([p[0], p[1], w_qkv, b_qkv, *p[4:]], torch.bfloat16)
    out, saved = vit_layer_train_forward(x, m1, m2, ops, num_heads=H, eps=1e-6)
    first = vit_layer_train_backward(g, x, m1, m2, ops, saved, num_heads=H, eps=1e-6)
    second = vit_layer_train_backward(g, x, m1, m2, ops, saved, num_heads=H, eps=1e-6)
    torch.cuda.synchronize()
    assert len(first) == 13
    for a, b in zip(first, second):
        assert torch.equal(a, b)


# Shapes that ``fits`` admits beyond the ragged ones above: MLP widths that
# are not a multiple of 8 (one odd), N above 192 with K and V whole in shared
# memory, keys too many for it (streamed a chunk at a time), and the widest
# heads each kernel takes (K3 432; K1 alone at 824). In f32 also an 824-wide
# head whose keys do not fit whole in shared memory (streamed).
EDGE_SHAPES = [(2, 16, 64, 4, 100), (2, 24, 64, 4, 75), (2, 256, 128, 2, 256), (1, 2048, 64, 1, 128),
               (1, 16, 432, 1, 64), (1, 16, 824, 1, 64)]
EDGE_CASES = [(*shape, "bfloat16") for shape in EDGE_SHAPES] + [
    (*shape, "float32") for shape in EDGE_SHAPES + [(1, 64, 824, 1, 64)]]


@pytest.mark.parametrize("B,N,C,H,F,dtype", EDGE_CASES)
def test_bf16_takes_every_shape_fits_admits(card, B, N, C, H, F, dtype):
    """K1 (and K3 where its heads fit) at each edge shape, in bf16 and f32
    (both instances of K1 run on the tensor cores)."""
    from probpose_code_torch.ops.kernels.vit_layer import vit_layer, vit_layer_plain

    dt = getattr(torch, dtype)
    f32 = dt == torch.float32
    x, p = layer_inputs(B, N, C, F, dt, seed=B + N + F)
    kw = dict(num_heads=H, dtype=dt, approximate_gelu=not f32)
    with torch.inference_mode():
        got = vit_layer(x, *p, **kw).float()
        want = vit_layer_plain(x, *p, **kw).float()
    assert (got - want).abs().max().item() / want.abs().max().item() < (K1_F32_REL if f32 else K1_BF16_REL)
    if C // H <= 432:
        for name, err in k3_errors(B, N, C, H, F, dt, B > 1, seed=B + N + F).items():
            assert err < (K3_BF16_REL if not f32 else K3_F32_FWD if name == "out" else K3_F32_GRAD), (name, err)


def test_bf16_heads_beyond_shared_memory_raise(card):
    """A head wider than one block's shared memory takes (K1 and K4 896 in
    bf16 and f32, K3 432 in bf16) is refused, as there is no other path; K4
    runs the widest f32 head it takes."""
    from probpose_code_torch.ops.kernels.attention import attention_kernel, fused_attention_plain
    from probpose_code_torch.ops.kernels.vit_layer import vit_layer
    from probpose_code_torch.ops.kernels.vit_layer_train import vit_layer_train

    for dt in (torch.bfloat16, torch.float32):
        x, p = layer_inputs(1, 8, 904, 16, dt, seed=5)
        with pytest.raises(ValueError, match="shared memory"):
            vit_layer(x, *p, num_heads=1, dtype=dt)
        with pytest.raises(ValueError, match="shared memory"):
            attention_kernel(*qkv_views(1, 8, 1, 904, dt, seed=5), 904 ** -0.5)
    q, k, v = qkv_views(1, 24, 1, 896, torch.float32, seed=7)
    got = attention_kernel(q, k, v, 896 ** -0.5)
    assert (got - fused_attention_plain(q, k, v, 896 ** -0.5)).abs().max().item() < K4_F32_ATOL
    x, p = layer_inputs(1, 8, 440, 16, torch.bfloat16, seed=6)
    with pytest.raises(ValueError, match="shared memory"):
        vit_layer_train(x, *p, num_heads=1, dtype=torch.bfloat16)


def test_k1_refuses_autograd_on_the_card(card):
    from probpose_code_torch.ops.kernels.vit_layer import vit_layer

    x, p = layer_inputs(2, 16, 64, 128, torch.float32, seed=1)
    with pytest.raises(RuntimeError, match="no backward"):
        vit_layer(x.requires_grad_(True), *p, num_heads=4, dtype=torch.float32)


def test_one_train_step_goes_through_k3(card):
    """The tiny config (tanh-GELU, drop_path 0.1) takes one step on the card:
    every ViT layer runs K3 forward and backward, no layer reaches K1, the
    losses are finite and the first layer gets a gradient."""
    import copy

    from probpose_code_torch.apis import init_model
    from probpose_code_torch.engine.optim import build_optimizer
    from probpose_code_torch.parallel import create_train_state, make_train_step

    cfg = copy.deepcopy(TINY_CFG)
    cfg["model"]["backbone"].update(approximate_gelu=True, drop_path_rate=0.1)
    model = init_model(cfg, device="cuda")
    optimizer, _ = build_optimizer(model, dict(optimizer=dict(type="AdamW", lr=1e-3, weight_decay=0.1),
                                               clip_grad=dict(max_norm=1.0)))
    step = make_train_step(model, optimizer)
    counters = kernel_counters()
    for c in counters.values():
        c.launches = 0
    _, metrics = step(create_train_state(model, optimizer), synthetic_train_batch(4, seed=0),
                      torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    assert launches == dict(vit_layer=0, expected_oks=0, oks_convolve=0, vit_layer_train_fwd=2, vit_layer_train_bwd=2,
                            attention=0)
    assert all(torch.isfinite(v).all() for v in metrics.values())
    assert float(metrics["grad_norm"]) > 0
    assert model.module.backbone.layers[0].attn.qkv.weight.grad.abs().max() > 0


def test_runner_trains_on_the_card(card, tmp_path):
    """The tiny config (tanh-GELU, so every layer trains through K3) through
    ``python -m probpose_code_torch.tools.train``'s main for two epochs of
    two steps over a seeded mini set, two loader workers started after CUDA:
    K3 x2 forward and x2 backward a step, K1 x2 and K2 x1 a val batch, no
    other kernel; the checkpoints written and the last one equal to the
    live weights; no worker, fork server or resource tracker left running."""
    from pathlib import Path

    from chip_smoke import mini_coco_set, stop_descendants, tiny_train_cfg
    from probpose_code_torch.engine.checkpoint import read_checkpoint
    from probpose_code_torch.tools import train as train_cli

    ann = mini_coco_set(tmp_path / "data")
    cfg = tiny_train_cfg(ann, batch_size=6, num_workers=2, approximate_gelu=True)
    (tmp_path / "cfg.py").write_text("".join(f"{k} = {v!r}\n" for k, v in cfg.items()))
    counters = kernel_counters()
    for c in counters.values():
        c.launches = 0
    runner = train_cli.main([str(tmp_path / "cfg.py"), "--work-dir", str(tmp_path / "wd")])
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    steps, val_batches = runner.state.step, 2  # one val batch of 12 after each epoch
    assert steps == 4 and len(runner.train_log) == 4
    assert launches == dict(vit_layer=2 * val_batches, expected_oks=val_batches, oks_convolve=0,
                            vit_layer_train_fwd=2 * steps, vit_layer_train_bwd=2 * steps, attention=0)
    assert all(np.isfinite(list(log.values())).all() for log in runner.train_log)
    ckpt = read_checkpoint(str(tmp_path / "wd" / "epoch_2.pth"))
    live = runner.model.module.state_dict()
    assert all(torch.equal(live[k].cpu(), v) for k, v in ckpt["state_dict"].items())
    assert (tmp_path / "wd" / "best.pth").exists() and (tmp_path / "wd" / "epoch_1.pth").exists()
    assert stop_descendants(grace=2.0) == []


# one pass (N <= 192, d <= 64); f32's wide one pass (N <= 192, d <= 96:
# ViT-H's 80, a ragged N at 72, the widest 96), whose shapes bf16 and, just
# past either edge, (1, 193, 2, 80) and (1, 192, 2, 104), take two passes;
# two passes with K and V whole in shared memory (1, 200, 2, 160) or
# streamed: keys beyond it (1, 1024, 2, 64), and a head of 824 (1, 40, 1, 824)
@pytest.mark.parametrize("B,N,H,D", [(2, 192, 12, 64), (3, 37, 5, 8), (1, 200, 2, 160), (2, 16, 3, 36),
                                     (1, 1024, 2, 64), (1, 40, 1, 824), (2, 192, 16, 80), (3, 37, 5, 72),
                                     (1, 192, 2, 96), (1, 193, 2, 80), (1, 192, 2, 104)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_attention_matches_plain(card, B, N, H, D, dtype):
    from probpose_code_torch.ops.kernels.attention import attention_kernel, fused_attention_plain

    dt = getattr(torch, dtype)
    q, k, v = qkv_views(B, N, H, D, dt, seed=B + N)
    before = attention_kernel.launches
    got = attention_kernel(q, k, v, D ** -0.5).float()
    want = fused_attention_plain(q, k, v, D ** -0.5).float()
    torch.cuda.synchronize()
    assert attention_kernel.launches == before + 1
    if dt == torch.float32:
        assert (got - want).abs().max().item() < K4_F32_ATOL
    else:
        assert (got - want).abs().max().item() / want.abs().max().item() < K4_BF16_REL
    # the same values laid out contiguously give the same result
    again = attention_kernel(*(t.contiguous() for t in (q, k, v)), D ** -0.5).float()
    assert torch.equal(again, got)


@pytest.mark.parametrize("D", [64, 80])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_attention_repeats_bit_for_bit(card, dtype, D):
    """K4 at the ViTPose-B and -H train steps' head widths gives the same
    bits on every launch: a race between the warps of a block (12 of them in
    f32's one-pass instances) would show as a change."""
    from probpose_code_torch.ops.kernels.attention import attention_kernel

    q, k, v = qkv_views(4, 192, 12, D, getattr(torch, dtype), seed=3)
    first = attention_kernel(q, k, v, D ** -0.5)
    for _ in range(50):
        assert torch.equal(attention_kernel(q, k, v, D ** -0.5), first)


@pytest.mark.parametrize("D", [64, 80, 96])
def test_f32_attention_keeps_its_head_on_one_sm(card, D):
    """At N = 192 the f32 instances of K1 and K4 hold a head's 192 queries
    in one block of 12 warps up to heads of 96, one block an SM; the wide
    instance (heads 65 to 96) spills nothing."""
    from probpose_code_torch.ops.kernels.attention import attention_occupancy

    for shift in (True, False):
        o = attention_occupancy(torch.float32, 192, D, shift)
        assert (o["threads"], o["blocks_per_sm"], o["warps_per_sm"]) == (384, 1, 12), o
        if D > 64:
            assert o["local_bytes"] == 0, o


def test_attention_rejects_what_it_does_not_take(card):
    from probpose_code_torch.ops.kernels.attention import attention_kernel

    q, k, v = qkv_views(1, 8, 2, 16, torch.float32, seed=0)
    with pytest.raises(TypeError):
        attention_kernel(q, k, v.bfloat16(), 0.25)
    with pytest.raises(ValueError, match="contiguous"):
        attention_kernel(q.transpose(2, 3), k.transpose(2, 3), v.transpose(2, 3), 0.25)
    big = torch.zeros(1, 8, 1, 4096, device="cuda")
    with pytest.raises(ValueError, match="shared memory"):
        attention_kernel(big, big, big, 1.0)


def test_one_vitpose_train_step_goes_through_k4(card):
    """The ViTPose-B-simple recipe (exact GELU, drop_path 0.3) takes one step
    on the card: each of its twelve layers runs the eager block, whose
    attention is K4; no layer reaches K1 or K3; the losses are finite and the
    first layer gets a gradient."""
    from probpose_code_torch.apis import init_model
    from probpose_code_torch.config import Config
    from probpose_code_torch.engine.optim import build_optimizer
    from probpose_code_torch.parallel import create_train_state, make_train_step

    cfg = Config.fromfile(VITPOSE)
    model = init_model(cfg, device="cuda")
    optimizer, _ = build_optimizer(model, cfg["optim_wrapper"], cfg["param_scheduler"])
    step = make_train_step(model, optimizer)
    counters = kernel_counters()
    for c in counters.values():
        c.launches = 0
    _, metrics = step(create_train_state(model, optimizer), synthetic_train_batch(4, seed=0),
                      torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    assert launches == dict(vit_layer=0, expected_oks=0, oks_convolve=0, vit_layer_train_fwd=0, vit_layer_train_bwd=0,
                            attention=12)
    assert set(metrics) == {"loss_kpt", "acc_pose", "loss", "grad_norm"}
    assert all(torch.isfinite(v).all() for v in metrics.values())
    assert float(metrics["grad_norm"]) > 0
    assert model.module.backbone.layers[0].attn.qkv.weight.grad.abs().max() > 0


def jpeg_fixtures():
    paths = sorted((GOLDEN_JPEG / "formats").glob("*.jpg")) + sorted((GOLDEN_JPEG / "golden").glob("*.jpg"))
    return [p for p in paths if p.stem != "truncated"]


def test_card_decode_matches_the_plain_decoder(card):
    from probpose_code_torch.datasets import jpeg
    from probpose_code_torch.ops.kernels.jpeg import decode_batch

    paths = jpeg_fixtures()
    datas = [p.read_bytes() for p in paths]
    before = decode_batch.launches
    for order in (datas[::-1], datas):  # the second batch's buffer may reuse the first's memory
        out, shapes = decode_batch(order, "cuda")
        for i, ((h, w), data) in enumerate(zip(shapes, order)):
            slot = out[i].cpu().numpy()
            ref = jpeg.decode(data)
            assert (h, w) == ref.shape[:2] and not slot[h:].any() and not slot[:, w:].any()
            np.testing.assert_array_equal(slot[:h, :w], ref)  # EXACT_BARS: bit for bit
    assert EXACT_BARS["max"] == 0 and decode_batch.launches == before + 2


def test_nvjpeg_yardstick_within_its_bars(card):
    from probpose_code_torch.datasets import jpeg
    from probpose_code_torch.ops.kernels.jpeg import decode_batch

    paths = jpeg_fixtures()
    datas = [p.read_bytes() for p in paths]
    infos = [jpeg.probe(d) for d in datas]
    before = decode_batch.launches
    yardstick = NvjpegBatched()
    try:
        out = yardstick.decode(datas, infos).cpu().numpy()
    finally:
        yardstick.close()
    for slot, info, data in zip(out, infos, datas):
        img = jpeg.orient(slot[:info.height, :info.width], info.orientation)
        d = np.abs(img.astype(np.int32) - jpeg.decode(data))
        assert not slot[info.height:].any() and not slot[:, info.width:].any()
        assert d.max() <= NVJPEG_BARS["max"] and np.percentile(d, 99) <= NVJPEG_BARS["p99"]
        assert d.mean() <= NVJPEG_BARS["mean"]
    assert decode_batch.launches == before  # the yardstick is no launch of the port's decode


def test_card_decode_refuses_a_truncated_stream(card):
    from probpose_code_torch.datasets.jpeg import probe
    from probpose_code_torch.ops.kernels.jpeg import decode_batch

    data = (GOLDEN_JPEG / "formats" / "truncated.jpg").read_bytes()
    with pytest.raises(ValueError, match="truncated"):
        decode_batch([data], "cuda", ["truncated.jpg"])
    whole = probe((GOLDEN_JPEG / "formats" / "restart.jpg").read_bytes())  # the header it was cut from
    with pytest.raises(ValueError, match="truncated.jpg"):  # past the probe, the host decoder refuses it too
        decode_batch([data], "cuda", ["truncated.jpg"], infos=[whole])


def test_val_path_reads_jpeg_on_the_card(card, tmp_path):
    from probpose_code_torch.datasets.loader import HOST_KEYS, DataLoader, stop_workers
    from probpose_code_torch.engine.checkpoint import load_checkpoint
    from probpose_code_torch.engine.runner import Runner
    from probpose_code_torch.ops.kernels.jpeg import decode_batch

    _, ann = golden_jpeg_set(tmp_path)
    runner = Runner.from_cfg(golden_val_cfg(TINY_CFG["model"], ann, batch_size=16, num_workers=2))
    load_checkpoint(runner.model, str(GOLDEN / "e2e_weights.pth"))
    before = decode_batch.launches
    try:
        metrics = runner.val()
    finally:
        stop_workers()
    assert decode_batch.launches == before + 4 and runner.val_times["decode"] > 0
    assert np.isfinite(metrics["coco/AP"]) and np.isfinite(metrics["coco/Ex_AP"])

    batch = next(iter(DataLoader(runner.val_dataset, 16, num_workers=0)))
    on_cpu = {k: torch.from_numpy(v) for k, v in batch.items() if isinstance(v, np.ndarray)}
    on_cpu.update({k: batch[k] for k in HOST_KEYS if k in batch})
    want = runner.model.device_preprocess_batch(on_cpu)["inputs"]  # the plain decoder
    got = runner.device_batch(batch)["inputs"]
    assert got.is_cuda and (got.cpu() - want).abs().max() <= 1.0  # the same pixels, the warp within one level


def test_serve_on_the_card(card):
    import json
    import threading
    import urllib.request

    from probpose_code_torch.apis import inference_topdown, init_model
    from probpose_code_torch.tools import serve

    model = init_model(TINY_CFG, checkpoint=str(GOLDEN / "e2e_weights.pth"))
    server = serve.make_server(model, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        path = GOLDEN_JPEG / "golden" / "5.jpg"
        req = urllib.request.Request(f"http://127.0.0.1:{server.server_port}/predict", data=path.read_bytes())
        with urllib.request.urlopen(req, timeout=120) as r:
            assert r.status == 200
            answer = json.loads(r.read())
        want = serve.payload(inference_topdown(model, str(path)))
        for a, b in zip(answer, want, strict=True):  # the card's predict varies in the last bits (chip_smoke)
            np.testing.assert_allclose(a["keypoints"], b["keypoints"], rtol=0, atol=SERVE_KPT_ATOL)
            np.testing.assert_allclose(a["keypoint_scores"], b["keypoint_scores"], rtol=0, atol=SERVE_SCORE_ATOL)
    finally:
        server.shutdown()
        server.server_close()
        thread.join()



def _twins(cfg):
    """The same model (seed-0 weights) on the card and on the CPU."""
    from probpose_code_torch.apis import init_model

    return init_model(cfg, device="cuda"), init_model(cfg, device="cpu")


def test_dpm_predict_on_the_card_matches_the_cpu(card):
    """Flip-TTA predict of the tiny DoubleProbPose model in f32: K1 x2 and K2
    once (both windows) a call; the maps at K1's f32 bar, the scalar outputs
    within 1e-4. The keypoints are not compared (random-weight maps are flat,
    and the last bits move their argmax): K2's launch at the identity scale,
    the route that decodes both windows, is held on peaked maps of the
    predict's (2B, K, H, W) shape instead."""
    from probpose_code_torch.ops.decode import heatmap_expected_value_batch
    from probpose_code_torch.ops.kernels.expected_oks import expected_oks_decode

    gpu, cpu = _twins(tiny_dpm_cfg())
    crops = torch.from_numpy(synthetic_dpm_batch(3, seed=1)["inputs"])
    counters = kernel_counters()
    for c in counters.values():
        c.launches = 0
    got = {k: v.cpu() for k, v in gpu.predict(crops.cuda()).items()}
    torch.cuda.synchronize()
    assert {k: c.launches for k, c in counters.items()} == dict(
        vit_layer=2, expected_oks=1, oks_convolve=0, vit_layer_train_fwd=0, vit_layer_train_bwd=0, attention=0)
    want = cpu.predict(crops)
    assert set(got) == set(want)
    for k in ("heatmaps", "out_heatmaps"):
        assert ((got[k] - want[k]).abs().max() / want[k].abs().max()).item() < K1_F32_REL, k
    for k in ("keypoints_probs", "keypoints_visible", "keypoints_oks", "keypoints_error"):
        assert (got[k] - want[k]).abs().max().item() < 1e-4, k
    maps = peaked_heatmaps(2 * len(crops), 17, 64, 48, seed=3)
    locs, vals = expected_oks_decode(torch.from_numpy(maps).cuda(), None)
    locs_p, vals_p = heatmap_expected_value_batch(torch.from_numpy(maps))
    assert locs.shape == (2 * len(crops), 17, 2)
    assert (locs.cpu() - locs_p).abs().max().item() < K2_LOCS_ATOL
    assert (vals.cpu() - vals_p).abs().max().item() < K2_VALS_ATOL


def test_dpm_train_step_on_the_card_matches_the_cpu(card):
    """One DoubleProbPose step of the tiny model from a batch as its pipeline
    ships it (both windows' maps and the bbox mask rendered on the device):
    K3 x2 forward and backward, the loss dict within 1e-3 of the CPU's (the
    card's convolutions may use TF32), finite, a gradient in both towers."""
    from probpose_code_torch.engine.optim import build_optimizer
    from probpose_code_torch.parallel import create_train_state, make_train_step

    batch = synthetic_dpm_batch(4, seed=2)
    metrics = {}
    for model in _twins(tiny_dpm_cfg()):
        device = model.device
        optimizer, _ = build_optimizer(model, dict(optimizer=dict(type="AdamW", lr=1e-3, weight_decay=0.1)))
        counters = kernel_counters()
        for c in counters.values():
            c.launches = 0
        _, m = make_train_step(model, optimizer)(
            create_train_state(model, optimizer), {k: torch.from_numpy(v).to(device) for k, v in batch.items()},
            torch.Generator(device=device).manual_seed(0))
        metrics[device.type] = {k: float(v) for k, v in m.items()}
        if device.type == "cuda":
            torch.cuda.synchronize()
            assert {k: c.launches for k, c in counters.items()} == dict(
                vit_layer=0, expected_oks=0, oks_convolve=0, vit_layer_train_fwd=2, vit_layer_train_bwd=2,
                attention=0)
            for tower in ("first_head", "second_head"):
                assert getattr(model.module.head, tower).final_layer.weight.grad.abs().max() > 0
    assert {"loss_kpt", "loss_kpt2", "acc_pose1", "acc_pose2"} <= set(metrics["cuda"])
    for k, v in metrics["cpu"].items():
        assert np.isfinite(metrics["cuda"][k]) and metrics["cuda"][k] == pytest.approx(v, rel=1e-3, abs=1e-5), k


def test_bbox_mask_on_the_card_matches_numpy(card):
    from probpose_code_torch.ops.bbox_mask import render_bbox_mask, render_bbox_mask_numpy

    batch = synthetic_dpm_batch(64, seed=3)
    rects, mats = batch["bbox_mask_rect"], batch["bbox_mask_mat"]
    want = render_bbox_mask_numpy(rects, mats, (192, 256))
    got = render_bbox_mask(torch.from_numpy(rects).cuda(), torch.from_numpy(mats).cuda(), (192, 256))
    assert got.is_cuda and got.dtype == torch.uint8
    assert 0 < want.mean() < 1
    np.testing.assert_array_equal(got.cpu().numpy(), want)


def test_one_hrnet_train_step_on_the_card(card):
    """The tiny HRNet + UDP fixture model takes one plain-Adam step on the
    card (UDP targets encoded there), TF32 off: no kernel of the port, the
    loss within ``HRNET_REL`` of the CPU's, the gradient norm within 1e-3."""
    from probpose_code_torch.engine.optim import build_optimizer
    from probpose_code_torch.models.builder import full_f32_precision
    from probpose_code_torch.parallel import create_train_state, make_train_step

    metrics = {}
    for model in _twins(UDP_FIXTURE_CFG):
        batch = synthetic_train_batch(4, seed=4) if model.device.type == "cuda" else {
            k: v.cpu() for k, v in synthetic_train_batch(4, seed=4).items()}
        optimizer, _ = build_optimizer(model, dict(optimizer=dict(type="Adam", lr=5e-4)))
        counters = kernel_counters()
        for c in counters.values():
            c.launches = 0
        with full_f32_precision():
            _, m = make_train_step(model, optimizer)(create_train_state(model, optimizer), batch,
                                                     torch.Generator(device=model.device).manual_seed(0))
        metrics[model.device.type] = {k: float(v) for k, v in m.items()}
        assert all(c.launches == 0 for c in counters.values())
    assert metrics["cuda"]["loss"] == pytest.approx(metrics["cpu"]["loss"], rel=HRNET_REL)
    assert metrics["cuda"]["grad_norm"] == pytest.approx(metrics["cpu"]["grad_norm"], rel=1e-3)


def _encode_cases(seed, n=8, lo=(-10, -10), hi=(58, 74)):
    """(n, 17, 2) keypoints (some on .5 boundaries, some outside) and visibility."""
    rng = np.random.RandomState(seed)
    kpts = np.stack([rng.uniform(lo[0], hi[0], (n, 17)), rng.uniform(lo[1], hi[1], (n, 17))], -1)
    kpts[:, :5] = np.round(kpts[:, :5]) + 0.5
    return kpts, (rng.rand(n, 17) > 0.2).astype(np.float32)


@pytest.mark.parametrize("unbiased", [False, True], ids=["msra", "unbiased"])
def test_msra_gaussians_on_the_card_match_the_codec(card, unbiased):
    """``generate_gaussian_device`` / ``generate_unbiased_gaussian_device`` on
    the card against the port's host codec (``codecs/utils/
    gaussian_heatmap.py``), instance by instance: atol 1e-6 (the last bit
    of exp), the test's weights equal to the codec's."""
    from probpose_code_torch.codecs.utils.gaussian_heatmap import (
        gaussian_weights,
        generate_gaussian_heatmaps,
        generate_unbiased_gaussian_heatmaps,
    )
    from probpose_code_torch.ops.encode import generate_gaussian_device, generate_unbiased_gaussian_device

    kpts, vis = _encode_cases(seed=1 + unbiased)
    host = generate_unbiased_gaussian_heatmaps if unbiased else generate_gaussian_heatmaps
    device = generate_unbiased_gaussian_device if unbiased else generate_gaussian_device
    got = device(torch.from_numpy(kpts).cuda(), torch.from_numpy(vis).cuda(), (48, 64), 2.0).cpu().numpy()
    for n in range(len(kpts)):
        want, weights = host((48, 64), kpts[n:n + 1], vis[n:n + 1], 2.0)
        np.testing.assert_allclose(got[n], want, atol=1e-6, err_msg=str(n))
        np.testing.assert_array_equal(weights, gaussian_weights((48, 64), kpts[n:n + 1], vis[n:n + 1], 2.0, unbiased))


@pytest.mark.parametrize("smoothing, normalize", [("gaussian", False), ("gaussian", True), ("standard", False)])
def test_simcc_labels_on_the_card_match_the_codec(card, smoothing, normalize):
    """``generate_simcc_labels_device`` on the card against the port's host
    codec (``codecs/simcc_label.py``): atol 1e-6."""
    from probpose_code_torch.codecs.simcc_label import SimCCLabel
    from probpose_code_torch.ops.encode import generate_simcc_labels_device

    sigma = (4.9, 5.66) if smoothing == "gaussian" else 6.0
    codec = SimCCLabel((192, 256), smoothing, sigma, 2.0, normalize=normalize)
    kpts, vis = _encode_cases(seed=3, lo=(-20, -20), hi=(212, 276))
    kpts = kpts.astype(np.float32) / 2  # bins on .5: half to even
    want = codec.encode(kpts, vis)
    x, y = generate_simcc_labels_device(torch.from_numpy(codec.bins(kpts).astype(np.float32)).cuda(),
                                        torch.from_numpy(vis).cuda(), (192, 256), 2.0, sigma, smoothing, normalize)
    np.testing.assert_allclose(x.cpu().numpy(), want["keypoint_x_labels"], atol=1e-6)
    np.testing.assert_allclose(y.cpu().numpy(), want["keypoint_y_labels"], atol=1e-6)


@pytest.mark.parametrize("name", ["classic", "rtmpose"])
def test_model_fixtures_on_the_card(card, name):
    """``chip_smoke.model_fixture_report`` on the card: the JAX package's
    keypoints, scores and AP at ``UDP_BARS``, its maps or vectors on the
    fixture's crops at ``FIXTURE_OUTPUT_REL``; no kernel of the port."""
    from chip_smoke import CLASSIC_FIXTURE, RTMPOSE_FIXTURE, model_fixture_report

    counters = kernel_counters()
    for c in counters.values():
        c.launches = 0
    report = model_fixture_report(CLASSIC_FIXTURE if name == "classic" else RTMPOSE_FIXTURE, device="cuda")
    assert report["ok"], report
    assert all(c.launches == 0 for c in counters.values())


@pytest.mark.parametrize("shape", [(3, 256, 192), (2, 17, 13), (1, 1, 5), (4, 7, 300)])
def test_photometric_kernels_match_plain(card, shape):
    """The card's photometric forms against their plain versions on noise
    crops, exactly: the median kernel of ``csrc/photometric.cu`` on the
    crop's shape and odd sides, one-pixel rows (its replicated border on
    every side), rows wider than a block, each k it takes and a k it
    refuses; the HSV jitter through its tables on each shape cut to a width
    cv2 converts in whole blocks, and its refusal of any other width."""
    from probpose_code_torch.ops import photometric as plain
    from probpose_code_torch.ops.kernels import photometric

    rng = np.random.RandomState(sum(shape))
    img = torch.from_numpy(rng.randint(0, 256, (*shape, 3)).astype(np.float32)).cuda()
    gains = torch.from_numpy((rng.uniform(-1, 1, (shape[0], 3)) * [5, 30, 30]).astype(np.int16)).cuda()
    width = shape[2] - shape[2] % plain.HSV_ROW_BLOCK
    if width:
        assert torch.equal(photometric.yolox_hsv(img[:, :, :width], gains), plain.yolox_hsv(img[:, :, :width], gains))
    if width != shape[2]:
        with pytest.raises(ValueError, match=f"width of {shape[2]}"):
            photometric.yolox_hsv(img, gains)
    before = photometric.median_blur.launches
    for k in photometric.MEDIAN_KSIZES:
        assert torch.equal(photometric.median_blur(img, k), plain.median_blur(img, k)), k
    assert photometric.median_blur.launches == before + len(photometric.MEDIAN_KSIZES)
    with pytest.raises(ValueError, match="k in"):
        photometric.median_blur(img, 9)
    with pytest.raises(ValueError, match="float32"):
        photometric.median_blur(img.double(), 3)


@pytest.mark.parametrize("order", ["body8", "halpe26"])
def test_photometric_distortion_matches_plain(card, order):
    """``PhotometricDistortion``'s kernel (its float32 steps around the
    tables) against its plain version on a batch of 64 noise crops with
    black rows (hue 0), under rows drawn by the worker half, every 16th
    turning hue 0 into 180, exactly: after the HSV jitter (the body8
    recipes' order) or on the crops (the halpe26 recipes'), through
    ``augment``, one launch; a width off cv2's blocks and rows of another
    shape refused; the hue step's remainder against NumPy's on every
    integer hue and a sweep of deltas."""
    from chip_smoke import photometric_fixture_params
    from probpose_code_torch.ops import photometric as plain
    from probpose_code_torch.ops.kernels import photometric

    rng = np.random.RandomState(3)
    crops = rng.randint(0, 256, (64, 256, 192, 3)).astype(np.float32)
    crops[:, :32] = 0
    img = torch.from_numpy(crops).cuda()
    rows = torch.from_numpy(photometric_fixture_params(64, seed=1)).cuda()
    gains = torch.from_numpy((rng.uniform(-1, 1, (64, 3)) * [5, 30, 30]).astype(np.int16)).cuda()
    extra = dict(hsv_gains=gains) if order == "body8" else {}
    want = plain.photometric_distortion(plain.yolox_hsv(img, gains) if extra else img, rows)
    before = photometric.photometric_distortion.launches
    assert torch.equal(photometric.augment(img, photometric=rows, **extra), want)
    assert photometric.photometric_distortion.launches == before + 1
    with pytest.raises(ValueError, match="width of 190"):
        photometric.photometric_distortion(img[:, :, :190], rows)
    with pytest.raises(ValueError, match=r"\(64, 8\) rows"):
        photometric.photometric_distortion(img, rows[:, :5])
    hue = np.arange(180, dtype=np.float32)[:, None]
    deltas = np.concatenate([rng.uniform(-18, 18, 20000).astype(np.float32), np.float32([-1e-6, -7.6e-6, 0, 18])])
    got = plain.numpy_remainder(torch.from_numpy(hue + deltas).cuda(), 180.0).cpu().numpy()
    np.testing.assert_array_equal(got, (hue + deltas) % np.float32(180))


def test_augment_fixture_on_the_card(card):
    """``chip_smoke.augment_fixture_report`` on the card: cv2's bytes for
    the fixture's batch, every colour, every HSV triple and the window-sum
    tiles."""
    from chip_smoke import augment_fixture_report

    report = augment_fixture_report("cuda")
    assert report["ok"], report


@pytest.mark.parametrize("B,n,e,s", [(64, 133, 512, 128), (3, 70, 24, 8), (1, 1, 40, 20), (2, 65, 68, 36)])
def test_gau_kernels_match_plain(card, B, n, e, s):
    """The GAU kernels against their plain twin (torch autograd for the
    gradients) at the whole-body step's shape and at token counts and widths
    that leave ragged tiles, at ``chip_smoke.py``'s bars; the backward
    repeats bit for bit, each call counts one launch."""
    from probpose_code_torch.ops.kernels import gau

    rng = np.random.RandomState(B + n + e)
    z, gamma, beta, dout = (torch.from_numpy(a.astype(np.float32)).cuda() for a in (
        rng.randn(B, n, 2 * e + s), rng.rand(2, s), 0.1 * rng.randn(2, s), rng.randn(B, n, e)))
    before = (gau.gau_forward.launches, gau.gau_backward.launches)
    out, saved = gau.gau_forward(z, gamma, beta, e, s)
    grads = gau.gau_backward(dout, z, gamma, saved, e, s)
    again = gau.gau_backward(dout, z, gamma, saved, e, s)
    assert (gau.gau_forward.launches, gau.gau_backward.launches) == (before[0] + 1, before[1] + 2)
    leaves = [a.clone().requires_grad_() for a in (z, gamma, beta)]
    ref = gau.gau_attention_plain(*leaves, e, s)
    ref_grads = torch.autograd.grad(ref, leaves, dout)
    assert float((out - ref.detach()).abs().max() / ref.detach().abs().max()) < GAU_REL
    for g, r in zip(grads, ref_grads):
        assert float((g - r).abs().max() / r.abs().max()) < GAU_GRAD_REL
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


def test_gau_refuses_what_the_kernels_do_not_take(card):
    from probpose_code_torch.ops.kernels import gau

    z = torch.randn(2, 5, 2 * 8 + 4, device="cuda")
    gamma, beta = torch.rand(2, 4, device="cuda"), torch.zeros(2, 4, device="cuda")
    with pytest.raises(NotImplementedError):
        gau.gau_attention(z, gamma, beta, 8, 4, rel_bias=torch.zeros(5, 5, device="cuda"))
    with pytest.raises(NotImplementedError):
        gau.gau_attention(z, gamma, beta, 8, 4, pos_enc=True)
    with pytest.raises(NotImplementedError):
        gau.gau_attention(z, gamma, beta, 8, 4, act_fn="ReLU")
    with pytest.raises(ValueError, match="float32"):
        gau.gau_forward(z.double(), gamma, beta, 8, 4)
    with pytest.raises(ValueError, match="gamma"):
        gau.gau_forward(z, gamma[:, :3], beta, 8, 4)
    with pytest.raises(ValueError, match="multiples of 4"):
        gau.gau_forward(torch.randn(2, 5, 2 * 6 + 4, device="cuda"), gamma, beta, 6, 4)


def test_rtmcc_block_on_the_card_goes_through_the_gau_kernels(card):
    """RTMPose's GAU block at the shipped widths over 133 tokens on the card
    (one forward and one backward launch): its output and its parameters'
    gradients against the same block on the CPU, at ``GAU_GRAD_REL``."""
    from probpose_code_torch.models.utils.rtmcc_block import RTMCCBlock
    from probpose_code_torch.ops.kernels import gau

    torch.manual_seed(0)
    block = RTMCCBlock(133, 256, 256, s=128, act_fn="SiLU", use_rel_bias=False)
    x = torch.randn(4, 133, 256)
    cpu_out = block(x)
    cpu_out.sum().backward()
    cpu_grads = [p.grad.clone() for p in block.parameters()]
    block.zero_grad()
    block.cuda()
    before = (gau.gau_forward.launches, gau.gau_backward.launches)
    out = block(x.cuda())
    out.sum().backward()
    assert (gau.gau_forward.launches, gau.gau_backward.launches) == (before[0] + 1, before[1] + 1)
    assert float((out.detach().cpu() - cpu_out.detach()).abs().max() / cpu_out.abs().max()) < GAU_GRAD_REL
    for p, g in zip(block.parameters(), cpu_grads):
        assert float((p.grad.cpu() - g).abs().max() / g.abs().max()) < GAU_GRAD_REL


@pytest.mark.parametrize("B,C,H,W,stride", [(4, 96, 64, 64, 2), (3, 36, 17, 9, 1), (2, 44, 9, 14, 2), (1, 4, 1, 1, 1)])
def test_depthwise_kernels_match_plain(card, B, C, H, W, stride):
    """The depthwise 3x3 kernels against ``F.conv2d`` with one group a
    channel (torch autograd for the gradients), TF32 off, at
    ``chip_smoke.py``'s bars, on channels-last and contiguous inputs; the
    backward repeats bit for bit, each call counts one launch."""
    from probpose_code_torch.models.builder import full_f32_precision
    from probpose_code_torch.ops.kernels import depthwise as dw

    rng = np.random.RandomState(B + C + H + W)
    x, w = (torch.from_numpy(a.astype(np.float32)).cuda() for a in (rng.randn(B, C, H, W), rng.randn(C, 1, 3, 3)))
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    dy = torch.from_numpy(rng.randn(B, C, Ho, Wo).astype(np.float32)).cuda()
    for inputs in (x, x.contiguous(memory_format=torch.channels_last)):
        before = (dw.depthwise_forward.launches, dw.depthwise_backward.launches)
        y = dw.depthwise_conv3x3(inputs, w, stride)
        grads = dw.depthwise_backward(dy, inputs, w, stride)
        again = dw.depthwise_backward(dy, inputs, w, stride)
        assert (dw.depthwise_forward.launches, dw.depthwise_backward.launches) == (before[0] + 1, before[1] + 2)
        leaves = [inputs.clone().requires_grad_(), w.clone().requires_grad_()]
        with full_f32_precision():
            ref = dw.depthwise_conv3x3_plain(*leaves, stride)
            ref_grads = torch.autograd.grad(ref, leaves, dy)
        assert y.shape == ref.shape and float((y - ref).abs().max() / ref.abs().max()) < DEPTHWISE_REL
        for g, r in zip(grads, ref_grads):
            assert float((g - r).abs().max() / r.abs().max()) < DEPTHWISE_GRAD_REL
        assert all(torch.equal(a, b) for a, b in zip(grads, again))
    with pytest.raises(ValueError, match="multiples of 4"):
        dw.depthwise_forward(torch.zeros(1, 6, 4, 4, device="cuda"), torch.zeros(6, 1, 3, 3, device="cuda"), 1)


@pytest.mark.parametrize("weighted", [True, False])
def test_adaptive_wing_kernels_match_plain(card, weighted):
    """``AdaptiveWingLoss`` on the card (its kernels, through autograd)
    against its plain twin on the CPU, at ``AWING_REL``, maps of 5 x 98 x
    17 x 23 with errors on both sides of ``theta`` and some exactly 0."""
    from probpose_code_torch.ops.kernels import adaptive_wing as aw
    from probpose_code_torch.registry import MODELS

    rng = np.random.RandomState(3)
    target = rng.rand(5, 98, 17, 23).astype(np.float32)
    output = (target + rng.randn(*target.shape) * rng.choice([0.05, 0.9], target.shape)).astype(np.float32)
    output[0, 0] = target[0, 0]
    weights = (rng.rand(5, 98) > 0.2).astype(np.float32)
    loss = MODELS.build(dict(type="AdaptiveWingLoss", use_target_weight=weighted, loss_weight=0.5))
    results = []
    for device in ("cpu", "cuda"):
        o = torch.from_numpy(output).to(device).requires_grad_()
        value = loss(o, torch.from_numpy(target).to(device), torch.from_numpy(weights).to(device))
        (2 * value).backward()
        results.append((value.detach().cpu(), o.grad.cpu()))
    (ref, ref_grad), (got, grad) = results
    assert float((got - ref).abs() / ref.abs()) < AWING_REL
    assert float((grad - ref_grad).abs().max() / ref_grad.abs().max()) < AWING_REL
    assert aw.adaptive_wing_forward.launches and aw.adaptive_wing_backward.launches


@pytest.mark.parametrize("B,C,H,W,r", [(2, 3, 17, 13, 4), (1, 5, 64, 48, 4), (3, 2, 9, 7, 2), (2, 4, 33, 25, 3),
                                       (1, 1, 4, 4, 4), (2, 7, 8, 6, 4)])
def test_sc_gate_kernels_match_plain(card, B, C, H, W, r):
    """SCNet's gate on the card (its kernels, through autograd) against its
    plain twin on the CPU: the output at ``SC_GATE_REL``, the gradients of
    x, k2 and k3 at ``SC_GATE_GRAD_REL``, the backward bit for bit across two
    runs."""
    from probpose_code_torch.ops.kernels import sc_gate

    rng = np.random.RandomState(100 * B + H)
    x, k3, dy = (torch.from_numpy(rng.randn(B, C, H, W).astype(np.float32)) for _ in range(3))
    k2 = torch.from_numpy(rng.randn(B, C, H // r, W // r).astype(np.float32))
    results = []
    for device in ("cpu", "cuda"):
        leaves = [t.to(device).requires_grad_() for t in (x, k2, k3)]
        out = sc_gate.self_calibration(*leaves)
        results.append([t.detach().cpu() for t in (out, *torch.autograd.grad(out, leaves, dy.to(device)))])
    for i, (got, ref) in enumerate(zip(results[1], results[0])):
        assert float((got - ref).abs().max() / ref.abs().max()) < (SC_GATE_REL if i == 0 else SC_GATE_GRAD_REL), i
    cuda = [t.cuda() for t in (dy, x, k2, k3)]
    first, second = sc_gate.sc_gate_backward(*cuda), sc_gate.sc_gate_backward(*cuda)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    assert sc_gate.sc_gate_forward.launches and sc_gate.sc_gate_backward.launches


def test_sc_gate_rejects_what_it_does_not_take(card):
    from probpose_code_torch.ops.kernels import sc_gate

    x = torch.zeros(1, 2, 8, 8, device="cuda")
    with pytest.raises(ValueError):
        sc_gate.sc_gate_forward(x, torch.zeros(1, 2, 9, 2, device="cuda"), x)
    with pytest.raises(ValueError):
        sc_gate.sc_gate_forward(x.double(), torch.zeros(1, 2, 2, 2, device="cuda").double(), x.double())


@pytest.mark.parametrize("B,R,C,H,W", [(2, 2, 64, 64, 48), (3, 2, 5, 8, 6), (1, 1, 7, 9, 13), (2, 3, 4, 17, 23),
                                       (1, 4, 3, 2, 2), (4, 2, 512, 8, 6)])
def test_split_attention_kernels_match_plain(card, B, R, C, H, W):
    """ResNeSt's split attention on the card (its kernels, through autograd)
    against its plain twin on the CPU: the output at
    ``SPLIT_ATTENTION_REL``, the gradients of the splits and the logits at
    ``SPLIT_ATTENTION_GRAD_REL``, the backward bit for bit across two runs."""
    from probpose_code_torch.ops.kernels import split_attention as sa

    rng = np.random.RandomState(10 * R + H)
    splits = torch.from_numpy(rng.randn(B, R, C, H, W).astype(np.float32))
    logits = torch.from_numpy(rng.randn(B, R, C).astype(np.float32))
    dy = torch.from_numpy(rng.randn(B, C, H, W).astype(np.float32))
    results = []
    for device in ("cpu", "cuda"):
        leaves = [t.to(device).requires_grad_() for t in (splits, logits)]
        out = sa.split_attention(*leaves)
        results.append([t.detach().cpu() for t in (out, *torch.autograd.grad(out, leaves, dy.to(device)))])
    for i, (got, ref) in enumerate(zip(results[1], results[0])):
        bar = SPLIT_ATTENTION_REL if i == 0 else SPLIT_ATTENTION_GRAD_REL
        assert float((got - ref).abs().max() / ref.abs().max()) < bar, i
    cuda = [t.cuda() for t in (dy, splits, logits)]
    first, second = sa.split_attention_backward(*cuda), sa.split_attention_backward(*cuda)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    assert sa.split_attention_forward.launches and sa.split_attention_backward.launches


def test_split_attention_rejects_what_it_does_not_take(card):
    from probpose_code_torch.ops.kernels import split_attention as sa

    with pytest.raises(ValueError):
        sa.split_attention_forward(torch.zeros(1, 5, 2, 4, 4, device="cuda"), torch.zeros(1, 5, 2, device="cuda"))
    with pytest.raises(ValueError):
        sa.split_attention_forward(torch.zeros(1, 2, 2, 4, 4, device="cuda"), torch.zeros(1, 2, 3, device="cuda"))
