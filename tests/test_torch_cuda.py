"""The CUDA kernels against their plain twins, on the card.

These tests need an NVIDIA card with the CUDA toolkit; elsewhere they skip.
They import no JAX, so they run where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

They cover shapes beyond the ones that ``chip_smoke.py`` holds: ragged
tiles, head widths of 8 and above 128, maps whose filter needs more than
48 KB of shared memory, and flat maps whose argmax is a tie; K1 and K3
forward and backward at those shapes and at the flagship layer's widths,
with and without stochastic-depth masks; in bf16 and f32 also MLP widths
that are not a multiple of 8, keys streamed through shared memory and the
widest heads (in f32 also a wide head whose keys are streamed); K3's
gradients bitwise equal across two runs (no atomics); a bf16 head too wide
for shared memory refused; one train step of the tiny config through K3;
K4 on strided and contiguous inputs, ragged N, head widths from 8 to 824,
and keys beyond the one-pass instance (two passes, streamed); and one
ViTPose-B-simple train step, whose twelve layers run K4 and not K3.
Bars are ``chip_smoke.py``'s, with its reasons.
"""

import numpy as np
import pytest
import torch

from chip_smoke import (
    GOLDEN,
    K4_BF16_REL,
    K4_F32_ATOL,
    VITPOSE,
    K1_BF16_REL,
    K1_F32_REL,
    K2_CONV_ATOL,
    K2_LOCS_ATOL,
    K2_VALS_ATOL,
    K3_BF16_REL,
    K3_F32_FWD,
    K3_F32_GRAD,
    TINY_CFG,
    golden_errors,
    golden_samples,
    k3_errors,
    kernel_counters,
    layer_inputs,
    peaked_heatmaps,
    qkv_views,
    synthetic_train_batch,
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


@pytest.mark.parametrize("B,K,H,W", [(5, 17, 64, 48), (2, 17, 128, 96), (3, 4, 32, 24)])
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


# one pass (N <= 192, d <= 64); two passes with K and V whole in shared memory
# (1, 200, 2, 160) or streamed: keys beyond it (1, 1024, 2, 64), and a head
# of 824 (1, 40, 1, 824)
@pytest.mark.parametrize("B,N,H,D", [(2, 192, 12, 64), (3, 37, 5, 8), (1, 200, 2, 160), (2, 16, 3, 36),
                                     (1, 1024, 2, 64), (1, 40, 1, 824)])
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


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_attention_repeats_bit_for_bit(card, dtype):
    """K4 at the ViTPose-B train step's shape gives the same bits on every
    launch: a race between the warps of a block would show as a change."""
    from probpose_code_torch.ops.kernels.attention import attention_kernel

    q, k, v = qkv_views(4, 192, 12, 64, getattr(torch, dtype), seed=3)
    first = attention_kernel(q, k, v, 0.125)
    for _ in range(50):
        assert torch.equal(attention_kernel(q, k, v, 0.125), first)


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
