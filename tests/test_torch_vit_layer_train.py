"""K3's plain twin against the JAX differentiable layer, and the layer routing.

``vit_layer_train`` on CPU tensors (the plain twin, differentiated by torch
autograd) against ``probpose_code_tpu.ops.pallas.vit_layer_train:
vit_layer_train`` in interpret mode, on the same numpy inputs at B, N, C, H,
F = 4, 16, 64, 4, 128 in f32, with and without stochastic-depth masks.

Bars are the JAX package's own (``tests/test_ops/test_vit_layer_train.py:
81,101``): forward rtol = atol = 2e-4, dx and the twelve parameter gradients
rtol = atol = 5e-4. Both sides compute in f32 and differ in summation order
(and the clamped softmax against the same math), about 1e-6 here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probpose_code_torch.models.backbones import vit as vit_module
from probpose_code_torch.models.backbones.vit import VisionTransformer
from probpose_code_torch.ops.kernels import vit_layer as k1
from probpose_code_torch.ops.kernels import vit_layer_train as k3
from probpose_code_tpu.ops.pallas.vit_layer_train import vit_layer_train as jax_vit_layer_train

B, N, C, H, F = 4, 16, 64, 4, 128
NAMES = ("ln1_scale", "ln1_bias", "w_qkv", "b_qkv", "w_proj", "b_proj",
         "ln2_scale", "ln2_bias", "w_fc1", "b_fc1", "w_fc2", "b_fc2")
MASKS = (np.array([0.0, 1 / 0.9, 1.0, 1 / 0.9], np.float32), np.array([1 / 0.9, 1.0, 0.0, 1 / 0.9], np.float32))


def _inputs(seed=0):
    rng = np.random.RandomState(seed)

    def r(*s, base=0.0):
        return (base + 0.05 * rng.randn(*s)).astype(np.float32)

    x = rng.randn(B, N, C).astype(np.float32)
    g = rng.randn(B, N, C).astype(np.float32)
    params = [r(C, base=1.0), r(C), r(C, 3 * C), r(3 * C), r(C, C), r(C),
              r(C, base=1.0), r(C), r(C, F), r(F), r(F, C), r(C)]
    return x, g, params


@pytest.mark.parametrize("masked", [False, True])
def test_twin_matches_jax_forward_and_gradients(masked):
    x, g, params = _inputs()
    m1, m2 = MASKS if masked else (None, None)

    def jax_loss(x_, *p):
        out = jax_vit_layer_train(
            x_, *p, None if m1 is None else jnp.asarray(m1), None if m2 is None else jnp.asarray(m2),
            num_heads=H, dtype=jnp.float32,
        )
        return jnp.sum(out * g), out

    (_, want), jgrads = jax.value_and_grad(jax_loss, argnums=tuple(range(13)), has_aux=True)(
        jnp.asarray(x), *[jnp.asarray(p) for p in params])

    tx = torch.from_numpy(x).requires_grad_(True)
    tp = [torch.from_numpy(p).requires_grad_(True) for p in params]
    got = k3.vit_layer_train(
        tx, *tp, None if m1 is None else torch.from_numpy(m1), None if m2 is None else torch.from_numpy(m2),
        num_heads=H, dtype=torch.float32,
    )
    tgrads = torch.autograd.grad(got, [tx, *tp], torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)
    for name, gt, gj in zip(("x",) + NAMES, tgrads, jgrads):
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=5e-4, atol=5e-4, err_msg=name)


def test_wrapper_takes_cpu_tensors_to_the_plain_twin():
    x, _, params = _inputs(1)
    args = [torch.from_numpy(x)] + [torch.from_numpy(p) for p in params]
    before = (k3.vit_layer_train_forward.launches, k3.vit_layer_train_backward.launches)
    got = k3.vit_layer_train(*args, num_heads=H, dtype=torch.float32)
    want = k3.vit_layer_train_plain(*args, num_heads=H, dtype=torch.float32)
    assert torch.equal(got, want)
    assert (k3.vit_layer_train_forward.launches, k3.vit_layer_train_backward.launches) == before


def test_wrapper_rejects_what_the_kernel_does_not_take():
    _, _, params = _inputs(2)
    w = [torch.from_numpy(p) for p in params]
    with pytest.raises(ValueError, match="K3 rule"):
        k3.vit_layer_train(torch.zeros(2, 12, C), *w, num_heads=H)  # N % 8 != 0
    with pytest.raises(ValueError, match="unsupported device"):
        k3.vit_layer_train(torch.empty(2, 16, C, device="meta"), *[t.to("meta") for t in w], num_heads=H)


def test_k1_refuses_a_call_under_autograd_off_the_cpu():
    """K1 fills its output through ctypes, so a result under autograd would
    carry no gradient: off the CPU it raises instead (a meta tensor stands in
    for the card's). On the CPU its twin is differentiable and runs."""
    _, _, params = _inputs(3)
    w = [torch.from_numpy(p).to("meta").requires_grad_(True) for p in params]
    prepared = k1.prepare_weights(*w, num_heads=H, dtype=torch.float32)
    x = torch.empty(2, 16, C, device="meta")
    with pytest.raises(RuntimeError, match="no backward"):
        k1.vit_layer_prepared(x, prepared, num_heads=H, dtype=torch.float32)
    with torch.no_grad():
        prepared = k1.prepare_weights(*w, num_heads=H, dtype=torch.float32)
        with pytest.raises(ValueError, match="unsupported device"):
            k1.vit_layer_prepared(x, prepared, num_heads=H, dtype=torch.float32)
    cpu = k1.prepare_weights(*[torch.from_numpy(p).requires_grad_(True) for p in params],
                             num_heads=H, dtype=torch.float32)
    out = k1.vit_layer_prepared(torch.randn(2, 16, C), cpu, num_heads=H, dtype=torch.float32)
    assert out.requires_grad


@pytest.fixture
def spies(monkeypatch):
    calls = []

    def spy(name, fn):
        def wrapped(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(vit_module, "vit_layer_train", spy("K3", k3.vit_layer_train))
    monkeypatch.setattr(vit_module, "vit_layer_prepared", spy("K1", k1.vit_layer_prepared))
    return calls


@pytest.mark.parametrize("gelu_tanh,fused_layers,train,want", [
    (True, None, True, "K3"),     # training: the differentiable kernel
    (True, None, False, "K1"),    # serving under no_grad: the forward kernel
    (True, False, True, None),    # fused_layers=False: the eager block
    (False, None, True, None),    # erf GELU: K3 is tanh-only, so the eager block
    (False, None, False, "K1"),   # K1 serves both GELUs
])
def test_backbone_routes_each_layer(spies, gelu_tanh, fused_layers, train, want):
    arch = dict(embed_dims=C, num_layers=2, num_heads=H, feedforward_channels=F)
    vit = VisionTransformer(arch=arch, img_size=(64, 32), approximate_gelu=gelu_tanh,
                            fused_layers=fused_layers, drop_path_rate=0.1)
    vit.train(train)
    x = torch.randn(2, 3, 64, 32)
    gen = torch.Generator().manual_seed(0)
    if train:
        vit(x, gen)[0].sum().backward()
        assert vit.layers[0].attn.qkv.weight.grad is not None
    else:
        with torch.no_grad():
            vit(x)
    assert spies == ([want] * 2 if want else [])


def test_eval_mode_under_autograd_goes_through_k3(spies):
    """A gradient taken in evaluation mode (no stochastic depth) still needs
    a differentiable layer, so it goes to K3, never to K1."""
    arch = dict(embed_dims=C, num_layers=2, num_heads=H, feedforward_channels=F)
    vit = VisionTransformer(arch=arch, img_size=(64, 32), approximate_gelu=True).eval()
    vit(torch.randn(2, 3, 64, 32))[0].sum().backward()
    assert spies == ["K3", "K3"]


def test_drop_path_needs_a_generator_and_follows_it():
    arch = dict(embed_dims=C, num_layers=3, num_heads=H, feedforward_channels=F)
    vit = VisionTransformer(arch=arch, img_size=(64, 32), approximate_gelu=True, drop_path_rate=0.3).train()
    assert [blk.drop_path_rate for blk in vit.layers] == pytest.approx([0.0, 0.15, 0.3])
    x = torch.randn(8, 3, 64, 32)
    with pytest.raises(ValueError, match="Generator"):
        vit(x)
    a = vit(x, torch.Generator().manual_seed(5))[0]
    b = vit(x, torch.Generator().manual_seed(5))[0]
    c = vit(x, torch.Generator().manual_seed(6))[0]
    assert torch.equal(a, b) and not torch.equal(a, c)
    m1, m2 = vit.layers[2].drop_masks(4096, torch.Generator().manual_seed(0))
    keep = 0.7
    for m in (m1, m2):
        values = m.numpy()
        assert np.all((values == 0.0) | np.isclose(values, 1 / keep, rtol=1e-6))
        assert abs(float((m > 0).float().mean()) - keep) < 0.03
