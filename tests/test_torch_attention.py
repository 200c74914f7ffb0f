"""K4, the attention core: the port's plain twins and its autograd Function
against the JAX package's ``fused_attention`` and ``xla_attention``.

The JAX Pallas kernel runs in interpret mode, as the JAX package's own test
runs it (``tests/test_ops/test_pallas_decode.py``). On the CPU the port's
``fused_attention`` runs the kernel's twin, so these tests hold the twin's
arithmetic and the Function's backward; ``tests/test_torch_cuda.py`` holds
the CUDA kernel against the twin on the card.

Bars, with their reasons:
- f32, twin vs the Pallas kernel: atol 1e-5. Both compute in f32 and differ
  in summation order only (measured at most 4.2e-7 on unit-normal inputs).
- f32, twin vs ``xla_attention``: atol 1e-4, the JAX package's bar for the
  kernel against it (``test_pallas_decode.py:76``).
- bf16, twin vs the Pallas kernel: at most one bf16 step at the output's
  magnitude (2^-8 for outputs below 1; measured 2.4e-4 to 4.9e-4, in under
  0.1% of the elements). p is rounded to bf16, and an exp that differs in its
  last f32 bit can round p to the neighbouring bf16 value.
- gradients, the Function vs ``jax.vjp`` of the Pallas kernel, f32: atol 1e-4
  (both recompute ``xla_attention``; measured at most 3.9e-7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from probpose_code_torch.ops.kernels import attention as k4
from probpose_code_torch.ops.kernels.attention import (
    attention_kernel,
    fused_attention,
    fused_attention_plain,
    xla_attention_plain,
)
from probpose_code_tpu.ops.pallas.attention import fused_attention as jax_fused_attention
from probpose_code_tpu.ops.pallas.attention import xla_attention as jax_xla_attention

# (B, N, h, d): ProbPose-S's head width, ViTPose-B's, an N that is not a
# multiple of 8, ViTPose-H's heads of 80 and the widest head (96) that the f32
# kernel's one-pass instances take
SHAPES = [(2, 192, 4, 32), (2, 192, 2, 64), (1, 37, 3, 32), (1, 192, 2, 80), (1, 64, 2, 96)]
BF16_STEP = 2.0 ** -8


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tier-1 runs six test workers at once; one torch thread each."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _inputs(shape, seed, scale=1.0):
    rng = np.random.RandomState(seed)
    return tuple((rng.randn(*shape) * scale).astype(np.float32) for _ in range(3))


def _jax_kernel(q, k, v, scale, dtype=jnp.float32):
    with pltpu.force_tpu_interpret_mode():
        out = jax_fused_attention(*(jnp.asarray(t).astype(dtype) for t in (q, k, v)), scale)
    return np.asarray(out.astype(jnp.float32))


def _twin(q, k, v, scale, dtype=torch.float32):
    return fused_attention_plain(*(torch.from_numpy(t).to(dtype) for t in (q, k, v)), scale).float().numpy()


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_twin_matches_the_pallas_kernel_f32(shape):
    q, k, v = _inputs(shape, seed=shape[1])
    scale = shape[-1] ** -0.5
    np.testing.assert_allclose(_twin(q, k, v, scale), _jax_kernel(q, k, v, scale), atol=1e-5)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_twin_matches_xla_attention_f32(shape):
    q, k, v = _inputs(shape, seed=shape[1] + 1)
    scale = shape[-1] ** -0.5
    want = np.asarray(jax_xla_attention(*map(jnp.asarray, (q, k, v)), scale))
    np.testing.assert_allclose(_twin(q, k, v, scale), want, atol=1e-4)
    got = xla_attention_plain(*map(torch.from_numpy, (q, k, v)), scale).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_twin_follows_the_kernel_in_bf16(shape):
    """In bf16 the twin keeps the kernel's f32 scores: it meets the Pallas
    kernel within one bf16 step, and ``xla_attention`` (bf16 scores) lies
    further off; the port's ``xla_attention_plain`` meets the JAX one."""
    q, k, v = _inputs(shape, seed=shape[1] + 2)
    scale = shape[-1] ** -0.5
    got = _twin(q, k, v, scale, torch.bfloat16)
    want = _jax_kernel(q, k, v, scale, jnp.bfloat16)
    assert np.abs(got - want).max() <= BF16_STEP * max(1.0, np.abs(want).max())
    xla = np.asarray(jax_xla_attention(*(jnp.asarray(t).astype(jnp.bfloat16) for t in (q, k, v)), scale)
                     .astype(jnp.float32))
    assert (got != want).sum() < (got != xla).sum()
    port_xla = xla_attention_plain(*(torch.from_numpy(t).bfloat16() for t in (q, k, v)), scale).float().numpy()
    assert np.abs(port_xla - xla).max() <= BF16_STEP * max(1.0, np.abs(xla).max())


def test_q_scale_is_applied_in_bf16():
    """At d = 32 the scale 32^-0.5 is not a bf16 number: q * scale is formed
    in bf16 from the bf16-rounded scale (``attention.py:60``). The twin does
    so; scaling in f32 instead moves more outputs off the Pallas kernel's."""
    q, k, v = _inputs((2, 64, 2, 32), seed=11)
    scale = 32 ** -0.5
    want = _jax_kernel(q, k, v, scale, jnp.bfloat16)
    got = _twin(q, k, v, scale, torch.bfloat16)
    tq, tk, tv = (torch.from_numpy(t).bfloat16() for t in (q, k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", tq.float() * scale, tk.float())
    p = torch.softmax(s, dim=-1).bfloat16().float()
    f32_scaled = torch.einsum("bhqk,bkhd->bqhd", p, tv.float()).bfloat16().float().numpy()
    assert (got != want).sum() < (f32_scaled != want).sum()


def test_softmax_is_max_shifted():
    """Scores near 100 overflow an unshifted exp in f32 (K1 / K3 clamp at 80
    instead); the max shift keeps the twin finite and on the kernel."""
    q, k, v = _inputs((1, 48, 2, 32), seed=5, scale=10.0)
    scale = 32 ** -0.5
    got = _twin(q, k, v, scale)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, _jax_kernel(q, k, v, scale), atol=1e-5 * np.abs(v).max())


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_gradients_match_jax(shape):
    """dq, dk, dv through the port's Function (its backward recomputes
    ``xla_attention``) against ``jax.vjp`` of the Pallas kernel's custom VJP;
    dq carries the q-scale."""
    q, k, v = _inputs(shape, seed=shape[1] + 3)
    g = np.random.RandomState(shape[1] + 4).randn(*shape).astype(np.float32)
    scale = shape[-1] ** -0.5
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda a, b, c: jax_fused_attention(a, b, c, scale), *map(jnp.asarray, (q, k, v)))
        want = [np.asarray(t) for t in vjp(jnp.asarray(g))]
    ts = [torch.from_numpy(t).requires_grad_(True) for t in (q, k, v)]
    got = torch.autograd.grad(fused_attention(*ts, scale), ts, torch.from_numpy(g))
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), b, atol=1e-4, err_msg=f"d{name}")


def test_forward_needs_no_autograd_and_launches_nothing_on_the_cpu():
    q, k, v = (torch.from_numpy(t) for t in _inputs((2, 16, 2, 8), seed=3))
    before = attention_kernel.launches
    with torch.inference_mode():
        out = fused_attention(q, k, v, 8 ** -0.5)
    assert not out.requires_grad
    assert torch.equal(out, fused_attention_plain(q, k, v, 8 ** -0.5))
    assert attention_kernel.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        attention_kernel(q, k, v, 8 ** -0.5)


def test_eager_attention_goes_through_k4(monkeypatch):
    """The ViT block's eager path hands K4's wrapper the qkv projection's
    strided views, once per layer, and uses what it returns."""
    from probpose_code_torch.models.backbones import vit

    calls = []

    def spy(q, k, v, scale):
        calls.append((q.shape, q.stride(), k.data_ptr() - q.data_ptr(), scale))
        return k4.fused_attention(q, k, v, scale)

    monkeypatch.setattr(vit, "fused_attention", spy)
    torch.manual_seed(0)
    B, N, C, H = 2, 24, 32, 4
    block = vit.TransformerBlock(C, H, 64, fused_layers=False)
    x = torch.randn(B, N, C, requires_grad=True)
    block(x).sum().backward()
    assert len(calls) == 1
    shape, stride, k_offset, scale = calls[0]
    assert shape == (B, N, H, C // H)
    assert stride == (N * 3 * C, 3 * C, C // H, 1)  # views of (B, N, 3, h, d): no copy
    assert k_offset == C * 4  # k starts one C after q in each token's row (f32)
    assert scale == pytest.approx((C // H) ** -0.5)
    assert x.grad is not None and block.attn.qkv.weight.grad.abs().max() > 0
