"""K1's plain twin against the JAX whole-layer kernel.

``vit_layer_plain`` (the same function as the CUDA kernel, in torch, with the
TPU kernel's casts) against ``probpose_code_tpu.ops.pallas.vit_layer:
vit_layer_fused`` in interpret mode, on the same numpy inputs at B = 2,
N = 64, C = 128, 4 heads, F = 256.

Bars: bf16 with tanh-GELU, relative max error < 3e-2, the JAX package's own
(``tests/test_ops/test_vit_layer_fused.py:76``). f32 with erf-GELU, relative
max error < 1e-5: both sides compute in f32 with the same formula and differ
only in summation order, about 1e-6 of the output's range here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probpose_code_torch.ops.kernels.vit_layer import fits, vit_layer, vit_layer_plain, vit_layer_prepared
from probpose_code_tpu.ops.pallas.vit_layer import vit_layer_fused

B, N, C, H, F = 2, 64, 128, 4, 256


def _inputs(seed):
    rng = np.random.RandomState(seed)

    def r(*shape, s=1.0, base=0.0):
        return (base + s * rng.randn(*shape)).astype(np.float32)

    x = r(B, N, C)
    params = [
        r(C, s=0.1, base=1.0), r(C, s=0.1), r(C, 3 * C, s=0.08), r(3 * C, s=0.05),
        r(C, C, s=0.08), r(C, s=0.05), r(C, s=0.1, base=1.0), r(C, s=0.1),
        r(C, F, s=0.08), r(F, s=0.05), r(F, C, s=0.08), r(C, s=0.05),
    ]
    return x, params


@pytest.mark.parametrize(
    "dtype,approx,bar",
    [("bfloat16", True, 3e-2), ("float32", False, 1e-5)],
)
def test_plain_matches_jax_kernel(dtype, approx, bar):
    x, params = _inputs(0)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = vit_layer_fused(
        jnp.asarray(x).astype(jdt), *[jnp.asarray(p) for p in params],
        num_heads=H, approximate_gelu=approx, dtype=jdt,
    )
    got = vit_layer_plain(
        torch.from_numpy(x).to(tdt), *[torch.from_numpy(p) for p in params],
        num_heads=H, approximate_gelu=approx, dtype=tdt,
    )
    assert got.dtype == tdt and got.shape == (B, N, C)
    w = np.asarray(want.astype(jnp.float32))
    g = got.float().numpy()
    assert np.abs(g - w).max() / np.abs(w).max() < bar


def test_wrapper_takes_cpu_tensors_to_the_plain_twin():
    x, params = _inputs(1)
    args = [torch.from_numpy(x)] + [torch.from_numpy(p) for p in params]
    kw = dict(num_heads=H, approximate_gelu=False, dtype=torch.float32)
    before = vit_layer_prepared.launches
    np.testing.assert_array_equal(vit_layer(*args, **kw).numpy(), vit_layer_plain(*args, **kw).numpy())
    assert vit_layer_prepared.launches == before  # the count moves only on a kernel launch


def test_shape_rule_matches_jax():
    # the TPU kernel's rule (vit_layer.py:131-138): C % heads, D % 8, N % 8
    x, params = _inputs(2)
    assert fits(N, C, H)
    for n, c, h in [(63, 128, 4), (64, 128, 3), (64, 100, 4)]:
        assert not fits(n, c, h)
    assert vit_layer_fused(jnp.zeros((2, 63, C), jnp.bfloat16), *[jnp.asarray(p) for p in params], num_heads=H) is None
    with pytest.raises(ValueError):
        vit_layer(torch.zeros(2, 63, C), *[torch.from_numpy(p) for p in params], num_heads=H)
