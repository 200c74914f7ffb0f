"""The port's sparsemax against the JAX package's (forward and gradient).

Same inputs from a numpy seed through ``probpose_code_tpu.ops.sparsemax`` and
``probpose_code_torch.ops.sparsemax``. Both run the same 26-step bisection
and renormalisation in f32, so supports match exactly and values agree to
f32 rounding (atol 1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probpose_code_torch.ops.sparsemax import sparsemax
from probpose_code_tpu.ops.sparsemax import sparsemax as jax_sparsemax

ATOL = 1e-6


def _logits(seed, shape=(3, 5, 96), scale=4.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


@pytest.mark.parametrize("seed,scale", [(0, 4.0), (1, 0.3), (2, 20.0)])
def test_forward_matches_jax(seed, scale):
    z = _logits(seed, scale=scale)
    want = np.asarray(jax_sparsemax(jnp.asarray(z)))
    got = sparsemax(torch.from_numpy(z)).numpy()
    np.testing.assert_array_equal(got > 0, want > 0)  # identical supports
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)


def test_gradient_matches_jax():
    z = _logits(4)
    w = np.random.RandomState(5).randn(*z.shape).astype(np.float32)
    want = np.asarray(jax.grad(lambda a: jnp.sum(jax_sparsemax(a) * w))(jnp.asarray(z)))
    zt = torch.from_numpy(z).requires_grad_(True)
    (sparsemax(zt) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(zt.grad.numpy(), want, atol=ATOL)
