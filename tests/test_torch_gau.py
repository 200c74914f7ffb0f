"""The GAU kernels' arithmetic on the CPU.

``csrc/gau.cu`` runs only on the card. What it computes is held here: its
forward and its backward as the kernels split them (the activations, R
and P = R^2, O = P v, then dO = dout * u with du, the score gradient G,
dv, dq and dk, the base's gradient and gamma's and beta's sums), written
out in float64 NumPy, against ``gau_attention_plain`` and torch autograd
through it; and
``gau_attention`` on a CPU tensor is the plain twin and launches nothing.
The kernels themselves are held against the twin on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``'s ``gau_parity``).
"""

import numpy as np
import pytest
import torch

from probpose_code_torch.ops.kernels import gau


def _act(z, act_fn):
    if act_fn == "ReLU":
        return np.maximum(z, 0.0), (z > 0).astype(z.dtype)
    sig = 1.0 / (1.0 + np.exp(-z))
    return z * sig, sig * (1.0 + z * (1.0 - sig))


def _kernels_f64(z, gamma, beta, dout, e, s, act_fn):
    """The kernels' steps in float64: (out, dz, dgamma, dbeta)."""
    a, da = _act(z, act_fn)  # activate_kernel
    u, v, base = a[..., :e], a[..., e:2 * e], a[..., 2 * e:]
    q, k = base * gamma[0] + beta[0], base * gamma[1] + beta[1]
    R = np.maximum(np.einsum("bis,bjs->bij", q, k) / np.sqrt(s), 0.0)  # scores_kernel
    P = R * R
    O = np.einsum("bij,bjc->bic", P, v)  # output_kernel
    out = u * O
    dz = np.empty_like(z)
    dO = dout * u  # grad_out_kernel
    dz[..., :e] = dout * O * da[..., :e]
    G = 2.0 * R * np.einsum("bic,bjc->bij", dO, v) / np.sqrt(s)  # grad_scores_kernel
    dz[..., e:2 * e] = np.einsum("bij,bic->bjc", P, dO) * da[..., e:2 * e]  # grad_values_kernel
    dq, dk = np.einsum("bij,bjs->bis", G, k), np.einsum("bij,bis->bjs", G, q)  # grad_qk_kernel<0>, <1>
    dz[..., 2 * e:] = (dq * gamma[0] + dk * gamma[1]) * da[..., 2 * e:]  # grad_base_kernel
    dgamma = np.stack([(dq * base).sum((0, 1)), (dk * base).sum((0, 1))])
    dbeta = np.stack([dq.sum((0, 1)), dk.sum((0, 1))])
    return out, dz, dgamma, dbeta


def _inputs(B, n, e, s, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, n, 2 * e + s), rng.rand(2, s), 0.1 * rng.randn(2, s), rng.randn(B, n, e))


@pytest.mark.parametrize("act_fn", ["SiLU", "ReLU"])
@pytest.mark.parametrize("B,n,e,s", [(2, 17, 16, 8), (3, 33, 24, 16), (1, 1, 8, 4)])
def test_kernel_steps_match_autograd_through_the_twin(B, n, e, s, act_fn):
    z, gamma, beta, dout = _inputs(B, n, e, s, seed=B * 100 + n)
    out, dz, dgamma, dbeta = _kernels_f64(z, gamma, beta, dout, e, s, act_fn)
    leaves = [torch.from_numpy(t).requires_grad_() for t in (z, gamma, beta)]
    ref = gau.gau_attention_plain(*leaves, e, s, act_fn)
    ref_grads = torch.autograd.grad(ref, leaves, torch.from_numpy(dout))
    np.testing.assert_allclose(out, ref.detach().numpy(), rtol=1e-12, atol=1e-12)
    for ours, theirs in zip((dz, dgamma, dbeta), ref_grads):
        np.testing.assert_allclose(ours, theirs.numpy(), rtol=1e-10, atol=1e-12)


def test_cpu_tensors_take_the_twin_and_launch_nothing():
    z, gamma, beta, _ = (torch.from_numpy(t.astype(np.float32)) for t in _inputs(2, 17, 16, 8, seed=0))
    gau.gau_forward.launches = gau.gau_backward.launches = 0
    z.requires_grad_()
    out = gau.gau_attention(z, gamma, beta, 16, 8)
    out.sum().backward()
    assert torch.equal(out, gau.gau_attention_plain(z, gamma, beta, 16, 8))
    assert gau.gau_forward.launches == 0 and gau.gau_backward.launches == 0


def test_the_twin_keeps_the_options_the_kernels_do_not_take():
    z, gamma, beta, _ = (torch.from_numpy(t.astype(np.float32)) for t in _inputs(1, 5, 8, 4, seed=1))
    bias = torch.from_numpy(np.random.RandomState(2).randn(5, 5).astype(np.float32))
    plain = gau.gau_attention(z, gamma, beta, 8, 4)
    assert not torch.equal(gau.gau_attention(z, gamma, beta, 8, 4, rel_bias=bias), plain)
    assert not torch.equal(gau.gau_attention(z, gamma, beta, 8, 4, pos_enc=True), plain)
    with pytest.raises(ValueError):
        gau.gau_attention(z, gamma, beta, 8, 4, act_fn="GELU")


def test_flops_count_the_products():
    fwd, bwd = gau.gau_flops(64, 133, 512, 128)
    assert fwd == 2 * 64 * 133 * 133 * 640 and bwd == 2 * fwd
