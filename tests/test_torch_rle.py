"""RLEHead, its RealNVP flow and RLELoss, and the neckless RegressionHead, on
the CPU against the JAX package on the same weights and inputs.

The models are the shipped configs' (``configs/body_2d_keypoint/
topdown_regression/``) on a ResNet-18 of 4-32 channels. Their JAX variables
are drawn by NumPy from a seed (``draw_variables``: kernels N(0, 1 / fan-in),
BatchNorm scales and variances in [0.5, 1.5), means in [-0.2, 0.2), other
arrays N(0, 0.1)) and carried to the port by ``state_dict_from_jax``, loaded
with ``strict=True``. The flow's twelve nets are drawn from N(0, 0.3^2)
(``FLOW_STD``): at their initialisation (xavier, gain 0.01) each net gives
about 1e-4 and the flow is near the identity, where a parity check would pass
whatever the coupling code did; at 0.3 the scales s and the shifts t are of
order 1 (each test states what it sees) and the residuals reach |10|, as
``(pred - target) / sigma`` gives with sigma near 0.1.

Bars, with their reasons:
- the flow and RLELoss: values in f32 within 1e-5 of the largest
  (summation order); gradients in float64 on both sides within 1e-9 of each
  array's largest (the densities reach 1e4, and f32 keeps four digits of
  their gradients);
- the flow kernel's steps (``csrc/realnvp.cu``, mirrored in float64 here)
  against autograd through the twin in float64: 1e-10 relative;
- the narrow models' predicts (flip-TTA): keypoints 1e-3 px (the JAX
  package's bar for a decode: f32 noise), RLE's scores 1e-5; one training
  step's loss dict rel 2e-5 and the gradients of ``fc`` within 1e-4 of each
  parameter's largest (f32 through a BatchNorm in training mode), the
  flow's within 5e-3 (``MODEL_FLOW_GRAD_REL``: a saturated tanh's 1 - s^2 in
  f32; the flow's own tests hold its gradients in float64 at 1e-9);
- the fixture (``chip_smoke.RLE_FIXTURE``) through ``init_model`` and
  ``inference_topdown``: ``chip_smoke.model_fixture_report``'s bars.
"""

import glob

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import RLE_FIXTURE, model_fixture_report
from probpose_code_torch.apis import init_model
from probpose_code_torch.config import Config
from probpose_code_torch.datasets.metainfo import parse_pose_metainfo
from probpose_code_torch.engine.checkpoint import flow_state_from_jax, state_dict_from_jax
from probpose_code_torch.models.builder import PoseModel
from probpose_code_torch.models.pose_estimators.topdown import regression_head_predict
from probpose_code_torch.models.utils.realnvp import RealNVP
from probpose_code_torch.registry import MODELS, TRANSFORMS
from probpose_code_tpu.datasets.metainfo import parse_pose_metainfo as jax_parse_pose_metainfo
from probpose_code_tpu.models import PoseModel as JaxPoseModel
from probpose_code_tpu.models.pose_estimators.topdown import regression_head_predict as jax_regression_head_predict
from probpose_code_tpu.models.utils.realnvp import RealNVP as JaxRealNVP
from probpose_code_tpu.registry import MODELS as JAX_MODELS
from tests.test_torch_classic_heatmap import _smooth_crops
from tests.test_torch_rtmpose_train import _plain

REG = "configs/body_2d_keypoint/topdown_regression/"
RLE_COCO = REG + "coco/td-reg_res50_rle-8xb64-210e_coco-256x192.py"
NECKLESS = {"coco": REG + "coco/td-reg_res50_8xb64-210e_coco-256x192.py",
            "mpii": REG + "mpii/td-reg_res50_8xb64-210e_mpii-256x256.py"}
CONFIGS = sorted(glob.glob(REG + "coco/td-reg_*.py") + glob.glob(REG + "mpii/td-reg_*.py"))
NARROW = dict(type="ResNet", depth=18, stem_channels=16, base_channels=4, out_indices=(3,))
FLOW_STD = 0.3
REL, GRAD_REL, GRAD_REL_64 = 1e-5, 1e-4, 1e-9
# the flow's gradients in a model's f32 step: where a scale net's tanh saturates, 1 - s^2 keeps few of f32's digits
# (a layer's whole gradient moves together, 1.5e-3 seen); the float64 tests above hold them at GRAD_REL_64
MODEL_FLOW_GRAD_REL = 5e-3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tier-1 runs six test workers at once; one torch thread each."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def close(got, want, rel, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    assert np.abs(got - want).max() <= rel * max(np.abs(want).max(), 1e-30), what


def draw_variables(shapes, seed):
    """JAX variables of ``shapes`` drawn by NumPy (see the module docstring),
    the flow's nets from N(0, FLOW_STD^2)."""
    rng = np.random.RandomState(seed)

    def one(path, leaf):
        keys = [getattr(p, "key", "") for p in path]
        name, shape = keys[-1], leaf.shape
        if "flow" in keys:
            return (FLOW_STD * rng.randn(*shape)).astype(np.float32)
        if name == "kernel":
            return (rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        if name == "mean":
            return rng.uniform(-0.2, 0.2, shape).astype(np.float32)
        return (0.1 * rng.randn(*shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(one, shapes)


def flow_pair(seed):
    """(the JAX flow's variables, the port's RealNVP with them, carried by
    ``flow_state_from_jax``, the flow's part of ``state_dict_from_jax``)."""
    flow = JaxRealNVP()
    shapes = jax.eval_shape(lambda: flow.init(jax.random.PRNGKey(0), jnp.zeros((1, 2))))
    variables = draw_variables({"flow": shapes["params"]}, seed)["flow"]
    ours = RealNVP()
    ours.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in flow_state_from_jax(variables).items()},
                         strict=True)
    return {"params": variables}, ours


def flow_grads(ours: RealNVP, want_params, rel):
    """Each of the port flow's parameter gradients against the JAX
    gradients ``want_params``, carried by ``flow_state_from_jax``."""
    params = dict(ours.named_parameters())
    for name, g in flow_state_from_jax(_np(want_params)).items():
        if name in params:
            close(params[name].grad, g, rel, name)


def residuals(n, seed):
    """(n, 2) residuals up to |10|, some near 0."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(-10, 10, (n, 2)).astype(np.float32)
    x[: n // 4] *= 0.01
    return x


_MODELS = {}


def narrow_cfg(config):
    """``config``'s model on the narrow ResNet-18 (32 channels out), its
    heads' deconvolutions 8 channels wide."""
    cfg = _plain(dict(Config.fromfile(config)["model"]))
    cfg["backbone"] = dict(NARROW)
    head = cfg["head"]["pose_cfg"] if cfg["head"]["type"] == "VisPredictHead" else cfg["head"]
    head["in_channels"] = 32
    if "in_featuremap_size" in head or head["type"] == "HeatmapHead":
        head["deconv_out_channels"] = (8, 8, 8)
    return cfg


def models(config, seed):
    """(port model, JAX model, JAX variables) of ``config`` on the narrow
    ResNet-18 (``narrow_cfg``), no neck, made once a module."""
    key = (config, seed)
    if key not in _MODELS:
        cfg = narrow_cfg(config)
        meta = "mpii" if "mpii" in config else "coco"
        jm = JaxPoseModel(cfg, metainfo=jax_parse_pose_metainfo(dict(dataset_name=meta)))
        w, h = jm.input_size
        rle = cfg["head"]["type"] == "RLEHead"

        def init(module, x):
            out = module(x, train=False)
            if rle:  # the flow's parameters exist once it runs (``PoseModel.init``)
                module.head.log_phi(jnp.zeros((1, out.shape[1], 2), jnp.float32))
            return out

        shapes = jax.eval_shape(lambda: jm.module.init(jax.random.PRNGKey(0), jnp.zeros((1, h, w, 3)), method=init))
        variables = draw_variables(shapes, seed)
        ours = PoseModel(cfg, metainfo=parse_pose_metainfo(dict(dataset_name=meta)), device="cpu")
        ours.module.load_state_dict(state_dict_from_jax(_np(variables)), strict=True)
        _MODELS[key] = ours, jm, variables
    return _MODELS[key]


def scales_and_shifts(flow: RealNVP, x: torch.Tensor):
    """The largest |s| and |t| over the coupling layers on ``x``."""
    from probpose_code_torch.models.utils.realnvp import _mlp

    s_max = t_max = 0.0
    z = x
    with torch.no_grad():
        for i in reversed(range(6)):
            m = flow.mask[i]
            s = torch.tanh(_mlp(m * z, flow.s[i])) * (1 - m)
            t = _mlp(m * z, flow.t[i]) * (1 - m)
            z = (1 - m) * (z - t) * torch.exp(-s) + m * z
            s_max, t_max = max(s_max, float(s.abs().max())), max(t_max, float(t.abs().max()))
    return s_max, t_max


# -- the flow -----------------------------------------------------------------------------------------------


def test_flow_log_prob_and_gradients_match_jax():
    """The flow's log-density of 64 residuals in f32, and in float64 on both
    sides its gradients to the residuals and to all twelve nets' weights
    (the densities reach 1e4 here, and f32 gradients of sums over rows that
    large keep four digits). The nets at N(0, 0.3^2) give scales |s| above
    0.5 and shifts |t| above 1, and a log-determinant far from 0: the flow is
    no identity."""
    variables, ours = flow_pair(seed=1)
    x = residuals(64, seed=2)
    weight = np.random.RandomState(3).uniform(0.5, 1.5, 64)
    jf = JaxRealNVP()
    want = np.asarray(jf.apply(variables, jnp.asarray(x)))
    close(ours(torch.from_numpy(x)).detach(), want, REL, "log_prob")
    s_max, t_max = scales_and_shifts(ours, torch.from_numpy(x))
    assert s_max > 0.5 and t_max > 1.0, (s_max, t_max)
    prior = -0.5 * (x.astype(np.float64) ** 2).sum(1) - np.log(2 * np.pi)
    assert np.abs(want - prior).max() > 1.0  # the flow moves the density by more than a nat

    with jax.enable_x64(True):
        params64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), variables["params"])
        want_gp, want_gx = jax.grad(lambda p, x: (weight * jf.apply({"params": p}, x)).sum(), argnums=(0, 1))(
            params64, jnp.asarray(x, jnp.float64))
        want_gp, want_gx = _np(want_gp), np.asarray(want_gx)
    ours = ours.double()
    xt = torch.from_numpy(x.astype(np.float64)).requires_grad_()
    (torch.from_numpy(weight) * ours(xt)).sum().backward()
    close(xt.grad, want_gx, GRAD_REL_64, "d/dx")
    flow_grads(ours, want_gp, GRAD_REL_64)


def kernel_steps(x, params, grad):
    """The arithmetic of ``csrc/realnvp.cu`` in float64, vectorized over the
    rows: the forward saving z at each layer's input, and the backward that
    recomputes each layer from it and applies the chain rule by hand (the
    kernel's ``da3``, ``da2``, ``dh1`` / ``da1``, ``dzm``; the weight
    gradients summed over the rows). Returns (log_prob, dx, the packed
    parameters' gradient)."""
    H, NET = 64, 4482
    layout = (("W1", (H, 2)), ("b1", (H,)), ("W2", (H, H)), ("b2", (H,)), ("W3", (2, H)), ("b3", (2,)))

    def unpack(i, net):
        out, at = {}, i * 2 * NET + net * NET
        for name, shape in layout:
            size = int(np.prod(shape))
            out[name] = params[at:at + size].reshape(shape)
            at += size
        return out

    def lrelu(a):
        return np.where(a > 0, a, 0.01 * a)

    def nets(i, zm):
        acts = []
        for net in (0, 1):
            w = unpack(i, net)
            a1 = zm @ w["W1"].T + w["b1"]
            a2 = lrelu(a1) @ w["W2"].T + w["b2"]
            a3 = lrelu(a2) @ w["W3"].T + w["b3"]
            acts.append((w, a1, a2, a3))
        return acts

    n = len(x)
    z, zs, log_det = x.copy(), [None] * 6, np.zeros(n)
    for i in reversed(range(6)):
        zs[i], q = z.copy(), i & 1
        zm = z.copy()
        zm[:, q] = 0
        (_, _, _, a3s), (_, _, _, a3t) = nets(i, zm)
        s, t = np.tanh(a3s[:, q]), a3t[:, q]
        z[:, q] = (z[:, q] - t) * np.exp(-s)
        log_det -= s
    logp = -0.5 * (z ** 2).sum(1) - np.log(2 * np.pi) + log_det
    dparams = np.zeros_like(params)
    gz = None
    for i in range(6):
        z, q, p = zs[i], i & 1, 1 - (i & 1)
        zm = z.copy()
        zm[:, q] = 0
        acts = nets(i, zm)
        s, t = np.tanh(acts[0][3][:, q]), acts[1][3][:, q]
        e = np.exp(-s)
        if gz is None:
            out = z.copy()
            out[:, q] = (z[:, q] - t) * e
            gz = -out * grad[:, None]
        dz = gz.copy()
        dz[:, q] = gz[:, q] * e
        ds = -gz[:, q] * (z[:, q] - t) * e - grad
        dzm = np.zeros_like(z)
        for net, (w, a1, a2, a3) in enumerate(acts):
            da3 = np.zeros((n, 2))
            da3[:, q] = ds * (1 - s * s) if net == 0 else -gz[:, q] * e
            da2 = (da3 @ w["W3"]) * np.where(a2 > 0, 1.0, 0.01)
            da1 = (da2 @ w["W2"]) * np.where(a1 > 0, 1.0, 0.01)
            dzm += da1 @ w["W1"]
            at = i * 2 * NET + net * NET
            for g in (da1.T @ zm, da1.sum(0), da2.T @ lrelu(a1), da2.sum(0), da3.T @ lrelu(a2), da3.sum(0)):
                dparams[at:at + g.size] = g.ravel()
                at += g.size
        dz[:, p] += dzm[:, p]
        gz = dz
    return logp, gz, dparams


def test_kernel_steps_match_autograd():
    """The flow kernel's forward and backward, its steps mirrored in float64
    (``kernel_steps``), against autograd through the plain twin in float64,
    at N(0, 0.3^2) weights and residuals up to |10|."""
    _, flow = flow_pair(seed=4)
    flow = flow.double()
    x = residuals(48, seed=5).astype(np.float64)
    grad = np.random.RandomState(6).uniform(-1, 1, 48)
    params = torch.cat([p.detach().reshape(-1) for p in flow.packed_parameters()]).numpy()
    assert params.size == 53_784
    logp, dx, dparams = kernel_steps(x, params, grad)
    xt = torch.from_numpy(x).requires_grad_()
    want = flow.log_prob_plain(xt)
    (want * torch.from_numpy(grad)).sum().backward()
    want_dparams = torch.cat([p.grad.reshape(-1) for p in flow.packed_parameters()]).numpy()
    close(logp, want.detach(), 1e-10, "log_prob")
    close(dx, xt.grad, 1e-10, "dx")
    close(dparams, want_dparams, 1e-10, "dparams")


@pytest.mark.parametrize("q_distribution", ["laplace", "gaussian"])
def test_rle_loss_and_gradients_match_jax(q_distribution):
    """RLELoss (target weights, size average) through the flow: the loss in
    f32, and in float64 on both sides its gradients to the coordinates, the
    raw sigmas and the flow's nets. Sigmas near 0.1 put the normalized
    errors up to about |10|."""
    variables, flow = flow_pair(seed=7)
    rng = np.random.RandomState(8)
    B, K = 4, 17
    target = rng.rand(B, K, 2).astype(np.float32)
    pred = (target + rng.uniform(-1, 1, (B, K, 2))).astype(np.float32)
    sigma = rng.uniform(-2.5, 0.5, (B, K, 2)).astype(np.float32)  # sigmoid: 0.08-0.62
    weights = (rng.rand(B, K) > 0.25).astype(np.float32)
    error = (pred - target) / (1 / (1 + np.exp(-sigma)) + 1e-9)
    assert np.abs(error).max() > 8
    cfg = dict(type="RLELoss", use_target_weight=True, q_distribution=q_distribution)
    jf = JaxRealNVP()

    def jax_loss(pred, sigma, params):
        def log_phi(e):
            return jf.apply({"params": params}, e.reshape(B * K, 2)).reshape(B, K)

        return JAX_MODELS.build(dict(cfg))(pred, sigma, jnp.asarray(target, pred.dtype),
                                           jnp.asarray(weights, pred.dtype), log_phi_fn=log_phi)

    def ours(flow, *arrays):
        p, s, t, w = (torch.from_numpy(a) for a in arrays)
        p.requires_grad_(), s.requires_grad_()

        def log_phi(e):
            return flow(e.reshape(B * K, 2)).reshape(B, K)

        loss = MODELS.build(dict(cfg))(p, s, t, w, log_phi_fn=log_phi)
        loss.backward()
        return loss.detach(), p.grad, s.grad

    want = jax_loss(jnp.asarray(pred), jnp.asarray(sigma), variables["params"])
    close(ours(flow, pred, sigma, target, weights)[0], want, REL, "loss")
    with jax.enable_x64(True):
        arrays = [a.astype(np.float64) for a in (pred, sigma, target, weights)]
        params64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), variables["params"])
        grads = _np(jax.grad(jax_loss, argnums=(0, 1, 2))(jnp.asarray(arrays[0]), jnp.asarray(arrays[1]), params64))
    flow = flow.double()
    flow.zero_grad(set_to_none=True)  # the f32 loss's backward above filled them
    _, p_grad, s_grad = ours(flow, *arrays)
    close(p_grad, grads[0], GRAD_REL_64, "d/dpred")
    close(s_grad, grads[1], GRAD_REL_64, "d/dsigma")
    flow_grads(flow, grads[2], GRAD_REL_64)


# -- the head and the model ---------------------------------------------------------------------------------


def test_rle_sigmoid_before_the_flip_average():
    """RLE's predict takes the sigmoid of each pass's sigmas before the
    flip-TTA average, as the JAX predict does (``topdown.py:586-588``): with
    sigmas that differ between the passes the scores differ from those of
    the sigmoid of the averaged sigmas."""
    rng = np.random.RandomState(9)
    out = rng.uniform(0, 1, (2, 17, 4)).astype(np.float32)
    flipped = out.copy()
    out[..., 2:] = rng.uniform(-4, -2, (2, 17, 2))
    flipped[..., 2:] = rng.uniform(2, 4, (2, 17, 2))
    flip = parse_pose_metainfo(dict(dataset_name="coco"))["flip_indices"]
    got = regression_head_predict(torch.from_numpy(out), torch.from_numpy(flipped), flip, (192, 256), "RLEHead")
    want = jax_regression_head_predict(jnp.asarray(out), jnp.asarray(flipped), flip, (192, 256), "RLEHead")
    for k in ("keypoints", "keypoint_scores"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=1e-5, err_msg=k)
    after = 1 - 1 / (1 + np.exp(-(out[..., 2:] + flipped[..., 2:]) / 2))
    assert np.abs(got["keypoint_scores"].numpy() - after.mean(-1)).max() > 0.1


def _batch(B, K, seed, size):
    rng = np.random.RandomState(seed)
    inputs = _smooth_crops(B, seed, size=size)
    labels = rng.uniform(-0.05, 1.05, (B, K, 2)).astype(np.float32)
    weights = (rng.rand(B, K) > 0.2).astype(np.float32)
    return dict(inputs=inputs, keypoint_labels=labels, keypoint_weights=weights)


def _predict(config, seed):
    """The narrow model's predict (two crops, flip-TTA) against the JAX
    package's."""
    ours, jm, variables = models(config, seed)
    w, h = jm.input_size
    crops = np.round(np.random.RandomState(seed + 1).rand(2, h, w, 3) * 255).astype(np.float32)
    want = {k: np.asarray(v) for k, v in jm.make_predict(jit=False)(variables, crops).items()}
    got = ours.predict(torch.from_numpy(crops))
    np.testing.assert_allclose(got["keypoints"].numpy(), want["keypoints"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["keypoint_scores"].numpy(), want["keypoint_scores"], rtol=0, atol=1e-5)


def _step(config, seed, head_params):
    """One training step of the narrow model: its loss dict and the
    gradients of the parameters named by ``head_params`` against the JAX
    package's (the model's BatchNorm statistics put back after)."""
    ours, jm, variables = models(config, seed)
    w, h = jm.input_size
    batch = _batch(2, ours.module.head.num_joints, seed + 2, (h, w))

    def jax_loss(params):
        total, (losses, _) = jm.loss_fn({"params": params, "batch_stats": variables["batch_stats"]},
                                        {k: jnp.asarray(v) for k, v in batch.items()},
                                        rngs={"dropout": jax.random.PRNGKey(0)})
        return total, losses

    (_, want_losses), grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(variables["params"])
    saved = {k: v.clone() for k, v in ours.module.state_dict().items()}
    for p in ours.module.parameters():
        p.grad = None
    total, (losses, _) = ours.loss_fn({k: torch.from_numpy(v) for k, v in batch.items()})
    total.backward()
    ours.module.load_state_dict(saved)
    for name in ("loss_kpt", "acc_pose"):
        assert float(losses[name].detach()) == pytest.approx(float(want_losses[name]), rel=2e-5, abs=1e-6), name
    want_grads = state_dict_from_jax({"params": _np(grads), "batch_stats": _np(variables["batch_stats"])})
    params = dict(ours.module.named_parameters())
    checked = [k for k in want_grads if k.startswith(head_params) and k in params]
    for key in checked:
        close(params[key].grad, want_grads[key], MODEL_FLOW_GRAD_REL if ".flow_model." in key else GRAD_REL, key)
    return checked


def test_rle_predict_and_training_step_match_jax():
    """RLE-ResNet's recipe on the narrow ResNet-18: its predict and one
    step's ``loss_kpt`` / ``acc_pose`` and the gradients of ``fc`` and of
    the flow's 72 weights and biases."""
    _predict(RLE_COCO, 21)
    assert len(_step(RLE_COCO, 21, ("head.fc.", "head.loss.flow_model."))) == 2 + 72


@pytest.mark.parametrize("dataset", ["coco", "mpii"])
def test_neckless_regression_predict_matches_jax(dataset):
    """The six plain-regression configs have no neck: the head pools the
    backbone's (B, C, h, w) map, as the JAX head does. Their predict on
    their geometry (256 x 192 on COCO, 256 x 256 on MPII) against the JAX
    predict on the same weights."""
    ours, _, _ = models(NECKLESS[dataset], 31)
    assert ours.module.neck is None
    _predict(NECKLESS[dataset], 31)


@pytest.mark.parametrize("dataset", ["coco", "mpii"])
def test_neckless_regression_step_matches_jax(dataset):
    """One training step on that geometry against the JAX
    ``regression_head_loss``: ``loss_kpt`` / ``acc_pose`` and ``fc``'s
    gradients."""
    assert len(_step(NECKLESS[dataset], 31, ("head.fc.",))) == 2


def test_rle_fixture_through_inference_topdown():
    """``chip_smoke.model_fixture_report`` on the RLE fixture, the card's
    ``regression_golden`` check, on the CPU: ``init_model`` with its
    weights, ``inference_topdown`` over the golden persons against the JAX
    package's keypoints and scores."""
    report = model_fixture_report(RLE_FIXTURE, device="cpu")
    assert report["ok"], report


@pytest.mark.parametrize("config", CONFIGS, ids=lambda c: c.split("/")[-1].removesuffix(".py"))
def test_regression_config_builds(config):
    """Each shipped plain-regression and RLE config builds through
    ``init_model`` at full width, and its training pipeline's
    ``GenerateTarget`` through the registry."""
    cfg = Config.fromfile(config)
    model = init_model(cfg, device="cpu")
    K = 16 if "mpii" in config else 17
    head = model.module.head
    assert type(head).__name__ == cfg["model"]["head"]["type"]
    assert head.fc.out_features == K * (4 if "rle" in config else 2)
    assert model.module.neck is None
    targets = [t for t in cfg["train_pipeline"] if t["type"] == "GenerateTarget"]
    assert len(targets) == 1 and TRANSFORMS.build(dict(targets[0])).type == "RegressionLabel"
