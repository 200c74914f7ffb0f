"""Training on the CPU: the port's loss, gradients, optimizer and train step
against the JAX package's, on the same weights and batch.

The model is ``TINY_PROBPOSE_CFG`` (``tests/test_models/test_probpose_model.py``:
2 ViT layers of width 64, 4 heads, 192 tokens; ProbMapHead with 2 deconvs to
64 x 48) in f32 with tanh-GELU and ``drop_path_rate=0``. The JAX variables
move to the port through ``state_dict_from_jax``. The JAX side runs with
``fused_layers`` False (its XLA graph) and True (its differentiable Pallas
layer in interpret mode); the port runs its default, K3's plain twin.

Bars, with their reasons: both sides compute in f32 and differ in summation
order, and the XLA graph's max-shifted softmax and clipped LN variance
against K3's clamped exp and unclipped variance (the same values in exact
arithmetic). Measured differences are about 1e-6 relative, so:
- loss dict: rtol 1e-5, atol 1e-6;
- gradients: per parameter, max |diff| <= 1e-4 of that parameter's largest
  |gradient| (measured at most 1.1e-5). The gradients that vanish in exact
  arithmetic (``VANISHING``: a conv bias right before a BatchNorm, the final
  bias under sparsemax) are rounding noise of about 1e-8 on both sides; they
  are held below 1e-6 of the model's largest gradient instead;
- batch statistics after one step: rtol 1e-5, atol 1e-6;
- three AdamW steps: losses rtol 2e-5 (the parameters drift apart by
  rounding; measured 4e-6 at step 3); each parameter's difference, in l2
  norm, within 2e-3 of its change (measured at most 4.3e-4). Adam divides
  each gradient by its own running RMS, so an element whose gradient sits
  near Adam's eps moves by a different fraction of the lr on each side; the
  norm over the tensor keeps those few elements from deciding, and 2e-3 is
  still far below any real fault (a wrong lr, scale, decay or clip moves
  whole tensors by tens of percent). ``VANISHING`` parameters are left out:
  Adam turns their noise into full-size steps of either sign. So is the
  running mean of the BatchNorm each such bias feeds, which the bias shifts;
  its running variance, which a shift does not move, is held at rtol 1e-5.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probpose_code_torch.engine.checkpoint import state_dict_from_jax
from probpose_code_torch.engine.optim import build_optimizer
from probpose_code_torch.models.builder import PoseModel
from probpose_code_torch.parallel import create_train_state, make_train_step
from probpose_code_tpu.engine.checkpoint import convert_torch_state_dict
from probpose_code_tpu.engine.optim import build_optimizer as jax_build_optimizer
from probpose_code_tpu.engine.optim import make_lr_scale_tree
from probpose_code_tpu.models import PoseModel as JaxPoseModel
from probpose_code_tpu.parallel import create_train_state as jax_create_train_state
from probpose_code_tpu.parallel import make_train_step as jax_make_train_step
from tests.test_models.test_probpose_model import TINY_PROBPOSE_CFG, make_batch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tier-1 runs six test workers at once; one torch thread each."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


OPTIM = dict(
    optimizer=dict(type="AdamW", lr=1e-3, betas=(0.9, 0.999), weight_decay=0.1),
    paramwise_cfg=dict(num_layers=2, layer_decay_rate=0.8),
    constructor="LayerDecayOptimWrapperConstructor",
    clip_grad=dict(max_norm=1.0, norm_type=2),
)
# a warmup and a milestone inside the first steps, so the lr moves
SCHEDULE = [
    dict(type="LinearLR", begin=0, end=4, start_factor=0.25, by_epoch=False),
    dict(type="MultiStepLR", begin=0, end=10, milestones=[1], gamma=0.5, by_epoch=True),
]
STEPS_PER_EPOCH, MAX_EPOCHS, STEPS = 2, 10, 3
# gradients that vanish in exact arithmetic: each tower conv's bias (a
# BatchNorm follows) and the final bias (sparsemax is shift-invariant)
VANISHING = {f"head.{t}_layers.{i}.bias" for t in ("probability", "visibility", "oks", "error")
             for i in (0, 4, 8)} | {"head.final_layer.bias"}


def _cfg(fused_layers=None, drop_path_rate=0.0):
    cfg = copy.deepcopy(TINY_PROBPOSE_CFG)
    cfg["backbone"].update(drop_path_rate=drop_path_rate, approximate_gelu=True)
    if fused_layers is not None:
        cfg["backbone"]["fused_layers"] = fused_layers
    return cfg


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _torch_batch(batch):
    return {k: torch.tensor(np.asarray(v)) for k, v in batch.items()}


def _as_state_dict(params, batch_stats):
    return {k: v.numpy() for k, v in state_dict_from_jax({"params": _np(params), "batch_stats": _np(batch_stats)}).items()}


@pytest.fixture(scope="module")
def setup():
    variables = _np(JaxPoseModel(_cfg()).init(seed=0))
    return variables, make_batch(2, seed=0)


@pytest.fixture(scope="module", params=[False, True], ids=["jax_xla", "jax_k3"])
def jax_run(request, setup):
    """The JAX package on one batch (value and grad) and over three steps."""
    variables, batch = setup
    jm = JaxPoseModel(_cfg(request.param))

    def loss(params, stats):
        return jm.loss_fn({"params": params, "batch_stats": stats}, batch, rngs={"dropout": jax.random.PRNGKey(0)})

    (total, (losses, new_state)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        variables["params"], variables["batch_stats"])
    tx, lr_fn = jax_build_optimizer(variables["params"], OPTIM, SCHEDULE, STEPS_PER_EPOCH, MAX_EPOCHS)
    state = jax_create_train_state(variables, tx)
    step = jax_make_train_step(jm, tx, mesh=None, donate=False)
    step_losses = []
    for _ in range(STEPS):
        state, metrics = step(state, batch, jax.random.PRNGKey(0))
        step_losses.append({k: float(v) for k, v in metrics.items()})
    return dict(
        total=float(total), losses={k: float(v) for k, v in losses.items()},
        grads=_as_state_dict(grads, jax.tree_util.tree_map(jnp.zeros_like, variables["batch_stats"])),
        stats=_as_state_dict(variables["params"], new_state["batch_stats"]),
        step_losses=step_losses, final=_as_state_dict(state.params, state.batch_stats),
        final_variables={"params": _np(state.params), "batch_stats": _np(state.batch_stats)},
    )


def _port_model(variables, **kw):
    model = PoseModel(_cfg(**kw), device="cpu")
    model.module.load_state_dict(state_dict_from_jax(variables), strict=True)
    return model


@pytest.fixture(scope="module")
def torch_run(setup):
    """The port on the same batch: one loss and backward, then three steps."""
    variables, batch = setup
    tbatch = _torch_batch(batch)
    model = _port_model(variables)
    total, (losses, new_state) = model.loss_fn(tbatch)
    total.backward()
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy().copy()
             for n, p in model.module.named_parameters()}
    stats = {k: v.numpy().copy() for k, v in new_state["batch_stats"].items()}
    side = dict(
        total=float(total.detach()), losses={k: float(v.detach()) for k, v in losses.items()}, grads=grads, stats=stats,
        none_grads={n for n, p in model.module.named_parameters() if p.grad is None},
        sample_losses=losses, model=model,
    )

    model = _port_model(variables)
    optimizer, _ = build_optimizer(model, OPTIM, SCHEDULE, STEPS_PER_EPOCH, MAX_EPOCHS)
    state = create_train_state(model, optimizer)
    step = make_train_step(model, optimizer)
    side["step_losses"] = []
    for _ in range(STEPS):
        state, metrics = step(state, tbatch, torch.Generator().manual_seed(0))
        side["step_losses"].append({k: float(v) for k, v in metrics.items()})
    side["final"] = {k: v.numpy().copy() for k, v in model.module.state_dict().items()}
    side["state"] = state
    return side


def test_loss_dict_matches_jax(jax_run, torch_run):
    assert set(torch_run["losses"]) == set(jax_run["losses"])
    for k, want in jax_run["losses"].items():
        assert torch_run["losses"][k] == pytest.approx(want, rel=1e-5, abs=1e-6), k
    assert torch_run["total"] == pytest.approx(jax_run["total"], rel=1e-5)


def test_every_gradient_matches_jax(jax_run, torch_run):
    assert set(torch_run["grads"]) == set(jax_run["grads"]) - {
        k for k in jax_run["grads"] if k.endswith(("running_mean", "running_var", "num_batches_tracked"))}
    noise = 1e-6 * max(np.abs(g).max() for g in jax_run["grads"].values())
    for name, got in torch_run["grads"].items():
        want = jax_run["grads"][name]
        assert got.shape == want.shape, name
        if name in VANISHING:
            assert np.abs(got).max() < noise and np.abs(want).max() < noise, name
        else:
            assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max(), name


def test_frozen_and_detached_towers(torch_run):
    """freeze_error: the error tower gets no gradient; the oks and error
    towers always read a detached feature map, so nothing of theirs reaches
    the backbone."""
    model, losses = torch_run["model"], torch_run["sample_losses"]
    assert {n for n in torch_run["none_grads"] if n.startswith("head.error_layers.")} == {
        n for n, _ in model.module.named_parameters() if n.startswith("head.error_layers.")}
    backbone = [p for n, p in model.module.named_parameters() if n.startswith("backbone.")]
    grads = torch.autograd.grad(losses["loss_oks"] + losses["loss_error"], backbone,
                                allow_unused=True, retain_graph=True)
    assert all(g is None or not g.any() for g in grads)
    # the oks tower itself learns (freeze_oks=False), and the heatmap loss reaches the backbone
    assert np.abs(torch_run["grads"]["head.oks_layers.0.weight"]).max() > 0
    assert np.abs(torch_run["grads"]["backbone.layers.0.attn.qkv.weight"]).max() > 0


def test_batch_stats_after_one_step_match_jax(jax_run, torch_run):
    """flax updates the running variance with the biased batch variance; the
    unbiased one would be off by n/(n-1), far outside the bar."""
    for name, got in torch_run["stats"].items():
        want = jax_run["stats"][name]
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=name)
    # a tower's last BN sees n = 2 images x 2 x 2 cells per channel: the
    # unbiased update would add 0.1 * var / (n - 1) to its running variance
    var = torch_run["stats"]["head.probability_layers.9.running_var"]
    batch_var = (var - 0.9) / 0.1  # running_var started at 1
    assert np.abs(0.1 * batch_var / (2 * 2 * 2 - 1)).max() > 10 * (1e-6 + 1e-5 * np.abs(var).max())


def test_lr_per_group_per_step_matches_jax(setup):
    """Each parameter group's lr at each update equals the JAX schedule times
    the JAX layer-decay scale of every parameter in it."""
    variables, _ = setup
    model = _port_model(variables)
    optimizer, lr_fn = build_optimizer(model, OPTIM, SCHEDULE, STEPS_PER_EPOCH, MAX_EPOCHS)
    _, jax_lr_fn = jax_build_optimizer(variables["params"], OPTIM, SCHEDULE, STEPS_PER_EPOCH, MAX_EPOCHS)
    # name each JAX leaf by the port's parameter it converts from
    names = list(model.module.state_dict())
    marked = {k: torch.full(v.shape, float(i)) for i, (k, v) in enumerate(model.module.state_dict().items())}
    tree = convert_torch_state_dict(marked, num_layers=2)
    scales = make_lr_scale_tree(tree["params"], num_layers=2, decay_rate=0.8)
    leaves = jax.tree_util.tree_leaves(tree["params"])
    scale_of = {names[int(np.asarray(leaf).flat[0])]: s for leaf, s in zip(leaves, jax.tree_util.tree_leaves(scales))}
    assert set(scale_of) == set(optimizer.names)
    # the final norm is backbone.ln1 and takes the head's full lr; layer 0 of the backbone two decays
    assert scale_of["backbone.ln1.weight"] == 1.0
    assert scale_of["backbone.layers.0.ln1.weight"] == pytest.approx(0.8 ** 2)
    assert scale_of["backbone.pos_embed"] == pytest.approx(0.8 ** 3)
    for k in range(8):
        jax_lr = float(jax_lr_fn(k))
        assert lr_fn(k) == pytest.approx(jax_lr, rel=1e-6)
        for group, lr in zip(optimizer.groups, optimizer.group_lrs(k)):
            for i in group["index"]:
                assert lr == pytest.approx(jax_lr * scale_of[optimizer.names[i]], rel=1e-6), (k, optimizer.names[i])


def test_three_adamw_steps_match_jax(setup, jax_run, torch_run):
    variables, _ = setup
    for got, want in zip(torch_run["step_losses"], jax_run["step_losses"]):
        assert set(got) == set(want)
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=2e-5, abs=1e-6), k
    start = {k: v.numpy() for k, v in state_dict_from_jax(variables).items()}
    moved = 0
    for name, want in jax_run["final"].items():
        got = torch_run["final"][name]
        prefix, _, leaf = name.rpartition(".")
        tower, _, index = prefix.rpartition(".")
        if leaf == "running_mean" and f"{tower}.{int(index) - 1}.bias" in VANISHING:
            continue
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=name)
            continue
        if name.endswith("num_batches_tracked") or name in VANISHING:
            continue
        change = want - start[name]
        moved += bool(np.abs(change).max() > 0)
        assert np.linalg.norm(got - want) <= 2e-3 * np.linalg.norm(change), name
    assert moved > 0.9 * len(torch_run["state"].model.module.state_dict()) / 2
    assert torch_run["state"].step == STEPS and torch_run["state"].opt_state.count == STEPS


def test_jax_state_after_a_step_moves_to_the_port(jax_run):
    """``state_dict_from_jax`` carries the parameters and the running
    statistics of a trained JAX model, and converts back unchanged."""
    after = jax_run["final_variables"]
    sd = state_dict_from_jax(after)
    model = PoseModel(_cfg(), device="cpu")
    model.module.load_state_dict(sd, strict=True)
    assert not np.allclose(sd["head.deconv_layers.1.running_var"].numpy(), 1.0)
    back = convert_torch_state_dict(sd, num_layers=2)
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    for path, leaf in jax.tree_util.tree_flatten_with_path(after)[0]:
        np.testing.assert_array_equal(np.asarray(flat_back[path]), leaf, err_msg=str(path))


@pytest.mark.parametrize("fused_layers", [None, False], ids=["k3_twin", "eager"])
def test_drop_path_training_descends(setup, fused_layers):
    variables, batch = setup
    model = _port_model(variables, fused_layers=fused_layers, drop_path_rate=0.1)
    optimizer, _ = build_optimizer(model, dict(OPTIM, clip_grad=None), None)
    state = create_train_state(model, optimizer)
    step = make_train_step(model, optimizer)
    gen = torch.Generator().manual_seed(0)
    tbatch = _torch_batch(batch)
    losses = []
    for _ in range(5):
        state, metrics = step(state, tbatch, gen)
        losses.append(float(metrics["loss"]))
        assert float(metrics["grad_norm"]) > 0
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses


@pytest.mark.parametrize("sched", [
    dict(type="LinearLR", begin=2, end=9, start_factor=0.1, end_factor=0.9, by_epoch=False),
    dict(type="MultiStepLR", begin=1, end=4, milestones=[2, 3], gamma=0.3, by_epoch=True),
    dict(type="ConstantLR", begin=3, end=11, factor=0.5, by_epoch=False),
    dict(type="CosineAnnealingLR", begin=1, end=5, eta_min=1e-5, by_epoch=True),
    dict(type="QuadraticWarmupLR", begin=0, end=7, by_epoch=False),
    dict(type="ExponentialLR", begin=2, gamma=0.7, by_epoch=True),
], ids=lambda c: c["type"])
def test_each_schedule_matches_jax(sched):
    """lr(k) of each scheduler type against the JAX package's, over steps
    before, inside and after its range (f32 both sides: rel 1e-6)."""
    from probpose_code_torch.engine.optim import build_schedule
    from probpose_code_tpu.engine.optim import build_schedule as jax_build_schedule

    got = build_schedule([sched], 1e-3, steps_per_epoch=3, max_epochs=6)
    want = jax_build_schedule([sched], 1e-3, steps_per_epoch=3, max_epochs=6)
    for k in range(20):
        assert got(k) == pytest.approx(float(want(k)), rel=1e-6), k


def test_eager_block_trains_as_the_k3_twin(setup):
    """The eager block (``fused_layers=False``: the XLA graph's max-shifted
    softmax and clipped LN variance) and K3's twin give the same loss and
    gradients in training, in f32 up to summation order (rel 1e-5)."""
    variables, batch = setup
    grads = []
    for fused_layers in (None, False):
        model = _port_model(variables, fused_layers=fused_layers)
        total, _ = model.loss_fn(_torch_batch(batch))
        total.backward()
        grads.append({n: p.grad for n, p in model.module.named_parameters() if p.grad is not None})
    assert set(grads[0]) == set(grads[1])
    for name in grads[0]:
        if name not in VANISHING:
            want = grads[0][name]
            assert (grads[1][name] - want).abs().max() <= 1e-5 * want.abs().max(), name
