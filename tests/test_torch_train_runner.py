"""The port's training runner (``Runner.train``, hooks, checkpoints and
``python -m probpose_code_torch.tools.train``) against the JAX package.

The setup: the tiny config at f32 with drop_path 0 and the flagship's head
losses, train pipeline, optimizer and schedules
(``chip_smoke.tiny_train_cfg``), over ``chip_smoke.mini_coco_set`` (six PNG
images, twelve persons, made from a seed), batches of 6: two steps an epoch.

- The first four loss dicts of the port's ``Runner.train`` match the JAX
  ``Runner.train`` (a mesh of one device) from one initialization (the JAX
  port's seed-0 weights, carried to JAX and back) and one batch order:
  relative error below 1e-3 in every loss (the crops differ by up to one
  grey level where cv2 rounds; the maps by 2e-5); measured: 9.4e-5 at
  most.
- Two epochs straight equal one epoch, then ``--resume`` and one more,
  bitwise on the CPU: parameters, BatchNorm statistics, Adam moments, step
  and lr.
- The CLI trains two epochs, validates each, writes ``epoch_1.pth``,
  ``epoch_2.pth`` and ``best.pth``, logs to ``train.log`` and
  ``vis_data/scalars.json``; ``best.pth`` follows ``save_best`` (an exact
  key or a ``/<key>`` suffix, rule ``greater``), and it loads in the JAX
  package (``load_weights`` through ``convert_torch_state_dict``) and
  predicts what the port predicts: keypoints within 1e-3 input pixels, every
  other field within 1e-5 (``tests/test_torch_model.py``'s bars: both sides
  compute in f32 and differ in summation order only).
- ``ExpMomentumEMA``'s blend, swap-in and swap-back equal the JAX hook's on
  a fixed parameter sequence (1e-7).
- ``merge_args`` equals the JAX one for ``--amp``, ``--auto-scale-lr`` and
  ``--cfg-options``; the CLI needs CUDA unless given ``--device cpu``.
"""

import copy
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from chip_smoke import mini_coco_set, tiny_train_cfg
from probpose_code_torch.engine.checkpoint import load_checkpoint, read_checkpoint, state_dict_from_jax
from probpose_code_torch.engine.hooks import ExpMomentumEMA, Hook
from probpose_code_torch.engine.runner import Runner
from probpose_code_torch.models.builder import PoseModel
from probpose_code_torch.tools import train as train_cli

ROOT = Path(__file__).resolve().parents[1]
LOSS_REL = 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tier-1 runs six test workers at once; one torch thread in this module
    (and the bitwise comparisons need the same thread count on both sides)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("train")
    ann = mini_coco_set(root / "data")
    cfg = tiny_train_cfg(ann, batch_size=6)
    cfg_file = root / "cfg.py"
    cfg_file.write_text("".join(f"{k} = {v!r}\n" for k, v in cfg.items())
                        + "auto_scale_lr = dict(base_batch_size=24)\n")
    return root, cfg, cfg_file


def cli(cfg_file, work_dir, *extra):
    return train_cli.main([str(cfg_file), "--work-dir", str(work_dir), "--device", "cpu", *extra])


@pytest.fixture(scope="module")
def straight(setup):
    root, _, cfg_file = setup
    return cli(cfg_file, root / "straight")


class Record(Hook):
    def __init__(self):
        self.losses = []

    def after_train_iter(self, runner, step, metrics):
        self.losses.append({k: float(v) for k, v in metrics.items()})


def test_cli_trains_validates_and_writes_checkpoints(straight):
    wd = Path(straight.work_dir)
    assert {"epoch_1.pth", "epoch_2.pth", "best.pth", "train.log"} <= set(os.listdir(wd))
    assert straight.state.step == 4 and [t["crops"] for t in straight.train_times] == [12, 12]
    log = (wd / "train.log").read_text()
    assert log.count("val: coco/vis_acc") == 2 and "Epoch [2][2/2] lr: " in log
    scalars = (wd / "vis_data" / "scalars.json").read_text().splitlines()
    assert len(scalars) == 6 and '"val/coco/AP"' in scalars[2] and '"train/loss_kpt"' in scalars[0]
    ckpt = read_checkpoint(str(wd / "epoch_2.pth"))
    assert ckpt["meta"]["epoch"] == 2 and ckpt["meta"]["step"] == ckpt["optimizer"]["count"] == 4
    assert ckpt["meta"]["dataset_meta"]["dataset_name"] == "coco"
    live = straight.model.module.state_dict()
    assert all(torch.equal(live[k], v) for k, v in ckpt["state_dict"].items())
    for key in ("first_batch", "loader", "step", "hooks", "val", "checkpoint", "window"):
        assert all(t[key] >= 0 for t in straight.train_times), key


def test_resume_equals_straight(setup, straight):
    root, _, cfg_file = setup
    first = cli(cfg_file, root / "broken", "--cfg-options", "train_cfg.max_epochs=1")
    assert first.state.step == 2
    resumed = cli(cfg_file, root / "broken", "--resume")
    assert resumed.train_times[0]["crops"] == 12 and len(resumed.train_times) == 1
    assert resumed.state.step == straight.state.step == 4
    assert resumed.train_log[-1]["lr"] == straight.train_log[-1]["lr"] == straight.lr_fn(4)
    a, b = straight.model.module.state_dict(), resumed.model.module.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    sa, sb = straight.state.opt_state, resumed.state.opt_state
    assert sa.count == sb.count == 4
    assert all(torch.equal(x, y) for x, y in zip(sa.mu + sa.nu, sb.mu + sb.nu))
    assert resumed.train_log[-1] == straight.train_log[-1]


def test_best_checkpoint_follows_save_best(straight, tmp_path):
    runner = straight
    saved = runner.work_dir, runner.best_metric, runner.save_best
    try:
        runner.work_dir, runner.best_metric = str(tmp_path), -np.inf
        best = tmp_path / "best.pth"
        runner._maybe_save_best({"coco/AP": 0.1})
        assert best.exists()
        best.unlink()
        runner._maybe_save_best({"coco/AP": 0.05})
        assert not best.exists()
        runner.save_best = "AP"  # a suffix of the prefixed key
        runner._maybe_save_best({"coco/AP": 0.2, "coco/AR": 0.9})
        assert best.exists() and runner.best_metric == 0.2
    finally:
        runner.work_dir, runner.best_metric, runner.save_best = saved


def test_best_checkpoint_predicts_in_jax(setup, straight):
    from probpose_code_tpu.engine.checkpoint import load_torch_checkpoint
    from probpose_code_tpu.models import PoseModel as JaxPoseModel

    cfg = setup[1]
    path = str(Path(straight.work_dir) / "best.pth")
    ours = PoseModel(cfg["model"], device="cpu")
    meta = load_checkpoint(ours, path)["meta"]
    ours.metainfo = meta["dataset_meta"]
    restored = load_torch_checkpoint(path, num_layers=2)
    ref = JaxPoseModel(cfg["model"], metainfo=restored["meta"]["dataset_meta"])
    ref.variables = restored["variables"]
    assert list(ref.metainfo["flip_indices"]) == list(ours.metainfo["flip_indices"])
    crops = np.round(np.random.RandomState(6).rand(3, 256, 192, 3) * 255).astype(np.float32)
    want = {k: np.asarray(v) for k, v in ref.make_predict(jit=True)(ref.variables, crops).items()}
    got = {k: v.numpy() for k, v in ours.predict(torch.from_numpy(crops)).items()}
    assert set(got) == set(want)
    np.testing.assert_allclose(got["keypoints"], want["keypoints"], atol=1e-3)
    for k in want:
        if k != "keypoints":
            np.testing.assert_allclose(got[k], want[k], atol=1e-5, err_msg=k)


def test_first_losses_match_jax_runner(setup, tmp_path):
    """One initialization for both: the port's seed-0 weights as JAX
    variables (``convert_torch_state_dict``) and back (``state_dict_from_jax``,
    a round trip that is exact). The JAX runner's orbax checkpoint writing
    is left out; it does not touch the losses."""
    from probpose_code_tpu.config import Config as JaxConfig
    from probpose_code_tpu.engine import Runner as JaxRunner
    from probpose_code_tpu.engine.checkpoint import convert_torch_state_dict
    from probpose_code_tpu.engine.hooks import Hook as JaxHook

    cfg = copy.deepcopy(setup[1])
    cfg.pop("val_evaluator")
    cfg["default_hooks"]["checkpoint"]["interval"] = 10  # one checkpoint, at the end

    class JaxRecord(JaxHook):
        def __init__(self):
            self.losses = []

        def after_train_iter(self, runner, step, metrics):
            self.losses.append({k: float(v) for k, v in metrics.items()})

    ours = Runner.from_cfg(dict(cfg, work_dir=str(tmp_path / "torch")), device="cpu")
    jax_runner = JaxRunner.from_cfg(JaxConfig.fromdict(dict(cfg, work_dir=str(tmp_path / "jax"))))
    jax_runner.model.variables = convert_torch_state_dict(ours.model.module.state_dict(), num_layers=2)
    jax_runner.save_checkpoint = lambda path: None
    ours.model.module.load_state_dict(state_dict_from_jax(jax_runner.model.variables))
    want, got = JaxRecord(), Record()
    jax_runner.hooks.append(want)
    ours.hooks.append(got)
    jax_runner.train()
    ours.train()
    ours.close()
    assert len(got.losses) == len(want.losses) == 4
    for step, (a, b) in enumerate(zip(got.losses, want.losses)):
        for k, v in b.items():
            if k.startswith("loss"):
                assert abs(a[k] - v) <= LOSS_REL * abs(v), (step, k, a[k], v)


def test_ema_hook_matches_jax():
    import jax.numpy as jnp
    from probpose_code_tpu.engine.hooks import ExpMomentumEMA as JaxEMA

    @dataclasses.dataclass
    class JaxState:
        params: list
        batch_stats: dict

        def replace(self, **kw):
            return dataclasses.replace(self, **kw)

    rng = np.random.RandomState(0)
    seq = [[rng.randn(3, 4).astype(np.float32), rng.randn(5).astype(np.float32)] for _ in range(4)]
    module = torch.nn.Module()
    module.a, module.b = (torch.nn.Parameter(torch.zeros(s.shape)) for s in seq[0])
    ours = SimpleNamespace(model=SimpleNamespace(module=module, batch_stats=dict), epoch=0)
    theirs = SimpleNamespace(state=None, epoch=0)
    hook, ref_hook = ExpMomentumEMA(momentum=0.01, gamma=3), JaxEMA(momentum=0.01, gamma=3)
    for step, (a, b) in enumerate(seq, start=1):
        with torch.no_grad():
            module.a.copy_(torch.from_numpy(a))
            module.b.copy_(torch.from_numpy(b))
        theirs.state = JaxState([jnp.asarray(a), jnp.asarray(b)], {})
        hook.after_train_iter(ours, step, {})
        ref_hook.after_train_iter(theirs, step, {})
    for e, r in zip(hook.ema_params, ref_hook.ema_params):
        np.testing.assert_allclose(e.numpy(), np.asarray(r), rtol=1e-7, atol=1e-7)
    hook.before_eval(ours)
    ref_hook.before_eval(theirs)
    for p, r in zip(module.parameters(), theirs.state.params):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(r), rtol=1e-7, atol=1e-7)
    hook.after_eval(ours)
    ref_hook.after_eval(theirs)
    for p, r, live in zip(module.parameters(), theirs.state.params, seq[-1]):
        assert torch.equal(p.detach(), torch.from_numpy(live)) and np.array_equal(np.asarray(r), live)


def test_merge_args_equals_jax(setup):
    """Both ``merge_args`` on the same parsed arguments (the JAX parser
    reads ``sys.argv`` and lacks ``--device``) give the same config."""
    import importlib.util

    from probpose_code_torch.config import Config
    from probpose_code_tpu.config import Config as JaxConfig

    spec = importlib.util.spec_from_file_location("_jax_train_cli", ROOT / "tools" / "train.py")
    jax_cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_cli)
    cfg_file = str(setup[2])
    lr = Config.fromfile(cfg_file)["optim_wrapper"]["optimizer"]["lr"]
    for argv, want_lr in (([cfg_file, "--amp", "--auto-scale-lr"], lr * 6 / 24),
                          ([cfg_file, "--auto-scale-lr", "--work-dir", "wd", "--seed", "3", "--resume",
                            "--cfg-options", "train_cfg.max_epochs=7", "optim_wrapper.optimizer.lr=0.002"], 0.002)):
        args = train_cli.parse_args(argv)
        ours = train_cli.merge_args(Config.fromfile(cfg_file), args)
        theirs = jax_cli.merge_args(JaxConfig.fromfile(cfg_file), args)
        assert json.loads(json.dumps(ours)) == json.loads(json.dumps(theirs))
        assert ours["optim_wrapper"]["optimizer"]["lr"] == want_lr


def test_cli_needs_cuda_unless_told_cpu(setup):
    out = subprocess.run([sys.executable, "-m", "probpose_code_torch.tools.train", str(setup[2])], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and "no CUDA device" in out.stderr
