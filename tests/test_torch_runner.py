"""The port's val path (``Runner.val`` and ``python -m
probpose_code_torch.tools.test``) against the JAX package's ``Runner.val``.

The setup: the tiny config (``chip_smoke.TINY_CFG``), the weights
``tests/golden/e2e_weights.pth``, and the fixture's 24 images written as PNG
next to a copy of ``e2e_coco.json`` (``chip_smoke.golden_png_set``: each
image with one zero column and row appended, so that the dataset's clip of
boxes to ``width - 1`` leaves the fixture's boxes as they were). The JAX
runner crops with ``cv2.warpAffine`` on the host, the port with the canvas
warp on the CPU tensor path. Bars: keypoints p99 < 1 px against the JAX
runner; AP and Ex-AP within 0.01 of the JAX runner's and of the fixture's
``stats[0]`` / ``Ex_stats[0]``.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from chip_smoke import GOLDEN, TINY_CFG, KeepSamples, golden_errors, golden_png_set, golden_val_cfg
from probpose_code_torch.engine.checkpoint import load_checkpoint
from probpose_code_torch.engine.runner import Runner

ROOT = Path(__file__).resolve().parents[1]
WEIGHTS = str(GOLDEN / "e2e_weights.pth")
# the visibility accuracy subsamples with NumPy's unseeded global generator
RANDOM_KEYS = ("vis_acc", "vis_thr")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tier-1 runs six test workers at once; one torch thread in this module."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("val")
    data, ann = golden_png_set(root)
    return data, golden_val_cfg(TINY_CFG["model"], ann)


@pytest.fixture(scope="module")
def ours(setup):
    runner = Runner.from_cfg(setup[1], device="cpu")
    load_checkpoint(runner.model, WEIGHTS)
    evaluator = KeepSamples(runner.build_evaluator())
    return runner.val(evaluator), evaluator.samples


@pytest.fixture(scope="module")
def jax_run(setup):
    from probpose_code_tpu.apis.inference import load_weights
    from probpose_code_tpu.config import Config
    from probpose_code_tpu.engine import Runner as JaxRunner

    runner = JaxRunner.from_cfg(Config.fromdict(setup[1]))
    runner.model.init()
    load_weights(runner.model, WEIGHTS)
    evaluator = KeepSamples(runner.build_evaluator())
    return runner.val(evaluator), evaluator.samples


def test_val_matches_jax_runner_and_fixture(setup, ours, jax_run):
    data = setup[0]
    (metrics, samples), (ref_metrics, ref_samples) = ours, jax_run
    assert len(samples) == len(ref_samples) == 62
    by_id = {s.metainfo["id"]: s for s in ref_samples}
    err = np.linalg.norm(np.stack([s.pred_instances.keypoints.reshape(17, 2) for s in samples])
                         - np.stack([by_id[s.metainfo["id"]].pred_instances.keypoints.reshape(17, 2)
                                     for s in samples]), axis=-1)
    assert np.percentile(err, 99) < 1.0, np.percentile(err, 99)
    assert np.percentile(golden_errors(data, samples)[0], 99) < 1.0
    assert set(metrics) == set(ref_metrics)
    for key, fixture in (("AP", data["stats"][0]), ("Ex_AP", data["Ex_stats"][0])):
        assert abs(metrics[f"coco/{key}"] - ref_metrics[f"coco/{key}"]) < 0.01, key
        assert abs(metrics[f"coco/{key}"] - fixture) < 0.01, key
    assert metrics["coco/prob_thr"] == pytest.approx(float(data["prob_thr"]))


def test_runner_needs_cuda_unless_told_cpu(setup, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Runner.from_cfg(setup[1])


def test_cli_prints_the_same_metrics(setup, ours, tmp_path):
    """The config as a file, its data root given by ``--cfg-options``."""
    cfg = setup[1]
    ds = cfg["val_dataloader"]["dataset"]
    (tmp_path / "cfg.py").write_text(
        f"model = {TINY_CFG['model']!r}\n"
        f"val_dataloader = dict(batch_size=16, num_workers=0, dataset=dict(type='CocoDataset', data_root='unset', "
        f"ann_file={ds['ann_file']!r}, data_prefix={ds['data_prefix']!r}, test_mode=True, pipeline={ds['pipeline']!r}))\n"
        f"val_evaluator = {cfg['val_evaluator']!r}\n"
    )
    out = subprocess.run(
        [sys.executable, "-m", "probpose_code_torch.tools.test", str(tmp_path / "cfg.py"), WEIGHTS, "--device", "cpu",
         "--cfg-options", f"val_dataloader.dataset.data_root={ds['data_root']}"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    printed = dict(line.rsplit(": ", 1) for line in out.stdout.splitlines() if line.startswith("coco/"))
    metrics = ours[0]
    assert list(printed) == list(metrics)
    for k, v in metrics.items():
        if not k.endswith(RANDOM_KEYS):
            assert printed[k] == f"{v:.4f}", k

    no_card = subprocess.run([sys.executable, "-m", "probpose_code_torch.tools.test", str(tmp_path / "cfg.py")],
                             cwd=ROOT, capture_output=True, text=True, timeout=300,
                             env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert no_card.returncode != 0 and "no CUDA device" in no_card.stderr
