"""The port stands alone and never falls back between CPU and card.

- Importing every module of ``probpose_code_torch`` and ``chip_smoke`` loads
  no ``jax*``, ``flax*``, ``cv2`` or ``probpose_code_tpu*`` module.
- ``init_model`` with ``device=None`` raises when CUDA is absent.
- A tensor that is not on the CPU never reaches a plain twin: every call of a
  plain twin in the kernel wrappers (K1, K2, K2b, K3, and the JPEG decode's
  call of the plain decoder) sits under a ``device.type == "cpu"`` test
  (static check), and a tensor on another device makes the wrapper raise
  before any plain code runs.
- ``chip_smoke.py`` alone, without the repository, fails without printing a
  result.
"""

import ast
import inspect
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "cv2", "probpose_code_tpu")


def test_port_imports_nothing_of_jax():
    code = (
        "import importlib, json, pkgutil, sys\n"
        "import probpose_code_torch\n"
        "for m in pkgutil.walk_packages(probpose_code_torch.__path__, 'probpose_code_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(json.dumps(bad))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_sources_name_no_jax():
    for path in [*sorted((ROOT / "probpose_code_torch").rglob("*.py")), ROOT / "chip_smoke.py"]:
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN, f"{path.name} imports {n}"


def test_init_model_without_cuda_raises(monkeypatch):
    from chip_smoke import TINY_CFG
    from probpose_code_torch.apis import init_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_model(TINY_CFG)


PLAIN = {"vit_layer_plain", "_layer_plain", "expected_oks_decode_to_input_space", "oks_convolve_plain",
         "vit_layer_train_plain", "decode_plain"}


def _is_cpu_test(node):
    src = ast.unparse(node)
    return 'device.type == "cpu"' in src or "device.type == 'cpu'" in src


def test_plain_twins_only_under_a_cpu_test():
    from probpose_code_torch.ops.kernels import expected_oks, jpeg, vit_layer, vit_layer_train

    for fn in (vit_layer.vit_layer_prepared, expected_oks.expected_oks_decode, expected_oks.oks_convolve,
               vit_layer_train.vit_layer_train, jpeg.decode_batch):
        tree = ast.parse(inspect.getsource(fn))
        guarded = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.If) and _is_cpu_test(node.test):
                for sub in node.body:
                    guarded.update(id(n) for n in ast.walk(sub))
        calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call) and getattr(n.func, "id", None) in PLAIN]
        assert calls, fn.__name__
        for call in calls:
            assert id(call) in guarded, f"{fn.__name__} calls {call.func.id} outside its CPU branch"


def test_non_cpu_tensor_never_reaches_a_plain_twin(monkeypatch):
    from probpose_code_torch.ops.kernels import expected_oks, jpeg, vit_layer, vit_layer_train

    def boom(*a, **k):
        raise AssertionError("a plain twin ran for a tensor off the CPU")

    for mod, name in ((vit_layer, "vit_layer_plain"), (vit_layer, "_layer_plain"),
                      (expected_oks, "expected_oks_decode_to_input_space"), (expected_oks, "oks_convolve_plain"),
                      (vit_layer_train, "vit_layer_train_plain"), (vit_layer_train, "_layer_plain"),
                      (jpeg, "decode_plain")):
        monkeypatch.setattr(mod, name, boom)
    stream = (ROOT / "tests" / "golden_torch" / "golden" / "1.jpg").read_bytes()
    with pytest.raises(ValueError, match="unsupported device"):
        jpeg.decode_batch([stream], torch.device("meta"))
    hm = torch.empty(2, 17, 64, 48, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        expected_oks.expected_oks_decode(hm, (192, 256))
    with pytest.raises(ValueError, match="unsupported device"):
        expected_oks.oks_convolve(hm)
    C, F = 64, 128
    x = torch.empty(2, 16, C, device="meta")
    w = [torch.empty(s, device="meta") for s in
         [(C,), (C,), (C, 3 * C), (3 * C,), (C, C), (C,), (C,), (C,), (C, F), (F,), (F, C), (C,)]]
    with pytest.raises(ValueError, match="unsupported device"):
        vit_layer.vit_layer(x, *w, num_heads=4)
    with pytest.raises(ValueError, match="unsupported device"):
        vit_layer_train.vit_layer_train(x, *w, num_heads=4)


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
