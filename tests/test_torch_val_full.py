"""Full-width twins of ``tests/test_apis/test_e2e_parity_full.py`` and
``test_e2e_parity_shipped.py`` through the port's ``Runner.val``.

The real ProbPose-S geometry (width 384, 12 layers, deconv 256) with the
fixture's weights (``tools/_e2e_torch_model.build_e2e_model(full=True)``,
rebuilt from its seed) runs the val path (PNG files, the flagship's val
pipeline, the canvas warp, predict, CocoMetric) over the 24 images of
``tests/golden/e2e_full_pipeline.npz``, held to those files' bars
(``chip_smoke.VAL_BARS``): f32 p99 < 1.5 px, max < 8 px, aux fields 5e-3, AP
and Ex-AP within 0.02; the shipped bf16 / tanh-GELU settings p50 < 0.2 px,
p90 < 0.75 px, aux fields 2e-2, AP and Ex-AP within 0.05. Slow, as they are;
``chip_smoke.py``'s ``val_full`` and ``val_shipped`` phases run the same on
the card.
"""

import pytest

from chip_smoke import full_fixture_state, run_val_golden

pytestmark = pytest.mark.slow


@pytest.fixture(scope="module")
def state_dict():
    return full_fixture_state()


@pytest.mark.parametrize("variant", ["full", "shipped"])
def test_full_width_val_against_the_fixture(state_dict, variant):
    report, _ = run_val_golden(variant, "cpu", state_dict)
    assert report["ok"], report
