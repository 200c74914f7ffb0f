"""Make the port's JPEG fixtures under ``tests/golden_torch/``.

Needs OpenCV and the JAX package, so it runs where they are installed (the
card's machine has neither): ``python tests/golden_torch/make_jpeg_fixtures.py``
from the repository root, with ``JAX_PLATFORMS=cpu``. It writes:

- ``golden/<id>.jpg``: the 24 images of ``tests/golden/e2e_full_pipeline.npz``
  with one zero column and row appended (as ``chip_smoke.golden_png_set``
  appends them), encoded by ``cv2.imencode`` as 4:2:0 baseline at quality 95;
- ``formats/*.jpg``: small crops of those images (at most 128 x 96, odd
  sizes among them) in the other modes the port decodes: 4:4:4, 4:2:2,
  4:4:0, grayscale, progressive, restart intervals, EXIF orientation 6 and
  8 (an APP1 segment spliced in after APP0), and one truncated stream;
- ``val_reference.npz``: the JAX package's ``Runner.val`` on the CPU over
  the golden JPEGs (read by ``cv2.imread``, cropped by ``cv2.warpAffine``)
  at the fixture's full ProbPose-S geometry in f32 with its seed-7 weights
  (``tools/_e2e_torch_model.build_e2e_model(full=True)``): each instance's
  keypoints and scores (in annotation-id order), AP, Ex-AP and the
  probability threshold.
"""

import json
import struct
import sys
import tempfile
from pathlib import Path

import cv2
import numpy as np

ROOT = Path(__file__).resolve().parents[2]
OUT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from chip_smoke import (  # noqa: E402
    GOLDEN,
    KeepSamples,
    full_fixture_state,
    full_model_cfg,
    golden_jpeg_set,
    golden_val_cfg,
)

S = cv2.IMWRITE_JPEG_SAMPLING_FACTOR
# name -> (source image id, rows, cols, grayscale, cv2.imencode parameters, EXIF orientation)
FORMATS = {
    "444": (3, 95, 127, False, [S, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444], 0),
    "422": (5, 90, 121, False, [S, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422], 0),
    "440": (7, 93, 118, False, [S, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440], 0),
    "gray": (9, 87, 113, True, [], 0),
    "progressive": (11, 94, 125, False, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1], 0),
    "restart": (13, 96, 128, False, [cv2.IMWRITE_JPEG_RST_INTERVAL, 2], 0),
    "exif6": (15, 90, 120, False, [], 6),
    "exif8": (17, 91, 119, False, [], 8),
}


def with_orientation(data: bytes, orientation: int) -> bytes:
    """``data`` with an APP1 Exif segment (big-endian TIFF, IFD0 holding
    only the orientation tag) inserted after its APP0 segment."""
    tiff = b"MM\x00*" + struct.pack(">IH", 8, 1) + struct.pack(">HHIHH", 0x0112, 3, 1, orientation, 0)
    payload = b"Exif\x00\x00" + tiff + struct.pack(">I", 0)
    seg = b"\xff\xe1" + struct.pack(">H", len(payload) + 2) + payload
    end = 4 + int.from_bytes(data[4:6], "big")
    return data[:end] + seg + data[end:]


def encode(img, params) -> bytes:
    ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 95] + params)
    assert ok
    return buf.tobytes()


def main():
    data = np.load(GOLDEN / "e2e_full_pipeline.npz")
    (OUT / "golden").mkdir(exist_ok=True)
    (OUT / "formats").mkdir(exist_ok=True)
    for i in range(1, 25):
        img = np.pad(data[f"img_{i}"], ((0, 1), (0, 1), (0, 0)))
        (OUT / "golden" / f"{i}.jpg").write_bytes(encode(img, [S, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420]))
    for name, (src, rows, cols, gray, params, orientation) in FORMATS.items():
        img = np.ascontiguousarray(data[f"img_{src}"][:rows, :cols])
        if gray:
            img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
        jpg = encode(img, params)
        if orientation:
            jpg = with_orientation(jpg, orientation)
        (OUT / "formats" / f"{name}.jpg").write_bytes(jpg)
    restart = (OUT / "formats" / "restart.jpg").read_bytes()
    (OUT / "formats" / "truncated.jpg").write_bytes(restart[:len(restart) * 3 // 5])
    write_reference()


def write_reference():
    import torch

    from probpose_code_tpu.apis.inference import load_weights
    from probpose_code_tpu.config import Config
    from probpose_code_tpu.engine import Runner

    with tempfile.TemporaryDirectory() as tmp:
        _, ann = golden_jpeg_set(tmp, full=True)
        weights = Path(tmp) / "weights.pth"
        torch.save(full_fixture_state(), weights)
        runner = Runner.from_cfg(Config.fromdict(golden_val_cfg(full_model_cfg(), ann)))
        runner.model.init()
        load_weights(runner.model, str(weights))
        evaluator = KeepSamples(runner.build_evaluator())
        metrics = runner.val(evaluator)
    samples = sorted(evaluator.samples, key=lambda s: s.metainfo["id"])
    inst = [s.pred_instances for s in samples]
    np.savez_compressed(
        OUT / "val_reference.npz",
        ids=np.array([s.metainfo["id"] for s in samples]),
        keypoints=np.stack([np.asarray(p.keypoints).reshape(17, 2) for p in inst]).astype(np.float32),
        keypoint_scores=np.stack([np.asarray(p.keypoint_scores).reshape(17) for p in inst]).astype(np.float32),
        AP=metrics["coco/AP"], Ex_AP=metrics["coco/Ex_AP"], prob_thr=metrics["coco/prob_thr"],
    )
    print(json.dumps({k: float(v) for k, v in metrics.items()}))


if __name__ == "__main__":
    main()
