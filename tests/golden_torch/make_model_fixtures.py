"""Make the port's model fixtures under ``tests/golden_torch/``.

Needs the JAX package, so it runs where it is installed (the card's
machine has none): ``JAX_PLATFORMS=cpu python tests/golden_torch/make_model_fixtures.py``
from the repository root (or name ``classic`` or ``rtmpose`` to make one). For each of ``chip_smoke.CLASSIC_FIXTURE`` (a
narrow ResNet-50 SimpleBaseline with the DARK codec) and
``chip_smoke.RTMPOSE_FIXTURE`` (a narrow CSPNeXt + RTMCCHead with SimCC) it
writes:

- ``<name>_weights.pth``: the port's module with weights drawn from seed 0
  (``PoseModel.init_weights``) and BatchNorm statistics randomized from seed
  1, as a state dict under mmpose's names;
- ``<name>_fixture.npz``: the JAX package's outputs on those weights (loaded
  through ``convert_torch_state_dict``) at the full 256 x 192 input: its
  predict program (flip-TTA and decode) on the crops of the 62 boxes of the
  24 golden images (``tests/golden/e2e_pipeline.npz``, ``e2e_coco.json``),
  the keypoints mapped to the image as its ``attach_predictions`` maps them:
  ``keypoints`` (62, 17, 2) and ``scores`` in the order of ``ids``
  (annotation ids), ``ap``, the JAX CocoMetric's AP of them; and the first
  two ``crops`` with the heatmaps or SimCC vectors on them.

The crops are the port's (``crop_batch``), not the JAX pipeline's
(``cv2.warpAffine``), which differs from it by one grey level on about
0.004% of the pixels: random weights give maps so flat that such a
difference moves an argmax, and DARK's Newton step on them can diverge.
"""

import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from chip_smoke import CLASSIC_FIXTURE, GOLDEN, RTMPOSE_FIXTURE  # noqa: E402
from probpose_code_torch.apis.inference import crop_batch  # noqa: E402
from probpose_code_tpu.datasets.metainfo import parse_pose_metainfo  # noqa: E402
from probpose_code_tpu.engine.checkpoint import convert_torch_state_dict  # noqa: E402
from probpose_code_tpu.engine.runner import attach_predictions  # noqa: E402
from probpose_code_tpu.evaluation import CocoMetric  # noqa: E402
from probpose_code_tpu.models import PoseModel as JaxPoseModel  # noqa: E402
from probpose_code_tpu.structures import InstanceData, PoseDataSample  # noqa: E402
from tests.test_torch_classic_heatmap import seeded_state_dict  # noqa: E402


def golden_instances(cfg):
    """The golden fixture's 62 boxes (in annotation order) cut as ``cfg``'s
    test pipeline cuts them, by the port's ``crop_batch``: the card's crop
    equals it bit for bit (the same f32 operations one at a time), so the
    JAX package is held on the crops the port feeds its model. Returns
    (annotations, crops (62, 256, 192, 3), centers, scales)."""
    data = np.load(GOLDEN / "e2e_pipeline.npz")
    anns = json.loads((GOLDEN / "e2e_coco.json").read_text())["annotations"]
    crops, centers, scales = [], [], []
    for a in anns:
        x, y, w, h = a["bbox"]
        cut, center, scale = crop_batch(data[f"img_{a['image_id']}"], np.array([[x, y, x + w, y + h]], np.float32),
                                        (192, 256), "cpu", cfg)
        crops.append(cut[0].numpy())
        centers.append(center[0])
        scales.append(scale[0])
    return anns, np.stack(crops), np.stack(centers), np.stack(scales)


def make(fixture):
    cfg = fixture["cfg"]
    sd = seeded_state_dict(cfg["model"], seed=0)
    torch.save(sd, fixture["weights"])
    model = JaxPoseModel(cfg["model"], metainfo=parse_pose_metainfo({"dataset_name": "coco"}))
    variables = convert_torch_state_dict({k: v.numpy() for k, v in sd.items()})

    anns, crops, centers, scales = golden_instances(cfg)
    predict = model.make_predict(jit=False)
    preds = [{k: np.asarray(v) for k, v in predict(variables, crops[i:i + 16]).items()}
             for i in range(0, len(crops), 16)]
    preds = {k: np.concatenate([p[k] for p in preds]) for k in preds[0]}
    samples = []
    for a, center, scale in zip(anns, centers, scales):
        sample = PoseDataSample(metainfo=dict(id=a["id"], img_id=a["image_id"], input_center=center,
                                              input_scale=scale, input_size=(192, 256)))
        x, y, w, h = a["bbox"]
        sample.gt_instances = InstanceData(bboxes=np.array([[x, y, x + w, y + h]], np.float32),
                                           bbox_scores=np.ones(1, np.float32))
        samples.append(sample)
    attach_predictions(preds, samples, (192, 256))
    metric = CocoMetric(ann_file=str(GOLDEN / "e2e_coco.json"), extended=[False])
    metric.dataset_meta = parse_pose_metainfo({"dataset_name": "coco"})
    metric.process(None, samples)
    ap = metric.compute_metrics(metric.results)["AP"]

    np.savez_compressed(
        fixture["outputs"], ids=np.array([a["id"] for a in anns]),
        keypoints=np.stack([np.asarray(s.pred_instances.keypoints).reshape(17, 2) for s in samples]).astype(np.float32),
        scores=np.stack([np.asarray(s.pred_instances.keypoint_scores).reshape(17) for s in samples]).astype(np.float32),
        ap=np.float64(ap), crops=crops[:2].astype(np.uint8),
        **{k: preds[k][:2].astype(np.float32) for k in fixture["keys"]},
    )
    print(f"{fixture['name']}: {len(samples)} instances, AP {ap:.4f}, weights "
          f"{Path(fixture['weights']).stat().st_size} B, outputs {Path(fixture['outputs']).stat().st_size} B")


if __name__ == "__main__":
    torch.set_num_threads(4)
    for fixture in (CLASSIC_FIXTURE, RTMPOSE_FIXTURE):
        if len(sys.argv) < 2 or fixture["name"] in sys.argv[1:]:
            make(fixture)
