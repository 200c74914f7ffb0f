"""Make the port's model fixtures under ``tests/golden_torch/``.

Needs the JAX package, so it runs where it is installed (the card's
machine has none): ``JAX_PLATFORMS=cpu python tests/golden_torch/make_model_fixtures.py``
from the repository root (or name ``classic``, ``rtmpose``, ``wholebody``,
``dpm``, ``face``, ``scnet``, ``vipnas``, ``rtmw``, ``hourglass``, ``cpm``, ``mspn``, ``litehrnet``, ``swin``,
``hrformer``, ``pvtv2``, ``rle``, ``dsnt`` or ``vis`` to make one). For each of ``chip_smoke.CLASSIC_FIXTURE``
(a narrow ResNet-50 SimpleBaseline with the DARK codec),
``chip_smoke.RTMPOSE_FIXTURE`` (a narrow CSPNeXt + RTMCCHead with SimCC),
``chip_smoke.WHOLEBODY_FIXTURE`` (the same with 133 outputs under
COCO-WholeBody's metainfo), ``chip_smoke.DPM_FIXTURE`` (DoubleProbPose-S
with its ViT in f32) and ``chip_smoke.FACE_FIXTURES`` (``face``: the narrow
CSPNeXt + RTMCCHead with 106 outputs under LaPa's metainfo, and a narrow
ResNet-18 + ``GlobalAveragePooling`` + ``RegressionHead`` of 98 joints under
WFLW's, both at 256 x 256 on the golden persons' face boxes) and
``chip_smoke.CNN_ZOO_FIXTURES`` (SCNet-50 with a narrow HeatmapHead, and a
narrow ViPNAS_ResNet with ViPNASHead, both MSRA at 193 x 257) and
``chip_smoke.MULTISTAGE_FIXTURES`` (narrow RTMW with 133 keypoints, a
two-stack HourglassNet with CPMHead, CPM, MSPN with the pose refine
machine) and ``chip_smoke.TOPDOWN_REST_FIXTURES`` (narrow LiteHRNet, Swin,
HRFormer and PVTv2 with a HeatmapHead; the JAX LiteHRNet cannot be jitted,
and its predict runs eagerly, as every fixture's here) and
``chip_smoke.REGRESSION_FIXTURES`` (a narrow ResNet-18 without a neck with
RLEHead, with DSNTHead at beta = 10, and with VisPredictHead around a
HeatmapHead) it writes:

- ``<name>_weights.pth``: the port's module with weights drawn from seed 0
  (``PoseModel.init_weights``) and BatchNorm statistics randomized from seed
  1, as a state dict under mmpose's names; the DoubleProbPose fixture's
  weights (about 90 MB) are not written: ``chip_smoke.dpm_fixture_state``
  makes them from seeds where they are used, and so does
  ``chip_smoke.seeded_fixture_state`` the SCNet, ViPNAS, RTMW, hourglass,
  CPM, MSPN, LiteHRNet, Swin, HRFormer, PVTv2, RLE, DSNT and Vis fixtures';
- ``<name>_fixture.npz``: the JAX package's outputs on those weights (loaded
  through ``convert_torch_state_dict``; for the SCNet and ViPNAS fixtures,
  and the four multi-stage and SimCC ones, whose models it does not know
  or whose names it reads from the other side, the JAX variables that the port's
  ``state_dict_from_jax`` carries onto them exactly, ``carried_variables``)
  at the fixture's input (256 x 192, or 257 x 193): its
  predict program (flip-TTA and decode) on the crops of the 62 boxes of the
  24 golden images (``tests/golden/e2e_pipeline.npz``, ``e2e_coco.json``),
  the keypoints mapped to the image as its ``attach_predictions`` maps them:
  ``keypoints`` (62, K, 2) and ``scores`` in the order of ``ids``
  (annotation ids), the fixture's ``aux`` outputs, a SimCC fixture's
  ``ties`` (``chip_smoke.SIMCC_TIE_REL``; the whole-body and face ones),
  ``ap``, the JAX metric's AP of them (CocoMetric's, or for the whole-body
  fixture CocoWholeBodyMetric's whole-body AP on the golden annotations in
  COCO-WholeBody's layout, ``chip_smoke.wholebody_set_from_coco``), or a
  face fixture's NME (the JAX ``NME`` against the golden faces in the
  fixture dataset's layout, ``chip_smoke.face_fixture_gt``); and the first
  two ``crops`` with the heatmaps, SimCC vectors or keypoints on them.

The JAX package builds the regression fixture's model without its neck
(its ``RegressionHead`` pools by itself), which is the port's model with
it; ``head.fc`` is carried across by hand.

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

from chip_smoke import (  # noqa: E402
    CLASSIC_FIXTURE,
    CNN_ZOO_FIXTURES,
    DPM_FIXTURE,
    FACE_FIXTURES,
    GOLDEN,
    MULTISTAGE_FIXTURES,
    REGRESSION_FIXTURES,
    RTMPOSE_FIXTURE,
    TOPDOWN_REST_FIXTURES,
    SIMCC_TIE_REL,
    WHOLEBODY_FIXTURE,
    face_fixture_gt,
    fixture_output_name,
    golden_boxes,
    wholebody_set_from_coco,
)
from probpose_code_torch.apis.inference import crop_batch  # noqa: E402
from probpose_code_torch.engine.checkpoint import state_dict_from_jax  # noqa: E402
from probpose_code_tpu.datasets.metainfo import parse_pose_metainfo  # noqa: E402
from probpose_code_tpu.engine.checkpoint import convert_torch_state_dict  # noqa: E402
from probpose_code_tpu.engine.runner import attach_predictions  # noqa: E402
from probpose_code_tpu.evaluation import CocoMetric, CocoWholeBodyMetric  # noqa: E402
from probpose_code_tpu.evaluation.metrics.keypoint_2d_metrics import NME  # noqa: E402
from probpose_code_tpu.models import PoseModel as JaxPoseModel  # noqa: E402
from probpose_code_tpu.structures import InstanceData, PoseDataSample  # noqa: E402
from tests.test_torch_classic_heatmap import seeded_state_dict  # noqa: E402


def golden_instances(cfg, boxes, input_size):
    """The golden fixture's 62 person or face boxes (``chip_smoke.
    golden_boxes``, in annotation order) cut as ``cfg``'s test pipeline cuts
    them at ``input_size``, by the port's ``crop_batch``: the card's crop
    equals it bit for bit (the same f32 operations one at a time), so the
    JAX package is held on the crops the port feeds its model. Returns
    (annotations, crops (62, h, w, 3), centers, scales)."""
    data = np.load(GOLDEN / "e2e_pipeline.npz")
    anns = json.loads((GOLDEN / "e2e_coco.json").read_text())["annotations"]
    crops, centers, scales = [], [], []
    for a, box in zip(anns, golden_boxes(anns, boxes)):
        cut, center, scale = crop_batch(data[f"img_{a['image_id']}"], box[None], input_size, "cpu", cfg)
        crops.append(cut[0].numpy())
        centers.append(center[0])
        scales.append(scale[0])
    return anns, np.stack(crops), np.stack(centers), np.stack(scales)


def jax_ap(samples, dataset):
    """The JAX metric's AP of ``samples``, as ``chip_smoke.golden_fixture_ap``
    takes the port's."""
    import tempfile

    if dataset in ("lapa", "wflw"):
        gt = face_fixture_gt(dataset)
        metric = NME(norm_mode="keypoint_distance")
        metric.dataset_meta = parse_pose_metainfo({"dataset_name": dataset})
        metric.process(None, [dict(pred_instances=dict(keypoints=np.asarray(s.pred_instances.keypoints)),
                                   gt_instances=dict(keypoints=gt[s.metainfo["id"]][0],
                                                     keypoints_visible=gt[s.metainfo["id"]][1])) for s in samples])
        return metric.compute_metrics(metric.results)["NME"]
    with tempfile.TemporaryDirectory() as tmp:
        if dataset == "coco_wholebody":
            ann = Path(tmp, "wholebody.json")
            wholebody_set_from_coco(GOLDEN / "e2e_coco.json", ann)
            metric = CocoWholeBodyMetric(ann_file=str(ann))
        else:
            metric = CocoMetric(ann_file=str(GOLDEN / "e2e_coco.json"), extended=[False])
        metric.dataset_meta = parse_pose_metainfo({"dataset_name": dataset})
        metric.process(None, samples)
        return metric.compute_metrics(metric.results)["AP"]


def jax_variables(sd):
    """``convert_torch_state_dict`` of a state dict; a DoubleProbMapHead's
    two heatmap towers (``head.first_head``, ``head.second_head``), which it
    does not name, each converted as a ProbMapHead's deconv stack and final
    layer (the port's ``state_dict_from_jax`` gives the state dict back
    exactly)."""
    towers = ("head.first_head.", "head.second_head.")
    variables = convert_torch_state_dict({k: v.numpy() for k, v in sd.items()
                                          if not k.startswith(towers) and not k.startswith("head.fc.")})
    if "head.fc.weight" in sd:  # a RegressionHead, which the converter does not name
        variables["params"]["head"] = {"fc": {"kernel": sd["head.fc.weight"].numpy().T,
                                              "bias": sd["head.fc.bias"].numpy()}}
    for tower in towers:
        part = {k: v.numpy() for k, v in sd.items() if k.startswith("backbone.")}
        part.update({"head." + k[len(tower):]: v.numpy() for k, v in sd.items() if k.startswith(tower)})
        if len(part) == sum(k.startswith("backbone.") for k in sd):
            continue
        converted, name = convert_torch_state_dict(part), tower.split(".")[1]
        variables["params"]["head"][name] = {k: converted["params"]["head"][k]
                                             for k in ("deconv_layers", "final_layer")}
        variables["batch_stats"]["head"][name] = {"deconv_layers": converted["batch_stats"]["head"]["deconv_layers"]}
    return variables


def carried_variables(sd, model, input_shape):
    """The JAX variables of ``model`` that the port's ``state_dict_from_jax``
    carries onto the state dict ``sd`` exactly: its init's shapes (traced by
    ``jax.eval_shape``), each element numbered, carried, and filled from
    ``sd`` at the place its number lands (the carry only moves elements)."""
    import jax
    import jax.numpy as jnp

    # the input abstract and the constants computed while tracing: the JAX LiteHRNet splits at a cumsum of its
    # widths, which jit (and eval_shape) cannot trace otherwise
    with jax.ensure_compile_time_eval():
        shapes = jax.eval_shape(lambda key, x: model.module.init(key, x, train=False), jax.random.PRNGKey(0),
                                jax.ShapeDtypeStruct(input_shape, jnp.float32))
    leaves, treedef = jax.tree_util.tree_flatten(shapes)
    offsets = np.cumsum([0] + [int(np.prod(leaf.shape)) for leaf in leaves])
    numbered = treedef.unflatten([np.arange(a, b, dtype=np.float64).reshape(leaf.shape)
                                  for a, b, leaf in zip(offsets[:-1], offsets[1:], leaves)])
    flat = np.full(offsets[-1], np.nan, np.float32)
    for key, where in state_dict_from_jax(numbered).items():
        # the BatchNorm counters and RealNVP's prior and masks are constants of the torch modules, no variables
        if not key.endswith(("num_batches_tracked", "flow_model.loc", "flow_model.cov", "flow_model.mask")):
            flat[where.numpy().astype(np.int64).ravel()] = sd[key].numpy().ravel()
    if np.isnan(flat).any():
        raise AssertionError("the state dict does not fill the JAX variables")
    variables = treedef.unflatten([flat[a:b].reshape(leaf.shape)
                                   for a, b, leaf in zip(offsets[:-1], offsets[1:], leaves)])
    for key, value in state_dict_from_jax(variables).items():
        if not torch.equal(value, sd[key]):
            raise AssertionError(f"state_dict_from_jax does not carry {key} back")
    return variables


def make(fixture):
    cfg = fixture["cfg"]() if callable(fixture["cfg"]) else fixture["cfg"]
    dataset = fixture.get("dataset", "coco")
    if callable(fixture["weights"]):
        sd = fixture["weights"]()
    else:
        sd = seeded_state_dict(cfg["model"], seed=0)
        torch.save(sd, fixture["weights"])
    # the JAX RegressionHead pools by itself: its model is the config's without the neck
    model_cfg = {k: v for k, v in cfg["model"].items() if k != "neck" or v["type"] != "GlobalAveragePooling"}
    model = JaxPoseModel(model_cfg, metainfo=parse_pose_metainfo({"dataset_name": dataset}))
    input_size = tuple(cfg["test_dataloader"]["dataset"]["pipeline"][2]["input_size"])
    if fixture in CNN_ZOO_FIXTURES + MULTISTAGE_FIXTURES + TOPDOWN_REST_FIXTURES + REGRESSION_FIXTURES:
        # unknown to the converter
        variables = carried_variables(sd, model, (1, input_size[1], input_size[0], 3))
    else:
        variables = jax_variables(sd)

    anns, crops, centers, scales = golden_instances(cfg, fixture.get("boxes", "person"), input_size)
    predict = model.make_predict(jit=False)
    preds = [{k: np.asarray(v) for k, v in predict(variables, crops[i:i + 16]).items()}
             for i in range(0, len(crops), 16)]
    preds = {k: np.concatenate([p[k] for p in preds]) for k in preds[0]}
    samples = []
    for a, center, scale in zip(anns, centers, scales):
        sample = PoseDataSample(metainfo=dict(id=a["id"], img_id=a["image_id"], input_center=center,
                                              input_scale=scale, input_size=input_size))
        sample.gt_instances = InstanceData(bboxes=golden_boxes([a], fixture.get("boxes", "person")),
                                           bbox_scores=np.ones(1, np.float32))
        samples.append(sample)
    attach_predictions(preds, samples, input_size)
    ap = jax_ap(samples, dataset)
    K = preds["keypoints"].shape[1]

    def field(name):
        return np.stack([np.asarray(s.pred_instances[name]).reshape(K) for s in samples]).astype(np.float32)

    extra = {}
    if fixture["name"] != "rtmpose" and "keypoint_x_labels" in preds:  # ties (``SIMCC_TIE_REL``), by ``ids``

        def gap(v):
            top = np.sort(v, axis=-1)
            return (top[..., -1] - top[..., -2]) / np.abs(top[..., -1])

        extra["ties"] = np.minimum(gap(preds["keypoint_x_labels"]), gap(preds["keypoint_y_labels"])) < SIMCC_TIE_REL
    np.savez_compressed(
        fixture["outputs"], ids=np.array([a["id"] for a in anns]), **extra,
        keypoints=np.stack([np.asarray(s.pred_instances.keypoints).reshape(K, 2) for s in samples]).astype(np.float32),
        scores=field("keypoint_scores"), ap=np.float64(ap), crops=crops[:2].astype(np.uint8),
        **{k: field(k) for k in fixture.get("aux", ())},
        **{fixture_output_name(k): preds[k][:2].astype(np.float32) for k in fixture["keys"]},
    )
    weights = Path(fixture["weights"]).stat().st_size if not callable(fixture["weights"]) else "made at run time"
    print(f"{fixture['name']}: {len(samples)} instances, {K} keypoints, {'NME' if dataset in ('lapa', 'wflw') else 'AP'} {ap:.4f}, weights {weights}, outputs "
          f"{Path(fixture['outputs']).stat().st_size} B")


if __name__ == "__main__":
    torch.set_num_threads(4)
    for fixture in (CLASSIC_FIXTURE, RTMPOSE_FIXTURE, WHOLEBODY_FIXTURE, DPM_FIXTURE, *FACE_FIXTURES,
                    *CNN_ZOO_FIXTURES, *MULTISTAGE_FIXTURES, *TOPDOWN_REST_FIXTURES, *REGRESSION_FIXTURES):
        if len(sys.argv) < 2 or fixture["name"] in sys.argv[1:] or fixture["name"].split("_")[0] in sys.argv[1:]:
            make(fixture)
