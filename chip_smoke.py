#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (probpose_code_torch) on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one CUDA
card and the CUDA toolkit (nvcc); it builds the port's kernels from
``probpose_code_torch/csrc`` first. Phases, each of which fails the run:

1. the card's name and power limit, and the kernels' build time;
2. K1 (whole ViT layer) against its plain twin at the flagship layer shape;
3. K2 (expected-OKS decode) and its conv-only entry against their plain twin,
   the decode also at the identity scale on DoubleProbPose's (128, 17, 64, 48);
4. K3 (the differentiable ViT layer): forward and all 13 gradients against
   its plain twin, at a small f32 shape and at the flagship layer shape in
   bf16 with stochastic-depth masks that drop some images;
5. the golden tiny ProbPose fixture end to end through ``init_model`` and
   ``inference_topdown``, against the reference keypoints;
6. ``checkpoint_file``: the golden weights written as mmpose's runner writes
   a checkpoint (``state_dict`` plus ``meta.dataset_meta`` with numpy
   arrays), loaded through ``init_model``: the same weights and bitwise the
   same golden predictions as the bare state dict;
7. the flagship ProbPose-S predict at full width (random weights, seed 0),
   64 boxes with flip-TTA: the kernels' launch counts in one call, then
   crops/s;
8. the flagship training recipe at full width (random weights, seed 0, a
   synthetic batch of 64 crops, targets encoded on the card, drop_path 0.1)
   through ``make_train_step``: the kernels' launch counts in one step, the
   losses, lr and gradient norm of each step, train crops/s and a profile;
9. ``k4_parity``: K4 (the attention core) against its plain twin at the
   ViTPose-B training shape in f32 and the ProbPose-S shape in bf16, and one
   gradient through its autograd Function against autograd through
   ``xla_attention``;
10. ``vitpose_predict``: ViTPose-B-simple (ViT-B/16, f32, erf GELU, x4 neck,
   HeatmapHead, UDP decode) at full width through ``init_model`` /
   ``inference_topdown``, 64 boxes with flip-TTA: K1's launches in one call
   (12), the outputs finite, every positive heatmap peak inside its crop's
   padded box, two crops' heatmaps and scores against the same model on the
   CPU, then crops/s and a profile;
11. ``vitpose_train``: the ViTPose-B-simple recipe (drop_path 0.3, UDP
   targets encoded on the card, AdamW with layer decay 0.75) through
   ``make_train_step`` on 64 crops: K4's launches in one step (12, and K3's
   0), the losses, lr and gradient norm of each step, train crops/s, peak
   memory and a profile;
12. ``jpeg_decode``: the card's JPEG decode (``ops/kernels/jpeg.py``: host
   Huffman decode, its own IDCT and pixel kernels) against the plain decoder
   on every fixture of ``tests/golden_torch`` bit for bit, nvJPEG's batched
   decode (the yardstick, ``csrc/nvjpeg_batched.cu``) within
   ``NVJPEG_BARS``, |difference| by sampling mode, zeroed padding, the
   truncated stream refused; then the decode rate of a batch of 64 golden
   JPEGs, the port's beside nvJPEG's, and the host half's cost a file, a MB
   and a megapixel on 1 and 8 threads;
13. ``val_full``: the evaluation path (``Runner.val``: a CocoDataset of PNG
   files, the flagship's val pipeline, the loader, the canvas warp on the
   card, predict, CocoMetric with Ex-OKS) at the golden fixture's full
   ProbPose-S geometry in f32 (width 384, K1's 3xTF32 instance) with the
   fixture's weights (``tools/_e2e_torch_model.build_e2e_model(full=True)``,
   built on the CPU), over its 24 images written as PNG: K1 x12 and K2 x1
   launched, keypoints p99 < 1.5 px and max < 8 px, AP and Ex-AP within
   0.02 of the fixture's (the JAX package's bars);
14. ``val_full_jpeg``: the same over the golden JPEGs, decoded on the card,
   against the JAX package's ``Runner.val`` on the same files
   (``tests/golden_torch/val_reference.npz``) at the same bars; one decode;
15. ``val_shipped``: ``val_full`` under the flagship's shipped bf16 /
   tanh-GELU settings: p50 < 0.2 px, p90 < 0.75 px, AP and Ex-AP within 0.05;
16. ``val_flagship``: the flagship config file at full width (random
   weights, seed 0) through ``Runner.val`` with its own CombinedDataset
   (CropCOCO + COCO), MultiDatasetEvaluator, batch size 64 and four worker
   processes, over the golden JPEGs (COCO's format) with their annotations
   copied to 512 instances: val crops/s from the start of the loader to the
   metrics, the time split (first batch, later loader waits, device with
   the decode on the card's clock, evaluate), the device's busy share over
   one batch, K1 and K2 launches and one decode a batch, and every metric
   key present and finite;
17. ``train_flagship``: the flagship's training entry point at full width,
   the main of ``python -m probpose_code_torch.tools.train`` on the flagship
   config file (random weights, seed 0) with its own train pipeline, loader
   (batch 64, four workers), optimizer, schedules and hooks, over the golden
   JPEGs with the train annotations copied to 256 instances and
   ``val_flagship``'s val sets: two epochs (a checkpoint each, val after the
   second), then a third resumed by ``--resume``; K3 x12 forward and
   backward a step and K1 x12 and K2 x1 a val batch, one decode a step and
   a val batch, the first step's loss dict against ``make_train_step``'s,
   ``epoch_2.pth`` against the live weights bitwise, the resumed state;
   train crops/s an epoch with the runner's time split (the decode apart),
   and one step profiled inside the runner;
18. ``serve``: ``tools.serve``'s server for the flagship at full width on an
   ephemeral 127.0.0.1 port, in a thread: 3 POSTed golden JPEGs answered
   with ``inference_topdown``'s JSON on the same files (to
   ``SERVE_KPT_ATOL``), K1 x12, K2 x1 and
   one decode a request, then the latency of a request;
19. ``dpm_predict``: the DoubleProbPose-S config file (``td-dpm_...``) at
   full width, random weights seed 0, 64 boxes with flip-TTA through
   ``inference_topdown``: K1 x12 and K2 x1 (both windows' decode in one
   launch) a call, two crops against the same model on the CPU, then
   crops/s beside the flagship's from this run, and a profile;
20. ``dpm_train``: its training entry point (``tools.train``'s main) over
   the golden JPEGs, one epoch of 4 steps and val after it: K3 x12 forward
   and backward a step, K1 x12 and K2 x1 a val batch, the card's bbox mask of
   the first batch bit for bit against its NumPy version, the first loss
   dict against ``make_train_step``'s, train crops/s;
21. ``hrnet_golden``: the HRNet + UDP golden fixture on the card at
   ``UDP_BARS`` (mmpose's weights loaded strict);
22. ``hrnet_predict`` and 23. ``hrnet_train``: HRNet-w32 UDP (its config
   file, random weights, f32) at full width, 64 boxes with flip-TTA and a
   train step of 64 crops with plain Adam: no kernel of the port launched,
   outputs finite (predict also against the CPU on two crops), crops/s and
   peak memory;
24. ``classic_golden`` and 25. ``rtmpose_golden``: the model fixtures of
   ``tests/golden_torch/`` (a narrow ResNet-50 with the DARK codec, a
   narrow CSPNeXt + RTMCCHead with SimCC; the JAX package's outputs made by
   ``make_model_fixtures.py``) through ``init_model`` and
   ``inference_topdown`` at ``UDP_BARS``, their maps or SimCC vectors on two
   crops at ``FIXTURE_OUTPUT_REL``;
26. ``res50_predict`` (``td-hm_res50_dark``), 27. ``hrnet_msra_predict``
   (``td-hm_hrnet-w32``, MSRA) and 29. ``rtmpose_predict`` (RTMPose-m) at
   full width, as ``hrnet_predict``: no kernel launched, two crops' maps or
   both SimCC vectors against the CPU (``HRNET_REL``), crops/s, peak memory
   and a profile (HRNet MSRA's short: its backbone is timed above);
28. ``res50_train``: the ResNet-50 recipe's bare step on 64 crops (MSRA
   targets rendered on the card, its lr schedule), then ``tools.train`` on
   its config file over the golden JPEGs (256 instances, one epoch and
   val): no kernel launched, the first loss dict equal to
   ``make_train_step``'s, train crops/s;
30. ``rtmpose_train``: RTMPose-m's bare step on 64 crops (SimCC labels
   rendered on the card), then ``Runner.val`` as ``tools.test`` builds it
   over the golden JPEGs: the SimCC predictions reach ``CocoMetric``;
31. ``rtmpose_augment``: the RTMPose recipes' photometric augmentations on
   the card (the median and ``PhotometricDistortion`` kernels of
   ``csrc/photometric.cu``, the HSV jitter through its tables, the blur and
   the dropout in PyTorch) bit for bit against cv2's fixture
   (``tests/golden_torch/augment_fixture.npz``): a batch of 256 crops,
   every op and kernel size, the distortion in both recipes' orders, every
   colour and HSV triple (hue 180 too), every window sum; each kernel
   against its plain version at the main paths' shapes; the time of the
   kernels, of the HSV jitter and of each recipe's whole augment;
32. ``rtmpose_train_runner``: RTMPose-m's own recipe through
   ``tools.train`` at its batch of 256 over 512 golden JPEG instances, two
   epochs across the stage-2 switch (``PipelineSwitchHook``, the loader's
   workers restarted), the EMA hook, val, then a resumed third epoch: no
   kernel of the TPU list, the augment on every step, the first
   loss dict against ``make_train_step``'s, crops/s an epoch with the
   decode and the augment apart, peak memory and one step profiled;
33. ``rtmpose_aic_train``: the AIC+COCO recipe's epoch at its batch of 128
   (``CombinedDataset``, AIC through ``KeypointConverter``): every batch's
   keypoint weights (B, 17) as the workers made them equal the CPU's;
34. ``body8_train_runner``: RTMPose-m's body8 recipe as
   ``rtmpose_train_runner`` (eight sub-datasets in their own layouts, 64
   instances each, YOLOX HSV, the distortion and Albumentation in stage 1):
   the same checks, the distortion kernel once a stage-1 step, and its
   share of the profiled step's device time;
35. ``halpe26_runner``: the halpe26 recipe (its datasets and converters
   repaired, ``halpe26_repair_options``: COCO through
   ``CocoWholeBodyDataset`` and the shipped 23-pair mapping, which takes
   its feet) at its batch of 512, one epoch of 2 steps
   and val over the eight-way mixed set by PCK and AUC, the best checkpoint
   by AUC, then ``tools.test`` on it: finite ``pck/PCK`` and ``auc/AUC``,
   the first loss dict, peak memory;
36. ``crowdpose_val``: ``tools.test`` on the CrowdPose ResNet-50 recipe
   over the golden JPEGs in CrowdPose's layout: finite ``crowdpose/``
   stats from COCOeval's crowd iouType;
37. ``wholebody_golden``: the whole-body model fixture
   (``tests/golden_torch/wholebody_*``, RTMPose's narrow model with 133
   outputs) as ``rtmpose_golden``, its AP ``CocoWholeBodyMetric``'s;
38. ``wholebody_predict``: RTMPose-m, HRNet-w32 and CSPNeXt-m UDP
   whole-body (133 keypoints) at full width as ``hrnet_predict``: crops/s,
   the busy share and peak memory of each;
39. ``wholebody_train``: the HRNet-w32 and CSPNeXt-m UDP whole-body bare
   steps on 64 crops, then ``tools.test`` on HRNet-w32 whole-body over the
   golden JPEGs in COCO-WholeBody's layout: the six AP families finite;
40. ``wholebody_train_runner``: RTMPose-m whole-body through ``tools.train``
   at B = 64 as ``rtmpose_train_runner`` (512 instances in COCO-WholeBody's
   layout, the switch, the EMA, a resumed third epoch), val by
   ``CocoWholeBodyMetric``, the best checkpoint by ``coco/AP``, then
   ``tools.test`` on ``best.pth``; the ops of 133 keypoints (the SimCC
   label render, the GAU's attention) each as a share of the step's device
   time;
41. ``ubody_train``: the COCO + UBody recipe's epoch (a
   ``CocoWholeBodyDataset`` and 15 ``UBody2dDataset`` scenes with
   ``sample_interval=10``) at B = 64 with val;
42. ``dpm_golden``: the DoubleProbPose-S fixture (its ViT in f32, weights
   from seeds) at ``UDP_BARS``, K1 and K2 launched;
43. ``timings``: each kernel's time beside its plain twin's, a PyTorch
   library call's where one computes the same function, and its bound from
   this run's shapes; K1 also at the ViT-B predict shape (f32), K4 also at
   the ProbPose-S shape in bf16. For K1 (bf16 and f32) and K3 (forward,
   backward) also the time over the bound and the rate of the layer's
   products: their operations over the device time of the GEMM kernels in a
   profile of a few calls. For K2 and K2b also the kernel's device time from
   a profile beside the call time, and the wrapper's host cost a call; K2b's
   yardstick is cuDNN's depthwise convolution of the padded maps.

Run in this order among them: after ``vitpose_train``, ``vit_large_parity``
(K1 in f32 at a layer of ViTPose-L's and -H's predict calls, C = 1024 and
C = 1280 with heads of 80, against its twin; K4 at their training shapes,
forward and gradient), ``vitpose_small_predict``, ``vitpose_large_predict``
and ``vitpose_huge_predict`` (as ``vitpose_predict``: K1 x12 a call, and
ViT-L's and -H's first ``VIT_LARGE_DEPTH`` layers of 24 and 32, K1 a layer)
and ``vitpose_large_train`` and ``vitpose_huge_train`` (as
``vitpose_train`` at B = 64, their first ``VIT_LARGE_DEPTH`` layers: K4 a
layer a step, peak memory, the classic head's share of the step); after ``dpm_golden``, ``animal_fashion_predict``
(AP-10K HRNet-w32 and RTMPose-m, Animal Kingdom, DeepFashion upper and
DeepFashion2 at full width through ``predict_phase``) and
``animal_fashion_runner`` (each through ``tools.train``, one epoch of 2
steps with val, then ``tools.test``); then ``cnn_zoo_golden`` (the SCNet-50
and narrow ViPNAS fixtures, ``CNN_ZOO_FIXTURES``, at 257 x 193),
``cnn_zoo_kernels`` (SCNet's gate kernels, ``csrc/sc_gate.cu``, and the
split attention's, ``csrc/split_attention.cu``, against their twins at
SCNet-50's and ResNeSt-50's step shapes, timed), ``cnn_zoo_predict`` (the nine
``CNN_ZOO`` recipes through ``predict_phase``: crops/s, busy share, peak
memory; ShuffleNetV2's channel shuffle share) and ``cnn_zoo_train``
(SCNet-50, ResNeSt-50 and ViPNAS-Res50 steps at B = 64 and the 2% rule's op
shares); ``cnn_zoo_kernels`` also holds the squeeze-and-excite kernels
(``csrc/se_layer.cu``) at ViPNAS-Res50's SE layers (``se_layer_kernels``),
and times each of these kernels with the L2 cache flushed before each
launch and without (``queued_ms``: CUDA events around calls queued
behind a wait, not the profiler, which drops records late in the run).
After ``timings``:
``multistage_golden``
(the RTMW, hourglass, CPM and MSPN fixtures, ``MULTISTAGE_FIXTURES``),
``multistage_predict`` (the twelve ``MULTISTAGE`` recipes through
``predict_phase``: the SimCC heads, RTMW-m with the GAU kernels,
SimCC-MobileNetV2 with the depthwise ones, the hourglass, CPM, MSPN and
RSN; the Megvii decode on the card against the CPU's),
``multistage_train`` (Hourglass-52, CPM, SimCC-ResNet-50 and RTMW-m steps
and the 2% rule's op shares) and ``rtmw_runner`` (RTMW-m through
``tools.train`` over a cocktail14 mix across the pipeline switch, val,
``tools.test``). ``timings`` also times K1 in f32 at ViTPose-S, -L and
-H's shapes and K4 at ViTPose-L and -H's. Last, after ``topdown_rest_runner``:
``regression_golden`` (the RLE, DSNT and Vis fixtures,
``REGRESSION_FIXTURES``), ``regression_predict`` (the eight ``REGRESSION``
recipes through ``predict_phase``: the plain regression ResNet-50 on COCO and
MPII without a neck, RLE-ResNet-50, -152 at 384 x 288 and -MobileNetV2,
IPR- and DSNT-debias-ResNet-50, Vis-ResNet-50 with its visibility),
``regression_train`` (the RLE-ResNet-50, RLE-MobileNetV2, Vis-ResNet-50 and
regression ResNet-50 steps at B = 64, the RLE ones profiled again with the
flow's twin, and the 2% rule's op shares), ``regression_runner``
(RLE-ResNet-50 through ``tools.train`` with val, ``tools.test`` of the
DSNT-debias recipe and of the PoseTrack18 HRNet-w32 recipe over the golden
images as three videos, printing ``PoseTrack18Metric``'s table, and the DSNT
recipe's ``tools.train`` refused by name) and ``regression_kernels`` (the
RealNVP flow kernels, ``csrc/realnvp.cu``, against their twin at N = 1,088
and 1,024, forward and backward, timed; their two records join the kernels
line with ``launches`` from the RLE-ResNet-50 step and ``launches_by_path``
on every main path, the runner's too).

The lines before the last hold the kernels' record as JSON (each kernel's
``launches`` from the flagship's paths, and ``launches_by_path`` on every
main path: K1's one count goes to the record of the instance, bf16 ViT-S
or f32 ViT-S, -B, -L or -H, that the path's model runs, and K4's to that of
the f32 width, ViT-B, -L or -H, that the path trains) and the JPEG decode's (no TPU
kernel: its own line, no ``replaces``) and the photometric kernels' (no
TPU kernel either: the ``augment`` line, each one's ``ports`` the JAX
transform it ports, the median's ``launches`` from
``rtmpose_train_runner``'s main path, the distortion's from
``body8_train_runner``'s, and each one's ``launches_by_path`` on every path
that augments on the card) and the CNN backbones' kernels' (no TPU
kernel: the ``cnn_zoo`` line, ``launches`` from ``cnn_zoo_train``'s SCNet-50
step for SCNet's gate, its ResNeSt-50 step for the split attention and its
ViPNAS-Res50 step for the squeeze and excite) and the normalisation
kernels' (no TPU kernel: the ``norms`` line, BatchNorm's ``launches`` from
LiteHRNet-18's train step, LayerNorm's from Swin-T's, and each one's
``launches_by_path`` on every main path: BatchNorm's where a path trains a
model with a BatchNorm), the
last line ``{"ok": true,
"device": ...}``. Any failure exits non-zero without them. It imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import importlib.util
import json
import math
import py_compile
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "golden"
GOLDEN_JPEG = ROOT / "tests" / "golden_torch"
FLAGSHIP = ROOT / "configs/body_2d_keypoint/topdown_probmap/coco/td-pm_ProbPose-small_8xb64-210e_coco-256x192.py"
VITPOSE = ROOT / "configs/body_2d_keypoint/topdown_heatmap/coco/td-hm_ViTPose-base-simple_8xb64-210e_coco-256x192.py"
VITPOSE_SMALL = ROOT / "configs/body_2d_keypoint/topdown_heatmap/coco/td-hm_ViTPose-small-simple_8xb64-210e_coco-256x192.py"
VITPOSE_LARGE = ROOT / "configs/body_2d_keypoint/topdown_heatmap/coco/td-hm_ViTPose-large_8xb64-210e_coco-256x192.py"
VITPOSE_HUGE = ROOT / "configs/body_2d_keypoint/topdown_heatmap/coco/td-hm_ViTPose-huge_8xb64-210e_coco-256x192.py"
# (C, heads, feed-forward width) of ViT-L and ViT-H: heads of 64 and of 80
VIT_LARGE_SHAPES = ((1024, 16, 4096), (1280, 16, 5120))
DPM = ROOT / "configs/body_2d_keypoint/topdown_probmap/coco/td-dpm_DoubleProbPose-small_8xb64-210e_coco-256x192.py"
HRNET = ROOT / "configs/body_2d_keypoint/topdown_heatmap/coco/td-hm_hrnet-w32_udp-8xb64-210e_coco-256x192.py"
# the classic heatmap recipes (MSRA codec, DARK with ``unbiased``) and RTMPose-m
CLASSIC_RECIPES = {
    name: ROOT / f"configs/body_2d_keypoint/topdown_heatmap/coco/td-hm_{stem}-210e_coco-256x192.py"
    for name, stem in (("res50", "res50_8xb64"), ("res50_dark", "res50_dark-8xb64"),
                       ("hrnet_w32", "hrnet-w32_8xb64"), ("hrnet_w32_dark", "hrnet-w32_dark-8xb64"))
}
RTMPOSE = ROOT / "configs/body_2d_keypoint/rtmpose/coco/rtmpose-m_8xb256-420e_coco-256x192.py"
# RTMPose-m's body8 recipes (the COCO-17 one and the 26-keypoint halpe26 one) and a CrowdPose recipe
BODY8 = ROOT / "configs/body_2d_keypoint/rtmpose/body8/rtmpose-m_8xb256-420e_body8-256x192.py"
HALPE26 = ROOT / "configs/body_2d_keypoint/rtmpose/body8/rtmpose-m_8xb512-700e_body8-halpe26-256x192.py"
CROWDPOSE = ROOT / "configs/body_2d_keypoint/topdown_heatmap/crowdpose/td-hm_res50_8xb64-210e_crowdpose-256x192.py"
# the COCO-WholeBody recipes (133 keypoints) and the COCO + UBody mix
WHOLEBODY_RECIPES = dict(
    rtmpose=ROOT / "configs/wholebody_2d_keypoint/rtmpose/coco-wholebody/"
                   "rtmpose-m_8xb64-270e_coco-wholebody-256x192.py",
    hrnet=ROOT / "configs/wholebody_2d_keypoint/topdown_heatmap/coco-wholebody/"
                 "td-hm_hrnet-w32_8xb64-210e_coco-wholebody-256x192.py",
    cspnext_udp=ROOT / "configs/wholebody_2d_keypoint/topdown_heatmap/coco-wholebody/"
                       "cspnext-m_udp_8xb64-210e_coco-wholebody-256x192.py",
)
UBODY = ROOT / "configs/wholebody_2d_keypoint/rtmpose/ubody/rtmpose-m_8xb64-270e_coco-ubody-wholebody-256x192.py"
# the face and hand recipes: RTMPose-m face6 and hand5, HRNetV2-w18 on WFLW (MSE, AWing, DARK), the ResNet-50
# regression recipe with WingLoss and MobileNetV2 on COCO-WholeBody-Hand
FACE_HAND_RECIPES = dict(
    face6=ROOT / "configs/face_2d_keypoint/rtmpose/face6/rtmpose-m_8xb256-120e_face6-256x256.py",
    hand5=ROOT / "configs/hand_2d_keypoint/rtmpose/hand5/rtmpose-m_8xb256-210e_hand5-256x256.py",
    hrnetv2=ROOT / "configs/face_2d_keypoint/topdown_heatmap/wflw/td-hm_hrnetv2-w18_8xb64-60e_wflw-256x256.py",
    hrnetv2_awing=ROOT / "configs/face_2d_keypoint/topdown_heatmap/wflw/td-hm_hrnetv2-w18_awing-8xb64-60e_wflw-256x256.py",
    hrnetv2_dark=ROOT / "configs/face_2d_keypoint/topdown_heatmap/wflw/td-hm_hrnetv2-w18_dark-8xb64-60e_wflw-256x256.py",
    res50_wing=ROOT / "configs/face_2d_keypoint/topdown_regression/wflw/td-reg_res50_wingloss_8xb64-210e_wflw-256x256.py",
    mobilenetv2_hand=ROOT / ("configs/hand_2d_keypoint/topdown_heatmap/coco_wholebody_hand/"
                             "td-hm_mobilenetv2_8xb32-210e_coco-wholebody-hand-256x256.py"),
)
# the animal and fashion recipes on the card: AP-10K (HRNet-w32 by CocoMetric with AP-10K's sigmas, RTMPose-m),
# Animal Kingdom (ResNet-50, PCK at 0.05), DeepFashion's upper subset (6 keypoints) and DeepFashion2 (294)
ANIMAL_FASHION_RECIPES = dict(
    ap10k_hrnet=ROOT / "configs/animal_2d_keypoint/topdown_heatmap/ap10k/td-hm_hrnet-w32_8xb64-210e_ap10k-256x256.py",
    ap10k_rtmpose=ROOT / "configs/animal_2d_keypoint/rtmpose/ap10k/rtmpose-m_8xb64-210e_ap10k-256x256.py",
    ak_res50=ROOT / "configs/animal_2d_keypoint/topdown_heatmap/ak/td-hm_res50_8xb64-300e_ak-256x256.py",
    deepfashion_upper_res50=ROOT / ("configs/fashion_2d_keypoint/topdown_heatmap/deepfashion/"
                                    "td-hm_res50_8xb64-210e_deepfashion_upper-256x192.py"),
    deepfashion2_res50=ROOT / ("configs/fashion_2d_keypoint/topdown_heatmap/deepfashion2/"
                               "td-hm_res50_4xb64-210e_deepfashion2-256x192.py"),
)
# and the ViPNAS DeepFashion recipes, which ``animal_fashion_predict`` runs beside them
VIPNAS_FASHION = {f"deepfashion_{subset}_vipnas": ROOT / (
    f"configs/fashion_2d_keypoint/topdown_heatmap/deepfashion/td-hm_vipnas-res50_8xb64-210e_deepfashion_{subset}"
    "-192x256.py") for subset in ("full", "upper", "lower")}
# the ResNet-like and small CNN recipes that ``cnn_zoo_predict`` runs, all COCO's 256 x 192 but the last
CNN_ZOO = {name: ROOT / f"configs/body_2d_keypoint/topdown_heatmap/coco/td-hm_{name}_8xb64-210e_coco-256x192.py"
           for name in ("resnetv1d50", "resnext50", "seresnet50", "scnet50", "resnest50", "shufflenetv2", "vgg16-bn",
                        "vipnas-res50")}
CNN_ZOO["vipnas-res50_wholebody"] = ROOT / ("configs/wholebody_2d_keypoint/topdown_heatmap/coco-wholebody/"
                                            "td-hm_vipnas-res50_8xb64-210e_coco-wholebody-256x192.py")
# and the recipes whose bare step ``cnn_zoo_train`` runs
CNN_ZOO_TRAIN = ("scnet50", "resnest50", "vipnas-res50")
# the SimCC and multi-stage recipes that ``multistage_predict`` runs, at full width and depth
_SIMCC = ROOT / "configs/body_2d_keypoint/simcc/coco"
_TD_COCO = ROOT / "configs/body_2d_keypoint/topdown_heatmap/coco"
RTMW = ROOT / "configs/wholebody_2d_keypoint/rtmpose/cocktail14/rtmw-m_8xb1024-270e_cocktail14-256x192.py"
MULTISTAGE = dict(
    simcc_res50=_SIMCC / "simcc_res50_8xb64-210e_coco-256x192.py",
    simcc_res50_384=_SIMCC / "simcc_res50_8xb32-140e_coco-384x288.py",
    simcc_mobilenetv2=_SIMCC / "simcc_mobilenetv2_wo-deconv-8xb64-210e_coco-256x192.py",
    simcc_vipnas_mbv3=_SIMCC / "simcc_vipnas-mbv3_8xb64-210e_coco-256x192.py",
    rtmw_m=RTMW,
    hourglass52=_TD_COCO / "td-hm_hourglass52_8xb32-210e_coco-256x256.py",
    hourglass52_384=_TD_COCO / "td-hm_hourglass52_8xb32-210e_coco-384x384.py",
    cpm=_TD_COCO / "td-hm_cpm_8xb64-210e_coco-256x192.py",
    mspn50=_TD_COCO / "td-hm_mspn50_8xb32-210e_coco-256x192.py",
    mspn50_4x=_TD_COCO / "td-hm_4xmspn50_8xb32-210e_coco-256x192.py",
    rsn18=_TD_COCO / "td-hm_rsn18_8xb32-210e_coco-256x192.py",
    rsn50_3x=_TD_COCO / "td-hm_3xrsn50_8xb32-210e_coco-256x192.py",
)
# and the steps that ``multistage_train`` runs, with their batch (the configs': 32 for the hourglass)
MULTISTAGE_TRAIN = dict(hourglass52=32, cpm=64, simcc_res50=64, rtmw_m=64)
# the rest of top-down's backbones (LiteHRNet, Swin, HRFormer, PVT / PVTv2): the recipes that
# ``topdown_rest_predict`` runs at full width and depth, and the steps that ``topdown_rest_train`` runs with
# their batch
TOPDOWN_REST = dict(
    litehrnet18=_TD_COCO / "td-hm_litehrnet-18_8xb64-210e_coco-256x192.py",
    litehrnet30=_TD_COCO / "td-hm_litehrnet-30_8xb64-210e_coco-256x192.py",
    litehrnet30_384=_TD_COCO / "td-hm_litehrnet-30_8xb32-210e_coco-384x288.py",
    swin_t=_TD_COCO / "td-hm_swin-t-p4-w7_8xb32-210e_coco-256x192.py",
    swin_b=_TD_COCO / "td-hm_swin-b-p4-w7_8xb32-210e_coco-256x192.py",
    swin_l=_TD_COCO / "td-hm_swin-l-p4-w7_8xb32-210e_coco-256x192.py",
    swin_l_384=_TD_COCO / "td-hm_swin-l-p4-w7_8xb32-210e_coco-384x288.py",
    hrformer_small=_TD_COCO / "td-hm_hrformer-small_8xb32-210e_coco-256x192.py",
    hrformer_base=_TD_COCO / "td-hm_hrformer-base_8xb32-210e_coco-256x192.py",
    hrformer_base_384=_TD_COCO / "td-hm_hrformer-base_8xb32-210e_coco-384x288.py",
    pvt_s=_TD_COCO / "td-hm_pvt-s_8xb64-210e_coco-256x192.py",
    pvtv2_b2=_TD_COCO / "td-hm_pvtv2-b2_8xb64-210e_coco-256x192.py",
)
TOPDOWN_REST_TRAIN = dict(litehrnet18=64, swin_t=32, hrformer_small=32, pvtv2_b2=64)
# the regression heads and PoseTrack18 (``regression_*`` phases): the recipes that ``regression_predict`` runs at full
# width and depth, the steps that ``regression_train`` runs at B = 64 (the plain regression ResNet-50, its head
# pooling the backbone's map: no neck), and the PoseTrack18 recipe ``regression_runner`` tests
_REG = ROOT / "configs/body_2d_keypoint/topdown_regression"
_IPR = ROOT / "configs/body_2d_keypoint/integral_regression/coco"
REGRESSION = dict(
    reg_res50_coco=_REG / "coco/td-reg_res50_8xb64-210e_coco-256x192.py",
    reg_res50_mpii=_REG / "mpii/td-reg_res50_8xb64-210e_mpii-256x256.py",
    rle_res50=_REG / "coco/td-reg_res50_rle-8xb64-210e_coco-256x192.py",
    rle_res152_384=_REG / "coco/td-reg_res152_rle-8xb64-210e_coco-384x288.py",
    rle_mobilenetv2=_REG / "coco/td-reg_mobilenetv2_rle_8xb64-210e_coco-192x256.py",
    ipr_res50=_IPR / "ipr_res50_8xb64-210e_coco-192x256.py",
    dsnt_debias_res50=_IPR / "ipr_res50_debias-8xb64-210e_coco-256x256.py",
    vis_res50=_TD_COCO / "td-hm-vis_res50_8xb64-210e_coco-aic-256x192-merge.py",
)
REGRESSION_TRAIN = ("rle_res50", "rle_mobilenetv2", "vis_res50", "reg_res50_coco")
POSETRACK = ROOT / "configs/body_2d_keypoint/topdown_heatmap/posetrack18/td-hm_hrnet-w32_8xb64-20e_posetrack18-256x192.py"
# the flow kernel against its twin (f32 on both sides): the log-density relative to its largest value (summation
# order); the gradients relative to each array's largest element, where a saturated tanh's 1 - s^2 keeps few of f32's
# digits (two f32 implementations on the CPU differ by 1.7e-4 there, tests/test_torch_rle.py) and the densities of
# residuals up to |10| reach 1e4; the nets' weights drawn at N(0, REALNVP_STD^2), where s and t are of order 1
REALNVP_REL = 1e-5
REALNVP_GRAD_REL = 2e-3
REALNVP_STD = 0.3
# the backbones whose depthwise 3x3 convs run ``ops/kernels/depthwise.py`` (PVT's only with its conv FFN, PVTv2's)
DEPTHWISE_BACKBONES = ("MobileNetV2", "LiteHRNet", "HRFormer", "PyramidVisionTransformerV2")
# the backbones whose LayerNorms run ``ops/kernels/layer_norm.py``
TRANSFORMER_BACKBONES = ("SwinTransformer", "HRFormer", "PyramidVisionTransformer", "PyramidVisionTransformerV2")
# the normalisation kernels against their twins (f32, summation order): outputs, running statistics and
# gradients relative to their largest element
NORM_REL = 1e-5
NORM_GRAD_REL = 1e-4
# the card's Megvii decode against the CPU's on the same maps: keypoints in input pixels, scores relative
MEGVII_KPT_ATOL = 1e-3
MEGVII_SCORE_REL = 1e-6

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, f32 outside
# them (the FMA units: K2 and K3's f32 instance), and device memory.
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
# 32-bit integer operations: 64 lanes an SM, half the f32 lanes, and one
# operation an instruction where PEAK_F32 counts an FMA as two (132 SMs x 64
# x 1.98 GHz, the data sheet's boost clock)
PEAK_INT32 = PEAK_F32 / 4
# f32-accurate products on the tensor cores: 3xTF32 issues three TF32
# products (hi.hi, hi.lo, lo.hi) for each one, so a third of the 495 TFLOP/s
# TF32 peak. It bounds the f32 products of K1, K4 and the GAU kernels, which
# run so.
PEAK_F32_3XTF32 = 495e12 / 3

# Bars. K1 bf16: the JAX package's own (tests/test_ops/test_vit_layer_fused.py:76).
# K1 f32: both sides compute in f32 and differ only in summation order and in
# the last ulp of expf / erff / rsqrtf, about 1e-6 of the output's range, so
# 1e-4 leaves a hundredfold margin while catching any wrong term or cast.
K1_BF16_REL = 3e-2
K1_F32_REL = 1e-4
# K2: tests/test_ops/test_pallas_decode.py:30-31,63-64 (heatmap pixels).
K2_LOCS_ATOL = 1e-3
K2_VALS_ATOL = 1e-5
K2_CONV_ATOL = 1e-4
# K3, as the relative max error max|kernel - twin| / max|twin| of each
# output: f32 forward 2e-4 and gradients 5e-4, the JAX package's bars
# (tests/test_ops/test_vit_layer_train.py:81,101); bf16 5e-2, its bar for
# bf16 backbone gradients (:152). The twin's gradients are torch autograd's,
# which rounds to bf16 at other points than the kernel's backward.
K3_F32_FWD = 2e-4
K3_F32_GRAD = 5e-4
K3_BF16_REL = 5e-2
# K4: f32 max abs error on unit-normal inputs, the JAX package's bar
# (tests/test_ops/test_pallas_decode.py:76); bf16 relative max error, K1's bf16
# bar; the gradient through the Function against autograd through
# xla_attention, f32 atol 1e-4.
K4_F32_ATOL = 1e-4
K4_BF16_REL = 3e-2
K4_GRAD_ATOL = 1e-4
# The val path at full width against the golden fixture, the JAX package's
# bars: f32 (tests/test_apis/test_e2e_parity_full.py:125-150) and the
# shipped bf16 / tanh-GELU settings (test_e2e_parity_shipped.py:73-110).
VAL_BARS = dict(
    full=dict(p99=1.5, max=8.0, aux=5e-3, ap=0.02),
    shipped=dict(p50=0.2, p90=0.75, aux=2e-2, ap=0.05),
)
VAL_AUX = ("keypoints_probs", "keypoints_visible", "keypoints_oks", "keypoints_error")
# nvJPEG against the plain decoder (which equals cv2.imread bit for bit), in
# grey levels of each decoded image: nvJPEG's IDCT and chroma interpolation
# are not libjpeg-turbo's integer "islow" IDCT and fancy upsampling. Measured
# on the fixtures (H100 80GB HBM3, 700 W): max 4, p99 3, mean 0.72 at 4:2:0;
# 4:4:4 max 3, grayscale max 1. The bars leave that room and no more than
# half a level more on average: a wrong colour table, chroma siting or
# orientation moves them by tens.
NVJPEG_BARS = dict(max=6, p99=4, mean=1.0)
# the port's decode (libjpeg-turbo's integer arithmetic in its kernels) equals the plain decoder bit for bit
EXACT_BARS = dict(max=0, p99=0, mean=0.0)
# ``serve``: an answer against ``inference_topdown`` on the same file. The
# card's predict repeats itself only to the last bits of a keypoint: the tiny
# f32 config gave two calls 3.1e-5 px apart (H100 80GB HBM3, 700 W; cuDNN
# picks its transposed convolutions' algorithms freely), so the bar is
# a thousandth of a pixel and 1e-5 of a score.
SERVE_KPT_ATOL = 1e-3
SERVE_SCORE_ATOL = 1e-5
# the kernels' launches of one ProbPose-S predict call (a val batch is one)
PREDICT_LAUNCHES = dict(vit_layer=12, expected_oks=1, oks_convolve=0, vit_layer_train_fwd=0, vit_layer_train_bwd=0,
                        attention=0)
# a path that launches no kernel of the port (HRNet: cuDNN's convolutions)
NO_LAUNCHES = {k: 0 for k in PREDICT_LAUNCHES}
# ``dpm_predict``: two crops on the card against the same model on the CPU.
# The shipped config runs the backbone in bf16 (K1's bf16 instance on the
# card, its plain twin on the CPU: other rounding points), so the maps are
# held at K1's bf16 bar and the scalar outputs at the bf16 head bar of
# tests/test_torch_model.py (3e-2 absolute; both squashed to [0, 1]).
DPM_SCALAR_ATOL = 3e-2
# ``hrnet_predict``: the HRNet-w32 maps on the card against the CPU, both f32
# (TF32 off in predict): summation order only, as K1's f32 bar
HRNET_REL = 1e-4
# the HRNet + UDP golden fixture's bars, the JAX package's
# (tests/test_apis/test_e2e_parity_udp.py:105-124): keypoints p99 < 1 px
# against the reference, at most one beyond 5 px, scores within 2e-3, AP
# within 0.01
UDP_BARS = dict(p99=1.0, over_5px=1, scores=2e-3, ap=0.01)
# the tiny HRNet of tests/golden/e2e_udp_weights.pth (tools/make_golden_e2e_udp.py)
UDP_FIXTURE_EXTRA = dict(
    stage1=dict(num_modules=1, num_branches=1, block="BOTTLENECK", num_blocks=(1,), num_channels=(8,)),
    stage2=dict(num_modules=1, num_branches=2, block="BASIC", num_blocks=(1, 1), num_channels=(8, 16)),
    stage3=dict(num_modules=1, num_branches=3, block="BASIC", num_blocks=(1, 1, 1), num_channels=(8, 16, 32)),
    stage4=dict(num_modules=1, num_branches=4, block="BASIC", num_blocks=(1, 1, 1, 1), num_channels=(8, 16, 32, 64)),
)
UDP_FIXTURE_CFG = dict(
    model=dict(
        type="TopdownPoseEstimator",
        data_preprocessor=dict(
            type="PoseDataPreprocessor", mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375],
            bgr_to_rgb=True,
        ),
        backbone=dict(type="HRNet", in_channels=3, extra=UDP_FIXTURE_EXTRA),
        head=dict(
            type="HeatmapHead", in_channels=8, out_channels=17, deconv_out_channels=None,
            final_layer=dict(kernel_size=1), loss=dict(type="KeypointMSELoss", use_target_weight=True),
            decoder=dict(type="UDPHeatmap", input_size=(192, 256), heatmap_size=(48, 64), sigma=2),
        ),
        test_cfg=dict(flip_test=True, flip_mode="heatmap", shift_heatmap=False),
    )
)
# The two model fixtures of ``tests/golden_torch/`` (made by
# ``make_model_fixtures.py`` with the JAX package on the CPU): narrow models
# at the full 256 x 192 input, their weights drawn from a seed under mmpose's
# names, and the JAX package's ``inference_topdown`` over the golden images
# (keypoints, scores, AP) and its predict on two crops (the heatmaps, or
# SimCC's vectors). The keypoints, scores and AP are held at ``UDP_BARS``,
# the outputs on the crops at ``FIXTURE_OUTPUT_REL`` (relative max error:
# f32 on both sides, summation order, as ``HRNET_REL``).
FIXTURE_OUTPUT_REL = 1e-4
# A SimCC fixture's ties: keypoints whose reference x or y vector has its
# two largest bins within this relative gap. The f32 outputs of the card,
# the CPU and the JAX package differ by about 2e-6 of their range
# (``outputs_rel``), so the argmax of such a vector is noise: one whole-body
# keypoint, 1.2e-6 apart, decoded 165 px away on the CPU and two on the
# card (H100 80GB HBM3, 700 W). They are left out of the keypoint errors,
# as DARK's divergences are.
SIMCC_TIE_REL = 1e-5
# The GAU kernels against their plain twin (relative max error over the
# twin's largest magnitude): f32 on both sides, sums in another order; the
# gradients of gamma and beta sum over every row of the batch (8,512 at the
# whole-body step), in fixed chunks against cuBLAS's order.
GAU_REL = 1e-5
GAU_GRAD_REL = 1e-4
# The shapes the main paths give the GAU kernels (B, n): the whole-body
# step's, its predict call's (64 boxes and their flips), the body
# recipes' step, face6's step and predict call (LaPa's 106), hand5's step
# (21) and a 68-keypoint face step (300W, COCO-WholeBody-Face); e = 512 and
# s = 128 in every shipped config. The first is the kernels' record; the
# kernels are also timed at ``GAU_TIMED``.
GAU_SHAPES = ((64, 133), (128, 133), (256, 17), (256, 106), (128, 106), (256, 21), (64, 68))
GAU_TIMED = ((64, 133), (256, 106), (256, 21))
# The face and hand kernels against their plain twin (relative max error over the twin's largest magnitude):
# the depthwise forward and input gradient are 9-term f32 sums in another order; its weight gradient sums up to
# 64 x 128 x 128 products a tap (float64 across the chunks here, cuDNN's own order there); AdaptiveWingLoss's
# powf and log1pf against PyTorch's, its mean over 25.7 M values in float64 here.
DEPTHWISE_REL = 1e-5
DEPTHWISE_GRAD_REL = 1e-4
AWING_REL = 1e-5
# SCNet's gate kernels against their twin: the same f32 operations in another
# order (the resize's backward gathered in a fixed order where PyTorch's
# scatters by atomics), so a few ulp of each output's largest value
SC_GATE_REL = 1e-5
SC_GATE_GRAD_REL = 1e-5
# the split attention's kernels against their twin: the same f32 operations,
# the dot products over space summed in another order
SPLIT_ATTENTION_REL = 1e-5
SPLIT_ATTENTION_GRAD_REL = 1e-5
# the squeeze-and-excite kernels against their twin: the same f32 sums in another order (a warp's shuffle
# tree over each plane; the twin's mean), and the weights' gradients the same products of those
SE_LAYER_REL = 1e-5
SE_LAYER_GRAD_REL = 1e-5
_TOPDOWN_TEST = dict(test_dataloader=dict(dataset=dict(pipeline=[
    dict(type="LoadImage"), dict(type="GetBBoxCenterScale"), dict(type="TopdownAffine", input_size=(192, 256)),
    dict(type="PackPoseInputs")])))
_PREPROCESSOR = dict(type="PoseDataPreprocessor", mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375],
                     bgr_to_rgb=True)
CLASSIC_FIXTURE = dict(
    name="classic",
    cfg=dict(_TOPDOWN_TEST, model=dict(
        type="TopdownPoseEstimator", data_preprocessor=_PREPROCESSOR,
        backbone=dict(type="ResNet", depth=50, stem_channels=16, base_channels=4, out_indices=(3,)),
        head=dict(type="HeatmapHead", in_channels=128, out_channels=17, deconv_out_channels=(8, 8, 8),
                  deconv_kernel_sizes=(4, 4, 4), loss=dict(type="KeypointMSELoss", use_target_weight=True),
                  decoder=dict(type="MSRAHeatmap", input_size=(192, 256), heatmap_size=(48, 64), sigma=2,
                               unbiased=True)),
        test_cfg=dict(flip_test=True))),
    weights=GOLDEN_JPEG / "classic_weights.pth", outputs=GOLDEN_JPEG / "classic_fixture.npz",
    keys=("heatmaps",),
)
RTMPOSE_FIXTURE = dict(
    name="rtmpose",
    cfg=dict(_TOPDOWN_TEST, model=dict(
        type="TopdownPoseEstimator", data_preprocessor=_PREPROCESSOR,
        backbone=dict(type="CSPNeXt", arch="P5", expand_ratio=0.5, deepen_factor=0.167, widen_factor=0.0625,
                      out_indices=(4,), channel_attention=True),
        head=dict(type="RTMCCHead", in_channels=64, out_channels=17, input_size=(192, 256), in_featuremap_size=(6, 8),
                  simcc_split_ratio=2.0, final_layer_kernel_size=7,
                  gau_cfg=dict(hidden_dims=32, s=16, expansion_factor=2, dropout_rate=0.0, drop_path=0.0,
                               act_fn="SiLU", use_rel_bias=False, pos_enc=False),
                  loss=dict(type="KLDiscretLoss", use_target_weight=True, beta=10.0, label_softmax=True),
                  decoder=dict(type="SimCCLabel", input_size=(192, 256), sigma=(4.9, 5.66), simcc_split_ratio=2.0,
                               normalize=False, use_dark=False)),
        test_cfg=dict(flip_test=True))),
    weights=GOLDEN_JPEG / "rtmpose_weights.pth", outputs=GOLDEN_JPEG / "rtmpose_fixture.npz",
    keys=("keypoint_x_labels", "keypoint_y_labels"),
)
# ``tests/golden_torch/wholebody_*``: ``RTMPOSE_FIXTURE``'s narrow model with
# RTMCCHead's 133 outputs under COCO-WholeBody's metainfo (its test set a
# ``CocoWholeBodyDataset``), its AP ``CocoWholeBodyMetric``'s whole-body AP on
# the golden annotations in COCO-WholeBody's layout (``golden_fixture_ap``)
WHOLEBODY_FIXTURE = dict(
    RTMPOSE_FIXTURE, name="wholebody", dataset="coco_wholebody",
    cfg=dict(test_dataloader=dict(dataset=dict(_TOPDOWN_TEST["test_dataloader"]["dataset"],
                                               type="CocoWholeBodyDataset")),
             model=dict(RTMPOSE_FIXTURE["cfg"]["model"],
                        head=dict(RTMPOSE_FIXTURE["cfg"]["model"]["head"], out_channels=133))),
    weights=GOLDEN_JPEG / "wholebody_weights.pth", outputs=GOLDEN_JPEG / "wholebody_fixture.npz",
)
# ``tests/golden_torch/face_*``: the face fixtures, on the golden persons' face boxes (``face_hand_parts``) at
# 256 x 256, scored by NME (``golden_fixture_ap``): ``RTMPOSE_FIXTURE``'s narrow model with RTMCCHead's 106 outputs
# over its 8 x 8 map under LaPa's metainfo, without flip-TTA (on these smooth, upsampled face crops the random
# model's flip average makes its x vectors nearly mirror-symmetric: 4.4% of them had their two top bins within
# ``SIMCC_TIE_REL``, ties that decode at either end), and a narrow ResNet-18 with ``GlobalAveragePooling`` and a
# ``RegressionHead`` of 98 joints under WFLW's (its keypoints, which no argmax rounds, compared at
# ``FIXTURE_OUTPUT_REL``)
_FACE_PIPELINE = [dict(type="LoadImage"), dict(type="GetBBoxCenterScale"),
                  dict(type="TopdownAffine", input_size=(256, 256)), dict(type="PackPoseInputs")]
FACE_RTMPOSE_FIXTURE = dict(
    RTMPOSE_FIXTURE, name="face_rtmpose", dataset="lapa", boxes="face",
    cfg=dict(test_dataloader=dict(dataset=dict(type="LapaDataset", pipeline=_FACE_PIPELINE)),
             model=dict(RTMPOSE_FIXTURE["cfg"]["model"], head=dict(
        RTMPOSE_FIXTURE["cfg"]["model"]["head"], out_channels=106, input_size=(256, 256), in_featuremap_size=(8, 8),
        decoder=dict(type="SimCCLabel", input_size=(256, 256), sigma=(5.66, 5.66), simcc_split_ratio=2.0,
                     normalize=False, use_dark=False)), test_cfg=dict(flip_test=False))),
    weights=GOLDEN_JPEG / "face_rtmpose_weights.pth", outputs=GOLDEN_JPEG / "face_rtmpose_fixture.npz",
)
FACE_REGRESSION_FIXTURE = dict(
    name="face_regression", dataset="wflw", boxes="face",
    cfg=dict(test_dataloader=dict(dataset=dict(type="WFLWDataset", pipeline=_FACE_PIPELINE)), model=dict(
        type="TopdownPoseEstimator", data_preprocessor=_PREPROCESSOR,
        backbone=dict(type="ResNet", depth=18, stem_channels=16, base_channels=4, out_indices=(3,)),
        neck=dict(type="GlobalAveragePooling"),
        head=dict(type="RegressionHead", in_channels=32, num_joints=98,
                  loss=dict(type="WingLoss", use_target_weight=True),
                  decoder=dict(type="RegressionLabel", input_size=(256, 256))),
        test_cfg=dict(flip_test=True))),
    weights=GOLDEN_JPEG / "face_regression_weights.pth", outputs=GOLDEN_JPEG / "face_regression_fixture.npz",
    keys=("keypoints",),
)
FACE_FIXTURES = (FACE_RTMPOSE_FIXTURE, FACE_REGRESSION_FIXTURE)
# ``tests/golden_torch/{scnet,vipnas}_fixture.npz``: SCNet-50 (full width: the JAX module has no width option) with
# a narrow HeatmapHead, and a narrow ViPNAS_ResNet with ViPNASHead (16 groups a deconvolution), both MSRA at a
# 193 x 257 input, where every strided input is odd and the JAX modules' "SAME" padding agrees with the port's
# (mmpose's); their weights made at run time from seeds (``seeded_fixture_state``), their JAX outputs from the
# JAX variables that ``state_dict_from_jax`` carries onto those weights exactly
_ODD_PIPELINE = [dict(type="LoadImage"), dict(type="GetBBoxCenterScale"),
                 dict(type="TopdownAffine", input_size=(193, 257)), dict(type="PackPoseInputs")]
_ODD_MSRA = dict(type="MSRAHeatmap", input_size=(193, 257), heatmap_size=(56, 72), sigma=2)
SCNET_FIXTURE = dict(
    name="scnet",
    cfg=dict(test_dataloader=dict(dataset=dict(pipeline=_ODD_PIPELINE)), model=dict(
        type="TopdownPoseEstimator", data_preprocessor=_PREPROCESSOR, backbone=dict(type="SCNet", depth=50),
        head=dict(type="HeatmapHead", in_channels=2048, out_channels=17, deconv_out_channels=(16, 16, 16),
                  deconv_kernel_sizes=(4, 4, 4), loss=dict(type="KeypointMSELoss", use_target_weight=True),
                  decoder=_ODD_MSRA),
        test_cfg=dict(flip_test=True))),
    weights=lambda: seeded_fixture_state(SCNET_FIXTURE), outputs=GOLDEN_JPEG / "scnet_fixture.npz",
    keys=("heatmaps",),
)
VIPNAS_FIXTURE = dict(
    name="vipnas",
    cfg=dict(test_dataloader=dict(dataset=dict(pipeline=_ODD_PIPELINE)), model=dict(
        type="TopdownPoseEstimator", data_preprocessor=_PREPROCESSOR,
        backbone=dict(type="ViPNAS_ResNet", depth=50, wid=(16, 32, 32, 64, 64), dep=(None, 2, 2, 3, 2)),
        head=dict(type="ViPNASHead", in_channels=64, out_channels=17, deconv_out_channels=(32, 32, 32),
                  deconv_num_groups=(16, 16, 16), loss=dict(type="KeypointMSELoss", use_target_weight=True),
                  decoder=_ODD_MSRA),
        test_cfg=dict(flip_test=True))),
    weights=lambda: seeded_fixture_state(VIPNAS_FIXTURE), outputs=GOLDEN_JPEG / "vipnas_fixture.npz",
    keys=("heatmaps",),
)
CNN_ZOO_FIXTURES = (SCNET_FIXTURE, VIPNAS_FIXTURE)
# ``tests/golden_torch/{rtmw,hourglass,cpm,mspn}_fixture.npz``: the SimCC and multi-stage families narrowed, their
# weights made at run time from seeds (``seeded_fixture_state``), their JAX outputs from the JAX variables that
# ``state_dict_from_jax`` carries onto them: RTMW (CSPNeXt, CSPNeXtPAFPN with ``in_channels`` narrower than the
# backbone's widths, as RTMW-m's, and RTMWHead; 133 keypoints under COCO-WholeBody's metainfo), a two-stack
# HourglassNet with CPMHead and CPM (its stem at full width: the module has no width option) at 256 x 192, MSRA;
# MSPN with the pose refine machine at 257 x 193, MSRA (the Megvii decode's JAX predict departs, see
# ``megvii_decode_batch``). The hourglass runs only at even sides, where the JAX stem conv's "SAME" padding is
# (2, 3) and the port's mmpose's (3, 3): its fixture's model takes JAX's padding (``jax_same_padding``)
_WB_TEST = dict(test_dataloader=dict(dataset=dict(_TOPDOWN_TEST["test_dataloader"]["dataset"],
                                                  type="CocoWholeBodyDataset")))
_MSRA = dict(type="MSRAHeatmap", input_size=(192, 256), heatmap_size=(48, 64), sigma=2)
_MSE = dict(type="KeypointMSELoss", use_target_weight=True)
RTMW_FIXTURE = dict(
    name="rtmw", dataset="coco_wholebody",
    cfg=dict(_WB_TEST, model=dict(
        type="TopdownPoseEstimator", data_preprocessor=_PREPROCESSOR,
        backbone=dict(type="CSPNeXt", arch="P5", expand_ratio=0.5, deepen_factor=0.167, widen_factor=0.125,
                      out_indices=(3, 4), channel_attention=True),
        neck=dict(type="CSPNeXtPAFPN", in_channels=[48, 96], out_channels=None, out_indices=(0, 1), num_csp_blocks=1,
                  expand_ratio=0.5),
        head=dict(type="RTMWHead", in_channels=96, out_channels=133, input_size=(192, 256), in_featuremap_size=(6, 8),
                  simcc_split_ratio=2.0, final_layer_kernel_size=7,
                  gau_cfg=dict(hidden_dims=32, s=16, expansion_factor=2, act_fn="SiLU", use_rel_bias=False,
                               pos_enc=False),
                  loss=dict(type="KLDiscretLoss", use_target_weight=True, beta=10.0, label_softmax=True),
                  decoder=dict(type="SimCCLabel", input_size=(192, 256), sigma=(4.9, 5.66), simcc_split_ratio=2.0,
                               normalize=False, use_dark=False)),
        test_cfg=dict(flip_test=True))),
    weights=lambda: seeded_fixture_state(RTMW_FIXTURE), outputs=GOLDEN_JPEG / "rtmw_fixture.npz",
    keys=("keypoint_x_labels", "keypoint_y_labels"),
)
HOURGLASS_FIXTURE = dict(
    name="hourglass", jax_same_stem=True,
    cfg=dict(_TOPDOWN_TEST, model=dict(
        type="TopdownPoseEstimator", data_preprocessor=_PREPROCESSOR,
        backbone=dict(type="HourglassNet", num_stacks=2, downsample_times=4, stage_channels=(16, 16, 24, 24, 32),
                      stage_blocks=(1, 1, 1, 1, 2), feat_channel=16),
        head=dict(type="CPMHead", in_channels=16, out_channels=17, num_stages=2, deconv_out_channels=None, loss=_MSE,
                  decoder=_MSRA),
        test_cfg=dict(flip_test=True))),
    weights=lambda: seeded_fixture_state(HOURGLASS_FIXTURE), outputs=GOLDEN_JPEG / "hourglass_fixture.npz",
    keys=("heatmaps",),
)
CPM_FIXTURE = dict(
    name="cpm",
    cfg=dict(_TOPDOWN_TEST, model=dict(
        type="TopdownPoseEstimator", data_preprocessor=_PREPROCESSOR,
        backbone=dict(type="CPM", out_channels=17, num_stages=3, feat_channels=16, middle_channels=8),
        head=dict(type="CPMHead", in_channels=17, out_channels=17, num_stages=3, loss=_MSE,
                  decoder=dict(_MSRA, heatmap_size=(24, 32))),
        test_cfg=dict(flip_test=True))),
    weights=lambda: seeded_fixture_state(CPM_FIXTURE), outputs=GOLDEN_JPEG / "cpm_fixture.npz",
    keys=("heatmaps",),
)
MSPN_FIXTURE = dict(
    name="mspn",
    cfg=dict(test_dataloader=dict(dataset=dict(pipeline=_ODD_PIPELINE)), model=dict(
        type="TopdownPoseEstimator", data_preprocessor=_PREPROCESSOR,
        backbone=dict(type="MSPN", unit_channels=16, num_stages=2, num_units=4, num_blocks=(1, 1, 1, 1),
                      res_top_channels=8),
        head=dict(type="MSPNHead", num_stages=2, num_units=4, out_shape=(72, 56), unit_channels=16, out_channels=17,
                  use_prm=True, level_indices=[0, 1, 2, 3, 1, 2, 3, 3], loss=_MSE, decoder=_ODD_MSRA),
        test_cfg=dict(flip_test=True))),
    weights=lambda: seeded_fixture_state(MSPN_FIXTURE), outputs=GOLDEN_JPEG / "mspn_fixture.npz",
    keys=("heatmaps",),
)
MULTISTAGE_FIXTURES = (RTMW_FIXTURE, HOURGLASS_FIXTURE, CPM_FIXTURE, MSPN_FIXTURE)
# ``tests/golden_torch/{litehrnet,swin,hrformer,pvtv2}_fixture.npz``: the rest of top-down's backbones narrowed, each
# with a HeatmapHead (MSRA), their weights made at run time from seeds (``seeded_fixture_state``), their JAX
# outputs from the JAX variables that ``state_dict_from_jax`` carries onto them: LiteHRNet (three stages of one
# module of one block, widths 8-32) at 256 x 192, where the port runs with JAX's stride-2 padding
# (``jax_same_strided``: LiteHRNet runs only at even sides) and the JAX outputs are its module's eager ``apply``
# (``jax.jit`` cannot trace it); Swin (widths 16-128, two blocks a stage) and PVTv2 (widths 8-64, one block a
# stage) at 256 x 192; HRFormer (widths 8-64, one block a branch) at 257 x 193, where its strided inputs are odd
_LITE_NARROW = dict(stem=dict(stem_channels=16, out_channels=16, expand_ratio=1), num_stages=3, stages_spec=dict(
    num_modules=(1, 1, 1), num_branches=(2, 3, 4), num_blocks=(1, 1, 1), module_type=("LITE",) * 3,
    with_fuse=(True,) * 3, reduce_ratios=(4, 4, 4), num_channels=((8, 16), (8, 16, 24), (8, 16, 24, 32))),
    with_head=True)


def _heatmap_model(backbone, in_channels, deconv, decoder=_MSRA):
    return dict(type="TopdownPoseEstimator", data_preprocessor=_PREPROCESSOR, backbone=backbone,
                head=dict(type="HeatmapHead", in_channels=in_channels, out_channels=17, deconv_out_channels=deconv,
                          deconv_kernel_sizes=(4,) * len(deconv or ()), loss=_MSE, decoder=decoder),
                test_cfg=dict(flip_test=True))


LITEHRNET_FIXTURE = dict(
    name="litehrnet", jax_same_strided=True,
    cfg=dict(_TOPDOWN_TEST, model=_heatmap_model(dict(type="LiteHRNet", extra=_LITE_NARROW), 8, None)),
    weights=lambda: seeded_fixture_state(LITEHRNET_FIXTURE), outputs=GOLDEN_JPEG / "litehrnet_fixture.npz",
    keys=("heatmaps",),
)
SWIN_FIXTURE = dict(
    name="swin",
    cfg=dict(_TOPDOWN_TEST, model=_heatmap_model(dict(
        type="SwinTransformer", embed_dims=16, depths=(2, 2, 2, 2), num_heads=(1, 2, 2, 4), out_indices=(3,)),
        128, (16, 16, 16))),
    weights=lambda: seeded_fixture_state(SWIN_FIXTURE), outputs=GOLDEN_JPEG / "swin_fixture.npz", keys=("heatmaps",),
)
HRFORMER_FIXTURE = dict(
    name="hrformer",
    cfg=dict(test_dataloader=dict(dataset=dict(pipeline=_ODD_PIPELINE)), model=_heatmap_model(
        dict(type="HRFormer", base_channels=8, depths=(1, 1, 1)), 8, None, dict(_ODD_MSRA, heatmap_size=(49, 65)))),
    weights=lambda: seeded_fixture_state(HRFORMER_FIXTURE), outputs=GOLDEN_JPEG / "hrformer_fixture.npz",
    keys=("heatmaps",),
)
PVTV2_FIXTURE = dict(
    name="pvtv2",
    cfg=dict(_TOPDOWN_TEST, model=_heatmap_model(dict(
        type="PyramidVisionTransformerV2", embed_dims=8, num_layers=(1, 1, 1, 1), out_indices=(3,)), 64,
        (16, 16, 16))),
    weights=lambda: seeded_fixture_state(PVTV2_FIXTURE), outputs=GOLDEN_JPEG / "pvtv2_fixture.npz",
    keys=("heatmaps",),
)
TOPDOWN_REST_FIXTURES = (LITEHRNET_FIXTURE, SWIN_FIXTURE, HRFORMER_FIXTURE, PVTV2_FIXTURE)
# ``tests/golden_torch/{rle,dsnt,vis}_fixture.npz``: the regression heads on a ResNet-18 of 4-32 channels without a
# neck at 256 x 192: RLEHead (its keypoints, and its scores 1 - mean(sigma)), DSNTHead at beta = 10 with deconvolutions
# of 8 channels (the soft-argmax keypoints), and VisPredictHead around a HeatmapHead, MSRA (the keypoints, the scores
# and the visibility); their weights made at run time from seeds (``seeded_fixture_state``), their JAX outputs from
# the JAX variables that ``state_dict_from_jax`` carries onto them
_NARROW_RESNET18 = dict(type="ResNet", depth=18, stem_channels=16, base_channels=4, out_indices=(3,))
RLE_FIXTURE = dict(
    name="rle",
    cfg=dict(_TOPDOWN_TEST, model=dict(
        type="TopdownPoseEstimator", data_preprocessor=_PREPROCESSOR, backbone=_NARROW_RESNET18,
        head=dict(type="RLEHead", in_channels=32, num_joints=17, loss=dict(type="RLELoss", use_target_weight=True),
                  decoder=dict(type="RegressionLabel", input_size=(192, 256))),
        test_cfg=dict(flip_test=True, shift_coords=True))),
    weights=lambda: seeded_fixture_state(RLE_FIXTURE), outputs=GOLDEN_JPEG / "rle_fixture.npz", keys=("keypoints",),
)
DSNT_FIXTURE = dict(
    name="dsnt",
    cfg=dict(_TOPDOWN_TEST, model=dict(
        type="TopdownPoseEstimator", data_preprocessor=_PREPROCESSOR, backbone=_NARROW_RESNET18,
        head=dict(type="DSNTHead", in_channels=32, in_featuremap_size=(6, 8), num_joints=17, debias=True, beta=10.0,
                  deconv_out_channels=(8, 8, 8), loss=dict(type="MultipleLossWrapper", losses=[
                      dict(type="SmoothL1Loss", use_target_weight=True),
                      dict(type="JSDiscretLoss", use_target_weight=True)]),
                  decoder=dict(type="IntegralRegressionLabel", input_size=(192, 256), heatmap_size=(48, 64),
                               sigma=2.0, normalize=True)),
        test_cfg=dict(flip_test=True, shift_coords=True, shift_heatmap=True))),
    weights=lambda: seeded_fixture_state(DSNT_FIXTURE), outputs=GOLDEN_JPEG / "dsnt_fixture.npz", keys=("keypoints",),
)
VIS_FIXTURE = dict(
    name="vis", aux=("keypoints_visible",),
    cfg=dict(_TOPDOWN_TEST, model=dict(
        type="TopdownPoseEstimator", data_preprocessor=_PREPROCESSOR, backbone=_NARROW_RESNET18,
        head=dict(type="VisPredictHead", loss=dict(type="BCELoss", use_target_weight=True, use_sigmoid=True),
                  pose_cfg=dict(type="HeatmapHead", in_channels=32, out_channels=17, deconv_out_channels=(8, 8, 8),
                                loss=_MSE, decoder=_MSRA)),
        test_cfg=dict(flip_test=True))),
    weights=lambda: seeded_fixture_state(VIS_FIXTURE), outputs=GOLDEN_JPEG / "vis_fixture.npz", keys=("heatmaps",),
)
REGRESSION_FIXTURES = (RLE_FIXTURE, DSNT_FIXTURE, VIS_FIXTURE)
# the keys of a kernel's record that K2 and K2b fill from ``k2_timings``
K2_KEYS = ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
K3_NAMES = ("out", "dx", "ln1_scale", "ln1_bias", "w_qkv", "b_qkv", "w_proj", "b_proj",
            "ln2_scale", "ln2_bias", "w_fc1", "b_fc1", "w_fc2", "b_fc2")
# ``train_flagship``: the first step's loss dict through Runner.train against
# make_train_step on the same batch, weights and generator seed. Both run the
# same kernels on the same inputs (K3 and the head are deterministic), so
# the bar only leaves room for a reduction that cuDNN orders differently.
TRAIN_FLAGSHIP_REL = 1e-5
# COCO train2017 person instances with keypoints over the recipe's batch of 64
STEPS_PER_EPOCH = 149813 // 64

TINY_CFG = dict(
    model=dict(
        type="TopdownPoseEstimator",
        data_preprocessor=dict(
            type="PoseDataPreprocessor", mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375],
            bgr_to_rgb=True,
        ),
        backbone=dict(
            type="VisionTransformer",
            arch=dict(embed_dims=64, num_layers=2, num_heads=4, feedforward_channels=128),
            img_size=(256, 192), patch_size=16, with_cls_token=False, out_type="featmap",
            patch_cfg=dict(padding=2),
        ),
        head=dict(
            type="ProbMapHead", in_channels=64, out_channels=17, deconv_out_channels=(32, 32),
            deconv_kernel_sizes=(4, 4), normalize=1.0, freeze_error=True, freeze_oks=False,
            decoder=dict(type="ProbMap", input_size=(192, 256), heatmap_size=(48, 64), sigma=-1),
        ),
        test_cfg=dict(flip_test=True, flip_mode="heatmap", shift_heatmap=False),
    )
)


def full_model_cfg(shipped=False):
    """ProbPose-S at the full geometry of the golden fixture (ViT-S/16,
    width 384, 12 layers, deconv 256): f32 with exact GELU, as
    ``tests/test_apis/test_e2e_parity_full.py:MODEL_CFG``, or with the
    flagship's shipped bf16 / tanh-GELU settings."""
    import copy

    cfg = copy.deepcopy(TINY_CFG["model"])
    cfg["backbone"]["arch"] = dict(embed_dims=384, num_layers=12, num_heads=12, feedforward_channels=1536)
    cfg["head"].update(in_channels=384, deconv_out_channels=(256, 256))
    if shipped:
        cfg["backbone"].update(dtype="bfloat16", approximate_gelu=True)
        cfg["head"]["dtype"] = "bfloat16"
    return cfg


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def traced(host: bool = False):
    """``torch.profiler`` over the card's activity, and the host's too where
    ``host``. Every trace here reads only the kernels' names and device
    times: recording and parsing the host's operators as well took 5-28 s a
    trace of two train steps (the H100 machine's host), so a long trace
    leaves them out. A short one, of a few calls, keeps them: traced without
    them, late in the whole script such a trace lost most of the card's
    records (a kernel missing, K2's decode read at a twentieth of its time)."""
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA] if host else [ProfilerActivity.CUDA])


def device_records(prof) -> list:
    """(name, device us) of each kernel, copy or fill that a finished trace
    recorded, read from the tracer's results as they come, without building
    the profiler's event list."""
    from torch.autograd import DeviceType

    return [(e.name(), e.duration_ns() / 1e3) for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA]


def all_of(fns):
    """One callable that calls each of ``fns`` in turn."""
    return lambda: [fn() for fn in fns]


def cuda_time_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


class NvjpegBatched:
    """nvJPEG's batched decode on its GPU-hybrid backend
    (``probpose_code_torch/csrc/nvjpeg_batched.cu``, linked with nvJPEG):
    the yardstick of the port's JPEG decode, timed here for its
    ``library_ms`` and held against the plain decoder at ``NVJPEG_BARS``.
    The port never calls it. Images come out as stored (no EXIF
    orientation)."""

    SIGNATURES = {
        "nvjpeg_batched_create": [ctypes.c_void_p],
        "nvjpeg_batched_destroy": [ctypes.c_void_p],
        "nvjpeg_batched_decode": [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 5,
        "nvjpeg_batched_error_string": ([ctypes.c_int], ctypes.c_char_p),
    }

    def __init__(self):
        from probpose_code_torch.ops.kernels import _build

        self.lib = _build.load("nvjpeg_batched", self.SIGNATURES)
        self.ctx = ctypes.c_void_p()
        self._check(self.lib.nvjpeg_batched_create(ctypes.byref(self.ctx)), "creating a handle")

    def _check(self, code: int, what: str) -> None:
        if code >= 1000:
            raise RuntimeError(f"nvjpeg_batched: {what}: CUDA error {code - 1000} "
                               f"({self.lib.nvjpeg_batched_error_string(code - 1000).decode()})")
        if code:
            raise RuntimeError(f"nvjpeg_batched: {what}: nvJPEG status {code}")

    def decode(self, datas, infos):
        """The streams (with their ``datasets.jpeg.probe`` results) into a
        new zeroed (B, Hmax, Wmax, 3) uint8 BGR tensor on the card, image i
        as stored at the top left of slot i."""
        import torch

        n = len(datas)
        out = torch.zeros((n, max(i.height for i in infos), max(i.width for i in infos), 3), dtype=torch.uint8,
                          device="cuda")
        code = self.lib.nvjpeg_batched_decode(
            self.ctx, n, (ctypes.c_char_p * n)(*datas), (ctypes.c_size_t * n)(*[len(d) for d in datas]),
            (ctypes.c_void_p * n)(*[out[i].data_ptr() for i in range(n)]), (ctypes.c_int * n)(*[out.shape[2] * 3] * n),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        self._check(code, "decoding a batch")
        return out

    def close(self) -> None:
        self._check(self.lib.nvjpeg_batched_destroy(self.ctx), "destroying its handle")


def layer_inputs(B, N, C, F, dtype, seed):
    import torch

    g = torch.Generator().manual_seed(seed)

    def r(*shape, s=1.0):
        return (torch.randn(*shape, generator=g) * s).cuda()

    x = r(B, N, C).to(dtype)
    params = [
        1.0 + r(C, s=0.1), r(C, s=0.1), r(C, 3 * C, s=0.08), r(3 * C, s=0.05),
        r(C, C, s=0.08), r(C, s=0.05), 1.0 + r(C, s=0.1), r(C, s=0.1),
        r(C, F, s=0.08), r(F, s=0.05), r(F, C, s=0.08), r(C, s=0.05),
    ]
    return x, params


def drop_masks(B, keep, seed):
    """Per-image stochastic-depth multipliers (0 or 1/keep) with the first
    image's attention branch and the last image's MLP branch dropped."""
    import torch

    g = torch.Generator().manual_seed(seed)
    m1, m2 = ((torch.rand(2, B, generator=g) < keep).float() / keep).cuda()
    m1[0] = 0.0
    m2[-1] = 0.0
    return m1, m2


def k3_errors(B, N, C, H, F, dtype, masked, seed):
    """K3's output and its 13 gradients (x and the twelve parameters) against
    the plain twin's under torch autograd, on the same inputs and the same
    random output gradient: {name: relative max error}."""
    import torch

    from probpose_code_torch.ops.kernels.vit_layer_train import vit_layer_train, vit_layer_train_plain

    x, p = layer_inputs(B, N, C, F, dtype, seed)
    m1, m2 = drop_masks(B, 0.9, seed) if masked else (None, None)
    g = torch.randn(B, N, C, generator=torch.Generator().manual_seed(seed + 1)).cuda().to(dtype)
    results = []
    for fn in (vit_layer_train, vit_layer_train_plain):
        xs = x.clone().requires_grad_(True)
        ps = [t.clone().requires_grad_(True) for t in p]
        out = fn(xs, *ps, m1, m2, num_heads=H, dtype=dtype)
        results.append([out.detach().float()] + [t.float() for t in torch.autograd.grad(out, [xs, *ps], g)])
    torch.cuda.synchronize()
    # a gradient that is zero on both sides (every image's branch dropped) counts as 0
    return {n: ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item() for n, a, b in zip(K3_NAMES, *results)}


def synthetic_train_batch(B, seed):
    """A batch of B crops as the ProbMap codec and the device pipeline give
    it: raw 0-255 crops, heatmap-space keypoints (some outside the map, some
    unannotated) whose maps are encoded on the card, and the codec's weight
    fields (``codecs/probmap.py:_encode_probmap``)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    W, H = 192, 256  # input size
    K = 17
    kpts = torch.stack([torch.rand(B, K, generator=g) * (W + 40) - 20,
                        torch.rand(B, K, generator=g) * (H + 40) - 20], dim=-1)
    vis = (torch.rand(B, K, generator=g) > 0.15).float()
    visibility = (torch.rand(B, K, generator=g) > 0.3).float() * vis
    in_image = ((kpts[..., 0] >= 0) & (kpts[..., 0] < W) & (kpts[..., 1] >= 0) & (kpts[..., 1] < H)).float()
    scale = torch.tensor([(W - 1) / (48 - 1), (H - 1) / (64 - 1)])
    batch = dict(
        inputs=torch.randint(0, 256, (B, H, W, 3), generator=g).float(),
        kpts_hm=kpts / scale, kpts_visible=vis, keypoint_weights=vis, in_image=in_image,
        annotated=(vis > 0).float(), keypoints_visibility=visibility,
    )
    return {k: v.cuda() for k, v in batch.items()}


def synthetic_codec_batch(B, seed, codec, K=17):
    """A batch of B crops as the config's ``GenerateTarget`` (the port's,
    deferred) ships it for ``codec``: raw 0-255 crops, K input-space
    keypoints (some outside the crop, some unannotated) turned into what the
    device encodes (MSRA's float64 heatmap-space keypoints, UDP's, SimCC's
    bins) and the codec's weights; on the card."""
    import numpy as np
    import torch

    from probpose_code_torch.datasets.transforms.common import GenerateTarget

    rng = np.random.RandomState(seed)
    W, H = codec["input_size"]
    target = GenerateTarget(encoder=dict(codec))
    shipped = [target({"transformed_keypoints": np.stack([rng.uniform(-20, W + 20, (1, K)),
                                                          rng.uniform(-20, H + 20, (1, K))], -1).astype(np.float32),
                       "keypoints_visible": (rng.rand(1, K) > 0.15).astype(np.float32)}) for _ in range(B)]
    batch = dict(inputs=torch.from_numpy(rng.randint(0, 256, (B, H, W, 3)).astype(np.float32)),
                 kpts_hm=torch.from_numpy(np.stack([s["device_kpts_hm"][0] for s in shipped])),
                 kpts_visible=torch.from_numpy(np.stack([s["device_kpts_visible"][0] for s in shipped])),
                 keypoint_weights=torch.from_numpy(np.stack([s["keypoint_weights"][0] for s in shipped])))
    return {k: v.cuda() for k, v in batch.items()}


def coco_data_options(root, train_json=None, workers=4):
    """``--cfg-options`` items that point a config's single COCO val set
    (no detector boxes) and, given ``train_json``, its train set at the
    golden set under ``root`` (``val.json``, ``imgs/``)."""
    options = [f"val_dataloader.dataset.data_root={root}", "val_dataloader.dataset.ann_file=val.json",
               "val_dataloader.dataset.data_prefix.img=imgs/", "val_dataloader.dataset.bbox_file=None",
               f"val_dataloader.num_workers={workers}", f"val_evaluator.ann_file={Path(root) / 'val.json'}"]
    if train_json:
        options += [f"train_dataloader.dataset.data_root={root}", f"train_dataloader.dataset.ann_file={train_json}",
                    "train_dataloader.dataset.data_prefix.img=imgs/", f"train_dataloader.num_workers={workers}"]
    return options


# the DoubleProbPose config's codec and head (its config file), at the tiny model's width
DPM_CODEC = dict(type="DoubleProbMap", input_size=(192, 256), heatmap_size=(48, 64), sigma=-1, in_heatmap_padding=1.0,
                 out_heatmap_padding=1.25)


def tiny_dpm_cfg():
    """``TINY_CFG`` with the DoubleProbPose head (f32, tanh-GELU, drop_path 0)."""
    import copy

    cfg = copy.deepcopy(TINY_CFG)
    cfg["model"]["backbone"].update(approximate_gelu=True, drop_path_rate=0.0)
    cfg["model"]["head"] = dict(
        type="DoubleProbMapHead", in_channels=64, out_channels=17, deconv_out_channels=(32, 32),
        deconv_kernel_sizes=(4, 4), split_heatmaps_by="in/all", freeze_error=True, freeze_oks=False,
        keypoint_loss=dict(type="OKSHeatmapLoss", use_target_weight=True, smoothing_weight=0.05),
        probability_loss=dict(type="BCELoss", use_target_weight=True, use_sigmoid=True),
        visibility_loss=dict(type="BCELoss", use_target_weight=True, use_sigmoid=True),
        oks_loss=dict(type="MSELoss", use_target_weight=True),
        error_loss=dict(type="L1LogLoss", use_target_weight=True), decoder=DPM_CODEC,
    )
    return cfg


def synthetic_dpm_batch(B, seed):
    """A DoubleProbMap training batch of B crops as its pipeline ships it,
    NumPy arrays: raw crops, both windows' keypoints from ``GenerateTarget``
    (some keypoints outside the crop, some unannotated), the labels, and the
    bbox mask's rectangle and UDP matrix for a box in a 480 x 640 image."""
    import numpy as np

    from probpose_code_torch.datasets.transforms.common import GenerateTarget
    from probpose_code_torch.ops.bbox_mask import mask_rect
    from probpose_code_torch.structures.bbox import bbox_xyxy2cs, fix_aspect_ratio, get_udp_warp_matrix

    rng = np.random.RandomState(seed)
    target = GenerateTarget(encoder=DPM_CODEC)
    samples = []
    for _ in range(B):
        kpts = np.stack([rng.uniform(-40, 232, (1, 17)), rng.uniform(-50, 306, (1, 17))], -1).astype(np.float32)
        vis = (rng.rand(1, 17) > 0.15).astype(np.float32)
        out = target(dict(transformed_keypoints=kpts, keypoints_visible=vis))
        x0, y0 = rng.uniform(-60, 500), rng.uniform(-60, 380)
        box = np.array([[x0, y0, x0 + rng.uniform(40, 260), y0 + rng.uniform(60, 300)]])
        center, scale = bbox_xyxy2cs(box, padding=1.25)
        scale = fix_aspect_ratio(scale, 192 / 256)
        out.update(visibility=(rng.rand(17) > 0.3) * vis[0], rect=mask_rect(box, (480, 640)),
                   mat=get_udp_warp_matrix(center[0], scale[0], rng.uniform(-40, 40), output_size=(192, 256)))
        samples.append(out)

    def stack(key, dtype, index=0):
        return np.stack([np.asarray(s[key])[index] if index is not None else s[key] for s in samples]).astype(dtype)

    in_image = stack("in_image", np.float32)
    return dict(
        inputs=rng.randint(0, 256, (B, 256, 192, 3)).astype(np.float32),
        kpts_hm=stack("device_kpts_hm", np.float64), kpts_hm_out=stack("device_kpts_hm_out", np.float64),
        kpts_visible=stack("device_kpts_visible", np.float32), keypoint_weights=stack("keypoint_weights", np.float32),
        in_image=in_image, annotated=stack("annotated", np.float32), keypoints_in_image=in_image,
        keypoints_visibility=stack("visibility", np.float32, None), bbox_mask_rect=stack("rect", np.int32, None),
        bbox_mask_mat=stack("mat", np.float32, None),
    )


def peaked_heatmaps(B, K, H, W, seed):
    """(B, K, H, W) float32 numpy maps with one gaussian peak each, away
    from the border: argmax ties on flat noise are last-bit behaviour, so the
    decode is held on real peaks (tests/test_ops/test_pallas_decode.py:44-47)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:H, :W]
    cy = rng.uniform(2, H - 3, (B, K, 1, 1))
    cx = rng.uniform(2, W - 3, (B, K, 1, 1))
    return np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 8.0).astype(np.float32)


def golden_boxes(anns, boxes="person"):
    """(N, 4) x1 y1 x2 y2 boxes of golden annotations: the persons' own, or
    for ``boxes="face"`` their faces (``face_hand_parts``)."""
    import numpy as np

    faces = face_hand_parts(GOLDEN / "e2e_coco.json") if boxes == "face" else None
    xywh = [faces[a["id"]]["face"] if faces else a["bbox"] for a in anns]
    return np.array([[x, y, x + w, y + h] for x, y, w, h in xywh], np.float32)


def golden_samples(model, boxes="person"):
    """The golden fixture's 24 images and boxes (``golden_boxes``: the
    persons' or their faces') through ``inference_topdown``. Returns
    (fixture arrays, samples with the annotation id / image id set)."""
    import numpy as np

    from probpose_code_torch.apis import inference_topdown

    data = np.load(GOLDEN / "e2e_pipeline.npz")
    gt = json.loads((GOLDEN / "e2e_coco.json").read_text())
    anns = {}
    for a in gt["annotations"]:
        anns.setdefault(a["image_id"], []).append(a)
    kind = boxes
    samples = []
    for im in gt["images"]:
        boxes = golden_boxes(anns[im["id"]], kind)
        preds = inference_topdown(model, data[f"img_{im['id']}"], boxes)
        if len(preds) != len(boxes):
            raise AssertionError(f"{len(preds)} predictions for {len(boxes)} boxes")
        for a, s in zip(anns[im["id"]], preds):
            s.set_metainfo(dict(id=a["id"], img_id=im["id"]))
            samples.append(s)
    return data, samples


GOLDEN_AUX = (("keypoints_probs", "pred_keypoint_probs"), ("keypoints_visible", "pred_keypoints_visible"),
              ("keypoints_oks", "pred_keypoint_scores"), ("keypoints_error", "pred_keypoint_errors"),
              ("keypoints_conf", "pred_keypoints_conf"))


def golden_errors(data, samples):
    """Per-keypoint pixel error against the reference decode (in the
    fixture's order) and the max error of each aux field."""
    import numpy as np

    by_id = {s.metainfo["id"]: s for s in samples}
    ids = data["pred_ids"]
    ours = np.stack([by_id[i].pred_instances.keypoints.reshape(17, 2) for i in ids])
    err = np.linalg.norm(ours - data["pred_keypoints"], axis=-1)
    aux = {f: float(np.abs(np.stack([by_id[i].pred_instances[f].reshape(17) for i in ids]) - data[k]).max())
           for f, k in GOLDEN_AUX}
    return err, aux


def udp_fixture_report(model):
    """The HRNet + UDP golden fixture (``tests/golden/e2e_udp_*``) through
    ``inference_topdown`` and ``CocoMetric`` with ``model`` (its weights
    loaded), against the reference's keypoints, scores and AP; the
    reference's own DARK divergences (coordinates thousands of pixels out,
    3 of 289) are left out, as the JAX package's test leaves them. Returns
    a report with ``ok`` against ``UDP_BARS``."""
    import numpy as np

    from probpose_code_torch.apis import inference_topdown
    from probpose_code_torch.datasets.metainfo import parse_pose_metainfo
    from probpose_code_torch.evaluation import CocoMetric

    data = np.load(GOLDEN / "e2e_udp_pipeline.npz")
    gt = json.loads((GOLDEN / "e2e_udp_coco.json").read_text())
    anns = {}
    for a in gt["annotations"]:
        anns.setdefault(a["image_id"], []).append(a)
    samples = []
    for im in gt["images"]:
        boxes = np.array([[a["bbox"][0], a["bbox"][1], a["bbox"][0] + a["bbox"][2], a["bbox"][1] + a["bbox"][3]]
                          for a in anns[im["id"]]], np.float32)
        preds = inference_topdown(model, data[f"img_{im['id']}"], bboxes=boxes)
        if len(preds) != len(boxes):
            raise AssertionError(f"{len(preds)} predictions for {len(boxes)} boxes")
        for a, sample in zip(anns[im["id"]], preds):
            sample.set_metainfo(dict(id=a["id"], img_id=im["id"]))
            samples.append(sample)
    by_id = {s.metainfo["id"]: s for s in samples}
    ids = data["pred_ids"]
    ours = np.stack([np.asarray(by_id[i].pred_instances["keypoints"]).reshape(17, 2) for i in ids])
    ref = data["pred_keypoints"]
    sane = np.all(np.abs(ref) < 1000.0, axis=-1)
    err = np.linalg.norm(ours - ref, axis=-1)[sane]
    scores = np.stack([np.asarray(by_id[i].pred_instances["keypoint_scores"]).reshape(17) for i in ids])
    metric = CocoMetric(ann_file=str(GOLDEN / "e2e_udp_coco.json"), extended=[False])
    metric.dataset_meta = parse_pose_metainfo({"dataset_name": "coco"})
    metric.process(None, samples)
    ap = metric.compute_metrics(metric.results)["AP"]
    report = dict(instances=len(samples), sane=float(sane.mean()), p99=float(np.percentile(err, 99)),
                  max=float(err.max()), over_5px=int((err > 5.0).sum()),
                  scores=float(np.abs(scores - data["pred_keypoint_scores"]).max()), AP=float(ap),
                  ref_AP=float(data["stats"][0]), d_AP=abs(float(ap) - float(data["stats"][0])))
    report["ok"] = (report["sane"] > 0.97 and report["p99"] < UDP_BARS["p99"]
                    and report["over_5px"] <= UDP_BARS["over_5px"] and report["scores"] < UDP_BARS["scores"]
                    and report["d_AP"] < UDP_BARS["ap"])
    return report


def randomize_batch_stats(module, seed: int) -> None:
    """Every BatchNorm's running mean in [-0.2, 0.2) and variance in [0.5, 1.5),
    drawn by NumPy from ``seed``."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for name, buf in module.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(torch.from_numpy(rng.uniform(-0.2, 0.2, buf.shape).astype(np.float32)))
            elif name.endswith("running_var"):
                buf.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, buf.shape).astype(np.float32)))


def dpm_fixture_cfg():
    """The DoubleProbPose-S config's model and test pipeline with its ViT in
    f32: the bf16 backbone's rounding differs between the card's K1 and the
    JAX package's XLA, and on the flat maps of random weights that moves an
    argmax by tens of pixels (K1's f32 instance differs from the CPU in the
    last bits only)."""
    import copy

    from probpose_code_torch.config import Config

    cfg = Config.fromfile(str(DPM))
    model = copy.deepcopy(cfg["model"])
    model["backbone"]["dtype"] = "float32"
    return dict(model=model, test_dataloader=dict(dataset=dict(pipeline=copy.deepcopy(cfg["val_pipeline"]))))


# the DoubleProbMapHead's four scalar towers
DPM_TOWERS = ("probability_layers", "visibility_layers", "oks_layers", "error_layers")


def dpm_fixture_state():
    """The DoubleProbPose fixture's weights, made on the CPU from seeds as
    ``tools/_e2e_torch_model.build_e2e_model`` makes the e2e model's:
    ``PoseModel.init_weights(seed=0)``, the BatchNorm statistics randomized
    from seed 1, and each scalar tower's last convolution widened 12 times
    with its bias drawn from N(0, 1) (seed 2) so that the probabilities,
    visibilities and OKS span (0, 1). Returns the state dict (about 90 MB:
    made at run time, not kept in the repository)."""
    import numpy as np
    import torch

    from probpose_code_torch.datasets.metainfo import parse_pose_metainfo
    from probpose_code_torch.models.builder import PoseModel

    model = PoseModel(dpm_fixture_cfg()["model"], metainfo=parse_pose_metainfo({"dataset_name": "coco"}),
                      device="cpu")
    model.init_weights(seed=0)
    randomize_batch_stats(model.module, seed=1)
    rng = np.random.RandomState(2)
    with torch.no_grad():
        for tower in DPM_TOWERS:
            last = [m for m in getattr(model.module.head, tower).modules() if isinstance(m, torch.nn.Conv2d)][-1]
            last.weight.mul_(12.0)
            last.bias.copy_(torch.from_numpy(rng.normal(0.0, 1.0, last.bias.shape).astype(np.float32)))
    return {k: v.clone() for k, v in model.module.state_dict().items()}


@contextlib.contextmanager
def jax_same_strided():
    """For the duration, every stride-2 convolution padded ``k // 2`` (the
    port's, mmpose's) padded as flax's "SAME" pads instead: total ``max((ceil(n
    / s) - 1) * s + k - n, 0)`` a side, the larger half after ((0, 1) at a 3x3
    conv on an even side, (2, 3) at a 7x7 one): ``F.conv2d`` substituted, and
    LiteHRNet's strided depthwise convs (``litehrnet.depthwise``, on the card
    the kernels of ``csrc/depthwise.cu``, which pad 1) run as ``F.conv2d``. A
    substitution for holding a model against the JAX package;
    ``jax_same_padding`` keeps it on for one module's forward."""
    import torch.nn.functional as F

    from probpose_code_torch.models.backbones import litehrnet

    conv2d, depthwise = F.conv2d, litehrnet.depthwise

    def same(x, w, b=None, stride=1, padding=0, dilation=1, groups=1):
        s = stride if isinstance(stride, int) else stride[0]
        k = w.shape[-1]
        if s != 2 or padding not in (k // 2, (k // 2, k // 2)):
            return conv2d(x, w, b, stride, padding, dilation, groups)
        pads = []
        for n in (x.shape[3], x.shape[2]):
            total = max((-(-n // s) - 1) * s + k - n, 0)
            pads += [total // 2, total - total // 2]
        return conv2d(F.pad(x, pads), w, b, stride, 0, dilation, groups)

    def strided_depthwise(conv, x):
        if conv.stride[0] == 1:
            return depthwise(conv, x)
        return F.conv2d(x.float(), conv.weight, None, conv.stride, 1, 1, conv.groups)

    F.conv2d, litehrnet.depthwise = same, strided_depthwise
    try:
        yield
    finally:
        F.conv2d, litehrnet.depthwise = conv2d, depthwise


def jax_same_padding(module):
    """``module`` (a ``ConvModule`` of ``models/backbones/classic.py``) with its
    forward run under ``jax_same_strided``: a stride-2 conv in it padded as
    flax's "SAME" pads ((2, 3) at a stride-2 7x7 conv on an even side, where
    the port pads mmpose's (3, 3)), for holding a model against the JAX
    package's."""
    forward = module.forward

    def padded(*args):
        with jax_same_strided():
            return forward(*args)

    module.forward = padded
    return module


def seeded_fixture_state(fixture):
    """A model fixture's weights made on the CPU from seeds:
    ``PoseModel.init_weights(seed=0)`` and the BatchNorm statistics
    randomized from seed 1, as a state dict."""
    from probpose_code_torch.datasets.metainfo import parse_pose_metainfo
    from probpose_code_torch.models.builder import PoseModel

    model = PoseModel(fixture["cfg"]["model"], metainfo=parse_pose_metainfo({"dataset_name": "coco"}), device="cpu")
    model.init_weights(seed=0)
    randomize_batch_stats(model.module, seed=1)
    return {k: v.clone() for k, v in model.module.state_dict().items()}


# ``tests/golden_torch/dpm_fixture.npz``: the DoubleProbPose-S fixture, its
# weights made at run time (``dpm_fixture_state``), the JAX package's
# keypoints, scores, the four scalar outputs and AP over the golden boxes,
# and both windows' maps on two crops
DPM_FIXTURE = dict(name="dpm", cfg=dpm_fixture_cfg, weights=dpm_fixture_state,
                   outputs=GOLDEN_JPEG / "dpm_fixture.npz", keys=("heatmaps", "out_heatmaps"),
                   aux=("keypoints_probs", "keypoints_visible", "keypoints_oks", "keypoints_error"))


# the face fixtures' datasets: the golden persons' faces in that dataset's layout (``face_hand_sets_from_coco``)
FACE_FIXTURE_SETS = dict(lapa="LapaDataset", wflw="WFLWDataset")


def face_fixture_gt(dataset):
    """{annotation id: (keypoints (1, K, 2), visible (1, K))} of the golden
    persons' faces in the layout of ``FACE_FIXTURE_SETS[dataset]``."""
    import tempfile

    import numpy as np

    kind = FACE_FIXTURE_SETS[dataset]
    with tempfile.TemporaryDirectory() as tmp:
        face_hand_sets_from_coco(GOLDEN / "e2e_coco.json", tmp, [kind])
        anns = json.loads(Path(tmp, f"{kind}.json").read_text())["annotations"]
    out = {}
    for a in anns:
        kpts = np.array(a["keypoints"], np.float32).reshape(1, -1, 3)
        out[a["id"]] = kpts[..., :2], np.minimum(1, kpts[..., 2])
    return out


def golden_fixture_ap(samples, dataset="coco"):
    """The score of the predictions ``samples`` on the golden boxes: the AP
    of CocoMetric on ``tests/golden/e2e_coco.json``, or for
    ``dataset="coco_wholebody"`` CocoWholeBodyMetric's whole-body AP on the
    same annotations in COCO-WholeBody's layout (``wholebody_set_from_coco``,
    seed 0); for a face dataset (``FACE_FIXTURE_SETS``) the NME (inter-ocular
    norm) against the golden faces in its layout (``face_fixture_gt``)."""
    import tempfile

    import numpy as np

    from probpose_code_torch.datasets.metainfo import parse_pose_metainfo
    from probpose_code_torch.evaluation import NME, CocoMetric, CocoWholeBodyMetric

    if dataset in FACE_FIXTURE_SETS:
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


def fixture_model(fixture, device):
    """``init_model`` on a model fixture's config and weights (a file, or
    made by a function and written to one), every key the model's; with
    ``jax_same_stem``, the stem's first conv padded as the JAX module pads it
    (``jax_same_padding``)."""
    import tempfile

    import torch

    from probpose_code_torch.apis import init_model

    cfg = fixture["cfg"]() if callable(fixture["cfg"]) else fixture["cfg"]
    with tempfile.TemporaryDirectory() as tmp:
        weights = fixture["weights"]
        if callable(weights):
            saved, weights = weights(), Path(tmp, "weights.pth")
            torch.save(saved, weights)
        else:
            saved = torch.load(weights, map_location="cpu", weights_only=True)
        model = init_model(cfg, checkpoint=str(weights), device=device)
    if set(saved) != set(model.module.state_dict()):
        raise AssertionError(f"{fixture['name']} fixture: its keys are not the model's")
    if fixture.get("jax_same_stem"):
        jax_same_padding(model.module.backbone.stem[0])
    return model


def fixture_output_name(key):
    """The name in a fixture's outputs of the crops' ``key`` output: the
    regressed ``keypoints`` of the crops are ``crop_keypoints`` (the
    image's are ``keypoints``)."""
    return "crop_keypoints" if key == "keypoints" else key


def model_fixture_report(fixture, device):
    """A model fixture (``CLASSIC_FIXTURE``, ``RTMPOSE_FIXTURE``,
    ``WHOLEBODY_FIXTURE``, ``DPM_FIXTURE``, ``FACE_FIXTURES``) through
    ``init_model`` with its weights (``fixture_model``), ``inference_topdown``
    over the golden images' person or face boxes and the AP, or a face
    fixture's NME, in ``AP`` (``golden_fixture_ap``), against the JAX
    package's keypoints, scores, the fixture's ``aux`` outputs and AP or NME
    (``UDP_BARS``; the aux outputs at the scores' bar); and
    ``PoseModel.predict`` on the fixture's two crops against the JAX
    package's heatmaps, SimCC vectors or regressed keypoints
    (``FIXTURE_OUTPUT_REL``); with ``jax_same_strided``, the strided convs
    padded as JAX pads them (``jax_same_strided``). Returns a report with
    ``ok``."""
    if fixture.get("jax_same_strided"):
        with jax_same_strided():
            return _model_fixture_report(fixture, device)
    return _model_fixture_report(fixture, device)


def _model_fixture_report(fixture, device):
    import numpy as np
    import torch

    model = fixture_model(fixture, device)
    K = model.metainfo["num_keypoints"]
    ref = np.load(fixture["outputs"])
    _, samples = golden_samples(model, fixture.get("boxes", "person"))
    by_id = {s.metainfo["id"]: s for s in samples}

    def ours(field, *shape):
        return np.stack([np.asarray(by_id[i].pred_instances[field]).reshape(*shape) for i in ref["ids"]])

    kpts = ours("keypoints", K, 2)
    scores = ours("keypoint_scores", K)
    aux = max((float(np.abs(ours(f, K) - ref[f]).max()) for f in fixture.get("aux", ())), default=0.0)
    # DARK's own divergences (coordinates thousands of pixels out, where the
    # Hessian is near singular) are left out, as ``udp_fixture_report`` leaves
    # them, and so are a SimCC fixture's ties (``SIMCC_TIE_REL``)
    ties = ref["ties"] if "ties" in ref else np.zeros(ref["keypoints"].shape[:2], bool)
    sane = np.all(np.abs(ref["keypoints"]) < 1000.0, axis=-1) & ~ties
    err = np.linalg.norm(kpts - ref["keypoints"], axis=-1)[sane]
    ap = golden_fixture_ap(samples, fixture.get("dataset", "coco"))
    preds = model.predict(torch.from_numpy(ref["crops"].astype(np.float32)).to(model.device))
    rel = max(float(np.abs(preds[k].cpu().numpy() - ref[fixture_output_name(k)]).max()
                    / np.abs(ref[fixture_output_name(k)]).max()) for k in fixture["keys"])
    report = dict(instances=len(samples), keypoints=K, ties=int(ties.sum()), sane=float(sane.mean()),
                  p99=float(np.percentile(err, 99)),
                  max=float(err.max()), over_5px=int((err > 5.0).sum()),
                  scores=float(np.abs(scores - ref["scores"]).max()), aux=aux,
                  AP=float(ap), ref_AP=float(ref["ap"]), d_AP=abs(float(ap) - float(ref["ap"])), outputs_rel=rel)
    report["ok"] = (report["sane"] > 0.97 and report["p99"] < UDP_BARS["p99"]
                    and report["over_5px"] <= UDP_BARS["over_5px"] and report["scores"] < UDP_BARS["scores"]
                    and aux < UDP_BARS["scores"] and report["d_AP"] < UDP_BARS["ap"] and rel < FIXTURE_OUTPUT_REL)
    return report


# ``tests/golden_torch/augment_fixture.npz`` (``make_augment_fixtures.py``,
# cv2 on the CPU): input crops cut from the golden images by cv2, a batch of
# ``AUGMENT_B`` parameter sets over them (``augment_fixture_params``), and
# the SHA-256 of cv2's uint8 result after each of the four ops of each
# sample; ``PhotometricDistortion``'s rows (``photometric_fixture_params``)
# and the SHA-256 of each sample's result by cv2 and NumPy after the HSV
# jitter and on the crop; the SHA-256 of cv2's BGR -> HSV of every colour
# (``all_bgr_colours``), of its HSV -> BGR of every HSV triple
# (``all_hsv_triples``) and of hue 180's, and of its blur and median of the
# window-sum tiles (``window_sum_tiles``) for each kernel size. The card's machine has no
# OpenCV: the digests hold it to cv2's bytes exactly.
AUGMENT_FIXTURE = GOLDEN_JPEG / "augment_fixture.npz"
AUGMENT_B = 256
AUGMENT_KSIZES = (3, 5, 7)
AUGMENT_STAGES = ("hsv_gains", "blur_ksize", "median_ksize", "dropout_rects")
# cv2's digests of each sample after ``PhotometricDistortion`` (its rows ``photometric``) in the body8 and the
# halpe26 recipes' order
PHOTOMETRIC_DIGESTS = ("photometric", "photometric_after_hsv", "photometric_first")


def all_bgr_colours():
    """Every 8-bit BGR colour once, (65536, 256, 3) uint8: rows as wide as a
    multiple of cv2's vector lanes, which every pixel of a crop of width 192
    goes through."""
    import numpy as np

    c = np.arange(1 << 24, dtype=np.uint32)
    return np.stack([c & 255, (c >> 8) & 255, c >> 16], -1).astype(np.uint8).reshape(-1, 256, 3)


def all_hsv_triples(hues=range(180)):
    """Every 8-bit HSV triple with a hue in ``hues``, (-1, 256, 3) uint8
    (hue, then saturation, then value), 256 a row: a multiple of cv2's
    vector lanes."""
    import numpy as np

    h, s, v = np.meshgrid(np.asarray(hues), np.arange(256), np.arange(256), indexing="ij")
    return np.stack([h, s, v], -1).astype(np.uint8).reshape(-1, 256, 3)


def window_sum_tiles(k):
    """A grey (H, W, 3) uint8 image of k x k tiles, one for each window sum
    s = 0 .. 255 k² (its pixels ``s // k²``, one more on the first ``s %
    k²``), inside a border of empty tiles: a k x k blur at a tile's centre
    sums exactly that tile."""
    import numpy as np

    sums = np.arange(255 * k * k + 1)
    side = int(np.ceil(np.sqrt(len(sums))))
    tiles = np.zeros((side * side, k * k), np.uint8)
    tiles[: len(sums)] = sums[:, None] // (k * k) + (np.arange(k * k) < sums[:, None] % (k * k))
    img = tiles.reshape(side, side, k, k).transpose(0, 2, 1, 3).reshape(side * k, side * k)
    img = np.pad(img, k)
    return np.repeat(img[..., None], 3, axis=-1)


def augment_fixture_params(n, crops, seed=0):
    """``n`` samples' parameters over ``crops`` input crops: the input of
    each, HSV gains drawn as ``YOLOXHSVRandomAug`` draws them, the blur and
    median kernel sizes cycling through every pair of 0 (not fired), 3, 5
    and 7, and one CoarseDropout hole of the RTMPose recipe's sizes on two
    samples in three (zero size on the third). Returns a dict of arrays."""
    import numpy as np

    rng = np.random.RandomState(seed)
    i = np.arange(n)
    ks = np.array((0,) + AUGMENT_KSIZES, np.int32)
    gains = rng.uniform(-1, 1, (n, 3)) * [5, 30, 30] * rng.randint(0, 2, (n, 3))
    hh, ww = rng.randint(51, 103, n), rng.randint(38, 78, n)
    rects = np.stack([rng.randint(0, 257 - hh), rng.randint(0, 193 - ww), hh, ww], -1) * (i % 3 != 0)[:, None]
    return dict(index=i % crops, hsv_gains=gains.astype(np.int16), blur_ksize=ks[i % 4],
                median_ksize=ks[(i // 4) % 4], dropout_rects=rects.astype(np.int32)[:, None])


def photometric_fixture_params(n, seed=0):
    """``n`` rows of ``PhotometricDistortion``'s parameters drawn by the
    port's worker half (the body8 and halpe26 recipes' settings, its
    defaults) from NumPy's generator seeded with ``seed``; every 16th row's
    hue delta set to -1e-6, which turns hue 0 into 180 (NumPy's float32
    remainder). (n, 8) float32."""
    import numpy as np

    from probpose_code_torch.datasets.transforms.common import PhotometricDistortion

    state = np.random.get_state()
    np.random.seed(seed)
    distortion = PhotometricDistortion()
    rows = np.stack([distortion(dict(warp_mat=np.eye(2, 3)))["photometric"] for _ in range(n)])
    np.random.set_state(state)
    rows[::16, 3] = -1e-6
    return rows


def sha256(arr) -> bytes:
    import hashlib

    return hashlib.sha256(arr.tobytes()).digest()


def augment_fixture_report(device, limit=None):
    """``ops/kernels/photometric.py`` on ``device`` (the card's forms, or
    the plain versions on the CPU) against ``AUGMENT_FIXTURE``: the four ops
    of the RTMPose recipe in turn on its batch (its first ``limit``
    samples), each sample's result after each op against cv2's digest;
    ``PhotometricDistortion`` after the HSV jitter (the body8 recipes'
    order) and on the crops (the halpe26 recipes'); the HSV tables that the
    plain conversions fill on ``device`` (every colour and HSV triple, hue
    180 too), and the blur and median on the window-sum tiles for each
    kernel size, against cv2's digests. Returns a report with ``ok``."""
    import numpy as np
    import torch

    from probpose_code_torch.ops import photometric as plain
    from probpose_code_torch.ops.kernels import photometric

    fx = dict(np.load(AUGMENT_FIXTURE))
    for key in ("index", "digests", *AUGMENT_STAGES, *PHOTOMETRIC_DIGESTS):
        fx[key] = fx[key][:limit]

    def mismatched(img, digests):
        got = img.to(torch.uint8).cpu().numpy()
        return int(sum(sha256(got[j]) != digests[j].tobytes() for j in range(len(got))))

    crops = torch.from_numpy(fx["crops"][fx["index"]]).to(device).float()
    rows = torch.from_numpy(fx["photometric"]).to(device)
    img, stages = crops, {}
    for i, key in enumerate(AUGMENT_STAGES):
        img = photometric.augment(img, **{key: torch.from_numpy(fx[key]).to(device)})
        stages[key] = mismatched(img, fx["digests"][:, i])
        if key == "hsv_gains":  # the body8 recipes' order, the distortion after the HSV jitter
            stages["photometric_after_hsv"] = mismatched(photometric.augment(img, photometric=rows),
                                                         fx["photometric_after_hsv"])
    # the halpe26 recipes' order, the distortion first
    stages["photometric_first"] = mismatched(photometric.augment(crops, photometric=rows), fx["photometric_first"])

    def digest(tensor):
        return sha256(tensor.to(torch.uint8).cpu().numpy())

    def on_device(arr):
        return torch.from_numpy(arr).to(device)

    to_hsv, to_bgr = plain.hsv_tables(device)
    exhaustive = dict(bgr_to_hsv=digest(to_hsv) == fx["bgr_to_hsv"].tobytes(),
                      hsv_to_bgr=digest(to_bgr[:180 << 16]) == fx["hsv_to_bgr"].tobytes(),
                      hsv_to_bgr_180=digest(to_bgr[180 << 16:]) == fx["hsv_to_bgr_180"].tobytes())
    for k in AUGMENT_KSIZES:
        tiles = on_device(window_sum_tiles(k)).float()[None]
        exhaustive[f"blur_{k}"] = digest(plain.box_blur(tiles, k)[0]) == fx[f"blur_{k}"].tobytes()
        exhaustive[f"median_{k}"] = digest(photometric.median_blur(tiles, k)[0]) == fx[f"median_{k}"].tobytes()
    fired = {k: int((fx[k] > 0).sum()) for k in ("blur_ksize", "median_ksize")}
    return dict(samples=len(fx["index"]), fired=fired, mismatched=stages, exhaustive=exhaustive,
                ok=not any(stages.values()) and all(exhaustive.values()))


def write_png(path, img):
    """An (H, W, 3) uint8 BGR image as an 8-bit RGB PNG, every row with
    filter type 0 (the card's machine has no OpenCV to write one)."""
    import struct
    import zlib

    import numpy as np

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    h, w = img.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img[..., ::-1].reshape(h, w * 3)], axis=1)
    Path(path).write_bytes(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                          + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + chunk(b"IEND", b""))


def golden_png_set(root, full=False):
    """The golden fixture's 24 images as PNG files under ``root/imgs`` and a
    copy of its annotations as ``root/ann.json``, for the val path. Each
    image gets one zero column and row appended: the dataset clips a box to
    ``width - 1`` and ``height - 1`` (``base_dataset.py:parse_data_info``)
    and four of the fixture's 62 boxes end on the image's edge, while the
    fixture was made on the unclipped boxes; with the zero border (which
    cv2.warpAffine's constant border reads anyway) the val path sees the
    fixture's boxes and pixels. Returns (fixture arrays, annotation path)."""
    import numpy as np

    root = Path(root)
    (root / "imgs").mkdir(parents=True, exist_ok=True)
    data = np.load(GOLDEN / ("e2e_full_pipeline.npz" if full else "e2e_pipeline.npz"))
    gt = json.loads((GOLDEN / ("e2e_full_coco.json" if full else "e2e_coco.json")).read_text())
    for im in gt["images"]:
        img = np.pad(data[f"img_{im['id']}"], ((0, 1), (0, 1), (0, 0)))
        im["file_name"], im["height"], im["width"] = f"{im['id']}.png", img.shape[0], img.shape[1]
        write_png(root / "imgs" / im["file_name"], img)
    (root / "ann.json").write_text(json.dumps(gt))
    return data, root / "ann.json"


def golden_jpeg_set(root, full=False):
    """``golden_png_set`` with the committed JPEG copies of the same 24
    images (``tests/golden_torch/golden/<id>.jpg``: the zero column and row
    appended, 4:2:0 baseline at quality 95, made by ``cv2.imencode`` in
    ``tests/golden_torch/make_jpeg_fixtures.py``) copied under
    ``root/imgs``, COCO's format. Returns (fixture arrays, annotation path)."""
    import shutil

    import numpy as np

    root = Path(root)
    (root / "imgs").mkdir(parents=True, exist_ok=True)
    data = np.load(GOLDEN / ("e2e_full_pipeline.npz" if full else "e2e_pipeline.npz"))
    gt = json.loads((GOLDEN / ("e2e_full_coco.json" if full else "e2e_coco.json")).read_text())
    for im in gt["images"]:
        h, w = data[f"img_{im['id']}"].shape[:2]
        im["file_name"], im["height"], im["width"] = f"{im['id']}.jpg", h + 1, w + 1
        shutil.copy(GOLDEN_JPEG / "golden" / im["file_name"], root / "imgs" / im["file_name"])
    (root / "ann.json").write_text(json.dumps(gt))
    return data, root / "ann.json"


POSETRACK_VIDEOS = 3


def posetrack_set(root):
    """The golden fixture's 24 images as the frames of ``POSETRACK_VIDEOS``
    videos in PoseTrack18's layout under ``root``: ``images/val/<video>/
    <frame>.jpg`` (image i the frame i // 3 of video i % 3), the persons in
    ``annotations/posetrack18_val.json`` (COCO's 17 keypoints read as
    PoseTrack18's; every other person with a ``bbox_head``, the top of its
    box; the last image's persons with no annotated keypoint: a frame with
    no ground truth) and a detection of each person's box (score 1) in
    ``annotations/posetrack18_val_human_detections.json``. Returns the
    ``--cfg-options`` that point a PoseTrack18 config's test loader and
    evaluator at them."""
    root = Path(root)
    _, ann = golden_jpeg_set(root / "golden")
    gt = json.loads(ann.read_text())
    for i, im in enumerate(sorted(gt["images"], key=lambda im: im["id"])):
        video = f"{i % POSETRACK_VIDEOS:06d}_mpii_test"
        name = f"images/val/{video}/{i // POSETRACK_VIDEOS:06d}.jpg"
        (root / name).parent.mkdir(parents=True, exist_ok=True)
        (root / "golden" / "imgs" / im["file_name"]).rename(root / name)
        im.update(file_name=name, vid_id=i % POSETRACK_VIDEOS, frame_id=i // POSETRACK_VIDEOS)
    last = max(im["id"] for im in gt["images"])
    for j, a in enumerate(gt["annotations"]):
        x, y, w, h = a["bbox"]
        a["track_id"] = j
        if j % 2 == 0:
            a["bbox_head"] = [x + 0.3 * w, y, 0.4 * w, 0.15 * h]
        if a["image_id"] == last:
            a["keypoints"], a["num_keypoints"] = [0] * len(a["keypoints"]), 0
    (root / "annotations").mkdir(exist_ok=True)
    (root / "annotations/posetrack18_val.json").write_text(json.dumps(gt))
    dets = [dict(image_id=a["image_id"], category_id=1, bbox=a["bbox"], score=1.0) for a in gt["annotations"]]
    (root / "annotations/posetrack18_val_human_detections.json").write_text(json.dumps(dets))
    return [f"test_dataloader.dataset.data_root={root}/",
            f"test_dataloader.dataset.bbox_file={root}/annotations/posetrack18_val_human_detections.json",
            f"test_evaluator.ann_file={root}/annotations/posetrack18_val.json"]


VAL_PIPELINE = [
    dict(type="LoadImage"), dict(type="GetBBoxCenterScale"),
    dict(type="TopdownAffine", input_size=(192, 256), use_udp=True, input_padding=1.25), dict(type="PackPoseInputs"),
]
# the flagship's train pipeline (its config's ``train_pipeline``)
TRAIN_PIPELINE = [
    dict(type="LoadImage"), dict(type="GetBBoxCenterScale"), dict(type="RandomFlip", direction="horizontal"),
    dict(type="RandomHalfBody"), dict(type="RandomBBoxTransform"),
    dict(type="TopdownAffine", input_size=(192, 256), use_udp=True, input_padding=1.25),
    dict(type="GenerateTarget", encoder=dict(type="ProbMap", input_size=(192, 256), heatmap_size=(48, 64), sigma=-1)),
    dict(type="PackPoseInputs"),
]
# the flagship's CocoMetric settings (its config's val_evaluator)
COCO_METRIC = dict(type="CocoMetric", extended=[False, True], match_by_bbox=[False, False],
                   ignore_border_points=[False, False], padding=1.25, score_thresh_type="prob",
                   keypoint_score_thr=0.45)


def golden_val_cfg(model_cfg, ann_file, batch_size=64, num_workers=0):
    """A val config over a ``golden_png_set``: the flagship's val pipeline
    and CocoMetric, the fixture's annotations."""
    root = Path(ann_file).parent
    return dict(
        model=model_cfg,
        val_dataloader=dict(batch_size=batch_size, num_workers=num_workers, dataset=dict(
            type="CocoDataset", data_root=str(root), ann_file=Path(ann_file).name, data_prefix=dict(img="imgs/"),
            test_mode=True, pipeline=VAL_PIPELINE)),
        val_evaluator=dict(COCO_METRIC, ann_file=str(ann_file)),
    )


def copy_instances(ann_file, n, out_file):
    """The annotations of ``ann_file`` copied round-robin to ``n``
    instances (each copy of an image under a new image id, the files
    shared), written to ``out_file``."""
    import copy

    gt = json.loads(Path(ann_file).read_text())
    anns, images = gt["annotations"], {im["id"]: im for im in gt["images"]}
    gt["images"], gt["annotations"], seen = [], [], set()
    for k in range(n):
        a = copy.deepcopy(anns[k % len(anns)])
        image_id = 1000 * (k // len(anns)) + a["image_id"]
        if image_id not in seen:
            seen.add(image_id)
            gt["images"].append(dict(images[a["image_id"]], id=image_id))
        a.update(id=k + 1, image_id=image_id)
        gt["annotations"].append(a)
    Path(out_file).write_text(json.dumps(gt))


def flagship_data_options(root, train_json=None):
    """``--cfg-options`` items that point the flagship config's val sets
    (CropCOCO and COCO, both ``root/val.json``) and, given ``train_json``,
    its train set at a ``golden_png_set`` under ``root``."""
    options = []
    for i in range(2):
        options += [f"val_dataloader.dataset.datasets.{i}.data_root={root}",
                    f"val_dataloader.dataset.datasets.{i}.ann_file=val.json",
                    f"val_dataloader.dataset.datasets.{i}.data_prefix.img=imgs/",
                    f"val_evaluator.metrics.{i}.ann_file={Path(root) / 'val.json'}"]
    if train_json:
        options += [f"train_dataloader.dataset.data_root={root}", f"train_dataloader.dataset.ann_file={train_json}",
                    "train_dataloader.dataset.data_prefix.img=imgs/"]
    return options


def mini_coco_set(root):
    """A small COCO-style person set made from seed 0, for training on the
    CPU: 6 smooth PNG images of about 160-220 x 140-200 pixels under
    ``root/imgs``, 2 persons each with a box and 17
    keypoints (some outside the box or the image, some unannotated; COCO's
    v = 0 / 1 / 2), in ``root/ann.json``. Returns the annotation path."""
    import numpy as np

    rng = np.random.RandomState(0)
    root = Path(root)
    (root / "imgs").mkdir(parents=True, exist_ok=True)
    gt = dict(images=[], annotations=[], categories=[dict(id=1, name="person", keypoints=[str(k) for k in range(17)],
                                                          skeleton=[])])
    for i in range(1, 7):
        w, h = int(rng.randint(160, 221)), int(rng.randint(140, 201))
        yy, xx = np.mgrid[:h, :w].astype(np.float64)
        img = 127.5 + 60 * np.sin(xx[..., None] / rng.uniform(6, 14, 3) + yy[..., None] / rng.uniform(8, 16, 3))
        img = np.clip(img + rng.uniform(-20, 20, (h, w, 3)) + 30 * np.cos(yy / 23)[..., None], 0, 255).astype(np.uint8)
        write_png(root / "imgs" / f"{i}.png", img)
        gt["images"].append(dict(id=i, file_name=f"{i}.png", width=w, height=h))
        for _ in range(2):
            x0, y0 = rng.uniform(2, w * 0.45), rng.uniform(2, h * 0.35)
            bw, bh = rng.uniform(w * 0.25, w * 0.5), rng.uniform(h * 0.35, h * 0.6)
            kx = rng.uniform(x0 - 0.1 * bw, x0 + 1.15 * bw, 17)
            ky = rng.uniform(y0 - 0.1 * bh, y0 + 1.3 * bh, 17)
            v = rng.choice([0, 1, 2], 17, p=[0.15, 0.25, 0.6])
            kpts = np.stack([np.where(v > 0, kx, 0), np.where(v > 0, ky, 0), v], axis=1)
            gt["annotations"].append(dict(
                id=len(gt["annotations"]) + 1, image_id=i, category_id=1, keypoints=kpts.reshape(-1).tolist(),
                num_keypoints=int((v > 0).sum()), bbox=[x0, y0, bw, bh], area=bw * bh, iscrowd=0))
    (root / "ann.json").write_text(json.dumps(gt))
    return root / "ann.json"


# the RTMPose AIC+COCO recipe's KeypointConverter: (AIC keypoint, COCO keypoint)
AIC_TO_COCO = ((0, 6), (1, 8), (2, 10), (3, 5), (4, 7), (5, 9), (6, 12), (7, 14), (8, 16), (9, 11), (10, 13),
               (11, 15))


def aic_from_coco(ann_file, out_file):
    """A COCO keypoint annotation file mapped back to AI Challenger's 14
    keypoints (``AIC_TO_COCO``; head top and neck, which COCO lacks,
    unannotated), written to ``out_file``: the AIC half of the AIC+COCO
    recipe over the same images."""
    body_set_from_coco(ann_file, out_file, "AicDataset", AIC_TO_COCO)


def body_set_from_coco(ann_file, out_file, dataset_type, mapping=None):
    """A COCO keypoint annotation file in the layout of the body dataset
    ``dataset_type`` (``datasets/base_dataset.py:BODY_DATASETS``: its
    metainfo's keypoints), written to ``out_file``: the inverse of a
    recipe's ``KeypointConverter`` ``mapping`` of (dataset keypoint, target
    keypoint) pairs, whose targets below 17 are COCO's (body8's COCO layout,
    halpe26's first 17); each dataset keypoint takes the COCO keypoint its
    target is, the rest unannotated. No mapping: COCO's 17 as they are.
    CrowdPose's images get a ``crowdIndex`` (0 to 0.95)."""
    from probpose_code_torch.datasets.base_dataset import BODY_DATASETS
    from probpose_code_torch.datasets.metainfo import DATASET_METAINFO

    num = len(DATASET_METAINFO[BODY_DATASETS[dataset_type]]["keypoint_info"])
    gt = json.loads(Path(ann_file).read_text())
    for a in gt["annotations"]:
        coco = [a["keypoints"][3 * k:3 * k + 3] for k in range(17)]
        kpts = [[0, 0, 0] for _ in range(num)]
        for s, t in mapping if mapping is not None else zip(range(17), range(17)):
            if t < 17:
                kpts[s] = coco[t]
        a["keypoints"] = [v for kpt in kpts for v in kpt]
        a["num_keypoints"] = sum(kpt[2] > 0 for kpt in kpts)
    if dataset_type == "CrowdPoseDataset":
        for k, im in enumerate(gt["images"]):
            im["crowdIndex"] = round(0.05 * (k % 20), 2)
    gt["categories"] = [dict(id=1, name="person", keypoints=[str(k) for k in range(num)], skeleton=[])]
    Path(out_file).write_text(json.dumps(gt))


# COCO-WholeBody's parts after the body, with their keypoint counts
WHOLEBODY_EXTRA_PARTS = (("foot_kpts", 6), ("face_kpts", 68), ("lefthand_kpts", 21), ("righthand_kpts", 21))
# the seed of the parts' draws, and the share of the parts left unannotated
WHOLEBODY_SEED = 0
WHOLEBODY_MISSING = 0.2


def wholebody_set_from_coco(ann_file, out_file):
    """A COCO keypoint annotation file in COCO-WholeBody's layout, written
    to ``out_file``: each annotation's 17 body keypoints as they are, and
    its 6 foot, 68 face and 2 x 21 hand keypoints drawn inside its box from
    NumPy's generator seeded with ``WHOLEBODY_SEED``, all visible (v = 2),
    as the JAX package's ``tests/test_evaluation/test_wholebody_metric.py``
    draws them; each of these four parts is left unannotated (all zeros,
    mmpose's ``<part>_valid`` false) with probability ``WHOLEBODY_MISSING``,
    as COCO-WholeBody leaves the hands and faces it cannot see."""
    import numpy as np

    rng = np.random.RandomState(WHOLEBODY_SEED)
    gt = json.loads(Path(ann_file).read_text())
    for a in gt["annotations"]:
        x0, y0, w, h = a["bbox"]
        for field, n in WHOLEBODY_EXTRA_PARTS:
            kpts = np.stack([x0 + rng.rand(n) * w, y0 + rng.rand(n) * h, np.full(n, 2.0)], axis=-1)
            valid = rng.rand() >= WHOLEBODY_MISSING
            a[field] = (kpts if valid else np.zeros((n, 3))).reshape(-1).tolist()
            a[field.replace("_kpts", "_valid")] = bool(valid)
    gt["categories"] = [dict(id=1, name="person", keypoints=[str(k) for k in range(133)], skeleton=[])]
    Path(out_file).write_text(json.dumps(gt))


# the face and hand datasets whose file layouts ``face_hand_sets_from_coco`` writes: the plain ones (a COCO-style
# annotation a face or a hand, its ``bbox`` the part's box) with their keypoint counts, then COCO-WholeBody's and
# Halpe's whole-person layouts, which hold a person's face and both hands
FACE_SETS = dict(WFLWDataset=98, Face300WDataset=68, Face300WLPDataset=68, COFWDataset=29, AFLWDataset=19,
                 LapaDataset=106)
HAND_SETS = dict(OneHand10KDataset=21, FreiHandDataset=21, Rhd2DDataset=21, PanopticHand2DDataset=21)
PERSON_SETS = ("CocoWholeBodyFaceDataset", "CocoWholeBodyHandDataset", "HalpeDataset", "HalpeHandDataset")
# the seed of the boxes' and keypoints' draws and the share of COCO-WholeBody's faces and hands left
# invalid (``<part>_valid`` false, all zeros)
FACE_HAND_SEED = 0
FACE_HAND_MISSING = 0.2
# the share of drawn keypoints left unannotated (``draw_keypoints``)
UNANNOTATED = 0.05


def draw_keypoints(rng, box, num):
    """``num`` keypoints drawn uniformly inside ``box`` (x, y, w, h) from
    ``rng``, v = 2 but an ``UNANNOTATED`` share left unannotated (v = 0, at
    0, 0), as the flat COCO list [x, y, v, ...]."""
    import numpy as np

    x, y, w, h = box
    kpts = np.stack([x + rng.rand(num) * w, y + rng.rand(num) * h, np.full(num, 2.0)], axis=-1)
    kpts[rng.rand(num) < UNANNOTATED] = 0.0
    return kpts.reshape(-1).tolist()


def face_hand_parts(ann_file):
    """A face box and two hand boxes (x, y, w, h) drawn inside each person
    box of ``ann_file`` from ``FACE_HAND_SEED``: the face a square of 0.3 to
    0.5 of the box's shorter side in its top 40%, each hand a square of 0.15
    to 0.3 of it anywhere in the box. Returns {annotation id: dict(face=,
    left=, right=)}."""
    import numpy as np

    rng = np.random.RandomState(FACE_HAND_SEED)
    parts = {}
    for a in json.loads(Path(ann_file).read_text())["annotations"]:
        x0, y0, w, h = a["bbox"]
        side = min(w, h)
        f = side * rng.uniform(0.3, 0.5)
        face = [x0 + rng.uniform(0, w - f), y0 + rng.uniform(0, max(0.4 * h - f, 0)), f, f]
        hands = []
        for _ in range(2):
            s = side * rng.uniform(0.15, 0.3)
            hands.append([x0 + rng.uniform(0, w - s), y0 + rng.uniform(0, h - s), s, s])
        parts[a["id"]] = dict(face=face, left=hands[0], right=hands[1])
    return parts


def face_hand_sets_from_coco(ann_file, root, kinds=None, prefix=""):
    """The persons of a COCO keypoint file (``tests/golden/e2e_coco.json``,
    say) in the layouts of the face and hand datasets (``kinds``, by default
    all of ``FACE_SETS``, ``HAND_SETS`` and ``PERSON_SETS``), written to
    ``root/<kind>.json``: each person's face and hands (``face_hand_parts``)
    with the dataset's keypoints drawn inside the part's box
    (``draw_keypoints``).
    A face set gets an annotation a person (WFLW, 300W and AFLW also
    mmpose's ``center`` and ``scale``, the box's centre and 1.25 times its
    longer side over 200, and AFLW its ``box_size``), a hand set one a hand
    (Panoptic also a ``head_size``); COCO-WholeBody's faces and hands are the
    persons' ``face_box`` / ``face_kpts`` / ``face_valid`` and
    ``<side>hand_*`` fields (each invalid with probability
    ``FACE_HAND_MISSING``), Halpe's 136 keypoints the body's 17, 9
    unannotated, then 68 of the face and 21 of each hand. The files are
    ``root/<prefix><kind>.json``. Returns {kind: file name}."""
    import copy

    import numpy as np

    gt = json.loads(Path(ann_file).read_text())
    parts = face_hand_parts(ann_file)
    kinds = list(kinds or [*FACE_SETS, *HAND_SETS, *PERSON_SETS])
    written = {}
    for n, kind in enumerate(kinds):
        rng = np.random.RandomState(FACE_HAND_SEED + 1 + n)
        draw = functools.partial(draw_keypoints, rng)
        out = dict(copy.deepcopy(gt), annotations=[])
        for a in gt["annotations"]:
            part = parts[a["id"]]
            if kind in FACE_SETS or kind in HAND_SETS:
                boxes = [part["face"]] if kind in FACE_SETS else [part["left"], part["right"]]
                num = FACE_SETS.get(kind) or HAND_SETS[kind]
                for k, box in enumerate(boxes):
                    kpts = draw(box, num)
                    ann = dict(id=len(boxes) * a["id"] + k, image_id=a["image_id"], category_id=1, bbox=box,
                               keypoints=kpts, num_keypoints=int(np.count_nonzero(kpts[2::3])),
                               area=box[2] * box[3], iscrowd=0)
                    if kind in ("WFLWDataset", "Face300WDataset", "AFLWDataset"):
                        ann.update(center=[box[0] + box[2] / 2, box[1] + box[3] / 2],
                                   scale=1.25 * max(box[2:]) / 200)
                    if kind == "AFLWDataset":
                        ann["box_size"] = max(box[2:])
                    if kind == "PanopticHand2DDataset":
                        ann["head_size"] = 0.7 * max(box[2:])
                    out["annotations"].append(ann)
                continue
            ann = copy.deepcopy(a)
            if kind.startswith("CocoWholeBody"):
                for field, num in (("face", 68), ("lefthand", 21), ("righthand", 21)):
                    valid = rng.rand() >= FACE_HAND_MISSING
                    box = part["face" if field == "face" else field.removesuffix("hand")]
                    ann[f"{field}_box"] = box if valid else [0.0] * 4
                    ann[f"{field}_kpts"] = draw(box, num) if valid else [0.0] * 3 * num
                    ann[f"{field}_valid"] = bool(valid)
                ann["foot_kpts"], ann["foot_valid"] = [0.0] * 18, False
            else:  # Halpe
                ann["keypoints"] = (a["keypoints"] + [0.0] * 27 + draw(part["face"], 68) + draw(part["left"], 21)
                                    + draw(part["right"], 21))
            out["annotations"].append(ann)
        num = FACE_SETS.get(kind) or HAND_SETS.get(kind) or (136 if kind.startswith("Halpe") else 17)
        out["categories"] = [dict(id=1, name="person", keypoints=[str(k) for k in range(num)], skeleton=[])]
        Path(root, f"{prefix}{kind}.json").write_text(json.dumps(out))
        written[kind] = f"{prefix}{kind}.json"
    return written


def face_hand_options(cfg, loader, root, ann_file):
    """``--cfg-options`` items that point ``cfg[loader]``'s dataset (each
    sub-dataset of a ``CombinedDataset``) at its layout of ``ann_file``'s
    persons (``face_hand_sets_from_coco``: ``root/<loader>_<kind>.json``),
    the images in ``root/imgs``."""
    dataset = cfg[loader]["dataset"]
    subs = list(enumerate(dataset["datasets"])) if dataset["type"] == "CombinedDataset" else [(None, dataset)]
    files = face_hand_sets_from_coco(ann_file, root, sorted({d["type"] for _, d in subs}), prefix=f"{loader}_")
    options = []
    for i, d in subs:
        key = f"{loader}.dataset" if i is None else f"{loader}.dataset.datasets.{i}"
        options += [f"{key}.data_root={root}", f"{key}.ann_file={files[d['type']]}", f"{key}.data_prefix.img=imgs/"]
    return options


# the seed of the animal and fashion sets' keypoint draws
ANIMAL_FASHION_SEED = 0


def animal_fashion_set_from_coco(ann_file, out_file, num_keypoints):
    """The persons of a COCO keypoint file (``tests/golden/e2e_coco.json``,
    say) as the instances of an animal, fashion or ExLPose dataset of
    ``num_keypoints`` (the COCO-style layout each reads), written to
    ``out_file``: each keeps its image, id, box, area and crowd flag, and
    its keypoints are drawn inside its box from ``ANIMAL_FASHION_SEED``
    (``draw_keypoints``)."""
    import copy

    import numpy as np

    gt = json.loads(Path(ann_file).read_text())
    rng = np.random.RandomState(ANIMAL_FASHION_SEED)
    out = dict(copy.deepcopy(gt), annotations=[])
    for a in gt["annotations"]:
        kpts = draw_keypoints(rng, a["bbox"], num_keypoints)
        out["annotations"].append(dict(a, keypoints=kpts, num_keypoints=int(np.count_nonzero(kpts[2::3]))))
    out["categories"] = [dict(id=1, name="person", keypoints=[str(k) for k in range(num_keypoints)], skeleton=[])]
    Path(out_file).write_text(json.dumps(out))


def animal_fashion_options(cfg, loader, root, ann_file):
    """``--cfg-options`` items that point ``cfg[loader]``'s dataset at
    ``ann_file``'s persons in its layout (``animal_fashion_set_from_coco``
    at its table's keypoint count: ``root/<loader>.json``), the images in
    ``root/imgs``, no detector boxes, and a ``CocoMetric`` evaluator of the
    loader at the same file."""
    from probpose_code_torch.datasets import config_metainfo
    from probpose_code_torch.datasets.metainfo import parse_pose_metainfo

    dataset = cfg[loader]["dataset"]
    num = parse_pose_metainfo(config_metainfo(dataset))["num_keypoints"]
    animal_fashion_set_from_coco(ann_file, Path(root, f"{loader}.json"), num)
    key = f"{loader}.dataset"
    options = [f"{key}.data_root={root}", f"{key}.ann_file={loader}.json", f"{key}.data_prefix.img=imgs/"]
    if "bbox_file" in dataset:
        options.append(f"{key}.bbox_file=None")
    evaluator = loader.replace("dataloader", "evaluator")
    if isinstance(cfg.get(evaluator), dict) and cfg[evaluator].get("type") == "CocoMetric":
        options.append(f"{evaluator}.ann_file={Path(root, f'{loader}.json')}")
    return options


def recipe_sets(cfg, loader, root, ann_file):
    """The sub-datasets of ``cfg[loader]``'s ``CombinedDataset`` over the
    images under ``root``: ``ann_file`` (COCO's layout) written in each
    one's layout through the inverse of its pipeline's ``KeypointConverter``
    (``body_set_from_coco``; a ``CocoWholeBodyDataset``'s by
    ``wholebody_set_from_coco``) as ``root/<loader>_<i>.json``. Returns the
    ``--cfg-options`` items that point each sub-dataset at its file."""
    options = []
    for i, d in enumerate(cfg[loader]["dataset"]["datasets"]):
        mapping = next((t["mapping"] for t in d.get("pipeline", []) if t["type"] == "KeypointConverter"), None)
        name = f"{loader}_{i}.json"
        if d["type"] == "CocoWholeBodyDataset":
            wholebody_set_from_coco(ann_file, Path(root) / name)
        else:
            body_set_from_coco(ann_file, Path(root) / name, d["type"], mapping)
        options += [f"{loader}.dataset.datasets.{i}.{key}" for key in (f"data_root={root}", f"ann_file={name}",
                                                                      "data_prefix.img=imgs/")]
    return options


def halpe26_repair_options(cfg, loaders=("train_dataloader", "val_dataloader")):
    """``--cfg-options`` items that give the halpe26 recipes' sub-datasets
    mmpose's datasets and converters where the shipped configs' differ from
    them: COCO becomes a ``CocoWholeBodyDataset`` (the configs name
    ``CocoDataset`` on COCO's 17-keypoint file, and their 23-pair mapping
    reads COCO-WholeBody's six foot keypoints, 17-22), Halpe gets
    ``halpe_halpe26`` (the first 26 of its 136 keypoints; the configs give
    it ``pipeline=[]``), and OCHuman, whose val entry reuses COCO's 23-pair
    pipeline on a file without feet, its 17 body keypoints. Without them
    the port refuses the recipe's samples by name."""
    options = []
    for loader in loaders:
        for i, d in enumerate(cfg[loader]["dataset"]["datasets"]):
            if d["type"] in ("CocoDataset", "CocoWholeBodyDataset"):  # the latter: a repaired config
                options.append(f"{loader}.dataset.datasets.{i}.type=CocoWholeBodyDataset")
                continue
            if d["type"] == "HalpeDataset":
                mapping = [(k, k) for k in range(26)]
            elif d["type"] == "OCHumanDataset":
                mapping = [(k, k) for k in range(17)]
            else:
                continue
            converter = [dict(type="KeypointConverter", num_keypoints=26, mapping=mapping)]
            options.append(f"{loader}.dataset.datasets.{i}.pipeline={converter!r}")
    return options


def ubody_sets(cfg, root, ann_file, loader="train_dataloader"):
    """The UBody recipe's train mix (``rtmpose-m_8xb64-270e_coco-ubody-
    wholebody``: a ``CocoWholeBodyDataset`` and 15 ``UBody2dDataset``
    scenes) over the images under ``root``: ``ann_file`` (COCO's layout)
    in COCO-WholeBody's layout (``wholebody_set_from_coco``) for COCO, and
    for scene ``s`` the same with each image ``i`` under the id ``10 i``
    where ``i % 4 == s % 4`` and ``10 i + 1`` elsewhere, so that the
    scenes' ``sample_interval=10`` keeps a quarter of the images, a
    different quarter in turn. Returns the ``--cfg-options`` items that
    point each sub-dataset at its file and the number of instances the mix
    keeps."""
    root = Path(root)
    wholebody_set_from_coco(ann_file, root / f"{loader}_0.json")
    base = json.loads((root / f"{loader}_0.json").read_text())
    options, kept = [], len(base["annotations"])
    for i, d in enumerate(cfg[loader]["dataset"]["datasets"]):
        if d["type"] == "UBody2dDataset":
            scene = json.loads(json.dumps(base))
            new_id = {im["id"]: 10 * im["id"] + (0 if im["id"] % 4 == i % 4 else 1) for im in scene["images"]}
            for im in scene["images"]:
                im["id"] = new_id[im["id"]]
            for a in scene["annotations"]:
                a["image_id"] = new_id[a["image_id"]]
            kept += sum(a["image_id"] % d["sample_interval"] == 0 for a in scene["annotations"])
            (root / f"{loader}_{i}.json").write_text(json.dumps(scene))
        options += [f"{loader}.dataset.datasets.{i}.{key}" for key in (
            f"data_root={root}", f"ann_file={loader}_{i}.json", "data_prefix.img=imgs/")]
    return options, kept


def interhand_set_from_coco(ann_file, out_file, seed=FACE_HAND_SEED):
    """The persons of a COCO keypoint file as InterHand2.6M's instances, in
    the JAX ``InterHand2DDoubleDataset``'s COCO-style layout, written to
    ``out_file``: each instance a pair of hands (``face_hand_parts``' two
    boxes), its box their union, its 42 keypoints the right hand's 21 then
    the left's (the order the cocktail14 recipe's ``KeypointConverter``
    reads), drawn inside each hand's box (``draw_keypoints``); each image id
    a multiple of 10 (the recipe's ``sample_interval=10`` keeps them all)."""
    import copy

    import numpy as np

    gt = json.loads(Path(ann_file).read_text())
    parts = face_hand_parts(ann_file)
    rng = np.random.RandomState(seed + 100)
    out = dict(copy.deepcopy(gt), annotations=[])
    for im in out["images"]:
        im["id"] = 10 * im["id"]
    for a in gt["annotations"]:
        right, left = parts[a["id"]]["right"], parts[a["id"]]["left"]
        x0, y0 = min(right[0], left[0]), min(right[1], left[1])
        x1, y1 = max(right[0] + right[2], left[0] + left[2]), max(right[1] + right[3], left[1] + left[3])
        kpts = draw_keypoints(rng, right, 21) + draw_keypoints(rng, left, 21)
        out["annotations"].append(dict(id=a["id"], image_id=10 * a["image_id"], category_id=1,
                                       bbox=[x0, y0, x1 - x0, y1 - y0], area=(x1 - x0) * (y1 - y0), iscrowd=0,
                                       keypoints=kpts, num_keypoints=int(np.count_nonzero(kpts[2::3]))))
    out["categories"] = [dict(id=1, name="hand", keypoints=[str(k) for k in range(42)], skeleton=[])]
    Path(out_file).write_text(json.dumps(out))


def cocktail14_sets(cfg, root, ann_file, loader="train_dataloader"):
    """The RTMW recipe's cocktail14 mix (``configs/wholebody_2d_keypoint/
    rtmpose/cocktail14/``: four ``CombinedDataset``s of 14 datasets, the
    UBody scenes a fifth inside the first) over the images under ``root``:
    ``ann_file`` (COCO's layout) in each leaf dataset's layout, as
    ``root/<its config key>.json``: COCO-WholeBody's
    (``wholebody_set_from_coco``), each UBody scene's as ``ubody_sets``
    writes them (image ids such that its ``sample_interval`` keeps a
    quarter, a different one in turn), Halpe's and the faces'
    (``face_hand_sets_from_coco``), InterHand2.6M's (``interhand_set_from_coco``)
    and the body sets' through the inverse of their ``KeypointConverter``
    (``body_set_from_coco``; Human-Art-21's fingers and toes unannotated).
    Returns the ``--cfg-options`` items that point each leaf at its file."""
    root = Path(root)
    wholebody = root / f"{loader}_wholebody.json"
    wholebody_set_from_coco(ann_file, wholebody)
    options, scenes = [], []

    def walk(d, key):
        if d["type"] == "CombinedDataset":
            for i, sub in enumerate(d["datasets"]):
                walk(sub, f"{key}.datasets.{i}")
            return
        name = key.replace(".", "_") + ".json"
        kind = d["type"]
        if kind == "CocoWholeBodyDataset":
            Path(root, name).write_text(wholebody.read_text())
        elif kind == "UBody2dDataset":
            scene = json.loads(wholebody.read_text())
            new_id = {im["id"]: 10 * im["id"] + (0 if im["id"] % 4 == len(scenes) % 4 else 1)
                      for im in scene["images"]}
            for im in scene["images"]:
                im["id"] = new_id[im["id"]]
            for a in scene["annotations"]:
                a["image_id"] = new_id[a["image_id"]]
            scenes.append(name)
            Path(root, name).write_text(json.dumps(scene))
        elif kind in FACE_SETS or kind in PERSON_SETS:
            written = face_hand_sets_from_coco(ann_file, root, [kind], prefix=f"{loader}_sets_")
            Path(root, written[kind]).rename(root / name)
        elif kind == "InterHand2DDoubleDataset":
            interhand_set_from_coco(ann_file, root / name)
        else:
            mapping = next((t["mapping"] for t in d.get("pipeline", []) if t["type"] == "KeypointConverter"), None)
            body_set_from_coco(ann_file, root / name, kind, [(s, t) for s, t in mapping if t < 17])
        options.extend(f"{key}.{item}" for item in (f"data_root={root}", f"ann_file={name}", "data_prefix.img=imgs/"))

    walk(cfg[loader]["dataset"], f"{loader}.dataset")
    return options


def tiny_train_cfg(ann_file, batch_size, num_workers=0, approximate_gelu=False):
    """A train config over a ``mini_coco_set``: the tiny model at f32 with
    the flagship head's losses and drop_path 0, the flagship's train
    pipeline, optimizer and schedules (layer decay over 2 layers), the
    val pipeline and CocoMetric over the same set, a checkpoint and a
    validation every epoch with the best by ``coco/AP``, a log line every
    step, and one device for the JAX package's mesh."""
    import copy

    root = Path(ann_file).parent
    flagship = json.loads(json.dumps(_flagship_train_parts()))
    model = copy.deepcopy(TINY_CFG["model"])
    model["backbone"]["drop_path_rate"] = 0.0
    if approximate_gelu:
        model["backbone"]["approximate_gelu"] = True
    model["head"].update(flagship["head_losses"])
    dataset = dict(type="CocoDataset", data_root=str(root), ann_file=Path(ann_file).name,
                   data_prefix=dict(img="imgs/"))
    flagship["optim_wrapper"]["paramwise_cfg"]["num_layers"] = 2
    return dict(
        model=model,
        train_dataloader=dict(batch_size=batch_size, num_workers=num_workers,
                              sampler=dict(type="DefaultSampler", shuffle=True),
                              dataset=dict(dataset, test_mode=False, pipeline=TRAIN_PIPELINE)),
        val_dataloader=dict(batch_size=16, num_workers=0, dataset=dict(dataset, test_mode=True, pipeline=VAL_PIPELINE)),
        val_evaluator=dict(COCO_METRIC, ann_file=str(ann_file)),
        optim_wrapper=flagship["optim_wrapper"], param_scheduler=flagship["param_scheduler"],
        train_cfg=dict(max_epochs=2, val_interval=1),
        default_hooks=dict(checkpoint=dict(interval=1, save_best="coco/AP", rule="greater"), logger=dict(interval=1)),
        custom_hooks=[dict(type="SyncBuffersHook")],
        visualizer=dict(vis_backends=[dict(type="LocalVisBackend")]),
        env_cfg=dict(mesh=dict(data=1, model=1)),
    )


def _flagship_train_parts():
    """The flagship config's head losses, optimizer and schedules."""
    from probpose_code_torch.config import Config

    cfg = Config.fromfile(FLAGSHIP)
    keys = ("keypoint_loss", "probability_loss", "visibility_loss", "oks_loss", "error_loss", "detach_probability",
            "detach_visibility", "freeze_error", "freeze_oks")
    return dict(head_losses={k: cfg["model"]["head"][k] for k in keys}, optim_wrapper=cfg["optim_wrapper"],
                param_scheduler=cfg["param_scheduler"])


class KeepSamples:
    """An evaluator that keeps every sample it is given, then scores them
    with ``inner``."""

    def __init__(self, inner):
        self.inner, self.samples = inner, []

    def process(self, data_samples, data_batch=None):
        self.samples.extend(data_samples)
        self.inner.process(data_samples)

    def evaluate(self, size=None):
        return self.inner.evaluate(size)


def kernel_counters():
    """Each kernel wrapper, whose ``launches`` counts its kernel's launches."""
    from probpose_code_torch.ops.kernels.attention import attention_kernel
    from probpose_code_torch.ops.kernels.expected_oks import expected_oks_decode, oks_convolve
    from probpose_code_torch.ops.kernels.vit_layer import vit_layer_prepared
    from probpose_code_torch.ops.kernels.vit_layer_train import vit_layer_train_backward, vit_layer_train_forward

    return dict(vit_layer=vit_layer_prepared, expected_oks=expected_oks_decode, oks_convolve=oks_convolve,
                vit_layer_train_fwd=vit_layer_train_forward, vit_layer_train_bwd=vit_layer_train_backward,
                attention=attention_kernel)


# the kernels line's records of K1, by the instance (compute type, width)
# that a model's backbone runs
K1_RECORDS = {("torch.bfloat16", 384): "vit_layer", ("torch.float32", 768): "vit_layer_vitb_f32",
              ("torch.float32", 384): "vit_layer_vits_f32", ("torch.float32", 1024): "vit_layer_vitl_f32",
              ("torch.float32", 1280): "vit_layer_vith_f32"}
# and of K4, by the width of the f32 backbone whose training runs it
K4_RECORDS = {768: "attention", 1024: "attention_vitl", 1280: "attention_vith"}


# ViTPose-L's and -H's predict and train paths run their first layers only
# (of 24 and 32): the script's time limit. K1 and K4 at their full layer
# shapes are held by ``vit_large_parity`` and timed by ``timings``.
VIT_LARGE_DEPTH = 8


def vit_config(config, layers):
    """A ViTPose config file with its backbone cut to its first ``layers``
    layers (its layer decay over them): the config as it is where it has
    no more."""
    from probpose_code_torch.config import Config
    from probpose_code_torch.models.backbones.vit import VIT_ARCH_ZOO

    cfg = Config.fromfile(str(config))
    arch = cfg["model"]["backbone"]["arch"]
    arch = dict(VIT_ARCH_ZOO[arch] if isinstance(arch, str) else arch)
    if layers < arch["num_layers"]:
        cfg.merge_from_dict({"model.backbone.arch": dict(arch, num_layers=layers)})
        if "num_layers" in (cfg["optim_wrapper"].get("paramwise_cfg") or {}):
            cfg.merge_from_dict({"optim_wrapper.paramwise_cfg.num_layers": layers})
    return cfg


def k1_record(model) -> str:
    """The kernels line's record of the K1 instance that ``model`` runs."""
    backbone = model.module.backbone
    key = (str(backbone.dtype), backbone.embed_dims)
    if key not in K1_RECORDS:
        raise AssertionError(f"no K1 record in the kernels line for the instance {key}")
    return K1_RECORDS[key]


def k4_record(model) -> str:
    """The kernels line's record of the K4 instance that ``model``'s training
    runs."""
    backbone = model.module.backbone
    if str(backbone.dtype) != "torch.float32" or backbone.embed_dims not in K4_RECORDS:
        raise AssertionError(f"no K4 record in the kernels line for ({backbone.dtype}, {backbone.embed_dims})")
    return K4_RECORDS[backbone.embed_dims]


def augment_counters():
    """The photometric kernels' wrappers (no TPU kernel: their own line),
    whose ``launches`` count their kernels' launches."""
    from probpose_code_torch.ops.kernels import photometric

    return dict(photometric_median=photometric.median_blur, photometric_distortion=photometric.photometric_distortion)


def gau_counters():
    """The GAU kernels' wrappers (no TPU kernel: their own line), whose
    ``launches`` count their kernels' launches."""
    from probpose_code_torch.ops.kernels import gau

    return dict(gau_forward=gau.gau_forward, gau_backward=gau.gau_backward)


def face_hand_counters():
    """The face and hand recipes' kernels' wrappers (no TPU kernel: their
    own line), whose ``launches`` count their kernels' launches."""
    from probpose_code_torch.ops.kernels import adaptive_wing, depthwise

    return dict(depthwise_forward=depthwise.depthwise_forward, depthwise_backward=depthwise.depthwise_backward,
                adaptive_wing_forward=adaptive_wing.adaptive_wing_forward,
                adaptive_wing_backward=adaptive_wing.adaptive_wing_backward)


def cnn_zoo_counters():
    """The CNN backbones' kernels' wrappers (no TPU kernel: their own line),
    whose ``launches`` count their kernels' launches."""
    from probpose_code_torch.ops.kernels import sc_gate, se_layer, split_attention

    return dict(sc_gate_forward=sc_gate.sc_gate_forward, sc_gate_backward=sc_gate.sc_gate_backward,
                se_layer_forward=se_layer.se_layer_forward, se_layer_backward=se_layer.se_layer_backward,
                split_attention_forward=split_attention.split_attention_forward,
                split_attention_backward=split_attention.split_attention_backward)


def norm_counters():
    """The normalisation kernels' wrappers (no TPU kernel: their own line),
    whose ``launches`` count their calls: BatchNorm in training mode (every
    model's ``BatchNorm2d``) and the transformer backbones' LayerNorm."""
    from probpose_code_torch.ops.kernels import batch_norm, layer_norm

    return dict(batch_norm_forward=batch_norm.batch_norm_forward, batch_norm_backward=batch_norm.batch_norm_backward,
                layer_norm_forward=layer_norm.layer_norm_forward, layer_norm_backward=layer_norm.layer_norm_backward)


def realnvp_counters():
    """The RealNVP flow kernels' wrappers (no TPU kernel: their records join
    the kernels line), whose ``launches`` count their calls."""
    from probpose_code_torch.ops.kernels import realnvp

    return dict(realnvp_forward=realnvp.realnvp_forward, realnvp_backward=realnvp.realnvp_backward)


def has_gau(model) -> bool:
    """Whether ``model``'s head runs a GAU (RTMPose's ``RTMCCHead``)."""
    from probpose_code_torch.models.utils.rtmcc_block import RTMCCBlock

    return any(isinstance(m, RTMCCBlock) for m in model.module.modules())


def norm_layers(model):
    """(whether ``model`` trains a BatchNorm: a ``BatchNorm2d`` of
    ``models/heads/heatmap_head.py`` that is not frozen, whether its backbone
    runs the transformers' LayerNorm: Swin, HRFormer, PVT), the normalisation
    kernels a training step of it launches (``read_norms``)."""
    from probpose_code_torch.models.backbones.resnet import FrozenBatchNorm2d
    from probpose_code_torch.models.heads.heatmap_head import BatchNorm2d

    frozen = {id(m) for f in getattr(model.module.backbone, "frozen_modules", list)() for m in f.modules()}
    trains = any(isinstance(m, BatchNorm2d) and not isinstance(m, FrozenBatchNorm2d) and id(m) not in frozen
                 for m in model.module.modules())
    return trains, model.aux["backbone_cfg"].get("type") in TRANSFORMER_BACKBONES


def reset_counts():
    """Every kernel's count, the JPEG decode's, the photometric kernels',
    the GAU kernels', the face and hand kernels', the CNN backbones', the
    normalisation kernels' and the flow kernels' set to 0; returns a reader of the kernels' counts
    (``decode_batch.launches`` holds the decode's, ``augment_counters``,
    ``gau_counters``, ``face_hand_counters`` and ``cnn_zoo_counters`` the
    others)."""
    from probpose_code_torch.ops.kernels.jpeg import decode_batch

    counters = kernel_counters()
    for c in (*counters.values(), *augment_counters().values(), *gau_counters().values(),
              *face_hand_counters().values(), *cnn_zoo_counters().values(), *norm_counters().values(),
              *realnvp_counters().values(), decode_batch):
        c.launches = 0
    return lambda: {k: c.launches for k, c in counters.items()}


def full_fixture_state():
    """The state dict of ``tools/_e2e_torch_model.build_e2e_model(full=True)``,
    loaded by file path so that ``tools/`` never joins ``sys.path``."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("_e2e_torch_model", ROOT / "tools" / "_e2e_torch_model.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.build_e2e_model(full=True).state_dict()


def val_run(model_cfg, ann, device, state_dict):
    """``Runner.val`` over the set of ``ann`` (the flagship's val pipeline
    and CocoMetric) with ``state_dict`` on ``device``. Returns (metrics,
    samples, the kernels' launches, ``val_times``)."""
    import tempfile

    import torch

    from probpose_code_torch.engine.checkpoint import load_checkpoint
    from probpose_code_torch.engine.runner import Runner

    with tempfile.TemporaryDirectory() as tmp:
        weights = Path(tmp) / "weights.pth"
        torch.save(state_dict, weights)
        runner = Runner.from_cfg(golden_val_cfg(model_cfg, ann), device=device)
        load_checkpoint(runner.model, str(weights))
    evaluator = KeepSamples(runner.build_evaluator())
    # the main path: counts set to 0 just before, read just after
    read_counts = reset_counts()
    metrics = runner.val(evaluator)
    if device == "cuda":
        torch.cuda.synchronize()
    return metrics, evaluator.samples, read_counts(), runner.val_times


def run_val_golden(variant, device, state_dict):
    """The val path (``Runner.val``: CocoDataset of PNG files, the flagship's
    val pipeline, the loader, the canvas warp on ``device``, predict,
    CocoMetric) at the fixture's full geometry with ``state_dict`` (its
    ``build_e2e_model(full=True)`` weights), held to the JAX package's bars
    for ``variant`` (``VAL_BARS``). Returns (report, the kernels' launches)."""
    import tempfile

    import numpy as np

    bars = VAL_BARS[variant]
    with tempfile.TemporaryDirectory() as tmp:
        data, ann = golden_png_set(tmp, full=True)
        metrics, samples, launches, _ = val_run(full_model_cfg(variant == "shipped"), ann, device, state_dict)
    err, aux = golden_errors(data, samples)
    report = dict(instances=len(samples), max=float(err.max()), aux={f: aux[f] for f in VAL_AUX},
                  **{f"p{q}": float(np.percentile(err, q)) for q in (50, 90, 99)})
    for key, ref in (("AP", data["stats"][0]), ("Ex_AP", data["Ex_stats"][0]), ("prob_thr", data["prob_thr"])):
        report.update({key: metrics[f"coco/{key}"], f"fixture_{key}": float(ref),
                       f"d_{key}": abs(metrics[f"coco/{key}"] - float(ref))})
    within = [report[k] < bar for k, bar in bars.items() if k in ("p50", "p90", "p99", "max")]
    within += [max(report["aux"].values()) < bars["aux"], report["d_AP"] < bars["ap"], report["d_Ex_AP"] < bars["ap"]]
    report["ok"] = report["instances"] == len(data["pred_ids"]) and all(within)
    return report, launches


def run_val_jpeg(device, state_dict):
    """``run_val_golden("full")`` over the golden JPEGs (``golden_jpeg_set``,
    decoded on ``device``), held to the JAX package's ``Runner.val`` on the
    same files (``tests/golden_torch/val_reference.npz``: ``cv2.imread`` and
    ``cv2.warpAffine``, f32) at the JAX package's f32 bars: keypoints p99 <
    1.5 px and max < 8 px, AP and Ex-AP within 0.02. Returns (report, the
    kernels' launches)."""
    import tempfile

    import numpy as np

    bars = VAL_BARS["full"]
    ref = np.load(GOLDEN_JPEG / "val_reference.npz")
    with tempfile.TemporaryDirectory() as tmp:
        _, ann = golden_jpeg_set(tmp, full=True)
        metrics, samples, launches, times = val_run(full_model_cfg(), ann, device, state_dict)
    by_id = {s.metainfo["id"]: s for s in samples}
    ours = np.stack([by_id[i].pred_instances.keypoints.reshape(17, 2) for i in ref["ids"]])
    err = np.linalg.norm(ours - ref["keypoints"], axis=-1)
    scores = np.stack([by_id[i].pred_instances.keypoint_scores.reshape(17) for i in ref["ids"]])
    report = dict(instances=len(samples), max=float(err.max()), decode_s=times["decode"],
                  scores=float(np.abs(scores - ref["keypoint_scores"]).max()),
                  **{f"p{q}": float(np.percentile(err, q)) for q in (50, 90, 99)})
    for key in ("AP", "Ex_AP", "prob_thr"):
        report.update({key: metrics[f"coco/{key}"], f"jax_{key}": float(ref[key]),
                       f"d_{key}": abs(metrics[f"coco/{key}"] - float(ref[key]))})
    report["ok"] = (report["instances"] == len(ref["ids"]) and report["p99"] < bars["p99"]
                    and report["max"] < bars["max"] and report["d_AP"] < bars["ap"] and report["d_Ex_AP"] < bars["ap"])
    return report, launches


def qkv_views(B, N, H, D, dtype, seed):
    """q, k, v as the ViT block hands them to K4: strided (B, N, h, d) views
    of one unit-normal (B, N, 3, h, d) projection."""
    import torch

    g = torch.Generator().manual_seed(seed)
    qkv = torch.randn(B, N, 3, H, D, generator=g).cuda().to(dtype)
    return qkv.unbind(2)


def synthetic_boxes(n, seed=0):
    """One synthetic 640 x 480 image and ``n`` xyxy boxes inside it."""
    import numpy as np

    rng = np.random.RandomState(seed)
    img = (rng.rand(480, 640, 3) * 255).astype(np.uint8)
    xy = rng.uniform(0, [560, 380], (n, 2))
    wh = rng.uniform([40, 60], [200, 300], (n, 2))
    return img, np.concatenate([xy, np.minimum(xy + wh, [640, 480])], axis=1).astype(np.float32)


def run_steps(step, state, batch, gen, lr_fn, n):
    """n train steps; the new state and each step's (step, lr, metrics), the
    metrics still on the card."""
    logs = []
    for _ in range(n):
        lr = lr_fn(state.step)
        state, metrics = step(state, batch, gen)
        logs.append((state.step, lr, metrics))
    return state, logs


def report_steps(logs):
    for k, lr, metrics in logs:
        m = {name: float(v) for name, v in metrics.items()}
        print(f"train step {k}: lr {lr:.4e} " + json.dumps(m))
        if not all(map(math.isfinite, m.values())) or not m["grad_norm"] > 0:
            raise AssertionError(f"train step {k}: non-finite metrics or zero grad norm")


def stop_descendants(grace: float = 10.0) -> list:
    """Terminate every process this one started that still runs (its
    children and theirs, read from /proc), reap them, and return their
    pids: the script leaves no process behind, whichever phase failed."""
    import os
    import signal

    parent = {}
    for stat in Path("/proc").glob("[0-9]*/stat"):
        try:
            state, ppid = stat.read_text().rsplit(")", 1)[1].split()[:2]
        except (OSError, ValueError):
            continue
        parent[int(stat.parent.name)] = (int(ppid), state)
    mine, frontier = set(), {os.getpid()}
    while frontier:
        frontier = {pid for pid, (ppid, _) in parent.items() if ppid in frontier} - mine
        mine |= frontier
    running = sorted(pid for pid in mine if parent[pid][1] != "Z")
    for pid in running:
        try:
            os.kill(pid, signal.SIGTERM)
        except ProcessLookupError:
            pass
    deadline, killed = time.time() + grace, False
    for pid in sorted(mine):
        while time.time() < deadline:
            try:  # a child is reaped here; a grandchild is gone or a zombie of its own parent
                if os.waitpid(pid, os.WNOHANG)[0] == pid:
                    break
            except ChildProcessError:
                try:
                    if Path(f"/proc/{pid}/stat").read_text().rsplit(")", 1)[1].split()[0] == "Z":
                        break
                except OSError:
                    break
            time.sleep(0.05)
            if time.time() >= deadline and not killed:  # past the grace: SIGKILL, once
                for other in running:
                    try:
                        os.kill(other, signal.SIGKILL)
                    except ProcessLookupError:
                        pass
                deadline, killed = time.time() + grace, True
    return running


def recipe_augment_params(n, seed, config=RTMPOSE):
    """The photometric parameters of ``n`` crops drawn by the photometric
    transforms of ``config``'s train pipeline (RTMPose-m's:
    ``YOLOXHSVRandomAug`` and ``Albumentation``; body8's also
    ``PhotometricDistortion``, halpe26's that and ``Albumentation``) from
    NumPy's generator seeded with ``seed``, stacked as a batch carries
    them."""
    import numpy as np

    import probpose_code_torch.datasets  # noqa: F401  (registers the transforms)
    from probpose_code_torch.config import Config
    from probpose_code_torch.datasets.transforms.common import PHOTOMETRIC_ORDER
    from probpose_code_torch.ops.photometric import AUGMENT_KEYS
    from probpose_code_torch.registry import TRANSFORMS

    pipeline = Config.fromfile(config)["train_pipeline"]
    transforms = [TRANSFORMS.build(json.loads(json.dumps(t))) for t in pipeline if t["type"] in PHOTOMETRIC_ORDER]
    state = np.random.get_state()
    np.random.seed(seed)
    samples = []
    for _ in range(n):
        results = dict(warp_mat=np.eye(2, 3, dtype=np.float32), input_size=(192, 256))
        for t in transforms:
            results = t(results)
        samples.append(results)
    np.random.set_state(state)
    return {k: np.stack([r[k] for r in samples]) for k in AUGMENT_KEYS if k in samples[0]}


def report_runner_epochs(name, runner, first_epoch, profiler_s=0.0):
    """Each epoch of a ``Runner.train``: its train crops/s over its window
    and the ``train_times`` split."""
    for e, t in enumerate(runner.train_times, start=first_epoch + 1):
        print(f"{name} epoch {e}: {t['crops']} crops, {t['crops'] / t['window']:.1f} train crops/s from the start "
              f"of its loader to its last step ({t['window']:.3f} s); split (s): wait for the first batch "
              f"{t['first_batch']:.3f}, later loader waits {t['loader'] - t['first_batch']:.3f}, steps "
              f"{t['step']:.3f} (JPEG decode {t['decode']:.3f} card clock, {t['decode_host']:.3f} host clock; "
              f"augment {t['augment']:.3f} card clock, {t['augment_host']:.3f} host clock), hooks and logging "
              f"{t['hooks']:.3f}" + (f" (the profiler's start and stop {profiler_s:.3f} of it)" if profiler_s else "")
              + f"; after it: checkpoint writing {t['checkpoint']:.3f}, val {t['val']:.3f}; steady "
              f"{t['crops'] / max(t['window'] - t['first_batch'], 1e-9):.1f} crops/s without the first batch's wait")


def first_step_check(name, runner):
    """The first step of ``runner``'s training again, through
    ``make_train_step`` on the same batch (made by a new loader: a
    pipeline switch changed the runner's dataset), weights and generator
    seed: every metric within ``TRAIN_FLAGSHIP_REL``."""
    import torch

    from probpose_code_torch.engine.optim import build_optimizer
    from probpose_code_torch.models.builder import PoseModel
    from probpose_code_torch.parallel import create_train_state, make_train_step

    cfg = runner.cfg
    model = PoseModel(cfg["model"], metainfo=runner.metainfo, device=runner.model.device)
    model.init_weights(seed=0)
    optimizer, _ = build_optimizer(model, cfg["optim_wrapper"], cfg["param_scheduler"], len(runner.train_loader),
                                   runner.max_epochs)
    batch = runner.to_device(runner.build_train_loader().load(0, 0))
    _, metrics = make_train_step(model, optimizer)(create_train_state(model, optimizer), batch,
                                                   torch.Generator(device=model.device).manual_seed(cfg["seed"]))
    direct = {k: float(v) for k, v in metrics.items()}
    logged = runner.train_log[0]
    rel = {k: abs(logged[k] - v) / max(abs(v), 1e-30) for k, v in direct.items()}
    print(f"{name} first step: Runner.train {json.dumps({k: logged[k] for k in direct})}; make_train_step "
          f"{json.dumps(direct)}; largest relative difference {max(rel.values()):.3e} (bar {TRAIN_FLAGSHIP_REL:g}, "
          f"1e-7 absolute at 0)")
    if any(abs(logged[k] - v) > TRAIN_FLAGSHIP_REL * abs(v) + 1e-7 for k, v in direct.items()):
        raise AssertionError(f"{name}: the first step's loss dict differs from make_train_step's: {rel}")


def _runner_watch():
    """``RunnerWatch``, defined once the port's ``Hook`` can be imported."""
    import torch

    from probpose_code_torch.engine.checkpoint import read_checkpoint
    from probpose_code_torch.engine.hooks import Hook

    class RunnerWatch(Hook):
        """The val's metrics, the state a resumed run starts from (against
        the checkpoint's EMA average), and with ``profile`` the second step
        of the second epoch profiled: from the end of the step before it to
        the end of its own kernels."""

        def __init__(self, resume_from=None, profile=False):
            self.resume_from, self.profile, self.profile_step = resume_from, profile, None
            self.metrics, self.start, self.prof, self.profiler_s, self.busy_ms = None, None, None, 0.0, None

        def before_run(self, runner):
            self.start = dict(epoch=runner.epoch, step=runner.state.step)
            if self.profile:
                self.profile_step = len(runner.train_loader) + 2
            if self.resume_from:
                saved = read_checkpoint(self.resume_from)["state_dict"]
                names = [n for n, _ in runner.model.module.named_parameters()]
                self.start["average_equal"] = all(torch.equal(p.cpu(), saved[n])
                                                  for n, p in zip(names, runner.hooks[0].ema_params))
            if self.profile_step:  # the tracer's first start is slow: once here, outside the window
                with traced():
                    torch.cuda.synchronize()

        def after_train_iter(self, runner, step, metrics):
            if self.profile_step and step == self.profile_step - 1:
                t = time.perf_counter()
                self.prof = traced()
                self.prof.start()
                self.t0 = time.perf_counter()
                self.profiler_s += self.t0 - t
            elif self.prof is not None and step == self.profile_step:
                torch.cuda.synchronize()
                t = time.perf_counter()
                wall_us = (t - self.t0) * 1e6
                self.prof.stop()
                self.busy_ms = Smoke.report_profile(self.prof, wall_us, 1, "runner steps (the loader wait, the "
                                                                           "batch moved, the decode and augment, the "
                                                                           "step, the hooks)")
                self.prof = None
                self.profiler_s += time.perf_counter() - t

        def after_val_epoch(self, runner, metrics):
            self.metrics = metrics

    return RunnerWatch


class Smoke:
    def __init__(self):
        self.failures = []
        self.record = {}
        self._full_state = None

    def read_gau(self, path, runs, backward=False):
        """The GAU kernels' launches on ``path``'s main path (their counts set
        to 0 with the others'), kept for the ``gau`` line. Fails unless the
        forward launched where the model runs a GAU (``runs``), the backward
        too where the path trains (``backward``), and neither elsewhere."""
        launches = {k: c.launches for k, c in gau_counters().items()}
        self.record.setdefault("gau_launches", {})[path] = launches
        want = dict(gau_forward=runs, gau_backward=runs and backward)
        if any(bool(launches[k]) != v for k, v in want.items()):
            raise AssertionError(f"{path}: GAU kernel launches {launches}, expected launched {want}")

    def read_face_hand(self, path, model, backward=False):
        """The face and hand kernels' launches on ``path``'s main path (their
        counts set to 0 with the others'), kept for the ``face_hand`` line.
        Fails unless the depthwise kernels launched where ``model``'s
        backbone has depthwise convs (``DEPTHWISE_BACKBONES``; the backward
        too where the path trains), the
        AdaptiveWingLoss kernels where it trains under that loss, and
        neither elsewhere."""
        launches = {k: c.launches for k, c in face_hand_counters().items()}
        self.record.setdefault("face_hand_launches", {})[path] = launches
        depthwise = model.aux["backbone_cfg"].get("type") in DEPTHWISE_BACKBONES
        awing = backward and (model.aux["head_cfg"].get("loss") or {}).get("type") == "AdaptiveWingLoss"
        want = dict(depthwise_forward=depthwise, depthwise_backward=depthwise and backward,
                    adaptive_wing_forward=awing, adaptive_wing_backward=awing)
        if any(bool(launches[k]) != v for k, v in want.items()):
            raise AssertionError(f"{path}: face and hand kernel launches {launches}, expected launched {want}")

    def read_cnn_zoo(self, path, model, backward=False):
        """The CNN backbones' kernels' launches on ``path``'s main path (their
        counts set to 0 with the others'), kept for the ``cnn_zoo`` line.
        Fails unless SCNet's gate kernel launched where ``model`` is an
        SCNet, the split attention's where it is a ResNeSt and the
        squeeze-and-excite kernels where it has an ``SELayer`` (SEResNet,
        the ViPNAS backbones, LiteHRNet's spatial weighting) (the backward
        too where the path trains), and none elsewhere."""
        from probpose_code_torch.models.backbones.classic import SELayer

        launches = {k: c.launches for k, c in cnn_zoo_counters().items()}
        self.record.setdefault("cnn_zoo_launches", {})[path] = launches
        kind = model.aux["backbone_cfg"].get("type")
        se = any(isinstance(m, SELayer) for m in model.module.modules())
        want = dict(sc_gate_forward=kind == "SCNet", sc_gate_backward=kind == "SCNet" and backward,
                    se_layer_forward=se, se_layer_backward=se and backward,
                    split_attention_forward=kind == "ResNeSt", split_attention_backward=kind == "ResNeSt" and backward)
        if any(bool(launches[k]) != v for k, v in want.items()):
            raise AssertionError(f"{path}: CNN backbone kernel launches {launches}, expected launched {want}")

    def read_norms(self, path, batch_norm, layer_norm, backward=False):
        """The normalisation kernels' launches on ``path``'s main path (their
        counts set to 0 with the others'), kept for the ``norms`` line. Fails
        unless BatchNorm's forward and backward launched where the path trains
        a model with a BatchNorm in training mode (``batch_norm``;
        ``norm_layers``), LayerNorm's forward where the model runs the
        transformers' LayerNorm (``layer_norm``) and its backward where that
        trains, and none elsewhere (BatchNorm in evaluation mode normalises by
        its running statistics, no kernel)."""
        launches = {k: c.launches for k, c in norm_counters().items()}
        self.record.setdefault("norm_launches", {})[path] = launches
        want = dict(batch_norm_forward=batch_norm and backward, batch_norm_backward=batch_norm and backward,
                    layer_norm_forward=layer_norm, layer_norm_backward=layer_norm and backward)
        if any(bool(launches[k]) != v for k, v in want.items()):
            raise AssertionError(f"{path}: normalisation kernel launches {launches}, expected launched {want}")

    def read_realnvp(self, path, model, backward=False):
        """The flow kernels' launches on ``path``'s main path (their counts set
        to 0 with the others'), kept for their records in the kernels line.
        Fails unless both launched where the path trains an RLEHead (its
        RLELoss runs the flow; predict does not), and neither elsewhere."""
        launches = {k: c.launches for k, c in realnvp_counters().items()}
        self.record.setdefault("realnvp_launches", {})[path] = launches
        rle = backward and model.head_type == "RLEHead"
        if any(bool(n) != rle for n in launches.values()):
            raise AssertionError(f"{path}: flow kernel launches {launches}, expected launched {rle}")

    def phase(self, name, fn):
        t0 = time.time()
        try:
            fn()
            print(f"[{name}] ok in {time.time() - t0:.1f} s", flush=True)
        except Exception:  # noqa: BLE001 - every phase reports, the run fails at the end
            self.failures.append(name)
            print(f"[{name}] FAILED", flush=True)
            traceback.print_exc()

    # -- phases ----------------------------------------------------------

    def build(self):
        from probpose_code_torch.ops.kernels import _build

        t0 = time.time()
        paths = _build.build(_build.sources())
        print(f"build: {len(paths)} libraries in {time.time() - t0:.1f} s ({', '.join(p.name for p in paths)})")

    def k1_parity(self):
        import torch

        from probpose_code_torch.ops.kernels.vit_layer import vit_layer, vit_layer_plain

        B, N, C, H, F = 8, 192, 384, 12, 1536
        for dtype, approx, bar in ((torch.bfloat16, True, K1_BF16_REL), (torch.float32, False, K1_F32_REL)):
            x, p = layer_inputs(B, N, C, F, dtype, seed=0)
            kw = dict(num_heads=H, approximate_gelu=approx, dtype=dtype)
            with torch.inference_mode():
                got = vit_layer(x, *p, **kw).float()
                want = vit_layer_plain(x, *p, **kw).float()
            rel = ((got - want).abs().max() / want.abs().max()).item()
            print(f"K1 {str(dtype)[6:]} {'tanh' if approx else 'erf'}: rel max err {rel:.3e} (bar {bar:g})")
            if not (rel < bar and torch.isfinite(got).all()):
                raise AssertionError(f"K1 {dtype} disagrees with its plain twin: {rel:.3e}")

    def k2_parity(self):
        import torch

        from probpose_code_torch.ops.decode import (
            expected_oks_decode_to_input_space, heatmap_expected_value_batch, oks_convolve_plain,
        )
        from probpose_code_torch.ops.kernels.expected_oks import expected_oks_decode, oks_convolve

        B, K, H, W = 64, 17, 64, 48
        hm = torch.from_numpy(peaked_heatmaps(B, K, H, W, seed=1)).cuda()
        size = (192, 256)
        scale = torch.tensor([size[0] / (W - 1), size[1] / (H - 1)], device="cuda")
        locs, vals = expected_oks_decode(hm, size)
        locs_p, vals_p = expected_oks_decode_to_input_space(hm, size)
        dl = ((locs - locs_p) / scale).abs().max().item()
        dv = (vals - vals_p).abs().max().item()
        conv_err = (oks_convolve(hm) - oks_convolve_plain(hm)).abs().max().item()
        print(f"K2: locs err {dl:.3e} px (bar {K2_LOCS_ATOL:g}), vals err {dv:.3e} (bar {K2_VALS_ATOL:g}), "
              f"conv-only err {conv_err:.3e} (bar {K2_CONV_ATOL:g})")
        if not (dl < K2_LOCS_ATOL and dv < K2_VALS_ATOL and conv_err < K2_CONV_ATOL):
            raise AssertionError("K2 disagrees with its plain twin")
        # the identity scale (heatmap pixels) at the DoubleProbPose decode's
        # shape: both windows of 64 crops, (2B, K, H, W), in one launch
        hm = torch.from_numpy(peaked_heatmaps(2 * B, K, H, W, seed=2)).cuda()
        locs, vals = expected_oks_decode(hm, None)
        locs_p, vals_p = heatmap_expected_value_batch(hm)
        dl = (locs - locs_p).abs().max().item()
        dv = (vals - vals_p).abs().max().item()
        print(f"K2 at the identity scale, ({2 * B}, {K}, {H}, {W}): locs err {dl:.3e} px (bar {K2_LOCS_ATOL:g}), "
              f"vals err {dv:.3e} (bar {K2_VALS_ATOL:g})")
        if not (locs.shape == (2 * B, K, 2) and dl < K2_LOCS_ATOL and dv < K2_VALS_ATOL):
            raise AssertionError("K2 at the identity scale disagrees with its plain twin")

    def k3_parity(self):
        import torch

        cases = ((4, 16, 64, 4, 128, torch.float32, False), (4, 16, 64, 4, 128, torch.float32, True),
                 (64, 192, 384, 12, 1536, torch.bfloat16, True))
        for B, N, C, H, F, dtype, masked in cases:
            errs = k3_errors(B, N, C, H, F, dtype, masked, seed=B + N)
            bars = {n: (K3_BF16_REL if dtype == torch.bfloat16 else K3_F32_FWD if n == "out" else K3_F32_GRAD)
                    for n in errs}
            print(f"K3 B={B} N={N} C={C} H={H} F={F} {str(dtype)[6:]}{' masked' if masked else ''}: "
                  + ", ".join(f"{n} {e:.2e} (bar {bars[n]:g})" for n, e in errs.items()))
            bad = [n for n, e in errs.items() if not e < bars[n]]
            if bad:
                raise AssertionError(f"K3 disagrees with its plain twin on {bad}")

    def golden(self):
        import numpy as np

        from probpose_code_torch.apis import init_model
        from probpose_code_torch.ops.kernels.expected_oks import expected_oks_decode
        from probpose_code_torch.ops.kernels.vit_layer import vit_layer_prepared

        model = init_model(TINY_CFG, checkpoint=str(GOLDEN / "e2e_weights.pth"), device="cuda")
        vit_layer_prepared.launches = expected_oks_decode.launches = 0
        data, samples = golden_samples(model)
        k1, k2 = vit_layer_prepared.launches, expected_oks_decode.launches
        err, aux = golden_errors(data, samples)
        p99 = float(np.percentile(err, 99))
        print(f"golden: {len(samples)} instances; keypoint err p99 {p99:.4f} px, "
              f"max {err.max():.4f} px; aux max err {json.dumps(aux)}; launches K1 {k1}, K2 {k2}")
        if not (p99 < 1.0 and err.max() < 5.0 and max(aux.values()) < 2e-3):
            raise AssertionError("golden fixture out of bars (p99 < 1 px, max < 5 px, aux atol 2e-3)")
        if k1 == 0 or k2 == 0:
            raise AssertionError("the golden run did not go through both kernels")

    def checkpoint_file(self):
        """A checkpoint as mmpose's runner writes it (the golden tiny weights
        under ``state_dict``, ``meta.dataset_meta`` with numpy arrays) loads
        through ``init_model`` on the card with no key missing and the file's
        metainfo, and gives the same state and bitwise the same predictions
        on the golden fixture as the bare state dict."""
        import tempfile

        import numpy as np
        import torch

        from probpose_code_torch.apis import init_model
        from probpose_code_torch.datasets.metainfo import parse_pose_metainfo

        bare = GOLDEN / "e2e_weights.pth"
        meta = parse_pose_metainfo({"dataset_name": "coco"})
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "epoch_210.pth"
            torch.save({"meta": {"dataset_meta": meta, "epoch": 210, "iter": 491400, "seed": 0},
                        "state_dict": torch.load(bare, map_location="cpu", weights_only=True)}, path)
            model = init_model(TINY_CFG, checkpoint=str(path), device="cuda")
        ref = init_model(TINY_CFG, checkpoint=str(bare), device="cuda")
        if not np.array_equal(model.metainfo["sigmas"], meta["sigmas"]):
            raise AssertionError("the model did not take the file's dataset_meta")
        got_sd, want_sd = model.module.state_dict(), ref.module.state_dict()
        if set(got_sd) != set(want_sd) or not all(torch.equal(got_sd[k], want_sd[k]) for k in want_sd):
            raise AssertionError("the runner-style file gave other weights than the bare state dict")
        # cuDNN's default algorithms for the head's transposed convolutions
        # add in no fixed order (one model's two runs differ by up to 6e-5 px
        # on the H100), so the bitwise comparison runs with deterministic ones
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            (_, got), (_, want) = golden_samples(model), golden_samples(ref)
        finally:
            torch.backends.cudnn.deterministic = deterministic
        fields = ("keypoints", "keypoint_scores") + tuple(f for f, _ in GOLDEN_AUX)
        diff = max(float(np.abs(g.pred_instances[f] - w.pred_instances[f]).max())
                   for g, w in zip(got, want) for f in fields)
        same = diff == 0
        print(f"checkpoint_file: runner-style .pth (state_dict + meta.dataset_meta with numpy sigmas) -> "
              f"{len(got)} golden instances, predictions bitwise equal to the bare state dict's: {same} "
              f"(max abs difference {diff:.3e})")
        if len(got) != len(want) or not same:
            raise AssertionError("the runner-style checkpoint's predictions differ from the bare state dict's")

    def flagship(self):
        import numpy as np
        import torch

        from probpose_code_torch.apis import inference_topdown, init_model
        from probpose_code_torch.config import Config

        model = init_model(Config.fromfile(FLAGSHIP), device="cuda")
        img, boxes = synthetic_boxes(64)

        # the main path: counts set to 0 just before, read just after
        read_counts = reset_counts()
        samples = inference_topdown(model, img, boxes)
        torch.cuda.synchronize()
        launches = read_counts()
        self.read_norms("flagship", False, False)
        print(f"flagship main path: {len(samples)} crops, launches {json.dumps(launches)}")
        kpts = np.stack([s.pred_instances.keypoints for s in samples])
        fields = [np.stack([s.pred_instances[f] for s in samples]) for f in
                  ("keypoint_scores", "keypoints_probs", "keypoints_visible", "keypoints_oks", "keypoints_error")]
        if kpts.shape != (64, 1, 17, 2) or any(f.shape != (64, 1, 17) for f in fields):
            raise AssertionError(f"flagship output shapes {kpts.shape}, {[f.shape for f in fields]}")
        if not (np.isfinite(kpts).all() and all(np.isfinite(f).all() for f in fields)):
            raise AssertionError("flagship outputs are not finite")
        if launches != PREDICT_LAUNCHES:
            raise AssertionError(f"expected K1 x12 and K2 x1 per call and no other kernel, got {launches}")
        self.record["launches"] = launches
        self.record.setdefault("k1_records", {})["flagship_predict"] = k1_record(model)

        iters = 10
        for _ in range(3):
            inference_topdown(model, img, boxes)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            inference_topdown(model, img, boxes)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        self.record["flagship_crops_s"] = 64 * iters / dt
        print(f"flagship ProbPose-S predict, flip-TTA, B=64: {64 * iters / dt:.1f} crops/s "
              f"({1e3 * dt / iters:.2f} ms per inference_topdown call, {iters} calls after 3 warm-up)")
        self.profile(lambda: inference_topdown(model, img, boxes), calls=3)

    def train(self):
        import torch

        from probpose_code_torch.apis import init_model
        from probpose_code_torch.config import Config
        from probpose_code_torch.engine.optim import build_optimizer
        from probpose_code_torch.parallel import create_train_state, make_train_step

        cfg = Config.fromfile(FLAGSHIP)
        model = init_model(cfg, device="cuda")
        optimizer, lr_fn = build_optimizer(
            model, cfg["optim_wrapper"], cfg["param_scheduler"], STEPS_PER_EPOCH, cfg["train_cfg"]["max_epochs"],
        )
        state = create_train_state(model, optimizer)
        step = make_train_step(model, optimizer)
        B = cfg["train_dataloader"]["batch_size"]
        batch = synthetic_train_batch(B, seed=0)
        gen = torch.Generator(device="cuda").manual_seed(0)
        qkv0 = dict(model.module.named_parameters())["backbone.layers.0.attn.qkv.weight"]

        def run(n):
            """n steps; their (step, lr, metrics) with the metrics still on the card."""
            nonlocal state
            state, logs = run_steps(step, state, batch, gen, lr_fn, n)
            return logs

        # the main path: counts set to 0 just before one step, read just after
        read_counts = reset_counts()
        report_steps(run(1))
        torch.cuda.synchronize()
        launches = read_counts()
        self.read_norms("train", *norm_layers(model), backward=True)
        g0 = qkv0.grad.abs().max().item()
        print(f"train main path: one step of B={B}, launches {json.dumps(launches)}; "
              f"max |grad| of backbone.layers.0.attn.qkv.weight {g0:.3e}")
        want = dict(vit_layer=0, expected_oks=0, oks_convolve=0, vit_layer_train_fwd=12, vit_layer_train_bwd=12,
                    attention=0)
        if launches != want:
            raise AssertionError(f"expected K3 x12 forward and x12 backward and no other kernel, got {launches}")
        if not g0 > 0:
            raise AssertionError("the first ViT layer got no gradient")
        self.record["train_launches"] = launches

        report_steps(run(2))  # warm-up: 3 steps with the one above
        torch.cuda.synchronize()
        steps = 5
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        logs = run(steps)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        report_steps(logs)
        self.record["flagship_train_crops_s"] = B * steps / dt
        print(f"flagship ProbPose-S train step, B={B}, bf16, drop_path 0.1: {B * steps / dt:.1f} crops/s "
              f"({1e3 * dt / steps:.2f} ms per step, {steps} steps after 3 warm-up; the loss dicts are read "
              f"to the host after the timed steps); peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        self.profile(lambda: run(1), calls=2, what="train steps")

    @staticmethod
    def k4_f32_errors(B, N, H, D, seed):
        """K4 in f32 at one shape: the forward's max abs error against its
        plain twin on unit-normal strided qkv views, and one gradient through
        the Function on the card (the kernel's forward, the strided views
        saved and recomputed there) against autograd through
        ``xla_attention`` on CPU copies of the same inputs; each checked
        against its bar."""
        import torch

        from probpose_code_torch.ops.kernels.attention import (
            fused_attention, fused_attention_plain, xla_attention_plain,
        )

        q, k, v = qkv_views(B, N, H, D, torch.float32, seed=seed)
        with torch.no_grad():
            err = (fused_attention(q, k, v, D ** -0.5) - fused_attention_plain(q, k, v, D ** -0.5)).abs().max().item()
        g = torch.randn(B, N, H, D, generator=torch.Generator().manual_seed(seed + 2))
        qkv = torch.stack((q, k, v), dim=2).detach().requires_grad_(True)
        (card,) = torch.autograd.grad(fused_attention(*qkv.unbind(2), D ** -0.5), qkv, g.cuda())
        qkv = qkv.detach().cpu().requires_grad_(True)
        (host,) = torch.autograd.grad(xla_attention_plain(*qkv.unbind(2), D ** -0.5), qkv, g)
        gerr = (card.cpu() - host).abs().max().item()
        print(f"K4 B={B} N={N} h={H} d={D} f32: max abs err {err:.3e} (bar {K4_F32_ATOL:g}); gradient (dq, dk, dv) "
              f"on the card vs autograd through xla_attention on the CPU: max abs err {gerr:.3e} "
              f"(bar {K4_GRAD_ATOL:g})")
        if not (err < K4_F32_ATOL and gerr < K4_GRAD_ATOL):
            raise AssertionError(f"K4 f32 at h={H} d={D} disagrees: forward {err:.3e}, gradient {gerr:.3e}")

    def k4_parity(self):
        import torch

        from probpose_code_torch.ops.kernels.attention import fused_attention, fused_attention_plain

        # the ViTPose-B training shape in f32, forward and gradient
        N, H = 192, 12
        self.k4_f32_errors(64, N, H, 64, seed=6)
        # the ProbPose-S shape in bf16: relative max error
        Bs, Ds = 128, 32
        qs, ks, vs = qkv_views(Bs, N, H, Ds, torch.bfloat16, seed=7)
        with torch.no_grad():
            got = fused_attention(qs, ks, vs, Ds ** -0.5).float()
            want = fused_attention_plain(qs, ks, vs, Ds ** -0.5).float()
        rel = ((got - want).abs().max() / want.abs().max()).item()
        print(f"K4 B={Bs} N={N} h={H} d={Ds} bf16: rel max err {rel:.3e} (bar {K4_BF16_REL:g})")
        if not (rel < K4_BF16_REL and torch.isfinite(got).all()):
            raise AssertionError(f"K4 bf16 disagrees with its plain twin: {rel:.3e}")

    def vit_large_parity(self):
        """K1 in f32 with erf GELU at one layer of the ViTPose-L and -H predict
        calls (64 crops and their mirrors: B = 128, N = 192; C = 1024 with 16
        heads of 64, and C = 1280 with 16 heads of 80, which takes the f32
        attention's wide one-pass instance) against its plain twin at
        ``K1_F32_REL``, and K4 in f32 at their training shapes (B = 64, 16
        heads of 64 and of 80), forward and gradient (``k4_f32_errors``)."""
        import torch

        from probpose_code_torch.ops.kernels.vit_layer import vit_layer, vit_layer_plain

        for C, H, F in VIT_LARGE_SHAPES:
            x, p = layer_inputs(128, 192, C, F, torch.float32, seed=C)
            kw = dict(num_heads=H, approximate_gelu=False, dtype=torch.float32)
            with torch.inference_mode():
                got = vit_layer(x, *p, **kw)
                want = vit_layer_plain(x, *p, **kw)
            rel = ((got - want).abs().max() / want.abs().max()).item()
            print(f"K1 B=128 N=192 C={C} h={H} d={C // H} f32 erf: rel max err {rel:.3e} (bar {K1_F32_REL:g})")
            if not (rel < K1_F32_REL and torch.isfinite(got).all()):
                raise AssertionError(f"K1 at C={C} disagrees with its plain twin: {rel:.3e}")
            self.k4_f32_errors(64, 192, H, C // H, seed=C + 1)

    def vit_predict(self, config, name, path, record_key, layers):
        """A ViTPose config file at full width (random weights, seed 0, f32,
        erf GELU; its first ``layers`` layers, ``vit_config``) through
        ``init_model`` / ``inference_topdown``, 64 boxes with flip-TTA: K1's
        launches in one call (one a layer, no other kernel), the outputs
        finite, every positive heatmap peak inside its crop's padded box, two
        crops' heatmaps and scores against the same model on the CPU (K1's
        plain twin), then crops/s, peak memory and a profile."""
        import numpy as np
        import torch

        from probpose_code_torch.apis import inference_topdown, init_model
        from probpose_code_torch.apis.inference import crop_batch
        from probpose_code_torch.ops.heatmap import heatmap_maximum_batch

        model = init_model(vit_config(config, layers), device="cuda")
        img, boxes = synthetic_boxes(64, seed=1)

        # the main path: counts set to 0 just before, read just after
        read_counts = reset_counts()
        samples = inference_topdown(model, img, boxes)
        torch.cuda.synchronize()
        launches = read_counts()
        self.read_norms(path, False, False)
        print(f"{path} main path: {len(samples)} crops, launches {json.dumps(launches)}")
        kpts = np.stack([s.pred_instances.keypoints for s in samples])
        scores = np.stack([s.pred_instances.keypoint_scores for s in samples])
        if kpts.shape != (64, 1, 17, 2) or scores.shape != (64, 1, 17):
            raise AssertionError(f"{name} output shapes {kpts.shape}, {scores.shape}")
        if not (np.isfinite(kpts).all() and np.isfinite(scores).all()):
            raise AssertionError(f"{name} outputs are not finite")
        # every positive heatmap peak maps inside its crop's padded box (a map
        # whose maximum is <= 0 has no peak: its location is -1, as in the
        # JAX decode). The DARK-UDP step that follows is a Newton step on
        # random-weight maps, which may carry a keypoint out of the box (as
        # the JAX decode does); how far is printed, and the refined values are
        # held against the CPU twin below.
        crops, centers, scales = crop_batch(img, boxes, model.input_size, model.device, model.cfg_full)
        hm = model.predict(crops)["heatmaps"]
        peaks, vals = (t.cpu().numpy() for t in heatmap_maximum_batch(hm))
        hm_wh = np.asarray([hm.shape[3] - 1, hm.shape[2] - 1], np.float32)  # UDP: the map's ends are the crop's
        lo, hi = (centers - scales / 2)[:, None], (centers + scales / 2)[:, None]
        peaks = peaks / hm_wh * scales[:, None] + lo
        inside = ((peaks >= lo - 1e-3) & (peaks <= hi + 1e-3)).all(-1)
        if not inside[vals > 0].all():
            raise AssertionError(f"a {name} heatmap peak maps outside its padded box")
        outside = np.maximum(np.maximum(lo - kpts[:, 0], kpts[:, 0] - hi), 0) / scales[:, None]
        print(f"{name} heatmap peaks inside the padded boxes ({int((vals > 0).sum())} of {vals.size} positive); "
              f"refined keypoints outside them: {int((outside.max(-1) > 0).sum())}, at most "
              f"{outside.max():.3f} box widths")
        # the predict program on two of the crops against the same model on the
        # CPU (K1's plain twin, the same seed-0 weights), both in f32
        crops = crops[:2]
        got = model.predict(crops)
        ref = init_model(vit_config(config, layers), device="cpu").predict(crops.cpu())
        hm_rel = ((got["heatmaps"].cpu() - ref["heatmaps"]).abs().max() / ref["heatmaps"].abs().max()).item()
        score_err = (got["keypoint_scores"].cpu() - ref["keypoint_scores"]).abs().max().item()
        print(f"{name} predict on 2 crops vs the CPU twin: heatmaps rel max err {hm_rel:.3e} "
              f"(bar {K1_F32_REL:g}), scores max abs err {score_err:.3e} (bar {K1_F32_REL:g})")
        if not (hm_rel < K1_F32_REL and score_err < K1_F32_REL):
            raise AssertionError(f"{name} predict disagrees with the CPU twin")
        want = dict(NO_LAUNCHES, vit_layer=layers)
        if launches != want:
            raise AssertionError(f"expected K1 x{layers} per call and no other kernel, got {launches}")
        self.record[record_key] = launches
        self.record.setdefault("k1_records", {})[path] = k1_record(model)

        iters = 5
        for _ in range(2):
            inference_topdown(model, img, boxes)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(iters):
            inference_topdown(model, img, boxes)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        print(f"{name} predict ({layers} layers), f32, flip-TTA, B=64: {64 * iters / dt:.1f} crops/s "
              f"({1e3 * dt / iters:.2f} ms per inference_topdown call, {iters} calls after 2 warm-up); peak device "
              f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        self.profile(lambda: inference_topdown(model, img, boxes), calls=2, what=f"{name} predict calls")

    def vitpose_predict(self):
        """ViTPose-B-simple (ViT-B/16, f32, erf GELU, x4 neck, HeatmapHead,
        UDP decode) through ``vit_predict``: K1 x12."""
        self.vit_predict(VITPOSE, "ViTPose-B-simple", "vitpose_predict", "vitpose_launches", 12)

    def vitpose_small_predict(self):
        """ViTPose-S-simple (ViT-S/16 in f32 with erf GELU: K1's f32 instance
        at C = 384) through ``vit_predict``: K1 x12."""
        self.vit_predict(VITPOSE_SMALL, "ViTPose-S-simple", "vitpose_small_predict", "vitpose_small_launches", 12)

    def vitpose_large_predict(self):
        """ViTPose-L (ViT-L/16: C = 1024, 16 heads of 64; the classic head's
        two deconvolutions on 1024 channels, 64 x 48 UDP maps) through
        ``vit_predict``, its first ``VIT_LARGE_DEPTH`` of 24 layers: K1 a
        layer."""
        self.vit_predict(VITPOSE_LARGE, "ViTPose-L", "vitpose_large_predict", "vitpose_large_launches",
                         VIT_LARGE_DEPTH)

    def vitpose_huge_predict(self):
        """ViTPose-H (ViT-H/16: C = 1280, 16 heads of 80; deconvolutions on
        1280 channels) through ``vit_predict``, its first ``VIT_LARGE_DEPTH``
        of 32 layers: K1 a layer."""
        self.vit_predict(VITPOSE_HUGE, "ViTPose-H", "vitpose_huge_predict", "vitpose_huge_launches", VIT_LARGE_DEPTH)

    def vit_train(self, config, name, path, record_key, layers, steps=5):
        """A ViTPose recipe at full width (its drop_path, UDP targets encoded
        on the card, its optimizer and schedules) through ``make_train_step``
        on its batch (64) of synthetic crops, its first ``layers`` layers
        (``vit_config``): K4's launches in one step (one a layer; K1 and K3
        none), the first layer's gradient, the losses, lr and gradient norm
        of each step, train crops/s over ``steps`` steps after 3 warm-up,
        peak memory and a profile. A batch that does not fit on the card
        fails the phase, saying so."""
        import torch

        from probpose_code_torch.apis import init_model
        from probpose_code_torch.engine.optim import build_optimizer
        from probpose_code_torch.parallel import create_train_state, make_train_step

        cfg = vit_config(config, layers)
        model = init_model(cfg, device="cuda")
        optimizer, lr_fn = build_optimizer(
            model, cfg["optim_wrapper"], cfg["param_scheduler"], STEPS_PER_EPOCH, cfg["train_cfg"]["max_epochs"],
        )
        state = create_train_state(model, optimizer)
        step = make_train_step(model, optimizer)
        B = cfg["train_dataloader"]["batch_size"]
        batch = synthetic_train_batch(B, seed=1)
        gen = torch.Generator(device="cuda").manual_seed(1)
        qkv0 = dict(model.module.named_parameters())["backbone.layers.0.attn.qkv.weight"]
        torch.cuda.reset_peak_memory_stats()

        # the main path: counts set to 0 just before one step, read just after
        read_counts = reset_counts()
        try:
            state, logs = run_steps(step, state, batch, gen, lr_fn, 1)
            torch.cuda.synchronize()
        except torch.cuda.OutOfMemoryError as e:
            raise AssertionError(f"{name}: a train step at the recipe's B={B} does not fit on the card "
                                 f"({torch.cuda.max_memory_allocated() / 2**30:.2f} GiB allocated at most)") from e
        launches = read_counts()
        self.read_norms(path, *norm_layers(model), backward=True)
        report_steps(logs)
        g0 = qkv0.grad.abs().max().item()
        print(f"{path} main path: one step of B={B}, launches {json.dumps(launches)}; "
              f"max |grad| of backbone.layers.0.attn.qkv.weight {g0:.3e}")
        if launches != dict(NO_LAUNCHES, attention=layers):
            raise AssertionError(f"expected K4 x{layers} (and K1, K3 x0) in a {name} step and no other kernel, "
                                 f"got {launches}")
        if not g0 > 0:
            raise AssertionError("the first ViT layer got no gradient")
        self.record[record_key] = launches
        self.record.setdefault("k4_records", {})[path] = k4_record(model)

        state, logs = run_steps(step, state, batch, gen, lr_fn, 2)  # warm-up: 3 steps with the one above
        report_steps(logs)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()  # the printed peak: the timed steps only
        t0 = time.perf_counter()
        state, logs = run_steps(step, state, batch, gen, lr_fn, steps)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        report_steps(logs)
        print(f"{name} train step ({layers} layers), B={B}, f32, drop_path {cfg['model']['backbone']['drop_path_rate']}: "
              f"{B * steps / dt:.1f} crops/s ({1e3 * dt / steps:.2f} ms per step, {steps} steps after 3 warm-up; "
              f"the loss dicts are read to the host after the timed steps); peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

        def one():
            nonlocal state
            state, _ = run_steps(step, state, batch, gen, lr_fn, 1)

        busy_ms = self.profile(one, calls=2, what=f"{name} train steps")
        head = model.module.head
        if len(head.deconv_layers) and busy_ms:
            # the 2% rule for the classic head this recipe newly puts on a step: its deconvolutions on the
            # backbone's C channels, BatchNorm and final conv (cuDNN), forward and backward alone at the step's shapes
            bb = model.module.backbone
            feat = torch.randn(B, bb.embed_dims, bb.grid_h, bb.grid_w, device="cuda", requires_grad=True)
            ms = self.kernel_device_ms(lambda: head(feat).sum().backward(), calls=5)
            print(f"2% rule: the {name} head ({len(head.deconv_layers) // 3} deconvolutions, the first on "
                  f"{bb.embed_dims} channels) forward and backward alone at B={B}: {ms:.3f} ms of device time, "
                  f"{100 * ms / busy_ms:.2f}% of the profiled step's {busy_ms:.2f} ms")

    def vitpose_train(self):
        """The ViTPose-B-simple recipe (drop_path 0.3, AdamW with layer decay
        0.75) through ``vit_train``: K4 x12."""
        self.vit_train(VITPOSE, "ViTPose-B-simple", "vitpose_train", "vitpose_train_launches", 12)

    def vitpose_large_train(self):
        """The ViTPose-L recipe (drop_path 0.5, AdamW with layer decay 0.8,
        clip 1.0) through ``vit_train``, its first ``VIT_LARGE_DEPTH`` of 24
        layers: K4 a layer."""
        self.vit_train(VITPOSE_LARGE, "ViTPose-L", "vitpose_large_train", "vitpose_large_train_launches",
                       VIT_LARGE_DEPTH, steps=3)

    def vitpose_huge_train(self):
        """The ViTPose-H recipe (drop_path 0.55, AdamW with layer decay 0.85,
        clip 1.0) through ``vit_train``, its first ``VIT_LARGE_DEPTH`` of 32
        layers: K4 a layer."""
        self.vit_train(VITPOSE_HUGE, "ViTPose-H", "vitpose_huge_train", "vitpose_huge_train_launches",
                       VIT_LARGE_DEPTH, steps=3)

    def full_weights(self):
        """The fixture's full-geometry weights, ``build_e2e_model(full=True)``
        (seed 7), built on the CPU: the fixture was made from the CPU
        generator's draws. Built once for both val phases."""
        if self._full_state is None:
            self._full_state = full_fixture_state()
        return self._full_state

    def val_golden(self, variant):
        report, launches = run_val_golden(variant, "cuda", self.full_weights())
        self.read_norms(f"val_{variant}", False, False)
        print(f"val_{variant}: {report['instances']} instances through Runner.val; keypoint err p50 "
              f"{report['p50']:.4f}, p90 {report['p90']:.4f}, p99 {report['p99']:.4f}, max {report['max']:.4f} px; "
              f"aux max err {json.dumps(report['aux'])}; AP {report['AP']:.4f} (fixture {report['fixture_AP']:.4f}, "
              f"|d| {report['d_AP']:.4f}), Ex_AP {report['Ex_AP']:.4f} (fixture {report['fixture_Ex_AP']:.4f}, "
              f"|d| {report['d_Ex_AP']:.4f}), prob_thr {report['prob_thr']:.2f} (fixture "
              f"{report['fixture_prob_thr']:.2f}); launches {json.dumps(launches)}; bars {json.dumps(VAL_BARS[variant])}")
        if launches != PREDICT_LAUNCHES:
            raise AssertionError(f"expected K1 x12 and K2 x1 for the one val batch and no other kernel, got {launches}")
        if not report["ok"]:
            raise AssertionError(f"val_{variant} out of its bars {VAL_BARS[variant]}")

    def jpeg_decode(self):
        """The port's decode on the card (``ops/kernels/jpeg.py``) against
        the plain decoder on every fixture of ``tests/golden_torch``: shapes
        equal (EXIF orientation applied), |difference| 0 on each image,
        every slot's padding zero in a batch of mixed sizes decoded after a
        batch of larger images (the buffer is zeroed for each batch), the
        truncated stream refused. nvJPEG's batched decode (``NvjpegBatched``,
        the yardstick) on the same images within ``NVJPEG_BARS``, oriented
        on the host for the comparison. Both reported by mode (max, mean,
        p99). Then the decode rate, a batch of 64 golden JPEGs on the card's
        clock, the port's and nvJPEG's, the host half alone (the Huffman
        decode on 1 and on ``HOST_THREADS`` threads, host clock, a file, a
        MB of JPEG data and a megapixel) and the plain decoder's time."""
        import numpy as np
        import torch

        from probpose_code_torch.datasets import jpeg
        from probpose_code_torch.ops.kernels.jpeg import HOST_THREADS, decode_batch, entropy_decode

        formats = sorted((GOLDEN_JPEG / "formats").glob("*.jpg"))
        golden = sorted((GOLDEN_JPEG / "golden").glob("*.jpg"), key=lambda p: int(p.stem))
        files = [p for p in formats + golden if p.stem != "truncated"]
        datas = [p.read_bytes() for p in files]
        infos = [jpeg.probe(d, str(p)) for d, p in zip(datas, files)]
        plain = [jpeg.decode(d, str(p)) for d, p in zip(datas, files)]

        def mode(p, info):
            if info.orientation > 1:
                return f"exif{info.orientation}"
            if info.progressive:
                return "progressive"
            return "restart" if p.stem == "restart" else info.sampling

        def compare(what, images, bars):
            """images: each file's (H, W, 3) uint8 array as cv2.imread returns it"""
            stats = {}
            for p, info, ref, img in zip(files, infos, plain, images):
                if img.shape != ref.shape:
                    raise AssertionError(f"jpeg_decode {what}: {p.name} shape {img.shape} against {ref.shape}")
                d = np.abs(img.astype(np.int32) - ref).ravel()
                stats.setdefault(mode(p, info), []).append(d)
                bad = {k: v for k, v in dict(max=d.max(), p99=np.percentile(d, 99), mean=d.mean()).items()
                       if v > bars[k]}
                if bad:
                    raise AssertionError(f"jpeg_decode {what}: {p.name} against the plain decoder {bad}, bars {bars}")
            for m, ds in sorted(stats.items()):
                d = np.concatenate(ds)
                print(f"jpeg_decode {what}: {m} ({len(ds)} images): |card - plain| max {d.max()}, mean "
                      f"{d.mean():.4f}, p99 {np.percentile(d, 99):.1f} grey levels")
            return max(int(np.concatenate(ds).max()) for ds in stats.values())

        decode_batch(datas[-24:], "cuda")  # larger images first: the next buffer reuses their memory
        out, shapes = decode_batch(datas, "cuda", [str(p) for p in files])
        slots = out.cpu().numpy()
        for p, (h, w), slot in zip(files, shapes, slots):
            if slot[h:].any() or slot[:, w:].any():
                raise AssertionError(f"jpeg_decode: {p.name}: pixels outside the image in its slot")
        worst = compare("port", [slot[:h, :w] for (h, w), slot in zip(shapes, slots)], EXACT_BARS)
        truncated = (GOLDEN_JPEG / "formats" / "truncated.jpg").read_bytes()
        try:
            decode_batch([truncated], "cuda", ["truncated.jpg"])
        except ValueError as e:
            print(f"jpeg_decode: the truncated stream raises: {e}")
        else:
            raise AssertionError("jpeg_decode: the truncated stream decoded without an error")

        yardstick = NvjpegBatched()
        try:
            stored = yardstick.decode(datas, infos).cpu().numpy()
            compare("nvjpeg", [jpeg.orient(slot[:i.height, :i.width], i.orientation)
                               for i, slot in zip(infos, stored)], NVJPEG_BARS)

            batch = [golden[i % 24].read_bytes() for i in range(64)]
            binfos = [jpeg.probe(d) for d in batch]
            ms = cuda_time_ms(lambda: decode_batch(batch, "cuda", infos=binfos), iters=10)
            library_ms = cuda_time_ms(lambda: yardstick.decode(batch, binfos), iters=10)
        finally:
            yardstick.close()
        for what, t in (("port", ms), ("nvjpeg", library_ms)):
            print(f"jpeg_decode {what}: {t:.3f} ms a batch of 64 golden JPEGs ({64e3 / t:.1f} images/s, "
                  f"CUDA events, host waits included)")
        names = [f"golden {i % 24 + 1}" for i in range(64)]
        mb, mpix = sum(len(d) for d in batch) / 1e6, sum(i.width * i.height for i in binfos) / 1e6
        for threads in (1, HOST_THREADS):
            entropy_decode(batch, names, threads)
            t0 = time.perf_counter()
            for _ in range(5):
                entropy_decode(batch, names, threads)
            host_ms = (time.perf_counter() - t0) * 200
            print(f"jpeg_decode host half (Huffman decode into pinned buffers, host clock), {threads} threads: "
                  f"{host_ms:.3f} ms a batch of 64 golden JPEGs ({mb:.3f} MB, {mpix:.3f} Mpixel): "
                  f"{host_ms / 64:.4f} ms a file, {host_ms / mb:.3f} ms a MB, {host_ms / mpix:.3f} ms a Mpixel")
        t0 = time.perf_counter()
        decode_batch(batch, "cpu", infos=binfos)
        plain_ms = (time.perf_counter() - t0) * 1e3
        moved = sum(len(d) for d in batch) + sum(3 * i.width * i.height for i in binfos)
        print(f"jpeg_decode: the plain decoder {plain_ms:.1f} ms for the same batch on the host; bytes in and out "
              f"{moved / 1e6:.2f} MB")
        # the port's decode is CUDA (its kernels after a host Huffman decode);
        # nvJPEG's batched decode, a library call for nearly the same function, is the yardstick
        self.record["decode"] = dict(
            name="jpeg_decode", route="cuda", source="probpose_code_torch/csrc/jpeg_decode.cu", launches=0,
            max_abs_err=float(worst), ms=ms, plain_ms=plain_ms, bound_ms=moved / PEAK_BYTES * 1e3, bound_by="bytes",
            library_ms=library_ms, library="nvjpegDecodeBatched")

    def val_full_jpeg(self):
        """``val_full`` over the golden JPEGs decoded on the card,
        against the JAX package's ``Runner.val`` on the same files
        (``run_val_jpeg``), at the JAX package's f32 bars; K1 x12, K2 x1
        and one decode for the one val batch."""
        from probpose_code_torch.ops.kernels.jpeg import decode_batch

        report, launches = run_val_jpeg("cuda", self.full_weights())
        decodes = decode_batch.launches
        self.read_norms("val_full_jpeg", False, False)
        print(f"val_full_jpeg: {report['instances']} instances through Runner.val from JPEG files; keypoint err "
              f"against the JAX Runner.val on the same files: p50 {report['p50']:.4f}, p90 {report['p90']:.4f}, "
              f"p99 {report['p99']:.4f}, max {report['max']:.4f} px; score max err {report['scores']:.5f}; AP "
              f"{report['AP']:.4f} (JAX {report['jax_AP']:.4f}, |d| {report['d_AP']:.4f}), Ex_AP "
              f"{report['Ex_AP']:.4f} (JAX {report['jax_Ex_AP']:.4f}, |d| {report['d_Ex_AP']:.4f}); decode "
              f"{report['decode_s'] * 1e3:.3f} ms (card clock), {decodes} decode launches; launches "
              f"{json.dumps(launches)}; bars {json.dumps(VAL_BARS['full'])}")
        if launches != PREDICT_LAUNCHES or decodes != 1:
            raise AssertionError(f"expected K1 x12, K2 x1 and one decode for the one val batch, got {launches} and "
                                 f"{decodes} decodes")
        if not report["ok"]:
            raise AssertionError(f"val_full_jpeg out of the bars {VAL_BARS['full']}")

    def serve(self):
        """``python -m probpose_code_torch.tools.serve``'s server
        (``tools.serve.make_server``) for the flagship config at full width
        (random weights, seed 0) on an ephemeral 127.0.0.1 port, in a thread
        that the phase always stops: 3 golden JPEGs POSTed, each answer
        equal to ``inference_topdown`` on the same file (within the card's
        run-to-run variation, ``SERVE_KPT_ATOL``), K1 x12, K2 x1 and
        one decode a request; then the latency of a request (20 after 3
        warm-up)."""
        import threading
        import urllib.request

        import numpy as np
        import torch

        from probpose_code_torch.apis import inference_topdown, init_model
        from probpose_code_torch.ops.kernels.jpeg import decode_batch
        from probpose_code_torch.tools import serve

        model = init_model(str(FLAGSHIP))
        server = serve.make_server(model, "127.0.0.1", 0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()

        def post(body):
            req = urllib.request.Request(f"http://127.0.0.1:{server.server_port}/predict", data=body, method="POST")
            with urllib.request.urlopen(req, timeout=120) as r:
                return r.status, json.loads(r.read())

        try:
            paths = [GOLDEN_JPEG / "golden" / f"{i}.jpg" for i in (1, 8, 16)]
            # the main path: counts set to 0 just before, read just after
            read_counts = reset_counts()
            answers = [post(p.read_bytes()) for p in paths]
            torch.cuda.synchronize()
            launches, decodes = read_counts(), decode_batch.launches
            self.read_norms("serve", False, False)
            expected = [serve.payload(inference_topdown(model, str(p))) for p in paths]
            per_request = {k: v / len(paths) for k, v in launches.items()}
            print(f"serve: {len(paths)} POSTed JPEGs, statuses {[a[0] for a in answers]}, launches a request "
                  f"{json.dumps(per_request)}, {decodes} decodes")
            for p, (status, answer), want in zip(paths, answers, expected):
                if status != 200 or len(answer) != len(want) or set(answer[0]) != set(want[0]):
                    raise AssertionError(f"serve: {p.name} answered {status}: {str(answer)[:300]}")
                kd = max(np.abs(np.asarray(a["keypoints"]) - b["keypoints"]).max() for a, b in zip(answer, want))
                sd = max(np.abs(np.asarray(a["keypoint_scores"]) - b["keypoint_scores"]).max()
                         for a, b in zip(answer, want))
                print(f"serve: {p.name}: the answer against inference_topdown on the file: "
                      f"{'bit-equal' if answer == want else f'keypoints {kd:.3g} px, scores {sd:.3g} apart'}")
                if kd > SERVE_KPT_ATOL or sd > SERVE_SCORE_ATOL:
                    raise AssertionError(f"serve: {p.name}'s answer is not inference_topdown's JSON (keypoints "
                                         f"{kd} px, scores {sd} apart; bars {SERVE_KPT_ATOL}, {SERVE_SCORE_ATOL})")
            if per_request != PREDICT_LAUNCHES or decodes != len(paths):
                raise AssertionError(f"serve: expected K1 x12, K2 x1 and one decode a request, got {per_request} "
                                     f"and {decodes} decodes")
            body = paths[0].read_bytes()
            for _ in range(3):
                post(body)
            lat = []
            for _ in range(20):
                t0 = time.perf_counter()
                post(body)
                lat.append((time.perf_counter() - t0) * 1e3)
            print(f"serve: {len(body)} bytes a request, one box: latency p50 {np.percentile(lat, 50):.3f} ms, max "
                  f"{max(lat):.3f} ms over 20 requests after 3 warm-up (host clock, client to answer)")
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)

    def val_full(self):
        self.val_golden("full")

    def val_shipped(self):
        self.val_golden("shipped")

    def val_flagship(self):
        """The flagship config file at full width (random weights, seed 0)
        through ``Runner.val`` with its own CombinedDataset (CropCOCO + COCO)
        and MultiDatasetEvaluator, at its batch size and worker count, over
        a synthetic set: the golden PNGs with their 62 annotations copied to
        256 instances for each sub-dataset (each copy under a new image id).
        Crops/s from the start of the loader to the metrics (all crops over
        the whole window), the time split, the device's busy share over one
        batch, and K1 / K2 launches a batch."""
        import contextlib
        import tempfile

        import torch

        from probpose_code_torch.config import Config, parse_cfg_option
        from probpose_code_torch.datasets.loader import DataLoader, stop_workers
        from probpose_code_torch.engine.runner import Runner
        from probpose_code_torch.ops.kernels.jpeg import decode_batch

        per_set = 256
        with tempfile.TemporaryDirectory() as tmp, contextlib.ExitStack() as stack:
            stack.callback(stop_workers)  # the fork server outlives a pass
            _, ann = golden_jpeg_set(tmp)
            copy_instances(ann, per_set, Path(tmp, "val.json"))
            cfg = Config.fromfile(FLAGSHIP)
            cfg.merge_from_dict(dict(parse_cfg_option(kv) for kv in flagship_data_options(tmp)))
            runner = Runner.from_cfg(cfg)
            loader_cfg = cfg["val_dataloader"]
            # the main path: counts set to 0 just before, read just after
            read_counts = reset_counts()
            metrics = runner.val()
            torch.cuda.synchronize()
            launches, decodes = read_counts(), decode_batch.launches
            self.read_norms("val_flagship", False, False)
            crops, batches = len(runner.val_dataset), len(runner.val_loader)
            self.record["decode_launches"] = decodes
            runs = [dict(runner.val_times)]
            runner.val()  # once more, with the fork server already started
            runs.append(dict(runner.val_times))
            # one batch in this process, for the profile
            batch = next(iter(DataLoader(runner.val_dataset, loader_cfg["batch_size"], num_workers=0)))
        for k, t in enumerate(runs):
            total = t["loader"] + t["device"] + t["process"] + t["evaluate"]
            print(f"val_flagship run {k + 1}: {crops} crops, {batches} batches of {loader_cfg['batch_size']}, "
                  f"{loader_cfg['num_workers']} workers (forkserver): {crops / total:.1f} crops/s from the start "
                  f"of the loader to the metrics ({total:.3f} s); split (s): wait for the first batch "
                  f"{t['first_batch']:.3f}, later loader waits {t['loader'] - t['first_batch']:.3f}, device "
                  f"{t['device']:.3f} (JPEG decode {t['decode']:.3f} of it, card clock; the issuing thread "
                  f"blocked in it {t['decode_host']:.3f}, host clock), attach+process "
                  f"{t['process']:.3f}, evaluate {t['evaluate']:.3f}")
        per_batch = {k: v / batches for k, v in launches.items()}
        print(f"val_flagship launches a batch: {json.dumps(per_batch)}, decodes {decodes / batches}")
        if decodes != batches:
            raise AssertionError(f"val_flagship: {decodes} JPEG decodes for {batches} batches")
        keys = [f"{p}/{k}" for p in ("CropCOCO", "COCO") for k in ("AP", "Ex_AP", "AR", "Ex_AR", "OKS", "Ex_OKS")]
        missing = [k for k in keys if k not in metrics]
        if crops != 2 * per_set or missing or not all(math.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"val_flagship: {crops} crops, metrics missing {missing} or not finite")
        if per_batch != PREDICT_LAUNCHES:
            raise AssertionError(f"expected K1 x12 and K2 x1 a val batch and no other kernel, got {per_batch}")

        def one_batch():
            preds = runner.model.predict(runner.device_batch(batch)["inputs"])
            return {k: v.cpu() for k, v in preds.items() if k != "heatmaps"}

        self.profile(one_batch, calls=1, what="val batches (JPEG decode and warp, predict, outputs back)")

    def train_flagship(self):
        """The flagship's training entry point at full width: the main of
        ``python -m probpose_code_torch.tools.train`` on the flagship config
        file (random weights, seed 0) with its own train pipeline, loader
        (batch 64, four workers, shuffled), optimizer, schedules, checkpoint
        hook (best by ``COCO/AP``), ``SyncBuffersHook`` and evaluator, its
        data roots pointed at the golden PNGs: the train set's 62
        annotations copied to 256 instances (4 steps an epoch), the val sets
        ``val_flagship``'s 2 x 256. Two epochs with a checkpoint each and val
        after the second, then a third resumed by ``--resume``. Fails unless
        8 steps run; ``epoch_1.pth``, ``epoch_2.pth`` and ``best.pth`` are
        written; every ``COCO/*`` and ``CropCOCO/*`` metric is present and
        finite; each step launches K3 x12 forward and x12 backward and no
        other kernel, each val batch K1 x12 and K2 x1; the first step's loss
        dict equals ``make_train_step``'s on the same batch from the same
        weights and generator seed (``TRAIN_FLAGSHIP_REL``); ``epoch_2.pth``
        in a fresh model equals the live weights bitwise; the resumed run
        starts at epoch 2, step 8, with the saved Adam moments, and ends at
        step 12 with ``lr == lr_fn(12)``. Prints each epoch's train crops/s
        (from the start of its loader to its last step) with the
        ``train_times`` split, the val inside training, and the device's busy
        share over one step profiled inside the runner."""
        import contextlib
        import tempfile

        import torch

        from probpose_code_torch.datasets.loader import stop_workers
        from probpose_code_torch.engine.checkpoint import load_checkpoint, read_checkpoint
        from probpose_code_torch.engine.hooks import Hook
        from probpose_code_torch.models.builder import PoseModel
        from probpose_code_torch.ops.kernels.jpeg import decode_batch
        from probpose_code_torch.tools import train as train_cli

        counters = kernel_counters()
        step_launches = dict(vit_layer=0, expected_oks=0, oks_convolve=0, vit_layer_train_fwd=12,
                             vit_layer_train_bwd=12, attention=0)

        class Watch(Hook):
            """The kernels launched by each step and by the val, the val's
            metrics, the state a run starts from (against a checkpoint's
            moments), and one step profiled: from the end of the step before
            it to the end of its own kernels."""

            def __init__(self, resume_from=None, profile_step=None):
                self.resume_from, self.profile_step = resume_from, profile_step
                self.steps, self.val, self.metrics, self.start, self.prof = [], None, None, None, None
                self.profiler_s = 0.0  # the profiler's start and stop inside the epoch's window

            def before_train_epoch(self, runner, epoch):
                if self.profile_step:  # the tracer's first start is slow: once here, outside the window
                    with traced():
                        torch.cuda.synchronize()

            def delta(self):
                now = {k: c.launches for k, c in counters.items()}
                prev, self.last = self.last, now
                return {k: now[k] - prev[k] for k in now}

            def before_run(self, runner):
                self.last = {k: c.launches for k, c in counters.items()}
                state = runner.state
                self.start = dict(epoch=runner.epoch, step=state.step, count=state.opt_state.count)
                if self.resume_from:
                    saved = read_checkpoint(self.resume_from)["optimizer"]
                    self.start["moments_equal"] = all(
                        torch.equal(mu.cpu(), saved["mu"][n]) and torch.equal(nu.cpu(), saved["nu"][n])
                        for n, mu, nu in zip(runner.optimizer.names, state.opt_state.mu, state.opt_state.nu))

            def after_train_iter(self, runner, step, metrics):
                self.steps.append(self.delta())
                if self.profile_step and step == self.profile_step - 1:
                    t = time.perf_counter()
                    self.prof = traced()
                    self.prof.start()
                    self.t0 = time.perf_counter()
                    self.profiler_s += self.t0 - t
                elif self.prof is not None and step == self.profile_step:
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    wall_us = (t - self.t0) * 1e6
                    self.prof.stop()
                    Smoke.report_profile(self.prof, wall_us, 1, "runner steps (the loader wait, the batch moved, "
                                                                "the step, the hooks)")
                    self.prof = None
                    self.profiler_s += time.perf_counter() - t

            def before_eval(self, runner):
                self.delta()  # nothing launches between the last step and the val

            def after_val_epoch(self, runner, metrics):
                self.val, self.metrics = self.delta(), metrics

        def report(runner, first_epoch, profiler_s=0.0):
            for e, t in enumerate(runner.train_times, start=first_epoch + 1):
                print(f"train_flagship epoch {e}: {t['crops']} crops, {t['crops'] / t['window']:.1f} train crops/s "
                      f"from the start of its loader to its last step ({t['window']:.3f} s); split (s): wait for "
                      f"the first batch {t['first_batch']:.3f}, later loader waits "
                      f"{t['loader'] - t['first_batch']:.3f}, steps {t['step']:.3f} (JPEG decode {t['decode']:.3f} "
                      f"of it, card clock; the issuing thread blocked in it {t['decode_host']:.3f}, host clock), "
                      f"hooks and logging "
                      f"{t['hooks']:.3f}" + (f" (the profiler's start and stop {profiler_s:.3f} of it)" if profiler_s
                                             else "")
                      + f"; after it: checkpoint writing {t['checkpoint']:.3f}, val {t['val']:.3f}")

        def check_val(runner, watch):
            keys = [f"{p}/{k}" for p in ("CropCOCO", "COCO") for k in ("AP", "Ex_AP", "AR", "Ex_AR", "OKS", "Ex_OKS")]
            metrics, batches = watch.metrics or {}, len(runner.val_loader)
            per_batch = {k: v / batches for k, v in (watch.val or {}).items()}
            t = runner.val_times
            print(f"train_flagship val inside training: {len(runner.val_dataset)} crops in {batches} batches, "
                  f"launches a batch {json.dumps(per_batch)}; split (s): first batch {t['first_batch']:.3f}, later "
                  f"loader waits {t['loader'] - t['first_batch']:.3f}, device {t['device']:.3f} (JPEG decode "
                  f"{t['decode']:.3f} card clock, {t['decode_host']:.3f} host clock), attach+process {t['process']:.3f}, evaluate {t['evaluate']:.3f}; "
                  + " ".join(f"{k} {metrics.get(k, float('nan')):.4f}" for k in keys))
            missing = [k for k in keys if k not in metrics]
            if missing or not all(math.isfinite(v) for v in metrics.values()):
                raise AssertionError(f"train_flagship: val metrics missing {missing} or not finite")
            if per_batch != PREDICT_LAUNCHES:
                raise AssertionError(f"expected K1 x12 and K2 x1 a val batch and no other kernel, got {per_batch}")

        with tempfile.TemporaryDirectory() as tmp, contextlib.ExitStack() as stack:
            stack.callback(stop_workers)
            _, ann = golden_jpeg_set(tmp)
            copy_instances(ann, 256, Path(tmp, "train.json"))
            copy_instances(ann, 256, Path(tmp, "val.json"))
            wd = Path(tmp, "work")
            options = flagship_data_options(tmp, "train.json") + [
                "train_cfg.val_interval=2", "default_hooks.checkpoint.interval=1", "default_hooks.logger.interval=1"]
            argv = [str(FLAGSHIP), "--work-dir", str(wd), "--cfg-options", *options]

            # the main path: counts set to 0 just before, read just after
            watch = Watch()
            read_counts = reset_counts()
            runner = train_cli.main(argv + ["train_cfg.max_epochs=2"], hooks=[watch])
            torch.cuda.synchronize()
            launches, decodes = read_counts(), decode_batch.launches
            self.read_norms("train_flagship", *norm_layers(runner.model), backward=True)
            print(f"train_flagship main path: {runner.state.step} steps of {runner.train_loader.batch_size}, "
                  f"launches {json.dumps(launches)}, JPEG decodes {decodes}")
            if decodes != runner.state.step + len(runner.val_loader):
                raise AssertionError(f"train_flagship: {decodes} JPEG decodes for {runner.state.step} steps and "
                                     f"{len(runner.val_loader)} val batches")
            report(runner, 0)
            written = sorted(p.name for p in wd.glob("*.pth"))
            if runner.state.step != 8 or written != ["best.pth", "epoch_1.pth", "epoch_2.pth"]:
                raise AssertionError(f"train_flagship: {runner.state.step} steps, checkpoints {written}")
            bad = [i for i, d in enumerate(watch.steps) if d != step_launches]
            if len(watch.steps) != 8 or bad:
                raise AssertionError(f"expected K3 x12 forward and x12 backward a step and no other kernel; steps "
                                     f"{bad} launched {[watch.steps[i] for i in bad]}")
            check_val(runner, watch)

            first_step_check("train_flagship", runner)

            cfg = runner.cfg
            fresh = PoseModel(cfg["model"], device="cuda")
            load_checkpoint(fresh, str(wd / "epoch_2.pth"))
            live, saved = runner.model.module.state_dict(), fresh.module.state_dict()
            differ = [k for k in live if not torch.equal(live[k], saved[k])]
            if differ:
                raise AssertionError(f"train_flagship: epoch_2.pth differs from the live weights in {differ[:5]}")
            print(f"train_flagship: epoch_2.pth in a fresh PoseModel equals the live weights bitwise "
                  f"({len(live)} tensors)")
            del runner, fresh, live, saved

            # a third epoch, resumed; one of its steps profiled inside the runner
            watch = Watch(resume_from=str(wd / "epoch_2.pth"), profile_step=10)
            runner = train_cli.main(argv + ["train_cfg.max_epochs=3", "--resume"], hooks=[watch])
            report(runner, 2, watch.profiler_s)
            last = runner.train_log[-1]
            print(f"train_flagship resumed: started at {json.dumps(watch.start)}; ended at step {runner.state.step} "
                  f"with lr {last['lr']:.6e} (lr_fn(12) {runner.lr_fn(12):.6e})")
            if (watch.start != dict(epoch=2, step=8, count=8, moments_equal=True) or runner.state.step != 12
                    or last["step"] != 12 or last["lr"] != runner.lr_fn(12)):
                raise AssertionError("train_flagship: the resumed epoch did not start at epoch 2, step 8, with the "
                                     "saved moments, or did not end at step 12 with lr_fn(12)")
            bad = [i for i, d in enumerate(watch.steps) if d != step_launches]
            if len(watch.steps) != 4 or bad:
                raise AssertionError(f"train_flagship resumed: steps {bad} launched {[watch.steps[i] for i in bad]}")
            check_val(runner, watch)

    def dpm_predict(self):
        """The DoubleProbPose-S config file at full width (random weights,
        seed 0; ViT-S/16 in bf16 with tanh-GELU, DoubleProbMapHead in f32)
        through ``inference_topdown``, 64 boxes with flip-TTA: K1 x12 and K2
        once (both windows in one launch) a call, the outputs' shapes and
        finiteness, two crops' maps and scalars against the same model on
        the CPU (``K1_BF16_REL``, ``DPM_SCALAR_ATOL``), then crops/s beside
        the flagship's from this run, and a profile."""
        import numpy as np
        import torch

        from probpose_code_torch.apis import inference_topdown, init_model
        from probpose_code_torch.apis.inference import crop_batch
        from probpose_code_torch.config import Config

        model = init_model(Config.fromfile(DPM), device="cuda")
        img, boxes = synthetic_boxes(64, seed=2)

        # the main path: counts set to 0 just before, read just after
        read_counts = reset_counts()
        samples = inference_topdown(model, img, boxes)
        torch.cuda.synchronize()
        launches = read_counts()
        self.read_norms("dpm_predict", False, False)
        print(f"dpm_predict main path: {len(samples)} crops, launches {json.dumps(launches)}")
        kpts = np.stack([s.pred_instances.keypoints for s in samples])
        fields = [np.stack([s.pred_instances[f] for s in samples]) for f in
                  ("keypoint_scores", "keypoints_probs", "keypoints_visible", "keypoints_oks", "keypoints_error",
                   "keypoints_conf")]
        if kpts.shape != (64, 1, 17, 2) or any(f.shape != (64, 1, 17) for f in fields):
            raise AssertionError(f"dpm_predict output shapes {kpts.shape}, {[f.shape for f in fields]}")
        if not (np.isfinite(kpts).all() and all(np.isfinite(f).all() for f in fields)):
            raise AssertionError("dpm_predict outputs are not finite")
        if launches != PREDICT_LAUNCHES:
            raise AssertionError(f"expected K1 x12 and K2 x1 (both windows) per call and no other kernel, got "
                                 f"{launches}")
        self.record["dpm_launches"] = launches
        self.record.setdefault("k1_records", {})["dpm_predict"] = k1_record(model)

        # two crops against the same model (seed-0 weights) on the CPU
        crops = crop_batch(img, boxes, model.input_size, model.device, model.cfg_full)[0][:2]
        got = {k: v.float().cpu() for k, v in model.predict(crops).items()}
        ref = init_model(Config.fromfile(DPM), device="cpu").predict(crops.cpu())
        maps = {k: ((got[k] - ref[k]).abs().max() / ref[k].abs().max()).item() for k in ("heatmaps", "out_heatmaps")}
        scalars = {k: (got[k] - ref[k]).abs().max().item() for k in
                   ("keypoints_probs", "keypoints_visible", "keypoints_oks", "keypoints_error")}
        kpt = (got["keypoints"] - ref["keypoints"]).abs().max().item()
        print(f"dpm_predict on 2 crops vs the CPU twin: maps rel max err {json.dumps(maps)} (bar {K1_BF16_REL:g}); "
              f"scalars max abs err {json.dumps(scalars)} (bar {DPM_SCALAR_ATOL:g}); keypoints max abs diff "
              f"{kpt:.3f} px (not held, nor the maps' values at them: random-weight maps are flat, and bf16 "
              f"rounding moves their argmax)")
        if not (max(maps.values()) < K1_BF16_REL and max(scalars.values()) < DPM_SCALAR_ATOL):
            raise AssertionError("dpm_predict disagrees with the CPU twin")

        iters = 10
        for _ in range(3):
            inference_topdown(model, img, boxes)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            inference_topdown(model, img, boxes)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        flagship = self.record.get("flagship_crops_s", float("nan"))
        print(f"DoubleProbPose-S predict, flip-TTA, B=64: {64 * iters / dt:.1f} crops/s "
              f"({1e3 * dt / iters:.2f} ms per inference_topdown call, {iters} calls after 3 warm-up); "
              f"ProbPose-S in this run {flagship:.1f} crops/s ({64 * iters / dt / flagship:.3f}x)")
        self.profile(lambda: inference_topdown(model, img, boxes), calls=3, what="DoubleProbPose-S predict calls")

    def dpm_train(self):
        """The DoubleProbPose-S training entry point at full width: the main
        of ``python -m probpose_code_torch.tools.train`` on its config file
        (random weights, seed 0) with its own train pipeline (both windows'
        keypoints and the bbox mask's rectangle and matrix shipped, the maps
        and the mask rendered on the card), loader, optimizer and hooks over
        the golden JPEGs, the train annotations copied to 256 instances (4
        steps), ``val_flagship``'s val sets: one epoch, a checkpoint, val.
        Fails unless 4 steps run, each launching K3 x12 forward and x12
        backward and no other kernel, each val batch K1 x12 and K2 x1, the
        metrics are finite; then the card's bbox mask of the first batch
        equals its NumPy version bit for bit, and the first step's loss dict
        equals ``make_train_step``'s on the same batch, weights and
        generator seed (``TRAIN_FLAGSHIP_REL``). Prints train crops/s."""
        import contextlib
        import tempfile

        import numpy as np
        import torch

        from probpose_code_torch.datasets.loader import stop_workers
        from probpose_code_torch.engine.hooks import Hook
        from probpose_code_torch.engine.optim import build_optimizer
        from probpose_code_torch.models.builder import PoseModel
        from probpose_code_torch.ops.bbox_mask import render_bbox_mask_numpy
        from probpose_code_torch.ops.kernels.jpeg import decode_batch
        from probpose_code_torch.parallel import create_train_state, make_train_step
        from probpose_code_torch.tools import train as train_cli

        counters = kernel_counters()
        step_launches = dict(NO_LAUNCHES, vit_layer_train_fwd=12, vit_layer_train_bwd=12)

        class Watch(Hook):
            """The kernels launched by each step and by the val, and the val's metrics."""

            def __init__(self):
                self.steps, self.val, self.metrics = [], None, None

            def delta(self):
                now = {k: c.launches for k, c in counters.items()}
                prev, self.last = self.last, now
                return {k: now[k] - prev[k] for k in now}

            def before_run(self, runner):
                self.last = {k: c.launches for k, c in counters.items()}

            def after_train_iter(self, runner, step, metrics):
                self.steps.append(self.delta())

            def before_eval(self, runner):
                self.delta()

            def after_val_epoch(self, runner, metrics):
                self.val, self.metrics = self.delta(), metrics

        with tempfile.TemporaryDirectory() as tmp, contextlib.ExitStack() as stack:
            stack.callback(stop_workers)
            _, ann = golden_jpeg_set(tmp)
            copy_instances(ann, 256, Path(tmp, "train.json"))
            copy_instances(ann, 256, Path(tmp, "val.json"))
            options = flagship_data_options(tmp, "train.json") + [
                "train_cfg.max_epochs=1", "train_cfg.val_interval=1", "default_hooks.checkpoint.interval=1",
                "default_hooks.logger.interval=1"]
            argv = [str(DPM), "--work-dir", str(Path(tmp, "work")), "--cfg-options", *options]

            # the main path: counts set to 0 just before, read just after
            watch = Watch()
            read_counts = reset_counts()
            runner = train_cli.main(argv, hooks=[watch])
            torch.cuda.synchronize()
            launches, decodes = read_counts(), decode_batch.launches
            self.read_norms("dpm_train", *norm_layers(runner.model), backward=True)
            batches = len(runner.val_loader)
            per_batch = {k: v / batches for k, v in (watch.val or {}).items()}
            t = runner.train_times[0]
            print(f"dpm_train main path: {runner.state.step} steps of {runner.train_loader.batch_size}, launches "
                  f"{json.dumps(launches)}, JPEG decodes {decodes}; val launches a batch {json.dumps(per_batch)}")
            print(f"dpm_train epoch 1: {t['crops']} crops, {t['crops'] / t['window']:.1f} train crops/s from the "
                  f"start of its loader to its last step ({t['window']:.3f} s); split (s): wait for the first batch "
                  f"{t['first_batch']:.3f}, later loader waits {t['loader'] - t['first_batch']:.3f}, steps "
                  f"{t['step']:.3f} (JPEG decode {t['decode']:.3f} of it, card clock), hooks and logging "
                  f"{t['hooks']:.3f}; after it: checkpoint writing {t['checkpoint']:.3f}, val {t['val']:.3f}")
            bad = [i for i, d in enumerate(watch.steps) if d != step_launches]
            if runner.state.step != 4 or len(watch.steps) != 4 or bad:
                raise AssertionError(f"dpm_train: {runner.state.step} steps; expected K3 x12 forward and x12 backward "
                                     f"a step and no other kernel, steps {bad} launched "
                                     f"{[watch.steps[i] for i in bad]}")
            if per_batch != PREDICT_LAUNCHES or decodes != runner.state.step + batches:
                raise AssertionError(f"dpm_train: val launches a batch {per_batch}, {decodes} JPEG decodes")
            metrics = watch.metrics or {}
            keys = [f"{p}/{k}" for p in ("CropCOCO", "COCO") for k in ("AP", "Ex_AP", "AR", "OKS")]
            if [k for k in keys if k not in metrics] or not all(math.isfinite(v) for v in metrics.values()):
                raise AssertionError(f"dpm_train: val metrics missing or not finite: {metrics}")
            logged = runner.train_log[0]
            print("dpm_train first step: " + json.dumps(logged))
            if not all(math.isfinite(v) for v in logged.values()):
                raise AssertionError("dpm_train: non-finite first step")
            self.record["dpm_train_launches"] = watch.steps[0]

            # the bbox mask of the first batch: the card's against its NumPy version
            raw = runner.train_loader.load(0, 0)
            batch = runner.model.device_preprocess_batch(runner.to_device(raw))
            want = render_bbox_mask_numpy(raw["bbox_mask_rect"], raw["bbox_mask_mat"], runner.model.input_size)
            got = batch["bbox_mask"].cpu().numpy()
            differ = int((got != want).sum())
            print(f"dpm_train bbox mask on the card, {got.shape} {got.dtype}: {differ} pixels differ from the NumPy "
                  f"version ({100 * want.mean():.1f}% of the pixels are 1)")
            if got.shape != want.shape or got.dtype != np.uint8 or differ or not 0 < want.mean() < 1:
                raise AssertionError("dpm_train: the card's bbox mask is not its NumPy version bit for bit")

            # the first step again, through make_train_step on the same batch
            cfg = runner.cfg
            model = PoseModel(cfg["model"], metainfo=runner.metainfo, device="cuda")
            model.init_weights(seed=0)
            optimizer, lr_fn = build_optimizer(model, cfg["optim_wrapper"], cfg["param_scheduler"],
                                               len(runner.train_loader), runner.max_epochs)
            state, step = create_train_state(model, optimizer), make_train_step(model, optimizer)
            gen = torch.Generator(device="cuda").manual_seed(cfg["seed"])
            state, metrics = step(state, runner.to_device(raw), gen)
            direct = {k: float(v) for k, v in metrics.items()}
            rel = {k: abs(logged[k] - v) / max(abs(v), 1e-30) for k, v in direct.items()}
            print(f"dpm_train first step: make_train_step {json.dumps(direct)}; largest relative difference from "
                  f"Runner.train's {max(rel.values()):.3e} (bar {TRAIN_FLAGSHIP_REL:g}, 1e-7 absolute at 0)")
            if any(abs(logged[k] - v) > TRAIN_FLAGSHIP_REL * abs(v) + 1e-7 for k, v in direct.items()):
                raise AssertionError(f"dpm_train: the first step's loss dict differs from make_train_step's: {rel}")
            runner.close()

        # the bare step on the prepared batch (crops, both windows' maps and the
        # mask made once), as the flagship's ``train`` phase times its step
        B = len(batch["inputs"])
        state, logs = run_steps(step, state, batch, gen, lr_fn, 2)  # warm-up: 3 steps with the one above
        report_steps(logs)
        torch.cuda.synchronize()
        steps = 5
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, logs = run_steps(step, state, batch, gen, lr_fn, steps)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        report_steps(logs)
        flagship = self.record.get("flagship_train_crops_s", float("nan"))
        print(f"DoubleProbPose-S train step, B={B}, bf16 backbone, f32 head, drop_path 0.1: {B * steps / dt:.1f} "
              f"crops/s ({1e3 * dt / steps:.2f} ms per step, {steps} steps after 3 warm-up); the flagship's step in "
              f"this run {flagship:.1f} crops/s ({B * steps / dt / flagship:.3f}x); peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

        def one():
            nonlocal state
            state, _ = run_steps(step, state, batch, gen, lr_fn, 1)

        self.profile(one, calls=2, what="DoubleProbPose-S train steps")

    def hrnet_golden(self):
        """The HRNet + UDP golden fixture on the card: ``init_model`` with
        ``tests/golden/e2e_udp_weights.pth`` (mmpose's names, loaded
        strict), ``inference_topdown``, ``CocoMetric``, at ``UDP_BARS``."""
        import torch

        from probpose_code_torch.apis import init_model

        model = init_model(UDP_FIXTURE_CFG, checkpoint=str(GOLDEN / "e2e_udp_weights.pth"), device="cuda")
        missing = set(model.module.state_dict()) ^ set(torch.load(GOLDEN / "e2e_udp_weights.pth", weights_only=True))
        read_counts = reset_counts()
        report = udp_fixture_report(model)
        launches = read_counts()
        self.read_norms("hrnet_golden", False, False)
        print(f"hrnet_golden: {json.dumps(report)}; launches {json.dumps(launches)}; bars {json.dumps(UDP_BARS)}")
        if missing or not report["ok"] or launches != NO_LAUNCHES:
            raise AssertionError(f"hrnet_golden out of its bars (keys not shared: {sorted(missing)[:3]})")

    def predict_phase(self, config, name, keys, record_key, timed_calls=5, profile_calls=2):
        """A config file's model at full width (random weights, seed 0, f32)
        through ``inference_topdown``, 64 boxes with flip-TTA: no kernel of
        the port launched, the outputs finite, two crops' ``keys`` (heatmaps
        or SimCC vectors) against the same model on the CPU (``HRNET_REL``),
        then crops/s over ``timed_calls`` calls after 2 warm-up, peak device
        memory and a profile of ``profile_calls`` calls. Returns the
        profiled call's device busy ms (None without a profile)."""
        import numpy as np
        import torch

        from probpose_code_torch.apis import inference_topdown, init_model
        from probpose_code_torch.apis.inference import crop_batch
        from probpose_code_torch.config import Config

        model = init_model(Config.fromfile(config), device="cuda")
        img, boxes = synthetic_boxes(64, seed=3)
        # the main path: counts set to 0 just before, read just after
        read_counts = reset_counts()
        samples = inference_topdown(model, img, boxes)
        torch.cuda.synchronize()
        launches = read_counts()
        self.read_gau(record_key.removesuffix("_launches"), has_gau(model))
        self.read_face_hand(record_key.removesuffix("_launches"), model)
        self.read_cnn_zoo(record_key.removesuffix("_launches"), model)
        self.read_norms(record_key.removesuffix("_launches"), False, norm_layers(model)[1])
        self.read_realnvp(record_key.removesuffix("_launches"), model)
        kpts = np.stack([s.pred_instances.keypoints for s in samples])
        scores = np.stack([s.pred_instances.keypoint_scores for s in samples])
        print(f"{record_key.removesuffix('_launches')} main path: {len(samples)} crops, launches {json.dumps(launches)}")
        if "keypoints_visible" in samples[0].pred_instances:  # a VisPredictHead's
            visible = np.stack([s.pred_instances.keypoints_visible for s in samples])
            print(f"{name} keypoints_visible {visible.shape}: mean {visible.mean():.4f}, min {visible.min():.4f}, "
                  f"max {visible.max():.4f}")
        K = model.metainfo["num_keypoints"]
        if kpts.shape != (64, 1, K, 2) or not (np.isfinite(kpts).all() and np.isfinite(scores).all()):
            raise AssertionError(f"{name} outputs {kpts.shape}, not finite")
        if launches != NO_LAUNCHES:
            raise AssertionError(f"{name} launched a kernel of the port: {launches}")
        self.record[record_key] = launches
        crops = crop_batch(img, boxes, model.input_size, model.device, model.cfg_full)[0][:2]
        got = model.predict(crops)
        ref = init_model(Config.fromfile(config), device="cpu").predict(crops.cpu())
        rel = max(((got[k].cpu() - ref[k]).abs().max() / ref[k].abs().max()).item() for k in keys)
        print(f"{name} on 2 crops vs the CPU twin: {', '.join(keys)} rel max err {rel:.3e} (bar {HRNET_REL:g})")
        if not rel < HRNET_REL:
            raise AssertionError(f"{name} disagrees with the CPU twin")
        for _ in range(2):
            inference_topdown(model, img, boxes)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(timed_calls):
            inference_topdown(model, img, boxes)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        flip = "flip-TTA" if model.aux["test_cfg"].get("flip_test") else "no flip-TTA"
        print(f"{name} predict, f32, {flip}, K={K}, B=64: {64 * timed_calls / dt:.1f} crops/s "
              f"({1e3 * dt / timed_calls:.2f} ms per inference_topdown call, {timed_calls} calls after 2 warm-up); "
              f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if profile_calls:
            return self.profile(lambda: inference_topdown(model, img, boxes), calls=profile_calls,
                                what=f"{name} predict calls")

    def train_phase(self, config, name, batch, record_key, first_lr=None):
        """A config file's recipe (its optimizer and schedules; targets
        encoded on the card from ``batch``) through ``make_train_step`` at
        full width: no kernel of the port launched, the losses, lr and
        gradient norm of each step finite (the first step's lr ``first_lr``
        where given), train crops/s over 5 steps after 3 warm-up, peak memory
        and a profile of 2 steps. Returns (model, state, step, the profiled
        step's device busy ms)."""
        import torch

        from probpose_code_torch.apis import init_model
        from probpose_code_torch.config import Config
        from probpose_code_torch.engine.optim import build_optimizer
        from probpose_code_torch.parallel import create_train_state, make_train_step

        cfg = Config.fromfile(config)
        model = init_model(cfg, device="cuda")
        optimizer, lr_fn = build_optimizer(
            model, cfg["optim_wrapper"], cfg["param_scheduler"], STEPS_PER_EPOCH, cfg["train_cfg"]["max_epochs"],
        )
        state = create_train_state(model, optimizer)
        step = make_train_step(model, optimizer)
        B = len(batch["inputs"])
        gen = torch.Generator(device="cuda").manual_seed(4)
        # the main path: counts set to 0 just before one step, read just after
        read_counts = reset_counts()
        state, logs = run_steps(step, state, batch, gen, lr_fn, 1)
        report_steps(logs)
        torch.cuda.synchronize()
        launches = read_counts()
        self.read_gau(record_key.removesuffix("_launches"), has_gau(model), backward=True)
        self.read_face_hand(record_key.removesuffix("_launches"), model, backward=True)
        self.read_cnn_zoo(record_key.removesuffix("_launches"), model, backward=True)
        self.read_norms(record_key.removesuffix("_launches"), *norm_layers(model), backward=True)
        self.read_realnvp(record_key.removesuffix("_launches"), model, backward=True)
        print(f"{record_key.removesuffix('_launches')} main path: one step of B={B}, launches {json.dumps(launches)}")
        if launches != NO_LAUNCHES:
            raise AssertionError(f"{name} train launched a kernel of the port: {launches}")
        if first_lr is not None and not math.isclose(logs[0][1], first_lr, rel_tol=1e-6):
            raise AssertionError(f"{name} train: lr {logs[0][1]} at step 0, the schedule gives {first_lr}")
        self.record[record_key] = launches
        state, logs = run_steps(step, state, batch, gen, lr_fn, 2)  # warm-up: 3 steps with the one above
        report_steps(logs)
        torch.cuda.synchronize()
        steps = 5
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, logs = run_steps(step, state, batch, gen, lr_fn, steps)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        report_steps(logs)
        print(f"{name} train step, B={B}, f32 (TF32 convolutions): {B * steps / dt:.1f} crops/s ({1e3 * dt / steps:.2f} "
              f"ms per step, {steps} steps after 3 warm-up; the loss dicts are read to the host after the timed "
              f"steps); peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

        def one():
            nonlocal state
            state, _ = run_steps(step, state, batch, gen, lr_fn, 1)

        busy_ms = self.profile(one, calls=2, what=f"{name} train steps")
        return model, state, step, busy_ms

    def hrnet_predict(self):
        """HRNet-w32 + UDP (its config file) through ``predict_phase``."""
        self.predict_phase(HRNET, "HRNet-w32 UDP", ("heatmaps",), "hrnet_launches")

    def hrnet_train(self):
        """The HRNet-w32 UDP recipe (plain Adam, LinearLR and MultiStepLR; UDP
        targets encoded on the card) through ``train_phase`` on 64 synthetic
        crops."""
        self.train_phase(HRNET, "HRNet-w32 UDP", synthetic_train_batch(64, seed=4), "hrnet_train_launches")

    def classic_golden(self):
        """The classic fixture (a narrow ResNet-50 with the DARK codec,
        ``tests/golden_torch/classic_*``) on the card: ``model_fixture_report``
        within ``UDP_BARS`` and ``FIXTURE_OUTPUT_REL``, no kernel launched."""
        self._fixture_phase(CLASSIC_FIXTURE)

    def rtmpose_golden(self):
        """The RTMPose fixture (a narrow CSPNeXt + RTMCCHead with SimCC,
        ``tests/golden_torch/rtmpose_*``) on the card, as ``classic_golden``."""
        self._fixture_phase(RTMPOSE_FIXTURE)

    def _fixture_phase(self, fixture, kernels=()):
        """``model_fixture_report`` on the card: within its bars, the
        ``kernels`` of the port launched and no other."""
        read_counts = reset_counts()
        report = model_fixture_report(fixture, device="cuda")
        launches = read_counts()
        self.read_gau(f"{fixture['name']}_golden", "keypoint_x_labels" in fixture["keys"])
        cfg = fixture["cfg"]() if callable(fixture["cfg"]) else fixture["cfg"]
        backbone = ((cfg.get("model") or {}).get("backbone") or {}) if isinstance(cfg, dict) else {}
        self.read_norms(f"{fixture['name']}_golden", False, backbone.get("type") in TRANSFORMER_BACKBONES)
        print(f"{fixture['name']}_golden: {json.dumps(report)}; launches {json.dumps(launches)}; bars "
              f"{json.dumps(UDP_BARS)}, outputs {FIXTURE_OUTPUT_REL:g}")
        if not report["ok"] or any(bool(n) != (k in kernels) for k, n in launches.items()):
            raise AssertionError(f"{fixture['name']}_golden out of its bars, or launched {launches}")

    def gau_parity(self):
        """The GAU kernels (``ops/kernels/gau.py``, ``csrc/gau.cu``) against
        their plain twin on the same inputs drawn from a seed, at each of
        ``GAU_SHAPES`` (e = 512, s = 128): the forward at ``GAU_REL``,
        and the gradients of z, gamma and beta (torch autograd through the
        twin) at ``GAU_GRAD_REL``; the backward twice, bit for bit (no
        atomics). At the shapes of ``GAU_TIMED`` (the whole-body step's, the
        record's, then face6's and hand5's), each kernel's time beside its
        twin's and its bound: the multiply-adds of its products at the
        rate of f32 products in 3xTF32, as they run (``PEAK_F32_3XTF32``),
        or its inputs read and outputs written once. The times are the
        kernels' device time a call by CUDA events, with the L2 cache
        flushed before each call and without (``queued_ms``: the profiler
        drops records, and read the backward at half its time once), the
        twin's (profiled, ``kernel_device_ms``), and the calls' CUDA-event
        times back to back. No PyTorch call
        computes the squared-ReLU attention, so there is no library time.
        Launches made here are not the main path's."""
        import numpy as np
        import torch

        from probpose_code_torch.ops.kernels.gau import gau_attention_plain, gau_backward, gau_flops, gau_forward

        e, s = 512, 128
        records = {}
        for B, n in GAU_SHAPES:
            rng = np.random.RandomState(B + n)
            z = torch.from_numpy(rng.randn(B, n, 2 * e + s).astype(np.float32)).cuda()
            gamma = torch.from_numpy(rng.rand(2, s).astype(np.float32)).cuda()
            beta = torch.from_numpy(0.1 * rng.randn(2, s).astype(np.float32)).cuda()
            dout = torch.from_numpy(rng.randn(B, n, e).astype(np.float32)).cuda()
            out, saved = gau_forward(z, gamma, beta, e, s)
            grads = gau_backward(dout, z, gamma, saved, e, s)
            again = gau_backward(dout, z, gamma, saved, e, s)
            leaves = [t.clone().requires_grad_() for t in (z, gamma, beta)]
            ref = gau_attention_plain(*leaves, e, s)
            ref_grads = torch.autograd.grad(ref, leaves, dout, retain_graph=True)

            def rel(a, b):
                return float((a - b).abs().max() / b.abs().max())

            err = dict(out=rel(out, ref.detach()), **{name: rel(g, r) for name, g, r in
                                                       zip(("dz", "dgamma", "dbeta"), grads, ref_grads)})
            deterministic = all(torch.equal(a, b) for a, b in zip(grads, again))
            print(f"gau_parity B={B} n={n} e={e} s={s}: rel max err {json.dumps(err)} (bars {GAU_REL:g} forward, "
                  f"{GAU_GRAD_REL:g} gradients); the backward repeats bit for bit: {deterministic}")
            if not (err["out"] < GAU_REL and max(err[k] for k in ("dz", "dgamma", "dbeta")) < GAU_GRAD_REL
                    and deterministic):
                raise AssertionError(f"gau_parity B={B} n={n}: the kernels disagree with the plain twin: {err}, "
                                     f"deterministic {deterministic}")
            if (B, n) not in GAU_TIMED:
                continue
            fwd_ops, bwd_ops = gau_flops(B, n, e, s)
            fwd_bytes = 4 * (z.numel() + gamma.numel() + beta.numel() + out.numel())
            bwd_bytes = 4 * (2 * z.numel() + dout.numel() + 3 * gamma.numel())  # z, gamma, dout; dz, dgamma, dbeta
            timed = dict(
                gau_forward=(lambda: gau_forward(z, gamma, beta, e, s),
                             lambda: gau_attention_plain(z, gamma, beta, e, s), fwd_ops, fwd_bytes,
                             float((out - ref.detach()).abs().max())),
                gau_backward=(lambda: gau_backward(dout, z, gamma, saved, e, s),
                              lambda: torch.autograd.grad(ref, leaves, dout, retain_graph=True), bwd_ops, bwd_bytes,
                              max(float((g - r).abs().max()) for g, r in zip(grads, ref_grads))))
            for name, (fn, plain, ops, nbytes, abs_err) in timed.items():
                need = dict(operations=ops / PEAK_F32_3XTF32, bytes=nbytes / PEAK_BYTES)
                r = dict(
                    name=name, route="cuda", source="probpose_code_torch/csrc/gau.cu",
                    ports="probpose_code_tpu/models/utils/rtmcc_block.py:99", max_abs_err=abs_err,
                    ms=Smoke.queued_ms([fn]), ms_warm=Smoke.queued_ms([fn], cold=False),
                    plain_ms=Smoke.kernel_device_ms(plain, calls=10), bound_ms=max(need.values()) * 1e3,
                    bound_by=max(need, key=need.get), library_ms=None)
                if (B, n) == GAU_TIMED[0]:
                    records[name] = dict(r, by_shape={})
                records[name]["by_shape"][f"B={B},n={n}"] = {k: r[k] for k in ("ms", "ms_warm", "plain_ms",
                                                                              "bound_ms", "bound_by", "max_abs_err")}
                print(f"  {name} B={B} n={n}: device {r['ms']:.4f} ms a call with the L2 cache flushed, "
                      f"{r['ms_warm']:.4f} without (call {cuda_time_ms(fn, 20):.4f} ms by CUDA events back to back, "
                      f"the wrapper's host work included), plain {r['plain_ms']:.4f} ms device (call "
                      f"{cuda_time_ms(plain, 10):.4f}), bound {r['bound_ms']:.4f} ms ({r['bound_by']}: "
                      f"{ops / 1e9:.3f} GFLOP, {nbytes / 1e6:.1f} MB), {r['ms'] / r['bound_ms']:.1f}x its bound, max "
                      f"abs err {abs_err:.3e}")
        self.record["gau"] = [records["gau_forward"], records["gau_backward"]]

    def wholebody_golden(self):
        """The whole-body fixture (``RTMPOSE_FIXTURE``'s narrow model with 133
        outputs, ``tests/golden_torch/wholebody_*``) on the card, as
        ``rtmpose_golden``: its AP ``CocoWholeBodyMetric``'s."""
        self._fixture_phase(WHOLEBODY_FIXTURE)

    def dpm_golden(self):
        """The DoubleProbPose-S fixture (its ViT in f32, weights from seeds,
        ``tests/golden_torch/dpm_fixture.npz``) on the card at ``UDP_BARS``,
        its four scalar outputs within the scores' bar and both windows' maps
        on two crops at ``FIXTURE_OUTPUT_REL``: K1 (its f32 instance) and K2
        (both windows in one launch at the identity scale) launched."""
        self._fixture_phase(DPM_FIXTURE, kernels=("vit_layer", "expected_oks"))

    def animal_fashion_predict(self):
        """The animal and fashion recipes (``ANIMAL_FASHION_RECIPES``) at full
        width through ``predict_phase`` (64 boxes, flip-TTA, 3 timed calls, no
        profile): HRNet-w32 and RTMPose-m on AP-10K (17 keypoints at 256 x
        256; RTMPose's GAU kernels), ResNet-50 on Animal Kingdom (23),
        DeepFashion's upper subset (6 keypoints, the subset's table),
        DeepFashion2 (294 maps of 64 x 48) and ViPNAS-Res50 with ViPNASHead
        on DeepFashion's three subsets (``VIPNAS_FASHION``)."""
        for key, config in {**ANIMAL_FASHION_RECIPES, **VIPNAS_FASHION}.items():
            keys = ("keypoint_x_labels", "keypoint_y_labels") if "rtmpose" in key else ("heatmaps",)
            self.predict_phase(config, key, keys, f"{key}_predict_launches", timed_calls=3, profile_calls=0)

    def animal_fashion_runner(self):
        """Each animal and fashion recipe through ``tools.train``'s main at its
        batch of 64 with four workers: one epoch over the golden JPEGs'
        persons copied to 128 instances in its dataset's layout (2 steps;
        ``animal_fashion_options``), val at its end over the 62 golden
        persons in the layout by the recipe's evaluator; then ``tools.test``
        on ``epoch_1.pth`` over the same persons as its test set (both
        loading in the process). Fails
        unless both steps run, no kernel of the port's TPU list launches,
        the GAU kernels launch where the model runs a GAU, one decode runs a
        step, the first loss dict equals ``make_train_step``'s, and every
        metric of the val and the test is finite (CocoMetric under AP-10K's
        sigmas, PCK at 0.05 on Animal Kingdom, PCK / AUC / EPE on
        DeepFashion)."""
        import contextlib
        import io
        import tempfile

        import torch

        from probpose_code_torch.config import Config
        from probpose_code_torch.datasets.loader import stop_workers
        from probpose_code_torch.ops.kernels.jpeg import decode_batch
        from probpose_code_torch.tools import test as test_cli
        from probpose_code_torch.tools import train as train_cli

        for key, config in ANIMAL_FASHION_RECIPES.items():
            cfg = Config.fromfile(str(config))
            path = f"{key}_train"
            with tempfile.TemporaryDirectory() as tmp, contextlib.ExitStack() as stack:
                stack.callback(stop_workers)
                _, ann = golden_jpeg_set(tmp)
                copy_instances(ann, 128, Path(tmp, "train.json"))
                options = animal_fashion_options(cfg, "train_dataloader", tmp, Path(tmp, "train.json"))
                # the val and test sets (62 persons) load in the process: a worker pool's start would take most
                # of their time
                options += animal_fashion_options(cfg, "val_dataloader", tmp, ann) + [
                    "train_dataloader.num_workers=4", "val_dataloader.num_workers=0", "train_cfg.max_epochs=1",
                    "default_hooks.logger.interval=1"]
                # the main path: counts set to 0 just before, read just after
                t0 = time.perf_counter()
                torch.cuda.reset_peak_memory_stats()
                read_counts = reset_counts()
                runner = train_cli.main([str(config), "--work-dir", str(Path(tmp, "work")), "--cfg-options",
                                         *options])
                torch.cuda.synchronize()
                launches, decodes = read_counts(), decode_batch.launches
                self.read_gau(path, has_gau(runner.model), backward=True)
                self.read_norms(path, *norm_layers(runner.model), backward=True)
                B, steps, val_batches = runner.train_loader.batch_size, runner.state.step, len(runner.val_loader)
                print(f"{path} main path: {steps} steps of {B} over {len(runner.train_loader.dataset)} instances "
                      f"({cfg['train_dataloader']['dataset']['type']}, {runner.metainfo['num_keypoints']} keypoints) "
                      f"in {time.perf_counter() - t0:.2f} s, launches {json.dumps(launches)}, JPEG decodes "
                      f"{decodes}, peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
                report_runner_epochs(path, runner, 0)
                val = [line for line in Path(tmp, "work", "train.log").read_text().splitlines() if "val: " in line]
                print(f"{path} val: {val[-1] if val else None}")
                if B != 64 or steps != 2 or launches != NO_LAUNCHES or decodes != steps + val_batches or not val:
                    raise AssertionError(f"{path}: batch {B}, {steps} steps, launches {launches}, {decodes} decodes, "
                                         f"val {val}")
                self.record[f"{path}_launches"] = launches
                first_step_check(path, runner)
                runner.close()

                test = animal_fashion_options(cfg, "test_dataloader", tmp, ann) + ["test_dataloader.num_workers=0"]
                out = io.StringIO()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(out):
                    test_cli.main([str(config), str(Path(tmp, "work", "epoch_1.pth")), "--cfg-options", *test])
                rows = (line.partition(": ") for line in out.getvalue().splitlines())
                tested = {k: float(v) for k, _, v in rows if "/" in k and " " not in k}
                print(f"{key} tools.test on epoch_1.pth over {len(json.loads(ann.read_text())['annotations'])} "
                      f"instances in {time.perf_counter() - t0:.2f} s: {json.dumps(tested)}")
                if not tested or not all(math.isfinite(v) for v in tested.values()):
                    raise AssertionError(f"{key}: tools.test gave {tested}")

    def multistage_golden(self):
        """The RTMW, hourglass, CPM and MSPN fixtures (``MULTISTAGE_FIXTURES``)
        on the card as ``classic_golden``: ``model_fixture_report`` within
        ``UDP_BARS`` and ``FIXTURE_OUTPUT_REL``, no kernel of the TPU list
        launched, the GAU kernels by RTMW alone."""
        for fixture in MULTISTAGE_FIXTURES:
            self._fixture_phase(fixture)

    def multistage_predict(self):
        """The SimCC and multi-stage recipes (``MULTISTAGE``: SimCC-ResNet-50 at
        256 x 192 and 384 x 288, SimCC-MobileNetV2, SimCC-ViPNAS-MobileNetV3,
        RTMW-m, Hourglass-52 at 256 and 384, CPM, MSPN-50, 4xMSPN-50, RSN-18,
        3xRSN-50) at full width through ``predict_phase`` (random weights,
        seed 0, 64 boxes with flip-TTA, 3 timed calls, one profiled: crops/s,
        the busy share, peak memory; the GAU kernels counted on RTMW's path,
        the depthwise on MobileNetV2's). For the two Megvii recipes
        (4xMSPN-50, RSN-18) the card's decode of two crops' flip-averaged maps
        against the CPU's decode of the same maps (``MEGVII_KPT_ATOL``,
        ``MEGVII_SCORE_REL``)."""
        import torch

        from probpose_code_torch.apis import init_model
        from probpose_code_torch.apis.inference import crop_batch
        from probpose_code_torch.config import Config
        from probpose_code_torch.ops.decode import megvii_decode_batch

        for name, config in MULTISTAGE.items():
            simcc = name.startswith(("simcc", "rtmw"))
            keys = ("keypoint_x_labels", "keypoint_y_labels") if simcc else ("heatmaps",)
            self.predict_phase(config, name, keys, f"{name}_predict_launches", timed_calls=3, profile_calls=1)
            dc = Config.fromfile(str(config))["model"]["head"]["decoder"]
            if dc["type"] != "MegviiHeatmap":
                continue
            model = init_model(Config.fromfile(str(config)), device="cuda")
            img, boxes = synthetic_boxes(2, seed=5)
            crops = crop_batch(img, boxes, model.input_size, model.device, model.cfg_full)[0]
            got = model.predict(crops)
            kpts, scores = megvii_decode_batch(got["heatmaps"].cpu(), dc["kernel_size"], model.input_size)
            err = (got["keypoints"].cpu() - kpts).abs().max().item()
            rel = ((got["keypoint_scores"].cpu() - scores).abs().max() / scores.abs().max()).item()
            print(f"{name}: the Megvii decode on the card vs the CPU on the same maps: keypoints max err {err:.3e} "
                  f"px (bar {MEGVII_KPT_ATOL:g}), scores rel {rel:.3e} (bar {MEGVII_SCORE_REL:g})")
            if not (err <= MEGVII_KPT_ATOL and rel <= MEGVII_SCORE_REL):
                raise AssertionError(f"{name}: the Megvii decode on the card disagrees with the CPU's")
            del model
            torch.cuda.empty_cache()

    def multistage_train(self):
        """The bare train steps (``train_phase``, the recipes' optimizers and
        schedules, targets encoded on the card) of Hourglass-52 at 256 x 256
        (B = 32), CPM at 256 x 192, SimCC-ResNet-50 and RTMW-m (B = 64)
        (``MULTISTAGE_TRAIN``): crops/s, peak memory and the busy share; then
        the 2% rule's candidate ops of these steps, each alone at its step's
        shapes, forward and backward (``multistage_op_shares``)."""
        import torch

        from probpose_code_torch.config import Config

        shares = self.record.setdefault("op_shares", {})
        for i, (name, B) in enumerate(MULTISTAGE_TRAIN.items()):
            config = MULTISTAGE[name]
            cfg = Config.fromfile(str(config))
            K = cfg["model"]["head"]["out_channels"]
            model, _, _, busy_ms = self.train_phase(config, name, synthetic_codec_batch(B, 41 + i, cfg["codec"], K),
                                                    f"{name}_train_launches")
            shares[name] = self.multistage_op_shares(name, busy_ms, model, B)
            del model
            torch.cuda.empty_cache()

    @staticmethod
    def multistage_op_shares(key, busy_ms, model, B):
        """The 2% rule's candidates that ``model`` runs, each alone on the card
        at the shapes one forward of ``B`` crops gives it (forward hooks),
        forward and backward, over the profiled step's device time
        ``busy_ms``: the hourglass's 2x repeat and sum (``hourglass_up``),
        CPM's concatenation of each belief map with the middle branch
        (``cpm_concat``), CSPNeXtPAFPN's nearest resize (``pafpn_resize``),
        RTMWHead's pixel shuffle (``pixel_shuffle``) and the ScaleNorms of
        the SimCC heads' tokens (``scale_norm``), and the SimCC loss
        (``KLDiscretLoss`` over both vectors, ``simcc_loss``). Returns {op:
        device ms, share %, calls}."""
        import torch
        import torch.nn.functional as F

        from probpose_code_torch.models.backbones.multistage import CPM, HourglassModule
        from probpose_code_torch.models.heads.rtmcc_head import RTMCCHead, RTMWHead, SimCCHead
        from probpose_code_torch.models.necks.necks import CSPNeXtPAFPN
        from probpose_code_torch.models.utils.rtmcc_block import ScaleNorm

        def leaf(*shape):
            return torch.randn(*shape, device=model.device).requires_grad_(True)

        cases, hooks = {}, []

        def add(op, fn, ins):
            cases.setdefault(op, []).append((fn, ins))

        def hook(m, args, out):
            if isinstance(m, HourglassModule):
                b, c, h, w = args[0].shape
                ins = leaf(b, c, h, w), leaf(b, c, h // 2, w // 2)
                add("hourglass_up", lambda ins=ins: ins[0] + ins[1][:, :, :, None, :, None].expand(
                    b, c, h // 2, 2, w // 2, 2).reshape(b, c, h, w), ins)
            elif isinstance(m, CPM):
                for belief in out[:-1]:
                    ins = leaf(*belief.shape), leaf(belief.shape[0], m.middle_conv[0][0].conv.out_channels,
                                                    *belief.shape[2:])
                    add("cpm_concat", lambda ins=ins: torch.cat(ins, dim=1), ins)
            elif isinstance(m, CSPNeXtPAFPN):
                for low, high in zip(args[0][:-1], args[0][1:]):
                    ins = (leaf(high.shape[0], m.reduce_layers[0].conv.out_channels, *high.shape[2:]),)
                    add("pafpn_resize", lambda ins=ins, size=tuple(low.shape[2:]): F.interpolate(
                        ins[0], size=size, mode="nearest-exact"), ins)
            elif isinstance(m, RTMWHead):
                ins = (leaf(*args[0][-1].shape),)
                add("pixel_shuffle", lambda ins=ins: m.shuffle(ins[0]), ins)
            elif isinstance(m, ScaleNorm):
                ins = (leaf(*args[0].shape),)
                add("scale_norm", lambda ins=ins, m=m: m(ins[0]), ins)
            if isinstance(m, (RTMCCHead, RTMWHead, SimCCHead)):
                px, py = leaf(*out[0].shape), leaf(*out[1].shape)
                tx, ty = torch.softmax(torch.randn_like(px), -1), torch.softmax(torch.randn_like(py), -1)
                w = torch.ones(px.shape[:2], device=model.device)
                loss = model.loss_modules["keypoint"]
                add("simcc_loss", lambda: loss((px, py), (tx, ty), w), (px, py))

        for m in model.module.modules():
            if isinstance(m, (HourglassModule, CPM, CSPNeXtPAFPN, RTMWHead, ScaleNorm, RTMCCHead, SimCCHead)):
                hooks.append(m.register_forward_hook(hook))
        w, h = model.input_size
        model.eval()
        with torch.no_grad():
            model.module(torch.zeros(B, h, w, 3, device=model.device))
        for handle in hooks:
            handle.remove()

        def run(calls):
            for fn, ins in calls:
                out = fn()
                torch.autograd.grad(out, ins, torch.ones_like(out))

        shares = {}
        for op, calls in cases.items():
            ms = Smoke.kernel_device_ms(lambda calls=calls: run(calls), calls=5)
            shares[op] = dict(device_ms=round(ms, 4), share=round(100 * ms / busy_ms, 2) if busy_ms else None,
                              calls=len(calls))
        print(f"{key}: the 2% rule's candidate ops alone at the step's shapes, device ms a step and % of the profiled "
              f"{busy_ms} ms of device time: {json.dumps(shares)}")
        return shares

    def rtmw_runner(self):
        """RTMW-m's recipe through ``tools.train``'s main at a batch of 64 with
        eight train workers (val and test loading in the process) over the
        cocktail14 mix made from the first 8 golden persons
        (``cocktail14_sets``: the 14 datasets' layouts, four combined
        sets, the UBody scenes a fifth; about two steps an epoch): two epochs
        across the pipeline switch (``custom_hooks.1.switch_epoch=1``), the
        EMA hook, a val pass by ``CocoWholeBodyMetric`` at the end over the 62
        golden persons in COCO-WholeBody's layout; then ``tools.test`` on
        ``epoch_2.pth``. Fails unless every step runs, no kernel of the TPU
        list launches, the GAU kernels launch (forward and backward), one
        JPEG decode runs a step, the photometric distortion runs on the card
        in the first epoch, the first loss dict equals ``make_train_step``'s,
        and every metric of the val and the test is finite."""
        import contextlib
        import io
        import tempfile

        import torch

        from probpose_code_torch.config import Config
        from probpose_code_torch.datasets.loader import stop_workers
        from probpose_code_torch.ops.kernels.jpeg import decode_batch
        from probpose_code_torch.tools import test as test_cli
        from probpose_code_torch.tools import train as train_cli

        families = [f"coco/{part}AP" for part in ("body_", "foot_", "face_", "lefthand_", "righthand_", "")]
        cfg = Config.fromfile(str(RTMW))
        with tempfile.TemporaryDirectory() as tmp, contextlib.ExitStack() as stack:
            stack.callback(stop_workers)
            _, ann = golden_jpeg_set(tmp)
            copy_instances(ann, 8, Path(tmp, "persons.json"))
            wholebody_set_from_coco(ann, Path(tmp, "val.json"))
            options = cocktail14_sets(cfg, tmp, Path(tmp, "persons.json")) + coco_data_options(tmp, workers=0) + [
                "train_dataloader.batch_size=64", "train_dataloader.num_workers=8", "train_cfg.max_epochs=2",
                "train_cfg.val_interval=2", "custom_hooks.1.switch_epoch=1", "default_hooks.logger.interval=1"]
            t0 = time.perf_counter()
            torch.cuda.reset_peak_memory_stats()
            read_counts = reset_counts()  # the main path: counts set to 0 just before, read just after
            runner = train_cli.main([str(RTMW), "--work-dir", str(Path(tmp, "work")), "--cfg-options", *options])
            torch.cuda.synchronize()
            launches, decodes = read_counts(), decode_batch.launches
            augments = {k: c.launches for k, c in augment_counters().items()}
            self.read_gau("rtmw_runner", True, backward=True)
            self.read_norms("rtmw_runner", *norm_layers(runner.model), backward=True)
            B, steps, n = runner.train_loader.batch_size, runner.state.step, len(runner.train_loader.dataset)
            print(f"rtmw_runner main path: {steps} steps of {B} over {n} instances of the cocktail14 mix in "
                  f"{time.perf_counter() - t0:.2f} s, launches {json.dumps(launches)}, JPEG decodes {decodes}, "
                  f"photometric kernels {json.dumps(augments)}, GAU kernels "
                  f"{json.dumps(self.record['gau_launches']['rtmw_runner'])}, peak device memory "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
            report_runner_epochs("rtmw_runner", runner, 0)
            log = Path(tmp, "work", "train.log").read_text()
            val = [line for line in log.splitlines() if "val: " in line]
            print(f"rtmw_runner val: {val[-1] if val else None}")
            if (B != 64 or steps != 2 * (n // B) or launches != NO_LAUNCHES or decodes != steps + len(runner.val_loader)
                    or "pipeline switch at epoch 1" not in log or not val or not augments["photometric_distortion"]):
                raise AssertionError(f"rtmw_runner: batch {B}, {steps} steps over {n}, launches {launches}, "
                                     f"{decodes} decodes, augments {augments}, val {val}")
            self.record["rtmw_runner_launches"] = launches
            first_step_check("rtmw_runner", runner)
            runner.close()

            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                test_cli.main([str(RTMW), str(Path(tmp, "work", "epoch_2.pth")), "--cfg-options",
                               *[kv.replace("val_", "test_", 1) for kv in coco_data_options(tmp, workers=0)]])
            tested = dict(line.split(": ", 1) for line in out.getvalue().splitlines() if line.startswith("coco/"))
            print(f"rtmw_runner tools.test on epoch_2.pth in {time.perf_counter() - t0:.2f} s: "
                  f"{json.dumps({k: tested.get(k) for k in families})}")
            if not all(math.isfinite(float(tested.get(k, "nan"))) for k in families):
                raise AssertionError(f"rtmw_runner: tools.test gave {tested}")

    def topdown_rest_golden(self):
        """The LiteHRNet, Swin, HRFormer and PVTv2 fixtures (``TOPDOWN_REST_FIXTURES``)
        on the card as ``classic_golden``: ``model_fixture_report`` within
        ``UDP_BARS`` and ``FIXTURE_OUTPUT_REL`` (LiteHRNet with JAX's stride-2
        padding, ``jax_same_strided``), no kernel of the TPU list launched, the
        depthwise kernels' forward by every fixture but Swin's, the
        squeeze-and-excite forward (LiteHRNet's spatial weighting) by
        LiteHRNet's alone and the LayerNorm forward by every fixture but
        LiteHRNet's (no BatchNorm kernel: evaluation mode)."""
        for fixture in TOPDOWN_REST_FIXTURES:
            self._fixture_phase(fixture)  # its counts set to 0 just before, the TPU kernels' read just after
            path = f"{fixture['name']}_golden"
            depthwise = {k: c.launches for k, c in face_hand_counters().items()}
            cnn_zoo = {k: c.launches for k, c in cnn_zoo_counters().items()}
            self.record.setdefault("face_hand_launches", {})[path] = depthwise
            self.record.setdefault("cnn_zoo_launches", {})[path] = cnn_zoo
            want_dw, want_se = fixture is not SWIN_FIXTURE, fixture is LITEHRNET_FIXTURE
            if (bool(depthwise["depthwise_forward"]) != want_dw or bool(cnn_zoo["se_layer_forward"]) != want_se
                    or depthwise["depthwise_backward"] or any(n for k, n in cnn_zoo.items() if k != "se_layer_forward")):
                raise AssertionError(f"{path}: kernel launches {depthwise}, {cnn_zoo}")

    def topdown_rest_predict(self):
        """The rest of top-down's recipes (``TOPDOWN_REST``: LiteHRNet-18 and -30
        at 256 x 192, LiteHRNet-30 at 384 x 288, Swin-T, -B, -L at 256 x 192 and
        Swin-L at 384 x 288, HRFormer-small and -base at 256 x 192 and -base at
        384 x 288, PVT-S, PVTv2-b2) at full width and depth through
        ``predict_phase`` (random weights, seed 0, 64 boxes with flip-TTA, 3
        timed calls, one profiled: crops/s, the busy share, peak memory; the
        depthwise kernels counted on the LiteHRNet, HRFormer and PVTv2 paths,
        the squeeze-and-excite kernels on LiteHRNet's)."""
        import torch

        for name, config in TOPDOWN_REST.items():
            self.predict_phase(config, name, ("heatmaps",), f"{name}_predict_launches", timed_calls=3,
                               profile_calls=1)
            torch.cuda.empty_cache()

    def topdown_rest_train(self):
        """The bare train steps (``train_phase``, MSRA targets rendered on the
        card, the recipes' optimizers and schedules) of LiteHRNet-18 (B = 64),
        Swin-T (B = 32), HRFormer-small (B = 32) and PVTv2-b2 (B = 64) at 256 x
        192 (``TOPDOWN_REST_TRAIN``): crops/s, peak memory and the busy share;
        then the 2% rule's candidate ops of these steps, each alone at its
        step's shapes, forward and backward (``topdown_rest_op_shares``)."""
        import torch

        from probpose_code_torch.config import Config

        shares = self.record.setdefault("op_shares", {})
        for i, (name, B) in enumerate(TOPDOWN_REST_TRAIN.items()):
            config = TOPDOWN_REST[name]
            model, _, _, busy_ms = self.train_phase(
                config, name, synthetic_codec_batch(B, 61 + i, Config.fromfile(str(config))["codec"]),
                f"{name}_train_launches")
            shares[name] = self.topdown_rest_op_shares(name, busy_ms, model, B)
            del model
            torch.cuda.empty_cache()

    @staticmethod
    def topdown_rest_calls(model, B):
        """The calls one forward of ``B`` crops of ``model`` (in training mode)
        makes to the ops that the 2% rule weighs in this slice's backbones, by
        name, with their arguments: the window attention core
        (``window_attention_plain``) and its layout (``windowed_attention``'s
        pad, roll and partition, and back), PVT's attention core
        (``sr_attention_plain``), the LayerNorms (``layer_norm``), GELU,
        the depthwise convs (LiteHRNet's ``depthwise``, the FFNs'
        ``depthwise_with_bias``), the nearest resizes (``resize_nearest``),
        LiteHRNet's spatial weighting (an ``SELayer``), cross-resolution weighting and channel
        split and shuffle, and BatchNorm in training mode. Each function is
        substituted by a recording one for the forward; modules by hooks."""
        import torch
        import torch.nn.functional as F

        from probpose_code_torch.models.backbones import litehrnet, transformers
        from probpose_code_torch.models.backbones.classic import SELayer
        from probpose_code_torch.models.heads.heatmap_head import BatchNorm2d

        calls = {}

        def record(op, fn, keep=lambda *args: args):
            def recording(*args, **kwargs):
                calls.setdefault(op, []).append(keep(*args))
                return fn(*args, **kwargs)
            return recording

        def shape(t):
            return torch.Size(t.shape)

        saved = [(transformers, "window_attention_plain"), (transformers, "windowed_attention"),
                 (transformers, "sr_attention_plain"), (transformers, "layer_norm"), (F, "gelu"),
                 (litehrnet, "depthwise"), (transformers, "depthwise_with_bias"), (litehrnet, "resize_nearest"),
                 (transformers, "resize_nearest")]
        saved = [(mod, name, getattr(mod, name)) for mod, name in saved]
        ops = dict(window_attention_plain="window_attention", windowed_attention="window_layout",
                   sr_attention_plain="sr_attention", layer_norm="layer_norm", gelu="gelu",
                   depthwise="depthwise", depthwise_with_bias="depthwise", resize_nearest="resize_nearest")
        keeps = dict(
            window_attention_plain=lambda q, k, v, bias, mask: (shape(q), shape(bias), mask),
            windowed_attention=lambda x, norm, attn, ws, shift, mask, dtype: (shape(x), ws, shift),
            sr_attention_plain=lambda q, k, v: (shape(q), shape(k)),
            layer_norm=lambda x, ln: (shape(x), ln), gelu=lambda x, *a: (shape(x),),
            depthwise=lambda conv, x: (shape(x), conv, False), depthwise_with_bias=lambda conv, x: (shape(x), conv, True),
            resize_nearest=lambda x, h, w: (shape(x), h, w))
        for mod, name, fn in saved:
            setattr(mod, name, record(ops[name], fn, keeps[name]))
        hooks = []
        for m in model.module.modules():
            kind = {SELayer: "spatial_weighting", litehrnet.CrossResolutionWeighting: "crw",
                    litehrnet.ConditionalChannelWeighting: "channel_split_shuffle",
                    BatchNorm2d: "batch_norm"}.get(type(m))
            if kind:
                hooks.append(m.register_forward_hook(
                    lambda m, args, out, kind=kind: calls.setdefault(kind, []).append((m, args))))
        w, h = model.input_size
        model.module.train()
        try:
            with torch.no_grad():
                model.module(torch.zeros(B, h, w, 3, device=model.device))
        finally:
            for mod, name, fn in saved:
                setattr(mod, name, fn)
            for handle in hooks:
                handle.remove()
        return calls

    @staticmethod
    def batch_norm_calls(model, B):
        """(module, shape, channels last) of each call that one forward of
        ``B`` crops of ``model`` in training mode (no gradients) makes to a
        BatchNorm that trains (``BatchNorm2d``, frozen ones left out): the
        calls that go to ``ops/kernels/batch_norm.py`` in its train step."""
        import torch

        from probpose_code_torch.models.backbones.resnet import FrozenBatchNorm2d
        from probpose_code_torch.models.heads.heatmap_head import BatchNorm2d

        calls = []

        def hook(m, args):
            if m.training:
                x = args[0]
                calls.append((m, torch.Size(x.shape),
                              x.is_contiguous(memory_format=torch.channels_last) and not x.is_contiguous()))

        hooks = [m.register_forward_pre_hook(hook) for m in model.module.modules()
                 if isinstance(m, BatchNorm2d) and not isinstance(m, FrozenBatchNorm2d)]
        w, h = model.input_size
        model.module.train()
        try:
            with torch.no_grad():
                model.module(torch.zeros(B, h, w, 3, device=model.device),
                             torch.Generator(device=model.device).manual_seed(0))
        finally:
            for handle in hooks:
                handle.remove()
        return calls

    @staticmethod
    def topdown_rest_op_shares(key, busy_ms, model, B):
        """The 2% rule's candidates of ``model``'s step (``topdown_rest_calls``),
        each op's calls of one forward run alone on the card at their shapes
        on random leaves, forward and backward, profiled
        (``kernel_device_ms``), over the profiled step's device time
        ``busy_ms``. The depthwise convs and the spatial weighting are kernels
        already (``csrc/depthwise.cu``, ``csrc/se_layer.cu``), and so are
        BatchNorm and LayerNorm since the 2% rule chose them
        (``csrc/batch_norm.cu``, ``csrc/layer_norm.cu``): their plain twins
        are timed beside them (``*_plain``), at the same calls. Returns {op:
        device ms, share %, calls}."""
        import torch
        import torch.nn.functional as F

        from probpose_code_torch.models.backbones import litehrnet, transformers
        from probpose_code_torch.models.backbones.classic import channel_shuffle
        from probpose_code_torch.ops.kernels.batch_norm import batch_norm_train_plain
        from probpose_code_torch.ops.kernels.layer_norm import layer_norm_plain

        dev = model.device

        def leaf(s):
            return torch.randn(s, device=dev).requires_grad_(True)

        def case(fn, *shapes, params=()):
            ins = [leaf(s) for s in shapes]
            return lambda: (fn(*ins), ins + [p for p in params if p.requires_grad])

        cases = {}
        for op, calls in Smoke.topdown_rest_calls(model, B).items():
            for args in calls:
                if op == "window_attention":
                    (q, bias, mask) = args
                    fn = case(lambda q, k, v, b, mask=mask: transformers.window_attention_plain(q, k, v, b, mask),
                              q, q, q, bias)
                elif op == "window_layout":
                    (s, ws, shift) = args

                    def layout(x, ws=ws, shift=shift):
                        Bx, H, W, C = x.shape
                        pb, pr = (ws - H % ws) % ws, (ws - W % ws) % ws
                        y = F.pad(x, (0, 0, 0, pr, 0, pb))
                        y = torch.roll(y, (-shift, -shift), (1, 2)) if shift else y
                        y = transformers.window_reverse(transformers.window_partition(y, ws) * 1.0, ws, H + pb, W + pr)
                        y = torch.roll(y, (shift, shift), (1, 2)) if shift else y
                        return y[:, :H, :W]
                    fn = case(layout, s)
                elif op == "sr_attention":
                    (q, k) = args
                    fn = case(transformers.sr_attention_plain, q, k, k)
                elif op == "layer_norm":
                    (s, ln) = args
                    fn = case(lambda x, ln=ln: transformers.layer_norm(x, ln), s, params=list(ln.parameters()))
                    cases.setdefault("layer_norm_plain", []).append(case(
                        lambda x, ln=ln: layer_norm_plain(x, ln.weight, ln.bias, ln.eps), s,
                        params=list(ln.parameters())))
                elif op == "gelu":
                    fn = case(F.gelu, args[0])
                elif op == "depthwise":
                    (s, conv, bias) = args
                    fn = case(lambda x, conv=conv, bias=bias: (transformers.depthwise_with_bias if bias else
                                                               litehrnet.depthwise)(conv, x), s,
                              params=list(conv.parameters()))
                elif op == "resize_nearest":
                    (s, h, w) = args
                    fn = case(lambda x, h=h, w=w: litehrnet.resize_nearest(x, h, w), s)
                elif op == "channel_split_shuffle":
                    m, (xs, _) = args
                    def shuffle(*xs, m=m):
                        x1 = [x[:, :c] for x, c in zip(xs, m.halves)]
                        x2 = [x[:, c:] * 1.0 for x, c in zip(xs, m.halves)]
                        return torch.cat([channel_shuffle(torch.cat([a, b], 1), 2).flatten() for a, b in zip(x1, x2)])
                    fn = case(shuffle, *[x.shape for x in xs])
                elif op == "crw":
                    m, (xs, dt) = args
                    fn = case(lambda *xs, m=m, dt=dt: torch.cat([y.flatten() for y in m(list(xs), dt)]),
                              *[x.shape for x in xs], params=list(m.parameters()))
                elif op == "spatial_weighting":
                    m, (x, dt) = args
                    fn = case(lambda x, m=m, dt=dt: m(x, dt), x.shape, params=list(m.parameters()))
                elif op == "batch_norm":
                    m, (x,) = args
                    fn = case(m, x.shape, params=list(m.parameters()))
                    cases.setdefault("batch_norm_plain", []).append(case(
                        lambda x, m=m: batch_norm_train_plain(x, m.weight, m.bias, m.running_mean.clone(),
                                                              m.running_var.clone(), m.momentum, m.eps), x.shape,
                        params=list(m.parameters())))
                cases.setdefault(op, []).append(fn)

        def run(fns):
            for fn in fns:
                out, ins = fn()
                torch.autograd.grad(out, ins, torch.ones_like(out))

        shares = {}
        for op, fns in cases.items():
            ms = Smoke.kernel_device_ms(lambda fns=fns: run(fns), calls=3)
            shares[op] = dict(device_ms=round(ms, 4), share=round(100 * ms / busy_ms, 2) if busy_ms else None,
                              calls=len(fns))
        print(f"{key}: the 2% rule's candidate ops alone at the step's shapes, forward and backward, device ms a step "
              f"and % of the profiled {busy_ms} ms of device time: {json.dumps(shares)}")
        return shares

    def topdown_rest_kernels(self):
        """The kernels on this slice's paths against their plain twins at those
        paths' shapes (inputs drawn from a seed): the depthwise 3x3 kernels
        (``ops/kernels/depthwise.py``) at each shape of the depthwise convs of LiteHRNet-18's
        B = 64 step (strides 1 and 2; forward at ``DEPTHWISE_REL``, the input's
        and the weight's gradients at ``DEPTHWISE_GRAD_REL``, the backward
        twice bit for bit) and with the bias added after them at the FFNs'
        depthwise convs of HRFormer-small's B = 32 and PVTv2-b2's B = 64 steps
        (``depthwise_with_bias`` against ``F.conv2d`` with the bias); the
        squeeze-and-excite kernels (``ops/kernels/se_layer.py``) at
        LiteHRNet-18's spatial weightings (``SE_LAYER_REL``,
        ``SE_LAYER_GRAD_REL``). Then the depthwise kernels' device time over
        LiteHRNet-18's step (every launch of one forward and one backward, by
        CUDA events with the L2 cache flushed before each, ``queued_ms``)
        beside cuDNN's ``F.conv2d`` at the same shapes (the twin, profiled),
        and their bound. Launches made here are not the main path's."""
        import torch
        import torch.nn.functional as F

        from probpose_code_torch.apis import init_model
        from probpose_code_torch.config import Config
        from probpose_code_torch.models.builder import full_f32_precision
        from probpose_code_torch.ops.kernels import depthwise as dw
        from probpose_code_torch.ops.kernels import se_layer

        gen = torch.Generator(device="cuda").manual_seed(23)
        t0 = time.perf_counter()

        def draw(*shape, s=1.0):  # on the card: NumPy's draws of a step's maps took over a minute
            return s * torch.randn(*shape, device="cuda", generator=gen)

        def rel(a, b):
            return float((a - b).abs().max() / b.abs().max())

        shapes = {}
        for name, B in (("litehrnet18", 64), ("swin_t", 32), ("hrformer_small", 32), ("pvtv2_b2", 64)):
            model = init_model(Config.fromfile(str(TOPDOWN_REST[name])), device="cuda")
            calls = self.topdown_rest_calls(model, B)
            # the shapes alone (and the modules), not the activations
            calls["batch_norm"] = [(m, x.shape, x.is_contiguous(memory_format=torch.channels_last)
                                    and not x.is_contiguous()) for m, (x,) in calls.get("batch_norm", [])]
            calls["spatial_weighting"] = [(m, x.shape) for m, (x, _) in calls.get("spatial_weighting", [])]
            shapes[name] = {k: v for k, v in calls.items() if k in ("batch_norm", "layer_norm", "depthwise",
                                                                      "spatial_weighting")}
            del model, calls
        for name, config in (("probpose_s", FLAGSHIP), ("rtmpose_m", RTMPOSE)):  # at their recipes' batches
            cfg = Config.fromfile(str(config))
            model = init_model(cfg, device="cuda")
            shapes[name] = dict(batch_norm=self.batch_norm_calls(model, cfg["train_dataloader"]["batch_size"]))
            del model
        torch.cuda.empty_cache()
        print(f"topdown_rest_kernels: the six steps' calls captured in {time.perf_counter() - t0:.1f} s")
        cases = []  # (x channels last, weight, bias or None, dy, stride, path)
        for name, calls in shapes.items():
            for (B, C, H, W), conv, bias in calls.get("depthwise", []):
                s = conv.stride[0]
                Ho, Wo = (H - 1) // s + 1, (W - 1) // s + 1
                cases.append((draw(B, H, W, C).permute(0, 3, 1, 2), draw(C, 1, 3, 3, s=1 / 3),
                              draw(C, s=0.1) if bias else None, draw(B, Ho, Wo, C).permute(0, 3, 1, 2), s, name))
        errors, abs_err, deterministic = dict(forward=0.0, dx=0.0, dw=0.0, db=0.0), [0.0, 0.0], True
        # each shape (stride, bias) once for the parity checks; every conv of LiteHRNet-18's step for the times
        distinct = list({(tuple(c[0].shape), c[4], c[2] is None): c for c in cases}.values())
        with full_f32_precision():
            for x, w, b, dy, s, _ in distinct:
                leaves = [t.clone().requires_grad_() for t in (x, w) + ((b,) if b is not None else ())]
                ref = F.conv2d(leaves[0], leaves[1], leaves[2] if b is not None else None, s, 1, 1, x.shape[1])
                ref_grads = torch.autograd.grad(ref, leaves, dy)
                mine = [t.clone().requires_grad_() for t in (x, w) + ((b,) if b is not None else ())]
                y = dw.depthwise_conv3x3(mine[0], mine[1], s)
                y = y + mine[2][:, None, None] if b is not None else y
                grads = torch.autograd.grad(y, mine, dy)
                again = dw.depthwise_backward(dy, x, w, s)
                errors["forward"] = max(errors["forward"], rel(y.detach(), ref.detach()))
                for key, g, r in zip(("dx", "dw", "db"), grads, ref_grads):
                    errors[key] = max(errors[key], rel(g, r))
                abs_err[0] = max(abs_err[0], float((y - ref).abs().max()))
                abs_err[1] = max(abs_err[1], *(float((g - r).abs().max()) for g, r in zip(grads, ref_grads)))
                deterministic &= torch.equal(grads[0], again[0]) and torch.equal(grads[1], again[1])
        counts = {name: sum(c[5] == name for c in cases) for name in shapes if name != "swin_t"}
        print(f"topdown_rest_kernels depthwise over the {len(distinct)} shapes of the {json.dumps(counts)} depthwise "
              f"convs of the B=64 LiteHRNet-18, "
              f"B=32 HRFormer-small and B=64 PVTv2-b2 steps (the last two with the bias after the kernel): rel max "
              f"err {json.dumps(errors)} (bars {DEPTHWISE_REL:g} forward, {DEPTHWISE_GRAD_REL:g} gradients); the "
              f"backward repeats bit for bit: {deterministic}")
        if not (errors["forward"] < DEPTHWISE_REL and max(errors["dx"], errors["dw"], errors["db"]) < DEPTHWISE_GRAD_REL
                and deterministic):
            raise AssertionError(f"topdown_rest_kernels: the depthwise kernels disagree with the twin: {errors}")

        se_cases = []
        for m, (B, C, H, W) in shapes["litehrnet18"]["spatial_weighting"]:
            mid = m.conv1["conv"].out_channels
            se_cases.append((draw(B, C, H, W), draw(mid, C, s=C ** -0.5), draw(mid, s=0.1),
                             draw(C, mid, s=mid ** -0.5), draw(C, s=0.1), draw(B, C, H, W)))
        se_err = dict(forward=0.0, gradients=0.0)
        with full_f32_precision():
            for *ins, dy in se_cases:
                out, *saved = se_layer.se_layer_forward(*ins, False)
                grads = se_layer.se_layer_backward(dy, ins[0], *saved, ins[1], ins[3], False)
                leaves = [t.clone().requires_grad_() for t in ins]
                ref = se_layer.se_layer_plain(*leaves)
                ref_grads = torch.autograd.grad(ref, leaves, dy)
                se_err["forward"] = max(se_err["forward"], rel(out, ref.detach()))
                se_err["gradients"] = max(se_err["gradients"], *(rel(g, r) for g, r in zip(grads, ref_grads)))
        print(f"topdown_rest_kernels se_layer over the {len(se_cases)} spatial weightings of LiteHRNet-18's B=64 step: "
              f"rel max err {json.dumps(se_err)} (bars {SE_LAYER_REL:g} forward, {SE_LAYER_GRAD_REL:g} gradients)")
        if not (se_err["forward"] < SE_LAYER_REL and se_err["gradients"] < SE_LAYER_GRAD_REL):
            raise AssertionError(f"topdown_rest_kernels: the se_layer kernels disagree with the twin: {se_err}")

        lite = [c for c in cases if c[5] == "litehrnet18"]
        fwd = [functools.partial(dw.depthwise_forward, x, w, s) for x, w, _, _, s, _ in lite]
        bwd = [functools.partial(dw.depthwise_backward, dy, x, w, s) for x, w, _, dy, s, _ in lite]

        def cudnn(x, w, dy, s):
            leaves = [x.detach().requires_grad_(), w.detach().requires_grad_()]
            torch.autograd.grad(dw.depthwise_conv3x3_plain(*leaves, s), leaves, dy)

        nbytes = [sum(dw.depthwise_bytes(*x.shape, s)[i] for x, _, _, _, s, _ in lite) for i in (0, 1)]
        ops = sum(2 * 9 * dy.numel() for _, _, _, dy, _, _ in lite)
        with full_f32_precision():
            ms = [Smoke.queued_ms(fwd), Smoke.queued_ms(bwd)]
            warm = [Smoke.queued_ms(fwd, cold=False), Smoke.queued_ms(bwd, cold=False)]
            library = [Smoke.kernel_device_ms(all_of([functools.partial(dw.depthwise_conv3x3_plain, x, w, s)
                                                      for x, w, _, _, s, _ in lite]), calls=10),
                       Smoke.kernel_device_ms(all_of([functools.partial(cudnn, x, w, dy, s)
                                                      for x, w, _, dy, s, _ in lite]), calls=10)]
        bound = [max(nbytes[0] / PEAK_BYTES, ops / PEAK_F32) * 1e3, max(nbytes[1] / PEAK_BYTES, 2 * ops / PEAK_F32) * 1e3]
        record = dict(convs=len(lite), forward_ms=ms[0], forward_ms_warm=warm[0], backward_ms=ms[1],
                      backward_ms_warm=warm[1], cudnn_forward_ms=library[0], cudnn_forward_backward_ms=library[1],
                      forward_bound_ms=bound[0], backward_bound_ms=bound[1], max_abs_err=abs_err)
        self.record["litehrnet_depthwise"] = record
        print(f"topdown_rest_kernels depthwise over LiteHRNet-18's B=64 step ({len(lite)} convs, summed): forward "
              f"{ms[0]:.4f} ms with the L2 cache flushed before each launch ({warm[0]:.4f} without), backward "
              f"{ms[1]:.4f} ms ({warm[1]:.4f}); cuDNN's F.conv2d at the same shapes {library[0]:.4f} ms forward, "
              f"{library[1]:.4f} ms forward and backward (profiled); bounds {bound[0]:.4f} / {bound[1]:.4f} ms "
              f"({nbytes[0] / 1e6:.1f} / {nbytes[1] / 1e6:.1f} MB over 3.35 TB/s)")
        self.norm_kernels(shapes)

    def norm_kernels(self, shapes):
        """The BatchNorm and LayerNorm kernels (``ops/kernels/batch_norm.py``,
        ``layer_norm.py``: the 2% rule's two, ``PERF.md`` §6) against their
        plain twins at the train steps' shapes (``shapes``:
        ``topdown_rest_calls`` of LiteHRNet-18 at B = 64, Swin-T and
        HRFormer-small at B = 32 and PVTv2-b2 at B = 64; ``batch_norm_calls``
        of ProbPose-S at B = 64 and RTMPose-m at B = 256), inputs drawn from a
        seed: BatchNorm at every BatchNorm of the LiteHRNet-18,
        HRFormer-small, ProbPose-S and RTMPose-m steps in their layouts (NCHW
        and channels last) and settings (CSPNeXt's eps 1e-3 and momentum
        0.03), the output and the running statistics at ``NORM_REL``, the
        gradients of the map, weight and bias (against autograd through the
        twin) at ``NORM_GRAD_REL``; LayerNorm at every LayerNorm of the
        Swin-T, HRFormer-small and PVTv2-b2 steps the same way; each shape
        (and layout and setting) once; each backward twice bit for bit. Then
        each kernel's device time summed over one step's calls of
        LiteHRNet-18 (BatchNorm) and Swin-T (LayerNorm), by CUDA events with
        the L2 cache flushed before each call (``queued_ms``), beside the
        twin's and the library call's (``F.batch_norm`` with
        ``training=True``, ``F.layer_norm``: the same functions but for the
        variance's formula; profiled; a backward's times its backward alone,
        the graphs made before the trace), and the bound: the bytes each must
        move over 3.35 TB/s. Keeps the four records for the ``norms`` line."""
        import torch
        import torch.nn.functional as F

        from probpose_code_torch.models.builder import full_f32_precision
        from probpose_code_torch.ops.kernels import batch_norm as bn
        from probpose_code_torch.ops.kernels import layer_norm as ln

        gen = torch.Generator(device="cuda").manual_seed(29)

        def draw(*shape, s=1.0, shift=0.0):  # on the card, as ``topdown_rest_kernels``'s
            return shift + s * torch.randn(*shape, device="cuda", generator=gen)

        def rel(a, b):
            return float((a - b).abs().max() / b.abs().max())

        t0 = time.perf_counter()

        def bn_case(m, shape, last, name):  # (x, w, b, running mean, running var, dy, path, momentum, eps)
            B, C, H, W = shape
            x, dy = draw(B, C, H, W, shift=0.5), draw(B, C, H, W)
            if last:
                x, dy = (t.contiguous(memory_format=torch.channels_last) for t in (x, dy))
            return (x, draw(C, s=0.2, shift=1.0), draw(C, s=0.1), draw(C, s=0.1), draw(C, s=0.1, shift=1.0).abs(),
                    dy, name, m.momentum, m.eps)

        bn_paths = ("litehrnet18", "hrformer_small", "probpose_s", "rtmpose_m")
        bn_counts = {name: len(shapes[name]["batch_norm"]) for name in bn_paths}
        # every call of LiteHRNet-18's step (timed below); each shape, layout and setting of the four steps once
        # for the parity checks
        lite = [bn_case(*c, "litehrnet18") for c in shapes["litehrnet18"]["batch_norm"]]
        bn_keys = {}
        for name in bn_paths:
            for m, shape, last in shapes[name]["batch_norm"]:
                bn_keys.setdefault((tuple(shape), last, m.momentum, m.eps), (m, shape, last, name))
        ln_cases = []  # (x, w, b, dy, eps, path)
        for name in ("swin_t", "hrformer_small", "pvtv2_b2"):
            for shape, m in shapes[name]["layer_norm"]:
                C = shape[-1]
                ln_cases.append((draw(*shape, shift=0.3), draw(C, s=0.2, shift=1.0), draw(C, s=0.1), draw(*shape),
                                 m.eps, name))
        errors = dict(bn_forward=0.0, bn_stats=0.0, bn_grads=0.0, ln_forward=0.0, ln_grads=0.0)
        abs_err = dict(batch_norm_forward=0.0, batch_norm_backward=0.0, layer_norm_forward=0.0,
                       layer_norm_backward=0.0)
        deterministic = True

        bn_distinct = [bn_case(*c) for c in bn_keys.values()]
        ln_distinct = list({tuple(c[0].shape): c for c in ln_cases}.values())  # each shape once for the parity checks
        with full_f32_precision():
            for x, w, b, rm, rv, dy, _, mom, eps in bn_distinct:
                stats = [rm.clone(), rv.clone()]
                y, mean, inv = bn.batch_norm_forward(x, w, b, *stats, mom, eps)
                grads = bn.batch_norm_backward(dy, x, w, mean, inv)
                again = bn.batch_norm_backward(dy, x, w, mean, inv)
                leaves = [t.clone().requires_grad_() for t in (x, w, b)]
                ref_stats = [rm.clone(), rv.clone()]
                ref = bn.batch_norm_train_plain(*leaves, *ref_stats, mom, eps)
                ref_grads = torch.autograd.grad(ref, leaves, dy)
                errors["bn_forward"] = max(errors["bn_forward"], rel(y, ref.detach()))
                errors["bn_stats"] = max(errors["bn_stats"], *(rel(a, r) for a, r in zip(stats, ref_stats)))
                errors["bn_grads"] = max(errors["bn_grads"], *(rel(g, r) for g, r in zip(grads, ref_grads)))
                abs_err["batch_norm_forward"] = max(abs_err["batch_norm_forward"], float((y - ref).abs().max()))
                abs_err["batch_norm_backward"] = max(abs_err["batch_norm_backward"],
                                                     *(float((g - r).abs().max()) for g, r in zip(grads, ref_grads)))
                deterministic &= all(torch.equal(g, a) for g, a in zip(grads, again))
            for x, w, b, dy, eps, _ in ln_distinct:
                y, mean, inv = ln.layer_norm_forward(x, w, b, eps)
                grads = ln.layer_norm_backward(dy, x, w, mean, inv)
                again = ln.layer_norm_backward(dy, x, w, mean, inv)
                leaves = [t.clone().requires_grad_() for t in (x, w, b)]
                ref = ln.layer_norm_plain(*leaves, eps)
                ref_grads = torch.autograd.grad(ref, leaves, dy)
                errors["ln_forward"] = max(errors["ln_forward"], rel(y, ref.detach()))
                errors["ln_grads"] = max(errors["ln_grads"], *(rel(g, r) for g, r in zip(grads, ref_grads)))
                abs_err["layer_norm_forward"] = max(abs_err["layer_norm_forward"], float((y - ref).abs().max()))
                abs_err["layer_norm_backward"] = max(abs_err["layer_norm_backward"],
                                                     *(float((g - r).abs().max()) for g, r in zip(grads, ref_grads)))
                deterministic &= all(torch.equal(g, a) for g, a in zip(grads, again))
        layouts = sum(c[0].is_contiguous(memory_format=torch.channels_last) and not c[0].is_contiguous()
                      for c in bn_distinct)
        print(f"norm_kernels over the {len(bn_distinct)} shapes and settings ({layouts} channels last) of the "
              f"BatchNorms of the B=64 LiteHRNet-18, B=32 HRFormer-small, B=64 ProbPose-S and B=256 RTMPose-m steps "
              f"({json.dumps(bn_counts)} calls) and the {len(ln_distinct)} of the "
              f"{len(ln_cases)} LayerNorms of the Swin-T, HRFormer-small and PVTv2-b2 steps "
              f"({time.perf_counter() - t0:.1f} s): "
              f"rel max err {json.dumps(errors)} (bars {NORM_REL:g} outputs and statistics, {NORM_GRAD_REL:g} "
              f"gradients); the backwards repeat bit for bit: {deterministic}")
        if not (max(errors["bn_forward"], errors["bn_stats"], errors["ln_forward"]) < NORM_REL
                and max(errors["bn_grads"], errors["ln_grads"]) < NORM_GRAD_REL and deterministic):
            raise AssertionError(f"norm_kernels: the normalisation kernels disagree with their twins: {errors}")

        del bn_distinct
        swin = [c for c in ln_cases if c[5] == "swin_t"]
        saved_bn = [bn.batch_norm_forward(x, w, b, rm.clone(), rv.clone(), mom, eps)[1:]
                    for x, w, b, rm, rv, _, _, mom, eps in lite]
        saved_ln = [ln.layer_norm_forward(x, w, b, eps)[1:] for x, w, b, _, eps, _ in swin]

        def bn_plain(grad, library):
            """A call over LiteHRNet-18's step of the twin or the library: the
            forward, or (``grad``) the backward alone, its graphs made here."""
            graphs = []
            for x, w, b, rm, rv, dy, _, mom, eps in lite:
                leaves = [t.detach().requires_grad_(grad) for t in (x, w, b)]
                y = (functools.partial(F.batch_norm, leaves[0], rm.clone(), rv.clone(), leaves[1], leaves[2], True,
                                       mom, eps) if library
                     else functools.partial(bn.batch_norm_train_plain, *leaves, rm.clone(), rv.clone(), mom, eps))
                graphs.append((y() if grad else y, leaves, dy))
            if grad:
                return lambda: [torch.autograd.grad(y, leaves, dy, retain_graph=True) for y, leaves, dy in graphs]
            return lambda: [y() for y, _, _ in graphs]

        def ln_plain(grad, library):
            """The same over Swin-T's step's LayerNorms."""
            graphs = []
            for x, w, b, dy, eps, _ in swin:
                leaves = [t.detach().requires_grad_(grad) for t in (x, w, b)]
                y = (functools.partial(F.layer_norm, leaves[0], leaves[0].shape[-1:], leaves[1], leaves[2], eps)
                     if library else functools.partial(ln.layer_norm_plain, *leaves, eps))
                graphs.append((y() if grad else y, leaves, dy))
            if grad:
                return lambda: [torch.autograd.grad(y, leaves, dy, retain_graph=True) for y, leaves, dy in graphs]
            return lambda: [y() for y, _, _ in graphs]

        bn_elements = sum(c[0].numel() for c in lite)
        bn_channels = sum(c[0].shape[1] for c in lite)
        ln_elements = sum(c[0].numel() for c in swin)
        ln_rows = sum(c[0].numel() // c[0].shape[-1] for c in swin)
        ln_channels = sum(c[0].shape[-1] for c in swin)
        bn_bytes = bn.batch_norm_bytes(bn_elements, bn_channels)
        ln_bytes = ln.layer_norm_bytes(ln_elements, ln_rows, ln_channels)
        timed = dict(
            batch_norm_forward=([functools.partial(bn.batch_norm_forward, x, w, b, rm, rv, mom, eps)
                                 for x, w, b, rm, rv, _, _, mom, eps in lite],
                                functools.partial(bn_plain, False, False), functools.partial(bn_plain, False, True), 8 * bn_elements, bn_bytes[0], "litehrnet18",
                                "probpose_code_tpu/models/backbones/resnet.py:24", "probpose_code_torch/csrc/batch_norm.cu"),
            batch_norm_backward=([functools.partial(bn.batch_norm_backward, c[5], c[0], c[1], *sv)
                                  for c, sv in zip(lite, saved_bn)], functools.partial(bn_plain, True, False),
                                 functools.partial(bn_plain, True, True),
                                 10 * bn_elements, bn_bytes[1], "litehrnet18",
                                 "probpose_code_tpu/models/backbones/resnet.py:24", "probpose_code_torch/csrc/batch_norm.cu"),
            layer_norm_forward=([functools.partial(ln.layer_norm_forward, x, w, b, eps) for x, w, b, _, eps, _ in swin],
                                functools.partial(ln_plain, False, False),
                                functools.partial(ln_plain, False, True), 8 * ln_elements, ln_bytes[0], "swin_t",
                                "probpose_code_tpu/models/backbones/transformers.py:103",
                                "probpose_code_torch/csrc/layer_norm.cu"),
            layer_norm_backward=([functools.partial(ln.layer_norm_backward, c[3], c[0], c[1], *sv)
                                  for c, sv in zip(swin, saved_ln)], functools.partial(ln_plain, True, False),
                                 functools.partial(ln_plain, True, True),
                                 10 * ln_elements, ln_bytes[1], "swin_t",
                                 "probpose_code_tpu/models/backbones/transformers.py:103",
                                 "probpose_code_torch/csrc/layer_norm.cu"))
        records = []
        for name, (fns, plain, library, ops, nbytes, path, ports, source) in timed.items():
            with full_f32_precision():
                ms, warm = Smoke.queued_ms(fns), Smoke.queued_ms(fns, cold=False)
                plain_ms = Smoke.kernel_device_ms(plain(), calls=5)
                library_ms = Smoke.kernel_device_ms(library(), calls=5)
            need = dict(operations=ops / PEAK_F32, bytes=nbytes / PEAK_BYTES)
            records.append(dict(name=name, route="cuda", source=source, ports=ports, main_path=f"{path}_train",
                                max_abs_err=abs_err[name], ms=ms, ms_warm=warm, plain_ms=plain_ms,
                                bound_ms=max(need.values()) * 1e3, bound_by=max(need, key=need.get),
                                library_ms=library_ms))
            r = records[-1]
            lib = ("F.batch_norm" if "batch" in name else "F.layer_norm") + (", its backward alone" if "backward" in name
                                                                               else "")
            print(f"  {name} over one {path} step's {len(fns)} calls: device {ms:.4f} ms with the L2 cache flushed "
                  f"before each call, {warm:.4f} without (CUDA events), plain {plain_ms:.4f} ms, library ({lib}) "
                  f"{library_ms:.4f} ms (profiled), bound {r['bound_ms']:.4f} ms ({r['bound_by']}: {nbytes / 1e6:.1f} "
                  f"MB), {ms / r['bound_ms']:.1f}x its bound, max abs err {r['max_abs_err']:.3e}")
        self.record["norm_kernels"] = records

    def topdown_rest_runner(self):
        """LiteHRNet-18's recipe through ``tools.train``'s main at its batch of 64
        with four workers: one epoch of two steps over the golden JPEGs'
        persons copied to 128 instances, val at its end over the 62 golden
        persons by ``CocoMetric``; then ``tools.test`` of Swin-T's recipe (random
        weights: no checkpoint) over the same persons. Fails unless both steps
        run, no kernel of the TPU list launches, the depthwise,
        squeeze-and-excite and BatchNorm kernels launch (forward and
        backward) and the test's LayerNorm kernel, one decode runs a step, the
        first loss dict equals ``make_train_step``'s, and the val's and the
        test's metrics are finite."""
        import io
        import tempfile

        import torch

        from probpose_code_torch.datasets.loader import stop_workers
        from probpose_code_torch.ops.kernels.jpeg import decode_batch
        from probpose_code_torch.tools import test as test_cli
        from probpose_code_torch.tools import train as train_cli

        config = TOPDOWN_REST["litehrnet18"]
        with tempfile.TemporaryDirectory() as tmp, contextlib.ExitStack() as stack:
            stack.callback(stop_workers)
            _, ann = golden_jpeg_set(tmp)
            copy_instances(ann, 128, Path(tmp, "train.json"))
            Path(tmp, "val.json").write_text(ann.read_text())
            options = coco_data_options(tmp, "train.json", workers=4) + [
                "val_dataloader.num_workers=0", "train_cfg.max_epochs=1", "train_cfg.val_interval=1",
                "default_hooks.logger.interval=1"]
            t0 = time.perf_counter()
            torch.cuda.reset_peak_memory_stats()
            read_counts = reset_counts()  # the main path: counts set to 0 just before, read just after
            runner = train_cli.main([str(config), "--work-dir", str(Path(tmp, "work")), "--cfg-options", *options])
            torch.cuda.synchronize()
            launches, decodes = read_counts(), decode_batch.launches
            self.read_face_hand("litehrnet18_runner", runner.model, backward=True)
            self.read_cnn_zoo("litehrnet18_runner", runner.model, backward=True)
            self.read_norms("litehrnet18_runner", *norm_layers(runner.model), backward=True)
            B, steps, val_batches = runner.train_loader.batch_size, runner.state.step, len(runner.val_loader)
            print(f"litehrnet18_runner main path: {steps} steps of {B} over {len(runner.train_loader.dataset)} "
                  f"instances in {time.perf_counter() - t0:.2f} s, launches {json.dumps(launches)}, JPEG decodes "
                  f"{decodes}, depthwise {json.dumps(self.record['face_hand_launches']['litehrnet18_runner'])}, "
                  f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
            report_runner_epochs("litehrnet18_runner", runner, 0)
            val = [line for line in Path(tmp, "work", "train.log").read_text().splitlines() if "val: " in line]
            print(f"litehrnet18_runner val: {val[-1] if val else None}")
            if B != 64 or steps != 2 or launches != NO_LAUNCHES or decodes != steps + val_batches or not val:
                raise AssertionError(f"litehrnet18_runner: batch {B}, {steps} steps, launches {launches}, {decodes} "
                                     f"decodes, val {val}")
            self.record["litehrnet18_runner_launches"] = launches
            first_step_check("litehrnet18_runner", runner)
            runner.close()

            config = TOPDOWN_REST["swin_t"]
            out = io.StringIO()
            t0 = time.perf_counter()
            read_counts = reset_counts()
            with contextlib.redirect_stdout(out):
                test_cli.main([str(config), "--cfg-options",
                               *[kv.replace("val_", "test_", 1) for kv in coco_data_options(tmp, workers=0)]])
            launches = read_counts()
            self.read_norms("swin_t_test", False, True)
            rows = (line.partition(": ") for line in out.getvalue().splitlines())
            tested = {k: float(v) for k, _, v in rows if k.startswith("coco/")}
            print(f"swin_t tools.test over {len(json.loads(ann.read_text())['annotations'])} instances in "
                  f"{time.perf_counter() - t0:.2f} s (random weights): {json.dumps(tested)}, launches "
                  f"{json.dumps(launches)}")
            if not tested or not all(math.isfinite(v) for v in tested.values()) or launches != NO_LAUNCHES:
                raise AssertionError(f"swin_t: tools.test gave {tested}, launches {launches}")

    def regression_golden(self):
        """The RLE, DSNT and Vis fixtures (``REGRESSION_FIXTURES``) on the card as
        ``classic_golden``: ``model_fixture_report`` within ``UDP_BARS`` and
        ``FIXTURE_OUTPUT_REL`` (the Vis fixture's visibility at the scores'
        bar), no kernel of the TPU list launched and no flow kernel (the flow
        runs in the loss alone)."""
        for fixture in REGRESSION_FIXTURES:
            self._fixture_phase(fixture)
            launches = {k: c.launches for k, c in realnvp_counters().items()}
            if any(launches.values()):
                raise AssertionError(f"{fixture['name']}_golden launched the flow kernels: {launches}")

    @staticmethod
    def realnvp_case(N, seed):
        """An RealNVP at N(0, ``REALNVP_STD``^2) weights and N residuals up to
        |10| (a quarter near 0) and a seeded gradient of the log-density, on
        the card: (flow, x, packed parameters, grad)."""
        import torch

        from probpose_code_torch.models.utils.realnvp import RealNVP

        gen = torch.Generator(device="cuda").manual_seed(seed)
        flow = RealNVP().cuda()
        with torch.no_grad():
            for p in flow.parameters():
                p.copy_(REALNVP_STD * torch.randn(p.shape, device="cuda", generator=gen))
        x = 20 * torch.rand(N, 2, device="cuda", generator=gen) - 10
        x[: N // 4] *= 0.01
        params = torch.cat([p.detach().reshape(-1) for p in flow.packed_parameters()])
        return flow, x, params, torch.rand(N, device="cuda", generator=gen) + 0.5

    def regression_kernels(self):
        """The flow kernels (``ops/kernels/realnvp.py``, ``csrc/realnvp.cu``)
        against their twin (``RealNVP.log_prob_plain`` through autograd, on the
        card, TF32 off) at the RLE steps' shapes, N = B K = 1,088 (COCO) and
        1,024 (MPII), weights at N(0, ``REALNVP_STD``^2): the log-density at
        ``REALNVP_REL``, the gradients of the residuals and of the 53,784
        parameters at ``REALNVP_GRAD_REL``, the backward twice bit for bit (no
        atomics). Then at N = 1,088 the forward's and the backward's device
        time (CUDA events, the L2 cache flushed before each call, and warm),
        the twin's (forward; backward alone, its graph made first; profiled),
        and the bound: the operations over 67 TFLOP/s f32 or the bytes over
        3.35 TB/s. No library call computes the flow (``library_ms`` null).
        Appends the two records to the kernels line; their launches are those
        of ``rle_res50_train``'s main path."""
        import torch

        from probpose_code_torch.models.builder import full_f32_precision
        from probpose_code_torch.ops.kernels import realnvp

        def rel(a, b):
            return float((a - b).abs().max() / b.abs().max())

        errors = dict(forward=0.0, dx=0.0, dparams=0.0)
        abs_err = dict(realnvp_forward=0.0, realnvp_backward=0.0)
        deterministic = True
        with full_f32_precision():
            for N in (1088, 1024):
                flow, x, params, grad = self.realnvp_case(N, seed=31 + N)
                logp, zs = realnvp.realnvp_forward(x, params)
                dx, dparams = realnvp.realnvp_backward(grad, zs, params)
                again = realnvp.realnvp_backward(grad, zs, params)
                deterministic &= torch.equal(dx, again[0]) and torch.equal(dparams, again[1])
                xt = x.clone().requires_grad_()
                ref = flow.log_prob_plain(xt)
                ref_grads = torch.autograd.grad(ref, [xt, *flow.packed_parameters()], grad)
                ref_dparams = torch.cat([g.reshape(-1) for g in ref_grads[1:]])
                errors["forward"] = max(errors["forward"], rel(logp, ref.detach()))
                errors["dx"] = max(errors["dx"], rel(dx, ref_grads[0]))
                # each parameter array against its own largest gradient
                at = 0
                for g in ref_grads[1:]:
                    errors["dparams"] = max(errors["dparams"], rel(dparams[at:at + g.numel()], g.reshape(-1)))
                    at += g.numel()
                abs_err["realnvp_forward"] = max(abs_err["realnvp_forward"], float((logp - ref.detach()).abs().max()))
                abs_err["realnvp_backward"] = max(abs_err["realnvp_backward"], float((dx - ref_grads[0]).abs().max()),
                                                  float((dparams - ref_dparams).abs().max()))
                with torch.no_grad():
                    s_max = max(float(flow.s[i](flow.mask[i] * x).abs().max()) for i in range(6))
                    top = float(ref.abs().max())
        print(f"regression_kernels: the flow at N = 1,088 and 1,024 (weights N(0, {REALNVP_STD}^2), |x| up to 10, "
              f"|s| up to {s_max:.3f}, |log-density| up to {top:.1f} at N = 1,024): rel max err "
              f"{json.dumps(errors)} (bars {REALNVP_REL:g} forward, {REALNVP_GRAD_REL:g} gradients, each array to its "
              f"largest); max abs err {json.dumps(abs_err)}; the backward repeats bit for bit: {deterministic}")
        if not (errors["forward"] < REALNVP_REL and max(errors["dx"], errors["dparams"]) < REALNVP_GRAD_REL
                and deterministic):
            raise AssertionError(f"regression_kernels: the flow kernels disagree with the twin: {errors}")

        flow, x, params, grad = self.realnvp_case(1088, seed=7)
        _, zs = realnvp.realnvp_forward(x, params)
        xt = x.clone().requires_grad_()
        graph = flow.log_prob_plain(xt)
        leaves = [xt, *flow.packed_parameters()]
        flops, nbytes = realnvp.realnvp_flops(1088), realnvp.realnvp_bytes(1088)
        timed = dict(
            realnvp_forward=(lambda: realnvp.realnvp_forward(x, params), lambda: flow.log_prob_plain(x),
                             flops[0], nbytes[0]),
            realnvp_backward=(lambda: realnvp.realnvp_backward(grad, zs, params),
                              lambda: torch.autograd.grad(graph, leaves, grad, retain_graph=True), flops[1], nbytes[1]))
        launches = self.record.get("realnvp_launches", {})
        for name, (fn, plain, ops, moved) in timed.items():
            with full_f32_precision():
                ms, warm = Smoke.queued_ms([fn]), Smoke.queued_ms([fn], cold=False)
                plain_ms = Smoke.kernel_device_ms(plain, calls=5)
            need = dict(operations=ops / PEAK_F32, bytes=moved / PEAK_BYTES)
            record = dict(name=name, route="cuda", source="probpose_code_torch/csrc/realnvp.cu",
                          replaces="none: no TPU kernel (the JAX flow, probpose_code_tpu/models/utils/realnvp.py:37, "
                                   "runs in XLA)",
                          launches=launches.get("rle_res50_train", {}).get(name, 0), max_abs_err=abs_err[name], ms=ms,
                          ms_warm=warm, plain_ms=plain_ms, bound_ms=max(need.values()) * 1e3,
                          bound_by=max(need, key=need.get), library_ms=None,
                          launches_by_path={path: n[name] for path, n in launches.items()})
            self.record.setdefault("kernels", []).append(record)
            print(f"  {name} at N = 1,088: device {ms:.4f} ms with the L2 cache flushed, {warm:.4f} warm (CUDA events), "
                  f"twin {plain_ms:.4f} ms ({'its backward alone, ' if 'backward' in name else ''}profiled), bound "
                  f"{record['bound_ms']:.5f} ms ({record['bound_by']}: {ops / 1e6:.1f} MFLOP, {moved / 1e6:.3f} MB), "
                  f"{ms / record['bound_ms']:.0f}x its bound, {plain_ms / ms:.1f}x faster than the twin; no library "
                  f"call computes the flow")

    def regression_predict(self):
        """The regression recipes (``REGRESSION``: plain regression ResNet-50 on
        COCO and MPII, their heads pooling the backbone's map; RLE-ResNet-50,
        RLE-ResNet-152 at 384 x 288, RLE-MobileNetV2; IPR-ResNet-50 at 192 x
        256, DSNT-debias-ResNet-50 at 256 x 256; Vis-ResNet-50) at full width
        and depth through ``predict_phase`` (random weights, seed 0, 64 boxes
        with flip-TTA, 3 timed calls, one profiled: crops/s, the busy share,
        peak memory; the keypoints, and the Vis head's visibility, against the
        CPU; no flow kernel: the flow runs in the loss alone)."""
        import torch

        for name, config in REGRESSION.items():
            keys = ("keypoints", "keypoints_visible") if name.startswith("vis") else ("keypoints",)
            self.predict_phase(config, name, keys, f"{name}_predict_launches", timed_calls=3, profile_calls=1)
            torch.cuda.empty_cache()

    def regression_train(self):
        """The bare train steps (``train_phase``, the recipes' optimizers and
        schedules, targets encoded on the card) at B = 64 of RLE-ResNet-50 at
        256 x 192, RLE-MobileNetV2 at 192 x 256, Vis-ResNet-50 at 256 x 192 and
        the plain regression ResNet-50 (``REGRESSION_TRAIN``): crops/s, peak
        memory, the busy share and the kernels a step. The RLE steps' kernels
        a step with the flow's twin in their place (``RealNVP.forward`` set to
        ``log_prob_plain`` for that profile alone). Then the 2% rule's
        candidate ops of these steps, each alone at its step's shapes, forward
        and backward (``regression_op_shares``)."""
        import torch

        from probpose_code_torch.config import Config
        from probpose_code_torch.models.utils.realnvp import RealNVP

        shares = self.record.setdefault("op_shares", {})
        for i, name in enumerate(REGRESSION_TRAIN):
            cfg = Config.fromfile(str(REGRESSION[name]))
            head = cfg["model"]["head"]
            codec = head["pose_cfg"]["decoder"] if head["type"] == "VisPredictHead" else head["decoder"]
            batch = synthetic_codec_batch(64, 71 + i, codec, K=17)
            model, state, step, busy_ms = self.train_phase(REGRESSION[name], name, batch, f"{name}_train_launches")
            if model.head_type == "RLEHead":
                gen = torch.Generator(device="cuda").manual_seed(5)
                forward = RealNVP.forward
                RealNVP.forward = RealNVP.log_prob_plain
                try:
                    run_steps(step, state, batch, gen, lambda s: 0.0, 1)  # warm-up
                    torch.cuda.synchronize()
                    self.profile(lambda: run_steps(step, state, batch, gen, lambda s: 0.0, 1), calls=2,
                                 what=f"{name} train steps with the flow's twin")
                finally:
                    RealNVP.forward = forward
            shares[name] = self.regression_op_shares(name, busy_ms, model, batch)
            del model, state, step
            torch.cuda.empty_cache()

    @staticmethod
    def regression_op_shares(key, busy_ms, model, batch):
        """The 2% rule's candidates of a regression step, each alone on the
        card at the shapes the step gives it, forward and backward, over the
        profiled step's device time ``busy_ms``: the flow (``RealNVP`` on the
        B K residuals: the kernels, and the twin), RLELoss (its elementwise
        terms and the flow kernels), the head's pooling and ``fc`` on the
        backbone's map, the Vis head's visibility branch and its
        ``BCELoss``, the wrapped heatmap head's ``KeypointMSELoss``, and the
        targets' encode on the card (forward). Returns {op: device ms,
        share %, calls}."""
        import torch

        B = batch["inputs"].shape[0]
        with torch.no_grad():
            feats = model.module.backbone(model.preprocess(batch["inputs"][:1]).permute(0, 3, 1, 2))
        C, h, w = feats[-1].shape[1:] if isinstance(feats, (tuple, list)) else feats.shape[1:]
        head = model.module.head
        K = 17

        def leaf(*shape, s=1.0):
            return (s * torch.randn(*shape, device="cuda")).requires_grad_()

        cases = {}
        if model.head_type == "RLEHead":
            flow = head.loss.flow_model
            x = leaf(B * K, 2, s=3.0)
            cases["flow"] = (lambda: flow(x), [x, *flow.parameters()])
            cases["flow_plain"] = (lambda: flow.log_prob_plain(x), [x, *flow.parameters()])
            pred, sigma = leaf(B, K, 2, s=0.3), leaf(B, K, 2)
            labels, weights = torch.rand(B, K, 2, device="cuda"), batch["keypoint_weights"]
            loss = model.loss_modules["keypoint"]
            cases["rle_loss"] = (lambda: loss(pred, sigma, labels, weights, log_phi_fn=head.log_phi),
                                 [pred, sigma, *flow.parameters()])
        if model.head_type in ("RLEHead", "RegressionHead"):
            maps = leaf(B, C, h, w)
            cases["pool_fc"] = (lambda: head(maps), [maps, *head.fc.parameters()])
        if model.head_type == "VisPredictHead":
            maps = leaf(B, C, h, w)
            target = batch["keypoint_weights"]
            vis_loss = model.loss_modules["vis"]
            cases["vis_branch"] = (lambda: vis_loss(head.vis_head(maps), target, torch.ones_like(target)),
                                   [maps, *head.vis_head.parameters()])
            hm = leaf(B, K, 64, 48)
            gt = torch.rand(B, K, 64, 48, device="cuda")
            cases["heatmap_loss"] = (lambda: model.loss_modules["keypoint"](hm, gt, target), [hm])
        encode = {k: v for k, v in batch.items() if k != "inputs"}
        cases["encode"] = (lambda: model.device_preprocess_batch(dict(encode)), None)

        def run(fn, ins):
            out = fn()
            if ins is not None:
                torch.autograd.grad(out, ins, torch.ones_like(out), allow_unused=True)

        shares = {}
        for op, (fn, ins) in cases.items():
            ms = Smoke.kernel_device_ms(lambda fn=fn, ins=ins: run(fn, ins), calls=5)
            shares[op] = dict(device_ms=round(ms, 4), share=round(100 * ms / busy_ms, 2) if busy_ms else None, calls=1)
        print(f"{key}: the 2% rule's candidate ops alone at the step's shapes, forward and backward, device ms a step "
              f"and % of the profiled {busy_ms} ms of device time: {json.dumps(shares)}")
        return shares

    def regression_runner(self):
        """The entry points: ``tools.train`` of RLE-ResNet-50's recipe at its
        batch of 64 with four workers, one epoch of two steps over the golden
        JPEGs' persons copied to 128 instances and val at its end by
        ``CocoMetric`` over the 62 golden persons (the flow kernels launched,
        the first loss dict equal to ``make_train_step``'s); ``tools.test``
        of the PoseTrack18 HRNet-w32 recipe (random weights) over the golden
        images as three videos (``posetrack_set``: detections, a frame
        without ground truth), which prints ``PoseTrack18Metric``'s table;
        ``tools.test`` of the DSNT-debias recipe over the golden persons; and
        ``tools.train`` of that recipe, which must fail with the port's
        refusal by name and nothing else. Fails unless every metric printed
        is finite."""
        import io
        import tempfile

        import torch

        from probpose_code_torch.datasets.loader import stop_workers
        from probpose_code_torch.models.builder import UNTRAINED_HEADS
        from probpose_code_torch.tools import test as test_cli
        from probpose_code_torch.tools import train as train_cli

        def tested(config, options, path):
            out = io.StringIO()
            t0 = time.perf_counter()
            read_counts = reset_counts()
            with contextlib.redirect_stdout(out):
                test_cli.main([str(config), "--cfg-options", *options])
            launches = read_counts()
            rows = (line.partition(": ") for line in out.getvalue().splitlines())
            metrics = {k: float(v) for k, _, v in rows if k.startswith("coco/")}
            print(f"{path} tools.test in {time.perf_counter() - t0:.2f} s (random weights): {json.dumps(metrics)}, "
                  f"launches {json.dumps(launches)}")
            if not metrics or not all(math.isfinite(v) for v in metrics.values()) or launches != NO_LAUNCHES:
                raise AssertionError(f"{path}: tools.test gave {metrics}, launches {launches}")
            return metrics

        config = REGRESSION["rle_res50"]
        with tempfile.TemporaryDirectory() as tmp, contextlib.ExitStack() as stack:
            stack.callback(stop_workers)
            _, ann = golden_jpeg_set(tmp)
            copy_instances(ann, 128, Path(tmp, "train.json"))
            Path(tmp, "val.json").write_text(ann.read_text())
            options = coco_data_options(tmp, "train.json", workers=4) + [
                "val_dataloader.num_workers=0", "train_cfg.max_epochs=1", "train_cfg.val_interval=1",
                "default_hooks.logger.interval=1"]
            t0 = time.perf_counter()
            torch.cuda.reset_peak_memory_stats()
            read_counts = reset_counts()  # the main path: counts set to 0 just before, read just after
            runner = train_cli.main([str(config), "--work-dir", str(Path(tmp, "work")), "--cfg-options", *options])
            torch.cuda.synchronize()
            launches = read_counts()
            self.read_realnvp("rle_res50_runner", runner.model, backward=True)
            self.read_norms("rle_res50_runner", *norm_layers(runner.model), backward=True)
            B, steps = runner.train_loader.batch_size, runner.state.step
            print(f"rle_res50_runner main path: {steps} steps of {B} over {len(runner.train_loader.dataset)} "
                  f"instances in {time.perf_counter() - t0:.2f} s, launches {json.dumps(launches)}, flow kernels "
                  f"{json.dumps(self.record['realnvp_launches']['rle_res50_runner'])}, peak device memory "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
            report_runner_epochs("rle_res50_runner", runner, 0)
            val = [line for line in Path(tmp, "work", "train.log").read_text().splitlines() if "val: " in line]
            print(f"rle_res50_runner val: {val[-1] if val else None}")
            if B != 64 or steps != 2 or launches != NO_LAUNCHES or not val:
                raise AssertionError(f"rle_res50_runner: batch {B}, {steps} steps, launches {launches}, val {val}")
            first_step_check("rle_res50_runner", runner)
            runner.close()

            tested(REGRESSION["dsnt_debias_res50"],
                   [kv.replace("val_", "test_", 1) for kv in coco_data_options(tmp, workers=0)], "dsnt_debias_res50")
            try:
                train_cli.main([str(REGRESSION["dsnt_debias_res50"]), "--work-dir", str(Path(tmp, "work_dsnt")),
                                "--cfg-options", *options])
            except NotImplementedError as e:
                if str(e) != UNTRAINED_HEADS["DSNTHead"]:
                    raise
                print(f"dsnt_debias_res50 tools.train refused by name: {e}")
            else:
                raise AssertionError("dsnt_debias_res50: tools.train ran; the port refuses to train the integral heads")

        with tempfile.TemporaryDirectory() as tmp:
            options = posetrack_set(tmp) + ["test_dataloader.num_workers=0"]
            metrics = tested(POSETRACK, options, "posetrack18_hrnet_w32")
            table = {k: v for k, v in metrics.items() if not k.startswith(("coco/coco_", "coco/vis_", "coco/prob_",
                                                                              "coco/score_"))}
            print(f"posetrack18_hrnet_w32 PoseTrack18Metric table over {POSETRACK_VIDEOS} videos: {json.dumps(table)}")
            if [k for k in table] != [f"coco/{k} AP" for k in ("Head", "Shou", "Elb", "Wri", "Hip", "Knee", "Ankl")] \
                    + ["coco/AP"]:
                raise AssertionError(f"posetrack18_hrnet_w32: the table's stats {list(table)}")

    def cnn_zoo_golden(self):
        """The SCNet-50 and ViPNAS fixtures (``CNN_ZOO_FIXTURES``) on the card
        as ``classic_golden``: ``model_fixture_report`` within ``UDP_BARS`` and
        ``FIXTURE_OUTPUT_REL``, no kernel of the TPU list launched, SCNet's
        gate forward launched by the SCNet fixture alone and the
        squeeze-and-excite forward by the ViPNAS one alone."""
        for fixture in CNN_ZOO_FIXTURES:
            self._fixture_phase(fixture)  # its counts set to 0 just before, the TPU kernels' read just after
            launches = {k: c.launches for k, c in cnn_zoo_counters().items()}
            self.record.setdefault("cnn_zoo_launches", {})[f"{fixture['name']}_golden"] = launches
            forward = "sc_gate_forward" if fixture is SCNET_FIXTURE else "se_layer_forward"
            if not launches[forward] or any(n for k, n in launches.items() if k != forward):
                raise AssertionError(f"{fixture['name']}_golden: the CNN backbones' kernels launched {launches}")

    def cnn_zoo_predict(self):
        """The ResNet-like and small CNN recipes (``CNN_ZOO``: ResNetV1d-50,
        ResNeXt-50, SEResNet-50, SCNet-50, ResNeSt-50, ShuffleNetV2, VGG16-bn
        and ViPNAS-Res50 on COCO, ViPNAS-Res50 on COCO-WholeBody) at full
        width through ``predict_phase`` (random weights, seed 0, 64 boxes
        with flip-TTA, 3 timed calls, one profiled: crops/s, the busy share,
        peak memory); then the channel shuffle's share of ShuffleNetV2's
        predict call (``cnn_zoo_op_shares``)."""
        shares = self.record.setdefault("op_shares", {})
        for name, config in CNN_ZOO.items():
            busy_ms = self.predict_phase(config, name, ("heatmaps",), f"{name}_predict_launches", timed_calls=3,
                                         profile_calls=1)
            if name == "shufflenetv2":
                from probpose_code_torch.apis import init_model
                from probpose_code_torch.config import Config

                model = init_model(Config.fromfile(str(config)), device="cuda")
                shares[name] = self.cnn_zoo_op_shares(name, busy_ms, model, backward=False)
                del model

    def cnn_zoo_train(self):
        """The bare train steps (``train_phase``, B = 64, MSRA targets
        rendered on the card, the recipes' Adam and schedules) of SCNet-50,
        ResNeSt-50 and ViPNAS-Res50 (``CNN_ZOO_TRAIN``): crops/s, peak memory
        and the busy share; then the 2% rule's candidate ops of these steps,
        each alone at its step's shapes, forward and backward
        (``cnn_zoo_op_shares``)."""
        from probpose_code_torch.config import Config

        shares = self.record.setdefault("op_shares", {})
        for i, name in enumerate(CNN_ZOO_TRAIN):
            config = CNN_ZOO[name]
            model, _, _, busy_ms = self.train_phase(
                config, name, synthetic_codec_batch(64, 21 + i, Config.fromfile(str(config))["codec"]),
                f"{name}_train_launches")
            shares[name] = self.cnn_zoo_op_shares(name, busy_ms, model)
            del model

    def cnn_zoo_kernels(self):
        """The CNN backbones' kernels against their plain twins on inputs drawn
        from a seed, at the shapes of their B = 64 train steps
        (``cnn_zoo_shapes``): SCNet's gate (``ops/kernels/sc_gate.py``,
        ``csrc/sc_gate.cu``) at SCNet-50's 16 gates and ResNeSt's split
        attention (``ops/kernels/split_attention.py``,
        ``csrc/split_attention.cu``) at ResNeSt-50's 16 blocks: the forward at
        ``SC_GATE_REL`` / ``SPLIT_ATTENTION_REL``, every input's gradient at
        ``SC_GATE_GRAD_REL`` / ``SPLIT_ATTENTION_GRAD_REL`` (against autograd
        through the twin), the backward twice bit for bit. Then each kernel's
        device time summed over its shapes (a step's worth,
        ``kernel_device_ms``) beside the twin's, and the bound: the bytes each
        must move (``sc_gate_bytes``, ``split_attention_bytes``) over 3.35
        TB/s, or its operations over the f32 rate. No single PyTorch call
        computes either: no library time. Launches made here are not the main
        path's."""
        import numpy as np
        import torch

        from probpose_code_torch.apis import init_model
        from probpose_code_torch.config import Config
        from probpose_code_torch.models.builder import full_f32_precision
        from probpose_code_torch.ops.kernels import sc_gate, split_attention

        def rel(a, b):
            return float((a - b).abs().max() / b.abs().max())

        rng = np.random.RandomState(9)

        def draw(*shape):
            return torch.from_numpy(rng.randn(*shape).astype(np.float32)).cuda()

        def shapes(recipe, op):
            model = init_model(Config.fromfile(str(CNN_ZOO[recipe])), device="cuda")
            found = [(m, shape) for o, m, shape in self.cnn_zoo_shapes(model) if o == op]
            del model
            return found

        # per kernel: its inputs and the output's gradient a case, the launches, the twin, the bytes, the bars
        gates = [(draw(B, C, H, W), draw(B, C, H // m.k2[0].kernel_size, W // m.k2[0].kernel_size), draw(B, C, H, W),
                  draw(B, C, H, W)) for m, (B, C, H, W) in shapes("scnet50", "self_calibration")]
        splits = [(draw(B, m.radix, m.channels, H, W), draw(B, m.radix, m.channels), draw(B, m.channels, H, W))
                  for m, (B, _, H, W) in shapes("resnest50", "split_attention")]
        kernels = dict(
            sc_gate=(gates, sc_gate.sc_gate_forward, sc_gate.sc_gate_backward, sc_gate.self_calibration_plain,
                     lambda case: sc_gate.sc_gate_bytes(case[0].numel(), case[1].numel()),
                     lambda case: (30 * case[0].numel(), 60 * case[0].numel()), SC_GATE_REL, SC_GATE_GRAD_REL,
                     "probpose_code_tpu/models/backbones/classic.py:330"),
            split_attention=(splits, split_attention.split_attention_forward, split_attention.split_attention_backward,
                             split_attention.split_attention_plain,
                             lambda case: split_attention.split_attention_bytes(case[2].numel(), case[0].shape[1],
                                                                                case[1].numel()),
                             lambda case: (2 * case[0].numel(), 4 * case[0].numel()), SPLIT_ATTENTION_REL,
                             SPLIT_ATTENTION_GRAD_REL, "probpose_code_tpu/models/backbones/litehrnet.py:245"))
        records = []
        for name, (cases, forward, backward, plain, nbytes, nops, bar, grad_bar, ports) in kernels.items():
            errors, abs_err, deterministic = dict(forward=0.0, gradients=0.0), [0.0, 0.0], True
            with full_f32_precision():
                for *ins, dy in cases:
                    out = forward(*ins)
                    grads, again = backward(dy, *ins), backward(dy, *ins)
                    leaves = [t.clone().requires_grad_() for t in ins]
                    ref = plain(*leaves)
                    ref_grads = torch.autograd.grad(ref, leaves, dy)
                    errors["forward"] = max(errors["forward"], rel(out, ref.detach()))
                    errors["gradients"] = max(errors["gradients"], *(rel(g, r) for g, r in zip(grads, ref_grads)))
                    abs_err[0] = max(abs_err[0], float((out - ref.detach()).abs().max()))
                    abs_err[1] = max(abs_err[1], *(float((g - r).abs().max()) for g, r in zip(grads, ref_grads)))
                    deterministic &= all(torch.equal(a, b) for a, b in zip(grads, again))
            print(f"cnn_zoo_kernels {name} over the {len(cases)} calls of its B=64 step: rel max err "
                  f"{json.dumps(errors)} (bars {bar:g} forward, {grad_bar:g} gradients); the backward repeats bit "
                  f"for bit: {deterministic}")
            if not (errors["forward"] < bar and errors["gradients"] < grad_bar and deterministic):
                raise AssertionError(f"cnn_zoo_kernels: the {name} kernels disagree with the twin: {errors}")

            def each(fn, cases=cases):
                return lambda: [fn(*case) for case in cases]

            def plain_grad(*case, plain=plain):
                *ins, dy = case
                leaves = [t.detach().requires_grad_() for t in ins]
                return torch.autograd.grad(plain(*leaves), leaves, dy)

            for i, (suffix, fn, twin) in enumerate(
                    (("forward", each(lambda *case, f=forward: f(*case[:-1])), each(lambda *case, p=plain: p(*case[:-1]))),
                     ("backward", each(lambda *case, b=backward: b(case[-1], *case[:-1])), each(plain_grad)))):
                launch = forward if suffix == "forward" else backward
                fns = [lambda case=case, f=launch: f(*case[:-1]) if suffix == "forward" else f(case[-1], *case[:-1])
                       for case in cases]
                ms, warm = Smoke.queued_ms(fns), Smoke.queued_ms(fns, cold=False)
                plain_ms = Smoke.kernel_device_ms(twin, calls=10)
                nb, ops = sum(nbytes(case)[i] for case in cases), sum(nops(case)[i] for case in cases)
                need = dict(operations=ops / PEAK_F32, bytes=nb / PEAK_BYTES)
                records.append(dict(name=f"{name}_{suffix}", route="cuda", source=f"probpose_code_torch/csrc/{name}.cu",
                                    ports=ports, max_abs_err=abs_err[i], ms=ms, ms_warm=warm, plain_ms=plain_ms,
                                    bound_ms=max(need.values()) * 1e3, bound_by=max(need, key=need.get),
                                    library_ms=None))
                r = records[-1]
                print(f"  {r['name']}: device {ms:.4f} ms with the L2 cache flushed before each launch, {warm:.4f} "
                      f"without (CUDA events; the call back to back {cuda_time_ms(fn, 10):.4f}), plain "
                      f"{plain_ms:.4f} ms device, bound {r['bound_ms']:.4f} ms ({r['bound_by']}: {ops / 1e9:.3f} GFLOP, "
                      f"{nb / 1e6:.1f} MB), {ms / r['bound_ms']:.1f}x its bound, max abs err {r['max_abs_err']:.3e}")
        self.record["cnn_zoo_kernels"] = records + self.se_layer_kernels()

    def se_layer_kernels(self):
        """The squeeze-and-excite kernels (``ops/kernels/se_layer.py``,
        ``csrc/se_layer.cu``; the 2% rule's free place) against their
        plain twin at ViPNAS-Res50's B = 64 step's SE layers (``cnn_zoo_shapes``;
        weights, maps and the output's gradient drawn from a seed), the gate a
        sigmoid, and the first layer's shape once more with the hard sigmoid
        (ViPNAS-MobileNetV3's): the forward at ``SE_LAYER_REL``, the map's and
        the weights' gradients at ``SE_LAYER_GRAD_REL`` (against autograd
        through the twin), the backward twice bit for bit. Then the device
        time of the forward and of the backward summed over the step's layers
        beside the twin's, and the bound: the bytes each must move
        (``se_layer_bytes``) over 3.35 TB/s. No single PyTorch call computes
        the layer: no library time. Returns the two records."""
        import numpy as np
        import torch

        from probpose_code_torch.apis import init_model
        from probpose_code_torch.config import Config
        from probpose_code_torch.models.builder import full_f32_precision
        from probpose_code_torch.ops.kernels import se_layer

        rng = np.random.RandomState(19)

        def draw(*shape, s=1.0):
            return torch.from_numpy((s * rng.randn(*shape)).astype(np.float32)).cuda()

        model = init_model(Config.fromfile(str(CNN_ZOO["vipnas-res50"])), device="cuda")
        layers = [(m.conv1["conv"].out_channels, shape) for o, m, shape in self.cnn_zoo_shapes(model) if o == "se_layer"]
        del model
        cases = [(draw(B, C, H, W), draw(mid, C, s=C ** -0.5), draw(mid, s=0.1), draw(C, mid, s=mid ** -0.5),
                  draw(C, s=0.1), draw(B, C, H, W)) for mid, (B, C, H, W) in layers]

        def rel(a, b):
            return float((a - b).abs().max() / b.abs().max())

        errors, abs_err, deterministic = dict(forward=0.0, gradients=0.0), [0.0, 0.0], True
        with full_f32_precision():
            for i, (*ins, dy) in enumerate(cases + cases[:1]):
                hard = i == len(cases)
                out, *saved = se_layer.se_layer_forward(*ins, hard)
                grads = se_layer.se_layer_backward(dy, ins[0], *saved, ins[1], ins[3], hard)
                again = se_layer.se_layer_backward(dy, ins[0], *saved, ins[1], ins[3], hard)
                leaves = [t.clone().requires_grad_() for t in ins]
                ref = se_layer.se_layer_plain(*leaves, hard)
                ref_grads = torch.autograd.grad(ref, leaves, dy)
                errors["forward"] = max(errors["forward"], rel(out, ref.detach()))
                errors["gradients"] = max(errors["gradients"], *(rel(g, r) for g, r in zip(grads, ref_grads)))
                abs_err[0] = max(abs_err[0], float((out - ref.detach()).abs().max()))
                abs_err[1] = max(abs_err[1], *(float((g - r).abs().max()) for g, r in zip(grads, ref_grads)))
                deterministic &= all(torch.equal(a, b) for a, b in zip(grads, again))
        print(f"cnn_zoo_kernels se_layer over the {len(cases)} SE layers of ViPNAS-Res50's B=64 step and one with the "
              f"hard sigmoid: rel max err {json.dumps(errors)} (bars {SE_LAYER_REL:g} forward, {SE_LAYER_GRAD_REL:g} "
              f"gradients); the backward repeats bit for bit: {deterministic}")
        if not (errors["forward"] < SE_LAYER_REL and errors["gradients"] < SE_LAYER_GRAD_REL and deterministic):
            raise AssertionError(f"cnn_zoo_kernels: the se_layer kernels disagree with the twin: {errors}")

        saved = [se_layer.se_layer_forward(*ins, False)[1:] for *ins, _ in cases]

        def plain_grad(x, w1, b1, w2, b2, dy):
            leaves = [t.detach().requires_grad_() for t in (x, w1, b1, w2, b2)]
            return torch.autograd.grad(se_layer.se_layer_plain(*leaves), leaves, dy)

        timed = (("forward", lambda: [se_layer.se_layer_forward(*c[:-1], False) for c in cases],
                  lambda: [se_layer.se_layer_plain(*c[:-1]) for c in cases]),
                 ("backward", lambda: [se_layer.se_layer_backward(c[-1], c[0], *st, c[1], c[3], False)
                                       for c, st in zip(cases, saved)],
                  lambda: [plain_grad(*c) for c in cases]))
        cold = ([lambda c=c: se_layer.se_layer_forward(*c[:-1], False) for c in cases],
                [lambda c=c, st=st: se_layer.se_layer_backward(c[-1], c[0], *st, c[1], c[3], False)
                 for c, st in zip(cases, saved)])
        records = []
        for i, (suffix, fn, twin) in enumerate(timed):
            ms, warm = Smoke.queued_ms(cold[i]), Smoke.queued_ms(cold[i], cold=False)
            plain_ms = Smoke.kernel_device_ms(twin, calls=10)
            nb = sum(se_layer.se_layer_bytes(c[0].numel(), c[0].shape[0] * c[0].shape[1])[i] for c in cases)
            ops = sum((2 + i) * c[0].numel() + 4 * c[0].shape[0] * c[1].numel() * (1 + i) for c in cases)
            need = dict(operations=ops / PEAK_F32, bytes=nb / PEAK_BYTES)
            records.append(dict(name=f"se_layer_{suffix}", route="cuda", source="probpose_code_torch/csrc/se_layer.cu",
                                ports="probpose_code_tpu/models/backbones/classic.py:SELayer", max_abs_err=abs_err[i],
                                ms=ms, ms_warm=warm, plain_ms=plain_ms, bound_ms=max(need.values()) * 1e3,
                                bound_by=max(need, key=need.get), library_ms=None))
            r = records[-1]
            print(f"  {r['name']}: {ms:.4f} ms with the L2 cache flushed before each layer, {warm:.4f} without "
                  f"(CUDA events; the call back to back {cuda_time_ms(fn, 10):.4f}), plain "
                  f"{plain_ms:.4f} ms device, bound {r['bound_ms']:.4f} ms ({r['bound_by']}: {ops / 1e9:.3f} GFLOP, "
                  f"{nb / 1e6:.1f} MB), {ms / r['bound_ms']:.1f}x its bound, max abs err {r['max_abs_err']:.3e}")
        return records

    @staticmethod
    def cnn_zoo_shapes(model):
        """(op, module, input shape) of each call of the 2% rule's candidate
        ops in one forward of 64 crops of ``model`` (forward hooks): the
        squeeze and excite (``SELayer``), SCNet's gate (``SCConv``), the split
        attention (``SplitAttentionConv``) and the channel shuffle
        (``ShuffleUnitV2``)."""
        import torch

        from probpose_code_torch.models.backbones import classic, resnest

        ops = {classic.SELayer: "se_layer", classic.SCConv: "self_calibration",
               resnest.SplitAttentionConv: "split_attention", classic.ShuffleUnitV2: "channel_shuffle"}
        calls, hooks = [], []
        for m in model.module.backbone.modules():
            if type(m) in ops:
                hooks.append(m.register_forward_hook(
                    lambda m, args, out, op=ops[type(m)]: calls.append((op, m, tuple(args[0].shape)))))
        w, h = model.input_size
        with torch.no_grad():
            model.module(torch.zeros(64, h, w, 3, device=model.device))
        for handle in hooks:
            handle.remove()
        return calls

    @staticmethod
    def cnn_zoo_op_shares(key, busy_ms, model, backward=True):
        """The 2% rule's candidates that ``model`` runs, each alone on the card
        at the shapes one forward of 64 crops gives it (``cnn_zoo_shapes``),
        over the profiled call's or step's device time ``busy_ms``: the
        squeeze and excite (``SELayer``: the pooling, its two 1x1 convs, the
        gate and the scale; as the kernels of ``csrc/se_layer.cu`` and as its
        plain twin), SCNet's gate (``self_calibration``: as the
        kernels of ``csrc/sc_gate.cu`` and as its plain twin), the split
        attention's radix softmax and weighted sum (``split_attention``: as
        the kernels of ``csrc/split_attention.cu`` and as its plain twin)
        and ShuffleNet's channel shuffle, summed over the model's calls of each,
        forward and (``backward``) backward as the step runs them. Returns
        {op: device ms, share %, calls}."""
        import torch

        from probpose_code_torch.models.backbones import classic
        from probpose_code_torch.ops.kernels import sc_gate, se_layer, split_attention

        def leaf(*shape):
            return torch.randn(*shape, device=model.device).requires_grad_(backward)

        cases = {}
        for op, m, (B, C, H, W) in Smoke.cnn_zoo_shapes(model):
            if op == "se_layer":
                x = leaf(B, C, H, W)
                cases.setdefault(op, []).append((lambda m=m, x=x: m(x, torch.float32), (x, *m.parameters())))
                ws = m.conv1["conv"].weight.flatten(1), m.conv1["conv"].bias, m.conv2["conv"].weight.flatten(1), \
                    m.conv2["conv"].bias
                cases.setdefault(op + "_plain", []).append(
                    (lambda x=x, ws=ws, hard=m.hard: se_layer.se_layer_plain(x, *ws, hard),
                     (x, *m.parameters())))
            elif op == "self_calibration":
                r = m.k2[0].kernel_size
                ins = leaf(B, C, H, W), leaf(B, C, H // r, W // r), leaf(B, C, H, W)
                cases.setdefault(op, []).append((lambda ins=ins: sc_gate.self_calibration(*ins), ins))
                cases.setdefault(op + "_plain", []).append((lambda ins=ins: sc_gate.self_calibration_plain(*ins), ins))
            elif op == "split_attention":
                ins = leaf(B, m.radix, m.channels, H, W), leaf(B, m.radix, m.channels)
                cases.setdefault(op, []).append((lambda ins=ins: split_attention.split_attention(*ins), ins))
                cases.setdefault(op + "_plain", []).append(
                    (lambda ins=ins: split_attention.split_attention_plain(*ins), ins))
            else:
                Ho, Wo = ((H + 1) // 2, (W + 1) // 2) if m.stride > 1 else (H, W)
                ins = (leaf(B, m.branch2[2].conv.out_channels * 2, Ho, Wo),)
                cases.setdefault(op, []).append((lambda ins=ins: classic.channel_shuffle(*ins, 2), ins))

        def run(calls):
            for fn, ins in calls:
                out = fn()
                if backward:
                    torch.autograd.grad(out, ins, torch.ones_like(out))

        shares = {}
        for op, calls in cases.items():
            ms = Smoke.kernel_device_ms(lambda calls=calls: run(calls), calls=5)
            shares[op] = dict(device_ms=round(ms, 4), share=round(100 * ms / busy_ms, 2) if busy_ms else None,
                              calls=len(calls))
        print(f"{key}: the 2% rule's candidate ops alone at the {'step' if backward else 'call'}'s shapes, device ms a "
              f"{'step' if backward else 'call'} and % of the profiled {busy_ms} ms of device time: {json.dumps(shares)}")
        return shares

    def res50_predict(self):
        """SimpleBaseline ResNet-50 with DARK (``td-hm_res50_dark``) through
        ``predict_phase``."""
        self.predict_phase(CLASSIC_RECIPES["res50_dark"], "ResNet-50 DARK", ("heatmaps",), "res50_launches")

    def hrnet_msra_predict(self):
        """HRNet-w32 with the MSRA codec (``td-hm_hrnet-w32``, not unbiased):
        the decode on the card against the CPU and a short timing; its
        backbone is the one ``hrnet_predict`` times and profiles."""
        self.predict_phase(CLASSIC_RECIPES["hrnet_w32"], "HRNet-w32 MSRA", ("heatmaps",), "hrnet_msra_launches",
                           timed_calls=2, profile_calls=0)

    def res50_train(self):
        """The ResNet-50 recipe (``td-hm_res50_8xb64``: plain Adam, LinearLR
        and MultiStepLR, MSRA targets rendered on the card): the bare step on
        64 synthetic crops through ``train_phase`` (its first lr the
        warm-up's 5e-4 x 0.001); then ``tools.train``'s main on the config
        file over the golden JPEGs, the train annotations copied to 256
        instances (4 steps) and the val set to 256: one epoch, a checkpoint,
        val. Fails unless 4 steps run, no kernel of the port launches, the
        metrics are finite and the first step's loss dict equals
        ``make_train_step``'s on the same batch, weights and generator seed
        (``TRAIN_FLAGSHIP_REL``). Prints the epoch's train crops/s."""
        import contextlib
        import tempfile

        import torch

        from probpose_code_torch.config import Config
        from probpose_code_torch.datasets.loader import stop_workers
        from probpose_code_torch.tools import train as train_cli

        config = CLASSIC_RECIPES["res50"]
        codec = Config.fromfile(config)["codec"]
        self.train_phase(config, "ResNet-50 MSRA", synthetic_codec_batch(64, 5, codec), "res50_train_launches",
                         first_lr=float(torch.tensor(5e-4 * 0.001, dtype=torch.float32)))
        with tempfile.TemporaryDirectory() as tmp, contextlib.ExitStack() as stack:
            stack.callback(stop_workers)
            _, ann = golden_jpeg_set(tmp)
            copy_instances(ann, 256, Path(tmp, "train.json"))
            copy_instances(ann, 256, Path(tmp, "val.json"))
            options = coco_data_options(tmp, "train.json") + [
                "train_cfg.max_epochs=1", "train_cfg.val_interval=1", "default_hooks.checkpoint.interval=1",
                "default_hooks.logger.interval=1"]
            argv = [str(config), "--work-dir", str(Path(tmp, "work")), "--cfg-options", *options]
            # the main path: counts set to 0 just before, read just after
            read_counts = reset_counts()
            runner = train_cli.main(argv)
            torch.cuda.synchronize()
            launches = read_counts()
            self.read_norms("res50_train", *norm_layers(runner.model), backward=True)
            t = runner.train_times[0]
            print(f"res50_train tools.train: {runner.state.step} steps of {runner.train_loader.batch_size}, launches "
                  f"{json.dumps(launches)}; epoch 1: {t['crops']} crops, {t['crops'] / t['window']:.1f} train "
                  f"crops/s from the start of its loader to its last step ({t['window']:.3f} s; first batch "
                  f"{t['first_batch']:.3f}, steps {t['step']:.3f}, JPEG decode {t['decode']:.3f} card clock); "
                  f"checkpoint {t['checkpoint']:.3f}, val {t['val']:.3f}")
            if runner.state.step != 4 or launches != NO_LAUNCHES:
                raise AssertionError(f"res50_train: {runner.state.step} steps, launches {launches}")
            logged = runner.train_log[0]
            metrics = {k: v for k, v in runner.train_log[-1].items()}
            print("res50_train first step: " + json.dumps(logged))
            if not all(math.isfinite(v) for v in (*logged.values(), *metrics.values())):
                raise AssertionError("res50_train: non-finite metrics")
            if not Path(tmp, "work", "epoch_1.pth").exists():
                raise AssertionError("res50_train: no checkpoint written")

            first_step_check("res50_train", runner)
            runner.close()

    def rtmpose_predict(self):
        """RTMPose-m (``rtmpose-m_8xb256-420e``) through ``predict_phase``,
        both SimCC vectors against the CPU."""
        self.predict_phase(RTMPOSE, "RTMPose-m", ("keypoint_x_labels", "keypoint_y_labels"), "rtmpose_launches")

    def rtmpose_train(self):
        """The RTMPose-m recipe's bare step (AdamW, its LinearLR warm-up;
        SimCC labels rendered on the card) through ``train_phase`` on 64
        synthetic crops; then ``Runner.val`` (the ``tools.test`` path: the
        config's val pipeline, loader and CocoMetric) over the golden JPEGs:
        no kernel launched, one decode a batch, every instance predicted,
        the metrics finite."""
        import contextlib
        import tempfile

        import numpy as np
        import torch

        from probpose_code_torch.config import Config, parse_cfg_option
        from probpose_code_torch.datasets.loader import stop_workers
        from probpose_code_torch.ops.kernels.jpeg import decode_batch
        from probpose_code_torch.tools.test import build_runner

        cfg = Config.fromfile(RTMPOSE)
        self.train_phase(RTMPOSE, "RTMPose-m", synthetic_codec_batch(64, 6, cfg["codec"]), "rtmpose_train_launches",
                         first_lr=float(torch.tensor(4e-3 * 1e-5, dtype=torch.float32)))
        with tempfile.TemporaryDirectory() as tmp, contextlib.ExitStack() as stack:
            stack.callback(stop_workers)
            _, ann = golden_jpeg_set(tmp)
            Path(tmp, "val.json").write_text(Path(ann).read_text())
            options = [kv.replace("val_", "test_", 1) for kv in coco_data_options(tmp, workers=2)]
            cfg.merge_from_dict(dict(parse_cfg_option(kv) for kv in options))
            runner = build_runner(cfg, device="cuda")
            evaluator = KeepSamples(runner.build_evaluator())
            # the main path: counts set to 0 just before, read just after
            read_counts = reset_counts()
            t0 = time.perf_counter()
            metrics = runner.val(evaluator)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            launches, decodes = read_counts(), decode_batch.launches
            self.read_gau("rtmpose_val", True)
            self.read_norms("rtmpose_val", False, False)
            kpts = np.stack([s.pred_instances.keypoints for s in evaluator.samples])
            print(f"rtmpose_train Runner.val: {len(evaluator.samples)} instances in {dt:.3f} s, launches "
                  f"{json.dumps(launches)}, JPEG decodes {decodes}; metrics {json.dumps(metrics)}; val_times "
                  f"{json.dumps(runner.val_times)}")
            if launches != NO_LAUNCHES or decodes != len(runner.val_loader) or len(evaluator.samples) != 62:
                raise AssertionError(f"rtmpose_train val: launches {launches}, {decodes} decodes, "
                                     f"{len(evaluator.samples)} instances")
            if not (np.isfinite(kpts).all() and metrics and all(math.isfinite(v) for v in metrics.values())):
                raise AssertionError(f"rtmpose_train val: keypoints or metrics not finite: {metrics}")
            self.record["rtmpose_val_launches"] = launches

    def rtmpose_augment(self):
        """RTMPose's photometric augmentations on the card
        (``ops/kernels/photometric.py``: the median kernel of
        ``csrc/photometric.cu``, the HSV jitter through its tables, the blur
        and dropout in PyTorch) against ``AUGMENT_FIXTURE`` bit for bit: the
        fixture's batch of ``AUGMENT_B`` crops (every op, every kernel size),
        both HSV tables (every colour and HSV triple), and the window-sum
        tiles of each kernel size (``augment_fixture_report``); no kernel of
        the port's TPU list launched. Then, at the main path's shapes (a batch
        of 256 crops, parameters drawn by the recipe's own worker halves,
        ``recipe_augment_params``: its rates, blur and median 0.1 each, a hole
        on every crop), the median kernel against its plain version on the
        same inputs (exactly), its time beside the plain version's and its
        bound, the HSV jitter's time by the tables and by the plain
        conversions, and the whole augment's time by the card's forms and by
        the plain versions; then ``photometric_timings``."""
        import numpy as np
        import torch

        from probpose_code_torch.ops import photometric as plain
        from probpose_code_torch.ops.kernels import photometric

        read_counts = reset_counts()
        t0 = time.perf_counter()
        report = augment_fixture_report("cuda")
        torch.cuda.synchronize()
        launches = read_counts()
        print(f"rtmpose_augment against cv2's fixture ({time.perf_counter() - t0:.1f} s): {json.dumps(report)}; "
              f"launches {json.dumps(launches)}")
        if not report["ok"] or launches != NO_LAUNCHES:
            raise AssertionError("rtmpose_augment: the card's augmentations differ from cv2's bytes, or launched a "
                                 "kernel of the port's TPU list")
        crops = np.load(AUGMENT_FIXTURE)["crops"]
        img = torch.from_numpy(crops[np.arange(AUGMENT_B) % len(crops)]).cuda().float()
        params = {k: torch.from_numpy(v).cuda() for k, v in recipe_augment_params(AUGMENT_B, seed=0).items()}
        gains = params["hsv_gains"]
        hsv_equal = torch.equal(photometric.yolox_hsv(img, gains), plain.yolox_hsv(img, gains))
        hsv_ms = cuda_time_ms(lambda: photometric.yolox_hsv(img, gains), iters=20)
        hsv_plain_ms = cuda_time_ms(lambda: plain.yolox_hsv(img, gains), iters=5)
        fired = params["median_ksize"]
        median = dict(name="photometric_median", route="cuda", source="probpose_code_torch/csrc/photometric.cu",
                      ports="probpose_code_tpu/datasets/transforms/common.py:797", max_abs_err=0.0, ms=0.0,
                      plain_ms=0.0, bound_ms=0.0, library_ms=None)
        need = dict(bytes=0.0, operations=0.0)
        for k in sorted(set(fired.tolist()) - {0}):
            crops_k = img[(fired == k).nonzero()[:, 0]]
            median["max_abs_err"] = max(median["max_abs_err"], float(
                (photometric.median_blur(crops_k, k) - plain.median_blur(crops_k, k)).abs().max()))
            median["ms"] += cuda_time_ms(lambda: photometric.median_blur(crops_k, k), iters=20)
            median["plain_ms"] += cuda_time_ms(lambda: plain.median_blur(crops_k, k), iters=3)
            # this batch's need: each float read once and written once, and the fewest comparisons any
            # selection of the median of k² values makes, 3 (k² - 1) / 2 (the adversary bound), at the int32 rate
            seconds = dict(bytes=8 * crops_k.numel() / PEAK_BYTES,
                           operations=1.5 * (k * k - 1) * crops_k.numel() / PEAK_INT32)
            median["bound_ms"] += max(seconds.values()) * 1e3
            need = {key: need[key] + seconds[key] for key in need}
        median["bound_by"] = max(need, key=need.get)
        if not hsv_equal or median["max_abs_err"]:
            raise AssertionError(f"rtmpose_augment: the card's HSV jitter equals the plain one {hsv_equal}; the "
                                 f"median kernel's largest difference from its plain version {median['max_abs_err']}")

        def plain_augment():
            out = plain.yolox_hsv(img, gains)
            for key, op in (("blur_ksize", plain.box_blur), ("median_ksize", plain.median_blur)):
                out = photometric._per_ksize(out, params[key], op)
            return plain.coarse_dropout(out, params["dropout_rects"])

        equal = torch.equal(photometric.augment(img, **params), plain_augment())
        ms = cuda_time_ms(lambda: photometric.augment(img, **params), iters=20)
        plain_ms = cuda_time_ms(plain_augment, iters=5)
        counts = {k: int((params[k] > 0).sum()) for k in ("blur_ksize", "median_ksize")}
        print(f"rtmpose_augment: a batch of {AUGMENT_B} crops under the recipe's draws ({json.dumps(counts)} crops "
              f"blurred / median-filtered, kernel sizes {sorted(set(fired.tolist()) - {0})}): {ms:.3f} ms on the "
              f"card by its forms, {plain_ms:.3f} ms by the plain versions (CUDA events, each including the launch "
              f"gaps after its per-kernel-size host syncs); equal {equal}")
        print(f"  the HSV jitter by its tables: {hsv_ms:.4f} ms, by the plain conversions {hsv_plain_ms:.4f} ms "
              f"(bound {24 * img.numel() // 3 / PEAK_BYTES * 1e3:.4f} ms: 3 floats read and 3 written a pixel)")
        print(f"  {median['name']}: {median['ms']:.4f} ms, plain {median['plain_ms']:.4f} ms, bound "
              f"{median['bound_ms']:.4f} ms ({median['bound_by']}), {median['ms'] / median['bound_ms']:.1f}x its "
              f"bound, max abs error {median['max_abs_err']}")
        if not equal:
            raise AssertionError("rtmpose_augment: the card's augment differs from the plain versions'")
        self.record["augment"] = [median]
        self.photometric_timings(img)

    def photometric_timings(self, img):
        """``PhotometricDistortion`` on the card (the tables and its float32
        steps) against its plain version at the body8 and halpe26 recipes'
        shapes: a batch of 256 crops, each recipe's whole augment under its
        own worker halves' draws (body8: the HSV jitter, the distortion,
        Albumentation; halpe26: the last two), exactly equal by the card's
        forms and by the plain versions; the distortion's time by the
        tables and by the plain conversions, and its bound (bytes: 3 floats
        read and 3 written a pixel at 3.35 TB/s)."""
        import torch

        from probpose_code_torch.ops import photometric as plain
        from probpose_code_torch.ops.kernels import photometric

        # this batch's need: 3 floats read and 3 written a pixel; about 25 float32 operations a pixel
        need = dict(bytes=24 * img.numel() // 3 / PEAK_BYTES * 1e3, operations=25 * img.numel() // 3 / PEAK_F32 * 1e3)
        bound = max(need.values())
        self.record["photometric_ms"] = {}
        for recipe, config in (("body8", BODY8), ("halpe26", HALPE26)):
            params = {k: torch.from_numpy(v).cuda() for k, v in recipe_augment_params(AUGMENT_B, 0, config).items()}
            rows = params["photometric"]
            before = photometric.yolox_hsv(img, params["hsv_gains"]) if "hsv_gains" in params else img

            def plain_augment():
                out = plain.yolox_hsv(img, params["hsv_gains"]) if "hsv_gains" in params else img
                out = plain.photometric_distortion(out, rows)
                for key, op in (("blur_ksize", plain.box_blur), ("median_ksize", plain.median_blur)):
                    out = photometric._per_ksize(out, params[key], op)
                return plain.coarse_dropout(out, params["dropout_rects"])

            err = float((photometric.photometric_distortion(before, rows)
                         - plain.photometric_distortion(before, rows)).abs().max())
            equal = not err and torch.equal(photometric.augment(img, **params), plain_augment())
            ms = cuda_time_ms(lambda: photometric.photometric_distortion(before, rows), iters=20)
            plain_ms = cuda_time_ms(lambda: plain.photometric_distortion(before, rows), iters=5)
            augment_ms = cuda_time_ms(lambda: photometric.augment(img, **params), iters=20)
            augment_plain_ms = cuda_time_ms(plain_augment, iters=5)
            fired = {name: int((rows[:, i] != neutral).sum()) for i, (name, neutral) in enumerate(
                (("brightness", 0), ("contrast", 1), ("saturation", 1), ("hue", 0), ("contrast_after", 1)))}
            fired["order"] = int((rows[:, 5:] != torch.arange(3.0, device=rows.device)).any(1).sum())
            print(f"rtmpose_augment {recipe}: PhotometricDistortion on {AUGMENT_B} crops {ms:.4f} ms by its kernel, "
                  f"{plain_ms:.4f} ms by the plain version, bound {bound:.4f} ms ({max(need, key=need.get)}: "
                  f"{json.dumps(need)}), {ms / bound:.1f}x its "
                  f"bound, steps fired {json.dumps(fired)}; the recipe's whole augment {augment_ms:.3f} ms, plain "
                  f"{augment_plain_ms:.3f} ms; equal {equal}")
            if not equal:
                raise AssertionError(f"rtmpose_augment {recipe}: the card's PhotometricDistortion or augment differs "
                                     "from the plain versions'")
            self.record["photometric_ms"][recipe] = ms
            if recipe == "body8":
                self.record["augment"].append(dict(
                    name="photometric_distortion", route="cuda", source="probpose_code_torch/csrc/photometric.cu",
                    ports="probpose_code_tpu/datasets/transforms/common.py:384", max_abs_err=err, ms=ms,
                    plain_ms=plain_ms, bound_ms=bound, bound_by=max(need, key=need.get), library_ms=None))

    def rtmpose_train_runner(self):
        """RTMPose-m's own training recipe through ``tools.train``'s main on
        its config file (random weights, seed 0) at the recipe's batch of
        256 with eight worker processes, over the golden JPEGs with their
        annotations copied to 512 train instances (2 steps an epoch) and the
        62 golden instances as the val set, as ``switch_runner`` runs it."""
        import contextlib
        import tempfile

        from probpose_code_torch.datasets.loader import stop_workers

        with tempfile.TemporaryDirectory() as tmp, contextlib.ExitStack() as stack:
            stack.callback(stop_workers)
            _, ann = golden_jpeg_set(tmp)
            copy_instances(ann, 512, Path(tmp, "train.json"))
            Path(tmp, "val.json").write_text(Path(ann).read_text())
            launches, augments, _, _ = self.switch_runner("rtmpose_train_runner", RTMPOSE, tmp,
                                                       coco_data_options(tmp, "train.json", workers=8))
            self.record["rtmpose_runner_launches"] = launches
            self.record["augment_launches"] = augments

    def body8_train_runner(self):
        """RTMPose-m's body8 recipe (``rtmpose-m_8xb256-420e_body8``) as
        ``rtmpose_train_runner`` runs the COCO one: its eight-way
        ``CombinedDataset`` over the golden JPEGs, 64 instances each (512 in
        all: 2 steps of 256 an epoch), each sub-dataset's annotation file
        in its own layout (``recipe_sets``: the golden COCO keypoints mapped
        back through the inverse of the recipe's mapping, CrowdPose's images
        with a ``crowdIndex``) and through its ``KeypointConverter``; YOLOX
        HSV, ``PhotometricDistortion`` and Albumentation on the card in
        stage 1. Also prints ``PhotometricDistortion``'s share of the
        profiled step's device time: its time on a batch of 256 in
        ``rtmpose_augment`` over the step's busy time."""
        import contextlib
        import tempfile

        from probpose_code_torch.config import Config
        from probpose_code_torch.datasets.loader import stop_workers

        with tempfile.TemporaryDirectory() as tmp, contextlib.ExitStack() as stack:
            stack.callback(stop_workers)
            _, ann = golden_jpeg_set(tmp)
            copy_instances(ann, 64, Path(tmp, "train.json"))
            Path(tmp, "val.json").write_text(Path(ann).read_text())
            options = coco_data_options(tmp, workers=8) + ["train_dataloader.num_workers=8"] + recipe_sets(
                Config.fromfile(str(BODY8)), "train_dataloader", tmp, Path(tmp, "train.json"))
            launches, augments, busy_ms, _ = self.switch_runner("body8_train_runner", BODY8, tmp, options)
            if augments["photometric_distortion"] != 2:  # one a step of stage 1, none in stage 2
                raise AssertionError(f"body8_train_runner: the distortion kernel launched {augments} times")
            self.record["body8_runner_launches"] = launches
            self.record["body8_augment_launches"] = augments
            photometric_ms = self.record.get("photometric_ms", {}).get("body8")
            if busy_ms and photometric_ms:
                print(f"body8_train_runner: PhotometricDistortion {photometric_ms:.4f} ms a batch of 256 "
                      f"(rtmpose_augment), {100 * photometric_ms / busy_ms:.2f}% of the profiled step's {busy_ms:.2f} "
                      f"ms of device time")

    def switch_runner(self, name, config, root, data_options, val_interval=2):
        """An RTMPose recipe through ``tools.train``'s main on its config
        file (random weights, seed 0) at its config's batch over the data
        of ``data_options`` under ``root`` (``root/val.json`` the val set;
        an epoch the whole batches the data holds): two epochs with
        ``switch_epoch=1`` (the stage-2 pipeline from the second, its workers
        restarted), the EMA hook, a checkpoint each epoch and val every
        ``val_interval`` epochs; then a third epoch resumed by ``--resume``. Fails unless the
        config's batch and two epochs' steps run, no kernel of the port's
        TPU list launches, the GAU's kernels launch (``read_gau``), one JPEG decode runs a step and a val batch, the
        crops are augmented on the card (the median kernel launched), the
        metrics are finite, ``epoch_2.pth`` holds the EMA's average as its
        weights and the live weights as ``ema_state_dict``, the first loss
        dict equals ``make_train_step``'s on the same batch, weights and
        generator seed (``TRAIN_FLAGSHIP_REL``), and the resumed run starts
        at epoch 2 with the saved average and ends a third epoch later.
        Prints each epoch's train crops/s with the ``train_times`` split
        (the decode and the augment apart), peak device memory, and the
        second step of the second epoch profiled inside the runner. Returns
        the main path's kernel launches, the photometric kernel's, the
        profiled step's device busy ms and the val's metrics."""
        import torch

        from probpose_code_torch.config import Config
        from probpose_code_torch.engine.checkpoint import read_checkpoint
        from probpose_code_torch.ops.kernels.jpeg import decode_batch
        from probpose_code_torch.tools import train as train_cli

        RunnerWatch = _runner_watch()
        wd = Path(root, "work")
        argv = [str(config), "--work-dir", str(wd), "--cfg-options", *data_options,
                f"train_cfg.val_interval={val_interval}",
                "default_hooks.checkpoint.interval=1", "default_hooks.logger.interval=1",
                "custom_hooks.1.switch_epoch=1"]

        # the main path: counts set to 0 just before, read just after
        watch = RunnerWatch(profile=True)
        torch.cuda.reset_peak_memory_stats()
        read_counts = reset_counts()
        runner = train_cli.main(argv + ["train_cfg.max_epochs=2"], hooks=[watch])
        torch.cuda.synchronize()
        launches, decodes = read_counts(), decode_batch.launches
        augments = {k: c.launches for k, c in augment_counters().items()}
        self.read_gau(name, True, backward=True)
        self.read_norms(name, *norm_layers(runner.model), backward=True)
        peak = torch.cuda.max_memory_allocated() / 2**30
        batch = Config.fromfile(str(config))["train_dataloader"]["batch_size"]
        B, steps, val_batches = runner.train_loader.batch_size, runner.state.step, len(runner.val_loader)
        steps_per_epoch = len(runner.train_loader.dataset) // batch
        print(f"{name} main path: {steps} steps of {B} over {len(runner.train_loader.dataset)} instances, launches "
              f"{json.dumps(launches)}, JPEG decodes {decodes}, photometric kernel {json.dumps(augments)}, GAU "
              f"kernels {json.dumps(self.record['gau_launches'][name])}, peak device memory {peak:.2f} GiB")
        report_runner_epochs(name, runner, 0, watch.profiler_s)
        log = (wd / "train.log").read_text()
        written = sorted(p.name for p in wd.glob("*.pth"))
        metrics = watch.metrics or {}
        print(f"{name} val inside training: {len(runner.val_dataset)} instances, {json.dumps(metrics)}; val_times "
              f"{json.dumps(runner.val_times)}")
        if (B != batch or not steps_per_epoch or steps != 2 * steps_per_epoch or launches != NO_LAUNCHES
                or decodes != steps + val_batches * (2 // val_interval)
                or written != sorted(["epoch_1.pth", "epoch_2.pth"] + (["best.pth"] if runner.save_best else []))
                or "pipeline switch at epoch 1" not in log
                or not metrics or not all(math.isfinite(v) for v in metrics.values())
                or not all(t["augment"] > 0 for t in runner.train_times)
                or not augments["photometric_median"]):
            raise AssertionError(f"{name}: batch {B} (the config's {batch}), {steps} steps, launches {launches}, "
                                 f"{decodes} decodes, checkpoints {written}, metrics {metrics}")
        ckpt = read_checkpoint(str(wd / "epoch_2.pth"))
        live = runner.model.module.state_dict()
        ema = runner.hooks[0]
        average = dict(zip([n for n, _ in runner.model.module.named_parameters()], ema.ema_params))
        if not (all(torch.equal(ckpt["ema_state_dict"][k], live[k].cpu()) for k in ckpt["ema_state_dict"])
                and all(torch.equal(ckpt["state_dict"][k], v.cpu()) for k, v in average.items())):
            raise AssertionError(f"{name}: epoch_2.pth does not hold the average as its weights and the live weights "
                                 "as ema_state_dict")
        first_step_check(name, runner)
        busy_ms = watch.busy_ms
        del runner, ckpt, live, average, ema

        watch = RunnerWatch(resume_from=str(wd / "epoch_2.pth"))
        runner = train_cli.main(argv + ["train_cfg.max_epochs=3", "--resume"], hooks=[watch])
        report_runner_epochs(name, runner, 2)
        print(f"{name} resumed: started at {json.dumps(watch.start)}; ended at step {runner.state.step}")
        if (watch.start != dict(epoch=2, step=steps, average_equal=True) or runner.state.step != 3 * steps // 2
                or "pipeline switch at epoch 2" not in (wd / "train.log").read_text()):
            raise AssertionError(f"{name}: the resumed epoch did not start at epoch 2, step {steps}, with the saved "
                                 f"average and the stage-2 pipeline, or did not end at step {3 * steps // 2}")
        return launches, augments, busy_ms, metrics

    def wholebody_predict(self):
        """The three whole-body recipes at full width through
        ``predict_phase``: RTMPose-m (CSPNeXt-m, RTMCCHead's GAU over 133
        tokens, SimCC), HRNet-w32 (MSRA, 133 maps of 64 x 48) and CSPNeXt-m
        with UDP (no flip-TTA, as its config says)."""
        self.predict_phase(WHOLEBODY_RECIPES["rtmpose"], "RTMPose-m whole-body",
                           ("keypoint_x_labels", "keypoint_y_labels"), "wholebody_rtmpose_launches")
        self.predict_phase(WHOLEBODY_RECIPES["hrnet"], "HRNet-w32 whole-body", ("heatmaps",),
                           "wholebody_hrnet_launches", timed_calls=3, profile_calls=1)
        self.predict_phase(WHOLEBODY_RECIPES["cspnext_udp"], "CSPNeXt-m UDP whole-body", ("heatmaps",),
                           "wholebody_cspnext_launches", timed_calls=3, profile_calls=1)

    def wholebody_train(self):
        """The bare train steps of HRNet-w32 whole-body (plain Adam, MSRA
        targets of 133 keypoints rendered on the card) and CSPNeXt-m UDP
        whole-body (AdamW, UDP targets) through ``train_phase`` on 64
        synthetic crops; then ``tools.test`` on the HRNet-w32 whole-body
        recipe over the golden JPEGs in COCO-WholeBody's layout, the
        ground-truth boxes: ``CocoWholeBodyMetric``'s six AP families finite,
        no kernel of the port launched, one decode a val batch."""
        import contextlib
        import io
        import tempfile

        from probpose_code_torch.config import Config
        from probpose_code_torch.datasets.loader import stop_workers
        from probpose_code_torch.ops.kernels.jpeg import decode_batch
        from probpose_code_torch.tools import test as test_cli

        for name, key, seed in (("hrnet", "HRNet-w32 whole-body", 7), ("cspnext_udp", "CSPNeXt-m UDP whole-body", 8)):
            config = WHOLEBODY_RECIPES[name]
            self.train_phase(config, key, synthetic_codec_batch(64, seed, Config.fromfile(config)["codec"], K=133),
                             f"wholebody_{name}_train_launches")
        families = [f"coco/{part}AP" for part in ("body_", "foot_", "face_", "lefthand_", "righthand_", "")]
        with tempfile.TemporaryDirectory() as tmp, contextlib.ExitStack() as stack:
            stack.callback(stop_workers)
            _, ann = golden_jpeg_set(tmp)
            wholebody_set_from_coco(ann, Path(tmp, "val.json"))
            options = [kv.replace("val_", "test_", 1) for kv in coco_data_options(tmp, workers=8)]
            out = io.StringIO()
            # the main path: counts set to 0 just before, read just after
            read_counts = reset_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                test_cli.main([str(WHOLEBODY_RECIPES["hrnet"]), "--cfg-options", *options])
            dt = time.perf_counter() - t0
            launches, decodes = read_counts(), decode_batch.launches
            self.read_gau("wholebody_hrnet_val", False)
            self.read_norms("wholebody_hrnet_val", False, False)
            tested = dict(line.split(": ", 1) for line in out.getvalue().splitlines() if line.startswith("coco/"))
            print(f"wholebody_train: tools.test on HRNet-w32 whole-body over 62 instances in {dt:.2f} s, launches "
                  f"{json.dumps(launches)}, JPEG decodes {decodes}; {json.dumps({k: tested.get(k) for k in families})}")
            if (launches != NO_LAUNCHES or decodes != 2
                    or not all(math.isfinite(float(tested.get(k, "nan"))) for k in families)):
                raise AssertionError(f"wholebody_train: tools.test gave {tested}, launches {launches}, "
                                     f"{decodes} decodes")
            self.record["wholebody_hrnet_val_launches"] = launches

    def wholebody_train_runner(self):
        """RTMPose-m's whole-body recipe through ``tools.train``'s main at its
        batch of 64 with eight workers over the golden JPEGs in
        COCO-WholeBody's layout (``wholebody_set_from_coco``; 512 train
        instances, 8 steps an epoch; the 62 golden ones as the val set), as
        ``switch_runner`` runs it, with ``CocoWholeBodyMetric``'s val and the
        best checkpoint by its whole-body AP (``coco/AP``); then
        ``tools.test`` on ``best.pth``. Fails unless ``switch_runner``'s
        checks hold, the six AP families are finite in both, and the best
        checkpoint was chosen by ``coco/AP``."""
        import contextlib
        import io
        import tempfile

        from probpose_code_torch.datasets.loader import stop_workers
        from probpose_code_torch.tools import test as test_cli

        families = [f"coco/{part}AP" for part in ("body_", "foot_", "face_", "lefthand_", "righthand_", "")]
        with tempfile.TemporaryDirectory() as tmp, contextlib.ExitStack() as stack:
            stack.callback(stop_workers)
            _, ann = golden_jpeg_set(tmp)
            copy_instances(ann, 512, Path(tmp, "coco.json"))
            wholebody_set_from_coco(Path(tmp, "coco.json"), Path(tmp, "train.json"))
            wholebody_set_from_coco(ann, Path(tmp, "val.json"))
            options = coco_data_options(tmp, "train.json", workers=8) + [
                "default_hooks.checkpoint.save_best=coco/AP", "default_hooks.checkpoint.rule=greater"]
            launches, augments, busy_ms, metrics = self.switch_runner(
                "wholebody_train_runner", WHOLEBODY_RECIPES["rtmpose"], tmp, options)
            log = Path(tmp, "work", "train.log").read_text()
            print(f"wholebody_train_runner: {json.dumps({k: metrics.get(k) for k in families})}; the profiled step "
                  f"{busy_ms} ms busy")
            if (not all(math.isfinite(metrics.get(k, math.nan)) for k in families) or "new best coco/AP" not in log
                    or not Path(tmp, "work", "best.pth").exists()):
                raise AssertionError(f"wholebody_train_runner: metrics {metrics}, no best checkpoint by coco/AP")
            self.record["wholebody_runner_launches"] = launches
            self.record["wholebody_augment_launches"] = augments
            self.wholebody_op_shares(busy_ms)

            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                test_cli.main([str(WHOLEBODY_RECIPES["rtmpose"]), str(Path(tmp, "work", "best.pth")), "--cfg-options",
                               *[kv.replace("val_", "test_", 1) for kv in coco_data_options(tmp, workers=8)]])
            tested = dict(line.split(": ", 1) for line in out.getvalue().splitlines() if line.startswith("coco/"))
            print(f"wholebody_train_runner tools.test on best.pth in {time.perf_counter() - t0:.2f} s: "
                  f"{json.dumps({k: tested.get(k) for k in families})}")
            if not all(math.isfinite(float(tested.get(k, "nan"))) for k in families):
                raise AssertionError(f"wholebody_train_runner: tools.test gave {tested}")

    @staticmethod
    def wholebody_op_shares(busy_ms):
        """The ops that grow with the whole-body recipe's 133 keypoints, each
        run alone on the card at its step's shapes (B = 64) and profiled (the
        device time of its kernels a call, ``kernel_device_ms``), as a share
        of the profiled runner step's device time ``busy_ms``: the SimCC label
        render (``generate_simcc_labels_device``, float64), the GAU's kernels
        (``gau_attention``, forward and backward), the whole GAU block
        (ScaleNorm, its two linear layers and the kernels) and, for the
        comparison, the block with the kernels' plain twin in their place.
        Returns the shares."""
        import numpy as np
        import torch

        from probpose_code_torch.config import Config
        from probpose_code_torch.datasets.metainfo import parse_pose_metainfo
        from probpose_code_torch.models.builder import PoseModel
        from probpose_code_torch.ops.encode import generate_simcc_labels_device
        from probpose_code_torch.ops.kernels.gau import gau_attention, gau_attention_plain

        cfg = Config.fromfile(str(WHOLEBODY_RECIPES["rtmpose"]))
        codec, gau_cfg = cfg["codec"], cfg["model"]["head"]["gau_cfg"]
        model = PoseModel(cfg["model"], metainfo=parse_pose_metainfo({"dataset_name": "coco_wholebody"}),
                          device="cuda")
        model.init_weights(seed=0)
        rng = np.random.RandomState(0)
        size = np.array(codec["input_size"]) * codec["simcc_split_ratio"]
        bins = torch.from_numpy(np.round(rng.uniform(-0.05, 1.05, (64, 133, 2)) * size)).cuda()
        vis = torch.from_numpy((rng.rand(64, 133) > 0.2).astype(np.float32)).cuda()
        gau, B, K, hidden = model.module.head.gau, 64, 133, gau_cfg["hidden_dims"]
        x = torch.randn(B, K, hidden, device="cuda", requires_grad=True)
        z = gau.uv(gau.ln(x)).detach().requires_grad_()

        def block_plain():
            out = gau.o(gau_attention_plain(gau.uv(gau.ln(x)), gau.gamma, gau.beta, gau.e, gau.s))
            (gau.res_scale(x) + out).sum().backward()

        ops = dict(
            simcc_label_render=lambda: generate_simcc_labels_device(
                bins, vis, tuple(codec["input_size"]), codec["simcc_split_ratio"], codec["sigma"], "gaussian",
                codec["normalize"]),
            gau_kernels_fwd_bwd=lambda: gau_attention(z, gau.gamma, gau.beta, gau.e, gau.s).sum().backward(),
            gau_block_fwd_bwd=lambda: gau(x).sum().backward(),
            gau_block_fwd_bwd_plain=block_plain)
        shares = {}
        for name, fn in ops.items():
            ms = Smoke.kernel_device_ms(fn, calls=10)
            shares[name] = dict(device_ms=round(ms, 4), share=round(100 * ms / busy_ms, 2) if busy_ms else None)
        print(f"wholebody_train_runner: the ops of 133 keypoints alone at B=64, device ms a call and % of the "
              f"profiled step's {busy_ms:.2f} ms of device time: {json.dumps(shares)}")
        return shares

    def ubody_train(self):
        """The COCO + UBody recipe (``rtmpose-m_8xb64-270e_coco-ubody-
        wholebody``) through ``tools.train``'s main at its batch of 64 with
        eight workers: its ``CombinedDataset`` of a ``CocoWholeBodyDataset``
        (the golden JPEGs' annotations copied to 128 instances) and 15
        ``UBody2dDataset`` scenes (``ubody_sets``: each keeps the quarter of
        the images that its ``sample_interval=10`` samples), one epoch and
        val by ``CocoWholeBodyMetric``. Fails unless every scene keeps what
        ``sample_interval`` samples, the epoch's steps run, no kernel of the
        port launches, one decode runs a step and a val batch, the metrics
        are finite and the first loss dict equals ``make_train_step``'s."""
        import contextlib
        import tempfile

        import torch

        from probpose_code_torch.config import Config
        from probpose_code_torch.datasets.loader import stop_workers
        from probpose_code_torch.ops.kernels.jpeg import decode_batch
        from probpose_code_torch.tools import train as train_cli

        cfg = Config.fromfile(str(UBODY))
        with tempfile.TemporaryDirectory() as tmp, contextlib.ExitStack() as stack:
            stack.callback(stop_workers)
            _, ann = golden_jpeg_set(tmp)
            copy_instances(ann, 128, Path(tmp, "coco.json"))
            sets, kept = ubody_sets(cfg, tmp, Path(tmp, "coco.json"))
            wholebody_set_from_coco(ann, Path(tmp, "val.json"))
            options = sets + coco_data_options(tmp, workers=8) + [
                "train_dataloader.num_workers=8", "train_cfg.max_epochs=1", "train_cfg.val_interval=1",
                "default_hooks.logger.interval=1"]
            # the main path: counts set to 0 just before, read just after
            read_counts = reset_counts()
            runner = train_cli.main([str(UBODY), "--work-dir", str(Path(tmp, "work")), "--cfg-options", *options])
            torch.cuda.synchronize()
            launches, decodes = read_counts(), decode_batch.launches
            self.read_gau("ubody_train", True, backward=True)
            self.read_norms("ubody_train", *norm_layers(runner.model), backward=True)
            self.record["ubody_augment_launches"] = {k: c.launches for k, c in augment_counters().items()}
            datasets = runner.train_loader.dataset.datasets
            B, steps, val_batches = runner.train_loader.batch_size, runner.state.step, len(runner.val_loader)
            print(f"ubody_train main path: {steps} steps of {B} over {len(runner.train_loader.dataset)} instances "
                  f"(COCO {len(datasets[0])}, the 15 scenes {[len(d) for d in datasets[1:]]}), launches "
                  f"{json.dumps(launches)}, JPEG decodes {decodes}")
            report_runner_epochs("ubody_train", runner, 0)
            metrics = runner.train_log[-1]
            if (B != 64 or len(datasets) != 16 or len(runner.train_loader.dataset) != kept or steps != kept // B
                    or launches != NO_LAUNCHES or decodes != steps + val_batches
                    or not all(math.isfinite(v) for v in metrics.values())):
                raise AssertionError(f"ubody_train: batch {B}, {steps} steps over {len(runner.train_loader.dataset)} "
                                     f"instances ({kept} sampled), launches {launches}, {decodes} decodes")
            self.record["ubody_launches"] = launches
            first_step_check("ubody_train", runner)
            runner.close()

    def face_golden(self):
        """The face fixtures (``FACE_FIXTURES``: the narrow RTMPose with 106
        outputs, its GAU kernels launched, and the narrow ResNet regression
        model with 98 joints; ``tests/golden_torch/face_*``) on the card over
        the golden persons' face boxes at 256 x 256, scored by NME."""
        for fixture in FACE_FIXTURES:
            self._fixture_phase(fixture)

    def face_hand_predict(self):
        """The face and hand recipes at full width through ``predict_phase``
        (64 boxes, flip-TTA as their configs say): RTMPose-m face6 (106
        outputs, the GAU over 106 tokens, SimCC of 512 bins an axis) and
        hand5 (21), HRNetV2-w18 on WFLW (98 MSRA maps of 64 x 64 from the
        four branches concatenated) and its DARK variant, the ResNet-50
        regression recipe (``GlobalAveragePooling``, ``RegressionHead``: its
        keypoints against the CPU twin's) and MobileNetV2 on
        COCO-WholeBody-Hand."""
        recipes = (("face6", "RTMPose-m face6", ("keypoint_x_labels", "keypoint_y_labels")),
                   ("hand5", "RTMPose-m hand5", ("keypoint_x_labels", "keypoint_y_labels")),
                   ("hrnetv2", "HRNetV2-w18 WFLW", ("heatmaps",)),
                   ("hrnetv2_dark", "HRNetV2-w18 DARK WFLW", ("heatmaps",)),
                   ("res50_wing", "ResNet-50 regression WFLW", ("keypoints",)),
                   ("mobilenetv2_hand", "MobileNetV2 COCO-WholeBody-Hand", ("heatmaps",)))
        for key, name, keys in recipes:
            self.predict_phase(FACE_HAND_RECIPES[key], name, keys, f"{key}_predict_launches", timed_calls=5,
                               profile_calls=1)

    def face6_train_runner(self):
        """RTMPose-m face6 (``rtmpose-m_8xb256-120e_face6``) through
        ``tools.train``'s main at its batch of 256 with eight workers, as
        ``switch_runner`` runs it (two epochs across the stage-2 switch, a
        resumed third): its six-way ``CombinedDataset`` (LaPa,
        COCO-WholeBody-Face, WFLW, 300W, COFW and Halpe, each through its
        converter to LaPa's 106 keypoints) over the golden JPEGs' persons
        copied to 92 (about 530 instances: 2 steps an epoch; ``face_hand_
        options``), val on LaPa's layout of the 62 golden persons by ``NME``
        after every epoch; then ``tools.test`` on ``best.pth`` over the
        config's six-way test mix. Fails unless ``switch_runner``'s checks
        hold (the first loss dict, the GAU and median kernels' launches), the
        NMEs are finite, ``best.pth`` is the epoch of the lowest and the test
        mix's NME is finite. Prints the SimCC label render's share of the
        profiled step's device time (the 2% rule)."""
        import contextlib
        import io
        import tempfile

        from probpose_code_torch.config import Config
        from probpose_code_torch.datasets.loader import stop_workers
        from probpose_code_torch.engine.checkpoint import read_checkpoint
        from probpose_code_torch.tools import test as test_cli

        config = FACE_HAND_RECIPES["face6"]
        cfg = Config.fromfile(str(config))
        with tempfile.TemporaryDirectory() as tmp, contextlib.ExitStack() as stack:
            stack.callback(stop_workers)
            _, ann = golden_jpeg_set(tmp)
            copy_instances(ann, 92, Path(tmp, "train.json"))
            options = face_hand_options(cfg, "train_dataloader", tmp, Path(tmp, "train.json")) + face_hand_options(
                cfg, "val_dataloader", tmp, ann) + ["train_dataloader.num_workers=8", "val_dataloader.num_workers=8"]
            launches, augments, busy_ms, metrics = self.switch_runner("face6_train_runner", config, tmp, options,
                                                                    val_interval=1)
            log = Path(tmp, "work", "train.log").read_text()
            nmes = [float(line.split("nme/NME: ")[1].split()[0]) for line in log.splitlines() if "val: " in line]
            best = read_checkpoint(str(Path(tmp, "work", "best.pth")))["meta"]
            print(f"face6_train_runner: val NME by epoch {nmes}; best.pth epoch {best['epoch']}, best score "
                  f"{best['best_score']}")
            # the log prints 4 decimals: the best epoch's NME is the lowest to that precision
            if (len(nmes) != 3 or not all(math.isfinite(v) for v in nmes) or set(metrics) != {"nme/NME"}
                    or abs(best["best_score"] - min(nmes)) > 1e-4 or abs(nmes[best["epoch"] - 1] - min(nmes)) > 1e-4):
                raise AssertionError(f"face6_train_runner: NMEs {nmes}, best.pth {best}")
            self.record["face6_runner_launches"] = launches
            self.record["face6_augment_launches"] = augments
            self.record.setdefault("op_shares", {})["face6_train_runner"] = self.face_hand_op_shares(
                "face6", busy_ms)

            test = face_hand_options(cfg, "test_dataloader", tmp, ann)
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                test_cli.main([str(config), str(Path(tmp, "work", "best.pth")), "--cfg-options", *test,
                               "test_dataloader.num_workers=8"])
            tested = dict(line.split(": ", 1) for line in out.getvalue().splitlines() if line.startswith("nme/"))
            print(f"face6_train_runner tools.test on best.pth over the six-way test mix in "
                  f"{time.perf_counter() - t0:.2f} s: {json.dumps(tested)}")
            if set(tested) != {"nme/NME"} or not math.isfinite(float(tested["nme/NME"])):
                raise AssertionError(f"face6_train_runner: tools.test gave {tested}")

    def hand5_train(self):
        """RTMPose-m hand5 (``rtmpose-m_8xb256-210e_hand5``) through
        ``tools.train``'s main at its batch of 256 with eight workers: its
        five-way mix (COCO-WholeBody-Hand, OneHand10K, FreiHAND, RHD through
        its converter, Halpe's hands) over the golden JPEGs' persons copied
        to 32 (about 300 hands: one step), one epoch, then val on the golden
        persons' hands in COCO-WholeBody's layout by ``PCKAccuracy(thr=0.2)``,
        ``AUC`` and ``EPE``. Fails unless the step runs, no kernel of the
        port's TPU list launches, the GAU and median kernels launch, one
        decode runs a step and a val batch, the metrics are finite and the
        first loss dict equals ``make_train_step``'s."""
        import contextlib
        import tempfile

        import torch

        from probpose_code_torch.config import Config
        from probpose_code_torch.datasets.loader import stop_workers
        from probpose_code_torch.ops.kernels.jpeg import decode_batch
        from probpose_code_torch.tools import train as train_cli

        config = FACE_HAND_RECIPES["hand5"]
        cfg = Config.fromfile(str(config))
        with tempfile.TemporaryDirectory() as tmp, contextlib.ExitStack() as stack:
            stack.callback(stop_workers)
            _, ann = golden_jpeg_set(tmp)
            copy_instances(ann, 32, Path(tmp, "train.json"))
            options = face_hand_options(cfg, "train_dataloader", tmp, Path(tmp, "train.json"))
            options += face_hand_options(cfg, "val_dataloader", tmp, ann) + [
                "train_dataloader.num_workers=8", "val_dataloader.num_workers=8", "train_cfg.max_epochs=1",
                "train_cfg.val_interval=1", "default_hooks.logger.interval=1"]
            # the main path: counts set to 0 just before, read just after
            torch.cuda.reset_peak_memory_stats()
            read_counts = reset_counts()
            runner = train_cli.main([str(config), "--work-dir", str(Path(tmp, "work")), "--cfg-options", *options])
            torch.cuda.synchronize()
            launches, decodes = read_counts(), decode_batch.launches
            self.read_gau("hand5_train", True, backward=True)
            self.read_norms("hand5_train", *norm_layers(runner.model), backward=True)
            augments = {k: c.launches for k, c in augment_counters().items()}
            B, steps, val_batches = runner.train_loader.batch_size, runner.state.step, len(runner.val_loader)
            print(f"hand5_train main path: {steps} steps of {B} over {len(runner.train_loader.dataset)} hands (5 "
                  f"datasets), launches {json.dumps(launches)}, JPEG decodes {decodes}, photometric kernels "
                  f"{json.dumps(augments)}, peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
            report_runner_epochs("hand5_train", runner, 0)
            log = Path(tmp, "work", "train.log").read_text()
            val = [line for line in log.splitlines() if "val: " in line]
            print(f"hand5_train val: {val[-1] if val else None}; val_times {json.dumps(runner.val_times)}")
            names = ("pck/PCK", "auc/AUC", "epe/EPE")
            got = {k: float(val[-1].split(f"{k}: ")[1].split()[0]) for k in names if val and f"{k}: " in val[-1]}
            if (B != 256 or steps < 1 or launches != NO_LAUNCHES or decodes != steps + val_batches
                    or set(got) != set(names) or not all(math.isfinite(v) for v in got.values())
                    or not augments["photometric_median"]):
                raise AssertionError(f"hand5_train: batch {B}, {steps} steps, launches {launches}, {decodes} decodes, "
                                     f"metrics {got}, photometric {augments}")
            self.record["hand5_launches"] = launches
            self.record["hand5_augment_launches"] = augments
            first_step_check("hand5_train", runner)
            runner.close()

    def face_hand_train(self):
        """The bare train steps (``train_phase``, B = 64, synthetic crops,
        targets encoded on the card) of HRNetV2-w18 on WFLW with
        ``AdaptiveWingLoss`` (98 MSRA maps of 64 x 64), the ResNet-50
        regression recipe with ``WingLoss`` (``RegressionLabel``'s labels)
        and MobileNetV2 on COCO-WholeBody-Hand (21 maps); then the 2% rule's
        candidate ops of these steps, each alone at its step's shapes
        (``face_hand_op_shares``)."""
        from probpose_code_torch.config import Config

        shares = self.record.setdefault("op_shares", {})
        for key, name, K, seed in (("hrnetv2_awing", "HRNetV2-w18 AWing WFLW", 98, 11),
                                   ("res50_wing", "ResNet-50 WingLoss WFLW", 98, 12),
                                   ("mobilenetv2_hand", "MobileNetV2 COCO-WholeBody-Hand", 21, 13)):
            config = FACE_HAND_RECIPES[key]
            model, _, _, busy_ms = self.train_phase(
                config, name, synthetic_codec_batch(64, seed, Config.fromfile(str(config))["codec"], K=K),
                f"{key}_train_launches")
            if key != "res50_wing":
                shares[key] = self.face_hand_op_shares(key, busy_ms, model)
            del model

    @staticmethod
    def depthwise_shapes(model):
        """(module, input shape) of each depthwise 3x3 conv of ``model``'s
        MobileNetV2 in one forward of 64 crops of the model's input size."""
        import torch

        from probpose_code_torch.models.backbones.mobilenet_v2 import ConvModule

        shapes, hooks = [], []
        for m in model.module.backbone.modules():
            if isinstance(m, ConvModule) and m.depthwise:
                hooks.append(m.register_forward_hook(lambda m, i, o: shapes.append((m, tuple(i[0].shape)))))
        w, h = model.input_size
        with torch.no_grad():
            model.module(torch.zeros(64, h, w, 3, device="cuda"))
        for hook in hooks:
            hook.remove()
        return shapes

    def face_hand_kernels(self):
        """The face and hand recipes' kernels against their plain twin on
        inputs drawn from a seed, at the shapes of their main paths: the
        depthwise 3x3 kernels (``ops/kernels/depthwise.py``,
        ``csrc/depthwise.cu``) at each of MobileNetV2's 17 depthwise convs
        of the hand recipe's step (B = 64, 256 x 256; forward at
        ``DEPTHWISE_REL``, input and weight gradients at
        ``DEPTHWISE_GRAD_REL``, the backward twice bit for bit), and
        ``AdaptiveWingLoss``'s (``ops/kernels/adaptive_wing.py``,
        ``csrc/adaptive_wing.cu``) over HRNetV2-w18's WFLW maps (64, 98, 64,
        64) with its weights (loss and gradient at ``AWING_REL``). Then each
        kernel's device time by CUDA events, with the L2 cache flushed before
        each launch and without (``queued_ms``: the profiler drops records
        late in the run; the depthwise kernels summed over the 17 shapes, a
        step's worth) beside the twin's (``kernel_device_ms``), the
        library call's (the depthwise twin is cuDNN's ``F.conv2d``, so its
        plain and library times are one call's, measured apart; no PyTorch
        call computes the loss) and the bound: the bytes that each moves
        (every input read once, every output written once) over 3.35 TB/s,
        or its operations over the f32 FMA rate. Launches made here are not
        the main path's."""
        import numpy as np
        import torch

        from probpose_code_torch.apis import init_model
        from probpose_code_torch.config import Config
        from probpose_code_torch.models.builder import full_f32_precision
        from probpose_code_torch.ops.kernels import adaptive_wing as aw
        from probpose_code_torch.ops.kernels import depthwise as dw

        def rel(a, b):
            return float((a - b).abs().max() / b.abs().max())

        model = init_model(Config.fromfile(str(FACE_HAND_RECIPES["mobilenetv2_hand"])), device="cuda")
        rng = np.random.RandomState(7)
        cases = []
        for module, (B, C, H, W) in self.depthwise_shapes(model):
            stride = module.conv.stride[0]
            Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1

            def draw(*shape):
                return torch.from_numpy(rng.randn(*shape).astype(np.float32)).cuda()

            x = draw(B, H, W, C).permute(0, 3, 1, 2)  # channels last, as the backbone gives it
            w = draw(C, 1, 3, 3)
            dy = draw(B, Ho, Wo, C).permute(0, 3, 1, 2)
            cases.append((x, w, dy, stride))
        del model
        errors = dict(forward=0.0, dx=0.0, dw=0.0)
        abs_err = dict(depthwise_forward=0.0, depthwise_backward=0.0)
        deterministic = True
        with full_f32_precision():
            for x, w, dy, stride in cases:
                y = dw.depthwise_forward(x, w, stride)
                gx, gw = dw.depthwise_backward(dy, x, w, stride)
                again = dw.depthwise_backward(dy, x, w, stride)
                leaves = [x.clone().requires_grad_(), w.clone().requires_grad_()]
                ref = dw.depthwise_conv3x3_plain(*leaves, stride)
                rx, rw = torch.autograd.grad(ref, leaves, dy)
                errors["forward"] = max(errors["forward"], rel(y, ref.detach()))
                errors["dx"], errors["dw"] = max(errors["dx"], rel(gx, rx)), max(errors["dw"], rel(gw, rw))
                abs_err["depthwise_forward"] = max(abs_err["depthwise_forward"], float((y - ref.detach()).abs().max()))
                abs_err["depthwise_backward"] = max(abs_err["depthwise_backward"], float((gx - rx).abs().max()),
                                                    float((gw - rw).abs().max()))
                deterministic &= torch.equal(gx, again[0]) and torch.equal(gw, again[1])
        print(f"face_hand_kernels depthwise over the 17 shapes of MobileNetV2's B=64 step: rel max err "
              f"{json.dumps(errors)} (bars {DEPTHWISE_REL:g} forward, {DEPTHWISE_GRAD_REL:g} gradients); the "
              f"backward repeats bit for bit: {deterministic}")
        if not (errors["forward"] < DEPTHWISE_REL and max(errors["dx"], errors["dw"]) < DEPTHWISE_GRAD_REL
                and deterministic):
            raise AssertionError(f"face_hand_kernels: the depthwise kernels disagree with the twin: {errors}")

        target = torch.from_numpy(rng.rand(64, 98, 64, 64).astype(np.float32)).cuda()
        output = target + torch.from_numpy(0.3 * rng.randn(64, 98, 64, 64).astype(np.float32)).cuda()
        weights = torch.from_numpy((rng.rand(64, 98) > 0.1).astype(np.float32)).cuda()
        params = (2.1, 14.0, 1.0, 0.5, 1.0)
        loss = aw.adaptive_wing_forward(output, target, weights, params)
        dloss = torch.ones((), device="cuda")
        grad = aw.adaptive_wing_backward(dloss, output, target, weights, params)
        leaf = output.clone().requires_grad_()
        ref = aw.adaptive_wing_loss_plain(leaf, target, weights, *params)
        (ref_grad,) = torch.autograd.grad(ref, [leaf])
        werr = dict(loss=rel(loss, ref.detach()), grad=rel(grad, ref_grad))
        print(f"face_hand_kernels AdaptiveWingLoss over (64, 98, 64, 64): rel max err {json.dumps(werr)} (bar "
              f"{AWING_REL:g})")
        if not max(werr.values()) < AWING_REL:
            raise AssertionError(f"face_hand_kernels: the AdaptiveWingLoss kernels disagree with the twin: {werr}")
        abs_err["adaptive_wing_forward"] = float((loss - ref.detach()).abs())
        abs_err["adaptive_wing_backward"] = float((grad - ref_grad).abs().max())

        def each(fn):
            return [functools.partial(fn, *case) for case in cases]

        def plain_grad(x, w, dy, stride):
            leaves = [x.detach().requires_grad_(), w.detach().requires_grad_()]
            return torch.autograd.grad(dw.depthwise_conv3x3_plain(*leaves, stride), leaves, dy)

        fwd_bytes = sum(dw.depthwise_bytes(x.shape[0], x.shape[1], x.shape[2], x.shape[3], s)[0]
                        for x, _, _, s in cases)
        bwd_bytes = sum(dw.depthwise_bytes(x.shape[0], x.shape[1], x.shape[2], x.shape[3], s)[1]
                        for x, _, _, s in cases)
        fwd_ops = sum(2 * 9 * dy.numel() for _, _, dy, _ in cases)
        elements = output.numel()
        awing_bytes = aw.adaptive_wing_bytes(elements, weights.numel(), True)
        timed = dict(
            depthwise_forward=(each(lambda x, w, dy, s: dw.depthwise_forward(x, w, s)),
                               all_of(each(lambda x, w, dy, s: dw.depthwise_conv3x3_plain(x, w, s))), True, fwd_ops,
                               fwd_bytes, "probpose_code_tpu/models/backbones/mobilenet_v2.py:45",
                               "probpose_code_torch/csrc/depthwise.cu"),
            depthwise_backward=(each(lambda x, w, dy, s: dw.depthwise_backward(dy, x, w, s)), all_of(each(plain_grad)),
                                True, 2 * fwd_ops, bwd_bytes, "probpose_code_tpu/models/backbones/mobilenet_v2.py:45",
                                "probpose_code_torch/csrc/depthwise.cu"),
            adaptive_wing_forward=([lambda: aw.adaptive_wing_forward(output, target, weights, params)],
                                   lambda: aw.adaptive_wing_loss_plain(output, target, weights, *params), False,
                                   30 * elements, awing_bytes[0], "probpose_code_tpu/models/losses/heatmap_loss.py:139",
                                   "probpose_code_torch/csrc/adaptive_wing.cu"),
            adaptive_wing_backward=([lambda: aw.adaptive_wing_backward(dloss, output, target, weights, params)],
                                    lambda: torch.autograd.grad(aw.adaptive_wing_loss_plain(
                                        leaf, target, weights, *params), [leaf]), False, 40 * elements,
                                    awing_bytes[1], "probpose_code_tpu/models/losses/heatmap_loss.py:139",
                                    "probpose_code_torch/csrc/adaptive_wing.cu"))
        records = []
        for name, (fns, plain, library, ops, nbytes, ports, source) in timed.items():
            with full_f32_precision():
                ms, warm = Smoke.queued_ms(fns), Smoke.queued_ms(fns, cold=False)
                plain_ms = Smoke.kernel_device_ms(plain, calls=10)
                library_ms = Smoke.kernel_device_ms(plain, calls=10) if library else None
            need = dict(operations=ops / PEAK_F32, bytes=nbytes / PEAK_BYTES)
            records.append(dict(name=name, route="cuda", source=source, ports=ports, max_abs_err=abs_err[name],
                                ms=ms, ms_warm=warm, plain_ms=plain_ms, bound_ms=max(need.values()) * 1e3,
                                bound_by=max(need, key=need.get), library_ms=library_ms))
            r = records[-1]
            print(f"  {name}: device {ms:.4f} ms with the L2 cache flushed before each launch, {warm:.4f} without "
                  f"(CUDA events; the call back to back {cuda_time_ms(all_of(fns), 10):.4f}), plain {plain_ms:.4f}"
                  f" ms device" + (f", library (cuDNN F.conv2d) {library_ms:.4f}" if library else "")
                  + f", bound {r['bound_ms']:.4f} ms ({r['bound_by']}: {ops / 1e9:.3f} GFLOP, {nbytes / 1e6:.1f} "
                  f"MB), {ms / r['bound_ms']:.1f}x its bound, max abs err {r['max_abs_err']:.3e}")
        self.record["face_hand_kernels"] = records

    @staticmethod
    def face_hand_op_shares(key, busy_ms, model=None):
        """The 2% rule's candidates of this slice, each run alone on the card
        at its step's shapes and profiled (``kernel_device_ms``: the device
        time of its kernels a call), over the profiled step's device time
        ``busy_ms``: for ``face6`` the SimCC label render at K = 106 with
        512 bins an axis (B = 256, float64); for ``hrnetv2_awing``
        ``AdaptiveWingLoss``, forward and backward over (64, 98, 64, 64) maps,
        as its kernels and as its plain twin (PyTorch, which the step ran
        before the kernels); for ``mobilenetv2_hand`` every depthwise 3x3
        convolution of the step's MobileNetV2, forward and backward at the
        shapes one forward of ``model`` gives them, as the kernels and as
        cuDNN's (the twin). Returns {op: device ms, share %}."""
        import numpy as np
        import torch

        from probpose_code_torch.config import Config
        from probpose_code_torch.ops.encode import generate_simcc_labels_device
        from probpose_code_torch.ops.kernels import adaptive_wing as aw
        from probpose_code_torch.ops.kernels import depthwise as dw

        rng = np.random.RandomState(0)
        ops = {}
        if key == "face6":
            codec = Config.fromfile(str(FACE_HAND_RECIPES["face6"]))["codec"]
            size = np.array(codec["input_size"]) * codec["simcc_split_ratio"]
            bins = torch.from_numpy(np.round(rng.uniform(-0.05, 1.05, (256, 106, 2)) * size)).cuda()
            vis = torch.from_numpy((rng.rand(256, 106) > 0.1).astype(np.float32)).cuda()
            ops["simcc_label_render_K106"] = lambda: generate_simcc_labels_device(
                bins, vis, tuple(codec["input_size"]), codec["simcc_split_ratio"], codec["sigma"], "gaussian",
                codec["normalize"])
        elif key == "hrnetv2_awing":
            target = torch.rand(64, 98, 64, 64, device="cuda")
            output = (target + 0.1 * torch.randn_like(target)).requires_grad_()
            weights = torch.ones(64, 98, device="cuda")
            params = (2.1, 14.0, 1.0, 0.5, 1.0)
            ops["adaptive_wing_loss_fwd_bwd_kernels"] = lambda: aw.adaptive_wing_loss(
                output, target, weights, *params).backward()
            ops["adaptive_wing_loss_fwd_bwd_plain"] = lambda: torch.autograd.grad(
                aw.adaptive_wing_loss_plain(output, target, weights, *params), [output])
        elif key == "mobilenetv2_hand":
            cases = []
            for module, (B, C, H, W) in Smoke.depthwise_shapes(model):
                s = module.conv.stride[0]
                x = torch.randn(B, H, W, C, device="cuda").permute(0, 3, 1, 2).requires_grad_()
                w = module.conv.weight.detach().clone().requires_grad_()
                dy = torch.randn(B, (H - 1) // s + 1, (W - 1) // s + 1, C, device="cuda").permute(0, 3, 1, 2)
                cases.append((x, w, dy, s))

            def run(conv):
                for x, w, dy, s in cases:
                    torch.autograd.grad(conv(x, w, s), [x, w], dy)

            ops[f"depthwise_3x3_fwd_bwd_x{len(cases)}_kernels"] = lambda: run(dw.depthwise_conv3x3)
            ops[f"depthwise_3x3_fwd_bwd_x{len(cases)}_plain"] = lambda: run(dw.depthwise_conv3x3_plain)
        shares = {}
        for name, fn in ops.items():
            ms = Smoke.kernel_device_ms(fn, calls=10)
            shares[name] = dict(device_ms=round(ms, 4), share=round(100 * ms / busy_ms, 2) if busy_ms else None)
        print(f"{key}: the 2% rule's candidate ops alone at the step's shapes, device ms a call and % of the "
              f"profiled step's {busy_ms} ms of device time: {json.dumps(shares)}")
        return shares

    def halpe26_runner(self):
        """RTMPose-m's halpe26 recipe (``rtmpose-m_8xb512-700e_body8-
        halpe26``, its sub-datasets' converters repaired as
        ``halpe26_repair_options`` says) through ``tools.train``'s main at
        its batch of 512 with eight workers: its seven-way train mix over the
        golden JPEGs, 147 instances each in its own layout (2 steps), one
        epoch, then val over the eight-way mixed val set (the 62 golden
        instances in each of eight layouts) scored by ``PCKAccuracy`` and
        ``AUC``; then ``tools.test`` on the best checkpoint. Fails unless no
        kernel of the port launches, one decode runs a step and a val batch,
        the first loss dict equals ``make_train_step``'s, ``pck/PCK`` and
        ``auc/AUC`` are finite in both, and the best checkpoint is chosen by
        ``auc/AUC``. Prints train crops/s with the split and peak device
        memory."""
        import contextlib
        import io
        import tempfile

        import torch

        from probpose_code_torch.config import Config, parse_cfg_option
        from probpose_code_torch.datasets.loader import stop_workers
        from probpose_code_torch.ops.kernels.jpeg import decode_batch
        from probpose_code_torch.tools import test as test_cli
        from probpose_code_torch.tools import train as train_cli

        RunnerWatch = _runner_watch()
        cfg = Config.fromfile(str(HALPE26))
        repair = halpe26_repair_options(cfg)
        cfg.merge_from_dict(dict(parse_cfg_option(o) for o in repair))
        with tempfile.TemporaryDirectory() as tmp, contextlib.ExitStack() as stack:
            stack.callback(stop_workers)
            _, ann = golden_jpeg_set(tmp)
            copy_instances(ann, 147, Path(tmp, "train.json"))
            val = [o for o in repair + recipe_sets(cfg, "val_dataloader", tmp, ann) if o.startswith("val_")]
            options = (repair + recipe_sets(cfg, "train_dataloader", tmp, Path(tmp, "train.json")) + val
                       + ["train_dataloader.num_workers=8", "val_dataloader.num_workers=8", "train_cfg.max_epochs=1",
                          "train_cfg.val_interval=1", "default_hooks.logger.interval=1"])
            wd = Path(tmp, "work")
            watch = RunnerWatch()
            # the main path: counts set to 0 just before, read just after
            torch.cuda.reset_peak_memory_stats()
            read_counts = reset_counts()
            runner = train_cli.main([str(HALPE26), "--work-dir", str(wd), "--cfg-options", *options], hooks=[watch])
            torch.cuda.synchronize()
            launches, decodes = read_counts(), decode_batch.launches
            self.read_gau("halpe26_runner", True, backward=True)
            self.read_norms("halpe26_runner", *norm_layers(runner.model), backward=True)
            augments = {k: c.launches for k, c in augment_counters().items()}
            peak = torch.cuda.max_memory_allocated() / 2**30
            B, steps, val_batches = runner.train_loader.batch_size, runner.state.step, len(runner.val_loader)
            print(f"halpe26_runner main path: {steps} steps of {B} over {len(runner.train_loader.dataset)} instances "
                  f"(7 datasets), launches {json.dumps(launches)}, JPEG decodes {decodes}, photometric kernels "
                  f"{json.dumps(augments)}, peak device memory {peak:.2f} GiB")
            report_runner_epochs("halpe26_runner", runner, 0)
            metrics = watch.metrics or {}
            log = (wd / "train.log").read_text()
            print(f"halpe26_runner val inside training: {len(runner.val_dataset)} instances (8 datasets), "
                  f"{json.dumps(metrics)}; val_times {json.dumps(runner.val_times)}; best by {runner.save_best}")
            if (B != 512 or steps != 2 or launches != NO_LAUNCHES or decodes != steps + val_batches
                    or augments["photometric_distortion"] != steps or set(metrics) != {"pck/PCK", "auc/AUC"}
                    or not all(math.isfinite(v) for v in metrics.values())
                    or runner.save_best != "AUC" or "new best auc/AUC" not in log or not (wd / "best.pth").exists()):
                raise AssertionError(f"halpe26_runner: batch {B}, {steps} steps, launches {launches}, {decodes} "
                                     f"decodes, metrics {metrics}, best by {runner.save_best}")
            self.record["halpe26_launches"] = launches
            first_step_check("halpe26_runner", runner)
            runner.close()
            del runner

            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                test_cli.main([str(HALPE26), str(wd / "best.pth"), "--cfg-options",
                               *["test" + o[3:] for o in val], "test_dataloader.num_workers=8"])
            tested = dict(line.split(": ", 1) for line in out.getvalue().splitlines() if ": " in line
                          and line.startswith(("pck/", "auc/")))
            print(f"halpe26_runner tools.test on best.pth: {json.dumps(tested)}")
            if set(tested) != {"pck/PCK", "auc/AUC"} or not all(math.isfinite(float(v)) for v in tested.values()):
                raise AssertionError(f"halpe26_runner: tools.test gave {tested}")

    def crowdpose_val(self):
        """``tools.test`` on the CrowdPose ResNet-50 recipe (``td-hm_res50_
        8xb64-210e_crowdpose``, random weights, seed 0) over the golden
        JPEGs in CrowdPose's layout (14 keypoints through the inverse of the
        body8 recipe's ``crowdpose_coco``, images with a ``crowdIndex``),
        the ground-truth boxes: ``CocoMetric`` with the crowd iouType under
        CrowdPose's sigmas. Fails unless no kernel of the port launches, one
        decode runs a val batch and every ``crowdpose/`` stat is finite."""
        import contextlib
        import io
        import tempfile

        from probpose_code_torch.config import Config
        from probpose_code_torch.datasets.loader import stop_workers
        from probpose_code_torch.ops.kernels.jpeg import decode_batch
        from probpose_code_torch.tools import test as test_cli

        with tempfile.TemporaryDirectory() as tmp, contextlib.ExitStack() as stack:
            stack.callback(stop_workers)
            _, ann = golden_jpeg_set(tmp)
            ann_file = Path(tmp, "crowdpose.json")
            body_set_from_coco(ann, ann_file, "CrowdPoseDataset", Config.fromfile(str(BODY8))["crowdpose_coco"])
            options = [f"test_dataloader.dataset.data_root={tmp}", "test_dataloader.dataset.ann_file=crowdpose.json",
                       "test_dataloader.dataset.data_prefix.img=imgs/", "test_dataloader.dataset.bbox_file=None",
                       "test_dataloader.num_workers=8", f"test_evaluator.ann_file={ann_file}"]
            out = io.StringIO()
            # the main path: counts set to 0 just before, read just after
            read_counts = reset_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                test_cli.main([str(CROWDPOSE), "--cfg-options", *options])
            dt = time.perf_counter() - t0
            launches, decodes = read_counts(), decode_batch.launches
            self.read_norms("crowdpose_val", False, False)
            stats = dict(line.split(": ", 1) for line in out.getvalue().splitlines() if line.startswith("crowdpose/"))
            n = sum(a["num_keypoints"] > 0 for a in json.loads(ann_file.read_text())["annotations"])
            print(f"crowdpose_val: tools.test over {n} instances in {dt:.2f} s, launches {json.dumps(launches)}, JPEG "
                  f"decodes {decodes}; {json.dumps(stats)}")
            if (launches != NO_LAUNCHES or decodes != -(-n // 32) or not {"crowdpose/AP", "crowdpose/AR"} <= set(stats)
                    or not all(math.isfinite(float(v)) for v in stats.values())):
                raise AssertionError(f"crowdpose_val: launches {launches}, {decodes} decodes, stats {stats}")
            self.record["crowdpose_launches"] = launches

    def rtmpose_aic_train(self):
        """The AIC+COCO recipe (``rtmpose-m_8xb256-420e_aic-coco``) through
        ``tools.train``'s main at its batch of 128 with four workers: its
        ``CombinedDataset`` over the golden JPEGs, the COCO half their
        annotations copied to 256 instances and the AIC half the same mapped
        back to AIC's 14 keypoints (``aic_from_coco``), each AIC sample
        through its ``KeypointConverter`` to COCO's 17; one epoch (4 steps)
        and val. Fails unless no kernel of the port launches, the metrics are
        finite, and every batch's keypoint weights (B, 17) as the step
        received them from the workers equal that batch made in this process
        on the CPU (``DataLoader.load``), the first loss dict equals
        ``make_train_step``'s (``TRAIN_FLAGSHIP_REL``). Prints the epoch's
        train crops/s and its split."""
        import contextlib
        import tempfile

        import numpy as np
        import torch

        from probpose_code_torch.datasets.loader import stop_workers
        from probpose_code_torch.engine.hooks import Hook
        from probpose_code_torch.tools import train as train_cli

        class Weights(Hook):
            """The keypoint weights of each batch the step receives."""

            def __init__(self):
                self.seen = []

            def before_run(self, runner):
                step = runner.train_step

                def recording(state, batch, generator):
                    self.seen.append(batch["keypoint_weights"].cpu().numpy())
                    return step(state, batch, generator)

                runner.train_step = recording

        config = RTMPOSE.parent / "rtmpose-m_8xb256-420e_aic-coco-256x192.py"
        with tempfile.TemporaryDirectory() as tmp, contextlib.ExitStack() as stack:
            stack.callback(stop_workers)
            _, ann = golden_jpeg_set(tmp)
            copy_instances(ann, 256, Path(tmp, "train.json"))
            aic_from_coco(Path(tmp, "train.json"), Path(tmp, "aic.json"))
            Path(tmp, "val.json").write_text(Path(ann).read_text())
            options = coco_data_options(tmp)
            for i, name in enumerate(("train.json", "aic.json")):
                options += [f"train_dataloader.dataset.datasets.{i}.data_root={tmp}",
                            f"train_dataloader.dataset.datasets.{i}.ann_file={name}",
                            f"train_dataloader.dataset.datasets.{i}.data_prefix.img=imgs/"]
            options += ["train_cfg.max_epochs=1", "train_cfg.val_interval=1", "default_hooks.checkpoint.interval=1",
                        "default_hooks.logger.interval=1"]
            weights = Weights()
            # the main path: counts set to 0 just before, read just after
            read_counts = reset_counts()
            runner = train_cli.main([str(config), "--work-dir", str(Path(tmp, "work")), "--cfg-options", *options],
                                    hooks=[weights])
            torch.cuda.synchronize()
            launches = read_counts()
            self.read_gau("rtmpose_aic_train", True, backward=True)
            self.read_norms("rtmpose_aic_train", *norm_layers(runner.model), backward=True)
            B, steps = runner.train_loader.batch_size, runner.state.step
            print(f"rtmpose_aic_train main path: {steps} steps of {B} over {len(runner.train_loader.dataset)} "
                  f"instances (COCO and AIC), launches {json.dumps(launches)}")
            report_runner_epochs("rtmpose_aic_train", runner, 0)
            here = [runner.train_loader.load(0, i)["keypoint_weights"] for i in range(steps)]
            equal = len(here) == len(weights.seen) and all(np.array_equal(a, b) for a, b in zip(here, weights.seen))
            aic_rows = sum(int((w[:, :5] == 0).all(axis=1).sum()) for w in weights.seen)
            print(f"rtmpose_aic_train: the weights of {len(weights.seen)} batches ({weights.seen[0].shape} each) "
                  f"{'equal' if equal else 'differ from'} the CPU's; {aic_rows} rows with no face keypoint weight")
            metrics = runner.train_log[-1]
            if (B != 128 or steps != 4 or launches != NO_LAUNCHES or not equal
                    or weights.seen[0].shape != (B, 17) or not all(math.isfinite(v) for v in metrics.values())):
                raise AssertionError(f"rtmpose_aic_train: batch {B}, {steps} steps, launches {launches}, weights "
                                     f"equal {equal}, metrics {metrics}")
            self.record["rtmpose_aic_launches"] = launches
            first_step_check("rtmpose_aic_train", runner)
            runner.close()

    @staticmethod
    def profile(fn, calls: int, what: str = "flagship calls"):
        """Device time by kernel over a few calls, and the device's busy
        share of the wall time (torch.profiler's CUDA activity); where K2 ran,
        also its share. Returns the device's busy ms a call (None where the
        profiler recorded no device time)."""
        import torch

        with traced() as prof:
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        return Smoke.report_profile(prof, wall_us, calls, what)

    @staticmethod
    def report_profile(prof, wall_us: float, calls: int, what: str):
        """Print a finished profile: device time by kernel, the busy share of
        ``wall_us`` and, where K2 ran, its share. Returns the device's busy
        ms a call (None where the profiler recorded no device time)."""
        by_name = {}
        for name, us in device_records(prof):
            t, n = by_name.get(name, (0.0, 0))
            by_name[name] = (t + us, n + 1)
        if not by_name:
            print("profile: the profiler recorded no device time (busy share not measured)")
            return
        busy = sum(t for t, _ in by_name.values())
        launched = sum(n for _, n in by_name.values())
        print(f"profile over {calls} {what}: wall {wall_us / calls / 1e3:.2f} ms per call, device busy "
              f"{busy / calls / 1e3:.2f} ms per call ({100 * busy / wall_us:.1f}% busy, "
              f"{100 * (1 - busy / wall_us):.1f}% idle), {launched // calls} kernels per call")
        for name, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]:
            print(f"  {100 * t / busy:5.1f}%  {t / calls / 1e3:8.3f} ms/call  x{n // calls:<4d} {name[:110]}")
        k2 = sum(t for name, (t, _) in by_name.items() if "expected_oks_kernel" in name)
        if k2:
            print(f"  expected_oks_kernel: {100 * k2 / busy:.2f}% of device time, {k2 / calls / 1e3:.4f} ms/call, "
                  f"{100 * k2 / wall_us:.2f}% of the wall time")
        return busy / calls / 1e3

    @staticmethod
    def products_rate(fn, flops, calls=3):
        """(device ms a call of the GEMM kernels, TFLOP/s of ``flops``) over
        a profile of ``calls`` calls of fn, traced with the host's activity
        (``traced``). A trace that recorded no device time at all, or none in the GEMM
        kernels (the tracer drops records late in a long run), is taken once
        more; if the second recorded no device time either, both numbers are
        NaN (not measured), and if it saw device time but no GEMM kernel, it
        fails."""
        import torch

        fn()
        torch.cuda.synchronize()
        for _ in range(2):
            with traced(host=True) as prof:
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
            device = device_records(prof)
            if any("gemm" in name for name, _ in device):
                break
        if not device:
            print("products: the profiler recorded no device time (their rate not measured)")
            return float("nan"), float("nan")
        us = sum(t for name, t in device if "gemm" in name)
        if us == 0:
            raise AssertionError("the profiler saw device time but no GEMM kernel")
        ms = us / calls / 1e3
        return ms, flops / (ms * 1e-3) / 1e12

    @staticmethod
    def kernel_device_ms(fn, name=None, calls=20):
        """Device ms a call of fn in the kernels whose name holds ``name`` (in
        all its kernels where ``name`` is None), over a profile of ``calls``
        calls of fn, traced with the host's activity (``traced``). A trace
        that recorded none of those kernels is taken once more; if the second
        recorded no device time at all, the result is NaN (not measured), and
        if it saw device time but none of those kernels, it fails."""
        import torch

        fn()
        torch.cuda.synchronize()
        for _ in range(2):
            with traced(host=True) as prof:
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
            device = device_records(prof)
            mine = [us for kernel, us in device if name is None or name in kernel]
            if mine:
                break
        if not device:
            print(f"{name or 'device time'}: the profiler recorded no device time (not measured)")
            return float("nan")
        if not mine:
            raise AssertionError(f"the profiler saw device time but no {name}")
        return sum(mine) / calls / 1e3

    @staticmethod
    def queued_ms(fns, calls=5, cold=True):
        """Device ms of one pass over ``fns`` (callables, each a kernel's call
        at a step's shape) by CUDA events around each call, the call queued
        behind a wait on the card (``torch.cuda._sleep``) long enough for the
        host to queue all of its launches, so that the events see the
        kernels alone and no host gap; ``cold``: behind a flush of the L2
        cache too (a 128 MB buffer zeroed), so that each call's inputs come
        from device memory, as its bound counts them. The profiler's device
        time is not used here: late in a long run the tracer drops records
        (a third of them, late in this script), which reads as a shorter
        time."""
        import torch

        flush = torch.empty(2**25, dtype=torch.float32, device="cuda")
        pairs = []
        for fn in fns:  # warm-up
            fn()
        for _ in range(calls):
            for fn in fns:
                if cold:
                    flush.zero_()
                torch.cuda._sleep(2_000_000)
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                end.record()
                pairs.append((start, end))
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in pairs) / calls

    @staticmethod
    def host_us(fn, calls=200):
        """The host's time to issue one call of fn: ``calls`` calls with no
        synchronize in between, on the host clock, then one synchronize."""
        import torch

        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        dt = time.perf_counter() - t0
        torch.cuda.synchronize()
        return dt / calls * 1e6

    @staticmethod
    def k2_timings(B=64, K=17, H=64, W=48):
        """K2 (decode) and K2b (conv-only) at the flagship decode shape, 64
        crops x 17 keypoints of 64 x 48: the error against the plain twin, the
        call time (CUDA events over back-to-back wrapper calls), the kernel's
        device time from a profiler trace, the wrapper's host cost a call,
        the plain twin's time, and the bound. K2b's library yardstick is one
        cuDNN depthwise convolution (f32, TF32 off) of the symmetric-padded
        maps with the (K, 1, D, D) outer products of the taps; the pad is
        timed on its own. No single PyTorch call computes K2's function (an
        argmax and a Taylor step after the convolution)."""
        import torch
        import torch.nn.functional as F_

        from probpose_code_torch.ops.decode import (
            expected_oks_decode_to_input_space, oks_convolve_plain, oks_filter_taps, symmetric_pad,
        )
        from probpose_code_torch.ops.kernels.expected_oks import expected_oks_decode, oks_convolve

        hm = torch.from_numpy(peaked_heatmaps(B, K, H, W, seed=3)).cuda()
        size = (192, 256)
        taps = torch.from_numpy(oks_filter_taps(K, H, W)).cuda()
        D = taps.shape[1]
        locs, vals = expected_oks_decode(hm, size)
        locs_p, vals_p = expected_oks_decode_to_input_space(hm, size)
        conv_p = oks_convolve_plain(hm)
        weight = (taps[:, :, None] * taps[:, None, :])[:, None]
        padded = symmetric_pad(hm, D // 2)
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            lib_err = (F_.conv2d(padded, weight, groups=K) - conv_p).abs().max().item()
            if not lib_err < K2_CONV_ATOL:
                raise AssertionError(f"the cuDNN yardstick computes another function: {lib_err:.3e}")
            lib_ms = cuda_time_ms(lambda: F_.conv2d(padded, weight, groups=K), 50)
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
        pad_ms = cuda_time_ms(lambda: symmetric_pad(hm, D // 2), 50)

        # two passes of D multiply-adds over the H x W map
        ops = B * K * 2 * D * 2 * H * W
        out = {}
        for entry, fn, plain, err, nbytes, libms in (
            ("decode", lambda: expected_oks_decode(hm, size), lambda: expected_oks_decode_to_input_space(hm, size),
             max((locs - locs_p).abs().max().item(), (vals - vals_p).abs().max().item()),
             hm.numel() * 4 + B * K * 3 * 4 + K * D * 4, None),
            ("conv", lambda: oks_convolve(hm), lambda: oks_convolve_plain(hm),
             (oks_convolve(hm) - conv_p).abs().max().item(), 2 * hm.numel() * 4 + K * D * 4, lib_ms),
        ):
            out[entry] = dict(
                max_abs_err=err, ms=cuda_time_ms(fn, 50), device_ms=Smoke.kernel_device_ms(fn, "expected_oks_kernel"),
                host_us=Smoke.host_us(fn), plain_ms=cuda_time_ms(plain, 10),
                bound_ms=max(ops / PEAK_F32, nbytes / PEAK_BYTES) * 1e3,
                bound_by="operations" if ops / PEAK_F32 >= nbytes / PEAK_BYTES else "bytes",
                library_ms=libms, mb=nbytes / 1e6,
            )
        for entry, name in (("decode", "K2 expected_oks"), ("conv", "K2b oks_convolve (conv-only entry)")):
            t = out[entry]
            print(f"{name} B={B} K={K} {H}x{W} D={D}: call {t['ms']:.4f} ms, device {t['device_ms']:.4f} ms, "
                  f"host {t['host_us']:.1f} us a call, plain {t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms, "
                  f"{t['bound_by']} ({t['mb']:.2f} MB, {ops / 1e9:.3f} GFLOP), device time "
                  f"{t['device_ms'] / t['bound_ms']:.2f}x its bound, max abs err {t['max_abs_err']:.3e}")
        print(f"K2b yardstick: F.conv2d on the padded maps, groups={K}, ({K}, 1, {D}, {D}) f32 weights, TF32 off: "
              f"{lib_ms:.4f} ms (max abs err {lib_err:.3e}); symmetric pad {pad_ms:.4f} ms; K2b device time "
              f"{out['conv']['device_ms'] / lib_ms:.2f}x the convolution")
        return out

    def timings(self):
        import torch
        import torch.nn as nn

        from probpose_code_torch.ops.kernels.vit_layer import (
            layer_flops, prepare_weights, vit_layer_plain, vit_layer_prepared,
        )

        # K1 at the flagship shape: 64 crops x 2 (flip) = 128 images
        B, N, C, H, F = 128, 192, 384, 12, 1536
        x, p = layer_inputs(B, N, C, F, torch.bfloat16, seed=2)
        kw = dict(num_heads=H, approximate_gelu=True, dtype=torch.bfloat16)
        ln1s, ln1b, wqkv, bqkv, wp, bp, ln2s, ln2b, w1, b1, w2, b2 = p
        lib = nn.TransformerEncoderLayer(
            C, H, F, dropout=0.0, activation="gelu", layer_norm_eps=1e-6, batch_first=True, norm_first=True,
        ).cuda().eval()
        with torch.no_grad():
            lib.self_attn.in_proj_weight.copy_(wqkv.t())
            lib.self_attn.in_proj_bias.copy_(bqkv)
            lib.self_attn.out_proj.weight.copy_(wp.t())
            lib.self_attn.out_proj.bias.copy_(bp)
            lib.linear1.weight.copy_(w1.t())
            lib.linear1.bias.copy_(b1)
            lib.linear2.weight.copy_(w2.t())
            lib.linear2.bias.copy_(b2)
            lib.norm1.weight.copy_(ln1s)
            lib.norm1.bias.copy_(ln1b)
            lib.norm2.weight.copy_(ln2s)
            lib.norm2.bias.copy_(ln2b)
        lib = lib.to(torch.bfloat16)
        with torch.inference_mode():
            # the weights prepared once, as the model's blocks keep them
            w = prepare_weights(*p, num_heads=H, dtype=torch.bfloat16)
            got = vit_layer_prepared(x, w, **kw).float()
            want = vit_layer_plain(x, *p, **kw).float()
            k1_err = (got - want).abs().max().item()
            k1_rel = k1_err / want.abs().max().item()
            if not k1_rel < K1_BF16_REL:
                raise AssertionError(f"K1 at B={B}: rel max err {k1_rel:.3e}")
            k1_ms = cuda_time_ms(lambda: vit_layer_prepared(x, w, **kw), 20)
            k1_plain = cuda_time_ms(lambda: vit_layer_plain(x, *p, **kw), 5)
            k1_lib = cuda_time_ms(lambda: lib(x), 20)
            k1_prod_flops = 2 * B * N * C * (4 * C + 2 * F)
            k1_prod_ms, k1_prod_rate = self.products_rate(lambda: vit_layer_prepared(x, w, **kw), k1_prod_flops)
        k1_bytes = 2 * x.numel() * 2 + sum(t.numel() * (2 if t.dim() == 2 else 4) for t in p)
        k1_ops = layer_flops(B, N, C, F)
        k1_bound = max(k1_ops / PEAK_BF16, k1_bytes / PEAK_BYTES) * 1e3

        k2 = self.k2_timings()
        # K3 at the flagship training shape: 64 crops, bf16, masks that drop some images
        Bt = 64
        kt = self.k3_timings(Bt, N, C, H, F)
        # K4 at the ViTPose-B training shape (f32) and the ProbPose-S shape
        # (bf16: no main path runs it, so it is printed, not recorded in the
        # kernels line); K1 at the ViTPose-B predict shape
        k4 = self.k4_timings(64, N, 12, 64, torch.float32)
        k4b = self.k4_timings(128, N, 12, 32, torch.bfloat16)
        kb = self.k1_f32_timings(128, N, 768, 12, 3072)
        # K1's f32 instance at ViT-S, -L and -H's predict shapes, K4 at ViT-L and -H's training shapes
        k1f = {C: self.k1_f32_timings(128, N, C, H_, F_) for C, H_, F_ in ((384, 12, 1536), *VIT_LARGE_SHAPES)}
        k4f = {C: self.k4_timings(64, N, H_, C // H_, torch.float32) for C, H_, _ in VIT_LARGE_SHAPES}
        self.attention_occupancy_report()

        # the launch counts above belong to the comparisons, not the main paths:
        # K1, K2 and K2b from the flagship predict run, K3 from the flagship
        # train step, K4 from the ViTPose-B train step, K1 at the ViT-B shape
        # from the ViTPose-B predict call
        predict, train = self.record.get("launches", {}), self.record.get("train_launches", {})
        launches = {k: predict.get(k, 0) for k in ("vit_layer", "expected_oks", "oks_convolve")}
        launches.update({k: train.get(k, 0) for k in ("vit_layer_train_fwd", "vit_layer_train_bwd")})
        launches["attention"] = self.record.get("vitpose_train_launches", {}).get("attention", 0)

        self.record["kernels"] = [
            dict(name="vit_layer", route="cuda", source="probpose_code_torch/csrc/vit_layer.cu",
                 replaces="probpose_code_tpu/ops/pallas/vit_layer.py:117", launches=launches["vit_layer"],
                 max_abs_err=k1_err, ms=k1_ms, plain_ms=k1_plain, bound_ms=k1_bound,
                 bound_by="operations" if k1_ops / PEAK_BF16 >= k1_bytes / PEAK_BYTES else "bytes",
                 library_ms=k1_lib),
            dict(name="expected_oks", route="cuda", source="probpose_code_torch/csrc/expected_oks.cu",
                 replaces="probpose_code_tpu/ops/pallas/expected_oks.py:158", launches=launches["expected_oks"],
                 **{key: k2["decode"][key] for key in K2_KEYS}),
            dict(name="oks_convolve", route="cuda", source="probpose_code_torch/csrc/expected_oks.cu",
                 replaces="probpose_code_tpu/ops/pallas/expected_oks.py:51", launches=launches["oks_convolve"],
                 **{key: k2["conv"][key] for key in K2_KEYS}),
        ] + [
            dict(name=f"vit_layer_train_{part}", route="cuda", source="probpose_code_torch/csrc/vit_layer_train.cu",
                 replaces=f"probpose_code_tpu/ops/pallas/vit_layer_train.py:{line}",
                 launches=launches[f"vit_layer_train_{part}"], **kt[part])
            for part, line in (("fwd", 298), ("bwd", 371))
        ] + [
            dict(name="attention", route="cuda", source="probpose_code_torch/csrc/attention.cu",
                 replaces="probpose_code_tpu/ops/pallas/attention.py:73", launches=launches["attention"],
                 **{key: k4[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}),
            dict(name="vit_layer_vitb_f32", route="cuda", source="probpose_code_torch/csrc/vit_layer.cu",
                 replaces="probpose_code_tpu/ops/pallas/vit_layer.py:117",
                 launches=self.record.get("vitpose_launches", {}).get("vit_layer", 0),
                 **{key: kb[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}),
        ] + [
            dict(name=K1_RECORDS[("torch.float32", C)], route="cuda", source="probpose_code_torch/csrc/vit_layer.cu",
                 replaces="probpose_code_tpu/ops/pallas/vit_layer.py:117",
                 launches=self.record.get(key, {}).get("vit_layer", 0),
                 **{k: k1f[C][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
            for C, key in ((384, "vitpose_small_launches"), (1024, "vitpose_large_launches"),
                           (1280, "vitpose_huge_launches"))
        ] + [
            dict(name=K4_RECORDS[C], route="cuda", source="probpose_code_torch/csrc/attention.cu",
                 replaces="probpose_code_tpu/ops/pallas/attention.py:73",
                 launches=self.record.get(key, {}).get("attention", 0),
                 **{k: k4f[C][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
            for C, key in ((1024, "vitpose_large_train_launches"), (1280, "vitpose_huge_train_launches"))
        ]
        # each kernel's launches on every main path of this run (one call, one step, or one val batch)
        paths = dict(flagship_predict="launches", flagship_train="train_launches", vitpose_predict="vitpose_launches",
                     vitpose_train="vitpose_train_launches", vitpose_small_predict="vitpose_small_launches",
                     vitpose_large_predict="vitpose_large_launches", vitpose_huge_predict="vitpose_huge_launches",
                     vitpose_large_train="vitpose_large_train_launches",
                     vitpose_huge_train="vitpose_huge_train_launches", dpm_predict="dpm_launches",
                     dpm_train="dpm_train_launches",
                     hrnet_predict="hrnet_launches", hrnet_train="hrnet_train_launches", res50_predict="res50_launches",
                     hrnet_msra_predict="hrnet_msra_launches", res50_train="res50_train_launches",
                     rtmpose_predict="rtmpose_launches", rtmpose_train="rtmpose_train_launches",
                     rtmpose_val="rtmpose_val_launches", rtmpose_train_runner="rtmpose_runner_launches",
                     rtmpose_aic_train="rtmpose_aic_launches", body8_train_runner="body8_runner_launches",
                     halpe26_runner="halpe26_launches", crowdpose_val="crowdpose_launches",
                     wholebody_rtmpose_predict="wholebody_rtmpose_launches",
                     wholebody_hrnet_predict="wholebody_hrnet_launches",
                     wholebody_cspnext_udp_predict="wholebody_cspnext_launches",
                     wholebody_hrnet_train="wholebody_hrnet_train_launches",
                     wholebody_cspnext_udp_train="wholebody_cspnext_udp_train_launches",
                     wholebody_hrnet_val="wholebody_hrnet_val_launches",
                     wholebody_train_runner="wholebody_runner_launches", ubody_train="ubody_launches")
        # K1's and K4's one counter each read for the record of the instance each path ran
        instances = dict(vit_layer=(K1_RECORDS, self.record.get("k1_records", {})),
                         attention=(K4_RECORDS, self.record.get("k4_records", {})))
        for counter, (_, records) in instances.items():
            for path, key in paths.items():
                if self.record.get(key, {}).get(counter, 0) and path not in records:
                    raise AssertionError(f"{path} launched {counter} but recorded no instance")
        for entry in self.record["kernels"]:
            by_path = {}
            for path, key in paths.items():
                counts = self.record.get(key, {})
                by_path[path] = counts.get(entry["name"], 0)
                for counter, (names, records) in instances.items():
                    if entry["name"] in names.values():
                        by_path[path] = counts.get(counter, 0) if records.get(path) == entry["name"] else 0
            entry["launches_by_path"] = by_path
            for counter, (names, records) in instances.items():
                if entry["name"] in names.values():
                    ran = {path for path, n in by_path.items() if n}
                    want = {path for path, name in records.items() if name == entry["name"]}
                    if ran != want:
                        raise AssertionError(f"{entry['name']}: launched on {sorted(ran)}, its instance ran on "
                                             f"{sorted(want)}")
        print(f"K1 vit_layer B={B} N={N} C={C} bf16: {k1_ms:.3f} ms, plain {k1_plain:.3f} ms, "
              f"nn.TransformerEncoderLayer (erf GELU, max-shifted softmax) {k1_lib:.3f} ms, "
              f"bound {k1_bound:.4f} ms ({k1_ops / 1e9:.1f} GFLOP, {k1_bytes / 1e6:.1f} MB), "
              f"{k1_ops / (k1_ms * 1e-3) / 1e12:.1f} TFLOP/s, {k1_ms / k1_bound:.1f}x its bound, "
              f"{k1_ms / k1_lib:.2f}x the library; its products ({k1_prod_flops / 1e9:.1f} GFLOP) "
              f"{k1_prod_ms:.3f} ms of GEMM device time, {k1_prod_rate:.1f} TFLOP/s")
        for part in ("fwd", "bwd"):
            t = kt[part]
            print(f"K3 vit_layer_train {part} B={Bt} N={N} C={C} bf16: {t['ms']:.3f} ms, plain {t['plain_ms']:.3f} ms, "
                  f"nn.TransformerEncoderLayer {part} (erf GELU, max-shifted softmax) {t['library_ms']:.3f} ms, "
                  f"bound {t['bound_ms']:.4f} ms ({kt['gflop'][part]:.1f} GFLOP, {kt['mb'][part]:.1f} MB), "
                  f"{t['ms'] / t['bound_ms']:.1f}x its bound, {t['ms'] / t['library_ms']:.2f}x the library, "
                  f"max abs err {t['max_abs_err']:.3e} (relative to the largest value {kt['rel'][part]:.2e}); "
                  f"its products ({kt['prod_gflop'][part]:.1f} GFLOP) {kt['prod_ms'][part]:.3f} ms of GEMM "
                  f"device time, {kt['prod_rate'][part]:.1f} TFLOP/s")
        for t, shape in ((k4, "B=64 N=192 h=12 d=64 f32"), (k4b, "B=128 N=192 h=12 d=32 bf16")):
            print(f"K4 attention {shape} (strided qkv views): {t['ms']:.3f} ms, "
                  f"plain {t['plain_ms']:.3f} ms, F.scaled_dot_product_attention {t['library_ms']:.3f} ms, "
                  f"bound {t['bound_ms']:.4f} ms, {t['bound_by']} ({t['gflop']:.2f} GFLOP, {t['mb']:.1f} MB), "
                  f"{t['gflop'] / t['ms']:.1f} TFLOP/s, {t['ms'] / t['bound_ms']:.1f}x its bound, "
                  f"{t['ms'] / t['library_ms']:.2f}x the library, max abs err {t['max_abs_err']:.3e} "
                  f"(relative to the largest value {t['rel']:.2e})")
        for what, C, H_, t in (("ViTPose-B", 768, 12, kb), ("ViTPose-S f32", 384, 12, k1f[384]),
                               ("ViTPose-L", 1024, 16, k1f[1024]), ("ViTPose-H", 1280, 16, k1f[1280])):
            print(f"K1 vit_layer at the {what} predict shape B=128 N={N} C={C} h={H_} d={C // H_} f32 erf: "
                  f"{t['ms']:.3f} ms, plain {t['plain_ms']:.3f} ms, nn.TransformerEncoderLayer "
                  f"{t['library_ms']:.3f} ms, bound {t['bound_ms']:.4f} ms, {t['bound_by']} ({t['gflop']:.1f} GFLOP), "
                  f"{t['gflop'] / t['ms']:.1f} TFLOP/s, {t['ms'] / t['bound_ms']:.1f}x its bound, "
                  f"{t['ms'] / t['library_ms']:.2f}x the library, rel max err {t['rel']:.2e}; its products "
                  f"({t['prod_gflop']:.1f} GFLOP) {t['prod_ms']:.3f} ms of GEMM device time, "
                  f"{t['prod_rate']:.1f} TFLOP/s; its attention (attention_fwd_kernel) {t['attn_ms']:.3f} ms of "
                  f"its {t['device_ms']:.3f} ms device time ({100 * t['attn_ms'] / t['device_ms']:.1f}%)")
        for C, H_, _ in VIT_LARGE_SHAPES:
            t = k4f[C]
            print(f"K4 attention at the ViTPose-{'L' if C == 1024 else 'H'} training shape B=64 N={N} h={H_} "
                  f"d={C // H_} f32 (strided qkv views): {t['ms']:.3f} ms, plain {t['plain_ms']:.3f} ms, "
                  f"F.scaled_dot_product_attention {t['library_ms']:.3f} ms, bound {t['bound_ms']:.4f} ms, "
                  f"{t['bound_by']} ({t['gflop']:.2f} GFLOP, {t['mb']:.1f} MB), {t['gflop'] / t['ms']:.1f} TFLOP/s, "
                  f"{t['ms'] / t['bound_ms']:.1f}x its bound, {t['ms'] / t['library_ms']:.2f}x the library, "
                  f"max abs err {t['max_abs_err']:.3e}")

    @staticmethod
    def attention_occupancy_report():
        """What the attention engine's instances hold on an SM at the shapes
        the ViT paths give them (N = 192; f32 heads of 64 and 80, bf16 of
        32) and, for heads of 80, the two-pass instance that N = 193 takes:
        registers and spills a thread, shared memory a block, resident warps
        an SM, from the card's function attributes (nothing is launched).
        Fails where K1's or K4's f32 instance at heads of 80 keeps fewer than
        8 warps on an SM."""
        import torch

        from probpose_code_torch.ops.kernels.attention import attention_occupancy

        rows = {}
        for what, dtype, N, D in (("f32", torch.float32, 192, 64), ("f32", torch.float32, 192, 80),
                                  ("f32 two-pass", torch.float32, 193, 80), ("bf16", torch.bfloat16, 192, 32)):
            for kernel, shift in (("K4", True), ("K1", False)):
                o = attention_occupancy(dtype, N, D, shift)
                rows[(kernel, what, N, D)] = o
                print(f"attention instance {kernel} {what} N={N} d={D}: {o['registers']} registers a thread, "
                      f"{o['local_bytes']} B local memory a thread (spills), {o['smem_bytes']} B shared memory and "
                      f"{o['threads']} threads a block, {o['blocks_per_sm']} blocks and {o['warps_per_sm']} warps "
                      f"an SM")
        for kernel in ("K4", "K1"):
            if rows[(kernel, "f32", 192, 80)]["warps_per_sm"] < 8:
                raise AssertionError(f"{kernel}'s f32 attention at heads of 80 keeps fewer than 8 warps an SM")

    @staticmethod
    def k4_timings(B, N, H, D, dtype):
        """K4 on strided views of a (B, N, 3, h, d) projection, its plain twin,
        and F.scaled_dot_product_attention on the same values in its
        (B, h, N, d) layout (the transposes are made before timing); the
        bound from QK^T and PV's operations (bf16 at the bf16 peak, f32 as
        3xTF32) and q, k, v read once and the output written once."""
        import torch
        import torch.nn.functional as F_

        from probpose_code_torch.ops.kernels.attention import (
            attention_flops, attention_kernel, fused_attention_plain,
        )

        q, k, v = qkv_views(B, N, H, D, dtype, seed=9)
        scale = D ** -0.5
        got = attention_kernel(q, k, v, scale).float()
        want = fused_attention_plain(q, k, v, scale).float()
        err = (got - want).abs().max().item()
        rel = err / want.abs().max().item()
        if not (err < K4_F32_ATOL if dtype == torch.float32 else rel < K4_BF16_REL):
            raise AssertionError(f"K4 {dtype} at B={B}: max abs err {err:.3e}, relative {rel:.3e}")
        ms = cuda_time_ms(lambda: attention_kernel(q, k, v, scale), 20)
        plain = cuda_time_ms(lambda: fused_attention_plain(q, k, v, scale), 5)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        lib = cuda_time_ms(lambda: F_.scaled_dot_product_attention(qt, kt, vt, scale=scale), 20)
        ops = attention_flops(B, N, H, D)
        peak = PEAK_F32_3XTF32 if dtype == torch.float32 else PEAK_BF16
        nbytes = 4 * B * N * H * D * q.element_size()
        return dict(max_abs_err=err, rel=rel, ms=ms, plain_ms=plain, library_ms=lib,
                    bound_ms=max(ops / peak, nbytes / PEAK_BYTES) * 1e3,
                    bound_by="operations" if ops / peak >= nbytes / PEAK_BYTES else "bytes",
                    gflop=ops / 1e9, mb=nbytes / 1e6)

    @staticmethod
    def k1_f32_timings(B, N, C, H, F):
        """K1 on prepared f32 weights with exact GELU, its plain twin and
        nn.TransformerEncoderLayer (f32, erf GELU) at one layer of a ViTPose
        predict call (64 crops and their mirrors; ViT-S, -B, -L or -H); the
        bound with the products as 3xTF32, the rate of the layer's
        products from the device time of its GEMM kernels, and its
        attention's device time beside the layer's."""
        import torch
        import torch.nn as nn

        from probpose_code_torch.ops.kernels.vit_layer import (
            layer_flops, prepare_weights, vit_layer_plain, vit_layer_prepared,
        )

        dt = torch.float32
        x, p = layer_inputs(B, N, C, F, dt, seed=10)
        kw = dict(num_heads=H, approximate_gelu=False, dtype=dt)
        lib = nn.TransformerEncoderLayer(
            C, H, F, dropout=0.0, activation="gelu", layer_norm_eps=1e-6, batch_first=True, norm_first=True,
        ).cuda().eval()
        with torch.inference_mode():
            w = prepare_weights(*p, num_heads=H, dtype=dt)
            got = vit_layer_prepared(x, w, **kw)
            want = vit_layer_plain(x, *p, **kw)
            err = (got - want).abs().max().item()
            rel = err / want.abs().max().item()
            if not rel < K1_F32_REL:
                raise AssertionError(f"K1 at C={C}: rel max err {rel:.3e}")
            ms = cuda_time_ms(lambda: vit_layer_prepared(x, w, **kw), 5, warmup=1)
            plain = cuda_time_ms(lambda: vit_layer_plain(x, *p, **kw), 3, warmup=1)
            libms = cuda_time_ms(lambda: lib(x), 5, warmup=1)
            prod_flops = 2 * B * N * C * (4 * C + 2 * F)
            prod_ms, prod_rate = Smoke.products_rate(lambda: vit_layer_prepared(x, w, **kw), prod_flops, calls=2)
            attn_ms = Smoke.kernel_device_ms(lambda: vit_layer_prepared(x, w, **kw), "attention_fwd_kernel", calls=3)
            device_ms = Smoke.kernel_device_ms(lambda: vit_layer_prepared(x, w, **kw), calls=3)
        ops = layer_flops(B, N, C, F)
        nbytes = 2 * x.numel() * 4 + sum(t.numel() * 4 for t in p)
        return dict(ms=ms, plain_ms=plain, library_ms=libms, rel=rel, max_abs_err=err, gflop=ops / 1e9,
                    bound_ms=max(ops / PEAK_F32_3XTF32, nbytes / PEAK_BYTES) * 1e3,
                    bound_by="operations" if ops / PEAK_F32_3XTF32 >= nbytes / PEAK_BYTES else "bytes",
                    prod_gflop=prod_flops / 1e9, prod_ms=prod_ms, prod_rate=prod_rate, attn_ms=attn_ms,
                    device_ms=device_ms)

    @staticmethod
    def k3_timings(B, N, C, H, F):
        """K3's forward and backward kernels, their plain twin (forward, and
        autograd's backward through it) and nn.TransformerEncoderLayer's
        forward and backward, at one layer of the training shape; the bound
        of each half from its operations (forward: the layer's products;
        backward: twice those, the least a backward can do) and its bytes
        (each input read once, each output written once)."""
        import torch
        import torch.nn as nn

        from probpose_code_torch.ops.kernels.vit_layer import _fold_q_scale, layer_flops
        from probpose_code_torch.ops.kernels.vit_layer_train import (
            _operands, vit_layer_train_backward, vit_layer_train_forward, vit_layer_train_plain,
        )

        dt = torch.bfloat16
        x, p = layer_inputs(B, N, C, F, dt, seed=4)
        m1, m2 = drop_masks(B, 0.9, seed=4)
        g = torch.randn(B, N, C, generator=torch.Generator().manual_seed(5)).cuda().to(dt)
        w_qkv, b_qkv = _fold_q_scale(p[2], p[3], C // H)
        ops = _operands([p[0], p[1], w_qkv, b_qkv, *p[4:]], dt)
        kw = dict(num_heads=H, eps=1e-6)
        out, saved = vit_layer_train_forward(x, m1, m2, ops, **kw)
        grads = vit_layer_train_backward(g, x, m1, m2, ops, saved, **kw)
        fwd_ms = cuda_time_ms(lambda: vit_layer_train_forward(x, m1, m2, ops, **kw), 10)
        bwd_ms = cuda_time_ms(lambda: vit_layer_train_backward(g, x, m1, m2, ops, saved, **kw), 10)
        # the products: forward qkv, proj, fc1, fc2; backward their dx products and weight gradients
        prod = {"fwd": 2 * B * N * C * (4 * C + 2 * F)}
        prod["bwd"] = 2 * prod["fwd"]
        rates = {"fwd": Smoke.products_rate(lambda: vit_layer_train_forward(x, m1, m2, ops, **kw), prod["fwd"]),
                 "bwd": Smoke.products_rate(lambda: vit_layer_train_backward(g, x, m1, m2, ops, saved, **kw),
                                            prod["bwd"])}

        xs = x.clone().requires_grad_(True)
        ps = [t.clone().requires_grad_(True) for t in p]
        want = vit_layer_train_plain(xs, *ps, m1, m2, num_heads=H, dtype=dt)
        want_grads = torch.autograd.grad(want, [xs, *ps], g, retain_graph=True)
        # the twin's w_qkv / b_qkv gradients are the un-scaled ones; the kernel's are for the folded operands
        col = torch.ones(3 * C, device="cuda")
        col[:C] = (C // H) ** -0.5
        got_grads = [grads[0], *grads[1:3], grads[3] * col, grads[4] * col, *grads[5:]]
        fwd_err = (out.float() - want.float()).abs().max().item()
        bwd_err = max((a.float() - b.float()).abs().max().item() for a, b in zip(got_grads, want_grads))
        rel = dict(fwd=fwd_err / want.float().abs().max().item(),
                   bwd=max(((a.float() - b.float()).abs().max() / b.float().abs().max()).item()
                           for a, b in zip(got_grads, want_grads)))
        if not max(rel.values()) < K3_BF16_REL:
            raise AssertionError(f"K3 at B={B}: relative max errors {rel}")
        fwd_plain = cuda_time_ms(lambda: vit_layer_train_plain(xs, *ps, m1, m2, num_heads=H, dtype=dt), 5)
        bwd_plain = cuda_time_ms(lambda: torch.autograd.grad(want, [xs, *ps], g, retain_graph=True), 5)

        lib = nn.TransformerEncoderLayer(
            C, H, F, dropout=0.0, activation="gelu", layer_norm_eps=1e-6, batch_first=True, norm_first=True,
        ).cuda().to(dt).train()
        xl = x.clone().requires_grad_(True)
        fwd_lib = cuda_time_ms(lambda: lib(xl), 10)
        yl = lib(xl)
        bwd_lib = cuda_time_ms(lambda: torch.autograd.grad(yl, [xl, *lib.parameters()], g, retain_graph=True), 10)

        fwd_ops = layer_flops(B, N, C, F)
        w_bytes = sum(t.numel() * t.element_size() for t in ops)
        act = B * N * C
        # forward: x and the masks in, out and x1 (f32) out; backward: g, x and x1 in, dx and 12 f32 grads out
        fwd_bytes = act * 2 + 2 * B * 4 + w_bytes + act * 2 + act * 4
        bwd_bytes = act * 2 * 2 + act * 4 + 2 * B * 4 + w_bytes + act * 2 + sum(t.numel() * 4 for t in ops)
        result = {}
        for part, ops_, bytes_, ms, plain, libms, err in (
            ("fwd", fwd_ops, fwd_bytes, fwd_ms, fwd_plain, fwd_lib, fwd_err),
            ("bwd", 2 * fwd_ops, bwd_bytes, bwd_ms, bwd_plain, bwd_lib, bwd_err),
        ):
            result[part] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain,
                bound_ms=max(ops_ / PEAK_BF16, bytes_ / PEAK_BYTES) * 1e3,
                bound_by="operations" if ops_ / PEAK_BF16 >= bytes_ / PEAK_BYTES else "bytes",
                library_ms=libms,
            )
        result["rel"] = rel
        result["gflop"] = dict(fwd=fwd_ops / 1e9, bwd=2 * fwd_ops / 1e9)
        result["mb"] = dict(fwd=fwd_bytes / 1e6, bwd=bwd_bytes / 1e6)
        result["prod_gflop"] = {k: v / 1e9 for k, v in prod.items()}
        result["prod_ms"] = {k: v[0] for k, v in rates.items()}
        result["prod_rate"] = {k: v[1] for k, v in rates.items()}
        return result


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "probpose_code_torch").is_dir():
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))

    card = card_line()
    print(f"card: {card}", flush=True)
    # loader workers import this script again, and a pool starts them one after another: run by its path, the
    # script would be compiled anew in each; by name, each reads the bytecode compiled here once
    script = str(ROOT / "chip_smoke.py")
    py_compile.compile(script, cfile=importlib.util.cache_from_source(script), doraise=True)
    sys.modules["__main__"].__spec__ = importlib.util.find_spec("chip_smoke")
    from probpose_code_torch.datasets.loader import keep_workers

    smoke = Smoke()
    with keep_workers():  # the fork server starts once for the run's passes, not once a pass
        smoke.phase("build", smoke.build)
        if not smoke.failures:
            smoke.phase("k1_parity", smoke.k1_parity)
            smoke.phase("k2_parity", smoke.k2_parity)
            smoke.phase("k3_parity", smoke.k3_parity)
            smoke.phase("golden", smoke.golden)
            smoke.phase("checkpoint_file", smoke.checkpoint_file)
            smoke.phase("flagship", smoke.flagship)
            smoke.phase("train", smoke.train)
            smoke.phase("k4_parity", smoke.k4_parity)
            smoke.phase("vitpose_predict", smoke.vitpose_predict)
            smoke.phase("vitpose_train", smoke.vitpose_train)
            smoke.phase("vit_large_parity", smoke.vit_large_parity)
            smoke.phase("vitpose_small_predict", smoke.vitpose_small_predict)
            smoke.phase("vitpose_large_predict", smoke.vitpose_large_predict)
            smoke.phase("vitpose_huge_predict", smoke.vitpose_huge_predict)
            smoke.phase("vitpose_large_train", smoke.vitpose_large_train)
            smoke.phase("vitpose_huge_train", smoke.vitpose_huge_train)
            smoke.phase("jpeg_decode", smoke.jpeg_decode)
            smoke.phase("val_full", smoke.val_full)
            smoke.phase("val_full_jpeg", smoke.val_full_jpeg)
            smoke.phase("val_shipped", smoke.val_shipped)
            smoke.phase("val_flagship", smoke.val_flagship)
            smoke.phase("train_flagship", smoke.train_flagship)
            smoke.phase("serve", smoke.serve)
            smoke.phase("dpm_predict", smoke.dpm_predict)
            smoke.phase("dpm_train", smoke.dpm_train)
            smoke.phase("hrnet_golden", smoke.hrnet_golden)
            smoke.phase("hrnet_predict", smoke.hrnet_predict)
            smoke.phase("hrnet_train", smoke.hrnet_train)
            smoke.phase("classic_golden", smoke.classic_golden)
            smoke.phase("gau_parity", smoke.gau_parity)
            smoke.phase("rtmpose_golden", smoke.rtmpose_golden)
            smoke.phase("res50_predict", smoke.res50_predict)
            smoke.phase("hrnet_msra_predict", smoke.hrnet_msra_predict)
            smoke.phase("res50_train", smoke.res50_train)
            smoke.phase("rtmpose_predict", smoke.rtmpose_predict)
            smoke.phase("rtmpose_train", smoke.rtmpose_train)
            smoke.phase("rtmpose_augment", smoke.rtmpose_augment)
            smoke.phase("rtmpose_train_runner", smoke.rtmpose_train_runner)
            smoke.phase("rtmpose_aic_train", smoke.rtmpose_aic_train)
            smoke.phase("body8_train_runner", smoke.body8_train_runner)
            smoke.phase("halpe26_runner", smoke.halpe26_runner)
            smoke.phase("crowdpose_val", smoke.crowdpose_val)
            smoke.phase("wholebody_golden", smoke.wholebody_golden)
            smoke.phase("wholebody_predict", smoke.wholebody_predict)
            smoke.phase("wholebody_train", smoke.wholebody_train)
            smoke.phase("wholebody_train_runner", smoke.wholebody_train_runner)
            smoke.phase("ubody_train", smoke.ubody_train)
            smoke.phase("face_golden", smoke.face_golden)
            smoke.phase("face_hand_predict", smoke.face_hand_predict)
            smoke.phase("face6_train_runner", smoke.face6_train_runner)
            smoke.phase("hand5_train", smoke.hand5_train)
            smoke.phase("face_hand_kernels", smoke.face_hand_kernels)
            smoke.phase("face_hand_train", smoke.face_hand_train)
            smoke.phase("dpm_golden", smoke.dpm_golden)
            smoke.phase("animal_fashion_predict", smoke.animal_fashion_predict)
            smoke.phase("animal_fashion_runner", smoke.animal_fashion_runner)
            smoke.phase("cnn_zoo_golden", smoke.cnn_zoo_golden)
            smoke.phase("cnn_zoo_predict", smoke.cnn_zoo_predict)
            smoke.phase("cnn_zoo_kernels", smoke.cnn_zoo_kernels)
            smoke.phase("cnn_zoo_train", smoke.cnn_zoo_train)
            smoke.phase("timings", smoke.timings)
            smoke.phase("multistage_golden", smoke.multistage_golden)
            smoke.phase("multistage_predict", smoke.multistage_predict)
            smoke.phase("multistage_train", smoke.multistage_train)
            smoke.phase("rtmw_runner", smoke.rtmw_runner)
            smoke.phase("topdown_rest_golden", smoke.topdown_rest_golden)
            smoke.phase("topdown_rest_kernels", smoke.topdown_rest_kernels)
            smoke.phase("topdown_rest_predict", smoke.topdown_rest_predict)
            smoke.phase("topdown_rest_train", smoke.topdown_rest_train)
            smoke.phase("topdown_rest_runner", smoke.topdown_rest_runner)
            smoke.phase("regression_golden", smoke.regression_golden)
            smoke.phase("regression_predict", smoke.regression_predict)
            smoke.phase("regression_train", smoke.regression_train)
            smoke.phase("regression_runner", smoke.regression_runner)
            smoke.phase("regression_kernels", smoke.regression_kernels)
    left = stop_descendants()
    if left:
        print(f"chip_smoke: stopped processes left running: {left}", file=sys.stderr)
    if smoke.failures:
        print(f"chip_smoke: failed phases: {', '.join(smoke.failures)}", file=sys.stderr)
        return 1
    print(card)
    print(json.dumps({"kernels": smoke.record["kernels"]}))
    # the JPEG decode, no TPU kernel: its own line, its launches those of val_flagship's main path
    print(json.dumps({"decode": dict(smoke.record["decode"], launches=smoke.record["decode_launches"])}))
    # the photometric kernels, no TPU kernel: their own line, the median's launches those of
    # rtmpose_train_runner's main path, the distortion's of body8_train_runner's,
    paths = dict(photometric_median="augment_launches", photometric_distortion="body8_augment_launches")
    # and each one's launches on every path that augments on the card
    by_path = dict(rtmpose_train_runner="augment_launches", body8_train_runner="body8_augment_launches",
                   wholebody_train_runner="wholebody_augment_launches", ubody_train="ubody_augment_launches",
                   face6_train_runner="face6_augment_launches", hand5_train="hand5_augment_launches")
    print(json.dumps({"augment": [dict(rec, launches=smoke.record[paths[rec["name"]]][rec["name"]],
                                       launches_by_path={path: smoke.record[key][rec["name"]]
                                                         for path, key in by_path.items()})
                                  for rec in smoke.record["augment"]]}))
    # the GAU kernels, no TPU kernel: their own line, their launches those of wholebody_train_runner's main
    # path, and on every path that runs RTMPose's head
    gau = smoke.record["gau_launches"]
    print(json.dumps({"gau": [dict(rec, launches=gau["wholebody_train_runner"][rec["name"]],
                                   launches_by_path={path: n[rec["name"]] for path, n in gau.items()})
                              for rec in smoke.record["gau"]]}))
    # the face and hand recipes' kernels, no TPU kernel: their own line, the depthwise kernels' launches those of
    # MobileNetV2's hand step, AdaptiveWingLoss's those of HRNetV2-w18's WFLW step, and each one's on every path
    face_hand = smoke.record["face_hand_launches"]
    main_path = dict(depthwise_forward="mobilenetv2_hand_train", depthwise_backward="mobilenetv2_hand_train",
                     adaptive_wing_forward="hrnetv2_awing_train", adaptive_wing_backward="hrnetv2_awing_train")
    print(json.dumps({"face_hand": [dict(rec, launches=face_hand[main_path[rec["name"]]][rec["name"]],
                                         launches_by_path={path: n[rec["name"]] for path, n in face_hand.items()})
                                    for rec in smoke.record["face_hand_kernels"]]}))
    # the CNN backbones' kernels, no TPU kernel: their own line, SCNet's gate's launches those of SCNet-50's
    # train step, the split attention's those of ResNeSt-50's, the squeeze and excite's those of ViPNAS-Res50's,
    # and each one's on every path
    cnn_zoo = smoke.record["cnn_zoo_launches"]
    main_path = dict(sc_gate_forward="scnet50_train", sc_gate_backward="scnet50_train",
                     split_attention_forward="resnest50_train", split_attention_backward="resnest50_train",
                     se_layer_forward="vipnas-res50_train", se_layer_backward="vipnas-res50_train")
    print(json.dumps({"cnn_zoo": [dict(rec, launches=cnn_zoo[main_path[rec["name"]]][rec["name"]],
                                       launches_by_path={path: n[rec["name"]] for path, n in cnn_zoo.items()})
                                  for rec in smoke.record["cnn_zoo_kernels"]]}))
    # the normalisation kernels, no TPU kernel: their own line, BatchNorm's launches those of LiteHRNet-18's train
    # step, LayerNorm's those of Swin-T's, and each one's on every main path
    norms = smoke.record["norm_launches"]
    print(json.dumps({"norms": [dict(rec, launches=norms[rec.pop("main_path")][rec["name"]],
                                     launches_by_path={path: n[rec["name"]] for path, n in norms.items()})
                                for rec in smoke.record["norm_kernels"]]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
