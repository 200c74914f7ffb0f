#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (probpose_code_torch) on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one CUDA
card and the CUDA toolkit (nvcc); it builds the port's kernels from
``probpose_code_torch/csrc`` first. Phases, each of which fails the run:

1. the card's name and power limit, and the kernels' build time;
2. K1 (whole ViT layer) against its plain twin at the flagship layer shape;
3. K2 (expected-OKS decode) and its conv-only entry against their plain twin;
4. K3 (the differentiable ViT layer): forward and all 13 gradients against
   its plain twin, at a small f32 shape and at the flagship layer shape in
   bf16 with stochastic-depth masks that drop some images;
5. the golden tiny ProbPose fixture end to end through ``init_model`` and
   ``inference_topdown``, against the reference keypoints;
6. the flagship ProbPose-S predict at full width (random weights, seed 0),
   64 boxes with flip-TTA: the kernels' launch counts in one call, then
   crops/s;
7. the flagship training recipe at full width (random weights, seed 0, a
   synthetic batch of 64 crops, targets encoded on the card, drop_path 0.1)
   through ``make_train_step``: the kernels' launch counts in one step, the
   losses, lr and gradient norm of each step, train crops/s and a profile;
8. ``k4_parity``: K4 (the attention core) against its plain twin at the
   ViTPose-B training shape in f32 and the ProbPose-S shape in bf16, and one
   gradient through its autograd Function against autograd through
   ``xla_attention``;
9. ``vitpose_predict``: ViTPose-B-simple (ViT-B/16, f32, erf GELU, x4 neck,
   HeatmapHead, UDP decode) at full width through ``init_model`` /
   ``inference_topdown``, 64 boxes with flip-TTA: K1's launches in one call
   (12), the outputs finite, every positive heatmap peak inside its crop's
   padded box, two crops' heatmaps and scores against the same model on the
   CPU, then crops/s and a profile;
10. ``vitpose_train``: the ViTPose-B-simple recipe (drop_path 0.3, UDP
   targets encoded on the card, AdamW with layer decay 0.75) through
   ``make_train_step`` on 64 crops: K4's launches in one step (12, and K3's
   0), the losses, lr and gradient norm of each step, train crops/s, peak
   memory and a profile;
11. ``timings``: each kernel's time beside its plain twin's, a PyTorch
   library call's where one computes the same function, and its bound from
   this run's shapes; K1 also at the ViT-B predict shape (f32), K4 also at
   the ProbPose-S shape in bf16. For K1 (bf16 and f32) and K3 (forward,
   backward) also the time over the bound and the rate of the layer's
   products: their operations over the device time of the GEMM kernels in a
   profile of a few calls.

The line before the last holds the kernels' record as JSON, the last line
``{"ok": true, "device": ...}``. Any failure exits non-zero without them.
It imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "golden"
FLAGSHIP = ROOT / "configs/body_2d_keypoint/topdown_probmap/coco/td-pm_ProbPose-small_8xb64-210e_coco-256x192.py"
VITPOSE = ROOT / "configs/body_2d_keypoint/topdown_heatmap/coco/td-hm_ViTPose-base-simple_8xb64-210e_coco-256x192.py"

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, f32 outside
# them (the FMA units: K2 and K3's f32 instance), and device memory.
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
# f32-accurate products on the tensor cores: 3xTF32 issues three TF32
# products (hi.hi, hi.lo, lo.hi) for each one, so a third of the 495 TFLOP/s
# TF32 peak. It bounds the f32 products of K1 and K4, which run so.
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
K3_NAMES = ("out", "dx", "ln1_scale", "ln1_bias", "w_qkv", "b_qkv", "w_proj", "b_proj",
            "ln2_scale", "ln2_bias", "w_fc1", "b_fc1", "w_fc2", "b_fc2")
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


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


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


def golden_samples(model):
    """The golden fixture's 24 images and boxes through ``inference_topdown``.
    Returns (fixture arrays, samples with the annotation id / image id set)."""
    import numpy as np

    from probpose_code_torch.apis import inference_topdown

    data = np.load(GOLDEN / "e2e_pipeline.npz")
    gt = json.loads((GOLDEN / "e2e_coco.json").read_text())
    anns = {}
    for a in gt["annotations"]:
        anns.setdefault(a["image_id"], []).append(a)
    samples = []
    for im in gt["images"]:
        boxes = np.array([[a["bbox"][0], a["bbox"][1], a["bbox"][0] + a["bbox"][2], a["bbox"][1] + a["bbox"][3]]
                          for a in anns[im["id"]]], np.float32)
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


def kernel_counters():
    """Each kernel wrapper, whose ``launches`` counts its kernel's launches."""
    from probpose_code_torch.ops.kernels.attention import attention_kernel
    from probpose_code_torch.ops.kernels.expected_oks import expected_oks_decode, oks_convolve
    from probpose_code_torch.ops.kernels.vit_layer import vit_layer_prepared
    from probpose_code_torch.ops.kernels.vit_layer_train import vit_layer_train_backward, vit_layer_train_forward

    return dict(vit_layer=vit_layer_prepared, expected_oks=expected_oks_decode, oks_convolve=oks_convolve,
                vit_layer_train_fwd=vit_layer_train_forward, vit_layer_train_bwd=vit_layer_train_backward,
                attention=attention_kernel)


def reset_counts():
    """Every kernel's count set to 0; returns a reader of the counts."""
    counters = kernel_counters()
    for c in counters.values():
        c.launches = 0
    return lambda: {k: c.launches for k, c in counters.items()}


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


class Smoke:
    def __init__(self):
        self.failures = []
        self.record = {}

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

        from probpose_code_torch.ops.decode import expected_oks_decode_to_input_space, oks_convolve_plain
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
        print(f"flagship main path: {len(samples)} crops, launches {json.dumps(launches)}")
        kpts = np.stack([s.pred_instances.keypoints for s in samples])
        fields = [np.stack([s.pred_instances[f] for s in samples]) for f in
                  ("keypoint_scores", "keypoints_probs", "keypoints_visible", "keypoints_oks", "keypoints_error")]
        if kpts.shape != (64, 1, 17, 2) or any(f.shape != (64, 1, 17) for f in fields):
            raise AssertionError(f"flagship output shapes {kpts.shape}, {[f.shape for f in fields]}")
        if not (np.isfinite(kpts).all() and all(np.isfinite(f).all() for f in fields)):
            raise AssertionError("flagship outputs are not finite")
        if launches != dict(vit_layer=12, expected_oks=1, oks_convolve=0, vit_layer_train_fwd=0, vit_layer_train_bwd=0,
                            attention=0):
            raise AssertionError(f"expected K1 x12 and K2 x1 per call and no other kernel, got {launches}")
        self.record["launches"] = launches

        iters = 10
        for _ in range(3):
            inference_topdown(model, img, boxes)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            inference_topdown(model, img, boxes)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
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
        print(f"flagship ProbPose-S train step, B={B}, bf16, drop_path 0.1: {B * steps / dt:.1f} crops/s "
              f"({1e3 * dt / steps:.2f} ms per step, {steps} steps after 3 warm-up; the loss dicts are read "
              f"to the host after the timed steps); peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        self.profile(lambda: run(1), calls=2, what="train steps")

    def k4_parity(self):
        import torch

        from probpose_code_torch.ops.kernels.attention import (
            fused_attention, fused_attention_plain, xla_attention_plain,
        )

        # the ViTPose-B training shape in f32: max abs error on unit-normal inputs
        B, N, H, D = 64, 192, 12, 64
        q, k, v = qkv_views(B, N, H, D, torch.float32, seed=6)
        with torch.no_grad():
            err = (fused_attention(q, k, v, D ** -0.5) - fused_attention_plain(q, k, v, D ** -0.5)).abs().max().item()
        print(f"K4 B={B} N={N} h={H} d={D} f32: max abs err {err:.3e} (bar {K4_F32_ATOL:g})")
        if not err < K4_F32_ATOL:
            raise AssertionError(f"K4 f32 disagrees with its plain twin: {err:.3e}")
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
        # one gradient through the Function on the card (the kernel's forward, the
        # strided qkv views saved and recomputed there) against autograd through
        # xla_attention on CPU copies of the same inputs
        g = torch.randn(B, N, H, D, generator=torch.Generator().manual_seed(8))
        qkv = torch.stack((q, k, v), dim=2).detach().requires_grad_(True)
        (card,) = torch.autograd.grad(fused_attention(*qkv.unbind(2), D ** -0.5), qkv, g.cuda())
        qkv = qkv.detach().cpu().requires_grad_(True)
        (host,) = torch.autograd.grad(xla_attention_plain(*qkv.unbind(2), D ** -0.5), qkv, g)
        gerr = (card.cpu() - host).abs().max().item()
        print(f"K4 gradient (dq, dk, dv) on the card vs autograd through xla_attention on the CPU: "
              f"max abs err {gerr:.3e} (bar {K4_GRAD_ATOL:g})")
        if not gerr < K4_GRAD_ATOL:
            raise AssertionError(f"K4's gradient disagrees: {gerr:.3e}")

    def vitpose_predict(self):
        import numpy as np
        import torch

        from probpose_code_torch.apis import inference_topdown, init_model
        from probpose_code_torch.apis.inference import crop_batch
        from probpose_code_torch.config import Config
        from probpose_code_torch.ops.heatmap import heatmap_maximum_batch

        model = init_model(Config.fromfile(VITPOSE), device="cuda")
        img, boxes = synthetic_boxes(64, seed=1)

        # the main path: counts set to 0 just before, read just after
        read_counts = reset_counts()
        samples = inference_topdown(model, img, boxes)
        torch.cuda.synchronize()
        launches = read_counts()
        print(f"vitpose predict main path: {len(samples)} crops, launches {json.dumps(launches)}")
        kpts = np.stack([s.pred_instances.keypoints for s in samples])
        scores = np.stack([s.pred_instances.keypoint_scores for s in samples])
        if kpts.shape != (64, 1, 17, 2) or scores.shape != (64, 1, 17):
            raise AssertionError(f"vitpose output shapes {kpts.shape}, {scores.shape}")
        if not (np.isfinite(kpts).all() and np.isfinite(scores).all()):
            raise AssertionError("vitpose outputs are not finite")
        # every positive heatmap peak maps inside its crop's padded box (a map
        # whose maximum is <= 0 has no peak: its location is -1, as in the
        # JAX decode). The DARK-UDP step that follows is a Newton step on
        # random-weight maps, which may carry a keypoint out of the box (as
        # the JAX decode does); how far is printed, and the refined values are
        # held against the CPU twin below.
        crops, centers, scales = crop_batch(img, boxes, model.input_size, model.device)
        hm = model.predict(crops)["heatmaps"]
        peaks, vals = (t.cpu().numpy() for t in heatmap_maximum_batch(hm))
        hm_wh = np.asarray([hm.shape[3] - 1, hm.shape[2] - 1], np.float32)  # UDP: the map's ends are the crop's
        lo, hi = (centers - scales / 2)[:, None], (centers + scales / 2)[:, None]
        peaks = peaks / hm_wh * scales[:, None] + lo
        inside = ((peaks >= lo - 1e-3) & (peaks <= hi + 1e-3)).all(-1)
        if not inside[vals > 0].all():
            raise AssertionError("a vitpose heatmap peak maps outside its padded box")
        outside = np.maximum(np.maximum(lo - kpts[:, 0], kpts[:, 0] - hi), 0) / scales[:, None]
        print(f"vitpose heatmap peaks inside the padded boxes ({int((vals > 0).sum())} of {vals.size} positive); "
              f"refined keypoints outside them: {int((outside.max(-1) > 0).sum())}, at most "
              f"{outside.max():.3f} box widths")
        # the predict program on two of the crops against the same model on the
        # CPU (K1's plain twin, the same seed-0 weights), both in f32
        crops = crops[:2]
        got = model.predict(crops)
        ref = init_model(Config.fromfile(VITPOSE), device="cpu").predict(crops.cpu())
        hm_rel = ((got["heatmaps"].cpu() - ref["heatmaps"]).abs().max() / ref["heatmaps"].abs().max()).item()
        score_err = (got["keypoint_scores"].cpu() - ref["keypoint_scores"]).abs().max().item()
        print(f"vitpose predict on 2 crops vs the CPU twin: heatmaps rel max err {hm_rel:.3e} "
              f"(bar {K1_F32_REL:g}), scores max abs err {score_err:.3e} (bar {K1_F32_REL:g})")
        if not (hm_rel < K1_F32_REL and score_err < K1_F32_REL):
            raise AssertionError("vitpose predict disagrees with the CPU twin")
        want = dict(vit_layer=12, expected_oks=0, oks_convolve=0, vit_layer_train_fwd=0, vit_layer_train_bwd=0,
                    attention=0)
        if launches != want:
            raise AssertionError(f"expected K1 x12 per call and no other kernel, got {launches}")
        self.record["vitpose_launches"] = launches

        iters = 5
        for _ in range(2):
            inference_topdown(model, img, boxes)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            inference_topdown(model, img, boxes)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        print(f"ViTPose-B-simple predict, f32, flip-TTA, B=64: {64 * iters / dt:.1f} crops/s "
              f"({1e3 * dt / iters:.2f} ms per inference_topdown call, {iters} calls after 2 warm-up)")
        self.profile(lambda: inference_topdown(model, img, boxes), calls=2, what="vitpose predict calls")

    def vitpose_train(self):
        import torch

        from probpose_code_torch.apis import init_model
        from probpose_code_torch.config import Config
        from probpose_code_torch.engine.optim import build_optimizer
        from probpose_code_torch.parallel import create_train_state, make_train_step

        cfg = Config.fromfile(VITPOSE)
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

        # the main path: counts set to 0 just before one step, read just after
        read_counts = reset_counts()
        state, logs = run_steps(step, state, batch, gen, lr_fn, 1)
        report_steps(logs)
        torch.cuda.synchronize()
        launches = read_counts()
        g0 = qkv0.grad.abs().max().item()
        print(f"vitpose train main path: one step of B={B}, launches {json.dumps(launches)}; "
              f"max |grad| of backbone.layers.0.attn.qkv.weight {g0:.3e}")
        want = dict(vit_layer=0, expected_oks=0, oks_convolve=0, vit_layer_train_fwd=0, vit_layer_train_bwd=0,
                    attention=12)
        if launches != want:
            raise AssertionError(f"expected K4 x12 (and K3 x0) in a ViTPose step and no other kernel, got {launches}")
        if not g0 > 0:
            raise AssertionError("the first ViT layer got no gradient")
        self.record["vitpose_train_launches"] = launches

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
        print(f"ViTPose-B-simple train step, B={B}, f32, drop_path 0.3: {B * steps / dt:.1f} crops/s "
              f"({1e3 * dt / steps:.2f} ms per step, {steps} steps after 3 warm-up; the loss dicts are read "
              f"to the host after the timed steps); peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

        def one():
            nonlocal state
            state, _ = run_steps(step, state, batch, gen, lr_fn, 1)

        self.profile(one, calls=2, what="vitpose train steps")

    @staticmethod
    def profile(fn, calls: int, what: str = "flagship calls"):
        """Device time by kernel over a few calls, and the device's busy
        share of the wall time (torch.profiler's CUDA activity)."""
        import torch
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        by_name = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                t, n = by_name.get(e.name, (0.0, 0))
                by_name[e.name] = (t + e.time_range.elapsed_us(), n + 1)
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

    @staticmethod
    def products_rate(fn, flops, calls=3):
        """(device ms a call of the GEMM kernels, TFLOP/s of ``flops``) over
        a profile of ``calls`` calls of fn, traced as ``profile`` traces. A
        trace that recorded no device time at all is taken once more; if
        that one is empty too, both numbers are NaN (not measured)."""
        import torch
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        for _ in range(2):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
            device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
            if device:
                break
        else:
            print("products: the profiler recorded no device time (their rate not measured)")
            return float("nan"), float("nan")
        us = sum(e.time_range.elapsed_us() for e in device if "gemm" in e.name)
        if us == 0:
            raise AssertionError("the profiler saw device time but no GEMM kernel")
        ms = us / calls / 1e3
        return ms, flops / (ms * 1e-3) / 1e12

    def timings(self):
        import torch
        import torch.nn as nn

        from probpose_code_torch.ops.decode import expected_oks_decode_to_input_space, oks_convolve_plain
        from probpose_code_torch.ops.kernels.expected_oks import expected_oks_decode, oks_convolve
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

        # K2 at the flagship shape: 64 crops x 17 keypoints, 64 x 48 maps
        Bk, K, Hh, Wh = 64, 17, 64, 48
        hm = torch.from_numpy(peaked_heatmaps(Bk, K, Hh, Wh, seed=3)).cuda()
        size = (192, 256)
        locs, vals = expected_oks_decode(hm, size)
        locs_p, vals_p = expected_oks_decode_to_input_space(hm, size)
        k2_err = max((locs - locs_p).abs().max().item(), (vals - vals_p).abs().max().item())
        k2_ms = cuda_time_ms(lambda: expected_oks_decode(hm, size), 50)
        k2_plain = cuda_time_ms(lambda: expected_oks_decode_to_input_space(hm, size), 10)
        conv_err = (oks_convolve(hm) - oks_convolve_plain(hm)).abs().max().item()
        conv_ms = cuda_time_ms(lambda: oks_convolve(hm), 50)
        conv_plain = cuda_time_ms(lambda: oks_convolve_plain(hm), 10)
        D = 19
        k2_bytes = hm.numel() * 4 + Bk * K * 3 * 4 + K * D * 4
        # along W over the Hh + D - 1 padded rows, then along H over Hh x Wh
        k2_ops = Bk * K * 2 * D * ((Hh + D - 1) * Wh + Hh * Wh)
        k2_bound = max(k2_ops / PEAK_F32, k2_bytes / PEAK_BYTES) * 1e3
        conv_bytes = 2 * hm.numel() * 4 + K * D * 4  # the conv-only entry writes the maps back
        conv_bound = max(k2_ops / PEAK_F32, conv_bytes / PEAK_BYTES) * 1e3
        # K3 at the flagship training shape: 64 crops, bf16, masks that drop some images
        Bt = 64
        kt = self.k3_timings(Bt, N, C, H, F)
        # K4 at the ViTPose-B training shape (f32) and the ProbPose-S shape
        # (bf16: no main path runs it, so it is printed, not recorded in the
        # kernels line); K1 at the ViTPose-B predict shape
        k4 = self.k4_timings(64, N, 12, 64, torch.float32)
        k4b = self.k4_timings(128, N, 12, 32, torch.bfloat16)
        kb = self.k1_vitb_timings(128, N, 768, 12, 3072)

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
                 max_abs_err=k2_err, ms=k2_ms, plain_ms=k2_plain, bound_ms=k2_bound,
                 bound_by="operations" if k2_ops / PEAK_F32 >= k2_bytes / PEAK_BYTES else "bytes",
                 library_ms=None),
            dict(name="oks_convolve", route="cuda", source="probpose_code_torch/csrc/expected_oks.cu",
                 replaces="probpose_code_tpu/ops/pallas/expected_oks.py:51", launches=launches["oks_convolve"],
                 max_abs_err=conv_err, ms=conv_ms, plain_ms=conv_plain, bound_ms=conv_bound,
                 bound_by="operations" if k2_ops / PEAK_F32 >= conv_bytes / PEAK_BYTES else "bytes",
                 library_ms=None),
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
        ]
        print(f"K1 vit_layer B={B} N={N} C={C} bf16: {k1_ms:.3f} ms, plain {k1_plain:.3f} ms, "
              f"nn.TransformerEncoderLayer (erf GELU, max-shifted softmax) {k1_lib:.3f} ms, "
              f"bound {k1_bound:.4f} ms ({k1_ops / 1e9:.1f} GFLOP, {k1_bytes / 1e6:.1f} MB), "
              f"{k1_ops / (k1_ms * 1e-3) / 1e12:.1f} TFLOP/s, {k1_ms / k1_bound:.1f}x its bound, "
              f"{k1_ms / k1_lib:.2f}x the library; its products ({k1_prod_flops / 1e9:.1f} GFLOP) "
              f"{k1_prod_ms:.3f} ms of GEMM device time, {k1_prod_rate:.1f} TFLOP/s")
        print(f"K2 expected_oks B={Bk} K={K} {Hh}x{Wh}: {k2_ms:.4f} ms, plain {k2_plain:.4f} ms, "
              f"bound {k2_bound:.4f} ms ({k2_bytes / 1e6:.2f} MB, {k2_ops / 1e9:.3f} GFLOP)")
        print(f"K2b oks_convolve (conv-only entry of expected_oks.cu): {conv_ms:.4f} ms, plain {conv_plain:.4f} ms, "
              f"bound {conv_bound:.4f} ms ({conv_bytes / 1e6:.2f} MB, {k2_ops / 1e9:.3f} GFLOP)")
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
        print(f"K1 vit_layer at the ViTPose-B predict shape B=128 N={N} C=768 f32 erf: {kb['ms']:.3f} ms, "
              f"plain {kb['plain_ms']:.3f} ms, nn.TransformerEncoderLayer {kb['library_ms']:.3f} ms, "
              f"bound {kb['bound_ms']:.4f} ms, {kb['bound_by']} ({kb['gflop']:.1f} GFLOP), "
              f"{kb['gflop'] / kb['ms']:.1f} TFLOP/s, {kb['ms'] / kb['bound_ms']:.1f}x its bound, "
              f"{kb['ms'] / kb['library_ms']:.2f}x the library, rel max err {kb['rel']:.2e}; its products "
              f"({kb['prod_gflop']:.1f} GFLOP) {kb['prod_ms']:.3f} ms of GEMM device time, "
              f"{kb['prod_rate']:.1f} TFLOP/s")

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
    def k1_vitb_timings(B, N, C, H, F):
        """K1 on prepared f32 weights with exact GELU, its plain twin and
        nn.TransformerEncoderLayer (f32, erf GELU) at one ViT-B layer of the
        ViTPose predict call (64 crops and their mirrors); the bound with the
        products as 3xTF32, and the rate of the layer's products from the
        device time of its GEMM kernels."""
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
                raise AssertionError(f"K1 at the ViT-B shape: rel max err {rel:.3e}")
            ms = cuda_time_ms(lambda: vit_layer_prepared(x, w, **kw), 5, warmup=1)
            plain = cuda_time_ms(lambda: vit_layer_plain(x, *p, **kw), 3, warmup=1)
            libms = cuda_time_ms(lambda: lib(x), 5, warmup=1)
            prod_flops = 2 * B * N * C * (4 * C + 2 * F)
            prod_ms, prod_rate = Smoke.products_rate(lambda: vit_layer_prepared(x, w, **kw), prod_flops, calls=2)
        ops = layer_flops(B, N, C, F)
        nbytes = 2 * x.numel() * 4 + sum(t.numel() * 4 for t in p)
        return dict(ms=ms, plain_ms=plain, library_ms=libms, rel=rel, max_abs_err=err, gflop=ops / 1e9,
                    bound_ms=max(ops / PEAK_F32_3XTF32, nbytes / PEAK_BYTES) * 1e3,
                    bound_by="operations" if ops / PEAK_F32_3XTF32 >= nbytes / PEAK_BYTES else "bytes",
                    prod_gflop=prod_flops / 1e9, prod_ms=prod_ms, prod_rate=prod_rate)

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
    smoke = Smoke()
    smoke.phase("build", smoke.build)
    if not smoke.failures:
        smoke.phase("k1_parity", smoke.k1_parity)
        smoke.phase("k2_parity", smoke.k2_parity)
        smoke.phase("k3_parity", smoke.k3_parity)
        smoke.phase("golden", smoke.golden)
        smoke.phase("flagship", smoke.flagship)
        smoke.phase("train", smoke.train)
        smoke.phase("k4_parity", smoke.k4_parity)
        smoke.phase("vitpose_predict", smoke.vitpose_predict)
        smoke.phase("vitpose_train", smoke.vitpose_train)
        smoke.phase("timings", smoke.timings)
    if smoke.failures:
        print(f"chip_smoke: failed phases: {', '.join(smoke.failures)}", file=sys.stderr)
        return 1
    print(card)
    print(json.dumps({"kernels": smoke.record["kernels"]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
