#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (probpose_code_torch) on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one CUDA
card and the CUDA toolkit (nvcc); it builds the port's kernels from
``probpose_code_torch/csrc`` first. Phases, each of which fails the run:

1. the card's name and power limit, and the kernels' build time;
2. K1 (whole ViT layer) against its plain twin at the flagship layer shape;
3. K2 (expected-OKS decode) and its conv-only entry against their plain twin;
4. the golden tiny ProbPose fixture end to end through ``init_model`` and
   ``inference_topdown``, against the reference keypoints;
5. the flagship ProbPose-S predict at full width (random weights, seed 0),
   64 boxes with flip-TTA: the kernels' launch counts in one call, then
   crops/s;
6. each kernel's time beside its plain twin's, a PyTorch library call's where
   one computes the same function, and its bound from this run's shapes.

The line before the last holds the kernels' record as JSON, the last line
``{"ok": true, "device": ...}``. Any failure exits non-zero without them.
It imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "golden"
FLAGSHIP = ROOT / "configs/body_2d_keypoint/topdown_probmap/coco/td-pm_ProbPose-small_8xb64-210e_coco-256x192.py"

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, f32 outside
# them, and device memory.
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12

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
        from probpose_code_torch.ops.kernels.expected_oks import expected_oks_decode
        from probpose_code_torch.ops.kernels.vit_layer import vit_layer_prepared

        model = init_model(Config.fromfile(FLAGSHIP), device="cuda")
        rng = np.random.RandomState(0)
        img = (rng.rand(480, 640, 3) * 255).astype(np.uint8)
        xy = rng.uniform(0, [560, 380], (64, 2))
        wh = rng.uniform([40, 60], [200, 300], (64, 2))
        boxes = np.concatenate([xy, np.minimum(xy + wh, [640, 480])], axis=1).astype(np.float32)

        # the main path: counts set to 0 just before, read just after
        vit_layer_prepared.launches = expected_oks_decode.launches = 0
        samples = inference_topdown(model, img, boxes)
        torch.cuda.synchronize()
        launches = {"vit_layer": vit_layer_prepared.launches, "expected_oks": expected_oks_decode.launches}
        print(f"flagship main path: {len(samples)} crops, launches {json.dumps(launches)}")
        kpts = np.stack([s.pred_instances.keypoints for s in samples])
        fields = [np.stack([s.pred_instances[f] for s in samples]) for f in
                  ("keypoint_scores", "keypoints_probs", "keypoints_visible", "keypoints_oks", "keypoints_error")]
        if kpts.shape != (64, 1, 17, 2) or any(f.shape != (64, 1, 17) for f in fields):
            raise AssertionError(f"flagship output shapes {kpts.shape}, {[f.shape for f in fields]}")
        if not (np.isfinite(kpts).all() and all(np.isfinite(f).all() for f in fields)):
            raise AssertionError("flagship outputs are not finite")
        if launches != {"vit_layer": 12, "expected_oks": 1}:
            raise AssertionError(f"expected K1 x12 and K2 x1 per call, got {launches}")
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

    @staticmethod
    def profile(fn, calls: int):
        """Device time by kernel over a few flagship calls, and the device's
        busy share of the wall time (torch.profiler's CUDA activity)."""
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
        print(f"profile over {calls} flagship calls: wall {wall_us / calls / 1e3:.2f} ms per call, device busy "
              f"{busy / calls / 1e3:.2f} ms per call ({100 * busy / wall_us:.1f}% busy, "
              f"{100 * (1 - busy / wall_us):.1f}% idle)")
        for name, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]:
            print(f"  {100 * t / busy:5.1f}%  {t / calls / 1e3:8.3f} ms/call  x{n // calls:<4d} {name[:110]}")

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
        conv_ms = cuda_time_ms(lambda: oks_convolve(hm), 50)
        conv_plain = cuda_time_ms(lambda: oks_convolve_plain(hm), 10)
        D = 19
        k2_bytes = hm.numel() * 4 + Bk * K * 3 * 4 + K * D * 4
        # along W over the Hh + D - 1 padded rows, then along H over Hh x Wh
        k2_ops = Bk * K * 2 * D * ((Hh + D - 1) * Wh + Hh * Wh)
        k2_bound = max(k2_ops / PEAK_F32, k2_bytes / PEAK_BYTES) * 1e3
        conv_bytes = 2 * hm.numel() * 4 + K * D * 4  # the conv-only entry writes the maps back
        conv_bound = max(k2_ops / PEAK_F32, conv_bytes / PEAK_BYTES) * 1e3
        # the launch counts above belong to the comparisons, not the main path
        launches = self.record.get("launches", {"vit_layer": 0, "expected_oks": 0})

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
        ]
        print(f"K1 vit_layer B={B} N={N} C={C} bf16: {k1_ms:.3f} ms, plain {k1_plain:.3f} ms, "
              f"nn.TransformerEncoderLayer (erf GELU, max-shifted softmax) {k1_lib:.3f} ms, "
              f"bound {k1_bound:.4f} ms ({k1_ops / 1e9:.1f} GFLOP, {k1_bytes / 1e6:.1f} MB), "
              f"{k1_ops / (k1_ms * 1e-3) / 1e12:.1f} TFLOP/s")
        print(f"K2 expected_oks B={Bk} K={K} {Hh}x{Wh}: {k2_ms:.4f} ms, plain {k2_plain:.4f} ms, "
              f"bound {k2_bound:.4f} ms ({k2_bytes / 1e6:.2f} MB, {k2_ops / 1e9:.3f} GFLOP)")
        print(f"K2b oks_convolve (conv-only entry of expected_oks.cu): {conv_ms:.4f} ms, plain {conv_plain:.4f} ms, "
              f"bound {conv_bound:.4f} ms ({conv_bytes / 1e6:.2f} MB, {k2_ops / 1e9:.3f} GFLOP)")


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
        smoke.phase("golden", smoke.golden)
        smoke.phase("flagship", smoke.flagship)
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
