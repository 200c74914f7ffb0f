"""probpose_code_torch: the PyTorch/CUDA port of probpose_code_tpu.

The top-down ProbPose predict path (ViT + ProbMapHead, flip-TTA, expected-OKS
decode) runs on an NVIDIA H100 through hand-written CUDA kernels for the
whole ViT layer (``ops/kernels/vit_layer.py``) and the expected-OKS decode
(``ops/kernels/expected_oks.py``); their plain PyTorch twins run on the CPU.
Entry points: ``probpose_code_torch.apis.init_model`` and
``inference_topdown``; ``python -m probpose_code_torch.tools.test`` (or
``engine.runner.Runner``) evaluates a config on its COCO-style val set. The
package imports torch only, never JAX, OpenCV or the JAX package.
"""

__version__ = "0.1.0"
